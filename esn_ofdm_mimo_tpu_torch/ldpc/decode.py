"""Flooding belief-propagation LDPC decoding: the plain PyTorch version.

Port of esn_ofdm_mimo_tpu/ldpc/decode.py for QC codes, and the plain
version of the CUDA kernel in ldpc/decode_cuda.py (csrc/bp_decode.cu).
pyldpc semantics (reference OFDM_SISO_NBF_LDPC.py:484):
  * channel LLR Lc = 2*y/10^(-snr/10) (`llr_from_yobs`); LLR > 0 <=> bit 0;
  * flooding schedule on the FULL lifted QC graph in natural column order
    (QcInfo.ck_cols_nat / var_edge_nat, including the dv-1 redundant checks);
  * var->check messages clipped to +-16; check rules "sumprod" (tanh rule,
    product clipped to +-0.9999999), "minsum" (normalised, x minsum_scale)
    and "offset-minsum" (max(min(loo, 16) - beta, 0), the flagship rule);
  * the syndrome is checked after every iteration (and on the channel
    decision before any); each codeword freezes at its first zero syndrome,
    an unconverged one keeps its decision after `cap` iterations;
  * stats: "iterations" (first zero-syndrome iteration, the cap if never)
    and "converged".

Each codeword's trajectory is deterministic and independent of the batch,
so the loop drops codewords from the active set as they freeze: the
results are those of a batch-wide loop, with work only for live codewords.
The posterior is summed in the kernel's order, Lc + (((r0 + r1) + r2) + r3)
over the dv base rows, so the min-sum rules agree with the kernel bit for
bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .code import LdpcCode

MSG_CLIP = 16.0
_SP_CLIP = 0.9999999
ALGOS = ("sumprod", "minsum", "offset-minsum")


def llr_from_yobs(y_obs: torch.Tensor, snr_db: float = 1.0) -> torch.Tensor:
    """pyldpc channel-LLR contract: Lc = 2*y/10^(-snr/10)."""
    var = float(np.float32(10.0 ** (-snr_db / 10.0)))
    return 2.0 * y_obs / var


def _check_args(code: LdpcCode, algo: str, schedule: str):
    if code.qc is None:
        raise NotImplementedError("the port decodes QC codes only")
    if algo not in ALGOS:
        raise ValueError(f"unknown BP check rule {algo!r}")
    if schedule != "flooding":
        raise NotImplementedError(
            f"BP schedule {schedule!r} is not ported yet (flooding only)")


def _effective_cap(max_iter: int, iter_cap) -> int:
    if iter_cap is None:
        return int(max_iter)
    if int(iter_cap) > int(max_iter):
        raise ValueError(f"iter_cap={int(iter_cap)} exceeds max_iter="
                         f"{int(max_iter)}")
    return int(iter_cap)


def _check_update(q: torch.Tensor, algo: str, minsum_scale: float,
                  minsum_offset: float) -> torch.Tensor:
    """q (B, m, dc) clipped var->check messages -> check->var messages."""
    if algo == "sumprod":
        t = torch.tanh(0.5 * q)
        dc = t.shape[-1]
        fwd = [torch.ones_like(t[..., 0])]
        for j in range(dc - 1):
            fwd.append(fwd[-1] * t[..., j])
        bwd = [torch.ones_like(t[..., 0])]
        for j in range(dc - 1, 0, -1):
            bwd.append(bwd[-1] * t[..., j])
        bwd = bwd[::-1]
        prod = torch.stack([f * b for f, b in zip(fwd, bwd)], dim=-1)
        return 2.0 * torch.atanh(torch.clamp(prod, -_SP_CLIP, _SP_CLIP))
    sgn = torch.where(q < 0, -1.0, 1.0)
    sgn_loo = sgn.prod(-1, keepdim=True) * sgn          # exact: +-1 values
    mag = q.abs()
    m1 = mag.amin(-1, keepdim=True)
    is_min = mag == m1
    first = is_min & (torch.cumsum(is_min.to(torch.int32), -1) == 1)
    m2 = torch.where(first, float("inf"), mag).amin(-1, keepdim=True)
    loo = torch.clamp_max(torch.where(first, m2, m1), MSG_CLIP)
    if algo == "offset-minsum":
        return sgn_loo * torch.clamp_min(loo - minsum_offset, 0.0)
    return minsum_scale * sgn_loo * loo


def _decode_flooding(code: LdpcCode, llr_nat: torch.Tensor, cap: int,
                     algo: str, minsum_scale: float, minsum_offset: float):
    """Flooding BP in natural order. llr_nat (B, n) -> (bits_nat (B, n)
    bool, iterations (B,) int32, converged (B,) bool)."""
    dev = llr_nat.device
    ck = torch.as_tensor(code.qc.ck_cols_nat, dtype=torch.int64, device=dev)
    ve = torch.as_tensor(code.qc.var_edge_nat, dtype=torch.int64, device=dev)
    m_full, dc = ck.shape
    dv = ve.shape[1]
    B = llr_nat.shape[0]

    def posterior(lc, r):
        x = r.reshape(r.shape[0], m_full * dc)[:, ve]         # (b, n, dv)
        s = x[..., 0]
        for i in range(1, dv):
            s = s + x[..., i]
        return lc + s

    def syndrome_ok(d):
        return (d[:, ck].sum(-1) % 2 == 0).all(-1)

    lc = llr_nat.to(torch.float32)
    d = lc < 0
    bits = d.clone()
    done = syndrome_ok(d)
    iters = torch.where(done, 0, cap).to(torch.int32)
    act = torch.nonzero(~done).flatten()
    lc_a, lt_a = lc[act], lc[act]
    r_a = torch.zeros(act.numel(), m_full, dc, device=dev)
    for it in range(cap):
        if act.numel() == 0:
            break
        q = torch.clamp(lt_a[:, ck] - r_a, -MSG_CLIP, MSG_CLIP)
        r_a = _check_update(q, algo, minsum_scale, minsum_offset)
        lt_a = posterior(lc_a, r_a)
        d_a = lt_a < 0
        ok = syndrome_ok(d_a)
        last = it + 1 == cap
        fin = torch.ones_like(ok) if last else ok
        bits[act[fin]] = d_a[fin]
        iters[act[ok]] = it + 1
        done[act[ok]] = True
        keep = ~fin
        act, lc_a, lt_a, r_a = act[keep], lc_a[keep], lt_a[keep], r_a[keep]
    return bits, iters, done


def ldpc_decode_bp_plain(code: LdpcCode, llr: torch.Tensor,
                         max_iter: int = 100, algo: str = "sumprod",
                         minsum_scale: float = 0.75, iter_cap=None,
                         schedule: str = "flooding", pass1_iters=None,
                         minsum_offset: float = 0.625,
                         count_against: torch.Tensor | None = None):
    """Plain version of the CUDA decoder, on any device.

    llr (B, n) pipeline order. Returns (bits (B, n) int8 pipeline order, or
    per-codeword info-bit errors (B,) int32 when `count_against` (B, k)
    holds the true info bits; stats dict).

    pass1_iters=K runs the JAX package's two-pass form: every codeword at
    budget K, then the unconverged ones again from scratch at the full cap.
    Trajectories are per-codeword deterministic, so the merged result is
    bit-identical to a single pass."""
    _check_args(code, algo, schedule)
    cap = _effective_cap(max_iter, iter_cap)
    qc = code.qc
    dev = llr.device
    llr_nat = llr.to(torch.float32)[:, torch.as_tensor(
        qc.inv_perm, dtype=torch.int64, device=dev)]
    run = lambda x, c: _decode_flooding(code, x, c, algo, minsum_scale,
                                        minsum_offset)
    if pass1_iters is not None and int(pass1_iters) < cap:
        bits, iters, conv = run(llr_nat, int(pass1_iters))
        strag = torch.nonzero(~conv).flatten()
        b2, i2, c2 = run(llr_nat[strag], cap)
        bits[strag], iters[strag], conv[strag] = b2, i2, c2
    else:
        bits, iters, conv = run(llr_nat, cap)
    stats = {"iterations": iters, "converged": conv}
    if count_against is not None:
        info_cols = torch.as_tensor(qc.perm[code.m:], dtype=torch.int64,
                                    device=dev)
        bad = bits[:, info_cols] != count_against.to(torch.bool)
        return bad.sum(-1, dtype=torch.int32), stats
    perm = torch.as_tensor(qc.perm, dtype=torch.int64, device=dev)
    return bits[:, perm].to(torch.int8), stats


def ldpc_decode_bp(code: LdpcCode, llr: torch.Tensor, max_iter: int = 100,
                   algo: str = "sumprod", minsum_scale: float = 0.75,
                   return_stats: bool = False, iter_cap=None,
                   schedule: str = "flooding", pass1_iters=None,
                   minsum_offset: float = 0.625):
    """Decode B codewords: llr (B, n) -> hard bits (B, n) int8 (+ stats).

    CUDA tensors run the BP kernel (ldpc/decode_cuda.py), CPU tensors its
    plain version."""
    from .decode_cuda import ldpc_decode_bp_cuda
    bits, st = ldpc_decode_bp_cuda(code, llr, max_iter, algo, minsum_scale,
                                   iter_cap=iter_cap, schedule=schedule,
                                   pass1_iters=pass1_iters,
                                   minsum_offset=minsum_offset)
    return (bits, st) if return_stats else bits


def ldpc_decode_bp_counts(code: LdpcCode, llr: torch.Tensor,
                          info_bits: torch.Tensor, max_iter: int = 100,
                          algo: str = "sumprod", minsum_scale: float = 0.75,
                          iter_cap=None, schedule: str = "flooding",
                          pass1_iters=None, minsum_offset: float = 0.625):
    """Decode + per-codeword info-bit error counts: info_bits (B, k)
    pipeline order -> (err (B,) int32, stats)."""
    from .decode_cuda import ldpc_decode_bp_cuda_counts
    return ldpc_decode_bp_cuda_counts(
        code, llr, info_bits, max_iter, algo, minsum_scale,
        iter_cap=iter_cap, schedule=schedule, pass1_iters=pass1_iters,
        minsum_offset=minsum_offset)
