"""Flooding belief-propagation decoding of QC LDPC codes in plain PyTorch:
a frozen copy of the program's plain decoder (pyldpc semantics: Lc =
2 y / 10^(-snr/10), LLR > 0 <=> bit 0; the full lifted graph in natural
column order; var->check messages clipped to +-16; the check rules
"sumprod" (tanh rule, product clipped to +-0.9999999, 2 atanh(p) as
log((1 + p) / (1 - p))), "minsum" (x minsum_scale) and "offset-minsum"
(max(min(loo, 16) - beta, 0)); the syndrome checked after every
iteration and on the channel decision; each codeword frozen at its first
zero syndrome, an unconverged one keeping its decision after `cap`
iterations). The posterior is summed in the program kernel's order,
Lc + (((r0 + r1) + r2) + r3), so the min-sum rules give the kernel's bits.
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
        raise ValueError("the reference decodes QC codes")
    if algo not in ALGOS:
        raise ValueError(f"unknown BP check rule {algo!r}")
    if schedule != "flooding":
        raise ValueError(f"the reference decodes the flooding schedule, "
                         f"not {schedule!r}")


def _effective_cap(max_iter: int, iter_cap) -> int:
    if iter_cap is None:
        return int(max_iter)
    if int(iter_cap) > int(max_iter):
        raise ValueError(f"iter_cap={int(iter_cap)} exceeds max_iter="
                         f"{int(max_iter)}")
    return int(iter_cap)


def tanh_half(q: torch.Tensor) -> torch.Tensor:
    """t = tanh(q / 2) in float32, the BP kernels' formula (bp_common.cuh):
    the odd Taylor polynomial q / 2 - q^3 / 24 where |q| < 1/8 (there 1 - e
    would cancel), else sign(q) (1 - e) / (1 + e) with e = exp(-|q|), which
    cannot overflow. The kernels evaluate the same with the card's ex2/rcp
    approximations and a fused multiply-add; the two differ by a few
    ulps."""
    poly = q * (q * q * (-1.0 / 24.0) + 0.5)
    e = torch.exp(-q.abs())
    return torch.where(q.abs() < 0.125, poly,
                       torch.copysign((1.0 - e) / (1.0 + e), q))


def log_ratio(p: torch.Tensor) -> torch.Tensor:
    """r = 2 atanh(p) in float32 as log((1 + p) / (1 - p)), the form of the
    TPU kernel (esn_ofdm_mimo_tpu/ldpc/decode_pallas.py:231), with the odd
    Taylor polynomial 2 p + 2 p^3 / 3 where |p| < 1/16 (there 1 + p drops
    p's low bits). The kernels evaluate the same with the card's lg2/rcp
    approximations."""
    poly = p * (p * p * (2.0 / 3.0) + 2.0)
    return torch.where(p.abs() < 0.0625, poly,
                       torch.log((1.0 + p) / (1.0 - p)))


def _loo_prod(t: torch.Tensor) -> torch.Tensor:
    """Leave-one-out products along the last axis, from forward and
    backward running products (the JAX _leave_one_out_prod's order)."""
    dc = t.shape[-1]
    fwd = [torch.ones_like(t[..., 0])]
    for j in range(dc - 1):
        fwd.append(fwd[-1] * t[..., j])
    bwd = [torch.ones_like(t[..., 0])]
    for j in range(dc - 1, 0, -1):
        bwd.append(bwd[-1] * t[..., j])
    bwd = bwd[::-1]
    return torch.stack([f * b for f, b in zip(fwd, bwd)], dim=-1)


def _check_update(q: torch.Tensor, algo: str, minsum_scale: float,
                  minsum_offset: float) -> torch.Tensor:
    """q (B, m, dc) clipped var->check messages -> check->var messages."""
    if algo == "sumprod":
        prod = _loo_prod(tanh_half(q))
        return log_ratio(torch.clamp(prod, -_SP_CLIP, _SP_CLIP))
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


_SIGN = -2 ** 31  # the sign bit of an int32 view of a float32


def minsum_form(q: torch.Tensor, algo: str, minsum_scale: float,
                minsum_offset: float) -> torch.Tensor:
    """The min-sum rules on float32 q (..., 8) in fewer passes: the same
    floats as `_check_update(clamp(q, +-16), ...)`, bit for bit (the
    program's tests hold its own copy of this form against the rule).

    Sign bits stand for `q < 0`: q + 0.0 turns -0.0 into +0.0 (the kernel
    does it once, to the channel LLRs it loads, and its sums then hold no
    -0.0). The check's sign is the XOR of the dc sign bits; m1 <= m2, the
    two smallest of a = min(|q|, 16), come from a tree of pairs; the rule's
    magnitude is computed for m1 and m2 only, edge j taking f(m2) where
    a == m1 (the first argmin; where several tie, m2 == m1) and f(m1)
    elsewhere; the signs are XORed onto it."""
    if q.shape[-1] != 8:
        raise ValueError(f"the kernel's tree of pairs takes dc = 8, got "
                         f"{q.shape[-1]}")
    qi = (q.to(torch.float32) + 0.0).view(torch.int32)
    a = torch.clamp_max(q.abs(), MSG_CLIP)
    par = qi[..., 0]
    for j in range(1, 8):
        par = par ^ qi[..., j]
    lo = torch.minimum(a[..., 0::2], a[..., 1::2])              # (..., 4)
    hi = torch.maximum(a[..., 0::2], a[..., 1::2])
    for _ in range(2):                        # merge neighbouring pairs
        lo_a, lo_b = lo[..., 0::2], lo[..., 1::2]
        hi_a, hi_b = hi[..., 0::2], hi[..., 1::2]
        hi = torch.minimum(torch.maximum(lo_a, lo_b),
                           torch.minimum(hi_a, hi_b))
        lo = torch.minimum(lo_a, lo_b)
    m1, m2 = lo, hi                                             # (..., 1)
    if algo == "offset-minsum":
        f1 = torch.clamp_min(m1 - minsum_offset, 0.0)
        f2 = torch.clamp_min(m2 - minsum_offset, 0.0)
    elif algo == "minsum":
        f1, f2 = minsum_scale * m1, minsum_scale * m2
    else:
        raise ValueError(f"minsum_form takes the min-sum rules, got {algo!r}")
    sgn = (par & _SIGN)[..., None]
    s1, s2 = f1.view(torch.int32) ^ sgn, f2.view(torch.int32) ^ sgn
    return (torch.where(a == m1, s2, s1) ^ (qi & _SIGN)).view(torch.float32)


def _decode_flooding(code: LdpcCode, llr_nat: torch.Tensor, cap: int,
                     algo: str, minsum_scale: float, minsum_offset: float):
    """Flooding BP on a QC code's full lifted graph in natural order.
    llr_nat (B, n) -> (bits_nat (B, n) bool, iterations (B,) int32,
    converged (B,) bool)."""
    return _flood_batch(code.qc.ck_cols_nat, code.qc.var_edge_nat, llr_nat,
                        cap, algo, minsum_scale, minsum_offset)


def _flood_batch(ck_cols: np.ndarray, var_edge: np.ndarray,
                 llr: torch.Tensor, cap: int, algo: str, minsum_scale: float,
                 minsum_offset: float, every: int = 10):
    """Flooding BP on gather maps with no padded edges (a QC code's full
    lifted graph): ck_cols (m, dc) the variables of each check, var_edge
    (n, dv) the edges of each variable. Every live codeword iterates in one
    batch; its bits and iteration count are recorded at its first zero
    syndrome, and the converged ones leave the batch every `every`
    iterations (one host read each time). The program's plain decoder
    drops them at every iteration: the same bits, iterations and
    convergence, bit for bit. The min-sum rules at dc = 8 take `minsum_form`,
    the same floats as `_check_update`, bit for bit, in fewer passes."""
    dev = llr.device
    ck = torch.as_tensor(ck_cols, dtype=torch.int64, device=dev)
    ve = torch.as_tensor(var_edge, dtype=torch.int64, device=dev)
    m_full, dc = ck.shape
    dv = ve.shape[1]
    if algo != "sumprod" and dc == 8:
        def rule(q):
            return minsum_form(q, algo, minsum_scale, minsum_offset)
    else:
        def rule(q):
            return _check_update(q, algo, minsum_scale, minsum_offset)

    def syndrome_ok(d):
        return (d[:, ck].sum(-1) % 2 == 0).all(-1)

    lc = llr.to(torch.float32)
    d = lc < 0
    bits = d.clone()
    done = syndrome_ok(d)
    iters = torch.where(done, 0, cap).to(torch.int32)
    act = torch.nonzero(~done).flatten()
    lc_a, lt_a = lc[act], lc[act]
    r_a = torch.zeros(act.numel(), m_full, dc, device=dev)
    bits_a, done_a = bits[act], done[act]
    iters_a = iters[act]
    for it in range(cap):
        if act.numel() == 0:
            break
        q = torch.clamp(lt_a[:, ck] - r_a, -MSG_CLIP, MSG_CLIP)
        r_a = rule(q)
        x = r_a.reshape(r_a.shape[0], m_full * dc)[:, ve]     # (b, n, dv)
        s = x[..., 0]
        for i in range(1, dv):
            s = s + x[..., i]
        lt_a = lc_a + s
        d_a = lt_a < 0
        ok = syndrome_ok(d_a)
        new = ok & ~done_a
        bits_a = torch.where(new[:, None], d_a, bits_a)
        iters_a = torch.where(new, it + 1, iters_a)
        done_a = done_a | ok
        if it + 1 == cap:
            bits_a = torch.where(done_a[:, None], bits_a, d_a)
        if it + 1 == cap or (it + 1) % every == 0:
            bits[act], iters[act], done[act] = bits_a, iters_a, done_a
            keep = torch.nonzero(~done_a).flatten()
            act, lc_a, lt_a, r_a = act[keep], lc_a[keep], lt_a[keep], \
                r_a[keep]
            bits_a, done_a, iters_a = bits_a[keep], done_a[keep], \
                iters_a[keep]
    return bits, iters, done


def ldpc_decode_bp_plain(code: LdpcCode, llr: torch.Tensor,
                         max_iter: int = 100, algo: str = "sumprod",
                         minsum_scale: float = 0.75, iter_cap=None,
                         schedule: str = "flooding", pass1_iters=None,
                         minsum_offset: float = 0.625,
                         count_against: torch.Tensor | None = None):
    """Flooding BP on any device. llr (B, n) pipeline order. Returns (bits
    (B, n) int8 pipeline order, or per-codeword info-bit errors (B,) int32
    when `count_against` (B, k) holds the true info bits; stats dict).

    pass1_iters=K runs the two-pass form: every codeword at budget K, then
    the unconverged ones again from scratch at the full cap. Trajectories
    are per-codeword deterministic, so the merged result is bit-identical
    to a single pass."""
    _check_args(code, algo, schedule)
    cap = _effective_cap(max_iter, iter_cap)
    qc = code.qc
    dev = llr.device
    llr_nat = llr.to(torch.float32)[:, torch.as_tensor(
        qc.inv_perm, dtype=torch.int64, device=dev)]
    def run(x, c):
        return _decode_flooding(code, x, c, algo, minsum_scale,
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


def ldpc_decode_bp_counts(code: LdpcCode, llr: torch.Tensor,
                          info_bits: torch.Tensor, max_iter: int = 100,
                          algo: str = "sumprod", minsum_scale: float = 0.75,
                          iter_cap=None, schedule: str = "flooding",
                          pass1_iters=None, minsum_offset: float = 0.625):
    """Decode + per-codeword info-bit error counts: info_bits (B, k)
    pipeline order -> (err (B,) int32, stats), plain BP on any device, in
    one pass: each codeword's trajectory is its own, so the two-pass form
    (`pass1_iters`) gives the same bits and stats."""
    return ldpc_decode_bp_plain(
        code, llr, max_iter, algo, minsum_scale, iter_cap=iter_cap,
        schedule=schedule, minsum_offset=minsum_offset,
        count_against=info_bits)
