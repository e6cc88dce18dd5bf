"""Belief-propagation LDPC decoding, flooding and layered: the plain PyTorch
versions.

Port of esn_ofdm_mimo_tpu/ldpc/decode.py: for QC codes the plain versions
of the CUDA kernels in ldpc/decode_cuda.py (csrc/bp_decode.cu,
csrc/bp_decode_layered.cu); for the Gallager and pyldpc families, whose
codes have no QC structure, the JAX package's flooding decoder on the
code's own gather maps (`_decode_bp_graph`, plain PyTorch on any device, as
the JAX package runs it in XLA on every backend; its sum-product keeps the
JAX decoder's 2 atanh(p)). pyldpc semantics (reference
OFDM_SISO_NBF_LDPC.py:484):
  * channel LLR Lc = 2*y/10^(-snr/10) (`llr_from_yobs`); LLR > 0 <=> bit 0;
  * flooding schedule (the default) on the FULL lifted QC graph in natural
    column order (QcInfo.ck_cols_nat / var_edge_nat, including the dv-1
    redundant checks);
  * schedule="layered": serial-C row-layered sweeps on the same graph. The
    dv base rows update in turn within one sweep, each reading the
    posteriors the rows before it just refreshed: q = Lt - r_i (unclipped),
    the check sees clip(q, +-16), Lt = q + r_i'. About half the flooding
    iterations reach the same BER, so layered runs at max_iter / 2;
  * var->check messages clipped to +-16; check rules "sumprod" (tanh rule,
    product clipped to +-0.9999999, 2*atanh(p) in the TPU kernel's form
    log((1+p)/(1-p)); see `tanh_half`, `log_ratio`), "minsum" (normalised,
    x minsum_scale) and "offset-minsum" (max(min(loo, 16) - beta, 0), the
    flagship rule);
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
bit. The layered sweep has one subtract and one add per edge, so it has no
summation order to agree on.
"""
from __future__ import annotations

import numpy as np
import torch

from .code import LdpcCode

MSG_CLIP = 16.0
_SP_CLIP = 0.9999999
ALGOS = ("sumprod", "minsum", "offset-minsum")
SCHEDULES = ("flooding", "layered")
# Decodes on an unlifted code's graph (`_decode_bp_graph`) since the count
# was last reset (by the caller): a QC code never comes here.
graph_decodes = 0
# Switches of the BP kernels' attribution builds (csrc/bp_decode.cu,
# csrc/bp_decode_layered.cu; launched only by tools/bench_bp_torch.py): a
# mask, 0 in every decode. In the layered kernel DIAG_NO_VAR_UPDATE drops the
# posterior write.
DIAG_FIXED, DIAG_COPY_RULE, DIAG_NO_SYNDROME, DIAG_NO_VAR_UPDATE = 1, 2, 4, 8


def llr_from_yobs(y_obs: torch.Tensor, snr_db: float = 1.0) -> torch.Tensor:
    """pyldpc channel-LLR contract: Lc = 2*y/10^(-snr/10)."""
    var = float(np.float32(10.0 ** (-snr_db / 10.0)))
    return 2.0 * y_obs / var


def _check_args(code: LdpcCode, algo: str, schedule: str):
    if code.qc is None:
        if schedule == "layered":
            raise ValueError("schedule='layered' requires a QC code "
                             "(LdpcConfig.family='qc')")
        raise ValueError("the BP kernels and their plain versions take QC "
                         "codes; ldpc_decode_bp decodes the others on their "
                         "graph")
    if algo not in ALGOS:
        raise ValueError(f"unknown BP check rule {algo!r}")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown BP schedule {schedule!r}")


def _check_graph_args(schedule: str):
    if schedule == "layered":
        raise ValueError("schedule='layered' requires a QC code "
                         "(LdpcConfig.family='qc')")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown BP schedule {schedule!r}")


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
    """The min-sum rules in the form the layered kernel computes them
    (csrc/bp_decode_layered.cu:minsum_rule), on float32 q (..., 8): the
    same floats as `_check_update(clamp(q, +-16), ...)`, bit for bit.
    Nothing on the decode path calls it; tests/test_torch_bp_layered_form.py
    holds it against `_check_update` and, through
    `_decode_layered(..., kernel_form=True)`, the decoder against the JAX
    package.

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


def _flood(ck_cols: np.ndarray, var_edge: np.ndarray, llr: torch.Tensor,
           cap: int, rule, diag: int = 0):
    """Flooding BP on the gather maps ck_cols (m, dc) (the variables of each
    check, padded with the sentinel n) and var_edge (n, dv) (the edges of
    each variable, padded with m * dc). llr (B, n) in the maps' column
    order -> (bits (B, n) bool, iterations (B,) int32, converged (B,)
    bool). `rule` maps clipped var->check messages (b, m, dc) to check->var
    messages; a padded edge brings it q = +inf (sign +, |q| no minimum,
    tanh 1) and carries no message back. The posterior sums a variable's
    messages in edge order. `diag` as in `_decode_flooding`."""
    dev = llr.device
    ck = torch.as_tensor(ck_cols, dtype=torch.int64, device=dev)
    ve = torch.as_tensor(var_edge, dtype=torch.int64, device=dev)
    m_full, dc = ck.shape
    n = llr.shape[1]
    dv = ve.shape[1]
    valid = ck < n
    padded = not bool(valid.all())          # checks of unequal degree
    ve_padded = bool((ve == m_full * dc).any())
    pad = torch.nn.functional.pad

    def posterior(lc, r):
        x = r.reshape(r.shape[0], m_full * dc)
        if ve_padded:
            x = pad(x, (0, 1))
        x = x[:, ve]                                          # (b, n, dv)
        s = x[..., 0]
        for i in range(1, dv):
            s = s + x[..., i]
        return lc + s

    def syndrome_ok(d):
        if padded:
            d = pad(d, (0, 1))
        ok = (d[:, ck].sum(-1) % 2 == 0).all(-1)
        return torch.zeros_like(ok) if diag & DIAG_FIXED else ok

    lc = llr.to(torch.float32)
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
        q = torch.clamp((pad(lt_a, (0, 1)) if padded else lt_a)[:, ck] - r_a,
                        -MSG_CLIP, MSG_CLIP)
        if padded:
            q = torch.where(valid, q, float("inf"))
        r_a = q if diag & DIAG_COPY_RULE else rule(q)
        if padded:
            r_a = torch.where(valid, r_a, 0.0)
        if not diag & DIAG_NO_VAR_UPDATE:
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


def _decode_flooding(code: LdpcCode, llr_nat: torch.Tensor, cap: int,
                     algo: str, minsum_scale: float, minsum_offset: float,
                     diag: int = 0):
    """Flooding BP on a QC code's full lifted graph in natural order, the
    plain version of the flooding kernel. llr_nat (B, n) -> (bits_nat (B,
    n) bool, iterations (B,) int32, converged (B,) bool).

    `diag` (a mask of DIAG_*, 0 in every decode) selects the plain version
    of one of the kernel's attribution builds, whose results are wrong by
    design: DIAG_FIXED never exits (every codeword runs `cap` iterations),
    DIAG_COPY_RULE makes the check rule return its inputs, and
    DIAG_NO_VAR_UPDATE keeps the posteriors at the channel LLRs.
    DIAG_NO_SYNDROME only removes work from the kernel: with DIAG_FIXED the
    syndrome decides nothing."""
    return _flood(code.qc.ck_cols_nat, code.qc.var_edge_nat, llr_nat, cap,
                  lambda q: _check_update(q, algo, minsum_scale,
                                          minsum_offset), diag)


def _graph_check_update(q: torch.Tensor, algo: str, minsum_scale: float,
                        minsum_offset: float) -> torch.Tensor:
    """The check rules of the JAX package's graph decoder: the min-sum
    rules as `_check_update`, sum-product as 2 atanh(p) of the clipped
    leave-one-out product of tanh(q / 2) (JAX decode.py:341-347)."""
    if algo != "sumprod":
        return _check_update(q, algo, minsum_scale, minsum_offset)
    prod = _loo_prod(torch.tanh(0.5 * q))
    return 2.0 * torch.atanh(torch.clamp(prod, -_SP_CLIP, _SP_CLIP))


def _decode_bp_graph(code: LdpcCode, llr: torch.Tensor, cap: int, algo: str,
                     minsum_scale: float, minsum_offset: float,
                     count_against: torch.Tensor | None = None):
    """Flooding BP of a code without QC structure (Gallager, pyldpc) on its
    gather maps (code.ck_cols, code.var_edge), in pipeline order (JAX
    _decode_bp_graph). llr (B, n) -> (bits (B, n) int8, or per-codeword
    info-bit errors (B,) int32 against `count_against` (B, k); stats)."""
    global graph_decodes
    if algo not in ALGOS:
        raise ValueError(f"unknown BP check rule {algo!r}")
    graph_decodes += 1
    bits, iters, conv = _flood(
        code.ck_cols, code.var_edge, llr, cap,
        lambda q: _graph_check_update(q, algo, minsum_scale, minsum_offset))
    stats = {"iterations": iters, "converged": conv}
    if count_against is not None:
        bad = bits[:, code.m:] != count_against.to(torch.bool)
        return bad.sum(-1, dtype=torch.int32), stats
    return bits.to(torch.int8), stats


def _decode_layered(code: LdpcCode, llr_nat: torch.Tensor, cap: int,
                    algo: str, minsum_scale: float, minsum_offset: float,
                    diag: int = 0, kernel_form: bool = False):
    """Row-layered BP in natural order (the JAX _decode_bp_qc_layered).
    Base row i touches every variable once and its check (i, z') sees
    variable (j, z) iff z' == (z + shifts[i, j]) % Z, so a layer is dc rolls
    each way over the lifted index, no gathers. Same interface and stats as
    _decode_flooding; an iteration is one sweep over the dv layers.

    `diag` selects the plain version of one of the layered kernel's
    attribution builds, as in _decode_flooding: DIAG_FIXED never exits,
    DIAG_COPY_RULE makes the check rule return its clipped inputs,
    DIAG_NO_VAR_UPDATE drops the posterior write (Lt stays the channel
    LLRs, the messages still update) and DIAG_NO_SYNDROME only removes
    work.

    kernel_form=True takes the min-sum rules in the kernel's form
    (`minsum_form`) and loads the channel LLRs as llr + 0.0, as the kernel
    does; the bits and stats are the same (tests only)."""
    qc = code.qc
    Z, dv, dc = int(qc.Z), int(code.dv), int(code.dc)
    shifts = [[int(s) for s in row] for row in np.asarray(qc.shifts)]
    B = llr_nat.shape[0]

    def syndrome_ok(lt):
        d = (lt < 0).to(torch.int32)                          # (b, dc, Z)
        ok = torch.ones(lt.shape[0], dtype=torch.bool, device=lt.device)
        if diag & DIAG_FIXED:
            return ~ok
        for i in range(dv):
            acc = sum(torch.roll(d[:, j], shifts[i][j], -1)
                      for j in range(dc))
            ok &= (acc % 2 == 0).all(-1)
        return ok

    def sweep(r, lt):
        """r (b, dv, dc, Z) check->var messages, lt (b, dc, Z) posteriors."""
        for i in range(dv):
            # the posterior is rebuilt from the UNclipped q; only the
            # message entering the check is clipped
            q = lt - r[:, i]
            qc_ = torch.clamp(q, -MSG_CLIP, MSG_CLIP)
            t = torch.stack([torch.roll(qc_[:, j], shifts[i][j], -1)
                             for j in range(dc)], dim=-1)      # (b, Z, dc)
            if diag & DIAG_COPY_RULE:
                rc = t
            elif kernel_form and algo != "sumprod":
                rc = minsum_form(t, algo, minsum_scale, minsum_offset)
            else:
                rc = _check_update(t, algo, minsum_scale, minsum_offset)
            r_new = torch.stack([torch.roll(rc[..., j], -shifts[i][j], -1)
                                 for j in range(dc)], dim=1)   # (b, dc, Z)
            if not diag & DIAG_NO_VAR_UPDATE:
                lt = q + r_new
            r[:, i] = r_new
        return r, lt

    lc = llr_nat.to(torch.float32).reshape(B, dc, Z)
    if kernel_form:
        lc = lc + 0.0
    bits = (lc < 0).reshape(B, -1)
    done = syndrome_ok(lc)
    iters = torch.where(done, 0, cap).to(torch.int32)
    act = torch.nonzero(~done).flatten()
    lt_a = lc[act]
    r_a = torch.zeros(act.numel(), dv, dc, Z, device=lc.device)
    for it in range(cap):
        if act.numel() == 0:
            break
        r_a, lt_a = sweep(r_a, lt_a)
        ok = syndrome_ok(lt_a)
        fin = torch.ones_like(ok) if it + 1 == cap else ok
        bits[act[fin]] = (lt_a[fin] < 0).reshape(-1, dc * Z)
        iters[act[ok]] = it + 1
        done[act[ok]] = True
        keep = ~fin
        act, lt_a, r_a = act[keep], lt_a[keep], r_a[keep]
    return bits, iters, done


def ldpc_decode_bp_plain(code: LdpcCode, llr: torch.Tensor,
                         max_iter: int = 100, algo: str = "sumprod",
                         minsum_scale: float = 0.75, iter_cap=None,
                         schedule: str = "flooding", pass1_iters=None,
                         minsum_offset: float = 0.625,
                         count_against: torch.Tensor | None = None):
    """Plain version of the CUDA decoders (both schedules), on any device.

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
    decode = _decode_layered if schedule == "layered" else _decode_flooding
    run = lambda x, c: decode(code, x, c, algo, minsum_scale,  # noqa: E731
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

    QC codes: CUDA tensors run the BP kernel of the schedule
    (ldpc/decode_cuda.py), CPU tensors its plain version. Other codes:
    flooding BP on their graph (`_decode_bp_graph`) on either device;
    pass1_iters does not apply."""
    if code.qc is None:
        _check_graph_args(schedule)
        bits, st = _decode_bp_graph(code, llr, _effective_cap(
            max_iter, iter_cap), algo, minsum_scale, minsum_offset)
        return (bits, st) if return_stats else bits
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
    pipeline order -> (err (B,) int32, stats). Routes as ldpc_decode_bp."""
    if code.qc is None:
        _check_graph_args(schedule)
        return _decode_bp_graph(code, llr, _effective_cap(max_iter, iter_cap),
                                algo, minsum_scale, minsum_offset,
                                count_against=info_bits)
    from .decode_cuda import ldpc_decode_bp_cuda_counts
    return ldpc_decode_bp_cuda_counts(
        code, llr, info_bits, max_iter, algo, minsum_scale,
        iter_cap=iter_cap, schedule=schedule, pass1_iters=pass1_iters,
        minsum_offset=minsum_offset)
