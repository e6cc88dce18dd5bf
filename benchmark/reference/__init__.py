"""The plain reference of the benchmark: what each cell's timed calls must
return, worked out again from the same keys by plain PyTorch
(`reference.chain`, a frozen copy of the program's plain chain), and the
numbers that compare the two (`reference.compare`).

It imports torch, numpy and its own modules only: neither jax, nor the
JAX package, nor anything of the program. It builds its own configuration
from the configuration file's `sim` tree and takes nothing the program
made: the harness hands both sides the same block keys, and the reference
derives everything else (taps, bits, noise, reservoirs, readouts,
calibrators, codes) itself.

Each function returns an answer: a flat dict of host numbers, keyed as
the entries key the program's answers. `tf32=True` computes it with TF32
matrix products (the control: the nearest precision below the fp32 the
configuration states).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from .chain import config as rc


def sim_config(tree: dict) -> rc.SimConfig:
    """The reference's SimConfig from a configuration file's `sim` tree
    (dataclasses.asdict of the program's preset)."""
    groups = {"ofdm": rc.OfdmConfig, "pa": rc.PaConfig,
              "channel": rc.ChannelConfig, "esn": rc.EsnConfig,
              "ldpc": rc.LdpcConfig, "calib": rc.CalibConfig}
    kw = {k: (groups[k](**v) if k in groups else v) for k, v in tree.items()}
    kw["ebno_db"] = tuple(kw["ebno_db"])
    cfg = rc.SimConfig(**kw)
    if dataclasses.asdict(cfg) != _tupled(tree):
        raise ValueError("the configuration file's sim tree has fields the "
                         "reference's SimConfig does not")
    return cfg


def _tupled(tree: dict) -> dict:
    out = dict(tree)
    out["ebno_db"] = tuple(out["ebno_db"])
    return out


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 matrix products on (the control) or off (the reference), put
    back as they were on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _ints(prefix: str, dct: dict) -> dict:
    return {f"{prefix}.{k}": int(v) for k, v in dct.items()}


def cdl_point(cfg, ebno_db: float, cal_keys: torch.Tensor,
              dec_keys: torch.Tensor, tf32: bool = False) -> dict:
    """One calibrated CDL SNR point: cal rounds of cal_keys (Rc, B, 2), the
    calibrator fit, decode rounds of dec_keys (Rd, B, 2), each round's
    codewords decoded alone."""
    from .chain.pipelines import cdl
    m = cfg.ofdm.bits_per_symbol
    dets = cdl.CDL_DETECTORS
    with precision(tf32), torch.no_grad():
        cal = {d: 0 for d in dets}
        llrs, bits = {d: [] for d in dets}, []
        for keys in cal_keys:
            out = cdl.run_cdl_cal_blocks(cfg, ebno_db, keys)
            for d in dets:
                cal[d] += int(out.bit_errors[d])
                llrs[d].append(out.llr[d].reshape(-1, m))
            bits.append(out.bits.reshape(-1, m))
            del out
        calib = cdl.fit_calibrators(
            cfg, {d: torch.cat(v) for d, v in llrs.items()}, torch.cat(bits))
        del llrs, bits
        acc = {f: {d: 0 for d in dets} for f in
               ("bit_errors", "info_errors", "frame_errors", "iter_sum",
                "unconverged")}
        codewords = 0
        for keys in dec_keys:
            errs, _, Lcs, u = cdl.run_cdl_detect_llrs(cfg, ebno_db, keys,
                                                      calib)
            dec = cdl.cdl_decode_counters(cfg, Lcs, u)
            codewords += u.shape[0]
            for d in dets:
                acc["bit_errors"][d] += int(errs[d])
                acc["info_errors"][d] += int(dec["info_errors"][d])
                acc["frame_errors"][d] += int(dec["frame_errors"][d])
                acc["iter_sum"][d] += int(dec["iter_sum"][d])
                acc["unconverged"][d] += int(dec["unconv"][d])
            del Lcs, u, dec
    ans = _ints("cal_bit_errors", cal)
    for f, v in acc.items():
        ans.update(_ints(f, v))
    ans["codewords"] = codewords
    for d in dets:
        a, b = calib[d]
        for j in range(m):
            ans[f"calib_a.{d}.{j}"] = float(a[j])
            ans[f"calib_b.{d}.{j}"] = float(b[j])
    return ans


def cdl_chunks(cfg, ebno_db: float, keys: torch.Tensor,
               tf32: bool = False) -> dict:
    """The uncoded counters of R calibration chunks, keys (R, B, 2)."""
    from .chain.pipelines import cdl
    with precision(tf32), torch.no_grad():
        errs, total = cdl.run_cdl_cal_counters_chunks(cfg, ebno_db, keys)
    ans = _ints("bit_errors", errs)
    ans["total_bits"] = int(total)
    return ans


def nbf_round(cfg, ebno_db: float, keys: torch.Tensor,
              tf32: bool = False) -> dict:
    """The counters and analytics of one block-fading round, keys (B, 2),
    BP at the Eb/N0's cap."""
    from .chain.pipelines import blockfading as bf
    with precision(tf32), torch.no_grad():
        c = bf.run_nbf_blocks(cfg, ebno_db, keys)
    return nbf_answer(c)


def nbf_answer(c) -> dict:
    """A flat answer from an NbfCounts-like tuple (the program's or the
    reference's): per-detector counters, totals, the capacity sum and the
    condition histogram's bins."""
    ans = {}
    for f in ("bit_errors", "info_errors", "frame_errors", "ldpc_iter_sum",
              "ldpc_unconverged"):
        ans.update(_ints(f, getattr(c, f)))
    for f in ("total_bits", "total_info_bits", "rank_full_sum", "rank_count",
              "n_blocks", "ldpc_codewords"):
        ans[f] = int(getattr(c, f))
    ans["capacity_sum"] = float(c.capacity_sum)
    for i, v in enumerate(torch.as_tensor(c.cond_hist).tolist()):
        ans[f"cond_hist.{i}"] = int(v)
    return ans
