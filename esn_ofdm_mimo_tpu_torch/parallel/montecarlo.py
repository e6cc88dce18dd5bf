"""Monte-Carlo SNR points and curves (port of
esn_ofdm_mimo_tpu/parallel/montecarlo.py), on one GPU or over the ranks of
a `torch.distributed` layout (parallel/mesh.py).

Calibrated CDL, the JAX `_cdl_snr_point`:

    cal rounds     run_cdl_cal_blocks per round of G blocks: uncoded
                   counters + (llr, bit) calibration pairs
    calibrator fit fit_calibrators on the stacked pairs (per-bit GD)
    decode rounds  run_cdl_detect_llrs per round, and BP on its codewords

It runs two ways, with the same counters and calibrators bit for bit:

  * fused (`make_sharded_cdl_steps`, `make_fused_cdl_snr_step`,
    `make_fused_cdl_grid`, the JAX builders): the bodies of
    pipelines/cdl.py:CdlRounds, each captured once as a CUDA graph that
    reads its Eb/N0 row (pipelines/common.py:EbnoRow), keys and
    calibrators from device buffers, replayed for every round, SNR point
    and call; counters stay on the card until the caller reads them. A
    decode round decodes its own codewords (BP decodes each codeword
    alone), so no stacked-LLR cap applies. On the CPU the same bodies run
    eagerly with the plain kernels;
  * eager (`cdl_snr_point`, `cdl_decode_rounds`): Python loops of the same
    functions, one BP decode of the round-stacked LLRs, the counters read
    as Python ints. The fused builders and `run_cdl_curve` take it by
    configuration only, where `eager_reason` names one: a code without QC
    structure (the graph decoder compacts with torch.nonzero) or an
    active `debug_nan_checks` (its checks read values on the host). A
    capture that fails raises (pipelines/graphs.py:GraphCaptureError);
    nothing falls back.

`run_cdl_curve` sweeps the SNR grid as the JAX one does: without a
checkpoint the whole grid (`make_fused_cdl_grid`), with one the per-SNR
step, the adaptive top-up through `dec_step` (extra decode rounds that
continue the id stream until every detector has enough errors or the block
cap is reached). The round budget is split into calibration and decode
rounds, per-SNR keys are block_keys(root, snr index, global block ids)
with the calibration ids first; per-SNR checkpoints and progress lines.

Block fading: rounds of run_nbf_blocks, counters summed per SNR, the same
key stream (the one the JAX fused NBF grid folds on the device), the same
top-up, checkpoints and progress, and `assemble_curve` into a
`CurveResult`. Two ways again, with the same counters bit for bit:

  * fused (`make_sharded_nbf_step`, `make_sharded_nbf_scan_step`,
    `make_fused_nbf_grid`, the JAX builders): the round body of
    pipelines/blockfading.py:NbfRounds, one CUDA graph a BP cap, replayed
    for every round, call and SNR point; counters on the card until read;
  * eager (`nbf_snr_point`): a Python loop of run_nbf_blocks, where
    `nbf_eager_reason` names a reason (a code without QC structure,
    debug_nan_checks; uncoded configs run fused).

`run_nbf_curve` routes as the JAX one does: the grid without a checkpoint,
the scan step a call with one, a `step_factory` (the fault-injection hook)
one round a call; the top-up through the scan step.

Counters are summed in int64, so the JAX package's int32 guards go away.
`_call_with_retry` re-runs a call on a runtime failure: calls are pure
functions of their keys, so a retry is exact.

Over ranks (`mesh`, the JAX shard_map over the "trials" axis): the SNR
points and curves take the same global keys on every rank; of each round
of G global blocks, rank r runs the contiguous share [r G/W, (r+1) G/W),
W ranks. Counters are summed over the ranks (int64; the float capacity
sum in float64, exact for its float32 terms), and the CDL calibration
pairs are gathered in global block order before the calibrator fit, so
every rank fits the same calibrators and takes the same top-up branch.
Both routes run over ranks. The fused one keeps everything on the card:
each rank captures and replays its own bodies on its share, and the
collectives (parallel/mesh.py:all_gather_into, all_sum_) run between the
replays on the replays' stream, outside the graphs: the pairs gathered
after a point's cal rounds, the counters summed once a call (a grid: once,
on its stacked per-SNR buffers). Every rank replays the same bodies in the
same order: nothing the host decides between them reads rank-local data.
Rank 0 alone writes checkpoints. Under EsnConfig(rng_mode="block") the
counters equal one process's bit for bit whatever the layout; under
"batch" each rank's share has its own shared reservoir, as each device's
has in the JAX package. Calls over ranks are not retried: a rank that ran
a round again would leave the others' collectives unmatched.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import SimConfig
from ..pipelines.blockfading import (NbfCounts, NbfRounds, bp_iter_cap,
                                     run_nbf_blocks)
from ..pipelines.cdl import (CDL_DETECTORS, CdlCalData, CdlCounts, CdlRounds,
                             cdl_decode_counters, fit_calibrators,
                             run_cdl_cal_blocks, run_cdl_detect_llrs)
from ..pipelines.common import EbnoRow, ebno_rows
from ..pipelines.graphs import GraphCaptureError, cached_graphs, graph_key
from ..utils import rng
from ..utils.device import resolve_device
from ..utils.metrics import (EventClock, PhaseClock, check_finite,
                             nan_checks_enabled)
from .mesh import TrialsMesh, all_gather_cat, all_sum_


class CdlSnrPoint(NamedTuple):
    """One calibrated SNR point (the JAX step's (cal errors, cal bits,
    CdlCounts, calib)). Its counters are Python ints, or, as the fused
    step returns them, int64 0-d tensors on the card until read."""
    cal_bit_errors: dict       # detector -> uncoded errors over the cal rounds
    cal_total_bits: int
    counts: CdlCounts          # decode rounds: uncoded + coded counters, BP
    #                            telemetry (iteration sum, unconverged)
    calib: dict                # detector -> (a (m,), b (m,)) calibrators


def _distributed(mesh: TrialsMesh | None) -> bool:
    return mesh is not None and mesh.group is not None


def _layout(mesh: TrialsMesh | None) -> tuple:
    """(ranks, this rank) of the layout a fused call runs over."""
    return (mesh.size, mesh.rank) if _distributed(mesh) else (1, 0)


def _sum_(mesh: TrialsMesh | None, *accs: torch.Tensor):
    """Device accumulators summed over the layout's ranks in place."""
    if _distributed(mesh):
        for x in accs:
            all_sum_(mesh, x)


def _share(keys: torch.Tensor, mesh: TrialsMesh | None) -> torch.Tensor:
    """This rank's contiguous share of every round of keys (R, G, 2)."""
    if not _distributed(mesh):
        return keys
    if not mesh.member:
        raise ValueError("this process is not a rank of the layout")
    G = keys.shape[1]
    if G % mesh.size:
        raise ValueError(f"a round of {G} blocks does not split over "
                         f"{mesh.size} ranks")
    g = G // mesh.size
    return keys[:, mesh.rank * g:(mesh.rank + 1) * g]


def _sum_over_ranks(counts, mesh: TrialsMesh | None):
    """Counters (a NamedTuple of ints, floats, int arrays and dicts of
    ints; None fields stay None) summed over the layout's ranks: the
    integers in int64, the floats in float64."""
    if not _distributed(mesh):
        return counts
    ints, floats = [], []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, float):
            floats.append(x)
        elif isinstance(x, np.ndarray):
            ints.extend(int(v) for v in x.reshape(-1))
        elif x is not None:
            ints.append(int(x))

    for field in counts:
        walk(field)
    si = iter(all_sum_(mesh, torch.tensor(ints, dtype=torch.int64)).tolist())
    sf = iter(all_sum_(mesh, torch.tensor(floats, dtype=torch.float64))
              .tolist() if floats else [])

    def rebuild(x):
        if isinstance(x, dict):
            got = {k: rebuild(x[k]) for k in sorted(x)}
            return {k: got[k] for k in x}
        if isinstance(x, float):
            return next(sf)
        if isinstance(x, np.ndarray):
            return np.asarray([next(si) for _ in range(x.size)],
                              dtype=np.int64).reshape(x.shape)
        return None if x is None else next(si)

    return type(counts)(*(rebuild(f) for f in counts))


def cdl_snr_point(cfg: SimConfig, ebno_db: float, cal_keys, dec_keys,
                  device=None, timings: dict | None = None,
                  mesh: TrialsMesh | None = None) -> CdlSnrPoint:
    """Calibration rounds, calibrator fit and decode rounds at one Eb/N0.

    cal_keys (Rc, G, 2) and dec_keys (Rd, G, 2): per-block uint32 key data
    (numpy arrays, or tensors) as utils.rng.block_keys makes them — the JAX
    package's `jax.random.key_data` layout, so the same keys give the same
    per-block draws. `device` defaults to "cuda" and raises without CUDA
    unless "cpu" is asked for. `timings`, when given, receives the wall ms
    of each phase (cal, fit, detect, decode). With a `mesh` every rank
    passes the same global keys and runs its share of each round; the
    calibration pairs are gathered in global block order and the counters
    summed, so every rank returns the same point."""
    dev = resolve_device(device)
    cal_keys = _share(rng.as_keys(cal_keys, dev), mesh)
    dec_keys = _share(rng.as_keys(dec_keys, dev), mesh)
    m = cfg.ofdm.bits_per_symbol
    clock = PhaseClock(dev, timings)

    cal_errs = {d: 0 for d in CDL_DETECTORS}
    cal_bits, llrs, bits = 0, {d: [] for d in CDL_DETECTORS}, []
    for keys in cal_keys:
        out = run_cdl_cal_blocks(cfg, ebno_db, keys)
        for d in CDL_DETECTORS:
            cal_errs[d] = cal_errs[d] + out.bit_errors[d]
            llrs[d].append(out.llr[d].reshape(-1, m))
        cal_bits += out.total_bits
        bits.append(out.bits.reshape(-1, m))
    clock.mark("cal")
    check_finite("the calibration LLRs", *(x for v in llrs.values()
                                           for x in v))

    def pairs(rounds):
        """(rounds, n, m) of each rank -> every round's global blocks in
        order, rounds one after another: (rounds * n * ranks, m)."""
        return all_gather_cat(mesh, torch.stack(rounds), 1).reshape(-1, m) \
            if _distributed(mesh) else torch.cat(rounds)

    calib = fit_calibrators(cfg, {d: pairs(v) for d, v in llrs.items()},
                            pairs(bits))
    clock.mark("fit")

    counts = _cdl_decode_rounds(cfg, ebno_db, dec_keys, calib, clock, mesh)
    cal = _sum_over_ranks(CdlSnrPoint(_ints(cal_errs), cal_bits, None, None),
                          mesh)
    return cal._replace(counts=counts, calib=calib)


def _ints(dct: dict) -> dict:
    return {k: int(v) for k, v in dct.items()}


def _cdl_decode_rounds(cfg: SimConfig, ebno_db: float, dec_keys, calib: dict,
                       clock: PhaseClock, mesh: TrialsMesh | None = None
                       ) -> CdlCounts:
    """Detection per round of dec_keys (Rd, G, 2), one BP decode of the
    round-stacked LLRs; CdlCounts of Python ints, summed over the ranks of
    `mesh` (dec_keys are this rank's share)."""
    dec_errs = {d: 0 for d in CDL_DETECTORS}
    dec_bits, Lcs, us = 0, {d: [] for d in CDL_DETECTORS}, []
    for keys in dec_keys:
        errs, tot, Lc, u = run_cdl_detect_llrs(cfg, ebno_db, keys, calib)
        for d in CDL_DETECTORS:
            dec_errs[d] = dec_errs[d] + errs[d]
            Lcs[d].append(Lc[d])
        dec_bits += tot
        us.append(u)
    clock.mark("detect")
    u = torch.cat(us)
    Lcs = {d: torch.cat(v) for d, v in Lcs.items()}
    check_finite("the calibrated decode LLRs", *Lcs.values())
    dec = cdl_decode_counters(cfg, Lcs, u)
    clock.mark("decode")
    return _sum_over_ranks(CdlCounts(
        bit_errors=_ints(dec_errs), total_bits=dec_bits,
        info_errors=_ints(dec["info_errors"]), total_info_bits=u.numel(),
        frame_errors=_ints(dec["frame_errors"]),
        ldpc_iter_sum=_ints(dec["iter_sum"]),
        ldpc_unconverged=_ints(dec["unconv"]), ldpc_codewords=u.shape[0]),
        mesh)


def cdl_decode_rounds(cfg: SimConfig, ebno_db: float, dec_keys, calib: dict,
                      device=None, timings: dict | None = None,
                      mesh: TrialsMesh | None = None) -> CdlCounts:
    """Decode rounds alone, with calibrators already fitted (the JAX
    dec_step): what the curve's extra and top-up rounds run. dec_keys
    (Rd, G, 2), global with a `mesh`; calib detector -> (a, b), tensors or
    array-likes."""
    dev = resolve_device(device)
    calib = {d: tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                      for x in ab) for d, ab in calib.items()}
    return _cdl_decode_rounds(cfg, ebno_db,
                              _share(rng.as_keys(dec_keys, dev), mesh), calib,
                              PhaseClock(dev, timings), mesh)


def eager_reason(cfg: SimConfig, mesh: TrialsMesh | None = None
                 ) -> str | None:
    """Why the calibrated CDL route runs eagerly on this configuration, or
    None where it runs fused (the two cases of the module docstring; any
    layout `mesh` runs fused)."""
    if not (cfg.ldpc.enabled and cfg.ldpc.family == "qc"):
        return "a code without QC structure"
    if nan_checks_enabled():
        return "debug_nan_checks"
    return None


def nbf_eager_reason(cfg: SimConfig, mesh: TrialsMesh | None = None
                     ) -> str | None:
    """Why the block-fading route runs eagerly, or None where it runs fused:
    the reasons of `eager_reason`, but an uncoded config (no code, no BP)
    runs fused."""
    if cfg.ldpc.enabled and cfg.ldpc.family != "qc":
        return "a code without QC structure"
    if nan_checks_enabled():
        return "debug_nan_checks"
    return None


def _on(dev: torch.device):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _rounds(cfg: SimConfig, G: int, dev: torch.device,
            mesh: TrialsMesh | None = None) -> CdlRounds:
    """The cached CdlRounds of (cfg, G blocks a round on this rank, card,
    predict switch, layout)."""
    key = graph_key(cfg, G, dev, "cdl", _layout(mesh))
    return cached_graphs(key, lambda: CdlRounds(key[1], G, key[3],
                                                *key[5]))


def _stage_row(g: CdlRounds, cfg: SimConfig, ebno_db):
    """Copy the row of `ebno_db` (a float, or an EbnoRow) into g.row: a
    device-to-device copy from its staged row."""
    g.row.copy_(torch.stack(tuple(ebno_db)) if isinstance(ebno_db, EbnoRow)
                else ebno_rows(cfg, (ebno_db,), g.dev)[0])


def _unpack(g: CdlRounds, cal_acc, dec_acc, calib, Rc: int, Rd: int
            ) -> CdlSnrPoint:
    """A point from packed counters summed over the ranks (cal_acc
    (n_det,), dec_acc (5, n_det), calib (n_det, 2, m)): tensors give
    tensor views, nested lists ints; the totals are the layout's."""
    def per(x):
        return {d: x[i] for i, d in enumerate(CDL_DETECTORS)}

    W = g.ranks
    counts = CdlCounts(
        bit_errors=per(dec_acc[0]), total_bits=Rd * W * g.code_bits,
        info_errors=per(dec_acc[1]), total_info_bits=Rd * W * g.info_bits,
        frame_errors=per(dec_acc[2]), ldpc_iter_sum=per(dec_acc[3]),
        ldpc_unconverged=per(dec_acc[4]),
        ldpc_codewords=Rd * W * g.codewords)
    return CdlSnrPoint(per(cal_acc), Rc * W * g.code_bits, counts,
                       {d: (c[0], c[1]) for d, c in per(calib).items()})


def _host_counts(c: CdlCounts) -> CdlCounts:
    """CdlCounts with tensor counters read as Python ints."""
    def ints(d):
        return {k: int(v) for k, v in d.items()}
    return c._replace(bit_errors=ints(c.bit_errors),
                      info_errors=ints(c.info_errors),
                      frame_errors=ints(c.frame_errors),
                      ldpc_iter_sum=ints(c.ldpc_iter_sum),
                      ldpc_unconverged=ints(c.ldpc_unconverged))


def _host_point(pt: CdlSnrPoint) -> CdlSnrPoint:
    return pt._replace(
        cal_bit_errors={k: int(v) for k, v in pt.cal_bit_errors.items()},
        counts=_host_counts(pt.counts))


def host_point(pt: CdlSnrPoint) -> CdlSnrPoint:
    """Every field of a point on the host: counters as Python ints, the
    calibrators as CPU tensors. Reading a fused step's point this way waits
    for all of its work on the card."""
    return _host_point(pt)._replace(
        calib={d: (torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu())
               for d, (a, b) in pt.calib.items()})


def make_sharded_cdl_steps(cfg: SimConfig, device=None,
                           mesh: TrialsMesh | None = None):
    """(cal_step, dec_step) of the calibrated CDL pipeline (JAX
    make_sharded_cdl_steps):

        cal_step(row, keys (G, 2)) -> CdlCalData: the round's uncoded
            counters, raw LLRs and code bits, (G, D, n_tx, N, m)
        dec_step(row, keys (Rd, G, 2), calib, timings=None) -> CdlCounts:
            Rd decode rounds with the calibrators calib (detector -> (a,
            b), tensors or array-likes)

    `row` is an Eb/N0 float or its EbnoRow; with a `mesh` the keys are
    global and each rank runs its share. Both routes sum the counters over
    the ranks and leave the pairs on the rank (the JAX cal_step leaves
    them sharded). Fused (`eager_reason` None): the CdlRounds bodies, CUDA
    graphs on the card, counters int64 0-d tensors on the device, summed
    over the ranks there, no host sync until the caller reads them;
    `timings`, when given, receives the detect and decode ms (CUDA events,
    read at the end of the call). Eager (a code without QC structure,
    debug_nan_checks): run_cdl_cal_blocks and `cdl_decode_rounds`."""
    dev = resolve_device(device)
    reason = eager_reason(cfg, mesh)

    def cal_step(row, keys) -> CdlCalData:
        keys = _share(rng.as_keys(keys, dev)[None], mesh)[0]
        if reason is not None:
            out = run_cdl_cal_blocks(cfg, row, keys)
            sums = _sum_over_ranks(CdlSnrPoint(_ints(out.bit_errors),
                                               out.total_bits, None, None),
                                   mesh)
            return out._replace(bit_errors=sums.cal_bit_errors,
                                total_bits=sums.cal_total_bits)
        with _on(dev):
            g = _rounds(cfg, keys.shape[0], dev, mesh)
            _stage_row(g, cfg, row)
            g.keys.copy_(keys)
            cal = g.body("cal")          # captured (and warmed up) first
            g.cal_acc.zero_()
            cal.run()
            errs = g.cal_acc.clone()
            _sum_(mesh, errs)
            shape = (keys.shape[0], cfg.data_symbols_per_block,
                     cfg.channel.n_tx, cfg.ofdm.n_subcarriers, g.m)
            return CdlCalData(
                bit_errors={d: errs[i] for i, d in enumerate(CDL_DETECTORS)},
                total_bits=g.ranks * g.code_bits,
                llr={d: g.llr[i].reshape(shape).clone()
                     for i, d in enumerate(CDL_DETECTORS)},
                bits=g.bits.reshape(shape).clone())

    def dec_step(row, keys, calib: dict, timings: dict | None = None
                 ) -> CdlCounts:
        if reason is not None:
            return cdl_decode_rounds(cfg, row, keys, calib, dev, timings,
                                     mesh)
        keys = _share(rng.as_keys(keys, dev), mesh)
        with _on(dev):
            g = _rounds(cfg, keys.shape[1], dev, mesh)
            _stage_row(g, cfg, row)
            g.calib.copy_(torch.stack([torch.stack([
                torch.as_tensor(x, dtype=torch.float32, device=dev)
                for x in calib[d]]) for d in CDL_DETECTORS]))
            g.prepare_decode(keys)
            g.dec_acc.zero_()
            clock = EventClock(dev, timings)
            g.decode_rounds(keys, clock)
            dec = g.dec_acc.clone()
            _sum_(mesh, dec)
            counts = _unpack(g, g.cal_acc, dec, g.calib, 0,
                             keys.shape[0]).counts
            clock.flush()
            return counts

    return cal_step, dec_step


def make_fused_cdl_snr_step(cfg: SimConfig, device=None,
                            mesh: TrialsMesh | None = None):
    """One SNR point a call (JAX make_fused_cdl_snr_step): step(ebno_db,
    cal_keys (Rc, G, 2), dec_keys (Rd, G, 2), timings=None) ->
    CdlSnrPoint, the round counts set by the keys' shapes.

    On the card: the Eb/N0 row (ebno_db a float, or its EbnoRow) and each
    round's keys are copied into the CdlRounds buffers (device to device),
    the cal graph replayed Rc times (each round's pairs copied into slot r
    of the fit's stacked input), the fit graph of Rc once, the detect and
    decode graphs Rd times; the first call of a (cfg, G) captures them.
    With a `mesh` the keys are global: each rank replays its own bodies on
    its share of every round, the pairs of all ranks are gathered between
    the cal rounds and the fit (every rank fits the same calibrators, as
    `cdl_snr_point` over the ranks does) and the counters summed over the
    ranks at the end, on the card. The point's counters are int64 0-d
    tensors on the card: nothing syncs the host until the caller reads
    them (`timings`, when given, receives each phase's ms from CUDA events
    and so syncs at the end). On the CPU the same bodies run eagerly. Where
    `eager_reason` names a reason (a code without QC structure,
    debug_nan_checks) the step is `cdl_snr_point`."""
    dev = resolve_device(device)
    reason = eager_reason(cfg, mesh)

    def step(ebno_db, cal_keys, dec_keys, timings: dict | None = None
             ) -> CdlSnrPoint:
        if reason is not None:
            return cdl_snr_point(cfg, ebno_db, cal_keys, dec_keys, dev,
                                 timings, mesh)
        ck = _share(rng.as_keys(cal_keys, dev), mesh)
        dk = _share(rng.as_keys(dec_keys, dev), mesh)
        with _on(dev):
            g = _rounds(cfg, ck.shape[1], dev, mesh)
            clock = EventClock(dev, timings)
            _stage_row(g, cfg, ebno_db)
            g.point(ck, dk, clock, mesh)
            cal, dec = g.cal_acc.clone(), g.dec_acc.clone()
            _sum_(mesh, cal, dec)
            pt = _unpack(g, cal, dec, g.calib.clone(), ck.shape[0],
                         dk.shape[0])
            clock.flush()
            return pt

    return step


def make_fused_cdl_grid(cfg: SimConfig, blocks_per_round: int,
                        cal_rounds: int, dec_rounds: int, device=None,
                        mesh: TrialsMesh | None = None):
    """The whole SNR grid of cfg.ebno_db in one call (JAX
    make_fused_cdl_grid): grid(root, timings=None) -> one host CdlSnrPoint
    per SNR point, counters Python ints, calibrators CPU tensors.

    It folds every point's keys on the device up front, block_keys(root,
    snr index, ids 0 .. (cal_rounds + dec_rounds) * blocks_per_round - 1)
    with the calibration ids first (the per-SNR path's stream), stages
    every point's Eb/N0 row once, runs the step's replays for each point
    and copies its counters and calibrators into stacked (n_snr, ...)
    device buffers, and reads those once, at the end. With a `mesh` a round
    holds blocks_per_round global blocks, each rank runs its share as the
    step does, and the stacked counters are summed over the ranks once,
    before that read. Equal to the per-SNR step (and to `cdl_snr_point`)
    on the same keys, bit for bit. Where `eager_reason` names a reason it
    loops `cdl_snr_point`."""
    dev = resolve_device(device)
    G, Rc, Rd = blocks_per_round, cal_rounds, dec_rounds
    ebnos = tuple(float(e) for e in np.asarray(cfg.ebno_db,
                                               dtype=np.float32))
    reason = eager_reason(cfg, mesh)

    def grid(root, timings: dict | None = None) -> list:
        root = rng.as_keys(root, dev)
        ids = torch.arange((Rc + Rd) * G, device=dev)
        keys = [rng.block_keys(root, jj, ids).reshape(Rc + Rd, G, 2)
                for jj in range(len(ebnos))]
        if reason is not None:
            return [cdl_snr_point(cfg, e, k[:Rc], k[Rc:], dev, timings,
                                  mesh) for e, k in zip(ebnos, keys)]
        keys = [_share(k, mesh) for k in keys]
        with _on(dev):
            g = _rounds(cfg, G // _layout(mesh)[0], dev, mesh)
            rows = ebno_rows(cfg, ebnos, dev)
            n = len(ebnos)
            cal_out = g.cal_acc.new_zeros((n,) + g.cal_acc.shape)
            dec_out = g.dec_acc.new_zeros((n,) + g.dec_acc.shape)
            calib_out = g.calib.new_zeros((n,) + g.calib.shape)
            clock = EventClock(dev, timings)
            for jj in range(n):
                g.row.copy_(rows[jj])
                g.point(keys[jj][:Rc], keys[jj][Rc:], clock, mesh)
                cal_out[jj].copy_(g.cal_acc)
                dec_out[jj].copy_(g.dec_acc)
                calib_out[jj].copy_(g.calib)
            _sum_(mesh, cal_out, dec_out)
            cal_h, dec_h = cal_out.tolist(), dec_out.tolist()
            calib_h = calib_out.cpu()
            clock.flush()
        return [_unpack(g, cal_h[j], dec_h[j], calib_h[j], Rc, Rd)
                for j in range(n)]

    return grid


def _add_counts(a, b):
    """Field-wise sum of two counter NamedTuples (dict fields per key)."""
    return type(a)(*({k: x[k] + y[k] for k in x} if isinstance(x, dict)
                     else x + y for x, y in zip(a, b)))


def _host(x):
    """A counter leaf on the host: int, float, or an int64 numpy array
    (host values pass through)."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if not isinstance(x, torch.Tensor):
        return x
    if x.ndim > 0:
        return x.cpu().numpy().astype(np.int64)
    return float(x) if x.is_floating_point() else int(x)


def _host_nbf(c: NbfCounts) -> NbfCounts:
    return NbfCounts(*(_host(x) for x in c))


def nbf_snr_point(cfg: SimConfig, ebno_db: float, keys, device=None,
                  timings: dict | None = None,
                  mesh: TrialsMesh | None = None) -> NbfCounts:
    """Rounds of run_nbf_blocks at one Eb/N0, counters summed over rounds:
    the eager block-fading point.

    keys (R, G, 2): per-block uint32 key data (numpy or tensors), as
    utils.rng.block_keys makes them. `device` defaults to "cuda" and raises
    without CUDA unless "cpu" is asked for. `timings`, when given, receives
    the wall ms of each phase summed over rounds (synth_fit, detect,
    decode, analytics). Returns NbfCounts of Python ints and floats, the
    histogram as an int64 numpy array. With a `mesh` every rank passes the
    same global keys, runs its share of each round, and returns the
    counters summed over the ranks."""
    dev = resolve_device(device)
    keys = _share(rng.as_keys(keys, dev), mesh)
    clock = PhaseClock(dev, timings)
    acc = None
    for bkeys in keys:
        c = run_nbf_blocks(cfg, ebno_db, bkeys, mark=clock.mark)
        acc = c if acc is None else _add_counts(acc, c)
    return _sum_over_ranks(_host_nbf(acc), mesh)


def _nbf_rounds(cfg: SimConfig, G: int, dev: torch.device,
                mesh: TrialsMesh | None = None) -> NbfRounds:
    """The cached NbfRounds of (cfg, G blocks a round on this rank, card,
    predict switch, layout)."""
    key = graph_key(cfg, G, dev, "nbf", _layout(mesh))
    return cached_graphs(key, lambda: NbfRounds(key[1], G, key[3]))


def _nbf_cap(cfg: SimConfig, ebno_db: float) -> int | None:
    """A call's BP cap, bp_iter_cap of its Eb/N0; None for an uncoded
    config (no BP, one body)."""
    return bp_iter_cap(cfg, ebno_db) if cfg.ldpc.enabled else None


def make_sharded_nbf_scan_step(cfg: SimConfig, device=None,
                               mesh: TrialsMesh | None = None):
    """R rounds a call (JAX make_sharded_nbf_scan_step): step(ebno_db, keys
    (R, G, 2)) -> NbfCounts summed over the R rounds.

    Fused (`nbf_eager_reason` None): the Eb/N0's row and each round's keys
    are copied into the NbfRounds buffers (device to device) and the body
    of the Eb/N0's BP cap replayed R times; the first call of a (cfg, G, cap)
    captures it. With a `mesh` the keys are global: each rank replays its
    own body on its share of every round, and after the rounds the
    accumulators are summed over the ranks on the card. The counters are
    int64 (capacity float64) tensors on the card: nothing syncs the host
    until the caller reads them. On the CPU the same body runs eagerly.
    Eager: `nbf_snr_point` (with a `mesh`, on this rank's share, the
    counters summed over the ranks)."""
    dev = resolve_device(device)
    reason = nbf_eager_reason(cfg, mesh)

    def step(ebno_db: float, keys) -> NbfCounts:
        if reason is not None:
            return nbf_snr_point(cfg, ebno_db, keys, dev, mesh=mesh)
        keys = _share(rng.as_keys(keys, dev), mesh)
        with _on(dev):
            g = _nbf_rounds(cfg, keys.shape[1], dev, mesh)
            _stage_row(g, cfg, ebno_db)
            g.rounds(keys, _nbf_cap(cfg, ebno_db))
            _sum_(mesh, *g.accs)
            return g.counts()

    return step


def make_sharded_nbf_step(cfg: SimConfig, device=None,
                          mesh: TrialsMesh | None = None):
    """One round a call (JAX make_sharded_nbf_step): step(ebno_db, keys
    (G, 2)) -> NbfCounts, the scan step on one round."""
    dev = resolve_device(device)
    scan = make_sharded_nbf_scan_step(cfg, dev, mesh)

    def step(ebno_db: float, keys) -> NbfCounts:
        return scan(ebno_db, rng.as_keys(keys, dev)[None])

    return step


def make_fused_nbf_grid(cfg: SimConfig, blocks_per_round: int, rounds: int,
                        device=None, mesh: TrialsMesh | None = None):
    """The whole SNR grid of cfg.ebno_db in one call (JAX
    make_fused_nbf_grid): grid(root) -> one host NbfCounts per SNR point.

    It folds every point's keys on the device up front, block_keys(root,
    snr index, ids 0 .. rounds * blocks_per_round - 1) (the per-SNR path's
    stream), stages every point's Eb/N0 row once, picks each point's BP
    cap on the host from cfg.ebno_db, replays the rounds and copies the
    point's counters into stacked (n_snr, ...) device buffers, and reads
    those once, at the end. With a `mesh` each rank runs its share of the
    global rounds of blocks_per_round blocks, and the stacked counters are
    summed over the ranks once, before that read. Equal to the per-SNR
    scan step (and to `nbf_snr_point`) on the same keys, bit for bit. Where
    `nbf_eager_reason` names a reason it loops `nbf_snr_point` (with a
    `mesh`, over the ranks too)."""
    dev = resolve_device(device)
    G, R = blocks_per_round, rounds
    ebnos = tuple(float(e) for e in np.asarray(cfg.ebno_db,
                                               dtype=np.float32))
    reason = nbf_eager_reason(cfg, mesh)

    def grid(root) -> list:
        root = rng.as_keys(root, dev)
        ids = torch.arange(R * G, device=dev)
        keys = [rng.block_keys(root, jj, ids).reshape(R, G, 2)
                for jj in range(len(ebnos))]
        if reason is not None:
            return [nbf_snr_point(cfg, e, k, dev, mesh=mesh)
                    for e, k in zip(ebnos, keys)]
        keys = [_share(k, mesh) for k in keys]
        with _on(dev):
            g = _nbf_rounds(cfg, G // _layout(mesh)[0], dev, mesh)
            rows = ebno_rows(cfg, ebnos, dev)
            outs = [b.new_zeros((len(ebnos),) + b.shape) for b in g.accs]
            for jj, e in enumerate(ebnos):
                g.row.copy_(rows[jj])
                g.rounds(keys[jj], _nbf_cap(cfg, e))
                for o, b in zip(outs, g.accs):
                    o[jj].copy_(b)
            _sum_(mesh, *outs)
            det, tot, cap = (o.tolist() for o in outs[:3])
            hist = outs[3].cpu().numpy()
        return [g.counts(det[j], tot[j], cap[j], hist[j])
                for j in range(len(ebnos))]

    return grid


@dataclasses.dataclass
class CurveResult:
    """Assembled BER curves and channel analytics for one experiment."""
    ebno_db: np.ndarray
    ber: Dict[str, np.ndarray]          # uncoded, per detector
    ber_coded: Dict[str, np.ndarray]    # post-LDPC, per detector
    capacity_per_sc: np.ndarray
    frac_rank_full: np.ndarray
    cond_hist: np.ndarray               # (n_snr, nbins)
    total_bits: np.ndarray
    total_info_bits: np.ndarray
    n_blocks: np.ndarray
    # BP telemetry: mean iterations and the unconverged fraction
    ldpc_avg_iters: Dict[str, np.ndarray]
    ldpc_unconverged_frac: Dict[str, np.ndarray]


# Deterministic program and user errors that a retry cannot fix: running
# them again only delays the real traceback. Runtime errors of the backend
# (a failed launch, an allocation that did not fit) stay retryable.
_NO_RETRY = (TypeError, ValueError, AssertionError, AttributeError, KeyError,
             NotImplementedError, FloatingPointError, GraphCaptureError)


def _call_with_retry(step, args, retries: int = 2,
                     progress: Optional[Callable[[str], None]] = None):
    """Run step(*args), again on a runtime failure, `retries` times at most.
    Rounds are pure functions of their keys, so a retry is exact."""
    last = None
    for attempt in range(retries + 1):
        try:
            return step(*args)
        except _NO_RETRY:
            raise
        except Exception as e:  # noqa: BLE001 - backend errors are opaque
            last = e
            if progress is not None:
                progress(f"[mc] round failed (attempt {attempt + 1}): {e}")
    raise last


def _writes(mesh: TrialsMesh | None) -> bool:
    """Whether this process writes checkpoints: rank 0 of a layout."""
    return mesh is None or mesh.rank == 0


def _round_keys(root: torch.Tensor, snr_idx: int, first_id: int,
                n_rounds: int, G: int) -> torch.Tensor:
    """Keys (n_rounds, G, 2) of the global block ids first_id .. first_id +
    n_rounds * G - 1 at one SNR index."""
    ids = torch.arange(first_id, first_id + n_rounds * G)
    return rng.block_keys(root, snr_idx, ids).reshape(n_rounds, G, 2)


def _adaptive_topup(acc, run_rounds, stop_counts, unit: str, tag: str,
                    ebno: float, G: int, blocks: int, first_id: int,
                    min_errors: Optional[int], max_blocks: int,
                    rounds_per_call: int, progress):
    """Sequential Monte-Carlo extension at one SNR point: while any
    detector's count in `stop_counts(acc)` is below `min_errors`, add up to
    `rounds_per_call` whole rounds of G blocks through `run_rounds(first
    block id, rounds)`, never passing `max_blocks` (`blocks` are already
    in). Block ids continue the base budget's, so an adaptive run's sample
    contains the fixed-budget run's. The progress line names the counter
    the stop rule reads. Returns the summed counters."""
    if not min_errors:
        return acc
    extra = 0
    # whole rounds only: stop when less than one round is left under the cap
    while (min(int(v) for v in stop_counts(acc).values()) < min_errors
           and max_blocks - blocks >= G):
        n_rounds = min(max(1, rounds_per_call), (max_blocks - blocks) // G)
        acc = _add_counts(acc, run_rounds(first_id + extra, n_rounds))
        blocks += n_rounds * G
        extra += n_rounds * G
    if progress is not None and extra:
        errs = {d: int(v) for d, v in stop_counts(acc).items()}
        progress(f"[{tag}] EbNo={ebno:g} dB adaptive: +{extra} blocks "
                 f"({blocks} {'decoded' if tag == 'cdl' else 'total'}), "
                 f"{unit} {errs}")
    return acc


def run_nbf_curve(cfg: SimConfig, blocks_per_snr: int,
                  blocks_per_round: int = 4, seed: Optional[int] = None,
                  device=None,
                  progress: Optional[Callable[[str], None]] = print,
                  checkpoint=None, rounds_per_call: int = 4,
                  adaptive_min_errors: Optional[int] = None,
                  adaptive_max_blocks: Optional[int] = None,
                  adaptive_on_uncoded: bool = False,
                  mesh: TrialsMesh | None = None,
                  step_factory=None) -> CurveResult:
    """The SNR sweep of a block-fading experiment (JAX run_nbf_curve).

    blocks_per_snr is rounded up to whole calls of `rounds_per_call` rounds
    of `blocks_per_round` blocks a rank (the JAX blocks_per_device; one
    rank without a `mesh`), as the JAX package rounds it to whole
    dispatches. Block keys are block_keys(PRNGKey(seed), snr index, 0 ..
    n - 1), the JAX package's stream, so the classical detectors draw the
    same blocks.

    The route, as the JAX package picks it: without a checkpoint the whole
    grid in one call (`make_fused_nbf_grid`), with one the scan step
    (`make_sharded_nbf_scan_step`) a call of `rounds_per_call` rounds; a
    `step_factory(cfg, device=..., mesh=...)` (the fault-injection hook)
    gives a step of the legacy signature, step(ebno_db, keys (G, 2)), one
    round a call; over the ranks of a `mesh` as on one. Where
    `nbf_eager_reason` names a reason the builders run `nbf_snr_point`.
    Every route gives the same counters.

    adaptive_min_errors: after the base budget at an SNR point, keep adding
    rounds through the scan step, continuing the block ids, until EVERY
    detector has at least this many failed codewords (frame errors: coded
    bit errors cluster per failed codeword, so frame counts set the
    effective sample size), or, with adaptive_on_uncoded or an uncoded
    config, uncoded bit errors; or until adaptive_max_blocks (default 4 x
    blocks_per_snr) is reached. `checkpoint` (utils.checkpoint.SnrCheckpoint)
    saves each finished SNR point (rank 0 of a `mesh` alone) and skips the
    ones it holds."""
    dev = resolve_device(device)
    G = blocks_per_round * (1 if mesh is None else mesh.size)
    rounds = max(1, -(-blocks_per_snr // G))
    R = 1 if step_factory is not None else max(1, min(rounds_per_call,
                                                      rounds))
    calls = -(-rounds // R)
    root = rng.prng_key(cfg.seed if seed is None else seed)
    ebnos = np.asarray(cfg.ebno_db, dtype=np.float32)
    max_blocks = (4 * blocks_per_snr if adaptive_max_blocks is None
                  else adaptive_max_blocks)
    coded_unit = cfg.ldpc.enabled and not adaptive_on_uncoded
    retries = 0 if _distributed(mesh) else 2
    steps = {}

    def call(name, fn, args):
        if name not in steps:
            steps[name] = fn(cfg, device=dev, mesh=mesh)
        return _host_nbf(_call_with_retry(steps[name], args,
                                          progress=progress,
                                          retries=retries))

    grid_pts = None
    if checkpoint is None and step_factory is None:
        grid = make_fused_nbf_grid(cfg, G, calls * R, dev, mesh)
        grid_pts = _call_with_retry(grid, (root,), progress=progress,
                                    retries=retries)

    acc_per_snr = []
    for jj, ebno in enumerate(ebnos):
        if checkpoint is not None and checkpoint.has(jj):
            loaded = checkpoint.load_or_none(jj)
            if loaded is not None:
                acc_per_snr.append(loaded)
                continue

        def run_rounds(first_id, n_rounds):
            keys = _round_keys(root, jj, first_id, n_rounds, G)
            return call("scan", make_sharded_nbf_scan_step,
                        (float(ebno), keys))

        if grid_pts is not None:
            acc = grid_pts[jj]
        else:
            acc = None
            for c in range(calls):
                cnt = (call("factory", step_factory,
                            (float(ebno),
                             _round_keys(root, jj, c * G, 1, G)[0]))
                       if step_factory is not None
                       else run_rounds(c * R * G, R))
                acc = cnt if acc is None else _add_counts(acc, cnt)
        acc = _adaptive_topup(
            acc, run_rounds,
            lambda a: a.frame_errors if coded_unit else a.bit_errors,
            "failed codewords" if coded_unit else "bit errors", "mc", ebno,
            G, calls * R * G, calls * R * G, adaptive_min_errors, max_blocks,
            rounds_per_call, progress)
        acc_per_snr.append(acc)
        if checkpoint is not None and _writes(mesh):
            checkpoint.save(jj, acc)
        if progress is not None:
            ber = {k: v / max(acc.total_bits, 1)
                   for k, v in acc.bit_errors.items()}
            progress(f"[mc] EbNo={ebno:g} dB done: "
                     + " ".join(f"{k}={v:.4g}" for k, v in sorted(ber.items())))
    return assemble_curve(cfg, ebnos, acc_per_snr)


def run_cdl_curve(cfg: SimConfig, blocks_per_snr: int,
                  blocks_per_round: int = 2, seed: Optional[int] = None,
                  device=None,
                  progress: Optional[Callable[[str], None]] = print,
                  checkpoint=None, rounds_per_call: int = 4,
                  adaptive_min_errors: Optional[int] = None,
                  adaptive_max_blocks: Optional[int] = None,
                  adaptive_on_uncoded: bool = False,
                  timings: dict | None = None,
                  mesh: TrialsMesh | None = None) -> list:
    """SNR sweep of the calibrated CDL pipeline (JAX run_cdl_curve).

    blocks_per_snr is rounded up to whole rounds of `blocks_per_round`
    blocks a rank (one rank without a `mesh`; the JAX blocks_per_device)
    and split into calibration rounds (calib.cal_fraction of them)
    and decode rounds; a one-round budget cannot host both phases and is
    bumped to 1 + 1, loudly. Per SNR index jj the keys are block_keys(root,
    jj, ids) with the calibration ids first and the decode ids after.

    The route, as the JAX package picks it: without a checkpoint the whole
    grid in one call (`make_fused_cdl_grid`), with one the per-SNR step
    (`make_fused_cdl_snr_step`), the top-up through `dec_step`
    (`make_sharded_cdl_steps`), over the ranks of a `mesh` as on one;
    where `eager_reason` names a reason (a code without QC structure,
    debug_nan_checks) `cdl_snr_point` and `cdl_decode_rounds`, the decode
    rounds past ~6e8 bytes of round-stacked LLRs a detector in extra calls
    of `rounds_per_call` rounds. Both routes give the same results.

    adaptive_min_errors: after the base budget, keep running decode rounds
    at an SNR point until every detector has at least this many failed
    codewords (uncoded bit errors with adaptive_on_uncoded), or until
    adaptive_max_blocks decoded blocks (default 4 x blocks_per_snr). The
    waterfall, where the coded BER falls decades across one grid step, is
    where a fixed budget leaves run-to-run variance; an error-count rule
    spends blocks there and nowhere else.

    `timings`, when given, receives the ms of each phase summed over the
    sweep (cal, fit, detect, decode): wall ms on the eager route, the
    card's ms between CUDA events on the fused one (where a call captures
    its graphs, the captures fall in its cal phase). Returns one dict per
    SNR point: ebno_db, ber_uncoded, ber_coded, calib, ldpc_avg_iters,
    ldpc_unconverged_frac; rank 0 of a `mesh` alone saves checkpoints."""
    dev = resolve_device(device)
    G = blocks_per_round * (1 if mesh is None else mesh.size)
    retries = 0 if _distributed(mesh) else 2
    rounds = max(1, -(-blocks_per_snr // G))
    cal_rounds = min(max(1, round(rounds * cfg.calib.cal_fraction)),
                     max(rounds - 1, 1))
    dec_rounds = max(1, rounds - cal_rounds)
    if cal_rounds + dec_rounds != rounds and progress is not None:
        progress(f"[cdl] blocks_per_snr={blocks_per_snr} gives a single "
                 f"{G}-block round; the calibrated pipeline needs separate "
                 f"cal+decode rounds, so {cal_rounds + dec_rounds} rounds "
                 f"({(cal_rounds + dec_rounds) * G} blocks/SNR) will run")
    root = rng.prng_key(cfg.seed if seed is None else seed)
    fused = eager_reason(cfg, mesh) is None
    # eager: decode rounds whose stacked f32 LLRs (one BP call) stay under
    # ~6e8 bytes per detector; the rest run as extra calls of R rounds
    bpb = (cfg.data_symbols_per_block * cfg.channel.n_tx
           * cfg.ofdm.n_subcarriers * cfg.ofdm.bits_per_symbol)
    rd_first = dec_rounds if fused else min(
        dec_rounds, max(1, int(6e8 // (G * bpb * 4))))
    rd_extra = dec_rounds - rd_first
    R = max(1, min(rounds_per_call, rd_extra))
    max_dec_blocks = (4 * blocks_per_snr if adaptive_max_blocks is None
                      else adaptive_max_blocks)
    unit = "bit errors" if adaptive_on_uncoded else "failed codewords"

    grid_pts = None
    if fused:
        if checkpoint is None:
            grid = make_fused_cdl_grid(cfg, G, cal_rounds, rd_first, dev,
                                       mesh)
            grid_pts = _call_with_retry(grid, (root, timings),
                                        progress=progress, retries=retries)
        else:
            step = make_fused_cdl_snr_step(cfg, dev, mesh)
        _, dec_step = make_sharded_cdl_steps(cfg, dev, mesh)

    ebnos = np.asarray(cfg.ebno_db, dtype=np.float32)
    results = []
    for jj, ebno in enumerate(ebnos):
        if checkpoint is not None and checkpoint.has(jj):
            loaded = checkpoint.load_or_none(jj)
            if loaded is not None:
                results.append(loaded)
                continue
        first_dec = cal_rounds * G
        keys = (_round_keys(root, jj, 0, cal_rounds, G),
                _round_keys(root, jj, first_dec, rd_first, G))
        if grid_pts is not None:
            pt = grid_pts[jj]
        elif fused:
            pt = _host_point(_call_with_retry(
                step, (float(ebno), *keys, timings), progress=progress,
                retries=retries))
        else:
            pt = _call_with_retry(
                cdl_snr_point, (cfg, float(ebno), *keys, dev, timings, mesh),
                progress=progress, retries=retries)
        calib = pt.calib

        def run_rounds(first_id, n_rounds):
            keys = _round_keys(root, jj, first_id, n_rounds, G)
            if fused:
                return _host_counts(_call_with_retry(
                    dec_step, (float(ebno), keys, calib, timings),
                    progress=progress, retries=retries))
            return _call_with_retry(
                cdl_decode_rounds,
                (cfg, float(ebno), keys, calib, dev, timings, mesh),
                progress=progress, retries=retries)

        coded = pt.counts
        bid = first_dec + rd_first * G
        while bid < first_dec + dec_rounds * G:
            n_r = min(R, (first_dec + dec_rounds * G - bid) // G)
            coded = _add_counts(coded, run_rounds(bid, n_r))
            bid += n_r * G
        coded = _adaptive_topup(
            coded, run_rounds,
            lambda c: c.bit_errors if adaptive_on_uncoded else c.frame_errors,
            unit, "cdl", ebno, G, bid - first_dec, bid, adaptive_min_errors,
            max_dec_blocks, rounds_per_call, progress)

        tot_unc = pt.cal_total_bits + coded.total_bits
        ncw = max(coded.ldpc_codewords, 1)
        snr_res = {
            "ebno_db": float(ebno),
            "ber_uncoded": {
                d: (pt.cal_bit_errors[d] + coded.bit_errors[d]) / tot_unc
                for d in CDL_DETECTORS},
            "ber_coded": {
                d: coded.info_errors[d] / max(coded.total_info_bits, 1)
                for d in CDL_DETECTORS},
            "calib": {d: (a.cpu().numpy().tolist(), b.cpu().numpy().tolist())
                      for d, (a, b) in calib.items()},
            # BP convergence telemetry (the budget counted for unconverged)
            "ldpc_avg_iters": {d: v / ncw
                               for d, v in coded.ldpc_iter_sum.items()},
            "ldpc_unconverged_frac": {
                d: v / ncw for d, v in coded.ldpc_unconverged.items()},
        }
        results.append(snr_res)
        if checkpoint is not None and _writes(mesh):
            checkpoint.save(jj, snr_res)
        if progress is not None:
            progress(f"[cdl] EbNo={ebno:g} dB: "
                     f"uncoded {snr_res['ber_uncoded']}, "
                     f"coded {snr_res['ber_coded']}")
    return results


def assemble_curve(cfg: SimConfig, ebnos, acc_per_snr) -> CurveResult:
    """Per-SNR host counters -> BER curves and channel analytics."""
    det = sorted(acc_per_snr[0].bit_errors)
    n = len(ebnos)
    ber = {d: np.zeros(n) for d in det}
    berc = {d: np.zeros(n) for d in det}
    avg_it = {d: np.zeros(n) for d in det}
    unconv = {d: np.zeros(n) for d in det}
    cap, frk, tot, toti, nblk = (np.zeros(n) for _ in range(5))
    chist = np.zeros((n, len(acc_per_snr[0].cond_hist)))
    for jj, acc in enumerate(acc_per_snr):
        tot[jj], toti[jj] = acc.total_bits, acc.total_info_bits
        nblk[jj] = acc.n_blocks
        ncw = max(acc.ldpc_codewords, 1)
        for d in det:
            ber[d][jj] = acc.bit_errors[d] / max(acc.total_bits, 1)
            berc[d][jj] = acc.info_errors[d] / max(acc.total_info_bits, 1)
            avg_it[d][jj] = acc.ldpc_iter_sum[d] / ncw
            unconv[d][jj] = acc.ldpc_unconverged[d] / ncw
        cap[jj] = acc.capacity_sum / max(acc.n_blocks, 1)
        frk[jj] = acc.rank_full_sum / max(acc.rank_count, 1)
        chist[jj] = acc.cond_hist
    return CurveResult(ebno_db=np.asarray(ebnos), ber=ber, ber_coded=berc,
                       capacity_per_sc=cap, frac_rank_full=frk,
                       cond_hist=chist, total_bits=tot, total_info_bits=toti,
                       n_blocks=nblk, ldpc_avg_iters=avg_it,
                       ldpc_unconverged_frac=unconv)
