"""The fused CDL and NBF builders over several `torch.distributed` ranks
(parallel/montecarlo.py with a `mesh`: each rank runs its bodies on its
share of every round, the calibration pairs gathered and the counters
summed by parallel/mesh.py:all_gather_into and all_sum_), on the CPU with
gloo ranks on localhost (each a process of its own, a free port and a
timeout each; tests/test_torch_distributed.py's harness and tiny configs).

Over 2 ranks (rounds of 4 global blocks, 2 a rank): make_fused_cdl_snr_step
and make_fused_cdl_grid (2 calibration rounds + 1 decode round, both SNR
points, max_fit_samples below the global pair count, so the fit's stride
is the global one and picks its samples in global block order), dec_step
and cal_step of make_sharded_cdl_steps, make_sharded_nbf_scan_step and
make_fused_nbf_grid (2 rounds, both SNR points):

  * in rng_mode "block" they equal one process's fused builders on the same
    global blocks bit for bit, counters and calibrators;
  * in rng_mode "batch" they equal the eager route over the same 2 ranks
    (cdl_snr_point, cdl_decode_rounds, nbf_snr_point with the mesh) bit for
    bit, and the JAX package's builders on Mesh(jax.devices()[:2],
    ("trials",)) at tests/test_torch_distributed.py's bands (CDL: every
    counter equal, calibrators within 1e-4; NBF: classical uncoded errors,
    the condition histogram and the totals equal, ESN uncoded errors within
    1% + 10, info-bit errors within two codewords' info bits, capacity
    within rtol 1e-5);
  * `eager_reason` and `nbf_eager_reason` over the 2 ranks are None, and
    run_cdl_curve over them takes the grid and never `cdl_snr_point`.

Over 4 ranks (1 block a rank): make_fused_nbf_grid equals one process's
grid in "block" and the eager route over the 4 ranks in "batch", bit for
bit.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import esn_ofdm_mimo_tpu  # noqa: F401
from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.parallel import montecarlo as jmc
from esn_ofdm_mimo_tpu.utils.rng import block_keys as j_block_keys
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.ldpc import make_code
from esn_ofdm_mimo_tpu_torch.parallel import montecarlo as tmc
from esn_ofdm_mimo_tpu_torch.utils import rng
from test_torch_distributed import (ROOT, _convert, _free_port, _jax_cdl_cfg,
                                    _nbf_cfg)
from test_torch_fused_cdl import _calib, _ints, _same_calib

torch.set_num_threads(1)

G, RC, RD, RN = 4, 2, 1, 2      # global blocks a round; CDL and NBF rounds


def _cdl_cfg(mode):
    """test_torch_distributed.py's tiny calibrated config, with a fit cap
    under the global pair count of a point (G RC D n_tx N a bit position):
    the global stride is 3, a rank's count would give 2, and with RC = 2
    rounds another order of the pairs picks other samples; the curve's
    split of its rounds is the grids' RC + RD."""
    cfg = _jax_cdl_cfg(mode)
    pairs = G * RC * cfg.data_symbols_per_block * cfg.channel.n_tx \
        * cfg.ofdm.n_subcarriers
    return dataclasses.replace(cfg, calib=dataclasses.replace(
        cfg.calib, max_fit_samples=pairs // 3 + 1,
        cal_fraction=RC / (RC + RD)))


# One rank: runs the builders of `what` ("two": CDL and NBF, "four": the
# NBF grid) over the default group in both modes, pickles its results to
# <out>/rank<r>.pkl.
_WORKER = textwrap.dedent("""
    import os, pickle, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from esn_ofdm_mimo_tpu_torch.parallel import (maybe_init_distributed,
                                                  trials_mesh)
    from esn_ofdm_mimo_tpu_torch.parallel import montecarlo as tmc
    out, what = sys.argv[1], sys.argv[2]
    with open(os.path.join(out, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    G, RC, RD, RN = inp["shape"]
    assert maybe_init_distributed("cpu")
    mesh = trials_mesh()
    res = {}
    for mode in ("block", "batch"):
        nbf = inp["nbf", mode]
        res["nbf grid", mode] = tmc.make_fused_nbf_grid(
            nbf, G, RN, "cpu", mesh)(inp["root"])
        if mode == "batch":
            res["nbf eager", mode] = [
                tmc.nbf_snr_point(nbf, e, k, "cpu", mesh=mesh)
                for e, k in zip(nbf.ebno_db, inp["nbf keys"])]
        if what == "four":
            continue
        scan = tmc.make_sharded_nbf_scan_step(nbf, "cpu", mesh)
        res["nbf scan", mode] = [tmc._host_nbf(scan(e, k)) for e, k in
                                 zip(nbf.ebno_db, inp["nbf keys"])]
        cfg, keys = inp["cdl", mode], inp["cdl keys"]
        step = tmc.make_fused_cdl_snr_step(cfg, "cpu", mesh)
        res["cdl step", mode] = [
            tmc._host_point(step(e, k[:RC], k[RC:]))
            for e, k in zip(cfg.ebno_db, keys)]
        res["cdl grid", mode] = tmc.make_fused_cdl_grid(
            cfg, G, RC, RD, "cpu", mesh)(inp["root"])
        calib = res["cdl grid", mode][0].calib
        cal_step, dec_step = tmc.make_sharded_cdl_steps(cfg, "cpu", mesh)
        res["cdl dec", mode] = tmc._host_counts(
            dec_step(12.0, keys[0][RC:], calib))
        cal = cal_step(12.0, keys[0][0])
        res["cdl cal", mode] = (
            {d: int(v) for d, v in cal.bit_errors.items()}, cal.total_bits,
            tuple(cal.bits.shape))
        if mode == "batch":
            res["cdl eager", mode] = [
                tmc.cdl_snr_point(cfg, e, k[:RC], k[RC:], "cpu", mesh=mesh)
                for e, k in zip(cfg.ebno_db, keys)]
            res["cdl dec eager", mode] = tmc.cdl_decode_rounds(
                cfg, 12.0, keys[0][RC:], calib, "cpu", mesh=mesh)
            res["reasons"] = (tmc.eager_reason(cfg, mesh),
                              tmc.nbf_eager_reason(nbf, mesh))
            calls = []
            for name in ("make_fused_cdl_grid", "cdl_snr_point"):
                setattr(tmc, name, lambda *a, _o=getattr(tmc, name), _n=name,
                        **k: calls.append(_n) or _o(*a, **k))
            res["curve", mode] = tmc.run_cdl_curve(
                cfg, G * (RC + RD), blocks_per_round=G // mesh.size,
                seed=0, device="cpu", progress=None, mesh=mesh)
            res["curve calls"] = calls
    with open(os.path.join(out, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
""")


def _keys(cfg, rounds):
    """Each SNR point's keys (rounds, G, 2), block_keys(root, snr index,
    0 .. rounds G - 1): the grids' stream."""
    root = rng.prng_key(0)
    return [rng.block_keys(root, jj, torch.arange(rounds * G)).reshape(
        rounds, G, 2) for jj in range(len(cfg.ebno_db))]


def _start(world: int, what: str, out):
    """Start `world` gloo ranks of the worker on `what`."""
    cdl = {m: _convert(_cdl_cfg(m), tc) for m in ("block", "batch")}
    nbf = {m: _nbf_cfg(m) for m in ("block", "batch")}
    with open(os.path.join(out, "inputs.pkl"), "wb") as f:
        pickle.dump({**{("cdl", m): c for m, c in cdl.items()},
                     **{("nbf", m): c for m, c in nbf.items()},
                     "cdl keys": _keys(cdl["block"], RC + RD),
                     "nbf keys": _keys(nbf["block"], RN),
                     "root": rng.prng_key(0), "shape": (G, RC, RD, RN)},
                    f)
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(out), what], cwd=ROOT,
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _collect(procs, out, timeout: float) -> list:
    """Wait for the ranks (a timeout each); their result dicts."""
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, e in zip(procs, errs):
        assert p.returncode == 0, e[-3000:]
    res = []
    for r in range(len(procs)):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 2 ranks' results, the 4 ranks', one process's block-mode
    results, the JAX builders' batch-mode results): both layouts launched
    together, the references computed while they run."""
    out2, out4 = (tmp_path_factory.mktemp(w) for w in ("two", "four"))
    procs = (_start(2, "two", out2), _start(4, "four", out4))
    cfg, nbf = _convert(_cdl_cfg("block"), tc), _nbf_cfg("block")
    ck, nk = _keys(cfg, RC + RD), _keys(nbf, RN)
    step = tmc.make_fused_cdl_snr_step(cfg, "cpu")
    scan = tmc.make_sharded_nbf_scan_step(nbf, "cpu")
    one = {
        "cdl step": [tmc._host_point(step(e, k[:RC], k[RC:]))
                     for e, k in zip(cfg.ebno_db, ck)],
        "cdl grid": tmc.make_fused_cdl_grid(cfg, G, RC, RD, "cpu")(
            rng.prng_key(0)),
        "nbf scan": [tmc._host_nbf(scan(e, k))
                     for e, k in zip(nbf.ebno_db, nk)],
        "nbf grid": tmc.make_fused_nbf_grid(nbf, G, RN, "cpu")(
            rng.prng_key(0))}
    _, dec_step = tmc.make_sharded_cdl_steps(cfg, "cpu")
    one["cdl dec"] = tmc._host_counts(dec_step(
        12.0, ck[0][RC:], one["cdl grid"][0].calib))
    jax_refs = _jax_refs()
    return (_collect(procs[0], out2, 300), _collect(procs[1], out4, 300),
            one, jax_refs)


def _same_points(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _ints(a) == _ints(b)
        _same_calib(_calib(a), _calib(b))


def _same_nbf(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert np.array_equal(x, y) if isinstance(x, np.ndarray) \
                else x == y, (f, x, y)


def test_block_mode_over_ranks_equals_one_process(runs):
    two, four, one, _ = runs
    for res in two:
        _same_points(res["cdl step", "block"], one["cdl step"])
        _same_points(res["cdl grid", "block"], one["cdl grid"])
        assert res["cdl dec", "block"] == one["cdl dec"]
        _same_nbf(res["nbf scan", "block"], one["nbf scan"])
        _same_nbf(res["nbf grid", "block"], one["nbf grid"])
        # cal_step: this rank's pairs, the counters over both ranks
        errs, total, shape = res["cdl cal", "block"]
        assert RC * total == one["cdl step"][0].cal_total_bits
        assert shape[0] == G // 2
    for res in four:
        _same_nbf(res["nbf grid", "block"], one["nbf grid"])
    assert two[0]["cdl cal", "block"][0] == two[1]["cdl cal", "block"][0]
    assert one["nbf grid"][0].n_blocks == RN * G


def test_batch_mode_over_ranks_equals_eager_route(runs):
    two, four, _, _ = runs
    for res in two:
        _same_points(res["cdl step", "batch"], res["cdl eager", "batch"])
        _same_points(res["cdl grid", "batch"], res["cdl eager", "batch"])
        assert res["cdl dec", "batch"] == res["cdl dec eager", "batch"]
        _same_nbf(res["nbf scan", "batch"], res["nbf eager", "batch"])
        _same_nbf(res["nbf grid", "batch"], res["nbf eager", "batch"])
    for res in four:
        _same_nbf(res["nbf grid", "batch"], res["nbf eager", "batch"])
    # every rank returns the same points
    _same_points(two[1]["cdl grid", "batch"], two[0]["cdl grid", "batch"])
    _same_nbf(four[3]["nbf grid", "batch"], four[0]["nbf grid", "batch"])


def test_routes_over_two_ranks(runs):
    for res in runs[0]:
        assert res["reasons"] == (None, None)
        assert res["curve calls"] == ["make_fused_cdl_grid"]
        grid = res["cdl grid", "batch"]
        for got, pt in zip(res["curve", "batch"], grid):
            c = pt.counts
            assert got["ber_coded"] == {
                d: c.info_errors[d] / c.total_info_bits for d in c.info_errors}
            assert got["ber_uncoded"] == {
                d: (pt.cal_bit_errors[d] + c.bit_errors[d])
                / (pt.cal_total_bits + c.total_bits) for d in c.bit_errors}


def _jax_refs() -> dict:
    """The JAX package's builders on a 2-device mesh in "batch" mode, both
    SNR points of each config, on the grids' stream."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("trials",))
    jcfg, root = _cdl_cfg("batch"), jax.random.PRNGKey(0)
    jgrid = jax.device_get(jmc.make_fused_cdl_grid(
        jcfg, mesh, G // 2, RC, RD)(root))
    jstep = jmc.make_fused_cdl_snr_step(jcfg, mesh)
    out = {"cdl grid": [tmc.CdlSnrPoint(*jax.tree.map(lambda x: x[j], jgrid))
                        for j in range(len(jcfg.ebno_db))],
           "cdl step": []}
    ids = jnp.arange((RC + RD) * G, dtype=jnp.uint32)
    for jj, e in enumerate(jcfg.ebno_db):
        keys = j_block_keys(root, jj, ids).reshape(RC + RD, G, 2)
        out["cdl step"].append(tmc.CdlSnrPoint(*jax.device_get(jstep(
            jnp.float32(e), keys[:RC], keys[RC:]))))
    jnbf = _convert(_nbf_cfg("batch"), jc)
    jscan = jmc.make_sharded_nbf_scan_step(jnbf, mesh)
    ngrid = jax.device_get(jmc.make_fused_nbf_grid(jnbf, mesh, G // 2, RN)(
        root))
    out["nbf grid"] = [jax.tree.map(lambda x: x[j], ngrid)
                       for j in range(len(jnbf.ebno_db))]
    ids = jnp.arange(RN * G, dtype=jnp.uint32)
    out["nbf scan"] = [jax.device_get(jscan(jnp.float32(e), j_block_keys(
        root, jj, ids).reshape(RN, G, 2))) for jj, e in enumerate(
            jnbf.ebno_db)]
    return out


def test_batch_mode_over_two_ranks_equals_jax_builders(runs):
    two, want = runs[0], runs[3]
    for res in two:
        for b in ("cdl step", "cdl grid"):
            for got, w in zip(res[b, "batch"], want[b], strict=True):
                assert _ints(got) == _ints(w)
                _same_calib(_calib(got), _calib(w), atol=1e-4)
    nbf = _nbf_cfg("batch")
    k_info = make_code(nbf.ldpc, nbf.ofdm.n_subcarriers
                       * nbf.ofdm.bits_per_symbol).k
    for res in two:
        for b in ("nbf scan", "nbf grid"):
            for got, w in zip(res[b, "batch"], want[b], strict=True):
                for d, x in w.bit_errors.items():
                    band = 0.01 * int(x) + 10 if d.startswith("esn") else 0
                    assert abs(got.bit_errors[d] - int(x)) <= band, (b, d)
                    assert abs(got.info_errors[d] - int(w.info_errors[d])
                               ) <= 2 * k_info, (b, d)
                for f in ("total_bits", "total_info_bits", "rank_full_sum",
                          "rank_count", "n_blocks", "ldpc_codewords"):
                    assert getattr(got, f) == int(getattr(w, f)), (b, f)
                np.testing.assert_array_equal(got.cond_hist,
                                              np.asarray(w.cond_hist))
                np.testing.assert_allclose(got.capacity_sum,
                                           float(w.capacity_sum), rtol=1e-5)
