"""The port's fused CDL route (parallel/montecarlo.py: make_sharded_cdl_steps,
make_fused_cdl_snr_step, make_fused_cdl_grid; the bodies of
pipelines/cdl.py:CdlRounds) on the CPU, where the bodies run eagerly with
the kernels' plain versions (on the card they are CUDA graphs: chip_smoke.py
`[cdl snr step]`, `[cdl grid]`).

On tests/test_torch_curve.py's tiny calibrated config (JAX on a one-device
mesh), two SNR points of 1 calibration + 2 decode rounds of 4 blocks:

  * the fused step and grid against the JAX ones: every uncoded, coded and
    BP-telemetry counter equal, calibrators within 1e-4 (the band of
    test_cdl_curve_equals_jax: float32 GD in two libraries);
  * the grid against the port's per-SNR step and its eager `cdl_snr_point`
    loop, bit for bit, counters and calibrators;
  * `dec_step` round by round against the eager stacked decode
    (`cdl_decode_rounds`: one BP call on the round-stacked LLRs), bit for
    bit;
  * `run_cdl_curve` takes the grid without a checkpoint and the step with
    one, and equals its eager route (forced by debug_nan_checks);
  * a stand-in for capture safety: the step's bodies run under a dispatch
    mode that raises on the ops that sync the host (_local_scalar_dense,
    nonzero), the plain stand-ins of K1, K2 and K3 exempted by name.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import TorchDispatchMode

import esn_ofdm_mimo_tpu  # noqa: F401
from esn_ofdm_mimo_tpu.parallel import montecarlo as jmc
from esn_ofdm_mimo_tpu.utils.rng import block_keys as jax_block_keys
from esn_ofdm_mimo_tpu_torch.ldpc import decode_cuda
from esn_ofdm_mimo_tpu_torch.models import esn_mimo, esn_states_cuda
from esn_ofdm_mimo_tpu_torch.parallel import montecarlo as tmc
from esn_ofdm_mimo_tpu_torch.parallel.mesh import TrialsMesh
from esn_ofdm_mimo_tpu_torch.pipelines import cdl, graphs
from esn_ofdm_mimo_tpu_torch.utils import rng
from esn_ofdm_mimo_tpu_torch.utils.checkpoint import SnrCheckpoint
from esn_ofdm_mimo_tpu_torch.utils.metrics import debug_nan_checks
from test_torch_curve import _cdl_cfg, _jax_cdl_cfg, _same_cdl_results

torch.set_num_threads(1)

G, RC, RD = 4, 1, 2
COUNTERS = ("bit_errors", "info_errors", "frame_errors", "ldpc_iter_sum",
            "ldpc_unconverged")


def _keys(jj):
    """Point jj's (cal keys (RC, G, 2), dec keys (RD, G, 2)): the grid's
    stream, block_keys(PRNGKey(seed), jj, ids) with the cal ids first."""
    k = rng.block_keys(rng.prng_key(_cdl_cfg().seed), jj,
                       torch.arange((RC + RD) * G)).reshape(RC + RD, G, 2)
    return k[:RC], k[RC:]


def _ints(pt):
    """A point's counters as one flat tuple of ints."""
    c = pt.counts
    return (tuple(int(pt.cal_bit_errors[d]) for d in cdl.CDL_DETECTORS)
            + (int(pt.cal_total_bits), int(c.total_bits),
               int(c.total_info_bits), int(c.ldpc_codewords))
            + tuple(int(getattr(c, f)[d]) for f in COUNTERS
                    for d in cdl.CDL_DETECTORS))


def _calib(pt):
    return {d: [np.asarray(x, dtype=np.float32) for x in ab]
            for d, ab in pt.calib.items()}


def _same_calib(a, b, atol=0.0):
    for d in b:
        for x, y in zip(a[d], b[d]):
            if atol:
                np.testing.assert_allclose(x, y, rtol=0, atol=atol)
            else:
                assert np.array_equal(x, y), d


@pytest.fixture(scope="module")
def points():
    """The port's grid, its step and eager points a SNR, and the JAX
    grid's points, on both SNR points of the config."""
    cfg = _cdl_cfg()
    grid = tmc.make_fused_cdl_grid(cfg, G, RC, RD, device="cpu")(
        rng.prng_key(cfg.seed))
    step = tmc.make_fused_cdl_snr_step(cfg, device="cpu")
    steps = [step(float(e), *_keys(j)) for j, e in enumerate(cfg.ebno_db)]
    eager = [tmc.cdl_snr_point(cfg, float(e), *_keys(j), device="cpu")
             for j, e in enumerate(cfg.ebno_db)]
    mesh = Mesh(np.array(jax.devices()[:1]), ("trials",))
    jgrid = jax.device_get(jmc.make_fused_cdl_grid(
        _jax_cdl_cfg(), mesh, G, RC, RD)(jax.random.PRNGKey(cfg.seed)))
    jax_pts = [tmc.CdlSnrPoint(*jax.tree.map(lambda x: x[j], jgrid))
               for j in range(len(cfg.ebno_db))]
    return grid, steps, eager, jax_pts


def test_grid_equals_jax_grid(points):
    grid, _, _, jax_pts = points
    for got, want in zip(grid, jax_pts):
        assert _ints(got) == _ints(want)
        _same_calib(_calib(got), _calib(want), atol=1e-4)


def test_step_equals_jax_step():
    cfg, jcfg = _cdl_cfg(), _jax_cdl_cfg()
    mesh = Mesh(np.array(jax.devices()[:1]), ("trials",))
    keys = jax_block_keys(jax.random.PRNGKey(jcfg.seed), 1, jnp.arange(
        (RC + RD) * G, dtype=jnp.uint32)).reshape(RC + RD, G, 2)
    want = tmc.CdlSnrPoint(*jax.device_get(jmc.make_fused_cdl_snr_step(
        jcfg, mesh)(jnp.float32(24.0), keys[:RC], keys[RC:])))
    got = tmc.make_fused_cdl_snr_step(cfg, device="cpu")(24.0, *_keys(1))
    # no host read inside the step: its counters are tensors until read
    assert all(isinstance(v, torch.Tensor) for v in got.counts.info_errors
               .values())
    assert _ints(got) == _ints(want)
    _same_calib(_calib(got), _calib(want), atol=1e-4)


def test_grid_equals_step_and_eager_points(points):
    grid, steps, eager, _ = points
    for g, s, e in zip(grid, steps, eager):
        assert _ints(g) == _ints(s) == _ints(e)
        _same_calib(_calib(g), _calib(s))
        _same_calib(_calib(g), _calib(e))
    assert 0 < grid[1].cal_bit_errors["mmse"] < grid[0].cal_bit_errors["mmse"]


def test_dec_step_by_round_equals_stacked_decode(points):
    """Three decode rounds: dec_step on all three, and one round a call
    summed, equal the eager stacked decode (one BP call on the three
    rounds' LLRs), bit for bit."""
    cfg = _cdl_cfg()
    calib = points[0][0].calib
    keys = tmc._round_keys(rng.prng_key(cfg.seed), 0, RC * G, 3, G)
    want = tmc.cdl_decode_rounds(cfg, 12.0, keys, calib, device="cpu")
    _, dec_step = tmc.make_sharded_cdl_steps(cfg, device="cpu")
    got = tmc._host_counts(dec_step(12.0, keys, calib))
    assert got == want
    by_round = [tmc._host_counts(dec_step(12.0, keys[r:r + 1], calib))
                for r in range(3)]
    total = by_round[0]
    for c in by_round[1:]:
        total = tmc._add_counts(total, c)
    assert total == want


def test_cal_step_equals_run_cdl_cal_blocks():
    cfg = _cdl_cfg()
    keys = _keys(0)[0][0]
    cal_step, _ = tmc.make_sharded_cdl_steps(cfg, device="cpu")
    got = cal_step(12.0, keys)
    want = cdl.run_cdl_cal_blocks(cfg, 12.0, keys)
    assert got.total_bits == want.total_bits
    assert {d: int(v) for d, v in got.bit_errors.items()} == {
        d: int(v) for d, v in want.bit_errors.items()}
    assert torch.equal(got.bits, want.bits)
    for d in cdl.CDL_DETECTORS:
        assert torch.equal(got.llr[d], want.llr[d])


def test_curve_routes(monkeypatch, tmp_path):
    """Without a checkpoint the grid runs, with one the per-SNR step; both
    equal the eager route on the same keys (debug_nan_checks selects it),
    and the eager route runs neither."""
    cfg = dataclasses.replace(_cdl_cfg(), ebno_db=(12.0,))
    calls = []
    for name in ("make_fused_cdl_grid", "make_fused_cdl_snr_step",
                 "cdl_snr_point"):
        orig = getattr(tmc, name)
        monkeypatch.setattr(tmc, name, lambda *a, _n=name, _o=orig, **k:
                            calls.append(_n) or _o(*a, **k))
    kw = dict(blocks_per_round=2, device="cpu", progress=None)
    grid = tmc.run_cdl_curve(cfg, 4, **kw)
    assert calls == ["make_fused_cdl_grid"]
    step = tmc.run_cdl_curve(cfg, 4, checkpoint=SnrCheckpoint(str(tmp_path)),
                             **kw)
    assert calls[1:] == ["make_fused_cdl_snr_step"]
    with debug_nan_checks():
        eager = tmc.run_cdl_curve(cfg, 4, **kw)
    assert calls[2:] == ["cdl_snr_point"]
    _same_cdl_results(grid, eager)
    _same_cdl_results(step, eager)


def test_eager_reason():
    cfg = _cdl_cfg()
    assert tmc.eager_reason(cfg) is None
    assert tmc.eager_reason(cfg, TrialsMesh(1, 0, None)) is None
    assert "ranks" in tmc.eager_reason(cfg, TrialsMesh(2, 0, None))
    gal = dataclasses.replace(cfg, ldpc=dataclasses.replace(
        cfg.ldpc, family="gallager"))
    assert "QC" in tmc.eager_reason(gal)
    with debug_nan_checks():
        assert tmc.eager_reason(cfg) == "debug_nan_checks"
    assert tmc.eager_reason(cfg) is None


def test_timings_sum_each_phase():
    cfg = _cdl_cfg()
    ph = {}
    tmc.make_fused_cdl_snr_step(cfg, device="cpu")(12.0, *_keys(0),
                                                   timings=ph)
    assert set(ph) == {"cal", "fit", "detect", "decode"}
    assert all(v > 0 for v in ph.values())


def test_graph_cache_releases_the_least_recent(monkeypatch):
    released = []

    class Set:
        def __init__(self, i):
            self.i = i

        def release(self):
            released.append(self.i)

    monkeypatch.setattr(graphs, "_CACHE", type(graphs._CACHE)())
    cpu = torch.device("cpu")
    keys = [cdl.graph_key(_cdl_cfg(), g, cpu, "cdl") for g in range(6)]
    for i, k in enumerate(keys[:4]):
        assert cdl.cached_graphs(k, lambda i=i: Set(i)).i == i
    assert cdl.cached_graphs(keys[0], lambda: Set(-1)).i == 0  # a hit
    cdl.cached_graphs(keys[4], lambda: Set(4))
    assert released == [1]              # 0 was used last, 1 is the oldest
    cdl.release_graphs()
    assert sorted(released) == [0, 1, 2, 3, 4] and not graphs._CACHE


class _NoHostSync(TorchDispatchMode):
    """Raises on the ops that read a value on the host (a sync on the card,
    which a CUDA graph capture cannot hold), outside exempted calls."""
    SYNCS = (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero)

    def __init__(self):
        super().__init__()
        self.exempt = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.exempt and func.overloadpacket in self.SYNCS:
            raise AssertionError(f"{func} reads a value on the host")
        return func(*args, **(kwargs or {}))


def test_bodies_never_read_a_value_on_the_host(monkeypatch):
    """The cal, fit, detect and decode bodies (one step) run under
    _NoHostSync. The plain stand-ins of K1, K2 and K3 read their seed and
    compact converged codewords on the host by nature: their wrappers are
    exempted by name, and each must have run."""
    cfg = _cdl_cfg()
    mode, ran = _NoHostSync(), []

    def exempt(mod, name):
        fn = getattr(mod, name)

        def run(*a, **k):
            ran.append(name)
            mode.exempt += 1
            try:
                return fn(*a, **k)
            finally:
                mode.exempt -= 1
        monkeypatch.setattr(mod, name, run)

    exempt(decode_cuda, "ldpc_decode_bp_cuda_counts")     # K1
    exempt(esn_mimo, "esn_predict_cuda")                  # K2
    exempt(esn_states_cuda, "esn_states_cuda")            # K3
    step = tmc.make_fused_cdl_snr_step(cfg, device="cpu")
    ck, dk = _keys(0)
    with mode:
        pt = step(12.0, ck, dk)
    assert set(ran) == {"ldpc_decode_bp_cuda_counts", "esn_predict_cuda",
                        "esn_states_cuda"}
    # what the mode watched is the step's own run, as read afterwards
    assert _ints(pt) == _ints(tmc.cdl_snr_point(cfg, 12.0, ck, dk,
                                                device="cpu"))
    with mode, pytest.raises(AssertionError, match="host"):
        int(torch.ones(()))
