"""The port's fused block-fading route (parallel/montecarlo.py:
make_sharded_nbf_step, make_sharded_nbf_scan_step, make_fused_nbf_grid; the
round body of pipelines/blockfading.py:NbfRounds) on the CPU, where the
body runs eagerly with the kernels' plain versions (on the card it is a
CUDA graph a BP cap: chip_smoke.py `[nbf step]`, `[nbf grid]`).

On test_torch_nbf.py's tiny 2x2 QC config, rounds of 4 blocks at 12 dB
and at 3 dB (the doubled BP cap):

  * the fused step against the JAX make_sharded_nbf_step on a one-device
    mesh at the same keys, within test_torch_nbf.py's stated bands
    (classical uncoded errors, frame errors, BP iterations, unconverged
    codewords, ranks and the condition histogram identical; ESN uncoded
    errors within 1% + 10, info-bit errors within 1% + 3, capacity within
    rtol 1e-5);
  * the scan step against the sum of single steps, and the grid against
    the per-SNR scan step loop and the eager `nbf_snr_point`, bit for bit
    (capacity_sum included: the same analytics);
  * `run_nbf_curve`'s grid, checkpoint and step_factory routes and its
    eager route (debug_nan_checks) give the same CurveResult; a flaky
    step_factory is retried (tests/test_fault_tolerance.py's
    test_round_retry_recovers);
  * run_nbf_blocks on an EbnoRow equals the float path bit for bit;
  * the round body runs under a dispatch mode that raises on the ops that
    sync the host (_local_scalar_dense, nonzero), the plain stand-ins of
    K1, K2 and K3 exempted by name.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.parallel import montecarlo as jmc
from esn_ofdm_mimo_tpu.parallel import trials_mesh
from esn_ofdm_mimo_tpu.utils.rng import block_keys as j_block_keys
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.ldpc import decode_cuda
from esn_ofdm_mimo_tpu_torch.models import esn_mimo, esn_states_cuda
from esn_ofdm_mimo_tpu_torch.parallel import montecarlo as tmc
from esn_ofdm_mimo_tpu_torch.parallel.mesh import TrialsMesh
from esn_ofdm_mimo_tpu_torch.pipelines import blockfading as tbf
from esn_ofdm_mimo_tpu_torch.pipelines.common import ebno_row
from esn_ofdm_mimo_tpu_torch.utils import rng
from esn_ofdm_mimo_tpu_torch.utils.checkpoint import SnrCheckpoint
from esn_ofdm_mimo_tpu_torch.utils.metrics import debug_nan_checks
from test_torch_fused_cdl import _NoHostSync
from test_torch_nbf import _tiny

torch.set_num_threads(1)

G = 4
SNRS = [(12.0, 1), (3.0, 0)]           # (Eb/N0, index in the tiny grid)
_JAX = {}


def _keys(jj, first=0, rounds=1):
    """Rounds (rounds, G, 2) of SNR index jj from block id `first`: the
    curve's and the grid's stream."""
    ids = torch.arange(first, first + rounds * G)
    return rng.block_keys(rng.prng_key(0), jj, ids).reshape(rounds, G, 2)


def _same(a, b):
    """Two host NbfCounts, every field equal (the histogram elementwise)."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f
        else:
            assert x == y, (f, x, y)


def _jax_step(ebno, jj):
    if "step" not in _JAX:
        _JAX["step"] = jmc.make_sharded_nbf_step(_tiny(jc), trials_mesh(1))
    keys = j_block_keys(jax.random.PRNGKey(0), jj,
                        jnp.arange(G, dtype=jnp.uint32))
    return np.asarray(keys), jax.device_get(
        _JAX["step"](jnp.float32(ebno), keys))


@pytest.mark.parametrize("ebno,jj", SNRS, ids=["12dB", "3dB-doubled-cap"])
def test_step_equals_jax_step(ebno, jj):
    keys, want = _jax_step(ebno, jj)
    step = tmc.make_sharded_nbf_step(_tiny(tc), device="cpu")
    got = step(ebno, keys)
    # no host read inside the step: its counters are tensors until read
    assert all(isinstance(v, torch.Tensor) for v in got.frame_errors.values())
    got = tmc._host_nbf(got)
    for field in ("frame_errors", "ldpc_iter_sum", "ldpc_unconverged"):
        assert getattr(got, field) == {
            d: int(v) for d, v in getattr(want, field).items()}, field
    for d, w in want.bit_errors.items():
        band = 0.01 * int(w) + 10 if d.startswith("esn") else 0
        assert abs(got.bit_errors[d] - int(w)) <= band, d
        wi = int(want.info_errors[d])
        assert abs(got.info_errors[d] - wi) <= 0.01 * wi + 3, d
    for field in ("total_bits", "total_info_bits", "rank_full_sum",
                  "rank_count", "n_blocks", "ldpc_codewords"):
        assert getattr(got, field) == int(getattr(want, field)), field
    np.testing.assert_array_equal(got.cond_hist, np.asarray(want.cond_hist))
    np.testing.assert_allclose(got.capacity_sum, float(want.capacity_sum),
                               rtol=1e-5)


def test_scan_step_equals_the_sum_of_single_steps():
    cfg = _tiny(tc)
    keys = _keys(0, rounds=2)
    scan = tmc.make_sharded_nbf_scan_step(cfg, device="cpu")
    step = tmc.make_sharded_nbf_step(cfg, device="cpu")
    got = tmc._host_nbf(scan(3.0, keys))
    want = tmc._add_counts(tmc._host_nbf(step(3.0, keys[0])),
                           tmc._host_nbf(step(3.0, keys[1])))
    _same(got, want)
    assert got.n_blocks == 2 * G


@pytest.fixture(scope="module")
def grid_points():
    cfg = _tiny(tc)
    grid = tmc.make_fused_nbf_grid(cfg, G, 2, device="cpu")(rng.prng_key(0))
    scan = tmc.make_sharded_nbf_scan_step(cfg, device="cpu")
    steps = [tmc._host_nbf(scan(e, _keys(j, rounds=2)))
             for j, e in enumerate(cfg.ebno_db)]
    eager = [tmc.nbf_snr_point(cfg, e, _keys(j, rounds=2), device="cpu")
             for j, e in enumerate(cfg.ebno_db)]
    return grid, steps, eager


def test_grid_equals_the_step_loop_and_the_eager_points(grid_points):
    grid, steps, eager = grid_points
    for g, s, e in zip(grid, steps, eager):
        _same(g, s)
        _same(g, e)
        assert isinstance(g.capacity_sum, float)
    # the doubled cap at 3 dB: unconverged codewords ran 2 * max_iter
    for d, n in grid[0].ldpc_unconverged.items():
        assert grid[0].ldpc_iter_sum[d] >= 40 * n
    assert grid[1].bit_errors["mmse"] < grid[0].bit_errors["mmse"]


def _same_curve(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            assert sorted(x) == sorted(y), f.name
            for d in x:
                np.testing.assert_array_equal(x[d], y[d], err_msg=f.name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_curve_routes(monkeypatch, tmp_path):
    """Without a checkpoint the grid runs, with one the scan step, with a
    step_factory one round a call; each equals the eager route on the same
    keys (debug_nan_checks selects it)."""
    cfg = dataclasses.replace(_tiny(tc), ebno_db=(12.0,))
    calls = []
    for name in ("make_fused_nbf_grid", "make_sharded_nbf_scan_step",
                 "nbf_snr_point"):
        orig = getattr(tmc, name)
        monkeypatch.setattr(tmc, name, lambda *a, _n=name, _o=orig, **k:
                            calls.append(_n) or _o(*a, **k))
    kw = dict(blocks_per_round=2, device="cpu", progress=None,
              rounds_per_call=2)
    grid = tmc.run_nbf_curve(cfg, 4, **kw)
    assert calls == ["make_fused_nbf_grid"]
    step = tmc.run_nbf_curve(cfg, 4, checkpoint=SnrCheckpoint(str(tmp_path)),
                             **kw)
    assert calls[1:] == ["make_sharded_nbf_scan_step"]
    made = []

    def factory(cfg_, device=None, mesh=None):
        made.append((device, mesh))
        return tmc.make_sharded_nbf_step(cfg_, device, mesh)

    by_round = tmc.run_nbf_curve(cfg, 4, step_factory=factory, **kw)
    assert made == [(torch.device("cpu"), None)]
    assert not {"make_fused_nbf_grid", "nbf_snr_point"} & set(calls[2:])
    n = len(calls)
    with debug_nan_checks():
        eager = tmc.run_nbf_curve(cfg, 4, **kw)
    assert "nbf_snr_point" in calls[n:]
    for res in (step, by_round, eager):
        _same_curve(grid, res)
    np.testing.assert_array_equal(grid.n_blocks, [4])


def test_flaky_step_factory_is_retried():
    """A round that fails transiently is run again, exactly (the port of
    tests/test_fault_tolerance.py:test_round_retry_recovers)."""
    cfg = dataclasses.replace(_tiny(tc), ebno_db=(12.0,))
    calls = {"n": 0}

    def flaky_factory(cfg_, device=None, mesh=None):
        real = tmc.make_sharded_nbf_step(cfg_, device, mesh)

        def step(ebno, keys):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected chaos: a round dropped")
            return real(ebno, keys)

        return step

    msgs = []
    res = tmc.run_nbf_curve(cfg, 2, blocks_per_round=1, device="cpu",
                            progress=msgs.append, step_factory=flaky_factory)
    assert calls["n"] == 3                  # 2 rounds, the first run twice
    assert any("injected chaos" in m for m in msgs)
    want = tmc.run_nbf_curve(cfg, 2, blocks_per_round=1, device="cpu",
                             progress=None)
    _same_curve(res, want)


@pytest.mark.parametrize("ebno,jj", SNRS, ids=["12dB", "3dB-doubled-cap"])
def test_run_nbf_blocks_on_a_row_equals_the_float_path(ebno, jj):
    cfg = _tiny(tc)
    keys = _keys(jj)[0]
    want = tmc._host_nbf(tbf.run_nbf_blocks(cfg, ebno, keys))
    row = ebno_row(cfg, ebno, torch.device("cpu"))
    got = tmc._host_nbf(tbf.run_nbf_blocks(cfg, row, keys,
                                   iter_cap=tbf.bp_iter_cap(cfg, ebno)))
    _same(got, want)
    with pytest.raises(ValueError, match="iter_cap"):
        tbf.run_nbf_blocks(cfg, row, keys)


def test_bp_iter_cap_and_eager_reasons():
    cfg = _tiny(tc)
    assert [tbf.bp_iter_cap(cfg, e) for e in (3.0, 5.999, 6.0, 12.0)] == [
        40, 40, 20, 20]
    assert tmc.nbf_eager_reason(cfg) is None
    assert tmc.nbf_eager_reason(cfg, TrialsMesh(1, 0, None)) is None
    assert tmc.nbf_eager_reason(cfg, TrialsMesh(2, 0, None)) is None
    gal = dataclasses.replace(cfg, ldpc=dataclasses.replace(
        cfg.ldpc, family="gallager"))
    assert "QC" in tmc.nbf_eager_reason(gal)
    unc = dataclasses.replace(cfg, ldpc=dataclasses.replace(
        cfg.ldpc, enabled=False, family="gallager"))
    assert tmc.nbf_eager_reason(unc) is None        # no BP: fused
    assert "QC" in tmc.eager_reason(unc)            # the CDL route's rule
    with debug_nan_checks():
        assert tmc.nbf_eager_reason(cfg) == "debug_nan_checks"


def test_uncoded_and_block_mode_steps_equal_their_eager_points():
    cfg = _tiny(tc)
    for c in (dataclasses.replace(cfg, ldpc=dataclasses.replace(
                  cfg.ldpc, enabled=False)),
              dataclasses.replace(cfg, esn=dataclasses.replace(
                  cfg.esn, rng_mode="block"))):
        keys = _keys(1, rounds=2)
        got = tmc._host_nbf(tmc.make_sharded_nbf_scan_step(c, device="cpu")(
            12.0, keys))
        _same(got, tmc.nbf_snr_point(c, 12.0, keys, device="cpu"))


def test_round_body_never_reads_a_value_on_the_host(monkeypatch):
    """One scan step (its round body, both BP caps) under _NoHostSync. The
    plain stand-ins of K1, K2 and K3 read their seed and compact converged
    codewords on the host by nature: their wrappers are exempted by name,
    and each must have run. The SVD's plain version is not exempted."""
    cfg = _tiny(tc)
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
    scan = tmc.make_sharded_nbf_scan_step(cfg, device="cpu")
    keys = _keys(0)
    with mode:
        pts = [scan(e, keys) for e in (12.0, 3.0)]
    assert set(ran) == {"ldpc_decode_bp_cuda_counts", "esn_predict_cuda",
                        "esn_states_cuda"}
    for pt, e in zip(pts, (12.0, 3.0)):
        _same(tmc._host_nbf(pt), tmc.nbf_snr_point(cfg, e, keys, device="cpu"))
