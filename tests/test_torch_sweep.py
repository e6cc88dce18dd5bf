"""The ESN hyperparameter sweep of the port (experiments/sweep.py) against
the JAX package's, on the CPU, and the readout solve it leans on.

  * run_sweep on a tiny 2x2 block-fading base (QPSK, N = 64, n_res 64,
    uncoded, ESN state noise 0), 4 blocks at 12 dB: a traced parameter
    ("spectral", through esn_over) and "reservoir" (a config per value),
    each value's ESN BER against the JAX run_sweep on the same seed within
    1% + 10 bit errors, the band tests/test_torch_nbf.py gives the ESN's
    ill-conditioned readout solve (measured: equal, or 1-24 bits of 18,432
    apart). The value lists are cut to two each (the JAX package compiles
    once per reservoir width);
  * main() of both packages on that base: the same [sweep] lines, and
    ESN_sweep_{param}.json with the same keys; the PNG beside it where
    matplotlib is installed;
  * the readout solve on a state matrix of low numerical rank, where
    rounding leaves the fp32 Gram indefinite: the port solves with the JAX
    package's Newton-Schulz solver (ops/linalg.py:ns_solver), finite, its
    fitted outputs within 1% of the JAX readout's; on a well-conditioned
    system of the same size it takes the same solver, its fitted outputs
    within 1e-4 of the largest of JAX's. (Before the port solved with this
    solver at all, the tiny base raised in a float64 Cholesky at every
    value; while it still factored where it could, the sweep below parted.)
  * the sweep on a 16-QAM base (N = 32, n_res 40, ESN noise 0) at spectral
    radius 0.5, where the readout's Gram is ill-conditioned (condition
    number above ~1e6): the ESN BER within 1% + 10 bit errors of JAX's.
    The 40 Newton-Schulz iterations regularise there, an exact
    factorisation does not: with the float64 Cholesky the port read 0.407
    against JAX's 0.331.
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.experiments import presets as jpresets
from esn_ofdm_mimo_tpu.experiments import sweep as jsw
from esn_ofdm_mimo_tpu.models import esn as jesn
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.experiments import presets as tpresets
from esn_ofdm_mimo_tpu_torch.experiments import sweep as tsw
from esn_ofdm_mimo_tpu_torch.models import esn as tesn

torch.set_num_threads(1)

BLOCKS = 4
CUT = {"spectral": (0.5, 0.99), "reservoir": (24, 64),
       "teachers": (5e-7, 5e-5)}


def _tiny(mod, n_subcarriers=64, bits_per_symbol=2, n_reservoir=64):
    return mod.SimConfig(
        name="tiny",
        ofdm=mod.OfdmConfig(n_subcarriers=n_subcarriers,
                            bits_per_symbol=bits_per_symbol,
                            doppler_hz=3000.0),
        channel=mod.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=mod.EsnConfig(n_reservoir=n_reservoir, noise=0.0),
        ldpc=mod.LdpcConfig(enabled=False), ebno_db=(12.0,))


@pytest.fixture
def cut_sweeps(monkeypatch):
    for mod in (jsw, tsw):
        sweeps = dict(mod.SWEEPS)
        sweeps.update(CUT)
        monkeypatch.setattr(mod, "SWEEPS", sweeps)


def _errors(ber):
    """BER -> bit errors over the tiny base's bits (4 blocks x 18 data
    symbols x 2 streams x 128 bits)."""
    return ber * BLOCKS * 18 * 2 * 128


def test_sweep_values_and_traced_keys_equal_jax():
    assert tsw.SWEEPS == jsw.SWEEPS
    assert tsw._TRACED == jsw._TRACED
    for p, v in (("reservoir", 50), ("spectral", 0.7), ("sparsity", 0.3),
                 ("inpscale", 0.02), ("teachers", 5e-6)):
        j, t = jsw._apply(_tiny(jc), p, v).esn, tsw._apply(_tiny(tc), p, v).esn
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in j.__dataclass_fields__}, p
    with pytest.raises(ValueError):
        tsw._apply(_tiny(tc), "leak", 0.1)


@pytest.mark.parametrize("param", ["spectral", "reservoir"])
def test_run_sweep_matches_jax(param, cut_sweeps):
    want = jsw.run_sweep(param, 12.0, BLOCKS, 0, _tiny(jc))
    got = tsw.run_sweep(param, 12.0, BLOCKS, 0, _tiny(tc), device="cpu")
    assert list(got) == list(want) == [float(v) for v in CUT[param]]
    for v in want:
        w = _errors(want[v])
        assert 0.0 < got[v] < 0.5
        assert abs(_errors(got[v]) - w) <= 0.01 * w + 10, (v, got[v],
                                                             want[v])


def test_sweep_main_writes_jax_keys(tmp_path, monkeypatch, cut_sweeps,
                                    capsys):
    monkeypatch.setattr(jpresets, "mimo_2x2_nbf",
                        lambda fast=False: _tiny(jc))
    monkeypatch.setattr(tpresets, "mimo_2x2_nbf",
                        lambda fast=False: _tiny(tc))
    argv = ["--param", "teachers", "--blocks", str(BLOCKS)]
    jsw.main(argv + ["--outdir", str(tmp_path / "jax")])
    j_lines = [x for x in capsys.readouterr().out.splitlines()
               if x.startswith("[sweep]")]
    tsw.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    t_lines = [x for x in capsys.readouterr().out.splitlines()
               if x.startswith("[sweep]")]
    assert [x.split(":")[0] for x in t_lines] == \
        [x.split(":")[0] for x in j_lines] == \
        [f"[sweep] teachers={v}" for v in CUT["teachers"]]
    with open(tmp_path / "jax" / "ESN_sweep_teachers.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "ESN_sweep_teachers.json") as f:
        got = json.load(f)
    assert list(got) == list(want) == ["5e-07", "5e-05"]
    for k in want:
        w = _errors(want[k])
        assert abs(_errors(got[k]) - w) <= 0.01 * w + 10, (k, got, want)
    assert ((tmp_path / "port" / "ESN_sweep_teachers.png").exists()
            == (tmp_path / "jax" / "ESN_sweep_teachers.png").exists())


def test_sweep_needs_a_device_argument_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsw.run_sweep("spectral", 12.0, 1, 0, _tiny(tc))


@pytest.mark.parametrize("R,F,rank", [(32, 40, 8), (64, 68, 20),
                                      (128, 60, 10)],
                         ids=["wide", "square", "tall"])
def test_readout_solve_of_low_rank_states(R, F, rank, monkeypatch):
    r = np.random.default_rng(rank)
    ext = (r.standard_normal((2, R, rank))
           @ r.standard_normal((2, rank, F))).astype(np.float32)
    tgt = (1e-3 * r.standard_normal((2, R, 4))).astype(np.float32)
    calls = []
    ns = tesn.ns_solver
    monkeypatch.setattr(tesn, "ns_solver",
                        lambda A: calls.append(A.shape) or ns(A))
    got = tesn._readout_lstsq(torch.as_tensor(ext),
                              torch.as_tensor(tgt)).numpy()
    assert len(calls) == 1 and np.isfinite(got).all()
    want = np.asarray(jesn._readout_lstsq(jnp.asarray(ext), jnp.asarray(tgt)))
    fit_got, fit_want = ext @ got, ext @ want
    assert (np.abs(fit_got - fit_want).max()
            <= 1e-2 * np.abs(fit_want).max())
    # a well-conditioned system of the same size takes the same solver
    calls.clear()
    full = r.standard_normal((2, R, F)).astype(np.float32)
    got = tesn._readout_lstsq(torch.as_tensor(full),
                              torch.as_tensor(tgt)).numpy()
    want = np.asarray(jesn._readout_lstsq(jnp.asarray(full),
                                          jnp.asarray(tgt)))
    assert len(calls) == 1
    np.testing.assert_allclose(full @ got, full @ want, rtol=0,
                               atol=1e-4 * np.abs(full @ want).max())


def test_readout_solve_of_an_ill_conditioned_sweep_matches_jax(monkeypatch):
    """The 16-QAM sweep case at spectral radius 0.5 (see the docstring)."""
    for mod in (jsw, tsw):
        monkeypatch.setattr(mod, "SWEEPS",
                            dict(mod.SWEEPS, spectral=(0.5,)))
    kw = dict(n_subcarriers=32, bits_per_symbol=4, n_reservoir=40)
    want = jsw.run_sweep("spectral", 12.0, BLOCKS, 0, _tiny(jc, **kw))[0.5]
    got = tsw.run_sweep("spectral", 12.0, BLOCKS, 0, _tiny(tc, **kw),
                        device="cpu")[0.5]
    cfg = _tiny(tc, **kw)
    bits = BLOCKS * cfg.data_symbols_per_block * 2 * 32 * 4
    assert 0.0 < got < 0.5
    assert abs(got - want) * bits <= 0.01 * want * bits + 10, (got, want)
