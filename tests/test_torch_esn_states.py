"""The plain versions behind K3 (ESN state harvest) and K4 (grouped-readout
predict) against the JAX package's XLA scans and Pallas kernels in
interpret mode, ESN noise 0.

  * esn_states and esn_states_cuda (CPU tensors: the plain version) vs JAX
    esn_states and esn_states_pallas(interpret=True), at the state tolerance
    of tests/test_esn_pallas.py (atol 2e-5, rtol 1e-4);
  * esn_predict_cuda(readout="grouped") on the CPU vs JAX esn_predict_pallas
    under ESN_TPU_PREDICT_READOUT=grouped, at the shape of
    tests/test_esn_pallas.py:test_predict_kernel_grouped_readouts (atol
    1e-4, rtol 1e-3);
  * the condition on which detection takes K4, and the fit's routing.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401
from esn_ofdm_mimo_tpu.models import esn as jesn
from esn_ofdm_mimo_tpu.models.esn_pallas import (esn_predict_pallas,
                                                 esn_states_pallas)
from esn_ofdm_mimo_tpu_torch.models import esn as tesn
from esn_ofdm_mimo_tpu_torch.models import esn_cuda, esn_states_cuda
from esn_ofdm_mimo_tpu_torch.models import esn_mimo as tmimo
from esn_ofdm_mimo_tpu_torch.utils import convert


def _mk(B=3, T=40, n_res=50, n_in=4, n_out=2, seed=0):
    """The fixture of tests/test_esn_pallas.py, as numpy."""
    r = np.random.default_rng(seed)
    W = r.uniform(-0.5, 0.5, (n_res, n_res)).astype(np.float32)
    W *= np.float32(0.9 / np.max(np.abs(np.linalg.eigvals(
        W.astype(np.float64)))))
    res = {"Wt": W.T, "noise": 0.0,
           "W_in_t": r.uniform(-1, 1, (n_res, n_in)).astype(np.float32).T,
           "W_fb_t": r.uniform(-1, 1, (n_res, n_out)).astype(np.float32).T}
    scale = {"input_scaling": 0.1, "input_shift": 0.0,
             "teacher_scaling": 1e-2}
    X = r.standard_normal((B, T, n_in)).astype(np.float32)
    D = r.standard_normal((B, T, n_out)).astype(np.float32)
    return res, scale, X, D


def _jax(res, scale):
    return (jesn.EsnReservoir(*(jnp.asarray(res[k]) for k in
                                ("Wt", "W_in_t", "W_fb_t")),
                              noise=jnp.float32(res["noise"])),
            jesn.EsnScale(*(jnp.float32(scale[k]) for k in
                            ("input_scaling", "input_shift",
                             "teacher_scaling"))))


@pytest.mark.parametrize("B,T,n_res,n_in,n_out",
                         [(3, 40, 50, 4, 2), (9, 23, 130, 16, 8),
                          (2, 12, 7, 2, 2)])
def test_states_match_jax_scan_and_pallas_interpret(B, T, n_res, n_in,
                                                    n_out):
    res, scale, X, D = _mk(B, T, n_res, n_in, n_out, seed=B)
    jr, js = _jax(res, scale)
    key = jax.random.PRNGKey(0)
    teach = D * np.float32(1e-2)
    want = jesn.esn_states(jr, js, jnp.asarray(X), jnp.asarray(teach), key)
    want_pl = esn_states_pallas(jr, js, jnp.asarray(X), jnp.asarray(teach),
                                key, interpret=True)
    r, s = convert.reservoir(res), convert.scale(scale)
    before = esn_states_cuda.launches
    got_k = esn_states_cuda.esn_states_cuda(r, s, torch.as_tensor(X),
                                            torch.as_tensor(teach), seed=5)
    assert esn_states_cuda.launches == before   # CPU: the plain version
    got = tesn.esn_states(r, s, torch.as_tensor(X), torch.as_tensor(teach))
    torch.testing.assert_close(got_k, got, rtol=0, atol=0)
    assert got.shape == (B, T, n_res)
    assert float(got[:, 0].abs().max()) == 0.0
    for ref in (want, want_pl):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=1e-4)


def test_states_wrapper_seeds_the_plain_noise_stream():
    res, scale, X, D = _mk(B=4, T=15)
    r = convert.reservoir(dict(res, noise=1e-3))
    s = convert.scale(scale)
    got = esn_states_cuda.esn_states_cuda(r, s, torch.as_tensor(X),
                                          torch.as_tensor(D), seed=77)
    gen = torch.Generator()
    gen.manual_seed(77)
    want = tesn.esn_states(r, s, torch.as_tensor(X), torch.as_tensor(D), gen)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    clean = tesn.esn_states(r._replace(noise=0.0), s, torch.as_tensor(X),
                            torch.as_tensor(D))
    assert 0.0 < float((got - clean).abs().max()) < 0.01


def test_grouped_predict_matches_pallas_grouped_kernel(monkeypatch):
    monkeypatch.setenv("ESN_TPU_PREDICT_READOUT", "grouped")
    res, scale, X, D = _mk(B=3, T=30)
    jr, js = _jax(res, scale)
    key = jax.random.PRNGKey(3)
    Wt_out = jesn.esn_fit(jr, js, jnp.asarray(X), jnp.asarray(D), 3, key)
    Dg = 50                                  # P = 64 // 50 + 2 = 3 <= 4
    Xb = np.repeat(X, Dg, axis=0)            # (150, T, n_in) grouped
    want = esn_predict_pallas(jr, js, Wt_out, jnp.asarray(Xb), 3, key,
                              interpret=True)
    assert esn_cuda.grouped_viable(3, Dg)
    before = (esn_cuda.launches, esn_cuda.launches_grouped)
    got = esn_cuda.esn_predict_cuda(
        convert.reservoir(res), convert.scale(scale),
        convert.readout(np.asarray(Wt_out)), torch.as_tensor(Xb), 3,
        readout="grouped")
    assert (esn_cuda.launches, esn_cuda.launches_grouped) == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("G,Dg,viable", [
    (128, 74, True),      # flagship detect: P = 2
    (128, 18, False),     # runs of 18 rows under a 64-row block: P = 5
    (128, 1, False),      # per-row readouts
    (2, 3, True),         # P capped at G
])
def test_grouped_condition(G, Dg, viable):
    # at the default of 64 rows a block; a launch passes the rows its tiling
    # gives a block (tests/test_torch_esn_tiling.py)
    assert esn_cuda.grouped_viable(G, Dg) is viable
    assert esn_cuda.grouped_slots(G, Dg) == min(G, 64 // Dg + 2)
    assert esn_cuda.grouped_slots(G, Dg, 64) == esn_cuda.grouped_slots(G, Dg)


def test_grouped_readout_argument_checks():
    res, scale, X, _ = _mk(B=4, T=10)
    Wt = torch.zeros(2, 54, 2)
    with pytest.raises(ValueError, match="unknown readout"):
        esn_cuda.esn_predict_cuda(convert.reservoir(res),
                                  convert.scale(scale), Wt,
                                  torch.as_tensor(X), 2, readout="masked")


def test_detect_symbols_same_on_cpu_under_the_grouped_switch(monkeypatch):
    res, scale, _, _ = _mk(B=1, T=5, n_in=8, n_out=4)
    r, s = convert.reservoir(res), convert.scale(scale)
    g = np.random.default_rng(1)
    y = torch.as_tensor((g.standard_normal((6, 4, 39)) + 1j
                         * g.standard_normal((6, 4, 39))).astype(np.complex64))
    Wt = torch.as_tensor(0.1 * g.standard_normal((2, 58, 4)).astype(
        np.float32))
    plain = tmimo.esn_detect_symbols(r, s, Wt, y, 3, 7, 32, 0.5)
    monkeypatch.setenv("ESN_TPU_PREDICT_READOUT", "grouped")
    grouped = tmimo.esn_detect_symbols(r, s, Wt, y, 3, 7, 32, 0.5)
    torch.testing.assert_close(grouped, plain, rtol=0, atol=0)
