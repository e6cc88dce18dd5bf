"""The port's ESN engine (plain PyTorch) against the JAX package, noise 0.

  * esn_states vs the JAX scan at the tests/test_esn_pallas.py state
    tolerance (atol 2e-5, rtol 1e-4);
  * esn_predict (the plain version of the CUDA predict kernel) vs the JAX
    esn_predict and vs esn_predict_pallas in interpret mode at atol 1e-4,
    rtol 1e-3 — grouped readouts and a batch that is no multiple of the
    Pallas kernel's chunk included;
  * train_mimo_esn + esn_detect_symbols: the detected symbols within 1e-3
    relative (the readout itself is an ill-conditioned dual solve, so the
    comparison is on what it detects).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401
from esn_ofdm_mimo_tpu import ops as jops
from esn_ofdm_mimo_tpu.models import esn as jesn
from esn_ofdm_mimo_tpu.models import esn_mimo as jmimo
from esn_ofdm_mimo_tpu.models.esn_pallas import esn_predict_pallas
from esn_ofdm_mimo_tpu_torch.models import esn as tesn
from esn_ofdm_mimo_tpu_torch.models import esn_cuda
from esn_ofdm_mimo_tpu_torch.models import esn_mimo as tmimo
from esn_ofdm_mimo_tpu_torch.utils import convert, rng


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


@pytest.mark.parametrize("T,n_res", [(40, 50), (25, 300)])
def test_states_match_jax(T, n_res):
    res, scale, X, D = _mk(T=T, n_res=n_res)
    jr, js = _jax(res, scale)
    want = jesn.esn_states(jr, js, jnp.asarray(X), jnp.asarray(D * 1e-2),
                           jax.random.PRNGKey(0))
    got = tesn.esn_states(convert.reservoir(res), convert.scale(scale),
                          torch.as_tensor(X), torch.as_tensor(D * 1e-2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_init_reservoir_matches_jax_at_same_key():
    key = jax.random.PRNGKey(11)
    want = jesn.init_reservoir(key, 8, 4, 60, 0.9, 0.1, 1e-3)
    got = tesn.init_reservoir(rng.as_keys(np.asarray(key)), 8, 4, 60, 0.9,
                              0.1, 1e-3)
    # uniform draws are bit-exact; the power-iteration radius rounds
    # differently across the two libraries' matvecs
    for name in ("Wt", "W_in_t", "W_fb_t"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-7)
    assert got.noise == pytest.approx(1e-3)


@pytest.mark.parametrize("B,G", [(3, 3), (150, 150), (150, 3), (296, 4)],
                         ids=["per-row", "ragged", "grouped", "grouped-tile"])
def test_predict_matches_jax_and_pallas_interpret(B, G):
    res, scale, X, D = _mk(B=3, T=30)
    jr, js = _jax(res, scale)
    key = jax.random.PRNGKey(1)
    W3 = jesn.esn_fit(jr, js, jnp.asarray(X), jnp.asarray(D), 3, key)
    Xb = np.repeat(X, -(-B // 3), axis=0)[:B] + np.float32(0.01) * \
        np.random.default_rng(B).standard_normal((B, 30, 4)).astype(
            np.float32)
    Wt = np.asarray(W3)[np.arange(G) % 3]
    Wt = Wt * (1.0 + 0.01 * np.arange(G, dtype=np.float32))[:, None, None]
    want = jesn.esn_predict(jr, js, jnp.asarray(Wt), jnp.asarray(Xb), 3, key)
    want_pl = esn_predict_pallas(jr, js, jnp.asarray(Wt), jnp.asarray(Xb), 3,
                                 key, interpret=True)
    got = tesn.esn_predict(convert.reservoir(res), convert.scale(scale),
                           convert.readout(Wt), torch.as_tensor(Xb), 3)
    for ref in (want, want_pl):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-3)


def test_predict_wrapper_runs_plain_version_on_cpu():
    res, scale, X, D = _mk(B=4, T=20)
    r, s = convert.reservoir(res), convert.scale(scale)
    Wt = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2, 54, 2)).astype(np.float32)) * 0.1
    before = esn_cuda.launches
    got = esn_cuda.esn_predict_cuda(r, s, Wt, torch.as_tensor(X), 2)
    assert esn_cuda.launches == before        # the kernel was not launched
    torch.testing.assert_close(got, tesn.esn_predict(r, s, Wt,
                                                     torch.as_tensor(X), 2))
    # the CUDA layout helper stacks [Wt; W_in_t; W_fb_t], zero padded
    Wc = esn_cuda.stacked_weights(r, 4, 2, 64)
    assert Wc.shape == (64, 64)
    torch.testing.assert_close(Wc[:50, :50], r.Wt)
    torch.testing.assert_close(Wc[50:54, :50], r.W_in_t)
    torch.testing.assert_close(Wc[54:56, :50], r.W_fb_t)
    assert float(Wc[56:].abs().sum() + Wc[:, 50:].abs().sum()) == 0.0


def _waveforms(seed, B, D, N=32, cp=7, n_tx=2, n_rx=4, ebno=12.0):
    """Pilot and data waveforms through a TDL-B channel, made with the JAX
    package's ops from numpy draws."""
    r = np.random.default_rng(seed)
    No = 1e-5
    var_x = 10 ** (ebno / 10) * No * N
    sqrt_pi = np.float32(np.sqrt(var_x / N))
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    from esn_ofdm_mimo_tpu.ops.channel import draw_tdl_taps
    taps = jax.vmap(lambda k: draw_tdl_taps(k, n_rx, n_tx, 8, 2.048e6,
                                            300.0))(keys)

    def chain(X, lead):
        x = jops.ofdm_modulate(jnp.asarray(X), cp) * sqrt_pi
        t = taps if lead == 0 else taps[:, None]
        std = np.sqrt((N + cp) * No / 2)
        noise = std * (r.standard_normal(x.shape[:-2] + (n_rx, N + cp))
                       + 1j * r.standard_normal(x.shape[:-2]
                                                + (n_rx, N + cp)))
        return x, jops.apply_fir_channel(t, x) + noise.astype(np.complex64)

    const = np.asarray(jops.qam_constellation(4))
    x_p, y_p = chain(const[r.integers(0, 16, (B, n_tx, N))], 0)
    x_d, y_d = chain(const[r.integers(0, 16, (B, D, n_tx, N))], 1)
    return (np.asarray(x_p), np.asarray(y_p), np.asarray(x_d),
            np.asarray(y_d), float(sqrt_pi), float(var_x))


def test_train_and_detect_match_jax():
    B, D, N, cp, delay = 3, 5, 32, 7, 3
    x_p, y_p, _, y_d, sqrt_pi, var_x = _waveforms(0, B, D)
    key = jax.random.PRNGKey(4)
    jr = jesn.init_reservoir(key, 8, 4, 40, 0.9, 0.1, 0.0)
    res = convert.reservoir({k: np.asarray(getattr(jr, k))
                             for k in jr._fields})
    scale = {"input_scaling": np.float32(0.005) / np.sqrt(np.float32(var_x)),
             "input_shift": 0.0, "teacher_scaling": 5e-7}
    _, js = _jax({"Wt": 0, "W_in_t": 0, "W_fb_t": 0, "noise": 0}, scale)
    Wj = jmimo.train_mimo_esn(jr, js, jnp.asarray(y_p), jnp.asarray(x_p),
                              delay, cp, key)
    Wt = tmimo.train_mimo_esn(res, convert.scale(scale),
                              torch.as_tensor(y_p), torch.as_tensor(x_p),
                              delay, cp)
    y_rows = y_d.reshape(B * D, 4, N + cp)
    Xj = np.asarray(jmimo.esn_detect_symbols(
        jr, js, Wj, jnp.asarray(y_rows), delay, cp, N, sqrt_pi, key))
    Xt = tmimo.esn_detect_symbols(res, convert.scale(scale), Wt,
                                  torch.as_tensor(y_rows), delay, cp, N,
                                  sqrt_pi).numpy()
    assert Xt.shape == (B * D, N, 2)
    rel = np.linalg.norm(Xt - Xj) / np.linalg.norm(Xj)
    assert rel < 1e-3, rel
    assert np.isfinite(Xt).all()
