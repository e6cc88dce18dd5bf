"""ESN continuation in the port: `esn_fit(..., return_carry=True)` and
`esn_predict(..., init_carry=...)` (pyESN's continuation=True) against the
JAX package, state noise 0.

  * the fit on tests/test_esn.py's setup (40 neurons, T = 120, the float64
    oracle's weights): readout within atol 1e-4 / rtol 1e-3 (the tolerance
    of tests/test_torch_esn.py's predictions), laststate within 2e-5 (the
    state tolerance there), lastoutput equal (one float32 product);
  * the continued prediction against JAX's within atol 1e-4 / rtol 1e-3,
    and away from the zero-carry prediction; a carry of one row per batch
    row in the per-row, ragged and grouped cases of test_torch_esn.py;
  * the predict wrapper takes the carry on CPU tensors without a launch;
  * train_mimo_esn, now through esn_fit, equals the inline fit it was,
    bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401
from esn_ofdm_mimo_tpu.models import esn as jesn
from esn_ofdm_mimo_tpu_torch.models import esn as tesn
from esn_ofdm_mimo_tpu_torch.models import esn_cuda
from esn_ofdm_mimo_tpu_torch.models import esn_mimo as tmimo
from esn_ofdm_mimo_tpu_torch.models.esn_states_cuda import esn_states_cuda
from esn_ofdm_mimo_tpu_torch.utils import convert

torch.set_num_threads(1)


def _oracle_setup(seed=0, n=40, n_in=2, n_out=2, T=120, in_scale=0.05,
                  t_scale=5e-3):
    """tests/test_esn.py's _mk, as numpy dicts."""
    r = np.random.default_rng(seed)
    W = r.uniform(-0.5, 0.5, (n, n))
    W *= 0.9 / np.max(np.abs(np.linalg.eigvals(W)))
    W_in = r.uniform(-1, 1, (n, n_in))
    W_fb = r.uniform(-1, 1, (n, n_out))
    X = r.standard_normal((T, n_in))
    D = r.standard_normal((T, n_out))
    res = {"Wt": W.T.astype(np.float32), "W_in_t": W_in.T.astype(np.float32),
           "W_fb_t": W_fb.T.astype(np.float32), "noise": 0.0}
    scale = {"input_scaling": in_scale, "input_shift": 0.0,
             "teacher_scaling": t_scale}
    return res, scale, X.astype(np.float32), D.astype(np.float32)


def _both(res, scale):
    jr = jesn.EsnReservoir(*(jnp.asarray(res[k]) for k in
                             ("Wt", "W_in_t", "W_fb_t")),
                           noise=jnp.float32(res["noise"]))
    js = jesn.EsnScale(*(jnp.float32(scale[k]) for k in
                         ("input_scaling", "input_shift", "teacher_scaling")))
    return (jr, js), (convert.reservoir(res), convert.scale(scale))


@pytest.fixture(scope="module")
def fitted():
    res, scale, X, D = _oracle_setup()
    (jr, js), (tr, ts) = _both(res, scale)
    W_j, (s_j, o_j) = jesn.esn_fit(jr, js, jnp.asarray(X)[None],
                                   jnp.asarray(D)[None], 10,
                                   jax.random.PRNGKey(0), return_carry=True)
    W_t, (s_t, o_t) = tesn.esn_fit(tr, ts, torch.as_tensor(X)[None],
                                   torch.as_tensor(D)[None], 10,
                                   return_carry=True)
    return dict(res=res, scale=scale, X=X, D=D, jax=(jr, js, W_j, s_j, o_j),
                port=(tr, ts, W_t, s_t, o_t))


def test_fit_with_carry_matches_jax(fitted):
    _, _, W_j, s_j, o_j = fitted["jax"]
    _, _, W_t, s_t, o_t = fitted["port"]
    assert W_t.shape == (1, 42, 2) and s_t.shape == (1, 40)
    np.testing.assert_allclose(W_t.numpy(), np.asarray(W_j), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=2e-5)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    # the carry is the fit's last state and last scaled teacher
    np.testing.assert_array_equal(o_t.numpy()[0],
                                  fitted["D"][-1] * np.float32(5e-3))
    # without return_carry: the readout alone, the same one
    tr, ts = fitted["port"][:2]
    W_only = tesn.esn_fit(tr, ts, torch.as_tensor(fitted["X"])[None],
                          torch.as_tensor(fitted["D"])[None], 10)
    assert torch.equal(W_only, W_t)


def test_predict_with_carry_matches_jax(fitted):
    jr, js, W_j, s_j, o_j = fitted["jax"]
    tr, ts, W_t, s_t, o_t = fitted["port"]
    X2 = np.ascontiguousarray(fitted["X"][::-1])
    want = jesn.esn_predict(jr, js, W_j, jnp.asarray(X2)[None], 0,
                            jax.random.PRNGKey(1), init_carry=(s_j, o_j))
    # the port's own readout and carry, and JAX's: both at the tolerance
    for W, carry in ((W_t, (s_t, o_t)),
                     (convert.readout(np.asarray(W_j)),
                      (convert.tensor(s_j), convert.tensor(o_j)))):
        got = tesn.esn_predict(tr, ts, W, torch.as_tensor(X2)[None], 0,
                               init_carry=carry)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-3)
    zero = tesn.esn_predict(tr, ts, W_t, torch.as_tensor(X2)[None], 0)
    assert float((got - zero).norm()) > 1e-3
    # a (n_res,) / (n_out,) carry broadcasts like a (1, .) one
    flat = tesn.esn_predict(tr, ts, W_t, torch.as_tensor(X2)[None], 0,
                            init_carry=(s_t[0], o_t[0]))
    assert torch.equal(flat, tesn.esn_predict(
        tr, ts, W_t, torch.as_tensor(X2)[None], 0, init_carry=(s_t, o_t)))


def _mk(B=3, T=30, n_res=50, n_in=4, n_out=2, seed=0):
    """tests/test_torch_esn.py's fixture (that of tests/test_esn_pallas.py)."""
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


@pytest.mark.parametrize("B,G", [(3, 3), (150, 150), (150, 3), (296, 4)],
                         ids=["per-row", "ragged", "grouped", "grouped-tile"])
def test_predict_with_a_carry_per_row_matches_jax(B, G):
    """A carry of its own for every row (the fit's last states and outputs,
    perturbed by row), grouped readouts as in test_torch_esn.py."""
    res, scale, X, D = _mk()
    (jr, js), (tr, ts) = _both(res, scale)
    W3, (s3, o3) = jesn.esn_fit(jr, js, jnp.asarray(X), jnp.asarray(D), 3,
                                jax.random.PRNGKey(1), return_carry=True)
    rr = np.random.default_rng(B + G)
    s0 = (np.asarray(s3)[np.arange(B) % 3]
          + np.float32(0.05) * rr.standard_normal((B, 50))).astype(np.float32)
    o0 = (np.asarray(o3)[np.arange(B) % 3]
          + np.float32(0.01) * rr.standard_normal((B, 2))).astype(np.float32)
    Xb = np.repeat(X, -(-B // 3), axis=0)[:B] + np.float32(0.01) * \
        rr.standard_normal((B, 30, 4)).astype(np.float32)
    Wt = np.asarray(W3)[np.arange(G) % 3]
    Wt = Wt * (1.0 + 0.01 * np.arange(G, dtype=np.float32))[:, None, None]
    want = jesn.esn_predict(jr, js, jnp.asarray(Wt), jnp.asarray(Xb), 3,
                            jax.random.PRNGKey(1),
                            init_carry=(jnp.asarray(s0), jnp.asarray(o0)))
    got = tesn.esn_predict(tr, ts, convert.readout(Wt), torch.as_tensor(Xb),
                           3, init_carry=(torch.as_tensor(s0),
                                          torch.as_tensor(o0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)
    zero = tesn.esn_predict(tr, ts, convert.readout(Wt), torch.as_tensor(Xb),
                            3)
    assert float((got - zero).abs().max()) > 1e-3


def test_predict_wrapper_takes_the_carry_on_cpu():
    res, scale, X, D = _mk(B=4, T=20)
    r, s = convert.reservoir(res), convert.scale(scale)
    W, (s0, o0) = tesn.esn_fit(r, s, torch.as_tensor(X[:2]),
                               torch.as_tensor(D[:2]), 2, return_carry=True)
    x = torch.as_tensor(X)
    before = (esn_cuda.launches, esn_cuda.launches_grouped)
    for readout in ("per_row", "grouped"):
        got = esn_cuda.esn_predict_cuda(r, s, W, x, 2, 5, readout=readout,
                                        init_carry=(s0[:1], o0[:1]))
        gen = torch.Generator().manual_seed(5)
        assert torch.equal(got, tesn.esn_predict(r, s, W, x, 2, gen,
                                                 init_carry=(s0[:1], o0[:1])))
    assert (esn_cuda.launches, esn_cuda.launches_grouped) == before
    # the carry broadcasts to (B, .) rows, zeros without one
    s_b, o_b = tesn.broadcast_carry((s0[:1], o0[:1]), 4, 50, 2, x)
    assert s_b.shape == (4, 50) and s_b.is_contiguous()
    assert torch.equal(s_b[3], s0[0]) and torch.equal(o_b[2], o0[0])
    z_s, z_o = tesn.broadcast_carry(None, 4, 50, 2, x)
    assert not z_s.any() and not z_o.any() and z_o.shape == (4, 2)


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_train_mimo_esn_through_esn_fit_is_unchanged(noise):
    """train_mimo_esn now calls esn_fit: the same readout, bit for bit, as
    its inline fit before (the states of esn_states_cuda's plain version,
    the scaled inputs appended, the ridge solve on rows [n_forget:]),
    state noise on and off."""
    r = np.random.default_rng(3)
    B, n_rx, n_tx, T, delay, cp = 3, 4, 2, 39, 3, 7
    y = torch.complex(*(torch.as_tensor(r.standard_normal((B, n_rx, T)),
                                        dtype=torch.float32)
                        for _ in range(2)))
    x = torch.complex(*(torch.as_tensor(r.standard_normal((B, n_tx, T)),
                                        dtype=torch.float32)
                        for _ in range(2)))
    res = tesn.init_reservoir(torch.tensor([0, 9]), 2 * n_rx, 2 * n_tx, 40,
                              noise=noise)
    scale = tesn.EsnScale(0.3, 0.0, 0.2)
    got = tmimo.train_mimo_esn(res, scale, y, x, delay, cp, 17)
    X_in, X_out = tmimo.build_esn_io(y, x, delay)
    ts = X_out * scale.teacher_scaling
    states = esn_states_cuda(res, scale, X_in, ts, 17)
    ext = torch.cat([states, tesn.scale_inputs(scale, X_in)], dim=-1)
    want = tesn._readout_lstsq(ext[:, delay + cp:], ts[:, delay + cp:])
    assert torch.equal(got, want)
