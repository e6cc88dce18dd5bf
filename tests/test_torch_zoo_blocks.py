"""The pieces of the port's 2x2 model-zoo comparison against the JAX
package's, on the CPU, with inputs made from a seed:

  * the pinv ablation readout (ESN_TPU_READOUT=pinv, both packages'
    module switch set as tests/test_esn.py sets the JAX one): fitted outputs
    within 1e-5 relative of JAX's, tall and wide; an unknown value raises;
  * esn_nmse within 1e-5 relative, and select_delay_by_nmse over delays
    0-4: the same best delays, the NMSE table within 1e-4 relative (ESN
    state noise 0: the two packages draw noise from different streams);
  * synth_block(return_pilot=True) and detect_data_symbols(return_td=True):
    the pilot and data waveforms equal JAX's within 1e-5 of their largest;
  * per-block training (models/zoo.py:train_regressor_per_block, one Adam
    over the stacked blocks) against separate per-block train_regressor
    runs of the port: losses and weights within 1e-6 after 50 epochs, for
    the CNN, the GRU and the FNN of pipelines/zoo2x2.py; and its losses
    against JAX's vmapped train_regressor from the same vmapped init (the
    weights carried over by utils/convert.py:regressors_per_block) within
    1e-5 relative over the first 10 epochs (the FNN 2e-5), and within 1e-6
    relative of the port's own float64 run; the GRU there as the pipeline
    trains it, through torch.nn.GRU (train_rnn_per_block), which is also
    held against the plain loop: losses within 1e-6 relative, weights and
    the trained GRUs' predictions of new inputs within 1e-5 after 50
    epochs (measured 6.9e-8 and 1.6e-6 for losses and weights). The FNN's
    band is wider because XLA's fp32 tanh on the CPU is an approximation
    (2.5e-7 from float64 on [-5, 5], torch's 3.2e-8): measured, the JAX
    losses leave the float64 run by 3.1e-6 of the largest loss in 10
    epochs, 1.24e-5 relative at the 10th, the port's by 1.2e-7.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.models import esn as jesn
from esn_ofdm_mimo_tpu.models import esn_mimo as jmimo
from esn_ofdm_mimo_tpu.models import zoo as jzoo
from esn_ofdm_mimo_tpu.pipelines import common as jcommon
from esn_ofdm_mimo_tpu.utils.rng import block_keys as jblock_keys
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.models import esn as tesn
from esn_ofdm_mimo_tpu_torch.models import esn_mimo as tmimo
from esn_ofdm_mimo_tpu_torch.models import zoo as tzoo
from esn_ofdm_mimo_tpu_torch.pipelines import common as tcommon
from esn_ofdm_mimo_tpu_torch.utils import convert, rng

torch.set_num_threads(1)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("R,F", [(60, 24), (24, 60)], ids=["tall", "wide"])
def test_pinv_readout_matches_jax(R, F, monkeypatch):
    r = np.random.default_rng(R)
    ext = r.standard_normal((3, R, F)).astype(np.float32)
    tgt = r.standard_normal((3, R, 4)).astype(np.float32)
    monkeypatch.setattr(jesn, "_READOUT_IMPL", "pinv")
    monkeypatch.setattr(tesn, "_READOUT_IMPL", "pinv")
    want = np.asarray(jesn._readout_lstsq(jnp.asarray(ext), jnp.asarray(tgt)))
    got = tesn._readout_lstsq(torch.as_tensor(ext), torch.as_tensor(tgt))
    assert got.dtype == torch.float32 and got.shape == (3, F, 4)
    assert _rel(ext @ got.numpy(), ext @ want) <= 1e-5
    monkeypatch.setattr(tesn, "_READOUT_IMPL", "lstsq")
    with pytest.raises(ValueError, match="ESN_TPU_READOUT"):
        tesn._readout_lstsq(torch.as_tensor(ext), torch.as_tensor(tgt))


def _esn_problem(B=3, T=39):
    """A reservoir (n_res 50, 2x2: n_in = n_out = 4, noise 0), its scale,
    and random complex waveforms y (B, 2, T), x (B, 2, T)."""
    r = np.random.default_rng(5)
    y = (r.standard_normal((B, 2, T))
         + 1j * r.standard_normal((B, 2, T))).astype(np.complex64)
    x = (r.standard_normal((B, 2, T))
         + 1j * r.standard_normal((B, 2, T))).astype(np.complex64)
    res = jesn.init_reservoir(jax.random.PRNGKey(1), 4, 4, 50, 0.9, 0.1, 0.0)
    scale = jesn.EsnScale(jnp.float32(0.5), jnp.float32(0.1),
                          jnp.float32(0.2))
    t_res = convert.reservoir({k: np.asarray(v)
                               for k, v in res._asdict().items()})
    t_scale = convert.scale({k: np.asarray(v)
                             for k, v in scale._asdict().items()})
    return res, scale, t_res, t_scale, y, x


def test_esn_nmse_matches_jax():
    res, scale, t_res, t_scale, y, x = _esn_problem()
    delay, cp, isi = 3, 7, 8
    W = jmimo.train_mimo_esn(res, scale, jnp.asarray(y), jnp.asarray(x),
                             delay, cp, jax.random.PRNGKey(2))
    want = np.asarray(jmimo.esn_nmse(res, scale, W, jnp.asarray(y),
                                     jnp.asarray(x), delay, cp, isi,
                                     jax.random.PRNGKey(3)))
    got = tmimo.esn_nmse(t_res, t_scale, convert.readout(np.asarray(W)),
                         torch.as_tensor(y), torch.as_tensor(x), delay, cp,
                         isi).numpy()
    assert got.shape == want.shape == (3,)
    assert _rel(got, want) <= 1e-5


def test_select_delay_by_nmse_matches_jax():
    res, scale, t_res, t_scale, y, x = _esn_problem()
    best_j, table_j = jmimo.select_delay_by_nmse(
        res, scale, jnp.asarray(y), jnp.asarray(x), 0, 4, 7, 8,
        jax.random.PRNGKey(2))
    best_t, table_t = tmimo.select_delay_by_nmse(
        t_res, t_scale, torch.as_tensor(y), torch.as_tensor(x), 0, 4, 7, 8,
        rng.prng_key(2))
    assert best_t.dtype == torch.int32 and table_t.shape == (3, 5)
    np.testing.assert_array_equal(best_t.numpy(), np.asarray(best_j))
    assert _rel(table_t.numpy(), table_j) <= 1e-4


def _zoo_cfg(mod):
    return mod.SimConfig(
        name="zoo_tiny",
        ofdm=mod.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                            doppler_hz=3000.0),
        channel=mod.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=mod.EsnConfig(n_reservoir=50, train_ebno_fixed_db=None,
                          noise=0.0),
        ldpc=mod.LdpcConfig(enabled=False), ebno_db=(15.0,))


def test_pilot_and_data_waveforms_match_jax():
    cfg_j, cfg_t = _zoo_cfg(jc), _zoo_cfg(tc)
    keys = jblock_keys(jax.random.PRNGKey(0), 0,
                       jnp.arange(2, dtype=jnp.uint32))
    tkeys = rng.as_keys(np.asarray(keys))
    D = cfg_t.data_symbols_per_block
    st_j, pilot_j = jcommon.synth_block(cfg_j, jnp.float32(15.0), keys,
                                        return_pilot=True)
    bits_j, _ = jcommon.data_bits_for_blocks(cfg_j, keys, D, None)
    _, data_j = jcommon.detect_data_symbols(
        cfg_j, st_j, jnp.float32(15.0), keys, bits_j, detectors=("mmse",),
        return_td=True)
    st_t, pilot_t = tcommon.synth_block(cfg_t, 15.0, tkeys,
                                        return_pilot=True)
    bits_t, _ = tcommon.data_bits_for_blocks(cfg_t, tkeys, D, None)
    _, data_t = tcommon.detect_data_symbols(
        cfg_t, st_t, 15.0, tkeys, bits_t, detectors=("mmse",),
        return_td=True)
    T = cfg_t.ofdm.n_subcarriers + cfg_t.ofdm.cp_len
    shapes = [(2, 2, T), (2, 2, T), (2, D, 2, T), (2, D, 2, T)]
    for got, want, shape in zip((*pilot_t, *data_t), (*pilot_j, *data_j),
                                shapes):
        assert tuple(got.shape) == shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(want)).max())
    # without the switches both return what they returned before
    assert isinstance(tcommon.synth_block(cfg_t, 15.0, tkeys),
                      tcommon.BlockState)


B, T_IN, C = 3, 42, 4
MODELS = {   # name: (port init, JAX init, apply name, lr, windowed input)
    "cnn": (lambda k: tzoo.cnn_init(k, C, C, channels=(32, 32)),
            lambda k: jzoo.cnn_init(k, C, C, channels=(32, 32)),
            "cnn_apply", 3e-3, False),
    "rnn": (lambda k: tzoo.rnn_init(k, C, 32, C),
            lambda k: jzoo.rnn_init(k, C, 32, C), "rnn_apply", 1e-2, False),
    "fnn": (lambda k: tzoo.mlp_init(k, (8 * C, 64, C)),
            lambda k: jzoo.mlp_init(k, (8 * C, 64, C)), "mlp_apply", 3e-3,
            True),
}


# the FNN's tanh layer: see the module docstring
JAX_RTOL = {"cnn": 1e-5, "rnn": 1e-5, "fnn": 2e-5}


def _block_data():
    r = np.random.default_rng(11)
    X = r.standard_normal((B, T_IN, C)).astype(np.float32)
    Y = (0.3 * r.standard_normal((B, T_IN, C))).astype(np.float32)
    return X, Y


@pytest.mark.parametrize("name", list(MODELS))
def test_per_block_training_equals_separate_runs(name):
    init, _, apply_name, lr, windowed = MODELS[name]
    apply_fn = getattr(tzoo, apply_name)
    X, Y = (torch.as_tensor(a)[:, None] for a in _block_data())
    if windowed:
        X = tzoo.window_flatten(X, 8)
    models = [init(k) for k in rng.split(rng.prng_key(7), B).unbind(0)]
    batched = tzoo.train_regressor_per_block(apply_fn, models, X, Y,
                                             epochs=50, lr=lr)
    assert batched.losses.shape == (B, 50)
    for b, m in enumerate(models):
        one = tzoo.train_regressor(apply_fn, m, X[b], Y[b], epochs=50, lr=lr)
        np.testing.assert_allclose(batched.losses[b].numpy(),
                                   one.losses.numpy(), rtol=0, atol=1e-6)
        for k, v in one.params.named_parameters():
            np.testing.assert_allclose(
                batched.params.params[f"p.{k}"][b].detach().numpy(),
                v.detach().numpy(), rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_per_block_losses_match_jax_vmapped(name):
    _, jinit, apply_name, lr, windowed = MODELS[name]
    X, Y = _block_data()
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    params = jax.vmap(jinit)(keys)
    jX = jnp.asarray(X)
    if windowed:
        jX = jzoo.window_flatten(jX, 8)
    japply = getattr(jzoo, apply_name)
    want = np.asarray(jax.vmap(
        lambda p, x, y: jzoo.train_regressor(japply, p, x[None], y[None],
                                             epochs=10, lr=lr).losses)(
        params, jX, jnp.asarray(Y)))
    models = convert.regressors_per_block(
        name, jax.tree.map(np.array, params))

    def train(ms, dtype):
        x, y = (torch.as_tensor(np.array(a)).to(dtype)[:, None]
                for a in (jX, Y))
        if name == "rnn":
            return tzoo.train_rnn_per_block(ms, x, y, epochs=10, lr=lr)
        return tzoo.train_regressor_per_block(getattr(tzoo, apply_name), ms,
                                              x, y, epochs=10, lr=lr)
    got = train(models, torch.float32).losses.numpy()
    assert got.shape == want.shape == (B, 10)
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL[name], atol=0)
    exact = train([m.double() for m in models], torch.float64).losses.numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=0)


def test_rnn_per_block_through_nn_gru_equals_plain_loop():
    X, Y = (torch.as_tensor(a)[:, None] for a in _block_data())
    models = [MODELS["rnn"][0](k)
              for k in rng.split(rng.prng_key(7), B).unbind(0)]
    plain = tzoo.train_regressor_per_block(tzoo.rnn_apply, models, X, Y,
                                           epochs=50, lr=1e-2)
    gru = tzoo.train_rnn_per_block(models, X, Y, epochs=50, lr=1e-2)
    np.testing.assert_allclose(gru.losses.numpy(), plain.losses.numpy(),
                               rtol=1e-6, atol=0)
    # the trained torch.nn.GRUs hold rnn_apply's weights (wi = weight_ih^T,
    # wh = weight_hh^T, bi = bias_ih, bias_hh zero) and predict as it does
    grus = gru.params
    got = {"p.wi": [g.gru.weight_ih_l0.T for g in grus],
           "p.wh": [g.gru.weight_hh_l0.T for g in grus],
           "p.bi": [g.gru.bias_ih_l0 for g in grus]}
    for k, _ in grus[0].head.named_parameters():
        got[f"p.head.{k}"] = [g.head.get_parameter(k) for g in grus]
    assert got.keys() == plain.params.params.keys()
    for k, v in plain.params.params.items():
        np.testing.assert_allclose(
            torch.stack(got[k]).detach().numpy(), v.detach().numpy(),
            rtol=0, atol=1e-5, err_msg=k)
    assert all(not g.gru.bias_hh_l0.any() for g in grus)
    x_new = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (B, 3) + tuple(X.shape[2:])).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(
            grus(x_new).numpy(),
            tzoo.apply_per_block(plain.params, x_new).numpy(),
            rtol=0, atol=1e-5)
