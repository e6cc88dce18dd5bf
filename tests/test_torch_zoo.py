"""The port's model zoo, ELM and symbol classifiers (models/zoo.py,
models/elm.py, models/classifiers.py) against the JAX package's, on the CPU:

  * every classifier's and regressor's init at the same key: uniform draws
    (the fixed reservoirs' W_in) bit for bit, normal ones within
    NORMAL_MAX_ULP (the port's normals, tests/test_torch_rng.py), zeros
    equal;
  * every apply on the JAX weights carried across (utils/convert.py:
    classifier) within APPLY_TOL of the JAX apply;
  * the trainable parameter counts of both width variants equal exactly;
  * train_classifier: the first 20 losses of every trained classifier
    within LOSS_RTOL of optax's on the same weights and data (Adam's first
    steps are sign-like, so weights are not held after many steps), and
    within F64_RTOL of the port's own float64 run. The CNN is held to
    CNN_LOSS_RTOL against optax: 61,906 of its first dense layer's 153,600
    gradients lie below 1e-7, near Adam's eps, where the two packages'
    float32 sums part relatively (measured 1.4e-4 at step 20, 2.9e-5 at
    step 10), while the port stays within 1.5e-6 of float64; the
    JAX package's l2_keys regression mirrored (a frozen W_in untouched,
    the ESN near-perfect on four clusters); train_regressor likewise;
  * the ELM on identical data: predictions agree in at least 99.9% of the
    samples (the Newton-Schulz readout in fp32 in both; measured 100%).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu.models import classifiers as jclf
from esn_ofdm_mimo_tpu.models import elm as jelm
from esn_ofdm_mimo_tpu.models import zoo as jzoo
from esn_ofdm_mimo_tpu.pipelines import classification as jpc
from esn_ofdm_mimo_tpu_torch.models import classifiers as tclf
from esn_ofdm_mimo_tpu_torch.models import elm as telm
from esn_ofdm_mimo_tpu_torch.models import zoo as tzoo
from esn_ofdm_mimo_tpu_torch.pipelines import classification as tpc
from esn_ofdm_mimo_tpu_torch.utils import convert, rng

torch.set_num_threads(1)

NORMAL_MAX_ULP = 4
APPLY_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-4
CNN_LOSS_RTOL = 2e-4
F64_RTOL = 1e-5
WIDE = jpc.ZOO_VARIANTS["wide"]


def _tk(k):
    return rng.as_keys(np.asarray(k))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b).max(initial=0)


def _leaves(module):
    """The port tree's tensors in the JAX tree's leaf order."""
    return [v.detach().numpy() for v in module.state_dict().values()]


# name -> (JAX init, its numpy tree, port init, port apply, JAX apply, the
# port's training tree from its init)
def _jax_tree(name, key):
    if name == "esn":
        p = jclf.esn_classifier_init(key, 600, 16)
        return _np(p._asdict())
    if name == "deep_esn":
        p = jclf.deep_esn_init(key, 600, WIDE["deep_hidden"], 16)
        return _np(p._asdict())
    if name == "fnn":
        return _np(jclf.fnn_classifier_init(key, (WIDE["fnn_width"],), 16))
    if name == "cnn":
        return _np(jclf.cnn_classifier_init(key, 16, WIDE["cnn_channels"],
                                            WIDE["cnn_hidden"]))
    if name == "rnn":
        return _np(jclf.rnn_classifier_init(key, WIDE["rnn_hidden"], 16))
    return _np(jclf.elm_classifier_init(key, 600, 16)._asdict())


def _port_init(name, tkey):
    if name == "esn":
        return tclf.esn_classifier_params(tclf.esn_classifier_init(tkey))
    if name == "deep_esn":
        return tclf.deep_esn_params(tclf.deep_esn_init(
            tkey, n_hidden=WIDE["deep_hidden"]))
    if name == "fnn":
        return tclf.fnn_classifier_init(tkey, (WIDE["fnn_width"],))
    if name == "cnn":
        return tclf.cnn_classifier_init(tkey, 16, WIDE["cnn_channels"],
                                        WIDE["cnn_hidden"])
    if name == "rnn":
        return tclf.rnn_classifier_init(tkey, WIDE["rnn_hidden"])
    return telm.init_elm(tkey, 2, 600, 16)


APPLY = {"esn": (jclf.esn_classifier_apply_full, tclf.esn_classifier_apply),
         "deep_esn": (jclf.deep_esn_apply_full, tclf.deep_esn_apply),
         "fnn": (jclf.fnn_classifier_apply, tclf.fnn_classifier_apply),
         "cnn": (jclf.cnn_classifier_apply, tclf.cnn_classifier_apply),
         "rnn": (jclf.rnn_classifier_apply, tclf.rnn_classifier_apply)}
NAMES = ("esn", "deep_esn", "fnn", "cnn", "rnn", "elm")


def _flat(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("name", NAMES)
def test_classifier_init_equal(name):
    key = jax.random.PRNGKey(11)
    jt = _jax_tree(name, key)
    pt = _port_init(name, _tk(key))
    if name == "elm":
        got = {f: getattr(pt, f).numpy() for f in ("W1", "b1", "W2")}
        assert _ulp(got["W1"], jt["W1"]) <= NORMAL_MAX_ULP
        assert _ulp(got["b1"], jt["b1"]) <= NORMAL_MAX_ULP
        np.testing.assert_array_equal(got["W2"], jt["W2"])
        return
    # the converted JAX tree has the port's structure: compare leaf by leaf
    want = _leaves(convert.classifier(name, jt))
    got = _leaves(pt)
    assert len(got) == len(want) == len(_flat(jt))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _ulp(g, w) <= NORMAL_MAX_ULP
    if name in ("esn", "deep_esn"):
        # the fixed reservoir is a uniform draw: bit for bit, and a buffer
        np.testing.assert_array_equal(pt.W_in.numpy(), jt["W_in"])
        assert "W_in" not in dict(pt.named_parameters())


@pytest.mark.parametrize("name", ["esn", "deep_esn", "fnn", "cnn", "rnn"])
def test_classifier_apply_on_converted_weights(name):
    key = jax.random.PRNGKey(12)
    jt = _jax_tree(name, key)
    if name == "esn":   # a nonzero readout, so the logits are not all 0
        g = np.random.default_rng(0)
        jt["W_out"] = g.standard_normal(jt["W_out"].shape).astype(np.float32)
        jt["b_out"] = g.standard_normal(16).astype(np.float32)
    x = np.random.default_rng(1).standard_normal((257, 2)).astype(np.float32)
    japply, tapply = APPLY[name]
    jparams = jax.tree.map(jnp.asarray, jt)
    if name == "deep_esn":
        jparams = {"W_in": jparams["W_in"], "hidden": jparams["hidden"]}
    want = np.asarray(japply(jparams, jnp.asarray(x)))
    got = tapply(convert.classifier(name, jt), torch.as_tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **APPLY_TOL)


@pytest.mark.parametrize("variant", ["wide", "narrow"])
def test_parameter_counts_equal(variant):
    w = jpc.ZOO_VARIANTS[variant]
    assert tpc.ZOO_VARIANTS == jpc.ZOO_VARIANTS
    key = jax.random.PRNGKey(0)
    tk = _tk(key)
    want = {
        "esn": jpc.count_params(jclf.esn_classifier_trainable(
            jclf.esn_classifier_init(key))),
        "deep_esn": jpc.count_params(jclf.deep_esn_init(
            key, n_hidden=w["deep_hidden"]).hidden),
        "fnn": jpc.count_params(jclf.fnn_classifier_init(
            key, (w["fnn_width"],))),
        "cnn": jpc.count_params(jclf.cnn_classifier_init(
            key, 16, w["cnn_channels"], w["cnn_hidden"])),
        "rnn": jpc.count_params(jclf.rnn_classifier_init(
            key, w["rnn_hidden"])),
        "elm": jpc.count_params(jclf.elm_classifier_init(key).W2)}
    got = {
        "esn": tpc.count_params(tclf.esn_classifier_trainable(
            tclf.esn_classifier_init(tk))),
        "deep_esn": tpc.count_params(tclf.deep_esn_init(
            tk, n_hidden=w["deep_hidden"]).hidden),
        "fnn": tpc.count_params(tclf.fnn_classifier_init(
            tk, (w["fnn_width"],))),
        "cnn": tpc.count_params(tclf.cnn_classifier_init(
            tk, 16, w["cnn_channels"], w["cnn_hidden"])),
        "rnn": tpc.count_params(tclf.rnn_classifier_init(
            tk, w["rnn_hidden"])),
        "elm": tpc.count_params(telm.init_elm(tk, 2, 600, 16).W2)}
    assert got == want
    table = {"wide": (9616, 370216, 11416, 180584, 732016, 9600),
             "narrow": (9616, 78992, 624, 3456, 9488, 9600)}[variant]
    assert tuple(got[n] for n in NAMES) == table
    # the training trees count the same (W_in is a buffer)
    assert tpc.count_params(tclf.esn_classifier_params(
        tclf.esn_classifier_init(tk))) == got["esn"]


def _clusters(n, seed=3):
    g = np.random.default_rng(seed)
    labels = g.integers(0, 16, n)
    pts = np.stack(np.meshgrid([-3, -1, 1, 3], [-3, -1, 1, 3]), -1).reshape(
        16, 2) / np.sqrt(10)
    x = (pts[labels] + 0.15 * g.standard_normal((n, 2))).astype(np.float32)
    return x, labels.astype(np.int32)


# (epochs multiplier, lr, l2, l2_keys) as train_and_evaluate_zoo trains them
TRAIN = {"esn": (1e-2, 5e-5, ("W_out",)), "deep_esn": (3e-3, 5e-5,
                                                       ("hidden",)),
         "fnn": (1e-3, 0.0, None), "cnn": (1e-3, 0.0, None),
         "rnn": (1e-3, 0.0, None)}


@pytest.mark.parametrize("name", ["esn", "deep_esn", "fnn", "cnn", "rnn"])
def test_train_classifier_first_losses(name):
    x, y = _clusters(512)
    jt = _jax_tree(name, jax.random.PRNGKey(13))
    japply, tapply = APPLY[name]
    jparams = jax.tree.map(jnp.asarray, jt)
    if name == "deep_esn":
        jparams = {"W_in": jparams["W_in"], "hidden": jparams["hidden"]}
    lr, l2, keys = TRAIN[name]
    want = jzoo.train_classifier(japply, jparams, jnp.asarray(x),
                                 jnp.asarray(y), epochs=20, lr=lr, l2=l2,
                                 l2_keys=keys)
    got = tzoo.train_classifier(tapply, convert.classifier(name, jt),
                                torch.as_tensor(x), torch.as_tensor(y),
                                epochs=20, lr=lr, l2=l2, l2_keys=keys)
    np.testing.assert_allclose(
        got.losses.numpy(), np.asarray(want.losses),
        rtol=CNN_LOSS_RTOL if name == "cnn" else LOSS_RTOL)
    assert got.losses[-1] < got.losses[0]
    f64 = tzoo.train_classifier(
        tapply, convert.classifier(name, jt).double(),
        torch.as_tensor(x).double(), torch.as_tensor(y), epochs=20, lr=lr,
        l2=l2, l2_keys=keys)
    np.testing.assert_allclose(got.losses.numpy(), f64.losses.numpy(),
                               rtol=F64_RTOL)


def test_train_classifier_l2_keys_preserve_frozen_weights():
    """Mirror of tests/test_models_zoo.py's regression: with l2 > 0 the
    penalty covers only l2_keys, so the fixed reservoir W_in is left as
    drawn and the ESN separates four clusters."""
    key = jax.random.PRNGKey(0)
    tk = _tk(key)
    p = tclf.esn_classifier_init(tk, n_res=64, n_classes=4)
    centers = torch.tensor([[1, 1], [1, -1], [-1, 1], [-1, -1]],
                           dtype=torch.float32)
    labels = rng.randint(rng.fold_in(tk, 1), (2048,), 0, 4)
    x = centers[labels] + 0.1 * rng.normal(rng.fold_in(tk, 2), (2048, 2))
    out = tzoo.train_classifier(tclf.esn_classifier_apply,
                                tclf.esn_classifier_params(p), x, labels,
                                epochs=400, lr=1e-2, l2=5e-5,
                                l2_keys=("W_out",))
    np.testing.assert_array_equal(out.params.W_in.numpy(), p.W_in.numpy())
    with torch.no_grad():
        pred = tclf.esn_classifier_apply(out.params, x).argmax(-1)
    assert float((pred != labels).float().mean()) < 0.05
    # the same labels as the JAX test draws
    np.testing.assert_array_equal(labels.numpy(), np.asarray(
        jax.random.randint(jax.random.fold_in(key, 1), (2048,), 0, 4)))


def test_elm_predictions_agree():
    x, y = _clusters(4000, seed=5)
    xt, _ = _clusters(2000, seed=6)
    key = jax.random.PRNGKey(21)
    jp = jelm.elm_fit_classifier(jclf.elm_classifier_init(key),
                                 jnp.asarray(x), jnp.asarray(y), 16)
    want = np.asarray(jelm.elm_classify(jp, jnp.asarray(xt)))
    tp = telm.elm_fit_classifier(
        convert.classifier("elm", _np(jclf.elm_classifier_init(key)
                                      ._asdict())),
        torch.as_tensor(x), torch.as_tensor(y), 16)
    got = telm.elm_classify(tp, torch.as_tensor(xt)).numpy()
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("model", ["mlp", "cnn", "rnn"])
def test_regressors_init_apply_and_train(model):
    key = jax.random.PRNGKey(31)
    tk = _tk(key)
    g = np.random.default_rng(2)
    X = g.standard_normal((3, 9, 4)).astype(np.float32)
    Y = g.standard_normal((3, 9, 2)).astype(np.float32)
    if model == "mlp":
        jp, tp = jzoo.mlp_init(key, (4, 16, 2)), tzoo.mlp_init(tk, (4, 16, 2))
        japply, tapply = jzoo.mlp_apply, tzoo.mlp_apply
    elif model == "cnn":
        jp = jzoo.cnn_init(key, 4, 2, channels=(8, 6), kernel=4)
        tp = tzoo.cnn_init(tk, 4, 2, channels=(8, 6), kernel=4)
        japply, tapply = jzoo.cnn_apply, tzoo.cnn_apply
    else:
        jp, tp = jzoo.rnn_init(key, 4, 12, 2), tzoo.rnn_init(tk, 4, 12, 2)
        japply, tapply = jzoo.rnn_apply, tzoo.rnn_apply
    jl = [np.asarray(v) for v in jax.tree.leaves(jp)]
    tl = _leaves(tp)
    assert sorted(a.shape for a in jl) == sorted(a.shape for a in tl)
    np.testing.assert_allclose(
        tapply(tp, torch.as_tensor(X)).detach().numpy(),
        np.asarray(japply(jp, jnp.asarray(X))), **APPLY_TOL)
    want = jzoo.train_regressor(japply, jp, jnp.asarray(X), jnp.asarray(Y),
                                epochs=20, lr=1e-2)
    got = tzoo.train_regressor(tapply, tp, torch.as_tensor(X),
                               torch.as_tensor(Y), epochs=20, lr=1e-2)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=1e-3)


def test_window_flatten_equal():
    x = np.random.default_rng(4).standard_normal((2, 11, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tzoo.window_flatten(torch.as_tensor(x), 4).numpy(),
        np.asarray(jzoo.window_flatten(jnp.asarray(x), 4)))
