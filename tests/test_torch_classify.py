"""The port's classification pipeline and classify CLI
(pipelines/classification.py, experiments/classify.py) against the JAX
package's, on the CPU:

  * split_dataset: the same 80/20 split (the permutation is bit-exact);
  * train_and_evaluate_zoo on identical data (the JAX sm1 dataset at batch
    1, 10 dB: 4,915 train / 1,229 test symbols, narrow widths, 10 epochs):
    the traditional demapper's SER and BER equal, every other model's SER
    within SER_BAND of JAX's (measured: equal, the ELM within one symbol),
    the parameter counts equal;
  * the sm2 frontend's dataset (make_equalized_dataset on a tiny CDL
    configuration, 2 blocks): labels identical, features within
    FEATURE_ATOL;
  * the CLI at --fast --epochs 3 --batch 2 --device cpu against the JAX
    CLI at the same flags: the same artifact files, the same pickle keys
    and meta, the same SNRs, models and parameter counts, the
    traditional demapper's SER equal and every SER within SER_BAND
    (measured: equal but for the ELM at 0 dB, one symbol of 1,229); the
    sm2 frontend's CLI writes the same artifact set;
  * the CLI's default device is cuda, which raises without a GPU.
"""
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.experiments import classify as jcli
from esn_ofdm_mimo_tpu.pipelines import classification as jpc
from esn_ofdm_mimo_tpu.utils.rng import block_keys as jblock_keys
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.experiments import classify as tcli
from esn_ofdm_mimo_tpu_torch.pipelines import classification as tpc
from esn_ofdm_mimo_tpu_torch.utils import rng

torch.set_num_threads(1)

SER_BAND = 0.005
FEATURE_ATOL = 1e-4
ARTIFACTS = {"ser_vs_snr.pkl", "ber_vs_snr.pkl", "model_results.pkl",
             "events.jsonl"}


def _tk(k):
    return rng.as_keys(np.asarray(k))


@pytest.fixture(scope="module")
def sm1_data():
    ds = jax.jit(lambda e, k: jpc.make_equalized_dataset_sm1(e, k, batch=1))(
        jnp.float32(10.0), jax.random.PRNGKey(3))
    return np.array(ds.x), np.array(ds.labels)


def test_split_equal(sm1_data):
    x, y = sm1_data
    k = jax.random.PRNGKey(77)
    jtr, jte = jpc.split_dataset(jpc.SymbolDataset(jnp.asarray(x),
                                                   jnp.asarray(y)), k)
    ttr, tte = tpc.split_dataset(tpc.SymbolDataset(torch.as_tensor(x),
                                                   torch.as_tensor(y)), _tk(k))
    for a, b in ((ttr, jtr), (tte, jte)):
        np.testing.assert_array_equal(a.x.numpy(), np.asarray(b.x))
        np.testing.assert_array_equal(a.labels.numpy(), np.asarray(b.labels))
    assert len(ttr.labels) == int(len(y) * 0.8)


def test_zoo_on_identical_data(sm1_data):
    x, y = sm1_data
    n = int(len(y) * 0.8)
    cfg_j = jc.SimConfig(ofdm=jc.OfdmConfig(bits_per_symbol=4))
    cfg_t = tc.SimConfig(ofdm=tc.OfdmConfig(bits_per_symbol=4))
    key = jax.random.PRNGKey(88)
    want = jpc.train_and_evaluate_zoo(
        cfg_j, jpc.SymbolDataset(jnp.asarray(x[:n]), jnp.asarray(y[:n])),
        jpc.SymbolDataset(jnp.asarray(x[n:]), jnp.asarray(y[n:])), key,
        epochs=10, gray=True, variant="narrow")
    timings = {}
    got = tpc.train_and_evaluate_zoo(
        cfg_t, tpc.SymbolDataset(torch.as_tensor(x[:n]),
                                 torch.as_tensor(y[:n])),
        tpc.SymbolDataset(torch.as_tensor(x[n:]), torch.as_tensor(y[n:])),
        _tk(key), epochs=10, gray=True, variant="narrow", timings=timings)
    assert set(got) == set(want) == {"traditional", "esn", "deep_esn",
                                     "fnn", "cnn", "rnn", "elm"}
    assert set(timings) == set(got)
    assert got["traditional"] == {k: float(v) for k, v in
                                  want["traditional"].items()}
    for m in want:
        assert abs(got[m]["ser"] - want[m]["ser"]) <= SER_BAND, m
        assert got[m].get("params") == want[m].get("params"), m


def _tiny(mod):
    return mod.SimConfig(
        name="clf_tiny",
        ofdm=mod.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                            doppler_hz=3000.0),
        channel=mod.ChannelConfig(kind="cdl_b", n_tx=2, n_rx=4),
        esn=mod.EsnConfig(n_reservoir=40, train_ebno_fixed_db=None),
        ldpc=mod.LdpcConfig(enabled=False), ebno_db=(18.0,))


def test_sm2_dataset_equal():
    keys = jblock_keys(jax.random.PRNGKey(0), 0,
                       jnp.arange(2, dtype=jnp.uint32))
    j = jax.jit(lambda e, k: jpc.make_equalized_dataset(_tiny(jc), e, k))(
        jnp.float32(18.0), keys)
    t = tpc.make_equalized_dataset(_tiny(tc), 18.0, _tk(keys))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0,
                               atol=FEATURE_ATOL)


def _load(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return pickle.load(f)


def test_cli_matches_jax_cli(tmp_path, capsys):
    argv = ["--fast", "--epochs", "3", "--batch", "2"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcli.main(argv + ["--outdir", jdir])
    tcli.main(argv + ["--outdir", tdir, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Trainable parameters" in out and "SER vs Eb/N0" in out
    assert set(os.listdir(tdir)) == set(os.listdir(jdir))
    assert ARTIFACTS <= set(os.listdir(tdir))
    for name in ("ser_vs_snr.pkl", "ber_vs_snr.pkl"):
        j, t = _load(jdir, name), _load(tdir, name)
        assert t.keys() == j.keys() and t["ebno_db"] == j["ebno_db"]
    jm, tm = _load(jdir, "model_results.pkl"), _load(tdir, "model_results.pkl")
    assert tm.keys() == jm.keys() and tm["meta"] == jm["meta"]
    assert tm["meta"]["nr_basegraph_fingerprint"] == "6e0522b9a8ebd5de"
    jr, tr = jm["results"], tm["results"]
    assert list(tr) == list(jr) == [0.0, 10.0, 20.0]
    for e in jr:
        assert tr[e].keys() == jr[e].keys()
        assert tr[e]["traditional"]["ser"] == jr[e]["traditional"]["ser"]
        for m in jr[e]:
            assert abs(tr[e][m]["ser"] - jr[e][m]["ser"]) <= SER_BAND
            assert tr[e][m].get("params") == jr[e][m].get("params")


def test_cli_sm2_writes_artifacts(tmp_path, monkeypatch):
    from esn_ofdm_mimo_tpu_torch.experiments import presets
    monkeypatch.setattr(presets, "mimo_4x8_cdl",
                        lambda fast=False: _tiny(tc))
    d = str(tmp_path / "sm2")
    tcli.main(["--fast", "--frontend", "sm2", "--blocks", "2", "--epochs",
               "2", "--variant", "narrow", "--outdir", d, "--device", "cpu"])
    assert ARTIFACTS <= set(os.listdir(d))
    res = _load(d, "model_results.pkl")
    assert res["meta"]["frontend"] == "sm2"
    assert "nr_caveat" not in res["meta"]
    assert res["results"][20.0]["traditional"]["ser"] < 0.5


def test_cli_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--fast", "--outdir", str(tmp_path)])
