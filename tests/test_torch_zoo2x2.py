"""The port's 2x2 model-zoo comparison (pipelines/zoo2x2.py and the
compare2x2 CLI) against the JAX package's, on the CPU.

The JAX test's tiny config (tests/test_zoo2x2_sweep.py: N = 32, 16-QAM,
2x2 exponential PDP, n_res 50, no fixed-SNR ESN, uncoded) at ESN state
noise 0 (the two packages draw state noise from different streams), two
blocks at 15 dB, 3 epochs; the JAX side under jax.jit as its CLI runs it:

  * the classical detectors (zf_perfect, zf_ls, mmse) count the same bit
    errors: the channels, pilots, bits and noise are drawn bit for bit;
  * the ESN and the four trained models within 1% + 10 bit errors of
    3,584: the trained models' losses part at the 1e-5 level
    (tests/test_torch_zoo_blocks.py), the ESN's readout is the same
    Newton-Schulz solve in another summation order, and the JAX package's
    own ELM moves by 6 bits between its eager and jitted runs (measured:
    1,271 and 1,277);
  * the NMSE sums within 1e-3 relative (the ELM's 1e-2: its closed-form
    fit of 128 tanh features on a 42-row pilot is singular, so its train
    NMSE is rounding noise near 3e-11; that entry is held within 1e-6
    absolute instead);
  * main() of both packages with presets.mimo_2x2_nbf patched to that
    config at 9 and 15 dB (two blocks, 3 epochs): the same [2x2] lines
    (the same Eb/N0 labels and detectors; the classical BERs equal, the
    rest in the band above), the same pickle keys, and the port's
    events.jsonl with run_start, a snr_done per SNR with each phase's ms
    and run_done; the default device raises without CUDA.
"""
import json
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.experiments import compare2x2 as jcli
from esn_ofdm_mimo_tpu.experiments import presets as jpresets
from esn_ofdm_mimo_tpu.pipelines.zoo2x2 import run_zoo_blocks as jrun
from esn_ofdm_mimo_tpu.utils.rng import block_keys as jblock_keys
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.experiments import compare2x2 as tcli
from esn_ofdm_mimo_tpu_torch.experiments import presets as tpresets
from esn_ofdm_mimo_tpu_torch.pipelines import zoo2x2 as tzoo2x2

torch.set_num_threads(1)

CLASSICAL = ("zf_perfect", "zf_ls", "mmse")
TRAINED = ("esn", "cnn", "rnn", "fnn", "elm")


def _cfg(mod, ebno=(15.0,)):
    return mod.SimConfig(
        name="zoo_tiny",
        ofdm=mod.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                            doppler_hz=3000.0),
        channel=mod.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=mod.EsnConfig(n_reservoir=50, train_ebno_fixed_db=None,
                          noise=0.0),
        ldpc=mod.LdpcConfig(enabled=False), ebno_db=ebno)


def _in_band(got: float, want: float) -> bool:
    """Bit errors within 1% + 10 of the JAX package's."""
    return abs(got - want) <= 0.01 * want + 10


def test_run_zoo_blocks_matches_jax():
    keys = jblock_keys(jax.random.PRNGKey(0), 0,
                       jnp.arange(2, dtype=jnp.uint32))
    want = jax.jit(lambda e, k: jrun(_cfg(jc), e, k, epochs=3))(
        jnp.float32(15.0), keys)
    timings = {}
    got = tzoo2x2.run_zoo_blocks(_cfg(tc), 15.0, np.asarray(keys), epochs=3,
                                 device="cpu", timings=timings)
    assert got.total_bits == int(want.total_bits) == 3584
    assert got.n_blocks == int(want.n_blocks) == 2
    assert list(got.bit_errors) == list(want.bit_errors)
    assert set(got.bit_errors) == set(tzoo2x2.DETECTORS)
    for d in CLASSICAL:
        assert got.bit_errors[d] == int(want.bit_errors[d]), d
    for d in TRAINED:
        assert _in_band(got.bit_errors[d], int(want.bit_errors[d])), (
            d, got.bit_errors[d], int(want.bit_errors[d]))
    for table in ("train_nmse", "test_nmse"):
        g, w = getattr(got, table), getattr(want, table)
        assert list(g) == list(w) == ["cnn", "elm", "esn", "fnn", "rnn"]
        for k in g:
            w_k = float(w[k])
            if (table, k) == ("train_nmse", "elm"):
                assert abs(g[k] - w_k) <= 1e-6, (table, k, g[k], w_k)
                continue
            rtol = 1e-2 if k == "elm" else 1e-3
            assert abs(g[k] - w_k) <= rtol * abs(w_k), (table, k, g[k], w_k)
    assert list(timings) == ["synth", "detect", "cnn", "rnn", "fnn", "elm",
                             "preds", "nmse", "bits"]


def test_compare2x2_main_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jpresets, "mimo_2x2_nbf",
                        lambda fast=False: _cfg(jc, (9.0, 15.0)))
    monkeypatch.setattr(tpresets, "mimo_2x2_nbf",
                        lambda fast=False: _cfg(tc, (9.0, 15.0)))
    argv = ["--blocks", "2", "--epochs", "3"]

    def lines():
        return [x for x in capsys.readouterr().out.splitlines()
                if x.startswith("[2x2]")]
    jcli.main(argv + ["--outdir", str(tmp_path / "jax")])
    j_lines = lines()
    tcli.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    t_lines = lines()

    def parse(line):
        head, rest = line.split(": ", 1)
        return head, dict((kv.split("=")[0], float(kv.split("=")[1]))
                          for kv in rest.split())
    assert len(t_lines) == len(j_lines) == 2
    bits = 3584
    for t, j in zip(t_lines, j_lines):
        (th, tv), (jh, jv) = parse(t), parse(j)
        assert th == jh and list(tv) == list(jv) == sorted(tzoo2x2.DETECTORS)
        for d in CLASSICAL:
            assert tv[d] == jv[d], (th, d)
        for d in TRAINED:
            assert _in_band(tv[d] * bits, jv[d] * bits), (th, d, tv[d], jv[d])
    for name in ("BERvsEBNo_esn_all_ml_model.pkl", "NMSE_compare.pkl"):
        with open(tmp_path / "jax" / name, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "port" / name, "rb") as f:
            got = pickle.load(f)
        assert list(got) == list(want)
        assert got["EBN0"] == want["EBN0"] == [9.0, 15.0]
        for k in got:
            if k != "EBN0":
                assert list(got[k]) == list(want[k]), (name, k)
                assert all(len(v) == 2 for v in got[k].values())
    with open(tmp_path / "port" / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert [e["event"] for e in events] == ["run_start", "snr_done",
                                            "snr_done", "run_done"]
    assert [e["ebno_db"] for e in events[1:3]] == [9.0, 15.0]
    assert set(events[1]["ms"]) >= {"synth", "rnn", "nmse"}
    assert ((tmp_path / "port" / "ber_comparison_system_2.png").exists()
            == (tmp_path / "jax" / "ber_comparison_system_2.png").exists())


def test_compare2x2_needs_a_device_argument_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--fast", "--outdir", str(tmp_path)])
