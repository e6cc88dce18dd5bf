"""The 2x2 model-zoo round as the card runs it (pipelines/zoo2x2.py:
ZooRounds, parallel/montecarlo.py:make_zoo_step), on the CPU at a tiny
size: 2x2 exponential PDP, N 32, 16-QAM, a 40-neuron reservoir, no code,
4 blocks, 5 epochs.

  * the step equals `run_zoo_blocks` on the same keys bit for bit: on the
    CPU both run the same round eagerly, the GRU through K7's plain
    version;
  * the round against the benchmark's plain reference
    (benchmark/reference/zoo.py:zoo_round) on seeded random keys at six
    Eb/N0s: every bit error within 2 of the reference's and every NMSE
    sum within 1e-5 of it, relative to max(|reference|, 1). Both sides do
    the same fp32 algebra in other orders (batched products against vmap
    and conv1d, another Adam update, autograd of other graphs); measured:
    bit errors equal, NMSE gaps <= 3.2e-7 on 15 key sets;
  * K7's plain version (ops/gru_cuda.py: `train_plain`, `rnn_apply_blocks`)
    against `rnn_apply` and autograd block by block: outputs, losses and
    every weight gradient within 1e-6 relative to the largest of each
    (another summation order of the same products), and `train` and
    `predict` take the plain version for CPU tensors.
"""
import dataclasses
import json

import pytest
import torch

from benchmark import reference
from benchmark.reference import zoo as ref_zoo
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.models import zoo
from esn_ofdm_mimo_tpu_torch.ops import gru_cuda
from esn_ofdm_mimo_tpu_torch.parallel import make_zoo_step
from esn_ofdm_mimo_tpu_torch.pipelines import graphs, zoo2x2
from esn_ofdm_mimo_tpu_torch.utils import rng

torch.set_num_threads(1)

CFG = tc.SimConfig(
    name="zoo_tiny",
    ofdm=tc.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                       doppler_hz=3000.0),
    channel=tc.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
    esn=tc.EsnConfig(n_reservoir=40, train_ebno_fixed_db=None),
    ldpc=tc.LdpcConfig(enabled=False))
B, EPOCHS = 4, 5


def _keys(seed, snr_index=4):
    return rng.block_keys(rng.prng_key(seed), snr_index, torch.arange(B))


def test_step_equals_run_zoo_blocks_bit_for_bit():
    graphs.release_graphs()
    keys = _keys(2**31 + 11)
    want = zoo2x2.run_zoo_blocks(CFG, 12.0, keys, epochs=EPOCHS,
                                 device="cpu")
    step = make_zoo_step(CFG, "cpu", epochs=EPOCHS)
    got = step(12.0, keys)
    assert all(isinstance(v, torch.Tensor) for v in got.bit_errors.values())
    assert zoo2x2.host_zoo(got) == want
    assert want.total_bits == B * 7 * 2 * 32 * 4 and want.n_blocks == B
    # a second call on other keys and another Eb/N0 reuses the round
    keys2 = _keys(5, 1)
    timings = {}
    got2 = zoo2x2.host_zoo(step(3.0, keys2, timings))
    assert got2 == zoo2x2.run_zoo_blocks(CFG, 3.0, keys2, epochs=EPOCHS,
                                         device="cpu")
    assert list(timings) == ["synth", "esn_fit", "detect", "cnn", "rnn",
                             "fnn", "elm", "preds", "nmse", "bits"]
    stats = graphs.body_stats()["zoo.round"]
    assert stats["replays"] == 1 and stats["captures"] == 0
    graphs.release_graphs()


@pytest.mark.parametrize("seed,ebno", [(1, 6.0), (2**31 + 77, 12.0),
                                       (4_000_000_007, 24.0), (9, 0.0),
                                       (3_100_000_013, 18.0),
                                       (2**32 + 5, 30.0)])
def test_round_against_the_plain_reference(seed, ebno):
    keys = _keys(seed)
    ref_cfg = reference.sim_config(json.loads(json.dumps(
        dataclasses.asdict(CFG))))
    want = ref_zoo.zoo_round(ref_cfg, ebno, keys, tf32=False, epochs=EPOCHS)
    got = ref_zoo.zoo_answer(zoo2x2.host_zoo(zoo2x2.zoo_round(
        CFG, ebno, keys, EPOCHS)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.startswith("bit_errors."):
            assert abs(got[k] - v) <= 2, (k, got[k], v)
        elif "nmse" in k:
            assert abs(got[k] - v) <= 1e-5 * max(abs(v), 1.0), (k, got[k], v)
        else:
            assert got[k] == v, k


def _gru_case(Bg=3, S=2, T=17, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = zoo.gru_weights(zoo.rnn_init(rng.split(rng.prng_key(seed), Bg),
                                     4, 32, 4))
    x = torch.randn(Bg, S, T, 4, generator=g)
    y = 0.5 * torch.randn(Bg, T, 4, generator=g)
    return w, x, y


def _models(w):
    """Block b's `rnn_init`-form tree for each block of stacked weights."""
    return [zoo.Params({"wi": w.wi[b], "wh": w.wh[b], "bi": w.bi[b],
                        "head": zoo.Dense(w.wo[b], w.bo[b])})
            for b in range(w.wi.shape[0])]


def _close(a, b, rel=1e-6):
    return float((a - b).abs().max()) <= rel * float(b.abs().max())


def test_k7_plain_form_against_rnn_apply_and_autograd():
    w, x, y = _gru_case()
    pred, loss, grads = gru_cuda.train_plain(x[:, 0], y, w)
    for b, p in enumerate(_models(w)):
        p = zoo.Params({"wi": p.wi.detach(), "wh": p.wh.detach(),
                        "bi": p.bi.detach(),
                        "head": zoo.Dense(p.head.w.detach(),
                                          p.head.b.detach())})
        out = zoo.rnn_apply(p, x[b, :1])[0]
        lb = torch.mean((out - y[b]) ** 2)
        lb.backward()
        assert _close(pred[b], out.detach()) and _close(loss[b], lb.detach())
        for got, want in zip(grads, (p.wi.grad, p.wh.grad, p.bi.grad,
                                     p.head.w.grad, p.head.b.grad)):
            assert _close(got[b], want), (got[b], want)
        with torch.no_grad():
            assert _close(gru_cuda.predict(x, w)[b], zoo.rnn_apply(p, x[b]))
    n0 = gru_cuda.launches
    for a, b in zip(gru_cuda.train(x[:, 0], y, w),
                    (pred, loss, grads)):
        assert all(torch.equal(u, v) for u, v in zip(a, b)) \
            if isinstance(a, tuple) else torch.equal(a, b)
    assert gru_cuda.launches == n0          # the CPU never counts a launch


def test_gru_blocks_training_matches_the_per_block_loop():
    """`train_gru_blocks` (the K7 route, here its plain version) against
    `train_regressor_per_block(rnn_apply, ...)`: the same losses to
    rounding over 8 Adam steps."""
    w, x, y = _gru_case(T=11, seed=3)
    X, Y = x[:, :1], y[:, None]
    got = zoo.train_gru_blocks(w, X, Y, epochs=8, lr=1e-2)
    want = zoo.train_regressor_per_block(zoo.rnn_apply, _models(w),
                                         X, Y, epochs=8, lr=1e-2)
    assert torch.allclose(got.losses, want.losses, rtol=1e-5, atol=0)
    assert torch.allclose(got.params.wh, want.params.params["p.wh"],
                          rtol=0, atol=1e-5)
