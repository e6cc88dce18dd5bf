"""K7, the zoo's GRU kernel (csrc/gru_train.cu), and the captured zoo round
on the card.

Run on a machine with an NVIDIA card:

    python -m pytest tests/test_torch_gru_cuda.py -m card --noconftest

(`--noconftest` where JAX, which tests/conftest.py imports, is not
installed). Without a card every test skips. Cases: a training launch's
outputs, losses and weight gradients and a prediction launch's outputs
against the plain version (ops/gru_cuda.py: `train_plain`,
`rnn_apply_blocks`) within 1e-5 relative to the largest of each (the same
fp32 products summed in another order and contracted into multiply-adds)
at 1, 3 and 128 blocks and 1, 33 and 522 steps, a step count off the
kernel's 32-step tile; an input the kernel does not take raising with no
launch; and the zoo round of a tiny configuration captured by
`make_zoo_step`: replays launch nothing from Python and equal eager
`run_zoo_blocks` on the card, and a replay's captured marks time the
esn_fit, detect, cnn, rnn, fnn and elm phases.
"""
import pytest
import torch

from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.models import esn_cuda, esn_states_cuda, zoo
from esn_ofdm_mimo_tpu_torch.ops import gru_cuda
from esn_ofdm_mimo_tpu_torch.parallel import make_zoo_step
from esn_ofdm_mimo_tpu_torch.pipelines import graphs, zoo2x2
from esn_ofdm_mimo_tpu_torch.utils import rng


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _case(dev, B, T, S=2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = zoo.gru_weights(zoo.rnn_init(rng.split(rng.prng_key(seed, dev), B),
                                     4, 32, 4))
    x = torch.randn(B, S, T, 4, generator=g, device=dev)
    y = 0.3 * torch.randn(B, T, 4, generator=g, device=dev)
    return w, x, y


def _close(a, b, rel=1e-5):
    """Within `rel` of the largest |b| (exactly equal where b is all zero:
    at T = 1 the recurrent weights' gradient is 0)."""
    return float((a - b).abs().max()) <= rel * float(b.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("B,T", [(1, 1), (3, 33), (128, 522)])
def test_train_and_predict_against_plain(card, B, T):
    w, x, y = _case(card, B, T, seed=B + T)
    n0 = gru_cuda.launches
    pred, loss, grads = gru_cuda.train(x[:, 0], y, w)
    q = gru_cuda.predict(x, w)
    assert gru_cuda.launches - n0 == 2
    want = gru_cuda.train_plain(x[:, 0], y, w)
    with torch.no_grad():
        want_q = gru_cuda.rnn_apply_blocks(w, x)
    for got, ref in zip((pred, loss, *grads, q),
                        (want[0], want[1], *want[2], want_q)):
        assert got.shape == ref.shape and _close(got, ref)


@pytest.mark.card
def test_refused_input_raises(card):
    w, x, y = _case(card, 2, 9)
    wide = zoo.gru_weights(zoo.rnn_init(rng.split(rng.prng_key(1, card), 2),
                                        4, 16, 4))
    n0 = gru_cuda.launches
    with pytest.raises(ValueError, match="hidden 32"):
        gru_cuda.train(x[:, 0], y, wide)
    with pytest.raises(ValueError, match="float32"):
        gru_cuda.predict(x.double(), w)
    assert gru_cuda.launches == n0


@pytest.mark.card
def test_zoo_round_replayed(card):
    cfg = tc.SimConfig(
        name="zoo_tiny",
        ofdm=tc.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                           doppler_hz=3000.0),
        channel=tc.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=tc.EsnConfig(n_reservoir=40, train_ebno_fixed_db=None),
        ldpc=tc.LdpcConfig(enabled=False))
    keys = [rng.block_keys(rng.prng_key(7, card), 4,
                           torch.arange(4 * i, 4 * i + 4, device=card))
            for i in range(3)]
    step = make_zoo_step(cfg, card, epochs=5)
    zoo2x2.host_zoo(step(12.0, keys[0]))              # captures the round

    def counts():
        return (gru_cuda.launches, esn_cuda.launches,
                esn_states_cuda.launches, rng.launches)
    n0 = counts()
    got = [zoo2x2.host_zoo(step(12.0, k)) for k in keys[1:]]
    assert counts() == n0
    timings = {}
    assert zoo2x2.host_zoo(step(12.0, keys[2], timings)) == got[1]
    assert list(timings) == ["esn_fit", "detect", "cnn", "rnn", "fnn", "elm"]
    assert zoo2x2.run_zoo_blocks(cfg, 12.0, keys[2], epochs=5,
                                 device=card) == got[1]
    assert graphs.body_stats()["zoo.round"]["captures"] == 1
    graphs.release_graphs()
