"""The port's analytic FLOP model (esn_ofdm_mimo_tpu_torch/utils/flops.py)
against the JAX package's (esn_ofdm_mimo_tpu/utils/flops.py) and against
the port's own code:

  * every count of algebra the port shares with the JAX package (the ESN
    harvest and predict, the Newton-Schulz readout solve, BP's edges, the
    calibrator fit, a dot, the LLRs, the encoder, the calibrated decode)
    equals the JAX count on a grid of shapes, the flagship's and NBF's
    included;
  * the counts of algebra the port runs differently (torch.fft, the direct
    FIR, the complex LU of the MMSE weights) are pinned to the port's
    formulas;
  * the matmul FLOPs that torch.utils.flop_counter measures in the port's
    plain ESN functions, readout solve and encoder equal the model's counts
    of the same calls (less the tanh, which the counter does not see);
  * `cdl_flops` raises where the JAX version raises, and the flagship's
    `cal_counters` at B = 128 is the figure the module's docstring states.
"""
import dataclasses
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from esn_ofdm_mimo_tpu.experiments import presets as jp
from esn_ofdm_mimo_tpu.utils import flops as jf
from esn_ofdm_mimo_tpu_torch.experiments import presets as tp
from esn_ofdm_mimo_tpu_torch.utils import flops as tf

torch.set_num_threads(1)

# (B, T, n_res, n_in, n_out): a tiny shape, the flagship fit / detect
# (128 blocks, 74 data symbols, T = 138), NBF's (T = 522, n_res 600)
ESN_SHAPES = [(2, 9, 40, 4, 2), (128, 138, 300, 16, 8),
              (9472, 138, 300, 16, 8), (128, 522, 600, 16, 8),
              (2304, 522, 600, 16, 8)]
# (B, R, F, n_out): dual (flagship F = 316 > R = 128, NBF 616 > 512) and
# primal (tall) readout solves
SOLVE_SHAPES = [(128, 128, 316, 8), (128, 512, 616, 8), (16, 64, 44, 4),
                (3, 20, 20, 2)]


def test_constants_equal_jax():
    assert tf.BP_FLOPS_PER_EDGE == jf.BP_FLOPS_PER_EDGE
    assert (tf.NS_ITERS, tf.NS_REFINE, tf.RAPP_FLOPS) == (
        jf.NS_ITERS, jf.NS_REFINE, jf.RAPP_FLOPS)


@pytest.mark.parametrize("shape", ESN_SHAPES)
def test_esn_counts_equal_jax(shape):
    assert tf.esn_states_flops(*shape) == jf.esn_states_flops(*shape)
    assert tf.esn_predict_flops(*shape) == jf.esn_predict_flops(*shape)
    assert tf.dot(*shape[:3]) == jf.dot(*shape[:3])


@pytest.mark.parametrize("shape", SOLVE_SHAPES)
def test_readout_solve_count_equals_jax(shape):
    assert tf.readout_lstsq_flops(*shape) == jf.readout_lstsq_flops(*shape)


@pytest.mark.parametrize("algo", sorted(jf.BP_FLOPS_PER_EDGE))
def test_bp_and_calib_counts_equal_jax(algo):
    for n_cw, n, cap in ((75776, 512, 100), (12800, 2048, 200)):
        assert tf.bp_decode_flops(n_cw, n, 4, cap, algo) == \
            jf.bp_decode_flops(n_cw, n, 4, cap, algo)
    assert tf.calib_fit_flops(4, 37888 * 4, 400) == \
        jf.calib_fit_flops(4, 37888 * 4, 400)


@pytest.mark.parametrize("rows,length", [(1, 2), (512, 128), (37888, 128),
                                         (9216, 512)])
def test_fft_count_is_the_ports(rows, length):
    # the JAX package's DFT as four real matmuls: 8 L^2 + 2 L a row
    assert jf.fft_flops(rows, length) == 8.0 * rows * length ** 2 \
        + 2.0 * rows * length
    assert tf.fft_flops(rows, length) == 5.0 * rows * length * math.log2(
        length)


@pytest.mark.parametrize("batch,n_tx,n_rx,T,isi",
                         [(1, 1, 1, 5, 1), (3, 2, 4, 40, 7),
                          (128, 4, 8, 137, 10), (9472, 4, 8, 137, 10)])
def test_fir_count_is_the_direct_loop(batch, n_tx, n_rx, T, isi):
    # ops/channel.apply_fir_channel: tap k is a complex (n_rx, n_tx) @
    # (n_tx, T - k) product, added for k >= 1 into y[..., k:]; the JAX
    # package's fir_dft_flops counts DFT matmuls the port does not run
    want = sum(batch * n_rx * (T - k) * (8.0 * n_tx + (2.0 if k else 0.0))
               for k in range(isi))
    assert tf.fir_direct_flops(batch, n_tx, n_rx, T, isi) == want
    assert not hasattr(tf, "fir_dft_flops")


def test_equalizer_count_is_the_ports():
    # the JAX count (real-embedded Gram, Cholesky, two substitutions) at
    # the flagship is 128 x 128 x (2,048 + 170.7 + 2,048) + the apply;
    # the port's: complex Gram 8 n_tx^2 n_rx, LU 8 n_tx^3 / 3, two
    # triangular solves 8 n_tx^2 n_rx, then 8 n_tx n_rx a symbol
    B, N, n_tx, n_rx, D = 128, 128, 4, 8, 74
    per = 8 * 16 * 8 + 8 * 64 / 3 + 8 * 16 * 8
    assert tf.equalizer_flops(B, N, n_tx, n_rx, D) == pytest.approx(
        B * N * per + 8.0 * B * D * N * n_tx * n_rx, rel=1e-15)
    assert jf.equalizer_flops(B, N, n_tx, n_rx, D) != \
        tf.equalizer_flops(B, N, n_tx, n_rx, D)


def _matmul_flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_counts_match_the_ports_matmuls():
    from esn_ofdm_mimo_tpu_torch.ldpc import ldpc_encode, make_code
    from esn_ofdm_mimo_tpu_torch.models.esn import (EsnScale, _readout_lstsq,
                                                    esn_predict, esn_states,
                                                    init_reservoir)
    from esn_ofdm_mimo_tpu_torch.utils import rng

    g = torch.Generator().manual_seed(0)
    B, T, n_res, n_in, n_out, G = 6, 12, 40, 4, 2, 3
    res = init_reservoir(rng.prng_key(1), n_in, n_out, n_res, noise=0.0)
    sc = EsnScale(1.0, 0.0, 1.0)
    x = torch.randn(B, T, n_in, generator=g)
    d = torch.randn(B, T, n_out, generator=g)
    W = torch.randn(G, n_res + n_in, n_out, generator=g)
    tanh_states, tanh_predict = (T - 1) * B * n_res, T * B * n_res
    assert _matmul_flops(lambda: esn_states(res, sc, x, d)) == \
        tf.esn_states_flops(B, T, n_res, n_in, n_out) - tanh_states
    # grouped readouts: the count is per row whatever G is
    assert _matmul_flops(lambda: esn_predict(res, sc, W, x, 0)) == \
        tf.esn_predict_flops(B, T, n_res, n_in, n_out) - tanh_predict
    for R, F in ((8, 20), (20, 8)):         # dual and primal
        ext = torch.randn(B, R, F, generator=g)
        tgt = torch.randn(B, R, n_out, generator=g)
        assert _matmul_flops(lambda: _readout_lstsq(ext, tgt)) == \
            tf.readout_lstsq_flops(B, R, F, n_out)
    code = make_code(tp.mimo_4x8_cdl().ldpc, 512)
    u = torch.randint(0, 2, (5, 7, code.k), generator=g)
    assert _matmul_flops(lambda: ldpc_encode(code, u)) == \
        tf.dot(35, code.k, code.n - code.k)


def test_cdl_flops_guard_matches_jax():
    cases = [(jp.mimo_4x8_nbf(), tp.mimo_4x8_nbf())]
    j, t = jp.mimo_4x8_cdl(), tp.mimo_4x8_cdl()
    cases.append(tuple(dataclasses.replace(c, calib=dataclasses.replace(
        c.calib, enabled=False)) for c in (j, t)))
    for jcfg, tcfg in cases:
        with pytest.raises(ValueError, match="calibrated CDL"):
            jf.cdl_flops(jcfg, 8)
        with pytest.raises(ValueError, match="calibrated CDL"):
            tf.cdl_flops(tcfg, 8)
    assert tf.cdl_flops(t, 8).cal_counters > 0


@pytest.mark.parametrize("B", [1, 128])
def test_cdl_flops_shared_parts_equal_jax(B):
    t, j = tf.cdl_flops(tp.mimo_4x8_cdl(), B), jf.cdl_flops(
        jp.mimo_4x8_cdl(), B)
    for f in ("llr", "encode", "decode", "calib_apply"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.cal_full == t.cal_counters + t.llr
    assert t.decode_blocks == t.cal_full + t.calib_apply + t.decode


def test_flagship_cal_counters_is_the_stated_figure():
    got = tf.cdl_flops(tp.mimo_4x8_cdl(), 128).cal_counters
    assert "318,408,976,554.7 FLOPs" in tf.__doc__
    assert round(got, 1) == 318_408_976_554.7
    # the JAX count of the same round, with its DFT matmuls
    assert round(jf.cdl_flops(jp.mimo_4x8_cdl(), 128).cal_counters / 1e9,
                 2) == 357.96
