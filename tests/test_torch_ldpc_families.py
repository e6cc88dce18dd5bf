"""The Gallager and pyldpc code families of the port against the JAX
package, on the CPU.

  * make_regular_ldpc and make_pyldpc_ldpc: H, the encoder P, ck_cols and
    var_edge equal to the JAX package's arrays for n in {256, 512, 1024} and
    seeds {0, 1, 7};
  * the decoder on the unlifted graph (ldpc/decode.py:_decode_bp_graph,
    reached through ldpc_decode_bp for a code with no QC structure) against
    the JAX ldpc_decode_bp on a Gallager and a pyldpc code at two Eb/N0:
    bits, iterations and converged flags identical for min-sum and offset
    min-sum (the same float operations in the same order); sum-product in
    the band of tests/test_torch_ldpc.py (bits > 0.999, iterations > 0.9,
    converged > 0.95: tanh and atanh round differently across libraries);
    counts mode equal to comparing the decoded info bits; the graph count
    moves for these codes and never for a QC code;
  * where the JAX package's C++ oracle builds (native_available), the
    decoder against esn_ofdm_mimo_tpu/native/ldpc_ref.py:ldpc_bp_decode_ref
    (float64, unscaled min-sum or sum-product) on the band of
    tests/test_native_ldpc.py: decisions agree > 0.999.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esn_ofdm_mimo_tpu.ldpc import code as jcode
from esn_ofdm_mimo_tpu.ldpc import ldpc_decode_bp as jax_decode
from esn_ofdm_mimo_tpu.native import ldpc_ref
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.ldpc import (code as tcode, decode as tdecode,
                                          decode_cuda, ldpc_decode_bp,
                                          ldpc_decode_bp_counts, ldpc_encode,
                                          make_code, make_qc_ldpc)

torch.set_num_threads(1)

FAMILIES = {"gallager": "make_regular_ldpc", "pyldpc": "make_pyldpc_ldpc"}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_code_equals_jax(family, n, seed):
    want = getattr(jcode, FAMILIES[family])(n, 4, 8, seed)
    got = make_code(tc.LdpcConfig(family=family, seed=seed), n)
    assert got is getattr(tcode, FAMILIES[family])(n, 4, 8, seed)  # cached
    assert got.qc is None
    for k in ("n", "k", "m", "dv", "dc"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("H", "P", "ck_cols", "var_edge"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # the encoder's codewords satisfy the decode graph
    u = np.random.default_rng(seed).integers(0, 2, (3, got.k))
    cw = ldpc_encode(got, torch.as_tensor(u)).numpy().astype(np.int64)
    assert ((got.H.astype(np.int64) @ cw.T) % 2).sum() == 0


def _awgn_llrs(code, B, ebno_db, seed):
    r = np.random.default_rng(seed)
    u = r.integers(0, 2, size=(B, code.k)).astype(np.int8)
    cw = ldpc_encode(code, torch.as_tensor(u)).numpy().astype(np.float64)
    sigma = np.sqrt(1.0 / (2 * code.k / code.n * 10 ** (ebno_db / 10)))
    y = 1.0 - 2.0 * cw + sigma * r.standard_normal(cw.shape)
    return u, (2.0 * y / sigma ** 2).astype(np.float32)


@pytest.mark.parametrize("algo", ["minsum", "offset-minsum", "sumprod"])
@pytest.mark.parametrize("ebno", [2.0, 3.0])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_graph_decoder_vs_jax(family, ebno, algo):
    code = getattr(tcode, FAMILIES[family])(512, 4, 8, 0)
    u, llr = _awgn_llrs(code, 96, ebno, seed=31)
    want, wst = jax_decode(getattr(jcode, FAMILIES[family])(512, 4, 8, 0),
                           jnp.asarray(llr), 25, algo, return_stats=True)
    want = np.asarray(want)
    before = (tdecode.graph_decodes, decode_cuda.launches)
    bits, st = ldpc_decode_bp(code, torch.as_tensor(llr), 25, algo,
                              return_stats=True)
    assert bits.dtype == torch.int8
    it_w, cv_w = np.asarray(wst["iterations"]), np.asarray(wst["converged"])
    if algo == "sumprod":
        assert (bits.numpy() == want).mean() > 0.999
        assert (st["iterations"].numpy() == it_w).mean() > 0.9
        assert (st["converged"].numpy() == cv_w).mean() > 0.95
    else:
        np.testing.assert_array_equal(bits.numpy(), want)
        np.testing.assert_array_equal(st["iterations"].numpy(), it_w)
        np.testing.assert_array_equal(st["converged"].numpy(), cv_w)
    if ebno == 2.0:     # some codewords converge and some do not
        assert 0 < int(st["converged"].sum()) < 96
    # counts mode: the same decode compared in place
    err, sc = ldpc_decode_bp_counts(code, torch.as_tensor(llr),
                                    torch.as_tensor(u), 25, algo)
    assert err.dtype == torch.int32
    np.testing.assert_array_equal(err.numpy(),
                                  (bits.numpy()[:, code.m:] != u).sum(-1))
    assert torch.equal(sc["iterations"], st["iterations"])
    assert (tdecode.graph_decodes, decode_cuda.launches) == (
        before[0] + 2, before[1])


def test_graph_decoder_runtime_cap_and_refusals():
    code = tcode.make_regular_ldpc(256, 4, 8, 1)
    _, llr = _awgn_llrs(code, 40, 1.5, seed=3)
    llr_t = torch.as_tensor(llr)
    b_cap, s_cap = ldpc_decode_bp(code, llr_t, 30, "offset-minsum",
                                  return_stats=True, iter_cap=6)
    b_6, s_6 = ldpc_decode_bp(code, llr_t, 6, "offset-minsum",
                              return_stats=True)
    assert torch.equal(b_cap, b_6)
    assert torch.equal(s_cap["iterations"], s_6["iterations"])
    assert int(s_cap["iterations"].max()) == 6
    with pytest.raises(ValueError):
        ldpc_decode_bp(code, llr_t, 5, iter_cap=6)
    with pytest.raises(ValueError, match="requires a QC code"):
        ldpc_decode_bp(code, llr_t, 5, schedule="layered")
    with pytest.raises(ValueError, match="unknown BP check rule"):
        ldpc_decode_bp(code, llr_t, 5, "bitflip")


def test_qc_codes_never_take_the_graph_decoder():
    code = make_qc_ldpc(256)
    _, llr = _awgn_llrs(code, 8, 2.5, seed=4)
    before = tdecode.graph_decodes
    ldpc_decode_bp(code, torch.as_tensor(llr), 10, "offset-minsum")
    ldpc_decode_bp_counts(code, torch.as_tensor(llr),
                          torch.zeros(8, code.k, dtype=torch.int8), 10)
    assert tdecode.graph_decodes == before


@pytest.mark.skipif(not ldpc_ref.native_available(),
                    reason="the C++ oracle needs g++")
@pytest.mark.parametrize("algo", ["sumprod", "minsum"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_graph_decoder_vs_cpp_oracle(family, algo):
    code = getattr(tcode, FAMILIES[family])(512, 4, 8, 0)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, size=(16, code.k))
    cw = ldpc_encode(code, torch.as_tensor(u)).numpy().astype(np.float64)
    # moderate-noise LLRs: some codewords need several BP iterations
    llr = (1 - 2 * cw) * 4.0 + 2.0 * rng.standard_normal(cw.shape)
    got = ldpc_decode_bp(code, torch.as_tensor(llr, dtype=torch.float32), 50,
                         algo, minsum_scale=1.0).numpy()
    want = ldpc_ref.ldpc_bp_decode_ref(code, llr, max_iter=50,
                                       min_sum=algo == "minsum")
    assert np.mean(got == want) > 0.999
