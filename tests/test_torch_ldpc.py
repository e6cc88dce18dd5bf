"""The port's QC-LDPC code, encoder and plain flooding BP decoder (the
plain version of the CUDA BP kernel) against the JAX package.

The decoder is held to EXACT bits and stats against the JAX XLA decoder on
the same natural-order graph for both min-sum rules (same float operations
in the same order); sum-product gets the agreement band of
tests/test_ldpc_qc.py (tanh/atanh round differently across libraries)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esn_ofdm_mimo_tpu.ldpc import code as jcode
from esn_ofdm_mimo_tpu.ldpc import ldpc_decode_bp as jax_decode
from esn_ofdm_mimo_tpu.ldpc import ldpc_encode as jax_encode
from esn_ofdm_mimo_tpu.ldpc.decode import _decode_bp_graph
from esn_ofdm_mimo_tpu_torch.ldpc import (decode_cuda, ldpc_decode_bp,
                                          ldpc_decode_bp_counts,
                                          ldpc_decode_bp_plain, ldpc_encode,
                                          llr_from_yobs, make_qc_ldpc)
from esn_ofdm_mimo_tpu_torch.utils import convert


def code_j():
    return jcode.make_qc_ldpc(512)


def _code_fields(c):
    d = {k: getattr(c, k) for k in c._fields if k != "qc"}
    d["qc"] = dict(c.qc._asdict())
    return d


@pytest.mark.parametrize("n", [128, 512])
def test_qc_code_equals_jax(n):
    want = jcode.make_qc_ldpc(n)
    got = make_qc_ldpc(n)
    for k in ("n", "k", "m", "dv", "dc"):
        assert getattr(got, k) == getattr(want, k)
    for k in ("H", "P", "ck_cols", "var_edge"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.qc.Z == want.qc.Z
    for k in ("shifts", "perm", "inv_perm", "ck_cols_nat", "var_edge_nat"):
        a, b = getattr(got.qc, k), getattr(want.qc, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the numpy fields carried across give the same code
    conv = convert.ldpc_code(_code_fields(want))
    np.testing.assert_array_equal(conv.qc.ck_cols_nat, got.qc.ck_cols_nat)
    assert conv.k == got.k and conv.qc.Z == got.qc.Z


def test_encoder_equals_jax():
    code = make_qc_ldpc(512)
    u = np.random.default_rng(3).integers(0, 2, (2, 6, code.k)).astype(np.int8)
    got = ldpc_encode(code, torch.as_tensor(u))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_encode(code_j(),
                                                        jnp.asarray(u))))
    cw = got.numpy().reshape(-1, code.n).astype(np.int64)
    assert ((code.H.astype(np.int64) @ cw.T) % 2).sum() == 0


def _awgn_llrs(code, B, ebno_db, seed):
    r = np.random.default_rng(seed)
    u = r.integers(0, 2, size=(B, code.k)).astype(np.int8)
    cw = np.asarray(ldpc_encode(code, torch.as_tensor(u))).astype(np.float64)
    sigma = np.sqrt(1.0 / (2 * code.k / code.n * 10 ** (ebno_db / 10)))
    y = 1.0 - 2.0 * cw + sigma * r.standard_normal(cw.shape)
    return u, (2.0 * y / sigma ** 2).astype(np.float32)


@pytest.mark.parametrize("algo", ["minsum", "offset-minsum"])
@pytest.mark.parametrize("ebno", [2.0, 3.0])
def test_plain_decoder_exact_vs_jax_graph(algo, ebno):
    code = make_qc_ldpc(512)
    qc = code.qc
    _, llr = _awgn_llrs(code, 64, ebno, seed=11)
    llr_nat = jnp.asarray(llr)[:, jnp.asarray(qc.inv_perm)]
    ref_nat, ref_st = _decode_bp_graph(
        jnp.asarray(qc.ck_cols_nat), jnp.asarray(qc.var_edge_nat), llr_nat,
        25, algo, 0.75, True, 0.625)
    want = np.asarray(ref_nat)[:, qc.perm]
    bits, st = ldpc_decode_bp_plain(code, torch.as_tensor(llr), 25, algo)
    np.testing.assert_array_equal(bits.numpy(), want)
    np.testing.assert_array_equal(st["iterations"].numpy(),
                                  np.asarray(ref_st["iterations"]))
    np.testing.assert_array_equal(st["converged"].numpy(),
                                  np.asarray(ref_st["converged"]))
    # some codewords converge and some do not: both branches are exercised
    assert 0 < int(st["converged"].sum()) <= 64


def test_plain_decoder_sumprod_band_and_public_entry():
    code = make_qc_ldpc(512)
    _, llr = _awgn_llrs(code, 48, 2.5, seed=5)
    want, wst = jax_decode(code_j(), jnp.asarray(llr), 25, "sumprod",
                           return_stats=True)
    bits, st = ldpc_decode_bp(code, torch.as_tensor(llr), 25, "sumprod",
                              return_stats=True)
    assert (bits.numpy() == np.asarray(want)).mean() > 0.999
    assert (st["iterations"].numpy()
            == np.asarray(wst["iterations"])).mean() > 0.9
    assert (st["converged"].numpy()
            == np.asarray(wst["converged"])).mean() > 0.95


def test_iter_cap_counts_and_pass1_identity():
    code = make_qc_ldpc(512)
    u, llr = _awgn_llrs(code, 96, 2.0, seed=2)
    llr_t, u_t = torch.as_tensor(llr), torch.as_tensor(u)
    kw = dict(algo="offset-minsum")
    # a runtime cap equals a smaller compiled budget; above max_iter raises
    b_cap, s_cap = ldpc_decode_bp_plain(code, llr_t, 30, iter_cap=7, **kw)
    b_7, s_7 = ldpc_decode_bp_plain(code, llr_t, 7, **kw)
    assert torch.equal(b_cap, b_7)
    assert torch.equal(s_cap["iterations"], s_7["iterations"])
    assert int(s_cap["iterations"].max()) <= 7
    with pytest.raises(ValueError):
        ldpc_decode_bp_plain(code, llr_t, 5, iter_cap=6, **kw)
    # two-pass compaction is bit-identical to a single pass
    b1, s1 = ldpc_decode_bp_plain(code, llr_t, 40, **kw)
    b2, s2 = ldpc_decode_bp_plain(code, llr_t, 40, pass1_iters=6, **kw)
    assert torch.equal(b1, b2)
    assert torch.equal(s1["iterations"], s2["iterations"])
    assert torch.equal(s1["converged"], s2["converged"])
    assert 0 < int(s1["converged"].sum()) < 96
    # counts mode == comparing the decoded info bits
    before = decode_cuda.launches
    err, sc = ldpc_decode_bp_counts(code, llr_t, u_t, 40, pass1_iters=6, **kw)
    assert decode_cuda.launches == before      # CPU: the plain version ran
    want = (b1[:, code.m:] != u_t).sum(-1)
    assert err.dtype == torch.int32
    assert torch.equal(err.long(), want)
    assert torch.equal(sc["iterations"], s1["iterations"])


def test_clean_codeword_reports_zero_iterations():
    code = make_qc_ldpc(512)
    llr = torch.full((3, code.n), 8.0)           # the all-zeros codeword
    llr[2, :40] = -8.0                           # not a codeword: never clean
    bits, st = ldpc_decode_bp_plain(code, llr, 12, "offset-minsum")
    assert st["iterations"][:2].tolist() == [0, 0]
    assert st["converged"][:2].all()
    assert int(bits[:2].sum()) == 0
    assert int(st["iterations"][2]) > 0     # not clean at iteration 0


def test_llr_from_yobs():
    y = np.random.default_rng(0).standard_normal(20).astype(np.float32)
    from esn_ofdm_mimo_tpu.ldpc import llr_from_yobs as jl
    np.testing.assert_allclose(llr_from_yobs(torch.as_tensor(y)).numpy(),
                               np.asarray(jl(jnp.asarray(y))), rtol=1e-6)
