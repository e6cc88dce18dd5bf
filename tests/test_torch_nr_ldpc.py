"""The port's 5G NR LDPC code (esn_ofdm_mimo_tpu_torch/ldpc/nr.py) against
the JAX package's, on the CPU: the host construction equal field for field
(the surrogate base graphs, their fingerprint 6e0522b9a8ebd5de, the
encoder matrix, the rate-matching selection, the lifted graph), the
codewords and the rate-recovered LLRs equal bit for bit, and the plain BP
decoder's bits and converged flags equal, for BG2 at the system-model-1
shape (k = 1,536, E = 3,072: Z = 160) and one BG1 code (k = 2,000 at rate
0.8: Z = 96)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from esn_ofdm_mimo_tpu.ldpc import nr as jnr
from esn_ofdm_mimo_tpu_torch import ldpc as tldpc
from esn_ofdm_mimo_tpu_torch.ldpc import nr as tnr
from esn_ofdm_mimo_tpu_torch.utils import convert

torch.set_num_threads(1)

CODES = [(1536, 3072), (2000, 2500)]      # BG2 (sm1), BG1


def test_tables_and_fingerprint_equal():
    assert tnr.basegraph_fingerprint() == jnr.basegraph_fingerprint() \
        == "6e0522b9a8ebd5de"
    assert tnr.LIFT_SIZES == jnr.LIFT_SIZES
    assert tnr.BG_TABLES_SOURCE == jnr.BG_TABLES_SOURCE
    assert tnr.NR_SURROGATE_CAVEAT == jnr.NR_SURROGATE_CAVEAT
    for bg in (1, 2):
        (te, td), (je, jd) = tnr._BG_TABLES[bg], jnr._BG_TABLES[bg]
        assert td == jd and sorted(te) == sorted(je)
        for ij in je:
            np.testing.assert_array_equal(te[ij], je[ij])
    for z in (2, 12, 96, 160, 384):
        assert tnr.lifting_set(z) == jnr.lifting_set(z)
    for K, R in ((200, 0.5), (1600, 0.5), (4000, 0.8), (3000, 0.2)):
        assert tnr.select_basegraph(K, R) == jnr.select_basegraph(K, R)
    # the package exports what the classify CLI imports
    assert tldpc.basegraph_fingerprint is tnr.basegraph_fingerprint
    assert tldpc.NR_SURROGATE_CAVEAT == jnr.NR_SURROGATE_CAVEAT


@pytest.mark.parametrize("k,E", CODES)
def test_make_nr_ldpc_fields_equal(k, E):
    j, t = jnr.make_nr_ldpc(k, E), tnr.make_nr_ldpc(k, E)

    def same(a, b):
        for f in jnr.NrCode._fields:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f)
            else:
                assert x == y, f

    same(j, t)
    np.testing.assert_array_equal(jnr.nr_lifted_H(j), tnr.nr_lifted_H(t))
    # the converter carries a JAX code across unchanged
    same(convert.nr_code(j._asdict()), t)


@pytest.mark.parametrize("k,E", CODES)
@pytest.mark.parametrize("qm", [None, 4])
def test_encode_equal_and_valid(k, E, qm):
    code = tnr.make_nr_ldpc(k, E)
    u = np.random.default_rng(k + (qm or 0)).integers(0, 2, (3, 2, k))
    want = np.asarray(jnr.nr_encode(jnr.make_nr_ldpc(k, E), jnp.asarray(u),
                                    interleave_qm=qm))
    got = tnr.nr_encode(code, torch.as_tensor(u), interleave_qm=qm)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    if qm is None:
        # the full codeword satisfies the lifted parity checks
        u_pad = np.pad(u.reshape(-1, k), ((0, 0), (0, code.F)))
        c = np.concatenate([u_pad, (u_pad @ code.M.T.astype(np.int64)) % 2],
                           axis=1)
        assert not ((tnr.nr_lifted_H(code).astype(np.int64)
                     @ c.T) % 2).any()


@pytest.mark.parametrize("k,E", CODES)
def test_encoder_tables_made_once(k, E):
    """The float32 encoder matrix and the selection are built once for each
    code and device; a converted code (its own arrays) gets its own tables,
    and the same codewords."""
    code = tnr.make_nr_ldpc(k, E)
    first = tnr._encoder_tables(code, torch.device("cpu"))
    again = tnr._encoder_tables(code, torch.device("cpu"))
    assert first[0] is again[0] and first[1] is again[1]
    assert first[0].dtype == torch.float32 and first[1].dtype == torch.int64
    np.testing.assert_array_equal(first[0].numpy(), code.M)
    copy = convert.nr_code({f: (np.array(v) if isinstance(v, np.ndarray)
                                else v) for f, v in code._asdict().items()})
    assert tnr._encoder_tables(copy, torch.device("cpu"))[0] is not first[0]
    u = torch.as_tensor(np.random.default_rng(3).integers(0, 2, (2, k)))
    np.testing.assert_array_equal(tnr.nr_encode(copy, u).numpy(),
                                  tnr.nr_encode(code, u).numpy())


@pytest.mark.parametrize("k,E,ebno", [(1536, 3072, 1.0), (1536, 3072, 3.0),
                                      (2000, 2500, 4.0)])
def test_derate_and_decode_equal(k, E, ebno):
    """BPSK over AWGN: the rate-recovered LLRs and the plain BP decoder's
    bits and converged flags equal the JAX decoder's (the same sum-product
    in float32; measured bit-identical)."""
    jc, tc = jnr.make_nr_ldpc(k, E), tnr.make_nr_ldpc(k, E)
    g = np.random.default_rng(7)
    u = g.integers(0, 2, (6, k))
    c = np.asarray(tnr.nr_encode(tc, torch.as_tensor(u))).astype(np.float32)
    sigma = np.sqrt(1.0 / (2 * (k / E) * 10 ** (ebno / 10)))
    y = (1 - 2 * c) + sigma * g.standard_normal(c.shape).astype(np.float32)
    llr = (2 * y / sigma ** 2).astype(np.float32)
    np.testing.assert_array_equal(
        tnr.nr_derate_llrs(tc, torch.as_tensor(llr)).numpy(),
        np.asarray(jnr.nr_derate_llrs(jc, jnp.asarray(llr))))
    ju, jok = jnr.nr_decode_bp(jc, jnp.asarray(llr), max_iter=12)
    tu, tok = tnr.nr_decode_bp(tc, torch.as_tensor(llr), max_iter=12)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    if k == 1536 and ebno >= 3.0:
        # the sm1 code at rate 1/2 corrects every word at 3 dB
        assert tok.all() and (tu.numpy() == u).all()
