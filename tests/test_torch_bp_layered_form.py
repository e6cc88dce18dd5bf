"""The layered BP kernel's min-sum form (csrc/bp_decode_layered.cu:
minsum_rule), written out in plain torch as ldpc/decode.py:minsum_form.

  * bit for bit (float32 words, the sign of zero included) against the
    plain rule `_check_update` on clipped messages, for both min-sum rules,
    on crafted checks: ties for the minimum and for the second minimum,
    -0.0 and +0.0, magnitudes at and beyond +-16, all-equal rows, offsets
    that cut a magnitude to exactly zero; and on random checks;
  * plain layered BP with that form (`_decode_layered(..., kernel_form=True)`,
    which also loads the channel LLRs as llr + 0.0, as the kernel does)
    against the JAX XLA layered decoder: exact bits, iterations and
    converged flags (the standard of tests/test_torch_ldpc.py for the plain
    rule), channel LLRs of -0.0 included;
  * the same against the Pallas layered branch in interpret mode, on that
    test's agreement band, and exactly against the plain rule's decode.
Small codes only (n = 128 and 512)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esn_ofdm_mimo_tpu.ldpc import code as jcode
from esn_ofdm_mimo_tpu.ldpc.decode import _decode_bp_qc_layered
from esn_ofdm_mimo_tpu_torch.ldpc import ldpc_encode, make_qc_ldpc
from esn_ofdm_mimo_tpu_torch.ldpc.decode import (MSG_CLIP, _check_update,
                                                 _decode_layered,
                                                 minsum_form)

# One intra-op thread per worker process (see tests/test_torch_curve.py).
torch.set_num_threads(1)

MINSUM = ("minsum", "offset-minsum")
SCALE, OFFSET = 0.75, 0.625


def _crafted() -> dict:
    """Named (rows, 8) float32 check inputs."""
    r = np.random.default_rng(11)
    f = np.float32
    ties = f(r.integers(-3, 4, (64, 8))) * f(0.625)   # offset hits 0 exactly
    zeros = np.zeros((16, 8), f)
    zeros[::2, ::3] = -0.0
    zeros[1::2, 1::2] = -0.0
    zeros[:, 7] = r.choice(f([-1.5, 1.5, -0.0, 0.0]), 16)
    clip = r.choice(f([16.0, -16.0, 16.000002, -16.000002, 17.0, -30.0,
                       15.999999, 1e30, -1e30]), (64, 8))
    equal = np.repeat(f([[3.0], [-3.0], [0.625], [16.0], [20.0], [0.0]]), 8, 1)
    equal[1, ::2] = 3.0                               # equal magnitudes
    second = np.tile(f([5.0, 2.0, 2.0, 9.0, -2.0, 7.0, 2.0, 8.0]), (4, 1))
    second[1] = [1.0, 2.0, 2.0, -2.0, 3.0, 4.0, 5.0, 6.0]
    second[2] = [-4.0, 1.0, 4.0, 4.0, -1.0, 6.0, 6.0, 4.0]
    second[3] = [0.0, -0.0, 1.0, 1.0, -0.0, 2.0, 0.0, 3.0]
    tiny = r.choice(f([1e-45, -1e-45, 1e-38, -1e-38, 0.0, -0.0]), (32, 8))
    rand = (8.0 * r.standard_normal((4096, 8))).astype(f)
    return dict(ties=ties, zeros=zeros, clip=clip, equal=equal, second=second,
                tiny=tiny, random=rand)


@pytest.mark.parametrize("algo", MINSUM)
@pytest.mark.parametrize("name", list(_crafted()))
def test_minsum_form_bit_identical_to_plain_rule(name, algo):
    q = torch.as_tensor(_crafted()[name])
    got = minsum_form(q, algo, SCALE, OFFSET)
    want = _check_update(torch.clamp(q, -MSG_CLIP, MSG_CLIP), algo, SCALE,
                         OFFSET)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        name, q[(got.view(torch.int32) != want.view(torch.int32)).any(-1)])


def test_minsum_form_refuses_other_rules_and_degrees():
    q = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="min-sum rules"):
        minsum_form(q, "sumprod", SCALE, OFFSET)
    with pytest.raises(ValueError, match="dc = 8"):
        minsum_form(torch.zeros(2, 6), "minsum", SCALE, OFFSET)


def _awgn_llrs(code, B, ebno_db, seed):
    r = np.random.default_rng(seed)
    u = r.integers(0, 2, size=(B, code.k)).astype(np.int8)
    cw = np.asarray(ldpc_encode(code, torch.as_tensor(u))).astype(np.float64)
    sigma = np.sqrt(1.0 / (2 * code.k / code.n * 10 ** (ebno_db / 10)))
    y = 1.0 - 2.0 * cw + sigma * r.standard_normal(cw.shape)
    return (2.0 * y / sigma ** 2).astype(np.float32)


def _torch_layered(code, llr, cap, algo, kernel_form):
    """Plain layered BP on pipeline-order LLRs -> (bits, iterations,
    converged) as numpy, bits in pipeline order."""
    qc = code.qc
    bits, its, conv = _decode_layered(
        code, torch.as_tensor(llr)[:, torch.as_tensor(qc.inv_perm)], cap,
        algo, SCALE, OFFSET, kernel_form=kernel_form)
    return bits[:, torch.as_tensor(qc.perm)].numpy(), its.numpy(), conv.numpy()


@pytest.mark.parametrize("algo", MINSUM)
@pytest.mark.parametrize("n", [128, 512])
def test_layered_with_kernel_form_vs_jax_layered(n, algo):
    code, cj = make_qc_ldpc(n), jcode.make_qc_ldpc(n)
    llr = _awgn_llrs(code, 160, 2.0, seed=n + 5)
    llr[:4, ::7] = -0.0                       # -0.0 channel LLRs
    llr[4:8] = np.abs(llr[4:8])               # codewords that converge at 0
    bits, its, conv = _torch_layered(code, llr, 15, algo, kernel_form=True)
    nat, st = _decode_bp_qc_layered(
        cj, jnp.asarray(llr)[:, jnp.asarray(cj.qc.inv_perm)], 15, algo,
        SCALE, True, OFFSET)
    np.testing.assert_array_equal(bits, np.asarray(nat)[:, cj.qc.perm])
    np.testing.assert_array_equal(its, np.asarray(st["iterations"]))
    np.testing.assert_array_equal(conv, np.asarray(st["converged"]))
    assert 0 < int(conv.sum()) < 160         # some converge and some do not
    assert int(its[4:8].max()) == 0


@pytest.mark.parametrize("algo", MINSUM)
def test_layered_with_kernel_form_vs_pallas_layered_interpret(algo):
    """Against the TPU kernel's layered branch, run in interpret mode the
    way tests/test_torch_ldpc.py runs it, on that test's band; and exactly
    against the decode with the plain rule."""
    from unittest import mock

    import jax
    from esn_ofdm_mimo_tpu.ldpc import decode_pallas

    code, cj = make_qc_ldpc(128), jcode.make_qc_ldpc(128)
    llr = _awgn_llrs(code, 16, 2.5, seed=23)
    with jax.disable_jit():
        orig = decode_pallas.pl.pallas_call

        def interp_call(*a, **kw):
            kw["interpret"] = True
            return orig(*a, **kw)

        with mock.patch.object(decode_pallas.pl, "pallas_call", interp_call):
            want, wst = decode_pallas.ldpc_decode_bp_pallas(
                cj, jnp.asarray(llr), 15, algo, SCALE, True,
                schedule="layered", minsum_offset=OFFSET)
    bits, its, conv = _torch_layered(code, llr, 15, algo, kernel_form=True)
    assert (bits == np.asarray(want)).mean() > 0.999
    assert (its == np.asarray(wst["iterations"])).mean() > 0.9
    assert (conv == np.asarray(wst["converged"])).mean() > 0.95
    plain = _torch_layered(code, llr, 15, algo, kernel_form=False)
    for a, b in zip((bits, its, conv), plain):
        np.testing.assert_array_equal(a, b)
