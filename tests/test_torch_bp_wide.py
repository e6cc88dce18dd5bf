"""The BP kernels' launch plan over lifting sizes, and the plain flooding and
layered decoders at the codes above Z = 256 (n = 3,072 and 4,096: the NBF
presets at 64- and 256-QAM, `--qam-bits 6` / `8`) against the JAX decoders.

  * ldpc/decode_cuda.py:bp_plan (threads, checks a thread, shared memory,
    codewords a block) at Z = 64, 256, 384 and 512 for both schedules, the
    layered kernel's shared-memory rule (`layered_smem_bytes`), and their
    refusals by name;
  * plain flooding BP against the JAX XLA graph decoder and plain layered BP
    against the JAX XLA layered decoder, 16 AWGN codewords a code (Eb/N0
    1.0-2.6 dB): both min-sum rules exact (bits, iterations, converged
    flags), sum-product in the band of tests/test_torch_ldpc.py
    (test_plain_decoder_sumprod_band_and_public_entry);
  * the public wrapper on a CPU tensor runs the plain version at n = 4,096
    and launches nothing.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esn_ofdm_mimo_tpu.ldpc import code as jcode
from esn_ofdm_mimo_tpu.ldpc.decode import (_decode_bp_graph,
                                           _decode_bp_qc_layered)
from esn_ofdm_mimo_tpu_torch.ldpc import (decode_cuda, ldpc_decode_bp_plain,
                                          ldpc_encode, make_qc_ldpc)

# One intra-op thread per worker process (see tests/test_torch_curve.py).
torch.set_num_threads(1)

B, CAP = 16, 15
# Eb/N0 spread over the batch, so that under every rule some codewords
# converge within the cap and some do not
EBNO = np.linspace(1.0, 2.6, B)[:, None]


@pytest.mark.parametrize("Z,flood,layered", [
    (64, (256, 1, 12_288, 1), (64, 4, 11_264, 1)),      # flagship, n = 512
    (256, (512, 2, 49_152, 1), (256, 4, 45_056, 1)),    # mimo_4x8_nbf, 2048
    (384, (768, 2, 73_728, 1), (384, 4, 67_584, 1)),    # 64-QAM NBF, 3,072
    (512, (1024, 2, 98_304, 1), (512, 4, 90_112, 1)),   # 256-QAM NBF, 4,096
])
def test_bp_plan(Z, flood, layered):
    assert tuple(decode_cuda.bp_plan(Z)) == flood
    assert tuple(decode_cuda.bp_plan(Z, "layered")) == layered
    p = decode_cuda.bp_plan(Z)
    assert p.threads * p.checks_per_thread == 4 * Z      # every check once
    assert p.threads <= 1024 and p.smem_bytes <= 232_448


@pytest.mark.parametrize("Z,schedule", [(513, "flooding"), (385, "flooding"),
                                        (0, "flooding"), (513, "layered")])
def test_bp_plan_refuses_by_name(Z, schedule):
    with pytest.raises(ValueError, match=f"{schedule} BP kernel"):
        decode_cuda.bp_plan(Z, schedule)


@pytest.mark.parametrize("Z", [64, 256, 384, 512])
def test_layered_layout_rule(Z):
    """The layered kernel's shared memory: the posteriors (dc * Z floats)
    and one padded row of dv * dc messages a thread, rows 16-byte aligned
    and 144 B apart, so that the 8 threads of a float4 phase fall on 8
    distinct 16-byte bank groups; the whole within a block's 227 KB."""
    smem = decode_cuda.layered_smem_bytes(Z)
    n = 8 * Z
    assert smem == 4 * n + 4 * Z * (4 * 8 + 4) == 176 * Z
    assert decode_cuda.bp_plan(Z, "layered").smem_bytes == smem <= 232_448
    row = 4 * (4 * 8 + 4)
    assert (4 * n) % 16 == 0 and row % 16 == 0
    assert len({(t * row) % 128 // 16 for t in range(8)}) == 8
    # one thread a lifted index, one codeword a block
    plan = decode_cuda.bp_plan(Z, "layered")
    assert (plan.threads, plan.codewords) == (Z, 1)


@pytest.mark.parametrize("Z", [513, 1024, 0, -1])
def test_layered_layout_refuses_past_512(Z):
    assert decode_cuda.layered_smem_bytes(Z) == 0
    with pytest.raises(ValueError, match="layered BP kernel takes Z <= 512"):
        decode_cuda.bp_plan(Z, "layered")


def _awgn(code, seed):
    r = np.random.default_rng(seed)
    u = r.integers(0, 2, size=(B, code.k)).astype(np.int8)
    cw = np.asarray(ldpc_encode(code, torch.as_tensor(u))).astype(np.float64)
    sigma = np.sqrt(1.0 / (2 * code.k / code.n * 10 ** (EBNO / 10)))
    y = 1.0 - 2.0 * cw + sigma * r.standard_normal(cw.shape)
    return u, (2.0 * y / sigma ** 2).astype(np.float32)


def _jax(code, cj, llr, algo, schedule):
    qc = code.qc
    llr_nat = jnp.asarray(llr)[:, jnp.asarray(qc.inv_perm)]
    if schedule == "layered":
        nat, st = _decode_bp_qc_layered(cj, llr_nat, CAP, algo, 0.75, True,
                                        0.625)
    else:
        nat, st = _decode_bp_graph(jnp.asarray(qc.ck_cols_nat),
                                   jnp.asarray(qc.var_edge_nat), llr_nat,
                                   CAP, algo, 0.75, True, 0.625)
    return np.asarray(nat)[:, qc.perm], st


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("n", [3072, 4096])
def test_plain_decoders_vs_jax_above_z256(n, schedule):
    code, cj = make_qc_ldpc(n), jcode.make_qc_ldpc(n)
    assert code.qc.Z == cj.qc.Z == n // 8 > 256
    _, llr = _awgn(code, seed=n)
    for algo in ("minsum", "offset-minsum", "sumprod"):
        want, wst = _jax(code, cj, llr, algo, schedule)
        bits, st = ldpc_decode_bp_plain(code, torch.as_tensor(llr), CAP,
                                        algo, schedule=schedule)
        its, conv = st["iterations"].numpy(), st["converged"].numpy()
        if algo == "sumprod":
            assert (bits.numpy() == want).mean() > 0.999
            assert (its == np.asarray(wst["iterations"])).mean() > 0.9
            assert (conv == np.asarray(wst["converged"])).mean() > 0.95
        else:
            np.testing.assert_array_equal(bits.numpy(), want)
            np.testing.assert_array_equal(its, np.asarray(wst["iterations"]))
            np.testing.assert_array_equal(conv, np.asarray(wst["converged"]))
        # some codewords converge and some do not: both branches run
        assert 0 < int(conv.sum()) < B, (algo, int(conv.sum()))


def test_wrapper_on_cpu_runs_the_plain_version_at_n4096():
    code = make_qc_ldpc(4096)
    u, llr = _awgn(code, seed=7)
    before = (decode_cuda.launches, decode_cuda.launches_layered)
    for schedule in ("flooding", "layered"):
        err, st = decode_cuda.ldpc_decode_bp_cuda_counts(
            code, torch.as_tensor(llr), torch.as_tensor(u), CAP,
            "offset-minsum", schedule=schedule)
        bits, st_p = ldpc_decode_bp_plain(code, torch.as_tensor(llr), CAP,
                                          "offset-minsum", schedule=schedule)
        want = (bits[:, code.m:] != torch.as_tensor(u)).sum(-1)
        assert torch.equal(err.long(), want)
        assert torch.equal(st["iterations"], st_p["iterations"])
    assert (decode_cuda.launches, decode_cuda.launches_layered) == before
