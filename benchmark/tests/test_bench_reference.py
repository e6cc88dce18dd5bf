"""The reference's flooding BP (which drops converged codewords every 10
iterations) against the program's plain decoder (which drops them at
every iteration): the same bits, iterations and convergence, at both
configurations' codes and rules."""
import pytest
import torch

from benchmark import manifest, reference
from benchmark.reference.chain.ldpc import decode as rd
from benchmark.reference.chain.ldpc import make_code


@pytest.mark.parametrize("snr_db", [1.5, 2.0])
@pytest.mark.parametrize("cfg_name", ["mimo_4x8_cdl", "mimo_4x8_nbf"])
def test_reference_bp_equals_program_plain(cfg_name, snr_db):
    from esn_ofdm_mimo_tpu_torch.ldpc import decode as pd
    from esn_ofdm_mimo_tpu_torch.ldpc import ldpc_encode
    from esn_ofdm_mimo_tpu_torch.ldpc import make_code as program_code
    cfg = reference.sim_config(manifest.config(cfg_name)["sim"])
    lc = cfg.ldpc
    n = cfg.ofdm.n_subcarriers * cfg.ofdm.bits_per_symbol
    code, pcode = make_code(lc, n), program_code(lc, n)
    g = torch.Generator().manual_seed(int(10 * snr_db))
    u = torch.randint(0, 2, (120, code.k), generator=g, dtype=torch.int8)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * ldpc_encode(pcode, u).float()
         + sigma * torch.randn(120, n, generator=g))
    llr = 2 * y / sigma ** 2
    kw = dict(algo=lc.algo, minsum_scale=lc.minsum_scale,
              pass1_iters=lc.pass1_iters, minsum_offset=lc.minsum_offset)
    e_p, s_p = pd.ldpc_decode_bp_plain(pcode, llr, lc.max_iter,
                                       count_against=u, **kw)
    e_r, s_r = rd.ldpc_decode_bp_counts(code, llr, u, lc.max_iter, **kw)
    assert torch.equal(e_p, e_r)
    assert torch.equal(s_p["iterations"], s_r["iterations"])
    assert torch.equal(s_p["converged"], s_r["converged"])
    assert 0 < int(s_r["converged"].sum()) < 120
