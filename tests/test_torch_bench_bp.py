"""tools/bench_bp_torch.py (per-iteration cost of the BP kernels and the
flooding kernel's attribution builds) on the CPU, where it runs the plain
versions at a tiny size against the host clock; and the plain versions of
the attribution builds (ldpc/decode.py DIAG_*, through
decode_cuda.ldpc_decode_bp_diag)."""
import importlib
import os
import re
import sys

import numpy as np
import pytest
import torch

from esn_ofdm_mimo_tpu_torch.ldpc import (decode_cuda, ldpc_decode_bp_plain,
                                          make_qc_ldpc)
from esn_ofdm_mimo_tpu_torch.ldpc.decode import (DIAG_COPY_RULE, DIAG_FIXED,
                                                 DIAG_NO_SYNDROME,
                                                 DIAG_NO_VAR_UPDATE)

# One intra-op thread per worker process (see tests/test_torch_curve.py).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_bp_tool_runs_on_cpu(capsys):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        tool = importlib.import_module("bench_bp_torch")
    finally:
        sys.path.pop(0)
    before = (decode_cuda.launches, decode_cuda.launches_layered,
              decode_cuda.launches_diag)
    assert tool.main(["--device", "cpu", "--batch", "3", "--lo", "1",
                      "--hi", "2", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "an edge-iteration" in ln]
    # 2 codes x 2 schedules x (3 rules + 3 rules x 5 attribution builds)
    assert len(lines) == 2 * 2 * (3 + 3 * len(decode_cuda.DIAG_BUILDS))
    # at -3 dB nothing converges: every codeword runs the whole budget
    assert all(re.search(r"converged 0 \|", ln) for ln in lines), out
    assert out.count("[diag split") == 12
    assert out.count("layered] ms an iteration") == 6
    assert "host clock" in out
    assert (decode_cuda.launches, decode_cuda.launches_layered,
            decode_cuda.launches_diag) == before


def test_attribution_builds_plain():
    code = make_qc_ldpc(128)
    r = np.random.default_rng(4)
    llr = torch.as_tensor((4.0 + 3.0 * r.standard_normal((5, code.n)))
                          .astype(np.float32))
    llr[0] = 8.0                               # the all-zeros codeword
    cap = 6
    # the fixed build is the decode without its exit: every codeword runs
    # the cap and none reports convergence, the clean one included
    _, st = decode_cuda.ldpc_decode_bp_diag(code, llr, cap, "offset-minsum",
                                            DIAG_FIXED)
    assert st["iterations"].tolist() == [cap] * 5
    assert not st["converged"].any()
    _, st0 = ldpc_decode_bp_plain(code, llr, cap, "offset-minsum")
    assert int(st0["iterations"][0]) == 0 and bool(st0["converged"][0])
    # the syndrome switch decides nothing once the exit is off
    a, _ = decode_cuda.ldpc_decode_bp_diag(code, llr, cap, "sumprod",
                                           DIAG_FIXED)
    b, _ = decode_cuda.ldpc_decode_bp_diag(code, llr, cap, "sumprod",
                                           DIAG_FIXED | DIAG_NO_SYNDROME)
    assert torch.equal(a, b)
    # without the variable update the posteriors stay the channel LLRs
    bits, _ = decode_cuda.ldpc_decode_bp_diag(
        code, llr, cap, "minsum", DIAG_FIXED | DIAG_NO_VAR_UPDATE)
    assert torch.equal(bits, (llr < 0).to(torch.int8))
    # with the rule a copy, r = q = clip(Lt - r): the copy-rule build runs
    full = DIAG_FIXED | DIAG_COPY_RULE | DIAG_NO_SYNDROME | DIAG_NO_VAR_UPDATE
    bits, st = decode_cuda.ldpc_decode_bp_diag(code, llr, cap, "minsum",
                                               full)
    assert torch.equal(bits, (llr < 0).to(torch.int8))
    assert decode_cuda.launches_diag == 0      # CPU: the plain versions ran
    with pytest.raises(ValueError, match="no attribution build"):
        decode_cuda.ldpc_decode_bp_diag(code, llr, cap, "minsum",
                                        DIAG_COPY_RULE)


def test_layered_attribution_builds_plain():
    """The plain versions of the layered kernel's attribution builds
    (`ldpc_decode_bp_diag(..., schedule="layered")`)."""
    code = make_qc_ldpc(128)
    r = np.random.default_rng(5)
    llr = torch.as_tensor((4.0 + 3.0 * r.standard_normal((5, code.n)))
                          .astype(np.float32))
    llr[0] = 8.0                               # the all-zeros codeword
    cap = 6
    kw = dict(schedule="layered")
    # the fixed build is the decode without its exit
    _, st = decode_cuda.ldpc_decode_bp_diag(code, llr, cap, "offset-minsum",
                                            DIAG_FIXED, **kw)
    assert st["iterations"].tolist() == [cap] * 5
    assert not st["converged"].any()
    _, st0 = ldpc_decode_bp_plain(code, llr, cap, "offset-minsum",
                                  schedule="layered")
    assert int(st0["iterations"][0]) == 0 and bool(st0["converged"][0])
    # at a fixed count the syndrome decides nothing
    a, _ = decode_cuda.ldpc_decode_bp_diag(code, llr, cap, "sumprod",
                                           DIAG_FIXED, **kw)
    b, _ = decode_cuda.ldpc_decode_bp_diag(code, llr, cap, "sumprod",
                                           DIAG_FIXED | DIAG_NO_SYNDROME, **kw)
    assert torch.equal(a, b)
    # the fixed build runs the decode's sweeps: where no codeword converges
    # before the cap, its bits are the decode's
    bad = torch.as_tensor((-1.0 + 2.0 * r.standard_normal((3, code.n)))
                          .astype(np.float32))
    bits_d, st_d = ldpc_decode_bp_plain(code, bad, cap, "minsum",
                                        schedule="layered")
    assert not st_d["converged"].any()
    bits_f, _ = decode_cuda.ldpc_decode_bp_diag(code, bad, cap, "minsum",
                                                DIAG_FIXED, **kw)
    assert torch.equal(bits_f, bits_d)
    # without the posterior write the posteriors stay the channel LLRs
    bits, _ = decode_cuda.ldpc_decode_bp_diag(
        code, llr, cap, "minsum", DIAG_FIXED | DIAG_NO_VAR_UPDATE, **kw)
    assert torch.equal(bits, (llr < 0).to(torch.int8))
    full = DIAG_FIXED | DIAG_COPY_RULE | DIAG_NO_SYNDROME | DIAG_NO_VAR_UPDATE
    bits, st = decode_cuda.ldpc_decode_bp_diag(code, llr, cap, "minsum",
                                               full, **kw)
    assert torch.equal(bits, (llr < 0).to(torch.int8))
    # with the rule a copy, r = clip(q) and Lt = q + clip(q): every sign
    # stays the channel's
    bits, _ = decode_cuda.ldpc_decode_bp_diag(
        code, llr, cap, "sumprod", DIAG_FIXED | DIAG_COPY_RULE, **kw)
    assert torch.equal(bits, (llr < 0).to(torch.int8))
    assert decode_cuda.launches_diag == 0      # CPU: the plain versions ran
    with pytest.raises(ValueError, match="no attribution build"):
        decode_cuda.ldpc_decode_bp_diag(code, llr, cap, "minsum",
                                        DIAG_NO_SYNDROME, **kw)
