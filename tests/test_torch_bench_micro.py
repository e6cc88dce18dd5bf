"""The ablation builds of the ESN predict recurrence (K5): the port's plain
version, `models/esn.esn_predict_ablate`, against the TPU kernel factory
`tools/bench_micro.py:_mk_kernel` run in interpret mode on the same numpy
operands (a small shape: 128 lanes, T = 6, n_res = 24; state noise off,
since the TPU generator has no interpret mode), and the micro-benchmark tool
`tools/bench_micro_torch.py` on the CPU.

Tolerances: builds without the recurrence product are float32 on both
sides: 1e-5. Builds with it go through the TPU kernel's bfloat16 `W s`
product while the port keeps float32: 2e-2 absolute on outputs of order 1
(bfloat16 keeps 8 bits of mantissa, and the error feeds back through the
state for T steps); the port's product against the same one in float64 is
held to 1e-5 separately.
"""
import importlib
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import esn_ofdm_mimo_tpu  # noqa: F401
from esn_ofdm_mimo_tpu_torch.models import esn_cuda
from esn_ofdm_mimo_tpu_torch.models.esn import (ABLATE_PARTS, EsnReservoir,
                                                EsnScale, esn_predict,
                                                esn_predict_ablate)

# The suite runs in several worker processes at once. One intra-op thread
# per process keeps torch's many small CPU ops (the int64 RNG) from
# oversubscribing the cores, which slows such tests a hundredfold.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, N_P, N_IN_P, N_OUT_P, LANES = 6, 24, 8, 8, 128


@pytest.fixture(scope="module")
def bm():
    """tools/bench_micro.py with its module-level T set to the test's.
    _BENCH_REEXEC=1 tells the tool it has already re-executed itself, which
    it would otherwise do at import where a TPU pool is configured."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    had = os.environ.get("_BENCH_REEXEC")
    os.environ["_BENCH_REEXEC"] = "1"
    try:
        mod = importlib.import_module("bench_micro")
    finally:
        sys.path.pop(0)
        if had is None:
            del os.environ["_BENCH_REEXEC"]
    old = mod.T
    mod.T = T
    yield mod
    mod.T = old


def _operands():
    r = np.random.default_rng(5)
    f32 = lambda a: a.astype(np.float32)                     # noqa: E731
    return dict(
        u=f32(r.standard_normal((T, N_IN_P, LANES))),
        W=f32(0.2 * r.standard_normal((N_P, N_P))),
        Win=f32(0.3 * r.standard_normal((N_P, N_IN_P))),
        Wfb=f32(0.3 * r.standard_normal((N_P, N_OUT_P))),
        wofs=f32(0.2 * r.standard_normal((N_P, N_OUT_P, LANES))),
        wofu=f32(0.2 * r.standard_normal((N_IN_P, N_OUT_P, LANES))))


def _tpu_kernel(bm, op, **sw):
    """out (T, n_out, lanes) of _mk_kernel(...) in interpret mode, wired as
    run_pred_variants wires its non-merged, non-hoisted call."""
    kern = bm._mk_kernel(sw["readout"], sw["feedback"], False, False, N_P,
                         N_IN_P, N_OUT_P, tanh=sw["tanh"],
                         bigdot=sw["recurrence_dot"])
    full = lambda *shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))  # noqa: E731
    lane = lambda *shape: pl.BlockSpec(                      # noqa: E731
        shape + (bm.BC,), lambda i: (0,) * len(shape) + (i,))
    assert bm.BC == LANES
    call = pl.pallas_call(
        kern, grid=(1,), interpret=True,
        in_specs=[lane(T, N_IN_P), full(N_P, N_P), full(N_P, N_IN_P),
                  full(N_P, N_OUT_P), lane(N_P, N_OUT_P),
                  lane(N_IN_P, N_OUT_P), full(1, 1), full(1, 1)],
        out_specs=lane(T, N_OUT_P),
        out_shape=jax.ShapeDtypeStruct((T, N_OUT_P, LANES), jnp.float32))
    out = call(jnp.asarray(op["u"]), jnp.asarray(op["W"]).astype(jnp.bfloat16),
               jnp.asarray(op["Win"]), jnp.asarray(op["Wfb"]),
               jnp.asarray(op["wofs"]), jnp.asarray(op["wofu"]),
               jnp.zeros((1, 1), jnp.int32), jnp.zeros((1, 1), jnp.float32))
    return np.asarray(out)


def _port_operands(op, dtype=torch.float32):
    """The same operands in the port's layout: transposed weights, one
    readout per row (G == B), rows = lanes."""
    t = lambda a: torch.tensor(a, dtype=dtype)               # noqa: E731
    res = EsnReservoir(Wt=t(op["W"].T.copy()), W_in_t=t(op["Win"].T.copy()),
                       W_fb_t=t(op["Wfb"].T.copy()), noise=0.0)
    Wt_out = torch.cat([t(op["wofs"]), t(op["wofu"])]).permute(2, 0, 1)
    inputs = t(op["u"]).permute(2, 0, 1)
    return res, EsnScale(1.0, 0.0, 1.0), Wt_out.contiguous(), \
        inputs.contiguous()


def _switches(off):
    return {p: p not in off for p in ABLATE_PARTS if p != "noise"}


_F32_BUILDS = [("floor", frozenset(ABLATE_PARTS)),
               ("no recurrence_dot", frozenset(("recurrence_dot",)))]
_BF16_BUILDS = [("full", frozenset())] + [
    (f"no {p}", frozenset((p,))) for p in ("readout", "feedback", "tanh")]


@pytest.mark.parametrize("off", [b[1] for b in _F32_BUILDS + _BF16_BUILDS],
                         ids=[b[0] for b in _F32_BUILDS + _BF16_BUILDS])
def test_plain_ablation_vs_tpu_kernel_interpret(bm, off):
    op = _operands()
    sw = _switches(off)
    want = _tpu_kernel(bm, op, **sw)
    res, scale, Wt_out, inputs = _port_operands(op)
    got = esn_predict_ablate(res, scale, Wt_out, inputs, 0, None, noise=False,
                             **sw).permute(1, 2, 0).numpy()
    assert got.shape == want.shape == (T, N_OUT_P, LANES)
    assert np.abs(want).max() > 0.1
    atol = 1e-5 if "recurrence_dot" in off else 2e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the float32 arithmetic itself, against float64
    r64, s64, w64, i64 = _port_operands(op, torch.float64)
    ref = esn_predict_ablate(r64, s64, w64, i64, 0, None, noise=False,
                             **sw).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_full_build_is_esn_predict_and_noise_switch():
    res, scale, Wt_out, inputs = _port_operands(_operands())
    noisy = res._replace(noise=1e-3)
    g = lambda: torch.Generator().manual_seed(3)             # noqa: E731
    a = esn_predict(noisy, scale, Wt_out, inputs, 2, g())
    b = esn_predict_ablate(noisy, scale, Wt_out, inputs, 2, g())
    assert torch.equal(a, b)
    clean = esn_predict(res, scale, Wt_out, inputs, 2)
    off = esn_predict_ablate(noisy, scale, Wt_out, inputs, 2, g(),
                             noise=False)
    assert torch.equal(off, clean)
    assert 0 < float((a - clean).abs().max()) < 0.05
    # grouped readouts pass through as in esn_predict
    Wg = Wt_out[::4].contiguous()
    assert torch.equal(esn_predict_ablate(res, scale, Wg, inputs, 0),
                       esn_predict(res, scale, Wg, inputs, 0))


def test_ablate_wrapper_on_cpu_runs_the_plain_version():
    res, scale, Wt_out, inputs = _port_operands(_operands())
    before = esn_cuda.launches_ablate
    for off in esn_cuda.ABLATE_BUILDS:
        sw = {p: p not in off for p in ABLATE_PARTS}
        got = esn_cuda.esn_predict_ablate_cuda(res, scale, Wt_out, inputs, 0,
                                               7, **sw)
        want = esn_predict_ablate(res, scale, Wt_out, inputs, 0,
                                  torch.Generator().manual_seed(7), **sw)
        assert torch.equal(got, want), sorted(off)
    assert esn_cuda.launches_ablate == before
    assert len(esn_cuda.ABLATE_BUILDS) == 7
    # the mask bits follow the order of the kernel's enum Off
    assert esn_cuda._OFF_BIT == {"readout": 1, "feedback": 2, "noise": 4,
                                 "tanh": 8, "recurrence_dot": 16}
    core = open(os.path.join(ROOT, "esn_ofdm_mimo_tpu_torch", "csrc",
                             "esn_predict_core.cuh")).read()
    for line in ("kNoReadout = 1,", "kNoFeedback = 2,", "kNoNoise = 4,",
                 "kNoTanh = 8,", "kNoRecDot = 16,"):
        assert line in core


def test_bench_micro_torch_tool_on_cpu(capsys):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        tool = importlib.import_module("bench_micro_torch")
    finally:
        sys.path.pop(0)
    # the JAX tool's shapes and variant names
    import ast
    src = open(os.path.join(ROOT, "tools", "bench_micro.py")).read()
    names = [n.value for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and n.value.startswith("pred ")]
    assert [n for n, _ in tool.PRED_VARIANTS] == names
    assert (tool.D, tool.T, tool.N_RES, tool.N_IN, tool.N_OUT) == (
        74, 138, 300, 16, 8)
    tool.main(["pred", "eq", "base", "bits", "--device", "cpu", "--blocks",
               "1"])
    out = capsys.readouterr().out
    assert "not a device time" in out
    for name in names + ["pred no tanh", "taps draw", "eq apply (einsum)",
                         "awgn draw (D,8,135)"]:
        line = next(x for x in out.splitlines() if x.startswith(name))
        assert line.endswith("ms/round") and float(line.split()[-2]) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["pred"])
