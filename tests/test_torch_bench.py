"""bench_torch.py, the port of bench.py, on the CPU (device="cpu", the
kernels' plain versions) at tiny shapes:

  * both timers' keys equal, bit for bit, the keys bench.py derives with
    the JAX package's block_keys(PRNGKey(0), ...);
  * main prints one stdout line whose keys are those of bench.py's final
    json.dumps (read from bench.py's source, not imported), and with the
    pin present vs_baseline is value / 147.85;
  * the timers' counters equal run_cdl_cal_counters_chunks' and the fused
    step's on the same keys;
  * the FLOP count's calibrator-fit samples equal what fit_calibrators
    keeps at the flagship shape, read from the fit's input shape on the
    meta device (no full-width run);
  * the baseline resolves as bench.py resolves it, pin first.

The tiny configuration is tests/test_torch_curve.py's (calibrated cdl_b
2x4 from __graft_entry__._flagship_cfg(tiny=True)), 2 chunks or rounds of 2
blocks.
"""
import ast
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401
import bench_torch
from esn_ofdm_mimo_tpu.utils.rng import block_keys as jax_block_keys
from esn_ofdm_mimo_tpu_torch.experiments.presets import mimo_4x8_cdl
from esn_ofdm_mimo_tpu_torch.parallel import (host_point,
                                              make_fused_cdl_snr_step)
from esn_ofdm_mimo_tpu_torch.pipelines import cdl
from esn_ofdm_mimo_tpu_torch.pipelines.cdl import run_cdl_cal_counters_chunks
from test_torch_curve import _cdl_cfg

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, R, RC, RD = 2, 2, 1, 1
TINY = ["--device", "cpu", "--blocks", str(B), "--rounds", str(R),
        "--cal-rounds", str(RC), "--dec-rounds", str(RD), "--iters", "1"]


def _bench_py_keys() -> set:
    """The keys of bench.py's final json.dumps({...}), from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps"
             and n.args and isinstance(n.args[0], ast.Dict)]
    return {k.value for k in dumps[-1].args[0].keys}


@pytest.mark.parametrize("i,rounds,blocks", [(0, R, B), (3, R, B),
                                             (5, 64, 128)])
def test_detect_keys_equal_bench_py(i, rounds, blocks):
    """bench.py:71-75 (`_bench_tpu.keys_for`)."""
    ids = jnp.arange(i * rounds * blocks, (i + 1) * rounds * blocks,
                     dtype=jnp.uint32)
    keys = jax_block_keys(jax.random.PRNGKey(0), 0, ids)
    want = np.asarray(keys.reshape(rounds, blocks, *keys.shape[1:]))
    got = bench_torch.detect_keys(i, rounds, blocks, "cpu")
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("i,cal,dec,blocks", [(0, RC, RD, B),
                                              (2, RC, RD, B),
                                              (5, 2, 6, 128)])
def test_e2e_keys_equal_bench_py(i, cal, dec, blocks):
    """bench.py:122-126 (`_bench_tpu_e2e.keys_for`)."""
    R_ = cal + dec
    ids = jnp.arange(i * R_ * blocks, (i + 1) * R_ * blocks,
                     dtype=jnp.uint32)
    keys = np.asarray(jax_block_keys(jax.random.PRNGKey(0), 1, ids)
                      .reshape(R_, blocks, -1)).astype(np.int64)
    ck, dk = bench_torch.e2e_keys(i, cal, dec, blocks, "cpu")
    assert np.array_equal(ck.numpy(), keys[:cal])
    assert np.array_equal(dk.numpy(), keys[cal:])


def test_main_prints_bench_py_line(capsys):
    bench_torch.main(TINY, cfg=_cdl_cfg())
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == _bench_py_keys()
    assert out["metric"] == "cdl_4x8_detected_symbols_per_s_per_chip"
    assert out["unit"] == "symbols/s"
    assert out["baseline_pinned"] is True
    assert out["value"] > 0 and out["e2e_decoded_symbols_per_s"] > 0
    assert abs(out["vs_baseline"] - out["value"] / 147.85) <= 0.005 + 1e-9
    assert set(out["bp_unconverged_frac"]) == {"esn", "mmse"}
    assert all(0.0 <= v <= 1.0 for v in out["bp_unconverged_frac"].values())
    for k in ("detect_spread_symbols_per_s", "e2e_spread_symbols_per_s"):
        assert out[k]["n"] == 1 and out[k]["min"] == out[k]["max"] > 0


def test_timers_count_what_the_port_counts():
    cfg = _cdl_cfg()
    rate, best, syms, times, (errs, total) = bench_torch._bench_detect(
        cfg, B, R, iters=1, device="cpu")
    want, want_total = run_cdl_cal_counters_chunks(
        cfg, 12.0, bench_torch.detect_keys(1, R, B, "cpu"))
    assert errs == {d: int(v) for d, v in want.items()}
    assert total == want_total
    assert syms == R * B * (cfg.data_symbols_per_block + 1)
    assert rate == syms / best and times == [best]

    _, _, syms, dec, _ = bench_torch._bench_e2e(cfg, B, RC, RD, iters=1,
                                                device="cpu")
    step = make_fused_cdl_snr_step(cfg, "cpu")
    pt = host_point(step(12.0, *bench_torch.e2e_keys(1, RC, RD, B, "cpu")))
    assert dec == pt.counts
    assert all(isinstance(v, int) for v in dec.ldpc_iter_sum.values())
    assert all(a.device.type == "cpu" for ab in pt.calib.values() for a in ab)
    assert syms == (RC + RD) * B * (cfg.data_symbols_per_block + 1)


def test_fit_samples_equal_what_the_fit_keeps(monkeypatch):
    """At bench.py's e2e shape (the flagship, 128 blocks, 2 cal rounds) the
    fit's input on the meta device: one row of (m, S) pairs a detector,
    stride-subsampled to 969,933 of 9,699,328."""
    cfg = mimo_4x8_cdl()
    kept = []

    def fit(x, y, **kw):
        kept.append(x.shape[-1])
        return x.new_ones(x.shape[:-1]), x.new_zeros(x.shape[:-1])

    monkeypatch.setattr(cdl, "fit_logreg_1d", fit)
    rounds = cdl.CdlRounds(cfg, 128, torch.device("meta"))
    rounds._fit_fn(2)()
    assert kept == [969_933] * len(cdl.CDL_DETECTORS)
    assert bench_torch.fit_samples(cfg, 2, 128) == 969_933


def test_baseline_resolution(tmp_path):
    assert bench_torch.resolve_baseline() == (147.85, True)
    assert bench_torch.resolve_baseline(str(ROOT)) == (147.85, True)
    base, pinned = bench_torch.resolve_baseline(str(tmp_path))
    assert not pinned and base > 0
    cached = json.loads((tmp_path / ".bench_baseline.json").read_text())
    assert cached["numpy_symbols_per_s"] == base
    assert bench_torch.resolve_baseline(str(tmp_path)) == (base, False)


def test_bench_torch_needs_a_card_and_names_no_jax():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch.main([])
    src = (ROOT / "bench_torch.py").read_text()
    for mod in ("jax", r"esn_ofdm_mimo_tpu(\.|\s)", r"bench\b"):
        assert not re.search(rf"^\s*(import|from)\s+{mod}", src, re.M), mod
    # no fallback: the one try is around nvidia-smi, outside any kernel
    with_try = {f.name for f in ast.walk(ast.parse(src))
                if isinstance(f, ast.FunctionDef)
                and any(isinstance(n, ast.Try) for n in ast.walk(f))}
    assert with_try == {"_card_line"}
