"""The zoo entry through the harness on the CPU: a tiny 2x2 zoo
configuration and cell (N 32, a 40-neuron reservoir, 2 blocks, 3 epochs)
dropped as new files into a temporary copy of the benchmark beside the
tiny cells of tiny.py, run untraced and traced with no code edit; and a
run whose program miscounts (one bit error more, or one block's hard
decisions inverted) comes out not correct."""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import manifest, run
from benchmark.tests.tiny import REPO, make_copy

CELL = "tiny.zoo"


def _zoo_copy(dst):
    import esn_ofdm_mimo_tpu_torch.config as tc
    make_copy(dst)
    cfg = tc.SimConfig(
        name="tiny_zoo",
        ofdm=tc.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                           doppler_hz=3000.0),
        channel=tc.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=tc.EsnConfig(n_reservoir=40, train_ebno_fixed_db=None),
        ldpc=tc.LdpcConfig(enabled=False))
    (dst / "benchmark" / "configs" / "tiny_zoo.json").write_text(json.dumps(
        {"name": "tiny_zoo", "source": "tiny", "preset": None, "reduced": [],
         "assumed": [], "sim": json.loads(json.dumps(
             dataclasses.asdict(cfg)))}))
    w = json.loads((REPO / "benchmark" / "workloads"
                    / "zoo2x2.round_12db.json").read_text())
    # 2 blocks of D = 7 data symbols of 2 x 32 x 4 bits
    w.update(config="tiny_zoo", blocks=2, epochs=3, trace_calls=1,
             totals={"total_bits": 3584, "n_blocks": 2})
    (dst / "benchmark" / "workloads" / f"{CELL}.json").write_text(
        json.dumps(w))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "zoo2x2.round_12db" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return _zoo_copy(tmp_path_factory.mktemp("zoo"))


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_zoo_cell_runs(copy, trace):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run(
        [sys.executable, str(copy / "benchmark" / "run.py"), "--workload",
         CELL, "--seed", str(2**31 + 79), "--seconds", "0.5", "--trace",
         str(trace), "--device", "cpu"], capture_output=True, text=True,
        env=env, timeout=600, cwd=copy)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0, out["check"]
    assert out["attempted"] >= 1
    names = set(out["metrics"])
    if trace:
        # the CPU has no device trace: only the host-clock readers read
        assert names == {"enqueue_ms.detect", "mfu.detect"}
    else:
        assert names == {"setup_s", "call_ms_p90", "detected_symbols_per_s"}
    assert set(out["check"]) == {"uncoded.linear", "uncoded.esn", "nmse.esn",
                                 "uncoded.elm", "nmse.elm",
                                 "uncoded.trained", "nmse.trained", "totals"}


def _one_more_error(Entry, monkeypatch):
    real = Entry.read

    def read(self, handle):
        ans = real(self, handle)
        ans["bit_errors.mmse"] += 1
        return ans
    monkeypatch.setattr(Entry, "read", read)


def _inverted_block(Entry, monkeypatch):
    import esn_ofdm_mimo_tpu_torch.pipelines.zoo2x2 as z
    real = z.symbols_to_bits_hard

    def hard(x, m):
        bits = real(x, m)
        bits[0] = 1 - bits[0]          # one block's decisions inverted
        return bits
    monkeypatch.setattr(z, "symbols_to_bits_hard", hard)


@pytest.mark.parametrize("fault", [_one_more_error, _inverted_block])
def test_zoo_fault_is_not_correct(copy, fault, monkeypatch):
    torch.manual_seed(0)
    monkeypatch.setattr(manifest, "HERE", copy / "benchmark")
    monkeypatch.setattr(manifest, "ROOT", copy)
    fault(manifest.entry("zoo_round").Entry, monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", CELL, "--seed", "4100000003",
                       "--seconds", "0.3", "--trace", "0", "--device",
                       "cpu"])
    assert rc == 0
    assert json.loads(out.getvalue().strip().splitlines()[-1])[
        "correct"] is False


def test_zoo_config_and_counts():
    """The zoo configuration file holds its sim tree for the program and
    the reference (D = 18 data symbols a block at N 512), and the frozen
    counts of its cell: a K7 training launch's bound is its operations'
    (1.48 GFLOP an epoch at 128 x 522), the zoo round's FLOPs grow with
    the epochs by the three trained models' steps."""
    from benchmark import reference
    from benchmark.counts import bounds, gru_work, zoo_flops
    from benchmark.run import program_config
    f = manifest.config("mimo_2x2_zoo")
    assert f["preset"] is None and f["reduced"] == []
    cfg = reference.sim_config(f["sim"])
    assert program_config(f).data_symbols_per_block == 18
    n_bytes, ops, transc = gru_work.train_work(128, 522)
    assert ops == pytest.approx(1_480_909_824.0)
    assert bounds.bound_s(n_bytes, ops, transc) == ops / bounds.FP32_FLOP_PER_S
    f50 = zoo_flops.zoo_round_flops(cfg, 128, 50)
    f49 = zoo_flops.zoo_round_flops(cfg, 128, 49)
    per_epoch = sum(3.0 * fwd * 128 * 522 + zoo_flops.ADAM_FLOPS * 128 * p
                    for fwd, p in (zoo_flops.cnn_step(4, 4),
                                   zoo_flops.gru_step(4, 4),
                                   zoo_flops.fnn_step(4, 4)))
    assert f50 - f49 == pytest.approx(per_epoch)
