"""Each entry drives its tiny cell through the harness on the CPU (the
program's plain path, the reference on the same keys): the cells are new
files dropped into a temporary copy of the benchmark, run with no code
edit. The last line holds exactly the result's keys, `check` last."""
import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.tiny import CELLS, REPO, make_copy


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("bench"))


def _run(copy, cell, trace, extra=()):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run(
        [sys.executable, str(copy / "benchmark" / "run.py"), "--workload",
         cell, "--seed", str(2**31 + 77), "--seconds", "0.5", "--trace",
         str(trace), "--device", "cpu", *extra], capture_output=True,
        text=True, env=env, timeout=600, cwd=copy)
    return p


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_runs(copy, cell, trace):
    p = _run(copy, cell, trace)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert json.loads(lines[0])["setup"]["setup_s"] > 0
    out = json.loads(lines[-1])
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert out["device"]["platform"] == "cpu"
    names = set(out["metrics"])
    if trace:
        # the CPU has no device trace: only the host-clock readers read
        assert names and all(n.startswith(("enqueue_ms.", "mfu."))
                             for n in names)
    else:
        assert "setup_s" in names and "call_ms_p90" in names
        assert names & {"decoded_symbols_per_s", "detected_symbols_per_s"}
    assert all(c["value"] <= c["limit"] for c in out["check"].values())
    assert p.stderr.strip().splitlines()[-1].startswith("benchmark: check ")


def test_without_a_card_no_result(copy):
    """The default device is the card; without one the run prints no
    result and exits non-zero."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run(
        [sys.executable, str(copy / "benchmark" / "run.py"), "--workload",
         "tiny.detect", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=300, cwd=copy)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files (no program), a run exits non-zero with no result."""
    make_copy(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, str(tmp_path / "benchmark" / "run.py"),
         "--workload", "tiny.detect", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--device", "cpu"], capture_output=True,
        text=True, env=env, timeout=300, cwd=tmp_path)
    assert p.returncode != 0
    assert not any(line.startswith('{"correct"')
                   for line in p.stdout.splitlines())
