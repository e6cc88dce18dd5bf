"""A run whose timed path is broken underneath comes out not correct. The
harness runs as it always does (on the CPU, the tiny cells of a temporary
copy); only the program is broken, once for each fault the cells can
have:

  state   the step returns its state unchanged: every call answers what
          the warm-up call answered;
  half    half of the batch left out: the program runs the first half of
          each round's blocks and its counters are doubled (the mean over
          the rest);
  token   an answer altered where it is produced: the program's hard
          decisions of one block are inverted.

The exchange between chips does not exist in these one-card cells."""
import contextlib
import io
import json

import pytest
import torch

from benchmark import manifest, run
from benchmark.tests.tiny import CELLS, make_copy


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("faults"))


def _break_state(Entry, monkeypatch):
    first = {}
    real = Entry.read

    def read(self, handle):
        ans = real(self, handle)
        return dict(first.setdefault(id(self), ans))
    monkeypatch.setattr(Entry, "read", read)


def _break_half(Entry, monkeypatch):
    real_issue, real_read = Entry.issue, Entry.read

    def issue(self, keys):
        return real_issue(self, keys[:, :keys.shape[1] // 2])

    def read(self, handle):
        ans = real_read(self, handle)
        return {k: (2 * v if isinstance(v, int) and k != "codewords"
                    else v) for k, v in ans.items()}
    monkeypatch.setattr(Entry, "issue", issue)
    monkeypatch.setattr(Entry, "read", read)


def _break_token(Entry, monkeypatch):
    import esn_ofdm_mimo_tpu_torch.pipelines.blockfading as bf
    import esn_ofdm_mimo_tpu_torch.pipelines.cdl as cdl
    real = cdl.symbols_to_bits_hard

    def hard(z, m):
        bits = real(z, m)
        bits[0] = 1 - bits[0]          # one block's decisions inverted
        return bits
    monkeypatch.setattr(cdl, "symbols_to_bits_hard", hard)
    monkeypatch.setattr(bf, "symbols_to_bits_hard", hard)


FAULTS = {"state": _break_state, "half": _break_half, "token": _break_token}


def _result(copy, cell, monkeypatch):
    monkeypatch.setattr(manifest, "HERE", copy / "benchmark")
    monkeypatch.setattr(manifest, "ROOT", copy)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", "4100000001",
                       "--seconds", "0.3", "--trace", "0", "--device",
                       "cpu"])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(copy, cell, fault, monkeypatch):
    torch.manual_seed(0)
    Entry = manifest.entry(manifest.workload(cell, copy / "benchmark")
                           ["entry"]).Entry
    FAULTS[fault](Entry, monkeypatch)
    out = _result(copy, cell, monkeypatch)
    assert out["correct"] is False, out["check"]


def test_sound_run_is_correct(copy, monkeypatch):
    assert _result(copy, "tiny.point", monkeypatch)["correct"] is True
