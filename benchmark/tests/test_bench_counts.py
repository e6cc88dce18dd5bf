"""The frozen counts against the figures they were frozen at."""
import json

import pytest

from benchmark import manifest, reference
from benchmark.counts import bounds, flops


def _cfg(name):
    return reference.sim_config(manifest.config(name)["sim"])


def test_flagship_chunk_flops():
    """A 128-block calibration chunk of mimo_4x8_cdl: the program's
    utils/flops.py figure when it was frozen."""
    got = flops.cdl_flops(_cfg("mimo_4x8_cdl"), 128).cal_counters
    assert got == pytest.approx(318_408_976_554.7, abs=0.1)


def test_point_flops_compose():
    cfg = _cfg("mimo_4x8_cdl")
    fl = flops.cdl_flops(cfg, 128)
    S = flops.fit_samples(cfg, 2, 128)
    assert S == 969_933          # the stride-subsampled pairs a bit position
    base = flops.cdl_point_flops(cfg, 128, 2, 6, S, 0)
    assert base == pytest.approx(
        2 * fl.cal_full + flops.calib_fit_flops(4, S, 400)
        + 6 * (fl.decode_blocks - fl.decode))
    more = flops.cdl_point_flops(cfg, 128, 2, 6, S, 1000)
    assert more - base == pytest.approx(1000 * 512 * 4 * 12.0)


def test_nbf_round_flops():
    cfg = _cfg("mimo_4x8_nbf")
    base = flops.nbf_round_flops(cfg, 128, 0)
    # two dual Newton-Schulz solves of 512 x 512 Grams lead the round
    ns = 2 * flops.readout_lstsq_flops(128, 512, 616, 8)
    assert 0.6 < ns / base < 0.8
    assert flops.nbf_round_flops(cfg, 128, 10) - base == pytest.approx(
        10 * 2048 * 4 * 14.0)


def test_bounds_at_the_program_figures():
    """chip_smoke.py's K2 bound at the flagship shape (3.897 ms, operations)
    and K1's at 75,776 codewords of 43.0 mean iterations (1.296 ms)."""
    nb, ops = bounds.predict_work(9472, 138, 10, 300, 16, 8, 128)
    assert 1e3 * bounds.bound_s(nb, ops) == pytest.approx(3.897, abs=5e-4)
    b = bounds.k1_work(75_776, 512, 256, 4, 75_776 * 43.0, "offset-minsum")
    assert 1e3 * bounds.bound_s(*b) == pytest.approx(1.296, abs=2e-3)
    assert bounds.k1_work(1, 512, 256, 4, 1, "sumprod")[2] == 2 * 2048


def test_config_files_hold_their_sim_trees():
    for name in ("mimo_4x8_cdl", "mimo_4x8_nbf"):
        f = manifest.config(name)
        assert f["preset"] == name and f["reduced"] == []
        assert json.loads(json.dumps(f["sim"])) == f["sim"]
        reference.sim_config(f["sim"])
