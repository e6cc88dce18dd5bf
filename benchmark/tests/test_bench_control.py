"""On the card, at each cell's own size: the control (the reference with
TF32 matrix products, put in the program's place) comes out not correct
on three seeds, and the program comes out correct on the same keys.
Skipped without a card; the readings behind the limits come from
benchmark/readings.py, which this runs."""
import io

import pytest

from benchmark import manifest
from benchmark.readings import readings
from benchmark.reference import compare

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    table = manifest.workload(cell)["check"]
    for row in readings(cell, (910001, 910002, 910003), None, "cuda",
                        io.StringIO()):
        prog = compare.check(table, row["program"], row["reference"])
        ctl = compare.check(table, row["control"], row["reference"])
        assert compare.passed(prog), prog
        assert not compare.passed(ctl), ctl
