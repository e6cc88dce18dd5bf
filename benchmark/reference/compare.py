"""The comparison that decides `correct`: the program's answer against the
reference's, one number per entry of a workload file's `check` table,
each held to its own limit.

A number names the answer keys it covers (fnmatch patterns) and how it
measures them:

  rel     the largest |program - reference| / max(|reference|, 1) over
          the keys: a relative gap of counters;
  group   max |program - reference| over the keys / max |reference| over
          the keys: a gap relative to the group's largest value, for
          floats of which some lie near 0 (the calibrators' offsets);
  exact   the largest |program - reference|: totals that must agree.

A key that one side lacks, or a pattern that matches nothing, makes the
number infinite, so the run fails.
"""
from __future__ import annotations

import fnmatch
import math


def _keys(spec: dict, prog: dict, ref: dict) -> list:
    keys = set()
    for pat in spec["keys"]:
        hit = fnmatch.filter(list(ref), pat) + fnmatch.filter(list(prog), pat)
        if not hit:
            return []
        keys.update(hit)
    return sorted(keys)


def number(spec: dict, prog: dict, ref: dict) -> float:
    """The value of one number of the check table."""
    keys = _keys(spec, prog, ref)
    if not keys or any(k not in prog or k not in ref for k in keys):
        return math.inf
    diff = [abs(float(prog[k]) - float(ref[k])) for k in keys]
    if spec["how"] == "exact":
        return max(diff)
    if spec["how"] == "rel":
        return max(d / max(abs(float(ref[k])), 1.0)
                   for d, k in zip(diff, keys))
    if spec["how"] == "group":
        return max(diff) / max(max(abs(float(ref[k])) for k in keys), 1e-30)
    raise ValueError(f"unknown comparison {spec['how']!r}")


def check(table: dict, prog: dict, ref: dict) -> dict:
    """name -> (value, limit) for every number of `table`."""
    return {name: (number(spec, prog, ref), float(spec["limit"]))
            for name, spec in table.items()}


def passed(results: dict) -> bool:
    """Whether every number lies within its limit (a NaN fails)."""
    return all(v <= lim for v, lim in results.values())


def gaps(prog: dict, ref: dict) -> dict:
    """Every key's own relative gap, for the readings that set limits."""
    return {k: abs(float(prog[k]) - float(ref[k]))
            / max(abs(float(ref[k])), 1.0)
            for k in sorted(set(prog) & set(ref))}
