"""The reference's answer to one call of the 2x2 model-zoo comparison:
chain/pipelines/zoo2x2.py on the call's keys, in fp32 with TF32 off (or,
for the control, on), and the flat answer both sides are read into."""
from __future__ import annotations

import torch

from . import precision


def zoo_round(cfg, ebno_db: float, keys: torch.Tensor, tf32: bool = False,
              epochs: int = 50) -> dict:
    """The eight detectors' bit errors and the five models' NMSE sums of
    the blocks of keys (B, 2), every model trained for `epochs` Adam
    steps."""
    from .chain.pipelines import zoo2x2
    with precision(tf32):
        return zoo_answer(zoo2x2.run_zoo_blocks(cfg, ebno_db, keys, epochs))


def zoo_answer(c) -> dict:
    """A flat answer from a ZooCounts-like tuple of host numbers (the
    program's or the reference's)."""
    ans = {f"bit_errors.{d}": int(v) for d, v in c.bit_errors.items()}
    for table in ("train_nmse", "test_nmse"):
        ans.update({f"{table}.{k}": float(v)
                    for k, v in getattr(c, table).items()})
    ans["total_bits"] = int(c.total_bits)
    ans["n_blocks"] = int(c.n_blocks)
    return ans
