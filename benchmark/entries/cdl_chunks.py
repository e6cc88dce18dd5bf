"""The detection chunks a call: the program's
`run_cdl_cal_counters_chunks(cfg, ebno, keys)` on `rounds` chunks of
`blocks` calibration blocks (a captured chunk replayed once a chunk; no
LLRs, calibrator fit or BP), its counters read on the host."""
from __future__ import annotations

import torch

from ..counts import flops as fl
from ._common import capture_stats, esn_shapes, free

LIBS = ("esn_predict", "esn_states", "threefry")


class Entry:
    kind = "detect"

    def __init__(self, sim, dev, traffic: dict):
        self.sim, self.dev = sim, dev
        self.rounds = int(traffic["rounds"])
        self.B = int(traffic["blocks"])
        self.ebno = float(traffic["ebno_db"])
        self.symbols_per_call = (self.rounds * self.B
                                 * (sim.data_symbols_per_block + 1))

    def setup(self):
        """Nothing before the warm-up call, which captures the chunk."""

    def captured(self) -> dict:
        if self.dev.type != "cuda":
            return {"captures_ms": 0.0, "pool_mib": 0.0}
        ms, pool = capture_stats((self.sim, self.B, self.dev, "chunk"))
        return {"captures_ms": ms, "pool_mib": pool / 2**20}

    def issue(self, keys: torch.Tensor):
        from esn_ofdm_mimo_tpu_torch.pipelines.cdl import \
            run_cdl_cal_counters_chunks
        return run_cdl_cal_counters_chunks(self.sim, self.ebno, keys)

    def read(self, out) -> dict:
        errs, total = out
        ans = {f"bit_errors.{d}": int(v) for d, v in errs.items()}
        ans["total_bits"] = int(total)
        return ans

    def flops(self, ans: dict) -> float:
        return fl.cdl_flops(self.sim, self.B).cal_counters * self.rounds

    def launches(self) -> dict:
        s = self.sim
        k2 = esn_shapes(s, self.B * s.data_symbols_per_block, self.B,
                        s.esn.n_reservoir)
        return {"esn_predict": [k2] * self.rounds}

    def free(self):
        self.step = None
        free(self.dev)

    def reference(self, ref_cfg, keys: torch.Tensor, tf32: bool) -> dict:
        from .. import reference
        return reference.cdl_chunks(ref_cfg, self.ebno, keys, tf32)
