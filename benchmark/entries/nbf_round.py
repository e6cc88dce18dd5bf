"""One block-fading round a call: the program's
`make_sharded_nbf_step(cfg, dev)` on `blocks` blocks (the fused NBF
round, a CUDA graph for the Eb/N0's BP cap), its counters and analytics
read on the host."""
from __future__ import annotations

import torch

from ..counts import flops as fl
from ._common import capture_stats, esn_shapes, free

LIBS = ("bp_decode", "esn_predict", "esn_states", "svdvals_small",
        "threefry")


class Entry:
    kind = "decode"

    def __init__(self, sim, dev, traffic: dict):
        self.sim, self.dev = sim, dev
        self.rounds = 1
        self.B = int(traffic["blocks"])
        self.ebno = float(traffic["ebno_db"])
        self.symbols_per_call = self.B * (sim.data_symbols_per_block + 1)
        self.step = None

    def setup(self):
        from esn_ofdm_mimo_tpu_torch.parallel import make_sharded_nbf_step
        self.step = make_sharded_nbf_step(self.sim, self.dev)

    def captured(self) -> dict:
        if self.dev.type != "cuda":
            return {"captures_ms": 0.0, "pool_mib": 0.0}
        ms, pool = capture_stats((self.sim, self.B, self.dev, "nbf"))
        return {"captures_ms": ms, "pool_mib": pool / 2**20}

    def issue(self, keys: torch.Tensor):
        return self.step(self.ebno, keys[0])

    def read(self, counts) -> dict:
        from .. import reference
        return reference.nbf_answer(counts)

    def bp_iterations(self, ans: dict) -> int:
        return sum(v for k, v in ans.items()
                   if k.startswith("ldpc_iter_sum."))

    def flops(self, ans: dict) -> float:
        return fl.nbf_round_flops(self.sim, self.B, self.bp_iterations(ans))

    def launches(self) -> dict:
        """K2: the matched and the fixed-SNR ESN, each on the round's B D
        rows; K1: one launch on the five detectors' codewords of every
        decode_every-th data symbol."""
        s = self.sim
        n = s.ofdm.n_subcarriers * s.ofdm.bits_per_symbol
        Dd = len(range(0, s.data_symbols_per_block, s.ldpc.decode_every))
        k2 = esn_shapes(s, self.B * s.data_symbols_per_block, self.B,
                        s.esn.n_reservoir)
        k1 = {"codewords": fl.NBF_DETECTORS * self.B * Dd * s.channel.n_tx,
              "n": n, "k": n // 2, "dv": s.ldpc.dv, "algo": s.ldpc.algo}
        return {"esn_predict": [k2, k2], "bp_decode": [k1]}

    def free(self):
        self.step = None
        free(self.dev)

    def reference(self, ref_cfg, keys: torch.Tensor, tf32: bool) -> dict:
        from .. import reference
        return reference.nbf_round(ref_cfg, self.ebno, keys[0], tf32)
