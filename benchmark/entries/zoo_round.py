"""One 2x2 model-zoo round a call: the program's `make_zoo_step(cfg, dev,
epochs)` on `blocks` blocks (the ESN, ZF, MMSE and a CNN, a GRU, an FNN
and an ELM trained on each block's pilot; one captured `zoo.round` graph),
its bit errors and NMSE sums read on the host with `host_zoo`."""
from __future__ import annotations

import torch

from ..counts import zoo_flops
from ._common import capture_stats, esn_shapes, free

# gru_train first: a program without K7 fails on its missing source
# before any nvcc of the others starts
LIBS = ("gru_train", "esn_predict", "esn_states", "threefry")


class Entry:
    kind = "detect"

    def __init__(self, sim, dev, traffic: dict):
        self.sim, self.dev = sim, dev
        self.rounds = 1
        self.B = int(traffic["blocks"])
        self.ebno = float(traffic["ebno_db"])
        self.epochs = int(traffic["epochs"])
        self.symbols_per_call = self.B * (sim.data_symbols_per_block + 1)
        self.step = None

    def setup(self):
        from esn_ofdm_mimo_tpu_torch.parallel import make_zoo_step
        self.step = make_zoo_step(self.sim, self.dev, self.epochs)

    def captured(self) -> dict:
        if self.dev.type != "cuda":
            return {"captures_ms": 0.0, "pool_mib": 0.0}
        ms, pool = capture_stats((self.sim, self.B, self.dev,
                                  f"zoo.e{self.epochs}"))
        return {"captures_ms": ms, "pool_mib": pool / 2**20}

    def issue(self, keys: torch.Tensor):
        return self.step(self.ebno, keys[0])

    def read(self, counts) -> dict:
        from esn_ofdm_mimo_tpu_torch.pipelines.zoo2x2 import host_zoo
        from ..reference.zoo import zoo_answer
        return zoo_answer(host_zoo(counts))

    def flops(self, ans: dict) -> float:
        return zoo_flops.zoo_round_flops(self.sim, self.B, self.epochs)

    def launches(self) -> dict:
        """K2: the ESN's detection of the B D data symbols and its two
        NMSE predictions (pilot and data), B readouts each; K7: a training
        launch an epoch on the B pilots, then the predictions of the
        pilots and of the data symbols."""
        s = self.sim
        D = s.data_symbols_per_block
        n = s.esn.n_reservoir
        k2 = [esn_shapes(s, self.B * D, self.B, n),
              esn_shapes(s, self.B, self.B, n),
              esn_shapes(s, self.B * D, self.B, n)]
        T = esn_shapes(s, 1, 1, n)["T"]
        k7 = ([{"mode": "train", "blocks": self.B, "T": T}] * self.epochs
              + [{"mode": "predict", "blocks": self.B, "sequences": 1,
                  "T": T},
                 {"mode": "predict", "blocks": self.B, "sequences": D,
                  "T": T}])
        return {"esn_predict": k2, "gru_train": k7}

    def free(self):
        self.step = None
        free(self.dev)

    def reference(self, ref_cfg, keys: torch.Tensor, tf32: bool) -> dict:
        from ..reference.zoo import zoo_round
        return zoo_round(ref_cfg, self.ebno, keys[0], tf32, self.epochs)
