"""One calibrated CDL SNR point a call: the program's
`make_fused_cdl_snr_step(cfg, dev)`, cal_rounds calibration rounds, the
calibrator fit and dec_rounds decode rounds of `blocks` blocks, read on
the host with `host_point` (every counter and both calibrators)."""
from __future__ import annotations

import torch

from ..counts import flops as fl
from ._common import capture_stats, esn_shapes, free

LIBS = ("bp_decode", "esn_predict", "esn_states", "threefry")


class Entry:
    kind = "decode"

    def __init__(self, sim, dev, traffic: dict):
        self.sim, self.dev = sim, dev
        self.Rc, self.Rd = int(traffic["cal_rounds"]), int(traffic["dec_rounds"])
        self.B = int(traffic["blocks"])
        self.ebno = float(traffic["ebno_db"])
        self.rounds = self.Rc + self.Rd
        self.symbols_per_call = (self.rounds * self.B
                                 * (sim.data_symbols_per_block + 1))
        self.step = None

    def setup(self):
        from esn_ofdm_mimo_tpu_torch.parallel import make_fused_cdl_snr_step
        self.step = make_fused_cdl_snr_step(self.sim, self.dev)

    def captured(self) -> dict:
        if self.dev.type != "cuda":
            return {"captures_ms": 0.0, "pool_mib": 0.0}
        ms, pool = capture_stats((self.sim, self.B, self.dev, "cdl"))
        return {"captures_ms": ms, "pool_mib": pool / 2**20}

    def issue(self, keys: torch.Tensor):
        return self.step(self.ebno, keys[:self.Rc], keys[self.Rc:])

    def read(self, pt) -> dict:
        from esn_ofdm_mimo_tpu_torch.parallel import host_point
        pt = host_point(pt)
        c = pt.counts
        ans = {f"cal_bit_errors.{d}": v for d, v in pt.cal_bit_errors.items()}
        for f, v in (("bit_errors", c.bit_errors),
                     ("info_errors", c.info_errors),
                     ("frame_errors", c.frame_errors),
                     ("iter_sum", c.ldpc_iter_sum),
                     ("unconverged", c.ldpc_unconverged)):
            ans.update({f"{f}.{d}": int(x) for d, x in v.items()})
        ans["codewords"] = int(c.ldpc_codewords)
        for d, (a, b) in pt.calib.items():
            for j in range(a.numel()):
                ans[f"calib_a.{d}.{j}"] = float(a[j])
                ans[f"calib_b.{d}.{j}"] = float(b[j])
        return ans

    def bp_iterations(self, ans: dict) -> int:
        return sum(v for k, v in ans.items() if k.startswith("iter_sum."))

    def flops(self, ans: dict) -> float:
        return fl.cdl_point_flops(self.sim, self.B, self.Rc, self.Rd,
                                  fl.fit_samples(self.sim, self.Rc, self.B),
                                  self.bp_iterations(ans))

    def launches(self) -> dict:
        """K2: one launch a round on its B D rows (the matched ESN); K1:
        one launch a decode round on both detectors' codewords."""
        s = self.sim
        n = s.ofdm.n_subcarriers * s.ofdm.bits_per_symbol
        k2 = esn_shapes(s, self.B * s.data_symbols_per_block, self.B,
                        s.esn.n_reservoir)
        k1 = {"codewords": 2 * self.B * s.data_symbols_per_block
              * s.channel.n_tx, "n": n, "k": n // 2, "dv": s.ldpc.dv,
              "algo": s.ldpc.algo}
        return {"esn_predict": [k2] * self.rounds, "bp_decode": [k1] * self.Rd}

    def free(self):
        self.step = None
        free(self.dev)

    def reference(self, ref_cfg, keys: torch.Tensor, tf32: bool) -> dict:
        from .. import reference
        return reference.cdl_point(ref_cfg, self.ebno, keys[:self.Rc],
                                   keys[self.Rc:], tf32)
