"""A temporary copy of the benchmark with tiny configurations and cells
beside the real ones, for runs on the CPU: the real cells' traffic files
with 2 blocks a round, a 2x2 CDL-B and a 2x2 block-fading configuration
of 32 subcarriers and a 40-neuron reservoir."""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELLS = {"tiny.point": ("cdl4x8.point_12db", "tiny_cdl"),
         "tiny.detect": ("cdl4x8.detect_12db", "tiny_cdl"),
         "tiny.round": ("nbf4x8.round_12db", "tiny_nbf")}


def tiny_configs() -> dict:
    import esn_ofdm_mimo_tpu_torch.config as tc
    cdl = tc.SimConfig(
        name="tiny_cdl",
        ofdm=tc.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                           doppler_hz=6000.0),
        channel=tc.ChannelConfig(kind="cdl_b", n_tx=2, n_rx=2),
        esn=tc.EsnConfig(n_reservoir=40, train_ebno_fixed_db=None),
        ldpc=tc.LdpcConfig(max_iter=20, family="qc", algo="offset-minsum"),
        calib=tc.CalibConfig(enabled=True, gd_steps=20))
    nbf = tc.SimConfig(
        name="tiny_nbf",
        ofdm=tc.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                           doppler_hz=3000.0),
        channel=tc.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=tc.EsnConfig(n_reservoir=40),
        ldpc=tc.LdpcConfig(max_iter=20, decode_every=2, family="qc"))
    return {c.name: c for c in (cdl, nbf)}


def make_copy(dst: Path) -> Path:
    """Copy BENCHMARK.json and benchmark/ to `dst`, add the tiny
    configurations and cells (as new files only), and list the cells in
    the metrics' `workloads` as their real counterparts are. Returns
    dst."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, c in tiny_configs().items():
        (dst / "benchmark" / "configs" / f"{name}.json").write_text(
            json.dumps({"name": name, "source": "tiny", "preset": None,
                        "reduced": [], "assumed": [],
                        "sim": json.loads(json.dumps(
                            dataclasses.asdict(c)))}))
    for cell, (real, cfg) in CELLS.items():
        w = json.loads((REPO / "benchmark" / "workloads"
                        / f"{real}.json").read_text())
        w.update(config=cfg, blocks=2, trace_calls=1)
        if "rounds" in w:
            w["rounds"] = 2
        w.pop("totals")
        (dst / "benchmark" / "workloads" / f"{cell}.json").write_text(
            json.dumps(w))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    back = {real: cell for cell, (real, _) in CELLS.items()}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [back[w] for w in m["workloads"] if w in back]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst
