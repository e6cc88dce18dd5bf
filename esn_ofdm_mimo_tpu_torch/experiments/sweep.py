"""ESN hyperparameter sweep of the port.

    python -m esn_ofdm_mimo_tpu_torch.experiments.sweep --param reservoir \
        --ebno 12 --blocks 16 --outdir results/esn_sweeps [--device cpu]

Port of esn_ofdm_mimo_tpu/experiments/sweep.py: the BER of the ESN detector
against one hyperparameter at a fixed Eb/N0 on the 2x2 block-fading plant
(the reference's ESN_sweep_{reservoir,spectral,sparsity,inpscale,teachers}
figures), uncoded by default. The same flags plus `--device` (default
`cuda`, which raises without a GPU; `cpu` runs the kernels' plain
versions), the same `[sweep]` lines, `ESN_sweep_{param}.json` with the same
keys, and the PNG where matplotlib is installed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Sequence

SWEEPS: Dict[str, Sequence] = {
    "reservoir": (50, 100, 200, 300, 450, 600),
    "spectral": (0.5, 0.7, 0.8, 0.9, 0.95, 0.99),
    "sparsity": (0.0, 0.1, 0.3, 0.5, 0.7, 0.9),
    "inpscale": (0.0005, 0.001, 0.005, 0.02, 0.1),
    "teachers": (5e-8, 5e-7, 5e-6, 5e-5),
}


def _apply(cfg, param: str, value):
    esn = cfg.esn
    if param == "reservoir":
        esn = dataclasses.replace(esn, n_reservoir=int(value))
    elif param == "spectral":
        esn = dataclasses.replace(esn, spectral_radius=float(value))
    elif param == "sparsity":
        esn = dataclasses.replace(esn, sparsity=float(value))
    elif param == "inpscale":
        esn = dataclasses.replace(esn, input_scaler=float(value))
    elif param == "teachers":
        esn = dataclasses.replace(esn, teacher_scaling=float(value))
    else:
        raise ValueError(param)
    return dataclasses.replace(cfg, esn=esn)


# sweep param -> the synth_block esn_over key that carries it (as the JAX
# package sweeps it); "reservoir" changes shapes and runs _apply's config
_TRACED = {"spectral": "spectral_radius", "sparsity": "sparsity",
           "inpscale": "input_scaler", "teachers": "teacher_scaling"}


def run_sweep(param: str, ebno_db: float = 12.0, blocks: int = 16,
              seed: int = 0, base_cfg=None, device=None) -> Dict[float, float]:
    """Returns {value: esn_ber} for the chosen hyperparameter sweep: one
    batch of `blocks` blocks, keys block_keys(PRNGKey(seed), 0, 0 ..
    blocks - 1), the ESN detector only."""
    from ..pipelines.blockfading import run_nbf_blocks
    from ..utils import rng
    from ..utils.device import resolve_device
    from .presets import mimo_2x2_nbf

    dev = resolve_device(device)
    base = base_cfg if base_cfg is not None else dataclasses.replace(
        mimo_2x2_nbf(), ldpc=dataclasses.replace(mimo_2x2_nbf().ldpc,
                                                 enabled=False))
    keys = rng.block_keys(rng.prng_key(seed, dev), 0, range(blocks))
    out = {}
    for v in SWEEPS[param]:
        if param in _TRACED:
            counts = run_nbf_blocks(base, float(ebno_db), keys,
                                    detectors=("esn",),
                                    esn_over={_TRACED[param]: v})
        else:
            counts = run_nbf_blocks(_apply(base, param, v), float(ebno_db),
                                    keys, detectors=("esn",))
        out[float(v)] = (float(counts.bit_errors["esn"])
                         / float(counts.total_bits))
        print(f"[sweep] {param}={v}: BER={out[float(v)]:.4g}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--param", choices=sorted(SWEEPS), required=True)
    ap.add_argument("--ebno", type=float, default=12.0)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--outdir", default="results/esn_sweeps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu (the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    res = run_sweep(args.param, args.ebno, args.blocks, device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        xs = sorted(res)
        fig = plt.figure()
        plt.semilogy(xs, [max(res[x], 1e-8) for x in xs], "o-")
        plt.xlabel(args.param)
        plt.ylabel("ESN BER")
        plt.grid(True, which="both", ls=":")
        plt.title(f"ESN sweep: {args.param} @ {args.ebno:g} dB")
        fig.savefig(os.path.join(args.outdir, f"ESN_sweep_{args.param}.png"),
                    dpi=150)
        plt.close(fig)
    except Exception:  # noqa: BLE001 - the figure is optional, as in JAX
        pass
    with open(os.path.join(args.outdir, f"ESN_sweep_{args.param}.json"),
              "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
