"""Classification-zoo experiment CLI of the port (system model 1).

    python -m esn_ofdm_mimo_tpu_torch.experiments.classify --fast \
        [--frontend sm1|sm2] [--variant wide|narrow] [--device cpu]

Port of esn_ofdm_mimo_tpu/experiments/classify.py: the same flags with the
same names and defaults, plus `--device` (default `cuda`, which raises
without a GPU; `cpu` runs everything in plain PyTorch). It writes the
reference's artifact set (esn_via_cdl_all_model.py:453-472):
ser_vs_snr.pkl, ber_vs_snr.pkl, model_results.pkl (with `meta`: the
run's settings and, for sm1, the NR base-graph source, fingerprint and
caveat), events.jsonl (run_start, one snr_done per SNR with each phase's
wall ms, run_done), the printed tables, and, where matplotlib is installed,
the SER and BER curves and constellation scatters as PNGs.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--outdir", default="results/classification")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frontend", choices=("sm1", "sm2"), default="sm1",
                    help="sm1 = the reference's Sionna operating point "
                         "(5G grid + spatial CDL-B + LS-nn + LMMSE); "
                         "sm2 = this framework's own comb-pilot CDL link")
    ap.add_argument("--batch", type=int, default=None,
                    help="sm1 batch size (reference batch_size_sim=64)")
    ap.add_argument("--variant", choices=("wide", "narrow"), default="wide",
                    help="baseline widths: wide = esn_via_cdl_all_model.py"
                         " (~600 units), narrow = esn_ofdm_mimo_via_cdl.py")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu (plain "
                         "PyTorch throughout)")
    args = ap.parse_args(argv)

    from ..pipelines.classification import run_classification_experiment
    from ..utils.device import resolve_device
    from ..utils.metrics import MetricsLogger
    from .presets import mimo_4x8_cdl

    dev = resolve_device(args.device)
    cfg = mimo_4x8_cdl(fast=args.fast)
    cfg = dataclasses.replace(
        cfg, ldpc=dataclasses.replace(cfg.ldpc, enabled=False),
        ebno_db=(0.0, 10.0, 20.0) if args.fast else
        tuple(float(x) for x in range(0, 21, 2)))
    blocks = args.blocks or (2 if args.fast else 8)
    epochs = args.epochs or (60 if args.fast else 200)
    batch = args.batch or (16 if args.fast else 64)

    os.makedirs(args.outdir, exist_ok=True)
    # the sm1 dataset encodes with the NR LDPC code, whose base-graph data
    # is a documented surrogate: the caveat and the table fingerprint
    # travel with every artifact
    meta = {"frontend": args.frontend, "variant": args.variant,
            "blocks": blocks, "epochs": epochs, "batch": batch,
            "seed": args.seed}
    if args.frontend == "sm1":
        from ..ldpc import (NR_SURROGATE_CAVEAT, BG_TABLES_SOURCE,
                            basegraph_fingerprint)
        meta["nr_basegraph_source"] = BG_TABLES_SOURCE
        meta["nr_basegraph_fingerprint"] = basegraph_fingerprint()
        if BG_TABLES_SOURCE == "surrogate":
            meta["nr_caveat"] = NR_SURROGATE_CAVEAT
    log = MetricsLogger(os.path.join(args.outdir, "events.jsonl"))
    log.log("run_start", device=str(dev), **meta)
    t0 = time.time()
    timings: dict = {}
    results, scatter = run_classification_experiment(
        cfg, blocks=blocks, epochs=epochs, seed=args.seed,
        frontend=args.frontend, batch=batch, variant=args.variant,
        collect_scatter=True, device=dev, timings=timings)
    for e, ph in timings.items():
        log.log("snr_done", ebno_db=e,
                ms={k: round(v, 3) for k, v in ph.items()})
    log.log("run_done", seconds=round(time.time() - t0, 1),
            outdir=args.outdir)
    log.close()
    models = sorted(next(iter(results.values())).keys())
    ebnos = sorted(results)
    ser = {m: [results[e][m]["ser"] for e in ebnos] for m in models}
    ber = {m: [results[e][m]["ber"] for e in ebnos] for m in models}
    with open(os.path.join(args.outdir, "ser_vs_snr.pkl"), "wb") as f:
        pickle.dump({"ebno_db": ebnos, "ser": ser}, f)
    with open(os.path.join(args.outdir, "ber_vs_snr.pkl"), "wb") as f:
        pickle.dump({"ebno_db": ebnos, "ber": ber}, f)
    with open(os.path.join(args.outdir, "model_results.pkl"), "wb") as f:
        pickle.dump({"meta": meta, "results": results}, f)

    # printed tables, reference style (incl. trainable parameter counts,
    # reference esn_via_cdl_all_model.py:229-236)
    first = results[ebnos[0]]
    print("\nTrainable parameters")
    for m in models:
        if "params" in first[m]:
            print(f"{m:10s} {first[m]['params']:>9,d}")
    print("\nSER vs Eb/N0")
    print("model     " + " ".join(f"{e:>9.0f}dB" for e in ebnos))
    for m in models:
        print(f"{m:10s}" + " ".join(f"{v:11.6f}" for v in ser[m]))
    print("\nBER vs Eb/N0")
    for m in models:
        print(f"{m:10s}" + " ".join(f"{v:11.6f}" for v in ber[m]))
    _plots(args.outdir, models, ebnos, ser, ber, scatter)


def _plots(outdir, models, ebnos, ser, ber, scatter) -> None:
    """SER / BER curves and constellation scatters at the top SNR (true
    labels, and each model's predictions; esn_via_cdl_all_model.py:
    400-437). Best-effort, as in the JAX package: a missing matplotlib or a
    plotting error skips the figures with a warning."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        for name, data in (("ser", ser), ("ber", ber)):
            fig = plt.figure(figsize=(9, 6))
            for m in models:
                plt.semilogy(ebnos, np.maximum(data[m], 1e-6), "o-", label=m)
            plt.grid(True, which="both", ls=":")
            plt.xlabel("E_b/N_0 [dB]")
            plt.ylabel(name.upper())
            plt.legend()
            plt.tight_layout()
            fig.savefig(os.path.join(outdir, f"{name}_vs_snr.png"), dpi=150)
            plt.close(fig)

        pts = scatter["x"][:4000]
        e_top = scatter["ebno_db"]

        def _scatter_png(colors, title, fname):
            fig = plt.figure(figsize=(6, 6))
            plt.scatter(pts[:, 0], pts[:, 1], c=colors[:4000], s=4,
                        cmap="tab20", alpha=0.6)
            plt.title(title)
            plt.xlabel("Re")
            plt.ylabel("Im")
            fig.savefig(os.path.join(outdir, fname), dpi=150)
            plt.close(fig)

        _scatter_png(scatter["labels"],
                     f"Equalized symbols (true labels) @ {e_top:g} dB",
                     "constellation_scatter.png")
        for mname, pred in scatter["preds"].items():
            _scatter_png(pred, f"{mname} predictions @ {e_top:g} dB",
                         f"constellation_{mname}.png")
    except Exception as e:  # noqa: BLE001 - the figures are best-effort
        print(f"[warn] plotting skipped (best-effort): {e}")


if __name__ == "__main__":
    main()
