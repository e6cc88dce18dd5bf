"""2x2 model-zoo comparison CLI of the port
(system_model_2_all_comparision.py).

    python -m esn_ofdm_mimo_tpu_torch.experiments.compare2x2 [--fast] \
        [--blocks B] [--epochs 50] [--device cpu]

Port of esn_ofdm_mimo_tpu/experiments/compare2x2.py: the same flags with the
same names and defaults, plus `--device` (default `cuda`, which raises
without a GPU; `cpu` runs everything in plain PyTorch). BER against Eb/N0
for ESN / Perfect-ZF / LS-ZF / MMSE / CNN / RNN / FNN / ELM on mimo_2x2_nbf
(uncoded), B blocks an SNR, one call of `parallel/montecarlo.py:
make_zoo_step` an SNR: on the card the captured `zoo.round` graph, the GRU
trained by K7, replayed for every SNR after the first captures it. It
writes the reference's artifacts (:685-717):
BERvsEBNo_esn_all_ml_model.pkl ({"EBN0", "BER"}), NMSE_compare.pkl
({"EBN0", "NMSE_train", "NMSE_test"}, means over blocks), events.jsonl
(run_start, one snr_done per SNR with each phase's ms: on the CPU every
phase's wall ms, on the card the device ms of esn_fit, detect, cnn, rnn,
fnn and elm; run_done) and, where matplotlib is installed,
ber_comparison_system_2.png.
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
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--outdir", default="results/compare_2x2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu (plain "
                         "PyTorch throughout)")
    args = ap.parse_args(argv)

    import torch

    from ..parallel import make_zoo_step
    from ..pipelines.zoo2x2 import host_zoo
    from ..utils import rng
    from ..utils.device import resolve_device
    from ..utils.metrics import MetricsLogger
    from .presets import mimo_2x2_nbf

    dev = resolve_device(args.device)
    cfg = mimo_2x2_nbf(fast=args.fast)
    cfg = dataclasses.replace(
        cfg, ldpc=dataclasses.replace(cfg.ldpc, enabled=False))
    blocks = args.blocks or (4 if args.fast else 16)

    os.makedirs(args.outdir, exist_ok=True)
    log = MetricsLogger(os.path.join(args.outdir, "events.jsonl"))
    log.log("run_start", blocks=blocks, epochs=args.epochs, device=str(dev))
    t0 = time.time()
    root = rng.prng_key(args.seed, dev)
    step = make_zoo_step(cfg, dev, epochs=args.epochs)
    ber, nmse_train, nmse_test = {}, {}, {}
    for jj, ebno in enumerate(cfg.ebno_db):
        keys = rng.block_keys(root, jj, torch.arange(blocks, device=dev))
        phases: dict = {}
        out = host_zoo(step(ebno, keys, phases))
        for k, v in out.bit_errors.items():
            ber.setdefault(k, []).append(v / out.total_bits)
        nb = max(out.n_blocks, 1)
        for k, v in out.train_nmse.items():
            nmse_train.setdefault(k, []).append(v / nb)
        for k, v in out.test_nmse.items():
            nmse_test.setdefault(k, []).append(v / nb)
        log.log("snr_done", ebno_db=ebno,
                ms={k: round(v, 3) for k, v in phases.items()})
        print(f"[2x2] EbNo={ebno:g}: " + " ".join(
            f"{k}={ber[k][-1]:.4g}" for k in sorted(ber)), flush=True)

    log.log("run_done", seconds=round(time.time() - t0, 1),
            outdir=args.outdir)
    log.close()
    with open(os.path.join(args.outdir, "BERvsEBNo_esn_all_ml_model.pkl"),
              "wb") as f:
        pickle.dump({"EBN0": list(cfg.ebno_db), "BER": ber}, f)
    # per-model train and test NMSE, the reference's NMSE_compare.pkl
    # (Demo_MIMO_2x2_all_DL_model_comparion.py:577-598)
    with open(os.path.join(args.outdir, "NMSE_compare.pkl"), "wb") as f:
        pickle.dump({"EBN0": list(cfg.ebno_db),
                     "NMSE_train": nmse_train, "NMSE_test": nmse_test}, f)
    _plot(args.outdir, cfg.ebno_db, ber)


def _plot(outdir, ebnos, ber) -> None:
    """The BER curves, best-effort as in the JAX package: a missing
    matplotlib or a plotting error skips the figure with a warning."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(9, 6))
        for k in sorted(ber):
            plt.semilogy(ebnos, np.maximum(ber[k], 1e-8), "o-", label=k)
        plt.grid(True, which="both", ls=":")
        plt.xlabel("E_b/N_0 [dB]")
        plt.ylabel("BER")
        plt.legend()
        plt.title("2x2 block fading: ESN vs model zoo vs classical")
        plt.tight_layout()
        fig.savefig(os.path.join(outdir, "ber_comparison_system_2.png"),
                    dpi=150)
        plt.close(fig)
    except Exception as e:  # noqa: BLE001 - the figure is best-effort
        print(f"[warn] plotting skipped (best-effort): {e}")


if __name__ == "__main__":
    main()
