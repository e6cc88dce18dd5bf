"""Result reporting: CSV / pickle / PNG outputs (port of
esn_ofdm_mimo_tpu/utils/reporting.py: the same file names, CSV headers and
row formats, pickle bundle keys and calibration text lines), mirroring the
reference's artifact formats and figure families:

  * combined BER_curves.png (ours)
  * per-run pre-LDPC / post-LDPC / ESN-pre-vs-post figures
    (reference OFDM_SISO_NBF_LDPC.py:536-575 styles and filenames)
  * channel capacity / rank figures ({siso,simo}_channel_capacity.png,
    mimo_channel_rank_info.png — committed at
    results/results_block_fading_*_12DB_train/)
  * channel_metrics_{tag}.pkl with capacity / frac-rank / cond p50+p90
    (reference :525-534)
  * CDL uncoded-coded overlay (Demo_MIMO_4x8_Sionna_CDL_ESN_v2.py:537-553)

All figure functions draw from the results_ber.pkl bundle dict, so a finished
run can regenerate its figure set without re-simulating. matplotlib is
optional: without it the PNGs are skipped and the CSV, pickle and text files
are the whole output."""
from __future__ import annotations

import csv
import os
import pickle
import numpy as np

# reference line styles per detector (OFDM_SISO_NBF_LDPC.py:538-571)
_NBF_STYLES = {
    "zf_perfect": ("kx-", "Perfect ZF"),
    "mmse": ("rs-.", "MMSE"),
    "zf_ls": ("o-", "LS ZF"),
    "zf": ("o-", "ZF"),
    "ls": ("c+-", "LS"),
    "esn": ("gd--", "ESN matched"),
    "esn_fixed": ("b^:", "ESN @ fixed train SNR"),
}


def _style(d):
    return _NBF_STYLES.get(d, ("-", d))


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:
        return None


def _tag(bundle: dict) -> str:
    meta = bundle.get("meta", {})
    return f"{meta.get('N_t', 1)}x{meta.get('N_r', 1)}"


def cond_percentiles_from_hist(cond_hist, bins, qs=(50.0, 90.0)):
    """Percentiles of the condition-number distribution from the summed
    log10 histogram (pipelines/blockfading.COND_BINS edges): the counters
    keep a histogram rather than samples so they stay mergeable across
    rounds; percentiles interpolate on the log-bin midpoints."""
    h = np.asarray(cond_hist, dtype=np.float64)
    edges = np.concatenate([[1.0], np.asarray(bins, dtype=np.float64)])
    mids = np.sqrt(edges[:-1] * edges[1:])          # log-midpoints
    mids = np.concatenate([mids, [edges[-1]]])      # overflow bin -> top edge
    out = []
    for q in qs:
        if h.sum() == 0:
            out.append(float("nan"))
            continue
        c = np.cumsum(h) / h.sum()
        out.append(float(mids[int(np.searchsorted(c, q / 100.0))]))
    return out


def nbf_figures(outdir: str, bundle: dict) -> None:
    """The reference's per-run NBF figure families from a results_ber.pkl
    bundle: pre-LDPC, post-LDPC, ESN pre-vs-post, capacity/rank."""
    plt = _plt()
    if plt is None:
        return
    ebno = np.asarray(bundle["EBN0"], dtype=float)
    ber = {d: np.asarray(v, float) for d, v in bundle["BER_uncoded"].items()}
    berc = {d: np.asarray(v, float)
            for d, v in bundle.get("BER_coded", {}).items()}
    tag = _tag(bundle)

    def _curves(data, suffix, ylab, title):
        fig = plt.figure()
        for d in sorted(data):
            sty, lab = _style(d)
            plt.semilogy(ebno, np.maximum(data[d], 1e-8), sty,
                         label=f"{lab} ({suffix})")
        plt.legend()
        plt.grid(True, which="both", ls=":")
        plt.xlabel("E_b/N_0 [dB]")
        plt.ylabel(ylab)
        plt.title(title)
        plt.tight_layout()
        return fig

    fig = _curves(ber, "pre-LDPC", "Bit Error Rate",
                  f"{tag} | Pre-LDPC BER (code bits)")
    fig.savefig(os.path.join(outdir, f"BER_preLDPC_{tag}.png"), dpi=150)
    plt.close(fig)

    if berc and any(np.any(v > 0) for v in berc.values()):
        fig = _curves(berc, "post-LDPC", "BER (info bits)",
                      f"{tag} | Post-LDPC BER")
        fig.savefig(os.path.join(outdir, f"BER_postLDPC_{tag}.png"), dpi=150)
        plt.close(fig)

        # ESN pre- vs post-LDPC (reference :563-574)
        fig = plt.figure()
        for d, pre_sty, post_sty in (("esn", "gd--", "g*-"),
                                     ("esn_fixed", "b^:", "b*-")):
            if d in ber:
                _, lab = _style(d)
                plt.semilogy(ebno, np.maximum(ber[d], 1e-8), pre_sty,
                             label=f"{lab} (pre-LDPC)")
            if d in berc:
                _, lab = _style(d)
                plt.semilogy(ebno, np.maximum(berc[d], 1e-8), post_sty,
                             label=f"{lab} (post-LDPC)")
        plt.grid(True, which="both", ls=":")
        plt.legend()
        plt.xlabel("E_b/N_0 [dB]")
        plt.ylabel("Bit Error Rate")
        plt.title("ESN: Pre- vs Post-LDPC")
        plt.tight_layout()
        fig.savefig(os.path.join(outdir, f"BER_ESN_pre_vs_postLDPC_{tag}.png"),
                    dpi=150)
        plt.close(fig)

    # capacity / rank figures (committed reference artifacts:
    # siso_channel_capacity.png, mimo_channel_rank_info.png)
    cap = np.asarray(bundle.get("capacity_bits_per_sc", []), dtype=float)
    if cap.size:
        meta = bundle.get("meta", {})
        n_tx, n_rx = meta.get("N_t", 1), meta.get("N_r", 1)
        mimo = min(n_tx, n_rx) > 1
        fig = plt.figure()
        plt.plot(ebno, cap, "mo-", ms=4, label="Avg. capacity per subcarrier")
        ylab = "Capacity [bits/s/Hz per subcarrier]"
        if mimo:
            frk = np.asarray(bundle["frac_rank_ge_full"], dtype=float)
            plt.plot(ebno, frk, "co-", ms=4,
                     label=f"Frac. rank >= {min(n_tx, n_rx)}")
            ylab = "Capacity [bits/s/Hz] / Fraction"
            title = f"{tag} MIMO: Capacity & usable rank"
            name = "mimo_channel_rank_info.png"
        else:
            kind = "SIMO" if n_rx > 1 else "SISO"
            title = f"{kind} capacity (from |H_k|, same channel ensemble)"
            name = f"{kind.lower()}_channel_capacity.png"
        plt.grid(True, ls=":")
        plt.legend()
        plt.xlabel("E_b/N_0 [dB]")
        plt.ylabel(ylab)
        plt.title(title)
        plt.tight_layout()
        fig.savefig(os.path.join(outdir, name), dpi=150)
        plt.close(fig)


def cdl_overlay_figure(outdir: str, bundle: dict) -> None:
    """The reference flagship's uncoded/coded overlay
    (Demo_MIMO_4x8_Sionna_CDL_ESN_v2.py:537-553 styles/filename)."""
    plt = _plt()
    if plt is None:
        return
    ebno = np.asarray(bundle["EBN0"], dtype=float)
    unc = bundle["BER_uncoded"]
    cod = bundle["BER_coded"]
    fig = plt.figure(figsize=(9, 6))
    plt.semilogy(ebno, np.maximum(np.asarray(unc["MMSE"], float), 1e-8),
                 "rs-.", label="MMSE (uncoded)")
    plt.semilogy(ebno, np.maximum(np.asarray(unc["ESN"], float), 1e-8),
                 "g^--", label="ESN (uncoded)")
    plt.semilogy(ebno, np.maximum(np.asarray(cod["MMSE_calLLR"], float),
                                  1e-8),
                 "r*-", label="MMSE + LDPC (calibrated LLRs)")
    plt.semilogy(ebno, np.maximum(np.asarray(cod["ESN_calLLR"], float),
                                  1e-8),
                 "g*-", label="ESN + LDPC (calibrated LLRs)")
    plt.grid(True, which="both", ls=":")
    plt.xlabel("E_b/N_0 [dB]")
    plt.ylabel("BER (bit or info-bit)")
    plt.title("4x8 MIMO — Uncoded vs Coded (LDPC) with LLR Calibration\n"
              "MMSE vs ESN — CDL-B (TDL) Channel + PA")
    plt.legend()
    plt.tight_layout()
    fig.savefig(os.path.join(outdir, "BER_uncoded_coded_overlay_MMSE_ESN.png"),
                dpi=150, bbox_inches="tight")
    plt.close(fig)


def save_nbf_results(outdir: str, cfg, res) -> None:
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "results_ber.csv"), "w", newline="") as f:
        w = csv.writer(f)
        dets = sorted(res.ber.keys())
        w.writerow(["EbNo(dB)"] + [f"{d}_uncoded" for d in dets]
                   + [f"{d}_coded" for d in dets])
        for i, snr in enumerate(res.ebno_db):
            w.writerow([float(snr)] + [res.ber[d][i] for d in dets]
                       + [res.ber_coded[d][i] for d in dets])
    bundle = {
        "EBN0": res.ebno_db.tolist(),
        "BER_uncoded": {d: v.tolist() for d, v in res.ber.items()},
        "BER_coded": {d: v.tolist() for d, v in res.ber_coded.items()},
        "capacity_bits_per_sc": res.capacity_per_sc.tolist(),
        "frac_rank_ge_full": res.frac_rank_full.tolist(),
        "cond_hist": res.cond_hist.tolist(),
        "ldpc_avg_iters": {d: v.tolist()
                           for d, v in res.ldpc_avg_iters.items()},
        "ldpc_unconverged_frac": {
            d: v.tolist() for d, v in res.ldpc_unconverged_frac.items()},
        "meta": {"name": cfg.name, "N": cfg.ofdm.n_subcarriers,
                 "N_t": cfg.channel.n_tx, "N_r": cfg.channel.n_rx,
                 "reservoir": cfg.esn.n_reservoir},
    }
    with open(os.path.join(outdir, "results_ber.pkl"), "wb") as f:
        pickle.dump(bundle, f)
    # channel metrics pkl (reference OFDM_SISO_NBF_LDPC.py:525-534 schema)
    from ..pipelines.blockfading import COND_BINS
    p50, p90 = zip(*[cond_percentiles_from_hist(h, COND_BINS)
                     for h in res.cond_hist])
    metrics = {
        "EBN0": res.ebno_db.tolist(),
        "capacity_bits_per_sc": res.capacity_per_sc.tolist(),
        "frac_rank_ge_full": res.frac_rank_full.tolist(),
        "cond_number": {"p50": list(p50), "p90": list(p90)},
        "notes": "Rank and conditioning computed from per-subcarrier SVD "
                 "of true H_k.",
    }
    tag = _tag(bundle)
    with open(os.path.join(outdir, f"channel_metrics_{tag}.pkl"), "wb") as f:
        pickle.dump(metrics, f)
    _plot_curves(outdir, res.ebno_db, res.ber, res.ber_coded, cfg.name)
    nbf_figures(outdir, bundle)


def save_cdl_results(outdir: str, cfg, results: list) -> None:
    os.makedirs(outdir, exist_ok=True)
    ebno = [r["ebno_db"] for r in results]
    dets = sorted(results[0]["ber_uncoded"].keys())
    with open(os.path.join(outdir, "results_ber.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["EbNo(dB)", "ESN_uncoded", "MMSE_uncoded",
                    "ESN_coded", "MMSE_coded"])
        for r in results:
            w.writerow([r["ebno_db"], r["ber_uncoded"]["esn"],
                        r["ber_uncoded"]["mmse"], r["ber_coded"]["esn"],
                        r["ber_coded"]["mmse"]])
    for r in results:
        p = os.path.join(outdir,
                         f"LLR_calibration_params_EbNo{int(r['ebno_db'])}dB.txt")
        with open(p, "w") as f:
            f.write("bit, a_esn, b_esn, a_mmse, b_mmse\n")
            a_e, b_e = r["calib"]["esn"]
            a_m, b_m = r["calib"]["mmse"]
            for b in range(len(a_e)):
                f.write(f"{b}, {a_e[b]:.4f}, {b_e[b]:.4f}, "
                        f"{a_m[b]:.4f}, {b_m[b]:.4f}\n")
    bundle = {
        "EBN0": ebno,
        "BER_uncoded": {d.upper(): [r["ber_uncoded"][d] for r in results]
                        for d in dets},
        "BER_coded": {d.upper() + "_calLLR": [r["ber_coded"][d] for r in results]
                      for d in dets},
    }
    with open(os.path.join(outdir, "results_ber.pkl"), "wb") as f:
        pickle.dump(bundle, f)
    ber = {d: np.array([r["ber_uncoded"][d] for r in results]) for d in dets}
    berc = {d: np.array([r["ber_coded"][d] for r in results]) for d in dets}
    _plot_curves(outdir, np.array(ebno), ber, berc, cfg.name)
    cdl_overlay_figure(outdir, bundle)


def _plot_curves(outdir, ebno, ber, ber_coded, title) -> None:
    plt = _plt()
    if plt is None:
        return
    fig = plt.figure(figsize=(9, 6))
    for d, v in sorted(ber.items()):
        plt.semilogy(ebno, np.maximum(v, 1e-8), "--", marker="o",
                     label=f"{d} (uncoded)")
    for d, v in sorted(ber_coded.items()):
        if np.any(v > 0):
            plt.semilogy(ebno, np.maximum(v, 1e-8), "-", marker="*",
                         label=f"{d} (coded)")
    plt.grid(True, which="both", ls=":")
    plt.xlabel("E_b/N_0 [dB]")
    plt.ylabel("BER")
    plt.title(title)
    plt.legend()
    plt.tight_layout()
    fig.savefig(os.path.join(outdir, "BER_curves.png"), dpi=150)
    plt.close(fig)
