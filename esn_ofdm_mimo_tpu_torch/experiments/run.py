"""CLI experiment runner of the port.

    python -m esn_ofdm_mimo_tpu_torch.experiments.run --preset mimo_4x8_cdl \
        --blocks-per-snr 16 --outdir results/mimo_4x8_cdl [--fast] [--resume]

Port of esn_ofdm_mimo_tpu/experiments/run.py: the same flags with the same
names and defaults, one runner over the preset registry. A preset with
calibration runs `run_cdl_curve` and writes `save_cdl_results`, the others
`run_nbf_curve` and `save_nbf_results`; progress goes to
`<outdir>/events.jsonl`. It runs on the GPU; `--device cpu` runs the plain
PyTorch versions of the kernels (with `--fast`, a few minutes).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from ..parallel.montecarlo import run_cdl_curve, run_nbf_curve
from ..utils.checkpoint import SnrCheckpoint
from ..utils.device import resolve_device
from ..utils.metrics import MetricsLogger, debug_nan_checks, profile_trace
from ..utils.reporting import save_cdl_results, save_nbf_results
from .presets import PRESETS, get_preset


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", required=True, choices=sorted(PRESETS))
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--blocks-per-snr", type=int, default=None,
                    help="Monte-Carlo blocks per SNR point "
                         "(default: reference-equivalent count)")
    ap.add_argument("--blocks-per-device", type=int, default=16,
                    help="coherence blocks per round on the one GPU; BER "
                         "is layout-invariant by key design")
    ap.add_argument("--rounds-per-call", type=int, default=4,
                    help="Monte-Carlo rounds per call of an SNR point: the "
                         "rounds one adaptive top-up step adds, and the "
                         "rounds whose LLRs one BP launch decodes")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--ldpc-algo",
                    choices=("sumprod", "minsum", "offset-minsum"),
                    default=None,
                    help="override the BP check rule (default: preset's; "
                         "sumprod = pyldpc parity, minsum = normalised "
                         "min-sum, offset-minsum = offset min-sum)")
    ap.add_argument("--ldpc-minsum-scale", type=float, default=None,
                    help="normalisation scale for --ldpc-algo minsum "
                         "(default: preset's, 0.75)")
    ap.add_argument("--ldpc-minsum-offset", type=float, default=None,
                    help="offset beta for --ldpc-algo offset-minsum "
                         "(default: preset's, 0.625)")
    ap.add_argument("--ldpc-family", choices=("gallager", "qc", "pyldpc"),
                    default=None,
                    help="override the code family (pyldpc = the "
                         "construction of pyldpc, decoded on its full-row "
                         "graph; gallager and pyldpc decode with plain "
                         "PyTorch BP, qc with the BP kernels)")
    ap.add_argument("--ldpc-seed", type=int, default=None,
                    help="override the code construction seed")
    ap.add_argument("--esn-target", choices=("pre_pa", "post_pa"),
                    default=None,
                    help="ESN training-target waveform: pre_pa = reference-"
                         "exact (clean TX before the Rapp PA), post_pa = PA "
                         "output. Default: preset's (post_pa)")
    ap.add_argument("--adaptive-min-errors", type=int, default=None,
                    help="sequential MC: keep simulating extra blocks at "
                         "each SNR until every detector has this many "
                         "FAILED CODEWORDS (frame errors: coded bit errors "
                         "cluster per codeword), or the "
                         "--adaptive-max-blocks cap: concentrates blocks at "
                         "the waterfall and the deep tails")
    ap.add_argument("--adaptive-on-uncoded", action="store_true",
                    help="stop adaptive sampling on UNCODED bit errors even "
                         "with LDPC enabled, for deep uncoded floors in "
                         "coded presets")
    ap.add_argument("--adaptive-max-blocks", type=int, default=None,
                    help="cap on decoded blocks per SNR for "
                         "--adaptive-min-errors (default 4x blocks-per-snr)")
    ap.add_argument("--ebno-list", default=None,
                    help="comma-separated Eb/N0 grid override (dB), e.g. a "
                         "fine 1 dB grid around the waterfall")
    ap.add_argument("--channel-kind", default=None,
                    choices=("exp_pdp", "cdl_a", "cdl_b", "cdl_c",
                             "awgn_flat"),
                    help="channel-profile override (38.901 TDL-A/-C beside "
                         "the reference's exp-PDP and TDL-B, and the flat "
                         "AWGN channel of siso_qpsk_awgn)")
    ap.add_argument("--qam-bits", type=int, default=None,
                    help="bits per QAM symbol override (any even m, e.g. 6 "
                         "for 64-QAM)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from per-SNR checkpoints in outdir")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="record a torch.profiler trace of the whole curve "
                         "run into DIR (Chrome trace format; tracing adds "
                         "overhead: profiling runs only)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="fail at the first non-finite LLR entering a "
                         "calibrator fit or a decode (synchronises the "
                         "device: debugging runs only)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu (the "
                         "kernels' plain PyTorch versions)")
    return ap


def main(argv=None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.qam_bits is not None and (args.qam_bits < 2 or args.qam_bits % 2):
        ap.error("--qam-bits must be a positive even integer "
                 "(square QAM constellations only)")

    cfg = get_preset(args.preset, fast=args.fast)
    replace = dataclasses.replace
    if args.ebno_list is not None:
        cfg = replace(cfg, ebno_db=tuple(float(x)
                                         for x in args.ebno_list.split(",")))
    if args.channel_kind is not None:
        cfg = replace(cfg, channel=replace(cfg.channel,
                                           kind=args.channel_kind))
    if args.qam_bits is not None:
        cfg = replace(cfg, ofdm=replace(cfg.ofdm,
                                        bits_per_symbol=args.qam_bits))
    if args.esn_target is not None:
        cfg = replace(cfg, esn=replace(cfg.esn,
                                       target_waveform=args.esn_target))
    ldpc = {field: value for field, value in (
        ("algo", args.ldpc_algo), ("minsum_scale", args.ldpc_minsum_scale),
        ("minsum_offset", args.ldpc_minsum_offset),
        ("family", args.ldpc_family), ("seed", args.ldpc_seed))
        if value is not None}
    if ldpc:
        cfg = replace(cfg, ldpc=replace(cfg.ldpc, **ldpc))
    device = resolve_device(args.device)

    outdir = args.outdir or f"results/{cfg.name}"
    blocks = args.blocks_per_snr or cfg.n_blocks
    ckpt = SnrCheckpoint(outdir + "/ckpt") if args.resume else None

    log = MetricsLogger(f"{outdir}/events.jsonl")
    try:
        log.log("run_start", preset=cfg.name, blocks_per_snr=blocks,
                devices=1, L=cfg.ofdm.coherence_symbols)
        t0 = time.time()
        curve_args = dict(
            blocks_per_round=args.blocks_per_device, seed=args.seed,
            device=device, checkpoint=ckpt,
            progress=lambda msg: log.log("progress", msg=msg),
            rounds_per_call=args.rounds_per_call,
            adaptive_min_errors=args.adaptive_min_errors,
            adaptive_max_blocks=args.adaptive_max_blocks,
            adaptive_on_uncoded=args.adaptive_on_uncoded)
        with debug_nan_checks(args.debug_nans), \
                profile_trace(f"curve:{cfg.name}", trace_dir=args.trace):
            if cfg.calib.enabled:
                save_cdl_results(outdir, cfg,
                                 run_cdl_curve(cfg, blocks, **curve_args))
            else:
                save_nbf_results(outdir, cfg,
                                 run_nbf_curve(cfg, blocks, **curve_args))
        log.log("run_done", seconds=round(time.time() - t0, 1),
                outdir=outdir)
    finally:
        log.close()


if __name__ == "__main__":
    main()
