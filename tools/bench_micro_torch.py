"""Micro-benchmarks of the PyTorch/CUDA port's flagship hot phases, each
isolated: the counterpart of tools/bench_micro.py for
esn_ofdm_mimo_tpu_torch.

Groups, on the flagship shapes (128 blocks, D = 74 symbols, n_res = 300,
T = 138): key folding and tap draw (`base`), random bits and AWGN (`bits`),
the ablation builds of the ESN predict recurrence (`pred`, the CUDA kernel
csrc/esn_predict_ablate.cu through models/esn_cuda.esn_predict_ablate_cuda),
and the equaliser apply (`eq`). Every variant is run ROUNDS times after one
warm-up and reported as ms per round between two CUDA events, one line per
variant: `name  ms/round`.

Run: python tools/bench_micro_torch.py [group ...] [--blocks N] [--device D]
groups: base bits pred eq (default: all). It runs on the GPU; --device cpu
runs the plain PyTorch versions against the host clock (a check that the
tool works, not a measurement of the card; use a small --blocks).

The six `pred` variants keep the names of the JAX tool. There `merged`,
`hoist_win` and `unroll` choose how the TPU schedules one function; the
port's kernel always contracts the one stacked weight [W; W_in; W_fb], so
on the card every "merged"/"cur" variant times the same full build, and the
tool says so. Beside them it times each single-part-off build.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from esn_ofdm_mimo_tpu_torch.experiments.presets import (  # noqa: E402
    mimo_4x8_cdl)
from esn_ofdm_mimo_tpu_torch.models import esn_cuda  # noqa: E402
from esn_ofdm_mimo_tpu_torch.models.esn import (  # noqa: E402
    ABLATE_PARTS, EsnReservoir, EsnScale)
from esn_ofdm_mimo_tpu_torch.ops import (  # noqa: E402
    awgn, taps_to_freq_response)
from esn_ofdm_mimo_tpu_torch.ops.equalize import apply_equalizer  # noqa: E402
from esn_ofdm_mimo_tpu_torch.pipelines import common as c  # noqa: E402
from esn_ofdm_mimo_tpu_torch.utils import rng  # noqa: E402
from esn_ofdm_mimo_tpu_torch.utils.device import resolve_device  # noqa: E402

ROUNDS = 8

# ---------------------------------------------------------------- shapes
D = 74                       # data symbols per block
N, CP, DELAY = 128, 7, 3
N_TX, N_RX, M = 4, 8, 4
N_RES = 300
T = N + CP + DELAY
N_IN, N_OUT = 2 * N_RX, 2 * N_TX

# the JAX tool's predict variants: name -> the parts switched off
_FLOOR = frozenset(ABLATE_PARTS)
PRED_VARIANTS = (
    ("pred merged io-dot", frozenset()),
    ("pred merged unroll2", frozenset()),
    ("pred merged unroll4", frozenset()),
    ("pred merged unroll8", frozenset()),
    ("pred floor unroll4", _FLOOR),
    ("pred cur unroll4", frozenset()),
)


def timed(name: str, fn, dev: torch.device, rounds: int = ROUNDS) -> float:
    """ms per round of fn(): CUDA events on the card, the host clock on the
    CPU. Prints the JAX tool's line."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(rounds):
            fn()
        e1.record()
        torch.cuda.synchronize(dev)
        ms = e0.elapsed_time(e1) / rounds
    else:
        t0 = time.perf_counter()
        for _ in range(rounds):
            fn()
        ms = 1e3 * (time.perf_counter() - t0) / rounds
    print(f"{name:28s} {ms:8.2f} ms/round", flush=True)
    return ms


def pred_operands(n_blocks: int, dev: torch.device, seed: int = 1):
    """The JAX tool's predict operands in the port's layout: a reservoir of
    N(0, 0.05^2) recurrence weights (the tool draws them, it does not scale
    a spectral radius), one dense readout per row (G == B), unit scales,
    n_forget 0, state-noise amplitude 1e-3."""
    B = n_blocks * D
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def normal(*shape, std=1.0):
        return std * torch.randn(*shape, generator=g, device=dev)

    res = EsnReservoir(Wt=normal(N_RES, N_RES, std=0.05),
                       W_in_t=normal(N_IN, N_RES, std=0.01),
                       W_fb_t=normal(N_OUT, N_RES, std=1e-6), noise=1e-3)
    scale = EsnScale(input_scaling=1.0, input_shift=0.0, teacher_scaling=1.0)
    return res, scale, normal(B, N_RES + N_IN, N_OUT), normal(B, T, N_IN)


def run_pred_variants(n_blocks: int, dev: torch.device, rounds: int = ROUNDS
                      ) -> dict:
    """Time the ablation builds; returns {variant name: ms per round}."""
    res, scale, Wt_out, u = pred_operands(n_blocks, dev)

    def call(off):
        switches = {p: p not in off for p in ABLATE_PARTS}
        return lambda: esn_cuda.esn_predict_ablate_cuda(
            res, scale, Wt_out, u, 0, 0, **switches)

    print("pred: merged / hoist_win / unroll are TPU scheduling choices of "
          "one function; here the merged and cur variants all time the "
          "same full build", flush=True)
    out = {name: timed(name, call(off), dev, rounds)
           for name, off in PRED_VARIANTS}
    for part in ABLATE_PARTS:
        name = f"pred no {part}"
        out[name] = timed(name, call(frozenset((part,))), dev, rounds)
    return out


def run_base(cfg, bkeys, dev):
    timed("empty (fold only)", lambda: rng.fold_in(bkeys, 1).sum(), dev)
    timed("taps draw",
          lambda: c._draw_taps(cfg, rng.fold_in(bkeys, 1)).abs().sum(), dev)
    timed("taps + freq response", lambda: taps_to_freq_response(
        c._draw_taps(cfg, rng.fold_in(bkeys, 1)), N).abs().sum(), dev)


def run_bits(bkeys, dev):
    shape = (D, N_TX, N * M // 2)        # info bits per block (rate 1/2)
    timed(f"bits bernoulli {shape}",
          lambda: c._vbits(rng.fold_in(bkeys, 8), shape).sum(), dev)

    def unpack32():
        # one 32-bit draw per 32 bits instead of one uniform per bit
        n = int(np.prod(shape))
        w = rng.random_bits(rng.fold_in(bkeys, 8), (-(-n // 32),))
        b = (w[..., None] >> torch.arange(32, device=w.device)) & 1
        return b.reshape(w.shape[0], -1)[:, :n].to(torch.int8).sum()
    timed(f"bits unpack32 {shape}", unpack32, dev)
    timed("awgn draw (D,8,135)", lambda: awgn(
        rng.fold_in(bkeys, 9), (D, N_RX, N + CP), 1e-5, N + CP).abs().sum(),
        dev)


def run_eq_variants(n_blocks: int, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(2)

    def cplx(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=dev),
                             torch.randn(*shape, generator=g, device=dev))

    W = cplx(n_blocks, N, N_TX, N_RX)
    Y = cplx(n_blocks, D, N_RX, N)
    timed("eq apply (batched matmul)",
          lambda: apply_equalizer(W, Y, 1.0).abs().sum(), dev)
    timed("eq apply (einsum)",
          lambda: torch.einsum("bnij,bdjn->bdni", W, Y).abs().sum(), dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("groups", nargs="*", metavar="group",
                    help="base bits pred eq (default: all)")
    ap.add_argument("--blocks", type=int, default=128,
                    help="coherence blocks (default 128, the flagship round)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    known = {"base", "bits", "pred", "eq"}
    groups = set(args.groups) or known
    if groups - known:
        ap.error(f"unknown group(s) {sorted(groups - known)}")
    dev = resolve_device(args.device)
    cfg = mimo_4x8_cdl()
    bkeys = rng.block_keys(rng.prng_key(0, dev), 0,
                           torch.arange(args.blocks, device=dev))
    what = torch.cuda.get_device_name(dev) if dev.type == "cuda" else \
        "cpu (host clock: not a device time)"
    print(f"B={args.blocks} blocks x D={D} syms, T={T}, n_res={N_RES}, "
          f"rounds={ROUNDS} dev={what}")
    if "base" in groups:
        run_base(cfg, bkeys, dev)
    if "bits" in groups:
        run_bits(bkeys, dev)
    if "pred" in groups:
        run_pred_variants(args.blocks, dev)
    if "eq" in groups:
        run_eq_variants(args.blocks, dev)


if __name__ == "__main__":
    main()
