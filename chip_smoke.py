#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (esn_ofdm_mimo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from esn_ofdm_mimo_tpu_torch/csrc/ (nvcc,
sm_90a, at first use), then:

  1. prints the card (nvidia-smi name and power limit) and the build time;
  2. K1, the BP decoder (csrc/bp_decode.cu), against its plain PyTorch
     version on 75,776 AWGN codewords of the flagship code at two Eb/N0:
     identical bits, iterations, converged flags and counts for offset
     min-sum (the flagship rule) and normalised min-sum; sum-product within
     the agreement band of the JAX package's own kernel test;
  3. K2, the ESN predict recurrence (csrc/esn_predict.cu), against its plain
     version at the flagship detect shape (9,472 rows, T = 138, n_res = 300,
     128 readouts of 74 rows): noise 0 within atol 1e-4 / rtol 1e-3, noise
     1e-3 within the plain version's own noise band;
  4. a small reference check: the tiny CDL configuration through
     `cdl_snr_point` on the GPU (kernels) and on the CPU (plain versions),
     MMSE counters within a few bit flips;
  5. the main path: `cdl_snr_point` on the flagship `mimo_4x8_cdl` at full
     width (N = 128, 4x8, n_res = 300, D = 74, n = 512), 128 blocks, one
     calibration and one decode round at 12 dB, with both kernels' launch
     counts reset just before and read just after;
  6. one JSON line listing the kernels (launches on the main path, error
     against the plain version, times, bound), then the card line and the
     final {"ok": true, ...} line.

Every phase ends in torch.cuda.synchronize(); any failure exits non-zero
before the final line. Without CUDA it exits 1 and prints no result.

--profile adds one more main-path run under torch.profiler and prints the
device time by kernel and the device's busy share of the run's wall time.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) FLOP/s
_HBM_BYTES_PER_S = 3.35e12
_FP32_FLOP_PER_S = 67e12


def _fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond, msg: str):
    if not cond:
        _fail(msg)


def _log(msg: str):
    print(msg, flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke run needs a GPU")

    from esn_ofdm_mimo_tpu_torch import config as tc
    from esn_ofdm_mimo_tpu_torch.experiments.presets import mimo_4x8_cdl
    from esn_ofdm_mimo_tpu_torch.ldpc import decode_cuda, ldpc_encode, \
        make_code
    from esn_ofdm_mimo_tpu_torch.ldpc.decode import ldpc_decode_bp_plain
    from esn_ofdm_mimo_tpu_torch.models import esn_cuda
    from esn_ofdm_mimo_tpu_torch.models.esn import (EsnScale, esn_predict,
                                                    init_reservoir)
    from esn_ofdm_mimo_tpu_torch.parallel import cdl_snr_point
    from esn_ofdm_mimo_tpu_torch.utils import build, rng

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    def cuda_ms(fn, reps: int) -> float:
        """Mean ms per call over `reps` calls after one warm-up call."""
        fn()
        sync()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        sync()
        return e0.elapsed_time(e1) / reps

    # ---- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(f"[device] {smi} | torch {torch.__version__} cuda "
         f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = build.build_all()
    _log(f"[build] {json.dumps({k: round(v, 2) for k, v in built.items()})} "
         f"total {time.perf_counter() - t0:.2f} s")

    cfg = mimo_4x8_cdl()
    kernels = {}

    # ---- 2. K1: BP decoder vs its plain version -----------------------------
    code = make_code(cfg.ldpc, cfg.ofdm.n_subcarriers * cfg.ofdm.bits_per_symbol)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n_half = 37_888                      # 2 x 37,888 = one flagship decode batch
    us, llrs = [], []
    for ebno in (1.5, 2.5):
        u = torch.randint(0, 2, (n_half, code.k), generator=gen, device=dev,
                          dtype=torch.int8)
        x = 1.0 - 2.0 * ldpc_encode(code, u).float()
        sigma2 = 1.0 / (2.0 * code.k / code.n * 10.0 ** (ebno / 10.0))
        y = x + sigma2 ** 0.5 * torch.randn(x.shape, generator=gen, device=dev)
        us.append(u)
        llrs.append((2.0 * y / sigma2).contiguous())
    u, llr = torch.cat(us), torch.cat(llrs)
    kw = dict(max_iter=cfg.ldpc.max_iter, algo=cfg.ldpc.algo,
              minsum_offset=cfg.ldpc.minsum_offset)
    bits_k, st_k = decode_cuda.ldpc_decode_bp_cuda(
        code, llr, pass1_iters=cfg.ldpc.pass1_iters, **kw)
    err_k, stc_k = decode_cuda.ldpc_decode_bp_cuda_counts(
        code, llr, u, pass1_iters=cfg.ldpc.pass1_iters, **kw)
    bits_p, st_p = ldpc_decode_bp_plain(code, llr, **kw)
    err_p, _ = ldpc_decode_bp_plain(code, llr, count_against=u, **kw)
    sync()
    _check(torch.equal(bits_k, bits_p), "K1 bits differ from the plain version")
    _check(torch.equal(st_k["iterations"], st_p["iterations"]),
           "K1 iterations differ from the plain version")
    _check(torch.equal(st_k["converged"], st_p["converged"]),
           "K1 converged flags differ from the plain version")
    _check(torch.equal(err_k.long(), err_p.long())
           and torch.equal(stc_k["iterations"], st_p["iterations"]),
           "K1 counts mode differs from the plain version")
    it_sum = int(st_k["iterations"].long().sum())
    conv_frac = float(st_k["converged"].float().mean())
    k1_ms = cuda_ms(lambda: decode_cuda.ldpc_decode_bp_cuda_counts(
        code, llr, u, pass1_iters=cfg.ldpc.pass1_iters, **kw), 3)
    k1_plain_ms = cuda_ms(lambda: ldpc_decode_bp_plain(
        code, llr, count_against=u, **kw), 1)
    # other check rules on a slice: min-sum exact, sum-product in the band of
    # the JAX kernel-vs-XLA test (tanh/atanh ulps differ)
    sub = slice(0, 4096)
    for algo, exact in (("minsum", True), ("sumprod", False)):
        kwa = dict(kw, algo=algo)
        bk, sk = decode_cuda.ldpc_decode_bp_cuda(code, llr[sub], **kwa)
        bp, sp = ldpc_decode_bp_plain(code, llr[sub], **kwa)
        sync()
        agree = float((bk == bp).float().mean())
        it_agree = float((sk["iterations"] == sp["iterations"]).float().mean())
        cv_agree = float((sk["converged"] == sp["converged"]).float().mean())
        _log(f"[K1 {algo}] bit agreement {agree} iterations {it_agree} "
             f"converged {cv_agree}")
        if exact:
            _check(agree == 1.0 and it_agree == 1.0 and cv_agree == 1.0,
                   f"K1 {algo} differs from the plain version")
        else:
            _check(agree > 0.999 and it_agree > 0.9 and cv_agree > 0.95,
                   f"K1 {algo} outside the agreement band")
    # bound: LLRs in + truth in + counts/stats out, and the check/variable
    # arithmetic of the iterations this data ran (13 fp32 ops per edge and
    # iteration: q = Lt - r, clip x2, |q|, min/second-min x2, sign, select,
    # offset, max, sign product, posterior add, parity)
    edges = code.dv * code.n
    k1_bytes = llr.numel() * 4 + u.numel() + llr.shape[0] * (4 + 4 + 1)
    k1_ops = 13.0 * edges * it_sum
    k1_bound = 1e3 * max(k1_bytes / _HBM_BYTES_PER_S, k1_ops / _FP32_FLOP_PER_S)
    kernels["bp_decode"] = dict(
        name="bp_decode", route="cuda",
        source="esn_ofdm_mimo_tpu_torch/csrc/bp_decode.cu",
        replaces="esn_ofdm_mimo_tpu/ldpc/decode_pallas.py:89",
        max_abs_err=0.0, ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound,
        bound_by="bytes" if k1_bytes / _HBM_BYTES_PER_S
        >= k1_ops / _FP32_FLOP_PER_S else "operations",
        library_ms=None)
    _log(f"[K1 offset-minsum] {llr.shape[0]} codewords at Eb/N0 1.5/2.5 dB: "
         f"bits, iterations, converged, counts identical | mean iterations "
         f"{it_sum / llr.shape[0]:.3f} converged {conv_frac:.4f} | kernel "
         f"{k1_ms:.3f} ms plain {k1_plain_ms:.3f} ms bound {k1_bound:.4f} ms")

    # ---- 3. K2: ESN predict vs its plain version ----------------------------
    n_res = cfg.esn.n_reservoir
    n_in, n_out = 2 * cfg.channel.n_rx, 2 * cfg.channel.n_tx
    G, Dg = 128, cfg.data_symbols_per_block
    delay = cfg.esn.shared_delay(cfg.ofdm.isi_duration)
    T = cfg.ofdm.n_subcarriers + cfg.ofdm.cp_len + delay
    n_forget = delay + cfg.ofdm.cp_len
    B = G * Dg
    res = init_reservoir(rng.prng_key(7, dev), n_in, n_out, n_res,
                         cfg.esn.spectral_radius, cfg.esn.sparsity, 0.0)
    scale = EsnScale(input_scaling=0.5, input_shift=0.0, teacher_scaling=1.0)
    inputs = torch.randn(B, T, n_in, generator=gen, device=dev)
    Wt_out = 0.02 * torch.randn(G, n_res + n_in, n_out, generator=gen,
                                device=dev)
    pk = esn_cuda.esn_predict_cuda(res, scale, Wt_out, inputs, n_forget, 0)
    pp = esn_predict(res, scale, Wt_out, inputs, n_forget)
    sync()
    k2_err = float((pk - pp).abs().max())
    _check(pk.shape == (B, T - n_forget, n_out) and bool(torch.isfinite(pk).all()),
           "K2 output has the wrong shape or is not finite")
    _check(torch.allclose(pk, pp, atol=1e-4, rtol=1e-3),
           f"K2 differs from the plain version (max abs err {k2_err})")
    noisy = res._replace(noise=1e-3)
    gn = torch.Generator(device=dev)
    gn.manual_seed(3)
    rms = lambda a: float(a.pow(2).mean().sqrt())                # noqa: E731
    r_k = rms(esn_cuda.esn_predict_cuda(noisy, scale, Wt_out, inputs,
                                        n_forget, 12345) - pp)
    r_p = rms(esn_predict(noisy, scale, Wt_out, inputs, n_forget, gn) - pp)
    _check(0.8 * r_p <= r_k <= 1.25 * r_p,
           f"K2 noise RMS {r_k} outside 0.8-1.25x the plain version's {r_p}")
    k2_ms = cuda_ms(lambda: esn_cuda.esn_predict_cuda(
        res, scale, Wt_out, inputs, n_forget, 0), 3)
    k2_plain_ms = cuda_ms(lambda: esn_predict(
        res, scale, Wt_out, inputs, n_forget), 2)
    # bound: inputs + weights in, outputs out; 2 flops per multiply-add of the
    # recurrence [W | W_in | W_fb] and the readout, plus tanh, per row-step
    k2_bytes = 4 * (inputs.numel() + Wt_out.numel() + pk.numel()
                    + n_res * (n_res + n_in + n_out))
    k2_ops = float(B) * T * (2 * n_res * (n_res + n_in + n_out)
                             + 2 * (n_res + n_in) * n_out + n_res)
    k2_bound = 1e3 * max(k2_bytes / _HBM_BYTES_PER_S, k2_ops / _FP32_FLOP_PER_S)
    kernels["esn_predict"] = dict(
        name="esn_predict", route="cuda",
        source="esn_ofdm_mimo_tpu_torch/csrc/esn_predict.cu",
        replaces="esn_ofdm_mimo_tpu/models/esn_pallas.py:101",
        max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound,
        bound_by="bytes" if k2_bytes / _HBM_BYTES_PER_S
        >= k2_ops / _FP32_FLOP_PER_S else "operations",
        library_ms=None)
    _log(f"[K2] rows {B} T {T} n_res {n_res} G {G} Dg {Dg}: max abs err "
         f"{k2_err:.3e} | noise RMS kernel {r_k:.4e} plain {r_p:.4e} | "
         f"kernel {k2_ms:.3f} ms plain {k2_plain_ms:.3f} ms bound "
         f"{k2_bound:.4f} ms ({k2_ops / 1e9:.1f} GFLOP)")

    # ---- 4. small reference check: GPU kernels vs CPU plain versions --------
    tiny = tc.SimConfig(
        name="cdl_tiny",
        ofdm=tc.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                           doppler_hz=3000.0),
        channel=tc.ChannelConfig(kind="cdl_b", n_tx=2, n_rx=4),
        esn=tc.EsnConfig(n_reservoir=40, train_ebno_fixed_db=None, noise=0.0),
        ldpc=tc.LdpcConfig(max_iter=8, family="qc", algo="offset-minsum"),
        calib=tc.CalibConfig(enabled=True), ebno_db=(12.0,))
    root = rng.prng_key(0)
    tk = rng.block_keys(root, 1, torch.arange(16)).reshape(2, 1, 8, 2)
    small = {d: cdl_snr_point(tiny, 20.0, tk[0].numpy(), tk[1].numpy(),
                              device=d) for d in ("cuda", "cpu")}
    sync()
    for name in ("mmse", "esn"):
        a, b = small["cuda"], small["cpu"]
        pairs = [(a.cal_bit_errors[name], b.cal_bit_errors[name]),
                 (a.counts.bit_errors[name], b.counts.bit_errors[name]),
                 (a.counts.info_errors[name], b.counts.info_errors[name])]
        _log(f"[reference tiny {name}] gpu/cpu uncoded cal, uncoded dec, "
             f"coded: {pairs}")
        band = 8 if name == "mmse" else max(16, pairs[0][1] // 20)
        _check(all(abs(x - y) <= band for x, y in pairs),
               f"tiny {name} counters: GPU and CPU differ beyond {band}")

    # ---- 5. the main path at full width -------------------------------------
    ebno = 12.0
    G_main = 128
    ids = torch.arange(2 * G_main)
    keys = rng.block_keys(root, 0, ids).reshape(2, 1, G_main, 2).numpy()
    cdl_snr_point(cfg, ebno, keys[0][:, :8], keys[1][:, :8])   # warm-up
    sync()
    decode_cuda.launches = 0
    esn_cuda.launches = 0
    phases = {}
    t0 = time.perf_counter()
    pt = cdl_snr_point(cfg, ebno, keys[0], keys[1], timings=phases)
    sync()
    wall = time.perf_counter() - t0
    launches = {"bp_decode": decode_cuda.launches,
                "esn_predict": esn_cuda.launches}
    _check(all(v > 0 for v in launches.values()),
           f"a kernel of the main path was never launched: {launches}")
    kernels["bp_decode"]["launches"] = launches["bp_decode"]
    kernels["esn_predict"]["launches"] = launches["esn_predict"]
    c = pt.counts
    D = cfg.data_symbols_per_block
    ber = {d: c.bit_errors[d] / c.total_bits for d in c.bit_errors}
    ber_coded = {d: c.info_errors[d] / c.total_info_bits for d in c.info_errors}
    det_syms = G_main * (D + 1)
    _log(f"[main] mimo_4x8_cdl {ebno} dB, {G_main} blocks x (1 cal + 1 decode)"
         f" rounds: cal errors {pt.cal_bit_errors} / {pt.cal_total_bits}")
    _log(f"[main] decode round: uncoded errors {c.bit_errors} / "
         f"{c.total_bits}, info errors {c.info_errors} / {c.total_info_bits}, "
         f"frame errors {c.frame_errors} / {c.ldpc_codewords}")
    _log(f"[main] uncoded BER {ber} coded BER {ber_coded}")
    _log(f"[main] BP iterations {c.ldpc_iter_sum} unconverged "
         f"{c.ldpc_unconverged} of {c.ldpc_codewords} codewords per detector")
    _log(f"[main] phases ms {json.dumps({k: round(v, 3) for k, v in phases.items()})}"
         f" wall {1e3 * wall:.3f} ms | detected symbols/s "
         f"{det_syms / (phases['cal'] / 1e3):.1f} | e2e decoded symbols/s "
         f"{2 * det_syms / wall:.1f} | launches {launches}")
    for d in ber:
        _check(0.0 < ber[d] < 0.5, f"{d} uncoded BER {ber[d]} not in (0, 0.5)")
        _check(0.0 <= ber_coded[d] < 0.5, f"{d} coded BER {ber_coded[d]}")
    _check(ber_coded["mmse"] <= ber["mmse"],
           "MMSE coded BER above its uncoded BER")
    _check(c.ldpc_codewords == G_main * D * cfg.channel.n_tx,
           "unexpected codeword count")

    if "--profile" in sys.argv[1:]:
        _profile_main_path(
            lambda: cdl_snr_point(cfg, ebno, keys[0], keys[1]), 1e3 * wall)

    # ---- 6. result lines ----------------------------------------------------
    order = ("bp_decode", "esn_predict")
    keys_out = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
    _log(json.dumps({"kernels": [{k: kernels[n][k] for k in keys_out}
                                 for n in order]}))
    _log(smi)
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _profile_main_path(run, wall_ms: float) -> None:
    """Device time by kernel over one main-path run under torch.profiler,
    and the share of the unprofiled run's wall time `wall_ms` the device
    was busy (kernels run on one stream, so their times add)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    per = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name][0] += e.time_range.elapsed_us() / 1e3
            per[e.name][1] += 1
    busy = sum(v[0] for v in per.values())
    _log(f"[profile] device kernels {busy:.3f} ms in "
         f"{sum(v[1] for v in per.values())} launches = "
         f"{100 * busy / wall_ms:.1f}% of the unprofiled main-path wall "
         f"{wall_ms:.3f} ms")
    for name, (ms, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:15]:
        _log(f"[profile] {ms:10.3f} ms {n:6d}x {name[:100]}")


if __name__ == "__main__":
    main()
