#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (esn_ofdm_mimo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Builds the port's six CUDA kernels from esn_ofdm_mimo_tpu_torch/csrc/ (one
nvcc per source, all started together; sm_90a), then:

  1. prints the card (nvidia-smi name and power limit) and the build time;
  2. K1, the BP decoder (csrc/bp_decode.cu), against its plain PyTorch
     version on 75,776 AWGN codewords of the flagship code at two Eb/N0:
     identical bits, iterations, converged flags and counts for offset
     min-sum (the flagship rule) and normalised min-sum; sum-product within
     the agreement band of the JAX package's own kernel test;
     [K1-nbf] the same for the mimo_4x8_nbf preset's own rule
     (sum-product) on 12,800 codewords of its code (n = 2048, 1,024
     threads a block) under the iteration caps 100 and 200;
  3. K2, the ESN predict recurrence (csrc/esn_predict.cu), against its plain
     version at the flagship detect shape (9,472 rows, T = 138, n_res = 300,
     128 readouts of 74 rows): noise 0 within atol 1e-4 / rtol 1e-3, noise
     1e-3 within the plain version's own noise band; [K2-nbf] the same check
     at the mimo_4x8_nbf detect shape (2,304 rows, T = 522, n_res = 600);
  4. K3, the ESN state harvest (csrc/esn_states.cu), against plain
     esn_states at the mimo_4x8_nbf fit shape (128 x 522 x 600) and the
     flagship fit shape (128 x 138 x 300), the same tolerances;
  5. K4, the grouped-readout predict (csrc/esn_predict_grouped.cu), against
     plain grouped esn_predict and against K2 at the flagship detect shape;
     [K1-layered] the row-layered BP decoder (csrc/bp_decode_layered.cu)
     against plain layered BP on the same codewords as K1 (cap 50) and
     K1-nbf (caps 50 and 100): identical for both min-sum rules,
     sum-product (the NBF preset's rule) in the band; then layered at cap
     50 against flooding at
     cap 100 (BER, unconverged share, ms per sweep);
     [K5] every ablation build of the predict recurrence
     (csrc/esn_predict_ablate.cu) against its plain version at the
     micro-benchmark's shape (9,472 rows, one readout per row), then the
     micro-benchmark itself (tools/bench_micro_torch.py, group pred), one
     line per variant;
  6. small reference checks: tiny CDL and tiny NBF configurations through
     `cdl_snr_point` / `nbf_snr_point` on the GPU (kernels) and on the CPU
     (plain versions), classical-detector counters within a few bit flips;
  7. the main paths at full width, each with every kernel's launch count
     reset just before and read just after:
       [nbf main] `nbf_snr_point` on mimo_4x8_nbf (N = 512, 4x8, n_res = 600,
       T = 522, D = 18, n = 2048), 128 blocks, one round at 3 dB (doubled
       BP cap) and at 12 dB, five detectors: K1, K2 and K3 launched;
       [main] `cdl_snr_point` on the flagship mimo_4x8_cdl (N = 128, 4x8,
       n_res = 300, D = 74, n = 512), 128 blocks, one calibration and one
       decode round at 12 dB: K1, K2 and K3 launched;
       [main grouped] the same flagship point with
       ESN_TPU_PREDICT_READOUT=grouped: K4 launched;
       [curve] the CLI, esn_ofdm_mimo_tpu_torch.experiments.run.main, on
       mimo_4x8_cdl at 9, 12 and 15 dB, 256 blocks per SNR in rounds of 128
       with the adaptive top-up and checkpoints: K1, K2, K3 launched, the
       artifacts written and parsed, MMSE coded BER non-increasing; a second
       call with --resume launches nothing and writes the same CSV; then
       `run_cdl_curve` on the same keys with flooding at max_iter 100 and
       with LdpcConfig(schedule="layered", max_iter=50): the layered kernel
       launched and the flooding one not, MMSE coded BER in the flooding
       run's band, decode ms of both;
       [curve nbf] the CLI on mimo_4x8_nbf at 3 and 12 dB, 128 blocks:
       artifacts written, BERs equal to `nbf_snr_point` on the same keys;
  8. one JSON line listing the kernels (launches on the main paths, error
     against the plain version, times, bound), then the card line and the
     final {"ok": true, ...} line.

Every phase ends in torch.cuda.synchronize(); any failure exits non-zero
before the final line. Without CUDA it exits 1 and prints no result.

--profile adds one more run of the flagship and the 12 dB NBF main paths
under torch.profiler and prints the device time by kernel and the device's
busy share of each run's wall time.
"""
from __future__ import annotations

import csv
import json
import os
import pickle
import subprocess
import sys
import tempfile
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


def _bound(n_bytes: float, ops: float):
    """(least ms for the work on the card, what bounds it)."""
    t_b, t_o = n_bytes / _HBM_BYTES_PER_S, ops / _FP32_FLOP_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _entry(name, source, replaces, err, ms, plain_ms, n_bytes, ops):
    bound_ms, by = _bound(n_bytes, ops)
    return dict(name=name, route="cuda",
                source=f"esn_ofdm_mimo_tpu_torch/csrc/{source}",
                replaces=replaces, launches=0, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=None)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke run needs a GPU")

    from esn_ofdm_mimo_tpu_torch import config as tc
    from esn_ofdm_mimo_tpu_torch.experiments.presets import (mimo_4x8_cdl,
                                                             mimo_4x8_nbf)
    from esn_ofdm_mimo_tpu_torch.ldpc import decode_cuda, ldpc_encode, \
        make_code
    from esn_ofdm_mimo_tpu_torch.ldpc.decode import ldpc_decode_bp_plain
    from esn_ofdm_mimo_tpu_torch.models import esn_cuda, esn_states_cuda
    from esn_ofdm_mimo_tpu_torch.models.esn import (EsnScale, esn_predict,
                                                    esn_states,
                                                    init_reservoir)
    import dataclasses

    from esn_ofdm_mimo_tpu_torch.experiments import run as cli
    from esn_ofdm_mimo_tpu_torch.models.esn import (ABLATE_PARTS,
                                                    esn_predict_ablate)
    from esn_ofdm_mimo_tpu_torch.parallel import (cdl_snr_point,
                                                  nbf_snr_point,
                                                  run_cdl_curve)
    from esn_ofdm_mimo_tpu_torch.pipelines.common import DETECTORS
    from esn_ofdm_mimo_tpu_torch.utils import build, rng

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import bench_micro_torch as micro

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    counters = ((decode_cuda, "launches", "bp_decode"),
                (decode_cuda, "launches_layered", "bp_decode_layered"),
                (esn_cuda, "launches", "esn_predict"),
                (esn_states_cuda, "launches", "esn_states"),
                (esn_cuda, "launches_grouped", "esn_predict_grouped"),
                (esn_cuda, "launches_ablate", "esn_predict_ablate"))

    def reset_counts():
        for mod, attr, _ in counters:
            setattr(mod, attr, 0)

    def read_counts() -> dict:
        return {name: getattr(mod, attr) for mod, attr, name in counters}

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

    def close(got, want, what: str) -> float:
        """Kernel output against its plain version: atol 1e-4, rtol 1e-3."""
        sync()
        err = float((got - want).abs().max())
        _check(got.shape == want.shape and bool(torch.isfinite(got).all()),
               f"{what} output has the wrong shape or is not finite")
        _check(torch.allclose(got, want, atol=1e-4, rtol=1e-3),
               f"{what} differs from the plain version (max abs err {err})")
        return err

    rms = lambda a: float(a.pow(2).mean().sqrt())                # noqa: E731

    def noise_band(kernel_noisy, plain_noisy, clean, what: str):
        """State noise 1e-3: the kernel's deviation from the noiseless plain
        output within 0.8-1.25x the plain version's own."""
        r_k, r_p = rms(kernel_noisy - clean), rms(plain_noisy - clean)
        _check(0.8 * r_p <= r_k <= 1.25 * r_p,
               f"{what} noise RMS {r_k} outside 0.8-1.25x the plain "
               f"version's {r_p}")
        return r_k, r_p

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
    nbf = mimo_4x8_nbf()
    kernels = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    # ---- 2. K1: BP decoder vs its plain version -----------------------------
    def awgn_codewords(code, n_half: int, ebnos):
        """n_half random codewords at each Eb/N0 (BPSK, AWGN) -> (info bits,
        channel LLRs)."""
        us, llrs = [], []
        for ebno in ebnos:
            u = torch.randint(0, 2, (n_half, code.k), generator=gen,
                              device=dev, dtype=torch.int8)
            x = 1.0 - 2.0 * ldpc_encode(code, u).float()
            sigma2 = 1.0 / (2.0 * code.k / code.n * 10.0 ** (ebno / 10.0))
            y = x + sigma2 ** 0.5 * torch.randn(x.shape, generator=gen,
                                                device=dev)
            us.append(u)
            llrs.append((2.0 * y / sigma2).contiguous())
        return torch.cat(us), torch.cat(llrs)

    def k1_identical(code, llr, u, what: str, **kw):
        """Bits, iterations, converged flags and counts of K1 equal to the
        plain version's; returns the iteration sum."""
        bits_k, st_k = decode_cuda.ldpc_decode_bp_cuda(code, llr, **kw)
        err_k, stc_k = decode_cuda.ldpc_decode_bp_cuda_counts(code, llr, u,
                                                              **kw)
        bits_p, st_p = ldpc_decode_bp_plain(code, llr, **kw)
        err_p, _ = ldpc_decode_bp_plain(code, llr, count_against=u, **kw)
        sync()
        _check(torch.equal(bits_k, bits_p),
               f"{what} bits differ from the plain version")
        _check(torch.equal(st_k["iterations"], st_p["iterations"]),
               f"{what} iterations differ from the plain version")
        _check(torch.equal(st_k["converged"], st_p["converged"]),
               f"{what} converged flags differ from the plain version")
        _check(torch.equal(err_k.long(), err_p.long())
               and torch.equal(stc_k["iterations"], st_p["iterations"]),
               f"{what} counts mode differs from the plain version")
        return (int(st_k["iterations"].long().sum()),
                float(st_k["converged"].float().mean()))

    def k1_work(code, llr, u, it_sum):
        """Bytes (LLRs in, truth in, counts/stats out) and operations (13
        fp32 ops per edge and executed iteration: q = Lt - r, clip x2, |q|,
        min/second-min x2, sign, select, offset, max, sign product,
        posterior add, parity)."""
        return (llr.numel() * 4 + u.numel() + llr.shape[0] * (4 + 4 + 1),
                13.0 * code.dv * code.n * it_sum)

    code = make_code(cfg.ldpc,
                     cfg.ofdm.n_subcarriers * cfg.ofdm.bits_per_symbol)
    u, llr = awgn_codewords(code, 37_888, (1.5, 2.5))  # one flagship batch
    kw = dict(max_iter=cfg.ldpc.max_iter, algo=cfg.ldpc.algo,
              minsum_offset=cfg.ldpc.minsum_offset)
    it_sum, conv_frac = k1_identical(code, llr, u, "K1",
                                     pass1_iters=cfg.ldpc.pass1_iters, **kw)
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
    kernels["bp_decode"] = _entry(
        "bp_decode", "bp_decode.cu",
        "esn_ofdm_mimo_tpu/ldpc/decode_pallas.py:89",
        0.0, k1_ms, k1_plain_ms, *k1_work(code, llr, u, it_sum))
    _log(f"[K1 offset-minsum] {llr.shape[0]} codewords at Eb/N0 1.5/2.5 dB: "
         f"bits, iterations, converged, counts identical | mean iterations "
         f"{it_sum / llr.shape[0]:.3f} converged {conv_frac:.4f} | kernel "
         f"{k1_ms:.3f} ms plain {k1_plain_ms:.3f} ms bound "
         f"{kernels['bp_decode']['bound_ms']:.4f} ms")

    # K1 at the NBF code: n = 2048, Z = 256, dv * Z = 1,024 threads a block,
    # (2 + dv) * dc * Z * 4 B = 48 KB of shared memory; both runtime caps
    code_n = make_code(nbf.ldpc,
                       nbf.ofdm.n_subcarriers * nbf.ofdm.bits_per_symbol)
    u_n, llr_n = awgn_codewords(code_n, 6_400, (1.0, 1.5))
    kw_n = dict(max_iter=2 * nbf.ldpc.max_iter, algo=nbf.ldpc.algo,
                minsum_offset=nbf.ldpc.minsum_offset,
                pass1_iters=nbf.ldpc.pass1_iters)
    for cap in (nbf.ldpc.max_iter, 2 * nbf.ldpc.max_iter):
        it_n, conv_n = k1_identical(code_n, llr_n, u_n, f"K1-nbf cap {cap}",
                                    iter_cap=cap, **kw_n)
        _log(f"[K1-nbf cap {cap}] {nbf.ldpc.algo}, {llr_n.shape[0]} "
             f"codewords of n = {code_n.n} at Eb/N0 1.0/1.5 dB: bits, iterations, converged, "
             f"counts identical | mean iterations {it_n / llr_n.shape[0]:.3f}"
             f" converged {conv_n:.4f}")
    k1n_ms = cuda_ms(lambda: decode_cuda.ldpc_decode_bp_cuda_counts(
        code_n, llr_n, u_n, iter_cap=cap, **kw_n), 2)
    k1n_plain_ms = cuda_ms(lambda: ldpc_decode_bp_plain(
        code_n, llr_n, iter_cap=cap, count_against=u_n, **kw_n), 1)
    k1n_bound, k1n_by = _bound(*k1_work(code_n, llr_n, u_n, it_n))
    _log(f"[K1-nbf cap {cap}] kernel {k1n_ms:.3f} ms plain "
         f"{k1n_plain_ms:.3f} ms bound {k1n_bound:.4f} ms ({k1n_by})")

    # ---- 3. K2: ESN predict vs its plain version ----------------------------
    def predict_shape(c, G: int, seed: int):
        """Reservoir, scale, grouped readouts and inputs of a detect call of
        G blocks of config c, at full width."""
        n_res = c.esn.n_reservoir
        n_in, n_out = 2 * c.channel.n_rx, 2 * c.channel.n_tx
        delay = c.esn.shared_delay(c.ofdm.isi_duration)
        T = c.ofdm.n_subcarriers + c.ofdm.cp_len + delay
        res = init_reservoir(rng.prng_key(seed, dev), n_in, n_out, n_res,
                             c.esn.spectral_radius, c.esn.sparsity, 0.0)
        B = G * c.data_symbols_per_block
        inputs = torch.randn(B, T, n_in, generator=gen, device=dev)
        Wt_out = 0.02 * torch.randn(G, n_res + n_in, n_out, generator=gen,
                                    device=dev)
        return res, inputs, Wt_out, delay + c.ofdm.cp_len

    def predict_work(res, inputs, Wt_out, out):
        """Bytes (inputs + weights in, outputs out) and operations (2 flops
        per multiply-add of [W | W_in | W_fb] and the readout, plus tanh, per
        row and step)."""
        (B, T, n_in), n_res = inputs.shape, res.Wt.shape[0]
        n_out = Wt_out.shape[-1]
        n_bytes = 4 * (inputs.numel() + Wt_out.numel() + out.numel()
                       + n_res * (n_res + n_in + n_out))
        ops = float(B) * T * (2 * n_res * (n_res + n_in + n_out)
                              + 2 * (n_res + n_in) * n_out + n_res)
        return n_bytes, ops

    scale = EsnScale(input_scaling=0.5, input_shift=0.0, teacher_scaling=1.0)
    G = 128
    res, inputs, Wt_out, n_forget = predict_shape(cfg, G, 7)
    B, T = inputs.shape[:2]
    pk = esn_cuda.esn_predict_cuda(res, scale, Wt_out, inputs, n_forget, 0)
    pp = esn_predict(res, scale, Wt_out, inputs, n_forget)
    k2_err = close(pk, pp, "K2")
    noisy = res._replace(noise=1e-3)
    gn = torch.Generator(device=dev)
    gn.manual_seed(3)
    r_k, r_p = noise_band(
        esn_cuda.esn_predict_cuda(noisy, scale, Wt_out, inputs, n_forget,
                                  12345),
        esn_predict(noisy, scale, Wt_out, inputs, n_forget, gn), pp, "K2")
    k2_ms = cuda_ms(lambda: esn_cuda.esn_predict_cuda(
        res, scale, Wt_out, inputs, n_forget, 0), 3)
    k2_plain_ms = cuda_ms(lambda: esn_predict(
        res, scale, Wt_out, inputs, n_forget), 2)
    k2_work = predict_work(res, inputs, Wt_out, pk)
    kernels["esn_predict"] = _entry(
        "esn_predict", "esn_predict.cu",
        "esn_ofdm_mimo_tpu/models/esn_pallas.py:101", k2_err, k2_ms,
        k2_plain_ms, *k2_work)
    _log(f"[K2] rows {B} T {T} n_res {res.Wt.shape[0]} G {G} Dg {B // G}: "
         f"max abs err {k2_err:.3e} | noise RMS kernel {r_k:.4e} plain "
         f"{r_p:.4e} | kernel {k2_ms:.3f} ms plain {k2_plain_ms:.3f} ms "
         f"bound {kernels['esn_predict']['bound_ms']:.4f} ms "
         f"({k2_work[1] / 1e9:.1f} GFLOP)")

    # K2 at the NBF detect shape: n_res = 600 (the NJ4 = 10 build, 160 KB of
    # shared memory, one block an SM) and 36 tiles of 64 rows
    res_n, inputs_n, Wt_out_n, n_forget_n = predict_shape(nbf, G, 8)
    pk_n = esn_cuda.esn_predict_cuda(res_n, scale, Wt_out_n, inputs_n,
                                     n_forget_n, 0)
    pp_n = esn_predict(res_n, scale, Wt_out_n, inputs_n, n_forget_n)
    k2n_err = close(pk_n, pp_n, "K2-nbf")
    k2n_ms = cuda_ms(lambda: esn_cuda.esn_predict_cuda(
        res_n, scale, Wt_out_n, inputs_n, n_forget_n, 0), 2)
    k2n_plain_ms = cuda_ms(lambda: esn_predict(
        res_n, scale, Wt_out_n, inputs_n, n_forget_n), 1)
    k2n_bound, k2n_by = _bound(*predict_work(res_n, inputs_n, Wt_out_n, pk_n))
    _log(f"[K2-nbf] rows {inputs_n.shape[0]} T {inputs_n.shape[1]} n_res "
         f"{res_n.Wt.shape[0]} G {G} Dg {inputs_n.shape[0] // G} "
         f"({-(-inputs_n.shape[0] // 64)} tiles): max abs err {k2n_err:.3e} | "
         f"kernel {k2n_ms:.3f} ms plain {k2n_plain_ms:.3f} ms bound "
         f"{k2n_bound:.4f} ms ({k2n_by})")
    del pk_n, pp_n, inputs_n

    # ---- 4. K3: ESN state harvest vs its plain version ----------------------
    def k3_phase(c, label: str, seed: int):
        """K3 against plain esn_states at the fit shape of config c (128
        blocks of one pilot each): returns (error, ms, plain ms, bytes,
        operations)."""
        n_res = c.esn.n_reservoir
        n_in, n_out = 2 * c.channel.n_rx, 2 * c.channel.n_tx
        T = (c.ofdm.n_subcarriers + c.ofdm.cp_len
             + c.esn.shared_delay(c.ofdm.isi_duration))
        r = init_reservoir(rng.prng_key(seed, dev), n_in, n_out, n_res,
                           c.esn.spectral_radius, c.esn.sparsity, 0.0)
        x = torch.randn(G, T, n_in, generator=gen, device=dev)
        d = 0.5 * torch.randn(G, T, n_out, generator=gen, device=dev)
        sk = esn_states_cuda.esn_states_cuda(r, scale, x, d, 0)
        sp = esn_states(r, scale, x, d)
        err = close(sk, sp, f"K3 {label}")
        g3 = torch.Generator(device=dev)
        g3.manual_seed(4)
        rn = r._replace(noise=1e-3)
        r_k3, r_p3 = noise_band(
            esn_states_cuda.esn_states_cuda(rn, scale, x, d, 12345),
            esn_states(rn, scale, x, d, g3), sp, f"K3 {label}")
        ms = cuda_ms(lambda: esn_states_cuda.esn_states_cuda(
            r, scale, x, d, 0), 3)
        plain_ms = cuda_ms(lambda: esn_states(r, scale, x, d), 2)
        # bytes: inputs, teachers and weights read once, states written once;
        # operations: 2 per multiply-add of [Wt; W_in; W_fb] per row and step
        n_bytes = 4 * (x.numel() + d.numel() + sk.numel()
                       + n_res * (n_res + n_in + n_out))
        ops = 2.0 * G * (T - 1) * n_res * (n_res + n_in + n_out)
        bound_ms, by = _bound(n_bytes, ops)
        _log(f"[K3 {label}] {G} x {T} x {n_res}: max abs err {err:.3e} | "
             f"noise RMS kernel {r_k3:.4e} plain {r_p3:.4e} | kernel "
             f"{ms:.3f} ms plain {plain_ms:.3f} ms bound {bound_ms:.4f} ms "
             f"({by}, {ops / 1e9:.1f} GFLOP)")
        return err, ms, plain_ms, n_bytes, ops

    k3 = k3_phase(nbf, "nbf fit", 9)
    k3_phase(cfg, "flagship fit", 10)
    kernels["esn_states"] = _entry(
        "esn_states", "esn_states.cu",
        "esn_ofdm_mimo_tpu/models/esn_pallas.py:346", *k3)

    # ---- 5. K4: grouped-readout predict vs plain and K2 ---------------------
    pg = esn_cuda.esn_predict_cuda(res, scale, Wt_out, inputs, n_forget, 0,
                                   readout="grouped")
    k4_err = close(pg, pp, "K4")
    k4_vs_k2 = float((pg - pk).abs().max())
    r_k4, _ = noise_band(
        esn_cuda.esn_predict_cuda(noisy, scale, Wt_out, inputs, n_forget,
                                  12345, readout="grouped"),
        esn_predict(noisy, scale, Wt_out, inputs, n_forget, gn), pp, "K4")
    # in turns on one card: K2, K4, K4, K2
    run_k2 = lambda: esn_cuda.esn_predict_cuda(                  # noqa: E731
        res, scale, Wt_out, inputs, n_forget, 0)
    run_k4 = lambda: esn_cuda.esn_predict_cuda(                  # noqa: E731
        res, scale, Wt_out, inputs, n_forget, 0, readout="grouped")
    t = [cuda_ms(f, 3) for f in (run_k2, run_k4, run_k4, run_k2)]
    k4_ms, k2_pair_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    kernels["esn_predict_grouped"] = _entry(
        "esn_predict_grouped", "esn_predict_grouped.cu",
        "esn_ofdm_mimo_tpu/models/esn_pallas.py:152", k4_err, k4_ms,
        k2_plain_ms, *k2_work)
    _log(f"[K4] rows {B} T {T} G {G} Dg {B // G} P "
         f"{esn_cuda.grouped_slots(G, B // G)}: max abs err vs plain "
         f"{k4_err:.3e} vs K2 {k4_vs_k2:.3e} | noise RMS {r_k4:.4e} | kernel "
         f"{k4_ms:.3f} ms, K2 in the same turns {k2_pair_ms:.3f} ms, plain "
         f"{k2_plain_ms:.3f} ms, bound "
         f"{kernels['esn_predict_grouped']['bound_ms']:.4f} ms")
    del pg, pk, pp, inputs

    # ---- 5b. K1-layered: the layered BP decoder vs its plain version --------
    kw_l = dict(kw, schedule="layered", max_iter=50)
    itl_sum, convl_frac = k1_identical(code, llr, u, "K1-layered", **kw_l)
    k1l_ms = cuda_ms(lambda: decode_cuda.ldpc_decode_bp_cuda_counts(
        code, llr, u, **kw_l), 3)
    k1l_plain_ms = cuda_ms(lambda: ldpc_decode_bp_plain(
        code, llr, count_against=u, **kw_l), 1)
    for algo, exact in (("minsum", True), ("sumprod", False)):
        kwa = dict(kw_l, algo=algo)
        bk, sk = decode_cuda.ldpc_decode_bp_cuda(code, llr[sub], **kwa)
        bp, sp = ldpc_decode_bp_plain(code, llr[sub], **kwa)
        sync()
        agree = float((bk == bp).float().mean())
        it_agree = float((sk["iterations"] == sp["iterations"]).float().mean())
        cv_agree = float((sk["converged"] == sp["converged"]).float().mean())
        _log(f"[K1-layered {algo}] bit agreement {agree} iterations "
             f"{it_agree} converged {cv_agree}")
        if exact:
            _check(agree == 1.0 and it_agree == 1.0 and cv_agree == 1.0,
                   f"K1-layered {algo} differs from the plain version")
        else:
            _check(agree > 0.999 and it_agree > 0.9 and cv_agree > 0.95,
                   f"K1-layered {algo} outside the agreement band")
    kernels["bp_decode_layered"] = _entry(
        "bp_decode_layered", "bp_decode_layered.cu",
        "esn_ofdm_mimo_tpu/ldpc/decode_pallas.py:254",
        0.0, k1l_ms, k1l_plain_ms, *k1_work(code, llr, u, itl_sum))
    _log(f"[K1-layered offset-minsum] {llr.shape[0]} codewords at Eb/N0 "
         f"1.5/2.5 dB, cap 50: bits, iterations, converged, counts identical "
         f"| mean sweeps {itl_sum / llr.shape[0]:.3f} converged "
         f"{convl_frac:.4f} | kernel {k1l_ms:.3f} ms plain "
         f"{k1l_plain_ms:.3f} ms bound "
         f"{kernels['bp_decode_layered']['bound_ms']:.4f} ms")
    for cap_l in (50, 100):
        for algo in ("offset-minsum", "minsum"):
            kwn_l = dict(kw_n, schedule="layered", max_iter=100,
                         iter_cap=cap_l, algo=algo)
            itn_l, convn_l = k1_identical(
                code_n, llr_n, u_n, f"K1-layered nbf {algo} cap {cap_l}",
                **kwn_l)
            k1ln_ms = cuda_ms(lambda: decode_cuda.ldpc_decode_bp_cuda_counts(
                code_n, llr_n, u_n, **kwn_l), 2)
            k1ln_bound, _ = _bound(*k1_work(code_n, llr_n, u_n, itn_l))
            _log(f"[K1-layered nbf cap {cap_l}] {algo}, {llr_n.shape[0]} "
                 f"codewords of n = {code_n.n}: bits, iterations, converged, "
                 f"counts identical | mean sweeps "
                 f"{itn_l / llr_n.shape[0]:.3f} converged {convn_l:.4f} | "
                 f"kernel {k1ln_ms:.3f} ms bound {k1ln_bound:.4f} ms")
    # the NBF preset's own rule, sum-product (libm's tanh/atanh against
    # torch's): the agreement band, and its time
    kwn_s = dict(kw_n, schedule="layered", max_iter=100)
    bk, sk = decode_cuda.ldpc_decode_bp_cuda(code_n, llr_n, **kwn_s)
    bp, sp = ldpc_decode_bp_plain(code_n, llr_n, **kwn_s)
    sync()
    agree = float((bk == bp).float().mean())
    it_agree = float((sk["iterations"] == sp["iterations"]).float().mean())
    cv_agree = float((sk["converged"] == sp["converged"]).float().mean())
    _check(agree > 0.999 and it_agree > 0.9 and cv_agree > 0.95,
           "K1-layered nbf sum-product outside the agreement band")
    k1ls_ms = cuda_ms(lambda: decode_cuda.ldpc_decode_bp_cuda_counts(
        code_n, llr_n, u_n, **kwn_s), 2)
    _log(f"[K1-layered nbf cap 100] {nbf.ldpc.algo}: bit agreement {agree} "
         f"iterations {it_agree} converged {cv_agree} | mean sweeps "
         f"{float(sk['iterations'].float().mean()):.3f} converged "
         f"{float(sk['converged'].float().mean()):.4f} | kernel "
         f"{k1ls_ms:.3f} ms")

    # layered at cap 50 against flooding at cap 100, the same codewords: the
    # band of the JAX package's schedule test
    def sched_stats(schedule, max_iter):
        err, st = decode_cuda.ldpc_decode_bp_cuda_counts(
            code, llr, u, max_iter=max_iter, algo=cfg.ldpc.algo,
            minsum_offset=cfg.ldpc.minsum_offset, schedule=schedule)
        conv = st["converged"]
        return (float(err.sum()) / u.numel(),
                float(st["iterations"][conv].float().mean()),
                float(conv.float().mean()))
    ber_f, itc_f, conv_f = sched_stats("flooding", 100)
    ber_l, itc_l, conv_l = sched_stats("layered", 50)
    sync()
    per_f = k1_ms / (it_sum / llr.shape[0])
    per_l = k1l_ms / (itl_sum / llr.shape[0])
    _log(f"[K1-layered vs flooding] layered cap 50: BER {ber_l:.4e} "
         f"unconverged {1 - conv_l:.4f} mean sweeps of converged "
         f"{itc_l:.3f} | flooding cap 100: BER {ber_f:.4e} unconverged "
         f"{1 - conv_f:.4f} mean iterations of converged {itc_f:.3f} | ms "
         f"per mean sweep: layered {per_l:.4f}, flooding {per_f:.4f} "
         f"(ratio {per_l / per_f:.3f}); whole decode {k1l_ms:.3f} vs "
         f"{k1_ms:.3f} ms")
    _check(ber_l <= ber_f * 1.25 + 2e-3 and conv_l >= conv_f - 0.02
           and itc_l <= 0.65 * itc_f,
           "layered at cap 50 does not track flooding at cap 100")

    # ---- 5c. K5: the ablation builds vs their plain versions ----------------
    # Operands: K2's reservoir with the feedback weights at a tenth. With
    # the readout switched off the raw state s'[:n_out] is fed back, and at
    # full feedback weight that loop amplifies rounding differences over the
    # 138 steps beyond the tolerance (1.4e-3 measured), in either version.
    B5 = G * cfg.data_symbols_per_block
    res5 = res._replace(W_fb_t=0.1 * res.W_fb_t)
    noisy5 = res5._replace(noise=1e-3)
    x5 = torch.randn(B5, T, res.W_in_t.shape[0], generator=gen, device=dev)
    W5 = 0.02 * torch.randn(B5, Wt_out.shape[1], Wt_out.shape[2],
                            generator=gen, device=dev)   # one readout per row
    k5_err, k5 = 0.0, {}
    for off in esn_cuda.ABLATE_BUILDS:
        sw = {p: p not in off for p in ABLATE_PARTS}
        label = "full" if not off else "floor" if len(off) > 1 else \
            f"no {next(iter(off))}"
        out_k = esn_cuda.esn_predict_ablate_cuda(res5, scale, W5, x5, 0, 0,
                                                 **sw)
        out_p = esn_predict_ablate(res5, scale, W5, x5, 0, None, **sw)
        err = close(out_k, out_p, f"K5 {label}")
        k5_err = max(k5_err, err)
        if sw["noise"]:
            noise_band(
                esn_cuda.esn_predict_ablate_cuda(noisy5, scale, W5, x5, 0,
                                                 12345, **sw),
                esn_predict_ablate(noisy5, scale, W5, x5, 0, gn, **sw), out_p,
                f"K5 {label}")
        ms = cuda_ms(lambda: esn_cuda.esn_predict_ablate_cuda(
            noisy5, scale, W5, x5, 0, 12345, **sw), 2)
        plain_ms = cuda_ms(lambda: esn_predict_ablate(
            noisy5, scale, W5, x5, 0, gn, **sw), 1)
        # K2's count less what each switch removes
        n_res5, n_in5, n_out5 = res.Wt.shape[0], x5.shape[2], W5.shape[2]
        per_step = ((2 * n_res5 * n_res5 if sw["recurrence_dot"] else n_res5)
                    + 2 * n_res5 * n_in5
                    + (2 * n_res5 * n_out5 if sw["feedback"] else 0)
                    + (n_res5 if sw["tanh"] else n_res5)
                    + (2 * (n_res5 + n_in5) * n_out5 if sw["readout"] else 0))
        n_bytes = 4 * (x5.numel() + out_k.numel()
                       + (W5.numel() if sw["readout"] else 0)
                       + n_res5 * ((n_res5 if sw["recurrence_dot"] else 0)
                                   + n_in5
                                   + (n_out5 if sw["feedback"] else 0)))
        k5[label] = (err, ms, plain_ms, n_bytes, float(B5) * T * per_step)
        b_ms, b_by = _bound(*k5[label][3:])
        _log(f"[K5 {label}] rows {B5} T {T} n_res {n_res5}: max abs err "
             f"{err:.3e} | kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound "
             f"{b_ms:.4f} ms ({b_by})")
    kernels["esn_predict_ablate"] = _entry(
        "esn_predict_ablate", "esn_predict_ablate.cu",
        "tools/bench_micro.py:147", k5_err, *k5["full"][1:])
    del x5, W5, out_k, out_p

    # ---- 6. small reference checks: GPU kernels vs CPU plain versions ------
    root = rng.prng_key(0)
    tiny = tc.SimConfig(
        name="cdl_tiny",
        ofdm=tc.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                           doppler_hz=3000.0),
        channel=tc.ChannelConfig(kind="cdl_b", n_tx=2, n_rx=4),
        esn=tc.EsnConfig(n_reservoir=40, train_ebno_fixed_db=None, noise=0.0),
        ldpc=tc.LdpcConfig(max_iter=8, family="qc", algo="offset-minsum"),
        calib=tc.CalibConfig(enabled=True), ebno_db=(12.0,))
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

    tiny_nbf = tc.SimConfig(
        name="nbf_tiny",
        ofdm=tc.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                           doppler_hz=3000.0),
        channel=tc.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=tc.EsnConfig(n_reservoir=40, noise=0.0),
        ldpc=tc.LdpcConfig(max_iter=20, decode_every=2, family="qc",
                           algo="offset-minsum"))
    nk = rng.block_keys(root, 2, torch.arange(8)).reshape(1, 8, 2).numpy()
    small_nbf = {d: nbf_snr_point(tiny_nbf, 12.0, nk, device=d)
                 for d in ("cuda", "cpu")}
    sync()
    a, b = small_nbf["cuda"], small_nbf["cpu"]
    for name in sorted(a.bit_errors):
        pairs = [(a.bit_errors[name], b.bit_errors[name]),
                 (a.info_errors[name], b.info_errors[name])]
        _log(f"[reference tiny nbf {name}] gpu/cpu uncoded, coded: {pairs}")
        if name in ("zf_perfect", "zf_ls", "mmse"):
            _check(all(abs(x - y) <= 8 + y // 100 for x, y in pairs),
                   f"tiny nbf {name} counters: GPU and CPU differ beyond a "
                   f"few bit flips")
    _check(a.cond_hist.tolist() == b.cond_hist.tolist()
           and a.rank_full_sum == b.rank_full_sum,
           "tiny nbf channel analytics: GPU and CPU differ")

    # ---- 7. the main paths at full width ------------------------------------
    launches_total = {name: 0 for _, _, name in counters}

    def count_run(run, need, what: str):
        """Run `run` with every launch count reset just before and read just
        after; the kernels in `need` must have launched."""
        sync()
        reset_counts()
        phases = {}
        t0 = time.perf_counter()
        out = run(phases)
        sync()
        wall = time.perf_counter() - t0
        launches = read_counts()
        _check(all(launches[k] > 0 for k in need),
               f"{what}: a kernel of the path was never launched: {launches}")
        for k, v in launches.items():
            launches_total[k] += v
        return out, phases, wall, launches

    # block fading: mimo_4x8_nbf, five detectors, at 3 dB and 12 dB
    G_nbf, D_n = 128, nbf.data_symbols_per_block
    nbf_keys = {e: rng.block_keys(root, nbf.ebno_db.index(e),
                                  torch.arange(G_nbf))
                .reshape(1, G_nbf, 2).numpy() for e in (3.0, 12.0)}
    nbf_snr_point(nbf, 12.0, nbf_keys[12.0][:, :8])              # warm-up
    nbf_wall = {}
    for ebno_n in (3.0, 12.0):
        pt_n, ph_n, wall_n, la_n = count_run(
            lambda ph: nbf_snr_point(nbf, ebno_n, nbf_keys[ebno_n],
                                     timings=ph),
            ("bp_decode", "esn_predict", "esn_states"), f"nbf {ebno_n} dB")
        nbf_wall[ebno_n] = wall_n
        ber = {d: v / pt_n.total_bits for d, v in pt_n.bit_errors.items()}
        coded = {d: v / pt_n.total_info_bits
                 for d, v in pt_n.info_errors.items()}
        n_cw = G_nbf * len(range(0, D_n, nbf.ldpc.decode_every)) \
            * nbf.channel.n_tx
        cap = nbf.ldpc.max_iter * (2 if ebno_n < 6.0 else 1)
        _log(f"[nbf main] mimo_4x8_nbf {ebno_n} dB, {G_nbf} blocks x 1 round"
             f" (N {nbf.ofdm.n_subcarriers}, n_res {nbf.esn.n_reservoir}, D "
             f"{D_n}, n {code_n.n}, BP cap {cap}): uncoded errors "
             f"{pt_n.bit_errors} / {pt_n.total_bits}, info errors "
             f"{pt_n.info_errors} / {pt_n.total_info_bits}, frame errors "
             f"{pt_n.frame_errors} / {pt_n.ldpc_codewords}")
        _log(f"[nbf main] uncoded BER {ber} coded BER {coded} | BP "
             f"iterations {pt_n.ldpc_iter_sum} unconverged "
             f"{pt_n.ldpc_unconverged} | capacity/sc "
             f"{pt_n.capacity_sum / pt_n.n_blocks:.4f} full rank "
             f"{pt_n.rank_full_sum}/{pt_n.rank_count}")
        _log(f"[nbf main] phases ms "
             f"{json.dumps({k: round(v, 3) for k, v in ph_n.items()})} wall "
             f"{1e3 * wall_n:.3f} ms | blocks/s {G_nbf / wall_n:.2f} | "
             f"detected symbols/s {G_nbf * (D_n + 1) / wall_n:.1f} | "
             f"launches {la_n}")
        for d in ber:
            _check(0.0 < ber[d] < 0.5,
                   f"nbf {ebno_n} dB {d} uncoded BER {ber[d]} not in (0, 0.5)")
        _check(pt_n.ldpc_codewords == n_cw, "unexpected NBF codeword count")
        for d, n_unc in pt_n.ldpc_unconverged.items():
            _check(pt_n.ldpc_iter_sum[d] >= n_unc * cap,
                   f"nbf {ebno_n} dB {d}: unconverged codewords below the "
                   f"cap {cap}")
        if ebno_n == 12.0:
            _check(coded["mmse"] <= ber["mmse"],
                   "NBF MMSE coded BER above its uncoded BER at 12 dB")

    # the flagship: mimo_4x8_cdl at 12 dB
    ebno = 12.0
    G_main = 128
    ids = torch.arange(2 * G_main)
    keys = rng.block_keys(root, 0, ids).reshape(2, 1, G_main, 2).numpy()
    cdl_snr_point(cfg, ebno, keys[0][:, :8], keys[1][:, :8])   # warm-up
    D = cfg.data_symbols_per_block
    det_syms = G_main * (D + 1)

    def flagship(what: str, need):
        pt, phases, wall, launches = count_run(
            lambda ph: cdl_snr_point(cfg, ebno, keys[0], keys[1], timings=ph),
            need, what)
        c = pt.counts
        ber = {d: c.bit_errors[d] / c.total_bits for d in c.bit_errors}
        ber_coded = {d: c.info_errors[d] / c.total_info_bits
                     for d in c.info_errors}
        _log(f"[{what}] mimo_4x8_cdl {ebno} dB, {G_main} blocks x (1 cal + 1 "
             f"decode) rounds: cal errors {pt.cal_bit_errors} / "
             f"{pt.cal_total_bits}")
        _log(f"[{what}] decode round: uncoded errors {c.bit_errors} / "
             f"{c.total_bits}, info errors {c.info_errors} / "
             f"{c.total_info_bits}, frame errors {c.frame_errors} / "
             f"{c.ldpc_codewords}")
        _log(f"[{what}] uncoded BER {ber} coded BER {ber_coded}")
        _log(f"[{what}] BP iterations {c.ldpc_iter_sum} unconverged "
             f"{c.ldpc_unconverged} of {c.ldpc_codewords} codewords per "
             f"detector")
        _log(f"[{what}] phases ms "
             f"{json.dumps({k: round(v, 3) for k, v in phases.items()})} wall"
             f" {1e3 * wall:.3f} ms | detected symbols/s "
             f"{det_syms / (phases['cal'] / 1e3):.1f} | e2e decoded symbols/s"
             f" {2 * det_syms / wall:.1f} | launches {launches}")
        for d in ber:
            _check(0.0 < ber[d] < 0.5, f"{d} uncoded BER {ber[d]} not in "
                                       f"(0, 0.5)")
            _check(0.0 <= ber_coded[d] < 0.5, f"{d} coded BER {ber_coded[d]}")
        _check(ber_coded["mmse"] <= ber["mmse"],
               "MMSE coded BER above its uncoded BER")
        _check(c.ldpc_codewords == G_main * D * cfg.channel.n_tx,
               "unexpected codeword count")
        return wall, launches

    wall, _ = flagship("main", ("bp_decode", "esn_predict", "esn_states"))
    # the JAX package's own switch to the grouped-readout kernel
    os.environ["ESN_TPU_PREDICT_READOUT"] = "grouped"
    try:
        _, la_g = flagship("main grouped", ("bp_decode", "esn_states",
                                            "esn_predict_grouped"))
    finally:
        del os.environ["ESN_TPU_PREDICT_READOUT"]
    _check(la_g["esn_predict"] == 0,
           f"the grouped run still launched K2: {la_g}")

    # the micro-benchmark's predict group: the path that launches K5
    _, _, _, la_5 = count_run(
        lambda ph: micro.run_pred_variants(G_main, dev, rounds=4),
        ("esn_predict_ablate",), "micro-benchmark pred")
    _log(f"[K5 path] tools/bench_micro_torch.py pred, {G_main} blocks: "
         f"launches {la_5}")

    # the curve entry point: the CLI on the flagship preset
    def read_csv(path):
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        return rows[0], [[float(x) for x in r] for r in rows[1:]]

    with tempfile.TemporaryDirectory() as tmp:
        out_c = os.path.join(tmp, "cdl")
        argv = ["--preset", "mimo_4x8_cdl", "--ebno-list", "9,12,15",
                "--blocks-per-device", "128", "--blocks-per-snr", "256",
                "--adaptive-min-errors", "2000", "--adaptive-max-blocks",
                "256", "--outdir", out_c, "--resume"]
        _, _, wall_c, la_c = count_run(
            lambda ph: cli.main(argv),
            ("bp_decode", "esn_predict", "esn_states"), "curve")
        head, rows = read_csv(os.path.join(out_c, "results_ber.csv"))
        _check(head == ["EbNo(dB)", "ESN_uncoded", "MMSE_uncoded",
                        "ESN_coded", "MMSE_coded"]
               and [r[0] for r in rows] == [9.0, 12.0, 15.0],
               f"curve: unexpected results_ber.csv {head} {rows}")
        with open(os.path.join(out_c, "results_ber.pkl"), "rb") as f:
            bundle = pickle.load(f)
        _check(bundle["EBN0"] == [9.0, 12.0, 15.0]
               and bundle["BER_coded"]["MMSE_calLLR"] == [r[4] for r in rows],
               "curve: results_ber.pkl disagrees with the CSV")
        for e in (9, 12, 15):
            with open(os.path.join(
                    out_c, f"LLR_calibration_params_EbNo{e}dB.txt")) as f:
                cal = f.read().splitlines()
            _check(cal[0] == "bit, a_esn, b_esn, a_mmse, b_mmse"
                   and len(cal) == 1 + cfg.ofdm.bits_per_symbol
                   and all(len(x.split(", ")) == 5 for x in cal[1:]),
                   f"curve: calibration file of {e} dB malformed")
        with open(os.path.join(out_c, "events.jsonl")) as f:
            events = [json.loads(x) for x in f]
        msgs = [e.get("msg", "") for e in events]
        _check(events[0]["event"] == "run_start"
               and events[-1]["event"] == "run_done",
               "curve: events.jsonl lacks run_start / run_done")
        topped = [m for m in msgs if "adaptive" in m]
        for r in rows:
            _check(0.0 < r[1] < 0.5 and 0.0 < r[2] < 0.5,
                   f"curve: uncoded BER not in (0, 0.5): {r}")
        _check(rows[0][4] >= rows[1][4] >= rows[2][4],
               f"curve: MMSE coded BER rises with Eb/N0: {rows}")
        _check(len(topped) > 0, "curve: no SNR point was topped up although "
               "the target of 2000 failed codewords is out of reach at 15 dB")
        _log(f"[curve] CLI mimo_4x8_cdl 9/12/15 dB, 256 blocks per SNR in "
             f"rounds of 128, adaptive to 256 decoded blocks: wall "
             f"{1e3 * wall_c:.1f} ms | launches {la_c}")
        for r in rows:
            _log(f"[curve] EbNo {r[0]:g} dB: uncoded esn {r[1]:.4e} mmse "
                 f"{r[2]:.4e} | coded esn {r[3]:.4e} mmse {r[4]:.4e}")
        for m in topped:
            _log(f"[curve] {m}")
        # resumed: every SNR point comes from its checkpoint
        csv_first = open(os.path.join(out_c, "results_ber.csv"), "rb").read()
        _, _, wall_r, la_r = count_run(lambda ph: cli.main(argv), (),
                                       "curve resume")
        _check(not any(la_r.values()),
               f"curve: the resumed call launched kernels: {la_r}")
        _check(open(os.path.join(out_c, "results_ber.csv"), "rb").read()
               == csv_first, "curve: the resumed call wrote another CSV")
        _log(f"[curve] second call with --resume: no launch, the same CSV, "
             f"{1e3 * wall_r:.1f} ms")

        # flooding at max_iter 100 against layered at max_iter 50, same keys
        cfg_c = dataclasses.replace(cfg, ebno_db=(9.0, 12.0, 15.0))
        cfg_l = dataclasses.replace(cfg_c, ldpc=dataclasses.replace(
            cfg.ldpc, schedule="layered", max_iter=50))
        sched = {}
        for name, c_s, need, absent in (
                ("flooding", cfg_c, "bp_decode", "bp_decode_layered"),
                ("layered", cfg_l, "bp_decode_layered", "bp_decode")):
            res_s, ph_s, wall_s, la_s = count_run(
                lambda ph: run_cdl_curve(c_s, 256, blocks_per_round=128,
                                         progress=None, timings=ph),
                (need, "esn_predict", "esn_states"), f"curve {name}")
            _check(la_s[absent] == 0,
                   f"curve {name}: the other BP kernel was launched: {la_s}")
            sched[name] = (res_s, ph_s)
            _log(f"[curve {name}] run_cdl_curve max_iter {c_s.ldpc.max_iter}:"
                 f" MMSE coded "
                 f"{[r['ber_coded']['mmse'] for r in res_s]} avg iterations "
                 f"{[round(r['ldpc_avg_iters']['mmse'], 3) for r in res_s]} "
                 f"unconverged "
                 f"{[r['ldpc_unconverged_frac']['mmse'] for r in res_s]} | "
                 f"phases ms "
                 f"{json.dumps({k: round(v, 3) for k, v in ph_s.items()})} "
                 f"wall {1e3 * wall_s:.1f} ms | launches {la_s}")
        for r_f, r_l in zip(sched["flooding"][0], sched["layered"][0]):
            b_f, b_l = r_f["ber_coded"]["mmse"], r_l["ber_coded"]["mmse"]
            _check(r_f["ber_uncoded"] == r_l["ber_uncoded"],
                   "curve: the schedules saw different uncoded errors")
            _check(b_l <= 1.25 * b_f + 2e-3 and b_f <= 1.25 * b_l + 2e-3,
                   f"curve: layered MMSE coded BER {b_l} outside the band of "
                   f"flooding's {b_f} at {r_f['ebno_db']} dB")
        dec_f = sched["flooding"][1]["decode"]
        dec_l = sched["layered"][1]["decode"]
        _log(f"[curve] decode ms over the 3 SNR points: flooding (max_iter "
             f"100) {dec_f:.3f}, layered (max_iter 50) {dec_l:.3f}, ratio "
             f"{dec_l / dec_f:.3f}")

        # the block-fading curve: the CLI on mimo_4x8_nbf at 3 and 12 dB
        out_n = os.path.join(tmp, "nbf")
        _, _, wall_cn, la_cn = count_run(
            lambda ph: cli.main(
                ["--preset", "mimo_4x8_nbf", "--ebno-list", "3,12",
                 "--blocks-per-device", "128", "--blocks-per-snr", "128",
                 "--outdir", out_n]),
            ("bp_decode", "esn_predict", "esn_states"), "curve nbf")
        head_n, rows_n = read_csv(os.path.join(out_n, "results_ber.csv"))
        with open(os.path.join(out_n, "channel_metrics_4x8.pkl"), "rb") as f:
            met = pickle.load(f)
        _check(met["EBN0"] == [3.0, 12.0]
               and all(x > 0 for x in met["capacity_bits_per_sc"])
               and len(met["cond_number"]["p50"]) == 2,
               f"curve nbf: channel_metrics_4x8.pkl malformed: {met}")
        dets = sorted(DETECTORS)
        _check(head_n == ["EbNo(dB)"] + [f"{d}_uncoded" for d in dets]
               + [f"{d}_coded" for d in dets],
               f"curve nbf: unexpected CSV header {head_n}")
        for jj, (ebno_c, row) in enumerate(zip((3.0, 12.0), rows_n)):
            kj = rng.block_keys(rng.prng_key(nbf.seed), jj,
                                torch.arange(G_nbf)).reshape(1, G_nbf, 2)
            pt_c = nbf_snr_point(nbf, ebno_c, kj)
            for i, d in enumerate(dets):
                want_u = pt_c.bit_errors[d] / pt_c.total_bits
                want_c = pt_c.info_errors[d] / pt_c.total_info_bits
                # the same kernels on the same inputs; a band of 0.1% for
                # the ESN detectors in case a library call is not
                # run-to-run deterministic
                tol = 1e-3 if d.startswith("esn") else 0.0
                _check(abs(row[1 + i] - want_u) <= tol * want_u
                       and abs(row[1 + len(dets) + i] - want_c)
                       <= tol * want_c,
                       f"curve nbf {ebno_c} dB {d}: CSV "
                       f"{row[1 + i], row[1 + len(dets) + i]} against "
                       f"nbf_snr_point's {want_u, want_c}")
        _log(f"[curve nbf] CLI mimo_4x8_nbf 3/12 dB, 128 blocks: "
             f"results_ber.csv and channel_metrics_4x8.pkl written, BERs "
             f"equal to nbf_snr_point on the same keys | wall "
             f"{1e3 * wall_cn:.1f} ms | launches {la_cn}")

    if "--profile" in sys.argv[1:]:
        _profile_main_path(
            "main", lambda: cdl_snr_point(cfg, ebno, keys[0], keys[1]),
            1e3 * wall)
        _profile_main_path(
            "nbf main 12 dB",
            lambda: nbf_snr_point(nbf, 12.0, nbf_keys[12.0]),
            1e3 * nbf_wall[12.0])

    # ---- 8. result lines ----------------------------------------------------
    for name, n in launches_total.items():
        kernels[name]["launches"] = n
    order = ("bp_decode", "bp_decode_layered", "esn_predict", "esn_states",
             "esn_predict_grouped", "esn_predict_ablate")
    keys_out = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
    _log(json.dumps({"kernels": [{k: kernels[n][k] for k in keys_out}
                                 for n in order]}))
    _log(smi)
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _profile_main_path(what: str, run, wall_ms: float) -> None:
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
    _log(f"[profile {what}] device kernels {busy:.3f} ms in "
         f"{sum(v[1] for v in per.values())} launches = "
         f"{100 * busy / wall_ms:.1f}% of the unprofiled wall "
         f"{wall_ms:.3f} ms")
    for name, (ms, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:15]:
        _log(f"[profile {what}] {ms:10.3f} ms {n:6d}x {name[:100]}")


if __name__ == "__main__":
    main()
