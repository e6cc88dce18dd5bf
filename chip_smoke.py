#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (esn_ofdm_mimo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

(`chip_smoke.py --dist-child <dir>` is one rank of [dist fused 2 ranks],
started by the run itself.)

Builds the port's nine CUDA kernel sources from esn_ofdm_mimo_tpu_torch/csrc/
(one nvcc per source, all started together; sm_90a), then:

  1. prints the card (nvidia-smi name and power limit) and the build time;
     [rng] the threefry kernel (csrc/threefry.cu: jax.random's
     threefry2x32 and the draws on it) against its plain version
     (utils/rng.py `*_plain`) at the main paths' shapes: fold_in and split
     of 128 block keys, the bits, a uniform on [0, 2 pi) and a normal at
     the flagship round's AWGN shape (128 blocks x D x n_rx x (N +
     cp_len) = 128 x 74 x 8 x 135), its Bernoulli info bits (128 x D x
     n_tx x code.k = 128 x 74 x 4 x 259) and a normal at the mimo_4x8_nbf
     round's AWGN shape (128 x 18 x 8 x 519): identical, the normals
     within 2 ulp with the count of differing draws printed; ms, plain ms
     and bound of each;
  2. [K1 rule] the BP kernels' sum-product check rule on its own, on the
     card and in its plain version, against float64 on a log-spaced grid
     (each value within 1e-5 relative or 5e-7 absolute);
     K1, the BP decoder (csrc/bp_decode.cu), against its plain PyTorch
     version on 75,776 AWGN codewords of the flagship code at two Eb/N0:
     identical bits, iterations, converged flags and counts for offset
     min-sum (the flagship rule) and normalised min-sum; sum-product within
     the agreement band of the JAX package's own kernel test;
     [K1-nbf] the mimo_4x8_nbf code (n = 2048: 512 threads a block, two
     checks a thread, two codewords an SM) under the iteration caps 100 and
     200: both min-sum rules identical on
     4,096 codewords, the preset's own rule (sum-product) on 12,800 in a
     band (bit, iteration and converged agreement; FER, BER and mean
     iterations against the plain version's);
     [K1 Z384], [K1 Z512] and [K1-layered Z384], [K1-layered Z512]: the
     codes of the NBF presets at 64- and 256-QAM (n = 3,072 and 4,096), 2,048
     codewords at Eb/N0 1.0 and 1.5 dB: both min-sum rules identical to the
     plain version, sum-product in the band, each line with the launch plan
     (flooding: threads, checks a thread, shared memory; layered: threads,
     codewords a block, shared memory, the build's registers and resident
     blocks an SM), ms and bound;
     [K1 siso] the siso_qpsk_awgn code (n = 1,024, Z = 128: 512 threads,
     one check a thread) on 4,096 codewords at Eb/N0 1.5 and 2.5 dB: both
     min-sum rules identical, sum-product (the preset's rule) in the band,
     with the plan, ms, plain ms and bound;
  3. K2, the ESN predict recurrence (csrc/esn_predict.cu), against its plain
     version at the flagship detect shape (9,472 rows, T = 138, n_res = 300,
     128 readouts of 74 rows): noise 0 within atol 1e-4 / rtol 1e-3, noise
     1e-3 within the plain version's own noise band; [K2-nbf] the same check
     at the mimo_4x8_nbf detect shape (2,304 rows, T = 522, n_res = 600);
     [K2 ragged] batches that no tile height divides (9,435 rows) and that
     are smaller than the card's SM count (100 rows); [K2 siso] the
     siso_qpsk_awgn detect shape (399 rows of one block, T = 512, n_in =
     n_out = 2, n_res = 200) and [K2 sweep n_res 50 / 600] the sweep's 2x2
     plant (288 rows, T = 522, n_in = n_out = 4) and [K2 zoo2x2 nmse 16
     rows] the 2x2 comparison's pilot NMSE (16 rows of 16 readouts, T =
     522, n_res 300) and [K2 zoo2x2 detect 288 rows] its ESN detector and
     data NMSE (288 rows, n_res 300), and [K2 compare2x2 cli detect / nmse
     2 rows] the same at the compare2x2 CLI's --fast run (2 blocks, T =
     266), noise 0; each line prints the tiling
     the wrapper chose (rows a block, blocks, blocks an SM, shared memory);
     [K2 tf32 ...] at each of those shapes (and [K2 carried] below) K2's
     TF32 build, the route of the configurations' recurrence_precision
     None, against the plain TF32 form (esn_predict(..., tf32=True)) at
     atol 5e-4 / rtol 1e-3, with the plain TF32 form's distance from the
     fp32 one, the TF32 and fp32 builds' ms in turns, and one launch
     counted in `launches_tf32`; [K2 tf32 short ...] the rounding rule
     itself, one step from a carried state (flagship and NBF: a drawn
     state; carried: the fit's): the build within a tenth of the plain
     TF32 form's distance from the fp32 one; [K2 tf32 rounding] the rms of
     the pre-activation's TF32-vs-fp32 difference at a fit's harvested
     states beside the state noise's, and the noise band on the TF32 route;
     [K2 siso highest] precision "highest" launches the fp32 build,
     identical to a call with no precision; [K2 route] (before the result
     lines) the TF32 share of K2's launches on each counted run, all of
     them on the cells' paths;
  4. K3, the ESN state harvest (csrc/esn_states.cu, a thread-block cluster
     kernel), against plain esn_states at the mimo_4x8_nbf fit shape (128 x
     522 x 600) and the flagship fit shape (128 x 138 x 300), the same
     tolerances; each line prints the cluster plan the wrapper chose
     (`models/esn_states_cuda.py:states_plan`: CTAs a cluster, clusters,
     rows a cluster and its row tile, columns and shared memory a CTA), the
     kernel's ms beside its time before the cluster design, and the
     yardstick: one cuDNN call of torch.nn.RNN (tanh, no bias) that computes
     the same function at noise 0, its ms and its error against plain (the
     port never calls it; its ms is K3's library_ms); [K3 ragged] 100, 9 and
     300 rows at the NBF fit shape; [K3 siso 1 row / 16 rows] the
     siso_qpsk_awgn fit (512 x 200, n_in = n_out = 2), [K3 sweep n_res
     50 / 600] the sweep's fits (16 x 522, n_in = n_out = 4), [K3 zoo2x2
     fit] the 2x2 comparison's fits (16 x 522 x 300, n_in = n_out = 4),
     [K3 compare2x2 cli fit] the CLI's --fast fits (2 x 266 x 300) and
     [K3 classify sm2 2 rows] the classify CLI's sm2 fit (2 x 138 x 300,
     n_in 16, n_out 8), noise 0, with the plan, ms, plain ms and bound;
  5. K4, the grouped-readout predict (csrc/esn_predict_grouped.cu), against
     plain grouped esn_predict and against K2 at the flagship detect shape,
     [K4-nbf] the same at the mimo_4x8_nbf detect shape (3 slots a block);
     [K2 carried] and [K4 carried]: the flagship detect shape continued
     from the carry of esn_fit(return_carry=True) at the flagship pilot
     shape (128 x 138, n_res 300; each block's last state and output on its
     74 rows) against plain esn_predict(init_carry=...) at atol 1e-4 /
     rtol 1e-3, with ms, the zero-carry ms in the same turns, plain ms and
     bound; [K2 carried ragged] 9,435 rows, a carry and a readout a row;
     [K1-layered] the row-layered BP decoder (csrc/bp_decode_layered.cu)
     against plain layered BP on the same codewords as K1 (cap 50) and
     K1-nbf (caps 50 and 100): identical for both min-sum rules,
     sum-product (the NBF preset's rule) in the band, each line with the
     launch plan as above; then layered at cap 50 against flooding at
     cap 100 (BER, unconverged share, ms per sweep);
     [K5] every ablation build of the predict recurrence
     (csrc/esn_predict_ablate.cu) against its plain version at the
     micro-benchmark's shape (9,472 rows, one readout per row), then the
     micro-benchmark itself (tools/bench_micro_torch.py, group pred), one
     line per variant;
     [svd 8x4], [svd 2x2], [svd 2x1] the small-SVD kernel
     (csrc/svdvals_small.cu, a port kernel: the JAX package's
     svdvals_small is plain jnp; Hermitian Jacobi on H^H H) against its
     plain version and the library SVD (torch.linalg.svdvals, the
     yardstick) on the channels of one full-width round, 128 blocks of
     mimo_4x8_nbf (65,536 matrices of 8 x 4), of mimo_2x2_nbf and of
     simo_1x2_nbf: each singular value within 1e-5 relative of plain
     (and whether identical), ranks and condition histogram equal to
     plain's, capacity within rtol 1e-5 of the library's; ms, plain ms,
     library ms, bound (and the real-embedded algorithm's count beside
     it); [svd build ...] each build's registers, local memory (a spill
     fails), SASS instructions a rotation and their issue floor (from
     cuobjdump, where the toolkit has it);
     [calib fit] the calibrator fit's step kernel (csrc/logreg_step.cu, a
     port kernel: the JAX package fits in plain jnp) through
     `fit_logreg_1d` against `fit_logreg_1d_plain` on one detector's pairs
     at the flagship fit's shape (4 x 969,933, the view `.T[..., ::10]`
     of 9,699,328 pairs), 400 steps (tools/bench_calib_fit_torch.py):
     (a, b) identical, eager and replayed from a CUDA graph, 401 launches
     a fit; the ms of a fit by each route, the step kernel's and the two
     means' ms a step, the bounds by bytes (the kernels line's: one read
     of the pairs a step), and the host ms of launching graphs of several
     node counts on an idle card and behind a 50 ms kernel;
     [K7 gru train] the zoo's GRU kernel (csrc/gru_train.cu, a port
     kernel: the JAX package trains rnn_apply's lax.scan under jax.grad)
     against its plain version (ops/gru_cuda.py, autograd) at the zoo
     cell's shape, 128 blocks x 522 steps: outputs, losses and every
     weight gradient within 1e-5 relative, predictions of 18 sequences a
     block likewise; ms of a training and a prediction launch at 128
     blocks and at one (the serial chain), the bound, plain ms;
  6. small reference checks: tiny CDL and tiny NBF configurations through
     `cdl_snr_point` / `nbf_snr_point` on the GPU (kernels) and on the CPU
     (plain versions), classical-detector counters within a few bit flips;
  7. the main paths at full width, each with every kernel's launch count
     reset just before and read just after:
       [nbf main] `nbf_snr_point` on mimo_4x8_nbf (N = 512, 4x8, n_res = 600,
       T = 522, D = 18, n = 2048), 128 blocks, one round at 3 dB (doubled
       BP cap) and at 12 dB, five detectors: K1, K2, K3 and the SVD kernel
       launched, the threefry kernel 33 times (a launch a draw); the 12 dB analytics equal the SVD kernel's on [svd 8x4]'s
       H, printed beside the library SVD's (full rank, histogram L1,
       capacity);
       [nbf uncoded] the 12 dB point with ldpc.enabled=False on the same
       keys: no BP launched, no decode phase, the coded counters empty,
       every uncoded BER within 10% of the coded run's;
       [main] `cdl_snr_point` on the flagship mimo_4x8_cdl (N = 128, 4x8,
       n_res = 300, D = 74, n = 512), 128 blocks, one calibration and one
       decode round at 12 dB: K1, K2 and K3 launched, the threefry kernel
       52 times;
       [main grouped] the same flagship point with
       ESN_TPU_PREDICT_READOUT=grouped: K4 launched;
       [main newton] the same point with CalibConfig(fit_method="newton"):
       coded BERs within 25% + 2e-3 of the GD fit's, both fits' ms;
       [block main] the flagship point in EsnConfig(rng_mode="block"), 16
       blocks, 1 cal + 1 decode round: K3 and K2 launched once a block of
       each round (one reservoir a block, each block's ESN alone), the
       counters and calibrators of rounds of 8 x 2 identical to one round
       of 16, block 2's reservoir and readout alone identical to a batch of
       4, uncoded BERs in (0, 0.5), each phase's ms and the ESN's ms a
       block (fit: K3 on one row and the readout solve; detect: K2 on 74
       rows); [block nbf] the same on mimo_4x8_nbf at full width, 8 blocks,
       one round at 12 dB (K3 and K2 twice a block: matched and 12 dB
       fixed);
       [cal chunks] the detection-throughput path,
       pipelines/cdl.py:run_cdl_cal_counters_chunks, on the flagship at 12
       dB, 16 chunks of 128 blocks (keys from block ids in order, as
       bench.py builds them; depth cut from its 64 chunks): one chunk
       captured as a CUDA graph and replayed 16 times, after a warm-up
       call; counters identical to 16 eager run_cdl_cal_blocks calls; the
       replays launch nothing from Python (every wrapper's count stays 0)
       and a torch.profiler trace of them counts K2 and K3 16 times each
       by kernel name; one eager chunk under
       torch.cuda.set_sync_debug_mode("error") (no host sync), the wall of
       the replays, of the eager
       loop and of the eager counters-only loop, detected symbols/s and
       TFLOP/s (utils/flops.py:cdl_flops) with their share of the fp32
       peak, the capture's ms and the graph pool's MiB; [cal chunks block]
       the same in rng_mode="block", 2 chunks of 4 blocks (K2 and K3 once
       a block);
       [cdl snr step] the fused CDL point, parallel/montecarlo.py:
       make_fused_cdl_snr_step, at bench.py's e2e shape (the flagship at 12
       dB, 128 blocks, 2 calibration + 6 decode rounds, bench.py's keys):
       the first call captures the cal, fit, detect and decode bodies as
       CUDA graphs, 3 replayed calls on new keys; every counter and both
       calibrators identical to the eager cdl_snr_point on the same keys,
       a replayed call traced (K1 6, K2 8, K3 8 by kernel name; none from
       Python) and one under set_sync_debug_mode("error"); the capture's
       ms, the pool's MiB, the best replayed wall against the eager one
       and e2e decoded symbols/s (8 x 128 x 75 / wall, bench.py's);
       [bench] bench_torch.py's main in this process at bench.py's full
       shape (64 chunks of 128 blocks, 2 + 6 rounds, 5 timed calls each),
       replaying the chunk and the point that [cal chunks] and [cdl snr
       step] captured: its one stdout line (logged) has bench.py's keys,
       value and e2e_decoded_symbols_per_s in (0, 1e9), every mfu_* in
       (0, 1), every bp_unconverged_frac in [0, 1]; no speed gate;
       [cdl grid] make_fused_cdl_grid at 9, 12 and 15 dB, 128 blocks, 1 +
       1 rounds: identical to the per-SNR loops of the fused step and of
       the eager cdl_snr_point, the wall of each, launches from a trace;
       [nbf step] the fused NBF route, parallel/montecarlo.py:
       make_sharded_nbf_scan_step, on mimo_4x8_nbf at full width, 128
       blocks x 2 rounds at 12 dB: the first call captures the round's
       body (BP cap 100), 3 replayed calls on new keys; every counter
       identical to the eager nbf_snr_point on the same keys, capacity_sum
       included; a replayed call traced (K1 2, K2 4, K3 4, the SVD kernel
       2 by kernel name; none from Python) and one under
       set_sync_debug_mode("error"); a call at 3 dB (the body of cap 200)
       identical to eager; capture ms, pool MiB, the best replayed wall
       against the eager one, detected symbols/s; [nbf grid]
       make_fused_nbf_grid at 3 and 12 dB, 128 blocks x 1 round, identical
       to the per-SNR loops of the scan step and of nbf_snr_point; [nbf
       step block] the scan step in rng_mode="block", 2 blocks x 1 round
       at 12 dB, identical to the eager point;
       [curve] the CLI, esn_ofdm_mimo_tpu_torch.experiments.run.main, on
       mimo_4x8_cdl at 9, 12 and 15 dB, 256 blocks per SNR in rounds of 128
       with the adaptive top-up: without a checkpoint it takes the grid
       route (recorded; the graph cache released first, so the run
       captures its graphs and the wrappers count the warm-ups'
       launches): K1, K2, K3 launched, the artifacts written and parsed,
       MMSE coded BER non-increasing; with --resume (checkpoints: the
       per-SNR step) and with --debug-nans (the eager route) on the same
       keys it writes the same CSV; a second call with --resume launches
       nothing and writes the same CSV; then `run_cdl_curve` (the grid
       route, captured in the run as above) on the same keys with
       flooding at max_iter 100 and with LdpcConfig(schedule="layered",
       max_iter=50): the layered kernel launched and the flooding one not,
       MMSE coded BER in the flooding run's band, decode ms of both (the
       card's time between CUDA events);
       [curve nbf] the CLI on mimo_4x8_nbf at 3 and 12 dB, 128 blocks, on
       the grid route (recorded; graphs released first): artifacts
       written, BERs equal to `nbf_snr_point` on the same keys; with
       --resume (the scan step) and --debug-nans (the eager route) the
       same CSV;
       [curve nbf qam6] the same with --qam-bits 6 at 12 dB: K1 at n =
       3,072 (Z = 384), the CSV equal to `nbf_snr_point` on the same keys;
       [curve siso] the CLI on siso_qpsk_awgn at full width (N = 512,
       400-symbol blocks, n_res 200), 8 rounds of one block at 12, 15 and
       21 dB: K1, K2 and K3 launched, the artifacts parsed, BERs in bands
       of the JAX package's TPU curve (MMSE uncoded 0.7-1.4x of 3.85e-3 at
       12 dB, ESN uncoded 0.5-2x of 1.99e-3 at 15 dB and <= 1e-4 at 21 dB,
       MMSE coded 0 at 21 dB);
       [curve gallager] the CLI on mimo_2x2_nbf --ldpc-family gallager at
       12 and 18 dB (16 blocks) and [curve pyldpc] on mimo_4x8_cdl
       --ldpc-family pyldpc at 12 dB (128 blocks): the graph decoder ran
       and no BP kernel, MMSE coded <= uncoded (Gallager at 18 dB: at 12 dB
       the JAX package's own curve has coded above uncoded; pyldpc <= 0.02),
       beside the JAX package's TPU runs, MMSE uncoded within 10% of a QC
       run on the same keys, decode ms of both;
       [sweep] experiments.sweep.main --param reservoir and spectral, 16
       blocks of mimo_2x2_nbf at 12 dB: K2 once and K3 twice a value, every
       BER in (0, 0.5), the JSON written; run_sweep at 2 blocks and noise 0
       on the card against the CPU within 1% + 10 bit errors a value;
       [classify sm1] the classify CLI, esn_ofdm_mimo_tpu_torch.experiments.
       classify.main, at --fast --batch 64 --variant wide (system model 1
       at full width: 5G grid of 64 x 14 REs, 4 x 8 spatial CDL-B, NR LDPC
       k = 1,536 / E = 3,072, 196,608 symbols an SNR at 0, 10 and 20 dB,
       the wide zoo, 60 epochs): no kernel but the threefry kernel
       launched, 156 times (52 an SNR); the traditional
       demapper's SER in (0.010, 0.028) at 10 dB and (0.33, 0.43) at 0
       dB, the ELM within 0.01 of it at 10 dB, every model below 0.5 at 20
       dB, the parameter counts exact, E|z|^2 within 0.05 of 1 on the 10
       dB dataset; the wall, peak device memory and each phase's ms per
       SNR (the dataset's steps, the split, each model), and the RNG draws
       timed alone;
       [classify sm1 cpu] the sm1 dataset at batch 2 on the card and on the
       CPU from one key at 0, 10 and 20 dB: labels identical, features
       within 1e-4;
       [classify sm2] the CLI at --frontend sm2 --fast (mimo_4x8_cdl at full
       width, 2 blocks an SNR): K3 launched, SERs printed; the CLI's
       [warn] lines (the best-effort PNG step) are passed on to the log;
       [compare2x2] `run_zoo_blocks` (the 2x2 model-zoo comparison) on
       uncoded mimo_2x2_nbf at full width (N = 512, n_res 300, T = 522, D
       = 18), 16 blocks, 50 epochs, seed 0, at 12 and 30 dB with the CLI's
       keys (SNR indices 4 and 10: the draws of the JAX package's TPU run,
       results/compare_2x2_tpu_r3), depth cut from 11 SNRs to 2: K3 twice
       and K2 three times an SNR (after a 2-epoch warm-up at the same
       shapes); the classical detectors' BERs within 2% relative of the TPU
       run's, the trained models' within 0.002, the ESN's within 0.03
       (its state noise comes from another stream), every BER in (0, 0.5),
       the NMSEs beside the TPU run's, each phase's ms; [compare2x2 gru]
       the GRU's per-block training through torch.nn.GRU (cuDNN) against
       the plain vmapped loop at that pilot shape, 5 epochs: losses within
       1e-5 relative, ms an epoch of both; the trained GRUs' predictions
       of 16 x 18 rows against rnn_apply's within 1e-4, ms of both;
       [zoo step] the captured zoo round (make_zoo_step on the zoo
       cell's configuration, n_res 100, 128 blocks, 50 epochs, 12 dB):
       two replays launch nothing from Python, a replay equals eager
       run_zoo_blocks on the same keys; capture and replay walls, the
       eager wall and a replay's phases (device ms);
       [compare2x2 cli] the CLI at --fast --blocks 2 --epochs 5: its
       artifacts written and read; one step for all SNRs, K3, K2 and K7
       launched only by its first call's warm-up and capture;
       [dist nccl] a torch.distributed process group of world size 1 on
       NCCL from the variables torchrun sets (maybe_init_distributed):
       run_nbf_curve (mimo_4x8_nbf, 8 blocks) and run_cdl_curve
       (mimo_4x8_cdl, 16 blocks; both fused, as at one rank) over it
       identical to the same calls without a group; the eager
       nbf_snr_point (8 blocks, 12 dB) over it, its counters summed by an
       NCCL all_reduce, identical to the point without a group;
       sharded_fir at one rank within 1e-6 of the FIR; [dist nccl fused]
       make_fused_cdl_snr_step and make_fused_cdl_grid (mimo_4x8_cdl, 8
       blocks, 1 + 1 rounds), make_sharded_nbf_scan_step and
       make_fused_nbf_grid (mimo_4x8_nbf, 8 blocks, 1 round) over the
       group (the pairs gathered, the counters summed by NCCL between the
       replays) identical to the same calls without a group and to the
       eager route over the group; a replayed call of each step under
       set_sync_debug_mode("error"), one traced (K1, K2, K3, on NBF the
       SVD kernel, launched by replays; none from Python), the walls
       beside the eager route's; the group destroyed afterwards;
       [scaling] the scaling CLI (experiments/scaling.py --fast) at one
       NCCL rank, its --out read (one card: no scaling efficiency);
       [dist fused 2 ranks] two processes on the one card (`chip_smoke.py
       --dist-child`, a timeout each) in a gloo group, each replaying its
       own CUDA graphs on its share: the flagship's fused point and grid
       (2 x 8 blocks, 1 + 1 rounds, 12 dB) and the NBF scan step (2 x 4
       blocks) equal one process's fused route on the same global blocks
       in rng_mode="block" (calibrators included) and the eager route over
       the two ranks in "batch", bit for bit.
     No QC path may reach the graph decoder (its count stays 0);
  8. one JSON line listing the kernels (launches on the main paths: the
     wrappers' counts, and for the phases with CUDA graph replays the
     kernels of their trace; error
     against the plain version, times, bound: the largest of bytes over the
     memory rate, fp32 operations over the fp32 peak and transcendentals
     over the special-function unit's rate; library_ms the cuDNN RNN's for
     K3, torch.linalg.svdvals's for the SVD kernel, null for the others),
     then the card line and the
     final {"ok": true, ...} line.

Every phase ends in torch.cuda.synchronize(); any failure exits non-zero
before the final line. Without CUDA it exits 1 and prints no result.

--profile adds one more run of the flagship and the 12 dB NBF main paths,
of [cal chunks]'s 16 replays and of one replayed [cdl snr step] and [nbf
step] call under torch.profiler and prints the device time by kernel and the device's busy
share of each run's wall time, the threefry kernel's launches and the
int64 elementwise launches left.
"""
from __future__ import annotations

import contextlib
import csv
import io
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
# Transcendentals (ex2, lg2, rcp, ...) run on the special-function unit: 16
# results a clock on each SM (4 a sub-partition; the CUDA C++ Programming
# Guide's arithmetic-throughput table for compute capability 9.0) against
# 128 fp32 lanes of 2 flops (a fused multiply-add): a sixteenth of the fp32
# peak.
_SFU_PER_S = _FP32_FLOP_PER_S / 16


def _fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond, msg: str):
    if not cond:
        _fail(msg)


def _log(msg: str):
    print(msg, flush=True)


def _bound(n_bytes: float, ops: float, transc: float = 0.0):
    """(least ms for the work on the card, what bounds it): the largest of
    bytes over the memory rate, fp32 operations over the fp32 peak and
    transcendentals over the special-function unit's rate."""
    t = {"bytes": n_bytes / _HBM_BYTES_PER_S,
         "operations": ops / _FP32_FLOP_PER_S,
         "transcendentals": transc / _SFU_PER_S}
    by = max(t, key=t.get)
    return 1e3 * t[by], by


def _entry(name, source, replaces, err, ms, plain_ms, n_bytes, ops,
           transc=0.0):
    bound_ms, by = _bound(n_bytes, ops, transc)
    # the line's vocabulary: the special-function unit's operations over
    # its rate are operations too
    return dict(name=name, route="cuda",
                source=f"esn_ofdm_mimo_tpu_torch/csrc/{source}",
                replaces=replaces, launches=0, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if by == "bytes" else "operations",
                library_ms=None)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke run needs a GPU")

    from esn_ofdm_mimo_tpu_torch import config as tc
    from esn_ofdm_mimo_tpu_torch.experiments.presets import (mimo_2x2_nbf,
                                                             mimo_4x8_cdl,
                                                             mimo_4x8_nbf,
                                                             simo_1x2_nbf,
                                                             siso_qpsk_awgn)
    from esn_ofdm_mimo_tpu_torch.ldpc import decode as bp_graph
    from esn_ofdm_mimo_tpu_torch.ldpc import decode_cuda, ldpc_encode, \
        make_code
    from esn_ofdm_mimo_tpu_torch.ldpc.decode import ldpc_decode_bp_plain
    from esn_ofdm_mimo_tpu_torch.models import esn_cuda, esn_states_cuda
    from esn_ofdm_mimo_tpu_torch.ops import analytics, gru_cuda, logreg_cuda
    from esn_ofdm_mimo_tpu_torch.models.esn import (EsnScale, esn_fit,
                                                    esn_predict, esn_states,
                                                    init_reservoir,
                                                    scale_inputs)
    import dataclasses

    from esn_ofdm_mimo_tpu_torch.experiments import run as cli
    from esn_ofdm_mimo_tpu_torch.models.esn import (ABLATE_PARTS,
                                                    esn_predict_ablate)
    from esn_ofdm_mimo_tpu_torch.experiments import sweep as esn_sweep
    from esn_ofdm_mimo_tpu_torch.parallel import (cdl_snr_point,
                                                  nbf_snr_point,
                                                  run_cdl_curve)
    from esn_ofdm_mimo_tpu_torch.models.esn_mimo import (
        esn_detect_symbols_per_block, train_mimo_esn_per_block)
    from esn_ofdm_mimo_tpu_torch.pipelines.common import DETECTORS, \
        synth_block
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
                (esn_cuda, "launches_ablate", "esn_predict_ablate"),
                (analytics, "launches", "svdvals_small"),
                (rng, "launches", "threefry"),
                (logreg_cuda, "launches", "logreg_step"),
                (gru_cuda, "launches", "gru_train"),
                # not a kernel: the plain BP of Gallager and pyldpc codes
                (bp_graph, "graph_decodes", "graph_decode"))

    def reset_counts():
        for mod, attr, _ in counters:
            setattr(mod, attr, 0)
        esn_cuda.launches_tf32 = 0

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

    def tf32_close(got, want, what: str) -> float:
        """K2's TF32 build against the plain TF32 form (esn_predict(...,
        tf32=True)): atol 5e-4, rtol 1e-3. The tensor cores round a tile's
        sum otherwise than fp32 multiply-adds, and a run compounds it over
        its steps; the plain TF32 form itself lies up to ~4e-4 from the fp32
        one at these shapes."""
        sync()
        err = float((got - want).abs().max())
        _check(got.shape == want.shape and bool(torch.isfinite(got).all()),
               f"{what} output has the wrong shape or is not finite")
        _check(torch.allclose(got, want, atol=5e-4, rtol=1e-3),
               f"{what} differs from the plain TF32 form (max abs err {err})")
        return err

    # K2 launches by route, per counted run: (what, TF32 launches, all)
    k2_routes = []

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

    # ---- [rng]: the threefry kernel (csrc/threefry.cu) --------------------
    # against its plain version (utils/rng.py *_plain) at the shapes the
    # main paths draw: keys, bits and uniforms at the flagship round's AWGN
    # shape, that AWGN's normal (ops/channel.py:awgn on
    # split(fold_in(block keys, _K_DNOISE))[..., 0, :], a strided view),
    # the round's LDPC info bits and the mimo_4x8_nbf round's AWGN normal.
    # Gates: identical; a normal within 2 ulp (log1pf and sqrtf rounding as
    # torch's CUDA log1p and sqrt make it identical), the differing draws
    # counted. Bound: the larger of the bytes (the keys read once, the
    # output written once) over the HBM rate and the integer operations
    # over 132 SMs x 64 int32 lanes x the SM's maximum clock (nvidia-smi)
    import numpy as np

    from esn_ofdm_mimo_tpu_torch.pipelines.common import _K_DBITS, _K_DNOISE
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    int_ops_per_s = 132 * 64 * clock_mhz * 1e6

    def rng_bound(mode: str, n: int, rows: int):
        """(ms, what bounds it) of n draws of `mode` from `rows` keys, in
        the fewest int32 instructions the work needs. Once a key: the
        extended key word k0 ^ k1 ^ 0x1BD11BDA (one three-input LOP3).
        Once an element, 67: x1's counter add, 20 rounds of an add, a
        rotation and an xor, the 5 injections into x1 (word + key + round
        in one IADD3) and the last into x0 (x0's counter add and its
        other 4 injections fold into the next round's add, an IADD3); then
        the epilogue (bits: an xor; the float modes: the xor, and the
        shift and the or as one shift-and-add, their bits being disjoint).
        fp32 operations: the uniform's 6 (subtract, widen, multiply, add,
        round, clamp), the normal's 25 more (the erfinv: log1p counted as
        one, 8 multiply-adds as 16), Bernoulli's compare. The float64
        steps are counted at the fp32 rate: a lower bound."""
        out_b = {"hash": 16, "bits": 8, "uniform": 4, "normal": 4,
                 "bernoulli": 1}[mode]
        n_int = rows + n * (67 + {"hash": 0, "bits": 1}.get(mode, 2))
        n_fp = n * {"uniform": 6, "normal": 31, "bernoulli": 7}.get(mode, 0)
        t = {"bytes": (16 * rows + out_b * n) / _HBM_BYTES_PER_S,
             "operations": max(n_int / int_ops_per_s,
                               n_fp / _FP32_FLOP_PER_S)}
        by = max(t, key=t.get)
        return 1e3 * t[by], by

    def ulps(a, b):
        return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()

    bk_r = rng.block_keys(rng.prng_key(0), 1, torch.arange(128)).to(dev)
    kri_r = rng.split(rng.fold_in(bk_r, _K_DNOISE))[..., 0, :]
    shape_c = (cfg.data_symbols_per_block, cfg.channel.n_rx,
               cfg.ofdm.n_subcarriers + cfg.ofdm.cp_len)
    shape_n = (nbf.data_symbols_per_block, nbf.channel.n_rx,
               nbf.ofdm.n_subcarriers + nbf.ofdm.cp_len)
    code_c = make_code(cfg.ldpc, cfg.ofdm.n_subcarriers
                       * cfg.ofdm.bits_per_symbol)
    shape_b = (cfg.data_symbols_per_block, cfg.channel.n_tx, code_c.k)
    kb_r = rng.fold_in(bk_r, _K_DBITS)
    rng_cases = (
        ("fold_in", "hash", rng.fold_in, (bk_r, _K_DNOISE)),
        ("split", "hash", rng.split, (bk_r,)),
        ("bits", "bits", rng.random_bits, (kri_r, shape_c)),
        ("uniform [0, 2 pi)", "uniform", rng.uniform,
         (kri_r, shape_c, 0.0, 2 * np.pi)),
        ("normal flagship AWGN", "normal", rng.normal, (kri_r, shape_c)),
        ("bernoulli flagship info bits", "bernoulli", rng.bernoulli,
         (kb_r, 0.5, shape_b)),
        ("normal nbf AWGN", "normal", rng.normal, (kri_r, shape_n)))
    rng_err = 0.0
    for what, mode, fn, args in rng_cases:
        plain = getattr(rng, fn.__name__ + "_plain")
        got, want = fn(*args), plain(*args)
        sync()
        _check(got.shape == want.shape and got.dtype == want.dtype,
               f"rng {what}: {got.dtype} {tuple(got.shape)} against plain "
               f"{want.dtype} {tuple(want.shape)}")
        n_diff, max_ulp = int((got != want).sum()), 0
        if mode == "normal":
            _check(bool(torch.isfinite(got).all()),
                   f"rng {what}: a normal is not finite")
            max_ulp = int(ulps(got, want).max())
            _check(max_ulp <= 2, f"rng {what}: {n_diff} normals differ from "
                                 f"plain, up to {max_ulp} ulp (at most 2)")
            rng_err = max(rng_err, float((got - want).abs().max()))
        else:
            _check(n_diff == 0, f"rng {what}: {n_diff} of {got.numel()} "
                                f"elements differ from the plain version")
        n = got.numel() // (2 if mode == "hash" else 1)
        rows = bk_r.shape[0]
        ms = cuda_ms(lambda: fn(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 3)
        b_ms, b_by = rng_bound(mode, n, rows)
        _log(f"[rng {what}] {tuple(got.shape)} {str(got.dtype)[6:]} from "
             f"{rows} keys: identical to plain {n_diff == 0} (differing "
             f"{n_diff}, max ulp {max_ulp}) | kernel {ms:.4f} ms plain "
             f"{plain_ms:.3f} ms bound {b_ms:.3g} ms ({b_by}; int32 at "
             f"{int_ops_per_s / 1e12:.2f} T/s from {clock_mhz:.0f} MHz) | "
             f"{smi}")
        if what == "normal flagship AWGN":
            kernels["threefry"] = dict(
                name="threefry", route="cuda",
                source="esn_ofdm_mimo_tpu_torch/csrc/threefry.cu",
                replaces="esn_ofdm_mimo_tpu/ops/channel.py:275 (awgn's "
                         "jax.random.normal: jax.random's threefry2x32_p, "
                         "no pl.pallas_call)",
                launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del got, want
    kernels["threefry"]["max_abs_err"] = rng_err
    del kri_r, kb_r

    # ---- 2. K1: BP decoder vs its plain version -----------------------------
    # The sum-product rule on its own, on the card (the exported entry of
    # csrc/bp_decode.cu) and in the plain version, against float64 on a
    # log-spaced grid of both signs: t = tanh(q / 2) over |q| in [1e-6, 16],
    # r = log((1 + p) / (1 - p)) over |p| in [1e-6, 0.9999999]. Each value
    # within 1e-5 relative or 5e-7 absolute (about 4 ulps of 1.0, the
    # resolution of any 1 +- p in fp32), whichever is larger.
    import numpy as np
    from esn_ofdm_mimo_tpu_torch.ldpc.decode import log_ratio, tanh_half
    for which, hi, ref in (("t", 16.0, lambda x: np.tanh(0.5 * x)),
                           ("r", 0.9999999, lambda x: 2.0 * np.arctanh(x))):
        g = np.logspace(-6.0, np.log10(hi), 100_001)
        x = np.concatenate([-g[::-1], g]).astype(np.float32)
        x = np.clip(x, -np.float32(hi), np.float32(hi))
        want = ref(x.astype(np.float64))
        tol = np.maximum(1e-5 * np.abs(want), 5e-7)
        got_k = decode_cuda.sumprod_rule(torch.as_tensor(x, device=dev),
                                         which).cpu().numpy()
        plain_fn = tanh_half if which == "t" else log_ratio
        got_p = plain_fn(torch.as_tensor(x)).numpy()
        worst = {}
        for name, got in (("kernel", got_k), ("plain", got_p)):
            _check(np.isfinite(got).all(), f"K1 rule {which}: {name} not "
                                           f"finite")
            err = np.abs(got.astype(np.float64) - want)
            worst[name] = (float((err / tol).max()),
                           float((err / np.abs(want)).max()))
            _check(worst[name][0] <= 1.0,
                   f"K1 rule {which}: the {name} version is outside 1e-5 "
                   f"relative / 5e-7 absolute of float64 (worst "
                   f"{worst[name][0]:.3f} of the tolerance)")
        _log(f"[K1 rule] {which} on {x.size} points: worst share of the "
             f"tolerance kernel {worst['kernel'][0]:.4f} plain "
             f"{worst['plain'][0]:.4f} | max relative error kernel "
             f"{worst['kernel'][1]:.3e} plain {worst['plain'][1]:.3e}")

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

    def k1_band(code, llr, u, what: str, **kw):
        """Sum-product: K1 against the plain version in a stated band. Bit
        agreement > 0.99, iterations > 0.9, converged flags > 0.95; frame
        error rate (counts mode) within 3 binomial sigma + 0.002, info-bit
        BER within 5% relative, mean iterations within 2%. Returns the
        kernel's iteration sum and converged share."""
        bits_k, st_k = decode_cuda.ldpc_decode_bp_cuda(code, llr, **kw)
        err_k, stc_k = decode_cuda.ldpc_decode_bp_cuda_counts(code, llr, u,
                                                              **kw)
        bits_p, st_p = ldpc_decode_bp_plain(code, llr, **kw)
        err_p, _ = ldpc_decode_bp_plain(code, llr, count_against=u, **kw)
        sync()
        B = llr.shape[0]
        agree = float((bits_k == bits_p).float().mean())
        it_agree = float((st_k["iterations"] == st_p["iterations"])
                         .float().mean())
        cv_agree = float((st_k["converged"] == st_p["converged"])
                         .float().mean())
        fer_k, fer_p = (float((e > 0).float().mean()) for e in (err_k, err_p))
        ber_k, ber_p = (float(e.double().sum()) / u.numel()
                        for e in (err_k, err_p))
        mi_k, mi_p = (float(st["iterations"].double().mean())
                      for st in (st_k, st_p))
        fer_tol = 3.0 * (fer_p * (1.0 - fer_p) / B) ** 0.5 + 0.002
        _log(f"[{what}] sum-product, {B} codewords of n = {code.n}: bit "
             f"agreement {agree} iterations {it_agree} converged {cv_agree} "
             f"| FER {fer_k:.5f} plain {fer_p:.5f} (band {fer_tol:.5f}) | "
             f"BER {ber_k:.5e} plain {ber_p:.5e} | mean iterations "
             f"{mi_k:.3f} plain {mi_p:.3f}")
        _check(agree > 0.99 and it_agree > 0.9 and cv_agree > 0.95,
               f"{what} outside the agreement band")
        _check(torch.equal(stc_k["iterations"], st_k["iterations"]),
               f"{what} counts mode ran other iterations than bits mode")
        _check(abs(fer_k - fer_p) <= fer_tol,
               f"{what} FER {fer_k} outside {fer_tol} of the plain {fer_p}")
        _check(abs(ber_k - ber_p) <= 0.05 * ber_p,
               f"{what} BER {ber_k} outside 5% of the plain {ber_p}")
        _check(abs(mi_k - mi_p) <= 0.02 * mi_p,
               f"{what} mean iterations {mi_k} outside 2% of the plain "
               f"{mi_p}")
        return (int(st_k["iterations"].long().sum()),
                float(st_k["converged"].float().mean()))

    def k1_work(code, llr, u, it_sum, algo):
        """Bytes (LLRs in, truth in, counts/stats out), operations (13 fp32
        ops per edge and executed iteration: q = Lt - r, clip x2, |q|,
        min/second-min x2, sign, select, offset, max, sign product,
        posterior add, parity) and transcendentals: 2 per edge and executed
        iteration under sum-product (the least a check rule takes, one
        tanh-like and one log-like), 0 under either min-sum rule."""
        edge_its = code.dv * code.n * it_sum
        return (llr.numel() * 4 + u.numel() + llr.shape[0] * (4 + 4 + 1),
                13.0 * edge_its, 2.0 * edge_its if algo == "sumprod" else 0.0)

    def layered_plan_str(Z: int, algo: str) -> str:
        """The layered kernel's launch at lifting size Z: bp_plan's threads,
        codewords and shared memory, the build's registers and the
        resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
        p = decode_cuda.bp_plan(Z, "layered")
        regs, blocks = decode_cuda.layered_occupancy(Z, algo)
        return (f"{p.threads} threads, {p.codewords} codeword a block, "
                f"{p.smem_bytes} B shared, {regs} registers, {blocks} blocks "
                f"an SM")

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
    # the JAX kernel-vs-XLA test (the SFU rule against exact exp/log)
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
        0.0, k1_ms, k1_plain_ms, *k1_work(code, llr, u, it_sum, kw["algo"]))
    _log(f"[K1 offset-minsum] {llr.shape[0]} codewords at Eb/N0 1.5/2.5 dB: "
         f"bits, iterations, converged, counts identical | mean iterations "
         f"{it_sum / llr.shape[0]:.3f} converged {conv_frac:.4f} | kernel "
         f"{k1_ms:.3f} ms plain {k1_plain_ms:.3f} ms bound "
         f"{kernels['bp_decode']['bound_ms']:.4f} ms "
         f"({kernels['bp_decode']['bound_by']})")

    # K1 at the NBF code: n = 2048, Z = 256, dv * Z = 1,024 checks, two a
    # thread, (2 + dv) * dc * Z * 4 B = 48 KB of shared memory a codeword;
    # both runtime caps
    code_n = make_code(nbf.ldpc,
                       nbf.ofdm.n_subcarriers * nbf.ofdm.bits_per_symbol)
    u_n, llr_n = awgn_codewords(code_n, 6_400, (1.0, 1.5))
    kw_n = dict(max_iter=2 * nbf.ldpc.max_iter, algo=nbf.ldpc.algo,
                minsum_offset=nbf.ldpc.minsum_offset,
                pass1_iters=nbf.ldpc.pass1_iters)
    # both min-sum rules exact at this code too, on a slice (the plain
    # version's time)
    sub_n = slice(0, 4096)
    for cap in (nbf.ldpc.max_iter, 2 * nbf.ldpc.max_iter):
        for algo in ("offset-minsum", "minsum"):
            it_m, conv_m = k1_identical(
                code_n, llr_n[sub_n], u_n[sub_n], f"K1-nbf {algo} cap {cap}",
                **dict(kw_n, algo=algo, iter_cap=cap))
            _log(f"[K1-nbf {algo} cap {cap}] {sub_n.stop} codewords of n = "
                 f"{code_n.n}: bits, iterations, converged, counts identical"
                 f" | mean iterations {it_m / sub_n.stop:.3f} converged "
                 f"{conv_m:.4f}")
    # the preset's own rule, sum-product: the SFU rule against the plain
    # version's exact exp/log, so a band, not identity
    for cap in (nbf.ldpc.max_iter, 2 * nbf.ldpc.max_iter):
        it_n, conv_n = k1_band(code_n, llr_n, u_n, f"K1-nbf cap {cap}",
                               iter_cap=cap, **kw_n)
    k1n_ms = cuda_ms(lambda: decode_cuda.ldpc_decode_bp_cuda_counts(
        code_n, llr_n, u_n, iter_cap=cap, **kw_n), 2)
    k1n_plain_ms = cuda_ms(lambda: ldpc_decode_bp_plain(
        code_n, llr_n, iter_cap=cap, count_against=u_n, **kw_n), 1)
    k1n_bound, k1n_by = _bound(*k1_work(code_n, llr_n, u_n, it_n,
                                        kw_n["algo"]))
    _log(f"[K1-nbf cap {cap}] {kw_n['algo']} kernel {k1n_ms:.3f} ms plain "
         f"{k1n_plain_ms:.3f} ms bound {k1n_bound:.4f} ms ({k1n_by})")

    # K1 and K1-layered above Z = 256: the codes of the NBF presets at 64-
    # and 256-QAM (--qam-bits 6 / 8: n = 3,072 and 4,096, Z = 384 and 512),
    # 2,048 codewords at two Eb/N0; flooding two checks a thread in blocks
    # of 768 / 1,024 threads, layered one thread a lifted index
    for m_bits in (6, 8):
        code_w = make_code(nbf.ldpc, nbf.ofdm.n_subcarriers * m_bits)
        Zw = code_w.qc.Z
        u_w, llr_w = awgn_codewords(code_w, 1024, (1.0, 1.5))
        for sched, tag, cap_w in (("flooding", "K1", 100),
                                  ("layered", "K1-layered", 50)):
            plan_w = decode_cuda.bp_plan(Zw, sched)
            for algo in ("offset-minsum", "minsum", "sumprod"):
                kw_w = dict(max_iter=cap_w, schedule=sched, algo=algo,
                            minsum_offset=nbf.ldpc.minsum_offset)
                what = f"{tag} Z{Zw} {algo}"
                if algo == "sumprod":
                    it_w, conv_w = k1_band(code_w, llr_w, u_w, what, **kw_w)
                    same = "in the band"
                else:
                    it_w, conv_w = k1_identical(code_w, llr_w, u_w, what,
                                                **kw_w)
                    same = "bits, iterations, converged, counts identical"
                ms_w = cuda_ms(
                    lambda: decode_cuda.ldpc_decode_bp_cuda_counts(
                        code_w, llr_w, u_w, **kw_w), 2)
                b_w, by_w = _bound(*k1_work(code_w, llr_w, u_w, it_w, algo))
                plan_s = (layered_plan_str(Zw, algo) if sched == "layered"
                          else f"{plan_w.threads} threads, "
                               f"{plan_w.checks_per_thread} checks a thread, "
                               f"{plan_w.smem_bytes} B shared")
                _log(f"[{tag} Z{Zw}] {algo}, {llr_w.shape[0]} codewords of "
                     f"n = {code_w.n} at Eb/N0 1.0/1.5 dB, cap {cap_w} "
                     f"({plan_s}): {same} | mean iterations "
                     f"{it_w / llr_w.shape[0]:.3f} converged {conv_w:.4f} | "
                     f"kernel {ms_w:.3f} ms bound {b_w:.4f} ms ({by_w})")
    del u_w, llr_w

    # K1 at the siso_qpsk_awgn code: n = 1024, Z = 128, dv * Z = 512 checks,
    # one a thread; the preset decodes with sum-product
    siso = siso_qpsk_awgn()
    code_s = make_code(siso.ldpc,
                       siso.ofdm.n_subcarriers * siso.ofdm.bits_per_symbol)
    plan_s = decode_cuda.bp_plan(code_s.qc.Z)
    u_s, llr_s = awgn_codewords(code_s, 2048, (1.5, 2.5))
    for algo in ("offset-minsum", "minsum", "sumprod"):
        kw_s = dict(max_iter=siso.ldpc.max_iter, algo=algo,
                    minsum_offset=siso.ldpc.minsum_offset)
        if algo == "sumprod":
            it_s, conv_s = k1_band(code_s, llr_s, u_s, f"K1 siso {algo}",
                                   **kw_s)
            same = "in the band"
        else:
            it_s, conv_s = k1_identical(code_s, llr_s, u_s,
                                        f"K1 siso {algo}", **kw_s)
            same = "bits, iterations, converged, counts identical"
        ms_s = cuda_ms(lambda: decode_cuda.ldpc_decode_bp_cuda_counts(
            code_s, llr_s, u_s, **kw_s), 3)
        plain_s = cuda_ms(lambda: ldpc_decode_bp_plain(
            code_s, llr_s, count_against=u_s, **kw_s), 1)
        b_s, by_s = _bound(*k1_work(code_s, llr_s, u_s, it_s, algo))
        _log(f"[K1 siso] {algo}, {llr_s.shape[0]} codewords of n = "
             f"{code_s.n} (Z = {code_s.qc.Z}) at Eb/N0 1.5/2.5 dB, cap "
             f"{siso.ldpc.max_iter} ({plan_s.threads} threads, "
             f"{plan_s.checks_per_thread} check a thread, "
             f"{plan_s.smem_bytes} B shared): {same} | mean iterations "
             f"{it_s / llr_s.shape[0]:.3f} converged {conv_s:.4f} | kernel "
             f"{ms_s:.3f} ms plain {plain_s:.3f} ms bound {b_s:.4f} ms "
             f"({by_s})")
    del u_s, llr_s

    # ---- 3. K2: ESN predict vs its plain version ----------------------------
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def tiling_str(plan) -> str:
        return (f"tile {plan.height} rows, {plan.blocks} blocks of "
                f"{plan.rows_per_block} rows, {plan.blocks_per_sm} a SM on "
                f"{n_sm} SMs, {plan.waves} wave(s), {plan.smem_bytes} B shared")

    def k2_tiling(res_, inputs_, Wt_out_, grouped=False, ablate=False) -> str:
        """The tiling the wrapper gives a predict call of these operands."""
        dims = (inputs_.shape[0], res_.Wt.shape[0], inputs_.shape[2],
                Wt_out_.shape[2], n_sm)
        if grouped:
            return tiling_str(esn_cuda.grouped_plan(
                dims[0], Wt_out_.shape[0], *dims[1:]))
        return tiling_str(esn_cuda.predict_tiling(
            *dims, heights=esn_cuda.tile_heights(
                dims[1], "ablate" if ablate else "per_row")))

    def predict_shape(c, G: int, seed: int, Dg: int | None = None):
        """Reservoir, scale, grouped readouts and inputs of a detect call of
        G blocks of config c, at full width: Dg rows a block (default the
        config's data symbols)."""
        n_res = c.esn.n_reservoir
        n_in, n_out = 2 * c.channel.n_rx, 2 * c.channel.n_tx
        delay = c.esn.shared_delay(c.ofdm.isi_duration)
        T = c.ofdm.n_subcarriers + c.ofdm.cp_len + delay
        res = init_reservoir(rng.prng_key(seed, dev), n_in, n_out, n_res,
                             c.esn.spectral_radius, c.esn.sparsity, 0.0)
        B = G * (c.data_symbols_per_block if Dg is None else Dg)
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
    # 8.631 ms: this shape on an H100 (700 W) before the carried prologue
    kernels["esn_predict"] = _entry(
        "esn_predict", "esn_predict.cu",
        "esn_ofdm_mimo_tpu/models/esn_pallas.py:101", k2_err, k2_ms,
        k2_plain_ms, *k2_work)
    _log(f"[K2] rows {B} T {T} n_res {res.Wt.shape[0]} G {G} Dg {B // G} "
         f"({k2_tiling(res, inputs, Wt_out)}): "
         f"max abs err {k2_err:.3e} | noise RMS kernel {r_k:.4e} plain "
         f"{r_p:.4e} | kernel {k2_ms:.3f} ms (zero carry; before the "
         f"carried prologue 8.631, ratio {k2_ms / 8.631:.4f}) plain "
         f"{k2_plain_ms:.3f} ms "
         f"bound {kernels['esn_predict']['bound_ms']:.4f} ms "
         f"({k2_work[1] / 1e9:.1f} GFLOP)")

    def k2_tf32(r, x, W, nf, label: str, reps: int = 3, carry=None):
        """K2's TF32 build (precision None, the configurations' route)
        against the plain TF32 form at noise 0, one launch counted; its ms
        beside the fp32 build's in the same turns. Returns (max abs err, its
        ms)."""
        n0, t0 = esn_cuda.launches, esn_cuda.launches_tf32
        run = lambda: esn_cuda.esn_predict_cuda(                 # noqa: E731
            r, scale, W, x, nf, 0, init_carry=carry, precision=None)
        if not esn_cuda.tf32_built(r.Wt.shape[0]):
            run()
            _check(esn_cuda.launches_tf32 == t0,
                   f"K2 tf32 {label}: a width with no TF32 build launched one")
            _log(f"[K2 tf32 {label}] n_res {r.Wt.shape[0]}: no TF32 build "
                 f"at this width (csrc/esn_predict_core.cuh:tf32_width); "
                 f"precision None launches the fp32 build")
            return None, None
        got = run()
        _check((esn_cuda.launches - n0, esn_cuda.launches_tf32 - t0) == (1, 1),
               f"K2 tf32 {label}: precision None did not launch the TF32 "
               f"build once")
        want = esn_predict(r, scale, W, x, nf, init_carry=carry, tf32=True)
        want32 = esn_predict(r, scale, W, x, nf, init_carry=carry)
        err = tf32_close(got, want, f"K2 tf32 {label}")
        ms_t = cuda_ms(run, reps)
        ms_f = cuda_ms(lambda: esn_cuda.esn_predict_cuda(
            r, scale, W, x, nf, 0, init_carry=carry), reps)
        plan = esn_cuda.predict_tiling(
            x.shape[0], r.Wt.shape[0], x.shape[2], W.shape[2], n_sm,
            tf32=True)
        _log(f"[K2 tf32 {label}] rows {x.shape[0]} T {x.shape[1]} n_res "
             f"{r.Wt.shape[0]} ({tiling_str(plan)}): against plain TF32 max "
             f"abs err {err:.3e} rms {rms(got - want):.3e} (tolerance atol "
             f"5e-4, rtol 1e-3) | plain TF32 against plain fp32 max "
             f"{float((want - want32).abs().max()):.3e} rms "
             f"{rms(want - want32):.3e} | TF32 {ms_t:.3f} ms, fp32 "
             f"{ms_f:.3f} ms ({ms_f / ms_t:.2f}x)")
        return err, ms_t

    def k2_tf32_short(r, x, W, label: str, carry=None):
        """The rounding rule itself, over one step from a carried state
        (n_forget 0, noise 0), before the runs' drift swamps it: the TF32
        build must lie within a tenth of the plain TF32 form's own distance
        from the plain fp32 one, and the fp32 form at least half that
        distance away. A build that kept fp32 operands, or truncated S or Wt
        instead of rounding them to nearest, lies about as far from the TF32
        form as fp32 does. From the third step on, the last-bit differences
        of the two forms' states flip roundings, and the build drifts to a
        tenth to a half of that distance (ratios 0.07-0.58 over 3-10 steps
        at these shapes, NVIDIA H100 80GB HBM3). Without `carry`, a state
        drawn from a generator of its own, |s| < 0.8."""
        if carry is None:
            g_c = torch.Generator(device=dev)
            g_c.manual_seed(261)
            carry = ((torch.rand(x.shape[0], r.Wt.shape[0], generator=g_c,
                                 device=dev) * 2 - 1) * 0.8,
                     torch.randn(x.shape[0], W.shape[2], generator=g_c,
                                 device=dev))
        x = x[:, :1].contiguous()
        got = esn_cuda.esn_predict_cuda(r, scale, W, x, 0, 0,
                                        init_carry=carry, precision=None)
        want = esn_predict(r, scale, W, x, 0, init_carry=carry, tf32=True)
        want32 = esn_predict(r, scale, W, x, 0, init_carry=carry)
        sync()
        d_t, d_f, d_r = (float((a - b).abs().max()) for a, b in (
            (got, want), (got, want32), (want, want32)))
        _check(d_r > 0 and d_t <= 0.1 * d_r and d_f >= 0.5 * d_r,
               f"K2 tf32 short {label}: against plain TF32 {d_t:.3e}, "
               f"against plain fp32 {d_f:.3e}, the two plain forms "
               f"{d_r:.3e} apart: the build does not round as round_tf32")
        _log(f"[K2 tf32 short {label}] rows {x.shape[0]} T {x.shape[1]} "
             f"n_res {r.Wt.shape[0]}, n_forget 0: max abs err against plain "
             f"TF32 {d_t:.3e}, against plain fp32 {d_f:.3e}, plain TF32 - "
             f"plain fp32 {d_r:.3e} (needs TF32 <= 0.1x and fp32 >= 0.5x "
             f"of it; ratio {d_t / d_r:.4f})")

    k2t_err, k2t_ms = k2_tf32(res, inputs, Wt_out, n_forget, "flagship")
    k2_tf32_short(res, inputs, Wt_out, "flagship")
    # the noise band on the TF32 route, and the size of its rounding: the
    # rms of the pre-activation's TF32-vs-fp32 difference at states of a
    # fit's harvest beside that of the state noise (0.001 / sqrt(12))
    # the noise and the teachers from generators of their own: the later
    # phases' inputs and noise stay those of the shared ones
    g_st = torch.Generator(device=dev)
    g_st.manual_seed(26)
    r_kt, r_pt = noise_band(
        esn_cuda.esn_predict_cuda(noisy, scale, Wt_out, inputs, n_forget,
                                  12345, precision=None),
        esn_predict(noisy, scale, Wt_out, inputs, n_forget, g_st, tf32=True),
        esn_predict(res, scale, Wt_out, inputs, n_forget, tf32=True),
        "K2 tf32")
    st = esn_states(res, scale, inputs[:1024], 0.5 * torch.randn(
        1024, T, Wt_out.shape[2], generator=g_st, device=dev))
    st = st.reshape(-1, st.shape[-1])
    d_pre = rms(esn_cuda.round_tf32(st) @ esn_cuda.round_tf32(res.Wt)
                - st @ res.Wt)
    _log(f"[K2 tf32 rounding] pre-activation TF32 - fp32 rms {d_pre:.3e} "
         f"over {st.shape[0]} harvested states (state rms {rms(st):.3e}) | "
         f"state noise rms {1e-3 / 12 ** 0.5:.3e} | noise 1e-3 on the TF32 "
         f"route: rms kernel {r_kt:.4e} plain {r_pt:.4e}")
    del st

    # K2 on batches no tile height divides, and smaller than the SM count;
    # the summation order differs from the plain matmuls': atol 1e-4, rtol 1e-3
    for B_r, G_r in ((B - 37, (B - 37) // 37), (100, 50)):
        x_r = inputs[:B_r].contiguous()
        W_r = 0.02 * torch.randn(G_r, Wt_out.shape[1], Wt_out.shape[2],
                                 generator=gen, device=dev)
        err_r = close(
            esn_cuda.esn_predict_cuda(res, scale, W_r, x_r, n_forget, 0),
            esn_predict(res, scale, W_r, x_r, n_forget), f"K2 ragged {B_r}")
        _log(f"[K2 ragged] rows {B_r} G {G_r} Dg {B_r // G_r} "
             f"({k2_tiling(res, x_r, W_r)}): max abs err {err_r:.3e}")
        k2_tf32(res, x_r, W_r, n_forget, f"ragged {B_r}")
    del x_r, W_r

    # K2 at the NBF detect shape: n_res = 600 (the 10 x 64 neuron build)
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
         f"({k2_tiling(res_n, inputs_n, Wt_out_n)}): max abs err "
         f"{k2n_err:.3e} | "
         f"kernel {k2n_ms:.3f} ms plain {k2n_plain_ms:.3f} ms bound "
         f"{k2n_bound:.4f} ms ({k2n_by})")
    _check(k2n_ms < k2n_plain_ms,
           f"K2 at the NBF shape ({k2n_ms} ms) is not below its plain "
           f"version ({k2n_plain_ms} ms)")
    k2n_t_err, k2n_t_ms = k2_tf32(res_n, inputs_n, Wt_out_n, n_forget_n,
                                  "nbf", reps=2)
    k2_tf32_short(res_n, inputs_n, Wt_out_n, "nbf")
    # K4 at the same shape: 18 rows a block over runs of 18 touch 3 readouts
    k4n_plan = esn_cuda.grouped_plan(
        inputs_n.shape[0], G, res_n.Wt.shape[0], inputs_n.shape[2],
        Wt_out_n.shape[2], n_sm)
    _check(k4n_plan is not None, "the NBF detect shape does not reach K4")
    run_k4n = lambda: esn_cuda.esn_predict_cuda(                 # noqa: E731
        res_n, scale, Wt_out_n, inputs_n, n_forget_n, 0, readout="grouped")
    pg_n = run_k4n()
    k4n_err = close(pg_n, pp_n, "K4-nbf")
    k4n_vs_k2 = float((pg_n - pk_n).abs().max())
    k4n_ms = cuda_ms(run_k4n, 2)
    Dg_n = inputs_n.shape[0] // G
    _log(f"[K4-nbf] rows {inputs_n.shape[0]} Dg {Dg_n} P "
         f"{esn_cuda.grouped_slots(G, Dg_n, k4n_plan.rows_per_block)} "
         f"({tiling_str(k4n_plan)}): max abs err vs plain {k4n_err:.3e} vs "
         f"K2 {k4n_vs_k2:.3e} | kernel {k4n_ms:.3f} ms, K2 {k2n_ms:.3f} ms")
    del pk_n, pp_n, pg_n, inputs_n

    def k2_shape(c, G_c: int, label: str, seed: int, Dg: int | None = None):
        """K2 against its plain version at the detect shape of G_c blocks of
        config c (noise 0: atol 1e-4 / rtol 1e-3), with its tiling, ms,
        plain ms and bound."""
        r, x, W, nf = predict_shape(c, G_c, seed, Dg)
        err = close(esn_cuda.esn_predict_cuda(r, scale, W, x, nf, 0),
                    esn_predict(r, scale, W, x, nf), f"K2 {label}")
        ms = cuda_ms(lambda: esn_cuda.esn_predict_cuda(r, scale, W, x, nf,
                                                       0), 3)
        plain = cuda_ms(lambda: esn_predict(r, scale, W, x, nf), 1)
        out = torch.empty(x.shape[0], x.shape[1] - nf, W.shape[2])
        b_ms, by = _bound(*predict_work(r, x, W, out))
        _log(f"[K2 {label}] rows {x.shape[0]} T {x.shape[1]} n_res "
             f"{r.Wt.shape[0]} n_in {x.shape[2]} n_out {W.shape[2]} G {G_c} "
             f"({k2_tiling(r, x, W)}): max abs err {err:.3e} | kernel "
             f"{ms:.3f} ms plain {plain:.3f} ms bound {b_ms:.4f} ms ({by})")
        if label == "siso":
            # the preset's "highest": the fp32 build, as a call with no
            # precision (its output's digest: tools/k2_fp32_digest.py
            # compares it with another tree's)
            n0, t0 = esn_cuda.launches, esn_cuda.launches_tf32
            hi = esn_cuda.esn_predict_cuda(r, scale, W, x, nf, 0,
                                           precision="highest")
            _check(torch.equal(hi, esn_cuda.esn_predict_cuda(
                       r, scale, W, x, nf, 0))
                   and (esn_cuda.launches - n0,
                        esn_cuda.launches_tf32 - t0) == (2, 0),
                   "K2 siso: precision \"highest\" is not the fp32 build")
            _log("[K2 siso highest] the fp32 build, identical to a call with "
                 "no precision, no TF32 launch")
        k2_tf32(r, x, W, nf, label)

    # the siso_qpsk_awgn detect shape: one block a round, 399 data symbols,
    # T = 512, n_in = n_out = 2, n_res = 200
    k2_shape(siso, 1, "siso", 12)
    # the sweep's 2x2 plant at its smallest and largest reservoir: 16
    # blocks of 18 data symbols, T = 522, n_in = n_out = 4
    nbf2 = mimo_2x2_nbf()

    def with_reservoir(c, n_res: int):
        return dataclasses.replace(c, esn=dataclasses.replace(
            c.esn, n_reservoir=n_res))
    for n_res_w in (50, 600):
        k2_shape(with_reservoir(nbf2, n_res_w), 16, f"sweep n_res {n_res_w}",
                 13)
    # the 2x2 comparison: its ESN detector and data NMSE (288 rows of 16
    # readouts at the preset's n_res 300) and its pilot NMSE (one row a
    # block against its own readout)
    k2_shape(nbf2, 16, "zoo2x2 detect 288 rows", 20)
    k2_shape(nbf2, 16, "zoo2x2 nmse 16 rows", 18, Dg=1)
    # the compare2x2 CLI's run below (--fast: N = 256, T = 266; 2 blocks):
    # its ESN detector and data NMSE (2 D rows) and its pilot NMSE (2 rows)
    nbf2_fast = mimo_2x2_nbf(fast=True)
    k2_shape(nbf2_fast, 2, "compare2x2 cli detect", 21)
    k2_shape(nbf2_fast, 2, "compare2x2 cli nmse 2 rows", 22, Dg=1)

    # ---- 4. K3: ESN state harvest vs its plain version ----------------------
    def k3_plan_str(p) -> str:
        return (f"cluster {p.cluster} CTAs x {p.clusters} clusters, "
                f"{p.rows_per_cluster} rows a cluster in tiles of "
                f"{p.row_tile}, {p.cols_per_cta} columns a CTA, "
                f"{p.smem_bytes} B shared a CTA")

    def k3_operands(c, B_k: int, seed: int):
        """Reservoir, inputs and scaled teachers of a fit of config c."""
        n_res = c.esn.n_reservoir
        n_in, n_out = 2 * c.channel.n_rx, 2 * c.channel.n_tx
        T = (c.ofdm.n_subcarriers + c.ofdm.cp_len
             + c.esn.shared_delay(c.ofdm.isi_duration))
        r = init_reservoir(rng.prng_key(seed, dev), n_in, n_out, n_res,
                           c.esn.spectral_radius, c.esn.sparsity, 0.0)
        x = torch.randn(B_k, T, n_in, generator=gen, device=dev)
        d = 0.5 * torch.randn(B_k, T, n_out, generator=gen, device=dev)
        return r, x, d

    def k3_rnn(r, x, d):
        """The library yardstick: one cuDNN call of a single-layer tanh RNN
        without bias on x_t = [u_t; d_{t-1}], weight_ih = [W_in_t; W_fb_t]^T,
        weight_hh = Wt^T, h_0 = 0 — K3's function at noise 0. Timed here
        only; the port never calls it. Returns (run, its states)."""
        n_in, n_out = x.shape[2], d.shape[2]
        rnn = torch.nn.RNN(n_in + n_out, r.Wt.shape[0], nonlinearity="tanh",
                           bias=False, batch_first=True).to(dev)
        with torch.no_grad():
            rnn.weight_ih_l0.copy_(torch.cat([r.W_in_t, r.W_fb_t]).T)
            rnn.weight_hh_l0.copy_(r.Wt.T)
        xz = torch.cat([scale_inputs(scale, x)[:, 1:], d[:, :-1]],
                       dim=2).contiguous()

        def run():
            with torch.no_grad():
                return rnn(xz)[0]
        return run, run()

    def k3_phase(c, label: str, seed: int, before_ms: float):
        """K3 against plain esn_states and the cuDNN RNN at the fit shape of
        config c (128 blocks of one pilot each): returns (error, ms, plain
        ms, bytes, operations, RNN ms). `before_ms` is the time the kernel
        took on an H100 (700 W) before the cluster design, when each block
        streamed the whole weight from L2 every step."""
        r, x, d = k3_operands(c, G, seed)
        n_res, (B_k, T, n_in), n_out = r.Wt.shape[0], x.shape, d.shape[2]
        plan = esn_states_cuda.device_plan(B_k, n_res, n_in, n_out, dev)
        sk = esn_states_cuda.esn_states_cuda(r, scale, x, d, 0)
        sp = esn_states(r, scale, x, d)
        err = close(sk, sp, f"K3 {label}")
        g3 = torch.Generator(device=dev)
        g3.manual_seed(4)
        rn = r._replace(noise=1e-3)
        r_k3, r_p3 = noise_band(
            esn_states_cuda.esn_states_cuda(rn, scale, x, d, 12345),
            esn_states(rn, scale, x, d, g3), sp, f"K3 {label}")
        run_rnn, s_rnn = k3_rnn(r, x, d)
        sync()    # the yardstick's error is printed, not gated
        rnn_err = float((s_rnn - sp[:, 1:]).abs().max())
        run_k3 = lambda: esn_states_cuda.esn_states_cuda(       # noqa: E731
            r, scale, x, d, 0)
        # in turns on one card: kernel, RNN, RNN, kernel
        t = [cuda_ms(f, 3) for f in (run_k3, run_rnn, run_rnn, run_k3)]
        ms, rnn_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        plain_ms = cuda_ms(lambda: esn_states(r, scale, x, d), 2)
        # bytes: inputs, teachers and weights read once, states written once;
        # operations: 2 per multiply-add of [Wt; W_in; W_fb] per row and step
        n_bytes = 4 * (x.numel() + d.numel() + sk.numel()
                       + n_res * (n_res + n_in + n_out))
        ops = 2.0 * B_k * (T - 1) * n_res * (n_res + n_in + n_out)
        bound_ms, by = _bound(n_bytes, ops)
        _log(f"[K3 {label}] {B_k} x {T} x {n_res} ({k3_plan_str(plan)}): "
             f"max abs err {err:.3e} | noise RMS kernel {r_k3:.4e} plain "
             f"{r_p3:.4e} | kernel {ms:.3f} ms (streaming design: "
             f"{before_ms}) cuDNN RNN "
             f"{rnn_ms:.3f} ms (max abs err vs plain {rnn_err:.3e}) plain "
             f"{plain_ms:.3f} ms bound {bound_ms:.4f} ms ({by}, "
             f"{ops / 1e9:.1f} GFLOP)")
        return err, ms, plain_ms, n_bytes, ops, rnn_ms

    *k3, k3_rnn_ms = k3_phase(nbf, "nbf fit", 9, 11.155)
    k3_phase(cfg, "flagship fit", 10, 1.519)
    kernels["esn_states"] = _entry(
        "esn_states", "esn_states.cu",
        "esn_ofdm_mimo_tpu/models/esn_pallas.py:346", *k3)
    kernels["esn_states"]["library_ms"] = k3_rnn_ms
    # rows that fill no whole tile, fewer rows than clusters, and more rows
    # than the card holds clusters of 8 rows (tiles run in turn)
    for B_r in (100, 9, 300):
        r, x, d = k3_operands(nbf, B_r, 11)
        plan_r = esn_states_cuda.device_plan(B_r, r.Wt.shape[0], x.shape[2],
                                             d.shape[2], dev)
        run_r = lambda: esn_states_cuda.esn_states_cuda(         # noqa: E731
            r, scale, x, d, 0)
        err_r = close(run_r(), esn_states(r, scale, x, d),
                      f"K3 ragged {B_r}")
        _log(f"[K3 ragged] rows {B_r} at the NBF fit shape "
             f"({k3_plan_str(plan_r)}): max abs err {err_r:.3e} | kernel "
             f"{cuda_ms(run_r, 2):.3f} ms")
    del r, x, d

    def k3_shape(c, B_k: int, label: str, seed: int):
        """K3 against plain esn_states at the fit shape of B_k blocks of
        config c (noise 0: atol 1e-4 / rtol 1e-3), with its cluster plan,
        ms, plain ms and bound."""
        r, x, d = k3_operands(c, B_k, seed)
        n_res_k, (_, T_k, n_in_k), n_out_k = (r.Wt.shape[0], x.shape,
                                              d.shape[2])
        plan_k = esn_states_cuda.device_plan(B_k, n_res_k, n_in_k, n_out_k,
                                             dev)
        run_k = lambda: esn_states_cuda.esn_states_cuda(         # noqa: E731
            r, scale, x, d, 0)
        err = close(run_k(), esn_states(r, scale, x, d), f"K3 {label}")
        ms, plain = cuda_ms(run_k, 3), cuda_ms(
            lambda: esn_states(r, scale, x, d), 1)
        b_ms, by = _bound(
            4 * (x.numel() + d.numel() + B_k * T_k * n_res_k
                 + n_res_k * (n_res_k + n_in_k + n_out_k)),
            2.0 * B_k * (T_k - 1) * n_res_k * (n_res_k + n_in_k + n_out_k))
        _log(f"[K3 {label}] {B_k} x {T_k} x {n_res_k}, n_in {n_in_k} n_out "
             f"{n_out_k} ({k3_plan_str(plan_k)}): max abs err {err:.3e} | "
             f"kernel {ms:.3f} ms plain {plain:.3f} ms bound {b_ms:.4f} ms "
             f"({by})")

    # the siso_qpsk_awgn fit: one block a round (a cluster on one row), and
    # sixteen; the sweep's fits at its smallest and largest reservoir
    for B_k in (1, 16):
        k3_shape(siso, B_k, f"siso {B_k} row{'s' if B_k > 1 else ''}", 14)
    for n_res_w in (50, 600):
        k3_shape(with_reservoir(nbf2, n_res_w), 16, f"sweep n_res {n_res_w}",
                 15)
    # the 2x2 comparison's two fits an SNR (the preset's reservoir)
    k3_shape(nbf2, 16, "zoo2x2 fit", 17)
    # the compare2x2 CLI's fits (--fast, 2 blocks: 2 x 266 x 300)
    k3_shape(nbf2_fast, 2, "compare2x2 cli fit", 23)
    # the classify CLI's sm2 frontend: the flagship ESN fit on its 2 blocks
    # an SNR
    k3_shape(cfg, 2, "classify sm2 2 rows", 16)

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
    k4_plan = esn_cuda.grouped_plan(B, G, res.Wt.shape[0], inputs.shape[2],
                                    Wt_out.shape[2], n_sm)
    _log(f"[K4] rows {B} T {T} G {G} Dg {B // G} P "
         f"{esn_cuda.grouped_slots(G, B // G, k4_plan.rows_per_block)} "
         f"({tiling_str(k4_plan)}): max abs err vs plain "
         f"{k4_err:.3e} vs K2 {k4_vs_k2:.3e} | noise RMS {r_k4:.4e} | kernel "
         f"{k4_ms:.3f} ms, K2 in the same turns {k2_pair_ms:.3f} ms, plain "
         f"{k2_plain_ms:.3f} ms, bound "
         f"{kernels['esn_predict_grouped']['bound_ms']:.4f} ms")

    # ---- 5a. K2 and K4 carried: continuation from a fit's last state -------
    # The carry of esn_fit(return_carry=True) at the flagship pilot shape
    # (128 blocks, T = 138, n_res 300; K3 harvests), block g's on its 74
    # detect rows, with K2's readouts above: predict from (s0, o0) instead
    # of zeros, against plain esn_predict(init_carry=...) at atol 1e-4 /
    # rtol 1e-3, then a batch no tile height divides (9,435 rows, a carry of
    # its own a row). The fit's own readouts are not used: fitted to random
    # teachers they are large, and the feedback loop then amplifies the
    # rounding of either version beyond the tolerance (4.4e-4 measured, as
    # much at zero carry)
    x_fit = torch.randn(G, T, inputs.shape[2], generator=gen, device=dev)
    d_fit = 0.5 * torch.randn(G, T, Wt_out.shape[2], generator=gen,
                              device=dev)
    _, (s_last, o_last) = esn_fit(res, scale, x_fit, d_fit, n_forget, 0,
                                  return_carry=True)
    carry = tuple(c.repeat_interleave(B // G, 0).contiguous()
                  for c in (s_last, o_last))
    pp_c = esn_predict(res, scale, Wt_out, inputs, n_forget,
                       init_carry=carry)
    _check(float((pp_c - esn_predict(res, scale, Wt_out, inputs, n_forget))
                 .abs().max()) > 1e-3,
           "the carry does not change the plain prediction")
    for rd, tag in (("per_row", "K2"), ("grouped", "K4")):
        run_c = lambda rd=rd: esn_cuda.esn_predict_cuda(         # noqa: E731
            res, scale, Wt_out, inputs, n_forget, 0, readout=rd,
            init_carry=carry)
        run_z = lambda rd=rd: esn_cuda.esn_predict_cuda(         # noqa: E731
            res, scale, Wt_out, inputs, n_forget, 0, readout=rd)
        err_c = close(run_c(), pp_c, f"{tag} carried")
        # in turns on one card: carried, zero carry, zero carry, carried
        t = [cuda_ms(f, 3) for f in (run_c, run_z, run_z, run_c)]
        ms_c, ms_z = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        plain_c = cuda_ms(lambda: esn_predict(
            res, scale, Wt_out, inputs, n_forget, init_carry=carry), 1)
        n_b, ops_c = predict_work(res, inputs, Wt_out, pp_c)
        b_ms, by = _bound(n_b + 4 * (carry[0].numel() + carry[1].numel()),
                          ops_c)
        _log(f"[{tag} carried] rows {B} T {T} n_res {res.Wt.shape[0]} G {G} "
             f"Dg {B // G}, carry of esn_fit(return_carry=True) at {G} x {T} "
             f"({k2_tiling(res, inputs, Wt_out, grouped=rd == 'grouped')}): "
             f"max abs err {err_c:.3e} | kernel {ms_c:.3f} ms, zero carry in "
             f"the same turns {ms_z:.3f} ms, plain {plain_c:.3f} ms, bound "
             f"{b_ms:.4f} ms ({by})")
    B_c = B - 37
    W_c = 0.02 * torch.randn(B_c, Wt_out.shape[1], Wt_out.shape[2],
                             generator=gen, device=dev)
    carry_r = (carry[0][:B_c] + 0.05 * torch.randn(
        B_c, carry[0].shape[1], generator=gen, device=dev), carry[1][:B_c])
    err_cr = close(
        esn_cuda.esn_predict_cuda(res, scale, W_c, inputs[:B_c].contiguous(),
                                  n_forget, 0, init_carry=carry_r),
        esn_predict(res, scale, W_c, inputs[:B_c], n_forget,
                    init_carry=carry_r), "K2 carried ragged")
    _log(f"[K2 carried ragged] rows {B_c}, one readout and one carry a row "
         f"({k2_tiling(res, inputs[:B_c], W_c)}): max abs err {err_cr:.3e}")
    k2_tf32(res, inputs, Wt_out, n_forget, "carried", carry=carry)
    k2_tf32_short(res, inputs, Wt_out, "carried", carry=carry)
    k2_tf32(res, inputs[:B_c].contiguous(), W_c, n_forget, "carried ragged",
            carry=carry_r)
    del pg, pk, pp, pp_c, inputs, W_c, carry_r

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
        0.0, k1l_ms, k1l_plain_ms,
        *k1_work(code, llr, u, itl_sum, kw_l["algo"]))
    _log(f"[K1-layered offset-minsum] {llr.shape[0]} codewords at Eb/N0 "
         f"1.5/2.5 dB, cap 50 ({layered_plan_str(code.qc.Z, kw_l['algo'])}):"
         f" bits, iterations, converged, counts identical "
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
            k1ln_bound, k1ln_by = _bound(*k1_work(code_n, llr_n, u_n, itn_l,
                                                  algo))
            _log(f"[K1-layered nbf cap {cap_l}] {algo}, {llr_n.shape[0]} "
                 f"codewords of n = {code_n.n} "
                 f"({layered_plan_str(code_n.qc.Z, algo)}): bits, "
                 f"iterations, converged, counts identical | mean sweeps "
                 f"{itn_l / llr_n.shape[0]:.3f} converged {convn_l:.4f} | "
                 f"kernel {k1ln_ms:.3f} ms bound {k1ln_bound:.4f} ms "
                 f"({k1ln_by})")
    # the NBF preset's own rule, sum-product (the SFU rule against the plain
    # version's exact exp/log): the agreement band, its time and bound
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
    k1ls_bound, k1ls_by = _bound(*k1_work(
        code_n, llr_n, u_n, int(sk["iterations"].long().sum()),
        kwn_s["algo"]))
    _log(f"[K1-layered nbf cap 100] {kwn_s['algo']} "
         f"({layered_plan_str(code_n.qc.Z, kwn_s['algo'])}): bit agreement "
         f"{agree} "
         f"iterations {it_agree} converged {cv_agree} | mean sweeps "
         f"{float(sk['iterations'].float().mean()):.3f} converged "
         f"{float(sk['converged'].float().mean()):.4f} | kernel "
         f"{k1ls_ms:.3f} ms bound {k1ls_bound:.4f} ms ({k1ls_by})")

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
        _log(f"[K5 {label}] rows {B5} T {T} n_res {n_res5} "
             f"({k2_tiling(res5, x5, W5, ablate=True)}): max abs err "
             f"{err:.3e} | kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound "
             f"{b_ms:.4f} ms ({b_by})")
    kernels["esn_predict_ablate"] = _entry(
        "esn_predict_ablate", "esn_predict_ablate.cu",
        "tools/bench_micro.py:147", k5_err, *k5["full"][1:])
    del x5, W5, out_k, out_p

    # ---- [svd]: the small-SVD kernel (csrc/svdvals_small.cu) -------------
    # against its plain version and the library SVD (torch.linalg.svdvals,
    # the yardstick; the port never calls it) on the channels of one
    # full-width round: [nbf main]'s 128 blocks at 12 dB (65,536 matrices
    # of 8 x 4), a mimo_2x2_nbf round (65,536 of 2 x 2) and a simo_1x2_nbf
    # round (65,536 of 2 x 1: the n_t = 1 build, which no main path here
    # launches). Gates: each singular value within 1e-5 relative of the
    # plain version's, the analytics' ranks and condition histogram equal
    # to the plain version's, the capacity within rtol 1e-5 of the
    # library's. The bound counts the Hermitian form's work
    # (tools/bench_svd_torch.py:svd_work), the count of the real-embedded
    # algorithm, the kernel's earlier form, beside it; then each build's
    # registers, local memory (a spill) and SASS a rotation from cuobjdump
    import bench_svd_torch as svd_bench
    from esn_ofdm_mimo_tpu_torch.pipelines.blockfading import cond_histogram
    from esn_ofdm_mimo_tpu_torch.pipelines.common import ebno_row

    def metrics_with(svd, H, c, e):
        """channel_svd_metrics of H at Eb/N0 e with `svd` in place of
        svdvals_small."""
        saved = analytics.svdvals_small
        analytics.svdvals_small = svd
        try:
            return analytics.channel_svd_metrics(
                H, ebno_row(c, e, dev).pi, c.ofdm.noise_psd)
        finally:
            analytics.svdvals_small = saved

    svd_metrics = {}
    svd_h = {}
    for c_s, what in ((nbf, "8x4"), (mimo_2x2_nbf(), "2x2"),
                      (simo_1x2_nbf(), "2x1")):
        # synth_block's channel draw of 128 blocks at 12 dB
        H_s = svd_bench.round_channels(c_s.name, dev)
        S_k = analytics.svdvals_small(H_s)
        S_p = analytics.svdvals_small_plain(H_s)
        S_l = torch.linalg.svdvals(H_s)
        sync()
        rel = float(((S_k - S_p).abs() / S_p.abs().clamp_min(1e-30)).max())
        _check(S_k.shape == S_p.shape and bool(torch.isfinite(S_k).all())
               and rel <= 1e-5,
               f"svd {what}: the kernel's singular values differ from the "
               f"plain version's (max relative error {rel})")
        m_k = analytics.channel_svd_metrics(
            H_s, ebno_row(c_s, 12.0, dev).pi, c_s.ofdm.noise_psd)
        m_p = metrics_with(analytics.svdvals_small_plain, H_s, c_s, 12.0)
        m_l = metrics_with(torch.linalg.svdvals, H_s, c_s, 12.0)
        hist_k, hist_l = cond_histogram(m_k.cond), cond_histogram(m_l.cond)
        _check(torch.equal(m_k.rank, m_p.rank)
               and torch.equal(hist_k, cond_histogram(m_p.cond)),
               f"svd {what}: ranks or condition histogram differ from the "
               f"plain version's")
        cap_rel = float(((m_k.capacity_per_sc - m_l.capacity_per_sc).abs()
                         / m_l.capacity_per_sc).max())
        _check(cap_rel <= 1e-5, f"svd {what}: capacity {cap_rel} relative "
                                f"from the library SVD's")
        # the kernel's time from a CUDA graph of 20 launches, beside 20
        # launched from Python, where a kernel shorter than its launch's
        # host time shows the host's
        ms = svd_bench.graph_ms(lambda: analytics.svdvals_small(H_s), 20)
        eager_ms = cuda_ms(lambda: analytics.svdvals_small(H_s), 20)
        # H is taps_to_freq_response's movedim view, which the wrapper
        # copies to a contiguous tensor: the kernel alone on such a copy
        H_c = H_s.contiguous()
        alone_ms = svd_bench.graph_ms(lambda: analytics.svdvals_small(H_c),
                                      20)
        del H_c
        plain_ms = cuda_ms(lambda: analytics.svdvals_small_plain(H_s), 2)
        lib_ms = cuda_ms(lambda: torch.linalg.svdvals(H_s), 5)
        work = svd_bench.svd_work(H_s)
        ran = work[2] / 8 / (H_s.numel() // (H_s.shape[-2] * H_s.shape[-1]))
        b_ms, b_by = _bound(*work)
        o_ms, o_by = _bound(*svd_bench.svd_work(H_s, real_embedding=True))
        full = min(c_s.channel.n_tx, c_s.channel.n_rx)
        n_t = H_s.shape[-1]
        svd_metrics[what] = (m_k, m_l)
        _log(f"[svd {what}] {tuple(H_s.shape)} complex64: kernel against "
             f"plain max relative error {rel:.3e} (identical: "
             f"{torch.equal(S_k, S_p)}), against the library "
             f"{float(((S_k - S_l).abs() / S_l.abs()).max()):.3e} | ranks "
             f"and condition histogram equal to plain; full rank kernel "
             f"{int((m_k.rank >= full).sum())} library "
             f"{int((m_l.rank >= full).sum())}, histogram L1 to the library "
             f"{int((hist_k - hist_l).abs().sum())}, capacity relative "
             f"{cap_rel:.3e} | kernel {ms:.4f} ms (a graph of 20 launches; "
             f"from Python {eager_ms:.4f} ms; on a contiguous H, without "
             f"the wrapper's copy, {alone_ms:.4f} ms) plain {plain_ms:.3f} ms "
             f"library {lib_ms:.3f} ms bound {b_ms:.4f} ms ({b_by}, "
             f"{ran:.2f} rotations ran a matrix of "
             f"{analytics.SWEEPS * n_t * (n_t - 1) // 2}; {b_ms / ms:.1%} of "
             f"it; the real embedding's count {o_ms:.4f} ms, {o_by}) | {smi}")
        if what == "8x4":
            kernels["svdvals_small"] = _entry(
                "svdvals_small", "svdvals_small.cu",
                "esn_ofdm_mimo_tpu/ops/linalg_mxu.py:207 (svdvals_small, "
                "plain jnp: no pl.pallas_call)",
                float((S_k - S_p).abs().max()), ms, plain_ms, *work)
            kernels["svdvals_small"]["library_ms"] = lib_ms
        svd_h[tuple(H_s.shape[-2:])] = H_s
        del S_k, S_p, S_l
    if os.path.exists(os.path.join(os.path.dirname(build.nvcc_path()),
                                   "cuobjdump")):
        for (n_r, n_t), r in sorted(svd_bench.build_report().items()):
            if (n_r, n_t) in svd_h:
                _check(r["local"] == 0 and r["stack"] == 0,
                       f"svd build {n_r}x{n_t} spills: {r}")
                _log(f"[svd build {n_r}x{n_t}] "
                     f"{svd_bench.build_line(r, n_r, n_t, svd_h[n_r, n_t])}")
    else:
        _log("[svd build] no cuobjdump in the toolkit: SASS not read")
    del svd_h, H_s

    # ---- [calib fit]: the calibrator fit's step kernel (csrc/logreg_step.cu)
    # through fit_logreg_1d against fit_logreg_1d_plain on one detector's
    # pairs at the flagship fit's shape. Gates: (a, b) identical, eager and
    # replayed; steps + 1 launches a fit. The kernels line's bound is the
    # function's (one read of the pairs a step: fp32 x, int8 y, 5 B a pair)
    # against the fit's ms (K6 and the two means); this design's own bytes
    # (K6 reads x and y and writes d and dx, the means read d and dx: 21 B
    # a pair a step) are printed beside it
    import bench_calib_fit_torch as fit_bench
    try:
        fit = fit_bench.run(reps=5)
    except AssertionError as e:
        _fail(str(e))
    _log(f"[calib fit] {tuple(fit['shape'])} pairs (strides "
         f"{tuple(fit['strides'])}), {fit['steps']} steps: kernel route "
         f"identical to the plain loop, eager and replayed; {fit['launches']}"
         f" launches a fit | a fit replayed {fit['kernel_ms']:.3f} ms (plain "
         f"{fit['plain_ms']:.3f} ms), from Python {fit['kernel_eager_ms']:.3f}"
         f" ms (plain {fit['plain_eager_ms']:.3f} ms) | a step: kernel "
         f"{1e3 * fit['step_kernel_ms']:.2f} us (bound "
         f"{1e3 * fit['step_kernel_bound_ms']:.2f} us), two means "
         f"{1e3 * fit['means_ms']:.2f} us | bound by bytes: the design "
         f"{fit['bound_design_ms']:.3f} ms, one read of the pairs a step "
         f"{fit['bound_one_read_ms']:.3f} ms (y as fp32 "
         f"{fit['bound_one_read_f32_ms']:.3f} ms) | {smi}")
    _log(f"[calib fit] host ms of a graph's launch, idle / behind a "
         f"{fit['busy_ms']:.0f} ms kernel (graph nodes): " + ", ".join(
             f"{k} {v[0]:.3f} / {v[1]:.3f} ({fit['graph_nodes'][k]})"
             for k, v in fit["launch_host_ms"].items()))
    kernels["logreg_step"] = _entry(
        "logreg_step", "logreg_step.cu",
        "none: esn_ofdm_mimo_tpu/pipelines/cdl.py fit_logreg_1d is plain "
        "jnp (no pl.pallas_call)", 0.0, fit["kernel_ms"], fit["plain_ms"],
        fit["one_read_bytes"], 0.0)

    # ---- [K7 gru train]: the zoo's GRU kernel (csrc/gru_train.cu) against
    # its plain version (ops/gru_cuda.py: rnn_apply batched over the blocks,
    # autograd) at the zoo cell's shape: 128 blocks, T = 522 (N 512 + cp 7 +
    # delay 3), 4 inputs, hidden 32, 4 outputs. Gate: the outputs, the
    # losses and every weight gradient within 1e-5 of plain relative to the
    # largest of each (the same fp32 products summed in another order and
    # contracted into multiply-adds; measured <= 8e-7 on the first card
    # run, while a wrong gate, index or sign is off by O(1)); the
    # predictions of 18 sequences a block likewise. Times: a training launch
    # (an epoch's gradients) and a prediction launch, at 128 blocks and at
    # one (a single CTA: the recurrence's serial chain, this design's
    # floor); the bound from the benchmark's frozen count
    # (benchmark/counts/gru_work.py)
    from benchmark.counts import gru_work
    from esn_ofdm_mimo_tpu_torch.models import zoo
    B7, T7, S7 = 128, 522, 18
    w7 = zoo.gru_weights(zoo.rnn_init(rng.split(rng.prng_key(3, dev), B7), 4,
                                      32, 4))
    # its own generator: the later phases' draws from `gen` stay as they were
    g7 = torch.Generator(device=dev)
    g7.manual_seed(7)
    x7 = torch.randn(B7, T7, 4, generator=g7, device=dev)
    y7 = 0.3 * torch.randn(B7, T7, 4, generator=g7, device=dev)
    xs7 = torch.randn(B7, S7, T7, 4, generator=g7, device=dev)
    got7 = gru_cuda.train(x7, y7, w7)
    sync()
    t0 = time.perf_counter()
    want7 = gru_cuda.train_plain(x7, y7, w7)
    sync()
    plain7_ms = 1e3 * (time.perf_counter() - t0)

    def rel7(a, b):
        return float((a - b).abs().max() / b.abs().max())
    errs7 = [rel7(a, b) for a, b in zip(got7[:2] + tuple(got7[2]),
                                        want7[:2] + tuple(want7[2]))]
    _check(max(errs7) <= 1e-5, f"K7 gru train: outputs, losses or gradients "
                               f"differ from plain by {errs7} relative")
    with torch.no_grad():
        err_p7 = rel7(gru_cuda.predict(xs7, w7),
                      gru_cuda.rnn_apply_blocks(w7, xs7))
    _check(err_p7 <= 1e-5, f"K7 gru predict: {err_p7} relative to plain")
    ws7 = gru_cuda.workspace(B7, T7, dev)
    ms7 = cuda_ms(lambda: gru_cuda.train(x7, y7, w7, ws7), 20)
    w1 = gru_cuda.GruWeights(*(t[:1] for t in w7))
    ms7_one = cuda_ms(lambda: gru_cuda.train(x7[:1], y7[:1], w1), 20)
    ms7_pred = cuda_ms(lambda: gru_cuda.predict(xs7, w7), 20)
    ms7_pred_one = cuda_ms(lambda: gru_cuda.predict(xs7[:1, :1], w1), 20)
    work7 = gru_work.train_work(B7, T7)
    bound7 = _bound(*work7)
    _log(f"[K7 gru train] {B7} blocks x {T7} steps, hidden 32, 4 in / 4 "
         f"out: outputs, losses, gradients within {max(errs7):.2e} of plain "
         f"(tolerance 1e-5; {', '.join(f'{e:.1e}' for e in errs7)}), "
         f"predictions of {S7} sequences a block within {err_p7:.2e} | a "
         f"training launch {ms7:.4f} ms ({B7} blocks), {ms7_one:.4f} ms (1 "
         f"block: the serial chain), bound {bound7[0]:.4f} ms by "
         f"{bound7[1]} | a prediction launch {ms7_pred:.4f} ms ({B7} x "
         f"{S7} sequences), {ms7_pred_one:.4f} ms (one) | plain (autograd) "
         f"{plain7_ms:.1f} ms | {smi}")
    kernels["gru_train"] = _entry(
        "gru_train", "gru_train.cu",
        "none: esn_ofdm_mimo_tpu/models/zoo.py rnn_apply is a lax.scan "
        "under jax.vmap and jax.grad (no pl.pallas_call)", max(errs7), ms7,
        plain7_ms, *work7)
    del x7, y7, xs7, got7, want7, ws7

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

    def count_run(run, need, what: str, traced: bool = False):
        """Run `run` with every launch count reset just before and read just
        after; the kernels in `need` must have launched. With `traced` the
        run is traced (torch.profiler; `_trace_kernels` runs it until two
        traces agree) and its launches are the kernels the card ran,
        counted by name: a CUDA graph's replays launch nothing from Python.
        The wall is then the traced runs'."""
        sync()
        reset_counts()
        phases = {}
        t0 = time.perf_counter()
        if traced:
            out, per = _trace_kernels(lambda: run(phases))
        else:
            out = run(phases)
        sync()
        wall = time.perf_counter() - t0
        launches = read_counts()
        k2_tf32_n = esn_cuda.launches_tf32
        if traced:
            launches = dict(_traced_launches(per, launches),
                            graph_decode=launches["graph_decode"])
            k2_tf32_n = sum(n for name, (_, n) in per.items()
                            if _is_k2_tf32(name))
        k2_routes.append((what, k2_tf32_n, launches["esn_predict"]))
        _check(all(launches[k] > 0 for k in need),
               f"{what}: a kernel of the path was never launched: {launches}")
        _check("graph_decode" in need or launches["graph_decode"] == 0,
               f"{what}: a QC code reached the graph decoder: {launches}")
        for k, v in launches.items():
            launches_total[k] += v
        return out, phases, wall, launches

    # block fading: mimo_4x8_nbf, five detectors, at 3 dB and 12 dB
    G_nbf, D_n = 128, nbf.data_symbols_per_block
    nbf_keys = {e: rng.block_keys(root, nbf.ebno_db.index(e),
                                  torch.arange(G_nbf))
                .reshape(1, G_nbf, 2).numpy() for e in (3.0, 12.0)}
    nbf_snr_point(nbf, 12.0, nbf_keys[12.0][:, :8])              # warm-up
    nbf_wall, nbf_pts = {}, {}
    for ebno_n in (3.0, 12.0):
        pt_n, ph_n, wall_n, la_n = count_run(
            lambda ph: nbf_snr_point(nbf, ebno_n, nbf_keys[ebno_n],
                                     timings=ph),
            ("bp_decode", "esn_predict", "esn_states", "svdvals_small",
             "threefry"),
            f"nbf {ebno_n} dB")
        # the eager point's draws: 13 fold_in, 5 split, 9 normal, 4
        # uniform and 2 bernoulli
        _check(la_n["threefry"] == 33,
               f"nbf {ebno_n} dB: {la_n['threefry']} threefry launches, "
               f"expected 33")
        nbf_wall[ebno_n], nbf_pts[ebno_n] = wall_n, pt_n
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
            # the point's analytics are the SVD kernel's on its channels
            # ([svd 8x4]'s H); beside them the library SVD's on the same H
            m_k, m_l = svd_metrics["8x4"]
            full_n = min(nbf.channel.n_tx, nbf.channel.n_rx)
            hist_k = cond_histogram(m_k.cond)
            _check(pt_n.rank_full_sum == int((m_k.rank >= full_n).sum())
                   and pt_n.cond_hist.tolist() == hist_k.tolist()
                   and pt_n.capacity_sum
                   == float(m_k.capacity_per_sc.double().sum()),
                   "nbf main: the point's analytics are not the SVD "
                   "kernel's on its channels")
            cap_l = float(m_l.capacity_per_sc.double().sum())
            _log(f"[nbf main] analytics (the SVD kernel) beside the library "
                 f"SVD's on the same H: full rank {pt_n.rank_full_sum} / "
                 f"{int((m_l.rank >= full_n).sum())}, condition histogram "
                 f"L1 difference "
                 f"{int((hist_k - cond_histogram(m_l.cond)).abs().sum())}, "
                 f"capacity relative difference "
                 f"{abs(pt_n.capacity_sum - cap_l) / cap_l:.3e}")

    # uncoded block fading: the same 12 dB keys with ldpc.enabled=False,
    # so the data symbols carry raw bits; no BP of any kind runs
    nbf_unc = dataclasses.replace(nbf, ldpc=dataclasses.replace(
        nbf.ldpc, enabled=False))
    pt_u, ph_u, wall_u, la_u = count_run(
        lambda ph: nbf_snr_point(nbf_unc, 12.0, nbf_keys[12.0], timings=ph),
        ("esn_predict", "esn_states"), "nbf uncoded")
    _check(la_u["bp_decode"] == 0 and la_u["bp_decode_layered"] == 0
           and "decode" not in ph_u,
           f"nbf uncoded: a decode ran: {la_u} {ph_u}")
    pt_c = nbf_pts[12.0]
    ber_u = {d: v / pt_u.total_bits for d, v in pt_u.bit_errors.items()}
    ber_cu = {d: v / pt_c.total_bits for d, v in pt_c.bit_errors.items()}
    _check(pt_u.total_info_bits == 0 and pt_u.ldpc_codewords == 0
           and not any(pt_u.info_errors.values())
           and pt_u.total_bits == pt_c.total_bits,
           f"nbf uncoded: coded counters not empty: {pt_u}")
    for d in ber_u:
        _check(abs(ber_u[d] - ber_cu[d]) <= 0.1 * ber_cu[d],
               f"nbf uncoded {d}: uncoded BER {ber_u[d]} not within 10% of "
               f"the coded run's {ber_cu[d]} on the same keys")
    _log(f"[nbf uncoded] mimo_4x8_nbf ldpc.enabled=False, 12 dB, {G_nbf} "
         f"blocks: uncoded BER {ber_u} | the coded run's uncoded BER "
         f"{ber_cu} | phases ms "
         f"{json.dumps({k: round(v, 3) for k, v in ph_u.items()})} wall "
         f"{1e3 * wall_u:.3f} ms | launches {la_u}")

    # the flagship: mimo_4x8_cdl at 12 dB
    ebno = 12.0
    G_main = 128
    ids = torch.arange(2 * G_main)
    keys = rng.block_keys(root, 0, ids).reshape(2, 1, G_main, 2).numpy()
    cdl_snr_point(cfg, ebno, keys[0][:, :8], keys[1][:, :8])   # warm-up
    D = cfg.data_symbols_per_block
    det_syms = G_main * (D + 1)

    def flagship(what: str, need, c_f=cfg):
        pt, phases, wall, launches = count_run(
            lambda ph: cdl_snr_point(c_f, ebno, keys[0], keys[1],
                                     timings=ph),
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
        return wall, launches, ber_coded, phases

    wall, la_main, coded_gd, ph_gd = flagship(
        "main", ("bp_decode", "esn_predict", "esn_states", "threefry"))
    # the eager point's draws, one launch each: 18 fold_in, 8 split, 14
    # normal, 8 uniform and 4 bernoulli (1 cal + 1 decode round)
    _check(la_main["threefry"] == 52,
           f"main: {la_main['threefry']} threefry launches, expected 52")
    # the JAX package's own switch to the grouped-readout kernel
    os.environ["ESN_TPU_PREDICT_READOUT"] = "grouped"
    try:
        _, la_g, _, _ = flagship("main grouped", ("bp_decode", "esn_states",
                                                  "esn_predict_grouped"))
    finally:
        del os.environ["ESN_TPU_PREDICT_READOUT"]
    _check(la_g["esn_predict"] == 0,
           f"the grouped run still launched K2: {la_g}")
    # the Newton calibrator fit on the same keys: coded BERs in the band
    # of the layered-against-flooding check (25% + 2e-3 either way)
    cfg_nt = dataclasses.replace(cfg, calib=dataclasses.replace(
        cfg.calib, fit_method="newton"))
    _, _, coded_nt, ph_nt = flagship(
        "main newton", ("bp_decode", "esn_predict", "esn_states"), cfg_nt)
    for d in coded_gd:
        b_g, b_n = coded_gd[d], coded_nt[d]
        _check(b_n <= 1.25 * b_g + 2e-3 and b_g <= 1.25 * b_n + 2e-3,
               f"main newton {d}: coded BER {b_n} outside the band of the "
               f"GD fit's {b_g}")
    _log(f"[main newton] calib.fit_method newton: coded BER {coded_nt}, GD "
         f"{coded_gd} | fit ms newton {ph_nt['fit']:.3f} GD "
         f"{ph_gd['fit']:.3f}")

    # ---- rng_mode="block": one reservoir a block, each block's ESN alone ----
    def block_mode(c, what: str, G_b: int, run_point, n_fits: int,
                   n_dets: int, keys_b):
        """The point of config c in block mode on one round of G_b blocks
        (counted: K3 n_fits and K2 n_dets times a block of each of its
        rounds), against rounds of G_b / 2 x 2 (bit-identical counters);
        block 2's reservoir and readouts alone against a batch of 4; each
        block's ESN ms. run_point(keys (R, G, 2) for each of its phases,
        timings) -> (counters, uncoded BER dict)."""
        c_b = dataclasses.replace(c, esn=dataclasses.replace(
            c.esn, rng_mode="block"))
        (pt, ber), ph, wall, la = count_run(
            lambda ph: run_point(c_b, [k.reshape(1, G_b, 2) for k in keys_b],
                                 ph),
            ("esn_predict", "esn_states"), what)
        n_rounds = len(keys_b)
        _check(la["esn_states"] == n_fits * G_b * n_rounds
               and la["esn_predict"] == n_dets * G_b * n_rounds,
               f"{what}: launches {la}, expected K3 {n_fits} and K2 {n_dets} "
               f"a block")
        pt2, _ = run_point(c_b, [k.reshape(2, G_b // 2, 2) for k in keys_b],
                           {})
        _check(same(pt2, pt), f"{what}: the counters of rounds of "
                              f"{G_b // 2} x 2 differ from one round of "
                              f"{G_b}: {pt2} {pt}")
        for d, v in ber.items():
            _check(0.0 < v < 0.5, f"{what}: {d} uncoded BER {v} not in "
                                  f"(0, 0.5)")
        k4 = rng.as_keys(keys_b[0][:4], dev)
        st4, (y4, x4) = synth_block(c_b, 12.0, k4, return_pilot=True)
        st1 = synth_block(c_b, 12.0, k4[2:3])
        for name in ("Wt", "W_in_t", "W_fb_t"):
            _check(torch.equal(getattr(st1.reservoir, name)[0],
                               getattr(st4.reservoir, name)[2]),
                   f"{what}: block 2's reservoir {name} alone differs")
        for name in ("Wt_out_m", "Wt_out_f"):
            if getattr(st4, name) is not None:
                _check(torch.equal(getattr(st1, name)[0],
                                   getattr(st4, name)[2]),
                       f"{what}: block 2's {name} alone differs")
        # each block's ESN: its fit (K3 on one row, the readout solve) and
        # its detection (K2 on D rows), 4 blocks in turn
        delay_b = c.esn.shared_delay(c.ofdm.isi_duration)
        D_b, cp_b = c.data_symbols_per_block, c.ofdm.cp_len
        y_d = torch.randn(4, D_b, c.channel.n_rx, y4.shape[-1],
                          dtype=torch.complex64, generator=gen, device=dev)
        seeds = list(range(4))
        fit_ms = 1e3 * wall_s(lambda: train_mimo_esn_per_block(
            st4.reservoir, st4.scale_m, y4, x4, delay_b, cp_b, seeds)) / 4
        det_ms = 1e3 * wall_s(lambda: esn_detect_symbols_per_block(
            st4.reservoir, st4.scale_m, st4.Wt_out_m, y_d, delay_b, cp_b,
            c.ofdm.n_subcarriers, 1.0, seeds)) / 4
        draw_ms = 1e3 * wall_s(lambda: [init_reservoir(
            k, 2 * c.channel.n_rx, 2 * c.channel.n_tx, c.esn.n_reservoir,
            c.esn.spectral_radius, c.esn.sparsity, c.esn.noise)
            for k in k4]) / 4
        _log(f"[{what}] {c.name} rng_mode block, 12 dB, {G_b} blocks x "
             f"{n_rounds} round(s): uncoded BER {ber} | launches {la} (K3 "
             f"{n_fits} and K2 {n_dets} a block) | the counters of rounds "
             f"of {G_b // 2} x 2 identical; block 2 alone: reservoir and "
             f"readouts identical to a batch of 4")
        _log(f"[{what}] phases ms "
             f"{json.dumps({k: round(v, 3) for k, v in ph.items()})} wall "
             f"{1e3 * wall:.3f} ms | ESN ms a block: reservoir draw "
             f"{draw_ms:.3f}, fit {fit_ms:.3f} (K3 on 1 row, the readout "
             f"solve), detect {det_ms:.3f} (K2 on {D_b} rows)")
        return wall

    def same(a, b) -> bool:
        """Counters, calibrators and curves equal, bit for bit."""
        if isinstance(a, torch.Tensor):
            return torch.equal(a.cpu(), b.cpu())
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        if dataclasses.is_dataclass(a):
            return same(dataclasses.asdict(a), dataclasses.asdict(b))
        return a == b

    def wall_s(fn) -> float:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    def cdl_point(c_b, keys_rd, ph):
        pt = cdl_snr_point(c_b, 12.0, keys_rd[0], keys_rd[1], timings=ph)
        bits = pt.cal_total_bits + pt.counts.total_bits
        return pt, {d: (pt.cal_bit_errors[d] + pt.counts.bit_errors[d])
                    / bits for d in pt.cal_bit_errors}

    def nbf_point(c_b, keys_rd, ph):
        pt = nbf_snr_point(c_b, 12.0, keys_rd[0], timings=ph)
        return pt, {d: v / pt.total_bits for d, v in pt.bit_errors.items()}

    keys_bm = rng.block_keys(root, 0, torch.arange(32)).numpy()
    block_mode(cfg, "block main", 16, cdl_point,
               1 + (cfg.esn.train_ebno_fixed_db is not None), 1,
               (keys_bm[:16], keys_bm[16:]))
    block_mode(nbf, "block nbf", 8, nbf_point,
               1 + (nbf.esn.train_ebno_fixed_db is not None),
               1 + (nbf.esn.train_ebno_fixed_db is not None),
               (rng.block_keys(root, 1, torch.arange(8)).numpy(),))

    # ---- the detection-throughput path: one captured chunk, R replays -----
    # [cal chunks]: run_cdl_cal_counters_chunks on the flagship at bench.py's
    # widths (128 blocks a chunk, keys from block ids in order), 16 chunks
    # (bench.py: 64); [cal chunks block] the same in rng_mode="block", 2
    # chunks of 4 blocks. Each runs once to warm up (an eager chunk, the
    # capture, the replays), then counted on the next keys, against R eager
    # run_cdl_cal_blocks calls on those keys (identical counters) and the
    # eager loop of the counters-only body (the same work as a replay)
    from esn_ofdm_mimo_tpu_torch.pipelines import cdl as cdl_pipe
    from esn_ofdm_mimo_tpu_torch.pipelines import graphs
    from esn_ofdm_mimo_tpu_torch.utils.flops import cdl_flops

    def cal_chunks(c, what: str, R_c: int, B_c: int, per_chunk: int):
        def keys_for(i):
            ids = torch.arange(i * R_c * B_c, (i + 1) * R_c * B_c)
            return rng.block_keys(root, 0, ids).reshape(R_c, B_c, 2).to(dev)

        wall_1 = wall_s(lambda: cdl_pipe.run_cdl_cal_counters_chunks(
            c, 12.0, keys_for(0)))
        keys_c = keys_for(1)
        # what a capture needs: an eager chunk that syncs the host nowhere
        # (torch raises on each synchronizing call it detects)
        torch.cuda.set_sync_debug_mode("error")
        try:
            cdl_pipe._cal_counters(c, 12.0, keys_c[0])
        except RuntimeError as e:
            _fail(f"{what}: an eager chunk synchronizes the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        def chunks():
            return cdl_pipe.run_cdl_cal_counters_chunks(c, 12.0, keys_c)

        got = []
        wall_g = wall_s(lambda: got.append(chunks()))
        # the counted run: the graph is cached, so the wrappers launch
        # nothing from Python (their counts stay 0) and the replays'
        # kernels are counted in the card's trace (CUPTI, through
        # torch.profiler), by kernel name
        (got_t, per), _, _, la_py = count_run(
            lambda ph: _trace_kernels(chunks), (), what)
        la = _traced_launches(per, la_py)
        for k, v in la.items():
            launches_total[k] += v
        k2_routes.append((f"{what} (trace)", sum(
            n for name, (_, n) in per.items() if _is_k2_tf32(name)),
            la["esn_predict"]))
        _check(not any(la_py.values()),
               f"{what}: the replays launched kernels from Python: {la_py}")
        g = cdl_pipe.cal_graph(c, 12.0, keys_c[0])
        errs, tot = got[0]
        errs = {d: int(v) for d, v in errs.items()}
        _check({d: int(v) for d, v in got_t[0].items()} == errs
               and got_t[1] == tot,
               f"{what}: the traced replays' counters {got_t} differ from "
               f"the timed replays' {errs} / {tot}")
        outs = []
        wall_e = wall_s(lambda: outs.extend(
            cdl_pipe.run_cdl_cal_blocks(c, 12.0, keys_c[r])
            for r in range(R_c)))
        want = {d: sum(int(o.bit_errors[d]) for o in outs) for d in errs}
        wall_c = wall_s(lambda: [cdl_pipe._cal_counters(c, 12.0, keys_c[r])
                                 for r in range(R_c)])
        _check(errs == want and tot == sum(o.total_bits for o in outs),
               f"{what}: the graph's counters {errs} / {tot} differ from the "
               f"eager loop's {want}")
        _check(la["esn_predict"] == R_c * per_chunk
               and la["esn_states"] == R_c * per_chunk
               and la["threefry"] > 0
               and not any(la[k] for k in la if k not in (
                   "esn_predict", "esn_states", "threefry")),
               f"{what}: traced launches {la}, expected K2 and K3 "
               f"{per_chunk} a chunk and the threefry kernel")
        syms = R_c * B_c * (c.data_symbols_per_block + 1)
        flop = cdl_flops(c, B_c).cal_counters * R_c
        rate = {k: (syms / w, flop / w / 1e12)
                for k, w in (("graph", wall_g), ("eager", wall_e),
                             ("eager counters", wall_c))}
        _log(f"[{what}] {c.name} rng_mode {c.esn.rng_mode}, 12 dB, {R_c} "
             f"chunks x {B_c} blocks: graph counters {errs} / {tot} "
             f"identical to {R_c} eager run_cdl_cal_blocks calls; an eager "
             f"chunk syncs nowhere (sync debug mode) | launches in the "
             f"trace of the replays {la} | capture {g.capture_ms:.1f} ms, graph pool "
             f"{g.pool_bytes / 2**20:.1f} MiB, first call (warm-up chunk, "
             f"capture, replays) {1e3 * wall_1:.1f} ms | {smi}")
        _log(f"[{what}] wall ms: graph {1e3 * wall_g:.3f}, eager "
             f"run_cdl_cal_blocks {1e3 * wall_e:.3f}, eager counters-only "
             f"{1e3 * wall_c:.3f} | detected symbols/s, TFLOP/s "
             f"(cdl_flops cal_counters {flop / 1e9:.2f} GFLOP; share of "
             f"{_FP32_FLOP_PER_S / 1e12:.0f}): "
             + ", ".join(f"{k} {v[0]:.1f}, {v[1]:.3f} "
                         f"({100 * v[1] * 1e12 / _FP32_FLOP_PER_S:.2f}%)"
                         for k, v in rate.items()) + f" | {smi}")
        return wall_g, keys_c

    wall_chunks, keys_chunks = cal_chunks(cfg, "cal chunks", 16, G_main, 1)
    cfg_cb = dataclasses.replace(cfg, esn=dataclasses.replace(
        cfg.esn, rng_mode="block"))
    cal_chunks(cfg_cb, "cal chunks block", 2, 4, 4)

    # ---- the fused CDL route: one SNR point, then the SNR grid -------------
    # [cdl snr step]: make_fused_cdl_snr_step at bench.py's e2e shape (the
    # flagship at 12 dB, 128 blocks, 2 cal + 6 decode rounds, keys
    # block_keys(root, 1, ids) in bench.py's order: call i takes ids
    # [8i, 8i + 8) x 128). The first call captures the cal, fit, detect and
    # decode bodies; then 3 replayed calls on new keys (best wall), the
    # eager cdl_snr_point on call 1's keys (every counter and both
    # calibrators identical), one replayed call traced (K1, K2, K3 counted
    # by name; nothing launched from Python) and one under
    # set_sync_debug_mode("error")
    from esn_ofdm_mimo_tpu_torch.parallel import montecarlo as tmc
    Rc_s, Rd_s = 2, 6
    R_s = Rc_s + Rd_s

    def step_keys(i):
        ids = torch.arange(i * R_s * G_main, (i + 1) * R_s * G_main)
        k = rng.block_keys(root, 1, ids).reshape(R_s, G_main, 2).to(dev)
        return k[:Rc_s], k[Rc_s:]

    keys_s = [step_keys(i) for i in range(4)]
    step = tmc.make_fused_cdl_snr_step(cfg)
    wall_first = wall_s(lambda: tmc._host_point(step(ebno, *keys_s[0])))
    cap_ms, pool_b = tmc._rounds(cfg, G_main, dev).capture_stats()
    pool_all = graphs.graph_pool_bytes(dev)
    pts_s, walls_s = [], []
    for i in (1, 2, 3):
        walls_s.append(wall_s(lambda i=i: pts_s.append(
            tmc._host_point(step(ebno, *keys_s[i])))))
    eager_s = []
    wall_eager_s = wall_s(lambda: eager_s.append(
        cdl_snr_point(cfg, ebno, *keys_s[1])))
    _check(same(pts_s[0].cal_bit_errors, eager_s[0].cal_bit_errors)
           and pts_s[0].cal_total_bits == eager_s[0].cal_total_bits
           and same(pts_s[0].counts, eager_s[0].counts)
           and same(pts_s[0].calib, eager_s[0].calib),
           f"cdl snr step: the fused point differs from the eager one: "
           f"{pts_s[0]} against {eager_s[0]}")
    pt_t, _, _, la_s = count_run(
        lambda ph: tmc._host_point(step(ebno, *keys_s[1])), (),
        "cdl snr step", traced=True)
    la_py = read_counts()
    k3_round = 1 + (cfg.esn.train_ebno_fixed_db is not None)
    _check(not any(la_py.values()),
           f"cdl snr step: a replayed call launched from Python: {la_py}")
    n_fit = len(cdl_pipe.CDL_DETECTORS) * (cfg.calib.gd_steps + 1)
    _check(la_s["bp_decode"] == Rd_s and la_s["esn_predict"] == R_s
           and la_s["esn_states"] == k3_round * R_s
           and la_s["logreg_step"] == n_fit
           and la_s["threefry"] > 0 and same(pt_t, pts_s[0]),
           f"cdl snr step: traced launches {la_s}, expected K1 {Rd_s}, K2 "
           f"{R_s}, K3 {k3_round * R_s}, the fit's step kernel {n_fit}, "
           f"the threefry kernel, or another point")
    torch.cuda.set_sync_debug_mode("error")
    try:
        pt_sync = step(ebno, *keys_s[2])
    except RuntimeError as e:
        _fail(f"cdl snr step: a replayed call synchronizes the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _check(same(tmc._host_point(pt_sync), pts_s[1]),
           "cdl snr step: the call under sync debug mode gave another point")
    best_s = min(walls_s)
    syms_s = R_s * G_main * (D + 1)
    c_s = pts_s[0].counts
    _log(f"[cdl snr step] mimo_4x8_cdl {ebno} dB, {G_main} blocks x ({Rc_s} "
         f"cal + {Rd_s} decode) rounds: counters and both calibrators "
         f"identical to the eager cdl_snr_point on the same keys (info "
         f"errors {c_s.info_errors}, frame errors {c_s.frame_errors} of "
         f"{c_s.ldpc_codewords}, BP iterations {c_s.ldpc_iter_sum}); a "
         f"replayed call syncs nowhere (sync debug mode) | capture "
         f"{cap_ms:.1f} ms (cal, fit, detect, decode), the graph pool "
         f"grew by {pool_b / 2**20:.1f} MiB to {pool_all / 2**20:.1f} MiB "
         f"(one pool for every graph, the chunk's included), first call "
         f"{1e3 * wall_first:.1f} ms | {smi}")
    _log(f"[cdl snr step] wall ms: replayed {[round(1e3 * w, 3) for w in walls_s]}"
         f" (best {1e3 * best_s:.3f}), eager cdl_snr_point "
         f"{1e3 * wall_eager_s:.3f}, eager / replayed "
         f"{wall_eager_s / best_s:.3f} | e2e decoded symbols/s ({R_s} x "
         f"{G_main} x {D + 1} / wall): replayed {syms_s / best_s:.1f}, eager "
         f"{syms_s / wall_eager_s:.1f} | launches in the trace of one "
         f"replayed call {la_s} | {smi}")

    # [bench]: bench_torch.main in this process at its defaults (bench.py's
    # shapes), after [cal chunks] and [cdl snr step] captured the same
    # chunk and point: the line's keys against bench.py's, its numbers in
    # range, and the same graph sets in the cache after it (the bench
    # replays what was captured; its timers also raise on a recapture)
    import bench_torch
    chunk_g = cdl_pipe.cal_graph(cfg, 12.0, keys_chunks[0])
    rounds_g = tmc._rounds(cfg, G_main, dev)
    out_b = io.StringIO()
    t0_b = time.perf_counter()
    with contextlib.redirect_stdout(out_b):
        bench_torch.main([])
    wall_b = time.perf_counter() - t0_b
    lines_b = out_b.getvalue().splitlines()
    _check(len(lines_b) == 1,
           f"bench: {len(lines_b)} stdout lines, expected one: {lines_b}")
    line_b = json.loads(lines_b[0])
    _log(f"[bench] {lines_b[0]}")
    want_keys = {"metric", "value", "unit", "vs_baseline",
                 "e2e_decoded_symbols_per_s", "mfu_detect", "mfu_e2e",
                 "mfu_decode_useful", "bp_unconverged_frac",
                 "flops_per_detected_symbol", "detect_spread_symbols_per_s",
                 "e2e_spread_symbols_per_s", "baseline_pinned"}
    _check(set(line_b) == want_keys,
           f"bench: keys {sorted(line_b)}, expected bench.py's")
    _check(all(0 < line_b[k] < 1e9
               for k in ("value", "e2e_decoded_symbols_per_s"))
           and all(0 < line_b[k] < 1 for k in line_b if k.startswith("mfu_"))
           and all(0 <= v <= 1
                   for v in line_b["bp_unconverged_frac"].values()),
           f"bench: a number out of range: {line_b}")
    _check(cdl_pipe.cal_graph(cfg, 12.0, keys_chunks[0]) is chunk_g
           and tmc._rounds(cfg, G_main, dev) is rounds_g,
           "bench: the chunk or the point was captured again")
    _log(f"[bench] bench_torch.main() in process, {G_main} blocks, 64 "
         f"chunks and {Rc_s} + {Rd_s} rounds, 5 timed calls each: wall "
         f"{wall_b:.1f} s, the cached chunk and point replayed (no "
         f"capture) | {smi}")

    # [cdl grid]: make_fused_cdl_grid at 9/12/15 dB, 128 blocks, 1 cal + 1
    # decode round, against the per-SNR loops (the fused step and the eager
    # cdl_snr_point) on the same keys: identical; the wall of each
    c_3 = dataclasses.replace(cfg, ebno_db=(9.0, 12.0, 15.0))
    grid_3 = tmc.make_fused_cdl_grid(c_3, G_main, 1, 1)
    keys_3 = [rng.block_keys(root, jj, torch.arange(2 * G_main))
              .reshape(2, G_main, 2).to(dev) for jj in range(3)]
    wall_g1 = wall_s(lambda: grid_3(root))
    got_3, loop_f, loop_e = [], [], []
    wall_g3 = wall_s(lambda: got_3.extend(grid_3(root)))
    wall_f3 = wall_s(lambda: loop_f.extend(
        tmc._host_point(step(e, k[:1], k[1:]))
        for e, k in zip(c_3.ebno_db, keys_3)))
    wall_e3 = wall_s(lambda: loop_e.extend(
        cdl_snr_point(c_3, e, k[:1], k[1:])
        for e, k in zip(c_3.ebno_db, keys_3)))
    _check(all(
        same(a.cal_bit_errors, b.cal_bit_errors) and same(a.counts, b.counts)
        and same(a.calib, b.calib)
        for x in (loop_f, loop_e) for a, b in zip(got_3, x)),
        "cdl grid: the grid differs from the per-SNR loops")
    _log(f"[cdl grid] mimo_4x8_cdl 9/12/15 dB, {G_main} blocks x (1 cal + 1 "
         f"decode) rounds: identical to the per-SNR loops of the fused step "
         f"and of the eager cdl_snr_point | coded MMSE BER "
         f"{[p.counts.info_errors['mmse'] / p.counts.total_info_bits for p in got_3]}"
         f" | wall ms: grid {1e3 * wall_g3:.3f} (first call, the fit of one "
         f"round captured: {1e3 * wall_g1:.3f}), step loop "
         f"{1e3 * wall_f3:.3f}, eager loop {1e3 * wall_e3:.3f} | {smi}")

    # ---- the fused NBF route: the scan step, then the SNR grid -----------
    # [nbf step]: make_sharded_nbf_scan_step on mimo_4x8_nbf at full width,
    # 128 blocks x 2 rounds at 12 dB (keys block_keys(root, snr index,
    # ids): call i takes ids [256 i, 256 (i + 1))). The first call captures
    # the round's body of BP cap 100; 3 replayed calls on new keys (best
    # wall), the eager nbf_snr_point on call 1's keys (every counter
    # identical, capacity_sum included), one replayed call traced (K1 once,
    # K2 and K3 twice, the SVD kernel once a round; nothing launched from
    # Python) and one under set_sync_debug_mode("error"); then a call at 3
    # dB, which captures the body of the doubled cap, against the eager
    # point
    R_n = 2

    def nbf_step_keys(e, i):
        ids = torch.arange(i * R_n * G_nbf, (i + 1) * R_n * G_nbf)
        return rng.block_keys(root, nbf.ebno_db.index(e), ids).reshape(
            R_n, G_nbf, 2).to(dev)

    keys_n = [nbf_step_keys(12.0, i) for i in range(4)]
    nstep = tmc.make_sharded_nbf_scan_step(nbf)
    wall_nfirst = wall_s(lambda: tmc._host_nbf(nstep(12.0, keys_n[0])))
    pts_n, walls_n = [], []
    for i in (1, 2, 3):
        walls_n.append(wall_s(lambda i=i: pts_n.append(
            tmc._host_nbf(nstep(12.0, keys_n[i])))))
    eager_n = []
    wall_eager_n = wall_s(lambda: eager_n.append(
        nbf_snr_point(nbf, 12.0, keys_n[1])))
    _check(same(pts_n[0], eager_n[0]),
           f"nbf step: the fused point differs from the eager one: "
           f"{pts_n[0]} against {eager_n[0]}")
    pt_tn, _, _, la_n = count_run(
        lambda ph: tmc._host_nbf(nstep(12.0, keys_n[1])), (), "nbf step",
        traced=True)
    la_npy = read_counts()
    fits_n = 1 + (nbf.esn.train_ebno_fixed_db is not None)
    _check(not any(la_npy.values()),
           f"nbf step: a replayed call launched from Python: {la_npy}")
    _check(la_n["bp_decode"] == R_n and la_n["esn_predict"] == fits_n * R_n
           and la_n["esn_states"] == fits_n * R_n
           and la_n["svdvals_small"] == R_n and la_n["threefry"] > 0
           and same(pt_tn, pts_n[0]),
           f"nbf step: traced launches {la_n}, expected K1 {R_n}, K2 and K3 "
           f"{fits_n * R_n}, the SVD kernel {R_n}, the threefry kernel, or "
           f"another point")
    torch.cuda.set_sync_debug_mode("error")
    try:
        pt_sn = nstep(12.0, keys_n[2])
    except RuntimeError as e:
        _fail(f"nbf step: a replayed call synchronizes the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _check(same(tmc._host_nbf(pt_sn), pts_n[1]),
           "nbf step: the call under sync debug mode gave another point")
    keys_n3 = nbf_step_keys(3.0, 0)
    wall_n3first = wall_s(lambda: tmc._host_nbf(nstep(3.0, keys_n3)))
    pt_n3, eager_n3 = [], []
    wall_n3 = wall_s(lambda: pt_n3.append(tmc._host_nbf(nstep(3.0, keys_n3))))
    wall_e3n = wall_s(lambda: eager_n3.append(
        nbf_snr_point(nbf, 3.0, keys_n3)))
    _check(same(pt_n3[0], eager_n3[0]),
           f"nbf step 3 dB: the fused point differs from the eager one: "
           f"{pt_n3[0]} against {eager_n3[0]}")
    cap_n, pool_nb = tmc._nbf_rounds(nbf, G_nbf, dev).capture_stats()
    best_n = min(walls_n)
    syms_n = R_n * G_nbf * (D_n + 1)
    _log(f"[nbf step] mimo_4x8_nbf 12 dB, {G_nbf} blocks x {R_n} rounds: "
         f"every counter identical to the eager nbf_snr_point on the same "
         f"keys (info errors {pts_n[0].info_errors}, frame errors "
         f"{pts_n[0].frame_errors} of {pts_n[0].ldpc_codewords}, capacity "
         f"sum {pts_n[0].capacity_sum!r}); a replayed call syncs nowhere "
         f"(sync debug mode) | capture {cap_n:.1f} ms (the bodies of caps "
         f"{nbf.ldpc.max_iter} and {2 * nbf.ldpc.max_iter}), they grew the "
         f"graph pool by {pool_nb / 2**20:.1f} MiB to "
         f"{graphs.graph_pool_bytes(dev) / 2**20:.1f} MiB, first call "
         f"{1e3 * wall_nfirst:.1f} ms | {smi}")
    _log(f"[nbf step] wall ms: replayed "
         f"{[round(1e3 * w, 3) for w in walls_n]} (best {1e3 * best_n:.3f}),"
         f" eager nbf_snr_point {1e3 * wall_eager_n:.3f}, eager / replayed "
         f"{wall_eager_n / best_n:.3f} | detected symbols/s ({R_n} x "
         f"{G_nbf} x {D_n + 1} / wall): replayed {syms_n / best_n:.1f}, "
         f"eager {syms_n / wall_eager_n:.1f} | 3 dB (cap "
         f"{2 * nbf.ldpc.max_iter}): identical to eager, replayed "
         f"{1e3 * wall_n3:.3f} (first call, its capture: "
         f"{1e3 * wall_n3first:.3f}), eager {1e3 * wall_e3n:.3f} | launches "
         f"in the trace of one replayed call {la_n} | {smi}")

    # [nbf grid]: make_fused_nbf_grid at 3 and 12 dB, 128 blocks x 1 round,
    # against the per-SNR loops of the scan step and of the eager
    # nbf_snr_point on the same keys: identical; the wall of each
    c_n2 = dataclasses.replace(nbf, ebno_db=(3.0, 12.0))
    grid_n = tmc.make_fused_nbf_grid(c_n2, G_nbf, 1)
    keys_g = [rng.block_keys(root, jj, torch.arange(G_nbf)).reshape(
        1, G_nbf, 2).to(dev) for jj in range(2)]
    got_gn, loop_fn, loop_en = [], [], []
    wall_gn = wall_s(lambda: got_gn.extend(grid_n(root)))
    wall_fn = wall_s(lambda: loop_fn.extend(
        tmc._host_nbf(nstep(e, k)) for e, k in zip(c_n2.ebno_db, keys_g)))
    wall_en = wall_s(lambda: loop_en.extend(
        nbf_snr_point(c_n2, e, k) for e, k in zip(c_n2.ebno_db, keys_g)))
    _check(all(same(a, b) for x in (loop_fn, loop_en)
               for a, b in zip(got_gn, x)),
           "nbf grid: the grid differs from the per-SNR loops")
    _log(f"[nbf grid] mimo_4x8_nbf 3/12 dB, {G_nbf} blocks x 1 round: "
         f"identical to the per-SNR loops of the scan step and of the eager "
         f"nbf_snr_point | MMSE coded BER "
         f"{[p.info_errors['mmse'] / p.total_info_bits for p in got_gn]} | "
         f"wall ms: grid {1e3 * wall_gn:.3f}, step loop {1e3 * wall_fn:.3f},"
         f" eager loop {1e3 * wall_en:.3f} | {smi}")

    # [nbf step block]: the scan step in EsnConfig(rng_mode="block") on
    # mimo_4x8_nbf at full width, 2 blocks x 1 round at 12 dB (one
    # reservoir, K3 and K2 a block, captured in the graph), against the
    # eager nbf_snr_point on the same keys: identical
    nbf_b = dataclasses.replace(nbf, esn=dataclasses.replace(
        nbf.esn, rng_mode="block"))
    bstep = tmc.make_sharded_nbf_scan_step(nbf_b)
    keys_b = keys_n[0][:1, :2]
    wall_b1 = wall_s(lambda: bstep(12.0, keys_b))
    pt_b, eager_b = [], []
    wall_b = wall_s(lambda: pt_b.append(tmc._host_nbf(bstep(12.0, keys_b))))
    wall_be = wall_s(lambda: eager_b.append(
        nbf_snr_point(nbf_b, 12.0, keys_b)))
    _check(same(pt_b[0], eager_b[0]),
           f"nbf step block: the fused point differs from the eager one: "
           f"{pt_b[0]} against {eager_b[0]}")
    _log(f"[nbf step block] mimo_4x8_nbf rng_mode=block, 2 blocks x 1 "
         f"round at 12 dB: identical to the eager nbf_snr_point | wall ms: "
         f"replayed {1e3 * wall_b:.3f}, eager {1e3 * wall_be:.3f}, first "
         f"call (its capture) {1e3 * wall_b1:.3f}")

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

    @contextlib.contextmanager
    def routes_taken(log: list, names=("make_fused_cdl_grid",
                                       "make_fused_cdl_snr_step",
                                       "cdl_snr_point")):
        """Record which route a curve takes: by default run_cdl_curve's
        grid, per-SNR step or eager point."""
        saved = {n: getattr(tmc, n) for n in names}
        for n, f in saved.items():
            setattr(tmc, n, lambda *a, _n=n, _f=f, **k:
                    log.append(_n) or _f(*a, **k))
        try:
            yield
        finally:
            for n, f in saved.items():
                setattr(tmc, n, f)

    with tempfile.TemporaryDirectory() as tmp:
        # the grid route (no checkpoint), its graphs released first so that
        # the CLI captures them as a new process would (the wrappers count
        # the warm-up's launches: a replay launches nothing from Python);
        # then the per-SNR step (--resume: checkpoints) and the eager route
        # (--debug-nans) on the same keys, each into its own directory: the
        # same CSV
        out_c = os.path.join(tmp, "cdl")
        argv_c = ["--preset", "mimo_4x8_cdl", "--ebno-list", "9,12,15",
                  "--blocks-per-device", "128", "--blocks-per-snr", "256",
                  "--adaptive-min-errors", "2000", "--adaptive-max-blocks",
                  "256"]
        route_g = []
        graphs.release_graphs()
        with routes_taken(route_g):
            _, _, wall_c, la_c = count_run(
                lambda ph: cli.main(argv_c + ["--outdir", out_c]),
                ("bp_decode", "esn_predict", "esn_states"), "curve")
        _check(route_g == ["make_fused_cdl_grid"],
               f"curve: the CLI without a checkpoint took {route_g}")
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
             f"rounds of 128, adaptive to 256 decoded blocks, the grid "
             f"route: wall {1e3 * wall_c:.1f} ms (its graphs captured) | "
             f"launches from Python (warm-ups) {la_c}")
        for r in rows:
            _log(f"[curve] EbNo {r[0]:g} dB: uncoded esn {r[1]:.4e} mmse "
                 f"{r[2]:.4e} | coded esn {r[3]:.4e} mmse {r[4]:.4e}")
        for m in topped:
            _log(f"[curve] {m}")
        csv_first = open(os.path.join(out_c, "results_ber.csv"), "rb").read()
        walls_r = {}
        for tag, extra in (("step", ["--resume"]), ("eager", ["--debug-nans"])):
            out_r, route_r = os.path.join(tmp, f"cdl_{tag}"), []
            with routes_taken(route_r):
                walls_r[tag] = wall_s(lambda: cli.main(
                    argv_c + ["--outdir", out_r] + extra))
            _check(set(route_r) == {"make_fused_cdl_snr_step" if tag == "step"
                                    else "cdl_snr_point"},
                   f"curve: the {tag} route took {route_r}")
            _check(open(os.path.join(out_r, "results_ber.csv"), "rb").read()
                   == csv_first,
                   f"curve: the {tag} route wrote another CSV than the grid")
        # resumed: every SNR point comes from its checkpoint
        out_s = os.path.join(tmp, "cdl_step")
        _, _, wall_r, la_r = count_run(
            lambda ph: cli.main(argv_c + ["--outdir", out_s, "--resume"]), (),
            "curve resume")
        _check(not any(la_r.values()),
               f"curve: the resumed call launched kernels: {la_r}")
        _check(open(os.path.join(out_s, "results_ber.csv"), "rb").read()
               == csv_first, "curve: the resumed call wrote another CSV")
        _log(f"[curve] the per-SNR step (--resume, checkpoints) and the eager "
             f"route (--debug-nans) on the same keys: the grid's CSV | wall "
             f"ms step {1e3 * walls_r['step']:.1f}, eager "
             f"{1e3 * walls_r['eager']:.1f}; a second call with --resume: no "
             f"launch, the same CSV, {1e3 * wall_r:.1f} ms")

        # flooding at max_iter 100 against layered at max_iter 50, same keys
        cfg_c = dataclasses.replace(cfg, ebno_db=(9.0, 12.0, 15.0))
        cfg_l = dataclasses.replace(cfg_c, ldpc=dataclasses.replace(
            cfg.ldpc, schedule="layered", max_iter=50))
        sched = {}
        for name, c_s, need, absent in (
                ("flooding", cfg_c, "bp_decode", "bp_decode_layered"),
                ("layered", cfg_l, "bp_decode_layered", "bp_decode")):
            graphs.release_graphs()     # captured in the run, as above
            res_s, ph_s, wall_sc, la_sc = count_run(
                lambda ph: run_cdl_curve(c_s, 256, blocks_per_round=128,
                                         progress=None, timings=ph),
                (need, "esn_predict", "esn_states"), f"curve {name}")
            _check(la_sc[absent] == 0,
                   f"curve {name}: the other BP kernel was launched: {la_sc}")
            sched[name] = (res_s, ph_s)
            _log(f"[curve {name}] run_cdl_curve max_iter {c_s.ldpc.max_iter}:"
                 f" MMSE coded "
                 f"{[r['ber_coded']['mmse'] for r in res_s]} avg iterations "
                 f"{[round(r['ldpc_avg_iters']['mmse'], 3) for r in res_s]} "
                 f"unconverged "
                 f"{[r['ldpc_unconverged_frac']['mmse'] for r in res_s]} | "
                 f"phases ms "
                 f"{json.dumps({k: round(v, 3) for k, v in ph_s.items()})} "
                 f"wall {1e3 * wall_sc:.1f} ms (its graphs captured) | "
                 f"launches from Python {la_sc}")
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

        # the block-fading curve: the CLI on mimo_4x8_nbf at 3 and 12 dB,
        # the grid route (its graphs released first, so that the CLI
        # captures them as a new process would)
        out_n = os.path.join(tmp, "nbf")
        argv_n = ["--preset", "mimo_4x8_nbf", "--ebno-list", "3,12",
                  "--blocks-per-device", "128", "--blocks-per-snr", "128"]
        nbf_routes = ("make_fused_nbf_grid", "make_sharded_nbf_scan_step",
                      "nbf_snr_point")
        route_n = []
        graphs.release_graphs()
        with routes_taken(route_n, nbf_routes):
            _, _, wall_cn, la_cn = count_run(
                lambda ph: cli.main(argv_n + ["--outdir", out_n]),
                ("bp_decode", "esn_predict", "esn_states", "svdvals_small"),
                "curve nbf")
        _check(route_n == ["make_fused_nbf_grid"],
               f"curve nbf: the CLI without a checkpoint took {route_n}")
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
        _log(f"[curve nbf] CLI mimo_4x8_nbf 3/12 dB, 128 blocks, the grid "
             f"route: results_ber.csv and channel_metrics_4x8.pkl written, "
             f"BERs equal to nbf_snr_point on the same keys | wall "
             f"{1e3 * wall_cn:.1f} ms (its graphs captured) | launches from "
             f"Python (warm-ups and captures) {la_cn}")
        # the scan step a call (--resume: checkpoints) and the eager route
        # (--debug-nans) on the same keys: the grid's CSV
        csv_n = open(os.path.join(out_n, "results_ber.csv"), "rb").read()
        walls_rn = {}
        for tag, extra in (("step", ["--resume"]), ("eager", ["--debug-nans"])):
            out_r, route_r = os.path.join(tmp, f"nbf_{tag}"), []
            with routes_taken(route_r, nbf_routes):
                walls_rn[tag] = wall_s(lambda: cli.main(
                    argv_n + ["--outdir", out_r] + extra))
            _check(set(route_r) == {"make_sharded_nbf_scan_step"}
                   if tag == "step" else "nbf_snr_point" in route_r,
                   f"curve nbf: the {tag} route took {route_r}")
            _check(open(os.path.join(out_r, "results_ber.csv"), "rb").read()
                   == csv_n,
                   f"curve nbf: the {tag} route wrote another CSV than the "
                   f"grid")
        _log(f"[curve nbf] the scan step (--resume, checkpoints) and the "
             f"eager route (--debug-nans) on the same keys: the grid's CSV | "
             f"wall ms step {1e3 * walls_rn['step']:.1f}, eager "
             f"{1e3 * walls_rn['eager']:.1f}")

        # 64-QAM on the block-fading preset: n = 512 x 6 = 3,072, Z = 384
        out_q = os.path.join(tmp, "nbf_qam6")
        _, _, wall_q, la_q = count_run(
            lambda ph: cli.main(
                ["--preset", "mimo_4x8_nbf", "--ebno-list", "12",
                 "--blocks-per-device", "128", "--blocks-per-snr", "128",
                 "--qam-bits", "6", "--outdir", out_q]),
            ("bp_decode", "esn_predict", "esn_states"), "curve nbf qam6")
        Zq = make_code(nbf.ldpc, nbf.ofdm.n_subcarriers * 6).qc.Z
        head_q, rows_q = read_csv(os.path.join(out_q, "results_ber.csv"))
        _check(Zq == 384 and head_q == head_n and len(rows_q) == 1
               and rows_q[0][0] == 12.0
               and os.path.exists(os.path.join(out_q,
                                               "channel_metrics_4x8.pkl")),
               f"curve nbf qam6: unexpected artifacts {head_q} {rows_q}")
        ber_q = {d: (rows_q[0][1 + i], rows_q[0][1 + len(dets) + i])
                 for i, d in enumerate(dets)}
        _check(all(0.0 < u_ < 0.5 for u_, _ in ber_q.values()),
               f"curve nbf qam6: uncoded BER not in (0, 0.5): {ber_q}")
        # the same point through nbf_snr_point on the same keys: the CSV is
        # its BERs. No "coded <= uncoded" gate: at 64-QAM this preset's MMSE
        # BER floors near 0.17 even at 28 dB, beyond the rate-1/2 code, and
        # its coded BER lies above the uncoded one in the JAX package's CLI
        # too (PERF.md, open questions); tests/test_torch_nbf_qam6.py holds
        # the 64-QAM path against the JAX package on the CPU.
        cfg_q = dataclasses.replace(nbf, ofdm=dataclasses.replace(
            nbf.ofdm, bits_per_symbol=6))
        pt_q = nbf_snr_point(cfg_q, 12.0, rng.block_keys(
            rng.prng_key(nbf.seed), 0, torch.arange(G_nbf)).reshape(
                1, G_nbf, 2))
        for i, d in enumerate(dets):
            want_q = (pt_q.bit_errors[d] / pt_q.total_bits,
                      pt_q.info_errors[d] / pt_q.total_info_bits)
            tol = 1e-3 if d.startswith("esn") else 0.0
            _check(all(abs(a_ - b_) <= tol * b_
                       for a_, b_ in zip(ber_q[d], want_q)),
                   f"curve nbf qam6 {d}: CSV {ber_q[d]} against "
                   f"nbf_snr_point's {want_q}")
        _log(f"[curve nbf qam6] CLI mimo_4x8_nbf --qam-bits 6 at 12 dB, 128 "
             f"blocks (n = 3,072, Z = {Zq}): (uncoded, coded) BER {ber_q}, "
             f"equal to nbf_snr_point on the same keys | "
             f"wall {1e3 * wall_q:.1f} ms | launches {la_q}")

        # the SISO-AWGN preset at full width (N = 512, 400-symbol blocks,
        # n_res 200): rounds of one block, as the preset's budget has it
        # (K3 on one row, K2 on 399), 8 rounds at each of 12, 15, 21 dB.
        # Bands from the JAX package's own curve (TPU run,
        # results/siso_qpsk_awgn_tpu_qc/results_ber.csv)
        out_s = os.path.join(tmp, "siso")
        _, _, wall_si, la_si = count_run(
            lambda ph: cli.main(
                ["--preset", "siso_qpsk_awgn", "--ebno-list", "12,15,21",
                 "--blocks-per-device", "1", "--blocks-per-snr", "8",
                 "--rounds-per-call", "8", "--outdir", out_s]),
            ("bp_decode", "esn_predict", "esn_states"), "curve siso")
        head_s, rows_s = read_csv(os.path.join(out_s, "results_ber.csv"))
        col = {h: i for i, h in enumerate(head_s)}
        ber_s = {r[0]: {h: r[i] for h, i in col.items()} for r in rows_s}
        _check([r[0] for r in rows_s] == [12.0, 15.0, 21.0]
               and "esn_fixed_uncoded" not in col
               and os.path.exists(os.path.join(
                   out_s, "siso_channel_capacity.png")) == os.path.exists(
                   os.path.join(out_s, "BER_curves.png")),
               f"curve siso: unexpected artifacts {head_s}")
        gates = (
            ("MMSE uncoded 12 dB", ber_s[12.0]["mmse_uncoded"], 0.7 * 3.85e-3,
             1.4 * 3.85e-3),
            ("ESN uncoded 15 dB", ber_s[15.0]["esn_uncoded"], 0.5 * 1.99e-3,
             2.0 * 1.99e-3),
            ("ESN uncoded 21 dB", ber_s[21.0]["esn_uncoded"], 0.0, 1e-4),
            ("MMSE coded 21 dB", ber_s[21.0]["mmse_coded"], 0.0, 0.0))
        for what, v, lo, hi in gates:
            _check(lo <= v <= hi, f"curve siso: {what} BER {v} outside "
                                  f"[{lo}, {hi}]")
        _log(f"[curve siso] CLI siso_qpsk_awgn 12/15/21 dB, 8 rounds of one "
             f"block (N 512, 399 data symbols, n_res 200, n = "
             f"{code_s.n}): wall {1e3 * wall_si:.1f} ms | launches {la_si}")
        for e_s, r in ber_s.items():
            _log(f"[curve siso] EbNo {e_s:g} dB: " + " ".join(
                f"{h} {v:.4e}" for h, v in r.items() if h != "EbNo(dB)"))
        _log("[curve siso] gates (JAX package's TPU curve: MMSE uncoded "
             "3.85e-3 at 12 dB, ESN uncoded 1.99e-3 at 15 dB and 2.4e-6 at "
             "21 dB): " + ", ".join(f"{w} {v:.4e} in [{lo:.4g}, {hi:.4g}]"
                                    for w, v, lo, hi in gates))

        # the code families without QC structure: plain BP on the code's
        # graph, the same keys as a QC run of the same preset
        def family_run(preset, family, ebnos, n_blocks, G_f, c_qc, tag):
            out_f = os.path.join(tmp, tag)
            _, _, wall_f, la_f = count_run(
                lambda ph: cli.main(
                    ["--preset", preset, "--ldpc-family", family,
                     "--ebno-list", ",".join(f"{e:g}" for e in ebnos),
                     "--blocks-per-device", str(G_f),
                     "--blocks-per-snr", str(n_blocks), "--outdir", out_f]),
                ("graph_decode", "esn_predict", "esn_states"),
                f"curve {family}")
            _check(la_f["bp_decode"] == 0 and la_f["bp_decode_layered"] == 0,
                   f"curve {family}: a BP kernel was launched: {la_f}")
            head_f, rows_f = read_csv(os.path.join(out_f, "results_ber.csv"))
            got = {r[0]: dict(zip(head_f, r)) for r in rows_f}
            _check(list(got) == list(ebnos),
                   f"curve {family}: unexpected rows {rows_f}")
            c_f = dataclasses.replace(c_qc, ebno_db=tuple(ebnos), ldpc=
                                      dataclasses.replace(c_qc.ldpc,
                                                          family=family))
            return got, wall_f, la_f, c_f

        # mimo_2x2_nbf, Gallager: one round of 16 blocks at 12 and 18 dB.
        # At 12 dB this preset's MMSE uncoded BER (~0.17) is beyond the
        # rate-1/2 code and its coded BER lies above it, in the JAX
        # package's own Gallager curve too (results/mimo_2x2_nbf_tpu_adapt_
        # gal: 0.1722 uncoded, 0.1867 coded); "coded <= uncoded" is gated
        # at 18 dB (there 0.0846 and 0.0586)
        jax_gal = {12.0: (0.1722, 0.1867), 18.0: (0.0846, 0.0586)}
        got_g, wall_g, la_g2, c_gal = family_run(
            "mimo_2x2_nbf", "gallager", (12.0, 18.0), 16, 16, nbf2,
            "gallager")
        for jj, e_g in enumerate((12.0, 18.0)):
            k_g = rng.block_keys(rng.prng_key(nbf2.seed), jj,
                                 torch.arange(16)).reshape(1, 16, 2)
            ph_qc, ph_g = {}, {}
            pt_qc = nbf_snr_point(nbf2, e_g, k_g, timings=ph_qc)
            unc_qc = pt_qc.bit_errors["mmse"] / pt_qc.total_bits
            nbf_snr_point(c_gal, e_g, k_g, timings=ph_g)
            g_u, g_c = got_g[e_g]["mmse_uncoded"], got_g[e_g]["mmse_coded"]
            _check(abs(g_u - unc_qc) <= 0.1 * unc_qc
                   and (e_g < 18.0 or g_c <= g_u),
                   f"curve gallager {e_g} dB: MMSE {got_g[e_g]} against the "
                   f"QC run's uncoded {unc_qc}")
            _log(f"[curve gallager] CLI mimo_2x2_nbf --ldpc-family gallager "
                 f"{e_g:g} dB, 16 blocks: MMSE uncoded {g_u:.4e} coded "
                 f"{g_c:.4e} (QC run on the same keys: uncoded "
                 f"{unc_qc:.4e}; JAX's TPU Gallager curve: "
                 f"{jax_gal[e_g][0]} / {jax_gal[e_g][1]}) | decode ms graph "
                 f"BP {ph_g['decode']:.3f}, QC kernel {ph_qc['decode']:.3f}")
        _log(f"[curve gallager] wall {1e3 * wall_g:.1f} ms | launches "
             f"{la_g2}")

        # mimo_4x8_cdl, pyldpc: 128 blocks, one calibration and one decode
        # round of 64; JAX's TPU run of the same family, 256 blocks
        # (results/mimo_4x8_cdl_tpu_pyldpc12_s0): uncoded 0.0818, coded
        # 0.0093
        got_p, wall_p, la_p, c_py = family_run(
            "mimo_4x8_cdl", "pyldpc", (12.0,), 128, 64, cfg, "pyldpc")
        got_p = got_p[12.0]
        ph_p, ph_q = {}, {}
        res_p = run_cdl_curve(c_py, 128, blocks_per_round=64, progress=None,
                              timings=ph_p)
        res_q = run_cdl_curve(dataclasses.replace(c_py, ldpc=cfg.ldpc), 128,
                              blocks_per_round=64, progress=None,
                              timings=ph_q)
        unc_q = res_q[0]["ber_uncoded"]["mmse"]
        _check(got_p["MMSE_coded"] <= got_p["MMSE_uncoded"]
               and got_p["MMSE_coded"] <= 0.02
               and abs(got_p["MMSE_uncoded"] - unc_q) <= 0.1 * unc_q
               and abs(res_p[0]["ber_coded"]["mmse"] - got_p["MMSE_coded"])
               <= 1e-3 * got_p["MMSE_coded"],
               f"curve pyldpc: MMSE {got_p} against the QC run's uncoded "
               f"{unc_q}")
        _log(f"[curve pyldpc] CLI mimo_4x8_cdl --ldpc-family pyldpc 12 dB, "
             f"1 cal + 1 decode round of 64 blocks: MMSE uncoded "
             f"{got_p['MMSE_uncoded']:.4e} coded {got_p['MMSE_coded']:.4e} "
             f"(JAX's TPU run, 256 blocks: 0.0818 / 0.0093; QC run on the "
             f"same keys: uncoded {unc_q:.4e} coded "
             f"{res_q[0]['ber_coded']['mmse']:.4e}) | decode ms graph BP "
             f"{ph_p['decode']:.3f}, QC kernel {ph_q['decode']:.3f} | wall "
             f"{1e3 * wall_p:.1f} ms | launches {la_p}")

        # the ESN sweep CLI on the 2x2 plant, 16 blocks at 12 dB: K2 and K3
        # for every value (two fits a value: matched and fixed-SNR)
        n_fits = 2 if nbf2.esn.train_ebno_fixed_db is not None else 1
        for param in ("reservoir", "spectral"):
            out_w = os.path.join(tmp, "sweeps")
            n_val = len(esn_sweep.SWEEPS[param])
            _, _, wall_w, la_w = count_run(
                lambda ph: esn_sweep.main(
                    ["--param", param, "--ebno", "12", "--blocks", "16",
                     "--outdir", out_w]),
                ("esn_predict", "esn_states"), f"sweep {param}")
            with open(os.path.join(out_w, f"ESN_sweep_{param}.json")) as f:
                sw = json.load(f)
            _check(la_w["esn_predict"] == n_val
                   and la_w["esn_states"] == n_fits * n_val
                   and la_w["bp_decode"] == 0 and la_w["graph_decode"] == 0,
                   f"sweep {param}: launches {la_w} for {n_val} values")
            _check(list(sw) == [str(float(v))
                                for v in esn_sweep.SWEEPS[param]]
                   and all(0.0 < b < 0.5 for b in sw.values()),
                   f"sweep {param}: unexpected ESN_sweep_{param}.json {sw}")
            # the same sweep at 2 blocks on the card and on the CPU (the
            # plain versions), state noise 0: a few bit flips apart
            base0 = dataclasses.replace(nbf2, ldpc=dataclasses.replace(
                nbf2.ldpc, enabled=False), esn=dataclasses.replace(
                nbf2.esn, noise=0.0))
            bits = 2 * nbf2.data_symbols_per_block * nbf2.channel.n_tx \
                * nbf2.ofdm.n_subcarriers * nbf2.ofdm.bits_per_symbol
            with contextlib.redirect_stdout(io.StringIO()):
                on = {d: esn_sweep.run_sweep(param, 12.0, 2, 0, base0,
                                             device=d)
                      for d in ("cuda", "cpu")}
            flips = {v: round(abs(on["cuda"][v] - on["cpu"][v]) * bits)
                     for v in on["cpu"]}
            _check(all(f <= 0.01 * on["cpu"][v] * bits + 10
                       for v, f in flips.items()),
                   f"sweep {param}: cuda and cpu differ: {on}")
            with open(os.path.join(os.path.dirname(os.path.abspath(
                    __file__)), "results", "esn_sweeps",
                    f"ESN_sweep_{param}.json")) as f:
                sw_jax = json.load(f)
            _log(f"[sweep] {param} at 12 dB, 16 blocks of mimo_2x2_nbf: ESN "
                 f"BER {sw} (the JAX package's TPU sweep, "
                 f"results/esn_sweeps: {sw_jax}) | wall {1e3 * wall_w:.1f} "
                 f"ms | launches {la_w} | 2 blocks at noise 0, bit errors "
                 f"cuda - cpu {flips}")

        # ---- the classify CLI (system model 1) at full width --------------
        # no kernel on the sm1 path: the dataset, the LMMSE solve and the
        # zoo's training are PyTorch library calls; the sm2 frontend's ESN
        # fit runs K3
        from esn_ofdm_mimo_tpu_torch.experiments import classify as clf_cli
        from esn_ofdm_mimo_tpu_torch.pipelines import classification as \
            clf_pipe

        def classify_run(argv, need, what):
            out = os.path.join(tmp, what.replace(" ", "_"))
            torch.cuda.reset_peak_memory_stats()
            with contextlib.redirect_stdout(io.StringIO()) as so:
                _, _, wall_c, la_c = count_run(
                    lambda ph: clf_cli.main(argv + ["--outdir", out]), need,
                    what)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            with open(os.path.join(out, "model_results.pkl"), "rb") as f:
                mr = pickle.load(f)
            with open(os.path.join(out, "events.jsonl")) as f:
                ev = [json.loads(line) for line in f]
            res_c = mr["results"]
            ser_c = {e: {m: r["ser"] for m, r in res_c[e].items()}
                     for e in res_c}
            _check(sorted(res_c) == [0.0, 10.0, 20.0]
                   and all(0.0 <= v <= 1.0 for r in ser_c.values()
                           for v in r.values())
                   and all(os.path.exists(os.path.join(out, a)) for a in
                           ("ser_vs_snr.pkl", "ber_vs_snr.pkl")),
                   f"{what}: artifacts or SERs out of range: {ser_c}")
            _log(f"[{what}] CLI {' '.join(argv)}: wall {1e3 * wall_c:.1f} "
                 f"ms | peak device memory {peak:.2f} GiB | launches "
                 f"{la_c}")
            # the CLI's warnings (the best-effort PNG step says so there)
            for line in so.getvalue().splitlines():
                if line.startswith("[warn]"):
                    _log(f"[{what}] CLI {line}")
            for e in sorted(ser_c):
                _log(f"[{what}] SER {e:g} dB: " + " ".join(
                    f"{m} {v:.5f}" for m, v in sorted(ser_c[e].items())))
            for rec in ev:
                if rec["event"] == "snr_done":
                    _log(f"[{what}] ms at {rec['ebno_db']:g} dB: "
                         + " ".join(f"{k} {v:.1f}"
                                    for k, v in rec["ms"].items()))
            return mr, ser_c, la_c, so.getvalue()

        # [classify sm1]: --fast at the reference's batch 64 (196,608
        # symbols an SNR), the wide zoo, 60 epochs; gates from the
        # reference's anchors (tests/test_sm1.py's windows)
        mr1, ser1, la1, out1 = classify_run(
            ["--fast", "--batch", "64", "--variant", "wide"], (),
            "classify sm1")
        # the draws of 3 SNRs' datasets and models, whatever the epochs
        # and batch: 6 fold_in, 20 split, 6 random_bits, 5 uniform and 15
        # normal an SNR
        _check(la1["threefry"] == 156
               and not any(v for k, v in la1.items() if k != "threefry")
               and "Trainable parameters" in out1,
               f"classify sm1: launches {la1} on a path whose one kernel is "
               f"the threefry RNG (156 launches), or no printed tables")
        want_params = {"esn": 9616, "deep_esn": 370216, "fnn": 11416,
                       "cnn": 180584, "rnn": 732016, "elm": 9600}
        got_params = {m: mr1["results"][0.0][m]["params"]
                      for m in want_params}
        _check(got_params == want_params,
               f"classify sm1: parameter counts {got_params}")
        _check(mr1["meta"]["nr_basegraph_fingerprint"] == "6e0522b9a8ebd5de",
               f"classify sm1: meta {mr1['meta']}")
        trad = {e: ser1[e]["traditional"] for e in ser1}
        _check(0.010 < trad[10.0] < 0.028 and 0.33 < trad[0.0] < 0.43,
               f"classify sm1: traditional SER {trad} outside (0.010, "
               f"0.028) at 10 dB or (0.33, 0.43) at 0 dB")
        _check(abs(ser1[10.0]["elm"] - trad[10.0]) <= 0.01,
               f"classify sm1: ELM {ser1[10.0]['elm']} against traditional "
               f"{trad[10.0]} at 10 dB")
        _check(all(v < 0.5 for v in ser1[20.0].values()),
               f"classify sm1: a model at or above SER 0.5 at 20 dB: "
               f"{ser1[20.0]}")
        # the CLI's 10 dB dataset again (its key: fold_key(root, 55, 1)):
        # E|z|^2 of the unbiased LMMSE output, the build's steps warm, and
        # the two RNG draws that dominate it, timed alone
        key10 = rng.fold_key(rng.prng_key(0, dev), 55, 1)
        ph_ds = {}
        ds10 = clf_pipe.make_equalized_dataset_sm1(10.0, key10, batch=64,
                                                   timings=ph_ds)
        ez2 = float((ds10.x.double() ** 2).sum(-1).mean())
        _check(abs(ez2 - 1.0) < 0.05, f"classify sm1: E|z|^2 = {ez2}")
        kb, _, _, kn = rng.split(key10, 4)
        ms_bits = cuda_ms(lambda: rng.randint(kb, (64, 4, 1536), 0, 2), 5)
        ms_noise = cuda_ms(lambda: rng.normal(kn, (2, 64, 14, 64, 8)), 5)
        _log(f"[classify sm1] 10 dB dataset (warm, {ds10.x.shape[0]} "
             f"symbols): E|z|^2 {ez2:.4f} | ms " + " ".join(
                 f"{k} {v:.2f}" for k, v in ph_ds.items())
             + f" | RNG alone: randint {ms_bits:.3f} ms (2 x 393,216 bit "
             f"draws), normal {ms_noise:.3f} ms (917,504) | LMMSE "
             f"{64 * 14 * 64} systems of 4 x 4")

        # [classify sm1 cpu]: the dataset at batch 2 on the card and on the
        # CPU from the same key: labels identical, features within 1e-4
        for e_c in (0.0, 10.0, 20.0):
            k_c = rng.fold_key(rng.prng_key(0), 55, int(e_c))
            dg = clf_pipe.make_equalized_dataset_sm1(e_c, k_c.to(dev),
                                                     batch=2)
            dc = clf_pipe.make_equalized_dataset_sm1(e_c, k_c, batch=2)
            err_c = float((dg.x.cpu() - dc.x).abs().max())
            _check(torch.equal(dg.labels.cpu(), dc.labels),
                   f"classify sm1 cpu: labels differ at {e_c} dB")
            _check(err_c <= 1e-4, f"classify sm1 cpu: features differ by "
                   f"{err_c} at {e_c} dB")
            _log(f"[classify sm1 cpu] {e_c:g} dB, batch 2 "
                 f"({dc.x.shape[0]} symbols): labels identical, features "
                 f"max abs error {err_c:.3e} (tolerance 1e-4)")

        # [classify sm2]: the framework's own CDL link at full width
        # (mimo_4x8_cdl, 2 blocks an SNR): K3 fits the ESN of every block
        _, ser2, _, _ = classify_run(["--frontend", "sm2", "--fast"],
                                     ("esn_states",), "classify sm2")
        _check(ser2[20.0]["traditional"] < 0.5,
               f"classify sm2: traditional SER {ser2[20.0]} at 20 dB")

        # ---- the 2x2 model-zoo comparison at full width --------------------
        # [compare2x2]: run_zoo_blocks on uncoded mimo_2x2_nbf, 16 blocks, 50
        # epochs, at 12 and 30 dB with the CLI's keys (SNR indices 4 and 10
        # of the preset's grid), so the channel, bit and noise draws are
        # those of the JAX package's TPU run; depth cut from 11 SNRs to 2
        from esn_ofdm_mimo_tpu_torch.experiments import compare2x2 as cmp_cli
        from esn_ofdm_mimo_tpu_torch.models import zoo
        from esn_ofdm_mimo_tpu_torch.pipelines.zoo2x2 import run_zoo_blocks
        zc = dataclasses.replace(nbf2, ldpc=dataclasses.replace(
            nbf2.ldpc, enabled=False))
        tpu_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "results", "compare_2x2_tpu_r3")
        with open(os.path.join(tpu_dir, "BERvsEBNo_esn_all_ml_model.pkl"),
                  "rb") as f:
            tpu_ber = pickle.load(f)
        with open(os.path.join(tpu_dir, "NMSE_compare.pkl"), "rb") as f:
            tpu_nmse = pickle.load(f)
        root0 = rng.prng_key(0, dev)
        G_z, E_z = 16, 50
        # warm-up at the measured run's shapes (K2 and K3 at 16 blocks are
        # checked above), 2 epochs
        run_zoo_blocks(zc, 12.0, rng.block_keys(root0, 4, torch.arange(G_z)),
                       epochs=2)
        for jj in (4, 10):
            e_z = zc.ebno_db[jj]
            keys_z = rng.block_keys(root0, jj, torch.arange(G_z))
            out_z, ph_z, wall_z, la_z = count_run(
                lambda ph: run_zoo_blocks(zc, e_z, keys_z, epochs=E_z,
                                          timings=ph),
                ("esn_predict", "esn_states"), f"compare2x2 {e_z:g} dB")
            _check(la_z["esn_states"] == 2 and la_z["esn_predict"] == 3
                   and la_z["bp_decode"] == 0,
                   f"compare2x2 {e_z:g} dB: launches {la_z}, expected K3 "
                   f"twice and K2 three times")
            ber_z = {d: v / out_z.total_bits
                     for d, v in out_z.bit_errors.items()}
            i_t = tpu_ber["EBN0"].index(e_z)
            ref_z = {d: tpu_ber["BER"][d][i_t] for d in ber_z}
            # the classical detectors and the trained models see the TPU
            # run's draws and inits (measured within 7e-5 of its BERs); the
            # ESN's state noise is drawn from another stream (8e-4)
            for d, v in ber_z.items():
                band = (0.02 * ref_z[d] if d in ("zf_perfect", "zf_ls",
                                                 "mmse")
                        else 0.03 if d == "esn" else 0.002)
                _check(0.0 < v < 0.5 and abs(v - ref_z[d]) <= band,
                       f"compare2x2 {e_z:g} dB: {d} BER {v} against the "
                       f"TPU run's {ref_z[d]} (band {band})")
            _log(f"[compare2x2] mimo_2x2_nbf uncoded {e_z:g} dB, {G_z} "
                 f"blocks, {E_z} epochs (N {zc.ofdm.n_subcarriers}, n_res "
                 f"{zc.esn.n_reservoir}, D {zc.data_symbols_per_block}; "
                 f"depth cut from 11 SNRs to 2): wall {1e3 * wall_z:.1f} ms "
                 f"| launches {la_z}")
            _log(f"[compare2x2] {e_z:g} dB BER (TPU run, "
                 f"results/compare_2x2_tpu_r3): " + " ".join(
                     f"{d} {v:.5f} ({ref_z[d]:.5f})"
                     for d, v in ber_z.items()))
            for tab, mine in (("NMSE_train", out_z.train_nmse),
                              ("NMSE_test", out_z.test_nmse)):
                _log(f"[compare2x2] {e_z:g} dB {tab} a block (TPU run): "
                     + " ".join(f"{k} {v / G_z:.5f} "
                                f"({tpu_nmse[tab][k][i_t]:.5f})"
                                for k, v in mine.items()))
            _log(f"[compare2x2] {e_z:g} dB phases ms "
                 f"{json.dumps({k: round(v, 1) for k, v in ph_z.items()})}")

        # [compare2x2 gru]: the GRU's per-block training through
        # torch.nn.GRU (cuDNN; models/zoo.py:train_rnn_per_block, which no
        # pipeline runs since the zoo round took K7) against the plain loop
        # of rnn_apply under vmap at the pilot shape, 5 epochs; then the
        # trained GRUs' predictions at the data shape (18 rows a block)
        # against rnn_apply's with the plain loop's trained weights
        xg = torch.randn(G_z, 1, 522, 4, generator=gen, device=dev)
        yg = 0.3 * torch.randn(G_z, 1, 522, 4, generator=gen, device=dev)
        mg = [zoo.rnn_init(k, 4, 32, 4)
              for k in rng.split(rng.prng_key(19, dev), G_z).unbind(0)]
        t_g = {}
        for what_g, fn_g in (
                ("cudnn", lambda: zoo.train_rnn_per_block(
                    mg, xg, yg, epochs=5, lr=1e-2)),
                ("plain", lambda: zoo.train_regressor_per_block(
                    zoo.rnn_apply, mg, xg, yg, epochs=5, lr=1e-2))):
            sync()
            t0 = time.perf_counter()
            t_g[what_g] = fn_g()
            sync()
            t_g[what_g + " ms"] = 1e3 * (time.perf_counter() - t0) / 5
        err_g = float(((t_g["cudnn"].losses - t_g["plain"].losses).abs()
                       / t_g["plain"].losses.abs()).max())
        _check(err_g <= 1e-5, f"compare2x2 gru: losses differ from the "
                              f"plain loop by {err_g} relative")
        xd = torch.randn(G_z, 18, 522, 4, generator=gen, device=dev)
        with torch.no_grad():
            pred_g = t_g["cudnn"].params(xd)
            pred_p = zoo.apply_per_block(t_g["plain"].params, xd)
            ms_pg = cuda_ms(lambda: t_g["cudnn"].params(xd), 3)
            ms_pp = cuda_ms(lambda: zoo.apply_per_block(t_g["plain"].params,
                                                        xd), 1)
        err_pg = float((pred_g - pred_p).abs().max())
        _check(err_pg <= 1e-4, f"compare2x2 gru: predictions differ from "
                               f"rnn_apply's by {err_pg}")
        _log(f"[compare2x2 gru] {G_z} blocks x 522 steps, hidden 32, 5 "
             f"epochs: losses within {err_g:.3e} relative of the plain "
             f"loop (tolerance 1e-5) | ms an epoch: torch.nn.GRU (cuDNN) "
             f"{t_g['cudnn ms']:.1f}, plain loop under vmap "
             f"{t_g['plain ms']:.1f} | predictions of {G_z} x 18 rows: max "
             f"abs err {err_pg:.3e} (tolerance 1e-4), ms cuDNN "
             f"{ms_pg:.3f}, plain {ms_pp:.3f}")

        # [zoo step]: the captured zoo round (make_zoo_step, the zoo
        # cell's configuration: mimo_2x2_nbf with the script's reservoir
        # 100, no code, no fixed-SNR ESN; 128 blocks, 50 epochs, 12 dB)
        # against eager run_zoo_blocks on the same keys: the same kernels
        # (K7, capturable Adam) launched from Python, so identical.
        # Replays launch nothing from Python
        from esn_ofdm_mimo_tpu_torch.parallel import make_zoo_step
        from esn_ofdm_mimo_tpu_torch.pipelines import zoo2x2
        zc2 = dataclasses.replace(
            zc, num_ofdm_symbols=4000, esn=dataclasses.replace(
                zc.esn, n_reservoir=100, train_ebno_fixed_db=None))
        keys_s = [rng.block_keys(root0, 4, torch.arange(i * 128,
                                                         (i + 1) * 128))
                  for i in range(3)]
        step_z = make_zoo_step(zc2, dev, epochs=E_z)
        sync()
        t0 = time.perf_counter()
        first_z = zoo2x2.host_zoo(step_z(12.0, keys_s[0]))
        capture_s = time.perf_counter() - t0
        reset_counts()
        walls_z = []
        for k_s in keys_s[1:]:
            t0 = time.perf_counter()
            rep_z = zoo2x2.host_zoo(step_z(12.0, k_s))
            walls_z.append(time.perf_counter() - t0)
        la_rep = read_counts()
        _check(not any(la_rep.values()),
               f"zoo step: a replayed call launched from Python: {la_rep}")
        ph_z = {}
        zoo2x2.host_zoo(step_z(12.0, keys_s[2], ph_z))
        sync()
        reset_counts()
        t0 = time.perf_counter()
        eager_z = run_zoo_blocks(zc2, 12.0, keys_s[2], epochs=E_z)
        eager_s = time.perf_counter() - t0
        k2_routes.append(("zoo step eager", esn_cuda.launches_tf32,
                          esn_cuda.launches))
        _check(eager_z == rep_z, f"zoo step: a replay {rep_z} differs from "
                                 f"run_zoo_blocks {eager_z}")
        _log(f"[zoo step] {zc2.name} n_res 100, uncoded, 128 blocks, "
             f"{E_z} epochs, 12 dB: first call (build, eager warm-up, "
             f"capture) {capture_s:.2f} s, replays "
             f"{', '.join(f'{1e3 * w:.1f}' for w in walls_z)} ms (no "
             f"launch from Python), equal to eager run_zoo_blocks "
             f"({eager_s:.2f} s) | device ms of a replay "
             f"{json.dumps({k: round(v, 2) for k, v in ph_z.items()})}")
        del step_z
        graphs.release_graphs()

        # [compare2x2 cli]: the CLI once, --fast (N = 256), 2 blocks, 5
        # epochs, on its 5 SNRs: one step, its graph captured at the first
        # SNR (K3 twice and K2 three times in the warm-up and again in the
        # capture; K7 five times and twice), replayed at the others
        out_c = os.path.join(tmp, "compare2x2")
        with contextlib.redirect_stdout(io.StringIO()) as so:
            _, _, wall_cc, la_cc = count_run(
                lambda ph: cmp_cli.main(["--fast", "--blocks", "2",
                                         "--epochs", "5", "--outdir",
                                         out_c]),
                ("esn_predict", "esn_states"), "compare2x2 cli")
        with open(os.path.join(out_c, "BERvsEBNo_esn_all_ml_model.pkl"),
                  "rb") as f:
            cli_ber = pickle.load(f)
        with open(os.path.join(out_c, "NMSE_compare.pkl"), "rb") as f:
            cli_nmse = pickle.load(f)
        with open(os.path.join(out_c, "events.jsonl")) as f:
            cli_ev = [json.loads(line)["event"] for line in f]
        n_e = len(cli_ber["EBN0"])
        _check(sorted(cli_ber["BER"]) == sorted(tpu_ber["BER"])
               and sorted(cli_nmse) == ["EBN0", "NMSE_test", "NMSE_train"]
               and all(len(v) == n_e and all(0.0 <= b <= 1.0 for b in v)
                       for v in cli_ber["BER"].values())
               and cli_ev == ["run_start"] + ["snr_done"] * n_e
               + ["run_done"]
               and la_cc["esn_states"] == 2 * 2
               and la_cc["esn_predict"] == 2 * 3
               and la_cc["gru_train"] == 2 * (5 + 2),
               f"compare2x2 cli: artifacts {cli_ber}, {sorted(cli_nmse)}, "
               f"events {cli_ev}, launches {la_cc}")
        _log(f"[compare2x2 cli] --fast --blocks 2 --epochs 5 ({n_e} SNRs): "
             f"wall {1e3 * wall_cc:.1f} ms | launches {la_cc}")
        for line in so.getvalue().splitlines():
            if line.startswith(("[2x2]", "[warn]")):
                _log(f"[compare2x2 cli] {line}")

        def dist_nccl_fused(mesh, c_c, c_n):
            """[dist nccl fused]: the fused builders over the one-rank NCCL
            group `mesh` (the pairs gathered by all_gather_into, the
            counters summed by all_sum_, both between replays) against the
            same calls without a group, bit for bit, at full width, 8 blocks
            a round (CDL 1 + 1 rounds, NBF 1 round, 12 dB); a replayed call
            of each step under set_sync_debug_mode("error") until the
            counters are read; one traced (K1, K2, K3 and on NBF the SVD
            kernel launched by replays, none from Python); the walls beside
            the eager route over the same group."""
            G_d, root_d = 8, rng.prng_key(0)
            kc = rng.block_keys(root_d, 0, torch.arange(2 * G_d)).reshape(
                2, G_d, 2).to(dev)
            kn = kc[:1]
            runs = {}
            for tag, m in (("group", mesh), ("none", None)):
                runs[tag] = (
                    tmc.make_fused_cdl_snr_step(c_c, mesh=m),
                    tmc.make_fused_cdl_grid(c_c, G_d, 1, 1, mesh=m),
                    tmc.make_sharded_nbf_scan_step(c_n, mesh=m),
                    tmc.make_fused_nbf_grid(c_n, G_d, 1, mesh=m))
            calls = (lambda b: tmc._host_point(b(12.0, kc[:1], kc[1:])),
                     lambda b: b(root_d),
                     lambda b: tmc._host_nbf(b(12.0, kn)),
                     lambda b: b(root_d))
            out = {tag: [c(b) for c, b in zip(calls, bs)]
                   for tag, bs in runs.items()}
            _check(same(out["group"], out["none"]),
                   "dist nccl fused: the fused builders over the one-rank "
                   "group differ from the same calls without a group")
            _check(same(out["group"][0], out["group"][1][0])
                   and same(out["group"][2], out["group"][3][0]),
                   "dist nccl fused: a step differs from its grid")
            step_c, _, step_n, _ = runs["group"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                pt_c, pt_n = step_c(12.0, kc[:1], kc[1:]), step_n(12.0, kn)
            except RuntimeError as e:
                _fail(f"dist nccl fused: a replayed call over the group "
                      f"synchronizes the host: {e}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
            _check(same(tmc._host_point(pt_c), out["group"][0])
                   and same(tmc._host_nbf(pt_n), out["group"][2]),
                   "dist nccl fused: the calls under sync debug mode gave "
                   "other points")
            la, n_nccl = {}, {}
            for what, fn, need in (
                    ("cdl", lambda ph: calls[0](step_c),
                     ("bp_decode", "esn_predict", "esn_states")),
                    ("nbf", lambda ph: calls[2](step_n),
                     ("bp_decode", "esn_predict", "esn_states",
                      "svdvals_small"))):
                reset_counts()
                _, per = _trace_kernels(lambda: fn(None))
                la_py = read_counts()
                _check(not any(la_py.values()),
                       f"dist nccl fused {what}: a replayed call launched "
                       f"from Python: {la_py}")
                la[what] = _traced_launches(per, la_py)
                _check(all(la[what][k] > 0 for k in need),
                       f"dist nccl fused {what}: a kernel of the path was "
                       f"not launched by the replays: {la[what]}")
                for k, v in la[what].items():
                    launches_total[k] += v
                n_nccl[what] = sum(n for name, (_, n) in per.items()
                                   if "nccl" in name.lower())
            walls = {}
            eager = {}
            walls["cdl fused"] = wall_s(lambda: calls[0](step_c))
            walls["cdl eager"] = wall_s(lambda: eager.update(cdl=cdl_snr_point(
                c_c, 12.0, kc[:1], kc[1:], mesh=mesh)))
            walls["nbf fused"] = wall_s(lambda: calls[2](step_n))
            walls["nbf eager"] = wall_s(lambda: eager.update(nbf=nbf_snr_point(
                c_n, 12.0, kn, mesh=mesh)))
            _check(same(eager["cdl"], out["group"][0])
                   and same(eager["nbf"], out["group"][2]),
                   "dist nccl fused: the eager route over the group differs "
                   "from the fused one")
            _log(f"[dist nccl fused] one-rank NCCL group, mimo_4x8_cdl 12 dB "
                 f"{G_d} blocks x (1 cal + 1 decode) and mimo_4x8_nbf 12 dB "
                 f"{G_d} blocks x 1 round: make_fused_cdl_snr_step, "
                 f"make_fused_cdl_grid, make_sharded_nbf_scan_step and "
                 f"make_fused_nbf_grid over the group identical to the same "
                 f"calls without one, and to the eager route over the group; "
                 f"a replayed step syncs nowhere (sync debug mode) | traced "
                 f"launches of one replayed call: cdl {la['cdl']}, nbf "
                 f"{la['nbf']}; NCCL kernels in the traces {n_nccl} | wall "
                 f"ms over the group: cdl fused "
                 f"{1e3 * walls['cdl fused']:.3f}, eager "
                 f"{1e3 * walls['cdl eager']:.3f}; nbf fused "
                 f"{1e3 * walls['nbf fused']:.3f}, eager "
                 f"{1e3 * walls['nbf eager']:.3f} | {smi}")

        def dist_fused_two_ranks(out: str, port: int):
            """[dist fused 2 ranks] (see the comment where it is called)."""
            os.makedirs(out)
            modes = {m: tuple(dataclasses.replace(
                c, esn=dataclasses.replace(c.esn, rng_mode=m),
                ebno_db=(12.0,)) for c in (cfg, nbf))
                for m in ("block", "batch")}
            G_c, G_n = 16, 8
            root_d = rng.prng_key(0)
            kc = rng.block_keys(root_d, 0, torch.arange(2 * G_c)).reshape(
                2, G_c, 2)
            kn = rng.block_keys(root_d, 0, torch.arange(G_n)).reshape(
                1, G_n, 2)
            with open(os.path.join(out, "inputs.pkl"), "wb") as f:
                pickle.dump({"modes": modes, "cdl keys": kc, "nbf keys": kn,
                             "root": root_d, "device": "cuda"}, f)
            here = os.path.dirname(os.path.abspath(__file__))
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), WORLD_SIZE="2", PYTHONPATH=here)
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-child",
                 out], cwd=here, env=dict(env, RANK=str(r)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(2)]
            try:
                # one process's fused route on the same global blocks
                c_b, n_b = modes["block"]
                one = {"cdl step": tmc._host_point(
                           tmc.make_fused_cdl_snr_step(c_b)(
                               12.0, kc[:1].to(dev), kc[1:].to(dev))),
                       "cdl grid": tmc.make_fused_cdl_grid(
                           c_b, G_c, 1, 1)(root_d)[0],
                       "nbf scan": tmc._host_nbf(
                           tmc.make_sharded_nbf_scan_step(n_b)(
                               12.0, kn.to(dev)))}
                # one deadline for both ranks, 300 s from their start
                logs = [p.communicate(timeout=max(
                    1.0, 300 - (time.perf_counter() - t0)))[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            wall = time.perf_counter() - t0
            for r, (p, log) in enumerate(zip(procs, logs)):
                _check(p.returncode == 0,
                       f"dist fused 2 ranks: rank {r} exited "
                       f"{p.returncode}:\n{log[-4000:]}")
            res = []
            for r in range(2):
                with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                    res.append(pickle.load(f))
            for r, got in enumerate(res):
                _check(got["graphs"] and got["layout"] == [(2, r)],
                       f"dist fused 2 ranks: rank {r} replayed no CUDA "
                       f"graphs of its layout: {got['graphs']}, "
                       f"{got['layout']}")
                for k in one:
                    _check(same(got[k, "block"], one[k]),
                           f"dist fused 2 ranks: rank {r}'s {k} in block "
                           f"mode differs from one process's")
                for k, e in (("cdl step", "cdl eager"),
                             ("cdl grid", "cdl eager"),
                             ("nbf scan", "nbf eager")):
                    _check(same(got[k, "batch"], got[e]),
                           f"dist fused 2 ranks: rank {r}'s {k} in batch "
                           f"mode differs from the eager route over the "
                           f"ranks")
            c_1 = one["cdl step"].counts
            _log(f"[dist fused 2 ranks] two processes on one card, a gloo "
                 f"group: mimo_4x8_cdl 12 dB 2 x {G_c // 2} blocks x (1 cal "
                 f"+ 1 decode), mimo_4x8_nbf 12 dB 2 x {G_n // 2} blocks x 1 "
                 f"round, each rank replaying its own CUDA graphs: block "
                 f"mode identical to one process's fused route (calibrators "
                 f"included; info errors {c_1.info_errors}), batch mode "
                 f"identical to the eager route over the two ranks | rank "
                 f"walls ms {[got['walls'] for got in res]} | phase wall "
                 f"{wall:.1f} s | {smi}")

        # ---- torch.distributed at one NCCL rank ------------------------------
        # [dist nccl]: a process group of world size 1 from the variables
        # torchrun sets, through maybe_init_distributed(); the curves over
        # its one rank (both take their fused routes, eager only over
        # several ranks) and the eager NBF point over it against the same
        # calls without a group, bit for bit; sharded_fir at one rank
        # against the FIR; the group is destroyed afterwards
        import socket

        import torch.distributed as dist
        from esn_ofdm_mimo_tpu_torch.experiments import scaling as scale_cli
        from esn_ofdm_mimo_tpu_torch.ops import apply_fir_channel
        from esn_ofdm_mimo_tpu_torch.parallel import (maybe_init_distributed,
                                                      run_nbf_curve,
                                                      trials_mesh)
        from esn_ofdm_mimo_tpu_torch.parallel.seqshard import sharded_fir

        def free_port() -> int:
            with socket.socket() as so_:
                so_.bind(("localhost", 0))
                return so_.getsockname()[1]

        env_dist = {"MASTER_ADDR": "localhost", "WORLD_SIZE": "1",
                    "RANK": "0"}
        os.environ.update(env_dist, MASTER_PORT=str(free_port()))
        try:
            t0 = time.perf_counter()
            _check(maybe_init_distributed() and dist.get_backend() == "nccl"
                   and dist.get_world_size() == 1,
                   "dist nccl: no NCCL process group of one rank")
            init_s = time.perf_counter() - t0
            mesh = trials_mesh()
            c_n = dataclasses.replace(nbf, ebno_db=(12.0,))
            c_c = dataclasses.replace(cfg, ebno_db=(12.0,))
            curves = {}

            def both_curves(m):
                # both curves take their fused routes at one rank: their
                # graphs are released first, so that each run captures
                # (and launches from Python) as a new process would
                graphs.release_graphs()
                return (run_nbf_curve(c_n, 8, blocks_per_round=8,
                                      progress=None, mesh=m),
                        run_cdl_curve(c_c, 16, blocks_per_round=8,
                                      progress=None, mesh=m))

            for tag, m in (("group", mesh), ("none", None)):
                curves[tag], _, wall_d, la_d = count_run(
                    lambda ph, m=m: both_curves(m),
                    ("bp_decode", "esn_predict", "esn_states",
                     "svdvals_small"), f"dist nccl {tag}")
                _log(f"[dist nccl] {'one-rank group' if m else 'no group'}: "
                     f"run_nbf_curve mimo_4x8_nbf 12 dB 8 blocks, "
                     f"run_cdl_curve mimo_4x8_cdl 12 dB 16 blocks (1 cal + 1 "
                     f"decode round of 8) | wall {1e3 * wall_d:.1f} ms | "
                     f"launches {la_d}")
            _check(same(curves["group"], curves["none"]),
                   "dist nccl: the curves over the group differ from those "
                   "without one")
            # the eager NBF point over the group sums its counters with an
            # NCCL all_reduce (the curves above run fused at one rank and
            # reduce nothing): against the same point without a group
            keys_d = rng.block_keys(rng.prng_key(0), 0,
                                    torch.arange(8)).reshape(1, 8, 2)
            _check(mesh.group is not None,
                   "dist nccl: the one-rank layout has no process group")
            pt_g = nbf_snr_point(c_n, 12.0, keys_d, mesh=mesh)
            pt_n = nbf_snr_point(c_n, 12.0, keys_d)
            _check(same(pt_g, pt_n),
                   "dist nccl: the eager NBF point summed over the group "
                   "differs from the one without a group")
            taps = torch.randn(8, 4, 8, dtype=torch.complex64, generator=gen,
                               device=dev)
            xs_d = torch.randn(4, 4096, dtype=torch.complex64, generator=gen,
                               device=dev)
            y_g = sharded_fir(taps, xs_d, mesh.group)
            y_f = apply_fir_channel(taps, xs_d)
            err_f = float((y_g - y_f).abs().max() / y_f.abs().max())
            _check(err_f <= 1e-6, f"dist nccl: sharded_fir at one rank is "
                                  f"{err_f} from the FIR (relative)")
            _log(f"[dist nccl] NCCL group of world size 1 in {init_s:.2f} s: "
                 f"curves over it, and the eager NBF point's counters summed "
                 f"by all_reduce, identical to those without a group; "
                 f"sharded_fir (8 x 4 taps of 8, 4,096 samples) within "
                 f"{err_f:.2e} of the FIR (relative, tolerance 1e-6) | "
                 f"nbf {curves['group'][0].ber} cdl uncoded "
                 f"{curves['group'][1][0]['ber_uncoded']}")
            dist_nccl_fused(mesh, c_c, c_n)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        _check(not dist.is_initialized(), "dist nccl: the group survived")

        # [scaling]: the scaling CLI at --fast under the same variables, one
        # rank (it starts and destroys its own group)
        out_sc = os.path.join(tmp, "scaling.json")
        os.environ["MASTER_PORT"] = str(free_port())
        try:
            with contextlib.redirect_stdout(io.StringIO()) as so:
                _, _, wall_sc, la_sc = count_run(
                    lambda ph: scale_cli.main(["--fast", "--out", out_sc]),
                    ("esn_predict", "esn_states"), "scaling")
        finally:
            for k in (*env_dist, "MASTER_PORT"):
                os.environ.pop(k, None)
        with open(out_sc) as f:
            sc = json.load(f)
        _check(list(sc) == ["1"] and sc["1"]["blocks_per_s"] > 0
               and not dist.is_initialized(),
               f"scaling: unexpected --out {sc}")
        _log(f"[scaling] CLI --fast (mimo_2x2_nbf, 2 blocks a round, one "
             f"NCCL rank): {sc['1']['blocks_per_s']:.2f} blocks/s, "
             f"{1e3 * sc['1']['seconds_per_round']:.1f} ms a round | wall "
             f"{1e3 * wall_sc:.1f} ms | launches {la_sc} (one H100: no "
             f"scaling efficiency)")

        # [dist fused 2 ranks]: two processes on the one card (NCCL refuses
        # two ranks on one GPU) in a gloo group, each rank's CUDA tensors
        # staged through the host by parallel/mesh.py; each replays its own
        # CUDA graphs on its share (`_dist_child`). Block mode: the
        # flagship point and grid (2 x 8 blocks, 1 + 1 rounds, 12 dB) and
        # the NBF scan step (2 x 4 blocks, 1 round) equal one process's
        # fused route on the same global blocks, calibrators included,
        # computed here while the children run; batch mode: they equal the
        # eager route over the same two ranks, computed by the children
        dist_fused_two_ranks(os.path.join(tmp, "dist2"), free_port())

    if "--profile" in sys.argv[1:]:
        _profile_main_path(
            "main", lambda: cdl_snr_point(cfg, ebno, keys[0], keys[1]),
            1e3 * wall)
        # the 16 replays of one captured flagship chunk (captured again
        # where the graph cache has released it since)
        def chunks():
            return cdl_pipe.run_cdl_cal_counters_chunks(cfg, ebno,
                                                        keys_chunks)

        chunks()
        _profile_main_path("cal chunks", chunks, 1e3 * wall_chunks)
        # one replayed call of the fused point at bench.py's e2e shape,
        # after a call that captures its graphs again where released
        def fused_point():
            return tmc._host_point(step(ebno, *keys_s[1]))

        fused_point()
        _profile_main_path("cdl snr step", fused_point, 1e3 * best_s)
        _profile_main_path(
            "nbf main 12 dB",
            lambda: nbf_snr_point(nbf, 12.0, nbf_keys[12.0]),
            1e3 * nbf_wall[12.0])
        # one replayed [nbf step] call (2 rounds of 128 blocks at 12 dB),
        # after a call that captures its graph again where released
        def nbf_fused():
            return tmc._host_nbf(nstep(12.0, keys_n[1]))

        nbf_fused()
        _profile_main_path("nbf step", nbf_fused, 1e3 * best_n)

    # K2's route on each counted run: the cells' paths (C's chunks, A's
    # point, B's round, Z's round) take the TF32 build at every launch
    cells = ("cal chunks", "cdl snr step", "nbf step", "zoo step")
    for what, n_tf32, n_k2 in k2_routes:
        if n_k2:
            _log(f"[K2 route] {what}: {n_tf32} of {n_k2} K2 launches TF32")
        if what.startswith(cells) and n_k2:
            _check(n_tf32 == n_k2,
                   f"{what}: {n_tf32} of {n_k2} K2 launches took the TF32 "
                   f"build")

    # ---- 8. result lines ----------------------------------------------------
    for name, n in launches_total.items():
        if name in kernels:
            kernels[name]["launches"] = n
    order = ("bp_decode", "bp_decode_layered", "esn_predict", "esn_states",
             "esn_predict_grouped", "esn_predict_ablate", "svdvals_small",
             "threefry", "logreg_step")
    keys_out = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
    _log(json.dumps({"kernels": [{k: kernels[n][k] for k in keys_out}
                                 for n in order]}))
    _log(smi)
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _trace_kernels(run, tries: int = 4, settle_s: float = 0.3):
    """`run()` under torch.profiler: (its result, kernel name -> [device
    ms, launches]). The card's trace (CUPTI) holds every kernel that ran,
    those that a CUDA graph replay launched too, but it loses the records
    of the run's last milliseconds when the profiler stops right after the
    synchronize (a trace of one replayed [cdl snr step] call then lacks
    its last K1 and every kernel after it), so each trace waits `settle_s`
    after the run before it stops. Records may still go
    missing now and then, and a trace can only miss kernels, so `run`
    (the same launches every call) is traced until two traces count the
    same launches of every port kernel (`_counter_of`), at most `tries`
    times; the result is the last run's, the counts those two agree
    on."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        # the card's activity alone: host operators would add an event each
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = run()
            torch.cuda.synchronize()
            time.sleep(settle_s)
        per = collections.defaultdict(lambda: [0.0, 0])
        # the raw events: prof.events() builds a Python object an event,
        # seconds for a call's ~60k kernels
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                per[e.name()][0] += e.duration_ns() / 1e6
                per[e.name()][1] += 1
        la = collections.Counter()
        for name, (_, n) in per.items():
            if _counter_of(name):
                la[_counter_of(name)] += n
        key = tuple(sorted(la.items()))
        if key in seen:
            return out, seen[key]
        seen[key] = dict(per)
    _fail(f"no two of {tries} traces of one run count the same kernel "
          f"launches: {list(seen)}")


def _traced_launches(per: dict, counts: dict) -> dict:
    """The launches of a trace (`_trace_kernels`'s kernel name -> [ms, n])
    for each counter name of `counts`."""
    la = {k: 0 for k in counts}
    for name, (_, n) in per.items():
        if _counter_of(name):
            la[_counter_of(name)] += n
    return la


def _is_k2_tf32(kernel: str) -> bool:
    """Whether a traced kernel name is K2's TF32 build: predict_kernel<...,
    false, 0, true>."""
    if "predict_kernel<" not in kernel:
        return False
    args = kernel.split("predict_kernel<")[1].split(",")
    return len(args) > 4 and args[4].strip().startswith("true")


def _counter_of(kernel: str):
    """The launch counter of the port's kernel that a traced kernel name
    belongs to, or None. K5's builds share K2's name (the same template of
    esn_predict_core.cuh): a trace counts them as K2's."""
    if "esn_states_cluster_kernel" in kernel:
        return "esn_states"
    if "predict_kernel<" in kernel:
        grouped = kernel.split("predict_kernel<")[1].split(",")[2].strip()
        return "esn_predict_grouped" if grouped == "true" else "esn_predict"
    if "bp_layered_kernel" in kernel:
        return "bp_decode_layered"
    if "bp_flooding_kernel" in kernel:
        return "bp_decode"
    if "svdvals_small_kernel" in kernel:
        return "svdvals_small"
    if "threefry_" in kernel:
        return "threefry"
    if "logreg_step_kernel" in kernel:
        return "logreg_step"
    if "gru_train_kernel" in kernel or "gru_predict_kernel" in kernel:
        return "gru_train"
    return None


def _profile_main_path(what: str, run, wall_ms: float) -> None:
    """Device time by kernel over one main-path run under torch.profiler,
    and the share of the unprofiled run's wall time `wall_ms` the device
    was busy (kernels run on one stream, so their times add); the threefry
    kernel's launches and ms, and those of torch's int64 elementwise
    kernels (`long` in the name: what is left of the plain RNG's kind)."""
    _, per = _trace_kernels(run)
    busy = sum(v[0] for v in per.values())
    _log(f"[profile {what}] device kernels {busy:.3f} ms in "
         f"{sum(v[1] for v in per.values())} launches = "
         f"{100 * busy / wall_ms:.1f}% of the unprofiled wall "
         f"{wall_ms:.3f} ms")
    for label, pick in (
            ("threefry kernel", lambda k: _counter_of(k) == "threefry"),
            ("int64 elementwise",
             lambda k: "elementwise" in k and "long" in k)):
        sel = [v for k, v in per.items() if pick(k)]
        _log(f"[profile {what}] {label}: {sum(v[1] for v in sel)} launches, "
             f"{sum(v[0] for v in sel):.3f} ms")
    for name, (ms, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:15]:
        _log(f"[profile {what}] {ms:10.3f} ms {n:6d}x {name[:100]}")


def _dist_child(out: str) -> None:
    """One rank of [dist fused 2 ranks]: a gloo group from MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK on card 0 (or on the CPU where the
    inputs say so); the fused builders over it in both modes, and in batch
    mode the eager route over it; its results pickled to
    <out>/rank<r>.pkl."""
    import torch
    import torch.distributed as dist
    from esn_ofdm_mimo_tpu_torch.parallel import montecarlo as tmc
    from esn_ofdm_mimo_tpu_torch.parallel import trials_mesh
    from esn_ofdm_mimo_tpu_torch.pipelines import graphs

    with open(os.path.join(out, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    dev = torch.device(inp["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    mesh = trials_mesh()
    kc, kn = inp["cdl keys"].to(dev), inp["nbf keys"].to(dev)
    G_c, G_n = kc.shape[1], kn.shape[1]
    res, walls = {}, {}

    def timed(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        walls[name] = round(1e3 * (time.perf_counter() - t0), 3)
        return r

    for mode, (cfg, nbf) in inp["modes"].items():
        step = tmc.make_fused_cdl_snr_step(cfg, dev, mesh)
        grid = tmc.make_fused_cdl_grid(cfg, G_c, 1, 1, dev, mesh)
        scan = tmc.make_sharded_nbf_scan_step(nbf, dev, mesh)
        res["cdl step", mode] = timed(
            f"cdl step {mode}",
            lambda: tmc.host_point(step(12.0, kc[:1], kc[1:])))
        res["cdl grid", mode] = timed(f"cdl grid {mode}",
                                      lambda: grid(inp["root"])[0])
        res["nbf scan", mode] = timed(f"nbf scan {mode}",
                                      lambda: tmc._host_nbf(scan(12.0, kn)))
        if mode == "batch":
            res["cdl eager"] = timed("cdl eager", lambda: tmc.host_point(
                tmc.cdl_snr_point(cfg, 12.0, kc[:1], kc[1:], dev, mesh=mesh)))
            res["nbf eager"] = timed("nbf eager", lambda: tmc.nbf_snr_point(
                nbf, 12.0, kn, dev, mesh=mesh))
    # every graph set this rank made: its layout, and CUDA graphs on the card
    sets = list(graphs._CACHE.items())
    layout = sorted({key[5] for key, _ in sets})
    replayed = dev.type == "cpu" or all(
        b.graph is not None for _, g in sets for b in g.bodies.values())
    res.update(walls=walls, layout=layout, graphs=replayed and len(sets) == 4)
    with open(os.path.join(out, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-child"]:
        _dist_child(sys.argv[2])
    else:
        main()
