// Fused ESN predict (detect) recurrence, Hopper, fp32 or a TF32 recurrence
// product (K2).
//
// Replaces the TPU kernel esn_ofdm_mimo_tpu/models/esn_pallas.py:
// _predict_kernel (launched by esn_predict_pallas). For every batch row it
// runs all T steps of
//     s' = tanh(W s + [W_in | W_fb] [u_t; o]) + noise * (U - 0.5)
//     o' = sum_f Wout[g, f, :] * [s'; u_t][f],   g = row / Dg
// from s = 0, o = 0, or from a carried (s0, o0) per row (pyESN's
// continuation), and writes o / teacher_scaling for t >= n_forget. The
// plain version it is held against is esn_ofdm_mimo_tpu_torch/models/esn.py
// (esn_predict, init_carry). The kernel itself is esn_predict_core.cuh, shared with the
// grouped-readout variant K4 (esn_predict_grouped.cu).
//
// What bounds it on the H100. At the flagship shape (9,472 rows, T = 138,
// n_res = 300, n_in = 16, n_out = 8) the work is ~2.6e11 fp32 operations,
// almost all in the recurrence W s; the kernel reads ~84 MB of inputs and
// writes ~39 MB. So it is bound by fp32 arithmetic (~3.9 ms at 67 TFLOP/s),
// not by device memory (~0.04 ms), if the state stays on chip and every SM
// works for all T steps. W in f32 (360 KB, 1.4 MB at n_res = 600) does not
// fit an SM's shared memory, so it is streamed from L2 at every step; what
// then holds the FMA pipe back is shared-memory traffic (each multiply-add
// needs operands loaded from it), barriers, and rows that do not fill the
// tiles or the SMs.
//
// Design:
//   * rows are dealt to the SMs evenly. The wrapper (models/esn_cuda.py:
//     predict_tiling) gives every SM the same number of blocks and every
//     block the same rows, B / SMs rounded up, all resident in one wave; the
//     kernel is built for tile heights of 20 and 72 rows, and a block
//     computes the smallest tile that holds its rows (flagship: 132 blocks of
//     72 rows; mimo_4x8_nbf detect, 2,304 rows at n_res = 600: 128 blocks of
//     18 rows in the 20-row tile). A block keeps its state S and two
//     buffers of [u; o] (even and odd steps) in shared memory for all T
//     steps;
//   * the per-step update is one (n_p x K) x (K x rows) product with the
//     stacked weight Wc = [Wt; W_in_t; W_fb_t] (n_p = n_res rounded up to
//     64). A thread holds a register tile of rows x neurons accumulators
//     (9 x 10 at the flagship); 256 threads a block, or 128 where 256 would
//     leave a thread too small a tile to pay for its shared-memory loads. A
//     warp covers all rows of the tile and its own slice of the neurons;
//   * the weight stream is overlapped and needs no block barrier: a warp
//     reads only its own columns of Wc, so each warp streams them with
//     cp.async (16 bytes, .cg) through a ring of its own, 4 chunks of 8 Wc
//     rows, three in flight while one is multiplied, across the step
//     boundary too. Inside the product the warps synchronise with
//     __syncwarp only; the block meets at four barriers a step. u_{t+1} is
//     copied by cp.async during step t;
//   * the readout is shared by all threads: a lane is a row, a warp takes
//     every 4th or 8th feature with 8 accumulators (all outputs of the row;
//     the state value is reused n_out times, the weights are read as
//     float4), the partial sums meet in shared memory. K2 reads the readout
//     weights Wout[row / Dg] through L1 from L2 at every step; the launcher
//     leaves L1 whatever shared memory the resident blocks do not need;
//   * state noise is Philox-4x32-10 (curand_kernel.h), one subsequence per
//     thread, added only to real neurons; the launch takes its 64-bit seed
//     in device memory and copies it to the library's constant slot
//     (esn_predict_core.cuh:c_seed) on its stream, so a captured CUDA
//     graph draws the stream of whatever seed the buffer holds at replay;
//   * everything is fp32 with fused multiply-adds, so sums differ from the
//     plain version's matmuls by rounding only (compared at atol 1e-4,
//     rtol 1e-3).
//
// The TF32 build (esn_predict_launch_tf32; the wrapper's route "tf32", for
// EsnConfig.recurrence_precision None: the JAX package's 1-pass bf16
// recurrence dot, which TF32's 10 mantissa bits exceed). The fp32 product
// is held at the SIMT FMA pipe (~4.6 ms of the flagship's ~8.6 at 1.755
// GHz), so the state rows of Wc go to the tensor cores:
//   * mma.sync m16n8k8 TF32 with fp32 sums, M = the tile's rows (5 m-tiles
//     for 72 rows, 2 for 20), N = 8 neurons (a warp's ring columns are
//     runs of 8 consecutive neurons), K = a chunk of 8 Wc rows: each warp
//     keeps streaming its own columns through its own ring, so the weight
//     stream and the four barriers a step are the fp32 build's. wgmma would
//     want 64-row tiles: 148 of them at the flagship's 9,472 rows, two
//     waves on 132 SMs;
//   * the operands are TF32 values, rounded to nearest (ties away): Wt by
//     the wrapper, the state once a step, when the readout has read s' in
//     fp32 (a carried s0 as it is loaded); the fragments are then plain
//     shared-memory loads, conflict-free (ring rows padded where needed);
//   * the [u; o] rows stay fp32 multiply-adds, into the MMA accumulators,
//     as does everything after the product (tanh, noise, readout);
//   * 256 threads a block at every tile height: with 128, one warp an SM
//     sub-partition exposed every fragment load and MMA latency (the NBF
//     shape ran 59 ms, slower than fp32), and 20 n-tiles of accumulators
//     spilled.
// What bounds it (chip runs of ablated builds, NVIDIA H100 80GB HBM3,
// 700 W): at the flagship shape ~5.9 ms, of which the MMAs ~0.6, the fp32
// [u; o] rows ~0.6-0.9, the weight stream ~0.3; the rest is what the fp32
// build also spends outside its product (readout through L1, tanh, the
// barriers) and the fragment loads. At the NBF shape ~25 ms, of which the
// 1.7 MB weight stream a block and step from L2 ~6. The MMAs themselves are
// no longer the bound: the next steps are overlapping the product with
// the readout and the epilogue, and the io rows. Its outputs are held
// against esn_predict(..., tf32=True) at atol 5e-4, rtol 1e-3: the tensor
// cores round a tile's sum otherwise than fp32 FMAs.
//
// Times (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W) are kept in
// PERF.md, beside those of the 64-row, barrier-per-chunk design this one
// replaced.

#include "esn_predict_core.cuh"

extern "C" int esn_predict_k_pad(int n_res, int n_in, int n_out) {
  return esn_predict::k_pad(n_res, n_in, n_out);
}

extern "C" long long esn_predict_smem_bytes(int n_res, int n_in, int n_out,
                                            int height, int P) {
  return (long long)esn_predict::smem_bytes(n_res, n_in, n_out, height, 0);
}

extern "C" int esn_predict_launch(const float* u_fm, const float* wc,
                                  const float* wout, float* out,
                                  const float* s0, const float* o0, int B,
                                  int T, int n_res, int n_in, int n_out,
                                  int Dg, int n_forget, int rows, int height,
                                  float noise, float teacher_scaling,
                                  const unsigned long long* seed, void* stream) {
  return esn_predict::launch_any<false>(u_fm, wc, wout, out, s0, o0, B, T,
                                        n_res, n_in, n_out, Dg, n_forget,
                                        rows, height, 0, noise,
                                        teacher_scaling, seed, stream);
}

// Whether the TF32 build has this reservoir width (tf32_width, the one list
// of them): models/esn_cuda.py launches the fp32 build at the others.
extern "C" int esn_predict_has_tf32(int n_res) {
  return n_res > 0 && esn_predict::tf32_width((n_res + 63) / 64);
}

// The TF32 build (models/esn_cuda.py, route "tf32"): the same operands with
// the state rows of wc rounded to TF32.
extern "C" long long esn_predict_smem_bytes_tf32(int n_res, int n_in, int n_out,
                                                 int height, int P) {
  return (long long)esn_predict::smem_bytes(n_res, n_in, n_out, height, 0, true);
}

extern "C" int esn_predict_launch_tf32(const float* u_fm, const float* wc,
                                       const float* wout, float* out,
                                       const float* s0, const float* o0, int B,
                                       int T, int n_res, int n_in, int n_out,
                                       int Dg, int n_forget, int rows,
                                       int height, float noise,
                                       float teacher_scaling,
                                       const unsigned long long* seed,
                                       void* stream) {
  return esn_predict::launch_any<false, true>(u_fm, wc, wout, out, s0, o0, B,
                                              T, n_res, n_in, n_out, Dg,
                                              n_forget, rows, height, 0, noise,
                                              teacher_scaling, seed, stream);
}
