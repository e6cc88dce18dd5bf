// Fused ESN predict (detect) recurrence, Hopper, fp32 (K2).
//
// Replaces the TPU kernel esn_ofdm_mimo_tpu/models/esn_pallas.py:
// _predict_kernel (launched by esn_predict_pallas). For every batch row it
// runs all T steps of
//     s' = tanh(W s + [W_in | W_fb] [u_t; o]) + noise * (U - 0.5)
//     o' = sum_f Wout[g, f, :] * [s'; u_t][f],   g = row / Dg
// from s = 0, o = 0, and writes o / teacher_scaling for t >= n_forget. The
// plain version it is held against is esn_ofdm_mimo_tpu_torch/models/esn.py
// (esn_predict). The kernel itself is esn_predict_core.cuh, shared with the
// grouped-readout variant K4 (esn_predict_grouped.cu).
//
// What bounds it on the H100. At the flagship shape (9,472 rows, T = 138,
// n_res = 300, n_in = 16, n_out = 8) the work is ~2.6e11 fp32 operations,
// almost all in the recurrence W s; the kernel reads ~84 MB of inputs and
// writes ~39 MB. So it is bound by fp32 arithmetic (~3.9 ms at 67 TFLOP/s),
// not by device memory (~0.04 ms) — if W stays on chip. W in f32 is
// 300 x 300 x 4 = 360 KB, more than one block's 227 KB of shared memory.
//
// Design (simple first; wgmma/TMA and a bf16/TF32 W are later work):
//   * a block owns 64 rows for all T steps (one launch, no per-step
//     launches). Its operand X = [s; u_t; o] (K_pad x 64 f32, 86 KB at the
//     flagship, 160 KB at n_res = 600) stays in shared memory across the
//     whole recurrence;
//   * the per-step update is one (n_p x K_pad) x (K_pad x 64) product with
//     the stacked weight Wc = [Wt; W_in_t; W_fb_t] (zero padded to
//     K_pad x n_p, n_p = n_res rounded up to 64). Wc is streamed from L2,
//     where all blocks keep it resident, in 16-row chunks through shared
//     memory; each thread accumulates a 4-row x 4*NJ4-neuron register tile
//     from float4 shared-memory reads (64 FMAs per 8 loads). ~106 KB of
//     shared memory lets two blocks share an SM, so the flagship's 148
//     blocks run in one wave on 132 SMs;
//   * the grouped readout is read from L2 per step, not repeated per row:
//     a row's readout is Wout[row / Dg] of the (G, F, n_out) stack, and a
//     64-row tile may straddle groups (74 does not divide 64); consecutive
//     threads take consecutive output columns of one row, so the readout
//     reads are coalesced and the state reads broadcast;
//   * state noise is Philox-4x32-10 (curand_kernel.h), one subsequence per
//     thread, seeded by the wrapper; it is added only to real neurons;
//   * everything is fp32 with fused multiply-adds, so sums differ from the
//     plain version's matmuls by rounding only (compared at atol 1e-4,
//     rtol 1e-3).

#include "esn_predict_core.cuh"

extern "C" int esn_predict_k_pad(int n_res, int n_in, int n_out) {
  return esn_predict::k_pad(n_res, n_in, n_out);
}

extern "C" int esn_predict_launch(const float* u_fm, const float* wc,
                                  const float* wout, float* out, int B, int T,
                                  int n_res, int n_in, int n_out, int Dg,
                                  int n_forget, float noise,
                                  float teacher_scaling,
                                  unsigned long long seed, void* stream) {
  return esn_predict::launch_any<false>(u_fm, wc, wout, out, B, T, n_res,
                                        n_in, n_out, Dg, n_forget, 0, noise,
                                        teacher_scaling, seed, stream);
}
