// ESN predict recurrence with the grouped readout staged on chip (K4),
// Hopper, fp32.
//
// Replaces the TPU kernel esn_ofdm_mimo_tpu/models/esn_pallas.py:
// _predict_kernel_grouped (esn_predict_pallas under
// ESN_TPU_PREDICT_READOUT=grouped). It computes exactly what K2
// (esn_predict.cu) computes; the plain version it is held against is the
// same esn_ofdm_mimo_tpu_torch/models/esn.py:esn_predict with a grouped
// (G, F, n_out) readout.
//
// What differs from K2. When Dg consecutive rows share a readout (detect runs
// the D data symbols of a coherence block), a block of `rows` consecutive
// rows touches at most P = rows // Dg + 2 readouts. The TPU kernel turned the
// per-lane readout into P masked MXU dots. On Hopper the readout is a small
// per-row dot either way; what can change is where its weights come from. K2
// reads Wout[row / Dg] through L1 from L2 at every step. Here the block's P
// slots (each F x n_out f32: 10 KB at the flagship, 20 KB at n_res = 600) are
// staged in shared memory once, before the T loop, and every step reads them
// from there.
//
// What bounds it, and the price. The recurrence is unchanged (fp32
// arithmetic bound, see esn_predict.cu). The slots add P x slot bytes of
// shared memory to the block, which the wrapper's tiling counts: the
// flagship (72 rows a block over runs of 74, P = 2) takes 181 KB, the
// mimo_4x8_nbf detect shape (18 rows a block over runs of 18, P = 3) 196 KB,
// one block an SM in both. The wrapper takes this kernel only where the JAX
// package takes its grouped kernel: Dg > 1 and P <= 4.

#include "esn_predict_core.cuh"

extern "C" int esn_predict_grouped_k_pad(int n_res, int n_in, int n_out) {
  return esn_predict::k_pad(n_res, n_in, n_out);
}

extern "C" long long esn_predict_grouped_smem_bytes(int n_res, int n_in,
                                                    int n_out, int height,
                                                    int P) {
  return (long long)esn_predict::smem_bytes(n_res, n_in, n_out, height, P);
}

extern "C" int esn_predict_grouped_launch(const float* u_fm, const float* wc,
                                          const float* wout, float* out, int B,
                                          int T, int n_res, int n_in,
                                          int n_out, int Dg, int n_forget,
                                          int rows, int height, float noise,
                                          float teacher_scaling,
                                          unsigned long long seed,
                                          void* stream) {
  if (Dg <= 1 || B % Dg || rows <= 0) return (int)cudaErrorInvalidValue;
  const int P = esn_predict::grouped_slots(B / Dg, Dg, rows);
  if (P > 4) return (int)cudaErrorInvalidValue;
  return esn_predict::launch_any<true>(u_fm, wc, wout, out, B, T, n_res, n_in,
                                       n_out, Dg, n_forget, rows, height, P,
                                       noise, teacher_scaling, seed, stream);
}
