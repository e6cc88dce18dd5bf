// Fused ESN predict (detect) recurrence, Hopper, fp32.
//
// Replaces the TPU kernel esn_ofdm_mimo_tpu/models/esn_pallas.py:
// _predict_kernel (launched by esn_predict_pallas). For every batch row it
// runs all T steps of
//     s' = tanh(W s + [W_in | W_fb] [u_t; o]) + noise * (U - 0.5)
//     o' = sum_f Wout[g, f, :] * [s'; u_t][f],   g = row / Dg
// from s = 0, o = 0, and writes o / teacher_scaling for t >= n_forget. The
// plain version it is held against is esn_ofdm_mimo_tpu_torch/models/esn.py
// (esn_predict).
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
//     flagship) stays in shared memory across the whole recurrence;
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

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // batch rows per block
constexpr int kThreads = 256;
constexpr int kRowThreads = 16;  // threads along rows, 4 rows each
constexpr int kKc = 16;        // Wc rows per staged chunk

template <int NJ4>
__global__ void __launch_bounds__(kThreads, NJ4 <= 5 ? 2 : 1)
esn_predict_kernel(const float* __restrict__ u_fm,  // (T, n_in, B) scaled
                   const float* __restrict__ wc,    // (K_pad, n_p)
                   const float* __restrict__ wout,  // (G, n_res + n_in, n_out)
                   float* __restrict__ out,         // (B, T - n_forget, n_out)
                   int B, int T, int n_res, int n_in, int n_out, int Dg,
                   int n_forget, int K_pad, float noise, float teacher_scaling,
                   unsigned long long seed) {
  constexpr int n_p = NJ4 * 64;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // (K_pad, kRows)
  float* Ws = X + K_pad * kRows;               // (kKc, n_p)

  const int tid = threadIdx.x;
  const int tx = tid % kRowThreads;  // rows tx*4 .. tx*4+3
  const int ty = tid / kRowThreads;  // neurons m*64 + ty*4 + q
  const int row0 = blockIdx.x * kRows;
  const int F = n_res + n_in;
  const int Tout = T - n_forget;

  curandStatePhilox4_32_10_t rng;
  if (noise != 0.0f) curand_init(seed, (unsigned long long)blockIdx.x * kThreads + tid, 0, &rng);

  for (int i = tid; i < K_pad * kRows; i += kThreads) X[i] = 0.0f;
  __syncthreads();

  auto load_u = [&](int t) {
    for (int i = tid; i < n_in * kRows; i += kThreads) {
      int r = i % kRows, f = i / kRows;
      int row = row0 + r;
      X[(n_res + f) * kRows + r] =
          row < B ? u_fm[((size_t)t * n_in + f) * B + row] : 0.0f;
    }
  };
  load_u(0);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- pre = Wc^T X over all K_pad contraction rows ----
    float acc[NJ4][4][4];
#pragma unroll
    for (int m = 0; m < NJ4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[m][q][r] = 0.0f;

    for (int k0 = 0; k0 < K_pad; k0 += kKc) {
      const float4* src = reinterpret_cast<const float4*>(wc + (size_t)k0 * n_p);
      float4* dst = reinterpret_cast<float4*>(Ws);
      for (int i = tid; i < kKc * n_p / 4; i += kThreads) dst[i] = __ldg(src + i);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKc; ++kk) {
        const float4 s4 =
            *reinterpret_cast<const float4*>(&X[(k0 + kk) * kRows + tx * 4]);
#pragma unroll
        for (int m = 0; m < NJ4; ++m) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(&Ws[kk * n_p + m * 64 + ty * 4]);
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[m][q][0] = fmaf(wv[q], s4.x, acc[m][q][0]);
            acc[m][q][1] = fmaf(wv[q], s4.y, acc[m][q][1]);
            acc[m][q][2] = fmaf(wv[q], s4.z, acc[m][q][2]);
            acc[m][q][3] = fmaf(wv[q], s4.w, acc[m][q][3]);
          }
        }
      }
      __syncthreads();
    }

    // ---- s' = tanh(pre) + noise, written over the state rows of X ----
#pragma unroll
    for (int m = 0; m < NJ4; ++m) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = m * 64 + ty * 4 + q;
        if (j < n_res) {
          float4 v = make_float4(tanhf(acc[m][q][0]), tanhf(acc[m][q][1]),
                                 tanhf(acc[m][q][2]), tanhf(acc[m][q][3]));
          if (noise != 0.0f) {
            const float4 z = curand_uniform4(&rng);
            v.x += noise * (z.x - 0.5f);
            v.y += noise * (z.y - 0.5f);
            v.z += noise * (z.z - 0.5f);
            v.w += noise * (z.w - 0.5f);
          }
          *reinterpret_cast<float4*>(&X[j * kRows + tx * 4]) = v;
        }
      }
    }
    __syncthreads();

    // ---- o' = grouped readout over [s'; u_t] (X rows < F) -> X rows F.. ----
    for (int idx = tid; idx < kRows * n_out; idx += kThreads) {
      const int r = idx / n_out, k = idx % n_out;
      const int row = row0 + r;
      if (row < B) {
        const float* w = wout + (size_t)(row / Dg) * F * n_out + k;
        float o = 0.0f;
        for (int f = 0; f < F; ++f) o = fmaf(__ldg(w + (size_t)f * n_out), X[f * kRows + r], o);
        X[(F + k) * kRows + r] = o;
        if (t >= n_forget)
          out[((size_t)row * Tout + (t - n_forget)) * n_out + k] = o / teacher_scaling;
      }
    }
    __syncthreads();
    if (t + 1 < T) {
      load_u(t + 1);
      __syncthreads();
    }
  }
}

template <int NJ4>
int launch(const float* u_fm, const float* wc, const float* wout, float* out,
           int B, int T, int n_res, int n_in, int n_out, int Dg, int n_forget,
           int K_pad, float noise, float teacher_scaling,
           unsigned long long seed, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)K_pad * kRows + (size_t)kKc * NJ4 * 64);
  cudaError_t e = cudaFuncSetAttribute(
      esn_predict_kernel<NJ4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + kRows - 1) / kRows;
  esn_predict_kernel<NJ4><<<blocks, kThreads, smem, stream>>>(
      u_fm, wc, wout, out, B, T, n_res, n_in, n_out, Dg, n_forget, K_pad,
      noise, teacher_scaling, seed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int esn_predict_k_pad(int n_res, int n_in, int n_out) {
  return (n_res + n_in + n_out + kKc - 1) / kKc * kKc;
}

extern "C" int esn_predict_launch(const float* u_fm, const float* wc,
                                  const float* wout, float* out, int B, int T,
                                  int n_res, int n_in, int n_out, int Dg,
                                  int n_forget, float noise,
                                  float teacher_scaling,
                                  unsigned long long seed, void* stream) {
  if (B <= 0 || T <= n_forget) return 0;
  const int K_pad = esn_predict_k_pad(n_res, n_in, n_out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define ESN_CASE(N)                                                         \
  case N:                                                                   \
    return launch<N>(u_fm, wc, wout, out, B, T, n_res, n_in, n_out, Dg,     \
                     n_forget, K_pad, noise, teacher_scaling, seed, s);
  switch ((n_res + 63) / 64) {
    ESN_CASE(1)
    ESN_CASE(2)
    ESN_CASE(3)
    ESN_CASE(4)
    ESN_CASE(5)
    ESN_CASE(6)
    ESN_CASE(7)
    ESN_CASE(8)
    ESN_CASE(9)
    ESN_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ESN_CASE
}
