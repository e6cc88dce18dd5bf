// The fused ESN predict recurrence shared by esn_predict.cu (K2, per-row
// readout from L2) and esn_predict_grouped.cu (K4, readout slots staged in
// shared memory). The design notes are in those two files; this header holds
// the one kernel both instantiate, templated on the readout. A third template
// argument, a mask of parts switched OFF, gives the ablation builds of
// esn_predict_ablate.cu (K5); at its default of 0 every switch folds away at
// compile time and K2 and K4 are compiled from the same statements as before.
//
// For every batch row it runs all T steps of
//     s' = tanh(W s + [W_in | W_fb] [u_t; o]) + noise * (U - 0.5)
//     o' = sum_f Wout[g, f, :] * [s'; u_t][f],   g = row / Dg
// from s = 0, o = 0, and writes o / teacher_scaling for t >= n_forget.

#pragma once

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

namespace esn_predict {

constexpr int kRows = 64;        // batch rows per block
constexpr int kThreads = 256;
constexpr int kRowThreads = 16;  // threads along rows, 4 rows each
constexpr int kKc = 16;          // Wc rows per staged chunk
constexpr int kSlotPad = 8;      // floats between staged readout slots (banks)

// Parts of the recurrence an ablation build leaves out (kOff mask bits), with
// the micro-benchmark's meaning of each: no readout -> o = s'[:n_out]; no
// feedback -> the W_fb o term dropped; no noise; no tanh -> s' = 0.5 * pre;
// no recurrence product -> pre = s + W_in u (+ W_fb o). The wrapper zeroes
// the weight rows of a dropped term, so a chunk that straddles it adds 0.
enum Off {
  kNoReadout = 1,
  kNoFeedback = 2,
  kNoNoise = 4,
  kNoTanh = 8,
  kNoRecDot = 16,
};

inline int k_pad(int n_res, int n_in, int n_out) {
  return (n_res + n_in + n_out + kKc - 1) / kKc * kKc;
}

// Readout slots a 64-row tile over runs of Dg rows can touch: the JAX
// package's P = BC // Dg + 2 at the port's tile of kRows.
inline int grouped_slots(int G, int Dg) {
  const int p = kRows / Dg + 2;
  return p < G ? p : G;
}

template <int NJ4, bool kGrouped, int kOff = 0>
__global__ void __launch_bounds__(kThreads, NJ4 <= 5 && !kGrouped ? 2 : 1)
predict_kernel(const float* __restrict__ u_fm,  // (T, n_in, B) scaled
               const float* __restrict__ wc,    // (K_pad, n_p)
               const float* __restrict__ wout,  // (G, n_res + n_in, n_out)
               float* __restrict__ out,         // (B, T - n_forget, n_out)
               int B, int T, int n_res, int n_in, int n_out, int Dg,
               int n_forget, int K_pad, int P, float noise,
               float teacher_scaling, unsigned long long seed) {
  constexpr int n_p = NJ4 * 64;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // (K_pad, kRows)
  float* Ws = X + K_pad * kRows;               // (kKc, n_p)
  float* WO = Ws + kKc * n_p;                  // K4 only: (P, slot) readouts

  const int tid = threadIdx.x;
  const int tx = tid % kRowThreads;  // rows tx*4 .. tx*4+3
  const int ty = tid / kRowThreads;  // neurons m*64 + ty*4 + q
  const int row0 = blockIdx.x * kRows;
  const int F = n_res + n_in;
  const int Tout = T - n_forget;
  const int slot = F * n_out + kSlotPad;
  const int g0 = row0 / Dg;          // K4: the group of the tile's first row

  curandStatePhilox4_32_10_t rng;
  if (!(kOff & kNoNoise) && noise != 0.0f) curand_init(seed, (unsigned long long)blockIdx.x * kThreads + tid, 0, &rng);

  for (int i = tid; i < K_pad * kRows; i += kThreads) X[i] = 0.0f;
  if (kGrouped) {
    // stage the P readout slots this tile can touch, once for all T steps
    const int G = B / Dg;
    for (int p = 0; p < P; ++p) {
      const int g = min(g0 + p, G - 1);
      const float* src = wout + (size_t)g * F * n_out;
      for (int i = tid; i < F * n_out; i += kThreads) WO[p * slot + i] = __ldg(src + i);
    }
  }
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

  // contraction rows [k_lo, k_hi) of Wc: all K_pad unless an ablation drops
  // the recurrence product (whole chunks of Wt skipped) or the feedback
  const int k_lo = (kOff & kNoRecDot) ? n_res / kKc * kKc : 0;
  const int k_hi = (kOff & kNoFeedback) ? (F + kKc - 1) / kKc * kKc : K_pad;

  for (int t = 0; t < T; ++t) {
    // ---- pre = Wc^T X over the contraction rows ----
    float acc[NJ4][4][4];
#pragma unroll
    for (int m = 0; m < NJ4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (kOff & kNoRecDot) {  // pre starts from s itself
            const int j = m * 64 + ty * 4 + q;
            acc[m][q][r] = j < n_res ? X[j * kRows + tx * 4 + r] : 0.0f;
          } else {
            acc[m][q][r] = 0.0f;
          }
        }

    for (int k0 = k_lo; k0 < k_hi; k0 += kKc) {
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
          float4 v;
          if (kOff & kNoTanh) {
            v = make_float4(0.5f * acc[m][q][0], 0.5f * acc[m][q][1],
                            0.5f * acc[m][q][2], 0.5f * acc[m][q][3]);
          } else {
            v = make_float4(tanhf(acc[m][q][0]), tanhf(acc[m][q][1]),
                            tanhf(acc[m][q][2]), tanhf(acc[m][q][3]));
          }
          if (!(kOff & kNoNoise) && noise != 0.0f) {
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
        float o = 0.0f;
        if (kOff & kNoReadout) {
          o = X[k * kRows + r];
        } else if (kGrouped) {
          const float* w = WO + (row / Dg - g0) * slot + k;
          for (int f = 0; f < F; ++f) o = fmaf(w[f * n_out], X[f * kRows + r], o);
        } else {
          const float* w = wout + (size_t)(row / Dg) * F * n_out + k;
          for (int f = 0; f < F; ++f) o = fmaf(__ldg(w + (size_t)f * n_out), X[f * kRows + r], o);
        }
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

template <int NJ4, bool kGrouped, int kOff = 0>
int launch(const float* u_fm, const float* wc, const float* wout, float* out,
           int B, int T, int n_res, int n_in, int n_out, int Dg, int n_forget,
           int K_pad, int P, float noise, float teacher_scaling,
           unsigned long long seed, cudaStream_t stream) {
  size_t floats = (size_t)K_pad * kRows + (size_t)kKc * NJ4 * 64;
  if (kGrouped) floats += (size_t)P * ((n_res + n_in) * n_out + kSlotPad);
  const size_t smem = sizeof(float) * floats;
  cudaError_t e = cudaFuncSetAttribute(predict_kernel<NJ4, kGrouped, kOff>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + kRows - 1) / kRows;
  predict_kernel<NJ4, kGrouped, kOff><<<blocks, kThreads, smem, stream>>>(
      u_fm, wc, wout, out, B, T, n_res, n_in, n_out, Dg, n_forget, K_pad, P,
      noise, teacher_scaling, seed);
  return (int)cudaGetLastError();
}

// Dispatch on n_p / 64 = ceil(n_res / 64), 1 .. 10 (n_res <= 640).
template <bool kGrouped>
int launch_any(const float* u_fm, const float* wc, const float* wout,
               float* out, int B, int T, int n_res, int n_in, int n_out,
               int Dg, int n_forget, int P, float noise,
               float teacher_scaling, unsigned long long seed, void* stream) {
  if (B <= 0 || T <= n_forget) return 0;
  const int K_pad = k_pad(n_res, n_in, n_out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define ESN_CASE(N)                                                          \
  case N:                                                                    \
    return launch<N, kGrouped>(u_fm, wc, wout, out, B, T, n_res, n_in,       \
                               n_out, Dg, n_forget, K_pad, P, noise,         \
                               teacher_scaling, seed, s);
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

}  // namespace esn_predict
