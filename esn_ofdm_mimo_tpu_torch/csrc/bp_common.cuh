// What the two BP decoder kernels share (bp_decode.cu, flooding;
// bp_decode_layered.cu, layered): the message clip, the three check rules on
// one check's dc clipped inputs, and the per-codeword epilogue (stats, then
// the info-bit error count or the hard bits through the fused permutation).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bp {

constexpr float kMsgClip = 16.0f;
constexpr float kSpClip = 0.9999999f;
constexpr int kDc = 8;  // check degree of every code the presets build

enum Algo { kSumProd = 0, kMinSum = 1, kOffsetMinSum = 2 };

__device__ __forceinline__ float clip_msg(float q) {
  return fminf(fmaxf(q, -kMsgClip), kMsgClip);
}

// Check->var messages r[j] from the clipped var->check messages q[j] of one
// check, leave-one-out. Min-sum keeps an online (min, second min, first
// argmin); compiled with --fmad=false both min-sum rules reproduce the plain
// version's floats exactly.
template <int DC>
__device__ __forceinline__ void check_update(const float (&q)[DC],
                                             float (&r)[DC], int algo,
                                             float scale, float offset) {
  if (algo == kSumProd) {
    float t[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) t[j] = tanhf(0.5f * q[j]);
    float fwd[DC];
    fwd[0] = 1.0f;
#pragma unroll
    for (int j = 1; j < DC; ++j) fwd[j] = fwd[j - 1] * t[j - 1];
    float bwd = 1.0f;
#pragma unroll
    for (int j = DC - 1; j >= 0; --j) {
      float p = fminf(fmaxf(fwd[j] * bwd, -kSpClip), kSpClip);
      r[j] = 2.0f * atanhf(p);
      bwd = bwd * t[j];
    }
  } else {
    float sprod = 1.0f;
    float m1 = fabsf(q[0]);
    float m2 = __int_as_float(0x7f800000);  // +inf
    int arg = 0;
#pragma unroll
    for (int j = 0; j < DC; ++j) sprod = sprod * (q[j] < 0.0f ? -1.0f : 1.0f);
#pragma unroll
    for (int j = 1; j < DC; ++j) {
      float a = fabsf(q[j]);
      if (a < m1) {
        m2 = m1;
        m1 = a;
        arg = j;
      } else {
        m2 = fminf(m2, a);
      }
    }
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      float s = sprod * (q[j] < 0.0f ? -1.0f : 1.0f);  // leave-one-out sign
      float loo = fminf(j == arg ? m2 : m1, kMsgClip);
      r[j] = (algo == kOffsetMinSum) ? s * fmaxf(loo - offset, 0.0f)
                                     : scale * s * loo;
    }
  }
}

// Called by every thread of the block once the codeword has stopped: Lt (n,)
// holds its final posteriors in natural order.
__device__ __forceinline__ void write_result(
    const float* Lt, int n, int b, bool ok, int it, int cap,
    const int* __restrict__ inv_perm, const int8_t* __restrict__ truth,
    const int* __restrict__ info_cols, int k, int8_t* __restrict__ bits,
    int* __restrict__ err, int* __restrict__ iters,
    uint8_t* __restrict__ conv) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  if (tid == 0) {
    iters[b] = ok ? it : cap;
    conv[b] = ok ? 1 : 0;
  }
  if (err != nullptr) {
    int total = 0;
    const int8_t* tb = truth + (size_t)b * k;
    for (int base = 0; base < k; base += nthr) {
      int i = base + tid;
      int bad = (i < k) && ((Lt[info_cols[i]] < 0.0f ? 1 : 0) != tb[i]);
      total += __syncthreads_count(bad);
    }
    if (tid == 0) err[b] = total;
  } else {
    int8_t* ob = bits + (size_t)b * n;
    for (int v = tid; v < n; v += nthr) ob[inv_perm[v]] = Lt[v] < 0.0f ? 1 : 0;
  }
}

}  // namespace bp
