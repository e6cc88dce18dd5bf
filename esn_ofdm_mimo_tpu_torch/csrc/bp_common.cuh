// What the two BP decoder kernels share (bp_decode.cu, flooding;
// bp_decode_layered.cu, layered): the message clip, the three check rules on
// one check's dc clipped inputs, and the per-codeword epilogue (stats, then
// the info-bit error count or the hard bits through the fused permutation).
//
// The sum-product rule runs on the special-function unit (SFU). A check
// rule takes at least two transcendentals an edge (one tanh-like, one
// log-like); libm's accurate tanhf and atanhf are software sequences of
// some 40 issue slots an edge together (atanhf a full IEEE divide and a
// log1pf), which held K1 at n = 2048. Here each edge takes four SFU
// operations (ex2, rcp for t; rcp, lg2 for r) and a few FP32 ones, in the
// TPU kernel's form 2 atanh(p) = log((1 + p) / (1 - p))
// (esn_ofdm_mimo_tpu/ldpc/decode_pallas.py:231). The PTX .approx forms are
// within 2 ulps (ex2, rcp) and 2^-22.6 absolute (lg2), and where a
// difference cancels (1 - e for small |q|, 1 + p for small |p|) a short odd
// Taylor polynomial takes over, so both functions stay within 1e-5 relative
// or 5e-7 absolute of float64 over the whole range the decoders feed them
// (chip_smoke.py [K1 rule]). Not tanh.approx.f32: its relative error of
// about 2^-11 is bf16-class, and the data path stays fp32. The plain
// version is ldpc/decode.py:tanh_half / log_ratio (exact exp/log, the same
// formulas and branches).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bp {

constexpr float kMsgClip = 16.0f;
constexpr float kSpClip = 0.9999999f;
constexpr int kDc = 8;  // check degree of every code the presets build
constexpr int kDv = 4;  // variable degree of every code the presets build

enum Algo { kSumProd = 0, kMinSum = 1, kOffsetMinSum = 2 };

__device__ __forceinline__ float clip_msg(float q) {
  return fminf(fmaxf(q, -kMsgClip), kMsgClip);
}

// The SFU approximations, flushing subnormals: no argument below is one
// that matters (ex2 sees [-23.1, 0], lg2 [6e-8, 1.7e7], rcp [1.2e-7, 2]).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// t = tanh(clip(q) / 2), clip to +-16: sign(q) (1 - e) / (1 + e), e =
// 2^(-min(|q|, 16) log2 e) in (1.1e-7, 1]; below |q| = 1/8, where 1 - e
// cancels, the odd Taylor polynomial q / 2 - q^3 / 24 (truncation 2e-6
// relative). The fused multiply-add is explicit: the source is built with
// --fmad=false for the min-sum rules' sake.
__device__ __forceinline__ float tanh_half(float q) {
  const float poly = q * __fmaf_rn(q * q, -1.0f / 24.0f, 0.5f);
  const float e = ex2_approx(fminf(fabsf(q), kMsgClip) * -1.44269504f);
  const float big = copysignf((1.0f - e) * rcp_approx(1.0f + e), q);
  return fabsf(q) < 0.125f ? poly : big;
}

// r = 2 atanh(p) = ln 2 * lg2((1 + p) / (1 - p)) for |p| <= 0.9999999;
// below |p| = 1/16, where 1 + p drops p's low bits, the odd Taylor
// polynomial 2 p + 2 p^3 / 3 (truncation 3e-6 relative).
__device__ __forceinline__ float log_ratio(float p) {
  const float poly = p * __fmaf_rn(p * p, 2.0f / 3.0f, 2.0f);
  const float big =
      0.693147181f * lg2_approx((1.0f + p) * rcp_approx(1.0f - p));
  return fabsf(p) < 0.0625f ? poly : big;
}

// The sum-product rule on one check: r[j] = 2 atanh(prod_{k != j} t[k]),
// t = tanh(clip(q) / 2), the leave-one-out products from a forward and a
// backward running product, clipped to +-0.9999999 (CLIP_P; that clip
// never binds: |t| <= 1 - 3 * 2^-24 at |q| >= 16, below the clip's
// 1 - 2^-23, and a product of such factors is no larger than its largest,
// so the layered kernel leaves it out: 2 instructions an edge).
template <int DC, bool CLIP_P = true>
__device__ __forceinline__ void sumprod_rule(const float (&q)[DC],
                                             float (&r)[DC]) {
  float t[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) t[j] = tanh_half(q[j]);
  float fwd[DC];
  fwd[0] = 1.0f;
#pragma unroll
  for (int j = 1; j < DC; ++j) fwd[j] = fwd[j - 1] * t[j - 1];
  float bwd = 1.0f;
#pragma unroll
  for (int j = DC - 1; j >= 0; --j) {
    float p = fwd[j] * bwd;
    if (CLIP_P) p = fminf(fmaxf(p, -kSpClip), kSpClip);
    r[j] = log_ratio(p);
    bwd = bwd * t[j];
  }
}

// Check->var messages r[j] from the var->check messages q[j] of one check,
// leave-one-out. The rules see the messages clipped to +-16, and take of
// them only min(|q|, 16) and the sign of q, which are clip(q)'s magnitude
// and sign: one FMNMX an edge where a two-sided clip and an abs would take
// three. Min-sum keeps an online (min, second min, first argmin); compiled
// with --fmad=false both min-sum rules reproduce the plain version's floats
// exactly. (The layered kernel has its own min-sum form,
// bp_decode_layered.cu:minsum_rule.)
template <int DC>
__device__ __forceinline__ void check_update(const float (&q)[DC],
                                             float (&r)[DC], int algo,
                                             float scale, float offset) {
#ifdef BP_SASS_ALGO
  algo = BP_SASS_ALGO;  // one rule's code only (tools/bench_bp_torch.py)
#endif
  if (algo == kSumProd) {
    sumprod_rule<DC>(q, r);
  } else {
    float sprod = 1.0f;
    float m1 = fminf(fabsf(q[0]), kMsgClip);
    float m2 = __int_as_float(0x7f800000);  // +inf
    int arg = 0;
#pragma unroll
    for (int j = 0; j < DC; ++j) sprod = sprod * (q[j] < 0.0f ? -1.0f : 1.0f);
#pragma unroll
    for (int j = 1; j < DC; ++j) {
      float a = fminf(fabsf(q[j]), kMsgClip);
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
