// Threefry-2x32 and the draws built on it (bits, uniform, normal,
// Bernoulli), Hopper.
//
// A port kernel with no Pallas counterpart: it replaces `jax.random`'s one
// primitive, `threefry2x32_p`, through which the JAX package draws every
// random number (keys, taps, bits, AWGN, reservoirs; e.g.
// esn_ofdm_mimo_tpu/ops/channel.py:275). XLA fuses that primitive into one
// loop on the TPU, and jaxlib lowers it to a hand-written kernel on CUDA;
// the port's plain version (esn_ofdm_mimo_tpu_torch/utils/rng.py,
// `threefry2x32_plain` and the `*_plain` draws) spends ~170 int64
// elementwise torch operations on one hash, each a pass over the whole
// draw. The counters follow JAX's partitionable mode
// (`jax_threefry_partitionable=True`, the JAX 0.9 default): element i of a
// key's draw hashes the counter words (hi32(i), lo32(i)); `fold_in` hashes
// (0, data) and `split` (0, j).
//
// One thread hashes one counter at a time, in a grid-stride loop with
// 64-bit indices (draws over 2^31 elements). The 20 rounds of a hash are
// one dependent chain of integer operations (an add, a funnel-shift
// rotation, an xor each round, and the key injections): nothing is shared
// between counters, so a thread a counter is the whole parallelism and
// needs neither shared memory nor synchronisation. Each thread reads only
// its key (16 bytes, from L1/L2) and writes its element once.
//
// What bounds it on the H100. Integer operations, in every mode at the
// main paths' sizes: at the least 67 int32 instructions a hash (the
// rounds' 60, x1's counter add and 5 injections, x0's last injection; its
// other injections fold into the next round's three-input add) and 1-2 of
// the epilogue, at 64 int32 lanes an SM (132 SMs at ~1.98 GHz, ~16.7 T
// operations/s), against at most 8 bytes written an element (3.35 TB/s):
// a 10.23M-element normal is ~42 us of integer work and ~12 us of writes.
// The float epilogues (the normal's erfinv, ~30 fp32 operations and a
// log1pf) add less than the hash.
//
// The epilogues repeat the plain version's operations one for one, each
// rounded as torch rounds it on the card (built with --fmad=false, see
// utils/build.py, and written with explicit _rn intrinsics, so no multiply
// and add is contracted into an fma):
//   BITS       y0 ^ y1, as int64 (the API's type);
//   UNIFORM    f = bits((bits >> 9) | 0x3F800000) - 1 in fp32, then
//              f64(f) * span + lo in float64, rounded once to fp32, clamped
//              below at lo (rng.py: uniform_plain);
//   NORMAL     UNIFORM on [nextafter(-1, 0), 1), then XLA's fp32 erfinv
//              (rng.py: _erfinv_f32): w = -log1pf(-x * x), the branch at
//              w < 5, a 9-term Horner with separate multiply and add, the
//              |x| == 1 case; times sqrt(2) rounded to fp32;
//   BERNOULLI  UNIFORM on [0, 1) < p, as bool.
// HASH (fold_in, split) writes both words as an int64 key pair.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kBits = 1, kUniform = 2, kNormal = 3, kBernoulli = 4;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds: rng.py threefry2x32_plain
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& y0, uint32_t& y1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

// uniform_plain's float steps on one element's bits
__device__ __forceinline__ float uniform_of(uint32_t bits, double span,
                                            double lo) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float v = __double2float_rn(__dadd_rn(__dmul_rn((double)f, span), lo));
  return fmaxf(v, (float)lo);
}

// _erfinv_f32: Giles' single-precision polynomial as XLA evaluates it
__device__ __forceinline__ float erfinv_f32(float x) {
  // the coefficients of rng.py _ERFINV_LT5 / _ERFINV_GE5 rounded to fp32,
  // written exactly
  constexpr float kLt5[9] = {0x1.e2cb1p-26f,  0x1.70966cp-22f,
                             -0x1.d8e6aep-19f, -0x1.26b582p-18f,
                             0x1.ca65b6p-13f,  -0x1.48a81p-10f,
                             -0x1.11c9dep-8f,  0x1.f91ec6p-3f,
                             0x1.805c5ep+0f};
  constexpr float kGe5[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f,
                             0x1.61b8e4p-10f,  -0x1.e17bcep-9f,
                             0x1.7824f6p-8f,   -0x1.f38baep-8f,
                             0x1.354afcp-7f,   0x1.006db6p+0f,
                             0x1.6a9efcp+1f};
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? kLt5[0] : kGe5[0];
#pragma unroll
  for (int k = 1; k < 9; ++k)
    p = __fadd_rn(lt ? kLt5[k] : kGe5[k], __fmul_rn(p, w));
  return fabsf(x) == 1.0f ? __fmul_rn(x, FLT_MAX) : __fmul_rn(p, x);
}

// fold_in / split: element e (of n) hashes the key of row e / kdiv (rows
// `kstride` int64 apart) with the counter words (0, c): c the data element
// e, or cnst + e % kdiv without data (fold_in of an integer: kdiv 1; split:
// cnst 0, kdiv the keys a row)
__global__ void __launch_bounds__(kThreads)
threefry_hash_kernel(const long long* __restrict__ keys, long long kstride,
                     long long kdiv, const long long* __restrict__ data,
                     long long cnst, long long n,
                     long long* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < n; e += step) {
    const long long* k = keys + e / kdiv * kstride;
    const uint32_t c = data ? (uint32_t)data[e] : (uint32_t)(cnst + e % kdiv);
    uint32_t y0, y1;
    threefry2x32((uint32_t)k[0], (uint32_t)k[1], 0u, c, y0, y1);
    out[2 * e] = y0;
    out[2 * e + 1] = y1;
  }
}

// random_bits and its epilogues: element e = row * size + i of the
// (rows, size) draw hashes key row `row` with the counter words
// (hi32(i), lo32(i))
template <int MODE>
__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(const long long* __restrict__ keys, long long kstride,
                     long long rows, long long size, double span, double lo,
                     float p, void* __restrict__ out) {
  const long long n = rows * size;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  // (row, i) of e, advanced by the stride without a division a step
  long long row = e / size, i = e - row * size;
  const long long srow = step / size, si = step - srow * size;
  for (; e < n; e += step) {
    const long long* k = keys + row * kstride;
    uint32_t y0, y1;
    threefry2x32((uint32_t)k[0], (uint32_t)k[1],
                 (uint32_t)((unsigned long long)i >> 32), (uint32_t)i, y0,
                 y1);
    const uint32_t bits = y0 ^ y1;
    if (MODE == kBits) {
      static_cast<long long*>(out)[e] = bits;
    } else if (MODE == kUniform) {
      static_cast<float*>(out)[e] = uniform_of(bits, span, lo);
    } else if (MODE == kNormal) {
      static_cast<float*>(out)[e] =
          __fmul_rn(0x1.6a09e6p+0f, erfinv_f32(uniform_of(bits, span, lo)));
    } else {
      static_cast<bool*>(out)[e] = uniform_of(bits, span, lo) < p;
    }
    row += srow;
    i += si;
    if (i >= size) {
      i -= size;
      ++row;
    }
  }
}

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" int threefry_hash_launch(const void* keys, long long kstride,
                                    long long kdiv, const void* data,
                                    long long cnst, long long n, void* out,
                                    void* stream) {
  if (n <= 0) return 0;
  if (kdiv < 1) return (int)cudaErrorInvalidValue;
  threefry_hash_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), kstride, kdiv,
      static_cast<const long long*>(data), cnst, n,
      static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

extern "C" int threefry_draw_launch(int mode, const void* keys,
                                    long long kstride, long long rows,
                                    long long size, double span, double lo,
                                    float p, void* out, void* stream) {
  if (rows <= 0 || size <= 0) return 0;
  const unsigned grid = blocks_for(rows * size);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* k = static_cast<const long long*>(keys);
  switch (mode) {
    case kBits:
      threefry_draw_kernel<kBits><<<grid, kThreads, 0, st>>>(
          k, kstride, rows, size, span, lo, p, out);
      break;
    case kUniform:
      threefry_draw_kernel<kUniform><<<grid, kThreads, 0, st>>>(
          k, kstride, rows, size, span, lo, p, out);
      break;
    case kNormal:
      threefry_draw_kernel<kNormal><<<grid, kThreads, 0, st>>>(
          k, kstride, rows, size, span, lo, p, out);
      break;
    case kBernoulli:
      threefry_draw_kernel<kBernoulli><<<grid, kThreads, 0, st>>>(
          k, kstride, rows, size, span, lo, p, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
