// Flooding belief-propagation decoder for quasi-cyclic LDPC codes, Hopper.
//
// Replaces the TPU kernel esn_ofdm_mimo_tpu/ldpc/decode_pallas.py:_bp_kernel
// (launched by _decode_padded, driven by _decode_impl) for the flooding
// schedule and all three check rules (sum-product, normalised min-sum,
// offset min-sum). The plain version it is held against is
// esn_ofdm_mimo_tpu_torch/ldpc/decode.py (_decode_flooding).
//
// What bounds it on the H100. Per codeword the kernel reads n f32 LLRs and
// writes n int8 bits (or, in counts mode, reads k int8 truth bits and writes
// one count): ~2.6 KB, 0.2 GB for the flagship's 75,776 codewords, which
// the card moves in ~0.06 ms. The iterations are what cost: up to 100
// flooding sweeps over dv*dc*Z = 2,048 edges, ~16 operations per edge, so
// the work is data dependent (converged codewords stop early) and set by
// instruction issue and barriers, not by device memory.
//
// Design. The TPU layout (128 codewords on lanes, sublane rolls, one exit per
// 128-codeword tile) is not carried over:
//   * one codeword per thread block, one thread per lifted check row
//     (i, z'), dv*Z threads (256 at n=512). The static cyclic routing
//     becomes dc per-thread edge indices v_j = j*Z + (z' - s[i][j]) mod Z
//     computed once;
//   * messages never leave the SM: a check's own dc messages stay in
//     registers across all iterations, and a var-domain copy R[i][v]
//     (dv*n f32 = 8 KB) plus the channel LLRs and posteriors (2 x 2 KB)
//     live in shared memory;
//   * per-codeword early exit: a codeword stops at its first zero syndrome
//     (checked with __syncthreads_or). Each codeword's trajectory is
//     deterministic, so the bits and stats are the TPU's per-tile-exit ones;
//     and because no codeword waits for a tile, the TPU wrapper's two-pass
//     straggler compaction (pass1_iters) has nothing left to remove: the
//     wrapper keeps the argument and this single pass IS its result;
//   * the same sums as the plain version: var->check q = Lt - r, clipped to
//     +-16; posterior Lt = Lc + (((R0 + R1) + R2) + R3) over the base rows in
//     order; min-sum keeps an online (min, second min, first argmin). Built
//     with --fmad=false, the two min-sum rules match the plain version bit
//     for bit; sum-product differs by the libraries' tanh/atanh ulps;
//   * the natural-order permutation is fused: LLRs are read from pipeline
//     order through inv_perm and bits written back the same way; counts mode
//     compares the info columns against the truth in the kernel and writes
//     one count per codeword (no (n, B) bits tensor at all).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMsgClip = 16.0f;
constexpr float kSpClip = 0.9999999f;
constexpr int kDc = 8;  // check degree of every code the presets build

enum Algo { kSumProd = 0, kMinSum = 1, kOffsetMinSum = 2 };

template <int DC>
__global__ void bp_flooding_kernel(
    const float* __restrict__ llr,       // (B, n) pipeline order
    const int* __restrict__ inv_perm,    // (n,) pipeline position of natural v
    const int* __restrict__ shifts,      // (dv, DC) circulant shifts
    const int8_t* __restrict__ truth,    // (B, k) info bits, counts mode
    const int* __restrict__ info_cols,   // (k,) natural column of info bit i
    int8_t* __restrict__ bits,           // (B, n) pipeline order, bits mode
    int* __restrict__ err,               // (B,) info-bit errors, counts mode
    int* __restrict__ iters,             // (B,)
    uint8_t* __restrict__ conv,          // (B,)
    int Z, int dv, int k, int cap, int algo, float scale, float offset) {
  extern __shared__ float smem[];
  const int n = DC * Z;
  float* Lc = smem;            // (n,) channel LLRs, natural order
  float* Lt = Lc + n;          // (n,) posteriors
  float* R = Lt + n;           // (dv, n) check->var messages, var domain
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;  // == dv * Z
  const int b = blockIdx.x;
  const int row = tid / Z;      // base row i
  const int zc = tid % Z;       // lifted index z' of this check

  int vj[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    int z = (zc - shifts[row * DC + j]) % Z;
    vj[j] = j * Z + (z < 0 ? z + Z : z);
  }
  const float* lb = llr + (size_t)b * n;
  for (int v = tid; v < n; v += nthr) {
    float x = lb[inv_perm[v]];
    Lc[v] = x;
    Lt[v] = x;
  }
  float r[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) r[j] = 0.0f;
  __syncthreads();

  auto syndrome_bad = [&]() {
    int par = 0;
#pragma unroll
    for (int j = 0; j < DC; ++j) par ^= (Lt[vj[j]] < 0.0f) ? 1 : 0;
    return __syncthreads_or(par);
  };

  int it = 0;
  bool ok = !syndrome_bad();
  while (!ok && it < cap) {
    // ---- check update from the pre-iteration posteriors ----
    float q[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j)
      q[j] = fminf(fmaxf(Lt[vj[j]] - r[j], -kMsgClip), kMsgClip);
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
    __syncthreads();  // every read of Lt is done
#pragma unroll
    for (int j = 0; j < DC; ++j) R[row * n + vj[j]] = r[j];
    __syncthreads();
    // ---- variable update: posterior in the plain version's order ----
    for (int v = tid; v < n; v += nthr) {
      float s = R[v];
      for (int i = 1; i < dv; ++i) s = s + R[i * n + v];
      Lt[v] = Lc[v] + s;
    }
    __syncthreads();
    ++it;
    ok = !syndrome_bad();
  }

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

template <int DC>
int launch(const float* llr, const int* inv_perm, const int* shifts,
           const int8_t* truth, const int* info_cols, int8_t* bits, int* err,
           int* iters, uint8_t* conv, int B, int Z, int dv, int k, int cap,
           int algo, float scale, float offset, cudaStream_t stream) {
  const int threads = dv * Z;
  const size_t smem = sizeof(float) * (size_t)(2 + dv) * DC * Z;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bp_flooding_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bp_flooding_kernel<DC><<<B, threads, smem, stream>>>(
      llr, inv_perm, shifts, truth, info_cols, bits, err, iters, conv, Z, dv,
      k, cap, algo, scale, offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bp_decode_launch(const float* llr, const int* inv_perm,
                                const int* shifts, const int8_t* truth,
                                const int* info_cols, int8_t* bits, int* err,
                                int* iters, uint8_t* conv, int B, int Z,
                                int dv, int dc, int k, int cap, int algo,
                                float scale, float offset, void* stream) {
  if (B <= 0) return 0;
  if (dv * Z > 1024 || dv * Z <= 0) return (int)cudaErrorInvalidValue;
  if (dc != kDc) return (int)cudaErrorInvalidValue;
  return launch<kDc>(llr, inv_perm, shifts, truth, info_cols, bits, err,
                     iters, conv, B, Z, dv, k, cap, algo, scale, offset,
                     reinterpret_cast<cudaStream_t>(stream));
}
