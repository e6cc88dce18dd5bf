// Teacher-forced ESN state harvest (the fit's recurrence), Hopper, fp32 (K3).
//
// Replaces the TPU kernel esn_ofdm_mimo_tpu/models/esn_pallas.py:
// _states_kernel (launched by esn_states_pallas). For every batch row it runs
//     s_t = tanh(Wt^T s_{t-1} + W_in^T u_t + W_fb^T d_{t-1})
//           + noise * (U - 0.5),        t = 1 .. T-1,  s_0 = 0
// and writes all T states to (B, T, n_res). The drive [u_t; d_{t-1}] is
// known in advance (teacher forcing): there is no readout in the loop. The
// plain version it is held against is esn_ofdm_mimo_tpu_torch/models/esn.py
// (esn_states).
//
// What bounds it on the H100. At the mimo_4x8_nbf fit shape (128 rows,
// T = 522, n_res = 600, n_in = 16, n_out = 8) the work is 2 * 128 * 521 *
// 600 * 624 = 5.0e10 fp32 operations (0.75 ms at 67 TFLOP/s) and the bytes
// are the 160 MB of states written (0.05 ms): bound by arithmetic. But the
// recurrence is sequential in t and a fit batch is small, so the card cannot
// be filled. What sets the time is how fast each of the few busy SMs streams
// the stacked weight (1.6 MB at n_res = 600, more than a block's shared
// memory) from L2 at every step, and how well it hides L2's latency.
//
// Design (simple first; a cluster design that splits one row tile's neurons
// over several SMs and exchanges the state through distributed shared
// memory, so that each SM keeps its slice of the weight on chip, is later
// work):
//   * a block owns kRows = 4 rows for all T steps (one launch): 32 blocks at
//     a 128-row fit. Its operand X = [s; u_t; d_{t-1}] (K_pad x 4 f32, 10 KB
//     at n_res = 600) stays in shared memory. 4-row blocks ran faster than
//     8-row blocks on an H100: each SM streams the same weight per step
//     either way, so more SMs win;
//   * each thread owns two neighbouring neuron columns for all 4 rows (8
//     accumulators): n_p / 2 threads, n_p = n_res rounded up to 64 (320
//     threads, 10 warps, at n_res = 600). The stacked weight Wc = [Wt;
//     W_in_t; W_fb_t] (K_pad x n_p, zero padded) is read straight from L2
//     into registers as float2, each element once per block and step,
//     coalesced; the 4 row values come from shared memory as one float4
//     broadcast. A weight element feeds 4 multiply-adds and is never staged
//     through shared memory;
//   * L2 latency is hidden by a register double buffer: the next kKu rows of
//     Wc are in flight while the current kKu rows are multiplied, and the
//     last chunk of a step prefetches the first chunk of the next step (the
//     weight is the same at every step);
//   * state noise is Philox-4x32-10 (curand_kernel.h), one subsequence per
//     thread, seeded by the wrapper, added only to real neurons;
//   * fp32 with fused multiply-adds throughout (no TF32, no bf16): the sums
//     differ from the plain version's matmuls by rounding only.

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;        // batch rows per block
constexpr int kCols = 64;       // n_p granularity (two columns a thread)
constexpr int kKu = 8;          // contraction rows per register buffer
constexpr int kMaxThreads = 320;  // n_p <= 640

__device__ __forceinline__ void load_chunk(float2 (&w)[kKu],
                                           const float2* __restrict__ wc2,
                                           int k0, int n_p2, int tid) {
#pragma unroll
  for (int kk = 0; kk < kKu; ++kk) w[kk] = __ldg(wc2 + (size_t)(k0 + kk) * n_p2 + tid);
}

__device__ __forceinline__ void fma_chunk(float (&acc)[2][kRows],
                                          const float2 (&w)[kKu],
                                          const float* X, int k0) {
#pragma unroll
  for (int kk = 0; kk < kKu; ++kk) {
    const float4 x4 = *reinterpret_cast<const float4*>(&X[(k0 + kk) * kRows]);
    const float xv[kRows] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc[0][r] = fmaf(w[kk].x, xv[r], acc[0][r]);
      acc[1][r] = fmaf(w[kk].y, xv[r], acc[1][r]);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
esn_states_kernel(const float* __restrict__ u,    // (B, T, n_in) scaled
                  const float* __restrict__ d,    // (B, T, n_out) scaled teachers
                  const float* __restrict__ wc,   // (K_pad, n_p)
                  float* __restrict__ out,        // (B, T, n_res)
                  int B, int T, int n_res, int n_in, int n_out, int K_pad,
                  int n_p, float noise, unsigned long long seed) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // (K_pad, kRows)

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;                 // n_p / 2
  const int row0 = blockIdx.x * kRows;
  const int nz = n_in + n_out;
  const int n_p2 = n_p / 2;
  const float2* wc2 = reinterpret_cast<const float2*>(wc);

  curandStatePhilox4_32_10_t rng;
  if (noise != 0.0f)
    curand_init(seed, (unsigned long long)blockIdx.x * nthr + tid, 0, &rng);

  for (int i = tid; i < K_pad * kRows; i += nthr) X[i] = 0.0f;
  for (int r = 0; r < kRows; ++r) {  // s_0 = 0
    const int row = row0 + r;
    if (row < B)
      for (int j = tid; j < n_res; j += nthr) out[(size_t)row * T * n_res + j] = 0.0f;
  }
  __syncthreads();  // X is zero before any drive is written into it

  float2 wa[kKu], wb[kKu];
  load_chunk(wa, wc2, 0, n_p2, tid);

  for (int t = 1; t < T; ++t) {
    // ---- drive z = [u_t; d_{t-1}] into X rows n_res .. n_res + nz ----
    for (int i = tid; i < kRows * nz; i += nthr) {
      const int r = i % kRows, f = i / kRows;
      const int row = row0 + r;
      float v = 0.0f;
      if (row < B)
        v = f < n_in ? u[((size_t)row * T + t) * n_in + f]
                     : d[((size_t)row * T + t - 1) * n_out + (f - n_in)];
      X[(n_res + f) * kRows + r] = v;
    }
    __syncthreads();

    // ---- pre = Wc^T X over K_pad rows, two register buffers in turn ----
    float acc[2][kRows];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[c][r] = 0.0f;
    for (int k0 = 0; k0 < K_pad; k0 += 2 * kKu) {  // K_pad % (2 * kKu) == 0
      load_chunk(wb, wc2, k0 + kKu, n_p2, tid);
      fma_chunk(acc, wa, X, k0);
      // the last chunk of the step prefetches the next step's first
      load_chunk(wa, wc2, k0 + 2 * kKu < K_pad ? k0 + 2 * kKu : 0, n_p2, tid);
      fma_chunk(acc, wb, X, k0 + kKu);
    }
    __syncthreads();  // every read of s_{t-1} and z is done

    // ---- s_t = tanh(pre) + noise: over the state rows of X, and out ----
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 2 * tid + c;
      if (j < n_res) {
        float v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = tanhf(acc[c][r]);
        if (noise != 0.0f) {
          const float4 z = curand_uniform4(&rng);
          v[0] += noise * (z.x - 0.5f);
          v[1] += noise * (z.y - 0.5f);
          v[2] += noise * (z.z - 0.5f);
          v[3] += noise * (z.w - 0.5f);
        }
        *reinterpret_cast<float4*>(&X[j * kRows]) = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (row0 + r < B) out[((size_t)(row0 + r) * T + t) * n_res + j] = v[r];
      }
    }
    // the next step's z load writes other rows of X; its barrier orders
    // these state writes before the next product
  }
}

}  // namespace

// Contraction rows of the stacked weight: n_res + n_in + n_out rounded up
// to the double buffer's 2 * kKu.
extern "C" int esn_states_k_pad(int n_res, int n_in, int n_out) {
  return (n_res + n_in + n_out + 2 * kKu - 1) / (2 * kKu) * (2 * kKu);
}

// Neuron columns of the stacked weight: n_res rounded up to kCols.
extern "C" int esn_states_n_p(int n_res) {
  return (n_res + kCols - 1) / kCols * kCols;
}

extern "C" int esn_states_launch(const float* u, const float* d, const float* wc,
                                 float* out, int B, int T, int n_res, int n_in,
                                 int n_out, float noise, unsigned long long seed,
                                 void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const int K_pad = esn_states_k_pad(n_res, n_in, n_out);
  const int n_p = esn_states_n_p(n_res);
  if (n_p / 2 > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)K_pad * kRows;  // < 48 KB
  const int blocks = (B + kRows - 1) / kRows;
  esn_states_kernel<<<blocks, n_p / 2, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      u, d, wc, out, B, T, n_res, n_in, n_out, K_pad, n_p, noise, seed);
  return (int)cudaGetLastError();
}
