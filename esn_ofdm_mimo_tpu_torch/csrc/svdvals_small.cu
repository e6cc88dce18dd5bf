// Singular values of small batched complex matrices, Hopper, fp32.
//
// A port kernel with no Pallas counterpart: the JAX package computes these
// values in plain jnp, esn_ofdm_mimo_tpu/ops/linalg_mxu.py:svdvals_small
// (:207; cyclic Jacobi on the real-embedded Gram, `_jacobi_sweeps_sym`
// :171), because its TPU backend had no complex SVD. Here it replaces a
// library SVD (torch.linalg.svdvals) that reads its convergence info on the
// host, which a CUDA graph cannot hold. For every matrix H (n_r x NT,
// complex64, NT in {1, 2, 4}, n_r <= 8):
//   He = [[Hr, -Hi], [Hi, Hr]]  (2 n_r x 2 NT),  G = He^T He  (N = 2 NT)
//   `sweeps` cyclic sweeps over the pairs (p, q), p < q, in JAX's order:
//     tau = (a_qq - a_pp) / (2 a_pq),  t = sign(tau) / (|tau| + sqrt(1 +
//     tau^2)),  no rotation where |a_pq| <= 1e-30 or tau == 0 (JAX's sign
//     is 0 there),  c = 1 / sqrt(1 + t^2),  s = t c;
//     rows p, q of G, then columns p, q (J^T G J, J = I but J_pp = J_qq =
//     c, J_pq = s, J_qp = -s);
//   the diagonal sorted descending; every second value (the eigenvalues of
//   the embedding come in pairs), sqrt(max(., 0)) -> S (NT values).
// The plain version it is held against is esn_ofdm_mimo_tpu_torch/ops/
// analytics.py:svdvals_small_plain, which does each step as one elementwise
// operation in the same order; built with --fmad=false (utils/build.py), the
// kernel repeats its roundings, and correctly rounded sqrt and division (no
// fast-math intrinsics) give the same values bit for bit.
//
// What bounds it on the H100. At the mimo_4x8_nbf analytics shape (65,536
// matrices of 8 x 4) it reads 16.8 MB and writes 1 MB (~5 us at 3.35 TB/s).
// The work the function needs: the Gram's 36 distinct entries (it is
// symmetric; 16 products and sums each) and 8 x 28 rotations of ~72
// operations each (the angle, the two rows outside the (p, q) block once,
// since the columns mirror them, the 2 x 2 block both ways): ~17.3k fp32
// operations a matrix, 1.1 GFLOP (~17 us at 67 TFLOP/s). Each rotation has
// two square roots and three divisions on the special-function unit, 73 M
// in all (~17.5 us at a sixteenth of the fp32 rate), which bound it. This
// kernel does more than that: the full N x N Gram and both sides of every
// rotation, ~26k operations a matrix, as the plain version does.
//
// Design: one thread a matrix, the whole N x N Gram in registers (64 floats
// at NT = 4; every index is a compile-time constant after unrolling, so
// nothing spills to local memory), the pair loops unrolled inside a sweep
// loop, a sorting network for the descending sort. The rotations of a
// matrix form one dependent chain, so a thread waits on its own latency;
// 65,536 threads are ~16 warps an SM, enough to cover the division and
// square-root latency only in part. Simple first: the time is far below
// the library call's either way.
#include <cuda_runtime.h>

namespace {

template <int NT>
__global__ void __launch_bounds__(128)
svdvals_small_kernel(const float2* __restrict__ H, float* __restrict__ S,
                     long long batch, int nr, int sweeps) {
  constexpr int N = 2 * NT;
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const float2* h = H + b * nr * NT;

  // G = He^T He as a left fold over He's rows: the top rows [Hr, -Hi]
  // first, then the bottom rows [Hi, Hr]
  float g[N][N];
  float e[N];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 v = h[j];
    e[j] = v.x;
    e[NT + j] = -v.y;
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k < N; ++k) g[j][k] = e[j] * e[k];
  for (int r = 1; r < 2 * nr; ++r) {
    const int i = r < nr ? r : r - nr;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 v = h[i * NT + j];
      e[j] = r < nr ? v.x : v.y;
      e[NT + j] = r < nr ? -v.y : v.x;
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int k = 0; k < N; ++k) g[j][k] = g[j][k] + e[j] * e[k];
  }

  for (int sw = 0; sw < sweeps; ++sw) {
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const float app = g[p][p], aqq = g[q][q], apq = g[p][q];
        const bool big = fabsf(apq) > 1e-30f;
        const float den = big ? apq : 1e-30f;
        const float tau = (aqq - app) / (2.0f * den);
        const float sg = tau > 0.0f ? 1.0f : (tau < 0.0f ? -1.0f : 0.0f);
        float t = sg / (fabsf(tau) + sqrtf(1.0f + tau * tau));
        t = big ? t : 0.0f;
        const float c = 1.0f / sqrtf(1.0f + t * t);
        const float s = t * c;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float gp = g[p][k], gq = g[q][k];
          g[p][k] = c * gp - s * gq;
          g[q][k] = s * gp + c * gq;
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float gp = g[k][p], gq = g[k][q];
          g[k][p] = gp * c - gq * s;
          g[k][q] = gp * s + gq * c;
        }
      }
    }
  }

  // descending sort of the diagonal: odd-even transposition, N rounds
  float ev[N];
#pragma unroll
  for (int j = 0; j < N; ++j) ev[j] = g[j][j];
#pragma unroll
  for (int round = 0; round < N; ++round) {
#pragma unroll
    for (int j = round & 1; j + 1 < N; j += 2) {
      const float hi = fmaxf(ev[j], ev[j + 1]);
      const float lo = fminf(ev[j], ev[j + 1]);
      ev[j] = hi;
      ev[j + 1] = lo;
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) S[b * NT + j] = sqrtf(fmaxf(ev[2 * j], 0.0f));
}

template <int NT>
int launch(const float2* H, float* S, long long batch, int nr, int sweeps,
           cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (batch + threads - 1) / threads;
  svdvals_small_kernel<NT><<<(unsigned)blocks, threads, 0, stream>>>(
      H, S, batch, nr, sweeps);
  return (int)cudaGetLastError();
}

}  // namespace

// H: batch x nr x nt complex64 (interleaved re, im), S: batch x nt float32.
// Returns a CUDA error code (cudaErrorInvalidValue for a shape the kernel is
// not built for).
extern "C" int svdvals_small_launch(const void* H, void* S, long long batch,
                                    int nr, int nt, int sweeps,
                                    void* stream) {
  if (batch <= 0) return 0;
  if (nr < 1 || nr > 8 || sweeps < 0) return (int)cudaErrorInvalidValue;
  const float2* h = static_cast<const float2*>(H);
  float* s = static_cast<float*>(S);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (nt) {
    case 1: return launch<1>(h, s, batch, nr, sweeps, st);
    case 2: return launch<2>(h, s, batch, nr, sweeps, st);
    case 4: return launch<4>(h, s, batch, nr, sweeps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
