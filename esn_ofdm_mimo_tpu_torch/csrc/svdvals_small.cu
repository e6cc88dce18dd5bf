// Singular values of small batched complex matrices, Hopper, fp32.
//
// A port kernel with no Pallas counterpart: the JAX package computes these
// values in plain jnp, esn_ofdm_mimo_tpu/ops/linalg_mxu.py:svdvals_small
// (:207; cyclic Jacobi on the real-embedded Gram, `_jacobi_sweeps_sym`
// :171), because its TPU backend had no complex SVD. Here it replaces a
// library SVD (torch.linalg.svdvals) that reads its convergence info on the
// host, which a CUDA graph cannot hold.
//
// The function: Hermitian Jacobi on G = H^H H. For every matrix H (n_r x NT,
// complex64, NT in {1, 2, 4}, n_r <= 8), with G's upper triangle kept as
// real and imaginary parts (the diagonal real):
//   G_jk = sum_i (hr_ij hr_ik + hi_ij hi_ik) + i (hr_ij hi_ik - hi_ij hr_ik),
//     j <= k, a left fold over the rows i;
//   `sweeps` cyclic sweeps over the pairs (p, q), p < q, in JAX's order:
//     m = sqrt(ar ar + ai ai) of a_pq, m_d = m where m > 1e-30 else 1e-30,
//     e = a_pq / m_d, tau = (a_qq - a_pp) / (2 m_d),
//     t = sign(tau) / (|tau| + sqrt(1 + tau^2)), 0 where m <= 1e-30,
//     c = 1 / sqrt(1 + t^2), s = t c;
//     for every other r: G_rp <- G_rp c - (G_rq conj(e)) s,
//                        G_rq <- (G_rp e) s + G_rq c
//     (G_rp read and written as conj(G_pr) where r > p);
//     a_pp <- a_pp - t m, a_qq <- a_qq + t m, a_pq <- 0 where t != 0 (where
//     t == 0 nothing changes: JAX's rotation is the identity there);
//   the diagonal sorted descending, sqrt(max(., 0)) -> S (NT values).
// The rotation is the real 2 x 2 Jacobi rotation of diag(1, conj(e))^H G
// diag(1, conj(e)), whose (p, q) entry is the real m, turned back by the
// same phase. It does to G what the JAX algorithm's rotations of the pairs
// (p, q) and (p + NT, q + NT) of the real embedding do together, whose
// eigenvalues are G's twice: the same values to float32 rounding (the CPU
// tests hold the plain version to JAX's, ranks and the condition histogram
// equal at a round's scale) with NT (NT - 1) / 2 rotations a sweep in place
// of NT (2 NT - 1): 6 in place of 28 at NT = 4, 1 in place of 6 at NT = 2.
//
// Bit identity. The plain version, esn_ofdm_mimo_tpu_torch/ops/analytics.py
// :svdvals_small_plain, does each step above as one float32 elementwise
// operation in this order (no complex multiply, whose order is torch's).
// This source repeats it: built with --fmad=false (utils/build.py), with
// correctly rounded division and sqrtf (no --use_fast_math, __fdividef,
// rsqrtf, hypotf or reciprocal-then-multiply), so the card gives the plain
// version's bits.
//
// What bounds it on the H100. At the mimo_4x8_nbf analytics shape (65,536
// matrices of 8 x 4) it reads 16.8 MB and writes 1 MB: 5.3 us at 3.35
// TB/s, which bounds it. A matrix needs 496 fp32 operations for the Gram,
// 3 for each of its 48 pair tests and, for each rotation that runs (t !=
// 0; ~24 of the 48 on a round's channels, as matrices converge), 59 more
// and 8 divisions and square roots: ~3 us of special-function work at a
// sixteenth of the fp32 rate. Each of those is several dependent
// instructions around one MUFU operation, so what the kernel meets is
// their latency and the instruction issue, not the SFU's rate.
//
// Design: one thread a matrix, its Gram in registers (16 floats at NT = 4;
// n_r and NT are template arguments, so every index is a compile-time
// constant after unrolling and nothing goes to local memory). A block of
// 128 threads first stages its matrices' contiguous span into shared
// memory with coalesced 16-byte loads, all of a thread's in flight at
// once, at an odd stride of float2 slots a matrix, so each thread's 8-byte
// reads of its own matrix hit 16 distinct bank pairs in a half-warp. The
// rotations of a matrix are one dependent chain of divisions and square
// roots; the 512 blocks of 65,536 matrices are all resident at once (~4
// an SM), and the schedulers interleave their chains. Where t == 0 the
// function leaves G as it is, so the kernel branches round the rotation
// there: a converged matrix's off-diagonal runs down to exactly 0 (each
// update mixes only off-diagonal entries), and its later sweeps cost a
// few instructions a pair in place of the divisions and square roots,
// whose slow paths (denormal and overflowing operands) they would take.
// A sorting network sorts the diagonal, and a thread writes its NT values
// with one store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void exchange_descending(float& a, float& b) {
  const float hi = fmaxf(a, b), lo = fminf(a, b);
  a = hi;
  b = lo;
}

// sqrt(max(., 0)) of the diagonal sorted descending, one store of NT floats
template <int NT>
__device__ __forceinline__ void store_sorted(float* out, const float (&d)[NT]) {
  float v[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) v[j] = d[j];
  if constexpr (NT == 4) {      // a sorting network of 5 exchanges
    exchange_descending(v[0], v[1]);
    exchange_descending(v[2], v[3]);
    exchange_descending(v[0], v[2]);
    exchange_descending(v[1], v[3]);
    exchange_descending(v[1], v[2]);
  } else if constexpr (NT == 2) {
    exchange_descending(v[0], v[1]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) v[j] = sqrtf(fmaxf(v[j], 0.0f));
  if constexpr (NT == 4) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (NT == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
  } else {
    out[0] = v[0];
  }
}

template <int NR, int NT>
__global__ void __launch_bounds__(kThreads)
svdvals_small_kernel(const float2* __restrict__ H, float* __restrict__ S,
                     long long batch, int sweeps) {
  constexpr int E = NR * NT;          // complex entries a matrix
  constexpr int STRIDE = E | 1;       // float2 slots a matrix, odd
  __shared__ float2 sh[kThreads * STRIDE];

  // stage the block's matrices: one contiguous span of count * E float2
  const long long first = (long long)blockIdx.x * kThreads;
  const int count = batch - first < kThreads ? (int)(batch - first)
                                             : kThreads;
  const float2* src = H + first * E;
  if (count == kThreads && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // a full block: 16-byte loads, all of a thread's in flight at once
    constexpr int kF4 = kThreads * E / 2;
    constexpr int kIters = (kF4 + kThreads - 1) / kThreads;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4 v[kIters];
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int k = threadIdx.x + i * kThreads;
      if (k < kF4) v[i] = __ldg(src4 + k);
    }
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int k = threadIdx.x + i * kThreads;
      if (k < kF4) {
        const int f = 2 * k, m0 = f / E, m1 = (f + 1) / E;
        sh[m0 * STRIDE + f - m0 * E] = make_float2(v[i].x, v[i].y);
        sh[m1 * STRIDE + f + 1 - m1 * E] = make_float2(v[i].z, v[i].w);
      }
    }
  } else {
    // the last, partial block (or a span that is not 16-byte aligned)
    for (int f = threadIdx.x; f < count * E; f += kThreads) {
      const int m = f / E;
      sh[m * STRIDE + f - m * E] = __ldg(src + f);
    }
  }
  __syncthreads();
  if ((int)threadIdx.x >= count) return;
  const float2* h = sh + threadIdx.x * STRIDE;

  // the Gram's upper triangle, a left fold over the rows
  float d[NT], ur[NT][NT], ui[NT][NT];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float2 row[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) row[j] = h[i * NT + j];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float a = row[j].x, b = row[j].y;
      const float term = a * a + b * b;
      d[j] = i == 0 ? term : d[j] + term;
#pragma unroll
      for (int k = j + 1; k < NT; ++k) {
        const float c = row[k].x, e = row[k].y;
        const float tr = a * c + b * e, ti = a * e - b * c;
        ur[j][k] = i == 0 ? tr : ur[j][k] + tr;
        ui[j][k] = i == 0 ? ti : ui[j][k] + ti;
      }
    }
  }

#pragma unroll 1
  for (int sw = 0; sw < sweeps; ++sw) {
#pragma unroll
    for (int p = 0; p < NT - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < NT; ++q) {
        const float ar = ur[p][q], ai = ui[p][q];
        const float m2 = ar * ar + ai * ai;
        // No rotation runs where t == 0, and G stays as it is: where m <=
        // 1e-30, which holds exactly where m2 == 0 (the least positive
        // float's square root is ~3.7e-23; NaN fails both tests), and where
        // tau == 0 or tau^2 overflows (t = 0 / ... or 1 / inf). Late sweeps
        // of a converged matrix, whose off-diagonal has run down to 0, skip
        // every division and square root.
        if (!(m2 > 0.0f)) continue;
        const float m = sqrtf(m2);
        const float tau = (d[q] - d[p]) / (2.0f * m);
        const float tt = tau * tau;
        if (tau == 0.0f || isinf(tt)) continue;
        const float er = ar / m, ei = ai / m;
        const float sg = tau > 0.0f ? 1.0f : (tau < 0.0f ? -1.0f : 0.0f);
        const float t = sg / (fabsf(tau) + sqrtf(1.0f + tt));
        const float c = 1.0f / sqrtf(1.0f + t * t);
        const float s = t * c;
#pragma unroll
        for (int r = 0; r < NT; ++r) {
          if (r == p || r == q) continue;
          const float xr = r < p ? ur[r][p] : ur[p][r];
          const float xi = r < p ? ui[r][p] : -ui[p][r];
          const float yr = r < q ? ur[r][q] : ur[q][r];
          const float yi = r < q ? ui[r][q] : -ui[q][r];
          const float ye_r = yr * er + yi * ei, ye_i = yi * er - yr * ei;
          const float xe_r = xr * er - xi * ei, xe_i = xr * ei + xi * er;
          const float nxr = xr * c - ye_r * s, nxi = xi * c - ye_i * s;
          const float nyr = xe_r * s + yr * c, nyi = xe_i * s + yi * c;
          if (r < p) {
            ur[r][p] = nxr;
            ui[r][p] = nxi;
          } else {
            ur[p][r] = nxr;
            ui[p][r] = -nxi;
          }
          if (r < q) {
            ur[r][q] = nyr;
            ui[r][q] = nyi;
          } else {
            ur[q][r] = nyr;
            ui[q][r] = -nyi;
          }
        }
        const float tm = t * m;
        d[p] = d[p] - tm;
        d[q] = d[q] + tm;
        ur[p][q] = 0.0f;
        ui[p][q] = 0.0f;
      }
    }
  }

  store_sorted<NT>(S + (first + threadIdx.x) * NT, d);
}

template <int NR, int NT>
int launch(const float2* H, float* S, long long batch, int sweeps,
           cudaStream_t stream) {
  const long long blocks = (batch + kThreads - 1) / kThreads;
  svdvals_small_kernel<NR, NT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      H, S, batch, sweeps);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_nr(const float2* H, float* S, long long batch, int nr, int sweeps,
              cudaStream_t st) {
  switch (nr) {
    case 1: return launch<1, NT>(H, S, batch, sweeps, st);
    case 2: return launch<2, NT>(H, S, batch, sweeps, st);
    case 3: return launch<3, NT>(H, S, batch, sweeps, st);
    case 4: return launch<4, NT>(H, S, batch, sweeps, st);
    case 5: return launch<5, NT>(H, S, batch, sweeps, st);
    case 6: return launch<6, NT>(H, S, batch, sweeps, st);
    case 7: return launch<7, NT>(H, S, batch, sweeps, st);
    case 8: return launch<8, NT>(H, S, batch, sweeps, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
    case 1: return launch_nr<1>(h, s, batch, nr, sweeps, st);
    case 2: return launch_nr<2>(h, s, batch, nr, sweeps, st);
    case 4: return launch_nr<4>(h, s, batch, nr, sweeps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
