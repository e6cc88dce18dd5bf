// The fused ESN predict recurrence shared by esn_predict.cu (K2, per-row
// readout from L2), esn_predict_grouped.cu (K4, readout slots staged in shared
// memory) and esn_predict_ablate.cu (K5, builds with parts switched off). The
// design note is at the head of esn_predict.cu; this header holds the one
// kernel all three instantiate, templated on the reservoir width, the tile
// height, the readout, a mask of parts switched OFF (0 for K2 and K4,
// where every switch folds away at compile time) and the precision of the
// recurrence product (K2's TF32 build; fp32 everywhere else).
//
// For every batch row it runs all T steps of
//     s' = tanh(W s + [W_in | W_fb] [u_t; o]) + noise * (U - 0.5)
//     o' = sum_f Wout[g, f, :] * [s'; u_t][f],   g = row / Dg
// from s = s0[row], o = o0[row] (zero where the pointers are null: pyESN's
// continuation=False), and writes o / teacher_scaling for t >= n_forget.
//
// Shared memory of a block (W = 4 or 8 warps, `rows` <= kH batch rows for
// all T steps):
//   S    (n_res8, kH)      the state, neuron-major, rows contiguous
//   IO   2 x (n_io8, kH)   [u_t; o] of the even and the odd steps: step t
//                          reads IO[t & 1], u_{t+1} is copied and o_{t+1}
//                          written into IO[(t + 1) & 1] meanwhile
//   ring W x kStages x (kKc, n_p / W)  chunks of the stacked weight in
//                          flight, each warp its own columns
//   RED  (W, 8, kH)        partial readout sums
//   WO   K4 only: P readout slots
// n_res8 = n_res rounded up to kKc, n_io8 = n_in + n_out rounded up to kKc,
// so a chunk of the weight never straddles S and IO. The weight is
// Wc = [Wt; 0; W_in_t; W_fb_t; 0] of shape (n_res8 + n_io8, n_p).
//
// The TF32 build (kTf32, K2 only) multiplies the state rows of Wc on the
// tensor cores (mma m16n8k8, TF32 operands, fp32 accumulation): the
// wrapper rounds Wt to TF32, and S holds the state rounded to TF32 from
// the end of each step's readout, which reads it in fp32, to the next
// step's product. The [u; o] rows stay fp32 multiply-adds into the same
// accumulators. A warp streams the same columns as in the fp32 build; its
// ring rows are padded by 8 floats where that keeps the B-fragment loads
// free of bank conflicts (`ring_pad`).

#pragma once

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

namespace esn_predict {

constexpr int kTy = 32;          // threads along neurons, 2 NJ4 neurons each
constexpr int kKc = 8;           // Wc rows per chunk
constexpr int kStages = 4;       // chunks in a warp's ring
constexpr int kOutTile = 8;      // readout columns per pass
constexpr int kSlotPad = 8;      // floats between staged readout slots (banks)
constexpr int kSmemMax = 232448; // bytes of shared memory a block may take
constexpr size_t kSmemSm = 233472;  // bytes of shared memory of an SM

// Parts of the recurrence an ablation build leaves out (kOff mask bits), with
// the micro-benchmark's meaning of each: no readout -> o = s'[:n_out]; no
// feedback -> the W_fb o term dropped; no noise; no tanh -> s' = 0.5 * pre;
// no recurrence product -> pre = s + W_in u (+ W_fb o). The wrapper zeroes
// the weight rows of a dropped term; whole chunks of them are skipped.
enum Off {
  kNoReadout = 1,
  kNoFeedback = 2,
  kNoNoise = 4,
  kNoTanh = 8,
  kNoRecDot = 16,
};

// The state-noise seed of the next launch of this library. The launcher
// copies it here from the device memory its caller names, on the launch's
// stream, so a captured CUDA graph seeds each replay from a buffer, and the
// kernel reads it as a constant: a seed loaded into registers costs the
// flagship build 16 registers and ~1% of its time (ptxas; PERF.md).
// The slot is stream-ordered: the launches of one library must not run on
// two streams at once.
__constant__ unsigned long long c_seed;

inline __host__ __device__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

inline int k_pad(int n_res, int n_in, int n_out) {
  return round_up(n_res, kKc) + round_up(n_in + n_out, kKc);
}

// Readout slots a block of `rows` consecutive rows over runs of Dg rows can
// touch: the JAX package's P = BC // Dg + 2 at this launch's rows a block.
inline int grouped_slots(int G, int Dg, int rows) {
  const int p = rows / Dg + 2;
  return p < G ? p : G;
}

// Threads of a block: 128 (4 threads along rows) where 256 would leave a
// thread 64 accumulators or fewer, so that a small tile keeps a register
// tile worth its shared-memory loads; else 256 (8 along rows). The TF32
// build always takes 256: eight warps a block hide each other's fragment
// loads and MMA latency, and a warp's share of the columns fits registers.
__host__ __device__ constexpr int threads_of(int NJ4, int kH, bool tf32 = false) {
  return !tf32 && kH * NJ4 / 4 <= 64 ? 128 : 256;
}

// Blocks an SM the registers allow: two of 128 threads, one of 256.
__host__ __device__ constexpr int min_blocks(int NJ4, int kH, bool tf32 = false) {
  return threads_of(NJ4, kH, tf32) == 128 ? 2 : 1;
}

// Reservoir widths (ceil(n_res / 64)) with a TF32 build: those of the
// presets and the reservoir sweep (n_res 100, 200, 300, 450, 600). At one
// 64-neuron group (the sweep's n_res 50) the fp32 build measured faster
// (PERF.md). The wrapper asks esn_predict_has_tf32.
__host__ __device__ constexpr bool tf32_width(int NJ4) {
  return NJ4 == 2 || NJ4 == 4 || NJ4 == 5 || NJ4 == 8 || NJ4 == 10;
}

// Floats of padding after each ring row of a warp in the TF32 build: a
// warp's row of kRowW = n_p / (threads / 32) floats is read by lanes
// (k = tig, n = gid) at k * stride + n, free of bank conflicts only where
// stride / 8 is odd.
__host__ __device__ constexpr int ring_pad(int NJ4, int kH, bool tf32) {
  return tf32 && (NJ4 * 64 / (threads_of(NJ4, kH, tf32) / 32) / 8) % 2 == 0 ? 8 : 0;
}

// Shared memory of one block in bytes; P = 0 for K2 and K5.
inline size_t smem_bytes(int n_res, int n_in, int n_out, int height, int P,
                         bool tf32 = false) {
  const int n_p = round_up(n_res, 64);
  const int kWarps = threads_of(n_p / 64, height, tf32) / 32;
  size_t floats = (size_t)(round_up(n_res, kKc) + 2 * round_up(n_in + n_out, kKc)) * height
                  + (size_t)kStages * kKc * (n_p + kWarps * ring_pad(n_p / 64, height, tf32))
                  + (size_t)kWarps * kOutTile * height
                  + (size_t)P * ((n_res + n_in) * n_out + kSlotPad);
  return sizeof(float) * floats;
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// models/esn.py:round_tf32 is its plain version.
__device__ __forceinline__ float tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d += a b on the tensor cores: a 16 x 8 (rows x k) and b 8 x 8 (k x
// neurons) TF32, d 16 x 8 fp32. Lane 4 gid + tig holds a (gid, tig),
// (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4); b (tig, gid),
// (tig + 4, gid); d (gid, 2 tig), (gid, 2 tig + 1), (gid + 8, 2 tig),
// (gid + 8, 2 tig + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Thread (tx, ty) of kTx x 32 owns RT = kH / kTx rows and NT = 2 * NJ4
// neurons. Rows: a slabs of 4 kTx rows in which it takes 4 consecutive ones
// (one 16-byte load), then b rows of the last slab, RT = 4 a + b. Neurons:
// groups of 128 with 4 consecutive ones where NJ4 is even, groups of 64 with
// 2 otherwise. A warp is kTx x (32 / kTx) threads: all the tile's rows, and
// a slice of the neurons that no other warp touches.
template <int NJ4, int kH, bool kGrouped, int kOff = 0, bool kTf32 = false>
__global__ void __launch_bounds__(threads_of(NJ4, kH, kTf32), min_blocks(NJ4, kH, kTf32))
predict_kernel(const float* __restrict__ u_fm,  // (T, n_in, B) scaled
               const float* __restrict__ wc,    // (K_pad, n_p)
               const float* __restrict__ wout,  // (G, n_res + n_in, n_out)
               float* __restrict__ out,         // (B, T - n_forget, n_out)
               const float* __restrict__ s0,    // (B, n_res) or null
               const float* __restrict__ o0,    // (B, n_out) or null
               int B, int T, int n_res, int n_in, int n_out, int Dg,
               int n_forget, int rows, int P, float noise,
               float teacher_scaling) {
  constexpr int n_p = NJ4 * 64;
  constexpr int kThreads = threads_of(NJ4, kH, kTf32), kWarps = kThreads / 32;
  constexpr int kTx = kThreads / kTy;  // threads along rows
  constexpr int kSlab = 4 * kTx;      // rows of a slab
  constexpr int RT = kH / kTx, RA = RT / 4, RB = RT % 4;
  constexpr int NT = n_p / kTy;
  constexpr int NW = NJ4 % 2 == 0 ? 4 : 2;  // consecutive neurons of one load
  constexpr int NM = NT / NW;         // neuron groups
  constexpr int kSeg = 32 / kTx * NW; // a warp's consecutive columns of a group
  constexpr int kRowW = NM * kSeg;    // a warp's columns of one Wc row
  constexpr int kRowS = kRowW + ring_pad(NJ4, kH, kTf32);  // ring row stride
  constexpr int kChunkS = kKc * kRowS;  // floats of a warp's ring slot
  static_assert((kTf32 || (kH % kTx == 0 && kH % 4 == 0)) && n_p % (kTy * NW) == 0 && kSeg % 4 == 0,
                "tile");
  // TF32 build: MT m16 tiles over the rows, NTW n8 tiles over the warp's
  // columns (8 consecutive neurons each: kSeg is a multiple of 8)
  constexpr int MT = (kH + 15) / 16, NTW = kRowW / 8;
  static_assert(!kTf32 || (kOff == 0 && !kGrouped && kKc == 8 && kSeg % 8 == 0), "tf32");

  const int n_res8 = round_up(n_res, kKc);
  const int n_io8 = round_up(n_in + n_out, kKc);
  const int F = n_res + n_in;
  const int Tout = T - n_forget;

  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);     // (n_res8, kH)
  float* IO = S + (size_t)n_res8 * kH;            // 2 x (n_io8, kH)
  float* ring = IO + 2 * (size_t)n_io8 * kH;      // kWarps x kStages x (kKc, kRowS)
  float* RED = ring + kWarps * kStages * kChunkS; // (kWarps, kOutTile, kH)
  float* WO = RED + kWarps * kOutTile * kH;       // K4 only: (P, slot)

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;  // the TF32 build's MMA lanes
  const int row0 = blockIdx.x * rows;
  const int n_valid = min(rows, B - row0);        // real rows of this block
  const int slot = F * n_out + kSlotPad;
  const int g0 = row0 / Dg;          // K4: the group of the block's first row

  auto row_of = [&](int i) {         // tile row of this thread's i-th row
    return i < 4 * RA ? (i / 4) * kSlab + tx * 4 + i % 4 : RA * kSlab + tx * RB + (i - 4 * RA);
  };
  auto neuron_of = [&](int n) { return (n / NW) * (kTy * NW) + ty * NW + n % NW; };

  const bool noisy = !(kOff & kNoNoise) && noise != 0.0f;
  curandStatePhilox4_32_10_t rng;
  if (noisy) curand_init(c_seed, (unsigned long long)blockIdx.x * kThreads + tid, 0, &rng);

  // contraction rows [k_lo, k_hi) of Wc: all of it unless an ablation drops
  // the recurrence product or the feedback (whole chunks skipped)
  const int k_lo = (kOff & kNoRecDot) ? n_res8 : 0;
  const int k_hi = (kOff & kNoFeedback) ? n_res8 + round_up(n_in, kKc) : n_res8 + n_io8;
  const int nck = (k_hi - k_lo) / kKc;            // chunks a step
  const long long total = (long long)T * nck;     // chunks of the whole run

  // The weight stream. A warp multiplies by its own 32 / kTx x NT columns of
  // Wc only, so each warp streams those columns through a ring of its own
  // and the warps of a block meet at the step's barriers, not at every
  // chunk. Chunk number c of the run goes to ring slot c % kStages, laid
  // out (kKc, NM, kSeg) with rows kRowS apart.
  float* wring = ring + warp * (kStages * kChunkS);
  const float* wsrc = wc + (warp * (32 / kTx)) * NW;
  long long c_fetch = 0;
  int kc_fetch = 0, st_fetch = 0;
  auto fetch_chunk = [&]() {
    if (c_fetch < total) {
      const float* src = wsrc + (size_t)(k_lo + kc_fetch * kKc) * n_p;
      float* dst = wring + st_fetch * kChunkS;
#pragma unroll
      for (int u = lane; u < kKc * kRowW / 4; u += 32) {
        const int kk = u / (kRowW / 4), rem = u % (kRowW / 4);
        const int m = rem / (kSeg / 4), q4 = rem % (kSeg / 4);
        cp_async16(dst + kk * kRowS + 4 * rem, src + (size_t)kk * n_p + m * (kTy * NW) + 4 * q4);
      }
    }
    cp_async_commit();
    ++c_fetch;
    if (++kc_fetch == nck) kc_fetch = 0;
    if (++st_fetch == kStages) st_fetch = 0;
  };
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) fetch_chunk();

  for (int i = tid; i < (n_res8 + 2 * n_io8) * kH; i += kThreads) S[i] = 0.0f;
  if (kGrouped) {
    // stage the P readout slots this block can touch, once for all T steps
    const int G = B / Dg;
    for (int p = 0; p < P; ++p) {
      const int g = min(g0 + p, G - 1);
      const float* src = wout + (size_t)g * F * n_out;
      for (int i = tid; i < F * n_out; i += kThreads) WO[p * slot + i] = __ldg(src + i);
    }
  }
  __syncthreads();
  for (int i = tid; i < n_in * kH; i += kThreads) {
    const int r = i % kH, f = i / kH;
    if (r < n_valid) IO[f * kH + r] = u_fm[(size_t)f * B + row0 + r];
  }
  // the carried state and output of the block's real rows, read row-major
  // (coalesced); the padded rows of a ragged last block stay zero
  if (s0 != nullptr)
    for (int i = tid; i < n_valid * n_res; i += kThreads) {
      const int r = i / n_res, j = i % n_res;
      const float v = s0[(size_t)(row0 + r) * n_res + j];
      S[j * kH + r] = kTf32 ? tf32_rna(v) : v;
    }
  if (o0 != nullptr)
    for (int i = tid; i < n_valid * n_out; i += kThreads) {
      const int r = i / n_out, k = i % n_out;
      IO[(n_in + k) * kH + r] = o0[(size_t)(row0 + r) * n_out + k];
    }
  __syncthreads();

  int st = 0;
  for (int t = 0; t < T; ++t) {
    float* io_t = IO + (size_t)(t & 1) * n_io8 * kH;
    float* io_n = IO + (size_t)((t + 1) & 1) * n_io8 * kH;

    // the head of chunk kc of step t: wait for it in this warp's ring slot
    // and start the fetch of the chunk kStages - 1 ahead
    auto begin_chunk = [&](int kc) {
      cp_async_wait<kStages - 2>();   // this lane's part of the chunk is in
      __syncwarp();                   // the warp's is, and the slot before is free
      if (kc == 0 && t + 1 < T) {
        // u_{t+1} rides in the same group as the next chunk
        const float* src = u_fm + (size_t)(t + 1) * n_in * B + row0;
        for (int i = tid; i < n_in * kH; i += kThreads) {
          const int r = i % kH, f = i / kH;
          if (r < n_valid) cp_async4(io_n + f * kH + r, src + (size_t)f * B + r);
        }
      }
      fetch_chunk();
    };

    if constexpr (kTf32) {
      // ---- pre on the tensor cores: tile (mt, nt) of a lane holds rows
      // mt * 16 + gid (+ 8) and the warp's ring columns nt * 8 + 2 tig (+ 1)
      float acc[MT][NTW][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.0f;

#pragma unroll 1
      for (int kc = 0; kc < nck; ++kc) {
        begin_chunk(kc);
        const int k0 = kc * kKc;
        const float* wb = wring + st * kChunkS;
        // a tile's rows past kH read the next rows of shared memory: their
        // sums are never written back
        if (k0 < n_res8) {
          // state rows: S and Wt hold TF32 values
          const float* xb = S + (size_t)k0 * kH + gid;
          unsigned a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            a[mt][0] = __float_as_uint(xb[tig * kH + mt * 16]);
            a[mt][1] = __float_as_uint(xb[tig * kH + mt * 16 + 8]);
            a[mt][2] = __float_as_uint(xb[(tig + 4) * kH + mt * 16]);
            a[mt][3] = __float_as_uint(xb[(tig + 4) * kH + mt * 16 + 8]);
          }
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
            const unsigned b0 = __float_as_uint(wb[tig * kRowS + nt * 8 + gid]);
            const unsigned b1 = __float_as_uint(wb[(tig + 4) * kRowS + nt * 8 + gid]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][nt], a[mt], b0, b1);
          }
        } else {
          // [u_t; o] rows: fp32 multiply-adds into the same sums
          const float* xb = io_t + (size_t)(k0 - n_res8) * kH + gid;
#pragma unroll
          for (int kk = 0; kk < kKc; ++kk) {
            float x[MT][2];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              x[mt][0] = xb[kk * kH + mt * 16];
              x[mt][1] = xb[kk * kH + mt * 16 + 8];
            }
#pragma unroll
            for (int nt = 0; nt < NTW; ++nt) {
              const float2 w = *reinterpret_cast<const float2*>(wb + kk * kRowS + nt * 8 + 2 * tig);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                acc[mt][nt][0] = fmaf(w.x, x[mt][0], acc[mt][nt][0]);
                acc[mt][nt][1] = fmaf(w.y, x[mt][0], acc[mt][nt][1]);
                acc[mt][nt][2] = fmaf(w.x, x[mt][1], acc[mt][nt][2]);
                acc[mt][nt][3] = fmaf(w.y, x[mt][1], acc[mt][nt][3]);
              }
            }
          }
        }
        if (++st == kStages) st = 0;
      }
      if (nck < kStages) cp_async_wait<0>();
      __syncthreads();  // every warp is done reading S; u_{t+1} has landed

      // ---- s' = tanh(pre) + noise, written over S (fp32 until the readout) ----
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          // rows mt * 16 + 8 (c >> 1) + gid; a half wholly past kH is skipped
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            v[c] = mt * 16 + 8 * (c >> 1) < kH ? tanhf(acc[mt][nt][c]) : 0.0f;
          if (noisy) {
            const float4 z = curand_uniform4(&rng);
            v[0] += noise * (z.x - 0.5f); v[1] += noise * (z.y - 0.5f);
            v[2] += noise * (z.z - 0.5f); v[3] += noise * (z.w - 0.5f);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = mt * 16 + gid + 8 * (c >> 1);
            const int col = nt * 8 + 2 * tig + (c & 1);
            const int j = (col / kSeg) * (kTy * NW) + warp * kSeg + col % kSeg;
            if (mt * 16 + 8 * (c >> 1) < kH && r < kH && j < n_res) S[(size_t)j * kH + r] = v[c];
          }
        }
    } else {
      // ---- pre = Wc^T [s; u_t; o] over the contraction rows ----
      float acc[NT][RT];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          if (kOff & kNoRecDot) {  // pre starts from s itself
            const int j = neuron_of(n);
            acc[n][i] = j < n_res ? S[j * kH + row_of(i)] : 0.0f;
          } else {
            acc[n][i] = 0.0f;
          }
        }

#pragma unroll 1
      for (int kc = 0; kc < nck; ++kc) {
        begin_chunk(kc);
        const int k0 = k_lo + kc * kKc;
        const float* xb = k0 < n_res8 ? S + (size_t)k0 * kH : io_t + (size_t)(k0 - n_res8) * kH;
        const float* wb = wring + st * kChunkS + (ty % (32 / kTx)) * NW;
#pragma unroll
        for (int kk = 0; kk < kKc; ++kk) {
          const float* xk = xb + kk * kH;
          const float* wk = wb + kk * kRowS;
          float x[RT], w[NT];
#pragma unroll
          for (int a = 0; a < RA; ++a) {
            const float4 v = *reinterpret_cast<const float4*>(xk + a * kSlab + tx * 4);
            x[4 * a] = v.x; x[4 * a + 1] = v.y; x[4 * a + 2] = v.z; x[4 * a + 3] = v.w;
          }
          if (RB == 2) {
            const float2 v = *reinterpret_cast<const float2*>(xk + RA * kSlab + tx * 2);
            x[4 * RA] = v.x; x[4 * RA + 1] = v.y;
          } else {
#pragma unroll
            for (int b = 0; b < RB; ++b) x[4 * RA + b] = xk[RA * kSlab + tx * RB + b];
          }
#pragma unroll
          for (int m = 0; m < NM; ++m) {
            if (NW == 4) {
              const float4 v = *reinterpret_cast<const float4*>(wk + m * kSeg);
              w[4 * m] = v.x; w[4 * m + 1] = v.y; w[4 * m + 2] = v.z; w[4 * m + 3] = v.w;
            } else {
              const float2 v = *reinterpret_cast<const float2*>(wk + m * kSeg);
              w[2 * m] = v.x; w[2 * m + 1] = v.y;
            }
          }
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int i = 0; i < RT; ++i) acc[n][i] = fmaf(w[n], x[i], acc[n][i]);
        }
        if (++st == kStages) st = 0;
      }
      // a short step leaves u_{t+1}'s group behind the ring's depth
      if (nck < kStages) cp_async_wait<0>();
      __syncthreads();  // every warp is done reading S; u_{t+1} has landed

      // ---- s' = tanh(pre) + noise, written over S ----
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int j = neuron_of(n);
        if (j < n_res) {
          float v[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i)
            v[i] = (kOff & kNoTanh) ? 0.5f * acc[n][i] : tanhf(acc[n][i]);
          if (noisy) {
#pragma unroll
            for (int i = 0; i < RT; i += 4) {
              const float4 z = curand_uniform4(&rng);
              const float zz[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (i + q < RT) v[i + q] += noise * (zz[q] - 0.5f);
            }
          }
          float* sj = S + (size_t)j * kH;
#pragma unroll
          for (int a = 0; a < RA; ++a)
            *reinterpret_cast<float4*>(sj + a * kSlab + tx * 4) =
                make_float4(v[4 * a], v[4 * a + 1], v[4 * a + 2], v[4 * a + 3]);
#pragma unroll
          for (int b = 0; b < RB; ++b) sj[RA * kSlab + tx * RB + b] = v[4 * RA + b];
        }
      }
    }
    __syncthreads();

    // ---- o' = grouped readout over [s'; u_t], n_out in passes of 8 ----
    // A lane is a row (x reads are contiguous), a warp takes every 8th
    // feature; the 8 partial sums of an output meet in RED.
    for (int kb = 0; kb < n_out; kb += kOutTile) {
      if (!(kOff & kNoReadout)) {
        const bool vec = n_out % 4 == 0;
        for (int rb = 0; rb < kH; rb += 32) {
          const int r = rb + lane;
          float o[kOutTile];
#pragma unroll
          for (int k = 0; k < kOutTile; ++k) o[k] = 0.0f;
          if (r < n_valid) {
            const int g = (row0 + r) / Dg;
            const float* wrow = kGrouped ? WO + (g - g0) * slot + kb
                                         : wout + (size_t)g * F * n_out + kb;
            // unrolled so that the loads of several features are in
            // flight: K2's weights come from L2 or L1
            auto add = [&](float xv, const float* wf) {
              if (vec) {
                const float4 a = kGrouped ? *reinterpret_cast<const float4*>(wf)
                                          : __ldg(reinterpret_cast<const float4*>(wf));
                o[0] = fmaf(a.x, xv, o[0]); o[1] = fmaf(a.y, xv, o[1]);
                o[2] = fmaf(a.z, xv, o[2]); o[3] = fmaf(a.w, xv, o[3]);
                if (kb + 4 < n_out) {
                  const float4 b = kGrouped ? *reinterpret_cast<const float4*>(wf + 4)
                                            : __ldg(reinterpret_cast<const float4*>(wf + 4));
                  o[4] = fmaf(b.x, xv, o[4]); o[5] = fmaf(b.y, xv, o[5]);
                  o[6] = fmaf(b.z, xv, o[6]); o[7] = fmaf(b.w, xv, o[7]);
                }
              } else {
#pragma unroll
                for (int k = 0; k < kOutTile; ++k)
                  if (kb + k < n_out) o[k] = fmaf(kGrouped ? wf[k] : __ldg(wf + k), xv, o[k]);
              }
            };
#pragma unroll 8
            for (int f = warp; f < n_res; f += kWarps) {
              const float sv = S[f * kH + r];
              add(sv, wrow + (size_t)f * n_out);
              // the TF32 build's next product reads s' rounded to TF32
              if (kTf32 && kb + kOutTile >= n_out) S[f * kH + r] = tf32_rna(sv);
            }
#pragma unroll 2
            for (int f = warp; f < n_in; f += kWarps)
              add(io_t[f * kH + r], wrow + (size_t)(n_res + f) * n_out);
          }
          if (r < kH) {
#pragma unroll
            for (int k = 0; k < kOutTile; ++k) RED[(warp * kOutTile + k) * kH + r] = o[k];
          }
        }
        __syncthreads();
      }
      for (int idx = tid; idx < kH * kOutTile; idx += kThreads) {
        const int r = idx / kOutTile, k = kb + idx % kOutTile;
        if (r < n_valid && k < n_out) {
          float o = 0.0f;
          if (kOff & kNoReadout) {
            o = S[k * kH + r];
          } else {
#pragma unroll
            for (int w = 0; w < kWarps; ++w) o += RED[(w * kOutTile + k - kb) * kH + r];
          }
          io_n[(n_in + k) * kH + r] = o;
          if (t >= n_forget)
            out[((size_t)(row0 + r) * Tout + (t - n_forget)) * n_out + k] = o / teacher_scaling;
        }
      }
      __syncthreads();  // o is in place for step t + 1; RED may be reused
    }
  }
  cp_async_wait<0>();
}

template <int NJ4, int kH, bool kGrouped, int kOff = 0, bool kTf32 = false>
int launch(const float* u_fm, const float* wc, const float* wout, float* out,
           const float* s0, const float* o0, int B, int T, int n_res, int n_in, int n_out, int Dg, int n_forget,
           int rows, int P, float noise, float teacher_scaling,
           const unsigned long long* seed, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_res, n_in, n_out, kH, kGrouped ? P : 0, kTf32);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(predict_kernel<NJ4, kH, kGrouped, kOff, kTf32>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  // shared memory for the blocks the tiling puts on an SM and no more: what
  // is left is L1, which holds K2's readout weights between steps
  const size_t fit = kSmemSm / (smem + 1024);
  constexpr int kMin = min_blocks(NJ4, kH, kTf32);
  const size_t need = (fit < (size_t)kMin ? fit : kMin) * (smem + 1024);
  e = cudaFuncSetAttribute(predict_kernel<NJ4, kH, kGrouped, kOff, kTf32>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           need >= kSmemSm ? 100 : (int)(need * 100 / kSmemSm) + 1);
  if (e != cudaSuccess) return (int)e;
  if (!(kOff & kNoNoise) && noise != 0.0f) {
    e = cudaMemcpyToSymbolAsync(c_seed, seed, sizeof(c_seed), 0,
                                cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + rows - 1) / rows;
  predict_kernel<NJ4, kH, kGrouped, kOff, kTf32><<<blocks, threads_of(NJ4, kH, kTf32), smem, stream>>>(
      u_fm, wc, wout, out, s0, o0, B, T, n_res, n_in, n_out, Dg, n_forget,
      rows, P, noise, teacher_scaling);
  return (int)cudaGetLastError();
}

// The builds of K2 and K4: tile heights of 20 and 72 rows for
// ceil(n_res / 64) = 1 .. 5, of 20 rows for 6 .. 10 (n_res <= 640; a 72-row
// state of a wider reservoir leaves the ring no room); K2's TF32 builds at
// the same heights for the widths of `tf32_width`. Another height or width,
// or more rows a block than the height, is refused.
template <bool kGrouped, bool kTf32 = false>
int launch_any(const float* u_fm, const float* wc, const float* wout,
               float* out, const float* s0, const float* o0, int B, int T, int n_res, int n_in, int n_out,
               int Dg, int n_forget, int rows, int height, int P, float noise,
               float teacher_scaling, const unsigned long long* seed, void* stream) {
  if (B <= 0 || T <= n_forget) return 0;
  if (rows <= 0 || rows > height || n_res <= 0 || Dg <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define ESN_ARGS u_fm, wc, wout, out, s0, o0, B, T, n_res, n_in, n_out, Dg, n_forget, rows, P, noise, teacher_scaling, seed, s
#define ESN_CASE(N)                                                  \
  case N:                                                            \
    if (kTf32 && !tf32_width(N)) return (int)cudaErrorInvalidValue;  \
    if (height == 20) return launch<N, 20, kGrouped, 0, kTf32 && tf32_width(N)>(ESN_ARGS); \
    if (height == 72 && N <= 5)                                      \
      return launch<(N <= 5 ? N : 1), 72, kGrouped, 0, kTf32 && tf32_width(N)>(ESN_ARGS); \
    return (int)cudaErrorInvalidValue;
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
#undef ESN_ARGS
}

}  // namespace esn_predict
