// Teacher-forced ESN state harvest (the fit's recurrence), Hopper, fp32 (K3).
//
// Replaces the TPU kernel esn_ofdm_mimo_tpu/models/esn_pallas.py:
// _states_kernel (launched by esn_states_pallas). For every batch row it runs
//     s_t = tanh(Wt^T s_{t-1} + W_in^T u_t + W_fb^T d_{t-1})
//           + noise * (U - 0.5),        t = 1 .. T-1,  s_0 = 0
// and writes all T states to (B, T, n_res). The drive z_t = [u_t; d_{t-1}]
// is known in advance (teacher forcing): there is no readout in the loop.
// The plain version it is held against is esn_ofdm_mimo_tpu_torch/models/
// esn.py (esn_states).
//
// What bounds it on the H100. At the mimo_4x8_nbf fit shape (128 rows,
// T = 522, n_res = 600, n_in = 16, n_out = 8) the work is 2 * 128 * 521 *
// 600 * 624 = 5.0e10 fp32 operations (0.75 ms at 67 TFLOP/s) and the bytes
// are the 160 MB of states written (0.05 ms): bound by arithmetic. But the
// recurrence is sequential in t and a fit batch is small: the stacked weight
// Wc = [Wt; W_in_t; W_fb_t] (K = n_res + n_in + n_out rows, 1.5 MB at NBF)
// is needed by every row at every step and is more than one SM's shared
// memory. A block that streams it from L2 at every step is bound by that
// stream (21 us a step at NBF on an H100).
//
// Design: a thread-block cluster keeps the weight on chip.
//   * A cluster of C CTAs (C in {2, 4, 8, 16}, one per SM) owns
//     rows_per_cluster consecutive rows for all T steps, in one launch: in
//     tiles of RT rows (RT <= 16), the rows left after the full tiles in
//     the smallest built tile that holds them (8 + 1 for 9 rows). CTA rank r owns `cols` consecutive neuron
//     columns [r * cols, (r + 1) * cols) and copies its column slice of Wc
//     (K x CP f32, CP = cols padded to 4 * odd) into shared memory ONCE per
//     launch (cp.async); no weight byte is read from L2 inside the step loop.
//   * Each CTA also holds the full operand X = [s_{t-1}; z_t] (K x RT f32)
//     twice, by step parity. Step t reads X[t & 1]: pre = X^T Wc_slice over
//     the whole K, the drive dot included (as in the Pallas body, no matmul
//     precompute). It applies tanh and noise, writes its slice of s_t to
//     `out`, and pushes that slice into X[(t + 1) & 1] of EVERY CTA of the
//     cluster through distributed shared memory (map_shared_rank). One
//     cluster barrier a step (barrier.cluster.arrive.release /
//     wait.acquire) orders the pushes before the next step's reads and the
//     reads of X[t & 1] before anyone overwrites it at step t + 1. The state
//     write to `out` and the fetch of the drive two steps ahead sit between
//     arrive and wait, so the release waits for neither.
//     Every CTA runs every step (rows beyond B are masked, never returned
//     early), and the last step's barrier is the exit barrier: no CTA
//     leaves while a peer may still write into its shared memory.
//   * Register tiling. Each half-warp owns 4 neighbouring columns (one
//     float4 of Wc a k) for all RT rows, so a warp owns 8; the 16 lanes of
//     a half split K (lane l takes k = l, l + 16, ...). A lane keeps 4 x RT
//     partial sums: each weight load feeds RT multiply-adds, each X load
//     (RT floats, the same row for both halves: one broadcast) feeds 4. A
//     butterfly of shuffles then reduces and scatters the sums over the 16
//     lanes (30 shuffles at RT = 8): each lane ends with the states of one
//     column at 4 rows (RT = 16), 2 (RT = 8) or 1, and pushes them as one
//     store a CTA.
//     Two groups a warp keep a block at <= 11 warps, so nvcc may give a
//     thread the registers of 4 x RT sums and the loads in flight without
//     spilling (local memory would go to L2: the L1 left beside a 227 KB
//     carve-out is small). Bank conflicts: CP / 4 is odd, so the 8 lanes
//     of a 16-byte load phase hit 8 different bank quads of Wc; at RT = 8
//     and 16 the quads of an X row are permuted with k (xidx) for the same
//     reason.
//   * fp32 fused multiply-adds throughout (no TF32, no bf16): the sums
//     differ from the plain version's matmuls by rounding only.
//   * State noise is Philox-4x32-10 (curand_kernel.h), one subsequence per
//     (cluster, rank, thread), added only to real neurons. Its 64-bit seed
//     is read from device memory (one load a thread), so a captured CUDA
//     graph draws the stream of whatever seed the buffer holds at replay.
//
// What holds it now (tools/bench_states_torch.py on an H100): shared-memory
// bandwidth. A step of a tile reads the CTA's whole slice (190 KB at NBF,
// >= 0.75 us at 128 B a clock) and every column group reads all of X (19
// groups x 20 KB at 8 rows, >= 1.5 us); the barrier, the pushes and the
// butterfly take most of the rest of a 1-row tile's 2.1 us. At the NBF fit
// the card holds 15 clusters of 8, so a cluster runs 9 rows as a tile of 8
// and a tile of 1, 7 us a step.
//
// The plan (C, clusters, rows a cluster, RT) is chosen by the wrapper
// (models/esn_states_cuda.py:states_plan) from the card's active-cluster
// counts; esn_states_smem_bytes and esn_states_cols_pad mirror its
// arithmetic.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxGroups = 22;   // CP <= 88: column groups of 4
constexpr int kLanesK = 16;      // lanes that split K for one column group
constexpr int kMaxThreads = 32 * ((kMaxGroups + 1) / 2);  // two groups a warp
constexpr int kZRegs = 2;        // drive values a thread prefetches, at most
constexpr int kSmemMax = 232448;

__host__ __device__ inline int cols_of(int n_res, int C) {
  return (n_res + C - 1) / C;
}

// cols rounded up to 4, then to an odd number of float4s
__host__ __device__ inline int cols_pad(int n_res, int C) {
  int cp = (cols_of(n_res, C) + 3) / 4 * 4;
  return (cp / 4) % 2 == 0 ? cp + 4 : cp;
}

// Index of (k, r) in one X buffer of RT rows, row k = RT floats in quads of
// 4. Lanes read 8 consecutive k at once; so that they hit 8 different bank
// quads, quad q of row k is stored at q ^ (k >> 2 & 1) (RT = 8) or q ^ (k
// >> 1 & 3) (RT = 16).
template <int RT>
__device__ __forceinline__ int xidx(int k, int r) {
  if constexpr (RT == 16) return k * 16 + (((r >> 2) ^ ((k >> 1) & 3)) << 2) + (r & 3);
  if constexpr (RT == 8) return k * 8 + (r ^ (((k >> 2) & 1) << 2));
  return k * RT + r;
}

template <int RT>
__device__ __forceinline__ void load_x(const float* X, int k, float (&x)[RT]) {
  if constexpr (RT >= 4) {
#pragma unroll
    for (int q = 0; q < RT / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(X + xidx<RT>(k, 4 * q));
      x[4 * q] = a.x; x[4 * q + 1] = a.y; x[4 * q + 2] = a.z; x[4 * q + 3] = a.w;
    }
  } else if constexpr (RT == 2) {
    const float2 a = *reinterpret_cast<const float2*>(X + k * 2);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = X[k];
  }
}

// LEVELS levels of the butterfly from VALS sums a lane, at lane bit M: a
// lane keeps the half of its sums that bit M of its lane selects and adds
// the partner's copy of that half. Every index is a constant, so v stays in
// registers.
template <int VALS, int M, int LEVELS, int N>
__device__ __forceinline__ void scatter(float (&v)[N], int lane) {
  if constexpr (LEVELS > 0) {
    constexpr int h = VALS / 2;
    const bool up = (lane & M) != 0;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float send = up ? v[j] : v[j + h];
      const float keep = up ? v[j + h] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    scatter<h, M / 2, LEVELS - 1>(v, lane);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Drive value f of row `row` at step t: u_t[f] for f < n_in, else
// d_{t-1}[f - n_in]; 0 for rows past the cluster's last.
__device__ __forceinline__ float drive(const float* __restrict__ u,
                                      const float* __restrict__ d, int row,
                                      int row_hi, int t, int f, int T,
                                      int n_in, int n_out) {
  if (row >= row_hi) return 0.0f;
  return f < n_in ? u[((size_t)row * T + t) * n_in + f]
                  : d[((size_t)row * T + t - 1) * n_out + (f - n_in)];
}

// What every tile of a CTA shares.
struct Cta {
  const float* __restrict__ u;
  const float* __restrict__ d;
  float* __restrict__ out;
  const float* Ws;    // (K, CP) this CTA's slice
  float* X0;          // X of even steps
  float* X1;          // X of odd steps
  int T, n_res, n_in, n_out, nz, K, CP, G4, C, col0, my_cols;
  int tid, nthr, lane, kl, gw, g;
  float noise;
};

// All T steps of R rows row0 .. row0 + R - 1 (those from row_hi masked).
template <int R>
__device__ __forceinline__ void run_tile(const Cta& c, int row0, int row_hi,
                                         curandStatePhilox4_32_10_t& rng) {
  cg::cluster_group cluster = cg::this_cluster();
  const int T = c.T, n_res = c.n_res, nz = c.nz, K = c.K;
  const int tid = c.tid, nthr = c.nthr, lane = c.lane;
  // The butterfly over the 16 lanes of a column group: kScatter levels
  // halve the 4 x R sums (lane bits 3, 2, ...), then kDup levels add the
  // kLeft that remain across lanes holding the same ones. A lane ends with
  // sums i0 .. i0 + kLeft - 1 of the (column c, row r) list i = c * R + r.
  constexpr int kVals = 4 * R;
  constexpr int kLogVals = R == 16 ? 6 : R == 8 ? 5 : R == 4 ? 4 : R == 2 ? 3 : 2;
  constexpr int kScatter = kLogVals < 4 ? kLogVals : 4;
  constexpr int kLeft = kVals >> kScatter;  // 4 at R = 16, 2 at 8, else 1
  constexpr int kDup = 4 - kScatter;
  const int i0 = (c.kl >> kDup) * kLeft;
  const int c_own = i0 / R, r_own = i0 % R;  // kLeft rows from r_own
  const int jcol = 4 * c.g + c_own;          // slice column
  const bool owner =
      (c.kl & ((1 << kDup) - 1)) == 0 && c.gw < c.G4 && jcol < c.my_cols;
  const int ncol = c.col0 + jcol;            // neuron

  // s_0 = 0 and z_1 into X1; s_0 into out
  for (int i = tid; i < n_res * R; i += nthr) c.X1[xidx<R>(i / R, i % R)] = 0.0f;
  for (int i = tid; i < nz * R; i += nthr)
    c.X1[xidx<R>(n_res + i / R, i % R)] =
        T > 1 ? drive(c.u, c.d, row0 + i % R, row_hi, 1, i / R, T, c.n_in,
                      c.n_out)
              : 0.0f;
  for (int i = tid; i < c.my_cols * R; i += nthr) {
    const int row = row0 + i / c.my_cols;
    if (row < row_hi) c.out[(size_t)row * T * n_res + c.col0 + i % c.my_cols] = 0.0f;
  }
  // z_{t+1} in registers, stored into the next X at step t. It is fetched
  // between a step's arrive and wait (z_2 here): a release orders this
  // thread's earlier loads too, so a load started before the arrive would
  // hold it for a global round trip, while one started after has a whole
  // step to land
  float zr[kZRegs];
  auto fetch_z = [&](int t) {
#pragma unroll
    for (int j = 0; j < kZRegs; ++j) {
      const int i = tid + j * nthr;
      zr[j] = (t < T && i < nz * R)
                  ? drive(c.u, c.d, row0 + i % R, row_hi, t, i / R, T, c.n_in,
                          c.n_out)
                  : 0.0f;
    }
  };
  fetch_z(2);
  __syncthreads();  // X1 ready; the previous tile's last barrier ended
                    // every push into and read of both buffers

  for (int t = 1; t < T; ++t) {
    const float* X = (t & 1) ? c.X1 : c.X0;
    float* Xn = (t & 1) ? c.X0 : c.X1;

    // ---- partial sums over this lane's k = kl, kl + 16, ... ----
    float v[kVals];  // v[column * R + row]
#pragma unroll
    for (int i = 0; i < kVals; ++i) v[i] = 0.0f;
    const float* wcol = c.Ws + 4 * c.g;
#pragma unroll 2
    for (int k = c.kl; k < K; k += kLanesK) {
      const float4 w = *reinterpret_cast<const float4*>(wcol + (size_t)k * c.CP);
      float x[R];
      load_x<R>(X, k, x);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[0 * R + r] = fmaf(w.x, x[r], v[0 * R + r]);
        v[1 * R + r] = fmaf(w.y, x[r], v[1 * R + r]);
        v[2 * R + r] = fmaf(w.z, x[r], v[2 * R + r]);
        v[3 * R + r] = fmaf(w.w, x[r], v[3 * R + r]);
      }
    }

    // ---- the butterfly ----
    scatter<kVals, kLanesK / 2, kScatter>(v, lane);
#pragma unroll
    for (int m = (1 << kDup) >> 1; m > 0; m >>= 1)
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);

    // ---- s_t = tanh(pre) + noise; push into every CTA's next X ----
    float s[kLeft];
    float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c.noise != 0.0f) z4 = curand_uniform4(&rng);
#pragma unroll
    for (int j = 0; j < kLeft; ++j) {
      const float z = j == 0 ? z4.x : j == 1 ? z4.y : j == 2 ? z4.z : z4.w;
      s[j] = tanhf(v[j]) + (c.noise != 0.0f ? c.noise * (z - 0.5f) : 0.0f);
    }
    if (owner) {
      // kLeft consecutive rows of one column: contiguous in X
      const int xi = xidx<R>(ncol, r_own);
      for (int q = 0; q < c.C; ++q) {
        float* dst = cluster.map_shared_rank(Xn, q) + xi;
        if constexpr (kLeft == 4)
          *reinterpret_cast<float4*>(dst) = make_float4(s[0], s[1], s[2], s[3]);
        else if constexpr (kLeft == 2)
          *reinterpret_cast<float2*>(dst) = make_float2(s[0], s[1]);
        else
          *dst = s[0];
      }
    }
#pragma unroll
    for (int j = 0; j < kZRegs; ++j) {
      const int i = tid + j * nthr;
      if (i < nz * R) Xn[xidx<R>(n_res + i / R, i % R)] = zr[j];
    }
    cluster_arrive();
    fetch_z(t + 2);
    if (owner) {
#pragma unroll
      for (int j = 0; j < kLeft; ++j) {
        const int row = row0 + r_own + j;
        if (row < row_hi) c.out[((size_t)row * T + t) * n_res + ncol] = s[j];
      }
    }
    cluster_wait();
  }
}

// Rows a tile of the build RT runs: the smallest built tile (<= RT) that
// holds the rows left (models/esn_states_cuda.py:tail_tile mirrors it).
__host__ __device__ inline int tile_rows(int RT, int left) {
  int r = 1;
  while (r < left && r < RT) r *= 2;
  return r;
}

template <int RT>
__global__ void __launch_bounds__(kMaxThreads, 1)
esn_states_cluster_kernel(const float* __restrict__ u,    // (B, T, n_in) scaled
                          const float* __restrict__ d,    // (B, T, n_out)
                          const float* __restrict__ wsl,  // (C, K, CP)
                          float* __restrict__ out,        // (B, T, n_res)
                          int B, int T, int n_res, int n_in, int n_out,
                          int rows_per_cluster, float noise,
                          const unsigned long long* seed) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  Cta c;
  c.u = u;
  c.d = d;
  c.out = out;
  c.T = T;
  c.n_res = n_res;
  c.n_in = n_in;
  c.n_out = n_out;
  c.noise = noise;
  c.C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / c.C;
  c.nz = n_in + n_out;
  c.K = n_res + c.nz;
  const int cols = cols_of(n_res, c.C);
  c.CP = cols_pad(n_res, c.C);
  c.G4 = c.CP / 4;  // column groups of the slice
  c.col0 = rank * cols;
  c.my_cols = max(0, min(cols, n_res - c.col0));
  float* Ws = reinterpret_cast<float*>(smem4);
  c.Ws = Ws;
  c.X0 = Ws + (size_t)c.K * c.CP;
  c.X1 = c.X0 + (size_t)c.K * RT;
  c.tid = threadIdx.x;
  c.nthr = blockDim.x;                    // 32 * ceil(G4 / 2)
  c.lane = c.tid & 31;
  c.kl = c.lane & (kLanesK - 1);          // this lane's k = kl + 16 j
  c.gw = 2 * (c.tid >> 5) + (c.lane >> 4);  // column group of the half-warp
  c.g = min(c.gw, c.G4 - 1);              // (the last may repeat one)

  // ---- the weight slice, once per launch ----
  {
    const char* src = reinterpret_cast<const char*>(wsl + (size_t)rank * c.K * c.CP);
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(Ws);
    const int n16 = c.K * c.CP / 4;
    for (int i = c.tid; i < n16; i += c.nthr)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16 * i),
                   "l"(src + 16 * (size_t)i));
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  }

  curandStatePhilox4_32_10_t rng;
  if (noise != 0.0f)
    curand_init(*seed, (unsigned long long)blockIdx.x * c.nthr + c.tid, 0, &rng);

  const int row_lo = cid * rows_per_cluster;
  const int row_hi = min(B, row_lo + rows_per_cluster);

  // the slice is complete, and every CTA of the cluster is running before
  // any pushes into another
  __syncthreads();
  cluster.sync();

  // full tiles of RT rows, then the rest in the smallest tile that holds
  // it; every CTA of the cluster takes the same branch
  for (int row0 = row_lo; row0 < row_hi; row0 += RT) {
    const int r = tile_rows(RT, row_hi - row0);
    if (r == RT) run_tile<RT>(c, row0, row_hi, rng);
    else if constexpr (RT > 1) {
      if (r == 1) run_tile<1>(c, row0, row_hi, rng);
      else if constexpr (RT > 2) {
        if (r == 2) run_tile<2>(c, row0, row_hi, rng);
        else if constexpr (RT > 4) {
          if (r == 4) run_tile<4>(c, row0, row_hi, rng);
          else if constexpr (RT > 8) {
            run_tile<8>(c, row0, row_hi, rng);
          }
        }
      }
    }
  }
}

template <int RT>
int launch_rt(const float* u, const float* d, const float* wsl, float* out,
              int B, int T, int n_res, int n_in, int n_out, int C,
              int clusters, int rows_per_cluster, float noise,
              const unsigned long long* seed, cudaStream_t stream, int* max_clusters) {
  auto kernel = esn_states_cluster_kernel<RT>;
  const int K = n_res + n_in + n_out;
  const int CP = cols_pad(n_res, C);
  size_t smem = sizeof(float) * (size_t)K * (CP + 2 * RT);
  // a plan puts one CTA on an SM: count clusters at no less shared memory
  // than makes that so
  if (max_clusters != nullptr && smem <= (size_t)kSmemMax / 2)
    smem = kSmemMax / 2 + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(32 * ((CP / 4 + 1) / 2));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  e = cudaLaunchKernelEx(&cfg, kernel, u, d, wsl, out, B, T, n_res, n_in,
                         n_out, rows_per_cluster, noise, seed);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int dispatch(const float* u, const float* d, const float* wsl, float* out,
             int B, int T, int n_res, int n_in, int n_out, int C, int clusters,
             int rows_per_cluster, int RT, float noise,
             const unsigned long long* seed, cudaStream_t stream, int* max_clusters) {
  const int CP = cols_pad(n_res, C);
  const int K = n_res + n_in + n_out;
  if ((C != 2 && C != 4 && C != 8 && C != 16) || CP / 4 > kMaxGroups ||
      (n_in + n_out) * RT > kZRegs * 32 * ((CP / 4 + 1) / 2) || n_res <= 0 ||
      sizeof(float) * (size_t)K * (CP + 2 * RT) > (size_t)kSmemMax)
    return (int)cudaErrorInvalidValue;
#define ESN_STATES_RT(R)                                                     \
  launch_rt<R>(u, d, wsl, out, B, T, n_res, n_in, n_out, C, clusters,        \
               rows_per_cluster, noise, seed, stream, max_clusters)
  switch (RT) {
    case 1: return ESN_STATES_RT(1);
    case 2: return ESN_STATES_RT(2);
    case 4: return ESN_STATES_RT(4);
    case 8: return ESN_STATES_RT(8);
    case 16: return ESN_STATES_RT(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ESN_STATES_RT
}

}  // namespace

// Padded columns of a CTA's weight slice (models/esn_states_cuda.py:
// cols_pad mirrors it).
extern "C" int esn_states_cols_pad(int n_res, int C) { return cols_pad(n_res, C); }

// Dynamic shared memory of one CTA: its weight slice and two X buffers of
// RT rows (models/esn_states_cuda.py:states_smem_bytes).
extern "C" long long esn_states_smem_bytes(int n_res, int n_in, int n_out,
                                           int C, int RT) {
  return 4LL * (n_res + n_in + n_out) * (cols_pad(n_res, C) + 2 * RT);
}

// Clusters of C CTAs of this shape the card holds at once
// (cudaOccupancyMaxActiveClusters); returns a CUDA error code.
extern "C" int esn_states_max_clusters(int n_res, int n_in, int n_out, int C,
                                       int RT, int* count) {
  *count = 0;
  return dispatch(nullptr, nullptr, nullptr, nullptr, 0, 0, n_res, n_in,
                  n_out, C, 1, RT, RT, 0.0f, nullptr, nullptr, count);
}

extern "C" int esn_states_launch(const float* u, const float* d,
                                 const float* wsl, float* out, int B, int T,
                                 int n_res, int n_in, int n_out, int C,
                                 int clusters, int rows_per_cluster, int RT,
                                 float noise, const unsigned long long* seed,
                                 void* stream) {
  if (B <= 0 || T <= 0) return 0;
  return dispatch(u, d, wsl, out, B, T, n_res, n_in, n_out, C, clusters,
                  rows_per_cluster, RT, noise, seed,
                  reinterpret_cast<cudaStream_t>(stream), nullptr);
}
