// K7: the forward pass and backpropagation through time of B independent
// GRUs, one a coherence block, Hopper, fp32.
//
// A port kernel with no Pallas counterpart: the JAX package trains the 2x2
// model zoo's GRU with jax.vmap over blocks of jax.grad of
// esn_ofdm_mimo_tpu/models/zoo.py:rnn_apply (a lax.scan that XLA compiles
// into one loop). The port's eager route makes one torch.nn.GRU call a
// block, forward and backward (models/zoo.py:train_rnn_per_block), so an
// epoch of 128 blocks is 256 cuDNN calls one after another, each at batch 1.
// This kernel gives every block's loss, outputs and weight gradients in one
// launch an epoch (gru_train_kernel), and every block's predictions of S
// sequences in one launch (gru_predict_kernel).
//
// The function (models/zoo.py:rnn_apply, hidden H = 32, inputs NI = 4,
// outputs NO = 4, the JAX package's gate order and an input bias only):
//   gi = x_t W_i + b_i, gh = h W_h              (gate columns r | z | n)
//   r = sigmoid(gi_r + gh_r), z = sigmoid(gi_z + gh_z)
//   n = tanh(gi_n + r * gh_n), h <- (1 - z) n + z h, y_t = h W_o + b_o
// over T steps from h = 0; the loss of a block is mean((y - target)^2)
// over its T x NO outputs, and the gradients are those of the sum of the
// blocks' losses (each block's own, since no weight is shared).
//
// What bounds it on the H100. Each step of the recurrence depends on the
// last: a block's T steps forward and T back are a serial chain, and the
// work of one step (3 x 32 x 32 multiply-adds forward, as many back) is a
// single warp's. So the kernel is bound by the chain's latency, not by
// bytes or operations: one CTA a block (128 blocks on 132 SMs), and inside
// it one warp runs the recurrence with everything it needs in registers.
// Lane k holds gate columns k, 32 + k and 64 + k of W_h forward (96
// registers) and row k of W_h backward, exchanges h (forward) or the 96
// gate gradients (backward) through 32 or 96 floats of shared memory
// between two __syncwarp()s, and splits each dot product into independent
// multiply-add chains. Nothing else sits on the chain: the outputs and
// their gradients are computed 32 steps at a time from a ring of hidden
// states in shared memory, and the weight gradients, sums over the T steps
// of outer products, after the backward pass by all 8 warps of the CTA,
// from the per-step values the recurrence left in a workspace.
//
// Numbers. fp32 throughout, sums in another order than PyTorch's matrix
// products and autograd's, and nvcc's default contraction into
// multiply-adds: the results agree with the plain version
// (ops/gru_cuda.py:train_plain) to rounding, not bit for bit.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int H = 32;        // hidden units, one a lane
constexpr int G = 3 * H;     // gate columns r | z | n
constexpr int NI = 4;        // inputs (2 n_rx)
constexpr int NO = 4;        // outputs (2 n_tx)
constexpr int ROWS = 5;      // a step's saved values a unit: r, z, n, gh_n, h
constexpr int TT = 32;       // steps a tile (the output ring, the reductions)
constexpr int kTrainThreads = 256;
constexpr int kPredictWarps = 4;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One sequence's forward pass by one warp (lane k = unit k). x (T, NI) and
// pred (T, NO) of the sequence; wi (NI, G), wh (H, G), bi (G) of its block;
// s_out holds W_o (H, NO) then b_o (NO). With TRAIN it also saves each
// step's r, z, n, gh_n and h to st (T, ROWS, H), writes each output's
// gradient 2 (y - target) / (T NO) to dy (T, NO) and the block's loss to
// *loss.
template <bool TRAIN>
__device__ void forward(const float* __restrict__ x,
                        const float* __restrict__ target,
                        const float* __restrict__ wi,
                        const float* __restrict__ wh,
                        const float* __restrict__ bi, const float* s_out,
                        float* __restrict__ pred, float* __restrict__ st,
                        float* __restrict__ dy, float* s_h,
                        float (*ring)[H + 1], int T, float* loss) {
  const int k = threadIdx.x & 31;
  float wr[H], wz[H], wn[H];
#pragma unroll
  for (int q = 0; q < H; ++q) {
    wr[q] = wh[q * G + k];
    wz[q] = wh[q * G + H + k];
    wn[q] = wh[q * G + 2 * H + k];
  }
  float ir[NI], iz[NI], in_[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    ir[i] = wi[i * G + k];
    iz[i] = wi[i * G + H + k];
    in_[i] = wi[i * G + 2 * H + k];
  }
  const float br = bi[k], bz = bi[H + k], bn = bi[2 * H + k];
  const float inv_n = 1.0f / (float)(T * NO);
  float h = 0.0f, lsum = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float4 xt = *reinterpret_cast<const float4*>(x + t * NI);
    const float gr = (xt.x * ir[0] + xt.y * ir[1] + xt.z * ir[2] +
                      xt.w * ir[3]) + br;
    const float gz = (xt.x * iz[0] + xt.y * iz[1] + xt.z * iz[2] +
                      xt.w * iz[3]) + bz;
    const float gn = (xt.x * in_[0] + xt.y * in_[1] + xt.z * in_[2] +
                      xt.w * in_[3]) + bn;
    s_h[k] = h;
    __syncwarp();
    float ar0 = 0.f, ar1 = 0.f, az0 = 0.f, az1 = 0.f, an0 = 0.f, an1 = 0.f;
#pragma unroll
    for (int q = 0; q < H; q += 4) {
      const float4 hq = *reinterpret_cast<const float4*>(s_h + q);
      ar0 = fmaf(hq.x, wr[q], ar0);
      az0 = fmaf(hq.x, wz[q], az0);
      an0 = fmaf(hq.x, wn[q], an0);
      ar1 = fmaf(hq.y, wr[q + 1], ar1);
      az1 = fmaf(hq.y, wz[q + 1], az1);
      an1 = fmaf(hq.y, wn[q + 1], an1);
      ar0 = fmaf(hq.z, wr[q + 2], ar0);
      az0 = fmaf(hq.z, wz[q + 2], az0);
      an0 = fmaf(hq.z, wn[q + 2], an0);
      ar1 = fmaf(hq.w, wr[q + 3], ar1);
      az1 = fmaf(hq.w, wz[q + 3], az1);
      an1 = fmaf(hq.w, wn[q + 3], an1);
    }
    __syncwarp();
    const float an = an0 + an1;
    const float r = sigmoidf(gr + (ar0 + ar1));
    const float z = sigmoidf(gz + (az0 + az1));
    const float n = tanhf(gn + r * an);
    h = (1.0f - z) * n + z * h;
    if (TRAIN) {
      float* s = st + (size_t)t * ROWS * H;
      s[k] = r;
      s[H + k] = z;
      s[2 * H + k] = n;
      s[3 * H + k] = an;
      s[4 * H + k] = h;
    }
    const int slot = t % TT;
    ring[slot][k] = h;
    if (slot == TT - 1 || t == T - 1) {
      __syncwarp();
      const int row = t - slot + k;       // lane k takes the tile's row k
      if (k <= slot) {
        float o[NO];
#pragma unroll
        for (int c = 0; c < NO; ++c) o[c] = 0.0f;
#pragma unroll
        for (int q = 0; q < H; ++q) {
          const float hq = ring[k][q];
#pragma unroll
          for (int c = 0; c < NO; ++c) o[c] = fmaf(hq, s_out[q * NO + c], o[c]);
        }
#pragma unroll
        for (int c = 0; c < NO; ++c) o[c] += s_out[H * NO + c];
        *reinterpret_cast<float4*>(pred + row * NO) =
            make_float4(o[0], o[1], o[2], o[3]);
        if (TRAIN) {
          const float4 y4 = *reinterpret_cast<const float4*>(target + row * NO);
          const float d0 = o[0] - y4.x, d1 = o[1] - y4.y, d2 = o[2] - y4.z,
                      d3 = o[3] - y4.w;
          lsum += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
          const float s2 = 2.0f * inv_n;
          *reinterpret_cast<float4*>(dy + row * NO) =
              make_float4(s2 * d0, s2 * d1, s2 * d2, s2 * d3);
        }
      }
      __syncwarp();
    }
  }
  if (TRAIN) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    if (k == 0) *loss = lsum * inv_n;
  }
}

// The backward pass through time by one warp (lane k = unit k), from the
// saved steps st and the output gradients dy. Each step's gate gradients
// overwrite its r, z, n, gh_n slots: d(a_r), d(a_z), d(a_n) (= d gi_n) and
// d(gh_n) = d(a_n) r, where a_* are the gates' pre-activations; h stays.
__device__ void backward(const float* __restrict__ wh, const float* s_out,
                         float* __restrict__ st, const float* __restrict__ dy,
                         float* s_g, int T) {
  const int k = threadIdx.x & 31;
  float wrow[G];
#pragma unroll
  for (int j = 0; j < G; ++j) wrow[j] = wh[k * G + j];
  float wo[NO];
#pragma unroll
  for (int c = 0; c < NO; ++c) wo[c] = s_out[k * NO + c];
  float dh = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const float4 d4 = *reinterpret_cast<const float4*>(dy + t * NO);
    dh += (d4.x * wo[0] + d4.y * wo[1]) + (d4.z * wo[2] + d4.w * wo[3]);
    float* s = st + (size_t)t * ROWS * H;
    const float r = s[k], z = s[H + k], n = s[2 * H + k], an = s[3 * H + k];
    const float hp = t > 0 ? s[-H + k] : 0.0f;     // h_{t-1}: row 4 of t-1
    const float dn = dh * (1.0f - z);
    const float dz = dh * (hp - n);
    const float dan = dn * (1.0f - n * n);
    const float dar = (dan * an) * (r * (1.0f - r));
    const float daz = dz * (z * (1.0f - z));
    const float dgn = dan * r;
    s[k] = dar;
    s[H + k] = daz;
    s[2 * H + k] = dan;
    s[3 * H + k] = dgn;
    s_g[k] = dar;
    s_g[H + k] = daz;
    s_g[2 * H + k] = dgn;
    __syncwarp();
    float a0 = dh * z, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int j = 0; j < G; j += 4) {
      const float4 g = *reinterpret_cast<const float4*>(s_g + j);
      a0 = fmaf(wrow[j], g.x, a0);
      a1 = fmaf(wrow[j + 1], g.y, a1);
      a2 = fmaf(wrow[j + 2], g.z, a2);
      a3 = fmaf(wrow[j + 3], g.w, a3);
    }
    __syncwarp();
    dh = (a0 + a1) + (a2 + a3);
  }
}

__global__ void __launch_bounds__(kTrainThreads)
    gru_train_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ wi,
                     const float* __restrict__ wh,
                     const float* __restrict__ bi,
                     const float* __restrict__ wo,
                     const float* __restrict__ bo, float* __restrict__ pred,
                     float* __restrict__ loss, float* __restrict__ gwi,
                     float* __restrict__ gwh, float* __restrict__ gbi,
                     float* __restrict__ gwo, float* __restrict__ gbo,
                     float* __restrict__ ws, int T) {
  __shared__ __align__(16) float s_h[H];
  __shared__ float ring[TT][H + 1];
  __shared__ float s_out[H * NO + NO];
  __shared__ __align__(16) float s_g[G];
  __shared__ float t_h[TT + 1][H];      // h_{t0 - 1} .. h_{t0 + TT - 1}
  __shared__ float t_g[TT][4][H];       // d a_r, d a_z, d a_n, d gh_n
  __shared__ float t_x[TT][NI];
  __shared__ float t_dy[TT][NO];

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* xb = x + b * T * NI;
  float* st = ws + b * T * (ROWS * H + NO);
  float* dyb = st + (size_t)T * ROWS * H;
  for (int i = tid; i < H * NO + NO; i += kTrainThreads)
    s_out[i] = i < H * NO ? wo[b * H * NO + i] : bo[b * NO + i - H * NO];
  __syncthreads();
  if (tid < 32)
    forward<true>(xb, y + b * T * NO, wi + b * NI * G, wh + b * H * G,
                  bi + b * G, s_out, pred + b * T * NO, st, dyb, s_h, ring,
                  T, loss + b);
  __syncthreads();
  if (tid < 32) backward(wh + b * H * G, s_out, st, dyb, s_g, T);
  __syncthreads();

  // The weight gradients: sums over the steps, a tile of TT steps at a
  // time. Threads 0-191: d W_h[k][j] = sum_t h_{t-1}[k] d gh_t[j], thread
  // j + 96 m holding j's 16 units k of half m. Threads 192-255 (u): d W_i
  // and d b_i of gate columns u and u + 64 (u < 32), d W_o[u % 32][2 (u /
  // 32) + c] and, for u < NO, d b_o[u].
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  const int u = tid - 192;
  const int j = tid % G, half = tid / G;
  const int grp = j / H == 2 ? 3 : j / H;   // d gh: d a_r | d a_z | d gh_n
  for (int t0 = 0; t0 < T; t0 += TT) {
    const int nt = min(TT, T - t0);
    for (int i = tid; i < (TT + 1) * H; i += kTrainThreads) {
      const int tt = i / H - 1, q = i % H;
      const int t = t0 + tt;
      t_h[tt + 1][q] = (t >= 0 && tt < nt) ? st[(size_t)t * ROWS * H + 4 * H + q]
                                           : 0.0f;
    }
    for (int i = tid; i < TT * 4 * H; i += kTrainThreads) {
      const int tt = i / (4 * H), rem = i % (4 * H);
      t_g[tt][rem / H][rem % H] =
          tt < nt ? st[(size_t)(t0 + tt) * ROWS * H + rem] : 0.0f;
    }
    for (int i = tid; i < TT * NI; i += kTrainThreads) {
      const int tt = i / NI;
      t_x[tt][i % NI] = tt < nt ? xb[(t0 + tt) * NI + i % NI] : 0.0f;
      t_dy[tt][i % NO] = tt < nt ? dyb[(t0 + tt) * NO + i % NO] : 0.0f;
    }
    __syncthreads();
    if (tid < 2 * G) {
      for (int tt = 0; tt < nt; ++tt) {
        const float g = t_g[tt][grp][j % H];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          acc[i] = fmaf(t_h[tt][16 * half + i], g, acc[i]);
      }
    } else {
      for (int tt = 0; tt < nt; ++tt) {
        const float g0 = t_g[tt][u / H][u % H];
        const float g1 = u < H ? t_g[tt][2][u] : 0.0f;   // column u + 64
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          acc[i] = fmaf(t_x[tt][i], g0, acc[i]);
          acc[NI + i] = fmaf(t_x[tt][i], g1, acc[NI + i]);
        }
        acc[8] += g0;
        acc[9] += g1;
        const float hk = t_h[tt + 1][u % H];
        acc[10] = fmaf(hk, t_dy[tt][2 * (u / H)], acc[10]);
        acc[11] = fmaf(hk, t_dy[tt][2 * (u / H) + 1], acc[11]);
        acc[12] += u < NO ? t_dy[tt][u] : 0.0f;
      }
    }
    __syncthreads();
  }
  if (tid < 2 * G) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      gwh[b * H * G + (16 * half + i) * G + j] = acc[i];
  } else {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      gwi[b * NI * G + i * G + u] = acc[i];
      if (u < H) gwi[b * NI * G + i * G + u + 2 * H] = acc[NI + i];
    }
    gbi[b * G + u] = acc[8];
    if (u < H) gbi[b * G + u + 2 * H] = acc[9];
    gwo[b * H * NO + (u % H) * NO + 2 * (u / H)] = acc[10];
    gwo[b * H * NO + (u % H) * NO + 2 * (u / H) + 1] = acc[11];
    if (u < NO) gbo[b * NO + u] = acc[12];
  }
}

__global__ void __launch_bounds__(kPredictWarps * 32)
    gru_predict_kernel(const float* __restrict__ x,
                       const float* __restrict__ wi,
                       const float* __restrict__ wh,
                       const float* __restrict__ bi,
                       const float* __restrict__ wo,
                       const float* __restrict__ bo, float* __restrict__ pred,
                       int B, int S, int T) {
  __shared__ __align__(16) float s_h[kPredictWarps][H];
  __shared__ float ring[kPredictWarps][TT][H + 1];
  __shared__ float s_out[kPredictWarps][H * NO + NO];
  const int w = threadIdx.x / 32, k = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * kPredictWarps + w;
  if (q >= (long long)B * S) return;       // a whole warp leaves together
  const long long b = q / S;
  for (int i = k; i < H * NO + NO; i += 32)
    s_out[w][i] = i < H * NO ? wo[b * H * NO + i] : bo[b * NO + i - H * NO];
  __syncwarp();
  forward<false>(x + q * T * NI, nullptr, wi + b * NI * G, wh + b * H * G,
                 bi + b * G, s_out[w], pred + q * T * NO, nullptr, nullptr,
                 s_h[w], ring[w], T, nullptr);
}

}  // namespace

// The workspace a block needs, in floats, at T steps.
extern "C" long long gru_workspace_floats(int T) {
  return (long long)T * (ROWS * H + NO);
}

// One training step's gradients for B blocks of one sequence of T steps:
// x (B, T, NI), y (B, T, NO), wi (B, NI, G), wh (B, H, G), bi (B, G), wo
// (B, H, NO), bo (B, NO) in; pred (B, T, NO), loss (B,) and the gradients
// (each its weight's shape) out; ws (B, gru_workspace_floats(T)) scratch.
// Every pointer 16-byte aligned, every array contiguous.
extern "C" int gru_train_launch(const void* x, const void* y, const void* wi,
                                const void* wh, const void* bi,
                                const void* wo, const void* bo, void* pred,
                                void* loss, void* gwi, void* gwh, void* gbi,
                                void* gwo, void* gbo, void* ws, int B, int T,
                                void* stream) {
  if (B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  gru_train_kernel<<<B, kTrainThreads, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(wi), static_cast<const float*>(wh),
      static_cast<const float*>(bi), static_cast<const float*>(wo),
      static_cast<const float*>(bo), static_cast<float*>(pred),
      static_cast<float*>(loss), static_cast<float*>(gwi),
      static_cast<float*>(gwh), static_cast<float*>(gbi),
      static_cast<float*>(gwo), static_cast<float*>(gbo),
      static_cast<float*>(ws), T);
  return (int)cudaGetLastError();
}

// The outputs of B blocks' GRUs on S sequences each: x (B, S, T, NI) ->
// pred (B, S, T, NO), block b's weights for its S sequences.
extern "C" int gru_predict_launch(const void* x, const void* wi,
                                  const void* wh, const void* bi,
                                  const void* wo, const void* bo, void* pred,
                                  int B, int S, int T, void* stream) {
  if (B < 1 || S < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)B * S + kPredictWarps - 1) / kPredictWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  gru_predict_kernel<<<(unsigned)blocks, kPredictWarps * 32, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wi),
      static_cast<const float*>(wh), static_cast<const float*>(bi),
      static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<float*>(pred), B, S, T);
  return (int)cudaGetLastError();
}
