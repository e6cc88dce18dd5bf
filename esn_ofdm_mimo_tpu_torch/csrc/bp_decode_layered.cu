// Row-layered (serial-C) belief-propagation decoder for quasi-cyclic LDPC
// codes, Hopper.
//
// Replaces the layered branch of the TPU kernel
// esn_ofdm_mimo_tpu/ldpc/decode_pallas.py:_bp_kernel (schedule="layered",
// launched by _decode_padded). The plain version it is held against is
// esn_ofdm_mimo_tpu_torch/ldpc/decode.py (_decode_layered). One sweep updates
// the dv base rows in turn; row i reads the posteriors the rows before it
// just refreshed:
//     q = Lt - r_i          (unclipped: it rebuilds the posterior)
//     r_i' = check(clip(q, +-16))
//     Lt = q + r_i'
// and the syndrome is checked after every sweep. The flooding kernel is
// bp_decode.cu; the check rules are shared (bp_common.cuh).
//
// What bounds it on the H100. As for flooding: ~2.6 KB of device memory per
// codeword, and up to `cap` sweeps over dv*dc*Z edges in between, so the
// time is instruction throughput, shared-memory access and barriers, and depends
// on the data (a codeword stops at its first zero syndrome).
//
// Design. Within a layer every variable belongs to exactly one check, so the
// Z checks of a layer update Lt in place without atomics, but layers must
// follow one another. The flooding kernel's map (one thread per lifted check
// (i, z'), dv*Z threads) would leave dv-1 of every dv threads idle inside a
// layer. Here a block is one codeword and has Z threads (64 at n = 512, 256
// at n = 2048); thread z' owns check z' of EVERY base row and walks the dv
// rows in turn:
//   * its dv*dc = 32 check->var messages stay in registers for all sweeps
//     (loops over rows and edges are unrolled, DV and DC are template
//     arguments); the only shared memory is the posterior Lt (n f32: 2 KB or
//     8 KB), so many codewords share an SM and no thread idles;
//   * one __syncthreads between layers, and the syndrome's
//     __syncthreads_or closes the sweep; with one codeword per block the
//     per-codeword exit stays a block-wide vote, as in the flooding kernel,
//     and the wrapper's pass1_iters has nothing to compact;
//   * one subtract and one add per edge and no sum over rows: there is no
//     summation order to match, and with --fmad=false both min-sum rules are
//     bit-identical to the plain version; sum-product differs by the
//     libraries' tanh/atanh ulps;
//   * the channel LLRs only initialise Lt; permutation, counts mode and the
//     runtime cap are as in the flooding kernel.

#include "bp_common.cuh"

namespace {

using namespace bp;

constexpr int kDv = 4;           // variable degree of every code the presets build
constexpr int kMaxThreads = 256;  // Z <= 256 (n = 2048)

template <int DV, int DC>
__global__ void __launch_bounds__(kMaxThreads) bp_layered_kernel(
    const float* __restrict__ llr,       // (B, n) pipeline order
    const int* __restrict__ inv_perm,    // (n,) pipeline position of natural v
    const int* __restrict__ shifts,      // (DV, DC) circulant shifts
    const int8_t* __restrict__ truth,    // (B, k) info bits, counts mode
    const int* __restrict__ info_cols,   // (k,) natural column of info bit i
    int8_t* __restrict__ bits,           // (B, n) pipeline order, bits mode
    int* __restrict__ err,               // (B,) info-bit errors, counts mode
    int* __restrict__ iters,             // (B,)
    uint8_t* __restrict__ conv,          // (B,)
    int Z, int k, int cap, int algo, float scale, float offset) {
  extern __shared__ float Lt[];  // (n,) posteriors, natural order
  const int n = DC * Z;
  const int zc = threadIdx.x;    // lifted index z' of this thread's checks
  const int b = blockIdx.x;

  // variable of edge j of check (i, z'): column block j, lifted index
  // (z' - s[i][j]) mod Z
  int vj[DV][DC];
#pragma unroll
  for (int i = 0; i < DV; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      int z = (zc - shifts[i * DC + j]) % Z;
      vj[i][j] = j * Z + (z < 0 ? z + Z : z);
    }
  const float* lb = llr + (size_t)b * n;
  for (int v = zc; v < n; v += Z) Lt[v] = lb[inv_perm[v]];
  float r[DV][DC];
#pragma unroll
  for (int i = 0; i < DV; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) r[i][j] = 0.0f;
  __syncthreads();

  auto syndrome_bad = [&]() {
    int par = 0;
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      int p = 0;
#pragma unroll
      for (int j = 0; j < DC; ++j) p ^= (Lt[vj[i][j]] < 0.0f) ? 1 : 0;
      par |= p;
    }
    return __syncthreads_or(par);  // also: every read of Lt is done
  };

  int it = 0;
  bool ok = !syndrome_bad();
  while (!ok && it < cap) {
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      float q[DC], qc[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        q[j] = Lt[vj[i][j]] - r[i][j];
        qc[j] = clip_msg(q[j]);
      }
      check_update<DC>(qc, r[i], algo, scale, offset);
#pragma unroll
      for (int j = 0; j < DC; ++j) Lt[vj[i][j]] = q[j] + r[i][j];
      __syncthreads();  // the next layer reads what this one wrote
    }
    ++it;
    ok = !syndrome_bad();
  }

  write_result(Lt, n, b, ok, it, cap, inv_perm, truth, info_cols, k, bits,
               err, iters, conv);
}

}  // namespace

extern "C" int bp_decode_layered_launch(
    const float* llr, const int* inv_perm, const int* shifts,
    const int8_t* truth, const int* info_cols, int8_t* bits, int* err,
    int* iters, uint8_t* conv, int B, int Z, int dv, int dc, int k, int cap,
    int algo, float scale, float offset, void* stream) {
  if (B <= 0) return 0;
  if (Z <= 0 || Z > kMaxThreads || dv != kDv || dc != kDc)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kDc * Z;
  bp_layered_kernel<kDv, kDc>
      <<<B, Z, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
          llr, inv_perm, shifts, truth, info_cols, bits, err, iters, conv, Z,
          k, cap, algo, scale, offset);
  return (int)cudaGetLastError();
}
