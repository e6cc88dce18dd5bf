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
// bp_decode.cu; the sum-product rule is shared (bp_common.cuh).
//
// What bounds it on the H100. As for flooding: ~2.6 KB of device memory per
// codeword, and up to `cap` sweeps over dv*dc*Z edges in between, so the
// time is instruction issue, shared-memory access, barriers and, under
// sum-product, the special-function unit (4 SFU operations an edge,
// bp_common.cuh); it depends on the data (a codeword stops at its first
// zero syndrome). tools/bench_bp_torch.py --ptxas counts the sweep loop's
// instructions an edge and sets them beside the card's issue rate.
//
// Design. Within a layer every variable belongs to exactly one check, so the
// Z checks of a layer update Lt in place without atomics, but layers must
// follow one another. A block is one codeword and has Z threads (64 at
// n = 512, 256 at n = 2048, 384 and 512 at n = 3,072 and 4,096); thread z'
// owns check z' of EVERY base row and walks the dv rows in turn:
//   * the byte offsets of its 32 variables in Lt stay in registers (loops
//     over rows and edges are unrolled); its 32 check->var messages stay in
//     shared memory, a padded row of its own read and written as float4.
//     That keeps every build at 64 registers: 16 codewords an SM at Z = 64,
//     4 at Z = 256, 2 at Z = 384 and 512 (messages in registers took 92-98
//     and 10 / 2 / 1 / 1, and were 1-8% slower a decode);
//   * the check rule is a template argument, so each rule's build holds
//     only its own code. The min-sum rules take the form of `minsum_rule`
//     below: ~8 issue slots an edge where the shared rule's online (min,
//     second min, argmin) with float signs took ~17;
//   * the posteriors never hold -0.0: the channel LLRs are loaded as
//     llr + 0.0 (which turns -0.0 into +0.0 and leaves every other value),
//     and a difference or sum of IEEE floats is -0.0 only when an operand
//     is. So a raw sign bit is the plain version's `< 0` for q and Lt, and
//     parities are XORs of whole words;
//   * the syndrome costs almost nothing: the last row's check parities come
//     from its update in registers, and their block-wide OR rides on the
//     barrier that ends the sweep; only where all of them are zero does the
//     block read the other rows' posteriors and vote again (the first
//     row's, read for that, feed the next sweep). Four barriers a sweep;
//     with one codeword per block the per-codeword exit stays a block-wide
//     vote, and the wrapper's pass1_iters has nothing to compact;
//   * one subtract and one add per edge and no sum over rows: there is no
//     summation order to match, and with --fmad=false both min-sum rules are
//     bit-identical to the plain version; sum-product differs by the SFU's
//     ulps (the rule clips q itself, so the posterior's unclipped q is the
//     rule's input);
//   * the channel LLRs only initialise Lt; permutation, counts mode and the
//     runtime cap are as in the flooding kernel.
//
// Beside the decode the source holds its attribution builds (template
// argument DIAG, launched only by tools/bench_bp_torch.py) and the layout
// queries ldpc/decode_cuda.py reads (shared memory, occupancy).

#include "bp_common.cuh"

namespace {

using namespace bp;

// Z threads a block, up to Z = 512 (n = 4,096): at most 128 registers a
// thread (the builds take 64).
constexpr int kMaxThreads = 512;

// Switches of the attribution builds (tools/bench_bp_torch.py; a mask, the
// decode is DIAG = 0). Each build holds kDiagFixed; their results are wrong
// by design.
enum Diag {
  kDiagFixed = 1,         // no exit: every codeword runs `cap` sweeps
  kDiagCopyRule = 2,      // the check rule returns its clipped inputs
  kDiagNoSyndrome = 4,    // no parity, no reads for it and no vote
  kDiagNoPosterior = 8,   // no posterior write: Lt stays the channel LLRs
};

__device__ __forceinline__ unsigned word(float x) { return __float_as_uint(x); }

// a ^ (b & 0x80000000): a sign bit XORed onto a word, one LOP3 (nvcc
// otherwise splits the min-sum rule's sign into two an edge)
__device__ __forceinline__ unsigned xor_sign(unsigned a, unsigned b) {
  unsigned d;  // LUT of a ^ (b & c): 0xf0 ^ (0xcc & 0xaa)
  asm("lop3.b32 %0, %1, %2, %3, 0x78;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80000000u));
  return d;
}

// The min-sum rules (RULE kMinSum: scale * loo, kOffsetMinSum: max(loo -
// offset, 0)) on one check, in the form the plain version
// ldpc/decode.py:minsum_form writes out. q holds no -0.0, so its sign bit is
// q < 0:
//   * a = min(|q|, 16); m1 <= m2, the two smallest of the a (with repeats),
//     from a tree of pairs: a pair gives (min, max), two merge as m1 =
//     min(m1, m1'), m2 = min(max(m1, m1'), min(m2, m2'));
//   * the magnitude of rule(loo) is computed twice a check, f(m1) and
//     f(m2), and takes the XOR of the dc sign bits (the check's sign);
//   * edge j gets f(m2) where a[j] == m1, else f(m1): the first argmin gets
//     m2 as in the plain version, and where several a equal m1, m2 == m1 so
//     which of them is "first" does not matter; then its own sign bit is
//     XORed in, which leaves the sign of the others' product. A sign bit
//     XORed onto a non-negative float is the plain version's multiply by
//     +-1, -0.0 included.
template <int DC, int RULE>
__device__ __forceinline__ void minsum_rule(const float (&q)[DC],
                                            float (&r)[DC], float scale,
                                            float offset) {
  static_assert(DC == 8, "the tree of pairs is written for dc = 8");
  float a[DC];
  unsigned par = 0;
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    a[j] = fminf(fabsf(q[j]), kMsgClip);
    par ^= word(q[j]);
  }
  float lo[DC / 2], hi[DC / 2];
#pragma unroll
  for (int p = 0; p < DC / 2; ++p) {
    lo[p] = fminf(a[2 * p], a[2 * p + 1]);
    hi[p] = fmaxf(a[2 * p], a[2 * p + 1]);
  }
#pragma unroll
  for (int w = 1; w < DC / 2; w *= 2)
#pragma unroll
    for (int p = 0; p < DC / 2; p += 2 * w) {
      const float m2 = fminf(fmaxf(lo[p], lo[p + w]),
                             fminf(hi[p], hi[p + w]));
      lo[p] = fminf(lo[p], lo[p + w]);
      hi[p] = m2;
    }
  const float m1 = lo[0];
  const float f1 = RULE == kOffsetMinSum ? fmaxf(m1 - offset, 0.0f)
                                         : scale * m1;
  const float f2 = RULE == kOffsetMinSum ? fmaxf(hi[0] - offset, 0.0f)
                                         : scale * hi[0];
  const unsigned s1 = xor_sign(word(f1), par), s2 = xor_sign(word(f2), par);
#pragma unroll
  for (int j = 0; j < DC; ++j)
    r[j] = __uint_as_float(xor_sign(a[j] == m1 ? s2 : s1, word(q[j])));
}

// Floats of a thread's row of check->var messages in shared memory: dv * dc
// and a pad of 4, so that rows stay 16-byte aligned for float4 access and
// the 8 threads of a float4 phase fall on distinct banks (144 B apart).
constexpr int kMsgRow = kDv * kDc + 4;

// Dynamic shared memory of a block at lifting size Z, 0 where the kernel
// takes no such code: the posteriors (n = dc * Z floats) and the messages
// (Z rows), 176 * Z bytes: 11 KB at Z = 64, 88 KB at Z = 512.
__host__ __device__ constexpr int smem_bytes(int Z) {
  return (Z <= 0 || Z > kMaxThreads) ? 0 : (int)sizeof(float) * (kDc + kMsgRow) * Z;
}

template <int RULE, int DIAG>
__global__ void __launch_bounds__(kMaxThreads) bp_layered_kernel(
    const float* __restrict__ llr,       // (B, n) pipeline order
    const int* __restrict__ inv_perm,    // (n,) pipeline position of natural v
    const int* __restrict__ shifts,      // (kDv, kDc) circulant shifts
    const int8_t* __restrict__ truth,    // (B, k) info bits, counts mode
    const int* __restrict__ info_cols,   // (k,) natural column of info bit i
    int8_t* __restrict__ bits,           // (B, n) pipeline order, bits mode
    int* __restrict__ err,               // (B,) info-bit errors, counts mode
    int* __restrict__ iters,             // (B,)
    uint8_t* __restrict__ conv,          // (B,)
    int Z, int k, int cap, float scale, float offset) {
  extern __shared__ __align__(16) float smem[];
  const int n = kDc * Z;
  float* Lt = smem;              // (n,) posteriors, natural order
  const int zc = threadIdx.x;    // lifted index z' of this thread's checks
  const int b = blockIdx.x;
  // this thread's check->var messages, row i's dc at msg[i * dc / 4 ..]
  float4* msg = reinterpret_cast<float4*>(smem + n + zc * kMsgRow);

  // byte offset in Lt of edge j of check (i, z'): column block j, lifted
  // index (z' - s[i][j]) mod Z
  int off[kDv][kDc];
#pragma unroll
  for (int i = 0; i < kDv; ++i)
#pragma unroll
    for (int j = 0; j < kDc; ++j) {
      int z = (zc - shifts[i * kDc + j]) % Z;
      off[i][j] = 4 * (j * Z + (z < 0 ? z + Z : z));
    }
  const float* lb = llr + (size_t)b * n;
  for (int v = zc; v < n; v += Z) Lt[v] = lb[inv_perm[v]] + 0.0f;  // no -0.0
#pragma unroll
  for (int c = 0; c < kDv * kDc / 4; ++c)
    msg[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  char* LtB = reinterpret_cast<char*>(Lt);
  auto at = [&](int o) -> float& {
    return *reinterpret_cast<float*>(LtB + o);
  };
  // the posteriors of row i's check; their sign bits' XOR in bit 31
  auto load = [&](int i, float (&lt)[kDc]) {
    unsigned p = 0;
#pragma unroll
    for (int j = 0; j < kDc; ++j) {
      lt[j] = at(off[i][j]);
      p ^= word(lt[j]);
    }
    return p;
  };
  unsigned sink = 0;  // keeps the rule's results of the no-posterior builds
  // row i's check update from its posteriors lt; returns the parity word of
  // the new posteriors (in the no-posterior builds one with bit 31 set, so
  // that they take the decode's usual path: no full syndrome)
  auto layer = [&](int i, const float (&lt)[kDc]) {
    float ri[kDc];
#pragma unroll
    for (int c = 0; c < kDc / 4; ++c) {
      const float4 m = msg[i * kDc / 4 + c];
      ri[4 * c] = m.x, ri[4 * c + 1] = m.y, ri[4 * c + 2] = m.z,
      ri[4 * c + 3] = m.w;
    }
    float q[kDc];  // unclipped: it rebuilds the posterior; the rule clips
#pragma unroll
    for (int j = 0; j < kDc; ++j) q[j] = lt[j] - ri[j];
    if constexpr ((DIAG & kDiagCopyRule) != 0) {
#pragma unroll
      for (int j = 0; j < kDc; ++j) ri[j] = clip_msg(q[j]);
    } else if constexpr (RULE == kSumProd) {
      sumprod_rule<kDc, false>(q, ri);  // no clip of p: it never binds
    } else {
      minsum_rule<kDc, RULE>(q, ri, scale, offset);
    }
#pragma unroll
    for (int c = 0; c < kDc / 4; ++c)
      msg[i * kDc / 4 + c] = make_float4(ri[4 * c], ri[4 * c + 1],
                                         ri[4 * c + 2], ri[4 * c + 3]);
    unsigned p = (DIAG & kDiagNoPosterior) != 0 ? 0x80000000u : 0u;
#pragma unroll
    for (int j = 0; j < kDc; ++j) {
      if constexpr ((DIAG & kDiagNoPosterior) != 0) {
        sink ^= word(ri[j]);
      } else {
        const float x = q[j] + ri[j];
        at(off[i][j]) = x;
        p ^= word(x);
      }
    }
    return p;
  };

  // The syndrome. A block-wide OR of the last row's check parities rides
  // on the barrier that ends each sweep (and on one after the channel
  // LLRs load); only where every check of the last row is satisfied does
  // the block read the other rows' posteriors and vote again. So most
  // sweeps read Lt 32 times a thread and pass 4 barriers; the exit is the
  // plain version's (first sweep with a zero syndrome).
  constexpr bool kSyndrome = (DIAG & kDiagNoSyndrome) == 0;
  float lt[kDc];
  bool last_ok = false;  // every check of the last row satisfied
  if constexpr (kSyndrome)
    last_ok = !__syncthreads_or(load(kDv - 1, lt) >> 31);
  int it = 0;
  bool ok = false;
  for (;;) {
    float lt0[kDc];  // row 0's posteriors: the syndrome's and row 0's
    unsigned par = load(0, lt0);
    if (last_ok) {  // block-uniform
#pragma unroll
      for (int i = 1; i < kDv - 1; ++i) par |= load(i, lt);
      ok = !__syncthreads_or(par >> 31) && (DIAG & kDiagFixed) == 0;
    }
    if (ok || it == cap) break;
    layer(0, lt0);
    __syncthreads();  // the next row reads what this one wrote
#pragma unroll
    for (int i = 1; i < kDv - 1; ++i) {
      load(i, lt);
      layer(i, lt);
      __syncthreads();
    }
    load(kDv - 1, lt);
    const unsigned p_last = layer(kDv - 1, lt);
    if constexpr (kSyndrome) {
      last_ok = !__syncthreads_or(p_last >> 31);
    } else {
      __syncthreads();
    }
    ++it;
  }

  write_result(Lt, n, b, ok, it, cap, inv_perm, truth, info_cols, k, bits,
               err, iters, conv);
  if ((DIAG & kDiagNoPosterior) != 0 && sink == 0x7fc00001u) conv[b] = 2;
}

#define BP_DECODE_ARGS                                                      \
  const float *llr, const int *inv_perm, const int *shifts,                 \
      const int8_t *truth, const int *info_cols, int8_t *bits, int *err,    \
      int *iters, uint8_t *conv, int B, int Z, int dv, int dc, int k,       \
      int cap, int algo, float scale, float offset

// The decode kernel of a rule (and attribution mask), for the launch and
// the occupancy query; nullptr for an unknown rule.
template <int DIAG>
auto kernel_of(int algo) -> decltype(&bp_layered_kernel<kSumProd, DIAG>) {
  switch (algo) {
    case kSumProd: return bp_layered_kernel<kSumProd, DIAG>;
    case kMinSum: return bp_layered_kernel<kMinSum, DIAG>;
    case kOffsetMinSum: return bp_layered_kernel<kOffsetMinSum, DIAG>;
    default: return nullptr;
  }
}

// The kernel of the rule and mask, allowed its shared memory (above 48 KB
// only by opt-in: Z > 279); nullptr where it takes no such launch.
template <int DIAG>
auto ready_kernel(int Z, int algo) -> decltype(kernel_of<DIAG>(algo)) {
  const auto kern = kernel_of<DIAG>(algo);
  const int smem = smem_bytes(Z);
  if (smem == 0 || kern == nullptr) return nullptr;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return nullptr;
  return kern;
}

template <int DIAG>
int launch(BP_DECODE_ARGS, cudaStream_t stream) {
  if (B <= 0) return 0;
  const auto kern = ready_kernel<DIAG>(Z, algo);
  const size_t smem = smem_bytes(Z);
  if (dv != kDv || dc != kDc || kern == nullptr)
    return (int)cudaErrorInvalidValue;
  kern<<<B, Z, smem, stream>>>(llr, inv_perm, shifts, truth, info_cols, bits,
                               err, iters, conv, Z, k, cap, scale, offset);
  return (int)cudaGetLastError();
}

#define BP_LAUNCH(DIAG)                                                     \
  launch<DIAG>(llr, inv_perm, shifts, truth, info_cols, bits, err, iters,   \
               conv, B, Z, dv, dc, k, cap, algo, scale, offset,             \
               reinterpret_cast<cudaStream_t>(stream))

}  // namespace

extern "C" int bp_decode_layered_launch(BP_DECODE_ARGS, void* stream) {
  return BP_LAUNCH(0);
}

// Registers a thread and resident blocks an SM of the decode kernel of rule
// `algo` at lifting size Z (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// chip_smoke.py prints them beside ldpc/decode_cuda.py:bp_plan.
extern "C" int bp_decode_layered_occupancy(int Z, int algo, int* regs,
                                           int* blocks_per_sm) {
  const auto kern = ready_kernel<0>(Z, algo);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kern, Z, smem_bytes(Z));
}

// Dynamic shared memory of a block at lifting size Z, 0 where the kernel
// takes no such code (ldpc/decode_cuda.py:layered_smem_bytes mirrors it).
extern "C" int bp_decode_layered_smem_bytes(int Z) { return smem_bytes(Z); }

// The attribution builds, launched only by tools/bench_bp_torch.py; the
// masks are ldpc/decode_cuda.py:DIAG_BUILDS.
extern "C" int bp_decode_layered_diag_launch(BP_DECODE_ARGS, int diag,
                                             void* stream) {
  switch (diag) {
    case kDiagFixed: return BP_LAUNCH(kDiagFixed);
    case kDiagFixed | kDiagCopyRule: return BP_LAUNCH(kDiagFixed | kDiagCopyRule);
    case kDiagFixed | kDiagNoSyndrome:
      return BP_LAUNCH(kDiagFixed | kDiagNoSyndrome);
    case kDiagFixed | kDiagNoPosterior:
      return BP_LAUNCH(kDiagFixed | kDiagNoPosterior);
    case kDiagFixed | kDiagCopyRule | kDiagNoSyndrome | kDiagNoPosterior:
      return BP_LAUNCH(kDiagFixed | kDiagCopyRule | kDiagNoSyndrome |
                       kDiagNoPosterior);
    default: return (int)cudaErrorInvalidValue;
  }
}
