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
// one count): ~2.6 KB, which the card moves in no time next to the
// iterations. Every iteration touches dv * n edges, and the work is data
// dependent (converged codewords stop early). Under min-sum an edge takes
// about 30 issue slots of fp32, compare and shared-memory instructions;
// under sum-product about 34 plus 4 special-function-unit (SFU) operations
// (bp_common.cuh), and the SFU's 16 results a clock on each SM make the
// check pass SFU-bound: at n = 2048 those 4 operations are 0.100 ms of an
// iteration over 12,800 codewords at the 1.98 GHz the card runs, a whole
// iteration 0.142 ms (tools/bench_bp_torch.py). So the time is instruction
// issue and the SFU, with the barriers and the variable pass between them.
//
// Design. The TPU layout (128 codewords on lanes, sublane rolls, one exit per
// 128-codeword tile) is not carried over:
//   * one codeword per thread block, one thread per lifted check (i, z'),
//     or per two (z' and z' + Z / 2 of one base row) where dv * Z threads
//     would fill a block of 1,024 (n = 2048: then two codewords share an
//     SM, and one's variable pass and barriers overlap the other's
//     SFU-bound check pass) or exceed it (n = 3,072 and 4,096, the NBF
//     presets at 64- and 256-QAM: 768 and 1,024 threads, one codeword an
//     SM); checks_per_thread. The static cyclic routing becomes dc byte
//     offsets of (j * Z + (z' - s[i][j]) mod Z) computed once; the second
//     check's are those with the bit of Z / 2 flipped where Z is a power of
//     two (FLIP), else those plus or minus Z / 2 within the column block,
//     the sign from one bit a variable of a register mask (on an H100 at
//     Z = 256 the flip takes 9-13% less time an iteration than the mask,
//     tools/bench_bp_torch.py);
//   * messages never leave the SM: a check's own dc messages stay in
//     registers across all iterations, and a var-domain copy R[i][v]
//     (dv*n f32) plus the channel LLRs and posteriors (2 x n f32) live in
//     shared memory (48 KB at n = 2048, 98 KB at n = 4,096);
//   * two barriers an iteration. The check pass reads the posteriors once
//     for both the rule and the syndrome (their sign parity), writes R, and
//     one __syncthreads_or ends the reads of Lt, publishes R and takes the
//     exit vote; the variable pass, unrolled over the dc * checks / dv
//     variables of a thread, ends in the second;
//   * per-codeword early exit: a codeword stops at its first zero syndrome.
//     Each codeword's trajectory is deterministic, so the bits and stats are
//     the TPU's per-tile-exit ones; and because no codeword waits for a
//     tile, the TPU wrapper's two-pass straggler compaction (pass1_iters)
//     has nothing left to remove: the wrapper keeps the argument and this
//     single pass IS its result;
//   * the same sums as the plain version: var->check q = Lt - r, clipped to
//     +-16; posterior Lt = Lc + (((R0 + R1) + R2) + R3) over the base rows in
//     order; min-sum keeps an online (min, second min, first argmin). Built
//     with --fmad=false, the two min-sum rules match the plain version bit
//     for bit; sum-product differs by the SFU's ulps (the check rules are in
//     bp_common.cuh, shared with the layered kernel);
//   * the natural-order permutation is fused: LLRs are read from pipeline
//     order through inv_perm and bits written back the same way; counts mode
//     compares the info columns against the truth in the kernel and writes
//     one count per codeword (no (n, B) bits tensor at all).
//
// Beside the decode the source holds its attribution builds (template
// argument DIAG, launched only by tools/bench_bp_torch.py) and the
// sum-product rule's two functions on their own (chip_smoke.py [K1 rule]).

#include "bp_common.cuh"

namespace {

using namespace bp;

// One codeword a block. A thread owns CPT checks of one base row: lifted
// indices z' and, for CPT = 2, z' + Z / 2. CPT = 1 takes dv * Z threads
// (256 at n = 512), CPT = 2 half as many (512 at n = 2048, 768 and 1,024 at
// n = 3,072 and 4,096). The bound keeps nvcc at <= 64 registers a thread,
// so that two blocks of 512 share an SM.
constexpr int kMaxThreads = 1024;
constexpr int kMaxZ = 2 * kMaxThreads / kDv;  // 512: two checks a thread

// Checks a thread owns at lifting size Z, 0 where the kernel takes no such
// code: 2 where dv * Z threads would fill a block of 1,024 and hold an SM
// alone, so two codewords share it (the sum-product check pass keeps the
// SFU busy, the variable pass and the barriers do not, and a second
// codeword fills those gaps), or exceed it (Z up to 512); Z even there.
// Else 1.
__host__ __device__ constexpr int checks_per_thread(int Z) {
  return (Z <= 0 || Z > kMaxZ || (kDv * Z >= kMaxThreads && Z % 2 != 0)) ? 0
         : kDv * Z >= kMaxThreads                                       ? 2
                                                                        : 1;
}

// Switches of the attribution builds (tools/bench_bp_torch.py; a mask, the
// decode is DIAG = 0). Each build holds kDiagFixed; their results are wrong
// by design.
enum Diag {
  kDiagFixed = 1,         // no exit: every codeword runs `cap` iterations
  kDiagCopyRule = 2,      // the check rule returns its inputs
  kDiagNoSyndrome = 4,    // no parity and no vote
  kDiagNoVarUpdate = 8,   // the posteriors stay the channel LLRs
};

template <int DC, int DV, int CPT, bool FLIP, int DIAG>
__global__ void __launch_bounds__(kMaxThreads) bp_flooding_kernel(
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
  extern __shared__ float smem[];
  const int n = DC * Z;
  float* Lc = smem;            // (n,) channel LLRs, natural order
  float* Lt = Lc + n;          // (n,) posteriors
  float* R = Lt + n;           // (DV, n) check->var messages, var domain
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;  // == DV * Z / CPT: DC * CPT / DV variables each
  const int b = blockIdx.x;
  const int zs = Z / CPT;       // lifted indices a row's threads cover
  const int row = tid / zs;     // base row i
  const int zc = tid % zs;      // lifted index z' of this thread's first check

  // byte offset in an (n,) array of variable j of the first check: column
  // block j, lifted index (z' - s[i][j]) mod Z; the second check's is this
  // one with the bit of Z / 2 flipped (FLIP: Z a power of two) or plus Z / 2
  // where that stays in the column block (bit j of wrap clear), else minus
  // Z / 2 (second below)
  int off[DC];
  unsigned wrap = 0;
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    int z = (zc - shifts[row * DC + j]) % Z;
    z = z < 0 ? z + Z : z;
    off[j] = 4 * (j * Z + z);
    if (!FLIP) wrap |= (z >= Z / 2 ? 1u : 0u) << j;
  }
  const int half = 2 * Z;  // bytes of Z / 2 floats
  auto second = [&](int j) {
    return FLIP ? off[j] ^ half
                : off[j] + (((wrap >> j) & 1u) ? -half : half);
  };
  const float* lb = llr + (size_t)b * n;
  for (int v = tid; v < n; v += nthr) {
    float x = lb[inv_perm[v]];
    Lc[v] = x;
    Lt[v] = x;
  }
  float r[CPT][DC];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int j = 0; j < DC; ++j) r[c][j] = 0.0f;
  __syncthreads();

  // Each pass of the loop is one check pass and, unless the codeword stops,
  // one variable pass. The check pass reads the posteriors Lt of the
  // iteration's start once: their sign parity is this check's syndrome, and
  // q = Lt - r feeds the check rule. One barrier then ends every read of
  // Lt, publishes R and takes the exit vote; a codeword whose syndrome is
  // zero stops there with iterations = it and its bits from this Lt (the
  // check just computed is discarded). At the cap only the vote runs.
  const char* LtB = reinterpret_cast<const char*>(Lt);
  char* RrowB = reinterpret_cast<char*>(R + row * n);
  int it = 0;
  bool ok;
  for (;;) {
    if constexpr (CPT == 2) {
      // keep the 8 offsets live across the loop, not the 32 addresses
      // nvcc would hoist from them: those need more than the 64 registers
      // of two blocks an SM and spill (44 B a thread, ptxas)
#pragma unroll
      for (int j = 0; j < DC; ++j) asm volatile("" : "+r"(off[j]));
      if constexpr (!FLIP) asm volatile("" : "+r"(wrap));
    }
    int par = 0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      float lt[DC];
      int pc = 0;
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        lt[j] = *reinterpret_cast<const float*>(
            LtB + (c == 0 ? off[j] : second(j)));
        pc ^= (lt[j] < 0.0f) ? 1 : 0;
      }
      par |= pc;
      if (it < cap) {
        float q[DC];  // var->check messages, clipped by the rule
#pragma unroll
        for (int j = 0; j < DC; ++j) q[j] = lt[j] - r[c][j];
        if constexpr ((DIAG & kDiagCopyRule) != 0) {
#pragma unroll
          for (int j = 0; j < DC; ++j) r[c][j] = clip_msg(q[j]);
        } else {
          check_update<DC>(q, r[c], algo, scale, offset);
        }
#pragma unroll
        for (int j = 0; j < DC; ++j)
          *reinterpret_cast<float*>(RrowB + (c == 0 ? off[j] : second(j))) =
              r[c][j];
      }
    }
    int bad;
    if constexpr ((DIAG & kDiagNoSyndrome) != 0) {
      __syncthreads();
      bad = 1;
    } else {
      bad = __syncthreads_or(par);
    }
    ok = (DIAG & kDiagFixed) ? false : !bad;
    if (ok || it == cap) break;
    // ---- variable update: posterior in the plain version's order ----
    if constexpr ((DIAG & kDiagNoVarUpdate) == 0) {
#pragma unroll
      for (int u = 0; u < DC * CPT / DV; ++u) {
        const int v = tid + u * nthr;
        float s = R[v];
#pragma unroll
        for (int i = 1; i < DV; ++i) s = s + R[i * n + v];
        Lt[v] = Lc[v] + s;
      }
    }
    __syncthreads();  // Lt complete; every read of R is done
    ++it;
  }

  write_result(Lt, n, b, ok, it, cap, inv_perm, truth, info_cols, k, bits,
               err, iters, conv);
}

template <int DC, int DV, int CPT, bool FLIP, int DIAG>
int launch_cpt(const float* llr, const int* inv_perm, const int* shifts,
               const int8_t* truth, const int* info_cols, int8_t* bits,
               int* err, int* iters, uint8_t* conv, int B, int Z, int k,
               int cap, int algo, float scale, float offset,
               cudaStream_t stream) {
  const int threads = DV * Z / CPT;
  const size_t smem = sizeof(float) * (size_t)(2 + DV) * DC * Z;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bp_flooding_kernel<DC, DV, CPT, FLIP, DIAG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bp_flooding_kernel<DC, DV, CPT, FLIP, DIAG><<<B, threads, smem, stream>>>(
      llr, inv_perm, shifts, truth, info_cols, bits, err, iters, conv, Z, k,
      cap, algo, scale, offset);
  return (int)cudaGetLastError();
}

// The attribution builds take the FLIP offsets only (at CPT = 2 the mask's
// spill 28 B in one of them).
template <int DC, int DV, int DIAG>
int launch(const float* llr, const int* inv_perm, const int* shifts,
           const int8_t* truth, const int* info_cols, int8_t* bits, int* err,
           int* iters, uint8_t* conv, int B, int Z, int k, int cap,
           int algo, float scale, float offset, cudaStream_t stream) {
  if (B <= 0) return 0;
  const int cpt = checks_per_thread(Z);
  if (cpt == 0) return (int)cudaErrorInvalidValue;
#define BP_CPT(CPT, FLIP)                                                   \
  launch_cpt<DC, DV, CPT, FLIP, DIAG>(llr, inv_perm, shifts, truth,         \
                                      info_cols, bits, err, iters, conv, B, \
                                      Z, k, cap, algo, scale, offset, stream)
  if (cpt == 1) return BP_CPT(1, true);
  if ((Z & (Z - 1)) == 0) return BP_CPT(2, true);
  if constexpr (DIAG != 0) return (int)cudaErrorInvalidValue;
  else return BP_CPT(2, false);
#undef BP_CPT
}

// The sum-product rule's two functions elementwise (chip_smoke.py [K1 rule]
// holds them against float64): which = 0 gives tanh(x / 2), 1
// log((1 + x) / (1 - x)).
__global__ void bp_sumprod_rule_kernel(const float* __restrict__ x,
                                       float* __restrict__ y, int n,
                                       int which) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = which == 0 ? tanh_half(x[i]) : log_ratio(x[i]);
}

}  // namespace

// Checks a thread of the flooding kernel owns at lifting size Z, 0 where it
// takes no such code (ldpc/decode_cuda.py:bp_plan mirrors it).
extern "C" int bp_decode_checks_per_thread(int Z) {
  return checks_per_thread(Z);
}

extern "C" int bp_sumprod_rule_launch(const float* x, float* y, int n,
                                      int which, void* stream) {
  if (n <= 0) return 0;
  bp_sumprod_rule_kernel<<<(n + 255) / 256, 256, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      x, y, n, which);
  return (int)cudaGetLastError();
}

#define BP_DECODE_ARGS                                                      \
  const float *llr, const int *inv_perm, const int *shifts,                 \
      const int8_t *truth, const int *info_cols, int8_t *bits, int *err,    \
      int *iters, uint8_t *conv, int B, int Z, int dv, int dc, int k,       \
      int cap, int algo, float scale, float offset
#define BP_LAUNCH(DIAG)                                                     \
  launch<kDc, kDv, DIAG>(llr, inv_perm, shifts, truth, info_cols, bits, err, \
                         iters, conv, B, Z, k, cap, algo, scale, offset,     \
                         reinterpret_cast<cudaStream_t>(stream))

extern "C" int bp_decode_launch(BP_DECODE_ARGS, void* stream) {
  if (dc != kDc || dv != kDv) return (int)cudaErrorInvalidValue;
  return BP_LAUNCH(0);
}

// The attribution builds, launched only by tools/bench_bp_torch.py; the
// masks are ldpc/decode_cuda.py:DIAG_BUILDS.
extern "C" int bp_decode_diag_launch(BP_DECODE_ARGS, int diag, void* stream) {
  if (dc != kDc || dv != kDv) return (int)cudaErrorInvalidValue;
  switch (diag) {
    case kDiagFixed: return BP_LAUNCH(kDiagFixed);
    case kDiagFixed | kDiagCopyRule: return BP_LAUNCH(kDiagFixed | kDiagCopyRule);
    case kDiagFixed | kDiagNoSyndrome:
      return BP_LAUNCH(kDiagFixed | kDiagNoSyndrome);
    case kDiagFixed | kDiagNoVarUpdate:
      return BP_LAUNCH(kDiagFixed | kDiagNoVarUpdate);
    case kDiagFixed | kDiagCopyRule | kDiagNoSyndrome | kDiagNoVarUpdate:
      return BP_LAUNCH(kDiagFixed | kDiagCopyRule | kDiagNoSyndrome |
                       kDiagNoVarUpdate);
    default: return (int)cudaErrorInvalidValue;
  }
}
