// Ablation builds of the ESN predict recurrence (K5), Hopper, fp32.
//
// Replaces the TPU kernel factory tools/bench_micro.py:_mk_kernel (launched
// by run_pred_variants): builds of the predict recurrence with parts switched
// off at compile time, so that a micro-benchmark can attribute the step time
// to the readout, the feedback term, the state noise, the tanh and the
// recurrence product. What a switched-off part computes instead is the
// micro-benchmark's definition (esn_predict_core.cuh, enum Off). The plain
// version each build is held against is
// esn_ofdm_mimo_tpu_torch/models/esn.py:esn_predict_ablate with the same
// switches. The kernel is K2's (esn_predict_core.cuh) with a third template
// argument; the full build (mask 0) is K2's code under another name.
//
// What bounds it. With every part on, K2's bound (fp32 arithmetic of the
// recurrence product, esn_predict.cu) plus the micro-benchmark's readout
// layout: one readout per row (Dg = 1), (n_res + n_in) x n_out floats each,
// 96 MB at 9,472 rows, more than the L2 holds and read again at every step,
// so the full builds also move ~13 GB through device memory (~4 ms). With
// the recurrence product off the work falls to the input product, and the
// floor build is bound by its reads of u and writes of o.
//
// The TPU factory's other arguments (merged io-dot, hoisted input product,
// unroll) choose how the TPU schedules the same function. This kernel always
// contracts the one stacked weight [Wt; W_in_t; W_fb_t], so they have no
// counterpart here and select no build.
//
// Builds: the full recurrence, each single part off, and the floor (all
// five off), for ceil(n_res / 64) == 5 (the micro-benchmark's n_res = 300)
// and the 72-row tile, which the wrapper's tiling is held to. Another mask,
// width or height returns cudaErrorInvalidValue; the wrapper raises before
// it gets here.

#include "esn_predict_core.cuh"

namespace {

using namespace esn_predict;

constexpr int kNj4 = 5;
constexpr int kHeight = 72;
constexpr int kFloor = kNoReadout | kNoFeedback | kNoNoise | kNoTanh | kNoRecDot;

}  // namespace

extern "C" int esn_predict_ablate_k_pad(int n_res, int n_in, int n_out) {
  return esn_predict::k_pad(n_res, n_in, n_out);
}

extern "C" long long esn_predict_ablate_smem_bytes(int n_res, int n_in,
                                                   int n_out, int height,
                                                   int P) {
  return (long long)esn_predict::smem_bytes(n_res, n_in, n_out, height, 0);
}

extern "C" int esn_predict_ablate_launch(
    const float* u_fm, const float* wc, const float* wout, float* out, int B,
    int T, int n_res, int n_in, int n_out, int Dg, int n_forget, int rows,
    int height, int off_mask, float noise, float teacher_scaling,
    unsigned long long seed, void* stream) {
  if (B <= 0 || T <= n_forget) return 0;
  if ((n_res + 63) / 64 != kNj4 || height != kHeight || rows <= 0 ||
      rows > height || Dg <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define ABLATE_CASE(MASK)                                                    \
  case MASK:                                                                 \
    return launch<kNj4, kHeight, false, MASK>(                               \
        u_fm, wc, wout, out, B, T, n_res, n_in, n_out, Dg, n_forget, rows,   \
        0, noise, teacher_scaling, seed, s);
  switch (off_mask) {
    ABLATE_CASE(0)
    ABLATE_CASE(kNoReadout)
    ABLATE_CASE(kNoFeedback)
    ABLATE_CASE(kNoNoise)
    ABLATE_CASE(kNoTanh)
    ABLATE_CASE(kNoRecDot)
    ABLATE_CASE(kFloor)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ABLATE_CASE
}
