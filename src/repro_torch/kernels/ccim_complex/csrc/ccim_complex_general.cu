// Prepacked fused complex hybrid-CIM GEMM for Hopper, any M, on the int8
// tensor cores.
//
// Replaces: src/repro/kernels/ccim_complex/kernel.py,
//   ccim_complex_matmul_prepacked_pallas (body
//   _ccim_complex_kernel_prepacked).
//
// Operands (the two packs of a PackedComplexCimWeights as stored):
//   x_re, x_im       (M, Kp)    int8 SMF activations
//   w_re, w_im       (N, Kp)    int8 weights, K contiguous per column
//   planes_re/_im    (2, N, Kp) int8 folded planes P6, P5
//   y_re, y_im       (M, N)     int32 at x 2^11
// Prototype numerics only (acc_len 16, top-3 split: P6 against x bit 6,
// P5 against x bit 5, lsb 2^11, 7-bit ADC).  Int32 holds the sums for K <
// 65,536: |y8| <= 128 per stream and chunk, two streams per output.
//
// What bounds it: six weight bytes per (k, n) and 24 M K N int8 MMA
// operations (four streams of one exact and two plane dots).  At M 128
// over one minicpm-2b layer's four full-width GEMMs (sum N K = 68.1 M)
// the bytes take 0.131 ms at 3.35 TB/s and the MMAs 0.106 ms at 1,979
// TOPS.  Above both sit the per-chunk conversions, four per (m, n,
// chunk) where the real GEMM has one, and the activation bit-planes of
// two sides, on the integer pipes: four times the real kernel's MMAs
// and conversions per output pair.  Timed on an H100 80GB HBM3 at 700 W
// (tools/ab_general_gemm.py, chip_smoke.py phase 17) the layer takes
// 1.04-1.06 ms, 3.2 times the real kernel's 0.33 and 8x the byte
// bound; 255 registers a thread, no spills.
//
// Design: general_kernel of ccim_mma.cuh over its packed fill with two
// sides, at acc_len 16 with two planes.  One stage holds x_re and x_im
// (128 rows each) and the six weight operands w, P6, P5 of Re and of Im
// (64 columns each): each weight tile is copied once per stage and its
// fragments, read once per 32 K, serve all four sub-MAC streams -- the
// co-located (Re, Im) residency of the silicon's complex bit-cell, not
// four GEMMs in one launch.  Per chunk and n8 tile, each stream is one
// exact m16n8k16 seeded with lsb/2 and a DCIM chain of two seeded with
// -64, converted in the fragment on its own (12 MMAs, 4 conversions);
// then y_re += cv_ac - cv_bd and y_im += cv_ad + cv_bc.  A 128 x 64 tile
// keeps the real kernel's 64 accumulators a thread.  The ragged N edge
// (the DoA grid's 2,401 columns) is masked, not padded; the last stage of
// a split is zero-filled past its end.  The K split is the shared
// picker's at the 64-column tile; with more than one split both outputs
// are zeroed on the stream and the splits add with red.global.add, mod
// 2^32 as the reference's int32 sum.
#include "../../ccim_matmul/csrc/ccim_mma.cuh"

namespace {

constexpr int kAccLen = 16;
constexpr int kXBits = 6 | (5 << 4);  // P6 pairs with x bit 6, P5 with 5
constexpr int kLsbShift = 11;         // DCIM lsb 2^11
constexpr int kAdcHalf = 64;          // 7-bit bipolar ADC

}  // namespace

// The split of K (bytes) that ccim_complex_general takes for this shape
// on the current device.
extern "C" int ccim_complex_general_k_split(int M, int N, int Kp) {
  return ccim::mma::pick_k_split(M, N, Kp, kAccLen, ccim::mma::sm_count(),
                                 2);
}

extern "C" int ccim_complex_general(const void* x_re, const void* x_im,
                                    const void* w_re, const void* planes_re,
                                    const void* w_im, const void* planes_im,
                                    void* y_re, void* y_im, int M, int N,
                                    int Kp, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % kAccLen)
    return static_cast<int>(cudaErrorInvalidValue);
  const ccim::mma::Args a{
      {static_cast<const int8_t*>(x_re), static_cast<const int8_t*>(x_im)},
      {static_cast<const int8_t*>(w_re), static_cast<const int8_t*>(w_im)},
      {static_cast<const int8_t*>(planes_re),
       static_cast<const int8_t*>(planes_im)},
      {static_cast<int32_t*>(y_re), static_cast<int32_t*>(y_im)},
      M, N, Kp, kXBits, kLsbShift, kAdcHalf, 0};
  return static_cast<int>(
      ccim::mma::run<kAccLen, 2, ccim::mma::PackedFill, 2>(
          a, static_cast<cudaStream_t>(stream)));
}
