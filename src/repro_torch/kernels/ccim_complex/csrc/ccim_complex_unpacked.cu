// Fused complex hybrid-CIM GEMM for Hopper on raw integer weights, any M,
// on the int8 tensor cores: one co-located (Re, Im) weight residency
// serves the four real sub-MACs.
//
// Replaces: src/repro/kernels/ccim_complex/kernel.py,
//   ccim_complex_matmul_pallas (body _ccim_complex_kernel).
//
// Operands:
//   x_re, x_im   (M, Kp) int8 SMF activations, K contiguous
//   w_re, w_im   (Kp, N) int8 SMF weights as the caller holds them, N
//                contiguous
//   y_re, y_im   (M, N)  int32 at x 2^11
// Prototype numerics only (acc_len 16, top-3 split: P6 against x bit 6,
// P5 against x bit 5, lsb 2^11, 7-bit ADC).  Kp is a multiple of 16; zero
// padding is numerically free (a chunk of zeros converts to 0), and the
// last stage is zero-filled past Kp.  Int32 holds the sums for K <
// 65,536: |dcim + code| <= 128 per stream and chunk, two streams per
// output, so |y| <= 2^11 * 256 * K / 16 = 2^15 K.
//
// What bounds it: 2 M K + 2 K N + 8 M N bytes (each side's x and raw
// weights read once, both outputs written once) and 24 M K N int8 MMA
// operations (four streams of one exact and two plane dots).  At M 128
// over one minicpm-2b layer's four full-width GEMMs (sum N K = 68.1 M)
// the operations take 0.106 ms at 1,979 TOPS and the bytes 0.049 ms at
// 3.35 TB/s; at M 4 the weight bytes alone set the least time, 0.041 ms.
// Above both sit what the prepacked complex kernel pays -- four per-chunk
// conversions per (m, n, chunk) and two sides' activation bit-planes on
// the integer pipes -- and the fill's transform of two raw tiles per
// stage.  Timed on an H100 80GB HBM3 at 700 W (tools/ab_general_gemm.py,
// chip_smoke.py phase 17) the layer takes 1.13-1.15 ms at M 128, the
// prepacked complex kernel's time and 0.09 ms, and 0.68 ms at M 4, where
// one warp per block does the MMAs while the others only fill; the DoA
// covariance (M 64, K 4,096, N 64) takes 0.014 ms.  255 registers a
// thread with 108 bytes of spill stores (9 words per half stage, under
// 1 % of the time).
//
// Design: general_kernel of ccim_mma.cuh over its raw fill with two
// sides, at acc_len 16 with two planes (the prepacked complex kernel's
// 128 x 64 tile and four-stream MMA loop).  Each stage's two raw (64 K,
// 64 N) tiles land by cp.async side by side in one (64 K, 128 N) area
// (byte loads where rows are not 16-byte aligned, N % 16 != 0); one pass
// then transposes them to K-contiguous words with byte permutes and folds
// P6 = s_w (2 b6 + b5) and P5 = s_w b6 per byte, warps 0-3 for Re and
// 4-7 for Im, writing the six operands in the layout the MMAs read: each
// raw weight byte is copied once and decomposed once per stage, and
// every B fragment serves two of the four sub-MAC streams.  Per chunk
// and n8 tile each stream is one exact m16n8k16 seeded with lsb/2 and a
// DCIM chain of two seeded with -64, converted in the fragment on its own
// before y_re += cv_ac - cv_bd and y_im += cv_ad + cv_bc.  The K split is
// the shared picker's at the 64-column tile (at the DoA covariance, one
// output tile and K = 4,096 snapshots: one stage per block over 64 SMs);
// with more than one split both outputs are zeroed on the stream and the
// splits add with red.global.add, mod 2^32 as the reference's int32 sum.
#include "../../ccim_matmul/csrc/ccim_mma.cuh"

namespace {

constexpr int kAccLen = 16;
constexpr int kXBits = 6 | (5 << 4);  // P6 pairs with x bit 6, P5 with 5
constexpr int kLsbShift = 11;         // DCIM lsb 2^11
constexpr int kAdcHalf = 64;          // 7-bit bipolar ADC

}  // namespace

// The split of K (bytes) that ccim_complex_unpacked takes for this shape
// on the current device.
extern "C" int ccim_complex_unpacked_k_split(int M, int N, int Kp) {
  return ccim::mma::pick_k_split(M, N, Kp, kAccLen, ccim::mma::sm_count(),
                                 2);
}

extern "C" int ccim_complex_unpacked(const void* x_re, const void* x_im,
                                     const void* w_re, const void* w_im,
                                     void* y_re, void* y_im, int M, int N,
                                     int Kp, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % kAccLen)
    return static_cast<int>(cudaErrorInvalidValue);
  const ccim::mma::Args a{
      {static_cast<const int8_t*>(x_re), static_cast<const int8_t*>(x_im)},
      {static_cast<const int8_t*>(w_re), static_cast<const int8_t*>(w_im)},
      {},
      {static_cast<int32_t*>(y_re), static_cast<int32_t*>(y_im)},
      M, N, Kp, kXBits, kLsbShift, kAdcHalf, 0};
  return static_cast<int>(
      ccim::mma::run<kAccLen, 2, ccim::mma::RawFill, 2>(
          a, static_cast<cudaStream_t>(stream)));
}
