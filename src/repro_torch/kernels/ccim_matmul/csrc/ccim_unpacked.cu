// Unpacked hybrid-CIM GEMM for Hopper: raw integer weights, decomposed
// in the kernel, at the 28nm prototype's numerics, on the int8 tensor
// cores.
//
// Replaces: src/repro/kernels/ccim_matmul/kernel.py,
//   ccim_matmul_pallas (body _ccim_kernel).
//
// Operands:
//   x   (M, Kp) int8 SMF activations, K contiguous
//   w   (Kp, N) int8 SMF weights as the caller holds them, N contiguous
//   out (M, N)  int32 at product scale (x 2^11)
// Kp is a multiple of 16; zero padding is numerically free (a chunk of
// zeros converts to 0), and the last stage is zero-filled past Kp.
//
// What bounds it: the function of the prepacked general kernel at the
// prototype's design point -- acc_len 16, DCIM planes P6 and P5 against
// activation bits 6 and 5, lsb 2^11, a 7-bit ADC -- on one weight byte
// per (k, n) instead of three.  At the prefill shape (M = 128, one
// minicpm-2b layer, sum N K = 68.1 M) the 6 M N K int8 operations take
// 0.026 ms at 1,979 TOPS and the bytes 0.020 ms at 3.35 TB/s; at M 4 the
// weight bytes alone set the least time, 0.020 ms.  Above both sit the
// per-chunk conversions and activation bit-planes on the integer pipes
// (the prepacked general kernel's 2.38 G integer ops per layer at M 128)
// and the weight transform of the fill, about a tenth more integer work
// per stage.  Timed on an H100 80GB HBM3 at 700 W (chip_smoke.py phase
// 17) the layer takes 0.365 ms at M 128, the prepacked general kernel's
// time and a tenth, and 0.222 ms at M 4, where one warp per block does
// the MMAs while the others only fill.
//
// Design: general_kernel of ccim_mma.cuh over its raw fill, at acc_len
// 16 with two planes.  Each stage's raw (64 K, 128 N) weight tile lands
// by cp.async (byte loads where rows are not 16-byte aligned, N % 16 !=
// 0), then one pass transposes it to K-contiguous words with byte
// permutes and folds P6 = s_w (2 b6 + b5) and P5 = s_w b6 per byte,
// writing w, P6 and P5 in the layout the MMAs read: the decomposition of
// w happens once per tile, never in a separate pass over memory.  The K
// split is the shared picker's; with more than one split the output is
// zeroed on the stream and the splits add with red.global.add, mod 2^32
// as the reference's int32 sum.
#include "ccim_mma.cuh"

namespace {

constexpr int kAccLen = 16;
constexpr int kXBits = 6 | (5 << 4);  // P6 pairs with x bit 6, P5 with 5
constexpr int kLsbShift = 11;         // DCIM lsb 2^11
constexpr int kAdcHalf = 64;          // 7-bit bipolar ADC

}  // namespace

// The split of K (bytes) that ccim_unpacked takes for this shape on the
// current device.
extern "C" int ccim_unpacked_k_split(int M, int N, int Kp) {
  return ccim::mma::pick_k_split(M, N, Kp, kAccLen, ccim::mma::sm_count());
}

extern "C" int ccim_unpacked(const void* x, const void* w, void* out, int M,
                             int N, int Kp, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % kAccLen)
    return static_cast<int>(cudaErrorInvalidValue);
  const ccim::mma::Args a{{static_cast<const int8_t*>(x)},
                          {static_cast<const int8_t*>(w)},
                          {},
                          {static_cast<int32_t*>(out)},
                          M, N, Kp, kXBits, kLsbShift, kAdcHalf, 0};
  return static_cast<int>(
      ccim::mma::run<kAccLen, 2, ccim::mma::RawFill>(
          a, static_cast<cudaStream_t>(stream)));
}
