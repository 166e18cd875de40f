// General-M prepacked hybrid-CIM GEMM for Hopper: the prefill shape of
// the macro GEMM, on the int8 tensor cores.
//
// Replaces: src/repro/kernels/ccim_matmul/kernel.py,
//   ccim_matmul_prepacked_pallas (body _ccim_kernel_prepacked).
//
// Operands as in the skinny kernel (K contiguous):
//   x (M, Kp) int8, w (N, Kp) int8, planes (n_planes, N, Kp) int8,
//   out (M, N) int32 at product scale.
//
// What bounds it: at the prefill shape (M = 128, one minicpm-2b layer,
// sum N K = 68.1 M) the weight and plane bytes take 0.061 ms at 3.35
// TB/s and the 52 G int8 MMA operations 0.026 ms at 1,979 TOPS.  The
// conversions (M N Kp / acc_len = 545 M, four int32 ops each) and the
// activation bit-planes (4 + 4 n_planes ops per 4 bytes) come to 2.38 G
// integer ops, 0.143 ms on 64 int32 lanes per SM at 1.98 GHz (data-sheet
// figures).  Timed on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 7,
// design sweep) the layer takes 0.336 ms and follows none of these alone:
// halving the conversions (acc_len 32) saves a quarter of it, and each
// DCIM plane costs 0.033 ms, more than its bytes (0.020) or its integer
// ops (0.010).  About 0.17 ms does not scale with the conversion count;
// whether MMA issue and latency (8 warps per SM, 255 registers), ldmatrix
// traffic or the split-K atomics hold it is not measured.
//
// Design: general_kernel of ccim_mma.cuh over its packed fill (x, w and
// each plane copied into the stage by cp.async, in the layout the MMAs
// read), instantiated for acc_len 8, 16, 32, 64 and 0-3 planes; the
// header holds the tile, the folded conversion and the split of K.  With
// a clip counter (int32, on the device) the entry point launches the
// instances that also count the conversions whose ADC code clipped
// (ccim_mma.cuh: kCount), the telemetry the scheduler's rings read; with
// none, the instances without the count.
#include "ccim_mma.cuh"

namespace {

using ccim::mma::Args;
using ccim::mma::PackedFill;

template <int ACC, bool kCount>
cudaError_t run_planes(const Args& a, int n_planes, cudaStream_t stream) {
  switch (n_planes) {
    case 0: return ccim::mma::run<ACC, 0, PackedFill, 1, kCount>(a, stream);
    case 1: return ccim::mma::run<ACC, 1, PackedFill, 1, kCount>(a, stream);
    case 2: return ccim::mma::run<ACC, 2, PackedFill, 1, kCount>(a, stream);
    case 3: return ccim::mma::run<ACC, 3, PackedFill, 1, kCount>(a, stream);
  }
  return cudaErrorInvalidValue;
}

// the clip-counting instances when clips is set, else today's kernel
template <int ACC>
cudaError_t run_count(const Args& a, int n_planes, cudaStream_t stream) {
  return a.clips ? run_planes<ACC, true>(a, n_planes, stream)
                 : run_planes<ACC, false>(a, n_planes, stream);
}

}  // namespace

// The split of K (bytes) that ccim_prepacked_general takes for this shape
// on the current device.
extern "C" int ccim_prepacked_general_k_split(int M, int N, int Kp,
                                              int acc_len) {
  return ccim::mma::pick_k_split(M, N, Kp, acc_len, ccim::mma::sm_count());
}

extern "C" int ccim_prepacked_general(const void* x, const void* w,
                                      const void* planes, void* out, int M,
                                      int N, int Kp, int n_planes, int x_bits,
                                      int lsb_shift, int adc_half, int acc_len,
                                      void* clips, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % 16 || n_planes < 0 ||
      n_planes > ccim::kMaxPlanes ||
      (acc_len != 8 && acc_len != 16 && acc_len != 32 && acc_len != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const Args a{{static_cast<const int8_t*>(x)},
               {static_cast<const int8_t*>(w)},
               {static_cast<const int8_t*>(planes)},
               {static_cast<int32_t*>(out)},
               M, N, Kp, x_bits, lsb_shift, adc_half, 0,
               static_cast<int32_t*>(clips)};
  cudaError_t err = cudaErrorInvalidValue;
  switch (acc_len) {
    case 8: err = run_count<8>(a, n_planes, s); break;
    case 16: err = run_count<16>(a, n_planes, s); break;
    case 32: err = run_count<32>(a, n_planes, s); break;
    case 64: err = run_count<64>(a, n_planes, s); break;
  }
  return static_cast<int>(err);
}
