// Skinny-M (M <= 32) prepacked fused complex hybrid-CIM GEMM for Hopper.
//
// Replaces: src/repro/kernels/ccim_complex/kernel.py,
//   ccim_complex_matmul_prepacked_skinny_pallas (body
//   _ccim_complex_kernel_prepacked_skinny).
//
// Operands (the two packs of a PackedComplexCimWeights as stored; the
// four folded planes are read where they lie, never stacked per call):
//   x_re, x_im       (M, Kp)    int8 SMF activations
//   w_re, w_im       (N, Kp)    int8 weights, K contiguous per column
//   planes_re/_im    (2, N, Kp) int8 folded planes P6, P5
//   y_re, y_im       (M, N)     int32 at x 2^11
// Prototype numerics only: acc_len 16 (one lane's 16 bytes are one
// chunk), DCIM lsb 2^11, 7-bit ADC.  |y8| <= 128 per chunk, so the int32
// outputs hold for K < 65,536.
//
// What bounds it: at M <= 32 there are at most 4 * M int8 operations per
// weight byte (six bytes per (k, n), 24 M operations), far below the
// card's ~590 operations per byte of HBM rate: streaming the six weight
// rows once sets the least time.
//
// Design: as ccim_prepacked_skinny.cu.  One warp owns one output column
// and walks K; per 512-element K tile each lane loads 16 bytes of the
// column's w_re row, its w_im row and the four plane rows, so each of
// the six rows is read by the warp as one contiguous 512-byte run.  The
// block's 8 warps share x_re, x_im and their bit-planes 6 and 5, built
// once per tile in shared memory.  Each lane converts its chunk four
// times (ac, bd, ad, bc), each y8 clipped on its own, and adds
// y8_ac - y8_bd to Re and y8_ad + y8_bc to Im: both outputs from one
// weight read.  Per-row sums stay in registers and meet across the warp
// once at the end.  The ragged N edge is masked (warps past N idle).
#include "../../ccim_matmul/csrc/ccim_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 512;             // 32 lanes x 16 bytes
constexpr int kPieces = kTileK / 16;    // int4 pieces per tile row
constexpr int kLsbShift = 11;
constexpr int kAdcHalf = 64;

// one sub-MAC chunk: exact dot, folded DCIM dots, conversion
__device__ __forceinline__ int sub_mac(int4 x, int4 x6, int4 x5, int4 w,
                                       int4 p6, int4 p5) {
  const int e = ccim::dot16(x, w, 0);
  const int d = ccim::dot16(x5, p5, ccim::dot16(x6, p6, 0));
  return ccim::convert(e, d, kLsbShift, kAdcHalf);
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
complex_skinny_kernel(const int8_t* __restrict__ x_re,
                      const int8_t* __restrict__ x_im,
                      const int8_t* __restrict__ w_re,
                      const int8_t* __restrict__ planes_re,
                      const int8_t* __restrict__ w_im,
                      const int8_t* __restrict__ planes_im,
                      int32_t* __restrict__ y_re, int32_t* __restrict__ y_im,
                      int M, int N, int Kp) {
  // [x_re, x_re bit 6, x_re bit 5, x_im, x_im bit 6, x_im bit 5][MT][kPieces]
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const bool active = n < N;            // warp-uniform
  const int4 zero = make_int4(0, 0, 0, 0);
  const int plane = MT * kPieces;       // int4s per shared array

  int acc_re[MT], acc_im[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc_re[m] = acc_im[m] = 0;

  for (int k0 = 0; k0 < Kp; k0 += kTileK) {
    for (int idx = threadIdx.x; idx < plane; idx += kThreads) {
      const int m = idx / kPieces;
      const int k = k0 + (idx % kPieces) * 16;
      int4 vr = zero, vi = zero;
      if (m < M && k < Kp) {
        vr = __ldg(reinterpret_cast<const int4*>(x_re + (size_t)m * Kp + k));
        vi = __ldg(reinterpret_cast<const int4*>(x_im + (size_t)m * Kp + k));
      }
      smem[idx] = vr;
      smem[plane + idx] = ccim::bit_plane16(vr, 6);
      smem[2 * plane + idx] = ccim::bit_plane16(vr, 5);
      smem[3 * plane + idx] = vi;
      smem[4 * plane + idx] = ccim::bit_plane16(vi, 6);
      smem[5 * plane + idx] = ccim::bit_plane16(vi, 5);
    }
    __syncthreads();

    if (active) {
      const int k = k0 + lane * 16;
      const bool in_k = k < Kp;         // whole chunks in or out
      auto row = [&](const int8_t* base) {
        return in_k ? __ldg(reinterpret_cast<const int4*>(base + k)) : zero;
      };
      const size_t col = (size_t)n * Kp, pl = (size_t)N * Kp;
      const int4 wr = row(w_re + col), wr6 = row(planes_re + col),
                 wr5 = row(planes_re + pl + col);
      const int4 wi = row(w_im + col), wi6 = row(planes_im + col),
                 wi5 = row(planes_im + pl + col);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= M) break;
        const int s = m * kPieces + lane;
        const int4 xr = smem[s], xr6 = smem[plane + s],
                   xr5 = smem[2 * plane + s];
        const int4 xi = smem[3 * plane + s], xi6 = smem[4 * plane + s],
                   xi5 = smem[5 * plane + s];
        acc_re[m] += sub_mac(xr, xr6, xr5, wr, wr6, wr5) -
                     sub_mac(xi, xi6, xi5, wi, wi6, wi5);
        acc_im[m] += sub_mac(xr, xr6, xr5, wi, wi6, wi5) +
                     sub_mac(xi, xi6, xi5, wr, wr6, wr5);
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
    int vr = acc_re[m], vi = acc_im[m];
    for (int off = 16; off > 0; off >>= 1) {
      vr += __shfl_xor_sync(0xffffffffu, vr, off);
      vi += __shfl_xor_sync(0xffffffffu, vi, off);
    }
    if (lane == 0) {
      y_re[(size_t)m * N + n] =
          static_cast<int32_t>(static_cast<uint32_t>(vr) << kLsbShift);
      y_im[(size_t)m * N + n] =
          static_cast<int32_t>(static_cast<uint32_t>(vi) << kLsbShift);
    }
  }
}

template <int MT>
int launch(const int8_t* xr, const int8_t* xi, const int8_t* wr,
           const int8_t* pr, const int8_t* wi, const int8_t* pi, int32_t* yr,
           int32_t* yi, int M, int N, int Kp, cudaStream_t stream) {
  const int smem = 6 * MT * kTileK;     // above 48 KB only when opted in
  cudaError_t err = cudaFuncSetAttribute(
      complex_skinny_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kWarps - 1) / kWarps);
  complex_skinny_kernel<MT><<<grid, kThreads, smem, stream>>>(
      xr, xi, wr, pr, wi, pi, yr, yi, M, N, Kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ccim_complex_skinny(const void* x_re, const void* x_im,
                                   const void* w_re, const void* planes_re,
                                   const void* w_im, const void* planes_im,
                                   void* y_re, void* y_im, int M, int N,
                                   int Kp, void* stream) {
  const auto* xr = static_cast<const int8_t*>(x_re);
  const auto* xi = static_cast<const int8_t*>(x_im);
  const auto* wr = static_cast<const int8_t*>(w_re);
  const auto* pr = static_cast<const int8_t*>(planes_re);
  const auto* wi = static_cast<const int8_t*>(w_im);
  const auto* pi = static_cast<const int8_t*>(planes_im);
  auto* yr = static_cast<int32_t*>(y_re);
  auto* yi = static_cast<int32_t*>(y_im);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 4) return launch<4>(xr, xi, wr, pr, wi, pi, yr, yi, M, N, Kp, s);
  if (M <= 8) return launch<8>(xr, xi, wr, pr, wi, pi, yr, yi, M, N, Kp, s);
  if (M <= 16)
    return launch<16>(xr, xi, wr, pr, wi, pi, yr, yi, M, N, Kp, s);
  return launch<32>(xr, xi, wr, pr, wi, pi, yr, yi, M, N, Kp, s);
}
