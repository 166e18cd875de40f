// General-M prepacked hybrid-CIM GEMM for Hopper: the prefill shape of
// the macro GEMM.
//
// Replaces: src/repro/kernels/ccim_matmul/kernel.py,
//   ccim_matmul_prepacked_pallas (body _ccim_kernel_prepacked).
//
// Operands as in the skinny kernel (K contiguous):
//   x (M, Kp) int8, w (N, Kp) int8, planes (n_planes, N, Kp) int8,
//   out (M, N) int32 at product scale.
//
// What bounds it: at the prefill shape (M = 128) the arithmetic is
// 2 * M * (1 + n_planes) int8 operations per weight byte, about 256 per
// byte for the prototype split -- under the card's ~590 ops per byte, so
// the least time is still set by the weight bytes.  This first version
// runs its chunk dots on the integer pipes (__dp4a), not the int8 tensor
// cores, so in practice it is bound by dp4a issue and shared-memory
// reads, far above the byte bound.
//
// Design: a 64 x 64 output tile per 256-thread block, 4 x 4 outputs per
// thread (rows ty + 16 i, columns tx + 16 j: conflict-free shared reads).
// The K loop takes 64-byte tiles, a whole number of chunks for every
// admitted acc_len (8..64), so each chunk's exact and DCIM dots finish in
// registers and are clipped before they join the running sum; partial
// sums of (dcim + code) then add exactly.  The activation bit-planes are
// built in the tile fill from the streamed x.
#include "ccim_common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kTileK = 64;
constexpr int kTM = 4, kTN = 4;
constexpr int kThreads = 256;            // 16 x 16
constexpr int kWords = kTileK / 4;       // int32 words per tile row
constexpr int kStride = kWords + 1;      // padded row: no bank conflicts

__global__ void __launch_bounds__(kThreads)
general_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const int8_t* __restrict__ planes, int32_t* __restrict__ out,
               int M, int N, int Kp, int n_planes, int x_bits, int lsb_shift,
               int adc_half, int acc_len) {
  __shared__ int xs[1 + ccim::kMaxPlanes][kBM][kStride];
  __shared__ int ws[1 + ccim::kMaxPlanes][kBN][kStride];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int4 zero = make_int4(0, 0, 0, 0);
  const int words_per_chunk = acc_len / 4;
  const int n_chunks = kTileK / acc_len;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  // tile fill: each thread moves one 16-byte piece of x and of w
  const int r = threadIdx.x / 4, p = threadIdx.x % 4;
  for (int k0 = 0; k0 < Kp; k0 += kTileK) {
    const int k = k0 + p * 16;
    {
      const int m = m0 + r;
      int4 v = zero;
      if (m < M && k < Kp)
        v = __ldg(reinterpret_cast<const int4*>(x + (size_t)m * Kp + k));
      int* dst = &xs[0][r][p * 4];
      dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      for (int i = 0; i < n_planes; ++i) {
        const int4 q = ccim::bit_plane16(v, (x_bits >> (4 * i)) & 0xF);
        int* d = &xs[1 + i][r][p * 4];
        d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
      }
    }
    {
      const int n = n0 + r;
      const bool ok = n < N && k < Kp;
      int4 u = ok ? __ldg(reinterpret_cast<const int4*>(w + (size_t)n * Kp + k))
                  : zero;
      int* dst = &ws[0][r][p * 4];
      dst[0] = u.x; dst[1] = u.y; dst[2] = u.z; dst[3] = u.w;
      for (int i = 0; i < n_planes; ++i) {
        u = ok ? __ldg(reinterpret_cast<const int4*>(
                     planes + ((size_t)i * N + n) * Kp + k))
               : zero;
        int* d = &ws[1 + i][r][p * 4];
        d[0] = u.x; d[1] = u.y; d[2] = u.z; d[3] = u.w;
      }
    }
    __syncthreads();

    for (int c = 0; c < n_chunks; ++c) {
      int ex[kTM][kTN], dc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) ex[i][j] = dc[i][j] = 0;
      for (int q = c * words_per_chunk; q < (c + 1) * words_per_chunk; ++q) {
        int a[kTM], b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = xs[0][ty + 16 * i][q];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = ws[0][tx + 16 * j][q];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) ex[i][j] = __dp4a(a[i], b[j], ex[i][j]);
#pragma unroll
        for (int pl = 0; pl < ccim::kMaxPlanes; ++pl) {
          if (pl < n_planes) {
#pragma unroll
            for (int i = 0; i < kTM; ++i) a[i] = xs[1 + pl][ty + 16 * i][q];
#pragma unroll
            for (int j = 0; j < kTN; ++j) b[j] = ws[1 + pl][tx + 16 * j][q];
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j)
                dc[i][j] = __dp4a(a[i], b[j], dc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] += ccim::convert(ex[i][j], dc[i][j], lsb_shift, adc_half);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j] * (1 << lsb_shift);
    }
  }
}

}  // namespace

extern "C" int ccim_prepacked_general(const void* x, const void* w,
                                      const void* planes, void* out, int M,
                                      int N, int Kp, int n_planes, int x_bits,
                                      int lsb_shift, int adc_half, int acc_len,
                                      void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  general_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int8_t*>(planes), static_cast<int32_t*>(out), M, N,
      Kp, n_planes, x_bits, lsb_shift, adc_half, acc_len);
  return static_cast<int>(cudaGetLastError());
}
