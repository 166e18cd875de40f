// Skinny-M (M <= 32) prepacked hybrid-CIM GEMM for Hopper: the decode
// shape of the macro GEMM.
//
// Replaces: src/repro/kernels/ccim_matmul/kernel.py,
//   ccim_matmul_prepacked_skinny_pallas (body _ccim_kernel_prepacked_skinny).
//
// Operands (all row-major, K contiguous):
//   x      (M, Kp)            int8 SMF activations
//   w      (N, Kp)            int8 SMF weights, one row per output column
//   planes (n_planes, N, Kp)  int8 folded signed DCIM planes
//   out    (M, N)             int32 at product scale
// Kp is a multiple of 16 and of acc_len; zero padding is numerically free
// (an all-zero chunk converts to code 0).
//
// What bounds it: at M <= 32 there are at most 2*M int8 operations per
// weight byte, far below the card's ~590 int8 ops per byte of HBM rate,
// so the kernel is bound by streaming w and the planes once.
//
// Design: one warp owns one output column and walks K; each lane loads
// 16 contiguous bytes of the column's w row and of each plane row per
// 512-element K tile, so a warp's loads are one contiguous 512-byte run.
// The block's 8 warps share the tile's activation rows and their signed
// bit-planes, built once per tile in shared memory from the streamed x
// (as the silicon derives its bit-planes from the streamed input).
// Chunks wider than 16 span acc_len/16 neighbouring lanes, whose exact
// and DCIM partials meet by shuffle before the per-chunk clip; at acc_len
// 8 each lane converts two chunks.  Per-row sums stay in registers and
// are reduced across the warp once at the end.
#include "ccim_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 512;             // 32 lanes x 16 bytes
constexpr int kPieces = kTileK / 16;    // int4 pieces per tile row

template <int MT>
__global__ void __launch_bounds__(kThreads)
skinny_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const int8_t* __restrict__ planes, int32_t* __restrict__ out,
              int M, int N, int Kp, int n_planes, int x_bits, int lsb_shift,
              int adc_half, int acc_len) {
  extern __shared__ int4 smem[];        // [(1 + n_planes)][MT][kPieces]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const bool active = n < N;            // warp-uniform
  const int group = acc_len >= 16 ? acc_len / 16 : 1;   // lanes per chunk
  const int4 zero = make_int4(0, 0, 0, 0);

  int acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0;

  for (int k0 = 0; k0 < Kp; k0 += kTileK) {
    // activation tile and its signed bit-planes, rows >= M zero
    for (int idx = threadIdx.x; idx < MT * kPieces; idx += kThreads) {
      const int m = idx / kPieces;
      const int k = k0 + (idx % kPieces) * 16;
      int4 v = zero;
      if (m < M && k < Kp)
        v = __ldg(reinterpret_cast<const int4*>(x + (size_t)m * Kp + k));
      smem[idx] = v;
      for (int i = 0; i < n_planes; ++i)
        smem[(1 + i) * MT * kPieces + idx] =
            ccim::bit_plane16(v, (x_bits >> (4 * i)) & 0xF);
    }
    __syncthreads();

    if (active) {
      const int k = k0 + lane * 16;
      const bool in_k = k < Kp;         // whole chunks in or out
      const int4 wv = in_k ? __ldg(reinterpret_cast<const int4*>(
                                 w + (size_t)n * Kp + k))
                           : zero;
      int4 pv[ccim::kMaxPlanes];
#pragma unroll
      for (int i = 0; i < ccim::kMaxPlanes; ++i)
        pv[i] = (i < n_planes && in_k)
                    ? __ldg(reinterpret_cast<const int4*>(
                          planes + ((size_t)i * N + n) * Kp + k))
                    : zero;

#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= M) break;
        const int4 xv = smem[m * kPieces + lane];
        if (acc_len == 8) {
          // two chunks per lane: words (x, y) and (z, w)
          int e0 = __dp4a(xv.y, wv.y, __dp4a(xv.x, wv.x, 0));
          int e1 = __dp4a(xv.w, wv.w, __dp4a(xv.z, wv.z, 0));
          int d0 = 0, d1 = 0;
#pragma unroll
          for (int i = 0; i < ccim::kMaxPlanes; ++i) {
            if (i < n_planes) {
              const int4 xp = smem[(1 + i) * MT * kPieces + m * kPieces + lane];
              d0 = __dp4a(xp.y, pv[i].y, __dp4a(xp.x, pv[i].x, d0));
              d1 = __dp4a(xp.w, pv[i].w, __dp4a(xp.z, pv[i].z, d1));
            }
          }
          acc[m] += ccim::convert(e0, d0, lsb_shift, adc_half) +
                    ccim::convert(e1, d1, lsb_shift, adc_half);
        } else {
          int e = ccim::dot16(xv, wv, 0);
          int d = 0;
#pragma unroll
          for (int i = 0; i < ccim::kMaxPlanes; ++i) {
            if (i < n_planes) {
              const int4 xp = smem[(1 + i) * MT * kPieces + m * kPieces + lane];
              d = ccim::dot16(xp, pv[i], d);
            }
          }
          // the chunk's lanes meet before the clip (the clip is per chunk)
          for (int off = 1; off < group; off <<= 1) {
            e += __shfl_xor_sync(0xffffffffu, e, off);
            d += __shfl_xor_sync(0xffffffffu, d, off);
          }
          if ((lane & (group - 1)) == 0)
            acc[m] += ccim::convert(e, d, lsb_shift, adc_half);
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
    int v = acc[m];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) out[(size_t)m * N + n] = v * (1 << lsb_shift);
  }
}

template <int MT>
int launch(const int8_t* x, const int8_t* w, const int8_t* planes,
           int32_t* out, int M, int N, int Kp, int n_planes, int x_bits,
           int lsb_shift, int adc_half, int acc_len, cudaStream_t stream) {
  const int smem = (1 + n_planes) * MT * kTileK;
  // above 48 KB only as opted-in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      skinny_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (1 + ccim::kMaxPlanes) * MT * kTileK);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kWarps - 1) / kWarps);
  skinny_kernel<MT><<<grid, kThreads, smem, stream>>>(
      x, w, planes, out, M, N, Kp, n_planes, x_bits, lsb_shift, adc_half,
      acc_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ccim_prepacked_skinny(const void* x, const void* w,
                                     const void* planes, void* out, int M,
                                     int N, int Kp, int n_planes, int x_bits,
                                     int lsb_shift, int adc_half, int acc_len,
                                     void* stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* pp = static_cast<const int8_t*>(planes);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 4)
    return launch<4>(xp, wp, pp, op, M, N, Kp, n_planes, x_bits, lsb_shift,
                     adc_half, acc_len, s);
  if (M <= 8)
    return launch<8>(xp, wp, pp, op, M, N, Kp, n_planes, x_bits, lsb_shift,
                     adc_half, acc_len, s);
  if (M <= 16)
    return launch<16>(xp, wp, pp, op, M, N, Kp, n_planes, x_bits, lsb_shift,
                      adc_half, acc_len, s);
  return launch<32>(xp, wp, pp, op, M, N, Kp, n_planes, x_bits, lsb_shift,
                    adc_half, acc_len, s);
}
