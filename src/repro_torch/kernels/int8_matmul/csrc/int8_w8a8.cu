// W8A8 integer GEMM for Hopper with the fused per-row / per-column
// dequant epilogue: the all-digital CIM baseline [11], no macro
// arithmetic and no per-chunk clip.
//
// Replaces: src/repro/kernels/int8_matmul/kernel.py,
//   int8_matmul_pallas (body _int8_kernel).
//
// Operands:
//   x   (M, Kp) int8 activations, K contiguous
//   w   (N, Kp) int8 weights, K contiguous (the wrapper quantizes w per
//       call, so it lays it out transposed for free)
//   sx  (M) float32 per-row scales, sw (N) float32 per-column scales
//   out (M, N) float32 = (float(acc) * sx[m]) * sw[n], acc the int32 dot
// Kp is a multiple of 64 (the wrapper zero-pads K); M and N are ragged:
// rows and columns past the edge load zeros and are not stored.  The
// int32 accumulator never leaves the kernel; the epilogue is the
// reference's two float32 roundings in its order (__fmul_rn keeps them
// from fusing into an FMA).
//
// What bounds it: the bytes -- at decode M the weights, one int8 per
// weight read once (68 MB for a minicpm-2b layer, ~20 us at 3.35 TB/s);
// at M 128 still the bytes, with the 2 M K N int8 operations ~3x below.
//
// Design: int8 tensor cores through mma.sync.m16n8k32 (s8 x s8 -> s32),
// fed straight from global memory into registers, no shared-memory
// staging.  Each lane loads 16 contiguous K bytes of one x row and one w
// row per 64-K step; the dot product does not care how K is ordered, so
// the step's two MMAs take K in the order the loads deliver it (MMA h
// reads words 2h, 2h+1 of every lane's 16 bytes, for A and B alike), and
// every load is one 16-byte vector.  A warp owns a (16 MT) x (8 NT)
// output tile and walks U K-steps per trip with all their loads issued
// before the MMAs; WN warps side by side along N and WK warps splitting
// K share one block tile, their partial sums meeting in shared memory
// (int32 atomics) before the epilogue writes the block's tile with
// coalesced stores.  Two shapes, picked by timing the variants at
// minicpm-2b's layer shapes: decode (M <= 16) a 16 x 8 tile per block
// with K split over 8 warps, 4 steps in flight each (even N 2304 gives
// 288 blocks); otherwise 32 x 64 tiles, 2 x 4 warps, 2 steps in flight.
// Every warp re-reads its operands from L2 (w once per 32 rows of M), so
// at large M this is latency-bound: shared-memory tiles fed by TMA and
// wgmma are the later work.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 K bytes of row `row` at column `k`; zeros past the ragged edge
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ base,
                                       int row, int rows, int ld, int k) {
  if (row >= rows) return make_int4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const int4*>(base + (size_t)row * ld + k));
}

template <int MT, int NT, int WN, int WK, int U>
__global__ void __launch_bounds__(32 * WN * WK)
int8_w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 float* __restrict__ out, int M, int N, int Kp) {
  constexpr int BM = 16 * MT, BN = 8 * NT * WN, STEP = 64 * WK;
  __shared__ int acc_s[BM * BN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp % WN, wk = warp / WN;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int nb = blockIdx.x * BN, n0 = nb + wn * 8 * NT;
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) acc_s[i] = 0;

  int c[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[mt][nt][r] = 0;

  // U K-steps per trip: every load of the trip is issued before its MMAs
  // (steps past Kp load zeros; the trip count is the same on every lane)
  for (int k = wk * 64 + 16 * t; k < Kp; k += U * STEP) {
    int4 a[U][MT][2], b[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + u * STEP;
      const bool in = kk < Kp;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[u][mt][0] = load16(x, m0 + mt * 16 + g, in ? M : 0, Kp, kk);
        a[u][mt][1] = load16(x, m0 + mt * 16 + g + 8, in ? M : 0, Kp, kk);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        b[u][nt] = load16(w, n0 + nt * 8 + g, in ? N : 0, Kp, kk);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_s8(c[mt][nt], a[u][mt][0].x, a[u][mt][1].x, a[u][mt][0].y,
                 a[u][mt][1].y, b[u][nt].x, b[u][nt].y);
          mma_s8(c[mt][nt], a[u][mt][0].z, a[u][mt][1].z, a[u][mt][0].w,
                 a[u][mt][1].w, b[u][nt].z, b[u][nt].w);
        }
  }
  __syncthreads();                       // the tile is zeroed
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = mt * 16 + g, col = wn * 8 * NT + nt * 8 + 2 * t;
      atomicAdd(&acc_s[r * BN + col], c[mt][nt][0]);
      atomicAdd(&acc_s[r * BN + col + 1], c[mt][nt][1]);
      atomicAdd(&acc_s[(r + 8) * BN + col], c[mt][nt][2]);
      atomicAdd(&acc_s[(r + 8) * BN + col + 1], c[mt][nt][3]);
    }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int m = m0 + i / BN, n = nb + i % BN;
    if (m < M && n < N)
      out[(size_t)m * N + n] =
          __fmul_rn(__fmul_rn(__int2float_rn(acc_s[i]), sx[m]), sw[n]);
  }
}

template <int MT, int NT, int WN, int WK, int U>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* sx,
                   const float* sw, float* out, int M, int N, int Kp,
                   cudaStream_t stream) {
  constexpr int BM = 16 * MT, BN = 8 * NT * WN;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_w8a8_kernel<MT, NT, WN, WK, U><<<grid, 32 * WN * WK, 0, stream>>>(
      x, w, sx, sw, out, M, N, Kp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int int8_w8a8(const void* x, const void* w, const void* sx,
                         const void* sw, void* out, int M, int N, int Kp,
                         void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % 64) return (int)cudaErrorInvalidValue;
  auto xs = static_cast<const int8_t*>(x);
  auto ws = static_cast<const int8_t*>(w);
  auto a = static_cast<const float*>(sx);
  auto b = static_cast<const float*>(sw);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = M <= 16
      ? launch<1, 1, 1, 8, 4>(xs, ws, a, b, o, M, N, Kp, s)
      : launch<2, 4, 2, 4, 2>(xs, ws, a, b, o, M, N, Kp, s);
  return (int)err;
}
