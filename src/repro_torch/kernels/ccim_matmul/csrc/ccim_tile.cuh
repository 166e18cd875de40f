// Tiled hybrid-CIM GEMM at the 28nm prototype's numerics (acc_len 16,
// top-3 DCIM split, 7-bit ADC), on dp4a, on raw (Kp, N) weights:
//
//   ccim_complex_unpacked.cu  complex, raw (Kp, N) weights    (2 sides)
//
// (The real unpacked GEMM and the prepacked complex one run on the int8
// tensor cores of ccim_mma.cuh.)  A "side" is one real operand pair: Re
// alone for a real GEMM, Re and Im for the complex one.  The complex
// kernel runs the four real sub-MACs of (a + bi)(c + di) as four chunk
// streams over ONE residency of the co-located (Re, Im) weight tile:
//
//   y_re = 2^11 * sum_c (y8_ac - y8_bd),  y_im = 2^11 * sum_c (y8_ad + y8_bc)
//
// and every y8 is clipped on its own, per chunk, before the streams are
// combined (subtracting exact dots first and converting once would give
// other integers).
//
// DCIM in the folded 2-plane form, integer-identical to the 3-dot form
// 2*x6.w6 + x6.w5 + x5.w6 of the TPU kernels:
//   dcim = x6 . P6 + x5 . P5,  P6 = s_w (2 b6 + b5),  P5 = s_w b6.
// Raw weights are decomposed into P6/P5 in the tile fill, once per tile,
// and all streams of the tile share them.
//
// int32 accumulation: |y8| <= 64 + 64 per chunk, so |y_re|, |y_im| <=
// 2^11 * 256 * K / 16 = 2^15 K, below 2^31 for K < 65,536 (the real GEMM:
// K < 131,072).
//
// Layout: 64 x 64 output tile per 256-thread block, 4 x 4 outputs per
// thread per side (rows ty + 16 i, columns tx + 16 j), K in 32-byte
// tiles (two chunks).  Shared rows are padded to 9 words, so the column
// reads of a warp hit 16 distinct banks.
#pragma once

#include "ccim_common.cuh"

namespace ccim {
namespace tile {

constexpr int kLsbShift = 11;            // DCIM lsb 2^11
constexpr int kAdcHalf = 64;             // 7-bit bipolar ADC
constexpr int kBM = 64, kBN = 64, kTileK = 32;
constexpr int kThreads = 256;            // 16 x 16
constexpr int kWords = kTileK / 4;       // int8x4 words per tile row
constexpr int kStride = kWords + 1;
constexpr int kChunkWords = 4;           // acc_len 16

struct Operands {
  const int8_t* x[2];       // (M, Kp) activations per side
  const int8_t* w[2];       // (Kp, N) raw weights per side
  int32_t* out[2];          // (M, N)
};

// Folded plane P6 of four packed int8 weights: per byte
// sign(w) * (2 b6(|w|) + b5(|w|)), in [-3, 3].  Bytes stay apart: the
// negation is a per-byte subtract.
__device__ __forceinline__ int fold_plane4(int w4) {
  const unsigned a = __vabs4(static_cast<unsigned>(w4));
  const unsigned m =
      (((a >> 6) & 0x01010101u) << 1) | ((a >> 5) & 0x01010101u);
  const unsigned neg =
      ((static_cast<unsigned>(w4) >> 7) & 0x01010101u) * 0xFFu;
  return static_cast<int>((m & ~neg) | (__vsub4(0u, m) & neg));
}

// 4 x 4 byte transpose: r[i] holds bytes (k = i, n = 0..3); on return
// r[c] holds bytes (k = 0..3, n = c), the K-contiguous word of dp4a.
__device__ __forceinline__ void transpose4(int r[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned t1 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t2 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = static_cast<int>(__byte_perm(t0, t1, 0x5410));
  r[1] = static_cast<int>(__byte_perm(t0, t1, 0x7632));
  r[2] = static_cast<int>(__byte_perm(t2, t3, 0x5410));
  r[3] = static_cast<int>(__byte_perm(t2, t3, 0x7632));
}

template <int kSides>
__global__ void __launch_bounds__(kThreads)
tile_kernel(Operands op, int M, int N, int Kp) {
  // [side][value | bit-6 plane | bit-5 plane][row][word]
  __shared__ int xs[kSides][3][kBM][kStride];
  // [side][value | P6 | P5][column][word]
  __shared__ int ws[kSides][3][kBN][kStride];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int4 zero = make_int4(0, 0, 0, 0);
  const bool w_words = (N & 3) == 0;     // raw rows 4-byte aligned

  int acc[kSides][4][4];
#pragma unroll
  for (int s = 0; s < kSides; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][i][j] = 0;

  for (int k0 = 0; k0 < Kp; k0 += kTileK) {
    // activations: 64 rows x two 16-byte pieces per side, with their
    // signed bit-planes 6 and 5
    for (int idx = threadIdx.x; idx < kSides * 128; idx += kThreads) {
      const int side = idx / 128, r = (idx % 128) / 2, p = idx % 2;
      const int m = m0 + r, k = k0 + 16 * p;
      int4 v = zero;
      if (m < M && k < Kp)
        v = __ldg(reinterpret_cast<const int4*>(op.x[side] +
                                                (size_t)m * Kp + k));
      const int4 q6 = bit_plane16(v, 6), q5 = bit_plane16(v, 5);
      int* d0 = &xs[side][0][r][4 * p];
      int* d6 = &xs[side][1][r][4 * p];
      int* d5 = &xs[side][2][r][4 * p];
      d0[0] = v.x; d0[1] = v.y; d0[2] = v.z; d0[3] = v.w;
      d6[0] = q6.x; d6[1] = q6.y; d6[2] = q6.z; d6[3] = q6.w;
      d5[0] = q5.x; d5[1] = q5.y; d5[2] = q5.z; d5[3] = q5.w;
    }
    // raw (Kp, N) weights: each thread takes a 4 (k) x 4 (n) block,
    // transposes it to K-contiguous words and folds its planes
    for (int idx = threadIdx.x; idx < kSides * 128; idx += kThreads) {
      const int side = idx / 128, b = idx % 128;
      const int kq = b / 16, nq = b % 16;
      const int k = k0 + 4 * kq, n = n0 + 4 * nq;
      int r[4] = {0, 0, 0, 0};
      if (k < Kp && n < N) {
        const int8_t* src = op.w[side] + (size_t)k * N + n;
        if (w_words) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            r[i] = __ldg(reinterpret_cast<const int*>(src + (size_t)i * N));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            unsigned word = 0;
            for (int c = 0; c < 4 && n + c < N; ++c)
              word |= static_cast<unsigned>(static_cast<uint8_t>(
                          __ldg(src + (size_t)i * N + c)))
                      << (8 * c);
            r[i] = static_cast<int>(word);
          }
        }
      }
      transpose4(r);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ws[side][0][4 * nq + c][kq] = r[c];
        ws[side][1][4 * nq + c][kq] = fold_plane4(r[c]);
        ws[side][2][4 * nq + c][kq] = bit_plane4(r[c], 6);
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kWords / kChunkWords; ++c) {
      // streams: ac (Re x Re -> Re), bd (Im x Im -> -Re), ad (Re x Im ->
      // Im), bc (Im x Re -> Im); the real GEMM runs ac alone
#pragma unroll
      for (int s = 0; s < (kSides == 2 ? 4 : 1); ++s) {
        const int xa = (s == 1 || s == 3), wb = (s == 1 || s == 2);
        const int o = s >= 2;
        int ex[4][4], dc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ex[i][j] = dc[i][j] = 0;
#pragma unroll
        for (int qq = 0; qq < kChunkWords; ++qq) {
          const int q = c * kChunkWords + qq;
#pragma unroll
          for (int pl = 0; pl < 3; ++pl) {
            int a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = xs[xa][pl][ty + 16 * i][q];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = ws[wb][pl][tx + 16 * j][q];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (pl == 0)
                  ex[i][j] = __dp4a(a[i], b[j], ex[i][j]);
                else
                  dc[i][j] = __dp4a(a[i], b[j], dc[i][j]);
              }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int y8 = convert(ex[i][j], dc[i][j], kLsbShift, kAdcHalf);
            acc[o][i][j] += s == 1 ? -y8 : y8;
          }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < kSides; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (m < M && n < N)
          op.out[s][(size_t)m * N + n] = static_cast<int32_t>(
              static_cast<uint32_t>(acc[s][i][j]) << kLsbShift);
      }
    }
}

template <int kSides>
int launch(const Operands& op, int M, int N, int Kp, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  tile_kernel<kSides><<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(op, M, N, Kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile
}  // namespace ccim
