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
// Kp is a multiple of 64 (the wrapper zero-pads K); M and N are ragged.
// The int32 accumulator never leaves the chip; the epilogue is the
// reference's two float32 roundings in its order (__fmul_rn keeps them
// from fusing into an FMA).
//
// What bounds it: the bytes -- the weights, one int8 per weight read once
// (68 MB for a minicpm-2b layer, 20 us at the H100 data sheet's 3.35
// TB/s), and at M 128 the float32 output (13 MB); the 2 M K N int8
// operations (17.4 G at M 128) take 9 us at its 1,979 TOPS.
//
// Design: a TMA-fed, warp-specialised wgmma pipeline.  The weights are the
// 64-row wgmma operand and the tokens its N (TOK = 8 ... 128): both are
// K-major, the one layout int8 wgmma reads, and a token tile reads each
// weight byte once (token tiles of one weight tile are neighbours in
// launch order, so a second one meets it in L2).  A block owns BN = 128
// weight rows x TOK tokens x one slice of K.  One producer thread starts
// cp.async.bulk.tensor loads of the (128 rows x 128 K bytes) weight tile
// and the (TOK x 128) token tile of each stage into a ring of `ring`
// stages (128-byte swizzle, full / empty mbarriers per stage); TMA's zero
// fill covers ragged M, N and a last half stage of K.  Two consumer
// warpgroups, 64 weight rows each, run four m64nTOKk32 wgmmas per stage
// from shared-memory descriptors and release the stage.  K is split over a
// thread-block cluster of `splits` blocks (<= 8): each block parks its
// int32 partial tile in its own freed ring, and after a cluster barrier
// each block sums one share of the tile over every block's partial
// (distributed shared memory, all of a vector's loads in flight; int32,
// exact in any order), dequantizes it and writes float32 with 16-byte
// stores along N.  No global workspace, no atomics.  (Bulk reductions
// pushed into the owner, cp.reduce.async.bulk .add.s32, timed slower.)
// The plan (TOK, splits, K stages per split, ring depth) is chosen in
// Python (kernel.py::plan) and passed in.  Two blocks fit an SM.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "sm90_pipeline.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 128;                  // weight rows per block
constexpr int KS = 128;                  // K bytes per ring stage
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int BNP = BN + 4;              // staging row pitch (int32), no
                                         // bank conflicts on the fragment
constexpr int MAX_SMEM = 232448;         // 227 KB a block can opt into

template <int TOK>
__host__ __device__ constexpr int stage_bytes() { return (BN + TOK) * KS; }

// the ring, or the parked partial tile when that is larger; its barriers
// follow it
template <int TOK>
__host__ __device__ constexpr int ring_bytes(int ring) {
  return ring * stage_bytes<TOK>() > TOK * BNP * 4 ? ring * stage_bytes<TOK>()
                                                   : TOK * BNP * 4;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = sm90::smem_addr(p);
  return p + (((a + 1023) & ~1023u) - a);
}

template <int TOK>
__global__ void __launch_bounds__(THREADS, 2)
int8_w8a8_kernel(const __grid_constant__ CUtensorMap tmw,
                 const __grid_constant__ CUtensorMap tmx,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 float* __restrict__ out, int M, int N, int k_stages,
                 int per_split, int ring) {
  constexpr int W_BYTES = BN * KS, STAGE = stage_bytes<TOK>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring_bytes<TOK>(ring));
  uint64_t* empty = full + ring;
  float* scale_x = reinterpret_cast<float*>(empty + ring);  // TOK of sx
  float* scale_w = scale_x + TOK;                            // BN of sw
  cg::cluster_group cluster = cg::this_cluster();

  // the cluster spans grid x: one block per K slice of one output tile
  const int split = blockIdx.x, splits = gridDim.x;
  const int m0 = blockIdx.y * TOK, n0 = blockIdx.z * BN;
  const int s0 = split * per_split;
  const int n_st = max(0, min(k_stages, s0 + per_split) - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ring; ++i) {
      sm90::mbar_init(&full[i], 1);               // the producer's arrival
      sm90::mbar_init(&empty[i], CONSUMERS / 32); // one per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  int acc[TOK / 2];
#pragma unroll
  for (int i = 0; i < TOK / 2; ++i) acc[i] = 0;

  if (warp == CONSUMERS / 32) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      sm90::tma_prefetch_map(&tmw);
      sm90::tma_prefetch_map(&tmx);
      int st = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_st; ++i) {
        sm90::mbar_wait(&empty[st], phase ^ 1);
        uint8_t* tile = smem + st * STAGE;
        const int k = (s0 + i) * KS;
        sm90::mbar_arrive_expect_tx(&full[st], STAGE);
        sm90::tma_load_2d(tile, &tmw, &full[st], k, n0);
        sm90::tma_load_2d(tile + W_BYTES, &tmx, &full[st], k, m0);
        if (++st == ring) { st = 0; phase ^= 1; }
      }
    }
  } else {
    // consumers: the tile's scales for the epilogue (zeros past M and
    // N), read while the first stages are in flight; then warpgroup wg
    // multiplies weight rows 64 wg .. 64 wg + 63
    if (threadIdx.x < TOK)
      scale_x[threadIdx.x] = m0 + threadIdx.x < M ? sx[m0 + threadIdx.x] : 0.f;
    else if (threadIdx.x < TOK + BN)
      scale_w[threadIdx.x - TOK] = n0 + threadIdx.x - TOK < N
                                       ? sw[n0 + threadIdx.x - TOK] : 0.f;
    const int wg = warp >> 2;
    int st = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n_st; ++i) {
      sm90::mbar_wait(&full[st], phase);
      __syncwarp();                              // wgmma is warp-aligned
      const uint8_t* tile = smem + st * STAGE;
      const uint64_t da = sm90::desc_k_sw128(tile + wg * 64 * KS);
      const uint64_t db = sm90::desc_k_sw128(tile + W_BYTES);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 32; ++kk)       // 32 K bytes = 2 units
        sm90::MmaS8<TOK>::mma(acc, da + 2 * kk, db + 2 * kk, 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (lane == 0) sm90::mbar_arrive(&empty[st]);
      if (++st == ring) { st = 0; phase ^= 1; }
    }
  }
  __syncthreads();            // every stage consumed, the scales staged

  // park the partial tile as [token][weight row] int32: register 4j + 2h
  // + e of the fragment is weight row 16 (warp % 4) + lane / 4 + 8 h of
  // the warpgroup's 64, token 8 j + 2 (lane % 4) + e
  int* part = reinterpret_cast<int*>(smem);
  if (warp < CONSUMERS / 32) {
    const int row = 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);
    const int tok = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < TOK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          part[(8 * j + tok + e) * BNP + row + 8 * h] = acc[4 * j + 2 * h + e];
  }

  cluster.sync();                         // every partial parked

  // each block of the cluster sums one share of the tile's 16-byte
  // vectors over every block's partial tile and writes it dequantized.
  // A thread keeps one column group (THREADS is a multiple of BN / 4) and
  // takes two vectors a trip, all of their (up to 16) loads in flight.
  static_assert(THREADS % (BN / 4) == 0, "a thread's columns stay fixed");
  const int vecs = min(TOK, M - m0) * (BN / 4);
  const int share = (vecs + splits - 1) / splits;
  const int lo = min(vecs, split * share), hi = min(vecs, lo + share);
  uint32_t src[8];
#pragma unroll
  for (int b = 0; b < 8; ++b)
    src[b] = sm90::map_rank(sm90::smem_addr(part), b < splits ? b : 0);
  const int c4 = 4 * ((lo + threadIdx.x) % (BN / 4));
  const int n = n0 + c4;
  const float4 b4 = *reinterpret_cast<const float4*>(scale_w + c4);
  const float bw[4] = {b4.x, b4.y, b4.z, b4.w};
  const bool vec_out = (N & 3) == 0;
  for (int v = lo + threadIdx.x; v < hi && n < N; v += 2 * THREADS) {
    const bool two = v + THREADS < hi;
    const int r0 = v / (BN / 4), r1 = r0 + THREADS / (BN / 4);
    int4 t[2][8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if (b < splits)
        t[0][b] = sm90::ld_cluster_v4(src[b] + 4 * (r0 * BNP + c4));
      if (b < splits && two)
        t[1][b] = sm90::ld_cluster_v4(src[b] + 4 * (r1 * BNP + c4));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      int sv[4] = {t[u][0].x, t[u][0].y, t[u][0].z, t[u][0].w};
#pragma unroll
      for (int b = 1; b < 8; ++b)
        if (b < splits) {
          sv[0] += t[u][b].x; sv[1] += t[u][b].y;
          sv[2] += t[u][b].z; sv[3] += t[u][b].w;
        }
      const int r = u ? r1 : r0;
      const float a = scale_x[r];
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = __fmul_rn(__fmul_rn(__int2float_rn(sv[e]), a), bw[e]);
      float* o = out + static_cast<size_t>(m0 + r) * N + n;
      if (vec_out) {
        *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) o[e] = y[e];
      }
    }
  }
  cluster.sync();     // no block leaves while others read its tile
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (the library is
// not linked against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, Kp) int8, K contiguous, read as (box_rows x 128 K bytes) boxes
// with 128-byte swizzle; out-of-range elements load as zeros
bool encode(CUtensorMap* map, const void* base, int rows, int Kp,
            int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Kp),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Kp)};
  const cuuint32_t box[2] = {KS, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TOK>
cudaError_t launch(const CUtensorMap& tmw, const CUtensorMap& tmx,
                   const float* sx, const float* sw, float* out, int M, int N,
                   int k_stages, int splits, int per_split, int ring,
                   cudaStream_t stream) {
  const size_t smem = 1024 + ring_bytes<TOK>(ring) + 16 * ring
                      + 4 * (TOK + BN);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(int8_w8a8_kernel<TOK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (M + TOK - 1) / TOK, (N + BN - 1) / BN);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_w8a8_kernel<TOK>, tmw, tmx, sx, sw,
                           out, M, N, k_stages, per_split, ring);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The plan (kernel.py::plan): tok tokens a tile (8, 16, 32, 64 or 128),
// K cut into `splits` slices of `per_split` 128-byte stages (the last may
// be shorter; none empty), a ring of `ring` stages.
extern "C" int int8_w8a8(const void* x, const void* w, const void* sx,
                         const void* sw, void* out, int M, int N, int Kp,
                         int tok, int splits, int per_split, int ring,
                         void* stream) {
  const int k_stages = (Kp + KS - 1) / KS;
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % 64 || splits < 1 || splits > 8
      || per_split < 1 || ring < 2 || (splits - 1) * per_split >= k_stages
      || splits * per_split < k_stages
      || reinterpret_cast<uintptr_t>(x) % 16
      || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  alignas(64) CUtensorMap tmw, tmx;
  if (!encode(&tmw, w, N, Kp, BN) || !encode(&tmx, x, M, Kp, tok))
    return static_cast<int>(cudaErrorInvalidValue);
  auto a = static_cast<const float*>(sx);
  auto b = static_cast<const float*>(sw);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tok) {
    case 8: err = launch<8>(tmw, tmx, a, b, o, M, N, k_stages, splits,
                            per_split, ring, s); break;
    case 16: err = launch<16>(tmw, tmx, a, b, o, M, N, k_stages, splits,
                              per_split, ring, s); break;
    case 32: err = launch<32>(tmw, tmx, a, b, o, M, N, k_stages, splits,
                              per_split, ring, s); break;
    case 64: err = launch<64>(tmw, tmx, a, b, o, M, N, k_stages, splits,
                              per_split, ring, s); break;
    case 128: err = launch<128>(tmw, tmx, a, b, o, M, N, k_stages, splits,
                                per_split, ring, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
