// Skinny-M (M <= 32) prepacked hybrid-CIM GEMM for Hopper: the decode
// shape of the macro GEMM, streaming its weight bytes through a cp.async
// ring into int8 tensor cores.
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
// What bounds it: the bytes of w and the planes, each read once.  One
// minicpm-2b layer (sum N K = 68.1 M, two planes) moves 204 MB: 0.061 ms at
// 3.35 TB/s.  Everything else is smaller at every M <= 32: the MMAs (M padded
// to 8-token groups) take 2 x 32 x 3 x 68.1 M = 13 G int8 ops at M 32, 0.007
// ms at 1,979 TOPS; the per-chunk conversions (M_pad N Kp / acc_len = 136 M at
// M 32, four int32 ops each) 0.037 ms on 64 int32 lanes per SM at 1.98 GHz
// (data-sheet figures).  How the rows are read matters as much as how many
// bytes are in flight: on an H100 80GB HBM3 at 700 W, cp.async rings reading
// 64 bytes of each of 128 rows per stage streamed the layer's operands at 2.0
// TB/s, and 128 or more bytes per row at 2.7 TB/s (tools/stage_probe.cu).
//
// Design: the weights are the MMA's 16-row A operand (16 output columns x K)
// and the <= 32 tokens its n8 B operand, up to four token groups, because M is
// too small to fill 16 rows.  Every warp streams on its own: a persistent grid
// of one block per SM, 12 warps at M <= 8 and 8 above (x's rows and the
// registers take the room), and each warp takes an even share of the
// (16-column tile, 128-byte K stage) sequence in tile-major order (stream-K),
// so every shape is balanced to one stage per warp: at N 2,304 the tiles alone
// would fill 144 warps, 12 of 132 SMs.  A warp's ring holds two stages (w's and each
// plane's 16 rows x 128 bytes, then x's rows, each as two 64-byte halves
// swizzled as in ccim_mma.cuh), copied by cp.async with an L2 prefetch of 256
// bytes; while it computes one stage the next is in flight, and it waits only
// for its own copies: no block-wide barrier couples one warp's compute to
// another's loads.  (A block-wide ring with derived fragments shared by 8
// warps, deeper rings and more warps a block all streamed slower; PERF.md
// gives the measurements.)  Per stage and 64-byte half, a warp ldmatrix-es its
// 16 columns of w and of each plane as A, and x's rows of each token group as
// B (register s holds the b0 of 16-K step s), derives the activation
// bit-planes from x's fragment in registers, and runs one MMA chain per chunk
// and operand: acc_len 16 one m16n8k16, 32 one m16n8k32, 64 two m16n8k32
// chained over the half, 8 two m16n8k16 per 16 K with the other chunk's half
// of the B fragment zeroed by lane.  Each chunk is converted in the fragment,
// clamp((e + lsb/2) >> s, d - h, d + h - 1) with the chains seeded with lsb/2
// and -h (ccim_mma.cuh).  A stage never cuts a chunk, so where a tile is cut
// between warps each adds its partial sums to out with red.global.add: exact
// and order-free, since the clip is per chunk, and the entry point zeroes out
// on the stream first.  The skinny complex kernel (ccim_complex_skinny.cu)
// keeps ccim_common.cuh's dp4a helpers; this one uses ccim_mma.cuh's.
//
// Clip count: with a counter (int32, on the device) the entry point
// launches the instances that also count the conversions whose ADC code
// clipped (kCount; ccim_mma.cuh's convert_count and add_clips), over the
// valid (m < M, n < N) outputs only.  The counting instances zero-fill a
// live token group's rows past M (the others leave them stale, as flush
// never stores them), and the weight rows past N are zero-filled by every
// instance, so a padded output's conversion is t = 0 inside [-h, h - 1]
// and never counts: no mask in the loop.  Each thread counts in a
// register and each warp adds its sum once.  With no counter, the
// instances without it.
#include <algorithm>

#include "ccim_mma.cuh"

namespace {

using ccim::mma::cp_async_commit;
using ccim::mma::cp_async_wait;
using ccim::mma::ldmatrix_x4;
using ccim::mma::smem_addr;
using ccim::mma::swz;

// 16 bytes global -> shared, bypassing L1, zero-filled when !ok; the L2
// fetches the 256 bytes around the source, so a row's next stage is read
// from the same DRAM page at once
__device__ __forceinline__ void load16(unsigned dst, const void* src,
                                       bool ok) {
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(dst),
      "l"(src), "r"(ok ? 16 : 0));
}

constexpr int kRows = 16;             // weight rows (output columns) a tile
constexpr int kHalf = ccim::mma::kBK;   // K bytes of a half (64)
constexpr int kHalves = 2;            // 64-byte halves of a stage
constexpr int kK = kHalves * kHalf;   // K bytes of a stage (128)
constexpr int kPieces = kK / 16;      // 16-byte pieces of a row's stage

// One warp's ring for TG token groups (x rows 8 TG) and NP planes: a stage
// holds w's and each plane's 16 rows, then x's rows, each as two (rows,
// 64-byte) halves in ccim_mma.cuh's swizzled layout.  Two stages a warp:
// one in flight while the other is computed.  Twelve warps a block at one
// token group, eight at four (x's rows take the room and the registers).
template <int TG, int NP>
struct Ring {
  static constexpr int kOps = (1 + NP) * kRows * kK;
  static constexpr int kXHalf = 8 * TG * kHalf;  // bytes of x's half
  static constexpr int kStage = kOps + kHalves * kXHalf;
  static constexpr int kWarps = TG == 1 ? 12 : 8;
  static constexpr int kStages = 2;
  static constexpr int kBytes = kWarps * kStages * kStage;
  static_assert(kBytes <= 227 * 1024, "ring");
};

struct Args {
  const int8_t* x;
  const int8_t* w;
  const int8_t* planes;
  int32_t* out;
  int M, N, Kp, x_bits, lsb_shift, adc_half;
  int split;  // 1: out was zeroed and every partial sum is added
  int32_t* clips;  // the clip count (kCount instances), or null
};

__host__ __device__ inline long cdiv(long a, long b) {
  return (a + b - 1) / b;
}

// stages of the (16-column tile, K stage) sequence
inline long total_stages(int N, int Kp) {
  return cdiv(N, kRows) * cdiv(Kp, kK);
}

// warps a block for M rows of x (the same at every plane count)
inline int warps_per_block(int M) {
  return M <= 8 ? Ring<1, 0>::kWarps : Ring<4, 0>::kWarps;
}

// blocks of the persistent grid: one per SM, no more than the stages fill
inline int grid_blocks(int M, int N, int Kp) {
  return static_cast<int>(std::min<long>(
      cdiv(total_stages(N, Kp), warps_per_block(M)), ccim::mma::sm_count()));
}

template <int ACC, int TG, int NP, bool kCount>
__global__ void __launch_bounds__(32 * Ring<TG, NP>::kWarps, 1)
    skinny_kernel(const Args a) {
  using R = Ring<TG, NP>;
  constexpr int S = R::kStages;
  extern __shared__ __align__(128) int8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int8_t* const ring = smem + warp * S * R::kStage;
  const int ntg = (a.M + 7) >> 3;              // live token groups
  const int ks_n = (a.Kp + kK - 1) / kK;       // K stages per tile
  const long T = cdiv(a.N, kRows) * ks_n;
  // warps with a share: every one, or one per stage
  const long grid_warps = static_cast<long>(gridDim.x) * R::kWarps;
  const long TW = grid_warps < T ? grid_warps : T;
  const long gw = static_cast<long>(blockIdx.x) * R::kWarps + warp;
  const long L0 = gw < TW ? gw * T / TW : T;   // this warp's share
  const int n_st = static_cast<int>((gw < TW ? (gw + 1) * T / TW : T) - L0);

  // stage t of the share -> its ring slot; 16-byte piece s8 of a row's
  // stage lands in half s8 / 4 at segment s8 % 4
  auto load = [&](int t) {
    int8_t* st = ring + (t % S) * R::kStage;
    const long L = L0 + t;
    const int n0 = static_cast<int>(L / ks_n) * kRows;
    const int k0 = static_cast<int>(L % ks_n) * kK;
#pragma unroll
    for (int op = 0; op <= NP; ++op) {
      const int8_t* base =
          op == 0 ? a.w : a.planes + (size_t)(op - 1) * a.N * a.Kp;
#pragma unroll
      for (int i = 0; i < kRows * kPieces / 32; ++i) {
        const int p = lane + 32 * i, r = p / kPieces, s8 = p % kPieces;
        const int n = n0 + r, k = k0 + 16 * s8;
        const bool ok = n < a.N && k < a.Kp;
        load16(smem_addr(st + op * kRows * kK +
                             (s8 >> 2) * kRows * kHalf + swz(r, s8 & 3)),
                   ok ? base + (size_t)n * a.Kp + k : base, ok);
      }
    }
    // x rows 0 .. M - 1 only: a row past M or a byte past Kp meets
    // outputs that are not stored or zero weights (kCount: a live token
    // group's rows past M are zero-filled, so they never count a clip)
#pragma unroll
    for (int i = 0; i < kHalves * TG; ++i) {
      const int p = lane + 32 * i, r = p / kPieces, s8 = p % kPieces;
      const int k = k0 + 16 * s8;
      const bool ok = r < a.M && k < a.Kp;
      if (kCount ? r < 8 * ntg : ok)
        load16(smem_addr(st + R::kOps + (s8 >> 2) * R::kXHalf +
                             swz(r, s8 & 3)),
                   ok ? a.x + (size_t)r * a.Kp + k : a.x, ok);
    }
  };

  const int half = (1 << a.lsb_shift) >> 1;
  const int seed_ex[4] = {half, half, half, half};
  const int span = 2 * a.adc_half - 1;
  int jbit[NP > 0 ? NP : 1];
#pragma unroll
  for (int pl = 0; pl < NP; ++pl) jbit[pl] = (a.x_bits >> (4 * pl)) & 0xF;
  // acc_len 8: the B half a lane keeps for the chunk at k 0-7 / 8-15
  const unsigned keep_lo = (lane & 2) ? 0u : ~0u, keep_hi = ~keep_lo;
  const int q = lane >> 3, i8 = lane & 7;  // ldmatrix: matrix q, row i8

  int acc[TG][4];
#pragma unroll
  for (int tg = 0; tg < TG; ++tg)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[tg][r] = 0;

  [[maybe_unused]] int n_clip = 0;  // kCount: this thread's clipped codes

  // one stage, half by half: the tile's 16 columns of every operand
  // against each token group's x and bit-planes
  auto compute = [&](int t) {
    const int8_t* st = ring + (t % S) * R::kStage;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      // A: per operand and 32-byte quarter of the half, the k32 fragment
      // of 16 columns; {r0, r1} is the k16 fragment of its first 16 K,
      // {r2, r3} of its second
      unsigned av[1 + NP][2][4];
#pragma unroll
      for (int op = 0; op <= NP; ++op)
#pragma unroll
        for (int hp = 0; hp < 2; ++hp)
          ldmatrix_x4(av[op][hp],
                      smem_addr(st + op * kRows * kK + h * kRows * kHalf +
                                swz((q & 1) * 8 + i8, 2 * hp + (q >> 1))));
#pragma unroll
      for (int tg = 0; tg < TG; ++tg) {
        if (tg >= ntg) break;
        // B: x rows 8 tg.. as stored; register s is the b0 of 16-K step s
        // (x[8 tg + g][16 s + 4 t4 ..]), (b0, b1) of k32 step s / 2
        unsigned b[1 + NP][4];
        ldmatrix_x4(b[0], smem_addr(st + R::kOps + h * R::kXHalf +
                                    swz(8 * tg + i8, q)));
        if constexpr (NP > 0) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const ccim::mma::Mag4 v = ccim::mma::mag4(b[0][s]);
#pragma unroll
            for (int pl = 0; pl < NP; ++pl)
              b[1 + pl][s] = ccim::mma::plane4(v, jbit[pl]);
          }
        }
        int e[4], d[4];
        if constexpr (ACC == 8 || ACC == 16) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {      // the half's 16-K steps
            const int hp = s >> 1, h2 = 2 * (s & 1);
#pragma unroll
            for (int c = 0; c < (ACC == 8 ? 2 : 1); ++c) {
              const unsigned keep =
                  ACC == 16 ? ~0u : (c == 0 ? keep_lo : keep_hi);
              ccim::mma::mma_k16(e, av[0][hp][h2], av[0][hp][h2 + 1],
                                 b[0][s] & keep, seed_ex);
              d[0] = d[1] = d[2] = d[3] = -a.adc_half;
#pragma unroll
              for (int pl = 0; pl < NP; ++pl)
                ccim::mma::mma_k16(d, av[1 + pl][hp][h2],
                                   av[1 + pl][hp][h2 + 1],
                                   b[1 + pl][s] & keep, d);
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                if constexpr (kCount) {
                  acc[tg][r] += ccim::mma::convert_count(
                      e[r], d[r], a.lsb_shift, span, n_clip);
                } else {
                  acc[tg][r] += ccim::mma::convert_folded(e[r], d[r],
                                                          a.lsb_shift, span);
                }
              }
            }
          }
        } else {
          // acc_len 32: one k32 MMA per chunk; 64: chained over the
          // quarters
#pragma unroll
          for (int hp = 0; hp < 2; ++hp) {
            if (ACC == 32 || hp == 0) {
#pragma unroll
              for (int r = 0; r < 4; ++r) e[r] = half, d[r] = -a.adc_half;
            }
            ccim::mma::mma_k32(e, av[0][hp], b[0][2 * hp], b[0][2 * hp + 1],
                               e);
#pragma unroll
            for (int pl = 0; pl < NP; ++pl)
              ccim::mma::mma_k32(d, av[1 + pl][hp], b[1 + pl][2 * hp],
                                 b[1 + pl][2 * hp + 1], d);
            if (ACC == 32 || hp == 1) {
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                if constexpr (kCount) {
                  acc[tg][r] += ccim::mma::convert_count(
                      e[r], d[r], a.lsb_shift, span, n_clip);
                } else {
                  acc[tg][r] += ccim::mma::convert_folded(e[r], d[r],
                                                          a.lsb_shift, span);
                }
              }
            }
          }
        }
      }
    }
  };

  // The tile's sums -> out: stored, or added when the tile is cut between
  // warps.  C fragment: rows g and g + 8 are columns, columns 2 t4 and
  // 2 t4 + 1 tokens of each group.
  auto flush = [&](int n0) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int tg = 0; tg < TG; ++tg)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = 8 * tg + 2 * t4 + (r & 1);
        const int n = n0 + g + 8 * (r >> 1);
        if (tg < ntg && m < a.M && n < a.N) {
          const unsigned v = static_cast<unsigned>(acc[tg][r]) << a.lsb_shift;
          unsigned* dst =
              reinterpret_cast<unsigned*>(a.out) + (size_t)m * a.N + n;
          if (a.split)
            atomicAdd(dst, v);
          else
            *dst = v;
        }
        acc[tg][r] = 0;
      }
  };

  // The warp's ring: stages t + 1 .. t + S - 1 stay in flight while stage
  // t is computed.  No block-wide barrier: a warp waits for its own copies.
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_st) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < n_st; ++t) {
    cp_async_wait<S - 2>();
    __syncwarp();  // stage t landed; every lane is done with stage t - 1
    if (t + S - 1 < n_st) load(t + S - 1);
    cp_async_commit();
    compute(t);
    const long L = L0 + t;
    if (t + 1 == n_st || (L + 1) % ks_n == 0)
      flush(static_cast<int>(L / ks_n) * kRows);
  }
  cp_async_wait<0>();
  if constexpr (kCount) ccim::mma::add_clips(a.clips, n_clip);
}

template <int ACC, int TG, int NP, bool kCount>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  using R = Ring<TG, NP>;
  static bool sized = false;  // above 48 KB needs the opt-in, once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        skinny_kernel<ACC, TG, NP, kCount>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  skinny_kernel<ACC, TG, NP, kCount>
      <<<blocks, 32 * R::kWarps, R::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <int ACC, int TG, bool kCount>
cudaError_t launch_planes(const Args& a, int n_planes, int blocks,
                          cudaStream_t stream) {
  switch (n_planes) {
    case 0: return launch<ACC, TG, 0, kCount>(a, blocks, stream);
    case 1: return launch<ACC, TG, 1, kCount>(a, blocks, stream);
    case 2: return launch<ACC, TG, 2, kCount>(a, blocks, stream);
    case 3: return launch<ACC, TG, 3, kCount>(a, blocks, stream);
  }
  return cudaErrorInvalidValue;
}

template <int ACC, bool kCount>
cudaError_t launch_tg(const Args& a, int n_planes, int blocks,
                      cudaStream_t stream) {
  return a.M <= 8
             ? launch_planes<ACC, 1, kCount>(a, n_planes, blocks, stream)
             : launch_planes<ACC, 4, kCount>(a, n_planes, blocks, stream);
}

// the clip-counting instances when a.clips is set, else today's kernel
template <int ACC>
cudaError_t launch_m(const Args& a, int n_planes, int blocks,
                     cudaStream_t stream) {
  return a.clips ? launch_tg<ACC, true>(a, n_planes, blocks, stream)
                 : launch_tg<ACC, false>(a, n_planes, blocks, stream);
}

}  // namespace

// Bytes of K that the largest warp's share of the (16-column tile, K
// stage) sequence spans for this shape on the current device: below Kp,
// every tile is cut between warps; above, a warp walks several tiles.
extern "C" int ccim_prepacked_skinny_k_split(int M, int N, int Kp,
                                             int acc_len) {
  (void)acc_len;  // the walk depends on M, N and Kp only
  if (M <= 0 || N <= 0 || Kp <= 0) return 0;
  const long T = total_stages(N, Kp);
  const long warps = std::min<long>(
      (long)grid_blocks(M, N, Kp) * warps_per_block(M), T);
  return static_cast<int>(cdiv(T, warps) * kK);
}

extern "C" int ccim_prepacked_skinny(const void* x, const void* w,
                                     const void* planes, void* out, int M,
                                     int N, int Kp, int n_planes, int x_bits,
                                     int lsb_shift, int adc_half, int acc_len,
                                     void* clips, void* stream) {
  if (M <= 0 || M > 32 || N <= 0 || Kp <= 0 || Kp % 16 || n_planes < 0 ||
      n_planes > ccim::kMaxPlanes ||
      (acc_len != 8 && acc_len != 16 && acc_len != 32 && acc_len != 64) ||
      Kp % acc_len)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_blocks(M, N, Kp);
  const long tiles = cdiv(N, kRows), ks_n = cdiv(Kp, kK);
  const long warps =
      std::min<long>((long)blocks * warps_per_block(M), tiles * ks_n);
  // No share starts inside a tile when a tile is one stage or the warps
  // divide the tiles evenly; otherwise tiles are taken as cut (at worst
  // out is zeroed for nothing).
  const int split = ks_n > 1 && tiles % warps != 0;
  if (split) {
    const cudaError_t e =
        cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)M * N, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               static_cast<const int8_t*>(planes), static_cast<int32_t*>(out),
               M, N, Kp, x_bits, lsb_shift, adc_half, split,
               static_cast<int32_t*>(clips)};
  cudaError_t err = cudaErrorInvalidValue;
  switch (acc_len) {
    case 8: err = launch_m<8>(a, n_planes, blocks, s); break;
    case 16: err = launch_m<16>(a, n_planes, blocks, s); break;
    case 32: err = launch_m<32>(a, n_planes, blocks, s); break;
    case 64: err = launch_m<64>(a, n_planes, blocks, s); break;
  }
  return static_cast<int>(err);
}
