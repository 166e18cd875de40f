// General-M prepacked hybrid-CIM GEMM for Hopper: the prefill shape of
// the macro GEMM, on the int8 tensor cores.
//
// Replaces: src/repro/kernels/ccim_matmul/kernel.py,
//   ccim_matmul_prepacked_pallas (body _ccim_kernel_prepacked).
//
// Operands as in the skinny kernel (K contiguous):
//   x (M, Kp) int8, w (N, Kp) int8, planes (n_planes, N, Kp) int8,
//   out (M, N) int32 at product scale.
// The K range [0, Kp) is cut into splits of k_split bytes (a multiple of
// the 64-byte stage, so of every admitted acc_len), one per blockIdx.z;
// the entry point picks the split (pick_k_split) for the shape and the
// card and, when there is more than one, zeroes out on the stream so the
// splits add into it.
//
// Per chunk, with lsb = 2^s and h = adc_half, the conversion
//   dcim + clamp(floor((exact - lsb dcim + lsb/2) / lsb), -h, h - 1)
// equals, exactly in integers,
//   clamp((exact + lsb/2) >> s, dcim - h, dcim + h - 1),
// so the exact MMA chain starts from lsb/2 and the DCIM chain from -h,
// and a conversion is four integer ops: shift, max, add-min, add.
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
// wgmma is not used: its int8 form takes K = 32 per instruction, so at
// the prototype's acc_len 16 a chunk is half an instruction (half its
// work wasted on zeros), and its asynchronous accumulators would have to
// be waited on after every instruction to clip each chunk.  mma.sync
// returns its sum in registers per instruction, which is what a
// per-chunk clip needs.
//
// Design: a 128 x 128 output tile per 256-thread block, its 8 warps stacked
// along M, each one m16 row of 16 n8 MMA tiles (at acc_len 64, 64 x 128 with 4
// x 2 warps of 8 tiles).  Stacked along M, no two warps derive the same
// bit-planes (a 2 x 4 warp grid would read w and the planes from shared memory
// a quarter as often, but have four warps derive each row's planes).  K streams through a
// 3-stage cp.async ring of 64-byte stages holding x, w and the folded planes,
// rows swizzled (16-byte segment s of row r at s ^ ((r >> 1) & 3)) so that
// ldmatrix reads 8 rows without bank conflicts.  ldmatrix yields the .row A
// fragments of x and the .col B fragments of w and of each plane as stored: no
// transpose.  The activation bit-plane A fragments are derived from x's in
// registers.  One mma.sync per chunk and operand pair, never across a chunk
// boundary: acc_len 16 one m16n8k16; 32 one m16n8k32; 64 two m16n8k32 chained
// over the stage's two halves; 8 two m16n8k16 per 16 K, each with the other
// chunk's half of the B fragment zeroed by lane (lanes with tid_in_group 0-1
// hold k 0-7).  Each chunk's 4 + 4 sums are converted in the fragment and added
// to the tile's running int32 accumulator; partial sums of lsb (dcim + code)
// from disjoint chunk ranges then add exactly in any order (mod 2^32, as the
// reference's int32 sum), so split-K adds with red.global.add.
#include "ccim_common.cuh"

namespace {

constexpr int kThreads = 256;                 // 8 warps
constexpr int kBN = 128;                      // block tile columns
constexpr int kBK = 64;                       // K bytes per stage
constexpr int kStages = 3;
constexpr int kNG = 8;                        // n8 tiles of B read at a time

// WM x WN warps, each one m16 row of NT n8 MMA tiles.  Below acc_len 64
// the warps stack along M, so no two derive the same bit-planes; at 64 a
// chunk's sums live across the stage's halves, which halves the tiles a
// warp can hold.
template <int ACC>
struct Tile {
  static constexpr int WM = ACC >= 64 ? 4 : 8, NT = ACC >= 64 ? 8 : 16;
  static constexpr int WN = 8 / WM, BM = 16 * WM;
  static_assert(8 * NT * WN == kBN && NT % kNG == 0, "tile");
};

template <int ACC, int NP>
__host__ __device__ constexpr int stage_bytes() {
  return (Tile<ACC>::BM + (1 + NP) * kBN) * kBK;
}

struct Args {
  const int8_t* x;
  const int8_t* w;
  const int8_t* planes;
  int32_t* out;
  int M, N, Kp, x_bits, lsb_shift, adc_half, k_split;
};

// byte offset of 16-byte segment s of row r in a 64-byte-row stage
__device__ __forceinline__ int swz(int r, int s) {
  return r * kBK + ((s ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !ok
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d = a (16 x 16, row) . b (16 x 8, col) + c, s8 x s8 -> s32
__device__ __forceinline__ void mma_k16(int (&d)[4], unsigned a0, unsigned a1,
                                        unsigned b, const int (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(c[0]), "r"(c[1]), "r"(c[2]),
        "r"(c[3]));
}

// d = a (16 x 32, row) . b (32 x 8, col) + c
__device__ __forceinline__ void mma_k32(int (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1,
                                        const int (&c)[4]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

// Activation bit-planes of four packed int8 lanes, per byte
// sign(x) * ((|x| >> j) & 1) -- ccim::bit_plane4 in fewer ops: the sign
// mask comes from one byte permute (sign-replicate mode), and |x| <= 127
// (SMF ints) keeps (x ^ s) + (s & 1) inside each byte.
struct Mag4 {
  unsigned mag, keep;  // |x| per byte; 0xFF for a negative byte, else 0x01
};

__device__ __forceinline__ Mag4 mag4(unsigned x) {
  unsigned s;
  asm("prmt.b32 %0, %1, 0, 0xBA98;\n" : "=r"(s) : "r"(x));
  return {(x ^ s) + (s & 0x01010101u), s | 0x01010101u};
}

__device__ __forceinline__ unsigned plane4(Mag4 v, int j) {
  const unsigned bits = (v.mag >> j) & 0x01010101u;  // 0/1 per byte
  return (bits * 0xFFu) & v.keep;                    // 0, +1 or -1
}

// One conversion, folded: ex = exact + lsb/2, dc = dcim - adc_half,
// span = 2 adc_half - 1 -> dcim + code
__device__ __forceinline__ int convert_folded(int ex, int dc, int shift,
                                              int span) {
  return __viaddmin_s32(dc, span, max(ex >> shift, dc));
}

template <int ACC, int NP>
__global__ void __launch_bounds__(kThreads, 1) general_kernel(const Args a) {
  using T = Tile<ACC>;
  constexpr int NT = T::NT, BM = T::BM;
  constexpr int XB = BM * kBK, WB = kBN * kBK, SB = stage_bytes<ACC, NP>();
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * a.k_split;
  const int ke = min(a.Kp, kb + a.k_split);
  const int n_tiles = (ke - kb + kBK - 1) / kBK;

  // one stage: x rows m0.., then w and each plane, rows n0..; 16 bytes
  // a thread per copy, zeros past M, N and the split's end
  auto load = [&](int stage, int k0) {
    int8_t* st = smem + stage * SB;
#pragma unroll
    for (int i = 0; i < BM * 4 / kThreads; ++i) {
      const int p = tid + i * kThreads, r = p >> 2, s = p & 3;
      const int m = m0 + r, k = k0 + 16 * s;
      const bool ok = m < a.M && k < ke;
      cp_async16(smem_addr(st + swz(r, s)),
                 ok ? a.x + (size_t)m * a.Kp + k : a.x, ok);
    }
#pragma unroll
    for (int op = 0; op <= NP; ++op) {
      const int8_t* base =
          op == 0 ? a.w : a.planes + (size_t)(op - 1) * a.N * a.Kp;
#pragma unroll
      for (int i = 0; i < kBN * 4 / kThreads; ++i) {
        const int p = tid + i * kThreads, r = p >> 2, s = p & 3;
        const int n = n0 + r, k = k0 + 16 * s;
        const bool ok = n < a.N && k < ke;
        cp_async16(smem_addr(st + XB + op * WB + swz(r, s)),
                   ok ? base + (size_t)n * a.Kp + k : a.w, ok);
      }
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

  int acc[NT][4];
  int ex[NT][4], dc[NT][4];  // acc_len 64: a chunk spans 2 halves
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0;

  // ldmatrix lane roles: matrix q = lane / 8, its row i = lane % 8
  const int q = lane >> 3, i8 = lane & 7;

  auto compute = [&](const int8_t* st) {
#pragma unroll
    for (int hp = 0; hp < 2; ++hp) {  // the stage's two 32-byte halves
      // A: x's k32 fragment of the warp's m16 row in this half, then
      // each plane's
      unsigned ax[1 + NP][4];
      ldmatrix_x4(ax[0], smem_addr(st + swz(wm * 16 + (q & 1) * 8 + i8,
                                            2 * hp + (q >> 1))));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const Mag4 v = mag4(ax[0][r]);
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) ax[1 + pl][r] = plane4(v, jbit[pl]);
      }
#pragma unroll
      for (int ng = 0; ng < NT; ng += kNG) {
        // B: per operand and n8 tile, k32 fragment {b0, b1} of this half
        unsigned b[1 + NP][kNG][2];
#pragma unroll
        for (int op = 0; op <= NP; ++op)
#pragma unroll
          for (int u = 0; u < kNG / 2; ++u) {
            unsigned r[4];
            const int row = wn * 8 * NT + (ng + 2 * u + (q >> 1)) * 8 + i8;
            ldmatrix_x4(r, smem_addr(st + XB + op * WB +
                                     swz(row, 2 * hp + (q & 1))));
            b[op][2 * u][0] = r[0];
            b[op][2 * u][1] = r[1];
            b[op][2 * u + 1][0] = r[2];
            b[op][2 * u + 1][1] = r[3];
          }
#pragma unroll
        for (int j = 0; j < kNG; ++j) {
          const int nt = ng + j;
          int e[4], d[4];
          if constexpr (ACC == 8 || ACC == 16) {
#pragma unroll
            for (int h = 0; h < 2; ++h)      // the half's two 16-K steps
#pragma unroll
              for (int c = 0; c < (ACC == 8 ? 2 : 1); ++c) {
                const unsigned keep =
                    ACC == 16 ? ~0u : (c == 0 ? keep_lo : keep_hi);
                mma_k16(e, ax[0][2 * h], ax[0][2 * h + 1],
                        b[0][j][h] & keep, seed_ex);
                d[0] = d[1] = d[2] = d[3] = -a.adc_half;
#pragma unroll
                for (int pl = 0; pl < NP; ++pl)
                  mma_k16(d, ax[1 + pl][2 * h], ax[1 + pl][2 * h + 1],
                          b[1 + pl][j][h] & keep, d);
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  acc[nt][r] +=
                      convert_folded(e[r], d[r], a.lsb_shift, span);
              }
          } else {
            // acc_len 32: one k32 MMA per chunk; 64: chained over halves
            const bool first = ACC == 32 || hp == 0;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              e[r] = first ? half : ex[nt][r];
              d[r] = first ? -a.adc_half : dc[nt][r];
            }
            mma_k32(e, ax[0], b[0][j][0], b[0][j][1], e);
#pragma unroll
            for (int pl = 0; pl < NP; ++pl)
              mma_k32(d, ax[1 + pl], b[1 + pl][j][0], b[1 + pl][j][1], d);
            if (ACC == 32 || hp == 1) {
#pragma unroll
              for (int r = 0; r < 4; ++r)
                acc[nt][r] += convert_folded(e[r], d[r], a.lsb_shift, span);
            } else {
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                ex[nt][r] = e[r];
                dc[nt][r] = d[r];
              }
            }
          }
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s, kb + s * kBK);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    const int nxt = t + kStages - 1;
    if (nxt < n_tiles) load(nxt % kStages, kb + nxt * kBK);
    cp_async_commit();
    compute(smem + (t % kStages) * SB);
  }
  cp_async_wait<0>();

  // C fragment: rows g and g + 8, columns 2 t and 2 t + 1 of each tile
  const int g = lane >> 2, t4 = lane & 3;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + wm * 16 + g + (r >> 1) * 8;
      const int n = n0 + wn * 8 * NT + nt * 8 + 2 * t4 + (r & 1);
      if (m >= a.M || n >= a.N) continue;
      const unsigned v = static_cast<unsigned>(acc[nt][r]) << a.lsb_shift;
      unsigned* o = reinterpret_cast<unsigned*>(a.out) + (size_t)m * a.N + n;
      if (split)
        atomicAdd(o, v);
      else
        *o = v;
    }
}

template <int ACC, int NP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = kStages * stage_bytes<ACC, NP>();
  static bool sized = false;  // above 48 KB needs the opt-in, once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        general_kernel<ACC, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  constexpr int BM = Tile<ACC>::BM;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + BM - 1) / BM,
                  (a.Kp + a.k_split - 1) / a.k_split);
  general_kernel<ACC, NP><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int ACC>
cudaError_t launch_planes(const Args& a, int n_planes, cudaStream_t stream) {
  switch (n_planes) {
    case 0: return launch<ACC, 0>(a, stream);
    case 1: return launch<ACC, 1>(a, stream);
    case 2: return launch<ACC, 2>(a, stream);
    case 3: return launch<ACC, 3>(a, stream);
  }
  return cudaErrorInvalidValue;
}

long cdiv(long a, long b) { return (a + b - 1) / b; }

// Bytes of K per split: whole 64-byte stages, so whole chunks at every
// admitted acc_len.  Minimizes waves x (stages per split + 2), the 2 for a
// block's fill and store, at one block per SM: few output tiles (the
// N-2304 GEMMs at M 128) split K over the card, many tiles keep it whole.
// Ties go to fewer splits.
int pick_k_split(int M, int N, int Kp, int acc_len, int n_sm) {
  const int bm = acc_len >= 64 ? Tile<64>::BM : Tile<16>::BM;
  const long blocks = cdiv(M, bm) * cdiv(N, kBN), stages = cdiv(Kp, kBK);
  long best = -1, best_per = stages;
  for (long per = stages; per >= 1; --per) {
    const long cost = cdiv(blocks * cdiv(stages, per), n_sm) * (per + 2);
    if (best < 0 || cost < best) best = cost, best_per = per;
  }
  return static_cast<int>(best_per * kBK);
}

// SMs of the current device, read once per device
int sm_count() {
  static int count[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (!count[dev] && cudaDeviceGetAttribute(
                         &count[dev], cudaDevAttrMultiProcessorCount, dev) !=
                         cudaSuccess)
    return 1;
  return count[dev];
}

}  // namespace

// The split of K (bytes) that ccim_prepacked_general takes for this shape
// on the current device.
extern "C" int ccim_prepacked_general_k_split(int M, int N, int Kp,
                                              int acc_len) {
  return pick_k_split(M, N, Kp, acc_len, sm_count());
}

extern "C" int ccim_prepacked_general(const void* x, const void* w,
                                      const void* planes, void* out, int M,
                                      int N, int Kp, int n_planes, int x_bits,
                                      int lsb_shift, int adc_half, int acc_len,
                                      void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % 16 || n_planes < 0 ||
      n_planes > ccim::kMaxPlanes ||
      (acc_len != 8 && acc_len != 16 && acc_len != 32 && acc_len != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int k_split = pick_k_split(M, N, Kp, acc_len, sm_count());
  const auto s = static_cast<cudaStream_t>(stream);
  if (k_split < Kp) {  // the splits add into a zeroed out
    const cudaError_t e =
        cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)M * N, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               static_cast<const int8_t*>(planes), static_cast<int32_t*>(out),
               M, N, Kp, x_bits, lsb_shift, adc_half, k_split};
  cudaError_t err = cudaErrorInvalidValue;
  switch (acc_len) {
    case 8: err = launch_planes<8>(a, n_planes, s); break;
    case 16: err = launch_planes<16>(a, n_planes, s); break;
    case 32: err = launch_planes<32>(a, n_planes, s); break;
    case 64: err = launch_planes<64>(a, n_planes, s); break;
  }
  return static_cast<int>(err);
}
