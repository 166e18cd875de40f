// The hybrid-CIM GEMM on Hopper's int8 tensor cores, shared by four
// kernels that differ in how a stage of K reaches shared memory and in
// how many weight sides one residency holds:
//
//   ccim_prepacked_general.cu  PackedFill, one side: prepacked w (N, Kp)
//                              and folded planes (n_planes, N, Kp), K
//                              contiguous
//   ccim_unpacked.cu           RawFill, one side: raw (Kp, N) weights, N
//                              contiguous, transposed and folded into P6,
//                              P5 here
//   ccim_complex_general.cu    PackedFill, two sides: the (Re, Im) packs
//                              of a complex weight, one residency serving
//                              four sub-MAC streams
//   ccim_complex_unpacked.cu   RawFill, two sides: the raw (Kp, N) Re and
//                              Im weights, each transposed and folded
//                              here, one residency serving four streams
//
// The MMAs, the folded conversion, the split of K and the epilogue are
// one template, general_kernel<ACC, NP, Fill, S>, S the number of sides.
//
// Operands: x (M, Kp) int8 per side, out (M, N) int32 at product scale
// per output.  The K range [0, Kp) is cut into splits of k_split bytes (a
// multiple of the 64-byte stage, so of every admitted acc_len), one per
// blockIdx.z; the entry point picks the split (pick_k_split) for the
// shape and the card and, when there is more than one, zeroes the
// outputs on the stream so the splits add into them.
//
// Per chunk, with lsb = 2^s and h = adc_half, the conversion
//   dcim + clamp(floor((exact - lsb dcim + lsb/2) / lsb), -h, h - 1)
// equals, exactly in integers,
//   clamp((exact + lsb/2) >> s, dcim - h, dcim + h - 1),
// so the exact MMA chain starts from lsb/2 and the DCIM chain from -h,
// and a conversion is four integer ops: shift, max, add-min, add.
//
// Two sides (the complex MAC, prototype numerics only: acc_len 16):
// activations x_re, x_im and weight sides Re = (w, P6, P5)_re, Im = (w,
// P6, P5)_im give four streams per chunk, ac = (x_re, Re), bd = (x_im,
// Im), ad = (x_re, Im), bc = (x_im, Re), each one exact MMA and one DCIM
// chain, each converted on its own; then y_re += cv_ac - cv_bd and y_im
// += cv_ad + cv_bc.  Every stream is clipped before they are combined
// (subtracting the exact dots first would give other integers).
//
// Tile: 8 warps of a 256-thread block stacked along M, each one m16 row
// of NT n8 MMA tiles per side: one side 128 x 128 (NT 16), two sides 128
// x 64 (NT 8, the same 64 accumulators a thread); at acc_len 64 (one
// side) 64 x 128 with 4 x 2 warps of 8 tiles.  Stacked along M, no two
// warps derive the same bit-planes.  A warp whose m16 rows all lie past
// M skips its MMAs and conversions and only helps to fill, so a small M
// costs the fill and one warp's MMAs per block.  K streams through a
// 3-stage cp.async ring of 64-byte stages.  compute() reads each side's
// x and weight operands (w, then each plane) as (rows, 64 bytes of K)
// tiles, rows swizzled (16-byte segment s of row r at s ^ ((r >> 1) &
// 3)) so that ldmatrix reads 8 rows without bank conflicts; ldmatrix
// yields the .row A fragments of x and the .col B fragments of w and of
// each plane as stored: no transpose.  The activation bit-plane A
// fragments are derived from x's in registers.  One mma.sync per chunk
// and operand pair, never across a chunk boundary: acc_len 16 one
// m16n8k16; 32 one m16n8k32; 64 two m16n8k32 chained over the stage's
// two halves; 8 two m16n8k16 per 16 K, each with the other chunk's half
// of the B fragment zeroed by lane (lanes with tid_in_group 0-1 hold k
// 0-7).  Each chunk's sums are converted in the fragment and added to the
// tile's running int32 accumulator; partial sums of lsb (dcim + code)
// from disjoint chunk ranges then add exactly in any order (mod 2^32, as
// the reference's int32 sum), so split-K adds with red.global.add.
//
// Clip count (the telemetry tap of obs/taps.py): an instance with kCount
// adds to *a.clips the conversions whose ADC code clipped, raw < -h or raw
// > h - 1: in the folded form, those whose clamp moved t = (exact + lsb/2)
// >> s (convert_count).  The tile computes padded rows and columns too,
// and only valid (m < M, n < N) conversions are counted: here a padded
// row or column holds zeros (the fills zero-fill past M, N and the
// split's end), so its conversion is t = 0 inside [dc, dc + span] = [-h,
// h - 1] and never counts; the skinny kernel, whose padded token rows
// hold stale bytes, masks them.  Each thread counts in a register; a warp
// sums its lanes and adds once with atomicAdd.  The count-off instance
// (kCount false, a null pointer) is the kernel without it.
//
// wgmma is not used: its int8 form takes K = 32 per instruction, so at
// the prototype's acc_len 16 a chunk is half an instruction (half its
// work wasted on zeros), and its asynchronous accumulators would have to
// be waited on after every instruction to clip each chunk.  mma.sync
// returns its sum in registers per instruction, which is what a
// per-chunk clip needs.
//
// Fills:
//   PackedFill  cp.async of each side's x, w and planes into the stage,
//               in compute's layout.
//   RawFill     cp.async of each side's x and of the raw weight area
//               (64 K x 128 N: one side's 128 columns, or Re's and Im's
//               64 side by side) into the stage (its rows' 16-byte
//               segments swizzled by k / 8); once the stage lands, a
//               transform pass writes each side's w, P6 and P5 into one
//               24 KB area in compute's layout: 4 x 4 byte blocks
//               transposed with byte permutes, the planes folded per
//               byte, then a second __syncthreads.  Each raw byte is
//               copied once and transformed once per stage.  Rows that
//               are not 16-byte aligned (N % 16 != 0) are copied with
//               byte loads instead of cp.async.
#pragma once

#include "ccim_common.cuh"

namespace ccim {
namespace mma {

constexpr int kThreads = 256;                 // 8 warps
constexpr int kBN = 128;                      // block tile columns x sides
constexpr int kBK = 64;                       // K bytes per stage
constexpr int kStages = 3;
constexpr int kNG = 8;                        // n8 tiles of B read at a time

// WM x WN warps, each one m16 row of NT n8 MMA tiles per side.  Below
// acc_len 64 the warps stack along M, so no two derive the same
// bit-planes; at 64 a chunk's sums live across the stage's halves, which
// halves the tiles a warp can hold.  S sides share the accumulators a
// thread holds, so each side gets 1 / S of the columns; two sides keep
// the A fragments of both x sides live, so B is read NG = 2 tiles at a
// time.
template <int ACC, int S>
struct Tile {
  static_assert(S == 1 || ACC == 16, "two sides: acc_len 16 only");
  static constexpr int WM = ACC >= 64 ? 4 : 8, NT = (ACC >= 64 ? 8 : 16) / S;
  static constexpr int WN = 8 / WM, BM = 16 * WM, BN = 8 * NT * WN;
  static constexpr int NG = S == 1 ? kNG : 2;
  static_assert(BN * S == kBN && NT % NG == 0, "tile");
};

// Side 0 is the real GEMM's only side, or Re; side 1 is Im.
struct Args {
  const int8_t* x[2];       // (M, Kp) per side
  const int8_t* w[2];       // packed (N, Kp) or raw (Kp, N) per side
  const int8_t* planes[2];  // packed: (n_planes, N, Kp) per side
  int32_t* out[2];          // (M, N) per output
  int M, N, Kp, x_bits, lsb_shift, adc_half, k_split;
  int32_t* clips;           // the clip count (kCount instances), or null
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

// Folded plane P6 of four packed int8 weights, per byte
// sign(w) * (2 b6(|w|) + b5(|w|)), in [-3, 3], from the same Mag4 as
// plane4: m = (|w| >> 5) & 3 (|w| <= 127), -m per byte as (0x80 - m) ^
// 0x80 (no borrow while m <= 3), its bits taken where keep has them
// (0xFF: a negative byte; 0x01 takes bit 0 only, where m and -m agree).  P5 = sign(w) b6(|w|) is plane4(v, 6).
__device__ __forceinline__ unsigned fold4(Mag4 v) {
  const unsigned m = (v.mag >> 5) & 0x03030303u;
  const unsigned neg = (0x80808080u - m) ^ 0x80808080u;
  return m ^ ((m ^ neg) & v.keep);
}

// 4 x 4 byte transpose with byte permutes: r[i] holds bytes
// (k = i, n = 0..3); on return r[c] holds bytes (k = 0..3, n = c).
__device__ __forceinline__ void transpose4(unsigned (&r)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned t1 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t2 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t1, 0x5410);
  r[1] = __byte_perm(t0, t1, 0x7632);
  r[2] = __byte_perm(t2, t3, 0x5410);
  r[3] = __byte_perm(t2, t3, 0x7632);
}

// One conversion, folded: ex = exact + lsb/2, dc = dcim - adc_half,
// span = 2 adc_half - 1 -> dcim + code
__device__ __forceinline__ int convert_folded(int ex, int dc, int shift,
                                              int span) {
  return __viaddmin_s32(dc, span, max(ex >> shift, dc));
}

// convert_folded, and in clips one more when the clamp moved the value
// (the code clipped: raw < -h or raw > h - 1)
__device__ __forceinline__ int convert_count(int ex, int dc, int shift,
                                             int span, int& clips) {
  const int t = ex >> shift;
  const int cv = __viaddmin_s32(dc, span, max(t, dc));
  clips += cv != t;
  return cv;
}

// A warp's clip counts (one per lane) summed and added to *clips once;
// every lane of the warp must call it
__device__ __forceinline__ void add_clips(int32_t* clips, int n) {
  const unsigned tot =
      __reduce_add_sync(0xffffffffu, static_cast<unsigned>(n));
  if ((threadIdx.x & 31) == 0 && tot)
    atomicAdd(reinterpret_cast<unsigned*>(clips), tot);
}

// x rows m0.. of one side of one stage at st: 16 bytes a thread per
// copy, zeros past M and the split's end ke
template <int BM>
__device__ __forceinline__ void load_x(const Args& a, int side, int8_t* st,
                                       int k0, int ke, int m0, int tid) {
  const int8_t* x = a.x[side];
#pragma unroll
  for (int i = 0; i < BM * 4 / kThreads; ++i) {
    const int p = tid + i * kThreads, r = p >> 2, s = p & 3;
    const int m = m0 + r, k = k0 + 16 * s;
    const bool ok = m < a.M && k < ke;
    cp_async16(smem_addr(st + swz(r, s)),
               ok ? x + (size_t)m * a.Kp + k : x, ok);
  }
}

// A stage holds each side's x, then each side's w and planes, rows n0..,
// in compute's layout.
template <class T, int NP, int S>
struct PackedFill {
  static constexpr int kStage = S * (T::BM + (1 + NP) * T::BN) * kBK;
  static constexpr int kExtra = 0;  // shared bytes beside the ring

  static __device__ __forceinline__ void load(const Args& a, int8_t* st,
                                              int k0, int ke, int m0, int n0,
                                              int tid) {
#pragma unroll
    for (int side = 0; side < S; ++side)
      load_x<T::BM>(a, side, st + side * T::BM * kBK, k0, ke, m0, tid);
    int8_t* ops = st + S * T::BM * kBK;
#pragma unroll
    for (int side = 0; side < S; ++side)
#pragma unroll
      for (int op = 0; op <= NP; ++op) {
        const int8_t* base =
            op == 0 ? a.w[side]
                    : a.planes[side] + (size_t)(op - 1) * a.N * a.Kp;
#pragma unroll
        for (int i = 0; i < T::BN * 4 / kThreads; ++i) {
          const int p = tid + i * kThreads, r = p >> 2, s = p & 3;
          const int n = n0 + r, k = k0 + 16 * s;
          const bool ok = n < a.N && k < ke;
          cp_async16(smem_addr(ops + (side * (1 + NP) + op) * T::BN * kBK +
                               swz(r, s)),
                     ok ? base + (size_t)n * a.Kp + k : base, ok);
        }
      }
  }

  // the weight operands of a landed stage
  static __device__ __forceinline__ const int8_t* operands(const int8_t* st,
                                                           int8_t*, int) {
    return st + S * T::BM * kBK;
  }
};

// A stage holds each side's x, then the raw (64 K, 128 N) weight area, N
// contiguous: one side's 128 columns, or two sides' 64 side by side (raw
// row k holds Re's columns in segments 0-3 and Im's in 4-7); operands()
// derives each side's w, P6 and P5 from it into the area beside the ring.
template <class T, int NP, int S>
struct RawFill {
  static_assert(NP == 2, "the raw fill folds the prototype's P6 and P5");
  static_assert(S == 1 || T::BN == 64, "two sides: 64 columns each");
  static constexpr int BM = T::BM, BN = T::BN;
  static constexpr int kRaw = kBK * kBN;
  static constexpr int kStage = S * BM * kBK + kRaw;
  static constexpr int kExtra = (1 + NP) * kBN * kBK;

  // byte offset of 16-byte segment s (columns 16 s..) of raw row r (k):
  // segments swizzled by r / 8, so the transform's column reads of 8 rows
  // 8 apart hit distinct banks
  static __device__ __forceinline__ int raw_off(int r, int s) {
    return r * kBN + ((s ^ ((r >> 3) & 7)) << 4);
  }

  static __device__ __forceinline__ void load(const Args& a, int8_t* st,
                                              int k0, int ke, int m0, int n0,
                                              int tid) {
#pragma unroll
    for (int side = 0; side < S; ++side)
      load_x<BM>(a, side, st + side * BM * kBK, k0, ke, m0, tid);
    int8_t* raw = st + S * BM * kBK;
    const bool vec = (a.N & 15) == 0;  // every row 16-byte aligned
#pragma unroll
    for (int i = 0; i < kRaw / 16 / kThreads; ++i) {
      const int p = tid + i * kThreads, r = p >> 3, s = p & 7;
      // two sides: Re's columns in segments 0-3, Im's in 4-7 (constant
      // indices into a: a dynamic one would copy it to local memory)
      const int8_t* w = S == 2 && s >= 4 ? a.w[1] : a.w[0];
      const int k = k0 + r, n = n0 + 16 * (S == 2 ? s & 3 : s);
      int8_t* dst = raw + raw_off(r, s);
      if (vec) {
        const bool ok = k < ke && n < a.N;
        cp_async16(smem_addr(dst), ok ? w + (size_t)k * a.N + n : w, ok);
      } else {
        unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (k < ke && n + j < a.N)
            v[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(
                             w[(size_t)k * a.N + n + j]))
                         << (8 * (j & 3));
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }

  // The landed raw area -> each side's w, P6, P5 at ops, (BN N, 64 K)
  // each, side by side in compute's layout.  A thread takes 8 k rows
  // (8 kp..) x 4 raw columns (4 nq..): two 4 x 4 blocks, transposed, then
  // per column 8 bytes of K of each operand.  Warp w takes nq 4 w..4 w + 3
  // at every kp (with two sides, warps 0-3 take Re and 4-7 Im): its raw
  // reads hit 32 banks, and so do its 8-byte stores per half-warp, the odd
  // nq storing their columns in the order 1 0 3 2 (rows of the other
  // parity, the other 64 bytes of the banks).  Ends with __syncthreads:
  // every warp's compute reads every thread's stores.
  static __device__ __forceinline__ const int8_t* operands(const int8_t* st,
                                                           int8_t* ops,
                                                           int tid) {
    constexpr int WB = BN * kBK;  // bytes of one operand of one side
    const int8_t* raw = st + S * BM * kBK;
    const int lane = tid & 31;
    const int kp = lane & 7, nq = 4 * (tid >> 5) + (lane >> 3);
    const int odd = nq & 1;
    unsigned r[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[h][i] = *reinterpret_cast<const unsigned*>(
            raw + raw_off(8 * kp + 4 * h + i, nq >> 2) + 4 * (nq & 3));
      transpose4(r[h]);
    }
    // two sides: raw column n >= 64 is Im's column n - 64, whose operand
    // op lies at (3 + op) WB + swz(n - 64, .) = NP WB + op WB + swz(n, .)
    // (swz(n, s) = WB + swz(n - 64, s) at WB = 64 rows of 64 bytes)
    int8_t* const base = ops + (S == 2 && nq >= 16 ? NP * WB : 0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned lo = odd ? r[0][c ^ 1] : r[0][c];
      const unsigned hi = odd ? r[1][c ^ 1] : r[1][c];
      const Mag4 vl = mag4(lo), vh = mag4(hi);
      int8_t* o = base + swz(4 * nq + (c ^ odd), kp >> 1) + 8 * (kp & 1);
      *reinterpret_cast<uint2*>(o) = make_uint2(lo, hi);
      *reinterpret_cast<uint2*>(o + WB) = make_uint2(fold4(vl), fold4(vh));
      *reinterpret_cast<uint2*>(o + 2 * WB) =
          make_uint2(plane4(vl, 6), plane4(vh, 6));
    }
    __syncthreads();
    return ops;
  }
};

template <int ACC, int NP, template <class, int, int> class Fill, int S = 1,
          bool kCount = false>
__global__ void __launch_bounds__(kThreads, 1) general_kernel(const Args a) {
  using T = Tile<ACC, S>;
  constexpr int NT = T::NT, NG = T::NG, BM = T::BM, BN = T::BN;
  constexpr int WB = BN * kBK;
  using F = Fill<T, NP, S>;
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * a.k_split;
  const int ke = min(a.Kp, kb + a.k_split);
  const int n_tiles = (ke - kb + kBK - 1) / kBK;
  const bool live = m0 + wm * 16 < a.M;  // else this warp only fills

  const int half = (1 << a.lsb_shift) >> 1;
  const int seed_ex[4] = {half, half, half, half};
  const int span = 2 * a.adc_half - 1;
  int jbit[NP > 0 ? NP : 1];
#pragma unroll
  for (int pl = 0; pl < NP; ++pl) jbit[pl] = (a.x_bits >> (4 * pl)) & 0xF;
  // acc_len 8: the B half a lane keeps for the chunk at k 0-7 / 8-15
  const unsigned keep_lo = (lane & 2) ? 0u : ~0u, keep_hi = ~keep_lo;

  int acc[S][NT][4];         // per output: the only one, or Re and Im
  int ex[NT][4], dc[NT][4];  // acc_len 64: a chunk spans 2 halves
#pragma unroll
  for (int o = 0; o < S; ++o)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[o][nt][r] = 0;

  // ldmatrix lane roles: matrix q = lane / 8, its row i = lane % 8
  const int q = lane >> 3, i8 = lane & 7;
  // clip count: this thread's C-fragment rows g, g + 8 and columns 2 t4,
  // 2 t4 + 1 of each n8 tile (S == 1 only)
  [[maybe_unused]] int n_clip = 0;  // kCount: this thread's clipped codes

  // one stage: each side's x at st, each side's w and planes at wo
  auto compute = [&](const int8_t* st, const int8_t* wo) {
    // the stage's two 32-byte halves; with two sides a loop, not unrolled,
    // or ptxas hoists the second half's fragments and spills
#pragma unroll (S == 1 ? 2 : 1)
    for (int hp = 0; hp < 2; ++hp) {
      // A: per side, x's k32 fragment of the warp's m16 row in this half,
      // then each plane's
      unsigned ax[S][1 + NP][4];
#pragma unroll
      for (int side = 0; side < S; ++side) {
        ldmatrix_x4(ax[side][0],
                    smem_addr(st + side * BM * kBK +
                              swz(wm * 16 + (q & 1) * 8 + i8,
                                  2 * hp + (q >> 1))));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const Mag4 v = mag4(ax[side][0][r]);
#pragma unroll
          for (int pl = 0; pl < NP; ++pl)
            ax[side][1 + pl][r] = plane4(v, jbit[pl]);
        }
      }
#pragma unroll
      for (int ng = 0; ng < NT; ng += NG)
#pragma unroll
        for (int ws = 0; ws < S; ++ws) {  // one weight side at a time
          // B: per operand and n8 tile of side ws, k32 fragment {b0, b1}
          // of this half; it serves the S streams that read side ws
          unsigned b[1 + NP][NG][2];
#pragma unroll
          for (int op = 0; op <= NP; ++op)
#pragma unroll
            for (int u = 0; u < NG / 2; ++u) {
              unsigned r[4];
              const int row = wn * 8 * NT + (ng + 2 * u + (q >> 1)) * 8 + i8;
              ldmatrix_x4(r, smem_addr(wo + (ws * (1 + NP) + op) * WB +
                                       swz(row, 2 * hp + (q & 1))));
              b[op][2 * u][0] = r[0];
              b[op][2 * u][1] = r[1];
              b[op][2 * u + 1][0] = r[2];
              b[op][2 * u + 1][1] = r[3];
            }
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            const int nt = ng + j;
            int e[4], d[4];
            if constexpr (ACC == 8 || ACC == 16) {
#pragma unroll
              for (int h = 0; h < 2; ++h)      // the half's two 16-K steps
#pragma unroll
                for (int c = 0; c < (ACC == 8 ? 2 : 1); ++c) {
                  const unsigned keep =
                      ACC == 16 ? ~0u : (c == 0 ? keep_lo : keep_hi);
                  // stream (x side xs, weight side ws) -> output xs ^ ws,
                  // negated when both are Im: ac (0, 0) -> Re, bc (1, 0)
                  // -> Im, ad (0, 1) -> Im, bd (1, 1) -> -Re
#pragma unroll
                  for (int xs = 0; xs < S; ++xs) {
                    mma_k16(e, ax[xs][0][2 * h], ax[xs][0][2 * h + 1],
                            b[0][j][h] & keep, seed_ex);
                    d[0] = d[1] = d[2] = d[3] = -a.adc_half;
#pragma unroll
                    for (int pl = 0; pl < NP; ++pl)
                      mma_k16(d, ax[xs][1 + pl][2 * h],
                              ax[xs][1 + pl][2 * h + 1],
                              b[1 + pl][j][h] & keep, d);
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                      int cv;
                      if constexpr (kCount)
                        cv = convert_count(e[r], d[r], a.lsb_shift, span,
                                           n_clip);
                      else
                        cv = convert_folded(e[r], d[r], a.lsb_shift, span);
                      acc[xs ^ ws][nt][r] += xs & ws ? -cv : cv;
                    }
                  }
                }
            } else {
              // acc_len 32: one k32 MMA per chunk; 64: chained over halves
              const bool first = ACC == 32 || hp == 0;
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                e[r] = first ? half : ex[nt][r];
                d[r] = first ? -a.adc_half : dc[nt][r];
              }
              mma_k32(e, ax[0][0], b[0][j][0], b[0][j][1], e);
#pragma unroll
              for (int pl = 0; pl < NP; ++pl)
                mma_k32(d, ax[0][1 + pl], b[1 + pl][j][0], b[1 + pl][j][1],
                        d);
              if (ACC == 32 || hp == 1) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  if constexpr (kCount)
                    acc[0][nt][r] += convert_count(e[r], d[r], a.lsb_shift,
                                                   span, n_clip);
                  else
                    acc[0][nt][r] +=
                        convert_folded(e[r], d[r], a.lsb_shift, span);
                }
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

  int8_t* const extra = smem + kStages * F::kStage;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) F::load(a, smem + s * F::kStage, kb + s * kBK, ke, m0,
                             n0, tid);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    const int nxt = t + kStages - 1;
    if (nxt < n_tiles)
      F::load(a, smem + (nxt % kStages) * F::kStage, kb + nxt * kBK, ke, m0,
              n0, tid);
    cp_async_commit();
    const int8_t* st = smem + (t % kStages) * F::kStage;
    const int8_t* wo = F::operands(st, extra, tid);
    if (live) compute(st, wo);
  }
  cp_async_wait<0>();

  // C fragment: rows g and g + 8, columns 2 t and 2 t + 1 of each tile
  const int g = lane >> 2, t4 = lane & 3;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int o = 0; o < S; ++o)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * 16 + g + (r >> 1) * 8;
        const int n = n0 + wn * 8 * NT + nt * 8 + 2 * t4 + (r & 1);
        if (m >= a.M || n >= a.N) continue;
        const unsigned v = static_cast<unsigned>(acc[o][nt][r])
                           << a.lsb_shift;
        unsigned* dst =
            reinterpret_cast<unsigned*>(a.out[o]) + (size_t)m * a.N + n;
        if (split)
          atomicAdd(dst, v);
        else
          *dst = v;
      }
  if constexpr (kCount) add_clips(a.clips, n_clip);
}

template <int ACC, int NP, template <class, int, int> class Fill, int S = 1,
          bool kCount = false>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using T = Tile<ACC, S>;
  using F = Fill<T, NP, S>;
  constexpr int bytes = kStages * F::kStage + F::kExtra;
  static bool sized = false;  // above 48 KB needs the opt-in, once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        general_kernel<ACC, NP, Fill, S, kCount>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid((a.N + T::BN - 1) / T::BN, (a.M + T::BM - 1) / T::BM,
                  (a.Kp + a.k_split - 1) / a.k_split);
  general_kernel<ACC, NP, Fill, S, kCount>
      <<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

inline long cdiv(long a, long b) { return (a + b - 1) / b; }

// Bytes of K per split: whole 64-byte stages, so whole chunks at every
// admitted acc_len.  Minimizes waves x (stages per split + 2), the 2 for a
// block's fill and store, at one block per SM: few output tiles (the
// N-2304 GEMMs at M 128) split K over the card, many tiles keep it whole.
// Ties go to fewer splits.  ``sides`` 2 takes the complex tile.
inline int pick_k_split(int M, int N, int Kp, int acc_len, int n_sm,
                        int sides = 1) {
  const int bm = acc_len >= 64 ? Tile<64, 1>::BM : Tile<16, 1>::BM;
  const int bn = sides == 2 ? Tile<16, 2>::BN : kBN;
  const long blocks = cdiv(M, bm) * cdiv(N, bn), stages = cdiv(Kp, kBK);
  long best = -1, best_per = stages;
  for (long per = stages; per >= 1; --per) {
    const long cost = cdiv(blocks * cdiv(stages, per), n_sm) * (per + 2);
    if (best < 0 || cost < best) best = cost, best_per = per;
  }
  return static_cast<int>(best_per * kBK);
}

// SMs of the current device, read once per device
inline int sm_count() {
  static int count[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (!count[dev] && cudaDeviceGetAttribute(
                         &count[dev], cudaDevAttrMultiProcessorCount, dev) !=
                         cudaSuccess)
    return 1;
  return count[dev];
}

// Picks the split for the shape, zeroes the outputs on the stream when
// there is more than one (the splits add into them), and launches.
template <int ACC, int NP, template <class, int, int> class Fill, int S = 1,
          bool kCount = false>
cudaError_t run(Args a, cudaStream_t stream) {
  a.k_split = pick_k_split(a.M, a.N, a.Kp, ACC, sm_count(), S);
  if (a.k_split < a.Kp) {
    for (int o = 0; o < S; ++o) {
      const cudaError_t e = cudaMemsetAsync(
          a.out[o], 0, sizeof(int32_t) * (size_t)a.M * a.N, stream);
      if (e != cudaSuccess) return e;
    }
  }
  return launch<ACC, NP, Fill, S, kCount>(a, stream);
}

}  // namespace mma
}  // namespace ccim
