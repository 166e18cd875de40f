// Paged-attention decode read for Hopper at head dim 256 (gemma2-9b,
// paligemma-3b): one query per row against the KV rows its block table
// names, with an online softmax, scores and P.V on tensor cores.
//
// Replaces: src/repro/kernels/paged_attn/kernel.py,
//   paged_attention_pallas (body _paged_attn_kernel), at head dim 256.
//   Head dims 64 and 128 run paged_attn_decode.cu; both share the row
//   walk and the split workspace's layout (paged_attn_common.cuh).
//
// Operands and function: as paged_attn_decode.cu.  For each row and
// query head: s = (q * Dh^-0.5) . k in float32, an optional tanh softcap,
// a mask k_pos <= q_pos (and q_pos - k_pos < window when is_local), an
// online softmax (m, l, acc) in float32, P.V with p kept to about float32
// (not rounded to bf16), and the output rounded to bf16 once -- the TPU
// kernel's function.  Masked positions carry weight exactly 0.
//
// What bounds it: each K and V row (512 bytes each) is read from HBM once,
// by the one block of its (row, kv head, split), and used by all G <= 16
// query heads of the kv head: about 2 G operations a byte, far below the
// card's ~295 bf16 operations a byte.  The read is bound by the bytes of
// the attended rows; at decode batch sizes those stream at HBM rate only
// with enough bytes in flight (~3.35 TB/s x 0.7 us, ~18 KB an SM) and a
// grid that covers the 132 SMs; at short walks a launch's latency (the
// walk's and the merge's) is most of the time.
//
// Design:
//  - Grid (kv head, row, split), 4 warps a block, all G query heads of
//    the kv head in one 16-row MMA tile (rows G..15 zero): no head groups,
//    no empty-head work beyond the tile's padding, each row read once.
//  - Split rule (kernel.py::paged_split at Dh 256): as many splits as 4
//    resident blocks an SM hold in one wave, at most 16, down to one
//    table entry a split (B 8: gemma2-9b 6 splits at L 96 and 8 at L
//    1,024, paligemma-3b 6 and 16).  A second kernel merges a row's
//    splits in split order, so a repeated call gives equal outputs: a
//    block per (row, query head), a thread per dim, every load of up to
//    16 splits issued at once, the splits' weights computed once a block.
//  - A 3-stage cp.async ring in dynamic shared memory: a tile is 16
//    consecutive attended positions of the split (any block size; each
//    row's address from its own table entry, block ids clamped into the
//    pool), 8 KB of K and 8 KB of V; up to 32 KB of loads in flight a
//    block, 4 blocks an SM.  Each thread copies 4 K and 4 V 16-byte
//    chunks a tile (one integer division a tile for their table entries);
//    rows past the split's end are zero-filled.  The table entries of the
//    tile after next are read while a tile is computed.  Rows (and Q's)
//    keep their 16-byte chunks XOR (row mod 8), so every ldmatrix reads 8
//    distinct bank groups.
//  - Scores: mma.sync.m16n8k16 bf16 -> float32.  Q, scaled by Dh^-0.5 =
//    2^-4 (exact in bf16; a product of two bf16 values is exact in
//    float32), sits in shared memory (8 KB) as the A operand; the K tile
//    is the B operand; both through ldmatrix: 16 k-steps x 2 n-tiles a
//    tile, in two chains per n-tile.  Every warp computes the same 16 x 16
//    scores (far below the ridge, and no barrier to share them), so every
//    warp holds the same (m, l) by the same arithmetic; row max and row
//    sum take 2 quad shuffles; rows 8-15 only at G > 8.  The softcap's
//    tanh is 1 - 2 / (e^2x + 1) on the hardware exp2 (within ~1e-6 of
//    tanhf), exponentials exp2 of log2(e)-scaled differences.
//  - P.V: p = p_hi + p_lo as two bf16 terms (p keeps ~2^-16 relative
//    error) against V through ldmatrix.trans, two MMAs each; warp w owns
//    output dims 64 w .. 64 w + 63 (a 16 x 64 float32 accumulator, 32
//    registers a lane).
//  - Resources: 128 threads, 56 KB of dynamic shared memory and at most
//    128 registers a thread (ptxas: 122, no spills; the build log, nvcc
//    -Xptxas -v, and chip_smoke.py's build record).
#include "paged_attn_common.cuh"

namespace {

using namespace paged_attn;

constexpr int kDh = 256;
constexpr int kTok = 16;                           // positions a tile
constexpr int kStages = 3;                         // tiles in the ring
constexpr int kRowBytes = kDh * 2;                 // a K, V or Q row, bf16
constexpr int kChunks = kRowBytes / 16;            // 16-byte chunks a row
constexpr int kTileBytes = kTok * kRowBytes;       // 8 KB
constexpr int kStageBytes = 2 * kTileBytes;        // K then V
constexpr int kQBytes = 16 * kRowBytes;            // Q, 16 rows: 8 KB
constexpr int kSmemBytes = kStages * kStageBytes + kQBytes;   // 56 KB
constexpr int kRowsPerPass = kThreads / kChunks;   // rows a block copies at once
constexpr int kLoads = kTok / kRowsPerPass;        // rows a thread copies a tile
constexpr int kKSteps = kDh / 16;                  // score MMA k-steps
constexpr int kNTiles = kDh / kWarps / 8;          // P.V n-tiles a warp
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r of a tile (or of Q)
__device__ __forceinline__ unsigned swz(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 operands,
// float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x0, x1) -> bf16 pairs hi = bf16(x) and lo = bf16(x - hi), x0 in the
// low half (the lower column of an MMA fragment)
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// tanh(x) = 1 - 2 / (e^2x + 1) with the hardware exp2 and a fast
// division: within ~1e-6 of tanhf (absolute), +-1 past |x| ~ 44
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.f - __fdividef(2.f, exp2f(x * (2.f * kLog2e)) + 1.f);
}

__global__ void __launch_bounds__(kThreads, 4)
paged_attn_walk_mma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pool,
                    const __nv_bfloat16* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                    int B, int Hkv, int G, int bs, int n_tbl, int n_blocks,
                    float scale, float softcap, int window, int is_local,
                    int n_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem + kStages * kStageBytes;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const bool local = is_local && window > 0;
  const Walk wk = row_walk(lengths, b, bs, n_tbl, window, local);
  const int n_sb = row_splits(wk.n, n_split);
  if (split >= n_sb) return;                         // no work: whole block
  const int e_lo = wk.j_lo + split * wk.n / n_sb;
  const int e_hi = wk.j_lo + (split + 1) * wk.n / n_sb;
  const int q_pos = wk.q_pos;
  // the split's attended positions [p_lo, p_hi), cut into tiles of kTok
  const int p_lo = max(e_lo * bs, local ? q_pos - window + 1 : 0);
  const int p_hi = min(e_hi * bs, q_pos + 1);
  const int n_tiles = p_hi > p_lo ? (p_hi - p_lo + kTok - 1) / kTok : 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int fr = lane >> 2;                  // fragment rows fr and fr + 8
  const int fc = lane & 3;                   // fragment columns 2 fc, +1
  const int Hq = Hkv * G;
  const bool upper = G > 8;                  // tile rows 8-15 hold heads

  // copy roles: this thread's 16-byte chunk of rows ld_row + kRowsPerPass j
  const int ld_chunk = tid % kChunks;
  const int ld_row = tid / kChunks;

  // Q into shared memory, scaled by Dh^-0.5 in bf16 (the reference's
  // weakly typed scale; exact at 2^-4), rows G..15 zero
  {
    const __nv_bfloat16* q0 =
        q + (static_cast<size_t>(b) * Hq + static_cast<size_t>(h) * G) * kDh;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int r = ld_row + kRowsPerPass * j;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < G) {
        u = __ldg(reinterpret_cast<const uint4*>(q0 + r * kDh) + ld_chunk);
        unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<__nv_bfloat162*>(&w[i]));
          w[i] = bf16x2_bits(__floats2bfloat162_rn(f.x * scale, f.y * scale));
        }
      }
      *reinterpret_cast<uint4*>(qs + swz(r, ld_chunk)) = u;
    }
  }

  const int* tbl = table + static_cast<size_t>(b) * n_tbl;
  const size_t row_stride = static_cast<size_t>(Hkv) * kDh;
  const size_t head_off = static_cast<size_t>(h) * kDh + 8 * ld_chunk;
  // pool element offset of this thread's chunk of tile t's rows, or -1
  // past the split's attended positions (one division a tile)
  auto sources = [&](int t, long long (&src)[kLoads]) {
    const int base = p_lo + t * kTok + ld_row;
    int e = base / bs;
    int o = base - e * bs;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      src[j] = -1;
      if (t < n_tiles && base + kRowsPerPass * j < p_hi) {
        const int blk = min(max(__ldg(tbl + e), 0), n_blocks - 1);
        src[j] = static_cast<long long>(
            (static_cast<size_t>(blk) * bs + o) * row_stride + head_off);
      }
      o += kRowsPerPass;
      while (o >= bs) {
        o -= bs;
        ++e;
      }
    }
  };
  auto issue = [&](int t, const long long (&src)[kLoads]) {
    if (t < n_tiles) {
      unsigned char* st = smem + (t % kStages) * kStageBytes;
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int r = ld_row + kRowsPerPass * j;
        const bool ok = src[j] >= 0;
        const size_t off = ok ? static_cast<size_t>(src[j]) : 0;
        cp_async16(smem_addr(st + swz(r, ld_chunk)), k_pool + off, ok);
        cp_async16(smem_addr(st + kTileBytes + swz(r, ld_chunk)),
                   v_pool + off, ok);
      }
    }
    cp_async_commit();                       // empty past the walk
  };

  long long src[kLoads];
#pragma unroll 1
  for (int t = 0; t < kStages - 1; ++t) {
    sources(t, src);
    issue(t, src);
  }
  sources(kStages - 1, src);

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  // ldmatrix lane roles: Q rows and chunk halves of a k-step (A); K rows
  // (tokens) and chunk halves (B of the scores); V rows of the two
  // 8-token halves and the n-tile pair's chunk (B of P.V)
  const unsigned qb = smem_addr(qs);
  const int q_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int q_half = lane >> 4;
  const int k_tok = ((lane >> 4) << 3) + (lane & 7);
  const int k_half = (lane >> 3) & 1;
  const int v_tok = (((lane >> 3) & 1) << 3) + (lane & 7);
  const int v_chunk = kNTiles * warp + (lane >> 4);

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();            // tile t has landed
    __syncthreads();                         // ... for every thread, Q is
                                             // stored, and tile t - 1's
                                             // stage is free
    issue(t + kStages - 1, src);
    sources(t + kStages, src);               // table reads in flight

    const unsigned char* st = smem + (t % kStages) * kStageBytes;
    const unsigned kb = smem_addr(st);
    const unsigned vb = smem_addr(st + kTileBytes);

    // scores of the tile's 16 positions: two chains per n-tile
    float sa[2][4] = {}, sb[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < kKSteps; ks += 2) {
      unsigned qa[4], qc[4], kf[4], kg[4];
      ldsm_x4(qa, qb + swz(q_row, 2 * ks + q_half));
      ldsm_x4(kf, kb + swz(k_tok, 2 * ks + k_half));
      ldsm_x4(qc, qb + swz(q_row, 2 * ks + 2 + q_half));
      ldsm_x4(kg, kb + swz(k_tok, 2 * ks + 2 + k_half));
      mma_bf16(sa[0], qa, kf[0], kf[1]);
      mma_bf16(sa[1], qa, kf[2], kf[3]);
      mma_bf16(sb[0], qc, kg[0], kg[1]);
      mma_bf16(sb[1], qc, kg[2], kg[3]);
    }
    // s[nt][i]: row fr + 8 (i >> 1), position p0 + 8 nt + 2 fc + (i & 1)
    const int p0 = p_lo + t * kTok;
    float s[2][4];
    bool ok[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) ok[nt][e] = p0 + 8 * nt + 2 * fc + e < p_hi;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = sa[nt][i] + sb[nt][i];
        if (softcap > 0.f && (i < 2 || upper))
          v = softcap * fast_tanh(v * inv_cap);
        s[nt][i] = v;
      }
    }
    // online softmax per tile row; s becomes p
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !upper) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) s[nt][2] = s[nt][3] = 0.f;
        break;
      }
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (ok[nt][e]) mx = fmaxf(mx, s[nt][2 * r + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mxl = mx * kLog2e;
      const float corr = exp2f(fmaf(m[r], kLog2e, -mxl));
      m[r] = mx;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p =
              ok[nt][e] ? exp2f(fmaf(s[nt][2 * r + e], kLog2e, -mxl)) : 0.f;
          s[nt][2 * r + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = fmaf(l[r], corr, rs);
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }
    // p as the A operand of P.V (its k: the tile's 16 positions), in two
    // bf16 terms
    unsigned ph[4], pl[4];
    split_pair(s[0][0], s[0][1], ph[0], pl[0]);
    split_pair(s[0][2], s[0][3], ph[1], pl[1]);
    split_pair(s[1][0], s[1][1], ph[2], pl[2]);
    split_pair(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n = 0; n < kNTiles; n += 2) {
      unsigned vf[4];
      ldsm_x4_t(vf, vb + swz(v_tok, v_chunk + n));
      mma_bf16(acc[n], pl, vf[0], vf[1]);
      mma_bf16(acc[n], ph, vf[0], vf[1]);
      mma_bf16(acc[n + 1], pl, vf[2], vf[3]);
      mma_bf16(acc[n + 1], ph, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();

  // write the output (one split) or this split's (m, l, acc)
  const size_t slots = static_cast<size_t>(B) * Hq * n_split;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = fr + 8 * r;
    if (g >= G) continue;
    const size_t row = static_cast<size_t>(b) * Hq +
                       static_cast<size_t>(h) * G + g;
    if (n_split == 1) {
      const float lr = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        const int d = 8 * (kNTiles * warp + n) + 2 * fc;
        *reinterpret_cast<__nv_bfloat162*>(out + row * kDh + d) =
            __floats2bfloat162_rn(acc[n][2 * r] / lr, acc[n][2 * r + 1] / lr);
      }
    } else {
      const size_t slot = row * n_split + split;
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        const int d = 8 * (kNTiles * warp + n) + 2 * fc;
        *reinterpret_cast<float2*>(ws + slot * kDh + d) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
      if (warp == 0 && fc == 0) {
        ws[slots * kDh + slot] = m[r];               // the splits' maxima
        ws[slots * (kDh + 1) + slot] = l[r];         // the splits' sums
      }
    }
  }
}

// one block per (row, query head), a thread per output dim: merge the
// row's splits in split order.  Every load of the first kPreload splits
// (the row's length, the splits' maxima, sums and this dim's partial
// sums) is issued at once, before the row's split count is known;
// splits past it are masked, never used.  The splits' weights are
// computed once a block; every thread then adds its dim's sums in split
// order (kDh splits at a time past the first kPreload).  kPreload is
// kernel.py::WIDE_MAX_SPLITS, the most splits the wrapper's rule picks
// but for walks longer than 64 entries a split.
constexpr int kPreload = 16;

__global__ void __launch_bounds__(kDh)
paged_attn_combine_wide(const float* __restrict__ ws,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, int B, int Hq,
                        int bs, int n_tbl, int window, int is_local,
                        int n_split) {
  __shared__ float s_w[kDh];                 // a chunk's split weights
  __shared__ float s_lw[kDh];                // ... and weighted sums
  __shared__ float s_max[kDh / 32];
  const int row = blockIdx.x;
  const int d = threadIdx.x;
  const size_t slots = static_cast<size_t>(B) * Hq * n_split;
  const float* wm = ws + slots * kDh + static_cast<size_t>(row) * n_split;
  const float* wl = wm + slots;
  const float* wa = ws + static_cast<size_t>(row) * n_split * kDh + d;
  float mw = d < n_split ? wm[d] : kNegInf;
  const float lw = d < n_split ? wl[d] : 0.f;
  float av[kPreload];
#pragma unroll
  for (int s = 0; s < kPreload; ++s)
    av[s] = s < n_split ? wa[static_cast<size_t>(s) * kDh] : 0.f;
  const Walk wk = row_walk(lengths, row / Hq, bs, n_tbl, window,
                           is_local && window > 0);
  const int n_sb = row_splits(wk.n, n_split);

  float mm = d < n_sb ? mw : kNegInf;
  for (int s = d + kDh; s < n_sb; s += kDh) mm = fmaxf(mm, wm[s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
  if ((d & 31) == 0) s_max[d >> 5] = mm;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kDh / 32; ++w) mm = fmaxf(mm, s_max[w]);
  const float mml = mm * kLog2e;
  float ls = 0.f, a = 0.f;
  for (int s0 = 0; s0 < n_sb; s0 += kDh) {
    const int n = min(kDh, n_sb - s0);
    if (d < n) {
      const float m_s = s0 ? wm[s0 + d] : mw;
      const float w = exp2f(fmaf(m_s, kLog2e, -mml));
      s_w[d] = w;
      s_lw[d] = (s0 ? wl[s0 + d] : lw) * w;
    }
    __syncthreads();
    int s = 0;
    if (s0 == 0) {
#pragma unroll
      for (; s < kPreload; ++s)
        if (s < n) {
          ls += s_lw[s];
          a = fmaf(av[s], s_w[s], a);
        }
      s = min(kPreload, n);
    }
    const float* wa0 = wa + static_cast<size_t>(s0) * kDh;
#pragma unroll 8
    for (; s < n; ++s) {
      ls += s_lw[s];
      a = fmaf(wa0[static_cast<size_t>(s) * kDh], s_w[s], a);
    }
    __syncthreads();
  }
  out[static_cast<size_t>(row) * kDh + d] =
      __float2bfloat16_rn(a / fmaxf(ls, 1e-30f));
}

}  // namespace

// As paged_attn_decode at Dh 256 (the only head dim it takes): scale Dh^-0.5
// as a float32; softcap <= 0: no softcap; window <= 0: no sliding window;
// n_split > 1 needs ws of B * Hq * n_split * (Dh + 2) floats.  Returns a
// cudaError_t code (0 on a successful launch).
extern "C" int paged_attn_decode_dh256(const void* q, const void* k_pool,
                                       const void* v_pool, const void* table,
                                       const void* lengths, void* out,
                                       void* ws, int B, int Hq, int Hkv,
                                       int Dh, int bs, int n_tbl,
                                       int n_blocks, int n_split, float scale,
                                       float softcap, int window,
                                       int is_local, void* stream) {
  if (Dh != kDh || B <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > kMaxG ||
      bs <= 0 || n_tbl <= 0 || n_blocks <= 0 || n_split <= 0 || B > 65535 ||
      n_split > 65535 || (n_split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // dynamic shared memory above 48 KB, allowed once per device (a first
  // call is eager: a captured step runs once before its capture)
  static bool opted_in[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(paged_attn_walk_mma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  const int G = Hq / Hkv;
  const int* lp = static_cast<const int*>(lengths);
  float* wp = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(Hkv, B, n_split);
  paged_attn_walk_mma<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(table), lp, static_cast<__nv_bfloat16*>(out),
      wp, B, Hkv, G, bs, n_tbl, n_blocks, scale, softcap, window, is_local,
      n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  paged_attn_combine_wide<<<B * Hq, kDh, 0, s>>>(
      wp, lp, static_cast<__nv_bfloat16*>(out), B, Hq, bs, n_tbl, window,
      is_local, n_split);
  return static_cast<int>(cudaGetLastError());
}
