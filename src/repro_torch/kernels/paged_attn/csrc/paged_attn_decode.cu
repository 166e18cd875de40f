// Paged-attention decode read for Hopper at head dims 64 and 128: one
// query per row against the KV rows its block table names, with an
// online softmax.  Head dim 256 has a design of its own
// (paged_attn_dh256.cu); the row walk and the split workspace's layout
// are shared (paged_attn_common.cuh).
//
// Replaces: src/repro/kernels/paged_attn/kernel.py,
//   paged_attention_pallas (body _paged_attn_kernel).
//
// Operands (row-major, contiguous):
//   q       (B, Hq, Dh)               bf16 query of each row
//   k_pool  (n_blocks, bs, Hkv, Dh)   bf16 key pool shared by every row
//   v_pool  (n_blocks, bs, Hkv, Dh)   bf16 value pool
//   table   (B, n_tbl)                int32 block ids; position p of row b
//                                     lives at pool[table[b, p / bs], p % bs]
//   lengths (B,)                      int32 valid rows (the query sits at
//                                     lengths[b] - 1)
//   out     (B, Hq, Dh)               bf16; query head h * G + g reads kv
//                                     head h (G = Hq / Hkv)
//   ws      float32 workspace of the split walk (n_split > 1): per (b,
//           query head, split) Dh sums, then every split's max, then
//           every split's sum
// For each row and query head: s = (q * Dh^-0.5) . k in float32, an
// optional tanh softcap, a mask k_pos <= q_pos (and q_pos - k_pos <
// window when is_local), then an online softmax (m, l, acc) in float32
// with P.V in float32, and the output rounded to bf16 once -- the TPU
// kernel's function.  Masked positions carry weight exactly 0, as the
// -1e30 mask gives them there.
//
// What bounds it: each K and V row is read once per group of up to 4
// query heads and used by each of them, about G float32 operations per
// byte, far below the card's ~295 bf16 operations per byte of HBM rate:
// the kernel is bound by the bytes of the rows each query attends.  At
// decode batch sizes those bytes only stream at HBM rate when enough of
// them are in flight: about 3.35 TB/s x 0.7 us, some 18 KB per SM.
//
// Design:
//  - Walk: block (kv head and head group, row, split) walks only the
//    table entries that hold positions the query attends -- from the
//    window's first block (or block 0) to the block holding q_pos --
//    never past n_tbl, with block ids clamped into the pool, so a
//    harvested row whose table points at the trash block reads the trash
//    block and nothing else.  Rows past q_pos or outside the window are
//    not read.
//  - Split and combine (flash-decoding): the row's n attended entries
//    are cut into min(n_split, n) splits of n / splits entries (the
//    grid's later splits get no work).  With n_split 1 the block writes
//    the output; otherwise each split writes its float32 (m, l, acc) to
//    the workspace and a second kernel merges a row's splits in split
//    order, so the result does not depend on which block ends first.
//    The wrapper picks n_split (kernel.py::paged_split).
//  - Per-warp state, merged once: an entry is cut into chunks of 4 warp
//    loads; warp w takes chunks w, w + 4, ... of its split and keeps its
//    own (m, l, acc) in registers, so there is no block-wide barrier in
//    the walk.  The warps' states are merged once at the end through
//    shared memory: m = max m_w, l = sum l_w e^(m_w - m), acc likewise.
//  - Loads in flight: each warp issues the K and V loads of its next
//    chunk (4 KB) and the table read of the one after before it computes
//    the current chunk; 4 warps a block, ~3 blocks an SM at minicpm-2b's
//    decode shape, ~48 KB in flight per SM.
//  - 16-byte loads, work for every lane: a lane loads 8 dims (16 bytes)
//    of a K row and the same 8 of the V row, so Dh / 8 lanes cover a row
//    and a warp load covers 32 / (Dh / 8) rows (4 at Dh 64, 2 at Dh
//    128).  Head dims 64 and 128 are instantiated.  Scores
//    reduce within each row's lanes by shuffle; each row group keeps its
//    own online softmax over its rows, and P.V runs in the same layout
//    (the lane multiplies its own V slice by its own row's p), so the
//    walk moves nothing between row groups; they merge at the end as the
//    warps do.  G > 1 runs groups of up to 4 query heads per block (each
//    group reads the rows again, mostly from L2): the scores stay on CUDA
//    cores, the read being far below the card's ridge.
#include "paged_attn_common.cuh"

namespace {

using namespace paged_attn;

constexpr int kGroup = 4;                  // query heads a block takes, G > 1
constexpr int kPasses = 4;                 // warp loads of K (and V) a chunk

__device__ __forceinline__ void bf16x8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

struct Chunk {
  uint4 k[kPasses];
  uint4 v[kPasses];
};

template <int DH, int GT>
__global__ void __launch_bounds__(kThreads)
paged_attn_walk(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k_pool,
                const __nv_bfloat16* __restrict__ v_pool,
                const int* __restrict__ table,
                const int* __restrict__ lengths,
                __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                int B, int Hkv, int G, int n_hg, int bs, int n_tbl,
                int n_blocks, float scale, float softcap, int window,
                int is_local, int n_split) {
  constexpr int kLanesPerRow = DH / 8;               // 16 bytes a lane
  constexpr int kRowsPerPass = 32 / kLanesPerRow;
  constexpr int kChunk = kPasses * kRowsPerPass;     // tokens a chunk
  __shared__ __align__(16) float s_acc[kWarps][GT][DH];
  __shared__ float s_m[kWarps][GT];
  __shared__ float s_l[kWarps][GT];

  const int h = blockIdx.x / n_hg;
  const int g0 = (blockIdx.x % n_hg) * GT;           // first head, of G
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const bool local = is_local && window > 0;
  const Walk wk = row_walk(lengths, b, bs, n_tbl, window, local);
  const int n_sb = row_splits(wk.n, n_split);
  if (split >= n_sb) return;                         // no work: whole block
  const int e_lo = wk.j_lo + split * wk.n / n_sb;
  const int e_hi = wk.j_lo + (split + 1) * wk.n / n_sb;
  const int cpe = (bs + kChunk - 1) / kChunk;        // chunks an entry
  const int n_chunks = (e_hi - e_lo) * cpe;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = lane / kLanesPerRow;                 // row in a warp load
  const int sl = lane % kLanesPerRow;                // 8 dims 8 sl ..
  const int Hq = Hkv * G;
  const int q_pos = wk.q_pos;

  float qf[GT][8], m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = qf[g][e] = 0.f;
    if (g0 + g < G) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(b) * Hq + h * G + g0 + g) * DH + 8 * sl));
      bf16x8(u, qf[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[g][e] *= scale;
    }
  }

  const int* tbl = table + static_cast<size_t>(b) * n_tbl;
  const size_t row_stride = static_cast<size_t>(Hkv) * DH;
  const size_t lane_off = static_cast<size_t>(h) * DH + 8 * sl;

  // chunk c's table entry and the token its first pass gives this lane
  auto entry = [&](int c) -> int { return e_lo + c / cpe; };
  auto first_token = [&](int c) -> int { return (c % cpe) * kChunk + r; };
  // pool block of chunk c, or -1 past the split's walk
  auto block_of = [&](int c) -> int {
    return c < n_chunks
               ? min(max(__ldg(tbl + entry(c)), 0), n_blocks - 1)
               : -1;
  };
  auto attended = [&](int j, int t) -> bool {
    const int k_pos = j * bs + t;
    return t < bs && k_pos <= q_pos && (!local || q_pos - k_pos < window);
  };
  auto load = [&](int c, int blk, Chunk& ch) {
    const int j = entry(c), t0 = first_token(c);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int t = t0 + p * kRowsPerPass;
      if (blk >= 0 && attended(j, t)) {
        const size_t off =
            (static_cast<size_t>(blk) * bs + t) * row_stride + lane_off;
        ch.k[p] = __ldg(reinterpret_cast<const uint4*>(k_pool + off));
        ch.v[p] = __ldg(reinterpret_cast<const uint4*>(v_pool + off));
      } else {
        ch.k[p] = ch.v[p] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  // fold chunk c into this row group's (m, l, acc)
  auto consume = [&](int c, const Chunk& ch) {
    const int j = entry(c), t0 = first_token(c);
    float s[kPasses][GT];
    bool ok[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      ok[p] = attended(j, t0 + p * kRowsPerPass);
      float kf[8];
      bf16x8(ch.k[p], kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(qf[g][e], kf[e], part);
#pragma unroll
        for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (softcap > 0.f) part = softcap * tanhf(part / softcap);
        s[p][g] = part;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int p = 0; p < kPasses; ++p)
        if (ok[p]) mx = fmaxf(mx, s[p][g]);
      const float corr = expf(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      float vf[8];
      bf16x8(ch.v[p], vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float pr = ok[p] ? expf(s[p][g] - m[g]) : 0.f;
        l[g] += pr;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
      }
    }
  };

  // two chunks per trip: ch_a and ch_b take turns, so the loads of the
  // next chunk are in flight while the current one is folded
  int c = warp;
  int blk_next = block_of(c + kWarps);
  Chunk ch_a, ch_b;
  load(c, block_of(c), ch_a);
#pragma unroll 1
  while (c < n_chunks) {
    int blk_after = block_of(c + 2 * kWarps);
    load(c + kWarps, blk_next, ch_b);
    consume(c, ch_a);
    c += kWarps;
    if (c >= n_chunks) break;
    blk_next = block_of(c + 2 * kWarps);
    load(c + kWarps, blk_after, ch_a);
    consume(c, ch_b);
    c += kWarps;
  }

  // merge the row groups of the warp (lanes 8 sl + e hold the same dims)
#pragma unroll
  for (int o = kLanesPerRow; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mm = fmaxf(m[g], mo);
      const float wa = expf(m[g] - mm), wb = expf(mo - mm);
      l[g] = l[g] * wa + lo * wb;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * wa + ao * wb;
      }
      m[g] = mm;
    }
  }
  if (r == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float4* dst = reinterpret_cast<float4*>(&s_acc[warp][g][8 * sl]);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      if (sl == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps, in warp order; write the output or this split
  const size_t slots = static_cast<size_t>(B) * Hq * n_split;
  for (int idx = threadIdx.x; idx < GT * DH; idx += kThreads) {
    const int g = idx / DH;
    const int d = idx % DH;
    if (g0 + g >= G) break;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, s_m[w][g]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(s_m[w][g] - mm);
      ls += s_l[w][g] * wt;
      a += s_acc[w][g][d] * wt;
    }
    const size_t row = static_cast<size_t>(b) * Hq + h * G + g0 + g;
    if (n_split == 1) {
      out[row * DH + d] = __float2bfloat16_rn(a / fmaxf(ls, 1e-30f));
    } else {
      const size_t slot = row * n_split + split;
      ws[slot * DH + d] = a;
      if (d == 0) {
        ws[slots * DH + slot] = mm;            // the splits' maxima
        ws[slots * (DH + 1) + slot] = ls;      // the splits' sums
      }
    }
  }
}

// one warp per (row, query head): merge its splits in split order
__global__ void __launch_bounds__(kThreads)
paged_attn_combine(const float* __restrict__ ws,
                   const int* __restrict__ lengths,
                   __nv_bfloat16* __restrict__ out, int B, int Hq, int DH,
                   int bs, int n_tbl, int window, int is_local, int n_split) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B * Hq) return;
  const int b = row / Hq;
  const Walk wk = row_walk(lengths, b, bs, n_tbl, window,
                           is_local && window > 0);
  const int n_sb = row_splits(wk.n, n_split);
  const size_t slots = static_cast<size_t>(B) * Hq * n_split;
  const float* wm = ws + slots * DH + static_cast<size_t>(row) * n_split;
  const float* wl = wm + slots;
  float mm = kNegInf;
  for (int s = 0; s < n_sb; ++s) mm = fmaxf(mm, wm[s]);
  float ls = 0.f;
  for (int s = 0; s < n_sb; ++s) ls += wl[s] * expf(wm[s] - mm);
  const float inv_l = 1.f / fmaxf(ls, 1e-30f);
  const float* wa = ws + static_cast<size_t>(row) * n_split * DH;
  for (int d = lane; d < DH; d += 32) {
    float a = 0.f;
    for (int s = 0; s < n_sb; ++s)
      a += wa[static_cast<size_t>(s) * DH + d] * expf(wm[s] - mm);
    out[static_cast<size_t>(row) * DH + d] = __float2bfloat16_rn(a * inv_l);
  }
}

template <int DH, int GT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* lengths, void* out, float* ws, int B,
           int Hkv, int G, int bs, int n_tbl, int n_blocks, int n_split,
           float scale, float softcap, int window, int is_local,
           cudaStream_t stream) {
  const int n_hg = (G + GT - 1) / GT;
  const dim3 grid(Hkv * n_hg, B, n_split);
  paged_attn_walk<DH, GT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), table, lengths,
      static_cast<__nv_bfloat16*>(out), ws, B, Hkv, G, n_hg, bs, n_tbl,
      n_blocks, scale, softcap, window, is_local, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const int Hq = Hkv * G;
  paged_attn_combine<<<(B * Hq + kWarps - 1) / kWarps, kThreads, 0,
                       stream>>>(ws, lengths,
                                 static_cast<__nv_bfloat16*>(out), B, Hq,
                                 DH, bs, n_tbl, window, is_local, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scale: Dh^-0.5 as a float32; softcap <= 0: no softcap; window <= 0: no
// sliding window; n_split > 1 needs ws of B * Hq * n_split * (Dh + 2)
// floats.  Returns a cudaError_t code (0 on a successful launch).
extern "C" int paged_attn_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const void* table,
                                 const void* lengths, void* out, void* ws,
                                 int B, int Hq, int Hkv, int Dh, int bs,
                                 int n_tbl, int n_blocks, int n_split,
                                 float scale, float softcap, int window,
                                 int is_local, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > kMaxG || bs <= 0 ||
      n_tbl <= 0 || n_blocks <= 0 || n_split <= 0 || B > 65535 ||
      n_split > 65535 || (n_split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const int* tp = static_cast<const int*>(table);
  const int* lp = static_cast<const int*>(lengths);
  float* wp = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return G == 1
        ? launch<64, 1>(q, k_pool, v_pool, tp, lp, out, wp, B, Hkv, G, bs,
                        n_tbl, n_blocks, n_split, scale, softcap, window,
                        is_local, s)
        : launch<64, kGroup>(q, k_pool, v_pool, tp, lp, out, wp, B, Hkv, G,
                             bs, n_tbl, n_blocks, n_split, scale, softcap,
                             window, is_local, s);
  if (Dh == 128)
    return G == 1
        ? launch<128, 1>(q, k_pool, v_pool, tp, lp, out, wp, B, Hkv, G, bs,
                         n_tbl, n_blocks, n_split, scale, softcap, window,
                         is_local, s)
        : launch<128, kGroup>(q, k_pool, v_pool, tp, lp, out, wp, B, Hkv, G,
                              bs, n_tbl, n_blocks, n_split, scale, softcap,
                              window, is_local, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
