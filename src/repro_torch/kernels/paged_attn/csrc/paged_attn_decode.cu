// Paged-attention decode read for Hopper: one query per row against the
// KV rows its block table names, with an online softmax.
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
// For each row and query head: s = (q * Dh^-0.5) . k in float32, an
// optional tanh softcap, a mask k_pos <= q_pos (and q_pos - k_pos <
// window when is_local), then an online softmax (m, l, acc) in float32
// with P.V in float32, and the output rounded to bf16 once -- the TPU
// kernel's function.
//
// What bounds it: each K and V row is read once and used by G queries,
// about G float32 operations per byte, far below the card's ~295 bf16
// operations per byte of HBM rate: the kernel is bound by reading the
// rows each query attends (and, at decode batch sizes, by latency).
//
// Design: one block of 4 warps per (row, kv head).  The block walks only
// the table entries that hold positions the query attends -- from the
// window's first block (or block 0) to the block holding q_pos -- never
// past n_tbl, with block ids clamped into the pool, so a harvested row
// whose table points at the trash block reads the trash block and
// nothing else.  Per KV block: each warp scores its tokens (a lane holds
// Dh/32 elements of each K row, partial dots meet by shuffle), warp g
// folds query head g's scores into (m, l) and writes exp(s - m) to shared
// memory, then every thread updates the float32 accumulators of the
// (head, d) outputs it owns, reading V rows coalesced along d.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 16;                  // query heads per kv head
constexpr float kNegInf = -1e30f;          // the TPU kernel's mask value

template <int DH>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k_pool,
                  const __nv_bfloat16* __restrict__ v_pool,
                  const int* __restrict__ table,
                  const int* __restrict__ lengths,
                  __nv_bfloat16* __restrict__ out,
                  int Hkv, int G, int bs, int n_tbl, int n_blocks,
                  float scale, float softcap, int window,
                  int is_local) {
  constexpr int kPerLane = DH / 32;                  // K elements per lane
  constexpr int kAcc = kMaxG * DH / kThreads;        // outputs per thread
  extern __shared__ float smem[];
  float* sq = smem;                        // (G, DH) scaled query
  float* sp = sq + G * DH;                 // (G, bs) scores, then exp(s-m)
  float* sm = sp + G * bs;                 // (G,) running max
  float* sl = sm + G;                      // (G,) running sum
  float* sc = sl + G;                      // (G,) correction of this block

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Hq = Hkv * G;
  const int row_stride = Hkv * DH;         // elements between pool rows

  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Hq + h * G) * DH;
  for (int i = tid; i < G * DH; i += kThreads)
    sq[i] = __bfloat162float(qb[i]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = kNegInf;
    sl[g] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  const int q_pos = lengths[b] - 1;
  const bool local = is_local && window > 0;
  int j_lo = 0;
  if (local) j_lo = max(q_pos - window + 1, 0) / bs;
  const int j_hi = q_pos < 0 ? 0 : min(q_pos / bs + 1, n_tbl);  // excl.
  const int* tbl = table + static_cast<size_t>(b) * n_tbl;
  __syncthreads();

  for (int j = j_lo; j < j_hi; ++j) {
    const int blk = min(max(tbl[j], 0), n_blocks - 1);
    const size_t base = (static_cast<size_t>(blk) * bs * Hkv + h) * DH;
    // scores: warp w takes tokens w, w + 4, ...
    for (int t = warp; t < bs; t += kWarps) {
      const __nv_bfloat16* kr = k_pool + base
                                + static_cast<size_t>(t) * row_stride;
      float kv[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e)
        kv[e] = __bfloat162float(kr[lane * kPerLane + e]);
      const int k_pos = j * bs + t;
      bool valid = k_pos <= q_pos;
      if (local) valid = valid && (q_pos - k_pos < window);
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          part += sq[g * DH + lane * kPerLane + e] * kv[e];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) {
          float s = part;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          sp[g * bs + t] = valid ? s : kNegInf;
        }
      }
    }
    __syncthreads();
    // online softmax: warp w folds query heads w, w + 4, ...
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, sp[g * bs + t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(sm[g], mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float p = expf(sp[g * bs + t] - m_new);
        sp[g * bs + t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(sm[g] - m_new);
        sc[g] = corr;
        sl[g] = sl[g] * corr + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();
    // P.V: thread owns outputs (g, d) = divmod(tid + a * kThreads, DH)
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int idx = tid + a * kThreads;
      if (idx < G * DH) {
        const int g = idx / DH;
        const int d = idx % DH;
        float s = acc[a] * sc[g];
        const __nv_bfloat16* vr = v_pool + base + d;
        for (int t = 0; t < bs; ++t)
          s += sp[g * bs + t]
               * __bfloat162float(vr[static_cast<size_t>(t) * row_stride]);
        acc[a] = s;
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * Hq + h * G) * DH;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int idx = tid + a * kThreads;
    if (idx < G * DH) {
      const int g = idx / DH;
      ob[idx] = __float2bfloat16_rn(acc[a] / fmaxf(sl[g], 1e-30f));
    }
  }
}

template <int DH>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* lengths, void* out, int B, int Hkv,
           int G, int bs, int n_tbl, int n_blocks, float scale, float softcap,
           int window, int is_local, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (G * DH + G * bs + 3 * G);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hkv, B);
  paged_attn_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), table, lengths,
      static_cast<__nv_bfloat16*>(out), Hkv, G, bs, n_tbl, n_blocks, scale,
      softcap, window, is_local);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scale: Dh^-0.5 as a float32; softcap <= 0: no softcap; window <= 0: no
// sliding window.  Returns a cudaError_t code (0 on a successful launch).
extern "C" int paged_attn_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const void* table,
                                 const void* lengths, void* out, int B,
                                 int Hq, int Hkv, int Dh, int bs, int n_tbl,
                                 int n_blocks, float scale, float softcap,
                                 int window, int is_local, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > kMaxG || bs <= 0 ||
      n_tbl <= 0 || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const int* tp = static_cast<const int*>(table);
  const int* lp = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch<64>(q, k_pool, v_pool, tp, lp, out, B, Hkv, G, bs, n_tbl,
                      n_blocks, scale, softcap, window, is_local, s);
  if (Dh == 128)
    return launch<128>(q, k_pool, v_pool, tp, lp, out, B, Hkv, G, bs, n_tbl,
                       n_blocks, scale, softcap, window, is_local, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
