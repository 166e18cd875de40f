// Shared by the paged-attention decode reads (paged_attn_decode.cu at
// head dims 64 and 128, paged_attn_dh256.cu at 256): a row's walk over
// its table entries and the splits that hold work.  Both keep the same
// split workspace (n_split > 1), float32: per (b, query head, split) Dh
// unnormalized sums, then every split's running max, then every split's
// sum of exponentials; each merges a row's splits in split order in a
// second kernel of its own.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paged_attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 16;                  // query heads per kv head
constexpr float kNegInf = -1e30f;          // the TPU kernel's mask value

struct Walk {
  int q_pos;                               // the query's position
  int j_lo;                                // first attended table entry
  int n;                                   // attended entries
};

__device__ __forceinline__ Walk row_walk(const int* lengths, int b, int bs,
                                         int n_tbl, int window, bool local) {
  Walk w;
  w.q_pos = lengths[b] - 1;
  w.j_lo = local ? max(w.q_pos - window + 1, 0) / bs : 0;
  const int j_hi = w.q_pos < 0 ? 0 : min(w.q_pos / bs + 1, n_tbl);
  w.n = max(j_hi - w.j_lo, 0);
  return w;
}

// splits that hold work for a row of n attended entries
__device__ __forceinline__ int row_splits(int n, int n_split) {
  return min(max(n, 1), n_split);
}

}  // namespace paged_attn
