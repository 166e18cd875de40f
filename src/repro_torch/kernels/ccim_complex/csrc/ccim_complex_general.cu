// Prepacked fused complex hybrid-CIM GEMM for Hopper, any M.
//
// Replaces: src/repro/kernels/ccim_complex/kernel.py,
//   ccim_complex_matmul_prepacked_pallas (body
//   _ccim_complex_kernel_prepacked).
//
// Operands (the two packs of a PackedComplexCimWeights as stored):
//   x_re, x_im       (M, Kp)    int8 SMF activations
//   w_re, w_im       (N, Kp)    int8 weights, K contiguous per column
//   planes_re/_im    (2, N, Kp) int8 folded planes P6, P5
//   y_re, y_im       (M, N)     int32 at x 2^11
// Prototype numerics only (acc_len 16, top-3 split, 7-bit ADC).  Int32
// holds the sums for K < 65,536 (see ccim_tile.cuh).
//
// What bounds it: six weight bytes per (k, n) and 24 M K N int8
// operations; at the DoA spectrum (M 60, K 64, N 2,401) and at M 128 of
// the full-width shapes the byte bound and the operation bound are within
// a few times of each other.  The dots run on the integer pipes
// (__dp4a), which bind this first version.
//
// Design: the two-side packed instance of ccim_tile.cuh.  The tile fill
// streams the stored planes (no per-call decomposition of the weights,
// no per-call stacking of the four planes); only the activations' bit
// planes are built, once per tile.  The ragged N edge (the DoA grid's
// 2,401 columns) is masked, not padded.
#include "../../ccim_matmul/csrc/ccim_tile.cuh"

extern "C" int ccim_complex_general(const void* x_re, const void* x_im,
                                    const void* w_re, const void* planes_re,
                                    const void* w_im, const void* planes_im,
                                    void* y_re, void* y_im, int M, int N,
                                    int Kp, void* stream) {
  ccim::tile::Operands op{};
  op.x[0] = static_cast<const int8_t*>(x_re);
  op.x[1] = static_cast<const int8_t*>(x_im);
  op.w[0] = static_cast<const int8_t*>(w_re);
  op.w[1] = static_cast<const int8_t*>(w_im);
  op.planes[0] = static_cast<const int8_t*>(planes_re);
  op.planes[1] = static_cast<const int8_t*>(planes_im);
  op.out[0] = static_cast<int32_t*>(y_re);
  op.out[1] = static_cast<int32_t*>(y_im);
  return ccim::tile::launch<2, false>(op, M, N, Kp, stream);
}
