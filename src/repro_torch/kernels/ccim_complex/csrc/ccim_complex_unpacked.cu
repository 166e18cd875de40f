// Fused complex hybrid-CIM GEMM for Hopper on raw integer weights: one
// co-located (Re, Im) weight residency serves the four real sub-MACs.
//
// Replaces: src/repro/kernels/ccim_complex/kernel.py,
//   ccim_complex_matmul_pallas (body _ccim_complex_kernel).
//
// Operands:
//   x_re, x_im   (M, Kp) int8 SMF activations, K contiguous
//   w_re, w_im   (Kp, N) int8 SMF weights as the caller holds them
//   y_re, y_im   (M, N)  int32 at x 2^11
// Kp is a multiple of 16; zero padding is numerically free.  Int32 holds
// the sums for K < 65,536 (see ccim_tile.cuh).
//
// What bounds it: 24 M K N int8 operations (four streams of one exact
// and two plane dots) on two weight bytes per (k, n): the bytes set the
// least time up to M of about 50 and the int8 peak above it.  The dots
// run on the integer pipes (__dp4a), so dp4a issue binds this first
// version.
//
// Design: the two-side raw instance of ccim_tile.cuh.  The tile fill
// reads each (Re, Im) weight tile once, transposes it in registers and
// folds its DCIM planes once; all four chunk streams read that one
// residency, as the silicon's complex bit-cell serves them.  Each
// stream's y8 is clipped per chunk before Re = ac - bd and Im = ad + bc
// are formed.
#include "../../ccim_matmul/csrc/ccim_tile.cuh"

extern "C" int ccim_complex_unpacked(const void* x_re, const void* x_im,
                                     const void* w_re, const void* w_im,
                                     void* y_re, void* y_im, int M, int N,
                                     int Kp, void* stream) {
  ccim::tile::Operands op{};
  op.x[0] = static_cast<const int8_t*>(x_re);
  op.x[1] = static_cast<const int8_t*>(x_im);
  op.w[0] = static_cast<const int8_t*>(w_re);
  op.w[1] = static_cast<const int8_t*>(w_im);
  op.out[0] = static_cast<int32_t*>(y_re);
  op.out[1] = static_cast<int32_t*>(y_im);
  return ccim::tile::launch<2>(op, M, N, Kp, stream);
}
