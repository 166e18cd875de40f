// Unpacked hybrid-CIM GEMM for Hopper: raw integer weights, decomposed
// in the kernel, at the 28nm prototype's numerics.
//
// Replaces: src/repro/kernels/ccim_matmul/kernel.py,
//   ccim_matmul_pallas (body _ccim_kernel).
//
// Operands:
//   x   (M, Kp) int8 SMF activations, K contiguous
//   w   (Kp, N) int8 SMF weights as the caller holds them, N contiguous
//   out (M, N)  int32 at product scale (x 2^11)
// Kp is a multiple of 16; zero padding is numerically free.
//
// What bounds it: 6 M K N int8 operations (one exact and two plane
// dots) on one weight byte per (k, n): the bytes set the least time up to
// M of about 100 and the int8 peak above it.  This first version runs its
// chunk dots on the integer pipes (__dp4a), so in practice dp4a issue and
// shared-memory reads bind it.
//
// Design: the one-side instance of ccim_tile.cuh.  The weight tile is
// read once from its (K, N) rows, transposed in registers to K-contiguous
// words and folded into the two DCIM planes in the tile fill, so the
// sign/magnitude split and the bit-planes of w happen once per tile,
// never in a separate pass over memory.
#include "ccim_tile.cuh"

extern "C" int ccim_unpacked(const void* x, const void* w, void* out, int M,
                             int N, int Kp, void* stream) {
  ccim::tile::Operands op{};
  op.x[0] = static_cast<const int8_t*>(x);
  op.w[0] = static_cast<const int8_t*>(w);
  op.out[0] = static_cast<int32_t*>(out);
  return ccim::tile::launch<1, true>(op, M, N, Kp, stream);
}
