// HBM rate of weight streaming patterns on one CUDA card, with no
// arithmetic: three int8 (N, Kp) operands (w and two folded planes) of
// each of minicpm-2b's four full-width layer GEMMs read once, as the
// skinny macro GEMM (kernel row 1) reads them.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/stage_probe tools/stage_probe.cu && build/stage_probe
//
// ring R x B Sn bpsK: a persistent grid of K blocks per SM, each block a
// cp.async ring of n stages of R rows x B bytes per row per operand,
// walking an even share of the (R-row group, B-byte K stage) sequence;
// a stage is consumed (xor-reduced) as soon as it lands.  direct Un: one
// warp per row, each lane n 16-byte loads of each operand in flight, no
// shared memory (the pattern of the parent kernel of row 1).  Times are
// per layer (the four GEMMs summed): cold rotates over 6 copies of the
// operands (1.2 GB), same-operand replays one copy; both are CUDA-graph
// replays of 24 launches per GEMM, the least of 5.  The last line is a
// device-to-device memcpy of 204 MB (read and write) for scale.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <vector>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int ROWS, int BPR, int S>
__global__ void __launch_bounds__(256) ring(const int8_t* w0, const int8_t* w1,
                                            const int8_t* w2, int N, int Kp,
                                            int* sink) {
  extern __shared__ __align__(128) int8_t smem[];
  constexpr int kStage = 3 * ROWS * BPR;
  const int tid = threadIdx.x;
  const long ks_n = (Kp + BPR - 1) / BPR, T = (long)(N / ROWS) * ks_n;
  const long L0 = blockIdx.x * T / gridDim.x;
  const int n = (int)((blockIdx.x + 1) * T / gridDim.x - L0);
  const int8_t* base[3] = {w0, w1, w2};
  auto load = [&](int t) {
    int8_t* st = smem + (t % S) * kStage;
    const long L = L0 + t;
    const int r0 = (int)(L / ks_n) * ROWS, k0 = (int)(L % ks_n) * BPR;
#pragma unroll
    for (int op = 0; op < 3; ++op)
#pragma unroll
      for (int i = 0; i < ROWS * BPR / 16 / 256; ++i) {
        const int p = tid + i * 256, r = p / (BPR / 16), s = p % (BPR / 16);
        if (k0 + 16 * s < Kp)
          cp16(smem_addr(st + op * ROWS * BPR + p * 16),
               base[op] + (size_t)(r0 + r) * Kp + k0 + 16 * s);
      }
  };
  unsigned acc = 0;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n) load(s);
    commit();
  }
  for (int t = 0; t < n; ++t) {
    wait_group<S - 2>();
    __syncthreads();
    if (t + S - 1 < n) load(t + S - 1);
    commit();
    const int4* st = reinterpret_cast<const int4*>(smem + (t % S) * kStage);
    for (int i = tid; i < kStage / 16; i += 256) {
      const int4 v = st[i];
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  wait_group<0>();
  if (acc == 0x12345678u) sink[0] = 1;
}

template <int U>
__global__ void __launch_bounds__(256) direct(const int8_t* w0,
                                              const int8_t* w1,
                                              const int8_t* w2, int N, int Kp,
                                              int* sink) {
  const int warp = (blockIdx.x * 256 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31, n_warps = gridDim.x * 8;
  unsigned acc = 0;
  for (int row = warp; row < N; row += n_warps) {
    const int8_t* b[3] = {w0 + (size_t)row * Kp, w1 + (size_t)row * Kp,
                          w2 + (size_t)row * Kp};
    for (int k = lane * 16; k < Kp; k += 512 * U) {
      int4 v[3][U];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int o = 0; o < 3; ++o)
          v[o][u] = k + 512 * u < Kp
                        ? __ldcs(reinterpret_cast<const int4*>(b[o] + k +
                                                               512 * u))
                        : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int o = 0; o < 3; ++o)
          acc ^= v[o][u].x ^ v[o][u].y ^ v[o][u].z ^ v[o][u].w;
    }
  }
  if (acc == 0x12345678u) sink[0] = 1;
}

struct Shape {
  int K, N;
};
const Shape kShapes[4] = {{2304, 9216}, {3072, 2304}, {2304, 11520},
                          {5760, 2304}};
constexpr int kCopies = 6;

}  // namespace

int main() {
  int n_sm = 0;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0);
  std::vector<int8_t*> buf[4];
  double layer_bytes = 0;
  for (int s = 0; s < 4; ++s) {
    const size_t nb = (size_t)kShapes[s].K * kShapes[s].N;
    layer_bytes += 3.0 * nb;
    for (int c = 0; c < 3 * kCopies; ++c) {
      int8_t* p = nullptr;
      cudaMalloc(&p, nb);
      cudaMemset(p, c, nb);
      buf[s].push_back(p);
    }
  }
  int* sink = nullptr;
  cudaMalloc(&sink, 4);
  cudaStream_t st;
  cudaStreamCreate(&st);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  auto time_layer = [&](const char* name, auto launch) {
    double cold = 0, same = 0;
    for (int one = 0; one < 2; ++one)
      for (int s = 0; s < 4; ++s) {
        cudaGraph_t g;
        cudaGraphExec_t ge;
        cudaStreamBeginCapture(st, cudaStreamCaptureModeGlobal);
        for (int i = 0; i < 4 * kCopies; ++i) {
          const int c = one ? 0 : i % kCopies;
          launch(s, buf[s][3 * c], buf[s][3 * c + 1], buf[s][3 * c + 2]);
        }
        cudaStreamEndCapture(st, &g);
        cudaGraphInstantiate(&ge, g, 0);
        cudaGraphLaunch(ge, st);
        cudaStreamSynchronize(st);
        float best = 1e9f;
        for (int rep = 0; rep < 5; ++rep) {
          cudaEventRecord(a, st);
          cudaGraphLaunch(ge, st);
          cudaEventRecord(b, st);
          cudaEventSynchronize(b);
          float ms = 0;
          cudaEventElapsedTime(&ms, a, b);
          best = std::min(best, ms / (4 * kCopies));
        }
        (one ? same : cold) += best;
        if (!one)
          printf("  %s %dx%d: %.4f ms, %.2f TB/s\n", name, kShapes[s].K,
                 kShapes[s].N, best,
                 3.0 * kShapes[s].K * kShapes[s].N / best / 1e9);
        cudaGraphExecDestroy(ge);
        cudaGraphDestroy(g);
      }
    printf("%s: cold %.4f ms, same-operand %.4f ms per layer (%.2f TB/s "
           "cold) %s\n",
           name, cold, same, layer_bytes / cold / 1e9,
           cudaGetErrorString(cudaGetLastError()));
    fflush(stdout);
  };
#define RING(ROWS, BPR, S, BPS)                                               \
  {                                                                           \
    auto k = ring<ROWS, BPR, S>;                                              \
    const int smem = S * 3 * ROWS * BPR;                                      \
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                         smem);                                               \
    char name[64];                                                            \
    snprintf(name, sizeof name, "ring %dx%d S%d bps%d", ROWS, BPR, S, BPS);   \
    time_layer(name, [&](int s, int8_t* p0, int8_t* p1, int8_t* p2) {        \
      const long T = (long)(kShapes[s].N / ROWS) *                            \
                     ((kShapes[s].K + BPR - 1) / BPR);                        \
      const int grid = (int)std::min<long>(T, (long)n_sm * BPS);              \
      k<<<grid, 256, smem, st>>>(p0, p1, p2, kShapes[s].N, kShapes[s].K,      \
                                 sink);                                       \
    });                                                                       \
  }
  RING(128, 64, 6, 1)
  RING(64, 128, 6, 1)
  RING(32, 256, 6, 1)
  RING(16, 512, 6, 1)
  RING(32, 256, 4, 2)
  RING(16, 512, 4, 2)
  RING(128, 64, 3, 2)
  RING(64, 128, 3, 2)
#undef RING
  time_layer("direct U4", [&](int s, int8_t* p0, int8_t* p1, int8_t* p2) {
    direct<4><<<n_sm * 4, 256, 0, st>>>(p0, p1, p2, kShapes[s].N,
                                        kShapes[s].K, sink);
  });
  time_layer("direct U1", [&](int s, int8_t* p0, int8_t* p1, int8_t* p2) {
    direct<1><<<n_sm * 8, 256, 0, st>>>(p0, p1, p2, kShapes[s].N,
                                        kShapes[s].K, sink);
  });
  {
    const size_t nb = (size_t)layer_bytes;
    int8_t *src = nullptr, *dst = nullptr;
    cudaMalloc(&src, nb);
    cudaMalloc(&dst, nb);
    cudaMemcpyAsync(dst, src, nb, cudaMemcpyDeviceToDevice, st);
    cudaEventRecord(a, st);
    for (int i = 0; i < 5; ++i)
      cudaMemcpyAsync(dst, src, nb, cudaMemcpyDeviceToDevice, st);
    cudaEventRecord(b, st);
    cudaEventSynchronize(b);
    float ms = 0;
    cudaEventElapsedTime(&ms, a, b);
    printf("memcpy %.0f MB: %.4f ms, %.2f TB/s (read and write) %s\n",
           nb / 1e6, ms / 5, 2.0 * nb / (ms / 5) / 1e9,
           cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
