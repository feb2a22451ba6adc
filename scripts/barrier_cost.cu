// barrier_cost.cu — what one barrier costs on the card, with no work between
// barriers: __syncthreads() in one CTA, cluster.sync() across a thread-block
// cluster, grid.sync() across a cooperative grid.  These are the three
// barriers of of_dis_tpu_torch/csrc/refine_inner.cu's launch variants; the
// numbers bound what any variant can save per phase.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o build/barrier_cost scripts/barrier_cost.cu && build/barrier_cost
//
// Each line is the time of 10,100 barriers minus that of 100, over 10,000.

#include <cooperative_groups.h>
#include <cstdio>
#include <cstdlib>

namespace cg = cooperative_groups;

__global__ void block_barriers(int n, float* out) {
  float a = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    a = a * 1.0001f + 1.f;
    __syncthreads();
  }
  if (a == 12345.f) out[0] = a;  // keeps the loop
}

__global__ void cluster_barriers(int n, float* out) {
  float a = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    a = a * 1.0001f + 1.f;
    cg::this_cluster().sync();
  }
  if (a == 12345.f) out[0] = a;
}

__global__ void grid_barriers(int n, float* out) {
  float a = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    a = a * 1.0001f + 1.f;
    cg::this_grid().sync();
  }
  if (a == 12345.f) out[0] = a;
}

static void check(cudaError_t e) {
  if (e != cudaSuccess) {
    std::fprintf(stderr, "CUDA error %d: %s\n", int(e), cudaGetErrorString(e));
    std::exit(1);
  }
}

// Microseconds per barrier of launch(n) for n barriers.
template <class F>
static double us_per_barrier(F launch) {
  cudaEvent_t s, e;
  check(cudaEventCreate(&s));
  check(cudaEventCreate(&e));
  float ms[2];
  const int counts[2] = {100, 10100};
  launch(counts[0]);  // warm-up
  check(cudaDeviceSynchronize());
  for (int i = 0; i < 2; ++i) {
    check(cudaEventRecord(s));
    launch(counts[i]);
    check(cudaEventRecord(e));
    check(cudaEventSynchronize(e));
    check(cudaEventElapsedTime(&ms[i], s, e));
  }
  return (ms[1] - ms[0]) * 1e3 / (counts[1] - counts[0]);
}

int main() {
  float* out = nullptr;
  check(cudaMalloc(&out, sizeof(float)));
  for (int threads : {256, 448, 1024}) {
    const double us = us_per_barrier([&](int n) {
      block_barriers<<<1, threads>>>(n, out);
      check(cudaGetLastError());
    });
    std::printf("block   1 CTA   x %4d threads: %.4f us per barrier\n", threads, us);
  }
  check(cudaFuncSetAttribute(cluster_barriers, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  for (int ctas : {2, 4, 7, 8, 16}) {
    for (int threads : {256, 1024}) {
      const double us = us_per_barrier([&](int n) {
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = ctas;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(ctas);
        cfg.blockDim = dim3(threads);
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        check(cudaLaunchKernelEx(&cfg, cluster_barriers, n, out));
      });
      std::printf("cluster %2d CTAs x %4d threads: %.4f us per barrier\n", ctas, threads, us);
    }
  }
  for (int ctas : {2, 16, 28, 64, 132}) {
    const double us = us_per_barrier([&](int n) {
      void* args[] = {&n, &out};
      check(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_barriers), dim3(ctas),
                                        dim3(256), args, 0, 0));
    });
    std::printf("grid   %3d CTAs x  256 threads: %.4f us per barrier\n", ctas, us);
  }
  check(cudaFree(out));
  return 0;
}
