// launch.cuh — launch plumbing shared by the port's kernels: the three
// barriers a kernel body is templated on (refine_inner.cu, sor_rb.cu), the
// row of a pixel without an integer division, and per-device launch facts
// (SM count, shared-memory limit, a kernel's resident blocks, attributes)
// queried once per device instead of at every launch.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

namespace launch {

namespace cg = cooperative_groups;

// The barrier between phases of a kernel that runs a whole level in one
// launch, the largest block each variant launches, and whether the level's
// fields live in the block's shared memory.
//   block    one CTA, __syncthreads();
//   cluster  one thread-block cluster of 2-16 CTAs (cudaLaunchKernelEx),
//            cluster.sync(), whose release / acquire orders the CTAs' writes
//            to fields in device memory before the other CTAs' reads;
//   grid     one cooperative launch (cudaLaunchCooperativeKernel), grid.sync().
struct BlockSync {
  static constexpr int MAX_THREADS = 1024;
  static constexpr bool SHARED_FIELDS = true;
  __device__ static void sync() { __syncthreads(); }
};
struct ClusterSync {
  static constexpr int MAX_THREADS = 1024;
  static constexpr bool SHARED_FIELDS = false;
  __device__ static void sync() { cg::this_cluster().sync(); }
};
struct GridSync {
  static constexpr int MAX_THREADS = 256;
  static constexpr bool SHARED_FIELDS = false;
  __device__ static void sync() { cg::this_grid().sync(); }
};

// ceil(2^64 / w) for w > 1 (0 for w == 1), computed once on the host.
__host__ __device__ inline unsigned long long row_inverse(int w) {
  return w > 1 ? ~0ULL / (unsigned long long)w + 1 : 0ULL;
}

// Row of element k of a row-major array of width w: a multiply-high by
// row_inverse(w), exact for every k < 2^32 (an integer division by a runtime
// w costs ~20 instructions, and the kernels' loops need one per element).
__device__ __forceinline__ int row_of(int k, int w, unsigned long long w_inv) {
  return w == 1 ? k : int(__umul64hi((unsigned long long)k, w_inv));
}

constexpr int MAX_DEVICES = 64;

// An int per device, from query(device, &value) at the first call on each
// device, then kept.  A static of the launcher of one kernel instance holds
// that kernel's facts.
class PerDevice {
 public:
  template <class Query>
  cudaError_t get(int* out, Query query) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES) return query(dev, out);
    const int kept = slot_[dev].load(std::memory_order_acquire);
    if (kept != 0) {
      *out = kept - 1;
      return cudaSuccess;
    }
    int v = 0;
    e = query(dev, &v);
    if (e != cudaSuccess) return e;
    slot_[dev].store(v + 1, std::memory_order_release);
    *out = v;
    return cudaSuccess;
  }

 private:
  std::atomic<int> slot_[MAX_DEVICES] = {};  // value + 1; 0 until queried
};

inline cudaError_t sm_count(int* out) {
  static PerDevice kept;
  return kept.get(out, [](int dev, int* v) {
    return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, dev);
  });
}

// The shared memory a block may use after opting in (232,448 bytes on an H100).
inline cudaError_t smem_optin(int* out) {
  static PerDevice kept;
  return kept.get(out, [](int dev, int* v) {
    return cudaDeviceGetAttribute(v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  });
}

// Lets `kernel` use up to the opt-in limit of dynamic shared memory, once per
// device (`kept` is a static of the kernel instance's launcher), and returns
// that limit.
template <class Kernel>
cudaError_t allow_optin_smem(Kernel kernel, PerDevice& kept, int* limit) {
  cudaError_t e = smem_optin(limit);
  if (e != cudaSuccess) return e;
  const int bytes = *limit;
  int done = 0;
  return kept.get(&done, [&](int, int* v) {
    *v = 1;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  });
}

// Blocks of `kernel` at (threads, smem) that fit on one SM at once, once per
// device.
template <class Kernel>
cudaError_t blocks_per_sm(Kernel kernel, int threads, size_t smem, PerDevice& kept, int* out) {
  return kept.get(out, [&](int, int* v) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(v, kernel, threads, smem);
  });
}

}  // namespace launch
