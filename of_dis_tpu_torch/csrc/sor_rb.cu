// sor_rb.cu — red-black SOR on the 5-point TV system of one refinement
// level, `iterations` sweeps in one launch.  Two solvers:
//   scalar   (stereo, sor_coupled_slow_but_readable_DE, solver.c:428-466).
//            Replaces of_dis_tpu/ops/pallas_kernels.py::_sor_scalar_kernel
//            (launched there by sor_scalar_rb_pallas), with its rounding:
//            A11 = a11 + up(wv) + left(wh) + wv + wh, inv = omega / A11,
//            du' = (1 - omega) du + inv (b1 + nb(du)).
//   coupled  (solver.c:19-72): in each colour du first, then dv with the new
//            du.  Replaces ::_sor_coupled_kernel (launched by
//            sor_coupled_rb_pallas), with its rounding:
//            inv11 = omega / (a11 + (up(wv) + left(wh) + wv + wh)),
//            du' = (1 - omega) du + inv11 (b1 + nb(du) - a12 dv).
// Red is (x + y) % 2 == 0; shifts are zero-filled.  The plain versions are
// of_dis_tpu_torch/models/refine.py::sor_scalar_rb and ::sor_coupled_rb.
//
// What bounds them on an H100: barriers.  Every half-step reads neighbours
// that the half-step before wrote, anywhere in the level, so the level needs
// a barrier over all its pixels between half-steps (2 * iterations - 1 of
// them).  Stereo op2's levels hold at most 7,168 px: a launch moves < 0.2 MB
// and does ~1e6 FP32 operations, far below a microsecond of either.
//
// The scalar solver is one body templated on its barrier (launch.cuh) and
// launched three ways, picked per level by ops/kernels.py::sor_variant:
//   block    one CTA, __syncthreads(), du in its shared memory;
//   cluster  2-16 CTAs of one thread-block cluster, cluster.sync(), du in
//            device memory (L2);
//   grid     one cooperative launch, grid.sync(), du in device memory.
// Each thread owns up to PAIRS vertical pixel pairs ((y, x), (y + 1, x), y
// even) for the whole launch.  A pair's two pixels have different colours,
// so a half-step gives each thread one pixel of each pair.  The read-only
// system of each owned pixel (inv = omega / A11, computed once per launch in
// the Pallas order, b1, wh, wv, wh[x-1], wv[y-1], zero at the borders) stays
// in registers; only du changes between half-steps.  du lives in a field of
// (h + 2) rows with a zero border and an even row stride, so a neighbour is
// one load with no bounds test, and a warp's 32 pixels of one colour in a
// row fall on 32 distinct banks.  The first half-step reads du_in; the
// output is written once, after the last.  Pairs past PAIRS per thread
// (the grid variant on levels larger than its resident threads hold, about
// 236,000 pairs on an H100, one 256-thread block per SM) recompute their
// system at each half-step, with the same operations.  The variants give the same bits: a
// half-step reads only the other colour's values of the step before.  No
// atomics, so bit-reproducible.
//
// The coupled solver is on no path (flow runs its solver inside
// refine_inner.cu): one cooperative kernel with grid-stride pixel loops and
// grid.sync() between half-steps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "launch.cuh"
#include "sor_rb.cuh"

namespace cg = cooperative_groups;

namespace {

using launch::BlockSync;
using launch::ClusterSync;
using launch::GridSync;

// ---------------------------------------------------------------------------
// Scalar solver
// ---------------------------------------------------------------------------

// Pixel pairs a thread keeps in registers (13 registers a pair), and the
// most threads of a CTA: 7 x 512 pairs hold a 56 x 128 level in the block
// variant's one CTA; the cluster and grid variants address device memory,
// which takes more registers, and run 256-thread CTAs.
constexpr int PAIRS = 7;
constexpr int BLOCK_THREADS = 512;
constexpr int CTA_THREADS = 256;
constexpr int MAX_CTAS = 16;

struct ScalarParams {
  const float *du_in, *a11, *b1, *wh, *wv;  // (h, w)
  float* du;                                // (h, w) output
  float* field;  // (h + 2) * row_stride(w) floats: du while the sweeps run (cluster, grid)
  int h, w, iterations;
  float omega;
  unsigned long long w_inv;  // launch::row_inverse(w)
};

__host__ __device__ constexpr int row_stride(int w) { return (w + 3) / 2 * 2; }  // even, >= w + 2

// The read-only system of one pixel.
struct Sys {
  float inv, b1, wh, wv, whl, wvu;  // whl = wh[x-1], wvu = wv[y-1], 0 at the borders
};

__device__ __forceinline__ Sys load_sys(const ScalarParams& P, int k, int y, int x) {
  Sys s;
  s.wvu = y > 0 ? P.wv[k - P.w] : 0.f;
  s.whl = x > 0 ? P.wh[k - 1] : 0.f;
  s.wh = P.wh[k];
  s.wv = P.wv[k];
  s.inv = P.omega / (P.a11[k] + s.wvu + s.whl + s.wv + s.wh);
  s.b1 = P.b1[k];
  return s;
}

// Field offset of the pixel of colour c of the pair whose top pixel is at
// field offset ot = (y + 1) * rs + x + 1 (y even, rs even): the top pixel's
// colour is x % 2, and ot is odd exactly when x is even.
__device__ __forceinline__ int colour_offset(int ot, int c, int rs) {
  return ((ot ^ c) & 1) ? ot : ot + rs;
}

// du' from the pixel's du and its neighbours (up, left, down, right; 0
// outside the level), in sor_rb.cuh::nb's order.
__device__ __forceinline__ float sor_value(const Sys& s, float omega, float c, float fu,
                                           float fl, float fd, float fr) {
  const float nb = s.wvu * fu + s.whl * fl + s.wv * fd + s.wh * fr;
  return (1.f - omega) * c + s.inv * (s.b1 + nb);
}

// One half-step of the pixel at field offset o, whose neighbours are in the field.
__device__ __forceinline__ void update(float* f, const Sys& s, int o, float omega, int rs) {
  f[o] = sor_value(s, omega, f[o], f[o - rs], f[o - 1], f[o + rs], f[o + 1]);
}

// Pair j: column x, top row y (even); which of its pixels is red, and
// whether its bottom pixel exists (h odd).
struct Pair {
  int y, x, k, ot;  // top pixel: row, column, index, field offset
  bool red_top, has_bottom;
};

__device__ __forceinline__ Pair pair_of(const ScalarParams& P, int j) {
  const int yp = launch::row_of(j, P.w, P.w_inv);
  Pair q;
  q.x = j - yp * P.w;
  q.y = 2 * yp;
  q.k = q.y * P.w + q.x;
  q.ot = (q.y + 1) * row_stride(P.w) + q.x + 1;
  q.red_top = (q.x & 1) == 0;
  q.has_bottom = q.y + 1 < P.h;
  return q;
}

// The pixel of colour c of pair q (false if it does not exist).
__device__ __forceinline__ bool pixel_of(const ScalarParams& P, const Pair& q, int c, int* k,
                                         int* y) {
  const bool top = q.red_top == (c == 0);
  *k = top ? q.k : q.k + P.w;
  *y = top ? q.y : q.y + 1;
  return top || q.has_bottom;
}

// The first half-step (red) of pair q, from du_in: writes both pixels to the
// field (red updated, black as it came in) and returns their systems.
struct PairSys {
  Sys red, black;
  bool has_red, has_black;
};

__device__ __forceinline__ PairSys first_half_step(const ScalarParams& P, float* f,
                                                   const Pair& q) {
  const float* u = P.du_in;
  const int h = P.h, w = P.w, x = q.x;
  PairSys s;
  int k, y;
  s.has_red = pixel_of(P, q, 0, &k, &y);
  if (s.has_red) {
    s.red = load_sys(P, k, y, x);
    const float fu = y > 0 ? u[k - w] : 0.f;
    const float fl = x > 0 ? u[k - 1] : 0.f;
    const float fd = y < h - 1 ? u[k + w] : 0.f;
    const float fr = x < w - 1 ? u[k + 1] : 0.f;
    f[colour_offset(q.ot, 0, row_stride(w))] = sor_value(s.red, P.omega, u[k], fu, fl, fd, fr);
  }
  s.has_black = pixel_of(P, q, 1, &k, &y);
  if (s.has_black) {
    s.black = load_sys(P, k, y, x);
    f[colour_offset(q.ot, 1, row_stride(w))] = u[k];
  }
  return s;
}

// Writes pair q's two final values from the field to the output.
__device__ __forceinline__ void write_pair(const ScalarParams& P, const float* f, const Pair& q) {
  P.du[q.k] = f[q.ot];
  if (q.has_bottom) P.du[q.k + P.w] = f[q.ot + row_stride(P.w)];
}

// Zero border of the field: rows 0 and h + 1, and the padding columns of
// each level row.
__device__ __forceinline__ void zero_border(float* f, int h, int w, int first, int stride) {
  const int rs = row_stride(w);
  const int pad = rs - w;  // column 0 and columns w + 1 .. rs - 1
  const int n = 2 * rs + h * pad;
  for (int b = first; b < n; b += stride) {
    int o;
    if (b < 2 * rs) {
      o = b < rs ? b : (h + 1) * rs + b - rs;
    } else {
      const int r = (b - 2 * rs) / pad, q = b - 2 * rs - r * pad;
      o = (r + 1) * rs + (q == 0 ? 0 : w + q);
    }
    f[o] = 0.f;
  }
}

template <class Sync>
constexpr int scalar_threads() {
  return Sync::SHARED_FIELDS ? BLOCK_THREADS : CTA_THREADS;
}

// Half-step of colour C over a thread's pairs: those it keeps (sys, ot,
// live) and, in the grid variant (TAIL), those past PAIRS per thread (from
// `tail`, stride apart).
template <int C, bool TAIL>
__device__ __forceinline__ void half_step(const ScalarParams& P, float* f,
                                          const Sys (&sys)[2][PAIRS], const int (&ot)[PAIRS],
                                          unsigned live, int tail, int stride) {
  const int rs = row_stride(P.w);
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    if ((live >> (2 * i)) == 0) break;  // a thread's pairs are a prefix of its slots
    if ((live >> (2 * i + C)) & 1u)
      update(f, sys[C][i], colour_offset(ot[i], C, rs), P.omega, rs);
  }
  if constexpr (TAIL) {
    const int npairs = (P.h + 1) / 2 * P.w;
    for (int j = tail; j < npairs; j += stride) {
      const Pair q = pair_of(P, j);
      int k, y;
      if (pixel_of(P, q, C, &k, &y))
        update(f, load_sys(P, k, y, q.x), colour_offset(q.ot, C, rs), P.omega, rs);
    }
  }
}

template <class Sync>
__global__ void __launch_bounds__(scalar_threads<Sync>()) sor_scalar_kernel(const ScalarParams P) {
  extern __shared__ float sm[];
  float* f;
  if constexpr (Sync::SHARED_FIELDS) {
    f = sm;
  } else {
    f = P.field;
  }
  const int npairs = (P.h + 1) / 2 * P.w;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  // Only the grid variant takes levels of more than PAIRS pairs per thread;
  // pairs from `tail` on keep no registers.
  constexpr bool TAIL = std::is_same<Sync, GridSync>::value;
  const int tail = first + PAIRS * stride;

  Sys sys[2][PAIRS];  // [colour][pair]
  int ot[PAIRS];      // field offset of each pair's top pixel
  unsigned live = 0;  // bit 2 i + c: pair i has a pixel of colour c (top: always)
  zero_border(f, P.h, P.w, first, stride);
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int j = first + i * stride;
    if (j < npairs) {
      const Pair q = pair_of(P, j);
      const PairSys s = first_half_step(P, f, q);
      sys[0][i] = s.red;
      sys[1][i] = s.black;
      ot[i] = q.ot;
      live |= (unsigned(s.has_red) | unsigned(s.has_black) << 1) << (2 * i);
    }
  }
  if constexpr (TAIL) {
    for (int j = tail; j < npairs; j += stride) first_half_step(P, f, pair_of(P, j));
  }

  Sync::sync();
  for (int sweep = 0; sweep < P.iterations; ++sweep) {
    if (sweep > 0) {
      half_step<0, TAIL>(P, f, sys, ot, live, tail, stride);
      Sync::sync();
    }
    half_step<1, TAIL>(P, f, sys, ot, live, tail, stride);
    if (sweep < P.iterations - 1) Sync::sync();
  }

  // Every pixel a thread writes is one it owns and last wrote itself.
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int j = first + i * stride;
    if (j < npairs) write_pair(P, f, pair_of(P, j));
  }
  if constexpr (TAIL) {
    for (int j = tail; j < npairs; j += stride) write_pair(P, f, pair_of(P, j));
  }
}

int threads_for(int pairs, int most) { return min(most, max(32, (pairs + 31) / 32 * 32)); }

// One CTA, du in its shared memory; a level of more than PAIRS pairs per
// thread is refused.
cudaError_t launch_scalar_block(const ScalarParams& P, cudaStream_t stream) {
  auto kernel = sor_scalar_kernel<BlockSync>;
  static launch::PerDevice smem_allowed;
  const int npairs = (P.h + 1) / 2 * P.w;
  if (npairs > PAIRS * BLOCK_THREADS) return cudaErrorInvalidValue;
  int max_smem = 0;
  cudaError_t e = launch::allow_optin_smem(kernel, smem_allowed, &max_smem);
  if (e != cudaSuccess) return e;
  const size_t smem = size_t(P.h + 2) * row_stride(P.w) * sizeof(float);
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  kernel<<<1, threads_for(npairs, BLOCK_THREADS), smem, stream>>>(P);
  return cudaGetLastError();
}

cudaError_t launch_scalar_cluster(const ScalarParams& P, int n_ctas, cudaStream_t stream) {
  const int npairs = (P.h + 1) / 2 * P.w;
  if (n_ctas < 2 || n_ctas > MAX_CTAS || npairs > n_ctas * PAIRS * CTA_THREADS)
    return cudaErrorInvalidValue;
  auto kernel = sor_scalar_kernel<ClusterSync>;
  static launch::PerDevice non_portable;
  int done = 0;
  cudaError_t e = non_portable.get(&done, [&](int, int* v) {  // clusters above 8 CTAs
    *v = 1;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  });
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ctas);
  cfg.blockDim = dim3(threads_for((npairs + n_ctas - 1) / n_ctas, CTA_THREADS));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, P);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

cudaError_t launch_scalar_grid(const ScalarParams& P, cudaStream_t stream) {
  auto kernel = sor_scalar_kernel<GridSync>;
  constexpr int threads = scalar_threads<GridSync>();
  static launch::PerDevice resident;
  int sms = 0, per_sm = 0;
  cudaError_t e = launch::sm_count(&sms);
  if (e == cudaSuccess) e = launch::blocks_per_sm(kernel, threads, 0, resident, &per_sm);
  if (e != cudaSuccess) return e;
  const int npairs = (P.h + 1) / 2 * P.w;
  const int grid = min((npairs + threads - 1) / threads, per_sm * sms);
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  ScalarParams args = P;
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                  dim3(threads), kargs, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Coupled solver
// ---------------------------------------------------------------------------

constexpr int COUPLED_THREADS = 256;

struct CoupledParams {
  const float *du_in, *dv_in;               // (h, w) start fields
  const float *a11, *a12, *a22, *b1, *b2;   // (h, w) system
  const float *wh, *wv;                     // (h, w) edge weights
  float *du, *dv;                           // (h, w) outputs
  int h, w, iterations;
  float omega;
};

// The first half-step reads the input fields and writes every pixel of the
// outputs (the other colour copied); later half-steps update the outputs in
// place: a half-step writes only its colour and reads only the other.
__global__ void __launch_bounds__(COUPLED_THREADS) sor_coupled_kernel(const CoupledParams P) {
  cg::grid_group grid = cg::this_grid();
  const int h = P.h, w = P.w, npx = h * w;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const float omega = P.omega;
  const float *wh = P.wh, *wv = P.wv;

  for (int sweep = 0; sweep < P.iterations; ++sweep) {
    for (int color = 0; color < 2; ++color) {
      const bool init = sweep == 0 && color == 0;
      const float* su = init ? P.du_in : P.du;
      const float* sv = init ? P.dv_in : P.dv;
      for (int k = first; k < npx; k += stride) {
        const int y = k / w, x = k - (k / w) * w;
        if (((x + y) & 1) == color) {
          const float up_wv = y > 0 ? wv[k - w] : 0.f;
          const float left_wh = x > 0 ? wh[k - 1] : 0.f;
          const float sum_dpsis = up_wv + left_wh + wv[k] + wh[k];
          float du_n, dv_n;
          sor::coupled_update(wh, wv, su, sv, P.b1[k], P.b2[k], P.a12[k],
                              omega / (P.a11[k] + sum_dpsis), omega / (P.a22[k] + sum_dpsis),
                              omega, y, x, k, h, w, du_n, dv_n);
          P.du[k] = du_n;
          P.dv[k] = dv_n;
        } else if (init) {  // the other colour starts as the input
          P.du[k] = su[k];
          P.dv[k] = sv[k];
        }
      }
      if (!(sweep == P.iterations - 1 && color == 1)) grid.sync();
    }
  }
}

cudaError_t launch_coupled(const CoupledParams& P, cudaStream_t stream) {
  static launch::PerDevice resident;
  int sms = 0, per_sm = 0;
  cudaError_t e = launch::sm_count(&sms);
  if (e == cudaSuccess)
    e = launch::blocks_per_sm(sor_coupled_kernel, COUPLED_THREADS, 0, resident, &per_sm);
  if (e != cudaSuccess) return e;
  const int need = (P.h * P.w + COUPLED_THREADS - 1) / COUPLED_THREADS;
  const int grid = min(need, per_sm * sms);
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  CoupledParams args = P;
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sor_coupled_kernel),
                                  dim3(grid), dim3(COUPLED_THREADS), kargs, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

enum Variant { BLOCK = 0, CLUSTER = 1, GRID = 2 };

}  // namespace

// Each returns the cudaError_t of the launch (0 on success).  The wrappers
// (ops/kernels.py::sor_scalar, ::sor_coupled) have checked shapes, types
// and devices, and give outputs distinct from the inputs.  sor_scalar:
// variant 0 block, 1 cluster of n_ctas CTAs, 2 grid; field is scratch of
// (h + 2) * (w + 3) floats for the cluster and grid variants (unused by the
// block variant).
extern "C" int sor_scalar_launch(const float* du_in, const float* a11, const float* b1,
                                 const float* wh, const float* wv, float* du, float* field,
                                 int h, int w, int iterations, float omega, int variant,
                                 int n_ctas, void* stream) {
  if (h < 1 || w < 1 || iterations < 1) return int(cudaErrorInvalidValue);
  const ScalarParams P{du_in, a11, b1, wh, wv, du, field, h, w, iterations, omega,
                       launch::row_inverse(w)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == BLOCK) return int(launch_scalar_block(P, s));
  if (variant == CLUSTER) return int(launch_scalar_cluster(P, n_ctas, s));
  if (variant == GRID) return int(launch_scalar_grid(P, s));
  return int(cudaErrorInvalidValue);
}

extern "C" int sor_coupled_launch(const float* du_in, const float* dv_in, const float* a11,
                                  const float* a12, const float* a22, const float* b1,
                                  const float* b2, const float* wh, const float* wv, float* du,
                                  float* dv, int h, int w, int iterations, float omega,
                                  void* stream) {
  if (h < 1 || w < 1 || iterations < 1) return int(cudaErrorInvalidValue);
  const CoupledParams P{du_in, dv_in, a11, a12, a22, b1, b2, wh, wv, du, dv, h, w, iterations,
                        omega};
  return int(launch_coupled(P, static_cast<cudaStream_t>(stream)));
}
