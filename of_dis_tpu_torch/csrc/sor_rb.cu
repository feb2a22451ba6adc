// sor_rb.cu — red-black SOR on the 5-point TV system of one refinement
// level of a batch of image pairs, `iterations` sweeps in one launch.  One
// solver body for two systems, templated on NOP:
//   NOP 1, scalar  (stereo, sor_coupled_slow_but_readable_DE, solver.c:428-466).
//            Replaces of_dis_tpu/ops/pallas_kernels.py::_sor_scalar_kernel
//            (launched there by sor_scalar_rb_pallas), with its rounding:
//            A11 = a11 + up(wv) + left(wh) + wv + wh, inv = omega / A11,
//            du' = (1 - omega) du + inv (b1 + nb(du)).
//   NOP 2, coupled (solver.c:19-72): in each colour du first, then dv with
//            the new du.  Replaces ::_sor_coupled_kernel (launched by
//            sor_coupled_rb_pallas), with its rounding (the weights summed
//            first): inv11 = omega / (a11 + (up(wv) + left(wh) + wv + wh)),
//            du' = (1 - omega) du + inv11 (b1 + nb(du) - a12 dv),
//            dv' = (1 - omega) dv + inv22 (b2 + nb(dv) - a12 du').
// Red is (x + y) % 2 == 0; shifts are zero-filled.  The plain versions are
// of_dis_tpu_torch/models/refine.py::sor_scalar_rb and ::sor_coupled_rb.
//
// What bounds them on an H100: barriers.  Every half-step reads neighbours
// that the half-step before wrote, anywhere in the level, so the level needs
// a barrier over all its pixels between half-steps (2 * iterations - 1 of
// them).  Stereo op2's levels hold at most 7,168 px: a launch moves < 0.2 MB
// and does ~1e6 FP32 operations, far below a microsecond of either.  On
// large levels (the grid variant, up to 448 x 1024) a half-step also waits
// on the L2 latency of its neighbour loads, which resident warps hide.
//
// The body is templated on NOP and on its barrier (launch.cuh) and launched
// three ways, picked per level and batch size by ops/kernels.py::sor_variant:
//   block    one CTA, __syncthreads(), the fields in its shared memory;
//   cluster  2-16 CTAs of one thread-block cluster, cluster.sync(), the
//            fields in device memory (L2);
//   grid     one cooperative launch, grid.sync(), the fields in device memory.
// Each thread owns up to PAIRS vertical pixel pairs ((y, x), (y + 1, x), y
// even) for the whole launch: 7 scalar, 3 coupled, whose pixels keep 9
// values instead of 6 (a 512-thread CTA has 128 registers a thread).  A
// pair's two pixels have different colours, so a half-step gives each
// thread one pixel of each pair.  The read-only system of each owned pixel
// (inv = omega / A11, computed once per launch in the Pallas order, b1, wh,
// wv, wh[x-1], wv[y-1], zero at the borders; coupled also inv22, a12, b2)
// stays in registers; only du (and dv) change between half-steps.  Each
// field (du, then dv) has (h + 2) rows with a zero border and an even row
// stride, so a neighbour is one load with no bounds test, and a warp's 32
// pixels of one colour in a row fall on 32 distinct banks.  The first
// half-step reads du_in (and dv_in); the output is written once, after the
// last.  Pairs past PAIRS per thread (the grid variant on levels larger than
// its resident threads hold) recompute their system at each half-step, with
// the same operations.  The variants give the same bits: a half-step reads
// only the other colour's values of the step before.  No atomics, so
// bit-reproducible.
//
// The pair axis (the batch dimension of a vmapped pallas_call): a pair's
// CTAs share blockIdx.y and solve that pair's slices of the batched fields,
// with its own B * NOP fields of scratch; PAIRS registers-held pixel pairs
// per thread count within one image pair.  block: grid (1, B); cluster:
// grid (n_ctas, B), clusters of (n_ctas, 1, 1), never spanning two pairs;
// grid: the resident CTAs split among the pairs, gridDim = (max(1,
// resident / B'), B') with B' = min(B, resident), the pairs past B' taken in
// rounds, and a CTA without a pair in the last round solves no pixels and
// reaches every grid.sync().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "launch.cuh"
#include "sor_rb.cuh"

namespace {

using launch::BlockSync;
using launch::ClusterSync;
using launch::GridSync;

// Pixel pairs a thread keeps in registers (13 registers a scalar pair, 19 a
// coupled one), and the most threads of a CTA: 7 x 512 scalar pairs hold a
// 56 x 128 level in the block variant's one CTA, 3 x 512 coupled pairs a
// 24 x 128 one; the cluster and grid variants address device memory, which
// takes more registers, and run 256-thread CTAs.  At 3 coupled pairs the
// coupled grid variant fits two CTAs per SM in 128 registers a thread
// without a spill.
template <int NOP>
__host__ __device__ constexpr int pairs_per_thread() {
  return NOP == 1 ? 7 : 3;
}
constexpr int BLOCK_THREADS = 512;
constexpr int CTA_THREADS = 256;
constexpr int MAX_CTAS = 16;

struct Params {
  const float *du_in, *dv_in;              // (B, h, w) start fields (dv_in: coupled)
  const float *a11, *a12, *a22, *b1, *b2;  // (B, h, w) system (a12, a22, b2: coupled)
  const float *wh, *wv;                    // (B, h, w) edge weights
  float *du, *dv;                          // (B, h, w) outputs (dv: coupled)
  float* field;  // B * NOP * (h + 2) * row_stride(w) floats: the fields (cluster, grid)
  int h, w, iterations, pairs;
  float omega;
  unsigned long long w_inv;  // launch::row_inverse(w)
};

__host__ __device__ constexpr int row_stride(int w) { return (w + 3) / 2 * 2; }  // even, >= w + 2

// P moved to image pair b: its slice of every field, and its NOP fields of
// scratch.  A pointer the solver does not read (nullptr) stays so.
template <int NOP>
__device__ __forceinline__ Params pair_params(const Params& P, int b) {
  const size_t o = size_t(b) * P.h * P.w;
  Params Q = P;
  Q.du_in += o;
  Q.a11 += o;
  Q.b1 += o;
  Q.wh += o;
  Q.wv += o;
  Q.du += o;
  if constexpr (NOP == 2) {
    Q.dv_in += o;
    Q.a12 += o;
    Q.a22 += o;
    Q.b2 += o;
    Q.dv += o;
  }
  if (Q.field != nullptr) Q.field += size_t(b) * NOP * (P.h + 2) * row_stride(P.w);
  return Q;
}

// The read-only system of one pixel.
struct ScalarSys {
  float inv, b1, wh, wv, whl, wvu;  // whl = wh[x-1], wvu = wv[y-1], 0 at the borders
};
struct CoupledSys : ScalarSys {  // inv = omega / A11
  float inv22, a12, b2;
};
template <int NOP>
using Sys = std::conditional_t<NOP == 1, ScalarSys, CoupledSys>;

template <int NOP>
__device__ __forceinline__ Sys<NOP> load_sys(const Params& P, int k, int y, int x) {
  Sys<NOP> s;
  s.wvu = y > 0 ? P.wv[k - P.w] : 0.f;
  s.whl = x > 0 ? P.wh[k - 1] : 0.f;
  s.wh = P.wh[k];
  s.wv = P.wv[k];
  if constexpr (NOP == 1) {
    s.inv = P.omega / (P.a11[k] + s.wvu + s.whl + s.wv + s.wh);
  } else {
    const float sum_dpsis = s.wvu + s.whl + s.wv + s.wh;
    s.inv = P.omega / (P.a11[k] + sum_dpsis);
    s.inv22 = P.omega / (P.a22[k] + sum_dpsis);
    s.a12 = P.a12[k];
    s.b2 = P.b2[k];
  }
  s.b1 = P.b1[k];
  return s;
}

// Field offset of the pixel of colour c of the pair whose top pixel is at
// field offset ot = (y + 1) * rs + x + 1 (y even, rs even): the top pixel's
// colour is x % 2, and ot is odd exactly when x is even.
__device__ __forceinline__ int colour_offset(int ot, int c, int rs) {
  return ((ot ^ c) & 1) ? ot : ot + rs;
}

// Neighbour sum of a field (up, left, down, right; 0 outside the level), in
// the order of sor_rb.cuh's neighbour sums.
__device__ __forceinline__ float nb_sum(const ScalarSys& s, float fu, float fl, float fd,
                                        float fr) {
  return s.wvu * fu + s.whl * fl + s.wv * fd + s.wh * fr;
}

// du' from the pixel's du and its neighbours.
__device__ __forceinline__ float sor_value(const ScalarSys& s, float omega, float c, float fu,
                                           float fl, float fd, float fr) {
  return (1.f - omega) * c + s.inv * (s.b1 + nb_sum(s, fu, fl, fd, fr));
}

// du' and then dv' (with du') from the pixel's du, dv and their neighbours
// u[4], v[4] (up, left, down, right).
__device__ __forceinline__ void coupled_value(const CoupledSys& s, float omega, float du,
                                              float dv, const float (&u)[4],
                                              const float (&v)[4], float* du_n, float* dv_n) {
  *du_n = sor::coupled_du(du, dv, nb_sum(s, u[0], u[1], u[2], u[3]), s.b1, s.a12, s.inv, omega);
  *dv_n = sor::coupled_dv(dv, *du_n, nb_sum(s, v[0], v[1], v[2], v[3]), s.b2, s.a12, s.inv22,
                          omega);
}

// One half-step of the pixel at field offset o, whose neighbours are in the
// fields (f: du; coupled f + fsize: dv).
template <int NOP>
__device__ __forceinline__ void update(float* f, int fsize, const Sys<NOP>& s, int o, float omega,
                                       int rs) {
  if constexpr (NOP == 1) {
    f[o] = sor_value(s, omega, f[o], f[o - rs], f[o - 1], f[o + rs], f[o + 1]);
  } else {
    float* g = f + fsize;
    const float u[4] = {f[o - rs], f[o - 1], f[o + rs], f[o + 1]};
    const float v[4] = {g[o - rs], g[o - 1], g[o + rs], g[o + 1]};
    float du, dv;
    coupled_value(s, omega, f[o], g[o], u, v, &du, &dv);
    f[o] = du;
    g[o] = dv;
  }
}

// Pair j: column x, top row y (even); which of its pixels is red, and
// whether its bottom pixel exists (h odd).
struct Pair {
  int y, x, k, ot;  // top pixel: row, column, index, field offset
  bool red_top, has_bottom;
};

__device__ __forceinline__ Pair pair_of(const Params& P, int j) {
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
__device__ __forceinline__ bool pixel_of(const Params& P, const Pair& q, int c, int* k, int* y) {
  const bool top = q.red_top == (c == 0);
  *k = top ? q.k : q.k + P.w;
  *y = top ? q.y : q.y + 1;
  return top || q.has_bottom;
}

// A pixel's neighbours (up, left, down, right) in an (h, w) input field, 0
// outside the level.
__device__ __forceinline__ void neighbours(const float* u, int k, int y, int x, int h, int w,
                                           float (&n)[4]) {
  n[0] = y > 0 ? u[k - w] : 0.f;
  n[1] = x > 0 ? u[k - 1] : 0.f;
  n[2] = y < h - 1 ? u[k + w] : 0.f;
  n[3] = x < w - 1 ? u[k + 1] : 0.f;
}

// The first half-step (red) of pair q, from du_in (and dv_in): writes both
// pixels to the fields (red updated, black as it came in) and returns their
// systems.
template <int NOP>
struct PairSys {
  Sys<NOP> red, black;
  bool has_red, has_black;
};

template <int NOP>
__device__ __forceinline__ PairSys<NOP> first_half_step(const Params& P, float* f, int fsize,
                                                        const Pair& q) {
  const float* u = P.du_in;
  const int h = P.h, w = P.w, x = q.x;
  PairSys<NOP> s;
  int k, y;
  s.has_red = pixel_of(P, q, 0, &k, &y);
  if (s.has_red) {
    s.red = load_sys<NOP>(P, k, y, x);
    float nu[4];
    neighbours(u, k, y, x, h, w, nu);
    const int o = colour_offset(q.ot, 0, row_stride(w));
    if constexpr (NOP == 1) {
      f[o] = sor_value(s.red, P.omega, u[k], nu[0], nu[1], nu[2], nu[3]);
    } else {
      float nv[4];
      neighbours(P.dv_in, k, y, x, h, w, nv);
      float du, dv;
      coupled_value(s.red, P.omega, u[k], P.dv_in[k], nu, nv, &du, &dv);
      f[o] = du;
      f[fsize + o] = dv;
    }
  }
  s.has_black = pixel_of(P, q, 1, &k, &y);
  if (s.has_black) {
    s.black = load_sys<NOP>(P, k, y, x);
    const int o = colour_offset(q.ot, 1, row_stride(w));
    f[o] = u[k];
    if constexpr (NOP == 2) f[fsize + o] = P.dv_in[k];
  }
  return s;
}

// Writes pair q's final values from the fields to the outputs.
template <int NOP>
__device__ __forceinline__ void write_pair(const Params& P, const float* f, int fsize,
                                           const Pair& q) {
  const int rs = row_stride(P.w);
  P.du[q.k] = f[q.ot];
  if (q.has_bottom) P.du[q.k + P.w] = f[q.ot + rs];
  if constexpr (NOP == 2) {
    P.dv[q.k] = f[fsize + q.ot];
    if (q.has_bottom) P.dv[q.k + P.w] = f[fsize + q.ot + rs];
  }
}

// Zero border of a field: rows 0 and h + 1, and the padding columns of each
// level row.
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
constexpr int sor_threads() {
  return Sync::SHARED_FIELDS ? BLOCK_THREADS : CTA_THREADS;
}

// Half-step of colour C over a thread's pairs: those it keeps (sys, ot,
// owned) and, in the grid variant (TAIL), those past PAIRS per thread (from
// `tail`, stride apart, below npairs).
template <int NOP, int C, class Sync, int PAIRS>
__device__ __forceinline__ void half_step(const Params& P, float* f, int fsize,
                                          const Sys<NOP> (&sys)[2][PAIRS], const int (&ot)[PAIRS],
                                          unsigned owned, int tail, int stride, int npairs) {
  constexpr bool TAIL = std::is_same<Sync, GridSync>::value;
  const int rs = row_stride(P.w);
  // The coupled solver's fields in device memory: hiding f's value at each
  // half-step makes the compiler recompute the neighbours' 64-bit addresses
  // (one integer multiply-add each) instead of keeping them in registers
  // across the sweeps, which lets the grid variant run two CTAs per SM.
  if constexpr (NOP == 2 && !Sync::SHARED_FIELDS) asm volatile("" : "+l"(f));
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    if ((owned >> (2 * i)) == 0) break;  // a thread's pairs are a prefix of its slots
    if ((owned >> (2 * i + C)) & 1u)
      update<NOP>(f, fsize, sys[C][i], colour_offset(ot[i], C, rs), P.omega, rs);
  }
  if constexpr (TAIL) {
    for (int j = tail; j < npairs; j += stride) {
      const Pair q = pair_of(P, j);
      int k, y;
      if (pixel_of(P, q, C, &k, &y))
        update<NOP>(f, fsize, load_sys<NOP>(P, k, y, q.x), colour_offset(q.ot, C, rs), P.omega,
                    rs);
    }
  }
}

// The solver body: `iterations` sweeps of one image pair's level (P moved to
// that pair).  A CTA without an image pair (live false) solves no pixels and
// reaches every barrier.
template <int NOP, class Sync>
__device__ __forceinline__ void solve(const Params& P, bool live) {
  constexpr int PAIRS = pairs_per_thread<NOP>();
  extern __shared__ float sm[];
  float* f;
  if constexpr (Sync::SHARED_FIELDS) {
    f = sm;
  } else {
    f = P.field;
  }
  const int fsize = (P.h + 2) * row_stride(P.w);  // floats of one field
  const int npairs = live ? (P.h + 1) / 2 * P.w : 0;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  // Only the grid variant takes levels of more than PAIRS pairs per thread;
  // pairs from `tail` on keep no registers.
  constexpr bool TAIL = std::is_same<Sync, GridSync>::value;
  const int tail = first + PAIRS * stride;

  Sys<NOP> sys[2][PAIRS];  // [colour][pair]
  int ot[PAIRS];           // field offset of each pair's top pixel
  unsigned owned = 0;      // bit 2 i + c: pair i has a pixel of colour c (top: always)
  if (live) {
#pragma unroll
    for (int c = 0; c < NOP; ++c) zero_border(f + c * fsize, P.h, P.w, first, stride);
  }
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int j = first + i * stride;
    if (j < npairs) {
      const Pair q = pair_of(P, j);
      const PairSys<NOP> s = first_half_step<NOP>(P, f, fsize, q);
      sys[0][i] = s.red;
      sys[1][i] = s.black;
      ot[i] = q.ot;
      owned |= (unsigned(s.has_red) | unsigned(s.has_black) << 1) << (2 * i);
    }
  }
  if constexpr (TAIL) {
    for (int j = tail; j < npairs; j += stride) first_half_step<NOP>(P, f, fsize, pair_of(P, j));
  }

  Sync::sync();
  for (int sweep = 0; sweep < P.iterations; ++sweep) {
    if (sweep > 0) {
      half_step<NOP, 0, Sync>(P, f, fsize, sys, ot, owned, tail, stride, npairs);
      Sync::sync();
    }
    half_step<NOP, 1, Sync>(P, f, fsize, sys, ot, owned, tail, stride, npairs);
    if (sweep < P.iterations - 1) Sync::sync();
  }

  // Every pixel a thread writes is one it owns and last wrote itself.
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int j = first + i * stride;
    if (j < npairs) write_pair<NOP>(P, f, fsize, pair_of(P, j));
  }
  if constexpr (TAIL) {
    for (int j = tail; j < npairs; j += stride) write_pair<NOP>(P, f, fsize, pair_of(P, j));
  }
}

// The image pairs of a CTA: blockIdx.y, then + gridDim.y while pairs are
// left (rounds, in the grid variant only); every CTA runs the same rounds.
template <int NOP, class Sync>
__device__ __forceinline__ void solve_pairs(const Params& P) {
  for (int r0 = 0; r0 < P.pairs; r0 += gridDim.y) {
    const int b = r0 + blockIdx.y;
    const bool live = b < P.pairs;
    solve<NOP, Sync>(pair_params<NOP>(P, live ? b : 0), live);
  }
}

// The kernels, one per solver and barrier.  The coupled grid variant asks
// for two resident CTAs per SM (at most 128 registers a thread): twice the
// warps of one hide more of the L2 latency of its half-steps, and hold
// twice the pairs in registers.
template <class Sync>
__global__ void __launch_bounds__(sor_threads<Sync>()) sor_scalar_kernel(const Params P) {
  solve_pairs<1, Sync>(P);
}

template <class Sync>
constexpr int coupled_min_ctas() {
  return std::is_same<Sync, GridSync>::value ? 2 : 1;
}

template <class Sync>
__global__ void __launch_bounds__(sor_threads<Sync>(), coupled_min_ctas<Sync>())
    sor_coupled_kernel(const Params P) {
  solve_pairs<2, Sync>(P);
}

template <int NOP, class Sync>
auto kernel_of() {
  return NOP == 1 ? sor_scalar_kernel<Sync> : sor_coupled_kernel<Sync>;
}

int threads_for(int pairs, int most) { return min(most, max(32, (pairs + 31) / 32 * 32)); }

// One CTA per image pair, the fields in its shared memory; a level of more
// than PAIRS pixel pairs per thread is refused.
template <int NOP>
cudaError_t launch_block(const Params& P, cudaStream_t stream) {
  auto kernel = kernel_of<NOP, BlockSync>();
  static launch::PerDevice smem_allowed;
  const int npairs = (P.h + 1) / 2 * P.w;
  if (npairs > pairs_per_thread<NOP>() * BLOCK_THREADS) return cudaErrorInvalidValue;
  int max_smem = 0;
  cudaError_t e = launch::allow_optin_smem(kernel, smem_allowed, &max_smem);
  if (e != cudaSuccess) return e;
  const size_t smem = size_t(NOP) * (P.h + 2) * row_stride(P.w) * sizeof(float);
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  kernel<<<dim3(1, P.pairs), threads_for(npairs, BLOCK_THREADS), smem, stream>>>(P);
  return cudaGetLastError();
}

template <int NOP>
cudaError_t launch_cluster(const Params& P, int n_ctas, cudaStream_t stream) {
  const int npairs = (P.h + 1) / 2 * P.w;
  if (n_ctas < 2 || n_ctas > MAX_CTAS || npairs > n_ctas * pairs_per_thread<NOP>() * CTA_THREADS)
    return cudaErrorInvalidValue;
  auto kernel = kernel_of<NOP, ClusterSync>();
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
  cfg.gridDim = dim3(n_ctas, P.pairs);
  cfg.blockDim = dim3(threads_for((npairs + n_ctas - 1) / n_ctas, CTA_THREADS));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, P);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int NOP>
cudaError_t launch_grid(const Params& P, cudaStream_t stream) {
  auto kernel = kernel_of<NOP, GridSync>();
  constexpr int threads = sor_threads<GridSync>();
  static launch::PerDevice kept;
  int sms = 0, per_sm = 0;
  cudaError_t e = launch::sm_count(&sms);
  if (e == cudaSuccess) e = launch::blocks_per_sm(kernel, threads, 0, kept, &per_sm);
  if (e != cudaSuccess) return e;
  const int resident = per_sm * sms;  // CTAs resident at once (the cooperative limit)
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int npairs = (P.h + 1) / 2 * P.w;
  const int by = min(P.pairs, resident);  // image pairs at once; the rest in rounds
  const int bx = max(1, min((npairs + threads - 1) / threads, resident / by));
  Params args = P;
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(bx, by),
                                  dim3(threads), kargs, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

enum Variant { BLOCK = 0, CLUSTER = 1, GRID = 2 };

template <int NOP>
int launch_variant(const Params& P, int variant, int n_ctas, void* stream) {
  if (P.pairs < 1 || P.pairs > 65535 || P.h < 1 || P.w < 1 || P.iterations < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == BLOCK) return int(launch_block<NOP>(P, s));
  if (variant == CLUSTER) return int(launch_cluster<NOP>(P, n_ctas, s));
  if (variant == GRID) return int(launch_grid<NOP>(P, s));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Each returns the cudaError_t of the launch (0 on success).  The wrappers
// (ops/kernels.py::sor_scalar, ::sor_coupled) have checked shapes, types
// and devices, and give outputs distinct from the inputs.  Every field holds
// `pairs` image pairs.  variant 0 block, 1 cluster of n_ctas CTAs per pair,
// 2 grid; field is scratch of pairs * NOP * (h + 2) * (w + 3) floats for the
// cluster and grid variants (unused by the block variant).
extern "C" int sor_scalar_launch(const float* du_in, const float* a11, const float* b1,
                                 const float* wh, const float* wv, float* du, float* field,
                                 int pairs, int h, int w, int iterations, float omega,
                                 int variant, int n_ctas, void* stream) {
  const Params P{du_in, nullptr, a11, nullptr, nullptr, b1, nullptr, wh, wv, du, nullptr, field,
                 h, w, iterations, pairs, omega, launch::row_inverse(w)};
  return launch_variant<1>(P, variant, n_ctas, stream);
}

extern "C" int sor_coupled_launch(const float* du_in, const float* dv_in, const float* a11,
                                  const float* a12, const float* a22, const float* b1,
                                  const float* b2, const float* wh, const float* wv, float* du,
                                  float* dv, float* field, int pairs, int h, int w,
                                  int iterations, float omega, int variant, int n_ctas,
                                  void* stream) {
  const Params P{du_in, dv_in, a11, a12, a22, b1, b2, wh, wv, du, dv, field,
                 h, w, iterations, pairs, omega, launch::row_inverse(w)};
  return launch_variant<2>(P, variant, n_ctas, stream);
}

