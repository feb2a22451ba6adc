// refine_inner.cu — the whole TV inner loop of one refinement level
// (RefLevelOF, refine_variational.cpp:192-218) of a batch of image pairs in
// one launch.
//
// Replaces of_dis_tpu/ops/pallas_kernels.py::_refine_inner_kernel
// (launched there by refine_inner_pallas).  n_inner times:
//   smoothness  s = qa / sqrt(|grad u|^2 + |grad v|^2 + 1e-6), replicate
//               borders; wh = s + s[x+1] (0 on the last column),
//               wv = s + s[y+1] (0 on the last row)   (opticalflow_aux.c:119-165)
//   data term   colour + gradient constancy, datanorm 0.01, eps 1e-6, the
//               x3 single-channel factors               (opticalflow_aux.c:306-438)
//   RHS         b -= div(w grad(wx|wy)), zero-fill shifts (:171-199)
//   SOR         solver_it red-black sweeps; red is (x + y) % 2 == 0; in each
//               colour du is updated first and dv uses the new du (solver.c:19-72;
//               the pixel update is sor_rb.cuh's, shared with sor_rb.cu)
//   update      uu = wx + du, vv = wy + dv
// The plain version is of_dis_tpu_torch/models/refine.py::refine_inner_reference.
//
// What bounds it on an H100: latency.  At op2's finest level (56x128) a
// launch moves ~0.4 MB and does ~1e7 FP32 operations — well under a
// microsecond of either — while every SOR half-step reads neighbours that
// the step before wrote, so the level needs a barrier over all its pixels
// between phases (2 + 2 * solver_it per inner iteration).  The design: one
// kernel body, templated on that barrier, with the per-pixel system (wh,
// wv, a12, b1, b2, omega/A11, omega/A22) and du, dv in scratch fields the
// wrapper allocates (L2 holds them), and three ways to launch it (the
// barriers are launch.cuh's, shared with sor_rb.cu's scalar solver):
//   block    one CTA of up to 1024 threads, __syncthreads(), the scratch
//            fields in its shared memory; small levels.
//   cluster  2-16 CTAs of up to 512 threads in one thread-block cluster
//            (cudaLaunchKernelEx), cluster.sync(), whose release / acquire
//            orders the CTAs' writes to the fields before the other CTAs'
//            reads; mid-size levels.
//   grid     one cooperative launch (cudaLaunchCooperativeKernel) of as
//            many 256-thread blocks as fit on the card, grid.sync(); large
//            levels (448x1024, op4's finest), whose fields stay in the
//            50 MB L2.
// Every variant strides over one pair's pixels with all the threads of that
// pair's CTAs.  Red-black SOR reads only the other colour's values of the
// step before, so the three give the same bits on the same inputs, at any
// number of CTAs per pair.  No atomics: bit-reproducible.
// ops/kernels.py::refine_variant picks the variant from the level's shape
// and the number of pairs.
//
// The pair axis, the counterpart of the batch dimension a vmapped
// pallas_call adds to its grid: a pair's CTAs share blockIdx.y, its fields
// are the pair's slices of the batched inputs and of the (10, B, h, w)
// scratch.  block: grid (1, B); cluster: grid (n_ctas, B) with clusters of
// (n_ctas, 1, 1), so a cluster never spans two pairs; grid: the resident
// CTAs split among the pairs, gridDim = (max(1, resident / B'), B') with
// B' = min(B, resident).  When B exceeds B' the CTAs take the pairs in
// rounds (pair blockIdx.y, then + B', ...); a CTA without a pair in the last
// round runs the loop on no pixels, so every CTA reaches every grid.sync().

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "launch.cuh"
#include "sor_rb.cuh"

namespace {

// Products taken in double, then rounded once, as the Python constants are.
constexpr float DATANORM = float(0.1 * 0.1);
constexpr float EPS_COLOR = float(0.001 * 0.001);
constexpr float EPS_GRAD = float(0.001 * 0.001);
constexpr float EPS_SMOOTH = float(0.001 * 0.001);

struct RefineParams {
  const float *wx, *wy, *mask;                              // (B, h, w)
  const float *ix, *iy, *iz, *ixx, *ixy, *iyy, *ixz, *iyz;  // (B, h, w, C)
  float *uu, *vv;                                           // (B, h, w) outputs
  // scratch, (B, h, w) each: the fields of the (10, B, h, w) scratch
  float *s, *wh, *wv, *a12, *b1, *b2, *inv11, *inv22, *du, *dv;
  int h, w, n_inner, solver_it, pairs;
  float omega, qa, hd3, hg3;
  unsigned long long w_inv;  // ceil(2^64 / w) (w > 1): row of pixel k = umulhi(k, w_inv)
};
constexpr int SCRATCH_FIELDS = 10;

// Threads of one CTA at most.  The cluster variant's CTAs take 512 (a level
// of more than 16 * 512 pixels strides).  Under a 1024-thread bound the
// compiler scheduled the SOR half-step to reuse a register between two of
// its loads, so it waited for memory twice, and on an H100 the cluster's
// half-step took 18-28 % longer.
template <class Sync>
constexpr int max_threads() {
  return std::is_same<Sync, launch::ClusterSync>::value ? 512 : Sync::MAX_THREADS;
}

// The batch is one stack of B * h rows of width w: pixel (y, x) of pair b
// is k = (b * h + y) * w + x of the inputs, the outputs and the scratch
// fields in device memory (the derivatives at k * C + c), and k - so of the
// scratch fields, so = b * h * w for the block variant's one pair of fields
// in shared memory and 0 otherwise.  The kernel indexes the batch with k,
// as one pair is indexed, and reads the pointers of its parameters: a pair
// moves no pointer and adds no offset to an address.

// TV diffusivity at pixel (y, x) (at k) of u = wx + du, v = wy + dv
// (replicate borders).
__device__ __forceinline__ float smoothness(const RefineParams& P, int so, int y, int x, int k,
                                            bool zero_d) {
  const int w = P.w;
  const int kl = x > 0 ? k - 1 : k, kr = x < w - 1 ? k + 1 : k;
  const int ku = y > 0 ? k - w : k, kd = y < P.h - 1 ? k + w : k;
  auto u = [&](int j) { return zero_d ? P.wx[j] + 0.f : P.wx[j] + P.du[j - so]; };
  auto v = [&](int j) { return zero_d ? P.wy[j] + 0.f : P.wy[j] + P.dv[j - so]; };
  const float ux = 0.5f * (u(kr) - u(kl));
  const float uy = 0.5f * (u(kd) - u(ku));
  const float vx = 0.5f * (v(kr) - v(kl));
  const float vy = 0.5f * (v(kd) - v(ku));
  return P.qa / sqrtf(ux * ux + uy * uy + vx * vx + vy * vy + EPS_SMOOTH);
}

// Per-pixel system of the current inner iteration (data term + RHS + SOR
// diagonal), from s and the current du, dv.
template <int C>
__device__ __forceinline__ void coefficients(const RefineParams& P, int so, int y, int x, int k,
                                             bool zero_d) {
  const int w = P.w, h = P.h;
  const int ks = k - so;  // in the scratch fields
  const float* s = P.s;
  const float wh = x == w - 1 ? 0.f : s[ks] + s[ks + 1];
  const float wv = y == h - 1 ? 0.f : s[ks] + s[ks + w];
  const float whl = x > 0 ? s[ks - 1] + s[ks] : 0.f;  // wh[y, x-1]
  const float wvu = y > 0 ? s[ks - w] + s[ks] : 0.f;  // wv[y-1, x]
  const float du = zero_d ? 0.f : P.du[ks];
  const float dv = zero_d ? 0.f : P.dv[ks];
  const float m = P.mask[k];

  float a11 = 0.f, a12 = 0.f, a22 = 0.f, b1 = 0.f, b2 = 0.f;
  // colour constancy
  float ix[C], iy[C], iz[C], nc[C], tc[C];
  float csum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ix[c] = P.ix[k * C + c];
    iy[c] = P.iy[k * C + c];
    iz[c] = P.iz[k * C + c];
    tc[c] = iz[c] + ix[c] * du + iy[c] * dv;
    nc[c] = ix[c] * ix[c] + iy[c] * iy[c] + DATANORM;
    csum += tc[c] * tc[c] / nc[c];
  }
  const float denc = C == 1 ? sqrtf(3.f * tc[0] * tc[0] / nc[0] + EPS_COLOR) : sqrtf(csum + EPS_COLOR);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float coef = (m * P.hd3 / denc) / nc[c];
    a11 += coef * ix[c] * ix[c];
    a12 += coef * ix[c] * iy[c];
    a22 += coef * iy[c] * iy[c];
    b1 += coef * iz[c] * ix[c];
    b2 += coef * iz[c] * iy[c];
  }
  b1 = -b1;
  b2 = -b2;
  // gradient constancy
  float ixx[C], ixy[C], iyy[C], ixz[C], iyz[C], n1[C], n2[C], t1[C], t2[C];
  float gsum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ixx[c] = P.ixx[k * C + c];
    ixy[c] = P.ixy[k * C + c];
    iyy[c] = P.iyy[k * C + c];
    ixz[c] = P.ixz[k * C + c];
    iyz[c] = P.iyz[k * C + c];
    n1[c] = ixx[c] * ixx[c] + ixy[c] * ixy[c] + DATANORM;
    n2[c] = iyy[c] * iyy[c] + ixy[c] * ixy[c] + DATANORM;
    t1[c] = ixz[c] + ixx[c] * du + ixy[c] * dv;
    t2[c] = iyz[c] + ixy[c] * du + iyy[c] * dv;
    gsum += t1[c] * t1[c] / n1[c] + t2[c] * t2[c] / n2[c];
  }
  const float deng = C == 1
      ? sqrtf(3.f * t1[0] * t1[0] / n1[0] + 3.f * t2[0] * t2[0] / n2[0] + EPS_GRAD)
      : sqrtf(gsum + EPS_GRAD);
  const float tg = m * P.hg3 / deng;
  float ga11 = 0.f, ga12 = 0.f, ga22 = 0.f, gb1 = 0.f, gb2 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float c1 = tg / n1[c], c2 = tg / n2[c];
    ga11 += c1 * ixx[c] * ixx[c] + c2 * ixy[c] * ixy[c];
    ga12 += c1 * ixx[c] * ixy[c] + c2 * ixy[c] * iyy[c];
    ga22 += c2 * iyy[c] * iyy[c] + c1 * ixy[c] * ixy[c];
    gb1 += c1 * ixx[c] * ixz[c] + c2 * ixy[c] * iyz[c];
    gb2 += c2 * iyy[c] * iyz[c] + c1 * ixy[c] * ixz[c];
  }
  a11 += ga11;
  a12 += ga12;
  a22 += ga22;
  b1 -= gb1;
  b2 -= gb2;
  if (C == 1) {
    a11 *= 3.f;
    a12 *= 3.f;
    a22 *= 3.f;
    b1 *= 3.f;
    b2 *= 3.f;
  }

  // weighted-Laplacian RHS with zero-fill shifts: b + th - th[x-1] + tv - tv[y-1]
  auto sub_lap = [&](float b, const float* src) {
    const float c0 = src[k];
    const float th = wh * ((x < w - 1 ? src[k + 1] : 0.f) - c0);
    const float thl = x > 0 ? whl * (c0 - src[k - 1]) : 0.f;
    const float tv = wv * ((y < h - 1 ? src[k + w] : 0.f) - c0);
    const float tvu = y > 0 ? wvu * (c0 - src[k - w]) : 0.f;
    return b + th - thl + tv - tvu;
  };
  b1 = sub_lap(b1, P.wx);
  b2 = sub_lap(b2, P.wy);

  const float sum_dpsis = wvu + whl + wv + wh;
  P.wh[ks] = wh;
  P.wv[ks] = wv;
  P.a12[ks] = a12;
  P.b1[ks] = b1;
  P.b2[ks] = b2;
  P.inv11[ks] = P.omega / (a11 + sum_dpsis);
  P.inv22[ks] = P.omega / (a22 + sum_dpsis);
  if (zero_d) {
    P.du[ks] = 0.f;
    P.dv[ks] = 0.f;
  }
}

// n_inner iterations over one image pair b's level, every thread of the
// pair's CTAs striding over the pixels (smoothness, coefficients) or over
// the pixel pairs (2j, 2j + 1) (SOR half-steps).  A pixel pair's two pixels
// have different colours, also where it wraps to the next row (w odd), so a
// half-step gives each thread one pixel of its colour and no lane idles on
// the other.  A CTA without an image pair (live false) strides over no
// pixels and reaches every barrier.
template <int C, class Sync>
__device__ __forceinline__ void inner_loop(const RefineParams& P, int b, bool live) {
  const int w = P.w, npx = P.h * w;
  const int o = b * npx;                    // the pair's first pixel in the batch
  const int end = live ? o + npx : o;
  const int bh = b * P.h;                   // and its first row
  const int so = Sync::SHARED_FIELDS ? o : 0;
  const int npairs = live ? (npx + 1) / 2 : 0;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const float omega = P.omega;

  for (int it = 0; it < P.n_inner; ++it) {
    const bool zero_d = it == 0;
    for (int k = o + first; k < end; k += stride) {
      const int r = launch::row_of(k, w, P.w_inv);
      P.s[k - so] = smoothness(P, so, r - bh, k - r * w, k, zero_d);
    }
    Sync::sync();
    for (int k = o + first; k < end; k += stride) {
      const int r = launch::row_of(k, w, P.w_inv);
      coefficients<C>(P, so, r - bh, k - r * w, k, zero_d);
    }
    Sync::sync();
    for (int sweep = 0; sweep < P.solver_it; ++sweep) {
      for (int color = 0; color < 2; ++color) {
        const bool last = it == P.n_inner - 1 && sweep == P.solver_it - 1 && color == 1;
        for (int j = first; j < npairs; j += stride) {
          const int k0 = o + 2 * j;
          const int r0 = launch::row_of(k0, w, P.w_inv);
          const int y0 = r0 - bh, x0 = k0 - r0 * w;
          const bool second = ((x0 + y0) & 1) != color;  // this colour's pixel is k0 + 1
          const int k = k0 + second;
          if (k < end) {
            const bool wraps = second && x0 == w - 1;
            const int y = wraps ? y0 + 1 : y0;
            const int x = wraps ? 0 : x0 + second;
            const int ks = k - so;
            float du_n, dv_n;
            sor::coupled_update(P.wh, P.wv, P.du, P.dv, P.b1[ks], P.b2[ks], P.a12[ks],
                                P.inv11[ks], P.inv22[ks], omega, y, x, ks, P.h, w, du_n, dv_n);
            P.du[ks] = du_n;
            P.dv[ks] = dv_n;
            if (last) {
              P.uu[k] = P.wx[k] + du_n;
              P.vv[k] = P.wy[k] + dv_n;
            }
          }
          const int kr = k == k0 ? k0 + 1 : k0;  // the red pixel, final after the red half-step
          if (last && kr < end) {
            P.uu[kr] = P.wx[kr] + P.du[kr - so];
            P.vv[kr] = P.wy[kr] + P.dv[kr - so];
          }
        }
        if (!last) Sync::sync();
      }
    }
  }
}

// The pairs of a CTA: blockIdx.y, then + gridDim.y while pairs are left
// (rounds, in the grid variant only: the block and cluster variants launch
// gridDim.y = B); the round count is the same for every CTA of the launch.
template <int C, class Sync>
__global__ void __launch_bounds__(max_threads<Sync>()) refine_inner_kernel(const RefineParams P) {
  constexpr bool rounds = std::is_same<Sync, launch::GridSync>::value;
  for (int r0 = 0; r0 < (rounds ? P.pairs : 1); r0 += gridDim.y) {
    const int b = r0 + blockIdx.y;
    const bool live = !rounds || b < P.pairs;
    if constexpr (Sync::SHARED_FIELDS) {
      extern __shared__ float sm[];
      const int f = P.h * P.w;
      RefineParams Q = P;
      Q.s = sm;
      Q.wh = sm + f;
      Q.wv = sm + 2 * f;
      Q.a12 = sm + 3 * f;
      Q.b1 = sm + 4 * f;
      Q.b2 = sm + 5 * f;
      Q.inv11 = sm + 6 * f;
      Q.inv22 = sm + 7 * f;
      Q.du = sm + 8 * f;
      Q.dv = sm + 9 * f;
      inner_loop<C, Sync>(Q, live ? b : 0, live);
    } else {
      inner_loop<C, Sync>(P, live ? b : 0, live);
    }
  }
}

using launch::BlockSync;
using launch::ClusterSync;
using launch::GridSync;

int threads_for(int px) { return min(1024, max(32, (px + 31) / 32 * 32)); }

// One CTA per pair with its ten scratch fields in shared memory; a level
// whose fields do not fit (> 5811 px in the 227 KB a block may use on an
// H100) is refused.
template <int C>
cudaError_t launch_block(const RefineParams& P, cudaStream_t stream) {
  auto kernel = refine_inner_kernel<C, BlockSync>;
  static launch::PerDevice smem_allowed;
  int max_smem = 0;
  cudaError_t e = launch::allow_optin_smem(kernel, smem_allowed, &max_smem);
  if (e != cudaSuccess) return e;
  const size_t smem = size_t(SCRATCH_FIELDS) * P.h * P.w * sizeof(float);
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  kernel<<<dim3(1, P.pairs), threads_for(P.h * P.w), smem, stream>>>(P);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_cluster(const RefineParams& P, int n_ctas, cudaStream_t stream) {
  if (n_ctas < 2 || n_ctas > 16) return cudaErrorInvalidValue;
  auto kernel = refine_inner_kernel<C, ClusterSync>;
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
  cfg.blockDim = dim3(min(max_threads<ClusterSync>(),
                          threads_for((P.h * P.w + n_ctas - 1) / n_ctas)));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, P);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_grid(const RefineParams& P, cudaStream_t stream) {
  auto kernel = refine_inner_kernel<C, GridSync>;
  constexpr int threads = GridSync::MAX_THREADS;
  static launch::PerDevice kept;
  int sms = 0, per_sm = 0;
  cudaError_t e = launch::sm_count(&sms);
  if (e == cudaSuccess) e = launch::blocks_per_sm(kernel, threads, 0, kept, &per_sm);
  if (e != cudaSuccess) return e;
  const int resident = per_sm * sms;  // CTAs resident at once (the cooperative limit)
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int need = (P.h * P.w + threads - 1) / threads;
  const int by = min(P.pairs, resident);  // pairs at once; the rest in rounds
  const int bx = max(1, min(need, resident / by));
  RefineParams args = P;
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(bx, by),
                                  dim3(threads), kargs, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

enum Variant { BLOCK = 0, CLUSTER = 1, GRID = 2 };

template <int C>
cudaError_t launch_variant(const RefineParams& P, int variant, int n_ctas, cudaStream_t stream) {
  if (variant == BLOCK) return launch_block<C>(P, stream);
  if (variant == CLUSTER) return launch_cluster<C>(P, n_ctas, stream);
  if (variant == GRID) return launch_grid<C>(P, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper
// (ops/kernels.py::refine_inner) has checked shapes, types and devices; the
// fields hold `pairs` image pairs and scratch 10 (pairs, h, w) float32
// fields.  variant: 0 block, 1 cluster of n_ctas CTAs per pair, 2 grid.
extern "C" int refine_inner_launch(
    const float* wx, const float* wy, const float* mask,
    const float* ix, const float* iy, const float* iz, const float* ixx,
    const float* ixy, const float* iyy, const float* ixz, const float* iyz,
    float* uu, float* vv, float* scratch, int pairs, int h, int w, int c, int n_inner,
    int solver_it, float omega, float qa, float hd3, float hg3, int variant, int n_ctas,
    void* stream) {
  // pixel indices of the batch, times C, are ints
  if (pairs < 1 || pairs > 65535 || h < 1 || w < 1 || n_inner < 1 || solver_it < 1 ||
      (long long)pairs * h * w * c > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  const size_t f = size_t(pairs) * h * w;  // floats of one scratch field
  RefineParams P{wx, wy, mask, ix, iy, iz, ixx, ixy, iyy, ixz, iyz, uu, vv,
                 scratch, scratch + f, scratch + 2 * f, scratch + 3 * f, scratch + 4 * f,
                 scratch + 5 * f, scratch + 6 * f, scratch + 7 * f, scratch + 8 * f,
                 scratch + 9 * f, h, w, n_inner, solver_it, pairs, omega, qa, hd3, hg3,
                 launch::row_inverse(w)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 1) return int(launch_variant<1>(P, variant, n_ctas, s));
  if (c == 3) return int(launch_variant<3>(P, variant, n_ctas, s));
  return int(cudaErrorInvalidValue);
}

