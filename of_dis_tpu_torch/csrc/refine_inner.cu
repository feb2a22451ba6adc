// refine_inner.cu — the whole TV inner loop of one refinement level
// (RefLevelOF, refine_variational.cpp:192-218) in one cooperative launch.
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
// the step before wrote, so the level needs a barrier across the whole grid
// between phases (2 + 2 * solver_it per inner iteration).  The design: one
// cooperative kernel (cudaLaunchCooperativeKernel) whose grid is no larger
// than the occupancy calculator allows on the card, grid-stride loops over
// pixels, cooperative_groups grid.sync() between phases, and the per-pixel
// system (wh, wv, a12, b1, b2, omega/A11, omega/A22) and du, dv held in
// scratch fields the wrapper allocates.  At large levels (448x1024, op4's
// finest) the same kernel strides over more pixels per thread; its fields
// then stay in the 50 MB L2.  No atomics: bit-reproducible.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sor_rb.cuh"

namespace cg = cooperative_groups;

namespace {

// Products taken in double, then rounded once, as the Python constants are.
constexpr float DATANORM = float(0.1 * 0.1);
constexpr float EPS_COLOR = float(0.001 * 0.001);
constexpr float EPS_GRAD = float(0.001 * 0.001);
constexpr float EPS_SMOOTH = float(0.001 * 0.001);
constexpr int THREADS = 256;

struct RefineParams {
  const float *wx, *wy, *mask;                              // (h, w)
  const float *ix, *iy, *iz, *ixx, *ixy, *iyy, *ixz, *iyz;  // (h, w, C)
  float *uu, *vv;                                           // (h, w) outputs
  // scratch, (h, w) each
  float *s, *wh, *wv, *a12, *b1, *b2, *inv11, *inv22, *du, *dv;
  int h, w, n_inner, solver_it;
  float omega, qa, hd3, hg3;
};

// TV diffusivity at pixel (y, x) of u = wx + du, v = wy + dv (replicate borders).
__device__ __forceinline__ float smoothness(const RefineParams& P, int y, int x, bool zero_d) {
  const int w = P.w;
  const int xl = max(x - 1, 0), xr = min(x + 1, w - 1);
  const int yu = max(y - 1, 0), yd = min(y + 1, P.h - 1);
  auto u = [&](int yy, int xx) {
    const int k = yy * w + xx;
    return zero_d ? P.wx[k] + 0.f : P.wx[k] + P.du[k];
  };
  auto v = [&](int yy, int xx) {
    const int k = yy * w + xx;
    return zero_d ? P.wy[k] + 0.f : P.wy[k] + P.dv[k];
  };
  const float ux = 0.5f * (u(y, xr) - u(y, xl));
  const float uy = 0.5f * (u(yd, x) - u(yu, x));
  const float vx = 0.5f * (v(y, xr) - v(y, xl));
  const float vy = 0.5f * (v(yd, x) - v(yu, x));
  return P.qa / sqrtf(ux * ux + uy * uy + vx * vx + vy * vy + EPS_SMOOTH);
}

// Per-pixel system of the current inner iteration (data term + RHS + SOR
// diagonal), from s and the current du, dv.
template <int C>
__device__ __forceinline__ void coefficients(const RefineParams& P, int y, int x, bool zero_d) {
  const int w = P.w, h = P.h;
  const int k = y * w + x;
  const float* s = P.s;
  const float wh = x == w - 1 ? 0.f : s[k] + s[k + 1];
  const float wv = y == h - 1 ? 0.f : s[k] + s[k + w];
  const float whl = x > 0 ? s[k - 1] + s[k] : 0.f;  // wh[y, x-1]
  const float wvu = y > 0 ? s[k - w] + s[k] : 0.f;  // wv[y-1, x]
  const float du = zero_d ? 0.f : P.du[k];
  const float dv = zero_d ? 0.f : P.dv[k];
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
  P.wh[k] = wh;
  P.wv[k] = wv;
  P.a12[k] = a12;
  P.b1[k] = b1;
  P.b2[k] = b2;
  P.inv11[k] = P.omega / (a11 + sum_dpsis);
  P.inv22[k] = P.omega / (a22 + sum_dpsis);
  if (zero_d) {
    P.du[k] = 0.f;
    P.dv[k] = 0.f;
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS) refine_inner_kernel(const RefineParams P) {
  cg::grid_group grid = cg::this_grid();
  const int npx = P.h * P.w;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const float omega = P.omega;

  for (int it = 0; it < P.n_inner; ++it) {
    const bool zero_d = it == 0;
    for (int k = first; k < npx; k += stride) {
      P.s[k] = smoothness(P, k / P.w, k % P.w, zero_d);
    }
    grid.sync();
    for (int k = first; k < npx; k += stride) {
      coefficients<C>(P, k / P.w, k % P.w, zero_d);
    }
    grid.sync();
    for (int sweep = 0; sweep < P.solver_it; ++sweep) {
      for (int color = 0; color < 2; ++color) {
        const bool last = it == P.n_inner - 1 && sweep == P.solver_it - 1 && color == 1;
        for (int k = first; k < npx; k += stride) {
          const int y = k / P.w, x = k % P.w;
          if (((x + y) & 1) == color) {
            float du_n, dv_n;
            sor::coupled_update(P.wh, P.wv, P.du, P.dv, P.b1[k], P.b2[k], P.a12[k], P.inv11[k],
                                P.inv22[k], omega, y, x, k, P.h, P.w, du_n, dv_n);
            P.du[k] = du_n;
            P.dv[k] = dv_n;
            if (last) {
              P.uu[k] = P.wx[k] + du_n;
              P.vv[k] = P.wy[k] + dv_n;
            }
          } else if (last) {  // red pixels are final after the red half-step
            P.uu[k] = P.wx[k] + P.du[k];
            P.vv[k] = P.wy[k] + P.dv[k];
          }
        }
        if (!last) grid.sync();
      }
    }
  }
}

template <int C>
cudaError_t launch(const RefineParams& P, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, refine_inner_kernel<C>, THREADS, 0);
  if (e != cudaSuccess) return e;
  const int need = (P.h * P.w + THREADS - 1) / THREADS;
  const int grid = min(need, per_sm * sms);
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  RefineParams args = P;
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(refine_inner_kernel<C>),
                                  dim3(grid), dim3(THREADS), kargs, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper
// (ops/kernels.py::refine_inner) has checked shapes, types and devices;
// scratch holds 10 (h, w) float32 fields.
extern "C" int refine_inner_launch(
    const float* wx, const float* wy, const float* mask,
    const float* ix, const float* iy, const float* iz, const float* ixx,
    const float* ixy, const float* iyy, const float* ixz, const float* iyz,
    float* uu, float* vv, float* scratch, int h, int w, int c, int n_inner,
    int solver_it, float omega, float qa, float hd3, float hg3, void* stream) {
  if (h < 1 || w < 1 || n_inner < 1 || solver_it < 1) return int(cudaErrorInvalidValue);
  const size_t f = size_t(h) * size_t(w);
  RefineParams P{wx, wy, mask, ix, iy, iz, ixx, ixy, iyy, ixz, iyz, uu, vv,
                 scratch, scratch + f, scratch + 2 * f, scratch + 3 * f, scratch + 4 * f,
                 scratch + 5 * f, scratch + 6 * f, scratch + 7 * f, scratch + 8 * f,
                 scratch + 9 * f, h, w, n_inner, solver_it, omega, qa, hd3, hg3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 1) return int(launch<1>(P, s));
  if (c == 3) return int(launch<3>(P, s));
  return int(cudaErrorInvalidValue);
}
