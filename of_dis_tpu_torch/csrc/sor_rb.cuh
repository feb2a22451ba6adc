// sor_rb.cuh — one pixel of a coupled red-black SOR half-step on the 5-point
// TV system: in the pointer form refine_inner.cu (the solver inside the fused
// TV inner loop) uses, and in the value form of sor_rb.cu's coupled solver,
// which keeps each pixel's system in registers.  Both round alike.  Shifts
// are zero-filled, as in of_dis_tpu/ops/pallas_kernels.py::_shifts; fields
// are (h, w) row-major and k = y * w + x.

#pragma once

#include <cuda_runtime.h>

namespace sor {

// Neighbour sum up(wv*f) + left(wh*f) + wv*down(f) + wh*right(f), zero-fill.
__device__ __forceinline__ float nb(const float* wh, const float* wv, const float* f,
                                    int y, int x, int k, int h, int w) {
  const float up = y > 0 ? wv[k - w] * f[k - w] : 0.f;
  const float left = x > 0 ? wh[k - 1] * f[k - 1] : 0.f;
  const float down = y < h - 1 ? f[k + w] : 0.f;
  const float right = x < w - 1 ? f[k + 1] : 0.f;
  return up + left + wv[k] * down + wh[k] * right;
}

// Coupled update of one pixel (solver.c:19-72): du first, then dv with the
// new du.  du_f, dv_f hold the current fields; inv11 = omega / A11.
__device__ __forceinline__ void coupled_update(const float* wh, const float* wv,
                                               const float* du_f, const float* dv_f,
                                               float b1, float b2, float a12, float inv11,
                                               float inv22, float omega, int y, int x, int k,
                                               int h, int w, float& du_n, float& dv_n) {
  const float du = du_f[k];
  const float dv = dv_f[k];
  const float B1 = b1 + nb(wh, wv, du_f, y, x, k, h, w);
  du_n = (1.f - omega) * du + inv11 * (B1 - a12 * dv);
  const float B2 = b2 + nb(wh, wv, dv_f, y, x, k, h, w);
  dv_n = (1.f - omega) * dv + inv22 * (B2 - a12 * du_n);
}

// The same update from values (sor_rb.cu): du, dv the pixel's fields;
// nb_u, nb_v the neighbour sums of du and dv, in nb's order.  coupled_du
// first, then coupled_dv with its result.
__device__ __forceinline__ float coupled_du(float du, float dv, float nb_u, float b1, float a12,
                                            float inv11, float omega) {
  return (1.f - omega) * du + inv11 * ((b1 + nb_u) - a12 * dv);
}

__device__ __forceinline__ float coupled_dv(float dv, float du_n, float nb_v, float b2, float a12,
                                            float inv22, float omega) {
  return (1.f - omega) * dv + inv22 * ((b2 + nb_v) - a12 * du_n);
}

}  // namespace sor
