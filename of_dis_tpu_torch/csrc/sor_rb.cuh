// sor_rb.cuh — one pixel of a coupled red-black SOR half-step on the 5-point
// TV system: in the value form of sor_rb.cu's coupled solver, which keeps
// each pixel's system in registers, and in the field form refine_inner.cu
// (the solver inside the fused TV inner loop) uses.  Both round alike.
// Shifts are zero-filled, as in of_dis_tpu/ops/pallas_kernels.py::_shifts;
// fields are (h, w) row-major and k = y * w + x.

#pragma once

#include <cuda_runtime.h>

namespace sor {

// The coupled update (solver.c:19-72) from values: du, dv the pixel's
// fields; nb_u, nb_v the neighbour sums of du and dv, up(wv*f) + left(wh*f)
// + wv*down(f) + wh*right(f) in that order, zero outside the level.
// coupled_du first, then coupled_dv with its result; inv11 = omega / A11.
__device__ __forceinline__ float coupled_du(float du, float dv, float nb_u, float b1, float a12,
                                            float inv11, float omega) {
  return (1.f - omega) * du + inv11 * ((b1 + nb_u) - a12 * dv);
}

__device__ __forceinline__ float coupled_dv(float dv, float du_n, float nb_v, float b2, float a12,
                                            float inv22, float omega) {
  return (1.f - omega) * dv + inv22 * ((b2 + nb_v) - a12 * du_n);
}

// The same update of pixel (y, x) at k from the fields du_f, dv_f, wh, wv:
// every value is loaded once, into a register of its own, before any is
// used (loading wv[k - w] and wh[k - 1] once per sum let the compiler reuse
// a register between the loads, and the half-step waited for memory twice).
__device__ __forceinline__ void coupled_update(const float* wh, const float* wv,
                                               const float* du_f, const float* dv_f,
                                               float b1, float b2, float a12, float inv11,
                                               float inv22, float omega, int y, int x, int k,
                                               int h, int w, float& du_n, float& dv_n) {
  const bool up = y > 0, left = x > 0, down = y < h - 1, right = x < w - 1;
  const float wvu = up ? wv[k - w] : 0.f, whl = left ? wh[k - 1] : 0.f;
  const float wvk = wv[k], whk = wh[k];
  const float du = du_f[k], dv = dv_f[k];
  const float u[4] = {up ? du_f[k - w] : 0.f, left ? du_f[k - 1] : 0.f,
                      down ? du_f[k + w] : 0.f, right ? du_f[k + 1] : 0.f};
  const float v[4] = {up ? dv_f[k - w] : 0.f, left ? dv_f[k - 1] : 0.f,
                      down ? dv_f[k + w] : 0.f, right ? dv_f[k + 1] : 0.f};
  auto nb = [&](const float (&f)[4]) {
    return (up ? wvu * f[0] : 0.f) + (left ? whl * f[1] : 0.f) + wvk * f[2] + whk * f[3];
  };
  du_n = coupled_du(du, dv, nb(u), b1, a12, inv11, omega);
  dv_n = coupled_dv(dv, du_n, nb(v), b2, a12, inv22, omega);
}

}  // namespace sor
