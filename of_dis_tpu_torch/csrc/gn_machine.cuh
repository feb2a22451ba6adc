// gn_machine.cuh — the inverse-compositional Gauss-Newton state machine of
// one patch (PatClass::OptimizeStart / OptimizeIter / OptimizeComputeErrImg,
// patch.cpp:119-284), shared by level_search.cu (templates extracted in the
// kernel) and gn_search.cu (templates built beforehand).  It is the CUDA
// counterpart of of_dis_tpu/ops/pallas_kernels.py::_gn_machine, which the
// TPU kernels _level_kernel, _gn_kernel and _gn_kernel_tiled share.
//
// One block runs one patch: psz^2 threads (one patch pixel each) rounded up
// to whole warps; threads past psz^2 hold zeros and take part in every
// reduction.  The machine loads the patch's (sy, sx, C) search window of the
// padded target image into shared memory at the clipped window base
// (inverse_search.py:303-308), then runs max_iter + 1 trips: bilinear
// extraction from the window (taps outside it read 0), mean normalisation,
// the costs L2 / L1 / pseudo-Huber / NCC, the 2x2 (or 1x1) solve, the
// outlier / out-of-bounds reset, the stereo sign clamp and the reference's
// convergence predicate.
//
// Every reduction is a warp butterfly plus one fixed-order shared-memory
// step, so all threads hold the same per-patch scalars: the trip loop is
// uniform across the block and `converged` never splits a barrier, and the
// results are bit-reproducible.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gnm {

struct GNConsts {
  int n, hp, wp, pad, w, h, sy, sx;
  int max_iter, min_iter, cost, patch_norm, stereo_clamp;  // clamp: -1 none, 0 min(p,0), 1 max(p,0)
  float normoutlier, dp_thresh_sq, dr_thresh, res_thresh, outlier_sq, minerrval;
};

// Sum of K values over the block; every thread receives the same totals.
// Warp butterfly, then lane 0 of each warp stores its partial and every
// thread adds the partials in warp order (fixed order: reproducible).
template <int NW, int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * NW + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = red[k * NW];
#pragma unroll
    for (int q = 1; q < NW; ++q) s += red[k * NW + q];
    v[k] = s;
  }
  __syncthreads();  // red is reused by the next reduction
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// LossComputeErrorImage (patch.cpp:223-262): pdiff; pweight = |pdiff|.
__device__ __forceinline__ float loss_pd(float d, int cost, float normoutlier) {
  if (cost == 1) return signf(d) * sqrtf(fabsf(d));
  if (cost == 2) {
    const float bsq = normoutlier * normoutlier;
    return signf(d) * sqrtf(2.f * bsq * (sqrtf(1.f + d * d / bsq) - 1.f));
  }
  return d;  // L2 (and NCC, whose diff is formed before)
}

__device__ __forceinline__ bool out_of_bounds(float x, float y, int w, int h, int psz) {
  const float lb = -float(psz) / 2.f;
  return x < lb || y < lb || x > float(w + psz / 2 - 2) || y > float(h + psz / 2 - 2);
}

// What one patch's search leaves behind.
template <int C>
struct GNOut {
  float p0, p1, ptx, pty;
  float pweight[C];  // |residual| of this thread's patch pixel
  bool conv;
  int cnt;           // GN iterations run
};

// The template of this thread's pixel (T, DX, DY per channel), the patch's
// Hessian (h00, h01, h11; det; with the 1e-10 bump already applied), the
// template norm tn (cost 10 only), the static centre (prx, pry) and the
// start displacement (pin0, pin1).  win and red are the block's shared
// buffers.
template <int PSZ, int C, int NOP>
__device__ __forceinline__ GNOut<C> gn_machine(
    const GNConsts& P, const float* __restrict__ imb, const float (&T)[C],
    const float (&DX)[C], const float (&DY)[C], float h00, float h01, float h11, float det,
    float tn, float prx, float pry, float pin0, float pin1,
    float (&win)[C][2 * PSZ + 2][2 * PSZ + 2], float* red) {
  constexpr int NPIX = PSZ * PSZ;
  constexpr int NT = ((NPIX + 31) / 32) * 32;
  constexpr int NW = NT / 32;
  constexpr int LB = -(PSZ / 2);
  const int t = threadIdx.x;
  const bool has_px = t < NPIX;
  const int j = t / PSZ;  // patch row
  const int i = t % PSZ;  // patch column
  const float novals = float(C * NPIX);
  const int sy = P.sy, sx = P.sx, wp = P.wp;

  // ---- start position, window base and window (OptimizeStart) ----
  const float stx = prx + pin0;
  const float sty = NOP == 2 ? pry + pin1 : pry;
  const bool oob0 = out_of_bounds(stx, sty, P.w, P.h, PSZ);
  const int by = min(max(int(floorf(sty)) + LB - PSZ / 2 + P.pad, 0), P.hp - sy);
  const int bx = min(max(int(floorf(stx)) + LB - PSZ / 2 + P.pad, 0), wp - sx);
  for (int k = t; k < sy * sx * C; k += NT) {
    const int yy = k / (sx * C);
    const int rem = k - yy * sx * C;
    const int xx = rem / C;
    const int c = rem - xx * C;
    win[c][yy][xx] = imb[((by + yy) * wp + bx) * C + rem];
  }
  __syncthreads();

  // ---- GN state machine (patch.cpp:119-284) ----
  float p0 = pin0, p1 = pin1, ptx = stx, pty = sty;
  float pdiff[C], pweight[C];
#pragma unroll
  for (int c = 0; c < C; ++c) pdiff[c] = pweight[c] = 0.f;
  float mares = 1e5f, dpsq_init = 1e-10f;
  int cnt = 0;
  bool conv = false;

  for (int trip = 0; trip <= P.max_iter; ++trip) {
    if (conv) break;  // block-uniform: a converged patch is frozen
    const bool first = trip == 0;
    const int cnt_n = first ? 0 : cnt + 1;

    // delta_p = H^-1 (J^T pdiff) (patch.cpp:176-184)
    float d0 = 0.f, d1 = 0.f;
    if (!first) {
      float v[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[0] += DX[c] * pdiff[c];
        v[1] += DY[c] * pdiff[c];
      }
      if (NOP == 2) {
        block_sum<NW, 2>(v, red);
        d0 = (h11 * v[0] - h01 * v[1]) / det;
        d1 = (h00 * v[1] - h01 * v[0]) / det;
      } else {
        float v1[1] = {v[0]};
        block_sum<NW, 1>(v1, red);
        d0 = v1[0] / h00;
      }
    }
    float np0 = p0 - d0, np1 = p1 - d1;
    if (!first && P.stereo_clamp == 0) np0 = fminf(np0, 0.f);
    if (!first && P.stereo_clamp == 1) np0 = fmaxf(np0, 0.f);
    float nx = prx + np0;
    float ny = NOP == 2 ? pry + np1 : pry;

    // outlier / bounds reset (patch.cpp:198-208)
    bool reset = false;
    if (!first) {
      const float ex = stx - nx, ey = sty - ny;
      reset = (ex * ex + ey * ey > P.outlier_sq) || out_of_bounds(nx, ny, P.w, P.h, PSZ);
      if (reset) {
        np0 = pin0;
        np1 = pin1;
        nx = prx + np0;
        ny = NOP == 2 ? pry + np1 : pry;
      }
    }

    // OptimizeComputeErrImg (patch.cpp:264-284) — runs even after a reset
    const bool oob_start = first && oob0;
    float pd[C], pw[C];
    float mares_n = 1e5f;
    if (oob_start) {
      // pdiff = template (patch.cpp:139); pweight = |loss(template)|
#pragma unroll
      for (int c = 0; c < C; ++c) {
        pd[c] = P.cost == 10 ? T[c] : loss_pd(T[c], P.cost, P.normoutlier);
        pw[c] = fabsf(pd[c]);
      }
    } else {
      const float fy = floorf(ny), fx = floorf(nx);
      const float ry = ny - fy, rx = nx - fx;
      const int y0 = int(fy) + LB + P.pad - by + j;
      const int x0 = int(fx) + LB + P.pad - bx + i;
      const bool iy0 = y0 >= 0 && y0 < sy, iy1 = y0 + 1 >= 0 && y0 + 1 < sy;
      const bool ix0 = x0 >= 0 && x0 < sx, ix1 = x0 + 1 >= 0 && x0 + 1 < sx;
      float raw[C];
      float v[1] = {0.f};
#pragma unroll
      for (int c = 0; c < C; ++c) {
        // blend rows, then columns; taps outside the window read 0
        const float w00 = (iy0 && ix0) ? win[c][y0][x0] : 0.f;
        const float w10 = (iy1 && ix0) ? win[c][y0 + 1][x0] : 0.f;
        const float w01 = (iy0 && ix1) ? win[c][y0][x0 + 1] : 0.f;
        const float w11 = (iy1 && ix1) ? win[c][y0 + 1][x0 + 1] : 0.f;
        const float col0 = (1.f - ry) * w00 + ry * w10;
        const float col1 = (1.f - ry) * w01 + ry * w11;
        raw[c] = has_px ? (1.f - rx) * col0 + rx * col1 : 0.f;
        v[0] += raw[c];
      }
      if (P.patch_norm) {
        block_sum<NW, 1>(v, red);
        const float mean = v[0] / novals;
#pragma unroll
        for (int c = 0; c < C; ++c) raw[c] = has_px ? raw[c] - mean : 0.f;
      }
      if (P.cost == 10) {
        float q[1] = {0.f};
#pragma unroll
        for (int c = 0; c < C; ++c) q[0] += raw[c] * raw[c];
        block_sum<NW, 1>(q, red);
        const float scale = tn / fmaxf(sqrtf(q[0]), 1e-10f);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          pd[c] = raw[c] * scale - T[c];
          pw[c] = fabsf(pd[c]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          pd[c] = loss_pd(raw[c] - T[c], P.cost, P.normoutlier);
          pw[c] = fabsf(pd[c]);
        }
      }
      float m[1] = {0.f};
#pragma unroll
      for (int c = 0; c < C; ++c) m[0] += has_px ? pw[c] : 0.f;
      block_sum<NW, 1>(m, red);
      mares_n = m[0] / novals;
    }

    const float dpsq_n = first ? 1e-10f : d0 * d0 + d1 * d1;
    const float dpsq_init_n = cnt_n == 1 ? dpsq_n : dpsq_init;
    const float mares_old_n = first ? 1e5f : mares;
    const bool keep_going =
        cnt_n < P.max_iter && mares_n > P.res_thresh &&
        (cnt_n < P.min_iter || dpsq_n / dpsq_init_n >= P.dp_thresh_sq) &&
        (cnt_n < P.min_iter || mares_n / mares_old_n <= P.dr_thresh);

    p0 = np0;
    p1 = np1;
    ptx = nx;
    pty = ny;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      pdiff[c] = pd[c];
      pweight[c] = pw[c];
    }
    mares = mares_n;
    dpsq_init = dpsq_init_n;
    cnt = cnt_n;
    conv = reset || !keep_going || oob_start;
  }

  GNOut<C> out;
  out.p0 = p0;
  out.p1 = p1;
  out.ptx = ptx;
  out.pty = pty;
#pragma unroll
  for (int c = 0; c < C; ++c) out.pweight[c] = pweight[c];
  out.conv = conv;
  out.cnt = cnt;
  return out;
}

}  // namespace gnm
