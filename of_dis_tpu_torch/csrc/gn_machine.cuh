// gn_machine.cuh — the inverse-compositional Gauss-Newton state machine of
// one patch (PatClass::OptimizeStart / OptimizeIter / OptimizeComputeErrImg,
// patch.cpp:119-284), shared by level_search.cu (templates extracted in the
// kernel) and gn_search.cu (templates built beforehand).  It is the CUDA
// counterpart of of_dis_tpu/ops/pallas_kernels.py::_gn_machine, which the
// TPU kernels _level_kernel, _gn_kernel and _gn_kernel_tiled share.
//
// The machine is written once, over a layout that says how a patch's psz^2
// pixels lie over threads:
//   BlockLayout  one block per patch, one pixel per thread (psz^2 threads
//                rounded up to whole warps); level_search.cu.
//   WarpLayout   one warp per patch, lane l holding the pixels l + 32 q for
//                q < NW = ceil(psz^2 / 32); gn_search.cu.
// Slots past psz^2 hold zeros and take part in every reduction.  The
// machine loads the patch's (sy, sx, C) search window of the padded target
// image into shared memory at the clipped window base (inverse_search.py
// :303-308), then runs max_iter + 1 trips: bilinear extraction from the
// window (taps outside it read 0), mean normalisation, the costs L2 / L1 /
// pseudo-Huber / NCC, the 2x2 (or 1x1) solve, the outlier / out-of-bounds
// reset, the stereo sign clamp and the reference's convergence predicate.
//
// Both layouts sum a patch in one order: per pixel the channels in order,
// then a 32-pixel butterfly (pairs l, l ^ 16 first) over each group of 32
// pixels, then the groups added in order q = 0 .. NW-1.  So every thread
// holds the same per-patch scalars, the trip loop is uniform across the
// patch's threads, `converged` never splits a barrier or a warp, and the
// results are bit-reproducible and equal to the plain version's
// (models/inverse_search.py::_patch_sum).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gnm {

struct GNConsts {
  int n, hp, wp, pad, w, h, sy, sx;
  int max_iter, min_iter, cost, patch_norm, stereo_clamp;  // clamp: -1 none, 0 min(p,0), 1 max(p,0)
  float normoutlier, dp_thresh_sq, dr_thresh, res_thresh, outlier_sq, minerrval;
};

__host__ __device__ constexpr int ceil_groups(int npix) { return (npix + 31) / 32; }
__host__ __device__ constexpr int pow2_at_least(int m) { return m <= 1 ? 1 : 2 * pow2_at_least((m + 1) / 2); }

// One block per patch: thread t holds pixel t.  red: 3 * NW floats of
// shared memory.  The window's row stride is its side.
template <int PSZ_>
struct BlockLayout {
  static constexpr int PSZ = PSZ_;
  static constexpr int NW = ceil_groups(PSZ * PSZ);  // warps per patch
  static constexpr int THREADS = 32 * NW;            // threads per patch
  static constexpr int NP = 1;                       // pixels per thread
  static constexpr int RS = 2 * PSZ + 2;             // window row stride
  float* red;

  __device__ int rank() const { return threadIdx.x; }
  __device__ int pixel(int) const { return threadIdx.x; }
  __device__ void sync() const { __syncthreads(); }

  // Sums of K values over the block; every thread receives the totals.
  // Warp butterfly, then lane 0 of each warp stores its partial and every
  // thread adds the partials in warp order.
  template <int K>
  __device__ void sum(const float (&v)[K][NP], float (&s)[K]) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x = v[k][0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) red[k * NW + warp] = x;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x = red[k * NW];
#pragma unroll
      for (int q = 1; q < NW; ++q) x += red[k * NW + q];
      s[k] = x;
    }
    __syncthreads();  // red is reused by the next reduction
  }
};

// The five shuffle steps (OFF = 16 .. 1) of WarpLayout::sum over the LIVE
// partials each lane holds; each step's count is a compile-time constant,
// so the partials stay in registers.
template <int LIVE, int OFF, int N>
__device__ __forceinline__ void scatter_steps(float (&a)[N], int lane) {
  if constexpr (OFF > 0) {
    if constexpr (LIVE > 1) {
      const bool hi = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < LIVE / 2; ++i) {
        const float keep = hi ? a[i + LIVE / 2] : a[i];
        const float send = hi ? a[i] : a[i + LIVE / 2];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      scatter_steps<LIVE / 2, OFF / 2>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], OFF);
      scatter_steps<1, OFF / 2>(a, lane);
    }
  }
}

// One warp per patch: lane l holds pixels l + 32 q.  The window's row
// stride is the smallest >= its side that is congruent to psz mod 32, so
// the 32 lanes' taps (pixel t at row t / psz, column t % psz) fall on 32
// distinct banks.
template <int PSZ_>
struct WarpLayout {
  static constexpr int PSZ = PSZ_;
  static constexpr int NP = ceil_groups(PSZ * PSZ);  // pixels per lane (32-pixel groups)
  static constexpr int THREADS = 32;                 // threads per patch
  static constexpr int RS = 2 * PSZ + 2 + ((PSZ - (2 * PSZ + 2)) % 32 + 32) % 32;
  int lane;

  __device__ int rank() const { return lane; }
  __device__ int pixel(int q) const { return lane + 32 * q; }
  __device__ void sync() const { __syncwarp(); }

  // Sums of K values over the warp's NP groups; every lane receives the
  // totals.  A reduce-scatter: while a lane holds more than one partial it
  // keeps half and sends its partner the other half, so each shuffle
  // carries a partial that is needed, and after the five steps lane
  // 32 / MP * g holds group g's total.  Each tree node adds the same two
  // operands as the butterfly (own + partner, and a + b == b + a), so the
  // totals are bit-equal to BlockLayout's.  Then the groups are added in
  // order.  Shuffles per call: MP - 1 + 5 - log2(MP) + K * NP with MP the
  // power of two >= K * NP (31 instead of 75 at psz 12, K = 3).
  template <int K>
  __device__ void sum(const float (&v)[K][NP], float (&s)[K]) const {
    constexpr int M = K * NP;
    constexpr int MP = pow2_at_least(M);
    static_assert(MP <= 32, "at most 32 partials per reduction");
    float a[MP];
#pragma unroll
    for (int m = 0; m < MP; ++m) a[m] = m < M ? v[m / NP][m % NP] : 0.f;
    scatter_steps<MP, 16>(a, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x = __shfl_sync(0xffffffffu, a[0], (k * NP) * (32 / MP));
#pragma unroll
      for (int q = 1; q < NP; ++q) x += __shfl_sync(0xffffffffu, a[0], (k * NP + q) * (32 / MP));
      s[k] = x;
    }
  }
};

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
template <int NP, int C>
struct GNOut {
  float p0, p1, ptx, pty;
  float pweight[NP][C];  // |residual| of this thread's patch pixels
  bool conv;
  int cnt;               // GN iterations run
};

// The templates of this thread's pixels (T, DX, DY per pixel and channel),
// the patch's Hessian (h00, h01, h11; det; with the 1e-10 bump already
// applied), the template norm tn (cost 10 only), the static centre (prx,
// pry) and the start displacement (pin0, pin1).  win is the patch's window
// in shared memory, C * (2 psz + 2) rows of L::RS floats.
template <class L, int C, int NOP>
__device__ __forceinline__ GNOut<L::NP, C> gn_machine(
    const L& lay, const GNConsts& P, const float* __restrict__ imb,
    const float (&T)[L::NP][C], const float (&DX)[L::NP][C], const float (&DY)[L::NP][C],
    float h00, float h01, float h11, float det, float tn, float prx, float pry, float pin0,
    float pin1, float* win) {
  constexpr int PSZ = L::PSZ;
  constexpr int NP = L::NP;
  constexpr int NPIX = PSZ * PSZ;
  constexpr int S = 2 * PSZ + 2;
  constexpr int RS = L::RS;
  constexpr int LB = -(PSZ / 2);
  const float novals = float(C * NPIX);
  const int sy = P.sy, sx = P.sx, wp = P.wp;
  bool has_px[NP];
  int poff[NP];  // window offset of each pixel (row * RS + column; 0 past psz^2)
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const int t = lay.pixel(q);
    has_px[q] = t < NPIX;
    poff[q] = has_px[q] ? (t / PSZ) * RS + t % PSZ : 0;
  }

  // ---- start position, window base and window (OptimizeStart) ----
  const float stx = prx + pin0;
  const float sty = NOP == 2 ? pry + pin1 : pry;
  const bool oob0 = out_of_bounds(stx, sty, P.w, P.h, PSZ);
  const int by = min(max(int(floorf(sty)) + LB - PSZ / 2 + P.pad, 0), P.hp - sy);
  const int bx = min(max(int(floorf(stx)) + LB - PSZ / 2 + P.pad, 0), wp - sx);
  for (int k = lay.rank(); k < sy * sx * C; k += L::THREADS) {
    const int yy = k / (sx * C);
    const int rem = k - yy * sx * C;
    const int xx = rem / C;
    const int c = rem - xx * C;
    win[(c * S + yy) * RS + xx] = imb[((by + yy) * wp + bx) * C + rem];
  }
  lay.sync();

  // ---- GN state machine (patch.cpp:119-284) ----
  // pweight is |pdiff| on every path, so only pdiff is kept.  jb = J^T pdiff
  // (patch.cpp:176-184) for the next trip is summed in one reduction with
  // that trip's mares: two dependent reductions per trip, not three.
  float p0 = pin0, p1 = pin1, ptx = stx, pty = sty;
  float pdiff[NP][C];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
#pragma unroll
    for (int c = 0; c < C; ++c) pdiff[q][c] = 0.f;
  }
  float jb0 = 0.f, jb1 = 0.f;
  float mares = 1e5f, dpsq_init = 1e-10f;
  int cnt = 0;
  bool conv = false;

  for (int trip = 0; trip <= P.max_iter; ++trip) {
    if (conv) break;  // uniform over the patch's threads: a converged patch is frozen
    const bool first = trip == 0;
    const int cnt_n = first ? 0 : cnt + 1;

    // delta_p = H^-1 (J^T pdiff) (patch.cpp:176-184)
    float d0 = 0.f, d1 = 0.f;
    if (!first) {
      if (NOP == 2) {
        d0 = (h11 * jb0 - h01 * jb1) / det;
        d1 = (h00 * jb1 - h01 * jb0) / det;
      } else {
        d0 = jb0 / h00;
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
    float pd[NP][C];
    float mares_n = 1e5f;
    if (oob_start) {
      // pdiff = template (patch.cpp:139); pweight = |loss(template)|
#pragma unroll
      for (int q = 0; q < NP; ++q) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          pd[q][c] = P.cost == 10 ? T[q][c] : loss_pd(T[q][c], P.cost, P.normoutlier);
      }
    } else {
      const float fy = floorf(ny), fx = floorf(nx);
      const float ry = ny - fy, rx = nx - fx;
      const int oy = int(fy) + LB + P.pad - by;  // window row of the patch's first tap
      const int ox = int(fx) + LB + P.pad - bx;
      // blend rows, then columns; taps outside the window read 0
      auto blend = [&](float w00, float w10, float w01, float w11) {
        const float col0 = (1.f - ry) * w00 + ry * w10;
        const float col1 = (1.f - ry) * w01 + ry * w11;
        return (1.f - rx) * col0 + rx * col1;
      };
      float raw[NP][C];
      float v[1][NP];
      if (oy >= 0 && ox >= 0 && oy + PSZ < sy && ox + PSZ < sx) {
        // every tap of the patch lies in the window (uniform over the patch)
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          v[0][q] = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float* w0 = win + (c * S + oy) * RS + ox + poff[q];
            raw[q][c] = has_px[q] ? blend(w0[0], w0[RS], w0[1], w0[RS + 1]) : 0.f;
            v[0][q] += raw[q][c];
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const int t = lay.pixel(q);
          const int y0 = oy + t / PSZ;
          const int x0 = ox + t % PSZ;
          const bool iy0 = y0 >= 0 && y0 < sy, iy1 = y0 + 1 >= 0 && y0 + 1 < sy;
          const bool ix0 = x0 >= 0 && x0 < sx, ix1 = x0 + 1 >= 0 && x0 + 1 < sx;
          v[0][q] = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float* w0 = win + (c * S + y0) * RS + x0;
            const float w00 = (iy0 && ix0) ? w0[0] : 0.f;
            const float w10 = (iy1 && ix0) ? w0[RS] : 0.f;
            const float w01 = (iy0 && ix1) ? w0[1] : 0.f;
            const float w11 = (iy1 && ix1) ? w0[RS + 1] : 0.f;
            raw[q][c] = has_px[q] ? blend(w00, w10, w01, w11) : 0.f;
            v[0][q] += raw[q][c];
          }
        }
      }
      if (P.patch_norm) {
        float b[1];
        lay.template sum<1>(v, b);
        const float mean = b[0] / novals;
#pragma unroll
        for (int q = 0; q < NP; ++q) {
#pragma unroll
          for (int c = 0; c < C; ++c) raw[q][c] = has_px[q] ? raw[q][c] - mean : 0.f;
        }
      }
      if (P.cost == 10) {
        float sq[1][NP], b[1];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          sq[0][q] = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) sq[0][q] += raw[q][c] * raw[q][c];
        }
        lay.template sum<1>(sq, b);
        const float scale = tn / fmaxf(sqrtf(b[0]), 1e-10f);
#pragma unroll
        for (int q = 0; q < NP; ++q) {
#pragma unroll
          for (int c = 0; c < C; ++c) pd[q][c] = raw[q][c] * scale - T[q][c];
        }
      } else {
#pragma unroll
        for (int q = 0; q < NP; ++q) {
#pragma unroll
          for (int c = 0; c < C; ++c) pd[q][c] = loss_pd(raw[q][c] - T[q][c], P.cost, P.normoutlier);
        }
      }
      // mares, and J^T pdiff for the next trip
      float m[1 + NOP][NP], b[1 + NOP];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        m[0][q] = 0.f;
        m[1][q] = 0.f;
        if (NOP == 2) m[NOP][q] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          m[0][q] += has_px[q] ? fabsf(pd[q][c]) : 0.f;
          m[1][q] += DX[q][c] * pd[q][c];
          if (NOP == 2) m[NOP][q] += DY[q][c] * pd[q][c];
        }
      }
      lay.template sum<1 + NOP>(m, b);
      mares_n = b[0] / novals;
      jb0 = b[1];
      jb1 = b[NOP];
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
    for (int q = 0; q < NP; ++q) {
#pragma unroll
      for (int c = 0; c < C; ++c) pdiff[q][c] = pd[q][c];
    }
    mares = mares_n;
    dpsq_init = dpsq_init_n;
    cnt = cnt_n;
    conv = reset || !keep_going || oob_start;
  }

  GNOut<NP, C> out;
  out.p0 = p0;
  out.p1 = p1;
  out.ptx = ptx;
  out.pty = pty;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
#pragma unroll
    for (int c = 0; c < C; ++c) out.pweight[q][c] = fabsf(pdiff[q][c]);
  }
  out.conv = conv;
  out.cnt = cnt;
  return out;
}

}  // namespace gnm
