// gn_machine.cuh — the inverse-compositional Gauss-Newton state machine of
// one patch (PatClass::OptimizeStart / OptimizeIter / OptimizeComputeErrImg,
// patch.cpp:119-284), shared by level_search.cu (templates extracted in the
// kernel) and gn_search.cu (templates built beforehand).  It is the CUDA
// counterpart of of_dis_tpu/ops/pallas_kernels.py::_gn_machine, which the
// TPU kernels _level_kernel, _gn_kernel and _gn_kernel_tiled share.
//
// Both kernels run one warp per patch (WarpLayout): lane l holds the patch
// pixels l + 32 q for q < NP = ceil(psz^2 / 32); slots past psz^2 hold zeros
// and take part in every reduction.  WARPS warps share a block, each with its
// own search window in shared memory, and each warp takes patches warp_id,
// warp_id + total warps, ... until none is left (launch_search below).  A
// launch searches a batch of image pairs: its patches are the pairs' N
// patches each, g = b * N + n (pair b, patch n of the level's grid), one
// flat axis over which the warps stride; a patch reads its pair's images
// and the shared centre pt_ref[n].
// load_window copies the patch's (sy, sx, C) search window of the padded
// target image into shared memory at the clipped window base
// (inverse_search.py:303-308); gn_machine then runs max_iter + 1 trips:
// bilinear extraction from the window (taps outside it read 0), mean
// normalisation, the costs L2 / L1 / pseudo-Huber / NCC, the 2x2 (or 1x1)
// solve, the outlier / out-of-bounds reset, the stereo sign clamp and the
// reference's convergence predicate.
//
// A patch is summed in one order: per pixel the channels in order, then a
// 32-pixel butterfly (pairs l, l ^ 16 first) over each group of 32 pixels,
// then the groups added in order q = 0 .. NP-1.  So every lane holds the
// same per-patch scalars, the trip loop is uniform across the warp,
// `converged` never splits it, and the results are bit-reproducible and
// equal to the plain version's (models/inverse_search.py::_patch_sum).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "launch.cuh"

namespace gnm {

struct GNConsts {
  int n, pairs;  // patches per pair (the level's grid), image pairs
  int hp, wp, pad, w, h, sy, sx;
  int max_iter, min_iter, cost, patch_norm, stereo_clamp;  // clamp: -1 none, 0 min(p,0), 1 max(p,0)
  float normoutlier, dp_thresh_sq, dr_thresh, res_thresh, outlier_sq, minerrval;
};

__host__ __device__ constexpr int ceil_groups(int npix) { return (npix + 31) / 32; }
__host__ __device__ constexpr int pow2_at_least(int m) { return m <= 1 ? 1 : 2 * pow2_at_least((m + 1) / 2); }

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
  static constexpr int RS = 2 * PSZ + 2 + ((PSZ - (2 * PSZ + 2)) % 32 + 32) % 32;
  int lane;

  __device__ int pixel(int q) const { return lane + 32 * q; }

  // Sums of K values over the warp's NP groups; every lane receives the
  // totals.  A reduce-scatter: while a lane holds more than one partial it
  // keeps half and sends its partner the other half, so each shuffle
  // carries a partial that is needed, and after the five steps lane
  // 32 / MP * g holds group g's total.  Each tree node adds the same two
  // operands as a butterfly (own + partner, and a + b == b + a), so the
  // totals are bit-equal to a butterfly's.  Then the groups are added in
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
  float pweight[NP][C];  // |residual| of this lane's patch pixels
  bool conv;
  int cnt;               // GN iterations run
};

// Where a patch starts (OptimizeStart) and the base of its search window.
struct Start {
  float stx, sty;
  int by, bx;  // window base in the padded image, clipped into it
  bool oob0;   // the start is out of bounds
};

// The start of the patch with static centre (prx, pry) and start
// displacement (pin0, pin1), and its (sy, sx, C) search window of the padded
// target image copied into win (C * (2 psz + 2) rows of WarpLayout::RS
// floats, channel-planar).  The copies are asynchronous (cp.async, global to
// shared without a register), issued back to back; gn_machine waits for them
// before its first trip.  A kernel issues its template loads before this
// call, so that the two memory latencies overlap.
template <int PSZ, int C, int NOP>
__device__ __forceinline__ Start load_window(const WarpLayout<PSZ>& lay, const GNConsts& P,
                                             const float* __restrict__ imb, float prx,
                                             float pry, float pin0, float pin1, float* win) {
  constexpr int S = 2 * PSZ + 2;
  constexpr int RS = WarpLayout<PSZ>::RS;
  constexpr int LB = -(PSZ / 2);
  const int sy = P.sy, sx = P.sx, wp = P.wp;
  Start st;
  st.stx = prx + pin0;
  st.sty = NOP == 2 ? pry + pin1 : pry;
  st.oob0 = out_of_bounds(st.stx, st.sty, P.w, P.h, PSZ);
  st.by = min(max(int(floorf(st.sty)) + LB - PSZ / 2 + P.pad, 0), P.hp - sy);
  st.bx = min(max(int(floorf(st.stx)) + LB - PSZ / 2 + P.pad, 0), wp - sx);
  // Lane l copies the window's floats l, l + 32, ...: row yy, float r of
  // the row (x = r / C, channel r % C), walked without a runtime division.
  const int row = sx * C;
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(win));
  const float* src = imb + (st.by * wp + st.bx) * C;
  int yy = lay.lane / row, r = lay.lane - yy * row;
  for (int k = lay.lane; k < sy * row; k += 32) {
    const int xx = r / C, c = r - xx * C;
    const unsigned dst = base + unsigned((c * S + yy) * RS + xx) * 4u;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src + yy * wp * C + r));
    r += 32;
    while (r >= row) {
      r -= row;
      ++yy;
    }
  }
  return st;
}

// The templates of this lane's pixels (T, DX, DY per pixel and channel),
// the patch's Hessian (h00, h01, h11; det; with the 1e-10 bump already
// applied), the template norm tn (cost 10 only), the static centre (prx,
// pry), the start displacement (pin0, pin1), and the start and window that
// load_window gave.
template <int PSZ, int C, int NOP>
__device__ __forceinline__ GNOut<WarpLayout<PSZ>::NP, C> gn_machine(
    const WarpLayout<PSZ>& lay, const GNConsts& P,
    const float (&T)[WarpLayout<PSZ>::NP][C], const float (&DX)[WarpLayout<PSZ>::NP][C],
    const float (&DY)[WarpLayout<PSZ>::NP][C],
    float h00, float h01, float h11, float det, float tn, float prx, float pry, float pin0,
    float pin1, const Start& st, const float* win) {
  using L = WarpLayout<PSZ>;
  constexpr int NP = L::NP;
  constexpr int NPIX = PSZ * PSZ;
  constexpr int S = 2 * PSZ + 2;
  constexpr int RS = L::RS;
  constexpr int LB = -(PSZ / 2);
  const float novals = float(C * NPIX);
  const int sy = P.sy, sx = P.sx;
  const float stx = st.stx, sty = st.sty;
  const int by = st.by, bx = st.bx;
  const bool oob0 = st.oob0;
  bool has_px[NP];
  int poff[NP];  // window offset of each pixel (row * RS + column; 0 past psz^2)
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const int t = lay.pixel(q);
    has_px[q] = t < NPIX;
    poff[q] = has_px[q] ? (t / PSZ) * RS + t % PSZ : 0;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // this lane's window copies
  __syncwarp();                                        // and every other lane's

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
    if (conv) break;  // uniform over the warp: a converged patch is frozen
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

// ---- launch plumbing of both search kernels ----

constexpr int WARPS = 4;  // patches (warps) per block

// Floats of one warp's search window: C * (2 psz + 2) rows of WarpLayout::RS.
template <int PSZ, int C>
__host__ __device__ constexpr int window_floats() {
  return C * (2 * PSZ + 2) * WarpLayout<PSZ>::RS;
}

template <int PSZ, int C>
constexpr size_t window_smem() {
  return WARPS * window_floats<PSZ, C>() * sizeof(float);
}

// Blocks of a search kernel for (psz, C) that fit on one SM at once, with
// its dynamic shared memory allowed, both once per device; `kept` is a
// static of the kernel instance's launcher.
template <int PSZ, int C, class Params>
cudaError_t search_blocks_per_sm(void (*kernel)(Params), launch::PerDevice& kept,
                                 int* per_sm) {
  return kept.get(per_sm, [&](int, int* v) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(window_smem<PSZ, C>()));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(v, kernel, 32 * WARPS,
                                                        window_smem<PSZ, C>());
    return e;
  });
}

// One launch of pairs * n patches: as many blocks as fit on the card at
// once, and no more than the patches need; each warp strides over the
// patches.
template <int PSZ, int C, class Params>
cudaError_t launch_search(void (*kernel)(Params), launch::PerDevice& kept, const Params& P,
                          cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t e = search_blocks_per_sm<PSZ, C>(kernel, kept, &per_sm);
  if (e == cudaSuccess) e = launch::sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long long total = (long long)P.k.n * P.k.pairs;
  const int grid = int(min((total + WARPS - 1) / WARPS, (long long)per_sm * sms));
  if (grid < 1) return cudaErrorInvalidConfiguration;
  kernel<<<grid, 32 * WARPS, window_smem<PSZ, C>(), stream>>>(P);
  return cudaGetLastError();
}

// F<psz, c, nop>::run(a...) for the runtime (psz, c, nop).
template <template <int, int, int> class F, class... A>
cudaError_t dispatch(int psz, int c, int nop, A... a) {
  if (psz == 8 && c == 1 && nop == 2) return F<8, 1, 2>::run(a...);
  if (psz == 8 && c == 3 && nop == 2) return F<8, 3, 2>::run(a...);
  if (psz == 8 && c == 1 && nop == 1) return F<8, 1, 1>::run(a...);
  if (psz == 8 && c == 3 && nop == 1) return F<8, 3, 1>::run(a...);
  if (psz == 12 && c == 1 && nop == 2) return F<12, 1, 2>::run(a...);
  if (psz == 12 && c == 3 && nop == 2) return F<12, 3, 2>::run(a...);
  if (psz == 12 && c == 1 && nop == 1) return F<12, 1, 1>::run(a...);
  if (psz == 12 && c == 3 && nop == 1) return F<12, 3, 1>::run(a...);
  return cudaErrorInvalidValue;
}

// Where patch g of a launch lies: its pair b, its patch n of the level's
// grid, and the offset of its pair's images (floats).
struct PatchOf {
  int b, n;
  size_t image;
};

template <int C>
__device__ __forceinline__ PatchOf patch_of(const GNConsts& k, int g) {
  PatchOf r;
  r.b = g / k.n;
  r.n = g - r.b * k.n;
  r.image = size_t(r.b) * k.hp * k.wp * C;
  return r;
}

}  // namespace gnm
