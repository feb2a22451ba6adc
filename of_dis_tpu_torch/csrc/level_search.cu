// level_search.cu — whole-level inverse-compositional Gauss-Newton patch
// search for one pyramid level of a batch of image pairs (DIS step 3).
//
// Replaces of_dis_tpu/ops/pallas_kernels.py::_level_kernel (with
// _gn_machine, _fetch_windows and _row_onehot), launched there by
// level_search_pallas.  It computes the same function as that kernel with
// inline templates, and as the plain PyTorch loop
// of_dis_tpu_torch/models/inverse_search.py::level_search_reference:
//   template extraction at the static patch centres + Hessian (1e-10
//   diagonal bump when det == 0), then the GN machine of gn_machine.cuh
//   (window bases, the (sy, sx, C) search window of the target image,
//   max_iter + 1 trips), and the densification weights
//   absw = 1 / sum_c max(minerrval, |pdiff|).
// gn_search.cu runs the same machine on templates built beforehand.
//
// What bounds it on an H100: latency.  One op2 level moves < 0.3 MB and
// does ~1e7 FP32 operations, far below a microsecond of bandwidth or
// arithmetic, and holds only tens to a few hundred patches, so the card is
// nearly empty and each patch's chain of 13-17 dependent GN trips sets the
// time.  The design is gn_search.cu's: one warp per patch (gn_machine.cuh's
// WarpLayout, lane l holds pixels l + 32 q), so every reduction is warp
// shuffles only, with no block barrier and no shared-memory step; WARPS
// warps share a block, each with its search window in shared memory (loaded
// once, at a row stride that keeps the bilinear taps on 32 distinct banks);
// templates and residuals in registers; every sum in the plain version's
// fixed order, so results are bit-reproducible and equal to it.  The TPU
// kernel's one-hot MXU row fetch, column block-select, roll-blend extraction
// and 128-lane patch padding exist only for the TPU and are not carried over.

#include <cuda_runtime.h>
#include <math.h>

#include "gn_machine.cuh"

namespace {

struct LevelParams {
  const float* ima;    // (B, Hp, Wp, C) padded reference images
  const float* dxa;    // (B, Hp, Wp, C) their x-gradients
  const float* dya;    // (B, Hp, Wp, C) their y-gradients
  const float* imb;    // (B, Hp, Wp, C) padded target images
  const float* ptref;  // (N, 2) patch centres (x, y), shared by the pairs
  const float* pinit;  // (B, N, nop) initial displacement
  float* p_out;        // (B, N, nop)
  float* pt_out;       // (B, N, 2)
  float* absw_out;     // (B, N, psz*psz), k = y*psz + x
  int* conv_out;       // (B, N)
  int* iters_out;      // (B, N) GN iterations run
  gnm::GNConsts k;
};

using gnm::WARPS;

template <int PSZ, int C, int NOP>
__global__ void __launch_bounds__(32 * WARPS)
level_search_kernel(const LevelParams P) {
  using L = gnm::WarpLayout<PSZ>;
  constexpr int NP = L::NP;
  constexpr int NPIX = PSZ * PSZ;
  constexpr int LB = -(PSZ / 2);
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  float* win = smem + warp * gnm::window_floats<PSZ, C>();
  const L lay{int(threadIdx.x & 31)};
  const float novals = float(C * NPIX);
  const int wp = P.k.wp;

  const int total = P.k.n * P.k.pairs;
  for (int n = blockIdx.x * WARPS + warp; n < total; n += gridDim.x * WARPS) {
    // n indexes the batch's patches and their outputs; at is the pair and
    // the grid patch (pt_ref) it stands for
    const gnm::PatchOf at = gnm::patch_of<C>(P.k, n);
    const float* ima = P.ima + at.image;
    const float* dxa = P.dxa + at.image;
    const float* dya = P.dya + at.image;
    // ---- templates at the static centres (patch.cpp:57-88) ----
    const float prx = P.ptref[2 * at.n], pry = P.ptref[2 * at.n + 1];
    int cy = int(floorf(pry + 0.5f)) + P.k.pad + LB;
    int cx = int(floorf(prx + 0.5f)) + P.k.pad + LB;
    cy = min(max(cy, 0), P.k.hp - PSZ);
    cx = min(max(cx, 0), wp - PSZ);
    float T[NP][C], DX[NP][C], DY[NP][C];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int t = lay.pixel(q);
      const bool has_px = t < NPIX;
      const int base = has_px ? ((cy + t / PSZ) * wp + cx + t % PSZ) * C : 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        T[q][c] = has_px ? ima[base + c] : 0.f;
        DX[q][c] = has_px ? dxa[base + c] : 0.f;
        DY[q][c] = has_px ? dya[base + c] : 0.f;
      }
    }
    const float pin0 = P.pinit[NOP * n];
    const float pin1 = NOP == 2 ? P.pinit[NOP * n + 1] : 0.f;
    const gnm::Start st =
        gnm::load_window<PSZ, C, NOP>(lay, P.k, P.imb + at.image, prx, pry, pin0, pin1, win);

    // The template sum (for its mean, patch.cpp:330-331) and the Hessian in
    // one reduction: each total is the same tree of the same operands as
    // when summed alone.
    float h00, h01 = 0.f, h11 = 0.f, det = 0.f;
    {
      float v[4][NP], s[4];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        v[0][q] = v[1][q] = v[2][q] = v[3][q] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          v[0][q] += DX[q][c] * DX[q][c];
          v[1][q] += DX[q][c] * DY[q][c];
          v[2][q] += DY[q][c] * DY[q][c];
          v[3][q] += T[q][c];
        }
      }
      lay.template sum<4>(v, s);
      if (P.k.patch_norm) {
        const float mean = s[3] / novals;
#pragma unroll
        for (int q = 0; q < NP; ++q) {
#pragma unroll
          for (int c = 0; c < C; ++c) T[q][c] = lay.pixel(q) < NPIX ? T[q][c] - mean : 0.f;
        }
      }
      h00 = s[0];
      if (NOP == 2) {
        h01 = s[1];
        h11 = s[2];
        const float bump = (h00 * h11 - h01 * h01 == 0.f) ? 1e-10f : 0.f;  // patch.cpp:78-82
        h00 += bump;
        h11 += bump;
        det = h00 * h11 - h01 * h01;
      } else if (h00 == 0.f) {
        h00 += 1e-10f;
      }
    }
    float tn = 0.f;
    if (P.k.cost == 10) {
      float v[1][NP], s[1];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        v[0][q] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) v[0][q] += T[q][c] * T[q][c];
      }
      lay.template sum<1>(v, s);
      tn = sqrtf(s[0]);
    }

    const gnm::GNOut<NP, C> r = gnm::gn_machine<PSZ, C, NOP>(
        lay, P.k, T, DX, DY, h00, h01, h11, det, tn, prx, pry, pin0, pin1, st, win);

    // ---- outputs; densification weights (patchgrid.cpp:253-260) ----
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int t = lay.pixel(q);
      if (t < NPIX) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) s += fmaxf(P.k.minerrval, r.pweight[q][c]);
        P.absw_out[size_t(n) * NPIX + t] = 1.f / s;
      }
    }
    if (lay.lane == 0) {
      P.p_out[NOP * n] = r.p0;
      if (NOP == 2) P.p_out[NOP * n + 1] = r.p1;
      P.pt_out[2 * n] = r.ptx;
      P.pt_out[2 * n + 1] = r.pty;
      P.conv_out[n] = r.conv ? 1 : 0;
      P.iters_out[n] = r.cnt;
    }
    __syncwarp();  // every lane is done with the window before the next patch loads it
  }
}

template <int PSZ, int C, int NOP>
struct Search {
  static cudaError_t run(const LevelParams* P, cudaStream_t stream) {
    static launch::PerDevice kept;
    return gnm::launch_search<PSZ, C>(level_search_kernel<PSZ, C, NOP>, kept, *P, stream);
  }
};

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper
// (ops/kernels.py::level_search) has checked shapes, types and devices.
extern "C" int level_search_launch(
    const float* ima, const float* dxa, const float* dya, const float* imb,
    const float* ptref, const float* pinit,
    float* p_out, float* pt_out, float* absw_out, int* conv_out, int* iters_out,
    int n, int pairs, int hp, int wp, int c, int psz, int nop, int pad, int w, int h,
    int sy, int sx, int max_iter, int min_iter, int cost, int patch_norm,
    int stereo_clamp, float normoutlier, float dp_thresh_sq, float dr_thresh,
    float res_thresh, float outlier_sq, float minerrval, void* stream) {
  if (n <= 0 || pairs <= 0 || (long long)n * pairs > 0x7fffffff || sy > 2 * psz + 2 ||
      sx > 2 * psz + 2)
    return int(cudaErrorInvalidValue);
  const LevelParams P{ima, dxa, dya, imb, ptref, pinit, p_out, pt_out, absw_out, conv_out,
                      iters_out,
                      {n, pairs, hp, wp, pad, w, h, sy, sx, max_iter, min_iter, cost, patch_norm,
                       stereo_clamp, normoutlier, dp_thresh_sq, dr_thresh, res_thresh,
                       outlier_sq, minerrval}};
  return int(gnm::dispatch<Search>(psz, c, nop, &P, static_cast<cudaStream_t>(stream)));
}
