// gn_search.cu — inverse-compositional Gauss-Newton patch search of one
// pyramid level over templates built beforehand (DIS step 3, the levels
// too large for the whole-level search).
//
// Replaces of_dis_tpu/ops/pallas_kernels.py::_gn_kernel (launched there by
// gn_search_pallas) and ::_gn_kernel_tiled (launched by _gn_search_tiled).
// The two TPU kernels differ only in how the patch axis is laid out over
// the TPU's (8, 128) tiles; on the card both are this one kernel.  It
// computes what they compute, and what the plain PyTorch loop
// of_dis_tpu_torch/models/inverse_search.py::gn_search_reference computes:
// the GN machine of gn_machine.cuh (shared with level_search.cu) on the
// templates T, DX, DY (N, psz, psz, C) and the Hessian (N, 3) for flow or
// (N, 1) for stereo that models/inverse_search.py::build_templates made.
// It returns p, pt, the residual weights pweight (N, psz, psz, C) and the
// convergence flag.
//
// Windows: the kernel gathers each patch's (sy, sx, C) window of the
// padded target image into shared memory itself, at the clipped bases of
// inverse_search.py:303-308.  The TPU path gathers every window into device
// memory first (ops/interp.py::gather_windows_rows); at op4's finest level
// (N = 51,300, psz 12) that would write 139 MB only to read it back.
//
// What bounds it on an H100: operations at the large levels.  At op4's
// level 0 each of 51,300 patches runs up to 129 trips over 144 pixels,
// ~3e10 FP32 operations (~0.5 ms at 67 TFLOP/s) against ~0.2 GB of
// device-memory traffic (templates 89 MB, windows read once, pweight
// 30 MB; < 0.1 ms at 3.35 TB/s).  In practice a trip is a chain of
// dependent patch reductions, so what limits it is their latency and the
// shuffle rate.  The design: one warp per patch (gn_machine.cuh's
// WarpLayout: lane l holds pixels l + 32 q), so a reduction is warp
// shuffles only, with no block barrier and no shared-memory step, and a
// slow patch holds nothing but its own warp.  WARPS warps share a block,
// each with its own window in shared memory (26 rows of 44 floats per
// channel at psz 12, a row stride that keeps the bilinear taps on 32
// distinct banks; a trip whose taps all lie in the window skips the
// per-tap bounds checks).  The grid holds as many blocks as fit on the card
// at once, and each warp takes patches warp_id, warp_id + total warps, ...
// until none is left.  Templates and residuals stay in registers.  A trip
// is then bound by the SM's instruction issue (several hundred
// instructions a warp-trip at psz 12: taps, two reductions, five IEEE
// divisions), not by resident warps: launch bounds that force more warps
// per SM did not make it faster.

#include <cuda_runtime.h>
#include <math.h>

#include "gn_machine.cuh"

namespace {

struct GNSearchParams {
  const float* tmp;    // (B, N, psz, psz, C) templates (mean-normalised if patch_norm)
  const float* dx;     // (B, N, psz, psz, C) x-gradients
  const float* dy;     // (B, N, psz, psz, C) y-gradients
  const float* hes;    // (B, N, nop == 2 ? 3 : 1) [h00, h01, h11] / [h00], bumped
  const float* imb;    // (B, Hp, Wp, C) padded target images
  const float* ptref;  // (N, 2) patch centres (x, y), shared by the pairs
  const float* pinit;  // (B, N, nop) initial displacement
  float* p_out;        // (B, N, nop)
  float* pt_out;       // (B, N, 2)
  float* pw_out;       // (B, N, psz, psz, C)
  int* conv_out;       // (B, N)
  int* iters_out;      // (B, N) GN iterations run
  gnm::GNConsts k;
};

using gnm::WARPS;

template <int PSZ, int C, int NOP>
__global__ void __launch_bounds__(32 * WARPS)
gn_search_kernel(const GNSearchParams P) {
  using L = gnm::WarpLayout<PSZ>;
  constexpr int NP = L::NP;
  constexpr int NPIX = PSZ * PSZ;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  float* win = smem + warp * gnm::window_floats<PSZ, C>();
  const L lay{int(threadIdx.x & 31)};

  const int total = P.k.n * P.k.pairs;
  for (int n = blockIdx.x * WARPS + warp; n < total; n += gridDim.x * WARPS) {
    // n indexes the batch's patches (templates, outputs); at is the pair
    // and the grid patch (pt_ref) it stands for
    const gnm::PatchOf at = gnm::patch_of<C>(P.k, n);
    float T[NP][C], DX[NP][C], DY[NP][C];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int t = lay.pixel(q);
      const bool has_px = t < NPIX;
      const size_t base = (size_t(n) * NPIX + t) * C;  // pixel t, channel 0
#pragma unroll
      for (int c = 0; c < C; ++c) {
        T[q][c] = has_px ? P.tmp[base + c] : 0.f;
        DX[q][c] = has_px ? P.dx[base + c] : 0.f;
        DY[q][c] = has_px ? P.dy[base + c] : 0.f;
      }
    }
    float h00, h01 = 0.f, h11 = 0.f, det = 0.f;
    if (NOP == 2) {
      h00 = P.hes[3 * n];
      h01 = P.hes[3 * n + 1];
      h11 = P.hes[3 * n + 2];
      det = h00 * h11 - h01 * h01;
    } else {
      h00 = P.hes[n];
    }
    const float prx = P.ptref[2 * at.n], pry = P.ptref[2 * at.n + 1];
    const float pin0 = P.pinit[NOP * n];
    const float pin1 = NOP == 2 ? P.pinit[NOP * n + 1] : 0.f;
    const gnm::Start st =
        gnm::load_window<PSZ, C, NOP>(lay, P.k, P.imb + at.image, prx, pry, pin0, pin1, win);
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

#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int t = lay.pixel(q);
      if (t < NPIX) {
#pragma unroll
        for (int c = 0; c < C; ++c) P.pw_out[(size_t(n) * NPIX + t) * C + c] = r.pweight[q][c];
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

// The kernel instance's launch, and its resident blocks per SM.
template <int PSZ, int C, int NOP>
struct Search {
  static launch::PerDevice& kept() {
    static launch::PerDevice k;
    return k;
  }
  static cudaError_t run(const GNSearchParams* P, cudaStream_t stream) {
    return gnm::launch_search<PSZ, C>(gn_search_kernel<PSZ, C, NOP>, kept(), *P, stream);
  }
};

template <int PSZ, int C, int NOP>
struct Occupancy {
  static cudaError_t run(int* blocks_per_sm) {
    return gnm::search_blocks_per_sm<PSZ, C>(gn_search_kernel<PSZ, C, NOP>,
                                             Search<PSZ, C, NOP>::kept(), blocks_per_sm);
  }
};

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper
// (ops/kernels.py::gn_search) has checked shapes, types and devices.
extern "C" int gn_search_launch(
    const float* tmp, const float* dx, const float* dy, const float* hes, const float* imb,
    const float* ptref, const float* pinit,
    float* p_out, float* pt_out, float* pw_out, int* conv_out, int* iters_out,
    int n, int pairs, int hp, int wp, int c, int psz, int nop, int pad, int w, int h,
    int sy, int sx, int max_iter, int min_iter, int cost, int patch_norm,
    int stereo_clamp, float normoutlier, float dp_thresh_sq, float dr_thresh,
    float res_thresh, float outlier_sq, float minerrval, void* stream) {
  if (n <= 0 || pairs <= 0 || (long long)n * pairs > 0x7fffffff || sy > 2 * psz + 2 ||
      sx > 2 * psz + 2)
    return int(cudaErrorInvalidValue);
  const GNSearchParams P{tmp, dx, dy, hes, imb, ptref, pinit, p_out, pt_out, pw_out, conv_out,
                         iters_out,
                         {n, pairs, hp, wp, pad, w, h, sy, sx, max_iter, min_iter, cost, patch_norm,
                          stereo_clamp, normoutlier, dp_thresh_sq, dr_thresh, res_thresh,
                          outlier_sq, minerrval}};
  return int(gnm::dispatch<Search>(psz, c, nop, &P, static_cast<cudaStream_t>(stream)));
}

// Blocks of the kernel for (psz, c, nop) that fit on one SM at once, and
// the warps (patches) per block; returns the cudaError_t (0 on success).
extern "C" int gn_search_occupancy(int psz, int c, int nop, int* blocks_per_sm,
                                   int* warps_per_block) {
  *warps_per_block = WARPS;
  return int(gnm::dispatch<Occupancy>(psz, c, nop, blocks_per_sm));
}
