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
// 30 MB; < 0.1 ms at 3.35 TB/s).  The design: one block per patch (psz^2
// threads rounded up to whole warps, 160 at psz 12), the window in shared
// memory (26 x 26 x C floats, <= 8.1 KB), templates and residuals in
// registers, fixed-order warp-shuffle reductions, so blocks are small and
// many fit on each SM to hide the reductions' latency.

#include <cuda_runtime.h>
#include <math.h>

#include "gn_machine.cuh"

namespace {

struct GNSearchParams {
  const float* tmp;    // (N, psz, psz, C) templates (mean-normalised if patch_norm)
  const float* dx;     // (N, psz, psz, C) x-gradients
  const float* dy;     // (N, psz, psz, C) y-gradients
  const float* hes;    // (N, nop == 2 ? 3 : 1) [h00, h01, h11] / [h00], bumped
  const float* imb;    // (Hp, Wp, C) padded target image
  const float* ptref;  // (N, 2) patch centres (x, y)
  const float* pinit;  // (N, nop) initial displacement
  float* p_out;        // (N, nop)
  float* pt_out;       // (N, 2)
  float* pw_out;       // (N, psz, psz, C)
  int* conv_out;       // (N,)
  int* iters_out;      // (N,) GN iterations run
  gnm::GNConsts k;
};

template <int PSZ, int C, int NOP>
__global__ void __launch_bounds__(((PSZ * PSZ + 31) / 32) * 32)
gn_search_kernel(const GNSearchParams P) {
  constexpr int NPIX = PSZ * PSZ;
  constexpr int NT = ((NPIX + 31) / 32) * 32;
  constexpr int NW = NT / 32;
  constexpr int S = 2 * PSZ + 2;
  __shared__ float win[C][S][S];
  __shared__ float red[3 * NW];

  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const bool has_px = t < NPIX;
  const size_t base = (size_t(n) * NPIX + t) * C;  // this thread's pixel, channel 0

  float T[C], DX[C], DY[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    T[c] = has_px ? P.tmp[base + c] : 0.f;
    DX[c] = has_px ? P.dx[base + c] : 0.f;
    DY[c] = has_px ? P.dy[base + c] : 0.f;
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
  float tn = 0.f;
  if (P.k.cost == 10) {
    float v[1] = {0.f};
#pragma unroll
    for (int c = 0; c < C; ++c) v[0] += T[c] * T[c];
    gnm::block_sum<NW, 1>(v, red);
    tn = sqrtf(v[0]);
  }

  const float prx = P.ptref[2 * n], pry = P.ptref[2 * n + 1];
  const float pin0 = P.pinit[NOP * n];
  const float pin1 = NOP == 2 ? P.pinit[NOP * n + 1] : 0.f;
  const gnm::GNOut<C> r = gnm::gn_machine<PSZ, C, NOP>(
      P.k, P.imb, T, DX, DY, h00, h01, h11, det, tn, prx, pry, pin0, pin1, win, red);

  if (has_px) {
#pragma unroll
    for (int c = 0; c < C; ++c) P.pw_out[base + c] = r.pweight[c];
  }
  if (t == 0) {
    P.p_out[NOP * n] = r.p0;
    if (NOP == 2) P.p_out[NOP * n + 1] = r.p1;
    P.pt_out[2 * n] = r.ptx;
    P.pt_out[2 * n + 1] = r.pty;
    P.conv_out[n] = r.conv ? 1 : 0;
    P.iters_out[n] = r.cnt;
  }
}

template <int PSZ, int C, int NOP>
cudaError_t launch(const GNSearchParams& P, cudaStream_t stream) {
  constexpr int NT = ((PSZ * PSZ + 31) / 32) * 32;
  gn_search_kernel<PSZ, C, NOP><<<P.k.n, NT, 0, stream>>>(P);
  return cudaGetLastError();
}

template <int PSZ>
cudaError_t dispatch_c_nop(const GNSearchParams& P, int c, int nop, cudaStream_t s) {
  if (c == 1 && nop == 2) return launch<PSZ, 1, 2>(P, s);
  if (c == 3 && nop == 2) return launch<PSZ, 3, 2>(P, s);
  if (c == 1 && nop == 1) return launch<PSZ, 1, 1>(P, s);
  if (c == 3 && nop == 1) return launch<PSZ, 3, 1>(P, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper
// (ops/kernels.py::gn_search) has checked shapes, types and devices.
extern "C" int gn_search_launch(
    const float* tmp, const float* dx, const float* dy, const float* hes, const float* imb,
    const float* ptref, const float* pinit,
    float* p_out, float* pt_out, float* pw_out, int* conv_out, int* iters_out,
    int n, int hp, int wp, int c, int psz, int nop, int pad, int w, int h,
    int sy, int sx, int max_iter, int min_iter, int cost, int patch_norm,
    int stereo_clamp, float normoutlier, float dp_thresh_sq, float dr_thresh,
    float res_thresh, float outlier_sq, float minerrval, void* stream) {
  if (n <= 0 || sy > 2 * psz + 2 || sx > 2 * psz + 2) return int(cudaErrorInvalidValue);
  GNSearchParams P{tmp, dx, dy, hes, imb, ptref, pinit, p_out, pt_out, pw_out, conv_out,
                   iters_out,
                   {n, hp, wp, pad, w, h, sy, sx, max_iter, min_iter, cost, patch_norm,
                    stereo_clamp, normoutlier, dp_thresh_sq, dr_thresh, res_thresh,
                    outlier_sq, minerrval}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (psz == 8) e = dispatch_c_nop<8>(P, c, nop, s);
  else if (psz == 12) e = dispatch_c_nop<12>(P, c, nop, s);
  else e = cudaErrorInvalidValue;
  return int(e);
}
