// level_search.cu — whole-level inverse-compositional Gauss-Newton patch
// search for one pyramid level of one image pair (DIS step 3).
//
// Replaces of_dis_tpu/ops/pallas_kernels.py::_level_kernel (with
// _gn_machine, _fetch_windows and _row_onehot), launched there by
// level_search_pallas.  It computes the same function as that kernel with
// inline templates, and as the plain PyTorch loop
// of_dis_tpu_torch/models/inverse_search.py::optimize_level:
//   template extraction at the static patch centres + Hessian (1e-10
//   diagonal bump when det == 0), then the GN machine of gn_machine.cuh
//   (window bases, the (sy, sx, C) search window of the target image,
//   max_iter + 1 trips), and the densification weights
//   absw = 1 / sum_c max(minerrval, |pdiff|).
// gn_search.cu runs the same machine on templates built beforehand.
//
// What bounds it on an H100: latency.  One op2 level moves < 0.3 MB and
// does ~1e7 FP32 operations, far below a microsecond of bandwidth or
// arithmetic; each GN trip is a chain of dependent block reductions.  The
// design keeps everything a patch touches on chip for the whole search:
// one block per patch (gn_machine.cuh's BlockLayout: psz^2 threads, one
// patch pixel per thread, rounded up to whole warps; gn_search.cu runs the
// same machine a warp per patch), the search window in shared memory (loaded once,
// coalesced along the image rows), templates and residuals in registers,
// and every reduction a warp-shuffle tree plus one shared-memory step in a
// fixed order, so results are bit-reproducible.  The TPU kernel's one-hot
// MXU row fetch, column block-select, roll-blend extraction and 128-lane
// patch padding exist only for the TPU and are not carried over.

#include <cuda_runtime.h>
#include <math.h>

#include "gn_machine.cuh"

namespace {

struct LevelParams {
  const float* ima;    // (Hp, Wp, C) padded reference image
  const float* dxa;    // (Hp, Wp, C) its x-gradient
  const float* dya;    // (Hp, Wp, C) its y-gradient
  const float* imb;    // (Hp, Wp, C) padded target image
  const float* ptref;  // (N, 2) patch centres (x, y)
  const float* pinit;  // (N, nop) initial displacement
  float* p_out;        // (N, nop)
  float* pt_out;       // (N, 2)
  float* absw_out;     // (N, psz*psz), k = y*psz + x
  int* conv_out;       // (N,)
  int* iters_out;      // (N,) GN iterations run
  gnm::GNConsts k;
};

template <int PSZ, int C, int NOP>
__global__ void __launch_bounds__(gnm::BlockLayout<PSZ>::THREADS)
level_search_kernel(const LevelParams P) {
  using L = gnm::BlockLayout<PSZ>;
  constexpr int NPIX = PSZ * PSZ;
  constexpr int S = 2 * PSZ + 2;
  constexpr int LB = -(PSZ / 2);
  __shared__ float win[C][S][S];
  __shared__ float red[3 * L::NW];
  const L lay{red};

  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const bool has_px = t < NPIX;
  const int j = t / PSZ;  // patch row
  const int i = t % PSZ;  // patch column
  const float novals = float(C * NPIX);
  const int wp = P.k.wp;

  // ---- templates at the static centres (patch.cpp:57-88) ----
  const float prx = P.ptref[2 * n], pry = P.ptref[2 * n + 1];
  int cy = int(floorf(pry + 0.5f)) + P.k.pad + LB;
  int cx = int(floorf(prx + 0.5f)) + P.k.pad + LB;
  cy = min(max(cy, 0), P.k.hp - PSZ);
  cx = min(max(cx, 0), wp - PSZ);
  float T[1][C], DX[1][C], DY[1][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int idx = ((cy + j) * wp + cx + i) * C + c;
    T[0][c] = has_px ? P.ima[idx] : 0.f;
    DX[0][c] = has_px ? P.dxa[idx] : 0.f;
    DY[0][c] = has_px ? P.dya[idx] : 0.f;
  }
  if (P.k.patch_norm) {  // patch.cpp:330-331
    float v[1][1] = {{0.f}}, s[1];
#pragma unroll
    for (int c = 0; c < C; ++c) v[0][0] += T[0][c];
    lay.template sum<1>(v, s);
    const float mean = s[0] / novals;
#pragma unroll
    for (int c = 0; c < C; ++c) T[0][c] = has_px ? T[0][c] - mean : 0.f;
  }
  float h00, h01 = 0.f, h11 = 0.f, det = 0.f;
  {
    float v[3][1] = {{0.f}, {0.f}, {0.f}}, s[3];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[0][0] += DX[0][c] * DX[0][c];
      v[1][0] += DX[0][c] * DY[0][c];
      v[2][0] += DY[0][c] * DY[0][c];
    }
    lay.template sum<3>(v, s);
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
    float v[1][1] = {{0.f}}, s[1];
#pragma unroll
    for (int c = 0; c < C; ++c) v[0][0] += T[0][c] * T[0][c];
    lay.template sum<1>(v, s);
    tn = sqrtf(s[0]);
  }

  const float pin0 = P.pinit[NOP * n];
  const float pin1 = NOP == 2 ? P.pinit[NOP * n + 1] : 0.f;
  const gnm::GNOut<1, C> r = gnm::gn_machine<L, C, NOP>(
      lay, P.k, P.imb, T, DX, DY, h00, h01, h11, det, tn, prx, pry, pin0, pin1, &win[0][0][0]);

  // ---- outputs; densification weights (patchgrid.cpp:253-260) ----
  if (has_px) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) s += fmaxf(P.k.minerrval, r.pweight[0][c]);
    P.absw_out[n * NPIX + t] = 1.f / s;
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
cudaError_t launch(const LevelParams& P, cudaStream_t stream) {
  level_search_kernel<PSZ, C, NOP><<<P.k.n, gnm::BlockLayout<PSZ>::THREADS, 0, stream>>>(P);
  return cudaGetLastError();
}

template <int PSZ>
cudaError_t dispatch_c_nop(const LevelParams& P, int c, int nop, cudaStream_t s) {
  if (c == 1 && nop == 2) return launch<PSZ, 1, 2>(P, s);
  if (c == 3 && nop == 2) return launch<PSZ, 3, 2>(P, s);
  if (c == 1 && nop == 1) return launch<PSZ, 1, 1>(P, s);
  if (c == 3 && nop == 1) return launch<PSZ, 3, 1>(P, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper
// (ops/kernels.py::level_search) has checked shapes, types and devices.
extern "C" int level_search_launch(
    const float* ima, const float* dxa, const float* dya, const float* imb,
    const float* ptref, const float* pinit,
    float* p_out, float* pt_out, float* absw_out, int* conv_out, int* iters_out,
    int n, int hp, int wp, int c, int psz, int nop, int pad, int w, int h,
    int sy, int sx, int max_iter, int min_iter, int cost, int patch_norm,
    int stereo_clamp, float normoutlier, float dp_thresh_sq, float dr_thresh,
    float res_thresh, float outlier_sq, float minerrval, void* stream) {
  if (n <= 0 || sy > 2 * psz + 2 || sx > 2 * psz + 2) return int(cudaErrorInvalidValue);
  LevelParams P{ima, dxa, dya, imb, ptref, pinit, p_out, pt_out, absw_out, conv_out,
                iters_out,
                {n, hp, wp, pad, w, h, sy, sx, max_iter, min_iter, cost, patch_norm,
                 stereo_clamp, normoutlier, dp_thresh_sq, dr_thresh, res_thresh, outlier_sq,
                 minerrval}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (psz == 8) e = dispatch_c_nop<8>(P, c, nop, s);
  else if (psz == 12) e = dispatch_c_nop<12>(P, c, nop, s);
  else e = cudaErrorInvalidValue;
  return int(e);
}
