// sor_rb.cu — red-black SOR on the 5-point TV system of one refinement
// level, `iterations` sweeps in one cooperative launch.  Templated on the
// number of fields:
//   NOP = 1  scalar SOR (stereo, sor_coupled_slow_but_readable_DE,
//            solver.c:428-466).  Replaces
//            of_dis_tpu/ops/pallas_kernels.py::_sor_scalar_kernel (launched
//            there by sor_scalar_rb_pallas), with its rounding:
//            A11 = a11 + up(wv) + left(wh) + wv + wh, inv = omega / A11,
//            du' = (1 - omega) du + inv (b1 + nb(du)).
//   NOP = 2  coupled SOR (solver.c:19-72): in each colour du first, then dv
//            with the new du.  Replaces ::_sor_coupled_kernel (launched by
//            sor_coupled_rb_pallas), with its rounding:
//            inv11 = omega / (a11 + (up(wv) + left(wh) + wv + wh)),
//            du' = (1 - omega) du + inv11 (b1 + nb(du) - a12 dv).
// Red is (x + y) % 2 == 0; shifts are zero-filled.  The plain versions are
// of_dis_tpu_torch/models/refine.py::sor_scalar_rb and ::sor_coupled_rb.
//
// What bounds it on an H100: barriers.  Every half-step reads neighbours
// that the half-step before wrote, anywhere in the level, so the level
// needs a barrier across the whole grid between half-steps (2 * iterations
// - 1 of them).  Stereo op2's levels hold at most 7,168 px: a launch moves
// < 0.2 MB and does ~1e6 FP32 operations, far below a microsecond of
// either.  The design is refine_inner.cu's: one cooperative kernel
// (cudaLaunchCooperativeKernel) with a grid no larger than the occupancy
// calculator allows on the card, grid-stride pixel loops and
// cooperative_groups grid.sync() between half-steps.  The first half-step
// reads the input field and writes every pixel of the output (the other
// colour copied), later half-steps update the output in place: a half-step
// writes only its colour and reads only the other.  It is right at every
// size up to 448 x 1024 and beyond (more pixels per thread); no atomics, so
// bit-reproducible.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sor_rb.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;

struct SorParams {
  const float *du_in, *dv_in;               // (h, w) start fields (dv_in: NOP 2)
  const float *a11, *a12, *a22, *b1, *b2;   // (h, w) system (a12, a22, b2: NOP 2)
  const float *wh, *wv;                     // (h, w) edge weights
  float *du, *dv;                           // (h, w) outputs (dv: NOP 2)
  int h, w, iterations;
  float omega;
};

template <int NOP>
__global__ void __launch_bounds__(THREADS) sor_rb_kernel(const SorParams P) {
  cg::grid_group grid = cg::this_grid();
  const int h = P.h, w = P.w, npx = h * w;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const float omega = P.omega;
  const float *wh = P.wh, *wv = P.wv;

  for (int sweep = 0; sweep < P.iterations; ++sweep) {
    for (int color = 0; color < 2; ++color) {
      const bool init = sweep == 0 && color == 0;
      const float* su = init ? P.du_in : P.du;
      const float* sv = init ? P.dv_in : P.dv;
      for (int k = first; k < npx; k += stride) {
        const int y = k / w, x = k - (k / w) * w;
        if (((x + y) & 1) == color) {
          const float up_wv = y > 0 ? wv[k - w] : 0.f;
          const float left_wh = x > 0 ? wh[k - 1] : 0.f;
          if (NOP == 1) {
            const float A11 = P.a11[k] + up_wv + left_wh + wv[k] + wh[k];
            const float inv = omega / A11;
            const float B1 = P.b1[k] + sor::nb(wh, wv, su, y, x, k, h, w);
            P.du[k] = (1.f - omega) * su[k] + inv * B1;
          } else {
            const float sum_dpsis = up_wv + left_wh + wv[k] + wh[k];
            float du_n, dv_n;
            sor::coupled_update(wh, wv, su, sv, P.b1[k], P.b2[k], P.a12[k],
                                omega / (P.a11[k] + sum_dpsis), omega / (P.a22[k] + sum_dpsis),
                                omega, y, x, k, h, w, du_n, dv_n);
            P.du[k] = du_n;
            P.dv[k] = dv_n;
          }
        } else if (init) {  // the other colour starts as the input
          P.du[k] = su[k];
          if (NOP == 2) P.dv[k] = sv[k];
        }
      }
      if (!(sweep == P.iterations - 1 && color == 1)) grid.sync();
    }
  }
}

template <int NOP>
cudaError_t launch(const SorParams& P, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sor_rb_kernel<NOP>, THREADS, 0);
  if (e != cudaSuccess) return e;
  const int need = (P.h * P.w + THREADS - 1) / THREADS;
  const int grid = min(need, per_sm * sms);
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  SorParams args = P;
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sor_rb_kernel<NOP>),
                                  dim3(grid), dim3(THREADS), kargs, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Each returns the cudaError_t of the launch (0 on success).  The wrappers
// (ops/kernels.py::sor_scalar, ::sor_coupled) have checked shapes, types
// and devices, and give outputs distinct from the inputs.
extern "C" int sor_scalar_launch(const float* du_in, const float* a11, const float* b1,
                                 const float* wh, const float* wv, float* du, int h, int w,
                                 int iterations, float omega, void* stream) {
  if (h < 1 || w < 1 || iterations < 1) return int(cudaErrorInvalidValue);
  SorParams P{du_in, nullptr, a11, nullptr, nullptr, b1, nullptr, wh, wv, du, nullptr,
              h, w, iterations, omega};
  return int(launch<1>(P, static_cast<cudaStream_t>(stream)));
}

extern "C" int sor_coupled_launch(const float* du_in, const float* dv_in, const float* a11,
                                  const float* a12, const float* a22, const float* b1,
                                  const float* b2, const float* wh, const float* wv, float* du,
                                  float* dv, int h, int w, int iterations, float omega,
                                  void* stream) {
  if (h < 1 || w < 1 || iterations < 1) return int(cudaErrorInvalidValue);
  SorParams P{du_in, dv_in, a11, a12, a22, b1, b2, wh, wv, du, dv, h, w, iterations, omega};
  return int(launch<2>(P, static_cast<cudaStream_t>(stream)));
}
