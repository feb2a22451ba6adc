// frame_io.cu — the entry's two full-resolution passes, run inside the
// entry's executable (models/dis.py::_dis_entry) around the padded pipeline:
//
//   frame_pad     both frames of B pairs, (B, H, W, C) in their own dtype
//                 (uint8 or float32), to float32 (2, B, Hp, Wp, C) with the
//                 divisibility padding replicated from the edges, floor(pad/2)
//                 before and ceil(pad/2) after (run_dense.cpp:298-311);
//   flow_upscale  the flow at scale sc_l, (B, Hp >> sc_l, Wp >> sc_l, nop),
//                 times 2^sc_l, resized to (Hp, Wp) by INTER_LINEAR with
//                 half-pixel centres and cropped by the padding
//                 (run_dense.cpp:406-414), written straight at (B, H, W, nop):
//                 only the cropped pixels are computed.
//
// They replace no TPU kernel: the JAX package pads, upscales and crops with
// XLA ops outside its jit.  Their plain versions are ops/pyramid.py::
// pad_to_divisible (after a conversion to float32) and models/dis.py::
// _upscale_crop, whose order of float32 operations flow_upscale keeps
// (built with --fmad=false): fy = (y + 0.5) * (in/out) - 0.5, floor and
// clamp, 1 - wx rounded on its own, top = a * (1 - wx) + b * wx, then
// top * (1 - wy) + bot * wy.  The conversion of a uint8 or float32 value to
// float32 is exact and the padding is a copy, so both give the plain
// versions' bits.
//
// What bounds them on an H100: bytes.  An op2 gray pair at 1024x436 reads
// 0.89 MB of uint8 frames and writes 3.67 MB of padded float32, then reads
// 0.06 MB of flow and writes 3.57 MB: about 0.08 ms for B = 32 at 3.35 TB/s,
// with a handful of operations per value.  So both stream: one launch each
// for all pairs (and both frames), a block per output row (a grid-stride
// loop above 65,535 rows), each thread's values contiguous in the row and
// stored together (16 bytes for frame_pad where the row allows; 2 nop floats
// for flow_upscale where the width is even), and the source row's index
// computed once per row.
// flow_upscale's taps come from a source 2^(2 sc_l) times smaller than its
// output, which stays in L1 and L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

int grid_rows(int rows) { return rows < MAX_GRID_Y ? rows : MAX_GRID_Y; }

// out row r (r = frame * B * Hp + pair * Hp + y, frame 0 for a, 1 for b)
// = the source row clamp(y - top, 0, H - 1) of that image, its columns
// clamp(x - left, 0, W - 1).  V consecutive floats of the row per thread:
// 4 (one 16-byte store) where Wp * C divides by 4, else 1.
template <typename T, int C, int V>
__global__ void __launch_bounds__(THREADS)
frame_pad_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out,
                 int pairs, int h, int w, int hp, int wp, int top, int left) {
  const int row_len = wp * C;
  const int k = (blockIdx.x * THREADS + threadIdx.x) * V;  // first float in the row
  if (k >= row_len) return;
  // the source column of each of this thread's values (the same in every row)
  int sx[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int e = k + q;
    const int x = e / C;
    sx[q] = min(max(x - left, 0), w - 1) * C + (e - x * C);
  }
  const int rows = 2 * pairs * hp;
  const size_t image = size_t(h) * w * C;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int img = r / hp;
    const int y = r - img * hp;
    const T* src = (img < pairs ? a + size_t(img) * image : b + size_t(img - pairs) * image)
                   + size_t(min(max(y - top, 0), h - 1)) * w * C;
    float* dst = out + size_t(r) * row_len + k;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(float(src[sx[0]]), float(src[sx[1]]),
                                                    float(src[sx[2]]), float(src[sx[3]]));
    } else {
      dst[0] = float(src[sx[0]]);
    }
  }
}

// out (B, h0, w0, NOP), row r = pair * h0 + i: the upscaled flow at the
// padded pixel (top + i, left + j), each tap scaled by 2^sc_l first (exact),
// as _upscale_crop scales the flow before resize_bilinear.  RESAMPLE false
// (sc_l == 0): the flow at that pixel, a crop.  PIX consecutive pixels per
// thread (2 where w0 is even: one 8- or 16-byte store), their taps and
// weights computed once for all the rows the thread writes.
template <int NOP, bool RESAMPLE, int PIX>
__global__ void __launch_bounds__(THREADS)
flow_upscale_kernel(const float* __restrict__ flow, float* __restrict__ out, int pairs,
                    int hl, int wl, int h0, int w0, int top, int left, float scale,
                    float ratio) {
  const int j = (blockIdx.x * THREADS + threadIdx.x) * PIX;
  if (j >= w0) return;
  int x0[PIX], x1[PIX];
  float wx[PIX], wx1[PIX];
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int x = left + j + q;
    x0[q] = x1[q] = x;
    wx[q] = 0.f;
    wx1[q] = 1.f;
    if constexpr (RESAMPLE) {
      const float fx = (float(x) + 0.5f) * ratio - 0.5f;
      x0[q] = int(fminf(fmaxf(floorf(fx), 0.f), float(wl - 1)));
      x1[q] = min(x0[q] + 1, wl - 1);
      wx[q] = fminf(fmaxf(fx - float(x0[q]), 0.f), 1.f);
      wx1[q] = 1.f - wx[q];
    }
  }
  const int rows = pairs * h0;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int pair = r / h0;
    const int y = top + (r - pair * h0);
    const float* src = flow + size_t(pair) * hl * wl * NOP;
    float* dst = out + (size_t(r) * w0 + j) * NOP;
    float v[PIX * NOP];
    if constexpr (!RESAMPLE) {
#pragma unroll
      for (int k = 0; k < PIX * NOP; ++k) v[k] = src[(size_t(y) * wl + x0[0]) * NOP + k];
    } else {
      const float fy = (float(y) + 0.5f) * ratio - 0.5f;
      const int y0 = int(fminf(fmaxf(floorf(fy), 0.f), float(hl - 1)));
      const int y1 = min(y0 + 1, hl - 1);
      const float wy = fminf(fmaxf(fy - float(y0), 0.f), 1.f);
      const float wy1 = 1.f - wy;
      const float* r0 = src + size_t(y0) * wl * NOP;
      const float* r1 = src + size_t(y1) * wl * NOP;
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
#pragma unroll
        for (int c = 0; c < NOP; ++c) {
          const float top_v = (r0[x0[q] * NOP + c] * scale) * wx1[q]
                              + (r0[x1[q] * NOP + c] * scale) * wx[q];
          const float bot_v = (r1[x0[q] * NOP + c] * scale) * wx1[q]
                              + (r1[x1[q] * NOP + c] * scale) * wx[q];
          v[q * NOP + c] = top_v * wy1 + bot_v * wy;
        }
      }
    }
    if constexpr (PIX * NOP == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (PIX * NOP == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    } else {
      dst[0] = v[0];
    }
  }
}

template <typename T, int C>
cudaError_t pad_as(const void* a, const void* b, float* out, int pairs, int h, int w, int hp,
                   int wp, int top, int left, cudaStream_t stream) {
  const int row_len = wp * C;
  const dim3 grid_4((row_len / 4 + THREADS - 1) / THREADS, grid_rows(2 * pairs * hp));
  const dim3 grid_1((row_len + THREADS - 1) / THREADS, grid_rows(2 * pairs * hp));
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (row_len % 4 == 0)
    frame_pad_kernel<T, C, 4><<<grid_4, THREADS, 0, stream>>>(ta, tb, out, pairs, h, w, hp, wp,
                                                              top, left);
  else
    frame_pad_kernel<T, C, 1><<<grid_1, THREADS, 0, stream>>>(ta, tb, out, pairs, h, w, hp, wp,
                                                              top, left);
  return cudaGetLastError();
}

// Rows of the output each block of flow_upscale writes (its grid-stride
// loop): the taps' columns are computed once for them.
constexpr int UPSCALE_ROWS = 4;

template <int NOP, bool RESAMPLE, int PIX>
cudaError_t upscale_with(const float* flow, float* out, int pairs, int hl, int wl, int sc,
                         int h0, int w0, int top, int left, cudaStream_t stream) {
  const int rows = pairs * h0;
  const dim3 grid((w0 / PIX + THREADS - 1) / THREADS,
                  grid_rows((rows + UPSCALE_ROWS - 1) / UPSCALE_ROWS));
  const float scale = float(1 << sc), ratio = 1.f / scale;
  flow_upscale_kernel<NOP, RESAMPLE, PIX><<<grid, THREADS, 0, stream>>>(
      flow, out, pairs, hl, wl, h0, w0, top, left, scale, ratio);
  return cudaGetLastError();
}

template <int NOP>
cudaError_t upscale_as(const float* flow, float* out, int pairs, int hl, int wl, int sc,
                       int h0, int w0, int top, int left, cudaStream_t stream) {
  if (sc == 0)
    return w0 % 2 ? upscale_with<NOP, false, 1>(flow, out, pairs, hl, wl, sc, h0, w0, top, left,
                                                stream)
                  : upscale_with<NOP, false, 2>(flow, out, pairs, hl, wl, sc, h0, w0, top, left,
                                                stream);
  return w0 % 2 ? upscale_with<NOP, true, 1>(flow, out, pairs, hl, wl, sc, h0, w0, top, left,
                                             stream)
                : upscale_with<NOP, true, 2>(flow, out, pairs, hl, wl, sc, h0, w0, top, left,
                                             stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype 0: uint8
// frames, 1: float32.  The wrapper (ops/kernels.py::frame_pad) has checked
// shapes, types and devices; out is (2, pairs, hp, wp, c) float32.
extern "C" int frame_pad_launch(const void* a, const void* b, float* out, int dtype, int pairs,
                                int h, int w, int c, int hp, int wp, int top, int left,
                                void* stream) {
  if (pairs <= 0 || h <= 0 || w <= 0 || hp < h || wp < w || (c != 1 && c != 3) ||
      (dtype != 0 && dtype != 1) || 2LL * pairs * hp > 0x7fffffffLL ||
      (long long)wp * c > 0x7fffffffLL - THREADS * 4)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(c == 1 ? pad_as<uint8_t, 1>(a, b, out, pairs, h, w, hp, wp, top, left, s)
                      : pad_as<uint8_t, 3>(a, b, out, pairs, h, w, hp, wp, top, left, s));
  return int(c == 1 ? pad_as<float, 1>(a, b, out, pairs, h, w, hp, wp, top, left, s)
                    : pad_as<float, 3>(a, b, out, pairs, h, w, hp, wp, top, left, s));
}

// Returns the cudaError_t of the launch (0 on success).  flow is (pairs, hl,
// wl, nop) at scale sc of the padded frames (hl << sc rows); out is (pairs,
// h0, w0, nop), the padded frame's rows top .. top + h0 - 1 and columns
// left .. left + w0 - 1.  The wrapper (ops/kernels.py::flow_upscale) has
// checked shapes, types and devices.
extern "C" int flow_upscale_launch(const float* flow, float* out, int pairs, int hl, int wl,
                                   int nop, int sc, int h0, int w0, int top, int left,
                                   void* stream) {
  if (pairs <= 0 || h0 <= 0 || w0 <= 0 || (nop != 1 && nop != 2) || sc < 0 || sc > 20 ||
      (long long)pairs * h0 > 0x7fffffffLL || top < 0 || left < 0 ||
      top + h0 > (hl << sc) || left + w0 > (wl << sc))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(nop == 1 ? upscale_as<1>(flow, out, pairs, hl, wl, sc, h0, w0, top, left, s)
                      : upscale_as<2>(flow, out, pairs, hl, wl, sc, h0, w0, top, left, s));
}
