// Host codecs of of_dis_tpu_torch: .flo and .pfm read / write, binary PNM
// read and OpenCV's fixed-point RGB -> gray, through a C ABI loaded with
// ctypes (of_dis_tpu_torch/native.py).  The port's own copy of the JAX
// package's csrc/ofdis_native.cpp: the byte layouts are the reference's
// SaveFlowFile / SavePFMFile (run_dense.cpp:16-81), and the NumPy code in
// of_dis_tpu_torch/io.py writes the same bytes.
//
// Built with the host compiler at first use (ops/build.py::build_host),
// never by nvcc: the .cpp suffix keeps it out of the *.cu glob.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

extern "C" {

// ---------------------------------------------------------------------------
// .flo codec (Middlebury): "PIEH" + int32 w,h + row-major float2
// ---------------------------------------------------------------------------

// Returns 0 on success. Writes (H, W, nc) float32 data.
int ofdis_write_flo(const char* path, const float* data, int32_t w, int32_t h,
                    int32_t nc) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int ok = 1;
  ok &= std::fwrite("PIEH", 1, 4, f) == 4;
  ok &= std::fwrite(&w, sizeof(int32_t), 1, f) == 1;
  ok &= std::fwrite(&h, sizeof(int32_t), 1, f) == 1;
  size_t n = (size_t)w * h * nc;
  ok &= std::fwrite(data, sizeof(float), n, f) == n;
  std::fclose(f);
  return ok ? 0 : -2;
}

// Reads header only; returns 0 and sets *w,*h on success.
int ofdis_flo_dims(const char* path, int32_t* w, int32_t* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char magic[4];
  int ok = std::fread(magic, 1, 4, f) == 4 && std::memcmp(magic, "PIEH", 4) == 0;
  ok = ok && std::fread(w, sizeof(int32_t), 1, f) == 1;
  ok = ok && std::fread(h, sizeof(int32_t), 1, f) == 1;
  std::fclose(f);
  return ok ? 0 : -2;
}

// Reads w*h*nc floats into out (caller allocates, dims from ofdis_flo_dims).
int ofdis_read_flo(const char* path, float* out, int32_t w, int32_t h,
                   int32_t nc) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, 12, SEEK_SET) != 0) {
    std::fclose(f);
    return -2;
  }
  size_t n = (size_t)w * h * nc;
  int ok = std::fread(out, sizeof(float), n, f) == n;
  std::fclose(f);
  return ok ? 0 : -3;
}

// ---------------------------------------------------------------------------
// .pfm codec (grayscale "Pf"), bottom-up rows, little-endian scale -1.0.
// negate != 0 replicates the reference's sign flip on write
// (run_dense.cpp:75).
// ---------------------------------------------------------------------------

int ofdis_write_pfm(const char* path, const float* data, int32_t w, int32_t h,
                    int32_t negate) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f, "Pf\n%d %d\n%f\n", w, h, -1.0f);
  float* row = (float*)std::malloc(sizeof(float) * w);
  if (!row) {
    std::fclose(f);
    return -4;
  }
  int ok = 1;
  for (int32_t y = h - 1; y >= 0; --y) {
    const float* src = data + (size_t)y * w;
    if (negate) {
      for (int32_t x = 0; x < w; ++x) row[x] = -src[x];
      ok &= std::fwrite(row, sizeof(float), w, f) == (size_t)w;
    } else {
      ok &= std::fwrite(src, sizeof(float), w, f) == (size_t)w;
    }
  }
  std::free(row);
  std::fclose(f);
  return ok ? 0 : -2;
}

int ofdis_pfm_dims(const char* path, int32_t* w, int32_t* h, float* scale) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char tag[8];
  int ok = std::fscanf(f, "%2s", tag) == 1 && std::strcmp(tag, "Pf") == 0;
  ok = ok && std::fscanf(f, "%d %d", w, h) == 2;
  ok = ok && std::fscanf(f, "%f", scale) == 1;
  std::fclose(f);
  return ok ? 0 : -2;
}

int ofdis_read_pfm(const char* path, float* out, int32_t w, int32_t h,
                   int32_t negate) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // skip the 3-line header: "Pf\n", dims line, scale line
  char tag[8];
  int32_t ww, hh;
  float scale;
  int ok = std::fscanf(f, "%2s%d%d%f", tag, &ww, &hh, &scale) == 4;
  std::fgetc(f);  // single whitespace after scale
  if (!ok || ww != w || hh != h) {
    std::fclose(f);
    return -2;
  }
  for (int32_t y = h - 1; y >= 0 && ok; --y) {
    float* dst = out + (size_t)y * w;
    ok = std::fread(dst, sizeof(float), w, f) == (size_t)w;
  }
  std::fclose(f);
  size_t n = (size_t)w * h;
  if (scale > 0.0f) {
    // positive scale marks big-endian pixel data (PFM spec)
    for (size_t i = 0; i < n; ++i) {
      uint32_t v;
      std::memcpy(&v, out + i, 4);
      v = __builtin_bswap32(v);
      std::memcpy(out + i, &v, 4);
    }
  }
  if (negate) {
    for (size_t i = 0; i < n; ++i) out[i] = -out[i];
  }
  return ok ? 0 : -3;
}

// ---------------------------------------------------------------------------
// Image conversion: OpenCV's fixed-point RGB->gray (parity with
// cv::imread(..., IMREAD_GRAYSCALE) on 8-bit input).
// ---------------------------------------------------------------------------

void ofdis_gray_from_rgb_u8(const uint8_t* rgb, float* out, int64_t npix) {
  for (int64_t i = 0; i < npix; ++i) {
    const int64_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    out[i] = (float)((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14);
  }
}

// ---------------------------------------------------------------------------
// PGM/PPM (binary P5/P6, maxval <= 255) decoder for OpenCV-free image input.
// Two-phase: dims query, then pixel read into caller buffer.
// ---------------------------------------------------------------------------

static int pnm_header(FILE* f, int* type, int32_t* w, int32_t* h) {
  char magic[3] = {0};
  if (std::fscanf(f, "%2s", magic) != 1) return -1;
  if (magic[0] != 'P' || (magic[1] != '5' && magic[1] != '6')) return -2;
  *type = magic[1] - '0';
  int32_t vals[3];
  int got = 0;
  while (got < 3) {
    int c = std::fgetc(f);
    if (c == '#') {  // comment line
      while (c != '\n' && c != EOF) c = std::fgetc(f);
    } else if (c >= '0' && c <= '9') {
      std::ungetc(c, f);
      if (std::fscanf(f, "%d", &vals[got]) != 1) return -3;
      got++;
    } else if (c == EOF) {
      return -3;
    }
  }
  if (vals[2] > 255) return -4;
  *w = vals[0];
  *h = vals[1];
  return 0;
}

int ofdis_pnm_dims(const char* path, int32_t* w, int32_t* h, int32_t* channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int type;
  int rc = pnm_header(f, &type, w, h);
  std::fclose(f);
  if (rc) return rc;
  *channels = (type == 5) ? 1 : 3;
  return 0;
}

int ofdis_read_pnm(const char* path, uint8_t* out, int32_t w, int32_t h,
                   int32_t channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int type;
  int32_t ww, hh;
  int rc = pnm_header(f, &type, &ww, &hh);
  if (rc || ww != w || hh != h) {
    std::fclose(f);
    return -2;
  }
  std::fgetc(f);  // single whitespace after maxval
  size_t n = (size_t)w * h * channels;
  int ok = std::fread(out, 1, n, f) == n;
  std::fclose(f);
  return ok ? 0 : -3;
}

}  // extern "C"
