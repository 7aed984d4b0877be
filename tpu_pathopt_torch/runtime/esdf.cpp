// Host-side exact Euclidean distance transform (Felzenszwalb & Huttenlocher
// 2-pass lower-envelope algorithm), the native runtime counterpart of the
// reference demo's cv::distanceTransform map preprocessing
// (reference: src/test/demo.cpp:109-113).
//
// The port builds maps on the device with its own exact EDT
// (tpu_pathopt_torch/maps.py); this C++ path is the host data loader the CLI
// uses for a map read from a PNG: O(n) per row and column, and it leaves the
// GPU free. A copy of the JAX package's runtime/esdf.cpp, so the port needs
// nothing of that package.
//
// Built by g++ as a plain shared library at first use (native.py), loaded
// with ctypes.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// 1-D squared distance transform of sampled function f, lower envelope of
// parabolas. n values; d gets min_j (f[j] + (i-j)^2).
void dt1d(const float* f, float* d, int* v, float* z, int n) {
  int k = 0;
  v[0] = 0;
  z[0] = -FLT_MAX;
  z[1] = FLT_MAX;
  for (int q = 1; q < n; ++q) {
    float s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2.0f * q - 2.0f * v[k]);
    while (s <= z[k]) {
      --k;
      s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2.0f * q - 2.0f * v[k]);
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = FLT_MAX;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    int j = v[k];
    d[q] = (q - j) * (q - j) + f[j];
  }
}

}  // namespace

extern "C" {

// obstacle: (rows*cols) uint8, nonzero = occupied. out: (rows*cols) float32
// distance in PIXELS to the nearest occupied cell (FLT_MAX/2-ish if none).
void esdf_f32(const uint8_t* obstacle, float* out, int rows, int cols) {
  const float kInf = 1e12f;
  std::vector<float> f(std::max(rows, cols));
  std::vector<float> d(std::max(rows, cols));
  std::vector<int> v(std::max(rows, cols));
  std::vector<float> z(std::max(rows, cols) + 1);

  // Pass 1: columns of squared distances along each row.
  for (int r = 0; r < rows; ++r) {
    for (int c = 0; c < cols; ++c)
      f[c] = obstacle[r * cols + c] ? 0.0f : kInf;
    dt1d(f.data(), d.data(), v.data(), z.data(), cols);
    for (int c = 0; c < cols; ++c) out[r * cols + c] = d[c];
  }
  // Pass 2: along each column.
  for (int c = 0; c < cols; ++c) {
    for (int r = 0; r < rows; ++r) f[r] = out[r * cols + c];
    dt1d(f.data(), d.data(), v.data(), z.data(), rows);
    for (int r = 0; r < rows; ++r)
      out[r * cols + c] = std::sqrt(d[r]);
  }
}

}  // extern "C"
