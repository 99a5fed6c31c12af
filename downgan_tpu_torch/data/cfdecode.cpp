// Host data-layer kernels of downgan_tpu_torch (the port's own copy of the
// JAX package's native/cfdecode.cpp): CF packed-variable decode (int16/int8
// -> float32 with fill -> NaN), NaN-aware moments, in-place standardization
// and block-mean coarsening, for the host-side loops of preprocessing and of
// the streaming tier. Compiled by downgan_tpu_torch/data/native.py at first
// use (g++ -O3) into build/torch_ext/; every entry point has a numpy
// fallback that gives the same bits, so nothing needs a toolchain.
//
// Build: g++ -O3 -shared -fPIC -o libcfdecode.so cfdecode.cpp
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <limits>

extern "C" {

// Unpack CF int16 payload: out = in * scale + offset; fill -> NaN.
void cf_unpack_i16(const int16_t* in, size_t n, double scale, double offset,
                   int16_t fill, int has_fill, float* out) {
  const float qnan = std::numeric_limits<float>::quiet_NaN();
  if (has_fill) {
    for (size_t i = 0; i < n; ++i) {
      out[i] = (in[i] == fill)
                   ? qnan
                   : static_cast<float>(in[i] * scale + offset);
    }
  } else {
    for (size_t i = 0; i < n; ++i) {
      out[i] = static_cast<float>(in[i] * scale + offset);
    }
  }
}

void cf_unpack_i8(const int8_t* in, size_t n, double scale, double offset,
                  int8_t fill, int has_fill, float* out) {
  const float qnan = std::numeric_limits<float>::quiet_NaN();
  if (has_fill) {
    for (size_t i = 0; i < n; ++i) {
      out[i] = (in[i] == fill)
                   ? qnan
                   : static_cast<float>(in[i] * scale + offset);
    }
  } else {
    for (size_t i = 0; i < n; ++i) {
      out[i] = static_cast<float>(in[i] * scale + offset);
    }
  }
}

// NaN-skipping mean/std (population, matching numpy.nanstd's default ddof=0).
// Two-pass in double precision for accuracy on GB-scale arrays.
void nan_moments(const float* in, size_t n, double* mean_out, double* std_out,
                 size_t* count_out) {
  double sum = 0.0;
  size_t count = 0;
  for (size_t i = 0; i < n; ++i) {
    if (!std::isnan(in[i])) {
      sum += in[i];
      ++count;
    }
  }
  const double mean = count ? sum / count : std::nan("");
  double ss = 0.0;
  for (size_t i = 0; i < n; ++i) {
    if (!std::isnan(in[i])) {
      const double d = in[i] - mean;
      ss += d * d;
    }
  }
  *mean_out = mean;
  *std_out = count ? std::sqrt(ss / count) : std::nan("");
  *count_out = count;
}

// In-place z-score: data = (data - mean) * inv_std.
void standardize_inplace(float* data, size_t n, double mean, double inv_std) {
  const float m = static_cast<float>(mean);
  const float s = static_cast<float>(inv_std);
  for (size_t i = 0; i < n; ++i) {
    data[i] = (data[i] - m) * s;
  }
}

// Block-mean coarsening of a (t, h, w) field by `factor` in both spatial
// dims: out has shape (t, h/factor, w/factor).
void block_mean_coarsen(const float* in, size_t t, size_t h, size_t w,
                        size_t factor, float* out) {
  const size_t ho = h / factor, wo = w / factor;
  const double inv = 1.0 / static_cast<double>(factor * factor);
  for (size_t k = 0; k < t; ++k) {
    const float* plane = in + k * h * w;
    float* oplane = out + k * ho * wo;
    for (size_t i = 0; i < ho; ++i) {
      for (size_t j = 0; j < wo; ++j) {
        double acc = 0.0;
        for (size_t di = 0; di < factor; ++di) {
          const float* row = plane + (i * factor + di) * w + j * factor;
          for (size_t dj = 0; dj < factor; ++dj) acc += row[dj];
        }
        oplane[i * wo + j] = static_cast<float>(acc * inv);
      }
    }
  }
}

}  // extern "C"
