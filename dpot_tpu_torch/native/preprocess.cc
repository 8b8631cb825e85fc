// Host preprocessing library of the port (dpot_tpu_torch/native): the data
// layer's per-sample hot loop (grid_dataset.py pad_data: bilinear resize to
// res^2 and ONES channel padding), the 3D trilinear resize, and the loader's
// whole-batch window assembly with its f32 -> bf16 conversion. It runs on
// the host that feeds the GPU, so it is plain C++ threads, not a kernel.
//
// A plain C ABI for ctypes (dpot_tpu_torch/native/preprocess.py). The
// resizes match torch F.interpolate(mode='bilinear'/'trilinear',
// align_corners=False): separable linear interpolation with half-pixel
// centers. tests/test_torch_native.py holds every function against its
// numpy version and against the JAX package's build of the same arithmetic.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct AxisLerp {
  std::vector<int64_t> i0, i1;
  std::vector<float> w0;
};

AxisLerp make_axis(int64_t n_in, int64_t n_out) {
  AxisLerp a;
  a.i0.resize(n_out);
  a.i1.resize(n_out);
  a.w0.resize(n_out);
  if (n_in == n_out) {
    for (int64_t i = 0; i < n_out; ++i) {
      a.i0[i] = a.i1[i] = i;
      a.w0[i] = 1.0f;
    }
    return a;
  }
  const double scale = static_cast<double>(n_in) / n_out;
  for (int64_t i = 0; i < n_out; ++i) {
    double x = (i + 0.5) * scale - 0.5;
    x = std::min(std::max(x, 0.0), static_cast<double>(n_in - 1));
    const int64_t i0 = static_cast<int64_t>(std::floor(x));
    a.i0[i] = i0;
    a.i1[i] = std::min(i0 + 1, n_in - 1);
    a.w0[i] = 1.0f - static_cast<float>(x - i0);
  }
  return a;
}

void for_rows(int64_t n, int n_threads,
              const std::function<void(int64_t, int64_t)>& fn) {
  if (n_threads <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(lo + chunk, n);
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Bilinear resize (H, W, F) -> (oh, ow, F), half-pixel centers.
// F is the flattened trailing size (T*C). Threaded over output rows.
void resize_bilinear_2d(const float* in, float* out, int64_t H, int64_t W,
                        int64_t F, int64_t oh, int64_t ow, int n_threads) {
  const AxisLerp ay = make_axis(H, oh);
  const AxisLerp ax = make_axis(W, ow);
  for_rows(oh, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<float> row(W * F);
    for (int64_t y = lo; y < hi; ++y) {
      const float wy = ay.w0[y];
      const float* r0 = in + ay.i0[y] * W * F;
      const float* r1 = in + ay.i1[y] * W * F;
      for (int64_t i = 0; i < W * F; ++i)
        row[i] = wy * r0[i] + (1.0f - wy) * r1[i];
      float* o = out + y * ow * F;
      for (int64_t x = 0; x < ow; ++x) {
        const float wx = ax.w0[x];
        const float* c0 = row.data() + ax.i0[x] * F;
        const float* c1 = row.data() + ax.i1[x] * F;
        for (int64_t f = 0; f < F; ++f)
          o[x * F + f] = wx * c0[f] + (1.0f - wx) * c1[f];
      }
    }
  });
}

// Fused pad_data: resize (H, W, T, C) -> (res, res, T, Cmax) with ONES
// channel padding (reference griddataset.py:88-101) in one pass.
void pad_data_2d(const float* in, float* out, int64_t H, int64_t W, int64_t T,
                 int64_t C, int64_t res, int64_t c_max, int n_threads) {
  const AxisLerp ay = make_axis(H, res);
  const AxisLerp ax = make_axis(W, res);
  const int64_t F = T * C;
  const int64_t Fo = T * c_max;
  for_rows(res, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<float> row(W * F);
    for (int64_t y = lo; y < hi; ++y) {
      const float wy = ay.w0[y];
      const float* r0 = in + ay.i0[y] * W * F;
      const float* r1 = in + ay.i1[y] * W * F;
      for (int64_t i = 0; i < W * F; ++i)
        row[i] = wy * r0[i] + (1.0f - wy) * r1[i];
      float* o = out + y * res * Fo;
      for (int64_t x = 0; x < res; ++x) {
        const float wx = ax.w0[x];
        const float* c0 = row.data() + ax.i0[x] * F;
        const float* c1 = row.data() + ax.i1[x] * F;
        float* op = o + x * Fo;
        for (int64_t t = 0; t < T; ++t) {
          for (int64_t c = 0; c < C; ++c)
            op[t * c_max + c] =
                wx * c0[t * C + c] + (1.0f - wx) * c1[t * C + c];
          for (int64_t c = C; c < c_max; ++c) op[t * c_max + c] = 1.0f;
        }
      }
    }
  });
}

// Trilinear resize (H, W, L, F) -> (oh, ow, ol, F).
void resize_trilinear_3d(const float* in, float* out, int64_t H, int64_t W,
                         int64_t L, int64_t F, int64_t oh, int64_t ow,
                         int64_t ol, int n_threads) {
  const AxisLerp az = make_axis(H, oh);
  const AxisLerp ay = make_axis(W, ow);
  const AxisLerp ax = make_axis(L, ol);
  for_rows(oh, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<float> plane(W * L * F), row(L * F);
    for (int64_t z = lo; z < hi; ++z) {
      const float wz = az.w0[z];
      const float* p0 = in + az.i0[z] * W * L * F;
      const float* p1 = in + az.i1[z] * W * L * F;
      for (int64_t i = 0; i < W * L * F; ++i)
        plane[i] = wz * p0[i] + (1.0f - wz) * p1[i];
      for (int64_t y = 0; y < ow; ++y) {
        const float wy = ay.w0[y];
        const float* r0 = plane.data() + ay.i0[y] * L * F;
        const float* r1 = plane.data() + ay.i1[y] * L * F;
        for (int64_t i = 0; i < L * F; ++i)
          row[i] = wy * r0[i] + (1.0f - wy) * r1[i];
        float* o = out + (z * ow + y) * ol * F;
        for (int64_t x = 0; x < ol; ++x) {
          const float wx = ax.w0[x];
          const float* c0 = row.data() + ax.i0[x] * F;
          const float* c1 = row.data() + ax.i1[x] * F;
          for (int64_t f = 0; f < F; ++f)
            o[x * F + f] = wx * c0[f] + (1.0f - wx) * c1[f];
        }
      }
    }
  });
}

// Batched window assembly (the loader's whole-batch path): each item j is
// ONE contiguous f32 range of a time-major trajectory memmap
// (data/raw_hdf5.py) holding x_elems input elements immediately followed
// by y_elems target elements; copy them into row j of the x / y batch
// slots. Called once per BATCH through ctypes (GIL released), in place of
// a per-item Python loop of fetch_into -> _copy_exact -> np.copyto.
void assemble_windows_f32(const float* const* srcs, float* x, float* y,
                          int64_t n, int64_t x_elems, int64_t y_elems,
                          int n_threads) {
  for_rows(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      std::memcpy(x + j * x_elems, srcs[j], x_elems * sizeof(float));
      std::memcpy(y + j * y_elems, srcs[j] + x_elems,
                  y_elems * sizeof(float));
    }
  });
}

namespace {

// f32 -> bf16 with round-to-nearest-even, bit-exact with ml_dtypes /
// Eigen and with torch's own conversion: NaN quietened, everything else
// u += 0x7FFF + lsb. Equality with the numpy version (preprocess.py
// f32_to_bf16_bits) is pinned in tests/test_torch_native.py over specials
// and random fields.
inline uint16_t f32_to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof(u));
  // branchless select so -O3 can vectorize the conversion loop (a taken
  // branch keeps it scalar): rounded value for finite/inf, quietened high
  // half for NaN.
  const uint16_t rounded =
      static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
  const uint16_t quiet_nan = static_cast<uint16_t>((u >> 16) | 0x0040u);
  return ((u & 0x7FFFFFFFu) > 0x7F800000u) ? quiet_nan : rounded;
}

inline void copy_bf16_scalar(uint16_t* dst, const float* src, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] = f32_to_bf16(src[i]);
}

#if defined(__AVX512F__) && defined(__AVX512BW__)
#include <immintrin.h>
// AVX-512 integer-form RNE (same math as f32_to_bf16 lane-wise — NOT
// vcvtneps2bf16, whose forced-DAZ handling of denormal f32 inputs would
// break bit-exactness with ml_dtypes) with NON-TEMPORAL stores: the
// output rows exceed L2, so streaming them skips the read-for-ownership
// pass, a quarter of the conversion's memory traffic (4 bytes read and 2
// written per element, plus 2 read for ownership).
inline void copy_bf16(uint16_t* dst, const float* src, int64_t n) {
  int64_t i = 0;
  // scalar head until the destination is 32B-aligned (stream requires it)
  while (i < n && (reinterpret_cast<uintptr_t>(dst + i) & 31u) != 0) {
    dst[i] = f32_to_bf16(src[i]);
    ++i;
  }
  const __m512i bias = _mm512_set1_epi32(0x7FFF);
  const __m512i one = _mm512_set1_epi32(1);
  const __m512i quiet = _mm512_set1_epi32(0x0040);
  const __m512i absm = _mm512_set1_epi32(0x7FFFFFFF);
  const __m512i inf = _mm512_set1_epi32(0x7F800000);
  for (; i + 16 <= n; i += 16) {
    const __m512i u = _mm512_loadu_si512(src + i);
    const __m512i lsb =
        _mm512_and_si512(_mm512_srli_epi32(u, 16), one);
    __m512i r = _mm512_srli_epi32(
        _mm512_add_epi32(u, _mm512_add_epi32(bias, lsb)), 16);
    const __m512i q =
        _mm512_or_si512(_mm512_srli_epi32(u, 16), quiet);
    const __mmask16 nan =
        _mm512_cmpgt_epu32_mask(_mm512_and_si512(u, absm), inf);
    r = _mm512_mask_mov_epi32(r, nan, q);
    _mm256_stream_si256(reinterpret_cast<__m256i*>(dst + i),
                        _mm512_cvtepi32_epi16(r));
  }
  for (; i < n; ++i) dst[i] = f32_to_bf16(src[i]);
  _mm_sfence();
}
#else
inline void copy_bf16(uint16_t* dst, const float* src, int64_t n) {
  copy_bf16_scalar(dst, src, n);
}
#endif

}  // namespace

// As assemble_windows_f32, but converting into bf16 batch slots (the
// train wire format): the dtype cast rides the one assembly pass.
void assemble_windows_bf16(const float* const* srcs, uint16_t* x,
                           uint16_t* y, int64_t n, int64_t x_elems,
                           int64_t y_elems, int n_threads) {
  for_rows(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      copy_bf16(x + j * x_elems, srcs[j], x_elems);
      copy_bf16(y + j * y_elems, srcs[j] + x_elems, y_elems);
    }
  });
}

}  // extern "C"
