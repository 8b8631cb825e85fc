// Fused GroupNorm + AFNO spectral mixer for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_gn_afno` in dpot_tpu/ops/pallas/afno_fused.py
// (`_kernel`, launched by `_fused_fwd`). Per sample b it computes
//
//     xn  = GroupNorm(groups)(x[b]) * gscale + gbias        (f32, eps 1e-5)
//     z   = A . round(xn)                                   (2K x C)
//     h_j = act([z_re | z_im]_j . W1_j + B1_j)              block j of nb
//     o_j = round(h_j) . W2_j + B2_j
//     out = Ainv . round(o) + xn                            (xn kept in f32)
//
// where "round" is a cast to the operand type T (bf16 or f32), every
// product accumulates in f32, and act is tanh-GELU (the TPU kernel) or erf-GELU
// (the JAX f32 path). W1/W2 are read in the reference layout (2, nb, bs, bs)
// and expanded to the real form [[wr, wi], [-wi, wr]] while their tiles load.
//
// What bounds it on this card. At DPOT-Ti (HW 256, C 512, K 144, nb 4) one
// sample costs 302 MFLOP against ~0.7 MB of operands, so from B ~ 2 up the
// work is bound by tensor-core operations in bf16 and by the FMA pipes in f32.
// The TPU kernel keeps A, Ainv, all of W1/W2 and the x tile resident in VMEM;
// at Ti that is over 1.5 MB, far beyond the 227 KB of shared memory a Hopper
// block can hold, and Hopper's blocks run in no order, so a sample's GroupNorm
// statistics cannot be carried from block to block. The design therefore
// splits the work into five launches on one stream:
//   1. gn_stats_kernel: one block per (group, sample), two-pass f32 statistics;
//   2. analysis_kernel: z = A . xn as a tiled GEMM that normalises x while it
//      loads the x tiles into shared memory;
//   3. mode_hidden_kernel: the first MLP layer, one 64 x 64 tile of the
//      hidden layer h of one block j per thread block;
//   4. mode_out_kernel: the second MLP layer, written back as o;
//   5. synthesis_kernel: Ainv . o with an epilogue that adds the f32 xn,
//      recomputed from x and the statistics.
// The MLP is split in two launches so that a small batch still fills the
// card: one launch for both layers had only 12 thread blocks at B = 1. z, h
// and o make a round trip through device memory (2.4 MB each at B = 8 in
// bf16). Products use mma.sync tensor-core tiles (WMMA) for bf16 and FMA for
// f32. At these shapes a launch has 8 to 320 thread blocks, one or two per SM,
// so a k-slab costs the instructions and the load latency of its tiles, not
// bandwidth. The tiles therefore load as 16-byte chunks, the loaders do no
// integer division per element (the GroupNorm constants of a block's
// channels and the offsets of its mode rows are gathered into shared memory
// once), and each thread stages the next slab in registers while the current
// one is multiplied. Keeping z, h and o on chip and feeding wgmma from TMA is
// the work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;         // tile rows
constexpr int BN = 64;         // tile columns
constexpr int BK = 64;         // tile depth
constexpr int NT = 256;        // threads per block (8 warps)
constexpr int LDA = BK + 8;    // shared-memory row strides, padded
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr float EPS = 1e-5f;   // torch.nn.GroupNorm default

template <typename T> __device__ __forceinline__ T to_op(float v);
template <> __device__ __forceinline__ float to_op<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 to_op<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <bool APPROX> __device__ __forceinline__ float gelu(float v) {
  if (APPROX) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return v * (0.5f * (1.0f + tanhf(k * (v + 0.044715f * v * v * v))));
  }
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// 16 bytes of consecutive row elements: the unit in which tiles load.
template <typename T> struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T e[N];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = to_op<T>(0.f);
  }
  // e = p[k .. k + N), zero from column n on. vec: p + k is 16-byte aligned
  // at every k that is a multiple of N.
  __device__ void load(const T* p, int k, int n, bool vec) {
    if (vec && k + N <= n) {
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p + k);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) e[i] = k + i < n ? p[k + i] : to_op<T>(0.f);
    }
  }
  __device__ void store(T* dst) const {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(e);
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Shared-memory tiles of one block: A (BM x BK) and B (BK x BN) during the
// k loop, then the f32 result in the same bytes.
template <typename T> struct Tiles {
  static constexpr int A_BYTES = BM * LDA * sizeof(T);
  static constexpr int AB_BYTES = A_BYTES + BK * LDB * sizeof(T);
  static constexpr int C_BYTES = BM * LDC * sizeof(float);
  alignas(128) unsigned char raw[AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES];

  __device__ T* a() { return reinterpret_cast<T*>(raw); }
  __device__ T* b() { return reinterpret_cast<T*>(raw + A_BYTES); }
  __device__ float* c() { return reinterpret_cast<float*>(raw); }
};

// The BM x BN accumulator of one block, held in registers across the k loop.
template <typename T> struct TileAcc;

// f32: each thread owns a 4 x 4 micro-tile (rows ty + 16 i, cols tx + 16 j).
template <> struct TileAcc<float> {
  float acc[4][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ void step(const float* ta, const float* tb) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ta[(ty + 16 * i) * LDA + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = tb[k * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* c) const {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  }
};

// bf16: warp w owns the 16 x 32 strip at rows 16 (w / 2), cols 32 (w % 2),
// as two 16 x 16 x 16 tensor-core fragments with f32 accumulators.
template <> struct TileAcc<bf16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2];
  __device__ void zero() {
    nvcuda::wmma::fill_fragment(acc[0], 0.f);
    nvcuda::wmma::fill_fragment(acc[1], 0.f);
  }
  __device__ void step(const bf16* ta, const bf16* tb) {
    using namespace nvcuda;
    const int w = threadIdx.x / 32, r = 16 * (w / 2), c = 32 * (w % 2);
#pragma unroll
    for (int k = 0; k < BK; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, ta + r * LDA + k, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, tb + k * LDB + c + 16 * j, LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __device__ void store(float* cs) const {
    const int w = threadIdx.x / 32, r = 16 * (w / 2), c = 32 * (w % 2);
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(cs + r * LDC + c + 16 * j, acc[j], LDC,
                                       nvcuda::wmma::mem_row_major);
  }
};

// One BM x BN output tile: the sum over kdim of A(m, k) * B(k, n), then
// epi(m, n, acc) for every tile element. load_a(m, k, v) fills v with the
// 16-byte chunk A(m, k .. k + N) and load_b(k, n, v) with B(k, n .. n + N),
// for tile-local m, n and absolute k (zero outside the matrices). Each thread
// fetches its chunks of the next slab into registers before the current
// slab's products, so the loads are in flight while the tensor cores work.
template <typename T, typename LoadA, typename LoadB, typename Epi>
__device__ void gemm_tile(Tiles<T>& t, int kdim, LoadA load_a, LoadB load_b,
                          Epi epi) {
  constexpr int N = Vec<T>::N;
  constexpr int CA = BK / N, CB = BN / N;  // chunks per tile row
  constexpr int A_PER = BM * CA / NT, B_PER = BK * CB / NT;
  TileAcc<T> acc;
  acc.zero();
  Vec<T> ra[A_PER], rb[B_PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int s = 0; s < A_PER; ++s) {
      const int q = threadIdx.x + s * NT;
      load_a(q / CA, k0 + q % CA * N, ra[s]);
    }
#pragma unroll
    for (int s = 0; s < B_PER; ++s) {
      const int q = threadIdx.x + s * NT;
      load_b(k0 + q / CB, q % CB * N, rb[s]);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < kdim; k0 += BK) {
#pragma unroll
    for (int s = 0; s < A_PER; ++s) {
      const int q = threadIdx.x + s * NT;
      ra[s].store(t.a() + q / CA * LDA + q % CA * N);
    }
#pragma unroll
    for (int s = 0; s < B_PER; ++s) {
      const int q = threadIdx.x + s * NT;
      rb[s].store(t.b() + q / CB * LDB + q % CB * N);
    }
    __syncthreads();
    if (k0 + BK < kdim) fetch(k0 + BK);
    acc.step(t.a(), t.b());
    __syncthreads();
  }
  acc.store(t.c());  // the k loop is done with the A and B tiles
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += NT)
    epi(i / BN, i % BN, t.c()[(i / BN) * LDC + i % BN]);
  __syncthreads();
}

// GroupNorm constants of the BN channels n0 .. n0 + BN - 1 of sample b,
// gathered once per block, so that no loader divides per element.
struct ColNorm {
  float mean[BN], rstd[BN], scale[BN], bias[BN];

  __device__ void load(const float* stats, const float* gscale,
                       const float* gbias, int b, int n0, int C, int groups) {
    const int cpg = C / groups;
    for (int n = threadIdx.x; n < BN; n += NT) {
      const int c = n0 + n;
      if (c < C) {
        const int s = 2 * (b * groups + c / cpg);
        mean[n] = stats[s];
        rstd[n] = stats[s + 1];
        scale[n] = gscale[c];
        bias[n] = gbias[c];
      }
    }
    __syncthreads();
  }
  // normalised, affine-transformed value v of channel n0 + n, in f32
  __device__ float operator()(int n, float v) const {
    return (v - mean[n]) * rstd[n] * scale[n] + bias[n];
  }
};

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// grid (groups, B): mean and 1/sqrt(var + eps) of one group of one sample.
// (Unrolled, so that each thread has eight loads in flight.)
template <typename T>
__global__ void __launch_bounds__(NT)
gn_stats_kernel(const T* x, float* stats, int HW, int C, int groups) {
  __shared__ float red[NT / 32];
  const int g = blockIdx.x, b = blockIdx.y, cpg = C / groups;
  const int n = HW * cpg;
  const T* xg = x + (size_t)b * HW * C + g * cpg;
  float s = 0.f;
#pragma unroll 8
  for (int i = threadIdx.x; i < n; i += NT) s += to_f32(xg[(size_t)(i / cpg) * C + i % cpg]);
  const float mean = block_sum(s, red) / n;
  float q = 0.f;
#pragma unroll 8
  for (int i = threadIdx.x; i < n; i += NT) {
    const float d = to_f32(xg[(size_t)(i / cpg) * C + i % cpg]) - mean;
    q += d * d;
  }
  const float var = block_sum(q, red) / n;
  if (threadIdx.x == 0) {
    stats[2 * (b * groups + g)] = mean;
    stats[2 * (b * groups + g) + 1] = rsqrtf(var + EPS);
  }
}

// grid (C / BN, 2K / BM, B): z[b] = A . round(xn[b]), stored rounded.
template <typename T>
__global__ void __launch_bounds__(NT)
analysis_kernel(const T* x, const float* stats, const float* gscale,
                const float* gbias, const T* A, T* z, int HW, int C, int K2,
                int groups) {
  constexpr int N = Vec<T>::N;
  __shared__ Tiles<T> t;
  __shared__ ColNorm xnorm;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, b = blockIdx.z;
  xnorm.load(stats, gscale, gbias, b, n0, C, groups);
  const T* xb = x + (size_t)b * HW * C + n0;
  const bool vec_a = HW % N == 0 && aligned16(A);
  const bool vec_x = C % N == 0 && aligned16(x);
  gemm_tile<T>(
      t, HW,
      [&](int m, int k, Vec<T>& v) {
        if (m0 + m < K2) v.load(A + (size_t)(m0 + m) * HW, k, HW, vec_a);
        else v.zero();
      },
      [&](int k, int n, Vec<T>& v) {
        if (k >= HW) return v.zero();
        v.load(xb + (size_t)k * C, n, C - n0, vec_x);
#pragma unroll
        for (int i = 0; i < N; ++i)
          v.e[i] = n0 + n + i < C ? to_op<T>(xnorm(n + i, to_f32(v.e[i]))) : to_op<T>(0.f);
      },
      [&](int m, int n, float v) {
        if (m0 + m < K2 && n0 + n < C)
          z[((size_t)b * K2 + m0 + m) * C + n0 + n] = to_op<T>(v);
      });
}

// Element (i, n) of the real-form block weight [[wr, wi], [-wi, wr]] of
// block j (i, n < 2 bs), read from the reference layout w (2, nb, bs, bs).
__device__ __forceinline__ float real_form(const float* w, int j, int i, int n,
                                           int nb, int bs) {
  const bool top = i < bs, left = n < bs;
  const size_t re = ((size_t)j * bs + (top ? i : i - bs)) * bs + (left ? n : n - bs);
  const size_t im = re + (size_t)nb * bs * bs;
  if (top) return left ? w[re] : w[im];
  return left ? -w[im] : w[re];
}

// Chunk (i, n .. n + N) of the real-form weight of block j, i < 2 bs. vec:
// bs is a multiple of N and w is 16-byte aligned, so the chunk lies in one
// quadrant and loads as N / 4 float4s.
template <typename T>
__device__ __forceinline__ void load_real_form(Vec<T>& v, const float* w, int j,
                                               int i, int n, int nb, int bs,
                                               bool vec) {
  constexpr int N = Vec<T>::N;
  const int hid = 2 * bs;
  if (!vec) {
#pragma unroll
    for (int e = 0; e < N; ++e)
      v.e[e] = n + e < hid ? to_op<T>(real_form(w, j, i, n + e, nb, bs)) : to_op<T>(0.f);
    return;
  }
  if (n >= hid) return v.zero();  // hid is a multiple of N here
  const bool top = i < bs, left = n < bs;
  const float sign = !top && left ? -1.f : 1.f;
  const float* p = w + ((size_t)(top == left ? 0 : nb) * bs + (size_t)j * bs +
                        (top ? i : i - bs)) * bs + (left ? n : n - bs);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v.e[4 * q + 0] = to_op<T>(sign * f.x);
    v.e[4 * q + 1] = to_op<T>(sign * f.y);
    v.e[4 * q + 2] = to_op<T>(sign * f.z);
    v.e[4 * q + 3] = to_op<T>(sign * f.w);
  }
}

// Bias element c < 2 bs of block j, from the reference layout (2, nb, bs).
__device__ __forceinline__ float block_bias(const float* bv, int j, int c, int nb,
                                            int bs) {
  return c < bs ? bv[j * bs + c] : bv[(nb + j) * bs + c - bs];
}

// Offsets of the mode rows r0 .. r0 + BM - 1 (r = b K + k) in z and o: the
// real part of row m of block j starts at row[m], its imaginary part K C
// further; -1 past the last mode row.
__device__ void mode_rows(long long* row, int r0, int B, int K, int C, int j,
                          int bs) {
  for (int m = threadIdx.x; m < BM; m += NT) {
    const int r = r0 + m;
    row[m] = r < B * K ? ((long long)(r / K) * 2 * K + r % K) * C + (long long)j * bs
                       : -1;
  }
  __syncthreads();
}

// grid (ceil(B*K / BM), 2 bs / BN, nb): the first layer of the complex block
// MLP, h = round(act([z_re | z_im]_j . W1_j + B1_j)), for 64 mode rows and
// 64 hidden columns of block j. h is (B*K, nb, 2 bs).
template <typename T, bool APPROX>
__global__ void __launch_bounds__(NT)
mode_hidden_kernel(const T* z, const float* w1, const float* b1, T* h, int B,
                   int K, int C, int nb) {
  constexpr int N = Vec<T>::N;
  __shared__ Tiles<T> t;
  __shared__ long long row[BM];
  const int bs = C / nb, hid = 2 * bs;
  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN, j = blockIdx.z;
  mode_rows(row, r0, B, K, C, j, bs);
  const size_t im = (size_t)K * C;
  // with bs and C multiples of N, a chunk of [z_re | z_im] lies in one half
  const bool vec_z = bs % N == 0 && C % N == 0 && aligned16(z);
  const bool vec_w = bs % N == 0 && aligned16(w1);
  gemm_tile<T>(
      t, hid,
      [&](int m, int i, Vec<T>& v) {
        const long long r = row[m];
        if (r < 0 || i >= hid) return v.zero();
        if (vec_z) return v.load(z + r + (i < bs ? i : im + i - bs), 0, N, true);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const int c = i + e;
          v.e[e] = c < hid ? z[r + (c < bs ? c : im + c - bs)] : to_op<T>(0.f);
        }
      },
      [&](int i, int n, Vec<T>& v) {
        if (i < hid) load_real_form(v, w1, j, i, n0 + n, nb, bs, vec_w);
        else v.zero();
      },
      [&](int m, int n, float v) {
        const int c = n0 + n;
        if (row[m] >= 0 && c < hid)
          h[((size_t)(r0 + m) * nb + j) * hid + c] =
              to_op<T>(gelu<APPROX>(v + block_bias(b1, j, c, nb, bs)));
      });
}

// grid (ceil(B*K / BM), 2 bs / BN, nb): the second layer,
// o = round(h_j . W2_j + B2_j), written back to the [re; im] rows of o.
template <typename T>
__global__ void __launch_bounds__(NT)
mode_out_kernel(const T* h, const float* w2, const float* b2, T* o, int B,
                int K, int C, int nb) {
  constexpr int N = Vec<T>::N;
  __shared__ Tiles<T> t;
  __shared__ long long row[BM];
  const int bs = C / nb, hid = 2 * bs;
  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN, j = blockIdx.z;
  mode_rows(row, r0, B, K, C, j, bs);
  const size_t im = (size_t)K * C;
  const bool vec_h = hid % N == 0 && aligned16(h);
  const bool vec_w = bs % N == 0 && aligned16(w2);
  gemm_tile<T>(
      t, hid,
      [&](int m, int i, Vec<T>& v) {
        if (row[m] < 0) return v.zero();
        v.load(h + ((size_t)(r0 + m) * nb + j) * hid, i, hid, vec_h);
      },
      [&](int i, int n, Vec<T>& v) {
        if (i < hid) load_real_form(v, w2, j, i, n0 + n, nb, bs, vec_w);
        else v.zero();
      },
      [&](int m, int n, float v) {
        const int c = n0 + n;
        if (row[m] >= 0 && c < hid)
          o[row[m] + (c < bs ? c : im + c - bs)] =
              to_op<T>(v + block_bias(b2, j, c, nb, bs));
      });
}

// grid (C / BN, HW / BM, B): out[b] = Ainv . o[b] + xn[b] (xn in f32).
template <typename T>
__global__ void __launch_bounds__(NT)
synthesis_kernel(const T* Ainv, const T* o, const T* x, const float* stats,
                 const float* gscale, const float* gbias, T* out, int HW, int C,
                 int K2, int groups) {
  constexpr int N = Vec<T>::N;
  __shared__ Tiles<T> t;
  __shared__ ColNorm xnorm;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, b = blockIdx.z;
  xnorm.load(stats, gscale, gbias, b, n0, C, groups);
  const T* ob = o + (size_t)b * K2 * C + n0;
  const T* xb = x + (size_t)b * HW * C + n0;
  T* outb = out + (size_t)b * HW * C + n0;
  const bool vec_a = K2 % N == 0 && aligned16(Ainv);
  const bool vec_o = C % N == 0 && aligned16(o);
  gemm_tile<T>(
      t, K2,
      [&](int m, int k, Vec<T>& v) {
        if (m0 + m < HW) v.load(Ainv + (size_t)(m0 + m) * K2, k, K2, vec_a);
        else v.zero();
      },
      [&](int k, int n, Vec<T>& v) {
        if (k < K2) v.load(ob + (size_t)k * C, n, C - n0, vec_o);
        else v.zero();
      },
      [&](int m, int n, float v) {
        const int p = m0 + m;
        if (p < HW && n0 + n < C)
          outb[(size_t)p * C + n] = to_op<T>(v + xnorm(n, to_f32(xb[(size_t)p * C + n])));
      });
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, bool APPROX>
cudaError_t launch(const void* x, const float* gscale, const float* gbias,
                   const void* A, const void* Ainv, const float* w1,
                   const float* b1, const float* w2, const float* b2,
                   float* stats, void* z, void* h, void* o, void* out, int B,
                   int HW, int C, int K, int nb, int groups, cudaStream_t s) {
  const int K2 = 2 * K, hid = 2 * (C / nb);
  const T* xt = static_cast<const T*>(x);
  cudaError_t e;
  gn_stats_kernel<T><<<dim3(groups, B), NT, 0, s>>>(xt, stats, HW, C, groups);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  analysis_kernel<T><<<dim3(cdiv(C, BN), cdiv(K2, BM), B), NT, 0, s>>>(
      xt, stats, gscale, gbias, static_cast<const T*>(A), static_cast<T*>(z),
      HW, C, K2, groups);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 mode_grid(cdiv(B * K, BM), cdiv(hid, BN), nb);
  mode_hidden_kernel<T, APPROX><<<mode_grid, NT, 0, s>>>(
      static_cast<const T*>(z), w1, b1, static_cast<T*>(h), B, K, C, nb);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  mode_out_kernel<T><<<mode_grid, NT, 0, s>>>(
      static_cast<const T*>(h), w2, b2, static_cast<T*>(o), B, K, C, nb);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  synthesis_kernel<T><<<dim3(cdiv(C, BN), cdiv(HW, BM), B), NT, 0, s>>>(
      static_cast<const T*>(Ainv), static_cast<const T*>(o), xt, stats, gscale,
      gbias, static_cast<T*>(out), HW, C, K2, groups);
  return cudaGetLastError();
}

}  // namespace

// x, out, A, Ainv and the scratch z, o (B, 2K, C) and h (B*K, nb, 2 bs) are
// of the operand type (bf16 when is_bf16, else f32); gscale/gbias (C),
// w1/w2 (2, nb, bs, bs), b1/b2 (2, nb, bs) and the stats scratch
// (B * groups * 2) are f32. Returns the first CUDA error.
extern "C" int dpot_fused_gn_afno(int is_bf16, int approximate, const void* x,
                                  const float* gscale, const float* gbias,
                                  const void* A, const void* Ainv,
                                  const float* w1, const float* b1,
                                  const float* w2, const float* b2, float* stats,
                                  void* z, void* h, void* o, void* out, int B,
                                  int HW, int C, int K, int nb, int groups,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return approximate
               ? launch<bf16, true>(x, gscale, gbias, A, Ainv, w1, b1, w2, b2,
                                    stats, z, h, o, out, B, HW, C, K, nb, groups, s)
               : launch<bf16, false>(x, gscale, gbias, A, Ainv, w1, b1, w2, b2,
                                     stats, z, h, o, out, B, HW, C, K, nb, groups, s);
  return approximate
             ? launch<float, true>(x, gscale, gbias, A, Ainv, w1, b1, w2, b2,
                                   stats, z, h, o, out, B, HW, C, K, nb, groups, s)
             : launch<float, false>(x, gscale, gbias, A, Ainv, w1, b1, w2, b2,
                                    stats, z, h, o, out, B, HW, C, K, nb, groups, s);
}
