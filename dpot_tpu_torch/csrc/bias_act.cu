// Fused bias + activation + gain + clamp for Hopper (sm_90a).
//
// Replaces the TPU kernel `bias_act_pallas` in
// dpot_tpu/ops/pallas/bias_act_kernel.py (`_kernel`, launched in 256-row
// tiles). For channels-last x (N, C) and a bias b (C) or none it computes
//
//     out = clamp(act(x + b[c], alpha) * gain, -clamp, clamp)
//
// with one of the nine activations of the reference plugin (linear, relu,
// lrelu, tanh, sigmoid, elu, selu, softplus, swish), in f32 registers,
// rounded once to the element type T (f32 or bf16) on the store.
//
// What bounds it on this card: every element is read once and written once
// and costs a few dozen operations at most, so the pass is bound by device
// memory bytes (2 N C sizeof(T) over 3.35 TB/s). The design follows: one
// grid-stride pass in which each thread moves 16 bytes per load and per
// store (4 f32 or 8 bf16 values), neighbouring threads on neighbouring
// addresses. The bias is small and stays in L1/L2; alpha, gain and clamp are
// kernel arguments held in registers. When C is not a multiple of the vector
// width, or a pointer is not 16-byte aligned, the kernel takes the same pass
// element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

enum Act { LINEAR, RELU, LRELU, TANH, SIGMOID, ELU, SELU, SOFTPLUS, SWISH };

template <int A> __device__ __forceinline__ float activate(float x, float alpha) {
  if constexpr (A == LINEAR) return x;
  if constexpr (A == RELU) return x > 0.f ? x : 0.f;
  if constexpr (A == LRELU) return x >= 0.f ? x : alpha * x;
  if constexpr (A == TANH) return tanhf(x);
  if constexpr (A == SIGMOID) return 1.f / (1.f + expf(-x));
  if constexpr (A == ELU) return x > 0.f ? x : expm1f(x);
  if constexpr (A == SELU)
    return 1.0507009873554804934f * (x > 0.f ? x : 1.6732632423543772848f * expm1f(x));
  if constexpr (A == SOFTPLUS) return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
  if constexpr (A == SWISH) return x / (1.f + expf(-x));
  return x;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

struct Params {
  float alpha, gain, clamp;
};

template <int A, typename T>
__device__ __forceinline__ T apply(T v, const T* __restrict__ b, int c, Params p) {
  float x = to_f32(v);
  if (b) x += to_f32(b[c]);
  x = activate<A>(x, p.alpha) * p.gain;
  if (p.clamp >= 0.f) x = fminf(fmaxf(x, -p.clamp), p.clamp);
  return from_f32<T>(x);
}

// VEC elements of T make one 16-byte access
template <typename T> struct alignas(16) Pack {
  static constexpr int VEC = 16 / sizeof(T);
  T v[VEC];
};

template <int A, typename T, bool VECTOR>
__global__ void __launch_bounds__(256)
bias_act_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ out,
                int64_t n, int C, Params p) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (VECTOR) {
    constexpr int VEC = Pack<T>::VEC;
    // C % VEC == 0, so the VEC channels of a pack never wrap around C
    const int64_t nvec = n / VEC;
    for (int64_t i = tid; i < nvec; i += stride) {
      Pack<T> in = reinterpret_cast<const Pack<T>*>(x)[i];
      const int c0 = (int)((i * VEC) % C);
      Pack<T> res;
#pragma unroll
      for (int k = 0; k < VEC; ++k) res.v[k] = apply<A>(in.v[k], b, c0 + k, p);
      reinterpret_cast<Pack<T>*>(out)[i] = res;
    }
  } else {
    for (int64_t i = tid; i < n; i += stride)
      out[i] = apply<A>(x[i], b, (int)(i % C), p);
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <int A, typename T>
cudaError_t launch(const void* x, const void* b, void* out, int64_t n, int C, Params p,
                   cudaStream_t s) {
  constexpr int VEC = Pack<T>::VEC;
  const bool vector = C % VEC == 0 && aligned16(x) && aligned16(out);
  const int64_t items = vector ? n / VEC : n;
  // a few waves of 256-thread blocks over 132 SMs; the loop covers the rest
  const int64_t blocks = (items + 255) / 256;
  const int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  if (vector)
    bias_act_kernel<A, T, true><<<grid, 256, 0, s>>>(xt, bt, ot, n, C, p);
  else
    bias_act_kernel<A, T, false><<<grid, 256, 0, s>>>(xt, bt, ot, n, C, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int act, const void* x, const void* b, void* out, int64_t n, int C,
                     Params p, cudaStream_t s) {
  switch (act) {
    case LINEAR: return launch<LINEAR, T>(x, b, out, n, C, p, s);
    case RELU: return launch<RELU, T>(x, b, out, n, C, p, s);
    case LRELU: return launch<LRELU, T>(x, b, out, n, C, p, s);
    case TANH: return launch<TANH, T>(x, b, out, n, C, p, s);
    case SIGMOID: return launch<SIGMOID, T>(x, b, out, n, C, p, s);
    case ELU: return launch<ELU, T>(x, b, out, n, C, p, s);
    case SELU: return launch<SELU, T>(x, b, out, n, C, p, s);
    case SOFTPLUS: return launch<SOFTPLUS, T>(x, b, out, n, C, p, s);
    case SWISH: return launch<SWISH, T>(x, b, out, n, C, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, b (C, or null) and out (n elements, C the last extent) are of one type:
// bf16 when is_bf16, else f32. clamp < 0 means no clamp. Returns the launch's
// CUDA error (cudaErrorInvalidValue for an unknown activation or a bad size).
extern "C" int dpot_bias_act(int is_bf16, int act, const void* x, const void* b,
                             void* out, long long n, int C, float alpha, float gain,
                             float clamp, void* stream) {
  if (n <= 0 || C <= 0 || n % C) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{alpha, gain, clamp};
  return is_bf16 ? dispatch<bf16>(act, x, b, out, n, C, p, s)
                 : dispatch<float>(act, x, b, out, n, C, p, s);
}
