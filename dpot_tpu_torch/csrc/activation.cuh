// Activations of the AFNO mode MLP, shared by afno_fused.cu and
// afno_hopper.cu. The ids are those of ACT_IDS in
// dpot_tpu_torch/ops/cuda/afno_fused.py, and each function is the one the
// registry dpot_tpu_torch/ops/activations.py names, computed in f32.
#pragma once

enum ActId {
  ACT_GELU_TANH = 0,   // gelu under bf16 (and the TPU kernel)
  ACT_GELU_ERF = 1,    // gelu under f32
  ACT_TANH = 2,
  ACT_SIGMOID = 3,
  ACT_RELU = 4,
  ACT_LEAKY_RELU = 5,  // negative slope 0.1
  ACT_SOFTPLUS = 6,
  ACT_ELU = 7,
  ACT_SILU = 8,
  ACT_COUNT = 9,
};

template <int ACT> __device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == ACT_GELU_TANH) {
    // 0.5 v (1 + tanh(u)) = v / (1 + exp(-2 u)): one fast exponential and
    // one division instead of tanhf, within about 1e-6 relative of it
    const float k = 2.0f * 0.7978845608028654f;  // 2 sqrt(2 / pi)
    return __fdividef(v, 1.0f + __expf(-k * (v + 0.044715f * v * v * v)));
  } else if constexpr (ACT == ACT_GELU_ERF) {
    return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
  } else if constexpr (ACT == ACT_TANH) {
    return tanhf(v);
  } else if constexpr (ACT == ACT_SIGMOID) {
    return 1.0f / (1.0f + expf(-v));
  } else if constexpr (ACT == ACT_RELU) {
    return fmaxf(v, 0.0f);
  } else if constexpr (ACT == ACT_LEAKY_RELU) {
    return v > 0.0f ? v : 0.1f * v;
  } else if constexpr (ACT == ACT_SOFTPLUS) {
    return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
  } else if constexpr (ACT == ACT_ELU) {
    return v > 0.0f ? v : expm1f(v);
  } else {
    static_assert(ACT == ACT_SILU, "unknown activation id");
    return v / (1.0f + expf(-v));
  }
}

// On the host, f(ActTag<id>{}) for the runtime id act (< ACT_COUNT,
// checked by the caller): one kernel instance per activation.
template <int ACT> struct ActTag { static constexpr int id = ACT; };

template <typename F> auto dispatch_act(int act, F&& f) {
  switch (act) {
    case ACT_GELU_TANH: return f(ActTag<ACT_GELU_TANH>{});
    case ACT_GELU_ERF: return f(ActTag<ACT_GELU_ERF>{});
    case ACT_TANH: return f(ActTag<ACT_TANH>{});
    case ACT_SIGMOID: return f(ActTag<ACT_SIGMOID>{});
    case ACT_RELU: return f(ActTag<ACT_RELU>{});
    case ACT_LEAKY_RELU: return f(ActTag<ACT_LEAKY_RELU>{});
    case ACT_SOFTPLUS: return f(ActTag<ACT_SOFTPLUS>{});
    case ACT_ELU: return f(ActTag<ACT_ELU>{});
    default: return f(ActTag<ACT_SILU>{});
  }
}
