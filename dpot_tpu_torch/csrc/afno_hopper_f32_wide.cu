// Fused GroupNorm + AFNO spectral mixer in f32 for AFNO blocks of 256
// channels (DPOT-H), designed for Hopper (sm_90a): every product as 3xTF32
// on the tensor cores, two launches, z and h kept on chip.
//
// Replaces, for f32 operands at the shapes that `hopper_f32_wide_supported`
// (dpot_tpu_torch/ops/cuda/afno_fused.py) admits, the TPU kernel
// `fused_gn_afno` of dpot_tpu/ops/pallas/afno_fused.py (`_kernel`, launched
// by `_fused_fwd`, line 114). It is afno_hopper_f32.cu's design at
// 256-channel blocks, and computes and rounds what that kernel does; its
// arithmetic (the register split, each depth-8 step's three products
// summed from zero, the f32 promotion), cp.async and the synthesis launch
// are that file's own, included below. Its header comment says why each
// is as it is.
//
// What bounds it. At DPOT-H (HW 256, C 2048, K 144, nb 8, bs 256) a sample
// is 1812 MFLOP, 5.4 GFLOP of TF32 work once split: 302 MFLOP each for the
// analysis and the synthesis, 1208 for the block MLP, whose weights are
// four times the 128-channel kernel's per block. A spectral CTA streams 2 x
// 256 KB of each layer's weights from L2, so a sample reads about 40 MB of
// weights from L2 at 32-mode chunks (5 chunks x 8 blocks x 1 MB), against
// 5.4 GFLOP of TF32 work: at B >= 2 the tensor cores' operations bound it
// before the L2's bytes; at B = 1 the grid of 72 CTAs is bound by latency.
//
// What differs at 256-channel blocks:
//   - a spectral CTA is 16 warps (512 threads): the real and imaginary
//     halves, each eight 32-column warp tiles (256 = 8 x 32), so a warp's
//     tile and fragment code are the 128-channel kernel's; one CTA an SM
//     (the register file's 64 K at 128 a thread, and 206,592 bytes of
//     shared memory);
//   - the padded strides keep their bank residues (LDX 264 = 8 and LDZ 516
//     = 4 mod 32, as 136 and 260 at 128), so every fragment load stays free
//     of bank conflicts;
//   - GroupNorm(8) over DPOT-H's 2048 channels makes groups of 256, one
//     block each; the gate admits groups of 8 to 256 channels (a power of
//     two, inside one block). Each CTA computes its block's statistics
//     from L2, as the 128-channel kernel does, each thread a fixed
//     4-channel column (64 columns) over every 8th row, the groups'
//     sums taken across warps, since a group of 256 channels spans both
//     halves of the block's columns.
// Warp-tile height MT is chosen as afno_hopper_f32.cu chooses it: MT = 1
// when the grid at 16-mode chunks has no more CTAs than the card has SMs
// (H at B = 1: 9 x 8 = 72 CTAs).

#define AFNO_HOPPER_F32_PARTS
#include "afno_hopper_f32.cu"

namespace {
namespace w256 {  // the names below hide afno_hopper_f32.cu's 128-channel ones

constexpr int BS = 256;          // AFNO block size, the only one admitted
constexpr int WPH = BS / 32;     // warps per output half
constexpr int NT = 2 * WPH * 32; // threads per spectral CTA: 16 warps
constexpr int MAX_MC = 32;       // modes per spectral CTA at MT = 2
constexpr int LDX = BS + 8;      // x and weight tiles [KC][LDX]
constexpr int LDZ = 2 * BS + 4;  // z and h [MC][LDZ]
constexpr int COLS = BS / 4;     // 4-channel columns of the statistics pass
constexpr int RSTEP = NT / COLS; // rows a pass of the statistics covers

// spectral_f32_wide_kernel's shared memory, in floats
constexpr int STAGE = 2 * KC * LDX;        // the larger of a W stage and an x + A stage
static_assert(KC * LDX + 2 * MAX_MC * LDA <= STAGE, "an x + A stage must fit a ring slot");
constexpr int F_Z = 2 * STAGE;             // z, then h
constexpr int F_COL = F_Z + MAX_MC * LDZ;  // per-channel mean, rstd * gscale, gbias
constexpr int F_RED = F_COL + 3 * BS;      // reduction scratch: 16 warps x 32
constexpr int F_GRP = F_RED + NT;          // group sums: 2 x 32
constexpr int SPECTRAL_SMEM = (F_GRP + 64) * 4;
static_assert(SPECTRAL_SMEM <= 232448, "a CTA may use 227 KB of shared memory");

// Sum of v over the threads of each GroupNorm group of the block into
// out[group]: thread t holds the 4-channel column t % 64, so warp w the
// columns 32 (w % 2) .. + 31; gsz neighbouring columns form a group (a
// power of two from 2 to 64), ng groups. red: NT floats.
__device__ void block_group_sum(float v, int gsz, int ng, float* red, float* out) {
  const int gl = gsz < 32 ? gsz : 32;  // a group's lanes within one warp
  for (int o = 1; o < gl; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane % gl == 0) red[warp * 32 + lane / gl] = v;
  __syncthreads();
  if (threadIdx.x < ng) {
    const int c0 = threadIdx.x * gsz;  // the group's first column
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w)  // the warps that hold some of the group's columns
      if (gsz > 32 || (w & 1) == c0 / 32) s += red[w * 32 + (c0 % 32) / gl];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Rows 32 ci .. 32 ci + 31 of block j's wr and wi ([part][32 rows][256])
// into a ring slot.
__device__ __forceinline__ void load_w_chunk(float* slot, const float* w, int j, int nb, int ci) {
  for (int q = threadIdx.x; q < 2 * KC * (BS / 4); q += NT) {
    const int p = q / (KC * BS / 4), r = (q / (BS / 4)) % KC, c4 = q % (BS / 4);
    cp16(slot + (p * KC + r) * LDX + 4 * c4,
         w + ((static_cast<size_t>(p) * nb + j) * BS + KC * ci + r) * BS + 4 * c4, true);
  }
}

// One complex MLP layer of block j for the CTA's 16 MT modes, as in
// afno_hopper_f32.cu: acc = [a_re | a_im] . [[wr, wi], [-wi, wr]] for the
// warp's 32 output columns, a in zb [16 MT][LDZ], w the layer's weights
// (2, nb, bs, bs) streamed in 32-row chunks through ring slots 0 and 1,
// whose first chunk is already in flight.
template <int MT>
__device__ __forceinline__ void complex_layer(WarpAcc<MT>& acc, float* sm, const float* zb,
                                              const float* w, int j, int nb) {
  const int warp = threadIdx.x >> 5, po = warp / WPH, o0 = 32 * (warp % WPH);
  const int g = lane_g(), t = lane_t();
  zero(acc);
  constexpr int NCH = BS / KC;
  for (int ci = 0; ci < NCH; ++ci) {
    if (ci + 1 < NCH) {
      load_w_chunk(sm + ((ci + 1) & 1) * STAGE, w, j, nb, ci + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* ws = sm + (ci & 1) * STAGE;
#pragma unroll
    for (int sp = 0; sp < 2; ++sp) {
      // source half sp of [a_re | a_im] meets wr when it matches the
      // output half po, else wi, negated for the real output
      const float* wt = ws + (sp == po ? 0 : KC * LDX);
      const float sign = (po == 0 && sp == 1) ? -1.f : 1.f;
      const float* at = zb + sp * BS + KC * ci;
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        mma_k8<MT>(
            acc,
            [&](int mt, int h, int q) { return at[(16 * mt + g + 8 * h) * LDZ + 8 * kk + t + 4 * q]; },
            [&](int nt, int q) { return sign * wt[(8 * kk + t + 4 * q) * LDX + o0 + 8 * nt + g]; });
      }
    }
    __syncthreads();  // the slot is free for the chunk after next
  }
}

// grid (ceil(K / MC), nb, B), MC = 16 MT: modes chunk * MC .. + MC - 1 of
// AFNO block j of sample b, from x (B, HW, C) and A (2K, HWp) to o (B, 2K,
// C); K even (the padded Kp, as in afno_hopper_f32.cu). stats (B, groups,
// 2) gets the GroupNorm mean and 1/std of the block's groups from the
// chunk-0 CTA. ACT is the mode MLP's activation (an ActId).
template <int ACT, int MT>
__global__ void __launch_bounds__(NT, 1)
spectral_f32_wide_kernel(const float* __restrict__ x, const float* __restrict__ gscale,
                         const float* __restrict__ gbias, const float* __restrict__ A,
                         const float* __restrict__ w1, const float* __restrict__ b1,
                         const float* __restrict__ w2, const float* __restrict__ b2,
                         float* __restrict__ stats, float* __restrict__ o, int HW, int HWp,
                         int C, int K, int nb, int groups) {
  constexpr int MC = 16 * MT;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int chunk = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int m0 = chunk * MC;
  const int g = lane_g(), t = lane_t();
  const float* xb = x + static_cast<size_t>(b) * HW * C + j * BS;

  // ring slot s of the z phase: load_z_chunk (afno_hopper_f32.cu)
  auto load_z_stage = [&](int s, int kc) {
    load_z_chunk<BS, LDX, NT, MC>(sm + s * STAGE, xb, A, kc, m0, HW, HWp, C, K);
  };
  load_z_stage(0, 0);
  cp_commit();

  // GroupNorm statistics of the block's groups, one pass from L2: thread
  // tid owns channels 4 (tid % COLS) .. + 3 of rows tid / COLS, + RSTEP,
  // ... below HW; its mean m and sum q of squared deviations (shifted by
  // its first value) combine into each group's mean and variance (Chan's
  // pairwise rule, weighted by its count cnt).
  const int cpg = C / groups, gsz = cpg / 4, ng = BS / cpg;
  float* s_mean = sm + F_COL;
  float* s_rs = s_mean + BS;
  float* s_bi = s_rs + BS;
  float* red = sm + F_RED;
  float* s_sum = sm + F_GRP;
  float* s_dev = s_sum + 32;
  const float n = static_cast<float>(HW) * cpg;  // a group's values
  float cnt, m, q;
  column_stats(xb + 4 * (tid % COLS), C, tid / COLS, RSTEP, HW, cnt, m, q);
  block_group_sum(m * cnt, gsz, ng, red, s_sum);
  const int grp = (tid % COLS) / gsz;
  const float mean = s_sum[grp] / n;
  block_group_sum(q + cnt * (m - mean) * (m - mean), gsz, ng, red, s_dev);
  if (tid < BS) {
    const int gc = tid / cpg;
    const float gm = s_sum[gc] / n, rstd = rsqrtf(s_dev[gc] / n + EPS);
    s_mean[tid] = gm;
    s_rs[tid] = rstd * __ldg(gscale + j * BS + tid);
    s_bi[tid] = __ldg(gbias + j * BS + tid);
    if (chunk == 0 && tid % cpg == 0) {
      float* st = stats + 2 * (b * groups + j * ng + gc);
      st[0] = gm;
      st[1] = rstd;
    }
  }
  __syncthreads();

  // z = A . xn: warp w computes rows MC (w / WPH) .. of [re; im] (the real
  // or imaginary parts of the MC modes) by channels 32 (w % WPH) ..
  const int rb = MC * (warp / WPH), cb = 32 * (warp % WPH);
  float nm[4], nr[4], nbias[4];  // GroupNorm of this thread's B-fragment columns
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = cb + 8 * nt + g;
    nm[nt] = s_mean[c];
    nr[nt] = s_rs[c];
    nbias[nt] = s_bi[c];
  }
  WarpAcc<MT> acc;
  zero<MT>(acc);
  const int nkc = HWp / KC;
  for (int kc = 0; kc < nkc; ++kc) {
    if (kc + 1 < nkc) {
      load_z_stage((kc + 1) & 1, kc + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* xs = sm + (kc & 1) * STAGE;
    const float* as = xs + KC * LDX;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      mma_k8<MT>(
          acc,
          [&](int mt, int h, int q) { return as[(rb + 16 * mt + g + 8 * h) * LDA + 8 * kk + t + 4 * q]; },
          [&](int nt, int q) {
            const float v = xs[(8 * kk + t + 4 * q) * LDX + cb + 8 * nt + g];
            return (v - nm[nt]) * nr[nt] + nbias[nt];
          });
    }
    __syncthreads();
  }

  // z to shared memory as [z_re | z_im] per mode; the first W1 chunk loads
  load_w_chunk(sm, w1, j, nb, 0);
  cp_commit();
  float* zb = sm + F_Z;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h, c = (rb ? BS : 0) + cb + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(zb + r * LDZ + c) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  __syncthreads();

  // h = act([z_re | z_im] . W1 + B1), over z. Warp w: output half w / WPH
  // (re, im), columns 32 (w % WPH) .. of it.
  const int po = warp / WPH, o0 = 32 * (warp % WPH);
  complex_layer<MT>(acc, sm, zb, w1, j, nb);
  load_w_chunk(sm, w2, j, nb, 0);
  cp_commit();
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = o0 + 8 * nt + 2 * t;
    const float bb0 = __ldg(b1 + (po * nb + j) * BS + c), bb1 = __ldg(b1 + (po * nb + j) * BS + c + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h;
        *reinterpret_cast<float2*>(zb + r * LDZ + po * BS + c) =
            make_float2(activate<ACT>(acc[mt][nt][2 * h] + bb0),
                        activate<ACT>(acc[mt][nt][2 * h + 1] + bb1));
      }
  }
  __syncthreads();

  // o = [h_re | h_im] . W2 + B2, to device memory (rows past K dropped)
  complex_layer<MT>(acc, sm, zb, w2, j, nb);
  float* ob = o + (static_cast<size_t>(b) * 2 * K + (po ? K : 0)) * C + j * BS;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = o0 + 8 * nt + 2 * t;
    const float bb0 = __ldg(b2 + (po * nb + j) * BS + c), bb1 = __ldg(b2 + (po * nb + j) * BS + c + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mode = m0 + 16 * mt + g + 8 * h;
        if (mode < K)
          *reinterpret_cast<float2*>(ob + static_cast<size_t>(mode) * C + c) =
              make_float2(acc[mt][nt][2 * h] + bb0, acc[mt][nt][2 * h + 1] + bb1);
      }
  }
}

// Lets spectral_f32_wide_kernel<ACT, MT> and synthesis_f32_kernel<MT> use
// the dynamic shared memory they need, once per device.
template <int ACT, int MT> cudaError_t allow_smem(int dev) {
  static bool done[64] = {};
  if (dev < 64 && done[dev]) return cudaSuccess;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(spectral_f32_wide_kernel<ACT, MT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, SPECTRAL_SMEM)) !=
          cudaSuccess ||
      (e = cudaFuncSetAttribute(synthesis_f32_kernel<MT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, SYN_SMEM)) !=
          cudaSuccess)
    return e;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

// Both launches at warp-tile height MT, on stream s; K is the padded Kp.
template <int ACT, int MT>
cudaError_t launch(int dev, const float* x, const float* gscale, const float* gbias,
                   const float* A, const float* Ainv, const float* w1, const float* b1,
                   const float* w2, const float* b2, float* stats, float* o, float* out, int B,
                   int HW, int C, int K, int nb, int groups, cudaStream_t s) {
  constexpr int MC = 16 * MT, TP = 32 * MT;
  const int HWp = padded_hw(HW);
  cudaError_t e;
  if ((e = allow_smem<ACT, MT>(dev)) != cudaSuccess) return e;
  spectral_f32_wide_kernel<ACT, MT><<<dim3((K + MC - 1) / MC, nb, B), NT, SPECTRAL_SMEM, s>>>(
      x, gscale, gbias, A, w1, b1, w2, b2, stats, o, HW, HWp, C, K, nb, groups);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  synthesis_f32_kernel<MT><<<dim3(HWp / TP, C / TC, B), NT_SYN, SYN_SMEM, s>>>(
      Ainv, o, x, stats, gscale, gbias, out, HW, C, K, groups);
  return cudaGetLastError();
}

}  // namespace w256
}  // namespace

// The shapes this kernel takes, as `hopper_f32_wide_supported` in
// dpot_tpu_torch/ops/cuda/afno_fused.py states them (the dtype is f32).
extern "C" int dpot_afno_hopper_f32_wide_supported(int B, int HW, int C, int K, int nb,
                                                   int groups) {
  if (B < 1 || B > 65535 || nb < 1 || C != nb * w256::BS || groups < 1 || C % groups) return 0;
  if (HW < 1 || HW > MAX_HW || K < 1) return 0;
  const int cpg = C / groups;
  return cpg >= 8 && cpg <= w256::BS && (cpg & (cpg - 1)) == 0;
}

// x, out (B, HW, C), A (2Kp, HWp), Ainv (HWp, 2Kp) (padded as
// dpot_afno_hopper_f32 states), w1/w2 (2, nb, bs, bs) in the reference
// layout, gscale/gbias (C), b1/b2 (2, nb, bs), the stats scratch (B *
// groups * 2) and the o scratch (B, 2Kp, C), all f32. act is an ActId.
// Returns 0 or a CUDA error.
extern "C" int dpot_afno_hopper_f32_wide(int act, const float* x, const float* gscale,
                                         const float* gbias, const float* A, const float* Ainv,
                                         const float* w1, const float* b1, const float* w2,
                                         const float* b2, float* stats, float* o, float* out,
                                         int B, int HW, int C, int K, int nb, int groups,
                                         void* stream) {
  if (!dpot_afno_hopper_f32_wide_supported(B, HW, C, K, nb, groups) || act < 0 ||
      act >= ACT_COUNT)
    return cudaErrorInvalidValue;
  const void* ptrs[] = {x, A, Ainv, w1, w2, o, out};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  static int sm_count[64] = {};  // the device's SMs, asked once
  int sms = dev < 64 ? sm_count[dev] : 0;
  if (!sms) {
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    if (dev < 64) sm_count[dev] = sms;
  }
  const int Kp = padded_k(K);
  const bool small = static_cast<long long>((Kp + 15) / 16) * nb * B <= sms;
  return dispatch_act(act, [&](auto tag) {
    constexpr int ACT = decltype(tag)::id;
    return small ? w256::launch<ACT, 1>(dev, x, gscale, gbias, A, Ainv, w1, b1, w2, b2, stats,
                                        o, out, B, HW, C, Kp, nb, groups, s)
                 : w256::launch<ACT, 2>(dev, x, gscale, gbias, A, Ainv, w1, b1, w2, b2, stats,
                                        o, out, B, HW, C, Kp, nb, groups, s);
  });
}
