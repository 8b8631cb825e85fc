// Fused GroupNorm + AFNO spectral mixer in bf16, designed for Hopper
// (sm_90a): wgmma fed by TMA, two launches, z and h kept on chip.
//
// Replaces, for bf16 operands at the shapes that `hopper_supported`
// (dpot_tpu_torch/ops/cuda/afno_fused.py) admits, the TPU kernel
// `fused_gn_afno` of dpot_tpu/ops/pallas/afno_fused.py (`_kernel`, launched
// by `_fused_fwd`). It computes what afno_fused.cu computes and rounds at
// the same points: GroupNorm in f32 (eps 1e-5), z = A . round(xn), per AFNO
// block j h = round(act([z_re | z_im] . W1_j + B1_j)), o = round(h . W2_j +
// B2_j), out = round(Ainv . o + xn) with xn in f32.
//
// What bounds it. At DPOT-Ti (HW 256, C 512, K 144, nb 4, bs 128) a sample
// is 302 MFLOP of bf16 products against 0.7 MB of operands, so from B ~ 2
// up it is bound by tensor-core operations; at B = 1 by latency. The
// five-launch kernel of afno_fused.cu ran 64 x 64 mma.sync tiles and sent
// z, h and o through device memory. Here the work is cut by AFNO block j,
// since GroupNorm groups, the mode MLP and its weights all live inside one
// block of bs = 128 channels:
//
//   1. spectral_kernel, one CTA per (chunk of 64 modes, block j, sample b):
//      TMA brings the x slab x[b, :, j bs : (j+1) bs] (HW x 128), the
//      chunk's rows of A (re and im) and the block's W1 into shared memory;
//      the CTA computes the f32 GroupNorm statistics of the groups in the
//      slab in one pass (each thread's mean and squared deviations,
//      combined pairwise) and rewrites the slab in place as round(xn);
//      z = A . xn by wgmma goes to shared memory as the MLP's A operand
//      [z_re | z_im]; both MLP layers run by wgmma with h in shared memory
//      (in the bytes z held); o leaves by a TMA store into (B, 2K, C), the
//      only trip an intermediate makes. W2 streams into the bytes of the
//      slab once z is done. The statistics go to a small scratch.
//   2. tma_synthesis_kernel, one CTA per (128 pixels, 128 channels, sample b):
//      out = Ainv . o by wgmma from TMA-loaded tiles, with an epilogue that
//      adds the f32 xn recomputed from the x tile and the statistics; out
//      leaves by a TMA store. It is a programmatic dependent launch: its
//      Ainv rows and x tile load while launch 1 finishes.
//
// Each CTA is two warpgroups; thread 0 issues every TMA load at the start
// (all operands fit in shared memory at once, so there is no ring to
// recycle), one mbarrier per operand tile, and the warpgroups wait on the
// tile they need next. Warpgroup w computes the real (w = 0) or imaginary
// (w = 1) half of each product: the complex block weights are used as
// they are, h_re = z_re.wr - z_im.wi and h_im = z_re.wi + z_im.wr, with the
// minus through wgmma's imm-scale-b = -1, so a CTA reads 2 x 32 KB of each
// weight instead of the 128 KB of the real form. The weights arrive as
// bf16 copies, each block transposed to (out, in), made by the wrapper and
// cached until the parameter changes (TMA cannot convert f32 to bf16).
//
// The PTX wrappers, the synthesis launch and the tensor maps live in
// hopper_tma.cuh, shared with afno_hopper_wide.cu (blocks of 256 channels).

#include "activation.cuh"
#include "hopper_tma.cuh"

namespace {

constexpr int BS = 128;        // AFNO block size, the only one admitted
constexpr int NT = 256;        // threads per CTA: two warpgroups
constexpr int MODES = 64;      // modes per spectral CTA
constexpr int MAX_HW = 256;    // the x slab and the A rows fit at most this
constexpr float EPS = 1e-5f;   // torch.nn.GroupNorm default

// spectral_kernel's shared memory, byte offsets from a 1024-aligned base
constexpr int S_X = 0;          // xn [2 halves][HW][64]; then W2 [2][2][128][64]
constexpr int S_A = 65536;      // A rows [2 parts][HW / 64][64][64]
constexpr int S_W1 = 131072;    // W1 [2 parts][2 k-blocks][128][64]
constexpr int S_ZH = 196608;    // z, then h: [4 k-blocks][64][64]
constexpr int S_MISC = 229376;  // 7 mbarriers, reduction scratch, statistics
constexpr int SPECTRAL_SMEM = S_MISC + 1024 + 1024;  // + alignment slack
enum { BAR_X = 0, BAR_A = 1, BAR_W1 = 5, BAR_W2 = 6 };
constexpr int ACT_NONE = -1;

// The 32 bias values of a thread's accumulator columns (acc_col(i) + e).
struct Bias {
  float v[32];
  __device__ __forceinline__ void load(const float* bias) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[2 * i] = __ldg(bias + acc_col(i));
      v[2 * i + 1] = __ldg(bias + acc_col(i) + 1);
    }
  }
};

// This warpgroup's accumulator (+ bias when BIAS, through ACT unless
// ACT_NONE), rounded to bf16, into k-blocks 2 wg and 2 wg + 1 of the
// swizzled tile zh [4][64][64]: the warpgroup's half of [z_re | z_im] or
// [h_re | h_im], or its two 64 x 64 boxes of o for the TMA store.
template <int ACT, bool BIAS>
__device__ __forceinline__ void store_half(uint8_t* zh, const Acc& acc, const Bias& bias,
                                           int wg) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = acc_col(i), kb = 2 * wg + (col >> 6), cc = col & 63;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = acc_row(h);
      float v0 = acc.d[4 * i + 2 * h], v1 = acc.d[4 * i + 2 * h + 1];
      if constexpr (BIAS) {
        v0 += bias.v[2 * i];
        v1 += bias.v[2 * i + 1];
      }
      if constexpr (ACT != ACT_NONE) {
        v0 = activate<ACT>(v0);
        v1 = activate<ACT>(v1);
      }
      uint8_t* p = zh + kb * 8192 + r * 128 + (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2;
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// One complex MLP layer of one block, computed by warpgroup WG: acc =
// WG's half of [a_re | a_im] . W, with a the K-major tile [4][64][64] at
// a_base and W the weight tiles [part][k-block][128 out][64 in] at w_base
// (part 0 = wr, 1 = wi), once barrier bar says W has landed. Real half
// (WG 0): a_re.wr - a_im.wi; imaginary (WG 1): a_re.wi + a_im.wr. The
// layer's bias for WG's columns loads into `b` while the products run.
// The warpgroup is a template argument so that the sign of the second
// term is an immediate and no wgmma sits on a path that depends on the
// thread (ptxas would serialise them).
template <int WG>
__device__ __forceinline__ void complex_layer(Acc& acc, uint32_t a_base, uint32_t w_base,
                                              uint32_t bar, const float* bias, Bias& b) {
  mbar_wait(bar, 0);
  acc.zero();
  acc.fence();
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const int part = kb < 2 ? WG : 1 - WG;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = desc_k(a_base + kb * 8192 + kk * 32);
      const uint64_t w = desc_k(w_base + (part * 2 + (kb & 1)) * 16384 + kk * 32);
      if (kb >= 2 && WG == 0) acc.mma<-1, 0>(a, w);
      else acc.mma<1, 0>(a, w);
    }
  }
  wgmma_commit();
  b.load(bias);
  wgmma_wait_all();
  acc.fence();
}

// Sum of v over the threads of each GroupNorm group of the slab into
// out[group]. Thread t holds the 8-channel chunk column t % 16 of the slab;
// gsz chunks form a group (a power of two up to 16), so a group is gsz
// neighbouring lanes. red: 16 floats per warp.
__device__ void slab_group_sum(float v, int gsz, int ng, float* red, float* out) {
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  for (int o = 1; o < gsz; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < 16 && lane % gsz == 0) red[warp * 16 + lane / gsz] = v;
  __syncthreads();
  if (threadIdx.x < ng) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += red[w * 16 + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// grid (ceil(K / 64), nb, B): modes chunk * 64 .. + 63 of AFNO block j of
// sample b, from x to o (stored through map_os, which views o as (2B, K, C)
// so that TMA drops the rows past the last mode). stats (B, groups, 2) gets
// the GroupNorm mean and 1/std of the block's groups from the chunk-0 CTA.
// ACT is the mode MLP's activation (an ActId).
template <int ACT>
__global__ void __launch_bounds__(NT, 1)
spectral_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_w1,
                const __grid_constant__ CUtensorMap map_w2,
                const __grid_constant__ CUtensorMap map_os, const float* __restrict__ gscale,
                const float* __restrict__ gbias, const float* __restrict__ b1,
                const float* __restrict__ b2, float* __restrict__ stats, int HW, int C, int nb,
                int groups) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int chunk = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int nkx = HW / 64;
  auto bar = [&](int i) { return base + S_MISC + 8 * i; };

  // the synthesis may take SMs that this grid leaves free; it waits for
  // this grid's o and statistics before it reads them
  launch_dependents();
  if (tid == 0) {
    for (int i = 0; i <= BAR_W2; ++i) mbar_init(bar(i), 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar(BAR_X), 2 * HW * 128);
    for (int h = 0; h < 2; ++h)
      tma_load_3d(base + S_X + h * HW * 128, &map_x, bar(BAR_X), j * BS + h * 64, 0, b);
    for (int kb = 0; kb < nkx; ++kb) {
      mbar_expect_tx(bar(BAR_A + kb), 2 * 8192);
      for (int p = 0; p < 2; ++p)
        tma_load_3d(base + S_A + (p * nkx + kb) * 8192, &map_a, bar(BAR_A + kb), kb * 64,
                    chunk * MODES, p);
    }
    mbar_expect_tx(bar(BAR_W1), 65536);
    for (int p = 0; p < 2; ++p)
      for (int ib = 0; ib < 2; ++ib)
        tma_load_4d(base + S_W1 + (p * 2 + ib) * 16384, &map_w1, bar(BAR_W1), ib * 64, 0, j, p);
  }

  // GroupNorm of the slab, in place. Thread tid owns 8-channel chunk column
  // lc of rows tid / 16, tid / 16 + 16, ...; chunk (p, lc) sits at 16-byte
  // position (lc % 8) ^ (p % 8) of row p of half lc / 8 (the swizzle).
  const int cpg = C / groups, gsz = cpg / 8, ng = BS / cpg;
  const int lc = tid & 15, g = lc / gsz;
  float* red = reinterpret_cast<float*>(sm + S_MISC + 64);
  float* s_sum = reinterpret_cast<float*>(sm + S_MISC + 576);
  float* s_dev = s_sum + 16;
  auto slab = [&](int p) {
    return reinterpret_cast<uint4*>(sm + S_X + (lc >> 3) * HW * 128 + p * 128 +
                                    (((lc & 7) ^ (p & 7)) << 4));
  };
  const float n = static_cast<float>(HW) * cpg, cnt = 8.f * (HW / 16), per_group = 16.f * gsz;
  float sc[8], bi[8];  // the affine of this thread's 8 channels, fetched while x lands
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sc[e] = __ldg(gscale + j * BS + lc * 8 + e);
    bi[e] = __ldg(gbias + j * BS + lc * 8 + e);
  }
  mbar_wait(bar(BAR_X), 0);
  // One pass over the slab: each thread's mean m and sum q of squared
  // deviations over its cnt values (shifted by its first value, eight
  // partial sums, rows unrolled), then the groups' mean from the m and
  // their variance from q + cnt (m - mean)^2 (Chan's pairwise combination,
  // as exact as two passes).
  float m, q;
  {
    float f0[8];
    unpack8(*slab(tid >> 4), f0);
    const float shift = f0[0];
    float p1[8] = {}, p2[8] = {};
#pragma unroll 4
    for (int p = tid >> 4; p < HW; p += 16) {
      float f[8];
      unpack8(*slab(p), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = f[e] - shift;
        p1[e] += d;
        p2[e] += d * d;
      }
    }
    const float s1 = sum8(p1);
    m = shift + s1 / cnt;
    q = sum8(p2) - s1 * s1 / cnt;
  }
  slab_group_sum(m, gsz, ng, red, s_sum);
  const float mean = s_sum[g] / per_group;
  slab_group_sum(q + cnt * (m - mean) * (m - mean), gsz, ng, red, s_dev);
  const float rstd = rsqrtf(s_dev[g] / n + EPS);
  if (chunk == 0 && tid < ng) {
    float* st = stats + 2 * (b * groups + j * ng + tid);
    st[0] = s_sum[tid] / per_group;
    st[1] = rsqrtf(s_dev[tid] / n + EPS);
  }
#pragma unroll 4
  for (int p = tid >> 4; p < HW; p += 16) {
    uint4* cell = slab(p);
    float f[8];
    unpack8(*cell, f);
    uint4 u;
    __nv_bfloat162* hq = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      hq[e] = __floats2bfloat162_rn((f[2 * e] - mean) * rstd * sc[2 * e] + bi[2 * e],
                                    (f[2 * e + 1] - mean) * rstd * sc[2 * e + 1] + bi[2 * e + 1]);
    *cell = u;
  }
  fence_proxy_async();
  __syncthreads();

  // z: warpgroup wg computes part wg (re, im) of the chunk's modes
  // (the A rows landed while the slab was normalised; waiting for all of
  // them first keeps the wait loop off the path between two wgmmas, which
  // would make ptxas serialise them)
  for (int kb = 0; kb < nkx; ++kb) mbar_wait(bar(BAR_A + kb), 0);
  Acc acc;
  acc.zero();
  acc.fence();
  wgmma_fence();
  for (int kb = 0; kb < nkx; ++kb) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      acc.mma<1, 1>(desc_k(base + S_A + (wg * nkx + kb) * 8192 + kk * 32),
                    desc_mn(base + S_X + (kb * 64 + kk * 16) * 128, HW * 128));
  }
  wgmma_commit();
  wgmma_wait_all();
  acc.fence();
  __syncthreads();  // the slab and the A rows are spent
  if (tid == 0) {
    mbar_expect_tx(bar(BAR_W2), 65536);
    for (int p = 0; p < 2; ++p)
      for (int ib = 0; ib < 2; ++ib)
        tma_load_4d(base + S_X + (p * 2 + ib) * 16384, &map_w2, bar(BAR_W2), ib * 64, 0, j, p);
  }
  Bias bias;
  store_half<ACT_NONE, false>(sm + S_ZH, acc, bias, wg);
  fence_proxy_async();
  __syncthreads();

  // h = act([z_re | z_im] . W1 + B1), into the bytes of z
  const float* b1_wg = b1 + (wg * nb + j) * BS;
  if (wg == 0) complex_layer<0>(acc, base + S_ZH, base + S_W1, bar(BAR_W1), b1_wg, bias);
  else complex_layer<1>(acc, base + S_ZH, base + S_W1, bar(BAR_W1), b1_wg, bias);
  __syncthreads();  // both warpgroups are done with z
  store_half<ACT, true>(sm + S_ZH, acc, bias, wg);
  fence_proxy_async();
  __syncthreads();

  // o = [h_re | h_im] . W2 + B2, rounded, staged in the bytes of h and
  // stored by TMA, two 64 x 64 boxes per warpgroup
  const float* b2_wg = b2 + (wg * nb + j) * BS;
  if (wg == 0) complex_layer<0>(acc, base + S_ZH, base + S_X, bar(BAR_W2), b2_wg, bias);
  else complex_layer<1>(acc, base + S_ZH, base + S_X, bar(BAR_W2), b2_wg, bias);
  __syncthreads();  // both warpgroups are done with h
  store_half<ACT_NONE, true>(sm + S_ZH, acc, bias, wg);
  fence_proxy_async();
  warpgroup_sync(wg);
  if ((tid & 127) == 0) {
    for (int h = 0; h < 2; ++h)
      tma_store_3d(&map_os, base + S_ZH + (2 * wg + h) * 8192, j * BS + h * 64, chunk * MODES,
                   2 * b + wg);
    tma_store_drain();
  }
}

// Lets spectral_kernel<ACT> use the dynamic shared memory it needs, once
// per device.
template <int ACT> cudaError_t allow_smem(int dev) {
  static bool done[64] = {};
  if (dev < 64 && done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      spectral_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SPECTRAL_SMEM);
  if (e != cudaSuccess) return e;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

}  // namespace

// The shapes this kernel takes, as `hopper_supported` in
// dpot_tpu_torch/ops/cuda/afno_fused.py states them (the dtype is bf16).
extern "C" int dpot_afno_hopper_supported(int B, int HW, int C, int K, int nb, int groups) {
  if (B < 1 || B > 65535 || nb < 1 || C != nb * BS || groups < 1 || C % groups) return 0;
  if (HW % TILE_P || HW > MAX_HW || K < 1 || K % 4 || (2 * K + 63) / 64 > MAX_NK) return 0;
  const int cpg = C / groups;
  return cpg >= 8 && cpg <= BS && (cpg & (cpg - 1)) == 0;
}

// x, out (B, HW, C), A (2K, HW), Ainv (HW, 2K), o scratch (B, 2K, C) are
// bf16; w1t/w2t are the bf16 block weights (2, nb, bs, bs), each block
// transposed to (out, in); gscale/gbias (C), b1/b2 (2, nb, bs) and the
// stats scratch (B * groups * 2) are f32. act is an ActId. Returns 0, a
// CUDA error, or 10000 + the CUresult of a failed tensor-map encoding.
extern "C" int dpot_afno_hopper(int act, const void* x, const float* gscale, const float* gbias,
                                const void* A, const void* Ainv, const void* w1t, const float* b1,
                                const void* w2t, const float* b2, float* stats, void* o,
                                void* out, int B, int HW, int C, int K, int nb, int groups,
                                void* stream) {
  if (!dpot_afno_hopper_supported(B, HW, C, K, nb, groups) || act < 0 || act >= ACT_COUNT)
    return cudaErrorInvalidValue;
  const void* ptrs[] = {x, A, Ainv, w1t, w2t, o, out};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t UB = static_cast<uint64_t>(B), UC = C, UHW = HW, UK = K, UBS = BS, UNB = nb;

  // x is (B, HW, C); o is written as (2B, K, C), the re and im rows of a
  // sample as two planes, so that TMA drops the rows past the last mode
  CUtensorMap mx, ma, mw1, mw2, mos;
  const uint64_t dx[3] = {UC, UHW, UB}, da[3] = {UHW, UK, 2}, dw[4] = {UBS, UBS, UNB, 2},
                 dos[3] = {UC, UK, 2 * UB};
  const uint32_t bx[3] = {64, static_cast<uint32_t>(HW), 1}, ba[3] = {64, MODES, 1},
                 bw[4] = {64, BS, 1, 1}, bo[3] = {64, 64, 1};
  CUresult r;
  if ((r = tensor_map(&mx, x, 3, dx, bx, false)) != CUDA_SUCCESS ||
      (r = tensor_map(&ma, A, 3, da, ba, true)) != CUDA_SUCCESS ||
      (r = tensor_map(&mw1, w1t, 4, dw, bw, true)) != CUDA_SUCCESS ||
      (r = tensor_map(&mw2, w2t, 4, dw, bw, true)) != CUDA_SUCCESS ||
      (r = tensor_map(&mos, o, 3, dos, bo, false)) != CUDA_SUCCESS)
    return 10000 + static_cast<int>(r);

  cudaError_t e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = dispatch_act(act, [&](auto tag) {
    constexpr int ACT = decltype(tag)::id;
    cudaError_t err = allow_smem<ACT>(dev);
    if (err != cudaSuccess) return err;
    spectral_kernel<ACT><<<dim3((K + MODES - 1) / MODES, nb, B), NT, SPECTRAL_SMEM, s>>>(
        mx, ma, mw1, mw2, mos, gscale, gbias, b1, b2, stats, HW, C, nb, groups);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return e;
  return launch_synthesis(x, Ainv, o, out, stats, gscale, gbias, B, HW, C, K, groups, s);
}
