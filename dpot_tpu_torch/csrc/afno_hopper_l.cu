// Fused GroupNorm + AFNO spectral mixer in bf16 for AFNO blocks of 96
// channels (DPOT-L), designed for Hopper (sm_90a): wgmma fed by TMA, two
// launches, z and h kept on chip.
//
// Replaces, for bf16 operands at the shapes that `hopper_l_supported`
// (dpot_tpu_torch/ops/cuda/afno_fused.py) admits, the TPU kernel
// `fused_gn_afno` of dpot_tpu/ops/pallas/afno_fused.py (`_kernel`, launched
// by `_fused_fwd`, line 114), whose own gate never admitted these shapes
// (2 bs = 192 is no multiple of 128). It computes what afno_hopper.cu
// computes and rounds at the same points: GroupNorm in f32 (eps 1e-5),
// z = A . round(xn), per AFNO block j h = round(act([z_re | z_im] . W1_j +
// B1_j)), o = round(h . W2_j + B2_j), out = round(Ainv . o + xn), xn in f32.
//
// What bounds it. At DPOT-L (HW 256, C 1536, K 144, nb 16, bs 96) a sample
// is 793 MFLOP of bf16 products against 2.2 MB of operands, so from B ~ 2
// up it is bound by tensor-core operations; at B = 1 by latency. The
// five-launch kernel of afno_fused.cu, which L ran before, sent z, h and o
// through device memory and took five launches with a grid-wide
// statistics pass of one CTA per group.
//
// What differs from afno_hopper.cu (blocks of 128). DPOT-L breaks that
// kernel's premise that a GroupNorm group lies inside one AFNO block:
// GroupNorm(8) over 1536 channels makes groups of 192, each spanning the
// block pair (2i, 2i+1). Here a group is one block or a block pair, so a
// whole block always lies inside one group, and every CTA computes its
// group's statistics itself, in one pass over the group's 192 (or 96)
// channels read from L2 while TMA brings the slab; no CTA waits for
// another. A 96-channel row is 192 bytes, no multiple of the 128-byte
// swizzle span, so:
//   - the x slab is loaded as two 64-channel boxes from the block's first
//     channel (128 channels: the block and the next 32, which the last
//     block reads as zeros past C), and z = A . xn runs at N = 128 exactly
//     as afno_hopper.cu runs it; the 32 columns past the block are
//     computed and dropped (a tenth of the call's products);
//   - z and h are the K-major tile [z_re | z_im] of 192 columns, three
//     64-column k-blocks; each k16 step lies wholly in the real (steps 0-5)
//     or imaginary (6-11) half;
//   - the weights arrive as two [96 out][64 in] boxes per part (in 0-63,
//     then 64-95 with zeros past 96), and both MLP layers run wgmma
//     m64n96k16;
//   - o leaves by plain stores from the accumulators (96 channels are not
//     whole 128-byte TMA boxes).
// The synthesis launch is afno_hopper.cu's (hopper_tma.cuh): it tiles 128
// pixels x 128 channels and finds each channel's group as c / (C / groups),
// whatever the block size, so it takes C a multiple of 128 (nb % 4 == 0).
//
// Shared memory of a spectral CTA (64 modes x block j x sample b): x slab
// 64 KB, A rows 64 KB, W1 48 KB, z/h 24 KB, W2 streamed into the slab's
// bytes once z is done: 202 KB with the barriers and slack. The grid is
// (ceil(K / 64), nb, B): 48 CTAs at DPOT-L's B = 1, which leaves 84 of the
// H100's 132 SMs idle for the spectral launch (its cost at B = 1 is
// latency, PERF.md).

#include "activation.cuh"
#include "hopper_tma.cuh"

namespace {

constexpr int BS = 96;          // AFNO block size, the only one admitted
constexpr int NT = 256;         // threads per CTA: two warpgroups
constexpr int MODES = 64;       // modes per spectral CTA
constexpr int MAX_HW = 256;     // the x slab and the A rows fit at most this
constexpr float EPS = 1e-5f;    // torch.nn.GroupNorm default
constexpr int W_TILE = 12288;   // one weight box: [96 out][64 in] bf16

// spectral_l_kernel's shared memory, byte offsets from a 1024-aligned base
constexpr int S_X = 0;          // xn [2 halves][HW][64]; then W2 [2 parts][2][96][64]
constexpr int S_A = 65536;      // A rows [2 parts][HW / 64][64][64]
constexpr int S_W1 = 131072;    // W1 [2 parts][2 k-blocks][96][64]
constexpr int S_ZH = 180224;    // z, then h: [3 k-blocks][64][64]
constexpr int S_MISC = 204800;  // 7 mbarriers, reduction scratch
constexpr int SPECTRAL_SMEM = S_MISC + 1024 + 1024;  // + alignment slack
enum { BAR_X = 0, BAR_A = 1, BAR_W1 = 5, BAR_W2 = 6 };
constexpr int ACT_NONE = -1;

struct Acc96 {
  float d[48];  // m64 x n96 f32 accumulator of one warpgroup

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 48; ++i) d[i] = 0.f;
  }
  // keep the compiler from moving the registers across wgmma's async use
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int i = 0; i < 48; ++i) asm volatile("" : "+f"(d[i])::"memory");
  }
  // d += A . (SB * B), m64 n96 k16, bf16 operands, both K-major
  template <int SB> __device__ __forceinline__ void mma(uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, %51, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1), "n"(SB));
  }
};

// Columns 0..95 of warpgroup wg's accumulator (+ the bias of its columns
// when BIAS, through ACT unless ACT_NONE), rounded to bf16, at columns
// 96 wg .. 96 wg + 95 of the swizzled K-major tile zh [3][64][64]: the
// warpgroup's half of [z_re | z_im] or [h_re | h_im]. AccT is Acc (the
// analysis, N = 128, whose columns past 95 are dropped) or Acc96.
template <int ACT, bool BIAS, typename AccT>
__device__ __forceinline__ void store_half(uint8_t* zh, const AccT& acc, const float* bias,
                                           int wg) {
#pragma unroll
  for (int i = 0; i < BS / 8; ++i) {
    const int col = acc_col(i), k = BS * wg + col, kb = k >> 6, cc = k & 63;
    float2 bv = make_float2(0.f, 0.f);
    if constexpr (BIAS) bv = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = acc_row(h);
      float v0 = acc.d[4 * i + 2 * h] + bv.x, v1 = acc.d[4 * i + 2 * h + 1] + bv.y;
      if constexpr (ACT != ACT_NONE) {
        v0 = activate<ACT>(v0);
        v1 = activate<ACT>(v1);
      }
      uint8_t* p = zh + kb * 8192 + r * 128 + (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2;
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// One complex MLP layer of one block, computed by warpgroup WG: acc = WG's
// half of [a_re | a_im] . W, with a the K-major tile [3][64][64] at a_base
// and W the weight boxes [part][k-block][96 out][64 in] at w_base (part 0 =
// wr, 1 = wi), once barrier bar says W has landed. Real half (WG 0):
// a_re.wr - a_im.wi; imaginary (WG 1): a_re.wi + a_im.wr. k16 step s of
// the 192 columns of a is in the real half for s < 6; its weight rows are
// the step's 16 input channels, si = s % 6. WG is a template argument so
// that the sign is an immediate and no wgmma sits on a path that depends
// on the thread (ptxas would serialise them).
template <int WG>
__device__ __forceinline__ void complex_layer(Acc96& acc, uint32_t a_base, uint32_t w_base,
                                              uint32_t bar) {
  mbar_wait(bar, 0);
  acc.zero();
  acc.fence();
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 12; ++s) {
    const int part = s < 6 ? WG : 1 - WG, si = s % 6;
    const uint64_t a = desc_k(a_base + (s >> 2) * 8192 + (s & 3) * 32);
    const uint64_t w = desc_k(w_base + (part * 2 + (si >> 2)) * W_TILE + (si & 3) * 32);
    if (s >= 6 && WG == 0) acc.mma<-1>(a, w);
    else acc.mma<1>(a, w);
  }
  wgmma_commit();
  wgmma_wait_all();
  acc.fence();
}

// Sum of v over the CTA, returned to every thread. red: 8 floats.
__device__ __forceinline__ float cta_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();  // red may be written again
  return s;
}

// grid (ceil(K / 64), nb, B): modes chunk * 64 .. + 63 of AFNO block j of
// sample b, from x to o (B, 2K, C). stats (B, groups, 2) gets the mean and
// 1/std of the block's group from the chunk-0 CTA of the group's first
// block. ACT is the mode MLP's activation (an ActId).
template <int ACT>
__global__ void __launch_bounds__(NT, 1)
spectral_l_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_w1,
                  const __grid_constant__ CUtensorMap map_w2, const bf16* __restrict__ x,
                  const float* __restrict__ gscale, const float* __restrict__ gbias,
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  float* __restrict__ stats, bf16* __restrict__ o, int HW, int C, int K,
                  int nb, int groups) {
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
    mbar_expect_tx(bar(BAR_W1), 4 * W_TILE);
    for (int p = 0; p < 2; ++p)
      for (int ib = 0; ib < 2; ++ib)
        tma_load_4d(base + S_W1 + (p * 2 + ib) * W_TILE, &map_w1, bar(BAR_W1), ib * 64, 0, j,
                    p);
  }

  // GroupNorm statistics of the block's group (its cpg = 96 or 192
  // channels, from the group's first channel g0), one pass from L2 while
  // the slab lands: the group's HW x cpg / 8 chunks of 8 channels are
  // dealt out evenly, n_per to a thread (HW cpg / 2048, whole at the
  // admitted shapes); each thread's mean m and sum q of squared deviations
  // (shifted by its first value) combine into the group's mean and
  // variance (Chan's pairwise rule, as exact as two passes).
  const int cpg = C / groups, g0 = j * BS / cpg * cpg, cols = cpg / 8;
  const int n_per = HW * cols / NT;
  float* red = reinterpret_cast<float*>(sm + S_MISC + 64);
  float mean, rstd;
  {
    const bf16* xg = x + static_cast<size_t>(b) * HW * C + g0;
    auto cell = [&](int q) {
      return __ldg(reinterpret_cast<const uint4*>(xg + static_cast<size_t>(q / cols) * C +
                                                  (q % cols) * 8));
    };
    float f0[8];
    unpack8(cell(tid), f0);
    const float shift = f0[0];
    float p1[8] = {}, p2[8] = {};
#pragma unroll 4
    for (int k = 0; k < n_per; ++k) {
      float f[8];
      unpack8(cell(tid + k * NT), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = f[e] - shift;
        p1[e] += d;
        p2[e] += d * d;
      }
    }
    const float cnt = 8.f * n_per, s1 = sum8(p1);
    const float m = shift + s1 / cnt, q = sum8(p2) - s1 * s1 / cnt;
    mean = cta_sum(m, red) / NT;
    const float m2 = cta_sum(q + cnt * (m - mean) * (m - mean), red);
    rstd = rsqrtf(m2 / (static_cast<float>(HW) * cpg) + EPS);
  }
  if (chunk == 0 && j * BS == g0 && tid == 0) {
    float* st = stats + 2 * (b * groups + g0 / cpg);
    st[0] = mean;
    st[1] = rstd;
  }

  // GroupNorm of the slab's first 96 channels, in place. Thread tid owns
  // 8-channel chunk column lc of rows tid / 16, tid / 16 + 16, ...; chunk
  // (p, lc) sits at 16-byte position (lc % 8) ^ (p % 8) of row p of half
  // lc / 8 (the swizzle). Columns 12-15 (the next block's channels) stay
  // as they landed: z's columns past 95 are dropped.
  const int lc = tid & 15;
  mbar_wait(bar(BAR_X), 0);
  if (lc < BS / 8) {
    float sc[8], bi[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[e] = __ldg(gscale + j * BS + lc * 8 + e) * rstd;
      bi[e] = __ldg(gbias + j * BS + lc * 8 + e);
    }
#pragma unroll 4
    for (int p = tid >> 4; p < HW; p += 16) {
      uint4* cellp = reinterpret_cast<uint4*>(sm + S_X + (lc >> 3) * HW * 128 + p * 128 +
                                              (((lc & 7) ^ (p & 7)) << 4));
      float f[8];
      unpack8(*cellp, f);
      uint4 u;
      __nv_bfloat162* hq = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hq[e] = __floats2bfloat162_rn((f[2 * e] - mean) * sc[2 * e] + bi[2 * e],
                                      (f[2 * e + 1] - mean) * sc[2 * e + 1] + bi[2 * e + 1]);
      *cellp = u;
    }
  }
  fence_proxy_async();
  __syncthreads();

  // z: warpgroup wg computes part wg (re, im) of the chunk's modes over the
  // slab's 128 columns, as afno_hopper.cu does (the A rows landed while the
  // slab was normalised; waiting for all of them first keeps the wait loop
  // off the path between two wgmmas)
  for (int kb = 0; kb < nkx; ++kb) mbar_wait(bar(BAR_A + kb), 0);
  {
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
      mbar_expect_tx(bar(BAR_W2), 4 * W_TILE);
      for (int p = 0; p < 2; ++p)
        for (int ib = 0; ib < 2; ++ib)
          tma_load_4d(base + S_X + (p * 2 + ib) * W_TILE, &map_w2, bar(BAR_W2), ib * 64, 0, j,
                      p);
    }
    store_half<ACT_NONE, false>(sm + S_ZH, acc, nullptr, wg);
  }
  fence_proxy_async();
  __syncthreads();

  // h = act([z_re | z_im] . W1 + B1), into the bytes of z
  Acc96 acc;
  if (wg == 0) complex_layer<0>(acc, base + S_ZH, base + S_W1, bar(BAR_W1));
  else complex_layer<1>(acc, base + S_ZH, base + S_W1, bar(BAR_W1));
  __syncthreads();  // both warpgroups are done with z
  store_half<ACT, true>(sm + S_ZH, acc, b1 + (wg * nb + j) * BS, wg);
  fence_proxy_async();
  __syncthreads();

  // o = [h_re | h_im] . W2 + B2, rounded, to o's rows wg K + mode (modes
  // past K dropped), columns j bs ..
  if (wg == 0) complex_layer<0>(acc, base + S_ZH, base + S_X, bar(BAR_W2));
  else complex_layer<1>(acc, base + S_ZH, base + S_X, bar(BAR_W2));
  const float* b2_wg = b2 + (wg * nb + j) * BS;
  bf16* ob = o + static_cast<size_t>(2 * b + wg) * K * C + j * BS;
#pragma unroll
  for (int i = 0; i < BS / 8; ++i) {
    const int col = acc_col(i);
    const float2 bv = __ldg(reinterpret_cast<const float2*>(b2_wg + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mode = chunk * MODES + acc_row(h);
      if (mode < K)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(mode) * C + col) =
            __floats2bfloat162_rn(acc.d[4 * i + 2 * h] + bv.x, acc.d[4 * i + 2 * h + 1] + bv.y);
    }
  }
}

// Lets spectral_l_kernel<ACT> use the dynamic shared memory it needs, once
// per device.
template <int ACT> cudaError_t allow_smem(int dev) {
  static bool done[64] = {};
  if (dev < 64 && done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      spectral_l_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SPECTRAL_SMEM);
  if (e != cudaSuccess) return e;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

}  // namespace

// The shapes this kernel takes, as `hopper_l_supported` in
// dpot_tpu_torch/ops/cuda/afno_fused.py states them (the dtype is bf16).
extern "C" int dpot_afno_hopper_l_supported(int B, int HW, int C, int K, int nb, int groups) {
  if (B < 1 || B > 65535 || nb < 1 || C != nb * BS || C % TILE_C || groups < 1 || C % groups)
    return 0;
  if (HW % TILE_P || HW > MAX_HW || K < 1 || K % 4 || (2 * K + 63) / 64 > MAX_NK) return 0;
  const int cpg = C / groups;
  return cpg == BS || cpg == 2 * BS;
}

// x, out (B, HW, C), A (2K, HW), Ainv (HW, 2K), o scratch (B, 2K, C) are
// bf16; w1t/w2t are the bf16 block weights (2, nb, bs, bs), each block
// transposed to (out, in); gscale/gbias (C), b1/b2 (2, nb, bs) and the
// stats scratch (B * groups * 2) are f32. act is an ActId. Returns 0, a
// CUDA error, or 10000 + the CUresult of a failed tensor-map encoding.
extern "C" int dpot_afno_hopper_l(int act, const void* x, const float* gscale,
                                  const float* gbias, const void* A, const void* Ainv,
                                  const void* w1t, const float* b1, const void* w2t,
                                  const float* b2, float* stats, void* o, void* out, int B,
                                  int HW, int C, int K, int nb, int groups, void* stream) {
  if (!dpot_afno_hopper_l_supported(B, HW, C, K, nb, groups) || act < 0 || act >= ACT_COUNT)
    return cudaErrorInvalidValue;
  const void* ptrs[] = {x, A, Ainv, w1t, w2t, o, out};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t UB = static_cast<uint64_t>(B), UC = C, UHW = HW, UK = K, UBS = BS, UNB = nb;

  CUtensorMap mx, ma, mw1, mw2;
  const uint64_t dx[3] = {UC, UHW, UB}, da[3] = {UHW, UK, 2}, dw[4] = {UBS, UBS, UNB, 2};
  const uint32_t bx[3] = {64, static_cast<uint32_t>(HW), 1}, ba[3] = {64, MODES, 1},
                 bw[4] = {64, BS, 1, 1};
  CUresult r;
  if ((r = tensor_map(&mx, x, 3, dx, bx, false)) != CUDA_SUCCESS ||
      (r = tensor_map(&ma, A, 3, da, ba, true)) != CUDA_SUCCESS ||
      (r = tensor_map(&mw1, w1t, 4, dw, bw, true)) != CUDA_SUCCESS ||
      (r = tensor_map(&mw2, w2t, 4, dw, bw, true)) != CUDA_SUCCESS)
    return 10000 + static_cast<int>(r);

  cudaError_t e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = dispatch_act(act, [&](auto tag) {
    constexpr int ACT = decltype(tag)::id;
    cudaError_t err = allow_smem<ACT>(dev);
    if (err != cudaSuccess) return err;
    spectral_l_kernel<ACT><<<dim3((K + MODES - 1) / MODES, nb, B), NT, SPECTRAL_SMEM, s>>>(
        mx, ma, mw1, mw2, static_cast<const bf16*>(x), gscale, gbias, b1, b2, stats,
        static_cast<bf16*>(o), HW, C, K, nb, groups);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return e;
  return launch_synthesis(x, Ainv, o, out, stats, gscale, gbias, B, HW, C, K, groups, s);
}
