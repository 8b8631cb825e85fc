// Fused GroupNorm + AFNO spectral mixer in bf16 for AFNO blocks of 256
// channels (DPOT-H), designed for Hopper (sm_90a): wgmma fed by TMA, the
// block weights streamed through a ring, two launches, z and h on chip.
//
// Replaces, for bf16 operands at the shapes that `hopper_wide_supported`
// (dpot_tpu_torch/ops/cuda/afno_fused.py) admits, the TPU kernel
// `fused_gn_afno` of dpot_tpu/ops/pallas/afno_fused.py (`_kernel`, launched
// by `_fused_fwd`), which the JAX package runs at DPOT-H. It computes what
// afno_fused.cu computes and rounds at the same points: GroupNorm in f32
// (eps 1e-5), z = A . round(xn), per AFNO block j h = round(act([z_re |
// z_im] . W1_j + B1_j)), o = round(h . W2_j + B2_j), out = round(Ainv . o +
// xn) with xn in f32.
//
// What bounds it. At DPOT-H (HW 256, C 2048, K 144, nb 8, bs 256) a sample
// is 1.81 GFLOP in the mixer (analysis 0.30, mode MLP 1.21, synthesis
// 0.30) against 2.1 MB of x and out and 4.2 MB of bf16 weights shared by
// the batch: bound by bytes at B = 1, by tensor-core operations from B = 2.
// The design of afno_hopper.cu (blocks of 128 channels) does not widen:
// there a CTA holds the block's W1 (64 KB) beside the x slab, the A rows
// and z/h, 224 of 227 KB. At bs = 256 one layer's weights are 256 KB as
// wr and wi, and one block's x slab is 128 KB. So:
//
//   1. spectral_wide_kernel, one CTA per (chunk of 64 modes, block j,
//      sample b), two consumer warpgroups and one producer warp. The
//      producer brings, by TMA, the x slab x[b, :, 256 j : 256 (j+1)]
//      (HW x 256, 128 KB at HW 256) and the chunk's rows of A (re and im,
//      64 KB) at once, then streams the 16 weight tiles of the two layers
//      ([256 out][64 in] of wr or wi, 32 KB each) through a ring of five
//      slots: slot 0 is free from the start, slots 1-4 lie in the bytes of
//      the slab and the A rows and are handed to the ring once the
//      analysis has read them (one "empty" mbarrier per slot, which every
//      consumer thread arrives on, one "full" per slot for the TMA bytes).
//      The consumers compute the f32 GroupNorm statistics of the slab in
//      one pass and rewrite it in place as round(xn); z = A . xn by wgmma
//      (m64n256k16: warpgroup w takes part w, re or im, of the chunk's
//      modes, all 256 channels, 128 accumulator registers a thread); z
//      goes to shared memory as the MLP's A operand [z_re | z_im] (64 KB,
//      eight 64-wide k-blocks). Each MLP layer is eight wgmma groups, one
//      per weight tile, one group kept in flight: warpgroup 0 computes
//      h_re = z_re . wr - z_im . wi (the minus through imm-scale-b = -1),
//      warpgroup 1 h_im = z_re . wi + z_im . wr, each from the same tile.
//      h overwrites z once both warpgroups are done with z; o leaves by a
//      TMA store into (B, 2K, C), the only trip an intermediate makes. The
//      chunk-0 CTA writes the block's GroupNorm statistics to a scratch.
//   2. tma_synthesis_kernel (hopper_tma.cuh, shared with afno_hopper.cu):
//      out = Ainv . o + xn per (128 pixels, 128 channels, sample), a
//      programmatic dependent launch. It reads the statistics by group,
//      whatever the group's size, so it serves blocks of 256 as they are.
//
// The weights arrive as bf16 copies, each block transposed to (out, in),
// made by the wrapper and cached until the parameter changes: the same
// copies afno_hopper.cu reads.

#include "activation.cuh"
#include "hopper_tma.cuh"

namespace {

constexpr int BS = 256;         // AFNO block size, the only one admitted
constexpr int NC = 256;         // consumer threads: two warpgroups
constexpr int NT = NC + 32;     // and one producer warp
constexpr int MODES = 64;       // modes per spectral CTA
constexpr float EPS = 1e-5f;    // torch.nn.GroupNorm default
constexpr int W_TILE = 32768;   // one weight tile: [256 out][64 in] bf16
constexpr int STAGES = 16;      // weight tiles per CTA: 2 layers x (wr, wi) x 4 k-chunks
constexpr int SLOTS = 5;        // weight tiles in flight

// spectral_wide_kernel's shared memory, byte offsets from a 1024-aligned base
constexpr int S_X = 0;          // x slab [4 quarters][HW][64], HW <= 256
constexpr int S_ZH = 0;         // after the analysis: z, then h, [8 k-blocks][64][64]
constexpr int S_A = 131072;     // A rows [2 parts][HW / 64][64][64]
constexpr int S_SLOT0 = 196608; // ring slot 0; slots 1-4 at 64, 96, 128, 160 KB
constexpr int S_MISC = 229376;  // 12 mbarriers, reduction scratch, statistics
constexpr int SPECTRAL_SMEM = S_MISC + 1536 + 1024;  // + alignment slack
enum { BAR_X = 0, BAR_A = 1, BAR_FULL = 2, BAR_EMPTY = BAR_FULL + SLOTS };
constexpr int ACT_NONE = -1;

__host__ __device__ constexpr int slot_off(int slot) {
  return slot == 0 ? S_SLOT0 : 65536 + (slot - 1) * W_TILE;
}
static_assert(SPECTRAL_SMEM <= 232448, "more shared memory than a CTA may have");
static_assert(slot_off(SLOTS - 1) + W_TILE <= S_SLOT0, "a ring slot runs into slot 0");
static_assert(S_ZH + 8 * 8192 <= slot_off(1), "z/h runs into ring slot 1");

// Barrier of the 256 consumer threads (1 and 2 are the warpgroups').
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until at most N of this warp's wgmma groups are in flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

struct Acc256 {
  float d[128];  // m64 x n256 f32 accumulator of one warpgroup

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
  }
  // keep the compiler from moving the registers across wgmma's async use
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
  }
  // d += A . (SB * B), m64 n256 k16, bf16 operands; TB: B is MN-major
  template <int SB, int TB> __device__ __forceinline__ void mma(uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
        "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127}, "
        "%128, %129, p, 1, %131, 0, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1), "n"(SB), "n"(TB));
  }
};

// Warpgroup wg's accumulator (+ the bias of its columns when BIAS, through
// ACT unless ACT_NONE), rounded to bf16, into k-blocks 4 wg .. 4 wg + 3 of
// the swizzled tile zh [8][64][64]: the warpgroup's half of [z_re | z_im]
// or [h_re | h_im], or its four 64 x 64 boxes of o for the TMA store.
template <int ACT, bool BIAS>
__device__ __forceinline__ void store_half(uint8_t* zh, const Acc256& acc, const float* bias,
                                           int wg) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = acc_col(i), kb = 4 * wg + (col >> 6), cc = col & 63;
    float2 bv = make_float2(0.f, 0.f);
    if constexpr (BIAS) bv = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = acc_row(h);
      float v0 = acc.d[4 * i + 2 * h], v1 = acc.d[4 * i + 2 * h + 1];
      if constexpr (BIAS) {
        v0 += bv.x;
        v1 += bv.y;
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

// One complex MLP layer (LAYER 0: W1, 1: W2) of one block, computed by
// warpgroup WG from the K-major tile [8][64][64] at S_ZH: the layer's
// eight weight tiles (t = 0..3: wr, k-chunk t; t = 4..7: wi, k-chunk t - 4)
// arrive in ring slot (8 LAYER + t) % SLOTS. Real half (WG 0): a_re . wr -
// a_im . wi; imaginary (WG 1): a_re . wi + a_im . wr. One wgmma group per
// tile, one kept in flight; a tile's slot is handed back (every consumer
// thread arrives on its "empty" barrier) once its group has completed.
// WG is a template argument so that the sign of each product is an
// immediate and no wgmma sits on a path that depends on the thread.
template <int WG, int LAYER>
__device__ __forceinline__ void complex_layer(Acc256& acc, uint32_t base) {
  auto bar = [&](int i) { return base + S_MISC + 8 * i; };
  acc.zero();
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int s = 8 * LAYER + t, slot = s % SLOTS, part = t / 4, kc = t % 4;
    const int kb = part == WG ? kc : 4 + kc;  // a_re's k-block kc, or a_im's
    mbar_wait(bar(BAR_FULL + slot), (s / SLOTS) & 1);
    acc.fence();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = desc_k(base + S_ZH + kb * 8192 + kk * 32);
      const uint64_t w = desc_k(base + slot_off(slot) + kk * 32);
      if (WG == 0 && part == 1) acc.mma<-1, 0>(a, w);
      else acc.mma<1, 0>(a, w);
    }
    wgmma_commit();
    if (t > 0) {
      wgmma_wait<1>();
      acc.fence();
      mbar_arrive(bar(BAR_EMPTY + (s - 1) % SLOTS));
    }
  }
  wgmma_wait<0>();
  acc.fence();
  mbar_arrive(bar(BAR_EMPTY + (8 * LAYER + 7) % SLOTS));
}

// Sum of v over the threads of each GroupNorm group of the slab into
// out[group]. Consumer thread t holds the 8-channel chunk column t % 32 of
// the slab; gsz chunks form a group (a power of two up to 32), so a group
// is gsz neighbouring lanes of every consumer warp. red: 32 floats a warp.
__device__ void slab_group_sum(float v, int gsz, int ng, float* red, float* out) {
  for (int o = 1; o < gsz; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane % gsz == 0) red[warp * 32 + lane / gsz] = v;
  consumer_sync();
  if (threadIdx.x < ng) {
    float s = 0.f;
    for (int w = 0; w < NC / 32; ++w) s += red[w * 32 + threadIdx.x];
    out[threadIdx.x] = s;
  }
  consumer_sync();
}

// grid (ceil(K / 64), nb, B), NT threads: modes chunk * 64 .. + 63 of AFNO
// block j of sample b, from x to o (stored through map_os, which views o
// as (2B, K, C) so that TMA drops the rows past the last mode). stats
// (B, groups, 2) gets the GroupNorm mean and 1/std of the block's groups
// from the chunk-0 CTA. ACT is the mode MLP's activation (an ActId).
template <int ACT>
__global__ void __launch_bounds__(NT, 1)
spectral_wide_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w1,
                     const __grid_constant__ CUtensorMap map_w2,
                     const __grid_constant__ CUtensorMap map_os, const float* __restrict__ gscale,
                     const float* __restrict__ gbias, const float* __restrict__ b1,
                     const float* __restrict__ b2, float* __restrict__ stats, int HW, int C,
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
    for (int i = 0; i < BAR_EMPTY; ++i) mbar_init(bar(i), 1);
    for (int i = 0; i < SLOTS; ++i) mbar_init(bar(BAR_EMPTY + i), NC);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NC) {  // the producer warp: one thread issues every load
    if (tid == NC) {
      mbar_expect_tx(bar(BAR_X), 4 * HW * 128);
      for (int q = 0; q < 4; ++q)
        tma_load_3d(base + S_X + q * HW * 128, &map_x, bar(BAR_X), j * BS + q * 64, 0, b);
      mbar_expect_tx(bar(BAR_A), 2 * nkx * 8192);
      for (int p = 0; p < 2; ++p)
        for (int kb = 0; kb < nkx; ++kb)
          tma_load_3d(base + S_A + (p * nkx + kb) * 8192, &map_a, bar(BAR_A), kb * 64,
                      chunk * MODES, p);
      // weight tile s into slot s % SLOTS once the slot's earlier tenant
      // (for slots 1-4 first the slab and the A rows) has handed it back
      for (int s = 0; s < STAGES; ++s) {
        const int slot = s % SLOTS, t = s % 8, need = s / SLOTS + (slot != 0);
        if (need) mbar_wait(bar(BAR_EMPTY + slot), (need - 1) & 1);
        mbar_expect_tx(bar(BAR_FULL + slot), W_TILE);
        tma_load_4d(base + slot_off(slot), s < 8 ? &map_w1 : &map_w2, bar(BAR_FULL + slot),
                    (t % 4) * 64, 0, j, t / 4);
      }
    }
    return;
  }

  // GroupNorm of the slab, in place. Thread tid owns 8-channel chunk column
  // lc of rows tid / 32, tid / 32 + 8, ...; chunk (p, lc) sits at 16-byte
  // position (lc % 8) ^ (p % 8) of row p of quarter lc / 8 (the swizzle).
  const int cpg = C / groups, gsz = cpg / 8, ng = BS / cpg;
  const int lc = tid & 31, g = lc / gsz;
  float* red = reinterpret_cast<float*>(sm + S_MISC + 128);
  float* s_sum = reinterpret_cast<float*>(sm + S_MISC + 1152);
  float* s_dev = s_sum + 32;
  auto slab = [&](int p) {
    return reinterpret_cast<uint4*>(sm + S_X + (lc >> 3) * HW * 128 + p * 128 +
                                    (((lc & 7) ^ (p & 7)) << 4));
  };
  const float n = static_cast<float>(HW) * cpg, cnt = 8.f * (HW / 8), per_group = 8.f * gsz;
  float sc[8], bi[8];  // the affine of this thread's 8 channels, fetched while x lands
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sc[e] = __ldg(gscale + j * BS + lc * 8 + e);
    bi[e] = __ldg(gbias + j * BS + lc * 8 + e);
  }
  mbar_wait(bar(BAR_X), 0);
  // One pass over the slab: each thread's mean m and sum q of squared
  // deviations over its cnt values (shifted by its first value, eight
  // partial sums), then the groups' mean from the m and their variance
  // from q + cnt (m - mean)^2 (Chan's pairwise combination).
  float m, q;
  {
    float f0[8];
    unpack8(*slab(tid >> 5), f0);
    const float shift = f0[0];
    float p1[8] = {}, p2[8] = {};
#pragma unroll 4
    for (int p = tid >> 5; p < HW; p += 8) {
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
  for (int p = tid >> 5; p < HW; p += 8) {
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
  consumer_sync();

  // z: warpgroup wg computes part wg (re, im) of the chunk's modes over the
  // block's 256 channels (the A rows landed while the slab was normalised)
  mbar_wait(bar(BAR_A), 0);
  Acc256 acc;
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
  wgmma_wait<0>();
  acc.fence();
  // the slab and the A rows are spent: ring slots 1-4 go to the producer
  for (int sl = 1; sl < SLOTS; ++sl) mbar_arrive(bar(BAR_EMPTY + sl));
  consumer_sync();  // both warpgroups are done with the slab
  store_half<ACT_NONE, false>(sm + S_ZH, acc, nullptr, wg);
  fence_proxy_async();
  consumer_sync();

  // h = act([z_re | z_im] . W1 + B1), into the bytes of z
  if (wg == 0) complex_layer<0, 0>(acc, base);
  else complex_layer<1, 0>(acc, base);
  consumer_sync();  // both warpgroups are done with z
  store_half<ACT, true>(sm + S_ZH, acc, b1 + (wg * nb + j) * BS, wg);
  fence_proxy_async();
  consumer_sync();

  // o = [h_re | h_im] . W2 + B2, rounded, staged in the bytes of h and
  // stored by TMA, four 64 x 64 boxes per warpgroup
  if (wg == 0) complex_layer<0, 1>(acc, base);
  else complex_layer<1, 1>(acc, base);
  consumer_sync();  // both warpgroups are done with h
  store_half<ACT_NONE, true>(sm + S_ZH, acc, b2 + (wg * nb + j) * BS, wg);
  fence_proxy_async();
  warpgroup_sync(wg);
  if ((tid & 127) == 0) {
    for (int q4 = 0; q4 < 4; ++q4)
      tma_store_3d(&map_os, base + S_ZH + (4 * wg + q4) * 8192, j * BS + q4 * 64,
                   chunk * MODES, 2 * b + wg);
    tma_store_drain();
  }
}

// Lets spectral_wide_kernel<ACT> use the dynamic shared memory it needs,
// once per device.
template <int ACT> cudaError_t allow_smem(int dev) {
  static bool done[64] = {};
  if (dev < 64 && done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      spectral_wide_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SPECTRAL_SMEM);
  if (e != cudaSuccess) return e;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

}  // namespace

// The shapes this kernel takes, as `hopper_wide_supported` in
// dpot_tpu_torch/ops/cuda/afno_fused.py states them (the dtype is bf16).
extern "C" int dpot_afno_hopper_wide_supported(int B, int HW, int C, int K, int nb, int groups) {
  if (B < 1 || B > 65535 || nb < 1 || C != nb * BS || groups < 1 || C % groups) return 0;
  if ((HW != 128 && HW != 256) || K < 1 || K % 4 || (2 * K + 63) / 64 > MAX_NK) return 0;
  const int cpg = C / groups;
  return cpg >= 8 && cpg <= BS && (cpg & (cpg - 1)) == 0;
}

// x, out (B, HW, C), A (2K, HW), Ainv (HW, 2K), o scratch (B, 2K, C) are
// bf16; w1t/w2t are the bf16 block weights (2, nb, bs, bs), each block
// transposed to (out, in); gscale/gbias (C), b1/b2 (2, nb, bs) and the
// stats scratch (B * groups * 2) are f32. act is an ActId. Returns 0, a
// CUDA error, or 10000 + the CUresult of a failed tensor-map encoding.
extern "C" int dpot_afno_hopper_wide(int act, const void* x, const float* gscale,
                                     const float* gbias, const void* A, const void* Ainv,
                                     const void* w1t, const float* b1, const void* w2t,
                                     const float* b2, float* stats, void* o, void* out, int B,
                                     int HW, int C, int K, int nb, int groups, void* stream) {
  if (!dpot_afno_hopper_wide_supported(B, HW, C, K, nb, groups) || act < 0 || act >= ACT_COUNT)
    return cudaErrorInvalidValue;
  const void* ptrs[] = {x, A, Ainv, w1t, w2t, o, out};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  if ((reinterpret_cast<uintptr_t>(b1) | reinterpret_cast<uintptr_t>(b2)) & 7)
    return cudaErrorMisalignedAddress;  // read as float2
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
    spectral_wide_kernel<ACT><<<dim3((K + MODES - 1) / MODES, nb, B), NT, SPECTRAL_SMEM, s>>>(
        mx, ma, mw1, mw2, mos, gscale, gbias, b1, b2, stats, HW, C, nb, groups);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return e;
  return launch_synthesis(x, Ainv, o, out, stats, gscale, gbias, B, HW, C, K, groups, s);
}
