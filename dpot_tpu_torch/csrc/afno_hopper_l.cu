// Fused GroupNorm + AFNO spectral mixer in bf16 for AFNO blocks of 96
// channels at 128- and 256-px latents (DPOT-L at 128^2, patch 8), designed
// for Hopper (sm_90a): three launches, a persistent warp-specialised
// spectral launch whose wgmma products are fed by TMA through mbarriers,
// z and h kept on chip.
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
// up it is bound by tensor-core operations (0.00641 ms at B = 8, 989
// TFLOP/s); at B = 1 by latency. What keeps a fused design from that bound
// is first the operands' trips from L2 to the SMs (the design before read
// 320 KB for 16 MFLOP a CTA), then the work between the products: the
// normalisation of x, the epilogues of z, h and o, and the synthesis.
//
// The design before (measured on an NVIDIA H100 80GB HBM3, 700 W, by
// chip_smoke.py's kernel phase): one CTA per (64-mode chunk, block,
// sample), 256 threads and 202 KB of shared memory, one CTA an SM, every
// phase in sequence: the block's GroupNorm group read from L2 for the
// statistics (192 channels x 256 px, the same 96 KB by the 6 CTAs of a
// group), the normalisation, z = A . xn at N = 128 (32 columns of the next
// block computed and dropped), both MLP layers (W2's load issued only
// after z), o by plain stores; then hopper_tma.cuh's synthesis launch,
// which holds all of o in a CTA. It read 320 KB from L2 a CTA, 125.8 MB a
// call at B = 8, and took 0.0199 / 0.0578 / 0.1103 / 0.1459 ms at B = 1 /
// 8 / 16 / 20 against a bound of 0.00092 / 0.00641 / 0.01282 / 0.01603 (a
// tensor-parallel rank's C = 768 at B = 1 / 4 / 16: 0.0199 / 0.0209 /
// 0.0581).
//
// This design (0.0185 / 0.0446 / 0.0872 / 0.112 ms at B = 1 / 8 / 16 / 20,
// C = 768 0.0185 / 0.0199 / 0.0445 at B = 1 / 4 / 16, device time on the
// same card by tools/afno_l_variants.py, the design before 0.0199 /
// 0.0578 / 0.1106 / 0.1468 in the same process):
//   1. the statistics once: l_stats_kernel, one CTA per (group, sample),
//      f32, Chan's rule over 8-channel columns as afno_hopper_stream.cu's
//      stream_stats_kernel, each thread's rows all loaded before any is
//      summed; the spectral launch is its programmatic dependent and no
//      spectral CTA reads its group from L2;
//   2. spectral_l_kernel<ACT>, persistent: one CTA an SM (at most one per
//      tile), each walking a contiguous range of the tiles (64-mode chunk
//      c, block j, sample b) in the order (j, c, b), b fastest. One
//      producer warp issues every TMA load, two consumer warpgroups run
//      the products. The chunk's A rows (re and im, every 64-px k-block:
//      64 KB) stay in shared memory while the walk keeps its chunk, the
//      block's W1 and W2 (72 KB) while it keeps its block, each behind its
//      own full/empty mbarrier pair; the x tiles stream through a ring of
//      five 64-px stages with full/empty mbarriers. The consumers rewrite a
//      tile's x stages in place as round(xn) from the statistics while the
//      tile before runs its MLP products (its first stage under MLP1, the
//      others under MLP2), fence the generic proxy, and run z = A . xn as
//      one batch of wgmma m64n96k16, warpgroup w part w (re, im) of the 64
//      modes; z goes to shared memory as the K-major tile [z_re | z_im]
//      (192 columns, three 64-column k-blocks), h and then o over it, each
//      layer 12 wgmma k16 steps from the resident weights; o leaves by
//      16-byte stores of the rows below K;
//   3. afno_hopper_stream.cu's synthesis, stream_synthesis_kernel<TN>
//      (128 px x 256, 128 or 64 channels, o streamed in 64-mode k-blocks),
//      a programmatic dependent of the spectral launch.
// Where its time goes (B = 16, the variants of tools/afno_l_variants.py):
// of 0.087 ms, the synthesis adds 0.022 to the spectral launch's end, the
// normalisation, the MLP products and the h activation 0.017, 0.017 and
// 0.013 each when taken out alone, the tail chunk 0.018; the statistics
// launch runs 0.008 before the spectral consumers may start (no spectral
// CTA fits in the registers a statistics CTA leaves on its SM). The streamed
// kernel forced onto these shapes takes 0.0481 / 0.0901 / 0.1114 at B = 8
// / 16 / 20 in the same process.
//
// No padded product at N: a 96-channel row is 192 bytes, no whole 128-byte
// swizzle span, so the x stage is three boxes of 32 channels with the
// 64-byte swizzle (64-byte rows), read as one MN-major operand of N = 96
// (three 32-channel atoms, LBO the box stride); each part of a block's
// weights is a [96 out][64 in] box with the 128-byte swizzle and a
// [96 out][32 in] box with the 64-byte one. What stays padded: K 144 makes
// two full 64-mode chunks and one of 16 modes, whose tiles run all three
// products at M = 64 with 48 empty rows (3 of every 9 tiles; 25 % of a
// call's products, 0.018 of 0.087 ms at B = 16). Two samples' tails in one
// tile (stacked [re | im] rows of A, one sample a warpgroup) would need
// both samples' x stages in the ring at once, 96 KB beside the resident
// A and W, which do not fit.
//
// The walk's L2 reckoning (DPOT-L, B = 8: 384 tiles over 132 CTAs, 2 or 3
// each): x 384 x 48 KB = 18.9 MB, A 156 loads x 64 KB = 10.2 MB, W 140
// loads x 72 KB = 10.3 MB; 39.4 MB against the design before's 125.8 MB,
// plus the statistics launch's one pass over x (6.3 MB); B = 16: 59.4 MB
// (251.7 before), B = 20: 68.8 (314.6). The order (c, j, b) reads the same
// 39.0 MB; (j, b, c), which would keep x and reload A every tile, 54.4 MB.

#define AFNO_HOPPER_STREAM_PARTS
#include "afno_hopper_stream.cu"

namespace {

constexpr int L_BS = 96;        // AFNO block size, the only one admitted
constexpr int L_MAX_HW = 256;   // the A rows of a chunk fit at most this
constexpr int L_NKX = L_MAX_HW / PX;  // 64-px k-blocks of the resident A rows
constexpr int L_NS = 5;         // x ring stages: a 256-px tile and one stage of the next
constexpr int L_NORM_T = 192;   // consumer threads that normalise: 12 columns x 16 rows
constexpr int L_STATS_ROWS = 16;  // rows a statistics thread reads at most
constexpr int XBOX = 32 * PX * 2;     // one x box: 32 channels x 64 px, 64-byte rows
constexpr int X_STAGE = 3 * XBOX;     // an x stage: the block's 96 channels
constexpr int A_BYTES = 2 * L_NKX * BOX;  // A rows [2 parts][L_NKX][64 modes][64 px]
constexpr int WQ0 = L_BS * 128;       // a weight box [96 out][64 in], 128-byte swizzle
constexpr int WQ1 = L_BS * 64;        // [96 out][32 in], 64-byte swizzle
constexpr int W_PART = WQ0 + WQ1;     // one part (wr or wi) of one layer
constexpr int W_LAYER = 2 * W_PART;
constexpr int ZH_BYTES = 3 * BOX;     // [z_re | z_im], then h, then o: [3][64 modes][64]
// spectral_l_kernel's shared memory, byte offsets from a 1024-aligned base
constexpr int L_A_OFF = 0;
constexpr int L_W_OFF = L_A_OFF + A_BYTES;   // W1, then W2
constexpr int L_Z_OFF = L_W_OFF + 2 * W_LAYER;
constexpr int L_X_OFF = L_Z_OFF + ZH_BYTES;
constexpr int L_MISC = L_X_OFF + L_NS * X_STAGE;  // 2 L_NS + 4 mbarriers
constexpr int L_SMEM = L_MISC + 128 + 1024;       // + alignment slack
static_assert(L_SMEM <= SMEM_MAX, "a CTA may use 227 KB of shared memory");
static_assert(8 * (2 * L_NS + 4) <= 128, "the mbarriers fit their bytes");
static_assert(L_STATS_ROWS * (STATS_NT / (2 * L_BS / 8)) >= L_MAX_HW,
              "a statistics thread's rows cover a group of 192 channels");
static_assert(L_W_OFF % 1024 == 0 && L_Z_OFF % 1024 == 0 && L_X_OFF % 1024 == 0 &&
                  WQ0 % 1024 == 0 && W_PART % 1024 == 0 && XBOX % 1024 == 0,
              "swizzled tiles 1024-aligned");

// wgmma shared-memory descriptor of a tile with the 64-byte swizzle (layout
// type 2): K-major with 64-byte rows, 8-row groups sbo = 512 bytes apart;
// MN-major with 32 channels a row, 32-channel atoms lbo bytes apart.
__device__ __forceinline__ uint64_t desc64(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (make_desc(addr, lbo, sbo) & ~(3ull << 62)) | (2ull << 62);
}

constexpr int ACT_NONE = -1;

// Columns 0..95 of a warpgroup's accumulator (+ bias of its columns when
// BIAS, through ACT unless ACT_NONE), rounded to bf16, at columns col0 ..
// col0 + 95 of the swizzled K-major tile [3][64][64] at zh.
template <int ACT, bool BIAS>
__device__ __forceinline__ void put96(uint8_t* zh, const Frag<96>& acc, const float* bias,
                                      int col0) {
#pragma unroll
  for (int i = 0; i < L_BS / 8; ++i) {
    const int c = acc_col(i);
    float2 bv = make_float2(0.f, 0.f);
    if constexpr (BIAS) bv = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc.d[4 * i + 2 * h] + bv.x, v1 = acc.d[4 * i + 2 * h + 1] + bv.y;
      if constexpr (ACT != ACT_NONE) {
        v0 = activate<ACT>(v0);
        v1 = activate<ACT>(v1);
      }
      *swizzled(zh, BOX, acc_row(h), col0 + c) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// grid (groups, B): the f32 GroupNorm mean and 1/std of group g of sample b
// into stats (B, groups, 2), one pass over the group's cpg channels (96 or
// 192) of x. Thread tid owns the 8-channel column tid % cols over rows
// tid / cols, + rstep, ... (threads past cols x rstep idle), at most
// L_STATS_ROWS of them, all loaded before any is summed (in a loop of
// eight loads and a remainder, most would wait an L2 round trip each,
// one after another); its mean m and sum
// q of squared deviations (shifted by its first value) combine into the
// group's mean and variance by Chan's pairwise rule, as
// afno_hopper_stream.cu's stream_stats_kernel (STATS_NT threads too)
// combines them.
__global__ void __launch_bounds__(STATS_NT, 1)
l_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats, int HW, int C,
               int groups) {
  __shared__ float red[STATS_NT / 32];
  // the spectral launch may take the SMs this grid leaves free; it waits
  // for the statistics before it reads them
  launch_dependents();
  const int tid = threadIdx.x, g = blockIdx.x, b = blockIdx.y;
  const int cpg = C / groups, cols = cpg / 8, rstep = STATS_NT / cols, row0 = tid / cols;
  float cnt = 0.f, m = 0.f, q = 0.f;
  if (row0 < rstep && row0 < HW) {
    const bf16* xc = x + static_cast<size_t>(b) * HW * C + g * cpg + 8 * (tid % cols);
    uint4 cells[L_STATS_ROWS];
#pragma unroll
    for (int k = 0; k < L_STATS_ROWS; ++k) {
      const int p = row0 + k * rstep;
      cells[k] = p < HW ? __ldg(reinterpret_cast<const uint4*>(xc + static_cast<size_t>(p) * C))
                        : make_uint4(0u, 0u, 0u, 0u);
    }
    float f[8];
    unpack8(cells[0], f);
    const float shift = f[0];
    float p1[8] = {}, p2[8] = {};
    int rows = 0;
#pragma unroll
    for (int k = 0; k < L_STATS_ROWS; ++k) {
      if (row0 + k * rstep >= HW) break;
      unpack8(cells[k], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = f[e] - shift;
        p1[e] += d;
        p2[e] += d * d;
      }
      ++rows;
    }
    const float s1 = sum8(p1), s2 = sum8(p2);
    cnt = 8.f * rows;
    m = shift + s1 / cnt;
    q = s2 - s1 * s1 / cnt;
  }
  const float n = static_cast<float>(HW) * cpg;
  const float mean = cta_sum(m * cnt, red) / n;
  const float var = cta_sum(q + cnt * (m - mean) * (m - mean), red) / n;
  if (tid == 0) {
    float* st = stats + 2 * (static_cast<size_t>(b) * groups + g);
    st[0] = mean;
    st[1] = rsqrtf(var + EPS);
  }
}

// One complex MLP layer of one block, computed by warpgroup WG: acc = WG's
// part of [a_re | a_im] . W, with a the K-major tile [3][64][64] at zh and
// W the resident layer [part][WQ0 box, WQ1 box] at w (part 0 = wr, 1 = wi).
// Real part (WG 0): a_re . wr - a_im . wi; imaginary (WG 1): a_re . wi +
// a_im . wr. k16 step s of a's 192 columns lies in its real half for s < 6;
// its weight rows are the step's 16 inputs si = s % 6, in the 128-byte box
// for si < 4 and in the 64-byte one after. WG is a template argument so
// that each sign is an immediate and no wgmma sits on a path that depends
// on the thread. The products are committed as one group, in flight on
// return: the caller waits for them (wgmma_wait) before it reads acc.
template <int WG>
__device__ __forceinline__ void mlp96(Frag<96>& acc, uint32_t zh, uint32_t w) {
  zero(acc);
  pin(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 12; ++s) {
    const int half = s / 6, si = s % 6, part = half ? 1 - WG : WG;
    const uint64_t a = desc_k(zh + (s >> 2) * BOX + (s & 3) * 32);
    const uint32_t wp = w + part * W_PART;
    const uint64_t b = si < 4 ? desc_k(wp + si * 32) : desc64(wp + WQ0 + (si - 4) * 32, 16, 512);
    if (WG == 0 && half) acc.template mma<-1, 0>(a, b);
    else acc.template mma<1, 0>(a, b);
  }
  wgmma_commit();
}

// The walk's tiles: t -> block j = t / (nch B), chunk c = t / B % nch,
// sample b = t % B.
struct Walk {
  int nch, B;
  __device__ __forceinline__ int block(int t) const { return t / (nch * B); }
  __device__ __forceinline__ int chunk(int t) const { return t / B % nch; }
};

// grid: min(tiles, SMs) CTAs of NT threads, CTA i walking the tiles
// [i T / G, (i + 1) T / G) of the T = nb nch B tiles (64-mode chunk, block
// j, sample b), nch the chunks walked (ceil(K / 64), one less in the
// control). From x (map_x: (B, HW, C), boxes of 32 channels x 64 px), A
// (map_a: (2, K, HW), boxes of 64 px x 64 modes), the bf16 block weights
// (map_w1 / map_w2: (2, nb, 96 out, 96 in), boxes of 64 inputs; map_w1h /
// map_w2h: boxes of the last 32) and the GroupNorm statistics (B, groups, 2)
// of l_stats_kernel, to o (B, 2K, C), the modes below K. ACT is the mode
// MLP's activation (an ActId): one instance per activation, since nine
// inlined activation epilogues chosen at run time made the kernel's code
// several times as long.
template <int ACT>
__global__ void __launch_bounds__(NT, 1)
spectral_l_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_w1,
                  const __grid_constant__ CUtensorMap map_w1h,
                  const __grid_constant__ CUtensorMap map_w2,
                  const __grid_constant__ CUtensorMap map_w2h,
                  const float* __restrict__ gscale, const float* __restrict__ gbias,
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  const float* stats, bf16* __restrict__ o, int HW, int C, int K, int nb,
                  int groups, int B, int nch) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nkx = HW / PX;
  const Walk walk{nch, B};
  const int tiles = nb * nch * B;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles / gridDim.x);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * tiles / gridDim.x);
  const uint32_t misc = base + L_MISC;
  auto full = [&](int s) { return misc + 8 * s; };
  auto empty = [&](int s) { return misc + 8 * (L_NS + s); };
  const uint32_t a_full = misc + 16 * L_NS, a_empty = a_full + 8;
  const uint32_t w_full = a_full + 16, w_empty = a_full + 24;
  // a tile loads new A rows where its chunk differs from the tile before
  // it in the walk, new weights where its block does
  auto new_a = [&](int t) { return t == t0 || walk.chunk(t) != walk.chunk(t - 1); };
  auto new_w = [&](int t) { return t == t0 || walk.block(t) != walk.block(t - 1); };

  // the synthesis may take SMs that this grid leaves free; it waits for
  // this grid's o before it reads it
  launch_dependents();
  if (tid == 0) {
    for (int s = 0; s < L_NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), EMPTY_ARRIVALS);
    }
    mbar_init(a_full, 1);
    mbar_init(a_empty, EMPTY_ARRIVALS);
    mbar_init(w_full, 1);
    mbar_init(w_empty, EMPTY_ARRIVALS);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NC) {  // the producer warp: one thread issues every load
    if (tid == NC) {
      int it = 0, na = 0, nw = 0;
      for (int t = t0; t < t1; ++t) {
        const int j = walk.block(t), c = walk.chunk(t), b = t % B;
        if (new_a(t)) {  // once the tile before has done its products with the old rows
          if (na) mbar_wait(a_empty, (na - 1) & 1);
          mbar_expect_tx(a_full, 2 * nkx * BOX);
          for (int p = 0; p < 2; ++p)
            for (int kc = 0; kc < nkx; ++kc)
              tma_load_3d(base + L_A_OFF + (p * L_NKX + kc) * BOX, &map_a, a_full, kc * PX,
                          c * MC, p);
          ++na;
        }
        for (int kc = 0; kc < nkx; ++kc, ++it) {
          const int s = it % L_NS, use = it / L_NS;
          if (use) mbar_wait(empty(s), (use - 1) & 1);
          mbar_expect_tx(full(s), X_STAGE);
          for (int h = 0; h < 3; ++h)
            tma_load_3d(base + L_X_OFF + s * X_STAGE + h * XBOX, &map_x, full(s),
                        j * L_BS + 32 * h, kc * PX, b);
        }
        if (new_w(t)) {  // once the tile before has done its second MLP layer
          if (nw) mbar_wait(w_empty, (nw - 1) & 1);
          mbar_expect_tx(w_full, 2 * W_LAYER);
          for (int layer = 0; layer < 2; ++layer)
            for (int p = 0; p < 2; ++p) {
              const uint32_t dst = base + L_W_OFF + layer * W_LAYER + p * W_PART;
              tma_load_4d(dst, layer ? &map_w2 : &map_w1, w_full, 0, 0, j, p);
              tma_load_4d(dst + WQ0, layer ? &map_w2h : &map_w1h, w_full, 64, 0, j, p);
            }
          ++nw;
        }
      }
    }
    return;
  }

  // the consumers. Thread tid < L_NORM_T normalises the 8-channel column lc
  // of rows r0, r0 + 16, r0 + 32, r0 + 48 of an x stage in place (all its
  // cells loaded, then all stored); chunk (p, lc) sits at 16-byte position
  // (lc % 4) ^ ((p / 2) % 4) of row p of box lc / 4 (the 64-byte swizzle).
  // A tile's stages are normalised while the tile before runs its MLP
  // products (the first of them under MLP1, the others under MLP2), so
  // that its analysis is one run of wgmma with no pass over x between.
  const bool norm = tid < L_NORM_T;
  const int lc = tid % 12, r0 = tid / 12, cpg = C / groups;
  uint8_t* zh = sm + L_Z_OFF;
  float nm = 0.f, nr[8], nbi[8];
  // the normalisation constants of tile t for this thread's 8 channels,
  // which lie in one group
  auto constants = [&](int t) {
    if (!norm) return;
    const int c0 = walk.block(t) * L_BS + 8 * lc;
    const float* st = stats + 2 * (static_cast<size_t>(t % B) * groups + c0 / cpg);
    nm = st[0];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      nr[e] = st[1] * __ldg(gscale + c0 + e);
      nbi[e] = __ldg(gbias + c0 + e);
    }
  };
  // x stage q rewritten as round(xn) in place, visible to wgmma
  auto normalise = [&](int q) {
    mbar_wait(full(q % L_NS), (q / L_NS) & 1);
    if (norm) {
      uint8_t* xt = sm + L_X_OFF + q % L_NS * X_STAGE + (lc >> 2) * XBOX;
      uint4 cells[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = r0 + 16 * k;
        cells[k] = *reinterpret_cast<const uint4*>(xt + p * 64 + (((lc & 3) ^ ((p >> 1) & 3)) << 4));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = r0 + 16 * k;
        float f[8];
        unpack8(cells[k], f);
        uint4 u;
        __nv_bfloat162* hq = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hq[e] = __floats2bfloat162_rn((f[2 * e] - nm) * nr[2 * e] + nbi[2 * e],
                                        (f[2 * e + 1] - nm) * nr[2 * e + 1] + nbi[2 * e + 1]);
        *reinterpret_cast<uint4*>(xt + p * 64 + (((lc & 3) ^ ((p >> 1) & 3)) << 4)) = u;
      }
    }
    fence_proxy_async();
  };

  wait_primary();  // the statistics
  int it = 0, na = 0, nw = 0;
  constants(t0);
  for (int q = 0; q < nkx; ++q) normalise(q);
  for (int t = t0; t < t1; ++t) {
    const int j = walk.block(t), c = walk.chunk(t), b = t % B;
    na += new_a(t);
    nw += new_w(t);
    const bool last = t + 1 == t1;

    // z = A . xn, warpgroup wg part wg of the chunk's modes, once every
    // stage of the tile is xn; then its stages go back to the producer
    mbar_wait(a_full, (na - 1) & 1);
    consumer_sync();
    Frag<96> za;
    zero(za);
    pin(za);
    wgmma_fence();
    for (int kc = 0; kc < nkx; ++kc) {
      const uint32_t xs = base + L_X_OFF + (it + kc) % L_NS * X_STAGE;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        za.template mma<1, 1>(desc_k(base + L_A_OFF + (wg * L_NKX + kc) * BOX + kk * 32),
                              desc64(xs + kk * 16 * 64, XBOX, 512));
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(za);
    for (int kc = 0; kc < nkx; ++kc) release(empty((it + kc) % L_NS));
    it += nkx;
    if (!last) {
      if (new_a(t + 1)) release(a_empty);
      constants(t + 1);
    }

    // z rounded into [z_re | z_im]: warpgroup wg's columns 96 wg .. 96 wg + 95
    put96<ACT_NONE, false>(zh, za, nullptr, L_BS * wg);
    fence_proxy_async();
    consumer_sync();

    // h = act([z_re | z_im] . W1 + B1), rounded, over z once both
    // warpgroups are done reading z; the next tile's first stage is
    // normalised while the products run
    const uint32_t z = base + L_Z_OFF, w1 = base + L_W_OFF, w2 = w1 + W_LAYER;
    mbar_wait(w_full, (nw - 1) & 1);
    Frag<96> acc;
    if (wg == 0) mlp96<0>(acc, z, w1);
    else mlp96<1>(acc, z, w1);
    if (!last) normalise(it);
    wgmma_wait<0>();
    pin(acc);
    consumer_sync();
    put96<ACT, true>(zh, acc, b1 + (static_cast<size_t>(wg) * nb + j) * L_BS, L_BS * wg);
    fence_proxy_async();
    consumer_sync();

    // o = [h_re | h_im] . W2 + B2, rounded, over h once both warpgroups
    // are done reading it (the next tile's other stages normalised while
    // the products run); then warpgroup wg stores part wg's rows below K
    // to o, 16 bytes a thread
    if (wg == 0) mlp96<0>(acc, z, w2);
    else mlp96<1>(acc, z, w2);
    if (!last)
      for (int q = 1; q < nkx; ++q) normalise(it + q);
    wgmma_wait<0>();
    pin(acc);
    if (!last && new_w(t + 1)) release(w_empty);
    consumer_sync();
    put96<ACT_NONE, true>(zh, acc, b2 + (static_cast<size_t>(wg) * nb + j) * L_BS, L_BS * wg);
    warpgroup_sync(wg);
    const int m0 = c * MC, rows = K - m0 < MC ? K - m0 : MC;
    bf16* ob = o + (static_cast<size_t>(b) * 2 * K + (wg ? K : 0) + m0) * C + j * L_BS;
    for (int q = tid & 127; q < rows * (L_BS / 8); q += 128) {
      const int r = q / (L_BS / 8), cc = 8 * (q % (L_BS / 8));
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(r) * C + cc) =
          *reinterpret_cast<const uint4*>(swizzled(zh, BOX, r, L_BS * wg + cc));
    }
  }
}

}  // namespace

// The shapes this kernel takes, as `hopper_l_supported` in
// dpot_tpu_torch/ops/cuda/afno_fused.py states them (the dtype is bf16).
extern "C" int dpot_afno_hopper_l_supported(int B, int HW, int C, int K, int nb, int groups) {
  if (B < 1 || B > 65535 || nb < 1 || C != nb * L_BS || C % TILE_C || groups < 1 || C % groups)
    return 0;
  if (HW % TILE_P || HW > L_MAX_HW || K < 1 || K % 4 || (2 * K + 63) / 64 > MAX_NK) return 0;
  const int cpg = C / groups;
  return cpg == L_BS || cpg == 2 * L_BS;
}

namespace {

int run_l(int act, const void* x, const float* gscale, const float* gbias, const void* A,
          const void* Ainv, const void* w1t, const float* b1, const void* w2t, const float* b2,
          float* stats, void* o, void* out, int B, int HW, int C, int K, int nb, int groups,
          bool drop, void* stream) {
  if (!dpot_afno_hopper_l_supported(B, HW, C, K, nb, groups) || act < 0 || act >= ACT_COUNT)
    return cudaErrorInvalidValue;
  const void* ptrs[] = {x, A, Ainv, w1t, w2t, o, out};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  if ((reinterpret_cast<uintptr_t>(b1) | reinterpret_cast<uintptr_t>(b2)) & 7)
    return cudaErrorMisalignedAddress;  // read as float2
  const int nch = (K + MC - 1) / MC - (drop ? 1 : 0);
  if (nch < 1) return cudaErrorInvalidValue;  // the control needs a chunk left
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  const int sms = sm_count(dev);
  if (!sms) return cudaErrorInvalidDevice;

  const uint64_t UB = static_cast<uint64_t>(B), UC = C, UHW = HW, UK = K, UBS = L_BS, UNB = nb;
  const uint64_t dx[3] = {UC, UHW, UB}, da[3] = {UHW, UK, 2}, dw[4] = {UBS, UBS, UNB, 2};
  const uint32_t bx[3] = {32, PX, 1}, ba[3] = {PX, MC, 1}, bw[4] = {64, L_BS, 1, 1},
                 bwh[4] = {32, L_BS, 1, 1};
  constexpr CUtensorMapSwizzle SW64 = CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mx, ma, mw1, mw1h, mw2, mw2h;
  CUresult r;
  if ((r = tensor_map(&mx, x, 3, dx, bx, false, SW64)) != CUDA_SUCCESS ||
      (r = tensor_map(&ma, A, 3, da, ba, true)) != CUDA_SUCCESS ||
      (r = tensor_map(&mw1, w1t, 4, dw, bw, true)) != CUDA_SUCCESS ||
      (r = tensor_map(&mw1h, w1t, 4, dw, bwh, true, SW64)) != CUDA_SUCCESS ||
      (r = tensor_map(&mw2, w2t, 4, dw, bw, true)) != CUDA_SUCCESS ||
      (r = tensor_map(&mw2h, w2t, 4, dw, bwh, true, SW64)) != CUDA_SUCCESS)
    return 10000 + static_cast<int>(r);

  l_stats_kernel<<<dim3(groups, B), STATS_NT, 0, s>>>(static_cast<const bf16*>(x), stats, HW, C,
                                                      groups);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int tiles = nb * nch * B, grid = tiles < sms ? tiles : sms;
  e = dispatch_act(act, [&](auto tag) {
    constexpr int ACT = decltype(tag)::id;
    static bool done[64] = {};
    const cudaError_t err = allow_smem(spectral_l_kernel<ACT>, L_SMEM, done, dev);
    if (err != cudaSuccess) return err;
    return launch_dependent(spectral_l_kernel<ACT>, dim3(grid), L_SMEM, s, mx, ma, mw1, mw1h,
                            mw2, mw2h, gscale, gbias, b1, b2, static_cast<const float*>(stats),
                            static_cast<bf16*>(o), HW, C, K, nb, groups, B, nch);
  });
  if (e != cudaSuccess) return e;

  // the synthesis tile: 256 channels where C takes them and the grid
  // still fills half the card, else 128 where it fills the card, else 64
  const Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(A),
               static_cast<const bf16*>(Ainv), static_cast<const bf16*>(w1t),
               static_cast<const bf16*>(w2t), gscale, gbias, b1, b2, stats,
               static_cast<bf16*>(o), static_cast<bf16*>(out), B, HW, HW, C, K, K, nb, groups,
               act};
  const long long ptiles = static_cast<long long>(HW / SYN_P) * B;
  if (C % 256 == 0 && 2 * ptiles * (C / 256) >= sms) return launch_synthesis_tn<256>(dev, a, s);
  if (ptiles * (C / 128) >= sms) return launch_synthesis_tn<128>(dev, a, s);
  return launch_synthesis_tn<64>(dev, a, s);
}

}  // namespace

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
  return run_l(act, x, gscale, gbias, A, Ainv, w1t, b1, w2t, b2, stats, o, out, B, HW, C, K, nb,
               groups, false, stream);
}

// A control for the checks that hold this kernel against its plain
// version, never called by the port: the same call with the walk's last
// mode chunk left out of every block and sample (o is cleared first, so its
// rows are zero, as a walk that missed those tiles would leave them):
// modes 128-143 of K 144, 64-79 of K 80. Refused where K <= 64 (one chunk:
// there would be nothing left).
extern "C" int dpot_afno_hopper_l_drop_last_chunk(
    int act, const void* x, const float* gscale, const float* gbias, const void* A,
    const void* Ainv, const void* w1t, const float* b1, const void* w2t, const float* b2,
    float* stats, void* o, void* out, int B, int HW, int C, int K, int nb, int groups,
    void* stream) {
  if (B < 1 || K < 1) return cudaErrorInvalidValue;
  const cudaError_t e = cudaMemsetAsync(o, 0, static_cast<size_t>(B) * 2 * K * C * sizeof(bf16),
                                        static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return run_l(act, x, gscale, gbias, A, Ainv, w1t, b1, w2t, b2, stats, o, out, B, HW, C, K, nb,
               groups, true, stream);
}
