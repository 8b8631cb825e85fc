// Fused GroupNorm + AFNO spectral mixer in bf16 for every latent up to 4096
// pixels and every mode count, designed for Hopper (sm_90a): three launches,
// z and h kept on chip, x, A, the block weights, o and Ainv streamed through
// shared memory in chunks, so that neither the latent nor the kept modes
// (2K) are capped by what a CTA holds.
//
// Replaces, for bf16 operands at the shapes that `hopper_stream_supported`
// (dpot_tpu_torch/ops/cuda/afno_fused.py) admits, the TPU kernel
// `fused_gn_afno` of dpot_tpu/ops/pallas/afno_fused.py (`_kernel`, launched
// by `_fused_fwd`, line 114), which takes latents up to 4096 px. It computes
// and rounds what afno_fused.cu and the plain version `fused_gn_afno_ref`
// do: GroupNorm in f32 (eps 1e-5), z = A . round(xn) rounded to bf16, per
// AFNO block j h = round(act([z_re | z_im] . W1_j + B1_j)), o = round(h .
// W2_j + B2_j), out = round(Ainv . o + xn) with the f32 xn; every product
// takes bf16 operands and accumulates in f32.
//
// Why it exists. The other bf16 Hopper kernels (afno_hopper{,_wide,_l}.cu)
// hold the block's whole x slab and A's rows in shared memory and all of o
// in a synthesis CTA, so they take 128- and 256-px latents with 2K <= 320
// only: a 64^2 grid at patch 8 (an 8^2 latent, K 40) or a 256^2 grid (a
// 32^2 latent, K 544) left every bf16 trunk block on the five-launch
// afno_fused.cu, which sends z, h and o through device memory on 64 x 64
// WMMA tiles staged in registers.
//
// What bounds it. At DPOT-M's 32^2 latent (HW 1024, C 1024, K 544, nb 8,
// bs 128) a sample is 5.7 GFLOP against about 6.6 MB of operands, so from
// B = 1 up it is bound by tensor-core operations (0.0058 ms a sample at 989
// TFLOP/s); at the 8^2 latent (HW 64, K 40) a sample is 0.105 GFLOP, bound
// by bytes up to B ~ 8 and by latency at B = 1. The design is
// afno_hopper_f32.cu's, in bf16, with the statistics in a launch of their
// own:
//
//   1. stream_stats_kernel, one CTA per (GroupNorm group, sample): the f32
//      statistics in one pass over the group's columns of x, each thread's
//      shifted sums over an 8-channel column combined by Chan's pairwise
//      rule. (In the spectral launch, as afno_hopper_f32.cu has them, every
//      mode chunk's CTA read its group again: 20 % of a call at M's 32^2
//      latent and B = 20, 39 % at L's with its groups of a block pair, on
//      the H100, tools/afno_stream_variants.py no_stats.)
//   2. stream_spectral_kernel, one CTA of 2 bs / 32 warps per (chunk of MC
//      modes, AFNO block j, sample b): z = A . xn streams 64-pixel chunks of
//      x and of the chunk's A rows through a ring of NS (three) cp.async
//      stages, normalising x in registers as its fragments load (the modes
//      past K are zero-filled rows of A); z stays in shared memory, rounded
//      to bf16; both MLP layers stream the block's weights (the cached bf16
//      copies, each block transposed to (out, in)) in 32-input chunks
//      through the same ring, h written over z; o (B, 2K, C) bf16 is the
//      only intermediate that goes to device memory;
//   3. stream_synthesis_kernel, one CTA of 4 warps per (32 MT pixels, 64
//      channels, sample b): out = Ainv . o streaming 32-mode chunks of
//      Ainv's columns and o's rows through a three-stage cp.async ring (the
//      chunk past 2K zero-filled in both, so no cap on 2K), with an epilogue
//      that adds the f32 xn recomputed from x and the statistics.
//
// Ragged latents and odd K. The launches work on whole 64-pixel tiles and an
// even count of modes: HWp = HW rounded up to 64, Kp = K rounded up to even
// (so that Ainv's rows are whole 8-byte units). The caller passes A (2Kp,
// HWp) and Ainv (HWp, 2Kp) padded with zeros (`padded_ops` in the wrapper)
// and o (B, 2Kp, C); x and out keep their HW rows. x rows past HW load as
// zeros (cp.async with a source size of 0, never read), the statistics run
// over the HW real rows, and the synthesis stores rows below HW only. A
// padded pixel meets a zero column of A and a padded mode a zero column of
// Ainv, so the result is the unpadded one exactly. (Masking A's and Ainv's
// ragged edges in the kernel instead would break the 16- and 8-byte copies
// of their rows, whose strides HW and 2K are then not whole units.)
//
// Products are warp-level mma.sync m16n8k16 bf16 with f32 accumulation,
// fragments loaded with ldmatrix (.trans for the operands whose channels
// are contiguous: xn and o); every shared-memory row is padded by 16 bytes
// (an odd number of 16-byte units), so the eight rows an ldmatrix reads fall
// in distinct bank groups. A warp computes a (16 MT) x 32 tile: MT = 1
// (16-mode chunks, 32-px synthesis tiles) when the spectral grid at 16-mode
// chunks has no more CTAs than the card has SMs, else MT = 2, as in
// afno_hopper_f32.cu. The activation is a runtime argument (it runs once an
// element of h), so the library holds one instance per block size and MT.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "activation.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int PAD = 8;           // bf16 of padding per shared-memory row
constexpr int KC = 64;           // pixels per analysis stage
constexpr int KW = 32;           // weight inputs per MLP stage
constexpr int KS = 32;           // mode rows (of 2K) per synthesis stage
constexpr int MAX_MC = 32;       // modes per spectral CTA at MT = 2
constexpr int LDA = KC + PAD;    // A tiles [2 MC][LDA]
constexpr int LDW = KW + PAD;    // weight tiles [2 parts][bs out][LDW]
constexpr int TC = 64;           // channels per synthesis CTA
constexpr int MAX_TP = 64;       // pixels per synthesis CTA at MT = 2
constexpr int LDI = KS + PAD;    // Ainv tiles [TP][LDI]
constexpr int LDO = TC + PAD;    // o tiles [KS][LDO]
constexpr int SYN_NT = 128;      // threads per synthesis CTA
constexpr int STATS_NT = 256;    // threads per statistics CTA
constexpr int NS = 3;           // stages of the spectral launch's ring
constexpr int SYN_STAGES = 3;
constexpr float EPS = 1e-5f;     // torch.nn.GroupNorm default
constexpr int MAX_HW = 4096;     // the combined-operator DFT's limit

// stream_spectral_kernel's layout at AFNO block size BS
template <int BS> struct Geo {
  static constexpr int WPH = BS / 32;                    // warps per output half
  static constexpr int NT = 2 * BS;                      // threads: 2 WPH warps
  static constexpr int LDX = BS + PAD;                   // x tiles [KC][LDX]
  static constexpr int LDZ = 2 * BS + PAD;               // z and h [MC][LDZ]
  static constexpr int X_STAGE = KC * LDX + 2 * MAX_MC * LDA;  // bf16
  static constexpr int W_STAGE = 2 * BS * LDW;                 // bf16
  static constexpr int STAGE = X_STAGE > W_STAGE ? X_STAGE : W_STAGE;
  static constexpr int Z_OFF = NS * STAGE * 2;           // bytes
  static constexpr int COL_OFF = Z_OFF + MAX_MC * LDZ * 2;  // mean, rstd * gscale, gbias
  static constexpr int SMEM = COL_OFF + 3 * BS * 4;
  static constexpr int MIN_CTAS = BS <= 64 ? 4 : BS <= 128 ? 2 : 1;
  static_assert(SMEM <= 232448, "a CTA may use 227 KB of shared memory");
  static_assert(BS % 32 == 0 && BS % KW == 0, "warp tiles of 32 columns");
};
constexpr int SYN_STAGE = MAX_TP * LDI + KS * LDO;  // bf16
constexpr int SYN_SMEM = SYN_STAGES * SYN_STAGE * 2 + 3 * TC * 4;

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (8) bytes global -> shared, asynchronously; zeros when !valid (src is
// then not read, but must be a mapped address).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The (16 MT) x 32 f32 accumulator of one warp: MT m16 tiles by four n8
// tiles. Element e of tile (mt, nt) of a thread sits at row 16 mt + lane /
// 4 + 8 (e / 2) and column 8 nt + 2 (lane % 4) + e % 2.
template <int MT> using WarpAcc = float[MT][4][4];

template <int MT> __device__ __forceinline__ void zero(WarpAcc<MT>& acc) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// A fragments of rows r0 .. r0 + 16 MT - 1, depth k0 .. k0 + 15, of a
// row-major tile [rows][ld] (m16n8k16's a0..a3 per m16 tile)
template <int MT>
__device__ __forceinline__ void load_a(uint32_t (&a)[MT][4], const bf16* tile, int ld, int r0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    ldsm(a[mt], tile + (r0 + 16 * mt + (lane & 15)) * ld + k0 + 8 * (lane >> 4));
}

// B fragments (b0, b1 of four n8 tiles) of depth k0 .. k0 + 15 and columns
// n0 .. n0 + 31 of a tile stored [depth][ld] (columns contiguous)
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4][2], const bf16* tile, int ld, int k0,
                                          int n0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t r[4];
    ldsm_t(r, tile + (k0 + (lane & 15)) * ld + n0 + 16 * h + 8 * (lane >> 4));
    b[2 * h][0] = r[0];
    b[2 * h][1] = r[1];
    b[2 * h + 1][0] = r[2];
    b[2 * h + 1][1] = r[3];
  }
}

// the same from a tile stored [column][ld] (depth contiguous: the
// transposed weight copies)
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4][2], const bf16* tile, int ld, int k0,
                                          int n0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t r[4];
    ldsm(r, tile + (n0 + 16 * h + (lane & 7) + 8 * (lane >> 4)) * ld + k0 + 8 * ((lane >> 3) & 1));
    b[2 * h][0] = r[0];
    b[2 * h][1] = r[1];
    b[2 * h + 1][0] = r[2];
    b[2 * h + 1][1] = r[3];
  }
}

template <int MT>
__device__ __forceinline__ void mma_tile(WarpAcc<MT>& acc, uint32_t (&a)[MT][4],
                                         uint32_t (&b)[4][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
}

// the activation of the runtime id act (< ACT_COUNT)
__device__ __forceinline__ float activate_id(int act, float v) {
  switch (act) {
    case ACT_GELU_TANH: return activate<ACT_GELU_TANH>(v);
    case ACT_GELU_ERF: return activate<ACT_GELU_ERF>(v);
    case ACT_TANH: return activate<ACT_TANH>(v);
    case ACT_SIGMOID: return activate<ACT_SIGMOID>(v);
    case ACT_RELU: return activate<ACT_RELU>(v);
    case ACT_LEAKY_RELU: return activate<ACT_LEAKY_RELU>(v);
    case ACT_SOFTPLUS: return activate<ACT_SOFTPLUS>(v);
    case ACT_ELU: return activate<ACT_ELU>(v);
    default: return activate<ACT_SILU>(v);
  }
}

// Inputs 32 ci .. 32 ci + 31 of block j's transposed weights, both parts
// ([part][bs out][LDW]), into a ring slot.
template <int BS>
__device__ __forceinline__ void load_w_chunk(bf16* slot, const bf16* w, int j, int nb, int ci) {
  for (int q = threadIdx.x; q < 2 * BS * (KW / 8); q += Geo<BS>::NT) {
    const int p = q / (BS * KW / 8), r = (q / (KW / 8)) % BS, c8 = q % (KW / 8);
    cp16(slot + (p * BS + r) * LDW + 8 * c8,
         w + ((static_cast<size_t>(p) * nb + j) * BS + r) * BS + KW * ci + 8 * c8, true);
  }
}

// The first NS - 1 chunks of a layer's weights into ring slots 0 .. NS - 2,
// a cp.async group each (empty past the last chunk).
template <int BS>
__device__ __forceinline__ void prefetch_w(bf16* ring, const bf16* w, int j, int nb) {
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < BS / KW) load_w_chunk<BS>(ring + s * Geo<BS>::STAGE, w, j, nb, s);
    cp_commit();
  }
}

// One complex MLP layer of block j for the CTA's 16 MT modes: acc = [a_re |
// a_im] . [[wr, wi], [-wi, wr]] for the warp's 32 output columns (output
// half warp / WPH), a in zb [16 MT][LDZ], w the layer's transposed bf16
// weights (2, nb, out, in) streamed in 32-input chunks through the NS-slot
// ring, whose first NS - 1 chunks are in flight (prefetch_w). The minus is
// a flip of the wi fragments' sign bits (exact).
template <int BS, int MT>
__device__ __forceinline__ void complex_layer(WarpAcc<MT>& acc, bf16* ring, const bf16* zb,
                                              const bf16* w, int j, int nb) {
  using G = Geo<BS>;
  const int warp = threadIdx.x >> 5, po = warp / G::WPH, o0 = 32 * (warp % G::WPH);
  zero<MT>(acc);
  constexpr int NCH = BS / KW;
  for (int ci = 0; ci < NCH; ++ci) {
    if (ci + NS - 1 < NCH) load_w_chunk<BS>(ring + (ci + NS - 1) % NS * G::STAGE, w, j, nb,
                                            ci + NS - 1);
    cp_commit();
    cp_wait<NS - 1>();
    __syncthreads();
    const bf16* ws = ring + ci % NS * G::STAGE;
#pragma unroll
    for (int sp = 0; sp < 2; ++sp) {
      // source half sp of [a_re | a_im] meets wr when it matches the output
      // half po, else wi, negated for the real output
      const bf16* wt = ws + (sp == po ? 0 : BS * LDW);
      const uint32_t flip = (po == 0 && sp == 1) ? 0x80008000u : 0u;
      const bf16* at = zb + sp * BS + KW * ci;
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        uint32_t a[MT][4], b[4][2];
        load_a<MT>(a, at, G::LDZ, 0, 16 * kk);
        load_b_nk(b, wt, LDW, 16 * kk, o0);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          b[nt][0] ^= flip;
          b[nt][1] ^= flip;
        }
        mma_tile<MT>(acc, a, b);
      }
    }
    __syncthreads();  // the slot is free for the chunk NS - 1 ahead
  }
}

// Sum of v over the CTA of STATS_NT threads, returned to every thread. red:
// STATS_NT / 32 floats.
__device__ __forceinline__ float cta_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < STATS_NT / 32; ++w) s += red[w];
  __syncthreads();  // red may be written again
  return s;
}

// grid (groups, B): the f32 GroupNorm mean and 1/std of group g of sample b
// into stats (B, groups, 2), one pass from L2 over the group's channels.
// Thread tid owns the 8-channel column tid % cols over rows tid / cols, +
// rstep, ... (threads past cols x rstep idle); its mean m and sum q of
// squared deviations (shifted by its first value) combine into the group's
// mean and variance by Chan's pairwise rule.
__global__ void __launch_bounds__(STATS_NT)
stream_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats, int HW, int C,
                    int groups) {
  __shared__ float red[STATS_NT / 32];
  const int tid = threadIdx.x, g = blockIdx.x, b = blockIdx.y;
  const int cpg = C / groups, cols = cpg / 8, rstep = STATS_NT / cols, row0 = tid / cols;
  float cnt = 0.f, m = 0.f, q = 0.f;
  if (row0 < rstep && row0 < HW) {
    const bf16* xc = x + static_cast<size_t>(b) * HW * C + g * cpg + 8 * (tid % cols);
    const float shift = __bfloat162float(xc[static_cast<size_t>(row0) * C]);
    float p1[8] = {}, p2[8] = {};
    int rows = 0;
#pragma unroll 4
    for (int p = row0; p < HW; p += rstep, ++rows) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(xc + static_cast<size_t>(p) * C));
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(w4[e]);
        const float d0 = f.x - shift, d1 = f.y - shift;
        p1[2 * e] += d0;
        p2[2 * e] += d0 * d0;
        p1[2 * e + 1] += d1;
        p2[2 * e + 1] += d1 * d1;
      }
    }
    const float s1 = ((p1[0] + p1[1]) + (p1[2] + p1[3])) + ((p1[4] + p1[5]) + (p1[6] + p1[7]));
    const float s2 = ((p2[0] + p2[1]) + (p2[2] + p2[3])) + ((p2[4] + p2[5]) + (p2[6] + p2[7]));
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

// grid (chunks, nb, B), chunks = ceil(K / MC), MC = 16 MT: modes chunk * MC
// .. + MC - 1 of AFNO block j of sample b, from x (B, HW, C) and A (2K, HWp)
// to o (B, 2K, C), with the GroupNorm statistics (B, groups, 2) of
// stream_stats_kernel. K is even here (the padded Kp).
template <int BS, int MT>
__global__ void __launch_bounds__(Geo<BS>::NT, Geo<BS>::MIN_CTAS)
stream_spectral_kernel(const bf16* __restrict__ x, const float* __restrict__ gscale,
                       const float* __restrict__ gbias, const bf16* __restrict__ A,
                       const bf16* __restrict__ w1, const float* __restrict__ b1,
                       const bf16* __restrict__ w2, const float* __restrict__ b2,
                       const float* __restrict__ stats, bf16* __restrict__ o, int HW, int HWp,
                       int C, int K, int nb, int groups, int act) {
  using G = Geo<BS>;
  constexpr int MC = 16 * MT, NT = G::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* zb = reinterpret_cast<bf16*>(smem + G::Z_OFF);
  float* s_mean = reinterpret_cast<float*>(smem + G::COL_OFF);
  float* s_rs = s_mean + BS;
  float* s_bi = s_rs + BS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int chunk = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int m0 = chunk * MC;
  const bf16* xb = x + static_cast<size_t>(b) * HW * C + j * BS;

  // ring slot s of the z phase: x rows [KC][LDX] (rows past HW zero-filled),
  // then A rows [2 MC][LDA] (rows 0 .. MC - 1 the chunk's real parts, then
  // its imaginary parts; modes past K zero-filled)
  auto load_x_stage = [&](int s, int kc) {
    bf16* xs = ring + s * G::STAGE;
    bf16* as = xs + KC * G::LDX;
    const int p0 = kc * KC;
    for (int q = tid; q < KC * (BS / 8); q += NT) {
      const int r = q / (BS / 8), c8 = q % (BS / 8), p = p0 + r;
      cp16(xs + r * G::LDX + 8 * c8, xb + static_cast<size_t>(p < HW ? p : 0) * C + 8 * c8,
           p < HW);
    }
    for (int q = tid; q < 2 * MC * (KC / 8); q += NT) {
      const int r = q / (KC / 8), c8 = q % (KC / 8), m = m0 + (r % MC);
      const bool valid = m < K;
      const int row = (r < MC ? 0 : K) + (valid ? m : 0);
      cp16(as + r * LDA + 8 * c8, A + static_cast<size_t>(row) * HWp + p0 + 8 * c8, valid);
    }
  };
  const int nkc = HWp / KC;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nkc) load_x_stage(s, s);
    cp_commit();
  }

  // the GroupNorm constants of the block's channels, from the statistics
  // that stream_stats_kernel left
  if (tid < BS) {
    const int c = j * BS + tid;
    const float* st = stats + 2 * (static_cast<size_t>(b) * groups + c / (C / groups));
    s_mean[tid] = st[0];
    s_rs[tid] = st[1] * __ldg(gscale + c);
    s_bi[tid] = __ldg(gbias + c);
  }
  __syncthreads();

  // z = A . xn: warp w computes rows MC (w / WPH) .. of [re; im] (the real
  // or imaginary parts of the MC modes) by channels 32 (w % WPH) ..; each
  // B fragment register holds two pixels of one channel, normalised and
  // rounded to bf16 in registers
  const int rb = MC * (warp / G::WPH), cb = 32 * (warp % G::WPH);
  float nm[4], nr[4], nbias[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = cb + 8 * nt + g;
    nm[nt] = s_mean[c];
    nr[nt] = s_rs[c];
    nbias[nt] = s_bi[c];
  }
  WarpAcc<MT> acc;
  zero<MT>(acc);
  for (int kc = 0; kc < nkc; ++kc) {
    if (kc + NS - 1 < nkc) load_x_stage((kc + NS - 1) % NS, kc + NS - 1);
    cp_commit();
    cp_wait<NS - 1>();
    __syncthreads();
    const bf16* xs = ring + kc % NS * G::STAGE;
    const bf16* as = xs + KC * G::LDX;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t a[MT][4], bx[4][2];
      load_a<MT>(a, as, LDA, rb, 16 * kk);
      load_b_kn(bx, xs, G::LDX, 16 * kk, cb);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 f = unpack_bf16(bx[nt][i]);
          bx[nt][i] = pack_bf16((f.x - nm[nt]) * nr[nt] + nbias[nt],
                                (f.y - nm[nt]) * nr[nt] + nbias[nt]);
        }
      mma_tile<MT>(acc, a, bx);
    }
    __syncthreads();
  }

  // z to shared memory as [z_re | z_im] per mode, rounded to bf16; the
  // first W1 chunks load
  prefetch_w<BS>(ring, w1, j, nb);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h, c = (rb ? BS : 0) + cb + 8 * nt + 2 * t;
        *reinterpret_cast<uint32_t*>(zb + r * G::LDZ + c) =
            pack_bf16(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  __syncthreads();

  // h = act([z_re | z_im] . W1 + B1), rounded to bf16, over z. Warp w:
  // output half w / WPH (re, im), columns 32 (w % WPH) .. of it.
  const int po = warp / G::WPH, o0 = 32 * (warp % G::WPH);
  complex_layer<BS, MT>(acc, ring, zb, w1, j, nb);
  prefetch_w<BS>(ring, w2, j, nb);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = o0 + 8 * nt + 2 * t;
    const float* bias = b1 + (static_cast<size_t>(po) * nb + j) * BS + c;
    const float bb0 = __ldg(bias), bb1 = __ldg(bias + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + g + 8 * h;
        *reinterpret_cast<uint32_t*>(zb + r * G::LDZ + po * BS + c) =
            pack_bf16(activate_id(act, acc[mt][nt][2 * h] + bb0),
                      activate_id(act, acc[mt][nt][2 * h + 1] + bb1));
      }
  }
  __syncthreads();

  // o = [h_re | h_im] . W2 + B2, rounded to bf16, to device memory (rows
  // past K dropped)
  complex_layer<BS, MT>(acc, ring, zb, w2, j, nb);
  bf16* ob = o + (static_cast<size_t>(b) * 2 * K + (po ? K : 0)) * C + j * BS;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = o0 + 8 * nt + 2 * t;
    const float* bias = b2 + (static_cast<size_t>(po) * nb + j) * BS + c;
    const float bb0 = __ldg(bias), bb1 = __ldg(bias + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mode = m0 + 16 * mt + g + 8 * h;
        if (mode < K)
          *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(mode) * C + c) =
              pack_bf16(acc[mt][nt][2 * h] + bb0, acc[mt][nt][2 * h + 1] + bb1);
      }
  }
}

// grid (HWp / TP, C / 64, B), TP = 32 MT: out[b] = Ainv . o[b] + xn[b] for
// TP pixels and 64 channels, xn recomputed in f32 from x and the
// statistics; rows past HW (Ainv's padded zero rows) are computed and not
// stored. Warp w computes pixels 16 MT (w / 2) .. by channels 32 (w % 2)
// ... Ainv's rows are 4K bytes, a multiple of 8 (K even, the padded Kp), so
// its tiles load in 8-byte units, which never straddle 2K (a multiple of 4).
template <int MT>
__global__ void __launch_bounds__(SYN_NT)
stream_synthesis_kernel(const bf16* __restrict__ Ainv, const bf16* __restrict__ o,
                        const bf16* __restrict__ x, const float* __restrict__ stats,
                        const float* __restrict__ gscale, const float* __restrict__ gbias,
                        bf16* __restrict__ out, int HW, int C, int K, int groups) {
  constexpr int TP = 32 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * TP, n0 = blockIdx.y * TC, b = blockIdx.z;
  const int K2 = 2 * K, nk = (K2 + KS - 1) / KS;
  const bf16* ob = o + static_cast<size_t>(b) * K2 * C + n0;

  // ring slot s: Ainv [TP][LDI] (columns KS kb ..), then o [KS][LDO] (rows
  // KS kb ..), both zero past 2K
  auto load_stage = [&](int s, int kb) {
    bf16* as = ring + s * SYN_STAGE;
    bf16* os = as + MAX_TP * LDI;
    for (int q = tid; q < TP * (KS / 4); q += SYN_NT) {
      const int r = q / (KS / 4), c4 = q % (KS / 4), k = kb * KS + 4 * c4;
      cp8(as + r * LDI + 4 * c4, Ainv + static_cast<size_t>(p0 + r) * K2 + (k < K2 ? k : 0),
          k < K2);
    }
    for (int q = tid; q < KS * (TC / 8); q += SYN_NT) {
      const int r = q / (TC / 8), c8 = q % (TC / 8), k = kb * KS + r;
      cp16(os + r * LDO + 8 * c8, ob + static_cast<size_t>(k < K2 ? k : 0) * C + 8 * c8, k < K2);
    }
  };
  for (int s = 0; s < SYN_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_commit();
  }
  float* col_mean = reinterpret_cast<float*>(smem + SYN_STAGES * SYN_STAGE * 2);
  float* col_rs = col_mean + TC;
  float* col_bias = col_rs + TC;
  if (tid < TC) {
    const int c = n0 + tid;
    const size_t s = 2 * (static_cast<size_t>(b) * groups + c / (C / groups));
    col_mean[tid] = stats[s];
    col_rs[tid] = stats[s + 1] * gscale[c];
    col_bias[tid] = gbias[c];
  }

  const int rb = 16 * MT * (warp >> 1), cb = 32 * (warp & 1);
  WarpAcc<MT> acc;
  zero<MT>(acc);
  for (int kb = 0; kb < nk; ++kb) {
    const int next = kb + SYN_STAGES - 1;
    if (next < nk) load_stage(next % SYN_STAGES, next);
    cp_commit();
    cp_wait<SYN_STAGES - 1>();
    __syncthreads();
    const bf16* as = ring + (kb % SYN_STAGES) * SYN_STAGE;
    const bf16* os = as + MAX_TP * LDI;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t a[MT][4], bo[4][2];
      load_a<MT>(a, as, LDI, rb, 16 * kk);
      load_b_kn(bo, os, LDO, 16 * kk, cb);
      mma_tile<MT>(acc, a, bo);
    }
    __syncthreads();
  }

  // out = round(acc + xn), rows below HW
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int cl = cb + 8 * nt + 2 * t, c = n0 + cl;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + rb + 16 * mt + g + 8 * h;
        if (p >= HW) continue;
        const size_t at = (static_cast<size_t>(b) * HW + p) * C + c;
        const float2 xv = unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(x + at)));
        const float xn0 = (xv.x - col_mean[cl]) * col_rs[cl] + col_bias[cl];
        const float xn1 = (xv.y - col_mean[cl + 1]) * col_rs[cl + 1] + col_bias[cl + 1];
        *reinterpret_cast<uint32_t*>(out + at) =
            pack_bf16(acc[mt][nt][2 * h] + xn0, acc[mt][nt][2 * h + 1] + xn1);
      }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Lets stream_spectral_kernel<BS, MT> and stream_synthesis_kernel<MT> use
// the dynamic shared memory they need, once per device.
template <int BS, int MT> cudaError_t allow_smem(int dev) {
  static bool done[64] = {};
  if (dev < 64 && done[dev]) return cudaSuccess;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(stream_spectral_kernel<BS, MT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<BS>::SMEM)) !=
          cudaSuccess ||
      (e = cudaFuncSetAttribute(stream_synthesis_kernel<MT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, SYN_SMEM)) !=
          cudaSuccess)
    return e;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

// HW is the latent's pixels, HWp and K (even) the padded operators' sizes
struct Args {
  const bf16 *x, *A, *Ainv, *w1, *w2;
  const float *gscale, *gbias, *b1, *b2;
  float* stats;
  bf16 *o, *out;
  int B, HW, HWp, C, K, nb, groups, act;
};

// The three launches at block size BS and warp-tile height MT, on stream s;
// the spectral launch runs all ceil(K / MC) mode chunks but the last `drop`.
template <int BS, int MT> cudaError_t launch(int dev, const Args& a, int drop, cudaStream_t s) {
  constexpr int MC = 16 * MT, TP = 32 * MT;
  cudaError_t e;
  if ((e = allow_smem<BS, MT>(dev)) != cudaSuccess) return e;
  stream_stats_kernel<<<dim3(a.groups, a.B), STATS_NT, 0, s>>>(a.x, a.stats, a.HW, a.C,
                                                                a.groups);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  stream_spectral_kernel<BS, MT>
      <<<dim3((a.K + MC - 1) / MC - drop, a.nb, a.B), Geo<BS>::NT, Geo<BS>::SMEM, s>>>(
          a.x, a.gscale, a.gbias, a.A, a.w1, a.b1, a.w2, a.b2, a.stats, a.o, a.HW, a.HWp, a.C,
          a.K, a.nb, a.groups, a.act);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  stream_synthesis_kernel<MT><<<dim3(a.HWp / TP, a.C / TC, a.B), SYN_NT, SYN_SMEM, s>>>(
      a.Ainv, a.o, a.x, a.stats, a.gscale, a.gbias, a.out, a.HW, a.C, a.K, a.groups);
  return cudaGetLastError();
}

template <int BS> cudaError_t launch_bs(int dev, bool small, const Args& a, int drop,
                                        cudaStream_t s) {
  return small ? launch<BS, 1>(dev, a, drop, s) : launch<BS, 2>(dev, a, drop, s);
}

}  // namespace

// The shapes this kernel takes, as `hopper_stream_supported` in
// dpot_tpu_torch/ops/cuda/afno_fused.py states them (the dtype is bf16):
// a latent up to 4096 px with any K, but not one the other bf16 Hopper
// kernels take (128 or 256 px, K a multiple of 4, 2K <= 320); AFNO blocks
// of 64, 128 or 256 channels with groups of a power of two channels from 8
// to the block, or of 96 channels with groups of one block or a block pair;
// C a multiple of the synthesis tile (64).
extern "C" int dpot_afno_hopper_stream_supported(int B, int HW, int C, int K, int nb,
                                                 int groups) {
  if (B < 1 || B > 65535 || nb < 1 || C % nb || C % TC || groups < 1 || C % groups) return 0;
  if (HW < 1 || HW > MAX_HW || K < 1) return 0;
  if ((HW == 128 || HW == 256) && K % 4 == 0 && (2 * K + 63) / 64 <= 5) return 0;
  const int bs = C / nb, cpg = C / groups;
  if (bs == 96) return cpg == 96 || cpg == 192;
  if (bs != 64 && bs != 128 && bs != 256) return 0;
  return cpg >= 8 && cpg <= bs && (cpg & (cpg - 1)) == 0;
}

namespace {

int run(int act, const void* x, const float* gscale, const float* gbias, const void* A,
        const void* Ainv, const void* w1t, const float* b1, const void* w2t, const float* b2,
        float* stats, void* o, void* out, int B, int HW, int C, int K, int nb, int groups,
        int drop, void* stream) {
  if (!dpot_afno_hopper_stream_supported(B, HW, C, K, nb, groups) || act < 0 ||
      act >= ACT_COUNT)
    return cudaErrorInvalidValue;
  const void* ptrs[] = {x, A, Ainv, w1t, w2t, o, out};
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
  const int HWp = (HW + KC - 1) / KC * KC, Kp = K + K % 2;  // the padded operators'
  const bool small = static_cast<long long>((Kp + 15) / 16) * nb * B <= sms;
  const int mc = small ? 16 : MAX_MC;
  if (drop < 0 || drop >= (Kp + mc - 1) / mc) return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(x),    static_cast<const bf16*>(A),
               static_cast<const bf16*>(Ainv), static_cast<const bf16*>(w1t),
               static_cast<const bf16*>(w2t),  gscale,
               gbias,                          b1,
               b2,                             stats,
               static_cast<bf16*>(o),          static_cast<bf16*>(out),
               B,                              HW,
               HWp,                            C,
               Kp,                             nb,
               groups,                         act};
  switch (C / nb) {
    case 64: return launch_bs<64>(dev, small, a, drop, s);
    case 96: return launch_bs<96>(dev, small, a, drop, s);
    case 128: return launch_bs<128>(dev, small, a, drop, s);
    default: return launch_bs<256>(dev, small, a, drop, s);
  }
}

}  // namespace

// x, out (B, HW, C), A (2Kp, HWp), Ainv (HWp, 2Kp), o scratch (B, 2Kp, C)
// are bf16, HWp = HW rounded up to 64 and Kp = K rounded up to even, the
// operators zero past HW and at mode K of an odd K (padded_ops in the
// wrapper); w1t/w2t are the bf16 block weights (2, nb, bs, bs), each block
// transposed to (out, in); gscale/gbias (C), b1/b2 (2, nb, bs) and the
// stats scratch (B * groups * 2) are f32. act is an ActId. Returns 0 or a
// CUDA error.
extern "C" int dpot_afno_hopper_stream(int act, const void* x, const float* gscale,
                                       const float* gbias, const void* A, const void* Ainv,
                                       const void* w1t, const float* b1, const void* w2t,
                                       const float* b2, float* stats, void* o, void* out, int B,
                                       int HW, int C, int K, int nb, int groups, void* stream) {
  return run(act, x, gscale, gbias, A, Ainv, w1t, b1, w2t, b2, stats, o, out, B, HW, C, K, nb,
             groups, 0, stream);
}

// A control for the checks that hold this kernel against its plain
// version, never called by the port: the same call with the spectral
// launch's last mode chunk (the ragged one where MC does not divide K) left
// out, its rows of o zero (o is cleared first), as a fault in the chunk
// arithmetic would leave them.
extern "C" int dpot_afno_hopper_stream_drop_last_chunk(
    int act, const void* x, const float* gscale, const float* gbias, const void* A,
    const void* Ainv, const void* w1t, const float* b1, const void* w2t, const float* b2,
    float* stats, void* o, void* out, int B, int HW, int C, int K, int nb, int groups,
    void* stream) {
  const size_t Kp = K + K % 2;
  const cudaError_t e = cudaMemsetAsync(o, 0, static_cast<size_t>(B) * 2 * Kp * C * sizeof(bf16),
                                        static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return run(act, x, gscale, gbias, A, Ainv, w1t, b1, w2t, b2, stats, o, out, B, HW, C, K, nb,
             groups, 1, stream);
}
