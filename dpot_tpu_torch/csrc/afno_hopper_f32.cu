// Fused GroupNorm + AFNO spectral mixer in f32, designed for Hopper
// (sm_90a): every product as 3xTF32 on the tensor cores, two launches, z and
// h kept on chip.
//
// Replaces, for f32 operands at the shapes that `hopper_f32_supported`
// (dpot_tpu_torch/ops/cuda/afno_fused.py) admits, the TPU kernel
// `fused_gn_afno` of dpot_tpu/ops/pallas/afno_fused.py (`_kernel`, launched
// by `_fused_fwd`, line 114). It computes what afno_fused.cu computes in
// f32: GroupNorm in f32 (eps 1e-5), z = A . xn, per AFNO block j
// h = act([z_re | z_im] . W1_j + B1_j), o = h . W2_j + B2_j, out = Ainv . o
// + xn.
//
// Precision. The f32 path is held to 5e-5 absolute against its plain
// version, and single-pass TF32 (10 mantissa bits) misses that by more than
// an order of magnitude. So every operand v is split in registers as it is
// loaded into a fragment, hi = tf32(v) and lo = tf32(v - hi), and
// each product is lo.hi' + hi.lo' + hi.hi' with f32 accumulation (3xTF32,
// the split that `tf32_split` in the wrapper states in torch), as close to
// an f32 product as f32 is to f64. The f32 running sums are kept outside
// the tensor cores (see mma_k8).
//
// What bounds it. At DPOT-Ti (HW 256, C 512, K 144, nb 4, bs 128) a sample
// is 302 MFLOP, 906 MFLOP of TF32 work once split, against 1.4 MB of f32
// operands, so from B ~ 2 up it is bound by tensor-core operations; at B = 1
// by latency. The five-launch kernel of afno_fused.cu ran f32 products on
// the FMA pipes (a 4 x 4 micro-tile per thread, bound by shared-memory
// loads) and sent z, h and o through device memory. Here:
//
//   1. spectral_f32_kernel, one CTA of 8 warps per (chunk of MC modes,
//      AFNO block j, sample b): a first pass over the x slab
//      x[b, :, j bs : (j+1) bs] (from L2) gives the f32 GroupNorm
//      statistics of the block's groups (each thread's mean and squared
//      deviations, combined pairwise); then z = A . xn streams 32-pixel
//      chunks of x and of the chunk's A rows through a two-stage cp.async
//      ring, normalising x as its fragments load; z (MC modes x [re | im])
//      stays in shared memory; both MLP layers stream the block's weights in
//      32-row chunks through the same ring, with h written over z; o leaves
//      for device memory (B, 2K, C), the only trip an intermediate makes.
//   2. synthesis_f32_kernel, one CTA of 4 warps per (TP pixels, 64
//      channels, sample b): out = Ainv . o through a three-stage cp.async
//      ring, with an epilogue that adds the f32 xn recomputed from x and the
//      statistics. (As a programmatic dependent launch, whose waiting CTAs
//      hold SMs while launch 1 runs, it was 0.013 ms slower at B = 8 and
//      no faster at B = 1 or 20 on the H100: a plain launch.)
//
// Ragged latents and any K, as in afno_hopper_stream.cu: the launches work
// on whole 64-pixel tiles and a count of modes that is a multiple of 4
// (HWp = HW rounded up to 64, Kp = K rounded up to a multiple of 4: any
// even Kp makes Ainv's f32 rows whole 16-byte units, and the streamed bf16
// kernel, whose padded operators these share, needs the 4), on A (2Kp,
// HWp) and Ainv (HWp, 2Kp) padded with zeros by the caller and o (B, 2Kp,
// C); x rows past HW load as zeros (cp.async with a
// source size of 0, never read), the statistics run over the HW real rows
// (each thread's count of them its weight in Chan's rule), and the
// synthesis stores rows below HW only. Exact: a padded pixel meets a zero
// column of A, a padded mode a zero column of Ainv. afno_hopper_f32_l.cu
// and afno_hopper_f32_wide.cu do the same.
//
// A warp computes a (16 MT) x 32 tile: MC = 16 MT modes per spectral CTA
// and TP = 32 MT pixels per synthesis CTA. MT = 2 when the batch fills the
// card; MT = 1 (twice the CTAs, each half the work) when the spectral grid
// at MC = 16 has no more CTAs than the card has SMs (DPOT-Ti at B <= 3),
// where the grid at MT = 2 would leave most SMs idle.
//
// The products are warp-level mma.sync m16n8k8 tf32, whose fragments are
// loaded by threads from shared memory in any layout: wgmma takes tf32
// operands only K-major, while xn and o (channels contiguous) are
// MN-major, and the register split needs the values in registers anyway.
// Shared-memory tiles are padded (row strides of 4 or 8 mod 32 floats) so
// that every fragment load is free of bank conflicts. The complex MLP uses
// the weights in their reference layout (2, nb, in, out) as they are:
// h_re = z_re.wr - z_im.wi and h_im = z_re.wi + z_im.wr, with the minus
// applied to the wi fragment (exact), so a CTA reads 2 x 64 KB of each
// layer's weights instead of the 256 KB of the real form.

#include <cuda_runtime.h>

#include <cstdint>

#include "activation.cuh"

namespace {

constexpr int BS = 128;        // AFNO block size, the only one admitted
constexpr int NT = 256;        // threads per spectral CTA: 8 warps
constexpr int NT_SYN = 128;    // threads per synthesis CTA: 4 warps
constexpr int MAX_MC = 32;     // modes per spectral CTA at MT = 2
constexpr int KC = 32;         // depth of one ring stage
constexpr int LDX = BS + 8;    // x and weight tiles [KC][LDX]
constexpr int LDA = KC + 4;    // A and Ainv tiles [rows][LDA]
constexpr int LDZ = 2 * BS + 4;  // z and h [MC][LDZ]
constexpr int MAX_TP = 64;     // pixels per synthesis CTA at MT = 2
constexpr int TC = 64;         // channels per synthesis CTA
constexpr int LDO = TC + 8;    // o tiles [KC][LDO]
constexpr int SYN_STAGES = 3;
constexpr float EPS = 1e-5f;   // torch.nn.GroupNorm default
constexpr int MAX_HW = 4096;   // the combined-operator DFT's limit

// the padded operators' sizes: the latent in whole synthesis tiles, the
// modes a multiple of 4 (`padded_dims` in the wrapper)
__host__ __device__ constexpr int padded_hw(int HW) {
  return (HW + MAX_TP - 1) / MAX_TP * MAX_TP;
}
__host__ __device__ constexpr int padded_k(int K) { return (K + 3) / 4 * 4; }

// spectral_f32_kernel's shared memory, in floats
constexpr int STAGE = 2 * KC * LDX;         // the larger of a W stage and an x + A stage
static_assert(KC * LDX + 2 * MAX_MC * LDA <= STAGE, "an x + A stage must fit a ring slot");
constexpr int F_Z = 2 * STAGE;              // z, then h
constexpr int F_COL = F_Z + MAX_MC * LDZ;   // per-channel mean, rstd * gscale, gbias
constexpr int F_RED = F_COL + 3 * BS;       // reduction scratch: 8 warps x 32
constexpr int F_GRP = F_RED + 8 * 32;       // group sums: 2 x 32
constexpr int SPECTRAL_SMEM = (F_GRP + 64) * 4;
// synthesis_f32_kernel's
constexpr int SYN_STAGE = MAX_TP * LDA + KC * LDO;
constexpr int SYN_SMEM = (SYN_STAGES * SYN_STAGE + 3 * TC) * 4;

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is then
// not read, but must be a mapped address).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo, both TF32, rounded to nearest with ties away from zero:
// cvt.rna.tf32.f32's rounding done by integer ops on the bits, which on
// the H100 made the whole kernel 9-10 % faster than cvt.rna itself
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The (16 MT) x 32 f32 accumulator of one warp: MT m16 tiles by four n8
// tiles. Element e of tile (mt, nt) of a thread sits at row 16 mt + lane /
// 4 + 8 (e / 2) and column 8 nt + 2 (lane % 4) + e % 2.
template <int MT> using WarpAcc = float[MT][4][4];

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

template <int MT> __device__ __forceinline__ void zero(WarpAcc<MT>& acc) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// acc += A . B over one depth-8 step, 3xTF32. The tensor cores sum the
// step's three products from zero and an f32 add (rounded to nearest) takes
// that into acc: their own accumulation truncates, and chained over the 96
// steps of a Ti block its bias came to 4e-5 of the output (measured on the
// H100), near the f32 path's 5e-5 limit. a(mt, h, q) is the f32 value
// at row 16 mt + lane / 4 + 8 h, depth lane % 4 + 4 q of the warp's
// (16 MT) x 8 slice of A; b(nt, q) the value at depth lane % 4 + 4 q,
// column 8 nt + lane / 4 of its 8 x 32 slice of B (fragment layouts of
// m16n8k8).
template <int MT, typename FA, typename FB>
__device__ __forceinline__ void mma_k8(WarpAcc<MT>& acc, FA a, FB b) {
  uint32_t ah[MT][4], al[MT][4], bh[4][2], bl[4][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    split(a(mt, 0, 0), ah[mt][0], al[mt][0]);
    split(a(mt, 1, 0), ah[mt][1], al[mt][1]);
    split(a(mt, 0, 1), ah[mt][2], al[mt][2]);
    split(a(mt, 1, 1), ah[mt][3], al[mt][3]);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    split(b(nt, 0), bh[nt][0], bl[nt][0]);
    split(b(nt, 1), bh[nt][1], bl[nt][1]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(d, al[mt], bh[nt]);
      mma_tf32(d, ah[mt], bl[nt]);
      mma_tf32(d, ah[mt], bh[nt]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[e];
    }
}

// Sum of v over the threads of each GroupNorm group of the slab into
// out[group]: thread t holds the 4-channel column t % 32, gsz neighbouring
// lanes form a group (a power of two up to 32), ng groups. red: 8 x 32.
__device__ void slab_group_sum(float v, int gsz, int ng, float* red, float* out) {
  for (int o = 1; o < gsz; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane % gsz == 0) red[warp * 32 + lane / gsz] = v;
  __syncthreads();
  if (threadIdx.x < ng) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += red[w * 32 + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// One complex MLP layer of block j for the CTA's 16 MT modes: acc = [a_re |
// a_im] . [[wr, wi], [-wi, wr]] for the warp's 32 output columns, with a in
// zb [16 MT][LDZ] and w the layer's weights (2, nb, bs, bs), streamed in
// 32-row chunks through ring slots 0 and 1. The first chunk must already be
// in flight (load_w_chunk(.., 0) into slot 0, committed).
__device__ __forceinline__ void load_w_chunk(float* slot, const float* w, int j, int nb, int ci) {
  // [part][32 rows][128] of wr and wi, rows 32 ci ..
  for (int q = threadIdx.x; q < 2 * KC * (BS / 4); q += NT) {
    const int p = q / (KC * BS / 4), r = (q / (BS / 4)) % KC, c4 = q % (BS / 4);
    cp16(slot + (p * KC + r) * LDX + 4 * c4,
         w + ((static_cast<size_t>(p) * nb + j) * BS + KC * ci + r) * BS + 4 * c4, true);
  }
}

template <int MT>
__device__ __forceinline__ void complex_layer(WarpAcc<MT>& acc, float* sm, const float* zb,
                                              const float* w, int j, int nb) {
  const int warp = threadIdx.x >> 5, po = warp >> 2, o0 = 32 * (warp & 3);
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

// x rows [KC][LDX] of chunk kc (rows past HW zero-filled), then A rows
// [2 MC][LDA] (rows 0 .. MC - 1 the chunk's real parts, then its imaginary
// parts; modes past K zero-filled) into ring slot xs, by the NTH threads:
// the z phase's stage of the spectral kernels at block size BSZ (x's stride
// C, xb its block's first channel of sample b, A's stride HWp)
template <int BSZ, int LDXZ, int NTH, int MC>
__device__ __forceinline__ void load_z_chunk(float* xs, const float* xb, const float* A, int kc,
                                             int m0, int HW, int HWp, int C, int K) {
  float* as = xs + KC * LDXZ;
  const int p0 = kc * KC;
  for (int q = threadIdx.x; q < KC * (BSZ / 4); q += NTH) {
    const int r = q / (BSZ / 4), c4 = q % (BSZ / 4), p = p0 + r;
    cp16(xs + r * LDXZ + 4 * c4, xb + static_cast<size_t>(p < HW ? p : 0) * C + 4 * c4, p < HW);
  }
  for (int q = threadIdx.x; q < 2 * MC * (KC / 4); q += NTH) {
    const int r = q / (KC / 4), c4 = q % (KC / 4), m = m0 + (r % MC);
    const bool valid = m < K;
    const int row = (r < MC ? 0 : K) + (valid ? m : 0);
    cp16(as + r * LDA + 4 * c4, A + static_cast<size_t>(row) * HWp + p0 + 4 * c4, valid);
  }
}

// One thread's part of a GroupNorm statistics pass: the 4-channel column
// col (x's stride C, from its first row) over rows r0, r0 + step, ... below
// HW. cnt: the values it read; m: their mean; q: their sum of squared
// deviations (shifted by its first value); all 0 where it read none.
__device__ __forceinline__ void column_stats(const float* col, int C, int r0, int step, int HW,
                                             float& cnt, float& m, float& q) {
  cnt = m = q = 0.f;
  if (r0 >= HW) return;
  const float shift = __ldg(col + static_cast<size_t>(r0) * C);
  float p1[4] = {}, p2[4] = {};
#pragma unroll 4
  for (int p = r0; p < HW; p += step) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(col + static_cast<size_t>(p) * C));
    const float d[4] = {v.x - shift, v.y - shift, v.z - shift, v.w - shift};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p1[e] += d[e];
      p2[e] += d[e] * d[e];
    }
  }
  cnt = 4.f * ((HW - r0 + step - 1) / step);
  const float s1 = (p1[0] + p1[1]) + (p1[2] + p1[3]);
  m = shift + s1 / cnt;
  q = ((p2[0] + p2[1]) + (p2[2] + p2[3])) - s1 * s1 / cnt;
}

// grid (ceil(K / MC), nb, B), MC = 16 MT: modes chunk * MC .. + MC - 1 of
// AFNO block j of sample b, from x (B, HW, C) and A (2K, HWp) to o (B, 2K,
// C); K even (the padded Kp). stats (B, groups, 2) gets the GroupNorm mean
// and 1/std of the block's groups from the chunk-0 CTA. ACT is the mode
// MLP's activation (an ActId).
template <int ACT, int MT>
__global__ void __launch_bounds__(NT, 2)
spectral_f32_kernel(const float* __restrict__ x, const float* __restrict__ gscale,
                    const float* __restrict__ gbias, const float* __restrict__ A,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ stats, float* __restrict__ o, int HW, int HWp, int C,
                    int K, int nb, int groups) {
  constexpr int MC = 16 * MT;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int chunk = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int m0 = chunk * MC;
  const int g = lane_g(), t = lane_t();
  const float* xb = x + static_cast<size_t>(b) * HW * C + j * BS;

  // ring slot s of the z phase: load_z_chunk
  auto load_z_stage = [&](int s, int kc) {
    load_z_chunk<BS, LDX, NT, MC>(sm + s * STAGE, xb, A, kc, m0, HW, HWp, C, K);
  };
  load_z_stage(0, 0);
  cp_commit();

  // GroupNorm statistics of the slab's groups, one pass from L2: thread tid
  // owns channels 4 (tid % 32) .. + 3 of rows tid / 32, tid / 32 + 8, ...
  // below HW; its mean m and sum q of squared deviations (shifted by its
  // first value) combine into each group's mean and variance (Chan's
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
  column_stats(xb + 4 * (tid & 31), C, tid >> 5, 8, HW, cnt, m, q);
  slab_group_sum(m * cnt, gsz, ng, red, s_sum);
  const int grp = (tid & 31) / gsz;
  const float mean = s_sum[grp] / n;
  slab_group_sum(q + cnt * (m - mean) * (m - mean), gsz, ng, red, s_dev);
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

  // z = A . xn: warp w computes rows MC (w / 4) .. of [re; im] (the real or
  // imaginary parts of the MC modes) by channels 32 (w % 4) ..
  const int rb = MC * (warp >> 2), cb = 32 * (warp & 3);
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

  // h = act([z_re | z_im] . W1 + B1), over z. Warp w: output half w / 4
  // (re, im), columns 32 (w % 4) .. of it.
  const int po = warp >> 2, o0 = 32 * (warp & 3);
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

// grid (HWp / TP, C / 64, B), TP = 32 MT: out[b] = Ainv . o[b] + xn[b] for
// TP pixels and 64 channels, xn recomputed in f32 from x and the
// statistics; Ainv (HWp, 2K), K even (the padded Kp); rows past HW
// (Ainv's padded zero rows) are computed and not stored. Warp w computes
// pixels 16 MT (w / 2) .. by channels 32 (w % 2) ...
template <int MT>
__global__ void __launch_bounds__(NT_SYN)
synthesis_f32_kernel(const float* __restrict__ Ainv, const float* __restrict__ o,
                     const float* __restrict__ x, const float* __restrict__ stats,
                     const float* __restrict__ gscale, const float* __restrict__ gbias,
                     float* __restrict__ out, int HW, int C, int K, int groups) {
  constexpr int TP = 32 * MT;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int p0 = blockIdx.x * TP, n0 = blockIdx.y * TC, b = blockIdx.z;
  const int K2 = 2 * K, nk = (K2 + KC - 1) / KC;
  const int g = lane_g(), t = lane_t();
  const float* ob = o + static_cast<size_t>(b) * K2 * C + n0;

  // ring slot s: Ainv [TP][LDA] (columns k0 ..), then o [KC][LDO] (rows k0 ..)
  auto load_ainv = [&](int s, int kb) {
    float* as = sm + s * SYN_STAGE;
    for (int q = tid; q < TP * (KC / 4); q += NT_SYN) {
      const int r = q / (KC / 4), c4 = q % (KC / 4), k = kb * KC + 4 * c4;
      cp16(as + r * LDA + 4 * c4, Ainv + static_cast<size_t>(p0 + r) * K2 + (k < K2 ? k : 0),
           k < K2);
    }
  };
  auto load_o = [&](int s, int kb) {
    float* os = sm + s * SYN_STAGE + MAX_TP * LDA;
    for (int q = tid; q < KC * (TC / 4); q += NT_SYN) {
      const int r = q / (TC / 4), c4 = q % (TC / 4), k = kb * KC + r;
      cp16(os + r * LDO + 4 * c4, ob + static_cast<size_t>(k < K2 ? k : 0) * C + 4 * c4, k < K2);
    }
  };
  for (int s = 0; s < SYN_STAGES - 1; ++s) {
    if (s < nk) {
      load_ainv(s, s);
      load_o(s, s);
    }
    cp_commit();
  }
  float* col_mean = sm + SYN_STAGES * SYN_STAGE;
  float* col_rs = col_mean + TC;
  float* col_bias = col_rs + TC;
  if (tid < TC) {
    const int c = n0 + tid, s = 2 * (b * groups + c / (C / groups));
    col_mean[tid] = stats[s];
    col_rs[tid] = stats[s + 1] * gscale[c];
    col_bias[tid] = gbias[c];
  }

  const int rb = 16 * MT * (warp >> 1), cb = 32 * (warp & 1);
  WarpAcc<MT> acc;
  zero<MT>(acc);
  for (int kb = 0; kb < nk; ++kb) {
    const int next = kb + SYN_STAGES - 1;
    if (next < nk) {
      load_ainv(next % SYN_STAGES, next);
      load_o(next % SYN_STAGES, next);
    }
    cp_commit();
    cp_wait<SYN_STAGES - 1>();
    __syncthreads();
    const float* as = sm + (kb % SYN_STAGES) * SYN_STAGE;
    const float* os = as + MAX_TP * LDA;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      mma_k8<MT>(
          acc,
          [&](int mt, int h, int q) { return as[(rb + 16 * mt + g + 8 * h) * LDA + 8 * kk + t + 4 * q]; },
          [&](int nt, int q) { return os[(8 * kk + t + 4 * q) * LDO + cb + 8 * nt + g]; });
    }
    __syncthreads();
  }

  // out = acc + xn, rows below HW
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
        const float2 xv = __ldg(reinterpret_cast<const float2*>(x + at));
        const float xn0 = (xv.x - col_mean[cl]) * col_rs[cl] + col_bias[cl];
        const float xn1 = (xv.y - col_mean[cl + 1]) * col_rs[cl + 1] + col_bias[cl + 1];
        *reinterpret_cast<float2*>(out + at) =
            make_float2(acc[mt][nt][2 * h] + xn0, acc[mt][nt][2 * h + 1] + xn1);
      }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Lets spectral_f32_kernel<ACT, MT> and synthesis_f32_kernel<MT> use the
// dynamic shared memory they need, once per device.
template <int ACT, int MT> cudaError_t allow_smem(int dev) {
  static bool done[64] = {};
  if (dev < 64 && done[dev]) return cudaSuccess;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(spectral_f32_kernel<ACT, MT>,
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
  spectral_f32_kernel<ACT, MT><<<dim3((K + MC - 1) / MC, nb, B), NT, SPECTRAL_SMEM, s>>>(
      x, gscale, gbias, A, w1, b1, w2, b2, stats, o, HW, HWp, C, K, nb, groups);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  synthesis_f32_kernel<MT><<<dim3(HWp / TP, C / TC, B), NT_SYN, SYN_SMEM, s>>>(
      Ainv, o, x, stats, gscale, gbias, out, HW, C, K, groups);
  return cudaGetLastError();
}

}  // namespace

// afno_hopper_f32_l.cu (AFNO blocks of 96 channels) includes this file for
// the parts above and defines AFNO_HOPPER_F32_PARTS, which leaves out the
// entry points below and so every instance of spectral_f32_kernel.
#ifndef AFNO_HOPPER_F32_PARTS

// The shapes this kernel takes, as `hopper_f32_supported` in
// dpot_tpu_torch/ops/cuda/afno_fused.py states them (the dtype is f32).
extern "C" int dpot_afno_hopper_f32_supported(int B, int HW, int C, int K, int nb, int groups) {
  if (B < 1 || B > 65535 || nb < 1 || C != nb * BS || groups < 1 || C % groups) return 0;
  if (HW < 1 || HW > MAX_HW || K < 1) return 0;
  const int cpg = C / groups;
  return cpg >= 8 && cpg <= BS && (cpg & (cpg - 1)) == 0;
}

// x, out (B, HW, C), A (2Kp, HWp), Ainv (HWp, 2Kp) (HWp = padded_hw(HW),
// Kp = padded_k(K), zero past HW and at the modes K .. Kp - 1: padded_ops in
// the wrapper), w1/w2 (2, nb, bs, bs) in the reference layout, gscale/gbias
// (C), b1/b2 (2, nb, bs), the stats scratch (B * groups * 2) and the o
// scratch (B, 2Kp, C), all f32. act is an ActId. Returns 0 or a CUDA error.
extern "C" int dpot_afno_hopper_f32(int act, const float* x, const float* gscale,
                                    const float* gbias, const float* A, const float* Ainv,
                                    const float* w1, const float* b1, const float* w2,
                                    const float* b2, float* stats, float* o, float* out, int B,
                                    int HW, int C, int K, int nb, int groups, void* stream) {
  if (!dpot_afno_hopper_f32_supported(B, HW, C, K, nb, groups) || act < 0 || act >= ACT_COUNT)
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
    return small ? launch<ACT, 1>(dev, x, gscale, gbias, A, Ainv, w1, b1, w2, b2, stats, o, out,
                                  B, HW, C, Kp, nb, groups, s)
                 : launch<ACT, 2>(dev, x, gscale, gbias, A, Ainv, w1, b1, w2, b2, stats, o, out,
                                  B, HW, C, Kp, nb, groups, s);
  });
}

#endif  // AFNO_HOPPER_F32_PARTS
