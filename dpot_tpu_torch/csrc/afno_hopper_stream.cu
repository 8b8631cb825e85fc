// Fused GroupNorm + AFNO spectral mixer in bf16 for every latent up to 4096
// pixels and every mode count, designed for Hopper (sm_90a): three launches,
// wgmma fed by TMA through rings of mbarrier-guarded stages, z and h kept on
// chip, so that neither the latent nor the kept modes (2K) are capped by
// what a CTA holds.
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
// afno_fused.cu.
//
// What bounds it. At DPOT-M's 32^2 latent (HW 1024, C 1024, K 544, nb 8,
// bs 128) a sample is 5.7 GFLOP against about 6.6 MB of operands, so from
// B = 1 up it is bound by tensor-core operations (0.0058 ms a sample at 989
// TFLOP/s); at the 8^2 latent (HW 64, K 40) a sample is 0.105 GFLOP, bound
// by bytes up to B ~ 8 and by latency at B = 1. What holds a streamed design
// back from that bound is the operands' trips through L2: a CTA reads its
// x tiles, A rows and weights (spectral) or Ainv rows and o (synthesis)
// from L2, so the FLOPs it does per byte it reads are set by its tile.
//
// The design before (measured on an NVIDIA H100 80GB HBM3, 700 W, by
// chip_smoke.py's kernel phase): warp-level m16n8k16 products fed by 8 x 8 matrix loads
// from shared memory, every operand through rings of 16-byte asynchronous
// copies, spectral CTAs of 16 or 32 modes, synthesis CTAs of 32 or 64 px x
// 64 channels (32 FLOP a byte from L2). M 32^2 0.0874 / 0.3840 /
// 0.8342 ms at B = 1 / 8 / 20 against a bound of 0.1154 at B = 20 (the
// synthesis 0.31 ms of it), M 8^2 0.0192 / 0.0279 / 0.0496, L 32^2 at B =
// 1 / 8 / 16 0.1213 / 0.5803 / 1.0567, M 12^2 0.0236 / 0.0404 / 0.0794, M
// 9^2 0.0208 / 0.0321 / 0.0565, M 20^2 0.0355 / 0.1176 / 0.2443, M 4^2
// 0.0177 / 0.0183 / 0.0287 (device time).
//
// This design: every product is a warpgroup wgmma (m64nNk16, N the tile's
// width: 64, 96, 128 or 256), every operand tile a TMA load into a ring of
// stages, each with a "full" mbarrier (the TMA bytes) and an "empty" one
// (one thread of each consumer warpgroup arrives once the products that
// read the stage have completed); one producer warp issues the loads, two
// consumer warpgroups compute, one wgmma group kept in flight.
//
//   1. stream_stats_kernel, one CTA per (GroupNorm group, sample): the f32
//      statistics in one pass over the group's columns of x, each thread's
//      shifted sums over an 8-channel column combined by Chan's pairwise
//      rule. (In the spectral launch every mode chunk's CTA would read its
//      group again.) It lets the spectral launch start early
//      (programmatic dependent launch).
//   2. stream_spectral_kernel<BS>, one CTA per (chunk of 64 modes, AFNO
//      block j, sample b). The producer streams 64-pixel stages: the x tile
//      (64 px x the block's channels, rounded up to 64-channel boxes; TMA's
//      out-of-bounds fill gives the zeros past HW and past C) and the
//      chunk's A rows (re and im; zeros past Kp). The consumers rewrite
//      each x tile in place as round(xn) from the statistics, fence the
//      generic proxy, and run z = A . xn by wgmma with the x tile read
//      MN-major (the transpose flag), warpgroup w part w (re, im) of the 64
//      modes over all channels. z goes to shared memory rounded, in the
//      128-byte-swizzled K-major layout the MLP's A operand needs. Then the
//      producer streams W1 and W2 (the cached bf16 copies, each block
//      transposed to (out, in)) in 64-input chunks of one part (wr or wi)
//      through the same ring; warpgroup 0 computes h_re = z_re . wr - z_im
//      . wi (the minus through imm-scale-b = -1), warpgroup 1 h_im = z_re .
//      wi + z_im . wr; h overwrites z, and o overwrites h, from where each
//      warpgroup stores its part's rows below Kp to o (B, 2Kp, C) in
//      16-byte units, the only intermediate that goes to device memory.
//      (32-mode chunks where the grid at 64 would leave SMs idle, as the
//      design before had, were slower at every such shape measured: each
//      CTA streams the same stages for half the products, PERF.md.)
//   3. stream_synthesis_kernel<TN>, one CTA per (128 px, TN channels,
//      sample), TN 256, 128 or 64 (the widest that divides C and still
//      fills the card): out = Ainv . o streaming 64-mode k-blocks of
//      Ainv's rows (K-major) and o's rows (MN-major, the transpose flag)
//      through a ring (zeros past 2Kp from TMA, so no cap on 2K), an
//      epilogue that adds the f32 xn recomputed from the x tile (loaded
//      with the first stages) and the statistics, written over the x tile
//      and stored by TMA, which drops the rows past HW. A programmatic
//      dependent of the spectral launch: its x tile and first Ainv rows
//      load while that grid finishes, o only after it has.
//
// Ragged latents and odd K. The launches work on whole 64-pixel stages and
// a mode count that is a multiple of 4: HWp = HW rounded up to 64, Kp = K
// rounded up to a multiple of 4, so that Ainv's rows (4 Kp bytes) are
// whole 16-byte units, which a tensor map's strides must be. The caller
// passes A (2Kp, HWp) and Ainv (HWp, 2Kp) padded with zeros (`padded_ops`
// in the wrapper) and o (B, 2Kp, C); x and out keep their HW rows. A padded
// pixel meets a zero column of A and a padded mode a zero column of Ainv,
// so the result is the unpadded one exactly. The statistics run over the
// HW real rows.
//
// The activation is a runtime argument (it runs once an element of h), so
// the library holds one spectral instance per block size, and
// one synthesis instance per tile width.

#include "activation.cuh"
#include "hopper_tma.cuh"

namespace {

constexpr int NC = 256;         // consumer threads of a CTA: two warpgroups
constexpr int NT = NC + 32;     // and one producer warp
constexpr int PX = 64;          // pixels per analysis stage, HWp's unit
constexpr int MC = 64;          // modes per spectral CTA
constexpr int DROP_UNIT = 32;   // the control leaves out the last DROP_UNIT-mode chunk
constexpr int KP_UNIT = 4;      // Kp's unit: Ainv's rows whole 16-byte units
constexpr int SYN_P = 128;      // pixels per synthesis CTA
constexpr int SYN_K = 64;       // modes (rows of o) per synthesis stage
constexpr int C_UNIT = 64;      // the narrowest synthesis tile; C is a multiple
constexpr int STATS_NT = 512;   // threads per statistics CTA
constexpr int EMPTY_ARRIVALS = 2;  // arrivals that hand a stage back: one a consumer warpgroup
constexpr int BOX = 8192;       // one 64 x 64 bf16 box, 128-byte rows
constexpr int SMEM_MAX = 232448;  // what a CTA may use on the H100
constexpr int MAX_HW = 4096;    // the combined-operator DFT's limit
constexpr float EPS = 1e-5f;    // torch.nn.GroupNorm default

// stream_spectral_kernel's layout at AFNO block size BS; byte offsets from
// a 1024-aligned base. A ring slot holds one analysis stage (the x tile
// [XCH / 64][64 px][64], then the A rows [2 parts][MC][64 px]) or one
// weight stage ([BS out][64 in] of one part and k-chunk).
template <int BS> struct Spec {
  static constexpr int NKB = (BS + 63) / 64;  // 64-wide k-blocks of each part of z, h, o
  static constexpr int XCH = 64 * NKB;  // the x tile's channels, z's width: 64, 128, 128, 256
  static constexpr int X_BYTES = XCH * 128;
  static constexpr int A_BYTES = 2 * MC * 128;
  static constexpr int W_BYTES = BS * 128;
  static constexpr int SLOT = X_BYTES + A_BYTES > W_BYTES ? X_BYTES + A_BYTES : W_BYTES;
  static constexpr int NS = BS == 96 || BS == 128 ? 4 : 3;  // ring stages
  static constexpr int Z_OFF = NS * SLOT;  // z, then h, then o: [2 parts][NKB][64 modes][64]
  static constexpr int MISC = Z_OFF + 2 * NKB * BOX;  // 2 NS mbarriers, then 3 XCH floats
  static constexpr int SMEM = MISC + 128 + 12 * XCH + 1024;  // + alignment slack
  static constexpr int MIN_CTAS = BS == 64 ? 2 : 1;
  static_assert(SMEM <= SMEM_MAX, "a CTA may use 227 KB of shared memory");
  static_assert(MIN_CTAS == 1 || 2 * (SMEM + 1024) <= 233472, "two CTAs an SM");
  static_assert(SLOT % 1024 == 0 && X_BYTES % 1024 == 0, "swizzled tiles 1024-aligned");
};

// stream_synthesis_kernel's layout at tile width TN: a ring slot holds the
// Ainv rows [128 px][64 modes] and o [TN / 64][64 modes][64]; the x tile,
// then out, [TN / 64][128 px][64].
template <int TN> struct Syn {
  static constexpr int NS = TN == 256 ? 3 : 4;
  static constexpr int AINV_BYTES = SYN_P * 128;
  static constexpr int SLOT = AINV_BYTES + TN * 128;
  static constexpr int X_OFF = NS * SLOT;
  static constexpr int MISC = X_OFF + TN * 256;  // 2 NS + 1 mbarriers, then 4 TN floats
  static constexpr int SMEM = MISC + 128 + 16 * TN + 1024;
  static_assert(SMEM <= SMEM_MAX, "a CTA may use 227 KB of shared memory");
};

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Hands a ring stage back to the producer once this warpgroup's products
// that read it have completed (a wgmma group completes for the whole
// warpgroup, and the generic writes to the stage came before the barrier
// that preceded them): one thread a warpgroup arrives. (Every consumer
// thread arriving timed the same on the H100:
// tools/afno_stream_variants.py arrive_every_thread.)
__device__ __forceinline__ void release(uint32_t bar) {
  if ((threadIdx.x & 127) == 0) mbar_arrive(bar);
}

// Wait until at most N of this warp's wgmma groups are in flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Barrier of the NC consumer threads (1 and 2 are the warpgroups').
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// The m64 x nN f32 accumulator of one warpgroup, N / 2 registers a thread
// (element 4 i + 2 h + e at acc_row(h), acc_col(i) + e); mma<SB, TB>: d +=
// A . (SB * B), bf16 operands from shared-memory descriptors, TB: B is
// MN-major.
template <int N> struct Frag;

template <> struct Frag<64> {
  float d[32];
  template <int SB, int TB> __device__ __forceinline__ void mma(uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, %35, 0, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(SB), "n"(TB));
  }
};

template <> struct Frag<96> {
  float d[48];
  template <int SB, int TB> __device__ __forceinline__ void mma(uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, %51, 0, %52;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1), "n"(SB), "n"(TB));
  }
};

template <> struct Frag<128> {
  float d[64];
  template <int SB, int TB> __device__ __forceinline__ void mma(uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, %67, 0, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(SB), "n"(TB));
  }
};

template <> struct Frag<256> {
  float d[128];
  template <int SB, int TB> __device__ __forceinline__ void mma(uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
        "%125, %126, %127}, "
        "%128, %129, p, 1, %131, 0, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
          "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
          "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
          "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
          "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "l"(a), "l"(b), "r"(1), "n"(SB), "n"(TB));
  }
};

template <int N> __device__ __forceinline__ void zero(Frag<N>& f) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) f.d[i] = 0.f;
}
// keep the compiler from moving the registers across wgmma's async use
template <int N> __device__ __forceinline__ void pin(Frag<N>& f) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(f.d[i])::"memory");
}

// bf16 pair (v0, v1) at row r, column c of a 128-byte-swizzled tile of
// 64-column boxes `box` bytes apart, rows of 128 bytes.
__device__ __forceinline__ __nv_bfloat162* swizzled(uint8_t* tile, int box, int r, int c) {
  const int cc = c & 63;
  return reinterpret_cast<__nv_bfloat162*>(tile + (c >> 6) * box + r * 128 +
                                           (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2);
}

// h = act(acc + bias), rounded, into the K-major tile [NKB][64][64] at zh
// (a warpgroup's part of h), ACT the activation's id.
template <int ACT, int N>
__device__ __forceinline__ void store_h_act(uint8_t* zh, const Frag<N>& acc, const float* bias) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int c = acc_col(i);
    const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *swizzled(zh, BOX, acc_row(h), c) =
          __floats2bfloat162_rn(activate<ACT>(acc.d[4 * i + 2 * h] + bv.x),
                                activate<ACT>(acc.d[4 * i + 2 * h + 1] + bv.y));
  }
}

// The same for the runtime id act (< ACT_COUNT), chosen once: a switch on
// act at every element of the unrolled epilogue made the call 1.6-1.7
// times as slow at DPOT-M's and DPOT-L's 32^2 latents (B = 20, 16) on the
// H100 (tools/afno_stream_variants.py act_per_element).
template <int N>
__device__ __forceinline__ void store_h(int act, uint8_t* zh, const Frag<N>& acc,
                                        const float* bias) {
  switch (act) {
    case ACT_GELU_TANH: return store_h_act<ACT_GELU_TANH>(zh, acc, bias);
    case ACT_GELU_ERF: return store_h_act<ACT_GELU_ERF>(zh, acc, bias);
    case ACT_TANH: return store_h_act<ACT_TANH>(zh, acc, bias);
    case ACT_SIGMOID: return store_h_act<ACT_SIGMOID>(zh, acc, bias);
    case ACT_RELU: return store_h_act<ACT_RELU>(zh, acc, bias);
    case ACT_LEAKY_RELU: return store_h_act<ACT_LEAKY_RELU>(zh, acc, bias);
    case ACT_SOFTPLUS: return store_h_act<ACT_SOFTPLUS>(zh, acc, bias);
    case ACT_ELU: return store_h_act<ACT_ELU>(zh, acc, bias);
    default: return store_h_act<ACT_SILU>(zh, acc, bias);
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
  // the spectral launch may take the SMs this grid leaves free; it waits
  // for the statistics before it reads them
  launch_dependents();
  const int tid = threadIdx.x, g = blockIdx.x, b = blockIdx.y;
  const int cpg = C / groups, cols = cpg / 8, rstep = STATS_NT / cols, row0 = tid / cols;
  float cnt = 0.f, m = 0.f, q = 0.f;
  if (row0 < rstep && row0 < HW) {
    const bf16* xc = x + static_cast<size_t>(b) * HW * C + g * cpg + 8 * (tid % cols);
    const float shift = __bfloat162float(xc[static_cast<size_t>(row0) * C]);
    float p1[8] = {}, p2[8] = {};
    int rows = 0;
#pragma unroll 8
    for (int p = row0; p < HW; p += rstep, ++rows) {
      float f[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(xc + static_cast<size_t>(p) * C)), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = f[e] - shift;
        p1[e] += d;
        p2[e] += d * d;
      }
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

// One complex MLP layer of block j for the CTA's 64 mode rows, computed by
// warpgroup WG from z (or h) in the K-major tile [2 parts][NKB][64][64] at
// z: the layer's 2 NKB weight stages (part p = t / NKB, 64-input k-chunk t
// % NKB) arrive in the ring in order, from stage `it` on. Real half (WG 0):
// a_re . wr - a_im . wi; imaginary (WG 1): a_re . wi + a_im . wr. One
// wgmma group a stage, one kept in flight; a stage goes back to the
// producer (`release`) once its group has completed. WG is a template
// argument so that the sign of each product is an immediate and no wgmma
// sits on a path that depends on the thread.
template <int BS, int WG>
__device__ __forceinline__ void mlp_layer(Frag<BS>& acc, uint32_t base, uint32_t z, int& it) {
  using G = Spec<BS>;
  zero(acc);
#pragma unroll
  for (int t = 0; t < 2 * G::NKB; ++t) {
    const int part = t / G::NKB, kb = t % G::NKB, s = it % G::NS;
    mbar_wait(base + G::MISC + 8 * s, (it / G::NS) & 1);
    pin(acc);
    wgmma_fence();
    const uint32_t za = z + ((part ^ WG) * G::NKB + kb) * BOX;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (64 * kb + 16 * kk < BS) {  // BS 96: the second k-chunk is 32 inputs
        const uint64_t a = desc_k(za + kk * 32), w = desc_k(base + s * G::SLOT + kk * 32);
        if (WG == 0 && part == 1) acc.template mma<-1, 0>(a, w);
        else acc.template mma<1, 0>(a, w);
      }
    }
    wgmma_commit();
    if (t > 0) {
      wgmma_wait<1>();
      pin(acc);
      release(base + G::MISC + 8 * (G::NS + (it - 1) % G::NS));
    }
    ++it;
  }
  wgmma_wait<0>();
  pin(acc);
  release(base + G::MISC + 8 * (G::NS + (it - 1) % G::NS));
}

// grid (ceil(Kp / MC), nb, B), NT threads: modes chunk * MC .. + MC - 1 of
// AFNO block j of sample b, from x (map_x: (B, HW, C), 64 x 64 boxes) and
// A (map_a: (2, Kp, HWp), boxes of 64 px x MC modes) to o (B, 2Kp, C), the
// modes below kstore stored (Kp; less in the control), with the GroupNorm
// statistics (B, groups, 2) of stream_stats_kernel and the bf16 block
// weights (map_w1, map_w2: (2, nb, BS out, BS in), boxes of 64 inputs of
// all BS outputs).
template <int BS>
__global__ void __launch_bounds__(NT, Spec<BS>::MIN_CTAS)
stream_spectral_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_w1,
                       const __grid_constant__ CUtensorMap map_w2,
                       const float* __restrict__ gscale, const float* __restrict__ gbias,
                       const float* __restrict__ b1, const float* __restrict__ b2,
                       const float* stats, bf16* __restrict__ o, int HWp, int C, int Kp,
                       int kstore, int nb, int groups, int act) {
  using G = Spec<BS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int j = blockIdx.y, b = blockIdx.z, m0 = blockIdx.x * MC, nkc = HWp / PX;
  auto full = [&](int s) { return base + G::MISC + 8 * s; };
  auto empty = [&](int s) { return base + G::MISC + 8 * (G::NS + s); };

  // the synthesis may take SMs that this grid leaves free; it waits for
  // this grid's o before it reads it
  launch_dependents();
  if (tid == 0) {
    for (int s = 0; s < G::NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), EMPTY_ARRIVALS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NC) {  // the producer warp: one thread issues every load
    if (tid == NC) {
      int it = 0;
      // the next stage's slot, once its earlier tenant has been handed back
      auto acquire = [&](uint32_t bytes) {
        const int s = it % G::NS, use = it / G::NS;
        if (use) mbar_wait(empty(s), (use - 1) & 1);
        mbar_expect_tx(full(s), bytes);
        ++it;
        return s;
      };
      for (int kc = 0; kc < nkc; ++kc) {
        const int s = acquire(G::X_BYTES + G::A_BYTES);
        const uint32_t slot = base + s * G::SLOT;
        for (int h = 0; h < G::XCH / 64; ++h)
          tma_load_3d(slot + h * BOX, &map_x, full(s), j * BS + h * 64, kc * PX, b);
        for (int p = 0; p < 2; ++p)
          tma_load_3d(slot + G::X_BYTES + p * BOX, &map_a, full(s), kc * PX, m0, p);
      }
      for (int layer = 0; layer < 2; ++layer)
        for (int t = 0; t < 2 * G::NKB; ++t) {
          const int s = acquire(G::W_BYTES);
          tma_load_4d(base + s * G::SLOT, layer ? &map_w2 : &map_w1, full(s),
                      (t % G::NKB) * 64, 0, j, t / G::NKB);
        }
    }
    return;
  }

  // the GroupNorm constants of the x tile's channels (zero past the block)
  float* s_mean = reinterpret_cast<float*>(sm + G::MISC + 128);
  float* s_rs = s_mean + G::XCH;
  float* s_bi = s_rs + G::XCH;
  wait_primary();
  for (int t = tid; t < G::XCH; t += NC) {
    float mean = 0.f, rs = 0.f, bias = 0.f;
    if (t < BS) {
      const int c = j * BS + t;
      const float* st = stats + 2 * (static_cast<size_t>(b) * groups + c / (C / groups));
      mean = st[0];
      rs = st[1] * __ldg(gscale + c);
      bias = __ldg(gbias + c);
    }
    s_mean[t] = mean;
    s_rs[t] = rs;
    s_bi[t] = bias;
  }
  consumer_sync();

  // z = A . xn, warpgroup wg part wg of the modes. Thread tid normalises the
  // 8-channel column lc of rows r0, r0 + RSTEP, ... of each x tile in place
  // (all its cells loaded, then all stored); chunk (p, lc) sits at 16-byte
  // position (lc % 8) ^ (p % 8) of row p of box lc / 8 (the swizzle). With
  // four ring stages or more, stage kc + 1 is normalised while the products
  // of stage kc (and kc - 1) run; with three, that left the producer one
  // stage of lead and was slower (tools/afno_stream_variants.py
  // spectral_ring3), so stage kc is normalised just before its products.
  constexpr int CPR = G::XCH / 8, RSTEP = NC / CPR, ROWS = PX / RSTEP;
  constexpr bool AHEAD = G::NS >= 4;
  const int lc = tid % CPR, r0 = tid / CPR;
  float nm[8], nr[8], nbi[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    nm[e] = s_mean[8 * lc + e];
    nr[e] = s_rs[8 * lc + e];
    nbi[e] = s_bi[8 * lc + e];
  }
  auto normalise = [&](int kc) {
    mbar_wait(full(kc % G::NS), (kc / G::NS) & 1);
    uint8_t* xt = sm + kc % G::NS * G::SLOT;
    uint4 cells[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int p = r0 + q * RSTEP;
      cells[q] = *reinterpret_cast<const uint4*>(xt + (lc >> 3) * BOX + p * 128 +
                                                 (((lc & 7) ^ (p & 7)) << 4));
    }
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int p = r0 + q * RSTEP;
      float f[8];
      unpack8(cells[q], f);
      uint4 u;
      __nv_bfloat162* hq = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hq[e] = __floats2bfloat162_rn((f[2 * e] - nm[2 * e]) * nr[2 * e] + nbi[2 * e],
                                      (f[2 * e + 1] - nm[2 * e + 1]) * nr[2 * e + 1] +
                                          nbi[2 * e + 1]);
      *reinterpret_cast<uint4*>(xt + (lc >> 3) * BOX + p * 128 + (((lc & 7) ^ (p & 7)) << 4)) = u;
    }
    fence_proxy_async();
  };
  Frag<G::XCH> za;
  zero(za);
  if (AHEAD) normalise(0);
  int it = 0;
  for (int kc = 0; kc < nkc; ++kc, ++it) {
    if (!AHEAD) normalise(kc);
    consumer_sync();  // the whole tile is xn before either warpgroup reads it
    pin(za);
    wgmma_fence();
    const uint32_t slot = base + it % G::NS * G::SLOT;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      za.template mma<1, 1>(desc_k(slot + G::X_BYTES + wg * BOX + kk * 32),
                            desc_mn(slot + kk * 16 * 128, BOX));
    wgmma_commit();
    if (AHEAD && kc + 1 < nkc) normalise(kc + 1);
    if (kc > 0) {
      wgmma_wait<1>();
      pin(za);
      release(empty((it - 1) % G::NS));
    }
  }
  wgmma_wait<0>();
  pin(za);
  release(empty((it - 1) % G::NS));

  // z rounded into [2 parts][NKB][64 modes][64], the block's channels only
  uint8_t* zb = sm + G::Z_OFF;
#pragma unroll
  for (int i = 0; i < G::XCH / 8; ++i) {
    const int c = acc_col(i);
    if (c >= BS) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *swizzled(zb + wg * G::NKB * BOX, BOX, acc_row(h), c) =
          __floats2bfloat162_rn(za.d[4 * i + 2 * h], za.d[4 * i + 2 * h + 1]);
  }
  fence_proxy_async();
  consumer_sync();

  // h = act([z_re | z_im] . W1 + B1), rounded, over z: warpgroup wg writes
  // part wg once both are done reading z
  const uint32_t z = base + G::Z_OFF;
  Frag<BS> acc;
  if (wg == 0) mlp_layer<BS, 0>(acc, base, z, it);
  else mlp_layer<BS, 1>(acc, base, z, it);
  consumer_sync();
  store_h<BS>(act, zb + wg * G::NKB * BOX, acc, b1 + (static_cast<size_t>(wg) * nb + j) * BS);
  fence_proxy_async();
  consumer_sync();

  // o = [h_re | h_im] . W2 + B2, rounded, over h once both warpgroups are
  // done reading it; then warpgroup wg stores part wg's rows below kstore
  // to device memory, 16 bytes a thread, the rows' chunks contiguous
  if (wg == 0) mlp_layer<BS, 0>(acc, base, z, it);
  else mlp_layer<BS, 1>(acc, base, z, it);
  consumer_sync();
  uint8_t* ot = zb + wg * G::NKB * BOX;
  const float* bias2 = b2 + (static_cast<size_t>(wg) * nb + j) * BS;
#pragma unroll
  for (int i = 0; i < BS / 8; ++i) {
    const int c = acc_col(i);
    const float2 bv = __ldg(reinterpret_cast<const float2*>(bias2 + c));
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *swizzled(ot, BOX, acc_row(h), c) =
          __floats2bfloat162_rn(acc.d[4 * i + 2 * h] + bv.x, acc.d[4 * i + 2 * h + 1] + bv.y);
  }
  warpgroup_sync(wg);
  bf16* ob = o + (static_cast<size_t>(b) * 2 * Kp + (wg ? Kp : 0) + m0) * C + j * BS;
  const int rows = kstore - m0 < MC ? kstore - m0 : MC;
  for (int q = tid & 127; q < rows * (BS / 8); q += 128) {
    const int r = q / (BS / 8), c = 8 * (q % (BS / 8));
    *reinterpret_cast<uint4*>(ob + static_cast<size_t>(r) * C + c) =
        *reinterpret_cast<const uint4*>(swizzled(ot, BOX, r, c));
  }
}

// grid (ceil(HW / 128), C / TN, B), NT threads: out[b] = Ainv . o[b] + xn[b]
// for 128 pixels and TN channels, from Ainv (map_ainv: (HWp, 2Kp), boxes of
// 64 modes x 128 px) and o (map_o: (B, 2Kp, C), 64 x 64 boxes), with xn
// recomputed in f32 from the x tile (map_x: (B, HW, C), boxes of 64
// channels x 128 px) and the statistics; out leaves by TMA (map_out), which
// drops the rows past HW.
template <int TN>
__global__ void __launch_bounds__(NT, 1)
stream_synthesis_kernel(const __grid_constant__ CUtensorMap map_ainv,
                        const __grid_constant__ CUtensorMap map_o,
                        const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_out, const float* stats,
                        const float* __restrict__ gscale, const float* __restrict__ gbias,
                        int C, int Kp, int groups) {
  using G = Syn<TN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int p0 = blockIdx.x * SYN_P, n0 = blockIdx.y * TN, b = blockIdx.z;
  const int nk = (2 * Kp + SYN_K - 1) / SYN_K;
  auto full = [&](int s) { return base + G::MISC + 8 * s; };
  auto empty = [&](int s) { return base + G::MISC + 8 * (G::NS + s); };
  const uint32_t xbar = base + G::MISC + 16 * G::NS;

  if (tid == 0) {
    for (int s = 0; s < G::NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), EMPTY_ARRIVALS);
    }
    mbar_init(xbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NC) {  // the producer warp
    if (tid == NC) {
      mbar_expect_tx(xbar, TN * 256);
      for (int h = 0; h < TN / 64; ++h)
        tma_load_3d(base + G::X_OFF + h * 2 * BOX, &map_x, xbar, n0 + h * 64, p0, b);
      // Ainv's first rows while the spectral grid finishes, o after it has
      const int pre = nk < G::NS ? nk : G::NS;
      for (int kb = 0; kb < pre; ++kb) {
        mbar_expect_tx(full(kb), G::SLOT);
        tma_load_2d(base + kb * G::SLOT, &map_ainv, full(kb), kb * SYN_K, p0);
      }
      wait_primary();
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % G::NS, use = kb / G::NS;
        const uint32_t slot = base + s * G::SLOT;
        if (use) {
          mbar_wait(empty(s), (use - 1) & 1);
          mbar_expect_tx(full(s), G::SLOT);
          tma_load_2d(slot, &map_ainv, full(s), kb * SYN_K, p0);
        }
        for (int h = 0; h < TN / 64; ++h)
          tma_load_3d(slot + G::AINV_BYTES + h * BOX, &map_o, full(s), n0 + h * 64, kb * SYN_K,
                      b);
      }
    }
    return;
  }

  wait_primary();
  float* col_mean = reinterpret_cast<float*>(sm + G::MISC + 128);
  float* col_rs = col_mean + TN;
  float* col_bias = col_rs + TN;
  if (tid < TN) {
    const int c = n0 + tid;
    const float* st = stats + 2 * (static_cast<size_t>(b) * groups + c / (C / groups));
    col_mean[tid] = st[0];
    col_rs[tid] = st[1] * __ldg(gscale + c);
    col_bias[tid] = __ldg(gbias + c);
  }

  Frag<TN> acc;
  zero(acc);
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % G::NS;
    mbar_wait(full(s), (kb / G::NS) & 1);
    pin(acc);
    wgmma_fence();
    const uint32_t slot = base + s * G::SLOT;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      acc.template mma<1, 1>(desc_k(slot + wg * BOX + kk * 32),
                             desc_mn(slot + G::AINV_BYTES + kk * 16 * 128, BOX));
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();
      pin(acc);
      release(empty((kb - 1) % G::NS));
    }
  }
  wgmma_wait<0>();
  pin(acc);
  consumer_sync();  // the column constants
  mbar_wait(xbar, 0);

  // out = acc + xn, written over the x tile
  uint8_t* xt = sm + G::X_OFF;
#pragma unroll
  for (int i = 0; i < TN / 8; ++i) {
    const int c = acc_col(i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162* p = swizzled(xt, 2 * BOX, 64 * wg + acc_row(h), c);
      const float2 xv = __bfloat1622float2(*p);
      const float xn0 = (xv.x - col_mean[c]) * col_rs[c] + col_bias[c];
      const float xn1 = (xv.y - col_mean[c + 1]) * col_rs[c + 1] + col_bias[c + 1];
      *p = __floats2bfloat162_rn(acc.d[4 * i + 2 * h] + xn0, acc.d[4 * i + 2 * h + 1] + xn1);
    }
  }
  fence_proxy_async();
  consumer_sync();
  if (tid == 0) {
    for (int h = 0; h < TN / 64; ++h)
      tma_store_3d(&map_out, base + G::X_OFF + h * 2 * BOX, n0 + h * 64, p0, b);
    tma_store_drain();
  }
}

// ---------------------------------------------------------------- host
// A kernel's dynamic shared memory allowed once per device.
template <typename K> cudaError_t allow_smem(K* kernel, int smem, bool (&done)[64], int dev) {
  if (dev < 64 && done[dev]) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// kernel<<<grid, NT, smem, s>>>(args...) as a programmatic dependent of
// the launch just before it on s.
template <typename... KArgs, typename... Args>
cudaError_t launch_dependent(void (*kernel)(KArgs...), dim3 grid, int smem, cudaStream_t s,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// HW is the latent's pixels, HWp and Kp the padded operators' sizes, kstore
// the modes the spectral launch stores (Kp, or less in the control)
struct Args {
  const bf16 *x, *A, *Ainv, *w1, *w2;
  const float *gscale, *gbias, *b1, *b2;
  float* stats;
  bf16 *o, *out;
  int B, HW, HWp, C, Kp, kstore, nb, groups, act;
};

// The spectral launch at block size BS.
template <int BS> int launch_spectral(int dev, const Args& a, cudaStream_t s) {
  using G = Spec<BS>;
  static bool done[64] = {};
  const uint64_t UB = static_cast<uint64_t>(a.B), UC = a.C, UHW = a.HW, UHWp = a.HWp,
                 UKp = a.Kp, UBS = BS, UNB = a.nb;
  const uint64_t dx[3] = {UC, UHW, UB}, da[3] = {UHWp, UKp, 2}, dw[4] = {UBS, UBS, UNB, 2};
  const uint32_t bx[3] = {64, PX, 1}, ba[3] = {PX, MC, 1}, bw[4] = {64, BS, 1, 1};
  CUtensorMap mx, ma, mw1, mw2;
  CUresult r;
  if ((r = tensor_map(&mx, a.x, 3, dx, bx, false)) != CUDA_SUCCESS ||
      (r = tensor_map(&ma, a.A, 3, da, ba, true)) != CUDA_SUCCESS ||
      (r = tensor_map(&mw1, a.w1, 4, dw, bw, true)) != CUDA_SUCCESS ||
      (r = tensor_map(&mw2, a.w2, 4, dw, bw, true)) != CUDA_SUCCESS)
    return 10000 + static_cast<int>(r);
  cudaError_t e;
  if ((e = allow_smem(stream_spectral_kernel<BS>, G::SMEM, done, dev)) != cudaSuccess) return e;
  return launch_dependent(stream_spectral_kernel<BS>,
                          dim3((a.Kp + MC - 1) / MC, a.nb, a.B), G::SMEM, s, mx, ma, mw1, mw2,
                          a.gscale, a.gbias, a.b1, a.b2, static_cast<const float*>(a.stats), a.o,
                          a.HWp, a.C, a.Kp, a.kstore, a.nb, a.groups, a.act);
}

// The synthesis launch at tile width TN.
template <int TN> int launch_synthesis_tn(int dev, const Args& a, cudaStream_t s) {
  using G = Syn<TN>;
  static bool done[64] = {};
  const uint64_t UB = static_cast<uint64_t>(a.B), UC = a.C, UHW = a.HW, UHWp = a.HWp,
                 UK2 = 2 * static_cast<uint64_t>(a.Kp);
  const uint64_t dx[3] = {UC, UHW, UB}, dob[3] = {UC, UK2, UB}, dai[2] = {UK2, UHWp};
  const uint32_t bt[3] = {64, SYN_P, 1}, bo[3] = {64, SYN_K, 1}, bai[2] = {SYN_K, SYN_P};
  CUtensorMap mx, mout, mo, mainv;
  CUresult r;
  if ((r = tensor_map(&mx, a.x, 3, dx, bt, false)) != CUDA_SUCCESS ||
      (r = tensor_map(&mout, a.out, 3, dx, bt, false)) != CUDA_SUCCESS ||
      (r = tensor_map(&mo, a.o, 3, dob, bo, false)) != CUDA_SUCCESS ||
      (r = tensor_map(&mainv, a.Ainv, 2, dai, bai, true)) != CUDA_SUCCESS)
    return 10000 + static_cast<int>(r);
  cudaError_t e;
  if ((e = allow_smem(stream_synthesis_kernel<TN>, G::SMEM, done, dev)) != cudaSuccess) return e;
  return launch_dependent(stream_synthesis_kernel<TN>,
                          dim3((a.HW + SYN_P - 1) / SYN_P, a.C / TN, a.B), G::SMEM, s, mainv, mo,
                          mx, mout, static_cast<const float*>(a.stats), a.gscale, a.gbias, a.C,
                          a.Kp, a.groups);
}

// The SMs of device dev, asked once.
int sm_count(int dev) {
  static int count[64] = {};
  int n = dev < 64 ? count[dev] : 0;
  if (!n && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
      dev < 64)
    count[dev] = n;
  return n;
}

}  // namespace

// afno_hopper_l.cu (AFNO blocks of 96 channels at 128- and 256-px latents)
// includes this file for the parts above and defines
// AFNO_HOPPER_STREAM_PARTS, which leaves out the entry points below and so
// every instance of stream_spectral_kernel.
#ifndef AFNO_HOPPER_STREAM_PARTS

// The shapes this kernel takes, as `hopper_stream_supported` in
// dpot_tpu_torch/ops/cuda/afno_fused.py states them (the dtype is bf16):
// a latent up to 4096 px with any K, but not one the other bf16 Hopper
// kernels take (128 or 256 px, K a multiple of 4, 2K <= 320); AFNO blocks
// of 64, 128 or 256 channels with groups of a power of two channels from 8
// to the block, or of 96 channels with groups of one block or a block pair;
// C a multiple of the narrowest synthesis tile (64).
extern "C" int dpot_afno_hopper_stream_supported(int B, int HW, int C, int K, int nb,
                                                 int groups) {
  if (B < 1 || B > 65535 || nb < 1 || C % nb || C % C_UNIT || groups < 1 || C % groups) return 0;
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
        bool drop, void* stream) {
  if (!dpot_afno_hopper_stream_supported(B, HW, C, K, nb, groups) || act < 0 ||
      act >= ACT_COUNT)
    return cudaErrorInvalidValue;
  const void* ptrs[] = {x, A, Ainv, w1t, w2t, o, out};
  for (const void* p : ptrs)
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  if ((reinterpret_cast<uintptr_t>(b1) | reinterpret_cast<uintptr_t>(b2)) & 7)
    return cudaErrorMisalignedAddress;  // read as float2
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  const int sms = sm_count(dev);
  if (!sms) return cudaErrorInvalidDevice;
  // the padded operators' sizes, as `padded_dims` in the wrapper
  const int HWp = (HW + PX - 1) / PX * PX, Kp = (K + KP_UNIT - 1) / KP_UNIT * KP_UNIT;
  if (drop && Kp <= DROP_UNIT) return cudaErrorInvalidValue;
  const int kstore = drop ? (Kp - 1) / DROP_UNIT * DROP_UNIT : Kp;
  const Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(A),
               static_cast<const bf16*>(Ainv), static_cast<const bf16*>(w1t),
               static_cast<const bf16*>(w2t), gscale, gbias, b1, b2, stats,
               static_cast<bf16*>(o), static_cast<bf16*>(out), B, HW, HWp, C, Kp, kstore, nb,
               groups, act};

  stream_stats_kernel<<<dim3(groups, B), STATS_NT, 0, s>>>(a.x, stats, HW, C, groups);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  int err;
  switch (C / nb) {
    case 64: err = launch_spectral<64>(dev, a, s); break;
    case 96: err = launch_spectral<96>(dev, a, s); break;
    case 128: err = launch_spectral<128>(dev, a, s); break;
    default: err = launch_spectral<256>(dev, a, s); break;
  }
  if (err) return err;

  // the widest synthesis tile that divides C and still fills the card
  const long long tiles = static_cast<long long>((HW + SYN_P - 1) / SYN_P) * B;
  if (C % 256 == 0 && tiles * (C / 256) >= sms) return launch_synthesis_tn<256>(dev, a, s);
  if (C % 128 == 0 && tiles * (C / 128) >= sms) return launch_synthesis_tn<128>(dev, a, s);
  return launch_synthesis_tn<64>(dev, a, s);
}

}  // namespace

// x, out (B, HW, C), A (2Kp, HWp), Ainv (HWp, 2Kp), o scratch (B, 2Kp, C)
// are bf16, HWp = HW rounded up to 64 and Kp = K rounded up to a multiple
// of 4, the operators zero past HW and at the modes K .. Kp - 1 (padded_ops
// in the wrapper); w1t/w2t are the bf16 block weights (2, nb, bs, bs), each
// block transposed to (out, in); gscale/gbias (C), b1/b2 (2, nb, bs) and
// the stats scratch (B * groups * 2) are f32. act is an ActId. Returns 0, a
// CUDA error, or 10000 + the CUresult of a failed tensor-map encoding.
extern "C" int dpot_afno_hopper_stream(int act, const void* x, const float* gscale,
                                       const float* gbias, const void* A, const void* Ainv,
                                       const void* w1t, const float* b1, const void* w2t,
                                       const float* b2, float* stats, void* o, void* out, int B,
                                       int HW, int C, int K, int nb, int groups, void* stream) {
  return run(act, x, gscale, gbias, A, Ainv, w1t, b1, w2t, b2, stats, o, out, B, HW, C, K, nb,
             groups, false, stream);
}

// A control for the checks that hold this kernel against its plain
// version, never called by the port: the same call with the modes of the
// last 32-mode chunk left out of o (o is cleared first, so their rows are
// zero, as a fault in the chunk arithmetic would leave them): modes 32-39
// of K 40, 64-83 of K 84, 512-543 of K 544, whatever chunk the spectral
// launch runs. The spectral launch computes those modes and does not store
// them. Refused where Kp <= 32 (there would be nothing left).
extern "C" int dpot_afno_hopper_stream_drop_last_chunk(
    int act, const void* x, const float* gscale, const float* gbias, const void* A,
    const void* Ainv, const void* w1t, const float* b1, const void* w2t, const float* b2,
    float* stats, void* o, void* out, int B, int HW, int C, int K, int nb, int groups,
    void* stream) {
  const size_t Kp = (K + KP_UNIT - 1) / KP_UNIT * KP_UNIT;
  const cudaError_t e = cudaMemsetAsync(o, 0, static_cast<size_t>(B) * 2 * Kp * C * sizeof(bf16),
                                        static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return run(act, x, gscale, gbias, A, Ainv, w1t, b1, w2t, b2, stats, o, out, B, HW, C, K, nb,
             groups, true, stream);
}

#endif  // AFNO_HOPPER_STREAM_PARTS
