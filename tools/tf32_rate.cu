// TF32 tensor-core rates on the card: warp-level mma.sync m16n8k8 against
// warpgroup-level wgmma m64n128k8 (operands in shared memory, or A in
// registers), and the inner loop of afno_hopper_f32.cu (its mma_k8: fragment
// loads, the register split, three mma and the f32 promotion) with nothing
// around it. Built and run by tools/tf32_rate.py; not part of the port.

#include "afno_hopper_f32.cu"

namespace {

// 1. mma.sync with register operands, eight independent accumulators per
// warp, 8 warps per CTA: the instruction's own rate.
__global__ void __launch_bounds__(256) mma_sync_peak(const float* in, float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(in[(threadIdx.x * 7 + i) & 1023]);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(in[(threadIdx.x * 5 + i + 4) & 1023]);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < 8; ++n) mma_tf32(d[n], a, b);
  }
  float s = 0.f;
  for (int n = 0; n < 8; ++n)
    for (int e = 0; e < 4; ++e) s += d[n][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// 2. mma_k8<MT> on an A tile [32 MT][LDA] and a B tile [KC][LDX] that stay
// in shared memory, 8 warps each computing a (16 MT) x 32 tile as the
// spectral launch lays them out (z = A . xn, without the normalisation).
// An opaque zero offset each iteration keeps the compiler from hoisting
// the loads and splits out of the loop.
template <int MT>
__global__ void __launch_bounds__(NT, 2) inner_loop(const float* in, float* out, int iters) {
  __shared__ __align__(16) float as[2 * 16 * MT * LDA];
  __shared__ __align__(16) float xs[KC * LDX];
  for (int i = threadIdx.x; i < 2 * 16 * MT * LDA; i += NT) as[i] = in[i & 1023];
  for (int i = threadIdx.x; i < KC * LDX; i += NT) xs[i] = in[(3 * i) & 1023];
  __syncthreads();
  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int rb = 16 * MT * (warp >> 2), cb = 32 * (warp & 3);
  WarpAcc<MT> acc;
  zero<MT>(acc);
  for (int it = 0; it < iters; ++it) {
    int off;
    asm volatile("mov.u32 %0, 0;" : "=r"(off));
    const float* a_t = as + off;
    const float* x_t = xs + off;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk)
      mma_k8<MT>(
          acc,
          [&](int mt, int h, int q) { return a_t[(rb + 16 * mt + g + 8 * h) * LDA + 8 * kk + t + 4 * q]; },
          [&](int nt, int q) { return x_t[(8 * kk + t + 4 * q) * LDX + cb + 8 * nt + g]; });
  }
  float s = 0.f;
  for (int mt = 0; mt < MT; ++mt)
    for (int nt = 0; nt < 4; ++nt)
      for (int e = 0; e < 4; ++e) s += acc[mt][nt][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// wgmma shared-memory descriptor, 128-byte swizzle, K-major: rows of 32
// f32 values (128 bytes), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d += A . B^T, m64 n128 k8, tf32 operands from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// the same with A from registers: the m16n8k8 A fragment of each warp's
// 16 rows
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 3. wgmma, two warpgroups per CTA: warpgroup wg multiplies rows 64 wg ..
// of A (128 x 32) by B (128 x 32), both K-major in the 128-byte swizzle,
// 16 k8 steps per commit. RS: A from registers. CHECK: one pass over
// k = 0 .. 31, D (128 x 128) written out.
constexpr int WG_SMEM = 33 * 1024;  // A and B, 16 KB each, and 1 KB to align

template <bool RS, bool CHECK>
__global__ void __launch_bounds__(256) wgmma_peak(const float* in, float* out, int iters) {
  extern __shared__ uint8_t smraw[];
  const uint32_t raw = smem_u32(smraw), base = (raw + 1023) & ~1023u;
  uint8_t* sm = smraw + (base - raw);
  // rows 0 .. 127 of in: A; rows 128 .. 255: B; 32 values each
  for (int i = threadIdx.x; i < 256 * 32; i += 256) {
    const int r = i >> 5, k = i & 31;
    *reinterpret_cast<float*>(sm + r * 128 + (((k >> 2) ^ (r & 7)) << 4) + (k & 3) * 4) = in[i];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, g = lane_g(), t = lane_t();
  const uint32_t a_base = base + wg * 8192, b_base = base + 16384;
  uint32_t ar[4][4];
  const int r0 = 64 * wg + 16 * warp + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ar[kk][0] = __float_as_uint(in[r0 * 32 + 8 * kk + t]);
    ar[kk][1] = __float_as_uint(in[(r0 + 8) * 32 + 8 * kk + t]);
    ar[kk][2] = __float_as_uint(in[r0 * 32 + 8 * kk + t + 4]);
    ar[kk][3] = __float_as_uint(in[(r0 + 8) * 32 + 8 * kk + t + 4]);
  }
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const int n = CHECK ? 1 : iters;
  for (int it = 0; it < n; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int rep = 0; rep < (CHECK ? 1 : 4); ++rep)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (RS) wgmma_rs(d, ar[kk], desc_k(b_base + 32 * kk));
        else wgmma_ss(d, desc_k(a_base + 32 * kk), desc_k(b_base + 32 * kk));
      }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
  }
  if constexpr (CHECK) {
    // element 4 i + 2 h + e at row 16 warp + g + 8 h, column 8 i + 2 t + e
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          out[(r0 + 8 * h) * 128 + 8 * i + 2 * t + e] = d[4 * i + 2 * h + e];
  } else {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s += d[i];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  }
}

}  // namespace

// which: 0 mma.sync, 1 and 2 mma_k8 at MT = 1 and 2, 3 wgmma SS, 4 wgmma
// RS, 5 and 6 their one-pass checks (one CTA). in: 8192 f32, out: one f32
// per thread of the grid (16384 for the checks). Returns a CUDA error.
extern "C" int tf32_rate(int which, const float* in, float* out, int iters, int blocks,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: mma_sync_peak<<<blocks, 256, 0, s>>>(in, out, iters); break;
    case 1: inner_loop<1><<<blocks, NT, 0, s>>>(in, out, iters); break;
    case 2: inner_loop<2><<<blocks, NT, 0, s>>>(in, out, iters); break;
    case 3: wgmma_peak<false, false><<<blocks, 256, WG_SMEM, s>>>(in, out, iters); break;
    case 4: wgmma_peak<true, false><<<blocks, 256, WG_SMEM, s>>>(in, out, iters); break;
    case 5: wgmma_peak<false, true><<<1, 256, WG_SMEM, s>>>(in, out, 1); break;
    case 6: wgmma_peak<true, true><<<1, 256, WG_SMEM, s>>>(in, out, 1); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
