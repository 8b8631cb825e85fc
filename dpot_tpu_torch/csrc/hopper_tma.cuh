// What the bf16 Hopper kernels of fused_gn_afno share: afno_hopper.cu
// (AFNO blocks of 128 channels), afno_hopper_wide.cu (256 channels),
// afno_hopper_stream.cu and, through it, afno_hopper_l.cu (96 channels).
//
//   - PTX wrappers for mbarriers, TMA loads and stores, programmatic
//     dependent launch and wgmma (m64n128k16, bf16 in, f32 accumulate);
//   - the synthesis launch of afno_hopper.cu and afno_hopper_wide.cu,
//     tma_synthesis_kernel: out = Ainv . o + xn, one
//     CTA per (128 pixels, 128 channels, sample), which does not depend on
//     the AFNO block size (it reads o (B, 2K, C) and the GroupNorm
//     statistics (B, groups, 2) that the spectral launch leaves);
//   - on the host, tensor maps (a small cache for the tensors that stay)
//     and the synthesis launch with its maps.
//
// Layouts in shared memory, all with the 128-byte swizzle that TMA writes
// and wgmma reads: K-major tiles (A rows, Ainv rows, weights, z, h) are
// rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes apart; the
// MN-major operands (xn and o, whose channels are contiguous in memory)
// are read with wgmma's transpose flag, 64 channels per 128-byte row, the
// 64-channel blocks `lbo` bytes apart.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

using bf16 = __nv_bfloat16;

constexpr int SYN_NT = 256;    // threads per synthesis CTA: two warpgroups
constexpr int TILE_P = 128;    // pixels per synthesis CTA
constexpr int TILE_C = 128;    // channels per synthesis CTA
constexpr int MAX_NK = 5;      // 64-mode k-blocks of 2K a synthesis CTA holds
// tma_synthesis_kernel's shared memory: Ainv [nk][128][64], o [2 halves]
// [nk * 64][64], the x tile (then the out tile) [2 halves][128][64], then
// nk + 1 mbarriers and the column constants, + alignment slack
constexpr int synthesis_smem(int nk) { return nk * 32768 + 32768 + 3072 + 1024; }

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for phase `parity` of the barrier. A load that never lands (a bad
// tensor map) traps after about two seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 4000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Wait until the bulk stores this thread issued have read shared memory.
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Barrier of the 128 threads of warpgroup wg (barrier 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Programmatic dependent launch: the next kernel on the stream may start
// (launch_dependents), and waits for this one's results (wait_primary).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand: rows of 64 k, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return make_desc(addr, 16, 1024); }
// MN-major operand: 64 channels per row, one row per k, 8-row k groups
// 1024 bytes apart, 64-channel blocks lbo bytes apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return make_desc(addr, lbo, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

struct Acc {
  float d[64];  // m64 x n128 f32 accumulator of one warpgroup

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
  }
  // keep the compiler from moving the registers across wgmma's async use
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
  }
  // d += A . (SB * B), m64 n128 k16, bf16 operands; TB: B is MN-major
  template <int SB, int TB> __device__ __forceinline__ void mma(uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, %67, 0, %68;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(SB), "n"(TB));
  }
};

// Accumulator element (4 i + 2 h + e) of a thread sits at row
// 16 warp + lane / 4 + 8 h and column 8 i + 2 (lane % 4) + e of the m64 x
// nN tile (warp and lane within the warpgroup).
__device__ __forceinline__ int acc_row(int h) {
  return 16 * ((threadIdx.x & 127) >> 5) + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int acc_col(int i) { return 8 * i + 2 * (threadIdx.x & 3); }

__device__ __forceinline__ float sum8(const float (&f)[8]) {
  return ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// grid (HW / 128, C / 128, B): out[b] = Ainv . o[b] + xn[b] for 128 pixels
// and 128 channels, xn recomputed in f32 from the x tile (brought by TMA
// with the operands) and the statistics; out goes back by TMA from the
// bytes of the x tile. Launched as a programmatic dependent of the
// spectral kernel: the Ainv rows and the x tile load while that grid
// finishes, o and the statistics only after it has.
__global__ void __launch_bounds__(SYN_NT, 1)
tma_synthesis_kernel(const __grid_constant__ CUtensorMap map_ainv,
                     const __grid_constant__ CUtensorMap map_o,
                     const __grid_constant__ CUtensorMap map_xt,
                     const __grid_constant__ CUtensorMap map_out, const float* __restrict__ stats,
                     const float* __restrict__ gscale, const float* __restrict__ gbias, int C,
                     int K, int groups) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * TILE_P, n0 = blockIdx.y * TILE_C, b = blockIdx.z;
  const int nk = (2 * K + 63) / 64;
  const int o_off = nk * 16384, x_off = nk * 32768, misc = x_off + 32768;
  auto bar = [&](int i) { return base + misc + 8 * i; };  // k-block i < nk; x tile: nk
  float* col_mean = reinterpret_cast<float*>(sm + misc + 64);
  float* col_rstd = col_mean + TILE_C;
  float* col_scale = col_rstd + TILE_C;
  float* col_bias = col_scale + TILE_C;

  if (tid == 0) {
    for (int kb = 0; kb <= nk; ++kb) mbar_init(bar(kb), 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar(nk), 32768);
    for (int h = 0; h < 2; ++h)
      tma_load_3d(base + x_off + h * 16384, &map_xt, bar(nk), n0 + h * 64, m0, b);
    for (int kb = 0; kb < nk; ++kb) {
      mbar_expect_tx(bar(kb), 32768);
      tma_load_2d(base + kb * 16384, &map_ainv, bar(kb), kb * 64, m0);
    }
  }
  wait_primary();
  if (tid == 0)
    for (int kb = 0; kb < nk; ++kb)
      for (int h = 0; h < 2; ++h)
        tma_load_3d(base + o_off + h * nk * 8192 + kb * 8192, &map_o, bar(kb), n0 + h * 64,
                    kb * 64, b);
  if (tid < TILE_C) {
    const int c = n0 + tid, s = 2 * (b * groups + c / (C / groups));
    col_mean[tid] = stats[s];
    col_rstd[tid] = stats[s + 1];
    col_scale[tid] = gscale[c];
    col_bias[tid] = gbias[c];
  }
  __syncthreads();

  Acc acc;
  acc.zero();
  acc.fence();
  wgmma_fence();
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(bar(kb), 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      acc.mma<1, 1>(desc_k(base + kb * 16384 + wg * 8192 + kk * 32),
                    desc_mn(base + o_off + (kb * 64 + kk * 16) * 128, nk * 8192));
  }
  wgmma_commit();
  wgmma_wait_all();
  acc.fence();
  mbar_wait(bar(nk), 0);

  // out = acc + xn, written over x in the swizzled tile [2 halves][128][64]
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = acc_col(i), cc = c & 63;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + acc_row(h);
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
          sm + x_off + (c >> 6) * 16384 + r * 128 + (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2);
      const float2 xv = __bfloat1622float2(*p);
      const float xn0 = (xv.x - col_mean[c]) * col_rstd[c] * col_scale[c] + col_bias[c];
      const float xn1 =
          (xv.y - col_mean[c + 1]) * col_rstd[c + 1] * col_scale[c + 1] + col_bias[c + 1];
      *p = __floats2bfloat162_rn(acc.d[4 * i + 2 * h] + xn0, acc.d[4 * i + 2 * h + 1] + xn1);
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    for (int h = 0; h < 2; ++h)
      tma_store_3d(&map_out, base + x_off + h * 16384, n0 + h * 64, m0, b);
    tma_store_drain();
  }
}

// ---------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API call, reached through the runtime.
EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map of a contiguous row-major bf16 tensor with 128-byte swizzle
// (or `swizzle`: a box whose rows are 64 bytes takes the 64-byte one);
// dims and box innermost first, out-of-bounds elements read as zero. A map
// depends only on these values, so the maps of tensors that stay (A, Ainv,
// the cached weights) are kept in a small per-thread cache.
struct MapKey {
  const void* ptr;
  int rank;
  uint64_t dims[4];
  uint32_t box[4];
  int swizzle;
};

CUresult tensor_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                    const uint32_t* box, bool cached,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  constexpr int SLOTS = 16;
  thread_local MapKey keys[SLOTS];
  thread_local CUtensorMap maps[SLOTS];
  thread_local int used = 0, next = 0;
  MapKey key;
  std::memset(&key, 0, sizeof key);
  key.ptr = ptr;
  key.rank = rank;
  key.swizzle = static_cast<int>(swizzle);
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
  }
  if (cached)
    for (int i = 0; i < used; ++i)
      if (std::memcmp(&keys[i], &key, sizeof key) == 0) {
        *map = maps[i];
        return CUDA_SUCCESS;
      }
  cuuint64_t strides[3];
  cuuint64_t stride = sizeof(bf16);
  cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const EncodeTiled encode = encode_fn();
  if (!encode) return CUDA_ERROR_NOT_SUPPORTED;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                            reinterpret_cast<const cuuint64_t*>(dims), strides,
                            reinterpret_cast<const cuuint32_t*>(box), estride,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS && cached) {
    keys[next] = key;
    maps[next] = *map;
    next = (next + 1) % SLOTS;
    if (used < SLOTS) ++used;
  }
  return r;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Launches tma_synthesis_kernel on stream s as a programmatic dependent of
// the spectral launch just before it: out (B, HW, C) = Ainv (HW, 2K) .
// o (B, 2K, C) + xn, xn from x (B, HW, C) and stats (B, groups, 2), all
// bf16 but stats, gscale and gbias. HW is a multiple of 128, C of 128,
// 2K <= 64 MAX_NK. Returns 0, a CUDA error, or 10000 + the CUresult of a
// failed tensor-map encoding.
int launch_synthesis(const void* x, const void* Ainv, const void* o, void* out,
                     const float* stats, const float* gscale, const float* gbias, int B, int HW,
                     int C, int K, int groups, cudaStream_t s) {
  const uint64_t UB = static_cast<uint64_t>(B), UC = C, UHW = HW, UK = K;
  const uint64_t dx[3] = {UC, UHW, UB}, dob[3] = {UC, 2 * UK, UB}, dai[2] = {2 * UK, UHW};
  const uint32_t bt[3] = {64, TILE_P, 1}, bo[3] = {64, 64, 1}, bai[2] = {64, TILE_P};
  CUtensorMap mxt, mout, mo, mainv;
  CUresult r;
  if ((r = tensor_map(&mxt, x, 3, dx, bt, false)) != CUDA_SUCCESS ||
      (r = tensor_map(&mout, out, 3, dx, bt, false)) != CUDA_SUCCESS ||
      (r = tensor_map(&mo, o, 3, dob, bo, false)) != CUDA_SUCCESS ||
      (r = tensor_map(&mainv, Ainv, 2, dai, bai, true)) != CUDA_SUCCESS)
    return 10000 + static_cast<int>(r);

  cudaError_t e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  static bool allowed[64] = {};
  if (dev >= 64 || !allowed[dev]) {
    if ((e = cudaFuncSetAttribute(tma_synthesis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  synthesis_smem(MAX_NK))) != cudaSuccess)
      return e;
    if (dev < 64) allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(HW / TILE_P, C / TILE_C, B);
  cfg.blockDim = dim3(SYN_NT);
  cfg.dynamicSmemBytes = synthesis_smem((2 * K + 63) / 64);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, tma_synthesis_kernel, mainv, mo, mxt, mout, stats, gscale,
                              gbias, C, K, groups)) != cudaSuccess)
    return e;
  return cudaGetLastError();
}

}  // namespace
