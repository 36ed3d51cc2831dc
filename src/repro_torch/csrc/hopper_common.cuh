// Hopper (sm_90a) primitives shared by the flash attention kernels
// (`flash_attention.cu`, `flash_attention_bwd.cu`): mbarriers, TMA tile
// loads, `wgmma` with A from registers, the 3xTF32 split of fp32 operands
// and the shared-memory tiles it needs, and the host-side tensor maps. Each
// kernel source is its own translation unit and library, so the anonymous
// namespace gives each its own copy.
//
// Tiles come by TMA as boxes of 128 bytes of the head dim by `rows` rows,
// swizzled 128 bytes (a 16-byte chunk c of row r sits at chunk c ^ (r & 7)),
// one box after the other; every tile starts on 1024 bytes, where the
// swizzle's pattern repeats. `wgmma` reads them through descriptors
// (`sdesc`).
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr uint32_t TF32_MASK = 0xffffe000u;

__host__ __device__ constexpr int align1k(int n) { return (n + 1023) / 1024 * 1024; }

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Waits for the phase of `parity` to complete. A wait past 10 s (a broken
// pipeline: no wait of a working one lasts a tile's compute) traps, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t n = 0; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (n == 0) t0 = now_ns();
    else if (!done && (n & 1023) == 0 && now_ns() - t0 > 10000000000ull)
      __trap();
  }
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// the consumer warpgroups only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}
// orders this thread's shared-memory writes before the async proxy's reads
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps registers that an in-flight wgmma reads or writes in place until the
// wait (the compiler may not move or reuse them across this point)
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: rows of 128
// bytes, 8-row groups SBO bytes apart, (MN-major operands) 64-element column
// blocks LBO bytes apart.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// wgmma with A from registers: m64nNk8 TF32 and m64nNk16 bf16 (TRANS_B = 1
// reads B MN-major)
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4],
    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], const uint32_t (&a)[4],
    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16], const uint32_t (&a)[4],
    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B)
      : "memory");
}

// one wgmma of N = BN columns (32 or 64)
template <int BN>
__device__ __forceinline__ void mma_tf32(float (&d)[BN / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (BN == 64) wgmma_tf32_n64(d, a, desc);
  else wgmma_tf32_n32(d, a, desc);
}
template <int BN, int TRANS_B>
__device__ __forceinline__ void mma_bf16(float (&d)[BN / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (BN == 64) wgmma_bf16_n64<TRANS_B>(d, a, desc);
  else wgmma_bf16_n32<TRANS_B>(d, a, desc);
}

// v = hi + lo: hi is v rounded to TF32's 11 significant bits, lo = v - hi
// exact in fp32 (the tensor core reads lo's top 11 bits: 2^-22 of v lost)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & TF32_MASK;
  lo = __float_as_uint(v - __uint_as_float(hi));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 3xTF32 with a TMA tile as a K-major B operand. The tensor core reads an
// fp32 word as TF32 by ignoring its low 13 mantissa bits (checked on the
// card: writing the tile's hi part over it first gave the same outputs to
// the last bit), so the raw tile serves as its own hi part and only its lo
// part (the value minus its top 19 bits) gets a tile of its own, in the
// same layout. BYTES: the tile's size; NC threads, the first NC of the CTA.
template <int BYTES, int NC>
__device__ __forceinline__ void split_lo(const uint8_t* y, uint8_t* lo) {
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* l4 = reinterpret_cast<float4*>(lo);
  for (int i = threadIdx.x; i < BYTES / 16; i += NC) {
    const float4 x = y4[i];
    const float4 hi = make_float4(
        __uint_as_float(__float_as_uint(x.x) & TF32_MASK),
        __uint_as_float(__float_as_uint(x.y) & TF32_MASK),
        __uint_as_float(__float_as_uint(x.z) & TF32_MASK),
        __uint_as_float(__float_as_uint(x.w) & TF32_MASK));
    l4[i] = make_float4(x.x - hi.x, x.y - hi.y, x.z - hi.z, x.w - hi.w);
  }
}

// A TMA tile of BN rows (keys) x an fp32 head dim (128-byte boxes of BN
// rows) as the B operand of a product over its rows (O += P V): TF32
// `wgmma` reads B K-major only, so columns c0 .. c0 + HO - 1 are written
// transposed, HO rows x BN, as hi and lo parts, each 8-key group in the
// order of the P fragments that meet it (slot t + 4e holds key 2t + e: the
// A fragments are taken straight from an accumulator's layout, where a
// thread holds keys 2t and 2t + 1), swizzled in 32-key chunks of HO rows x
// 128 bytes.
template <int HO, int BN, int NC>
__device__ __forceinline__ void split_t(const uint8_t* y, int c0, uint8_t* th,
                                        uint8_t* tl) {
  for (int i = threadIdx.x; i < HO * BN / 4; i += NC) {
    const int d = i % HO, uk = i / HO;      // uk: 16-byte unit of a row
    const int key0 = 8 * (uk >> 1) + (uk & 1), col = c0 + d;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 2 * e;
      const float x = *reinterpret_cast<const float*>(
          y + (col / 32) * BN * 128 + key * 128 +
          ((((col % 32) >> 2) ^ (key & 7)) << 4) + (col & 3) * 4);
      split_tf32(x, hi[e], lo[e]);
    }
    const int off = (uk / 8) * HO * 128 + d * 128 + (((uk & 7) ^ (d & 7)) << 4);
    *reinterpret_cast<uint4*>(th + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(tl + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// ------------------------------------------------------------------ host
// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library links no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// error codes beyond the CUDA runtime's
constexpr int ERR_NO_ENCODER = 10000;   // + 0
constexpr int ERR_ENCODE = 10001;       // + the CUresult

// A 4-D map of (B, heads, L, hd) read through element strides (seq, head,
// batch), boxes of 128 bytes of hd by `rows` rows, swizzled 128 bytes, zero
// fill past L.
int make_map(CUtensorMap* map, const void* base, bool fp32, int hd, int L,
             int heads, int B, long long sseq, long long shead,
             long long sbatch, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const int es = fp32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)L,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sseq * es),
                                 (cuuint64_t)(shead * es),
                                 (cuuint64_t)(sbatch * es)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

}  // namespace
