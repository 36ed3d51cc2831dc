// Device code shared by the selective-scan kernels (`ssm_scan.cu`,
// `ssm_scan_bwd.cu`): the block shape both walk the sequence with (32
// channels x 8 time segments of a 64-step chunk), the exponential, and the
// cp.async staging of (S, width) slabs into tiles of padded segments.
// Each kernel source is its own translation unit and library, so the
// anonymous namespace gives each its own copy.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CB = 32;          // channels per block
constexpr int P = 8;            // segments per chunk (a channel's lanes)
constexpr int R = 8;            // steps per segment
constexpr int L = P * R;        // steps per chunk
constexpr int NT = CB * P;      // threads per block
constexpr int CPW = 32 / P;     // channels per warp
constexpr int PAD = 16;         // bytes after each segment's rows in a tile
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// bytes of one segment of a staged tile: R rows of CB elements (dt, x, y)
// or of n elements (B, C), then the padding
__host__ __device__ constexpr int x_seg(int elt) { return R * CB * elt + PAD; }
__host__ __device__ constexpr int bc_seg(int n, int elt) {
  return R * n * elt + PAD;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// G consecutive values from shared memory as floats (16-, 8- or 4-byte
// aligned as G and the element size give)
template <int G>
__device__ __forceinline__ void load_g(float* v, const float* p) {
  if constexpr (G == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (G == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) v[j] = p[j];
  }
}
template <int G>
__device__ __forceinline__ void load_g(float* v, const __nv_bfloat16* p) {
  static_assert(G % 2 == 0, "bf16 groups load in pairs");
#pragma unroll
  for (int j = 0; j < G; j += 2) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p + j));
    v[j] = f.x; v[j + 1] = f.y;
  }
}
template <int G>
__device__ __forceinline__ void store_g(float* p, const float* v) {
  if constexpr (G == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) p[j] = v[j];
  }
}

// `unit` bytes (16, 8 or 4) from device to shared memory by cp.async, the
// first `valid` from src and the rest zero; unit 2 (bf16 on 2-byte
// alignment) is a plain copy
__device__ __forceinline__ void copy_unit(void* dst, const void* src, int unit,
                                          int valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (unit == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid) : "memory");
  else if (unit == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid) : "memory");
  else if (unit == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid) : "memory");
  else
    *static_cast<uint16_t*>(dst) =
        valid ? *static_cast<const uint16_t*>(src) : uint16_t(0);
}

// Rows s0 .. s0 + L - 1 of a (S, width) slab (row stride ss elements, from
// src) into a tile whose row t sits at (t / R) * seg + (t % R) * row_bytes;
// elements past `width` and rows past S are zero. Row bytes and the unit
// are powers of two, so a copy's row and offset are shifts.
template <typename T>
__device__ __forceinline__ void load_tile(unsigned char* tile, const T* src,
                                          long long ss, int s0, int S,
                                          int width, int row_bytes, int seg,
                                          int unit, int tid) {
  constexpr int E = sizeof(T);
  const int lu = __ffs(unit) - 1, lr = __ffs(row_bytes) - 1 - lu;
  for (int i = tid; i < (L << lr); i += NT) {
    const int t = i >> lr, o = (i & ((1 << lr) - 1)) << lu, s = s0 + t;
    const int col = o / E;
    const int valid = s < S ? min(unit, max(0, (width - col) * E)) : 0;
    const T* g = src + (long long)min(s, S - 1) * ss + (valid ? col : 0);
    copy_unit(tile + (t / R) * seg + (t % R) * row_bytes + o, g, unit, valid);
  }
}

// The widest copy (16, 8 or 4 bytes) that the base, the strides that matter
// and the row's bytes allow; 2 for bf16 rows on 2-byte alignment.
int unit_of(const void* p, long long sb, long long ss, int B, int S, int elt,
            int row_bytes) {
  for (int u = 16; u >= 4; u /= 2) {
    if (reinterpret_cast<uintptr_t>(p) % u || row_bytes % u) continue;
    if (B > 1 && (sb * elt) % u) continue;
    if (S > 1 && (ss * elt) % u) continue;
    return u;
  }
  return 2;
}

}  // namespace
