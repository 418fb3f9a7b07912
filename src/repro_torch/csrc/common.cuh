// Pieces shared by the kernels, and which source uses each:
//  * dtype conversion (to_f, from_f): all three sources;
//  * warp reductions (warp_max, warp_sum): decode_attention.cu, and the
//    fp32 CUDA-core body of flash_attention.cu;
//  * cp.async copies (cp_async16, cp_async4, cp_async_commit,
//    cp_async_wait): decode_attention.cu (its per-warp rings), and the bf16
//    tensor-core body of flash_attention.cu (its K/V ring);
//  * stage_tile, one K/V tile staged in shared memory as fp32: only the
//    fp32 CUDA-core body of flash_attention.cu;
//  * tensor-core fragments (ldmatrix_x4, ldmatrix_x4_trans, mma_bf16): the
//    bf16 tensor-core bodies of flash_attention.cu and ssd_scan.cu.
// kernels/build.py hashes this header with each source, so an edit here
// rebuilds every library.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;  // keys per tile: one per lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes (4 bytes) from global to shared memory, asynchronously; with
// `in` false nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives this lane's part of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a b for a 16 x 16 bf16 A-fragment and a 16 x 8 bf16 B-fragment
// (b0, b1), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage keys [t0, t0 + kTile) of K and V (rows of `row` elements apart,
// 16-byte aligned) into shared memory as fp32, zero past `hi`: K with row
// stride D + 1 (lane j then reads key j without bank conflicts), V with row
// stride D.  Each thread issues four 16-byte loads of K and four of V before
// it converts any, so a tile costs about one round trip to memory instead of
// one per element.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* ks, float* vs, const T* kb,
                                           const T* vb, size_t row, int t0,
                                           int hi) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;  // vectors per key row
  constexpr int NV = kTile * VPR;
  constexpr int DP = D + 1;
  for (int base = threadIdx.x; base < NV; base += 4 * blockDim.x) {
    uint4 kr[4], vr[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * blockDim.x, t = t0 + i / VPR;
      const size_t off = (size_t)t * row + (i % VPR) * VEC;
      const bool in = i < NV && t < hi;
      kr[u] = in ? *reinterpret_cast<const uint4*>(kb + off) : make_uint4(0, 0, 0, 0);
      vr[u] = in ? *reinterpret_cast<const uint4*>(vb + off) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * blockDim.x;
      if (i >= NV) break;
      const int j = i / VPR, c = (i % VPR) * VEC;
      const T* ke = reinterpret_cast<const T*>(&kr[u]);
      const T* ve = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[j * DP + c + e] = to_f(ke[e]);
        vs[j * D + c + e] = to_f(ve[e]);
      }
    }
  }
}

}  // namespace attn
