// Flash-decode for Hopper (sm_90a): one query token per slot attending over
// the slot KV cache, with per-slot valid lengths and query positions.  One
// body serves two caches through its K/V-loader template parameter: K/V in
// the query's dtype (flash_decode_launch), and int8 K/V with per-token fp32
// scales (flash_decode_int8_launch).
//
// Replaces: src/repro/kernels/decode_attention.py::_decode_kernel (entry
// flash_decode), the Pallas TPU kernel on every decode step of the served
// path, and ::_decode_kernel_int8 (entry flash_decode_int8), the one that
// reads an int8 cache: every decode step of the step functions over an
// int8 linear cache (launch/steps.py).
//
// Bound on the card: bytes.  A step reads kv_len rows of K and V for each
// slot and does 4*D flops per (query head, key): at GQA 6 in bf16 that is
// about 6 flops per byte (12 over int8 codes), far under the ~295 flops per
// byte at which the H100's tensor cores, and not its memory, would set the
// limit.  An int8 row is D bytes per KV head plus one 4-byte scale per
// token for K and for V: at decode_32k (B=128, L=32768, 2 KV heads, D=128)
// a call reads 2.18 GB, 0.651 ms at 3.35 TB/s.
//
// Design:
//  * one block per (slot, kv head); its G = H/KH warps each own one query
//    head of the group, so every K/V tile is read from device memory once for
//    the whole group (the TPU grid re-read it for each query head);
//  * the block reads its own kv_len / q_offset from device vectors (the GPU
//    has no scalar prefetch), so one launch serves slots at any depth;
//  * it walks only the rows in [lo, hi) that the mask keeps
//    (k_pos < kv_len, k_pos <= q_pos, k_pos > q_pos - window, k_pos < L): a
//    masked row adds exactly 0 to the online softmax, so skipping it
//    computes the same function and stops at kv_len instead of the buffer
//    length L (a step at len == L passes kv_len = L + 1);
//  * tiles of 32 keys are staged in shared memory as fp32 (row stride D+1, so
//    lane j reads key j without bank conflicts) with 16-byte loads, several in
//    flight per thread (16 int8 codes per load: a 128-dim row is 8 loads);
//    an int8 tile is dequantized while it is staged, code * scale in fp32 as
//    the TPU kernel does, and the threads that stage one row read its scale
//    in the same coalesced load, so each scale crosses from memory once;
//    lane j scores key j, and each lane accumulates D/32 output dims in fp32
//    registers;
//  * a fully masked row gives 0: the denominator is clamped at 1e-30;
//  * offsets are size_t: one layer of a decode_32k int8 cache is 1.07 GB of
//    codes for K alone.
// Known limit: the grid has only B*KH blocks (8 at the served shape, 256 at
// decode_32k) for the card's 132 SMs, and each walks its rows one tile at a
// time.  Splitting the KV axis across blocks, with a combine pass, is the
// next step.

#include <cstdint>

#include "common.cuh"

namespace {

using namespace attn;

constexpr int kMaxGroup = 16;

// Stage keys [t0, t0 + kTile) of int8 K and V (rows of `row` codes apart,
// 16-byte aligned) into shared memory as fp32 code * scale, zero past `hi`,
// in stage_tile's layout.  ksc / vsc are the slot's per-token scales.
template <int D>
__device__ __forceinline__ void stage_tile_int8(float* ks, float* vs,
                                                const int8_t* kb, const int8_t* vb,
                                                const float* ksc, const float* vsc,
                                                size_t row, int t0, int hi) {
  constexpr int VEC = 16;       // codes per 16-byte load
  constexpr int VPR = D / VEC;  // loads per key row
  constexpr int NV = kTile * VPR;
  constexpr int DP = D + 1;
  for (int base = threadIdx.x; base < NV; base += 4 * blockDim.x) {
    uint4 kr[4], vr[4];
    float sk[4], sv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * blockDim.x, t = t0 + i / VPR;
      const size_t off = (size_t)t * row + (i % VPR) * VEC;
      const bool in = i < NV && t < hi;
      kr[u] = in ? *reinterpret_cast<const uint4*>(kb + off) : make_uint4(0, 0, 0, 0);
      vr[u] = in ? *reinterpret_cast<const uint4*>(vb + off) : make_uint4(0, 0, 0, 0);
      sk[u] = in ? ksc[t] : 0.f;
      sv[u] = in ? vsc[t] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * blockDim.x;
      if (i >= NV) break;
      const int j = i / VPR, c = (i % VPR) * VEC;
      const int8_t* ke = reinterpret_cast<const int8_t*>(&kr[u]);
      const int8_t* ve = reinterpret_cast<const int8_t*>(&vr[u]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[j * DP + c + e] = static_cast<float>(ke[e]) * sk[u];
        vs[j * D + c + e] = static_cast<float>(ve[e]) * sv[u];
      }
    }
  }
}

// K/V loaders: stage<D>(ks, vs, b, off, row, L, t0, hi) fills one tile of
// slot b's rows, where `off` is the element offset of the block's first K
// (and V) element and `row` the elements from one token's row to the next.
template <typename T>
struct PlainKV {
  const T* k;
  const T* v;
  template <int D>
  __device__ __forceinline__ void stage(float* ks, float* vs, int, size_t off,
                                        size_t row, int, int t0, int hi) const {
    stage_tile<T, D>(ks, vs, k + off, v + off, row, t0, hi);
  }
};

struct Int8KV {
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;  // (B, L)
  const float* v_scale;
  template <int D>
  __device__ __forceinline__ void stage(float* ks, float* vs, int b, size_t off,
                                        size_t row, int L, int t0, int hi) const {
    const size_t s = (size_t)b * L;
    stage_tile_int8<D>(ks, vs, k + off, v + off, k_scale + s, v_scale + s, row, t0, hi);
  }
};

template <typename T, int D, typename KV>
__global__ void decode_kernel(const T* __restrict__ q, const KV kv,
                              const int* __restrict__ kv_len,
                              const int* __restrict__ q_off, T* __restrict__ out,
                              int L, int H, int KH, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PER = D / 32;
  extern __shared__ float smem[];
  const int G = H / KH;
  float* ks = smem;                // kTile x DP
  float* vs = ks + kTile * DP;     // kTile x D
  float* qs = vs + kTile * D;      // G x D
  float* ps = qs + G * D;          // G x kTile

  const int b = blockIdx.x, kh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = kh * G + warp;

  const int qpos = q_off[b];
  const int hi = min(min(kv_len[b], qpos + 1), L);
  const int lo = window > 0 ? max(qpos - window + 1, 0) : 0;

  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    qs[i] = to_f(q[((size_t)b * H + kh * G) * D + i]);

  const size_t row = (size_t)KH * D;
  const size_t off = (size_t)b * L * row + (size_t)kh * D;

  float m = kNegInf, l = 0.f, acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    kv.template stage<D>(ks, vs, b, off, row, L, t0, hi);
    __syncthreads();

    const bool valid = t0 + lane < hi;  // t0 + lane >= lo by construction
    const float* qr = qs + warp * D;
    const float* kr = ks + lane * DP;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
    s = valid ? s * scale : kNegInf;

    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    ps[warp * kTile + lane] = p;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= alpha;
    for (int j = 0; j < kTile; ++j) {
      const float pj = ps[warp * kTile + j];
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] += pj * vs[j * D + lane + 32 * i];
    }
    m = m_new;
  }

  const float denom = fmaxf(l, 1e-30f);
  T* o = out + ((size_t)b * H + h) * D;
#pragma unroll
  for (int i = 0; i < PER; ++i) o[lane + 32 * i] = from_f<T>(acc[i] / denom);
}

template <typename T, int D, typename KV>
cudaError_t launch(const void* q, const KV& kv, const int* kv_len, const int* q_off,
                   void* out, int B, int L, int H, int KH, int window, float scale,
                   cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = (size_t)(kTile * (D + 1) + kTile * D + G * D + G * kTile) * sizeof(float);
  decode_kernel<T, D, KV><<<dim3(B, KH), 32 * G, smem, stream>>>(
      static_cast<const T*>(q), kv, kv_len, q_off, static_cast<T*>(out), L, H, KH,
      window, scale);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t launch_d(int D, const void* q, const KV& kv, const int* kv_len,
                     const int* q_off, void* out, int B, int L, int H, int KH,
                     int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, kv, kv_len, q_off, out, B, L, H, KH, window, scale, stream);
    case 64: return launch<T, 64>(q, kv, kv_len, q_off, out, B, L, H, KH, window, scale, stream);
    case 128: return launch<T, 128>(q, kv, kv_len, q_off, out, B, L, H, KH, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int L, int H, int KH) {
  return B <= 0 || L <= 0 || KH <= 0 || H % KH != 0 || H / KH > kMaxGroup;
}

}  // namespace

// q (B,1,H,D), k/v (B,L,KH,D), out (B,1,H,D), all contiguous, k and v
// 16-byte aligned; kv_len and
// q_off are int32 (B,) on the device.  dtype: 0 = float32, 1 = bfloat16.
// window <= 0 means no sliding window.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kv_len, const void* q_off, void* out,
                                   int B, int L, int H, int KH, int D, int dtype,
                                   int window, float scale, void* stream) {
  if (bad_shape(B, L, H, KH)) return (int)cudaErrorInvalidValue;
  const int* kl = static_cast<const int*>(kv_len);
  const int* qo = static_cast<const int*>(q_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_d<float>(D, q, PlainKV<float>{static_cast<const float*>(k),
                                               static_cast<const float*>(v)},
                          kl, qo, out, B, L, H, KH, window, scale, s);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(
        D, q, PlainKV<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(k),
                                     static_cast<const __nv_bfloat16*>(v)},
        kl, qo, out, B, L, H, KH, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// As flash_decode_launch, over an int8 cache: k/v (B,L,KH,D) int8 codes,
// k_scale/v_scale (B,L) fp32, contiguous; q and out in `dtype`.
extern "C" int flash_decode_int8_launch(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* kv_len, const void* q_off, void* out,
                                        int B, int L, int H, int KH, int D, int dtype,
                                        int window, float scale, void* stream) {
  if (bad_shape(B, L, H, KH)) return (int)cudaErrorInvalidValue;
  const Int8KV kv{static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
                  static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)};
  const int* kl = static_cast<const int*>(kv_len);
  const int* qo = static_cast<const int*>(q_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_d<float>(D, q, kv, kl, qo, out, B, L, H, KH, window, scale, s);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(D, q, kv, kl, qo, out, B, L, H, KH, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
