// Flash-decode for Hopper (sm_90a): one query token per slot attending over
// the slot KV cache, with per-slot valid lengths and query positions.
//
// Replaces: src/repro/kernels/decode_attention.py::_decode_kernel (entry
// flash_decode), the Pallas TPU kernel on every decode step of the served
// path.
//
// Bound on the card: bytes.  A step reads kv_len rows of K and V for each
// slot and does 4*D flops per (query head, key): at GQA 6 in bf16 that is
// about 6 flops per byte, far under the ~295 flops per byte at which the
// H100's tensor cores, and not its memory, would set the limit.
//
// Design:
//  * one block per (slot, kv head); its G = H/KH warps each own one query
//    head of the group, so every K/V tile is read from device memory once for
//    the whole group (the TPU grid re-read it for each query head);
//  * the block reads its own kv_len / q_offset from device vectors (the GPU
//    has no scalar prefetch), so one launch serves slots at any depth;
//  * it walks only the rows in [lo, hi) that the mask keeps
//    (k_pos < kv_len, k_pos <= q_pos, k_pos > q_pos - window): a masked row
//    adds exactly 0 to the online softmax, so skipping it computes the same
//    function and stops at kv_len instead of the buffer length L;
//  * tiles of 32 keys are staged in shared memory as fp32 (row stride D+1, so
//    lane j reads key j without bank conflicts) with 16-byte loads, several in
//    flight per thread; lane j scores key j, and each lane accumulates D/32
//    output dims in fp32 registers;
//  * a fully masked row gives 0: the denominator is clamped at 1e-30.
// Known limit: the grid has only B*KH blocks (8 at the served shape) for the
// card's 132 SMs.  Splitting the KV axis across blocks, with a combine pass,
// is the next step.

#include "common.cuh"

namespace {

using namespace attn;

constexpr int kMaxGroup = 16;

template <typename T, int D>
__global__ void decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ kv_len,
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
  const T* kb = k + (size_t)b * L * row + (size_t)kh * D;
  const T* vb = v + (size_t)b * L * row + (size_t)kh * D;

  float m = kNegInf, l = 0.f, acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    stage_tile<T, D>(ks, vs, kb, vb, row, t0, hi);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len,
                   const int* q_off, void* out, int B, int L, int H, int KH,
                   int window, float scale, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = (size_t)(kTile * (D + 1) + kTile * D + G * D + G * kTile) * sizeof(float);
  decode_kernel<T, D><<<dim3(B, KH), 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      kv_len, q_off, static_cast<T*>(out), L, H, KH, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* kv_len,
                     const int* q_off, void* out, int B, int L, int H, int KH,
                     int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, kv_len, q_off, out, B, L, H, KH, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, kv_len, q_off, out, B, L, H, KH, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, kv_len, q_off, out, B, L, H, KH, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
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
  if (B <= 0 || L <= 0 || KH <= 0 || H % KH != 0 || H / KH > kMaxGroup)
    return (int)cudaErrorInvalidValue;
  const int* kl = static_cast<const int*>(kv_len);
  const int* qo = static_cast<const int*>(q_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_d<float>(D, q, k, v, kl, qo, out, B, L, H, KH, window, scale, s);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(D, q, k, v, kl, qo, out, B, L, H, KH, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
