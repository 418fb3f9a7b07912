// Causal flash attention for Hopper (sm_90a): the engine's one-shot prefill
// over right-padded prompt buckets, GQA, static query offset, optional
// sliding window.
//
// Replaces: src/repro/kernels/flash_attention.py::_attn_kernel (entry
// flash_attention), the Pallas TPU kernel of the served path's prefill.
//
// Bound on the card: at the served shapes (S <= 512, D = 128, bf16) the
// bytes (q, k, v read once, out written once) and the causal flops set
// bounds of the same few microseconds; the bytes are slightly larger.  This
// first kernel does its products on the CUDA cores in fp32, so in practice
// it is bound by its own arithmetic and shared-memory reads, far from either
// bound: moving the two products onto the tensor cores (mma / wgmma) is the
// planned next step.
//
// Design:
//  * one block per (q tile of 16 rows, head, batch row); four warps, each
//    owning four query rows, share every K/V tile staged in shared memory;
//  * the block loops over tiles of 32 keys, staged in shared memory as fp32
//    with 16-byte loads, several in flight per thread; it skips the tiles
//    above the causal diagonal (and, with a window, those wholly before it),
//    and masks the ragged edges itself, so S need not be a multiple of any
//    tile (the Pallas kernel asserted S % block == 0);
//  * online softmax in fp32 per row (m, l, acc in registers); masked scores
//    are -1e30 and masked probabilities exactly 0, as in the reference, and
//    a row with no visible key gives 0 (denominator clamped at 1e-30);
//  * the output is stored in the input dtype.

#include "common.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 4;
constexpr int kRows = 4;    // query rows per warp
constexpr int kBlockQ = kWarps * kRows;

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ out, int Sq, int Skv, int H, int KH, int q_offset,
            int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PER = D / 32;
  __shared__ float qs[kBlockQ * D];
  __shared__ float ks[kTile * DP];
  __shared__ float vs[kTile * D];
  __shared__ float ps[kWarps * kTile];

  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = min(kBlockQ, Sq - q0);

  const size_t qrow = (size_t)H * D, krow = (size_t)KH * D;
  const T* qb = q + ((size_t)b * Sq + q0) * qrow + (size_t)h * D;
  const T* kb = k + (size_t)b * Skv * krow + (size_t)kh * D;
  const T* vb = v + (size_t)b * Skv * krow + (size_t)kh * D;

  for (int i = threadIdx.x; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    qs[i] = r < nq ? to_f(qb[r * qrow + d]) : 0.f;
  }

  // key range any row of this tile can see
  const int pos_first = q_offset + q0, pos_last = q_offset + q0 + nq - 1;
  const int hi = min(Skv, pos_last + 1);
  const int lo = window > 0 ? max(pos_first - window + 1, 0) : 0;

  float m[kRows], l[kRows], acc[kRows][PER];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[r][i] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    stage_tile<T, D>(ks, vs, kb, vb, krow, t0, hi);
    __syncthreads();

    const int t = t0 + lane;
    const float* kr = ks + lane * DP;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      const int pos = q_offset + q0 + row;
      const bool valid = row < nq && t < hi && t <= pos &&
                         (window <= 0 || t > pos - window);
      const float* qr = qs + row * D;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
      s = valid ? s * scale : kNegInf;

      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      __syncwarp();  // the previous row's reads of ps are done
      ps[warp * kTile + lane] = p;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[r][i] *= alpha;
      for (int j = 0; j < kTile; ++j) {
        const float pj = ps[warp * kTile + j];
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[r][i] += pj * vs[j * D + lane + 32 * i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = warp * kRows + r;
    if (row >= nq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* o = out + ((size_t)b * Sq + q0 + row) * qrow + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < PER; ++i) o[lane + 32 * i] = from_f<T>(acc[r][i] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Skv, int H, int KH, int q_offset, int window, float scale,
                   cudaStream_t stream) {
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  attn_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, KH, q_offset, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* out, int B,
                     int Sq, int Skv, int H, int KH, int q_offset, int window, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, KH, q_offset, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KH, q_offset, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KH, q_offset, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/out (B,Sq,H,D), k/v (B,Skv,KH,D), all contiguous, k and v 16-byte
// aligned.  dtype: 0 = float32,
// 1 = bfloat16.  window <= 0 means no sliding window.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int Sq, int Skv, int H, int KH,
                                      int D, int dtype, int q_offset, int window,
                                      float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH != 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_d<float>(D, q, k, v, out, B, Sq, Skv, H, KH, q_offset, window, scale, s);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Skv, H, KH, q_offset, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
