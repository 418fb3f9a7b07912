// Chunked SSD scan (Mamba2, arXiv:2405.21060) for Hopper (sm_90a): the
// one-shot prefill of the SSM family.
//
// Replaces: src/repro/kernels/ssm_scan.py::_ssd_kernel (entry ssd_scan), the
// Pallas TPU kernel that ssm.py::ssm_forward runs with attn_impl="pallas".
//
// What it computes, per (batch b, head h), chunk after chunk, with the
// (P, N) state h carried in fp32 from zero:
//   a_cum = running sum of a over the chunk
//   y     = (C B^T o L) x + exp(a_cum) C h_in^T,  L[t,s] = exp(a_cum[t] - a_cum[s]), s <= t
//   h_out = exp(a_cum[-1]) h_in + (x o exp(a_cum[-1] - a_cum))^T B
// y and the final state are stored in x's dtype.  a_cum is summed in fp64
// and rounded to fp32, as the plain version (kernels/ref.py) does, so the
// two agree whatever the order of the sum.
//
// Bound on the card: at the served widths (H = 24, P = 64, N = 128, bf16)
// the bytes (x, a, B, C read once, y and the final state written once:
// 9.9 MB at B = 1, S = 512) take 2.9 us at 3.35 TB/s, and the causal
// products (per head and chunk ~c^2 (N + P) + 4 c P N flops, 1.0 GFLOP)
// 1.0 us on bf16 tensor cores: bytes bound it.  This kernel is far from
// either: its products run on the CUDA cores in fp32 out of shared memory,
// and its grid of B * H * ceil(chunk / 64) blocks (96 at the served widths
// and chunk 256) does not fill the 132 SMs, each block walking the chunks
// in order.  A chunk-parallel two-pass design (each chunk's end state in
// parallel, then a short carry pass) and tensor-core products are the
// planned next steps.
//
// Design:
//  * one block of 256 threads (a 16 x 16 grid) per (head, batch row, 64-row
//    query tile of a chunk); it walks the chunks in order and keeps the
//    (P, N) state in shared memory (64 x 128 fp32 = 32 KB at the served
//    widths);
//  * the Pallas kernel held a whole chunk's (c, c) score matrix (256 KB of
//    fp32 at c = 256, more than a block's 227 KB); here each block takes
//    its 64 query rows of a chunk against the 64-row key tiles at or
//    before them: scores (C B^T o L) for the pair go to shared memory,
//    masked to s <= t, and are applied to the key tile's x rows;
//  * the carried-state term is added to the block's rows; then every block
//    of the (b, h) updates its own copy of the state over the whole chunk
//    (the work the query tiles cannot share without a pass between them),
//    and the first of them stores the final state;
//  * products are register-tiled (4 x 4 scores, 4 x P/16 outputs, P/16 x
//    N/16 state elements per thread) over fp32 tiles staged in shared
//    memory from 16-byte loads; the chunk length is a run-time int <= 256,
//    not a power of two in general (exact-length prefill makes chunk = S),
//    so the last query and key tiles of a chunk are ragged and masked here.

#include "common.cuh"

namespace {

using attn::from_f;
using attn::to_f;

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kTile = 64;      // query rows, and key rows, per tile
constexpr int kMaxChunk = 256;
constexpr int kMaxDevices = 64;  // devices whose attribute is tracked

// Stage rows [0, kTile) of a (rows, W) tile into dst (row stride ld) as
// fp32; src rows are `row` elements apart and 16-byte aligned; rows past
// `rows` are zero.
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          size_t row, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = W / VEC;
  constexpr int NV = kTile * VPR;
#pragma unroll 4
  for (int i = threadIdx.x; i < NV; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    const uint4 v = r < rows ? *reinterpret_cast<const uint4*>(src + (size_t)r * row + c)
                             : make_uint4(0, 0, 0, 0);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) dst[r * ld + c + k] = to_f(e[k]);
  }
}

template <int P, int N>
constexpr size_t smem_floats() {
  return (size_t)P * (N + 1) + 2 * (size_t)kTile * (N + 1) + (size_t)kTile * P +
         (size_t)kTile * (kTile + 1) + 2 * kMaxChunk;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, T* __restrict__ y, T* __restrict__ fs, int S, int H,
           int chunk, int n_chunks) {
  constexpr int NP = N + 1;      // padded row stride: state, B and C tiles
  constexpr int TP = kTile + 1;  // padded row stride: scores
  constexpr int JP = P / 16;     // head-dim columns per thread
  constexpr int KN = N / 16;     // state columns per thread (state update)
  extern __shared__ float smem[];
  float* hs = smem;               // (P, NP)        carried state
  float* cs = hs + P * NP;        // (kTile, NP)    C rows of the query tile
  float* bs = cs + kTile * NP;    // (kTile, NP)    B rows of the key tile
  float* xs = bs + kTile * NP;    // (kTile, P)     x rows of the key tile
  float* ss = xs + kTile * P;     // (kTile, TP)    masked scores
  float* acum = ss + kTile * TP;  // (kMaxChunk)    running sum of a
  float* dec = acum + kMaxChunk;  // (kMaxChunk)    exp(a_cum[-1] - a_cum)

  // this block's query tile of every chunk: rows [q0, q0 + nq)
  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * kTile;
  const int nq = min(kTile, chunk - q0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t xrow = (size_t)H * P, nrow = (size_t)H * N;
  const T* xb = x + (size_t)b * S * xrow + (size_t)h * P;
  const T* bb = bm + (size_t)b * S * nrow + (size_t)h * N;
  const T* cb = cm + (size_t)b * S * nrow + (size_t)h * N;
  const float* ab = a + (size_t)b * S * H + h;
  T* yb = y + (size_t)b * S * xrow + (size_t)h * P;

  for (int i = tid; i < P * NP; i += kThreads) hs[i] = 0.f;

  for (int z = 0; z < n_chunks; ++z) {
    const int c0 = z * chunk;
    __syncthreads();  // the previous chunk is done with every buffer; hs is written
    if (warp == 0) {  // inclusive running sum of a, in fp64
      double carry = 0.0;
      for (int base = 0; base < chunk; base += 32) {
        const int t = base + lane;
        double v = t < chunk ? (double)ab[(size_t)(c0 + t) * H] : 0.0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (t < chunk) acum[t] = (float)v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    load_rows<T, N>(cs, NP, cb + (size_t)(c0 + q0) * nrow, nrow, nq);
    __syncthreads();
    const float last = acum[chunk - 1];
    for (int t = tid; t < chunk; t += kThreads) dec[t] = expf(last - acum[t]);
    // dec is first read in the state update, after further barriers

    // carried state: acc[t][p] = exp(a_cum[t]) * C[t] . h_in[p], for
    // t = ty + 16 i and p = tx + 16 j
    float acc[4][JP];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JP; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[4], hv[JP];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * NP + n];
#pragma unroll
      for (int j = 0; j < JP; ++j) hv[j] = hs[(tx + 16 * j) * NP + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JP; ++j) acc[i][j] += cv[i] * hv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const float e = row < nq ? expf(acum[q0 + row]) : 0.f;
#pragma unroll
      for (int j = 0; j < JP; ++j) acc[i][j] *= e;
    }

    // intra-chunk: the key tiles at or before the query tile
    for (int k0 = 0; k0 <= q0; k0 += kTile) {
      const int nk = min(kTile, chunk - k0);
      __syncthreads();  // the previous key tile is done with bs, xs, ss
      load_rows<T, N>(bs, NP, bb + (size_t)(c0 + k0) * nrow, nrow, nk);
      load_rows<T, P>(xs, P, xb + (size_t)(c0 + k0) * xrow, xrow, nk);
      __syncthreads();
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = k0 + tx + 16 * j;
          const bool keep = t < chunk && s <= t;
          ss[(ty + 16 * i) * TP + tx + 16 * j] =
              keep ? sc[i][j] * expf(acum[t] - acum[s]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < kTile; ++s) {
        float xv[JP];
#pragma unroll
        for (int j = 0; j < JP; ++j) xv[j] = xs[s * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sv = ss[(ty + 16 * i) * TP + s];
#pragma unroll
          for (int j = 0; j < JP; ++j) acc[i][j] += sv * xv[j];
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      if (row >= nq) continue;
      T* yr = yb + (size_t)(c0 + q0 + row) * xrow;
#pragma unroll
      for (int j = 0; j < JP; ++j) yr[tx + 16 * j] = from_f<T>(acc[i][j]);
    }

    // state update, over the whole chunk in every block of this (b, h):
    // h_out[p][n] = exp(a_cum[-1]) h_in[p][n] + sum_s (x[s][p] dec[s]) B[s][n],
    // for p = ty + 16 j and n = tx + 16 k
    float hn[JP][KN];
#pragma unroll
    for (int j = 0; j < JP; ++j)
#pragma unroll
      for (int k = 0; k < KN; ++k) hn[j][k] = 0.f;
    for (int k0 = 0; k0 < chunk; k0 += kTile) {
      const int nk = min(kTile, chunk - k0);
      __syncthreads();  // every thread is done with bs and xs (and with hs)
      load_rows<T, N>(bs, NP, bb + (size_t)(c0 + k0) * nrow, nrow, nk);
      load_rows<T, P>(xs, P, xb + (size_t)(c0 + k0) * xrow, xrow, nk);
      __syncthreads();
#pragma unroll 2
      for (int s = 0; s < nk; ++s) {
        const float ds = dec[k0 + s];
        float xv[JP], bv[KN];
#pragma unroll
        for (int j = 0; j < JP; ++j) xv[j] = xs[s * P + ty + 16 * j] * ds;
#pragma unroll
        for (int k = 0; k < KN; ++k) bv[k] = bs[s * NP + tx + 16 * k];
#pragma unroll
        for (int j = 0; j < JP; ++j)
#pragma unroll
          for (int k = 0; k < KN; ++k) hn[j][k] += xv[j] * bv[k];
      }
    }
    const float el = expf(last);
#pragma unroll
    for (int j = 0; j < JP; ++j)  // each thread owns these elements of hs
#pragma unroll
      for (int k = 0; k < KN; ++k) {
        float* hp = hs + (ty + 16 * j) * NP + tx + 16 * k;
        *hp = *hp * el + hn[j][k];
      }
  }
  if (blockIdx.z != 0) return;
  __syncthreads();
  T* fb = fs + ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) fb[i] = from_f<T>(hs[(i / N) * NP + i % N]);
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const void* a, const void* bm, const void* cm, void* y,
                   void* fs, int B, int S, int H, int chunk, cudaStream_t stream) {
  const size_t smem = smem_floats<P, N>() * sizeof(float);
  // the attribute is set per device: once per instantiation and device,
  // before any capture
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(ssd_kernel<T, P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid(H, B, (chunk + kTile - 1) / kTile);
  ssd_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), static_cast<T*>(fs), S, H, chunk,
      S / chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pn(int P, int N, const void* x, const void* a, const void* bm,
                      const void* cm, void* y, void* fs, int B, int S, int H, int chunk,
                      cudaStream_t s) {
  if (P == 32 && N == 16) return launch<T, 32, 16>(x, a, bm, cm, y, fs, B, S, H, chunk, s);
  if (P == 32 && N == 128) return launch<T, 32, 128>(x, a, bm, cm, y, fs, B, S, H, chunk, s);
  if (P == 64 && N == 16) return launch<T, 64, 16>(x, a, bm, cm, y, fs, B, S, H, chunk, s);
  if (P == 64 && N == 128) return launch<T, 64, 128>(x, a, bm, cm, y, fs, B, S, H, chunk, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x/y (B,S,H,P), bm/cm (B,S,H,N) in the same dtype (0 = float32,
// 1 = bfloat16), a (B,S,H) float32, fs (B,H,P,N); all contiguous, x, bm,
// cm 16-byte aligned.  S % chunk == 0, 1 <= chunk <= 256, P in {32, 64},
// N in {16, 128}.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* bm, const void* cm,
                               void* y, void* fs, int B, int S, int H, int P, int N,
                               int chunk, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || chunk <= 0 || chunk > kMaxChunk ||
      S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_pn<float>(P, N, x, a, bm, cm, y, fs, B, S, H, chunk, s);
  else if (dtype == 1)
    err = launch_pn<__nv_bfloat16>(P, N, x, a, bm, cm, y, fs, B, S, H, chunk, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
