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
// Bound on the card: x, a, B, C read once, y and the final state written
// once (at H = 24, P = 64, N = 128, bf16: 9.9 MB at B = 1, S = 512, 2.9 us
// at 3.35 TB/s; 0.61 GB at S = 32768, 0.18 ms).  The causal products (per
// head and chunk ~c^2 (N + P) + 4 c P N flops) take a third of that on
// the bf16 tensor cores: bytes bound it.
//
// Two bodies, chosen by dtype:
//  * bf16: three chunk-parallel passes on the tensor cores, the SSD
//    algorithm's own split (arXiv:2405.21060 s6; chunk state, state
//    passing, chunk scan);
//  * fp32: ssd_kernel, one pass on the CUDA cores in fp32 (products out of
//    shared memory, a grid of B * H * ceil(chunk / 64) blocks each walking
//    the chunks in order).  A tensor-core product would round fp32
//    operands, and the fp32 kernel path must give the plain path's greedy
//    tokens in chip_smoke.py phase 5, so fp32 keeps this body.
//
// The bf16 passes (4 warps a block; products by mma.sync m16n8k16, bf16
// operands, fp32 accumulators; tiles staged by cp.async with rows padded
// by 16 bytes, so the eight rows an ldmatrix phase reads fall in distinct
// banks; rows past the chunk zero-filled before any product):
//  1. chunk_state_kernel, one block per (b, h, chunk, slice of at most 64
//     state columns): a_cum by an fp64 warp scan (chunk_acum), then the
//     chunk's end state from zero, s_z = (x o decay)^T B, through a
//     two-stage ring of 64-row groups, into an fp32 workspace (B, nc, H,
//     P, N), and exp(a_cum[-1]) beside it (B, nc, H).  With one chunk s_z
//     is the final state and is stored as such, and no workspace is used;
//  2. carry_kernel (only when nc > 1), one thread per 4 state elements,
//     in order over the chunks: h_z = exp(a_cum_{z-1}[-1]) h_{z-1} +
//     s_{z-1} from h_0 = 0, written in place over s_z, loads a few chunks
//     ahead; the last h is the final state;
//  3. output_kernel, one block per (b, h, chunk, 64-row query tile), the
//     query tiles of a chunk on neighbouring blocks (they share its B and
//     x rows and h_in in L2), the last tile first: exp(a_cum) C h_in^T
//     (skipped at z = 0, where h_in = 0) as h_in C^T, h_in's fragments
//     straight from the workspace, each warp 16 state rows, exchanged
//     through shared memory into each warp's own 16 query rows; then over
//     the 64-key tiles at or before the query tile (a two-stage cp.async
//     ring), scores C B^T from C fragments kept in registers, times L,
//     then P x; on the query tile's own keys P is masked to s < t before
//     the exponential (a_cum[t] - a_cum[s] > 0 past the diagonal) and a
//     warp skips the 16-key blocks past its rows; last, the diagonal term
//     (C_t . B_t) x_t in fp32 on the CUDA cores (below).
// Passes 1 and 3 take a_cum from the same scan code (bit for bit the same
// sums); only pass 1 exponentiates a_cum[-1].
//
// Precision.  Products of bf16 inputs (C B^T, and B, C or x as the second
// operand) are exact in fp32.  Three operands are fp32: x o decay (pass
// 1), h_in and the masked scores P (pass 3).  Each is split into three
// bf16 parts, hi + mid + lo, which carry all of its 24 mantissa bits, and
// the three are multiplied in turn into one fp32 accumulator: every
// product is exact, and only the order of the sums differs from the plain
// version.  (chip_smoke.py --planted-fault ssd_operands_in_bf16 keeps the
// hi parts alone.)  Where the decay is fast, y[t] is nearly its diagonal
// term (C_t . B_t) x_t, and a sum of C_t . B_t in another order than the
// plain version's flips the bf16 rounding of y in more elements, which 24
// layers carry to the model's logits (chip_smoke.py phase 5).  So that
// term is summed in fp32 on the CUDA cores in order over n, as the plain
// version's fp32 product sums it, and added last with one fused
// multiply-add: it keeps the logit gap of phase 5 at 0, well inside its
// limit.
//
// Instances: (P, N) = (32, 16), (32, 128), (64, 16), (64, 64) (zamba2-7b,
// 112 heads) and (64, 128).  Every loop over P or N steps in units of 16
// and a chunk-state block takes at most 64 state columns, so (64, 64) is
// one slice of (64, 128)'s pass 1 (4 x 4 m16n8 tile pairs over the block's
// 4 warps), the same 4 x 8 C h_in^T split in pass 3 (static_assert in
// output_kernel), rows of N + 8 = 72 bf16 (144 bytes: an ldmatrix phase's
// 8 rows at 16-byte offsets 0, 16, ..., 112 mod 128, conflict-free), and
// 46 KB of shared memory in pass 3 (92 KB at N = 128); the fp32 body's
// 16 x 16 thread grid covers P and N in 4 columns each.
//
// What sets the time (H100, B = 1, S = 32768: ~0.94 ms against the 0.18
// ms bound): the output pass, two thirds of it, at 3 blocks an SM (168
// registers a thread), held back (as variants of it suggest; no profiler
// of the SM runs there) by one exponential per score, the three-part
// products and each warp re-reading the whole key tile from shared
// memory; the state pass a quarter; the carry pass, near the card's
// memory rate, a tenth.  At the served S = 512 (~0.037 ms), the
// three launches and the serial key tiles of the last query tile.

#include <cstdint>

#include "common.cuh"

namespace {

using attn::from_f;
using attn::to_f;

// ------------------------------------------------------------------------
// fp32: the CUDA-core body

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


// ------------------------------------------------------------------------
// bf16: the tensor-core passes

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::ldmatrix_x4;
using attn::ldmatrix_x4_trans;
using attn::mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;  // a block of the chunk-state and output passes
constexpr int kTcThreads = kWarps * 32;
constexpr int kCarryThreads = 256;
constexpr int kAhead = 8;  // chunks the carry pass loads ahead

// (x, y) as three bf16 pairs, x in the low half: hi = bf16(x, y), mid =
// bf16((x, y) - hi), lo = bf16((x, y) - hi - mid).  Each difference is
// exact, and the three parts carry all 24 mantissa bits of an fp32 value,
// so hi + mid + lo is (x, y) and each part's product with a bf16 value is
// exact in fp32.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A bf16 pair (low half first) times (d0, d1) in fp32, split as above.
__device__ __forceinline__ void scale_split(uint32_t v, float d0, float d1, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split_bf16(f.x * d0, f.y * d1, hi, mid, lo);
}

// Copy rows [0, n) of a tile of `rows` rows of W bf16 (`pitch` elements
// apart in global memory) into shared memory with row stride W + 8,
// zero-filling rows [n, rows); every thread of the block takes part.
template <int W>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, size_t pitch, int n,
                                          int rows) {
  constexpr int kChunks = W / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = r < n;
    cp_async16(dst + r * (W + 8) + c, src + (in ? (size_t)r * pitch + c : 0), in);
  }
}

// Inclusive running sum of a chunk's a over rows [0, len), in fp64 and
// rounded to fp32, into acum[0, len), and 0 into acum[len, to) (to <=
// kMaxChunk); ab is the chunk's first a, rows H apart.  One warp runs it:
// lane l sums rows [8l, 8l + 8) in order, a warp scan adds the lanes
// before it.  Every pass runs this code, so they agree bit for bit.
__device__ __forceinline__ void chunk_acum(float* acum, const float* ab, int H, int len,
                                           int to, int lane) {
  constexpr int kPer = kMaxChunk / 32;  // rows a lane sums
  double v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int t = kPer * lane + k;
    v[k] = t < len ? (double)ab[(size_t)t * H] : 0.0;
  }
#pragma unroll
  for (int k = 1; k < kPer; ++k) v[k] += v[k - 1];
  double incl = v[kPer - 1];  // rows [0, 8l + 8), after the scan
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  double before = __shfl_up_sync(0xffffffffu, incl, 1);  // rows [0, 8l)
  if (lane == 0) before = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int t = kPer * lane + k;
    if (t < to) acum[t] = t < len ? (float)(before + v[k]) : 0.f;
  }
}

// State columns a chunk-state block computes: N in slices of at most 64.
template <int N>
__host__ __device__ constexpr int state_cols() {
  return N < 64 ? N : 64;
}

template <int P, int N>
constexpr size_t state_smem_bytes() {
  return 2 * (size_t)kTile * ((P + 8) + (state_cols<N>() + 8)) * sizeof(bf16) +
         2 * (size_t)kMaxChunk * sizeof(float);
}

// Pass 1: block (b, h, z, ns) computes columns [ns NN, ns NN + NN) of
// chunk z's end state from zero, s_z = (x o decay)^T B, P x NN in fp32:
// into ws, or into fs in bf16 when nc = 1.  Warps split the (m16 row tile,
// pair of n8 column tiles) items; a warp's items share its row tile.
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads)
chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                   const bf16* __restrict__ bm, float* __restrict__ ws,
                   float* __restrict__ wdec, bf16* __restrict__ fs, int H, int chunk, int nc) {
  constexpr int NN = state_cols<N>(), NS = N / NN;
  constexpr int XS = P + 8, BS = NN + 8;  // shared-memory row strides, elements
  constexpr int MT = P / 16, NP = NN / 16;
  constexpr int ITEMS = MT * NP, IPW = (ITEMS + kWarps - 1) / kWarps;
  static_assert(kWarps % MT == 0, "a warp's items share one row tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage st of a ring of kTile-row groups: x rows at xst(st), then the
  // slice's B rows
  bf16* const ring = reinterpret_cast<bf16*>(smem_raw);
  auto xst = [ring](int st) { return ring + (size_t)st * kTile * (XS + BS); };
  float* const acum = reinterpret_cast<float*>(ring + 2 * kTile * (XS + BS));
  float* const dec = acum + kMaxChunk;  // exp(a_cum[-1] - a_cum), 0 past the chunk

  const int ns = blockIdx.x % NS, bhz = blockIdx.x / NS;
  const int h = bhz % H, z = (bhz / H) % nc, b = bhz / (H * nc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // the m16n8 C layout: rows g, g + 8; cols 2tq
  const int kc = (chunk + 15) & ~15;       // the chunk in steps of the mma depth
  const size_t r0 = ((size_t)b * nc + z) * chunk;  // the chunk's first row
  const size_t xrow = (size_t)H * P, nrow = (size_t)H * N;

  // x and the slice's B rows in groups of kTile rows through a two-stage
  // ring, the next group in flight while this one is multiplied
  const bf16* xb = x + r0 * xrow + (size_t)h * P;
  const bf16* bb = bm + r0 * nrow + (size_t)h * N + ns * NN;
  auto copy_group = [&](int k0) {
    bf16* st = xst((k0 / kTile) & 1);
    const int rows = min(kTile, kc - k0);
    copy_rows<P>(st, xb + (size_t)k0 * xrow, xrow, chunk - k0, rows);
    copy_rows<NN>(st + kTile * XS, bb + (size_t)k0 * nrow, nrow, chunk - k0, rows);
    cp_async_commit();
  };
  copy_group(0);
  if (warp == 0) chunk_acum(acum, a + r0 * H + h, H, chunk, kc, lane);
  __syncthreads();
  const float last = acum[chunk - 1];
  for (int t = threadIdx.x; t < kc; t += kTcThreads)
    dec[t] = t < chunk ? expf(last - acum[t]) : 0.f;
  if (threadIdx.x == 0 && ns == 0 && nc > 1) wdec[((size_t)b * nc + z) * H + h] = expf(last);

  float acc[IPW][2][4];
#pragma unroll
  for (int k = 0; k < IPW; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[k][e][i] = 0.f;
  const int mt = warp % MT;
  // A = (x o decay)^T, rows p: x is stored (s, p), so transposed 8 x 8
  // loads of rows s [0, 8) and [8, 16), columns p [0, 8) and [8, 16) give
  // its A-fragments.  B is stored (s, n): transposed loads of rows s [0,
  // 16), columns n [0, 8) and [8, 16) give the B-fragments of two n-tiles.
  const int xa = ((lane & 7) + 8 * (lane >> 4)) * XS + 16 * mt + 8 * ((lane >> 3) & 1);
  const int ba = (lane & 15) * BS + 8 * (lane >> 4);
  for (int k0 = 0; k0 < kc; k0 += 16) {
    if (k0 % kTile == 0) {
      cp_async_wait<0>();
      __syncthreads();  // group k0 / kTile has landed, the one before is consumed
                        // (and dec is written)
      if (k0 + kTile < kc) copy_group(k0 + kTile);
    }
    const bf16* sx = xst((k0 / kTile) & 1) + (k0 % kTile) * XS;  // x rows from k0
    const bf16* sb = xst((k0 / kTile) & 1) + kTile * XS + (k0 % kTile) * BS;  // B rows
    uint32_t ax[4], a_hi[4], a_mid[4], a_lo[4];
    ldmatrix_x4_trans(ax, sx + xa);
    // registers 0, 1 hold rows s = k0 + 2tq, + 1; registers 2, 3 those + 8
    const float d0 = dec[k0 + 2 * tq], d1 = dec[k0 + 2 * tq + 1];
    const float d8 = dec[k0 + 2 * tq + 8], d9 = dec[k0 + 2 * tq + 9];
    scale_split(ax[0], d0, d1, a_hi[0], a_mid[0], a_lo[0]);
    scale_split(ax[1], d0, d1, a_hi[1], a_mid[1], a_lo[1]);
    scale_split(ax[2], d8, d9, a_hi[2], a_mid[2], a_lo[2]);
    scale_split(ax[3], d8, d9, a_hi[3], a_mid[3], a_lo[3]);
#pragma unroll
    for (int k = 0; k < IPW; ++k) {
      const int item = warp + kWarps * k;
      if (item >= ITEMS) break;
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, sb + ba + 16 * (item / MT));
      mma_bf16(acc[k][0], a_hi, bf[0], bf[1]);
      mma_bf16(acc[k][1], a_hi, bf[2], bf[3]);
      mma_bf16(acc[k][0], a_mid, bf[0], bf[1]);
      mma_bf16(acc[k][1], a_mid, bf[2], bf[3]);
      mma_bf16(acc[k][0], a_lo, bf[0], bf[1]);
      mma_bf16(acc[k][1], a_lo, bf[2], bf[3]);
    }
  }

  const size_t state = (nc > 1 ? ((size_t)b * nc + z) * H : (size_t)b * H) + h;
#pragma unroll
  for (int k = 0; k < IPW; ++k) {
    const int item = warp + kWarps * k;
    if (item >= ITEMS) break;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * mt + g + 8 * r;
        const int n = ns * NN + 16 * (item / MT) + 8 * e + 2 * tq;
        const size_t at = (state * P + p) * N + n;
        if (nc > 1)
          *reinterpret_cast<float2*>(ws + at) = make_float2(acc[k][e][2 * r], acc[k][e][2 * r + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(fs + at) =
              __floats2bfloat162_rn(acc[k][e][2 * r], acc[k][e][2 * r + 1]);
      }
  }
}

// Pass 2 (nc > 1): thread i carries 4 elements of one (b, h) state through
// the chunks, in place: ws holds s_z on entry and h_z (the state chunk z
// starts from) on exit; the final state goes to fs.  Loads run kAhead
// chunks ahead of the dependent multiply-adds.
__global__ void __launch_bounds__(kCarryThreads)
carry_kernel(float* __restrict__ ws, const float* __restrict__ wdec, bf16* __restrict__ fs,
             int B, int H, int PN, int nc) {
  const int per = PN / 4;  // float4s a state
  const int i = blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= B * H * per) return;
  const int v = i % per, bh = i / per, h = bh % H, b = bh / H;
  float4* w = reinterpret_cast<float4*>(ws) + ((size_t)b * nc * H + h) * per + v;
  const float* ew = wdec + (size_t)b * nc * H + h;
  const size_t step = (size_t)H * per;  // float4s from one chunk's state to the next
  float4 sr[kAhead];
  float er[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (u < nc) {
      sr[u] = w[u * step];
      er[u] = ew[(size_t)u * H];
    }
  float hc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int z0 = 0; z0 < nc; z0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int z = z0 + u;
      if (z >= nc) break;
      const float sv[4] = {sr[u].x, sr[u].y, sr[u].z, sr[u].w};
      const float ez = er[u];
      if (z + kAhead < nc) {
        sr[u] = w[(z + kAhead) * step];
        er[u] = ew[(size_t)(z + kAhead) * H];
      }
      w[z * step] = make_float4(hc[0], hc[1], hc[2], hc[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) hc[j] = hc[j] * ez + sv[j];
    }
  }
  __nv_bfloat162* f = reinterpret_cast<__nv_bfloat162*>(fs + (size_t)bh * PN + 4 * v);
  f[0] = __floats2bfloat162_rn(hc[0], hc[1]);
  f[1] = __floats2bfloat162_rn(hc[2], hc[3]);
}

// Bytes of one stage of the output pass's key ring (B rows, then x rows),
// and of the second stage, which first holds C h_in^T in fp32 (kTile rows
// of P + 4) for the warps to exchange.
template <int P, int N>
__host__ __device__ constexpr size_t ring_stage_bytes() {
  return (size_t)kTile * ((N + 8) + (P + 8)) * sizeof(bf16);
}
template <int P, int N>
__host__ __device__ constexpr size_t ring_stage1_bytes() {
  return ring_stage_bytes<P, N>() > (size_t)kTile * (P + 4) * sizeof(float)
             ? ring_stage_bytes<P, N>()
             : (size_t)kTile * (P + 4) * sizeof(float);
}
template <int P, int N>
constexpr size_t output_smem_bytes() {
  return (size_t)kTile * (N + 8) * sizeof(bf16) + ring_stage_bytes<P, N>() +
         ring_stage1_bytes<P, N>() + (size_t)kMaxChunk * sizeof(float);
}

// Pass 3: block (b, h, z, query tile) writes y for rows [q0, q0 + nq) of
// chunk z; warp w owns rows [q0 + 16w, q0 + 16w + 16).
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, 3)
output_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
              const bf16* __restrict__ bm, const bf16* __restrict__ cm,
              const float* __restrict__ ws, bf16* __restrict__ y, int H, int chunk, int nc) {
  constexpr int NS = N + 8, XS = P + 8, YS = P + 4;  // shared-memory row strides, elements
  // C h_in^T: warps split it by (m16 tile of state rows p, n8 tiles of
  // query rows t)
  constexpr int MTP = P / 16, WT = kWarps / MTP, TN = kTile / 8 / WT;
  static_assert(kWarps % MTP == 0 && TN % 2 == 0, "warps split C h_in^T evenly");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const cs = reinterpret_cast<bf16*>(smem_raw);  // (kTile, NS)  C rows of the query tile
  // stage st of the key ring: B rows at bst(st), x rows kTile * NS after them
  unsigned char* const ring = smem_raw + (size_t)kTile * NS * sizeof(bf16);
  auto bst = [ring](int st) {
    return reinterpret_cast<bf16*>(ring + (size_t)st * ring_stage_bytes<P, N>());
  };
  float* const ys = reinterpret_cast<float*>(bst(1));  // (kTile, YS)  C h_in^T, before the ring
  float* const acum =
      reinterpret_cast<float*>(ring + ring_stage_bytes<P, N>() + ring_stage1_bytes<P, N>());

  // blocks in order: the query tiles of one (b, h, chunk) side by side,
  // last first (the last sees the most keys), so that they find the
  // chunk's B and x rows and h_in in L2; then heads, chunks, batch rows
  const int n_qt = (chunk + kTile - 1) / kTile;
  const int bhz = blockIdx.x / n_qt;
  const int h = bhz % H, z = (bhz / H) % nc, b = bhz / (H * nc);
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int q0 = qt * kTile, nq = min(kTile, chunk - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t r0 = ((size_t)b * nc + z) * chunk;
  const size_t xrow = (size_t)H * P, nrow = (size_t)H * N;
  const bf16* xb = x + r0 * xrow + (size_t)h * P;
  const bf16* bb = bm + r0 * nrow + (size_t)h * N;

  copy_rows<N>(cs, cm + (r0 + q0) * nrow + (size_t)h * N, nrow, nq, kTile);
  copy_rows<N>(bst(0), bb, nrow, min(kTile, chunk), kTile);
  copy_rows<P>(bst(0) + kTile * NS, xb, xrow, min(kTile, chunk), kTile);
  cp_async_commit();
  const bool carried = z > 0;  // h_in = 0 in the first chunk
  // this warp's state rows p of h_in (fp32, P x N) as A-fragments, straight
  // from the workspace, issued before the scan: per k-step over n, rows
  // g and g + 8 of its m16 tile, columns 2tq, 2tq + 1 and 8 more
  const int pt = warp % MTP, tn0 = (warp / MTP) * TN;
  float2 hv[N / 16][4];
  if (carried) {
    const float* hw = ws + (((size_t)b * nc + z) * H + h) * P * N +
                      (size_t)(16 * pt + g) * N + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      hv[kk][0] = *reinterpret_cast<const float2*>(hw + 16 * kk);
      hv[kk][1] = *reinterpret_cast<const float2*>(hw + 8 * N + 16 * kk);
      hv[kk][2] = *reinterpret_cast<const float2*>(hw + 16 * kk + 8);
      hv[kk][3] = *reinterpret_cast<const float2*>(hw + 8 * N + 16 * kk + 8);
    }
  }
  if (warp == 0) chunk_acum(acum, a + r0 * H + h, H, q0 + nq, q0 + kTile, lane);
  cp_async_wait<0>();
  __syncthreads();

  // B-fragments from row-major (row, column) tiles: rows [0, 8) and [8,
  // 16) of two n-tiles, columns [0, 8) and [8, 16) of the k-step
  const int nrow8 = (lane & 7) + 8 * (lane >> 4), ncol8 = 8 * ((lane >> 3) & 1);
  // this lane's accumulator rows (chunk positions) and their a_cum
  const int t_a = q0 + 16 * warp + g, t_b = t_a + 8;
  const bool in_a = t_a < chunk, in_b = t_b < chunk;
  const float ac_a = acum[t_a], ac_b = acum[t_b];

  float o[P / 8][4];
#pragma unroll
  for (int c = 0; c < P / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  if (carried) {
    // (C h_in^T)^T = h_in C^T for this warp's state rows and TN n8 tiles
    // of query rows, h_in as hi + mid + lo, C's B-fragments from its rows
    float yo[TN][4];
#pragma unroll
    for (int n = 0; n < TN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yo[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t h_hi[4], h_mid[4], h_lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(hv[kk][r].x, hv[kk][r].y, h_hi[r], h_mid[r], h_lo[r]);
#pragma unroll
      for (int n = 0; n < TN; n += 2) {
        uint32_t cb[4];
        ldmatrix_x4(cb, cs + (8 * (tn0 + n) + nrow8) * NS + 16 * kk + ncol8);
        mma_bf16(yo[n], h_hi, cb[0], cb[1]);
        mma_bf16(yo[n + 1], h_hi, cb[2], cb[3]);
        mma_bf16(yo[n], h_mid, cb[0], cb[1]);
        mma_bf16(yo[n + 1], h_mid, cb[2], cb[3]);
        mma_bf16(yo[n], h_lo, cb[0], cb[1]);
        mma_bf16(yo[n + 1], h_lo, cb[2], cb[3]);
      }
    }
    // through shared memory (row stride P + 4: no bank conflicts) into
    // each warp's own query rows, times exp(a_cum[t])
#pragma unroll
    for (int n = 0; n < TN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ys[(8 * (tn0 + n) + 2 * tq + (e & 1)) * YS + 16 * pt + g + 8 * (e >> 1)] = yo[n][e];
    __syncthreads();
    const float e_a = in_a ? expf(ac_a) : 0.f, e_b = in_b ? expf(ac_b) : 0.f;
    const float* yr = ys + (16 * warp + g) * YS + 2 * tq;
#pragma unroll
    for (int c = 0; c < P / 8; ++c) {
      const float2 va = *reinterpret_cast<const float2*>(yr + 8 * c);
      const float2 vb = *reinterpret_cast<const float2*>(yr + 8 * YS + 8 * c);
      o[c][0] = va.x * e_a;
      o[c][1] = va.y * e_a;
      o[c][2] = vb.x * e_b;
      o[c][3] = vb.y * e_b;
    }
  }
  // this warp's C rows as A-fragments, one per 16 state columns
  uint32_t cf[N / 16][4];
  const bf16* ca = cs + (16 * warp + (lane & 15)) * NS + 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) ldmatrix_x4(cf[kk], ca + 16 * kk);

  const int n_tiles = qt + 1;  // key tiles [0, q0 + kTile)
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile;
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; tile it - 1 (or C h_in^T) is consumed
    if (it + 1 < n_tiles) {
      const int k1 = k0 + kTile, n1 = min(kTile, chunk - k1);
      bf16* st = bst((it + 1) & 1);
      copy_rows<N>(st, bb + (size_t)k1 * nrow, nrow, n1, kTile);
      copy_rows<P>(st + kTile * NS, xb + (size_t)k1 * xrow, xrow, n1, kTile);
    }
    cp_async_commit();
    const bf16* bt = bst(it & 1);
    const bf16* xt = bt + kTile * NS;
    const bool diag = it == qt;  // on the query tile's own keys, 16-key
                                 // blocks past a warp's rows are all masked

    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
      for (int n = 0; n < kTile / 8; n += 2) {
        if (diag && n / 2 > warp) continue;
        uint32_t kf[4];
        ldmatrix_x4(kf, bt + (8 * n + nrow8) * NS + 16 * kk + ncol8);
        mma_bf16(s[n], cf[kk], kf[0], kf[1]);
        mma_bf16(s[n + 1], cf[kk], kf[2], kf[3]);
      }
    // P = scores o L.  Before the query tile every key precedes every row
    // (rows past the chunk are never stored, so they need no mask); on it,
    // P is zero where s >= t, the exponent masked first (a_cum[t] -
    // a_cum[s] > 0 past the diagonal), and n-tiles past the warp's rows
    // are left at zero.  The diagonal s = t is added after the loop.
    float ak[kTile / 8][2];  // a_cum of this lane's keys
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      const float2 v = *reinterpret_cast<const float2*>(acum + k0 + 8 * n + 2 * tq);
      ak[n][0] = v.x;
      ak[n][1] = v.y;
    }
    if (!diag) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= expf((e < 2 ? ac_a : ac_b) - ak[n][e & 1]);
    } else {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        if (n / 2 > warp) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sk = k0 + 8 * n + 2 * tq + (e & 1);
          const bool keep = sk < (e < 2 ? t_a : t_b);
          const float seg = keep ? (e < 2 ? ac_a : ac_b) - ak[n][e & 1] : 0.f;
          s[n][e] = keep ? s[n][e] * expf(seg) : 0.f;
        }
      }
    }
    // y += P x, P as hi + mid + lo; x is stored (s, p): transposed loads give
    // its B-fragments
    const bf16* xa = xt + (lane & 15) * XS + 8 * (lane >> 4);
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      if (diag && j > warp) continue;
      // the A-fragment of keys [16j, 16j + 16) is the C-fragments of
      // n-tiles 2j and 2j + 1
      uint32_t p_hi[4], p_mid[4], p_lo[4];
      split_bf16(s[2 * j][0], s[2 * j][1], p_hi[0], p_mid[0], p_lo[0]);
      split_bf16(s[2 * j][2], s[2 * j][3], p_hi[1], p_mid[1], p_lo[1]);
      split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], p_hi[2], p_mid[2], p_lo[2]);
      split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], p_hi[3], p_mid[3], p_lo[3]);
#pragma unroll
      for (int c = 0; c < P / 8; c += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, xa + 16 * j * XS + 8 * c);
        mma_bf16(o[c], p_hi, vf[0], vf[1]);
        mma_bf16(o[c + 1], p_hi, vf[2], vf[3]);
        mma_bf16(o[c], p_mid, vf[0], vf[1]);
        mma_bf16(o[c + 1], p_mid, vf[2], vf[3]);
        mma_bf16(o[c], p_lo, vf[0], vf[1]);
        mma_bf16(o[c + 1], p_lo, vf[2], vf[3]);
      }
    }
  }

  // the diagonal term (C_t . B_t) x_t, L = 1 there, in fp32 on the CUDA
  // cores, the dot product summed in order over n as the plain version's
  // fp32 product sums it: when the decay is fast this term is nearly all
  // of y, and so y rounds to bf16 as the plain version's does.  Lane l
  // sums row l % 16 of the warp's rows (the C row and the key row t of the
  // diagonal tile, still in its stage of the ring).
  {
    const bf16* bt = bst(qt & 1);
    const bf16* xt = bt + kTile * NS;
    const int row = 16 * warp + (lane & 15);
    float st = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; n += 8) {
      const uint4 cv = *reinterpret_cast<const uint4*>(cs + row * NS + n);
      const uint4 bv = *reinterpret_cast<const uint4*>(bt + row * NS + n);
      const bf16* ce = reinterpret_cast<const bf16*>(&cv);
      const bf16* be = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
      for (int k = 0; k < 8; ++k) st = fmaf(__bfloat162float(ce[k]), __bfloat162float(be[k]), st);
    }
    const float s_a = __shfl_sync(0xffffffffu, st, g);
    const float s_b = __shfl_sync(0xffffffffu, st, g + 8);
    const bf16* xa = xt + (16 * warp + g) * XS + 2 * tq;
#pragma unroll
    for (int c = 0; c < P / 8; ++c) {
      const float2 va = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xa + 8 * c));
      const float2 vb =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xa + 8 * XS + 8 * c));
      o[c][0] = fmaf(s_a, va.x, o[c][0]);
      o[c][1] = fmaf(s_a, va.y, o[c][1]);
      o[c][2] = fmaf(s_b, vb.x, o[c][2]);
      o[c][3] = fmaf(s_b, vb.y, o[c][3]);
    }
  }

  bf16* yb = y + (r0 + q0 + 16 * warp + g) * xrow + (size_t)h * P + 2 * tq;
#pragma unroll
  for (int c = 0; c < P / 8; ++c) {
    if (t_a < q0 + nq)
      *reinterpret_cast<__nv_bfloat162*>(yb + 8 * c) = __floats2bfloat162_rn(o[c][0], o[c][1]);
    if (t_b < q0 + nq)
      *reinterpret_cast<__nv_bfloat162*>(yb + 8 * xrow + 8 * c) =
          __floats2bfloat162_rn(o[c][2], o[c][3]);
  }
}

// ------------------------------------------------------------------------
// launches

// The body the last launch ran (0 the fp32 CUDA-core body, 1 the bf16
// tensor-core passes, -1 none) and how many kernels it launched
// (ssd_scan_last_body, ssd_scan_last_kernels).
int last_body = -1;
int last_kernels = 0;

template <typename K>
cudaError_t grant(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int P, int N>
cudaError_t grant_pn() {
  cudaError_t err = grant(ssd_kernel<float, P, N>, smem_floats<P, N>() * sizeof(float));
  if (err == cudaSuccess) err = grant(chunk_state_kernel<P, N>, state_smem_bytes<P, N>());
  if (err == cudaSuccess) err = grant(output_kernel<P, N>, output_smem_bytes<P, N>());
  return err;
}

// The shared memory above 48 KB of every kernel, granted once per device,
// at its first launch (before any CUDA-graph capture of it).
cudaError_t grant_all() {
  static bool granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (granted[dev]) return cudaSuccess;
  err = grant_pn<32, 16>();
  if (err == cudaSuccess) err = grant_pn<32, 128>();
  if (err == cudaSuccess) err = grant_pn<64, 16>();
  if (err == cudaSuccess) err = grant_pn<64, 64>();
  if (err == cudaSuccess) err = grant_pn<64, 128>();
  if (err == cudaSuccess) granted[dev] = true;
  return err;
}

template <int P, int N>
cudaError_t launch_fp32(const void* x, const void* a, const void* bm, const void* cm, void* y,
                        void* fs, int B, int S, int H, int chunk, cudaStream_t stream) {
  const dim3 grid(H, B, (chunk + kTile - 1) / kTile);
  ssd_kernel<float, P, N><<<grid, kThreads, smem_floats<P, N>() * sizeof(float), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(bm), static_cast<const float*>(cm), static_cast<float*>(y),
      static_cast<float*>(fs), S, H, chunk, S / chunk);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    last_body = 0;
    last_kernels = 1;
  }
  return err;
}

template <int P, int N>
cudaError_t launch_bf16(const void* x, const void* a, const void* bm, const void* cm, void* y,
                        void* fs, void* ws, int B, int S, int H, int chunk,
                        cudaStream_t stream) {
  const int nc = S / chunk;
  const long long bhz = (long long)B * H * nc;
  const long long state_blocks = bhz * (N / state_cols<N>());
  const long long out_blocks = bhz * ((chunk + kTile - 1) / kTile);
  const long long carry_threads = (long long)B * H * P * N / 4;
  if (out_blocks > 0x7fffffffLL || (nc > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  float* wsf = static_cast<float*>(ws);
  float* wdec = nc > 1 ? wsf + (size_t)bhz * P * N : nullptr;
  const bf16* xb = static_cast<const bf16*>(x);
  const float* af = static_cast<const float*>(a);
  const bf16* bb = static_cast<const bf16*>(bm);
  bf16* fb = static_cast<bf16*>(fs);
  chunk_state_kernel<P, N><<<(unsigned)state_blocks, kTcThreads, state_smem_bytes<P, N>(),
                             stream>>>(xb, af, bb, wsf, wdec, fb, H, chunk, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nc > 1) {
    carry_kernel<<<(unsigned)((carry_threads + kCarryThreads - 1) / kCarryThreads),
                   kCarryThreads, 0, stream>>>(wsf, wdec, fb, B, H, P * N, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  output_kernel<P, N><<<(unsigned)out_blocks, kTcThreads, output_smem_bytes<P, N>(), stream>>>(
      xb, af, bb, static_cast<const bf16*>(cm), wsf, static_cast<bf16*>(y), H, chunk, nc);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    last_body = 1;
    last_kernels = nc > 1 ? 3 : 2;
  }
  return err;
}

template <int P, int N>
cudaError_t launch(int dtype, const void* x, const void* a, const void* bm, const void* cm,
                   void* y, void* fs, void* ws, int B, int S, int H, int chunk,
                   cudaStream_t s) {
  if (dtype == 0) return launch_fp32<P, N>(x, a, bm, cm, y, fs, B, S, H, chunk, s);
  if (dtype == 1) return launch_bf16<P, N>(x, a, bm, cm, y, fs, ws, B, S, H, chunk, s);
  return cudaErrorInvalidValue;
}

cudaError_t launch_pn(int P, int N, int dtype, const void* x, const void* a, const void* bm,
                      const void* cm, void* y, void* fs, void* ws, int B, int S, int H,
                      int chunk, cudaStream_t s) {
  if (P == 32 && N == 16) return launch<32, 16>(dtype, x, a, bm, cm, y, fs, ws, B, S, H, chunk, s);
  if (P == 32 && N == 128)
    return launch<32, 128>(dtype, x, a, bm, cm, y, fs, ws, B, S, H, chunk, s);
  if (P == 64 && N == 16) return launch<64, 16>(dtype, x, a, bm, cm, y, fs, ws, B, S, H, chunk, s);
  if (P == 64 && N == 64) return launch<64, 64>(dtype, x, a, bm, cm, y, fs, ws, B, S, H, chunk, s);
  if (P == 64 && N == 128)
    return launch<64, 128>(dtype, x, a, bm, cm, y, fs, ws, B, S, H, chunk, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x/y (B,S,H,P), bm/cm (B,S,H,N) in the same dtype (0 = float32,
// 1 = bfloat16), a (B,S,H) float32, fs (B,H,P,N); all contiguous, x, bm,
// cm 16-byte aligned.  S % chunk == 0, 1 <= chunk <= 256, (P, N) one of
// (32, 16), (32, 128), (64, 16), (64, 64) and (64, 128).  ws: for bf16 with S / chunk > 1 chunks, an fp32
// workspace of B * nc * H * (P * N + 1) elements, 16-byte aligned (else
// unused, may be null).  Returns cudaGetLastError() after the launches (0
// = launched).
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* bm, const void* cm,
                               void* y, void* fs, void* ws, int B, int S, int H, int P, int N,
                               int chunk, int dtype, void* stream) {
  last_body = -1;
  last_kernels = 0;
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || chunk <= 0 || chunk > kMaxChunk ||
      S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = grant_all();
  if (err == cudaSuccess)
    err = launch_pn(P, N, dtype, x, a, bm, cm, y, fs, ws, B, S, H, chunk,
                    static_cast<cudaStream_t>(stream));
  return (int)err;
}

// Which body the last ssd_scan_launch of this process ran (see last_body),
// and how many kernels it launched, for checks on the card.
extern "C" int ssd_scan_last_body() { return last_body; }
extern "C" int ssd_scan_last_kernels() { return last_kernels; }
