// Causal flash attention for Hopper (sm_90a): the engine's one-shot prefill
// over right-padded prompt buckets, GQA, static query offset, optional
// sliding window.  A tensor-parallel rank whose query heads cut a GQA group
// is launched once per uniform segment of its heads, over strided views of
// its q, k, v and output (the entry's row strides HR and KHR).
//
// Replaces: src/repro/kernels/flash_attention.py::_attn_kernel (entry
// flash_attention), the Pallas TPU kernel of the served path's prefill and
// of the step functions' prefill (launch/steps.py).
//
// Bound on the card: at the served shapes (S <= 512, D = 128, bf16) the
// bytes (q, k, v read once, out written once: 4.4 us at B=4, S=512) lie
// above the causal flops (2.7 us at 989 TFLOP/s); at long prompts the flops
// grow as S^2 and set the bound (B=1, S=32768: 3.30e12 flops, 3.34 ms).
//
// Two bodies, chosen by dtype in launch():
//  * bf16: attn_tc_kernel, both products on the tensor cores
//    (mma.sync m16n8k16, bf16 operands, fp32 accumulators);
//  * fp32: attn_kernel, the products on the CUDA cores in fp32.  A
//    tensor-core product would round fp32 operands to TF32 (10 mantissa
//    bits), and the fp32 kernel path must give the plain path's greedy
//    tokens bit for bit in chip_smoke.py phase 5, so fp32 keeps this body.
//
// The bf16 body:
//  * one block of 4 warps per (query tile, query head, batch row); each
//    warp owns MT m16 row tiles (16 * MT query rows), so a block holds 64
//    (MT = 1) or 128 (MT = 2) rows.  Two row tiles a warp halve the
//    shared-memory reads per score (each K/V fragment feeds two mmas), and
//    on an H100 they were the faster at long prompts, but they leave half
//    the blocks, and at the served shape (B=4, S=512) one row tile was the
//    faster: the launch takes MT = 2 only when its blocks still make two
//    waves of 2 blocks on every SM (kMinWaves; chip_smoke.py phase 3
//    times both instances on each side of it).  Blocks run the query
//    tiles longest first (the last tile, which sees the most keys under
//    the causal mask, has the lowest block index), so the causal work
//    spreads evenly over the SMs;
//  * Q's tile is copied to shared memory once and read as mma A-fragments
//    (ldmatrix) at every k-step: kept in registers it would take D/4 of
//    them per row tile, which MT = 2 does not have;
//  * K/V tiles of 64 keys arrive by cp.async (16-byte copies, rows past the
//    visible range zero-filled) in a ring of two stages in dynamic shared
//    memory, the next tile in flight while this one is computed, one block
//    barrier per tile.  Rows are padded by 16 bytes, so the eight rows an
//    ldmatrix phase reads fall in distinct banks.  At D=128: 85 KB a block
//    (MT = 1) or 102 KB (MT = 2), 2 blocks an SM;
//  * S = Q K^T by mma with fp32 accumulators.  Products of bf16 values are
//    exact in fp32, so the scores are those of the Pallas kernel's fp32 dot
//    over upcast inputs up to the order of the sums;
//  * only tiles that cross the causal diagonal, the window's lower edge or
//    the end of K pay for the mask (per warp); tiles wholly above the
//    diagonal or wholly before the window are never loaded.  Masked scores
//    are -1e30 and masked probabilities exactly 0, and a row with no
//    visible key gives 0 (denominator clamped at 1e-30), as in the
//    reference.  S need not be a multiple of any tile;
//  * online softmax in registers, in base 2 with the scale folded into one
//    fused multiply-add before the hardware's exp2: a row's max and sum
//    are reduced over the 4 lanes of its quad;
//  * O += P V on the tensor cores at fp32-grade precision.  The Pallas
//    kernel multiplies P and V in fp32, and the bf16 tolerance holds the
//    output to 2e-5 absolute, which a P rounded to bf16 (relative error
//    2^-9 per term) breaks near 0 (chip_smoke.py --planted-fault
//    p_in_bf16).  So P is split into hi = bf16(P) and lo = bf16(P - hi),
//    and two mmas, hi V and lo V, go into one fp32 accumulator: an error of
//    ~2^-17 per term, at 1.5 times the tensor work of a plain bf16 kernel
//    (three products per score and head dim, one of Q K^T and two of P V,
//    in place of two).  P's A-fragments are taken from S's accumulator
//    registers directly (the m16n8k16 C layout is the A layout of the next
//    product), and V's B-fragments come from ldmatrix.trans;
//  * the epilogue divides by the clamped sum, rounds to bf16, stages the
//    tile in shared memory and writes rows < Sq with 16-byte stores (out
//    is a fresh tensor, 16-byte aligned, and D is a multiple of 8).
// The head dim is tiled in steps of 16, so any multiple of 16 needs only
// an instance, and the launch has D = 32, 64, 112 (zamba2-7b) and 128.  At
// D = 112 every step over D is a whole number of its units: 7 k-steps of
// 16 in Q K^T, 7 pairs of n8 tiles (ldmatrix x4 over two 8-column halves)
// in P V, 14 16-byte chunks a row in the copies and the epilogue.  Rows of
// 240 bytes (112 + 8 elements) stay conflict-free for ldmatrix: the 8 rows
// of a phase start at 16-byte offsets 0, 112, 96, 80, 64, 48, 32, 16 mod
// 128.  Shared memory at D = 112: 75 KB a block (MT = 1), 90 KB (MT = 2).
// What sets its time: the tensor pipe behind mma.sync and
// the shared-memory reads of the fragments, with 8 warps an SM to hide
// their latency (registers: up to 255 a thread at D=128, MT = 2);
// chip_smoke.py prints ptxas's registers and spills.
//
// The fp32 body:
//  * one block per (q tile of 16 rows, head, batch row); four warps, each
//    owning four query rows, share every K/V tile staged in shared memory
//    as fp32 (common.cuh: stage_tile); the block loops over tiles of 32
//    keys, skipping and masking as the bf16 body does;
//  * online softmax in fp32 per row (m, l, acc in registers); every score
//    is a serial dot product over D on the CUDA cores, so this body is
//    bound by its arithmetic and shared-memory reads, far from either
//    bound;
//  * lane j accumulates output dims j + 32 i, i < ceil(D / 32): at D = 112
//    the fourth of them exists for lanes 0-15 only, and lanes 16-31 skip
//    it (the 32-lane loops of the score and the softmax are untouched).

#include <cstdint>

#include "common.cuh"

namespace {

using namespace attn;

// ------------------------------------------------------------------------
// fp32: the CUDA-core body (instantiated for float only)

constexpr int kWarps = 4;
constexpr int kRows = 4;    // query rows per warp
constexpr int kBlockQ = kWarps * kRows;

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ out, int Sq, int Skv, int H, int KH, int HR, int KHR,
            int q_offset, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PER = (D + 31) / 32;  // output dims a lane owns, the last maybe not
  constexpr bool kRagged = D % 32 != 0;
  __shared__ float qs[kBlockQ * D];
  __shared__ float ks[kTile * DP];
  __shared__ float vs[kTile * D];
  __shared__ float ps[kWarps * kTile];

  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = min(kBlockQ, Sq - q0);

  const size_t qrow = (size_t)HR * D, krow = (size_t)KHR * D;
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
        for (int i = 0; i < PER; ++i)
          if (!kRagged || lane + 32 * i < D) acc[r][i] += pj * vs[j * D + lane + 32 * i];
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
    for (int i = 0; i < PER; ++i)
      if (!kRagged || lane + 32 * i < D) o[lane + 32 * i] = from_f<T>(acc[r][i] / denom);
  }
}

// ------------------------------------------------------------------------
// bf16: the tensor-core body

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kKeys = 64;  // keys per K/V tile
constexpr int kMaxDevices = 64;

// Query rows of a block whose warps hold MT m16 row tiles each.
template <int MT>
__host__ __device__ constexpr int tc_rows() {
  return 16 * MT * kTcWarps;
}

// Shared memory of a block, in rows of D + 8 bf16 (16 bytes of padding):
// the block's Q tile (the output tile after the last key tile), then two
// stages of a K tile and a V tile.
template <int D, int MT>
constexpr size_t tc_smem_bytes() {
  return (size_t)(tc_rows<MT>() + 2 * 2 * kKeys) * (D + 8) * sizeof(bf16);
}

// 2^x by the hardware's approximation (relative error ~2^-22; 0 for x <=
// -126, so exactly 0 at -1e30).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi), x in the
// low half: hi + lo carries 16 of x's 24 mantissa bits.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Copy rows [0, n) of an R-row tile (D bf16 a row, `pitch` elements apart
// in global memory) into shared memory with row stride D + 8, zero-filling
// rows [n, R); every thread of the block takes part.
template <int D, int R>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, size_t pitch, int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * kChunks; i += kTcWarps * 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = r < n;
    cp_async16(dst + r * (D + 8) + c, src + (in ? (size_t)r * pitch + c : 0), in);
  }
}

// s = Q K^T for one warp's MT row tiles and a 64-key tile: s[mt][n] is the
// m16n8 accumulator of row tile mt and keys [8n, 8n + 8).  qw: the warp's
// first Q row in shared memory.
template <int D, int MT>
__device__ __forceinline__ void scores(float (&s)[MT][kKeys / 8][4], const bf16* qw,
                                       const bf16* kt, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
  // Q: rows [0, 8) and [8, 16) of a row tile, dims [16kk, 16kk+8) and
  // [16kk+8, 16kk+16): its A-fragment at one k-step.  K: keys [8n, 8n+8)
  // and [8n+8, 8n+16), dims as Q's: the B-fragments of two n-tiles
  const bf16* qa = qw + (lane & 15) * (D + 8) + 8 * (lane >> 4);
  const bf16* ka = kt + ((lane & 7) + 8 * (lane >> 4)) * (D + 8) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qf[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(qf[mt], qa + 16 * mt * (D + 8) + 16 * kk);
#pragma unroll
    for (int n = 0; n < kKeys / 8; n += 2) {
      uint32_t kf[4];
      ldmatrix_x4(kf, ka + 8 * n * (D + 8) + 16 * kk);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][n], qf[mt], kf[0], kf[1]);
        mma_bf16(s[mt][n + 1], qf[mt], kf[2], kf[3]);
      }
    }
  }
}

// o += p V for one warp's MT row tiles and a 64-key tile, p split into hi
// and lo bf16 parts; o[mt][c] is the m16n8 accumulator of row tile mt and
// dims [8c, 8c + 8).
template <int D, int MT>
__device__ __forceinline__ void pv_tile(float (&o)[MT][D / 8][4],
                                        const float (&p)[MT][kKeys / 8][4], const bf16* vt,
                                        int lane) {
  // V: keys [16j, 16j+8) and [16j+8, 16j+16), dims [16c, 16c+8) and
  // [16c+8, 16c+16), each transposed: the B-fragments of two n-tiles
  const bf16* va = vt + (lane & 15) * (D + 8) + 8 * (lane >> 4);
#pragma unroll
  for (int j = 0; j < kKeys / 16; ++j) {
    // the A-fragment of keys [16j, 16j+16) is the C-fragments of n-tiles
    // 2j and 2j+1: rows g and g+8, keys 2t, 2t+1 (and 8 more)
    uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split_bf16(p[mt][2 * j][0], p[mt][2 * j][1], ph[mt][0], pl[mt][0]);
      split_bf16(p[mt][2 * j][2], p[mt][2 * j][3], ph[mt][1], pl[mt][1]);
      split_bf16(p[mt][2 * j + 1][0], p[mt][2 * j + 1][1], ph[mt][2], pl[mt][2]);
      split_bf16(p[mt][2 * j + 1][2], p[mt][2 * j + 1][3], ph[mt][3], pl[mt][3]);
    }
#pragma unroll
    for (int c = 0; c < D / 8; c += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, va + 16 * j * (D + 8) + 8 * c);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][c], ph[mt], vf[0], vf[1]);
        mma_bf16(o[mt][c + 1], ph[mt], vf[2], vf[3]);
        mma_bf16(o[mt][c], pl[mt], vf[0], vf[1]);
        mma_bf16(o[mt][c + 1], pl[mt], vf[2], vf[3]);
      }
    }
  }
}

template <int D, int MT>
__global__ void __launch_bounds__(kTcWarps * 32)
attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out, int B, int Sq, int Skv,
               int H, int KH, int HR, int KHR, int q_offset, int window, float scale_log2) {
  static_assert(D % 16 == 0, "the head dim is tiled in steps of 16");
  constexpr int RS = D + 8;  // shared-memory row stride, elements
  constexpr int kTcRows = tc_rows<MT>();
  constexpr int kWarpRows = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const qs = reinterpret_cast<bf16*>(smem_raw);
  // stage s of the ring: K rows at kst(s), V rows kKeys * RS after them
  auto kst = [qs](int s) { return qs + (size_t)(kTcRows + 2 * s * kKeys) * RS; };

  // blocks in order: heads and batch rows fastest, query tiles last first
  const int n_qt = (Sq + kTcRows - 1) / kTcRows;
  const int hb = blockIdx.x % (H * B);
  const int h = hb % H, b = hb / H;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / (H * B))) * kTcRows;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // the m16n8 C layout: rows g, g + 8; cols 2tq
  const int nq = min(kTcRows, Sq - q0);

  const size_t qrow = (size_t)HR * D, krow = (size_t)KHR * D;
  const bf16* qb = q + ((size_t)b * Sq + q0) * qrow + (size_t)h * D;
  const bf16* kb = k + (size_t)b * Skv * krow + (size_t)kh * D;
  const bf16* vb = v + (size_t)b * Skv * krow + (size_t)kh * D;

  // key range any row of this tile can see
  const int pos_first = q_offset + q0, pos_last = pos_first + nq - 1;
  const int hi = min(Skv, pos_last + 1);
  const int lo = window > 0 ? max(pos_first - window + 1, 0) : 0;
  const int first = lo;
  const int n_tiles = hi > first ? (hi - first + kKeys - 1) / kKeys : 0;
  const int pos_w = pos_first + kWarpRows * warp;  // this warp's first row

  // per row tile mt: accumulators of dims [8c, 8c + 8), and the running
  // max (of the raw scores) and sum of rows g (r = 0) and g + 8 (r = 1)
  float o[MT][D / 8][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][c][e] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  if (n_tiles > 0) {
    copy_tile<D, kTcRows>(qs, qb, qrow, nq);
    copy_tile<D, kKeys>(kst(0), kb + (size_t)first * krow, krow, min(kKeys, hi - first));
    copy_tile<D, kKeys>(kst(0) + kKeys * RS, vb + (size_t)first * krow, krow,
                        min(kKeys, hi - first));
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = first + it * kKeys;
    cp_async_wait<0>();
    __syncthreads();  // tile it (and Q) has landed; tile it - 1 is consumed
    if (it + 1 < n_tiles) {
      const int t1 = t0 + kKeys, n1 = min(kKeys, hi - t1);
      bf16* ks = kst((it + 1) & 1);
      copy_tile<D, kKeys>(ks, kb + (size_t)t1 * krow, krow, n1);
      copy_tile<D, kKeys>(ks + kKeys * RS, vb + (size_t)t1 * krow, krow, n1);
    }
    cp_async_commit();
    const bf16* kt = kst(it & 1);

    float s[MT][kKeys / 8][4];
    scores<D, MT>(s, qs + kWarpRows * warp * RS, kt, lane);
    // a tile that some key of some row of this warp may not see is masked
    // element by element; scores stay raw (the scale goes into exp2)
    const bool masked = t0 + kKeys > Skv || t0 + kKeys - 1 > pos_w ||
                        (window > 0 && t0 <= pos_w + kWarpRows - 1 - window);
    if (masked) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // the keys this row sees, relative to key t0 + 2tq: [bot, top]
          const int pos = pos_w + 16 * mt + g + 8 * r, k0 = t0 + 2 * tq;
          const int top = min(pos, Skv - 1) - k0;
          const int bot = window > 0 ? pos - window + 1 - k0 : -kKeys;
#pragma unroll
          for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * n + e > top || 8 * n + e < bot) s[mt][n][2 * r + e] = kNegInf;
        }
    }
    // online softmax in base 2; a row's 64 scores lie in the 4 lanes of its
    // quad
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[mt][r];
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * r], s[mt][n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row that sees no key yet keeps m = -1e30; exponents taken from
        // 0 then give exactly 0 for its masked scores
        const float base = mx == kNegInf ? 0.f : mx * scale_log2;
        const float alpha = fast_exp2(fmaf(m[mt][r], scale_log2, -base));
        m[mt][r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[mt][n][e] = fast_exp2(fmaf(s[mt][n][e], scale_log2, -base));
            sum += s[mt][n][e];
          }
        l[mt][r] = l[mt][r] * alpha + sum;  // this lane's part of the row sum
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          o[mt][c][2 * r] *= alpha;
          o[mt][c][2 * r + 1] *= alpha;
        }
      }
    pv_tile<D, MT>(o, s, kt + kKeys * RS, lane);
  }

  // epilogue: the row sums over the quad, the output tile through shared
  // memory (each warp over its own Q rows), rows < nq out with 16-byte
  // stores
  bf16* os = qs + kWarpRows * warp * RS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float d = l[mt][r];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d = fmaxf(d, 1e-30f);
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(os + (16 * mt + g + 8 * r) * RS + 8 * c + 2 * tq) =
            __floats2bfloat162_rn(o[mt][c][2 * r] / d, o[mt][c][2 * r + 1] / d);
    }
  __syncthreads();
  bf16* ob = out + ((size_t)b * Sq + q0) * qrow + (size_t)h * D;
  for (int i = threadIdx.x; i < nq * (D / 8); i += kTcWarps * 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(ob + r * qrow + c) = *reinterpret_cast<const uint4*>(qs + r * RS + c);
  }
}

// ------------------------------------------------------------------------
// launches

// The body the last launch ran: 0 the CUDA-core body, MT (1 or 2) the
// tensor-core body with MT row tiles a warp, -1 when the last launch
// reached no body (flash_attention_last_body).
int last_body = -1;
// The row tiles a warp that bf16 launches take: 1 or 2, or 0 to choose by
// grid size (flash_attention_row_tiles).
int forced_row_tiles = 0;

template <int D>
cudaError_t launch_cuda_core(const void* q, const void* k, const void* v, void* out, int B,
                             int Sq, int Skv, int H, int KH, int HR, int KHR, int q_offset,
                             int window, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  last_body = 0;
  attn_kernel<float, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, KH, HR, KHR,
      q_offset, window, scale);
  return cudaGetLastError();
}

template <int D, int MT>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                      int Skv, int H, int KH, int HR, int KHR, int q_offset, int window,
                      float scale, cudaStream_t stream, int dev) {
  constexpr size_t smem = tc_smem_bytes<D, MT>();
  last_body = MT;
  // the shared memory above 48 KB is granted per kernel and device, once
  static bool granted[kMaxDevices] = {};
  if (!granted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_tc_kernel<D, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted[dev] = true;
  }
  const long long blocks = (long long)((Sq + tc_rows<MT>() - 1) / tc_rows<MT>()) * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn_tc_kernel<D, MT><<<(unsigned)blocks, kTcWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), B, Sq, Skv, H, KH, HR, KHR, q_offset, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// Two row tiles a warp (128-row blocks) halve the shared-memory reads per
// score and reuse each K/V fragment twice, but leave half the blocks: they
// are taken when those still make kMinWaves waves of 2 blocks on every SM.
constexpr int kMinWaves = 2;

template <int D>
cudaError_t launch_tensor_core(const void* q, const void* k, const void* v, void* out, int B,
                               int Sq, int Skv, int H, int KH, int HR, int KHR,
                               int q_offset, int window, float scale, cudaStream_t stream) {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long long blocks2 = (long long)((Sq + tc_rows<2>() - 1) / tc_rows<2>()) * H * B;
  const bool two = forced_row_tiles ? forced_row_tiles == 2
                                    : blocks2 >= (long long)kMinWaves * 2 * sms[dev];
  if (two)
    return launch_tc<D, 2>(q, k, v, out, B, Sq, Skv, H, KH, HR, KHR, q_offset, window, scale,
                           stream, dev);
  return launch_tc<D, 1>(q, k, v, out, B, Sq, Skv, H, KH, HR, KHR, q_offset, window, scale,
                         stream, dev);
}

// dtype 0 (fp32): the CUDA-core body; dtype 1 (bf16): the tensor-core body
template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out, int B,
                   int Sq, int Skv, int H, int KH, int HR, int KHR, int q_offset, int window,
                   float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_cuda_core<D>(q, k, v, out, B, Sq, Skv, H, KH, HR, KHR, q_offset, window,
                               scale, stream);
  if (dtype == 1)
    return launch_tensor_core<D>(q, k, v, out, B, Sq, Skv, H, KH, HR, KHR, q_offset, window,
                                 scale, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_d(int D, int dtype, const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Skv, int H, int KH, int HR, int KHR, int q_offset,
                     int window, float scale, cudaStream_t stream) {
#define PREFILL_D(DD) \
  launch<DD>(dtype, q, k, v, out, B, Sq, Skv, H, KH, HR, KHR, q_offset, window, scale, stream)
  switch (D) {
    case 32:
      return PREFILL_D(32);
    case 64:
      return PREFILL_D(64);
    case 112:
      return PREFILL_D(112);
    case 128:
      return PREFILL_D(128);
    default:
      return cudaErrorInvalidValue;
  }
#undef PREFILL_D
}

}  // namespace

// q/out (B,Sq,H,D), k/v (B,Skv,KH,D), q, k and v 16-byte aligned, out
// 16-byte aligned for bf16.  A token's heads are HR (q and out) and KHR (k
// and v) apart, HR >= H and KHR >= KH: the H and KH heads are then a
// contiguous range of wider rows, as one uniform GQA segment of a
// tensor-parallel rank whose heads cut a group (kernels/ops.py::
// head_segments); HR = H and KHR = KH for whole contiguous tensors.  dtype:
// 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int Sq, int Skv, int H, int KH,
                                      int HR, int KHR, int D, int dtype, int q_offset,
                                      int window, float scale, void* stream) {
  last_body = -1;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH != 0 || H > 65535 || HR < H ||
      KHR < KH)
    return (int)cudaErrorInvalidValue;
  return (int)launch_d(D, dtype, q, k, v, out, B, Sq, Skv, H, KH, HR, KHR, q_offset, window,
                       scale, static_cast<cudaStream_t>(stream));
}

// Which body the last flash_attention_launch of this process ran (see
// last_body), for checks on the card; -1 before the first launch and after
// a launch refused before its body.
extern "C" int flash_attention_last_body() { return last_body; }

// Make the bf16 launches that follow take mt row tiles a warp (1 or 2), or
// choose by grid size again (0, the default), so that the card can time
// both instances at one shape (chip_smoke.py phase 3).  Returns 0, or
// cudaErrorInvalidValue for another mt.
extern "C" int flash_attention_row_tiles(int mt) {
  if (mt < 0 || mt > 2) return (int)cudaErrorInvalidValue;
  forced_row_tiles = mt;
  return 0;
}
