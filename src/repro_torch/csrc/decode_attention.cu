// Split-KV flash-decode for Hopper (sm_90a): one query token per slot
// attending over the slot KV cache, with per-slot valid lengths and query
// positions.  One body serves two caches through its K/V-loader template
// parameter: K/V in the query's dtype (flash_decode_launch, also run once per
// rank by the wrapper flash_decode_sharded), and int8 K/V with per-token fp32
// scales (flash_decode_int8_launch).  A tensor-parallel rank whose query
// heads cut a GQA group is launched once per uniform segment of its heads,
// each a strided view of the rank's q, cache and output (the entries' row
// strides HR and KHR); a head's arithmetic does not depend on the view.
//
// Replaces: src/repro/kernels/decode_attention.py::_decode_kernel (entries
// flash_decode and flash_decode_sharded), the Pallas TPU kernel on every
// decode step of the served path, and ::_decode_kernel_int8 (entry
// flash_decode_int8), the one that reads an int8 cache: every decode step of
// the step functions over an int8 linear cache (launch/steps.py).  There the
// key axis was a sequential grid axis carrying (m, l, acc) in scratch from
// step to step; here blocks split it and a second pass merges them.
//
// Partials mode (flash_decode_partials_launch, flash_decode_int8_partials_
// launch, flash_decode_combine_launch): where a pod splits the cache's rows
// (the reference's sequence-sharded and context-parallel caches, which GSPMD
// lowers through XLA there), each rank's launch reads its own rows [r0, r0 +
// L), shifts the slots' global lengths and positions by r0, and writes its
// splits' (acc, m, l) into its slice of one fp32 scratch that all ranks
// share (a split offset, a head offset, a total split count); one combine
// launch then merges every rank's splits, in rank order, as it merges one
// launch's.  A rank with no visible row of a slot writes empty splits
// (m = -1e30, l = 0), which the combine leaves out of its max and weighs 0.
//
// Bound on the card: bytes.  A step reads kv_len rows of K and V for each
// slot and does 4*D flops per (query head, key): at GQA 6 in bf16 that is
// about 6 flops per byte (12 over int8 codes), far under the ~295 flops per
// byte at which the H100's tensor cores, and not its memory, would set the
// limit, so the work stays on the CUDA cores.  An int8 row is D bytes per KV
// head plus one 4-byte scale per token for K and for V: at decode_32k
// (B=128, L=32768, 2 KV heads, D=128) a call reads 2.18 GB, 0.651 ms at
// 3.35 TB/s.
//
// Design:
//  * the grid is (slot, kv head, split): split s of n_split walks the rows
//    of [s*s_len, (s+1)*s_len) that the mask keeps (k_pos < kv_len,
//    k_pos <= q_pos, k_pos > q_pos - window, k_pos < L); a masked row adds
//    exactly 0 to the online softmax, so skipping it computes the same
//    function.  The host picks (n_split, s_len) from B, L and the SM count
//    alone (kernels/ops.py::decode_splits), never from the heads or the
//    device-side lengths: the shards of a TP pod then see the partition the
//    single-device kernel sees, and no step waits on a host sync.  At
//    decode_32k that is 9 splits, 2304 blocks instead of 256;
//  * inside a block the warps split the keys again, tile by tile, and each
//    warp computes every query head of the GQA group (G = H/KH, built for
//    G rounded up to 1, 2, 4, 6, 8 or 16) over its own keys: lane j scores
//    key j against all G heads, and lane i accumulates output dims
//    [i*PER, (i+1)*PER) of all G heads, PER = ceil(D/32), so each K and V
//    element crosses shared memory once per block, not once per head (a
//    warp per head, re-reading the tile in fp32, is bound by shared
//    memory).  Built for D = 32, 64, 112 (zamba2-7b) and 128.  At D = 112,
//    PER = 4 and lanes 0-27 own the 112 dims; lanes 28-31 score their keys
//    like the others but read the last dims' V (their sums are dropped) and
//    write nothing;
//  * each warp has its own ring of kStages tiles of 32 keys in shared
//    memory, filled with cp.async (16-byte copies, rows past the split's
//    end zero-filled) one tile ahead of the one in use, and synchronised by
//    the warp alone: the loads of the next tile are in flight while this
//    one is scored and accumulated, and no block barrier stands in the key
//    loop.  Tiles stay raw (int8, bf16 or fp32) in shared memory and are
//    converted where they are read; an int8 code is dequantized there,
//    code * scale in fp32 as the TPU kernel does (the code through an exact
//    byte-permute trick, not the slow integer-to-float unit).  K's 16-byte
//    chunks are swizzled within each row so that lanes reading their own
//    rows hit distinct banks: chunk c of row j sits at chunk c ^ (j & 7)
//    (rows of fewer than 8 chunks: c ^ ((j / rows) & (chunks - 1)), rows
//    per 128 bytes), a permutation of the row's own chunks only when the
//    row holds a power of two, or a multiple of 8, chunks.  So each K row
//    is padded to such a count (Layout::kKChunks): D = 112 gives 14 chunks
//    (bf16), 28 (fp32) and 7 (int8), padded to 16, 32 and 8; the other
//    head dims need no padding.  V rows are not swizzled or padded;
//  * each warp keeps (m, l, acc) per head; the warps merge in the order of
//    the warps, and each split writes its merged state in fp32 (empty
//    splits too: m = -1e30, l = 0, acc = 0).  combine_kernel, one warp per
//    (slot, query head), merges the splits in the order of s: M = max m_s,
//    l = sum l_s e_s, out = sum acc_s e_s / max(l, 1e-30), e_s =
//    exp(m_s - M).  With one split the block writes the output itself, the
//    same bits.  Every sum runs in an order fixed by the key partition
//    alone, so a head's result does not depend on G.  The denominator's
//    update l = l * alpha + p is written as one fma: left to the
//    compiler it was fused in some group-size instances and not in
//    others, and an fp32 output then differed in its last bit between a
//    rank's cut segment and one device (a bf16 output rounds it away);
//  * the key loop's exponentials use the hardware's fast exp2 (__expf,
//    within 2 + 1.16|x| ulp: ~1e-6 relative over the range a softmax
//    weight that matters spans; expf costs several instructions more, and
//    the kernel is issue-bound); __expf(0) = 1 and __expf(-1e30) = 0, so
//    empty tiles and splits stay exact;
//  * a slot that sees no key gives 0 (the denominator is clamped at 1e-30);
//  * offsets are size_t: one layer of a decode_32k int8 cache is 1.07 GB of
//    codes for K alone.
// Occupancy (shared memory sets it): int8 at D=128, G=6 takes 72 KB a block
// of 4 warps and 96 registers a thread (ptxas: an 8-byte spill), so 3
// blocks (12 warps) an SM, each warp one tile (8.4 KB) ahead; bf16 at D=128
// 69.5 KB a block of 2 warps, 128 registers.  chip_smoke.py prints ptxas's
// registers and spills for every instance.  What still limits it: the arithmetic of the CUDA
// cores.  Per key and head a warp does D multiply-adds for the score and D
// for the output, and an int8 code costs three more instructions to
// dequantize; at decode_32k that issue work, not the 2.18 GB read, sets the
// time.

#include <cstdint>

#include "common.cuh"

namespace {

using namespace attn;

constexpr int kMaxGroup = 16;
constexpr int kStages = 2;                // tiles in each warp's ring
constexpr int kMaxWarps = 4;              // warps of a block
constexpr size_t kRingBytes = 72 * 1024;  // the block's rings at most

// Code e (0..3) of four int8 codes packed in w, as an exact fp32: the biased
// byte code + 128 placed in the mantissa of 2^23, less 2^23 + 128.
__device__ __forceinline__ float int8_to_f(uint32_t w, int e) {
  return __int_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7650 + e)) -
         8388736.f;
}

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y;
}

// N consecutive fp32 (N = 1, 2 or 4) from shared memory in one load.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* o) {
  if constexpr (N == 4) {
    load4(p, o);
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x, o[1] = x.y;
  } else {
    o[0] = *p;
  }
}

// Shared memory of a block: each warp's ring of kStages raw tiles of 32
// keys, kWarps warps (as many as fit kRingBytes, at most kMaxWarps); after
// the key loop the rings hold the warps' states for the in-block merge.
// A stage holds K then V codes (kTile rows each: K rows padded to kKRow
// bytes, V rows of kRow) and, for the int8 loader, kTile K scales and kTile
// V scales.  K's 16-byte chunks are swizzled within each row (kpos) so that
// 8 lanes reading chunk c of 8 consecutive rows hit 8 distinct bank groups.
template <typename Raw, int D>
struct Layout {
  static constexpr int kRow = D * sizeof(Raw);  // bytes of one V row, and of K's data
  static constexpr int kChunks = kRow / 16;
  // K's chunks a row with padding: a multiple of 8 from 8 on, else a power
  // of two, so that the swizzle (kpos) stays inside the row
  static constexpr int kKChunks = kChunks >= 8 ? (kChunks + 7) / 8 * 8
                                  : kChunks > 4 ? 8
                                  : kChunks > 2 ? 4
                                                : kChunks;
  static constexpr int kKRow = kKChunks * 16;        // bytes of one padded K row
  static constexpr size_t kV = kTile * kKRow;        // offset of V in a stage
  static constexpr size_t kS = kV + kTile * kRow;    // offset of the scales
  static constexpr size_t kStage = kS + 2 * kTile * sizeof(float);
  static constexpr int kFit = (int)(kRingBytes / (kStages * kStage));
  static constexpr int kWarps = kFit < 1 ? 1 : (kFit > kMaxWarps ? kMaxWarps : kFit);
  static constexpr size_t kRing = kWarps * kStages * kStage;
  // byte offset of K chunk c of row j in a stage
  static __device__ __forceinline__ int kpos(int j, int c) {
    constexpr int rows = kKChunks >= 8 ? 1 : 8 / kKChunks;  // rows per 128 bytes
    constexpr int mask = (kKChunks >= 8 ? 8 : kKChunks) - 1;
    return j * kKRow + ((c ^ ((j / rows) & mask)) << 4);
  }
};

// 16 bytes of K codes (one chunk) as fp32.
__device__ __forceinline__ void chunk_to_f(const int8_t* p, float* o) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * i + e] = int8_to_f(w[i], e);
}

__device__ __forceinline__ void chunk_to_f(const __nv_bfloat16* p, float* o) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x, o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void chunk_to_f(const float* p, float* o) { load4(p, o); }

// N (1, 2 or 4) consecutive V elements as fp32.
template <int N>
__device__ __forceinline__ void raw_to_f(const int8_t* p, float* o) {
  uint32_t w;
  if constexpr (N == 4) w = *reinterpret_cast<const uint32_t*>(p);
  else if constexpr (N == 2) w = *reinterpret_cast<const uint16_t*>(p);
  else w = *reinterpret_cast<const uint8_t*>(p);
#pragma unroll
  for (int e = 0; e < N; ++e) o[e] = int8_to_f(w, e);
}

template <int N>
__device__ __forceinline__ void raw_to_f(const __nv_bfloat16* p, float* o) {
  if constexpr (N == 4) {
    load4(p, o);
  } else if constexpr (N == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = f.x, o[1] = f.y;
  } else {
    o[0] = to_f(*p);
  }
}

template <int N>
__device__ __forceinline__ void raw_to_f(const float* p, float* o) { load_n<N>(p, o); }

// One warp issues cp.async copies of keys [t0, t0 + kTile) of K and V (rows
// `row` elements apart, 16-byte aligned) into one stage, zero past t_end.
template <typename Raw, int D>
__device__ __forceinline__ void issue_rows(unsigned char* stage, const Raw* kb,
                                           const Raw* vb, size_t row, int t0,
                                           int t_end, int lane) {
  using Ly = Layout<Raw, D>;
  constexpr int VEC = 16 / sizeof(Raw);
  for (int i = lane; i < kTile * Ly::kChunks; i += 32) {
    const int j = i / Ly::kChunks, c = i % Ly::kChunks, t = t0 + j;
    const bool in = t < t_end;
    const size_t g = (size_t)(in ? t : t0) * row + c * VEC;
    cp_async16(stage + Ly::kpos(j, c), kb + g, in);
    cp_async16(stage + Ly::kV + j * Ly::kRow + c * 16, vb + g, in);
  }
}

// K/V loaders.  issue<D>(stage, b, off, row, L, t0, t_end, lane) starts one
// warp's copies of a tile of slot b's rows, where `off` is the element
// offset of the block's first K (and V) element and `row` the elements from
// one token's row to the next.  kScaled: the codes carry per-token scales.
template <typename T>
struct PlainKV {
  using Raw = T;
  static constexpr bool kScaled = false;
  const T* k;
  const T* v;
  template <int D>
  __device__ __forceinline__ void issue(unsigned char* stage, int, size_t off, size_t row,
                                        int, int t0, int t_end, int lane) const {
    issue_rows<T, D>(stage, k + off, v + off, row, t0, t_end, lane);
  }
};

struct Int8KV {
  using Raw = int8_t;
  static constexpr bool kScaled = true;
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;  // (B, L)
  const float* v_scale;
  template <int D>
  __device__ __forceinline__ void issue(unsigned char* stage, int b, size_t off, size_t row,
                                        int L, int t0, int t_end, int lane) const {
    issue_rows<int8_t, D>(stage, k + off, v + off, row, t0, t_end, lane);
    float* rs = reinterpret_cast<float*>(stage + Layout<int8_t, D>::kS);
    const size_t s = (size_t)b * L;
    const int t = t0 + lane;
    const bool in = t < t_end;
    cp_async4(rs + lane, k_scale + s + (in ? t : t0), in);
    cp_async4(rs + kTile + lane, v_scale + s + (in ? t : t0), in);
  }
};

// Shared memory of a block: the rings (or, after the key loop, the warps'
// states for the merge, whichever is larger), then q (KG x D fp32), then
// each warp's p (KG x kTile fp32).
template <typename Raw, int D, int KG>
__host__ __device__ constexpr size_t state_bytes() {
  return Layout<Raw, D>::kRing > (size_t)Layout<Raw, D>::kWarps * KG * (D + 2) * 4
             ? Layout<Raw, D>::kRing
             : ((size_t)Layout<Raw, D>::kWarps * KG * (D + 2) * 4 + 15) / 16 * 16;
}

template <typename Raw, int D, int KG>
size_t smem_bytes() {
  return state_bytes<Raw, D, KG>() +
         (size_t)(KG * D + Layout<Raw, D>::kWarps * KG * kTile) * sizeof(float);
}

// Block (b, kh, s): the G = H/KH query heads kh*G .. kh*G + G - 1 of slot b
// over split s, computed as KG >= G heads (q rows past G are zero and their
// results dropped).  Warp w walks tiles w, w + kWarps, ... of the split,
// each lane scoring one key for every head, with its own online softmax
// state (m, l, acc) per head; the warps' states are merged in the order of
// w.  With n_split == 1 and `out` given the block writes out; else its
// partial state to `part`: acc (B*HP, n_total, D), then (m, l) (B*HP,
// n_total, 2), all fp32, at row b*HP + hp0 + (the head) and split s_off + s.
// A launch over a whole cache has HP = H, hp0 = s_off = 0, n_total =
// n_split.  Partials mode (out == nullptr) writes its splits into a slice of
// a scratch that other launches share: a rank of a pod whose cache holds
// rows [r0, r0 + L) of the buffer, its row i at position r0 + i.
template <typename T, int D, int KG, typename KV>
__global__ void __launch_bounds__(32 * kMaxWarps)
decode_kernel(const T* __restrict__ q, const KV kv, const int* __restrict__ kv_len,
              const int* __restrict__ q_off, T* __restrict__ out,
              float* __restrict__ part, int L, int H, int KH, int HR, int KHR,
              int window, float scale, int n_split, int s_len, int r0, int HP,
              int hp0, int s_off, int n_total) {
  using Raw = typename KV::Raw;
  using Ly = Layout<Raw, D>;
  constexpr int W = Ly::kWarps;
  constexpr int PER = (D + 31) / 32;  // output dims a lane owns
  constexpr int kVLanes = D / PER;    // lanes that own dims: 28 at D = 112
  static_assert(D % PER == 0 && (PER == 1 || PER == 2 || PER == 4),
                "each owning lane reads PER whole dims of a V row");
  constexpr int VEC = 16 / sizeof(Raw);
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + state_bytes<Raw, D, KG>());
  const int G = H / KH;
  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // lanes past kVLanes own no dims: they read the last owner's and write
  // nothing
  const bool owner = kVLanes == 32 || lane < kVLanes;
  const int vlane = owner ? lane : kVLanes - 1;
  float* ps = qs + KG * D + warp * KG * kTile;  // this warp's p, KG x kTile

  // the visible positions [lo, hi) less r0: the rows of this launch's range
  const int qpos = q_off[b];
  const int hi = min(min(kv_len[b], qpos + 1) - r0, L);
  const int lo = window > 0 ? max(qpos - window + 1 - r0, 0) : 0;
  const int t_begin = max(lo, split * s_len);
  const int t_end = min(hi, (split + 1) * s_len);
  const int n_all = t_end > t_begin ? (t_end - t_begin + kTile - 1) / kTile : 0;
  const int n_mine = n_all > warp ? (n_all - 1 - warp) / W + 1 : 0;

  for (int i = threadIdx.x; i < KG * D; i += blockDim.x)
    qs[i] = i < G * D ? to_f(q[((size_t)b * HR + kh * G) * D + i]) : 0.f;

  const size_t row = (size_t)KHR * D;
  const size_t off = (size_t)b * L * row + (size_t)kh * D;
  unsigned char* ring = smem + warp * kStages * Ly::kStage;

  // prologue: the first kStages - 1 of this warp's tiles in flight (empty
  // groups keep the count of groups per tile uniform)
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < n_mine)
      kv.template issue<D>(ring + n * Ly::kStage, b, off, row, L,
                           t_begin + (n * W + warp) * kTile, t_end, lane);
    cp_async_commit();
  }
  __syncthreads();  // qs written

  float m[KG], l[KG], acc[KG][PER];
#pragma unroll
  for (int h = 0; h < KG; ++h) {
    m[h] = kNegInf, l[h] = 0.f;  // l: this lane's share of the sum
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[h][i] = 0.f;
  }

  for (int n = 0; n < n_mine; ++n) {
    __syncwarp();  // every lane is done with the stage the next copy fills
    const int ahead = n + kStages - 1;
    if (ahead < n_mine)
      kv.template issue<D>(ring + (ahead % kStages) * Ly::kStage, b, off, row, L,
                           t_begin + (ahead * W + warp) * kTile, t_end, lane);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this lane's copies of tile n landed
    __syncwarp();                  // and every lane's

    const unsigned char* st = ring + (n % kStages) * Ly::kStage;
    const float* sc = reinterpret_cast<const float*>(st + Ly::kS);  // K, V scales
    const int t0 = t_begin + (n * W + warp) * kTile;
    const bool valid = t0 + lane < t_end;  // t0 + lane >= lo by construction

    // scores of key t0 + lane for the KG heads
    float s[KG];
#pragma unroll
    for (int h = 0; h < KG; ++h) s[h] = 0.f;
#pragma unroll
    for (int c = 0; c < Ly::kChunks; ++c) {
      float kd[VEC];
      chunk_to_f(reinterpret_cast<const Raw*>(st + Ly::kpos(lane, c)), kd);
      if constexpr (KV::kScaled) {
        const float sk = sc[lane];
#pragma unroll
        for (int e = 0; e < VEC; ++e) kd[e] = kd[e] * sk;
      }
#pragma unroll
      for (int h = 0; h < KG; ++h)
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          float qd[4];
          load4(qs + h * D + c * VEC + e, qd);
#pragma unroll
          for (int x = 0; x < 4; ++x) s[h] += qd[x] * kd[e + x];
        }
    }

#pragma unroll
    for (int h = 0; h < KG; ++h) {
      const float sh = valid ? s[h] * scale : kNegInf;
      const float m_new = fmaxf(m[h], warp_max(sh));
      const float alpha = __expf(m[h] - m_new);
      const float p = valid ? __expf(sh - m_new) : 0.f;
      l[h] = __fmaf_rn(l[h], alpha, p);  // one rounding in every instance
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[h][i] *= alpha;
      m[h] = m_new;
      ps[h * kTile + lane] = p;
    }
    __syncwarp();

    // acc += p V, lane owning dims [lane*PER, lane*PER + PER), keys in order
    const Raw* vr = reinterpret_cast<const Raw*>(st + Ly::kV) + vlane * PER;
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float vv[4][PER];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        raw_to_f<PER>(vr + (j + u) * D, vv[u]);
        if constexpr (KV::kScaled) {
          const float sv = sc[kTile + j + u];
#pragma unroll
          for (int i = 0; i < PER; ++i) vv[u][i] = vv[u][i] * sv;
        }
      }
#pragma unroll
      for (int h = 0; h < KG; ++h) {
        float pw[4];
        load4(ps + h * kTile + j, pw);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float pj = pw[u];
#pragma unroll
          for (int i = 0; i < PER; ++i) acc[h][i] += pj * vv[u][i];
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the loop

  // merge the warps' states, in the order of the warps, through the rings
#pragma unroll
  for (int h = 0; h < KG; ++h) l[h] = warp_sum(l[h]);
  __syncthreads();  // every warp is done with its ring
  float* mw = reinterpret_cast<float*>(smem);  // W x KG x (acc[D], m, l)
#pragma unroll
  for (int h = 0; h < KG; ++h) {
    float* r = mw + (warp * KG + h) * (D + 2);
    if (owner) {
#pragma unroll
      for (int i = 0; i < PER; ++i) r[lane * PER + i] = acc[h][i];
    }
    if (lane == 0) r[D] = m[h], r[D + 1] = l[h];
  }
  __syncthreads();
  for (int h = warp; h < G; h += W) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) M = fmaxf(M, mw[(w * KG + h) * (D + 2) + D]);
    float lt = 0.f, o[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) o[i] = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float* r = mw + (w * KG + h) * (D + 2);
      const float e_w = expf(r[D] - M);
      lt += r[D + 1] * e_w;
#pragma unroll
      for (int i = 0; i < PER; ++i) o[i] += r[vlane * PER + i] * e_w;
    }
    if (out != nullptr && n_split == 1) {
      if (!owner) continue;
      const float denom = fmaxf(lt, 1e-30f);
      T* dst = out + ((size_t)b * HR + kh * G + h) * D + lane * PER;
#pragma unroll
      for (int i = 0; i < PER; ++i) dst[i] = from_f<T>(o[i] / denom);
      continue;
    }
    const size_t ps_i = ((size_t)b * HP + hp0 + kh * G + h) * n_total + s_off + split;
    float* pa = part + ps_i * D + lane * PER;
    if (owner) {
#pragma unroll
      for (int i = 0; i < PER; ++i) pa[i] = o[i];
    }
    if (lane == 0) {
      float* ml = part + (size_t)gridDim.x * HP * n_total * D + 2 * ps_i;
      ml[0] = M;
      ml[1] = lt;
    }
  }
}

// Merge the n_split partial states of each (slot, query head), in the order
// of s, into the output: one warp per row of BH = B*H, lane i owning dims
// [i*PER, (i+1)*PER), PER = ceil(D/32) (lanes past D / PER own none).  Row
// r is head r % H of slot r / H, which lies at row (r / H) * HR + r % H of
// the output (HR heads a slot).  The splits may be those of several ranks
// of a pod, each over its own rows, in rank order
// (flash_decode_combine_launch).  A split that saw no key (l = 0: an empty
// split, or a rank that holds none of the slot's visible rows) is left out
// of the max and gets weight 0, whatever its m, so that no m = -inf or
// garbage can make a NaN; where every split is empty the row is 0.
template <typename T, int D>
__global__ void combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                               int BH, int H, int HR, int n_split) {
  constexpr int PER = (D + 31) / 32;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= BH || lane >= D / PER) return;
  const float* pa = part + (size_t)r * n_split * D + lane * PER;
  const float* ml = part + (size_t)BH * n_split * D + (size_t)r * n_split * 2;
  float M = kNegInf;  // over the splits that saw a key
  for (int s = 0; s < n_split; ++s)
    if (ml[2 * s + 1] > 0.f) M = fmaxf(M, ml[2 * s]);
  float l = 0.f, o[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) o[i] = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float e_s = ml[2 * s + 1] > 0.f ? expf(ml[2 * s] - M) : 0.f;
    l += ml[2 * s + 1] * e_s;
#pragma unroll
    for (int i = 0; i < PER; ++i) o[i] += pa[(size_t)s * D + i] * e_s;
  }
  const float denom = fmaxf(l, 1e-30f);
  T* dst = out + ((size_t)(r / H) * HR + r % H) * D + lane * PER;
#pragma unroll
  for (int i = 0; i < PER; ++i) dst[i] = from_f<T>(o[i] / denom);
}

// The key splits of a launch; HP > 0 is partials mode (decode_kernel).
struct Split {
  float* part;
  int n_split, s_len;
  int r0 = 0, HP = 0, hp0 = 0, s_off = 0, n_total = 0;
};

template <typename T, int D, int KG, typename KV>
cudaError_t launch(const void* q, const KV& kv, const int* kv_len, const int* q_off,
                   void* out, Split sp, int B, int L, int H, int KH, int HR, int KHR,
                   int window, float scale, cudaStream_t stream) {
  using Ly = Layout<typename KV::Raw, D>;
  const size_t smem = smem_bytes<typename KV::Raw, D, KG>();
  auto kernel = decode_kernel<T, D, KG, KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool partials = sp.HP > 0;
  kernel<<<dim3(B, KH, sp.n_split), 32 * Ly::kWarps, smem, stream>>>(
      static_cast<const T*>(q), kv, kv_len, q_off,
      partials ? nullptr : static_cast<T*>(out), sp.part, L, H, KH, HR, KHR, window,
      scale, sp.n_split, sp.s_len, sp.r0, partials ? sp.HP : H, sp.hp0, sp.s_off,
      partials ? sp.n_total : sp.n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || sp.n_split == 1 || partials) return err;
  const int BH = B * H;
  combine_kernel<T, D><<<(BH + 3) / 4, 128, 0, stream>>>(sp.part, static_cast<T*>(out),
                                                         BH, H, HR, sp.n_split);
  return cudaGetLastError();
}

// The group size G = H / KH rounded up to the heads a kernel is built for.
template <typename T, int D, typename KV>
cudaError_t launch_g(const void* q, const KV& kv, const int* kv_len, const int* q_off,
                     void* out, Split sp, int B, int L, int H, int KH, int HR, int KHR,
                     int window, float scale, cudaStream_t stream) {
  const int G = H / KH;
#define DECODE_LAUNCH(KG)                                                          \
  launch<T, D, KG>(q, kv, kv_len, q_off, out, sp, B, L, H, KH, HR, KHR, window, scale, \
                   stream)
  if (G <= 1) return DECODE_LAUNCH(1);
  if (G <= 2) return DECODE_LAUNCH(2);
  if (G <= 4) return DECODE_LAUNCH(4);
  if (G <= 6) return DECODE_LAUNCH(6);
  if (G <= 8) return DECODE_LAUNCH(8);
  return DECODE_LAUNCH(16);
#undef DECODE_LAUNCH
}

template <typename T, typename KV>
cudaError_t launch_d(int D, const void* q, const KV& kv, const int* kv_len,
                     const int* q_off, void* out, Split sp, int B, int L, int H,
                     int KH, int HR, int KHR, int window, float scale,
                     cudaStream_t stream) {
#define DECODE_D(DD) \
  launch_g<T, DD>(q, kv, kv_len, q_off, out, sp, B, L, H, KH, HR, KHR, window, scale, stream)
  switch (D) {
    case 32: return DECODE_D(32);
    case 64: return DECODE_D(64);
    case 112: return DECODE_D(112);
    case 128: return DECODE_D(128);
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_D
}

// The splits must be tile-aligned, cover [0, L), and leave no split wholly
// past L; more than one needs the scratch.
bool bad_shape(int B, int L, int H, int KH, int HR, int KHR, const Split& sp) {
  return B <= 0 || L <= 0 || KH <= 0 || H % KH != 0 || H / KH > kMaxGroup ||
         HR < H || KHR < KH ||
         sp.n_split < 1 || sp.n_split > 65535 || sp.s_len <= 0 ||
         sp.s_len % kTile != 0 || (long long)sp.n_split * sp.s_len < L ||
         (long long)(sp.n_split - 1) * sp.s_len >= L ||
         (sp.n_split > 1 && sp.part == nullptr) ||
         (sp.HP > 0 && (sp.part == nullptr || sp.r0 < 0 || sp.hp0 < 0 ||
                        sp.hp0 + H > sp.HP || sp.s_off < 0 ||
                        sp.s_off + sp.n_split > sp.n_total));
}

template <int D>
cudaError_t combine_d(int dtype, const float* part, void* out, int B, int HP, int HR,
                      int n_total, cudaStream_t stream) {
  const int BH = B * HP;
  if (dtype == 0)
    combine_kernel<float, D><<<(BH + 3) / 4, 128, 0, stream>>>(
        part, static_cast<float*>(out), BH, HP, HR, n_total);
  else
    combine_kernel<__nv_bfloat16, D><<<(BH + 3) / 4, 128, 0, stream>>>(
        part, static_cast<__nv_bfloat16*>(out), BH, HP, HR, n_total);
  return cudaGetLastError();
}

template <typename KV32, typename KV16>
int dispatch(int dtype, int D, const void* q, const KV32& kv32, const KV16& kv16,
             const void* kv_len, const void* q_off, void* out, Split sp, int B, int L,
             int H, int KH, int HR, int KHR, int window, float scale, void* stream) {
  if (bad_shape(B, L, H, KH, HR, KHR, sp)) return (int)cudaErrorInvalidValue;
  const int* kl = static_cast<const int*>(kv_len);
  const int* qo = static_cast<const int*>(q_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(D, q, kv32, kl, qo, out, sp, B, L, H, KH, HR, KHR, window,
                                scale, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, kv16, kl, qo, out, sp, B, L, H, KH, HR, KHR,
                                        window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,1,H,D), k/v (B,L,KH,D), out (B,1,H,D), k and v 16-byte aligned;
// kv_len and q_off are int32 (B,) on the device.  A slot's heads are HR
// (q and out) and a key's KHR (k and v) apart, HR >= H and KHR >= KH: the
// H heads and KH KV heads are then a contiguous range of wider rows, as
// one uniform GQA segment of a tensor-parallel rank whose heads cut a
// group (kernels/ops.py::head_segments); HR = H and KHR = KH for whole
// contiguous tensors.  dtype: 0 =
// float32, 1 = bfloat16.  window <= 0 means no sliding window.  The key axis
// is cut into n_split splits of s_len rows (a multiple of 32, covering
// [0, L) with none wholly past L); with n_split > 1, part is fp32 scratch of
// B*H*n_split*(D+2) floats.  Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kv_len, const void* q_off, void* out,
                                   void* part, int B, int L, int H, int KH, int HR,
                                   int KHR, int D, int dtype, int window, float scale,
                                   int n_split, int s_len, void* stream) {
  const Split sp{static_cast<float*>(part), n_split, s_len};
  return dispatch(dtype, D, q,
                  PlainKV<float>{static_cast<const float*>(k), static_cast<const float*>(v)},
                  PlainKV<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(k),
                                         static_cast<const __nv_bfloat16*>(v)},
                  kv_len, q_off, out, sp, B, L, H, KH, HR, KHR, window, scale, stream);
}

// As flash_decode_launch, over an int8 cache: k/v (B,L,KH,D) int8 codes (KHR
// heads a key apart), k_scale/v_scale (B,L) fp32, contiguous; q and out in
// `dtype`.
extern "C" int flash_decode_int8_launch(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* kv_len, const void* q_off, void* out,
                                        void* part, int B, int L, int H, int KH, int HR,
                                        int KHR, int D, int dtype, int window, float scale,
                                        int n_split, int s_len, void* stream) {
  const Split sp{static_cast<float*>(part), n_split, s_len};
  const Int8KV kv{static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
                  static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)};
  return dispatch(dtype, D, q, kv, kv, kv_len, q_off, out, sp, B, L, H, KH, HR, KHR, window,
                  scale, stream);
}

// Partials mode of flash_decode_launch over one rank's rows of a cache whose
// key axis a pod splits (the sequence-sharded and context-parallel layouts):
// k/v (B,L,KH,D) hold buffer rows [r0, r0 + L), and kv_len / q_off are the
// slots' global lengths and positions, which the kernel shifts by r0.  The
// launch writes its n_split splits into the fp32 scratch `part` at split
// s_off of n_total and at head hp0 of HP a slot (decode_kernel); it writes no
// output.  flash_decode_combine_launch merges the scratch once every rank's
// launch is queued.
extern "C" int flash_decode_partials_launch(const void* q, const void* k, const void* v,
                                            const void* kv_len, const void* q_off,
                                            void* part, int B, int L, int H, int KH,
                                            int HR, int KHR, int D, int dtype, int window,
                                            float scale, int n_split, int s_len, int r0,
                                            int HP, int hp0, int s_off, int n_total,
                                            void* stream) {
  if (HP <= 0) return (int)cudaErrorInvalidValue;
  const Split sp{static_cast<float*>(part), n_split, s_len, r0, HP, hp0, s_off, n_total};
  return dispatch(dtype, D, q,
                  PlainKV<float>{static_cast<const float*>(k), static_cast<const float*>(v)},
                  PlainKV<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(k),
                                         static_cast<const __nv_bfloat16*>(v)},
                  kv_len, q_off, nullptr, sp, B, L, H, KH, HR, KHR, window, scale, stream);
}

// As flash_decode_partials_launch over an int8 cache: k/v codes and their
// (B,L) fp32 scales hold the same rows [r0, r0 + L).
extern "C" int flash_decode_int8_partials_launch(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* kv_len, const void* q_off, void* part, int B, int L, int H, int KH, int HR,
    int KHR, int D, int dtype, int window, float scale, int n_split, int s_len, int r0,
    int HP, int hp0, int s_off, int n_total, void* stream) {
  if (HP <= 0) return (int)cudaErrorInvalidValue;
  const Split sp{static_cast<float*>(part), n_split, s_len, r0, HP, hp0, s_off, n_total};
  const Int8KV kv{static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
                  static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)};
  return dispatch(dtype, D, q, kv, kv, kv_len, q_off, nullptr, sp, B, L, H, KH, HR, KHR,
                  window, scale, stream);
}

// Merge the n_total splits of every (slot, head) of the scratch `part` (B*HP
// rows) in split order, which is the pod's rank order, into out (B,1,HR,D),
// head h of slot b at row b*HR + h; an empty split weighs 0 (combine_kernel).
extern "C" int flash_decode_combine_launch(const void* part, void* out, int B, int HP,
                                           int HR, int n_total, int D, int dtype,
                                           void* stream) {
  if (B <= 0 || HP <= 0 || HR < HP || n_total < 1 || part == nullptr || out == nullptr ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)combine_d<32>(dtype, p, out, B, HP, HR, n_total, s);
    case 64: return (int)combine_d<64>(dtype, p, out, B, HP, HR, n_total, s);
    case 112: return (int)combine_d<112>(dtype, p, out, B, HP, HR, n_total, s);
    case 128: return (int)combine_d<128>(dtype, p, out, B, HP, HR, n_total, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
