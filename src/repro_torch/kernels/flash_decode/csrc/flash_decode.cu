// flash_decode: one query token per sequence against its KV cache, masked
// at the sequence's length, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py
// (flash_decode_kernel, launched by flash_decode_call), whose grid walks
// (batch x kv head, cache block) in order and carries (acc, m, l) in VMEM
// across the cache blocks of a row.
//
// What bounds it here: bytes. Every valid cache row is read once (k and v,
// KH * D * 2 elements a position) for G * D multiply-adds per element pair:
// a few operations per byte, far below the card's 295. So the design is
// about bytes in flight and a grid that fills the card, in one launch.
//
// * Splits sized to the grid. The cache axis is cut into splits of
//   split_len positions (ops.split_length: 64 to 256, shorter when B x KH
//   is small, so that B x KH x splits reaches the 132 SMs). A block takes
//   one (sequence, kv head, split) and every q head of that kv head (up to
//   16; a larger group is cut into even head groups), so the cache is read
//   once. Blocks past the sequence's length return at once.
// * Loads in flight. 64-row K and V tiles are copied straight from the
//   [B, T, KH, D] cache into a shared-memory ring with cp.async (16 bytes a
//   copy, rows past the length zero-filled), up to four stages within
//   about 96 KB, so two blocks share an SM with their tiles in flight.
// * Products. bf16 blocks of 4 or more q heads (D >= 64) run S = q K^T and
//   acc += p V as mma.sync m16n8k16: the heads are the 16 rows of M (zero
//   rows pad them); each warp takes 16 positions of the tile for S and a
//   quarter of D for PV. f32, and bf16 blocks of 1-3 heads, run the same
//   steps on the CUDA cores (no TF32): S with two lanes a position, PV with
//   a thread a run of elements of one head.
// * A tile's step: S (scaled, masked) into shared memory; each head's
//   online-softmax step by one warp (p rounded to the cache's dtype into
//   shared memory, m, l and alpha beside it); then PV into registers.
// * The combine inside the launch, in a fixed order. A sequence of one
//   split writes its output straight away. Otherwise each split writes its
//   (m, l, acc) in f32 and counts itself in on a counter of its (sequence,
//   kv head, head group). When the whole grid fits on the card at once (a
//   cooperative launch guarantees it: recurrentgemma-2b's 256 blocks), each
//   block of the row then waits for the row's count and merges its own
//   slice of the outputs over all the splits, so the merge is spread over
//   the row's SMs and takes one round trip to L2. Otherwise (a ragged
//   serving batch, most blocks past their length) the block that counts
//   last merges the whole row, which is then small. The counts are reset
//   by the block that leaves last. The result does not depend on which
//   block came last.
// * exp is ex2.approx of x log2(e) (2 ulp), as in the attention kernel.
//
// Semantics (src/repro/kernels/flash_decode/kernel.py): scores in f32 over
// positions < length; p = exp(s - m) is summed in f32 and rounded to v's
// dtype before the PV product; out = acc / max(l, 1e-30). A length past T
// admits the whole cache (the reference's mask), hence min(length, T). A
// length of 0 or less masks every position: the reference's scores are
// then all equal, so its softmax weighs the whole cache alike and returns
// the mean of v; such a row reads all T positions with scores of 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // cache positions a tile
constexpr int kHeads = 16;                 // q heads a block at most: the M of m16n8k16
constexpr int kMaxStages = 4;
constexpr int kRingBytes = 96 * 1024;      // K/V ring of a block: two blocks an SM
constexpr int kSPitch = kTile + 4;         // f32 rows of scores and p in shared memory
constexpr int kPPitch = kTile + 8;         // bf16 rows of p (ldmatrix: 16-byte rows, no conflicts)

struct Params {
  const void* q;        // [B, H, D]
  const void* k;        // [B, T, KH, D]
  const void* v;
  const int* lengths;   // [B]
  float* part_acc;      // [B, H, NS, D]: each split's unnormalised output
  float* part_ml;       // [B, H, NS, 2]: its (m, l)
  int* counters;        // [B, KH * head_groups, 2]: arrivals, departures; 0 between calls
  void* o;              // [B, H, D]
  int T, H, KH, group, head_groups, heads_per_block, num_splits, split_len, stages;
  int resident;         // 1: every block of the grid is resident at once (a cooperative launch)
  float scale;
};

// Dynamic shared memory of a block, in bytes: the mma path keeps 16 rows
// of q, S and p, the CUDA-core path GT rows.
template <typename T, int D, bool kMma, int GT>
struct Smem {
  static constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte copy
  static constexpr int kLd = D + kVec;         // K/V row pitch: 16 bytes of pad
  static constexpr int kRows = kMma ? kHeads : GT;
  static constexpr int kQ = 0;                 // q: bf16 [16][D + 8] (mma) or f32 [GT][D]
  static constexpr int kS = kQ + (kMma ? kHeads * (D + 8) * 2 : GT * D * 4);  // f32 [rows][kSPitch]
  static constexpr int kP = kS + kRows * kSPitch * 4;  // bf16 [16][kPPitch] or f32 [GT][kSPitch]
  static constexpr int kPBytes = kMma ? kHeads * kPPitch * 2 : GT * kSPitch * 4;
  static constexpr int kStat = kP + kPBytes;         // m, l, alpha [16] each, the ticket
  static constexpr int kRing = kStat + 4 * kHeads * 4;
  static constexpr int kTileBytes = kTile * kLd * static_cast<int>(sizeof(T));
  static constexpr int kStage = 2 * kTileBytes;  // K, then V
};

// Cache positions a sequence's blocks read (see the note above).
__device__ __forceinline__ int read_len(const Params& p, int b) {
  const int len = p.lengths[b];
  return len > 0 ? min(len, p.T) : p.T;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, bf16* dst) { *dst = __float2bfloat16_rn(x); }
// p as the PV product sees it: rounded to the cache's dtype.
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, bf16) { return __bfloat162float(__float2bfloat16_rn(x)); }

// E consecutive elements from shared memory, as f32, in the widest loads
// their alignment allows (E * sizeof(T) bytes, aligned to that size).
template <typename T, int E>
__device__ __forceinline__ void load_vals(const T* src, float (&out)[E]) {
  constexpr int kBytes = E * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int u = 0; u < kBytes / 16; ++u) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[u];
      const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kPer; ++e) out[u * kPer + e] = to_f(el[e]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f(el[e]);
  } else if constexpr (kBytes == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(src);
    const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f(el[e]);
  } else {
    out[0] = to_f(src[0]);
  }
}

// exp(x) as 2^(x log2 e) on the SFU (ex2.approx: 2 ulp), as the attention
// kernel takes it.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A counter's value, read with acquire semantics at device scope.
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float4 fma4(float w, const float4& x, const float4& acc) {
  return make_float4(fmaf(w, x.x, acc.x), fmaf(w, x.y, acc.y), fmaf(w, x.z, acc.z), fmaf(w, x.w, acc.w));
}

__device__ __forceinline__ void store4(const float4& a, float den, float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
}
__device__ __forceinline__ void store4(const float4& a, float den, bf16* dst) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a.x / den, a.y / den);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a.z / den, a.w / den);
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = lo;
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = hi;
}

// (m, l, acc) merged with (m2, l2, acc2): the online softmax's combine.
__device__ __forceinline__ void combine(float& m, float& l, float4& acc, float m2, float l2, const float4& acc2) {
  const float m_new = fmaxf(m, m2);
  const float a = fast_exp(m - m_new), w = fast_exp(m2 - m_new);
  l = fmaf(w, l2, l * a);
  acc = fma4(w, acc2, make_float4(acc.x * a, acc.y * a, acc.z * a, acc.w * a));
  m = m_new;
}

// Merge the partials of float4 outputs [q0, q0 + count) of a block's heads
// (count <= kThreads) over the row's ns splits: `groups` threads an output
// each take every groups-th split, in order, then the groups are combined in
// order through shared memory (red: kThreads x 6 floats), and the outputs
// written: out = acc / max(l, 1e-30). The result depends on count and ns
// only, not on timing.
template <typename T, int D>
__device__ __forceinline__ void merge_quads(const float* part_acc, const float* part_ml, long long row,
                                            int ns, int ns_all, int q0, int count, float* red, T* out) {
  constexpr int kQuads = D / 4;
  const int tid = threadIdx.x;
  const int groups = min(ns, max(1, kThreads / count));
  const int qi = tid % count, sg = tid / count;
  float m = kNegInf, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int q = q0 + qi, g = q / kQuads, c = (q % kQuads) * 4;
  if (sg < groups) {
    const float2* ml = reinterpret_cast<const float2*>(part_ml) + (row + g) * ns_all;
    const float4* src = reinterpret_cast<const float4*>(part_acc + (row + g) * ns_all * D + c);
#pragma unroll 4
    for (int s = sg; s < ns; s += groups) {
      const float2 mls = __ldcg(ml + s);
      combine(m, l, acc, mls.x, mls.y, __ldcg(src + static_cast<long long>(s) * (D / 4)));
    }
  }
  float* rm = red;
  float* rl = red + kThreads;
  float4* racc = reinterpret_cast<float4*>(red + 2 * kThreads);
  rm[tid] = m;
  rl[tid] = l;
  racc[tid] = acc;
  __syncthreads();
  if (tid < count) {
    for (int k = 1; k < groups; ++k) combine(m, l, acc, rm[tid + k * count], rl[tid + k * count], racc[tid + k * count]);
    store4(acc, fmaxf(l, 1e-30f), out + g * D + c);
  }
  __syncthreads();
}

// 16 bytes global -> shared, asynchronously; zeros when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most n (0..3) of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + 64) of the split's K and V into a ring stage; rows >= n
// are zeros (the cache past the length is never read).
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* sk, T* sv, const T* k, const T* v, long long row_stride,
                                          int r0, int n) {
  constexpr int kVec = 16 / sizeof(T), kLd = D + kVec, kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool in = r0 + r < n;
    const long long off = (in ? r0 + r : 0) * row_stride + c;
    cp_async16(sk + r * kLd + c, k + off, in);
    cp_async16(sv + r * kLd + c, v + off, in);
  }
}

// Threads a head and elements a thread in the CUDA-core PV step.
template <int GT, int D>
struct SimtPv {
  static constexpr int kE = GT * D / kThreads >= 1 ? GT * D / kThreads : 1;
  static constexpr int kTph = D / kE;
};

// kMma: the tensor-core path (bf16, D >= 64); else the CUDA-core path,
// GT the most q heads it holds. Grid (split, kv head x head group, batch).
template <typename T, int D, bool kMma, int GT>
__global__ void __launch_bounds__(kThreads, 2) flash_decode_kernel(Params p) {
  using L = Smem<T, D, kMma, GT>;
  using Pv = SimtPv<GT, D>;
  constexpr int kCols = D / kWarps;  // PV columns a warp (mma path)
  constexpr int kNB = kCols / 8;     // their n8 blocks
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x, b = blockIdx.z;
  const int hg = blockIdx.y % p.head_groups, kvh = blockIdx.y / p.head_groups;
  const int h0 = kvh * p.group + hg * p.heads_per_block;
  const int nh = min(p.heads_per_block, p.group - hg * p.heads_per_block);
  const int len = read_len(p, b);
  const int ns = (len + p.split_len - 1) / p.split_len;  // this sequence's splits
  if (split >= ns) return;  // past the length: nothing to read
  const int p0 = split * p.split_len;
  const int n = min(p.split_len, len - p0);
  const float scale = p.lengths[b] > 0 ? p.scale : 0.f;  // 0: all positions masked

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sM = reinterpret_cast<float*>(smem + L::kStat);
  float* sL = sM + kHeads;
  float* sA = sL + kHeads;
  int* sTicket = reinterpret_cast<int*>(sA + kHeads);
  T* ring = reinterpret_cast<T*>(smem + L::kRing);
  auto stage_k = [&](int st) { return ring + st * (L::kStage / static_cast<int>(sizeof(T))); };
  auto stage_v = [&](int st) { return stage_k(st) + L::kTileBytes / static_cast<int>(sizeof(T)); };

  const long long row_stride = static_cast<long long>(p.KH) * D;
  const long long base = (static_cast<long long>(b) * p.T + p0) * row_stride + static_cast<long long>(kvh) * D;
  const T* kg = static_cast<const T*>(p.k) + base;
  const T* vg = static_cast<const T*>(p.v) + base;
  // Every stage's tile is asked for first, then q is read meanwhile.
  const int nt = (n + kTile - 1) / kTile;
  const int S = min(p.stages, nt);
  for (int t = 0; t < S; ++t) {
    load_tile<T, D>(stage_k(t), stage_v(t), kg, vg, row_stride, t * kTile, n);
    cp_async_commit();
  }

  // q of the block's heads, the softmax state and p's padding rows (0).
  const T* qg = static_cast<const T*>(p.q) + (static_cast<long long>(b) * p.H + h0) * D;
  if constexpr (kMma) {
    bf16* sq = reinterpret_cast<bf16*>(smem + L::kQ);
    for (int i = tid; i < kHeads * (D / 8); i += kThreads) {
      const int g = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (g < nh) val = *reinterpret_cast<const uint4*>(qg + g * D + c);
      *reinterpret_cast<uint4*>(sq + g * (D + 8) + c) = val;
    }
  } else {
    float* sq = reinterpret_cast<float*>(smem + L::kQ);
    for (int i = tid; i < nh * D; i += kThreads) sq[i] = to_f(qg[i]);
  }
  for (int i = tid; i < L::kPBytes / 4; i += kThreads) reinterpret_cast<float*>(smem + L::kP)[i] = 0.f;
  if (tid < kHeads) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
    sA[tid] = 0.f;  // stays 0 for rows past nh: their acc stays 0
  }
  __syncthreads();

  // The mma path keeps q's A fragments (all of D) in registers.
  uint32_t qa[kMma ? D / 16 : 1][4];
  float acc_m[kMma ? kNB : 1][4];
  float acc_s[Pv::kE];
  if constexpr (kMma) {
    const bf16* sq = reinterpret_cast<const bf16*>(smem + L::kQ);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qa[kk], sq + (lane & 15) * (D + 8) + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < kNB; ++j) acc_m[j][0] = acc_m[j][1] = acc_m[j][2] = acc_m[j][3] = 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < Pv::kE; ++e) acc_s[e] = 0.f;
  }
  const int pv_g = tid / Pv::kTph, pv_c = (tid % Pv::kTph) * Pv::kE;  // the CUDA-core PV's elements
  const bool pv_on = tid < GT * Pv::kTph && pv_g < nh;

  for (int i = 0; i < nt; ++i) {
    cp_async_wait_upto(S - 1);  // tile i has landed (this thread's copies; a group a tile)
    __syncthreads();            // and everyone's; S and p are free
    const int r0 = i * kTile;
    const T* sk = stage_k(i % S);
    const T* sv = stage_v(i % S);

    // S = q K^T over the tile, scaled; positions past n masked.
    if constexpr (kMma) {
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sk + (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) * L::kLd + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], qa[kk], bf[0], bf[1]);
        mma_bf16(s[1], qa[kk], bf[2], bf[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (lane >> 2) + (e >> 1) * 8, col = warp * 16 + nb * 8 + 2 * (lane & 3) + (e & 1);
          sS[row * kSPitch + col] = r0 + col < n ? s[nb][e] * scale : kNegInf;
        }
    } else {
      constexpr int kHalf = D / 2;
      const int pos = warp * 16 + (lane & 15), half = lane >> 4;
      const T* krow = sk + pos * L::kLd + half * kHalf;
      const float* qh = reinterpret_cast<const float*>(smem + L::kQ) + half * kHalf;
      float dot[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) dot[g] = 0.f;
      for (int c = 0; c < kHalf; c += L::kVec) {
        float kf[L::kVec];
        load_vals<T, L::kVec>(krow + c, kf);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          if (g < nh) {
#pragma unroll
            for (int u = 0; u < L::kVec; u += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qh + g * D + c + u);
              dot[g] = fmaf(qv.x, kf[u], dot[g]);
              dot[g] = fmaf(qv.y, kf[u + 1], dot[g]);
              dot[g] = fmaf(qv.z, kf[u + 2], dot[g]);
              dot[g] = fmaf(qv.w, kf[u + 3], dot[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], 16);
        if (g < nh && half == 0) sS[g * kSPitch + pos] = r0 + pos < n ? dot[g] * scale : kNegInf;
      }
    }
    __syncthreads();

    // The online-softmax step, a warp a head: lanes over the 64 positions.
    for (int g = warp; g < nh; g += kWarps) {
      const float s0 = sS[g * kSPitch + lane], s1 = sS[g * kSPitch + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = fast_exp(m_old - m_new);
      const float p0 = r0 + lane < n ? fast_exp(s0 - m_new) : 0.f;
      const float p1 = r0 + lane + 32 < n ? fast_exp(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if constexpr (kMma) {
        bf16* sp = reinterpret_cast<bf16*>(smem + L::kP) + g * kPPitch;
        sp[lane] = __float2bfloat16_rn(p0);
        sp[lane + 32] = __float2bfloat16_rn(p1);
      } else {
        float* sp = reinterpret_cast<float*>(smem + L::kP) + g * kSPitch;
        sp[lane] = round_as(p0, T());
        sp[lane + 32] = round_as(p1, T());
      }
      __syncwarp();
      if (lane == 0) {
        sM[g] = m_new;
        sL[g] = sL[g] * alpha + sum;
        sA[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p V.
    if constexpr (kMma) {
      const float a_lo = sA[lane >> 2], a_hi = sA[(lane >> 2) + 8];
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        acc_m[j][0] *= a_lo;
        acc_m[j][1] *= a_lo;
        acc_m[j][2] *= a_hi;
        acc_m[j][3] *= a_hi;
      }
      const bf16* sp = reinterpret_cast<const bf16*>(smem + L::kP);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t pa[4];
        ldmatrix_x4(pa, sp + (lane & 15) * kPPitch + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < kNB; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, sv + (kk * 16 + (lane & 15)) * L::kLd + warp * kCols + j * 8 + (lane >> 4) * 8);
          mma_bf16(acc_m[j], pa, bf[0], bf[1]);
          mma_bf16(acc_m[j + 1], pa, bf[2], bf[3]);
        }
      }
    } else if (pv_on) {
      const float alpha = sA[pv_g];
#pragma unroll
      for (int e = 0; e < Pv::kE; ++e) acc_s[e] *= alpha;
      const float* sp = reinterpret_cast<const float*>(smem + L::kP) + pv_g * kSPitch;
      const int rows = min(kTile, n - r0);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        float vf[Pv::kE];
        load_vals<T, Pv::kE>(sv + r * L::kLd + pv_c, vf);
        const float pr = sp[r];
#pragma unroll
        for (int e = 0; e < Pv::kE; ++e) acc_s[e] = fmaf(pr, vf[e], acc_s[e]);
      }
    }
    if (i + S < nt) {  // tile i + S into tile i's stage, once every thread is done with it
      __syncthreads();
      load_tile<T, D>(stage_k(i % S), stage_v(i % S), kg, vg, row_stride, (i + S) * kTile, n);
    }
    cp_async_commit();  // a group a tile, empty or not, so that S - 1 stays the wait's count
  }

  // This block's result: (head g, column c, value) for each accumulator.
  auto each = [&](auto&& fn) {
    if constexpr (kMma) {
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = (lane >> 2) + (e >> 1) * 8;
          if (g < nh) fn(g, warp * kCols + j * 8 + 2 * (lane & 3) + (e & 1), acc_m[j][e]);
        }
    } else if (pv_on) {
#pragma unroll
      for (int e = 0; e < Pv::kE; ++e) fn(pv_g, pv_c + e, acc_s[e]);
    }
  };

  // The combine. A row of one split is written out. Otherwise each split
  // writes its (m, l, acc) and counts itself in; then either (resident
  // grid) every block of the row waits for the row's count and merges its
  // own slice of the outputs, or the block that counts last merges them
  // all. Either way over the splits in a fixed order.
  const long long row = static_cast<long long>(b) * p.H + h0;  // the block's first head
  T* out = static_cast<T*>(p.o) + row * D;
  if (ns == 1) {
    each([&](int g, int c, float a) { from_f(a / fmaxf(sL[g], 1e-30f), out + g * D + c); });
    return;
  }
  const int ns_all = p.num_splits;
  each([&](int g, int c, float a) { p.part_acc[((row + g) * ns_all + split) * D + c] = a; });
  if (tid < nh) reinterpret_cast<float2*>(p.part_ml)[(row + tid) * ns_all + split] = make_float2(sM[tid], sL[tid]);
  __syncthreads();
  int* counter = p.counters + (static_cast<long long>(b) * gridDim.y + blockIdx.y) * 2;
  if (tid == 0) {
    __threadfence();
    *sTicket = atomicAdd(counter, 1);
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + L::kRing);  // the ring is free
  const int quads = nh * (D / 4);
  if (p.resident) {
    if (tid == 0)
      while (load_acquire(counter) < ns) __nanosleep(64);  // every split of the row is written
    __syncthreads();
    const int per = (quads + ns - 1) / ns;  // this block's slice: float4 outputs [split * per, ...)
    const int end = min(quads, (split + 1) * per);
    for (int q0 = split * per; q0 < end; q0 += kThreads)
      merge_quads<T, D>(p.part_acc, p.part_ml, row, ns, ns_all, q0, min(kThreads, end - q0), red, out);
    if (tid == 0 && atomicAdd(counter + 1, 1) == ns - 1) {  // the last to leave resets the counts
      counter[0] = 0;
      counter[1] = 0;
    }
    return;
  }
  if (*sTicket != ns - 1) return;  // another block of the row merges
  __threadfence();
  for (int q0 = 0; q0 < quads; q0 += kThreads)
    merge_quads<T, D>(p.part_acc, p.part_ml, row, ns, ns_all, q0, min(kThreads, quads - q0), red, out);
  if (tid == 0) counter[0] = 0;  // ready for the next call
}

template <typename T, int D, bool kMma, int GT>
int launch(Params p, int B, cudaStream_t stream) {
  using L = Smem<T, D, kMma, GT>;
  int stages = kRingBytes / L::kStage;
  stages = max(1, min(kMaxStages, min(stages, (p.split_len + kTile - 1) / kTile)));
  p.stages = stages;
  const int smem = L::kRing + stages * L::kStage;
  // Above 48 KB, dynamic shared memory must be asked for. Asked on the
  // current device at every call, for the most this instantiation uses, so
  // that no call on another device or thread can undo it.
  constexpr int kMaxSmem = L::kRing + std::max(1, std::min(kMaxStages, kRingBytes / L::kStage)) * L::kStage;
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<T, D, kMma, GT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Blocks the device holds at once, for this instantiation and size: the
  // occupancy query times the SMs, asked once a (device, size).
  int dev = 0, resident = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    static std::mutex mu;
    static std::map<std::pair<int, int>, int> known;
    const std::lock_guard<std::mutex> lock(mu);
    const auto it = known.find({dev, smem});
    if (it != known.end()) {
      resident = it->second;
    } else {
      int per_sm = 0, sms = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_decode_kernel<T, D, kMma, GT>, kThreads,
                                                            smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      resident = known[{dev, smem}] = per_sm * sms;
    }
  }
  const dim3 grid(p.num_splits, p.KH * p.head_groups, B);
  p.resident = static_cast<long long>(grid.x) * grid.y * grid.z <= resident;
  // Cooperative when it fits: the runtime then holds every block resident
  // at once, which the row's wait for its splits needs.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.resident ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, flash_decode_kernel<T, D, kMma, GT>, p));
}

template <typename T, int D>
int by_group(const Params& p, int B, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16> && D >= 64) {
    if (p.heads_per_block >= 4) return launch<T, D, true, kHeads>(p, B, stream);
  }
  if (p.heads_per_block <= 2) return launch<T, D, false, 2>(p, B, stream);
  if (p.heads_per_block <= 8) return launch<T, D, false, 8>(p, B, stream);
  return launch<T, D, false, kHeads>(p, B, stream);
}

template <typename T>
int by_dim(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return by_group<T, 32>(p, B, stream);
    case 64: return by_group<T, 64>(p, B, stream);
    case 128: return by_group<T, 128>(p, B, stream);
    case 256: return by_group<T, 256>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int flash_decode_threads() { return kThreads; }


const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, H, D], k/v [B, T, KH, D], lengths [B] int32, part_acc [B, H, NS, D]
// f32, part_ml [B, H, NS, 2] f32 with NS = ceil(T / split_len), counters
// [B, KH * ceil(H / KH / 16), 2] int32 that are 0 (and are left 0), o [B,
// H, D]; one dtype (bf16 when is_bf16, else f32) for q, k, v and o; D in
// {32, 64, 128, 256}; split_len a multiple of 64; rows 16-byte aligned.
int flash_decode_launch(const void* q, const void* k, const void* v, const void* lengths,
                        void* part_acc, void* part_ml, void* counters, void* o, int B, int T, int H,
                        int KH, int D, int split_len, float scale, int is_bf16, void* stream) {
  if (split_len <= 0 || split_len % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int group = H / KH;
  const int head_groups = (group + kHeads - 1) / kHeads;
  Params p{q, k, v, static_cast<const int*>(lengths), static_cast<float*>(part_acc),
           static_cast<float*>(part_ml), static_cast<int*>(counters), o, T, H, KH, group, head_groups,
           (group + head_groups - 1) / head_groups, (T + split_len - 1) / split_len, split_len, 1, 0, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? by_dim<bf16>(p, B, D, s) : by_dim<float>(p, B, D, s);
}

}  // extern "C"
