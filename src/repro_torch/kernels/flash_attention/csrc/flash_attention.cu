// flash_attention: causal / sliding-window GQA attention with an online
// softmax, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, launched by flash_attention_call), which runs a
// sequential grid over (batch x head, q block, kv block) and carries the
// (acc, m, l) scratch in VMEM from one kv block to the next.
//
// What bounds it here: operations. A prefill at the serving shape (q
// [1, S, 16, 128], k/v [1, S, 8, 128] bf16, causal) does 2 * S^2 * H * Dh
// multiply-adds for about 12 S * H * Dh bytes, far above the card's 295
// operations per byte. So the two products run on the tensor cores, and
// only wgmma reaches their full rate.
//
// Three kernels, chosen by shape alone (the wrapper's rule, ops.py):
//
// * flash_attention_tma<D, kC, kEmpty> — bf16, D in {64, 128, 256}: the
//   serving path's (kEmpty: the shape has rows that see no key, below).
//   Warp-specialised: one producer warp keeps TMA loads in flight (the q
//   tile once, then 64-row K and V tiles, the reference's kv block, through
//   a ring of kStages buffers with full and empty mbarriers: 4 at D 64/128;
//   at D 256, where a K or V tile is 32 KB, 2 beside a 128-row q tile and 3
//   beside a 64-row one, within the 227 KB a block may use; 128-byte
//   swizzle, each 64-column box of a row loaded on its own), and kC
//   consumer warpgroups of 64 q rows each (kC = 2: a 128-row q tile;
//   kC = 1 for small grids) run S = Q K^T as wgmma m64n64k16 with both
//   operands in shared memory and O += P V as wgmma m64nDk16 (two m64n128k16
//   halves at D 256) with P taken
//   from registers (S's f32 accumulator after the softmax, rounded to bf16:
//   the reference's rounding point) and V read through the transposed-B
//   descriptor. The next tile's S is issued before this tile's PV, and its
//   softmax runs while PV is in flight; setmaxnreg moves registers from the
//   producer to the consumers. The online softmax runs in f32 on the
//   accumulator with exp2 and scale * log2(e) folded into one multiply-add;
//   only the tiles on the causal diagonal, at the window's lower edge or
//   past T are masked. q, k and v are read in place through 4-D tensor
//   maps over [B, S, H, D]; TMA zero-fills rows past S and T and the
//   epilogue writes only rows < S. Blocks take the heaviest causal q tiles
//   first. ptxas keeps the wgmmas asynchronous only while no branch falls
//   between a wgmma and its wait and no instruction but a wgmma rewrites an
//   accumulator that is still to be read as one: the loop body is
//   specialised (last tile, masked next tile) and chosen between tiles, and
//   each S starts in fresh registers.
// * flash_attention_bf16<D> — bf16, D 32 (and, where a measurement asks
//   for it, D 64-256): one block of four warps per 64-row q tile, mma.sync
//   m16n8k16 fed by ldmatrix from tiles that the threads copy into shared
//   memory themselves.
// * flash_attention_f32<D> — f32: the same algorithm on the CUDA cores
//   (no TF32), tiles of 64 q rows and 32 kv rows in shared memory.
//
// In all three, kv tiles above the diagonal or wholly before the window
// are never read, and GQA is indexing: q head h reads kv head h / group.
//
// Semantics (src/repro/kernels/flash_attention/kernel.py): scores in f32,
// masked to -1e30; m_new = max(m, rowmax); alpha = exp(m - m_new);
// p = exp(s - m_new); l = l * alpha + rowsum(p); p is rounded to v's dtype
// before the PV product; acc = acc * alpha + pv; out = acc / max(l, 1e-30).
// A row with no allowed key (window > 0 and row >= T + window - 1, causal
// or not) has every score at -1e30, so the reference's softmax weighs all
// T keys alike: such a row is the mean of v over T. The wrapper passes that
// mean ([B, KH, D] f32, `vmean`) only when the shape has such rows, and the
// epilogues write it there, whatever the kv loop left in the accumulator
// (it skipped the row's tiles, or took p = 1 on every visited key, padding
// past T included).
// A skipped tile is one that the reference's mask empties: its p would be 0,
// or exp(0) that a later alpha of 0 wipes, so skipping it changes nothing.
// The TMA kernel keeps m in log2 units (m * log2(e)); exp2 of the same
// differences gives the same p up to rounding.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;             // q rows per block
constexpr int kBK = 64;             // kv rows per tile (bf16 kernel)
constexpr int kThreads = 128;       // bf16 kernel: 4 warps x 16 q rows
constexpr int kBK32 = 32;           // kv rows per tile (f32 kernel)
constexpr int kThreads32 = 256;

struct Params {
  const void* q;  // [B, S, H, D]
  const void* k;  // [B, T, KH, D]
  const void* v;
  void* o;        // [B, S, H, D]
  const float* vmean;  // [B, KH, D] mean of v over T, or null: no row is empty
  int S, T, H, KH, group, causal, window;
  float scale;
};

// The mean of v for query row qp when that row has no allowed key, else null.
__device__ __forceinline__ const float* empty_row_mean(const float* vmean, int T, int window, int KH,
                                                       int b, int kvh, int D, int qp) {
  if (vmean == nullptr || qp < T + window - 1) return nullptr;
  return vmean + (static_cast<long long>(b) * KH + kvh) * D;
}

// kv tiles [lo, hi) that a q tile starting at q0 can attend to.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int bk, int& lo, int& hi) {
  const int nk = (p.T + bk - 1) / bk;
  hi = nk;
  if (p.causal) hi = min(nk, min(q0 + kBQ - 1, p.S - 1) / bk + 1);
  lo = p.window > 0 ? max(0, q0 - p.window + 1) / bk : 0;
}

__device__ __forceinline__ bool allowed(const Params& p, int qp, int kp) {
  bool ok = kp < p.T;
  if (p.causal) ok = ok && qp >= kp;
  if (p.window > 0) ok = ok && (qp - kp) < p.window;
  return ok;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [r0, r0 + 64) of a [rows, stride] bf16 matrix into shared
// memory with pitch D + 8, 16 bytes a thread; rows >= valid are zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int r0, int valid) {
  constexpr int kLd = D + 8, kVpr = D / 8;
  for (int i = threadIdx.x; i < 64 * kVpr; i += kThreads) {
    const int r = i / kVpr, c = (i % kVpr) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < valid) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_bf16(Params p) {
  constexpr int kLd = D + 8;  // shared-memory row pitch (16-byte pad: no bank conflicts)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBQ * kLd;
  __nv_bfloat16* sV = sK + kBK * kLd;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const int t4 = lane & 3;
  const long long q_stride = static_cast<long long>(p.H) * D;
  const long long kv_stride = static_cast<long long>(p.KH) * D;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           static_cast<long long>(b) * p.S * q_stride + static_cast<long long>(h) * D;
  const long long kv_off = static_cast<long long>(b) * p.T * kv_stride +
                           static_cast<long long>(h / p.group) * D;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_off;

  load_tile<D>(sQ, q, q_stride, q0, p.S);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  int lo, hi;
  kv_range(p, q0, kBK, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and sQ is visible)
    load_tile<D>(sK, k, kv_stride, k0, p.T);
    load_tile<D>(sV, v, kv_stride, k0, p.T);
    __syncthreads();

    // s = q k^T over this warp's 16 rows and the tile's 64 columns.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, sQ + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sK + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[n], a, bf[0], bf[1]);
        mma_bf16(s[n + 1], a, bf[2], bf[3]);
      }
    }

    // Scale, mask, online softmax in f32 (rows row0 and row0 + 8; the four
    // threads of a quad hold one row's 64 columns between them).
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + n * 8 + 2 * t4 + (e & 1);
        s[n][e] = allowed(p, row0 + (e >> 1) * 8, kp) ? s[n][e] * p.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_run[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += bf16(p) v: the accumulator layout of s is the A-operand
    // layout of the next product, 16 kv columns at a time.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, sV + (kk * 16 + (lane & 15)) * kLd + j * 8 + (lane >> 4) * 8);
        mma_bf16(acc[j], a, bf[0], bf[1]);
        mma_bf16(acc[j + 1], a, bf[2], bf[3]);
      }
    }
  }

  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) +
                     static_cast<long long>(b) * p.S * q_stride + static_cast<long long>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= p.S) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    const float* mean = empty_row_mean(p.vmean, p.T, p.window, p.KH, b, h / p.group, D, row);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t4;
      const __nv_bfloat162 val =
          mean != nullptr ? __floats2bfloat162_rn(mean[c], mean[c + 1])
                          : __floats2bfloat162_rn(acc[j][2 * r] / l, acc[j][2 * r + 1] / l);
      *reinterpret_cast<__nv_bfloat162*>(o + row * q_stride + c) = val;
    }
  }
}

// The f32 kernel: the same algorithm on the CUDA cores, with every tile
// and the accumulator in shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads32) flash_attention_f32(Params p) {
  constexpr int kLdK = D + 1, kLdS = kBK32 + 1;  // pads against bank conflicts
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [64][D]
  float* sK = sQ + kBQ * D;                     // [32][D + 1]
  float* sV = sK + kBK32 * kLdK;                // [32][D]
  float* sO = sV + kBK32 * D;                   // [64][D]
  float* sS = sO + kBQ * D;                     // [64][33]
  float* sM = sS + kBQ * kLdS;                  // [64] running max
  float* sL = sM + kBQ;                         // [64] running sum
  float* sA = sL + kBQ;                         // [64] this tile's alpha

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long q_stride = static_cast<long long>(p.H) * D;
  const long long kv_stride = static_cast<long long>(p.KH) * D;
  const float* q = static_cast<const float*>(p.q) +
                   static_cast<long long>(b) * p.S * q_stride + static_cast<long long>(h) * D;
  const long long kv_off = static_cast<long long>(b) * p.T * kv_stride +
                           static_cast<long long>(h / p.group) * D;
  const float* k = static_cast<const float*>(p.k) + kv_off;
  const float* v = static_cast<const float*>(p.v) + kv_off;

  for (int i = tid; i < kBQ * D; i += kThreads32) {
    const int r = i / D, c = i % D;
    sQ[i] = q0 + r < p.S ? q[(q0 + r) * q_stride + c] : 0.f;
    sO[i] = 0.f;
  }
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  int lo, hi;
  kv_range(p, q0, kBK32, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK32;
    __syncthreads();
    for (int i = tid; i < kBK32 * D; i += kThreads32) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.T;
      sK[r * kLdK + c] = in ? k[(k0 + r) * kv_stride + c] : 0.f;
      sV[i] = in ? v[(k0 + r) * kv_stride + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * kBK32; i += kThreads32) {
      const int r = i / kBK32, c = i % kBK32;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += sQ[r * D + d] * sK[c * kLdK + d];
      sS[r * kLdS + c] = allowed(p, q0 + r, k0 + c) ? dot * p.scale : kNegInf;
    }
    __syncthreads();
    if (tid < kBQ) {
      float mx = kNegInf;
      for (int c = 0; c < kBK32; ++c) mx = fmaxf(mx, sS[tid * kLdS + c]);
      const float m_new = fmaxf(sM[tid], mx);
      float sum = 0.f;
      for (int c = 0; c < kBK32; ++c) {
        const float e = expf(sS[tid * kLdS + c] - m_new);
        sS[tid * kLdS + c] = e;
        sum += e;
      }
      const float alpha = expf(sM[tid] - m_new);
      sA[tid] = alpha;
      sL[tid] = sL[tid] * alpha + sum;
      sM[tid] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * D; i += kThreads32) {
      const int r = i / D, c = i % D;
      float pv = 0.f;
      for (int j = 0; j < kBK32; ++j) pv += sS[r * kLdS + j] * sV[j * D + c];
      sO[i] = sO[i] * sA[r] + pv;
    }
  }
  __syncthreads();
  float* o = static_cast<float*>(p.o) + static_cast<long long>(b) * p.S * q_stride +
             static_cast<long long>(h) * D;
  for (int i = tid; i < kBQ * D; i += kThreads32) {
    const int r = i / D, c = i % D;
    if (q0 + r >= p.S) continue;
    const float* mean = empty_row_mean(p.vmean, p.T, p.window, p.KH, b, h / p.group, D, q0 + r);
    o[(q0 + r) * q_stride + c] = mean != nullptr ? mean[c] : sO[i] / fmaxf(sL[r], 1e-30f);
  }
}

// ---- The TMA + wgmma kernel (bf16, D in {64, 128, 256}) ------------------

constexpr int kTmaBK = 64;       // kv rows per tile: the reference's kv block
constexpr int kBoxBytes = 128;   // one TMA box row: 64 bf16, the 128-byte swizzle span
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // setmaxnreg, two consumer warpgroups

// Shared memory of one block, in bytes from a 1024-aligned base (the
// 128-byte swizzle repeats every 1024 bytes). A tile of R rows is D / 64
// boxes of R x 128 bytes, one after the other. kStages: the K/V ring's
// depth, as deep as 232,448 bytes allow up to 4.
template <int D, int kC>
struct TmaSmem {
  static constexpr int kStages = D < 256 ? 4 : (kC == 2 ? 2 : 3);
  static constexpr int kBoxes = D / 64;
  static constexpr int kQRows = 64 * kC;
  static constexpr int kQBox = kQRows * kBoxBytes;   // one 64-column box of the q tile
  static constexpr int kKVBox = kTmaBK * kBoxBytes;  // one 64-column box of a K or V tile
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;                // + stage * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;  // q_full, k_full[], v_full[], k_empty[], v_empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;          // room to align the base
  static_assert(kAlloc <= 232448, "a block may use 227 KB of shared memory");
};

struct TmaParams {
  void* o;  // [B, S, H, D] bf16
  int S, T, H, KH, group, causal, window;
  float scale_log2;  // scale * log2(e)
  const float* vmean;  // [B, KH, D] mean of v over T (the kEmpty instantiations only)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completion counts on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across this point.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define FA_ACC8(i)                                                                               \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]),         \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define FA_OUT8(i)                                                                               \
  "=f"(d[(i)]), "=f"(d[(i) + 1]), "=f"(d[(i) + 2]), "=f"(d[(i) + 3]), "=f"(d[(i) + 4]),         \
      "=f"(d[(i) + 5]), "=f"(d[(i) + 6]), "=f"(d[(i) + 7])

// d[32] = A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major): the
// first k16 step of S. d is written, not read: S starts from fresh registers.
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_OUT8(0), FA_OUT8(8), FA_OUT8(16), FA_OUT8(24)
      : "l"(a), "l"(b), "r"(0));
}

// d[32] += A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24)
      : "l"(a), "l"(b), "r"(1));
}

// d[64] += A (64 x 16, registers) * B (16 x 128, shared, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24), FA_ACC8(32), FA_ACC8(40), FA_ACC8(48),
        FA_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[32] += A (64 x 16, registers) * B (16 x 64, shared, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FA_ACC8
#undef FA_OUT8

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool allowed(const TmaParams& p, int qp, int kp) {
  bool ok = kp < p.T;
  if (p.causal) ok = ok && qp >= kp;
  if (p.window > 0) ok = ok && (qp - kp) < p.window;
  return ok;
}

// Whether kv tile kt needs the mask for the 64 rows from r0: the causal
// diagonal, the window's lower edge, or keys past T.
__device__ __forceinline__ bool tile_masked(const TmaParams& p, int r0, int kt) {
  const int k0 = kt * kTmaBK;
  bool m = k0 + kTmaBK > p.T;
  if (p.causal) m = m || k0 + kTmaBK - 1 > r0;
  if (p.window > 0) m = m || r0 + 63 - k0 >= p.window;
  return m;
}

// One online-softmax step on this warpgroup's 64 x 64 score tile, in place:
// the thread holds rows row_a and row_a + 8, columns k0 + 8j + 2 t4 + {0, 1}
// (wgmma's accumulator layout). On return s holds p (f32), m2 the running
// max in log2 units, l this thread's share of the running sum, alpha the
// factor for the accumulator.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m2)[2], float (&l)[2],
                                             float (&alpha)[2], const TmaParams& p, int row_a,
                                             int k0, int t4) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if constexpr (kMasked) {
      const int kp = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
      s[i] = allowed(p, row_a + ((i >> 1) & 1) * 8, kp) ? s[i] * p.scale_log2 : kNegInf;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if constexpr (!kMasked) mx[r] *= p.scale_log2;
    const float m_new = fmaxf(m2[r], mx[r]);
    alpha[r] = fast_exp2(m2[r] - m_new);
    m2[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = kMasked ? fast_exp2(s[i] - m2[r]) : fast_exp2(fmaf(s[i], p.scale_log2, -m2[r]));
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// S = Q K^T for one warpgroup on one K stage, issued (not waited for):
// D / 16 wgmmas of k16; a 128-byte swizzled row holds four k16 slices,
// 32 bytes apart, and the next 64 columns are the next box.
template <int D, int kC>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_wg, uint32_t k_st) {
  using L = TmaSmem<D, kC>;
  wgmma_fence();
  wgmma_ss_first(s, desc_sw128(q_wg, 16, 1024), desc_sw128(k_st, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss(s, desc_sw128(q_wg + (kk >> 2) * L::kQBox + off, 16, 1024),
             desc_sw128(k_st + (kk >> 2) * L::kKVBox + off, 16, 1024));
  }
  wgmma_commit();
}

// O += P V over one V stage, issued: V is [kv, d], the product's K by N
// with N contiguous, so B is read N-major (transposed); each k16 step is 16
// rows (2048 bytes) on, and the next 64 columns of d are the next box. At
// D 256 each k16 step is two m64n128k16 products, one a 128-column half of
// O (its accumulator layout is the first and the second 64 registers).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[16], uint32_t v_st) {
  hold(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTmaBK / 16; ++kk) {
    const uint32_t v_k = v_st + kk * 16 * kBoxBytes;
    if constexpr (D == 256) {
      wgmma_rs(*reinterpret_cast<float(*)[64]>(&o[0]), pa + 4 * kk, desc_sw128(v_k, kTmaBK * kBoxBytes, 1024));
      wgmma_rs(*reinterpret_cast<float(*)[64]>(&o[64]), pa + 4 * kk,
               desc_sw128(v_k + 2 * kTmaBK * kBoxBytes, kTmaBK * kBoxBytes, 1024));
    } else {
      wgmma_rs(o, pa + 4 * kk, desc_sw128(v_k, kTmaBK * kBoxBytes, 1024));
    }
  }
  wgmma_commit();
}

// p (f32, the accumulator layout) to four bf16 A fragments of m64k16.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[16], const float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

template <int D, int kC, bool kEmpty>
__global__ void __launch_bounds__(128 * (kC + 1), 1)
    flash_attention_tma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, TmaParams p) {
  using L = TmaSmem<D, kC>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  constexpr int kStages = L::kStages;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages, v_empty = k_empty + 8 * kStages;

  const int n_qt = gridDim.y;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * L::kQRows;  // heaviest causal tiles first
  const int h = blockIdx.x, b = blockIdx.z, kvh = h / p.group;
  // kv tiles [lo, hi) that this q tile can attend to.
  const int nk = (p.T + kTmaBK - 1) / kTmaBK;
  const int hi = p.causal ? min(nk, min(q0 + L::kQRows - 1, p.S - 1) / kTmaBK + 1) : nk;
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) / kTmaBK : 0;
  const int n_tiles = hi - lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 4 * kC);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * st, 4 * kC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index through a shuffle, so that the compiler sees it,
  // and every branch on it, as uniform across the warp.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every load -------------------------
    if constexpr (kC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int bx = 0; bx < L::kBoxes; ++bx) tma_load(sQ + bx * L::kQBox, &tq, q_full, 64 * bx, h, q0, b);
      // K and V of a stage are released apart: K once S is done, V once PV is.
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t released = ((i / kStages) + 1) & 1;  // the phase of round i / kStages - 1
        const int k0 = (lo + i) * kTmaBK;
        if (i >= kStages) mbar_wait(k_empty + 8 * st, released);
        mbar_expect_tx(k_full + 8 * st, L::kKVBytes);
#pragma unroll
        for (int bx = 0; bx < L::kBoxes; ++bx)
          tma_load(sK + st * L::kKVBytes + bx * L::kKVBox, &tk, k_full + 8 * st, 64 * bx, kvh, k0, b);
        if (i >= kStages) mbar_wait(v_empty + 8 * st, released);
        mbar_expect_tx(v_full + 8 * st, L::kKVBytes);
#pragma unroll
        for (int bx = 0; bx < L::kBoxes; ++bx)
          tma_load(sV + st * L::kKVBytes + bx * L::kKVBox, &tv, v_full + 8 * st, 64 * bx, kvh, k0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns q rows [q0 + 64 cw, q0 + 64 cw + 64) --
  if constexpr (kC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int r0 = q0 + 64 * cw;                    // the warpgroup's first row
  const int row_a = r0 + 16 * warp + (lane >> 2);  // this thread's rows: row_a, row_a + 8
  const uint32_t sQw = sQ + cw * 64 * kBoxBytes;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t pa[16];  // p of the current tile in bf16: four k16 A fragments
  float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];

  // The warp waits for a barrier's phase, and releases a buffer once all
  // its wgmma reads are done (one arrival a warp).
  auto wait = [&](uint32_t bar, uint32_t parity) {
    mbar_wait(bar, parity);
    __syncwarp();
  };
  auto release = [&](uint32_t bar) {
    if (lane == 0) mbar_arrive(bar);
    __syncwarp();
  };
  auto softmax = [&](float (&s)[32], int kt, auto masked_tag) {
    softmax_tile<decltype(masked_tag)::value>(s, m2, l, alpha, p, row_a, kt * kTmaBK, t4);
  };

  // Tile i, with the next tile's S issued first so that its softmax runs
  // while this tile's PV is in flight. The last tile (no next) and the
  // masked or unmasked softmax of the next tile are separate bodies, chosen
  // between tiles when no wgmma is in flight: a branch between a wgmma and
  // its wait makes ptxas serialise every wgmma of the kernel.
  auto tile = [&](int i, auto more_tag, auto masked_tag) {
    constexpr bool kMore = decltype(more_tag)::value;
    const int st = i % kStages, nx = (i + 1) % kStages;
    float s[32];
    if constexpr (kMore) {
      wait(k_full + 8 * nx, ((i + 1) / kStages) & 1);
      issue_qk<D, kC>(s, sQw, sK + nx * L::kKVBytes);
    }
    wait(v_full + 8 * st, (i / kStages) & 1);
    issue_pv<D>(o, pa, sV + st * L::kKVBytes);
    if constexpr (kMore) {
      wgmma_wait<1>();  // S of the next tile is done; PV may still run
      hold(s);
      release(k_empty + 8 * nx);
      softmax(s, lo + i + 1, masked_tag);
    }
    wgmma_wait<0>();
    hold(o);
    hold(pa);
    release(v_empty + 8 * st);
    if constexpr (kMore) {
      rescale<D>(o, alpha);
      pack_p(pa, s);
    }
  };

  if (n_tiles > 0) {
    {
      float s[32];
      wait(q_full, 0);
      wait(k_full, 0);
      issue_qk<D, kC>(s, sQw, sK);
      wgmma_wait<0>();
      hold(s);
      release(k_empty);
      if (tile_masked(p, r0, lo))
        softmax(s, lo, std::true_type{});
      else
        softmax(s, lo, std::false_type{});
      pack_p(pa, s);  // o is 0: no rescale
    }
    for (int i = 0; i + 1 < n_tiles; ++i) {
      if (tile_masked(p, r0, lo + i + 1))
        tile(i, std::true_type{}, std::true_type{});
      else
        tile(i, std::true_type{}, std::false_type{});
    }
    tile(n_tiles - 1, std::false_type{}, std::false_type{});
  }

  // Epilogue: the quad's partial sums, then rows < S straight from registers
  // (every thread reads its accumulators; only the stores are predicated);
  // a row with no allowed key takes the mean of v.
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) +
                       static_cast<long long>(b) * p.S * p.H * D + static_cast<long long>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_a + 8 * r;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + static_cast<long long>(min(row, p.S - 1)) * p.H * D + 2 * t4;
    const float* mean = nullptr;
    if constexpr (kEmpty) mean = empty_row_mean(p.vmean, p.T, p.window, p.KH, b, kvh, D, row);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      __nv_bfloat162 val = __floats2bfloat162_rn(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
      if constexpr (kEmpty) {
        const int c = 8 * j + 2 * t4;
        if (mean != nullptr) val = __floats2bfloat162_rn(mean[c], mean[c + 1]);
      }
      if (row < p.S) *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = val;
    }
  }
}

// ---- Host side of the TMA kernel -----------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kEncodeFailed = 100000;  // + the CUresult of a failed encode

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map over a contiguous bf16 [B, rows, heads, D] tensor, read in
// boxes of 64 columns x 1 head x box_rows rows x 1 batch element, 128-byte
// swizzled; rows past the end read as zeros.
int encode_map(CUtensorMap* map, const void* base, int B, int rows, int heads, int D, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads, row_bytes * heads * rows};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                          strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(res);
}

struct TmaMaps {
  CUtensorMap q, k, v;
};

int encode_maps(TmaMaps& m, const void* q, const void* k, const void* v, int B, int S, int T, int H,
                int KH, int D, int q_rows) {
  int err = encode_map(&m.q, q, B, S, H, D, q_rows);
  if (err == 0) err = encode_map(&m.k, k, B, T, KH, D, kTmaBK);
  if (err == 0) err = encode_map(&m.v, v, B, T, KH, D, kTmaBK);
  return err;
}

template <int D, int kC, bool kEmpty>
int launch_tma(const TmaMaps& m, const TmaParams& p, int B, cudaStream_t stream) {
  using L = TmaSmem<D, kC>;
  static bool attr_set = false;  // the shared-memory opt-in, once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tma<D, kC, kEmpty>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid(p.H, (p.S + L::kQRows - 1) / L::kQRows, B);
  flash_attention_tma<D, kC, kEmpty><<<grid, 128 * (kC + 1), L::kAlloc, stream>>>(m.q, m.k, m.v, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int B, int threads, size_t smem, cudaStream_t stream) {
  // Above 48 KB, dynamic shared memory must be asked for (idempotent).
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.H, B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(const Params& p, int B, int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch(flash_attention_bf16<D>, p, B, kThreads, 3 * 64 * (D + 8) * 2, stream);
  const size_t smem = sizeof(float) * (2 * kBQ * D + kBK32 * (D + 1) + kBK32 * D +
                                       kBQ * (kBK32 + 1) + 3 * kBQ);
  return launch(flash_attention_f32<D>, p, B, kThreads32, smem, stream);
}

}  // namespace

extern "C" {

int flash_attention_threads() { return kThreads; }

const char* flash_attention_error_string(int code) {
  if (code >= kEncodeFailed) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The mma.sync (bf16) and CUDA-core (f32) kernels. q [B, S, H, D], k/v
// [B, T, KH, D], o [B, S, H, D], all contiguous and of one dtype (bf16 when
// is_bf16, else f32); H % KH == 0; D in {32, 64, 128, 256}; rows 16-byte
// aligned. vmean: [B, KH, D] f32, the mean of v over T, given (non-null)
// exactly when window > 0 and T + window - 1 < S (some row has no key).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           const void* vmean, int B, int S, int T, int H, int KH, int D, int causal,
                           int window, float scale, int is_bf16, void* stream) {
  const Params p{q, k, v, o, static_cast<const float*>(vmean), S, T, H, KH, H / KH, causal, window,
                 scale};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dispatch<32>(p, B, is_bf16, s);
    case 64: return dispatch<64>(p, B, is_bf16, s);
    case 128: return dispatch<128>(p, B, is_bf16, s);
    case 256: return dispatch<256>(p, B, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The TMA + wgmma kernel: bf16, D in {64, 128, 256}, q_rows (q rows per block)
// 64 or 128, the rest as above. Encodes the three tensor maps, then
// launches.
int flash_attention_tma_launch(const void* q, const void* k, const void* v, void* o,
                               const void* vmean, int B, int S, int T, int H, int KH, int D,
                               int causal, int window, float scale, int q_rows, void* stream) {
  TmaMaps m;
  const int err = encode_maps(m, q, k, v, B, S, T, H, KH, D, q_rows);
  if (err != 0) return err;
  const TmaParams p{o, S, T, H, KH, H / KH, causal, window, scale * 1.4426950408889634f,
                    static_cast<const float*>(vmean)};
  const auto s = static_cast<cudaStream_t>(stream);
  // Shapes with rows that see no key take the kEmpty instantiations, so the
  // epilogue of the others is the one the serving path was tuned with.
  if (vmean != nullptr) {
    if (D == 256 && q_rows == 128) return launch_tma<256, 2, true>(m, p, B, s);
    if (D == 256 && q_rows == 64) return launch_tma<256, 1, true>(m, p, B, s);
    if (D == 128 && q_rows == 128) return launch_tma<128, 2, true>(m, p, B, s);
    if (D == 128 && q_rows == 64) return launch_tma<128, 1, true>(m, p, B, s);
    if (D == 64 && q_rows == 128) return launch_tma<64, 2, true>(m, p, B, s);
    if (D == 64 && q_rows == 64) return launch_tma<64, 1, true>(m, p, B, s);
  } else {
    if (D == 256 && q_rows == 128) return launch_tma<256, 2, false>(m, p, B, s);
    if (D == 256 && q_rows == 64) return launch_tma<256, 1, false>(m, p, B, s);
    if (D == 128 && q_rows == 128) return launch_tma<128, 2, false>(m, p, B, s);
    if (D == 128 && q_rows == 64) return launch_tma<128, 1, false>(m, p, B, s);
    if (D == 64 && q_rows == 128) return launch_tma<64, 2, false>(m, p, B, s);
    if (D == 64 && q_rows == 64) return launch_tma<64, 1, false>(m, p, B, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The host work that the TMA path adds to a call: encoding its three
// tensor maps, `iters` times (for timing it).
int flash_attention_tma_encode(const void* q, const void* k, const void* v, int B, int S, int T,
                               int H, int KH, int D, int q_rows, int iters) {
  TmaMaps m;
  for (int i = 0; i < iters; ++i) {
    const int err = encode_maps(m, q, k, v, B, S, T, H, KH, D, q_rows);
    if (err != 0) return err;
  }
  return 0;
}

}  // extern "C"
