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
// operations per byte. So the two products run on the tensor cores.
//
// What the design does about it: one block of four warps per (q tile of 64
// rows, q head, batch element); each warp owns 16 q rows. The kernel loops
// over 64-row k/v tiles staged in shared memory, from the window's edge up
// to the causal diagonal, so tiles above the diagonal are never read. The
// carry of the TPU grid becomes registers: QK^T and PV are mma.sync
// m16n8k16 bf16 products with f32 accumulators, fed by ldmatrix (.trans for
// V), and the online softmax runs on the accumulators in f32. GQA is
// indexing: q head h reads kv head h / group. Ragged edges (any S, any T,
// T != S) are masked in the kernel, not padded by the caller. There is no
// TMA or wgmma yet: loads are synchronous 16-byte copies (a later PR).
//
// f32 inputs take a second kernel with the same algorithm on the CUDA
// cores (no TF32), tiles of 64 q rows and 32 kv rows in shared memory.
//
// Semantics (src/repro/kernels/flash_attention/kernel.py): scores in f32,
// masked to -1e30; m_new = max(m, rowmax); alpha = exp(m - m_new);
// p = exp(s - m_new); l = l * alpha + rowsum(p); p is rounded to v's dtype
// before the PV product; acc = acc * alpha + pv; out = acc / max(l, 1e-30).
// A skipped tile is one that the reference's mask empties: its p would be 0,
// or exp(0) that a later alpha of 0 wipes, so skipping it changes nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  int S, T, H, KH, group, causal, window;
  float scale;
};

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
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 val =
          __floats2bfloat162_rn(acc[j][2 * r] / l, acc[j][2 * r + 1] / l);
      *reinterpret_cast<__nv_bfloat162*>(o + row * q_stride + j * 8 + 2 * t4) = val;
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
    if (q0 + r < p.S) o[(q0 + r) * q_stride + c] = sO[i] / fmaxf(sL[r], 1e-30f);
  }
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
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, S, H, D], k/v [B, T, KH, D], o [B, S, H, D], all contiguous and of
// one dtype (bf16 when is_bf16, else f32); H % KH == 0; D in {32, 64, 128,
// 256}; rows 16-byte aligned.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                           int T, int H, int KH, int D, int causal, int window, float scale,
                           int is_bf16, void* stream) {
  const Params p{q, k, v, o, S, T, H, KH, H / KH, causal, window, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dispatch<32>(p, B, is_bf16, s);
    case 64: return dispatch<64>(p, B, is_bf16, s);
    case 128: return dispatch<128>(p, B, is_bf16, s);
    case 256: return dispatch<256>(p, B, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
