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
// a few operations per byte, far below the card's 295. At the serving
// shape (16 sequences, an 8,192-slot cache, 8 kv heads of 128, G = 2) the
// B * KH = 128 (sequence, kv head) rows would fill fewer than the 132 SMs,
// and one block could not keep enough loads in flight for its row.
//
// What the design does about it: the cache axis is split (flash-decoding).
// Pass 1 gives each block one (sequence, kv head, group of up to 8 q heads)
// and one chunk of 256 cache positions; it reads only positions below
// min(length, T), as 16-byte loads with neighbouring lanes on neighbouring
// addresses, straight from the [B, T, KH, D] cache (no transpose copy), and
// writes the chunk's partial (m, l, acc) in f32. Blocks past the length
// return at once. Pass 2 merges the partials of a (sequence, q head).
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

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;  // cache positions per pass-1 block

struct Params {
  const void* q;        // [B, H, D]
  const void* k;        // [B, T, KH, D]
  const void* v;
  const int* lengths;   // [B]
  float* part_acc;      // [B, H, NS, D]
  float* part_ml;       // [B, H, NS, 2]
  void* o;              // [B, H, D]
  int T, H, KH, group, heads_per_block, num_splits;
  float scale;
};

// Cache positions a sequence's block reads (see the note above).
__device__ __forceinline__ int read_len(const Params& p, int b) {
  const int len = p.lengths[b];
  return len > 0 ? min(len, p.T) : p.T;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16_rn(x); }
// p as the PV product sees it: rounded to the cache's dtype.
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* src, bool valid, float out[EPL]) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < EPL / kVec; ++u) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (valid) raw = *reinterpret_cast<const uint4*>(src + u * kVec);
    const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[u * kVec + e] = to_f(el[e]);
  }
}

// Pass 1. Grid (split, kv head x head group, batch). GT: q heads a block
// holds in registers (the actual count may be smaller).
template <typename T, int D, int GT>
__global__ void __launch_bounds__(kThreads) decode_split(Params p) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowL = D / kVec < 32 ? D / kVec : 32;  // lanes per cache row
  constexpr int kEpl = D / kRowL;                       // elements per lane
  constexpr int kWRows = 32 / kRowL;                    // rows per warp at once
  __shared__ float s_p[GT][kChunk];
  __shared__ float s_acc[kWarps][GT][D];

  const int split = blockIdx.x, b = blockIdx.z;
  const int groups = (p.group + p.heads_per_block - 1) / p.heads_per_block;
  const int kvh = blockIdx.y / groups;
  const int h0 = kvh * p.group + (blockIdx.y % groups) * p.heads_per_block;
  const int nh = min(p.heads_per_block, kvh * p.group + p.group - h0);
  const int len = read_len(p, b);
  const float scale = p.lengths[b] > 0 ? p.scale : 0.f;  // 0: all positions masked
  const int p0 = split * kChunk;
  if (p0 >= len) return;  // nothing valid in this chunk; pass 2 skips it
  const int n = min(kChunk, len - p0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / kRowL, col = (lane % kRowL) * kEpl;
  const long long kv_stride = static_cast<long long>(p.KH) * D;
  const long long base = (static_cast<long long>(b) * p.T + p0) * kv_stride +
                         static_cast<long long>(kvh) * D + col;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;

  float q[GT][kEpl];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const T* qs = static_cast<const T*>(p.q) + (static_cast<long long>(b) * p.H + h0 + g) * D + col;
#pragma unroll
    for (int e = 0; e < kEpl; ++e) q[g][e] = g < nh ? to_f(qs[e]) : 0.f;
  }

  // Scores: each warp takes kWRows rows at a time; the loop bound is
  // uniform over the warp, so every lane reaches every shuffle.
  for (int r0 = warp * kWRows; r0 < n; r0 += kWarps * kWRows) {
    const int r = r0 + sub;
    float kf[kEpl];
    load_row<T, kEpl>(k + r * kv_stride, r < n, kf);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kEpl; ++e) dot += q[g][e] * kf[e];
#pragma unroll
      for (int off = kRowL / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (r < n && lane % kRowL == 0) s_p[g][r] = dot * scale;
    }
  }
  __syncthreads();

  // Chunk max and sum per q head (one warp per head); p overwrites s.
  for (int g = warp; g < nh; g += kWarps) {
    float mx = kNegInf;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, s_p[g][r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float e = expf(s_p[g][r] - mx);
      s_p[g][r] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      float* ml = p.part_ml + ((static_cast<long long>(b) * p.H + h0 + g) * p.num_splits + split) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  __syncthreads();

  // acc = sum_r round(p[r]) v[r], lanes over D, rows over the warps.
  float acc[GT][kEpl];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < kEpl; ++e) acc[g][e] = 0.f;
  for (int r0 = warp * kWRows; r0 < n; r0 += kWarps * kWRows) {
    const int r = r0 + sub;
    float vf[kEpl];
    load_row<T, kEpl>(v + r * kv_stride, r < n, vf);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float pg = (r < n && g < nh) ? round_as(s_p[g][r], T()) : 0.f;
#pragma unroll
      for (int e = 0; e < kEpl; ++e) acc[g][e] += pg * vf[e];
    }
  }
  // Fold the warp's row groups, then the warps, in a fixed order.
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < kEpl; ++e) {
#pragma unroll
      for (int off = kRowL; off < 32; off <<= 1) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      if (lane < kRowL) s_acc[warp][g][col + e] = acc[g][e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_acc[w][g][d];
    p.part_acc[((static_cast<long long>(b) * p.H + h0 + g) * p.num_splits + split) * D + d] = total;
  }
}

// Pass 2. Grid (q head, batch), one thread per element of the head.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine(Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int ns = (read_len(p, b) + kChunk - 1) / kChunk;
  const long long row = static_cast<long long>(b) * p.H + h;
  const float* ml = p.part_ml + row * p.num_splits * 2;
  const float* pa = p.part_acc + row * p.num_splits * D + d;
  float m = kNegInf;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float w = expf(ml[2 * s] - m);
    l += w * ml[2 * s + 1];
    acc += w * pa[static_cast<long long>(s) * D];
  }
  from_f(acc / fmaxf(l, 1e-30f), static_cast<T*>(p.o) + row * D + d);
}

template <typename T, int D>
int dispatch(Params p, int B, cudaStream_t stream) {
  const int gt = p.group <= 2 ? 2 : 8;
  p.heads_per_block = gt;
  const dim3 grid1(p.num_splits, p.KH * ((p.group + gt - 1) / gt), B);
  if (gt == 2)
    decode_split<T, D, 2><<<grid1, kThreads, 0, stream>>>(p);
  else
    decode_split<T, D, 8><<<grid1, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine<T, D><<<dim3(p.H, B), D, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_dim(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch<T, 32>(p, B, stream);
    case 64: return dispatch<T, 64>(p, B, stream);
    case 128: return dispatch<T, 128>(p, B, stream);
    case 256: return dispatch<T, 256>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int flash_decode_threads() { return kThreads; }

int flash_decode_chunk() { return kChunk; }

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, H, D], k/v [B, T, KH, D], lengths [B] int32, part_acc
// [B, H, NS, D] f32, part_ml [B, H, NS, 2] f32 with NS = ceil(T / chunk),
// o [B, H, D]; one dtype (bf16 when is_bf16, else f32) for q, k, v and o;
// D in {32, 64, 128, 256}; rows 16-byte aligned.
int flash_decode_launch(const void* q, const void* k, const void* v, const void* lengths,
                        void* part_acc, void* part_ml, void* o, int B, int T, int H, int KH, int D,
                        float scale, int is_bf16, void* stream) {
  Params p{q, k, v, static_cast<const int*>(lengths), static_cast<float*>(part_acc),
           static_cast<float*>(part_ml), o, T, H, KH, H / KH, 0,
           (T + kChunk - 1) / kChunk, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? by_dim<__nv_bfloat16>(p, B, D, s) : by_dim<float>(p, B, D, s);
}

}  // extern "C"
