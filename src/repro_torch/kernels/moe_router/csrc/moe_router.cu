// moe_router: softmax -> top-k -> renormalised gates and per-group expert
// counts, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_router/kernel.py
// (moe_router_kernel, launched by moe_router_call), which takes a [TT, E]
// tile of logits in VMEM, picks the top k by k rounds of max + mask on the
// vector unit and folds a [1, E] histogram per tile.
//
// What bounds it here: bytes. Per token it reads E f32 logits and writes k
// f32 gates and k int32 ids; per group it writes E f32 counts. The work (E
// exps, k warp-wide argmax rounds of log2(32) shuffles each) is small
// against the card's rate. At the deepseek-moe-16b width (T = 32,768,
// E = 64, k = 6) that is 8.4 MB in and 1.6 MB out.
//
// What the design does about it: one warp per token row, each lane holding
// up to PER = ceil(E / 32) logits in registers, so a row is read once,
// coalesced, and never leaves registers. Max and sum are warp butterflies;
// each of the k rounds is a lane-local argmax then a butterfly argmax that
// keeps the LOWER expert id among equal values (what jnp.argmax and
// jax.lax.top_k do), and the owning lane masks its pick with -1e30. One
// block covers exactly one dispatch group of `group` rows, so its int32
// shared-memory histogram is that group's row of the [G, E] counts; it is
// written once, as f32, at the end (exact: integers). Rows past T are
// simply not processed (no padding rows to subtract).
//
// Semantics (src/repro/kernels/moe_router/ref.py, router_ref):
//   p = exp(x - max(x)); probs = p / sum(p); k rounds of first-index
//   argmax + mask; gates = vals / max(sum(vals), 1e-9) with the k values
//   summed in pick order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // 32 warps per block
constexpr float kNegInf = -1e30f;  // the reference kernel's mask value

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int PER>
__global__ void moe_router_kernel(const float* __restrict__ logits, long long T,
                                  int E, int K, int group,
                                  float* __restrict__ gates,
                                  int* __restrict__ ids,
                                  float* __restrict__ counts) {
  extern __shared__ int hist[];  // [E]
  for (int e = threadIdx.x; e < E; e += blockDim.x) hist[e] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * group;
  const long long last = min(first + group, T);

  for (long long row = first + warp; row < last; row += warps) {
    const float* x = logits + row * E;
    float v[PER];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = lane + 32 * i;
      v[i] = e < E ? x[e] : -INFINITY;
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = lane + 32 * i;
      v[i] = e < E ? expf(v[i] - m) : 0.f;
      s += v[i];
    }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = lane + 32 * i;
      v[i] = e < E ? v[i] / s : -INFINITY;  // lanes past E are never picked
    }

    float gsum = 0.f;  // the k picked probabilities, summed in pick order
    float my_val = 0.f;
    int my_id = 0;
    for (int j = 0; j < K; ++j) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < PER; ++i) {  // ascending ids: strict > keeps the lower
        if (lane + 32 * i < E && v[i] > bv) {
          bv = v[i];
          bi = lane + 32 * i;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (lane + 32 * i == bi) v[i] = kNegInf;
      gsum += bv;
      if (lane == j) {
        my_val = bv;
        my_id = bi;
      }
    }
    if (lane < K) {
      gates[row * K + lane] = my_val / fmaxf(gsum, 1e-9f);
      ids[row * K + lane] = my_id;
      atomicAdd(&hist[my_id], 1);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    counts[static_cast<long long>(blockIdx.x) * E + e] = static_cast<float>(hist[e]);
}

template <int PER>
int launch(const float* logits, long long T, int E, int K, int group,
           float* gates, int* ids, float* counts, int blocks,
           cudaStream_t stream) {
  const size_t shmem = static_cast<size_t>(E) * sizeof(int);
  moe_router_kernel<PER><<<blocks, kThreads, shmem, stream>>>(
      logits, T, E, K, group, gates, ids, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int moe_router_threads() { return kThreads; }

int moe_router_max_experts() { return 32 * 8; }

const char* moe_router_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// logits [T, E] f32 -> gates [T, K] f32, ids [T, K] int32, counts
// [ceil(T / group), E] f32. Requires 1 <= K <= min(E, 32), E <= 256.
int moe_router_launch(const void* logits, long long T, int E, int K,
                      int group, void* gates, void* ids, void* counts,
                      void* stream) {
  const long long blocks = (T + group - 1) / group;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(logits);
  auto* g = static_cast<float*>(gates);
  auto* i = static_cast<int*>(ids);
  auto* c = static_cast<float*>(counts);
  const int b = static_cast<int>(blocks);
  if (E <= 32) return launch<1>(x, T, E, K, group, g, i, c, b, s);
  if (E <= 64) return launch<2>(x, T, E, K, group, g, i, c, b, s);
  if (E <= 128) return launch<4>(x, T, E, K, group, g, i, c, b, s);
  return launch<8>(x, T, E, K, group, g, i, c, b, s);
}

}  // extern "C"
