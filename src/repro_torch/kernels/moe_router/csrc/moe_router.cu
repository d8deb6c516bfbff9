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
// exps, k argmax rounds) is small against the card's rate. At the
// deepseek-moe-16b width (T = 32,768, E = 64, k = 6) that is 8.4 MB in and
// 1.6 MB out, about 3 us at 3.35 TB/s.
//
// What the design does about it:
//   * the grid is cut from the rows, not from the dispatch groups: a block
//     of 256 threads takes 64 rows (E <= 64) or 32 (E <= 256), so 32,768
//     rows are 512 blocks, all resident at once on 132 SMs;
//   * a row per subgroup of L = 4 lanes (E <= 64) or 8 (E <= 256), so a
//     warp has 8 or 4 rows in flight. Lane q of a subgroup holds the
//     experts 4 (L i + q) + c as NV float4 loads (16 logits a lane at
//     E = 64), so the subgroup reads its row's bytes coalesced, 16 bytes a
//     lane, and the row never leaves registers. The max, the sum and each
//     of the k argmax rounds are a lane-local pass plus log2(L) shuffles
//     inside the subgroup (2 at E = 64, against 5 for a warp a row);
//   * ties: the lane-local pass walks its experts in ascending id with a
//     strict >, and the shuffle keeps the lower id among equal values:
//     what jnp.argmax and jax.lax.top_k do. The owner lane marks its pick
//     in a bit mask, which the next passes skip (the reference masks the
//     pick with -1e30, below every probability: the same order);
//   * counts: each block folds its picks into an int32 shared-memory
//     histogram for the (at most two, when group >= rows a block) groups
//     its rows fall in, and adds it to an int32 [G, E] scratch with integer
//     atomics (exact, order-free; rows of further groups, when the groups
//     are shorter than a block, go to the scratch directly). The last
//     block to finish, by a ticket, writes the scratch out as f32 (whole
//     numbers: exact) and zeroes it: one launch a call, no fill;
//   * the k picks of a row are kept in shared memory, and the subgroup
//     writes the row's gates and ids together at the end.
//
// Semantics (src/repro/kernels/moe_router/ref.py, router_ref):
//   p = exp(x - max(x)); probs = p / sum(p); k rounds of first-index
//   argmax + mask; gates = vals / max(sum(vals), 1e-9) with the k values
//   summed in pick order. Built with -fmad=false and IEEE division. The
//   softmax denominator is summed lane by lane then across the subgroup,
//   another order than the plain version's: probabilities can differ by
//   an ulp, which moves an id only where two experts are within an ulp.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kSlots = 2;  // groups a block folds in shared memory
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* logits;  // [T, E]
  long long T;
  int E, K, group, vec;  // vec: logits 16-byte aligned and E % 4 == 0
  float* gates;          // [T, K]
  int* ids;              // [T, K]
  float* counts;         // [G, E]
  int* counts_acc;       // [G * E] scratch, zero between calls
  unsigned* ticket;      // scratch, zero between calls
};

template <int L>
__device__ __forceinline__ float sub_max(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int L>
__device__ __forceinline__ float sub_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// L lanes a row, NV float4 chunks a lane (E <= 4 * L * NV).
template <int L, int NV>
__global__ void __launch_bounds__(kThreads, 4) moe_router_kernel(const Args a) {
  constexpr int kRows = kThreads / L;  // rows a block
  constexpr int kPerLane = 4 * NV;
  extern __shared__ int smem[];
  int* hist_s = smem;                                        // [kSlots][E]
  float* val_s = reinterpret_cast<float*>(hist_s + kSlots * a.E);  // [kRows][K]
  int* id_s = reinterpret_cast<int*>(val_s + kRows * a.K);         // [kRows][K]
  __shared__ bool is_last;

  const int E = a.E, K = a.K;
  for (int i = threadIdx.x; i < kSlots * E; i += kThreads) hist_s[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, q = lane % L;
  const int r = threadIdx.x / L;  // the block's row of this subgroup
  const long long first = static_cast<long long>(blockIdx.x) * kRows;
  const long long row = first + r;
  const bool live = row < a.T;
  const long long g_first = first / a.group;
  const long long grp = row / a.group;  // this row's dispatch group
  const long long slot = grp - g_first;  // its slot in the block's histogram

  // Load: lane q holds experts 4 (L i + q) + c, ascending in (i, c).
  // Experts past E read as -inf: they add nothing to the max or the sum
  // (exp gives 0) and, with probability 0 and an id above every real
  // expert's, are never picked (k <= E).
  float v[kPerLane];
  const float* x = a.logits + (live ? row : 0) * E;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int e0 = 4 * (L * i + q);
    if (a.vec) {
      float4 f = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (e0 < E) f = __ldg(reinterpret_cast<const float4*>(x + e0));
      v[4 * i] = f.x, v[4 * i + 1] = f.y, v[4 * i + 2] = f.z, v[4 * i + 3] = f.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[4 * i + c] = e0 + c < E ? __ldg(x + e0 + c) : -INFINITY;
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) m = fmaxf(m, v[j]);
  m = sub_max<L>(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    v[j] = expf(v[j] - m);
    s += v[j];
  }
  s = sub_sum<L>(s);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) v[j] = v[j] / s;

  // k rounds: the lane's best untaken value (ascending ids, strict >: the
  // lower id among equals), then the subgroup's, lower id first among
  // equal values; the owner marks it taken (the reference masks it with
  // -1e30, below every probability).
  float gsum = 0.f;  // the k picked probabilities, summed in pick order
  unsigned taken = 0u;
  for (int j = 0; j < K; ++j) {
    float bv = -INFINITY;
    int bl = 0;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t)
      if (!((taken >> t) & 1u) && v[t] > bv) {
        bv = v[t];
        bl = t;
      }
    const int mine = bv == -INFINITY ? 0x7fffffff : 4 * (L * (bl >> 2) + q) + (bl & 3);
    int bi = mine;
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi == mine) taken |= 1u << bl;
    gsum += bv;
    if (q == 0 && live) {
      val_s[r * K + j] = bv;
      id_s[r * K + j] = bi;
      if (slot < kSlots)
        atomicAdd(&hist_s[slot * E + bi], 1);
      else
        atomicAdd(&a.counts_acc[grp * E + bi], 1);
    }
  }
  // This block's groups into the [G, E] scratch and its ticket first, so
  // that the fence waits on the counts alone and the last block's
  // conversion overlaps the gate and id stores of the others.
  __syncthreads();
  const long long groups = (a.T + a.group - 1) / a.group;
  for (int i = threadIdx.x; i < kSlots * E; i += kThreads) {
    const long long g = g_first + i / E;
    if (hist_s[i] != 0 && g < groups) atomicAdd(&a.counts_acc[g * E + i % E], hist_s[i]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  auto write_rows = [&]() {
    if (!live) return;
    const float den = fmaxf(gsum, 1e-9f);
    for (int j = q; j < K; j += L) {
      a.gates[row * K + j] = val_s[r * K + j] / den;
      a.ids[row * K + j] = id_s[r * K + j];
    }
  };
  if (!is_last) {
    write_rows();
    return;
  }
  // The last block: every other block's counts reached the scratch before
  // its ticket (its fence), and these loads read L2 (__ldcg). Sixteen loads
  // a thread in flight (a 64 x 64 [G, E] in one round), then their stores.
  const long long total = groups * E;
  for (long long base = 0; base < total; base += 16 * kThreads) {
    int c[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      c[u] = i < total ? __ldcg(a.counts_acc + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      if (i < total) {
        a.counts[i] = static_cast<float>(c[u]);
        a.counts_acc[i] = 0;
      }
    }
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
  write_rows();  // the last block's own rows after the counts: they are the kernel's tail
}

template <int L, int NV>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int kRows = kThreads / L;
  const long long blocks = (a.T + kRows - 1) / kRows;
  const size_t smem = sizeof(int) * kSlots * a.E + sizeof(float) * kRows * a.K * 2;
  moe_router_kernel<L, NV><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int moe_router_threads() { return kThreads; }

const char* moe_router_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// logits [T, E] f32 -> gates [T, K] f32, ids [T, K] int32, counts
// [ceil(T / group), E] f32. Requires 1 <= K <= min(E, 32), E <= 256 and
// lanes == 4 for E <= 64, 8 above (the wrapper's rule). sync: [1 + G * E]
// int32 scratch (the ticket, then the count accumulator), zero on entry and
// left zero. vec: logits 16-byte aligned and E % 4 == 0.
int moe_router_launch(const void* logits, long long T, int E, int K, int group, int lanes,
                      int vec, void* gates, void* ids, void* counts, void* sync, void* stream) {
  if (E < 1 || E > 256 || K < 1 || K > kMaxK || K > E || group < 1 || lanes != (E <= 64 ? 4 : 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.logits = static_cast<const float*>(logits);
  a.T = T;
  a.E = E;
  a.K = K;
  a.group = group;
  a.vec = vec;
  a.gates = static_cast<float*>(gates);
  a.ids = static_cast<int*>(ids);
  a.counts = static_cast<float*>(counts);
  a.ticket = static_cast<unsigned*>(sync);
  a.counts_acc = static_cast<int*>(sync) + 1;
  const auto s = static_cast<cudaStream_t>(stream);
  if (E <= 16) return launch<4, 1>(a, s);
  if (E <= 32) return launch<4, 2>(a, s);
  if (E <= 64) return launch<4, 4>(a, s);
  if (E <= 128) return launch<8, 4>(a, s);
  return launch<8, 8>(a, s);
}

}  // extern "C"
