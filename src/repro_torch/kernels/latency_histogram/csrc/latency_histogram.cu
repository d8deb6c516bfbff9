// latency_histogram: bucketize per-request latencies into log-spaced bins
// and fold them, weighted, into a grouped histogram, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/latency_histogram/kernel.py
// (latency_histogram_kernel, launched by latency_histogram_call). That
// kernel has no scatter on the TPU, so it folds each [TR] tile as a
// one-hot matmul onehot_g^T [G, TR] x onehot_b [TR, B] on the matrix unit
// into one [G, B] block carried across a sequential grid; the telemetry
// layer vmaps it over chunks for the [C, G, B] form.
//
// What bounds it here: bytes. Each row reads its latency, group and weight
// (12 B) once; each output cell is written once. At the static path's
// shape (100 M rows into [10,000, 10, 128]) that is 1.25 GB, 0.37 ms at
// 3.35 TB/s. What stood in the way was everything else a row cost: a
// double-precision log, an f32 shared-memory atomic (a compare-and-swap
// loop on this card) that the 32 lanes of a warp aimed at a handful of
// cells, a fill of the output and global atomics on every cell.
//
// What the design does about it:
//   * exact bins without a log a row. bin_of (../../csrc/log_bins.cuh, the
//     rule chunk_replay's fused histogram keeps) is monotone in lat over
//     every non-NaN float: each of its steps (fmaxf, the division by lo, the
//     log rounded to f32, the division by the span, the product and the
//     floor) rounds monotonically. So it is fixed by B - 1 thresholds: e_k,
//     the least f32 with bin_of(e_k) >= k, and the bin of a non-NaN lat is
//     the number of e_k <= lat. A set-up launch (thresholds_kernel, cached
//     by the wrapper per device, lo, hi and B) finds each e_k by
//     bisection over the bit patterns of [lo, hi], calling bin_of itself, so
//     the table equals the rule by construction; it also stores bin_of's
//     bin for NaN (fmaxf drops a NaN: bin 1 at lo >= 1e-30). The thresholds
//     lie in Eytzinger (breadth-first) order, so a row's bin is `depth`
//     branch-free compares in shared memory (7 for 128 bins), four rows'
//     searches interleaved, and the nodes of one level sit in distinct
//     banks. check_kernel holds the two rules against each other on all
//     2^32 bit patterns. Where the table does not fit beside the
//     histogram (a histogram of nearly the whole budget) the search reads
//     it from global memory instead, through L1;
//   * integer counts. Beside the f32 histogram the block keeps a u32 one
//     where it fits (before the table: it saves more); a step of a warp
//     whose weights are all 0 or 1 (a vote) adds 1 a kept row with a u32
//     shared-memory atomic, which is native, and the flush adds the counts
//     to the f32 sums. Lanes that collide are left to the hardware:
//     grouping them first with __match_any_sync measured slower on an
//     H100 at the static path's shape. Real weights, or a histogram with no room for
//     the counts, take the f32 path: lanes aiming at one cell are grouped
//     with __match_any_sync and one lane a group adds the group's weight
//     (summed in lane order), so colliding lanes do not repeat the
//     compare-and-swap loop;
//   * a block a chunk, stores instead of atomics, no fill. A persistent grid
//     (no more blocks than fit on the card at once) walks the work items: a
//     chunk, or a tile of one when the chunks are too few to fill the card
//     (ops.py::launch_shape). A block folds its chunk into its shared
//     histogram and writes the finished [G, B] slice with 16-byte stores,
//     zeroing its histogram as it reads it, into an output that nobody
//     fills. Only the split form (the flat [G, B] form over many rows, or
//     a few large chunks) zeroes the output first and adds its tiles with
//     global atomics;
//   * rows are read as 16-byte vectors (latency, group, weight: four rows a
//     lane) streamed past L1 (__ldcs), two vectors a lane in flight, with
//     scalar heads and tails for a chunk that starts off a 16-byte boundary
//     (rows_per_chunk = 997) and scalar loads where a pointer is not
//     aligned;
//   * the shared-memory layout (counts and table where they fit) is
//     decided here, and the dynamic shared-memory opt-in and the
//     occupancy query run once per device and layout, not on every call;
//     latency_histogram_resident gives the wrapper the blocks that fit on
//     the card at once, from which it sizes the grid;
//   * counts with 0/1 weights are integers, exact in f32 below 2**24 in any
//     order, so they repeat bit for bit and equal the plain version's;
//     real-valued weights are summed in another order (allclose);
//   * rows whose weight is 0 or whose group lies outside [0, G) are dropped.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "log_bins.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // vectors a lane has in flight
constexpr int kSetupThreads = 128;
constexpr int kCheckThreads = 256;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // the key of a dropped row

struct Args {
  const float* lat;
  const int* group;
  const float* weight;
  long long R;
  long long rows_per_chunk;
  long long span;  // rows of a tile (a multiple of 4)
  int tiles;       // tiles a chunk: 1 is the chunk form (stores)
  long long items;  // chunks * tiles
  int G;
  int B;
  int counts;  // a u32 count histogram beside the f32 one
  const float* table;  // [2^depth]: NaN's bin, then the thresholds
  int depth;
  int vec;  // lat, group and weight are 16-byte aligned
  float* hist;
};

// The bins of N values by the threshold table t (Eytzinger order, t[1 ..
// 2^depth - 1], padded with +inf; t[0] holds NaN's bin as int bits): the
// number of thresholds <= x, of which there are B - 1 = last. The N
// searches run interleaved, `depth` branch-free compares each.
template <int N>
__device__ __forceinline__ void table_bins(const float (&x)[N], const float* t, int depth,
                                           int last, int (&bin)[N]) {
  int i[N];
#pragma unroll
  for (int r = 0; r < N; ++r) i[r] = 1;
  for (int l = 0; l < depth; ++l) {
#pragma unroll
    for (int r = 0; r < N; ++r) i[r] = 2 * i[r] + (t[i[r]] <= x[r] ? 1 : 0);
  }
#pragma unroll
  for (int r = 0; r < N; ++r)
    bin[r] = x[r] == x[r] ? min(i[r] - (1 << depth), last) : __float_as_int(t[0]);
}

// Threshold k (1-based, in-order rank of a complete tree of 2^depth - 1
// nodes) sits at this Eytzinger index.
__device__ __forceinline__ int eytzinger_index(int k, int depth) {
  const int z = __ffs(k) - 1;
  return (k >> (z + 1)) + (1 << (depth - 1 - z));
}

__global__ void thresholds_kernel(float lo, float hi, float log_span, int B, int depth,
                                  float* __restrict__ table) {
  const int k = blockIdx.x * kSetupThreads + threadIdx.x + 1;
  if (k == 1) table[0] = __int_as_float(bin_of(__int_as_float(0x7fc00000), lo, hi, log_span, B));
  if (k >= (1 << depth)) return;
  float e = INFINITY;  // padding past the last threshold
  if (k <= B - 1) {
    // bin_of(lo) >= 1 and bin_of(hi) = B - 1 >= k, and positive floats are
    // ordered like their bit patterns: the least pattern in [lo, hi] whose
    // bin reaches k.
    unsigned a = __float_as_uint(lo), b = __float_as_uint(hi);
    while (a < b) {
      const unsigned m = a + (b - a) / 2;
      if (bin_of(__uint_as_float(m), lo, hi, log_span, B) >= k) b = m;
      else a = m + 1;
    }
    e = __uint_as_float(a);
  }
  table[eytzinger_index(k, depth)] = e;
}

// Counts the f32 bit patterns on which table_bins and bin_of disagree, and
// the least such pattern: out[0] += mismatches, out[1] = min(pattern).
__global__ void check_kernel(float lo, float hi, float log_span, int B, int depth,
                             const float* __restrict__ table, unsigned long long* out) {
  extern __shared__ float t_s[];
  for (int i = threadIdx.x; i < (1 << depth); i += kCheckThreads) t_s[i] = table[i];
  __syncthreads();
  const unsigned long long total = 1ull << 32;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * kCheckThreads;
  unsigned long long bad = 0, first = ~0ull;
  for (unsigned long long p = blockIdx.x * kCheckThreads + threadIdx.x; p < total; p += stride) {
    const float x[1] = {__uint_as_float(static_cast<unsigned>(p))};
    int bin[1];
    table_bins(x, t_s, depth, B - 1, bin);
    if (bin[0] != bin_of(x[0], lo, hi, log_span, B)) {
      ++bad;
      first = min(first, p);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    bad += __shfl_xor_sync(kFull, bad, off);
    first = min(first, __shfl_xor_sync(kFull, first, off));
  }
  if ((threadIdx.x & 31) == 0 && bad != 0) {
    atomicAdd(out, bad);
    atomicMin(out + 1, first);
  }
}

// One cell a lane (or kNone) with its weight, into the block's histograms
// through the f32 path: lanes aiming at one cell are grouped
// (__match_any_sync) and one lane a group adds the group's weight: its size
// where unit (every weight of the warp's step is 0 or 1), else the weights
// summed in lane order. Every lane of the warp calls it together.
__device__ __forceinline__ void fold_grouped(float* hist, unsigned* cnt, unsigned key, float w,
                                             bool unit) {
  const unsigned peers = __match_any_sync(kFull, key);
  const int lane = threadIdx.x & 31;
  const bool leader = key != kNone && lane == __ffs(peers) - 1;
  if (unit) {
    if (leader) {
      if (cnt != nullptr) atomicAdd(cnt + key, static_cast<unsigned>(__popc(peers)));
      else atomicAdd(hist + key, static_cast<float>(__popc(peers)));
    }
    return;
  }
  float s = 0.f;
  unsigned m = key != kNone ? peers : 0u;
  while (__any_sync(kFull, m != 0u)) {
    const int src = m != 0u ? __ffs(m) - 1 : lane;
    const float v = __shfl_sync(kFull, w, src);
    if (m != 0u) {
      s += v;
      m &= m - 1u;
    }
  }
  if (leader) atomicAdd(hist + key, s);
}

// Four rows a lane (those with `in` set), into the block's histograms. unit:
// every weight of the warp's step is 0 or 1 (the caller's vote). With u32
// counts a kept row of a unit step is one integer atomic, native in shared
// memory: the hardware resolves lanes that collide faster than grouping
// them first would. Otherwise (real weights, or no room for the counts)
// the rows take fold_grouped, since an f32 add in shared memory is a
// compare-and-swap loop that colliding lanes would repeat. Every lane of
// the warp calls it together.
__device__ __forceinline__ void fold_quad(const Args& a, float* hist, unsigned* cnt,
                                          const float* t, const float (&x)[4],
                                          const int (&g)[4], const float (&w)[4],
                                          const bool (&in)[4], bool unit) {
  int bin[4];
  table_bins(x, t, a.depth, a.B - 1, bin);
  unsigned key[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool keep = in[r] && w[r] != 0.f && g[r] >= 0 && g[r] < a.G;
    key[r] = keep ? static_cast<unsigned>(g[r] * a.B + bin[r]) : kNone;
  }
  if (unit && cnt != nullptr) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (key[r] != kNone) atomicAdd(cnt + key[r], 1u);
    return;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) fold_grouped(hist, cnt, key[r], w[r], unit);
}

__device__ __forceinline__ bool is_unit(float w) { return w == 0.f || w == 1.f; }

// Rows [begin, end) into the block's histograms; t: the threshold table.
__device__ __forceinline__ void fold_rows(const Args& a, float* hist, unsigned* cnt,
                                          const float* t, long long begin, long long end) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long vbeg = end, vend = end;  // the 16-byte vectors [vbeg, vend)
  if (a.vec) {
    vbeg = min((begin + 3) & ~3ll, end);
    vend = vbeg + ((end - vbeg) & ~3ll);
  }
  // Scalar rows: the head [begin, vbeg) and the tail [vend, end), at most
  // three each when vectors are on; every row otherwise.
  const long long head = vbeg - begin, rest = head + (end - vend);
  for (long long j0 = static_cast<long long>(warp) * 32; j0 < rest; j0 += kThreads) {
    const long long j = j0 + lane;
    const bool in = j < rest;
    const long long i = j < head ? begin + j : vend + (j - head);
    float x[4] = {0.f, 0.f, 0.f, 0.f}, w[4] = {0.f, 0.f, 0.f, 0.f};
    int g[4] = {0, 0, 0, 0};
    const bool one[4] = {in, false, false, false};
    if (in) {
      x[0] = __ldcs(a.lat + i);
      g[0] = __ldcs(a.group + i);
      w[0] = __ldcs(a.weight + i);
    }
    fold_quad(a, hist, cnt, t, x, g, w, one, __all_sync(kFull, is_unit(w[0])));
  }
  const long long v0 = vbeg >> 2, nv = (vend - vbeg) >> 2;
  const float4* lat4 = reinterpret_cast<const float4*>(a.lat) + v0;
  const int4* group4 = reinterpret_cast<const int4*>(a.group) + v0;
  const float4* weight4 = reinterpret_cast<const float4*>(a.weight) + v0;
  for (long long j0 = static_cast<long long>(warp) * 32; j0 < nv; j0 += kThreads * kUnroll) {
    float4 x[kUnroll], w[kUnroll];
    int4 g[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u * kThreads + lane;
      in[u] = j < nv;
      x[u] = w[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      g[u] = make_int4(0, 0, 0, 0);
      if (in[u]) {
        x[u] = __ldcs(lat4 + j);
        g[u] = __ldcs(group4 + j);
        w[u] = __ldcs(weight4 + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!__any_sync(kFull, in[u])) break;  // warp-uniform
      const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
      const int gs[4] = {g[u].x, g[u].y, g[u].z, g[u].w};
      const float ws[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
      const bool ins[4] = {in[u], in[u], in[u], in[u]};
      const bool unit = __all_sync(kFull, is_unit(ws[0]) && is_unit(ws[1]) && is_unit(ws[2]) &&
                                              is_unit(ws[3]));
      fold_quad(a, hist, cnt, t, xs, gs, ws, ins, unit);
    }
  }
}

// kSharedTable: the threshold table is copied into shared memory (the
// search then reads it with shared loads), else read from global memory.
template <bool kSharedTable>
__global__ void __launch_bounds__(kThreads) latency_histogram_kernel(Args a) {
  // [G * B] f32 sums, then (with counts) [G * B] u32 counts, then the table.
  extern __shared__ float smem[];
  const int cells = a.G * a.B, kept = (a.counts ? 2 : 1) * cells;
  float* sum_s = smem;
  unsigned* cnt_s = a.counts ? reinterpret_cast<unsigned*>(smem + cells) : nullptr;
  const float* t = a.table;
  if (kSharedTable) {
    float* t_s = smem + kept;
    for (int i = threadIdx.x; i < (1 << a.depth); i += kThreads) t_s[i] = a.table[i];
    t = t_s;
  }
  for (int i = threadIdx.x; i < kept; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  const bool split = a.tiles > 1;
  const bool vec_out = (cells & 3) == 0;  // slice c starts 16-byte aligned

  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const long long c = item / a.tiles, tile = item - c * a.tiles;
    const long long cbeg = c * a.rows_per_chunk;
    const long long cend = min(cbeg + a.rows_per_chunk, a.R);
    const long long begin = min(cbeg + tile * a.span, cend);
    fold_rows(a, sum_s, cnt_s, t, begin, min(begin + a.span, cend));
    __syncthreads();
    // The flush: each thread reads its cells (the sum plus the count),
    // writes them out and zeroes them for the next item. With 0/1 weights
    // the sums are 0 and a cell is its count.
    float* out = a.hist + c * cells;
    if (!split && vec_out) {
      float4* s4 = reinterpret_cast<float4*>(sum_s);
      uint4* c4 = reinterpret_cast<uint4*>(cnt_s);
      for (int i = threadIdx.x; i < cells / 4; i += kThreads) {
        float4 v = s4[i];
        s4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c4 != nullptr) {
          const uint4 n = c4[i];
          c4[i] = make_uint4(0u, 0u, 0u, 0u);
          v.x += static_cast<float>(n.x);
          v.y += static_cast<float>(n.y);
          v.z += static_cast<float>(n.z);
          v.w += static_cast<float>(n.w);
        }
        __stcs(reinterpret_cast<float4*>(out) + i, v);
      }
    } else {
      for (int i = threadIdx.x; i < cells; i += kThreads) {
        float v = sum_s[i];
        sum_s[i] = 0.f;
        if (cnt_s != nullptr) {
          v += static_cast<float>(cnt_s[i]);
          cnt_s[i] = 0u;
        }
        if (!split) out[i] = v;
        else if (v != 0.f) atomicAdd(out + i, v);
      }
    }
    __syncthreads();
  }
}

// Where a [G, B] histogram's parts go in a block's shared memory of
// `budget` bytes: the f32 sums, the u32 counts where they fit too, then the
// threshold table where it fits as well.
struct Layout {
  int counts = 0;
  bool shared_table = false;
  size_t smem = 0;
};

Layout layout(int G, int B, int depth, int budget) {
  const size_t cells = static_cast<size_t>(G) * B, table = sizeof(float) << depth;
  Layout l;
  l.counts = 2 * sizeof(float) * cells <= static_cast<size_t>(budget);
  l.smem = (l.counts ? 2 : 1) * sizeof(float) * cells;
  l.shared_table = l.smem + table <= static_cast<size_t>(budget);
  if (l.shared_table) l.smem += table;
  return l;
}

// Once per device: the dynamic shared-memory opt-in (the card's whole
// per-block budget, so no call needs another); once per device, kernel and
// size: the blocks that fit on the card at once.
struct DeviceState {
  int budget = 0;
  size_t resident_smem[2] = {0, 0};
  int resident[2] = {0, 0};
};
DeviceState g_state[kMaxDevices];

// The layout of a [G, B] histogram on the current device, and the blocks
// of its kernel that fit on the card at once.
int prepare(int G, int B, int depth, Layout& l, int& resident) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceState& s = g_state[dev];
  if (s.budget == 0) {
    int optin = 0;
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, latency_histogram_kernel<true>);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int room = optin - static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(latency_histogram_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, room);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(latency_histogram_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, room);
    if (err != cudaSuccess) return static_cast<int>(err);
    s.budget = room;
  }
  l = layout(G, B, depth, s.budget);
  if (l.smem > static_cast<size_t>(s.budget)) return static_cast<int>(cudaErrorInvalidValue);
  const int k = l.shared_table ? 1 : 0;
  if (s.resident_smem[k] != l.smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, l.shared_table ? latency_histogram_kernel<true> : latency_histogram_kernel<false>,
          kThreads, l.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    s.resident[k] = per_sm * sms;
    s.resident_smem[k] = l.smem;
  }
  resident = s.resident[k];
  return 0;
}

}  // namespace

extern "C" {

int latency_histogram_threads() { return kThreads; }

const char* latency_histogram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table: [2^depth] f32, written here: NaN's bin, then the B - 1 thresholds
// of bin_of(lo, hi, B) in Eytzinger order, padded with +inf.
int latency_histogram_thresholds_launch(float lo, float hi, int B, int depth, void* table,
                                        void* stream) {
  const int blocks = ((1 << depth) - 1 + kSetupThreads - 1) / kSetupThreads;
  thresholds_kernel<<<blocks, kSetupThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi, log_bin_span(lo, hi), B, depth, static_cast<float*>(table));
  return static_cast<int>(cudaGetLastError());
}

// out: [2] u64, set here to {0, ~0} and then to {mismatches, least
// mismatching pattern} between table_bin over table and bin_of, over all
// 2^32 f32 bit patterns.
int latency_histogram_check_launch(float lo, float hi, int B, int depth, const void* table,
                                   void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaError_t err = cudaMemsetAsync(o, 0, sizeof(*o), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(o + 1, 0xff, sizeof(*o), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) << depth;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  check_kernel<<<132 * 16, kCheckThreads, smem, s>>>(
      lo, hi, log_bin_span(lo, hi), B, depth, static_cast<const float*>(table), o);
  return static_cast<int>(cudaGetLastError());
}

// resident: [1] int, set here to the blocks of the kernel for a [G, B]
// histogram (depth: the table's levels) that fit on the current device at
// once: the most a launch should ask for.
int latency_histogram_resident(int G, int B, int depth, void* resident) {
  Layout l;
  return prepare(G, B, depth, l, *static_cast<int*>(resident));
}

// lat: [R] f32, group: [R] i32, weight: [R] f32; hist: [num_chunks, G, B]
// f32, not filled by the caller. Chunk c holds rows [c * rows_per_chunk,
// min((c + 1) * rows_per_chunk, R)); tile t of it the rows from t * span
// on, span of them at most. With tiles == 1 each chunk is folded by one
// block and stored; with tiles > 1 the output is zeroed here and the tiles
// add into it. blocks: the grid, which takes the (chunk, tile) items in
// turn. table: the thresholds_launch table (depth levels).
int latency_histogram_launch(const void* lat, const void* group, const void* weight,
                             long long R, long long rows_per_chunk, long long span,
                             int num_chunks, int tiles, int blocks, int G, int B,
                             const void* table, int depth, int vec, void* hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Layout l;
  int resident = 0;
  const int code = prepare(G, B, depth, l, resident);
  if (code != 0) return code;
  if (tiles > 1) {
    const cudaError_t err = cudaMemsetAsync(
        hist, 0, sizeof(float) * static_cast<size_t>(G) * B * num_chunks, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args a;
  a.lat = static_cast<const float*>(lat);
  a.group = static_cast<const int*>(group);
  a.weight = static_cast<const float*>(weight);
  a.R = R;
  a.rows_per_chunk = rows_per_chunk;
  a.span = span;
  a.tiles = tiles;
  a.items = static_cast<long long>(num_chunks) * tiles;
  a.G = G;
  a.B = B;
  a.counts = l.counts;
  a.table = static_cast<const float*>(table);
  a.depth = depth;
  a.vec = vec;
  a.hist = static_cast<float*>(hist);
  if (l.shared_table) latency_histogram_kernel<true><<<blocks, kThreads, l.smem, s>>>(a);
  else latency_histogram_kernel<false><<<blocks, kThreads, l.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
