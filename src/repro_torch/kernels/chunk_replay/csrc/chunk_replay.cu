// chunk_replay: one simulation chunk's whole request path on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/chunk_replay/kernel.py
// (chunk_replay_kernel, launched by chunk_replay_call). That kernel gathers
// hosts[keys] as a one-hot [TR, TKEY] x [TKEY, N] matmul over EVERY key
// tile, O(B*K*N) per chunk, because the TPU's matrix unit has no gather.
//
// What bounds it here: bytes, and for a chunk the latency chain. Each
// request reads its key, node, read flag, valid flag (10 B) and the N bytes
// of its replica row; the [N, N] RTT matrix is read once per block. There
// is no arithmetic worth counting. At the simulator's chunk (10,000
// requests) the bytes take about 0.05 us, so a call is as fast as its
// chain: the launch, two dependent loads (the request, then its map row),
// the reductions and the combine. Over a whole 100 M-request trace the map
// rows are random 5-byte reads: each brings a 32-byte L2 sector to the SM,
// about three times the bytes of the requests themselves.
//
// What the design does about it:
//   * one launch a call, combined in the kernel in a fixed order, so the
//     same inputs give the same bits from run to run. A chunk (up to
//     16,384 requests on up to 8 nodes; ops.py::launch_shape) is one
//     thread-block cluster of up to eight 512-thread blocks: each block
//     writes its partial row (busy[N] and lat_sum in f64; hits, reads and
//     count) into block 0's shared memory and adds its histogram there,
//     and block 0 sums the rows in block order after one cluster barrier.
//     A larger launch (the static path's whole trace) is 128-thread blocks,
//     no more than fit on the card at once, looping over the requests;
//     each block writes its row to scratch, fences and takes a ticket, and
//     the last block sums the rows in block order and resets the ticket.
//     Either way busy and lat_sum are the plain version's f64 sums,
//     re-associated, rounded to f32 once;
//   * four requests a thread a step, all loads issued before any use:
//     keys and nodes (and extra_ms) as 16-byte vectors, is_read and valid
//     as 4-byte words, streamed past L1 (__ldcs) so the map keeps the
//     cache; the next step's requests and map rows are in flight while
//     this step computes, and the first step's map rows while the block
//     sets up. With N <= 8 a map row is read as the 16-byte block that
//     holds it (and the next, for a row across the boundary) and the
//     replica set is a bit mask. Unaligned inputs (a view at an odd
//     offset) and the tail of B take scalar loads;
//   * with N <= 8 the block evaluates the latency expression once for every
//     (read or write, node, replica set), 2 N 2^N values, into a table in
//     shared memory, and a request is one lookup. Above, a request runs
//     the expression itself;
//   * busy accumulates per thread in f64 in shared memory (one slot per
//     node and thread: no race, no atomics); the N + 4 sums of a block are
//     fixed-order warp butterflies, then one pass over the warps;
//   * the optional [2N, num_bins] log-bin histogram: equal bins are merged
//     within a warp (__match_any_sync) before the shared-memory atomic,
//     and blocks add their counts with integer atomics (order-free): into
//     block 0's shared memory in a cluster, else into a scratch histogram
//     that the last block copies out and zeroes. The caller allocates the
//     output without a fill. The bin rule is bin_of in
//     ../../csrc/log_bins.cuh, shared with latency_histogram.cu;
//   * the latency expressions keep the reference's f32 op order
//     (src/repro/kernels/chunk_replay/ref.py, chunk_latency_ref and
//     chunk_replay_ref), built with -fmad=false and IEEE division;
//   * optional per-request outputs: the latency (after extra_ms and the
//     valid mask, the value bin_of bins) and the read-hit flag, written
//     only when the caller passes the buffers. The static-policy path
//     replays its whole trace in one launch and bins the latencies per
//     chunk with latency_histogram.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "log_bins.cuh"

namespace {

constexpr int kThreads = 128;  // a grid-stride block: 4 warps, <= 80 registers for 6 an SM
constexpr int kClusterThreads = 512;  // a block of a one-cluster launch
constexpr int kClusterMax = 8;  // blocks of a cluster (the portable bound)
// Launch modes (ops.py::launch_shape): blocks looping over the requests and
// combined by a last-block ticket; one thread-block cluster; the first,
// with the map packed to a byte a key first (a cooperative launch).
constexpr int kGrid = 0, kCluster = 1, kPacked = 2;
constexpr int kPer = 4;  // requests a thread takes per step
constexpr int kMaxNodes = 64;
constexpr int kNoLocal = 1;  // read_mode codes; 0 is "map"
constexpr int kIdeal = 2;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const uint8_t* hosts;  // [K, N] bool
  const int* keys;       // [B]
  const int* nodes;      // [B]
  const uint8_t* is_read;
  const uint8_t* valid;
  const float* rtt;    // [N, N]
  const float* extra;  // [B] or null
  long long B;
  int K, N, read_mode, master, num_bins;
  int vec;        // keys, nodes, extra, lat_out 16-byte and the flags 4-byte aligned
  int map_vec;  // hosts 16-byte aligned (and K * N < 2**31): rows read as 16-byte blocks
  float service, xfer_r, xfer_w, lo, hi;
  double* part_f;    // [grid, N + 1] scratch: busy, lat_sum per block
  int* part_i;       // [grid, 3] scratch: hits, reads, count per block
  int* hist_acc;     // [2N * num_bins] scratch, zero between calls
  unsigned* ticket;  // scratch, zero between calls
  uint8_t* packed;   // [K] scratch: hosts[k] as a bit mask (packed launches)
  unsigned* grid_bar;  // scratch, zero between calls (packed launches)
  float* out_f;      // [N + 1]: busy, lat_sum
  long long* out_i;  // [3]: hits, reads, count
  int* hist;         // [2N, num_bins] or null
  float* lat_out;    // [B] or null
  uint8_t* hit_out;  // [B] or null
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The four requests [i, i + 4): flags bit q marks request q below B, bit
// 4 + q a read, bit 8 + q a valid row.
struct Group {
  int key[kPer], node[kPer];
  float ex[kPer];
  unsigned flags;
};

__device__ __forceinline__ bool in_b(const Group& g, int q) { return (g.flags >> q) & 1u; }
__device__ __forceinline__ bool read_of(const Group& g, int q) { return (g.flags >> (4 + q)) & 1u; }
__device__ __forceinline__ bool valid_of(const Group& g, int q) { return (g.flags >> (8 + q)) & 1u; }

// Four bools (bytes of 0 or 1, as PyTorch stores them) of a little-endian
// word to bits: bit j is byte j. The product puts byte j's low bit at
// 24 + j, and no two partial products meet; the other bits of a byte (a
// byte past the end of the map, read with its word) are dropped first.
__device__ __forceinline__ unsigned bool_bits(uint32_t w) {
  return ((w & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void load_group(const Args& a, long long i, bool lane_in, Group& g) {
  if (lane_in && a.vec && i + kPer <= a.B) {
    const int4 k4 = __ldcs(reinterpret_cast<const int4*>(a.keys + i));
    const int4 n4 = __ldcs(reinterpret_cast<const int4*>(a.nodes + i));
    const unsigned r4 = __ldcs(reinterpret_cast<const unsigned*>(a.is_read + i));
    const unsigned v4 = __ldcs(reinterpret_cast<const unsigned*>(a.valid + i));
    float4 e4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a.extra != nullptr) e4 = __ldcs(reinterpret_cast<const float4*>(a.extra + i));
    g.key[0] = k4.x, g.key[1] = k4.y, g.key[2] = k4.z, g.key[3] = k4.w;
    g.node[0] = n4.x, g.node[1] = n4.y, g.node[2] = n4.z, g.node[3] = n4.w;
    g.ex[0] = e4.x, g.ex[1] = e4.y, g.ex[2] = e4.z, g.ex[3] = e4.w;
    g.flags = 0xfu | bool_bits(r4) << 4 | bool_bits(v4) << 8;
    return;
  }
  g.flags = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const bool in = lane_in && i + q < a.B;
    const long long j = in ? i + q : 0;
    g.key[q] = in ? __ldcs(a.keys + j) : 0;
    g.node[q] = in ? __ldcs(a.nodes + j) : 0;
    g.ex[q] = (in && a.extra != nullptr) ? __ldcs(a.extra + j) : 0.f;
    if (in) g.flags |= 1u << q | unsigned(a.is_read[j] != 0) << (4 + q) | unsigned(a.valid[j] != 0) << (8 + q);
  }
}

// Bit j of the result: hosts[k, j], for j < N.
template <int NB, int kMode>
__device__ __forceinline__ uint64_t row_mask(const Args& a, int k) {
  if constexpr (kMode == kPacked) {
    return a.packed[k];  // written by this launch before its grid barrier: a coherent load
  } else if constexpr (NB <= 8) {
    if (a.map_vec) {
      // The row's bytes [start, start + N) lie in the 16-byte block at
      // a16 and, for a row that crosses it (a quarter of the rows at N 5),
      // the next one: one load a row, rarely two. A block is read whole,
      // bytes past the map's end included (inside the allocation: the map
      // is 16-byte aligned, and allocations end on such a boundary); their
      // bits fall outside the row's. The wrapper sets map_vec only where
      // K * N < 2**31.
      const unsigned start = static_cast<unsigned>(k) * a.N;
      const unsigned a16 = start & ~15u, off = start & 15u;
      const uint4 c0 = __ldg(reinterpret_cast<const uint4*>(a.hosts + a16));
      uint4 c1 = make_uint4(0u, 0u, 0u, 0u);
      if (off + a.N > 16) c1 = __ldg(reinterpret_cast<const uint4*>(a.hosts + a16 + 16));
      const unsigned bits = bool_bits(c0.x) | bool_bits(c0.y) << 4 | bool_bits(c0.z) << 8 |
                            bool_bits(c0.w) << 12 | bool_bits(c1.x) << 16 | bool_bits(c1.y) << 20;
      return (bits >> off) & ((1u << a.N) - 1u);
    }
  }
  const long long start = static_cast<long long>(k) * a.N;
  uint64_t mask = 0;
  for (int j = 0; j < a.N; ++j)
    if (__ldg(a.hosts + start + j) != 0) mask |= 1ull << j;
  return mask;
}

// The replica sets of a group's four keys (none for ideal reads).
template <int NB, int kMode>
__device__ __forceinline__ void row_masks(const Args& a, const Group& g, uint64_t (&mask)[kPer]) {
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = min(max(g.key[q], 0), a.K - 1);
    mask[q] = (in_b(g, q) && a.read_mode != kIdeal) ? row_mask<NB, kMode>(a, k) : 0ull;
  }
}

// All blocks of a cooperative launch (all resident at once) meet here.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*reinterpret_cast<volatile unsigned*>(bar) < gridDim.x) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// The latency of a request from node x whose key's replica set is `mask`
// (the reference's f32 op order), and its read-hit flag; read_mode "map"
// or "no_local". With N <= 8 the kernel evaluates it once per (read, x,
// mask) into a table and looks requests up there: the same expression,
// so the same bits.
__device__ __forceinline__ float latency(const Args& a, const float* rtt_s, float rtt_max,
                                         uint64_t mask, int x, bool rd, bool& hit) {
  const int N = a.N, master = a.master;
  const float* rrow = rtt_s + x * N;
  const float* mrow = rtt_s + master * N;
  hit = ((mask >> x) & 1ull) != 0;
  const int owners = __popcll(mask);
  float nearest = INFINITY;
  float post = 0.f;
  for (int j = 0; j < N; ++j) {
    const bool h = ((mask >> j) & 1ull) != 0;
    if (h && !(a.read_mode == kNoLocal && j == x)) nearest = fminf(nearest, rrow[j]);
    if (h && j != master) post = fmaxf(post, mrow[j]);
  }
  if (!isfinite(nearest)) nearest = rtt_max;
  if (a.read_mode == kNoLocal) hit = false;
  const bool has_local = hit;
  const float r_lat = (a.service + nearest) + (has_local ? 0.f : a.xfer_r);
  const bool sole_local = hit && owners == 1;
  const float relay = (x == master) ? 0.f : rrow[master];
  float cost = relay + post;
  cost = cost + (cost > 0.f ? a.xfer_w : 0.f);
  const float w_lat = a.service + (sole_local ? 0.f : cost);
  return rd ? r_lat : w_lat;
}

// NB: an upper bound on N known at compile time (NB <= 8: the replica-set
// tables); T: threads a block. kMode kCluster: the grid is one thread-
// block cluster, combined through distributed shared memory; else partial
// rows in global scratch and a last-block ticket (kPacked: the map packed
// first, then a grid barrier).
template <int NB, int T, int kMode>
__global__ void __launch_bounds__(T, kMode == kCluster ? 1 : 6) chunk_replay_kernel(const Args a) {
  constexpr bool kTables = NB <= 8;
  constexpr int kW = T / 32;  // warps a block
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N;
  double* acc_s = reinterpret_cast<double*>(smem);          // [N][T] busy per thread
  float* rtt_s = reinterpret_cast<float*>(acc_s + N * T);  // [N][N]
  float* lat_s = rtt_s + N * N;  // [2][N][2^N]: latency by (read, node, replica set); tables only
  int* hist_s = reinterpret_cast<int*>(lat_s + (kTables ? 2 * N << N : 0));  // [2N * num_bins]
  __shared__ double part_s[kMaxNodes + 1];  // the block's busy[N] and lat_sum
  __shared__ int ipart_s[3];                // the block's hits, reads, count
  __shared__ double red_lat[kW];
  __shared__ int red_i[kW][3];
  __shared__ bool is_last;
  // Cluster launches: block 0 gathers every block's row here.
  __shared__ double gather_f[kMode == kCluster ? kClusterMax * (kMaxNodes + 1) : 1];
  __shared__ int gather_i[kMode == kCluster ? kClusterMax * 3 : 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nbins = a.num_bins;
  // Warp-aligned steps: every lane of a warp runs the same iterations (the
  // histogram's __match_any_sync needs the whole warp); lanes past the last
  // group load nothing. The first group's loads go out before the set-up.
  const long long groups = (a.B + kPer - 1) / kPer;
  const long long stride = static_cast<long long>(gridDim.x) * T;
  long long g0 = static_cast<long long>(blockIdx.x) * T + warp * 32;
  Group cur;
  load_group(a, (g0 + lane) * kPer, g0 + lane < groups, cur);
  const float rtt_v = tid < N * N ? a.rtt[tid] : 0.f;
  uint64_t mask[kPer];
  if constexpr (kMode == kPacked) {
    // hosts[k] to a byte, bit j for node j: a request then reads one byte,
    // and the hot keys' bytes stay in L1. Consecutive threads take
    // consecutive rows. The first group's requests are in flight meanwhile.
    const long long gstride = static_cast<long long>(gridDim.x) * T;
    for (long long k = static_cast<long long>(blockIdx.x) * T + tid; k < a.K; k += gstride) {
      const uint8_t* row = a.hosts + k * N;
      unsigned bits = 0;
      for (int j = 0; j < N; ++j) bits |= unsigned(row[j] != 0) << j;
      a.packed[k] = static_cast<uint8_t>(bits);
    }
    grid_barrier(a.grid_bar);
  }
  // The first group's map rows go out once its keys are in, before the
  // tables are built: their round trip overlaps the set-up.
  row_masks<NB, kMode>(a, cur, mask);

  for (int i = tid; i < N * N; i += T) rtt_s[i] = i == tid ? rtt_v : a.rtt[i];
  for (int j = 0; j < N; ++j) acc_s[j * T + tid] = 0.0;
  for (int i = tid; i < 2 * N * nbins; i += T) hist_s[i] = 0;
  __syncthreads();
  if constexpr (kMode == kCluster) cluster_arrive();  // this block's histogram is zeroed: waited on at the end
  float rtt_max = -INFINITY;  // every warp takes the max itself: no extra barrier
  for (int i = lane; i < N * N; i += 32) rtt_max = fmaxf(rtt_max, rtt_s[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rtt_max = fmaxf(rtt_max, __shfl_xor_sync(kFull, rtt_max, o));
  if constexpr (kTables) {
    if (a.read_mode != kIdeal) {
      for (int e = tid; e < 2 * N << N; e += T) {
        const int rx = e >> N;  // read * N + x
        bool h;
        lat_s[e] = latency(a, rtt_s, rtt_max, e & ((1 << N) - 1), rx % N, rx >= N, h);
      }
    }
    __syncthreads();
  }
  const float log_span = nbins > 0 ? log_bin_span(a.lo, a.hi) : 1.f;

  double lat_sum = 0.0;
  int hits = 0, reads = 0, count = 0;
  for (; g0 < groups; g0 += stride) {
    const long long i = (g0 + lane) * kPer;
    Group nxt;  // the next step's loads, in flight while this one computes
    load_group(a, (g0 + stride + lane) * kPer, g0 + stride + lane < groups, nxt);
    float lat[kPer];
    bool hit[kPer];
    int x[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const bool rd = read_of(cur, q), v = valid_of(cur, q);
      x[q] = min(max(cur.node[q], 0), N - 1);
      float l;
      if (a.read_mode == kIdeal) {
        l = a.service;
        hit[q] = true;
      } else if constexpr (kTables) {
        const unsigned m = static_cast<unsigned>(mask[q]);
        l = lat_s[(((rd ? N : 0) + x[q]) << N) | m];
        hit[q] = a.read_mode != kNoLocal && ((m >> x[q]) & 1u) != 0;
      } else {
        l = latency(a, rtt_s, rtt_max, mask[q], x[q], rd, hit[q]);
      }
      if (a.extra != nullptr) l = l + cur.ex[q];
      if (!v) l = 0.f;
      lat[q] = l;
      hit[q] = hit[q] && rd && v;
      lat_sum += static_cast<double>(l);
      acc_s[x[q] * T + tid] += static_cast<double>(l);  // this thread's own slot: no race
      hits += hit[q];
      reads += (rd && v);
      count += v;
    }
    if (a.lat_out != nullptr || a.hit_out != nullptr) {
      if (a.vec && in_b(cur, kPer - 1)) {
        if (a.lat_out != nullptr)
          *reinterpret_cast<float4*>(a.lat_out + i) = make_float4(lat[0], lat[1], lat[2], lat[3]);
        if (a.hit_out != nullptr)
          *reinterpret_cast<unsigned*>(a.hit_out + i) =
              unsigned(hit[0]) | unsigned(hit[1]) << 8 | unsigned(hit[2]) << 16 | unsigned(hit[3]) << 24;
      } else {
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          if (!in_b(cur, q)) continue;
          if (a.lat_out != nullptr) a.lat_out[i + q] = lat[q];
          if (a.hit_out != nullptr) a.hit_out[i + q] = hit[q] ? 1 : 0;
        }
      }
    }
    if (nbins > 0) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int bin = valid_of(cur, q) ? (2 * x[q] + (read_of(cur, q) ? 1 : 0)) * nbins +
                                               bin_of(lat[q], a.lo, a.hi, log_span, nbins)
                                         : -1;
        const unsigned peers = __match_any_sync(kFull, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist_s[bin], __popc(peers));
      }
    }
    cur = nxt;
    row_masks<NB, kMode>(a, cur, mask);  // the next step's map rows, in flight from here
  }

  // This block's partial row, in a fixed order: butterflies within warps,
  // then the warps in order; node c's plane is summed by one warp, lane l
  // taking threads l, l + 32, ... before the butterfly.
  lat_sum = warp_sum(lat_sum);
  hits = warp_sum(hits);
  reads = warp_sum(reads);
  count = warp_sum(count);
  if (lane == 0) {
    red_lat[warp] = lat_sum;
    red_i[warp][0] = hits;
    red_i[warp][1] = reads;
    red_i[warp][2] = count;
  }
  __syncthreads();
  for (int c = warp; c < N; c += kW) {
    double s = 0.0;
#pragma unroll
    for (int m = 0; m < T / 32; ++m) s += acc_s[c * T + lane + 32 * m];
    s = warp_sum(s);
    if (lane == 0) part_s[c] = s;
  }
  if (tid == T - 1) {
    double s = 0.0;
    for (int w = 0; w < kW; ++w) s += red_lat[w];
    part_s[N] = s;
  }
  if (tid < 3) {
    int s = 0;
    for (int w = 0; w < kW; ++w) s += red_i[w][tid];
    ipart_s[tid] = s;
  }
  __syncthreads();

  if constexpr (kMode == kCluster) {
    // Every block writes its row into block 0's shared memory and adds its
    // histogram to block 0's (integer atomics, order-free), then arrives;
    // block 0 waits for all, sums the rows in block order and writes the
    // outputs. The first wait (every histogram zeroed) was arrived at
    // after the set-up, so nothing stalls on it now.
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    cluster_wait();
    double* gf = cluster.map_shared_rank(gather_f, 0);
    int* gi = cluster.map_shared_rank(gather_i, 0);
    if (tid <= N) gf[rank * (N + 1) + tid] = part_s[tid];
    if (tid < 3) gi[rank * 3 + tid] = ipart_s[tid];
    if (rank != 0 && nbins > 0) {
      int* h0 = cluster.map_shared_rank(hist_s, 0);
      for (int i = tid; i < 2 * N * nbins; i += T)
        if (hist_s[i] != 0) atomicAdd(&h0[i], hist_s[i]);
    }
    cluster_arrive();
    if (rank != 0) return;  // nothing reads this block's shared memory
    cluster_wait();
    const int ranks = static_cast<int>(cluster.num_blocks());
    if (tid <= N) {
      double s = 0.0;
      for (int r = 0; r < ranks; ++r) s += gather_f[r * (N + 1) + tid];
      a.out_f[tid] = static_cast<float>(s);  // rounded to f32 once
    } else if (tid < N + 4) {
      long long s = 0;
      for (int r = 0; r < ranks; ++r) s += gather_i[r * 3 + tid - N - 1];
      a.out_i[tid - N - 1] = s;
    }
    for (int i = tid; i < 2 * N * nbins; i += T) a.hist[i] = hist_s[i];
  } else {
    if (tid <= N) a.part_f[static_cast<long long>(blockIdx.x) * (N + 1) + tid] = part_s[tid];
    if (tid < 3) a.part_i[blockIdx.x * 3 + tid] = ipart_s[tid];
    if (nbins > 0) {
      for (int i = tid; i < 2 * N * nbins; i += T)
        if (hist_s[i] != 0) atomicAdd(&a.hist_acc[i], hist_s[i]);
    }
    // The last block to finish combines the partial rows in block order.
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // Warp w takes columns w, w + kW, ...: lane l sums blocks l, l + 32,
    // ... of each (the warp's loads of a block row in flight together),
    // then a butterfly.
    constexpr int kCols = (NB + 4 + kW - 1) / kW;
    double fsum[kCols];
    long long isum[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) fsum[u] = 0.0, isum[u] = 0;
    const int blocks = gridDim.x;
    for (int b = lane; b < blocks; b += 32) {
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = warp + kW * u;
        if (c <= N) fsum[u] += __ldcg(a.part_f + static_cast<long long>(b) * (N + 1) + c);
        else if (c < N + 4) isum[u] += __ldcg(a.part_i + b * 3 + (c - N - 1));
      }
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = warp + kW * u;
      if (c >= N + 4) break;  // uniform
      if (c <= N) {
        const double s = warp_sum(fsum[u]);
        if (lane == 0) a.out_f[c] = static_cast<float>(s);  // rounded to f32 once
      } else {
        const long long s = warp_sum(isum[u]);
        if (lane == 0) a.out_i[c - N - 1] = s;
      }
    }
    if (nbins > 0) {
      // Sixteen loads a thread in flight, then their stores.
      const int total = 2 * N * nbins;
      for (int base = 0; base < total; base += 16 * T) {
        int vals[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int idx = base + u * T + tid;
          vals[u] = idx < total ? __ldcg(a.hist_acc + idx) : 0;
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int idx = base + u * T + tid;
          if (idx < total) {
            a.hist[idx] = vals[u];
            a.hist_acc[idx] = 0;
          }
        }
      }
    }
    if (tid == 0) {
      *a.ticket = 0u;
      if constexpr (kMode == kPacked) *a.grid_bar = 0u;  // every block has passed it
    }
  }
}

size_t smem_bytes(int N, int num_bins, int threads, bool tables) {
  return sizeof(double) * N * threads + sizeof(float) * N * N +
         (tables ? sizeof(float) * (2 * N << N) : 0) +
         (num_bins > 0 ? sizeof(int) * 2 * N * num_bins : 0);
}

// The dynamic shared-memory opt-in, once per instantiation and process (the
// card's whole per-block budget, so that no call needs another), and the
// blocks that fit on the card at once for a given shared-memory size: a
// grid-stride launch larger than that would run a second, partial wave.
template <int NB, int T, int kMode>
struct Launcher {
  static int budget;
  static size_t resident_smem;
  static int resident;

  static int prepare() {
    if (budget != 0) return 0;
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, chunk_replay_kernel<NB, T, kMode>);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int room = optin - static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(chunk_replay_kernel<NB, T, kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, room);
    if (err != cudaSuccess) return static_cast<int>(err);
    budget = room;
    return 0;
  }

  static int fits(size_t smem, int& blocks) {
    if (resident_smem != smem) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chunk_replay_kernel<NB, T, kMode>, T, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      resident = per_sm * sms;
      resident_smem = smem;
    }
    blocks = resident;
    return 0;
  }

  static int launch(const Args& a, int grid, cudaStream_t stream) {
    int err = prepare();
    if (err != 0) return err;
    const size_t smem = smem_bytes(a.N, a.num_bins, T, NB <= 8);
    if (smem > static_cast<size_t>(budget)) return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (kMode == kCluster) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(grid);
      cfg.blockDim = dim3(T);
      cfg.dynamicSmemBytes = smem;
      cfg.stream = stream;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = grid;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = static_cast<int>(cudaLaunchKernelEx(&cfg, chunk_replay_kernel<NB, T, kMode>, a));
      if (err != 0) return err;
    } else {
      int blocks = 0;  // a grid-stride launch: no more blocks than fit at once
      err = fits(smem, blocks);
      if (err != 0) return err;
      if (blocks > 0 && grid > blocks) grid = blocks;
      if constexpr (kMode == kPacked) {
        // Cooperative: the runtime guarantees every block is resident, which
        // the grid barrier needs (it refuses a grid that would not be).
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(grid);
        cfg.blockDim = dim3(T);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = stream;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeCooperative;
        attr[0].val.cooperative = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        err = static_cast<int>(cudaLaunchKernelEx(&cfg, chunk_replay_kernel<NB, T, kMode>, a));
        if (err != 0) return err;
      } else {
        chunk_replay_kernel<NB, T, kMode><<<grid, T, smem, stream>>>(a);
      }
    }
    return static_cast<int>(cudaGetLastError());
  }
};

template <int NB, int T, int kMode>
int Launcher<NB, T, kMode>::budget = 0;
template <int NB, int T, int kMode>
size_t Launcher<NB, T, kMode>::resident_smem = 0;
template <int NB, int T, int kMode>
int Launcher<NB, T, kMode>::resident = 0;

}  // namespace

extern "C" {

int chunk_replay_threads() { return kThreads; }

const char* chunk_replay_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch. mode kCluster: grid (at most kClusterMax blocks of
// kClusterThreads) is one thread-block cluster and N <= 8; else blocks of
// kThreads, at most as many as fit on the card at once (kPacked: N <= 8,
// packed: [K] u8 scratch). part_f: [grid, N+1] f64 and part_i: [grid, 3]
// i32 scratch; sync: [2 + 2N * num_bins] i32 scratch (the ticket, the grid
// barrier, then the histogram accumulator), zero on entry and left zero
// (untouched by a cluster launch); out_f: [N+1] f32
// (busy, lat_sum); out_i: [3] i64 (hits, reads, count); hist: [2N, bins]
// i32 (unused when num_bins == 0), written whole; extra, lat_out ([B] f32)
// and hit_out ([B] uint8) may be null. vec: keys, nodes, extra and lat_out
// are 16-byte aligned and is_read, valid and hit_out 4-byte aligned;
// map_vec: hosts is 16-byte aligned and K * N < 2**31.
int chunk_replay_launch(const void* hosts, const void* keys, const void* nodes,
                        const void* is_read, const void* valid, const void* rtt,
                        const void* extra, long long B, int K, int N, int read_mode,
                        int master, float service, float xfer_r, float xfer_w, float lo,
                        float hi, int num_bins, int vec, int map_vec, void* part_f,
                        void* part_i, void* sync, void* packed, void* out_f, void* out_i,
                        void* hist, void* lat_out, void* hit_out, int mode, int grid,
                        void* stream) {
  if (N < 1 || N > kMaxNodes || grid < 1 || mode < kGrid || mode > kPacked)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kGrid && N > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kCluster && grid > kClusterMax) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kPacked && packed == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.hosts = static_cast<const uint8_t*>(hosts);
  a.keys = static_cast<const int*>(keys);
  a.nodes = static_cast<const int*>(nodes);
  a.is_read = static_cast<const uint8_t*>(is_read);
  a.valid = static_cast<const uint8_t*>(valid);
  a.rtt = static_cast<const float*>(rtt);
  a.extra = static_cast<const float*>(extra);
  a.B = B;
  a.K = K;
  a.N = N;
  a.read_mode = read_mode;
  a.master = master;
  a.num_bins = num_bins;
  a.vec = vec;
  a.map_vec = map_vec;
  a.service = service;
  a.xfer_r = xfer_r;
  a.xfer_w = xfer_w;
  a.lo = lo;
  a.hi = hi;
  a.part_f = static_cast<double*>(part_f);
  a.part_i = static_cast<int*>(part_i);
  a.ticket = static_cast<unsigned*>(sync);
  a.grid_bar = static_cast<unsigned*>(sync) + 1;
  a.hist_acc = static_cast<int*>(sync) + 2;
  a.packed = static_cast<uint8_t*>(packed);
  a.out_f = static_cast<float*>(out_f);
  a.out_i = static_cast<long long*>(out_i);
  a.hist = static_cast<int*>(hist);
  a.lat_out = static_cast<float*>(lat_out);
  a.hit_out = static_cast<uint8_t*>(hit_out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == kCluster) return Launcher<8, kClusterThreads, kCluster>::launch(a, grid, s);
  if (mode == kPacked) return Launcher<8, kThreads, kPacked>::launch(a, grid, s);
  if (N <= 8) return Launcher<8, kThreads, kGrid>::launch(a, grid, s);
  return Launcher<kMaxNodes, kThreads, kGrid>::launch(a, grid, s);
}

}  // extern "C"
