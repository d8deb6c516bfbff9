// capacity_projection: trim a replica plan to per-node byte budgets on
// Hopper (sm_90a).
//
// Not the port of a Pallas kernel: the reference projects with three
// chained stable sorts in XLA (src/repro/core/costmodel.py,
// project_capacity); the plain version here (ref.py) sorts 50 M composite
// int64 keys at K = 10 M, N = 5. This kernel selects instead of sorting.
//
// Semantics (ref.py, project_capacity_ref). Per node j, the owned entries
// are ordered by v = (rank(f) << 1) | !held, then key id, where rank orders
// like -f (-0.0 equal to 0.0) and held = owners & hosts; an entry is
// admitted iff cum <= budget[j], cum the f64 sum of the f32 sizes of the
// owned entries at or before it in that order. Sizes are >= 0, so cum never
// falls and the admitted entries are a prefix of the order: the first entry
// with !(cum <= budget) is the node's cut point (v*, k*). Outputs:
// projected = owned & admitted, evicted = held & !admitted, rejected =
// owned & !hosts & !admitted. The f64 sums are exact in any order while a
// node's sizes span fewer than 53 bits, so sums taken by bins, tiles and
// atomics equal the plain version's prefix sums bit for bit.
//
// What bounds it: bytes. The least the stage can move is owners, hosts
// (1 B), f (4 B) and object_bytes (4 B a key) read once and the two output
// planes that callers read (projected, evicted) written once: 8 K N + 4 K
// bytes, 440 MB or 0.131 ms at 3.35 TB/s for K = 10 M, N = 5. The kernel
// also writes rejected, K N bytes more. This design reads the inputs five
// times (three select levels, the tie pass, the final pass).
//
// What the design does about it. The inputs are read in place, [K, N]
// row-major, a tile of tk keys at a time, staged in shared memory with
// 16-byte cp.async copies. The launch sequence is fixed (a memset and nine
// kernels) and never waits for the host:
//   1. three histogram passes, one a digit of v (11 bits each: bits 22-32,
//      11-21, 0-10), sum the f64 bytes of each node's owned entries whose
//      higher digits equal the prefix found so far. A block bins the
//      entries of a group of up to five nodes into [G, 2048] bins in shared
//      memory (80 KB at G = 5, two blocks an SM) and adds its nonzero bins
//      to the level's global histogram with atomics. A tie group of
//      millions of entries falls into one bin, and an f64 add to shared
//      memory is a compare-and-swap loop on this card, so each thread
//      first folds its entries into two register slots (bin, bytes),
//      evicting the smaller sum on a miss: a heavy bin stays in registers
//      and reaches shared memory once a thread (four slots, or eight, cost
//      more compares than the misses they save on the benchmark's ticks).
//      Few warps fit beside the bins, so a thread issues the loads of four
//      entries before it uses any of them;
//   2. after each pass one block a node scans its 2048 bins and takes the
//      first bin whose running total crosses the budget: the next digit of
//      v*, and the bytes ordered before it. A node whose total fits admits
//      every owned entry ("all");
//   3. the tie pass sums, a tile a node, the bytes of the entries with
//      v == v* (key order is tile order), and one block a node scans the
//      tile sums to the tile where the running total crosses;
//   4. the final pass decides every entry against its node's (v*, tile);
//      in the crossing tile the block scans the tie entries in key order
//      to find k*. It writes the three planes with 16-byte stores.
// Scratch is O(N x 2048 x 3 + N x tiles) doubles; no [K, N] temporary.
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kBits = 11;               // bits of v a select level
constexpr int kBins = 1 << kBits;       // bins a node and level
constexpr int kLevels = 3;              // 3 x 11 = the 33 bits of v
constexpr int kMaxGroup = 5;            // nodes a histogram block bins
constexpr int kHistWarps = 16;          // warps a histogram block aims at (two blocks an SM)
constexpr int kTieWarps = 10;           // warps a tie block aims at
constexpr int kSlots = 2;               // register slots a thread
constexpr int kBatch = 4;               // entries whose loads a thread issues together
constexpr int kScanThreads = kBins / 2; // a scan block: two bins a thread
constexpr int kFinalThreads = 256;
constexpr int kTileBudget = 32 * 1024;  // shared bytes of a staged tile
constexpr int kMaxSmem = 227 * 1024;    // an H100 block's limit
constexpr int kMaxNodes = 1024;

// Per node, in scratch (zeroed by the launch's memset).
struct NodeState {
  unsigned long long prefix;  // v's digits found so far; v* after the last level
  double below;               // bytes of the owned entries ordered before the prefix
  double below_tile;          // ... and of the tie entries in tiles before the crossing one
  int all;                    // 1: the budget holds every owned entry
  int tile;                   // the tile where the tie group crosses the budget
};

struct Inputs {
  const uint8_t* owners;
  const uint8_t* hosts;
  const float* f;
  const float* obj;
  const float* budget;
  int K, N, tk, tiles;
};

__host__ __device__ __forceinline__ int pad16(int b) { return (b + 15) & ~15; }

// Keys a tile: the final pass keeps 7 N + 4 bytes a key in shared memory.
int tile_keys(int N) {
  const int tk = kTileBudget / (7 * N + 4) / 16 * 16;
  return tk < 16 ? 16 : (tk > 1024 ? 1024 : tk);
}

__host__ __device__ __forceinline__ int tile_bytes(int tk, int N) {
  return pad16(tk * N * 4) + pad16(tk * 4) + 2 * pad16(tk * N);
}

struct Tile {
  float* f;      // [tk, N]
  float* obj;    // [tk]
  uint8_t* own;  // [tk, N]; projected after the final pass
  uint8_t* host; // [tk, N]; evicted after the final pass
};

__device__ __forceinline__ Tile tile_at(uint8_t* p, int tk, int N) {
  Tile t;
  t.f = reinterpret_cast<float*>(p);
  p += pad16(tk * N * 4);
  t.obj = reinterpret_cast<float*>(p);
  p += pad16(tk * 4);
  t.own = p;
  t.host = p + pad16(tk * N);
  return t;
}

// n bytes from global src to shared dst (16-byte aligned): 16-byte cp.async
// copies while src is 16-byte aligned, byte by byte otherwise and for the
// tail.
__device__ __forceinline__ void load_bytes(void* dst_, const void* src_, int n) {
  uint8_t* dst = static_cast<uint8_t*>(dst_);
  const uint8_t* src = static_cast<const uint8_t*>(src_);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n >> 4;
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    for (int i = threadIdx.x; i < nv; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 16 * i),
                   "l"(src + 16 * i)
                   : "memory");
    done = nv << 4;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// n bytes from shared src (16-byte aligned) to global dst, the same way.
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint8_t* src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nv = n >> 4;
    for (int i = threadIdx.x; i < nv; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = nv << 4;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ int keys_of(const Inputs& in, int tile) {
  return static_cast<int>(min(static_cast<long long>(in.tk),
                              in.K - static_cast<long long>(tile) * in.tk));
}

// Tile `tile` (every input) into t; returns after a barrier.
__device__ __forceinline__ void stage(const Tile& t, const Inputs& in, int tile) {
  const long long k0 = static_cast<long long>(tile) * in.tk, e0 = k0 * in.N;
  const int nk = keys_of(in, tile), ne = nk * in.N;
  load_bytes(t.f, in.f + e0, ne * 4);
  load_bytes(t.obj, in.obj + k0, nk * 4);
  load_bytes(t.own, in.owners + e0, ne);
  load_bytes(t.host, in.hosts + e0, ne);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// v: rank(f) in bits 1-32 (orders like -f, -0.0 equal to 0.0), !held in bit 0.
__device__ __forceinline__ unsigned long long order_value(float f, bool held) {
  const int bits = __float_as_int(f == 0.0f ? 0.0f : f);
  const int ordered = bits < 0 ? bits ^ 0x7FFFFFFF : bits;  // orders like f
  const uint32_t rank = 0x7FFFFFFFu - static_cast<uint32_t>(ordered);
  return (static_cast<unsigned long long>(rank) << 1) | (held ? 0ull : 1ull);
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Exclusive prefix sum of x over the block (whole warps); tmp holds 32
// doubles. Every thread of the block calls it.
__device__ double block_exclusive_sum(double x, double* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  double incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  double ex = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) ex = 0.0;
  __syncthreads();  // tmp is free: an earlier call has read it
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    double w = lane < warps ? tmp[lane] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    double we = __shfl_up_sync(0xffffffffu, w, 1);
    if (lane == 0) we = 0.0;
    if (lane < warps) tmp[lane] = we;
  }
  __syncthreads();
  return tmp[warp] + ex;
}

// A thread's (bin, bytes) slots in registers; a miss adds the slot with
// the smallest sum to the shared histogram h and takes its place.
struct Slots {
  int bin[kSlots];
  double sum[kSlots];

  __device__ Slots() {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      bin[s] = -1;
      sum[s] = -1.0;  // below every sum: empty slots are taken first
    }
  }

  __device__ __forceinline__ void add(int b, double bytes, double* h) {
    bool hit = false;
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (bin[s] == b) {
        sum[s] += bytes;
        hit = true;
      }
    if (hit) return;
    double least = sum[0];
    int m = 0;
#pragma unroll
    for (int s = 1; s < kSlots; ++s)
      if (sum[s] < least) {
        least = sum[s];
        m = s;
      }
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (s == m) {
        if (bin[s] >= 0) atomicAdd(h + bin[s], sum[s]);
        bin[s] = b;
        sum[s] = bytes;
      }
  }

  __device__ __forceinline__ void flush(double* h) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (bin[s] >= 0) atomicAdd(h + bin[s], sum[s]);
  }
};

// The warps of a histogram or tie block: W warps for each of the group's G
// nodes (nodes blockIdx.y * G onward).
struct Lane {
  int jj, j, sub, step, g0, gn;

  __device__ Lane(int G, int W, int N) {
    const int warp = threadIdx.x >> 5;
    jj = warp / W;
    sub = (warp - jj * W) * 32 + (threadIdx.x & 31);
    step = W * 32;
    g0 = blockIdx.y * G;
    gn = min(G, N - g0);
    j = g0 + jj;
  }
};

// Calls fn(v, bytes) for each owned entry of node ln.j among the tile's nk
// keys that this thread takes (every ln.step-th from ln.sub). The loads of
// kBatch entries are issued before any of them is used.
template <typename Fn>
__device__ __forceinline__ void for_owned(const Tile& t, const Lane& ln, int nk, int N, Fn fn) {
  for (int kl0 = ln.sub; kl0 < nk; kl0 += kBatch * ln.step) {
    bool own[kBatch], held[kBatch];
    float f[kBatch], bytes[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int kl = kl0 + u * ln.step, e = kl * N + ln.j;
      own[u] = kl < nk && t.own[e];
      held[u] = own[u] && t.host[e];
      f[u] = own[u] ? t.f[e] : 0.0f;
      bytes[u] = own[u] ? t.obj[kl] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (own[u]) fn(order_value(f[u], held[u]), static_cast<double>(bytes[u]));
  }
}

// Level kLevel's histogram: [N, kBins] f64 bytes of the owned entries whose
// digits above this level equal the node's prefix.
template <int kLevel>
__global__ void histogram_kernel(const Inputs in, int G, int W, const NodeState* __restrict__ state,
                                 double* __restrict__ hist) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kShift = kBits * (kLevels - 1 - kLevel);
  double* h = reinterpret_cast<double*>(smem);  // [G, kBins]
  const Tile t = tile_at(smem + G * kBins * 8, in.tk, in.N);
  const Lane ln(G, W, in.N);
  for (int i = threadIdx.x; i < G * kBins; i += blockDim.x) h[i] = 0.0;
  const bool active = ln.jj < ln.gn && !state[ln.j].all;
  const unsigned long long pre = active ? state[ln.j].prefix >> (kShift + kBits) : 0;
  double* hj = h + ln.jj * kBins;
  Slots slots;
  __syncthreads();
  for (int tile = blockIdx.x; tile < in.tiles; tile += gridDim.x) {
    const int nk = keys_of(in, tile);
    stage(t, in, tile);
    if (active)
      for_owned(t, ln, nk, in.N, [&](unsigned long long v, double bytes) {
        if (kLevel == 0 || (v >> (kShift + kBits)) == pre)
          slots.add(static_cast<int>(v >> kShift) & (kBins - 1), bytes, hj);
      });
    __syncthreads();  // the tile is read before the next one is staged over it
  }
  if (active) slots.flush(hj);
  __syncthreads();
  double* out = hist + static_cast<long long>(ln.g0) * kBins;
  for (int i = threadIdx.x; i < ln.gn * kBins; i += blockDim.x)
    if (h[i] != 0.0) atomicAdd(out + i, h[i]);
}

// One block a node: the first bin of level kLevel whose running total
// crosses the budget gives the next digit of v*.
template <int kLevel>
__global__ void __launch_bounds__(kScanThreads)
level_scan_kernel(const double* __restrict__ hist, const float* __restrict__ budget,
                  NodeState* __restrict__ state) {
  __shared__ double tmp[32];
  constexpr int kShift = kBits * (kLevels - 1 - kLevel);
  NodeState* st = state + blockIdx.x;
  if (st->all) return;
  const double below = st->below, cap = static_cast<double>(budget[blockIdx.x]);
  const double* hj = hist + static_cast<long long>(blockIdx.x) * kBins;
  const int i = threadIdx.x;
  const double a = hj[2 * i], b = hj[2 * i + 1];
  const double ex = block_exclusive_sum(a + b, tmp);
  const bool c_prev = i > 0 && !(below + ex <= cap);
  const bool c0 = !(below + (ex + a) <= cap);
  const bool c1 = !(below + (ex + a + b) <= cap);
  if (!c_prev && c0) {
    st->prefix |= static_cast<unsigned long long>(2 * i) << kShift;
    st->below = below + ex;
  } else if (!c0 && c1) {
    st->prefix |= static_cast<unsigned long long>(2 * i + 1) << kShift;
    st->below = below + (ex + a);
  } else if (i == kScanThreads - 1 && !c1) {
    if (kLevel == 0) {
      st->all = 1;  // the node's whole owned set fits
    } else {
      // Only where sums round (sizes spanning 53 bits or more): keep the
      // prefix's last bin.
      st->prefix |= static_cast<unsigned long long>(kBins - 1) << kShift;
      st->below = below + (ex + a);
    }
  }
}

// A tile a block and a node a thread group: the bytes of the tie entries
// (v == v*) of each tile, [N, tiles].
__global__ void tie_kernel(const Inputs in, int G, int W, const NodeState* __restrict__ state,
                           double* __restrict__ tile_sums) {
  extern __shared__ __align__(16) uint8_t smem[];
  double* red = reinterpret_cast<double*>(smem);  // a sum a warp
  const Tile t = tile_at(smem + pad16(G * W * 8), in.tk, in.N);
  const Lane ln(G, W, in.N);
  const bool active = ln.jj < ln.gn && !state[ln.j].all;
  const unsigned long long vstar = active ? state[ln.j].prefix : 0;
  for (int tile = blockIdx.x; tile < in.tiles; tile += gridDim.x) {
    const int nk = keys_of(in, tile);
    stage(t, in, tile);
    double s = 0.0;
    if (active)
      for_owned(t, ln, nk, in.N, [&](unsigned long long v, double bytes) {
        if (v == vstar) s += bytes;
      });
    s = warp_sum(s);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < ln.gn) {
      double total = 0.0;
      for (int w = 0; w < W; ++w) total += red[threadIdx.x * W + w];
      tile_sums[static_cast<long long>(ln.g0 + threadIdx.x) * in.tiles + tile] = total;
    }
    __syncthreads();
  }
}

// One block a node: the first tile where the tie group's running total
// crosses the budget, and the bytes ordered before that tile's ties.
__global__ void __launch_bounds__(kScanThreads)
tile_scan_kernel(const double* __restrict__ tile_sums, int tiles, const float* __restrict__ budget,
                 NodeState* __restrict__ state) {
  __shared__ double tmp[32];
  NodeState* st = state + blockIdx.x;
  if (st->all) return;
  const double below = st->below, cap = static_cast<double>(budget[blockIdx.x]);
  const double* ts = tile_sums + static_cast<long long>(blockIdx.x) * tiles;
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, tiles), hi = min(lo + per, tiles);
  double s = 0.0;
  for (int i = lo; i < hi; ++i) s += ts[i];
  if (threadIdx.x == 0) st->tile = tiles;  // no crossing: only where sums round
  double acc = block_exclusive_sum(s, tmp);
  bool prev = lo > 0 && !(below + acc <= cap);
  for (int i = lo; i < hi && !prev; ++i) {
    const double before = acc;
    acc += ts[i];
    if (!(below + acc <= cap)) {
      st->tile = i;
      st->below_tile = below + before;
      prev = true;
    }
  }
}

__host__ __device__ __forceinline__ int node_bytes(int N) {
  return pad16(32 * 8 + N * (3 * 8 + 3 * 4));
}

// A tile a block: every entry against its node's cut point; the crossing
// tile of a node scans its tie entries in key order for k*.
__global__ void __launch_bounds__(kFinalThreads)
final_kernel(const Inputs in, const NodeState* __restrict__ state, uint8_t* __restrict__ projected,
             uint8_t* __restrict__ evicted, uint8_t* __restrict__ rejected) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int N = in.N;
  double* tmp = reinterpret_cast<double*>(smem);  // 32
  unsigned long long* vstar = reinterpret_cast<unsigned long long*>(tmp + 32);
  double* below_tile = reinterpret_cast<double*>(vstar + N);
  double* cap = below_tile + N;
  int* tstar = reinterpret_cast<int*>(cap + N);
  int* kstar = tstar + N;
  int* all = kstar + N;
  const Tile t = tile_at(smem + node_bytes(N), in.tk, N);
  uint8_t* rej = t.host + pad16(in.tk * N);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const NodeState s = state[i];
    vstar[i] = s.prefix;
    below_tile[i] = s.below_tile;
    cap[i] = static_cast<double>(in.budget[i]);
    tstar[i] = s.tile;
    all[i] = s.all;
  }
  __syncthreads();
  for (int tile = blockIdx.x; tile < in.tiles; tile += gridDim.x) {
    const int nk = keys_of(in, tile);
    stage(t, in, tile);
    for (int j = 0; j < N; ++j) {  // the same branch in every thread
      if (all[j] || tstar[j] != tile) continue;
      const int per = (nk + blockDim.x - 1) / blockDim.x;
      const int lo = min(static_cast<int>(threadIdx.x) * per, nk), hi = min(lo + per, nk);
      double s = 0.0;
      for (int kl = lo; kl < hi; ++kl) {
        const int e = kl * N + j;
        if (t.own[e] && order_value(t.f[e], t.host[e] != 0) == vstar[j])
          s += static_cast<double>(t.obj[kl]);
      }
      if (threadIdx.x == 0) kstar[j] = nk;
      double acc = block_exclusive_sum(s, tmp);
      for (int kl = lo; kl < hi; ++kl) {
        const int e = kl * N + j;
        if (t.own[e] && order_value(t.f[e], t.host[e] != 0) == vstar[j]) {
          acc += static_cast<double>(t.obj[kl]);
          if (!(below_tile[j] + acc <= cap[j])) {
            atomicMin(kstar + j, kl);
            break;
          }
        }
      }
      __syncthreads();
    }
    for (int kl = threadIdx.x; kl < nk; kl += blockDim.x) {
      for (int j = 0; j < N; ++j) {
        const int e = kl * N + j;
        const bool own = t.own[e] != 0, host = t.host[e] != 0;
        bool admit = true;
        if (own && !all[j]) {
          const unsigned long long v = order_value(t.f[e], host);
          admit = v < vstar[j] ||
                  (v == vstar[j] && (tile < tstar[j] || (tile == tstar[j] && kl < kstar[j])));
        }
        t.own[e] = own && admit;
        t.host[e] = own && host && !admit;
        rej[e] = own && !host && !admit;
      }
    }
    __syncthreads();
    const long long e0 = static_cast<long long>(tile) * in.tk * N;
    store_bytes(projected + e0, t.own, nk * N);
    store_bytes(evicted + e0, t.host, nk * N);
    store_bytes(rejected + e0, rej, nk * N);
    __syncthreads();  // the stores have read the tile before the next one is staged
  }
}

long long state_bytes(int N) { return (static_cast<long long>(N) * sizeof(NodeState) + 15) & ~15ll; }

long long cleared_bytes(int N) {
  return state_bytes(N) + static_cast<long long>(kLevels) * N * kBins * 8;
}

long long tiles_of(int K, int N) { return (static_cast<long long>(K) + tile_keys(N) - 1) / tile_keys(N); }

constexpr int kKernels = 5;  // histogram levels 0-2, tie, final: the launches sized by residency

struct Resident {
  long long blocks[kKernels];  // blocks each kernel keeps resident on the card
};

// Each kernel's resident blocks at N nodes on the current device, asked once
// a (device, N): they depend on nothing else, so a call makes its memset and
// nine launches and no other runtime call but cudaGetDevice. Dynamic shared
// memory above 48 KB must be asked for; it is asked on a miss for the most
// any N has needed on that device, so that no other N or thread can undo it.
cudaError_t resident_blocks(int N, const int threads[kKernels], const int smem[kKernels], Resident* out) {
  const void* const kernels[kKernels] = {
      reinterpret_cast<const void*>(histogram_kernel<0>), reinterpret_cast<const void*>(histogram_kernel<1>),
      reinterpret_cast<const void*>(histogram_kernel<2>), reinterpret_cast<const void*>(tie_kernel),
      reinterpret_cast<const void*>(final_kernel)};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<int, int>, Resident> known;  // (device, N)
  static std::map<std::pair<int, int>, int> asked;       // (device, kernel): shared bytes asked for
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find({device, N});
  if (it != known.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  Resident r;
  for (int i = 0; i < kKernels; ++i) {
    if (smem[i] > kMaxSmem) return cudaErrorInvalidValue;
    int& most = asked[{device, i}];
    if (smem[i] > most) {
      err = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[i]);
      if (err != cudaSuccess) return err;
      most = smem[i];
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernels[i], threads[i], smem[i]);
    if (err != cudaSuccess) return err;
    r.blocks[i] = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  *out = known[{device, N}] = r;
  return cudaSuccess;
}

// Blocks a launch: as many as stay resident on the card, at most one a tile.
int grid_of(long long resident, int tiles) { return static_cast<int>(resident < tiles ? resident : tiles); }

#define CP_CHECK(expr)                       \
  do {                                       \
    const cudaError_t e_ = (expr);           \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

}  // namespace

extern "C" {

int capacity_projection_threads() { return kFinalThreads; }

int capacity_projection_max_nodes() { return kMaxNodes; }

const char* capacity_projection_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of device scratch a launch at K keys and N nodes needs.
long long capacity_projection_scratch_bytes(int K, int N) {
  return cleared_bytes(N) + static_cast<long long>(N) * tiles_of(K, N) * 8;
}

// owners, hosts [K, N] bool; f [K, N] f32; obj [K] f32; budget [N] f32, all
// on the device, contiguous. Writes projected, evicted, rejected [K, N]
// bool. scratch: capacity_projection_scratch_bytes(K, N) device bytes.
int capacity_projection_launch(const void* owners, const void* hosts, const void* f,
                               const void* obj, const void* budget, int K, int N, void* projected,
                               void* evicted, void* rejected, void* scratch, void* stream) {
  if (K <= 0 || N <= 0 || N > kMaxNodes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tk = tile_keys(N);
  const int tiles = static_cast<int>(tiles_of(K, N));
  const Inputs in{static_cast<const uint8_t*>(owners), static_cast<const uint8_t*>(hosts),
                  static_cast<const float*>(f), static_cast<const float*>(obj),
                  static_cast<const float*>(budget), K, N, tk, tiles};
  const int groups = (N + kMaxGroup - 1) / kMaxGroup;
  const int G = (N + groups - 1) / groups;
  const int hw = kHistWarps / G > 1 ? kHistWarps / G : 1, tw = kTieWarps / G > 1 ? kTieWarps / G : 1;

  uint8_t* base = static_cast<uint8_t*>(scratch);
  NodeState* state = reinterpret_cast<NodeState*>(base);
  double* hist = reinterpret_cast<double*>(base + state_bytes(N));
  double* tile_sums = hist + static_cast<long long>(kLevels) * N * kBins;

  const int hist_smem = G * kBins * 8 + tile_bytes(tk, N);
  const int tie_smem = pad16(G * tw * 8) + tile_bytes(tk, N);
  const int final_smem = node_bytes(N) + tile_bytes(tk, N) + pad16(tk * N);
  const int threads[kKernels] = {32 * hw * G, 32 * hw * G, 32 * hw * G, 32 * tw * G, kFinalThreads};
  const int smem[kKernels] = {hist_smem, hist_smem, hist_smem, tie_smem, final_smem};
  Resident r;
  CP_CHECK(resident_blocks(N, threads, smem, &r));
  const dim3 hgrid[kLevels] = {dim3(grid_of(r.blocks[0], tiles), groups),
                                dim3(grid_of(r.blocks[1], tiles), groups),
                                dim3(grid_of(r.blocks[2], tiles), groups)};
  const dim3 tgrid(grid_of(r.blocks[3], tiles), groups);
  const int fx = grid_of(r.blocks[4], tiles);
  const long long level = static_cast<long long>(N) * kBins;

  CP_CHECK(cudaMemsetAsync(scratch, 0, cleared_bytes(N), s));
  histogram_kernel<0><<<hgrid[0], 32 * hw * G, hist_smem, s>>>(in, G, hw, state, hist);
  CP_CHECK(cudaGetLastError());
  level_scan_kernel<0><<<N, kScanThreads, 0, s>>>(hist, in.budget, state);
  CP_CHECK(cudaGetLastError());
  histogram_kernel<1><<<hgrid[1], 32 * hw * G, hist_smem, s>>>(in, G, hw, state, hist + level);
  CP_CHECK(cudaGetLastError());
  level_scan_kernel<1><<<N, kScanThreads, 0, s>>>(hist + level, in.budget, state);
  CP_CHECK(cudaGetLastError());
  histogram_kernel<2><<<hgrid[2], 32 * hw * G, hist_smem, s>>>(in, G, hw, state, hist + 2 * level);
  CP_CHECK(cudaGetLastError());
  level_scan_kernel<2><<<N, kScanThreads, 0, s>>>(hist + 2 * level, in.budget, state);
  CP_CHECK(cudaGetLastError());
  tie_kernel<<<tgrid, 32 * tw * G, tie_smem, s>>>(in, G, tw, state, tile_sums);
  CP_CHECK(cudaGetLastError());
  tile_scan_kernel<<<N, kScanThreads, 0, s>>>(tile_sums, tiles, in.budget, state);
  CP_CHECK(cudaGetLastError());
  final_kernel<<<fx, kFinalThreads, final_smem, s>>>(in, state, static_cast<uint8_t*>(projected),
                                                     static_cast<uint8_t*>(evicted),
                                                     static_cast<uint8_t*>(rejected));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
