// ownership_sweep: the paper's Algorithm 3 analysis pass on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ownership_sweep/kernel.py
// (ownership_sweep_kernel, launched by ownership_sweep_call), which walks
// [TK, N] tiles of the metadata store in VMEM.
//
// What bounds it here: bytes. Per key it reads N counts (int32 access
// counters for the key-value engine, f32 EMA traffic for the ML-state
// daemons; one template serves both), N host bytes, one live byte and one
// int32 timestamp, and writes three N-byte planes (owners, add, drop), one
// expired byte and N f32 fractions; the arithmetic (one division per count)
// is far below the card's rate. At K = 1e6, N = 5 that is 30 MB in and
// 36 MB out.
//
// What the design does about it: a row of N = 5 is 20 bytes of counts and
// 5 bytes of each byte plane, so one thread per key would load and store
// with strides across the warp. Instead each block owns a contiguous tile
// of TK keys (tile_keys: 512 at N = 5, fewer for wide rows, always a
// multiple of 16 so that every tile of a 16-byte-aligned array starts
// 16-byte aligned). The block copies the tile's counts, hosts, live and
// last planes into shared memory with 16-byte cp.async copies, neighbouring
// threads on neighbouring addresses; decides each key there, computing
// each fraction once; writes f over the counts, owners over the hosts and
// expired over live in shared memory, beside add and drop; and stores the
// five planes back with 16-byte vector stores. The ragged last tile's
// tail, and any array whose base is not 16-byte aligned, take byte-wide
// copies. Blocks walk tiles grid-stride.
//
// Semantics (src/repro/kernels/ownership_sweep/ref.py, sweep_ref):
//   total = sum of the row in f32, left to right; f = total > 0 ?
//   c / max(total, 1) : 0 (IEEE division); eligible where f >= H (decided
//   in f32); if the key has traffic and no node qualifies, the FIRST argmax
//   node is eligible (starvation guard); silent keys keep hosts; expired =
//   expiry > 0 && live && now - last > expiry; owners &= live && !expired.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 20 * 1024;  // bytes of shared memory a tile aims at
constexpr int kMaxSmem = 227 * 1024;    // an H100 block's limit

// Keys per tile for rows of N nodes: 7N + 5 bytes of shared memory a key.
int tile_keys(int N) {
  const int tk = kSmemBudget / (7 * N + 5) / 16 * 16;
  return tk < 16 ? 16 : (tk > 1024 ? 1024 : tk);
}

int smem_bytes(int N) {
  const int tk = tile_keys(N);
  const int plane = (tk * N + 15) & ~15;
  return tk * N * 4 + 3 * plane + tk + tk * 4;
}

// n bytes from global src to shared dst (16-byte aligned): 16-byte cp.async
// copies while src is 16-byte aligned, all in flight at once (the caller
// waits with cp_async_wait_all), byte by byte for the rest.
__device__ __forceinline__ void load_bytes(uint8_t* dst, const uint8_t* src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n >> 4;
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    for (int i = threadIdx.x; i < nv; i += kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 16 * i),
                   "l"(src + 16 * i)
                   : "memory");
    done = nv << 4;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n bytes from shared src (16-byte aligned) to global dst, the same way.
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint8_t* src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nv = n >> 4;
    for (int i = threadIdx.x; i < nv; i += kThreads)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = nv << 4;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

template <typename C>
__device__ __forceinline__ float as_count(uint32_t w);
template <>
__device__ __forceinline__ float as_count<int>(uint32_t w) {
  return static_cast<float>(static_cast<int>(w));
}
template <>
__device__ __forceinline__ float as_count<float>(uint32_t w) {
  return __uint_as_float(w);
}

template <typename C>
__global__ void __launch_bounds__(kThreads) ownership_sweep_kernel(
    const C* __restrict__ counts, const uint8_t* __restrict__ hosts,
    const uint8_t* __restrict__ live, const int* __restrict__ last, int K,
    int N, int now, float h, int expiry, int tk, uint8_t* __restrict__ owners,
    uint8_t* __restrict__ add, uint8_t* __restrict__ drop,
    uint8_t* __restrict__ expired, float* __restrict__ f) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int plane = (tk * N + 15) & ~15;
  uint32_t* cf = reinterpret_cast<uint32_t*>(smem);  // counts in, f out: [tk, N] words
  uint8_t* hb = smem + tk * N * 4;                    // hosts in, owners out
  uint8_t* ab = hb + plane;                           // add
  uint8_t* db = ab + plane;                           // drop
  uint8_t* lv = db + plane;                           // live in, expired out
  int* ls = reinterpret_cast<int*>(lv + tk);          // last access

  const int tiles = (K + tk - 1) / tk;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long key0 = static_cast<long long>(tile) * tk;
    const int nk = static_cast<int>(min(static_cast<long long>(tk), K - key0));
    const long long base = key0 * N;
    const int nb = nk * N;
    __syncthreads();  // the previous tile's stores are done reading shared memory
    load_bytes(smem, reinterpret_cast<const uint8_t*>(counts + base), nb * 4);
    load_bytes(hb, hosts + base, nb);
    load_bytes(lv, live + key0, nk);
    load_bytes(reinterpret_cast<uint8_t*>(ls), reinterpret_cast<const uint8_t*>(last + key0), nk * 4);
    cp_async_wait_all();
    __syncthreads();

    for (int j = threadIdx.x; j < nk; j += kThreads) {
      uint32_t* c = cf + j * N;
      float total = 0.f;
      float best = as_count<C>(c[0]);
      int am = 0;
      for (int n = 0; n < N; ++n) {
        const float cn = as_count<C>(c[n]);
        total += cn;
        if (cn > best) {
          best = cn;
          am = n;
        }
      }
      const bool touched = total > 0.f;
      const float denom = fmaxf(total, 1.f);
      bool any = false;
      for (int n = 0; n < N; ++n) {
        const float fn = touched ? as_count<C>(c[n]) / denom : 0.f;
        c[n] = __float_as_uint(fn);
        any = any || (fn >= h);
      }
      const bool none_q = touched && !any;
      const bool lvj = lv[j] != 0;
      const bool ex = expiry > 0 && lvj && (now - ls[j]) > expiry;
      lv[j] = ex;
      for (int n = 0; n < N; ++n) {
        const bool hn = hb[j * N + n] != 0;
        const bool el = none_q ? (n == am) : (__uint_as_float(c[n]) >= h);
        const bool o = (touched ? el : hn) && lvj && !ex;
        hb[j * N + n] = o;
        ab[j * N + n] = o && !hn;
        db[j * N + n] = hn && !o;
      }
    }
    __syncthreads();
    store_bytes(reinterpret_cast<uint8_t*>(f + base), smem, nb * 4);
    store_bytes(owners + base, hb, nb);
    store_bytes(add + base, ab, nb);
    store_bytes(drop + base, db, nb);
    store_bytes(expired + key0, lv, nk);
  }
}

template <typename C>
int launch(const void* counts, const void* hosts, const void* live,
           const void* last, int K, int N, int now, float h, int expiry,
           void* owners, void* add, void* drop, void* expired, void* f,
           int grid, void* stream) {
  const int smem = smem_bytes(N);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ownership_sweep_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ownership_sweep_kernel<C><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(counts), static_cast<const uint8_t*>(hosts),
      static_cast<const uint8_t*>(live), static_cast<const int*>(last), K, N,
      now, h, expiry, tile_keys(N), static_cast<uint8_t*>(owners),
      static_cast<uint8_t*>(add), static_cast<uint8_t*>(drop),
      static_cast<uint8_t*>(expired), static_cast<float*>(f));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ownership_sweep_threads() { return kThreads; }

// Keys per block tile at N nodes: the wrapper's grid is ceil(K / this),
// capped.
int ownership_sweep_tile_keys(int N) { return tile_keys(N); }

const char* ownership_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counts_f32 = 0: int32 counts; 1: f32 counts.
int ownership_sweep_launch(const void* counts, int counts_f32,
                           const void* hosts, const void* live,
                           const void* last, int K, int N, int now, float h,
                           int expiry, void* owners, void* add, void* drop,
                           void* expired, void* f, int grid, void* stream) {
  if (counts_f32)
    return launch<float>(counts, hosts, live, last, K, N, now, h, expiry,
                         owners, add, drop, expired, f, grid, stream);
  return launch<int>(counts, hosts, live, last, K, N, now, h, expiry, owners,
                     add, drop, expired, f, grid, stream);
}

}  // extern "C"
