// chunk_replay: one simulation chunk's whole request path on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/chunk_replay/kernel.py
// (chunk_replay_kernel, launched by chunk_replay_call). That kernel gathers
// hosts[keys] as a one-hot [TR, TKEY] x [TKEY, N] matmul over EVERY key
// tile, O(B*K*N) per chunk, because the TPU's matrix unit has no gather.
//
// What bounds it here: bytes. Each request reads its key, node, read flag,
// valid flag (10 B) and the N bytes of its replica row; the [N, N] RTT
// matrix is read once per block. There is no arithmetic worth counting, so
// the kernel is a gather over device memory plus per-block reductions.
//
// What the design does about it:
//   * one thread per request (grid-stride), reading the request's N host
//     bytes directly from the [K, N] uint8 map - O(B*N) bytes, not O(B*K*N);
//   * the RTT matrix lives in shared memory (16 KB at N = 64);
//   * the latency expressions keep the reference's f32 op order
//     (src/repro/kernels/chunk_replay/ref.py, chunk_latency_ref and
//     chunk_replay_ref), built with -fmad=false and IEEE division;
//   * busy[N] and lat_sum are folded per thread in shared memory, reduced
//     per block by a fixed-order tree and written as one row per block; a
//     second small kernel reduces the rows in fixed order, so results repeat
//     bit for bit from run to run. hits, reads and count stay integers;
//   * the optional [2N, num_bins] log-bin histogram uses per-block int
//     counters in shared memory, added to the output with integer atomics
//     (order-free). The bin's logarithm is taken in double and rounded to
//     float, the correctly rounded f32 log, so latencies on a decade edge
//     land in the reference's bins.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // power of two: the tree reductions need it
constexpr int kNoLocal = 1;  // read_mode codes; 0 is "map"
constexpr int kIdeal = 2;

__device__ __forceinline__ int bin_of(float lat, float lo, float hi,
                                      float log_span, int num_bins) {
  if (lat < lo) return 0;
  if (lat >= hi) return num_bins - 1;
  const int inner = num_bins - 2;
  const float x = fmaxf(lat, 1e-30f) / lo;
  const float t = static_cast<float>(log(static_cast<double>(x))) / log_span;
  const int raw = static_cast<int>(floorf(t * static_cast<float>(inner))) + 1;
  return min(max(raw, 1), inner);
}

__global__ void chunk_replay_kernel(
    const uint8_t* __restrict__ hosts, const int* __restrict__ keys,
    const int* __restrict__ nodes, const uint8_t* __restrict__ is_read,
    const uint8_t* __restrict__ valid, const float* __restrict__ rtt,
    const float* __restrict__ extra, int B, int K, int N, int read_mode,
    int master, float service, float xfer_r, float xfer_w, float lo, float hi,
    int num_bins, float* __restrict__ fpart, int* __restrict__ ipart,
    int* __restrict__ hist) {
  extern __shared__ float smem[];
  float* rtt_s = smem;                      // [N * N]
  float* acc_s = rtt_s + N * N;             // [N][kThreads] busy per thread
  int* hist_s = reinterpret_cast<int*>(acc_s + N * kThreads);  // [2N * bins]
  __shared__ float rtt_max_s;
  __shared__ float red_f[kThreads];
  __shared__ int red_i[kThreads];

  const int tid = threadIdx.x;
  for (int i = tid; i < N * N; i += kThreads) rtt_s[i] = rtt[i];
  for (int j = 0; j < N; ++j) acc_s[j * kThreads + tid] = 0.f;
  if (num_bins > 0) {
    for (int i = tid; i < 2 * N * num_bins; i += kThreads) hist_s[i] = 0;
  }
  __syncthreads();
  if (tid == 0) {
    float m = rtt_s[0];
    for (int i = 1; i < N * N; ++i) m = fmaxf(m, rtt_s[i]);
    rtt_max_s = m;
  }
  __syncthreads();

  const float log_span =
      num_bins > 0 ? static_cast<float>(log(static_cast<double>(hi / lo)))
                   : 1.f;
  float lat_sum = 0.f;
  int hits = 0, reads = 0, count = 0;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + tid; i < B; i += stride) {
    const int x = min(max(nodes[i], 0), N - 1);
    const bool rd = is_read[i] != 0;
    const bool v = valid[i] != 0;
    float lat;
    bool hit;
    if (read_mode == kIdeal) {
      lat = service;
      hit = true;
    } else {
      const int k = min(max(keys[i], 0), K - 1);
      const uint8_t* row = hosts + static_cast<size_t>(k) * N;
      const float* rrow = rtt_s + x * N;
      const float* mrow = rtt_s + master * N;
      float nearest = INFINITY;
      float post = 0.f;
      int owners = 0;
      hit = row[x] != 0;
      for (int j = 0; j < N; ++j) {
        const bool h = row[j] != 0;
        owners += h;
        if (h && !(read_mode == kNoLocal && j == x)) {
          nearest = fminf(nearest, rrow[j]);
        }
        if (h && j != master) post = fmaxf(post, mrow[j]);
      }
      if (!isfinite(nearest)) nearest = rtt_max_s;
      if (read_mode == kNoLocal) hit = false;
      const bool has_local = hit;
      const float r_lat = (service + nearest) + (has_local ? 0.f : xfer_r);
      const bool sole_local = hit && owners == 1;
      const float relay = (x == master) ? 0.f : rrow[master];
      float cost = relay + post;
      cost = cost + (cost > 0.f ? xfer_w : 0.f);
      const float w_lat = service + (sole_local ? 0.f : cost);
      lat = rd ? r_lat : w_lat;
    }
    if (extra != nullptr) lat = lat + extra[i];
    if (!v) lat = 0.f;
    lat_sum += lat;
    acc_s[x * kThreads + tid] += lat;
    hits += (hit && rd && v);
    reads += (rd && v);
    count += v;
    if (num_bins > 0 && v) {
      const int g = 2 * x + (rd ? 1 : 0);
      atomicAdd(&hist_s[g * num_bins + bin_of(lat, lo, hi, log_span, num_bins)],
                1);
    }
  }

  // Fixed-order tree reductions: the same inputs give the same bits.
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      for (int j = 0; j < N; ++j) {
        acc_s[j * kThreads + tid] += acc_s[j * kThreads + tid + s];
      }
    }
    __syncthreads();
  }
  float* frow = fpart + static_cast<size_t>(blockIdx.x) * (N + 1);
  if (tid < N) frow[tid] = acc_s[tid * kThreads];

  red_f[tid] = lat_sum;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red_f[tid] += red_f[tid + s];
    __syncthreads();
  }
  if (tid == 0) frow[N] = red_f[0];

  const int vals[3] = {hits, reads, count};
  for (int q = 0; q < 3; ++q) {
    red_i[tid] = vals[q];
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (tid < s) red_i[tid] += red_i[tid + s];
      __syncthreads();
    }
    if (tid == 0) ipart[blockIdx.x * 3 + q] = red_i[0];
    __syncthreads();
  }

  if (num_bins > 0) {
    for (int i = tid; i < 2 * N * num_bins; i += kThreads) {
      if (hist_s[i] != 0) atomicAdd(&hist[i], hist_s[i]);
    }
  }
}

// One block per output column: columns 0..N-1 are busy, N is lat_sum, and
// N+1..N+3 are hits, reads, count. Each thread sums a fixed strided subset
// of the block rows, then a fixed-order tree combines the threads.
__global__ void chunk_replay_finalize(const float* __restrict__ fpart,
                                      const int* __restrict__ ipart, int G,
                                      int N, float* __restrict__ out_f,
                                      long long* __restrict__ out_i) {
  __shared__ float bf[kThreads];
  __shared__ long long bi[kThreads];
  const int col = blockIdx.x;
  const int tid = threadIdx.x;
  if (col <= N) {
    float s = 0.f;
    for (int g = tid; g < G; g += kThreads) s += fpart[static_cast<size_t>(g) * (N + 1) + col];
    bf[tid] = s;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (tid < w) bf[tid] += bf[tid + w];
      __syncthreads();
    }
    if (tid == 0) out_f[col] = bf[0];
  } else {
    const int q = col - (N + 1);
    long long s = 0;
    for (int g = tid; g < G; g += kThreads) s += ipart[g * 3 + q];
    bi[tid] = s;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (tid < w) bi[tid] += bi[tid + w];
      __syncthreads();
    }
    if (tid == 0) out_i[q] = bi[0];
  }
}

}  // namespace

extern "C" {

int chunk_replay_threads() { return kThreads; }

const char* chunk_replay_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// fpart: [grid, N+1] f32 and ipart: [grid, 3] i32 scratch; out_f: [N+1]
// (busy, lat_sum); out_i: [3] i64 (hits, reads, count); hist: [2N, bins]
// i32, zeroed by the caller (unused when num_bins == 0); extra may be null.
int chunk_replay_launch(const void* hosts, const void* keys, const void* nodes,
                        const void* is_read, const void* valid,
                        const void* rtt, const void* extra, int B, int K,
                        int N, int read_mode, int master, float service,
                        float xfer_r, float xfer_w, float lo, float hi,
                        int num_bins, void* fpart, void* ipart, void* out_f,
                        void* out_i, void* hist, int grid, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(N) * N +
                                       static_cast<size_t>(N) * kThreads) +
                      (num_bins > 0 ? sizeof(int) * 2 * N * num_bins : 0);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chunk_replay_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(hosts), static_cast<const int*>(keys),
      static_cast<const int*>(nodes), static_cast<const uint8_t*>(is_read),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(rtt),
      static_cast<const float*>(extra), B, K, N, read_mode, master, service,
      xfer_r, xfer_w, lo, hi, num_bins, static_cast<float*>(fpart),
      static_cast<int*>(ipart), static_cast<int*>(hist));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_replay_finalize<<<N + 4, kThreads, 0, s>>>(
      static_cast<const float*>(fpart), static_cast<const int*>(ipart), grid,
      N, static_cast<float*>(out_f), static_cast<long long*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
