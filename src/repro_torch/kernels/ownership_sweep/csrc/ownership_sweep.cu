// ownership_sweep: the paper's Algorithm 3 analysis pass on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ownership_sweep/kernel.py
// (ownership_sweep_kernel, launched by ownership_sweep_call), which walks
// [TK, N] tiles of the metadata store in VMEM.
//
// What bounds it here: bytes. Per key it reads N counts (int32 access
// counters for the key-value engine, f32 EMA traffic for the ML-state
// daemons; one template serves both), N host bytes,
// one live byte and one int32 timestamp, and writes three N-byte planes
// (owners, add, drop), one expired byte and N f32 fractions; the arithmetic
// (one division per count) is far below the card's rate. At K = 1e6, N = 5
// that is 30 MB in and 36 MB out.
//
// What the design does about it: one thread per key (grid-stride), each
// reading its row once and writing every output once, with no shared memory
// and no second pass. Rows of N = 5 are not 16-byte aligned, so the loads
// are not fully coalesced; that is the limit of this first version.
//
// Semantics (src/repro/kernels/ownership_sweep/ref.py, sweep_ref):
//   total = sum of the row in f32; f = total > 0 ? c / max(total, 1) : 0;
//   eligible where f >= H (decided in f32); if the key has traffic and no
//   node qualifies, the FIRST argmax node is eligible (starvation guard);
//   silent keys keep hosts; expired = expiry > 0 && live && now - last >
//   expiry; owners &= live && !expired.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename C>
__global__ void ownership_sweep_kernel(
    const C* __restrict__ counts, const uint8_t* __restrict__ hosts,
    const uint8_t* __restrict__ live, const int* __restrict__ last, int K,
    int N, int now, float h, int expiry, uint8_t* __restrict__ owners,
    uint8_t* __restrict__ add, uint8_t* __restrict__ drop,
    uint8_t* __restrict__ expired, float* __restrict__ f) {
  const int stride = gridDim.x * kThreads;
  for (int key = blockIdx.x * kThreads + threadIdx.x; key < K; key += stride) {
    const size_t base = static_cast<size_t>(key) * N;
    const C* c = counts + base;
    float total = 0.f;
    float best = static_cast<float>(c[0]);
    int am = 0;
    for (int j = 0; j < N; ++j) {
      const float cj = static_cast<float>(c[j]);
      total += cj;
      if (cj > best) {
        best = cj;
        am = j;
      }
    }
    const bool touched = total > 0.f;
    const float denom = fmaxf(total, 1.f);
    bool any = false;
    for (int j = 0; j < N; ++j) {
      const float fj = touched ? static_cast<float>(c[j]) / denom : 0.f;
      f[base + j] = fj;
      any = any || (fj >= h);
    }
    const bool none_q = touched && !any;
    const bool lv = live[key] != 0;
    const bool ex = expiry > 0 && lv && (now - last[key]) > expiry;
    expired[key] = ex;
    for (int j = 0; j < N; ++j) {
      const bool hj = hosts[base + j] != 0;
      const float fj = touched ? static_cast<float>(c[j]) / denom : 0.f;
      const bool el = none_q ? (j == am) : (fj >= h);
      const bool o = (touched ? el : hj) && lv && !ex;
      owners[base + j] = o;
      add[base + j] = o && !hj;
      drop[base + j] = hj && !o;
    }
  }
}

template <typename C>
int launch(const void* counts, const void* hosts, const void* live,
           const void* last, int K, int N, int now, float h, int expiry,
           void* owners, void* add, void* drop, void* expired, void* f,
           int grid, void* stream) {
  ownership_sweep_kernel<C><<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(counts), static_cast<const uint8_t*>(hosts),
      static_cast<const uint8_t*>(live), static_cast<const int*>(last), K, N,
      now, h, expiry, static_cast<uint8_t*>(owners),
      static_cast<uint8_t*>(add), static_cast<uint8_t*>(drop),
      static_cast<uint8_t*>(expired), static_cast<float*>(f));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ownership_sweep_threads() { return kThreads; }

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
