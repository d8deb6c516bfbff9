// hot_gather: the first level of the two-level embedding lookup, on Hopper
// (sm_90a): each token's row from the hot-row replica cache, or zeros and a
// miss flag.
//
// Replaces the TPU kernel src/repro/kernels/hot_gather/kernel.py
// (hot_gather_kernel, launched by hot_gather_call), which pins slot_map and
// a column tile of the hot table in VMEM and fetches rows one token at a
// time in a serial loop over the token tile.
//
// What bounds it here: bytes. It must write T * D * elem bytes of rows and
// T hit flags, and read T token ids, T slot_map entries and the hit rows of
// the hot table; there is no arithmetic. At the deepseek-moe-16b width
// (T = 32,768, D = 2048 bf16) the output alone is 134 MB, and the 8 MB hot
// table (2048 x 2048 bf16) stays resident in the 50 MB L2, so repeated hits
// cost L2 reads, not device-memory reads.
//
// What the design does about it: one warp per token (grid-stride). Lane 0
// reads the token and its slot and broadcasts the slot by shuffle; the warp
// then copies the row in 16-byte units (uint4), neighbouring lanes on
// neighbouring addresses, or writes zeros on a miss. The copy is of bits, so
// one kernel serves bf16 and f32 tables; the wrapper picks 16-, 4- or
// 2-byte units from the row size and the pointers' alignment.
//
// Semantics (src/repro/kernels/hot_gather/ref.py, hot_gather_ref):
//   slot = slot_map[tok]; hit = slot >= 0; row = hit ? table[slot] : 0.
//   A token outside [0, V) or a slot >= R counts as a miss.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps per block

template <typename U>
__global__ void hot_gather_kernel(const int* __restrict__ tokens, long long T,
                                  const int* __restrict__ slot_map, int V,
                                  const U* __restrict__ table, int R,
                                  int units, U* __restrict__ out,
                                  uint8_t* __restrict__ hit) {
  const int lane = threadIdx.x & 31;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long t = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       t < T; t += warps) {
    int slot = -1;
    if (lane == 0) {
      const int tok = tokens[t];
      slot = (tok >= 0 && tok < V) ? slot_map[tok] : -1;
      if (slot >= R) slot = -1;
    }
    slot = __shfl_sync(0xffffffffu, slot, 0);
    U* dst = out + t * units;
    if (slot >= 0) {
      const U* src = table + static_cast<long long>(slot) * units;
      for (int u = lane; u < units; u += 32) dst[u] = src[u];
    } else {
      const U zero{};
      for (int u = lane; u < units; u += 32) dst[u] = zero;
    }
    if (lane == 0) hit[t] = slot >= 0;
  }
}

template <typename U>
int launch(const void* tokens, long long T, const void* slot_map, int V,
           const void* table, int R, long long row_bytes, void* out, void* hit,
           int blocks, cudaStream_t stream) {
  hot_gather_kernel<U><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(tokens), T, static_cast<const int*>(slot_map), V,
      static_cast<const U*>(table), R, static_cast<int>(row_bytes / sizeof(U)),
      static_cast<U*>(out), static_cast<uint8_t*>(hit));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hot_gather_threads() { return kThreads; }

const char* hot_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tokens [T] int32, slot_map [V] int32, table [R, row_bytes] -> out
// [T, row_bytes], hit [T] uint8. `unit` (16, 4 or 2) must divide row_bytes
// and the alignment of table and out.
int hot_gather_launch(const void* tokens, long long T, const void* slot_map,
                      int V, const void* table, int R, long long row_bytes,
                      int unit, void* out, void* hit, int blocks,
                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (unit == 16)
    return launch<uint4>(tokens, T, slot_map, V, table, R, row_bytes, out, hit, blocks, s);
  if (unit == 4)
    return launch<uint32_t>(tokens, T, slot_map, V, table, R, row_bytes, out, hit, blocks, s);
  if (unit == 2)
    return launch<uint16_t>(tokens, T, slot_map, V, table, R, row_bytes, out, hit, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
