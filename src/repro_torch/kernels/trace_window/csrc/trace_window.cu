// trace_window: the request fields of a window of trace positions, drawn
// from the trace's threefry2x32 stream, on Hopper (sm_90a).
//
// Not the port of a Pallas kernel: the reference draws its traces with
// jax.random in XLA-fused code (src/repro/kvsim/workload.py,
// generate_trace and _request_window). In plain PyTorch ops one skewed
// window costs 9 threefry blocks a request, each 20 rounds of a few integer
// ops, a few hundred small launches a window; here it is one launch.
//
// Semantics (ref.py, trace_window_ref; kvsim/prng.py): under the
// partitionable layout the word at position p of a draw with key k is
// threefry2x32(k, (p >> 32, p & 0xFFFFFFFF)) with its two outputs xor-ed.
//   randint(minval, span, mult): hi, lo words of the key's two halves;
//     minval + ((hi % span) * mult + lo % span) % span, in wrapping u32
//   bernoulli(p): f32((w >> 9) | 0x3F800000) - 1 < p
//   key   = skewed ? (bern(hot) ? draw : cold) : draw
//   node  = bern(stay) ? nat : (nat + shift) % N, nat = natural[key];
//           with diurnal shifts (node + (pos * shifts) / R) % N
//   read  = bern(read)
// Positions at or past R give well-typed values that the caller masks.
//
// What bounds it: integer operations. A skewed position takes 9 blocks of
// about 100 32-bit integer operations each and writes 9 bytes, so it is far
// from the memory rate. One thread a position, grid-stride; the parameters
// (18 key words, the draws' spans, multipliers and minvals, thresholds) ride
// in a kernel argument, so they sit in constant memory. The only float
// operation is the exact subtract of the uniform transform; the build keeps
// -fmad=false as the other bit-exact kernels do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 27;  // 18 key words, 3 spans, 3 multipliers, 3 minvals

struct Params {
  uint32_t w[kWords];
  float p_hot, p_stay, p_read;
  long long start, count, num_requests;
  int skewed, num_nodes, diurnal_shifts;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t word(uint32_t k0, uint32_t k1, long long pos) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t a = static_cast<uint32_t>(static_cast<unsigned long long>(pos) >> 32) + k0;
  uint32_t b = static_cast<uint32_t>(pos) + k1;
#define TF_ROUND(r) a += b; b = rotl(b, r); b ^= a;
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_EVEN a += k1; b += ks2 + 1u;
  TF_ODD a += ks2; b += k0 + 2u;
  TF_EVEN a += k0; b += k1 + 3u;
  TF_ODD a += k1; b += ks2 + 4u;
  TF_EVEN a += ks2; b += k0 + 5u;
#undef TF_ODD
#undef TF_EVEN
#undef TF_ROUND
  return a ^ b;
}

__device__ __forceinline__ bool bern(const Params& p, int key, float thr, long long pos) {
  const uint32_t w = word(p.w[2 * key], p.w[2 * key + 1], pos);
  return __uint_as_float((w >> 9) | 0x3F800000u) - 1.0f < thr;
}

// Draw `slot` (0 key, 1 cold, 2 shift) from the two halves of key `key`.
__device__ __forceinline__ int draw(const Params& p, int slot, int key, long long pos) {
  const uint32_t span = p.w[18 + slot], mult = p.w[21 + slot];
  const uint32_t hi = word(p.w[2 * key], p.w[2 * key + 1], pos);
  const uint32_t lo = word(p.w[2 * key + 2], p.w[2 * key + 3], pos);
  const uint32_t off = ((hi % span) * mult + lo % span) % span;
  return static_cast<int>(p.w[24 + slot] + off);
}

__global__ void __launch_bounds__(kThreads)
trace_window_kernel(const Params p, const int* __restrict__ natural, int* __restrict__ keys_out,
                    int* __restrict__ nodes_out, bool* __restrict__ read_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < p.count; i += stride) {
    const long long pos = p.start + i;
    int key = draw(p, 0, 1, pos);  // K_DRAW_HI = 1
    if (p.skewed && !bern(p, 0, p.p_hot, pos)) key = draw(p, 1, 3, pos);  // K_HOT, K_COLD_HI
    const int nat = natural[key];
    const int shift = draw(p, 2, 5, pos);  // K_SHIFT_HI
    const int n = p.num_nodes;
    long long node = bern(p, 7, p.p_stay, pos) ? nat : (nat + shift) % n;  // K_NODE
    if (p.diurnal_shifts > 0) node = (node + pos * p.diurnal_shifts / p.num_requests) % n;
    keys_out[i] = key;
    nodes_out[i] = static_cast<int>(node);
    read_out[i] = bern(p, 8, p.p_read, pos);  // K_RW
  }
}

}  // namespace

extern "C" {

int trace_window_threads() { return kThreads; }

const char* trace_window_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// words: host array of the 27 u32 words of WindowParams.words(). Positions
// [start, start + count) of a trace of num_requests; natural [K] int32;
// keys_out, nodes_out [count] int32; read_out [count] bool.
int trace_window_launch(long long start, long long count, long long num_requests,
                        const void* words, float p_hot, float p_stay, float p_read, int skewed,
                        int num_nodes, int diurnal_shifts, const void* natural, void* keys_out,
                        void* nodes_out, void* read_out, int blocks, void* stream) {
  if (count <= 0) return 0;
  Params p;
  const uint32_t* w = static_cast<const uint32_t*>(words);
  for (int i = 0; i < kWords; ++i) p.w[i] = w[i];
  p.p_hot = p_hot;
  p.p_stay = p_stay;
  p.p_read = p_read;
  p.start = start;
  p.count = count;
  p.num_requests = num_requests;
  p.skewed = skewed;
  p.num_nodes = num_nodes;
  p.diurnal_shifts = diurnal_shifts;
  trace_window_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(natural), static_cast<int*>(keys_out),
      static_cast<int*>(nodes_out), static_cast<bool*>(read_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
