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
// (12 B) once; each output cell is written once. The arithmetic (one log
// per row) is far below the card's rate.
//
// What the design does about it:
//   * the direct form: each thread takes rows by grid stride, computes the
//     row's bin with bin_of (../../csrc/log_bins.cuh, the rule chunk_replay
//     shares, so both kernels bin every latency alike) and adds its weight
//     into a per-block [G, B] f32 histogram in shared memory with
//     atomicAdd; a last pass adds the block's non-zero cells into global
//     memory. No one-hot planes, no matmul;
//   * the [C, G, B] form: blockIdx.x is the chunk and blockIdx.y a tile of
//     that chunk's rows, so a block's shared histogram never mixes chunks;
//     the flat [G, B] form is the same kernel with one chunk of all rows;
//   * counts with 0/1 weights are integers, exact in f32 below 2**24 in any
//     order, so the result repeats bit for bit; real-valued weights are
//     summed in another order than the plain version (allclose);
//   * rows whose group lies outside [0, G) are dropped.
#include <cuda_runtime.h>
#include <stdint.h>

#include "log_bins.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void latency_histogram_kernel(
    const float* __restrict__ lat, const int* __restrict__ group,
    const float* __restrict__ weight, long long R, long long rows_per_chunk,
    int G, int B, float lo, float hi, float log_span,
    float* __restrict__ hist) {
  extern __shared__ float hist_s[];  // [G * B]
  const int cells = G * B;
  for (int i = threadIdx.x; i < cells; i += kThreads) hist_s[i] = 0.f;
  __syncthreads();

  const long long c = blockIdx.x;
  const long long begin = c * rows_per_chunk;
  const long long end = min(begin + rows_per_chunk, R);
  const long long stride = static_cast<long long>(gridDim.y) * kThreads;
  for (long long i = begin + static_cast<long long>(blockIdx.y) * kThreads +
                     threadIdx.x;
       i < end; i += stride) {
    const int g = group[i];
    const float w = weight[i];
    if (g < 0 || g >= G || w == 0.f) continue;
    atomicAdd(&hist_s[g * B + bin_of(lat[i], lo, hi, log_span, B)], w);
  }
  __syncthreads();

  float* out = hist + c * cells;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const float v = hist_s[i];
    if (v != 0.f) atomicAdd(&out[i], v);
  }
}

}  // namespace

extern "C" {

int latency_histogram_threads() { return kThreads; }

const char* latency_histogram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// lat: [R] f32, group: [R] i32, weight: [R] f32; hist: [num_chunks, G, B]
// f32, zeroed by the caller. Chunk c holds rows [c * rows_per_chunk,
// min((c + 1) * rows_per_chunk, R)); tiles blocks share each chunk.
int latency_histogram_launch(const void* lat, const void* group,
                             const void* weight, long long R,
                             long long rows_per_chunk, int num_chunks,
                             int tiles, int G, int B, float lo, float hi,
                             void* hist, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(G) * B;
  cudaError_t err = cudaFuncSetAttribute(
      latency_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(num_chunks),
                  static_cast<unsigned>(tiles));
  latency_histogram_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lat), static_cast<const int*>(group),
      static_cast<const float*>(weight), R, rows_per_chunk, G, B, lo, hi,
      log_bin_span(lo, hi), static_cast<float*>(hist));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
