// The log-spaced latency bin rule, shared by chunk_replay.cu (its fused
// histogram) and latency_histogram.cu, so that both kernels and the plain
// version (kernels/latency_histogram/ref.py::bin_index) put every latency
// in the same bin.
//
// Bin 0 is the underflow bucket (< lo), bin num_bins-1 the overflow bucket
// (>= hi), and the num_bins-2 interior bins are log-spaced on [lo, hi).
// The logarithm is taken in double and rounded to float: the correctly
// rounded f32 log, which puts 1, 10, 100 and 1000 ms (exact bin edges at
// lo=1, hi=1e4, 128 bins) into bins 1, 32, 64 and 95. Both kernels are
// built with -fmad=false, so no product here is fused into an add.
#pragma once

#include <math.h>

// log(hi / lo) rounded to float: the denominator of every bin position.
__host__ __device__ __forceinline__ float log_bin_span(float lo, float hi) {
  return static_cast<float>(log(static_cast<double>(hi / lo)));
}

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
