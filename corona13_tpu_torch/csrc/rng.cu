// The counter RNG's draw for the H100 (sm_90a): one uniform float a lane
// from the (pixel, sample, dim, seed) counter, in one launch a draw.
//
// It replaces no TPU kernel: the JAX package hashes with jnp ops under
// XLA (corona13_tpu/ops/rng.py).  ops/rng.py's torch path carries the
// same PCG4D hash (Jarzynski & Olano, JCGT 2020) in int64 tensors, masked
// to 32 bits after every add and multiply, because torch has no uint32
// arithmetic on every device: 52 eager ops a draw over the whole
// wavefront.  Here each thread hashes its lane in uint32 registers.  The
// two agree bit for bit: products and sums mod 2^32 depend only on their
// operands mod 2^32, a right shift of a word below 2^32 is the same in
// both, and (v0 >> 8) * 2^-24 is exact in float32.
//
// The four counter words take one form each: a word of the arguments
// (a Python int on the host, masked to 32 bits there), one int64 value for
// every lane (step 0), or an int64 value a lane (step 1, contiguous).
// ops/rng_cuda.py brings every input to one of these forms, so every draw
// on the card comes here.
//
// What bounds it.  A lane reads its int64 pixel and, where the sample is
// one a lane, its int64 sample, and writes one float: 20 bytes.  The hash
// is about 30 integer operations a lane, far below the card's integer
// rate, so the bytes are the floor (2,073,600 lanes: 41.5 MB, 12.4 us at
// 3.35 TB/s).  One thread a lane, neighbouring threads on neighbouring
// addresses; a value for every lane is read from one address (L1).
//
// Only v0 of the hash is kept: the second round's v0 is its first line,
// which reads v1 and v3 as the first round left them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  int n;
  const long long* ptr[4];    // pixel, sample, dim, seed; null: word[k]
  int step[4];                // 1: ptr[k][i]; 0: ptr[k][0] for every lane
  uint32_t word[4];           // seed's word already ^ 0x9E3779B9
  float* out;                 // [n]
};

__device__ __forceinline__ uint32_t lcg(uint32_t v) {
  return v * 1664525u + 1013904223u;
}

__device__ __forceinline__ uint32_t counter(const Params& p, int k, int i) {
  return p.ptr[k] == nullptr
      ? p.word[k]
      : (uint32_t)p.ptr[k][(size_t)i * p.step[k]];
}

__global__ void __launch_bounds__(kThreads)
rng_uniform_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  uint32_t v0 = lcg(counter(p, 0, i));
  uint32_t v1 = lcg(counter(p, 1, i));
  uint32_t v2 = lcg(counter(p, 2, i));
  uint32_t v3 = lcg(p.ptr[3] == nullptr ? p.word[3]
                                        : counter(p, 3, i) ^ 0x9E3779B9u);
  v0 += v1 * v3;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v3 += v1 * v2;
  v0 ^= v0 >> 16;
  v1 ^= v1 >> 16;
  v3 ^= v3 >> 16;
  v0 += v1 * v3;
  p.out[i] = (float)(v0 >> 8) * 0x1p-24f;
}

}  // namespace

extern "C" {

struct Corona13RngArgs {
  int n;
  int pixel_step;             // 1 or 0; read only where its pointer is set
  int sample_step;
  int dim_step;
  int seed_step;
  unsigned int pixel_word;    // the word where its pointer is null
  unsigned int sample_word;
  unsigned int dim_word;
  unsigned int seed_word;
  const long long* pixel;
  const long long* sample;
  const long long* dim;
  const long long* seed;
  float* out;
  void* stream;
};

int corona13_rng_uniform(const Corona13RngArgs* a) {
  const int steps[4] = {a->pixel_step, a->sample_step, a->dim_step,
                        a->seed_step};
  Params p;
  p.n = a->n;
  p.ptr[0] = a->pixel;
  p.ptr[1] = a->sample;
  p.ptr[2] = a->dim;
  p.ptr[3] = a->seed;
  p.word[0] = a->pixel_word;
  p.word[1] = a->sample_word;
  p.word[2] = a->dim_word;
  p.word[3] = a->seed_word ^ 0x9E3779B9u;
  p.out = a->out;
  if (a->n <= 0 || a->out == nullptr) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k) {
    if (p.ptr[k] != nullptr && steps[k] != 0 && steps[k] != 1)
      return (int)cudaErrorInvalidValue;
    p.step[k] = steps[k];
  }
  const int blocks = (a->n + kThreads - 1) / kThreads;
  rng_uniform_kernel<<<blocks, kThreads, 0, (cudaStream_t)a->stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
