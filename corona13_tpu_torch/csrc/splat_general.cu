// The general splat for the H100 (sm_90a): ops/splat.py's reproducible
// scatter of filter taps into a framebuffer, as one chain of kernels a call
// on the caller's stream, with no host read.
//
// What it replaces.  No TPU kernel: the JAX package's splat
// (corona13_tpu/ops/splat.py) is XLA's scatter-add.  The port's plain path
// (ops/splat.py, _scatter_sorted) makes the scatter reproducible by sorting
// every tap twice by int64 keys, the pixel and then the bits of its three
// colours, and summing each pixel's run serially (segment_reduce); the 4x4
// filters first build their footprint as [N, 4, 4] tensors.  At bdpt's
// camera splats that is 33.2 M taps sorted twice a call, nine in ten of
// them zero.
//
// What bounds it.  Bytes: a splat's two coordinates and three colours read
// once (20 B), a pixel's three floats read and written once (24 B).  The
// filter weights are arithmetic in registers.  The chain:
//   1. count_kernel: a thread a splat (or a given tap) forms its taps, drops
//      those that add nothing and counts the rest a pixel (atomicAdd);
//   2. scan_tiles, scan_tops: the counts' exclusive scan, in tiles of
//      kScanTile and then over the tiles: each pixel's bin;
//   3. place_kernel: each tap again, its colours' bits written into its
//      pixel's bin at a slot from an atomic countdown (the order in a bin
//      is not fixed);
//   4. sum_kernel: a thread a pixel sorts its bin in place by the plain
//      path's key, sums it serially from +0.0 and adds the sum to fb once;
//      a bin of more than kSmall taps is listed for
//   5. big_kernel: a block a bin, a bitonic sort in shared memory (in place
//      in global memory past kBigCap taps), the sum by three threads; the
//      other bins never wait for it.
//
// The same bits as the plain path.  Its key orders a pixel's taps by colour
// 0's bits as unsigned, then colour 1's as signed, then colour 2's as
// unsigned (tap_less); taps of equal key have equal values.  So a pixel's
// sum depends on its taps alone, not on their order in the input or in the
// bin.  The dropped taps: off the film or with a coordinate that is not
// finite (the plain path's keep False, sorted past the last pixel), and
// taps whose three contributions are +-0.0: a serial sum from +0.0 never
// becomes -0.0 under round-to-nearest, x + (+-0.0) = x for every other x,
// and the other taps keep their order.  NaN and inf colours are kept.
//
// Rounding.  The 4x4 filters' weights are the plain path's on the card,
// operation for operation and in its order (-fmad=false): torch divides by
// a Python scalar on CUDA as a product with the float reciprocal, and sums
// the 16 normalisation taps as a tree (tree_sum16).  The JAX package's tests
// hold the CPU's sort path; the card tests hold this chain to the sort path
// on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanTile = 4096;                  // counts a scan_tiles block
constexpr int kPerThread = kScanTile / kThreads;
constexpr int kTopsThreads = 1024;
constexpr int kSmall = 32;                       // taps a bin one thread sorts
constexpr int kBigThreads = 512;
constexpr int kBigCap = 16384;                   // taps sorted in shared memory
constexpr int kBigBlocks = 132;                  // one a streaming multiprocessor

constexpr int kGiven = 0;        // taps given as (flat pixel, keep, colours)
constexpr int kFootprint = 1;    // splats given: their 4x4 footprint

constexpr int kBlackmanHarris = 0;
constexpr int kGaussian = 1;
constexpr int kSpline = 2;

struct Params {
  int mode;
  int filter;
  int n;                  // splats (footprint) or taps (given)
  int w, h;               // the film (footprint)
  int n_pix;              // fb's pixels, its leading axes folded in
  int n_tiles;            // scan tiles over n_pix + 1 counts
  const float* pix_i;     // [n] (footprint)
  const float* pix_j;     // [n]
  const float* col;       // [n, 3]
  const long long* flat;  // [n] (given): the flat pixel
  const bool* keep;       // [n] or null (given)
  const float* vals;      // [n, 3] (given)
  const float* fb;        // [n_pix, 3]
  float* out;             // [n_pix, 3]
  int* count;             // [n_pix + 1]: taps a pixel, zeroed
  int* big;               // [1 + n_pix]: big bins (zeroed), their pixels
  int* start;             // [n_pix + 1]: exclusive scan within the tile
  int* tops;              // [n_tiles + 1]: the tiles' scan, then the total
  uint3* bins;            // [taps]: colour bits, grouped by pixel
};

// --- the 4x4 filters, as ops/splat.py computes them on the card -------------

constexpr float kTwoPi = 6.283185307179586f;     // float(2.0 * math.pi)
constexpr float kThird = 1.0f / 3.0f;            // x / 3.0 on CUDA: x * (1/3)
constexpr float kSixth = 1.0f / 6.0f;
constexpr float kInvSigma = 1.0f / 0.7f;         // gaussian_window's sigma

__device__ __forceinline__ float bh_window(float n) {
  const float x = (n * kTwoPi) * kThird;
  float w = 0.35875f - 0.48829f * cosf(x);
  w = w + 0.14128f * cosf(2.0f * x);
  w = w - 0.01168f * cosf(3.0f * x);
  return (n < 0.0f || n > 3.0f) ? 0.0f : w;
}

__device__ __forceinline__ float gaussian_window(float r) {
  const float q = r * kInvSigma;
  return r <= 2.5f ? expf(-0.5f * (q * q)) : 0.0f;
}

__device__ __forceinline__ float cubic_bspline(float x) {
  const float a = fabsf(x);
  const float near = (0.6666666666666666f - a * a) + ((0.5f * a) * a) * a;
  const float b = 2.0f - a;
  const float far = ((b * b) * b) * kSixth;
  return a < 1.0f ? near : (a < 2.0f ? far : 0.0f);
}

// torch.sum over the 16 taps [v][u] on CUDA: a half-warp a splat, one tap a
// lane, the shuffle tree at offsets 8, 4, 2, 1 (Reduce.cuh, block_x_reduce)
__device__ __forceinline__ float tree_sum16(const float f[16]) {
  float s8[8], s4[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) s8[i] = f[i] + f[i + 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) s4[i] = s8[i] + s8[i + 4];
  return (s4[0] + s4[2]) + (s4[1] + s4[3]);
}

// visit(pixel, c0, c1, c2) for each of splat s's 16 taps that adds something:
// a copy of ops/splat.py's rule (_footprint's mask, _landing, _adds)
template <class Visit>
__device__ __forceinline__ void footprint(const Params& p, int s, Visit visit) {
  const size_t s3 = 3 * (size_t)s;
  const float c0 = p.col[s3], c1 = p.col[s3 + 1], c2 = p.col[s3 + 2];
  // the normalised weights are finite and in [0, 1] (below), so a colour of
  // +-0.0 adds +-0.0 at every tap
  if (c0 == 0.0f && c1 == 0.0f && c2 == 0.0f) return;
  const float pi = p.pix_i[s], pj = p.pix_j[s];
  if (!isfinite(pi) || !isfinite(pj)) return;
  const float fx = floorf(pi - 1.5f), fy = floorf(pj - 1.5f);
  if (!(fx > -4.0f && fx < (float)p.w && fy > -4.0f && fy < (float)p.h))
    return;                                       // every tap off the film
  const int x0 = (int)fx, y0 = (int)fy;
  float uu[4], vv[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uu[t] = ((float)(x0 + t) + 0.5f) - pi;
    vv[t] = ((float)(y0 + t) + 0.5f) - pj;
  }
  float f[16];
  if (p.filter == kSpline) {
    float bu[4], bv[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      bu[t] = cubic_bspline(uu[t]);
      bv[t] = cubic_bspline(vv[t]);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) f[k] = bv[k >> 2] * bu[k & 3];
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float u = uu[k & 3], v = vv[k >> 2];
      const float r = sqrtf(u * u + v * v);
      f[k] = p.filter == kGaussian ? gaussian_window(r) : bh_window(r + 1.5f);
    }
  }
  unsigned inb = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int x = x0 + (k & 3), y = y0 + (k >> 2);
    if (x >= 0 && x < p.w && y >= 0 && y < p.h) inb |= 1u << k;
    else f[k] = 0.0f;
  }
  // the weights are >= 0 and the norm at least each of them
  const float norm = fmaxf(tree_sum16(f), 1e-20f);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (!(inb >> k & 1)) continue;
    const float fk = f[k] / norm;
    const float q0 = fk * c0, q1 = fk * c1, q2 = fk * c2;
    if (q0 != 0.0f || q1 != 0.0f || q2 != 0.0f)
      visit((y0 + (k >> 2)) * p.w + x0 + (k & 3), q0, q1, q2);
  }
}

// visit tap m of the given taps if it adds something (_landing, _adds)
template <class Visit>
__device__ __forceinline__ void given(const Params& p, int m, Visit visit) {
  const long long pix = p.flat[m];
  if (pix < 0 || pix >= p.n_pix || (p.keep != nullptr && !p.keep[m])) return;
  const size_t m3 = 3 * (size_t)m;
  const float q0 = p.vals[m3], q1 = p.vals[m3 + 1], q2 = p.vals[m3 + 2];
  if (q0 != 0.0f || q1 != 0.0f || q2 != 0.0f) visit((int)pix, q0, q1, q2);
}

template <class Visit>
__device__ __forceinline__ void taps(const Params& p, int i, Visit visit) {
  if (p.mode == kFootprint) footprint(p, i, visit);
  else given(p, i, visit);
}

__device__ __forceinline__ int bin_start(const Params& p, int pix) {
  return p.start[pix] + p.tops[pix / kScanTile];
}

// the plain path's order: colour 0's bits unsigned, 1's signed, 2's unsigned
__device__ __forceinline__ bool tap_less(uint3 a, uint3 b) {
  if (a.x != b.x) return a.x < b.x;
  if (a.y != b.y) return (int)a.y < (int)b.y;
  return a.z < b.z;
}

__device__ __forceinline__ void write_pixel(const Params& p, int pix,
                                            float s0, float s1, float s2) {
  const size_t o = 3 * (size_t)pix;
  p.out[o] = p.fb[o] + s0;
  p.out[o + 1] = p.fb[o + 1] + s1;
  p.out[o + 2] = p.fb[o + 2] + s2;
}

__global__ void __launch_bounds__(kThreads) count_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  taps(p, i, [&](int pix, float, float, float) { atomicAdd(p.count + pix, 1); });
}

__global__ void __launch_bounds__(kThreads) scan_tiles(const Params p) {
  __shared__ int s[kScanTile];
  __shared__ int warp_sum[kThreads / 32];
  const int n = p.n_pix + 1, base = blockIdx.x * kScanTile;
  for (int i = threadIdx.x; i < kScanTile; i += kThreads)
    s[i] = base + i < n ? p.count[base + i] : 0;
  __syncthreads();
  int v[kPerThread], total = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    v[k] = s[threadIdx.x * kPerThread + k];
    total += v[k];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int run = incl - total;
  for (int w = 0; w < warp; ++w) run += warp_sum[w];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    s[threadIdx.x * kPerThread + k] = run;
    run += v[k];
  }
  if (threadIdx.x == kThreads - 1) p.tops[blockIdx.x] = run;
  __syncthreads();
  for (int i = threadIdx.x; i < kScanTile; i += kThreads)
    if (base + i < n) p.start[base + i] = s[i];
}

// one block: the tiles' totals into their exclusive scan, the sum last
__global__ void __launch_bounds__(kTopsThreads) scan_tops(const Params p) {
  __shared__ int warp_sum[kTopsThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < p.n_tiles; base += kTopsThreads) {
    const int i = base + threadIdx.x;
    const int v = i < p.n_tiles ? p.tops[i] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int ws = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, ws, o);
        if (lane >= o) ws += y;
      }
      warp_sum[lane] = ws;
    }
    __syncthreads();
    if (i < p.n_tiles)
      p.tops[i] = carry + (warp ? warp_sum[warp - 1] : 0) + incl - v;
    carry += warp_sum[kTopsThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) p.tops[p.n_tiles] = carry;
}

__global__ void __launch_bounds__(kThreads) place_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  taps(p, i, [&](int pix, float q0, float q1, float q2) {
    const int slot = atomicSub(p.count + pix, 1) - 1;
    p.bins[bin_start(p, pix) + slot] = make_uint3(
        __float_as_uint(q0), __float_as_uint(q1), __float_as_uint(q2));
  });
}

__global__ void __launch_bounds__(kThreads) sum_kernel(const Params p) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= p.n_pix) return;
  const int b0 = bin_start(p, pix), b1 = bin_start(p, pix + 1);
  if (b1 - b0 > kSmall) {
    p.big[1 + atomicAdd(p.big, 1)] = pix;
    return;
  }
  uint3* bin = p.bins;
  for (int i = b0 + 1; i < b1; ++i) {          // insertion sort, in place
    const uint3 k = bin[i];
    int j = i - 1;
    for (; j >= b0 && tap_less(k, bin[j]); --j) bin[j + 1] = bin[j];
    bin[j + 1] = k;
  }
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int i = b0; i < b1; ++i) {
    const uint3 k = bin[i];
    s0 = s0 + __uint_as_float(k.x);
    s1 = s1 + __uint_as_float(k.y);
    s2 = s2 + __uint_as_float(k.z);
  }
  write_pixel(p, pix, s0, s1, s2);
}

// the block sorts a[0, n) by tap_less: the bitonic network in the form whose
// comparators all put the lesser at the lower index, so that the virtual
// padding past n (greater than any tap) never moves and is never touched
__device__ void block_sort(uint3* a, int n) {
  int np2 = 1;
  while (np2 < n) np2 <<= 1;
  const int pairs = np2 >> 1;
  for (int k = 2; k <= np2; k <<= 1) {
    for (int d = k >> 1; d > 0; d >>= 1) {
      for (int t = threadIdx.x; t < pairs; t += blockDim.x) {
        const int lo = (t / d) * 2 * d + (t % d);
        const int hi = 2 * d == k ? (lo / k) * k + k - 1 - lo % k : lo + d;
        if (hi < n) {
          const uint3 x = a[lo], y = a[hi];
          if (tap_less(y, x)) {
            a[lo] = y;
            a[hi] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kBigThreads) big_kernel(const Params p) {
  extern __shared__ uint3 sh[];
  const int n_big = p.big[0];
  for (int b = blockIdx.x; b < n_big; b += gridDim.x) {
    const int pix = p.big[1 + b];
    const int b0 = bin_start(p, pix), n = bin_start(p, pix + 1) - b0;
    uint3* a = p.bins + b0;
    if (n <= kBigCap) {
      for (int i = threadIdx.x; i < n; i += kBigThreads) sh[i] = a[i];
      a = sh;
    }
    __syncthreads();
    block_sort(a, n);
    if (threadIdx.x < 3) {
      const unsigned* c = reinterpret_cast<const unsigned*>(a) + threadIdx.x;
      float s = 0.0f;
      for (int i = 0; i < n; ++i) s = s + __uint_as_float(c[3 * i]);
      const size_t o = 3 * (size_t)pix + threadIdx.x;
      p.out[o] = p.fb[o] + s;
    }
    __syncthreads();
  }
}

int n_tiles(int n_pix) { return (n_pix + 1 + kScanTile - 1) / kScanTile; }

}  // namespace

extern "C" {

struct Corona13SplatArgs {
  int mode;               // 0 given taps, 1 the 4x4 footprint of splats
  int filter;             // 0 blackmanharris, 1 gaussian, 2 spline
  int n;
  int w, h;
  int n_pix;
  const float* pix_i;
  const float* pix_j;
  const float* col;
  const long long* flat;
  const bool* keep;
  const float* vals;
  const float* fb;
  float* out;
  int* scratch;           // corona13_splat_scratch(n_pix) ints
  void* bins;             // [taps, 3] ints: n * 16 (footprint) or n
  void* stream;
};

// the int32 scratch a call over n_pix pixels takes; its last entry is the
// taps summed
long long corona13_splat_scratch(int n_pix) {
  return 3LL * n_pix + n_tiles(n_pix) + 4;
}

int corona13_splat(const Corona13SplatArgs* a) {
  if (a->n < 0 || a->n_pix < 1 || (a->mode != kGiven && a->mode != kFootprint)
      || a->fb == nullptr || a->out == nullptr || a->scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (a->n > 0 && a->bins == nullptr) return (int)cudaErrorInvalidValue;
  if (a->mode == kFootprint &&
      (a->pix_i == nullptr || a->pix_j == nullptr || a->col == nullptr ||
       a->w < 1 || a->h < 1 || (long long)a->w * a->h != a->n_pix ||
       a->n >= (1 << 27) || a->filter < kBlackmanHarris || a->filter > kSpline))
    return (int)cudaErrorInvalidValue;
  if (a->mode == kGiven && (a->flat == nullptr || a->vals == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.mode = a->mode;
  p.filter = a->filter;
  p.n = a->n;
  p.w = a->w;
  p.h = a->h;
  p.n_pix = a->n_pix;
  p.n_tiles = n_tiles(a->n_pix);
  p.pix_i = a->pix_i;
  p.pix_j = a->pix_j;
  p.col = a->col;
  p.flat = a->flat;
  p.keep = a->keep;
  p.vals = a->vals;
  p.fb = a->fb;
  p.out = a->out;
  p.count = a->scratch;
  p.big = p.count + (a->n_pix + 1);
  p.start = p.big + (1 + a->n_pix);
  p.tops = p.start + (a->n_pix + 1);
  p.bins = (uint3*)a->bins;
  const cudaStream_t st = (cudaStream_t)a->stream;
  // the counts and the big bins' count are adjacent
  cudaError_t err = cudaMemsetAsync(p.count, 0, sizeof(int) * (a->n_pix + 2),
                                    st);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a->n + kThreads - 1) / kThreads;
  if (blocks > 0) count_kernel<<<blocks, kThreads, 0, st>>>(p);
  scan_tiles<<<p.n_tiles, kThreads, 0, st>>>(p);
  scan_tops<<<1, kTopsThreads, 0, st>>>(p);
  if (blocks > 0) place_kernel<<<blocks, kThreads, 0, st>>>(p);
  sum_kernel<<<(a->n_pix + kThreads - 1) / kThreads, kThreads, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int smem = kBigCap * (int)sizeof(uint3);
  err = cudaFuncSetAttribute(big_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  big_kernel<<<kBigBlocks, kBigThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
