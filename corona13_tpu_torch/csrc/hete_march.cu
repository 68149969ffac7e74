// The heterogeneous grid's march for the H100 (sm_90a): free-flight
// sampling and transmittance through the dense density grid of
// models/medium_hete.py, one thread a lane, in one launch a call.
//
// It computes, lane for lane, what medium_hete.sample_dist and
// medium_hete.transmittance compute with eager torch ops over [N, 64] and
// [N, 64, 3] tensors, and writes the result where medium.sample_dist_scene
// and medium.transmittance_scene would put it with torch.where: into the
// homogeneous results, at the lanes whose current medium is the grid's
// material.  Every other lane returns at once and its outputs stay as they
// are.
//
// What bounds it.  A grid lane reads about 40 bytes and writes at most
// 21, and makes up to 64 nearest-voxel lookups into the grid (64^3
// floats, 1 MB: resident in the 50 MB L2) with a running sum; there is no
// reuse a tile could exploit, so one thread walks one lane in registers.
// The bytes in and out once take 0.05-0.07 of its time on an H100; the
// lookups hold it: a 32-byte L2 sector each, about 4 TB/s of them at
// 0031_hete's NEE calls (chip_smoke.py, hete_march_phase).
//
// Rounding.  Each step's optical depth dtau is the plain path's, operation
// for operation and in its order (-fmad=false, IEEE division): the segment
// [a, b] of _segment, dx = (b - a) / 64, t_i = a + (i + 0.5) dx,
// x = org + t_i w, _voxel's rel = (x - lo) / max(hi - lo, 1e-20) * res,
// the floor and the flat index, rho (0 outside), dtau = (rho sigma_t) dx.
// Minima, maxima and clamps propagate NaN as torch's do.  Only the running
// sum differs: it is kept in double in index order and rounded to float at
// each step, as torch's CPU cumsum does; torch.sum and the card's scan
// reduce in trees, so cum and T differ from theirs in the last bits.
//
// Gradients.  The optical depth is sigma_t dx times the sum of the
// densities looked up, whose lookups (floor) have no gradient in the ray:
// tau = sigma_t dx R, and where the free flight crosses its target at step
// k, cum_before = sigma_t dx R_before and dtau_k = rho_k sigma_t dx.  With
// aux given, a grid lane writes what models/medium.py needs to rebuild the
// plain march's gradient from [a, b] by autograd: transmit (R, -, -),
// sample (k, R_before, rho_k), or (0, 0, 0) where it does not cross.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 64;       // medium_hete.N_MARCH
constexpr int kThreads = 256;
constexpr int kSample = 0;       // medium_hete.sample_dist
constexpr int kTransmit = 1;     // medium_hete.transmittance

struct Params {
  int mode;
  int n;
  int mf;                 // hero lanes of the weight / transmittance rows
  int nx, ny, nz;         // density.shape[::-1]
  long long mat_id;
  int med_is64;
  const void* med;        // [n] int64 or int32
  const float* org;       // [n, 3]
  const float* dir;       // [n, 3]
  const float* t_max;     // [n]: t_hit (sample) or dist (transmit)
  const float* rnd;       // [n] (sample)
  const float* density;   // [nz, ny, nx]
  const float* lo;        // [3]
  const float* hi;        // [3]
  const float* sigma_t;   // 0-d
  const float* sigma_s;   // 0-d (sample)
  bool* scat;             // [n] (sample), updated at grid lanes
  float* dist;            // [n] (sample)
  float* weight;          // [n, mf]: the weight (sample) or T (transmit)
  float* aux;             // [n, 3] or null: what a gradient needs (below)
};

// torch's NaN-propagating minimum / maximum and clamps
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}

__global__ void __launch_bounds__(kThreads)
hete_march_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const long long m = p.med_is64 ? ((const long long*)p.med)[i]
                                 : (long long)((const int*)p.med)[i];
  if (m != p.mat_id) return;

  const size_t i3 = 3 * (size_t)i;
  const float o[3] = {p.org[i3], p.org[i3 + 1], p.org[i3 + 2]};
  const float w[3] = {p.dir[i3], p.dir[i3 + 1], p.dir[i3 + 2]};
  float lo[3], rel_scale[3];
  const float res[3] = {(float)p.nx, (float)p.ny, (float)p.nz};
  // _segment: the ray-box overlap clipped to [0, min(t_max, 1e4)]
  float near = 0.f, far = 0.f;
  for (int c = 0; c < 3; ++c) {
    lo[c] = __ldg(p.lo + c);
    const float hi = __ldg(p.hi + c);
    rel_scale[c] = clamp_lo(hi - lo[c], 1e-20f);
    const float wc = fabsf(w[c]) < 1e-20f ? 1e-20f : w[c];
    const float inv = 1.0f / wc;
    const float t0 = (lo[c] - o[c]) * inv;
    const float t1 = (hi - o[c]) * inv;
    const float tn = tmin(t0, t1), tf = tmax(t0, t1);
    near = c == 0 ? tn : tmax(near, tn);
    far = c == 0 ? tf : tmin(far, tf);
  }
  const float t_max = p.t_max[i];
  const float a = clamp_lo(near, 0.f);
  const float b = tmax(tmin(far, clamp_hi(t_max, 1e4f)), a);
  const float dx = (b - a) / (float)kSteps;
  const float st = __ldg(p.sigma_t);

  float target = 0.f;
  if (p.mode == kSample)
    target = -logf(clamp_lo(1.0f - p.rnd[i], 1e-20f));
  double sum = 0.0;
  float cum = 0.f, cum_before = 0.f, dtau_k = 0.f;
  float rho_sum = 0.f, rho_before = 0.f, rho_k = 0.f;   // for aux
  int k = -1;
  for (int s = 0; s < kSteps; ++s) {
    const float t = a + ((float)s + 0.5f) * dx;
    bool inside = true;
    int ijk[3];
    for (int c = 0; c < 3; ++c) {
      const float x = o[c] + t * w[c];
      const float r = (x - lo[c]) / rel_scale[c] * res[c];
      inside = inside && r >= 0.f && r < res[c];
      ijk[c] = (int)floorf(r);
    }
    const float rho = inside
        ? __ldg(p.density + ((size_t)ijk[2] * p.ny + ijk[1]) * p.nx + ijk[0])
        : 0.f;
    const float dtau = (rho * st) * dx;
    sum += (double)dtau;
    const float prev = cum;
    cum = (float)sum;
    if (p.mode == kSample && cum >= target) {
      k = s;
      cum_before = prev;
      dtau_k = dtau;
      rho_before = rho_sum;
      rho_k = rho;
      break;
    }
    rho_sum += rho;
  }
  const int mf = p.mf;
  float* row = p.weight + (size_t)i * mf;
  float* aux = p.aux == nullptr ? nullptr : p.aux + 3 * (size_t)i;
  if (p.mode == kTransmit) {
    const float tr = expf(-cum);
    for (int l = 0; l < mf; ++l) row[l] = tr;
    if (aux != nullptr) aux[0] = rho_sum;
    return;
  }
  if (aux != nullptr) {
    aux[0] = k >= 0 ? (float)k : 0.f;
    aux[1] = rho_before;
    aux[2] = rho_k;
  }
  bool scatter = false;
  float dist = t_max;
  if (k >= 0) {
    const float frac = (target - cum_before) / clamp_lo(dtau_k, 1e-20f);
    const float f01 = frac != frac ? frac : fminf(fmaxf(frac, 0.f), 1.f);
    const float d = a + ((float)k + f01) * dx;
    scatter = d < t_max;
    if (scatter) dist = d;
  }
  float wgt = 1.f;
  if (scatter) {
    const float ss = __ldg(p.sigma_s);
    wgt = st > 0.f ? ss / clamp_lo(st, 1e-20f) : 0.f;
  }
  p.scat[i] = scatter;
  p.dist[i] = dist;
  for (int l = 0; l < mf; ++l) row[l] = wgt;
}

}  // namespace

extern "C" {

struct Corona13HeteArgs {
  int mode;               // 0 sample (free flight), 1 transmit
  int n;
  int mf;
  int nx, ny, nz;
  long long mat_id;
  int med_is64;
  const void* med;
  const float* org;
  const float* dir;
  const float* t_max;
  const float* rnd;
  const float* density;
  const float* lo;
  const float* hi;
  const float* sigma_t;
  const float* sigma_s;
  bool* scat;
  float* dist;
  float* weight;
  float* aux;
  void* stream;
};

int corona13_hete_march(const Corona13HeteArgs* a) {
  if (a->n <= 0 || (a->n >> 30) != 0 || a->mf < 1 || a->nx < 1 ||
      a->ny < 1 || a->nz < 1 || (a->mode != kSample && a->mode != kTransmit))
    return (int)cudaErrorInvalidValue;
  if (a->med == nullptr || a->org == nullptr || a->dir == nullptr ||
      a->t_max == nullptr || a->density == nullptr || a->lo == nullptr ||
      a->hi == nullptr || a->sigma_t == nullptr || a->weight == nullptr)
    return (int)cudaErrorInvalidValue;
  if (a->mode == kSample &&
      (a->rnd == nullptr || a->sigma_s == nullptr || a->scat == nullptr ||
       a->dist == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.mode = a->mode;
  p.n = a->n;
  p.mf = a->mf;
  p.nx = a->nx; p.ny = a->ny; p.nz = a->nz;
  p.mat_id = a->mat_id;
  p.med_is64 = a->med_is64;
  p.med = a->med;
  p.org = a->org;
  p.dir = a->dir;
  p.t_max = a->t_max;
  p.rnd = a->rnd;
  p.density = a->density;
  p.lo = a->lo;
  p.hi = a->hi;
  p.sigma_t = a->sigma_t;
  p.sigma_s = a->sigma_s;
  p.scat = a->scat;
  p.dist = a->dist;
  p.weight = a->weight;
  p.aux = a->aux;
  const int blocks = (a->n + kThreads - 1) / kThreads;
  hete_march_kernel<<<blocks, kThreads, 0, (cudaStream_t)a->stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
