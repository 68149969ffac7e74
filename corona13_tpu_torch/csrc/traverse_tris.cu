// BVH8 triangle traversal for the H100 (sm_90a).
//
// Replaces the Pallas TPU kernel corona13_tpu/ops/trace_pallas.py
// (_kernel, launched by traverse_tris at trace_pallas.py:284).  It walks
// the collapse8 layout of corona13_tpu/ops/bvh.py:
//   wbounds     [Wn, 8, 8] f32  per child: min3, max3, push weight, pad
//                               (weight 2^c inner, 256*2^c leaf, 0 empty)
//   wlinks      [Wn * 8]   i32  child link: wide node id or leaf id
//   leaf_packed [nl, 8, 16] f32 per row: v0, e1, e2, prim id as f32
//
// One thread per ray with a private stack in local memory.  The slab and
// Moeller-Trumbore expressions are the TPU kernel's, term for term, and
// the file is built with -fmad=false so they round like the plain torch
// version in ops/trace_cuda.py.  Children are pushed in ascending order
// (the TPU kernel's packet order restricted to this ray's hits); the
// winner inside a leaf is the minimum of (bits(t) & ~7) | row, so ties
// within the low 3 mantissa bits go to the lower row as on the TPU.
//
// Bound on this card: divergent, latency-bound 256 B node and 512 B leaf
// gathers and the local-memory stack; no matrix work.
//
// kCounters (the TPU kernel's want_counters, its ACCEL_DEBUG analogue)
// adds each ray's inner-node and leaf pops to two int32 outputs; the
// wrapper sums them per 1024-ray block.  It is a template flag, so the
// closest-hit and any-hit launches of the render path carry no counting.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStack = 192;  // >= wdepth*7+8, checked at BVH upload
constexpr int kLeaf = 8;
constexpr int kNoHit = 0x7f000000;
constexpr int kThreads = 128;

template <bool kAnyHit, bool kCounters>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(const float* __restrict__ wbounds,
                const int* __restrict__ wlinks,
                const float* __restrict__ leaf,
                const float* __restrict__ org,
                const float* __restrict__ dir,
                const float* __restrict__ inv,
                const float* __restrict__ t_init,
                const int* __restrict__ ignore1,
                const int* __restrict__ ignore2,
                int n,
                float* __restrict__ t_out, int* __restrict__ prim_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                int* __restrict__ slot_out,
                int* __restrict__ iters_out, int* __restrict__ leafs_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t_best = t_init[i];
  int prim = -1, slot = -1;
  float u = 0.f, v = 0.f;
  int iters = 0, leafs = 0;
  if (t_best > 0.f) {
    const float ox = org[3 * i], oy = org[3 * i + 1], oz = org[3 * i + 2];
    const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
    const float ix = inv[3 * i], iy = inv[3 * i + 1], iz = inv[3 * i + 2];
    const int ig1 = ignore1[i], ig2 = ignore2[i];
    int stack[kMaxStack];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const int entry = stack[--sp];
      if (entry >= 0) {
        if (kCounters) ++iters;
        const float* blk = wbounds + (size_t)entry * 64;
        const int* lnk = wlinks + (size_t)entry * 8;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float* b = blk + c * 8;
          const float w = b[6];
          const float t0x = (b[0] - ox) * ix, t1x = (b[3] - ox) * ix;
          const float t0y = (b[1] - oy) * iy, t1y = (b[4] - oy) * iy;
          const float t0z = (b[2] - oz) * iz, t1z = (b[5] - oz) * iz;
          const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                 fmaxf(fminf(t0z, t1z), 0.f));
          const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                 fminf(fmaxf(t0z, t1z), t_best));
          if (w != 0.f && tn <= tf && tf > 0.f && sp < kMaxStack) {
            const int link = lnk[c];
            stack[sp++] = (w >= 256.f) ? -link - 1 : link;
          }
        }
      } else {
        if (kCounters) ++leafs;
        const int lid = -entry - 1;
        const float* rows = leaf + (size_t)lid * (kLeaf * 16);
        int best = kNoHit;
        float bt = 0.f, bu = 0.f, bv = 0.f;
        int bc = -1;
        for (int k = 0; k < kLeaf; ++k) {
          const float* r = rows + k * 16;
          const float v0x = r[0], v0y = r[1], v0z = r[2];
          const float e1x = r[3], e1y = r[4], e1z = r[5];
          const float e2x = r[6], e2y = r[7], e2z = r[8];
          const int cand = (int)r[9];
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const float inv_det = fabsf(det) < 1e-20f ? 0.f : 1.f / det;
          const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
          const float b_v = (tx * px + ty * py + tz * pz) * inv_det;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float b_u = (dx * qx + dy * qy + dz * qz) * inv_det;
          const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const bool ok = b_v >= 0.f && b_v <= 1.f && b_u >= 0.f &&
                          b_u + b_v <= 1.f && tt > 0.f && tt < t_best &&
                          cand >= 0 && cand != ig1 && cand != ig2;
          if (ok) {
            const int enc = (__float_as_int(tt) & ~7) | k;
            if (enc < best) {
              best = enc;
              bt = tt; bu = b_u; bv = b_v; bc = cand;
            }
          }
        }
        if (best < kNoHit) {
          if (kAnyHit) {
            prim = 0;
            t_best = -1.f;
            break;
          }
          t_best = bt;
          u = bu;
          v = bv;
          prim = bc;
          slot = lid * kLeaf + (best & 7);
        }
      }
    }
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
  u_out[i] = u;
  v_out[i] = v;
  slot_out[i] = slot;
  if (kCounters) {
    iters_out[i] = iters;
    leafs_out[i] = leafs;
  }
}

template <bool kAnyHit, bool kCounters>
void launch(int blocks, cudaStream_t stream, const float* wbounds,
            const int* wlinks, const float* leaf, const float* org,
            const float* dir, const float* inv, const float* t_init,
            const int* ignore1, const int* ignore2, int n, float* t_out,
            int* prim_out, float* u_out, float* v_out, int* slot_out,
            int* iters_out, int* leafs_out) {
  traverse_kernel<kAnyHit, kCounters><<<blocks, kThreads, 0, stream>>>(
      wbounds, wlinks, leaf, org, dir, inv, t_init, ignore1, ignore2, n,
      t_out, prim_out, u_out, v_out, slot_out, iters_out, leafs_out);
}

}  // namespace

// Plain C entry point (no torch headers here); bind.cpp wraps it and
// checks the launch.  iters_out/leafs_out: per-ray pop counts, or null for
// the launches without counters.
extern "C" void corona13_traverse_tris(
    const float* wbounds, const int* wlinks, const float* leaf,
    const float* org, const float* dir, const float* inv,
    const float* t_init, const int* ignore1, const int* ignore2, int n,
    float* t_out, int* prim_out, float* u_out, float* v_out, int* slot_out,
    int* iters_out, int* leafs_out, int any_hit, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  using Launch = void (*)(int, cudaStream_t, const float*, const int*,
                          const float*, const float*, const float*,
                          const float*, const float*, const int*, const int*,
                          int, float*, int*, float*, float*, int*, int*, int*);
  Launch fn;
  if (iters_out != nullptr) {
    fn = any_hit ? static_cast<Launch>(&launch<true, true>)
                 : static_cast<Launch>(&launch<false, true>);
  } else {
    fn = any_hit ? static_cast<Launch>(&launch<true, false>)
                 : static_cast<Launch>(&launch<false, false>);
  }
  fn(blocks, stream, wbounds, wlinks, leaf, org, dir, inv, t_init, ignore1,
     ignore2, n, t_out, prim_out, u_out, v_out, slot_out, iters_out,
     leafs_out);
}
