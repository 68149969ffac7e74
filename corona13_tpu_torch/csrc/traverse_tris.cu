// BVH8 triangle traversal for the H100 (sm_90a).
//
// Replaces the Pallas TPU kernel corona13_tpu/ops/trace_pallas.py
// (_kernel, launched by traverse_tris at trace_pallas.py:284): closest-hit,
// any-hit and the want_counters debug walk.  It computes, ray for ray, what
// traverse_tris_plain in ops/trace_cuda.py computes.
//
// What bounds it on this card.  There is no matrix product here: the
// 8-child slab test and the 8-row Moeller-Trumbore test are SIMD inside
// one thread, so the tensor cores and wgmma do not apply.  On the main
// path's small trees the floor is bytes (about 70 B a ray in and out); on a
// deep tree it is fp32 operations (224 an inner pop, 432 a leaf pop).  In
// practice the kernel waits on divergent gathers of node and leaf records
// and on its stack, and idles on dead lanes and on the slowest ray of a
// warp.  The design goes at each of those:
//
//   layout   The kernel walks its own records, repacked from collapse8's
//            arrays at upload (ops/trace_cuda.py: pack_kernel_layout).  A
//            wide node is 16 float4 (per child: min.xyz, max.x | max.yz,
//            push weight, link as int bits; the link sits in the
//            reference layout's pad word, so there is no second gather).
//            A leaf row is 3 float4 (v0.xyz, prim id as int bits | e1 |
//            e2).  Every load is a 16-byte ld.global.nc.
//   stack    In shared memory, laid out [entry][thread] so a warp's 32
//            accesses fall in 32 banks.  Its depth is a launch argument,
//            wdepth*7+8 as computed at upload (at most 192), and sizes the
//            dynamic shared memory: 128 threads x depth x 4 B, i.e. 7.5 KB
//            for a one-node tree, 25 KB at wdepth 6, 96 KB at the limit
//            (above 48 KB through cudaFuncSetAttribute).  The push guard
//            sp < depth stays.
//   loop     Aila and Laine's while-while: pop inner nodes until a leaf is
//            on top, then leaves until an inner node is on top.  Each
//            thread pops its own entries in the same order as a single
//            loop would; only the warp's convergence changes.
//   rays     Closest-hit and any-hit launch a persistent grid (as many
//            blocks as are resident at once, 6 an SM).  A warp takes its
//            own batch of 32 consecutive rays first and then the batches a
//            global counter deals out; it writes a batch's dead rays
//            (t_init <= 0) out at once and hands the live ones to its idle
//            lanes (ballot compaction); a lane whose ray ends takes the
//            next live ray at the warp's next step.
//            The last warp out zeroes the counter for the next launch.  A
//            ray's walk does not depend on the lane that walks it, so
//            outputs are the same from run to run.
//   wrapper  The kernel derives the clamped inverse direction itself (IEEE
//            division, the bits of torch's reciprocal), takes the ignore
//            ids as int32 or int64 or not at all, takes t_init as a tensor
//            or one value for all rays, and writes prim and slot as int64
//            (or only a blocked byte), so the callers add no passes.
//
// Order and rounding are the TPU kernel's: children are pushed in
// ascending child index (its packet order restricted to this ray's hits),
// an exact-t tie between leaves goes to the first visited (tt < t_best),
// the winner inside a leaf is the minimum of (bits(t) & ~7) | row, and the
// file is built with -fmad=false so the slab and Moeller-Trumbore
// expressions round term for term like the plain version.  Any-hit
// returns a flag that does not depend on the order, but keeps it: testing
// a node's leaf children before its inner ones measured 4-8% slower.
// Tried and measured no faster, so not here: the tree's top levels staged
// in shared memory (L1 serves them as well), skipping the arithmetic of
// empty children and rows (the branches cost more than they save), larger
// chunks per atomic, asking the counter one batch ahead.
//
// The counters launches (want_counters, the ACCEL_DEBUG analogue, on no
// render path) keep the simple assignment, thread i walks ray i, share
// the layout, the stack and the loop, and count each ray's own pops in
// the reference order.
//
// The leaf test is a policy class (TriangleLeaf) chosen by a template
// parameter of the kernel: the seam for the leaf tests still to come.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLeaf = 8;
constexpr int kNoHit = 0x7f000000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNodeVec = 16;  // float4 per wide node
// __launch_bounds__' minimum of resident blocks per SM: 6 caps a thread at
// 80 registers (unbounded the compiler takes 88-96 and only 5 blocks fit).
constexpr int kMinBlocks = 6;

struct Params {
  const float4* nodes;
  const float4* leaves;
  const float* org;
  const float* dir;
  const float* t_init;  // [n], or null: t_all for every ray
  float t_all;
  const void* ignore1;  // [n] int32 or int64, or null: none
  const void* ignore2;
  int ignore_is64;
  int n;
  int depth;  // stack entries per thread
  float* t_out;  // t, prim, u, v, slot: all five or all null
  long long* prim_out;
  float* u_out;
  float* v_out;
  long long* slot_out;
  unsigned char* blocked_out;  // or null
  int* iters_out;  // per-ray pops (counters launches), or null
  int* leafs_out;
  int* work;  // persistent launches: [0] batches dealt out by the counter,
              // [1] warps that are done; both zero between launches
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float t, u, v;
  int ig1, ig2, prim, slot;
  int iters, leafs;
};

__device__ __forceinline__ int load_ignore(const void* ids, int i, int is64) {
  if (ids == nullptr) return -1;
  return is64 ? (int)__ldg((const long long*)ids + i)
              : __ldg((const int*)ids + i);
}

// Position of the k-th (from 0) set bit of m, which has more than k.
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  int pos = 0;
  int c = __popc(m & 0xffffu);
  if (k >= c) { k -= c; m >>= 16; pos += 16; }
  c = __popc(m & 0xffu);
  if (k >= c) { k -= c; m >>= 8; pos += 8; }
  c = __popc(m & 0xfu);
  if (k >= c) { k -= c; m >>= 4; pos += 4; }
  c = __popc(m & 0x3u);
  if (k >= c) { k -= c; m >>= 2; pos += 2; }
  if (k >= (int)(m & 1u)) pos += 1;
  return pos;
}

__device__ __forceinline__ float clamped_inverse(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.f ? -1e-20f : 1e-20f) : d);
}

__device__ __forceinline__ void load_ray(const Params& p, int i, float t,
                                         Ray& r) {
  const float* o = p.org + (size_t)i * 3;
  const float* d = p.dir + (size_t)i * 3;
  r.ox = __ldg(o); r.oy = __ldg(o + 1); r.oz = __ldg(o + 2);
  r.dx = __ldg(d); r.dy = __ldg(d + 1); r.dz = __ldg(d + 2);
  r.ix = clamped_inverse(r.dx);
  r.iy = clamped_inverse(r.dy);
  r.iz = clamped_inverse(r.dz);
  r.ig1 = load_ignore(p.ignore1, i, p.ignore_is64);
  r.ig2 = load_ignore(p.ignore2, i, p.ignore_is64);
  r.t = t;
}

template <bool kCounters>
__device__ __forceinline__ void store_ray(const Params& p, int i,
                                          const Ray& r) {
  if (p.blocked_out != nullptr) p.blocked_out[i] = r.prim >= 0;
  if (p.t_out != nullptr) {
    p.t_out[i] = r.t;
    p.prim_out[i] = r.prim;
    p.u_out[i] = r.u;
    p.v_out[i] = r.v;
    p.slot_out[i] = r.slot;
  }
  if (kCounters) {
    p.iters_out[i] = r.iters;
    p.leafs_out[i] = r.leafs;
  }
}

// One inner pop: slab-test the 8 children of the wide node at `rec` and
// push the hit ones in ascending child index (a leaf as -link-1).
__device__ __forceinline__ void pop_inner(const float4* __restrict__ rec,
                                          const Ray& r, int* stack, int& sp,
                                          int depth) {
  unsigned hit = 0, leafm = 0;
  int link[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 a = __ldg(rec + 2 * c);      // min.xyz, max.x
    const float4 b = __ldg(rec + 2 * c + 1);  // max.yz, weight, link
    const float w = b.z;
    const float t0x = (a.x - r.ox) * r.ix, t1x = (a.w - r.ox) * r.ix;
    const float t0y = (a.y - r.oy) * r.iy, t1y = (b.x - r.oy) * r.iy;
    const float t0z = (a.z - r.oz) * r.iz, t1z = (b.y - r.oz) * r.iz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), 0.f));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fminf(fmaxf(t0z, t1z), r.t));
    if (w != 0.f && tn <= tf && tf > 0.f) hit |= 1u << c;
    if (w >= 256.f) leafm |= 1u << c;
    link[c] = __float_as_int(b.w);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if ((hit >> c) & 1u)
      if (sp < depth)
        stack[sp++ * kThreads] = ((leafm >> c) & 1u) ? -link[c] - 1 : link[c];
}

// The triangle leaf test: Moeller-Trumbore on one packed row
// (v0.xyz, prim bits | e1.xyz, - | e2.xyz, -).  True where the row is hit
// in (0, r.t) by a prim that is not excluded.
struct TriangleLeaf {
  static constexpr int kRowVec = 3;  // float4 per row
  static __device__ __forceinline__ bool test(const float4* __restrict__ row,
                                              const Ray& r, float& tt,
                                              float& b_u, float& b_v,
                                              int& cand) {
    const float4 q0 = __ldg(row), q1 = __ldg(row + 1),
                 q2 = __ldg(row + 2);
    const float v0x = q0.x, v0y = q0.y, v0z = q0.z;
    const float e1x = q1.x, e1y = q1.y, e1z = q1.z;
    const float e2x = q2.x, e2y = q2.y, e2z = q2.z;
    cand = __float_as_int(q0.w);
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const float inv_det = fabsf(det) < 1e-20f ? 0.f : 1.f / det;
    const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
    b_v = (tx * px + ty * py + tz * pz) * inv_det;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    b_u = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    return b_v >= 0.f && b_v <= 1.f && b_u >= 0.f && b_u + b_v <= 1.f &&
           tt > 0.f && tt < r.t && cand >= 0 && cand != r.ig1 &&
           cand != r.ig2;
  }
};

// One leaf pop: test the 8 rows of leaf `lid`; the winner is the minimum
// of (bits(t) & ~7) | row.  Returns true when the ray is finished (any-hit
// found a blocker).
template <class Leaf, bool kAnyHit>
__device__ __forceinline__ bool pop_leaf(const float4* __restrict__ rows,
                                         int lid, Ray& r) {
  int best = kNoHit;
  float bt = 0.f, bu = 0.f, bv = 0.f;
  int bc = -1;
#pragma unroll
  for (int k = 0; k < kLeaf; ++k) {
    float tt, b_u, b_v;
    int cand;
    if (Leaf::test(rows + k * Leaf::kRowVec, r, tt, b_u, b_v, cand)) {
      const int enc = (__float_as_int(tt) & ~7) | k;
      if (enc < best) {
        best = enc;
        bt = tt; bu = b_u; bv = b_v; bc = cand;
      }
    }
  }
  if (best < kNoHit) {
    if (kAnyHit) {
      r.prim = 0;
      r.t = -1.f;
      return true;
    }
    r.t = bt;
    r.u = bu;
    r.v = bv;
    r.prim = bc;
    r.slot = lid * kLeaf + (best & 7);
  }
  return false;
}

// kPersistent: warps fetch rays from p.work until none are left.
// Otherwise thread i of the grid walks ray i (the counters launches).
template <class Leaf, bool kAnyHit, bool kCounters, bool kPersistent>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
traverse_kernel(const Params p) {
  extern __shared__ int smem[];
  int* stack = smem + threadIdx.x;  // entry e of this thread: stack[e * kThreads]
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;

  // Warp-uniform fetch state.  A warp looks at its own batch of 32 rays
  // first; a persistent launch then takes the batches the counter deals
  // out.  pend: the live rays of the last batch that no lane has taken.
  int own = 32 * (blockIdx.x * kWarps + (threadIdx.x >> 5));
  const int dealt_from = 32 * gridDim.x * kWarps;
  bool more = true;
  unsigned pend = 0;
  int pend_base = 0;
  float pend_t = 0.f;  // this lane's t_init in the pending batch

  int ray = -1;  // the ray this lane walks, -1: idle
  int sp = 0;
  Ray r;

  for (;;) {
    unsigned active = __ballot_sync(kFull, ray >= 0);
    if (active != kFull && (pend != 0 || more)) {
      unsigned idle = ~active;
      while (idle != 0) {
        if (pend == 0) {
          if (!more) break;
          int base = own;
          if (own < 0) {
            if (lane == 0) base = dealt_from + 32 * atomicAdd(p.work, 1);
            base = __shfl_sync(kFull, base, 0);
          }
          own = -1;
          if (!kPersistent) more = false;
          if (base >= p.n) {
            more = false;
            break;
          }
          const int idx = base + lane;
          const bool in = idx < p.n;
          pend_t = 0.f;
          if (in) pend_t = p.t_init != nullptr ? __ldg(p.t_init + idx) : p.t_all;
          const bool alive = in && pend_t > 0.f;
          if (in && !alive) {  // a dead lane does no work: t stays t_init
            Ray dead;
            dead.t = pend_t; dead.u = 0.f; dead.v = 0.f;
            dead.prim = -1; dead.slot = -1; dead.iters = 0; dead.leafs = 0;
            store_ray<kCounters>(p, idx, dead);
          }
          pend = __ballot_sync(kFull, alive);
          pend_base = base;
          continue;
        }
        // the idle lane of rank k takes the k-th pending ray
        const int n_pend = __popc(pend);
        const int take = min(__popc(idle), n_pend);
        const int rank = __popc(idle & lanes_below);
        const bool mine = ((idle >> lane) & 1u) && rank < take;
        int src = lane;  // a whole batch onto a whole idle warp: in place
        if (pend != kFull || idle != kFull) src = mine ? nth_set_bit(pend, rank) : 0;
        const float t0 = __shfl_sync(kFull, pend_t, src);
        if (mine) {
          ray = pend_base + src;
          load_ray(p, ray, t0, r);
          r.u = 0.f; r.v = 0.f; r.prim = -1; r.slot = -1;
          r.iters = 0; r.leafs = 0;
          stack[0] = 0;  // the root
          sp = 1;
        }
        // drop the `take` lowest pending rays
        pend = take == n_pend
                   ? 0u
                   : pend & ~((2u << nth_set_bit(pend, take - 1)) - 1u);
        idle = ~__ballot_sync(kFull, ray >= 0);
      }
      active = __ballot_sync(kFull, ray >= 0);
    }
    if (active == 0) break;

    if (ray >= 0) {
      // while-while: inner nodes until a leaf is on top ...
      while (sp > 0) {
        const int entry = stack[(sp - 1) * kThreads];
        if (entry < 0) break;
        --sp;
        if (kCounters) ++r.iters;
        const float4* rec = p.nodes + (size_t)entry * kNodeVec;
        pop_inner(rec, r, stack, sp, p.depth);
      }
      // ... then leaves until an inner node is on top
      while (sp > 0) {
        const int entry = stack[(sp - 1) * kThreads];
        if (entry >= 0) break;
        --sp;
        if (kCounters) ++r.leafs;
        const int lid = -entry - 1;
        const float4* rows =
            p.leaves + (size_t)lid * (kLeaf * Leaf::kRowVec);
        if (pop_leaf<Leaf, kAnyHit>(rows, lid, r)) sp = 0;
      }
      if (sp == 0) {
        store_ray<kCounters>(p, ray, r);
        ray = -1;
      }
    }
    __syncwarp();
  }
  // the last warp out leaves the counters at zero for the next launch
  if (kPersistent && lane == 0) {
    __threadfence();
    if (atomicAdd(p.work + 1, 1) == (int)gridDim.x * kWarps - 1) {
      p.work[0] = 0;
      p.work[1] = 0;
    }
  }
}

template <bool kAnyHit, bool kCounters, bool kPersistent>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = traverse_kernel<TriangleLeaf, kAnyHit, kCounters, kPersistent>;
  const size_t smem = (size_t)p.depth * kThreads * sizeof(int);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int blocks = (p.n + kThreads - 1) / kThreads;
  if (kPersistent) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, kThreads, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    if (blocks > sms * per_sm) blocks = sms * per_sm;
  }
  kern<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes (ops/trace_cuda.py); returns the
// launch's cudaError_t (0: launched).  nodes/leaves: the kernel layout.
// t_init null: every ray starts at t_all.  ignore1/ignore2: [n] int64
// (ignore_is64) or int32, or null.  Outputs: (t, prim, u, v, slot)
// together or all null; blocked_out [n] bytes or null.  iters_out and
// leafs_out non-null select the counters launch (thread i walks ray i,
// per-ray pop counts); otherwise the launch is persistent and `work`
// points at two int32 zeros, which the launch leaves zero again.
extern "C" int corona13_traverse_tris(
    const void* nodes, const void* leaves, int depth, const float* org,
    const float* dir, const float* t_init, float t_all, const void* ignore1,
    const void* ignore2, int ignore_is64, int n, float* t_out,
    long long* prim_out, float* u_out, float* v_out, long long* slot_out,
    unsigned char* blocked_out, int* iters_out, int* leafs_out, int* work,
    int any_hit, void* stream) {
  Params p;
  p.nodes = (const float4*)nodes;
  p.leaves = (const float4*)leaves;
  p.org = org;
  p.dir = dir;
  p.t_init = t_init;
  p.t_all = t_all;
  p.ignore1 = ignore1;
  p.ignore2 = ignore2;
  p.ignore_is64 = ignore_is64;
  p.n = n;
  p.depth = depth;
  p.t_out = t_out;
  p.prim_out = prim_out;
  p.u_out = u_out;
  p.v_out = v_out;
  p.slot_out = slot_out;
  p.blocked_out = blocked_out;
  p.iters_out = iters_out;
  p.leafs_out = leafs_out;
  p.work = work;
  if (n <= 0 || depth < 1 || (n >> 30) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (iters_out != nullptr) {
    if (leafs_out == nullptr) return (int)cudaErrorInvalidValue;
    return (int)(any_hit ? launch<true, true, false>(p, s)
                         : launch<false, true, false>(p, s));
  }
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  return (int)(any_hit ? launch<true, false, true>(p, s)
                       : launch<false, false, true>(p, s));
}
