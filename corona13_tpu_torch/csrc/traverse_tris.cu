// BVH8 triangle traversal for the H100 (sm_90a).
//
// Replaces the Pallas TPU kernel corona13_tpu/ops/trace_pallas.py
// (_kernel, launched by traverse_tris at trace_pallas.py:284): closest-hit,
// any-hit and the want_counters debug walk.  It computes, ray for ray, what
// traverse_tris_plain in ops/trace_cuda.py computes, and the want_counters
// walk what union_walk_plain computes.
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
//            (above 48 KB through cudaFuncSetAttribute).  The line form's
//            closest-hit keeps an entry distance beside each entry, 8 B:
//            51 KB at the hair tree's depth of 50, 192 KB at the limit,
//            where one block is resident an SM whatever kMinBlocks asks
//            (4 warps; a line tree deeper than about 56 entries holds
//            fewer than the four blocks its registers allow, since an SM
//            has 228 KB).  The push guard sp < depth stays.
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
// Order and rounding are the TPU kernel's (the line, moving and sphere
// forms' closest-hit orders are their own, below): children are pushed in
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
// The counters launch (want_counters, the ACCEL_DEBUG analogue, on no
// render path) is the TPU kernel's own walk, union_kernel below: each
// 128-ray tile walks the union of its rays' hits, whose pops are what the
// TPU kernel counts, and gets its hits bit for bit, exact-t ties between
// leaves included (the per-ray walks above may give another leaf there).
// What bounds it: a tile's pops are serial, and every lane tests every
// popped box and row whether its ray needs it or not.  The lane share (the
// per-ray pops over the union's pops times its live lanes) is 0.46-0.65
// on the cornell box, 0.07-0.12 on the plane scene's bounce and shadow
// rays and 0.01 on a 2^17-triangle soup, so the bound chip_smoke.py gives
// it (the operations of the union pops on the lanes still open at the
// pop) is 10-15x the per-ray walk's on the plane and 80-100x on the soup.  Design: one ray
// a thread, a tile's 128 threads (four warps) a group, a block of eight
// groups one 1024-ray counter block; the stack (stack_depth entries of
// 4 B) in shared memory, one a tile; the node and leaf records read as the
// broadcast loads they are; the children's hit masks ORed by a
// __reduce_or_sync a warp and the four warps' words after a named barrier
// of the tile's threads, every thread writing the same pushed entries, so
// that it reads back only its own writes; any-hit's open lanes summed the
// same way; the eight tiles' counts summed in shared memory and written
// once a block: no atomics, no memset, counts that do not depend on
// timing.  Measured against it (NVIDIA H100 80GB HBM3, 700 W, ms at
// 589,824 rays, cornell / plane / 2^17 soup bounce closest-hit, in turns,
// means of two passes): one warp a tile with four rays a lane and the
// warp's own stack, no barrier (127 registers) 0.085 / 2.27 / 87.1 ms, two
// warps a tile with two rays a lane (87) 0.084 / 1.31 / 50.8, kept
// (64 registers, no spills) 0.069 / 1.18 / 45.2; shadow
// any-hit 0.068 / 1.16 / 29.5, 0.071 / 0.70 / 18.8, kept 0.058 / 0.63 /
// 18.1.  A pop's 8 slab tests or 8 rows of 128 rays spread over four
// warps take a quarter of one warp's time, for one barrier a pop.  The per-ray walk with each ray's own pops (simple_walk:
// thread i walks ray i, traverse_kernel's kCounters flag) stays as the
// persistent launch's yardstick.
//
// Beyond the TPU kernel.  The JAX package serves motion-blurred triangles,
// sphere and line BVHs, short prim lists and trees too deep for the stack
// with XLA's lockstep skip-link _traverse (corona13_tpu/ops/trace.py), not
// with Pallas.  A lockstep torch loop would synchronise with the host at
// every step, so this file serves them as further forms of the same kernel:
//
//   leaf policies   The leaf test is a policy class chosen by a template
//            parameter: TriangleLeaf, MovingTriangleLeaf (two records a
//            row, lerped at the ray's time as a*(1-w) + b*w), SphereLeaf
//            and ConeLeaf (a line prim is a truncated cone).  They compute
//            what ops/trace_plain.py computes, operation for operation.
//   winner   TriangleLeaf in the wide walk keeps the TPU kernel's winner,
//            the minimum of (bits(t) & ~7) | row.  Every other policy and
//            form keeps _closest_select's: the smallest t, the first row
//            on an exact tie, accepted when strictly below the running t.
//   ids      A record holds its prim's id local to its kind; the launch
//            takes the kind's offset into the global ids, excludes the
//            ignore ids against the global id and writes global ids.
//   carry    One intersect/occluded call walks triangles, then spheres,
//            then lines, each from the best hit so far.  A launch with
//            `carry` set starts every ray at the t in t_out and writes a
//            ray's outputs only where it found a closer hit (u, v and slot
//            only if its policy produces them); any-hit reads blocked_out,
//            leaves blocked rays alone and sets the flag where it finds a
//            blocker.  No pass runs between the launches of one call.
//   dense    dense_kernel: up to 64 spheres or lines staged in shared
//            memory, every ray against every prim, no tree and no box (the
//            only form that lerps sphere centres in time).  Spheres come
//            from the geometry's own arrays, lines from records that carry
//            each line's terms of the cone test, packed once at upload.
//   deep     deep_kernel: a tree whose wdepth*7+8 exceeds the stack limit
//            has no wide layout; it is walked in _traverse's order over
//            records that hold both children of a binary node, with a
//            stack of its binary levels (the deep form, below).
//   skip     skip_kernel: a tree with more binary levels than the deep
//            walk's stack takes (MAX_BIN_STACK, chosen at upload) is walked
//            stacklessly by its skip links over the binary nodes [n, 8],
//            one ray a thread: _traverse without the lockstep.
//   These forms are bound as the triangle walk is: bytes on small trees
//   and short lists, fp32 operations on deep ones; a simple kernel that is
//   right comes first, and each policy states its own occupancy bound.
//
// The line form (ConeLeaf in the wide walk), laid out for this card.  Its
// winner is _closest_select's, not the TPU kernel's encoding, so nothing
// ties it to the index order.  What bounds it: fp32 operations on a deep
// fibre tree (on the hair frame the plain skip-link walk visits 51 nodes
// and tests 6.2 leaves a camera ray, on the 2^16-line soup 124 and 11.7; a
// cone row is 75 operations, one sqrt and two IEEE divides among them).
// What it waited on: leaves opened behind the ray's nearest hit, a fibre's
// axis, length and slope recomputed for every ray, the root's sqrt and
// divides on rows the ray misses.  Kept, each measured faster at the hair
// frame's shapes and on the soup (NVIDIA H100 80GB HBM3, 700 W):
//   order    closest-hit sorts a node's hit children by entry distance (a
//            19-comparator network) and pushes them far to near, each with
//            its distance in a second shared-memory stack, so the nearest
//            pops first; an entry the running t has passed is dropped at
//            its pop.  8 B an entry: 51 KB a block at the hair tree's depth
//            of 50, four blocks an SM, as the registers allow.  Hair frame
//            9.60 -> 3.31 ms, soup 1.98 -> 1.69 ms a launch.  Any-hit keeps
//            the index order: its t does not move.
//   terms    each fibre's unit axis, length, k and k*k come from its record
//            (computed once at upload with the reference's expressions);
//            the per-ray operations keep the reference's order, and the
//            axial fraction's divide is taken for a leaf's winner only.
//            Alone: hair 14.88 -> 9.93 ms closest-hit and 1.49 -> 1.11 ms
//            any-hit a frame, soup 2.66 -> 2.01 ms.
//   rows     a leaf pop tests its filled rows only (the count in each
//            record's last word; build_bvh pads a leaf at its end): hair
//            3.42 -> 3.31, soup 1.73 -> 1.69 ms.
//   exit     a row whose discriminant is not positive leaves before the
//            sqrt and divides: hair 3.31 -> 2.82 ms closest-hit and 1.10 ->
//            0.96 ms any-hit a frame, soup 1.69 -> 1.54 and 0.59 -> 0.56
//            ms.  The exit changes no result (such a row misses either
//            way); the dense line list takes it too, and reads each line's
//            terms from its record instead of computing them a ray (64
//            lines in the cornell box: 0.269 -> 0.140 ms closest-hit,
//            0.247 -> 0.132 ms any-hit).
// The bound chip_smoke.py gives this form is the one it gives every tree:
// the full 75-operation test on every filled row the plain skip-link walk
// tests, and that walk's index-order visits.  The kernel does less: most
// rows leave at the discriminant (45 operations), and near-first order
// with the pop-time cull pops fewer nodes (its counters launch prints its
// pops beside the walk's).  So the printed share reads higher than the
// kernel earns; chip_smoke.py prints beside it the share with missed rows
// counted up to the discriminant.
// Measured and dropped (closest-hit, hair frame / soup): 6 blocks an SM
// (80 registers, no spills), 2.84 / 1.58 against 2.82 / 1.54 ms (any-hit
// 0.961 against 0.964 ms a hair frame, inside the 0.964-0.973 that one
// tree reads from run to run: not kept for any-hit alone either); the
// nearest child alone on top of the others in index order, 3.34
// / 1.60 against 2.82 / 1.53; the sort skipped under two hit children,
// 2.87 / 1.56.  Four blocks: 96 registers closest-hit, 89 any-hit, no
// spills.
//
// The moving form (MovingTriangleLeaf in the wide walk), laid out for this
// card.  On the 0002_mb frame it walks the plane scene's tree (487 wide
// nodes, 1,315 leaves) with 12 moving triangles among 8,210; the static
// walk of the same tree on the same rays is the least it could approach.
// What it waited on: a second record loaded for every row, though 1,303 of
// 1,315 leaves do not move; padded rows tested in full (78% of the slots
// are filled).  What it got wrong: its order.  The reference's winner on a
// ray that meets two leaves at once (an edge two leaves of a planar mesh
// share) is not the smallest t with a fixed tie rule: its skip-link walk
// tests each box at the running t, and a hit can lie an ulp before its own
// box's entry, so the leaf it reaches first decides.  In index order the
// kernel differed from the plain walk on 5,805 of 65,536 rays aimed at the
// 0002_mb plane's shared edges (scripts/moving_order.py predicted the
// count).  Kept (NVIDIA H100 80GB HBM3, 700 W; ms a 0002_mb frame of five
// launches, closest / any-hit, then the 2^17-triangle moving soup):
//   order    closest-hit walks nodes whose children are in reverse binary
//            preorder and tests a leaf's box again at its pop: it tests
//            the leaves the skip-link walk tests, in its order, and equals
//            it on every ray.  Dearer than index order, which the rays of
//            this scene favour: 0.618 -> 0.696 ms a frame, 3.38 -> 3.68 ms
//            on the soup, against the same records in index order without
//            a cull.  Any-hit's flag does not depend on the order and keeps
//            the index order (in preorder: 0.304 -> 0.384 ms a frame).
//   records  a row's second (shutter-close) record only where it moves,
//            its index in the row's free word, -1 for a static row, which
//            is lerped with itself (the bits of two equal records): 0.766
//            / 0.312 -> 0.696 / 0.303 ms; the soup, where every row moves,
//            unchanged (3.68 / 1.09 ms).
//   rows     a leaf pop tests its filled rows only (the count in each
//            record's last word): 0.703 / 0.354 -> 0.696 / 0.303 ms, soup
//            4.15 / 1.19 -> 3.68 / 1.09 ms.
//   blocks   closest-hit at 6 blocks an SM (80 registers, no spills):
//            0.696 -> 0.681 ms, soup 3.68 -> 3.54 ms.  Any-hit stays at 4
//            (91 registers): at 6, 0.303 -> 0.307 ms a frame.
// Measured and dropped: the children's preorder rank in the push weight's
// exponent, the positions computed a pop (111 registers, 0.757 ms a
// frame); the entry distance in a second stack instead of the test again
// at the pop (8 B entries: 0.704 against 0.701 ms a frame, 3.85 against
// 3.70 ms on the soup).  Not built: near-first order, which cannot keep
// the reference's winner on those edges (emulated with a leaf-rank tie
// rule, it differs on 459 of the 65,536 rays).
//
// The sphere form (SphereLeaf in the wide walk), laid out for this card.
// It serves a sphere BVH of more than 64 spheres; chip_smoke.py's sphere
// frame (65,536 spheres of radii 0.05-0.25 in a slab, a particle render)
// launches it five times a progression for each of closest-hit and
// any-hit.  What it waited on: the leaves behind a ray's nearest hit,
// which the index order tests though the slab stops a camera ray in its
// front layer (the frame's first launch: 1.04 ms, 0.014 of its bound); a
// 32-byte row whose id was loaded for every row, hit or not; padded rows
// tested in full (70.5% of the slots are filled).  What it got wrong: its
// order.  In index order it differed from the plain skip-link walk on 55
// of 65,536 rays aimed at points where two spheres of different leaves
// meet on the frame's tree, and on 352 on the 2^16-sphere soup
// (chip_smoke.sphere_edge_rays; scripts/moving_order.py --kind sphere
// predicted 55 and 351 on the CPU, whose sqrt was then an ulp low).
// Kept (NVIDIA H100 80GB HBM3, 700 W; ms a sphere frame of five launches,
// closest / any-hit, then the soup; each item against the tree without
// it, means of two passes in turns):
//   order    closest-hit walks the preorder nodes and tests a leaf's box
//            again at its pop, as MovingTriangleLeaf's does: it equals the
//            skip-link walk on every ray, and the test at the pop drops
//            the leaves behind the nearest hit: 3.00 -> 2.27 ms a frame
//            (the first launch 1.01 -> 0.34 ms).  The soup, a sparse cloud
//            where a ray rarely stops early, pays for the second box test:
//            1.06 -> 1.19 ms.  Any-hit keeps the index order.
//   records  16 B a row, (c.xyz, r); the id comes from the tree's
//            leaf_prims (p.ids), read for a row that is hit, before the
//            ignore test: 2.30 -> 2.27 ms closest-hit, soup 1.22 / 0.395
//            -> 1.19 / 0.387 ms (any-hit a frame 0.392 / 0.394, within one
//            tree's spread).
//   rows     a leaf pop tests its filled rows only; the count sits in the
//            leaf child's link (lid * 8 + filled - 1, pack_nodes with
//            leaf_fill), so the pop knows it from its entry without a
//            gather: 2.36 -> 2.27 ms; any-hit and the soup unchanged.
// Measured and dropped: r*r stored in the record instead of r (one
// rounding either way, the same bits): 2.273 against 2.271 ms a frame,
// 1.189 against 1.185 ms on the soup, no gain, so the record keeps r and
// the test squares it as the reference does; four blocks an SM (90 / 87
// registers): closest-hit 2.29 against 2.27 ms a frame, any-hit 0.383
// against 0.394 ms a frame but 0.393 against 0.387 ms on the soup.  Six
// blocks, 80 registers both, no spills.
//
// The deep form (deep_kernel), laid out for this card.  It serves a tree
// too deep for the wide stack; chip_smoke.py's zoom frame (a 65,536-
// triangle log-spiral ribbon: wdepth 31, 50 binary levels) launches it
// five times a progression for each of closest-hit and any-hit.  What held
// the stackless skip-link walk back: a chain of dependent 32 B node loads,
// one a node and every child of a hit node visited to test its box (15
// nodes a camera ray of the zoom frame, 155 a bounce ray of the 2^17
// soup); one ray a thread, so a warp and a wave of blocks wait on their
// slowest ray.  Kept (NVIDIA H100 80GB HBM3, 700 W; ms a zoom frame of
// five launches closest / any-hit, then the 2^17-triangle soup, means of
// two passes in turns, against the skip-link walk's 0.813 / 0.217 and
// 3.98 / 0.966):
//   records  both children's boxes and links in the parent, 64 B, four
//            independent loads a step: half the dependent steps (7.0
//            records against 15.1 nodes a camera ray, 77 against 155 on
//            the soup); a leaf child's rows are tested from its parent.
//   stack    the skip-link walk's order: the left child first, the node
//            pushed when its right child is hit as well, and at the pop
//            the right box tested again at the running t, where the
//            skip-link walk tests it (without that test 1,301 of 65,536 rays
//            aimed at the zoom tree's shared edges differ; with it 0).  4 B
//            an entry, the tree's binary levels a thread: 25.6 KB a block
//            at 50 levels, eight blocks an SM as the registers allow.
//   rays     persistent warps with the wide walk's dealer and ballot
//            compaction: without them (one warp a batch, thread i ray i)
//            0.888 / 0.267 ms a frame and 2.54 ms on the soup.
// Together 0.755 / 0.220 ms a frame and 1.92 / 0.576 ms on the soup.  The
// frame's launches after the first bounce have few live rays (43k, 38k,
// 9k of 589,824) and take 0.11-0.16 ms each, set by their slowest rays'
// chains of dependent loads; an all-dead launch costs the dealer 0.020 ms
// against the skip-link walk's 0.005 ms, which is why any-hit a frame is
// no faster.  Measured and dropped: the right child pushed with its entry
// distance (8 B entries, dropped at the pop by a compare, no reload): 0.806
// / 0.238 ms a frame (51 KB a block at 50 levels, four blocks an SM), 1.77
// / 0.568 ms on the soup; four or sixteen batches dealt by one atomic
// (fewer atomics on a sparse launch, but warps wait for work on a full
// one): 0.860 / 0.244 and 1.18 / 0.359 ms a frame.  60 / 54 registers
// (closest / any, triangles), no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLeaf = 8;
constexpr int kNoHit = 0x7f000000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNodeVec = 16;  // float4 per wide node
constexpr int kBinVec = 4;    // float4 per record of the deep walk
constexpr int kDenseMax = 64;  // prims of a dense list

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
  int* iters_out;  // per-ray pops (simple walk) or per block (union), or null
  int* leafs_out;
  int* work;  // persistent launches: [0] batches dealt out by the counter,
              // [1] warps that are done; both zero between launches
  const float4* leaves_t1;  // MovingTriangleLeaf: the moving rows' close records
  const long long* ids;     // SphereLeaf: each leaf slot's prim id, -1 padding
  const float* time;        // [n] ray times in [0, 1], or null
  int prim_offset;          // global id of the kind's prim 0
  int carry;                // start from and update t_out / blocked_out
  int n_nodes;              // skip_kernel: binary nodes
  // dense_kernel: spheres c [S,3], r [S], c_t1 [S,3] or null; lines
  // their records [L,12] in d0
  const float* d0;
  const float* d1;
  const float* d2;
  int n_prims;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float t, u, v, time;
  int ig1, ig2, prim, slot;  // ig1, ig2: local to the kind (id - offset)
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
  r.ig1 = load_ignore(p.ignore1, i, p.ignore_is64) - p.prim_offset;
  r.ig2 = load_ignore(p.ignore2, i, p.ignore_is64) - p.prim_offset;
  r.time = p.time != nullptr ? __ldg(p.time + i) : 0.f;
  r.t = t;
  r.u = 0.f; r.v = 0.f; r.prim = -1; r.slot = -1;
  r.iters = 0; r.leafs = 0;
}

// The t a ray starts from: with carry the running t of an earlier launch
// (0 for a ray that is blocked already), else t_init or t_all.
__device__ __forceinline__ float start_t(const Params& p, int i) {
  if (p.carry) {
    if (p.blocked_out != nullptr && p.blocked_out[i]) return 0.f;
    if (p.t_out != nullptr) return p.t_out[i];
  }
  return p.t_init != nullptr ? __ldg(p.t_init + i) : p.t_all;
}

template <class Leaf, bool kCounters>
__device__ __forceinline__ void store_ray(const Params& p, int i,
                                          const Ray& r) {
  if (p.carry) {  // only what this launch improved
    if (r.prim < 0) return;
    if (p.blocked_out != nullptr) p.blocked_out[i] = 1;
    if (p.t_out != nullptr) {
      p.t_out[i] = r.t;
      p.prim_out[i] = r.prim;
      if (Leaf::kSetsU) p.u_out[i] = r.u;
      if (Leaf::kSetsV) p.v_out[i] = r.v;
      if (Leaf::kSetsSlot) p.slot_out[i] = r.slot;
    }
    return;
  }
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

// Slab test of child c of the wide node at `rec`: true where the ray's
// segment (0, r.t) meets the child's box; tn is the entry distance, w the
// push weight (0: an empty slot, >= 256: a leaf), link the child's link.
__device__ __forceinline__ bool child_hit(const float4* __restrict__ rec,
                                          int c, const Ray& r, float& tn,
                                          float& w, int& link) {
  const float4 a = __ldg(rec + 2 * c);      // min.xyz, max.x
  const float4 b = __ldg(rec + 2 * c + 1);  // max.yz, weight, link
  w = b.z;
  link = __float_as_int(b.w);
  const float t0x = (a.x - r.ox) * r.ix, t1x = (a.w - r.ox) * r.ix;
  const float t0y = (a.y - r.oy) * r.iy, t1y = (b.x - r.oy) * r.iy;
  const float t0z = (a.z - r.oz) * r.iz, t1z = (b.y - r.oz) * r.iz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
             fmaxf(fminf(t0z, t1z), 0.f));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fminf(fmaxf(t0z, t1z), r.t));
  return w != 0.f && tn <= tf && tf > 0.f;
}

// Slab-test the 8 children of the wide node at `rec`: the mask of the hit
// ones, the mask of the leaves and the children's links.
__device__ __forceinline__ void child_masks(const float4* __restrict__ rec,
                                            const Ray& r, unsigned& hit,
                                            unsigned& leafm, int (&link)[8]) {
  hit = 0;
  leafm = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float tn, w;
    if (child_hit(rec, c, r, tn, w, link[c])) hit |= 1u << c;
    if (w >= 256.f) leafm |= 1u << c;
  }
}

// Push the children in `hit` in ascending child index (a leaf as
// -link-1) on a stack whose entries lie kStride ints apart.
template <int kStride>
__device__ __forceinline__ void push_children(unsigned hit, unsigned leafm,
                                              const int (&link)[8],
                                              int* stack, int& sp,
                                              int depth) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (((hit >> c) & 1u) && sp < depth)
      stack[sp++ * kStride] = ((leafm >> c) & 1u) ? -link[c] - 1 : link[c];
}

// One inner pop of a ray's own walk: its hit children pushed on its stack.
__device__ __forceinline__ void pop_inner(const float4* __restrict__ rec,
                                          const Ray& r, int* stack, int& sp,
                                          int depth) {
  unsigned hit, leafm;
  int link[8];
  child_masks(rec, r, hit, leafm, link);
  push_children<kThreads>(hit, leafm, link, stack, sp, depth);
}

// pop_inner for the pop-time box test: a leaf child is pushed as
// -(node * 8 + child) - 1, the place of its box and link, which
// leaf_at_pop reads again when the entry is popped.
__device__ __forceinline__ void pop_inner_slot(const float4* __restrict__ rec,
                                               int node, const Ray& r,
                                               int* stack, int& sp,
                                               int depth) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float tn, w;
    int link;
    if (child_hit(rec, c, r, tn, w, link) && sp < depth)
      stack[sp++ * kThreads] = w >= 256.f ? -(node * 8 + c) - 1 : link;
  }
}

// The leaf of a pop_inner_slot entry (-entry - 1 = node * 8 + child), or
// -1 where its box, tested again at the running t, is missed: the test the
// skip-link walk makes when it reaches that leaf.
__device__ __forceinline__ int leaf_at_pop(const Params& p, int at,
                                           const Ray& r) {
  float tn, w;
  int link;
  return child_hit(p.nodes + (size_t)(at >> 3) * kNodeVec, at & 7, r, tn, w,
                   link)
             ? link
             : -1;
}

// Sort step of pop_inner_near: the larger key first.
__device__ __forceinline__ void order_desc(float& ka, int& va, float& kb,
                                           int& vb) {
  const bool swap = ka < kb;
  const float k = swap ? kb : ka;
  const int v = swap ? vb : va;
  kb = swap ? ka : kb;
  vb = swap ? va : vb;
  ka = k;
  va = v;
}

// One inner pop in near-first order: the slab test of pop_inner, then the
// hit children sorted by entry distance (19-comparator network over the 8
// slots, a missed slot keyed -1) and pushed far to near, each with its
// entry distance in tstack, so that the nearest is popped first and an
// entry that the running t has passed is dropped at its pop.
__device__ __forceinline__ void pop_inner_near(const float4* __restrict__ rec,
                                               const Ray& r, int* stack,
                                               float* tstack, int& sp,
                                               int depth) {
  float key[8];
  int val[8];
  int n_hit = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float tn, w;
    int link;
    const bool hit = child_hit(rec, c, r, tn, w, link);
    key[c] = hit ? tn : -1.f;
    val[c] = w >= 256.f ? -link - 1 : link;
    n_hit += hit;
  }
  order_desc(key[0], val[0], key[2], val[2]);
  order_desc(key[1], val[1], key[3], val[3]);
  order_desc(key[4], val[4], key[6], val[6]);
  order_desc(key[5], val[5], key[7], val[7]);
  order_desc(key[0], val[0], key[4], val[4]);
  order_desc(key[1], val[1], key[5], val[5]);
  order_desc(key[2], val[2], key[6], val[6]);
  order_desc(key[3], val[3], key[7], val[7]);
  order_desc(key[0], val[0], key[1], val[1]);
  order_desc(key[2], val[2], key[3], val[3]);
  order_desc(key[4], val[4], key[5], val[5]);
  order_desc(key[6], val[6], key[7], val[7]);
  order_desc(key[2], val[2], key[4], val[4]);
  order_desc(key[3], val[3], key[5], val[5]);
  order_desc(key[1], val[1], key[4], val[4]);
  order_desc(key[3], val[3], key[6], val[6]);
  order_desc(key[1], val[1], key[2], val[2]);
  order_desc(key[3], val[3], key[4], val[4]);
  order_desc(key[5], val[5], key[6], val[6]);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (c < n_hit && sp < depth) {
      stack[sp * kThreads] = val[c];
      tstack[sp * kThreads] = key[c];
      ++sp;
    }
}

// Moeller-Trumbore on (v0, e1, e2).  True where the triangle is hit in
// (0, r.t); b_u weights vertex 2, b_v vertex 1.
__device__ __forceinline__ bool triangle_hit(
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, const Ray& r, float& tt, float& b_u,
    float& b_v) {
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
         tt > 0.f && tt < r.t;
}

// The nearest positive root of a sphere (centre c, radius rad), in (0, r.t).
__device__ __forceinline__ bool sphere_hit(float cx, float cy, float cz,
                                           float rad, const Ray& r,
                                           float& tt) {
  const float ox = r.ox - cx, oy = r.oy - cy, oz = r.oz - cz;
  const float b = ox * r.dx + oy * r.dy + oz * r.dz;
  const float cc = ox * ox + oy * oy + oz * oz - rad * rad;
  const float disc = b * b - cc;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float t0 = -b - sq, t1 = -b + sq;
  tt = t0 > 0.f ? t0 : t1;
  return disc > 0.f && tt > 0.f && tt < r.t;
}

// The cone test of a line prim from its own terms (unit axis, length, the
// slope k and k*k, the root radius r0), which depend on the prim alone and
// are computed once a prim, at upload: the per-ray operations of the
// reference's test, in its order.  True where hit in (0, r.t); yt is the
// hit's axial coordinate (yt / length is the axial fraction).  A ray whose
// discriminant is not positive misses, so it leaves before the root's sqrt
// and divides (tt and yt then 0).
__device__ __forceinline__ bool cone_test(float v0x, float v0y, float v0z,
                                          float ax, float ay, float az,
                                          float length, float k, float kk,
                                          float r0, const Ray& r, float& tt,
                                          float& yt) {
  const float ox = r.ox - v0x, oy = r.oy - v0y, oz = r.oz - v0z;
  const float ya = ox * ax + oy * ay + oz * az;
  const float wd = r.dx * ax + r.dy * ay + r.dz * az;
  const float ow = ox * r.dx + oy * r.dy + oz * r.dz;
  const float oo = ox * ox + oy * oy + oz * oz;
  const float s = r0 + k * ya;
  const float a = 1.f - wd * wd - kk * wd * wd;
  const float b = 2.f * (ow - ya * wd - k * wd * s);
  const float c = oo - ya * ya - s * s;
  const float disc = b * b - 4.f * a * c;
  if (!(disc > 0.f)) {
    tt = 0.f;
    yt = 0.f;
    return false;
  }
  const float sq = sqrtf(disc);
  const float sgn = b > 0.f ? 1.f : (b < 0.f ? -1.f : b);
  const float q = -0.5f * (b + sgn * sq);
  const float asafe = fabsf(a) < 1e-12f ? 1e-12f : a;
  const float t0 = q / asafe;
  const bool tiny = fabsf(q) < 1e-20f;
  const float t1 = tiny ? 3.4e38f : c / (tiny ? 1.f : q);
  const float tlo = fminf(t0, t1), thi = fmaxf(t0, t1);
  const float ylo = ya + tlo * wd;
  tt = (tlo > 0.f && ylo >= 0.f && ylo <= length) ? tlo : thi;
  yt = ya + tt * wd;
  return tt > 0.f && yt >= 0.f && yt <= length && tt < r.t;
}

// A line prim's axial fraction of the hit, from cone_test's yt.
__device__ __forceinline__ float cone_fraction(float yt, float length) {
  return fminf(fmaxf(yt / length, 0.f), 1.f);
}

// The cone test on a line record (v0.xyz, - | unit axis.xyz, r0 | length,
// k, k*k, -): what the line BVH's rows and the dense list's records hold.
__device__ __forceinline__ bool cone_record(float4 q0, float4 q1, float4 q2,
                                            const Ray& r, float& tt,
                                            float& yt) {
  return cone_test(q0.x, q0.y, q0.z, q1.x, q1.y, q1.z, q2.x, q2.y, q2.z,
                   q1.w, r, tt, yt);
}

// Leaf policies.  test(): true where row `row` (leaf id * 8 + row in the
// leaf) is hit in (0, r.t) by a prim that is not excluded; cand is the
// prim's id local to its kind.  kRowVec: float4 per row.  kEncoded: the
// wide walk picks the winner by the TPU kernel's (bits(t) & ~7) | row.
// kSets*: which of u, v, slot a hit of this kind defines.  kDenseList: the
// kind has a dense small-list form (kCone: of lines).  kMinBlocks,
// kMinBlocksAny: __launch_bounds__' resident blocks per SM for the wide
// walk's closest-hit and any-hit (6 caps a thread at 80 registers, 4 at
// 128).  kNearFirst: the wide closest-hit
// walk pushes children near-first and drops entries the running t has
// passed (pop_inner_near).  kBoxAtPop: the wide closest-hit walk keeps
// the order of its node records and tests a leaf's box again when it pops
// it (pop_inner_slot, leaf_at_pop).  A leaf child's link is its code:
// leaf_of() its leaf id, rows() the rows to test, from the first;
// code_of_leaf(): the code of a leaf the deep walk reaches by its id;
// u_of(): the u of a leaf's winner from what test() gave it.

// What a policy does not set: the code is the leaf id, every row tested,
// children in index order, u as test() gives it.
struct LeafDefaults {
  static constexpr bool kNearFirst = false, kBoxAtPop = false;
  static __device__ __forceinline__ int leaf_of(int code) { return code; }
  static __device__ __forceinline__ int code_of_leaf(int lid) { return lid; }
  static __device__ __forceinline__ int rows(const Params&, int) {
    return kLeaf;
  }
  static __device__ __forceinline__ float u_of(float b_u, float) {
    return b_u;
  }
};

// The filled rows of a leaf whose records keep their count in the last
// word of a row (build_bvh pads a leaf at its end).
__device__ __forceinline__ int filled_rows(const Params& p, int lid) {
  return __float_as_int(__ldg(p.leaves + (size_t)lid * kLeaf * 3 + 2).w);
}

// (v0.xyz, prim bits | e1.xyz, - | e2.xyz, -)
struct TriangleLeaf : LeafDefaults {
  static constexpr int kRowVec = 3;
  static constexpr bool kEncoded = true;
  static constexpr bool kSetsU = true, kSetsV = true, kSetsSlot = true;
  static constexpr bool kDenseList = false, kCone = false;
  static constexpr int kMinBlocks = 6, kMinBlocksAny = 6;
  static __device__ __forceinline__ bool test(const Params& p, int row,
                                              const Ray& r, float& tt,
                                              float& b_u, float& b_v,
                                              int& cand) {
    const float4* q = p.leaves + (size_t)row * kRowVec;
    const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2);
    cand = __float_as_int(q0.w);
    return triangle_hit(q0.x, q0.y, q0.z, q1.x, q1.y, q1.z, q2.x, q2.y, q2.z,
                        r, tt, b_u, b_v) &&
           cand >= 0 && cand != r.ig1 && cand != r.ig2;
  }
};

// Shutter-open rows (v0.xyz, prim bits | e1.xyz, index of the row's
// shutter-close record in p.leaves_t1 or -1 | e2.xyz, filled rows of the
// leaf; ints as their bits), lerped at the ray's time as a*(1-w) + b*w.  A
// row that does not move (its two records bit-equal at upload) has no
// second record and is lerped with itself, which gives the bits of the two
// equal records.  Closest-hit walks nodes whose children are in reverse
// binary preorder (ops/trace_cuda.py: pack_nodes_preorder), so they pop in
// the skip-link walk's order, and tests a leaf's box again at its pop, at
// the running t, as that walk does when it reaches the leaf: every ray
// tests the leaves the skip-link walk tests, in its order, so an exact-t
// tie or a hit an ulp before its box goes where the reference sends it.
// Any-hit's flag does not depend on the order: it walks the nodes of the
// other forms, whose order measured faster.
struct MovingTriangleLeaf : LeafDefaults {
  static constexpr int kRowVec = 3;
  static constexpr bool kEncoded = false;
  static constexpr bool kSetsU = true, kSetsV = true, kSetsSlot = true;
  static constexpr bool kDenseList = false, kCone = false;
  static constexpr int kMinBlocks = 6, kMinBlocksAny = 4;
  static constexpr bool kBoxAtPop = true;
  static __device__ __forceinline__ int rows(const Params& p, int lid) {
    return filled_rows(p, lid);
  }
  static __device__ __forceinline__ bool test(const Params& p, int row,
                                              const Ray& r, float& tt,
                                              float& b_u, float& b_v,
                                              int& cand) {
    const float4* q = p.leaves + (size_t)row * kRowVec;
    const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2);
    const int moved = __float_as_int(q1.w);
    float4 s0 = q0, s1 = q1, s2 = q2;
    if (moved >= 0) {
      const float4* s = p.leaves_t1 + (size_t)moved * kRowVec;
      s0 = __ldg(s); s1 = __ldg(s + 1); s2 = __ldg(s + 2);
    }
    const float w = r.time, w0 = 1.f - r.time;
    cand = __float_as_int(q0.w);
    return triangle_hit(q0.x * w0 + s0.x * w, q0.y * w0 + s0.y * w,
                        q0.z * w0 + s0.z * w, q1.x * w0 + s1.x * w,
                        q1.y * w0 + s1.y * w, q1.z * w0 + s1.z * w,
                        q2.x * w0 + s2.x * w, q2.y * w0 + s2.y * w,
                        q2.z * w0 + s2.z * w, r, tt, b_u, b_v) &&
           cand >= 0 && cand != r.ig1 && cand != r.ig2;
  }
};

// One float4 a row, (c.xyz, radius); the prim id in p.ids, read for a row
// that is hit.  A leaf child's link is lid * 8 + filled rows - 1
// (ops/trace_cuda.py: pack_nodes with the leaves' filled counts), so a pop
// knows its rows from the entry it popped.  Closest-hit walks the preorder
// nodes and tests a leaf's box again at its pop, as MovingTriangleLeaf's
// does, and equals the skip-link walk on every ray; any-hit walks the
// nodes in index order.
struct SphereLeaf : LeafDefaults {
  static constexpr int kRowVec = 1;
  static constexpr bool kEncoded = false;
  static constexpr bool kSetsU = false, kSetsV = false, kSetsSlot = false;
  static constexpr bool kDenseList = true, kCone = false;
  static constexpr int kMinBlocks = 6, kMinBlocksAny = 6;
  static constexpr bool kBoxAtPop = true;
  static __device__ __forceinline__ int leaf_of(int code) { return code >> 3; }
  static __device__ __forceinline__ int code_of_leaf(int lid) {
    return lid * kLeaf + kLeaf - 1;
  }
  static __device__ __forceinline__ int rows(const Params&, int code) {
    return (code & (kLeaf - 1)) + 1;
  }
  static __device__ __forceinline__ bool test(const Params& p, int row,
                                              const Ray& r, float& tt,
                                              float& b_u, float& b_v,
                                              int& cand) {
    const float4 q = __ldg(p.leaves + (size_t)row * kRowVec);
    b_u = 0.f; b_v = 0.f;
    if (!sphere_hit(q.x, q.y, q.z, q.w, r, tt)) return false;
    cand = (int)__ldg(p.ids + row);
    return cand >= 0 && cand != r.ig1 && cand != r.ig2;
  }
};

// (v0.xyz, prim bits | unit axis.xyz, r0 | length, k, k*k, filled rows of
// the leaf as int bits): the prim's own terms of the cone test, computed
// once at upload (ops/trace_cuda.py: pack_line_rows); u is the axial
// fraction, divided out for the leaf's winner only.
struct ConeLeaf : LeafDefaults {
  static constexpr int kRowVec = 3;
  static constexpr bool kEncoded = false;
  static constexpr bool kSetsU = true, kSetsV = false, kSetsSlot = false;
  static constexpr bool kDenseList = true, kCone = true;
  static constexpr int kMinBlocks = 4, kMinBlocksAny = 4;
  static constexpr bool kNearFirst = true;
  static __device__ __forceinline__ int rows(const Params& p, int lid) {
    return filled_rows(p, lid);
  }
  static __device__ __forceinline__ float u_of(float yt, float length) {
    return cone_fraction(yt, length);
  }
  static __device__ __forceinline__ bool test(const Params& p, int row,
                                              const Ray& r, float& tt,
                                              float& b_u, float& b_v,
                                              int& cand) {
    const float4* q = p.leaves + (size_t)row * kRowVec;
    const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2);
    cand = __float_as_int(q0.w);
    b_v = q2.x;  // the length, for u_of
    return cone_record(q0, q1, q2, r, tt, b_u) && cand >= 0 &&
           cand != r.ig1 && cand != r.ig2;
  }
};

// A winner of a leaf or of a dense list into the ray, as global id.
template <class Leaf>
__device__ __forceinline__ void take_hit(const Params& p, Ray& r, float bt,
                                         float bu, float bv, int cand,
                                         int slot) {
  r.t = bt;
  if (Leaf::kSetsU) r.u = bu;
  if (Leaf::kSetsV) r.v = bv;
  if (Leaf::kSetsSlot) r.slot = slot;
  r.prim = cand + p.prim_offset;
}

// One leaf test: the first `rows` rows of leaf `lid`.  kEncoded: the
// winner is the minimum of (bits(t) & ~7) | row; else the smallest t, the
// first row on an exact tie.  Returns true when the ray is finished
// (any-hit found a blocker).
template <class Leaf, bool kAnyHit, bool kEncoded>
__device__ __forceinline__ bool test_leaf(const Params& p, int lid, int rows,
                                          Ray& r) {
  int best = kNoHit;
  float bt = r.t, bu = 0.f, bv = 0.f;
  int bc = -1, bk = 0;
#pragma unroll
  for (int k = 0; k < kLeaf; ++k) {
    if (k >= rows) break;
    float tt, b_u, b_v;
    int cand;
    if (Leaf::test(p, lid * kLeaf + k, r, tt, b_u, b_v, cand)) {
      if (kEncoded) {
        const int enc = (__float_as_int(tt) & ~7) | k;
        if (enc < best) {
          best = enc;
          bt = tt; bu = b_u; bv = b_v; bc = cand; bk = k;
        }
      } else if (tt < bt) {
        bt = tt; bu = b_u; bv = b_v; bc = cand; bk = k;
      }
    }
  }
  if (bc >= 0) {
    if (kAnyHit) {
      r.prim = 0;
      r.t = -1.f;
      return true;
    }
    take_hit<Leaf>(p, r, bt, Leaf::u_of(bu, bv), bv, bc, lid * kLeaf + bk);
  }
  return false;
}

// test_leaf on the rows of the leaf whose code is `code` in the wide walk.
template <class Leaf, bool kAnyHit, bool kEncoded>
__device__ __forceinline__ bool pop_leaf(const Params& p, int code, Ray& r) {
  return test_leaf<Leaf, kAnyHit, kEncoded>(p, Leaf::leaf_of(code),
                                            Leaf::rows(p, code), r);
}

// The ray dealing of a walk whose warps take rays as their lanes fall idle.
// Warp-uniform state: a warp looks at its own batch of 32 rays first; a
// persistent launch then takes the batches a global counter deals out.  A
// batch's dead rays (t_init <= 0) are written out at once and its live
// ones handed to idle lanes (ballot compaction).
struct RayDealer {
  int own;          // this warp's own batch, -1 once taken
  int dealt_from;   // the first ray the counter deals out
  bool more = true;
  unsigned pend = 0;  // the live rays of the last batch no lane has taken
  int pend_base = 0;
  float pend_t = 0.f;  // this lane's t_init in the pending batch

  __device__ RayDealer()
      : own(32 * (blockIdx.x * kWarps + (threadIdx.x >> 5))),
        dealt_from(32 * gridDim.x * kWarps) {}

  // Hands pending live rays to the warp's idle lanes (ray < 0): a lane that
  // takes one sets `ray` and calls start(ray, its t_init).  Returns the
  // lanes that walk a ray.  kPersistent: batches from p.work until none
  // are left; else the warp's own batch only.
  template <class Leaf, bool kCounters, bool kPersistent, class Start>
  __device__ __forceinline__ unsigned deal(const Params& p, int& ray,
                                           Start&& start) {
    const int lane = threadIdx.x & 31;
    const unsigned lanes_below = (1u << lane) - 1u;
    const unsigned active = __ballot_sync(kFull, ray >= 0);
    if (active == kFull || (pend == 0 && !more)) return active;
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
        if (in) pend_t = start_t(p, idx);
        const bool alive = in && pend_t > 0.f;
        if (in && !alive) {  // a dead lane does no work: t stays t_init
          Ray dead;
          dead.t = pend_t; dead.u = 0.f; dead.v = 0.f;
          dead.prim = -1; dead.slot = -1; dead.iters = 0; dead.leafs = 0;
          store_ray<Leaf, kCounters>(p, idx, dead);
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
        start(ray, t0);
      }
      // drop the `take` lowest pending rays
      pend = take == n_pend
                 ? 0u
                 : pend & ~((2u << nth_set_bit(pend, take - 1)) - 1u);
      idle = ~__ballot_sync(kFull, ray >= 0);
    }
    return __ballot_sync(kFull, ray >= 0);
  }
};

// The end of a persistent launch: the last warp out leaves the counters at
// zero for the next launch.
__device__ __forceinline__ void release_work(const Params& p) {
  if ((threadIdx.x & 31) == 0) {
    __threadfence();
    if (atomicAdd(p.work + 1, 1) == (int)gridDim.x * kWarps - 1) {
      p.work[0] = 0;
      p.work[1] = 0;
    }
  }
}

// kPersistent: warps fetch rays from p.work until none are left.
// Otherwise thread i of the grid walks ray i (the counters launches).
template <class Leaf, bool kAnyHit, bool kCounters, bool kPersistent>
__global__ void __launch_bounds__(kThreads, kAnyHit ? Leaf::kMinBlocksAny
                                                    : Leaf::kMinBlocks)
traverse_kernel(const Params p) {
  constexpr bool kNear = Leaf::kNearFirst && !kAnyHit;
  constexpr bool kBox = Leaf::kBoxAtPop && !kAnyHit;
  extern __shared__ int smem[];
  int* stack = smem + threadIdx.x;  // entry e of this thread: stack[e * kThreads]
  // kNear: each entry's distance, beside it (a second depth x kThreads)
  float* tstack = reinterpret_cast<float*>(smem) + p.depth * kThreads +
                  threadIdx.x;
  RayDealer dealer;
  int ray = -1;  // the ray this lane walks, -1: idle
  int sp = 0;
  Ray r;

  for (;;) {
    const unsigned active = dealer.deal<Leaf, kCounters, kPersistent>(
        p, ray, [&](int i, float t0) {
          load_ray(p, i, t0, r);
          stack[0] = 0;  // the root
          if (kNear) tstack[0] = 0.f;
          sp = 1;
        });
    if (active == 0) break;

    if (ray >= 0) {
      // while-while: inner nodes until a leaf is on top ...
      // (kNear: an entry farther than the running t is dropped)
      while (sp > 0) {
        const int entry = stack[(sp - 1) * kThreads];
        if (kNear && tstack[(sp - 1) * kThreads] > r.t) {
          --sp;
          continue;
        }
        if (entry < 0) break;
        --sp;
        if (kCounters) ++r.iters;
        const float4* rec = p.nodes + (size_t)entry * kNodeVec;
        if (kNear)
          pop_inner_near(rec, r, stack, tstack, sp, p.depth);
        else if (kBox)
          pop_inner_slot(rec, entry, r, stack, sp, p.depth);
        else
          pop_inner(rec, r, stack, sp, p.depth);
      }
      // ... then leaves until an inner node is on top
      while (sp > 0) {
        const int entry = stack[(sp - 1) * kThreads];
        if (kNear && tstack[(sp - 1) * kThreads] > r.t) {
          --sp;
          continue;
        }
        if (entry >= 0) break;
        --sp;
        if (kCounters) ++r.leafs;
        const int code = kBox ? leaf_at_pop(p, -entry - 1, r) : -entry - 1;
        if (kBox && code < 0) continue;
        if (pop_leaf<Leaf, kAnyHit, Leaf::kEncoded>(p, code, r)) sp = 0;
      }
      if (sp == 0) {
        store_ray<Leaf, kCounters>(p, ray, r);
        ray = -1;
      }
    }
    __syncwarp();
  }
  if (kPersistent) release_work(p);
}

// The union walk (want_counters): the TPU kernel's own walk of a 128-ray
// tile, whose pops are what it counts.  One ray a thread: a tile is walked
// by a group of kTile threads (four warps), and a block of kTilesPerBlock
// groups is one 1024-ray counter block.
constexpr int kTile = 128;
constexpr int kTilesPerBlock = 8;

// The OR (kSum false) or the sum of v over the kTile threads of a tile,
// known to all of them: each warp reduces in registers, its lane 0 writes
// the warp's word into `red` (two buffers used in turns, so that no word
// is written again before every warp has read it), and the tile's threads
// meet at a named barrier of their own (id 1 + tile; 0 is __syncthreads').
template <bool kSum>
__device__ __forceinline__ unsigned tile_reduce(unsigned v,
                                                unsigned (*red)[kTile / 32],
                                                int tile, int& phase) {
  v = kSum ? __reduce_add_sync(kFull, v) : __reduce_or_sync(kFull, v);
  unsigned* buf = red[phase];
  phase ^= 1;
  if ((threadIdx.x & 31) == 0) buf[(threadIdx.x % kTile) / 32] = v;
  asm volatile("bar.sync %0, %1;" ::"r"(1 + tile), "r"(kTile) : "memory");
  unsigned out = 0;
#pragma unroll
  for (int k = 0; k < kTile / 32; ++k) out = kSum ? out + buf[k] : out | buf[k];
  return out;
}

// A lane that does no work: a dead ray (t <= 0) or a padded lane past n,
// as the TPU kernel pads one (every input 0): its t fails every slab test
// and every row.
__device__ __forceinline__ void idle_ray(float t, Ray& r) {
  r.ox = r.oy = r.oz = r.dx = r.dy = r.dz = r.ix = r.iy = r.iz = 0.f;
  r.t = t; r.u = 0.f; r.v = 0.f; r.time = 0.f;
  r.ig1 = -1; r.ig2 = -1; r.prim = -1; r.slot = -1;
  r.iters = 0; r.leafs = 0;
}

// union_kernel: trace_pallas.py's _kernel with want_counters, static
// triangles.  A tile's group walks the union with one stack in shared
// memory, p.depth entries (the wide walk's stack_depth: an inner pop nets
// at most +7 entries for the union too).  At an inner pop every thread
// slab-tests the 8 children for its ray at the ray's running t, the tile
// ORs the hit masks, and every thread writes the same pushed entries (a
// child any lane hits, ascending child index; a leaf as -link-1), so it
// reads back only what it wrote itself, and no thread writes an entry
// before the tile's barrier, which every thread reaches after its last
// read.  At a leaf pop every lane tests all 8 rows (test_leaf, the TPU
// kernel's winner).  Any-hit stops once none of the tile's 128 lanes is
// open (prim < 0: dead and padded lanes count as open).  A tile without a
// live ray pops its root once.  The tiles' counts are summed in shared
// memory and written once a block, so they need no atomics and do not
// depend on timing.
template <bool kAnyHit>
__global__ void __launch_bounds__(kTile * kTilesPerBlock)
union_kernel(const Params p) {
  extern __shared__ int smem[];
  __shared__ unsigned red[kTilesPerBlock][2][kTile / 32];
  __shared__ int counts[kTilesPerBlock][2];
  const int tile = threadIdx.x / kTile;
  int* stack = smem + tile * p.depth;
  const int i = blockIdx.x * kTilesPerBlock * kTile + threadIdx.x;
  Ray r;
  const float t0 = i < p.n ? start_t(p, i) : 0.f;
  if (t0 > 0.f)
    load_ray(p, i, t0, r);
  else
    idle_ray(t0, r);
  int sp = 1, nopen = kTile, iters = 0, leafs = 0, phase = 0;
  stack[0] = 0;  // the root
  while (sp > 0 && (!kAnyHit || nopen > 0)) {
    const int entry = stack[--sp];
    if (entry >= 0) {
      ++iters;
      unsigned hit, leafm;
      int link[8];
      child_masks(p.nodes + (size_t)entry * kNodeVec, r, hit, leafm, link);
      hit = tile_reduce<false>(hit, red[tile], tile, phase);
      push_children<1>(hit, leafm, link, stack, sp, p.depth);
    } else {
      ++leafs;
      test_leaf<TriangleLeaf, kAnyHit, true>(p, -entry - 1, kLeaf, r);
      if (kAnyHit)
        nopen = (int)tile_reduce<true>(r.prim < 0, red[tile], tile, phase);
    }
  }
  if (i < p.n) store_ray<TriangleLeaf, false>(p, i, r);
  if (threadIdx.x % kTile == 0) {
    counts[tile][0] = iters;
    counts[tile][1] = leafs;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int it = 0, lf = 0;
#pragma unroll
    for (int k = 0; k < kTilesPerBlock; ++k) {
      it += counts[k][0];
      lf += counts[k][1];
    }
    p.iters_out[blockIdx.x] = it;
    p.leafs_out[blockIdx.x] = lf;
  }
}

// Slab test of one box (lo.xyz, hi.xyz) as the skip-link walk tests a
// node: true where the segment (0, r.t) meets it; tn is the entry distance.
__device__ __forceinline__ bool bin_box(float lx, float ly, float lz,
                                        float hx, float hy, float hz,
                                        const Ray& r, float& tn) {
  const float t0x = (lx - r.ox) * r.ix, t1x = (hx - r.ox) * r.ix;
  const float t0y = (ly - r.oy) * r.iy, t1y = (hy - r.oy) * r.iy;
  const float t0z = (lz - r.oz) * r.iz, t1z = (hz - r.oz) * r.iz;
  tn = fmaxf(fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z)),
             0.f);
  const float tf = fminf(fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                               fmaxf(t0z, t1z)), r.t);
  return tn <= tf;
}

// The deep walk's next entry from its stack of parent records: the right
// child of the top parent whose right box the running t still meets (the
// others are dropped), 0 when none is left.
__device__ __forceinline__ int deep_pop(const Params& p, const int* stack,
                                        int& sp, const Ray& r) {
  while (sp > 0) {
    --sp;
    const float4* q = p.nodes + (size_t)stack[sp * kThreads] * kBinVec;
    const float4 q1 = __ldg(q + 1), q2 = __ldg(q + 2), q3 = __ldg(q + 3);
    float tn;
    if (bin_box(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, r, tn))
      return __float_as_int(q3.y);
  }
  return 0;
}

// The deep form: a tree without a wide layout (its wdepth*7+8 exceeds the
// wide stack's limit), walked in the skip-link walk's order over records
// that hold both children of a binary node (ops/trace_cuda.py:
// pack_bin_nodes: left box, right box, left and right link, 64 B).  An
// entry is an inner node's record (> 0), a leaf child as -code - 1 (code =
// leaf id * 8 + filled rows - 1) or 0, none.  At an inner node both boxes
// are tested at the running t with independent loads; the walk goes on to
// the left child if its box is hit, pushing the node if the right box is
// hit too, else to the right child; a leaf child's rows are tested when
// the walk reaches it, with no visit of its own.  A pop tests the pushed
// node's right box again at the running t, as the skip-link walk does
// when it reaches that child, and drops it on a miss, so every ray tests
// the leaves that walk tests, in its order, at its t, and gets its bits.
// The stack (4 B a node) is in shared memory, [entry][thread], p.depth
// entries a thread (the tree's binary levels, chosen at upload); rays are
// dealt to persistent warps as in the wide walk.  Record 0 holds the
// root's box and link, tested when a ray starts.
template <class Leaf, bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kAnyHit ? Leaf::kMinBlocksAny
                                                    : Leaf::kMinBlocks)
deep_kernel(const Params p) {
  extern __shared__ int smem[];
  int* stack = smem + threadIdx.x;
  RayDealer dealer;
  int ray = -1, sp = 0, e = 0;
  Ray r;
  for (;;) {
    const unsigned active = dealer.deal<Leaf, false, true>(
        p, ray, [&](int i, float t0) {
          load_ray(p, i, t0, r);
          const float4 a = __ldg(p.nodes), b = __ldg(p.nodes + 1);
          float tn;
          e = bin_box(a.x, a.y, a.z, a.w, b.x, b.y, r, tn)
                  ? __float_as_int(b.z)
                  : 0;
          sp = 0;
        });
    if (active == 0) break;
    if (ray >= 0) {
      // inner nodes until a leaf is due ...
      while (e > 0) {
        const float4* q = p.nodes + (size_t)e * kBinVec;
        const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2),
                     q3 = __ldg(q + 3);
        float tn;
        const bool hl = bin_box(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, r, tn);
        const bool hr = bin_box(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, r, tn);
        const int left = __float_as_int(q3.x), right = __float_as_int(q3.y);
        if (hl && hr && sp < p.depth) {
          stack[sp * kThreads] = e;
          ++sp;
        }
        e = hl ? left : hr ? right : deep_pop(p, stack, sp, r);
      }
      // ... then leaves until an inner node is due
      while (e < 0) {
        const int code = -e - 1;
        if (test_leaf<Leaf, kAnyHit, false>(p, code >> 3, (code & 7) + 1, r)) {
          e = 0;
          break;
        }
        e = deep_pop(p, stack, sp, r);
      }
      if (e == 0) {
        store_ray<Leaf, false>(p, ray, r);
        ray = -1;
      }
    }
    __syncwarp();
  }
  release_work(p);
}

// The skip form: a tree too deep for the deep walk's stack (more binary
// levels than MAX_BIN_STACK; chosen at upload).  Thread i walks ray i
// through the binary nodes (min.xyz, max.x | max.yz, skip bits, first
// bits) by skip links, without a stack: the left child of an inner node is
// the next node, a miss or a leaf goes on at the node's skip link.  A
// leaf's rows start at its first slot, so the leaf id is first / 8.
template <class Leaf, bool kAnyHit>
__global__ void __launch_bounds__(kThreads) skip_kernel(const Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  Ray r;
  const float t0 = start_t(p, i);
  if (!(t0 > 0.f)) {
    r.t = t0; r.u = 0.f; r.v = 0.f; r.prim = -1; r.slot = -1;
    store_ray<Leaf, false>(p, i, r);
    return;
  }
  load_ray(p, i, t0, r);
  int node = 0;
  while (node < p.n_nodes) {
    const float4 a = __ldg(p.nodes + 2 * (size_t)node);
    const float4 b = __ldg(p.nodes + 2 * (size_t)node + 1);
    const int skip = __float_as_int(b.z), first = __float_as_int(b.w);
    float tn;
    if (bin_box(a.x, a.y, a.z, a.w, b.x, b.y, r, tn)) {
      if (first < 0) {
        ++node;
        continue;
      }
      if (pop_leaf<Leaf, kAnyHit, false>(
              p, Leaf::code_of_leaf(first / kLeaf), r))
        break;
    }
    node = skip;
  }
  store_ray<Leaf, false>(p, i, r);
}

// The dense small-list form: the block stages the list (kDenseVec floats
// a prim) in shared memory, then thread i tests ray i against every prim in
// list order.  Spheres: (c.xyz, r, c_t1.xyz, -), the centre lerped at the
// ray's time when the launch has both; lines: the line record (v0.xyz, id |
// unit axis.xyz, r0 | length, k, k*k, count) packed once at upload
// (ops/trace_cuda.py: pack_dense_lines), whose terms the cone test reads.
// The id of a prim is its index in the list.
constexpr int kDenseVec = 12;

template <class Leaf, bool kAnyHit>
__global__ void __launch_bounds__(kThreads) dense_kernel(const Params p) {
  __shared__ __align__(16) float rec[kDenseMax * kDenseVec];
  constexpr bool kCone = Leaf::kCone;
  const bool lerp = !kCone && p.d2 != nullptr && p.time != nullptr;
  for (int j = threadIdx.x; j < p.n_prims; j += kThreads) {
    float* q = rec + kDenseVec * j;
    if (kCone) {
      for (int i = 0; i < kDenseVec; ++i) q[i] = p.d0[kDenseVec * j + i];
    } else {
      q[0] = p.d0[3 * j]; q[1] = p.d0[3 * j + 1]; q[2] = p.d0[3 * j + 2];
      q[3] = p.d1[j];
      q[4] = lerp ? p.d2[3 * j] : 0.f;
      q[5] = lerp ? p.d2[3 * j + 1] : 0.f;
      q[6] = lerp ? p.d2[3 * j + 2] : 0.f;
    }
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  Ray r;
  const float t0 = start_t(p, i);
  if (!(t0 > 0.f)) {
    r.t = t0; r.u = 0.f; r.v = 0.f; r.prim = -1; r.slot = -1;
    store_ray<Leaf, false>(p, i, r);
    return;
  }
  load_ray(p, i, t0, r);
  const float w = r.time, w0 = 1.f - r.time;
  float bt = r.t, bu = 0.f;
  int bc = -1;
  for (int j = 0; j < p.n_prims; ++j) {
    const float* q = rec + kDenseVec * j;
    float tt, yt = 0.f;
    bool ok;
    if (kCone) {
      const float4* q4 = reinterpret_cast<const float4*>(q);
      ok = cone_record(q4[0], q4[1], q4[2], r, tt, yt);
    } else if (lerp) {
      ok = sphere_hit(q[0] * w0 + q[4] * w, q[1] * w0 + q[5] * w,
                      q[2] * w0 + q[6] * w, q[3], r, tt);
    } else {
      ok = sphere_hit(q[0], q[1], q[2], q[3], r, tt);
    }
    if (ok && tt < bt && j != r.ig1 && j != r.ig2) {
      bt = tt; bc = j;
      if (kCone) bu = cone_fraction(yt, q[8]);
      if (kAnyHit) break;
    }
  }
  if (bc >= 0) {
    if (kAnyHit) {
      r.prim = 0;
      r.t = -1.f;
    } else {
      take_hit<Leaf>(p, r, bt, bu, 0.f, bc, -1);
    }
  }
  store_ray<Leaf, false>(p, i, r);
}

// Launch kernel `kern` with `smem` bytes of dynamic shared memory a block.
// kPersistent: as many blocks as are resident at once; else one thread a
// ray.
template <bool kPersistent>
cudaError_t launch_walk(void (*kern)(Params), const Params& p, size_t smem,
                        cudaStream_t stream) {
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

// The wide walk of one policy.
template <class Leaf, bool kAnyHit, bool kCounters, bool kPersistent>
cudaError_t launch_wide(const Params& p, cudaStream_t stream) {
  constexpr size_t kEntry = Leaf::kNearFirst && !kAnyHit ? 8 : 4;
  return launch_walk<kPersistent>(
      traverse_kernel<Leaf, kAnyHit, kCounters, kPersistent>, p,
      (size_t)p.depth * kThreads * kEntry, stream);
}

enum Form { kWide = 0, kDeep = 1, kDense = 2, kSkip = 3, kUnion = 4 };

// The union walk: one block a 1024-ray counter block.
template <bool kAnyHit>
cudaError_t launch_union(const Params& p, cudaStream_t stream) {
  const int blocks = (p.n + kTile * kTilesPerBlock - 1) /
                     (kTile * kTilesPerBlock);
  union_kernel<kAnyHit><<<blocks, kTile * kTilesPerBlock,
                          (size_t)kTilesPerBlock * p.depth * sizeof(int),
                          stream>>>(p);
  return cudaGetLastError();
}
enum Kind { kTriangle = 0, kMoving = 1, kSphere = 2, kLine = 3 };

template <class Leaf, bool kAnyHit>
cudaError_t launch_form(const Params& p, int form, cudaStream_t stream) {
  const int blocks = (p.n + kThreads - 1) / kThreads;
  if (form == kWide) return launch_wide<Leaf, kAnyHit, false, true>(p, stream);
  if (form == kDeep)  // a node record index, 4 B
    return launch_walk<true>(deep_kernel<Leaf, kAnyHit>, p,
                             (size_t)p.depth * kThreads * 4, stream);
  if (form == kSkip) {
    skip_kernel<Leaf, kAnyHit><<<blocks, kThreads, 0, stream>>>(p);
  } else if constexpr (Leaf::kDenseList) {
    dense_kernel<Leaf, kAnyHit><<<blocks, kThreads, 0, stream>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool kAnyHit>
cudaError_t launch_kind(const Params& p, int form, int kind,
                        cudaStream_t stream) {
  switch (kind) {
    case kTriangle: return launch_form<TriangleLeaf, kAnyHit>(p, form, stream);
    case kMoving:
      return launch_form<MovingTriangleLeaf, kAnyHit>(p, form, stream);
    case kSphere: return launch_form<SphereLeaf, kAnyHit>(p, form, stream);
    case kLine: return launch_form<ConeLeaf, kAnyHit>(p, form, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launch arguments, as ops/trace_cuda.py fills them through ctypes.
struct Corona13TraceArgs {
  int form;   // 0 wide walk, 1 deep tree, 2 dense list, 3 skip links,
              // 4 union walk (triangles, want_counters)
  int kind;   // 0 triangles, 1 moving triangles, 2 spheres, 3 lines
  int any_hit;
  int carry;  // start from t_out / blocked_out and update them
  const void* nodes;      // wide: kernel nodes; deep: its records [r, 16];
                          // skip: binary nodes [n, 8]
  const void* leaves;     // the kind's leaf rows
  const void* leaves_t1;  // moving triangles: the moving rows' close records
  const void* ids;        // spheres (wide, deep): leaf slots' prim ids, int64
  int depth;              // wide, deep: stack entries a thread; union: a tile
  int n_nodes;            // skip: binary nodes
  const float* d0;        // dense: see dense_kernel
  const float* d1;
  const float* d2;
  int n_prims;
  int prim_offset;
  const float* org;
  const float* dir;
  const float* time;    // [n] or null
  const float* t_init;  // [n], or null: every ray starts at t_all
  float t_all;
  int ignore_is64;
  const void* ignore1;  // [n] int64 (ignore_is64) or int32, or null
  const void* ignore2;
  int n;
  float* t_out;  // (t, prim, u, v, slot) together or all null
  long long* prim_out;
  float* u_out;
  float* v_out;
  long long* slot_out;
  unsigned char* blocked_out;  // [n] bytes or null
  int* iters_out;  // both non-null: per-ray pops (wide triangles or lines,
  int* leafs_out;  // thread i walks ray i), or the union walk's per block
  int* work;       // wide (not counters), deep: two int32 zeros, left zero
  void* stream;
};

// Plain C entry point, loaded with ctypes; returns the launch's
// cudaError_t (0: launched).
extern "C" int corona13_trace(const Corona13TraceArgs* a) {
  Params p;
  p.nodes = (const float4*)a->nodes;
  p.leaves = (const float4*)a->leaves;
  p.leaves_t1 = (const float4*)a->leaves_t1;
  p.ids = (const long long*)a->ids;
  p.org = a->org;
  p.dir = a->dir;
  p.time = a->time;
  p.t_init = a->t_init;
  p.t_all = a->t_all;
  p.ignore1 = a->ignore1;
  p.ignore2 = a->ignore2;
  p.ignore_is64 = a->ignore_is64;
  p.n = a->n;
  p.depth = a->depth;
  p.n_nodes = a->n_nodes;
  p.prim_offset = a->prim_offset;
  p.carry = a->carry;
  p.d0 = a->d0; p.d1 = a->d1; p.d2 = a->d2;
  p.n_prims = a->n_prims;
  p.t_out = a->t_out;
  p.prim_out = a->prim_out;
  p.u_out = a->u_out;
  p.v_out = a->v_out;
  p.slot_out = a->slot_out;
  p.blocked_out = a->blocked_out;
  p.iters_out = a->iters_out;
  p.leafs_out = a->leafs_out;
  p.work = a->work;
  const int n = a->n, form = a->form, kind = a->kind;
  if (n <= 0 || (n >> 30) != 0) return (int)cudaErrorInvalidValue;
  if ((form == kWide || form == kDeep || form == kUnion) &&
      (a->depth < 1 || a->nodes == nullptr))
    return (int)cudaErrorInvalidValue;
  if (form == kSkip && (a->n_nodes < 1 || a->nodes == nullptr))
    return (int)cudaErrorInvalidValue;
  if (form < kWide || form > kUnion) return (int)cudaErrorInvalidValue;
  if (form == kDense && (a->n_prims < 1 || a->n_prims > kDenseMax ||
                         a->d0 == nullptr ||
                         (kind == kSphere && a->d1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (form != kDense && a->leaves == nullptr)
    return (int)cudaErrorInvalidValue;
  if (kind == kMoving && (a->leaves_t1 == nullptr || a->time == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kind == kSphere && form != kDense && a->ids == nullptr)
    return (int)cudaErrorInvalidValue;
  if (a->carry && a->t_out == nullptr && a->blocked_out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)a->stream;
  if (form == kUnion) {
    if (kind != kTriangle || a->iters_out == nullptr ||
        a->leafs_out == nullptr || a->t_out == nullptr || a->carry)
      return (int)cudaErrorInvalidValue;
    return (int)(a->any_hit ? launch_union<true>(p, s)
                            : launch_union<false>(p, s));
  }
  if (a->iters_out != nullptr) {
    if (a->leafs_out == nullptr || form != kWide ||
        (kind != kTriangle && kind != kLine) || a->carry)
      return (int)cudaErrorInvalidValue;
    if (kind == kLine)
      return (int)(a->any_hit
                       ? launch_wide<ConeLeaf, true, true, false>(p, s)
                       : launch_wide<ConeLeaf, false, true, false>(p, s));
    return (int)(a->any_hit
                     ? launch_wide<TriangleLeaf, true, true, false>(p, s)
                     : launch_wide<TriangleLeaf, false, true, false>(p, s));
  }
  if ((form == kWide || form == kDeep) && a->work == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)(a->any_hit ? launch_kind<true>(p, form, kind, s)
                          : launch_kind<false>(p, form, kind, s));
}
