// Closest-hit (pt_closest_hit_tlas) and any-hit (pt_any_hit_tlas) over the
// whole scene by one walk of its TLAS, one ray a lane in persistent warps
// that refill their idle lanes.
//
// Replaces no TPU kernel: it is the counterpart of the JAX package's XLA
// walk ptsharp_tpu/intersect.py traverse_scene (a while_loop with one
// cursor per ray), as the K-wide walks over w_rows (4w, 7w) are the
// counterparts of traverse_wide. Eager PyTorch would launch 30-60 kernels a
// loop turn for hundreds of turns a query; this is one launch a query.
//
// The node rows are the XLA walks' (bvh_common.cuh RowTable layout):
// the TLAS head [0, tlas_end) over every object of the scene, typed
// singleton leaves (sphere, cube, cylinder, mesh instance) in world space,
// then each mesh's BLAS in object space, binary u_rows (k = 0: a hit
// internal node goes to the next row) or K-wide w_rows (a hit internal
// node goes to its hit child of smallest preorder index, wide_child_step
// in ptsharp_tpu/accel/traverse.py:272-306). Per step, as traverse_scene:
//   - test the node's own box against the best t (tmax >= max(tmin, 0) and
//     tmin < best t), in the ray's current space;
//   - a triangle leaf: Moller-Trumbore over its `count` triangles in slot
//     order, strict t < best t (leaf_intersect, accel/traverse.py:164);
//   - an analytic leaf: its sphere, cube or cylinder test in the
//     primitive's object space where its type is transformed
//     (_sphere_t1, _cube_t1, _cyl_t1, ptsharp_tpu/intersect.py:58-133);
//   - an instance leaf: the ray goes into the instance's object space by
//     its world->object affine, its direction unnormalised so that t stays
//     the world ray's, and the cursor jumps to the instance's BLAS range
//     with a one-deep return slot (the leaf's skip link); when the cursor
//     reaches the range's end the ray pops back to world space and the
//     return slot;
//   - otherwise, and where no child is hit, the skip link.
// A ray ends when it is back in the TLAS at or past tlas_end, or after
// max_iters (65,536) steps, as the JAX loop caps it. Closest-hit writes
// t (INF where the kind is none), kind, index (the scene slot of a
// triangle, the primitive's index of an analytic hit), inst (the instance
// of a triangle, else -1), u and v (of the last triangle kept: an analytic
// hit leaves them as they were, as traverse_scene does). Any-hit walks
// with best t fixed at t_cut and ends a lane on its first accepted hit
// (True); a lane whose t_cut is not positive writes False without reading
// the table. That is the boolean traverse_scene(..., t_cut).kind !=
// PT_NONE (ptsharp_tpu/intersect.py:624-626): until its first accepted hit
// the bounded closest-hit walks with best t = t_cut too.
//
// What bounds it on an H100: as the other walks, a chain of dependent row
// loads a ray (the next row is known only after the box and child tests),
// and rays of one warp that end after very different numbers of steps;
// here also the instance entries, which re-enter BLAS trees of very
// different depths, and the analytic tests and the instance entry beside
// the triangle tests in one step, whose union a diverged warp runs and
// whose live values set the registers a lane holds. With a TLAS and its
// BLAS small enough for L1 and L2 (toybrick: 118 node rows, 48 leaf
// blocks), registers, through the resident warps, set the time more than
// the width of the loads (PERF.md section 6: the first design's scalar
// loads and this one's float4 loads take the same time at the same
// registers; four triangles of float4 leaf loads in registers at once
// took 21 more registers and 0-20% more time). The design (bvh_common.cuh
// tlas_step and leaf_each, in persistent_walk's persistent warps, which
// refill their idle lanes below kRefillBelow live):
//   - K at compile time: instances for K = 4 and 8 over w_rows, K = 0 over
//     binary u_rows, and one that reads K from the table (any other K the
//     scene build takes, or tables off the boundaries below), so the child
//     loop is unrolled and the child boxes stay in registers;
//   - the node row in wide loads: fields [0, 12) (own box, first slot,
//     count with the kind bits, skip link) as three float4 loads, the
//     child quads only at an internal node the ray enters (PreorderRow);
//     binary rows as five float2 loads;
//   - a leaf's `count` triangles one at a time, each from the three float4
//     loads that cover its nine floats where leaf_rows is a 16-byte stride
//     from a 16-byte aligned base (leaf 4, 8, ...), else nine scalar loads
//     (leaf 6): twelve floats live, not four triangles' 36;
//   - an instance entry's world->object affine as three float4 loads and
//     its BLAS range as one int2; a transformed primitive's affine alike;
//   - one ray in registers: the ray in the current space with its safe
//     inverse, and the ray's index; leaving a BLAS re-reads the world ray
//     from org and dir (an L2 hit), which gives the bits a kept copy would
//     (ptxas: 7-10 registers fewer than keeping both rays, no spills).
// ptxas (nvcc 12.8, sm_90a): closest-hit 64 registers at K=4, 92 at K=8,
// 59 binary, 63 at run-time K; any-hit 56, 86, 56, 56; no stack frame,
// no spills (the first design: 68 closest, 60-63 any). The wrapper
// (kernels/traverse.py tlas_instance) picks the instance from the
// tables' K, strides and base alignment. The plain versions
// (kernels/traverse.py closest_hit_tlas_plain, any_hit_tlas_plain) take
// the same steps in the same order with the same arithmetic (-fmad=false),
// so every instance equals them on every lane, step counts included.

#include <climits>

#include "bvh_common.cuh"

namespace {

// the cursor of a ray whose walk is over
constexpr int kDone = INT_MAX;

template <bool kAny, int K, bool kVecLeaf>
__global__ void __launch_bounds__(ptk::kWalkThreads,
                                  ptk::kPreorderMinBlocks)
tlas_walk_kernel(ptk::TlasScene sc, const float* __restrict__ org,
                 const float* __restrict__ dir, const float* __restrict__ t_in,
                 int n, int root, int tlas_end, int max_iters,
                 float* __restrict__ t_out, int* __restrict__ kind_out,
                 int* __restrict__ idx_out, int* __restrict__ inst_out,
                 float* __restrict__ u_out, float* __restrict__ v_out,
                 bool* __restrict__ occ_out, int* __restrict__ next_ray,
                 unsigned long long* __restrict__ counts) {
  const ptk::RowTable tab{sc.rows, sc.leaves, sc.node_stride, sc.leaf_stride,
                          sc.leaf_size};
  ptk::Ray r;  // the ray in the current space
  float bt = 0.0f, bu = 0.0f, bv = 0.0f;
  int bk = ptk::kNone, bi = -1, binst = -1;
  int ray = 0, ret = tlas_end, inst = -1, bend = 0;
  bool occ = false;
  ptk::persistent_walk(
      n, kDone, max_iters, next_ray, counts,
      [&](int i) {
        bt = t_in[i];
        bk = ptk::kNone;
        bi = binst = -1;
        bu = bv = 0.0f;
        ret = tlas_end;
        inst = -1;
        bend = 0;
        occ = false;
        if (kAny && !(bt > 0.0f)) return kDone;
        ray = i;
        r = ptk::load_ray(org, dir, i);
        return root;
      },
      [&](int cur) {
        bool stop = false;
        int nxt = ptk::tlas_step<K>(
            tab, sc.k, cur, r, bt, [&](int kind, int first, int cnt,
                                       int skip) {
              if (kind == ptk::kTriangle) {
                ptk::leaf_each<kVecLeaf>(
                    tab.leaf(nullptr, first), cnt, r,
                    [&](int l, float tt, float uu, float vv) {
                      if (!(tt < bt)) return false;
                      if (kAny) {
                        stop = true;
                        return true;
                      }
                      bt = tt;
                      bk = ptk::kTriangle;
                      bi = first + l;
                      binst = inst;
                      bu = uu;
                      bv = vv;
                      return false;
                    });
              } else if (kind == ptk::kSphere || kind == ptk::kCube ||
                         kind == ptk::kCylinder) {
                const float t = ptk::analytic_t(sc, kind, first, r);
                if (t < bt) {
                  stop = kAny;
                  if (!kAny) {
                    bt = t;
                    bk = kind;
                    bi = first;
                    binst = -1;
                  }
                }
              } else if (kind == ptk::kInstance && sc.n_inst > 0) {
                // the ray is in world space here: instances lie in the TLAS
                const int ii = first < 0 ? 0
                               : (first >= sc.n_inst ? sc.n_inst - 1 : first);
                const int2 range =
                    __ldg(reinterpret_cast<const int2*>(sc.inst_range) + ii);
                bend = range.y;
                ret = skip;
                inst = ii;
                r = ptk::affine_ray(sc.inst_inv + 12 * ii, r);
                return range.x;
              }
              return skip;
            });
        if (inst >= 0 && nxt >= bend) {  // the BLAS is done: back to the TLAS
          nxt = ret;
          inst = -1;
          r = ptk::load_ray(org, dir, ray);  // the world ray, as it began
        }
        if (stop) {
          occ = true;
          return kDone;
        }
        return inst < 0 && nxt >= tlas_end ? kDone : nxt;
      },
      [&](int i, int) {
        if (kAny) {
          occ_out[i] = occ;
        } else {
          t_out[i] = bk == ptk::kNone ? ptk::kInf : bt;
          kind_out[i] = bk;
          idx_out[i] = bi;
          inst_out[i] = binst;
          u_out[i] = bu;
          v_out[i] = bv;
        }
      });
}

// a launch's inputs and outputs (an output a kernel does not write is null)
struct Launch {
  ptk::TlasScene sc;
  const float* org;
  const float* dir;
  const float* t_in;
  int n, root, tlas_end, max_iters;
  float* t;
  int* kind;
  int* idx;
  int* inst;
  float* u;
  float* v;
  bool* occ;
  int* next_ray;
  unsigned long long* counts;
  cudaStream_t stream;
};

template <bool kAny, int K, bool kVecLeaf>
int launch(const Launch& a) {
  static const int resident =
      ptk::resident_blocks(tlas_walk_kernel<kAny, K, kVecLeaf>);
  tlas_walk_kernel<kAny, K, kVecLeaf>
      <<<ptk::persistent_blocks(a.n, resident), ptk::kWalkThreads, 0,
         a.stream>>>(a.sc, a.org, a.dir, a.t_in, a.n, a.root, a.tlas_end,
                     a.max_iters, a.t, a.kind, a.idx, a.inst, a.u, a.v,
                     a.occ, a.next_ray, a.counts);
  return static_cast<int>(cudaGetLastError());
}

// the instance for K (4, 8, 0 or ptk::kRunTimeK) and the leaf loads
// (vec_leaf 1: float4; the run-time-K instance reads leaves with scalar
// loads only), else cudaErrorInvalidValue
template <bool kAny>
int launch_instance(int k, int vec_leaf, const Launch& a) {
  switch (k) {
    case 4:
      return vec_leaf ? launch<kAny, 4, true>(a) : launch<kAny, 4, false>(a);
    case 8:
      return vec_leaf ? launch<kAny, 8, true>(a) : launch<kAny, 8, false>(a);
    case 0:
      return vec_leaf ? launch<kAny, 0, true>(a) : launch<kAny, 0, false>(a);
    case ptk::kRunTimeK:
      if (!vec_leaf) return launch<kAny, ptk::kRunTimeK, false>(a);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// scene: the tables (kernels/traverse.py fills it), copied into the
// kernel's parameters at launch; k_inst the instance's K (4, 8: w_rows
// from a 16-byte aligned base, float4 loads; 0: u_rows from an 8-byte
// aligned base, float2 loads; -1: K = scene->k, scalar loads), vec_leaf 1
// where leaf_rows is a 16-byte stride from a 16-byte aligned base (not
// with k_inst -1); the affine tables start on 16-byte boundaries and
// inst_range on an 8-byte one (the wrapper checks all of it); [root,
// tlas_end) the TLAS head; next_ray and counts as in pt_closest_hit. Each
// ray takes at most max_iters steps.
extern "C" int pt_closest_hit_tlas(const ptk::TlasScene* scene, int k_inst,
                                   int vec_leaf, const float* org,
                                   const float* dir, const float* t_max, int n,
                                   int root, int tlas_end, int max_iters,
                                   float* t_out, int* kind_out, int* idx_out,
                                   int* inst_out, float* u_out, float* v_out,
                                   int* next_ray, unsigned long long* counts,
                                   void* stream) {
  const Launch a{*scene,   org,     dir,      t_max,    n,
                 root,     tlas_end, max_iters, t_out,  kind_out,
                 idx_out,  inst_out, u_out,    v_out,   nullptr,
                 next_ray, counts,   static_cast<cudaStream_t>(stream)};
  return launch_instance<false>(k_inst, vec_leaf, a);
}

// as pt_closest_hit_tlas, with t_cut for t_max and one bool a ray
extern "C" int pt_any_hit_tlas(const ptk::TlasScene* scene, int k_inst,
                               int vec_leaf, const float* org,
                               const float* dir, const float* t_cut, int n,
                               int root, int tlas_end, int max_iters,
                               bool* occ_out, int* next_ray,
                               unsigned long long* counts, void* stream) {
  const Launch a{*scene,  org,      dir,     t_cut,   n,
                 root,    tlas_end, max_iters, nullptr, nullptr,
                 nullptr, nullptr,  nullptr, nullptr, occ_out,
                 next_ray, counts,  static_cast<cudaStream_t>(stream)};
  return launch_instance<true>(k_inst, vec_leaf, a);
}
