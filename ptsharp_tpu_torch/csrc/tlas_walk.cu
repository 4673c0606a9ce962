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
// loads a ray, and rays of one warp that end after very different numbers
// of steps; here also the instance entries, which re-enter BLAS trees of
// very different depths. The design is the persistent walk of
// bvh_common.cuh (persistent_walk: refill idle lanes below kRefillBelow
// live) with the walk state a lane in registers: cursor, return slot,
// instance and its range end, the world ray and the ray in the current
// space, and the best hit. A simple kernel: every field is a scalar load
// through the read-only path, the row's meta fields first and the child
// fields only at an internal node the ray enters, K a run-time value. The
// plain versions (kernels/traverse.py closest_hit_tlas_plain,
// any_hit_tlas_plain) take the same steps in the same order with the same
// arithmetic (-fmad=false), so the kernel equals them on every lane.

#include <climits>

#include "bvh_common.cuh"

namespace {

// the cursor of a ray whose walk is over
constexpr int kDone = INT_MAX;

template <bool kAny, bool kWide>
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
  ptk::Ray world, local;
  float bt = 0.0f, bu = 0.0f, bv = 0.0f;
  int bk = ptk::kNone, bi = -1, binst = -1;
  int ret = tlas_end, inst = -1, bend = 0;
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
        world = ptk::load_ray(org, dir, i);
        local = world;
        return root;
      },
      [&](int cur) {
        const float* node =
            sc.rows + static_cast<size_t>(cur) * sc.node_stride;
        float box[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) box[i] = __ldg(node + i);
        const int first = __float_as_int(__ldg(node + 6));
        const int meta = __float_as_int(__ldg(node + 7));
        const int skip = __float_as_int(__ldg(node + 8));
        const int kind = (meta >> 8) & 0xF;
        float tmin, tmax;
        ptk::slab(box, local, tmin, tmax);
        int nxt = skip;
        bool stop = false;
        if (ptk::box_hit(tmin, tmax, bt)) {
          if (kind == ptk::kTriangle) {
            const float* leaf =
                sc.leaves + static_cast<size_t>(first / sc.leaf_size) *
                                sc.leaf_stride;
            ptk::leaf_slots<false>(
                leaf, meta & 0xFF, local,
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
            const float t = ptk::analytic_t(sc, kind, first, local);
            if (t < bt) {
              stop = kAny;
              if (!kAny) {
                bt = t;
                bk = kind;
                bi = first;
                binst = -1;
              }
            }
          } else if (kind == ptk::kNone) {
            if (kWide) {
              int target = -1;
              for (int c = 0; c < sc.k; ++c) {
                const float* cb = node + 9 + 6 * c;
                float b6[6];
#pragma unroll
                for (int i = 0; i < 6; ++i) b6[i] = __ldg(cb + i);
                const int ci = __float_as_int(__ldg(node + 9 + 6 * sc.k + c));
                float ctmin, ctmax;
                ptk::slab(b6, local, ctmin, ctmax);
                if (ptk::box_hit(ctmin, ctmax, bt) && ci > 0 &&
                    (target < 0 || ci < target)) {
                  target = ci;
                }
              }
              if (target >= 0) nxt = target;
            } else {
              nxt = cur + 1;
            }
          } else if (kind == ptk::kInstance && sc.n_inst > 0) {
            const int ii =
                first < 0 ? 0 : (first >= sc.n_inst ? sc.n_inst - 1 : first);
            nxt = __ldg(sc.inst_range + 2 * ii);
            bend = __ldg(sc.inst_range + 2 * ii + 1);
            ret = skip;
            inst = ii;
            local = ptk::affine_ray(sc.inst_inv + 12 * ii, world);
          }
        }
        if (inst >= 0 && nxt >= bend) {  // the BLAS is done: back to the TLAS
          nxt = ret;
          inst = -1;
          local = world;
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

template <bool kAny, bool kWide>
int launch(const ptk::TlasScene& sc, const float* org, const float* dir,
           const float* t_in, int n, int root, int tlas_end, int max_iters,
           float* t_out, int* kind_out, int* idx_out, int* inst_out,
           float* u_out, float* v_out, bool* occ_out, int* next_ray,
           unsigned long long* counts, cudaStream_t s) {
  static const int resident =
      ptk::resident_blocks(tlas_walk_kernel<kAny, kWide>);
  tlas_walk_kernel<kAny, kWide>
      <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, 0, s>>>(
          sc, org, dir, t_in, n, root, tlas_end, max_iters, t_out, kind_out,
          idx_out, inst_out, u_out, v_out, occ_out, next_ray, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scene: the tables (kernels/traverse.py fills it), copied into the
// kernel's parameters at launch; [root, tlas_end) the TLAS head; next_ray
// and counts as in pt_closest_hit. Each ray takes at most max_iters steps.
extern "C" int pt_closest_hit_tlas(const ptk::TlasScene* scene,
                                   const float* org, const float* dir,
                                   const float* t_max, int n, int root,
                                   int tlas_end, int max_iters, float* t_out,
                                   int* kind_out, int* idx_out, int* inst_out,
                                   float* u_out, float* v_out, int* next_ray,
                                   unsigned long long* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return scene->k > 0
             ? launch<false, true>(*scene, org, dir, t_max, n, root, tlas_end,
                                   max_iters, t_out, kind_out, idx_out,
                                   inst_out, u_out, v_out, nullptr, next_ray,
                                   counts, s)
             : launch<false, false>(*scene, org, dir, t_max, n, root,
                                    tlas_end, max_iters, t_out, kind_out,
                                    idx_out, inst_out, u_out, v_out, nullptr,
                                    next_ray, counts, s);
}

// as pt_closest_hit_tlas, with t_cut for t_max and one bool a ray
extern "C" int pt_any_hit_tlas(const ptk::TlasScene* scene, const float* org,
                               const float* dir, const float* t_cut, int n,
                               int root, int tlas_end, int max_iters,
                               bool* occ_out, int* next_ray,
                               unsigned long long* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return scene->k > 0
             ? launch<true, true>(*scene, org, dir, t_cut, n, root, tlas_end,
                                  max_iters, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, nullptr, occ_out,
                                  next_ray, counts, s)
             : launch<true, false>(*scene, org, dir, t_cut, n, root, tlas_end,
                                   max_iters, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, occ_out,
                                   next_ray, counts, s);
}
