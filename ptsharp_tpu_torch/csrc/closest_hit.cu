// Closest-hit by the ordered walk, one ray a lane, in persistent warps that
// refill their idle lanes: over the fat BVH table (pt_closest_hit) or over
// the split tables rows + leaf (pt_closest_hit_split).
//
// Replaces two TPU kernels of ptsharp_tpu/pallas/ordered_kernel.py:
// pallas_traverse_ordered8_fat (body _kernel8_ord_fat), the closest-hit of
// every flat mesh scene, over the fat table; and pallas_traverse_ordered8
// (body _kernel8_ord), the same walk over `rows` + `leaf` held in VMEM, node
// j at rows[j] and a leaf node's triangles at leaf[first / leaf_size]. The
// TPU kernels walk a packet of 8x128 rays, each group of 128 with one
// consensus cursor and stack, and DMA one row (pair) per group step;
// `pipelined`, `mt_gate`, `defer_leaf` and `desc_gate` only schedule that
// DMA and that work and change no result, so they have no counterpart here.
// Their `order_mode` decides which of two triangles at an exact tie in t a
// lane keeps, since the first one found wins. The group's consensus order
// decides it there, which no per-ray order follows at every tie; of the two
// per-ray orders, "near" (the nearest hit child next, the others pushed in
// static reverse order), the order the JAX package asks for, keeps the JAX
// kernel's triangle on more tie lanes than "full" (far to near;
// tests/test_torch_ordered.py). The fat walk pushes "near"; the split walk
// takes either order (ptk::Push). pallas_traverse_ordered8's
// `return_iters` is the packet's loop count broadcast over the tile; here
// it is each ray's own number of steps, written to an int32 (R,) buffer
// when one is given.
//
// What bounds it on an H100: each step is a dependent load (the next node
// is known only after the current row's tests), so a ray's walk is a chain
// of memory latencies, and rays of one warp end after very different
// numbers of steps (lane use 0.21 on bounce rays in one-ray-a-thread
// warps). The design (bvh_common.cuh, the persistent ordered walk):
//   - a persistent grid of as many 128-thread blocks as are resident; each
//     warp takes rays in input order from one counter and refills its idle
//     lanes when fewer than 24 are live, so Morton-ordered camera rays
//     still arrive together and a finished lane does not idle;
//   - stack entries carry the entry distance of their box: a pop drops a
//     node that the ray no longer enters before the best t without reading
//     its row, and no visited node tests its own box again;
//   - float4 loads of what a step uses: the meta fields, the K child boxes
//     and indices (16 loads at K=8), at a leaf its `count` triangles (both
//     tables start on 16-byte boundaries; the wrappers check it).
// The two table forms hold the same rows, so the split walk in the "near"
// order takes the fat walk's steps and gets its results on every lane; it
// only looks its leaf block up in a second table (an integer divide). The
// stack (kStackCap entries of node and distance) lives in local memory;
// shared memory for its first 16 entries measured slower. The plain
// versions are kernels/traverse.py closest_hit_plain and
// closest_hit_split_plain, which take the same steps in the same order, so
// the kernels agree with them in t, slot, u and v on every lane.

#include <type_traits>

#include "bvh_common.cuh"

namespace {

template <int K, ptk::Push P, class Table>
__global__ void __launch_bounds__(ptk::kWalkThreads)
closest_hit_kernel(Table tab, const float* __restrict__ org,
                   const float* __restrict__ dir,
                   const float* __restrict__ t_max, int n, int base, int end,
                   float* __restrict__ t_out, int* __restrict__ slot_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   int* __restrict__ iters_out, int* __restrict__ next_ray,
                   unsigned long long* __restrict__ counts) {
  ptk::Ray r;
  ptk::Best b;
  ptk::EntryStack<true> st;
  ptk::persistent_walk(
      n, end, end - base + 2, next_ray, counts,
      [&](int i) {
        r = ptk::load_ray(org, dir, i);
        b = ptk::Best{t_max[i], -1, 0.0f, 0.0f};
        st.sp = 0;
        return ptk::walk_start(tab, r, b.t, base, end);
      },
      [&](int cur) {
        return ptk::walk_step<K, P>(
            tab, cur, r, b.t, st, end,
            [&](int slot, float tt, float uu, float vv) {
              if (tt < b.t) b = ptk::Best{tt, slot, uu, vv};
              return false;  // the first slot wins ties
            });
      },
      [&](int i, int steps) {
        t_out[i] = b.slot >= 0 ? b.t : ptk::kInf;
        slot_out[i] = b.slot;
        u_out[i] = b.u;
        v_out[i] = b.v;
        // only the split walk writes each ray's steps: with the store
        // #1 at K=4 took 79 registers, not its 85 (PERF.md section 6)
        if constexpr (std::is_same<Table, ptk::SplitTable>::value) {
          if (iters_out != nullptr) iters_out[i] = steps;
        }
      });
}

template <int K, ptk::Push P, class Table>
int launch(const Table& tab, const float* org, const float* dir,
           const float* t_max, int n, int base, int end, float* t_out,
           int* slot_out, float* u_out, float* v_out, int* iters_out,
           int* next_ray, unsigned long long* counts, void* stream) {
  static const int resident =
      ptk::resident_blocks(closest_hit_kernel<K, P, Table>);
  closest_hit_kernel<K, P, Table>
      <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          tab, org, dir, t_max, n, base, end, t_out, slot_out, u_out, v_out,
          iters_out, next_ray, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// next_ray: two ints, 0 and 0: the counter from which the warps take
// rays and the warps finished, both 0 again when the kernel ends; counts: null, or
// two unsigned 64-bit ints to which the kernel adds [steps, lane slots].
extern "C" int pt_closest_hit(const float* fat, const float* org,
                              const float* dir, const float* t_max, int n,
                              int base, int end, int k, float* t_out,
                              int* slot_out, float* u_out, float* v_out,
                              int* next_ray, unsigned long long* counts,
                              void* stream) {
  using ptk::Push;
  const ptk::FatTable tab{fat};
  switch (k) {
    case 4:
      return launch<4, Push::kNear>(tab, org, dir, t_max, n, base, end,
                                    t_out, slot_out, u_out, v_out, nullptr,
                                    next_ray, counts, stream);
    case 8:
      return launch<8, Push::kNear>(tab, org, dir, t_max, n, base, end,
                                    t_out, slot_out, u_out, v_out, nullptr,
                                    next_ray, counts, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The split tables (node j at rows[j], its leaf block at leaf[first /
// leaf_size]); near != 0 selects order_mode "near"; iters_out: null, or
// an int (R,) buffer for each ray's step count; next_ray and counts as in
// pt_closest_hit.
extern "C" int pt_closest_hit_split(const float* rows, const float* leaf,
                                    const float* org, const float* dir,
                                    const float* t_max, int n, int base,
                                    int end, int leaf_size, int k, int near,
                                    float* t_out, int* slot_out, float* u_out,
                                    float* v_out, int* iters_out,
                                    int* next_ray,
                                    unsigned long long* counts,
                                    void* stream) {
  using ptk::Push;
  const ptk::SplitTable tab{rows, leaf, leaf_size};
  if (k == 4 && !near) {
    return launch<4, Push::kFull>(tab, org, dir, t_max, n, base, end, t_out,
                                  slot_out, u_out, v_out, iters_out, next_ray,
                                  counts, stream);
  } else if (k == 4) {
    return launch<4, Push::kNear>(tab, org, dir, t_max, n, base, end, t_out,
                                  slot_out, u_out, v_out, iters_out, next_ray,
                                  counts, stream);
  } else if (k == 8 && !near) {
    return launch<8, Push::kFull>(tab, org, dir, t_max, n, base, end, t_out,
                                  slot_out, u_out, v_out, iters_out, next_ray,
                                  counts, stream);
  } else if (k == 8) {
    return launch<8, Push::kNear>(tab, org, dir, t_max, n, base, end, t_out,
                                  slot_out, u_out, v_out, iters_out, next_ray,
                                  counts, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
