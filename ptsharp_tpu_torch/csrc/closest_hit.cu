// Closest-hit over the fat BVH table: the ordered walk, one ray a lane, in
// persistent warps that refill their idle lanes.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/ordered_kernel.py
// pallas_traverse_ordered8_fat (body _kernel8_ord_fat), the closest-hit of
// every flat mesh scene. The TPU kernel walks a packet of 8x128 rays, each
// group of 128 with one consensus cursor and stack, and DMAs one fat row
// pair per group step; `pipelined`, `mt_gate` and `desc_gate` only
// schedule that DMA and that work and change no result, so they have no
// counterpart here. Its `order_mode` decides which of two triangles at an
// exact tie in t a lane keeps, since the first one found wins. The group's
// consensus order decides it there, which no per-ray order follows at
// every tie; of the two per-ray orders, "near" (the nearest hit child
// next, the others pushed in static reverse order), the order the JAX
// package asks for, keeps the JAX kernel's triangle on more tie lanes
// than "full" (tests/test_torch_ordered.py). This walk pushes "near".
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
//     and indices (16 loads at K=8), at a leaf its `count` triangles.
// The stack (kStackCap entries of node and distance) lives in local
// memory; shared memory for its first 16 entries measured slower. The
// plain version is kernels/traverse.py closest_hit_plain, which takes the
// same steps in the same order, so the two agree in t, slot, u and v on
// every lane.

#include "bvh_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(ptk::kWalkThreads)
closest_hit_kernel(const float* __restrict__ fat,
                   const float* __restrict__ org,
                   const float* __restrict__ dir,
                   const float* __restrict__ t_max, int n, int base, int end,
                   float* __restrict__ t_out, int* __restrict__ slot_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   int* __restrict__ next_ray,
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
        return ptk::fat_start(fat, r, b.t, base, end);
      },
      [&](int cur) {
        return ptk::fat_step<K, ptk::Push::kNear>(
            fat, cur, r, b.t, st, end,
            [&](int slot, float tt, float uu, float vv) {
              if (tt < b.t) b = ptk::Best{tt, slot, uu, vv};
              return false;  // the first slot wins ties
            });
      },
      [&](int i) {
        t_out[i] = b.slot >= 0 ? b.t : ptk::kInf;
        slot_out[i] = b.slot;
        u_out[i] = b.u;
        v_out[i] = b.v;
      });
}

template <int K>
int launch(const float* fat, const float* org, const float* dir,
           const float* t_max, int n, int base, int end, float* t_out,
           int* slot_out, float* u_out, float* v_out, int* next_ray,
           unsigned long long* counts, cudaStream_t s) {
  static const int resident = ptk::resident_blocks(closest_hit_kernel<K>);
  closest_hit_kernel<K>
      <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, 0, s>>>(
          fat, org, dir, t_max, n, base, end, t_out, slot_out, u_out, v_out,
          next_ray, counts);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      return launch<4>(fat, org, dir, t_max, n, base, end, t_out, slot_out,
                       u_out, v_out, next_ray, counts, s);
    case 8:
      return launch<8>(fat, org, dir, t_max, n, base, end, t_out, slot_out,
                       u_out, v_out, next_ray, counts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
