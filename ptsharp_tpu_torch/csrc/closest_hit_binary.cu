// Closest-hit by the binary skip-link walk over the binary node rows
// u_rows (N, 10) and the leaf blocks leaf_rows (NL, leaf_size * 9), no
// stack, one ray a lane in persistent warps that refill their idle lanes.
//
// Replaces ptsharp_tpu/pallas/traverse_kernel.py pallas_traverse (body
// _kernel), the fused form of traverse_packed (accel/traverse.py). The TPU
// kernel walks a tile of 1,024 rays with ONE shared cursor held in VMEM:
// it descends to j + 1 when any lane hits node j's box, and each lane's own
// box test gates its MT. Node boxes nest and the best t only shrinks, so a
// lane that misses a box misses every box below it: each lane accepts the
// triangles its own walk accepts, in the same order, and gets this per-ray
// walk's result. The tile is a TPU schedule; this kernel walks each ray on
// its own. The TPU wrapper's fits_vmem guard (VMEM budget for both tables)
// has no counterpart: the tables stay in device memory and L2.
//
// What bounds it on an H100: each step is a dependent load of a 40-byte
// node row (the next address is known only after the box test), and a
// binary tree has about twice the levels of a K=4 one, so a ray's walk is
// a longer chain of memory latencies than the K-wide walks', and the rays
// of one warp end after very different numbers of steps. The bunny's
// tables (5.2 MB) fit the 50 MB L2, dragon_hd's do not. Most launches are
// the "cluster" intersector's 8,192-ray chunks, in which the rays the cull
// resolved enter with t_max = -INF and end at their first step. The design
// (bvh_common.cuh, the persistent binary walk):
//   - a persistent grid of as many 128-thread blocks as are resident; each
//     warp takes rays in input order from one counter and refills its idle
//     lanes when fewer than kRefillBelow are live; with no stack, a new ray
//     resets only the lane's cursor and best hit;
//   - each step reads the node row with five float2 loads through the
//     read-only path, and at a leaf the ray enters only its `count`
//     triangles: float4 loads where leaf_rows is a 16-byte stride from a
//     16-byte aligned base (leaf 4, 8, ...), scalar loads otherwise (leaf
//     6: 54 floats), the instance chosen by the wrapper from the table's
//     geometry.
// ptxas (nvcc 12.8, sm_90a; chip_smoke.py's ptxas lines): 78 registers
// with float4 leaf loads, 53 with scalar ones, no stack frame, no spills;
// the one-thread-a-ray design it replaces had 39-40, and so twice the
// resident warps, which kept it ahead on Morton-ordered camera rays.
// Refill below 24 live lanes measured best against 16 and 32; asking 8
// blocks an SM held it to 64 registers with 98 bytes of spills and lost
// on every ray kind (PERF.md section 6).
//
// Per step: test the node's own box against the best t; at a leaf run MT
// over its triangles in slot order (strict tt < best t) and follow the skip
// link; at an internal node go to j + 1 where its box is hit, else follow
// the skip link. The cursor only grows, so end - base steps bound the walk;
// max_iters (65,536, as traverse_packed takes it) also caps each ray's
// steps, as the JAX lockstep loop caps them. The plain version,
// accel/traverse.py traverse_packed, takes the same steps in the same
// order, so the kernel equals it in t, slot, u, v and each ray's step count
// on every lane.

#include "bvh_common.cuh"

namespace {

template <bool kVec>
__global__ void __launch_bounds__(ptk::kWalkThreads,
                                  ptk::kPreorderMinBlocks)
closest_hit_binary_kernel(ptk::RowTable tab, const float* __restrict__ org,
                          const float* __restrict__ dir,
                          const float* __restrict__ t_max, int n, int base,
                          int end, int max_iters, float* __restrict__ t_out,
                          int* __restrict__ slot_out,
                          float* __restrict__ u_out,
                          float* __restrict__ v_out,
                          int* __restrict__ next_ray,
                          unsigned long long* __restrict__ counts) {
  ptk::Ray r;
  ptk::Best b;
  ptk::persistent_walk(
      n, end, max_iters, next_ray, counts,
      [&](int i) {
        r = ptk::load_ray(org, dir, i);
        b = ptk::Best{t_max[i], -1, 0.0f, 0.0f};
        return base;
      },
      [&](int cur) {
        return ptk::binary_step(
            tab, cur, r, b.t, [&](const float* leaf, int first, int cnt) {
              ptk::closest_in_leaf<kVec>(leaf, first, cnt, r, b);
            });
      },
      [&](int i, int) {
        t_out[i] = b.slot >= 0 ? b.t : ptk::kInf;
        slot_out[i] = b.slot;
        u_out[i] = b.u;
        v_out[i] = b.v;
      });
}

template <bool kVec>
int launch(const ptk::RowTable& tab, const float* org, const float* dir,
           const float* t_max, int n, int base, int end, int max_iters,
           float* t_out, int* slot_out, float* u_out, float* v_out,
           int* next_ray, unsigned long long* counts, cudaStream_t s) {
  static const int resident =
      ptk::resident_blocks(closest_hit_binary_kernel<kVec>);
  closest_hit_binary_kernel<kVec>
      <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, 0, s>>>(
          tab, org, dir, t_max, n, base, end, max_iters, t_out, slot_out,
          u_out, v_out, next_ray, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// next_ray and counts as in pt_closest_hit. rows starts on an 8-byte
// boundary and node_stride is even (float2 loads); vec: 1 where leaves
// starts on a 16-byte boundary and leaf_stride is a multiple of 4 floats
// (float4 loads), else 0 (scalar loads); the wrapper checks both. Each ray
// takes at most min(end - base, max_iters) steps.
extern "C" int pt_closest_hit_binary(
    const float* rows, const float* leaves, int node_stride, int leaf_stride,
    int vec, const float* org, const float* dir, const float* t_max, int n,
    int base, int end, int leaf_size, int max_iters, float* t_out,
    int* slot_out, float* u_out, float* v_out, int* next_ray,
    unsigned long long* counts, void* stream) {
  const ptk::RowTable tab{rows, leaves, node_stride, leaf_stride, leaf_size};
  const int cap = end - base < max_iters ? end - base : max_iters;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(tab, org, dir, t_max, n, base, end, cap, t_out,
                            slot_out, u_out, v_out, next_ray, counts, s)
             : launch<false>(tab, org, dir, t_max, n, base, end, cap, t_out,
                             slot_out, u_out, v_out, next_ray, counts, s);
}
