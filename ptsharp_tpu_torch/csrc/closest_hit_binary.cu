// Closest-hit over the binary node rows u_rows (N, 10) and the leaf blocks
// leaf_rows (NL, leaf_size * 9): one thread per ray, the binary skip-link
// walk, no stack.
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
// a longer chain of memory latencies than the K-wide walks'. The bunny's
// tables (5.2 MB) fit the 50 MB L2, dragon_hd's (80.8 MB) do not. What the
// design does about it: the walk keeps no stack, only the cursor and the
// best t, slot, u and v, so many warps fit an SM to hide each other's
// latency; a step reads one node row and, at a hit leaf, one leaf block.
// Rows 10 floats wide are not 16-byte aligned, so loads are scalar. Packet
// schedules and wider loads are left to later work.
//
// Per step (ptk::binary_step): test the node's own box against the best t;
// at a leaf run MT over its leaf_size triangles in slot order (strict
// tt < best t) and follow the skip link; at an internal node go to j + 1
// where its box is hit, else follow the skip link. The cursor only grows,
// so end - base steps bound the walk; max_iters (65,536, as traverse_packed
// takes it) caps each ray's steps as the JAX lockstep loop caps them.

#include "bvh_common.cuh"

namespace {

__global__ void __launch_bounds__(128)
closest_hit_binary_kernel(ptk::RowTable tab, const float* __restrict__ org,
                          const float* __restrict__ dir,
                          const float* __restrict__ t_max, int n, int base,
                          int end, int max_iters, float* __restrict__ t_out,
                          int* __restrict__ slot_out,
                          float* __restrict__ u_out,
                          float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const ptk::Ray r = ptk::load_ray(org, dir, i);
  ptk::Best b{t_max[i], -1, 0.0f, 0.0f};
  int cur = base;
  for (int it = 0; cur < end && it < max_iters; ++it) {
    cur = ptk::binary_step(tab, cur, r, tab.leaf_size, b);
  }
  t_out[i] = b.slot >= 0 ? b.t : ptk::kInf;
  slot_out[i] = b.slot;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

}  // namespace

extern "C" int pt_closest_hit_binary(const float* rows, const float* leaves,
                                     int node_stride, int leaf_stride,
                                     const float* org, const float* dir,
                                     const float* t_max, int n, int base,
                                     int end, int leaf_size, int max_iters,
                                     float* t_out, int* slot_out,
                                     float* u_out, float* v_out,
                                     void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const ptk::RowTable tab{rows, leaves, node_stride, leaf_stride, leaf_size};
  closest_hit_binary_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      tab, org, dir, t_max, n, base, end, max_iters, t_out, slot_out, u_out,
      v_out);
  return static_cast<int>(cudaGetLastError());
}
