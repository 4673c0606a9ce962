// Closest-hit over the fat BVH table: one thread per ray, ordered stack.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/ordered_kernel.py
// pallas_traverse_ordered8_fat (body _kernel8_ord_fat), the closest-hit of
// every flat mesh scene. The TPU kernel walks a packet of 8x128 rays with a
// shared consensus stack and DMAs one fat row pair per group step; its
// `pipelined`, `mt_gate`, `desc_gate` and `order_mode` options only
// schedule that DMA and change no result, so they have no counterpart here.
//
// What bounds it on an H100: each visited node is a dependent load of a
// 1 KB fat row pair (the next address is known only after the current box
// and child tests), so a ray's walk is a chain of memory latencies, and the
// per-thread stack (kStackCap ints) plus the K child keys cost registers
// and spill to local memory. This first version keeps the design simple:
// one thread per ray, no shared memory, reads through the read-only path;
// occupancy hides part of the latency, and the near-to-far order shrinks
// best t early so far subtrees are culled when popped. It does no packet
// reordering, TMA or warp cooperation.
//
// Per iteration: pop a node, re-test its own box against the current best
// t; at a leaf run MT over its leaf_size triangles; at an internal node
// slab-test the K child boxes, push the hit ones far to near and continue
// with the nearest. The loop is bounded by the node count (end - base + 2),
// as max_iters bounds the TPU kernel. The walk body is ptk::ordered_closest
// (bvh_common.cuh), which closest_hit_split.cu runs over the split tables.

#include "bvh_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(128)
closest_hit_kernel(const float* __restrict__ fat,
                   const float* __restrict__ org,
                   const float* __restrict__ dir,
                   const float* __restrict__ t_max, int n, int base, int end,
                   int leaf_size, float* __restrict__ t_out,
                   int* __restrict__ slot_out, float* __restrict__ u_out,
                   float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const ptk::Ray r = ptk::load_ray(org, dir, i);
  ptk::Best b{t_max[i], -1, 0.0f, 0.0f};
  ptk::ordered_closest<K, ptk::Push::kFull>(ptk::FatTable{fat}, r, base, end,
                                            leaf_size, b);
  t_out[i] = b.slot >= 0 ? b.t : ptk::kInf;
  slot_out[i] = b.slot;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

}  // namespace

extern "C" int pt_closest_hit(const float* fat, const float* org,
                              const float* dir, const float* t_max, int n,
                              int base, int end, int leaf_size, int k,
                              float* t_out, int* slot_out, float* u_out,
                              float* v_out, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      closest_hit_kernel<4><<<blocks, threads, 0, s>>>(
          fat, org, dir, t_max, n, base, end, leaf_size, t_out, slot_out,
          u_out, v_out);
      break;
    case 8:
      closest_hit_kernel<8><<<blocks, threads, 0, s>>>(
          fat, org, dir, t_max, n, base, end, leaf_size, t_out, slot_out,
          u_out, v_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
