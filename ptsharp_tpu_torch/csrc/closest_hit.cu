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
// as max_iters bounds the TPU kernel.

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
  float bt = t_max[i];
  int bs = -1;
  float bu = 0.0f, bv = 0.0f;
  int stack[ptk::kStackCap];
  int sp = 0;
  int cur = base;
  const int max_iters = end - base + 2;
  for (int it = 0; cur < end && it < max_iters; ++it) {
    const float* node = fat + static_cast<size_t>(2 * cur) * ptk::kRow;
    const int* bits = reinterpret_cast<const int*>(node);
    float tmin, tmax;
    ptk::slab(node, r, tmin, tmax);
    int next = -1;
    if (ptk::box_hit(tmin, tmax, bt)) {
      if ((bits[7] & 0xFF) > 0) {
        const float* leaf = node + ptk::kRow;
        const int first = bits[6];
        for (int l = 0; l < leaf_size; ++l) {
          float tt, uu, vv;
          if (ptk::mt(leaf + 9 * l, r, tt, uu, vv) && tt < bt) {
            bt = tt;
            bs = first + l;
            bu = uu;
            bv = vv;
          }
        }
      } else {
        float key[K];
        int idx[K];
        const int nh = ptk::hit_children<K>(node, r, bt, key, idx);
        if (nh > 0) {
          ptk::push_far_to_near<K>(idx, nh, stack, sp);
          next = idx[0];
        }
      }
    }
    if (next < 0) next = sp > 0 ? stack[--sp] : end;
    cur = next;
  }
  t_out[i] = bs >= 0 ? bt : ptk::kInf;
  slot_out[i] = bs;
  u_out[i] = bu;
  v_out[i] = bv;
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
