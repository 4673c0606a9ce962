// Closest-hit over the split node and leaf tables: a warp-packet preorder
// walk, 32 rays sharing one cursor.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/wide_kernel.py
// pallas_traverse_wide (body _kernel), the shared-cursor packet walk: a
// tile of rays walks the tree in preorder with one scalar cursor, reads
// one node row per step, and moves the cursor to the minimum over its
// rays of the node each wants next. Its `tile` is the TPU packet size; on
// the card the packet is one warp, so the port takes no tile and the
// results do not depend on it.
//
// Per step, every lane of the warp:
//   - loads node row j, the warp's cursor; the address is warp-uniform,
//     so the load is one broadcast;
//   - tests the node's box against its own best t;
//   - at a leaf, if its box test hit, runs MT over leaf[first / leaf_size]
//     (also one address for the warp) in slot order, strict tt < best t;
//   - picks its own next node: the hit child of smallest preorder index
//     at an internal node it entered, else the skip link;
// and the warp's next cursor is __reduce_min_sync over the lanes' next
// nodes. Lanes past R contribute INT_MAX and test nothing; a lane whose
// own walk is done wants a node at or past `end`, which the minimum
// passes over. Child indices and skip links point forward, so the cursor
// only grows and end - base steps bound the walk (wide_kernel.py:312-315).
//
// Each lane gets the slot its own preorder walk (closest_hit_preorder.cu)
// gives: a lane also tests the nodes other lanes want, but those lie
// inside boxes it missed or pruned (a child box lies inside its parent's,
// and best t only shrinks), so it misses them again and accepts the same
// triangles in the same order. The plain version is therefore the
// preorder walk over the split tables.
//
// What bounds it on an H100: the warp visits the union of its lanes'
// nodes, so its speed follows the rays' coherence: camera rays in Morton
// order share most of their walk and load each row once for 32 rays,
// where a per-ray walk loads it up to 32 times; scattered bounce rays
// make the warp visit many nodes most lanes miss. The design keeps no
// stack and no shared memory; each step is one warp-uniform row load and
// one warp reduction. Sorting rays into coherent warps, shared-memory
// staging and TMA are left to later work.

#include <climits>

#include "bvh_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(128)
closest_hit_packet_kernel(const float* __restrict__ rows,
                          const float* __restrict__ leaf,
                          const float* __restrict__ org,
                          const float* __restrict__ dir,
                          const float* __restrict__ t_max, int n, int base,
                          int end, int leaf_size, float* __restrict__ t_out,
                          int* __restrict__ slot_out,
                          float* __restrict__ u_out,
                          float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a warp with no ray leaves as a whole; otherwise every lane stays in
  // the loop for the warp reduction
  if (i - static_cast<int>(threadIdx.x & 31) >= n) return;
  const bool live = i < n;
  const ptk::Ray r = ptk::load_ray(org, dir, live ? i : 0);
  const ptk::SplitTable tab{rows, leaf, leaf_size};
  ptk::Best b{live ? t_max[i] : -ptk::kInf, -1, 0.0f, 0.0f};
  int cur = base;
  const int max_iters = end - base;
  for (int it = 0; cur < end && it < max_iters; ++it) {
    const float* node = tab.node(cur);
    const int* bits = reinterpret_cast<const int*>(node);
    float tmin, tmax;
    ptk::slab(node, r, tmin, tmax);
    int next = bits[8];  // skip link
    if (live && ptk::box_hit(tmin, tmax, b.t)) {
      if ((bits[7] & 0xFF) > 0) {
        ptk::leaf_closest(tab.leaf(node), bits[6], leaf_size, r, b);
      } else {
        const int c = ptk::first_hit_child<K>(node, r, b.t);
        if (c >= 0) next = c;
      }
    }
    cur = __reduce_min_sync(0xffffffffu, live ? next : INT_MAX);
  }
  if (!live) return;
  t_out[i] = b.slot >= 0 ? b.t : ptk::kInf;
  slot_out[i] = b.slot;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

}  // namespace

extern "C" int pt_closest_hit_packet(const float* rows, const float* leaf,
                                     const float* org, const float* dir,
                                     const float* t_max, int n, int base,
                                     int end, int leaf_size, int k,
                                     float* t_out, int* slot_out,
                                     float* u_out, float* v_out,
                                     void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      closest_hit_packet_kernel<4><<<blocks, threads, 0, s>>>(
          rows, leaf, org, dir, t_max, n, base, end, leaf_size, t_out,
          slot_out, u_out, v_out);
      break;
    case 8:
      closest_hit_packet_kernel<8><<<blocks, threads, 0, s>>>(
          rows, leaf, org, dir, t_max, n, base, end, leaf_size, t_out,
          slot_out, u_out, v_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
