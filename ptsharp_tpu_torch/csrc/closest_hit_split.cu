// Closest-hit over the split node and leaf tables: one thread per ray,
// ordered stack, both push orders, and an optional count of each ray's
// steps.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/ordered_kernel.py
// pallas_traverse_ordered8 (body _kernel8_ord), the ordered closest-hit
// over `rows` + `leaf` held in VMEM: node j is rows[j] and a leaf node's
// triangles are leaf[first / leaf_size]. The TPU kernel walks 8 groups of
// 128 rays, each with one consensus cursor and stack; its `defer_leaf`
// batches the groups' MT passes and its `desc_gate` skips the child tests
// on steps where no group descends. Both only schedule the packet's work
// and change no result, so, like `pipelined` and `mt_gate` in
// closest_hit.cu, they have no per-thread counterpart. Its `order_mode` is
// a template parameter here (ptk::Push): "full" pushes the hit children
// far to near, "near" in static reverse order; both take the nearest hit
// child next. Its `return_iters` is the packet's loop count broadcast
// over the tile; the count here is each ray's own number of steps (nodes
// visited), written to an int32 (R,) buffer when one is given.
//
// What bounds it on an H100: the same chain of dependent loads as
// closest_hit.cu, with a node row and its leaf block 512 bytes each in two
// tables instead of a 1 KB row pair, so a visit to an internal node reads
// half the bytes of the fat walk's pair, and a leaf visit reads a block
// from a second table. The per-thread stack of kStackCap ints lives in
// local memory. The design is the simple one: one thread per ray, no
// shared memory; the walk body is ptk::ordered_closest over a SplitTable,
// the same body closest_hit.cu runs over the fat table, so the two give
// the same t, slot, u and v on every lane in the "full" order.

#include "bvh_common.cuh"

namespace {

template <int K, ptk::Push P>
__global__ void __launch_bounds__(128)
closest_hit_split_kernel(const float* __restrict__ rows,
                         const float* __restrict__ leaf,
                         const float* __restrict__ org,
                         const float* __restrict__ dir,
                         const float* __restrict__ t_max, int n, int base,
                         int end, int leaf_size, float* __restrict__ t_out,
                         int* __restrict__ slot_out,
                         float* __restrict__ u_out,
                         float* __restrict__ v_out,
                         int* __restrict__ iters_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const ptk::Ray r = ptk::load_ray(org, dir, i);
  ptk::Best b{t_max[i], -1, 0.0f, 0.0f};
  const int steps = ptk::ordered_closest<K, P>(
      ptk::SplitTable{rows, leaf, leaf_size}, r, base, end, leaf_size, b);
  t_out[i] = b.slot >= 0 ? b.t : ptk::kInf;
  slot_out[i] = b.slot;
  u_out[i] = b.u;
  v_out[i] = b.v;
  if (iters_out != nullptr) iters_out[i] = steps;
}

template <int K, ptk::Push P>
void launch(const float* rows, const float* leaf, const float* org,
            const float* dir, const float* t_max, int n, int base, int end,
            int leaf_size, float* t_out, int* slot_out, float* u_out,
            float* v_out, int* iters_out, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  closest_hit_split_kernel<K, P><<<blocks, threads, 0, s>>>(
      rows, leaf, org, dir, t_max, n, base, end, leaf_size, t_out, slot_out,
      u_out, v_out, iters_out);
}

}  // namespace

// near != 0 selects order_mode "near"; iters_out may be null.
extern "C" int pt_closest_hit_split(const float* rows, const float* leaf,
                                    const float* org, const float* dir,
                                    const float* t_max, int n, int base,
                                    int end, int leaf_size, int k, int near,
                                    float* t_out, int* slot_out, float* u_out,
                                    float* v_out, int* iters_out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using ptk::Push;
  if (k == 4 && !near) {
    launch<4, Push::kFull>(rows, leaf, org, dir, t_max, n, base, end,
                           leaf_size, t_out, slot_out, u_out, v_out,
                           iters_out, s);
  } else if (k == 4) {
    launch<4, Push::kNear>(rows, leaf, org, dir, t_max, n, base, end,
                           leaf_size, t_out, slot_out, u_out, v_out,
                           iters_out, s);
  } else if (k == 8 && !near) {
    launch<8, Push::kFull>(rows, leaf, org, dir, t_max, n, base, end,
                           leaf_size, t_out, slot_out, u_out, v_out,
                           iters_out, s);
  } else if (k == 8) {
    launch<8, Push::kNear>(rows, leaf, org, dir, t_max, n, base, end,
                           leaf_size, t_out, slot_out, u_out, v_out,
                           iters_out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
