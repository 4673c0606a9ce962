// Closest-hit by the K-wide preorder walk along skip links, no stack: one
// thread per ray, over the fat BVH table (pt_closest_hit_preorder) or over
// the XLA walk's row tables w_rows + leaf_rows (pt_closest_hit_wide_rows).
//
// Replaces two TPU kernels that compute the same preorder closest-hit:
// ptsharp_tpu/pallas/wide_kernel.py pallas_traverse_wide8 (body _kernel8,
// over separate node and leaf tables held in VMEM) and
// ptsharp_tpu/pallas/hbm_kernel.py pallas_traverse_hbm8_fat (body
// _kernel8_hbm_fat, over the fat interleave streamed from HBM). pack_fat
// puts node i's leaf block beside node i, so both read the same data and
// one kernel over the port's single fat table serves both. The TPU
// kernels move a 128-ray group's shared cursor to the minimum of its
// lanes' next nodes; a lane then also tests nodes inside boxes it missed
// or pruned, misses them again (a child box lies inside its parent's, and
// best t only shrinks), and so accepts the same triangles in the same
// order as this one-ray walk: slots agree exactly, ties included.
//
// The same walk body over a third table view (ptk::RowTable: node rows of
// row_width(K) floats, leaf blocks of leaf_size * 9) is the XLA "wide"
// intersector's traverse_wide (ptsharp_tpu/accel/traverse.py), the JAX
// package's default mesh walk and its shadow-ray walk for every non-pallas
// intersector. It is no TPU kernel of its own: only the strides differ,
// and max_iters (65,536, as traverse_wide takes it) caps each ray's steps.
//
// What bounds it on an H100: each step is a dependent load of a node row
// (a 1 KB fat row pair, or a 160- or 288-byte wide row; the next address
// is known only after the box and child tests), so a ray's walk is a chain
// of memory latencies; and the walk visits more nodes than the near-to-far
// walk of closest_hit.cu, because children are taken in preorder, not by
// entry distance, and best t shrinks later. What the design does about it:
// the walk keeps no stack, only the cursor and the best t, slot, u and v,
// so nothing lives in local memory (ptxas, nvcc 12.8 for sm_90a: a 0-byte
// stack frame, against 576 bytes for closest_hit.cu at K=8). It does not
// save registers: ptxas gives it 47 at K=8 against closest_hit.cu's 39, so
// fewer warps fit on an SM to hide each other's load latency. Bounding the
// registers, packet reordering, TMA and warp cooperation are left to later
// work.
//
// Per step: test the node's own box against the best t; at a leaf run MT
// over its leaf_size triangles in slot order (strict tt < best t) and
// follow the skip link; at an internal node go to the hit child of
// smallest preorder index, or follow the skip link when none is hit. Child
// indices and skip links point forward, so the cursor only grows and
// end - base steps bound the walk, as max_iters bounds the TPU kernels.

#include "bvh_common.cuh"

namespace {

template <int K, class Table>
__global__ void __launch_bounds__(128)
closest_hit_preorder_kernel(Table tab, const float* __restrict__ org,
                            const float* __restrict__ dir,
                            const float* __restrict__ t_max, int n, int base,
                            int end, int max_iters, int leaf_size,
                            float* __restrict__ t_out,
                            int* __restrict__ slot_out,
                            float* __restrict__ u_out,
                            float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const ptk::Ray r = ptk::load_ray(org, dir, i);
  ptk::Best b{t_max[i], -1, 0.0f, 0.0f};
  int cur = base;
  for (int it = 0; cur < end && it < max_iters; ++it) {
    const float* node = tab.node(cur);
    const int* bits = reinterpret_cast<const int*>(node);
    float tmin, tmax;
    ptk::slab(node, r, tmin, tmax);
    int next = bits[8];  // skip link
    if (ptk::box_hit(tmin, tmax, b.t)) {
      if ((bits[7] & 0xFF) > 0) {
        ptk::leaf_closest(tab.leaf(node), bits[6], leaf_size, r, b);
      } else {
        const int c = ptk::first_hit_child<K>(node, r, b.t);
        if (c >= 0) next = c;
      }
    }
    cur = next;
  }
  t_out[i] = b.slot >= 0 ? b.t : ptk::kInf;
  slot_out[i] = b.slot;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

template <class Table>
int launch(const Table& tab, const float* org, const float* dir,
           const float* t_max, int n, int base, int end, int max_iters,
           int leaf_size, int k, float* t_out, int* slot_out, float* u_out,
           float* v_out, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      closest_hit_preorder_kernel<4, Table><<<blocks, threads, 0, s>>>(
          tab, org, dir, t_max, n, base, end, max_iters, leaf_size, t_out,
          slot_out, u_out, v_out);
      break;
    case 8:
      closest_hit_preorder_kernel<8, Table><<<blocks, threads, 0, s>>>(
          tab, org, dir, t_max, n, base, end, max_iters, leaf_size, t_out,
          slot_out, u_out, v_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pt_closest_hit_preorder(const float* fat, const float* org,
                                       const float* dir, const float* t_max,
                                       int n, int base, int end,
                                       int leaf_size, int k, float* t_out,
                                       int* slot_out, float* u_out,
                                       float* v_out, void* stream) {
  return launch(ptk::FatTable{fat}, org, dir, t_max, n, base, end,
                end - base, leaf_size, k, t_out, slot_out, u_out, v_out,
                stream);
}

extern "C" int pt_closest_hit_wide_rows(
    const float* rows, const float* leaves, int node_stride, int leaf_stride,
    const float* org, const float* dir, const float* t_max, int n, int base,
    int end, int leaf_size, int k, int max_iters, float* t_out,
    int* slot_out, float* u_out, float* v_out, void* stream) {
  const ptk::RowTable tab{rows, leaves, node_stride, leaf_stride, leaf_size};
  return launch(tab, org, dir, t_max, n, base, end, max_iters, leaf_size, k,
                t_out, slot_out, u_out, v_out, stream);
}
