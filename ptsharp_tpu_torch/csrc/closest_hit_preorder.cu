// Closest-hit by the K-wide preorder walk along skip links, no stack, one
// ray a lane in persistent warps that refill their idle lanes: over the
// fat BVH table (pt_closest_hit_preorder), over the split tables rows +
// leaf (pt_closest_hit_packet) or over the XLA walk's row tables w_rows +
// leaf_rows (pt_closest_hit_wide_rows).
//
// Replaces three TPU kernels that compute the same preorder closest-hit:
// ptsharp_tpu/pallas/wide_kernel.py pallas_traverse_wide8 (body _kernel8,
// over separate node and leaf tables held in VMEM),
// ptsharp_tpu/pallas/hbm_kernel.py pallas_traverse_hbm8_fat (body
// _kernel8_hbm_fat, over the fat interleave streamed from HBM), and
// wide_kernel.py pallas_traverse_wide (body _kernel, the shared-cursor
// tile over the split tables). pack_fat puts node i's leaf block beside
// node i, so the first two read the same data and one kernel over the
// port's single fat table serves both; the third reads the split tables
// that pack_fat interleaves, and runs here over them (ptk::SplitTable). The
// TPU kernels move a tile's shared cursor to the minimum of its lanes' next
// nodes; a lane then also tests nodes inside boxes it missed or pruned,
// misses them again (a child box lies inside its parent's, and best t only
// shrinks), and so accepts the same triangles in the same order as this
// one-ray walk: slots agree exactly, ties included. No packet is walked
// here: the tile (and pallas_traverse_wide's `tile`) is a TPU schedule.
//
// The same walk over a third table view (ptk::RowTable: node rows of
// row_width(K) floats, leaf blocks of leaf_size * 9) is the XLA "wide"
// intersector's traverse_wide (ptsharp_tpu/accel/traverse.py), the JAX
// package's default mesh walk. It is no TPU kernel of its own: only the
// strides differ, and max_iters (65,536, as traverse_wide takes it) also
// caps each ray's steps.
//
// What bounds it on an H100: each step is a dependent load of a node row
// (the next address is known only after the box and child tests), so a
// ray's walk is a chain of memory latencies, and rays of one warp end
// after very different numbers of steps. The design (bvh_common.cuh, the
// persistent preorder walk):
//   - a persistent grid of as many 128-thread blocks as are resident; each
//     warp takes rays in input order from one counter and refills its idle
//     lanes when fewer than kRefillBelow (24) are live (measured against
//     16 and 32; PERF.md section 6); with no stack, a new ray resets only
//     the lane's cursor and best hit;
//   - loads of what a step uses through the read-only path: fields [0, 12)
//     first, the child fields only at an internal node the ray enters, and
//     only a leaf's `count` triangles; float4 loads on 16-byte strides (the
//     fat table, the split tables, and w_rows + leaf_rows at leaf 4, 8,
//     ...), scalar loads of the same fields otherwise, the instance chosen
//     by the wrapper from the tables' geometry.
// ptxas (nvcc 12.8, sm_90a; chip_smoke.py's ptxas lines): 79 registers at
// K=4 and 83 at K=8 with float4 loads over each table view, 56 and 96 with
// scalar loads, no
// stack frame and no spills; __launch_bounds__ asks for 4 blocks an SM,
// without which ptxas kept 80 registers at K=8 and spilled 4-8 bytes
// (PERF.md section 6). The one-thread-a-ray design it replaces had 40 and
// 48. The plain versions
// (kernels/traverse.py closest_hit_preorder_plain, closest_hit_packet_plain,
// accel/traverse.py traverse_wide) take the same steps in the same order,
// so the kernel equals them in t, slot, u and v on every lane.
//
// Per step: test the node's own box against the best t; at a leaf run MT
// over its triangles in slot order (strict tt < best t) and follow the
// skip link; at an internal node go to the hit child of smallest
// preorder index, or follow the skip link when none is hit. Child
// indices and skip links point forward, so the cursor only grows and
// end - base steps bound the walk, as max_iters bounds the TPU kernels.

#include "bvh_common.cuh"

namespace {

template <int K, bool kVec, class Table>
__global__ void __launch_bounds__(ptk::kWalkThreads,
                                  ptk::kPreorderMinBlocks)
closest_hit_preorder_kernel(Table tab, const float* __restrict__ org,
                            const float* __restrict__ dir,
                            const float* __restrict__ t_max, int n, int base,
                            int end, int max_iters,
                            float* __restrict__ t_out,
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
        return ptk::preorder_step<K, kVec>(
            tab, cur, r, b.t, end,
            [&](const float* leaf, int first, int cnt) {
              ptk::closest_in_leaf<kVec>(leaf, first, cnt, r, b);
              return false;
            });
      },
      [&](int i, int) {
        t_out[i] = b.slot >= 0 ? b.t : ptk::kInf;
        slot_out[i] = b.slot;
        u_out[i] = b.u;
        v_out[i] = b.v;
      });
}

template <int K, bool kVec, class Table>
int launch(const Table& tab, const float* org, const float* dir,
           const float* t_max, int n, int base, int end, int max_iters,
           float* t_out, int* slot_out, float* u_out, float* v_out,
           int* next_ray, unsigned long long* counts, cudaStream_t s) {
  static const int resident =
      ptk::resident_blocks(closest_hit_preorder_kernel<K, kVec, Table>);
  closest_hit_preorder_kernel<K, kVec, Table>
      <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, 0, s>>>(
          tab, org, dir, t_max, n, base, end, max_iters, t_out, slot_out,
          u_out, v_out, next_ray, counts);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, class Table>
int launch_k(int k, const Table& tab, const float* org, const float* dir,
             const float* t_max, int n, int base, int end, int max_iters,
             float* t_out, int* slot_out, float* u_out, float* v_out,
             int* next_ray, unsigned long long* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      return launch<4, kVec>(tab, org, dir, t_max, n, base, end, max_iters,
                             t_out, slot_out, u_out, v_out, next_ray, counts,
                             s);
    case 8:
      return launch<8, kVec>(tab, org, dir, t_max, n, base, end, max_iters,
                             t_out, slot_out, u_out, v_out, next_ray, counts,
                             s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// next_ray and counts as in pt_closest_hit. The fat table starts on a
// 16-byte boundary (the wrapper checks it). Each ray takes at most
// end - base steps.
extern "C" int pt_closest_hit_preorder(const float* fat, const float* org,
                                       const float* dir, const float* t_max,
                                       int n, int base, int end, int k,
                                       float* t_out, int* slot_out,
                                       float* u_out, float* v_out,
                                       int* next_ray,
                                       unsigned long long* counts,
                                       void* stream) {
  return launch_k<true>(k, ptk::FatTable{fat}, org, dir, t_max, n, base, end,
                        end - base, t_out, slot_out, u_out, v_out, next_ray,
                        counts, stream);
}

// The split tables (node j at rows[j], its leaf block at leaf[first /
// leaf_size]), both starting on 16-byte boundaries (the wrapper checks
// it); next_ray and counts as in pt_closest_hit. Each ray takes at most
// end - base steps.
extern "C" int pt_closest_hit_packet(const float* rows, const float* leaf,
                                     const float* org, const float* dir,
                                     const float* t_max, int n, int base,
                                     int end, int leaf_size, int k,
                                     float* t_out, int* slot_out,
                                     float* u_out, float* v_out,
                                     int* next_ray,
                                     unsigned long long* counts,
                                     void* stream) {
  return launch_k<true>(k, ptk::SplitTable{rows, leaf, leaf_size}, org, dir,
                        t_max, n, base, end, end - base, t_out, slot_out,
                        u_out, v_out, next_ray, counts, stream);
}

// vec: 1 where both tables start on 16-byte boundaries and both strides are
// multiples of 4 floats (float4 loads), else 0 (scalar loads). Each ray
// takes at most min(end - base, max_iters) steps.
extern "C" int pt_closest_hit_wide_rows(
    const float* rows, const float* leaves, int node_stride, int leaf_stride,
    int vec, const float* org, const float* dir, const float* t_max, int n,
    int base, int end, int leaf_size, int k, int max_iters, float* t_out,
    int* slot_out, float* u_out, float* v_out, int* next_ray,
    unsigned long long* counts, void* stream) {
  const ptk::RowTable tab{rows, leaves, node_stride, leaf_stride, leaf_size};
  const int cap = end - base < max_iters ? end - base : max_iters;
  return vec ? launch_k<true>(k, tab, org, dir, t_max, n, base, end, cap,
                              t_out, slot_out, u_out, v_out, next_ray, counts,
                              stream)
             : launch_k<false>(k, tab, org, dir, t_max, n, base, end, cap,
                               t_out, slot_out, u_out, v_out, next_ray,
                               counts, stream);
}
