// Closest-hit over the split node and leaf tables: a preorder packet walk
// of 128 rays that stages each step's node row, and at a leaf its leaf
// block, into shared memory with cp.async.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/hbm_kernel.py
// pallas_traverse_hbm8_row (body _kernel8_hbm_row), the row-DMA variant of
// the HBM streaming walk: a group of 128 rays shares one cursor; each step
// copies node row j from HBM into VMEM and, at a leaf, leaf row
// first // leaf_size, with no cache; the next cursor is the group's
// minimum over its lanes' next nodes. The TPU kernel clamps the leaf
// index to the last full 64-row block of the leaf table, so on a table
// that is not a multiple of 64 rows the leaves past that block read the
// wrong row (ROADMAP Queue 3). This kernel reads leaf[first / leaf_size]
// on any leaf table.
//
// Per step, the block of 128 threads (ptk::packet_closest with RowStager):
//   1. stages node row j, 512 B (32 threads x 16 B of cp.async), waits
//      and syncs;
//   2. at a leaf (count > 0, the same for the whole block) stages its
//      leaf row the same way;
//   3. runs the shared preorder step (ptk::packet_step) against the staged
//      rows, one ray a thread;
//   4. takes the block minimum of the lanes' next nodes as the cursor.
// Each lane gets the slot its own preorder walk gives, so the results
// equal closest_hit_preorder.cu's on every lane and do not depend on the
// packet width.
//
// What bounds it on an H100: each step is a dependent row load (the next
// cursor is known only after every lane's tests), now also two or three
// __syncthreads() a step, and the packet visits the union of its 128
// lanes' nodes, so scattered rays make it visit many nodes most lanes
// miss. What the design does about it: one copy serves 128 rays (the row
// is read from device memory once per packet, not once per ray), and the
// reads from shared memory are broadcasts. Only 1 KB of shared memory a
// block, so occupancy is set by registers. Prefetching the next row
// before the MT is left to later work.

#include "bvh_common.cuh"

namespace {

struct RowStager {
  const float* rows;
  const float* leaves;
  int n_rows, n_leaf, leaf_size;
  float* node_row;  // shared, kRow floats
  float* leaf_row;  // shared, kRow floats

  __device__ __forceinline__ const float* node(int j) {
    ptk::stage_rows(node_row, rows, j, 1, n_rows);
    return node_row;
  }
  __device__ __forceinline__ const float* leaf(const float* row) {
    const int first = reinterpret_cast<const int*>(row)[6];
    ptk::stage_rows(leaf_row, leaves, first / leaf_size, 1, n_leaf);
    return leaf_row;
  }
};

template <int K>
__global__ void __launch_bounds__(ptk::kPacket)
closest_hit_row_stage_kernel(const float* __restrict__ rows,
                             const float* __restrict__ leaf, int n_rows,
                             int n_leaf, const float* __restrict__ org,
                             const float* __restrict__ dir,
                             const float* __restrict__ t_max, int n, int base,
                             int end, int leaf_size, float* __restrict__ t_out,
                             int* __restrict__ slot_out,
                             float* __restrict__ u_out,
                             float* __restrict__ v_out) {
  __shared__ __align__(16) float node_row[ptk::kRow];
  __shared__ __align__(16) float leaf_row[ptk::kRow];
  RowStager st{rows, leaf, n_rows, n_leaf, leaf_size, node_row, leaf_row};
  ptk::packet_closest<K>(st, org, dir, t_max, n, base, end, leaf_size, t_out,
                         slot_out, u_out, v_out);
}

}  // namespace

extern "C" int pt_closest_hit_row_stage(const float* rows, const float* leaf,
                                        int n_rows, int n_leaf,
                                        const float* org, const float* dir,
                                        const float* t_max, int n, int base,
                                        int end, int leaf_size, int k,
                                        float* t_out, int* slot_out,
                                        float* u_out, float* v_out,
                                        void* stream) {
  const int blocks = (n + ptk::kPacket - 1) / ptk::kPacket;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      closest_hit_row_stage_kernel<4><<<blocks, ptk::kPacket, 0, s>>>(
          rows, leaf, n_rows, n_leaf, org, dir, t_max, n, base, end,
          leaf_size, t_out, slot_out, u_out, v_out);
      break;
    case 8:
      closest_hit_row_stage_kernel<8><<<blocks, ptk::kPacket, 0, s>>>(
          rows, leaf, n_rows, n_leaf, org, dir, t_max, n, base, end,
          leaf_size, t_out, slot_out, u_out, v_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
