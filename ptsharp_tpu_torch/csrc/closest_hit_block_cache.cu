// Closest-hit over the split node and leaf tables: a preorder packet walk
// of 128 rays through two 64-row block caches in shared memory, one for
// node rows and one for leaf blocks.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/hbm_kernel.py
// pallas_traverse_hbm8 (body _kernel8_hbm), the block-cache design over
// `rows` + `leaf` in HBM, each a multiple of BLK = 64 rows: every group of
// 128 rays keeps a node cache and a leaf cache of 64 rows (32 KB) each,
// with their own tags; a step whose node row lies outside the node
// cache's block copies that block, and a leaf node whose leaf row lies
// outside the leaf cache's block copies that one. Its `leaf_mode` (0/1/2)
// only chooses how the TPU schedules the leaf copies and changes no
// result, so it has no counterpart here.
//
// Per step, the block of 128 threads (ptk::packet_closest with
// BlockCacheStager):
//   - on a node-cache miss (j / 64 != node tag) the block copies rows
//     [64 b, 64 b + 64) into the first 32 KB of dynamic shared memory,
//     2,048 16-byte cp.async copies, 16 a thread, waits and syncs;
//   - at a leaf, the same for leaf row first / leaf_size and the leaf
//     cache, the second 32 KB;
//   - the shared preorder step against the cached rows, then the block
//     minimum of the lanes' next nodes as the cursor.
// The tags are the same for every thread of the block, so each holds
// them in registers. Each lane gets the slot its own preorder walk gives,
// so the results equal closest_hit_preorder.cu's on every lane and do not
// depend on the packet width.
//
// What bounds it on an H100: the dependent loads of the walk, now block
// copies of 32 KB on each miss of either cache, one __syncthreads() a
// step plus one a miss, and the union of 128 lanes' nodes a step. 64 KB
// of dynamic shared memory a block, above the 48 KB default, so the entry
// raises the kernel's limit; it leaves room for three blocks (12 warps) an
// SM, few to hide latency with. What the design does about it: a hit
// costs no device-memory read, and one copy serves 128 rays.

#include "bvh_common.cuh"

namespace {

constexpr int kBlk = 64;  // rows a cache block (BLK)
constexpr size_t kSmem = 2 * kBlk * ptk::kRow * sizeof(float);

struct BlockCacheStager {
  const float* rows;
  const float* leaves;
  int n_rows, n_leaf, leaf_size;
  float* node_cache;  // shared, kBlk rows
  float* leaf_cache;  // shared, kBlk rows
  int node_tag, leaf_tag;

  __device__ __forceinline__ const float* node(int j) {
    const int blk = j / kBlk;
    if (blk != node_tag) {
      ptk::stage_rows(node_cache, rows, kBlk * blk, kBlk, n_rows);
      node_tag = blk;
    }
    return node_cache + static_cast<size_t>(j % kBlk) * ptk::kRow;
  }
  __device__ __forceinline__ const float* leaf(const float* row) {
    const int lj = reinterpret_cast<const int*>(row)[6] / leaf_size;
    const int blk = lj / kBlk;
    if (blk != leaf_tag) {
      ptk::stage_rows(leaf_cache, leaves, kBlk * blk, kBlk, n_leaf);
      leaf_tag = blk;
    }
    return leaf_cache + static_cast<size_t>(lj % kBlk) * ptk::kRow;
  }
};

template <int K>
__global__ void __launch_bounds__(ptk::kPacket)
closest_hit_block_cache_kernel(const float* __restrict__ rows,
                               const float* __restrict__ leaf, int n_rows,
                               int n_leaf, const float* __restrict__ org,
                               const float* __restrict__ dir,
                               const float* __restrict__ t_max, int n,
                               int base, int end, int leaf_size,
                               float* __restrict__ t_out,
                               int* __restrict__ slot_out,
                               float* __restrict__ u_out,
                               float* __restrict__ v_out) {
  extern __shared__ __align__(16) float caches[];
  BlockCacheStager st{rows,   leaf,   n_rows, n_leaf, leaf_size,
                      caches, caches + kBlk * ptk::kRow, -1, -1};
  ptk::packet_closest<K>(st, org, dir, t_max, n, base, end, leaf_size, t_out,
                         slot_out, u_out, v_out);
}

template <int K>
int launch(const float* rows, const float* leaf, int n_rows, int n_leaf,
           const float* org, const float* dir, const float* t_max, int n,
           int base, int end, int leaf_size, float* t_out, int* slot_out,
           float* u_out, float* v_out, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      closest_hit_block_cache_kernel<K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + ptk::kPacket - 1) / ptk::kPacket;
  closest_hit_block_cache_kernel<K><<<blocks, ptk::kPacket, kSmem, s>>>(
      rows, leaf, n_rows, n_leaf, org, dir, t_max, n, base, end, leaf_size,
      t_out, slot_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_rows and n_leaf are multiples of 64 (the wrapper checks).
extern "C" int pt_closest_hit_block_cache(const float* rows, const float* leaf,
                                          int n_rows, int n_leaf,
                                          const float* org, const float* dir,
                                          const float* t_max, int n, int base,
                                          int end, int leaf_size, int k,
                                          float* t_out, int* slot_out,
                                          float* u_out, float* v_out,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      return launch<4>(rows, leaf, n_rows, n_leaf, org, dir, t_max, n, base,
                       end, leaf_size, t_out, slot_out, u_out, v_out, s);
    case 8:
      return launch<8>(rows, leaf, n_rows, n_leaf, org, dir, t_max, n, base,
                       end, leaf_size, t_out, slot_out, u_out, v_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
