// Closest-hit over the fat table: a preorder packet walk of 128 rays
// through a block cache of 32 fat row pairs in shared memory.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/hbm_kernel.py
// pallas_traverse_hbm8_fat_cache (body _kernel8_hbm_fat_cache): each group
// of 128 rays keeps one cache block of CBLK = 32 fat pairs (64 rows,
// 32 KB) and its tag; on a miss (j / 32 != tag) one DMA brings the whole
// block, and the step reads pair j % 32 from it. The walk is the preorder
// packet walk, so preorder adjacency (a child follows its parent) makes
// coherent walks hit the cache.
//
// Per step, the block of 128 threads (ptk::packet_closest with
// FatCacheStager):
//   - on a miss, the block copies fat rows [64 b, 64 b + 64) of block
//     b = j / 32 into the 32 KB dynamic shared-memory cache, 2,048
//     16-byte cp.async copies, 16 a thread, waits and syncs; the tag is
//     the same for every thread of the block, so each holds it in a
//     register;
//   - node j's row is cache + 2 (j % 32) * 128 and its leaf block the row
//     after it, so a leaf costs no second copy;
//   - the shared preorder step, then the block minimum of the lanes' next
//     nodes as the cursor.
// The JAX wrapper pads the whole fat table with zeros to a block multiple
// on every call; this kernel copies the last block only up to the
// table's end and never copies the table. Each lane gets the slot its own
// preorder walk gives, so the results equal closest_hit_preorder.cu's on
// every lane and do not depend on the packet width.
//
// What bounds it on an H100: the dependent loads of the walk, now one
// 32 KB block copy on each miss (a miss costs 64 rows where the walk
// needs one pair), one __syncthreads() a step plus one a miss, and the
// union of 128 lanes' nodes a step. What the design does about it: a hit
// costs no device-memory read at all, one copy serves 128 rays, and
// 32 KB of shared memory a block leaves room for six blocks an SM.

#include "bvh_common.cuh"

namespace {

constexpr int kPairs = 32;  // fat pairs a cache block (CBLK)

struct FatCacheStager {
  const float* fat;
  int n_fat_rows;
  float* cache;  // shared, 2 kPairs rows
  int tag;

  __device__ __forceinline__ const float* node(int j) {
    const int blk = j / kPairs;
    if (blk != tag) {
      ptk::stage_rows(cache, fat, 2 * kPairs * blk, 2 * kPairs, n_fat_rows);
      tag = blk;
    }
    return cache + static_cast<size_t>(2 * (j % kPairs)) * ptk::kRow;
  }
  __device__ __forceinline__ const float* leaf(const float* row) const {
    return row + ptk::kRow;
  }
};

template <int K>
__global__ void __launch_bounds__(ptk::kPacket)
closest_hit_fat_cache_kernel(const float* __restrict__ fat, int n_fat_rows,
                             const float* __restrict__ org,
                             const float* __restrict__ dir,
                             const float* __restrict__ t_max, int n, int base,
                             int end, int leaf_size, float* __restrict__ t_out,
                             int* __restrict__ slot_out,
                             float* __restrict__ u_out,
                             float* __restrict__ v_out) {
  extern __shared__ __align__(16) float cache[];
  FatCacheStager st{fat, n_fat_rows, cache, -1};
  ptk::packet_closest<K>(st, org, dir, t_max, n, base, end, leaf_size, t_out,
                         slot_out, u_out, v_out);
}

}  // namespace

extern "C" int pt_closest_hit_fat_cache(const float* fat, int n_fat_rows,
                                        const float* org, const float* dir,
                                        const float* t_max, int n, int base,
                                        int end, int leaf_size, int k,
                                        float* t_out, int* slot_out,
                                        float* u_out, float* v_out,
                                        void* stream) {
  const int blocks = (n + ptk::kPacket - 1) / ptk::kPacket;
  const size_t smem = 2 * kPairs * ptk::kRow * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      closest_hit_fat_cache_kernel<4><<<blocks, ptk::kPacket, smem, s>>>(
          fat, n_fat_rows, org, dir, t_max, n, base, end, leaf_size, t_out,
          slot_out, u_out, v_out);
      break;
    case 8:
      closest_hit_fat_cache_kernel<8><<<blocks, ptk::kPacket, smem, s>>>(
          fat, n_fat_rows, org, dir, t_max, n, base, end, leaf_size, t_out,
          slot_out, u_out, v_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
