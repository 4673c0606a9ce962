// Closest-hit over the split node and leaf tables: the preorder walk in
// warp packets of 32 rays, persistent warps, reading node rows from one
// ring of two cache blocks and leaf blocks from another, both filled by
// TMA bulk copies.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/hbm_kernel.py
// pallas_traverse_hbm8 (body _kernel8_hbm), the block-cache design over
// `rows` + `leaf` in HBM, each a multiple of BLK = 64 rows: every group of
// 128 rays shares one cursor and keeps a node cache and a leaf cache of 64
// rows (32 KB, the TPU's DMA size) each, with their own tags; a miss of
// either copies its whole block. Its `leaf_mode` (0/1/2) only chooses how
// the TPU schedules the leaf copies and changes no result, so it has no
// counterpart here. The wrapper keeps the JAX contract that both tables
// are multiples of 64 rows; any block size that divides 64 stays inside
// the tables, and the last block is copied only up to a table's end.
//
// What bounds it on an H100: each step is a dependent read of a node row,
// and at a leaf of a leaf block found from the row (the next cursor is
// known only after the lanes' tests), and a packet visits the union of its
// lanes' walks. The first design (a block of 128 rays sharing a cursor, two
// 32 KB cp.async caches, 64 KB of shared memory a block) had four faults,
// and this design answers each (ptk::warp_packet_closest, ptk::TmaRing and
// ptk::SplitRings in bvh_common.cuh):
//   1. a packet of 128 lanes walked the union of 128 rays' walks: the
//      packet is one warp of 32 rays, and the cursor a __reduce_min_sync;
//   2. two __syncthreads() a step on a miss of either cache and a
//      synchronous copy of the whole block before any test: nothing wider
//      than the warp synchronises, one lane issues TMA bulk copies that
//      report to an mbarrier a buffer, and each ring copies the block after
//      the one in use while the warp tests it (the cursor only grows, and
//      in these tables so do the leaf rows it reaches: tests/
//      test_torch_staged.py checks it on the test scenes);
//   3. 64 rows a copy, the TPU's DMA size, and 64 KB a block (three blocks
//      an SM): kBlockRows rows a buffer, sized for the card by measurement
//      (PERF.md section 6), two buffers a ring, two rings a warp;
//   4. one block per 128 rays: a persistent grid of the resident blocks
//      (counted with this dynamic shared memory), each warp taking 32
//      consecutive (Morton-ordered) rays from the ray counter at a time.
// The leaf ring is touched only at a leaf some lane at the cursor enters,
// at leaf row first / leaf_size. Every lane reads the same rows from shared
// memory, a broadcast, and only the fields a step uses. Each lane takes
// exactly the steps of its own preorder walk, so the results equal
// closest_hit_preorder.cu's in t, slot, u and v on every lane.
// On the card (PERF.md section 6) it beats closest_hit_preorder.cu on
// coherent camera rays, where one shared row serves most lanes, and stays
// about four times slower on scattered bounce rays: there a packet walks
// the union of 32 walks, moving under two lanes a step, and a step costs
// the warp's instructions however few lanes it moves.

#include "bvh_common.cuh"

namespace {

// table rows (512 B each) a ring buffer holds, in both rings: the block a
// copy moves; it divides 64, the tables' row multiple. Measured at 1, 2,
// 4, 8 and 16 rows (PERF.md section 6): one row, a node row or a leaf
// block a copy with the next one prefetched, is the fastest (4 rows within
// 2%, 16 rows 2.5x slower)
constexpr int kBlockRows = 1;
static_assert(64 % kBlockRows == 0, "a block must divide the 64-row tables");
using Ring = ptk::TmaRing<kBlockRows>;
constexpr int kWarpSmem = ptk::warp_smem(2 * Ring::kBytes);
constexpr int kSmem = (ptk::kWalkThreads / 32) * kWarpSmem;

template <int K>
__global__ void __launch_bounds__(ptk::kWalkThreads, ptk::kPreorderMinBlocks)
closest_hit_block_cache_kernel(const float* __restrict__ rows,
                               const float* __restrict__ leaf, int n_rows,
                               int n_leaf, const float* __restrict__ org,
                               const float* __restrict__ dir,
                               const float* __restrict__ t_max, int n,
                               int base, int end, int leaf_size,
                               float* __restrict__ t_out,
                               int* __restrict__ slot_out,
                               float* __restrict__ u_out,
                               float* __restrict__ v_out,
                               int* __restrict__ next_ray,
                               unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(128) unsigned char smem[];
  ptk::SplitRings<Ring> tab;
  tab.init(rows, n_rows, end, leaf, n_leaf, leaf_size,
           smem + (threadIdx.x / 32) * kWarpSmem);
  ptk::warp_packet_closest<K>(tab, org, dir, t_max, n, base, end, t_out,
                              slot_out, u_out, v_out, next_ray, counts);
}

template <int K>
int launch(const float* rows, const float* leaf, int n_rows, int n_leaf,
           const float* org, const float* dir, const float* t_max, int n,
           int base, int end, int leaf_size, float* t_out, int* slot_out,
           float* u_out, float* v_out, int* next_ray,
           unsigned long long* counts, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      closest_hit_block_cache_kernel<K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int resident =
      ptk::resident_blocks(closest_hit_block_cache_kernel<K>, kSmem);
  closest_hit_block_cache_kernel<K>
      <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, kSmem, s>>>(
          rows, leaf, n_rows, n_leaf, org, dir, t_max, n, base, end,
          leaf_size, t_out, slot_out, u_out, v_out, next_ray, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_rows and n_leaf are multiples of 64 and both tables start on 16-byte
// boundaries (the wrapper checks both); next_ray as in pt_closest_hit;
// counts, if not null, (5,) as ptk::warp_packet_closest fills it, both
// rings' copies summed.
extern "C" int pt_closest_hit_block_cache(const float* rows, const float* leaf,
                                          int n_rows, int n_leaf,
                                          const float* org, const float* dir,
                                          const float* t_max, int n, int base,
                                          int end, int leaf_size, int k,
                                          float* t_out, int* slot_out,
                                          float* u_out, float* v_out,
                                          int* next_ray,
                                          unsigned long long* counts,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      return launch<4>(rows, leaf, n_rows, n_leaf, org, dir, t_max, n, base,
                       end, leaf_size, t_out, slot_out, u_out, v_out,
                       next_ray, counts, s);
    case 8:
      return launch<8>(rows, leaf, n_rows, n_leaf, org, dir, t_max, n, base,
                       end, leaf_size, t_out, slot_out, u_out, v_out,
                       next_ray, counts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Table rows a ring buffer holds, dynamic shared memory a launch asks for
// and whether the rings prefetch, for the plain model of the schedule and
// the records.
extern "C" int pt_closest_hit_block_cache_block_rows() { return kBlockRows; }
extern "C" int pt_closest_hit_block_cache_smem() { return kSmem; }
extern "C" int pt_closest_hit_block_cache_prefetch() { return 1; }
