// Closest-hit over the split node and leaf tables of any length: the
// preorder walk in warp packets of 32 rays, persistent warps, reading each
// step's node row, and at a leaf its leaf block, from one-row stages in
// shared memory that TMA bulk copies fill.
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
// on any leaf table and needs no padding.
//
// What bounds it on an H100: each step is a dependent read of a node row,
// and at a leaf of a leaf row found from it (the next cursor is known only
// after the lanes' tests), and a packet visits the union of its lanes'
// walks. The first design (a block of 128 rays sharing a cursor, a
// synchronous cp.async copy of each row, two or three __syncthreads() a
// step) walked the union of 128 walks and synchronised the block on every
// copy. This design is #10's body (ptk::warp_packet_closest and
// ptk::SplitRings in bvh_common.cuh) over stages:
//   - the packet is one warp of 32 rays with one cursor, a
//     __reduce_min_sync over the lanes' own cursors; the lanes whose
//     cursor it is take their own preorder step there;
//   - the TPU kernel's schedule, a row a step with no cache, from the
//     card's copy engine: one stage of one row a table (node rows, leaf
//     rows) in the warp's shared memory, which one lane fills with a TMA
//     bulk copy reporting to an mbarrier, copied only when the row the
//     cursor needs is not the one the stage holds; nothing wider than the
//     warp synchronises;
//   - a persistent grid of the resident blocks, each warp taking 32
//     consecutive (Morton-ordered) rays from the ray counter at a time.
// kPrefetch chooses the stage: without it one buffer a table and no
// prefetch; with it #10's ring, two buffers a table and the next row
// prefetched. Both were measured on the card (PERF.md section 6). Every
// lane reads the same row from shared memory, a broadcast, and only the
// fields a step uses. Each lane takes exactly the steps of its own
// preorder walk, so the results equal closest_hit_preorder.cu's in t,
// slot, u and v on every lane.

#include "bvh_common.cuh"

namespace {

// whether each table's stage prefetches the row after the one in use (a
// ring of two one-row buffers, #10's) or holds one row (PERF.md section 6)
constexpr bool kPrefetch = false;
constexpr int kBlockRows = 1;  // table rows (512 B) a copy moves
using Stage = ptk::TmaRing<kBlockRows, kPrefetch>;
constexpr int kWarpSmem = ptk::warp_smem(2 * Stage::kBytes);
constexpr int kSmem = (ptk::kWalkThreads / 32) * kWarpSmem;

template <int K>
__global__ void __launch_bounds__(ptk::kWalkThreads, ptk::kPreorderMinBlocks)
closest_hit_row_stage_kernel(const float* __restrict__ rows,
                             const float* __restrict__ leaf, int n_rows,
                             int n_leaf, const float* __restrict__ org,
                             const float* __restrict__ dir,
                             const float* __restrict__ t_max, int n, int base,
                             int end, int leaf_size, float* __restrict__ t_out,
                             int* __restrict__ slot_out,
                             float* __restrict__ u_out,
                             float* __restrict__ v_out,
                             int* __restrict__ next_ray,
                             unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(128) unsigned char smem[];
  ptk::SplitRings<Stage> tab;
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
      closest_hit_row_stage_kernel<K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int resident =
      ptk::resident_blocks(closest_hit_row_stage_kernel<K>, kSmem);
  closest_hit_row_stage_kernel<K>
      <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, kSmem, s>>>(
          rows, leaf, n_rows, n_leaf, org, dir, t_max, n, base, end,
          leaf_size, t_out, slot_out, u_out, v_out, next_ray, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both tables start on 16-byte boundaries (the wrapper checks it), of any
// length; next_ray as in pt_closest_hit; counts, if not null, (5,) as
// ptk::warp_packet_closest fills it, both stages' copies summed.
extern "C" int pt_closest_hit_row_stage(const float* rows, const float* leaf,
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

// Table rows a stage buffer holds, dynamic shared memory a launch asks for
// and whether the stages prefetch, for the plain model of the schedule and
// the records.
extern "C" int pt_closest_hit_row_stage_block_rows() { return kBlockRows; }
extern "C" int pt_closest_hit_row_stage_smem() { return kSmem; }
extern "C" int pt_closest_hit_row_stage_prefetch() { return kPrefetch; }
