// Closest-hit over the fat table: the preorder walk in warp packets of 32
// rays, persistent warps, reading node rows and leaf blocks from a ring of
// two cache blocks of the fat table that TMA bulk copies fill.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/hbm_kernel.py
// pallas_traverse_hbm8_fat_cache (body _kernel8_hbm_fat_cache): each group
// of 128 rays shares one cursor and keeps one cache block of CBLK = 32 fat
// pairs (64 rows, 32 KB, the TPU's DMA size) and its tag; on a miss one DMA
// brings the whole block. The JAX wrapper pads the whole fat table to a
// block multiple on every call; this kernel copies the last block only up
// to the table's end and never copies the table.
//
// What bounds it on an H100: each step is a dependent read of a node row
// (the next cursor is known only after the lanes' tests), and a packet
// visits the union of its lanes' walks, which on scattered rays is many
// nodes that most lanes do not need. The first design (a block of 128 rays
// sharing a cursor, cp.async copies of 32-pair blocks) had four faults,
// and this design answers each (ptk::warp_packet_closest, ptk::TmaRing in
// bvh_common.cuh):
//   1. a packet of 128 lanes walked the union of 128 rays' walks: the
//      packet is one warp of 32 rays, and the cursor a __reduce_min_sync;
//   2. two __syncthreads() a step on a miss and a synchronous copy of the
//      whole block before any test: nothing wider than the warp
//      synchronises, one lane issues a TMA bulk copy that reports to an
//      mbarrier, and the copy of the next block (child indices and skip
//      links point forward, so the cursor only grows) overlaps the tests
//      of this one;
//   3. 32 pairs a copy, the TPU's DMA size: kPairs pairs a buffer, sized
//      for the card by measurement (PERF.md section 6), two buffers a warp;
//   4. one block per 128 rays: a persistent grid of the resident blocks
//      (counted with this dynamic shared memory), each warp taking 32
//      consecutive (Morton-ordered) rays from the ray counter at a time.
// A node row and its leaf block are a fat pair, so a leaf costs no second
// copy. Every lane reads the same row from shared memory, a broadcast, and
// only the fields a step uses. Each lane takes exactly the steps of its own
// preorder walk, so the results equal closest_hit_preorder.cu's in t,
// slot, u and v on every lane.
// On the card (PERF.md section 6) it beats closest_hit_preorder.cu on
// coherent camera rays, where one shared row serves most lanes, and stays
// about four times slower on scattered bounce rays: there a packet walks
// the union of 32 walks, moving under two lanes a step, and a step costs
// the warp's instructions however few lanes it moves.

#include "bvh_common.cuh"

namespace {

// fat pairs (2 rows, 1 KB) a ring buffer: the block a copy moves. Measured
// at 1, 2, 4, 8 and 16 pairs (PERF.md section 6): the copies' bytes set the
// time more than their number, so 2 (1 is 2% slower at the bunny's main
// width; 32 pairs, two 32 KB buffers a warp, do not fit a 128-thread block)
constexpr int kPairs = 2;
using Ring = ptk::TmaRing<2 * kPairs>;
constexpr int kWarpSmem = ptk::warp_smem(Ring::kBytes);
constexpr int kSmem = (ptk::kWalkThreads / 32) * kWarpSmem;

// The fat table through one ring: node j is rows 2j (its row) and 2j + 1
// (its leaf block), in one block since a block holds whole pairs.
struct FatRing {
  Ring ring;

  __device__ __forceinline__ void start(int j) { ring.start(2 * j); }
  __device__ __forceinline__ const float* node(int j) {
    return ring.row(2 * j);
  }
  __device__ __forceinline__ const float* leaf(const float* node, int) const {
    return node + ptk::kRow;
  }
  __device__ __forceinline__ void end_packet() { ring.end_packet(); }
  __device__ __forceinline__ void add_counts(unsigned long long* c) const {
    ptk::add_ring_counts(ring, c);
  }
};

template <int K>
__global__ void __launch_bounds__(ptk::kWalkThreads, ptk::kPreorderMinBlocks)
closest_hit_fat_cache_kernel(const float* __restrict__ fat, int n_fat_rows,
                             const float* __restrict__ org,
                             const float* __restrict__ dir,
                             const float* __restrict__ t_max, int n, int base,
                             int end, float* __restrict__ t_out,
                             int* __restrict__ slot_out,
                             float* __restrict__ u_out,
                             float* __restrict__ v_out,
                             int* __restrict__ next_ray,
                             unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* own = smem + (threadIdx.x / 32) * kWarpSmem;
  FatRing tab;
  tab.ring.init(fat, n_fat_rows, 2 * end,
                reinterpret_cast<float*>(own + 128),
                reinterpret_cast<unsigned long long*>(own));
  ptk::warp_packet_closest<K>(tab, org, dir, t_max, n, base, end, t_out,
                              slot_out, u_out, v_out, next_ray, counts);
}

template <int K>
int launch(const float* fat, int n_fat_rows, const float* org,
           const float* dir, const float* t_max, int n, int base, int end,
           float* t_out, int* slot_out, float* u_out, float* v_out,
           int* next_ray, unsigned long long* counts, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      closest_hit_fat_cache_kernel<K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int resident =
      ptk::resident_blocks(closest_hit_fat_cache_kernel<K>, kSmem);
  closest_hit_fat_cache_kernel<K>
      <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, kSmem, s>>>(
          fat, n_fat_rows, org, dir, t_max, n, base, end, t_out, slot_out,
          u_out, v_out, next_ray, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fat table starts on a 16-byte boundary (the wrapper checks it);
// next_ray as in pt_closest_hit; counts, if not null, (5,) as
// ptk::warp_packet_closest fills it. leaf_size is read from each leaf's count.
extern "C" int pt_closest_hit_fat_cache(const float* fat, int n_fat_rows,
                                        const float* org, const float* dir,
                                        const float* t_max, int n, int base,
                                        int end, int /*leaf_size*/, int k,
                                        float* t_out, int* slot_out,
                                        float* u_out, float* v_out,
                                        int* next_ray,
                                        unsigned long long* counts,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      return launch<4>(fat, n_fat_rows, org, dir, t_max, n, base, end, t_out,
                       slot_out, u_out, v_out, next_ray, counts, s);
    case 8:
      return launch<8>(fat, n_fat_rows, org, dir, t_max, n, base, end, t_out,
                       slot_out, u_out, v_out, next_ray, counts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Table rows a ring buffer holds (2 kPairs), dynamic shared memory a
// launch asks for and whether the ring prefetches, for the plain model of
// the schedule and the records.
extern "C" int pt_closest_hit_fat_cache_block_rows() { return 2 * kPairs; }
extern "C" int pt_closest_hit_fat_cache_smem() { return kSmem; }
extern "C" int pt_closest_hit_fat_cache_prefetch() { return 1; }
