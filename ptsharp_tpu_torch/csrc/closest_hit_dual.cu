// Closest-hit over the fat table: the ordered walk of closest_hit.cu with
// two rays a lane, in persistent warps that refill their idle slots, so
// that each thread has two independent chains of row loads in flight.
//
// Replaces the TPU kernel ptsharp_tpu/pallas/ordered_kernel.py
// pallas_traverse_ordered8_fat_dual (body _kernel8_ord_fat_dual): two
// independent packets of the ordered walk interleaved in one program,
// each issuing the DMA of its next fat pair before its MT unroll, so that
// the other packet's whole phase runs in that copy's shadow. It pushes in
// the "near" order only, and its results are those of
// pallas_traverse_ordered8_fat (closest_hit.cu), which the JAX package
// calls in that order. Its `mt_gate` only skips MT passes no lane needs
// and changes no result, and its `max_iters` is closest_hit.cu's bound,
// so the port takes neither.
//
// What bounds it on an H100: each walk is a chain of dependent row loads
// (the meta fields, then the child fields or the leaf's triangles, then
// the next node). closest_hit.cu walks one ray a lane; here each lane
// holds two slots, each with its own ray, best hit, stack of entry
// distances (ptk::EntryStack) and step count, and a warp's 64 slots take
// rays from the ray counter and refill when fewer than kRefillBelow2 are
// live (ptk::persistent_walk2). A loop turn first issues both slots' loads
// (ptk::OrderedRow: both meta float4s, then the child fields of each slot
// at an internal node), so a thread waits for the slower of two loads
// instead of each in turn; then runs each slot's whole step in turn: at a
// leaf ptk::row_leaf, the test of its triangles (read there) and then the
// pop, which drops entries by the best t that the test has just set; at an
// internal node ptk::row_descend. The walk is not reordered, so each slot
// takes closest_hit.cu's steps and gets its t, slot, u and v on every
// lane. The price is about twice the registers and two stacks of local
// memory a thread, so fewer warps fit an SM (PERF.md section 6).

#include "bvh_common.cuh"

namespace {

// the warp refills its idle slots when fewer than this of its 64 are live
// (closest_hit.cu's 24 of 32, doubled; 40 and 56 measured the same on the
// H100, PERF.md section 6)
constexpr int kRefillBelow2 = 48;
// blocks an SM that the kernel's __launch_bounds__ ask for: 3 caps ptxas
// at 168 registers (K=8: 217 without a cap, 2 blocks an SM; the cap
// spills about 190 B), which measured 18% faster (PERF.md section 6)
constexpr int kDualMinBlocks = 3;

template <int K>
__global__ void __launch_bounds__(ptk::kWalkThreads, kDualMinBlocks)
closest_hit_dual_kernel(const float* __restrict__ fat,
                        const float* __restrict__ org,
                        const float* __restrict__ dir,
                        const float* __restrict__ t_max, int n, int base,
                        int end, float* __restrict__ t_out,
                        int* __restrict__ slot_out, float* __restrict__ u_out,
                        float* __restrict__ v_out, int* __restrict__ next_ray,
                        unsigned long long* __restrict__ counts) {
  ptk::Ray r[2];
  ptk::Best b[2];
  ptk::EntryStack<true> st[2];
  ptk::OrderedRow<K> row[2];
  const ptk::FatTable tab{fat};
  ptk::persistent_walk2<kRefillBelow2>(
      n, end, end - base + 2, next_ray, counts,
      [&](int s, int i) {
        r[s] = ptk::load_ray(org, dir, i);
        b[s] = ptk::Best{t_max[i], -1, 0.0f, 0.0f};
        st[s].sp = 0;
        return ptk::walk_start(tab, r[s], b[s].t, base, end);
      },
      [&](const bool (&run)[2], int (&cur)[2]) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (run[s]) row[s].load_meta(tab, cur[s]);
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (run[s] && row[s].cnt == 0) row[s].load_children();
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (!run[s]) continue;
          ptk::Best& bs = b[s];
          cur[s] = row[s].cnt > 0
                       ? ptk::row_leaf(tab, row[s], r[s], bs.t, st[s], end,
                                       [&](int slot, float tt, float uu,
                                           float vv) {
                                         if (tt < bs.t) {
                                           bs = ptk::Best{tt, slot, uu, vv};
                                         }
                                         return false;  // first slot wins
                                       })
                       : ptk::row_descend<K, ptk::Push::kNear>(
                             row[s], r[s], bs.t, st[s], end);
        }
      },
      [&](int s, int i) {
        t_out[i] = b[s].slot >= 0 ? b[s].t : ptk::kInf;
        slot_out[i] = b[s].slot;
        u_out[i] = b[s].u;
        v_out[i] = b[s].v;
      });
}

template <int K>
int launch(const float* fat, const float* org, const float* dir,
           const float* t_max, int n, int base, int end, float* t_out,
           int* slot_out, float* u_out, float* v_out, int* next_ray,
           unsigned long long* counts, cudaStream_t s) {
  static const int resident = ptk::resident_blocks(closest_hit_dual_kernel<K>);
  closest_hit_dual_kernel<K>
      <<<ptk::persistent_blocks(n, resident), ptk::kWalkThreads, 0, s>>>(
          fat, org, dir, t_max, n, base, end, t_out, slot_out, u_out, v_out,
          next_ray, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// next_ray as in pt_closest_hit; counts: null, or two unsigned 64-bit ints
// to which the kernel adds [steps, slots run] (64 slots a warp's loop
// turn).
extern "C" int pt_closest_hit_dual(const float* fat, const float* org,
                                   const float* dir, const float* t_max,
                                   int n, int base, int end, int k,
                                   float* t_out, int* slot_out, float* u_out,
                                   float* v_out, int* next_ray,
                                   unsigned long long* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4:
      return launch<4>(fat, org, dir, t_max, n, base, end, t_out, slot_out,
                       u_out, v_out, next_ray, counts, s);
    case 8:
      return launch<8>(fat, org, dir, t_max, n, base, end, t_out, slot_out,
                       u_out, v_out, next_ray, counts, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
