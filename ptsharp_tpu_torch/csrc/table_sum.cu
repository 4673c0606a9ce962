// Sums of per-lane rows by table row on the card: the scatter-add of the
// tape backward's cotangents into a parameter table, one launch a sum.
//
// Replaces no TPU kernel. The JAX package sums the tape's per-lane
// cotangents into the material tables with a one-hot matmul
// (ptsharp_tpu/tape.py _onehot_accum) and leaves the texture atlas's to
// XLA's transpose of the texel gather; neither is a Pallas kernel. The
// port summed both with PyTorch's index_add_, whose atomics to one
// address run in series: a wavefront of ~2 M lanes meets on 3 material
// rows and, through the atlas fetches of its untextured, dead and miss
// lanes (whose cotangent is zero), on a handful of texels.
//
// What bounds it on an H100: bytes. A lane's id and row are read once
// (8 + 4 W bytes at int64 ids), the (m, W) table written once: the tape's
// ~30 sums a train step at 1080p read ~1.3 GB, ~0.4 ms at 3.35 TB/s. The
// design keeps the atomics off that path:
//   - persistent blocks in a grid-stride loop, a warp over 32 neighbouring
//     lanes at a time;
//   - a lane whose row is all zeros (+0 or -0) adds nothing: adding a
//     zero changes no float sum, and most of the tape's lanes carry none
//     (a NaN is not a zero and is added);
//   - in each warp __match_any_sync groups the lanes of one id, shuffles
//     sum the group's rows into its lowest lane, and that lane alone adds;
//   - where the table fits in kSmemBudget bytes (the 3 x 5 material table
//     and the 4,096 x 3 texels of a 64x64 texture do) a block sums into a
//     private copy in shared memory, then adds each nonzero entry to
//     device memory once; a larger table takes the warps' sums straight
//     to device memory. The table's size, which the entry reads from its
//     arguments, picks the one or the other: one algorithm, not an option.
// The adds land in an order that changes from run to run, as
// index_add_'s do on the card, so the last bits of a sum may change.
//
// ids clamp into [0, m) as the tape's _row clamps them. Launched on the
// caller's stream; it allocates nothing and does not synchronise. The
// output must hold zeros (or a sum to add to). `counts`, if not null,
// three int64 the kernel adds its lanes, its active lanes (a nonzero
// entry) and its atomic adds to device memory (one a float) to.
//
// Entry (the wrapper is ptsharp_tpu_torch/kernels/table_sum.py):
//   pt_table_sum(ids, ids_are_int64, rows, n, w, m, out, counts, stream)
// It returns cudaGetLastError(); n == 0 launches nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the widest row the kernel takes (the tape's are 5, 4 and 3 floats)
constexpr int kMaxW = 8;
// a block's private table, at most: 48 KiB takes no opt-in and leaves
// 4 blocks an SM
constexpr int64_t kSmemBudget = 48 * 1024;
// rows a thread before the grid grows past one wave
constexpr int64_t kRowsPerThread = 4;
constexpr unsigned kAll = 0xffffffffu;

// Sums v[0, w) over the lanes of `peers` (this lane's group, itself
// included) into the group's lowest lane, in log2(group) shuffle steps;
// every lane of the warp calls it.
__device__ __forceinline__ void reduce_peers(unsigned peers,
                                             float (&v)[kMaxW], int w,
                                             int lane) {
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(kAll, above != 0u)) {
    const int next = __ffs(above);  // 1 + the next peer above, 0 if none
#pragma unroll
    for (int c = 0; c < kMaxW; ++c) {
      if (c < w) {
        const float t = __shfl_sync(kAll, v[c], (next - 1) & 31);
        if (next) v[c] += t;
      }
    }
    // a lane of odd rank has given its sum to the lane below it
    above &= ~__ballot_sync(kAll, rank & 1);
    rank >>= 1;
  }
}

template <typename Id, bool kShared>
__global__ void __launch_bounds__(kThreads)
table_sum_kernel(const Id* __restrict__ ids, const float* __restrict__ rows,
                 int64_t n, int w, int64_t m, float* __restrict__ out,
                 unsigned long long* __restrict__ counts) {
  extern __shared__ float table[];
  const int lane = threadIdx.x & 31;
  const int64_t cells = m * w;
  if (kShared) {
    for (int64_t j = threadIdx.x; j < cells; j += kThreads) table[j] = 0.0f;
    __syncthreads();
  }
  unsigned lanes = 0, active_lanes = 0, adds = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base =
           (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
           32;
       base < n; base += stride) {
    const int64_t i = base + lane;
    float v[kMaxW];
    bool active = false;
    int64_t id = 0;
    if (i < n) {
#pragma unroll
      for (int c = 0; c < kMaxW; ++c) {
        v[c] = c < w ? rows[i * w + c] : 0.0f;
        active |= v[c] != 0.0f;
      }
      const int64_t raw = static_cast<int64_t>(ids[i]);
      id = raw < 0 ? 0 : (raw >= m ? m - 1 : raw);
      ++lanes;
    } else {
#pragma unroll
      for (int c = 0; c < kMaxW; ++c) v[c] = 0.0f;
    }
    if (!__any_sync(kAll, active)) continue;
    active_lanes += active;
    // an inactive lane is a group of its own, under a key no id takes
    const unsigned long long key =
        active ? static_cast<unsigned long long>(id)
               : (1ull << 63) | static_cast<unsigned long long>(lane);
    const unsigned peers = __match_any_sync(kAll, key);
    reduce_peers(peers, v, w, lane);
    if (active && (peers & ((1u << lane) - 1u)) == 0u) {
#pragma unroll
      for (int c = 0; c < kMaxW; ++c) {
        if (c < w && v[c] != 0.0f) {
          if (kShared) {
            atomicAdd(&table[id * w + c], v[c]);
          } else {
            atomicAdd(&out[id * w + c], v[c]);
            ++adds;
          }
        }
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int64_t j = threadIdx.x; j < cells; j += kThreads) {
      const float s = table[j];
      if (s != 0.0f) {
        atomicAdd(&out[j], s);
        ++adds;
      }
    }
  }
  if (counts != nullptr) {
    lanes = __reduce_add_sync(kAll, lanes);
    active_lanes = __reduce_add_sync(kAll, active_lanes);
    adds = __reduce_add_sync(kAll, adds);
    if (lane == 0) {
      atomicAdd(&counts[0], static_cast<unsigned long long>(lanes));
      atomicAdd(&counts[1], static_cast<unsigned long long>(active_lanes));
      atomicAdd(&counts[2], static_cast<unsigned long long>(adds));
    }
  }
}

template <typename Id, bool kShared>
int launch(const void* ids, const float* rows, int64_t n, int w, int64_t m,
           float* out, unsigned long long* counts, cudaStream_t stream) {
  auto kernel = table_sum_kernel<Id, kShared>;
  const size_t smem =
      kShared ? static_cast<size_t>(m * w) * sizeof(float) : 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t per_block = kThreads * kRowsPerThread;
  const int64_t want = (n + per_block - 1) / per_block;
  const unsigned blocks = static_cast<unsigned>(want < wave ? want : wave);
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const Id*>(ids),
                                             rows, n, w, m, out, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pt_table_sum(const void* ids, int ids_are_int64,
                            const float* rows, int64_t n, int w, int64_t m,
                            float* out, unsigned long long* counts,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (w < 1 || w > kMaxW || m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const bool shared =
      m * w * static_cast<int64_t>(sizeof(float)) <= kSmemBudget;
  if (ids_are_int64) {
    return shared ? launch<int64_t, true>(ids, rows, n, w, m, out, counts, s)
                  : launch<int64_t, false>(ids, rows, n, w, m, out, counts, s);
  }
  return shared ? launch<int32_t, true>(ids, rows, n, w, m, out, counts, s)
                : launch<int32_t, false>(ids, rows, n, w, m, out, counts, s);
}
