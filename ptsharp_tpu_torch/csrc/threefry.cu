// Threefry-2x32 draws of core/rng.py on the card: one launch a draw.
//
// Replaces no TPU kernel: the JAX package draws with jax.random, whose
// threefry XLA compiles into the step. The port's plain draw (core/rng.py
// _threefry2x32 over tensors) runs the 20-round block as some 180
// separate int64 elementwise ops, each a launch that reads and writes
// the whole draw; here each thread runs the block on uint32 registers for
// a few words and stores each word once. The key words arrive by value
// (core/rng.py derives keys on the host in Python integers), so a draw
// copies nothing to the card and never waits for it.
//
// What bounds it on an H100: integer operations, 73 a word for the block
// (the counter's 2 adds of the key, 20 rounds of add, rotate and xor,
// five injections of 2 adds, the output xor; the key schedule and the
// injections' constants are a thread's, outside the loop over its words)
// and a few for the output's form, at the card's int32 rate; then 4 B a
// word written. The design:
//   - the counter of word i is the row-major flat index as (hi32(i),
//     lo32(i)), in 64 bits, as jax's partitionable threefry lays it out;
//   - native uint32 arithmetic, rotations by __funnelshift_l;
//   - a grid-stride loop over the words, a few a thread, so that
//     neighbouring threads store neighbouring words (coalesced); no
//     shared memory;
//   - launched on the caller's stream; it allocates nothing and does not
//     synchronise.
// Each entry returns cudaGetLastError().
//
// Entries (the wrappers are ptsharp_tpu_torch/kernels/threefry.py), the
// two draws the main path makes:
//   pt_threefry_uniform   float32 in [0, 1): bitcast((w >> 9) | 0x3F800000)
//                         - 1;
//   pt_threefry_randint   int32 in [minval, minval + span): jax's two-word
//                         modulus, from the two sub-keys' words and the
//                         multiplier (2^16 % span)^2 % span the host gives.
// Each equals its plain version in core/rng.py bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// a thread's words in a launch large enough to fill the card
constexpr int kWordsPerThread = 4;
// one wave of 256-thread blocks at 8 an SM on the H100's 132 SMs; larger
// draws take more words a thread
constexpr int64_t kMaxBlocks = 132 * 8;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The Threefry-2x32 block, 20 rounds, on counter (x0, x1) under key
// (k0, k1); returns the two output words xor-ed, as jax's random bits
// take them.
__device__ __forceinline__ uint32_t threefry(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define PT_MIX(r) \
  x0 += x1;       \
  x1 = rotl(x1, r) ^ x0;
#define PT_ROUNDS_A PT_MIX(13) PT_MIX(15) PT_MIX(26) PT_MIX(6)
#define PT_ROUNDS_B PT_MIX(17) PT_MIX(29) PT_MIX(16) PT_MIX(24)
  x0 += k0;
  x1 += k1;
  PT_ROUNDS_A
  x0 += k1;
  x1 += k2 + 1u;
  PT_ROUNDS_B
  x0 += k2;
  x1 += k0 + 2u;
  PT_ROUNDS_A
  x0 += k0;
  x1 += k1 + 3u;
  PT_ROUNDS_B
  x0 += k1;
  x1 += k2 + 4u;
  PT_ROUNDS_A
  x0 += k2;
  x1 += k0 + 5u;
#undef PT_ROUNDS_B
#undef PT_ROUNDS_A
#undef PT_MIX
  return x0 ^ x1;
}

__device__ __forceinline__ uint32_t word(uint32_t k0, uint32_t k1,
                                         int64_t i) {
  return threefry(k0, k1, static_cast<uint32_t>(i >> 32),
                  static_cast<uint32_t>(i));
}

__device__ __forceinline__ float to_uniform(uint32_t w) {
  return __uint_as_float((w >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ int64_t first_word() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

__global__ void __launch_bounds__(kThreads)
threefry_uniform(float* __restrict__ out, int64_t n, uint32_t k0,
                 uint32_t k1) {
  for (int64_t i = first_word(); i < n; i += grid_stride()) {
    out[i] = to_uniform(word(k0, k1, i));
  }
}

// higher and lower words under the two sub-keys (a0, a1) and (b0, b1);
// off = ((higher % span) * mult + lower % span) mod 2^32, then % span
__global__ void __launch_bounds__(kThreads)
threefry_randint(int32_t* __restrict__ out, int64_t n, uint32_t a0,
                 uint32_t a1, uint32_t b0, uint32_t b1, uint32_t span,
                 uint32_t mult, int64_t minval) {
  for (int64_t i = first_word(); i < n; i += grid_stride()) {
    const uint32_t higher = word(a0, a1, i);
    const uint32_t lower = word(b0, b1, i);
    const uint32_t off = ((higher % span) * mult + lower % span) % span;
    out[i] = static_cast<int32_t>(minval + static_cast<int64_t>(off));
  }
}

unsigned blocks_for(int64_t n) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kWordsPerThread;
  const int64_t want = (n + per_block - 1) / per_block;
  return static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

// Each entry launches nothing for n == 0 (the wrappers do not call it
// then) and returns cudaGetLastError().

extern "C" int pt_threefry_uniform(float* out, int64_t n, uint32_t k0,
                                   uint32_t k1, void* stream) {
  if (n > 0) {
    threefry_uniform<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(out, n, k0, k1);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_threefry_randint(int32_t* out, int64_t n, uint32_t a0,
                                   uint32_t a1, uint32_t b0, uint32_t b1,
                                   uint32_t span, uint32_t mult,
                                   int64_t minval, void* stream) {
  if (n > 0) {
    threefry_randint<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        out, n, a0, a1, b0, b1, span, mult, minval);
  }
  return static_cast<int>(cudaGetLastError());
}
