// Chunk fingerprint digest (and fused digest-and-compare) for Hopper, sm_90a.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/fingerprint.py:
//   * _fingerprint_cmp_kernel (launched by fingerprint_words_cmp): kCompare = true
//   * _fingerprint_kernel     (launched by fingerprint_words):     kCompare = false
// The spec and the plain PyTorch versions are in src/repro_torch/kernels/ref.py:
//
//   digest[c,d] = sum_i words[c,i] * mix32(i*A_d + seed + d*SALT)
//                 + mix32(len_c ^ (d+1)*PHI) + seed                 (mod 2^32)
//   dirty[c]    = any_d digest[c,d] != prev[c,d]
//
// Design.  One block of 256 threads per chunk row (grid = C).  The TPU's
// sequential inner grid axis, which carried the (rows, 4) accumulator
// across word tiles, becomes a strided loop inside the block: thread t
// reads words t, t+256, ... (consecutive threads on consecutive words),
// recomputes the four weights of each position and keeps four uint32
// partial sums.  Warp shuffles, then shared memory across the 8 warps,
// reduce them.  Addition mod 2^32 is associative and commutative, so every
// reduction order gives the same bits: no atomics, zero tolerance.  Thread 0
// adds the length fold and the seed, writes the digest and, with kCompare,
// the dirty flag.  Padded rows (zero words, length 0) are digested like any
// other row.
//
// Bound on an H100 SXM.  The function needs one multiply-add per word and
// digest lane: 4 integer instructions per 4-byte word, 1 per byte read.
// The weights mix32(i*A_d + seed + d*SALT) depend only on the position i,
// so a (C, W) bucket needs W*4 of them (~9 instructions each), not C*W*4.
// At 33.5 T integer instructions/s (one per lane per clock on 132 x 128
// lanes at 1.98 GHz) that is a tenth of the time that 3.35 TB/s of HBM
// takes to stream the words: the digest is bound by bytes.  This simple
// design recomputes the four weights in every row (~40 instructions per
// word, near the lanes' issue limit at HBM rate), and reads 4 bytes per
// thread and load.  The ways to the HBM bound are later work: share the
// weights across rows (several rows per block, or a weight tile in shared
// memory), 16-byte vector loads, and splitting W across blocks for
// buckets with few rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 4;

constexpr uint32_t kA0 = 0x9E3779B1u;
constexpr uint32_t kA1 = 0x85EBCA77u;
constexpr uint32_t kA2 = 0xC2B2AE3Du;
constexpr uint32_t kA3 = 0x27D4EB2Fu;
constexpr uint32_t kPhi = 0x9E3779B9u;
constexpr uint32_t kSalt = 0x632BE59Bu;

__device__ __forceinline__ uint32_t mix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  return z;
}

template <bool kCompare>
__global__ void __launch_bounds__(kThreads)
fingerprint_kernel(const uint32_t* __restrict__ words, uint32_t W,
                   const uint32_t* __restrict__ lengths,
                   const uint32_t* __restrict__ prev,
                   uint32_t* __restrict__ out, uint32_t* __restrict__ dirty,
                   uint32_t seed) {
  const int64_t c = blockIdx.x;
  const uint32_t* __restrict__ row = words + c * static_cast<int64_t>(W);
  const uint32_t b0 = seed;
  const uint32_t b1 = seed + kSalt;
  const uint32_t b2 = seed + 2u * kSalt;
  const uint32_t b3 = seed + 3u * kSalt;

  uint32_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  for (uint32_t i = threadIdx.x; i < W; i += kThreads) {
    const uint32_t x = __ldg(row + i);
    s0 += x * mix32(i * kA0 + b0);
    s1 += x * mix32(i * kA1 + b1);
    s2 += x * mix32(i * kA2 + b2);
    s3 += x * mix32(i * kA3 + b3);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s0 += __shfl_down_sync(0xffffffffu, s0, off);
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
    s3 += __shfl_down_sync(0xffffffffu, s3, off);
  }

  __shared__ uint32_t part[kWarps][kLanes];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[warp][0] = s0;
    part[warp][1] = s1;
    part[warp][2] = s2;
    part[warp][3] = s3;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const uint32_t len = lengths[c];
    uint32_t any_diff = 0;
#pragma unroll
    for (int d = 0; d < kLanes; ++d) {
      uint32_t acc = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += part[w][d];
      acc += mix32(len ^ (static_cast<uint32_t>(d + 1) * kPhi)) + seed;
      out[c * kLanes + d] = acc;
      if (kCompare) any_diff |= static_cast<uint32_t>(acc != prev[c * kLanes + d]);
    }
    if (kCompare) dirty[c] = any_diff;
  }
}

}  // namespace

// Digest C rows of W uint32 words on `stream`.  words: (C, W); lengths: (C,);
// out: (C, 4).  With compare != 0 also reads prev (C, 4) and writes
// dirty (C,).  All pointers are device pointers to contiguous buffers.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fingerprint_launch(const void* words, int64_t C, int64_t W,
                                  const void* lengths, const void* prev,
                                  void* out, void* dirty, uint32_t seed,
                                  int compare, void* stream) {
  if (C <= 0) return 0;
  if (C > 0x7FFFFFFFLL || W < 0 || W > 0xFFFFFFFFLL - kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(C));
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t w32 = static_cast<uint32_t>(W);
  if (compare) {
    fingerprint_kernel<true><<<grid, block, 0, s>>>(
        static_cast<const uint32_t*>(words), w32,
        static_cast<const uint32_t*>(lengths),
        static_cast<const uint32_t*>(prev), static_cast<uint32_t*>(out),
        static_cast<uint32_t*>(dirty), seed);
  } else {
    fingerprint_kernel<false><<<grid, block, 0, s>>>(
        static_cast<const uint32_t*>(words), w32,
        static_cast<const uint32_t*>(lengths), nullptr,
        static_cast<uint32_t*>(out), nullptr, seed);
  }
  return static_cast<int>(cudaGetLastError());
}
