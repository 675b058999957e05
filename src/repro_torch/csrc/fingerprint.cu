// Chunk fingerprint digest (and fused digest-and-compare) for Hopper, sm_90a.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/fingerprint.py:
//   * _fingerprint_cmp_kernel (launched by fingerprint_words_cmp): K1,
//     fingerprint_kernel<true>, launched by fingerprint_cmp_launch
//   * _fingerprint_kernel     (launched by fingerprint_words):     K2,
//     digest_kernel<R>, launched by fingerprint_launch
// The spec and the plain PyTorch versions are in src/repro_torch/kernels/ref.py:
//
//   digest[c,d] = sum_i words[c,i] * w_d(i) + mix32(len_c ^ (d+1)*PHI) + seed
//   w_d(i)      = mix32(i*A_d + seed + d*SALT)                       (mod 2^32)
//   dirty[c]    = any_d digest[c,d] != prev[c,d]
//
// Addition mod 2^32 is associative and commutative, so any split of the sum
// and any combine order (shuffles, shared memory, atomics) gives the same
// bits: zero tolerance, no ordering.
//
// Bound on an H100 SXM.  The function needs one multiply-add per word and
// digest lane, 4 integer instructions per 4-byte word, plus the weights,
// ~9 instructions each, which depend only on the position i: W*4 of them
// per (C, W) launch, not C*W*4.  At 33.5 T integer instructions/s (one per
// lane per clock on 132 x 128 lanes at 1.98 GHz) that is a tenth of the
// time 3.35 TB/s of HBM takes to stream the words: the digest is bound by
// bytes.  A kernel that recomputes the four weights in every row spends ~40
// instructions per word, which at 0.84 T words/s (3.35 TB/s) is the lanes'
// whole issue rate: such a kernel sits on the ridge however well it is fed.
//
// K2, digest_kernel<R>.  Three things hold a one-block-per-row kernel far
// from that bound, and the design answers each:
//   * Split W.  The grid covers (row groups) x (W segments), both on
//     gridDim.x (gridDim.y/z stop at 65,535, and a bucket of small rows can
//     have more).  The wrapper (kernels/fingerprint.py, digest_plan) picks
//     the segment count so a launch with few rows still fills the card, and
//     never cuts a row into segments of less than one step (8-16 KiB).
//   * Weights shared across rows.  A block owns R rows (R in {1, 2, 4, 8},
//     a template parameter chosen from C), computes the four weights of each
//     position once and applies them to all R rows: ~36/R + 4 instructions
//     per word.  R > 1 needs every row at the same offset from a 16-byte
//     boundary, i.e. W % 4 == 0; rows of other widths run with R = 1.
//   * 16-byte loads, several in flight.  Consecutive threads read
//     consecutive uint4 vectors through the read-only path; a step issues
//     U loads per row per thread (U = 4 for R <= 4, U = 2 for R = 8, so 4
//     to 16 loads and 64-256 bytes in flight per thread) before using any.
//   A row may start anywhere 4-byte aligned: a view of a leaf's own storage
//   (a slice t[1:] has data_ptr() % 16 == 4), or row c > 0 of a width with
//   W % 4 != 0.  So each row is a scalar head up to its first 16-byte
//   boundary (< 4 words), a vector body, and a scalar tail (< 4 words); the
//   head and the tail go to segment 0, and every word keeps its true
//   position i for its weight.  Segment s owns body vectors
//   [s*seg_vecs, (s+1)*seg_vecs).  Each block reduces its 4*R sums by warp
//   shuffles and shared memory.  With one segment it stores the digest;
//   with more, out is zeroed on the stream first (cudaMemsetAsync, so two
//   device operations per call) and every segment adds its partial with
//   atomicAdd, which wraps mod 2^32.  Segment 0 adds the length fold and
//   the seed.
//
// K1, fingerprint_kernel<true>, keeps the simple one-block-per-row design
// (grid = C, a strided loop of 4-byte loads, the weights recomputed in
// every row): at the main path's buckets, whose (2048, 2^20) matrix keeps
// ~1056 blocks resident, it runs at 56% of its byte bound on an H100
// (PERF.md), and is left as it is until it reads the leaves in place.  Its
// template's kCompare = false form is not instantiated.

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

// ---------------------------------------------------------------------------
// K2: the digest alone, split-W, R rows per block, 16-byte loads.
// ---------------------------------------------------------------------------

// The odd multiplier A_d of digest lane d (d is a constant once unrolled).
__device__ __forceinline__ uint32_t lane_prime(int d) {
  return d == 0 ? kA0 : d == 1 ? kA1 : d == 2 ? kA2 : kA3;
}

// w_d(i), the weight of position i in digest lane d.
__device__ __forceinline__ uint32_t lane_weight(uint32_t i, int d,
                                                uint32_t seed) {
  return mix32(i * lane_prime(d) + seed + static_cast<uint32_t>(d) * kSalt);
}

// acc[r][d] += sum_k x[r][k] * w_d(p + k) for the 4 words of one vector per
// row, at positions p..p+3; the 16 weights are computed once for all R rows.
template <int R>
__device__ __forceinline__ void add_vector(uint32_t (&acc)[R][kLanes],
                                           const uint4 (&x)[R], uint32_t p,
                                           uint32_t seed) {
#pragma unroll
  for (int d = 0; d < kLanes; ++d) {
    const uint32_t a = lane_prime(d);
    const uint32_t z = p * a + seed + static_cast<uint32_t>(d) * kSalt;
    const uint32_t w0 = mix32(z);
    const uint32_t w1 = mix32(z + a);
    const uint32_t w2 = mix32(z + 2u * a);
    const uint32_t w3 = mix32(z + 3u * a);
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r][d] += x[r].x * w0 + x[r].y * w1 + x[r].z * w2 + x[r].w * w3;
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
digest_kernel(const uint32_t* __restrict__ words, int64_t C, uint32_t W,
              const uint32_t* __restrict__ lengths,
              uint32_t* __restrict__ out, uint32_t n_seg, uint32_t seg_vecs,
              uint32_t seed) {
  constexpr int U = R <= 4 ? 4 : 2;  // uint4 loads per row and thread a step
  constexpr uint32_t kStep = static_cast<uint32_t>(kThreads) * U;

  const uint32_t s = blockIdx.x % n_seg;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x / n_seg) * R;
  // Rows past C repeat row C-1 (valid memory); their sums are not written.
  const uint32_t* row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t c = c0 + r < C ? c0 + r : C - 1;
    row[r] = words + c * static_cast<int64_t>(W);
  }
  // Words of the row before its first 16-byte boundary: the same for all R
  // rows, since R > 1 only when W % 4 == 0.
  const uint32_t mis = static_cast<uint32_t>(
      (reinterpret_cast<uintptr_t>(row[0]) >> 2) & 3u);
  const uint32_t head = min((4u - mis) & 3u, W);
  const uint32_t nvec = (W - head) >> 2;
  const uint32_t tail = head + 4u * nvec;
  const uint64_t lo64 = static_cast<uint64_t>(s) * seg_vecs;
  const uint32_t v_lo = static_cast<uint32_t>(lo64 < nvec ? lo64 : nvec);
  const uint32_t v_hi = static_cast<uint32_t>(
      lo64 + seg_vecs < nvec ? lo64 + seg_vecs : nvec);

  uint32_t acc[R][kLanes];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < kLanes; ++d) acc[r][d] = 0;

  const uint4* vec[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    vec[r] = reinterpret_cast<const uint4*>(row[r] + head);

  uint32_t v = v_lo + threadIdx.x;
  // Full steps: all U vectors of this thread lie in the segment, so the
  // U*R loads go out before any is used.
  for (; v + (U - 1) * kThreads < v_hi; v += kStep) {
    uint4 x[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) x[u][r] = __ldg(vec[r] + v + u * kThreads);
#pragma unroll
    for (int u = 0; u < U; ++u)
      add_vector<R>(acc, x[u], head + 4u * (v + u * kThreads), seed);
  }
  for (; v < v_hi; v += kThreads) {
    uint4 x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = __ldg(vec[r] + v);
    add_vector<R>(acc, x, head + 4u * v, seed);
  }
  // Segment 0 also digests the scalar head [0, head) and tail [tail, W).
  if (s == 0) {
    for (uint32_t k = threadIdx.x; k < head + (W - tail); k += kThreads) {
      const uint32_t i = k < head ? k : tail + (k - head);
#pragma unroll
      for (int d = 0; d < kLanes; ++d) {
        const uint32_t w = lane_weight(i, d, seed);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][d] += __ldg(row[r] + i) * w;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < kLanes; ++d)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][d] += __shfl_down_sync(0xffffffffu, acc[r][d], off);

  __shared__ uint32_t part[kWarps][R * kLanes];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < kLanes; ++d) part[warp][r * kLanes + d] = acc[r][d];
  }
  __syncthreads();

  if (threadIdx.x < R * kLanes) {
    const int64_t c = c0 + threadIdx.x / kLanes;
    const uint32_t d = threadIdx.x % kLanes;
    if (c < C) {
      uint32_t sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += part[w][threadIdx.x];
      if (s == 0) sum += mix32(lengths[c] ^ ((d + 1u) * kPhi)) + seed;
      if (n_seg > 1)
        atomicAdd(out + c * kLanes + d, sum);
      else
        out[c * kLanes + d] = sum;
    }
  }
}

template <int R>
void launch_digest(const uint32_t* words, int64_t C, uint32_t W,
                   const uint32_t* lengths, uint32_t* out, uint32_t n_seg,
                   uint32_t seg_vecs, uint32_t seed, unsigned int blocks,
                   cudaStream_t s) {
  digest_kernel<R><<<blocks, kThreads, 0, s>>>(words, C, W, lengths, out,
                                               n_seg, seg_vecs, seed);
}

}  // namespace

// K1.  Digest C rows of W uint32 words and compare with prev on `stream`.
// words: (C, W); lengths: (C,); prev, out: (C, 4); dirty: (C,).  All are
// device pointers to contiguous buffers.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int fingerprint_cmp_launch(const void* words, int64_t C, int64_t W,
                                      const void* lengths, const void* prev,
                                      void* out, void* dirty, uint32_t seed,
                                      void* stream) {
  if (C <= 0) return 0;
  if (C > 0x7FFFFFFFLL || W < 0 || W > 0xFFFFFFFFLL - kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  fingerprint_kernel<true><<<static_cast<unsigned int>(C), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t>(W),
      static_cast<const uint32_t*>(lengths),
      static_cast<const uint32_t*>(prev), static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(dirty), seed);
  return static_cast<int>(cudaGetLastError());
}

// K2.  Digest C rows of W uint32 words on `stream` into out (C, 4).
// words (4-byte aligned, any offset from 16 bytes): (C, W); lengths: (C,).
// rows_per_block R in {1, 2, 4, 8} (R > 1 needs W % 4 == 0); the body of a
// row is cut into n_seg segments of seg_vecs 16-byte vectors, which must
// cover floor(W / 4) vectors; the grid is ceil(C / R) * n_seg blocks.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments outside these limits.
extern "C" int fingerprint_launch(const void* words, int64_t C, int64_t W,
                                  const void* lengths, void* out,
                                  uint32_t seed, int rows_per_block,
                                  int64_t n_seg, int64_t seg_vecs,
                                  void* stream) {
  if (C <= 0) return 0;
  const int R = rows_per_block;
  if (C > 0x7FFFFFFFLL || W < 0 || W > 0xFFFFFFFFLL - kThreads ||
      !(R == 1 || R == 2 || R == 4 || R == 8) || (R > 1 && W % 4 != 0) ||
      reinterpret_cast<uintptr_t>(words) % 4 != 0 || n_seg < 1 ||
      n_seg > 0x7FFFFFFFLL || seg_vecs < 1 || seg_vecs > 0x7FFFFFFFLL ||
      n_seg * seg_vecs < W / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (C + R - 1) / R * n_seg;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_seg > 1) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, static_cast<size_t>(C) * kLanes * 4, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* len = static_cast<const uint32_t*>(lengths);
  auto* o = static_cast<uint32_t*>(out);
  const auto w32 = static_cast<uint32_t>(W);
  const auto ns = static_cast<uint32_t>(n_seg);
  const auto sv = static_cast<uint32_t>(seg_vecs);
  const auto nb = static_cast<unsigned int>(blocks);
  switch (R) {
    case 1: launch_digest<1>(w, C, w32, len, o, ns, sv, seed, nb, s); break;
    case 2: launch_digest<2>(w, C, w32, len, o, ns, sv, seed, nb, s); break;
    case 4: launch_digest<4>(w, C, w32, len, o, ns, sv, seed, nb, s); break;
    default: launch_digest<8>(w, C, w32, len, o, ns, sv, seed, nb, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
