// Chunk fingerprint digest (and fused digest-and-compare) for Hopper, sm_90a.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/fingerprint.py:
//   * _fingerprint_cmp_kernel (launched by fingerprint_words_cmp): K1,
//     leaves_cmp_kernel, launched by leaves_cmp_launch
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
// K1, leaves_cmp_kernel: digest-and-compare that reads the leaves in place.
// The TPU kernel digests a packed (C, W) bucket matrix, since a BlockSpec
// tiles one dense array; on this card a block can read each chunk where it
// lies, so nothing is copied into a matrix or zeroed, and each byte of the
// state is read once.  A row table (kernels/fingerprint.py, RowTable)
// gives each digest row its leaf, its word offset in the leaf, its whole
// words and the valid bytes (1-3) of a last partial word; the leaves' base
// addresses are the only input per call.  The host groups rows of equal
// whole-word count whose first 16-byte boundary falls at the same word
// (`head`), so the rows of a group share the position of every vector and
// hence its weights.  Work items, one block each:
//   * Long rows (> 2048 words): kR rows x one segment of the body,
//     K2's loop: U = kU uint4 loads per row in flight, the 16 weights of a
//     vector computed once for all kR rows.  Segments add their partial
//     sums with atomicAdd into the zeroed output; the last segment of a
//     group to arrive (an arrival counter per group, zeroed in the same
//     memset, __threadfence() before the increment) reads the full digests
//     back and writes the dirty flags.
//   * Short rows (<= 2048 words, padded rows of 0 words included): up to
//     kShortRows rows of one group.  The block computes the weights
//     of every position once into shared memory, [lane][position], shifted
//     so that body vector v's four weights are one aligned 16-byte load;
//     the block stages its rows' descriptors in shared memory once, and
//     each warp then streams whole rows, two a pass (2 x kUS loads per
//     lane in flight),
//     reduces by shuffles and stores digest and dirty flag itself.
// Words before the first 16-byte boundary, after the last whole vector, and
// the last partial word (loaded byte by byte: the bytes after a leaf are
// not its own) are scalars.  A row whose payload slot is set (the
// speculated rows) also stores what it loads into the payload buffer at
// that word offset, which the host aligns so the vectors stay aligned: the
// fetched payload needs no gather.  One launch digests every bucket.

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


// ---------------------------------------------------------------------------
// K1: digest-and-compare over the leaves in place, through a row table.
// ---------------------------------------------------------------------------

constexpr int kR = 4;             // rows per long-row block
constexpr int kU = 4;             // uint4 loads per row and thread a step
constexpr int kUS = 4;            // uint4 loads per lane and row a pass
constexpr int kShortRows = 64;    // rows per short-row item, at most
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr int kItemInts = 8;      // see leaves_cmp_launch

__device__ __forceinline__ uint32_t fold(uint32_t len, int d, uint32_t seed) {
  return mix32(len ^ (static_cast<uint32_t>(d + 1) * kPhi)) + seed;
}

struct RowRef {
  const uint32_t* ptr;            // the row's first word
  uint32_t nfull;                 // whole words
  uint32_t part;                  // valid bytes of a last partial word, or 0
};

// rows: int32 (N, 4) = word offset (lo, hi), leaf index, nfull | part << 30.
__device__ __forceinline__ RowRef load_row(const uint64_t* __restrict__ bases,
                                           const int4* __restrict__ rows,
                                           int c) {
  const int4 e = __ldg(rows + c);
  const uint64_t off = static_cast<uint64_t>(static_cast<uint32_t>(e.x)) |
                       (static_cast<uint64_t>(static_cast<uint32_t>(e.y)) << 32);
  RowRef r;
  r.ptr = reinterpret_cast<const uint32_t*>(__ldg(
              reinterpret_cast<const unsigned long long*>(bases) + e.z)) +
          off;
  r.nfull = static_cast<uint32_t>(e.w) & 0x3FFFFFFFu;
  r.part = static_cast<uint32_t>(e.w) >> 30;
  return r;
}

// The first `valid` bytes of the word at p, little-endian, zero above.
__device__ __forceinline__ uint32_t load_partial(const uint32_t* p,
                                                 uint32_t valid) {
  const auto* b = reinterpret_cast<const uint8_t*>(p);
  uint32_t x = 0;
  for (uint32_t k = 0; k < valid; ++k)
    x |= static_cast<uint32_t>(__ldg(b + k)) << (8 * k);
  return x;
}

// The words of a row before its first 16-byte boundary (< 4).
__device__ __forceinline__ uint32_t head_of(const uint32_t* p, uint32_t nfull) {
  const uint32_t mis = static_cast<uint32_t>(
      (reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
  return min((4u - mis) & 3u, nfull);
}

__device__ __forceinline__ void store_dirty(int c, const uint32_t (&dig)[kLanes],
                                            const uint32_t* __restrict__ prev,
                                            uint32_t* __restrict__ dirty) {
  uint32_t any = 0;
#pragma unroll
  for (int d = 0; d < kLanes; ++d)
    any |= static_cast<uint32_t>(dig[d] != __ldg(prev + c * kLanes + d));
  dirty[c] = any;
}

__global__ void __launch_bounds__(kThreads, 2)
leaves_cmp_kernel(const uint64_t* __restrict__ bases,
                  const int4* __restrict__ rows,
                  const int* __restrict__ grows,
                  const int* __restrict__ items,
                  const uint32_t* __restrict__ lengths,
                  const uint32_t* __restrict__ prev,
                  const uint32_t* __restrict__ slots,
                  uint32_t* __restrict__ payload,
                  uint32_t* __restrict__ out, uint32_t* __restrict__ dirty,
                  uint32_t* __restrict__ arrivals, uint32_t seed) {
  extern __shared__ uint4 dyn[];
  __shared__ uint32_t part[kWarps][kR * kLanes];
  __shared__ uint32_t last;
  __shared__ const uint32_t* s_ptr[kShortRows];
  __shared__ int s_row[kShortRows];
  __shared__ uint32_t s_part[kShortRows];
  __shared__ uint32_t s_slot[kShortRows];

  const int* item = items + static_cast<int64_t>(blockIdx.x) * kItemInts;
  const int start = item[0];
  const int count = item[1];
  const int seg = item[2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (seg < 0) {
    // ---- short rows: weights of every position in shared memory ----------
    const uint32_t tl = static_cast<uint32_t>(item[6]);  // entries per lane
    uint32_t* tab = reinterpret_cast<uint32_t*>(dyn);
    // the block's row descriptors, loaded once, side by side
    if (static_cast<int>(threadIdx.x) < count) {
      const int c = grows[start + threadIdx.x];
      const RowRef r = load_row(bases, rows, c);
      s_ptr[threadIdx.x] = r.ptr;
      s_row[threadIdx.x] = c;
      s_part[threadIdx.x] = r.part;
      s_slot[threadIdx.x] = slots ? __ldg(slots + c) : kNone;
    }
    __syncthreads();
    const uint32_t nfull = load_row(bases, rows, s_row[0]).nfull;
    const uint32_t head = head_of(s_ptr[0], nfull);
    const uint32_t nvec = (nfull - head) >> 2;
    const uint32_t tail = head + 4u * nvec;
    // entry j of lane d holds w_d(j - 4 + head): body vector v's weights are
    // entries 4 + 4v .. 7 + 4v, 16-byte aligned since tl % 4 == 0.
    for (uint32_t j = threadIdx.x; j < kLanes * tl; j += kThreads) {
      const int d = static_cast<int>(j / tl);
      tab[j] = lane_weight(j % tl - 4u + head, d, seed);
    }
    __syncthreads();
    // a warp streams two rows a pass, k and k + kWarps: their loads first
    for (int k = warp; k < count; k += 2 * kWarps) {
      const int ks[2] = {k, k + kWarps < count ? k + kWarps : -1};
      uint32_t acc[2][kLanes] = {};
      for (uint32_t v0 = 0; v0 < nvec; v0 += 32u * kUS) {
        uint4 x[2][kUS];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint4* vec = reinterpret_cast<const uint4*>(
              s_ptr[ks[q] < 0 ? k : ks[q]] + head);
#pragma unroll
          for (int u = 0; u < kUS; ++u) {
            const uint32_t v = v0 + lane + 32u * u;
            x[q][u] = (ks[q] >= 0 && v < nvec) ? __ldg(vec + v)
                                               : make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int u = 0; u < kUS; ++u) {
          const uint32_t v = v0 + lane + 32u * u;
          if (v < nvec) {
#pragma unroll
            for (int d = 0; d < kLanes; ++d) {
              const uint4 w =
                  *reinterpret_cast<const uint4*>(tab + d * tl + 4u + 4u * v);
#pragma unroll
              for (int q = 0; q < 2; ++q)
                acc[q][d] += x[q][u].x * w.x + x[q][u].y * w.y +
                             x[q][u].z * w.z + x[q][u].w * w.w;
            }
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const uint32_t slot = ks[q] >= 0 ? s_slot[ks[q]] : kNone;
              if (slot != kNone)
                reinterpret_cast<uint4*>(payload + slot + head)[v] = x[q][u];
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (ks[q] < 0) continue;        // uniform across the warp
        const int kq = ks[q];
        const uint32_t* ptr = s_ptr[kq];
        const uint32_t rpart = s_part[kq];
        const uint32_t slot = s_slot[kq];
        // scalars: the head, the words after the last vector, a partial word
        const uint32_t n_sc = head + (nfull - tail) + (rpart ? 1u : 0u);
        if (static_cast<uint32_t>(lane) < n_sc) {
          const uint32_t p = static_cast<uint32_t>(lane) < head
                                 ? lane : tail + (lane - head);
          const uint32_t x = p < nfull ? __ldg(ptr + p)
                                       : load_partial(ptr + p, rpart);
#pragma unroll
          for (int d = 0; d < kLanes; ++d)
            acc[q][d] += x * tab[d * tl + p + 4u - head];
          if (slot != kNone) payload[slot + p] = x;
        }
#pragma unroll
        for (int d = 0; d < kLanes; ++d)
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[q][d] += __shfl_xor_sync(0xffffffffu, acc[q][d], off);
        if (lane == 0) {
          const int c = s_row[kq];
          const uint32_t len = __ldg(lengths + c);
#pragma unroll
          for (int d = 0; d < kLanes; ++d) {
            acc[q][d] += fold(len, d, seed);
            out[c * kLanes + d] = acc[q][d];
          }
          store_dirty(c, acc[q], prev, dirty);
        }
      }
    }
    return;
  }

  // ---- long rows: kR rows x one segment of the body ----------------------
  const int n_seg = item[3];
  const uint32_t seg_vecs = static_cast<uint32_t>(item[4]);
  int c[kR];
  RowRef row[kR];
  uint32_t slot[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    // rows past count repeat the group's first (valid memory), unwritten
    c[r] = grows[start + (r < count ? r : 0)];
    row[r] = load_row(bases, rows, c[r]);
    slot[r] = (slots && r < count) ? __ldg(slots + c[r]) : kNone;
  }
  const uint32_t nfull = row[0].nfull;
  const uint32_t head = head_of(row[0].ptr, nfull);
  const uint32_t nvec = (nfull - head) >> 2;
  const uint32_t tail = head + 4u * nvec;
  const uint64_t lo64 = static_cast<uint64_t>(seg) * seg_vecs;
  const uint32_t v_lo = static_cast<uint32_t>(lo64 < nvec ? lo64 : nvec);
  const uint32_t v_hi = static_cast<uint32_t>(
      lo64 + seg_vecs < nvec ? lo64 + seg_vecs : nvec);

  uint32_t acc[kR][kLanes];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int d = 0; d < kLanes; ++d) acc[r][d] = 0;
  const uint4* vec[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r)
    vec[r] = reinterpret_cast<const uint4*>(row[r].ptr + head);

  constexpr uint32_t kStep = static_cast<uint32_t>(kThreads) * kU;
  uint32_t v = v_lo + threadIdx.x;
  for (; v + (kU - 1) * kThreads < v_hi; v += kStep) {
    uint4 x[kU][kR];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int r = 0; r < kR; ++r) x[u][r] = __ldg(vec[r] + v + u * kThreads);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      add_vector<kR>(acc, x[u], head + 4u * (v + u * kThreads), seed);
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (slot[r] != kNone)
          reinterpret_cast<uint4*>(payload + slot[r] + head)[v + u * kThreads] =
              x[u][r];
    }
  }
  for (; v < v_hi; v += kThreads) {
    uint4 x[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) x[r] = __ldg(vec[r] + v);
    add_vector<kR>(acc, x, head + 4u * v, seed);
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (slot[r] != kNone)
        reinterpret_cast<uint4*>(payload + slot[r] + head)[v] = x[r];
  }
  if (seg == 0) {
    const uint32_t n_sc = head + (nfull - tail) + 1u;  // + a partial word
    for (uint32_t k = threadIdx.x; k < n_sc; k += kThreads) {
      const uint32_t p = k < head ? k : tail + (k - head);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (p == nfull && !row[r].part) continue;
        const uint32_t x = p < nfull ? __ldg(row[r].ptr + p)
                                     : load_partial(row[r].ptr + p, row[r].part);
#pragma unroll
        for (int d = 0; d < kLanes; ++d) acc[r][d] += x * lane_weight(p, d, seed);
        if (slot[r] != kNone) payload[slot[r] + p] = x;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int d = 0; d < kLanes; ++d)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][d] += __shfl_down_sync(0xffffffffu, acc[r][d], off);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int d = 0; d < kLanes; ++d) part[warp][r * kLanes + d] = acc[r][d];
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < count * kLanes) {
    const int r = t / kLanes;
    const int d = t % kLanes;
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][t];
    if (seg == 0) sum += fold(__ldg(lengths + c[r]), d, seed);
    if (n_seg > 1) {
      atomicAdd(out + c[r] * kLanes + d, sum);
    } else {
      out[c[r] * kLanes + d] = sum;
      part[0][t] = sum;  // every thread read part[*][t] above: its own slot
    }
  }
  if (n_seg == 1) {
    __syncthreads();
    if (t < count) {
      uint32_t dig[kLanes];
#pragma unroll
      for (int d = 0; d < kLanes; ++d) dig[d] = part[0][t * kLanes + d];
      store_dirty(c[t], dig, prev, dirty);
    }
    return;
  }
  // the last segment of the group to arrive compares the full digests
  __threadfence();
  __syncthreads();
  if (t == 0)
    last = atomicAdd(arrivals + item[5], 1u) == static_cast<uint32_t>(n_seg - 1);
  __syncthreads();
  if (last && t < count) {
    __threadfence();
    uint32_t dig[kLanes];
#pragma unroll
    for (int d = 0; d < kLanes; ++d) dig[d] = __ldcg(out + c[t] * kLanes + d);
    store_dirty(c[t], dig, prev, dirty);
  }
}

}  // namespace

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

// K1.  Digest and compare N rows read in place on `stream`; one launch.
//   bases:    uint64 (n_leaves,) the leaves' base addresses (4-byte aligned)
//   rows:     int32 (N, 4) the row table (see load_row)
//   grows:    int32 row indices in group order
//   items:    int32 (n_items, 8) one block each: first index into grows,
//             row count, segment (-1: a short-row item), segments of the
//             group, 16-byte vectors per segment, arrival counter, shared
//             weight entries per lane (short rows, a multiple of 4), 0
//   lengths:  uint32 (N,) the true byte lengths folded into the digests
//   prev:     uint32 (N, 4) the previous digests
//   slots:    uint32 (N,) payload word offsets, 0xFFFFFFFF for none; or null
//   payload:  uint32 words written at the rows' slots
//   ws:       uint32 (N * 5 + n_arrivals,) = out (N, 4), dirty (N,), the
//             arrival counters; zeroed here first when n_arrivals > 0
// smem_bytes is the short items' largest weight table.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int leaves_cmp_launch(const void* bases, const void* rows,
                                 const void* grows, const void* items,
                                 int64_t n_items, const void* lengths,
                                 const void* prev, const void* slots,
                                 void* payload, void* ws, int64_t N,
                                 int64_t n_arrivals, int64_t smem_bytes,
                                 uint32_t seed, void* stream) {
  if (n_items <= 0) return 0;
  if (n_items > 0x7FFFFFFFLL || N <= 0 || N > 0x1FFFFFFFLL ||
      n_arrivals < 0 || smem_bytes < 0 || smem_bytes > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        leaves_cmp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto* w = static_cast<uint32_t*>(ws);
  if (n_arrivals > 0) {
    const cudaError_t err = cudaMemsetAsync(
        w, 0, static_cast<size_t>(N * 5 + n_arrivals) * 4, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  leaves_cmp_kernel<<<static_cast<unsigned int>(n_items), kThreads,
                      static_cast<size_t>(smem_bytes), s>>>(
      static_cast<const uint64_t*>(bases), static_cast<const int4*>(rows),
      static_cast<const int*>(grows), static_cast<const int*>(items),
      static_cast<const uint32_t*>(lengths),
      static_cast<const uint32_t*>(prev), static_cast<const uint32_t*>(slots),
      static_cast<uint32_t*>(payload), w, w + N * kLanes, w + N * 5, seed);
  return static_cast<int>(cudaGetLastError());
}
