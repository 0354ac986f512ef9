// Huffman decode of baseline restart segments, hand-written for Hopper
// (sm_90a), bound to PyTorch through plain C entry points and ctypes.
//
// Replaces the TPU kernel jpeg_decoder_tpu/ops/entropy_pallas.py:
// decode_segments_pallas (body _segment_body / _decode_block / _peek16 /
// _lut_at).  It computes the same function: for every restart segment s,
// decode min(nm[s], rows / bpm) MCUs of bpm blocks each from the segment's
// big-endian 32-bit words, with the 16-bit LUT probe (entry = (symbol << 5)
// | code length, 0 = invalid), DC predictors per component reset at the
// segment start, EOB / ZRL run lengths, and the error conditions of the
// Pallas kernel, with T.81's size categories for the frame's precision
// (max_dc, max_ac = 11, 10 for 8-bit frames and 15, 14 for 12-bit ones, as
// the JAX package's lockstep lanes have them; the Pallas kernel itself
// flags 12-bit categories):
//   DC: entry == 0, size > max_dc
//   AC: entry == 0, i+run > 64, (size > 0 and i+run >= 64), size > max_ac.
// Each coefficient is written at its natural index ZIGZAG[i] into the
// caller's zero-filled output.  A segment is flagged when its sequential
// decode meets an error before its last block; the rows of a flagged
// segment are unspecified (the wrapper raises on any flag).
//
// What bounds it: latency, not bytes.  A decode is a chain of dependent
// probes (where the next code starts depends on this one's length), and
// the bytes it moves would take microseconds at HBM rate.  So the design
// buys parallelism inside every segment, as in Weissenberger & Schmidt,
// "Massively Parallel Huffman Decoding on GPUs" (ICPP 2018) and its JPEG
// form (arXiv:2111.09219): Huffman codes self-synchronise, so a decoder
// started at an arbitrary bit soon follows the true symbol boundaries.
//
//  0. Tables (build_l1_kernel, once per table set; the wrapper caches the
//     result per device): a 4,096-entry int16 first level per table, entry
//     i = lut[i << 4] when that code is <= 12 bits long, else 0.  Each CTA
//     of the decode kernels copies them into shared memory with 16-byte
//     cp.async vectors; a miss probes the full int32 table in device memory.
//  1. Sync (seg_chunks_kernel, sync_kernel, seal_kernel).  Every segment's
//     bits, up to its last non-zero word, are cut into chunks of C bits;
//     chunk c of segment s is thread s * cps + c, and kSyncLanes of them form
//     a CTA.  A state is (bit, k = block in the MCU, i = coefficient index);
//     a chunk's entry is the state at its first symbol boundary at or past
//     its first bit, its exit the same for the next chunk.  Every chunk but
//     a segment's last decodes from an assumed entry (its first bit, k = 0,
//     i = 0; chunk 0's is the true one) to its exit, counting the DC symbols
//     (blocks begun) and summing the DC differences per component.  An
//     invalid code met on this speculative path flags nothing: the lane
//     re-aligns to the next byte boundary as an MCU start and goes on.
//     Then each chunk takes its predecessor's exit (shared memory) as its
//     entry and decodes again where that changed, until no entry in the CTA
//     changes; a decode started at a true state follows the true path, and
//     a wrong one soon merges into it, so this converges in a few rounds.
//     Across CTAs, a launch re-runs each CTA whose first chunk's entry is no
//     longer its predecessor's exit.  Last, one thread per segment walks the
//     CTA boundaries in order and re-decodes, chunk after chunk, wherever an
//     entry still differs.  The entries are then a fixed point of "entry =
//     predecessor's exit" with chunk 0's true, so each is the sequential
//     decode's state at that point.  At worst (no chunk ever synchronises,
//     e.g. a corrupt stream) this is the sequential decode, one chunk at a
//     time: it always ends, and exact.
//  2. Offsets (offsets_kernel, one CTA per segment): exclusive prefix sums
//     of the blocks begun and of the DC sums (wrapping int32, as the
//     sequential sum does) give each chunk its first block and DC carry-in.
//  3. Write (write_kernel): each chunk decodes once more from its true
//     entry to its exit (a segment's last chunk until its MCUs are done),
//     storing DC (carry-in plus running sum) and each non-zero AC term.  An
//     error met here lies on the true path; before the segment's last block
//     it flags the segment.
// Kept from the one-lane-per-segment form: a 64-bit bit buffer with guarded
// shifts, every word read bounds-checked (zeros past the end), int64 bit
// positions.  New: the next word is prefetched one refill ahead, and the
// decode is one flat loop of symbols (no nested MCU/block loops), so the
// lanes of a warp stay in step.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kL1Bits = 12;                 // first-level table index bits
constexpr int kL1Size = 1 << kL1Bits;
constexpr int kMaxTables = 8;               // 2 * at most 4 components
constexpr int kSyncLanes = 64;              // chunks per CTA, sync and write
constexpr int kSegThreads = 128;            // per-segment kernels
constexpr int kScanThreads = 512;           // offsets: most per segment
constexpr int kStats = 5;
constexpr unsigned kFull = 0xffffffffu;

__device__ const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Everything the kernels share, passed by value.
struct Params {
  const uint32_t* words;      // (n_seg, n_words)
  const int32_t* seg_nmcus;   // (n_seg,)
  const int32_t* luts;        // (n_tables, 65536)
  const int16_t* l1;          // (n_tables, kL1Size)
  int32_t* out;               // (n_seg, rows, 64), zero-filled
  int32_t* err;               // (n_seg,)
  uint64_t* entry;            // (n_chunk,) state words
  uint64_t* exit;             // (n_chunk,)
  int32_t* cnt;               // (n_chunk,) blocks begun, then first block
  int32_t* dcs;               // (4, n_chunk) DC sums, then DC carry-in
  int32_t* n_chunks;          // (n_seg,)
  int32_t* stats;             // (kStats,)
  int64_t n_seg, n_words, rows, chunk_bits, cps, n_chunk;
  uint64_t comp_code;         // component of block k in bits 4k..4k+3
  int n_tables, bpm;
  int max_dc, max_ac;         // size categories: 11, 10 or (12-bit) 15, 14
};

// Stats slots (read by the wrapper's caller, for reports).
enum : int {
  kRound0Iters = 0,   // max iterations of a CTA in the first sync launch
  kGlobalCtas = 1,    // CTAs re-run by the cross-CTA launches
  kGlobalIters = 2,   // max iterations of such a CTA
  kSealDecodes = 3,   // chunks re-decoded by the serial seal
  kSyncDecodes = 4,   // chunk decodes of the sync launches in all
};

// State word: bit position << 10 | k << 6 | i  (k < 16, i < 64).
__device__ __forceinline__ uint64_t pack(int64_t pos, int k, int i) {
  return (static_cast<uint64_t>(pos) << 10) |
         (static_cast<uint64_t>(k) << 6) | static_cast<uint64_t>(i);
}

// MSB-first reader over one segment's words.  Invariant after refill():
// 33 <= nbits <= 64 valid bits, left-aligned in buf, zeros below them; pf
// holds word `next`, loaded one refill ahead.  Words outside [0, n_words)
// read as zero (never out of bounds).
struct BitReader {
  const uint32_t* words;
  int64_t n_words;
  int64_t next;
  uint64_t buf;
  int nbits;
  uint32_t pf;

  __device__ __forceinline__ uint32_t word(int64_t w) const {
    return (w >= 0 && w < n_words) ? __ldg(words + w) : 0u;
  }
  __device__ __forceinline__ void seek(int64_t pos) {
    const int64_t w = pos >> 5;
    const int off = static_cast<int>(pos & 31);
    // off in [0, 31]: the shift is defined.
    buf = ((static_cast<uint64_t>(word(w)) << 32) | word(w + 1)) << off;
    nbits = 64 - off;
    next = w + 2;
    pf = word(next);
  }
  __device__ __forceinline__ void refill() {
    if (nbits <= 32) {   // shift in [0, 32]: defined for a 64-bit value
      buf |= static_cast<uint64_t>(pf) << (32 - nbits);
      nbits += 32;
      pf = word(++next);
    }
  }
  __device__ __forceinline__ uint32_t peek16() const {
    return static_cast<uint32_t>(buf >> 48);
  }
  // n <= 31 at every call site (code <= 16 bits, then value <= 15 bits of
  // a 12-bit frame), within the 33 bits refill() leaves.
  __device__ __forceinline__ void skip(int n) {
    buf <<= n;
    nbits -= n;
  }
  // The next n bits as an unsigned value; n == 0 reads nothing (a shift by
  // 64 would be undefined).
  __device__ __forceinline__ int32_t bits(int n) {
    if (n == 0) return 0;
    const int32_t v = static_cast<int32_t>(buf >> (64 - n));
    skip(n);
    return v;
  }
};

__device__ __forceinline__ int32_t extend(int32_t v, int size) {
  return (size > 0 && v < (1 << (size - 1))) ? v - ((1 << size) - 1) : v;
}

// LUT entry for table t at the 16-bit window p: first level (shared memory
// in the decode kernels, device memory in the seal), full table in device
// memory on a miss (long code or invalid window).
__device__ __forceinline__ int32_t probe(const int16_t* l1,
                                         const int32_t* __restrict__ luts,
                                         int t, uint32_t p) {
  const int32_t e = l1[t * kL1Size + (p >> (16 - kL1Bits))];
  return e != 0 ? e : __ldg(luts + static_cast<int64_t>(t) * 65536 + p);
}

// One decoded symbol.
struct Sym {
  int ci;        // component
  bool dc;       // a DC difference (a block begins)
  int at;        // natural index of a non-zero AC value, else -1
  int32_t val;   // DC difference or AC value
};

// Decode the symbol at (pos, k, i).  On success advance the reader, pos,
// k and i and return true; on an error (the Pallas kernel's conditions)
// return false and change nothing.
__device__ __forceinline__ bool step(BitReader& br, const int16_t* l1,
                                     const Params& p, int64_t& pos, int& k,
                                     int& i, Sym& s) {
  br.refill();
  const int ci = static_cast<int>((p.comp_code >> (4 * k)) & 0xF);
  const bool dc = i == 0;
  const int32_t e = probe(l1, p.luts, 2 * ci + (dc ? 0 : 1), br.peek16());
  // An entry is 0 or has a code length of 1..16 (huffman.build_lut); a
  // zero length is refused too, so that every step moves the position on.
  const int len = e & 31;
  if (len == 0) return false;
  const int sym = e >> 5;
  int size, i2, at = -1;
  if (dc) {
    if (sym > p.max_dc) return false;
    size = sym;
    i2 = 1;
  } else if (sym == 0) {                       // EOB
    size = 0;
    i2 = 64;
  } else {
    const int run = sym == 0xF0 ? 16 : sym >> 4;
    const int csize = sym & 0x0F;
    const int i_new = i + run;
    if (i_new > 64 || (csize > 0 && i_new >= 64) || csize > p.max_ac)
      return false;
    size = csize;
    if (csize > 0) {
      at = kZigzag[i_new];
      i2 = i_new + 1;
    } else {
      i2 = i_new;                              // ZRL
    }
  }
  br.skip(len);
  s.val = extend(br.bits(size), size);
  s.ci = ci;
  s.dc = dc;
  s.at = at;
  pos += len + size;
  if (i2 >= 64) {
    i = 0;
    k = k + 1 == p.bpm ? 0 : k + 1;
  } else {
    i = i2;
  }
  return true;
}

struct SyncOut {
  uint64_t exit;
  int32_t cnt;
  uint32_t d0, d1, d2, d3;
};

// Phase 1 for one chunk: decode from `entry` to the first symbol boundary
// at or past `end`, speculatively (an error re-aligns to the next byte
// boundary as an MCU start).
__device__ __forceinline__ SyncOut sync_chunk(const Params& p,
                                              const int16_t* l1, int64_t seg,
                                              uint64_t entry, int64_t end) {
  int64_t pos = static_cast<int64_t>(entry >> 10);
  int k = static_cast<int>((entry >> 6) & 15);
  int i = static_cast<int>(entry & 63);
  BitReader br{p.words + seg * p.n_words, p.n_words, 0, 0, 0, 0};
  br.seek(pos);
  SyncOut o{0, 0, 0u, 0u, 0u, 0u};
  while (pos < end) {
    Sym s;
    if (!step(br, l1, p, pos, k, i, s)) {
      pos = (pos | 7) + 1;
      k = 0;
      i = 0;
      br.seek(pos);
      continue;
    }
    if (s.dc) {
      const uint32_t v = static_cast<uint32_t>(s.val);
      ++o.cnt;
      o.d0 += s.ci == 0 ? v : 0u;
      o.d1 += s.ci == 1 ? v : 0u;
      o.d2 += s.ci == 2 ? v : 0u;
      o.d3 += s.ci == 3 ? v : 0u;
    }
  }
  o.exit = pack(pos, k, i);
  return o;
}

__device__ __forceinline__ void store_chunk(const Params& p, int64_t g,
                                            uint64_t entry,
                                            const SyncOut& o) {
  p.entry[g] = entry;
  p.exit[g] = o.exit;
  p.cnt[g] = o.cnt;
  p.dcs[g] = static_cast<int32_t>(o.d0);
  p.dcs[p.n_chunk + g] = static_cast<int32_t>(o.d1);
  p.dcs[2 * p.n_chunk + g] = static_cast<int32_t>(o.d2);
  p.dcs[3 * p.n_chunk + g] = static_cast<int32_t>(o.d3);
}

// Copy the first-level tables into shared memory as 16-byte vectors.
__device__ __forceinline__ void stage_tables(int16_t* dst, const int16_t* src,
                                             int n_tables) {
  const int n_vec = n_tables * kL1Size * 2 / 16;
  for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
    const unsigned saddr =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + v * 8));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
                 "l"(src + v * 8));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

__global__ void build_l1_kernel(const int32_t* __restrict__ luts,
                                int16_t* __restrict__ l1, int n_tables) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_tables * kL1Size) return;
  const int32_t e = luts[static_cast<int64_t>(i >> kL1Bits) * 65536 +
                         ((i & (kL1Size - 1)) << (16 - kL1Bits))];
  const int len = e & 31;
  // (symbol << 5) | length <= 8191 fits an int16.
  l1[i] = (len > 0 && len <= kL1Bits) ? static_cast<int16_t>(e) : 0;
}

// One warp per segment: chunks up to the last non-zero word; also clears
// the segment's flag and (threads 0 .. kStats-1) the stats.
__global__ void __launch_bounds__(kSegThreads) seg_chunks_kernel(Params p) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t < kStats) p.stats[t] = 0;
  const int lane = threadIdx.x & 31;
  const int64_t seg = t >> 5;
  if (seg >= p.n_seg) return;
  if (lane == 0) p.err[seg] = 0;
  const uint32_t* w = p.words + seg * p.n_words;
  int64_t last = -1;
  for (int64_t top = p.n_words - 1; top >= 0; top -= 32) {
    const int64_t idx = top - lane;
    const bool nz = idx >= 0 && __ldg(w + idx) != 0u;
    const unsigned m = __ballot_sync(kFull, nz);
    if (m != 0u) {
      last = top - (__ffs(m) - 1);   // lowest lane = highest word
      break;
    }
  }
  const int64_t nw = last + 1 < 1 ? 1 : last + 1;
  if (lane == 0)
    p.n_chunks[seg] =
        static_cast<int32_t>((nw * 32 + p.chunk_bits - 1) / p.chunk_bits);
}

// Phase 1 on one CTA of kSyncLanes chunks.  first_round: every chunk
// decodes from its assumed entry.  Otherwise only a CTA whose first chunk's
// entry is no longer its predecessor's exit (in the previous CTA) re-runs.
// Then chunks take their predecessors' exits until nothing changes.
__global__ void __launch_bounds__(kSyncLanes)
    sync_kernel(Params p, int first_round) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* s_l1 = reinterpret_cast<int16_t*>(smem);
  uint64_t* s_exit = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(p.n_tables) * kL1Size * sizeof(int16_t));
  const int tid = threadIdx.x;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kSyncLanes + tid;
  const int64_t seg = g / p.cps, c = g % p.cps;
  const int64_t n = seg < p.n_seg ? p.n_chunks[seg] : 0;
  const bool active = c < n - 1;          // a segment's last chunk: no exit
  const bool has_prev = active && c > 0;
  uint64_t entry = 0;
  bool changed;
  if (first_round) {
    entry = pack(c * p.chunk_bits, 0, 0);  // chunk 0: the true entry
    changed = active;
  } else {
    changed = false;
    if (active) {
      entry = p.entry[g];
      s_exit[tid] = p.exit[g];
    }
    if (tid == 0 && has_prev) {
      // Written by the previous CTA, possibly in this launch: a stale value
      // only delays convergence (the seal completes it).
      const uint64_t x = __ldcg(reinterpret_cast<const unsigned long long*>(
          p.exit + g - 1));
      if (x != entry) {
        entry = x;
        changed = true;
      }
    }
  }
  if (!__syncthreads_or(changed)) return;   // the whole CTA leaves at once
  stage_tables(s_l1, p.l1, p.n_tables);
  int iters = 0, decodes = 0;
  while (true) {
    const int n_dec = __syncthreads_count(changed);
    if (n_dec == 0) break;
    if (changed) {
      const SyncOut o =
          sync_chunk(p, s_l1, seg, entry, (c + 1) * p.chunk_bits);
      s_exit[tid] = o.exit;
      store_chunk(p, g, entry, o);
    }
    ++iters;
    decodes += n_dec;
    __syncthreads();
    changed = false;
    if (has_prev && tid > 0) {
      const uint64_t x = s_exit[tid - 1];
      if (x != entry) {
        entry = x;
        changed = true;
      }
    }
  }
  if (tid == 0) {
    atomicMax(p.stats + (first_round ? kRound0Iters : kGlobalIters), iters);
    atomicAdd(p.stats + kSyncDecodes, decodes);
    if (!first_round) atomicAdd(p.stats + kGlobalCtas, 1);
  }
}

// One thread per segment: walk the CTA boundaries in order and, wherever a
// chunk's entry is not its predecessor's exit, re-decode it and its
// successors one by one until the entries agree again.
__global__ void __launch_bounds__(kSegThreads) seal_kernel(Params p) {
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (seg >= p.n_seg) return;
  const int64_t n = p.n_chunks[seg], g0 = seg * p.cps;
  int64_t c = (kSyncLanes - g0 % kSyncLanes) % kSyncLanes;
  if (c == 0) c = kSyncLanes;             // chunk 0 has no predecessor
  int fixes = 0;
  while (c <= n - 2) {
    int64_t cc = c;
    for (; cc <= n - 2; ++cc) {
      const int64_t g = g0 + cc;
      const uint64_t x = p.exit[g - 1];
      if (x == p.entry[g]) break;
      store_chunk(p, g, x,
                  sync_chunk(p, p.l1, seg, x, (cc + 1) * p.chunk_bits));
      ++fixes;
    }
    do {
      c += kSyncLanes;
    } while (c < cc);
  }
  if (fixes) atomicAdd(p.stats + kSealDecodes, fixes);
}

// Phase 2, one CTA per segment: exclusive prefix sums over the segment's
// chunks of the blocks begun and the DC sums, in place.  Each thread owns a
// run of consecutive chunks: it sums them, a block scan gives each run its
// carry-in, and the thread writes its run's prefixes.  A segment's last
// chunk has no counts of its own (it is never decoded in phase 1).
__global__ void __launch_bounds__(kScanThreads) offsets_kernel(Params p) {
  __shared__ uint32_t s_warp[kScanThreads / 32][5];
  const int64_t seg = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x / 32;
  const int64_t n = p.n_chunks[seg], g0 = seg * p.cps;
  const int64_t per = (n + blockDim.x - 1) / blockDim.x;
  const int64_t c0 = tid * per;
  const int64_t c1 = c0 + per < n ? c0 + per : n;
  int32_t* arr[5] = {p.cnt, p.dcs, p.dcs + p.n_chunk, p.dcs + 2 * p.n_chunk,
                     p.dcs + 3 * p.n_chunk};
  uint32_t own[5] = {0u, 0u, 0u, 0u, 0u};
  for (int64_t c = c0; c < c1 && c < n - 1; ++c) {
#pragma unroll
    for (int q = 0; q < 5; ++q)
      own[q] += static_cast<uint32_t>(arr[q][g0 + c]);   // wraps as int32
  }
  uint32_t x[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    x[q] = own[q];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x[q], off);
      if (lane >= off) x[q] += y;
    }
    if (lane == 31) s_warp[warp][q] = x[q];
  }
  __syncthreads();
  if (tid < 5) {   // inclusive scan of the warp totals, one value per thread
    uint32_t run = 0u;
    for (int w = 0; w < n_warps; ++w) {
      run += s_warp[w][tid];
      s_warp[w][tid] = run;
    }
  }
  __syncthreads();
  uint32_t run[5];
#pragma unroll
  for (int q = 0; q < 5; ++q)
    run[q] = x[q] - own[q] + (warp > 0 ? s_warp[warp - 1][q] : 0u);
  for (int64_t c = c0; c < c1; ++c) {
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const uint32_t v =
          c < n - 1 ? static_cast<uint32_t>(arr[q][g0 + c]) : 0u;
      arr[q][g0 + c] = static_cast<int32_t>(run[q]);
      run[q] += v;
    }
  }
}

// Phase 3 on one CTA of kSyncLanes chunks: decode each chunk from its true
// entry and write its coefficients.
__global__ void __launch_bounds__(kSyncLanes) write_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* s_l1 = reinterpret_cast<int16_t*>(smem);
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kSyncLanes +
                    threadIdx.x;
  const int64_t seg = g / p.cps, c = g % p.cps;
  const int64_t n = seg < p.n_seg ? p.n_chunks[seg] : 0;
  const bool live = c < n;
  if (!__syncthreads_or(live)) return;
  stage_tables(s_l1, p.l1, p.n_tables);
  if (!live) return;

  const uint64_t entry = c == 0 ? 0 : p.exit[g - 1];
  int64_t pos = static_cast<int64_t>(entry >> 10);
  int k = static_cast<int>((entry >> 6) & 15);
  int i = static_cast<int>(entry & 63);
  const bool last = c == n - 1;
  const int64_t end = (c + 1) * p.chunk_bits;
  const int64_t nm = p.seg_nmcus[seg] < p.rows / p.bpm ? p.seg_nmcus[seg]
                                                        : p.rows / p.bpm;
  const int64_t limit = nm * p.bpm;
  int64_t nb = p.cnt[g];                  // blocks begun before this chunk
  uint32_t pr0 = static_cast<uint32_t>(p.dcs[g]);
  uint32_t pr1 = static_cast<uint32_t>(p.dcs[p.n_chunk + g]);
  uint32_t pr2 = static_cast<uint32_t>(p.dcs[2 * p.n_chunk + g]);
  uint32_t pr3 = static_cast<uint32_t>(p.dcs[3 * p.n_chunk + g]);
  int32_t* seg_out = p.out + seg * p.rows * 64;
  BitReader br{p.words + seg * p.n_words, p.n_words, 0, 0, 0, 0};
  br.seek(pos);
  while (last || pos < end) {
    const int64_t cur = i == 0 ? nb : nb - 1;
    if (cur >= limit || cur < 0) break;
    Sym s;
    if (!step(br, s_l1, p, pos, k, i, s)) {
      p.err[seg] = 1;                     // on the true path, before the end
      break;
    }
    int32_t* blk = seg_out + cur * 64;
    if (s.dc) {
      const uint32_t v = static_cast<uint32_t>(s.val);
      uint32_t pr = s.ci == 0 ? pr0 : s.ci == 1 ? pr1 : s.ci == 2 ? pr2 : pr3;
      pr += v;
      pr0 = s.ci == 0 ? pr : pr0;
      pr1 = s.ci == 1 ? pr : pr1;
      pr2 = s.ci == 2 ? pr : pr2;
      pr3 = s.ci == 3 ? pr : pr3;
      blk[0] = static_cast<int32_t>(pr);
      ++nb;
    } else if (s.at >= 0) {
      blk[s.at] = s.val;
    }
  }
}

size_t decode_smem(int n_tables) {
  return static_cast<size_t>(n_tables) * kL1Size * sizeof(int16_t) +
         kSyncLanes * sizeof(uint64_t);
}

unsigned blocks_for(int64_t threads, int per_block) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

}  // namespace

// luts: (n_tables, 65536) int32; l1: (n_tables, 4096) int16 out.  Launches
// on `stream`; returns cudaGetLastError().
extern "C" int jd_build_l1(const void* luts, void* l1, int n_tables,
                           void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables)
    return static_cast<int>(cudaErrorInvalidValue);
  build_l1_kernel<<<blocks_for(n_tables * kL1Size, 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(luts), static_cast<int16_t*>(l1), n_tables);
  return static_cast<int>(cudaGetLastError());
}

// words: (n_seg, n_words) uint32 big-endian stream words; seg_nmcus:
// (n_seg,) int32; luts: (n_tables, 65536) int32 with tables 2c (DC) and
// 2c+1 (AC) of component c; l1: their first levels (jd_build_l1); out:
// (n_seg, rows, 64) int32, zero-filled, rows >= bpm; err: (n_seg,) int32;
// scratch: 36 * n_seg * cps + 4 * n_seg + 4 * kStats bytes (cps = chunks
// per row, ceil(n_words * 32 / chunk_bits)), 16-byte aligned: entry and exit
// (uint64), blocks begun and 4 DC sums (int32) per chunk, chunks per
// segment, then the kStats int32 stats.  comp_code holds the component of
// within-MCU block k in bits 4k..4k+3 (bpm <= 16).  chunk_bits: a multiple
// of 32.  precision: 8 or 12 (the size categories).  All on the current
// device (the wrapper checks this).  Launches the phases on `stream` and
// returns the first CUDA error (0 = launched).
extern "C" int jd_decode_segments(const void* words, const void* seg_nmcus,
                                  const void* luts, const void* l1, void* out,
                                  void* err, void* scratch, int64_t n_seg,
                                  int64_t n_words, int64_t rows, int n_tables,
                                  int bpm, uint64_t comp_code,
                                  int64_t chunk_bits, int global_rounds,
                                  int precision, void* stream) {
  if (n_seg <= 0) return 0;
  if (n_tables < 2 || n_tables > kMaxTables || bpm < 1 || bpm > 16 ||
      chunk_bits < 32 || chunk_bits % 32 != 0 || global_rounds < 0 ||
      (precision != 8 && precision != 12))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  p.words = static_cast<const uint32_t*>(words);
  p.seg_nmcus = static_cast<const int32_t*>(seg_nmcus);
  p.luts = static_cast<const int32_t*>(luts);
  p.l1 = static_cast<const int16_t*>(l1);
  p.out = static_cast<int32_t*>(out);
  p.err = static_cast<int32_t*>(err);
  p.n_seg = n_seg;
  p.n_words = n_words;
  p.rows = rows;
  p.chunk_bits = chunk_bits;
  p.cps = (n_words * 32 + chunk_bits - 1) / chunk_bits;
  p.n_chunk = n_seg * p.cps;
  p.comp_code = comp_code;
  p.n_tables = n_tables;
  p.bpm = bpm;
  p.max_dc = precision == 12 ? 15 : 11;
  p.max_ac = precision == 12 ? 14 : 10;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  p.entry = reinterpret_cast<uint64_t*>(base);
  p.exit = p.entry + p.n_chunk;
  p.cnt = reinterpret_cast<int32_t*>(p.exit + p.n_chunk);
  p.dcs = p.cnt + p.n_chunk;
  p.n_chunks = p.dcs + 4 * p.n_chunk;
  p.stats = p.n_chunks + n_seg;

  const size_t smem = decode_smem(n_tables);
  cudaError_t rc = cudaFuncSetAttribute(
      sync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(write_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);

  const unsigned seg_warps = blocks_for(n_seg * 32, kSegThreads);
  const unsigned chunk_ctas = blocks_for(p.n_chunk, kSyncLanes);
  seg_chunks_kernel<<<seg_warps, kSegThreads, 0, st>>>(p);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  for (int r = 0; r <= global_rounds; ++r) {
    sync_kernel<<<chunk_ctas, kSyncLanes, smem, st>>>(p, r == 0 ? 1 : 0);
    if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  }
  seal_kernel<<<blocks_for(n_seg, kSegThreads), kSegThreads, 0, st>>>(p);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  // Threads per segment: about one per chunk of a row, 32 to kScanThreads.
  int64_t scan_threads = (p.cps + 31) / 32 * 32;
  if (scan_threads > kScanThreads) scan_threads = kScanThreads;
  offsets_kernel<<<static_cast<unsigned>(n_seg),
                   static_cast<unsigned>(scan_threads), 0, st>>>(p);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  write_kernel<<<chunk_ctas, kSyncLanes, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
