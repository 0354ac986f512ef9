// Emit-lane Huffman decode from true MCU starts (K7), hand-written for
// Hopper (sm_90a), bound to PyTorch through plain C entry points and ctypes.
//
// Replaces the XLA device loop of the JAX package's `hybrid` backend:
// jpeg_decoder_tpu/ops/entropy_flat.py:decode_emit2 (the emission decoder)
// with ops/entropy_spec.py:_hybrid_pipeline_batch_emit (the scatter into
// scan order through ZIGZAG_INV) and :_dc_prefix_sum_seg (the segmented DC
// prefix sum), and the geometry-bucketed form of them that
// jpeg_decoder_tpu/parallel/sharded.py:_hybrid_full_step_emit_dyn runs (its
// `lut_base` and per-image geometry).  It computes the same function: B
// images, C lanes each; lane (b, j) starts at the true start bit starts[b, j]
// of MCU m_lo = lane_off / (64 * bpm) and decodes nm[b, j] contiguous MCUs of
// bpm blocks of image b's n_mcus_img[b] (n_mcus, the bucket's, when not
// given), with the Huffman tables lut_base[b] .. lut_base[b] + 2 * n_comps - 1
// of a stack of table sets (0 when not given).  The output is (B, rows, 64)
// int32 natural-order blocks in scan order (rows >= n_mcus * bpm), DC as the
// prefix sum of the differences per component, reset at every restart
// segment, wrapping as int32 as jnp.cumsum does; rows past n_mcus_img[b] *
// bpm are zeros; plus a (B,) error flag.  The first MCU of MCU m's segment
// is seg_first[m] when that array is given, else (m / ri[b]) * ri[b] (0 for
// DRI 0 or no ri), as sharded.py:829-838 derives it.  An image is flagged,
// as decode_emit2 flags a lane, on
//   an LUT entry of 0;
//   a DC size over max_dc or an AC size over max_ac (11, 10 for 8-bit
//   frames; 15, 14 for 12-bit ones);
//   i + run > 64, or size > 0 and i + run >= 64;
//   a lane that has not finished its nm * bpm blocks within T symbols;
// and, since a lane's plan is data here and not a trusted trace, on a lane
// plan that does not tile the image's MCUs in order (a lane_off that is not
// an MCU start, a lane past n_mcus, a gap or overlap between consecutive
// lanes) or a lane whose first and last MCUs lie in different restart
// segments, or on an n_mcus_img outside [1, n_mcus] or a table set outside
// the stack.  The blocks of a flagged image are unspecified (the wrapper's
// callers raise).  An image with no lane (nm[b, 0] <= 0: its host walk
// failed) decodes to zeros unflagged, as the JAX function does.
//
// What bounds it: latency, not bytes.  Each lane is a chain of dependent
// symbols, each a few hundred instructions of which most wait on the one
// before; the words in and blocks out would take microseconds at HBM rate.
// One frame's lanes (a lane is at least about two MCUs in the host plan)
// give each SM only a warp or two, so nothing hides that chain: a frame
// costs about its longest lane's steps times a step's latency, and only a
// batch of frames in one launch fills the card (PERF.md has the numbers).
// The first form (csrc/entropy_emit_v1.cu) refilled every word from device
// memory, zero-filled the output before the launch, and carried DC in two
// more launches (one CTA per image, one per lane).  This one is a single
// launch of persistent CTAs (a few per SM, as many as shared memory allows):
//  * Each CTA stages the first-level tables of one table set, and builds in
//    shared memory a second level for every 12-bit prefix of a longer code,
//    so that no probe reads device memory (`misses` counts those that still
//    do).  Shared memory holds one set: when a ticket lands on an image of
//    another set, the CTA stages and builds again (`stages` counts each
//    staging); callers order a batch's images by set, so that a CTA seldom
//    does.
//  * It then takes lane groups by ticket (an atomic counter, in order): a
//    group is `blockDim.x` consecutive lanes of one image, one thread each.
//    A valid plan's lanes are consecutive in the stream, so the group reads
//    one word range, from its first lane's start to the next group's first
//    start plus the reader's lookahead (the pool's end for the image's last
//    group).  The CTA copies it into shared memory with 16-byte cp.async
//    (overlapping the table copy on its first group), at most
//    `budget_words` words; the reader refills from there.  A word outside
//    the staged range is read from device memory and the group is counted
//    as over budget (never a switch to the plain version).
//  * A warp's 32 lanes decode in lockstep, one symbol per step, with few
//    branches.  A lane builds its current block's AC terms as int16 in
//    shared memory; when blocks complete, the warp stores each one whole (DC
//    included), a quarter warp per block, as coalesced 16-byte stores, and
//    zeroes its buffer.  Nothing is zero-filled first: every element is
//    stored once, and only a DC term that needs a carry-in once more.
//  * DC carry, decoupled look-back: the group scans its lanes' DC sums
//    (segmented by restart segment) in registers and shared memory,
//    publishes its aggregate, looks back over the groups with earlier
//    tickets (32 at a time, one warp) for its carry-in, publishes its
//    inclusive sum, and adds each lane's carry-in to its blocks' DC terms
//    (the lane-local terms of its first kDcSlots blocks kept in shared
//    memory, so those are stores, not reads).
//  * Each group also zeroes its share of the rows past its image's blocks
//    (a bucket's tail, and the fill row a caller may ask for), or of all the
//    image's rows when it has no lane.
//    Tickets are taken in order by running CTAs, so a group only waits on
//    groups whose aggregate does not wait on anything: no deadlock,
//    whatever the scheduling order.
// Output offsets are int64, so a >= 50 MP frame or a large batch does not
// wrap (the JAX lanes keep them in int32); stream positions are the plan's
// int32 start bits, so word indices are int32.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kL1Bits = 12;                 // first-level table index bits
constexpr int kL1Size = 1 << kL1Bits;
constexpr int kMaxTables = 8;               // one set: 2 * <= 4 components
constexpr int kMaxLanes = 128;              // threads (lanes) per CTA, most
constexpr int kWarps = kMaxLanes / 32;
constexpr int kL2Slots = 128;               // second-level tables of 16
constexpr int kBlkStride = 68;              // int16 per lane block buffer
constexpr int kDcSlots = 16;                // lane-local DC terms kept
constexpr int kLookahead = 3;               // words past a lane's last word
constexpr int kStatusWords = 16;            // per group: flag, agg, incl
constexpr int kHeaderWords = 8;             // ticket and counters
constexpr unsigned kFull = 0xffffffffu;

__device__ const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Params {
  const uint32_t* pools;      // (B, W) big-endian words
  const int32_t* starts;      // (B, C) lane start bits within the pool row
  const int32_t* nm;          // (B, C) MCUs per lane (0: no lane)
  const int64_t* lane_off;    // (B, C) coefficient slot of the first block
  const int32_t* seg_first;   // (n_mcus,) first MCU of each MCU's segment,
                              // or null: from ri
  const int32_t* lut_base;    // (B,) first table of each image's set, or null
  const int32_t* n_mcus_img;  // (B,) each image's MCUs, or null: n_mcus
  const int32_t* ri;          // (B,) each image's restart interval, or null
  const int32_t* luts;        // (n_stack, 65536)
  const int16_t* l1;          // (n_stack, kL1Size)
  int32_t* out;               // (B, rows, 64), not initialised
  int32_t* err;               // (B,), zero-filled
  uint32_t* scratch;          // header + status per group, zero-filled
  int64_t n_img, n_words, n_mcus, rows, trips, n_groups;
  uint64_t comp_code;         // component of block k in bits 4k..4k+3
  int lanes_per_img, groups_per_img, n_tables, n_stack, bpm, max_dc, max_ac;
  int lane_lo, lane_hi;       // the lanes of each image this launch decodes
  int budget_words;           // staged words per group, a multiple of 4
};

// Scratch header words.
constexpr int kTicket = 0, kStaged = 1, kOverBudget = 2, kMisses = 3,
              kStages = 4;

// ---- Copies and flags (PTX) ----------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// ---- Reader and probe ----------------------------------------------------

// MSB-first reader over one image's words (K2's, csrc/entropy.cu), refilling
// from the group's staged range [s_lo, s_hi) of row words, kept in shared
// memory at s_words[w - s_base].  Invariant after refill(): 33 <= nbits <=
// 64 valid bits, left-aligned in buf, zeros below them; pf holds word
// `next`, loaded one refill ahead, so a lane whose bits end at bit e reads
// no word past (e >> 5) + 2.  Words outside [0, n_words) read as zero;
// words of the row outside the staged range come from device memory and
// set `far`.
struct BitReader {
  const uint32_t* g_words;    // the image's row in device memory
  const uint32_t* s_words;
  // Word indices are below 2^26 (start bits are int32) and n_words is
  // clamped to int32, so 32-bit arithmetic holds.
  int32_t n_words, s_lo, s_hi, s_base;
  int32_t next;
  uint64_t buf;
  int nbits;
  uint32_t pf;
  bool far;

  __device__ __forceinline__ uint32_t word(int32_t w) {
    if (w >= s_lo && w < s_hi) return s_words[w - s_base];
    if (w < 0 || w >= n_words) return 0u;
    far = true;
    return __ldg(g_words + w);
  }
  __device__ __forceinline__ void seek(int32_t pos) {
    const int32_t w = pos >> 5;
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
  // n <= 31 at every call site (a code of <= 16 bits and its term).
  __device__ __forceinline__ void skip(int n) {
    buf <<= n;
    nbits -= n;
  }
};

// Shared-memory tables: s_l1[t * kL1Size + (p >> 4)] is the LUT entry of a
// code of at most 12 bits, -(slot + 1) for a prefix of longer codes whose
// 16 entries are s_l2[slot * 16 ...], 0 for a prefix no code takes.  Only
// when the second level ran out of slots (l2_full) does a 0 read the full
// table in device memory, counted in `misses`.
struct Tables {
  const int16_t* l1;
  const int16_t* l2;
  const int32_t* luts;
  bool l2_full;

  __device__ __forceinline__ int32_t probe(int t, uint32_t p,
                                           uint32_t& misses) const {
    const int32_t e = l1[t * kL1Size + (p >> (16 - kL1Bits))];
    if (e > 0) return e;
    if (e < 0) return l2[(-e - 1) * 16 + (p & 15)];
    if (!l2_full) return 0;
    ++misses;
    return __ldg(luts + static_cast<int64_t>(t) * 65536 + p);
  }
};

// ---- The plan ------------------------------------------------------------

// Image b's MCUs, or -1 when n_mcus_img[b] is outside [1, n_mcus].
__device__ __forceinline__ int64_t img_mcus(const Params& p, int64_t b) {
  if (p.n_mcus_img == nullptr) return p.n_mcus;
  const int64_t n = p.n_mcus_img[b];
  return n >= 1 && n <= p.n_mcus ? n : -1;
}

// The first MCU of the restart segment of image b's MCU m (m < n_mcus).
__device__ __forceinline__ int64_t seg_start(const Params& p, int64_t b,
                                             int64_t m) {
  if (p.seg_first != nullptr) return p.seg_first[m];
  const int64_t r = p.ri != nullptr ? p.ri[b] : 0;
  return r > 0 ? m / r * r : 0;
}

// Lane g's first MCU, or -1 when its plan is malformed: lane_off is not an
// MCU start or the lane runs past the image's n_mcus (n >= 1).  nm must be
// > 0.
__device__ __forceinline__ int64_t first_mcu(const Params& p, int64_t g,
                                             int64_t n) {
  const int64_t per_mcu = 64LL * p.bpm;
  const int64_t off = p.lane_off[g];
  if (off < 0 || off % per_mcu != 0) return -1;
  const int64_t m = off / per_mcu;
  return m + p.nm[g] <= n ? m : -1;
}

// Lane (b, j)'s first MCU when its plan is part of one that tiles the
// image's MCUs in order (lane 0 starts at MCU 0, each lane ends where the
// next one starts, the last lane with MCUs ends at the image's n_mcus) and
// its MCUs lie in one restart segment; -1 for a lane without MCUs, -2 for a
// malformed lane (its image is flagged).
__device__ __forceinline__ int64_t lane_mcu(const Params& p, int64_t b,
                                            int j) {
  const int64_t g = b * p.lanes_per_img + j;
  if (p.nm[g] <= 0) return -1;
  const int64_t n = img_mcus(p, b);
  if (n < 0) return -2;
  const int64_t m_lo = first_mcu(p, g, n);
  if (m_lo < 0) return -2;
  if (j == 0 ? m_lo != 0 : p.nm[g - 1] <= 0) return -2;
  const int64_t end = m_lo + p.nm[g];
  if (seg_start(p, b, end - 1) != seg_start(p, b, m_lo)) return -2;
  if (j + 1 < p.lanes_per_img && p.nm[g + 1] > 0)
    return first_mcu(p, g + 1, n) == end ? m_lo : -2;
  return end == n ? m_lo : -2;
}

// The carry's run key of lane (b, j): its restart segment, or -1 (a run of
// its own, with no DC sum) for a lane without MCUs or a malformed one.
__device__ __forceinline__ int64_t run_key(const Params& p, int64_t b,
                                           int j) {
  const int64_t m = lane_mcu(p, b, j);
  return m < 0 ? -1 : seg_start(p, b, m);
}

// The row words a group stages: [s_lo, s_hi).  s_lo is its first lane's
// start word; the range needed ends at the next group's first start word
// plus the lookahead, or at the pool's end for the image's last group, and
// is cut at budget_words; a group whose first lane has no MCUs stages
// nothing.  tests/test_torch_emit.py:windows is the same computation in
// numpy.
__device__ __forceinline__ void window(const Params& p, int64_t b, int x,
                                       int64_t& s_lo, int64_t& s_hi) {
  const int64_t row = b * p.lanes_per_img;
  const int j0 = p.lane_lo + x * static_cast<int>(blockDim.x);
  int j1 = j0 + static_cast<int>(blockDim.x);
  j1 = j1 < p.lane_hi ? j1 : p.lane_hi;
  s_lo = static_cast<int64_t>(p.starts[row + j0]) >> 5;
  s_lo = s_lo < 0 ? 0 : (s_lo > p.n_words ? p.n_words : s_lo);
  if (p.nm[row + j0] <= 0) {   // no lane in the group: nothing to stage
    s_hi = s_lo;
    return;
  }
  int64_t hi = p.n_words;
  if (j1 < p.lanes_per_img && p.nm[row + j1] > 0)
    hi = (static_cast<int64_t>(p.starts[row + j1]) >> 5) + kLookahead;
  hi = hi > p.n_words ? p.n_words : hi;
  hi = hi < s_lo ? s_lo : hi;
  s_hi = hi - s_lo > p.budget_words ? s_lo + p.budget_words : hi;
}

// ---- Staging -------------------------------------------------------------

// Issue the copy of the first-level tables (16-byte cp.async).
__device__ __forceinline__ void stage_tables(int16_t* dst, const int16_t* src,
                                             int n_tables) {
  const int n_vec = n_tables * kL1Size * 2 / 16;
  for (int v = threadIdx.x; v < n_vec; v += blockDim.x)
    cp_async16(dst + v * 8, src + v * 8);
}

// Issue the copy of row words [s_lo, s_hi) of image b: absolute words from
// a = (row + s_lo) rounded down to a multiple of 4 (so that whole 16-byte
// chunks stay aligned when the pool is), to s_words[0 ...].  Returns a -
// row, the row word that s_words[0] holds.
__device__ __forceinline__ int64_t stage_words(uint32_t* s_words,
                                               const Params& p, int64_t b,
                                               int64_t s_lo, int64_t s_hi,
                                               bool aligned) {
  const int64_t row = b * p.n_words;
  const int64_t a = (row + s_lo) & ~static_cast<int64_t>(3);
  const int64_t a_end = row + s_hi;
  for (int64_t i = a + 4 * threadIdx.x; i < a_end; i += 4 * blockDim.x) {
    if (aligned && i + 4 <= a_end) {
      cp_async16(s_words + (i - a), p.pools + i);
    } else {
      for (int k = 0; k < 4 && i + k < a_end; ++k)
        cp_async4(s_words + (i - a + k), p.pools + i + k);
    }
  }
  return a - row;
}

// After the table copy: a second level for every prefix whose l1 entry is
// 0 but whose full-table entries are not all 0 (codes of 13-16 bits).
__device__ void build_l2(int16_t* s_l1, int16_t* s_l2, const int32_t* luts,
                         int n_tables, int* n_slots) {
  const int n_vec = n_tables * kL1Size / 8;
  for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
    const uint4 q = reinterpret_cast<const uint4*>(s_l1)[v];
    if ((__vcmpeq2(q.x, 0u) | __vcmpeq2(q.y, 0u) | __vcmpeq2(q.z, 0u) |
         __vcmpeq2(q.w, 0u)) == 0u)
      continue;                          // no entry of the 8 is 0
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      if ((w[h >> 1] >> (16 * (h & 1)) & 0xffffu) != 0u) continue;
      const int e = v * 8 + h;
      const int32_t* src = luts + static_cast<int64_t>(e >> kL1Bits) * 65536 +
                           ((e & (kL1Size - 1)) << (16 - kL1Bits));
      int32_t ent[16];
      bool any = false;
      for (int s = 0; s < 16; ++s) {
        ent[s] = __ldg(src + s);
        any |= ent[s] != 0;
      }
      if (!any) continue;
      const int slot = atomicAdd(n_slots, 1);
      if (slot >= kL2Slots) continue;   // l2_full: probes read luts
      for (int s = 0; s < 16; ++s)
        s_l2[slot * 16 + s] = static_cast<int16_t>(ent[s]);
      s_l1[e] = static_cast<int16_t>(-(slot + 1));
    }
  }
}

// ---- The kernel ----------------------------------------------------------

__global__ void __launch_bounds__(kMaxLanes) emit_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  int16_t* s_l1 = reinterpret_cast<int16_t*>(smem + 4 * (p.budget_words + 4));
  int16_t* s_l2 = s_l1 + p.n_tables * kL1Size;
  int16_t* s_blk = s_l2 + kL2Slots * 16;
  int32_t* s_dcs = reinterpret_cast<int32_t*>(s_blk + blockDim.x * kBlkStride);
  __shared__ int64_t s_ticket;
  __shared__ int s_n_slots, s_far;
  __shared__ uint32_t s_wv[kWarps][4], s_carry[4];
  __shared__ int s_wh[kWarps];
  __shared__ uint8_t s_zz[64];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int last_tid = static_cast<int>(blockDim.x) - 1;
  const bool aligned = (reinterpret_cast<uintptr_t>(p.pools) & 15) == 0;
  uint32_t* const ticket = p.scratch + kTicket;
  uint32_t* const status = p.scratch + kHeaderWords;
  int16_t* const my_blk = s_blk + tid * kBlkStride;
  Tables tab{s_l1, s_l2, p.luts, false};
  uint32_t misses = 0;

  for (int q = tid; q < 64; q += blockDim.x) s_zz[q] = kZigzag[q];
  for (int q = 0; q < kBlkStride / 4; ++q)
    reinterpret_cast<uint2*>(my_blk)[q] = make_uint2(0u, 0u);
  int64_t staged_set = -1;   // the first table of the set in shared memory

  for (;;) {
    if (tid == 0) {
      s_ticket = atomicAdd(ticket, 1u);
      s_far = 0;
    }
    __syncthreads();
    const int64_t t = s_ticket;
    if (t >= p.n_groups) break;
    const int64_t b = t / p.groups_per_img;
    const int x = static_cast<int>(t % p.groups_per_img);
    const int j = p.lane_lo + x * static_cast<int>(blockDim.x) + tid;
    const bool in = j < p.lane_hi;
    const int64_t g = b * p.lanes_per_img + j;

    // Rows past the image's blocks (all of them for an image without
    // lanes) are zeros: each of its groups zeroes its share.
    {
      const int64_t n = img_mcus(p, b);
      const int64_t z0 =
          p.nm[b * p.lanes_per_img] <= 0 ? 0 : (n < 0 ? p.n_mcus : n) * p.bpm;
      int4* o = reinterpret_cast<int4*>(p.out + (b * p.rows + z0) * 64);
      const int64_t span = (p.rows - z0) * 16;
      const int64_t lo = span * x / p.groups_per_img;
      const int64_t hi = span * (x + 1) / p.groups_per_img;
      for (int64_t v = lo + tid; v < hi; v += blockDim.x)
        o[v] = make_int4(0, 0, 0, 0);
    }

    // The image's table set: staged again when it is not the one in shared
    // memory (every thread is past the last group's probes: the ticket's
    // __syncthreads).  A set outside the stack flags the image.
    int64_t set = p.lut_base != nullptr ? p.lut_base[b] : 0;
    if (set < 0 || set + p.n_tables > p.n_stack) {
      if (tid == 0) p.err[b] = 1;
      set = 0;
    }
    const bool restage = set != staged_set;
    if (restage) {
      if (tid == 0) {
        s_n_slots = 0;
        atomicAdd(p.scratch + kStages, 1u);
      }
      stage_tables(s_l1, p.l1 + set * kL1Size, p.n_tables);
    }
    int64_t s_lo, s_hi;
    window(p, b, x, s_lo, s_hi);
    const int64_t s_base = stage_words(s_words, p, b, s_lo, s_hi, aligned);
    cp_async_wait_all();
    __syncthreads();
    if (restage) {
      tab.luts = p.luts + set * 65536;
      build_l2(s_l1, s_l2, tab.luts, p.n_tables, &s_n_slots);
      __syncthreads();
      tab.l2_full = s_n_slots > kL2Slots;
      staged_set = set;
    }

    // Decode: the warp's lanes in lockstep, one symbol per step.
    const int64_t m_lo = in ? lane_mcu(p, b, j) : -1;
    if (m_lo == -2) p.err[b] = 1;
    const int n_blocks = m_lo >= 0 ? p.nm[g] * p.bpm : 0;
    const int64_t lane_base = (b * p.rows + (m_lo >= 0 ? m_lo : 0) *
                               p.bpm) * 64;
    const int32_t n_words32 = static_cast<int32_t>(
        p.n_words < 0x7fffffff ? p.n_words : 0x7fffffff);
    BitReader br{p.pools + b * p.n_words, s_words, n_words32,
                 static_cast<int32_t>(s_lo < n_words32 ? s_lo : n_words32),
                 static_cast<int32_t>(s_hi < n_words32 ? s_hi : n_words32),
                 static_cast<int32_t>(s_base), 0, 0, 0, 0, false};
    if (n_blocks > 0) br.seek(p.starts[g]);
    uint32_t run0 = 0u, run1 = 0u, run2 = 0u, run3 = 0u;
    int blk = 0, k = 0, i = 0;
    int ci = static_cast<int>(p.comp_code & 0xF);   // block k's component
    int32_t dc_val = 0;
    bool bad = false, act = n_blocks > 0;
    const int trips = static_cast<int>(p.trips < 0x7fffffff ? p.trips
                                                            : 0x7fffffff);
    int64_t done_at = 0;
    for (int step = 0; step < trips; ++step) {
      if (!__any_sync(kFull, act)) break;
      bool done = false;
      if (act) {
        // One symbol, with as few branches as the warp can take together:
        // once a lane is bad it stops, so its state may go stale.
        br.refill();
        const bool dc = i == 0;
        const uint32_t top = static_cast<uint32_t>(br.buf >> 32);
        const int32_t e = tab.probe(2 * ci + (dc ? 0 : 1), top >> 16,
                                    misses);
        // An entry is 0 or has a code length of 1..16 (huffman.build_lut).
        const int len = e & 31;
        const int sym = e >> 5;
        // AC: EOB (0) ends the block; a size of 0 skips its run of zeros
        // (16 for ZRL, 0xF0); else the run, then a term at slot i + run.
        const int sz = sym & 15;
        const int adv = sz ? (sym >> 4) + 1 : (sym == 0xF0 ? 16 : sym >> 4);
        const int i2 = dc ? 1 : (sym == 0 ? 64 : i + adv);
        const int size = dc ? sym : sz;
        bad = len == 0 ||
              (dc ? sym > p.max_dc : (i2 > 64 || sz > p.max_ac));
        // len + size <= 31: the term's bits follow the code in `top`.
        const uint32_t raw = (!bad && size) ? (top << len) >> (32 - size)
                                            : 0u;
        const int32_t val =
            (size && raw < (1u << (size - 1)))
                ? static_cast<int32_t>(raw) - ((1 << size) - 1)
                : static_cast<int32_t>(raw);
        br.skip(bad ? 0 : len + size);
        const uint32_t r = (ci == 0 ? run0 : ci == 1 ? run1 : ci == 2 ? run2
                                                                    : run3) +
                           static_cast<uint32_t>(val);   // wraps as int32
        if (dc) {
          run0 = ci == 0 ? r : run0;
          run1 = ci == 1 ? r : run1;
          run2 = ci == 2 ? r : run2;
          run3 = ci == 3 ? r : run3;
          dc_val = static_cast<int32_t>(r);
          if (blk < kDcSlots) s_dcs[blk * blockDim.x + tid] = dc_val;
        }
        if (!bad && !dc && sz)
          my_blk[s_zz[i2 - 1]] = static_cast<int16_t>(val);   // |val| < 2^14
        done = !bad && i2 >= 64;                  // the block is complete
        i = done ? 0 : i2;
        if (done) {
          done_at = lane_base + static_cast<int64_t>(blk) * 64;
          ++blk;
          k = k + 1 == p.bpm ? 0 : k + 1;
          ci = static_cast<int>((p.comp_code >> (4 * k)) & 0xF);
        }
        act = !bad && blk < n_blocks;
      }
      // Store the blocks completed in this step whole: a quarter warp per
      // block (up to four at once), two 16-byte chunks (4 terms each) a
      // thread, DC from the block's lane.
      __syncwarp();
      unsigned m = __ballot_sync(kFull, done);
      while (m) {
        int o = -1;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int f = m ? __ffs(m) - 1 : -1;
          o = (lane >> 3) == x ? f : o;
          m &= m - 1;
        }
        const int src = o < 0 ? 0 : o;
        const int64_t at = __shfl_sync(kFull, done_at, src);
        const int32_t dcv = __shfl_sync(kFull, dc_val, src);
        if (o >= 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = (lane & 7) + 8 * h;
            uint2* cell = reinterpret_cast<uint2*>(
                s_blk + (warp * 32 + o) * kBlkStride + 4 * q);
            const uint2 raw = *cell;
            int4 v;
            v.x = q == 0 ? dcv : static_cast<int32_t>(raw.x << 16) >> 16;
            v.y = static_cast<int32_t>(raw.x) >> 16;
            v.z = static_cast<int32_t>(raw.y << 16) >> 16;
            v.w = static_cast<int32_t>(raw.y) >> 16;
            reinterpret_cast<int4*>(p.out + at)[q] = v;
            *cell = make_uint2(0u, 0u);
          }
        }
      }
      __syncwarp();
    }
    if (n_blocks > 0 && (bad || blk < n_blocks)) {
      p.err[b] = 1;
      // A block may be left half-built: clear the lane's buffer.
      for (int q = 0; q < kBlkStride / 4; ++q)
        reinterpret_cast<uint2*>(my_blk)[q] = make_uint2(0u, 0u);
    }
    if (br.far) s_far = 1;

    // Carry: segmented inclusive scan of the lane sums over the group.
    const int64_t key = m_lo >= 0 ? seg_start(p, b, m_lo) : -1;
    int h = !in || j == p.lane_lo || key < 0 || key != run_key(p, b, j - 1);
    const bool lane_head = h;
    const uint32_t own[4] = {run0, run1, run2, run3};
    uint32_t v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = key < 0 ? 0u : own[c];
    const uint32_t mine[4] = {v[0], v[1], v[2], v[3]};
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      uint32_t u[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) u[c] = __shfl_up_sync(kFull, v[c], off);
      const int hu = __shfl_up_sync(kFull, h, off);
      if (lane >= off && !h) {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] += u[c];
        h = hu;
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s_wv[warp][c] = v[c];
      s_wh[warp] = h;
    }
    if (tid == 0) s_carry[0] = s_carry[1] = s_carry[2] = s_carry[3] = 0u;
    __syncthreads();
    // Runs open at the warp's start continue from the warps before it.
    for (int w = warp - 1; w >= 0 && !h; --w) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] += s_wv[w][c];
      h = s_wh[w];
    }
    // The group's first lane starts a run: no carry-in to look back for.
    const bool group_head = __syncthreads_or(tid == 0 && lane_head);
    // The last thread's (v, h): the run ending the group, and whether it
    // starts inside the group.
    uint32_t* const st = status + t * kStatusWords;
    if (tid == last_tid) {
#pragma unroll
      for (int c = 0; c < 4; ++c) st[(h ? 5 : 1) + c] = v[c];
      store_release(st, h ? 2u : 1u);
    }
    // Look back for the carry-in of the run open at the group's start.
    if (!group_head && warp == 0) {
      uint32_t cin[4] = {0u, 0u, 0u, 0u};
      const int64_t img0 = t - x;      // the image's first group: a head
      for (int64_t base = t - 1;;) {
        const int64_t idx = base - lane;
        const uint32_t* s2 = status + idx * kStatusWords;
        const uint32_t f = idx >= img0 ? load_acquire(s2) : 2u;
        if (__any_sync(kFull, f == 0u)) {
          __nanosleep(64);
          continue;
        }
        const unsigned stop = __ballot_sync(kFull, f == 2u);
        const int last = stop ? __ffs(stop) - 1 : 31;
        uint32_t add[4] = {0u, 0u, 0u, 0u};
        if (lane <= last && idx >= img0) {
#pragma unroll
          for (int c = 0; c < 4; ++c) add[c] = __ldcg(s2 + (f == 2u ? 5 : 1) + c);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          for (int off = 16; off > 0; off >>= 1)
            add[c] += __shfl_xor_sync(kFull, add[c], off);
          cin[c] += add[c];
        }
        if (stop) break;
        base -= 32;
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s_carry[c] = cin[c];
      }
    }
    __syncthreads();
    if (tid == last_tid && !h) {   // the group's inclusive sum
#pragma unroll
      for (int c = 0; c < 4; ++c) st[5 + c] = v[c] + s_carry[c];
      store_release(st, 2u);
    }
    // Each lane's carry-in, added to its blocks' DC terms.
    if (n_blocks > 0 && !bad) {
      uint32_t cy[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        cy[c] = v[c] - mine[c] + (h ? 0u : s_carry[c]);
      if ((cy[0] | cy[1] | cy[2] | cy[3]) != 0u) {
        // The first kDcSlots blocks' lane-local DC terms are in shared
        // memory (a store each); later ones are read back.
        int kk = 0;
        for (int q = 0; q < n_blocks; ++q) {
          const int c = static_cast<int>((p.comp_code >> (4 * kk)) & 0xF);
          const uint32_t add = c == 0 ? cy[0] : c == 1 ? cy[1]
                               : c == 2 ? cy[2] : cy[3];
          int32_t* dc = p.out + lane_base + static_cast<int64_t>(q) * 64;
          const int32_t was = q < kDcSlots ? s_dcs[q * blockDim.x + tid]
                                           : *dc;
          *dc = static_cast<int32_t>(static_cast<uint32_t>(was) + add);
          kk = kk + 1 == p.bpm ? 0 : kk + 1;
        }
      }
    }
    // Counters: a group with lanes either stayed in shared memory or not.
    const bool any_lane = __syncthreads_or(n_blocks > 0);
    if (tid == 0 && any_lane)
      atomicAdd(p.scratch + (s_far ? kOverBudget : kStaged), 1u);
  }
  if (misses) atomicAdd(p.scratch + kMisses, misses);
}

size_t smem_bytes(int group_lanes, int budget_words, int n_tables) {
  return 4 * static_cast<size_t>(budget_words + 4) +
         2 * static_cast<size_t>(n_tables) * kL1Size + 2 * kL2Slots * 16 +
         static_cast<size_t>(group_lanes) * (2 * kBlkStride + 4 * kDcSlots);
}

bool fill(Params& p, const void* pools, const void* starts, const void* nm,
          const void* lane_off, const void* seg_first, const void* lut_base,
          const void* n_mcus_img, const void* ri, const void* luts,
          const void* l1, void* out, void* err, void* scratch, int64_t n_img,
          int64_t n_words, int64_t lanes_per_img, int64_t n_mcus,
          int64_t rows, int64_t trips, int n_tables, int n_stack, int bpm,
          uint64_t comp_code, int precision, int group_lanes,
          int budget_words, int64_t lane_lo, int64_t lane_hi) {
  if (n_img < 1 || n_words < 1 || lanes_per_img < 1 ||
      lanes_per_img > 0x7fffffff || lane_lo < 0 || lane_hi <= lane_lo ||
      lane_hi > lanes_per_img || n_mcus < 1 || rows < n_mcus * bpm ||
      trips < 0 || n_tables < 2 || n_tables > kMaxTables ||
      n_stack < n_tables || bpm < 1 || bpm > 16 ||
      (precision != 8 && precision != 12) || group_lanes < 32 ||
      group_lanes > kMaxLanes || group_lanes % 32 != 0 || budget_words < 4 ||
      budget_words % 4 != 0)
    return false;
  p.pools = static_cast<const uint32_t*>(pools);
  p.starts = static_cast<const int32_t*>(starts);
  p.nm = static_cast<const int32_t*>(nm);
  p.lane_off = static_cast<const int64_t*>(lane_off);
  p.seg_first = static_cast<const int32_t*>(seg_first);
  p.lut_base = static_cast<const int32_t*>(lut_base);
  p.n_mcus_img = static_cast<const int32_t*>(n_mcus_img);
  p.ri = static_cast<const int32_t*>(ri);
  p.luts = static_cast<const int32_t*>(luts);
  p.l1 = static_cast<const int16_t*>(l1);
  p.out = static_cast<int32_t*>(out);
  p.err = static_cast<int32_t*>(err);
  p.scratch = static_cast<uint32_t*>(scratch);
  p.n_img = n_img;
  p.n_words = n_words;
  p.lanes_per_img = static_cast<int>(lanes_per_img);
  p.lane_lo = static_cast<int>(lane_lo);
  p.lane_hi = static_cast<int>(lane_hi);
  p.groups_per_img = static_cast<int>(
      (lane_hi - lane_lo + group_lanes - 1) / group_lanes);
  p.n_groups = n_img * p.groups_per_img;
  p.n_mcus = n_mcus;
  p.rows = rows;
  p.trips = trips;
  p.comp_code = comp_code;
  p.n_tables = n_tables;
  p.n_stack = n_stack;
  p.bpm = bpm;
  p.max_dc = precision == 12 ? 15 : 11;
  p.max_ac = precision == 12 ? 14 : 10;
  p.budget_words = budget_words;
  // Tickets are uint32.
  return p.n_groups < 0x7fffffffLL;
}

}  // namespace

// CTAs of emit_kernel one SM of the current device holds at this shape (0
// if it cannot run), or a negative CUDA error.  Also raises the kernel's
// dynamic shared memory limit to all the device allows a block, as a launch
// above 48 KB needs: always to that, never lower, so that callers on other
// threads with other shapes cannot shrink it under a launch.
extern "C" int jd_emit_ctas_per_sm(int group_lanes, int budget_words,
                                   int n_tables) {
  const size_t smem = smem_bytes(group_lanes, budget_words, n_tables);
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, emit_kernel);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(
        emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - static_cast<int>(attr.sharedSizeBytes));
  if (rc != cudaSuccess) return -static_cast<int>(rc);
  int n = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, emit_kernel,
                                                     group_lanes, smem);
  return rc != cudaSuccess ? -static_cast<int>(rc) : n;
}

// pools (n_img, n_words) uint32; starts, nm (n_img, lanes_per_img) int32;
// lane_off (n_img, lanes_per_img) int64; seg_first (n_mcus,) int32 or null
// (segments from ri); lut_base, n_mcus_img, ri (n_img,) int32, each or null
// (table set 0, n_mcus, DRI 0); luts (n_stack, 65536) int32, table sets of
// n_tables tables, tables 2c (DC) and 2c+1 (AC) of component c, and l1 their
// first levels (csrc/entropy.cu's jd_build_l1); out (n_img, rows, 64) int32,
// rows >= n_mcus * bpm, 16-byte aligned, not initialised; err (n_img,)
// int32 and scratch (8 + 16 * n_img * ceil((lane_hi - lane_lo) /
// group_lanes)) uint32, both zero-filled; trips: the symbols a lane may decode;
// comp_code: the component of within-MCU block k in bits 4k..4k+3;
// precision: 8 or 12; group_lanes: lanes per group = threads per CTA (32,
// 64, 96 or 128); budget_words: words a group stages (a multiple of 4);
// grid: the persistent CTAs, at most jd_emit_ctas_per_sm's count times the
// SMs (that call, made first on this device, set the shared memory limit);
// [lane_lo, lane_hi): the lanes of every image this launch decodes (all of
// them, 0 .. lanes_per_img, on one GPU; a rank's share of them on a mesh,
// whose DC carry then starts from 0 at lane_lo: csrc/emit_carry.cu adds
// the ranks before it).  The plan is checked against the whole table.
// After the launch scratch[1..4] hold the groups that read only shared
// memory, the groups that read stream words from device memory, the probes
// that read the full tables, and the table sets staged.  All on the current device (the
// wrapper checks this).  Launches on `stream` and returns the CUDA error of
// the launch (0 = launched).
extern "C" int jd_emit_lanes(const void* pools, const void* starts,
                             const void* nm, const void* lane_off,
                             const void* seg_first, const void* lut_base,
                             const void* n_mcus_img, const void* ri,
                             const void* luts, const void* l1, void* out,
                             void* err, void* scratch, int64_t n_img,
                             int64_t n_words, int64_t lanes_per_img,
                             int64_t n_mcus, int64_t rows, int64_t trips,
                             int n_tables, int n_stack, int bpm,
                             uint64_t comp_code, int precision,
                             int group_lanes, int budget_words, int grid,
                             int64_t lane_lo, int64_t lane_hi,
                             void* stream) {
  Params p;
  if (!fill(p, pools, starts, nm, lane_off, seg_first, lut_base, n_mcus_img,
            ri, luts, l1, out, err, scratch, n_img, n_words, lanes_per_img,
            n_mcus, rows, trips, n_tables, n_stack, bpm, comp_code, precision,
            group_lanes, budget_words, lane_lo, lane_hi) ||
      grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ctas = grid < p.n_groups ? grid : p.n_groups;
  emit_kernel<<<static_cast<unsigned>(ctas), group_lanes,
                smem_bytes(group_lanes, budget_words, n_tables),
                static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
