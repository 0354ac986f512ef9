// Emit-lane Huffman decode from true MCU starts (K7), its first form for
// Hopper (sm_90a), kept as the same-card baseline of the current kernel
// (csrc/entropy_emit.cu).  Reached only from testing/emit_v1.py, never from
// decode() or BatchDecoder; bound to PyTorch through plain C entry points
// and ctypes.
//
// Replaces the XLA device loop of the JAX package's `hybrid` backend:
// jpeg_decoder_tpu/ops/entropy_flat.py:decode_emit2 (the emission decoder)
// with ops/entropy_spec.py:_hybrid_pipeline_batch_emit (the scatter into
// scan order through ZIGZAG_INV) and :_dc_prefix_sum_seg (the segmented DC
// prefix sum).  It computes the same function: B images, C lanes each; lane
// (b, j) starts at the true start bit starts[b, j] of MCU m_lo = lane_off /
// (64 * bpm) and decodes nm[b, j] contiguous MCUs of bpm blocks.  The output
// is (B, n_mcus * bpm, 64) int32 natural-order blocks in scan order, DC as
// the prefix sum of the differences per component, reset at every restart
// segment (seg_first[m] is the first MCU of MCU m's segment), wrapping as
// int32 as jnp.cumsum does; plus a (B,) error flag.  An image is flagged,
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
// segments.  The blocks of a flagged image are unspecified (the wrapper's
// callers raise).  An image with no lane (nm all 0: its host walk failed)
// decodes to zeros unflagged, as the JAX function does; its caller knows
// from the plan.
//
// What bounds it: latency, not bytes.  Each lane is a chain of dependent
// probes, a few hundred symbols long in the port's plan
// (ops/entropy_spec.py:device_plan; the JAX plan's ~2,600 suit the TPU);
// the words in and blocks out would take microseconds at HBM rate.  The
// TPU form decodes two symbols per step into a (T, 2, S) tape and scatters
// it after the loop, to amortise the TPU's loop overhead; a GPU thread has
// no such overhead, so here:
//  1. emit_kernel: one thread per lane, one symbol per iteration (K2's
//     reader and probe: a 64-bit buffer with guarded shifts, every word read
//     bounds-checked against the image's pool, first-level tables staged in
//     shared memory), each coefficient stored straight at its natural index
//     in the zero-filled output (lanes own disjoint MCU ranges: no atomics),
//     DC as a lane-local running sum per component; the lane's final sums
//     go to `tot`.
//  2. The carry, the scheme of K2's offsets_kernel: scan_kernel (one CTA per
//     image) replaces `tot` by its exclusive sum over each run of lanes in
//     one restart segment, and apply_kernel (one CTA per lane) adds that
//     carry-in to the lane's blocks' DC terms.
// Bit offsets and output offsets are int64: a >= 50 MP frame or a large
// batch does not wrap (the JAX lanes keep them in int32).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kL1Bits = 12;                 // first-level table index bits
constexpr int kL1Size = 1 << kL1Bits;
constexpr int kMaxTables = 8;               // 2 * at most 4 components
constexpr int kLanes = 64;                  // lanes (threads) per emit CTA
constexpr int kScanThreads = 256;           // lanes per scan tile
constexpr int kApplyThreads = 64;           // threads per apply CTA

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
  const int32_t* seg_first;   // (n_mcus,) first MCU of each MCU's segment
  const int32_t* luts;        // (n_tables, 65536)
  const int16_t* l1;          // (n_tables, kL1Size)
  int32_t* out;               // (B, n_mcus * bpm, 64), zero-filled
  int32_t* err;               // (B,), zero-filled
  uint32_t* tot;              // (B * C, 4) lane DC sums, zero-filled
  int64_t n_img, n_words, n_lanes, n_mcus, trips;
  uint64_t comp_code;         // component of block k in bits 4k..4k+3
  int lanes_per_img, n_tables, bpm, max_dc, max_ac;
};

// MSB-first reader over one image's words, K2's (csrc/entropy.cu).
// Invariant after refill(): 33 <= nbits <= 64 valid bits, left-aligned in
// buf, zeros below them; pf holds word `next`, loaded one refill ahead.
// Words outside [0, n_words) read as zero (never out of bounds).
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
  // n <= 31 at every call site (code <= 16 bits, then value <= 15 bits).
  __device__ __forceinline__ void skip(int n) {
    buf <<= n;
    nbits -= n;
  }
  // The next n bits as an unsigned value; n == 0 reads nothing.
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

// LUT entry for table t at the 16-bit window p: first level in shared
// memory, the full table in device memory on a miss.
__device__ __forceinline__ int32_t probe(const int16_t* l1,
                                         const int32_t* __restrict__ luts,
                                         int t, uint32_t p) {
  const int32_t e = l1[t * kL1Size + (p >> (16 - kL1Bits))];
  return e != 0 ? e : __ldg(luts + static_cast<int64_t>(t) * 65536 + p);
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

// Lane g's first MCU, or -1 when its plan is malformed: lane_off is not an
// MCU start or the lane runs past n_mcus.  nm must be > 0.
__device__ __forceinline__ int64_t first_mcu(const Params& p, int64_t g) {
  const int64_t per_mcu = 64LL * p.bpm;
  const int64_t off = p.lane_off[g];
  if (off < 0 || off % per_mcu != 0) return -1;
  const int64_t m = off / per_mcu;
  return m + p.nm[g] <= p.n_mcus ? m : -1;
}

// Whether lane g = (b, j) is part of a plan that tiles the image's MCUs in
// order: lane 0 starts at MCU 0, each lane ends where the next one starts,
// and the last lane with MCUs ends at n_mcus; and whether its MCUs lie in
// one restart segment (its last MCU's segment starts where its first's
// does: segments are runs of MCUs).
__device__ __forceinline__ bool tiles(const Params& p, int64_t g, int64_t j,
                                      int64_t m_lo) {
  if (j == 0 ? m_lo != 0 : p.nm[g - 1] <= 0) return false;
  const int64_t end = m_lo + p.nm[g];
  if (p.seg_first[end - 1] != p.seg_first[m_lo]) return false;
  if (j + 1 < p.lanes_per_img && p.nm[g + 1] > 0)
    return first_mcu(p, g + 1) == end;
  return end == p.n_mcus;
}

__global__ void __launch_bounds__(kLanes) emit_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* s_l1 = reinterpret_cast<int16_t*>(smem);
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  const bool live = g < p.n_lanes && p.nm[g] > 0;
  if (!__syncthreads_or(live)) return;        // the whole CTA leaves at once
  stage_tables(s_l1, p.l1, p.n_tables);
  if (!live) return;

  const int64_t b = g / p.lanes_per_img, j = g % p.lanes_per_img;
  const int64_t m_lo = first_mcu(p, g);
  if (m_lo < 0 || !tiles(p, g, j, m_lo)) {
    p.err[b] = 1;
    return;
  }
  const int64_t n_blocks = static_cast<int64_t>(p.nm[g]) * p.bpm;
  int32_t* lane_out =
      p.out + (b * p.n_mcus * p.bpm + m_lo * p.bpm) * 64;
  BitReader br{p.pools + b * p.n_words, p.n_words, 0, 0, 0, 0};
  br.seek(p.starts[g]);
  uint32_t run0 = 0u, run1 = 0u, run2 = 0u, run3 = 0u;
  int64_t blk = 0;
  int k = 0, i = 0;
  bool bad = false;
  for (int64_t t = 0; t < p.trips && blk < n_blocks; ++t) {
    br.refill();
    const int ci = static_cast<int>((p.comp_code >> (4 * k)) & 0xF);
    const bool dc = i == 0;
    const int32_t e = probe(s_l1, p.luts, 2 * ci + (dc ? 0 : 1), br.peek16());
    // An entry is 0 or has a code length of 1..16 (huffman.build_lut).
    const int len = e & 31;
    if (len == 0) {
      bad = true;
      break;
    }
    const int sym = e >> 5;
    int size, i2, at = -1;
    if (dc) {
      if (sym > p.max_dc) {
        bad = true;
        break;
      }
      size = sym;
      i2 = 1;
    } else if (sym == 0) {                     // EOB
      size = 0;
      i2 = 64;
    } else {
      const int run = sym == 0xF0 ? 16 : sym >> 4;
      const int csize = sym & 0x0F;
      const int i_new = i + run;
      if (i_new > 64 || (csize > 0 && i_new >= 64) || csize > p.max_ac) {
        bad = true;
        break;
      }
      size = csize;
      if (csize > 0) {
        at = kZigzag[i_new];
        i2 = i_new + 1;
      } else {
        i2 = i_new;                            // ZRL
      }
    }
    br.skip(len);
    const int32_t val = extend(br.bits(size), size);
    int32_t* dst = lane_out + blk * 64;
    if (dc) {
      const uint32_t v = static_cast<uint32_t>(val);
      uint32_t r = ci == 0 ? run0 : ci == 1 ? run1 : ci == 2 ? run2 : run3;
      r += v;                                  // wraps as int32
      run0 = ci == 0 ? r : run0;
      run1 = ci == 1 ? r : run1;
      run2 = ci == 2 ? r : run2;
      run3 = ci == 3 ? r : run3;
      dst[0] = static_cast<int32_t>(r);
    } else if (at >= 0) {
      dst[at] = val;
    }
    if (i2 >= 64) {                            // the block is complete
      i = 0;
      k = k + 1 == p.bpm ? 0 : k + 1;
      ++blk;
    } else {
      i = i2;
    }
  }
  if (bad || blk < n_blocks) p.err[b] = 1;
  uint32_t* tot = p.tot + g * 4;
  tot[0] = run0;
  tot[1] = run1;
  tot[2] = run2;
  tot[3] = run3;
}

// Lane g's segment for the carry: the first MCU of its restart segment, or
// -1 for a lane without MCUs or with a malformed plan (a run of its own).
__device__ __forceinline__ int64_t seg_key(const Params& p, int64_t g) {
  if (p.nm[g] <= 0) return -1;
  const int64_t m = first_mcu(p, g);
  return m < 0 ? -1 : p.seg_first[m];
}

// One CTA per image: the exclusive sum of the lane DC sums over each run of
// lanes in one restart segment (lanes of a valid plan are in MCU order), in
// place of `tot`.  Tiles of kScanThreads lanes, a segmented Hillis-Steele
// scan in shared memory per tile, the running sum carried across tiles;
// uint32 sums wrap as int32.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(Params p) {
  __shared__ uint32_t s_val[4][kScanThreads];
  __shared__ int s_head[kScanThreads];
  const int tid = threadIdx.x;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * p.lanes_per_img;
  uint32_t carry[4] = {0u, 0u, 0u, 0u};   // the run ending the last tile
  for (int64_t base = 0; base < p.lanes_per_img; base += kScanThreads) {
    const int64_t j = base + tid;
    const bool in = j < p.lanes_per_img;
    const int64_t key = in ? seg_key(p, g0 + j) : -1;
    int head = !in || j == 0 || key < 0 || key != seg_key(p, g0 + j - 1);
    uint32_t own[4], v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      own[c] = in ? p.tot[(g0 + j) * 4 + c] : 0u;
      v[c] = own[c];
    }
    for (int off = 1; off < kScanThreads; off <<= 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s_val[c][tid] = v[c];
      s_head[tid] = head;
      __syncthreads();
      if (tid >= off && !head) {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] += s_val[c][tid - off];
        head = s_head[tid - off];
      }
      __syncthreads();
    }
    // No run start at or before this lane in the tile: its run began in an
    // earlier tile.
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] += head ? 0u : carry[c];
    if (in) {
#pragma unroll
      for (int c = 0; c < 4; ++c) p.tot[(g0 + j) * 4 + c] = v[c] - own[c];
    }
    if (tid == kScanThreads - 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s_val[c][0] = v[c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 4; ++c) carry[c] = s_val[c][0];
    __syncthreads();
  }
}

// One CTA per lane g: its carry-in (scan_kernel's `tot`) added to its
// blocks' DC terms.
__global__ void __launch_bounds__(kApplyThreads) apply_kernel(Params p) {
  const int64_t g = blockIdx.x;
  if (p.nm[g] <= 0) return;
  const int64_t m_lo = first_mcu(p, g);
  if (m_lo < 0) return;
  const uint32_t* carry = p.tot + g * 4;
  if ((carry[0] | carry[1] | carry[2] | carry[3]) == 0u) return;
  const int64_t b = g / p.lanes_per_img;
  const int64_t n_blocks = static_cast<int64_t>(p.nm[g]) * p.bpm;
  int32_t* lane_out = p.out + (b * p.n_mcus * p.bpm + m_lo * p.bpm) * 64;
  for (int64_t q = threadIdx.x; q < n_blocks; q += kApplyThreads) {
    const int ci = static_cast<int>((p.comp_code >> (4 * (q % p.bpm))) & 0xF);
    int32_t* dc = lane_out + q * 64;
    *dc = static_cast<int32_t>(static_cast<uint32_t>(*dc) + carry[ci]);
  }
}

unsigned blocks_for(int64_t threads, int per_block) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

bool fill(Params& p, const void* pools, const void* starts, const void* nm,
          const void* lane_off, const void* seg_first, const void* luts,
          const void* l1, void* out, void* err, void* tot, int64_t n_img,
          int64_t n_words, int64_t lanes_per_img, int64_t n_mcus,
          int64_t trips, int n_tables, int bpm, uint64_t comp_code,
          int precision) {
  if (n_img < 1 || n_words < 1 || lanes_per_img < 1 || n_mcus < 1 ||
      trips < 0 || n_tables < 2 || n_tables > kMaxTables || bpm < 1 ||
      bpm > 16 || (precision != 8 && precision != 12))
    return false;
  p.pools = static_cast<const uint32_t*>(pools);
  p.starts = static_cast<const int32_t*>(starts);
  p.nm = static_cast<const int32_t*>(nm);
  p.lane_off = static_cast<const int64_t*>(lane_off);
  p.seg_first = static_cast<const int32_t*>(seg_first);
  p.luts = static_cast<const int32_t*>(luts);
  p.l1 = static_cast<const int16_t*>(l1);
  p.out = static_cast<int32_t*>(out);
  p.err = static_cast<int32_t*>(err);
  p.tot = static_cast<uint32_t*>(tot);
  p.n_img = n_img;
  p.n_words = n_words;
  p.lanes_per_img = static_cast<int>(lanes_per_img);
  p.n_lanes = n_img * lanes_per_img;
  p.n_mcus = n_mcus;
  p.trips = trips;
  p.comp_code = comp_code;
  p.n_tables = n_tables;
  p.bpm = bpm;
  p.max_dc = precision == 12 ? 15 : 11;
  p.max_ac = precision == 12 ? 14 : 10;
  return lanes_per_img <= 0x7fffffff;
}

}  // namespace

// The arguments of both entry points, in order: pools (n_img, n_words)
// uint32; starts, nm (n_img, lanes_per_img) int32; lane_off (n_img,
// lanes_per_img) int64; seg_first (n_mcus,) int32; luts (n_tables, 65536)
// int32 with tables 2c (DC) and 2c+1 (AC) of component c and l1 their first
// levels (csrc/entropy.cu's jd_build_l1); out (n_img, n_mcus * bpm, 64)
// int32, err (n_img,) int32 and tot (n_img * lanes_per_img, 4) int32, all
// zero-filled before jd_emit_decode; trips: the symbols a lane may decode;
// comp_code: the component of within-MCU block k in bits 4k..4k+3;
// precision: 8 or 12.  All on the current device (the wrapper checks
// this).  Each launches its kernel on `stream` and returns the CUDA error
// of the launch (0 = launched).

// Phase 1: decode every lane, DC as lane-local sums, the sums to tot.
extern "C" int jd_emit_decode(const void* pools, const void* starts,
                              const void* nm, const void* lane_off,
                              const void* seg_first, const void* luts,
                              const void* l1, void* out, void* err, void* tot,
                              int64_t n_img, int64_t n_words,
                              int64_t lanes_per_img, int64_t n_mcus,
                              int64_t trips, int n_tables, int bpm,
                              uint64_t comp_code, int precision,
                              void* stream) {
  Params p;
  if (!fill(p, pools, starts, nm, lane_off, seg_first, luts, l1, out, err,
            tot, n_img, n_words, lanes_per_img, n_mcus, trips, n_tables, bpm,
            comp_code, precision))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n_tables) * kL1Size *
                      sizeof(int16_t);
  cudaError_t rc = cudaFuncSetAttribute(
      emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  emit_kernel<<<blocks_for(p.n_lanes, kLanes), kLanes, smem,
                static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Phase 2: each lane's DC carry-in within its restart segment (the scan,
// then the apply launch); `tot` holds the carry-ins after it.
extern "C" int jd_emit_carry(const void* pools, const void* starts,
                             const void* nm, const void* lane_off,
                             const void* seg_first, const void* luts,
                             const void* l1, void* out, void* err, void* tot,
                             int64_t n_img, int64_t n_words,
                             int64_t lanes_per_img, int64_t n_mcus,
                             int64_t trips, int n_tables, int bpm,
                             uint64_t comp_code, int precision,
                             void* stream) {
  Params p;
  if (!fill(p, pools, starts, nm, lane_off, seg_first, luts, l1, out, err,
            tot, n_img, n_words, lanes_per_img, n_mcus, trips, n_tables, bpm,
            comp_code, precision) ||
      p.n_lanes > 0x7fffffff || p.n_img > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  scan_kernel<<<static_cast<unsigned>(p.n_img), kScanThreads, 0, st>>>(p);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  apply_kernel<<<static_cast<unsigned>(p.n_lanes), kApplyThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
