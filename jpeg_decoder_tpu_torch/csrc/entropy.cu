// Huffman decode of baseline restart segments, hand-written for Hopper
// (sm_90a), bound to PyTorch through a plain C entry point and ctypes.
//
// Replaces the TPU kernel jpeg_decoder_tpu/ops/entropy_pallas.py:
// decode_segments_pallas (body _segment_body / _decode_block / _peek16 /
// _lut_at).  It computes the same function: for every restart segment s,
// decode nm[s] MCUs of bpm blocks each from the segment's big-endian 32-bit
// words, with the 16-bit LUT probe (entry = (symbol << 5) | code length,
// 0 = invalid), DC predictors per component reset at the segment start,
// EOB / ZRL run lengths, and the error conditions of the Pallas kernel:
//   DC: entry == 0, size > 11
//   AC: entry == 0, i+run > 64, (size > 0 and i+run >= 64), size > 10.
// Each coefficient is written at its natural index ZIGZAG[i] (the Pallas
// wrapper's take(out, ZIGZAG_INV) is folded in).  The output is zero-filled
// by the caller, so only the DC and the non-zero AC terms are stored.  At a
// segment's first error the lane stops and raises its flag; the rows of a
// flagged segment are unspecified (the wrapper raises on any flag).
//
// What bounds it: latency, not bytes.  Each lane is a serial chain of
// dependent probes (the position of the next code depends on the length of
// this one), about 30 per 8x8 block at photo qualities; the bytes it moves
// (compressed words in, n_blocks * 256 B out) would take microseconds at
// HBM rate.  What the design does about it:
//  * one thread per restart segment, all segments at once (the TPU grid
//    walked them one by one, with a one-hot lane extract per probe because
//    Mosaic cannot index lanes dynamically: here a probe is a plain load);
//  * a 64-bit bit buffer in registers, refilled one word at a time, so a
//    probe is a shift, not two word loads and a funnel shift as in _peek16;
//  * the LUTs' first level in shared memory, built by each CTA from the
//    full tables: entry i of a 4,096-entry int16 table is lut[i << 4] when
//    that code is <= 12 bits long (it then covers all 16 windows i<<4..+15),
//    else 0 (the full 65,536-entry int32 table, 256 KB, does not fit next
//    to five others); only longer codes and invalid windows probe the full
//    table in device memory, where it stays L2-resident.
// Parallelism is the number of segments: a DRI=0 stream is one lane (slow,
// but exact).  Not yet done (later work): splitting long segments, and
// keeping more than one block's state per lane to hide probe latency.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kL1Bits = 12;                 // first-level table index bits
constexpr int kL1Size = 1 << kL1Bits;
constexpr int kMaxTables = 8;               // 2 * at most 4 components

__device__ const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// MSB-first reader over one segment's words.  Invariant after refill():
// 33 <= nbits <= 64 valid bits, left-aligned in buf, zeros below them.
// Words at or past n_words read as zero (never out of bounds).
struct BitReader {
  const uint32_t* words;
  int64_t n_words;
  int64_t next;       // index of the next word to load
  uint64_t buf;
  int nbits;

  __device__ uint32_t word(int64_t w) const {
    return w < n_words ? words[w] : 0u;
  }
  __device__ void init() {
    buf = (static_cast<uint64_t>(word(0)) << 32) | word(1);
    next = 2;
    nbits = 64;
  }
  __device__ void refill() {
    if (nbits <= 32) {   // shift in [0, 32]: defined for a 64-bit value
      buf |= static_cast<uint64_t>(word(next)) << (32 - nbits);
      ++next;
      nbits += 32;
    }
  }
  __device__ uint32_t peek16() const {
    return static_cast<uint32_t>(buf >> 48);
  }
  // n <= 27 at every call site (code <= 16 bits, then value <= 11 bits).
  __device__ void skip(int n) {
    buf <<= n;
    nbits -= n;
  }
  // The next n bits as an unsigned value; n == 0 reads nothing (a shift
  // by 64 would be undefined).
  __device__ int32_t bits(int n) {
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
// memory, full table in device memory on a miss (long code or invalid).
__device__ __forceinline__ int32_t probe(const int16_t* s_l1,
                                         const int32_t* __restrict__ luts,
                                         int t, uint32_t p) {
  const int32_t e = s_l1[t * kL1Size + (p >> (16 - kL1Bits))];
  return e != 0 ? e : luts[static_cast<int64_t>(t) * 65536 + p];
}

__global__ void __launch_bounds__(kThreads)
decode_segments_kernel(const uint32_t* __restrict__ words,   // (S, W)
                       const int32_t* __restrict__ seg_nmcus, // (S,)
                       const int32_t* __restrict__ luts,      // (T, 65536)
                       int32_t* __restrict__ out,   // (S, rows, 64), zeroed
                       int32_t* __restrict__ err,   // (S,)
                       int64_t n_seg, int64_t n_words, int64_t rows,
                       int n_tables, int bpm, uint64_t comp_code) {
  extern __shared__ int16_t s_l1[];   // (n_tables, 4096)
  for (int i = threadIdx.x; i < n_tables * kL1Size; i += blockDim.x) {
    const int32_t e = luts[static_cast<int64_t>(i >> kL1Bits) * 65536 +
                           ((i & (kL1Size - 1)) << (16 - kL1Bits))];
    const int len = e & 31;
    // (symbol << 5) | length <= 8191 fits an int16.
    s_l1[i] = (len > 0 && len <= kL1Bits) ? static_cast<int16_t>(e) : 0;
  }
  __syncthreads();

  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_seg) return;

  BitReader br{words + s * n_words, n_words, 0, 0, 0};
  br.init();
  int32_t* seg_out = out + s * rows * 64;
  int32_t pred[kMaxTables / 2] = {0, 0, 0, 0};
  // At most rows / bpm MCUs fit the segment's output rows.
  const int64_t nm = seg_nmcus[s] < rows / bpm ? seg_nmcus[s] : rows / bpm;
  int bad = 0;

  for (int64_t m = 0; m < nm && !bad; ++m) {
    for (int k = 0; k < bpm; ++k) {
      const int ci = static_cast<int>((comp_code >> (4 * k)) & 0xF);
      int32_t* blk = seg_out + (m * bpm + k) * 64;

      // DC: code, then `size` value bits.
      br.refill();
      int32_t e = probe(s_l1, luts, 2 * ci, br.peek16());
      int size = e >> 5;
      if (e == 0 || size > 11) { bad = 1; break; }
      br.skip(e & 31);
      pred[ci] += extend(br.bits(size), size);
      blk[0] = pred[ci];

      // AC: (run, size) symbols until EOB or the block is full.
      int i = 1;
      while (i < 64) {
        br.refill();
        e = probe(s_l1, luts, 2 * ci + 1, br.peek16());
        if (e == 0) { bad = 1; break; }
        br.skip(e & 31);
        const int sym = e >> 5;
        if (sym == 0x00) break;                        // EOB
        const int run = sym == 0xF0 ? 16 : sym >> 4;
        const int csize = sym & 0x0F;
        const int i_new = i + run;
        if (i_new > 64 || (csize > 0 && i_new >= 64) || csize > 10) {
          bad = 1;
          break;
        }
        if (csize > 0) {
          blk[kZigzag[i_new]] = extend(br.bits(csize), csize);
          i = i_new + 1;
        } else {
          i = i_new;                                   // ZRL
        }
      }
      if (bad) break;
    }
  }
  err[s] = bad;
}

}  // namespace

// words: (n_seg, n_words) uint32 big-endian stream words; seg_nmcus: (n_seg,)
// int32; luts: (n_tables, 65536) int32 with tables 2c (DC) and 2c+1 (AC) of
// component c; out: (n_seg, rows, 64) int32, zero-filled, rows >= bpm;
// err: (n_seg,) int32.  comp_code holds the component of within-MCU block k
// in bits 4k..4k+3 (bpm <= 16).  All on the current device (the wrapper
// checks this).  Launches on `stream` and returns cudaGetLastError().
extern "C" int jd_decode_segments(const void* words, const void* seg_nmcus,
                                  const void* luts, void* out, void* err,
                                  int64_t n_seg, int64_t n_words, int64_t rows,
                                  int n_tables, int bpm, uint64_t comp_code,
                                  void* stream) {
  if (n_seg <= 0) return 0;
  if (n_tables < 2 || n_tables > kMaxTables || bpm < 1 || bpm > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(n_tables) * kL1Size * sizeof(int16_t);
  cudaError_t rc = cudaFuncSetAttribute(
      decode_segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned grid =
      static_cast<unsigned>((n_seg + kThreads - 1) / kThreads);
  decode_segments_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(seg_nmcus),
      static_cast<const int32_t*>(luts), static_cast<int32_t*>(out),
      static_cast<int32_t*>(err), n_seg, n_words, rows, n_tables, bpm,
      comp_code);
  return static_cast<int>(cudaGetLastError());
}
