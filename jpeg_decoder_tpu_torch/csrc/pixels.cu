// K6a and K6b: the device pixel stage of the batch routes, hand-written for
// Hopper (sm_90a), bound to PyTorch through plain C entry points and ctypes.
//
// K6a, the nibble wire to blocks.  Replaces the XLA code of
// jpeg_decoder_tpu/models/batch.py:256 _batched_from_nibble (its `one`,
// :266): decode each entry byte e (g = e >> 4, v = e & 15; advance 16 g
// where v == 0, else g), prefix-sum the advances into positions (minus 1),
// take v == 8's value from the overflow stream at the rank given by a second
// prefix sum, ADD every value at its position (a 0x00 filler re-adds 0 at
// the last real position: a store would wipe the value there), drop the
// positions outside [0, n_blk * 64), then SET the escapes, then set DC of
// blocks [0, n_blk); block n_blk stays 0 (the fill block).  With a trim
// (ops/pixels_cuda.py: n_img, n_rows) only the first n_img rows and n_keep
// = n_rows blocks of each take part: the reference on the wire cut to
// them, which is the whole output's [:n_img, :n_keep + 1] wherever that
// is zero at block n_keep (the routes' n_keep covers every image's
// blocks).
//   Bound: bytes.  It reads the wire once and writes the (n_img, n_keep +
// 1, 64) int32 blocks once, zeros included.
//   Design: three launches on the caller's stream; each output element is
// written once, from shared memory, and no pass zero-fills the output or
// adds in device memory.  The entries of a row are cut into chunks of
// 4,096 (256 threads x 16, one 16-byte load a thread).  (1) Each chunk's
// advance and overflow totals and whether any entry carries a value; extra
// CTAs check that each row's escapes do not fall (keys max(idx, -1)).
// (2) One CTA a row scans the totals into each chunk's first position and
// rank.  (3) One CTA a window of kWindow output positions: zeros and DC
// into shared memory; a warp's 32-way search of the chunk bases finds the
// chunks whose entries land in the window (positions never fall along a
// row, so they are a run; a chunk that advances nowhere and carries no
// value is skipped, so a row's tail of fillers costs a look at its
// totals); each such chunk is loaded and scanned again, and its entries
// that land in the window add with shared-memory atomics (an entry that
// advances 0 adds at the position before its chunk's, in its window, so a
// chunk's lead needs no special case); then the escapes in the window are
// set (a second warp's search of the row's escapes, or all of them where
// they fall); then the window goes out in coalesced 16-byte stores.  DC is
// set last in the reference, so no add or escape may touch a DC slot of a
// block below n_keep: those are skipped, which leaves its result.  A
// window reads each chunk that reaches it, so wire bytes are read about
// twice from L2 where a chunk spans two windows.
// Positions are 64-bit in registers; no index tensor is built.
//   Its first form, kept as the same-card baseline jd_unpack_nibble_v1:
// the whole output written with zeros and DC, chunk totals, then each
// chunk's adds as 32-bit atomics in device memory (every one a
// read-modify-write of a sector long out of L2), then the escapes.
//
// K6b, scan-order blocks to RGB in one pass.  Replaces
// jpeg_decoder_tpu/models/batch.py:52 _planes_from_blocks_dyn and :82
// _rgb_one_dyn, i.e. ops/pixel.py:325 pixel_pipeline_impl: dequantise and
// IDCT (:55 dequantize; K1's arithmetic, idct_pallas.py:55, under `pallas`
// and `kron`, the Pallas kernel's XLA twin; K5's, pixel.py:123, under
// `exact`; under `fast` the separable form of :135 idct_fast,
// idct_common.cuh), crop each component to its unpadded sample grid at the
// bucket's dims, upsample (:200 upsample_fancy, edge replication at each
// image's true edge; :157 upsample_nn, and for ratios outside {1, 2}),
// colour (:253 _ycbcr_channels, :283 gray_to_rgb, :289 _level_shift_u8,
// :293 cmyk_to_rgb, :307 decoded_to_cmyk) into the whole (B, H, W, 3)
// output, padding included.
//   Bound: bytes.  It reads the blocks each image's geometry covers once and
// writes the output once; the IDCT is some 32 FLOP a sample.
//   Design: persistent CTAs of 256 threads (ops/pixels_cuda.py:CTAS_PER_SM a
// multiprocessor; kCtas and its kin cap the registers to match) walk the
// group's output tiles of about 64 x 64 pixels (whole MCUs;
// ops/pixels_cuda.py:TILE), tile i, i + grid, ... .  Phase 1 computes, for each component, the samples of
// every block the tile's pixels reach, the fancy filter's one-sample halo
// included (the neighbouring tile computes those halo blocks again), into a
// window of int32 samples in shared memory: eight threads a block, a round
// of 32 blocks at a time; each block's source row comes from the image's
// geometry in closed form (a cell outside it is a zero block).  Under
// `exact` and `fast` the blocks reach shared memory through each warp's own
// ring of two stages: the warp issues cp.async copies (16 bytes a thread,
// 256 a block) of its next round's four blocks into one stage while it
// transforms the round in the other, and a stage's mbarrier
// (cp.async.mbarrier.arrive.noinc) says when its copies have landed, so no
// round waits on the CTA.  Under `pallas` and `kron` K1's transform and
// recheck need the registers the ring would hold (with it they spilled and
// ran slower), and each octet loads its block as idct.cu does.  The tile's
// geometry lives in shared memory and a component's values are picked, not
// indexed, so no per-component array lives in local memory.  A tile whose windows reach
// no block of the geometry (bucket padding) skips phase 1 and gives every
// pixel the colour of zero samples.  Phase 2 gives each thread a column of
// the tile and every (256 / tile width)-th row: the upsampled sample of
// each component from the windows through its column offsets and the
// tile's row table (no division a pixel), the colour transform in the
// reference's float32 op order with uncontracted __fmul_rn / __fadd_rn,
// clamp, truncate, and three stores a pixel, which the threads of a warp
// make to consecutive bytes.  No plane is written to device memory.
//   Its first form, kept as the same-card baseline
// jd_blocks_to_rgb_v1: one CTA per tile, a round's blocks loaded
// synchronously, the samples of `kron` and `fast` from a torch product
// before the launch (ops/pixels_cuda.py:scan_samples), a division a pixel,
// and every padding pixel computed.

#include <cstdint>

#include <cuda_runtime.h>

#include "idct_common.cuh"   // K1's, K5's and fast's per-block arithmetic

namespace {

// ---- K6a: nibble wire -> blocks ---------------------------------------

constexpr int kUnpackThreads = 256;
constexpr int kPerThread = 16;                          // one 16-byte load
constexpr int kChunk = kUnpackThreads * kPerThread;    // entries per chunk
constexpr int kWarpsPerCta = kUnpackThreads / 32;
// Output positions a CTA of the window pass builds in shared memory (64 KB
// of dynamic shared memory; a multiple of 64, so windows hold whole
// blocks).  The fastest of 4,096 to 24,576 in testing/pixel_variants.py's
// runs.
constexpr int kWindow = 16384;
constexpr int kWindowBytes = kWindow * 4;
// K6a's variants, for testing/pixel_variants.py (which builds copies of
// this file with another value): 0 the kernel as it is, 1 passes 1 and 2
// alone, 2 the window pass's zeros and DC alone (no search, add or
// escape), 3 the window pass without its stores.
constexpr int kUnpackVariant = 0;
// Window CTAs a multiprocessor that __launch_bounds__ caps the registers
// for: 3 (80 registers, no spill; 3 windows fill 192 KB of shared memory),
// the fastest of 2 to 5 in testing/pixel_variants.py's runs.
constexpr int kUnpackCtas = 3;

struct NibbleArgs {
  const int16_t* dc16;    // (B, n_blk)
  const uint8_t* e;       // (B, K)
  const int8_t* ov;       // (B, O)
  const int32_t* esc_idx;  // (B, E)
  const int16_t* esc_val;  // (B, E)
  int32_t* out;           // (n_img, n_keep + 1, 64); the first form's
                          // (B, n_blk + 1, 64)
  int32_t* agg;           // first form: (B, n_chunks, 2) advance, overflow
  int4* rec;              // (n_img, n_chunks): advance and overflow
                          // totals, any value
  longlong2* base;        // (n_img, n_chunks + 1): position and rank
                          // before each chunk, the row's totals last
  int32_t* flags;         // (n_img, n_esc_ctas + 1): escapes that fall,
                          // per CTA, the row's last
  int64_t n_blk, k, o, n_esc, n_chunks;
  int64_t n_keep;         // blocks that take values (<= n_blk)
  int64_t n_esc_ctas;     // CTAs of pass 1 that check escapes
  int vec;                // rows start on 16-byte boundaries
};

// This thread's 16 entries of chunk `chunk` of row b (0 past the row's end:
// a 0x00 filler advances 0 and adds 0).
__device__ __forceinline__ void load_entries(const NibbleArgs& a, int64_t b,
                                             int64_t chunk,
                                             uint8_t (&v)[kPerThread]) {
  const int64_t first =
      chunk * kChunk + static_cast<int64_t>(threadIdx.x) * kPerThread;
  const uint8_t* row = a.e + b * a.k;
  if (a.vec && first + kPerThread <= a.k) {
    const int4 w = *reinterpret_cast<const int4*>(row + first);
    const int32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      v[i] = static_cast<uint8_t>(words[i >> 2] >> (8 * (i & 3)));
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      v[i] = first + i < a.k ? row[first + i] : 0;
  }
}

// The same 16 entries as four little-endian words (entry i in byte i & 3
// of word i >> 2): four registers where the window pass keeps them.
__device__ __forceinline__ void load_words(const NibbleArgs& a, int64_t b,
                                           int64_t chunk,
                                           uint32_t (&w)[kPerThread / 4]) {
  const int64_t first =
      chunk * kChunk + static_cast<int64_t>(threadIdx.x) * kPerThread;
  const uint8_t* row = a.e + b * a.k;
  if (a.vec && first + kPerThread <= a.k) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + first);
    w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread / 4; ++j) {
      w[j] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (first + 4 * j + i < a.k)
          w[j] |= static_cast<uint32_t>(row[first + 4 * j + i]) << (8 * i);
    }
  }
}

__device__ __forceinline__ int advance(uint8_t e) {
  const int g = e >> 4, vc = e & 15;
  return vc == 0 ? g * 16 : g;
}

// Block-wide exclusive scan of two ints (each CTA's own totals fit int32:
// at most 4,096 x 240).  Returns the CTA's totals.  Every thread calls it.
__device__ __forceinline__ int2 block_scan2(int a, int b, int& ea, int& eb) {
  __shared__ int2 warp_tot[kWarpsPerCta];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ya = __shfl_up_sync(kFullMask, ia, off);
    const int yb = __shfl_up_sync(kFullMask, ib, off);
    if (lane >= off) ia += ya, ib += yb;
  }
  if (lane == 31) warp_tot[warp] = make_int2(ia, ib);
  __syncthreads();
  int pa = 0, pb = 0, ta = 0, tb = 0;
#pragma unroll
  for (int w = 0; w < kWarpsPerCta; ++w) {
    const int2 t = warp_tot[w];
    if (w < warp) pa += t.x, pb += t.y;
    ta += t.x, tb += t.y;
  }
  __syncthreads();   // warp_tot is reused by the next call
  ea = pa + ia - a;
  eb = pb + ib - b;
  return make_int2(ta, tb);
}

// First form, pass 0: zeros and DC, the whole (n_blk + 1, 64) row of each
// image in 16-byte stores.  grid (ceil(units / 1024), B), four stores a
// thread.
__global__ void __launch_bounds__(kUnpackThreads)
    nibble_fill(NibbleArgs a) {
  const int64_t b = blockIdx.y;
  const int64_t units = (a.n_blk + 1) * 16;     // int4s of a row
  int4* out = reinterpret_cast<int4*>(a.out + b * (a.n_blk + 1) * 64);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t u = (static_cast<int64_t>(blockIdx.x) * 4 + k) *
                          kUnpackThreads + threadIdx.x;
    if (u >= units) break;
    const int64_t blk = u >> 4;
    int4 v = make_int4(0, 0, 0, 0);
    if ((u & 15) == 0 && blk < a.n_blk) v.x = a.dc16[b * a.n_blk + blk];
    out[u] = v;
  }
}

// First form, pass 1: each chunk's advance and overflow totals.  grid
// (n_chunks, B).
__global__ void __launch_bounds__(kUnpackThreads)
    nibble_totals(NibbleArgs a) {
  const int64_t b = blockIdx.y, chunk = blockIdx.x;
  uint8_t v[kPerThread];
  load_entries(a, b, chunk, v);
  int adv = 0, n_ov = 0;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    adv += advance(v[i]);
    n_ov += (v[i] & 15) == 8;
  }
  int ea, eb;
  const int2 tot = block_scan2(adv, n_ov, ea, eb);
  if (threadIdx.x == 0) {
    a.agg[(b * a.n_chunks + chunk) * 2] = tot.x;
    a.agg[(b * a.n_chunks + chunk) * 2 + 1] = tot.y;
  }
}

// First form, pass 2: positions and ranks, then the adds.  grid
// (n_chunks, B).
__global__ void __launch_bounds__(kUnpackThreads)
    nibble_scatter(NibbleArgs a) {
  __shared__ long long base_sum[2][kWarpsPerCta];
  const int64_t b = blockIdx.y, chunk = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The totals of the row's chunks before this one.
  long long pos = 0, rank = 0;
  for (int64_t k = threadIdx.x; k < chunk; k += kUnpackThreads) {
    pos += a.agg[(b * a.n_chunks + k) * 2];
    rank += a.agg[(b * a.n_chunks + k) * 2 + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pos += __shfl_xor_sync(kFullMask, pos, off);
    rank += __shfl_xor_sync(kFullMask, rank, off);
  }
  if (lane == 0) base_sum[0][warp] = pos, base_sum[1][warp] = rank;
  __syncthreads();
  pos = 0, rank = 0;
#pragma unroll
  for (int w = 0; w < kWarpsPerCta; ++w)
    pos += base_sum[0][w], rank += base_sum[1][w];

  uint8_t v[kPerThread];
  load_entries(a, b, chunk, v);
  int adv = 0, n_ov = 0;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    adv += advance(v[i]);
    n_ov += (v[i] & 15) == 8;
  }
  int ea, eb;
  block_scan2(adv, n_ov, ea, eb);
  pos += ea;
  rank += eb;
  const int64_t n_coef = a.n_blk * 64;
  int32_t* out = a.out + b * (a.n_blk + 1) * 64;
  const int8_t* ov = a.ov + b * a.o;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int vc = v[i] & 15;
    pos += advance(v[i]);
    int val;
    if (vc == 8) {
      const long long r = rank < 0 ? 0 : (rank >= a.o ? a.o - 1 : rank);
      val = a.o > 0 ? ov[r] : 0;
      ++rank;
    } else {
      val = ((vc + 8) & 15) - 8;
    }
    const long long idx = pos - 1;
    if (val != 0 && idx >= 0 && idx < n_coef && (idx & 63) != 0)
      atomicAdd(out + idx, val);
  }
}

// First form, pass 3: escapes set (off the DC slots).  grid
// (ceil(E / 256), B).
__global__ void __launch_bounds__(kUnpackThreads)
    nibble_escapes(NibbleArgs a) {
  const int64_t b = blockIdx.y;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kUnpackThreads + threadIdx.x;
  int32_t* out = a.out + b * (a.n_blk + 1) * 64;
  if (i < a.n_esc) {
    const int64_t idx = a.esc_idx[b * a.n_esc + i];
    if (idx >= 0 && idx < a.n_blk * 64 && (idx & 63) != 0)
      out[idx] = a.esc_val[b * a.n_esc + i];
  }
}

// An escape's key for the window search: every index below 0 is dropped
// alike.
__device__ __forceinline__ int esc_key(int32_t idx) { return max(idx, -1); }

// Pass 1.  CTAs below n_chunks: a chunk's advance and overflow totals and
// whether any entry carries a value (a value code other than 0).  The rest:
// whether 256 escapes of the row fall anywhere (each against the one
// before it).  grid (n_chunks + n_esc_ctas, n_img).
__global__ void __launch_bounds__(kUnpackThreads)
    unpack_totals(NibbleArgs a) {
  const int64_t b = blockIdx.y;
  if (blockIdx.x < a.n_chunks) {
    const int64_t chunk = blockIdx.x;
    uint8_t v[kPerThread];
    load_entries(a, b, chunk, v);
    int adv = 0, n_ov = 0, live = 0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      adv += advance(v[i]);
      n_ov += (v[i] & 15) == 8;
      live |= (v[i] & 15) != 0;
    }
    int ea, eb;
    const int2 tot = block_scan2(adv, n_ov, ea, eb);
    live = __syncthreads_or(live);
    if (threadIdx.x == 0)
      a.rec[b * a.n_chunks + chunk] = make_int4(tot.x, tot.y, live, 0);
    return;
  }
  const int64_t j = blockIdx.x - a.n_chunks;
  const int64_t i = j * kUnpackThreads + threadIdx.x;
  const int32_t* idx = a.esc_idx + b * a.n_esc;
  const int fall =
      i > 0 && i < a.n_esc && esc_key(idx[i - 1]) > esc_key(idx[i]);
  const int any = __syncthreads_or(fall);
  if (threadIdx.x == 0) a.flags[b * (a.n_esc_ctas + 1) + j] = any;
}

// Pass 2: a row's position and rank before each chunk (an exclusive scan
// of the totals, 256 chunks a step; a step's sums fit int32: 256 x 4,096 x
// 240), its totals after the last, and whether its escapes fall.  grid
// (n_img).
__global__ void __launch_bounds__(kUnpackThreads)
    unpack_bases(NibbleArgs a) {
  const int64_t b = blockIdx.x;
  longlong2* base = a.base + b * (a.n_chunks + 1);
  long long pos = 0, rank = 0;
  for (int64_t c0 = 0; c0 < a.n_chunks; c0 += kUnpackThreads) {
    const int64_t c = c0 + threadIdx.x;
    int t = 0, o = 0;
    if (c < a.n_chunks) {
      const int4 r = a.rec[b * a.n_chunks + c];
      t = r.x, o = r.y;
    }
    int et, eo;
    const int2 tot = block_scan2(t, o, et, eo);
    if (c < a.n_chunks) base[c] = make_longlong2(pos + et, rank + eo);
    pos += tot.x, rank += tot.y;
  }
  if (threadIdx.x == 0) base[a.n_chunks] = make_longlong2(pos, rank);
  int32_t* f = a.flags + b * (a.n_esc_ctas + 1);
  int fall = 0;
  for (int64_t j = threadIdx.x; j < a.n_esc_ctas; j += kUnpackThreads)
    fall |= f[j];
  fall = __syncthreads_or(fall);
  if (threadIdx.x == 0) f[a.n_esc_ctas] = fall;
}

// The first index in [0, n) whose key(i) is >= x, n if none; key must not
// fall.  A 32-way search: each round every lane probes the last index of
// its 32nd of the range.  Every lane of the warp calls it and gets the
// answer.
template <typename Key>
__device__ __forceinline__ int64_t warp_lower_bound(int64_t n, long long x,
                                                    Key key) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;   // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t first = lo + lane * step;
    const bool ge = first < hi && key(min(first + step, hi) - 1) >= x;
    const unsigned m = __ballot_sync(kFullMask, ge);
    if (m == 0) {   // every key of [lo, hi) is below x
      lo = hi;
    } else {        // the answer lies in lane f's part, at or before its end
      const int64_t f_first = lo + (__ffs(m) - 1) * step;
      hi = min(f_first + step, hi) - 1;
      lo = f_first;
    }
  }
  return lo;
}

// Adds the values of chunk `chunk`'s entries that land in [w0, lim), off
// the DC slots, into the window `win` (position w0 first); a chunk that
// advances nowhere and carries no value adds nothing.  The entries, the
// totals and the base are read at once.  Every thread of the CTA calls it.
__device__ __forceinline__ void add_chunk(const NibbleArgs& a, int64_t b,
                                          int64_t chunk, int64_t w0,
                                          int64_t lim, int32_t* win) {
  uint32_t w[kPerThread / 4];
  load_words(a, b, chunk, w);
  const int4 r = a.rec[b * a.n_chunks + chunk];
  const longlong2 base = a.base[b * (a.n_chunks + 1) + chunk];
  if (r.x == 0 && r.z == 0) return;   // alike in every thread
  int adv = 0, n_ov = 0;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const uint8_t e = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
    adv += advance(e);
    n_ov += (e & 15) == 8;
  }
  int ea, eb;
  block_scan2(adv, n_ov, ea, eb);
  long long pos = base.x + ea;   // positions before the thread's entries
  long long rank = base.y + eb;
  // The thread's entries land on [pos - 1, pos + adv - 1].
  if (pos + adv - 1 < w0 || pos - 1 >= lim) return;
  const int8_t* ov = a.ov + b * a.o;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const uint8_t e = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
    const int vc = e & 15;
    pos += advance(e);
    const long long idx = pos - 1;
    const bool in = idx >= w0 && idx < lim && (idx & 63) != 0;
    int val = ((vc + 8) & 15) - 8;
    if (vc == 8) {
      const long long rk = rank < 0 ? 0 : (rank >= a.o ? a.o - 1 : rank);
      val = in && a.o > 0 ? ov[rk] : 0;
      ++rank;
    }
    if (in && val != 0) atomicAdd(win + (idx - w0), val);
  }
}

// Chunks a window takes one after another without first looking at their
// totals (a row's tail of fillers takes the look); 2% faster than always
// looking, in testing/pixel_variants.py's runs.
constexpr int kDirect = 4;
static_assert(kWindow % 64 == 0, "a window holds whole blocks");
// DC values a thread of the window pass holds: block tid + k * 256, k <
// kDcPerThread.
constexpr int kDcPerThread = (kWindow / 64 + kUnpackThreads - 1) /
                             kUnpackThreads;

// Pass 3: window blockIdx.x of row blockIdx.y, whole (see the design note
// at the top).  Every read whose address is known early is issued early:
// the window's DC values first, the searches while the other warps zero
// the window, a thread's escape and a chunk's totals beside its entries.
// grid (ceil((n_keep + 1) * 64 / kWindow), n_img).
__global__ void __launch_bounds__(kUnpackThreads, kUnpackCtas)
    unpack_windows(NibbleArgs a) {
  extern __shared__ __align__(16) int32_t win[];   // kWindow ints
  __shared__ int list[kUnpackThreads];
  __shared__ int n_list;
  __shared__ long long span[4];   // chunks [0, 1), escapes [2, 3)
  const int64_t b = blockIdx.y;
  const int64_t row = (a.n_keep + 1) * 64;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kWindow;
  const int len = static_cast<int>(min(static_cast<int64_t>(kWindow),
                                       row - w0));
  const int64_t lim = min(w0 + len, a.n_keep * 64);   // takes values below
  const int tid = threadIdx.x, warp = tid >> 5;
  // The DC of the window's blocks tid, tid + 256, ..., set last (no add
  // or escape touches a DC slot).
  int dc[kDcPerThread];
#pragma unroll
  for (int k = 0; k < kDcPerThread; ++k) {
    const int j = tid + k * kUnpackThreads;
    const int64_t blk = (w0 >> 6) + j;
    dc[k] = j < len / 64 && blk < a.n_keep ? a.dc16[b * a.n_blk + blk] : 0;
  }

  if (kUnpackVariant == 2) {   // no search: no chunk, no escape
    if (tid == 0) span[0] = span[1] = span[2] = span[3] = 0;
  } else if (warp == 0) {
    // Chunk c's entries land on [base[c] - 1, base[c + 1] - 1]: those of
    // chunks [first, end) reach [w0, lim).
    const longlong2* base = a.base + b * (a.n_chunks + 1);
    const auto at = [base](int64_t j) { return base[j].x; };
    int64_t first = a.n_chunks, end = a.n_chunks;
    if (w0 < lim) {
      first = warp_lower_bound(a.n_chunks + 1, w0 + 1, at) - 1;
      end = min(warp_lower_bound(a.n_chunks + 1, lim + 1, at), a.n_chunks);
    }
    if (tid == 0) span[0] = first, span[1] = end;
  } else if (warp == 1) {
    const int32_t* ei = a.esc_idx + b * a.n_esc;
    const auto key = [ei](int64_t i) { return esc_key(ei[i]); };
    int64_t lo = 0, hi = 0;
    if (w0 < lim) {
      if (a.flags[b * (a.n_esc_ctas + 1) + a.n_esc_ctas]) {
        hi = a.n_esc;   // they fall somewhere: look at all of them
      } else {
        lo = warp_lower_bound(a.n_esc, w0, key);
        hi = warp_lower_bound(a.n_esc, lim, key);
      }
    }
    if (tid == 32) span[2] = lo, span[3] = hi;
  }
  int4* win4 = reinterpret_cast<int4*>(win);
  for (int u = tid; u < len / 4; u += kUnpackThreads)
    win4[u] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // This thread's escape, read before the adds and set after them (when
  // the window has more than one a thread, all are read after).
  const int32_t* ei = a.esc_idx + b * a.n_esc;
  const int16_t* ev = a.esc_val + b * a.n_esc;
  const int64_t e_lo = span[2], e_hi = span[3];
  const bool few = e_hi - e_lo <= kUnpackThreads;
  int64_t e_idx = -1;
  int e_val = 0;
  if (few && e_lo + tid < e_hi)
    e_idx = ei[e_lo + tid], e_val = ev[e_lo + tid];

  // The adds, chunk by chunk; past kDirect chunks, up to 256 a step are
  // looked at and those that advance or carry a value are loaded.
  const int64_t first = span[0], end = span[1];
  if (end - first <= kDirect) {
    for (int64_t c = first; c < end; ++c) add_chunk(a, b, c, w0, lim, win);
  } else {
    for (int64_t c0 = first; c0 < end; c0 += kUnpackThreads) {
      if (tid == 0) n_list = 0;
      __syncthreads();
      const int64_t c = c0 + tid;
      if (c < end) {
        const int4 r = a.rec[b * a.n_chunks + c];
        if (r.x > 0 || r.z) list[atomicAdd(&n_list, 1)] = tid;
      }
      __syncthreads();
      const int n = n_list;
      for (int k = 0; k < n; ++k) add_chunk(a, b, c0 + list[k], w0, lim, win);
      __syncthreads();   // n_list is reset next step
    }
  }
  __syncthreads();   // the adds are in

  // The escapes set, after the adds; then DC.
  if (few) {
    if (e_idx >= w0 && e_idx < lim && (e_idx & 63) != 0)
      win[e_idx - w0] = e_val;
  } else {
    for (int64_t i = e_lo + tid; i < e_hi; i += kUnpackThreads) {
      const int64_t idx = ei[i];
      if (idx >= w0 && idx < lim && (idx & 63) != 0) win[idx - w0] = ev[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kDcPerThread; ++k) {
    const int j = tid + k * kUnpackThreads;
    if (j < len / 64) win[j * 64] = dc[k];
  }
  __syncthreads();

  if (kUnpackVariant == 3) return;
  int4* out4 = reinterpret_cast<int4*>(a.out + b * row + w0);
  for (int u = tid; u < len / 4; u += kUnpackThreads) __stcs(out4 + u, win4[u]);
}

// ---- K6b: scan-order blocks -> RGB ------------------------------------

constexpr int kPixThreads = 256;
constexpr int kOctets = kPixThreads / 8;   // blocks a round of IDCTs
constexpr int kMaxComps = 4;
constexpr int kPad = 72;                   // floats per block, padded

// `kron` runs K1's arithmetic (kPallas); kSamples is the first form's
// mode for samples made before the launch.
enum Mode { kPallas = 0, kExact = 1, kSamples = 2, kFast = 3 };
enum Colour { kGray = 0, kYCbCr = 1, kRGB = 2, kYCCK = 3, kCMYK = 4 };
enum Up { kNone = 0, kNN = 1, kFancy = 2 };

// Scratch of an octet: K1's dequantised block and its row pass.
constexpr int kScratchFloats = 2 * kPad;

// The first form's variants, for testing/pixel_variants.py (which builds
// copies of this file with another value): 0 the kernel as it is, 1 phase 1
// alone, 2 phase 2 alone from zeroed windows, 3 phase 2's RGB staged in
// shared memory and stored 16 bytes at a time.
constexpr int kV1Variant = 0;

struct CompGeo {
  int h, v;          // sampling factors: the closed-form source
  int k0;            // the component's first block in an MCU
  int n_r, n_c;      // sample rows / columns the upsampler sees
  int vy, vx;        // upsampling factors
  int up;            // Up
  int win_w;         // window columns (capacity)
  int off;           // window's first int in the sample area
};

struct PixArgs {
  const int32_t* blocks;   // (B, n_rows, 64): coefficients or samples
  const int32_t* qt;       // (B, n_comps, 64)
  const int32_t* geom;     // (B, 4): mcus_x, mcus_y, height, width
  const float* kron;       // (64, 64) KRON, for K1's recheck
  void* out;               // (B, out_h, out_w, 3) uint8 or uint16
  int64_t n_rows;
  int n_comps, bpm;
  int out_h, out_w;
  int tile_h, tile_w, tiles_x;
  int colour, center, maxv;
  int window_ints;         // variant 2: the windows zeroed
  int rgb_pitch;           // variant 3: bytes a staged row
  CompGeo c[kMaxComps];
};

// The tile's window of component c: sample rows [r0, r1], columns [c0, c1].
struct Window {
  int r0, r1, c0, c1;
};

__device__ __forceinline__ void span(int lo_out, int hi_out, int f, int up,
                                     int n, int& lo, int& hi) {
  if (up == kNone) {
    lo = lo_out, hi = hi_out;
  } else if (up == kNN || f == 1) {
    lo = lo_out / f, hi = hi_out / f;
  } else {   // fancy at 2: the sample and its neighbours
    lo = max(lo_out / 2 - 1, 0);
    hi = min(hi_out / 2 + 1, n - 1);
  }
}

__device__ __forceinline__ float ycc_r(float y, float cr, float center) {
  return __fadd_rn(__fadd_rn(y, __fmul_rn(0x1.66e978p+0f, cr)), center);
}
__device__ __forceinline__ float ycc_g(float y, float cb, float cr,
                                       float center) {
  return __fadd_rn(__fsub_rn(__fsub_rn(y, __fmul_rn(0x1.60418ap-2f, cb)),
                             __fmul_rn(0x1.6d9168p-1f, cr)),
                   center);
}
__device__ __forceinline__ float ycc_b(float y, float cb, float center) {
  return __fadd_rn(__fadd_rn(y, __fmul_rn(0x1.c5a1cap+0f, cb)), center);
}

// Clamp to [0, maxv] in float32, then truncate (pixel.py:_ycbcr_channels).
__device__ __forceinline__ int clamp_trunc(float x, float maxv) {
  return __float2int_rz(fminf(fmaxf(x, 0.0f), maxv));
}

__device__ __forceinline__ int clamp_i(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// int32 3 a + b + k, wrapping as the torch ops do.
__device__ __forceinline__ int mul3_add(int a, int b, int k = 0) {
  return static_cast<int>(3u * static_cast<unsigned>(a) +
                          static_cast<unsigned>(b) + static_cast<unsigned>(k));
}

// Pillow's cmyk2rgb on one channel: nk - MULDIV255(c, nk), nk = 255 - K.
__device__ __forceinline__ int cmyk_channel(int c, int nk) {
  const int t = c * nk + 128;
  return clamp_i(nk - ((t + (t >> 8)) >> 8), 0, 255);
}

// One pixel's RGB from its components' upsampled samples v.
__device__ __forceinline__ void colour_pixel(int colour, const int (&v)[4],
                                             int center, int maxv,
                                             int (&rgb)[3]) {
  if (colour == kGray) {
    const int gv = clamp_i(mul3_add(0, v[0], center), 0, maxv);
    rgb[0] = rgb[1] = rgb[2] = gv;
  } else if (colour == kRGB) {
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[k] = clamp_i(v[k] + 128, 0, 255);
  } else {
    int cmy[3], kk;
    if (colour == kCMYK) {
#pragma unroll
      for (int k = 0; k < 3; ++k) cmy[k] = 255 - clamp_i(v[k] + 128, 0, 255);
      kk = 255 - clamp_i(v[3] + 128, 0, 255);
    } else {
      const float cf = static_cast<float>(center);
      const float mf = static_cast<float>(maxv);
      const float yf = __int2float_rn(v[0]), cb = __int2float_rn(v[1]);
      const float cr = __int2float_rn(v[2]);
      cmy[0] = clamp_trunc(ycc_r(yf, cr, cf), mf);
      cmy[1] = clamp_trunc(ycc_g(yf, cb, cr, cf), mf);
      cmy[2] = clamp_trunc(ycc_b(yf, cb, cf), mf);
      kk = colour == kYCCK ? 255 - clamp_i(v[3] + 128, 0, 255) : 0;
    }
    if (colour == kYCbCr) {
      rgb[0] = cmy[0], rgb[1] = cmy[1], rgb[2] = cmy[2];
    } else {   // PIL-convention CMYK to RGB
      const int nk = 255 - kk;
#pragma unroll
      for (int k = 0; k < 3; ++k) rgb[k] = cmyk_channel(cmy[k], nk);
    }
  }
}

// Stores `rows` staged rows of `nbytes` bytes: row yl goes to row0 + yl *
// pitch and was staged at stage + yl * stage_pitch + (its address & 15), so
// the 16-byte chunks of its aligned middle are aligned in both memories and
// go out as streaming 16-byte stores; the ragged ends go out a byte at a
// time.  A half-warp takes a row.  Every thread calls it.
__device__ __forceinline__ void store_rows(unsigned char* row0, int64_t pitch,
                                           const unsigned char* stage,
                                           int stage_pitch, int rows,
                                           int nbytes) {
  const int hw = threadIdx.x >> 4, l16 = threadIdx.x & 15;
  for (int yl = hw; yl < rows; yl += kPixThreads / 16) {
    unsigned char* g = row0 + yl * pitch;
    const int o = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
    const int head = min((16 - o) & 15, nbytes);
    const int n16 = (nbytes - head) >> 4;
    const int tail = nbytes - head - 16 * n16;
    const unsigned char* s = stage + yl * stage_pitch + o;
    if (l16 < head) g[l16] = s[l16];
    const int4* s4 = reinterpret_cast<const int4*>(s + head);
    int4* g4 = reinterpret_cast<int4*>(g + head);
    for (int i = l16; i < n16; i += 16) __stcs(g4 + i, s4[i]);
    if (l16 < tail) g[head + 16 * n16 + l16] = s[head + 16 * n16 + l16];
  }
}

// ---- K6b's first form: a CTA per tile ---------------------------------

template <int kMode, typename OutT>
__global__ void __launch_bounds__(kPixThreads)
    blocks_to_rgb_v1_kernel(const PixArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // The octets' scratch (ops/pixels_cuda.py:SCRATCH), then the windows.
  constexpr int kScratchBytes =
      kMode == kPallas ? kOctets * kScratchFloats * 4
                       : (kMode == kExact ? kOctets * kBlockStride * 4 : 0);
  float* scratch = reinterpret_cast<float*>(smem);
  int32_t* win = reinterpret_cast<int32_t*>(smem + kScratchBytes);
  const int tid = threadIdx.x, oct = tid >> 3, r = tid & 7;
  const int64_t b = blockIdx.y;
  const int ty = blockIdx.x / a.tiles_x;
  const int tx = blockIdx.x - ty * a.tiles_x;
  const int y0 = ty * a.tile_h, x0 = tx * a.tile_w;
  const int y1 = min(y0 + a.tile_h, a.out_h) - 1;   // last row, inclusive
  const int x1 = min(x0 + a.tile_w, a.out_w) - 1;
  const int mcus_x = a.geom[b * 4], mcus_y = a.geom[b * 4 + 1];
  const int true_h = a.geom[b * 4 + 2], true_w = a.geom[b * 4 + 3];

  Window w[kMaxComps];
  int br0[kMaxComps], bc0[kMaxComps], nbc[kMaxComps], first[kMaxComps + 1];
  first[0] = 0;
  bool any_valid = false;   // a window reaches a block of the geometry
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    int jobs = 0;
    if (c < a.n_comps) {
      const CompGeo& g = a.c[c];
      span(y0, y1, g.vy, g.up, g.n_r, w[c].r0, w[c].r1);
      span(x0, x1, g.vx, g.up, g.n_c, w[c].c0, w[c].c1);
      br0[c] = w[c].r0 >> 3;
      bc0[c] = w[c].c0 >> 3;
      nbc[c] = (w[c].c1 >> 3) - bc0[c] + 1;
      jobs = ((w[c].r1 >> 3) - br0[c] + 1) * nbc[c];
      any_valid |= br0[c] < mcus_y * g.v && bc0[c] < mcus_x * g.h;
    }
    first[c + 1] = first[c] + jobs;
  }
  if (kV1Variant == 2) {
    for (int i = tid; i < a.window_ints; i += kPixThreads) win[i] = 0;
  }

  // Phase 1: the samples of every block the tile reaches, one block an
  // octet a round; the loop is uniform over the CTA (the shuffles of K1's
  // eps need every lane).  A tile whose windows reach no block of the
  // geometry (bucket padding) has only zero samples, so every pixel is the
  // colour of zeros: phase 1 is skipped and phase 2 reads no window.
  const int n_jobs = any_valid && kV1Variant != 2 ? first[a.n_comps] : 0;
  for (int base = 0; base < n_jobs; base += kOctets) {
    const int j = base + oct;
    const bool active = j < n_jobs;
    int c = 0;
#pragma unroll
    for (int k = 1; k < kMaxComps; ++k)
      if (k < a.n_comps && j >= first[k]) c = k;
    const CompGeo& g = a.c[c];
    const int jj = active ? j - first[c] : 0;
    const int br = br0[c] + jj / nbc[c];
    const int bc = bc0[c] + jj % nbc[c];
    const int64_t src =
        (static_cast<int64_t>(br / g.v) * mcus_x + bc / g.h) * a.bpm + g.k0 +
        (br % g.v) * g.h + bc % g.h;
    const bool valid = active && br < mcus_y * g.v && bc < mcus_x * g.h &&
                       src < a.n_rows;
    const int32_t* blk = a.blocks + (b * a.n_rows + src) * 64;
    int s[8];
    bool by_column;   // s holds column r of the block, else row r
    if (kMode == kSamples) {
      int4 lo = make_int4(0, 0, 0, 0), hi = lo;
      if (valid) load_row(blk, r, lo, hi);
      s[0] = lo.x, s[1] = lo.y, s[2] = lo.z, s[3] = lo.w;
      s[4] = hi.x, s[5] = hi.y, s[6] = hi.z, s[7] = hi.w;
      by_column = false;
    } else {
      int4 clo = make_int4(0, 0, 0, 0), chi = clo, qlo, qhi;
      if (valid) load_row(blk, r, clo, chi);
      load_row(a.qt + (b * a.n_comps + c) * 64, r, qlo, qhi);
      const int32_t q[8] = {qlo.x, qlo.y, qlo.z, qlo.w,
                            qhi.x, qhi.y, qhi.z, qhi.w};
      if (kMode == kPallas) {
        float x[8];
        k1_dequant_row(clo, chi, q, x);
        float* xb = scratch + oct * kScratchFloats;
        float* tb = xb + kPad;
        store_row(xb, r, x);
        const float eps = k1_eps(x);
        float t[8];
        k1_row_pass(x, t);
        store_row(tb, r, t);
        __syncwarp();
        float col[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) col[u] = tb[u * 8 + r];
        int32_t res[8];
        const unsigned near = k1_col_pass(col, eps, res);
#pragma unroll
        for (int p = 0; p < 8; ++p)
          s[p] = (near >> p & 1u) ? k1_kron(xb, a.kron, p * 8 + r) : res[p];
        by_column = true;
      } else {
        int* t = reinterpret_cast<int*>(scratch) + oct * kBlockStride;
        const int cv[8] = {clo.x, clo.y, clo.z, clo.w,
                           chi.x, chi.y, chi.z, chi.w};
#pragma unroll
        for (int k = 0; k < 8; ++k)
          t[r * kRowStride + k] = k5_dequant(cv[k], q[k]);
        __syncwarp();
        k5_col_pass(t, r);
        __syncwarp();
        k5_row_pass(t, r, s);
        by_column = false;
      }
      __syncwarp();   // the octet's scratch is reused next round
    }
    if (active) {
      const Window& wc = w[c];
      int32_t* dst = win + g.off;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int sr = br * 8 + (by_column ? k : r);
        const int sc = bc * 8 + (by_column ? r : k);
        if (sr >= wc.r0 && sr <= wc.r1 && sc >= wc.c0 && sc <= wc.c1)
          dst[(sr - wc.r0) * g.win_w + (sc - wc.c0)] = s[k];
      }
    }
  }
  __syncthreads();
  if (kV1Variant == 1) return;

  // Phase 2: the tile's pixels.
  const int tile_w = x1 - x0 + 1;
  const int n_pix = (y1 - y0 + 1) * tile_w;
  OutT* out = static_cast<OutT*>(a.out);
  unsigned char* stage = smem + kScratchBytes + 4 * a.window_ints;
  for (int p = tid; p < n_pix; p += kPixThreads) {
    const int y = y0 + p / tile_w, x = x0 + p % tile_w;
    int v[kMaxComps] = {0, 0, 0, 0};
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) {
      if (c >= a.n_comps || !any_valid) break;
      const CompGeo& g = a.c[c];
      const Window& wc = w[c];
      const int32_t* ws = win + g.off;
#define S(i, j) ws[((i) - wc.r0) * g.win_w + ((j) - wc.c0)]
      if (g.up == kNone) {
        v[c] = S(y, x);
      } else if (g.up == kNN) {
        v[c] = S(y / g.vy, x / g.vx);
      } else {
        // Edge replication at the image's true edge (pixel.py:_shift_down,
        // _shift_right); a row or column past it takes its own value.
        const int e_r = (true_h + g.vy - 1) / g.vy;
        const int e_c = (true_w + g.vx - 1) / g.vx;
        if (g.vy == 2 && g.vx == 2) {
          const int i = y >> 1, j = x >> 1;
          const int ni = (y & 1) ? (i + 1 >= e_r ? i : min(i + 1, g.n_r - 1))
                                 : max(i - 1, 0);
          const int nj = (x & 1) ? (j + 1 >= e_c ? j : min(j + 1, g.n_c - 1))
                                 : max(j - 1, 0);
          const int col_j = mul3_add(S(i, j), S(ni, j));
          const int col_n = mul3_add(S(i, nj), S(ni, nj));
          v[c] = mul3_add(col_j, col_n, (x & 1) ? 7 : 8) >> 4;
        } else if (g.vy == 2) {
          const int i = y >> 1;
          const int ni = (y & 1) ? (i + 1 >= e_r ? i : min(i + 1, g.n_r - 1))
                                 : max(i - 1, 0);
          v[c] = mul3_add(S(i, x), S(ni, x), (y & 1) ? 2 : 1) >> 2;
        } else {
          const int j = x >> 1;
          const int nj = (x & 1) ? (j + 1 >= e_c ? j : min(j + 1, g.n_c - 1))
                                 : max(j - 1, 0);
          v[c] = mul3_add(S(y, j), S(y, nj), (x & 1) ? 2 : 1) >> 2;
        }
      }
#undef S
    }
    int rgb[3];
    colour_pixel(a.colour, v, a.center, a.maxv, rgb);
    OutT* o =
        out + ((b * a.out_h + y) * static_cast<int64_t>(a.out_w) + x) * 3;
    if (kV1Variant == 3) {
      const int o16 = static_cast<int>(
          reinterpret_cast<uintptr_t>(out + ((b * a.out_h + y) *
                                             static_cast<int64_t>(a.out_w) +
                                             x0) * 3) & 15);
      o = reinterpret_cast<OutT*>(stage + (y - y0) * a.rgb_pitch + o16) +
          (x - x0) * 3;
    }
    o[0] = static_cast<OutT>(rgb[0]);
    o[1] = static_cast<OutT>(rgb[1]);
    o[2] = static_cast<OutT>(rgb[2]);
  }
  if (kV1Variant == 3) {
    __syncthreads();
    store_rows(reinterpret_cast<unsigned char*>(
                   out + ((b * a.out_h + y0) * static_cast<int64_t>(a.out_w) +
                          x0) * 3),
               static_cast<int64_t>(a.out_w) * 3 * sizeof(OutT), stage,
               a.rgb_pitch, y1 - y0 + 1, tile_w * 3 * sizeof(OutT));
  }
}

template <int kMode, typename OutT>
int launch_rgb_v1(const PixArgs& a, int64_t n_img, int64_t n_tiles,
                  size_t smem, cudaStream_t stream) {
  auto kernel = blocks_to_rgb_v1_kernel<kMode, OutT>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(n_img));
  kernel<<<grid, kPixThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- K6b ----------------------------------------------------------------

// Asynchronous copies and their barriers (PTX, sm_90).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// 16 bytes from global to shared memory, cached in L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed
// (the barrier's count holds this arrival: .noinc).
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// CTAs a multiprocessor holds: __launch_bounds__ caps the registers at
// 65,536 / (256 x CTAs): kCtas under `exact`, kK1Ctas under `pallas` and
// `kron` (K1's transform and recheck), kFastCtas under `fast` (its two
// transposes and its ring); ops/pixels_cuda.py:CTAS_PER_SM sizes the grid
// for as many.  Each is the fastest of 2, 3 and 4 in
// testing/pixel_variants.py's runs.
constexpr int kCtas = 4;
constexpr int kK1Ctas = 3;
constexpr int kFastCtas = 3;

// K6b's variants, for testing/pixel_variants.py (which builds copies of
// this file with another value): 0 the kernel as it is, 1 its blocks'
// copies and IDCTs alone, 2 its pixels alone from zeroed windows, 3 its RGB
// staged in shared memory and stored 16 bytes at a time.
constexpr int kVariant = 0;

// Component c's value of four held in registers: selects, not an indexed
// array (which would live in local memory).
__device__ __forceinline__ int pick(int c, int v0, int v1, int v2, int v3) {
  return c == 0 ? v0 : (c == 1 ? v1 : (c == 2 ? v2 : v3));
}
#define PICK(c, field) \
  pick(c, a.c[0].field, a.c[1].field, a.c[2].field, a.c[3].field)

struct TileArgs {
  const int32_t* blocks;   // (B, n_rows, 64) coefficients
  const int32_t* qt;       // (B, n_comps, 64)
  const int32_t* geom;     // (B, 4): mcus_x, mcus_y, height, width
  const float* kron;       // (64, 64) KRON, for K1's recheck
  void* out;               // (B, out_h, out_w, 3) uint8 or uint16
  int64_t n_rows;
  int n_coded;                           // images with blocks (<= n_img)
  int n_comps, bpm, out_h, out_w;
  int tile_h, tile_w, tiles_x, tiles;   // tiles: an image's
  int n_work;                            // B x tiles
  int colour, center, maxv;
  // Byte offsets in dynamic shared memory (the IDCT scratch first).
  int off_stage, off_win, window_ints, off_rows, off_rgb, rgb_pitch;
  CompGeo c[kMaxComps];
};

// A tile's geometry, in shared memory: per component its window of
// samples (rows r0..r1, columns c0..c1), first block row and column and
// block columns, and the first job of each component (first[4]: the tile's
// blocks).
struct TileGeo {
  int r0[kMaxComps], r1[kMaxComps], c0[kMaxComps], c1[kMaxComps];
  int br0[kMaxComps], bc0[kMaxComps];
  int nbc[kMaxComps], first[kMaxComps + 1];
  int valid;   // a window reaches a block of the geometry
};

__device__ __forceinline__ void tile_geo(const TileArgs& a, int y0, int y1,
                                         int x0, int x1, int mcus_x,
                                         int mcus_y, TileGeo& t) {
  t.first[0] = 0;
  t.valid = 0;
  for (int c = 0; c < kMaxComps; ++c) {
    int jobs = 0;
    t.r0[c] = t.r1[c] = t.c0[c] = t.c1[c] = t.br0[c] = t.bc0[c] = 0;
    t.nbc[c] = 1;
    if (c < a.n_comps) {
      const CompGeo& g = a.c[c];
      span(y0, y1, g.vy, g.up, g.n_r, t.r0[c], t.r1[c]);
      span(x0, x1, g.vx, g.up, g.n_c, t.c0[c], t.c1[c]);
      t.br0[c] = t.r0[c] >> 3;
      t.bc0[c] = t.c0[c] >> 3;
      t.nbc[c] = (t.c1[c] >> 3) - t.bc0[c] + 1;
      jobs = ((t.r1[c] >> 3) - t.br0[c] + 1) * t.nbc[c];
      t.valid |= t.br0[c] < mcus_y * g.v && t.bc0[c] < mcus_x * g.h;
    }
    t.first[c + 1] = t.first[c] + jobs;
  }
}

// Job j of a tile: its component, block row and column, and scan row (-1
// outside the geometry: a zero block).
__device__ __forceinline__ int tile_job(const TileArgs& a, const TileGeo& t,
                                        int j, int mcus_x, int mcus_y,
                                        int& c, int& br, int& bc) {
  // first[] does not fall, so c is the count of first[k] <= j.
  c = (j >= t.first[1]) + (j >= t.first[2]) + (j >= t.first[3]);
  const int gv = PICK(c, v), gh = PICK(c, h);
  const int nbc = t.nbc[c];
  const int jj = j - t.first[c];
  const int row = jj / nbc;
  br = t.br0[c] + row;
  bc = t.bc0[c] + jj - row * nbc;
  if (br >= mcus_y * gv || bc >= mcus_x * gh) return -1;
  const int64_t s = (static_cast<int64_t>(br / gv) * mcus_x + bc / gh) *
                        a.bpm +
                    PICK(c, k0) + (br % gv) * gh + bc % gh;
  return s < a.n_rows ? static_cast<int>(s) : -1;
}

// Finds job j (none past n_jobs), issues the copy of its block into `dst`
// (256 bytes: two 16-byte copies a thread of the octet) and leaves the job
// (its block's scan row, -1 for a zero block or no job; its component,
// block row and column) in `job` for the round that transforms it; then
// every lane of the warp arrives on `bar` once its copies have landed.
// Every lane of the warp calls it.
__device__ __forceinline__ void fetch(const TileArgs& a, const TileGeo& t,
                                      int b, int j, int n_jobs, int mcus_x,
                                      int mcus_y, int32_t* dst, int4* job,
                                      unsigned long long* bar) {
  int src = -1, c = 0, br = 0, bc = 0;
  if (j < n_jobs) src = tile_job(a, t, j, mcus_x, mcus_y, c, br, bc);
  const int r = threadIdx.x & 7;
  if (src >= 0) {
    const int32_t* blk =
        a.blocks + (static_cast<int64_t>(b) * a.n_rows + src) * 64 + r * 8;
    cp_async16(dst + r * 8, blk);
    cp_async16(dst + r * 8 + 4, blk + 4);
  }
  if (r == 0) *job = make_int4(src, c, br, bc);
  cp_async_arrive(bar);
}

template <int kMode, typename OutT>
__global__ void __launch_bounds__(
    kPixThreads,
    kMode == kFast ? kFastCtas : (kMode == kPallas ? kK1Ctas : kCtas))
    blocks_to_rgb_kernel(const TileArgs a) {
  // K5 and fast take their blocks through the warps' rings; K1's transform
  // and recheck need the registers the ring's jobs would hold, so under
  // pallas and kron each octet loads its block from device memory as
  // idct.cu does.
  constexpr bool kRing = kMode != kPallas;
  extern __shared__ __align__(16) unsigned char smem[];
  // Each warp's two stages' barriers (its own ring: no CTA-wide wait).
  __shared__ __align__(8) unsigned long long full[kPixThreads / 32][2];
  __shared__ TileGeo geo_s;
  __shared__ int4 jobs_s[2][kOctets];   // each octet's job in each stage
  const TileGeo& t = geo_s;
  float* scratch = reinterpret_cast<float*>(smem);
  int32_t* win = reinterpret_cast<int32_t*>(smem + a.off_win);
  // Each component's sample rows of the tile's pixel rows (window offsets
  // of the row and of its fancy neighbour), after the windows.
  int2* rowtab = reinterpret_cast<int2*>(smem + a.off_rows);
  unsigned char* rgbs = smem + a.off_rgb;
  const int tid = threadIdx.x, oct = tid >> 3, r = tid & 7;
  const int warp = tid >> 5;
  // The warp's two stages: four blocks (one an octet) each.
  int32_t* stage = reinterpret_cast<int32_t*>(smem + a.off_stage) +
                   warp * 2 * 4 * 64 + (oct & 3) * 64;
  // The thread's column of a tile and its first row; threads past
  // rstep * tile_w take no pixel.
  const int rstep = kPixThreads / a.tile_w;
  const int yph = tid / a.tile_w, xl = tid - yph * a.tile_w;
  const bool emits = yph < rstep;
  if ((tid & 31) == 0) {
    mbar_init(&full[warp][0], 32);
    mbar_init(&full[warp][1], 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  unsigned uses = 0;   // bit k: the parity of stage k's next phase

  for (int work = blockIdx.x; work < a.n_work; work += gridDim.x) {
    const int b = work / a.tiles;
    const int tile = work - b * a.tiles;
    const int ty = tile / a.tiles_x, tx = tile - ty * a.tiles_x;
    const int y0 = ty * a.tile_h, x0 = tx * a.tile_w;
    const int rows = min(a.tile_h, a.out_h - y0);
    const int w_pix = min(a.tile_w, a.out_w - x0);
    const int mcus_x = __ldg(a.geom + b * 4);
    const int mcus_y = __ldg(a.geom + b * 4 + 1);
    __syncthreads();   // the last tile's geometry and windows are read
    if (tid == 0) {
      tile_geo(a, y0, y0 + rows - 1, x0, x0 + w_pix - 1, mcus_x, mcus_y,
               geo_s);
      // An image past the blocks given is padding: the colour of zeros.
      if (b >= a.n_coded) geo_s.valid = 0;
    }
    if (kVariant == 2) {
      for (int i = tid; i < a.window_ints; i += kPixThreads) win[i] = 0;
    }
    __syncthreads();   // the tile's geometry
    if (t.valid && tid < rows) {
      const int y = y0 + tid;
      const int true_h = __ldg(a.geom + b * 4 + 2);
#pragma unroll
      for (int c = 0; c < kMaxComps; ++c) {
        if (c < a.n_comps) {
          const CompGeo& g = a.c[c];
          int ra, rb;
          if (g.up == kFancy && g.vy == 2) {
            const int i = y >> 1, e_r = (true_h + 1) >> 1;
            ra = i;
            rb = (y & 1) ? (i + 1 >= e_r ? i : min(i + 1, g.n_r - 1))
                         : max(i - 1, 0);
          } else {
            ra = rb = g.up == kNone || g.vy == 1 ? y : y / g.vy;
          }
          rowtab[c * a.tile_h + tid] = make_int2((ra - t.r0[c]) * g.win_w,
                                                 (rb - t.r0[c]) * g.win_w);
        }
      }
    }

    // Phase 1: the samples of every block the tile reaches (the fancy
    // filter's halo included), one block an octet a round; each warp
    // copies its next round's four blocks into its other stage while it
    // transforms this round's.  A tile whose windows reach no block of the
    // geometry (bucket padding) has only zero samples: no round, and
    // phase 2 gives every pixel the colour of zeros.
    const int n_jobs = t.valid && kVariant != 2 ? t.first[kMaxComps] : 0;
    if (kRing && n_jobs > 0)
      fetch(a, t, b, oct, n_jobs, mcus_x, mcus_y, stage, &jobs_s[0][oct],
            &full[warp][0]);
    for (int base = 0, k = 0; base < n_jobs; base += kOctets, k ^= 1) {
      int4 cur;   // the octet's job: src, c, br, bc
      const int32_t* blk;
      if (kRing) {
        if (base + kOctets < n_jobs)
          fetch(a, t, b, base + kOctets + oct, n_jobs, mcus_x, mcus_y,
                stage + (k ^ 1) * 4 * 64, &jobs_s[k ^ 1][oct],
                &full[warp][k ^ 1]);
        mbar_wait(&full[warp][k], (uses >> k) & 1);
        uses ^= 1u << k;
        __syncwarp();   // the octet's job, written by its first thread
        cur = jobs_s[k][oct];
        blk = stage + k * 4 * 64;
      } else {
        cur = make_int4(-1, 0, 0, 0);
        if (base + oct < n_jobs)
          cur.x = tile_job(a, t, base + oct, mcus_x, mcus_y, cur.y, cur.z,
                           cur.w);
        blk = a.blocks + (static_cast<int64_t>(b) * a.n_rows + cur.x) * 64;
      }
      const int c = cur.y;
      const int32_t* qc =
          a.qt + (static_cast<int64_t>(b) * a.n_comps + c) * 64;
      int4 clo = make_int4(0, 0, 0, 0), chi = clo, qlo, qhi;
      if (cur.x >= 0) load_row(blk, r, clo, chi);
      load_row(qc, r, qlo, qhi);
      const int32_t q[8] = {qlo.x, qlo.y, qlo.z, qlo.w,
                            qhi.x, qhi.y, qhi.z, qhi.w};
      int32_t s8[8];
      bool by_column;   // s8 holds column r of the block, else row r
      if (kMode == kPallas) {
        // K1 as idct.cu runs it: the dequantised block kept in the
        // octet's scratch for the recheck of the samples near a half.
        float x[8];
        k1_dequant_row(clo, chi, q, x);
        float* xb = scratch + oct * 2 * kPad;
        float* tb = xb + kPad;
        store_row(xb, r, x);
        const float eps = k1_eps(x);
        float tt[8];
        k1_row_pass(x, tt);
        store_row(tb, r, tt);
        __syncwarp();
        float col[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) col[u] = tb[u * 8 + r];
        int32_t res[8];
        const unsigned near = k1_col_pass(col, eps, res);
#pragma unroll
        for (int p = 0; p < 8; ++p)
          s8[p] = (near >> p & 1u) ? k1_kron(xb, a.kron, p * 8 + r) : res[p];
        by_column = true;
      } else if (kMode == kFast) {
        // T = M X column by column, then T M^T row by row: two passes
        // through the octet's scratch.
        float x[8];
        k1_dequant_row(clo, chi, q, x);
        float* tb = scratch + oct * kPad;
        store_row(tb, r, x);
        __syncwarp();
        float col[8], tt[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) col[u] = tb[u * 8 + r];
        fast_col_pass(col, tt);
        __syncwarp();
#pragma unroll
        for (int p = 0; p < 8; ++p) tb[p * 8 + r] = tt[p];
        __syncwarp();
        float4 lo, hi;
        load_row(tb, r, lo, hi);
        const float row[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        fast_row_pass(row, s8);
        by_column = false;
      } else {
        int* tt = reinterpret_cast<int*>(scratch) + oct * kBlockStride;
        const int cv[8] = {clo.x, clo.y, clo.z, clo.w,
                           chi.x, chi.y, chi.z, chi.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          tt[r * kRowStride + e] = k5_dequant(cv[e], q[e]);
        __syncwarp();
        k5_col_pass(tt, r);
        __syncwarp();
        k5_row_pass(tt, r, s8);
        by_column = false;
      }
      if (base + oct < n_jobs) {
        // The window holds rows r0..r1 and columns c0..c1; a halo block's
        // samples outside it are dropped.
        const int r0 = t.r0[c], r1 = t.r1[c], c0 = t.c0[c], c1 = t.c1[c];
        const int ww = PICK(c, win_w);
        int32_t* dst = win + PICK(c, off);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int sr = cur.z * 8 + (by_column ? e : r);
          const int sc = cur.w * 8 + (by_column ? r : e);
          if (sr >= r0 && sr <= r1 && sc >= c0 && sc <= c1)
            dst[(sr - r0) * ww + (sc - c0)] = s8[e];
        }
      }
      __syncwarp();   // the scratch and the stage are written again
    }
    __syncthreads();   // the windows are whole
    if (kVariant == 1) continue;

    // Phase 2: the tile's pixels, a column a thread.
    OutT* out = static_cast<OutT*>(a.out);
    const int64_t pitch = static_cast<int64_t>(a.out_w) * 3;
    const bool valid = t.valid;
    if (emits && xl < w_pix) {
      const int x = x0 + xl;
      const int true_w = __ldg(a.geom + b * 4 + 3);
      int ca[kMaxComps], cb[kMaxComps];
#pragma unroll
      for (int c = 0; c < kMaxComps; ++c) {
        ca[c] = cb[c] = 0;
        if (c < a.n_comps) {
          const CompGeo& g = a.c[c];
          const int e_c = (true_w + g.vx - 1) / g.vx;
          const int c0 = t.c0[c];
          if (g.up == kFancy && g.vx == 2) {
            const int j = x >> 1;
            ca[c] = j - c0;
            cb[c] = ((x & 1) ? (j + 1 >= e_c ? j : min(j + 1, g.n_c - 1))
                             : max(j - 1, 0)) - c0;
          } else {
            ca[c] = cb[c] = (g.up == kNone || g.vx == 1 ? x : x / g.vx) - c0;
          }
        }
      }
      int zero[3];   // the colour of zero samples
      if (!valid) {
        const int v0[kMaxComps] = {0, 0, 0, 0};
        colour_pixel(a.colour, v0, a.center, a.maxv, zero);
      }
#pragma unroll 2
      for (int yl = yph; yl < rows; yl += rstep) {
        const int y = y0 + yl;
        int rgb[3];
        if (valid) {
          int v[kMaxComps] = {0, 0, 0, 0};
#pragma unroll
          for (int c = 0; c < kMaxComps; ++c) {
            if (c < a.n_comps) {
              const CompGeo& g = a.c[c];
              const int32_t* ws = win + g.off;
              const int2 rt = rowtab[c * a.tile_h + yl];
              const int ra = rt.x, rb = rt.y;
              if (g.up != kFancy || (g.vy != 2 && g.vx != 2)) {
                v[c] = ws[ra + ca[c]];
              } else if (g.vy == 2 && g.vx == 2) {
                const int col_j = mul3_add(ws[ra + ca[c]], ws[rb + ca[c]]);
                const int col_n = mul3_add(ws[ra + cb[c]], ws[rb + cb[c]]);
                v[c] = mul3_add(col_j, col_n, (x & 1) ? 7 : 8) >> 4;
              } else if (g.vy == 2) {
                v[c] = mul3_add(ws[ra + ca[c]], ws[rb + ca[c]],
                                (y & 1) ? 2 : 1) >> 2;
              } else {
                v[c] = mul3_add(ws[ra + ca[c]], ws[ra + cb[c]],
                                (x & 1) ? 2 : 1) >> 2;
              }
            }
          }
          colour_pixel(a.colour, v, a.center, a.maxv, rgb);
        } else {
          rgb[0] = zero[0], rgb[1] = zero[1], rgb[2] = zero[2];
        }
        OutT* o = out + ((static_cast<int64_t>(b) * a.out_h + y) * pitch + (x0 + xl) * 3);
        if (kVariant == 3) {
          const int o16 = static_cast<int>(
              reinterpret_cast<uintptr_t>(out + (static_cast<int64_t>(b) * a.out_h + y) * pitch +
                                          x0 * 3) & 15);
          o = reinterpret_cast<OutT*>(rgbs + yl * a.rgb_pitch + o16) + xl * 3;
        }
        o[0] = static_cast<OutT>(rgb[0]);
        o[1] = static_cast<OutT>(rgb[1]);
        o[2] = static_cast<OutT>(rgb[2]);
      }
    }
    if (kVariant == 3) {
      __syncthreads();
      store_rows(reinterpret_cast<unsigned char*>(
                     out + (static_cast<int64_t>(b) * a.out_h + y0) * pitch + x0 * 3),
                 pitch * static_cast<int64_t>(sizeof(OutT)), rgbs,
                 a.rgb_pitch, rows, w_pix * 3 * static_cast<int>(sizeof(OutT)));
    }
  }
}

template <int kMode, typename OutT>
int launch_rgb(const TileArgs& a, int grid, size_t smem,
               cudaStream_t stream) {
  auto kernel = blocks_to_rgb_kernel<kMode, OutT>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, kPixThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6a.  dc16 (B, n_blk) int16, e (B, K) uint8, ov (B, O) int8, esc_idx
// (B, E) int32, esc_val (B, E) int16 (B >= n_img), out (n_img, n_keep + 1,
// 64) int32 (16-byte aligned), scratch rec (n_img, ceil(K / 4096), 4)
// int32, base (n_img, ceil(K / 4096) + 1, 2) int64 and flags (n_img,
// ceil(E / 256) + 1) int32; all contiguous on the current device (the
// wrapper checks this).  Rows n_img.. of the wire and its blocks from
// n_keep on take no part.  Launches on `stream`; returns cudaGetLastError()
// (0 = launched), -1 for arguments out of range.
extern "C" int jd_unpack_nibble(const void* dc16, const void* e,
                                const void* ov, const void* esc_idx,
                                const void* esc_val, void* out, void* rec,
                                void* base, void* flags, int64_t n_img,
                                int64_t n_blk, int64_t n_keep, int64_t k,
                                int64_t o, int64_t n_esc, void* stream) {
  if (n_img <= 0) return 0;
  if (n_img > 65535 || n_keep < 0 || n_keep > n_blk) return -1;
  const int64_t n_windows = ((n_keep + 1) * 64 + kWindow - 1) / kWindow;
  NibbleArgs a = {};
  a.dc16 = static_cast<const int16_t*>(dc16);
  a.e = static_cast<const uint8_t*>(e);
  a.ov = static_cast<const int8_t*>(ov);
  a.esc_idx = static_cast<const int32_t*>(esc_idx);
  a.esc_val = static_cast<const int16_t*>(esc_val);
  a.out = static_cast<int32_t*>(out);
  a.rec = static_cast<int4*>(rec);
  a.base = static_cast<longlong2*>(base);
  a.flags = static_cast<int32_t*>(flags);
  a.n_blk = n_blk, a.n_keep = n_keep, a.k = k, a.o = o, a.n_esc = n_esc;
  a.n_chunks = (k + kChunk - 1) / kChunk;
  a.n_esc_ctas = (n_esc + kUnpackThreads - 1) / kUnpackThreads;
  a.vec = reinterpret_cast<uintptr_t>(e) % 16 == 0 && k % 16 == 0;
  if (a.n_chunks + a.n_esc_ctas >= (int64_t{1} << 31) ||
      n_windows >= (int64_t{1} << 31))
    return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned ny = static_cast<unsigned>(n_img);
  if (a.n_chunks + a.n_esc_ctas > 0)
    unpack_totals<<<dim3(static_cast<unsigned>(a.n_chunks + a.n_esc_ctas),
                         ny),
                    kUnpackThreads, 0, s>>>(a);
  unpack_bases<<<ny, kUnpackThreads, 0, s>>>(a);
  if (kUnpackVariant != 1) {
    // The window's size is this file's constant: every call sets the same
    // limit.
    const cudaError_t rc = cudaFuncSetAttribute(
        unpack_windows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWindowBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    unpack_windows<<<dim3(static_cast<unsigned>(n_windows), ny),
                     kUnpackThreads, kWindowBytes, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6a's first form (the same-card baseline; no path reaches it).  dc16
// (B, n_blk) int16, e (B, K) uint8, ov (B, O) int8, esc_idx (B, E) int32,
// esc_val (B, E) int16, out (B, n_blk + 1, 64) int32, agg (B, ceil(K /
// 4096), 2) int32 scratch; all contiguous on the current device.  Launches
// on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int jd_unpack_nibble_v1(const void* dc16, const void* e,
                                   const void* ov, const void* esc_idx,
                                   const void* esc_val, void* out, void* agg,
                                   int64_t n_img, int64_t n_blk, int64_t k,
                                   int64_t o, int64_t n_esc, void* stream) {
  if (n_img <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  NibbleArgs a = {};
  a.dc16 = static_cast<const int16_t*>(dc16);
  a.e = static_cast<const uint8_t*>(e);
  a.ov = static_cast<const int8_t*>(ov);
  a.esc_idx = static_cast<const int32_t*>(esc_idx);
  a.esc_val = static_cast<const int16_t*>(esc_val);
  a.out = static_cast<int32_t*>(out);
  a.agg = static_cast<int32_t*>(agg);
  a.n_blk = n_blk, a.k = k, a.o = o, a.n_esc = n_esc;
  a.n_chunks = (k + kChunk - 1) / kChunk;
  a.vec = reinterpret_cast<uintptr_t>(e) % 16 == 0 && k % 16 == 0;
  const unsigned ny = static_cast<unsigned>(n_img);
  const int64_t units = (n_blk + 1) * 16;
  nibble_fill<<<dim3(static_cast<unsigned>(
                         (units + 4 * kUnpackThreads - 1) /
                         (4 * kUnpackThreads)),
                     ny),
                kUnpackThreads, 0, s>>>(a);
  if (a.n_chunks > 0) {
    const dim3 grid(static_cast<unsigned>(a.n_chunks), ny);
    nibble_totals<<<grid, kUnpackThreads, 0, s>>>(a);
    nibble_scatter<<<grid, kUnpackThreads, 0, s>>>(a);
  }
  if (n_esc > 0) {
    const dim3 grid(
        static_cast<unsigned>((n_esc + kUnpackThreads - 1) / kUnpackThreads),
        ny);
    nibble_escapes<<<grid, kUnpackThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6b.  `dims`: n_comps, bpm, out_h, out_w, tile_h, tile_w, tiles_x,
// tiles (an image's), colour, center, maxv, mode (0 pallas and kron, 1
// exact, 3 fast), out_bytes (1 uint8, 2 uint16), off_stage, off_win (byte
// offsets of the rings and the windows in dynamic shared memory),
// window_ints (a multiple of 4), off_rows, off_rgb (byte offsets of the row
// table and the staged rows), rgb_pitch (ops/pixels_cuda.py:RgbPlan.layout),
// n_coded (the images `blocks` holds, its first dimension: the images past
// them are padding, the colour of zeros); `geo`: per component 10 int32
// (CompGeo).  The pointers as in TileArgs, contiguous and 16-byte aligned
// on the current device; qt and geom hold n_img images.  Launches `grid`
// persistent CTAs with `smem` bytes of dynamic shared memory on `stream`,
// which walk the n_img x tiles tiles; returns cudaGetLastError() (0 =
// launched).
extern "C" int jd_blocks_to_rgb(const void* blocks, const void* qt,
                                const void* geom, const void* kron,
                                void* out, int64_t n_img, int64_t n_rows,
                                const int32_t* dims, const int32_t* geo,
                                int64_t grid, int64_t smem, void* stream) {
  if (n_img <= 0 || grid <= 0) return 0;
  TileArgs a = {};
  a.blocks = static_cast<const int32_t*>(blocks);
  a.qt = static_cast<const int32_t*>(qt);
  a.geom = static_cast<const int32_t*>(geom);
  a.kron = static_cast<const float*>(kron);
  a.out = out;
  a.n_rows = n_rows;
  a.n_comps = dims[0], a.bpm = dims[1], a.out_h = dims[2], a.out_w = dims[3];
  a.tile_h = dims[4], a.tile_w = dims[5], a.tiles_x = dims[6];
  a.tiles = dims[7];
  a.colour = dims[8], a.center = dims[9], a.maxv = dims[10];
  const int mode = dims[11], out_bytes = dims[12];
  a.off_stage = dims[13], a.off_win = dims[14], a.window_ints = dims[15];
  a.off_rows = dims[16], a.off_rgb = dims[17], a.rgb_pitch = dims[18];
  a.n_coded = dims[19];
  if (a.n_coded < 0 || a.n_coded > n_img) return -1;
  if (a.n_comps < 1 || a.n_comps > kMaxComps) return -1;
  if (a.tile_w < 1 || a.tile_w > kPixThreads || a.tile_h < 1 ||
      a.tile_h > kPixThreads)
    return -1;
  if (n_img * a.tiles >= (int64_t{1} << 31)) return -1;
  a.n_work = static_cast<int>(n_img * a.tiles);
  for (int c = 0; c < a.n_comps; ++c) {
    const int32_t* g = geo + c * 10;
    a.c[c] = CompGeo{g[0], g[1], g[2], g[3], g[4],
                     g[5], g[6], g[7], g[8], g[9]};
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  const int n = static_cast<int>(grid);
  if (out_bytes == 1) {
    if (mode == kPallas) return launch_rgb<kPallas, uint8_t>(a, n, sm, s);
    if (mode == kExact) return launch_rgb<kExact, uint8_t>(a, n, sm, s);
    if (mode == kFast) return launch_rgb<kFast, uint8_t>(a, n, sm, s);
    return -1;
  }
  if (mode == kPallas) return launch_rgb<kPallas, uint16_t>(a, n, sm, s);
  if (mode == kExact) return launch_rgb<kExact, uint16_t>(a, n, sm, s);
  if (mode == kFast) return launch_rgb<kFast, uint16_t>(a, n, sm, s);
  return -1;
}

// K6b's first form.  `geo`: per component 10 int32 (h, v, k0, n_r, n_c, vy,
// vx, up, win_w, off: CompGeo); `dims`: n_comps, bpm, out_h, out_w, tile_h,
// tile_w, tiles_x, colour, center, maxv, mode (0 pallas, 1 exact, 2
// samples), out_bytes (1 uint8, 2 uint16), window_ints (a multiple of 4),
// rgb_pitch (the variant with staged stores); the pointers as in PixArgs,
// contiguous and 16-byte aligned on the current device.  `smem` is the
// dynamic shared memory of a CTA: the octets' scratch (mode 0: 32 x 144
// floats, mode 1: 32 x 72 ints, mode 2: none), then the windows (and the
// staged rows of variant 3).
extern "C" int jd_blocks_to_rgb_v1(const void* blocks, const void* qt,
                                   const void* geom, const void* kron,
                                   void* out, int64_t n_img, int64_t n_rows,
                                   const int32_t* dims, const int32_t* geo,
                                   int64_t n_tiles, int64_t smem,
                                   void* stream) {
  if (n_img <= 0 || n_tiles <= 0) return 0;
  PixArgs a;
  a.blocks = static_cast<const int32_t*>(blocks);
  a.qt = static_cast<const int32_t*>(qt);
  a.geom = static_cast<const int32_t*>(geom);
  a.kron = static_cast<const float*>(kron);
  a.out = out;
  a.n_rows = n_rows;
  a.n_comps = dims[0], a.bpm = dims[1];
  a.out_h = dims[2], a.out_w = dims[3];
  a.tile_h = dims[4], a.tile_w = dims[5], a.tiles_x = dims[6];
  a.colour = dims[7], a.center = dims[8], a.maxv = dims[9];
  const int mode = dims[10], out_bytes = dims[11];
  a.window_ints = dims[12], a.rgb_pitch = dims[13];
  if (a.n_comps < 1 || a.n_comps > kMaxComps) return -1;
  for (int c = 0; c < a.n_comps; ++c) {
    const int32_t* g = geo + c * 10;
    a.c[c] = CompGeo{g[0], g[1], g[2], g[3], g[4],
                     g[5], g[6], g[7], g[8], g[9]};
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (out_bytes == 1) {
    if (mode == kPallas)
      return launch_rgb_v1<kPallas, uint8_t>(a, n_img, n_tiles, sm, s);
    if (mode == kExact)
      return launch_rgb_v1<kExact, uint8_t>(a, n_img, n_tiles, sm, s);
    return launch_rgb_v1<kSamples, uint8_t>(a, n_img, n_tiles, sm, s);
  }
  if (mode == kPallas)
    return launch_rgb_v1<kPallas, uint16_t>(a, n_img, n_tiles, sm, s);
  if (mode == kExact)
    return launch_rgb_v1<kExact, uint16_t>(a, n_img, n_tiles, sm, s);
  return launch_rgb_v1<kSamples, uint16_t>(a, n_img, n_tiles, sm, s);
}
