// Progressive Huffman scan kernels (T.81 G.2) for sm_90a: K8a DC first,
// K8b DC refinement, K8c AC first, K8d AC refinement.
//
// Replace the JAX package's device loops in
// jpeg_decoder_tpu/ops/entropy_prog.py: decode_dc_first (:87),
// dc_refine_bits (:152), decode_ac_first (:199) with decode_ac_first_emit
// (:770) and _emit_global_scatter (:1083), decode_ac_refine (:317) with
// decode_ac_refine_emit (:517), _refine_emit_prep (:876) and
// _refine_emit_core (:897).  They compute what those compute, not how: a TPU
// loop cannot scatter, so the JAX forms emit (position, value) pairs or
// per-event accumulators and scatter or gather them afterwards.  Here the
// lanes of a scan own disjoint blocks, so each lane stores into its own
// blocks' coefficients.
//
// A lane is a run of consecutive MCUs (DC scans) or blocks (AC scans) of one
// scan, from a known state: a restart segment (predictors and EOB run zero)
// or a record of the host's skeleton walk (bit position, predictors, pending
// EOB run).
//
// K8a (DC first) is a serial chain of DC differences per lane.  Its first
// form (dc_first_kernel_v1, one thread per lane, 128-thread CTAs) probed
// each component's 65536-entry LUT and read two words from device memory
// per symbol, divided in 64 bits three times a block and added into
// coefficient 0 with a load: on a 1920x1080 frame with a restart marker
// every MCU row (a DC first scan of three interleaved components, DRI 120:
// 68 segment lanes of 720 blocks) all 68 lanes sat in one CTA on one SM,
// 0.5923 ms (~820 ns a symbol); a DRI-0 1920x1080 frame at 4,096 target
// lanes gave 4,080 lanes of 12 blocks in 32 CTAs, 0.0167 ms (H100 80GB
// HBM3, 700 W, chip_smoke.py).  Now:
//  * Tables: each component's compact table (entropy_prog_cuda.dc_tables:
//    the 11-bit first level of K8c's, where DC codes of up to 11 bits
//    resolve, then the components' second levels) is built once on the
//    host, uploaded with the scan's words and staged per CTA with cp.async
//    (4 KB a component); a prefix left out reads the LUT, counted as a
//    table miss.  Words are staged as K8c's (a lane's, or one range for 32
//    lanes), a word outside counted as over budget.
//  * Warp form (dc_warp_kernel), up to DC_WARP_LANES_MAX lanes: one warp
//    per lane, persistent 32-thread CTAs (lane s on CTA s % grid).  Per
//    chunk of 32 blocks lane 0 walks the symbols (a shared-memory probe
//    and shifts of a window held in registers; the slot cycles 0..bpm-1 as
//    a counter) and records each block's difference in shared memory;
//    then each thread takes one block: its slot and unit from counters
//    that advance 32 blocks a chunk (a division only where a row wraps),
//    its predictor by a per-component prefix sum over the warp
//    (__shfl_up_sync, wrapping as uint32), and a 4-byte store of
//    ``pred << al`` into coefficient 0, which is zero entering the scan (no
//    load).  68 segment lanes put a warp on 68 SMs.
//  * Thread form (dc_thread_kernel), beyond: one thread per lane, 32-thread
//    CTAs (4,080 lanes: 128 CTAs), the predictors in registers, the same
//    probe and store.
//    The numbers that set DC_WARP_LANES_MAX = 1,024 (ops/entropy_prog_cuda.py;
//    device ms of a DC first scan, warp / thread form, 10 launches queued
//    behind a spin kernel; H100 80GB HBM3, 700 W, chip_smoke.py's "prog
//    K8a forms" lines): 1920x1080 at 510 lanes of 16 MCUs 0.0159 / 0.0275,
//    742 of 11 0.0184 / 0.0216, 1,020 of 8 0.0173 / 0.0178, 1,360 of 6
//    0.0250 / 0.0154, 4,080 of 2 0.0270 / 0.0107; 3840x2160 at 1,013 of 32
//    0.0348 / 0.0467, 1,473 of 22 0.0455 / 0.0346, 4,050 of 8 0.0524 /
//    0.0180; 68 segment lanes of 120 MCUs 0.0521 / 0.1534.  The forms cross
//    between 1,020 and 1,360 lanes on both frames.  Same run, first form:
//    0.0162 (1920x1080, 4,080 lanes), 0.0574 (3840x2160, 4,050), 0.5977
//    (68 segment lanes).
//  * The slot geometry comes in 32 bits with each slot's plane pointer and
//    size (DcGeo), copied once per CTA into shared memory.
// K8b (DC refinement): block t of a lane takes the bit at base + t.  Its
// first form (dc_refine_kernel_v1) ran one thread per (lane, slot) over the
// lanes times the longest lane, with 64-bit divisions and a word load each.
// Now one thread per block of the scan (a flat grid, 32-bit indices): the
// lane by a division where the lanes have one length (restart segments, a
// single lane), else by a binary search of the lanes' first units, the bit
// from the warp's one word pair (__shfl_sync), and only a thread whose bit
// is 1 touches its row, with a reduction that returns nothing.  It runs at
// the launch floor either way: 0.0062 ms against the first form's 0.0064
// on a 1920x1080 frame, 0.0075 against 0.0090 on 3840x2160 (same run).
//
// K8c and K8d share one design.  A lane is a serial chain of symbols; the
// first forms (ac_*_kernel_v1, one thread per lane, 128-thread CTAs) loaded
// every band position's history, every correction bit and every table probe
// from device memory inside that chain (K8d: ~290 ns a position step,
// 17.35 ms for the four AC refinement scans of a 1920x1080 frame with a
// restart marker every MCU row, whose 135 luma segment lanes filled 2 CTAs:
// 2 SMs busy; H100 80GB HBM3, 700 W, chip_smoke.py).
//  * Warp form (ac_warp_kernel), K8d always and K8c up to WARP_LANES_MAX
//    lanes (1,024 in ops/entropy_prog_cuda.py): one warp per lane, 32-thread
//    CTAs persistent over the lanes (lane s on CTA s % grid), as many as fit
//    on the card (at most 85 registers a thread and 6-8 KB of shared memory:
//    24 an SM) and no more than the lanes.  135 segment lanes put a warp on
//    every SM, 512 lanes about four.  Lane 0 walks; the warp builds the
//    history masks and applies the results.
//  * Thread form (ac_first_thread_kernel), K8c beyond WARP_LANES_MAX lanes:
//    one thread per lane, 32-thread CTAs.  With thousands of short lanes a
//    warp per lane fills every SM with warps that each issue one thread's
//    chain; 32 lanes of a warp share each instruction instead.
//    The numbers that set the choice (sums over the four scans of a kind of
//    1920x1080 and 3840x2160 progressive frames, warp / thread form, ms;
//    H100 80GB HBM3, 700 W, chip_smoke.py): at 4,096 lanes K8c 0.1596 /
//    0.0450 (first form 0.0488) and 0.1846 / 0.0683; at 512 lanes K8c
//    0.0884 / 0.1214.  K8d's thread form was never faster: 0.2768 / 0.2769
//    and 0.7597 / 0.8898 at 4,096 lanes, 0.4500 / 1.6758 at 512 lanes,
//    1.7028 / 6.6608 on 135 segment lanes; K8d has the warp form only,
//    re-timed at 4,096 lanes: 0.2854 ms (1920x1080) and 0.7446 ms
//    (3840x2160), first form 0.6842 and 2.9080, same card and script.
//  * Tables: the host builds each AC table's compact form once (an 11-bit
//    first level, and a 32-entry second level for each prefix of longer
//    codes, at most 64: entropy_prog_cuda.compact_table) and uploads it
//    with the scan's words; each CTA copies it once into shared memory
//    with cp.async (4-8 KB).  A prefix left out when the 64 second levels
//    run out reads the 65536-entry LUT in device memory, counted as a
//    table miss.
//  * Words: in shared memory, staged with 16-byte cp.async: a lane's words
//    (warp form) or the one contiguous range of a warp's 32 consecutive
//    lanes (thread form), from the start word to the end word plus the
//    reader's lookahead, up to budget_words (the wrapper sizes it from the
//    longest lane or group of 32, at most kMaxBudget).  A word outside the
//    staged range is read from device memory and the lane counted as over
//    budget; never a switch to the plain version.
//  * History as bit masks (K8d): a 64-bit mask per block of the band
//    positions with nonzero history, in zigzag order.  The walk of a
//    block (walk_block, shared by K8c and K8d) then runs on registers and
//    shared memory alone: a zero run of r is the (r+1)-th clear bit of the
//    mask at or after k, the correction bits of the positions it crosses
//    come out of one 64-bit stream window, and it records the positions
//    whose correction bit is 1, the new coefficients' positions and their
//    signs.  It never reads the plane.  Per chunk of 32 blocks the warp
//    loads each row (8 bytes a thread, one coalesced 256-byte load),
//    reduces it to the mask and ballots a map of the chunk's blocks with
//    history (the chunk's part of JAX's nextp), so that an EOB run skips
//    the blocks without history in O(1).  The planes must start on a
//    16-byte boundary (the wrapper checks).
//  * K8c skips an EOB run's blocks in O(1); the warp form keeps each
//    block's new terms in shared memory (chunks of 8 blocks).
//  * Apply.  Warp form: after each chunk the warp updates the touched
//    blocks, each thread its two positions: K8d adds +-(1 << al) where a
//    correction bit is 1 and the value's (1 << al) bit is clear and stores
//    the new +-(1 << al); K8c adds its terms (the plain version's add,
//    wrapping as uint32).  K8c's thread form adds its terms with atomic
//    adds that return nothing, so its chain never waits on a store.  Either
//    way only the elements that change are written: the DC chain writes
//    coefficient 0 of the same rows at the same time on its own stream.
//  * Counters, after the lane flags in the same zero-filled buffer: the
//    second-level tables used, the lanes that read a word outside their
//    staged range, the table probes that read device memory.
//
// Bound: bytes.  A scan reads its words once and touches the plane rows of
// its blocks (K8d reads the band of every block and writes what changes,
// K8a writes coefficient 0 of every block, K8b those whose bit is 1); the
// serial walk of the longest lane sets the time.
//
// Every lane checks itself: a bad code, a size or run out of range, a block
// row outside its plane, a position past the lane's end bit, and, for lanes
// chained by the skeleton walk, an end state that is not exactly the next
// lane's start (bit position and predictors or EOB run).  A failing lane
// sets err[lane] = 1 and stops; its blocks are then unspecified.  The
// redesigned kernels flag exactly as their first forms and the plain
// versions do, and leave the same planes.
//
// Plain versions: jpeg_decoder_tpu_torch/ops/entropy_prog_cuda.py.

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 10;   // blocks per MCU of an interleaved scan
constexpr int kMaxPlanes = 4;
constexpr int kThreads = 128;
constexpr int kGeoLen = 2 + 6 * kMaxSlots + 2 * kMaxPlanes;

// Slot geometry: block t of a lane whose first unit is m0 lies in unit
// m = m0 + t / bpm, slot j = t % bpm, plane plane[j] at row
// (my * v[j] + jv[j]) * pcols + mx * h[j] + jh[j], my = m / mx_div,
// mx = m % mx_div; comp[j] is the slot's component in scan order (its DC
// table).  A single-component scan has bpm 1, mx_div the component's
// unpadded block columns, v = h = 1 and jv = jh = 0.
struct Geo {
  int64_t bpm, mx_div;
  int64_t plane[kMaxSlots], v[kMaxSlots], jv[kMaxSlots], h[kMaxSlots],
      jh[kMaxSlots], comp[kMaxSlots];
  int64_t pcols[kMaxPlanes], n_rows[kMaxPlanes];
};

struct Planes {
  int32_t* p[kMaxPlanes];
};

__constant__ int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// The 32 stream bits from ``pos`` on.  The word index is clamped into the
// pool (a lane past its end reads garbage and is flagged by its end
// check); the shift by 32 - off is skipped at off == 0, where it would be
// undefined.
__device__ __forceinline__ uint32_t window32(const uint32_t* words,
                                             int64_t n_words, int64_t pos) {
  int64_t i = pos >> 5;
  if (i > n_words - 2) i = n_words - 2;
  const unsigned off = unsigned(pos & 31);
  const uint32_t a = words[i];
  return off ? (a << off) | (words[i + 1] >> (32 - off)) : a;
}

__device__ __forceinline__ uint32_t bit_at(const uint32_t* words,
                                           int64_t n_words, int64_t pos) {
  int64_t i = pos >> 5;
  if (i > n_words - 1) i = n_words - 1;
  return (words[i] >> (31 - unsigned(pos & 31))) & 1u;
}

// The top ``n`` (1..16) bits of ``w << len``.
__device__ __forceinline__ uint32_t take(uint32_t w, int len, int n) {
  return (w << len) >> (32 - n);
}

// JPEG sign extension of an ``size``-bit magnitude (T.81 F.2.2.1).
__device__ __forceinline__ int32_t extend(uint32_t raw, int size) {
  if (size == 0) return 0;
  return raw < (1u << (size - 1)) ? int32_t(raw) - ((1 << size) - 1)
                                  : int32_t(raw);
}

// Plane row of block t of a lane starting at unit m0; -1 when outside.
__device__ __forceinline__ int64_t slot_row(const Geo& g, int64_t m0,
                                            int64_t t, int* plane) {
  const int j = int(t % g.bpm);
  const int64_t m = m0 + t / g.bpm;
  const int64_t my = m / g.mx_div, mx = m - my * g.mx_div;
  const int p = int(g.plane[j]);
  const int64_t row = (my * g.v[j] + g.jv[j]) * g.pcols[p] + mx * g.h[j] +
                      g.jh[j];
  *plane = p;
  return (row < 0 || row >= g.n_rows[p]) ? -1 : row;
}

__device__ __forceinline__ void add_to(int32_t* dst, uint32_t v) {
  *dst = int32_t(uint32_t(*dst) + v);
}

// K8a's first form, kept as the same-card baseline of dc_warp_kernel and
// dc_thread_kernel (entry jd_prog_dc_v1; no path of the package launches
// it).  DC first scan (Ss = 0, Ah = 0), one thread per lane.  Block t of a
// lane is slot t % bpm of its MCU; its component's predictor takes the
// extended difference and coefficient 0 of its row gets ``pred << al`` (it
// is zero entering the scan, so the add is the store of
// entropy/progressive.py).
__global__ void dc_first_kernel_v1(const uint32_t* __restrict__ words,
                                int64_t n_words,
                                const int64_t* __restrict__ base,
                                const int64_t* __restrict__ end,
                                const int32_t* __restrict__ n_per,
                                const int64_t* __restrict__ first,
                                const int32_t* __restrict__ pred0, int nsc,
                                const int32_t* __restrict__ luts, Planes pl,
                                Geo g, int al, int chained, int64_t n_lanes,
                                int32_t* __restrict__ err) {
  const int64_t s = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_lanes) return;
  int64_t pos = base[s];
  const int64_t lim = end[s];
  uint32_t pred[kMaxPlanes] = {0, 0, 0, 0};
  for (int c = 0; c < nsc; ++c) pred[c] = uint32_t(pred0[s * nsc + c]);
  const int64_t nb = int64_t(n_per[s]) * g.bpm;
  const int64_t m0 = first[s];
  bool bad = false;
  for (int64_t t = 0; t < nb; ++t) {
    if (pos > lim) { bad = true; break; }
    int p;
    const int64_t row = slot_row(g, m0, t, &p);
    const int c = int(g.comp[t % g.bpm]);
    const uint32_t w = window32(words, n_words, pos);
    const int32_t e = luts[int64_t(c) * 65536 + (w >> 16)];
    const int len = e & 31, size = e >> 5;
    if (e == 0 || size > 11 || row < 0) { bad = true; break; }
    pred[c] += uint32_t(size ? extend(take(w, len, size), size) : 0);
    add_to(pl.p[p] + row * 64, pred[c] << al);
    pos += len + size;
  }
  if (!bad) bad = pos > lim;
  if (!bad && chained && s + 1 < n_lanes) {
    bad = pos != lim;
    for (int c = 0; c < nsc; ++c)
      bad |= pred[c] != uint32_t(pred0[(s + 1) * nsc + c]);
  }
  if (bad) err[s] = 1;
}

// K8b's first form, the same-card baseline of dc_refine_kernel (entry
// jd_prog_dc_v1).  DC refinement (Ss = 0, Ah > 0): block t of lane s reads
// the bit at base[s] + t and adds ``bit << al`` to coefficient 0 (the bit
// is zero entering the scan, so the add is the |= of
// entropy/progressive.py).  One thread per (lane, slot) over the lanes
// times the longest lane; slot 0 checks that the lane's bits lie before
// its end.
__global__ void dc_refine_kernel_v1(const uint32_t* __restrict__ words,
                                 int64_t n_words,
                                 const int64_t* __restrict__ base,
                                 const int64_t* __restrict__ end,
                                 const int32_t* __restrict__ n_per,
                                 const int64_t* __restrict__ first, Planes pl,
                                 Geo g, int al, int64_t n_lanes,
                                 int64_t max_blocks,
                                 int32_t* __restrict__ err) {
  const int64_t gid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= n_lanes * max_blocks) return;
  const int64_t s = gid / max_blocks, t = gid - s * max_blocks;
  const int64_t nb = int64_t(n_per[s]) * g.bpm;
  if (t >= nb) return;
  if (t == 0 && base[s] + nb > end[s]) err[s] = 1;
  int p;
  const int64_t row = slot_row(g, first[s], t, &p);
  if (row < 0) {
    err[s] = 1;
    return;
  }
  if (bit_at(words, n_words, base[s] + t)) add_to(pl.p[p] + row * 64,
                                                  1u << al);
}

// K8c's first form, kept as the same-card baseline of ac_lane_kernel (entry
// jd_prog_ac_v1; no path of the package launches it).  AC first scan (Ss >=
// 1, Ah = 0) of one component, one thread per lane.  A block covered by the
// pending EOB run is skipped; otherwise run/size symbols put
// ``extend(bits) << al`` at natural position ZIGZAG[k] (into zero slots:
// add equals store), ZRL advances k by 16 and an EOB run of r gives
// (1 << r) + bits(r) blocks, this one among them.
__global__ void ac_first_kernel_v1(const uint32_t* __restrict__ words,
                                int64_t n_words,
                                const int64_t* __restrict__ base,
                                const int64_t* __restrict__ end,
                                const int32_t* __restrict__ n_per,
                                const int64_t* __restrict__ first,
                                const int32_t* __restrict__ eob0,
                                const int32_t* __restrict__ lut,
                                int32_t* __restrict__ plane, Geo g, int ss,
                                int se, int al, int chained, int64_t n_lanes,
                                int32_t* __restrict__ err) {
  const int64_t s = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_lanes) return;
  int64_t pos = base[s];
  const int64_t lim = end[s];
  int64_t eob = eob0[s];
  const int64_t n = n_per[s], m0 = first[s];
  bool bad = false;
  for (int64_t t = 0; t < n && !bad; ++t) {
    if (eob > 0) {
      --eob;
      continue;
    }
    int p;
    const int64_t row = slot_row(g, m0, t, &p);
    if (row < 0) { bad = true; break; }
    int32_t* blk = plane + row * 64;
    int k = ss;
    while (k <= se) {
      if (pos > lim) { bad = true; break; }
      const uint32_t w = window32(words, n_words, pos);
      const int32_t e = lut[w >> 16];
      if (e == 0) { bad = true; break; }
      const int len = e & 31, sym = (e >> 5) & 0xFF;
      const int r = sym >> 4, sz = sym & 15;
      if (sz == 0) {
        if (r < 15) {
          eob = (int64_t(1) << r) - 1 + (r ? take(w, len, r) : 0);
          pos += len + r;
          break;
        }
        pos += len;
        k += 16;  // ZRL
      } else {
        k += r;
        if (k > se) { bad = true; break; }
        add_to(blk + kZigzag[k], uint32_t(extend(take(w, len, sz), sz)) << al);
        pos += len + sz;
        ++k;
      }
    }
  }
  if (!bad) bad = pos > lim;
  if (!bad && chained && s + 1 < n_lanes)
    bad = pos != lim || eob != eob0[s + 1];
  if (bad) err[s] = 1;
}

// K8d's first form, the same-card baseline (entry jd_prog_ac_v1).  AC
// refinement (Ss >= 1, Ah > 0) of one component (T.81 G.2.3), one thread per
// lane.  The history of a band position is the plane's value there: a nonzero one
// takes a correction bit (+-(1 << al) in its sign's direction when its
// (1 << al) bit is clear), a zero one counts toward the symbol's zero run
// and the new +-(1 << al) coefficient goes to the run's end.  Blocks under
// an EOB run still take correction bits.  Lanes own their blocks, so the
// read-modify-write of a row is the lane's alone.
__global__ void ac_refine_kernel_v1(const uint32_t* __restrict__ words,
                                 int64_t n_words,
                                 const int64_t* __restrict__ base,
                                 const int64_t* __restrict__ end,
                                 const int32_t* __restrict__ n_per,
                                 const int64_t* __restrict__ first,
                                 const int32_t* __restrict__ eob0,
                                 const int32_t* __restrict__ lut,
                                 int32_t* __restrict__ plane, Geo g, int ss,
                                 int se, int al, int chained,
                                 int64_t n_lanes, int32_t* __restrict__ err) {
  const int64_t s = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_lanes) return;
  int64_t pos = base[s];
  const int64_t lim = end[s];
  int64_t eob = eob0[s];
  const int64_t n = n_per[s], m0 = first[s];
  const int32_t p1 = 1 << al;
  bool bad = false;
  // A correction bit for the nonzero coefficient at *d.
  auto correct = [&](int32_t* d, int32_t v) {
    const uint32_t b = bit_at(words, n_words, pos);
    ++pos;
    if (b && (v & p1) == 0) *d = v > 0 ? v + p1 : v - p1;
  };
  for (int64_t t = 0; t < n && !bad; ++t) {
    int p;
    const int64_t row = slot_row(g, m0, t, &p);
    if (row < 0) { bad = true; break; }
    int32_t* blk = plane + row * 64;
    int k = ss;
    if (eob == 0) {
      while (k <= se) {
        if (pos > lim) { bad = true; break; }
        const uint32_t w = window32(words, n_words, pos);
        const int32_t e = lut[w >> 16];
        if (e == 0) { bad = true; break; }
        const int len = e & 31, sym = (e >> 5) & 0xFF;
        int r = sym >> 4;
        const int sz = sym & 15;
        int32_t newval = 0;
        pos += len;
        if (sz == 0) {
          if (r < 15) {
            eob = (int64_t(1) << r) + (r ? take(w, len, r) : 0);
            pos += r;
            break;
          }
          // ZRL: 16 zero-history positions, no new value.
        } else {
          if (sz != 1) { bad = true; break; }
          newval = take(w, len, 1) ? p1 : -p1;
          pos += 1;
        }
        while (k <= se) {
          int32_t* d = blk + kZigzag[k];
          const int32_t v = *d;
          if (v != 0) {
            correct(d, v);
          } else {
            if (r == 0) break;
            --r;
          }
          ++k;
        }
        if (newval && k <= se) blk[kZigzag[k]] = newval;
        ++k;
      }
    }
    if (eob > 0 && !bad) {
      for (; k <= se; ++k) {
        int32_t* d = blk + kZigzag[k];
        const int32_t v = *d;
        if (v != 0) correct(d, v);
      }
      --eob;
    }
  }
  if (!bad) bad = pos > lim;
  if (!bad && chained && s + 1 < n_lanes)
    bad = pos != lim || eob != eob0[s + 1];
  if (bad) err[s] = 1;
}

// ---- K8c and K8d: one warp per lane ----------------------------------------
//
// See the file header for the design.  A CTA is one warp; it stages the
// compact AC table once, then walks lanes blockIdx.x, + gridDim.x, ...: per
// lane it stages the lane's words, and per chunk of blocks the warp builds
// the history masks (K8d), lane 0 walks the chunk's symbols on registers
// and shared memory, and the warp applies the chunk's results.

constexpr int kAcL1Bits = 11;                  // first-level index bits
constexpr int kAcL1Size = 1 << kAcL1Bits;
constexpr int kAcL2Bits = 16 - kAcL1Bits;
constexpr int kAcL2Size = 1 << kAcL2Bits;
constexpr int kAcL2Slots = 64;                 // second-level tables, most
constexpr int kLookahead = 3;                  // words past a lane's end word
constexpr int kDcLookahead = 7;                // the same for K8a (dc_range)
constexpr int kMaxBudget = 4096;               // staged words per lane, most
constexpr unsigned kFull = 0xffffffffu;

__constant__ uint8_t kZigzagInv[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

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

// Copy n 4-byte words to shared memory, 16 bytes at a time where both ends
// allow it, thread t of nt.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src,
                                      int64_t n, bool aligned, int t,
                                      int nt) {
  for (int64_t i = 4 * t; i < n; i += 4 * nt) {
    if (aligned && i + 4 <= n) {
      cp_async16(dst + i, src + i);
    } else {
      for (int q = 0; q < 4 && i + q < n; ++q)
        cp_async4(dst + i + q, src + i + q);
    }
  }
}

// Zigzag positions k .. se as a mask (0 when k > se; 1 <= k, se <= 63).
__device__ __forceinline__ uint64_t band_from(int k, int se) {
  if (k > se) return 0;
  const uint64_t hi = se >= 63 ? ~0ull : (1ull << (se + 1)) - 1;
  return (~0ull << k) & hi;
}

struct AcArgs {
  const uint32_t* words;
  const int64_t* base;
  const int64_t* end;
  const int32_t* n_per;
  const int64_t* first;
  const int32_t* eob0;
  const int32_t* lut;      // (65536,) for the prefixes the table left out
  const int16_t* tab;      // l1 (kAcL1Size) then n_slots second levels
  int32_t* plane;
  int32_t* err;            // (n_lanes,) then 3 counters, zeroed
  int64_t n_words, n_lanes;
  int ss, se, al, chained, budget_words, n_slots, l2_full;
};

// A lane's words: [s_lo, s_hi) staged in shared memory from s[0], the rest
// read from device memory (setting far; past the pool the last word: such
// a lane is past its end and flagged).
struct Stream {
  const uint32_t* g;
  const uint32_t* s;
  int64_t s_lo, s_hi, n_words;
  bool far;
  // Words ci, ci + 1, ci + 2 of the last window (ci < 0: none yet): the
  // position only grows, so most windows start in the same word or the
  // next one and read one word or none.
  int64_t ci;
  uint32_t c0, c1, c2;

  __device__ __forceinline__ uint32_t word(int64_t i) {
    if (i >= s_lo && i < s_hi) return s[i - s_lo];
    far = true;
    if (i > n_words - 1) i = n_words - 1;
    return __ldg(g + i);
  }
  // The 64 stream bits from ``p`` on (the shift by 32 - off skipped at
  // off == 0, where it would be undefined).
  __device__ __forceinline__ uint64_t window(int64_t p) {
    const int64_t i = p >> 5;
    if (i == ci + 1) {
      c0 = c1;
      c1 = c2;
      c2 = word(i + 2);
    } else if (i != ci) {
      c0 = word(i);
      c1 = word(i + 1);
      c2 = word(i + 2);
    }
    ci = i;
    const unsigned off = unsigned(p & 31);
    const uint64_t hi = (uint64_t(c0) << 32) | c1;
    return off ? (hi << off) | (c2 >> (32 - off)) : hi;
  }
};

// The compact table in shared memory; a prefix it left out (l2_full) reads
// the LUT in device memory, counted in misses.
struct Probe {
  const int16_t* l1;
  const int16_t* l2;
  const int32_t* lut;
  bool l2_full;
  uint32_t misses;

  __device__ __forceinline__ int32_t operator()(uint32_t p16) {
    const int32_t e = l1[p16 >> kAcL2Bits];
    if (e > 0) return e;
    if (e < 0) return l2[(-e - 1) * kAcL2Size + (p16 & (kAcL2Size - 1))];
    if (!l2_full) return 0;
    ++misses;
    return __ldg(lut + p16);
  }
};

// The correction bits of the positions ``crossed``, in increasing order
// the next popc(crossed) stream bits: the mask of those whose bit is 1.
// Advances pos.
__device__ __forceinline__ uint64_t corrections(Stream& st, int64_t& pos,
                                                uint64_t crossed) {
  if (crossed == 0) return 0;
  uint64_t bits = st.window(pos), out = 0;
  pos += __popcll(crossed);
  while (crossed) {
    const uint64_t low = crossed & (~crossed + 1);
    if (bits >> 63) out |= low;
    bits <<= 1;
    crossed ^= low;
  }
  return out;
}

// One block of a lane, from ``pos`` with the pending EOB run ``eob``, as
// the first forms walk it (a block of K8c under an EOB run is the caller's
// to skip).  K8c: each new term goes to put(k, value), its position to
// newp.  K8d: ``nz`` holds the band positions with history; a zero run of r
// stops at the (r+1)-th zero-history position at or after k, the
// nonzero-history positions before it take correction bits (those that are
// 1 go to fix), the new +-(1 << al) to the stop (newp, and neg where it is
// negative); no stop inside the band ends the block; a block under an EOB
// run takes a correction bit at each of its positions with history.
// Returns false for a bad code, a size or run out of range or a position
// past lim before a symbol (the lane is flagged; what the block recorded
// until then stands, as in the first forms).
template <bool kRefine, class Put>
__device__ __forceinline__ bool walk_block(Stream& st, Probe& probe,
                                           int64_t& pos, int64_t& eob,
                                           int64_t lim, int ss, int se,
                                           int al, uint64_t nz, uint64_t& fix,
                                           uint64_t& newp, uint64_t& neg,
                                           Put&& put) {
  int k = ss;
  if (eob == 0) {
    while (k <= se) {
      if (pos > lim) return false;
      const uint64_t w = st.window(pos);
      const int32_t e = probe(uint32_t(w >> 48));
      if (e == 0) return false;
      const int len = e & 31, sym = (e >> 5) & 0xFF;
      const int r = sym >> 4, sz = sym & 15;
      const uint64_t wl = w << len;   // len <= 16
      if (!kRefine) {
        if (sz == 0) {
          if (r < 15) {
            eob = (int64_t(1) << r) - 1 + (r ? int64_t(wl >> (64 - r)) : 0);
            pos += len + r;
            return true;
          }
          pos += len;
          k += 16;   // ZRL
          continue;
        }
        k += r;
        if (k > se) return false;
        put(k, int32_t(uint32_t(extend(uint32_t(wl >> (64 - sz)), sz))
                       << al));
        newp |= 1ull << k;
        pos += len + sz;
        ++k;
        continue;
      }
      pos += len;
      bool has_new = false, is_neg = false;
      if (sz == 0) {
        if (r < 15) {
          eob = (int64_t(1) << r) + (r ? int64_t(wl >> (64 - r)) : 0);
          pos += r;
          break;
        }
        // ZRL: 16 zero-history positions, no new value.
      } else {
        if (sz != 1) return false;
        has_new = true;
        is_neg = (wl >> 63) == 0;
        pos += 1;
      }
      const uint64_t from_k = band_from(k, se);
      uint64_t z = ~nz & from_k;
      for (int q = 0; q < r && z; ++q) z &= z - 1;
      if (z == 0) {
        fix |= corrections(st, pos, nz & from_k);
        k = se + 1;
        break;
      }
      const int stop = __ffsll(static_cast<long long>(z)) - 1;
      fix |= corrections(st, pos, nz & from_k & ((1ull << stop) - 1));
      if (has_new) {
        newp |= 1ull << stop;
        if (is_neg) neg |= 1ull << stop;
      }
      k = stop + 1;
    }
  }
  if (kRefine && eob > 0) {
    fix |= corrections(st, pos, nz & band_from(k, se));
    --eob;
  }
  return true;
}

// The lane end checks of the first forms: flag a lane past its end bit,
// and a chained lane that does not end exactly at the next one's start.
__device__ __forceinline__ void end_lane(const AcArgs& a, int64_t s, bool bad,
                                         int64_t pos, int64_t lim,
                                         int64_t eob) {
  if (!bad) bad = pos > lim;
  if (!bad && a.chained && s + 1 < a.n_lanes)
    bad = pos != lim || eob != a.eob0[s + 1];
  if (bad) a.err[s] = 1;
}

// Blocks a lane walks per chunk in the warp form: K8d's history masks take
// a warp's 32 (one bit of a ballot each); K8c keeps its chunk's terms, 64
// int32 a block.
__host__ __device__ constexpr int ac_chunk(bool refine) {
  return refine ? 32 : 8;
}

// Dynamic shared memory of one CTA: the compact table, the warp form's
// chunk masks, rows and K8c's terms, and the staged words of a lane (warp
// form) or of the CTA's 32 lanes (thread form).
__host__ __device__ constexpr int ac_smem_bytes(bool refine, bool threads,
                                                int n_slots, int budget) {
  return 2 * (kAcL1Size + n_slots * kAcL2Size) +
         (threads ? 0
                  : 8 * 5 * ac_chunk(refine) +
                        (refine ? 0 : 4 * 64 * ac_chunk(refine))) +
         4 * budget;
}

// The warp form: one warp per lane, persistent over the lanes.
template <bool kRefine>
__global__ void __launch_bounds__(32, 24) ac_warp_kernel(AcArgs a, Geo g) {
  constexpr int kCh = ac_chunk(kRefine);
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* s_l1 = reinterpret_cast<int16_t*>(smem);
  int16_t* s_l2 = s_l1 + kAcL1Size;
  uint64_t* s_nz =
      reinterpret_cast<uint64_t*>(s_l2 + a.n_slots * kAcL2Size);
  uint64_t* s_fix = s_nz + kCh;        // K8d: correction bits that are 1
  uint64_t* s_newp = s_fix + kCh;      // new coefficients' positions
  uint64_t* s_neg = s_newp + kCh;      // K8d: the new ones that are -p1
  int64_t* s_row = reinterpret_cast<int64_t*>(s_neg + kCh);
  int32_t* s_val = reinterpret_cast<int32_t*>(s_row + kCh);   // K8c
  uint32_t* s_words =
      reinterpret_cast<uint32_t*>(s_val + (kRefine ? 0 : 64 * kCh));
  __shared__ uint32_t s_touch;

  const int lane = threadIdx.x;
  const int32_t p1 = 1 << a.al;
  // This thread's two natural positions, their zigzag indices and band
  // bits (the mask build and the apply).
  const int n0 = 2 * lane, n1 = 2 * lane + 1;
  const int k0 = kZigzagInv[n0], k1 = kZigzagInv[n1];
  const uint64_t bm0 = k0 >= a.ss && k0 <= a.se ? 1ull << k0 : 0;
  const uint64_t bm1 = k1 >= a.ss && k1 <= a.se ? 1ull << k1 : 0;

  // The compact table, once per CTA.
  stage(reinterpret_cast<uint32_t*>(s_l1),
        reinterpret_cast<const uint32_t*>(a.tab),
        (kAcL1Size + a.n_slots * kAcL2Size) / 2,
        (reinterpret_cast<uintptr_t>(a.tab) & 15) == 0, lane, 32);
  const bool words_aligned = (reinterpret_cast<uintptr_t>(a.words) & 15) == 0;

  Probe probe{s_l1, s_l2, a.lut, a.l2_full != 0, 0};
  uint32_t over = 0;
  for (int64_t s = blockIdx.x; s < a.n_lanes; s += gridDim.x) {
    const int64_t base = a.base[s], lim = a.end[s];
    const int64_t n = a.n_per[s], m0 = a.first[s];
    // Stage the lane's words [s_lo, s_hi): from its start word (rounded
    // down to 4 words) to its end word plus the lookahead, at most the
    // budget.  The previous lane's walk is done (the __syncwarp closing
    // its last chunk).
    const int64_t s_lo = (base >> 5) & ~int64_t(3);
    int64_t s_hi = (lim >> 5) + kLookahead;
    if (s_hi > a.n_words) s_hi = a.n_words;
    if (s_hi - s_lo > a.budget_words) s_hi = s_lo + a.budget_words;
    if (s_hi < s_lo) s_hi = s_lo;
    stage(s_words, a.words + s_lo, s_hi - s_lo, words_aligned, lane, 32);
    cp_async_wait_all();
    __syncwarp();

    // Lane 0's walk state.
    Stream st{a.words, s_words, s_lo, s_hi, a.n_words, false, -4, 0, 0, 0};
    int64_t pos = base, eob = a.eob0[s];
    bool bad = false;

    for (int64_t t0 = 0; t0 < n; t0 += kCh) {
      const int nb = int(n - t0 < kCh ? n - t0 : kCh);
      int p_unused;
      const int64_t my_row =
          lane < nb ? slot_row(g, m0, t0 + lane, &p_unused) : -1;
      uint32_t any = 0;
      if (kRefine) {
        // History masks: block j's band positions whose value is nonzero,
        // one coalesced 256-byte row load per block (8 bytes a thread),
        // eight loads in flight.
        uint64_t my_nz = 0;
#pragma unroll
        for (int j8 = 0; j8 < kCh; j8 += 8) {
          int2 v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int64_t row = __shfl_sync(kFull, my_row, j8 + q);
            v[q] = j8 + q < nb && row >= 0
                       ? reinterpret_cast<const int2*>(a.plane + row * 64)[lane]
                       : make_int2(0, 0);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const uint64_t bits =
                (v[q].x != 0 ? bm0 : 0) | (v[q].y != 0 ? bm1 : 0);
            const uint32_t lo = __reduce_or_sync(kFull, uint32_t(bits));
            const uint32_t hi = __reduce_or_sync(kFull, uint32_t(bits >> 32));
            if (lane == j8 + q) my_nz = (uint64_t(hi) << 32) | lo;
          }
        }
        s_nz[lane] = my_nz;
        // The blocks a run of EOB-covered blocks cannot skip: history, or a
        // row outside the plane (flagged when reached).
        any = __ballot_sync(kFull, lane < nb && (my_nz != 0 || my_row < 0));
      }
      if (lane < kCh) s_row[lane] = my_row;
      __syncwarp();

      if (lane == 0) {
        uint32_t touched = 0;
        int j = 0;
        while (j < nb && !bad) {
          if (eob > 0) {
            // Covered blocks: K8c skips them all; K8d those without history
            // (their walk would take no bit).
            int run = nb - j;
            if (kRefine && (any >> j)) run = __ffs(any >> j) - 1;
            if (run > eob) run = int(eob);
            if (run > 0) {
              eob -= run;
              j += run;
              continue;
            }
          }
          if (s_row[j] < 0) {
            bad = true;
            break;
          }
          uint64_t fix = 0, newp = 0, neg = 0;
          int32_t* vals = s_val + j * 64;
          bad = !walk_block<kRefine>(
              st, probe, pos, eob, lim, a.ss, a.se, a.al,
              kRefine ? s_nz[j] : 0, fix, newp, neg,
              [vals](int k, int32_t v) { vals[k] = v; });
          s_newp[j] = newp;
          if (kRefine) {
            s_fix[j] = fix;
            s_neg[j] = neg;
          }
          if (newp | fix) touched |= 1u << j;
          ++j;
        }
        s_touch = touched;
      }
      __syncwarp();

      // Apply: per touched block, each thread its two positions, storing
      // only the elements that change (coefficient 0 and the band's other
      // positions stay untouched: the DC chain may be writing them).  Up
      // to 8 blocks at a time: their loads first, then their stores.
      uint32_t touched = s_touch;
      while (touched) {
        int js[8];
        int nj = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          js[q] = touched ? __ffs(touched) - 1 : -1;
          if (touched) {
            touched &= touched - 1;
            nj = q + 1;
          }
        }
        int32_t v[8][2];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q >= nj) break;
          const int32_t* r = a.plane + s_row[js[q]] * 64;
          // K8d reads the values it corrects, K8c those it adds to.
          const uint64_t rd = kRefine ? s_fix[js[q]] : s_newp[js[q]];
          v[q][0] = (rd >> k0) & 1 ? r[n0] : 0;
          v[q][1] = (rd >> k1) & 1 ? r[n1] : 0;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q >= nj) break;
          const int j = js[q];
          int32_t* r = a.plane + s_row[j] * 64;
          const uint64_t newp = s_newp[j];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int nn = h ? n1 : n0, kk = h ? k1 : k0;
            const int32_t x = v[q][h];
            if (kRefine) {
              if ((s_fix[j] >> kk) & 1) {
                if ((x & p1) == 0) r[nn] = x > 0 ? x + p1 : x - p1;
              } else if ((newp >> kk) & 1) {
                r[nn] = ((s_neg[j] >> kk) & 1) ? -p1 : p1;
              }
            } else if ((newp >> kk) & 1) {
              r[nn] = int32_t(uint32_t(x) + uint32_t(s_val[j * 64 + kk]));
            }
          }
        }
      }
      __syncwarp();
      if (__shfl_sync(kFull, int(bad), 0)) break;
    }

    if (lane == 0) {
      end_lane(a, s, bad, pos, lim, eob);
      over += st.far;
    }
  }
  int32_t* stats = a.err + a.n_lanes;
  if (lane == 0 && blockIdx.x == 0) stats[0] = a.n_slots;
  if (lane == 0 && (over | probe.misses)) {
    atomicAdd(stats + 1, int(over));
    atomicAdd(stats + 2, int(probe.misses));
  }
}

// K8c's thread form: one thread per lane, one warp per CTA; the warp
// stages the compact table and the words of its 32 consecutive lanes (one
// contiguous range, at most budget words).  A thread skips its EOB runs'
// blocks and adds its terms straight into its own blocks with atomic adds
// that return nothing (the thread does not wait on them).
__global__ void __launch_bounds__(32) ac_first_thread_kernel(AcArgs a, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* s_l1 = reinterpret_cast<int16_t*>(smem);
  int16_t* s_l2 = s_l1 + kAcL1Size;
  uint32_t* s_words =
      reinterpret_cast<uint32_t*>(s_l2 + a.n_slots * kAcL2Size);
  __shared__ uint8_t s_zz[64];

  const int lane = threadIdx.x;
  s_zz[lane] = uint8_t(kZigzag[lane]);
  s_zz[lane + 32] = uint8_t(kZigzag[lane + 32]);
  stage(reinterpret_cast<uint32_t*>(s_l1),
        reinterpret_cast<const uint32_t*>(a.tab),
        (kAcL1Size + a.n_slots * kAcL2Size) / 2,
        (reinterpret_cast<uintptr_t>(a.tab) & 15) == 0, lane, 32);
  const int64_t s0 = int64_t(blockIdx.x) * 32;
  const int64_t s = s0 + lane;
  int64_t s_lo = 0, s_hi = 0;
  if (s0 < a.n_lanes) {
    const int64_t last = s0 + 31 < a.n_lanes ? s0 + 31 : a.n_lanes - 1;
    s_lo = (a.base[s0] >> 5) & ~int64_t(3);
    s_hi = (a.end[last] >> 5) + kLookahead;
    if (s_hi > a.n_words) s_hi = a.n_words;
    if (s_hi - s_lo > a.budget_words) s_hi = s_lo + a.budget_words;
    if (s_hi < s_lo) s_hi = s_lo;
    stage(s_words, a.words + s_lo, s_hi - s_lo,
          (reinterpret_cast<uintptr_t>(a.words) & 15) == 0, lane, 32);
  }
  cp_async_wait_all();
  __syncwarp();

  Stream st{a.words, s_words, s_lo, s_hi, a.n_words, false, -4, 0, 0, 0};
  Probe probe{s_l1, s_l2, a.lut, a.l2_full != 0, 0};
  if (s < a.n_lanes) {
    int64_t pos = a.base[s], eob = a.eob0[s];
    const int64_t lim = a.end[s], n = a.n_per[s], m0 = a.first[s];
    bool bad = false;
    for (int64_t t = 0; t < n && !bad;) {
      if (eob > 0) {   // covered blocks: nothing to do
        const int64_t run = eob < n - t ? eob : n - t;
        eob -= run;
        t += run;
        continue;
      }
      int p_unused;
      const int64_t row = slot_row(g, m0, t, &p_unused);
      if (row < 0) {
        bad = true;
        break;
      }
      int32_t* blk = a.plane + row * 64;
      uint64_t fix = 0, newp = 0, neg = 0;
      bad = !walk_block<false>(
          st, probe, pos, eob, lim, a.ss, a.se, a.al, 0, fix, newp, neg,
          [blk](int k, int32_t v) { atomicAdd(blk + s_zz[k], v); });
      ++t;
    }
    end_lane(a, s, bad, pos, lim, eob);
  }
  const unsigned over = __reduce_add_sync(kFull, st.far ? 1u : 0u);
  const unsigned misses = __reduce_add_sync(kFull, probe.misses);
  int32_t* stats = a.err + a.n_lanes;
  if (lane == 0 && blockIdx.x == 0) stats[0] = a.n_slots;
  if (lane == 0 && (over | misses)) {
    atomicAdd(stats + 1, int(over));
    atomicAdd(stats + 2, int(misses));
  }
}

// ---- K8a and K8b ------------------------------------------------------------
//
// See the file header for the design.  Both take the slot geometry in 32
// bits with each slot's plane pointer and plane size folded in (dc_geo on
// the host), copied once per CTA into shared memory.

struct SlotGeo {
  int32_t* dst;                 // the slot's plane
  int32_t v, jv, h, jh, comp, pcols, n_rows;
};
struct DcGeo {
  int32_t bpm, mx_div;
  SlotGeo slot[kMaxSlots];
};

__device__ __forceinline__ void load_slots(const DcGeo& g, SlotGeo* s) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kMaxSlots; ++j) s[j] = g.slot[j];
  }
}

// Each slot's component, two bits a slot: the walk's table and predictor
// for slot j without a load.
__device__ __forceinline__ uint32_t slot_comps(const DcGeo& g) {
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) out |= uint32_t(g.slot[j].comp & 3)
                                             << (2 * j);
  return out;
}

// Plane row of unit (mx, my)'s slot; -1 when outside the plane.
__device__ __forceinline__ int64_t dc_row(const SlotGeo& sg, int mx, int my) {
  const int64_t row = (int64_t(my) * sg.v + sg.jv) * sg.pcols +
                      int64_t(mx) * sg.h + sg.jh;
  return (row < 0 || row >= sg.n_rows) ? -1 : row;
}

struct DcArgs {
  const uint32_t* words;
  const int64_t* base;
  const int64_t* end;
  const int32_t* n_per;
  const int64_t* first;
  const int32_t* pred0;    // (n_lanes, nsc)
  const int32_t* luts;     // (nsc, 65536) for the prefixes the tables left out
  const int16_t* tab;      // nsc first levels, then n_slots second levels
  int32_t* err;            // (n_lanes,) then 3 counters, zeroed
  int64_t n_words, n_lanes;
  int nsc, al, chained, budget_words, n_slots, l2_full;   // l2_full: bit c
  DcGeo g;
};

// The compact DC tables in shared memory: component c's first level at
// c * kAcL1Size; a prefix left out of component c's second levels (bit c of
// l2_full) reads its LUT in device memory, counted in misses.
struct DcProbe {
  const int16_t* l1;
  const int16_t* l2;
  const int32_t* lut;
  int l2_full;
  uint32_t misses;

  // The entry of the 16-bit window p16 of component c, given its
  // first-level entry e: e itself when positive, else its second level or
  // (a prefix left out) its LUT, or 0 for no code.
  __device__ __forceinline__ int32_t resolve(int32_t e, int c, uint32_t p16) {
    if (e > 0) return e;
    if (e < 0) return l2[(-e - 1) * kAcL2Size + (p16 & (kAcL2Size - 1))];
    if (!((l2_full >> c) & 1)) return 0;
    ++misses;
    return __ldg(lut + (int64_t(c) << 16) + p16);
  }
};

// A DC first-level entry that needs nothing more: a code of at most 11 bits
// whose size is at most 11 (0 < e <= 11 << 5 | 31).
__device__ __forceinline__ bool dc_short(int32_t e) {
  return unsigned(e - 1) < unsigned((11 << 5) | 31);
}

// The bit reader of a walk whose every read lies in the staged words (the
// staging reaches kDcLookahead words past the end bit: a walk stops at
// most four symbols past it): a 32-bit position from the staging's first
// word, the two words under the window and the next one in registers.  A
// DC symbol takes at most 27 bits, so a step moves on by one word at most,
// and the word the window then needs was loaded before: every step loads
// the word after the next one again (the same word unless the step
// crossed one) straight into its register, so nothing waits on that load
// until the next crossing, and the window is a funnel shift of registers.
struct StagedBits {
  static constexpr bool kGroups = true;   // four symbols without a branch
  const uint32_t* s;
  uint32_t p, c0, c1, c2;

  __device__ __forceinline__ StagedBits(const uint32_t* s_, uint32_t p_)
      : s(s_), p(p_) {
    c0 = s[p >> 5];
    c1 = s[(p >> 5) + 1];
    c2 = s[(p >> 5) + 2];
  }
  // The 32 stream bits from p on (the funnel shift takes p & 31).
  __device__ __forceinline__ uint32_t window() const {
    return __funnelshift_l(c1, c0, p);
  }
  __device__ __forceinline__ void skip(int n) {
    const uint32_t q = p + unsigned(n);
    const bool cross = (q ^ p) >> 5;
    c0 = cross ? c1 : c0;
    c1 = cross ? c2 : c1;
    c2 = s[(q >> 5) + 2];
    p = q;
  }
  __device__ __forceinline__ bool past(uint32_t lim) const { return p > lim; }
  __device__ __forceinline__ bool far() const { return false; }
};

// The bit reader of a walk that may leave its staged words (K8c's Stream:
// a word outside is read from device memory and marks the walk far).
struct FarBits {
  static constexpr bool kGroups = false;
  Stream st;
  uint32_t p;   // bits from the staging's first word

  __device__ __forceinline__ uint32_t window() {
    return uint32_t(st.window(st.s_lo * 32 + p) >> 32);
  }
  __device__ __forceinline__ void skip(int n) { p += unsigned(n); }
  __device__ __forceinline__ bool past(uint32_t lim) const { return p > lim; }
  __device__ __forceinline__ bool far() const { return st.far; }
};

// One DC symbol of component c at the reader's position, as the first
// form decodes it: false for a bad code or a size over 11, and when the
// symbol ends past ``lim`` (the first form then flags the lane before the
// next symbol or at its end); else pred[c] takes the difference and *v
// gets ``pred[c] << al``.  The reader's position must be at most lim.
template <class Bits>
__device__ __forceinline__ bool dc_step(Bits& bits, DcProbe& probe,
                                        uint32_t lim, int c, uint32_t* pred,
                                        int al, int32_t* v) {
  const uint32_t w = bits.window();
  int32_t e = probe.l1[c * kAcL1Size + int(w >> (32 - kAcL1Bits))];
  if (!dc_short(e)) {
    e = probe.resolve(e, c, w >> 16);
    if (e == 0 || (e >> 5) > 11) return false;
  }
  const int len = e & 31, size = e >> 5;
  bits.skip(len + size);
  const uint32_t d =
      size ? uint32_t(extend((w << len) >> (32 - size), size)) : 0u;
#pragma unroll
  for (int k = 0; k < kMaxPlanes; ++k) {
    if (k == c) {
      pred[k] += d;
      *v = int32_t(pred[k] << al);
    }
  }
  return !bits.past(lim);
}

// Walk up to n DC symbols of a lane from slot jw on, recording each
// symbol's 32-bit window and table entry in rec[q] for the warp to decode
// (dc_value): the walker's chain is only the probe and the position.
// Stops as dc_step does (the reader's position must be at most lim);
// *done counts the symbols recorded.  With Bits::kGroups it walks four
// symbols at a time without a branch while each is a short code and the
// four end at most at lim, and otherwise walks them again one at a time
// with every check.
template <class Bits>
__device__ __forceinline__ bool dc_walk_rec(Bits& bits, DcProbe& probe,
                                            uint32_t lim, uint32_t comps,
                                            int bpm, int& jw, int n,
                                            uint2* rec, int* done) {
  int q = 0;
  bool ok = true;
  while (q < n) {
    if (Bits::kGroups && q + 4 <= n) {
      const Bits keep = bits;
      int jg = jw;
      bool fine = true;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = (comps >> (2 * jg)) & 3;
        const uint32_t w = bits.window();
        const int32_t e =
            probe.l1[c * kAcL1Size + int(w >> (32 - kAcL1Bits))];
        const bool short_code = dc_short(e);
        fine &= short_code;
        bits.skip(short_code ? (e & 31) + (e >> 5) : 0);
        rec[q + u] = make_uint2(w, uint32_t(e));
        jg = jg + 1 == bpm ? 0 : jg + 1;
      }
      if (fine && !bits.past(lim)) {
        q += 4;
        jw = jg;
        continue;
      }
      bits = keep;
    }
    const int c = (comps >> (2 * jw)) & 3;
    const uint32_t w = bits.window();
    int32_t e = probe.l1[c * kAcL1Size + int(w >> (32 - kAcL1Bits))];
    if (!dc_short(e)) {
      e = probe.resolve(e, c, w >> 16);
      if (e == 0 || (e >> 5) > 11) {
        ok = false;
        break;
      }
    }
    bits.skip((e & 31) + (e >> 5));
    rec[q++] = make_uint2(w, uint32_t(e));
    jw = jw + 1 == bpm ? 0 : jw + 1;
    if (bits.past(lim)) {
      ok = false;
      break;
    }
  }
  *done = q;
  return ok;
}

// The DC difference of a recorded symbol (window w, entry e).
__device__ __forceinline__ uint32_t dc_value(uint32_t w, int32_t e) {
  const int len = e & 31, size = e >> 5;
  return size ? uint32_t(extend((w << len) >> (32 - size), size)) : 0u;
}

// The end checks of the first form for a lane that decoded without fault:
// past its end bit, or (chained) not ending exactly at the next lane's
// start bit with its predictors.
__device__ __forceinline__ bool dc_end_bad(const DcArgs& a, int64_t s,
                                           int64_t pos, int64_t lim,
                                           const uint32_t* pred) {
  if (pos > lim) return true;
  if (!a.chained || s + 1 >= a.n_lanes) return false;
  bool bad = pos != lim;
#pragma unroll
  for (int c = 0; c < kMaxPlanes; ++c)
    if (c < a.nsc) bad |= pred[c] != uint32_t(a.pred0[(s + 1) * a.nsc + c]);
  return bad;
}

// The words from ``lo`` (rounded down to 4) through ``hi``'s end bit and
// the reader's lookahead, at most ``budget``: [*s_lo, *s_hi); true when
// that is all of them (the walk needs no device read, StagedBits).
__device__ __forceinline__ bool dc_range(int64_t lo, int64_t hi,
                                         int64_t n_words, int budget,
                                         int64_t* s_lo, int64_t* s_hi) {
  *s_lo = (lo >> 5) & ~int64_t(3);
  int64_t need = (hi >> 5) + kDcLookahead;
  if (need > n_words) need = n_words;
  if (need < *s_lo) need = *s_lo;
  *s_hi = need - *s_lo > budget ? *s_lo + budget : need;
  return *s_hi == need;
}

// Dynamic shared memory of one CTA of K8a: the compact tables, the warp
// form's 32 symbol records, and the staged words of a lane (warp form) or
// of the CTA's 32 lanes (thread form).
__host__ __device__ constexpr int dc_smem_bytes(bool threads, int nsc,
                                                int n_slots, int budget) {
  return 2 * (nsc * kAcL1Size + n_slots * kAcL2Size) + (threads ? 0 : 8 * 32) +
         4 * budget;
}

// One lane of K8a's warp form: per chunk of 32 blocks lane 0 walks the
// symbols, recording them in s_rec; then each thread takes one block: its
// difference (dc_value), its predictor by a per-component prefix sum over
// the warp (``pred`` carries each component's across chunks, the same in
// every thread) and a store into coefficient 0 of its row (a row outside
// its plane flags the lane).
template <class Bits>
__device__ __forceinline__ void dc_warp_lane(const DcArgs& a, int64_t s,
                                             Bits& bits, uint32_t lim,
                                             const SlotGeo* s_slot,
                                             uint2* s_rec, DcProbe& probe,
                                             uint32_t comps, int j_lane,
                                             int d_lane, int q32, int r32,
                                             uint32_t* pred, bool& bad) {
  const int lane = threadIdx.x;
  const int bpm = a.g.bpm, mx_div = a.g.mx_div;
  const int nb = a.n_per[s] * bpm;
  // This thread's block of the chunk: slot j of unit (mx, my).
  int j = j_lane;
  const int m = int(a.first[s]) + d_lane;
  int my = m / mx_div, mx = m - my * mx_div;
  int jw = 0;
  for (int t0 = 0; t0 < nb; t0 += 32) {
    const int nbc = nb - t0 < 32 ? nb - t0 : 32;
    int n_ok = 0;
    if (lane == 0)
      bad = !dc_walk_rec(bits, probe, lim, comps, bpm, jw, nbc, s_rec, &n_ok);
    n_ok = __shfl_sync(kFull, n_ok, 0);
    bool stop = __shfl_sync(kFull, int(bad), 0);
    __syncwarp();
    const SlotGeo& sg = s_slot[j];
    uint32_t d = 0;
    if (lane < n_ok) {
      const uint2 r = s_rec[lane];
      d = dc_value(r.x, int32_t(r.y));
    }
    // All four components' sums at once (a component the scan lacks sums
    // zeros), so that their shuffles interleave.
    uint32_t v = 0;
#pragma unroll
    for (int c = 0; c < kMaxPlanes; ++c) {
      uint32_t x = sg.comp == c ? d : 0u;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      if (sg.comp == c) v = pred[c] + x;
      pred[c] += __shfl_sync(kFull, x, 31);
    }
    if (lane < nbc) {
      const int64_t row = dc_row(sg, mx, my);
      if (row < 0)
        stop = true;
      else if (lane < n_ok)
        sg.dst[row * 64] = int32_t(v << a.al);
    }
    if (__any_sync(kFull, stop)) {
      bad = true;
      return;
    }
    // The next chunk's block: 32 blocks on.
    j += r32;
    int dm = q32;
    if (j >= bpm) {
      j -= bpm;
      ++dm;
    }
    mx += dm;
    if (mx >= mx_div) {
      const int k = mx / mx_div;
      my += k;
      mx -= k * mx_div;
    }
    __syncwarp();
  }
}

// K8a's warp form: one warp per lane, persistent over the lanes.
__global__ void __launch_bounds__(32) dc_warp_kernel(DcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* s_l1 = reinterpret_cast<int16_t*>(smem);
  int16_t* s_l2 = s_l1 + a.nsc * kAcL1Size;
  uint2* s_rec = reinterpret_cast<uint2*>(s_l2 + a.n_slots * kAcL2Size);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_rec + 32);
  __shared__ SlotGeo s_slot[kMaxSlots];

  const int lane = threadIdx.x;
  load_slots(a.g, s_slot);
  stage(reinterpret_cast<uint32_t*>(s_l1),
        reinterpret_cast<const uint32_t*>(a.tab),
        (a.nsc * kAcL1Size + a.n_slots * kAcL2Size) / 2,
        (reinterpret_cast<uintptr_t>(a.tab) & 15) == 0, lane, 32);
  const bool words_aligned = (reinterpret_cast<uintptr_t>(a.words) & 15) == 0;
  const int bpm = a.g.bpm;
  // 32 blocks are q32 units and r32 slots; thread i's first block of a lane
  // is slot i % bpm of unit i / bpm.
  const int q32 = 32 / bpm, r32 = 32 - q32 * bpm;
  const int j_lane = lane % bpm, d_lane = lane / bpm;
  const uint32_t comps = slot_comps(a.g);

  DcProbe probe{s_l1, s_l2, a.luts, a.l2_full, 0};
  uint32_t over = 0;
  for (int64_t s = blockIdx.x; s < a.n_lanes; s += gridDim.x) {
    const int64_t base = a.base[s], lim = a.end[s];
    // Stage the lane's words (the previous lane's walk is done: the
    // __syncwarp closing it).
    int64_t s_lo, s_hi;
    const bool all = dc_range(base, lim, a.n_words, a.budget_words, &s_lo,
                              &s_hi);
    stage(s_words, a.words + s_lo, s_hi - s_lo, words_aligned, lane, 32);
    cp_async_wait_all();
    __syncwarp();
    uint32_t pred[kMaxPlanes];
#pragma unroll
    for (int c = 0; c < kMaxPlanes; ++c)
      pred[c] = c < a.nsc ? uint32_t(a.pred0[s * a.nsc + c]) : 0u;
    const uint32_t p0 = uint32_t(base - s_lo * 32);
    const uint32_t plim = uint32_t(lim - s_lo * 32);
    bool bad = false;
    int64_t pos;
    if (all) {
      StagedBits bits(s_words, p0);
      dc_warp_lane(a, s, bits, plim, s_slot, s_rec, probe, comps, j_lane,
                   d_lane, q32, r32, pred, bad);
      pos = s_lo * 32 + bits.p;
    } else {
      FarBits bits{{a.words, s_words, s_lo, s_hi, a.n_words, false, -4, 0, 0,
                    0},
                   p0};
      dc_warp_lane(a, s, bits, plim, s_slot, s_rec, probe, comps, j_lane,
                   d_lane, q32, r32, pred, bad);
      pos = s_lo * 32 + bits.p;
      over += bits.far();
    }
    if (lane == 0 && (bad || dc_end_bad(a, s, pos, lim, pred))) a.err[s] = 1;
    __syncwarp();
  }
  int32_t* stats = a.err + a.n_lanes;
  if (lane == 0 && blockIdx.x == 0) stats[0] = a.n_slots;
  if (lane == 0 && (over | probe.misses)) {
    atomicAdd(stats + 1, int(over));
    atomicAdd(stats + 2, int(probe.misses));
  }
}

// One lane of K8a's thread form: the thread walks its blocks and stores
// each value into coefficient 0 of its row, four symbols at a time as
// dc_walk_rec's groups (without a branch, so that the warp's 32 walks stay
// converged) and one at a time where a group cannot.
template <class Bits>
__device__ __forceinline__ bool dc_thread_lane(const DcArgs& a, int64_t s,
                                               Bits& bits, uint32_t lim,
                                               const SlotGeo* s_slot,
                                               DcProbe& probe, uint32_t comps,
                                               uint32_t* pred) {
  const int bpm = a.g.bpm, mx_div = a.g.mx_div;
  const int nb = a.n_per[s] * bpm;
  const int m0 = int(a.first[s]);
  int j = 0, my = m0 / mx_div, mx = m0 - my * mx_div;
  // Block t's row and the next block's slot and unit.
  auto row_next = [&](int64_t* row) {
    *row = dc_row(s_slot[j], mx, my);
    if (++j == bpm) {
      j = 0;
      if (++mx == mx_div) {
        mx = 0;
        ++my;
      }
    }
  };
  for (int t = 0; t < nb;) {
    if (Bits::kGroups && t + 4 <= nb) {
      const Bits keep = bits;
      uint2 rec[4];
      int jg = j;
      bool fine = true;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = (comps >> (2 * jg)) & 3;
        const uint32_t w = bits.window();
        const int32_t e =
            probe.l1[c * kAcL1Size + int(w >> (32 - kAcL1Bits))];
        const bool short_code = dc_short(e);
        fine &= short_code;
        bits.skip(short_code ? (e & 31) + (e >> 5) : 0);
        rec[u] = make_uint2(w, uint32_t(e));
        jg = jg + 1 == bpm ? 0 : jg + 1;
      }
      if (fine && !bits.past(lim)) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = (comps >> (2 * j)) & 3;
          int32_t* dst = s_slot[j].dst;
          int64_t row;
          row_next(&row);
          if (row < 0) return false;
          const uint32_t d = dc_value(rec[u].x, int32_t(rec[u].y));
          uint32_t v = 0;
#pragma unroll
          for (int k = 0; k < kMaxPlanes; ++k) {
            if (k == c) {
              pred[k] += d;
              v = pred[k];
            }
          }
          dst[row * 64] = int32_t(v << a.al);
        }
        t += 4;
        continue;
      }
      bits = keep;
    }
    const int c = (comps >> (2 * j)) & 3;
    int32_t* dst = s_slot[j].dst;
    int64_t row;
    row_next(&row);
    int32_t v;
    if (row < 0 || !dc_step(bits, probe, lim, c, pred, a.al, &v))
      return false;
    dst[row * 64] = v;
    ++t;
  }
  return true;
}

// K8a's thread form: one thread per lane, one warp per CTA; the warp stages
// the compact tables and the words of its 32 consecutive lanes (one
// contiguous range, at most budget words).
__global__ void __launch_bounds__(32) dc_thread_kernel(DcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* s_l1 = reinterpret_cast<int16_t*>(smem);
  int16_t* s_l2 = s_l1 + a.nsc * kAcL1Size;
  uint32_t* s_words =
      reinterpret_cast<uint32_t*>(s_l2 + a.n_slots * kAcL2Size);
  __shared__ SlotGeo s_slot[kMaxSlots];

  const int64_t s0 = int64_t(blockIdx.x) * 32;
  if (s0 >= a.n_lanes) return;
  const int64_t s = s0 + threadIdx.x;
  const int lane = threadIdx.x;
  load_slots(a.g, s_slot);
  stage(reinterpret_cast<uint32_t*>(s_l1),
        reinterpret_cast<const uint32_t*>(a.tab),
        (a.nsc * kAcL1Size + a.n_slots * kAcL2Size) / 2,
        (reinterpret_cast<uintptr_t>(a.tab) & 15) == 0, lane, 32);
  const int64_t last = s0 + 31 < a.n_lanes ? s0 + 31 : a.n_lanes - 1;
  int64_t s_lo, s_hi;
  const bool all = dc_range(a.base[s0], a.end[last], a.n_words,
                            a.budget_words, &s_lo, &s_hi);
  stage(s_words, a.words + s_lo, s_hi - s_lo,
        (reinterpret_cast<uintptr_t>(a.words) & 15) == 0, lane, 32);
  cp_async_wait_all();
  __syncwarp();

  DcProbe probe{s_l1, s_l2, a.luts, a.l2_full, 0};
  bool far = false;
  if (s < a.n_lanes) {
    const int64_t lim = a.end[s];
    uint32_t pred[kMaxPlanes];
#pragma unroll
    for (int c = 0; c < kMaxPlanes; ++c)
      pred[c] = c < a.nsc ? uint32_t(a.pred0[s * a.nsc + c]) : 0u;
    const uint32_t p0 = uint32_t(a.base[s] - s_lo * 32);
    const uint32_t plim = uint32_t(lim - s_lo * 32);
    const uint32_t comps = slot_comps(a.g);
    bool ok;
    int64_t pos;
    if (all) {
      StagedBits bits(s_words, p0);
      ok = dc_thread_lane(a, s, bits, plim, s_slot, probe, comps, pred);
      pos = s_lo * 32 + bits.p;
    } else {
      FarBits bits{{a.words, s_words, s_lo, s_hi, a.n_words, false, -4, 0, 0,
                    0},
                   p0};
      ok = dc_thread_lane(a, s, bits, plim, s_slot, probe, comps, pred);
      pos = s_lo * 32 + bits.p;
      far = bits.far();
    }
    if (!ok || dc_end_bad(a, s, pos, lim, pred)) a.err[s] = 1;
  }
  const unsigned over = __reduce_add_sync(kFull, far ? 1u : 0u);
  const unsigned misses = __reduce_add_sync(kFull, probe.misses);
  int32_t* stats = a.err + a.n_lanes;
  if (lane == 0 && blockIdx.x == 0) stats[0] = a.n_slots;
  if (lane == 0 && (over | misses)) {
    atomicAdd(stats + 1, int(over));
    atomicAdd(stats + 2, int(misses));
  }
}

struct DcRefineArgs {
  const uint32_t* words;
  const int64_t* base;
  const int64_t* end;
  const int32_t* n_per;
  const int64_t* first;
  int32_t* err;
  int64_t n_words;
  int n_lanes, n_blocks, al;
  int stride;   // units of every lane but the last when all equal, else 0
  DcGeo g;
};

// K8b: one thread per block of the scan, in flat order (block b is slot
// b % bpm of unit b / bpm), 32-bit index arithmetic.  A thread finds its
// lane by a division where the lanes have one length (restart segments,
// the skeleton's strides), else by a binary search of the lanes' first
// units; it reads its bit from the
// warp's one word pair (or, where the warp spans lanes whose bits lie
// apart, its own word) and, where the bit is 1, adds ``1 << al`` to
// coefficient 0 of its row with a reduction that returns nothing.  The
// thread of a lane's first block checks that the lane's bits lie before
// its end; a row outside its plane flags its lane.
__global__ void __launch_bounds__(kThreads) dc_refine_kernel(DcRefineArgs a) {
  __shared__ SlotGeo s_slot[kMaxSlots];
  load_slots(a.g, s_slot);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool on = b < a.n_blocks;
  const int bpm = a.g.bpm;
  int s = 0, m = 0, j = 0;
  uint32_t bit_pos = 0;
  if (on) {
    m = b / bpm;
    j = b - m * bpm;
    // The lane holding unit m: the last whose first unit is at most m (an
    // empty lane shares its first unit with the next one).
    int hi = a.n_lanes - 1;
    if (a.stride > 0) s = hi = min(m / a.stride, hi);
    while (s < hi) {
      const int mid = (s + hi + 1) >> 1;
      if (a.first[mid] <= m)
        s = mid;
      else
        hi = mid - 1;
    }
    const int t = b - int(a.first[s]) * bpm;
    bit_pos = uint32_t(a.base[s]) + uint32_t(t);
    if (t == 0 && a.base[s] + int64_t(a.n_per[s]) * bpm > a.end[s])
      a.err[s] = 1;
  }
  const int64_t last = a.n_words - 1;
  const uint32_t wi = bit_pos >> 5;
  const uint32_t w0 = __shfl_sync(kFull, wi, 0);
  uint32_t pair0 = 0, pair1 = 0;
  if (lane == 0 && on) {
    pair0 = __ldg(a.words + (w0 < last ? w0 : last));
    pair1 = __ldg(a.words + (w0 + 1 < last ? w0 + 1 : last));
  }
  pair0 = __shfl_sync(kFull, pair0, 0);
  pair1 = __shfl_sync(kFull, pair1, 0);
  if (!on) return;
  const uint32_t word =
      wi == w0 ? pair0
               : wi == w0 + 1 ? pair1 : __ldg(a.words + (wi < last ? wi : last));
  const SlotGeo& sg = s_slot[j];
  const int my = m / a.g.mx_div;
  const int64_t row = dc_row(sg, m - my * a.g.mx_div, my);
  if (row < 0)
    a.err[s] = 1;
  else if ((word >> (31 - (bit_pos & 31))) & 1u)
    atomicAdd(sg.dst + row * 64, 1 << a.al);
}

Geo unpack(const int64_t* geo) {
  Geo g;
  g.bpm = geo[0];
  g.mx_div = geo[1];
  int64_t* slots[6] = {g.plane, g.v, g.jv, g.h, g.jh, g.comp};
  for (int f = 0; f < 6; ++f)
    for (int j = 0; j < kMaxSlots; ++j) slots[f][j] = geo[2 + f * kMaxSlots + j];
  for (int p = 0; p < kMaxPlanes; ++p) {
    g.pcols[p] = geo[2 + 6 * kMaxSlots + p];
    g.n_rows[p] = geo[2 + 6 * kMaxSlots + kMaxPlanes + p];
  }
  return g;
}

unsigned grid_of(int64_t n) { return unsigned((n + kThreads - 1) / kThreads); }

// CTAs of 32 threads that fit on the current device at once with ``smem``
// bytes of shared memory each (CTAs per SM times the SMs): a cache per
// (device, kernel, shared memory), so that a launch makes no occupancy
// query after the first and one shape never sets another's limit
// (cudaGetDevice reads the thread's current device).
int resident_ctas(const void* kernel, int smem, int64_t* out) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, int64_t> cache;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return int(rc);
  std::lock_guard<std::mutex> hold(mu);
  const auto key = std::make_tuple(dev, kernel, smem);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return 0;
  }
  int n_sm = 0, per_sm = 0;
  rc = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32,
                                                       smem);
  if (rc != cudaSuccess) return int(rc);
  *out = cache[key] = int64_t(n_sm) * (per_sm > 0 ? per_sm : 1);
  return 0;
}

// K8d always runs its warp form; K8c its thread form when ``threads``.
template <bool kRefine>
int launch_ac(const AcArgs& a, const Geo& g, bool threads,
              cudaStream_t stream, int64_t* grid_out) {
  if (kRefine && threads) return int(cudaErrorInvalidValue);
  const int smem = ac_smem_bytes(kRefine, threads, a.n_slots, a.budget_words);
  int64_t grid = (a.n_lanes + 31) / 32;
  if (!threads) {
    const int rc = resident_ctas(
        reinterpret_cast<const void*>(ac_warp_kernel<kRefine>), smem, &grid);
    if (rc != 0) return rc;
    if (grid > a.n_lanes) grid = a.n_lanes;
  }
  if (grid_out != nullptr) {
    *grid_out = grid;
    return 0;
  }
  if (threads)
    ac_first_thread_kernel<<<unsigned(grid), 32, smem, stream>>>(a, g);
  else
    ac_warp_kernel<kRefine><<<unsigned(grid), 32, smem, stream>>>(a, g);
  return int(cudaGetLastError());
}

// The slot geometry of K8a/K8b: Geo in 32 bits, each slot with its plane's
// pointer, block columns and rows.
DcGeo dc_geo(const int64_t* geo, int32_t* const planes[kMaxPlanes]) {
  const Geo g = unpack(geo);
  DcGeo d{};
  d.bpm = int32_t(g.bpm);
  d.mx_div = int32_t(g.mx_div);
  for (int j = 0; j < kMaxSlots; ++j) {
    const int p = int(g.plane[j]);
    d.slot[j] = SlotGeo{planes[p],          int32_t(g.v[j]),
                        int32_t(g.jv[j]),   int32_t(g.h[j]),
                        int32_t(g.jh[j]),   int32_t(g.comp[j]),
                        int32_t(g.pcols[p]), int32_t(g.n_rows[p])};
  }
  return d;
}

const void* dc_kernel(bool threads) {
  return threads ? reinterpret_cast<const void*>(dc_thread_kernel)
                 : reinterpret_cast<const void*>(dc_warp_kernel);
}

}  // namespace

// Host entry points: one launch each on ``stream``; ``geo`` is a HOST array
// of kGeoLen int64 (ops/entropy_prog_cuda.Geometry.pack).  Each returns
// cudaGetLastError() after its launch (0: launched).
extern "C" int jd_prog_geo_len() { return kGeoLen; }

// K8a in the warp form (threads == 0) or the thread form on ``grid`` CTAs
// (ops/entropy_prog_cuda.dc_launch_shape: the thread form needs one CTA per
// 32 lanes, the warp form any number); ``tab`` holds the nsc compact
// first levels and n_slots second levels (dc_tables).
extern "C" int jd_prog_dc_first(
    const uint32_t* words, int64_t n_words, const int64_t* base,
    const int64_t* end, const int32_t* n_per, const int64_t* first,
    const int32_t* pred0, int32_t nsc, const int32_t* luts,
    const int16_t* tab, int32_t n_slots, int32_t l2_full, int32_t* p0,
    int32_t* p1, int32_t* p2, int32_t* p3, const int64_t* geo, int32_t al,
    int32_t chained, int64_t n_lanes, int32_t threads, int32_t budget_words,
    int64_t grid, int32_t* err, void* stream) {
  if (n_lanes < 1) return 0;
  if (budget_words < 4 || budget_words > kMaxBudget || budget_words % 4 ||
      n_slots < 0 || n_slots > kAcL2Slots || nsc < 1 || nsc > kMaxPlanes ||
      grid < 1 || grid > 0x7fffffff || (threads && grid * 32 < n_lanes))
    return int(cudaErrorInvalidValue);
  int32_t* const planes[kMaxPlanes] = {p0, p1, p2, p3};
  DcArgs a;
  a.words = words;
  a.base = base;
  a.end = end;
  a.n_per = n_per;
  a.first = first;
  a.pred0 = pred0;
  a.luts = luts;
  a.tab = tab;
  a.err = err;
  a.n_words = n_words;
  a.n_lanes = n_lanes;
  a.nsc = nsc;
  a.al = al;
  a.chained = chained;
  a.budget_words = budget_words;
  a.n_slots = n_slots;
  a.l2_full = l2_full;
  a.g = dc_geo(geo, planes);
  const int smem = dc_smem_bytes(threads != 0, nsc, n_slots, budget_words);
  const cudaStream_t st = (cudaStream_t)stream;
  if (threads)
    dc_thread_kernel<<<unsigned(grid), 32, smem, st>>>(a);
  else
    dc_warp_kernel<<<unsigned(grid), 32, smem, st>>>(a);
  return int(cudaGetLastError());
}

// The CTAs of K8a's form that fit on the current device at once at this
// table and budget size (into *out), or a CUDA error.
extern "C" int jd_prog_dc_resident(int32_t threads, int32_t nsc,
                                   int32_t n_slots, int32_t budget_words,
                                   int64_t* out) {
  return resident_ctas(dc_kernel(threads != 0),
                       dc_smem_bytes(threads != 0, nsc, n_slots, budget_words),
                       out);
}

// K8b over the scan's n_units * bpm blocks (fewer than 2^31); ``stride``:
// LaneTable.stride.
extern "C" int jd_prog_dc_refine(const uint32_t* words, int64_t n_words,
                                 const int64_t* base, const int64_t* end,
                                 const int32_t* n_per, const int64_t* first,
                                 int32_t* p0, int32_t* p1, int32_t* p2,
                                 int32_t* p3, const int64_t* geo, int32_t al,
                                 int64_t n_lanes, int64_t n_units,
                                 int64_t stride, int32_t* err, void* stream) {
  if (n_lanes < 1 || n_units < 1) return 0;
  int32_t* const planes[kMaxPlanes] = {p0, p1, p2, p3};
  DcRefineArgs a;
  a.words = words;
  a.base = base;
  a.end = end;
  a.n_per = n_per;
  a.first = first;
  a.err = err;
  a.n_words = n_words;
  a.g = dc_geo(geo, planes);
  const int64_t n_blocks = n_units * a.g.bpm;
  if (n_lanes > 0x7fffffff || n_blocks > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  a.n_lanes = int(n_lanes);
  a.n_blocks = int(n_blocks);
  a.al = al;
  a.stride = stride > 0 && stride <= 0x7fffffff ? int(stride) : 0;
  dc_refine_kernel<<<grid_of(n_blocks), kThreads, 0, (cudaStream_t)stream>>>(
      a);
  return int(cudaGetLastError());
}

extern "C" int jd_prog_ac(int32_t refine, const uint32_t* words,
                          int64_t n_words, const int64_t* base,
                          const int64_t* end, const int32_t* n_per,
                          const int64_t* first, const int32_t* eob0,
                          const int32_t* lut, const int16_t* tab,
                          int32_t n_slots, int32_t l2_full, int32_t* plane,
                          const int64_t* geo, int32_t ss, int32_t se,
                          int32_t al, int32_t chained, int64_t n_lanes,
                          int32_t threads, int32_t budget_words, int32_t* err,
                          void* stream) {
  if (n_lanes < 1) return 0;
  if (budget_words < 4 || budget_words > kMaxBudget || budget_words % 4 ||
      n_slots < 0 || n_slots > kAcL2Slots)
    return int(cudaErrorInvalidValue);
  AcArgs a;
  a.words = words;
  a.base = base;
  a.end = end;
  a.n_per = n_per;
  a.first = first;
  a.eob0 = eob0;
  a.lut = lut;
  a.tab = tab;
  a.plane = plane;
  a.err = err;
  a.n_words = n_words;
  a.n_lanes = n_lanes;
  a.ss = ss;
  a.se = se;
  a.al = al;
  a.chained = chained;
  a.budget_words = budget_words;
  a.n_slots = n_slots;
  a.l2_full = l2_full;
  const Geo g = unpack(geo);
  const cudaStream_t st = (cudaStream_t)stream;
  return refine ? launch_ac<true>(a, g, threads != 0, st, nullptr)
                : launch_ac<false>(a, g, threads != 0, st, nullptr);
}

// The CTAs jd_prog_ac launches for ``n_lanes`` lanes in the given form at
// this table size and budget on the current device (into *grid), or a CUDA
// error.
extern "C" int jd_prog_ac_grid(int32_t refine, int32_t threads,
                               int32_t n_slots, int32_t budget_words,
                               int64_t n_lanes, int64_t* grid) {
  AcArgs a{};
  a.n_lanes = n_lanes;
  a.n_slots = n_slots;
  a.budget_words = budget_words;
  Geo g{};
  return refine ? launch_ac<true>(a, g, threads != 0, nullptr, grid)
                : launch_ac<false>(a, g, threads != 0, nullptr, grid);
}

// The table layout and staging limit, held to ops/entropy_prog_cuda.py.
extern "C" int jd_prog_ac_l1_bits() { return kAcL1Bits; }
extern "C" int jd_prog_ac_l2_slots() { return kAcL2Slots; }
extern "C" int jd_prog_ac_max_budget() { return kMaxBudget; }
extern "C" int jd_prog_dc_lookahead() { return kDcLookahead; }

// The first forms of K8c and K8d (one thread per lane, everything read from
// device memory), the same-card baseline; the package never launches them.
extern "C" int jd_prog_ac_v1(int32_t refine, const uint32_t* words,
                          int64_t n_words, const int64_t* base,
                          const int64_t* end, const int32_t* n_per,
                          const int64_t* first, const int32_t* eob0,
                          const int32_t* lut, int32_t* plane,
                          const int64_t* geo, int32_t ss, int32_t se,
                          int32_t al, int32_t chained, int64_t n_lanes,
                          int32_t* err, void* stream) {
  if (n_lanes < 1) return 0;
  const Geo g = unpack(geo);
  if (refine)
    ac_refine_kernel_v1<<<grid_of(n_lanes), kThreads, 0, (cudaStream_t)stream>>>(
        words, n_words, base, end, n_per, first, eob0, lut, plane, g, ss, se,
        al, chained, n_lanes, err);
  else
    ac_first_kernel_v1<<<grid_of(n_lanes), kThreads, 0, (cudaStream_t)stream>>>(
        words, n_words, base, end, n_per, first, eob0, lut, plane, g, ss, se,
        al, chained, n_lanes, err);
  return int(cudaGetLastError());
}

// The first forms of K8a and K8b (one thread per lane, or per lane and
// slot up to the longest lane, everything read from device memory), the
// same-card baseline; the package never launches them.
extern "C" int jd_prog_dc_v1(int32_t refine, const uint32_t* words,
                             int64_t n_words, const int64_t* base,
                             const int64_t* end, const int32_t* n_per,
                             const int64_t* first, const int32_t* pred0,
                             int32_t nsc, const int32_t* luts, int32_t* p0,
                             int32_t* p1, int32_t* p2, int32_t* p3,
                             const int64_t* geo, int32_t al, int32_t chained,
                             int64_t n_lanes, int64_t max_blocks,
                             int32_t* err, void* stream) {
  if (n_lanes < 1) return 0;
  Planes pl{{p0, p1, p2, p3}};
  const cudaStream_t st = (cudaStream_t)stream;
  if (refine) {
    if (max_blocks < 1) return 0;
    dc_refine_kernel_v1<<<grid_of(n_lanes * max_blocks), kThreads, 0, st>>>(
        words, n_words, base, end, n_per, first, pl, unpack(geo), al,
        n_lanes, max_blocks, err);
  } else {
    dc_first_kernel_v1<<<grid_of(n_lanes), kThreads, 0, st>>>(
        words, n_words, base, end, n_per, first, pred0, nsc, luts, pl,
        unpack(geo), al, chained, n_lanes, err);
  }
  return int(cudaGetLastError());
}
