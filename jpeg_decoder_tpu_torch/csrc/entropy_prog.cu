// Progressive Huffman scan kernels (T.81 G.2) for sm_90a: K8a DC first,
// K8b DC refinement, K8c AC first, K8d AC refinement.
//
// Replace the JAX package's device loops in
// jpeg_decoder_tpu/ops/entropy_prog.py: decode_dc_first (:87),
// dc_refine_bits (:152), decode_ac_first (:199) with decode_ac_first_emit
// (:770) and _emit_global_scatter (:1083), decode_ac_refine (:317) with
// decode_ac_refine_emit (:517) and _refine_emit_core (:897).  They compute
// what those compute, not how: a TPU loop cannot scatter, so the JAX forms
// emit (position, value) pairs or per-event accumulators and scatter or
// gather them afterwards.  A CUDA thread stores directly, and the lanes of a
// scan own disjoint blocks, so each lane adds to (or, in K8d, reads and
// updates) its own blocks' coefficients with plain loads and stores.
//
// One thread per lane (K8b: one per block, its bit lies at a closed-form
// position).  A lane is a run of consecutive MCUs (DC scans) or blocks (AC
// scans) of one scan, from a known state: a restart segment (predictors and
// EOB run zero) or a record of the host's skeleton walk (bit position,
// predictors, pending EOB run).  The lane keeps a 64-bit bit position and
// its predictors or EOB run in registers and reads the 16-bit-indexed
// Huffman tables from device memory.
//
// Bound: bytes.  A scan reads its words once and touches the plane rows of
// its blocks (K8d reads and writes them).  The serial walk of each lane is
// latency-bound on the LUT and word loads; the design answer for now is
// many short lanes (the host plans thousands per scan), not shared-memory
// tables or warp-cooperative refinement, which are a later change.
//
// Every lane checks itself: a bad code, a size or run out of range, a block
// row outside its plane, a position past the lane's end bit, and, for lanes
// chained by the skeleton walk, an end state that is not exactly the next
// lane's start (bit position and predictors or EOB run).  A failing lane
// sets err[lane] = 1 and stops; its blocks are then unspecified.
//
// Plain versions: jpeg_decoder_tpu_torch/ops/entropy_prog_cuda.py.

#include <cstdint>
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

// K8a: DC first scan (Ss = 0, Ah = 0).  Block t of a lane is slot t % bpm
// of its MCU; its component's predictor takes the extended difference and
// coefficient 0 of its row gets ``pred << al`` (it is zero entering the
// scan, so the add is the store of entropy/progressive.py).
__global__ void dc_first_kernel(const uint32_t* __restrict__ words,
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

// K8b: DC refinement (Ss = 0, Ah > 0).  Block t of lane s reads the bit at
// base[s] + t and adds ``bit << al`` to coefficient 0 (the bit is zero
// entering the scan, so the add is the |= of entropy/progressive.py).
// One thread per (lane, slot); slot 0 checks that the lane's bits lie
// before its end.
__global__ void dc_refine_kernel(const uint32_t* __restrict__ words,
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

// K8c: AC first scan (Ss >= 1, Ah = 0) of one component.  A block covered
// by the pending EOB run is skipped; otherwise run/size symbols put
// ``extend(bits) << al`` at natural position ZIGZAG[k] (into zero slots:
// add equals store), ZRL advances k by 16 and an EOB run of r gives
// (1 << r) + bits(r) blocks, this one among them.
__global__ void ac_first_kernel(const uint32_t* __restrict__ words,
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

// K8d: AC refinement (Ss >= 1, Ah > 0) of one component (T.81 G.2.3).  The
// history of a band position is the plane's value there: a nonzero one
// takes a correction bit (+-(1 << al) in its sign's direction when its
// (1 << al) bit is clear), a zero one counts toward the symbol's zero run
// and the new +-(1 << al) coefficient goes to the run's end.  Blocks under
// an EOB run still take correction bits.  Lanes own their blocks, so the
// read-modify-write of a row is the lane's alone.
__global__ void ac_refine_kernel(const uint32_t* __restrict__ words,
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

}  // namespace

// Host entry points: one launch each on ``stream``; ``geo`` is a HOST array
// of kGeoLen int64 (ops/entropy_prog_cuda.Geometry.pack).  Each returns
// cudaGetLastError() after its launch (0: launched).
extern "C" int jd_prog_geo_len() { return kGeoLen; }

extern "C" int jd_prog_dc_first(const uint32_t* words, int64_t n_words,
                                const int64_t* base, const int64_t* end,
                                const int32_t* n_per, const int64_t* first,
                                const int32_t* pred0, int32_t nsc,
                                const int32_t* luts, int32_t* p0, int32_t* p1,
                                int32_t* p2, int32_t* p3, const int64_t* geo,
                                int32_t al, int32_t chained, int64_t n_lanes,
                                int32_t* err, void* stream) {
  if (n_lanes < 1) return 0;
  Planes pl{{p0, p1, p2, p3}};
  dc_first_kernel<<<grid_of(n_lanes), kThreads, 0, (cudaStream_t)stream>>>(
      words, n_words, base, end, n_per, first, pred0, nsc, luts, pl,
      unpack(geo), al, chained, n_lanes, err);
  return int(cudaGetLastError());
}

extern "C" int jd_prog_dc_refine(const uint32_t* words, int64_t n_words,
                                 const int64_t* base, const int64_t* end,
                                 const int32_t* n_per, const int64_t* first,
                                 int32_t* p0, int32_t* p1, int32_t* p2,
                                 int32_t* p3, const int64_t* geo, int32_t al,
                                 int64_t n_lanes, int64_t max_blocks,
                                 int32_t* err, void* stream) {
  if (n_lanes < 1 || max_blocks < 1) return 0;
  Planes pl{{p0, p1, p2, p3}};
  dc_refine_kernel<<<grid_of(n_lanes * max_blocks), kThreads, 0,
                     (cudaStream_t)stream>>>(
      words, n_words, base, end, n_per, first, pl, unpack(geo), al, n_lanes,
      max_blocks, err);
  return int(cudaGetLastError());
}

extern "C" int jd_prog_ac(int32_t refine, const uint32_t* words,
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
    ac_refine_kernel<<<grid_of(n_lanes), kThreads, 0, (cudaStream_t)stream>>>(
        words, n_words, base, end, n_per, first, eob0, lut, plane, g, ss, se,
        al, chained, n_lanes, err);
  else
    ac_first_kernel<<<grid_of(n_lanes), kThreads, 0, (cudaStream_t)stream>>>(
        words, n_words, base, end, n_per, first, eob0, lut, plane, g, ss, se,
        al, chained, n_lanes, err);
  return int(cudaGetLastError());
}
