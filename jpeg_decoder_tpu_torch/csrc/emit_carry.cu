// Cross-rank DC carry of the emit-lane decode (K7c), hand-written for Hopper
// (sm_90a), bound to PyTorch through plain C entry points and ctypes.
//
// Replaces the cross-device half of the JAX package's segmented DC prefix
// sum on a mesh: jpeg_decoder_tpu/parallel/sharded.py:630 psums each 'seg'
// shard's scattered DC differences (and :816 in the bucketed step), and
// :641-646 (:829-838) then take the prefix sum of the whole image, reset at
// each restart segment.  On a mesh the port's K7 (csrc/entropy_emit.cu)
// decodes each rank's share of an image's lanes, [lane_lo, lane_hi), with
// its DC carry starting from 0 at the share's first lane, so the blocks of
// the restart segment open at the share's start lack the DC sums of the
// ranks before it.  Each rank reports, per (image, component), its DC total
// of the segment open at its last MCU (the DC of that MCU's last block of
// the component); the ranks all-gather those, and the carry of image b's
// component c is
//
//   carry[b][c] = sum over ranks q of w[q][b] * tot[q][b][c]   (uint32 wrap)
//
// (w[q][b] = 1 for the ranks before this one whose last MCU of image b lies
// in the segment holding this rank's first MCU, else 0), added to
// coefficient 0 of each block of component c from this rank's first MCU to
// the end of that segment or of its share.  Adding the sums of the ranks
// before a rank in the same segment is the exclusive segmented prefix JAX
// takes over the psummed differences, restricted to the blocks it changes;
// int32 wraps as jnp.cumsum does.
//
// Two forms live here.
//
// jd_carry_pack, "carry and pack" (the mesh route's form).  The rows a rank
// owns (its MCUs [m_a, m_b) of each image, times the blocks per MCU) are
// all-gathered over 'seg' right after the carry, so the carry rides the
// copy that packs them: one pass reads each owned 256-byte block row once,
// adds the carry to coefficient 0 where the row is carried, writes the row
// into a contiguous send buffer of max(owned rows over the ranks) rows (the
// pad zeroed, so the collective takes it as it is), and writes the carried
// DC back in place, because the pixels read this rank's own rows.  The DC
// goes back with the rest of its 32-byte sector: a 4-byte store makes the
// memory read, merge and write the sector (at the mesh route's shape on an
// H100 80GB HBM3 at 700 W, testing/carry_variants.py: 0.1839 ms with
// 4-byte stores, 0.1415 with whole sectors, 0.1140 with no write-back).
// What bounds it: bytes, each owned row read and written once (512 bytes),
// 4 bytes of DC written back per carried row, the pad, the totals and the
// plan.  The design does about it: a half-warp moves one row as 16-byte
// vectors, coalesced, with streaming loads and stores (__ldcs/__stcs, read
// once); the grid fills the SMs, each CTA one contiguous run of 64-row
// tiles of the concatenated rows of every image, each thread issuing its
// four rows' loads of a tile before their stores; each thread keeps the
// within-MCU position of its rows and steps it by addition (the
// component comes from comp_code by a shift: no division per row) and
// finds its row's image by a binary search of the plan only when the row
// leaves the image it holds (once or twice a CTA).  Each CTA sums every
// image's carry once into shared memory.  The plan (32 bytes an image)
// rides in the kernel's parameters up to kInline images, else it is read
// from the card, where the caller copied it before K7's launch; either way
// no host work sits between K7 and this launch but the launch itself.
//
// jd_emit_carry_v1, the first form: the carry alone, in place, one thread
// per carried row touching coefficient 0 (a strided 4 bytes of each
// 256-byte row, so a 32-byte sector read and written per row), one CTA row
// per image; the gather and the pad were torch ops after it.  It stays in
// the build as the same-card baseline.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxComps = 4;
constexpr int kThreads = 256;
constexpr int kMaxRanks = 64;       // a plan's rank mask is 64 bits
constexpr int kRowsPerPass = kThreads / 16;   // a row is 16 int4 vectors
constexpr int kUnroll = 4;          // rows of a thread in flight
constexpr int kTileRows = kRowsPerPass * kUnroll;   // a CTA's step, 16 KB
constexpr int kPackCtasPerSm = 4;   // 1,024 threads an SM, <= 64 registers
constexpr int kInline = 120;        // images whose plan rides the launch
constexpr int kMaxCells = 32768;    // images x components in shared memory

struct Args {
  int32_t* out;           // (n_img, rows, 64)
  const int32_t* tot;     // (n_ranks, n_img, n_comps)
  const int32_t* w;       // (n_ranks, n_img), 0 or 1
  const int64_t* lo;      // (n_img,) first row to add to
  const int64_t* hi;      // (n_img,) end row
  int64_t n_img, rows;
  int n_ranks, n_comps, bpm;
  uint64_t comp_code;     // component of within-MCU block k in bits 4k..
};

__global__ void __launch_bounds__(kThreads) carry_kernel(Args a) {
  __shared__ uint32_t s_carry[kMaxComps];
  const int64_t b = blockIdx.y;
  if (threadIdx.x < a.n_comps) {
    uint32_t sum = 0u;
    for (int q = 0; q < a.n_ranks; ++q)
      if (a.w[q * a.n_img + b])
        sum += static_cast<uint32_t>(
            a.tot[(q * a.n_img + b) * a.n_comps + threadIdx.x]);
    s_carry[threadIdx.x] = sum;
  }
  __syncthreads();
  const int64_t lo = a.lo[b];
  int64_t hi = a.hi[b];
  hi = hi < a.rows ? hi : a.rows;
  for (int64_t r = lo + blockIdx.x * int64_t(kThreads) + threadIdx.x; r < hi;
       r += int64_t(gridDim.x) * kThreads) {
    const int k = static_cast<int>(r % a.bpm);
    const int c = static_cast<int>((a.comp_code >> (4 * k)) & 0xF);
    int32_t* dc = a.out + (b * a.rows + r) * 64;
    *dc = static_cast<int32_t>(static_cast<uint32_t>(*dc) + s_carry[c]);
  }
}

// One image of jd_carry_pack's plan, 32 bytes (emit_carry_cuda.PLAN_DTYPE).
struct PackImg {
  int64_t src;         // its first owned row, blocks seen as (n_img*rows, 64)
  int32_t dst;         // that row's place in the send buffer
  int32_t n;           // owned rows (whole MCUs)
  int32_t c_lo, c_hi;  // carried rows [c_lo, c_hi), counted from src
  uint64_t w;          // bit q: rank q's totals carry into this image
};
static_assert(sizeof(PackImg) == 32, "PackImg is the host plan's record");

struct PackArgs {
  int32_t* blocks;        // (n_img, rows, 64), the carried DC written back
  int4* send;             // (n_send, 64) int32 as 16-byte vectors
  const int32_t* tot;     // (n_ranks, n_img, n_comps)
  const PackImg* plan;    // the plan on the card, or null: it is `inl`
  int64_t n_own;          // owned rows of every image: the send rows before
  int64_t n_send;         //   the pad, and all of them
  uint64_t comp_code;     // component of within-MCU block k in bits 4k..
  int32_t n_img, n_ranks, n_comps, bpm;
  PackImg inl[kInline];
};
static_assert(sizeof(PackArgs) <= 4096, "kernel parameters hold 4 KB");

// The last image whose first send row is <= i (images of no rows share
// their successor's first row and so are never found for a row they lack).
__device__ __forceinline__ int find_image(const PackImg* plan, int n,
                                          int64_t i) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (plan[mid].dst <= i)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo - 1;
}

__global__ void __launch_bounds__(kThreads, kPackCtasPerSm)
    pack_kernel(const __grid_constant__ PackArgs a) {
  extern __shared__ uint32_t s_carry[];   // (n_img, n_comps)
  const PackImg* plan = a.plan != nullptr ? a.plan : a.inl;
  for (int j = threadIdx.x; j < a.n_img * a.n_comps; j += kThreads) {
    const int b = j / a.n_comps;
    const int c = j - b * a.n_comps;
    const uint64_t w = plan[b].w;
    uint32_t sum = 0u;
    for (int q = 0; q < a.n_ranks; ++q)
      if ((w >> q) & 1u)
        sum += static_cast<uint32_t>(
            a.tot[(static_cast<int64_t>(q) * a.n_img + b) * a.n_comps + c]);
    s_carry[j] = sum;
  }
  __syncthreads();

  const int v = threadIdx.x & 15;   // this thread's vector of a row
  // This CTA's tiles of kTileRows send rows: one contiguous run of them.
  const int64_t n_tiles = (a.n_send + kTileRows - 1) / kTileRows;
  const int64_t per = (n_tiles + gridDim.x - 1) / gridDim.x;
  const int64_t t_lo = blockIdx.x * per;
  const int64_t t_hi = t_lo + per < n_tiles ? t_lo + per : n_tiles;
  // Every image's rows start an MCU in the send buffer, so send row i is
  // block i % bpm of its MCU.  Thread row u of a tile is its first row +
  // 16u; each keeps its within-MCU position, stepped by kTileRows % bpm.
  const int64_t i0 = t_lo * kTileRows + (threadIdx.x >> 4);
  const int step_tile = kTileRows % a.bpm;
  int pos[kUnroll];
  pos[0] = static_cast<int>(i0 % a.bpm);   // once a thread
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) {
    pos[u] = pos[u - 1] + kRowsPerPass % a.bpm;
    pos[u] -= pos[u] >= a.bpm ? a.bpm : 0;
  }
  const int4* in = reinterpret_cast<const int4*>(a.blocks);
  int b = 0;
  int64_t src = 0, dst = 0, end = 0;
  int c_lo = 0, c_hi = 0;
  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int64_t base = t * kTileRows + (threadIdx.x >> 4);
    int4 x[kUnroll];
    int64_t row[kUnroll];
    uint32_t add[kUnroll];
    bool carried[kUnroll];
    // The tile's loads first, then its stores: kUnroll rows of each
    // thread in flight.
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kRowsPerPass;
      x[u] = make_int4(0, 0, 0, 0);
      row[u] = 0;
      add[u] = 0u;
      carried[u] = false;
      if (i < a.n_own) {
        if (i >= end) {   // the row left the image this thread holds
          b = find_image(plan, a.n_img, i);
          src = plan[b].src;
          dst = plan[b].dst;
          end = dst + plan[b].n;
          c_lo = plan[b].c_lo;
          c_hi = plan[b].c_hi;
        }
        const int r = static_cast<int>(i - dst);
        row[u] = src + r;
        // Vectors 0 and 1, the row's first 32-byte sector, go back in
        // place; vector 0 holds the DC.
        carried[u] = v < 2 && r >= c_lo && r < c_hi;
        if (carried[u] && v == 0)
          add[u] = s_carry[b * a.n_comps +
                           static_cast<int>((a.comp_code >> (4 * pos[u])) &
                                            0xF)];
        x[u] = __ldcs(in + row[u] * 16 + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kRowsPerPass;
      if (carried[u]) {
        x[u].x = static_cast<int32_t>(static_cast<uint32_t>(x[u].x) +
                                      add[u]);
        __stcs(reinterpret_cast<int4*>(a.blocks) + row[u] * 16 + v, x[u]);
      }
      if (i < a.n_send) __stcs(a.send + i * 16 + v, x[u]);
      pos[u] += step_tile;
      pos[u] -= pos[u] >= a.bpm ? a.bpm : 0;
    }
  }
}

}  // namespace

// The first form.  out (n_img, rows, 64) int32, in place; tot (n_ranks,
// n_img, n_comps) int32; w (n_ranks, n_img) int32; lo, hi (n_img,) int64
// row ranges, 0 <= lo (hi <= lo: nothing for that image); max_span: the
// longest hi - lo (sizes the grid); comp_code: the component of within-MCU
// block k in bits 4k..4k+3.  Launches on `stream` and returns the CUDA
// error of the launch (0 = launched).
extern "C" int jd_emit_carry_v1(void* out, const void* tot, const void* w,
                                const void* lo, const void* hi,
                                int64_t n_img, int64_t rows, int32_t n_ranks,
                                int32_t n_comps, int32_t bpm,
                                uint64_t comp_code, int64_t max_span,
                                void* stream) {
  if (n_img < 1 || n_img > 65535 || rows < 1 || n_ranks < 1 ||
      n_comps < 1 || n_comps > kMaxComps || bpm < 1 || bpm > 16 ||
      max_span < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (max_span == 0) return 0;
  Args a;
  a.out = static_cast<int32_t*>(out);
  a.tot = static_cast<const int32_t*>(tot);
  a.w = static_cast<const int32_t*>(w);
  a.lo = static_cast<const int64_t*>(lo);
  a.hi = static_cast<const int64_t*>(hi);
  a.n_img = n_img;
  a.rows = rows;
  a.n_ranks = n_ranks;
  a.n_comps = n_comps;
  a.bpm = bpm;
  a.comp_code = comp_code;
  int64_t gx = (max_span + kThreads - 1) / kThreads;
  gx = gx < 1024 ? gx : 1024;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(n_img));
  carry_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The carry-and-pack form.  blocks (n_img, rows, 64) int32 (its carried DC
// written back in place) and send (n_send, 64) int32, both on 16-byte
// boundaries; tot (n_ranks, n_img, n_comps) int32; the plan as n_img
// PackImg records, read from host_plan into the launch's parameters when
// n_img <= kInline, else from dev_plan on the card; its images' rows tile
// send rows [0, n_own) in order, each image's first row at an MCU, and
// rows [n_own, n_send) are zeroed.  grid: CTAs (emit_carry_cuda.pack_grid),
// each taking one contiguous run of 64-row tiles.  Launches on `stream` and
// returns the CUDA error of the launch (0 = launched).
extern "C" int jd_carry_pack(void* blocks, void* send, const void* tot,
                             const void* host_plan, const void* dev_plan,
                             int64_t n_img, int64_t n_own, int64_t n_send,
                             int32_t n_ranks, int32_t n_comps, int32_t bpm,
                             uint64_t comp_code, int64_t grid,
                             void* stream) {
  if (n_img < 1 || n_img * n_comps > kMaxCells || n_ranks < 1 ||
      n_ranks > kMaxRanks || n_comps < 1 || n_comps > kMaxComps ||
      bpm < 1 || bpm > 16 || n_own < 0 || n_send < n_own || n_send < 1 ||
      n_send >= (int64_t(1) << 31) || grid < 1 || grid > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(blocks) |
       reinterpret_cast<uintptr_t>(send)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  PackArgs a;
  a.blocks = static_cast<int32_t*>(blocks);
  a.send = static_cast<int4*>(send);
  a.tot = static_cast<const int32_t*>(tot);
  if (n_img <= kInline && host_plan != nullptr) {
    memcpy(a.inl, host_plan, n_img * sizeof(PackImg));
    a.plan = nullptr;
  } else if (dev_plan != nullptr) {
    a.plan = static_cast<const PackImg*>(dev_plan);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n_own = n_own;
  a.n_send = n_send;
  a.comp_code = comp_code;
  a.n_img = static_cast<int32_t>(n_img);
  a.n_ranks = n_ranks;
  a.n_comps = n_comps;
  a.bpm = bpm;
  const size_t smem = static_cast<size_t>(n_img * n_comps) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pack_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
