// Cross-rank DC carry of the emit-lane decode (K7c), hand-written for Hopper
// (sm_90a), bound to PyTorch through a plain C entry point and ctypes.
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
// the component); the ranks all-gather those, and this kernel adds
//
//   carry[b][c] = sum over ranks q of w[q][b] * tot[q][b][c]   (uint32 wrap)
//
// (w[q][b] = 1 for the ranks before this one whose last MCU of image b lies
// in the segment holding this rank's first MCU, else 0) to coefficient 0 of
// each block of component c in rows [lo[b], hi[b]) of image b's output:
// this rank's blocks from its first MCU to the end of that segment or of
// its share.  Adding the sums of the ranks before a rank in the same
// segment is the exclusive segmented prefix JAX takes over the psummed
// differences, restricted to the blocks it changes; int32 wraps as
// jnp.cumsum does.
//
// What bounds it: bytes.  It reads and writes one int32 per block touched
// (a strided 4 bytes of each 256-byte block row), plus the gathered totals;
// the work is a handful of integer adds per block.  One CTA row per image
// (blockIdx.y), grid-stride over its rows (blockIdx.x); each CTA sums its
// image's carry once into shared memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxComps = 4;
constexpr int kThreads = 256;

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

}  // namespace

// out (n_img, rows, 64) int32, in place; tot (n_ranks, n_img, n_comps)
// int32; w (n_ranks, n_img) int32; lo, hi (n_img,) int64 row ranges, 0 <=
// lo (hi <= lo: nothing for that image); max_span: the longest hi - lo
// (sizes the grid); comp_code: the component of within-MCU block k in bits
// 4k..4k+3.  Launches on `stream` and returns the CUDA error of the launch
// (0 = launched).
extern "C" int jd_emit_carry(void* out, const void* tot, const void* w,
                             const void* lo, const void* hi, int64_t n_img,
                             int64_t rows, int32_t n_ranks, int32_t n_comps,
                             int32_t bpm, uint64_t comp_code,
                             int64_t max_span, void* stream) {
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
