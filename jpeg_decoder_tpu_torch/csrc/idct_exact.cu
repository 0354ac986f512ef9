// K5: strict `exact` dequantise + AAN IDCT for Hopper (sm_90a).
//
// Replaces the XLA code of jpeg_decoder_tpu/ops/pixel.py:dequantize (:55)
// followed by idct_exact (:123, the butterfly _aan_1d :65), the reference's
// inverseDCTComponent (jpeg.cpp:594-753).  The JAX package runs it as
// separate XLA ops (its strict mode, eagerly, so that no op is fused); here
// it is one pass over the blocks.
//
// What it computes, per 8x8 block (natural order, x[r][c] = coefficient
// r*8 + c): the int32 product coefficient * q (wrapping, as JAX's int32
// multiply does); the column pass (_aan_1d over the 8 rows of each column)
// in float32; a truncating, saturating store to int32; the row pass over the
// 8 columns of each row; a truncating store again.
//
// Parity: every float operation is written as __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into an FMA whatever -fmad says, so
// each rounds to float32 on its own in the JAX package's order.  float->int
// is __float2int_rz: toward zero, saturating at the int32 range, as XLA's
// convert does.  int->float is round to nearest.  The constants are the
// float32 values of pixel.py's _M*/_S numpy expressions, as hex literals
// (a CPU test parses them from idct_common.cuh, where they live with the
// butterfly, and compares them bit for bit).
//
// Bound: 256 B read and 256 B written per block, and about 0.7 kFLOP per
// block, so it is bound by HBM bytes: at B=32, N=65,536 (the batch path's
// largest launch) 1.07 GB, 0.32 ms at 3.35 TB/s.
//
// Design: one CTA of 256 threads takes 32 consecutive blocks of one image.
// It loads them with coalesced 16-byte loads, dequantises while storing
// them to shared memory, then runs the column pass with one thread per
// (block, column) and the row pass with one thread per (block, row).  The
// tile is padded (row stride 9, block stride 72 words) so that neither
// pass's shared-memory accesses collide in a bank.  The result leaves with
// coalesced 16-byte stores.  No tensor-core work: the arithmetic is a fixed
// butterfly with truncations.

#include <cstdint>
#include <cuda_runtime.h>

#include "idct_common.cuh"   // the AAN constants, aan_1d, the K5 passes

namespace {

constexpr int kBlocksPerCta = 32;
constexpr int kThreads = 256;

// blocks/out: (n_img, n_blk, 64) int32, 16-byte aligned; qtable: (n_img, 64).
// grid = (ceil(n_blk / 32), n_img).
__global__ void __launch_bounds__(kThreads)
idct_exact_kernel(const int4* __restrict__ blocks,
                  const int* __restrict__ qtable, int4* __restrict__ out,
                  int64_t n_blk) {
  __shared__ int tile[kBlocksPerCta * kBlockStride];
  __shared__ int q[64];
  const int tid = threadIdx.x;
  const int64_t img = blockIdx.y;
  const int64_t blk0 = static_cast<int64_t>(blockIdx.x) * kBlocksPerCta;
  const int64_t n_here = min(static_cast<int64_t>(kBlocksPerCta),
                             n_blk - blk0);
  if (tid < 64) q[tid] = qtable[img * 64 + tid];
  __syncthreads();

  // Load + dequantise: 16 int4 per block, 512 per CTA, 2 per thread.
  const int64_t base4 = (img * n_blk + blk0) * 16;
  for (int i = tid; i < kBlocksPerCta * 16; i += kThreads) {
    const int b = i >> 4;
    const int e = (i & 15) * 4;            // first coefficient of the int4
    int4 v = make_int4(0, 0, 0, 0);
    if (b < n_here) v = blocks[base4 + i];
    const int vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = (e + k) >> 3, c = (e + k) & 7;
      tile[b * kBlockStride + r * kRowStride + c] = k5_dequant(vals[k],
                                                             q[e + k]);
    }
  }
  __syncthreads();

  const int b = tid >> 3, lane = tid & 7;
  int* t = tile + b * kBlockStride;
  // Column pass: this thread's column `lane`, rows 0..7.
  k5_col_pass(t, lane);
  __syncthreads();
  // Row pass: this thread's row `lane`, columns 0..7.
  int y[8];
  k5_row_pass(t, lane, y);
#pragma unroll
  for (int c = 0; c < 8; ++c) t[lane * kRowStride + c] = y[c];
  __syncthreads();

  for (int i = tid; i < kBlocksPerCta * 16; i += kThreads) {
    const int bb = i >> 4;
    if (bb >= n_here) continue;
    const int e = (i & 15) * 4;
    const int* s = tile + bb * kBlockStride;
    int4 v;
    v.x = s[((e + 0) >> 3) * kRowStride + ((e + 0) & 7)];
    v.y = s[((e + 1) >> 3) * kRowStride + ((e + 1) & 7)];
    v.z = s[((e + 2) >> 3) * kRowStride + ((e + 2) & 7)];
    v.w = s[((e + 3) >> 3) * kRowStride + ((e + 3) & 7)];
    out[base4 + i] = v;
  }
}

}  // namespace

extern "C" int jd_dequant_idct_exact(const void* blocks, const void* qtable,
                                     void* out, int64_t n_img, int64_t n_blk,
                                     void* stream) {
  if (n_img <= 0 || n_blk <= 0) return 0;
  const dim3 grid(static_cast<unsigned int>(
                      (n_blk + kBlocksPerCta - 1) / kBlocksPerCta),
                  static_cast<unsigned int>(n_img));
  idct_exact_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(blocks), static_cast<const int*>(qtable),
      static_cast<int4*>(out), n_blk);
  return static_cast<int>(cudaGetLastError());
}
