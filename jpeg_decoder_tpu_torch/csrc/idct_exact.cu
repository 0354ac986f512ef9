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
// (a CPU test parses them from this file and compares them bit for bit).
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

namespace {

constexpr int kBlocksPerCta = 32;
constexpr int kThreads = 256;
constexpr int kRowStride = 9;
constexpr int kBlockStride = 72;

// float32(2 cos(k pi / 8)) combinations and float32 AAN scales.
constexpr float M1 = 0x1.6a09e6p+0f;   // 2 cos(2 pi / 8)
constexpr float M2 = 0x1.1517a8p+0f;   // M0 - M5
constexpr float M3 = 0x1.6a09e6p+0f;   // = M1
constexpr float M4 = 0x1.4e7ae8p+1f;   // M0 + M5
constexpr float M5 = 0x1.87de2ap-1f;   // 2 cos(3 pi / 8)
constexpr float S0 = 0x1.6a09e6p-2f;   // cos(0) / sqrt(8)
constexpr float S1 = 0x1.f6297cp-2f;   // cos(k pi / 16) / 2, k = 1..7
constexpr float S2 = 0x1.d906bcp-2f;
constexpr float S3 = 0x1.a9b662p-2f;
constexpr float S4 = 0x1.6a09e6p-2f;
constexpr float S5 = 0x1.1c73b4p-2f;
constexpr float S6 = 0x1.87de2ap-3f;
constexpr float S7 = 0x1.8f8b84p-4f;

// One scaled-AAN 1-D pass: in[k] = x[k], out[k] = result k (jpeg.cpp:596-663,
// op for op as pixel.py:_aan_1d).
__device__ __forceinline__ void aan_1d(const float x[8], float out[8]) {
  const float g0 = __fmul_rn(x[0], S0);
  const float g1 = __fmul_rn(x[4], S4);
  const float g2 = __fmul_rn(x[2], S2);
  const float g3 = __fmul_rn(x[6], S6);
  const float g4 = __fmul_rn(x[5], S5);
  const float g5 = __fmul_rn(x[1], S1);
  const float g6 = __fmul_rn(x[7], S7);
  const float g7 = __fmul_rn(x[3], S3);

  const float f4 = __fsub_rn(g4, g7);
  const float f5 = __fadd_rn(g5, g6);
  const float f6 = __fsub_rn(g5, g6);
  const float f7 = __fadd_rn(g4, g7);

  const float e2 = __fsub_rn(g2, g3);
  const float e3 = __fadd_rn(g2, g3);
  const float e5 = __fsub_rn(f5, f7);
  const float e7 = __fadd_rn(f5, f7);
  const float e8 = __fadd_rn(f4, f6);

  const float d2 = __fmul_rn(e2, M1);
  const float d4 = __fmul_rn(f4, M2);
  const float d5 = __fmul_rn(e5, M3);
  const float d6 = __fmul_rn(f6, M4);
  const float d8 = __fmul_rn(e8, M5);

  const float c0 = __fadd_rn(g0, g1);
  const float c1 = __fsub_rn(g0, g1);
  const float c2 = __fsub_rn(d2, e3);
  const float c3 = e3;
  const float c4 = __fadd_rn(d4, d8);
  const float c5 = __fadd_rn(d5, e7);
  const float c6 = __fsub_rn(d6, d8);
  const float c7 = e7;
  const float c8 = __fsub_rn(c5, c6);

  const float b0 = __fadd_rn(c0, c3);
  const float b1 = __fadd_rn(c1, c2);
  const float b2 = __fsub_rn(c1, c2);
  const float b3 = __fsub_rn(c0, c3);
  const float b4 = __fsub_rn(c4, c8);
  const float b5 = c8;
  const float b6 = __fsub_rn(c6, c7);
  const float b7 = c7;

  out[0] = __fadd_rn(b0, b7);
  out[1] = __fadd_rn(b1, b6);
  out[2] = __fadd_rn(b2, b5);
  out[3] = __fadd_rn(b3, b4);
  out[4] = __fsub_rn(b3, b4);
  out[5] = __fsub_rn(b2, b5);
  out[6] = __fsub_rn(b1, b6);
  out[7] = __fsub_rn(b0, b7);
}

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
      // int32 product with wraparound, computed unsigned (no signed
      // overflow in C++).
      const unsigned int p = static_cast<unsigned int>(vals[k]) *
                             static_cast<unsigned int>(q[e + k]);
      tile[b * kBlockStride + r * kRowStride + c] = static_cast<int>(p);
    }
  }
  __syncthreads();

  const int b = tid >> 3, lane = tid & 7;
  int* t = tile + b * kBlockStride;
  float x[8], y[8];
  // Column pass: this thread's column `lane`, rows 0..7.
#pragma unroll
  for (int r = 0; r < 8; ++r) x[r] = __int2float_rn(t[r * kRowStride + lane]);
  aan_1d(x, y);
#pragma unroll
  for (int r = 0; r < 8; ++r) t[r * kRowStride + lane] = __float2int_rz(y[r]);
  __syncthreads();
  // Row pass: this thread's row `lane`, columns 0..7.
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = __int2float_rn(t[lane * kRowStride + c]);
  aan_1d(x, y);
#pragma unroll
  for (int c = 0; c < 8; ++c) t[lane * kRowStride + c] = __float2int_rz(y[c]);
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
