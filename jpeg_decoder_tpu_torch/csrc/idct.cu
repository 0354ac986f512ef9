// Fused dequantize + 8x8 IDCT (Kronecker form), hand-written for Hopper
// (sm_90a), bound to PyTorch through a plain C entry point and ctypes.
//
// Replaces the TPU kernel jpeg_decoder_tpu/ops/idct_pallas.py:
// fused_dequant_idct (Pallas body `_kernel`).  It computes the same thing:
//
//   out[b, n, p] = rint( sum_k float(blocks[b, n, k] * q[b, k]) * KRON[p, k] )
//
// with KRON = IDCT_M (x) IDCT_M, so each 8x8 block is one 64-vector and the
// separable 2-D IDCT is one length-64 dot product per output sample.  The
// dot is full float32 (no TF32); rounding is half to even (__float2int_rn,
// as jnp.round).  FMA contraction is allowed: the Kronecker form's bound
// against the JAX reference is +-1 either way.
//
// What bounds it: memory bandwidth.  Per coefficient the kernel reads 4 B
// and writes 4 B and does 64 FMAs (128 FLOP), i.e. 16 FLOP per byte, below
// the H100's float32 CUDA-core rate over its HBM bandwidth (~67 TFLOP/s over
// 3.35 TB/s, ~20 FLOP/B).  What the design does about it:
//  * every coefficient is read once and every sample written once, with
//    16-byte loads (int4) and warp-contiguous 128-byte stores;
//  * dequantisation and the float conversion happen on the way into shared
//    memory, so no dequantised plane ever reaches device memory;
//  * the transposed basis (16 KB) is staged through shared memory once per
//    CTA and then held in registers: each thread owns one output lane p and
//    keeps column p of the basis in 64 registers, so the inner loop reads
//    only the dequantised tile, as broadcast float4 loads from shared memory;
//  * CTAs walk over tiles in a grid-stride loop, so the basis is loaded a
//    few thousand times per launch, not once per tile.
// Not yet done (later work): wgmma/TMA, double-buffered tiles, and fusing
// this step with the wire unpack and the colour transform.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // 4 groups of 64 output lanes
constexpr int kGroups = kThreads / 64;
constexpr int kTile = 64;                 // 8x8 blocks per shared-memory tile
constexpr int kVecPerThread = kTile * 16 / kThreads;  // int4 loads per thread

__global__ void __launch_bounds__(kThreads)
fused_dequant_idct_kernel(const int32_t* __restrict__ blocks,  // (B, N, 64)
                          const int32_t* __restrict__ qtable,  // (B, 64)
                          const float* __restrict__ kron_t,    // (64, 64)
                          int32_t* __restrict__ out,           // (B, N, 64)
                          int64_t n_blk) {
  __shared__ float s_basis[64 * 64];               // s_basis[k*64+p] = KRON[p,k]
  __shared__ __align__(16) float s_deq[kTile * 64];

  const int t = threadIdx.x;
  const int64_t img = blockIdx.y;
  const int32_t* src = blocks + img * n_blk * 64;
  int32_t* dst = out + img * n_blk * 64;

  for (int i = t; i < 64 * 64; i += kThreads) s_basis[i] = kron_t[i];
  // Thread t loads the int4 vectors t + j*kThreads of a tile.  kThreads is a
  // multiple of 16 vectors (= one 8x8 block), so the four natural-order
  // indices it touches, 4*(t%16) .. +3, are the same on every load and its
  // four quantiser steps stay in registers.
  const int4 q = reinterpret_cast<const int4*>(qtable + img * 64)[t & 15];
  __syncthreads();

  const int p = t & 63;   // output lane: natural-order sample index
  const int g = t >> 6;   // which of the tile's blocks this thread handles
  float basis[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) basis[k] = s_basis[k * 64 + p];

  const int64_t n_tiles = (n_blk + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t b0 = tile * kTile;
    const int64_t rows = n_blk - b0 < kTile ? n_blk - b0 : kTile;
    const int4* src4 = reinterpret_cast<const int4*>(src + b0 * 64);
    float4* deq4 = reinterpret_cast<float4*>(s_deq);
#pragma unroll
    for (int j = 0; j < kVecPerThread; ++j) {
      const int v = t + j * kThreads;
      int4 c = make_int4(0, 0, 0, 0);
      if (v / 16 < rows) c = src4[v];
      deq4[v] = make_float4(static_cast<float>(c.x * q.x),
                            static_cast<float>(c.y * q.y),
                            static_cast<float>(c.z * q.z),
                            static_cast<float>(c.w * q.w));
    }
    __syncthreads();
    for (int n = g; n < rows; n += kGroups) {
      const float4* row = reinterpret_cast<const float4*>(s_deq + n * 64);
      float acc = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < 16; ++k4) {
        const float4 d = row[k4];
        acc = fmaf(d.x, basis[4 * k4 + 0], acc);
        acc = fmaf(d.y, basis[4 * k4 + 1], acc);
        acc = fmaf(d.z, basis[4 * k4 + 2], acc);
        acc = fmaf(d.w, basis[4 * k4 + 3], acc);
      }
      dst[(b0 + n) * 64 + p] = __float2int_rn(acc);
    }
    __syncthreads();
  }
}

}  // namespace

// blocks, out: (n_img, n_blk, 64) int32; qtable: (n_img, 64) int32;
// kron_t: (64, 64) float32 with kron_t[k][p] = KRON[p][k].  All contiguous,
// 16-byte aligned, on the current device (the wrapper checks this).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int jd_fused_dequant_idct(const void* blocks, const void* qtable,
                                     const void* kron_t, void* out,
                                     int64_t n_img, int64_t n_blk,
                                     void* stream) {
  if (n_img <= 0 || n_blk <= 0) return 0;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  // About eight CTAs per SM in all, split over the images; each CTA then
  // walks its image's tiles.
  const int64_t n_tiles = (n_blk + kTile - 1) / kTile;
  int64_t gx = (8 * static_cast<int64_t>(n_sm) + n_img - 1) / n_img;
  if (gx > n_tiles) gx = n_tiles;
  if (gx < 1) gx = 1;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(n_img));
  fused_dequant_idct_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blocks),
      static_cast<const int32_t*>(qtable),
      static_cast<const float*>(kron_t), static_cast<int32_t*>(out), n_blk);
  return static_cast<int>(cudaGetLastError());
}
