// Fused dequantize + 8x8 IDCT, hand-written for Hopper (sm_90a), bound to
// PyTorch through a plain C entry point and ctypes.
//
// Replaces the TPU kernel jpeg_decoder_tpu/ops/idct_pallas.py:
// fused_dequant_idct (Pallas body `_kernel`).  It computes the same thing,
// with the same rounding as its twin (ops/idct_cuda.py:idct_kron):
//
//   out[b, n, p] = rint( sum_k float(blocks[b, n, k] * q[b, k]) * KRON[p, k] )
//
// with KRON = IDCT_M (x) IDCT_M in float32 and rint half to even.
//
// What bounds it: memory.  Per coefficient it must read 4 B and write 4 B
// (1.07 GB at B=32, N=65,536: 0.32 ms at 3.35 TB/s).  The Kronecker form's
// 64 FMAs per sample would take 0.26 ms of the float32 CUDA-core rate, too
// close to that to hide, so the design computes the product separably:
//  * row pass then column pass, 16 FMAs per sample, with the basis scaled
//    by sqrt(8) (S = sqrt(8) IDCT_M, column 0 exactly 1.0) and a final
//    exact * 1/8, so a DC-only block gives exactly dc*q/8 and its ties round
//    half to even; the basis sits in constant memory at compile-time
//    indices, an operand of each FMA;
//  * one thread per block row: two 16-byte loads, the transpose between
//    the passes through padded shared memory, 32-byte sectors stored whole;
//  * persistent CTAs, about one wave, each walking 32-block tiles through a
//    ring of kStages shared-memory stages: while a tile is computed, the
//    next kStages - 1 stream in (cp.async).  (On the H100, 3, 4 or 6
//    stages were no faster than 2: testing/idct_variants.py.)
// Summing in another order than the twin moves a sample by a few float32
// ulps, which flips its rounding where it lies that close to a half.  So a
// sample whose separable value lies within eps of a half, eps = 2^-22 *
// sum|deq|/8 (both sums' errors scale with sum|deq|), is recomputed as the
// twin computes it: the 64-term Kronecker dot in k order with one FMA per
// term.  Such samples (about 0.6% on uniformly random blocks, far fewer on
// JPEG coefficients) are queued per warp and spread over its lanes.  The
// largest separable-vs-Kronecker gap seen in 20M random samples is 1.5 eps,
// so a rare sample still rounds the other way (3 in 19.2M samples of
// uniform +-512 * q<40 blocks, none in 19.2M of the +-256 * q90 blocks
// chip_smoke.py times); each stays within the +-1 bound.  A smaller eps
// costs time: testing/idct_variants.py.  No TF32: it would break the +-1 bound and buys
// nothing when bytes are the limit.  The per-block arithmetic (the basis,
// both passes, eps, the Kronecker recheck) lives in idct_common.cuh, which
// K6b (pixels.cu) shares, so that its `pallas` samples are K1's.

#include <cstdint>

#include <cuda_runtime.h>

#include "idct_common.cuh"   // kS, kEpsScale, the passes, k1_kron

namespace {

constexpr int kThreads = 256;               // one thread per block row
constexpr int kTile = kThreads / 8;         // 32 blocks per tile (8 KB)
constexpr int kStages = 2;                  // tiles in the shared-memory ring
constexpr int kVecPerThread = kTile * 16 / kThreads;  // int4 copies
constexpr int kPad = 72;                    // floats per block, padded
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 4 * 64;              // samples of a warp's 4 blocks

// Start the copy of tile `tile` (image tile / tpi, blocks from
// (tile % tpi) * kTile) into `dst`; blocks past n_blk are zero-filled.
__device__ __forceinline__ void issue_tile(int32_t* dst,
                                           const int32_t* __restrict__ blocks,
                                           int64_t n_blk, int64_t tpi,
                                           int64_t tile) {
  const int64_t img = tile / tpi;
  const int64_t b0 = (tile - img * tpi) * kTile;
  const int32_t* src = blocks + (img * n_blk + b0) * 64;
#pragma unroll
  for (int j = 0; j < kVecPerThread; ++j) {
    const int v = threadIdx.x + j * kThreads;   // int4 index in the tile
    const bool ok = b0 + (v >> 4) < n_blk;
    const unsigned saddr =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + v * 4));
    const int32_t* g = ok ? src + v * 4 : blocks;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     saddr),
                 "l"(g), "r"(ok ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Dynamic shared memory: the ring, then the dequantised blocks, the blocks
// after the row pass, and each warp's queue of samples to recompute.
constexpr size_t kRingBytes = size_t{kStages} * kTile * 64 * sizeof(int32_t);
constexpr size_t kBlockBytes = size_t{kTile} * kPad * sizeof(float);
constexpr size_t kSmemBytes =
    kRingBytes + 2 * kBlockBytes + size_t{kWarps} * kQueue * sizeof(uint16_t);

__global__ void __launch_bounds__(kThreads)
    fused_dequant_idct_kernel(const int32_t* __restrict__ blocks,  // (B,N,64)
                              const int32_t* __restrict__ qtable,  // (B, 64)
                              const float* __restrict__ kron,      // (64, 64)
                              int32_t* __restrict__ out,           // (B,N,64)
                              int64_t n_blk, int64_t tpi, int64_t n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* ring = reinterpret_cast<int32_t*>(smem);
  float* s_x = reinterpret_cast<float*>(smem + kRingBytes);    // dequantised
  float* s_t = s_x + kTile * kPad;                 // after the row pass
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint16_t* queue =
      reinterpret_cast<uint16_t*>(s_t + kTile * kPad) + warp * kQueue;
  const int blk = tid >> 3;   // block in the tile
  const int r = tid & 7;      // row u (row pass), then column q
  int64_t tile = blockIdx.x;
  if (tile >= n_tiles) return;
  // Prologue: tiles 0 .. kStages-2 of this CTA in flight.
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    const int64_t t = tile + j * static_cast<int64_t>(gridDim.x);
    if (t < n_tiles) {
      issue_tile(ring + j * kTile * 64, blocks, n_blk, tpi, t);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  int stage = 0;
  int64_t cur_img = -1;
  int32_t q[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (; tile < n_tiles; tile += gridDim.x) {
    // This tile's group is complete once at most kStages - 2 newer ones
    // are pending; after the barrier every thread is done with the stage
    // the previous tile used, which receives the tile kStages - 1 ahead.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    const int64_t ahead =
        tile + (kStages - 1) * static_cast<int64_t>(gridDim.x);
    const int refill = stage == 0 ? kStages - 1 : stage - 1;
    if (ahead < n_tiles) {
      issue_tile(ring + refill * kTile * 64, blocks, n_blk, tpi, ahead);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const int32_t* tile_in = ring + stage * kTile * 64;
    stage = stage + 1 == kStages ? 0 : stage + 1;

    const int64_t img = tile / tpi;
    const int64_t gb = (tile - img * tpi) * kTile + blk;
    if (img != cur_img) {   // row r of this image's quantiser table
      int4 lo, hi;
      load_row(qtable + img * 64, r, lo, hi);
      q[0] = lo.x, q[1] = lo.y, q[2] = lo.z, q[3] = lo.w;
      q[4] = hi.x, q[5] = hi.y, q[6] = hi.z, q[7] = hi.w;
      cur_img = img;
    }
    int4 clo, chi;
    load_row(tile_in + blk * 64, r, clo, chi);
    float x[8];
    k1_dequant_row(clo, chi, q, x);
    float* xb = s_x + blk * kPad;
    float* tb = s_t + blk * kPad;
    store_row(xb, r, x);
    const float eps = k1_eps(x);

    // Row pass: t[u][c] = sum_v x[u][v] S[c][v], this thread's u = r.
    float t[8];
    k1_row_pass(x, t);
    store_row(tb, r, t);
    __syncwarp();
    // Column pass on column c = r: o[p] = sum_u S[p][u] t[u][c] / 8.
    float col[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) col[u] = tb[u * 8 + r];
    int32_t res[8];
    const unsigned near = k1_col_pass(col, eps, res);
    // Queue the near-half samples of the warp, then spread them over its
    // lanes, each recomputed as the twin computes it.
    const int n_near = __popc(near);
    int incl = n_near;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += y;
    }
    const int total = __shfl_sync(kFullMask, incl, 31);
    int slot = incl - n_near;
#pragma unroll
    for (int p = 0; p < 8; ++p)
      if (near >> p & 1u)
        queue[slot++] = static_cast<uint16_t>(blk * 64 + p * 8 + r);
    if (gb < n_blk) {
      int32_t* dst = out + (img * n_blk + gb) * 64 + r;
#pragma unroll
      for (int p = 0; p < 8; ++p)
        if (!(near >> p & 1u)) dst[p * 8] = res[p];
    }
    __syncwarp();
    for (int k = lane; k < total; k += 32) {
      const int item = queue[k];
      const int b = item >> 6, idx = item & 63;
      const int64_t gbb = (tile - img * tpi) * kTile + b;
      if (gbb >= n_blk) continue;
      out[(img * n_blk + gbb) * 64 + idx] =
          k1_kron(s_x + b * kPad, kron, idx);
    }
    __syncwarp();   // the warp's blocks in s_x, s_t and its queue are reused
  }
}

}  // namespace

// blocks, out: (n_img, n_blk, 64) int32; qtable: (n_img, 64) int32;
// kron: (64, 64) float32 KRON, row p holding sample p's weights.  All
// contiguous, 16-byte aligned, on the current device (the wrapper checks
// this).  Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int jd_fused_dequant_idct(const void* blocks, const void* qtable,
                                     const void* kron, void* out,
                                     int64_t n_img, int64_t n_blk,
                                     void* stream) {
  if (n_img <= 0 || n_blk <= 0) return 0;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t rc = cudaFuncSetAttribute(
      fused_dequant_idct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_dequant_idct_kernel, kThreads, kSmemBytes);
  if (per_sm < 1) per_sm = 1;
  const int64_t tpi = (n_blk + kTile - 1) / kTile;
  const int64_t n_tiles = n_img * tpi;
  int64_t grid = static_cast<int64_t>(n_sm) * per_sm;   // one wave
  if (grid > n_tiles) grid = n_tiles;
  fused_dequant_idct_kernel<<<static_cast<unsigned>(grid), kThreads,
                              kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blocks),
      static_cast<const int32_t*>(qtable), static_cast<const float*>(kron),
      static_cast<int32_t*>(out), n_blk, tpi, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
