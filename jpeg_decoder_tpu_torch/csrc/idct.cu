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
// nothing when bytes are the limit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // one thread per block row
constexpr int kTile = kThreads / 8;         // 32 blocks per tile (8 KB)
constexpr int kStages = 2;                  // tiles in the shared-memory ring
constexpr int kVecPerThread = kTile * 16 / kThreads;  // int4 copies
constexpr int kPad = 72;                    // floats per block, padded
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 4 * 64;              // samples of a warp's 4 blocks
constexpr unsigned kFull = 0xffffffffu;
// eps = sum|deq| * 2^-25 = (sum|deq| / 8) * 2^-22.
constexpr float kEpsScale = 0x1p-25f;

// S[p][u] = float32(sqrt(8) * IDCT_M[p][u]): ops/idct_cuda.py:IDCT_S.
__constant__ float kS[8][8] = {
    {0x1p+0f, 0x1.63150cp+0f, 0x1.4e7aeap+0f, 0x1.2d062ep+0f, 0x1p+0f,
     0x1.92469cp-1f, 0x1.1517a8p-1f, 0x1.1a855ep-2f},
    {0x1p+0f, 0x1.2d062ep+0f, 0x1.1517a8p-1f, -0x1.1a855ep-2f, -0x1p+0f,
     -0x1.63150cp+0f, -0x1.4e7aeap+0f, -0x1.92469cp-1f},
    {0x1p+0f, 0x1.92469cp-1f, -0x1.1517a8p-1f, -0x1.63150cp+0f, -0x1p+0f,
     0x1.1a855ep-2f, 0x1.4e7aeap+0f, 0x1.2d062ep+0f},
    {0x1p+0f, 0x1.1a855ep-2f, -0x1.4e7aeap+0f, -0x1.92469cp-1f, 0x1p+0f,
     0x1.2d062ep+0f, -0x1.1517a8p-1f, -0x1.63150cp+0f},
    {0x1p+0f, -0x1.1a855ep-2f, -0x1.4e7aeap+0f, 0x1.92469cp-1f, 0x1p+0f,
     -0x1.2d062ep+0f, -0x1.1517a8p-1f, 0x1.63150cp+0f},
    {0x1p+0f, -0x1.92469cp-1f, -0x1.1517a8p-1f, 0x1.63150cp+0f, -0x1p+0f,
     -0x1.1a855ep-2f, 0x1.4e7aeap+0f, -0x1.2d062ep+0f},
    {0x1p+0f, -0x1.2d062ep+0f, 0x1.1517a8p-1f, 0x1.1a855ep-2f, -0x1p+0f,
     0x1.63150cp+0f, -0x1.4e7aeap+0f, 0x1.92469cp-1f},
    {0x1p+0f, -0x1.63150cp+0f, 0x1.4e7aeap+0f, -0x1.2d062ep+0f, 0x1p+0f,
     -0x1.92469cp-1f, 0x1.1517a8p-1f, -0x1.1a855ep-2f},
};

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

// Row r of a block as 8 values: two 16-byte accesses, rows 4..7 taking
// their halves in the other order so that the 8 rows of a block hit
// distinct banks in each access (the layout stays natural).
template <class V, class T>
__device__ __forceinline__ void load_row(const T* base, int r, V& lo, V& hi) {
  const V* row = reinterpret_cast<const V*>(base + r * 8);
  const int h = (r >> 2) & 1;
  const V a = row[h], b = row[h ^ 1];
  lo = h ? b : a;
  hi = h ? a : b;
}

__device__ __forceinline__ void store_row(float* base, int r,
                                          const float (&v)[8]) {
  float4* row = reinterpret_cast<float4*>(base + r * 8);
  const int h = (r >> 2) & 1;
  const float4 lo = make_float4(v[0], v[1], v[2], v[3]);
  const float4 hi = make_float4(v[4], v[5], v[6], v[7]);
  row[h] = h ? hi : lo;
  row[h ^ 1] = h ? lo : hi;
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
    float x[8] = {static_cast<float>(clo.x * q[0]),
                  static_cast<float>(clo.y * q[1]),
                  static_cast<float>(clo.z * q[2]),
                  static_cast<float>(clo.w * q[3]),
                  static_cast<float>(chi.x * q[4]),
                  static_cast<float>(chi.y * q[5]),
                  static_cast<float>(chi.z * q[6]),
                  static_cast<float>(chi.w * q[7])};
    float* xb = s_x + blk * kPad;
    float* tb = s_t + blk * kPad;
    store_row(xb, r, x);
    float asum = fabsf(x[0]);
#pragma unroll
    for (int v = 1; v < 8; ++v) asum += fabsf(x[v]);
    asum += __shfl_xor_sync(kFull, asum, 1);
    asum += __shfl_xor_sync(kFull, asum, 2);
    asum += __shfl_xor_sync(kFull, asum, 4);

    // Row pass: t[u][c] = sum_v x[u][v] S[c][v], this thread's u = r.
    float t[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float a = x[0] * kS[c][0];
#pragma unroll
      for (int v = 1; v < 8; ++v) a = fmaf(x[v], kS[c][v], a);
      t[c] = a;
    }
    store_row(tb, r, t);
    __syncwarp();
    // Column pass on column c = r: o[p] = sum_u S[p][u] t[u][c] / 8.
    float col[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) col[u] = tb[u * 8 + r];
    const float eps = asum * kEpsScale;
    unsigned near = 0;
    int32_t res[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      float a = kS[p][0] * col[0];
#pragma unroll
      for (int u = 1; u < 8; ++u) a = fmaf(kS[p][u], col[u], a);
      const float o = a * 0.125f;   // exact
      res[p] = __float2int_rn(o);   // half to even
      if (fabsf(o - floorf(o) - 0.5f) < eps) near |= 1u << p;
    }
    // Queue the near-half samples of the warp, then spread them over its
    // lanes, each recomputed as the twin computes it.
    const int n_near = __popc(near);
    int incl = n_near;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
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
      const float4* d4 = reinterpret_cast<const float4*>(s_x + b * kPad);
      const float4* w4 = reinterpret_cast<const float4*>(kron + idx * 64);
      float acc = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < 16; ++k4) {
        const float4 d = d4[k4];
        const float4 w = __ldg(w4 + k4);
        acc = fmaf(d.x, w.x, acc);
        acc = fmaf(d.y, w.y, acc);
        acc = fmaf(d.z, w.z, acc);
        acc = fmaf(d.w, w.w, acc);
      }
      out[(img * n_blk + gbb) * 64 + idx] = __float2int_rn(acc);
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
