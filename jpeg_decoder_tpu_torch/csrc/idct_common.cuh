// Device code shared by K1 (idct.cu), K5 (idct_exact.cu) and K6b
// (pixels.cu), so that K6b gives K1's and K5's samples bit for bit, and
// K6b's own `fast` arithmetic.
//
// K1's arithmetic (the `pallas` IDCT): a separable float32 sum with the
// basis S = sqrt(8) IDCT_M, a row pass then a column pass, one explicit FMA
// per term, times 1/8 (exact), rint half to even; a sample within eps of a
// half (eps = 2^-22 of the block's sum|deq|/8) recomputed as the twin's
// 64-term Kronecker dot in k order.  Eight threads take a block, one row
// each (8-lane aligned groups of a warp: the eps needs their shuffles).
//
// K5's arithmetic (the `exact` IDCT): the reference's AAN butterfly, every
// float operation an uncontracted __fmul_rn / __fadd_rn / __fsub_rn, with
// truncating, saturating int32 stores between the column and the row pass.
//
// `fast` (K6b only): M @ X @ M^T with M = IDCT_M_F32 (ops/pixel.py),
// associated as torch's einsum contracts it, (M @ X) @ M^T: a column pass
// then a row pass, one explicit FMA per term in index order, rounded half
// to even and saturating (__float2int_rn), as pixel.idct_fast rounds; within
// +-1 of XLA's einsum (the reference gives `fast` that bound).  Plain model:
// ops/pixels_cuda.py:fast_separable.
//
// A library built from a source that includes this header is named by a
// hash of both (_build.lib_path), and nvcc finds it with -I csrc.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// ---- K1 ---------------------------------------------------------------

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

// Row r of a block dequantised: int32 products (wrapping), then float.
__device__ __forceinline__ void k1_dequant_row(const int4& clo,
                                               const int4& chi,
                                               const int32_t (&q)[8],
                                               float (&x)[8]) {
  x[0] = static_cast<float>(clo.x * q[0]);
  x[1] = static_cast<float>(clo.y * q[1]);
  x[2] = static_cast<float>(clo.z * q[2]);
  x[3] = static_cast<float>(clo.w * q[3]);
  x[4] = static_cast<float>(chi.x * q[4]);
  x[5] = static_cast<float>(chi.y * q[5]);
  x[6] = static_cast<float>(chi.z * q[6]);
  x[7] = static_cast<float>(chi.w * q[7]);
}

// The block's eps from each thread's dequantised row: |x| summed along the
// row, then over rows 0+1, 2+3, ... by lane shuffles within the 8-lane
// group.  Every lane of the warp must call it.
__device__ __forceinline__ float k1_eps(const float (&x)[8]) {
  float asum = fabsf(x[0]);
#pragma unroll
  for (int v = 1; v < 8; ++v) asum += fabsf(x[v]);
  asum += __shfl_xor_sync(kFullMask, asum, 1);
  asum += __shfl_xor_sync(kFullMask, asum, 2);
  asum += __shfl_xor_sync(kFullMask, asum, 4);
  return asum * kEpsScale;
}

// Row pass: t[u][c] = sum_v x[u][v] S[c][v], for this thread's row u.
__device__ __forceinline__ void k1_row_pass(const float (&x)[8],
                                            float (&t)[8]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float a = x[0] * kS[c][0];
#pragma unroll
    for (int v = 1; v < 8; ++v) a = fmaf(x[v], kS[c][v], a);
    t[c] = a;
  }
}

// Column pass on one column: o[p] = sum_u S[p][u] col[u] / 8, rounded half
// to even into res[p]; returns the mask of the samples within eps of a
// half, which the caller recomputes with k1_kron.
__device__ __forceinline__ unsigned k1_col_pass(const float (&col)[8],
                                                float eps,
                                                int32_t (&res)[8]) {
  unsigned near = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    float a = kS[p][0] * col[0];
#pragma unroll
    for (int u = 1; u < 8; ++u) a = fmaf(kS[p][u], col[u], a);
    const float o = a * 0.125f;   // exact
    res[p] = __float2int_rn(o);   // half to even
    if (fabsf(o - floorf(o) - 0.5f) < eps) near |= 1u << p;
  }
  return near;
}

// Sample idx of a dequantised block `xb` (64 floats, natural order,
// 16-byte aligned) as the twin computes it: the 64-term Kronecker dot in k
// order, one FMA per term; `kron` is KRON, row p holding sample p's
// weights.
__device__ __forceinline__ int32_t k1_kron(const float* xb,
                                           const float* __restrict__ kron,
                                           int idx) {
  const float4* d4 = reinterpret_cast<const float4*>(xb);
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
  return __float2int_rn(acc);
}

// ---- K5 ---------------------------------------------------------------

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

// Words between rows and between blocks of K5's shared tile: padded so
// that neither pass's accesses collide in a bank.
constexpr int kRowStride = 9;
constexpr int kBlockStride = 72;

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

// int32 product coefficient * q with wraparound, computed unsigned (no
// signed overflow in C++).
__device__ __forceinline__ int k5_dequant(int v, int q) {
  return static_cast<int>(static_cast<unsigned int>(v) *
                          static_cast<unsigned int>(q));
}

// Column pass on column c of a dequantised block `t` (rows kRowStride
// words apart), written back truncated to int32.
__device__ __forceinline__ void k5_col_pass(int* t, int c) {
  float x[8], y[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) x[r] = __int2float_rn(t[r * kRowStride + c]);
  aan_1d(x, y);
#pragma unroll
  for (int r = 0; r < 8; ++r) t[r * kRowStride + c] = __float2int_rz(y[r]);
}

// Row pass on row r of `t` after the column pass: the row's 8 samples.
__device__ __forceinline__ void k5_row_pass(const int* t, int r,
                                            int (&out)[8]) {
  float x[8], y[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = __int2float_rn(t[r * kRowStride + c]);
  aan_1d(x, y);
#pragma unroll
  for (int c = 0; c < 8; ++c) out[c] = __float2int_rz(y[c]);
}

// ---- fast (K6b) -------------------------------------------------------

// M[p][u] = float32(IDCT_M[p][u]): ops/pixel.py:IDCT_M_F32.
__constant__ float kM[8][8] = {
    {0x1.6a09e6p-2f, 0x1.f6297cp-2f, 0x1.d906bcp-2f, 0x1.a9b662p-2f,
     0x1.6a09e6p-2f, 0x1.1c73b4p-2f, 0x1.87de2ap-3f, 0x1.8f8b84p-4f},
    {0x1.6a09e6p-2f, 0x1.a9b662p-2f, 0x1.87de2ap-3f, -0x1.8f8b84p-4f,
     -0x1.6a09e6p-2f, -0x1.f6297cp-2f, -0x1.d906bcp-2f, -0x1.1c73b4p-2f},
    {0x1.6a09e6p-2f, 0x1.1c73b4p-2f, -0x1.87de2ap-3f, -0x1.f6297cp-2f,
     -0x1.6a09e6p-2f, 0x1.8f8b84p-4f, 0x1.d906bcp-2f, 0x1.a9b662p-2f},
    {0x1.6a09e6p-2f, 0x1.8f8b84p-4f, -0x1.d906bcp-2f, -0x1.1c73b4p-2f,
     0x1.6a09e6p-2f, 0x1.a9b662p-2f, -0x1.87de2ap-3f, -0x1.f6297cp-2f},
    {0x1.6a09e6p-2f, -0x1.8f8b84p-4f, -0x1.d906bcp-2f, 0x1.1c73b4p-2f,
     0x1.6a09e6p-2f, -0x1.a9b662p-2f, -0x1.87de2ap-3f, 0x1.f6297cp-2f},
    {0x1.6a09e6p-2f, -0x1.1c73b4p-2f, -0x1.87de2ap-3f, 0x1.f6297cp-2f,
     -0x1.6a09e6p-2f, -0x1.8f8b84p-4f, 0x1.d906bcp-2f, -0x1.a9b662p-2f},
    {0x1.6a09e6p-2f, -0x1.a9b662p-2f, 0x1.87de2ap-3f, 0x1.8f8b84p-4f,
     -0x1.6a09e6p-2f, 0x1.f6297cp-2f, -0x1.d906bcp-2f, 0x1.1c73b4p-2f},
    {0x1.6a09e6p-2f, -0x1.f6297cp-2f, 0x1.d906bcp-2f, -0x1.a9b662p-2f,
     0x1.6a09e6p-2f, -0x1.1c73b4p-2f, 0x1.87de2ap-3f, -0x1.8f8b84p-4f},
};

// Column pass: t[p] = sum_u M[p][u] col[u] on one column of the
// dequantised block (T = M X, column by column), an FMA chain in u order.
__device__ __forceinline__ void fast_col_pass(const float (&col)[8],
                                              float (&t)[8]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    float a = kM[p][0] * col[0];
#pragma unroll
    for (int u = 1; u < 8; ++u) a = fmaf(kM[p][u], col[u], a);
    t[p] = a;
  }
}

// Row pass on one row of T: res[q] = sum_v row[v] M[q][v], an FMA chain in
// v order, rounded half to even, saturating.
__device__ __forceinline__ void fast_row_pass(const float (&row)[8],
                                              int32_t (&res)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float a = row[0] * kM[q][0];
#pragma unroll
    for (int v = 1; v < 8; ++v) a = fmaf(row[v], kM[q][v], a);
    res[q] = __float2int_rn(a);
  }
}

}  // namespace
