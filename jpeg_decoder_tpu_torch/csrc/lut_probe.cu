// LUT-probe kernels, hand-written for Hopper (sm_90a), bound to PyTorch
// through plain C entry points and ctypes.
//
// Replace the TPU probe kernels of tools/pallas_mosaic_repro.py, which
// reduce the core operation of the Huffman decoder (csrc/entropy.cu) --
// "peek 16 stream bits, index a 65,536-entry LUT" -- to two minimal
// kernels:
//  * lut_chain: `run` with lane_kernel / sublane_kernel.  One thread makes
//    n dependent probes, acc += lut[(idx[i] + acc) & 0xFFFF].  The TPU's two
//    variants compute the same value; their layouts existed only for
//    Mosaic's lowering rules, so here there is one kernel, reading the LUT
//    from device memory.  Bound: latency (each probe's address depends on
//    the last probe's value), the pattern of one Huffman lane.
//  * lut_gather: vecprobe_kernel.  One thread per index, out[t] =
//    lut[idx[t] & 0xFFFF]: the per-lane probe Mosaic could only emulate by a
//    one-hot over all 512 table rows.  Bound: bytes (4 B index in, 4 B
//    out; the 256 KB table stays in L2), at this size launch latency.
// Arithmetic is on uint32 so a sum past INT32_MAX wraps as the int32 twins'
// does, without undefined behaviour.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGatherThreads = 256;

__global__ void lut_chain_kernel(const int32_t* __restrict__ lut,
                                 const int32_t* __restrict__ idx,
                                 int32_t* __restrict__ out, int64_t n) {
  uint32_t acc = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t w16 = (static_cast<uint32_t>(idx[i]) + acc) & 0xFFFFu;
    acc += static_cast<uint32_t>(lut[w16]);
  }
  out[0] = static_cast<int32_t>(acc);
}

__global__ void __launch_bounds__(kGatherThreads)
lut_gather_kernel(const int32_t* __restrict__ lut,
                  const int32_t* __restrict__ idx,
                  int32_t* __restrict__ out, int64_t n) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t < n) out[t] = lut[static_cast<uint32_t>(idx[t]) & 0xFFFFu];
}

}  // namespace

// lut: (65536,) int32; idx: (n,) int32; out: (1,) int32.  One thread.
extern "C" int jd_lut_chain(const void* lut, const void* idx, void* out,
                            int64_t n, void* stream) {
  lut_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lut), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// lut: (65536,) int32; idx, out: (n,) int32.  One thread per index.
extern "C" int jd_lut_gather(const void* lut, const void* idx, void* out,
                             int64_t n, void* stream) {
  if (n <= 0) return 0;
  const unsigned grid =
      static_cast<unsigned>((n + kGatherThreads - 1) / kGatherThreads);
  lut_gather_kernel<<<grid, kGatherThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lut), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
