// int32_chain for NVIDIA Hopper (sm_90a): the card's measured int32
// elementwise ceiling, the denominator of the bench's kernel_pct_peak.
//
// Replaces bench.py:vpu_peak_prepare (:143), which is not a Pallas
// kernel: a jnp chain of eight dependent int32 operations per element
// per iteration (bench.py:164-177) that XLA fuses into one loop over a
// (1024, 512) tile, timed at K 8448 against K 256. A chain of torch ops
// on the card would launch 8 K kernels, each moving the tile through the
// cache, and so would measure launch overhead and L2, not the ALU. This
// kernel runs the whole chain in registers. It computes exactly what
// int32_chain_plain (shasta_tpu_torch/utils/peak.py) computes.
//
// What bounds it: operations. Each element costs 8 K int32 operations
// and 8 bytes of traffic (read once, written once), so the issue rate of
// the SMs' int32 units bounds it (the data sheet's 64 lanes per SM).
//
// What the design does about it. One element per thread, 256 threads a
// block, so a sub-partition holds up to 16 warps of independent chains,
// enough to hide each chain's dependent-latency. The loop index enters
// four of the eight operations, so nothing is hoisted out of the loop;
// the index and its successor are uniform across the warp, so their
// arithmetic stays on the uniform datapath. The loop is unrolled four
// times (chip_smoke.py counts its SASS). The tile is written at the end
// so the work stays live.
//
// Arithmetic: the adds and xors in uint32_t, which wrap as XLA's int32
// does (signed overflow is undefined in C++); the max and min compare
// the same bits as int32_t.
//
// Plain C interface; launched through ctypes on PyTorch's current
// stream. The launch function returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t chain_step(uint32_t y, int i) {
  const uint32_t u = (uint32_t)i;
  y = y + u;                                  // 1 add i
  y = y ^ 0x9E3779B9u;                        // 2 xor const
  y = (uint32_t)max((int32_t)y, i);           // 3 max i
  y = y + y;                                  // 4 add
  y = y ^ u;                                  // 5 xor i
  y = (uint32_t)min((int32_t)y, 1 << 30);     // 6 min const
  y = y + 13u;                                // 7 add const
  y = y ^ (u + 1u);                           // 8 xor i + 1
  return y;
}

__global__ void __launch_bounds__(kThreads)
    int32_chain_kernel(const int32_t* __restrict__ x, int n, int K,
                       int32_t* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  uint32_t y = (uint32_t)x[e];
#pragma unroll 4
  for (int i = 0; i < K; ++i) y = chain_step(y, i);
  out[e] = (int32_t)y;
}

}  // namespace

extern "C" int int32_chain_launch(const int32_t* x, int n, int K, int32_t* out,
                                  void* stream) {
  if (n < 1 || K < 0) return (int)cudaErrorInvalidValue;
  int32_chain_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(x, n, K, out);
  return (int)cudaGetLastError();
}
