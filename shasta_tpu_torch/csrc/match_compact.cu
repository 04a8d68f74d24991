// match_compact for NVIDIA Hopper (sm_90a): the kept pairs' matches of one
// phase-2 batch, written straight into the alignment store's CSR.
//
// Replaces no TPU kernel. The JAX package collects phase 2's matches on
// the host (shasta_tpu/ops/align.py: _collect_bucket, collect_filtered_*):
// each batch's matches come to the host and numpy scatters them into the
// output CSR. The port did the same, as a nonzero on the device, three
// int64 arrays (row, column, value) fetched per batch, 24 bytes for a
// match that the store keeps in 4, and a numpy scatter of them all: most
// of computeAlignments' time on the card. This kernel does that scatter
// on the card, so only the store's own arrays cross. It computes exactly
// what match_compact_plain (ops/align_kernel.py) computes.
//
// Input: the fused (B, 16 + LA) int32 output of banded_align_pairs, whose
// columns 16 .. 15 + LA hold each row's matched ordinal1 per ordinal0 (or
// -1), and dst (B,) int64: the CSR slot of row b's first match, or -1
// where the pair is not kept. Output: for each kept row, its matches in
// column (path) order, ord0[dst + k] = the column and ord1[dst + k] = the
// value, in the store's type (uint16_t, or uint32_t when a read has more
// than 65,535 markers).
//
// What bounds it: bytes. It reads each kept row's LA columns and every
// row's dst once, and writes 2 x sizeof(Out) bytes a match; its
// arithmetic is a few instructions a column. A row not kept costs its
// 8-byte dst.
//
// What the design does about it. One warp per row, eight rows a block.
// The warp walks its row 32 x V columns a step, each thread holding V
// adjacent columns: V = 4 (one 16-byte load) where LA is a multiple of 4
// and the rows are 16-byte aligned, V = 1 elsewhere. Four steps are
// loaded before any is written, so four loads a thread are in flight. A
// thread's slot is the warp's running count plus the matches of the
// lanes below it: one ballot per column of its vector, each popcount
// masked to those lanes. The running count moves on by the ballots'
// totals. The walk is a loop and offsets are 64-bit, so rows of any LA
// and stores past 2^31 matches work.
//
// Plain C interface; launched through ctypes on PyTorch's current
// stream. The launch function returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kSteps = 4;  // steps loaded ahead of their writes
constexpr unsigned kFull = 0xffffffffu;

// Columns c .. c + V - 1 of a row's matches (-1 past LA).
template <int V>
__device__ __forceinline__ void load_cols(const int32_t* __restrict__ mj,
                                          int c, int LA, int32_t (&v)[V]) {
  if constexpr (V == 4) {
    if (c < LA) {  // LA is a multiple of 4: the vector is whole
      const int4 q = __ldg(reinterpret_cast<const int4*>(mj + c));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = -1;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = c + k < LA ? __ldg(mj + c + k) : -1;
  }
}

template <typename Out, int V>
__global__ void __launch_bounds__(32 * kWarps)
    match_compact_kernel(const int32_t* __restrict__ fused, int B, int LA,
                         const int64_t* __restrict__ dst,
                         Out* __restrict__ ord0, Out* __restrict__ ord1) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;
  const int64_t slot = __ldg(dst + row);
  if (slot < 0) return;  // the whole warp: dst is the row's
  const int32_t* mj = fused + (size_t)row * (size_t)(16 + LA) + 16;
  const unsigned below = (1u << lane) - 1u;
  constexpr int kCols = 32 * V;
  int64_t base = slot;
  for (int c0 = 0; c0 < LA; c0 += kSteps * kCols) {
    int32_t v[kSteps][V];
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      load_cols<V>(mj, c0 + s * kCols + lane * V, LA, v[s]);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      int before = 0, total = 0;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const unsigned m = __ballot_sync(kFull, v[s][k] >= 0);
        before += __popc(m & below);
        total += __popc(m);
      }
      const int c = c0 + s * kCols + lane * V;
      int64_t p = base + before;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (v[s][k] >= 0) {
          ord0[p] = (Out)(c + k);
          ord1[p] = (Out)v[s][k];
          ++p;
        }
      }
      base += total;
    }
  }
}

template <typename Out>
int launch(const int32_t* fused, int B, int LA, const int64_t* dst,
           void* ord0, void* ord1, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  if (LA % 4 == 0 && (reinterpret_cast<uintptr_t>(fused) & 15) == 0) {
    match_compact_kernel<Out, 4><<<blocks, 32 * kWarps, 0, stream>>>(
        fused, B, LA, dst, static_cast<Out*>(ord0), static_cast<Out*>(ord1));
  } else {
    match_compact_kernel<Out, 1><<<blocks, 32 * kWarps, 0, stream>>>(
        fused, B, LA, dst, static_cast<Out*>(ord0), static_cast<Out*>(ord1));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out_bytes: 2 (uint16_t ordinals) or 4 (uint32_t).
extern "C" int match_compact_launch(const int32_t* fused, int B, int LA,
                                    const int64_t* dst, void* ord0, void* ord1,
                                    int out_bytes, void* stream) {
  if (B < 1 || LA < 0 || (out_bytes != 2 && out_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return out_bytes == 2
             ? launch<uint16_t>(fused, B, LA, dst, ord0, ord1, st)
             : launch<uint32_t>(fused, B, LA, dst, ord0, ord1, st);
}
