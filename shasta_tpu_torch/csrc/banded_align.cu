// banded_fwd's row-scan body, for NVIDIA Hopper (sm_90a).
//
// Replaces the forward half of the Pallas kernels of
// shasta_tpu/ops/align_pallas.py, _kernel (:156-294) and
// _fwd_chunked_kernel (:581), for the launches that the anti-diagonal
// body (banded_fwd_diag.cu) does not take: W > DIAG_MAX_W (2048) or
// W > 2 LA (fwd_body, ops/align_kernel.py).
// The TPU needs a monolithic and a chunked regime because of its VMEM
// budget; here the packed direction codes always stream to device
// memory, so this body serves every LA and every W: up to kSmemMaxW
// (16384) lanes with its two rows in shared memory (banded_fwd_kernel),
// past that with them in device memory (banded_fwd_wide_kernel, below).
// The traceback is banded_tb.cu.
//
// What bounds it. The forward pass is a row-sequential DP: each row of
// a pair's band depends on the previous row (diag/up) and, through the
// LEFT gap, on the lanes before it in the same row. An interior band
// cell needs ~13 int32 operations and writes 2 bits, so the work is
// bound by operations, not by device memory. On an H100 the body is
// bound by latency instead: a row is one chain (the a and b loads, each
// lane's in a divergent branch region of its own, the shared-memory
// read of the previous row, the shuffle scan, the barrier), about 1,740
// cycles per row at W = 128 (PERF.md).
//
// What the design does about it. One thread block per pair, each
// thread owning K contiguous lanes, so most of a row's work is
// thread-local registers: a running max gives the in-row prefix max
// over the thread's lanes, and only the per-thread totals go through a
// warp shuffle scan plus one pass over the warp totals in shared
// memory. The previous row lives in shared memory, double-buffered, so
// one barrier per row publishes it. Best-end accumulators stay in
// registers and are folded once per pair with exactly the reference's
// tie-break (max score, then earliest row, then last column before
// last row, then lowest lane). Direction codes are packed 16 rows to a
// 32-bit word in registers and stored once every 16 rows. Rows past a
// pair's a_len are skipped (no cell there is valid). Across warps the
// block is what a wide band needs; up to DIAG_MAX_W (2048) lanes, where
// LA is at least W / 2, the anti-diagonal body runs instead (its
// launcher takes up to DIAG_W_LIMIT, 4096 lanes).
//
// Plain C interface; launched through ctypes on PyTorch's current
// stream. The launch function returns cudaGetLastError().

#include "banded_common.cuh"

namespace {

using banded::better;
using banded::kFull;
using banded::kNegInf;

// Forward DP. Grid: one block per pair. Block: T = ceil(W / K) threads
// rounded up to a warp multiple; thread t owns lanes [t*K, t*K + K).
// Shared memory: two (W + 1)-int row buffers (the extra int is the UP
// neighbour of lane W - 1, always NEG_INF) and 3 x 32 ints of scratch.
template <int K>
__global__ void __launch_bounds__(1024)
    banded_fwd_kernel(const int* __restrict__ a, const int* __restrict__ b,
                      const int* __restrict__ a_len,
                      const int* __restrict__ b_len,
                      const int* __restrict__ band_min, int LA, int LB, int W,
                      int match, int mismatch, int gap, int* __restrict__ dirs,
                      int* __restrict__ best, int* __restrict__ bi_out,
                      int* __restrict__ bd_out) {
  extern __shared__ int smem[];
  int* buf0 = smem;
  int* buf1 = smem + (W + 1);
  int* scratch = smem + 2 * (W + 1);  // 96 ints

  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wid = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* ap = a + (size_t)p * LA;
  const int* bp = b + (size_t)p * LB;
  const int alen = a_len[p];
  const int blen = b_len[p];
  const int bm = band_min[p];
  const int nw16 = (LA + 15) >> 4;
  int* dp = dirs + (size_t)p * nw16 * W;
  const int d0 = t * K;

  // Row 0: V[0][j] = 0 for 0 <= j <= b_len inside the band.
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + k;
    if (d < W) {
      const int j = bm + d;
      buf0[d] = (j >= 0 && j <= blen) ? 0 : kNegInf;
    }
  }
  if (t == 0) {
    buf0[W] = kNegInf;
    buf1[W] = kNegInf;
  }

  int bv[K], bim[K];
  unsigned pk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bv[k] = kNegInf;
    bim[k] = 0;
    pk[k] = 0u;
  }
  __syncthreads();

  const int rows = alen < LA ? alen : LA;
  for (int i = 1; i <= rows; ++i) {
    const int* pv = (i & 1) ? buf0 : buf1;  // row i - 1
    int* nv = (i & 1) ? buf1 : buf0;        // row i
    const int av = __ldg(ap + i - 1);
    const int jrow = i + bm;  // j of lane 0

    int base[K], diag[K], run[K];
    bool mt[K];
    int lmax = kNegInf;  // the scan identity (and the TPU scan's fill)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = d0 + k;
      base[k] = 0;
      diag[k] = 0;
      mt[k] = false;
      if (d < W) {
        const int j = jrow + d;
        const int jm1 = j - 1;
        const int bj = (jm1 >= 0 && jm1 < LB) ? __ldg(bp + jm1) : -2;
        mt[k] = bj == av;
        diag[k] = pv[d] + (mt[k] ? match : mismatch);
        int bs = max(diag[k], pv[d + 1] + gap);
        if (j == 0) bs = max(bs, 0);
        base[k] = bs;
        lmax = max(lmax, bs - d * gap);
      }
      run[k] = lmax;
    }

    // Exclusive block scan (max) of the per-thread totals.
    int x = lmax;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x = max(x, y);
    }
    int excl = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) excl = kNegInf;
    if (nwarps > 1) {
      if (lane == 31) scratch[wid] = x;
      __syncthreads();
      for (int w = 0; w < wid; ++w) excl = max(excl, scratch[w]);
    }

    const unsigned sh = 2u * (unsigned)((i - 1) & 15);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = d0 + k;
      if (d < W) {
        const int j = jrow + d;
        const bool valid = j >= 0 && j <= blen;  // i <= a_len holds here
        const int V = valid ? max(run[k], excl) + d * gap : kNegInf;
        const int code = V > base[k] ? 3 : (base[k] == diag[k] ? (mt[k] ? 0 : 1) : 2);
        nv[d] = V;
        pk[k] |= (unsigned)code << sh;
        const bool iscol = valid && j == blen;
        const bool endm = iscol || (valid && i == alen);
        if (endm && V > bv[k]) {
          bv[k] = V;
          bim[k] = iscol ? 2 * i : 2 * i + 1;
        }
      }
    }
    if ((i & 15) == 0 || i == rows) {
      int* wp = dp + (size_t)((i - 1) >> 4) * W;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = d0 + k;
        if (d < W) wp[d] = (int)pk[k];
        pk[k] = 0u;
      }
    }
    __syncthreads();
  }

  // Best end: lexicographic (max V, min packed row, min lane).
  int v = INT_MIN, im = INT_MAX, bd = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + k;
    if (d < W && better(bv[k], bim[k], d, v, im, bd)) {
      v = bv[k];
      im = bim[k];
      bd = d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v2 = __shfl_down_sync(kFull, v, o);
    const int im2 = __shfl_down_sync(kFull, im, o);
    const int d2 = __shfl_down_sync(kFull, bd, o);
    if (better(v2, im2, d2, v, im, bd)) {
      v = v2;
      im = im2;
      bd = d2;
    }
  }
  if (lane == 0) {
    scratch[wid] = v;
    scratch[32 + wid] = im;
    scratch[64 + wid] = bd;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < nwarps; ++w) {
      if (better(scratch[w], scratch[32 + w], scratch[64 + w], v, im, bd)) {
        v = scratch[w];
        im = scratch[32 + w];
        bd = scratch[64 + w];
      }
    }
    best[p] = v;
    bi_out[p] = im >> 1;
    bd_out[p] = bd;
  }
}

// Bands wider than kSmemMaxW lanes. Two rows of W + 1 ints no longer
// fit in a block's shared memory, nor K lanes a thread in 1024 threads'
// registers. So the two row buffers live in device memory (rowbuf, a
// per-pair scratch of 2 (W + 1) ints that the wrapper allocates; L1 and
// L2 hold the previous row's lanes a tile reads), and each row runs in
// tiles of kTile lanes, kWideK a thread, in order of lane: the prefix
// max's running value (the max of base - d * gap over the lanes before
// the tile) is carried from tile to tile in a register of every thread.
// A thread's lanes change from tile to tile, so its 2-bit codes cannot
// wait in registers for the 16 rows of a dirs word: each row's code is
// or-ed into the word in device memory (the word's first row stores
// it). The best end is folded per thread over every end cell it
// computes, with better(): the same lexicographic best as the per-lane
// accumulators of banded_fwd_kernel. Each cell thus costs two loads of
// the previous row, one store of the new row and a read-modify-write of
// its dirs word in device memory (bound by memory latency, not by
// operations); the DP's order and arithmetic are the narrow body's.
constexpr int kSmemMaxW = 16384;
constexpr int kWideK = 16;
constexpr int kWideThreads = 1024;
constexpr int kTile = kWideK * kWideThreads;

__global__ void __launch_bounds__(kWideThreads)
    banded_fwd_wide_kernel(const int* __restrict__ a,
                           const int* __restrict__ b,
                           const int* __restrict__ a_len,
                           const int* __restrict__ b_len,
                           const int* __restrict__ band_min, int LA, int LB,
                           int W, int match, int mismatch, int gap,
                           int* rowbuf, int* __restrict__ dirs,
                           int* __restrict__ best, int* __restrict__ bi_out,
                           int* __restrict__ bd_out) {
  __shared__ int scratch[96];
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wid = t >> 5;
  constexpr int nwarps = kWideThreads / 32;
  const int* ap = a + (size_t)p * LA;
  const int* bp = b + (size_t)p * LB;
  const int alen = a_len[p];
  const int blen = b_len[p];
  const int bm = band_min[p];
  const int nw16 = (LA + 15) >> 4;
  int* dp = dirs + (size_t)p * nw16 * W;
  int* buf0 = rowbuf + (size_t)p * 2 * (W + 1);
  int* buf1 = buf0 + (W + 1);

  // Row 0: V[0][j] = 0 for 0 <= j <= b_len inside the band.
  for (int d = t; d < W; d += kWideThreads) {
    const int j = bm + d;
    buf0[d] = (j >= 0 && j <= blen) ? 0 : kNegInf;
  }
  if (t == 0) {
    buf0[W] = kNegInf;
    buf1[W] = kNegInf;
  }
  // This thread's best end cell so far; (kNegInf, 0, lane 0), the best
  // of a pair with no end cell above kNegInf, is folded in at the end.
  int v = INT_MIN, im = INT_MAX, bd = INT_MAX;
  __syncthreads();

  const int rows = alen < LA ? alen : LA;
  for (int i = 1; i <= rows; ++i) {
    const int* pv = (i & 1) ? buf0 : buf1;  // row i - 1
    int* nv = (i & 1) ? buf1 : buf0;        // row i
    const int av = __ldg(ap + i - 1);
    const int jrow = i + bm;  // j of lane 0
    const unsigned sh = 2u * (unsigned)((i - 1) & 15);
    const bool first = sh == 0u;
    int* wp = dp + (size_t)((i - 1) >> 4) * W;
    int carry = kNegInf;  // max of base - d * gap over the earlier tiles
    for (int t0 = 0; t0 < W; t0 += kTile) {
      const int d0 = t0 + t * kWideK;
      int base[kWideK], diag[kWideK], run[kWideK];
      bool mt[kWideK];
      int lmax = kNegInf;
#pragma unroll
      for (int k = 0; k < kWideK; ++k) {
        const int d = d0 + k;
        base[k] = 0;
        diag[k] = 0;
        mt[k] = false;
        if (d < W) {
          const int j = jrow + d;
          const int jm1 = j - 1;
          const int bj = (jm1 >= 0 && jm1 < LB) ? __ldg(bp + jm1) : -2;
          mt[k] = bj == av;
          diag[k] = pv[d] + (mt[k] ? match : mismatch);
          int bs = max(diag[k], pv[d + 1] + gap);
          if (j == 0) bs = max(bs, 0);
          base[k] = bs;
          lmax = max(lmax, bs - d * gap);
        }
        run[k] = lmax;
      }

      // Exclusive block scan (max) of the per-thread totals, then the
      // tile's total for the carry.
      int x = lmax;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x = max(x, y);
      }
      int excl = __shfl_up_sync(kFull, x, 1);
      if (lane == 0) excl = kNegInf;
      if (lane == 31) scratch[wid] = x;
      __syncthreads();
      int total = carry;
      for (int w = 0; w < nwarps; ++w) {
        const int s = scratch[w];
        if (w < wid) excl = max(excl, s);
        total = max(total, s);
      }
      excl = max(excl, carry);

#pragma unroll
      for (int k = 0; k < kWideK; ++k) {
        const int d = d0 + k;
        if (d < W) {
          const int j = jrow + d;
          const bool valid = j >= 0 && j <= blen;  // i <= a_len holds here
          const int V = valid ? max(run[k], excl) + d * gap : kNegInf;
          const int code =
              V > base[k] ? 3 : (base[k] == diag[k] ? (mt[k] ? 0 : 1) : 2);
          nv[d] = V;
          const unsigned c = (unsigned)code << sh;
          wp[d] = first ? (int)c : (int)((unsigned)wp[d] | c);
          const bool iscol = valid && j == blen;
          const bool endm = iscol || (valid && i == alen);
          const int im2 = iscol ? 2 * i : 2 * i + 1;
          if (endm && V > kNegInf && better(V, im2, d, v, im, bd)) {
            v = V;
            im = im2;
            bd = d;
          }
        }
      }
      carry = total;
      // The next tile rewrites scratch; after the row's last tile this
      // barrier also publishes row i to the next row's reads.
      __syncthreads();
    }
  }

  banded::warp_fold_best(v, im, bd);
  if (lane == 0) {
    scratch[wid] = v;
    scratch[32 + wid] = im;
    scratch[64 + wid] = bd;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < nwarps; ++w) {
      if (better(scratch[w], scratch[32 + w], scratch[64 + w], v, im, bd)) {
        v = scratch[w];
        im = scratch[32 + w];
        bd = scratch[64 + w];
      }
    }
    if (better(kNegInf, 0, 0, v, im, bd)) {
      v = kNegInf;
      im = 0;
      bd = 0;
    }
    best[p] = v;
    bi_out[p] = im >> 1;
    bd_out[p] = bd;
  }
}

template <int K>
cudaError_t launch_fwd(const int* a, const int* b, const int* a_len,
                       const int* b_len, const int* band_min, int B, int LA,
                       int LB, int W, int match, int mismatch, int gap,
                       int* dirs, int* best, int* bi, int* bd,
                       cudaStream_t stream) {
  int threads = (W + K - 1) / K;
  threads = ((threads + 31) / 32) * 32;
  const size_t smem = (size_t)(2 * (W + 1) + 96) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        banded_fwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  banded_fwd_kernel<K><<<B, threads, smem, stream>>>(
      a, b, a_len, b_len, band_min, LA, LB, W, match, mismatch, gap, dirs,
      best, bi, bd);
  return cudaGetLastError();
}

}  // namespace

// The row-scan body at any W (banded_fwd where fwd_body does not pick
// the anti-diagonal body: W > DIAG_MAX_W or W > 2 LA). rowbuf: the
// device-memory row buffers of W > kSmemMaxW, 2 (W + 1) ints per pair
// (unused, and may be null, at W <= kSmemMaxW).
extern "C" int banded_fwd_rows_launch(const int* a, const int* b,
                                      const int* a_len, const int* b_len,
                                      const int* band_min, int B, int LA,
                                      int LB, int W, int match, int mismatch,
                                      int gap, int* rowbuf, int* dirs,
                                      int* best, int* bi, int* bd,
                                      void* stream) {
  if (B < 1 || LA < 1 || LB < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (W <= 4096)
    return (int)launch_fwd<4>(a, b, a_len, b_len, band_min, B, LA, LB, W,
                              match, mismatch, gap, dirs, best, bi, bd, s);
  if (W <= kSmemMaxW)
    return (int)launch_fwd<16>(a, b, a_len, b_len, band_min, B, LA, LB, W,
                               match, mismatch, gap, dirs, best, bi, bd, s);
  if (rowbuf == nullptr) return (int)cudaErrorInvalidValue;
  banded_fwd_wide_kernel<<<B, kWideThreads, 0, s>>>(
      a, b, a_len, b_len, band_min, LA, LB, W, match, mismatch, gap, rowbuf,
      dirs, best, bi, bd);
  return (int)cudaGetLastError();
}
