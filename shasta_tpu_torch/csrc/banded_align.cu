// banded_fwd's row-scan body and banded_fwd_waves, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the forward half of the Pallas kernels of
// shasta_tpu/ops/align_pallas.py:
//   banded_fwd (row-scan body) <- _kernel (forward half, :156-294) and
//                                 _fwd_chunked_kernel (:581), for the
//                                 launches that the anti-diagonal body
//                                 (banded_fwd_diag.cu) does not take:
//                                 W > DIAG_MAX_W (2048) or W > 2 LA
//                                 (fwd_body, ops/align_kernel.py)
//   banded_fwd_waves <- _kernel_waves (:340), forward half (see below)
// The TPU needs a monolithic and a chunked regime because of its VMEM
// budget; here the packed direction codes always stream to device
// memory, so one kernel serves every LA and every W up to 16384 (two
// rows of W ints in shared memory). A wider band is refused. The
// traceback is banded_tb.cu.
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
// banded_fwd_waves <- _kernel_waves (align_pallas.py:340), the forward
// half. It computes what banded_fwd computes (dirs, best, bi, bd), for
// WAVES = 2 or 4 pairs per thread block, W <= 4096 (K = 4 lanes per
// thread). What bounds it is the same latency chain. What the
// interleave is for: on the TPU, one sub-slab's prefix-max latency is
// filled by the other sub-slabs' independent steps. Here every step of
// the shuffle scan is issued for pair 0, 1, ... WAVES-1 before the next
// dependent step, and the block's barriers are shared by its pairs; but
// each pair's lane loop compiles to divergent branch regions with their
// own loads, one pair after the other, so 2 or 4 pairs in one warp take
// 2 or 4 times as long (PERF.md) and banded_fwd stays the default. Rows
// run to the largest row count among the block's pairs; a pair past its
// own rows writes and updates nothing. The traceback half of
// _kernel_waves is per pair and equal to _kernel's, so banded_tb serves
// it.
//
// Plain C interface; launched through ctypes on PyTorch's current
// stream. Each launch function returns cudaGetLastError().

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

// Forward DP, WAVES pairs per block (pairs blockIdx.x * WAVES + s).
// Block: T = ceil(W / K) threads rounded up to a warp multiple, at most
// MAXT. Shared memory: two (W + 1)-int row buffers per pair, then
// 96 ints of scratch per pair. Slots at or past B are padding: they
// read the block's first pair, own no row and write no output.
template <int K, int WAVES, int MAXT>
__global__ void __launch_bounds__(MAXT)
    banded_fwd_waves_kernel(const int* __restrict__ a,
                            const int* __restrict__ b,
                            const int* __restrict__ a_len,
                            const int* __restrict__ b_len,
                            const int* __restrict__ band_min, int B, int LA,
                            int LB, int W, int match, int mismatch, int gap,
                            int* __restrict__ dirs, int* __restrict__ best,
                            int* __restrict__ bi_out,
                            int* __restrict__ bd_out) {
  extern __shared__ int smem[];
  int* scratch = smem + 2 * WAVES * (W + 1);  // 96 ints per pair

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wid = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nw16 = (LA + 15) >> 4;
  const int d0 = t * K;
  const int p0 = blockIdx.x * WAVES;

  // pc: the pair whose inputs slot s reads (padding slots read the
  // block's first pair and process no row).
  int blen[WAVES], bm[WAVES], alen[WAVES], rows[WAVES], pc[WAVES];
  int rmax = 0;
#pragma unroll
  for (int s = 0; s < WAVES; ++s) {
    const int p = p0 + s;
    const bool ok = p < B;
    pc[s] = ok ? p : p0;
    alen[s] = ok ? a_len[p] : 0;
    blen[s] = ok ? b_len[p] : 0;
    bm[s] = ok ? band_min[p] : 0;
    rows[s] = alen[s] < LA ? alen[s] : LA;
    rmax = max(rmax, rows[s]);
    // Row 0: V[0][j] = 0 for 0 <= j <= b_len inside the band.
    int* buf0 = smem + 2 * s * (W + 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = d0 + k;
      if (d < W) {
        const int j = bm[s] + d;
        buf0[d] = (j >= 0 && j <= blen[s]) ? 0 : kNegInf;
      }
    }
    if (t == 0) {
      buf0[W] = kNegInf;
      buf0[2 * W + 1] = kNegInf;
    }
  }

  int bv[WAVES][K], bim[WAVES][K];
  unsigned pk[WAVES][K];
#pragma unroll
  for (int s = 0; s < WAVES; ++s) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      bv[s][k] = kNegInf;
      bim[s][k] = 0;
      pk[s][k] = 0u;
    }
  }
  __syncthreads();

  for (int i = 1; i <= rmax; ++i) {
    const int pvo = (i & 1) ? 0 : W + 1;  // row i - 1
    const int nvo = (i & 1) ? W + 1 : 0;  // row i
    int base[WAVES][K], diag[WAVES][K], run[WAVES][K];
    bool mt[WAVES][K];
    int x[WAVES], excl[WAVES];

    // The lane loop, pair by pair. A pair past its rows (or a padding
    // slot) computes on in-bounds inputs with no branch, so that the
    // compiler can interleave the pairs' instructions; only its
    // results are dropped below.
#pragma unroll
    for (int s = 0; s < WAVES; ++s) {
      const bool act = i <= rows[s];
      const int* pv = smem + 2 * s * (W + 1) + pvo;
      const int* bp = b + (size_t)pc[s] * LB;
      const int av = __ldg(a + (size_t)pc[s] * LA + (act ? i - 1 : 0));
      const int jrow = i + bm[s];
      int lmax = kNegInf;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = d0 + k;
        base[s][k] = 0;
        diag[s][k] = 0;
        mt[s][k] = false;
        if (d < W) {
          const int j = jrow + d;
          const int jm1 = j - 1;
          const int bj = (jm1 >= 0 && jm1 < LB) ? __ldg(bp + jm1) : -2;
          mt[s][k] = bj == av;
          diag[s][k] = pv[d] + (mt[s][k] ? match : mismatch);
          int bs = max(diag[s][k], pv[d + 1] + gap);
          if (j == 0) bs = max(bs, 0);
          base[s][k] = bs;
          lmax = max(lmax, bs - d * gap);
        }
        run[s][k] = lmax;
      }
      x[s] = lmax;
    }

    // The interleave: each step of the exclusive block scan (max) of
    // the per-thread totals issues for every pair before the next.
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int s = 0; s < WAVES; ++s) {
        const int y = __shfl_up_sync(kFull, x[s], o);
        if (lane >= o) x[s] = max(x[s], y);
      }
    }
#pragma unroll
    for (int s = 0; s < WAVES; ++s) {
      excl[s] = __shfl_up_sync(kFull, x[s], 1);
      if (lane == 0) excl[s] = kNegInf;
    }
    if (nwarps > 1) {
      if (lane == 31) {
#pragma unroll
        for (int s = 0; s < WAVES; ++s) scratch[s * 96 + wid] = x[s];
      }
      __syncthreads();
      for (int w = 0; w < wid; ++w) {
#pragma unroll
        for (int s = 0; s < WAVES; ++s)
          excl[s] = max(excl[s], scratch[s * 96 + w]);
      }
    }

    const unsigned sh = 2u * (unsigned)((i - 1) & 15);
#pragma unroll
    for (int s = 0; s < WAVES; ++s) {
      const bool act = i <= rows[s];
      int* nv = smem + 2 * s * (W + 1) + nvo;
      const int jrow = i + bm[s];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = d0 + k;
        if (d < W) {
          const int j = jrow + d;
          const bool valid = j >= 0 && j <= blen[s];
          const int V = valid ? max(run[s][k], excl[s]) + d * gap : kNegInf;
          const int code =
              V > base[s][k]
                  ? 3
                  : (base[s][k] == diag[s][k] ? (mt[s][k] ? 0 : 1) : 2);
          nv[d] = V;  // the pair's own row buffer
          pk[s][k] |= (unsigned)code << sh;
          const bool iscol = act && valid && j == blen[s];
          const bool endm = iscol || (act && valid && i == alen[s]);
          if (endm && V > bv[s][k]) {
            bv[s][k] = V;
            bim[s][k] = iscol ? 2 * i : 2 * i + 1;
          }
        }
      }
      if (act && ((i & 15) == 0 || i == rows[s])) {
        int* wp = dirs + (size_t)(p0 + s) * nw16 * W +
                  (size_t)((i - 1) >> 4) * W;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int d = d0 + k;
          if (d < W) wp[d] = (int)pk[s][k];
          pk[s][k] = 0u;
        }
      }
    }
    __syncthreads();
  }

  // Best end per pair: lexicographic (max V, min packed row, min lane).
  int v[WAVES], im[WAVES], bd[WAVES];
#pragma unroll
  for (int s = 0; s < WAVES; ++s) {
    v[s] = INT_MIN;
    im[s] = INT_MAX;
    bd[s] = INT_MAX;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = d0 + k;
      if (d < W && better(bv[s][k], bim[s][k], d, v[s], im[s], bd[s])) {
        v[s] = bv[s][k];
        im[s] = bim[s][k];
        bd[s] = d;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int s = 0; s < WAVES; ++s) {
      const int v2 = __shfl_down_sync(kFull, v[s], o);
      const int im2 = __shfl_down_sync(kFull, im[s], o);
      const int d2 = __shfl_down_sync(kFull, bd[s], o);
      if (better(v2, im2, d2, v[s], im[s], bd[s])) {
        v[s] = v2;
        im[s] = im2;
        bd[s] = d2;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < WAVES; ++s) {
      scratch[s * 96 + wid] = v[s];
      scratch[s * 96 + 32 + wid] = im[s];
      scratch[s * 96 + 64 + wid] = bd[s];
    }
  }
  __syncthreads();
  if (t < WAVES && p0 + t < B) {
    const int* sc = scratch + t * 96;
    int vv = sc[0], ii = sc[32], dd = sc[64];
    for (int w = 1; w < nwarps; ++w) {
      if (better(sc[w], sc[32 + w], sc[64 + w], vv, ii, dd)) {
        vv = sc[w];
        ii = sc[32 + w];
        dd = sc[64 + w];
      }
    }
    best[p0 + t] = vv;
    bi_out[p0 + t] = ii >> 1;
    bd_out[p0 + t] = dd;
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

template <int WAVES, int MAXT>
cudaError_t launch_fwd_waves(const int* a, const int* b, const int* a_len,
                             const int* b_len, const int* band_min, int B,
                             int LA, int LB, int W, int match, int mismatch,
                             int gap, int* dirs, int* best, int* bi, int* bd,
                             int threads, cudaStream_t stream) {
  const size_t smem = (size_t)(WAVES * (2 * (W + 1) + 96)) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        banded_fwd_waves_kernel<4, WAVES, MAXT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  banded_fwd_waves_kernel<4, WAVES, MAXT>
      <<<(B + WAVES - 1) / WAVES, threads, smem, stream>>>(
          a, b, a_len, b_len, band_min, B, LA, LB, W, match, mismatch, gap,
          dirs, best, bi, bd);
  return cudaGetLastError();
}

}  // namespace

// waves: 2 or 4 pairs per block; W <= 4096 (K = 4 lanes per thread).
// Blocks of up to 512 threads (W <= 2048) take an instantiation that
// may hold 128 registers a thread; wider ones the 1024-thread one.
extern "C" int banded_fwd_waves_launch(const int* a, const int* b,
                                       const int* a_len, const int* b_len,
                                       const int* band_min, int B, int LA,
                                       int LB, int W, int match, int mismatch,
                                       int gap, int waves, int* dirs,
                                       int* best, int* bi, int* bd,
                                       void* stream) {
  if (B < 1 || LA < 1 || LB < 1 || W < 1 || W > 4096 ||
      (waves != 2 && waves != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = (((W + 3) / 4 + 31) / 32) * 32;
  if (waves == 2) {
    if (threads <= 512)
      return (int)launch_fwd_waves<2, 512>(a, b, a_len, b_len, band_min, B,
                                           LA, LB, W, match, mismatch, gap,
                                           dirs, best, bi, bd, threads, s);
    return (int)launch_fwd_waves<2, 1024>(a, b, a_len, b_len, band_min, B, LA,
                                          LB, W, match, mismatch, gap, dirs,
                                          best, bi, bd, threads, s);
  }
  if (threads <= 512)
    return (int)launch_fwd_waves<4, 512>(a, b, a_len, b_len, band_min, B, LA,
                                         LB, W, match, mismatch, gap, dirs,
                                         best, bi, bd, threads, s);
  return (int)launch_fwd_waves<4, 1024>(a, b, a_len, b_len, band_min, B, LA,
                                        LB, W, match, mismatch, gap, dirs,
                                        best, bi, bd, threads, s);
}

// The row-scan body at any W up to 16384 (banded_fwd where fwd_body
// does not pick the anti-diagonal body: W > DIAG_MAX_W or W > 2 LA).
extern "C" int banded_fwd_rows_launch(const int* a, const int* b,
                                      const int* a_len, const int* b_len,
                                      const int* band_min, int B, int LA,
                                      int LB, int W, int match, int mismatch,
                                      int gap, int* dirs, int* best, int* bi,
                                      int* bd, void* stream) {
  if (B < 1 || LA < 1 || LB < 1 || W < 1 || W > 16384)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (W <= 4096)
    return (int)launch_fwd<4>(a, b, a_len, b_len, band_min, B, LA, LB, W,
                              match, mismatch, gap, dirs, best, bi, bd, s);
  return (int)launch_fwd<16>(a, b, a_len, b_len, band_min, B, LA, LB, W,
                             match, mismatch, gap, dirs, best, bi, bd, s);
}
