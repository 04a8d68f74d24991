// Banded marker alignment (method 3) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of shasta_tpu/ops/align_pallas.py:
//   banded_fwd  <- _kernel (forward half, :156-294) and
//                  _fwd_chunked_kernel (:581)
//   banded_tb   <- _kernel (traceback half, :296-337),
//                  _tb_chunked_kernel (:714) and the traceback half of
//                  _kernel_waves (:496-536)
//   banded_fwd_waves <- _kernel_waves (:340), forward half (see below)
// The TPU needs a monolithic and a chunked regime because of its VMEM
// budget; here one kernel pair serves every LA and every W up to 16384
// (two rows of W ints in shared memory): the packed direction codes
// always stream to device memory. A wider band is refused.
//
// What bounds it. The forward pass is a row-sequential DP: each row of
// a pair's band depends on the previous row (diag/up) and, through the
// LEFT gap, on the lanes before it in the same row. An interior band
// cell needs ~17 int32 operations and writes 2 bits (this body issues
// ~37 as written: per-cell index tests, the j == 0 clamp and the
// end-cell test), so it is bound by integer issue (operations), not by
// device memory: at (LA, W) = (4096, 512) the dirs are 0.5 MB per pair
// against ~36 M needed operations. The row dependency also costs two
// block barriers per row.
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
// pair's a_len are skipped (no cell there is valid). The traceback runs
// one thread per pair and resolves each row at the greatest non-LEFT
// lane at or below the entry lane, reading the j == 0 cell as the
// terminal; it starts at the best-end row, so it touches only the rows
// of the path. No wgmma or TMA: a DP with a data-dependent walk has no
// matrix product to feed them.
//
// banded_fwd_waves <- _kernel_waves (align_pallas.py:340), the forward
// half. It computes what banded_fwd computes (dirs, best, bi, bd), for
// WAVES = 2 or 4 pairs per thread block, W <= 4096 (K = 4 lanes per
// thread). What bounds it is the same: integer issue, the same 17
// operations per interior cell (FWD_INT_OPS_PER_CELL). What the
// interleave is for: a row's longest dependent chain is the warp
// shuffle scan (five dependent shuffles) and the pass over the warp
// totals; with one pair per block, a block with few warps (W = 128 is
// one warp) stalls on each step. Here every step of that chain is issued
// for pair 0, 1, ... WAVES-1 before the next dependent step, so one
// pair's latency is filled by the other pairs' independent work, as the
// TPU kernel interleaves its sub-slabs' prefix-max steps; the block's
// barriers are shared by its pairs. On an H100 this buys nothing: a
// one-warp block is bound by what its warp can issue, not by latency, so
// 2 or 4 pairs in one warp take 2 or 4 times as long (PERF.md), and
// banded_fwd stays the default. Rows run to the largest row count
// among the block's pairs; a pair past its own rows writes and updates
// nothing. The traceback half of _kernel_waves is per pair and equal to
// _kernel's, so banded_tb serves it.
//
// Plain C interface; launched through ctypes on PyTorch's current
// stream. Each launch function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(int v1, int im1, int d1, int v2,
                                       int im2, int d2) {
  return v1 > v2 || (v1 == v2 && (im1 < im2 || (im1 == im2 && d1 < d2)));
}

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

// Traceback. One thread per pair. Codes: 0 DIAG match, 1 DIAG
// mismatch, 2 UP, 3 LEFT; a j == 0 cell is the terminal (4).
__global__ void banded_tb_kernel(const int* __restrict__ dirs,
                                 const int* __restrict__ bi_in,
                                 const int* __restrict__ bd_in,
                                 const int* __restrict__ band_min, int B,
                                 int LA, int W, int* __restrict__ mj) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const int nw16 = (LA + 15) >> 4;
  const int* dp = dirs + (size_t)p * nw16 * W;
  int* out = mj + (size_t)p * LA;
  const int bi = bi_in[p];
  const int bm = band_min[p];
  for (int r = bi; r < LA; ++r) out[r] = -1;  // rows past the best end
  int entry = bd_in[p];
  int jb = bm + bi;  // j of lane 0 in row i
  int i = bi;
  for (; i >= 1 && entry >= 0; --i, --jb) {
    const int* wp = dp + (size_t)((i - 1) >> 4) * W;
    const int sh = 2 * ((i - 1) & 15);
    int d = entry;
    int code = 7;
    for (; d >= 0; --d) {
      if (jb + d == 0) {
        code = 4;
        break;
      }
      const int c = (wp[d] >> sh) & 3;
      if (c != 3) {
        code = c;
        break;
      }
    }
    out[i - 1] = (code == 0 && jb + d > 0) ? jb + d - 1 : -1;
    if (d < 0) {
      entry = -1;
    } else {
      entry = code <= 1 ? d : (code == 2 ? d + 1 : -1);
      if (entry >= W) entry = -1;
    }
  }
  for (; i >= 1; --i) out[i - 1] = -1;
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

extern "C" int banded_fwd_launch(const int* a, const int* b, const int* a_len,
                                 const int* b_len, const int* band_min, int B,
                                 int LA, int LB, int W, int match,
                                 int mismatch, int gap, int* dirs, int* best,
                                 int* bi, int* bd, void* stream) {
  if (B < 1 || LA < 1 || LB < 1 || W < 1 || W > 16384)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (W <= 4096)
    return (int)launch_fwd<4>(a, b, a_len, b_len, band_min, B, LA, LB, W,
                              match, mismatch, gap, dirs, best, bi, bd, s);
  return (int)launch_fwd<16>(a, b, a_len, b_len, band_min, B, LA, LB, W,
                             match, mismatch, gap, dirs, best, bi, bd, s);
}

extern "C" int banded_tb_launch(const int* dirs, const int* bi, const int* bd,
                                const int* band_min, int B, int LA, int W,
                                int* mj, void* stream) {
  if (B < 1 || LA < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  banded_tb_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(dirs, bi, bd, band_min, B, LA, W,
                                             mj);
  return (int)cudaGetLastError();
}
