// Banded marker alignment (method 3) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of shasta_tpu/ops/align_pallas.py:
//   banded_fwd  <- _kernel (forward half, :156-294) and
//                  _fwd_chunked_kernel (:581)
//   banded_tb   <- _kernel (traceback half, :296-337) and
//                  _tb_chunked_kernel (:714)
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

}  // namespace

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
