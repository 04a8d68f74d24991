// banded_fwd's anti-diagonal body for NVIDIA Hopper (sm_90a): the
// forward DP of banded marker alignment for bands of W <= 4096 lanes
// (banded_fwd gives it W <= DIAG_MAX_W = 2048 where W <= 2 LA:
// fwd_body, ops/align_kernel.py).
//
// Replaces the forward half of the Pallas kernels of
// shasta_tpu/ops/align_pallas.py: _kernel (:156-294) and
// _fwd_chunked_kernel (:581). It computes exactly what the row-scan body
// (banded_align.cu) and banded_fwd_plain compute: the packed dirs, best,
// bi and bd.
//
// What bounds it. Each row of a pair's band depends on the row before it
// and, through the LEFT gap, on the lanes before it in the same row. The
// row-scan body resolves that with a warp shuffle scan per row; on an
// H100 its row is one chain of dependent latencies (the a and b loads,
// the shared-memory read of the previous row, six dependent shuffles,
// the barrier), about 1,740 cycles at W = 128, and the warp has nothing
// to overlap it with. The work itself is ~13 int32 operations per band
// cell, a DPX add-and-max counted as one (operations, not bytes: 2 bits
// of dirs are written per cell).
//
// What the design does about it. With linear gaps the row's prefix max
// is the recurrence U[d] = max(base[d], U[d-1] + gap), floored at
// NEG_INF + d * gap as the scan's NEG_INF identity floors it. Cell (i, d)
// then depends on (i-1, d), (i-1, d+1) and (i, d-1), all on an earlier
// step of s = 2i + d, so the cells of one step are independent. One
// block runs one pair; thread t owns K contiguous lanes (K = 2 up to 64
// lanes, else 4) and at each step computes its K/2 lanes of the step's
// parity. A pair of steps (2q, 2q+1) moves every lane one row down: lane
// pair h of thread t (lanes tK + 2h, tK + 2h + 1) is on row
// q - t*K/2 - h. The only traffic between threads is one value per step:
// on the even step the left neighbour's unmasked U of lane tK - 1, on
// the odd step the right neighbour's V of lane tK + K. Inside a warp
// that is a shuffle; a band wider than 128 lanes takes W / 128 warps,
// which pass their edge values through shared memory with two barriers
// per pair of steps, and each warp skips its cells at the steps where
// none of its lanes is on a row. No scan and, up to 128 lanes, no shared
// memory or barrier. The stored V is masked to NEG_INF outside
// 0 <= j <= b_len; the carried U is not (the scan takes base from every
// lane). The inputs are off the chain: lane pair h's a[i-1] and b[j-1]
// slide by one lane pair per pair of steps, so they move between registers and neighbour threads by
// shuffles, and enter at each warp's two ends from a 16-element chunk of
// a and of b that is loaded two chunks (32 pair steps) ahead. Every
// cell is computed branch-free and committed by selects: the row-scan
// body's per-lane branches put each lane's loads in a divergent region
// of its own and paid their latencies one after the other. Each lane
// packs 16 rows of 2-bit codes into a register; a lane pair stores its
// two words when its row reaches a multiple of 16 or the pair's last
// row. The best end needs no per-cell accumulator: a lane has one cell
// on the last column (j == b_len), kept when it is computed, and its cell
// on the last row is its final V; taken in that order with the
// reference's strict comparison, they give its tie-break, and the fold
// across lanes is the row-scan body's. No tensor cores or TMA: the DP
// has no matrix product and reads a few ints per row.
//
// Plain C interface; launched through ctypes on PyTorch's current
// stream. The launch function returns cudaGetLastError().

#include "banded_common.cuh"

namespace {

using banded::kFull;
using banded::kNegInf;

__device__ __forceinline__ int load_a(const int* ap, int idx, int LA) {
  return (idx >= 0 && idx < LA) ? __ldg(ap + idx) : -1;
}

__device__ __forceinline__ int load_b(const int* bp, int idx, int LB) {
  return (idx >= 0 && idx < LB) ? __ldg(bp + idx) : -2;
}

// One band cell (row i, column j): lsrc is the left neighbour's
// unmasked U on row i (NEG_INF - gap at lane 0), up the up neighbour's V
// on row i - 1, Vk this lane's V on row i - 1. Commits V, U and the
// column end (j == b_len) when act; returns the lane's packed word with
// this row's code at bit sh.
__device__ __forceinline__ unsigned cell(int& Vk, int& Uk, int& colk,
                                         unsigned pkk, bool act, int sh,
                                         int j, int lsrc, int up, int av,
                                         int bval, int blen, int match,
                                         int mismatch, int gap) {
  const bool m = bval == av;
  const int diag = Vk + (m ? match : mismatch);
  int base = __viaddmax_s32(up, gap, diag);  // max(up + gap, diag)
  base = j == 0 ? max(base, 0) : base;
  const int u = __viaddmax_s32(lsrc, gap, base);  // max(left + gap, base)
  const int v = (j >= 0 && j <= blen) ? u : kNegInf;
  const unsigned code = v > base ? 3u : (base == diag ? (m ? 0u : 1u) : 2u);
  colk = (act && j == blen) ? v : colk;
  Vk = act ? v : Vk;
  Uk = act ? u : Uk;
  return pkk | (code << sh);
}

// Grid: one block per pair, of nw = ceil(W / 32K) warps (MULTI: more
// than one). Thread t owns lanes [t*K, t*K + K); lanes past W (phantoms)
// never commit. Across a warp boundary the two neighbour values go
// through shared memory, with two barriers per pair of steps, and a warp
// skips the cells of the steps at which none of its lanes is on a row.
template <int K, bool MULTI>
__global__ void __launch_bounds__(MULTI ? 1024 : 32)
    banded_fwd_diag_kernel(const int* __restrict__ a,
                           const int* __restrict__ b,
                           const int* __restrict__ a_len,
                           const int* __restrict__ b_len,
                           const int* __restrict__ band_min, int LA, int LB,
                           int W, int match, int mismatch, int gap,
                           int* __restrict__ dirs, int* __restrict__ best,
                           int* __restrict__ bi_out,
                           int* __restrict__ bd_out) {
  constexpr int H = K / 2;  // lane pairs per thread
  // Per warp: U of its last lane, V of its first lane; then the folds.
  __shared__ int xu[32], xv[32], fim[32], fbd[32];
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int xl = t & 31;  // thread of the warp
  const int wp = t >> 5;  // warp
  const int nw = MULTI ? blockDim.x >> 5 : 1;
  const int* ap = a + (size_t)p * LA;
  const int* bp = b + (size_t)p * LB;
  const int alen = a_len[p];
  const int blen = b_len[p];
  const int bm = band_min[p];
  const int rows = alen < LA ? alen : LA;
  const int d0 = t * K;
  const int nreal = min(max(W - d0, 0), K);  // this thread's lanes < W
  int* dpt = dirs + (size_t)p * ((LA + 15) >> 4) * W + d0;

  // Row 0: V[0][j] = 0 for 0 <= j <= b_len inside the band; phantom
  // lanes stay NEG_INF (lane W - 1's UP neighbour). colv: the lane's V
  // at its one cell with j == b_len (the last-column end).
  int V[K], U[K], colv[K];
  unsigned pk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = bm + d0 + k;
    V[k] = (k < nreal && j >= 0 && j <= blen) ? 0 : kNegInf;
    U[k] = kNegInf;
    colv[k] = kNegInf;
    pk[k] = 0u;
  }

  // Inputs at pair step q: av[h] = a[i - 1] for lane pair h's row
  // i = q - t*H - h; bw[h] = b[j - 1] of its even lane and bw[h + 1] of
  // its odd lane (b[bm + q + t*H + h - 1]). Out of range: -1 and -2.
  int av[H], bw[H + 1];
#pragma unroll
  for (int h = 0; h < H; ++h) av[h] = load_a(ap, -t * H - h, LA);
#pragma unroll
  for (int h = 0; h <= H; ++h) bw[h] = load_b(bp, bm + t * H + h, LB);

  // The streams enter at each warp's ends: after pair step q its thread
  // 0 takes a[q - 16K wp] and its thread 31 b[bm + 16K (wp + 1) + q]. A
  // chunk for pair steps [q0, q0 + 16) holds the a values in threads
  // x < 16 and the b values in threads x >= 16.
  auto chunk = [&](int q0) {
    return xl < 16 ? load_a(ap, q0 + xl - 16 * K * wp, LA)
                   : load_b(bp, bm + 16 * K * (wp + 1) + q0 + xl - 16, LB);
  };
  const int qend = rows > 0 ? rows + (W - 1) / 2 : 0;
  // The pair steps at which some lane of this warp is on a row 1..rows.
  const int q_lo = 16 * K * wp + 1;
  const int q_hi = rows + 16 * K * (wp + 1) - 1;
  int cur = chunk(1), nx1 = chunk(17), nx2 = chunk(33);
  for (int q0 = 1; q0 <= qend; q0 += 16) {
    const int n = min(16, qend - q0 + 1);
    for (int r = 0; r < n; ++r) {
      const bool on = !MULTI || (q0 + r >= q_lo && q0 + r <= q_hi);
      const int i0 = q0 + r - t * H;  // row of lane pair 0
      const int j0 = bm + i0 + d0;    // column of lane 0
      // Even step: lanes 0, 2, ..., K - 2. Lane 0's left neighbour is
      // the previous thread's lane K - 1 (thread 0: the scan's floor).
      if (on) {
        const int uin = __shfl_up_sync(kFull, U[K - 1], 1);
        const int lsrc0 =
            xl != 0 ? uin : (wp == 0 ? kNegInf - gap : xu[MULTI ? wp - 1 : 0]);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int i = i0 - h;
          const bool act = (unsigned)(i - 1) < (unsigned)rows && 2 * h < nreal;
          const unsigned w = cell(
              V[2 * h], U[2 * h], colv[2 * h], pk[2 * h], act,
              2 * ((i - 1) & 15), j0 + h,
              h == 0 ? lsrc0 : U[h > 0 ? 2 * h - 1 : 0], V[2 * h + 1], av[h],
              bw[h], blen, match, mismatch, gap);
          pk[2 * h] = act ? w : pk[2 * h];
        }
      }
      if (MULTI) {
        if (xl == 0) xv[wp] = V[0];
        __syncthreads();
      }
      // Odd step: lanes 1, 3, ..., K - 1. Lane K - 1's up neighbour is
      // the next thread's lane 0 (past the last thread: outside the
      // band). Then each lane pair whose row ends a 16-row group, or is
      // the pair's last row, stores its two words.
      if (on) {
        const int vin = __shfl_down_sync(kFull, V[0], 1);
        const int up_last =
            xl != 31 ? vin : (wp == nw - 1 ? kNegInf : xv[MULTI ? wp + 1 : 0]);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int i = i0 - h;
          const bool row_on = (unsigned)(i - 1) < (unsigned)rows;
          const bool act = row_on && 2 * h + 1 < nreal;
          const unsigned w = cell(
              V[2 * h + 1], U[2 * h + 1], colv[2 * h + 1], pk[2 * h + 1], act,
              2 * ((i - 1) & 15), j0 + h + 1, U[2 * h],
              h == H - 1 ? up_last : V[h < H - 1 ? 2 * h + 2 : 0], av[h],
              bw[h + 1], blen, match, mismatch, gap);
          pk[2 * h + 1] = act ? w : pk[2 * h + 1];
          const bool flush = row_on && ((i & 15) == 0 || i == rows);
          int* wq = dpt + ((i - 1) >> 4) * W + 2 * h;
          if (flush && 2 * h < nreal) wq[0] = (int)pk[2 * h];
          if (flush && 2 * h + 1 < nreal) wq[1] = (int)pk[2 * h + 1];
          pk[2 * h] = flush ? 0u : pk[2 * h];
          pk[2 * h + 1] = flush ? 0u : pk[2 * h + 1];
        }
      }
      if (MULTI) {
        if (xl == 31) xu[wp] = U[K - 1];
        __syncthreads();
      }
      // Slide the inputs by one lane pair for pair step q + 1.
      const int sv = __shfl_sync(kFull, cur, xl == 0 ? r : 16 + r);
      const int na = __shfl_up_sync(kFull, av[H - 1], 1);
      const int nb = __shfl_down_sync(kFull, bw[1], 1);
#pragma unroll
      for (int h = H - 1; h > 0; --h) av[h] = av[h - 1];
      av[0] = xl == 0 ? sv : na;
#pragma unroll
      for (int h = 0; h < H; ++h) bw[h] = bw[h + 1];
      bw[H] = xl == 31 ? sv : nb;
    }
    cur = nx1;
    nx1 = nx2;
    nx2 = chunk(q0 + 48);
  }

  // Each lane's best end, in the row order of the reference's
  // accumulator (strictly better replaces): its last-column cell, then
  // its cell on the last row (when a_len <= LA). Then the fold:
  // lexicographic (max V, min packed row, min lane).
  const bool last_row = rows >= 1 && rows == alen;
  int v = INT_MIN, im = INT_MAX, bd = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + k;
    const bool col = colv[k] > kNegInf;
    int cv = col ? colv[k] : kNegInf;
    int cim = col ? 2 * (blen - bm - d) : 0;
    const bool row = last_row && V[k] > cv;
    cv = row ? V[k] : cv;
    cim = row ? 2 * rows + 1 : cim;
    const bool take = k < nreal && banded::better(cv, cim, d, v, im, bd);
    v = take ? cv : v;
    im = take ? cim : im;
    bd = take ? d : bd;
  }
  banded::warp_fold_best(v, im, bd);
  if (MULTI) {
    if (xl == 0) {
      xu[wp] = v;
      fim[wp] = im;
      fbd[wp] = bd;
    }
    __syncthreads();
    if (t == 0) {
      for (int o = 1; o < nw; ++o) {
        if (banded::better(xu[o], fim[o], fbd[o], v, im, bd)) {
          v = xu[o];
          im = fim[o];
          bd = fbd[o];
        }
      }
    }
  }
  if (t == 0) {
    best[p] = v;
    bi_out[p] = im >> 1;
    bd_out[p] = bd;
  }
}

template <int K, bool MULTI>
cudaError_t launch(const int* a, const int* b, const int* a_len,
                   const int* b_len, const int* band_min, int B, int LA,
                   int LB, int W, int match, int mismatch, int gap, int* dirs,
                   int* best, int* bi, int* bd, cudaStream_t stream) {
  const int warps = (W + 32 * K - 1) / (32 * K);
  banded_fwd_diag_kernel<K, MULTI><<<B, 32 * warps, 0, stream>>>(
      a, b, a_len, b_len, band_min, LA, LB, W, match, mismatch, gap, dirs,
      best, bi, bd);
  return cudaGetLastError();
}

}  // namespace

// W <= 4096: one warp of K = 2 lanes per thread up to 64 lanes, else
// ceil(W / 128) warps of K = 4.
extern "C" int banded_fwd_diag_launch(const int* a, const int* b,
                                      const int* a_len, const int* b_len,
                                      const int* band_min, int B, int LA,
                                      int LB, int W, int match, int mismatch,
                                      int gap, int* dirs, int* best, int* bi,
                                      int* bd, void* stream) {
  if (B < 1 || LA < 1 || LB < 1 || W < 1 || W > 4096)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (W <= 64)
    return (int)launch<2, false>(a, b, a_len, b_len, band_min, B, LA, LB, W,
                                 match, mismatch, gap, dirs, best, bi, bd, s);
  if (W <= 128)
    return (int)launch<4, false>(a, b, a_len, b_len, band_min, B, LA, LB, W,
                                 match, mismatch, gap, dirs, best, bi, bd, s);
  return (int)launch<4, true>(a, b, a_len, b_len, band_min, B, LA, LB, W,
                              match, mismatch, gap, dirs, best, bi, bd, s);
}
