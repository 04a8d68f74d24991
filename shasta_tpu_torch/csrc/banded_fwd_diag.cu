// The anti-diagonal body of the forward DP of banded marker alignment,
// for NVIDIA Hopper (sm_90a), with P = 1, 2 or 4 pairs per warp:
// banded_fwd (P = 1, bands of W <= 4096 lanes; banded_fwd gives it
// W <= DIAG_MAX_W = 4096 where W <= 2 LA: fwd_body, ops/align_kernel.py)
// and banded_fwd_waves (P = 2 or 4, the same region up to W 2048).
//
// Replaces the forward half of the Pallas kernels of
// shasta_tpu/ops/align_pallas.py: _kernel (:156-294) and
// _fwd_chunked_kernel (:581) at P = 1, _kernel_waves (:340) at P = 2
// and 4. It computes exactly what the row-scan body (banded_align.cu)
// and banded_fwd_plain compute: the packed dirs, best, bi and bd.
//
// What bounds it. Each row of a pair's band depends on the row before it
// and, through the LEFT gap, on the lanes before it in the same row. The
// row-scan body resolves that with a warp shuffle scan per row; on an
// H100 its row is one chain of dependent latencies (the a and b loads,
// the shared-memory read of the previous row, six dependent shuffles,
// the barrier), about 1,740 cycles at W = 128, and the warp has nothing
// to overlap it with. The work itself is ~13 int32 operations per band
// cell (FWD_INT_OPS_PER_CELL), a DPX add-and-max counted as one
// (operations, not bytes: 2 bits of dirs are written per cell).
//
// What the design does about it. With linear gaps the row's prefix max
// is the recurrence U[d] = max(base[d], U[d-1] + gap), floored at
// NEG_INF + d * gap as the scan's NEG_INF identity floors it. Cell (i, d)
// then depends on (i-1, d), (i-1, d+1) and (i, d-1), all on an earlier
// step of s = 2i + d, so the cells of one step are independent. One
// block runs P pairs; thread t owns K contiguous lanes (K = 2 up to 64
// lanes, else 4) of each and at each step computes its K/2 lanes of the
// step's parity. A pair of steps (2q, 2q+1) moves every lane one row
// down: lane pair h of thread t (lanes tK + 2h, tK + 2h + 1) is on row
// q - t*K/2 - h. The only traffic between threads is one value per step
// and pair: on the even step the left neighbour's unmasked U of lane
// tK - 1, on the odd step the right neighbour's V of lane tK + K. Inside
// a warp that is a shuffle; a band wider than 128 lanes takes W / 128
// warps, which pass their edge values through shared memory with two
// barriers per pair of steps, and each warp skips its cells at the steps
// where none of its lanes is on a row. No scan and, up to 128 lanes, no
// shared memory or barrier. The stored V is masked to NEG_INF outside
// 0 <= j <= b_len; the carried U is not (the scan takes base from every
// lane). The inputs are off the chain: lane pair h's a[i-1] and b[j-1]
// slide by one lane pair per pair of steps, so they move between
// registers and neighbour threads by shuffles, and enter at each warp's
// two ends from a 16-element chunk of a and of b that is loaded two
// chunks (32 pair steps) ahead. Every cell is computed branch-free and
// committed by selects: the row-scan body's per-lane branches put each
// lane's loads in a divergent region of its own and paid their latencies
// one after the other. Each lane packs 16 rows of 2-bit codes into a
// register; a lane pair stores its two words when its row reaches a
// multiple of 16 or the pair's last row. The best end needs no per-cell
// accumulator: a lane has one cell on the last column (j == b_len), kept
// when it is computed, and its cell on the last row is its final V;
// taken in that order with the reference's strict comparison, they give
// its tie-break, and the fold across lanes is the row-scan body's. No
// tensor cores or TMA: the DP has no matrix product and reads a few ints
// per row.
//
// P pairs per warp (banded_fwd_waves). _kernel_waves interleaves
// sub-slabs so that one slab's chain latency is filled by another's
// independent steps. Here a lane's state is [P][K] and each per-pair
// scalar [P]; each phase of a pair step (the even-step cells, then the
// odd-step cells, then the input slides) is emitted for pair 0, 1, ...
// P-1 in turn, so a warp carries P independent chains in one basic
// block. At P > 1 the 16-row stores of all pairs follow the slides, under
// one branch taken only at a step where some lane pair stores: a store
// branch between two pairs' cells splits the block and serialises their
// chains (slower on the card). P pairs share
// the loop control, the shuffles' index arithmetic and, above 128
// lanes, the two barriers per pair step (the edge values go through
// [P][32] shared arrays), and put P pairs in flight per resident block
// past the 32-blocks-per-SM cap. What bounds it on the H100 is the int32
// issue rate: an SM sub-partition has 16 INT32 lanes, one warp
// instruction every 2 cycles, and one P = 1 warp alone already issues
// about one every 2.5 cycles (chip_smoke.py's pairs-per-SM phase and
// SASS count; PERF.md). So P chains in one
// warp take about P times as long per step, and at the main path's
// launches (B <= 1024) P = 1's blocks spread over more sub-partitions;
// PERF.md has the times. The warp runs to the largest qend among its
// pairs; a pair past its last row commits and stores nothing (its
// cells' act and flush tests are per pair). The last block's slots past
// B read the block's first pair, own no row, and write no output.
// Registers: a thread holds P x K lanes of state, and a block of P pairs
// at most 32 / P warps (launch bounds 1024 / P threads, so 64 P
// registers a thread). P = 4 with 16 warps (W 1025 to 2048) would need
// about 170 registers against the 128 a 512-thread block may have
// (ptxas spilled), and K = 2 with twice the warps would leave 64; so
// waves 4 runs P = 2 there. ptxas reports no spill for any
// instantiation (chip_smoke.py phase 1 fails on one). At P = 1 the body
// compiles to the same pair-step loop as the one-pair kernel it
// generalises (B is the last parameter and the columns j0 are taken once
// per step for that reason: other orders compiled to a slower loop at
// W > 128). The traceback half of _kernel_waves is per pair and equal to
// _kernel's, so banded_tb serves it.
//
// Plain C interface; launched through ctypes on PyTorch's current
// stream. The launch functions return cudaGetLastError().

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

// Grid: one block per P pairs (pairs blockIdx.x * P + s), of
// nw = ceil(W / 32K) warps (MULTI: more than one). Thread t owns lanes
// [t*K, t*K + K) of each pair; lanes past W (phantoms) never commit.
// Across a warp boundary the two neighbour values of each pair go through
// shared memory, with two barriers per pair of steps, and a warp skips
// the cells of the steps at which none of its lanes is on a row of any
// of its pairs.
template <int K, bool MULTI, int P>
__global__ void __launch_bounds__(MULTI ? 1024 / P : 32)
    banded_fwd_diag_kernel(const int* __restrict__ a,
                           const int* __restrict__ b,
                           const int* __restrict__ a_len,
                           const int* __restrict__ b_len,
                           const int* __restrict__ band_min, int LA,
                           int LB, int W, int match, int mismatch, int gap,
                           int* __restrict__ dirs, int* __restrict__ best,
                           int* __restrict__ bi_out,
                           int* __restrict__ bd_out, int B) {
  constexpr int H = K / 2;  // lane pairs per thread
  // Per pair and warp: U of its last lane, V of its first lane; then the
  // folds.
  __shared__ int xu[P][32], xv[P][32], fim[P][32], fbd[P][32];
  const int p0 = blockIdx.x * P;
  const int t = threadIdx.x;
  const int xl = t & 31;  // thread of the warp
  const int wp = t >> 5;  // warp
  const int nw = MULTI ? blockDim.x >> 5 : 1;
  const int d0 = t * K;
  const int nreal = min(max(W - d0, 0), K);  // this thread's lanes < W
  // Per pair slot s: the pair it reads (a slot past B reads the block's
  // first pair and owns no row).
  const int* ap[P];
  const int* bp[P];
  int* dpt[P];
  int alen[P], blen[P], bm[P], rows[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const bool ok = P == 1 || p0 + s < B;
    const int p = ok ? p0 + s : p0;
    ap[s] = a + (size_t)p * LA;
    bp[s] = b + (size_t)p * LB;
    dpt[s] = dirs + (size_t)p * ((LA + 15) >> 4) * W + d0;
    alen[s] = ok ? a_len[p] : 0;
    blen[s] = b_len[p];
    bm[s] = band_min[p];
    rows[s] = alen[s] < LA ? alen[s] : LA;
  }
  int rmax = rows[0];
#pragma unroll
  for (int s = 1; s < P; ++s) rmax = max(rmax, rows[s]);

  // Row 0: V[0][j] = 0 for 0 <= j <= b_len inside the band; phantom
  // lanes stay NEG_INF (lane W - 1's UP neighbour). colv: the lane's V
  // at its one cell with j == b_len (the last-column end).
  int V[P][K], U[P][K], colv[P][K];
  unsigned pk[P][K];
#pragma unroll
  for (int s = 0; s < P; ++s) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = bm[s] + d0 + k;
      V[s][k] = (k < nreal && j >= 0 && j <= blen[s]) ? 0 : kNegInf;
      U[s][k] = kNegInf;
      colv[s][k] = kNegInf;
      pk[s][k] = 0u;
    }
  }

  // Inputs at pair step q: av[h] = a[i - 1] for lane pair h's row
  // i = q - t*H - h; bw[h] = b[j - 1] of its even lane and bw[h + 1] of
  // its odd lane (b[bm + q + t*H + h - 1]). Out of range: -1 and -2.
  int av[P][H], bw[P][H + 1];
#pragma unroll
  for (int s = 0; s < P; ++s) {
#pragma unroll
    for (int h = 0; h < H; ++h) av[s][h] = load_a(ap[s], -t * H - h, LA);
#pragma unroll
    for (int h = 0; h <= H; ++h)
      bw[s][h] = load_b(bp[s], bm[s] + t * H + h, LB);
  }

  // The streams enter at each warp's ends: after pair step q its thread
  // 0 takes a[q - 16K wp] and its thread 31 b[bm + 16K (wp + 1) + q]. A
  // chunk for pair steps [q0, q0 + 16) holds the a values in threads
  // x < 16 and the b values in threads x >= 16.
  auto chunk = [&](int s, int q0) {
    return xl < 16
               ? load_a(ap[s], q0 + xl - 16 * K * wp, LA)
               : load_b(bp[s], bm[s] + 16 * K * (wp + 1) + q0 + xl - 16, LB);
  };
  const int qend = rmax > 0 ? rmax + (W - 1) / 2 : 0;
  // The pair steps at which some lane of this warp is on a row 1..rows
  // of some pair.
  const int q_lo = 16 * K * wp + 1;
  const int q_hi = rmax + 16 * K * (wp + 1) - 1;
  int cur[P], nx1[P], nx2[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    cur[s] = chunk(s, 1);
    nx1[s] = chunk(s, 17);
    nx2[s] = chunk(s, 33);
  }
  for (int q0 = 1; q0 <= qend; q0 += 16) {
    const int n = min(16, qend - q0 + 1);
    for (int r = 0; r < n; ++r) {
      const bool on = !MULTI || (q0 + r >= q_lo && q0 + r <= q_hi);
      const int i0 = q0 + r - t * H;  // row of lane pair 0
      int j0[P];                      // column of lane 0, per pair
#pragma unroll
      for (int s = 0; s < P; ++s) j0[s] = bm[s] + i0 + d0;
      // Even step: lanes 0, 2, ..., K - 2. Lane 0's left neighbour is
      // the previous thread's lane K - 1 (thread 0: the scan's floor).
      if (on) {
#pragma unroll
        for (int s = 0; s < P; ++s) {
          const int uin = __shfl_up_sync(kFull, U[s][K - 1], 1);
          const int lsrc0 = xl != 0 ? uin
                                    : (wp == 0 ? kNegInf - gap
                                               : xu[s][MULTI ? wp - 1 : 0]);
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int i = i0 - h;
            const bool act =
                (unsigned)(i - 1) < (unsigned)rows[s] && 2 * h < nreal;
            const unsigned w = cell(
                V[s][2 * h], U[s][2 * h], colv[s][2 * h], pk[s][2 * h], act,
                2 * ((i - 1) & 15), j0[s] + h,
                h == 0 ? lsrc0 : U[s][h > 0 ? 2 * h - 1 : 0],
                V[s][2 * h + 1], av[s][h], bw[s][h], blen[s], match,
                mismatch, gap);
            pk[s][2 * h] = act ? w : pk[s][2 * h];
          }
        }
      }
      if (MULTI) {
        if (xl == 0) {
#pragma unroll
          for (int s = 0; s < P; ++s) xv[s][wp] = V[s][0];
        }
        __syncthreads();
      }
      // Odd step: lanes 1, 3, ..., K - 1. Lane K - 1's up neighbour is
      // the next thread's lane 0 (past the last thread: outside the
      // band). Then (P = 1; P > 1 after the slides) each lane pair whose
      // row ends a 16-row group, or is the pair's last row, stores its
      // two words.
      if (on) {
#pragma unroll
        for (int s = 0; s < P; ++s) {
          const int vin = __shfl_down_sync(kFull, V[s][0], 1);
          const int up_last =
              xl != 31 ? vin
                       : (wp == nw - 1 ? kNegInf : xv[s][MULTI ? wp + 1 : 0]);
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int i = i0 - h;
            const bool row_on = (unsigned)(i - 1) < (unsigned)rows[s];
            const bool act = row_on && 2 * h + 1 < nreal;
            const unsigned w = cell(
                V[s][2 * h + 1], U[s][2 * h + 1], colv[s][2 * h + 1],
                pk[s][2 * h + 1], act, 2 * ((i - 1) & 15), j0[s] + h + 1,
                U[s][2 * h],
                h == H - 1 ? up_last : V[s][h < H - 1 ? 2 * h + 2 : 0],
                av[s][h], bw[s][h + 1], blen[s], match, mismatch, gap);
            pk[s][2 * h + 1] = act ? w : pk[s][2 * h + 1];
            if (P == 1) {
              const bool flush = row_on && ((i & 15) == 0 || i == rows[s]);
              int* wq = dpt[s] + ((i - 1) >> 4) * W + 2 * h;
              if (flush && 2 * h < nreal) wq[0] = (int)pk[s][2 * h];
              if (flush && 2 * h + 1 < nreal) wq[1] = (int)pk[s][2 * h + 1];
              pk[s][2 * h] = flush ? 0u : pk[s][2 * h];
              pk[s][2 * h + 1] = flush ? 0u : pk[s][2 * h + 1];
            }
          }
        }
      }
      if (MULTI) {
        if (xl == 31) {
#pragma unroll
          for (int s = 0; s < P; ++s) xu[s][wp] = U[s][K - 1];
        }
        __syncthreads();
      }
      // Slide the inputs by one lane pair for pair step q + 1.
#pragma unroll
      for (int s = 0; s < P; ++s) {
        const int sv = __shfl_sync(kFull, cur[s], xl == 0 ? r : 16 + r);
        const int na = __shfl_up_sync(kFull, av[s][H - 1], 1);
        const int nb = __shfl_down_sync(kFull, bw[s][1], 1);
#pragma unroll
        for (int h = H - 1; h > 0; --h) av[s][h] = av[s][h - 1];
        av[s][0] = xl == 0 ? sv : na;
#pragma unroll
        for (int h = 0; h < H; ++h) bw[s][h] = bw[s][h + 1];
        bw[s][H] = xl == 31 ? sv : nb;
      }
      // P > 1: the stores of every pair, under one branch.
      if (P > 1) {
        bool any = false;
#pragma unroll
        for (int s = 0; s < P; ++s) {
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int i = i0 - h;
            any |= (unsigned)(i - 1) < (unsigned)rows[s] &&
                   ((i & 15) == 0 || i == rows[s]);
          }
        }
        if (on && any) {
#pragma unroll
          for (int s = 0; s < P; ++s) {
#pragma unroll
            for (int h = 0; h < H; ++h) {
              const int i = i0 - h;
              const bool flush = (unsigned)(i - 1) < (unsigned)rows[s] &&
                                 ((i & 15) == 0 || i == rows[s]);
              int* wq = dpt[s] + ((i - 1) >> 4) * W + 2 * h;
              if (flush && 2 * h < nreal) wq[0] = (int)pk[s][2 * h];
              if (flush && 2 * h + 1 < nreal) wq[1] = (int)pk[s][2 * h + 1];
              pk[s][2 * h] = flush ? 0u : pk[s][2 * h];
              pk[s][2 * h + 1] = flush ? 0u : pk[s][2 * h + 1];
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < P; ++s) {
      cur[s] = nx1[s];
      nx1[s] = nx2[s];
      nx2[s] = chunk(s, q0 + 48);
    }
  }

  // Each lane's best end, in the row order of the reference's
  // accumulator (strictly better replaces): its last-column cell, then
  // its cell on the last row (when a_len <= LA). Then the fold:
  // lexicographic (max V, min packed row, min lane).
  int v[P], im[P], bd[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const bool last_row = rows[s] >= 1 && rows[s] == alen[s];
    v[s] = INT_MIN;
    im[s] = INT_MAX;
    bd[s] = INT_MAX;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = d0 + k;
      const bool col = colv[s][k] > kNegInf;
      int cv = col ? colv[s][k] : kNegInf;
      int cim = col ? 2 * (blen[s] - bm[s] - d) : 0;
      const bool row = last_row && V[s][k] > cv;
      cv = row ? V[s][k] : cv;
      cim = row ? 2 * rows[s] + 1 : cim;
      const bool take =
          k < nreal && banded::better(cv, cim, d, v[s], im[s], bd[s]);
      v[s] = take ? cv : v[s];
      im[s] = take ? cim : im[s];
      bd[s] = take ? d : bd[s];
    }
    banded::warp_fold_best(v[s], im[s], bd[s]);
  }
  if (MULTI) {
    if (xl == 0) {
#pragma unroll
      for (int s = 0; s < P; ++s) {
        xu[s][wp] = v[s];
        fim[s][wp] = im[s];
        fbd[s][wp] = bd[s];
      }
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int s = 0; s < P; ++s) {
        for (int o = 1; o < nw; ++o) {
          if (banded::better(xu[s][o], fim[s][o], fbd[s][o], v[s], im[s],
                             bd[s])) {
            v[s] = xu[s][o];
            im[s] = fim[s][o];
            bd[s] = fbd[s][o];
          }
        }
      }
    }
  }
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      if (P == 1 || p0 + s < B) {
        best[p0 + s] = v[s];
        bi_out[p0 + s] = im[s] >> 1;
        bd_out[p0 + s] = bd[s];
      }
    }
  }
}

// Blocks of P pairs: one warp of K = 2 lanes per thread up to 64 lanes,
// else ceil(W / 128) warps of K = 4.
template <int P>
cudaError_t launch(const int* a, const int* b, const int* a_len,
                   const int* b_len, const int* band_min, int B, int LA,
                   int LB, int W, int match, int mismatch, int gap, int* dirs,
                   int* best, int* bi, int* bd, cudaStream_t stream) {
  const int grid = (B + P - 1) / P;
  if (W <= 64) {
    banded_fwd_diag_kernel<2, false, P><<<grid, 32, 0, stream>>>(
        a, b, a_len, b_len, band_min, LA, LB, W, match, mismatch, gap,
        dirs, best, bi, bd, B);
  } else if (W <= 128) {
    banded_fwd_diag_kernel<4, false, P><<<grid, 32, 0, stream>>>(
        a, b, a_len, b_len, band_min, LA, LB, W, match, mismatch, gap,
        dirs, best, bi, bd, B);
  } else {
    banded_fwd_diag_kernel<4, true, P><<<grid, 32 * ((W + 127) / 128), 0,
                                         stream>>>(
        a, b, a_len, b_len, band_min, LA, LB, W, match, mismatch, gap,
        dirs, best, bi, bd, B);
  }
  return cudaGetLastError();
}

}  // namespace

// banded_fwd's anti-diagonal body, one pair per block: W <= 4096.
extern "C" int banded_fwd_diag_launch(const int* a, const int* b,
                                      const int* a_len, const int* b_len,
                                      const int* band_min, int B, int LA,
                                      int LB, int W, int match, int mismatch,
                                      int gap, int* dirs, int* best, int* bi,
                                      int* bd, void* stream) {
  if (B < 1 || LA < 1 || LB < 1 || W < 1 || W > 4096)
    return (int)cudaErrorInvalidValue;
  return (int)launch<1>(a, b, a_len, b_len, band_min, B, LA, LB, W, match,
                        mismatch, gap, dirs, best, bi, bd,
                        (cudaStream_t)stream);
}

// banded_fwd_waves: waves = 2 or 4 pairs per block, W <= 2048. A block
// of P pairs holds at most 32 / P warps (W <= 4096 / P lanes), so that a
// thread may keep its P x K lanes' state in registers: waves 4 runs
// P = 2 where W > 1024.
extern "C" int banded_fwd_waves_launch(const int* a, const int* b,
                                       const int* a_len, const int* b_len,
                                       const int* band_min, int B, int LA,
                                       int LB, int W, int match, int mismatch,
                                       int gap, int waves, int* dirs,
                                       int* best, int* bi, int* bd,
                                       void* stream) {
  if (B < 1 || LA < 1 || LB < 1 || W < 1 || W > 2048 ||
      (waves != 2 && waves != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (waves == 2 || W > 1024)
    return (int)launch<2>(a, b, a_len, b_len, band_min, B, LA, LB, W, match,
                          mismatch, gap, dirs, best, bi, bd, s);
  return (int)launch<4>(a, b, a_len, b_len, band_min, B, LA, LB, W, match,
                        mismatch, gap, dirs, best, bi, bd, s);
}
