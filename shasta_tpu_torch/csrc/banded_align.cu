// banded_fwd's row-scan body, for NVIDIA Hopper (sm_90a).
//
// Replaces the forward half of the Pallas kernels of
// shasta_tpu/ops/align_pallas.py, _kernel (:156-294) and
// _fwd_chunked_kernel (:581), for the launches that the anti-diagonal
// body (banded_fwd_diag.cu) does not take: W > DIAG_MAX_W or
// W > DIAG_W_PER_LA * LA (fwd_body, ops/align_kernel.py). It computes
// exactly what banded_fwd_plain computes: every dirs word of a processed
// row, best, bi and bd. The traceback is banded_tb.cu.
//
// What bounds it. The forward pass is a row-sequential DP: each row
// depends on the previous row (DIAG, UP) and, through the LEFT gap, on
// the cells before it in the same row (a prefix max). An in-matrix cell
// needs ~13 int32 operations (FWD_INT_OPS_PER_CELL) and writes 2 bits.
// These launches have bands wider than the matrix is tall (phase 1 of
// alignment method 3 aligns the downsampled reads over the whole
// matrix, j - i in [-la, lb], centred in a W class up to 4x wider; the
// palindrome pass runs a W 32768 class on reads of a few hundred
// markers), so most of the W lanes of a row lie outside the matrix:
// 15 to 21 % of them were inside on phase-1-like batches. Past the
// cells, the bound is the dirs words: every lane of a processed row
// gets a code, 4 bytes per lane and 16 rows.
//
// What the design does about it.
//
// 1. Only the live lanes are computed. On row i the live columns are
//    lo_i = max(0, i + bm) <= j <= hi_i = min(b_len + 1, i + bm + W - 1):
//    the matrix and one margin column (j = b_len + 1, outside the matrix
//    but with a finite DIAG neighbour). Every other lane of a processed
//    row has both previous-row neighbours at NEG_INF and b padding
//    (-2, never equal to a marker), so its code is fixed by the scores:
//    the dead-lane code, worked out once per launch by code_of() with
//    both neighbours NEG_INF and no match (3, LEFT, at 6/-1/-1). The
//    dead lanes are also left out of the in-row prefix max: those left
//    of the matrix (j < 0) exist only on rows whose band holds j = 0,
//    and that lane's base is >= 0 (the free start) while theirs is
//    NEG_INF plus a score, so the max from j = 0 on is what it was with
//    them; those right of the matrix come after every live lane. So V,
//    the codes and the best end are the reference's, bit for bit.
//
// 2. Lanes are held in j, not in d = j - i - bm. In j the live range of
//    a full-matrix band is the same on every row, [0, b_len + 1], where
//    in d it slides one lane per row and spans la + lb; a pair's columns
//    are a window [max(0, bm), hi_rows] of at most min(LB + 2, LA + W)
//    columns (rows_plan in ops/align_kernel.py sizes the launch by it).
//    A column keeps its b value for the whole pair, DIAG is the left
//    neighbour's previous row and UP the column's own. Each row's codes
//    are packed per column for 16 rows (a j-word), staged in shared
//    memory once per 16 rows, and each d-word of the traceback's layout
//    is gathered from 16 staged j-words (column j1 + r holds row r's
//    bits): the traceback's input is unchanged. A lane whose 16 columns
//    all lie outside the matrix stores the dead word without a gather.
//
// 3. Threads are sized by the window, not by W (rows_plan):
//    - up to 32 x 9 = 288 columns (the phase-1 classes with LB <= 128),
//      one warp per pair and four pairs per block
//      (banded_fwd_rows_warp_kernel<K>, K = 5 or 9 columns a thread,
//      each pair using ceil(window / 32) of them): the row lives in
//      registers, DIAG's neighbour comes through one shuffle, the
//      prefix max is a warp shuffle scan, and no block barrier runs.
//      A warp is one chain of dependent latencies per row, so wider
//      windows take more warps: at 514 columns (LB 512) one warp of 17
//      columns a thread took twice the anti-diagonal body's time on 32
//      pairs (PERF.md, PR 9);
//    - up to 2048 columns, one block per pair (banded_fwd_rows_cluster_
//      kernel<false, KC>) of up to 512 threads of KC = 4 columns;
//    - past that, a thread-block cluster (<true, KC>) of one block per
//      4096 columns, 2 to 8, of KC = 4 or 8 columns a thread, the fewer
//      that hold a block's share, up to 32768 columns: each block keeps
//      its slice of the row, and its staged j-words, in its own shared
//      memory (opting in past 48 KB; 12 bytes a column, 48 KB at 4096
//      columns), and the edge column and the prefix-max carry pass from
//      block to block through distributed shared memory. A chain of KC
//      columns a thread per row bounds a pair that is alone on its SMs,
//      and 8 columns take 126 of the 128 registers a 512-thread block
//      leaves a thread (16 spilled), so a window spreads over more SMs
//      before a thread takes more columns (8 columns a thread was the
//      fastest at 4098 to 24578 columns; 16 and 32 were slower:
//      PERF.md, PR 9).
//    Warps whose columns are all outside the row's live range skip the
//    row's cells, its scan and its carry.
//
// 4. One barrier per row (a cluster barrier in a cluster). Before it,
//    each warp scans its own cells and publishes, by row parity, its
//    total and its last column's previous-row V. The one input a warp
//    cannot have before the barrier is its first column's DIAG
//    neighbour, the previous warp's last column. The previous warp owns
//    that value, so it adds that cell's DIAG term to the total it
//    publishes (where every later warp's carry picks it up), and the
//    warp itself fixes its first cell's base and code after the
//    barrier. The prefix carried into a warp is the max of the earlier
//    warps' totals, read 32 at a time (one per lane, plus one per
//    earlier block of the cluster) and reduced by shuffles. Codes stay
//    packed in registers for 16 rows and are stored once, through the
//    stage; there is no read-modify-write in device memory.
//
// 5. The widest window one cluster holds is 32768 columns (8 blocks, the
//    portable cluster size, x 512 threads x 8 columns). A wider one (LB
//    and LA + W both past 32768) is swept in strips of 32768 columns
//    from left to right, since every input of a cell lies at or left of
//    its column: the strip passes each row's last-column V and prefix
//    max to the next through strip_edges ((B, 2, LA + 1) int32, which
//    the wrapper allocates for such launches only), and a d-word whose
//    16 columns straddle two strips gets the later strip's bits or-ed
//    in.
//
// The best end is folded per thread over its end cells with exactly the
// reference's tie-break (max score, then earliest row, then last column
// before last row, then lowest lane), from (NEG_INF, row 0, lane 0),
// which is also the result of a pair with no end cell.
//
// Plain C interface; launched through ctypes on PyTorch's current
// stream. The launch functions return the launch's error or
// cudaGetLastError().

#include <cooperative_groups.h>

#include "banded_common.cuh"

namespace cg = cooperative_groups;

namespace {

using banded::better;
using banded::kFull;
using banded::kNegInf;

constexpr int kWarpPairs = 4;    // warp tier: pairs (one warp each) per block
constexpr int kThreads = 512;    // block and cluster tiers: most threads a block
constexpr int kMaxCluster = 8;   // portable cluster size

// A cell's 2-bit code: LEFT (3) when its V beats its base, else DIAG with
// (0) or without (1) a match when the base came from DIAG, else UP (2).
__host__ __device__ __forceinline__ unsigned code_of(int V, int base,
                                                     int diag, bool m) {
  return V > base ? 3u : (base == diag ? (m ? 0u : 1u) : 2u);
}

__device__ __forceinline__ int load_b(const int* bp, int j, int LB) {
  return (j >= 1 && j <= LB) ? __ldg(bp + j - 1) : -2;  // b[j - 1]
}

// Writes one 16-row group's d-words (lane d: the code of row 16g + 1 + r
// at column jb + d + r in bits 2r, r < nr) for lanes d0, d0 + step, ...
// below d1. A column outside 0 <= j <= b_len + 1 holds the dead code;
// a live column inside [cs, ce] the bits of its staged j-word (load);
// a live column past ce is a later strip's (left 0 here). rmw: or the
// bits into the word already stored (the lanes that start in the
// previous strip).
template <class Load>
__device__ __forceinline__ void store_group(int* out, int d0, int d1,
                                            int step, int jb, int nr,
                                            int blen, unsigned dead, int cs,
                                            int ce, bool rmw, Load load) {
  const unsigned mask = nr >= 16 ? 0xffffffffu : (1u << (2 * nr)) - 1u;
  const unsigned deadw = (dead * 0x55555555u) & mask;
  for (int d = d0; d < d1; d += step) {
    const int j1 = jb + d;
    unsigned w = deadw;
    if (j1 + nr > 0 && j1 <= blen + 1) {
      w = rmw ? (unsigned)out[d] : 0u;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int j = j1 + r;
        if (r < nr) {
          if (j < 0 || j > blen + 1)
            w |= dead << (2 * r);
          else if (j >= cs && j <= ce)
            w |= load(j) & (3u << (2 * r));
        }
      }
    }
    out[d] = (int)w;
  }
}

// Warp tier: one warp per pair, kWarpPairs pairs per block. Lane t owns
// columns c + t*kk .. c + t*kk + kk - 1 of the pair's window [c, cw1],
// kk = ceil(window / 32) <= K; its row, b values and j-words live in
// registers. Grid: ceil(B / kWarpPairs) blocks of 32 * kWarpPairs.
template <int K>
__global__ void __launch_bounds__(32 * kWarpPairs)
    banded_fwd_rows_warp_kernel(const int* __restrict__ a,
                                const int* __restrict__ b,
                                const int* __restrict__ a_len,
                                const int* __restrict__ b_len,
                                const int* __restrict__ band_min, int LA,
                                int LB, int W, int match, int mismatch,
                                int gap, unsigned dead, int* __restrict__ dirs,
                                int* __restrict__ best,
                                int* __restrict__ bi_out,
                                int* __restrict__ bd_out, int B) {
  __shared__ unsigned stage[kWarpPairs][32 * K];
  const int wp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpPairs + wp;
  if (p >= B) return;  // a whole warp: no barrier below spans warps
  unsigned* st = stage[wp];
  const int* ap = a + (size_t)p * LA;
  const int* bp = b + (size_t)p * LB;
  const int alen = a_len[p];
  const int blen = b_len[p];
  const int bm = band_min[p];
  const int rows = alen < LA ? alen : LA;
  int* dp = dirs + (size_t)p * ((LA + 15) >> 4) * W;
  const int cw0 = max(0, bm);
  const int cw1 = rows > 0 ? min(blen + 1, rows + bm + W - 1) : cw0 - 1;
  const int kk = (max(0, cw1 - cw0 + 1) + 31) >> 5;
  const int col0 = cw0 + lane * kk;

  // Row 0: V[0][j] = 0 for 0 <= j <= b_len inside the band.
  int V[K], bv[K];
  unsigned pk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = col0 + k;
    const bool in = k < kk && j <= cw1;
    V[k] = (in && j >= bm && j - bm < W && j <= blen) ? 0 : kNegInf;
    bv[k] = in ? load_b(bp, j, LB) : -2;
    pk[k] = 0u;
  }
  int v = kNegInf, im = 0, bdv = 0;
  int an = rows > 0 ? __ldg(ap) : 0;
  for (int i = 1; i <= rows; ++i) {
    const int av = an;
    if (i < rows) an = __ldg(ap + i);
    const int r0 = i + bm;  // the column of lane 0
    const int lo = max(0, r0);
    const int hi = min(blen + 1, r0 + W - 1);
    int vlast = V[0];
#pragma unroll
    for (int k = 1; k < K; ++k) vlast = k < kk ? V[k] : vlast;
    int dprev = __shfl_up_sync(kFull, vlast, 1);
    if (lane == 0) dprev = kNegInf;  // column c - 1: outside the window

    // Pass 1: bases and the thread's running prefix max of base - d*gap.
    int base[K], run[K];
    unsigned part = 0u;  // 2 bits a column (K <= 9, KC <= 8)
    int lmax = kNegInf;  // the scan's identity and floor
#pragma unroll
    for (int k = 0; k < K; ++k) {
      base[k] = kNegInf;
      run[k] = kNegInf;
      if (k < kk) {
        const int j = col0 + k;
        const bool m = bv[k] == av;
        const int diag = dprev + (m ? match : mismatch);
        int bs = __viaddmax_s32(V[k], gap, diag);  // max(up + gap, diag)
        bs = j == 0 ? max(bs, 0) : bs;
        base[k] = bs;
        part |= (bs == diag ? (m ? 0u : 1u) : 2u) << (2 * k);
        lmax = (j >= lo && j <= hi) ? max(lmax, bs - (j - r0) * gap) : lmax;
        run[k] = lmax;
        dprev = V[k];
      }
    }
    int x = lmax;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x = max(x, y);
    }
    int excl = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) excl = kNegInf;

    // Pass 2: V and codes; then the end cells: the last column (j ==
    // b_len) on every row, every column on the last row.
    const unsigned sh = 2u * (unsigned)((i - 1) & 15);
    int vcol = kNegInf;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kk) {
        const int j = col0 + k;
        const bool act = j >= lo && j <= hi;
        const int Vn = j <= blen ? max(run[k], excl) + (j - r0) * gap : kNegInf;
        const unsigned code =
            Vn > base[k] ? 3u : (part >> (2 * k)) & 3u;
        pk[k] |= act ? code << sh : 0u;
        V[k] = act ? Vn : V[k];
        vcol = (act && j == blen) ? Vn : vcol;
      }
    }
    if (vcol > kNegInf && better(vcol, 2 * i, blen - r0, v, im, bdv)) {
      v = vcol;
      im = 2 * i;
      bdv = blen - r0;
    }
    if (i == alen) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = col0 + k;
        if (k < kk && j >= lo && j < min(hi + 1, blen) &&
            better(V[k], 2 * i + 1, j - r0, v, im, bdv)) {
          v = V[k];
          im = 2 * i + 1;
          bdv = j - r0;
        }
      }
    }

    if ((i & 15) == 0 || i == rows) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < kk) st[lane * kk + k] = pk[k];
        pk[k] = 0u;
      }
      __syncwarp();
      const int g = (i - 1) >> 4;
      store_group(dp + (size_t)g * W, lane, W, 32, 16 * g + 1 + bm,
                  i - 16 * g, blen, dead, cw0, cw1, false,
                  [&](int j) { return st[j - cw0]; });
      __syncwarp();
    }
  }
  banded::warp_fold_best(v, im, bdv);
  if (lane == 0) {
    best[p] = v;
    bi_out[p] = im >> 1;
    bd_out[p] = bdv;
  }
}

template <bool CLUSTER, class Tp>
__device__ __forceinline__ Tp* at_rank(Tp* ptr, int r) {
  if constexpr (CLUSTER)
    return cg::this_cluster().map_shared_rank(ptr, (unsigned)r);
  else
    return ptr;
}

template <bool CLUSTER>
__device__ __forceinline__ void sync_all() {
  if constexpr (CLUSTER)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Block and cluster tiers: one pair per cluster of C blocks (C = 1: one
// block, CLUSTER false). Block r of the cluster owns columns
// [cs + r*NS, cs + (r+1)*NS) of the strip starting at column cs, NS =
// blockDim.x * KC; thread t of it KC columns from cs + r*NS + t*KC, with
// their b values and 16-row j-words in registers. Shared memory per
// block: the row (in place; the base during a row), the staged j-words
// by group parity (a group is gathered one row after it is staged,
// while the next may already be staging), warp totals and edge values
// by row parity, folds.
template <bool CLUSTER, int KC>
__global__ void __launch_bounds__(kThreads)
    banded_fwd_rows_cluster_kernel(const int* __restrict__ a,
                                   const int* __restrict__ b,
                                   const int* __restrict__ a_len,
                                   const int* __restrict__ b_len,
                                   const int* __restrict__ band_min, int LA,
                                   int LB, int W, int match, int mismatch,
                                   int gap, unsigned dead, int C,
                                   int* strip_edges, int* __restrict__ dirs,
                                   int* __restrict__ best,
                                   int* __restrict__ bi_out,
                                   int* __restrict__ bd_out) {
  extern __shared__ int smem[];
  const int T = blockDim.x;
  const int NS = T * KC;
  int* Vs = smem;
  unsigned* st = (unsigned*)(smem + NS);  // [2][NS] by group parity
  int* tot = smem + 3 * NS;  // [2][32]
  int* edg = tot + 64;       // [2][32]
  int* fold = edg + 64;      // [4][32]

  int rank = 0;
  if constexpr (CLUSTER) rank = (int)cg::this_cluster().block_rank();
  const int p = blockIdx.x / C;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wp = t >> 5;
  const int nw = T >> 5;
  const int gw = rank * nw + wp;  // the warp's place in the strip
  const bool last_warp = rank == C - 1 && wp == nw - 1;
  const int* ap = a + (size_t)p * LA;
  const int* bp = b + (size_t)p * LB;
  const int alen = a_len[p];
  const int blen = b_len[p];
  const int bm = band_min[p];
  const int rows = alen < LA ? alen : LA;
  int* dp = dirs + (size_t)p * ((LA + 15) >> 4) * W;
  int* ve = strip_edges ? strip_edges + (size_t)p * 2 * (LA + 1) : nullptr;
  int* ca = ve ? ve + LA + 1 : nullptr;
  const int cw0 = max(0, bm);
  const int cw1 = rows > 0 ? min(blen + 1, rows + bm + W - 1) : cw0 - 1;
  const int cap = C * NS;
  const int nstrips = max(1, (max(0, cw1 - cw0 + 1) + cap - 1) / cap);
  int* mine = Vs + t * KC;

  int v = kNegInf, im = 0, bdv = 0;
  for (int sp = 0; sp < nstrips; ++sp) {
    const int cs = cw0 + sp * cap;  // the strip's columns: [cs, ce]
    const int ce = min(cw1, cs + cap - 1);
    const bool first_strip = sp == 0;
    const bool last_strip = sp == nstrips - 1;
    const int col0 = cs + rank * NS + t * KC;
    const int wcol0 = cs + rank * NS + wp * 32 * KC;
    const int wcol1 = wcol0 + 32 * KC - 1;

    // Row 0 of the strip's columns, their b values, and the next
    // warp's first column's b (lane 31).
    int bv[KC];
    unsigned pk[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int j = col0 + k;
      mine[k] = (j <= ce && j >= bm && j - bm < W && j <= blen) ? 0 : kNegInf;
      bv[k] = load_b(bp, j, LB);
      pk[k] = 0u;
    }
    const int bnext = load_b(bp, wcol1 + 1, LB);
    int vlast = mine[KC - 1];
    // Row 0's V at column cs - 1, the strip's first DIAG neighbour.
    int vin = (!first_strip && cs - 1 >= bm && cs - 1 - bm < W &&
               cs - 1 <= blen) ? 0 : kNegInf;
    int pend = -1;  // a 16-row group staged, to gather after a barrier
    int an = rows > 0 ? __ldg(ap) : 0;
    sync_all<CLUSTER>();

    // One group's d-words: this block's lanes, those whose first column
    // lies in its slice (the strip's first block also those left of the
    // window, its last block those right of it), then, in a strip after
    // the first, the lanes that start in the previous strip.
    auto gather = [&](int g) {
      const int jb = 16 * g + 1 + bm;
      const int nr = min(16, rows - 16 * g);
      const long long lo_j =
          (first_strip && rank == 0) ? (long long)jb : (long long)cs + rank * NS;
      const long long hi_j = (last_strip && rank == C - 1)
                                 ? (long long)jb + W
                                 : (long long)cs + (long long)(rank + 1) * NS;
      const int d0 = (int)min(max(lo_j - jb, 0ll), (long long)W);
      const int d1 = (int)min(max(hi_j - jb, 0ll), (long long)W);
      auto load = [&](int j) -> unsigned {
        const int s = j - cs;
        const int r = s / NS;
        const int off = (g & 1) * NS + s - r * NS;
        return r == rank ? st[off] : at_rank<CLUSTER>(st, r)[off];
      };
      int* out = dp + (size_t)g * W;
      store_group(out, d0 + t, d1, T, jb, nr, blen, dead, cs, ce, false, load);
      if (!first_strip && rank == 0) {
        const int t0 = (int)min(max((long long)cs - nr + 1 - jb, 0ll), (long long)W);
        const int t1 = (int)min(max((long long)cs - jb, 0ll), (long long)W);
        store_group(out, t0 + t, t1, T, jb, nr, blen, dead, cs, ce, true, load);
      }
    };

    for (int i = 1; i <= rows; ++i) {
      const int par = (i & 1) * 32;
      const int av = an;
      if (i < rows) an = __ldg(ap + i);
      const int r0 = i + bm;
      const int lo = max(max(0, r0), cs);
      const int hi = min(min(blen + 1, r0 + W - 1), ce);
      const bool wact = wcol0 <= hi && wcol1 >= lo;  // uniform in the warp

      // Pass 1. The DIAG neighbour of the warp's first column comes after
      // the barrier (NEG_INF here is below its true value, so the base
      // taken with it is fixed by a max); in a strip after the first,
      // the strip's first column has it from strip_edges.
      int dprev = __shfl_up_sync(kFull, vlast, 1);
      int cin = kNegInf;  // the prefix carried in from the earlier strips
      if (lane == 0) {
        dprev = kNegInf;
        if (gw == 0 && !first_strip) {
          dprev = vin;
          vin = ve[i];
          cin = ca[i];
        }
      }
      int lmax = cin;
      unsigned part = 0u;  // 2 bits a column (K <= 9, KC <= 8)
      if (wact) {
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int j = col0 + k;
          const int vold = mine[k];
          const bool m = bv[k] == av;
          const int diag = dprev + (m ? match : mismatch);
          int bs = __viaddmax_s32(vold, gap, diag);
          bs = j == 0 ? max(bs, 0) : bs;
          part |= (bs == diag ? (m ? 0u : 1u) : 2u) << (2 * k);
          const bool act = j >= lo && j <= hi;
          if (act) mine[k] = bs;
          lmax = act ? max(lmax, bs - (j - r0) * gap) : lmax;
          dprev = vold;
        }
      }
      // The warp's inclusive scan (an idle warp holds NEG_INF but for
      // the strip's carry in its lane 0).
      int x = lmax;
      if (wact) {
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, x, o);
          if (lane >= o) x = max(x, y);
        }
      } else {
        x = max(x, __shfl_sync(kFull, lmax, 0));
      }
      if (lane == 31) {
        // The next warp's first cell's DIAG term, when it is live.
        const int jn = wcol1 + 1;
        const int tn = (jn >= lo && jn <= hi)
                           ? vlast + (bnext == av ? match : mismatch) -
                                 (jn - r0) * gap
                           : kNegInf;
        tot[par + wp] = max(x, tn);
        edg[par + wp] = vlast;
      }
      sync_all<CLUSTER>();

      // The prefix carried in: the totals of every earlier warp (read by
      // the warps that compute cells, and by the strip's last warp when
      // it passes the row's prefix to the next strip).
      const bool edge_out = !last_strip && last_warp;
      int carry = kNegInf;
      if (wact || edge_out) {
        carry = lane < wp ? tot[par + lane] : kNegInf;
        if (CLUSTER && lane < nw) {
          for (int r = 0; r < rank; ++r)
            carry = max(carry, at_rank<CLUSTER>(tot, r)[par + lane]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          carry = max(carry, __shfl_xor_sync(kFull, carry, o));
      }

      // Pass 2.
      if (wact) {
        int excl = __shfl_up_sync(kFull, x, 1);
        if (lane == 0) excl = kNegInf;
        excl = max(excl, carry);
        // The warp's first column: its DIAG neighbour is the previous
        // warp's last column.
        int bs0 = mine[0];
        unsigned pt0 = part & 3u;
        if (lane == 0 && gw > 0) {
          const int vl = wp > 0 ? edg[par + wp - 1]
                                : at_rank<CLUSTER>(edg, rank - 1)[par + nw - 1];
          const bool m = bv[0] == av;
          const int diag = vl + (m ? match : mismatch);
          bs0 = max(bs0, diag);
          pt0 = bs0 == diag ? (m ? 0u : 1u) : 2u;
        }
        int run = max(excl, cin);
        int vcol = kNegInf;  // V at j == b_len, the last-column end
        const unsigned sh = 2u * (unsigned)((i - 1) & 15);
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int j = col0 + k;
          const bool act = j >= lo && j <= hi;
          const int bs = k == 0 ? bs0 : mine[k];
          const unsigned pt = k == 0 ? pt0 : (part >> (2 * k)) & 3u;
          const int d = j - r0;
          run = act ? max(run, bs - d * gap) : run;
          const int Vn = j <= blen ? run + d * gap : kNegInf;
          pk[k] |= act ? (Vn > bs ? 3u : pt) << sh : 0u;
          if (act) mine[k] = Vn;
          vcol = (act && j == blen) ? Vn : vcol;
        }
        if (vcol > kNegInf && better(vcol, 2 * i, blen - r0, v, im, bdv)) {
          v = vcol;
          im = 2 * i;
          bdv = blen - r0;
        }
        if (i == alen) {  // the last row: any cell ends the alignment
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            const int j = col0 + k;
            if (j >= lo && j <= hi && j < blen &&
                better(mine[k], 2 * i + 1, j - r0, v, im, bdv)) {
              v = mine[k];
              im = 2 * i + 1;
              bdv = j - r0;
            }
          }
        }
      }
      vlast = mine[KC - 1];
      if (edge_out && lane == 31) {
        ve[i] = vlast;
        ca[i] = max(carry, x);
      }
      if (pend >= 0) {
        gather(pend);
        pend = -1;
      }
      if ((i & 15) == 0 || i == rows) {
        const int g = (i - 1) >> 4;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          st[(g & 1) * NS + t * KC + k] = pk[k];
          pk[k] = 0u;
        }
        pend = g;
      }
    }
    sync_all<CLUSTER>();
    if (pend >= 0) gather(pend);
    __threadfence();  // this strip's dirs and edges, for the next strip
    sync_all<CLUSTER>();
  }

  banded::warp_fold_best(v, im, bdv);
  if (lane == 0) {
    fold[wp] = v;
    fold[32 + wp] = im;
    fold[64 + wp] = bdv;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < nw; ++w) {
      if (better(fold[w], fold[32 + w], fold[64 + w], v, im, bdv)) {
        v = fold[w];
        im = fold[32 + w];
        bdv = fold[64 + w];
      }
    }
    fold[96] = v;
    fold[97] = im;
    fold[98] = bdv;
  }
  if (CLUSTER) sync_all<CLUSTER>();
  if (rank == 0 && t == 0) {
    for (int r = 1; r < C; ++r) {
      const int* f = at_rank<CLUSTER>(fold, r);
      if (better(f[96], f[97], f[98], v, im, bdv)) {
        v = f[96];
        im = f[97];
        bdv = f[98];
      }
    }
    best[p] = v;
    bi_out[p] = im >> 1;
    bd_out[p] = bdv;
  }
  if (CLUSTER) sync_all<CLUSTER>();  // keep every block's folds until read
}

template <bool CLUSTER, int KC>
cudaError_t launch_cluster(const int* a, const int* b, const int* a_len,
                           const int* b_len, const int* band_min, int B,
                           int LA, int LB, int W, int match, int mismatch,
                           int gap, unsigned dead, int T, int C,
                           int* strip_edges, int* dirs, int* best, int* bi,
                           int* bd, cudaStream_t s) {
  auto kernel = banded_fwd_rows_cluster_kernel<CLUSTER, KC>;
  const size_t smem = (size_t)(3 * T * KC + 64 + 64 + 128) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)C);
  cfg.blockDim = dim3((unsigned)T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, a, b, a_len, b_len, band_min, LA, LB,
                         W, match, mismatch, gap, dead, C, strip_edges, dirs,
                         best, bi, bd);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_warp(const int* a, const int* b, const int* a_len,
                        const int* b_len, const int* band_min, int B, int LA,
                        int LB, int W, int match, int mismatch, int gap,
                        unsigned dead, int* dirs, int* best, int* bi, int* bd,
                        cudaStream_t s) {
  banded_fwd_rows_warp_kernel<K>
      <<<(B + kWarpPairs - 1) / kWarpPairs, 32 * kWarpPairs, 0, s>>>(
          a, b, a_len, b_len, band_min, LA, LB, W, match, mismatch, gap, dead,
          dirs, best, bi, bd, B);
  return cudaGetLastError();
}

}  // namespace

// The row-scan body (banded_fwd where fwd_body does not pick the
// anti-diagonal body), in the shape ops/align_kernel.py:rows_plan gives:
// tier 0 (the warp tier, cols = K = 5 or 9 columns a thread, which must
// hold the widest window, min(LB + 2, LA + W)) or 1 (one block or a
// cluster of `blocks` <= 8 blocks per pair, `threads` <= 512 a block, a
// multiple of 32, cols = KC = 4 or 8 columns a thread).
// strip_edges: (B, 2, LA + 1) int32 where the window passes
// blocks x threads x cols columns, else unused (may be null).
extern "C" int banded_fwd_rows_launch(const int* a, const int* b,
                                      const int* a_len, const int* b_len,
                                      const int* band_min, int B, int LA,
                                      int LB, int W, int match, int mismatch,
                                      int gap, int tier, int cols,
                                      int threads, int blocks,
                                      int* strip_edges, int* dirs, int* best,
                                      int* bi, int* bd, void* stream) {
  if (B < 1 || LA < 1 || LB < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long S =
      LB + 2LL < (long long)LA + W ? LB + 2LL : (long long)LA + W;
  // The dead-lane code: both previous-row neighbours NEG_INF, no match.
  const int diag = kNegInf + mismatch;
  const int up = kNegInf + gap;
  const unsigned dead = code_of(kNegInf, diag > up ? diag : up, diag, false);
  if (tier == 0) {
    if ((cols != 5 && cols != 9) || 32LL * cols < S)
      return (int)cudaErrorInvalidValue;
    if (cols == 5)
      return (int)launch_warp<5>(a, b, a_len, b_len, band_min, B, LA, LB, W,
                                 match, mismatch, gap, dead, dirs, best, bi,
                                 bd, s);
    return (int)launch_warp<9>(a, b, a_len, b_len, band_min, B, LA, LB, W,
                               match, mismatch, gap, dead, dirs, best, bi, bd,
                               s);
  }
  const int T = threads, C = blocks;
  if (tier != 1 || T < 32 || T > kThreads || T % 32 != 0 || C < 1 ||
      C > kMaxCluster ||
      ((long long)C * T * cols < S && strip_edges == nullptr))
    return (int)cudaErrorInvalidValue;
#define ROWS_CLUSTER(CL, KCV)                                                \
  return (int)launch_cluster<CL, KCV>(a, b, a_len, b_len, band_min, B, LA, LB, \
                                      W, match, mismatch, gap, dead, T, C,    \
                                      strip_edges, dirs, best, bi, bd, s)
  if (C == 1) {
    if (cols == 4) ROWS_CLUSTER(false, 4);
    if (cols == 8) ROWS_CLUSTER(false, 8);
  } else {
    if (cols == 4) ROWS_CLUSTER(true, 4);
    if (cols == 8) ROWS_CLUSTER(true, 8);
  }
#undef ROWS_CLUSTER
  return (int)cudaErrorInvalidValue;
}
