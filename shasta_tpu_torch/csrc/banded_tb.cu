// banded_tb for NVIDIA Hopper (sm_90a): the traceback of banded marker
// alignment over the packed direction codes that banded_fwd writes.
//
// Replaces the traceback halves of the Pallas kernels of
// shasta_tpu/ops/align_pallas.py: _kernel (:296-337), _tb_chunked_kernel
// (:714) and _kernel_waves (:496-536), which walks each pair as _kernel
// does. It computes exactly what banded_tb_plain computes.
//
// What bounds it. The walk is a chain: each row's entry lane is the
// previous row's exit, so one pair's rows resolve one after another. The
// work is small (one dirs word read per walked row, the (B, LA) matches
// written): it is bound by bytes, and by the chain's latency in practice.
// One thread per pair, as before, paid a dependent device-memory load
// per row plus one per LEFT lane it stepped over, and filled 2 of the
// 132 SMs at 256 pairs.
//
// What the design does about it. One warp per pair, four pairs per
// block. For each 16-row group the warp loads the 32-lane chunk of dirs
// words that holds the entry lane (one 128-byte load, reused for up to
// 16 rows), two groups ahead. A row resolves at the greatest lane at or
// below the entry that is the j == 0 terminal or not LEFT. That exit
// depends on nothing but the entry, so the warp tabulates it for every
// entry lane of the chunk at once (thread x: entry lane c0 + x; a vote
// and a shuffle per row), a group ahead of the walk that reads it. The
// walk then takes one shuffle per row, reading the row's exit from the
// thread of its entry lane. The warp resolves row by row only when the
// entry leaves the chunk (UP past its last lane) or every lane down to
// the chunk's first is LEFT. Each thread keeps one row of mj of every
// 32, and the warp stores the 32 rows at once; rows at or past the best
// end are -1, stored coalesced first.
//
// Plain C interface; launched through ctypes on PyTorch's current
// stream. The launch function returns cudaGetLastError().

#include "banded_common.cuh"

namespace {

using banded::kFull;

constexpr int kWarps = 4;  // pairs per block

// The 32-lane chunk [c, c + 32) of dirs word row w (0 past W).
__device__ __forceinline__ unsigned chunk_word(const int* dp, int w, int c,
                                               int W, int x) {
  const int d = c + x;
  return d < W ? (unsigned)__ldg(dp + (size_t)w * W + d) : 0u;
}

// A row's exit for every entry lane of the chunk held, one per thread:
// thread x holds the exit from entry c0 + x, packed as ((e + 1) << 1) | m,
// e the next row's entry (-1: the path ends) and m set when the row's
// cell is a match (its output is then jb + e - 1); kDown when every lane
// c0 .. c0 + x is LEFT and lanes below c0 remain. The row resolves at
// the greatest lane at or below the entry that is the j == 0 terminal or
// not LEFT: each lane packs the exit it would give, one vote finds the
// qualifying lanes, and each thread takes the packed exit of the
// greatest one at or below its own lane.
constexpr unsigned kDown = 0xffffffffu;

__device__ __forceinline__ unsigned row_exits(unsigned words, int r, int c0,
                                              int jb, int W, int x) {
  const int code = (int)((words >> (2 * (r & 15))) & 3u);
  const int d = c0 + x;
  const bool term = jb + d == 0;
  const unsigned q = __ballot_sync(kFull, term || code != 3);
  int e = term ? -1 : (code <= 1 ? d : d + 1);  // DIAG, UP, terminal
  e = e >= W ? -1 : e;
  const unsigned self =
      ((unsigned)(e + 1) << 1) | (unsigned)(!term && code == 0 && jb + d > 0);
  // Lanes c0 .. c0 + x: (2 << 31) - 1 wraps to all 32.
  const unsigned hit = q & ((2u << x) - 1u);
  const unsigned got = __shfl_sync(kFull, self, 31 - __clz(hit));
  return hit ? got : (c0 > 0 ? kDown : 0u);
}

// The exits of the 16 rows of word row w from the chunk at lanes c0.
__device__ __forceinline__ void group_exits(unsigned (&ex)[16], unsigned words,
                                            int w, int c0, int bm, int W,
                                            int x) {
#pragma unroll
  for (int k = 0; k < 16; ++k)
    ex[k] = row_exits(words, 16 * w + k, c0, bm + 16 * w + k + 1, W, x);
}

// Codes: 0 DIAG match, 1 DIAG mismatch, 2 UP, 3 LEFT; the j == 0 cell is
// the terminal (4).
__global__ void __launch_bounds__(32 * kWarps)
    banded_tb_kernel(const int* __restrict__ dirs,
                     const int* __restrict__ bi_in,
                     const int* __restrict__ bd_in,
                     const int* __restrict__ band_min, int B, int LA, int W,
                     int* __restrict__ mj) {
  const int x = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= B) return;  // the whole warp
  const int* dp = dirs + (size_t)p * ((LA + 15) >> 4) * W;
  int* out = mj + (size_t)p * LA;
  const int bi = bi_in[p];
  const int bm = band_min[p];
  int e = bd_in[p];  // entry lane of the current row; -1: path ended

  // Rows of the 32-row blocks above the one that holds row bi - 1.
  const int top = bi > 0 ? (((bi - 1) >> 5) << 5) + 32 : 0;
  for (int r = top + x; r < LA; r += 32) out[r] = -1;
  if (bi == 0) return;

  // ex: the exits of group w's rows from the chunk at lanes tc, loaded
  // as words; pre: group w - 1's chunk at lanes pc, loaded a group
  // ahead.
  int w = (bi - 1) >> 4;
  int tc = e & ~31;
  unsigned words = chunk_word(dp, w, tc, W, x);
  unsigned ex[16];
  group_exits(ex, words, w, tc, bm, W, x);
  int pc = tc;
  unsigned pre = w > 0 ? chunk_word(dp, w - 1, pc, W, x) : 0u;
  int my = -1;  // out[32 * (w >> 1) + x]
  for (; w >= 0; --w) {
    unsigned nex[16];
    int npc = pc;
    unsigned npre = 0u;
    if (e >= 0) {
      if ((e & ~31) != tc) {  // the entry left the tables' chunk
        tc = e & ~31;
        words = chunk_word(dp, w, tc, W, x);
        group_exits(ex, words, w, tc, bm, W, x);
      }
      // The next group's exits from the chunk loaded a group ago, and
      // the load of the group after: neither depends on this group's
      // walk, so their latency hides behind it.
      if (w > 0) group_exits(nex, pre, w - 1, pc, bm, W, x);
      npc = tc;
      npre = w > 1 ? chunk_word(dp, w - 2, npc, W, x) : 0u;
      // The walk: one shuffle per row while the entry stays in the chunk.
      int k = min(15, bi - 1 - 16 * w);  // the next row of the group
      bool fast = true;  // no row of the group has left the table yet
#pragma unroll
      for (int kk = 15; kk >= 0; --kk) {
        const unsigned pe = __shfl_sync(kFull, ex[kk], (e - tc) & 31);
        fast = fast && (kk > k || (e >= 0 && (e & ~31) == tc && pe != kDown));
        if (fast && kk <= k) {  // the same for the whole warp
          const int r = 16 * w + kk;
          e = (int)(pe >> 1) - 1;
          my = x == (r & 31) ? ((pe & 1u) ? bm + r + e : -1) : my;  // jb + e - 1
          k = kk - 1;
        }
      }
      // The rest of the group row by row: the entry left the chunk, or
      // every lane down to the chunk's first is LEFT.
      int c0 = tc;
      for (; k >= 0 && e >= 0; --k) {
        const int r = 16 * w + k;
        const int jb = bm + r + 1;
        if ((e & ~31) != c0) {
          c0 = e & ~31;
          words = chunk_word(dp, w, c0, W, x);
        }
        unsigned pe = __shfl_sync(kFull, row_exits(words, r, c0, jb, W, x), e - c0);
        while (pe == kDown) {  // to the chunk below, all of it <= e
          c0 -= 32;
          words = chunk_word(dp, w, c0, W, x);
          pe = __shfl_sync(kFull, row_exits(words, r, c0, jb, W, x), 31);
        }
        e = (int)(pe >> 1) - 1;
        const int val = (pe & 1u) ? jb + e - 1 : -1;
        my = x == (r & 31) ? val : my;
      }
    }
    if ((w & 1) == 0) {  // the 32-row block [16 w, 16 w + 32) is done
      if (16 * w + x < LA) out[16 * w + x] = my;
      my = -1;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) ex[k] = nex[k];
    tc = pc;
    words = pre;
    pc = npc;
    pre = npre;
  }
}

}  // namespace

extern "C" int banded_tb_launch(const int* dirs, const int* bi, const int* bd,
                                const int* band_min, int B, int LA, int W,
                                int* mj, void* stream) {
  if (B < 1 || LA < 1 || W < 1) return (int)cudaErrorInvalidValue;
  banded_tb_kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, 0,
                     (cudaStream_t)stream>>>(dirs, bi, bd, band_min, B, LA, W,
                                             mj);
  return (int)cudaGetLastError();
}
