// kmer_table for NVIDIA Hopper (sm_90a): the downsampling hash of every
// k-mer id, the table alignMethod 3 selects its downsampled markers by.
//
// Replaces no TPU kernel. The JAX package builds the table on the host
// (shasta_tpu/data/kmers.py: downsampling_hash_table) and so did the port:
// numpy runs the reverse complement and MurmurHash2 as some twenty passes
// over 1 to 2 GiB temporaries at k 14 (2^28 ids), about 20 s of every
// process that aligns with method 3. This kernel computes the same bits
// (data/kmers.py: kmer_downsampling_hash, the plain version the tests hold
// it to): for id x, MurmurHash2 of the 8-byte little-endian key
// x + rc(x) with seed 13477 (reference: src/AssemblerKmers.cpp:182-186).
//
// What bounds it: bytes. It reads nothing and writes 4 bytes an id (1 GiB
// at k 14: 0.32 ms at 3.35 TB/s); its arithmetic, about 40 int32
// operations an id, needs about 0.3 ms of the card's int32 rate at k 14.
//
// What the design does about it. Each thread computes four consecutive
// ids and writes them as one 16-byte store, neighbouring threads on
// neighbouring 16 bytes, in a grid-stride loop over a grid of a few
// blocks an SM. The reverse complement stays in registers: complement,
// __brev reverses the 32 bits, a swap within each 2-bit pair restores
// the bases' bit order, and a shift drops the 16 - k bases that were
// padding. One launch writes the whole table; 4^k is a multiple of 4, so
// every thread's four ids are whole.
//
// Plain C interface; launched through ctypes on PyTorch's current
// stream. The launch function returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSeed = 13477u;
constexpr uint32_t kM = 0x5bd1e995u;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint32_t reverse_complement(uint32_t id, int k) {
  const uint32_t r = __brev(~id);
  const uint32_t s = ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
  return s >> (32 - 2 * k);
}

// One 4-byte block of MurmurHash2.
__device__ __forceinline__ uint32_t murmur_block(uint32_t h, uint32_t w) {
  w *= kM;
  w ^= w >> 24;
  w *= kM;
  return (h * kM) ^ w;
}

__device__ __forceinline__ uint32_t downsampling_hash(uint32_t id, int k) {
  const uint64_t key = (uint64_t)id + reverse_complement(id, k);
  uint32_t h = kSeed ^ 8u;
  h = murmur_block(h, (uint32_t)key);
  h = murmur_block(h, (uint32_t)(key >> 32));
  h ^= h >> 13;
  h *= kM;
  h ^= h >> 15;
  return h;
}

__global__ void __launch_bounds__(kThreads)
    kmer_table_kernel(uint32_t* __restrict__ out, uint64_t groups, int k) {
  const uint64_t stride = (uint64_t)gridDim.x * kThreads;
  uint4* __restrict__ out4 = reinterpret_cast<uint4*>(out);
  for (uint64_t g = (uint64_t)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const uint32_t id = (uint32_t)(4 * g);
    uint4 v;
    v.x = downsampling_hash(id, k);
    v.y = downsampling_hash(id + 1u, k);
    v.z = downsampling_hash(id + 2u, k);
    v.w = downsampling_hash(id + 3u, k);
    out4[g] = v;
  }
}

}  // namespace

// out: the 4^k uint32 of the table of k-mers of length k (1 <= k <= 16),
// 16-byte aligned.
extern "C" int kmer_table_launch(uint32_t* out, int k, void* stream) {
  if (k < 1 || k > 16 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const uint64_t groups = (1ull << (2 * k)) / 4;
  const uint64_t need = (groups + kThreads - 1) / kThreads;
  const uint64_t cap = (uint64_t)(sms > 0 ? sms : 1) * kBlocksPerSm;
  const unsigned blocks = (unsigned)(need < cap ? need : cap);
  kmer_table_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      out, groups, k);
  return (int)cudaGetLastError();
}
