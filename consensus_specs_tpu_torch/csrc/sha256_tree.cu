// K2: merkle root of a packed uint64 list, the whole tree on the card.
//
// Replaces the reference's consensus_specs_tpu/ops/merkle_resident.py
// _reduce_to_root (:44), which packs the LE uint64 halves into big-endian
// chunk words and then hashes one tree level per call of the SHA-256
// compression (the Pallas kernel sha256_pallas.py:87 or its XLA twin
// sha256_jax.py), all inside one XLA program.  Input: 4 * 2^k int64 values
// (raw LE 64-bit patterns), i.e. 2^k 32-byte chunks.  Output: the 8
// big-endian words of the root of that 2^k-chunk subtree; with one chunk
// the root is the chunk itself, unhashed.
//
// Bound on an H100 SXM at the fused epoch update's shape (2^17 chunks,
// 131,071 parent messages over 17 dependent levels): 2,288 32-bit ALU
// operations a message (derivation in sha256.cu) at 33.5e12 lane
// operations a second is 0.00895 ms; the bytes, 4 MiB read once and 32
// written, take 0.00125 ms at 3.35 TB/s.  So operations bound it, and
// Hopper's integer pipe (64 lanes an SM, half the float32 rate) puts the
// attainable throughput near twice that.  The kernel is judged against
// that bound.  What keeps it from the bound is the tree's dependency chain:
// each level needs the one below, and one message is two compressions of
// 64 rounds that run strictly in order on one thread, so from level 4 on
// most SMs idle while a few warps walk the chain.  A model of that chain,
// not a bound: if a warp instruction takes two issue cycles on a
// sub-partition's 16-lane integer pipe however few of its lanes are
// active, a message hashed alone costs about 2 x 2,288 = 4,576 cycles and
// 17 levels about 78,000 cycles, 0.039 ms at 1.98 GHz.  The model was
// chosen after one level in one warp was measured on an H100 80GB HBM3
// (~5,500 cycles, the rest being the level's shared-memory reads and
// barriers); a model of dependent latency (~13.5 cycles a round) predicted
// half that.  Only the first three levels are wide enough to be bound by
// throughput (level 1 alone is half the work, about 9 us with every SM
// busy).
//
// Design for this card:
// 1. Packing happens in the load.  A chunk is 4 LE uint64 values, 32
//    contiguous bytes, and its SHA-256 words are the byte-reversed 32-bit
//    words of the same memory.  Each CTA reads its slice as coalesced
//    16-byte vectors (thread i takes vector i, i + 256, ...) and reverses
//    each word with one __byte_perm on the way into shared memory.  No
//    lo/hi split, stack or conversion tensor exists.
// 2. Each CTA of 256 threads reduces a subtree of up to 512 leaves in
//    shared memory: level 1 hashes the 256 leaf pairs, and each level after
//    halves the active threads, with __syncthreads() between reading a
//    level and overwriting it, down to one root per CTA.  At 2^17 chunks
//    that is 256 CTAs, one wave over 132 SMs.  A pair of 32-byte leaves
//    (16 words) sits in a row of 17 words: thread t reads row t, word j at
//    bank (17t + j) mod 32, distinct across a warp since 17 is odd, so the
//    16 loads of a level never serialise on a bank (an unpadded 16-word row
//    would put a whole warp on two banks).  Writes of the 8-word digests and
//    the staging stores are at most two-way conflicted.
// 3. The tail stays on the card: when more than one CTA was needed, the
//    CTA roots (256 at 2^17 chunks) are reduced by the same kernel, which
//    reads them as big-endian words without the byte reversal; a second
//    pass of one CTA finishes any tree up to 2^18 chunks, a tree of at most
//    512 chunks is one launch.  A last-CTA-done tail (fence plus an atomic
//    counter) would save the second launch's few microseconds but needs a
//    counter that outlives the call and is shared by every stream; the
//    second pass needs only the caller's scratch.  Above 2^18 chunks a
//    third pass runs the same way.
// The compression is sha256_core.cuh, shared with K1 (sha256.cu).
#include "sha256_core.cuh"

namespace {

constexpr int kThreads = 256;               // threads a CTA
constexpr int kLeavesPerCta = 2 * kThreads;  // leaves (32 B each) a CTA reduces
constexpr int kRowWords = 17;               // a leaf pair's row: 16 words + 1 pad

__global__ void __launch_bounds__(kThreads)
tree_reduce_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                   int leaves_per_cta, bool from_u64) {
  __shared__ uint32_t rows[(kLeavesPerCta / 2) * kRowWords];
  const int t = threadIdx.x;
  const uint4* src = in + (long long)blockIdx.x * leaves_per_cta * 2;

  // Stage: 16-byte vector i is quarter (i & 3) of leaf pair (i >> 2).
  for (int i = t; i < leaves_per_cta * 2; i += kThreads) {
    uint4 v = src[i];
    if (from_u64) {
      v.x = __byte_perm(v.x, 0, 0x0123);
      v.y = __byte_perm(v.y, 0, 0x0123);
      v.z = __byte_perm(v.z, 0, 0x0123);
      v.w = __byte_perm(v.w, 0, 0x0123);
    }
    uint32_t* dst = rows + kRowWords * (i >> 2) + 4 * (i & 3);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __syncthreads();

  // Each level: thread t hashes pair t into leaf t of the level above.
  for (int active = leaves_per_cta >> 1; active > 0; active >>= 1) {
    uint32_t st[8];
    if (t < active) {
      uint32_t w[16];
      const uint32_t* row = rows + kRowWords * t;
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = row[j];
      init_state(st);
      compress_message(st, w);
      compress_padding(st);
    }
    __syncthreads();  // every pair of this level is read before any is overwritten
    if (t < active) {
      uint32_t* dst = rows + kRowWords * (t >> 1) + 8 * (t & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = st[j];
    }
    __syncthreads();
  }

  // The subtree's root is leaf 0: words 0..7 of row 0.
  if (t < 2) {
    const uint32_t* r = rows + 4 * t;
    out[(long long)blockIdx.x * 2 + t] = make_uint4(r[0], r[1], r[2], r[3]);
  }
}

}  // namespace

// values: [4 * n_chunks] int64 (raw LE 64-bit patterns), out: [8] uint32,
// scratch: room for `scratch_digests` 32-byte digests, which must hold the
// CTA roots of every pass but the last (the sum over those passes of
// n / 512, n being the pass's leaf count), all 16-byte aligned and
// contiguous on the current device.  n_chunks must be a power of two.
// Launches one pass per 512-fold reduction (one launch up to 512 chunks,
// two up to 2^18, three up to 2^27) on `stream`, stores the number of
// passes it launched in *passes, returns cudaGetLastError() of the first
// launch that fails (0 on success), and does not synchronise.  A pass whose
// roots would not fit in scratch is not launched: the launcher returns
// cudaErrorInvalidValue.
extern "C" int u64_list_root_launch(const void* values, void* scratch,
                                    long long scratch_digests, void* out,
                                    long long n_chunks, void* stream,
                                    int* passes) {
  *passes = 0;
  if (n_chunks <= 0 || (n_chunks & (n_chunks - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const uint4* src = (const uint4*)values;
  uint4* next = (uint4*)scratch;
  long long scratch_left = scratch_digests;
  bool from_u64 = true;
  for (long long n = n_chunks;;) {
    const int per_cta = n < kLeavesPerCta ? (int)n : kLeavesPerCta;
    const long long blocks = n / per_cta;
    if (blocks > 1) {
      if (blocks > scratch_left) return (int)cudaErrorInvalidValue;
      scratch_left -= blocks;
    }
    uint4* dst = blocks == 1 ? (uint4*)out : next;
    tree_reduce_kernel<<<(unsigned int)blocks, kThreads, 0, s>>>(
        src, dst, per_cta, from_u64);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*passes;
    if (blocks == 1) return 0;
    src = dst;
    next = dst + blocks * 2;
    n = blocks;
    from_u64 = false;
  }
}
