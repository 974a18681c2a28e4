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
// written, take 0.00125 ms at 3.35 TB/s.  So operations bound it.  What
// keeps it from the bound is the tree's dependency chain: each level needs
// the one below, and a message is two compressions of 64 rounds that run
// strictly in order on one thread.  Only levels 1 and 2 are wide enough to
// fill the card (level 1 is half the work); the other 15 hash at most 128
// messages a CTA, one warp or none on each sub-partition.  Such a lone
// level costs what one message hash costs one warp: about the cycles ptxas
// scheduled for it (2.44 us a level against ~2,400 SASS instructions a hash
// on an H100 80GB HBM3 at 700 W).  Adds moved to the FMA pipe as IMAD and
// the schedule computed by a partner warp did not bring a level lower
// (PERF.md has the numbers), so the design keeps the compression and cuts
// what surrounds it:
// 1. The compression is sha256_core.cuh, shared with K1, through its
//    AluPipe: its adds are three-input IADD3s, the fewest instructions a
//    message and the shortest chain.
// 2. Packing happens in the load.  A chunk is 4 LE uint64 values, 32
//    contiguous bytes, and its SHA-256 words are the byte-reversed 32-bit
//    words of the same memory.  Each CTA reads its slice as coalesced
//    16-byte vectors and reverses each word with one __byte_perm on the way
//    into shared memory.
// 3. A CTA of 512 threads reduces a subtree of up to 1,024 leaves, so at
//    2^17 chunks pass 1 is 128 CTAs, one a SM.  While a level has more than
//    32 messages, thread t hashes leaf pair t from shared memory, with
//    __syncthreads() between reading a level and overwriting it.  A pair of
//    32-byte leaves (16 words) sits in a row of 17 words: thread t reads
//    word j at bank (17t + j) mod 32, distinct across a warp since 17 is
//    odd.  The last six levels (32 messages down to one) run in warp 0
//    alone: each digest stays in its lane's registers and reaches the
//    parent's lane by __shfl_sync, with no shared memory and no barrier;
//    the other warps have left.
// 4. The tail stays on the card: when more than one CTA was needed, the CTA
//    roots (128 at 2^17 chunks) are reduced by the same kernel, which reads
//    them as big-endian words without the byte reversal; a second pass of
//    one CTA finishes any tree up to 2^20 chunks, a tree of at most 1,024
//    chunks is one launch, and above 2^20 chunks a third pass runs the
//    same way.  Each pass is launched as a programmatic dependent launch
//    (Hopper): it may start while the pass before it runs, and waits in
//    griddepcontrol.wait until that pass has finished and its roots are
//    visible, so the second launch's latency overlaps the first pass.  One
//    launch with a grid-wide barrier would need every CTA co-resident, and
//    a last-CTA-done tail a counter that outlives the call; the passes need
//    only the caller's scratch.
#include "sha256_core.cuh"

namespace {

constexpr int kThreads = 512;               // threads a CTA
constexpr int kLeavesPerCta = 2 * kThreads;  // leaves (32 B each) a CTA reduces
constexpr int kRowWords = 17;               // a leaf pair's row: 16 words + 1 pad
constexpr int kWarp = 32;

__global__ void __launch_bounds__(kThreads, 1)
tree_reduce_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                   int leaves_per_cta, bool from_u64) {
  // the pass before this one (if any) has finished and its roots are
  // visible; the next pass may launch and wait in turn
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ uint32_t rows[(kLeavesPerCta / 2) * kRowWords];
  const int t = threadIdx.x;
  const uint4* src = in + (long long)blockIdx.x * leaves_per_cta * 2;
  uint4* dst = out + (long long)blockIdx.x * 2;

  // Stage: 16-byte vector i is quarter (i & 3) of leaf pair (i >> 2).
  for (int i = t; i < leaves_per_cta * 2; i += kThreads) {
    uint4 v = src[i];
    if (from_u64) {
      v.x = __byte_perm(v.x, 0, 0x0123);
      v.y = __byte_perm(v.y, 0, 0x0123);
      v.z = __byte_perm(v.z, 0, 0x0123);
      v.w = __byte_perm(v.w, 0, 0x0123);
    }
    uint32_t* row = rows + kRowWords * (i >> 2) + 4 * (i & 3);
    row[0] = v.x;
    row[1] = v.y;
    row[2] = v.z;
    row[3] = v.w;
  }
  __syncthreads();
  if (leaves_per_cta == 1) {  // a one-chunk tree is its own root
    if (t < 2) dst[t] = make_uint4(rows[4 * t], rows[4 * t + 1],
                                   rows[4 * t + 2], rows[4 * t + 3]);
    return;
  }

  uint32_t st[8];
  bool in_rows = true;  // this level's pairs are in shared memory
#pragma unroll 1
  for (int active = leaves_per_cta >> 1; active > 0; active >>= 1) {
    // In warp 0's levels every lane hashes, so the warp never diverges;
    // lanes at or past `active` hash garbage that nothing reads.
    const bool busy = t < (active > kWarp ? active : kWarp);
    uint32_t w[16];
    if (in_rows) {
      if (busy) {
        const uint32_t* row = rows + kRowWords * t;
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = row[j];
      }
    } else {
      // lane t's pair is the digests of lanes 2t and 2t + 1
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        w[j] = __shfl_sync(0xffffffffu, st[j], 2 * t);
        w[8 + j] = __shfl_sync(0xffffffffu, st[j], 2 * t + 1);
      }
    }
    if (busy) {
      init_state(st);
      compress_message(st, w, AluPipe(1u));
      compress_padding(st, AluPipe(1u));
    }
    if (active > kWarp) {
      __syncthreads();  // every pair of this level is read before any is overwritten
      if (t < active) {
        uint32_t* row = rows + kRowWords * (t >> 1) + 8 * (t & 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) row[j] = st[j];
      }
      __syncthreads();
    } else {
      if (t >= kWarp) return;
      in_rows = false;
    }
  }

  // The subtree's root is lane 0's digest.
  if (t == 0) {
    dst[0] = make_uint4(st[0], st[1], st[2], st[3]);
    dst[1] = make_uint4(st[4], st[5], st[6], st[7]);
  }
}

}  // namespace

// values: [4 * n_chunks] int64 (raw LE 64-bit patterns), out: [8] uint32,
// scratch: room for `scratch_digests` 32-byte digests, which must hold the
// CTA roots of every pass but the last (the sum over those passes of
// n / 1024, n being the pass's leaf count), all 16-byte aligned and
// contiguous on the current device.  n_chunks must be a power of two.
// Launches one pass per 1024-fold reduction (one launch up to 1,024 chunks,
// two up to 2^20, three up to 2^30) on `stream`, stores the number of
// passes it launched in *passes, returns the error of the first launch that
// fails (0 on success), and does not synchronise.  A pass whose roots would
// not fit in scratch is not launched: the launcher returns
// cudaErrorInvalidValue.
extern "C" int u64_list_root_launch(const void* values, void* scratch,
                                    long long scratch_digests, void* out,
                                    long long n_chunks, void* stream,
                                    int* passes) {
  *passes = 0;
  if (n_chunks <= 0 || (n_chunks & (n_chunks - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
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
    cfg.gridDim = dim3((unsigned int)blocks);
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, tree_reduce_kernel, src, dst, per_cta, from_u64);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the caller raises
      return (int)err;
    }
    ++*passes;
    if (blocks == 1) return 0;
    src = dst;
    next = dst + blocks * 2;
    n = blocks;
    from_u64 = false;
  }
}
