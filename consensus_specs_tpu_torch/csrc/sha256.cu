// K1: SHA-256 of 64-byte merkle parent messages (two child roots each),
// either N dense rows or a whole merkle wave schedule over a digest pool.
//
// Replaces the TPU kernel consensus_specs_tpu/ops/sha256_pallas.py
// (_block64_t_impl :87, body _kernel :64 / _compress_rows :44), which laid
// message words on sublanes and 128 messages on lanes, and the JAX package's
// wave hasher around it (ops/sha256_jax.py _run_waves :158), which runs a
// tree's every wave as a gather from a digest pool plus that compression in
// one XLA program.  Each thread owns one message: it compresses the message
// block, then the constant padding block (0x80, zeros, bit length 512) that
// every 64-byte message shares.
//
// Bound on an H100 SXM: a message is about 2,288 32-bit integer operations
// (2 compressions x 64 rounds x 14: Sigma0/Sigma1 as three funnel-shift
// rotates plus one three-way xor each, Ch and Maj as one LOP3 each, four
// three-input adds; 48 x 10 for the message block's schedule; 16
// feed-forward adds) and 96 bytes (64 read, 32 written; a wave's message
// adds two 4-byte pool indices).  At 33.5e12 lane operations a second (the
// instruction rate behind the card's 67 TFLOP/s float32 figure, 128 lanes a
// clock on each SM) that is 0.068 ns a message against 0.029 ns for the
// bytes at 3.35 TB/s: K1 is bound by operations.  That rate counts both of
// a sub-partition's 16-lane integer pipes, the ALU pipe (logic, shifts,
// IADD3) and the FMA pipe (IMAD), each of which takes two clocks a warp
// instruction.  Written plainly, ptxas puts 2,036 of a message's SASS
// instructions on the ALU pipe and almost none on the FMA pipe, so the
// kernel could reach at most half the bound; on the SSZ hasher's path it
// also paid one launch, one upload and one synchronising download a tree
// level, and left waves under 256 messages to hashlib on the host.
//
// The design answers each of those:
// (a) Gather from the pool.  A wave schedule is one upload of the known
//     child digests into a [P, 8] word pool and one of the waves' int32
//     left and right pool rows (coalesced loads, one a thread each), then
//     every wave on the card, then one download.  A thread reads its
//     message's two children as two 16-byte loads each and writes its
//     digest into the pool at the wave's output rows, in place, where the
//     next wave gathers it.  The dense [N, 16] entry stays for hash_layer;
//     both run one body, hash_message, with the load step a compile-time
//     policy (DenseRows or GatheredPairs).
// (b) The small tail in one block.  A wave of more than kTailThreads
//     messages is one grid launch; each run of smaller waves (the top of the
//     tree and the one-message waves up a list's zero padding) is one launch
//     of one block that runs its waves in order, with __syncthreads()
//     between them, so that a wave's pool writes are visible to the next
//     wave's reads.  Each of those waves costs its dependency chain, one
//     message hash in one warp (about 2.4 us), not a launch.  Every launch
//     is a programmatic dependent launch: it may start while the wave before
//     it runs, and waits in griddepcontrol.wait until that wave's digests
//     are visible.
// (c) Both integer pipes.  The grid launches hash the message block through
//     AluPipe and the padding block through FmaPipe (sha256_core.cuh): the
//     padding rounds' adds are IMADs by a run-time 1, 1,907 ALU-pipe and
//     505 FMA-pipe SASS instructions a message against 2,036 and 247.  On
//     an H100 80GB HBM3 at 700 W that takes K1 from 0.1377 to 0.1320 ms at
//     2^20 messages (sha256_pipes.py, in turns).  Larger moves measured
//     slower although they balance the two pipes' counts better: the
//     message block's adds too (1,568 and 1,093) 0.1358 ms, the message
//     block's alone 0.1379, IMAD.WIDE rotates 0.151 and 0.178; the SM clock
//     held 1,980 MHz in each.  The tail, bound by its chain and not by
//     issue, keeps AluPipe's IADD3s, the shortest chain (as K2 does).
// On its path, a fresh 400,000-validator state's schedule (3.85 million
// messages in 50 waves: 14 grid launches and one tail of 36 waves), K1 takes
// about 0.68 ms against a bound of 0.263 ms: the waves too small to fill
// the card and the tail's chain, one hash after another, hold it there.
#include "sha256_core.cuh"

namespace {

constexpr int kThreads = 128;      // threads a block of a grid launch
constexpr int kTailThreads = 256;  // the tail's one block, and the most
                                   // messages a wave of the tail may hold

// the pipe policies of the grid launches, which fill the card: the message
// block's compression, and the padding block's (see (c) above)
using K1MessagePipe = AluPipe;
using K1PaddingPipe = FmaPipe;

// Message i is row i of a dense [N, 16] word array.
struct DenseRows {
  const uint4* __restrict__ in;
  __device__ __forceinline__ void operator()(long long i, uint32_t w[16]) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = in[i * 4 + q];
      w[4 * q + 0] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  }
};

// Message i is pool rows left[i] and right[i].  The pool is not read
// through the read-only path: the tail reads rows its own block wrote.
struct GatheredPairs {
  const uint4* pool;
  const int* __restrict__ left;
  const int* __restrict__ right;
  __device__ __forceinline__ void operator()(long long i, uint32_t w[16]) const {
    const long long rows[2] = {left[i], right[i]};
#pragma unroll
    for (int side = 0; side < 2; ++side) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint4 v = pool[rows[side] * 2 + q];
        w[8 * side + 4 * q + 0] = v.x;
        w[8 * side + 4 * q + 1] = v.y;
        w[8 * side + 4 * q + 2] = v.z;
        w[8 * side + 4 * q + 3] = v.w;
      }
    }
  }
};

// The one K1 body: load message i, hash it, write its digest to row i of out.
template <class Load, class MessagePipe, class PaddingPipe>
__device__ __forceinline__ void hash_message(const Load& load, long long i,
                                             uint4* out, const MessagePipe& m,
                                             const PaddingPipe& p) {
  uint32_t w[16];
  load(i, w);
  uint32_t st[8];
  hash64(w, st, m, p);
  out[i * 2 + 0] = make_uint4(st[0], st[1], st[2], st[3]);
  out[i * 2 + 1] = make_uint4(st[4], st[5], st[6], st[7]);
}

__device__ __forceinline__ void wait_for_previous_launch() {
  // the launch before this one (if it was a dependent launch's primary) has
  // finished and its writes are visible; the next launch may start and wait
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
}

// Messages [begin, end), one a thread.
template <class Load>
__global__ void __launch_bounds__(kThreads)
sha256_block64_kernel(Load load, uint4* out, long long begin, long long end,
                      uint32_t one) {
  wait_for_previous_launch();
  const long long i = begin + (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= end) return;
  hash_message(load, i, out, K1MessagePipe(one), K1PaddingPipe(one));
}

// Waves [0, n_waves) of a run, one after another in one block: wave w is
// messages [starts[w], starts[w + 1]).
__global__ void __launch_bounds__(kTailThreads)
sha256_waves_tail_kernel(GatheredPairs load, uint4* out,
                         const int* __restrict__ starts, int n_waves) {
  wait_for_previous_launch();
  for (int w = 0; w < n_waves; ++w) {
    const int end = starts[w + 1];
    for (int i = starts[w] + threadIdx.x; i < end; i += kTailThreads) {
      hash_message(load, i, out, AluPipe(1u), AluPipe(1u));
    }
    __syncthreads();  // this wave's digests are written before the next reads
  }
}

template <class Kernel, class... Args>
int launch(Kernel kernel, unsigned int blocks, int threads, void* stream,
           Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}

unsigned int grid_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Every launcher runs on `stream` on the current device, returns the CUDA
// error of the launch (0 on success) and does not synchronise.  Pointers are
// 16-byte aligned (the int32 index arrays 4-byte aligned) and contiguous.

// in: [n, 16] uint32, out: [n, 8] uint32.
extern "C" int sha256_block64_launch(const void* in, void* out, long long n,
                                     void* stream) {
  if (n <= 0) return 0;
  return launch(sha256_block64_kernel<DenseRows>, grid_for(n), kThreads,
                stream, DenseRows{(const uint4*)in}, (uint4*)out, 0LL, n, 1u);
}

// One wave: messages [begin, end) of a schedule, each hashing pool rows
// left[i] and right[i] into row i of out (out is the pool from its first
// output row on).  Every index is a row the waves before this one filled.
extern "C" int sha256_wave_launch(const void* pool, const void* left,
                                  const void* right, void* out,
                                  long long begin, long long end,
                                  void* stream) {
  if (end <= begin) return 0;
  const GatheredPairs load{(const uint4*)pool, (const int*)left,
                           (const int*)right};
  return launch(sha256_block64_kernel<GatheredPairs>, grid_for(end - begin),
                kThreads, stream, load, (uint4*)out, begin, end, 1u);
}

// A run of n_waves waves in one block: wave w is messages [starts[w],
// starts[w + 1]), indexed as in sha256_wave_launch; starts is on the card.
extern "C" int sha256_waves_tail_launch(const void* pool, const void* left,
                                        const void* right, const void* starts,
                                        int n_waves, void* out, void* stream) {
  if (n_waves <= 0) return 0;
  const GatheredPairs load{(const uint4*)pool, (const int*)left,
                           (const int*)right};
  return launch(sha256_waves_tail_kernel, 1u, kTailThreads, stream, load,
                (uint4*)out, (const int*)starts, n_waves);
}
