// K1: SHA-256 of N 64-byte merkle parent messages (two child roots each).
//
// Replaces the TPU kernel consensus_specs_tpu/ops/sha256_pallas.py
// (_block64_t_impl :87, body _kernel :64 / _compress_rows :44), which laid
// message words on sublanes and 128 messages on lanes.  Here each thread
// owns one message: it compresses the message block, then the constant
// padding block (0x80, zeros, bit length 512) that every 64-byte message
// shares.  Layout at the boundary is the port's [N, 16] -> [N, 8] big-endian
// uint32 words (row-major), as ops/sha256.py's plain version has it.
//
// Bound on an H100 SXM: per message the kernel moves 96 bytes (64 read,
// 32 written) and does about 2288 32-bit ALU operations: 2 compressions x
// 64 rounds x 14 (Sigma0/Sigma1 as three funnel-shift rotates plus one
// three-way xor each, Ch and Maj as one LOP3 each, four three-input adds),
// 48 x 10 for the message block's schedule, and 16 feed-forward adds.
// At 33.5e12 lane operations a second (the instruction rate behind the card's
// 67 TFLOP/s float32 figure) that is 0.068 ns a message, against 0.029 ns
// for the bytes at 3.35 TB/s: the kernel is bound by operations, about
// 2.4x over the memory time.  Hopper's integer pipe runs at half that instruction
// rate, so the attainable floor sits near twice that bound.
//
// Design for that bound: the 64 rounds are unrolled with the 16-word
// schedule window in registers; the padding block's schedule is the same
// for every message, so K[i] + W_pad[i] is one constant table and that
// compression does no schedule work at all.  Loads and stores are 16-byte
// vectors of each thread's own row.  Coalesced transposed loads and
// several messages a thread come in later changes; the fused multi-level
// tree reduction is K2 (sha256_tree.cu).  The compression itself lives in
// sha256_core.cuh, shared with K2.
#include "sha256_core.cuh"

namespace {

__global__ void __launch_bounds__(128)
sha256_block64_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                      long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = in[i * 4 + q];
    w[4 * q + 0] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  uint32_t st[8];
  init_state(st);
  compress_message(st, w);
  compress_padding(st);
  out[i * 2 + 0] = make_uint4(st[0], st[1], st[2], st[3]);
  out[i * 2 + 1] = make_uint4(st[4], st[5], st[6], st[7]);
}

}  // namespace

// in: [n, 16] uint32, out: [n, 8] uint32, both 16-byte aligned and
// contiguous, on the current device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int sha256_block64_launch(const void* in, void* out, long long n,
                                     void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  sha256_block64_kernel<<<(unsigned int)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, n);
  return (int)cudaGetLastError();
}
