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
// vectors of each thread's own row.  Coalesced transposed loads, several
// messages a thread and a fused multi-level tree reduction come in later
// changes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

// K[i] + W[i] of the padding block's message schedule (mod 2^32).
__constant__ uint32_t kKPad[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u, 0x649b69c1u, 0xf0fe4786u,
    0x0fe1edc6u, 0x240cf254u, 0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u,
    0xfdb1232bu, 0xc7353eb0u, 0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu,
    0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u, 0x007f3e86u, 0x37088980u,
    0xa507ea32u, 0x6fab9537u, 0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u,
    0x6ed41a95u, 0x6d437890u, 0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
    0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void round_step(uint32_t& a, uint32_t& b, uint32_t& c,
                                           uint32_t& d, uint32_t& e, uint32_t& f,
                                           uint32_t& g, uint32_t& h, uint32_t kw) {
  const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t t1 = h + s1 + ch + kw;
  const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  h = g;
  g = f;
  f = e;
  e = d + t1;
  d = c;
  c = b;
  b = a;
  a = t1 + s0 + maj;
}

// Compression of the message block: schedule kept as a rolling 16-word
// window in registers (every index is a compile-time constant once the
// loop is unrolled).
__device__ __forceinline__ void compress_message(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t w15 = w[(i - 15) & 15];
      const uint32_t w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[i & 15] = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
    }
    round_step(a, b, c, d, e, f, g, h, kK[i] + w[i & 15]);
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// Compression of the constant padding block: no schedule work.
__device__ __forceinline__ void compress_padding(uint32_t st[8]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    round_step(a, b, c, d, e, f, g, h, kKPad[i]);
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

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
  uint32_t st[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
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
