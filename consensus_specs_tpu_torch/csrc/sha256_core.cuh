// SHA-256 compression shared by the merkle kernels: K1 (sha256.cu) and
// K2 (sha256_tree.cu).  Both hash 64-byte merkle parents: one message-block
// compression, then the constant padding block (0x80, zeros, bit length
// 512), whose schedule plus K is the constant table kKPad.  The round is
// written once over a pipe policy (below): K2 and K1's tail take AluPipe,
// K1's grid launches AluPipe for the message block and FmaPipe for the
// padding block.  The constants
// sit in an anonymous namespace, so each source that includes this header
// holds its own copy and the two link into one library without clashing.
#pragma once

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

// -- the integer pipes --------------------------------------------------------
//
// Hopper issues one warp instruction a clock on each SM sub-partition.  Logic
// operations, shifts and IADD3 run on its 16-lane ALU pipe, IMAD on its
// 16-lane FMA pipe, and each takes two clocks a warp instruction, so a stream
// that sends everything to one pipe issues at half the rate the two reach
// together.  A compression round's ten logic operations (six funnel-shift
// rotates, the xors of Sigma0 and Sigma1, Ch and Maj, one LOP3 each) run only
// on the ALU pipe; its adds may run on either.  The compression is written
// once, over a pipe policy that supplies the adds and the sigmas:
//
// AluPipe: plain C++ adds, which ptxas sums three terms at a time in IADD3s
//   on the ALU pipe: the fewest instructions and the shortest dependent chain
//   (about 2,400 SASS instructions a message, 2,034 of them on the ALU pipe).
//   For hashes that wait on each other: K2's tree levels, K1's one-block tail.
// FmaPipe: every add one IMAD by a run-time 1 (a kernel argument, written as
//   PTX, so that neither compiler folds it back into an IADD3) and the
//   schedule's two plain right shifts as the high word of a multiply by
//   2^(32 - n) (IMAD.HI).  More instructions and a longer chain, but fewer
//   on the ALU pipe, which bounds a card full of warps: K1's grid launches
//   hash the padding block through it (sha256.cu gives the measurements).

struct AluPipe {
  __device__ explicit AluPipe(uint32_t) {}
  __device__ __forceinline__ uint32_t add(uint32_t x, uint32_t y) const {
    return x + y;
  }
  __device__ __forceinline__ uint32_t big_sigma0(uint32_t a) const {
    return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  }
  __device__ __forceinline__ uint32_t big_sigma1(uint32_t e) const {
    return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  }
  __device__ __forceinline__ uint32_t small_sigma0(uint32_t x) const {
    return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
  }
  __device__ __forceinline__ uint32_t small_sigma1(uint32_t x) const {
    return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10);
  }
};

struct FmaPipe : AluPipe {
  uint32_t one, m29, m22;  // 1, 2^29, 2^22, none of them known to the compiler
  __device__ explicit FmaPipe(uint32_t one_)
      : AluPipe(one_), one(one_), m29(one_ << 29), m22(one_ << 22) {}
  __device__ __forceinline__ uint32_t add(uint32_t x, uint32_t y) const {
    uint32_t r;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(one), "r"(y));
    return r;
  }
  __device__ __forceinline__ uint32_t small_sigma0(uint32_t x) const {
    return rotr(x, 7) ^ rotr(x, 18) ^ __umulhi(x, m29);  // x >> 3
  }
  __device__ __forceinline__ uint32_t small_sigma1(uint32_t x) const {
    return rotr(x, 17) ^ rotr(x, 19) ^ __umulhi(x, m22);  // x >> 10
  }
};

// One round; kw = K[i] + W[i].  Under AluPipe the expressions are the
// standard's, T1 = h + Sigma1(e) + Ch + kw, e' = d + T1, a' = T1 + Sigma0(a)
// + Maj, which ptxas folds into IADD3s.
template <class Pipe>
__device__ __forceinline__ void round_step(uint32_t& a, uint32_t& b, uint32_t& c,
                                           uint32_t& d, uint32_t& e, uint32_t& f,
                                           uint32_t& g, uint32_t& h, uint32_t kw,
                                           const Pipe& p) {
  const uint32_t s1 = p.big_sigma1(e);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t t1 = p.add(p.add(p.add(h, s1), ch), kw);
  const uint32_t s0 = p.big_sigma0(a);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  h = g;
  g = f;
  f = e;
  e = p.add(d, t1);
  d = c;
  c = b;
  b = a;
  a = p.add(p.add(t1, s0), maj);
}

template <class Pipe>
__device__ __forceinline__ void feed_forward(uint32_t st[8], uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d, uint32_t e,
                                             uint32_t f, uint32_t g, uint32_t h,
                                             const Pipe& p) {
  st[0] = p.add(st[0], a); st[1] = p.add(st[1], b);
  st[2] = p.add(st[2], c); st[3] = p.add(st[3], d);
  st[4] = p.add(st[4], e); st[5] = p.add(st[5], f);
  st[6] = p.add(st[6], g); st[7] = p.add(st[7], h);
}

// Compression of the message block: schedule kept as a rolling 16-word
// window in registers (every index is a compile-time constant once the
// loop is unrolled).
template <class Pipe>
__device__ __forceinline__ void compress_message(uint32_t st[8], uint32_t w[16],
                                                 const Pipe& p) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t s0 = p.small_sigma0(w[(i - 15) & 15]);
      const uint32_t s1 = p.small_sigma1(w[(i - 2) & 15]);
      w[i & 15] = p.add(p.add(p.add(w[i & 15], s0), w[(i - 7) & 15]), s1);
    }
    round_step(a, b, c, d, e, f, g, h, p.add(kK[i], w[i & 15]), p);
  }
  feed_forward(st, a, b, c, d, e, f, g, h, p);
}

// Compression of the constant padding block: no schedule work.
template <class Pipe>
__device__ __forceinline__ void compress_padding(uint32_t st[8], const Pipe& p) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    round_step(a, b, c, d, e, f, g, h, kKPad[i], p);
  }
  feed_forward(st, a, b, c, d, e, f, g, h, p);
}

// The initial hash value H0.
__device__ __forceinline__ void init_state(uint32_t st[8]) {
  st[0] = 0x6a09e667u; st[1] = 0xbb67ae85u; st[2] = 0x3c6ef372u;
  st[3] = 0xa54ff53au; st[4] = 0x510e527fu; st[5] = 0x9b05688cu;
  st[6] = 0x1f83d9abu; st[7] = 0x5be0cd19u;
}

// SHA-256 of one 64-byte message (16 big-endian words) into st: the
// message block's compression through pipe m, the padding block's through p.
template <class MessagePipe, class PaddingPipe>
__device__ __forceinline__ void hash64(uint32_t w[16], uint32_t st[8],
                                       const MessagePipe& m,
                                       const PaddingPipe& p) {
  init_state(st);
  compress_message(st, w, m);
  compress_padding(st, p);
}

}  // namespace
