// K3: the BLS12-381 Fq Montgomery product a*b*R^-1 mod p of N operand pairs.
//
// Replaces consensus_specs_tpu/ops/bls_jax/limbs.py:145 `mul` (ROADMAP B7),
// an XLA program: a padded outer product gathered into anti-diagonal sums,
// then 16 REDC steps as whole-lane vector ops, on [..., 16] int64 lazy
// limbs.  Here one thread computes one product (bls_fq.cuh, fq_mul_body)
// in the same representation: [N, 16] int64 in, [N, 16] int64 out, 26-bit
// limbs, R = 2^416, output canonical digits with value in (0, 3p).  The
// wrapper (ops/bls/limbs.py) expands broadcast operands to rows first.
//
// Bound on an H100 SXM: per product the kernel moves 384 bytes (two
// 128-byte operands read, one written), and its SASS holds 1,025
// integer multiplies (497 IMAD.WIDE.U32, 528 IMAD: nvcc builds each of
// the 256 signed schoolbook products from an unsigned wide multiply and
// two sign corrections; REDC's 240 are unsigned; 16 make the REDC
// quotients), where the product needs 512 (the 256 schoolbook, the 240
// and the 16).  Hopper's integer multiply-add rate is 64 lanes a clock an
// SM (half the float32 FMA rate), 16.7e12 a second at 1.98 GHz on 132
// SMs, so 2^20 products need 0.032 ms of multiplies (0.064 ms as
// compiled) and 0.120 ms of bytes at 3.35 TB/s: the kernel is bound by
// bytes, because the int64 limb layout carries 16 x 8 bytes where 48
// would do.
//
// Design for that bound: each thread reads its own two rows as eight
// 16-byte loads each and writes its row the same way; the arithmetic is
// straight-line code on registers (two 16-limb operands as 32-bit words,
// 32 64-bit column sums; 124 registers, no spills), no shared memory.  A
// denser boundary layout (12 x 32-bit words), coalesced row loads and
// unsigned operands (a third of the multiplies) come in a later change.
#include <cuda_runtime.h>

#include "bls_fq.cuh"

namespace {

__global__ void __launch_bounds__(128)
fq_mul_kernel(const longlong2* __restrict__ a, const longlong2* __restrict__ b,
              longlong2* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long av[bls::kLimbs], bv[bls::kLimbs], ov[bls::kLimbs];
#pragma unroll
  for (int q = 0; q < bls::kLimbs / 2; ++q) {
    const longlong2 x = a[i * (bls::kLimbs / 2) + q];
    const longlong2 y = b[i * (bls::kLimbs / 2) + q];
    av[2 * q] = x.x;
    av[2 * q + 1] = x.y;
    bv[2 * q] = y.x;
    bv[2 * q + 1] = y.y;
  }
  bls::fq_mul_body(ov, av, bv);
#pragma unroll
  for (int q = 0; q < bls::kLimbs / 2; ++q)
    out[i * (bls::kLimbs / 2) + q] = make_longlong2(ov[2 * q], ov[2 * q + 1]);
}

}  // namespace

// a, b, out: [n, 16] int64, contiguous and 16-byte aligned, on the current
// device.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise.
extern "C" int fq_mul_launch(const void* a, const void* b, void* out,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  fq_mul_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const longlong2*)a, (const longlong2*)b, (longlong2*)out, n);
  return (int)cudaGetLastError();
}
