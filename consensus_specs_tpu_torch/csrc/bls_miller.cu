// K4: a run of n Miller-loop doubling steps; K5: a run of n Fq12 squarings.
//
// K4 replaces consensus_specs_tpu/ops/bls_jax/pairing.py:119 `_dbl_run` and
// K5 replaces :146 `_sq_run` (ROADMAP B9), XLA programs: a fori_loop with a
// dynamic trip count over batched [K, B, ...] limb tensors, each step a
// few dozen whole-batch limb multiplies.  K4's step, for each of the K
// pairs of an item: T <- 2T on the twist with its tangent line at P
// (pairing._dbl_step), and f <- f^2 * prod_k line_k (tower.fq12_square,
// tower.fq12_mul_line).  K5's step is f <- f^2, the squaring chains of the
// final exponentiation.  The formulas are bls_tower.cuh's, on bls_fq.cuh's
// products (K3's), and the limbs written are the plain versions'
// (pairing._dbl_run_plain, pairing._sq_run_plain) bit for bit.
//
// Layouts (the torch code's): f [B, 6, 2, 16]; X, Y, Z [K, B, 2, 16]; px, py
// [K, B, 16]; int64 limbs, contiguous.
//
// Bound on an H100 SXM: a doubling step costs 47 Fq products a pair (the
// point doubling and its line), 36 for the Fq12 squaring and 54 a pair for
// the line products: 238 products at K = 2, each the 1,025 integer
// multiplies of K3's product (its SASS); a squaring step 36 products.  At
// B = 64, K = 2, n = 32 that is 487,424 products, 0.030 ms at the card's
// 16.7e12 integer multiply-adds a second (64 lanes a clock an SM at
// 1.98 GHz on 132 SMs); the bytes (a few hundred KB) are negligible.  So
// the kernels are bound by operations, and only if the work fills the
// card.
//
// Design, the simple first one: one thread per batch item, the item's
// state (f, and T and P for each pair) in local memory, the n steps and
// the K pairs as loops, every product a call of the one product routine.
// At B = 64 that is 64 threads, two warps, on two of 132 SMs: the kernels
// run at one thread's latency (K4 about 34 ms at n = 32, a thousand times
// its bound), and the state and temporaries live in local memory (ptxas:
// a 15.6 KB stack frame and spills).  A warp per item with limb-parallel
// products, or the lanes of one product spread over a warp, is the lever
// for a later change.
#include <cuda_runtime.h>

#include "bls_tower.cuh"

namespace {

constexpr int kMaxPairs = 4;  // pairing.MAX_PAIRS
constexpr int kFq2Words = 2 * bls::kLimbs;
constexpr int kFq12Words = 6 * kFq2Words;

__global__ void __launch_bounds__(32)
miller_dbl_run_kernel(const long long* __restrict__ f_in,
                      const long long* __restrict__ x_in,
                      const long long* __restrict__ y_in,
                      const long long* __restrict__ z_in,
                      const long long* __restrict__ px_in,
                      const long long* __restrict__ py_in,
                      long long* __restrict__ f_out,
                      long long* __restrict__ x_out,
                      long long* __restrict__ y_out,
                      long long* __restrict__ z_out, int K, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  bls::Fq12 f;
  bls::load_fq12(f, f_in + (long long)b * kFq12Words);
  bls::Fq2 X[kMaxPairs], Y[kMaxPairs], Z[kMaxPairs];
  bls::Fq px[kMaxPairs], py[kMaxPairs];
  for (int k = 0; k < K; ++k) {
    const long long item = (long long)k * B + b;
    bls::load_fq2(X[k], x_in + item * kFq2Words);
    bls::load_fq2(Y[k], y_in + item * kFq2Words);
    bls::load_fq2(Z[k], z_in + item * kFq2Words);
    bls::load_fq(px[k], px_in + item * bls::kLimbs);
    bls::load_fq(py[k], py_in + item * bls::kLimbs);
  }
  for (int step = 0; step < n; ++step) {
    // the pairs' doublings are independent of f, so each pair's line is
    // applied as soon as it is made: the plain version's values, in its
    // order (f squared first, then the lines of pairs 0..K-1)
    f = bls::f12_square(f);
    for (int k = 0; k < K; ++k) {
      const bls::Line line = bls::dbl_step(X[k], Y[k], Z[k], px[k], py[k]);
      f = bls::f12_mul_line(f, line.l0, line.l3, line.l5);
    }
  }
  bls::store_fq12(f_out + (long long)b * kFq12Words, f);
  for (int k = 0; k < K; ++k) {
    const long long item = (long long)k * B + b;
    bls::store_fq2(x_out + item * kFq2Words, X[k]);
    bls::store_fq2(y_out + item * kFq2Words, Y[k]);
    bls::store_fq2(z_out + item * kFq2Words, Z[k]);
  }
}

__global__ void __launch_bounds__(32)
fq12_sq_run_kernel(const long long* __restrict__ acc_in,
                   long long* __restrict__ acc_out, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  bls::Fq12 acc;
  bls::load_fq12(acc, acc_in + (long long)b * kFq12Words);
  for (int step = 0; step < n; ++step) acc = bls::f12_square(acc);
  bls::store_fq12(acc_out + (long long)b * kFq12Words, acc);
}

constexpr int kThreads = 32;

}  // namespace

// Each launcher takes contiguous int64 tensors on the current device,
// launches on `stream` and returns cudaGetLastError() (0 on success); it
// does not synchronise.  1 <= K <= kMaxPairs (the wrapper checks).
extern "C" int miller_dbl_run_launch(const void* f_in, const void* x_in,
                                     const void* y_in, const void* z_in,
                                     const void* px, const void* py,
                                     void* f_out, void* x_out, void* y_out,
                                     void* z_out, int K, int B, int n,
                                     void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > kMaxPairs) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  miller_dbl_run_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)f_in, (const long long*)x_in, (const long long*)y_in,
      (const long long*)z_in, (const long long*)px, (const long long*)py,
      (long long*)f_out, (long long*)x_out, (long long*)y_out,
      (long long*)z_out, K, B, n);
  return (int)cudaGetLastError();
}

extern "C" int fq12_sq_run_launch(const void* acc_in, void* acc_out, int B,
                                  int n, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  fq12_sq_run_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)acc_in, (long long*)acc_out, B, n);
  return (int)cudaGetLastError();
}
