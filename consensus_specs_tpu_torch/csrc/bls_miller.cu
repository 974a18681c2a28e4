// K4: a run of n Miller-loop doubling steps; K5: a run of n Fq12 squarings.
//
// K4 replaces consensus_specs_tpu/ops/bls_jax/pairing.py:119 `_dbl_run` and
// K5 replaces :146 `_sq_run` (ROADMAP B9), XLA programs: a fori_loop with a
// dynamic trip count over batched [K, B, ...] limb tensors, each step a
// few dozen whole-batch limb multiplies.  K4's step, for each of the K
// pairs of an item: T <- 2T on the twist with its tangent line at P, and
// f <- f^2 * prod_k line_k, the lines in pair order
// (pairing._dbl_run_step).  K5's step is f <- f^2, the squaring chains of
// the final exponentiation (tower.fq12_square).  The limbs written are the
// plain versions' (pairing._dbl_run_plain, pairing._sq_run_plain) bit for
// bit.
//
// Layouts (the torch code's): f [B, 6, 2, 16]; X, Y, Z [K, B, 2, 16]; px, py
// [K, B, 16]; int64 limbs, contiguous.
//
// Bound on an H100 SXM: a doubling step costs 36 Fq products for the Fq12
// squaring and 101 a pair (47 for the point doubling and its line, 54 for
// the line product): 238 at K = 2; a squaring step 36.  A Montgomery
// product of 16-limb operands needs 512 integer multiplies (16 x 16 for
// a*b, 16 REDC quotients, 16 x 15 for the quotients times p's nonzero
// limbs), each one 26 x 26-bit multiply into a 64-bit sum; K3's
// signed-word body issues 1,025 (its SASS), most of them sign
// corrections.  At B = 64, K = 2, n = 32 that is 487,424 products, 0.015
// ms at the card's 16.7e12 integer multiply-adds a second (64 lanes a
// clock an SM at 1.98 GHz on 132 SMs, each multiply counted one issue);
// the bytes (a few hundred KB) are negligible.  So the kernels are bound
// by operations, and only if the work fills the card.
//
// Design: one thread block an item.  The item's state (f, and X, Y, Z, px,
// py for each pair: 12 + 8K Fq elements) stays in shared memory for the
// whole run, one Fq a slot of 17 words (16 limbs and a pad, so that threads
// reading different slots spread over the banks), beside slots for the
// step's intermediate values and a copy of the step's table.  The table
// (ops/bls/schedule.py, generated into bls_miller_schedule.cuh) is recorded
// from the torch formulas: a step is a fixed list of phases, a phase a set
// of independent operations, one to a thread, and a __syncthreads() ends
// it.  A MUL thread forms its two operands, lazy linear combinations of
// slots with small coefficients, in 32-bit words, runs K3's product body
// (bls_fq.cuh) in registers and writes the canonical result to its slot;
// a RENORM thread forms its combination in 64 bits and carries it.  The
// MULs of a phase take the first warps, so a warp runs one kind.  A K4 step at K = 2 is 12 phases (8 with products, 2 to
// 54 of them), a K5 step 5 (two with 18 products), where one thread an
// item ran 238 and 36 products one after another.  The block has the
// widest phase's threads (64 for K5, 96 for K4 at K <= 3, 128 at K = 4)
// and 13 KB (K5) to 56 KB (K4 at K = 4) of shared memory.
//
// What holds it back (clock64 a phase on an H100): a phase costs about one
// product in one thread, some 4,500 cycles, whatever the number of
// products in it, and a phase of renorms alone 1,600 to 2,600 cycles; a
// warp alone on its scheduler issues the product's dependent chains at
// about three cycles an instruction.  The item's phases depend on each
// other, and at B = 64 the launch holds 64 of the 132 SMs, one block each,
// so the card's multiply rate is out of reach by design.  Measured no
// faster: 16 lanes a product (its REDC waits on a shuffle a limb), the
// product as a loop over a 16-column register window, and unsigned
// schoolbook words (half the multiplies, the same time).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bls_fq.cuh"
#include "bls_miller_schedule.cuh"

namespace {

namespace sc = bls_schedule;

constexpr int kLimbs = bls::kLimbs;
constexpr int kStride = kLimbs + 1;  // words a slot
constexpr int kFSlots = 12;          // f: 6 Fq2 coefficients
constexpr int kPairSlots = 8;        // X, Y, Z (two each), px, py
constexpr int kMaxPairs = sc::kTables - 1;

// sum(coef * slot) over the terms [t0, t1), limb by limb, four terms a
// round with their loads issued together (a padding term reads slot 0
// with coefficient 0).  A MUL's operands take it in the low 32-bit words
// (W = uint32_t: the product reads no more of a limb, and the sums wrap
// exactly), the other operations in 64 bits.
template <typename W>
__device__ __forceinline__ void combine(W* acc, const long long* S,
                                        const int* terms, int t0, int t1) {
  constexpr int kWords = sizeof(long long) / sizeof(W);
  const W* words = reinterpret_cast<const W*>(S);
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) acc[i] = 0;
  for (int t = t0; t < t1; t += 4) {
    int w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = t + j < t1 ? terms[t + j] : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const W* src = words + kWords * (w[j] >> 16) * kStride;
      const W c = (W)(short)(w[j] & 0xFFFF);
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) acc[i] += c * src[kWords * i];
    }
  }
}

__device__ __forceinline__ void store_slot(long long* S, int slot,
                                           const long long* v) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) S[slot * kStride + i] = v[i];
}

// a step table's sizes, and where its copy starts after the slots (in
// 8-byte words, even, so that the ops' 16-byte rows stay aligned)
struct Table {
  int index, n_phases, n_ops, n_terms, slot_words;
};

Table table_of(int t) {
  return {t, sc::kPhases[t], sc::kOps[t], sc::kTerms[t],
          (sc::kNSlots[t] * kStride + 1) / 2 * 2};
}

size_t shared_bytes(const Table& t) {
  return sizeof(long long) * t.slot_words +
         sizeof(int) * (4 * t.n_ops + t.n_terms + 3 * t.n_phases);
}

// n steps of table t on the block's slots, S.  The table is first copied
// into shared memory after the slots, so that every phase reads its
// operations there.
__device__ __forceinline__ void run_steps(long long* S, const Table t, int n) {
  const int* g_phases;
  const int* g_ops;
  const int* g_terms;
  sc::table(t.index, g_phases, g_ops, g_terms);
  int* op_words = reinterpret_cast<int*>(S + t.slot_words);
  int* terms = op_words + 4 * t.n_ops;
  int* phases = terms + t.n_terms;
  for (int i = threadIdx.x; i < 4 * t.n_ops; i += blockDim.x)
    op_words[i] = __ldg(g_ops + i);
  for (int i = threadIdx.x; i < t.n_terms; i += blockDim.x)
    terms[i] = __ldg(g_terms + i);
  for (int i = threadIdx.x; i < 3 * t.n_phases; i += blockDim.x)
    phases[i] = __ldg(g_phases + i);
  __syncthreads();
  const int4* ops = reinterpret_cast<const int4*>(op_words);
  for (int step = 0; step < n; ++step) {
    for (int p = 0; p < t.n_phases; ++p) {
      const int first = phases[3 * p];
      const int n_mul = phases[3 * p + 1];
      const int n_rest = phases[3 * p + 2];
      const int mul_lanes = (n_mul + 31) & ~31;
      for (int i = threadIdx.x; i < mul_lanes + n_rest; i += blockDim.x) {
        long long v[kLimbs];
        if (i < n_mul) {
          const int4 op = ops[first + i];
          uint32_t a[kLimbs], b[kLimbs];
          combine(a, S, terms, op.y, op.z);
          combine(b, S, terms, op.z, op.w);
          bls::fq_mul_words(v, reinterpret_cast<const int32_t*>(a),
                            reinterpret_cast<const int32_t*>(b));
          store_slot(S, op.x, v);
        } else if (i >= mul_lanes) {
          const int4 op = ops[first + n_mul + (i - mul_lanes)];
          combine(v, S, terms, op.y, op.w);
          bls::fq_renorm(v);
          store_slot(S, op.x, v);
        }
      }
      __syncthreads();
    }
  }
}

// word `limb` of state slot `slot` of item b in the torch layouts
__device__ __forceinline__ long long* state_word(
    long long* f, long long* x, long long* y, long long* z, long long* px,
    long long* py, int B, int b, int slot, int limb) {
  if (slot < kFSlots) return f + ((long long)b * kFSlots + slot) * kLimbs + limb;
  const int k = (slot - kFSlots) / kPairSlots;
  const int r = (slot - kFSlots) % kPairSlots;
  const long long item = (long long)k * B + b;
  if (r == 6) return px + item * kLimbs + limb;
  if (r == 7) return py + item * kLimbs + limb;
  long long* t = r < 2 ? x : (r < 4 ? y : z);
  return t + (item * 2 + (r & 1)) * kLimbs + limb;
}

__global__ void __launch_bounds__(sc::kMaxThreads)
miller_dbl_run_kernel(const long long* __restrict__ f_in,
                      const long long* __restrict__ x_in,
                      const long long* __restrict__ y_in,
                      const long long* __restrict__ z_in,
                      const long long* __restrict__ px_in,
                      const long long* __restrict__ py_in,
                      long long* __restrict__ f_out,
                      long long* __restrict__ x_out,
                      long long* __restrict__ y_out,
                      long long* __restrict__ z_out, int K, int B, int n,
                      const Table table) {
  extern __shared__ long long bls_slots[];
  const int b = blockIdx.x;
  const int n_state = kFSlots + kPairSlots * K;
  long long* px = const_cast<long long*>(px_in);
  long long* py = const_cast<long long*>(py_in);
  for (int w = threadIdx.x; w < n_state * kLimbs; w += blockDim.x) {
    const int slot = w / kLimbs, limb = w % kLimbs;
    bls_slots[slot * kStride + limb] = *state_word(
        const_cast<long long*>(f_in), const_cast<long long*>(x_in),
        const_cast<long long*>(y_in), const_cast<long long*>(z_in), px, py,
        B, b, slot, limb);
  }
  __syncthreads();
  run_steps(bls_slots, table, n);
  for (int w = threadIdx.x; w < n_state * kLimbs; w += blockDim.x) {
    const int slot = w / kLimbs, limb = w % kLimbs;
    const int r = (slot - kFSlots) % kPairSlots;
    if (slot >= kFSlots && r >= 6) continue;  // px, py are not outputs
    *state_word(f_out, x_out, y_out, z_out, px, py, B, b, slot, limb) =
        bls_slots[slot * kStride + limb];
  }
}

__global__ void __launch_bounds__(sc::kMaxThreads)
fq12_sq_run_kernel(const long long* __restrict__ acc_in,
                   long long* __restrict__ acc_out, int n,
                   const Table table) {
  extern __shared__ long long bls_slots[];
  const long long base = (long long)blockIdx.x * kFSlots * kLimbs;
  for (int w = threadIdx.x; w < kFSlots * kLimbs; w += blockDim.x)
    bls_slots[(w / kLimbs) * kStride + w % kLimbs] = acc_in[base + w];
  __syncthreads();
  run_steps(bls_slots, table, n);
  for (int w = threadIdx.x; w < kFSlots * kLimbs; w += blockDim.x)
    acc_out[base + w] = bls_slots[(w / kLimbs) * kStride + w % kLimbs];
}

// launches past 48 KB of shared memory must be allowed it first
template <typename Kernel>
int allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Each launcher takes contiguous int64 tensors on the current device,
// launches one block an item on `stream` and returns cudaGetLastError()
// (0 on success); it does not synchronise.  1 <= K <= kMaxPairs (the
// wrapper checks).
extern "C" int miller_dbl_run_launch(const void* f_in, const void* x_in,
                                     const void* y_in, const void* z_in,
                                     const void* px, const void* py,
                                     void* f_out, void* x_out, void* y_out,
                                     void* z_out, int K, int B, int n,
                                     void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > kMaxPairs) return (int)cudaErrorInvalidValue;
  const Table table = table_of(K);
  const int rc = allow_shared(miller_dbl_run_kernel, shared_bytes(table));
  if (rc != 0) return rc;
  miller_dbl_run_kernel<<<B, sc::kThreads[K], shared_bytes(table),
                          (cudaStream_t)stream>>>(
      (const long long*)f_in, (const long long*)x_in, (const long long*)y_in,
      (const long long*)z_in, (const long long*)px, (const long long*)py,
      (long long*)f_out, (long long*)x_out, (long long*)y_out,
      (long long*)z_out, K, B, n, table);
  return (int)cudaGetLastError();
}

extern "C" int fq12_sq_run_launch(const void* acc_in, void* acc_out, int B,
                                  int n, void* stream) {
  if (B <= 0) return 0;
  const Table table = table_of(0);
  fq12_sq_run_kernel<<<B, sc::kThreads[0], shared_bytes(table),
                       (cudaStream_t)stream>>>(
      (const long long*)acc_in, (long long*)acc_out, n, table);
  return (int)cudaGetLastError();
}
