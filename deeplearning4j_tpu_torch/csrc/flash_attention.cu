// Flash attention for the training path: the forward (with the row
// logsumexp L) and the two backward kernels (dQ; dK and dV), on Hopper
// (sm_90a).
//
// Replaces the TPU kernels of deeplearning4j_tpu/ops/pallas_attention.py:
//   flash_fwd_*kernel     <- _flash_fwd_kernel      (glue _flash_forward)
//   flash_bwd_dq_*kernel  <- _flash_bwd_dq_kernel   (glue _flash_mha_bwd)
//   flash_bwd_dkv_*kernel <- _flash_bwd_dkv_kernel  (glue _flash_mha_bwd)
// Same contract: q/k/v (B, T, H, D) in the JAX layout, read through their
// (b, t, h) strides with unit stride along D; O = softmax(Q K^T * scale
// [+ causal mask]) V; L = m + log l as a (B*H, Tq) f32 array; rows with
// l == 0 give O = 0 and L = NEG_INF = -1e30. The backward recomputes
// P = exp(S - L) tile by tile (masked entries exactly 0), with
// dsum = rowsum(dO * O) (B*H, Tq) f32 computed outside the kernels, and
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - dsum),
//   dQ = dS K * scale,  dK = dS^T Q * scale.
// Scores, softmax statistics and every accumulator are f32. In bf16, P and
// dS are rounded to bf16 before their products, as the Pallas kernels do.
//
// Design. The Pallas grid's sequential axis (K/V tiles for the forward and
// dQ, Q tiles for dK/dV) becomes a loop inside one block; the VMEM scratch
// carried across grid steps (m, l, acc) lives on chip. Under the causal
// mask a block visits only the tiles on or below the diagonal (the Pallas
// kernels' _causal_needed_kv skip). Which kernel runs which family:
//  - bf16 D = 128 forward (the training path's): flash_fwd_wgmma_kernel, a
//    warp-specialized Hopper kernel. A producer warp feeds Q and a ring of
//    two 128-key K/V stages by TMA (one 4-D tensor map per input over
//    (D, H, T, B) with the input's own strides, so the fused-qkv slices of
//    the training path are read in place; 128-byte swizzle, mbarriers);
//    two consumer warpgroups of 64 query rows run QK^T and PV on wgmma
//    (P from registers), the softmax in the log2 domain with ex2, and mask
//    only the diagonal tile. Blocks take the query tiles in reverse, so
//    under the causal mask the longest rows start first;
//  - bf16 D = 128 backward: flash_bwd_dq_wgmma_kernel and
//    flash_bwd_dkv_wgmma_kernel, the same structure (their section below
//    says how the work is split between the consumer warpgroups);
//  - bf16 backward (dQ; dK/dV) at D >= 256, and the forward at D >= 256:
//    4-warp blocks, each warp 16 rows of a 64-row tile with its scores and
//    accumulators in registers; mma.sync m16n8k16 fed by ldmatrix from
//    tiles staged by cp.async (double-buffered), and a score tile's
//    registers re-packed as the A operand of the next product. The
//    backward at D >= 256 and the forward at D > 256 split their output
//    columns over blocks of 128 (grid z), each recomputing the scores (the
//    forward's block z = 0 writes L); at D > 256 the streamed tiles hold
//    32 keys (or queries) instead of 64, and at D = 512 the backward's are
//    single-buffered, so that the staged tiles fit a block;
//  - f32 (MultiLayerNetwork's default precision): the forward at every
//    head dim and the backward at D = 128 and 256 on the tensor cores in
//    split TF32 (three TF32 products per f32 product, f32 accuracy; their
//    section below); the backward at D = 384 and 512 with scalar FMAs,
//    16-row tiles and f32 accumulators in shared memory.
//
// What bounds it on an H100: at the training shape (T = 4096, D = 128) the
// work is far above the card's ridge (about 2 * D * T / 2 flops per byte
// of Q, K, V read), so it is bounded by operations, 989 TFLOP/s in bf16,
// which only wgmma reaches: the D = 128 kernels' products run there, fed
// by TMA so no thread spends instructions on staging; the mbarrier waits spin
// inside PTX, so ptxas sees no divergent branch between wgmma operations
// and does not serialize them. What still holds it back: each consumer
// warpgroup runs its two products and its softmax one after the other (the
// two warpgroups overlap each other only as they drift). Overlapping a
// warpgroup's softmax with its own previous P V product needs S, O and two
// P tiles live at once, more than the 168 registers ptxas gives a thread
// of this 384-thread block (setmaxnreg moves registers at run time only):
// that schedule spilled and ran slower. The backward kernels likewise run
// each warpgroup's products and element-wise work one after the other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // ops/attention.py NEG_INF

struct Strides {
  long long b, t, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  void* out0;      // O (forward), dQ, or dK
  void* out1;      // dV
  float* lse;      // (B*H, Tq); forward writes it when not null
  const float* dsum;  // (B*H, Tq)
  Strides sq, sk, sv, sdo, so0, so1;
  int B, H, Tq, Tk;
  int causal;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const void* base, const Strides& s,
                                            int b, int h, int t) {
  return static_cast<const T*>(base) + (long long)b * s.b +
         (long long)h * s.h + (long long)t * s.t;
}

// A bump allocator over dynamic shared memory, run with base == nullptr on
// the host to size a launch and on the device to carve the same layout.
struct Carver {
  unsigned char* base;
  size_t off = 0;
  template <typename U>
  __host__ __device__ U* take(size_t n) {
    off = (off + 127) & ~size_t(127);
    U* p = base ? reinterpret_cast<U*>(base + off) : nullptr;
    off += n * sizeof(U);
    return p;
  }
};

// ------------------------------------------------------------- staging
// Asynchronous copies device memory -> shared memory (sm_80+): a thread
// starts all of its copies of a tile at once and nothing waits for them
// here. cp_async_commit closes a group; cp_async_wait<N> waits until at
// most N of this thread's groups are in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of ROWS rows of D elements (row r at src + r * stride_t)
// into a shared tile with rows of LD elements: 16 bytes a copy for bf16
// (rows 16-byte aligned, checked by the wrapper), 4 for f32.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      long long stride_t) {
  constexpr int vpr = D / 8;  // 16-byte copies per row
  for (int i = threadIdx.x; i < ROWS * vpr; i += kThreads) {
    const int r = i / vpr, c = i % vpr;
    cp_async16(dst + r * LD + 8 * c, src + (long long)r * stride_t + 8 * c);
  }
}

template <int ROWS, int D, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long stride_t) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    cp_async4(dst + r * LD + c, src + (long long)r * stride_t + c);
  }
}

// ================================== f32 scalar backward (D = 384, 512)
// The f32 backward at the head dims whose split-TF32 tiles (below) would
// not fit a block. 16-row tiles; operand tiles padded by one float (bank
// spread), score and accumulator rows by four (16-byte aligned for float4
// access). Products give one thread per output element, neighbouring
// threads on neighbouring columns (FMAs, no tensor cores).
// Rows of a tile: 16, so that the four staged tiles and the two
// accumulators of the backward fit a block's shared memory.
constexpr int kF32Blk = 16;
constexpr int kAccPad = 4;

// dQ (rows = query tile, loop over K/V) and dK/dV (rows = key tile, loop
// over Q) share one layout: the block's own two tiles (a, b), the two
// streamed tiles (c, d), scores S and dP, P and dS, two accumulators and
// the per-query-row L and dsum.
template <int D>
struct BwdSmem {
  static constexpr int kBlk = kF32Blk;
  float *a, *b, *c, *d, *p, *ds, *s, *dp, *acc0, *acc1, *lse, *dsum;
  __host__ __device__ static size_t carve(Carver& c, BwdSmem* t, bool two) {
    BwdSmem x;
    x.a = c.take<float>(kBlk * (D + 1));
    x.b = c.take<float>(kBlk * (D + 1));
    x.c = c.take<float>(kBlk * (D + 1));
    x.d = c.take<float>(kBlk * (D + 1));
    x.p = c.take<float>(kBlk * (kBlk + 1));
    x.ds = c.take<float>(kBlk * (kBlk + 1));
    x.s = c.take<float>(kBlk * (kBlk + kAccPad));
    x.dp = c.take<float>(kBlk * (kBlk + kAccPad));
    x.acc0 = c.take<float>(kBlk * (D + kAccPad));
    x.acc1 = two ? c.take<float>(kBlk * (D + kAccPad)) : nullptr;
    x.lse = c.take<float>(kBlk);
    x.dsum = c.take<float>(kBlk);
    if (t) *t = x;
    return c.off;
  }
};

template <int N>
__device__ __forceinline__ void zero(float* p) {
  for (int i = threadIdx.x; i < N; i += kThreads) p[i] = 0.f;
}

// C (M x N) = A (M x K) . B^T, B stored (N x K)
template <int M, int N, int K>
__device__ __forceinline__ void mm_abt(float* C, int ldc, const float* A,
                                       int lda, const float* B, int ldb) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int r = i / N, c = i % N;
    const float* a = A + r * lda;
    const float* b = B + c * ldb;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) acc = fmaf(a[k], b[k], acc);
    C[r * ldc + c] = acc;
  }
}

// C (M x N) += A (M x K) . B (K x N)
template <int M, int N, int K>
__device__ __forceinline__ void mm_ab_acc(float* C, int ldc, const float* A,
                                          int lda, const float* B, int ldb) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int r = i / N, c = i % N;
    const float* a = A + r * lda;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) acc = fmaf(a[k], B[k * ldb + c], acc);
    C[r * ldc + c] += acc;
  }
}

// C (M x N) += A^T . B, A stored (K x M), B (K x N)
template <int M, int N, int K>
__device__ __forceinline__ void mm_atb_acc(float* C, int ldc, const float* A,
                                           int lda, const float* B, int ldb) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int r = i / N, c = i % N;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      acc = fmaf(A[k * lda + r], B[k * ldb + c], acc);
    C[r * ldc + c] += acc;
  }
}

// Row-wise passes (softmax, P and dS) give each row of the tile to
// tpr(BLK) neighbouring threads of one warp, each owning cpt(BLK)
// consecutive columns kept in registers: loads, math and stores of a
// thread are independent, so their latencies overlap.
__host__ __device__ constexpr int tpr(int blk) { return kThreads / blk; }
__host__ __device__ constexpr int cpt(int blk) { return blk / tpr(blk); }

// N consecutive f32 of shared memory into registers (16 bytes a load when
// N % 4 == 0, the start then 16-byte aligned)
template <int N>
__device__ __forceinline__ void load_cols(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + j);
      v[j] = x.x, v[j + 1] = x.y, v[j + 2] = x.z, v[j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = p[j];
  }
}

template <int N>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) p[j] = v[j];
}

// P = exp(S * scale - L) (masked entries 0) and dS = P * (dP - dsum) for a
// (kBlk query rows) x (kBlk key columns) tile (the Pallas kernels' _tile_p).
template <int D>
__device__ __forceinline__ void p_and_ds(const BwdSmem<D>& sm, const Args& a,
                                         int q0, int k0) {
  constexpr int kBlk = kF32Blk, kTpr = tpr(kBlk), kCpt = cpt(kBlk);
  constexpr int ldp = kBlk + 1, lds = kBlk + kAccPad;
  const int r = threadIdx.x / kTpr, c0 = (threadIdx.x % kTpr) * kCpt;
  float p[kCpt], ds[kCpt];
  load_cols(p, sm.s + r * lds + c0);
  load_cols(ds, sm.dp + r * lds + c0);
  const float lse = sm.lse[r], dsum = sm.dsum[r];
#pragma unroll
  for (int j = 0; j < kCpt; ++j) {
    float s = p[j] * a.scale;
    if (a.causal && k0 + c0 + j > q0 + r) s = kNegInf;
    p[j] = s <= kNegInf * 0.5f ? 0.f : expf(s - lse);
    ds[j] = p[j] * (ds[j] - dsum);
  }
  store_cols(sm.p + r * ldp + c0, p);
  store_cols(sm.ds + r * ldp + c0, ds);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Args a) {
  constexpr int kBlk = kF32Blk;
  constexpr int ld = D + 1, ldp = kBlk + 1;
  constexpr int lds = kBlk + kAccPad, ldo = D + kAccPad;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  BwdSmem<D> sm;  // a = Q, b = dO, c = K, d = V
  BwdSmem<D>::carve(cv, &sm, false);

  const int qi = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qi * kBlk;
  const int nk = a.causal ? qi + 1 : a.Tk / kBlk;
  auto stage_kv = [&](float* dst, const void* src, const Strides& st,
                      int kj) {
    if (kj < nk)
      stage<kBlk, D, ld>(dst, row_ptr<float>(src, st, b, h, kj * kBlk), st.t);
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  stage<kBlk, D, ld>(sm.a, row_ptr<float>(a.q, a.sq, b, h, q0), a.sq.t);
  stage<kBlk, D, ld>(sm.b, row_ptr<float>(a.dO, a.sdo, b, h, q0), a.sdo.t);
  stage_kv(sm.d, a.v, a.sv, 0);  // groups in flight: {Q, dO, V0}, K0
  stage_kv(sm.c, a.k, a.sk, 0);
  zero<kBlk * ldo>(sm.acc0);
  for (int r = threadIdx.x; r < kBlk; r += kThreads) {
    sm.lse[r] = a.lse[(long long)bh * a.Tq + q0 + r];
    sm.dsum[r] = a.dsum[(long long)bh * a.Tq + q0 + r];
  }
  // V of the next tile loads while this tile's scores, P, dS and dS.K run
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * kBlk;
    cp_async_wait<1>();  // V(kj) staged (K(kj) may be in flight)
    __syncthreads();
    mm_abt<kBlk, kBlk, D>(sm.dp, lds, sm.b, ld, sm.d, ld);  // dO V^T
    __syncthreads();  // V free
    stage_kv(sm.d, a.v, a.sv, kj + 1);
    cp_async_wait<1>();  // K(kj) staged (V(kj + 1) may be in flight)
    __syncthreads();
    mm_abt<kBlk, kBlk, D>(sm.s, lds, sm.a, ld, sm.c, ld);  // Q K^T
    __syncthreads();
    p_and_ds<D>(sm, a, q0, k0);
    __syncthreads();
    mm_ab_acc<kBlk, D, kBlk>(sm.acc0, ldo, sm.ds, ldp, sm.c, ld);  // dS K
    __syncthreads();  // K free
    stage_kv(sm.c, a.k, a.sk, kj + 1);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* out = static_cast<float*>(a.out0);
  for (int i = threadIdx.x; i < kBlk * D; i += kThreads) {
    const int r = i / D, c = i % D;
    out[(long long)b * a.so0.b + (long long)h * a.so0.h +
        (long long)(q0 + r) * a.so0.t + c] = sm.acc0[r * ldo + c] * a.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Args a) {
  constexpr int kBlk = kF32Blk;
  constexpr int ld = D + 1, ldp = kBlk + 1;
  constexpr int lds = kBlk + kAccPad, ldo = D + kAccPad;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  BwdSmem<D> sm;  // a = K, b = V, c = Q, d = dO
  BwdSmem<D>::carve(cv, &sm, true);

  const int kj = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = kj * kBlk;
  const int q_first = a.causal ? kj : 0;  // earlier query tiles see none
  const int nq = a.Tq / kBlk;
  auto stage_q = [&](int qi) {  // Q and dO of query tile qi, one group each
    if (qi < nq)
      stage<kBlk, D, ld>(sm.c, row_ptr<float>(a.q, a.sq, b, h, qi * kBlk),
                         a.sq.t);
    cp_async_commit();
    if (qi < nq)
      stage<kBlk, D, ld>(sm.d, row_ptr<float>(a.dO, a.sdo, b, h, qi * kBlk),
                         a.sdo.t);
    cp_async_commit();
  };
  stage<kBlk, D, ld>(sm.a, row_ptr<float>(a.k, a.sk, b, h, k0), a.sk.t);
  stage<kBlk, D, ld>(sm.b, row_ptr<float>(a.v, a.sv, b, h, k0), a.sv.t);
  stage_q(q_first);  // groups in flight: {K, V, Q}, dO
  zero<kBlk * ldo>(sm.acc0);
  zero<kBlk * ldo>(sm.acc1);
  for (int qi = q_first; qi < nq; ++qi) {
    const int q0 = qi * kBlk;
    for (int r = threadIdx.x; r < kBlk; r += kThreads) {
      sm.lse[r] = a.lse[(long long)bh * a.Tq + q0 + r];
      sm.dsum[r] = a.dsum[(long long)bh * a.Tq + q0 + r];
    }
    cp_async_wait<1>();  // Q(qi) staged (dO(qi) may be in flight)
    __syncthreads();
    mm_abt<kBlk, kBlk, D>(sm.s, lds, sm.c, ld, sm.a, ld);  // Q K^T
    cp_async_wait<0>();  // dO(qi) staged
    __syncthreads();
    mm_abt<kBlk, kBlk, D>(sm.dp, lds, sm.d, ld, sm.b, ld);  // dO V^T
    __syncthreads();
    p_and_ds<D>(sm, a, q0, k0);
    __syncthreads();
    mm_atb_acc<kBlk, D, kBlk>(sm.acc1, ldo, sm.p, ldp, sm.d, ld);   // P^T dO
    mm_atb_acc<kBlk, D, kBlk>(sm.acc0, ldo, sm.ds, ldp, sm.c, ld);  // dS^T Q
    __syncthreads();  // Q, dO, L and dsum free
    stage_q(qi + 1);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* dk = static_cast<float*>(a.out0);
  float* dv = static_cast<float*>(a.out1);
  for (int i = threadIdx.x; i < kBlk * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dk[(long long)b * a.so0.b + (long long)h * a.so0.h +
       (long long)(k0 + r) * a.so0.t + c] = sm.acc0[r * ldo + c] * a.scale;
    dv[(long long)b * a.so1.b + (long long)h * a.so1.h +
       (long long)(k0 + r) * a.so1.t + c] = sm.acc1[r * ldo + c];
  }
}

// ================================================= bf16 register kernels
// Each of the 4 warps owns 16 rows of the block's 64-row tile; products
// are mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix from
// shared memory, and the score tile's accumulator registers are re-packed
// as the A operand of the next product (P.V, dS.K, P^T.dO, dS^T.Q) without
// touching shared memory. The streamed tiles are double-buffered: the next
// one's cp.async copies run during this one's math. Fragment layouts are
// those of the PTX ISA for m16n8k16: lane l = 4g + t holds rows g and
// g + 8, columns 2t and 2t + 1 of each 8-wide accumulator tile. Templated
// on D and on DO, the output columns one block accumulates (blockIdx.z
// picks which DO of the D); shared rows are D + 8 elements (16 bytes of
// padding spreads ldmatrix rows over the banks).
constexpr int kMmaBlk = 64;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A operand (16 x 16) at rows r0.., cols c0.. of a row-major bf16 tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* base,
                                     int ld, int r0, int c0) {
  const int l = threadIdx.x % 32;
  const bf16* p = base + (r0 + l % 16) * ld + c0 + 8 * (l / 16);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// B operands of two 8-wide n-tiles (n0, n0 + 8) at k-step k0, from a tile
// stored [n][k] (row n holds the k values): b[0..1] for n0, b[2..3] for
// n0 + 8
__device__ __forceinline__ void ld_b_nk(uint32_t (&b)[4], const bf16* base,
                                        int ld, int n0, int k0) {
  const int l = threadIdx.x % 32;
  const bf16* p = base + (n0 + l % 8 + 8 * (l / 16)) * ld + k0 +
                  8 * ((l / 8) % 2);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

// the same from a tile stored [k][n] (row k holds the n values)
__device__ __forceinline__ void ld_b_kn(uint32_t (&b)[4], const bf16* base,
                                        int ld, int n0, int k0) {
  const int l = threadIdx.x % 32;
  const bf16* p = base + (k0 + l % 16) * ld + n0 + 8 * (l / 16);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc (16 x 8*NT) += A (16 x K, row-major tile in shared memory) . B^T,
// B stored [n][k]: scores Q.K^T, dO.V^T, K.Q^T, V.dO^T
template <int NT, int K, int LD>
__device__ __forceinline__ void warp_abt(float (&acc)[NT][4], const bf16* A,
                                         int r0, const bf16* B) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    ld_a(a, A, LD, r0, k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ld_b_nk(b, B, LD, 8 * j, k0);
      mma(acc[j], a, b[0], b[1]);
      mma(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x 8*NT) += P (16 x 16*KS, accumulator registers rounded to
// bf16) . B, B stored [k][n]: P.V, dS.K, P^T.dO, dS^T.Q
template <int NT, int KS, int LD>
__device__ __forceinline__ void warp_pb(float (&acc)[NT][4],
                                        const float (&p)[2 * KS][4],
                                        const bf16* B) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ld_b_kn(b, B, LD, 8 * j, 16 * kk);
      mma(acc[j], a, b[0], b[1]);
      mma(acc[j + 1], a, b[2], b[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store a warp's 16 x 8*NT accumulator (times `mul`) as bf16 into rows
// r0 + (0..15), columns c0.. of a (b, h, t) strided output.
template <int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4],
                                          float mul, void* out,
                                          const Strides& st, int b, int h,
                                          int r0, int c0) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  bf16* base = static_cast<bf16*>(out) + (long long)b * st.b +
               (long long)h * st.h + c0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      *reinterpret_cast<__nv_bfloat162*>(
          base + (long long)(r0 + g + 8 * hi) * st.t + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * hi] * mul,
                                acc[j][2 * hi + 1] * mul);
    }
  }
}

// Keys (or queries) per streamed tile: 64, or 32 at D > 256, where the
// staged tiles of 64 would not fit a block's shared memory.
__host__ __device__ constexpr int mma_kb(int D) { return D > 256 ? 32 : 64; }
// Stages of the streamed tiles in the backward kernels: two (the next
// tile's copies run during this one's math), or one at D = 512, where two
// would not fit.
__host__ __device__ constexpr int mma_bufs(int D) { return D > 384 ? 1 : 2; }
// Output columns one block accumulates: all of D up to 256 (forward), 128
// otherwise (the backward at D = 256, everything at D > 256: two 16 x 256
// accumulators per warp, or one of 16 x 512, would not fit the registers).
__host__ __device__ constexpr int mma_cols(int kind_fwd, int D) {
  return kind_fwd && D <= 256 ? D : 128;
}

// Q, and two stages of K (KB x D) and of V's DO columns (KB x DO).
template <int D, int DO>
struct MmaFwdSmem {
  static constexpr int KB = mma_kb(D);
  bf16 *q, *k[2], *v[2];
  __host__ __device__ static size_t carve(Carver& c, MmaFwdSmem* t) {
    MmaFwdSmem x;
    x.q = c.take<bf16>(kMmaBlk * (D + 8));
    for (int i = 0; i < 2; ++i) {
      x.k[i] = c.take<bf16>(KB * (D + 8));
      x.v[i] = c.take<bf16>(KB * (DO + 8));
    }
    if (t) *t = x;
    return c.off;
  }
};

// The block's own two tiles (a, b) and the buffers of the streamed pair
// (c, d) with the streamed rows' L and dsum (dK/dV only).
template <int D>
struct MmaBwdSmem {
  static constexpr int KB = mma_kb(D), NB = mma_bufs(D);
  bf16 *a, *b, *c[2], *d[2];
  float *lse[2], *dsum[2];
  __host__ __device__ static size_t carve(Carver& c, MmaBwdSmem* t) {
    MmaBwdSmem x;
    x.a = c.take<bf16>(kMmaBlk * (D + 8));
    x.b = c.take<bf16>(kMmaBlk * (D + 8));
    for (int i = 0; i < NB; ++i) {
      x.c[i] = c.take<bf16>(KB * (D + 8));
      x.d[i] = c.take<bf16>(KB * (D + 8));
      x.lse[i] = c.take<float>(KB);
      x.dsum[i] = c.take<float>(KB);
    }
    if (NB == 1) {
      x.c[1] = x.c[0], x.d[1] = x.d[0];
      x.lse[1] = x.lse[0], x.dsum[1] = x.dsum[0];
    }
    if (t) *t = x;
    return c.off;
  }
};

template <int N>
__device__ __forceinline__ void stage_f32_row(float* dst, const float* src) {
  for (int i = threadIdx.x; i < N / 4; i += kThreads)
    cp_async16(dst + 4 * i, src + 4 * i);
}

// Columns DO * blockIdx.z .. + DO of O; at D > 256 each z-block recomputes
// the scores, and block z = 0 writes L.
template <int D, int DO>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const Args a) {
  constexpr int BLK = kMmaBlk, KB = mma_kb(D), LD = D + 8, LDV = DO + 8;
  constexpr int NO = DO / 8, NS = KB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  MmaFwdSmem<D, DO> sm;
  MmaFwdSmem<D, DO>::carve(cv, &sm);
  const int qi = blockIdx.x, bh = blockIdx.y, c0 = DO * blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, q0 = qi * BLK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int g = l / 4, t = l % 4, r0 = 16 * warp;
  // key tiles strictly above the diagonal contribute nothing
  const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB;
  auto stage_kv = [&](int kj) {
    if (kj < nk) {
      const int k0 = kj * KB;
      stage<KB, D, LD>(sm.k[kj & 1], row_ptr<bf16>(a.k, a.sk, b, h, k0),
                       a.sk.t);
      stage<KB, DO, LDV>(sm.v[kj & 1],
                         row_ptr<bf16>(a.v, a.sv, b, h, k0) + c0, a.sv.t);
    }
    cp_async_commit();
  };
  stage<BLK, D, LD>(sm.q, row_ptr<bf16>(a.q, a.sq, b, h, q0), a.sq.t);
  stage_kv(0);
  float o[NO][4], m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
  zero_acc(o);
  for (int kj = 0; kj < nk; ++kj) {
    stage_kv(kj + 1);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* K = sm.k[kj & 1];
    const bf16* V = sm.v[kj & 1];
    const int k0 = kj * KB;
    float s[NS][4];
    zero_acc(s);
    warp_abt<NS, D, LD>(s, sm.q, r0, K);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale;
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        if (a.causal && key > q0 + r0 + g + 8 * (e >> 1)) x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      lsum[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked entries stay exactly 0, also on rows masked so far
        const float x = s[j][e];
        const float p = x <= kNegInf * 0.5f ? 0.f : expf(x - m[e >> 1]);
        s[j][e] = p;
        lsum[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
    warp_pb<NO, KB / 16, LDV>(o, s, V);
    __syncthreads();  // this buffer is restaged two tiles on
  }
  cp_async_wait<0>();
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] = quad_sum(lsum[i]);
    inv[i] = lsum[i] > 0.f ? 1.f / lsum[i] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= inv[e >> 1];  // l == 0 gives 0
  store_acc(o, 1.f, a.out0, a.so0, b, h, q0 + r0, c0);
  if (a.lse != nullptr && blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a.lse[(long long)bh * a.Tq + q0 + r0 + g + 8 * i] =
          lsum[i] > 0.f ? m[i] + logf(lsum[i]) : kNegInf;
  }
}

// ====================================== bf16 D = 128 forward: wgmma + TMA
// Three warpgroups. Warpgroups 0 and 1 (the consumers) each own 64 of the
// block's 128 query rows; warpgroup 2 is the producer, one thread of which
// issues every TMA load: Q once, then K and V tiles of 128 keys into a
// ring of two stages each, behind full (bytes landed) and empty (every
// consumer warp done reading) mbarriers. setmaxnreg moves registers from
// the producer to the consumers at run time. Per K/V tile a consumer runs S = Q K^T
// as wgmma with both operands in shared memory, the online softmax in
// registers in the log2 domain (scale * log2(e) folded into one multiply,
// ex2), rounds P to bf16 in registers, and runs O += P V as wgmma with P
// as the register A operand and V read MN-major from shared memory.
constexpr int kWgRows = 128;  // query rows per block, keys per K/V tile
constexpr int kWgStages = 2;
constexpr int kWgThreads = 384;
constexpr uint32_t kWgTileBytes = kWgRows * 128 * 2;  // 128 rows of D = 128

// Every tile is two boxes of 64 columns (128-byte rows, swizzled), at
// 1024-byte aligned offsets.
struct WgFwdSmem {
  bf16 q[2][kWgRows * 64];
  bf16 k[kWgStages][2][kWgRows * 64];
  bf16 v[kWgStages][2][kWgRows * 64];
  uint64_t q_full, k_full[kWgStages], k_empty[kWgStages];
  uint64_t v_full[kWgStages], v_empty[kWgStages];
};
constexpr size_t kWgSmemBytes = sizeof(WgFwdSmem) + 1024;  // + alignment

struct WgFwdArgs {
  void* o;
  float* lse;
  Strides so;
  int H, Tq, Tk, causal;
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of tile j into sc (issued, not waited for)
__device__ __forceinline__ void issue_scores(float (&sc)[64], WgFwdSmem& sm,
                                             const char* q_tile, int s) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;
    sm90::wgmma_m64n128_ss(
        sc, sm90::desc_sw128(q_tile + box * sizeof(sm.q[0]) + off),
        sm90::desc_sw128(reinterpret_cast<const char*>(sm.k[s][box]) + off),
        kk > 0);
  }
  sm90::wgmma_commit();
}

// O += P V of the tile in stage s (issued, not waited for)
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&p)[32],
                                         WgFwdSmem& sm, int s) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t af[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                            p[4 * kk + 3]};
    sm90::wgmma_m64n128_rs_mn(
        o, af,
        sm90::desc_sw128(reinterpret_cast<const char*>(sm.v[s][0]) + kk * 2048,
                         sizeof(sm.v[s][0])));
  }
  sm90::wgmma_commit();
}

// The online softmax of one score tile in the log2 domain, in place: the
// row maxima m and sums lsum updated, sc turned into P = ex2(S - m) in
// f32; corr is the factor O must be scaled by. Only the diagonal tile
// masks keys after a row.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&lsum)[2],
                                             float (&corr)[2],
                                             float scale_log2, bool diag,
                                             int rl, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = sc[i] * scale_log2;
    if (diag && 8 * (i / 4) + 2 * t + (i & 1) > rl + 8 * ((i >> 1) & 1))
      x = -INFINITY;
    sc[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    base[r] = mn == -INFINITY ? 0.f : mn;  // a row with no key yet
    corr[r] = ex2(m[r] - base[r]);
    m[r] = mn;
    lsum[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = ex2(sc[i] - base[(i >> 1) & 1]);
    lsum[(i >> 1) & 1] += sc[i];
  }
}

// P rounded to bf16: p[2n], p[2n + 1] are the m16n8k16 A fragment
// registers of 8-column block n (rows rl and rl + 8)
__device__ __forceinline__ void pack_p(uint32_t (&p)[32],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) p[i / 2] = pack_bf16(sc[i], sc[i + 1]);
}

// A consumer warpgroup. Per K/V tile j: S(j) on the tensor cores, its
// K stage released, the softmax, O rescaled, P(j) packed, O += P(j) V(j),
// its V stage released. The two warpgroups overlap each other's softmax
// with their products as they drift; overlapping a warpgroup's own
// softmax with its previous P V would hold S, O and both P tiles at once,
// more than the 168 registers ptxas gives a thread of this block.
__device__ __forceinline__ void flash_fwd_consumer(WgFwdSmem& sm,
                                                   const WgFwdArgs& a, int wg,
                                                   int qi, int nk, int b,
                                                   int h, int bh) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int w = (threadIdx.x % 128) / 32;
  // this thread's rows in the block's tile: rl and rl + 8 (accumulator
  // element 4j + e: row rl + 8 (e >> 1), column 8j + 2t + (e & 1))
  const int rl = wg * 64 + 16 * w + g;
  float o[64], sc[64], m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  float corr[2];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  sm90::mbar_wait(&sm.q_full, 0);
  const char* q_tile = reinterpret_cast<const char*>(sm.q) + wg * 8192;
  for (int j = 0; j < nk; ++j) {
    const int s = j % kWgStages;
    const uint32_t par = (j / kWgStages) & 1;
    sm90::mbar_wait(&sm.k_full[s], par);
    sm90::wgmma_fence();
    issue_scores(sc, sm, q_tile, s);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    if (l == 0) sm90::mbar_arrive(&sm.k_empty[s]);
    softmax_tile(sc, m, lsum, corr, a.scale_log2, a.causal && j == nk - 1,
                 rl, t);
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];
    pack_p(p, sc);
    sm90::mbar_wait(&sm.v_full[s], par);
    sm90::fence_regs(o);
    sm90::wgmma_fence();
    issue_pv(o, p, sm, s);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    if (l == 0) sm90::mbar_arrive(&sm.v_empty[s]);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] = quad_sum(lsum[r]);
    inv[r] = lsum[r] > 0.f ? 1.f / lsum[r] : 0.f;  // l == 0 gives O = 0
  }
  const int q0 = qi * kWgRows;
  bf16* out = static_cast<bf16*>(a.o) + (long long)b * a.so.b +
              (long long)h * a.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* row = out + (long long)(q0 + rl + 8 * r) * a.so.t + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    if (a.lse != nullptr && t == 0)
      a.lse[(long long)bh * a.Tq + q0 + rl + 8 * r] =
          lsum[r] > 0.f ? m[r] * 0.6931471805599453f + logf(lsum[r])
                        : kNegInf;
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const WgFwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  WgFwdSmem& sm = *reinterpret_cast<WgFwdSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int qi = a.Tq / kWgRows - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // K/V tiles strictly above the diagonal are never loaded
  const int nk = a.causal ? qi + 1 : a.Tk / kWgRows;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      sm90::mbar_init(&sm.k_full[s], 1);
      sm90::mbar_init(&sm.v_full[s], 1);
      sm90::mbar_init(&sm.k_empty[s], 8);  // one arrival per consumer warp
      sm90::mbar_init(&sm.v_empty[s], 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const int q0 = qi * kWgRows;
      sm90::mbar_expect_tx(&sm.q_full, kWgTileBytes);
      sm90::tma_load_4d(sm.q[0], &tq, &sm.q_full, 0, h, q0, b);
      sm90::tma_load_4d(sm.q[1], &tq, &sm.q_full, 64, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kWgStages, k0 = j * kWgRows;
        // a stage is refilled once every consumer warp released it
        const uint32_t par = ((j / kWgStages) & 1) ^ 1;
        sm90::mbar_wait(&sm.k_empty[s], par);
        sm90::mbar_expect_tx(&sm.k_full[s], kWgTileBytes);
        sm90::tma_load_4d(sm.k[s][0], &tk, &sm.k_full[s], 0, h, k0, b);
        sm90::tma_load_4d(sm.k[s][1], &tk, &sm.k_full[s], 64, h, k0, b);
        sm90::mbar_wait(&sm.v_empty[s], par);
        sm90::mbar_expect_tx(&sm.v_full[s], kWgTileBytes);
        sm90::tma_load_4d(sm.v[s][0], &tv, &sm.v_full[s], 0, h, k0, b);
        sm90::tma_load_4d(sm.v[s][1], &tv, &sm.v_full[s], 64, h, k0, b);
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    flash_fwd_consumer(sm, a, threadIdx.x / 128, qi, nk, b, h, bh);
  }
}

// ============================= bf16 D = 128 backward: wgmma + TMA
// The two backward kernels of the training path, laid out as the forward:
// three warpgroups, warpgroup 2 the producer (one thread issues every TMA
// load into a ring of kBwStages stages behind full and empty mbarriers),
// warpgroups 0 and 1 the consumers, every product on wgmma, the score
// tiles turned into the register A operand of the next product, and only
// the diagonal tile masked under the causal mask (tiles above it are
// never loaded). Streamed tiles hold 64 rows (keys for dQ, queries for
// dK/dV): a 64 x 64 f32 score tile is 32 registers a thread.
//  - dQ: a block owns 128 query rows (Q and dO loaded once), each consumer
//    warpgroup 64 of them; the ring carries 64-key K/V tiles, which both
//    warpgroups read. Per tile: S = Q K^T and dP = dO V^T (shared-memory
//    operands, one commit), P = ex2(S * scale * log2(e) - L * log2(e)) and
//    dS = P * (dP - dsum) in registers (L and dsum of the thread's two rows
//    stay in registers), dQ += dS K with dS rounded to bf16 as the register
//    A operand and K read MN-major. Live f32 per thread: dQ 64, S 32, dP 32.
//  - dK/dV: a block owns 64 keys (K and V loaded once); the ring carries
//    64-query tiles of Q and dO with their L and dsum rows (bulk copies).
//    The two accumulators (128 registers) do not fit one warpgroup beside
//    the score tiles, so the work is split: warpgroup 0 computes S^T = K
//    Q^T, then P^T (f32), hands P^T to warpgroup 1 through shared memory
//    (two buffers behind p_full / p_empty mbarriers) and accumulates
//    dV += P^T dO; warpgroup 1 computes dP^T = V dO^T, reads P^T, forms
//    dS^T = P^T * (dP^T - dsum) and accumulates dK += dS^T Q. Each holds
//    64 accumulator and 32 score registers and runs two products a tile.
// No atomics: each block writes its own rows, so two runs give the same
// bits. Blocks take their tiles longest first: the grid's x is (b, h), so
// the first wave holds every head's longest rows (dQ) or columns (dK/dV).
// What holds them back: a warpgroup's element-wise work sits between its
// products (only the other warpgroup fills the tensor cores meanwhile),
// and an m64n64 score product reads its 4 KB of operands a k-step from
// shared memory in about the time it multiplies them. Schedules that
// overlap the next tile's scores with the element-wise work, or keep the
// A operands in registers, made ptxas serialize the wgmma (C7511, C7512,
// C7515) and ran slower.
constexpr int kBwRows = 64;  // rows of a streamed tile; keys of a dK/dV block
constexpr int kBwStages = 4;
constexpr uint32_t kBwTileBytes = kBwRows * 128 * 2;  // 64 rows of D = 128

struct WgDqSmem {
  bf16 q[2][kWgRows * 64];  // 128 rows, two boxes of 64 columns
  bf16 dO[2][kWgRows * 64];
  bf16 k[kBwStages][2][kBwRows * 64];
  bf16 v[kBwStages][2][kBwRows * 64];
  uint64_t own_full, full[kBwStages], empty[kBwStages];
};

struct WgDkvSmem {
  bf16 k[2][kBwRows * 64];
  bf16 v[2][kBwRows * 64];
  bf16 q[kBwStages][2][kBwRows * 64];
  bf16 dO[kBwStages][2][kBwRows * 64];
  float pt[2][kBwRows * kBwRows];  // P^T, in the accumulator's layout
  float lse[kBwStages][kBwRows], dsum[kBwStages][kBwRows];
  uint64_t own_full, full[kBwStages], empty[kBwStages];
  uint64_t p_full[2], p_empty[2];
};
constexpr size_t kDqSmemBytes = sizeof(WgDqSmem) + 1024;  // + alignment
constexpr size_t kDkvSmemBytes = sizeof(WgDkvSmem) + 1024;

struct WgBwdArgs {
  const float* lse;   // (B*H, Tq)
  const float* dsum;  // (B*H, Tq)
  void* out0;         // dQ or dK
  void* out1;         // dV
  Strides so0, so1;
  int H, Tq, Tk, causal;
  float scale, scale_log2;  // scale, scale * log2(e)
};

constexpr float kLog2e = 1.4426950408889634f;

// acc (64 x 64) = A (64 x 128, K-major tile of two 64-column boxes `a_box`
// bytes apart) . B^T (B: 64 rows of 128, two boxes of kBwTileBytes / 2);
// issued, not committed
__device__ __forceinline__ void issue_s64(float (&acc)[32], const void* a,
                                          uint32_t a_box, const void* b) {
  const char* pa = static_cast<const char*>(a);
  const char* pb = static_cast<const char*>(b);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;
    sm90::wgmma_m64n64_ss(acc, sm90::desc_sw128(pa + box * a_box + off),
                          sm90::desc_sw128(pb + box * (kBwTileBytes / 2) +
                                           off),
                          kk > 0);
  }
}

// acc (64 x 128) += P (64 x 64, bf16 A fragments in registers) . B, B a
// 64-row tile of D = 128 read MN-major; issued and committed
__device__ __forceinline__ void issue_pb64(float (&acc)[64],
                                           const uint32_t (&p)[16],
                                           const void* b) {
  const char* pb = static_cast<const char*>(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t af[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                            p[4 * kk + 3]};
    sm90::wgmma_m64n128_rs_mn(
        acc, af, sm90::desc_sw128(pb + kk * 2048, kBwTileBytes / 2));
  }
  sm90::wgmma_commit();
}

__device__ __forceinline__ void pack16(uint32_t (&p)[16],
                                       const float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) p[i / 2] = pack_bf16(x[i], x[i + 1]);
}

// A consumer's 64 x 128 accumulator (times `mul`) as bf16 into rows
// r0 + rl, r0 + rl + 8 (and their 16-row steps) of a (b, t, h) strided
// output: element 4j + e is row 16w + g + 8 (e >> 1), column 8j + 2t + (e & 1)
__device__ __forceinline__ void store_wg(const float (&acc)[64], float mul,
                                         void* out, const Strides& st, int b,
                                         int h, int r0, int rl, int t) {
  bf16* base = static_cast<bf16*>(out) + (long long)b * st.b +
               (long long)h * st.h + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* row = base + (long long)(r0 + rl + 8 * r) * st.t;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// A dQ consumer warpgroup: query rows q0 .. q0 + 63 of the block's tile.
__device__ __forceinline__ void dq_consumer(WgDqSmem& sm, const WgBwdArgs& a,
                                            int wg, int q0, int nk, int b,
                                            int h, int bh) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int rl = 16 * ((threadIdx.x % 128) / 32) + g;  // rows rl, rl + 8
  // key tiles past this warpgroup's diagonal tile are masked out whole
  const int nk_wg = a.causal ? q0 / kBwRows + 1 : nk;
  float lse2[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = (long long)bh * a.Tq + q0 + rl + 8 * r;
    lse2[r] = a.lse[i] * kLog2e;
    dsum[r] = a.dsum[i];
  }
  float dq[64], s[32], dp[32];
  uint32_t p[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  sm90::mbar_wait(&sm.own_full, 0);
  const char* q_tile = reinterpret_cast<const char*>(sm.q) + wg * 8192;
  const char* do_tile = reinterpret_cast<const char*>(sm.dO) + wg * 8192;
  for (int j = 0; j < nk; ++j) {
    const int st = j % kBwStages;
    sm90::mbar_wait(&sm.full[st], (j / kBwStages) & 1);
    if (j < nk_wg) {
      sm90::wgmma_fence();
      issue_s64(s, q_tile, sizeof(sm.q[0]), sm.k[st]);
      issue_s64(dp, do_tile, sizeof(sm.dO[0]), sm.v[st]);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      const bool diag = a.causal && j == nk_wg - 1;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const bool masked = diag && 8 * (i / 4) + 2 * t + (i & 1) > rl + 8 * r;
        const float pv =
            masked ? 0.f : ex2(fmaf(s[i], a.scale_log2, -lse2[r]));
        s[i] = pv * (dp[i] - dsum[r]);  // dS
      }
      pack16(p, s);
      sm90::fence_regs(dq);
      sm90::wgmma_fence();
      issue_pb64(dq, p, sm.k[st][0]);  // dQ += dS K
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
    }
    if (l == 0) sm90::mbar_arrive(&sm.empty[st]);
  }
  store_wg(dq, a.scale, a.out0, a.so0, b, h, q0, rl, t);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const WgBwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  WgDqSmem& sm = *reinterpret_cast<WgDqSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int qi = a.Tq / kWgRows - 1 - blockIdx.y;  // longest rows first
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = qi * kWgRows;
  // K/V tiles past the block's diagonal are never loaded
  const int nk = a.causal ? (q0 + kWgRows) / kBwRows : a.Tk / kBwRows;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.own_full, 1);
    for (int s = 0; s < kBwStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      sm90::mbar_expect_tx(&sm.own_full, 2 * kWgTileBytes);
      sm90::tma_load_4d(sm.q[0], &tq, &sm.own_full, 0, h, q0, b);
      sm90::tma_load_4d(sm.q[1], &tq, &sm.own_full, 64, h, q0, b);
      sm90::tma_load_4d(sm.dO[0], &tdo, &sm.own_full, 0, h, q0, b);
      sm90::tma_load_4d(sm.dO[1], &tdo, &sm.own_full, 64, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kBwStages, k0 = j * kBwRows;
        // a stage is refilled once every consumer warp released it
        sm90::mbar_wait(&sm.empty[s], ((j / kBwStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&sm.full[s], 2 * kBwTileBytes);
        sm90::tma_load_4d(sm.k[s][0], &tk, &sm.full[s], 0, h, k0, b);
        sm90::tma_load_4d(sm.k[s][1], &tk, &sm.full[s], 64, h, k0, b);
        sm90::tma_load_4d(sm.v[s][0], &tv, &sm.full[s], 0, h, k0, b);
        sm90::tma_load_4d(sm.v[s][1], &tv, &sm.full[s], 64, h, k0, b);
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    dq_consumer(sm, a, wg, q0 + wg * kBwRows, nk, b, h, bh);
  }
}

// dK/dV warpgroup 0: S^T, P^T (handed to warpgroup 1), dV += P^T dO.
__device__ __forceinline__ void dv_consumer(WgDkvSmem& sm, const WgBwdArgs& a,
                                            int kj, int q_first, int nq,
                                            int b, int h) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int tid = threadIdx.x % 128;
  const int rl = 16 * (tid / 32) + g;  // key rows rl, rl + 8 of the block
  float dv[64], s[32];
  uint32_t p[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) dv[i] = 0.f;
  sm90::mbar_wait(&sm.own_full, 0);
  for (int qi = q_first; qi < nq; ++qi) {
    const int n = qi - q_first, st = n % kBwStages, pb = n & 1;
    sm90::mbar_wait(&sm.full[st], (n / kBwStages) & 1);
    sm90::wgmma_fence();
    issue_s64(s, sm.k, sizeof(sm.k[0]), sm.q[st]);  // S^T = K Q^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    // P^T = ex2(S^T * scale * log2(e) - L(query) * log2(e)); on the
    // diagonal tile keys after a query are masked (exactly 0)
    const bool diag = a.causal && qi == kj;
    const float* Ls = sm.lse[st];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(Ls + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, col = 8 * j + 2 * t + (e & 1);
        const float L2 = ((e & 1) ? lq.y : lq.x) * kLog2e;
        const bool masked = diag && rl + 8 * (e >> 1) > col;
        s[i] = masked ? 0.f : ex2(fmaf(s[i], a.scale_log2, -L2));
      }
    }
    // hand P^T to warpgroup 1 once it read the buffer's previous tile
    sm90::mbar_wait(&sm.p_empty[pb], ((n >> 1) & 1) ^ 1);
    float4* pt = reinterpret_cast<float4*>(sm.pt[pb]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      pt[j * 128 + tid] =
          make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
    sm90::mbar_arrive(&sm.p_full[pb]);
    pack16(p, s);
    sm90::fence_regs(dv);
    sm90::wgmma_fence();
    issue_pb64(dv, p, sm.dO[st][0]);  // dV += P^T dO
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    if (l == 0) sm90::mbar_arrive(&sm.empty[st]);
  }
  store_wg(dv, 1.f, a.out1, a.so1, b, h, kj * kBwRows, rl, t);
}

// dK/dV warpgroup 1: dP^T, dS^T = P^T * (dP^T - dsum), dK += dS^T Q.
__device__ __forceinline__ void dk_consumer(WgDkvSmem& sm, const WgBwdArgs& a,
                                            int kj, int q_first, int nq,
                                            int b, int h) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int tid = threadIdx.x % 128;
  const int rl = 16 * (tid / 32) + g;
  float dk[64], dp[32];
  uint32_t p[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = 0.f;
  sm90::mbar_wait(&sm.own_full, 0);
  for (int qi = q_first; qi < nq; ++qi) {
    const int n = qi - q_first, st = n % kBwStages, pb = n & 1;
    sm90::mbar_wait(&sm.full[st], (n / kBwStages) & 1);
    sm90::wgmma_fence();
    issue_s64(dp, sm.v, sizeof(sm.v[0]), sm.dO[st]);  // dP^T = V dO^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
    sm90::mbar_wait(&sm.p_full[pb], (n >> 1) & 1);
    const float4* pt = reinterpret_cast<const float4*>(sm.pt[pb]);
    const float* Ds = sm.dsum[st];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 pv = pt[j * 128 + tid];
      const float2 d2 = *reinterpret_cast<const float2*>(Ds + 8 * j + 2 * t);
      dp[4 * j] = pv.x * (dp[4 * j] - d2.x);
      dp[4 * j + 1] = pv.y * (dp[4 * j + 1] - d2.y);
      dp[4 * j + 2] = pv.z * (dp[4 * j + 2] - d2.x);
      dp[4 * j + 3] = pv.w * (dp[4 * j + 3] - d2.y);
    }
    sm90::mbar_arrive(&sm.p_empty[pb]);
    pack16(p, dp);
    sm90::fence_regs(dk);
    sm90::wgmma_fence();
    issue_pb64(dk, p, sm.q[st][0]);  // dK += dS^T Q
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dk);
    if (l == 0) sm90::mbar_arrive(&sm.empty[st]);
  }
  store_wg(dk, a.scale, a.out0, a.so0, b, h, kj * kBwRows, rl, t);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const WgBwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  WgDkvSmem& sm = *reinterpret_cast<WgDkvSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kj = blockIdx.y;  // under the causal mask: longest columns first
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = kj * kBwRows;
  // query tiles before the diagonal see none of these keys
  const int q_first = a.causal ? kj : 0;
  const int nq = a.Tq / kBwRows;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.own_full, 1);
    for (int s = 0; s < kBwStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&sm.p_full[i], 128);   // every thread of warpgroup 0
      sm90::mbar_init(&sm.p_empty[i], 128);  // every thread of warpgroup 1
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      sm90::mbar_expect_tx(&sm.own_full, 2 * kBwTileBytes);
      sm90::tma_load_4d(sm.k[0], &tk, &sm.own_full, 0, h, k0, b);
      sm90::tma_load_4d(sm.k[1], &tk, &sm.own_full, 64, h, k0, b);
      sm90::tma_load_4d(sm.v[0], &tv, &sm.own_full, 0, h, k0, b);
      sm90::tma_load_4d(sm.v[1], &tv, &sm.own_full, 64, h, k0, b);
      const float* lse = a.lse + (long long)bh * a.Tq;
      const float* dsum = a.dsum + (long long)bh * a.Tq;
      for (int qi = q_first; qi < nq; ++qi) {
        const int n = qi - q_first, s = n % kBwStages, r0 = qi * kBwRows;
        // a stage is refilled once every consumer warp released it
        sm90::mbar_wait(&sm.empty[s], ((n / kBwStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&sm.full[s],
                             2 * kBwTileBytes + 2 * kBwRows * 4);
        sm90::tma_load_4d(sm.q[s][0], &tq, &sm.full[s], 0, h, r0, b);
        sm90::tma_load_4d(sm.q[s][1], &tq, &sm.full[s], 64, h, r0, b);
        sm90::tma_load_4d(sm.dO[s][0], &tdo, &sm.full[s], 0, h, r0, b);
        sm90::tma_load_4d(sm.dO[s][1], &tdo, &sm.full[s], 64, h, r0, b);
        sm90::bulk_load(sm.lse[s], lse + r0, kBwRows * 4, &sm.full[s]);
        sm90::bulk_load(sm.dsum[s], dsum + r0, kBwRows * 4, &sm.full[s]);
      }
    }
  } else if (threadIdx.x < 128) {
    sm90::setmaxnreg_inc<232>();
    dv_consumer(sm, a, kj, q_first, nq, b, h);
  } else {
    sm90::setmaxnreg_inc<232>();
    dk_consumer(sm, a, kj, q_first, nq, b, h);
  }
}

template <int D, int DO>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma_kernel(const Args a) {
  constexpr int BLK = kMmaBlk, KB = mma_kb(D), NB = mma_bufs(D);
  constexpr int LD = D + 8, NO = DO / 8, NS = KB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  MmaBwdSmem<D> sm;  // a = Q, b = dO, c = K, d = V
  MmaBwdSmem<D>::carve(cv, &sm);
  const int qi = blockIdx.x, bh = blockIdx.y, c0 = DO * blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, q0 = qi * BLK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int g = l / 4, t = l % 4, r0 = 16 * warp;
  const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB;
  auto stage_kv = [&](int kj) {
    if (kj < nk) {
      const int k0 = kj * KB;
      stage<KB, D, LD>(sm.c[kj & 1], row_ptr<bf16>(a.k, a.sk, b, h, k0),
                       a.sk.t);
      stage<KB, D, LD>(sm.d[kj & 1], row_ptr<bf16>(a.v, a.sv, b, h, k0),
                       a.sv.t);
    }
    cp_async_commit();
  };
  stage<BLK, D, LD>(sm.a, row_ptr<bf16>(a.q, a.sq, b, h, q0), a.sq.t);
  stage<BLK, D, LD>(sm.b, row_ptr<bf16>(a.dO, a.sdo, b, h, q0), a.sdo.t);
  stage_kv(0);
  float lse[2], dsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = a.lse[(long long)bh * a.Tq + q0 + r0 + g + 8 * i];
    dsum[i] = a.dsum[(long long)bh * a.Tq + q0 + r0 + g + 8 * i];
  }
  float dq[NO][4];
  zero_acc(dq);
  for (int kj = 0; kj < nk; ++kj) {
    if constexpr (NB == 2) {
      stage_kv(kj + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* K = sm.c[kj & 1];
    const bf16* V = sm.d[kj & 1];
    const int k0 = kj * KB;
    float s[NS][4], dp[NS][4];
    zero_acc(s);
    zero_acc(dp);
    warp_abt<NS, D, LD>(s, sm.a, r0, K);   // Q K^T
    warp_abt<NS, D, LD>(dp, sm.b, r0, V);  // dO V^T
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = s[j][e] * a.scale;
        if (a.causal && k0 + 8 * j + 2 * t + (e & 1) > q0 + r0 + g + 8 * i)
          x = kNegInf;
        const float p = x <= kNegInf * 0.5f ? 0.f : expf(x - lse[i]);
        s[j][e] = p * (dp[j][e] - dsum[i]);  // dS
      }
    warp_pb<NO, KB / 16, LD>(dq, s, K + c0);  // dS K, this block's columns
    __syncthreads();
    if constexpr (NB == 1) stage_kv(kj + 1);
  }
  cp_async_wait<0>();
  store_acc(dq, a.scale, a.out0, a.so0, b, h, q0 + r0, c0);
}

template <int D, int DO>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_mma_kernel(const Args a) {
  constexpr int BLK = kMmaBlk, KB = mma_kb(D), NB = mma_bufs(D);
  constexpr int LD = D + 8, NO = DO / 8, NS = KB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  MmaBwdSmem<D> sm;  // a = K, b = V, c = Q, d = dO
  MmaBwdSmem<D>::carve(cv, &sm);
  const int kj = blockIdx.x, bh = blockIdx.y, c0 = DO * blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, k0 = kj * BLK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int g = l / 4, t = l % 4, r0 = 16 * warp;
  const int q_first = a.causal ? k0 / KB : 0;  // earlier query tiles see none
  const int nq = a.Tq / KB;
  auto stage_q = [&](int qi) {
    if (qi < nq) {
      const int buf = (qi - q_first) & 1;
      stage<KB, D, LD>(sm.c[buf], row_ptr<bf16>(a.q, a.sq, b, h, qi * KB),
                       a.sq.t);
      stage<KB, D, LD>(sm.d[buf], row_ptr<bf16>(a.dO, a.sdo, b, h, qi * KB),
                       a.sdo.t);
      stage_f32_row<KB>(sm.lse[buf], a.lse + (long long)bh * a.Tq + qi * KB);
      stage_f32_row<KB>(sm.dsum[buf],
                        a.dsum + (long long)bh * a.Tq + qi * KB);
    }
    cp_async_commit();
  };
  stage<BLK, D, LD>(sm.a, row_ptr<bf16>(a.k, a.sk, b, h, k0), a.sk.t);
  stage<BLK, D, LD>(sm.b, row_ptr<bf16>(a.v, a.sv, b, h, k0), a.sv.t);
  stage_q(q_first);
  float dk[NO][4], dv[NO][4];
  zero_acc(dk);
  zero_acc(dv);
  for (int qi = q_first; qi < nq; ++qi) {
    if constexpr (NB == 2) {
      stage_q(qi + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = (qi - q_first) & 1;
    const bf16* Q = sm.c[buf];
    const bf16* dO = sm.d[buf];
    const float* Ls = sm.lse[buf];
    const float* Ds = sm.dsum[buf];
    const int q0 = qi * KB;
    // rows of these tiles are keys k0 + r0 + (g, g + 8), columns queries
    float s[NS][4], dp[NS][4];
    zero_acc(dp);
    warp_abt<NS, D, LD>(dp, sm.b, r0, dO);  // V dO^T = dP^T
    zero_acc(s);
    warp_abt<NS, D, LD>(s, sm.a, r0, Q);    // K Q^T = S^T
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * a.scale;
        if (a.causal && k0 + r0 + g + 8 * (e >> 1) > q0 + col) x = kNegInf;
        s[j][e] = x <= kNegInf * 0.5f ? 0.f : expf(x - Ls[col]);  // P^T
      }
    warp_pb<NO, KB / 16, LD>(dv, s, dO + c0);  // P^T dO, this block's columns
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] *= dp[j][e] - Ds[8 * j + 2 * t + (e & 1)];  // dS^T
    warp_pb<NO, KB / 16, LD>(dk, s, Q + c0);  // dS^T Q
    __syncthreads();
    if constexpr (NB == 1) stage_q(qi + 1);
  }
  cp_async_wait<0>();
  store_acc(dk, a.scale, a.out0, a.so0, b, h, k0 + r0, c0);
  store_acc(dv, 1.f, a.out1, a.so1, b, h, k0 + r0, c0);
}

// ================================= f32: split-TF32 tensor-core kernels
// The f32 forward at every head dim, and dQ and dK/dV at D = 128 and 256,
// run every product of the body on the tensor cores in split TF32
// ("3xTF32"), the counterpart of the reference's HIGHEST precision (bf16x3
// passes on the MXU, ops/kernel_dispatch.py): each operand x is split once
// into big = rna_tf32(x) and small = rna_tf32(x - big), and
// a.b ~ a_small.b_big + a_big.b_small + a_big.b_big (small terms first),
// accumulated in f32 by mma.sync m16n8k8. The tensor cores ignore the low
// 13 bits of an f32 register, so an operand that skipped the conversion
// would lose accuracy without any error: every operand goes through
// split_tf32. Scores, softmax statistics and accumulators stay f32 in
// registers. At D = 384 and 512 the backward keeps the scalar kernels
// above: its staged tiles would not fit a block.
//
// mma.sync, not wgmma: wgmma takes tf32 operands from shared memory only
// K-major, and four of the six products (P V, dS K, P^T dO, dS^T Q) sum
// over the rows of their B operand, which would need a transposed, split
// copy of each streamed tile in shared memory; mma.sync takes either
// layout from registers, and a score fragment is the next product's A
// operand as it stands (split in registers).
//
// Where the split happens. Splitting costs more instruction slots than
// the three products it feeds (cvt.rna is a sequence of integer and
// compare instructions on sm_90), so each value is split as few times as
// possible:
//  - the streamed tiles (K and V; Q and dO for dK/dV), which every warp
//    reads whole, are split once per block: cp.async lands a tile raw in
//    its stage, one pass of the block writes its big and small parts to two
//    split tiles, and the warps read both parts (PRE: the backward at
//    D = 128; at wider heads the split tiles would not fit, and the
//    forward keeps two blocks an SM without them, which measured faster);
//  - the block's own tiles (Q; dO; K and V for dK/dV) are split as each
//    warp reads its 16 rows, once per streamed tile.
//
// Accumulation. The tensor cores truncate the sums they accumulate, so
// products are summed on fresh accumulators, two k-steps of a score or a
// whole streamed tile of P V, dS K, P^T dO and dS^T Q, and added to the
// running f32 sums with f32 adds (add_acc).
//
// Layout: 4 warps, each 16 of the block's 64 rows (kTfBlk); the streamed
// tiles hold KB rows (keys, or queries for dK/dV), double-buffered by
// cp.async; every shared tile has rows of D + 4 floats. Fragments are read
// 16 bytes a lane, without bank conflicts, through two permutations that
// are undone where values leave the registers:
//  - rows: lane group g reads the row perm8(g) = g / 2 + 4 (g % 2) of an
//    A tile (and of a K-major B tile), so the two groups of a quarter-warp
//    read rows 4 apart, 16 banks apart; a score accumulator's columns 2t
//    and 2t + 1 then hold keys t and t + 4 of its 8-key tile, which is the
//    next product's A fragment with the keys in order;
//  - a K-major 16-byte run of 4 columns feeds two k-steps (the sum runs
//    over them in the same order on both sides);
//  - columns: an MN-major B (summed over its rows) is read 4 output columns
//    at a time, one for each n-tile of a group of 4: n-tile i's column g is
//    output column C(g) + i, C(g) = 4 (g / 2) + 16 (g % 2), so lane (g, t)
//    holds columns 4t .. 4t + 3 and 16 + 4t .. of each group of 32.
// Blocks accumulate kTfCols output columns (grid z splits wider heads, each
// block recomputing the scores); dQ and the forward take their query tiles
// in reverse, so under the causal mask the longest rows start first.
//
// What bounds it: at phase 6's shape (T = 1024, D = 128) the work is far
// above the ridge, so operations: 3 tensor-core passes at 495 TFLOP/s
// (TF32), ~165 TFLOP/s of f32 products, against 67 for f32 FMAs. mma.sync
// reaches part of that rate, and the splits, the f32 adds of the fresh
// accumulators and the softmax take instruction slots beside it (PERF.md
// has the measured times); dK/dV holds dK and dV (128 registers a thread)
// and spills a few hundred bytes at ptxas' 255.
constexpr int kTfBlk = 64;    // rows a block owns: 4 warps of 16
constexpr int kTfCols = 128;  // output columns a block accumulates

__host__ __device__ constexpr int tf_ld(int W) { return W + 4; }
// Rows per streamed tile: the forward's (K, V) and the backward's (K, V or
// Q, dO with their L and dsum), so that two stages fit a block.
__host__ __device__ constexpr int tf_kb(int fwd, int D) {
  return fwd ? (D <= 256 ? 32 : 16) : (D == 128 ? 32 : 16);
}
// Whether the streamed tiles are split once per block (see above).
__host__ __device__ constexpr bool tf_presplit(int fwd, int D) {
  return !fwd && D == 128;
}

__device__ __forceinline__ int perm8(int g) {
  return (g >> 1) | ((g & 1) << 2);
}

// the split of an f32 operand into two TF32 parts (sm90.cuh)
using sm90::split_tf32;

// 16 bytes of shared memory through a generic pointer into it
__device__ __forceinline__ float4 lds128(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_addr(p)));
  return v;
}

__device__ __forceinline__ void sts128(float* p, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1,%2,%3,%4};\n" ::"r"(smem_addr(p)),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

struct TfA {  // an m16n8k8 A fragment, split
  uint32_t big[4], small[4];
};
struct TfB {  // an m16n8k8 B fragment, split
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in split TF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const TfA& a,
                                     const TfB& b) {
  mma_tf32(d, a.small, b.big[0], b.big[1]);
  mma_tf32(d, a.big, b.small[0], b.small[1]);
  mma_tf32(d, a.big, b.big[0], b.big[1]);
}

// acc += t, then t = 0: the products of two k-steps (a score product) or
// of a whole streamed tile (P V, dS K, P^T dO, dS^T Q) are summed on the
// tensor cores into a fresh accumulator t and added to the running sum
// here, an f32 add that rounds to nearest. The tensor cores truncate the
// sums they accumulate, so a running sum chained through every k-step of
// a row (48 mma a score at D = 128, 384 a row of O per 1024 keys) drifts
// toward zero by up to an ulp a step; measured on the card, that was
// several times the error of f32 FMAs and failed phase 6's training
// parity.
__device__ __forceinline__ void add_acc(float (&acc)[4], float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[e] += t[e];
    t[e] = 0.f;
  }
}

// A B operand value: split in registers, or (PRE) its two parts as stored
// by split_tile.
template <bool PRE>
__device__ __forceinline__ void b_parts(float x, float xs, uint32_t& big,
                                        uint32_t& small) {
  if constexpr (PRE) {
    big = __float_as_uint(x);
    small = __float_as_uint(xs);
  } else {
    split_tf32(x, big, small);
  }
}

// Split a streamed tile of N floats once for the whole block: big parts
// to `big`, small parts to `small`.
template <int N>
__device__ __forceinline__ void split_tile(const float* src, float* big,
                                           float* small) {
  for (int i = 4 * threadIdx.x; i < N; i += 4 * kThreads) {
    const float4 x = lds128(src + i);
    uint32_t b[4], s[4];
    split_tf32(x.x, b[0], s[0]);
    split_tf32(x.y, b[1], s[1]);
    split_tf32(x.z, b[2], s[2]);
    split_tf32(x.w, b[3], s[3]);
    sts128(big + i, make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                                __uint_as_float(b[2]), __uint_as_float(b[3])));
    sts128(small + i,
           make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                       __uint_as_float(s[2]), __uint_as_float(s[3])));
  }
}

// A fragments of two k-steps (columns c .. c + 15) over rows r0 .. r0 + 15
// of a row-major tile: lane (g, t) reads rows r0 + perm8(g) and + 8,
// columns c + 4t .. + 3; k-step 0 takes columns 4t, 4t + 1 as its k = t,
// t + 4, k-step 1 columns 4t + 2, 4t + 3.
template <int LD>
__device__ __forceinline__ void ld_a_tf32(TfA (&a)[2], const float* base,
                                          int r0, int c) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const float* p = base + (r0 + perm8(g)) * LD + c + 4 * t;
  const float4 x = lds128(p), y = lds128(p + 8 * LD);
  split_tf32(x.x, a[0].big[0], a[0].small[0]);
  split_tf32(y.x, a[0].big[1], a[0].small[1]);
  split_tf32(x.y, a[0].big[2], a[0].small[2]);
  split_tf32(y.y, a[0].big[3], a[0].small[3]);
  split_tf32(x.z, a[1].big[0], a[1].small[0]);
  split_tf32(y.z, a[1].big[1], a[1].small[1]);
  split_tf32(x.w, a[1].big[2], a[1].small[2]);
  split_tf32(y.w, a[1].big[3], a[1].small[3]);
}

// B fragments of two k-steps (columns c .. c + 15) for the n-tile of rows
// n0 .. n0 + 7 of a row-major tile, read as B^T (Q K^T, dO V^T, K Q^T,
// V dO^T): lane (g, t) reads row n0 + perm8(g), columns c + 4t .. + 3 (of
// the big and small tiles when PRE).
template <int LD, bool PRE>
__device__ __forceinline__ void ld_bt_tf32(TfB (&b)[2], const float* base,
                                           const float* small, int n0,
                                           int c) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int off = (n0 + perm8(g)) * LD + c + 4 * t;
  const float4 x = lds128(base + off);
  const float4 xs = PRE ? lds128(small + off) : x;
  b_parts<PRE>(x.x, xs.x, b[0].big[0], b[0].small[0]);
  b_parts<PRE>(x.y, xs.y, b[0].big[1], b[0].small[1]);
  b_parts<PRE>(x.z, xs.z, b[1].big[0], b[1].small[0]);
  b_parts<PRE>(x.w, xs.w, b[1].big[1], b[1].small[1]);
}

// B fragments of the four n-tiles of the output columns c .. c + 31 at the
// k-step of rows k0 .. k0 + 7 of a tile stored [k][n] (P V, dS K, P^T dO,
// dS^T Q): lane (g, t) reads rows k0 + t and k0 + t + 4, columns c + C(g)
// .. + 3 (of the big and small tiles when PRE); n-tile i's column g is
// output column c + C(g) + i.
template <int LD, bool PRE>
__device__ __forceinline__ void ld_b_tf32(TfB (&b)[4], const float* base,
                                          const float* small, int k0,
                                          int c) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int off = (k0 + t) * LD + c + 4 * (g >> 1) + 16 * (g & 1);
  const float4 x = lds128(base + off), y = lds128(base + off + 4 * LD);
  const float4 xs = PRE ? lds128(small + off) : x;
  const float4 ys = PRE ? lds128(small + off + 4 * LD) : y;
  b_parts<PRE>(x.x, xs.x, b[0].big[0], b[0].small[0]);
  b_parts<PRE>(y.x, ys.x, b[0].big[1], b[0].small[1]);
  b_parts<PRE>(x.y, xs.y, b[1].big[0], b[1].small[0]);
  b_parts<PRE>(y.y, ys.y, b[1].big[1], b[1].small[1]);
  b_parts<PRE>(x.z, xs.z, b[2].big[0], b[2].small[0]);
  b_parts<PRE>(y.z, ys.z, b[2].big[1], b[2].small[1]);
  b_parts<PRE>(x.w, xs.w, b[3].big[0], b[3].small[0]);
  b_parts<PRE>(y.w, ys.w, b[3].big[1], b[3].small[1]);
}

// A streamed tile as the warps read it: raw (split as read), or its big
// and small parts (PRE).
struct TfTile {
  const float *big, *small;
  __device__ TfTile cols(int c) const {
    return {big + c, small == nullptr ? nullptr : small + c};
  }
};

// acc (16 x 8 NT) += A (rows r0 .. r0 + 15 of a row-major tile) . B^T
// (8 NT rows of a row-major streamed tile), both K wide: the score products
template <int NT, int K, int LD, bool PRE>
__device__ __forceinline__ void warp_abt_tf32(float (&acc)[NT][4],
                                              const float* A, int r0,
                                              TfTile B) {
#pragma unroll 1
  for (int c = 0; c < K; c += 16) {
    TfA a[2];
    ld_a_tf32<LD>(a, A, r0, c);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      TfB b[2];
      ld_bt_tf32<LD, PRE>(b, B.big, B.small, 8 * j, c);
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma3(t, a[0], b[0]);
      mma3(t, a[1], b[1]);
      add_acc(acc[j], t);
    }
  }
}

// acc (16 x 8 NO, columns permuted in groups of 32) += P (16 x 8 NK, score
// accumulator registers, split once) . B (a streamed tile stored [k][n],
// from its output column 0): P V, dS K, P^T dO, dS^T Q. Each group of 4
// n-tiles sums the whole tile on fresh accumulators (see add_acc).
template <int NO, int NK, int LD, bool PRE>
__device__ __forceinline__ void warp_pb_tf32(float (&acc)[NO][4],
                                             const float (&p)[NK][4],
                                             TfTile B) {
  TfA a[NK];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    split_tf32(p[kk][0], a[kk].big[0], a[kk].small[0]);
    split_tf32(p[kk][2], a[kk].big[1], a[kk].small[1]);
    split_tf32(p[kk][1], a[kk].big[2], a[kk].small[2]);
    split_tf32(p[kk][3], a[kk].big[3], a[kk].small[3]);
  }
#pragma unroll
  for (int q = 0; q < NO / 4; ++q) {
    float t[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      TfB b[4];
      ld_b_tf32<LD, PRE>(b, B.big, B.small, 8 * kk, 32 * q);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma3(t[i], a[kk], b[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) add_acc(acc[4 * q + i], t[i]);
  }
}

// Store a warp's accumulator (times `mul`) as f32 into rows `row` and
// row + 8, columns c0 .. c0 + 8 NO of a (b, h, t) strided output, the
// column permutation undone: two float4 per group of 32 columns and row.
template <int NO>
__device__ __forceinline__ void store_acc_tf32(const float (&acc)[NO][4],
                                               float mul, void* out,
                                               const Strides& st, int b,
                                               int h, int row, int c0) {
  const int t = threadIdx.x % 4;
  float* base = static_cast<float*>(out) + (long long)b * st.b +
                (long long)h * st.h + c0 + 4 * t;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    float* p = base + (long long)(row + 8 * hi) * st.t;
#pragma unroll
    for (int q = 0; q < NO / 4; ++q) {
      const int e = 2 * hi;
      *reinterpret_cast<float4*>(p + 32 * q) = make_float4(
          acc[4 * q][e] * mul, acc[4 * q + 1][e] * mul,
          acc[4 * q + 2][e] * mul, acc[4 * q + 3][e] * mul);
      *reinterpret_cast<float4*>(p + 32 * q + 16) = make_float4(
          acc[4 * q][e + 1] * mul, acc[4 * q + 1][e + 1] * mul,
          acc[4 * q + 2][e + 1] * mul, acc[4 * q + 3][e + 1] * mul);
    }
  }
}

// Start the 16-byte copies of ROWS rows of W floats (row r at
// src + r * stride_t) into a shared tile with rows of LD floats.
template <int ROWS, int W, int LD>
__device__ __forceinline__ void stage16(float* dst, const float* src,
                                        long long stride_t) {
  constexpr int vpr = W / 4;
  for (int i = threadIdx.x; i < ROWS * vpr; i += kThreads) {
    const int r = i / vpr, c = i % vpr;
    cp_async16(dst + r * LD + 4 * c, src + (long long)r * stride_t + 4 * c);
  }
}

// The streamed pair of one stage as the warps read it, with the streamed
// rows' L and dsum (dK/dV).
struct TfStage {
  TfTile tile[2];
  const float *L, *Ds;
};

// The block's own tiles (own0, own1: Q and dO, or K and V; the forward
// uses own0 only); two stages, each holding the streamed pair raw (K and
// V, or Q and dO; the forward's V tile holds kTfCols columns, rows of LD1)
// and the streamed rows' L and dsum (dK/dV); when PRE the split parts of
// the current pair and a copy of its L and dsum. Stage s starts at
// stages + s * kStage.
template <int D, bool FWD>
struct TfSmem {
  static constexpr int KB = tf_kb(FWD, D), LD = tf_ld(D);
  static constexpr int LD1 = FWD ? tf_ld(kTfCols) : LD;
  static constexpr bool PRE = tf_presplit(FWD, D);
  static constexpr int kT0 = KB * LD, kT1 = KB * LD1;  // floats a tile
  static constexpr int kStage = (kT0 + kT1 + 2 * KB + 31) / 32 * 32;
  float *own0, *own1, *stages;
  float *big0 = nullptr, *small0 = nullptr, *big1 = nullptr,
        *small1 = nullptr, *ls = nullptr, *ds = nullptr;
  __host__ __device__ static size_t carve(Carver& c, TfSmem* t) {
    TfSmem x;
    x.own0 = c.take<float>(kTfBlk * LD);
    x.own1 = FWD ? nullptr : c.take<float>(kTfBlk * LD);
    x.stages = c.take<float>(2 * kStage);
    if (PRE) {
      x.big0 = c.take<float>(kT0);
      x.small0 = c.take<float>(kT0);
      x.big1 = c.take<float>(kT1);
      x.small1 = c.take<float>(kT1);
      x.ls = c.take<float>(KB);
      x.ds = c.take<float>(KB);
    }
    if (t) *t = x;
    return c.off;
  }
  __device__ float* raw0(int s) const { return stages + s * kStage; }
  __device__ float* raw1(int s) const { return raw0(s) + kT0; }
  __device__ float* lse(int s) const { return raw1(s) + kT1; }
  __device__ float* dsum(int s) const { return lse(s) + KB; }
};

// One step of the streamed loop, between the arrival of stage s and its
// use: the barrier that makes the stage visible (and, when PRE, frees the
// split tiles of the previous step), then, when PRE, the block's split
// pass with L and dsum copied beside it, and the barrier after it.
template <class Sm>
__device__ __forceinline__ TfStage tf_ready(const Sm& sm, int s) {
  __syncthreads();
  if constexpr (Sm::PRE) {
    split_tile<Sm::kT0>(sm.raw0(s), sm.big0, sm.small0);
    split_tile<Sm::kT1>(sm.raw1(s), sm.big1, sm.small1);
    if (threadIdx.x < Sm::KB) {
      sm.ls[threadIdx.x] = sm.lse(s)[threadIdx.x];
      sm.ds[threadIdx.x] = sm.dsum(s)[threadIdx.x];
    }
    __syncthreads();
    return {{{sm.big0, sm.small0}, {sm.big1, sm.small1}}, sm.ls, sm.ds};
  } else {
    return {{{sm.raw0(s), nullptr}, {sm.raw1(s), nullptr}}, sm.lse(s),
            sm.dsum(s)};
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tf32_kernel(const Args a) {
  using Sm = TfSmem<D, true>;
  constexpr int BLK = kTfBlk, KB = Sm::KB, LD = Sm::LD, LDV = Sm::LD1;
  constexpr int NO = kTfCols / 8, NS = KB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  Sm sm;
  Sm::carve(cv, &sm);
  const int qi = gridDim.y - 1 - blockIdx.y, bh = blockIdx.x;
  const int c0 = kTfCols * blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, q0 = qi * BLK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int t = l % 4, r0 = 16 * warp;
  const int row = q0 + r0 + perm8(l / 4);  // this lane's rows: row, row + 8
  // key tiles strictly above the diagonal contribute nothing
  const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB;
  auto stage_kv = [&](int kj) {
    if (kj < nk) {
      const int k0 = kj * KB;
      stage16<KB, D, LD>(sm.raw0(kj & 1),
                         row_ptr<float>(a.k, a.sk, b, h, k0), a.sk.t);
      stage16<KB, kTfCols, LDV>(sm.raw1(kj & 1),
                                row_ptr<float>(a.v, a.sv, b, h, k0) + c0,
                                a.sv.t);
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  stage16<BLK, D, LD>(sm.own0, row_ptr<float>(a.q, a.sq, b, h, q0),
                      a.sq.t);
  stage_kv(0);
  float o[NO][4], m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
  zero_acc(o);
  for (int kj = 0; kj < nk; ++kj) {
    stage_kv(kj + 1);
    cp_async_wait<1>();
    const TfStage kv = tf_ready(sm, kj & 1);
    const int k0 = kj * KB;
    // a tile wholly after the diagonal of this warp's 16 rows adds nothing
    if (!a.causal || k0 <= q0 + r0 + 15) {
      float s[NS][4];
      zero_acc(s);
      warp_abt_tf32<NS, D, LD, Sm::PRE>(s, sm.own0, r0, kv.tile[0]);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * a.scale;
          const int key = k0 + 8 * j + t + 4 * (e & 1);
          if (a.causal && key > row + 8 * (e >> 1)) x = kNegInf;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
        lsum[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // masked entries stay exactly 0, also on rows masked so far
          const float x = s[j][e];
          const float p = x <= kNegInf * 0.5f ? 0.f : expf(x - m[e >> 1]);
          s[j][e] = p;
          lsum[e >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
      warp_pb_tf32<NO, NS, LDV, Sm::PRE>(o, s, kv.tile[1]);
    }
    // without PRE the raw stage is read until here: restaged two tiles on
    if constexpr (!Sm::PRE) __syncthreads();
  }
  cp_async_wait<0>();
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] = quad_sum(lsum[i]);
    inv[i] = lsum[i] > 0.f ? 1.f / lsum[i] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= inv[e >> 1];  // l == 0 gives 0
  store_acc_tf32(o, 1.f, a.out0, a.so0, b, h, row, c0);
  if (a.lse != nullptr && blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a.lse[(long long)bh * a.Tq + row + 8 * i] =
          lsum[i] > 0.f ? m[i] + logf(lsum[i]) : kNegInf;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tf32_kernel(const Args a) {
  using Sm = TfSmem<D, false>;
  constexpr int BLK = kTfBlk, KB = Sm::KB, LD = Sm::LD;
  constexpr int NO = kTfCols / 8, NS = KB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  Sm sm;  // own: Q, dO; streamed: K, V
  Sm::carve(cv, &sm);
  const int qi = gridDim.y - 1 - blockIdx.y, bh = blockIdx.x;
  const int c0 = kTfCols * blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, q0 = qi * BLK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int t = l % 4, r0 = 16 * warp;
  const int row = q0 + r0 + perm8(l / 4);  // this lane's rows: row, row + 8
  const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB;
  auto stage_kv = [&](int kj) {
    if (kj < nk) {
      const int k0 = kj * KB;
      stage16<KB, D, LD>(sm.raw0(kj & 1),
                         row_ptr<float>(a.k, a.sk, b, h, k0), a.sk.t);
      stage16<KB, D, LD>(sm.raw1(kj & 1),
                         row_ptr<float>(a.v, a.sv, b, h, k0), a.sv.t);
    }
    cp_async_commit();
  };
  stage16<BLK, D, LD>(sm.own0, row_ptr<float>(a.q, a.sq, b, h, q0),
                      a.sq.t);
  stage16<BLK, D, LD>(sm.own1, row_ptr<float>(a.dO, a.sdo, b, h, q0),
                      a.sdo.t);
  stage_kv(0);
  float lse[2], dsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = a.lse[(long long)bh * a.Tq + row + 8 * i];
    dsum[i] = a.dsum[(long long)bh * a.Tq + row + 8 * i];
  }
  float dq[NO][4];
  zero_acc(dq);
  for (int kj = 0; kj < nk; ++kj) {
    stage_kv(kj + 1);
    cp_async_wait<1>();
    const TfStage kv = tf_ready(sm, kj & 1);
    const int k0 = kj * KB;
    if (!a.causal || k0 <= q0 + r0 + 15) {
      float s[NS][4], dp[NS][4];
      zero_acc(s);
      zero_acc(dp);
      warp_abt_tf32<NS, D, LD, Sm::PRE>(s, sm.own0, r0, kv.tile[0]);  // Q K^T
      warp_abt_tf32<NS, D, LD, Sm::PRE>(dp, sm.own1, r0,
                                        kv.tile[1]);  // dO V^T
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float x = s[j][e] * a.scale;
          if (a.causal && k0 + 8 * j + t + 4 * (e & 1) > row + 8 * i)
            x = kNegInf;
          const float p = x <= kNegInf * 0.5f ? 0.f : expf(x - lse[i]);
          s[j][e] = p * (dp[j][e] - dsum[i]);  // dS
        }
      // dS K, this block's columns
      warp_pb_tf32<NO, NS, LD, Sm::PRE>(dq, s, kv.tile[0].cols(c0));
    }
    if constexpr (!Sm::PRE) __syncthreads();
  }
  cp_async_wait<0>();
  store_acc_tf32(dq, a.scale, a.out0, a.so0, b, h, row, c0);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_tf32_kernel(const Args a) {
  using Sm = TfSmem<D, false>;
  constexpr int BLK = kTfBlk, KB = Sm::KB, LD = Sm::LD;
  constexpr int NO = kTfCols / 8, NS = KB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  Sm sm;  // own: K, V; streamed: Q, dO with their L and dsum
  Sm::carve(cv, &sm);
  const int kj = blockIdx.y, bh = blockIdx.x, c0 = kTfCols * blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, k0 = kj * BLK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int t = l % 4, r0 = 16 * warp;
  const int key = k0 + r0 + perm8(l / 4);  // this lane's rows: key, key + 8
  const int q_first = a.causal ? k0 / KB : 0;  // earlier query tiles see none
  const int nq = a.Tq / KB;
  auto stage_q = [&](int qi) {
    if (qi < nq) {
      const int s = (qi - q_first) & 1;
      stage16<KB, D, LD>(sm.raw0(s),
                         row_ptr<float>(a.q, a.sq, b, h, qi * KB), a.sq.t);
      stage16<KB, D, LD>(sm.raw1(s),
                         row_ptr<float>(a.dO, a.sdo, b, h, qi * KB), a.sdo.t);
      stage_f32_row<KB>(sm.lse(s), a.lse + (long long)bh * a.Tq + qi * KB);
      stage_f32_row<KB>(sm.dsum(s), a.dsum + (long long)bh * a.Tq + qi * KB);
    }
    cp_async_commit();
  };
  stage16<BLK, D, LD>(sm.own0, row_ptr<float>(a.k, a.sk, b, h, k0),
                      a.sk.t);
  stage16<BLK, D, LD>(sm.own1, row_ptr<float>(a.v, a.sv, b, h, k0),
                      a.sv.t);
  stage_q(q_first);
  float dk[NO][4], dv[NO][4];
  zero_acc(dk);
  zero_acc(dv);
  for (int qi = q_first; qi < nq; ++qi) {
    stage_q(qi + 1);
    cp_async_wait<1>();
    const TfStage st = tf_ready(sm, (qi - q_first) & 1);  // Q, dO
    const float* Ls = st.L;
    const float* Ds = st.Ds;
    const int q0 = qi * KB;
    // a tile of queries wholly before this warp's 16 keys sees none of them
    if (!a.causal || q0 + KB - 1 >= k0 + r0) {
      // rows of these tiles are keys, columns queries
      float s[NS][4], dp[NS][4];
      zero_acc(dp);
      warp_abt_tf32<NS, D, LD, Sm::PRE>(dp, sm.own1, r0,
                                        st.tile[1]);  // V dO^T = dP^T
      zero_acc(s);
      warp_abt_tf32<NS, D, LD, Sm::PRE>(s, sm.own0, r0,
                                        st.tile[0]);  // K Q^T = S^T
      // P^T into s, dS^T into dp (so that P^T dies with the dV product)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + t + 4 * (e & 1);
          float x = s[j][e] * a.scale;
          if (a.causal && key + 8 * (e >> 1) > q0 + col) x = kNegInf;
          s[j][e] = x <= kNegInf * 0.5f ? 0.f : expf(x - Ls[col]);
          dp[j][e] = s[j][e] * (dp[j][e] - Ds[col]);
        }
      // P^T dO and dS^T Q, this block's columns
      warp_pb_tf32<NO, NS, LD, Sm::PRE>(dv, s, st.tile[1].cols(c0));
      warp_pb_tf32<NO, NS, LD, Sm::PRE>(dk, dp, st.tile[0].cols(c0));
    }
    if constexpr (!Sm::PRE) __syncthreads();
  }
  cp_async_wait<0>();
  store_acc_tf32(dk, a.scale, a.out0, a.so0, b, h, key, c0);
  store_acc_tf32(dv, 1.f, a.out1, a.so1, b, h, key, c0);
}

// ------------------------------------------------------------- launches
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// The kernel family that runs (kind, dtype, D): 0 the f32 scalar
// backward (D = 384, 512), 1 split TF32, 2 bf16 mma.sync, 3 bf16 wgmma.
enum Route { kScalar = 0, kTf32 = 1, kMma = 2, kWgmma = 3 };
__host__ __device__ constexpr int route_of(int kind, int dtype, int D) {
  if (dtype == 1) return D == 128 ? kWgmma : kMma;
  return kind == kFwd || D <= 256 ? kTf32 : kScalar;
}

template <int D>
size_t smem_f32(int kind) {
  Carver c{nullptr};
  if (kind == kFwd) return TfSmem<D, true>::carve(c, nullptr);
  if constexpr (route_of(kDq, 0, D) == kTf32)
    return TfSmem<D, false>::carve(c, nullptr);
  else
    return BwdSmem<D>::carve(c, nullptr, kind == kDkv);
}

template <int D>
size_t smem_bf16(int kind) {
  Carver c{nullptr};
  if (D == 128)
    return kind == kFwd ? kWgSmemBytes
           : kind == kDq ? kDqSmemBytes
                         : kDkvSmemBytes;
  return kind == kFwd ? MmaFwdSmem<D, mma_cols(1, D)>::carve(c, nullptr)
                      : MmaBwdSmem<D>::carve(c, nullptr);
}

// The bf16 D = 128 kernels read each input through one 4-D tensor map
// over (D, H, T, B) with the tensor's own strides (16-byte multiples,
// checked by the wrapper), boxes of 64 x 1 x `rows` x 1, built at each
// call.
int make_bthd_map(CUtensorMap* map, const void* base, const Strides& s,
                  int H, int T, int B, int rows) {
  const cuuint64_t dims[4] = {128, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.t * 2,
                               (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return sm90::make_map_bf16(map, base, 4, dims, bytes, box);
}

int launch_fwd_wgmma(const Args& a, cudaStream_t st) {
  CUtensorMap maps[3];
  int rc = make_bthd_map(&maps[0], a.q, a.sq, a.H, a.Tq, a.B, kWgRows);
  if (!rc) rc = make_bthd_map(&maps[1], a.k, a.sk, a.H, a.Tk, a.B, kWgRows);
  if (!rc) rc = make_bthd_map(&maps[2], a.v, a.sv, a.H, a.Tk, a.B, kWgRows);
  if (rc) return rc;
  const WgFwdArgs w{a.out0, a.lse, a.so0, a.H, a.Tq, a.Tk, a.causal,
                    a.scale * kLog2e};
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWgSmemBytes);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_wgmma_kernel<<<dim3(a.Tq / kWgRows, a.B * a.H), kWgThreads,
                           kWgSmemBytes, st>>>(maps[0], maps[1], maps[2], w);
  return (int)cudaGetLastError();
}

// The bf16 D = 128 backward: dQ blocks of 128 query rows (Q and dO maps
// with 128-row boxes), dK/dV blocks of 64 keys; streamed tiles of 64 rows.
int launch_bwd_wgmma(int kind, const Args& a, cudaStream_t st) {
  const bool dq = kind == kDq;
  const int own = dq ? kWgRows : kBwRows;
  CUtensorMap maps[4];  // q, dO, k, v
  int rc = make_bthd_map(&maps[0], a.q, a.sq, a.H, a.Tq, a.B, own);
  if (!rc) rc = make_bthd_map(&maps[1], a.dO, a.sdo, a.H, a.Tq, a.B, own);
  if (!rc) rc = make_bthd_map(&maps[2], a.k, a.sk, a.H, a.Tk, a.B, kBwRows);
  if (!rc) rc = make_bthd_map(&maps[3], a.v, a.sv, a.H, a.Tk, a.B, kBwRows);
  if (rc) return rc;
  const WgBwdArgs w{a.lse, a.dsum, a.out0, a.out1, a.so0, a.so1, a.H,
                    a.Tq, a.Tk, a.causal, a.scale, a.scale * kLog2e};
  const size_t smem = dq ? kDqSmemBytes : kDkvSmemBytes;
  cudaError_t e = dq ? cudaFuncSetAttribute(
                           flash_bwd_dq_wgmma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem)
                     : cudaFuncSetAttribute(
                           flash_bwd_dkv_wgmma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.B * a.H, dq ? a.Tq / kWgRows : a.Tk / kBwRows);
  if (dq)
    flash_bwd_dq_wgmma_kernel<<<grid, kWgThreads, smem, st>>>(
        maps[0], maps[1], maps[2], maps[3], w);
  else
    flash_bwd_dkv_wgmma_kernel<<<grid, kWgThreads, smem, st>>>(
        maps[0], maps[1], maps[2], maps[3], w);
  return (int)cudaGetLastError();
}

int run(void (*kern)(const Args), size_t smem, dim3 grid, const Args& a,
        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Split TF32: blocks of kTfBlk rows, grid (B * H, row tiles, column
// blocks of kTfCols); the scalar backward: grid (row tiles, B * H).
template <int D>
int launch_f32(int kind, const Args& a, cudaStream_t st) {
  const int rows = kind == kDkv ? a.Tk : a.Tq;
  const size_t smem = smem_f32<D>(kind);
  const dim3 grid(a.B * a.H, rows / kTfBlk, D / kTfCols);
  if (kind == kFwd) return run(flash_fwd_tf32_kernel<D>, smem, grid, a, st);
  if constexpr (route_of(kDq, 0, D) == kTf32)
    return run(kind == kDq ? flash_bwd_dq_tf32_kernel<D>
                           : flash_bwd_dkv_tf32_kernel<D>,
               smem, grid, a, st);
  else
    return run(kind == kDq ? flash_bwd_dq_kernel<D> : flash_bwd_dkv_kernel<D>,
               smem, dim3(rows / kF32Blk, a.B * a.H), a, st);
}

template <int D>
int launch_bf16(int kind, const Args& a, cudaStream_t st) {
  if constexpr (D == 128) {
    return kind == kFwd ? launch_fwd_wgmma(a, st)
                        : launch_bwd_wgmma(kind, a, st);
  } else {
    constexpr int DF = mma_cols(1, D), DB = mma_cols(0, D);
    void (*kern)(const Args) = kind == kFwd  ? flash_fwd_mma_kernel<D, DF>
                               : kind == kDq ? flash_bwd_dq_mma_kernel<D, DB>
                                             : flash_bwd_dkv_mma_kernel<D, DB>;
    const dim3 grid((kind == kDkv ? a.Tk : a.Tq) / kMmaBlk, a.B * a.H,
                    D / (kind == kFwd ? DF : DB));
    return run(kern, smem_bf16<D>(kind), grid, a, st);
  }
}

// The head dims the kernels are built for: the multiples of 128 up to 512.
template <typename F>
int with_head_dim(int D, F f) {
  switch (D) {
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 384: return f(std::integral_constant<int, 384>{});
    case 512: return f(std::integral_constant<int, 512>{});
  }
  return -1;
}

int dispatch(int kind, int dtype, int D, const Args& a, cudaStream_t st) {
  const int rc = with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return dtype == 1 ? launch_bf16<kD>(kind, a, st)
                      : launch_f32<kD>(kind, a, st);
  });
  return rc < 0 ? (int)cudaErrorInvalidValue : rc;
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D in {128, 256, 384, 512}. `strides`
// holds the (b, t, h) element strides of each tensor argument in order. Each entry
// returns the cudaError_t of its launch.

// O (and L when lse is not null) from q, k, v. strides: q, k, v, o.
int dl4j_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   float* lse, const long long* strides, int dtype, int B,
                   int H, int Tq, int Tk, int D, int causal, float scale,
                   void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.out0 = o, a.lse = lse;
  a.sq = strides_at(strides, 0), a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2), a.so0 = strides_at(strides, 3);
  a.B = B, a.H = H, a.Tq = Tq, a.Tk = Tk, a.causal = causal, a.scale = scale;
  return dispatch(kFwd, dtype, D, a, static_cast<cudaStream_t>(stream));
}

// dQ. strides: q, k, v, dO, dQ.
int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dO, const float* lse, const float* dsum,
                      void* dq, const long long* strides, int dtype, int B,
                      int H, int Tq, int Tk, int D, int causal, float scale,
                      void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dO = dO, a.out0 = dq;
  a.lse = const_cast<float*>(lse), a.dsum = dsum;
  a.sq = strides_at(strides, 0), a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2), a.sdo = strides_at(strides, 3);
  a.so0 = strides_at(strides, 4);
  a.B = B, a.H = H, a.Tq = Tq, a.Tk = Tk, a.causal = causal, a.scale = scale;
  return dispatch(kDq, dtype, D, a, static_cast<cudaStream_t>(stream));
}

// dK and dV. strides: q, k, v, dO, dK, dV.
int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dO, const float* lse, const float* dsum,
                       void* dk, void* dv, const long long* strides,
                       int dtype, int B, int H, int Tq, int Tk, int D,
                       int causal, float scale, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dO = dO, a.out0 = dk, a.out1 = dv;
  a.lse = const_cast<float*>(lse), a.dsum = dsum;
  a.sq = strides_at(strides, 0), a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2), a.sdo = strides_at(strides, 3);
  a.so0 = strides_at(strides, 4), a.so1 = strides_at(strides, 5);
  a.B = B, a.H = H, a.Tq = Tq, a.Tk = Tk, a.causal = causal, a.scale = scale;
  return dispatch(kDkv, dtype, D, a, static_cast<cudaStream_t>(stream));
}

// Rows per tile, the largest over the family's kernels (the sequence
// lengths must be multiples of it).
int dl4j_flash_block_rows(int dtype, int D) {
  if (dtype != 1) return kTfBlk;
  return D == 128 ? kWgRows : kMmaBlk;
}

// The kernel family that runs kernel `kind` (0 forward, 1 dQ, 2 dK/dV) at
// dtype and D: 0 f32 scalar FMAs, 1 f32 split TF32 on mma.sync, 2 bf16
// mma.sync, 3 bf16 wgmma; -1 for an unsupported D.
int dl4j_flash_route(int kind, int dtype, int D) {
  return with_head_dim(D, [&](auto) { return route_of(kind, dtype, D); });
}

// Dynamic shared memory of one block of kernel `kind` (0 forward, 1 dQ,
// 2 dK/dV), in bytes; 0 for an unsupported D.
size_t dl4j_flash_smem_bytes(int kind, int dtype, int D) {
  const int rc = with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return (int)(dtype == 1 ? smem_bf16<kD>(kind) : smem_f32<kD>(kind));
  });
  return rc < 0 ? 0 : (size_t)rc;
}

}  // extern "C"
