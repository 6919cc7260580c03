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
//  - f32 (the parity path; scalar FMAs, TF32 stays off): 32-row tiles (16
//    at D > 256), f32 accumulators in shared memory.
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

// ================================================== f32 (parity) kernels
// 32-row tiles; operand tiles padded by one float (bank spread), score and
// accumulator rows by four (16-byte aligned for float4 access). Products
// give one thread per output element, neighbouring threads on neighbouring
// columns.
// Rows of a tile: 32, or 16 at D > 256 so that the four staged tiles and
// the two accumulators of the backward fit a block's shared memory.
__host__ __device__ constexpr int f32_blk(int D) { return D > 256 ? 16 : 32; }
constexpr int kAccPad = 4;

template <int D>
struct FwdSmem {
  static constexpr int kBlk = f32_blk(D);
  float *q, *k, *v, *p, *s, *o, *m, *l;
  __host__ __device__ static size_t carve(Carver& c, FwdSmem* t) {
    FwdSmem x;
    x.q = c.take<float>(kBlk * (D + 1));
    x.k = c.take<float>(kBlk * (D + 1));
    x.v = c.take<float>(kBlk * (D + 1));
    x.p = c.take<float>(kBlk * (kBlk + 1));
    x.s = c.take<float>(kBlk * (kBlk + kAccPad));
    x.o = c.take<float>(kBlk * (D + kAccPad));
    x.m = c.take<float>(kBlk);
    x.l = c.take<float>(kBlk);
    if (t) *t = x;
    return c.off;
  }
};

// dQ (rows = query tile, loop over K/V) and dK/dV (rows = key tile, loop
// over Q) share one layout: the block's own two tiles (a, b), the two
// streamed tiles (c, d), scores S and dP, P and dS, two accumulators and
// the per-query-row L and dsum.
template <int D>
struct BwdSmem {
  static constexpr int kBlk = f32_blk(D);
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

template <int TPR>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int TPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Args a) {
  constexpr int kBlk = f32_blk(D), kTpr = tpr(kBlk), kCpt = cpt(kBlk);
  constexpr int ld = D + 1, ldp = kBlk + 1;
  constexpr int lds = kBlk + kAccPad, ldo = D + kAccPad;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  FwdSmem<D> sm;
  FwdSmem<D>::carve(cv, &sm);

  const int qi = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = qi * kBlk;
  const int tid = threadIdx.x;
  // K/V tiles strictly above the diagonal contribute nothing
  const int nk = a.causal ? qi + 1 : a.Tk / kBlk;
  auto stage_k = [&](int kj) {
    if (kj < nk)
      stage<kBlk, D, ld>(sm.k, row_ptr<float>(a.k, a.sk, b, h, kj * kBlk),
                         a.sk.t);
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  auto stage_v = [&](int kj) {
    if (kj < nk)
      stage<kBlk, D, ld>(sm.v, row_ptr<float>(a.v, a.sv, b, h, kj * kBlk),
                         a.sv.t);
    cp_async_commit();
  };
  stage<kBlk, D, ld>(sm.q, row_ptr<float>(a.q, a.sq, b, h, q0), a.sq.t);
  stage_k(0);  // groups in flight: {Q, K0}, V0
  stage_v(0);
  zero<kBlk * ldo>(sm.o);
  for (int r = tid; r < kBlk; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
  // K of the next tile loads while this tile's softmax and P.V run, V of
  // the next tile while its scores run
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * kBlk;
    cp_async_wait<1>();  // K(kj) staged (V(kj) may be in flight)
    __syncthreads();
    mm_abt<kBlk, kBlk, D>(sm.s, lds, sm.q, ld, sm.k, ld);
    __syncthreads();  // K free
    stage_k(kj + 1);
    {  // online softmax over this tile; row r's O rescaled by its corr
      constexpr int OPT = D / kTpr;  // O columns per thread
      const int r = tid / kTpr, part = tid % kTpr, c0 = part * kCpt;
      float v[kCpt];
      load_cols(v, sm.s + r * lds + c0);
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCpt; ++j) {
        float s = v[j] * a.scale;
        if (a.causal && k0 + c0 + j > q0 + r) s = kNegInf;
        v[j] = s;
        mx = fmaxf(mx, s);
      }
      const float m_prev = sm.m[r], l_prev = sm.l[r];
      const float m_new = fmaxf(m_prev, group_max<kTpr>(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCpt; ++j) {
        // masked entries stay exactly 0, also on rows masked so far
        v[j] = v[j] <= kNegInf * 0.5f ? 0.f : expf(v[j] - m_new);
        sum += v[j];
      }
      store_cols(sm.p + r * ldp + c0, v);
      sum = group_sum<kTpr>(sum);  // every thread of the row has read m, l
      const float corr = expf(m_prev - m_new);
      if (part == 0) {
        sm.l[r] = l_prev * corr + sum;
        sm.m[r] = m_new;
      }
      float* orow = sm.o + r * ldo + part * OPT;
#pragma unroll
      for (int j = 0; j < OPT; j += 4) {
        float4 x = *reinterpret_cast<float4*>(orow + j);
        x.x *= corr, x.y *= corr, x.z *= corr, x.w *= corr;
        *reinterpret_cast<float4*>(orow + j) = x;
      }
    }
    cp_async_wait<1>();  // V(kj) staged (K(kj + 1) may be in flight)
    __syncthreads();
    mm_ab_acc<kBlk, D, kBlk>(sm.o, ldo, sm.p, ldp, sm.v, ld);
    __syncthreads();  // V free
    stage_v(kj + 1);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* out = static_cast<float*>(a.out0);
  for (int i = tid; i < kBlk * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const float l = sm.l[r];
    out[(long long)b * a.so0.b + (long long)h * a.so0.h +
        (long long)(q0 + r) * a.so0.t + c] =
        l > 0.f ? sm.o[r * ldo + c] / l : 0.f;
  }
  if (a.lse != nullptr) {
    for (int r = tid; r < kBlk; r += kThreads) {
      const float l = sm.l[r];
      a.lse[(long long)bh * a.Tq + q0 + r] =
          l > 0.f ? sm.m[r] + logf(l) : kNegInf;
    }
  }
}

// P = exp(S * scale - L) (masked entries 0) and dS = P * (dP - dsum) for a
// (kBlk query rows) x (kBlk key columns) tile (the Pallas kernels' _tile_p).
template <int D>
__device__ __forceinline__ void p_and_ds(const BwdSmem<D>& sm, const Args& a,
                                         int q0, int k0) {
  constexpr int kBlk = f32_blk(D), kTpr = tpr(kBlk), kCpt = cpt(kBlk);
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
  constexpr int kBlk = f32_blk(D);
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
  constexpr int kBlk = f32_blk(D);
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

// ------------------------------------------------------------- launches
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
size_t smem_f32(int kind) {
  Carver c{nullptr};
  return kind == kFwd ? FwdSmem<D>::carve(c, nullptr)
                      : BwdSmem<D>::carve(c, nullptr, kind == kDkv);
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

template <int D>
int launch_f32(int kind, const Args& a, cudaStream_t st) {
  void (*kern)(const Args) = kind == kFwd  ? flash_fwd_kernel<D>
                             : kind == kDq ? flash_bwd_dq_kernel<D>
                                           : flash_bwd_dkv_kernel<D>;
  const dim3 grid((kind == kDkv ? a.Tk : a.Tq) / f32_blk(D), a.B * a.H);
  return run(kern, smem_f32<D>(kind), grid, a, st);
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
  if (dtype != 1) return f32_blk(D);
  return D == 128 ? kWgRows : kMmaBlk;
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
