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
// carried across grid steps (m, l, acc) lives on chip. One block of 4 warps
// per (b*h, tile of rows), tiles staged with cp.async into rows padded for
// bank spread, the next streamed tile in flight while this one is
// computed. Under the causal mask a block visits only the tiles on or below
// the diagonal (the Pallas kernels' _causal_needed_kv skip). Two families:
//  - bf16 (D = 128 and 256): each warp owns 16 rows of a 64-row tile and
//    keeps its scores and accumulators in registers; products are mma.sync
//    m16n8k16 on the tensor cores fed by ldmatrix, and a score tile's
//    registers are re-packed as the A operand of the next product without a
//    trip through shared memory. At D = 256 the backward kernels split
//    their output columns over two blocks (grid z), each recomputing the
//    scores, so every thread holds at most 2 x 64 accumulator registers, as
//    at D = 128;
//  - f32 (the parity path; scalar FMAs, TF32 stays off): 32-row tiles, f32
//    accumulators in shared memory.
//
// What bounds it on an H100: at the training shape (T = 4096, D = 128) the
// work is far above the card's ridge (about 2 * D * T / 2 flops per byte
// of Q, K, V read), so it is bounded by operations, 989 TFLOP/s in bf16.
// mma.sync reaches a fraction of that; wgmma with TMA staging into a ring
// of buffers and warp specialization is the later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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
constexpr int kBlk = 32;
constexpr int kAccPad = 4;

template <int D>
struct FwdSmem {
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

// Row-wise passes (softmax, P and dS) give each row of the tile to kTpr
// neighbouring threads of one warp, each owning kCpt consecutive columns
// kept in registers: loads, math and stores of a thread are independent,
// so their latencies overlap.
constexpr int kTpr = kThreads / kBlk;
constexpr int kCpt = kBlk / kTpr;

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = kTpr / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kTpr / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kCpt consecutive f32 of shared memory (16-byte aligned) into registers
__device__ __forceinline__ void load_cols(float (&v)[kCpt], const float* p) {
#pragma unroll
  for (int j = 0; j < kCpt; j += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + j);
    v[j] = x.x, v[j + 1] = x.y, v[j + 2] = x.z, v[j + 3] = x.w;
  }
}

__device__ __forceinline__ void store_cols(float* p, const float (&v)[kCpt]) {
#pragma unroll
  for (int j = 0; j < kCpt; ++j) p[j] = v[j];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Args a) {
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
      const float m_new = fmaxf(m_prev, group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCpt; ++j) {
        // masked entries stay exactly 0, also on rows masked so far
        v[j] = v[j] <= kNegInf * 0.5f ? 0.f : expf(v[j] - m_new);
        sum += v[j];
      }
      store_cols(sm.p + r * ldp + c0, v);
      sum = group_sum(sum);  // every thread of the row has read m, l
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

template <int D>
struct MmaFwdSmem {
  bf16 *q, *k[2], *v[2];
  __host__ __device__ static size_t carve(Carver& c, MmaFwdSmem* t) {
    MmaFwdSmem x;
    x.q = c.take<bf16>(kMmaBlk * (D + 8));
    for (int i = 0; i < 2; ++i) {
      x.k[i] = c.take<bf16>(kMmaBlk * (D + 8));
      x.v[i] = c.take<bf16>(kMmaBlk * (D + 8));
    }
    if (t) *t = x;
    return c.off;
  }
};

// The block's own two tiles (a, b) and two buffers of the streamed pair
// (c, d) with the streamed rows' L and dsum (dK/dV only).
template <int D>
struct MmaBwdSmem {
  bf16 *a, *b, *c[2], *d[2];
  float *lse[2], *dsum[2];
  __host__ __device__ static size_t carve(Carver& c, MmaBwdSmem* t) {
    MmaBwdSmem x;
    x.a = c.take<bf16>(kMmaBlk * (D + 8));
    x.b = c.take<bf16>(kMmaBlk * (D + 8));
    for (int i = 0; i < 2; ++i) {
      x.c[i] = c.take<bf16>(kMmaBlk * (D + 8));
      x.d[i] = c.take<bf16>(kMmaBlk * (D + 8));
      x.lse[i] = c.take<float>(kMmaBlk);
      x.dsum[i] = c.take<float>(kMmaBlk);
    }
    if (t) *t = x;
    return c.off;
  }
};

__device__ __forceinline__ void stage_f32_row(float* dst, const float* src) {
  for (int i = threadIdx.x; i < kMmaBlk / 4; i += kThreads)
    cp_async16(dst + 4 * i, src + 4 * i);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const Args a) {
  constexpr int BLK = kMmaBlk, LD = D + 8, NO = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  MmaFwdSmem<D> sm;
  MmaFwdSmem<D>::carve(cv, &sm);
  const int qi = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H, q0 = qi * BLK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int g = l / 4, t = l % 4, r0 = 16 * warp;
  const int nk = a.causal ? qi + 1 : a.Tk / BLK;
  auto stage_kv = [&](int kj) {
    if (kj < nk) {
      const int k0 = kj * BLK;
      stage<BLK, D, LD>(sm.k[kj & 1], row_ptr<bf16>(a.k, a.sk, b, h, k0),
                        a.sk.t);
      stage<BLK, D, LD>(sm.v[kj & 1], row_ptr<bf16>(a.v, a.sv, b, h, k0),
                        a.sv.t);
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
    const int k0 = kj * BLK;
    float s[8][4];
    zero_acc(s);
    warp_abt<8, D, LD>(s, sm.q, r0, K);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
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
    for (int j = 0; j < 8; ++j)
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
    warp_pb<NO, 4, LD>(o, s, V);
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
  store_acc(o, 1.f, a.out0, a.so0, b, h, q0 + r0, 0);
  if (a.lse != nullptr && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a.lse[(long long)bh * a.Tq + q0 + r0 + g + 8 * i] =
          lsum[i] > 0.f ? m[i] + logf(lsum[i]) : kNegInf;
  }
}

template <int D, int DO>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma_kernel(const Args a) {
  constexpr int BLK = kMmaBlk, LD = D + 8, NO = DO / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  MmaBwdSmem<D> sm;  // a = Q, b = dO, c = K, d = V
  MmaBwdSmem<D>::carve(cv, &sm);
  const int qi = blockIdx.x, bh = blockIdx.y, c0 = DO * blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, q0 = qi * BLK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int g = l / 4, t = l % 4, r0 = 16 * warp;
  const int nk = a.causal ? qi + 1 : a.Tk / BLK;
  auto stage_kv = [&](int kj) {
    if (kj < nk) {
      const int k0 = kj * BLK;
      stage<BLK, D, LD>(sm.c[kj & 1], row_ptr<bf16>(a.k, a.sk, b, h, k0),
                        a.sk.t);
      stage<BLK, D, LD>(sm.d[kj & 1], row_ptr<bf16>(a.v, a.sv, b, h, k0),
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
    stage_kv(kj + 1);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* K = sm.c[kj & 1];
    const bf16* V = sm.d[kj & 1];
    const int k0 = kj * BLK;
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    warp_abt<8, D, LD>(s, sm.a, r0, K);   // Q K^T
    warp_abt<8, D, LD>(dp, sm.b, r0, V);  // dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = s[j][e] * a.scale;
        if (a.causal && k0 + 8 * j + 2 * t + (e & 1) > q0 + r0 + g + 8 * i)
          x = kNegInf;
        const float p = x <= kNegInf * 0.5f ? 0.f : expf(x - lse[i]);
        s[j][e] = p * (dp[j][e] - dsum[i]);  // dS
      }
    warp_pb<NO, 4, LD>(dq, s, K + c0);  // dS K, this block's columns
    __syncthreads();
  }
  cp_async_wait<0>();
  store_acc(dq, a.scale, a.out0, a.so0, b, h, q0 + r0, c0);
}

template <int D, int DO>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_mma_kernel(const Args a) {
  constexpr int BLK = kMmaBlk, LD = D + 8, NO = DO / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  MmaBwdSmem<D> sm;  // a = K, b = V, c = Q, d = dO
  MmaBwdSmem<D>::carve(cv, &sm);
  const int kj = blockIdx.x, bh = blockIdx.y, c0 = DO * blockIdx.z;
  const int b = bh / a.H, h = bh % a.H, k0 = kj * BLK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int g = l / 4, t = l % 4, r0 = 16 * warp;
  const int q_first = a.causal ? kj : 0;  // earlier query tiles see none
  const int nq = a.Tq / BLK;
  auto stage_q = [&](int qi) {
    if (qi < nq) {
      const int buf = (qi - q_first) & 1;
      stage<BLK, D, LD>(sm.c[buf], row_ptr<bf16>(a.q, a.sq, b, h, qi * BLK),
                        a.sq.t);
      stage<BLK, D, LD>(sm.d[buf], row_ptr<bf16>(a.dO, a.sdo, b, h, qi * BLK),
                        a.sdo.t);
      stage_f32_row(sm.lse[buf], a.lse + (long long)bh * a.Tq + qi * BLK);
      stage_f32_row(sm.dsum[buf], a.dsum + (long long)bh * a.Tq + qi * BLK);
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
    stage_q(qi + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int buf = (qi - q_first) & 1;
    const bf16* Q = sm.c[buf];
    const bf16* dO = sm.d[buf];
    const float* Ls = sm.lse[buf];
    const float* Ds = sm.dsum[buf];
    const int q0 = qi * BLK;
    // rows of these tiles are keys k0 + r0 + (g, g + 8), columns queries
    float s[8][4], dp[8][4];
    zero_acc(dp);
    warp_abt<8, D, LD>(dp, sm.b, r0, dO);  // V dO^T = dP^T
    zero_acc(s);
    warp_abt<8, D, LD>(s, sm.a, r0, Q);    // K Q^T = S^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * a.scale;
        if (a.causal && k0 + r0 + g + 8 * (e >> 1) > q0 + col) x = kNegInf;
        s[j][e] = x <= kNegInf * 0.5f ? 0.f : expf(x - Ls[col]);  // P^T
      }
    warp_pb<NO, 4, LD>(dv, s, dO + c0);  // P^T dO, this block's columns
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] *= dp[j][e] - Ds[8 * j + 2 * t + (e & 1)];  // dS^T
    warp_pb<NO, 4, LD>(dk, s, Q + c0);  // dS^T Q
    __syncthreads();
  }
  cp_async_wait<0>();
  store_acc(dk, a.scale, a.out0, a.so0, b, h, k0 + r0, c0);
  store_acc(dv, 1.f, a.out1, a.so1, b, h, k0 + r0, c0);
}

// ------------------------------------------------------------- launches
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// Output columns one bf16 backward block accumulates: all of D = 128, half
// of D = 256 (two accumulators of 16 x 256 per warp would not fit the
// 255 registers a thread may hold).
constexpr int kMmaOutCols = 128;

template <int D>
size_t smem_f32(int kind) {
  Carver c{nullptr};
  return kind == kFwd ? FwdSmem<D>::carve(c, nullptr)
                      : BwdSmem<D>::carve(c, nullptr, kind == kDkv);
}

template <int D>
size_t smem_bf16(int kind) {
  Carver c{nullptr};
  return kind == kFwd ? MmaFwdSmem<D>::carve(c, nullptr)
                      : MmaBwdSmem<D>::carve(c, nullptr);
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
  const dim3 grid((kind == kDkv ? a.Tk : a.Tq) / kBlk, a.B * a.H);
  return run(kern, smem_f32<D>(kind), grid, a, st);
}

template <int D>
int launch_bf16(int kind, const Args& a, cudaStream_t st) {
  constexpr int DO = kMmaOutCols;
  void (*kern)(const Args) = kind == kFwd  ? flash_fwd_mma_kernel<D>
                             : kind == kDq ? flash_bwd_dq_mma_kernel<D, DO>
                                           : flash_bwd_dkv_mma_kernel<D, DO>;
  const dim3 grid((kind == kDkv ? a.Tk : a.Tq) / kMmaBlk, a.B * a.H,
                  kind == kFwd ? 1 : D / DO);
  return run(kern, smem_bf16<D>(kind), grid, a, st);
}

int dispatch(int kind, int dtype, int D, const Args& a, cudaStream_t st) {
  if (dtype == 1) {
    if (D == 128) return launch_bf16<128>(kind, a, st);
    if (D == 256) return launch_bf16<256>(kind, a, st);
  } else {
    if (D == 128) return launch_f32<128>(kind, a, st);
    if (D == 256) return launch_f32<256>(kind, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D in {128, 256}. `strides` holds the
// (b, t, h) element strides of each tensor argument in order. Each entry
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

// Rows per tile (the sequence lengths must be multiples of it).
int dl4j_flash_block_rows(int dtype, int D) {
  return dtype == 1 ? kMmaBlk : kBlk;
}

// Dynamic shared memory of one block of kernel `kind` (0 forward, 1 dQ,
// 2 dK/dV), in bytes; 0 for an unsupported D.
size_t dl4j_flash_smem_bytes(int kind, int dtype, int D) {
  if (dtype == 1) {
    if (D == 128) return smem_bf16<128>(kind);
    if (D == 256) return smem_bf16<256>(kind);
  } else {
    if (D == 128) return smem_f32<128>(kind);
    if (D == 256) return smem_f32<256>(kind);
  }
  return 0;
}

}  // extern "C"
