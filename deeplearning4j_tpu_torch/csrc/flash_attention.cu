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
//  - bf16 forward at D = 256, 384, 512: flash_fwd_wide_kernel<D>, the same
//    warp specialization over blocks of 64 query rows, whose two consumer
//    warpgroups split D (each owns D / 2 columns of O and computes the
//    partial scores over them; the partials meet in shared memory and are
//    added in one order in both, so both hold the same P; its section
//    says more);
//  - bf16 backward at D = 256: flash_bwd_dq_wide_kernel and
//    flash_bwd_dkv_wide_kernel, the D = 128 backward's structure (a
//    producer warpgroup, two consumer warpgroups) with accumulators over
//    all of D = 256, so each block computes every score once; dQ's two
//    warpgroups take a 64-row block's key tiles in turn and add their
//    partial dQ at the end (their section says why);
//  - bf16 backward (dQ; dK/dV) at D = 384 and 512: flash_bwd_dq_cluster_
//    kernel<D> and flash_bwd_dkv_cluster_kernel<D> ("wgmma cluster"):
//    thread block clusters of two blocks, each the D = 256 backward's
//    structure over one column half (a 64 x D f32 accumulator, 192 or 256
//    registers a thread, does not fit a warpgroup), which add their
//    partial scores through distributed shared memory in one order, so
//    each score is computed once per cluster (their section says more);
//  - f32 (MultiLayerNetwork's default precision): every kernel at every
//    head dim on the tensor cores in split TF32 (three TF32 products per
//    f32 product, f32 accuracy; their section below); at D = 256, 384
//    and 512 the forward, dQ and dK/dV as thread block clusters of D / 128
//    blocks, each block a 128-column slice, which add their partial
//    scores through distributed shared memory (the section after it).
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

template <int N>
__device__ __forceinline__ void stage_f32_row(float* dst, const float* src) {
  for (int i = threadIdx.x; i < N / 4; i += kThreads)
    cp_async16(dst + 4 * i, src + 4 * i);
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

// =============================== bf16 D = 256, 384, 512 forward: wgmma + TMA
// flash_fwd_wide_kernel<D>: blocks of 64 query rows, three warpgroups.
// Warpgroup 2 is the producer: one thread issues every TMA load, Q once,
// then K and V tiles of KB keys (wide_kb: 64 at D = 256, 32 above) into a
// ring of NS stages each (wide_stages), behind full and empty mbarriers,
// each row as D / 64 boxes of 64 columns (128-byte rows, swizzled).
// Warpgroups 0 and 1 (the consumers) split D: warpgroup w owns columns
// w * D / 2 .. + D / 2 of O in registers (64, 96 or 128 f32 a thread) and
// computes the partial score S_w = Q K^T over those columns on wgmma. The
// partials meet in shared memory (double-buffered by tile parity, one
// named barrier a tile) and both warpgroups form the same scaled scores
// x = fma(S_0, c, S_1 * c), c = scale * log2(e), in this one order, so
// both hold bit-identical P. Then, as the D = 128 kernel: the online
// softmax in the log2 domain, O rescaled, P rounded to bf16 as the
// register A operand of O += P V (V read MN-major, the warpgroup's
// columns). Only the diagonal tiles are masked (64 / KB of them), tiles
// above them are never loaded, and the grid's x is (b, h), so the first
// wave holds every head's longest rows. Why this shape: a 64 x D f32
// accumulator does not fit one warpgroup beside S and P at D > 256, and
// splitting D over two warpgroups of one block computes every score once
// (the grid-z blocks of the mma.sync kernel it replaced each recomputed
// the full-D scores); 128-row blocks would make one wave of long blocks
// at the timing shape (B = 2, H = 4, T = 2048). What bounds it: the
// products are bounded by operations (989 TFLOP/s), but each block
// streams every visible K/V tile from L2 for only 64 query rows (64 flops
// a byte), so the rate at which L2 delivers K and V limits it too; the
// two warpgroups meet at the exchange each tile, and each warpgroup's
// P V runs during its next tile's exchange and softmax.
constexpr int kWideRows = 64;  // query rows per block
__host__ __device__ constexpr int wide_kb(int D) { return D == 256 ? 64 : 32; }
__host__ __device__ constexpr int wide_stages(int D) {
  return D == 384 ? 3 : 2;
}

// Q, the K and V rings (boxes 1024-byte aligned) and the partial scores
// x[tile parity][warpgroup], each thread's KB / 2 values as float4 runs
// laid out thread-major (conflict-free; the peer thread of the other
// warpgroup holds the same rows and columns and reads the same offsets).
template <int D>
struct WideFwdSmem {
  static constexpr int KB = wide_kb(D), NS = wide_stages(D), BOXES = D / 64;
  bf16 q[BOXES][kWideRows * 64];
  bf16 k[NS][BOXES][KB * 64];
  bf16 v[NS][BOXES][KB * 64];
  float x[2][2][kWideRows * KB];
  uint64_t q_full, k_full[NS], k_empty[NS], v_full[NS], v_empty[NS];
};
template <int D>
constexpr size_t wide_smem_bytes() {
  return sizeof(WideFwdSmem<D>) + 1024;  // + alignment
}

// TMA of `rows` rows (from row t0 of head h, batch b) as BOXES boxes of
// 64 columns, from column c0 on, into dst, the bytes counted on bar
template <int BOXES>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int h,
                                         int t0, int b, int c0 = 0) {
  sm90::mbar_expect_tx(bar, BOXES * rows * 128);
  for (int c = 0; c < BOXES; ++c)
    sm90::tma_load_4d(dst + c * rows * 64, map, bar, c0 + 64 * c, h, t0, b);
}

// the score product's and the output product's wgmma by accumulator size
__device__ __forceinline__ void wide_s(float (&d)[16], uint64_t a, uint64_t b,
                                       int acc) {
  sm90::wgmma_m64n32_ss(d, a, b, acc);
}
__device__ __forceinline__ void wide_s(float (&d)[32], uint64_t a, uint64_t b,
                                       int acc) {
  sm90::wgmma_m64n64_ss(d, a, b, acc);
}
__device__ __forceinline__ void wide_pv(float (&d)[64],
                                        const uint32_t (&a)[4], uint64_t b) {
  sm90::wgmma_m64n128_rs_mn(d, a, b);
}
__device__ __forceinline__ void wide_pv(float (&d)[96],
                                        const uint32_t (&a)[4], uint64_t b) {
  sm90::wgmma_m64n192_rs_mn(d, a, b);
}
__device__ __forceinline__ void wide_pv(float (&d)[128],
                                        const uint32_t (&a)[4], uint64_t b) {
  sm90::wgmma_m64n256_rs_mn(d, a, b);
}

// The online softmax of one tile of scaled scores x (log2 domain), N per
// thread (row rl + 8 (i >> 1 & 1), column 8 (i / 4) + 2t + (i & 1)), in
// place: m and lsum updated, x turned into P = ex2(x - m), corr the factor
// O is scaled by. On a diagonal tile, keys after a row are masked; koff is
// the tile's first key minus the block's first query row. (The D = 128
// kernel keeps its own softmax_tile, with the scale multiply in its first
// loop: sharing this one made that kernel slower.)
template <int N>
__device__ __forceinline__ void wide_softmax(float (&x)[N], float (&m)[2],
                                             float (&lsum)[2],
                                             float (&corr)[2], bool diag,
                                             int koff, int rl, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (diag && koff + 8 * (i / 4) + 2 * t + (i & 1) > rl + 8 * ((i >> 1) & 1))
      x[i] = -INFINITY;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x[i]);
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
  for (int i = 0; i < N; ++i) {
    x[i] = ex2(x[i] - base[(i >> 1) & 1]);
    lsum[(i >> 1) & 1] += x[i];
  }
}

// The partial scores meet: this warpgroup's (in x) goes to its buffer
// xs[wg], the peer's is read back from xs[wg ^ 1] after the named barrier
// of the two consumer warpgroups, and x becomes the scaled score
// fma(S_0, c, S_1 * c) of warpgroup 0's partial S_0 and warpgroup 1's
// S_1, in this order in both, so both hold the same bits.
template <int NX>
__device__ __forceinline__ void wide_exchange(float (&x)[NX],
                                              float (*xs)[kWideRows * NX * 2],
                                              int wg, int tid, float c) {
  float* mine = xs[wg] + 4 * tid;
  const float* peer = xs[wg ^ 1] + 4 * tid;
#pragma unroll
  for (int i = 0; i < NX; i += 4)
    *reinterpret_cast<float4*>(mine + 128 * i) =
        make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  sm90::named_bar_sync(1, 256);
#pragma unroll
  for (int i = 0; i < NX; i += 4) {
    const float4 y4 = *reinterpret_cast<const float4*>(peer + 128 * i);
    const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s0 = wg == 0 ? x[i + e] : y[e];  // warpgroup 0's partial
      const float s1 = wg == 0 ? y[e] : x[i + e];  // warpgroup 1's
      x[i + e] = fmaf(s0, c, s1 * c);
    }
  }
}

// Key tile j of nk (KB keys) crosses the diagonal of the block's 64 query
// rows: the last 64 / KB tiles of a causal row tile
__device__ __forceinline__ bool wide_diag(int causal, int j, int nk, int kb) {
  return causal && j >= nk - kWideRows / kb;
}

// P rounded to nearest bf16: p[2n], p[2n + 1] are the A fragment
// registers of 8-column block n (rows rl and rl + 8)
template <int NX>
__device__ __forceinline__ void wide_pack(uint32_t (&p)[NX / 2],
                                          const float (&x)[NX]) {
#pragma unroll
  for (int i = 0; i < NX; i += 2) p[i / 2] = pack_bf16(x[i], x[i + 1]);
}

// A consumer's columns wg * NO * 2 .. of O (its accumulator over the row
// sums, bf16) into rows q0 + rl, q0 + rl + 8 (and their 16-row steps);
// warpgroup 0 also writes L = m ln 2 + log l (m in the log2 domain)
template <int NO>
__device__ __forceinline__ void wide_store(const float (&o)[NO],
                                           const float (&m)[2],
                                           float (&lsum)[2],
                                           const WgFwdArgs& a, int wg, int q0,
                                           int rl, int t, int b, int h,
                                           int bh) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] = quad_sum(lsum[r]);
    inv[r] = lsum[r] > 0.f ? 1.f / lsum[r] : 0.f;  // l == 0 gives O = 0
  }
  bf16* out = static_cast<bf16*>(a.o) + (long long)b * a.so.b +
              (long long)h * a.so.h + wg * 2 * NO + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* row = out + (long long)(q0 + rl + 8 * r) * a.so.t;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    if (a.lse != nullptr && wg == 0 && t == 0)
      a.lse[(long long)bh * a.Tq + q0 + rl + 8 * r] =
          lsum[r] > 0.f ? m[r] * 0.6931471805599453f + logf(lsum[r])
                        : kNegInf;
  }
}

// A consumer warpgroup of flash_fwd_wide_kernel<D>: columns wg * D / 2 ..
// of O for the block's 64 query rows. Per key tile j, with S(j) (this
// warpgroup's partial) in registers and P V(j - 1) still running on the
// tensor cores: the exchange and the softmax of tile j; wait for P V(j -
// 1) (release its V stage); rescale O, round P(j); issue S(j + 1) into
// the score registers, then P V(j); wait for S(j + 1) only (release its
// K stage). So each P V overlaps the next tile's exchange and softmax.
// The last tile is peeled off (it issues no next S), so no branch sits
// around a wgmma; P, O and the scores are defined only while no product
// that reads or writes them is in flight (ptxas serializes wgmma
// otherwise).
template <int D>
__device__ __forceinline__ void wide_fwd_consumer(WideFwdSmem<D>& sm,
                                                  const WgFwdArgs& a, int wg,
                                                  int qi, int nk, int b,
                                                  int h, int bh) {
  using Sm = WideFwdSmem<D>;
  constexpr int KB = Sm::KB, NS = Sm::NS, HALF = D / 2;
  constexpr int NX = KB / 2;    // score registers a thread (64 x KB)
  constexpr int NO = HALF / 2;  // output registers a thread (64 x D / 2)
  const int tid = threadIdx.x % 128, l = threadIdx.x % 32;
  const int g = l / 4, t = l % 4;
  const int rl = 16 * (tid / 32) + g;  // this thread's rows: rl, rl + 8
  const int q0 = qi * kWideRows;
  const int box0 = wg * (HALF / 64);   // the warpgroup's first column box
  float o[NO], x[NX], m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  float corr[2];
  uint32_t p[NX / 2];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  // S(j), this warpgroup's columns, into x (issued and committed)
  auto issue_s = [&](int j) {
    const int s = j % NS;
    sm90::mbar_wait(&sm.k_full[s], (j / NS) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HALF / 16; ++kk) {
      const int box = box0 + kk / 4, off = (kk % 4) * 32;
      wide_s(x, sm90::desc_sw128(reinterpret_cast<const char*>(sm.q[box]) +
                                 off),
             sm90::desc_sw128(reinterpret_cast<const char*>(sm.k[s][box]) +
                              off),
             kk > 0);
    }
    sm90::wgmma_commit();
  };
  sm90::mbar_wait(&sm.q_full, 0);
  issue_s(0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(x);
  if (l == 0) sm90::mbar_arrive(&sm.k_empty[0]);
  // tile j; with `next` true, S(j + 1) is also issued and waited for
  auto step = [&](int j, auto next) {
    const int s = j % NS;
    wide_exchange(x, sm.x[j & 1], wg, tid, a.scale_log2);
    wide_softmax(x, m, lsum, corr, wide_diag(a.causal, j, nk, KB),
                 j * KB - q0, rl, t);
    sm90::wgmma_wait<0>();  // P V(j - 1)
    sm90::fence_regs(o);
    sm90::mbar_arrive_if(&sm.v_empty[(j + NS - 1) % NS], l == 0 && j > 0);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
    wide_pack(p, x);
    if constexpr (decltype(next)::value) issue_s(j + 1);
    sm90::mbar_wait(&sm.v_full[s], (j / NS) & 1);
    sm90::fence_regs(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      const uint32_t af[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                              p[4 * kk + 3]};
      wide_pv(o, af,
              sm90::desc_sw128(
                  reinterpret_cast<const char*>(sm.v[s][box0]) + kk * 2048,
                  sizeof(sm.v[s][0])));
    }
    sm90::wgmma_commit();
    if constexpr (decltype(next)::value) {
      sm90::wgmma_wait<1>();  // S(j + 1); P V(j) runs on
      sm90::fence_regs(x);
      sm90::mbar_arrive_if(&sm.k_empty[(j + 1) % NS], l == 0);
    }
  };
  for (int j = 0; j + 1 < nk; ++j) step(j, std::true_type{});
  step(nk - 1, std::false_type{});
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  wide_store(o, m, lsum, a, wg, q0, rl, t, b, h, bh);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const WgFwdArgs a) {
  using Sm = WideFwdSmem<D>;
  constexpr int KB = Sm::KB, NS = Sm::NS;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qi = a.Tq / kWideRows - 1 - blockIdx.y;  // longest rows first
  const int q0 = qi * kWideRows;
  // K/V tiles strictly above the diagonal are never loaded
  const int nk = a.causal ? (q0 + kWideRows) / KB : a.Tk / KB;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < NS; ++s) {
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
      tma_rows<Sm::BOXES>(sm.q[0], &tq, &sm.q_full, kWideRows, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % NS;
        // a stage is refilled once every consumer warp released it
        const uint32_t par = ((j / NS) & 1) ^ 1;
        sm90::mbar_wait(&sm.k_empty[s], par);
        tma_rows<Sm::BOXES>(sm.k[s][0], &tk, &sm.k_full[s], KB, h, j * KB, b);
        sm90::mbar_wait(&sm.v_empty[s], par);
        tma_rows<Sm::BOXES>(sm.v[s][0], &tv, &sm.v_full[s], KB, h, j * KB, b);
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    wide_fwd_consumer<D>(sm, a, threadIdx.x / 128, qi, nk, b, h, bh);
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

// A consumer's 64 x N / 2 accumulator (times `mul`) as bf16 into rows
// r0 + rl, r0 + rl + 8 (and their 16-row steps) of a (b, t, h) strided
// output: element 4j + e is row 16w + g + 8 (e >> 1), column 8j + 2t + (e & 1)
template <int N>
__device__ __forceinline__ void store_wg(const float (&acc)[N], float mul,
                                         void* out, const Strides& st, int b,
                                         int h, int r0, int rl, int t) {
  bf16* base = static_cast<bf16*>(out) + (long long)b * st.b +
               (long long)h * st.h + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* row = base + (long long)(r0 + rl + 8 * r) * st.t;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
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

// ====================== bf16 D = 256 backward: wgmma + TMA ("wgmma wide")
// flash_bwd_dq_wide_kernel and flash_bwd_dkv_wide_kernel: two consumer
// warpgroups with accumulators over all of D = 256 (128 f32 registers a
// thread) and a producer warpgroup, so every score tile (S and dP, or S^T
// and dP^T) is computed once, by one warpgroup: the mma.sync kernels they
// replaced split D over grid-z blocks of 128 columns, each of which
// recomputed the full-D scores. Every product runs on wgmma; its
// shared-memory operands are loaded by TMA (one thread of the producer),
// a row as four 64-column boxes (128-byte rows, swizzled; the 4-D tensor
// maps of the other bf16 kernels, so fused-qkv slices are read in place),
// into a ring behind full and empty mbarriers. A score tile becomes the
// register A operand of the next product with P and dS rounded to nearest
// bf16; P = ex2(S * scale * log2(e) - L * log2(e)); only the tiles that
// cross the diagonal are masked and tiles above them are never loaded;
// the grid's x is (b, h), so the first wave holds every head's longest
// rows (dQ) or columns (dK/dV). No atomics: each block writes its own
// rows, so two runs give the same bits.
//  - dQ: a block owns 64 query rows (Q and dO, 64 KB); the ring carries
//    K/V tiles of 32 keys in four stages of 32 KB, tile j in stage j % 4,
//    and the warpgroups take the tiles in turn (warpgroup j % 2). Per
//    tile: S = Q K^T and dP = dO V^T (wgmma n = 32, one commit), dS = P
//    (dP - dsum) in registers, dQ += dS K (K read MN-major). At the end
//    the two partial dQ meet in the freed ring: each warpgroup adds the
//    other's half to its own half and stores it (one addition of two
//    partials: the same bits in either order). Live f32 a thread: dQ 128,
//    S 16, dP 16.
//  - dK/dV: a block owns 64 keys (K and V, 64 KB); the ring carries Q/dO
//    tiles of 64 queries with their L and dsum rows in two stages of
//    64 KB, and P^T goes from warpgroup 0 to warpgroup 1 through two f32
//    buffers of 16 KB (231,496 bytes of the 232,448 a block may use).
//    Warpgroup 0: S^T = K Q^T, P^T, dV += P^T dO; warpgroup 1: dP^T =
//    V dO^T, dS^T = P^T (dP^T - dsum), dK += dS^T Q. Live f32: 128 + 32.
// Why dQ splits the key tiles and not the rows: blocks of 128 rows, 64 a
// warpgroup (the D = 128 kernel's split), make B * H * T / 128 blocks,
// one wave at B = 2, H = 4, T = 2048, whose time is the longest causal
// block's, about twice the average; 64-row blocks make two waves taken
// longest first. Their cost: each block streams its K/V tiles from L2
// for 64 rows, not 128 (slightly slower where the grid is many waves
// deep). Registers: 128 accumulator registers beside a score tile are
// more than the 168 a thread of a 384-thread block starts with; the
// producer warpgroup gives registers up (setmaxnreg 40), the consumers
// take them (232), and ptxas compiles the consumer code to that budget
// without spills. (A block of 288 threads, the producer one warp and no
// setmaxnreg, was held to 168 registers by ptxas, spilled and serialized
// the wgmma.) What bounds them: the products (989 TFLOP/s); the S and dP
// products of dQ at n = 32 read 3 KB of shared memory a k-step for 16
// cycles of tensor work, above the 128 bytes a cycle shared memory
// gives; and a warpgroup runs its products and its element-wise work one
// after the other (the other warpgroup fills the tensor cores meanwhile).
constexpr int kWbRows = 64;  // query rows of a dQ block; keys of a dK/dV
                             // block and queries of its streamed tiles
constexpr int kWbKeys = 32;  // keys of a dQ block's streamed tile
constexpr int kWbDqStages = 4;  // tile j in stage j % 4, warpgroup j % 2
constexpr int kWbDkvStages = 2;
constexpr int kWbBoxes = 4;     // 64-column boxes of a row of D = 256

struct WideDqSmem {
  bf16 q[kWbBoxes][kWbRows * 64];
  bf16 dO[kWbBoxes][kWbRows * 64];
  bf16 k[kWbDqStages][kWbBoxes][kWbKeys * 64];
  bf16 v[kWbDqStages][kWbBoxes][kWbKeys * 64];
  uint64_t own_full, full[kWbDqStages], empty[kWbDqStages];
};

struct WideDkvSmem {
  bf16 k[kWbBoxes][kWbRows * 64];
  bf16 v[kWbBoxes][kWbRows * 64];
  bf16 q[kWbDkvStages][kWbBoxes][kWbRows * 64];
  bf16 dO[kWbDkvStages][kWbBoxes][kWbRows * 64];
  float pt[2][kWbRows * kWbRows];  // P^T, in the accumulator's layout
  float lse[kWbDkvStages][kWbRows], dsum[kWbDkvStages][kWbRows];
  uint64_t own_full, full[kWbDkvStages], empty[kWbDkvStages];
  uint64_t p_full[2], p_empty[2];
};
constexpr size_t kWbDqSmemBytes = sizeof(WideDqSmem) + 1024;  // + alignment
constexpr size_t kWbDkvSmemBytes = sizeof(WideDkvSmem) + 1024;

// acc (64 x N) = A (64 rows of K columns: K / 64 boxes a_box bytes apart)
// . B^T (N rows, boxes b_box bytes apart), both K-major; issued, not
// committed
template <int K, int NX>
__device__ __forceinline__ void issue_s(float (&acc)[NX], const void* a,
                                        uint32_t a_box, const void* b,
                                        uint32_t b_box) {
  const char* pa = static_cast<const char*>(a);
  const char* pb = static_cast<const char*>(b);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;
    wide_s(acc, sm90::desc_sw128(pa + box * a_box + off),
           sm90::desc_sw128(pb + box * b_box + off), kk > 0);
  }
}

// acc (64 x 2 NO: 256, 192 or 128 columns) += P (64 x 2 NP, bf16 A
// fragments in registers) . B (2 NP rows read MN-major, 2 NO / 64 boxes
// b_box bytes apart); issued and committed
template <int NO, int NP>
__device__ __forceinline__ void issue_pb(float (&acc)[NO],
                                         const uint32_t (&p)[NP],
                                         const void* b, uint32_t b_box) {
  const char* pb = static_cast<const char*>(b);
#pragma unroll
  for (int kk = 0; kk < NP / 4; ++kk) {
    const uint32_t af[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                            p[4 * kk + 3]};
    wide_pv(acc, af, sm90::desc_sw128(pb + kk * 2048, b_box));
  }
  sm90::wgmma_commit();
}

// The two partial dQ of a block's warpgroups meet: this warpgroup hands
// the columns its peer stores (elements GIVE .. GIVE + N / 2 - 1 of dq) to
// `mine`, and after the named barrier of the two consumer warpgroups adds
// the peer's partial of its own columns (elements N / 2 - GIVE ..) into
// out. Each thread's N / 2 values are float4 runs laid out thread-major;
// the peer thread holds the same rows and columns. One addition of two
// partials gives the same bits in either order.
template <int N, int GIVE>
__device__ __forceinline__ void dq_meet(const float (&dq)[N], float4* mine,
                                        const float4* peer, int tid,
                                        float (&out)[N / 2]) {
  constexpr int KEEP = N / 2 - GIVE;
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
    mine[i * 128 + tid] = make_float4(dq[GIVE + 4 * i], dq[GIVE + 4 * i + 1],
                                      dq[GIVE + 4 * i + 2],
                                      dq[GIVE + 4 * i + 3]);
  sm90::named_bar_sync(1, 256);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const float4 y = peer[i * 128 + tid];
    out[4 * i] = dq[KEEP + 4 * i] + y.x;
    out[4 * i + 1] = dq[KEEP + 4 * i + 1] + y.y;
    out[4 * i + 2] = dq[KEEP + 4 * i + 2] + y.z;
    out[4 * i + 3] = dq[KEEP + 4 * i + 3] + y.w;
  }
}

// A dQ consumer warpgroup of flash_bwd_dq_wide_kernel: the block's query
// rows q0 .. q0 + 63 over key tiles wg, wg + 2, ..; at the end it stores
// columns 128 wg .. 128 wg + 127 of dQ, its partial plus the peer's.
__device__ __forceinline__ void wide_dq_consumer(WideDqSmem& sm,
                                                 const WgBwdArgs& a, int wg,
                                                 int q0, int nk, int b,
                                                 int h, int bh) {
  constexpr int KB = kWbKeys, NS = kWbDqStages;
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int tid = threadIdx.x % 128;
  const int rl = 16 * (tid / 32) + g;  // rows rl, rl + 8
  float lse2[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = (long long)bh * a.Tq + q0 + rl + 8 * r;
    lse2[r] = a.lse[i] * kLog2e;
    dsum[r] = a.dsum[i];
  }
  float dq[128], s[16], dp[16];
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < 128; ++i) dq[i] = 0.f;
  sm90::mbar_wait(&sm.own_full, 0);
  for (int j = wg; j < nk; j += 2) {
    const int st = j % NS;
    sm90::mbar_wait(&sm.full[st], (j / NS) & 1);
    sm90::wgmma_fence();
    issue_s<256>(s, sm.q[0], sizeof(sm.q[0]), sm.k[st][0],
                 sizeof(sm.k[st][0]));
    issue_s<256>(dp, sm.dO[0], sizeof(sm.dO[0]), sm.v[st][0],
                 sizeof(sm.v[st][0]));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    const bool diag = wide_diag(a.causal, j, nk, KB);
    const int koff = j * KB - q0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1;
      const bool masked =
          diag && koff + 8 * (i / 4) + 2 * t + (i & 1) > rl + 8 * r;
      const float pv = masked ? 0.f : ex2(fmaf(s[i], a.scale_log2, -lse2[r]));
      s[i] = pv * (dp[i] - dsum[r]);  // dS
    }
    wide_pack(p, s);
    sm90::fence_regs(dq);
    sm90::wgmma_fence();
    issue_pb(dq, p, sm.k[st][0], sizeof(sm.k[st][0]));  // dQ += dS K
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    if (l == 0) sm90::mbar_arrive(&sm.empty[st]);
  }
  // every stage is consumed: the K ring's 64 KB hold the two hand-overs
  sm90::named_bar_sync(1, 256);
  float4* xs = reinterpret_cast<float4*>(sm.k[0][0]);
  float out[64];
  if (wg == 0)
    dq_meet<128, 64>(dq, xs, xs + 2048, tid, out);
  else
    dq_meet<128, 0>(dq, xs + 2048, xs, tid, out);
  store_wg(out, a.scale, static_cast<bf16*>(a.out0) + 128 * wg, a.so0, b, h,
           q0, rl, t);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const WgBwdArgs a) {
  constexpr int KB = kWbKeys, NS = kWbDqStages;
  extern __shared__ unsigned char smem_raw[];
  WideDqSmem& sm = *reinterpret_cast<WideDqSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = (a.Tq / kWbRows - 1 - blockIdx.y) * kWbRows;  // longest first
  // K/V tiles past the block's diagonal are never loaded
  const int nk = a.causal ? (q0 + kWbRows) / KB : a.Tk / KB;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.own_full, 2);  // Q's and dO's expected bytes
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&sm.full[s], 2);   // K's and V's
      sm90::mbar_init(&sm.empty[s], 4);  // the warps of the stage's warpgroup
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      tma_rows<kWbBoxes>(sm.q[0], &tq, &sm.own_full, kWbRows, h, q0, b);
      tma_rows<kWbBoxes>(sm.dO[0], &tdo, &sm.own_full, kWbRows, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % NS;
        // a stage is refilled once its warpgroup released it
        sm90::mbar_wait(&sm.empty[s], ((j / NS) & 1) ^ 1);
        tma_rows<kWbBoxes>(sm.k[s][0], &tk, &sm.full[s], KB, h, j * KB, b);
        tma_rows<kWbBoxes>(sm.v[s][0], &tv, &sm.full[s], KB, h, j * KB, b);
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    wide_dq_consumer(sm, a, threadIdx.x / 128, q0, nk, b, h, bh);
  }
}

// dK/dV warpgroup 0 of flash_bwd_dkv_wide_kernel: S^T, P^T (handed to
// warpgroup 1), dV += P^T dO.
__device__ __forceinline__ void wide_dv_consumer(WideDkvSmem& sm,
                                                 const WgBwdArgs& a, int kj,
                                                 int q_first, int nq, int b,
                                                 int h) {
  constexpr int NS = kWbDkvStages;
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int tid = threadIdx.x % 128;
  const int rl = 16 * (tid / 32) + g;  // key rows rl, rl + 8 of the block
  float dv[128], s[32];
  uint32_t p[16];
#pragma unroll
  for (int i = 0; i < 128; ++i) dv[i] = 0.f;
  sm90::mbar_wait(&sm.own_full, 0);
  for (int qi = q_first; qi < nq; ++qi) {
    const int n = qi - q_first, st = n % NS, pb = n & 1;
    sm90::mbar_wait(&sm.full[st], (n / NS) & 1);
    sm90::wgmma_fence();
    issue_s<256>(s, sm.k[0], sizeof(sm.k[0]), sm.q[st][0],
                 sizeof(sm.q[st][0]));  // S^T = K Q^T
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
    issue_pb(dv, p, sm.dO[st][0], sizeof(sm.dO[st][0]));  // dV += P^T dO
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    if (l == 0) sm90::mbar_arrive(&sm.empty[st]);
  }
  store_wg(dv, 1.f, a.out1, a.so1, b, h, kj * kWbRows, rl, t);
}

// dK/dV warpgroup 1: dP^T, dS^T = P^T * (dP^T - dsum), dK += dS^T Q.
__device__ __forceinline__ void wide_dk_consumer(WideDkvSmem& sm,
                                                 const WgBwdArgs& a, int kj,
                                                 int q_first, int nq, int b,
                                                 int h) {
  constexpr int NS = kWbDkvStages;
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int tid = threadIdx.x % 128;
  const int rl = 16 * (tid / 32) + g;
  float dk[128], dp[32];
  uint32_t p[16];
#pragma unroll
  for (int i = 0; i < 128; ++i) dk[i] = 0.f;
  sm90::mbar_wait(&sm.own_full, 0);
  for (int qi = q_first; qi < nq; ++qi) {
    const int n = qi - q_first, st = n % NS, pb = n & 1;
    sm90::mbar_wait(&sm.full[st], (n / NS) & 1);
    sm90::wgmma_fence();
    issue_s<256>(dp, sm.v[0], sizeof(sm.v[0]), sm.dO[st][0],
                 sizeof(sm.dO[st][0]));  // dP^T = V dO^T
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
    issue_pb(dk, p, sm.q[st][0], sizeof(sm.q[st][0]));  // dK += dS^T Q
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dk);
    if (l == 0) sm90::mbar_arrive(&sm.empty[st]);
  }
  store_wg(dk, a.scale, a.out0, a.so0, b, h, kj * kWbRows, rl, t);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const WgBwdArgs a) {
  constexpr int NS = kWbDkvStages;
  extern __shared__ unsigned char smem_raw[];
  WideDkvSmem& sm = *reinterpret_cast<WideDkvSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kj = blockIdx.y;  // under the causal mask: longest columns first
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = kj * kWbRows;
  // query tiles before the diagonal see none of these keys
  const int q_first = a.causal ? kj : 0;
  const int nq = a.Tq / kWbRows;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.own_full, 2);  // K's and V's expected bytes
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&sm.full[s], 3);   // Q's, dO's, and L's with dsum's
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
      tma_rows<kWbBoxes>(sm.k[0], &tk, &sm.own_full, kWbRows, h, k0, b);
      tma_rows<kWbBoxes>(sm.v[0], &tv, &sm.own_full, kWbRows, h, k0, b);
      const float* lse = a.lse + (long long)bh * a.Tq;
      const float* dsum = a.dsum + (long long)bh * a.Tq;
      for (int qi = q_first; qi < nq; ++qi) {
        const int n = qi - q_first, s = n % NS, r0 = qi * kWbRows;
        // a stage is refilled once every consumer warp released it
        sm90::mbar_wait(&sm.empty[s], ((n / NS) & 1) ^ 1);
        tma_rows<kWbBoxes>(sm.q[s][0], &tq, &sm.full[s], kWbRows, h, r0, b);
        tma_rows<kWbBoxes>(sm.dO[s][0], &tdo, &sm.full[s], kWbRows, h, r0,
                           b);
        sm90::mbar_expect_tx(&sm.full[s], 2 * kWbRows * 4);
        sm90::bulk_load(sm.lse[s], lse + r0, kWbRows * 4, &sm.full[s]);
        sm90::bulk_load(sm.dsum[s], dsum + r0, kWbRows * 4, &sm.full[s]);
      }
    }
  } else if (threadIdx.x < 128) {
    sm90::setmaxnreg_inc<232>();
    wide_dv_consumer(sm, a, kj, q_first, nq, b, h);
  } else {
    sm90::setmaxnreg_inc<232>();
    wide_dk_consumer(sm, a, kj, q_first, nq, b, h);
  }
}

// ============= bf16 backward at D = 384, 512: wgmma + TMA in clusters
// ("wgmma cluster")
// flash_bwd_dq_cluster_kernel<D> and flash_bwd_dkv_cluster_kernel<D>. A
// warpgroup's 64 x D f32 accumulator would be D / 2 registers a thread
// (192 or 256), and at D = 512 the dK and dV of 64 keys alone are the
// whole register file of an SM, so no block holds a row tile's outputs:
// each 64-row tile (queries for dQ, keys for dK/dV) is a thread block
// cluster of two blocks along grid z, and block r owns the column half
// r * D / 2 .. + D / 2 (192 or 256 columns) of its owned tiles, of every
// streamed tile and of its outputs. Each block is the D = 256 "wgmma wide"
// backward at that width: a producer warpgroup (one thread issues every
// TMA load; setmaxnreg 40) and two consumer warpgroups (232), every
// product on wgmma, its shared-memory operands loaded by TMA as the
// block's D / 128 boxes of 64 columns (the 4-D tensor maps, so fused-qkv
// slices are read in place), the streamed tiles of 32 rows in a ring of
// cl_stages(D) stages.
// Every score is computed once per cluster. Each block computes the
// partial scores over its columns (S and dP, or S^T and dP^T); a
// warpgroup stores its partials into the same warpgroup's buffer in the
// peer block (distributed shared memory) by st.async, whose bytes count on
// the peer's barrier of that buffer as a TMA load's do (the storing thread
// neither fences nor waits; plain stores followed by a release arrival a
// warp measured slower on the card), then arms its own barrier
// with the bytes it expects, waits on it (acquire at cluster scope) and
// forms, from the two blocks' partials in rank order (rank 0's S_0 and
// dP_0, then rank 1's),
//   P = ex2(fma(S_0, c, fma(S_1, c, -L log2(e)))),  c = scale log2(e),
//   dS = P (dP_0 + (dP_1 - dsum)),
// so both blocks hold bit-identical P and dS. A warpgroup's two buffers
// alternate by its tile parity: a block pushes into a buffer again two of
// the warpgroup's tiles on, after it received the peer's push of the tile
// between, which the peer made after reading that buffer; so no barrier
// frees a buffer. A cluster barrier follows the barriers' initialization
// (the peer's stores count on them) and one precedes the exit.
//  - dQ: a block owns its half of 64 query rows (Q and dO); the ring
//    carries its half of K/V tiles of 32 keys; the warpgroups take the
//    tiles in turn (warpgroup j % 2) and add their partial dQ once at the
//    end, as at D = 256. Live f32 a thread: dQ 96 or 128, S 16, dP 16.
//  - dK/dV: a block owns its half of 64 keys (K and V); the ring carries
//    its half of Q/dO tiles of 32 queries (tiles of 64 would not fit beside
//    the exchange buffers and P^T) with their L and dsum rows; warpgroup 0
//    forms S^T and P^T, hands P^T to warpgroup 1 (two f32 buffers) and
//    accumulates dV; warpgroup 1 forms dP^T and dS^T and accumulates dK.
//    Each warpgroup issues the next tile's partial score product before it
//    waits for the peer's partials, so that the product runs during the
//    wait (two sets of 16 score registers, taken in turn). dQ does not:
//    a second pair of its S and dP sets beside dQ's 96 or 128 registers
//    spilled and ran slower on the card.
// Shared memory at D = 512 / 384: dQ 224 / 208 KB (Q and dO halves 64 /
// 48 KB, 3 / 4 stages of 32 / 24 KB, exchange buffers 64 KB), dK/dV 209 /
// 193 KB (K and V halves 64 / 48, 3 / 4 stages of 32 / 24 with L and
// dsum, exchange 32, P^T 16). Only the tiles that cross the diagonal are
// masked and tiles above it are never loaded; the grid's y takes the
// longest rows (dQ) or columns (dK/dV) first. No atomics: each cluster
// writes its own rows, so two runs give the same bits. What bounds them:
// the products (989 TFLOP/s); the score products at n = 32 read 3 KB of
// shared memory a k-step for 16 cycles of tensor work, as at D = 256; the
// exchange adds, per tile and warpgroup, 16 (dQ) or 8 (dK/dV) KB stored
// into the peer, the wait for the peer's (about a fifth of a tile's
// cycles, `chip_phase_profile.py`) and the sum's element-wise work.
constexpr int kClTile = 32;  // rows of a streamed tile (keys or queries)
__host__ __device__ constexpr int cl_stages(int D) { return D == 512 ? 3 : 4; }

template <int D>
struct ClDqSmem {
  static constexpr int BOXES = D / 128, NS = cl_stages(D);
  bf16 q[BOXES][kWbRows * 64];
  bf16 dO[BOXES][kWbRows * 64];
  bf16 k[NS][BOXES][kClTile * 64];
  bf16 v[NS][BOXES][kClTile * 64];
  // [warpgroup][buffer]: the peer's partial S and dP (cl_push's layout)
  float x[2][2][2 * kWbRows * kClTile];
  uint64_t own_full, full[NS], empty[NS], x_full[2][2];
};

template <int D>
struct ClDkvSmem {
  static constexpr int BOXES = D / 128, NS = cl_stages(D);
  bf16 k[BOXES][kWbRows * 64];
  bf16 v[BOXES][kWbRows * 64];
  bf16 q[NS][BOXES][kClTile * 64];
  bf16 dO[NS][BOXES][kClTile * 64];
  // [warpgroup][buffer]: the peer's partial S^T (warpgroup 0) or dP^T (1)
  float x[2][2][kWbRows * kClTile];
  float pt[2][kWbRows * kClTile];  // P^T, in the accumulator's layout
  float lse[NS][kClTile], dsum[NS][kClTile];
  uint64_t own_full, full[NS], empty[NS], x_full[2][2];
  uint64_t p_full[2], p_empty[2];
};

// This thread's N partial scores of a tile, as float4 runs laid out
// thread-major (run i / 4 at byte 16 tid + 2048 (i / 4) of the tile's
// buffer), stored by st.async at the same places of the peer block's
// buffer, whose address (at this thread's first run) is `remote`, their
// bytes counted on the peer's barrier at `bar`; the peer thread holds the
// same rows and columns.
template <int N>
__device__ __forceinline__ void cl_push(const float (&x)[N], uint32_t remote,
                                        uint32_t bar) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    sm90::st_async_v4(remote + 512 * i,
                      make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]), bar);
}

// After the pushes: the wait for the peer's pushes into this block, the
// `bytes` of phase `parity` of this block's `bar`, which the warpgroup's
// first thread arms
__device__ __forceinline__ void cl_meet(uint64_t* bar, uint32_t bytes,
                                        uint32_t parity, int tid) {
  sm90::mbar_expect_tx_if(bar, bytes, tid == 0);
  sm90::mbar_wait_cluster(bar, parity);
}

// The scaled score fma(S_0, c, fma(S_1, c, -l2)) of the two blocks'
// partials in rank order, from this block's partial `mine` and the peer's
__device__ __forceinline__ float cl_score(float mine, float peer, int rank,
                                          float c, float l2) {
  const float s0 = rank == 0 ? mine : peer;
  const float s1 = rank == 0 ? peer : mine;
  return fmaf(s0, c, fmaf(s1, c, -l2));
}

// dP - dsum as dP_0 + (dP_1 - dsum), the partials in rank order
__device__ __forceinline__ float cl_dp(float mine, float peer, int rank,
                                       float dsum) {
  const float d0 = rank == 0 ? mine : peer;
  const float d1 = rank == 0 ? peer : mine;
  return d0 + (d1 - dsum);
}

// A dQ consumer warpgroup of flash_bwd_dq_cluster_kernel<D>: the block's
// half of query rows q0 .. q0 + 63 over key tiles wg, wg + 2, ..; at the
// end it stores columns rank * D / 2 + wg * D / 4 .. + D / 4 of dQ, its
// partial plus the other warpgroup's.
template <int D>
__device__ __forceinline__ void cl_dq_consumer(ClDqSmem<D>& sm,
                                               const WgBwdArgs& a, int wg,
                                               int rank, int q0, int nk,
                                               int b, int h, int bh) {
  constexpr int NS = ClDqSmem<D>::NS, HALF = D / 2, NO = HALF / 2;
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int tid = threadIdx.x % 128;
  const int rl = 16 * (tid / 32) + g;  // rows rl, rl + 8
  const uint32_t peer = rank ^ 1;
  float lse2[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = (long long)bh * a.Tq + q0 + rl + 8 * r;
    lse2[r] = a.lse[i] * kLog2e;
    dsum[r] = a.dsum[i];
  }
  float dq[NO], s[16], dp[16];
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;
  sm90::mbar_wait(&sm.own_full, 0);
  for (int j = wg; j < nk; j += 2) {
    const int st = j % NS, m = j / 2;  // the warpgroup's m-th tile
    sm90::mbar_wait(&sm.full[st], (j / NS) & 1);
    sm90::wgmma_fence();
    issue_s<HALF>(s, sm.q[0], sizeof(sm.q[0]), sm.k[st][0],
                  sizeof(sm.k[st][0]));
    issue_s<HALF>(dp, sm.dO[0], sizeof(sm.dO[0]), sm.v[st][0],
                  sizeof(sm.v[st][0]));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    // the partial scores meet: S at the buffer's start, dP 8 KB on
    float* xs = sm.x[wg][m & 1];
    const uint32_t remote = sm90::map_cluster(xs + 4 * tid, peer);
    const uint32_t bar = sm90::map_cluster(&sm.x_full[wg][m & 1], peer);
    cl_push(s, remote, bar);
    cl_push(dp, remote + kWbRows * kClTile * 4, bar);
    cl_meet(&sm.x_full[wg][m & 1], 2 * kWbRows * kClTile * 4, (m >> 1) & 1,
            tid);
    const bool diag = wide_diag(a.causal, j, nk, kClTile);
    const int koff = j * kClTile - q0;
    const float* ys = xs + 4 * tid;
#pragma unroll
    for (int i = 0; i < 16; i += 4) {
      const float4 y4 = *reinterpret_cast<const float4*>(ys + 128 * i);
      const float4 z4 = *reinterpret_cast<const float4*>(
          ys + kWbRows * kClTile + 128 * i);
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
      const float z[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool masked =
            diag && koff + 2 * i + 2 * t + (e & 1) > rl + 8 * r;
        const float pv = masked ? 0.f
                                : ex2(cl_score(s[i + e], y[e], rank,
                                               a.scale_log2, lse2[r]));
        s[i + e] = pv * cl_dp(dp[i + e], z[e], rank, dsum[r]);  // dS
      }
    }
    wide_pack(p, s);
    sm90::fence_regs(dq);
    sm90::wgmma_fence();
    issue_pb(dq, p, sm.k[st][0], sizeof(sm.k[st][0]));  // dQ += dS K
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    if (l == 0) sm90::mbar_arrive(&sm.empty[st]);
  }
  // every tile is exchanged: the exchange buffers hold the two hand-overs
  sm90::named_bar_sync(1, 256);
  float4* xs = reinterpret_cast<float4*>(sm.x[0][0]);
  float out[NO / 2];
  if (wg == 0)
    dq_meet<NO, NO / 2>(dq, xs, xs + NO / 8 * 128, tid, out);
  else
    dq_meet<NO, 0>(dq, xs + NO / 8 * 128, xs, tid, out);
  store_wg(out, a.scale,
           static_cast<bf16*>(a.out0) + rank * HALF + wg * (HALF / 2), a.so0,
           b, h, q0, rl, t);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const WgBwdArgs a) {
  using Sm = ClDqSmem<D>;
  constexpr int NS = Sm::NS, BOXES = Sm::BOXES;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = (a.Tq / kWbRows - 1 - blockIdx.y) * kWbRows;  // longest first
  const int rank = (int)sm90::cluster_rank();  // the block's column half
  // K/V tiles past the block's diagonal are never loaded
  const int nk = a.causal ? (q0 + kWbRows) / kClTile : a.Tk / kClTile;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.own_full, 2);  // Q's and dO's expected bytes
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&sm.full[s], 2);   // K's and V's
      sm90::mbar_init(&sm.empty[s], 4);  // the warps of the stage's warpgroup
    }
    for (int w = 0; w < 2; ++w)
      for (int i = 0; i < 2; ++i)
        sm90::mbar_init(&sm.x_full[w][i], 1);  // the arming; bytes
    sm90::mbar_fence_init();
  }
  sm90::cluster_sync();  // both blocks' barriers are initialized
  if (threadIdx.x >= 256) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const int c0 = rank * (D / 2);
      tma_rows<BOXES>(sm.q[0], &tq, &sm.own_full, kWbRows, h, q0, b, c0);
      tma_rows<BOXES>(sm.dO[0], &tdo, &sm.own_full, kWbRows, h, q0, b, c0);
      for (int j = 0; j < nk; ++j) {
        const int s = j % NS, k0 = j * kClTile;
        // a stage is refilled once its warpgroup released it
        sm90::mbar_wait(&sm.empty[s], ((j / NS) & 1) ^ 1);
        tma_rows<BOXES>(sm.k[s][0], &tk, &sm.full[s], kClTile, h, k0, b, c0);
        tma_rows<BOXES>(sm.v[s][0], &tv, &sm.full[s], kClTile, h, k0, b, c0);
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    cl_dq_consumer<D>(sm, a, threadIdx.x / 128, rank, q0, nk, b, h, bh);
  }
  sm90::cluster_sync();  // no block exits while its peer may push into it
}

// dK/dV warpgroup 0 of flash_bwd_dkv_cluster_kernel<D>: S^T (this block's
// partial, then the cluster's), P^T (handed to warpgroup 1), dV += P^T dO
// over the block's columns.
template <int D>
__device__ __forceinline__ void cl_dv_consumer(ClDkvSmem<D>& sm,
                                               const WgBwdArgs& a, int rank,
                                               int kj, int q_first, int nq,
                                               int b, int h) {
  constexpr int NS = ClDkvSmem<D>::NS, HALF = D / 2;
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int tid = threadIdx.x % 128;
  const int rl = 16 * (tid / 32) + g;  // key rows rl, rl + 8 of the block
  const uint32_t peer = rank ^ 1;
  float dv[HALF / 2], sa[16], sb[16];
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) dv[i] = 0.f;
  // S^T = K Q^T of the n-th streamed tile, this block's partial, into s:
  // issued and committed
  auto issue = [&](int n, float (&s)[16]) {
    const int st = n % NS;
    sm90::mbar_wait(&sm.full[st], (n / NS) & 1);
    sm90::wgmma_fence();
    issue_s<HALF>(s, sm.k[0], sizeof(sm.k[0]), sm.q[st][0],
                  sizeof(sm.q[st][0]));
    sm90::wgmma_commit();
  };
  // the n-th tile, its partial in s; with `next`, the next tile's partial
  // is issued into s2 before the exchange and waited for at the end
  auto step = [&](int n, float (&s)[16], float (&s2)[16], auto next) {
    const int qi = q_first + n, st = n % NS, pb = n & 1;
    float* xs = sm.x[0][pb];
    cl_push(s, sm90::map_cluster(xs + 4 * tid, peer),
            sm90::map_cluster(&sm.x_full[0][pb], peer));
    if constexpr (decltype(next)::value) issue(n + 1, s2);
    cl_meet(&sm.x_full[0][pb], kWbRows * kClTile * 4, (n >> 1) & 1, tid);
    // P^T = ex2(S^T * scale * log2(e) - L(query) * log2(e)); on the two
    // diagonal tiles keys after a query are masked (exactly 0); koff is the
    // tile's first query minus the block's first key
    const bool diag = a.causal && qi < q_first + kWbRows / kClTile;
    const int koff = qi * kClTile - kj * kWbRows;
    const float* Ls = sm.lse[st];
    const float* ys = xs + 4 * tid;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(Ls + 8 * j + 2 * t);
      const float4 y4 = *reinterpret_cast<const float4*>(ys + 512 * j);
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, col = 8 * j + 2 * t + (e & 1);
        const float L2 = ((e & 1) ? lq.y : lq.x) * kLog2e;
        const bool masked = diag && rl + 8 * (e >> 1) > koff + col;
        s[i] = masked ? 0.f
                      : ex2(cl_score(s[i], y[e], rank, a.scale_log2, L2));
      }
    }
    // hand P^T to warpgroup 1 once it read the buffer's previous tile
    sm90::mbar_wait(&sm.p_empty[pb], ((n >> 1) & 1) ^ 1);
    float4* pt = reinterpret_cast<float4*>(sm.pt[pb]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pt[j * 128 + tid] =
          make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
    sm90::mbar_arrive(&sm.p_full[pb]);
    wide_pack(p, s);
    sm90::fence_regs(dv);
    sm90::wgmma_fence();
    issue_pb(dv, p, sm.dO[st][0], sizeof(sm.dO[st][0]));  // dV += P^T dO
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    if constexpr (decltype(next)::value) sm90::fence_regs(s2);
    if (l == 0) sm90::mbar_arrive(&sm.empty[st]);
  };
  const int nt = nq - q_first;
  sm90::mbar_wait(&sm.own_full, 0);
  issue(0, sa);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sa);
  int n = 0;
  for (; n + 2 < nt; n += 2) {
    step(n, sa, sb, std::true_type{});
    step(n + 1, sb, sa, std::true_type{});
  }
  if (n + 1 < nt) {
    step(n, sa, sb, std::true_type{});
    step(n + 1, sb, sa, std::false_type{});
  } else {
    step(n, sa, sb, std::false_type{});
  }
  store_wg(dv, 1.f, static_cast<bf16*>(a.out1) + rank * HALF, a.so1, b, h,
           kj * kWbRows, rl, t);
}

// dK/dV warpgroup 1: dP^T (this block's partial, then the cluster's),
// dS^T = P^T (dP^T - dsum), dK += dS^T Q over the block's columns.
template <int D>
__device__ __forceinline__ void cl_dk_consumer(ClDkvSmem<D>& sm,
                                               const WgBwdArgs& a, int rank,
                                               int kj, int q_first, int nq,
                                               int b, int h) {
  constexpr int NS = ClDkvSmem<D>::NS, HALF = D / 2;
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int tid = threadIdx.x % 128;
  const int rl = 16 * (tid / 32) + g;
  const uint32_t peer = rank ^ 1;
  float dk[HALF / 2], da[16], db[16];
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) dk[i] = 0.f;
  // dP^T = V dO^T of the n-th streamed tile, this block's partial, into d:
  // issued and committed
  auto issue = [&](int n, float (&d)[16]) {
    const int st = n % NS;
    sm90::mbar_wait(&sm.full[st], (n / NS) & 1);
    sm90::wgmma_fence();
    issue_s<HALF>(d, sm.v[0], sizeof(sm.v[0]), sm.dO[st][0],
                  sizeof(sm.dO[st][0]));
    sm90::wgmma_commit();
  };
  // the n-th tile, its partial in d; with `next`, the next tile's partial
  // is issued into d2 before the exchange and waited for at the end
  auto step = [&](int n, float (&d)[16], float (&d2)[16], auto next) {
    const int st = n % NS, pb = n & 1;
    float* xs = sm.x[1][pb];
    cl_push(d, sm90::map_cluster(xs + 4 * tid, peer),
            sm90::map_cluster(&sm.x_full[1][pb], peer));
    if constexpr (decltype(next)::value) issue(n + 1, d2);
    cl_meet(&sm.x_full[1][pb], kWbRows * kClTile * 4, (n >> 1) & 1, tid);
    const float* Ds = sm.dsum[st];
    const float* ys = xs + 4 * tid;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 d2s = *reinterpret_cast<const float2*>(Ds + 8 * j + 2 * t);
      const float4 y4 = *reinterpret_cast<const float4*>(ys + 512 * j);
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[4 * j + e] =
            cl_dp(d[4 * j + e], y[e], rank, (e & 1) ? d2s.y : d2s.x);
    }
    sm90::mbar_wait(&sm.p_full[pb], (n >> 1) & 1);
    const float4* pt = reinterpret_cast<const float4*>(sm.pt[pb]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 pv = pt[j * 128 + tid];
      d[4 * j] *= pv.x;  // dS^T
      d[4 * j + 1] *= pv.y;
      d[4 * j + 2] *= pv.z;
      d[4 * j + 3] *= pv.w;
    }
    sm90::mbar_arrive(&sm.p_empty[pb]);
    wide_pack(p, d);
    sm90::fence_regs(dk);
    sm90::wgmma_fence();
    issue_pb(dk, p, sm.q[st][0], sizeof(sm.q[st][0]));  // dK += dS^T Q
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dk);
    if constexpr (decltype(next)::value) sm90::fence_regs(d2);
    if (l == 0) sm90::mbar_arrive(&sm.empty[st]);
  };
  const int nt = nq - q_first;
  sm90::mbar_wait(&sm.own_full, 0);
  issue(0, da);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(da);
  int n = 0;
  for (; n + 2 < nt; n += 2) {
    step(n, da, db, std::true_type{});
    step(n + 1, db, da, std::true_type{});
  }
  if (n + 1 < nt) {
    step(n, da, db, std::true_type{});
    step(n + 1, db, da, std::false_type{});
  } else {
    step(n, da, db, std::false_type{});
  }
  store_wg(dk, a.scale, static_cast<bf16*>(a.out0) + rank * HALF, a.so0, b,
           h, kj * kWbRows, rl, t);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const WgBwdArgs a) {
  using Sm = ClDkvSmem<D>;
  constexpr int NS = Sm::NS, BOXES = Sm::BOXES;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kj = blockIdx.y;  // under the causal mask: longest columns first
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int rank = (int)sm90::cluster_rank();  // the block's column half
  const int k0 = kj * kWbRows;
  // query tiles before the diagonal see none of these keys
  const int q_first = a.causal ? k0 / kClTile : 0;
  const int nq = a.Tq / kClTile;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.own_full, 2);  // K's and V's expected bytes
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&sm.full[s], 3);   // Q's, dO's, and L's with dsum's
      sm90::mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&sm.x_full[0][i], 1);  // the arming; bytes
      sm90::mbar_init(&sm.x_full[1][i], 1);
      sm90::mbar_init(&sm.p_full[i], 128);   // every thread of warpgroup 0
      sm90::mbar_init(&sm.p_empty[i], 128);  // every thread of warpgroup 1
    }
    sm90::mbar_fence_init();
  }
  sm90::cluster_sync();  // both blocks' barriers are initialized
  if (threadIdx.x >= 256) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const int c0 = rank * (D / 2);
      tma_rows<BOXES>(sm.k[0], &tk, &sm.own_full, kWbRows, h, k0, b, c0);
      tma_rows<BOXES>(sm.v[0], &tv, &sm.own_full, kWbRows, h, k0, b, c0);
      const float* lse = a.lse + (long long)bh * a.Tq;
      const float* dsum = a.dsum + (long long)bh * a.Tq;
      for (int qi = q_first; qi < nq; ++qi) {
        const int n = qi - q_first, s = n % NS, r0 = qi * kClTile;
        // a stage is refilled once every consumer warp released it
        sm90::mbar_wait(&sm.empty[s], ((n / NS) & 1) ^ 1);
        tma_rows<BOXES>(sm.q[s][0], &tq, &sm.full[s], kClTile, h, r0, b, c0);
        tma_rows<BOXES>(sm.dO[s][0], &tdo, &sm.full[s], kClTile, h, r0, b,
                        c0);
        sm90::mbar_expect_tx(&sm.full[s], 2 * kClTile * 4);
        sm90::bulk_load(sm.lse[s], lse + r0, kClTile * 4, &sm.full[s]);
        sm90::bulk_load(sm.dsum[s], dsum + r0, kClTile * 4, &sm.full[s]);
      }
    }
  } else if (threadIdx.x < 128) {
    sm90::setmaxnreg_inc<232>();
    cl_dv_consumer<D>(sm, a, rank, kj, q_first, nq, b, h);
  } else {
    sm90::setmaxnreg_inc<232>();
    cl_dk_consumer<D>(sm, a, rank, kj, q_first, nq, b, h);
  }
  sm90::cluster_sync();  // no block exits while its peer may push into it
}

// ================================= f32: split-TF32 tensor-core kernels
// The f32 forward, dQ and dK/dV at every head dim run every product of
// the body on the tensor cores in split TF32 ("3xTF32"), the counterpart
// of the reference's HIGHEST precision (bf16x3
// passes on the MXU, ops/kernel_dispatch.py): each operand x is split once
// into big = rna_tf32(x) and small = rna_tf32(x - big), and
// a.b ~ a_small.b_big + a_big.b_small + a_big.b_big (small terms first),
// accumulated in f32 by mma.sync m16n8k8. The tensor cores ignore the low
// 13 bits of an f32 register, so an operand that skipped the conversion
// would lose accuracy without any error: every operand goes through
// split_tf32. Scores, softmax statistics and accumulators stay f32 in
// registers. The kernels of this section take D = 128; at D = 256, 384
// and 512 all three run as thread block clusters of D / 128 blocks, one
// 128-column slice each, that share the scores (the section after these
// kernels).
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
//    split tiles, and the warps read both parts (PRE: the backward; the
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
// A block accumulates all kTfCols = D output columns; dQ and the forward
// take their query tiles in reverse, so under the causal mask the longest
// rows start first.
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
constexpr int kTfKeys = 32;   // rows of a streamed tile

__host__ __device__ constexpr int tf_ld(int W) { return W + 4; }

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

// split-TF32 fragments and products on mma.sync m16n8k8 (sm90.cuh)
using sm90::add_acc;
using sm90::mma3;
using sm90::mma_tf32;
using sm90::TfA;
using sm90::TfB;

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
// V, or Q and dO) and the streamed rows' L and dsum (dK/dV); when PRE
// (the backward) the split parts of the current pair and a copy of its L
// and dsum. Stage s starts at stages + s * kStage.
template <bool FWD>
struct TfSmem {
  static constexpr int KB = kTfKeys, LD = tf_ld(kTfCols);
  static constexpr bool PRE = !FWD;
  static constexpr int kT = KB * LD;  // floats a tile
  static constexpr int kStage = (2 * kT + 2 * KB + 31) / 32 * 32;
  float *own0, *own1, *stages;
  float *big0 = nullptr, *small0 = nullptr, *big1 = nullptr,
        *small1 = nullptr, *ls = nullptr, *ds = nullptr;
  __host__ __device__ static size_t carve(Carver& c, TfSmem* t) {
    TfSmem x;
    x.own0 = c.take<float>(kTfBlk * LD);
    x.own1 = FWD ? nullptr : c.take<float>(kTfBlk * LD);
    x.stages = c.take<float>(2 * kStage);
    if (PRE) {
      x.big0 = c.take<float>(kT);
      x.small0 = c.take<float>(kT);
      x.big1 = c.take<float>(kT);
      x.small1 = c.take<float>(kT);
      x.ls = c.take<float>(KB);
      x.ds = c.take<float>(KB);
    }
    if (t) *t = x;
    return c.off;
  }
  __device__ float* raw0(int s) const { return stages + s * kStage; }
  __device__ float* raw1(int s) const { return raw0(s) + kT; }
  __device__ float* lse(int s) const { return raw1(s) + kT; }
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
    split_tile<Sm::kT>(sm.raw0(s), sm.big0, sm.small0);
    split_tile<Sm::kT>(sm.raw1(s), sm.big1, sm.small1);
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

// The forward's online softmax over one streamed tile of KB keys from k0:
// the scores s (raw products) scaled and masked, the running maximum m
// and sum lsum of this lane's rows (row, row + 8) moved on, O rescaled,
// and P left in s for P V.
template <int NS, int NO>
__device__ __forceinline__ void tf_softmax_step(float (&s)[NS][4],
                                                float (&o)[NO][4],
                                                float (&m)[2],
                                                float (&lsum)[2],
                                                const Args& a, int k0,
                                                int row) {
  const int t = threadIdx.x % 4;
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
}

// The forward's end: O divided by the row sums and stored into columns
// c0 .. c0 + 8 NO of this lane's rows; L = m + log l too when `with_lse`
// (and the caller asked for L).
template <int NO>
__device__ __forceinline__ void tf_fwd_store(float (&o)[NO][4],
                                             const float (&m)[2],
                                             float (&lsum)[2], const Args& a,
                                             int bh, int row, int c0,
                                             bool with_lse) {
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
  store_acc_tf32(o, 1.f, a.out0, a.so0, bh / a.H, bh % a.H, row, c0);
  if (with_lse && a.lse != nullptr && threadIdx.x % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a.lse[(long long)bh * a.Tq + row + 8 * i] =
          lsum[i] > 0.f ? m[i] + logf(lsum[i]) : kNegInf;
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_tf32_kernel(const Args a) {
  using Sm = TfSmem<true>;
  constexpr int D = kTfCols, BLK = kTfBlk, KB = Sm::KB, LD = Sm::LD;
  constexpr int NO = D / 8, NS = KB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  Sm sm;
  Sm::carve(cv, &sm);
  const int qi = gridDim.y - 1 - blockIdx.y, bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H, q0 = qi * BLK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int r0 = 16 * warp;
  const int row = q0 + r0 + perm8(l / 4);  // this lane's rows: row, row + 8
  // key tiles strictly above the diagonal contribute nothing
  const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB;
  auto stage_kv = [&](int kj) {
    if (kj < nk) {
      const int k0 = kj * KB;
      stage16<KB, D, LD>(sm.raw0(kj & 1),
                         row_ptr<float>(a.k, a.sk, b, h, k0), a.sk.t);
      stage16<KB, D, LD>(sm.raw1(kj & 1),
                         row_ptr<float>(a.v, a.sv, b, h, k0), a.sv.t);
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
      tf_softmax_step(s, o, m, lsum, a, k0, row);
      warp_pb_tf32<NO, NS, LD, Sm::PRE>(o, s, kv.tile[1]);
    }
    // without PRE the raw stage is read until here: restaged two tiles on
    if constexpr (!Sm::PRE) __syncthreads();
  }
  cp_async_wait<0>();
  tf_fwd_store(o, m, lsum, a, bh, row, 0, true);
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tf32_kernel(const Args a) {
  using Sm = TfSmem<false>;
  constexpr int D = kTfCols, BLK = kTfBlk, KB = Sm::KB, LD = Sm::LD;
  constexpr int NO = D / 8, NS = KB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  Sm sm;  // own: Q, dO; streamed: K, V
  Sm::carve(cv, &sm);
  const int qi = gridDim.y - 1 - blockIdx.y, bh = blockIdx.x;
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
      warp_pb_tf32<NO, NS, LD, Sm::PRE>(dq, s, kv.tile[0]);  // dS K
    }
    if constexpr (!Sm::PRE) __syncthreads();
  }
  cp_async_wait<0>();
  store_acc_tf32(dq, a.scale, a.out0, a.so0, b, h, row, 0);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_tf32_kernel(const Args a) {
  using Sm = TfSmem<false>;
  constexpr int D = kTfCols, BLK = kTfBlk, KB = Sm::KB, LD = Sm::LD;
  constexpr int NO = D / 8, NS = KB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  Sm sm;  // own: K, V; streamed: Q, dO with their L and dsum
  Sm::carve(cv, &sm);
  const int kj = blockIdx.y, bh = blockIdx.x;
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
      warp_pb_tf32<NO, NS, LD, Sm::PRE>(dv, s, st.tile[1]);   // P^T dO
      warp_pb_tf32<NO, NS, LD, Sm::PRE>(dk, dp, st.tile[0]);  // dS^T Q
    }
    if constexpr (!Sm::PRE) __syncthreads();
  }
  cp_async_wait<0>();
  store_acc_tf32(dk, a.scale, a.out0, a.so0, b, h, key, 0);
  store_acc_tf32(dv, 1.f, a.out1, a.so1, b, h, key, 0);
}

// ============ f32 at D = 256, 384, 512: split-TF32 thread block clusters
// The forward, dQ and dK/dV at the head dims above 128, with every score
// product computed once. Each 64-row tile (queries for the forward and
// dQ, keys for dK/dV) is one thread block cluster of C = D / 128 blocks
// along grid z (2 at D = 256, 3 at D = 384, 4 at D = 512). Member z owns
// columns 128 z .. 128 z + 127: that slice of its owned tiles (Q; Q, dO;
// K, V), of each streamed tile (K, V; K, V; Q, dO) and of its outputs (O;
// dQ; dK, dV), which is the D = 128 kernels' tile and register shape.
// Per streamed tile of 32 rows:
//  1. the block splits its slices of the streamed pair once, in place
//     (big parts over the raw tile, small parts beside it);
//  2. each warp computes partial S (and, backward, dP) of its 16 rows over
//     the member's 128 columns (fresh accumulators every two k-steps,
//     added in f32) and stores them to the step's partial buffer;
//  3. one barrier.cluster;
//  4. each warp reads the C members' partials of its rows through
//     distributed shared memory and adds them in rank order 0 .. C - 1, so
//     every member of the cluster holds bit-identical S (and dP), then the
//     same mask, online softmax statistics and P (forward), or P and dS;
//  5. the output products over the member's columns (P V; dS K; P^T dO
//     and dS^T Q).
// A grid-z split of the D = 128 kernels would have each of the C blocks
// recompute the full-D scores: C (C + 1) units of work where 2C do in the
// forward (1.5x at D = 256, 2.5x at D = 512), 2.3x the work of dQ at
// D = 384 and 2x that of dK/dV; its full-D owned tiles would also leave
// room for only 16-row streamed tiles. The partials are double-buffered,
// so the one cluster barrier of a step serves as "ready" (this step's
// partials are stored) and as "free" (a member writes a buffer again two
// steps on, after every peer has read it and arrived at the barrier
// between). Every member walks the same streamed tiles and its warps take
// the same causal skips, which skip products and never a barrier, so all
// arrive at each barrier; a last barrier keeps each member resident until
// its peers have read its final partials. The forward's member 0 writes
// L (every member holds the same m and l).
//
// Budget per block (128 threads, one block an SM), backward: owned slices
// 2 x 64 x 132 x 4 = 67,584 B; two stages of the streamed slices with the
// streamed rows' L and dsum, 2 x (2 x 32 x 132 + 64) x 4 = 68,096 B; the
// small parts of the current pair 33,792 B; partial S and dP, two buffers
// of 2 x 64 x 32 x 4 = 32,768 B: 202,240 B in all. Forward: the Q slice
// 33,792 B (split as each warp reads its rows, once per streamed tile: a
// Q split once in place, its small parts stored beside it, measured 2-3%
// slower); two stages of the K and V slices 67,584 B; the small parts of
// the current pair 33,792 B; partial S, two buffers of 64 x 32 x 4 =
// 16,384 B: 151,552 B in all (both under the 232,448 B a block may opt
// into). Registers as the D = 128 kernels' (ptxas: the forward 246 at
// every D, dQ 236 at D = 256 and 384, 244 at 512, no spills; dK/dV,
// which holds dK and dV in 128 a thread, 255 and 432-496 bytes of
// spills, as at D = 128); on an H100 (132 SMs) clusters of 2 blocks fit
// 66 at once, of 3 blocks 39, of 4 blocks 30 (the wrapper's
// `cluster_plan`). What bounds it: operations, as above; the
// exchange adds per step one cluster barrier and, per member, C reads of
// 8 KB (forward) or 16 KB (backward) of distributed shared memory.
template <bool FWD>
struct TcSmem {
  static constexpr int KB = kTfKeys, LD = tf_ld(kTfCols);
  static constexpr int kTile = KB * LD;  // a streamed slice
  // the pair (backward: with the streamed rows' L and dsum)
  static constexpr int kStage = 2 * kTile + (FWD ? 0 : 2 * KB);
  static constexpr int kPart = (FWD ? 1 : 2) * kTfBlk * KB;  // S (and dP)
  float *own0, *own1, *stages, *small, *part;
  __host__ __device__ static size_t carve(Carver& c, TcSmem* t) {
    TcSmem x;
    x.own0 = c.take<float>(kTfBlk * LD);
    x.own1 = FWD ? nullptr : c.take<float>(kTfBlk * LD);
    x.stages = c.take<float>(2 * kStage);
    x.small = c.take<float>(2 * kTile);
    x.part = c.take<float>(2 * kPart);
    if (t) *t = x;
    return c.off;
  }
  __device__ float* raw0(int s) const { return stages + s * kStage; }
  __device__ float* raw1(int s) const { return raw0(s) + kTile; }
  __device__ float* lse(int s) const { return raw1(s) + kTile; }
  __device__ float* dsum(int s) const { return lse(s) + KB; }
  // the partial buffer of streamed step n
  __device__ float* partial(int n) const { return part + (n & 1) * kPart; }
};

// Step 1: the streamed pair of stage s split in place by the block, and
// the barrier after it (the forward's stage has no L and dsum).
template <bool FWD>
__device__ __forceinline__ TfStage tc_split(const TcSmem<FWD>& sm, int s) {
  constexpr int N = TcSmem<FWD>::kTile;
  split_tile<N>(sm.raw0(s), sm.raw0(s), sm.small);
  split_tile<N>(sm.raw1(s), sm.raw1(s), sm.small + N);
  __syncthreads();
  return {{{sm.raw0(s), sm.small}, {sm.raw1(s), sm.small + N}},
          FWD ? nullptr : sm.lse(s), FWD ? nullptr : sm.dsum(s)};
}

// Step 2: a thread's partial S in fragment order, n-tile j at float4
// j * kThreads + threadIdx.x, so each warp access is 512 contiguous
// bytes; the backward's dP follows S, at (NS + j) * kThreads + ....
template <int NS>
__device__ __forceinline__ void put_partial(float* part,
                                            const float (&s)[NS][4]) {
  float* p = part + 4 * threadIdx.x;
#pragma unroll
  for (int j = 0; j < NS; ++j)
    sts128(p + 4 * kThreads * j,
           make_float4(s[j][0], s[j][1], s[j][2], s[j][3]));
}

template <int NS>
__device__ __forceinline__ void put_partial(float* part,
                                            const float (&s)[NS][4],
                                            const float (&dp)[NS][4]) {
  put_partial(part, s);
  put_partial(part + 4 * kThreads * NS, dp);
}

// Step 4: one accumulator fragment over all of D, the C members' partials
// at `p` added in rank order (the same order in every member, so the same
// bits).
template <int C>
__device__ __forceinline__ void sum_ranks(const float* p, float (&d)[4]) {
  float4 x = sm90::ld_cluster_v4(p, 0);
#pragma unroll
  for (int r = 1; r < C; ++r) {
    const float4 y = sm90::ld_cluster_v4(p, r);
    x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
  }
  d[0] = x.x, d[1] = x.y, d[2] = x.z, d[3] = x.w;
}

template <int C, int NS>
__device__ __forceinline__ void sum_partials(const float* part,
                                             float (&s)[NS][4]) {
  const float* p = part + 4 * threadIdx.x;
#pragma unroll
  for (int j = 0; j < NS; ++j) sum_ranks<C>(p + 4 * kThreads * j, s[j]);
}

template <int C, int NS>
__device__ __forceinline__ void sum_partials(const float* part,
                                             float (&s)[NS][4],
                                             float (&dp)[NS][4]) {
  sum_partials<C>(part, s);
  sum_partials<C>(part + 4 * kThreads * NS, dp);
}

// The forward: O and L of one 64-row query tile, this member's columns
// of O (steps 1-5 above, P V as the output product).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tf32_cluster_kernel(const Args a) {
  using Sm = TcSmem<true>;
  constexpr int C = D / kTfCols, BLK = kTfBlk, KB = Sm::KB;
  constexpr int LD = Sm::LD, NO = kTfCols / 8, NS = KB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  Sm sm;  // own: Q; streamed: K, V (this member's columns)
  Sm::carve(cv, &sm);
  const int qi = gridDim.y - 1 - blockIdx.y, bh = blockIdx.x;
  const int c0 = kTfCols * blockIdx.z;  // member z's columns
  const int b = bh / a.H, h = bh % a.H, q0 = qi * BLK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int r0 = 16 * warp;
  const int row = q0 + r0 + perm8(l / 4);  // this lane's rows: row, row + 8
  // key tiles strictly above the diagonal contribute nothing
  const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB;
  auto stage_kv = [&](int kj) {
    if (kj < nk) {
      const int k0 = kj * KB;
      stage16<KB, kTfCols, LD>(
          sm.raw0(kj & 1), row_ptr<float>(a.k, a.sk, b, h, k0) + c0, a.sk.t);
      stage16<KB, kTfCols, LD>(
          sm.raw1(kj & 1), row_ptr<float>(a.v, a.sv, b, h, k0) + c0, a.sv.t);
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  stage16<BLK, kTfCols, LD>(
      sm.own0, row_ptr<float>(a.q, a.sq, b, h, q0) + c0, a.sq.t);
  stage_kv(0);
  float o[NO][4], m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
  zero_acc(o);
  for (int kj = 0; kj < nk; ++kj) {
    cp_async_wait<0>();  // the K, V slices of tile kj staged
    __syncthreads();     // ... and every warp done with kj - 1
    stage_kv(kj + 1);    // copied during this step
    const TfStage kv = tc_split(sm, kj & 1);  // K, V
    const int k0 = kj * KB;
    // a tile wholly after the diagonal of this warp's 16 rows adds nothing
    // (the same warps skip in every member)
    const bool live = !a.causal || k0 <= q0 + r0 + 15;
    float s[NS][4];
    if (live) {
      zero_acc(s);
      warp_abt_tf32<NS, kTfCols, LD, true>(s, sm.own0, r0,
                                           kv.tile[0]);  // Q K^T
      put_partial(sm.partial(kj), s);
    }
    sm90::cluster_sync();  // every member's partial scores of tile kj stored
    if (live) {
      sum_partials<C>(sm.partial(kj), s);
      tf_softmax_step(s, o, m, lsum, a, k0, row);
      warp_pb_tf32<NO, NS, LD, true>(o, s, kv.tile[1]);  // P V
    }
  }
  cp_async_wait<0>();
  sm90::cluster_sync();  // the peers have read this member's last partials
  tf_fwd_store(o, m, lsum, a, bh, row, c0, blockIdx.z == 0);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_tf32_cluster_kernel(const Args a) {
  using Sm = TcSmem<false>;
  constexpr int C = D / kTfCols, BLK = kTfBlk, KB = Sm::KB;
  constexpr int LD = Sm::LD, NO = kTfCols / 8, NS = KB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  Sm sm;  // own: Q, dO; streamed: K, V (this member's columns)
  Sm::carve(cv, &sm);
  const int qi = gridDim.y - 1 - blockIdx.y, bh = blockIdx.x;
  const int c0 = kTfCols * blockIdx.z;  // member z's columns
  const int b = bh / a.H, h = bh % a.H, q0 = qi * BLK;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int t = l % 4, r0 = 16 * warp;
  const int row = q0 + r0 + perm8(l / 4);  // this lane's rows: row, row + 8
  const int nk = a.causal ? (q0 + BLK) / KB : a.Tk / KB;
  auto stage_kv = [&](int kj) {
    if (kj < nk) {
      const int k0 = kj * KB;
      stage16<KB, kTfCols, LD>(
          sm.raw0(kj & 1), row_ptr<float>(a.k, a.sk, b, h, k0) + c0, a.sk.t);
      stage16<KB, kTfCols, LD>(
          sm.raw1(kj & 1), row_ptr<float>(a.v, a.sv, b, h, k0) + c0, a.sv.t);
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  stage16<BLK, kTfCols, LD>(
      sm.own0, row_ptr<float>(a.q, a.sq, b, h, q0) + c0, a.sq.t);
  stage16<BLK, kTfCols, LD>(
      sm.own1, row_ptr<float>(a.dO, a.sdo, b, h, q0) + c0, a.sdo.t);
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
    cp_async_wait<0>();  // K, V of tile kj staged
    __syncthreads();     // ... and every warp done with tile kj - 1
    stage_kv(kj + 1);    // copied during this step
    const TfStage kv = tc_split(sm, kj & 1);
    const int k0 = kj * KB;
    // a tile wholly after the diagonal of this warp's 16 rows adds nothing
    // (the same warps skip in every member)
    const bool live = !a.causal || k0 <= q0 + r0 + 15;
    float s[NS][4], dp[NS][4];
    if (live) {
      zero_acc(s);
      zero_acc(dp);
      warp_abt_tf32<NS, kTfCols, LD, true>(s, sm.own0, r0,
                                           kv.tile[0]);  // Q K^T
      warp_abt_tf32<NS, kTfCols, LD, true>(dp, sm.own1, r0,
                                           kv.tile[1]);  // dO V^T
      put_partial(sm.partial(kj), s, dp);
    }
    sm90::cluster_sync();  // every member's partials of tile kj stored
    if (live) {
      sum_partials<C>(sm.partial(kj), s, dp);
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
      warp_pb_tf32<NO, NS, LD, true>(dq, s, kv.tile[0]);  // dS K
    }
  }
  cp_async_wait<0>();
  sm90::cluster_sync();  // the peers have read this member's last partials
  store_acc_tf32(dq, a.scale, a.out0, a.so0, b, h, row, c0);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_tf32_cluster_kernel(const Args a) {
  using Sm = TcSmem<false>;
  constexpr int C = D / kTfCols, BLK = kTfBlk, KB = Sm::KB;
  constexpr int LD = Sm::LD, NO = kTfCols / 8, NS = KB / 8;
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
      stage16<KB, kTfCols, LD>(
          sm.raw0(s), row_ptr<float>(a.q, a.sq, b, h, qi * KB) + c0, a.sq.t);
      stage16<KB, kTfCols, LD>(
          sm.raw1(s), row_ptr<float>(a.dO, a.sdo, b, h, qi * KB) + c0,
          a.sdo.t);
      stage_f32_row<KB>(sm.lse(s), a.lse + (long long)bh * a.Tq + qi * KB);
      stage_f32_row<KB>(sm.dsum(s), a.dsum + (long long)bh * a.Tq + qi * KB);
    }
    cp_async_commit();
  };
  stage16<BLK, kTfCols, LD>(
      sm.own0, row_ptr<float>(a.k, a.sk, b, h, k0) + c0, a.sk.t);
  stage16<BLK, kTfCols, LD>(
      sm.own1, row_ptr<float>(a.v, a.sv, b, h, k0) + c0, a.sv.t);
  stage_q(q_first);
  float dk[NO][4], dv[NO][4];
  zero_acc(dk);
  zero_acc(dv);
  for (int qi = q_first; qi < nq; ++qi) {
    const int n = qi - q_first;
    cp_async_wait<0>();  // Q, dO, L, dsum of tile qi staged
    __syncthreads();     // ... and every warp done with tile qi - 1
    stage_q(qi + 1);
    const TfStage st = tc_split(sm, n & 1);
    const int q0 = qi * KB;
    // a tile of queries wholly before this warp's 16 keys sees none of them
    const bool live = !a.causal || q0 + KB - 1 >= k0 + r0;
    // rows of these tiles are keys, columns queries
    float s[NS][4], dp[NS][4];
    if (live) {
      zero_acc(dp);
      warp_abt_tf32<NS, kTfCols, LD, true>(dp, sm.own1, r0,
                                           st.tile[1]);  // V dO^T = dP^T
      zero_acc(s);
      warp_abt_tf32<NS, kTfCols, LD, true>(s, sm.own0, r0,
                                           st.tile[0]);  // K Q^T = S^T
      put_partial(sm.partial(n), s, dp);
    }
    sm90::cluster_sync();  // every member's partials of tile qi stored
    if (live) {
      sum_partials<C>(sm.partial(n), s, dp);
      // P^T into s, dS^T into dp (so that P^T dies with the dV product)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + t + 4 * (e & 1);
          float x = s[j][e] * a.scale;
          if (a.causal && key + 8 * (e >> 1) > q0 + col) x = kNegInf;
          s[j][e] = x <= kNegInf * 0.5f ? 0.f : expf(x - st.L[col]);
          dp[j][e] = s[j][e] * (dp[j][e] - st.Ds[col]);
        }
      warp_pb_tf32<NO, NS, LD, true>(dv, s, st.tile[1]);   // P^T dO
      warp_pb_tf32<NO, NS, LD, true>(dk, dp, st.tile[0]);  // dS^T Q
    }
  }
  cp_async_wait<0>();
  sm90::cluster_sync();  // the peers have read this member's last partials
  store_acc_tf32(dk, a.scale, a.out0, a.so0, b, h, key, c0);
  store_acc_tf32(dv, 1.f, a.out1, a.so1, b, h, key, c0);
}

// ------------------------------------------------------------- launches
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// The kernel family that runs (kind, dtype, D): 0 split TF32 in clusters
// of D / 128 blocks (f32 at D = 256-512), 1 split TF32 (f32 at D = 128),
// 2 bf16 wgmma in clusters of two blocks (the backward at D = 384, 512),
// 3 bf16 wgmma (D = 128), 4 bf16 wgmma at D >= 256 (the forward at
// D = 256-512, D split over two warpgroups; the backward at D = 256).
enum Route {
  kTf32Cluster = 0,
  kTf32 = 1,
  kWgmmaCluster = 2,
  kWgmma = 3,
  kWide = 4
};
__host__ __device__ constexpr int route_of(int kind, int dtype, int D) {
  if (dtype == 1)
    return D == 128 ? kWgmma
           : kind == kFwd || D == 256 ? kWide
                                      : kWgmmaCluster;
  return D == 128 ? kTf32 : kTf32Cluster;
}

template <int D>
size_t smem_f32(int kind) {
  Carver c{nullptr};
  if (D == 128)
    return kind == kFwd ? TfSmem<true>::carve(c, nullptr)
                        : TfSmem<false>::carve(c, nullptr);
  return kind == kFwd ? TcSmem<true>::carve(c, nullptr)
                      : TcSmem<false>::carve(c, nullptr);
}

template <int D>
size_t smem_bf16(int kind) {
  if (D == 128)
    return kind == kFwd ? kWgSmemBytes
           : kind == kDq ? kDqSmemBytes
                         : kDkvSmemBytes;
  if (kind == kFwd) return wide_smem_bytes<D>();
  if (D == 256) return kind == kDq ? kWbDqSmemBytes : kWbDkvSmemBytes;
  // + alignment
  return (kind == kDq ? sizeof(ClDqSmem<D>) : sizeof(ClDkvSmem<D>)) + 1024;
}

// The bf16 wgmma kernels read each input through one 4-D tensor map over
// (D, H, T, B) with the tensor's own strides (16-byte multiples, checked
// by the wrapper), boxes of 64 x 1 x `rows` x 1, built at each call.
int make_bthd_map(CUtensorMap* map, const void* base, const Strides& s,
                  int H, int T, int B, int rows, int D = 128) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
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

// The bf16 forward at D >= 256: blocks of 64 query rows, grid (B * H,
// query tiles), K/V maps with boxes of KB rows.
template <int D>
int launch_fwd_wide(const Args& a, cudaStream_t st) {
  constexpr int KB = wide_kb(D);
  CUtensorMap maps[3];
  int rc = make_bthd_map(&maps[0], a.q, a.sq, a.H, a.Tq, a.B, kWideRows, D);
  if (!rc) rc = make_bthd_map(&maps[1], a.k, a.sk, a.H, a.Tk, a.B, KB, D);
  if (!rc) rc = make_bthd_map(&maps[2], a.v, a.sv, a.H, a.Tk, a.B, KB, D);
  if (rc) return rc;
  const WgFwdArgs w{a.out0, a.lse, a.so0, a.H, a.Tq, a.Tk, a.causal,
                    a.scale * kLog2e};
  constexpr size_t smem = wide_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_wide_kernel<D><<<dim3(a.B * a.H, a.Tq / kWideRows), kWgThreads,
                              smem, st>>>(maps[0], maps[1], maps[2], w);
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

// The bf16 D = 256 backward: dQ blocks of 64 query rows and K/V tiles of
// 32 keys, dK/dV blocks of 64 keys and Q/dO tiles of 64 queries.
int launch_bwd_wide(int kind, const Args& a, cudaStream_t st) {
  const bool dq = kind == kDq;
  const int krows = dq ? kWbKeys : kWbRows;
  CUtensorMap maps[4];  // q, dO, k, v
  int rc = make_bthd_map(&maps[0], a.q, a.sq, a.H, a.Tq, a.B, kWbRows, 256);
  if (!rc)
    rc = make_bthd_map(&maps[1], a.dO, a.sdo, a.H, a.Tq, a.B, kWbRows, 256);
  if (!rc) rc = make_bthd_map(&maps[2], a.k, a.sk, a.H, a.Tk, a.B, krows, 256);
  if (!rc) rc = make_bthd_map(&maps[3], a.v, a.sv, a.H, a.Tk, a.B, krows, 256);
  if (rc) return rc;
  const WgBwdArgs w{a.lse, a.dsum, a.out0, a.out1, a.so0, a.so1, a.H,
                    a.Tq, a.Tk, a.causal, a.scale, a.scale * kLog2e};
  const size_t smem = dq ? kWbDqSmemBytes : kWbDkvSmemBytes;
  cudaError_t e = dq ? cudaFuncSetAttribute(
                           flash_bwd_dq_wide_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem)
                     : cudaFuncSetAttribute(
                           flash_bwd_dkv_wide_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.B * a.H, (dq ? a.Tq : a.Tk) / kWbRows);
  if (dq)
    flash_bwd_dq_wide_kernel<<<grid, kWgThreads, smem, st>>>(
        maps[0], maps[1], maps[2], maps[3], w);
  else
    flash_bwd_dkv_wide_kernel<<<grid, kWgThreads, smem, st>>>(
        maps[0], maps[1], maps[2], maps[3], w);
  return (int)cudaGetLastError();
}

// The bf16 backward at D = 384, 512 ("wgmma cluster"): clusters of two
// blocks along z, one column half each; dQ blocks of 64 query rows and
// K/V tiles of 32 keys, dK/dV blocks of 64 keys and Q/dO tiles of 32
// queries. Given `active`, not launched: how many clusters fit on the card
// at once, into `active`.
template <int D>
int launch_bwd_cluster(int kind, const Args& a, cudaStream_t st,
                       int* active) {
  const bool dq = kind == kDq;
  void (*kern)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
               WgBwdArgs) = dq ? flash_bwd_dq_cluster_kernel<D>
                               : flash_bwd_dkv_cluster_kernel<D>;
  const size_t smem = smem_bf16<D>(kind);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = active != nullptr
                    ? dim3(1, 1, 2)
                    : dim3(a.B * a.H, (dq ? a.Tq : a.Tk) / kWbRows, 2);
  cfg.blockDim = dim3(kWgThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(active, (const void*)kern,
                                               &cfg);
  // Q and dO: the dQ block's rows or the dK/dV tile's; K and V the reverse
  const int qrows = dq ? kWbRows : kClTile, krows = dq ? kClTile : kWbRows;
  CUtensorMap maps[4];  // q, dO, k, v
  int rc = make_bthd_map(&maps[0], a.q, a.sq, a.H, a.Tq, a.B, qrows, D);
  if (!rc)
    rc = make_bthd_map(&maps[1], a.dO, a.sdo, a.H, a.Tq, a.B, qrows, D);
  if (!rc) rc = make_bthd_map(&maps[2], a.k, a.sk, a.H, a.Tk, a.B, krows, D);
  if (!rc) rc = make_bthd_map(&maps[3], a.v, a.sv, a.H, a.Tk, a.B, krows, D);
  if (rc) return rc;
  WgBwdArgs w{a.lse, a.dsum, a.out0, a.out1, a.so0, a.so1, a.H,
              a.Tq, a.Tk, a.causal, a.scale, a.scale * kLog2e};
  void* args[5] = {&maps[0], &maps[1], &maps[2], &maps[3], &w};
  e = cudaLaunchKernelExC(&cfg, (const void*)kern, args);
  if (e != cudaSuccess) return (int)e;
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

// The split-TF32 cluster kernel `kind` over `grid`, one cluster of the
// D / 128 blocks along z per row tile, launched after the kernel's
// shared-memory limit is raised; or, given `active`, not launched: how
// many clusters fit on the card at once, into `active`.
template <int D>
int run_cluster(int kind, dim3 grid, const Args& a, cudaStream_t st,
                int* active) {
  void (*kern)(const Args) = kind == kFwd ? flash_fwd_tf32_cluster_kernel<D>
                             : kind == kDq
                                 ? flash_bwd_dq_tf32_cluster_kernel<D>
                                 : flash_bwd_dkv_tf32_cluster_kernel<D>;
  const size_t smem = smem_f32<D>(kind);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = D / kTfCols;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(active, (const void*)kern,
                                               &cfg);
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Split TF32: blocks of kTfBlk rows, grid (B * H, row tiles, D / kTfCols
// column slices), above D = 128 the blocks in clusters along z.
template <int D>
int launch_f32(int kind, const Args& a, cudaStream_t st) {
  const int rows = kind == kDkv ? a.Tk : a.Tq;
  const dim3 grid(a.B * a.H, rows / kTfBlk, D / kTfCols);
  if constexpr (D == 128)
    return run(kind == kFwd ? flash_fwd_tf32_kernel
               : kind == kDq ? flash_bwd_dq_tf32_kernel
                             : flash_bwd_dkv_tf32_kernel,
               smem_f32<D>(kind), grid, a, st);
  else
    return run_cluster<D>(kind, grid, a, st, nullptr);
}

template <int D>
int launch_bf16(int kind, const Args& a, cudaStream_t st) {
  if constexpr (D == 128) {
    return kind == kFwd ? launch_fwd_wgmma(a, st)
                        : launch_bwd_wgmma(kind, a, st);
  } else if constexpr (D == 256) {
    return kind == kFwd ? launch_fwd_wide<D>(a, st)
                        : launch_bwd_wide(kind, a, st);
  } else {
    return kind == kFwd ? launch_fwd_wide<D>(a, st)
                        : launch_bwd_cluster<D>(kind, a, st, nullptr);
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

// The multiple the sequence lengths must be: 128 (the JAX package's
// smallest tile, which its flash route asks for) where the family has
// tiles of 128 rows or takes no other, 64 for the bf16 kernels at
// D >= 256 (the forward's and the backward's blocks hold 64 rows, their
// streamed tiles 64 or 32).
int dl4j_flash_block_rows(int dtype, int D) {
  return dtype == 1 && D != 128 ? kWideRows : 128;
}

// The kernel family that runs kernel `kind` (0 forward, 1 dQ, 2 dK/dV) at
// dtype and D: 0 f32 split TF32 on mma.sync in thread block clusters of
// D / 128 blocks (D = 256-512), 1 f32 split TF32 on mma.sync (D = 128), 2
// bf16 wgmma in clusters of two blocks
// ("wgmma cluster": the backward at D = 384, 512), 3 bf16 wgmma
// (D = 128), 4 bf16 wgmma at D >= 256 ("wgmma wide": the forward at
// D = 256-512, the backward at D = 256); -1 for an unsupported D.
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

// The clusters of kernel `kind` (0 forward, 1 dQ, 2 dK/dV) at dtype (0
// f32, 1 bf16) and head dim D: the blocks a cluster holds into `cluster`,
// and how many such clusters fit on the card at once into `active`;
// `cluster` 1 and `active` 0 where the kernel runs no clusters. Returns a
// cudaError_t.
int dl4j_flash_cluster_plan(int kind, int dtype, int D, int* cluster,
                            int* active) {
  *cluster = 1;
  *active = 0;
  const int rc = with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if constexpr (route_of(kFwd, 0, kD) == kTf32Cluster) {
      if (dtype == 0) {
        *cluster = kD / kTfCols;
        return run_cluster<kD>(kind, dim3(1, 1, kD / kTfCols), Args{},
                               nullptr, active);
      }
    }
    if constexpr (route_of(kDq, 1, kD) == kWgmmaCluster) {
      if (dtype == 1 && kind != kFwd) {
        *cluster = 2;
        return launch_bwd_cluster<kD>(kind, Args{}, nullptr, active);
      }
    }
    return 0;
  });
  return rc < 0 ? (int)cudaErrorInvalidValue : rc;
}

}  // extern "C"
