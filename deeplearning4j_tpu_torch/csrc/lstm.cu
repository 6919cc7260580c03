// The Graves LSTM time loop (peepholes, gate order [i, f, o, g]) as one
// persistent kernel per layer, direction and pass, on Hopper (sm_90a).
//
// Replaces the TPU kernels of deeplearning4j_tpu/ops/pallas_lstm.py:
//   <- _lstm_fwd_kernel (glue _fwd_call), and masked
//      <- _lstm_fwd_kernel_masked (glue _fwd_call_masked):
//        lstm_fwd_cluster_kernel<ROWS, MASKED, *> (bf16),
//        lstm_fwd_kernel<bf16, MASKED, *> (bf16, B <= 128 and H <= 1024),
//        lstm_fwd_f32_kernel<MASKED, *> (f32);
//   <- _lstm_bwd_kernel (glue _bwd_call), and masked
//      <- _lstm_bwd_kernel_masked (glue _bwd_call_masked):
//        lstm_bwd_cluster_kernel<MASKED> (bf16),
//        lstm_bwd_f32_kernel<MASKED> (f32).
// Same contract. Forward, per step t (walked T-1..0 with `reverse`):
//   z = xw[t] + h @ RW;  i = sig(zi + pI c);  f = sig(zf + pF c);
//   g = tanh(zg);  c' = f c + i g;  o = sig(zo + pO c');  h' = o tanh(c').
// Masked (binary mask, m > 0 selects): h_sel = m>0 ? h' : h,
// c_sel = m>0 ? c' : c, output h_sel * m; the carry and the stash hold the
// selected values, hT the last selected h. The training stash is c (c_sel),
// h_sel and the post-activation gates. Backward, walking the other way: dz
// from the stash and the f32 carries dh, dc, written in xw's type, then
// dh_prev = dz . RW^T; dh0 and dc0 in f32 at the last backward step. The
// masked backward rebuilds the candidate c' = f c_prev + i g from the
// gates and routes the whole cotangent to one side of the select.
// Rounding points are the Pallas kernels': carries and the gate chain in
// f32 (the bf16 cluster forward takes sigmoid and tanh from ex2 and an
// approximate reciprocal, a few ulp of f32); product operands in the
// operand type (h rounded before the product, never carried rounded);
// h_out, c, gates and dz stored in xw's type.
//
// Every kernel rests on one fact: the recurrence does not couple batch
// rows (step t of rows m needs h[t-1] (or dz[t]) of rows m only), so no
// grid barrier is needed, only one among the blocks that share a tile of
// rows. The TPU kernel keeps all of RW in VMEM and walks a sequential grid
// axis; on Hopper a tile of batch rows is a thread block cluster, whose
// blocks each own a slice of the hidden units, compute their slice of the
// step's product and gate chain, and meet at barrier.cluster once per
// step. Clusters need not be resident together: the grid runs in waves.
//  - bf16 forward (lstm_fwd_cluster_kernel, rows 5 and 7): per step
//    z = h[t-1] . RW[:, the block's units' 4 gates] on wgmma m64n256k16
//    from a TMA ring (RW rearranged by the wrapper so a unit group's four
//    gates are contiguous K-major rows; h[t-1] multicast within the
//    cluster), the gate chain in the accumulator's registers, h_t stored
//    and fenced for the async proxy; 128 rows x 64 units per block up to
//    H = 1024, 64 x 128 above (16 blocks of 128 units is the most a
//    cluster holds, so H is at most 2048);
//  - bf16 backward (lstm_bwd_cluster_kernel, rows 6 and 8): per step the
//    cell phase (dz[t] of the block's rows and units from the stash and
//    the carries), the cluster barrier, then dh_prev = dz[t] . RW^T on
//    wgmma m64n128k16 from a TMA ring (dz[t] multicast within the
//    cluster); 128 rows x 128 units per block;
//  - f32 (the parity path, both passes; TF32 stays off): f32 FMAs on
//    operands staged in shared memory in chunks of 16, 32 rows x 128 units
//    per block, carries in registers; shared memory does not grow with H
//    or B.
// The bf16 forward at B <= 128 and H <= 1024 takes the cooperative kernel
// (lstm_fwd_kernel): a row tile there would stream all of RW through L2
// every step, while each cooperative block keeps its 8 units' slice of RW
// on chip for the whole launch and the grid meets at this_grid().sync()
// once per step (every block resident, or the launch is refused with
// cudaErrorCooperativeLaunchTooLarge; never a spin barrier without that
// guarantee); its products are mma.sync m16n8k16 with the h rows read
// from L2 (ld.global.cg) in the k order perm16 gives.
//
// What bounds it on an H100: per step the work is 2*B*H*4H flops against
// B*4H operand bytes in and B*(4H+2H) bytes of stash out; at the training
// shapes (bf16) the card's bound is the bytes at H=256 and the flops at
// H=1024 (chip_smoke.py prints both). The cluster kernels move (B / rows)
// x |RW| + |h| (forward) or + |dz[t]| (backward) through L2 per step
// (forward, B=2048, H=1024: 16 x 8 MB), against H/8 x |h| for the
// cooperative kernel's every-slice-reads-all-of-h. What holds the bf16
// forward back (clock64 per phase on an H100, B=2048, H=1024): the
// product, bound by L2 as each block streams its RW slice every step
// (about 26k cycles a step); three waves, since 16-block clusters fit 7 at
// once; the cell phase (about 12.5k cycles) and the wait for h_t's store
// before the barrier (about 7k). The backward's cell phase still follows
// the accumulator's layout (8 rows x 16 bytes per warp access) under the
// 168 registers a thread of these blocks gets. A remote mbarrier
// arrival releases at CTA scope: a cluster-scope release fences all of
// the thread's earlier stores at every arrival, which doubled the
// backward's product.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;   // hidden units per block
constexpr int kRows = 16;   // batch rows per mma tile
// 16-wide k chunks whose A loads are issued together before their
// products (forward): the loads come from L2, and enough must be in
// flight to cover its latency with one or two blocks per SM
constexpr int kFwdBatch = 8;

__host__ __device__ constexpr int ceil_to(int x, int m) {
  return (x + m - 1) / m * m;
}

// ------------------------------------------------------------ conversions
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename DT>
__device__ __forceinline__ DT from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// an element written during this launch by another block: read from L2
__device__ __forceinline__ float ld_l2(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
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

// Operand layout of the RW slice in shared memory: bf16 rows carry 8
// elements of padding (ldmatrix rows 16-byte aligned, spread over the
// banks).
template <typename DT>
struct Lay;
template <>
struct Lay<bf16> {
  static constexpr int kPad = 8;
};

// Forward: RW slice [32 columns][K], the four peepholes' rows of this
// block's units, and the c carry of its rows. K = Hp (H padded to 16).
template <typename DT>
struct FwdSmem {
  DT* rw;
  float* peep;  // [3][kUnits]
  float* c;     // [rows][kUnits]
  __host__ __device__ static size_t carve(Carver& cv, FwdSmem* s, int Hp,
                                          int rows) {
    FwdSmem x;
    x.rw = cv.take<DT>(size_t(4 * kUnits) * (Hp + Lay<DT>::kPad));
    x.peep = cv.take<float>(3 * kUnits);
    x.c = cv.take<float>(size_t(rows) * kUnits);
    if (s) *s = x;
    return cv.off;
  }
};

// Position inside a 16-wide k chunk at which element p of the chunk is
// stored for the mma B operand: lane t's 8-byte A load of elements 4t..4t+3
// supplies its registers for k = 2t, 2t+1 (a0/a1) and 2t+8, 2t+9 (a2/a3),
// so element 4t + j sits at logical k 2t + j (j < 2) or 2t + 6 + j.
__host__ __device__ __forceinline__ int perm16(int p) {
  const int t = p / 4, j = p % 4;
  return j < 2 ? 2 * t + j : 2 * t + 6 + j;
}

// ----------------------------------------------------------- mma helpers
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// B operands of two 8-wide n-tiles (n0, n0 + 8) at chunk k0 from a tile
// stored [n][k]: b[0..1] for n0, b[2..3] for n0 + 8
__device__ __forceinline__ void ld_b_2n(uint32_t (&b)[4], const bf16* base,
                                        int ld, int n0, int k0) {
  const int l = threadIdx.x % 32;
  const bf16* p = base + (n0 + l % 8 + 8 * (l / 16)) * ld + k0 +
                  8 * ((l / 8) % 2);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// A operand (rows g and g + 8 of a 16-row tile, chunk at k0) from a
// row-major bf16 array in global memory (L2), the lane's 8 bytes at
// 4t..4t+3 of each row (perm16 order); rows or columns out of range read 0.
__device__ __forceinline__ void ld_a_l2(uint32_t (&a)[4], const bf16* rows,
                                        long long ld, int r_ok0, int r_ok1,
                                        int k0, int K) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const int k = k0 + 4 * t;
  uint2 lo = make_uint2(0u, 0u), hi = make_uint2(0u, 0u);
  if (k < K) {
    if (r_ok0)
      lo = __ldcg(reinterpret_cast<const uint2*>(rows + g * ld + k));
    if (r_ok1)
      hi = __ldcg(reinterpret_cast<const uint2*>(rows + (g + 8) * ld + k));
  }
  a[0] = lo.x, a[1] = hi.x, a[2] = lo.y, a[3] = hi.y;
}

// ================================================================ forward
struct FwdArgs {
  const void* xw;    // (T, B, 4H)
  const void* rw;    // (H, 4H)
  const void* peep;  // (3, H)
  const void* c0;    // (B, H)
  const void* mask;  // (T, B), masked kernels only
  void* hbuf;        // (2, Bp, ldh) in the operand type; [0] holds h0
  void* h_out;       // (T, B, H)
  void* hT;          // (B, H), masked kernels only
  void* cT;          // (B, H)
  void* hsel;        // (T, B, H), masked stash
  void* c_stash;     // (T, B, H)
  void* gates;       // (T, B, 4H)
  int T, B, H;
  int Bp, ldh;       // hbuf's rows and row stride
  int Hp;            // H rounded up to 16: the cooperative kernel's K
  int rows, reverse;
  long long plane;   // Bp * ldh
};

// The gate chain for one (row r, unit u) of step t from the product's
// four z columns; `cl` is the pair's slot in the c carry.
template <typename DT, bool MASKED, bool STASH>
__device__ __forceinline__ void fwd_cell(const FwdArgs& a,
                                         const FwdSmem<DT>& sm, int t,
                                         bool last, int r, int ul, int cl,
                                         float zi, float zf, float zo,
                                         float zg, const DT* hcur, DT* hnext) {
  const int H = a.H, u = blockIdx.x * kUnits + ul;
  if (r >= a.B || u >= H) return;
  const long long row = (long long)t * a.B + r;
  const DT* xw = static_cast<const DT*>(a.xw) + row * 4 * H + u;
  zi += to_f(xw[0]);
  zf += to_f(xw[H]);
  zo += to_f(xw[2 * H]);
  zg += to_f(xw[3 * H]);
  const float c = sm.c[cl];
  const float i = sigm(zi + sm.peep[ul] * c);
  const float f = sigm(zf + sm.peep[kUnits + ul] * c);
  const float g = tanhf(zg);
  const float cn = f * c + i * g;
  const float o = sigm(zo + sm.peep[2 * kUnits + ul] * cn);
  const float hn = o * tanhf(cn);
  float hs = hn, cs = cn, out = hn;
  if constexpr (MASKED) {
    const float m = to_f(static_cast<const DT*>(a.mask)[(long long)t * a.B + r]);
    const bool mp = m > 0.f;
    hs = mp ? hn : ld_l2(hcur + (long long)r * a.ldh + u);
    cs = mp ? cn : c;
    out = hs * m;
  }
  const long long e = row * H + u;
  static_cast<DT*>(a.h_out)[e] = from_f<DT>(out);
  if constexpr (STASH) {
    static_cast<DT*>(a.c_stash)[e] = from_f<DT>(cs);
    if constexpr (MASKED) static_cast<DT*>(a.hsel)[e] = from_f<DT>(hs);
    DT* gt = static_cast<DT*>(a.gates) + row * 4 * H + u;
    gt[0] = from_f<DT>(i);
    gt[H] = from_f<DT>(f);
    gt[2 * H] = from_f<DT>(o);
    gt[3 * H] = from_f<DT>(g);
  }
  hnext[(long long)r * a.ldh + u] = from_f<DT>(hs);
  sm.c[cl] = cs;
  if (last) {
    static_cast<DT*>(a.cT)[(long long)r * H + u] = from_f<DT>(cs);
    if constexpr (MASKED)
      static_cast<DT*>(a.hT)[(long long)r * H + u] = from_f<DT>(hs);
  }
}

template <typename DT>
__device__ void fwd_load(const FwdArgs& a, const FwdSmem<DT>& sm, int r0,
                         int nrows) {
  const int H = a.H, Hp = a.Hp, u0 = blockIdx.x * kUnits;
  constexpr int ld_pad = Lay<DT>::kPad;
  const DT* rw = static_cast<const DT*>(a.rw);
  // column n = gate * 8 + unit; bf16 rows in perm16 order
  for (int idx = threadIdx.x; idx < 4 * kUnits * Hp; idx += kThreads) {
    const int n = idx / Hp, k = idx % Hp;
    const int u = u0 + n % kUnits, col = (n / kUnits) * H + u;
    const float v = (k < H && u < H) ? to_f(rw[(long long)k * 4 * H + col])
                                     : 0.f;
    const int pos = sizeof(DT) == 2 ? (k & ~15) + perm16(k & 15) : k;
    sm.rw[n * (Hp + ld_pad) + pos] = from_f<DT>(v);
  }
  const DT* pp = static_cast<const DT*>(a.peep);
  for (int idx = threadIdx.x; idx < 3 * kUnits; idx += kThreads) {
    const int u = u0 + idx % kUnits;
    sm.peep[idx] = u < H ? to_f(pp[(idx / kUnits) * H + u]) : 0.f;
  }
  const DT* c0 = static_cast<const DT*>(a.c0);
  for (int idx = threadIdx.x; idx < nrows * kUnits; idx += kThreads) {
    const int r = r0 + idx / kUnits, u = u0 + idx % kUnits;
    sm.c[idx] = (r < a.B && u < H) ? to_f(c0[(long long)r * H + u]) : 0.f;
  }
}

// bf16: warp w takes the block's 16-row tiles w, w + 8, ...
template <bool MASKED, bool STASH>
__device__ __forceinline__ void fwd_step(const FwdArgs& a,
                                         const FwdSmem<bf16>& sm, int t,
                                         bool last, int r0, int nrows,
                                         const bf16* hcur, bf16* hnext) {
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32, g = l / 4,
            tq = l % 4;
  const int ld = a.Hp + Lay<bf16>::kPad;
  for (int tile = warp; tile * kRows < nrows; tile += kWarps) {
    const int rt = r0 + tile * kRows;
    float acc[4][4] = {};
    const bf16* rows = hcur + (long long)rt * a.ldh;
    for (int kb = 0; kb < a.Hp; kb += 16 * kFwdBatch) {
      uint32_t av[kFwdBatch][4];
#pragma unroll
      for (int j = 0; j < kFwdBatch; ++j)
        ld_a_l2(av[j], rows, a.ldh, 1, 1, kb + 16 * j, a.Hp);
#pragma unroll
      for (int j = 0; j < kFwdBatch; ++j) {
        const int k0 = kb + 16 * j;
        if (k0 >= a.Hp) break;
        uint32_t b[4];
        ld_b_2n(b, sm.rw, ld, 0, k0);
        mma(acc[0], av[j], b[0], b[1]);
        mma(acc[1], av[j], b[2], b[3]);
        ld_b_2n(b, sm.rw, ld, 16, k0);
        mma(acc[2], av[j], b[0], b[1]);
        mma(acc[3], av[j], b[2], b[3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = tile * kRows + g + 8 * (e >> 1), ul = 2 * tq + (e & 1);
      fwd_cell<bf16, MASKED, STASH>(a, sm, t, last, r0 + rl, ul,
                                    rl * kUnits + ul, acc[0][e], acc[1][e],
                                    acc[2][e], acc[3][e], hcur, hnext);
    }
  }
}

template <typename DT, bool MASKED, bool STASH>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  FwdSmem<DT> sm;
  FwdSmem<DT>::carve(cv, &sm, a.Hp, a.rows);
  const int r0 = blockIdx.y * a.rows;
  const int nrows = min(a.rows, ceil_to(a.B, kRows) - r0);
  fwd_load<DT>(a, sm, r0, nrows);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  DT* hb = static_cast<DT*>(a.hbuf);
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const DT* hcur = hb + (s & 1) * a.plane;
    DT* hnext = hb + ((s + 1) & 1) * a.plane;
    if (nrows > 0)
      fwd_step<MASKED, STASH>(a, sm, t, s == a.T - 1, r0, nrows, hcur, hnext);
    if (s + 1 < a.T) grid.sync();  // h_t visible; no block still reads h_{t-1}
  }
}

// =============================================================== backward
struct BwdArgs {
  const void* gates;   // (T, B, 4H)
  const void* c;       // (T, B, H): c, or c_sel (masked)
  const void* dh_out;  // (T, B, H)
  const void* dhT;     // (B, H), masked kernels only
  const void* dcT;     // (B, H)
  const void* mask;    // (T, B), masked kernels only
  const void* rw;      // (H, 4H)
  const void* peep;    // (3, H)
  const void* c0;      // (B, H)
  void* dz;            // (T, B, 4H)
  float* dhc0;         // (2, B, H)
  int T, B, H, reverse;
};

// ================================================ bf16 backward, clusters
constexpr int kTileRows = 128;   // batch rows of a block (2 warpgroups x 64)
constexpr int kTileUnits = 128;  // hidden units of a block (the product's n)
constexpr int kChunk = 64;       // gate columns per stage: 128-byte rows
constexpr int kStages = 5;
// 2 consumer warpgroups, a producer warp and a prefetch warp
constexpr int kClusterThreads = 320;
constexpr int kConsumers = 256;
constexpr int kMaxCluster = 16;
constexpr uint32_t kChunkBytes = kTileRows * kChunk * 2;  // 16 KB (A or RW)

struct ClusterSmem {
  bf16 a[kStages][kTileRows * kChunk];   // dz[t][rows, chunk], swizzled
  bf16 w[kStages][kTileUnits * kChunk];  // RW[units, chunk], swizzled
  float dc[64][kConsumers];  // the dc carry: element e of consumer thread i
  float peep[3][kTileUnits];
  uint64_t full[kStages], empty[kStages];
};
static_assert(sizeof(float) * 64 * kConsumers <= sizeof(ClusterSmem::a),
              "the staged product fits the A stages");
constexpr size_t kClusterSmemBytes = sizeof(ClusterSmem) + 1024;  // + align

struct ClusterArgs {
  const bf16 *gates, *c, *dh_out, *dhT, *dcT, *mask, *peep, *c0;
  bf16* dz;
  float* dhc0;
  int T, B, H, reverse, cluster;
};

// backward step s undoes forward step T-1-s
struct Step {
  int t, t_prev;
  bool first;  // forward step 0: c_prev is c0, dh0 and dc0 are written
  __device__ Step(const ClusterArgs& a, int s)
      : t(a.reverse ? s : a.T - 1 - s),
        t_prev(a.reverse ? s + 1 : a.T - 2 - s),
        first(s == a.T - 1) {}
};

__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ void st_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Producer warp: per step, the RW chunks of the first ring stages (during
// the cell phase: they do not depend on dz), then after the cluster
// barrier this block's slice of the dz[t] rows of every chunk, multicast
// to the cluster, and the remaining RW chunks. A stage is reused once its
// empty barrier has every consumer warpgroup of every block of the
// cluster.
__device__ void cluster_producer(ClusterSmem& sm, const ClusterArgs& a,
                                 const CUtensorMap* tdz,
                                 const CUtensorMap* trw, int nch) {
  const bool leader = threadIdx.x % 32 == 0;
  const int C = a.cluster, u0 = blockIdx.x * kTileUnits;
  const int r0 = blockIdx.y * kTileRows;
  const uint32_t rank = sm90::cluster_rank();
  const int slice = kTileRows / C;
  const uint16_t mask = (uint16_t)((1u << C) - 1);
  const int ahead = nch < kStages ? nch : kStages;
  auto issue_w = [&](uint32_t q, int c) {
    const uint32_t st = q % kStages;
    sm90::mbar_wait_cluster(&sm.empty[st], ((q / kStages) & 1) ^ 1);
    sm90::mbar_expect_tx(&sm.full[st], 2 * kChunkBytes);
    sm90::tma_load_2d(sm.w[st], trw, &sm.full[st], c * kChunk, u0);
  };
  uint32_t q = 0;  // chunks issued before this step
  for (int s = 0; s < a.T; ++s) {
    const Step sp(a, s);
    if (leader)
      for (int c = 0; c < ahead; ++c) issue_w(q + c, c);
    sm90::cluster_sync();  // dz[t] of the row tile stored by every block
    if (leader)
      for (int c = 0; c < nch; ++c) {
        const uint32_t st = (q + c) % kStages;
        if (c >= ahead) issue_w(q + c, c);
        bf16* dst = sm.a[st] + rank * slice * kChunk;
        if (C == 1)
          sm90::tma_load_3d(dst, tdz, &sm.full[st], c * kChunk, r0, sp.t);
        else
          sm90::tma_load_3d_multicast(dst, tdz, &sm.full[st], mask,
                                      c * kChunk, r0 + rank * slice, sp.t);
      }
    q += nch;
  }
}

// Prefetch warp: while step s's product runs, bring step s + 1's stash
// rows of this tile into L2.
__device__ void cluster_prefetcher(const ClusterArgs& a) {
  const int H = a.H, u0 = blockIdx.x * kTileUnits;
  const int r0 = blockIdx.y * kTileRows;
  const int units = min(kTileUnits, H - u0);
  const long long G = 4LL * H;
  for (int s = 0; s < a.T; ++s) {
    sm90::cluster_sync();
    if (s + 1 >= a.T || units <= 0) continue;
    const Step sp(a, s + 1);
    for (int i = threadIdx.x % 32; i < kTileRows * 7; i += 32) {
      const int r = r0 + i / 7, seg = i % 7;
      if (r >= a.B) continue;
      const long long row = (long long)sp.t * a.B + r;
      const bf16* p;
      if (seg < 4) p = a.gates + row * G + seg * H + u0;
      else if (seg == 4) p = a.dh_out + row * H + u0;
      else if (seg == 5) p = a.c + row * H + u0;
      else if (sp.first) p = a.c0 + (long long)r * H + u0;
      else p = a.c + ((long long)sp.t_prev * a.B + r) * H + u0;
      const char* b = reinterpret_cast<const char*>(p);
      for (int off = 0; off < 2 * units; off += 128) sm90::prefetch_l2(b + off);
      sm90::prefetch_l2(b + 2 * units - 1);
    }
  }
}

// Consumer warpgroup wg (rows 64 wg .. 64 wg + 63 of the tile). Element
// 4j + e of a thread (warp w, lane 4g + tq) is row
// r0 + 64 wg + 16 w + g + 8 (e >> 1), unit u0 + 8j + 2tq + (e & 1): the
// wgmma accumulator's layout. The product accumulates into acc, which
// only wgmma defines (its first k step zeroes it); the dh carry is the
// product plus byp (dhT at the start, then the masked select's bypass; 0
// unmasked), and dc sits in shared memory in the same order.
template <bool MASKED>
__device__ void cluster_consumer(ClusterSmem& sm, const ClusterArgs& a,
                                 int nch) {
  const int tid = threadIdx.x, wg = tid / 128;
  const int l = tid % 32, g = l / 4, tq = l % 4, w = (tid % 128) / 32;
  const int H = a.H, B = a.B, C = a.cluster;
  const long long G = 4LL * H;
  const int u0 = blockIdx.x * kTileUnits;
  const int rbase = blockIdx.y * kTileRows + wg * 64 + 16 * w + g;
  float acc[64], byp[64];
  float(*dc)[kConsumers] = sm.dc;
  // between products the A stages hold the product's result, element e of
  // thread i at dhs[e][i]: the cell phase reads it back from there and
  // keeps its registers for the stash loads in flight
  float(*dhs)[kConsumers] = reinterpret_cast<float(*)[kConsumers]>(sm.a[0]);
  // thread 8k of a warpgroup releases a stage to block k of the cluster
  const int wt = tid % 128;
  const bool releases = wt % 8 == 0 && wt / 8 < C;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int r = rbase + 8 * rr, u = u0 + 8 * j + 2 * tq, e = 4 * j + 2 * rr;
      float2 c2 = make_float2(0.f, 0.f), h2 = make_float2(0.f, 0.f);
      if (r < B && u < H) {
        c2 = ld_pair(a.dcT + (long long)r * H + u);
        if (MASKED) h2 = ld_pair(a.dhT + (long long)r * H + u);
      }
      dc[e][tid] = c2.x, dc[e + 1][tid] = c2.y;
      byp[e] = h2.x, byp[e + 1] = h2.y;
    }
  const char* a_tile = reinterpret_cast<const char*>(sm.a[0]) + wg * 8192;
  uint32_t q = 0;  // chunks consumed before this step
  for (int s = 0; s < a.T; ++s) {
    const Step sp(a, s);
    // ---- cell phase: dz[t] of this thread's rows and units
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rbase + 8 * rr;
      if (r >= B) continue;
      const long long row = (long long)sp.t * B + r;
      const float m = MASKED ? __bfloat162float(a.mask[row]) : 1.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int ul = 8 * j + 2 * tq, u = u0 + ul;
        if (u >= H) continue;  // H is even: u + 1 < H too
        const bf16* gt = a.gates + row * G + u;
        const float2 gi = ld_pair(gt), gf = ld_pair(gt + H),
                     go = ld_pair(gt + 2 * H), gg = ld_pair(gt + 3 * H);
        const float2 cp = ld_pair(
            sp.first ? a.c0 + (long long)r * H + u
                     : a.c + ((long long)sp.t_prev * B + r) * H + u);
        const float2 dho = ld_pair(a.dh_out + row * H + u);
        const float2 c_st = MASKED ? make_float2(0.f, 0.f)
                                   : ld_pair(a.c + row * H + u);
        float dzv[4][2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 4 * j + 2 * rr + x;
          const float i = x ? gi.y : gi.x, f = x ? gf.y : gf.x;
          const float o = x ? go.y : go.x, gv = x ? gg.y : gg.x;
          const float c_prev = x ? cp.y : cp.x;
          const float pI = sm.peep[0][ul + x], pF = sm.peep[1][ul + x],
                      pO = sm.peep[2][ul + x];
          const float dhc = (s > 0 ? dhs[e][tid] : 0.f) + byp[e];
          const float dcc = dc[e][tid];
          float dhn, dcn, c_t, byp_h = 0.f, byp_c = 0.f;
          if (MASKED) {
            const bool mp = m > 0.f;
            const float d_hsel = m * (x ? dho.y : dho.x) + dhc;
            dhn = mp ? d_hsel : 0.f;
            byp_h = mp ? 0.f : d_hsel;
            dcn = mp ? dcc : 0.f;
            byp_c = mp ? 0.f : dcc;
            c_t = f * c_prev + i * gv;  // the candidate: the stash has c_sel
          } else {
            dhn = (x ? dho.y : dho.x) + dhc;
            dcn = dcc;
            c_t = x ? c_st.y : c_st.x;
          }
          const float tc = tanhf(c_t);
          const float dzo = dhn * tc * o * (1.f - o);
          const float dct = dhn * o * (1.f - tc * tc) + dcn + dzo * pO;
          const float dzg = dct * i * (1.f - gv * gv);
          const float dzi = dct * gv * i * (1.f - i);
          const float dzf = dct * c_prev * f * (1.f - f);
          const float dc_prev = dct * f + dzi * pI + dzf * pF + byp_c;
          dzv[0][x] = dzi, dzv[1][x] = dzf, dzv[2][x] = dzo, dzv[3][x] = dzg;
          dc[e][tid] = dc_prev;
          byp[e] = byp_h;  // the product adds dz . RW^T to it
          if (sp.first)
            a.dhc0[(long long)B * H + (long long)r * H + u + x] = dc_prev;
        }
        bf16* dz = a.dz + row * G + u;
#pragma unroll
        for (int k = 0; k < 4; ++k) st_pair(dz + k * H, dzv[k][0], dzv[k][1]);
      }
    }
    sm90::fence_proxy_async();  // dz[t] is read back by TMA
    sm90::cluster_sync();
    // ---- product phase: acc = dz[t][rows, :] . RW[units, :]^T
    for (int c = 0; c < nch; ++c, ++q) {
      const uint32_t st = q % kStages;
      sm90::mbar_wait(&sm.full[st], (q / kStages) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::wgmma_m64n128_ss(
            acc, sm90::desc_sw128(a_tile + st * sizeof(sm.a[0]) + kk * 32),
            sm90::desc_sw128(reinterpret_cast<const char*>(sm.w[st]) +
                             kk * 32),
            c > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous chunk's products are done
      sm90::mbar_arrive_cluster(&sm.empty[(q + kStages - 1) % kStages],
                                wt / 8, c > 0 && releases);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive_cluster(&sm.empty[(q - 1) % kStages], wt / 8, releases);
    // both warpgroups' products are done with the A stages: stage dh
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
    for (int e = 0; e < 64; ++e) dhs[e][tid] = acc[e];
    if (sp.first) {  // dh0 = this product + the bypass, in f32
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int r = rbase + 8 * rr, u = u0 + 8 * j + 2 * tq;
          const int e = 4 * j + 2 * rr;
          if (r < B && u < H) {
            a.dhc0[(long long)r * H + u] = acc[e] + byp[e];
            a.dhc0[(long long)r * H + u + 1] = acc[e + 1] + byp[e + 1];
          }
        }
    }
  }
}

template <bool MASKED>
__global__ void __launch_bounds__(kClusterThreads, 1)
    lstm_bwd_cluster_kernel(const __grid_constant__ CUtensorMap tdz,
                            const __grid_constant__ CUtensorMap trw,
                            const ClusterArgs a) {
  extern __shared__ unsigned char smem_raw[];
  ClusterSmem& sm = *reinterpret_cast<ClusterSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nch = (4 * a.H + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      // one arrival per consumer warpgroup of every block of the cluster
      sm90::mbar_init(&sm.empty[s], 2 * a.cluster);
    }
    sm90::mbar_fence_init();
  }
  const int u0 = blockIdx.x * kTileUnits;
  for (int i = threadIdx.x; i < 3 * kTileUnits; i += kClusterThreads) {
    const int k = i / kTileUnits, u = u0 + i % kTileUnits;
    sm.peep[k][i % kTileUnits] =
        u < a.H ? __bfloat162float(a.peep[k * a.H + u]) : 0.f;
  }
  __syncthreads();
  // every block's barriers are initialised before any multicast or remote
  // arrival reaches them
  sm90::cluster_sync();
  if (threadIdx.x < kConsumers)
    cluster_consumer<MASKED>(sm, a, nch);
  else if (threadIdx.x < kConsumers + 32)
    cluster_producer(sm, a, &tdz, &trw, nch);
  else
    cluster_prefetcher(a);
  sm90::cluster_sync();  // no block leaves while others may reach it
}

// ==================================================== f32, row-tile clusters
// The parity path: f32 at any B and at H up to 2048, both passes. A block
// owns a tile of kF32Rows batch rows x kF32Units hidden units; the
// ceil(H / kF32Units) blocks of a row tile form a thread block cluster and
// meet at barrier.cluster once per step (the tile's h_t, or dz[t], stored
// by all of them); clusters need not be resident together. Products are
// f32 FMAs (no TF32): per chunk of k the operands are staged in shared
// memory by cp.async, every copy of a chunk in flight at once: h (or dz)
// rows from L2 (16-byte .cg copies: written by the cluster in this
// launch), RW through L1. Thread (rg, ug) = (tid / 32, tid % 32) owns
// rows 4 rg .. 4 rg + 3 and units ug + 32 j (j < 4) of the tile, all four
// gates of each (neighbouring lanes on neighbouring units: the cell
// phase's loads and stores coalesce, the products' shared reads hit
// distinct banks): the cell phase runs on the product's registers, and the
// carries (c; dh and dc) stay in registers for the whole loop. Shared
// memory does not grow with H or B.
constexpr int kF32Threads = 256;
constexpr int kF32Rows = 32;
constexpr int kF32Units = 128;
constexpr int kF32FwdK = 16;  // k per chunk: forward (K = H)
constexpr int kF32BwdK = 64;  // backward (K = 4H)
constexpr int kF32Pad = 4;    // shared rows 16-byte aligned, banks spread

// asynchronous copies into shared memory: `bytes` of 16 (the rest zero),
// through L2 only; and 4 bytes (or a zero) through L1
__device__ __forceinline__ void cp16_zfill(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4_zfill(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// forward: z[i][j][q] = sum_k h[row i][k] RW[k][q H + unit j] (+= into z)
__device__ __forceinline__ void f32_fwd_product(const FwdArgs& a,
                                                const float* hcur, int r0,
                                                int u0, float (&z)[4][4][4]) {
  constexpr int KC = kF32FwdK;
  __shared__ __align__(16) float sa[kF32Rows][KC + kF32Pad];
  __shared__ __align__(16) float sb[KC][4][kF32Units + kF32Pad];
  const int H = a.H, tid = threadIdx.x;
  const int rg = tid / 32, ug = tid % 32;
  const float* rw = static_cast<const float*>(a.rw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) z[i][j][q] = 0.f;
  for (int k0 = 0; k0 < H; k0 += KC) {
    __syncthreads();  // the previous chunk's operands are read
    if (tid < kF32Rows * KC / 4) {  // h columns past H are zero in hbuf
      const int r = tid / (KC / 4), x = tid % (KC / 4);
      const bool ok = r0 + r < a.B;
      cp16_zfill(&sa[r][4 * x],
                 ok ? hcur + (long long)(r0 + r) * a.ldh + k0 + 4 * x : hcur,
                 ok ? 16 : 0);
    }
#pragma unroll 8
    for (int i = tid; i < KC * 4 * kF32Units; i += kF32Threads) {
      const int kk = i / (4 * kF32Units), q = i / kF32Units % 4;
      const int u = i % kF32Units, k = k0 + kk;
      const bool ok = k < H && u0 + u < H;
      cp4_zfill(&sb[kk][q][u],
                ok ? rw + (long long)k * 4 * H + q * H + u0 + u : rw, ok);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = sa[4 * rg + i][kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = sb[kk][q][ug + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) z[i][j][q] += hv[i] * wv[j];
      }
    }
  }
}

template <bool MASKED, bool STASH>
__global__ void __launch_bounds__(kF32Threads)
    lstm_fwd_f32_kernel(const FwdArgs a) {
  const int H = a.H, B = a.B, tid = threadIdx.x;
  const int u0 = blockIdx.x * kF32Units, r0 = blockIdx.y * kF32Rows;
  const int rb = r0 + 4 * (tid / 32), ub = u0 + tid % 32;
  const float* xw = static_cast<const float*>(a.xw);
  const float* peep = static_cast<const float*>(a.peep);
  const float* c0 = static_cast<const float*>(a.c0);
  float* hb = static_cast<float*>(a.hbuf);
  float pp[3][4], c[4][4], hp[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      pp[k][j] = ub + 32 * j < H ? peep[k * H + ub + 32 * j] : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = rb + i < B && ub + 32 * j < H;
      c[i][j] = ok ? c0[(long long)(rb + i) * H + ub + 32 * j] : 0.f;
      hp[i][j] = ok ? hb[(long long)(rb + i) * a.ldh + ub + 32 * j] : 0.f;
    }
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const bool last = s == a.T - 1;
    const float* hcur = hb + (s & 1) * a.plane;
    float* hnext = hb + ((s + 1) & 1) * a.plane;
    float z[4][4][4];
    f32_fwd_product(a, hcur, r0, u0, z);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rb + i;
      if (r >= B) continue;
      const long long row = (long long)t * B + r;
      const float m = MASKED ? static_cast<const float*>(a.mask)[row] : 1.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = ub + 32 * j;
        if (u >= H) continue;
        const float* x = xw + row * 4 * H + u;
        const float cp = c[i][j];
        const float ig = sigm(z[i][j][0] + x[0] + pp[0][j] * cp);
        const float fg = sigm(z[i][j][1] + x[H] + pp[1][j] * cp);
        const float gg = tanhf(z[i][j][3] + x[3 * H]);
        const float cn = fg * cp + ig * gg;
        const float og = sigm(z[i][j][2] + x[2 * H] + pp[2][j] * cn);
        const float hn = og * tanhf(cn);
        float hs = hn, cs = cn, out = hn;
        if constexpr (MASKED) {
          hs = m > 0.f ? hn : hp[i][j];
          cs = m > 0.f ? cn : cp;
          out = hs * m;
        }
        const long long e = row * H + u;
        static_cast<float*>(a.h_out)[e] = out;
        if constexpr (STASH) {
          static_cast<float*>(a.c_stash)[e] = cs;
          if constexpr (MASKED) static_cast<float*>(a.hsel)[e] = hs;
          float* gt = static_cast<float*>(a.gates) + row * 4 * H + u;
          gt[0] = ig, gt[H] = fg, gt[2 * H] = og, gt[3 * H] = gg;
        }
        hnext[(long long)r * a.ldh + u] = hs;
        c[i][j] = cs, hp[i][j] = hs;
        if (last) {
          static_cast<float*>(a.cT)[(long long)r * H + u] = cs;
          if constexpr (MASKED)
            static_cast<float*>(a.hT)[(long long)r * H + u] = hs;
        }
      }
    }
    sm90::cluster_sync();  // the tile's h_t stored; h_{t-1} read by all
  }
}

// backward: dh[i][j] = sum_k dz[t][row i][k] RW[unit j][k] over K = 4H
__device__ __forceinline__ void f32_bwd_product(const BwdArgs& a,
                                                const float* dzt, int r0,
                                                int u0, float (&acc)[4][4]) {
  constexpr int KC = kF32BwdK;
  __shared__ __align__(16) float sa[kF32Rows][KC + kF32Pad];
  __shared__ float sb[kF32Units][KC + 1];  // odd stride: distinct banks
  const int K = 4 * a.H, tid = threadIdx.x;
  const int rg = tid / 32, ug = tid % 32;
  const float* rw = static_cast<const float*>(a.rw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < kF32Rows * KC / 4; i += kF32Threads) {
      const int r = i / (KC / 4), k = k0 + 4 * (i % (KC / 4));
      const int bytes = r0 + r < a.B ? 4 * max(0, min(4, K - k)) : 0;
      cp16_zfill(&sa[r][k - k0],
                 bytes ? dzt + (long long)(r0 + r) * K + k : dzt, bytes);
    }
#pragma unroll 8
    for (int i = tid; i < KC * kF32Units; i += kF32Threads) {
      const int u = i / KC, kk = i % KC, k = k0 + kk;
      const bool ok = k < K && u0 + u < a.H;
      cp4_zfill(&sb[u][kk], ok ? rw + (long long)(u0 + u) * K + k : rw, ok);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = sa[4 * rg + i][kk];
      float wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = sb[ug + 32 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += dv[i] * wv[j];
    }
  }
}

template <bool MASKED>
__global__ void __launch_bounds__(kF32Threads)
    lstm_bwd_f32_kernel(const BwdArgs a) {
  const int H = a.H, B = a.B, tid = threadIdx.x;
  const int u0 = blockIdx.x * kF32Units, r0 = blockIdx.y * kF32Rows;
  const int rb = r0 + 4 * (tid / 32), ub = u0 + tid % 32;
  const float* peep = static_cast<const float*>(a.peep);
  const float* gates = static_cast<const float*>(a.gates);
  const float* cst = static_cast<const float*>(a.c);
  const float* c0 = static_cast<const float*>(a.c0);
  const float* dh_out = static_cast<const float*>(a.dh_out);
  float* dz = static_cast<float*>(a.dz);
  float pp[3][4], dh[4][4], dc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      pp[k][j] = ub + 32 * j < H ? peep[k * H + ub + 32 * j] : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = rb + i < B && ub + 32 * j < H;
      const long long e = (long long)(rb + i) * H + ub + 32 * j;
      dc[i][j] = ok ? static_cast<const float*>(a.dcT)[e] : 0.f;
      dh[i][j] = ok && MASKED ? static_cast<const float*>(a.dhT)[e] : 0.f;
    }
  // backward step s undoes forward step T-1-s
  for (int s = 0; s < a.T; ++s) {
    const int sf = a.T - 1 - s;
    const int t = a.reverse ? a.T - 1 - sf : sf;
    const int t_prev = a.reverse ? t + 1 : t - 1;
    const bool first = sf == 0;
    float byp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rb + i;
      const long long row = (long long)t * B + r;
      const float m = MASKED && r < B
                          ? static_cast<const float*>(a.mask)[row] : 1.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = ub + 32 * j;
        byp[i][j] = 0.f;
        if (r >= B || u >= H) continue;
        const float* gt = gates + row * 4 * H + u;
        const float ig = gt[0], fg = gt[H], og = gt[2 * H], gg = gt[3 * H];
        const float c_prev =
            first ? c0[(long long)r * H + u]
                  : cst[((long long)t_prev * B + r) * H + u];
        const float dho = dh_out[row * H + u];
        float dhn, dcn, c_t, byp_c = 0.f;
        if constexpr (MASKED) {
          const float d_hsel = m * dho + dh[i][j];
          dhn = m > 0.f ? d_hsel : 0.f;
          byp[i][j] = m > 0.f ? 0.f : d_hsel;
          dcn = m > 0.f ? dc[i][j] : 0.f;
          byp_c = m > 0.f ? 0.f : dc[i][j];
          c_t = fg * c_prev + ig * gg;  // the candidate: the stash has c_sel
        } else {
          dhn = dho + dh[i][j];
          dcn = dc[i][j];
          c_t = cst[row * H + u];
        }
        const float tc = tanhf(c_t);
        const float dzo = dhn * tc * og * (1.f - og);
        const float dct = dhn * og * (1.f - tc * tc) + dcn + dzo * pp[2][j];
        const float dzg = dct * ig * (1.f - gg * gg);
        const float dzi = dct * gg * ig * (1.f - ig);
        const float dzf = dct * c_prev * fg * (1.f - fg);
        const float dc_prev =
            dct * fg + dzi * pp[0][j] + dzf * pp[1][j] + byp_c;
        float* d = dz + row * 4 * H + u;
        d[0] = dzi, d[H] = dzf, d[2 * H] = dzo, d[3 * H] = dzg;
        dc[i][j] = dc_prev;
        if (first) a.dhc0[(long long)B * H + (long long)r * H + u] = dc_prev;
      }
    }
    sm90::cluster_sync();  // dz[t] of the tile stored by every block
    float acc[4][4];
    f32_bwd_product(a, dz + (long long)t * B * 4 * H, r0, u0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dh[i][j] = acc[i][j] + byp[i][j];
        if (first && rb + i < B && ub + 32 * j < H)
          a.dhc0[(long long)(rb + i) * H + ub + 32 * j] = dh[i][j];
      }
  }
}

// ================================================= bf16 forward, clusters
// The bf16 forward at B above kCoopMaxB rows, or H above 1024: the
// backward's skeleton carried over. A block owns ROWS batch rows x
// 8192 / ROWS hidden units (128 x 64 at H <= 1024, 64 x 128 above); the
// blocks of a row tile (H / units, rounded up to a power of two, at most
// 16) form a cluster and meet at barrier.cluster once per step. Each step:
//  1. product: each of two consumer warpgroups computes z = h[t-1] . RW
//     for 64 rows x 64 units x 4 gates on wgmma m64n256k16 (bf16 in, f32
//     accumulate; the first k step zeroes the accumulator) from a ring of
//     shared-memory stages filled by TMA. RW comes pre-arranged by the
//     wrapper as RWp (4 Hu, Hk) with the 256 columns of each 64-unit
//     group's four gates as contiguous K-major rows, so that a thread's
//     accumulator holds all four gates of its 2 rows x 16 units; the h[t-1]
//     rows of the tile come from the (2, Bp, ldh) ping-pong buffer, 1/C of
//     them loaded by each block and multicast to the cluster, so a cluster
//     reads them once. A prefetch warp meanwhile brings the step's xw rows
//     into L2;
//  2. cell phase: the ring is idle now. TMA loads the step's xw tile
//     (and, masked, the tile's h[t-1] of the block's units) into it; the
//     gate chain runs on the accumulator (128-row tiles: half of it parked
//     in the ring, so that its registers let the chains of many cells
//     overlap; the c carry in f32 in shared memory; sigmoid and tanh from
//     ex2 and rcp); h_out, the stash and h_t are written into the ring as
//     128-byte-swizzled tiles (the gates over the xw they came from), then
//     stored by TMA in whole rows (h_t first, waited for before the
//     barrier: the next step's loads read it);
//  3. the cluster meets; the producer warp then issues every chunk's loads
//     of the next step.
// The wrapper pads H to a multiple of 8 (TMA rows and boxes on 16 bytes).
template <int ROWS>
struct FwdCfg {
  static constexpr int kUnits = 8192 / ROWS;  // hidden units of a block
  static constexpr int kGroups = kUnits / 64;  // 64-unit groups: 256 RWp rows
  static constexpr int kStages = ROWS == 128 ? 4 : 2;
  static constexpr uint32_t kABytes = ROWS * kChunk * 2;
  static constexpr uint32_t kWBytes = kGroups * 256 * kChunk * 2;
  static constexpr int kBox = ROWS * 128;  // bytes of an output box
};

template <int ROWS>
struct FwdClusterSmem {
  using Cfg = FwdCfg<ROWS>;
  bf16 a[Cfg::kStages][ROWS * kChunk];               // h[t-1] rows, swizzled
  // RWp rows, swizzled; between products, the tiles of the cell phase:
  // xw, then the gates over it (4 x kGroups boxes), then h_out, c, h_t (=
  // h_sel) and, masked, h[t-1] (kGroups boxes each)
  bf16 w[Cfg::kStages][Cfg::kGroups * 256 * kChunk];
  float c[32][kConsumers];  // the c carry: cell e of consumer thread i
  float peep[3][Cfg::kUnits];
  uint64_t full[Cfg::kStages], empty[Cfg::kStages], x_full;
};
static_assert(sizeof(FwdClusterSmem<128>::w) >= 8 * FwdCfg<128>::kBox,
              "the output tiles fit the idle ring");
static_assert(sizeof(FwdClusterSmem<64>::w) >= 16 * FwdCfg<64>::kBox,
              "the output tiles fit the idle ring");
static_assert(sizeof(FwdClusterSmem<128>::a) >= 64 * kConsumers * 4,
              "half the accumulator fits the idle A stages");

template <int ROWS>
constexpr size_t fwd_cluster_smem() {
  return sizeof(FwdClusterSmem<ROWS>) + 1024;  // + alignment
}

struct FwdClusterArgs {
  const bf16 *xw, *peep, *c0, *mask;
  bf16 *hbuf, *hT, *cT;
  long long plane;
  int T, B, H, ldh, reverse, cluster;
};

// The tensor maps of a launch: h loads (boxes of the multicast slice) and
// tiles, RWp, xw and the outputs (h_out, c, h_sel (T, B, H); xw and the
// gates (H, 4, B, T)), all in boxes of 64 units x ROWS rows.
struct FwdMaps {
  CUtensorMap h_ld, h_st, w, xw, h_out, c, hsel, gates;
};

// Producer warp: per step, after the cluster barrier that publishes
// h[t-1] (the output tiles of the previous step are then stored, so the
// ring is free), every chunk's RW rows and this block's slice of the h
// rows (multicast). A stage is refilled once every consumer warpgroup of
// every block of the cluster released it.
template <int ROWS>
__device__ void fwd_producer(FwdClusterSmem<ROWS>& sm,
                             const FwdClusterArgs& a, const FwdMaps& m,
                             int nch) {
  using Cfg = FwdCfg<ROWS>;
  constexpr int S = Cfg::kStages;
  const bool leader = threadIdx.x % 32 == 0;
  const int C = a.cluster, r0 = blockIdx.y * ROWS;
  const int g0 = blockIdx.x * Cfg::kGroups;  // first 64-unit group
  const uint32_t rank = sm90::cluster_rank();
  // each loading block's rows: at least 8 (a whole swizzle atom)
  const int slice = ROWS / C < 8 ? 8 : ROWS / C;
  const bool loads = (int)rank * slice < ROWS;
  const uint16_t mask = (uint16_t)((1u << C) - 1);
  uint32_t q = 0;  // chunks issued before this step
  for (int s = 0; s < a.T; ++s) {
    if (s > 0) sm90::cluster_sync();  // h[t-1] stored by every block
    if (leader)
      for (int c = 0; c < nch; ++c, ++q) {
        const uint32_t st = q % S;
        sm90::mbar_wait_cluster(&sm.empty[st], ((q / S) & 1) ^ 1);
        sm90::mbar_expect_tx(&sm.full[st], Cfg::kABytes + Cfg::kWBytes);
#pragma unroll
        for (int gi = 0; gi < Cfg::kGroups; ++gi)
          sm90::tma_load_2d(sm.w[st] + gi * 256 * kChunk, &m.w, &sm.full[st],
                            c * kChunk, (g0 + gi) * 256);
        if (!loads) continue;
        bf16* dst = sm.a[st] + rank * slice * kChunk;
        if (C == 1)
          sm90::tma_load_3d(dst, &m.h_ld, &sm.full[st], c * kChunk, r0,
                            s & 1);
        else
          sm90::tma_load_3d_multicast(dst, &m.h_ld, &sm.full[st], mask,
                                      c * kChunk, r0 + rank * slice, s & 1);
      }
  }
  sm90::cluster_sync();  // the consumers' last step
}

// Prefetch warp: while step s's product runs, bring its xw rows of this
// tile into L2.
template <int ROWS>
__device__ void fwd_prefetcher(const FwdClusterArgs& a) {
  constexpr int U = FwdCfg<ROWS>::kUnits;
  const int H = a.H, u0 = blockIdx.x * U, r0 = blockIdx.y * ROWS;
  const int units = min(U, H - u0);
  for (int s = 0; s < a.T; ++s) {
    if (s > 0) sm90::cluster_sync();
    if (units <= 0) continue;
    const int t = a.reverse ? a.T - 1 - s : s;
    for (int i = threadIdx.x % 32; i < ROWS * 4; i += 32) {
      const int r = r0 + i / 4, q = i % 4;
      if (r >= a.B) continue;
      const char* b = reinterpret_cast<const char*>(
          a.xw + ((long long)t * a.B + r) * 4 * H + q * H + u0);
      for (int off = 0; off < 2 * units; off += 128) sm90::prefetch_l2(b + off);
      sm90::prefetch_l2(b + 2 * units - 1);
    }
  }
  sm90::cluster_sync();
}

// sigmoid and tanh from ex2 and an approximate reciprocal (f32; a few
// ulp, far inside the bf16 outputs' rounding; 0 and +-1 at the extremes)
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sigm_fast(float x) {
  return rcp_approx(1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - 2.f * rcp_approx(__expf(2.f * x) + 1.f);
}

// a pair of bf16 of a 128-byte-swizzled box (64 columns): row r, columns
// 2k, 2k + 1 (k < 32); a row's 16-byte chunk j sits at j ^ (r % 8)
__device__ __forceinline__ int box_off(int r, int k) {
  return r * 128 + (((k / 4) ^ (r % 8)) * 16) + 4 * (k % 4);
}
__device__ __forceinline__ void st_box(char* box, int r, int k, float x,
                                       float y) {
  *reinterpret_cast<__nv_bfloat162*>(box + box_off(r, k)) =
      __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ float2 ld_box(const char* box, int r, int k) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(box + box_off(r, k)));
}

// Consumer warpgroup wg. Its rows: wr .. wr + 63 of the tile (wr = 64 wg
// for 128-row tiles, else 0); its units: ug .. ug + 63 of the block's (ug
// = 0 for 128-row tiles, else 64 wg). Thread (warp w, lane 4g + tq) holds
// rows wr + 16w + g + 8rr and units ug + 8jj + 2tq + e: gate q of that cell
// is accumulator element 4 (8q + jj) + 2rr + e (RWp's column order).
template <int ROWS, bool MASKED, bool STASH>
__device__ void fwd_consumer(FwdClusterSmem<ROWS>& sm,
                             const FwdClusterArgs& a, const FwdMaps& mp,
                             int nch) {
  using Cfg = FwdCfg<ROWS>;
  constexpr int S = Cfg::kStages, KG = Cfg::kGroups, BOX = Cfg::kBox;
  constexpr bool kSplitZ = ROWS == 128;
  const int tid = threadIdx.x, wg = tid / 128;
  const int l = tid % 32, g = l / 4, tq = l % 4, w = (tid % 128) / 32;
  const int H = a.H, B = a.B, C = a.cluster;
  const long long G4 = 4LL * H;
  const int wr = ROWS == 128 ? 64 * wg : 0, ug = ROWS == 128 ? 0 : 64 * wg;
  const int u0 = blockIdx.x * Cfg::kUnits, r0 = blockIdx.y * ROWS;
  const int rbase = r0 + wr + 16 * w + g;
  const int wt = tid % 128;
  // thread 8k of a warpgroup releases a stage to block k of the cluster
  const bool releases = wt % 8 == 0 && wt / 8 < C;
  // the output tiles, between products: gate q of group gi at box
  // q * KG + gi, then h_out, c, h_t, h_sel (KG boxes each)
  char* tiles = reinterpret_cast<char*>(sm.w[0]);
  char* gbox = tiles + (ug / 64) * BOX;
  char* obox = tiles + (4 * KG + ug / 64) * BOX;
  const char* hbox = tiles + (7 * KG + ug / 64) * BOX;
  // 128-row tiles: the accumulator's second rows (rr = 1) wait in the idle
  // A stages during the cell phase, element 4j + 2 + e at zs[2j + e][tid],
  // so their registers are free for the first rows' gate chains
  float(*zs)[kConsumers] = reinterpret_cast<float(*)[kConsumers]>(sm.a[0]);
  float acc[128];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int r = rbase + 8 * rr, u = u0 + ug + 8 * jj + 2 * tq;
      const float2 c2 = r < B && u < H
                            ? ld_pair(a.c0 + (long long)r * H + u)
                            : make_float2(0.f, 0.f);
      sm.c[16 * rr + 2 * jj][tid] = c2.x;
      sm.c[16 * rr + 2 * jj + 1][tid] = c2.y;
    }
  const char* a_tile = reinterpret_cast<const char*>(sm.a[0]) + wr * 128;
  const char* w_tile = reinterpret_cast<const char*>(sm.w[0]) +
                       (ug / 64) * 256 * kChunk * 2;
  uint32_t q = 0;  // chunks consumed before this step
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const bool last = s == a.T - 1;
    // ---- product: acc = h[t-1][rows, :] . RWp[cols, :]^T
    for (int c = 0; c < nch; ++c, ++q) {
      const uint32_t st = q % S;
      sm90::mbar_wait(&sm.full[st], (q / S) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::wgmma_m64n256_ss(
            acc, sm90::desc_sw128(a_tile + st * sizeof(sm.a[0]) + kk * 32),
            sm90::desc_sw128(w_tile + st * sizeof(sm.w[0]) + kk * 32),
            c > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous chunk's products are done
      sm90::mbar_arrive_cluster(&sm.empty[(q + S - 1) % S], wt / 8,
                                c > 0 && releases);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive_cluster(&sm.empty[(q - 1) % S], wt / 8, releases);
    // both warpgroups' products are done with the ring: it holds the tiles
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (tid == 0) {
      sm90::mbar_expect_tx(&sm.x_full, (4 + MASKED) * KG * BOX);
      for (int gi = 0; gi < KG; ++gi) {
        for (int k = 0; k < 4; ++k)
          sm90::tma_load_4d(tiles + (k * KG + gi) * BOX, &mp.xw, &sm.x_full,
                            u0 + 64 * gi, k, r0, t);
        if (MASKED)
          sm90::tma_load_3d(tiles + (7 * KG + gi) * BOX, &mp.h_st, &sm.x_full,
                            u0 + 64 * gi, r0, s & 1);
      }
    }
    if (kSplitZ) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        zs[2 * j][tid] = acc[4 * j + 2], zs[2 * j + 1][tid] = acc[4 * j + 3];
    }
    sm90::mbar_wait(&sm.x_full, s & 1);
    // ---- cell phase: the gate chain of this thread's 2 x 16 cells
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rbase + 8 * rr, rl = r - r0;  // row in the tile
      if (r >= B) continue;
      const long long row = (long long)t * B + r;
      const float m = MASKED ? __bfloat162float(a.mask[row]) : 1.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int kc = 4 * jj + tq;  // the pair's column pair in its box
        const int ul = ug + 8 * jj + 2 * tq, u = u0 + ul;
        if (u >= H) continue;  // H is even: u + 1 < H too
        float2 xq[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) xq[k] = ld_box(gbox + k * KG * BOX, rl, kc);
        const float2 hprev =
            MASKED ? ld_box(hbox, rl, kc) : make_float2(0.f, 0.f);
        float hv[2], cv[2], ov[2], gv[4][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = 16 * rr + 2 * jj + e;
          const float cp = sm.c[ci][tid];
          // gate q's pre-activation: product + xw
          auto z = [&](int q) {
            const int j = 8 * q + jj;
            const float p = kSplitZ && rr ? zs[2 * j + e][tid]
                                          : acc[4 * j + 2 * rr + e];
            return p + (e ? xq[q].y : xq[q].x);
          };
          const float zi = z(0), zf = z(1), zo = z(2), zg = z(3);
          const float ig = sigm_fast(zi + sm.peep[0][ul + e] * cp);
          const float fg = sigm_fast(zf + sm.peep[1][ul + e] * cp);
          const float gg = tanh_fast(zg);
          const float cn = fg * cp + ig * gg;
          const float og = sigm_fast(zo + sm.peep[2][ul + e] * cn);
          const float hn = og * tanh_fast(cn);
          float hs = hn, cs = cn, out = hn;
          if (MASKED) {
            hs = m > 0.f ? hn : (e ? hprev.y : hprev.x);
            cs = m > 0.f ? cn : cp;
            out = hs * m;
          }
          sm.c[ci][tid] = cs;
          hv[e] = hs, cv[e] = cs, ov[e] = out;
          gv[0][e] = ig, gv[1][e] = fg, gv[2][e] = og, gv[3][e] = gg;
        }
        st_box(obox, rl, kc, ov[0], ov[1]);
        st_box(obox + 2 * KG * BOX, rl, kc, hv[0], hv[1]);
        if (STASH) {
          st_box(obox + KG * BOX, rl, kc, cv[0], cv[1]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            st_box(gbox + k * KG * BOX, rl, kc, gv[k][0], gv[k][1]);
        }
        if (last) {
          st_pair(a.cT + (long long)r * H + u, cv[0], cv[1]);
          if (MASKED) st_pair(a.hT + (long long)r * H + u, hv[0], hv[1]);
        }
      }
    }
    // the tiles are read by TMA: h_t first (the next step's loads read it,
    // so it completes before the barrier), then the stash
    sm90::fence_proxy_async_smem();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (tid == 0) {
      const int ot = a.reverse ? a.T - 1 - s : s;
      for (int gi = 0; gi < KG; ++gi)
        sm90::tma_store_3d(&mp.h_st, tiles + (6 * KG + gi) * BOX,
                           u0 + 64 * gi, r0, (s + 1) & 1);
      sm90::bulk_commit();
      for (int gi = 0; gi < KG; ++gi) {
        const int ug0 = u0 + 64 * gi;
        sm90::tma_store_3d(&mp.h_out, tiles + (4 * KG + gi) * BOX, ug0, r0,
                           ot);
        if (STASH) {
          sm90::tma_store_3d(&mp.c, tiles + (5 * KG + gi) * BOX, ug0, r0, ot);
          if (MASKED)  // the selected h: the h_t tile
            sm90::tma_store_3d(&mp.hsel, tiles + (6 * KG + gi) * BOX, ug0, r0,
                               ot);
          for (int k = 0; k < 4; ++k)
            sm90::tma_store_4d(&mp.gates, tiles + (k * KG + gi) * BOX, ug0, k,
                               r0, ot);
        }
      }
      sm90::bulk_commit();
      sm90::bulk_wait<1>();       // h_t is in global memory
      sm90::bulk_wait_read<0>();  // every tile is read: the ring is free
    }
    sm90::cluster_sync();
  }
  if (tid == 0) sm90::bulk_wait<0>();  // the last step's stash is stored
}

template <int ROWS, bool MASKED, bool STASH>
__global__ void __launch_bounds__(kClusterThreads, 1)
    lstm_fwd_cluster_kernel(const __grid_constant__ FwdMaps maps,
                            const FwdClusterArgs a) {
  using Cfg = FwdCfg<ROWS>;
  extern __shared__ unsigned char smem_raw[];
  FwdClusterSmem<ROWS>& sm = *reinterpret_cast<FwdClusterSmem<ROWS>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nch = (a.H + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      // one arrival per consumer warpgroup of every block of the cluster
      sm90::mbar_init(&sm.empty[s], 2 * a.cluster);
    }
    sm90::mbar_init(&sm.x_full, 1);
    sm90::mbar_fence_init();
  }
  const int u0 = blockIdx.x * Cfg::kUnits;
  for (int i = threadIdx.x; i < 3 * Cfg::kUnits; i += kClusterThreads) {
    const int k = i / Cfg::kUnits, u = u0 + i % Cfg::kUnits;
    sm.peep[k][i % Cfg::kUnits] =
        u < a.H ? __bfloat162float(a.peep[k * a.H + u]) : 0.f;
  }
  __syncthreads();
  // every block's barriers are initialised before any multicast or remote
  // arrival reaches them
  sm90::cluster_sync();
  if (threadIdx.x < kConsumers)
    fwd_consumer<ROWS, MASKED, STASH>(sm, a, maps, nch);
  else if (threadIdx.x < kConsumers + 32)
    fwd_producer<ROWS>(sm, a, maps, nch);
  else
    fwd_prefetcher<ROWS>(a);
  sm90::cluster_sync();  // no block leaves while others may reach it
}

// ------------------------------------------------------------------ host
// Routes: the cooperative bf16 forward (small batches), the bf16 cluster
// forward, the f32 cluster kernels (both passes) and the bf16 cluster
// backward.
enum Route { kCoop = 0, kFwdCluster = 1, kF32 = 2, kBwdCluster = 3 };
// The bf16 forward takes the cooperative kernel up to this many batch
// rows at H <= 1024: the cluster kernel's step costs about the same from 1
// to 128 rows a cluster (it streams all of RW through L2 every step),
// while the cooperative blocks keep their slices of RW on chip and slow
// down with B. Measured on an H100 at H = 1024, T = 64 (chip_smoke.py
// phase 15): the cooperative kernel wins at 128 rows and loses at 256.
constexpr int kCoopMaxB = 128;

int route_of(int kind, int dtype, int B, int H) {
  if (dtype == 0) return kF32;
  if (kind == 1) return kBwdCluster;
  return B <= kCoopMaxB && H <= 1024 ? kCoop : kFwdCluster;
}

// A launch plan, as dl4j_lstm_plan reports it.
struct Plan {
  int route, gx, gy, rows, active, cluster, units;
  size_t smem;
};

int device_limits(int* sms, int* optin) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return (int)e;
}

// The cooperative forward: H/8 unit slices (x) times the largest batch
// split (y) for which the whole grid can be resident; a split holds a
// multiple of 16 rows. When even one split does not fit, the plan keeps
// y = 1 and the launch is refused.
int coop_plan(const void* kern, int B, int H, Plan* p) {
  int sms, optin;
  int rc = device_limits(&sms, &optin);
  if (rc) return rc;
  const int gu = (H + kUnits - 1) / kUnits;
  const int tiles = (B + kRows - 1) / kRows;
  int gb = tiles < 2 * sms / gu ? tiles : 2 * sms / gu;
  if (gb < 1) gb = 1;
  for (; gb >= 1; --gb) {
    const int rows = (tiles + gb - 1) / gb * kRows;
    Carver cv{nullptr};
    const size_t smem = FwdSmem<bf16>::carve(cv, nullptr, ceil_to(H, 16), rows);
    int nb = 0;
    if (smem <= (size_t)optin) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, kThreads,
                                                          smem);
      if (e != cudaSuccess) return (int)e;
    }
    *p = Plan{kCoop, gu, gb, rows, nb * sms, 1, kUnits, smem};
    if (nb * sms >= gu * gb) return 0;
  }
  return 0;  // gb = 1 does not fit: the launch reports it
}

inline cudaLaunchConfig_t cluster_config(const Plan& p, int threads,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.gx, p.gy, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A cluster kernel's plan: `units` per block, C = the blocks a row tile of
// `rows` needs (rounded up to a power of two when `pow2`), and how many
// clusters fit on the card at once (0: refused; the wrapper names why: C
// above 16, or H above 2048 where the four gates of a unit no longer fit
// one thread's accumulator in a cluster of 16 blocks).
int cluster_plan(const void* kern, int route, int threads, size_t smem,
                 int rows, int units, bool pow2, int B, int H, Plan* p) {
  int C = (H + units - 1) / units;
  if (pow2) {
    int c2 = 1;
    while (c2 < C) c2 *= 2;
    C = c2;
  }
  *p = Plan{route, C, (B + rows - 1) / rows, rows, 0, C, units, smem};
  if (C > kMaxCluster || H > 2048) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && C > 8)  // beyond the portable 8 blocks
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(*p, threads, attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(&p->active, kern, &cfg);
}

template <bool MASKED, bool STASH>
const void* fwd_kernel(int route, int H) {
  if (route == kCoop) return (const void*)lstm_fwd_kernel<bf16, MASKED, STASH>;
  if (route == kF32) return (const void*)lstm_fwd_f32_kernel<MASKED, STASH>;
  return H <= 1024 ? (const void*)lstm_fwd_cluster_kernel<128, MASKED, STASH>
                   : (const void*)lstm_fwd_cluster_kernel<64, MASKED, STASH>;
}

template <bool MASKED>
const void* bwd_kernel(int route) {
  return route == kF32 ? (const void*)lstm_bwd_f32_kernel<MASKED>
                       : (const void*)lstm_bwd_cluster_kernel<MASKED>;
}

// The plan of kernel `kind` (0 forward, 1 backward) at (dtype, B, H).
template <bool MASKED, bool STASH>
int make_plan(int kind, int dtype, int B, int H, Plan* p) {
  const int route = route_of(kind, dtype, B, H);
  if (route == kCoop)
    return coop_plan(fwd_kernel<MASKED, STASH>(route, H), B, H, p);
  if (route == kF32)
    return cluster_plan(kind == 0 ? fwd_kernel<MASKED, STASH>(route, H)
                                  : bwd_kernel<MASKED>(route),
                        route, kF32Threads, 0, kF32Rows, kF32Units, false, B,
                        H, p);
  if (route == kBwdCluster)
    return cluster_plan(bwd_kernel<MASKED>(route), route, kClusterThreads,
                        kClusterSmemBytes, kTileRows, kTileUnits, true, B, H,
                        p);
  if (H <= 1024)
    return cluster_plan(fwd_kernel<MASKED, STASH>(route, H), route,
                        kClusterThreads, fwd_cluster_smem<128>(), 128,
                        FwdCfg<128>::kUnits, true, B, H, p);
  return cluster_plan(fwd_kernel<MASKED, STASH>(route, H), route,
                      kClusterThreads, fwd_cluster_smem<64>(), 64,
                      FwdCfg<64>::kUnits, true, B, H, p);
}

int launch_ready(const Plan& p) {
  if (p.route == kCoop) return 0;  // a grid too large is refused at launch
  return p.active < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

// The bf16 cluster forward's tensor maps (bf16, 128-byte swizzle): h loads
// from (ldh, Bp, 2) in boxes of 64 columns x `slice` rows of one plane, h
// tiles in (H, B, 2) (clipped at H and B); RWp (Hk, 4 Hu) in boxes of 64
// columns x 256 rows; the outputs (H, B, T), xw and the gates (H, 4, B, T)
// in boxes of 64 units x `rows` rows. Maps of absent outputs stay unset.
int fwd_maps(const FwdArgs& a, const void* rwp, int Hk, int slice, int rows,
             FwdMaps* m) {
  const cuuint64_t H = a.H, B = a.B, T = a.T;
  const cuuint32_t box3[3] = {64, (cuuint32_t)rows, 1};
  {
    const cuuint64_t dims[3] = {(cuuint64_t)a.ldh, (cuuint64_t)a.Bp, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)a.ldh * 2,
                                   (cuuint64_t)a.plane * 2};
    const cuuint32_t box[3] = {kChunk, (cuuint32_t)slice, 1};
    int rc = sm90::make_map_bf16(&m->h_ld, a.hbuf, 3, dims, strides, box);
    const cuuint64_t sdims[3] = {H, B, 2};
    if (rc == 0)
      rc = sm90::make_map_bf16(&m->h_st, a.hbuf, 3, sdims, strides, box3);
    if (rc) return rc;
  }
  {
    const int Hu = ceil_to(a.H, 64);
    const cuuint64_t dims[2] = {(cuuint64_t)Hk, (cuuint64_t)(4 * Hu)};
    const cuuint64_t strides[1] = {(cuuint64_t)Hk * 2};
    const cuuint32_t box[2] = {kChunk, 256};
    const int rc = sm90::make_map_bf16(&m->w, rwp, 2, dims, strides, box);
    if (rc) return rc;
  }
  const cuuint64_t dims[3] = {H, B, T};
  const cuuint64_t strides[2] = {H * 2, H * 2 * B};
  void* outs[3] = {a.h_out, a.c_stash, a.hsel};
  CUtensorMap* maps[3] = {&m->h_out, &m->c, &m->hsel};
  for (int i = 0; i < 3; ++i) {
    if (outs[i] == nullptr) continue;
    const int rc = sm90::make_map_bf16(maps[i], outs[i], 3, dims, strides,
                                       box3);
    if (rc) return rc;
  }
  const cuuint64_t gdims[4] = {H, 4, B, T};
  const cuuint64_t gstrides[3] = {H * 2, H * 8, H * 8 * B};
  const cuuint32_t gbox[4] = {64, 1, (cuuint32_t)rows, 1};
  const int rc =
      sm90::make_map_bf16(&m->xw, a.xw, 4, gdims, gstrides, gbox);
  if (rc || a.gates == nullptr) return rc;
  return sm90::make_map_bf16(&m->gates, a.gates, 4, gdims, gstrides, gbox);
}

template <int ROWS, bool MASKED, bool STASH>
int launch_fwd_cluster(const FwdArgs& a, const Plan& p, const void* rwp,
                       int Hk, cudaStream_t st) {
  FwdMaps maps;
  const int slice = ROWS / p.cluster < 8 ? 8 : ROWS / p.cluster;
  int rc = fwd_maps(a, rwp, Hk, slice, ROWS, &maps);
  if (rc) return rc;
  const FwdClusterArgs ca{static_cast<const bf16*>(a.xw),
                          static_cast<const bf16*>(a.peep),
                          static_cast<const bf16*>(a.c0),
                          static_cast<const bf16*>(a.mask),
                          static_cast<bf16*>(a.hbuf),
                          static_cast<bf16*>(a.hT),
                          static_cast<bf16*>(a.cT),
                          a.plane,
                          a.T,
                          a.B,
                          a.H,
                          a.ldh,
                          a.reverse,
                          p.cluster};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(p, kClusterThreads, attr, st);
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, lstm_fwd_cluster_kernel<ROWS, MASKED, STASH>, maps, ca);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool MASKED, bool STASH>
int launch_fwd(FwdArgs a, int dtype, const void* rwp, int Hk,
               cudaStream_t st) {
  Plan p;
  int rc = make_plan<MASKED, STASH>(0, dtype, a.B, a.H, &p);
  if (rc == 0) rc = launch_ready(p);
  if (rc) return rc;
  if (p.route == kCoop) {
    a.rows = p.rows;
    void* args[] = {&a};
    cudaError_t e = cudaLaunchCooperativeKernel(
        fwd_kernel<MASKED, STASH>(p.route, a.H), dim3(p.gx, p.gy),
        dim3(kThreads), args, p.smem, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (p.route == kF32) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(p, kF32Threads, attr, st);
    cudaError_t e =
        cudaLaunchKernelEx(&cfg, lstm_fwd_f32_kernel<MASKED, STASH>, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  return a.H <= 1024
             ? launch_fwd_cluster<128, MASKED, STASH>(a, p, rwp, Hk, st)
             : launch_fwd_cluster<64, MASKED, STASH>(a, p, rwp, Hk, st);
}

template <bool MASKED>
int launch_bwd(const BwdArgs& a, int dtype, cudaStream_t st) {
  Plan p;
  int rc = make_plan<MASKED, true>(1, dtype, a.B, a.H, &p);
  if (rc == 0) rc = launch_ready(p);
  if (rc) return rc;
  cudaLaunchAttribute attr[1];
  if (p.route == kF32) {
    const cudaLaunchConfig_t cfg = cluster_config(p, kF32Threads, attr, st);
    cudaError_t e = cudaLaunchKernelEx(&cfg, lstm_bwd_f32_kernel<MASKED>, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const cuuint64_t G = 4ull * a.H;
  CUtensorMap tdz, trw;
  {  // dz (T, B, 4H): boxes of 64 columns x (128 / C) rows of one step
    const cuuint64_t dims[3] = {G, (cuuint64_t)a.B, (cuuint64_t)a.T};
    const cuuint64_t strides[2] = {G * 2, G * 2 * a.B};
    const cuuint32_t box[3] = {kChunk, (cuuint32_t)(kTileRows / p.cluster), 1};
    rc = sm90::make_map_bf16(&tdz, a.dz, 3, dims, strides, box);
  }
  if (rc) return rc;
  {  // RW (H, 4H): boxes of 64 columns x 128 units
    const cuuint64_t dims[2] = {G, (cuuint64_t)a.H};
    const cuuint64_t strides[1] = {G * 2};
    const cuuint32_t box[2] = {kChunk, kTileUnits};
    rc = sm90::make_map_bf16(&trw, a.rw, 2, dims, strides, box);
  }
  if (rc) return rc;
  const ClusterArgs ca{static_cast<const bf16*>(a.gates),
                       static_cast<const bf16*>(a.c),
                       static_cast<const bf16*>(a.dh_out),
                       static_cast<const bf16*>(a.dhT),
                       static_cast<const bf16*>(a.dcT),
                       static_cast<const bf16*>(a.mask),
                       static_cast<const bf16*>(a.peep),
                       static_cast<const bf16*>(a.c0),
                       static_cast<bf16*>(a.dz),
                       a.dhc0,
                       a.T,
                       a.B,
                       a.H,
                       a.reverse,
                       p.cluster};
  const cudaLaunchConfig_t cfg = cluster_config(p, kClusterThreads, attr, st);
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, lstm_bwd_cluster_kernel<MASKED>, tdz, trw, ca);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (every tensor argument in that type,
// dhc0 f32). A null `mask` runs the unmasked kernel (hT and hsel unused),
// a null `gates` the forward without the training stash (c_stash and hsel
// unused). `hbuf` is (2, Bp, ldh) zeros with h0 in [0][:B, :H] (Bp >= B,
// ldh >= H rounded up to 128); `rwp` is RW arranged for the bf16 cluster
// forward ((4 Hu, Hk): see lstm_fwd_cluster_kernel; Hu = H rounded up to
// 64, Hk to 8), read by that route only. The bf16 kernels take H a
// multiple of 8 (the wrapper pads it). Each entry returns the cudaError_t
// of its launch: a cooperative grid larger than the co-resident blocks
// cudaErrorCooperativeLaunchTooLarge, a cluster kernel whose plan has no
// cluster that fits cudaErrorInvalidConfiguration.
int dl4j_lstm_fwd(const void* xw, const void* rw, const void* rwp, int Hk,
                  const void* peep, const void* c0, const void* mask,
                  void* hbuf, int Bp, int ldh, void* h_out, void* hT, void* cT,
                  void* hsel, void* c_stash, void* gates, int dtype, int T,
                  int B, int H, int reverse, void* stream) {
  FwdArgs a{};
  a.xw = xw, a.rw = rw, a.peep = peep, a.c0 = c0, a.mask = mask;
  a.hbuf = hbuf, a.h_out = h_out, a.hT = hT, a.cT = cT, a.hsel = hsel;
  a.c_stash = c_stash, a.gates = gates;
  a.T = T, a.B = B, a.H = H, a.Bp = Bp, a.Hp = ceil_to(H, 16);
  a.ldh = ldh, a.plane = (long long)Bp * ldh, a.reverse = reverse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mask)
    return gates ? launch_fwd<true, true>(a, dtype, rwp, Hk, st)
                 : launch_fwd<true, false>(a, dtype, rwp, Hk, st);
  return gates ? launch_fwd<false, true>(a, dtype, rwp, Hk, st)
               : launch_fwd<false, false>(a, dtype, rwp, Hk, st);
}

int dl4j_lstm_bwd(const void* gates, const void* c, const void* dh_out,
                  const void* dhT, const void* dcT, const void* mask,
                  const void* rw, const void* peep, const void* c0, void* dz,
                  float* dhc0, int dtype, int T, int B, int H, int reverse,
                  void* stream) {
  BwdArgs a{};
  a.gates = gates, a.c = c, a.dh_out = dh_out, a.dhT = dhT, a.dcT = dcT;
  a.mask = mask, a.rw = rw, a.peep = peep, a.c0 = c0, a.dz = dz;
  a.dhc0 = dhc0;
  a.T = T, a.B = B, a.H = H, a.reverse = reverse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mask ? launch_bwd<true>(a, dtype, st)
              : launch_bwd<false>(a, dtype, st);
}

// The launch plan of kernel `kind` (0 forward, 1 backward) at (dtype, B,
// H), out[0..6]: {route (0 cooperative forward, 1 bf16 cluster forward, 2
// f32 clusters, 3 bf16 cluster backward), blocks along x (unit slices of
// the cooperative grid, or blocks per cluster), along y (batch splits, or
// row tiles), rows per split or tile, blocks that can be resident at once
// (cooperative) or clusters that fit at once (0: refused), blocks per
// cluster (1 cooperative), units per block}. Returns the dynamic shared
// memory of one block in bytes (1 for the f32 kernels, whose shared memory
// is static; 0 on a CUDA error).
size_t dl4j_lstm_plan(int kind, int dtype, int masked, int B, int H,
                      int* out) {
  Plan p{};
  const int rc = masked ? make_plan<true, true>(kind, dtype, B, H, &p)
                        : make_plan<false, true>(kind, dtype, B, H, &p);
  if (rc) return 0;
  out[0] = p.route, out[1] = p.gx, out[2] = p.gy, out[3] = p.rows;
  out[4] = p.active, out[5] = p.cluster, out[6] = p.units;
  return p.smem ? p.smem : 1;
}

}  // extern "C"
