// The Graves LSTM time loop (peepholes, gate order [i, f, o, g]) as one
// persistent kernel per layer, direction and pass, on Hopper (sm_90a).
//
// Replaces the TPU kernels of deeplearning4j_tpu/ops/pallas_lstm.py:
//   lstm_fwd_kernel<DT, false, *>       <- _lstm_fwd_kernel  (glue _fwd_call)
//   lstm_bwd_cluster_kernel<false> (bf16), lstm_bwd_kernel<float, false>
//                                       <- _lstm_bwd_kernel  (glue _bwd_call)
//   lstm_fwd_kernel<DT, true, *>        <- _lstm_fwd_kernel_masked
//                                          (glue _fwd_call_masked)
//   lstm_bwd_cluster_kernel<true> (bf16), lstm_bwd_kernel<float, true>
//                                       <- _lstm_bwd_kernel_masked
//                                          (glue _bwd_call_masked)
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
// f32; product operands in the operand type (h rounded before the product,
// never carried rounded); h_out, c, gates and dz stored in xw's type.
//
// Forward, and the f32 backward (the parity path). The TPU kernel walks a
// sequential grid axis with the carries and all of RW in VMEM; on Hopper
// RW (H x 4H) does not fit one block, so the whole loop runs in ONE
// cooperative launch whose blocks stay resident: block x owns 8 hidden
// units (kUnits) and keeps their slice of RW in shared memory for the
// whole launch (forward: the 32 columns of its units' four gates, one
// 8-wide mma n-tile per gate; f32 backward: its units' 8 rows of RW). Its
// units' c carry (and dh, dc in the backward) stay in f32 in shared
// memory. Per step every block reads all of h_{t-1} for its batch rows from
// a global ping-pong buffer (operand type, zero-padded to (Bp, Hp)),
// computes its 32 columns of z, applies the gate chain in the mma
// accumulator's own registers (lane (g, t) holds rows g, g+8 and units 2t,
// 2t+1 of all four gates), writes its slice of h_t into the other buffer
// and meets the grid at this_grid().sync(). The f32 backward writes its
// units' dz[t], syncs, then reads the whole dz[t] row block to form its
// units' dh_prev. blockIdx.y splits the batch when the card has room for
// more blocks than unit slices. The launch is refused
// (cudaErrorCooperativeLaunchTooLarge) when the grid is larger than the
// blocks that can be resident at once; there is no spin barrier without
// that guarantee. bf16 forward products are mma.sync m16n8k16 with f32
// accumulation; the A operand (h rows) is loaded straight from L2
// (ld.global.cg: the L1 of another SM may hold a stale line) with one
// 8-byte load per lane and row, the k order inside each 16-wide chunk
// permuted so those 8 bytes are the lane's two A registers, and RW stored
// in shared memory in the same permuted order. f32 runs FMAs (no TF32).
//
// The bf16 backward (lstm_bwd_cluster_kernel) rests on one fact: the
// recurrence does not couple batch rows (dh_prev of rows m needs dz[t] of
// rows m only, and dz[t] of rows m the carries of rows m only), so no grid
// barrier is needed, only one among the blocks that share a row tile. A
// block owns a tile of 128 batch rows x 128 hidden units and keeps that
// tile's carries on chip for the whole loop: dc in shared memory, dh as
// the product's wgmma accumulator (staged in the ring's A stages, idle
// between products) plus, masked, the select's bypass in registers. The
// H/128 blocks of a row tile (rounded up to a power of
// two) form a thread block cluster, launched with cudaLaunchKernelEx;
// clusters need not be resident together, so the grid runs in waves. Each
// step has two phases:
//  1. cell: two consumer warpgroups compute dz[t] of the tile's rows and
//     its units' four gates from the stash and the carries and store it in
//     xw's type (the Pallas rounding point: dz is rounded before the
//     product), then the cluster meets at barrier.cluster (stores fenced
//     for the async proxy first);
//  2. product: dh_prev[tile] = dz[t][rows, 0:4H] . RW[units, 0:4H]^T on
//     wgmma m64n128k16 (bf16 in, f32 accumulate; the first k step zeroes
//     the accumulator). A producer warp streams K = 4H through a ring of
//     five shared-memory stages of 64 columns by TMA: RW rows from a 2-D
//     tensor map (issued ahead, during the cell phase) and dz[t] rows from
//     a 3-D map (4H, B, T), each block loading 1/C of the row tile's rows
//     and multicasting them to the whole cluster, so a cluster reads dz[t]
//     once from L2. A stage is refilled only after every consumer warp of
//     every block in the cluster released it (remote mbarrier arrivals,
//     one per consumer warpgroup and block, released at CTA scope: a
//     cluster-scope release fences all of the thread's earlier stores at
//     every arrival, which doubled the product's time).
// A prefetch warp brings the next step's stash (gates, c, dh_out) into L2
// while the product runs. Rows past B and units past H are zero in the TMA
// boxes and never written. The f32 backward keeps the cooperative kernel
// (f32 at H=1024, B=2048 stays refused: its shared memory).
//
// What bounds it on an H100: per step the work is 2*B*H*4H flops against
// B*4H operand bytes in and B*(4H+2H) bytes of stash out; at the training
// shapes (bf16) the card's bound is the bytes at H=256 and the flops at
// H=1024 (chip_smoke.py prints both). The forward is held back by its L2
// reads of the operand rows: every unit slice reads all of h (B*H) per
// step, so H/8 times the operand bytes cross L2, plus one grid barrier per
// step. The bf16 backward moves (B/128) * |RW| + |dz[t]| through L2 per
// step (about 150 MB at B=2048, H=1024, against 2.15 GB for a design that
// re-reads dz once per 8-unit slice). What holds it back (chip_smoke.py
// phase 15; clock64 readings per phase on the card): the cell phase, about
// half of each step, whose loads of the stash follow the accumulator's
// layout (8 rows x 16 bytes per warp load) and wait on L2 latency with few
// loads in flight under the 168 registers a thread gets (a coalesced
// mapping spilled and ran slower); per-chunk overhead in the product
// (about 3x the tensor cores' time); and at B=2048, H=1024 two waves (16
// clusters of 8, 15 fit at once).

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
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename DT>
__device__ __forceinline__ DT from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// an element written during this launch by another block: read from L2
__device__ __forceinline__ float ld_l2(const float* p) { return __ldcg(p); }
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

// Operand layout of the RW slice in shared memory, per dtype. bf16 rows
// carry 8 elements of padding (ldmatrix rows 16-byte aligned, spread over
// the banks), f32 rows 4.
template <typename DT>
struct Lay;
template <>
struct Lay<bf16> {
  static constexpr int kPad = 8;
};
template <>
struct Lay<float> {
  static constexpr int kPad = 4;
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

// f32 backward: RW rows of this block's units [8][4H], the peepholes, and
// the dh and dc carries of its rows.
template <typename DT>
struct BwdSmem {
  DT* rw;
  float* peep;
  float* dh;
  float* dc;
  __host__ __device__ static int K(int H) { return 4 * H; }
  __host__ __device__ static size_t carve(Carver& cv, BwdSmem* s, int H,
                                          int rows) {
    BwdSmem x;
    x.rw = cv.take<DT>(size_t(kUnits) * (K(H) + Lay<DT>::kPad));
    x.peep = cv.take<float>(3 * kUnits);
    x.dh = cv.take<float>(size_t(rows) * kUnits);
    x.dc = cv.take<float>(size_t(rows) * kUnits);
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
  void* hbuf;        // (2, Bp, Hp) in the operand type; [0] holds h0
  void* h_out;       // (T, B, H)
  void* hT;          // (B, H), masked kernels only
  void* cT;          // (B, H)
  void* hsel;        // (T, B, H), masked stash
  void* c_stash;     // (T, B, H)
  void* gates;       // (T, B, 4H)
  int T, B, H, Bp, Hp, rows, reverse;
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
    hs = mp ? hn : ld_l2(hcur + (long long)r * a.Hp + u);
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
  hnext[(long long)r * a.Hp + u] = from_f<DT>(hs);
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
    const bf16* rows = hcur + (long long)rt * a.Hp;
    for (int kb = 0; kb < a.Hp; kb += 16 * kFwdBatch) {
      uint32_t av[kFwdBatch][4];
#pragma unroll
      for (int j = 0; j < kFwdBatch; ++j)
        ld_a_l2(av[j], rows, a.Hp, 1, 1, kb + 16 * j, a.Hp);
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

// f32: thread per (row, unit), FMAs over k with 16-byte loads
template <bool MASKED, bool STASH>
__device__ __forceinline__ void fwd_step(const FwdArgs& a,
                                         const FwdSmem<float>& sm, int t,
                                         bool last, int r0, int nrows,
                                         const float* hcur, float* hnext) {
  const int ld = a.Hp + Lay<float>::kPad;
  for (int idx = threadIdx.x; idx < nrows * kUnits; idx += kThreads) {
    const int rl = idx / kUnits, ul = idx % kUnits;
    const float* h = hcur + (long long)(r0 + rl) * a.Hp;
    float z[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < a.Hp; k += 4) {
      const float4 hv = __ldcg(reinterpret_cast<const float4*>(h + k));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 w = *reinterpret_cast<const float4*>(
            sm.rw + (q * kUnits + ul) * ld + k);
        z[q] += hv.x * w.x + hv.y * w.y + hv.z * w.z + hv.w * w.w;
      }
    }
    fwd_cell<float, MASKED, STASH>(a, sm, t, last, r0 + rl, ul, idx, z[0],
                                   z[1], z[2], z[3], hcur, hnext);
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
  const int nrows = min(a.rows, a.Bp - r0);
  fwd_load<DT>(a, sm, r0, nrows);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  DT* hb = static_cast<DT*>(a.hbuf);
  const long long plane = (long long)a.Bp * a.Hp;
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const DT* hcur = hb + (s & 1) * plane;
    DT* hnext = hb + ((s + 1) & 1) * plane;
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
  int T, B, H, Bp, rows, reverse;
};

template <typename DT>
__device__ void bwd_load(const BwdArgs& a, const BwdSmem<DT>& sm, int r0,
                         int nrows, bool masked) {
  const int H = a.H, K = BwdSmem<DT>::K(H), u0 = blockIdx.x * kUnits;
  constexpr int ld_pad = Lay<DT>::kPad;
  const DT* rw = static_cast<const DT*>(a.rw);
  for (int idx = threadIdx.x; idx < kUnits * K; idx += kThreads) {
    const int ul = idx / K, k = idx % K, u = u0 + ul;
    const float v = (k < 4 * H && u < H) ? to_f(rw[(long long)u * 4 * H + k])
                                         : 0.f;
    const int pos = sizeof(DT) == 2 ? (k & ~15) + perm16(k & 15) : k;
    sm.rw[ul * (K + ld_pad) + pos] = from_f<DT>(v);
  }
  const DT* pp = static_cast<const DT*>(a.peep);
  for (int idx = threadIdx.x; idx < 3 * kUnits; idx += kThreads) {
    const int u = u0 + idx % kUnits;
    sm.peep[idx] = u < H ? to_f(pp[(idx / kUnits) * H + u]) : 0.f;
  }
  const DT* dcT = static_cast<const DT*>(a.dcT);
  const DT* dhT = static_cast<const DT*>(a.dhT);
  for (int idx = threadIdx.x; idx < nrows * kUnits; idx += kThreads) {
    const int r = r0 + idx / kUnits, u = u0 + idx % kUnits;
    const bool ok = r < a.B && u < H;
    const long long e = (long long)r * H + u;
    sm.dc[idx] = ok ? to_f(dcT[e]) : 0.f;
    sm.dh[idx] = ok && masked ? to_f(dhT[e]) : 0.f;
  }
}

// Phase 1 of a backward step: dz[t] of this block's units and rows from
// the stash and the carries; dc_prev into the dc carry, the select's
// bypass of dh (0 unmasked) into the dh carry.
template <typename DT, bool MASKED>
__device__ __forceinline__ void bwd_cells(const BwdArgs& a,
                                          const BwdSmem<DT>& sm, int t,
                                          int t_prev, bool first, int r0,
                                          int nrows) {
  const int H = a.H, u0 = blockIdx.x * kUnits;
  const DT* gates = static_cast<const DT*>(a.gates);
  const DT* cst = static_cast<const DT*>(a.c);
  for (int idx = threadIdx.x; idx < nrows * kUnits; idx += kThreads) {
    const int r = r0 + idx / kUnits, ul = idx % kUnits, u = u0 + ul;
    if (r >= a.B || u >= H) continue;
    const long long row = (long long)t * a.B + r;
    const DT* gt = gates + row * 4 * H + u;
    const float i = to_f(gt[0]), f = to_f(gt[H]), o = to_f(gt[2 * H]),
                g = to_f(gt[3 * H]);
    const float c_prev =
        first ? to_f(static_cast<const DT*>(a.c0)[(long long)r * H + u])
              : to_f(cst[((long long)t_prev * a.B + r) * H + u]);
    const float pI = sm.peep[ul], pF = sm.peep[kUnits + ul],
                pO = sm.peep[2 * kUnits + ul];
    const float dho = to_f(static_cast<const DT*>(a.dh_out)[row * H + u]);
    const float dhc = sm.dh[idx], dcc = sm.dc[idx];
    float dh, dcn, c_t, byp_h = 0.f, byp_c = 0.f;
    if constexpr (MASKED) {
      const float m = to_f(static_cast<const DT*>(a.mask)[row]);
      const bool mp = m > 0.f;
      const float d_hsel = m * dho + dhc;
      dh = mp ? d_hsel : 0.f;
      byp_h = mp ? 0.f : d_hsel;
      dcn = mp ? dcc : 0.f;
      byp_c = mp ? 0.f : dcc;
      c_t = f * c_prev + i * g;  // the candidate; the stash holds c_sel
    } else {
      dh = dho + dhc;
      dcn = dcc;
      c_t = to_f(cst[row * H + u]);
    }
    const float tc = tanhf(c_t);
    const float dzo = dh * tc * o * (1.f - o);
    const float dct = dh * o * (1.f - tc * tc) + dcn + dzo * pO;
    const float dzg = dct * i * (1.f - g * g);
    const float dzi = dct * g * i * (1.f - i);
    const float dzf = dct * c_prev * f * (1.f - f);
    const float dc_prev = dct * f + dzi * pI + dzf * pF + byp_c;
    DT* dz = static_cast<DT*>(a.dz) + row * 4 * H + u;
    dz[0] = from_f<DT>(dzi);
    dz[H] = from_f<DT>(dzf);
    dz[2 * H] = from_f<DT>(dzo);
    dz[3 * H] = from_f<DT>(dzg);
    sm.dc[idx] = dc_prev;
    sm.dh[idx] = byp_h;
    if (first) a.dhc0[(long long)a.B * H + (long long)r * H + u] = dc_prev;
  }
}

// Phase 2 (f32): dh carry += dz[t] . RW^T, thread per (row, unit), FMAs
// over the 4H columns
__device__ __forceinline__ void bwd_dh(const BwdArgs& a,
                                       const BwdSmem<float>& sm, int t,
                                       bool first, int r0, int nrows) {
  const int H = a.H, K = 4 * H, ld = K + Lay<float>::kPad;
  const float* dz = static_cast<const float*>(a.dz) + (long long)t * a.B * K;
  for (int idx = threadIdx.x; idx < nrows * kUnits; idx += kThreads) {
    const int rl = idx / kUnits, ul = idx % kUnits, r = r0 + rl;
    const int u = blockIdx.x * kUnits + ul;
    if (r >= a.B) continue;
    const float* row = dz + (long long)r * K;
    const float* w = sm.rw + ul * ld;
    float s = 0.f;
    for (int k = 0; k < K; k += 4) {
      const float4 d = __ldcg(reinterpret_cast<const float4*>(row + k));
      const float4 v = *reinterpret_cast<const float4*>(w + k);
      s += d.x * v.x + d.y * v.y + d.z * v.z + d.w * v.w;
    }
    const float v = sm.dh[idx] + s;
    sm.dh[idx] = v;
    if (first && u < H) a.dhc0[(long long)r * H + u] = v;
  }
}

template <typename DT, bool MASKED>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carver cv{smem_raw};
  BwdSmem<DT> sm;
  BwdSmem<DT>::carve(cv, &sm, a.H, a.rows);
  const int r0 = blockIdx.y * a.rows;
  const int nrows = min(a.rows, a.Bp - r0);
  bwd_load<DT>(a, sm, r0, nrows, MASKED);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  // backward step s undoes forward step T-1-s
  for (int s = 0; s < a.T; ++s) {
    const int sf = a.T - 1 - s;
    const int t = a.reverse ? a.T - 1 - sf : sf;
    const int t_prev = a.reverse ? t + 1 : t - 1;
    const bool first = sf == 0;
    if (nrows > 0) bwd_cells<DT, MASKED>(a, sm, t, t_prev, first, r0, nrows);
    grid.sync();  // every block's dz[t] written
    if (nrows > 0) bwd_dh(a, sm, t, first, r0, nrows);
    __syncthreads();  // the dh carry is read by other threads next step
  }
}

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

// ------------------------------------------------------------------ host
struct Plan {
  int gu, gb, rows, capacity;
  size_t smem;
};

template <typename DT>
size_t smem_bytes(int kind, int H, int rows) {
  Carver cv{nullptr};
  return kind == 0 ? FwdSmem<DT>::carve(cv, nullptr, ceil_to(H, 16), rows)
                   : BwdSmem<DT>::carve(cv, nullptr, H, rows);
}

// Grid: H/8 unit slices (x) times the largest batch split (y) for which
// the whole grid can be resident; a split holds a multiple of 16 rows.
// When even one split does not fit, the plan keeps y = 1 and the launch is
// refused.
template <typename DT>
int plan(const void* kern, int kind, int B, int H, Plan* p) {
  int dev, sms, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  const int gu = (H + kUnits - 1) / kUnits;
  const int tiles = (B + kRows - 1) / kRows;
  int gb = tiles < 2 * sms / gu ? tiles : 2 * sms / gu;
  if (gb < 1) gb = 1;
  for (; gb >= 1; --gb) {
    const int rows = (tiles + gb - 1) / gb * kRows;
    const size_t smem = smem_bytes<DT>(kind, H, rows);
    int nb = 0;
    if (smem <= (size_t)optin) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, kThreads,
                                                        smem);
      if (e != cudaSuccess) return (int)e;
    }
    *p = Plan{gu, gb, rows, nb * sms, smem};
    if (nb * sms >= gu * gb) return 0;
  }
  return 0;  // gb = 1 does not fit: the launch reports it
}

template <typename DT, bool MASKED, bool STASH>
int launch_fwd(FwdArgs a, cudaStream_t st) {
  const void* kern = (const void*)lstm_fwd_kernel<DT, MASKED, STASH>;
  Plan p;
  int rc = plan<DT>(kern, 0, a.B, a.H, &p);
  if (rc) return rc;
  if (p.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  a.rows = p.rows;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(p.gu, p.gb),
                                              dim3(kThreads), args, p.smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename DT, bool MASKED>
int launch_bwd(BwdArgs a, cudaStream_t st) {
  const void* kern = (const void*)lstm_bwd_kernel<DT, MASKED>;
  Plan p;
  int rc = plan<DT>(kern, 1, a.B, a.H, &p);
  if (rc) return rc;
  if (p.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  a.rows = p.rows;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(p.gu, p.gb),
                                              dim3(kThreads), args, p.smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The bf16 backward's plan at (B, H): C = the H/128 unit tiles rounded up
// to a power of two (so 128 rows split evenly over the blocks' multicast
// slices; tiles past H do nothing but their share of the loads), a cluster
// per row tile of 128, and how many clusters fit on the card at once
// (0: refused, the wrapper names why: H odd, so a row of dz or RW is not
// a multiple of 16 bytes as TMA needs; C above 16).
struct ClusterPlan {
  int cluster, tiles, active;
};

inline cudaLaunchConfig_t cluster_config(const ClusterPlan& p,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, p.tiles, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = kClusterSmemBytes;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool MASKED>
int cluster_plan(int B, int H, ClusterPlan* p) {
  const void* kern = (const void*)lstm_bwd_cluster_kernel<MASKED>;
  int C = 1;
  while (C * kTileUnits < H) C *= 2;
  *p = ClusterPlan{C, (B + kTileRows - 1) / kTileRows, 0};
  if (H % 2 || C > kMaxCluster) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kClusterSmemBytes);
  if (e == cudaSuccess && C > 8)  // 16 blocks: beyond the portable 8
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(*p, attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(&p->active, kern, &cfg);
}

template <bool MASKED>
int launch_bwd_cluster(const BwdArgs& a, cudaStream_t st) {
  ClusterPlan p;
  int rc = cluster_plan<MASKED>(a.B, a.H, &p);
  if (rc) return rc;
  if (p.active < 1) return (int)cudaErrorInvalidConfiguration;
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
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(p, attr, st);
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, lstm_bwd_cluster_kernel<MASKED>, tdz, trw, ca);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename DT>
int fwd_dispatch(const FwdArgs& a, bool masked, bool stash, cudaStream_t st) {
  if (masked)
    return stash ? launch_fwd<DT, true, true>(a, st)
                 : launch_fwd<DT, true, false>(a, st);
  return stash ? launch_fwd<DT, false, true>(a, st)
               : launch_fwd<DT, false, false>(a, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (every tensor argument in that type,
// dhc0 f32). A null `mask` runs the unmasked kernel (hT and hsel unused),
// a null `gates` the forward without the training stash (c_stash and hsel
// unused). `hbuf` is (2, Bp, Hp) zeros with h0 in [0][:B, :H], Bp and Hp
// B and H rounded up to 16. Each entry returns the cudaError_t of its
// launch; a cooperative grid larger than the co-resident blocks returns
// cudaErrorCooperativeLaunchTooLarge, a bf16 backward whose plan has no
// cluster that fits cudaErrorInvalidConfiguration.
int dl4j_lstm_fwd(const void* xw, const void* rw, const void* peep,
                  const void* c0, const void* mask, void* hbuf, void* h_out,
                  void* hT, void* cT, void* hsel, void* c_stash, void* gates,
                  int dtype, int T, int B, int H, int reverse, void* stream) {
  FwdArgs a{};
  a.xw = xw, a.rw = rw, a.peep = peep, a.c0 = c0, a.mask = mask;
  a.hbuf = hbuf, a.h_out = h_out, a.hT = hT, a.cT = cT, a.hsel = hsel;
  a.c_stash = c_stash, a.gates = gates;
  a.T = T, a.B = B, a.H = H, a.Bp = ceil_to(B, 16), a.Hp = ceil_to(H, 16);
  a.reverse = reverse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool masked = mask != nullptr, stash = gates != nullptr;
  return dtype == 1 ? fwd_dispatch<bf16>(a, masked, stash, st)
                    : fwd_dispatch<float>(a, masked, stash, st);
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
  a.T = T, a.B = B, a.H = H, a.Bp = ceil_to(B, 16), a.reverse = reverse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return mask ? launch_bwd_cluster<true>(a, st)
                : launch_bwd_cluster<false>(a, st);
  return mask ? launch_bwd<float, true>(a, st) : launch_bwd<float, false>(a, st);
}

// The launch plan of kernel `kind` (0 forward, 1 backward) at (B, H),
// out[0..5]: the cooperative kernels (forward; f32 backward) {unit slices
// of 8, batch splits, rows per split, blocks that can be resident at that
// shared memory, 1, 8}; the bf16 backward {unit tiles, row tiles, 128 rows
// per tile, clusters that fit on the card at once (0: refused), cluster
// size, 128 units per block}. Returns the shared memory of one block in
// bytes (0 on a CUDA error).
size_t dl4j_lstm_plan(int kind, int dtype, int masked, int B, int H,
                      int* out) {
  if (kind == 1 && dtype == 1) {
    ClusterPlan c{};
    if (masked ? cluster_plan<true>(B, H, &c) : cluster_plan<false>(B, H, &c))
      return 0;
    out[0] = c.cluster, out[1] = c.tiles, out[2] = kTileRows;
    out[3] = c.active, out[4] = c.cluster, out[5] = kTileUnits;
    return kClusterSmemBytes;
  }
  Plan p{};
  int rc;
  if (kind == 0) {
    const void* k = dtype == 1
        ? (masked ? (const void*)lstm_fwd_kernel<bf16, true, true>
                  : (const void*)lstm_fwd_kernel<bf16, false, true>)
        : (masked ? (const void*)lstm_fwd_kernel<float, true, true>
                  : (const void*)lstm_fwd_kernel<float, false, true>);
    rc = dtype == 1 ? plan<bf16>(k, 0, B, H, &p) : plan<float>(k, 0, B, H, &p);
  } else {
    const void* k = masked ? (const void*)lstm_bwd_kernel<float, true>
                           : (const void*)lstm_bwd_kernel<float, false>;
    rc = plan<float>(k, 1, B, H, &p);
  }
  if (rc) return 0;
  out[0] = p.gu, out[1] = p.gb, out[2] = p.rows, out[3] = p.capacity;
  out[4] = 1, out[5] = kUnits;
  return p.smem;
}

}  // extern "C"
