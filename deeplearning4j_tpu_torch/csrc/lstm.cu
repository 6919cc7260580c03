// The Graves LSTM time loop (peepholes, gate order [i, f, o, g]) as one
// persistent cooperative kernel per layer, direction and pass, on Hopper
// (sm_90a).
//
// Replaces the TPU kernels of deeplearning4j_tpu/ops/pallas_lstm.py:
//   lstm_fwd_kernel<DT, false, *>  <- _lstm_fwd_kernel         (glue _fwd_call)
//   lstm_bwd_kernel<DT, false>     <- _lstm_bwd_kernel         (glue _bwd_call)
//   lstm_fwd_kernel<DT, true, *>   <- _lstm_fwd_kernel_masked  (_fwd_call_masked)
//   lstm_bwd_kernel<DT, true>      <- _lstm_bwd_kernel_masked  (_bwd_call_masked)
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
// Design. The TPU kernel walks a sequential grid axis with the carries and
// all of RW in VMEM; on Hopper RW (H x 4H) does not fit one block, so the
// whole loop runs in ONE cooperative launch whose blocks stay resident:
// block x owns 8 hidden units (kUnits) and keeps their slice of RW in
// shared memory for the whole launch (forward: the 32 columns of its units'
// four gates, one 8-wide mma n-tile per gate; backward: its units' 8 rows
// of RW). Its units' c carry (and dh, dc in the backward) stay in f32 in
// shared memory. Per step every block reads all of h_{t-1} for its batch
// rows from a global ping-pong buffer (operand type, zero-padded to
// (Bp, Hp)), computes its 32 columns of z, applies the gate chain in the
// mma accumulator's own registers (lane (g, t) holds rows g, g+8 and units
// 2t, 2t+1 of all four gates), writes its slice of h_t into the other
// buffer and meets the grid at this_grid().sync(). The backward writes its
// units' dz[t], syncs, then reads the whole dz[t] row block to form its
// units' dh_prev (one sync per step: dz[t] is never rewritten). blockIdx.y
// splits the batch when the card has room for more blocks than unit slices.
// The launch is refused (cudaErrorCooperativeLaunchTooLarge) when the grid
// is larger than the blocks that can be resident at once; there is no spin
// barrier without that guarantee. bf16 products are mma.sync m16n8k16 with
// f32 accumulation; the A operand (h or dz rows) is loaded straight from
// L2 (ld.global.cg: the L1 of another SM may hold a stale line) with one
// 8-byte load per lane and row, the k order inside each 16-wide chunk
// permuted so those 8 bytes are the lane's two A registers, and RW stored
// in shared memory in the same permuted order. f32 runs FMAs (no TF32).
//
// What bounds it on an H100: per step the work is 2*B*H*4H flops against
// B*4H operand bytes in and B*(4H+2H) bytes of stash out; at the training
// shapes (bf16) the card's bound is the bytes at H=256 and the flops at
// H=1024 (chip_smoke.py prints both). This kernel is held back instead by
// its L2 reads of the operand rows: every unit slice reads all of h (B*H)
// per forward step and all of dz (B*4H) per backward step, so H/8 times the
// operand bytes cross L2, plus one grid barrier per step. Clusters with
// multicast, wgmma and wider unit slices are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;   // hidden units per block
constexpr int kRows = 16;   // batch rows per mma tile
// 16-wide k chunks whose A loads are issued together before their
// products: the loads come from L2, and enough must be in flight to
// cover its latency with one or two blocks per SM
constexpr int kFwdBatch = 8;
constexpr int kBwdBatch = 8;

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

// Backward: RW rows of this block's units [8][K] (K = 4H, padded to 32 for
// bf16), the peepholes, and the dh and dc carries of its rows.
template <typename DT>
struct BwdSmem {
  DT* rw;
  float* peep;
  float* dh;
  float* dc;
  __host__ __device__ static int K(int H) {
    return sizeof(DT) == 2 ? ceil_to(4 * H, 32) : 4 * H;
  }
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

// B operands of one 8-wide n-tile at two chunks (k0, k0 + 16): b[0..1]
// for k0, b[2..3] for k0 + 16
__device__ __forceinline__ void ld_b_2k(uint32_t (&b)[4], const bf16* base,
                                        int ld, int k0) {
  const int l = threadIdx.x % 32;
  const bf16* p = base + (l % 8) * ld + k0 + 8 * (l / 8);
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

// Phase 2: dh carry += dz[t] . RW^T for this block's units (bf16 mma)
__device__ __forceinline__ void bwd_dh(const BwdArgs& a,
                                       const BwdSmem<bf16>& sm, int t,
                                       bool first, int r0, int nrows) {
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32, g = l / 4,
            tq = l % 4;
  const int H = a.H, K = BwdSmem<bf16>::K(H), ld = K + Lay<bf16>::kPad;
  const bf16* dz = static_cast<const bf16*>(a.dz) + (long long)t * a.B * 4 * H;
  for (int tile = warp; tile * kRows < nrows; tile += kWarps) {
    const int rt = r0 + tile * kRows;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* rows = dz + (long long)rt * 4 * H;
    const int ok0 = rt + g < a.B, ok1 = rt + g + 8 < a.B;
    for (int kb = 0; kb < K; kb += 16 * kBwdBatch) {
      uint32_t av[kBwdBatch][4];
#pragma unroll
      for (int j = 0; j < kBwdBatch; ++j)
        ld_a_l2(av[j], rows, 4 * H, ok0, ok1, kb + 16 * j, 4 * H);
#pragma unroll
      for (int j = 0; j < kBwdBatch; j += 2) {
        const int k0 = kb + 16 * j;
        if (k0 >= K) break;
        uint32_t b[4];
        ld_b_2k(b, sm.rw, ld, k0);
        mma(acc, av[j], b[0], b[1]);
        mma(acc, av[j + 1], b[2], b[3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = tile * kRows + g + 8 * (e >> 1), ul = 2 * tq + (e & 1);
      const int r = r0 + rl, u = blockIdx.x * kUnits + ul;
      const float v = sm.dh[rl * kUnits + ul] + acc[e];
      sm.dh[rl * kUnits + ul] = v;
      if (first && r < a.B && u < H) a.dhc0[(long long)r * H + u] = v;
    }
  }
}

// f32: thread per (row, unit), FMAs over the 4H columns
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
// launch; a grid larger than the co-resident blocks returns
// cudaErrorCooperativeLaunchTooLarge.
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
    return mask ? launch_bwd<bf16, true>(a, st) : launch_bwd<bf16, false>(a, st);
  return mask ? launch_bwd<float, true>(a, st) : launch_bwd<float, false>(a, st);
}

// The launch plan of kernel `kind` (0 forward, 1 backward) at (B, H):
// out = {unit slices, batch splits, rows per split, co-resident blocks at
// that shared memory}; returns the shared memory of one block in bytes
// (0 on a CUDA error).
size_t dl4j_lstm_plan(int kind, int dtype, int masked, int B, int H,
                      int* out) {
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
    const void* k = dtype == 1
        ? (masked ? (const void*)lstm_bwd_kernel<bf16, true>
                  : (const void*)lstm_bwd_kernel<bf16, false>)
        : (masked ? (const void*)lstm_bwd_kernel<float, true>
                  : (const void*)lstm_bwd_kernel<float, false>);
    rc = dtype == 1 ? plan<bf16>(k, 1, B, H, &p) : plan<float>(k, 1, B, H, &p);
  }
  if (rc) return 0;
  out[0] = p.gu, out[1] = p.gb, out[2] = p.rows, out[3] = p.capacity;
  return p.smem;
}

}  // extern "C"
