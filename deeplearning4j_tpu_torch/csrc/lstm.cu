// The Graves LSTM time loop (peepholes, gate order [i, f, o, g]) as one
// persistent kernel per layer, direction and pass, on Hopper (sm_90a).
//
// Replaces the TPU kernels of deeplearning4j_tpu/ops/pallas_lstm.py:
//   <- _lstm_fwd_kernel (glue _fwd_call), and masked
//      <- _lstm_fwd_kernel_masked (glue _fwd_call_masked):
//        lstm_fwd_cluster_kernel<ROWS, MASKED, *> (bf16),
//        lstm_fwd_kernel<MASKED, *> (bf16, B <= 128 and H <= 1024),
//        lstm_fwd_tf32_kernel<MASKED, *> (f32);
//   <- _lstm_bwd_kernel (glue _bwd_call), and masked
//      <- _lstm_bwd_kernel_masked (glue _bwd_call_masked):
//        lstm_bwd_cluster_kernel<MASKED> (bf16),
//        lstm_bwd_tf32_kernel<MASKED> (f32).
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
// f32 (the forwards and the f32 backward take sigmoid and tanh
// from ex2 and an approximate reciprocal, a few ulp of f32); product
// operands in the operand type (h rounded before the product, never
// carried rounded; f32 operands split into two TF32 parts, the
// reference's HIGHEST precision); h_out, c, gates and dz stored in xw's
// type.
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
//  - f32 (lstm_fwd_tf32_kernel, lstm_bwd_tf32_kernel, rows 5-8 in f32):
//    the same two skeletons with each step's product in split TF32 (three
//    wgmma m64n128k8 .tf32 passes per k step, each 32-wide k chunk summed
//    on a fresh accumulator and added in f32): 64 rows x 64 units per
//    forward block up to H = 1024, 64 x 128 in two passes above, 128 x 128
//    per backward block; the cell phase reads the product back by rows from
//    shared memory and writes the step operand's two TF32 parts for the
//    next product.
// The bf16 forward at B <= 128 and H <= 1024 takes the cooperative kernel
// (lstm_fwd_kernel): a row tile there would stream all of RW through L2
// every step, while each cooperative block keeps its 8 units' slice of RW
// in shared memory for the whole launch; h[t-1] reaches every block by
// TMA (multicast within clusters of up to 8 blocks), the product runs on
// wgmma m64n32k16, and the blocks wait for each other's h_t on a counter
// in global memory (every block resident, or the launch is refused with
// cudaErrorCooperativeLaunchTooLarge; never a spin wait without that
// guarantee).
//
// What bounds it on an H100: per step the work is 2*B*H*4H flops against
// B*4H operand bytes in and B*(4H+2H) bytes of stash out; at the training
// shapes (bf16) the card's bound is the bytes at H=256 and the flops at
// H=1024 (chip_smoke.py prints both). The cluster kernels move (B / rows)
// x |RW| + |h| (forward) or + |dz[t]| (backward) through L2 per step
// (forward, B=2048, H=1024: 16 x 8 MB), against H/8 x |h| / C for the
// cooperative kernel, whose every block multiplies all of h (16 MB a step
// at B=128, H=1024, clusters of 2). What holds the bf16
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int ceil_to(int x, int m) {
  return (x + m - 1) / m * m;
}

// ================================================================ forward
struct FwdArgs {
  const void* xw;    // (T, B, 4H)
  const void* peep;  // (3, H)
  const void* c0;    // (B, H)
  const void* mask;  // (T, B), masked kernels only
  void* hbuf;        // (2, Bp, ldh) in the operand type; [0] holds h0
  unsigned* sync;    // the cooperative forward's step counter, 0 at launch
  void* h_out;       // (T, B, H)
  void* hT;          // (B, H), masked kernels only
  void* cT;          // (B, H)
  void* hsel;        // (T, B, H), masked stash
  void* c_stash;     // (T, B, H)
  void* gates;       // (T, B, 4H)
  int T, B, H;
  int Bp, ldh;       // hbuf's rows and row stride
  int reverse;
  long long plane;   // Bp * ldh
};

// =============================================================== backward
struct BwdArgs {
  const void* gates;   // (T, B, 4H)
  const void* c;       // (T, B, H): c, or c_sel (masked)
  const void* dh_out;  // (T, B, H)
  const void* dhT;     // (B, H), masked kernels only
  const void* dcT;     // (B, H)
  const void* mask;    // (T, B), masked kernels only
  const void* rw;      // (H, 4H)
  const void* rwp;     // (2, H, 4H): RW's TF32 planes (split-TF32 route)
  const void* peep;    // (3, H)
  const void* c0;      // (B, H)
  void* dz;            // (T, B, 4H)
  void* dzbuf;         // (2, B, 4H): dz[t]'s TF32 planes (split-TF32 route)
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

// ============================================= f32, split-TF32 clusters
// Rows 5-8 in f32 (a network's default precision): the step's recurrent
// product on the tensor cores in split TF32, the counterpart of the
// reference's HIGHEST-precision _dot (pallas_lstm.py: bf16x3 passes on the
// MXU). Every operand x is split into big = rna_tf32(x) and small =
// rna_tf32(x - big) (sm90::split_tf32), and a.b ~ a_small.b_big +
// a_big.b_small + a_big.b_big, small terms first, on wgmma m64n128k8 .tf32
// with both operands K-major in shared memory (both LSTM products are
// K-major on both sides, so no transposed copy is needed):
//  - forward, z = h[t-1] . RW[:, a 32-unit group's 4 gates]: A is the
//    h[t-1] rows (K = H), B is RW arranged per 32-unit group by the
//    wrapper (`_rw_by_unit_group(rw, 32, 4)`: gate q of unit 32 G + j at
//    row 128 G + 32 q + j) and streamed in f32: each warpgroup splits its
//    tile of a stage once it has arrived (big in place, small into ws), so
//    L2 carries RW once per row tile and step, not twice;
//  - backward, dh_prev = dz[t] . RW^T: A is the dz[t] rows (K = 4H), B is
//    RW's own rows (unit n over 4H), split once per launch by the wrapper
//    into two planes (`_tf32_planes`): the block's two warpgroups share
//    each RW tile, and a per-stage split measured slower.
// The cell phase that produces the step operand (h_t forward, dz[t]
// backward) writes its big and small parts itself, into a scratch of two
// planes (forward: double-buffered, `hbuf` (2 x 2, B, ldh); backward:
// `dzbuf` (2, B, 4H)), from which TMA multicasts each block's slice of
// the tile's rows to the cluster, as in the bf16 cluster kernels; the f32
// outputs (h_out, dz, the stash) stay f32. The product goes through shared
// memory to the cell phase, where a warp takes 16 rows and its lanes 32
// consecutive units: every load and store of the cell phase is 128
// contiguous bytes (the accumulator's layout, 8 rows x 32 bytes a warp,
// doubled the cell phase's time).
// Accuracy: the tensor cores truncate the sums they accumulate. Each
// 32-wide k chunk (4 k steps x 3 passes) is summed on a fresh accumulator
// (its first wgmma overwrites it) and added into a running f32 sum with
// f32 adds (round to nearest), so the truncation never runs along K (1024
// forward, 4096 backward at H = 1024). Two accumulators of m64n128 (64
// registers a thread each) fit the 168 registers ptxas gives a thread of
// these blocks; m64n256 would not, so a consumer warpgroup owns 128
// product columns at a time:
//  - forward: 64 rows x 64 units a block, each warpgroup 32 units x 4
//    gates over the same 64 h rows, in clusters of ceil(H / 64) blocks
//    rounded up to a power of two, up to H = 1024 (16 blocks); above, 64
//    x 128 in two passes a step of 32 units per warpgroup (the h rows
//    re-streamed), clusters of ceil(H / 128);
//  - backward: 128 rows x 128 units a block (two warpgroups of 64 rows
//    over the same RW rows), clusters of ceil(H / 128).
// The carries live in the f32 outputs that end up holding them (c in cT,
// the masked forward's h in hT, the backward's dc in dhc0[1]; the wrapper
// fills them with c0, h0 and dcT): each thread reads and writes only its
// own cells. Sums run in a fixed order, without atomics: bits are
// identical run to run.
// What bounds it: at T=8, B=2048, H=1024 the 3 x 137 GFLOP on the TF32
// tensor cores (0.83 ms at 495 TFLOP/s). Beside the products a step holds
// the RW splits (forward), the cell phase (its f32 loads and stores) and
// the cluster barrier, during which the tensor cores idle
// (chip_phase_profile.py prints the cycles of each).
constexpr int kTfK = 32;              // k per ring stage: a 128-byte row
constexpr int kTfFwdRows = 64;        // forward tile: 64 rows x 64 P units
constexpr int kTfFwdUnits = 64;       // units of a block per pass
constexpr int kTfFwdStages = 4;
constexpr int kTfBwdRows = 128;       // backward tile: 128 rows x 128 units
constexpr int kTfBwdUnits = 128;
constexpr int kTfBwdStages = 3;
// The forward takes one pass of 64 units a block up to this H (clusters of
// 16 at most), two passes of 64 above (clusters of ceil(H / 128)): at H =
// 1024 one pass measured faster, its 16-block clusters filling more of
// the card than 8-block ones with two passes (32 row tiles at B = 2048).
constexpr int kTfOnePassH = kMaxCluster * kTfFwdUnits;  // 1024

// d = A . B^T over one 32-wide k chunk in split TF32 (A 64 rows and B 128
// rows of 128-byte-swizzled tiles, each as a big and a small plane), the
// small terms first, on a fresh accumulator (the first wgmma overwrites
// it); waits for the products.
__device__ __forceinline__ void tf_chunk(float (&d)[64], const float* ab,
                                         const float* as, const float* bb,
                                         const float* bs) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTfK / 8; ++kk) {
    const uint64_t dab = sm90::desc_sw128(ab + 8 * kk);
    const uint64_t das = sm90::desc_sw128(as + 8 * kk);
    const uint64_t dbb = sm90::desc_sw128(bb + 8 * kk);
    const uint64_t dbs = sm90::desc_sw128(bs + 8 * kk);
    if (kk == 0)
      sm90::wgmma_m64n128k8_tf32_zero(d, das, dbb);  // a fresh accumulator
    else
      sm90::wgmma_m64n128k8_tf32(d, das, dbb, 1);
    sm90::wgmma_m64n128k8_tf32(d, dab, dbs, 1);
    sm90::wgmma_m64n128k8_tf32(d, dab, dbb, 1);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(d);
}

// sigmoid and tanh from ex2 and an approximate reciprocal (a few ulp of
// f32, as the bf16 cluster forward takes them; 0 and +-1 at the extremes)
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

// the chunk's products added into the running sum: f32 adds, round to
// nearest
__device__ __forceinline__ void add_chunk(float (&sum)[64],
                                          const float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] += d[i];
}

// An m64n128 accumulator (d[4j + 2rr + e1] of warp w, lane 4g + tq: row
// 16w + g + 8rr, column 8j + 2tq + e1) and a row-major tile in shared
// memory, rows of 128 columns, column group (col / 4) of a row XORed with
// row % 8: the stores of a warp (8 rows x 4 column pairs) and the reads
// of a row by 32 lanes (32 consecutive columns) are both free of bank
// conflicts. A warp writes and reads only its own 16 rows, from `row0`.
__device__ __forceinline__ int tile_at(int row, int col) {
  return row * 128 + (col ^ ((row & 7) << 2));
}
__device__ __forceinline__ void acc_to_tile(float* tile, const float (&d)[64],
                                            int row0, int g, int tq) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<float2*>(
          tile + tile_at(row0 + g + 8 * rr, 8 * j + 2 * tq)) =
          make_float2(d[4 * j + 2 * rr], d[4 * j + 2 * rr + 1]);
}
__device__ __forceinline__ void tile_to_acc(float (&d)[64], const float* tile,
                                            int row0, int g, int tq) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float2 v = *reinterpret_cast<const float2*>(
          tile + tile_at(row0 + g + 8 * rr, 8 * j + 2 * tq));
      d[4 * j + 2 * rr] = v.x, d[4 * j + 2 * rr + 1] = v.y;
    }
}

// x's two TF32 parts: big at big[i], small one plane further
__device__ __forceinline__ void st_split(float* big, long long plane,
                                         long long i, float x) {
  uint32_t b, s;
  sm90::split_tf32(x, b, s);
  big[i] = __uint_as_float(b);
  big[plane + i] = __uint_as_float(s);
}

// An RW tile of N f32 values, as TMA delivered it, split in place into
// its TF32 big parts, the small parts written at the same offsets of
// `small` (the 128-byte swizzle moves 16-byte groups, so the split is
// position for position), by THREADS threads of which this is `i`, every
// load issued first; then fenced for the async proxy (wgmma reads both).
template <int N, int THREADS>
__device__ __forceinline__ void split_tile(float* tile, float* small, int i) {
  constexpr int kPer = N / (4 * THREADS);  // 16-byte groups a thread
  float4 v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];\n"
                 : "=f"(v[j].x), "=f"(v[j].y), "=f"(v[j].z), "=f"(v[j].w)
                 : "r"(sm90::smem_u32(tile + 4 * (i + j * THREADS))));
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = 4 * (i + j * THREADS);
    uint32_t b[4], sp[4];
    sm90::split_tf32(v[j].x, b[0], sp[0]);
    sm90::split_tf32(v[j].y, b[1], sp[1]);
    sm90::split_tf32(v[j].z, b[2], sp[2]);
    sm90::split_tf32(v[j].w, b[3], sp[3]);
    asm volatile("st.shared.v4.b32 [%0], {%1,%2,%3,%4};\n" ::"r"(
                     sm90::smem_u32(tile + k)),
                 "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3])
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1,%2,%3,%4};\n" ::"r"(
                     sm90::smem_u32(small + k)),
                 "r"(sp[0]), "r"(sp[1]), "r"(sp[2]), "r"(sp[3])
                 : "memory");
  }
  sm90::fence_proxy_async_smem();
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------ forward
// A stage: the h[t-1] rows of the tile in their two TF32 planes (TMA,
// multicast) and each warpgroup's RW rows of the current pass in f32
// (TMA), split by that warpgroup once they have arrived: big in place,
// small into ws.
struct TfFwdSmem {
  float a[kTfFwdStages][2][kTfFwdRows * kTfK];  // h[t-1]: big, small
  float w[kTfFwdStages][2][4 * 32 * kTfK];      // [warpgroup] RW rows
  float ws[2][4 * 32 * kTfK];  // [warpgroup] small parts of its RW tile
  float peep[3][2 * kTfFwdUnits];
  uint64_t full[kTfFwdStages], empty[kTfFwdStages];
};
constexpr uint32_t kTfFwdStageBytes =
    sizeof(float) * kTfK * (2 * kTfFwdRows + 2 * 4 * 32);
constexpr size_t kTfFwdSmemBytes = sizeof(TfFwdSmem) + 1024;  // + align

struct TfFwdArgs {
  const float *xw, *peep, *mask;
  float *hbuf, *h_out, *hT, *cT, *hsel, *c_stash, *gates;
  long long plane;  // B * ldh: one plane of hbuf
  int T, B, H, ldh, reverse, cluster;
};

// h loads from hbuf (H, B, 4 planes: step parity x {big, small}) in boxes
// of 32 columns x `slice` rows; RW arranged per 32-unit group (H, 4 Hu) in
// boxes of 32 columns x 128 rows (one group's four gates)
struct TfFwdMaps {
  CUtensorMap h, w;
};

// Producer warp, per step: the RW chunks of the first three ring stages
// before the cluster barrier (they do not depend on h; the fourth stage
// holds the consumers' product during the last cell phase), then this
// block's slice of every chunk's h[t-1] rows (both planes, multicast to
// the cluster) and the remaining RW chunks, pass after pass. A stage is
// refilled once every consumer warpgroup of every block of the cluster
// released it.
template <int P>
__device__ void tf_fwd_producer(TfFwdSmem& sm, const TfFwdArgs& a,
                                const TfFwdMaps& m, int nch) {
  constexpr int S = kTfFwdStages;
  const bool leader = threadIdx.x % 32 == 0;
  const int C = a.cluster, r0 = blockIdx.y * kTfFwdRows;
  const int g0 = 2 * P * blockIdx.x;  // the block's first 32-unit group
  const uint32_t rank = sm90::cluster_rank();
  // each loading block's rows: at least 8 (a whole swizzle atom)
  const int slice = kTfFwdRows / C < 8 ? 8 : kTfFwdRows / C;
  const bool loads = (int)rank * slice < kTfFwdRows;
  const uint16_t mask = (uint16_t)((1u << C) - 1);
  const int n = P * nch;  // a step's chunks: P passes
  const int ahead = n < S - 1 ? n : S - 1;
  // chunk i of a step: pass i / nch (warpgroup wg's units 32 (P wg + pass)
  // .. + 31 of the block), k chunk i % nch
  auto issue_w = [&](uint32_t q, int i) {
    const uint32_t st = q % S;
    sm90::mbar_wait_cluster(&sm.empty[st], ((q / S) & 1) ^ 1);
    sm90::mbar_expect_tx(&sm.full[st], kTfFwdStageBytes);
    for (int wg = 0; wg < 2; ++wg)
      sm90::tma_load_2d(sm.w[st][wg], &m.w, &sm.full[st], (i % nch) * kTfK,
                        (g0 + P * wg + i / nch) * 128);
  };
  uint32_t q = 0;  // chunks issued before this step
  for (int s = 0; s < a.T; ++s) {
    if (leader)
      for (int i = 0; i < ahead; ++i) issue_w(q + i, i);
    if (s > 0) sm90::cluster_sync();  // h[t-1] stored by every block
    if (leader)
      for (int i = 0; i < n; ++i) {
        const uint32_t st = (q + i) % S;
        if (i >= ahead) issue_w(q + i, i);
        if (!loads) continue;
        for (int pl = 0; pl < 2; ++pl) {
          float* dst = sm.a[st][pl] + rank * slice * kTfK;
          const int hp = 2 * (s & 1) + pl, k0 = (i % nch) * kTfK;
          if (C == 1)
            sm90::tma_load_3d(dst, &m.h, &sm.full[st], k0, r0, hp);
          else
            sm90::tma_load_3d_multicast(dst, &m.h, &sm.full[st], mask, k0,
                                        r0 + rank * slice, hp);
        }
      }
    q += n;
  }
  sm90::cluster_sync();  // the consumers' last step
}

// Prefetch warp: while step s's products run, bring its xw rows of this
// tile into L2.
template <int P>
__device__ void tf_fwd_prefetcher(const TfFwdArgs& a) {
  const int H = a.H, u0 = blockIdx.x * P * kTfFwdUnits;
  const int r0 = blockIdx.y * kTfFwdRows;
  const int units = min(P * kTfFwdUnits, H - u0);
  for (int s = 0; s < a.T; ++s) {
    if (s > 0) sm90::cluster_sync();
    if (units <= 0) continue;
    const int t = a.reverse ? a.T - 1 - s : s;
    for (int i = threadIdx.x % 32; i < kTfFwdRows * 4; i += 32) {
      const int r = r0 + i / 4, q = i % 4;
      if (r >= a.B) continue;
      const char* b = reinterpret_cast<const char*>(
          a.xw + ((long long)t * a.B + r) * 4 * H + q * H + u0);
      for (int off = 0; off < 4 * units; off += 128) sm90::prefetch_l2(b + off);
      sm90::prefetch_l2(b + 4 * units - 1);
    }
  }
  sm90::cluster_sync();
}

// Consumer warpgroup wg: the tile's 64 rows and the block's units 32 P wg
// .. 32 P wg + 32 P - 1, in P passes of 32 units a step (each a product,
// then its cell phase). A pass's product has column 32 q + j for gate q
// of its unit j (RW's arrangement per 32-unit group); the cell phase reads
// it back by rows from shared memory: from the warpgroup's RW tile of the
// pass's last ring stage (rows 0-31), which it holds until then, and from
// ws (rows 32-63), so that the other stages take the next chunks.
template <int P, bool MASKED, bool STASH>
__device__ void tf_fwd_consumer(TfFwdSmem& sm, const TfFwdArgs& a,
                                int nch) {
  constexpr int S = kTfFwdStages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int l = tid % 32, g = l / 4, tq = l % 4, w = (tid % 128) / 32;
  const int H = a.H, B = a.B, C = a.cluster;
  const int u0 = blockIdx.x * P * kTfFwdUnits, r0 = blockIdx.y * kTfFwdRows;
  const int wt = tid % 128;
  // thread 8k of a warpgroup releases a stage to block k of the cluster
  const bool releases = wt % 8 == 0 && wt / 8 < C;
  float fresh[64], z[64];
  uint32_t q = 0;  // chunks consumed before this pass
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    float* hnext = a.hbuf + 2 * ((s + 1) & 1) * a.plane;  // big; small next
    for (int p = 0; p < P; ++p) {
      // ---- product: z = h[t-1][rows, :] . RWp[the pass's 128 rows, :]^T
#pragma unroll
      for (int i = 0; i < 64; ++i) z[i] = 0.f;
      for (int c = 0; c < nch; ++c, ++q) {
        const uint32_t st = q % S;
        sm90::mbar_wait(&sm.full[st], (q / S) & 1);
        named_sync(2 + wg, 128);  // every warp is done with ws
        split_tile<4 * 32 * kTfK, 128>(sm.w[st][wg], sm.ws[wg], wt);
        named_sync(2 + wg, 128);  // the warpgroup's RW tile is split
        tf_chunk(fresh, sm.a[st][0], sm.a[st][1], sm.w[st][wg], sm.ws[wg]);
        if (c + 1 < nch)  // the pass's last stage is released after its cells
          sm90::mbar_arrive_cluster(&sm.empty[st], wt / 8, releases);
        add_chunk(z, fresh);
      }
      // ---- the product to shared memory (warps 0, 1: the last stage's RW
      // tile of this warpgroup; warps 2, 3: ws)
      const uint32_t held = (q - 1) % S;
      float* zt = w < 2 ? sm.w[held][wg] : sm.ws[wg];
      acc_to_tile(zt, z, 16 * (w & 1), g, tq);
      __syncwarp();
      // ---- cell phase: lane l takes unit u0 + 32 (P wg + p) + l of the
      // warp's 16 rows (a warp's loads and stores are 128 contiguous
      // bytes); 4 rows' loads (xw, the carries) are issued together before
      // their gate chains
      const int ul = 32 * (P * wg + p) + l, u = u0 + ul;
      if (u < H) {
        const float pI = sm.peep[0][ul], pF = sm.peep[1][ul],
                    pO = sm.peep[2][ul];
#pragma unroll 1
        for (int i0 = 0; i0 < 16; i0 += 4) {
          float xv[4][4], cv[4], hv[4], mv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r0 + 16 * w + i0 + i;
            if (r >= B) continue;
            const long long row = (long long)t * B + r;
            const float* x = a.xw + row * 4 * H + u;
#pragma unroll
            for (int g4 = 0; g4 < 4; ++g4) xv[i][g4] = x[g4 * H];
            cv[i] = a.cT[(long long)r * H + u];  // the c carry (c0 at first)
            if (MASKED) {
              hv[i] = a.hT[(long long)r * H + u];  // the h carry (h0 at first)
              mv[i] = a.mask[row];
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rl = 16 * (w & 1) + i0 + i, r = r0 + 16 * w + i0 + i;
            if (r >= B) continue;
            const long long row = (long long)t * B + r;
            auto zq = [&](int q4) { return zt[tile_at(rl, 32 * q4 + l)]; };
            const float cp = cv[i];
            const float ig = sigm_fast(zq(0) + xv[i][0] + pI * cp);
            const float fg = sigm_fast(zq(1) + xv[i][1] + pF * cp);
            const float gg = tanh_fast(zq(3) + xv[i][3]);
            const float cn = fg * cp + ig * gg;
            const float og = sigm_fast(zq(2) + xv[i][2] + pO * cn);
            const float hn = og * tanh_fast(cn);
            float hs = hn, cs = cn, out = hn;
            const long long cu = (long long)r * H + u;
            if constexpr (MASKED) {
              hs = mv[i] > 0.f ? hn : hv[i];
              cs = mv[i] > 0.f ? cn : cp;
              out = hs * mv[i];
              a.hT[cu] = hs;
            }
            const long long o = row * H + u;
            a.h_out[o] = out;
            if constexpr (STASH) {
              a.c_stash[o] = cs;
              if constexpr (MASKED) a.hsel[o] = hs;
              float* gt = a.gates + row * 4 * H + u;
              gt[0] = ig, gt[H] = fg, gt[2 * H] = og, gt[3 * H] = gg;
            }
            a.cT[cu] = cs;
            st_split(hnext, a.plane, (long long)r * a.ldh + u, hs);  // h_t
          }
        }
      }
      // the held stage goes back to the producer once every warp is done
      // with it (its TMA writes follow these generic accesses)
      sm90::fence_proxy_async();
      named_sync(2 + wg, 128);
      sm90::mbar_arrive_cluster(&sm.empty[held], wt / 8, releases);
    }
    sm90::cluster_sync();  // h_t is stored (and fenced for TMA) by all
  }
}

template <int P, bool MASKED, bool STASH>
__global__ void __launch_bounds__(kClusterThreads, 1)
    lstm_fwd_tf32_kernel(const __grid_constant__ TfFwdMaps maps,
                         const TfFwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  TfFwdSmem& sm = *reinterpret_cast<TfFwdSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nch = (a.H + kTfK - 1) / kTfK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTfFwdStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      // one arrival per consumer warpgroup of every block of the cluster
      sm90::mbar_init(&sm.empty[s], 2 * a.cluster);
    }
    sm90::mbar_fence_init();
  }
  constexpr int U = P * kTfFwdUnits;
  const int u0 = blockIdx.x * U;
  for (int i = threadIdx.x; i < 3 * U; i += kClusterThreads) {
    const int k = i / U, u = u0 + i % U;
    sm.peep[k][i % U] = u < a.H ? a.peep[k * a.H + u] : 0.f;
  }
  __syncthreads();
  // every block's barriers are initialised before any multicast or remote
  // arrival reaches them
  sm90::cluster_sync();
  if (threadIdx.x < kConsumers)
    tf_fwd_consumer<P, MASKED, STASH>(sm, a, nch);
  else if (threadIdx.x < kConsumers + 32)
    tf_fwd_producer<P>(sm, a, maps, nch);
  else
    tf_fwd_prefetcher<P>(a);
  sm90::cluster_sync();  // no block leaves while others may reach it
}

// ----------------------------------------------------------- backward
// A stage: the dz[t] rows of the tile and the block's RW rows, each in
// their two TF32 planes (TMA; dz multicast). Between products the A
// planes hold the product's result (the dh carry) as a row-major tile, so
// that the cell phase runs with its registers free and reads it by rows.
struct TfBwdSmem {
  float a[kTfBwdStages][2][kTfBwdRows * kTfK];  // dz[t] rows: big, small
  float w[kTfBwdStages][2][kTfBwdUnits * kTfK];  // RW rows: big, small
  float peep[3][kTfBwdUnits];
  uint64_t full[kTfBwdStages], empty[kTfBwdStages];
};
static_assert(sizeof(TfBwdSmem::a) >= sizeof(float) * kTfBwdRows * 128,
              "the dh carry fits the A planes");
constexpr uint32_t kTfBwdStageBytes =
    sizeof(float) * kTfK * 2 * (kTfBwdRows + kTfBwdUnits);
constexpr size_t kTfBwdSmemBytes = sizeof(TfBwdSmem) + 1024;  // + align

struct TfBwdArgs {
  const float *gates, *c, *dh_out, *dhT, *mask, *peep, *c0;
  float *dz, *dzbuf, *dhc0;
  int T, B, H, reverse, cluster;
};

// backward step s undoes forward step T-1-s
struct TfStep {
  int t, t_prev;
  bool first;  // forward step 0: c_prev is c0, dh0 is written
  __device__ TfStep(const TfBwdArgs& a, int s)
      : t(a.reverse ? s : a.T - 1 - s),
        t_prev(a.reverse ? s + 1 : a.T - 2 - s),
        first(s == a.T - 1) {}
};

// Producer warp, per step: the RW chunks of the first ring stages (during
// the cell phase), then after the cluster barrier this block's slice of
// the dz[t] rows of every chunk (both planes, multicast to the cluster)
// and the remaining RW chunks.
__device__ void tf_bwd_producer(TfBwdSmem& sm, const TfBwdArgs& a,
                                const CUtensorMap* tdz,
                                const CUtensorMap* trw, int nch) {
  constexpr int S = kTfBwdStages;
  const bool leader = threadIdx.x % 32 == 0;
  const int C = a.cluster, u0 = blockIdx.x * kTfBwdUnits;
  const int r0 = blockIdx.y * kTfBwdRows;
  const uint32_t rank = sm90::cluster_rank();
  const int slice = kTfBwdRows / C;
  const uint16_t mask = (uint16_t)((1u << C) - 1);
  const int ahead = nch < S ? nch : S;
  auto issue_w = [&](uint32_t q, int c) {
    const uint32_t st = q % S;
    sm90::mbar_wait_cluster(&sm.empty[st], ((q / S) & 1) ^ 1);
    sm90::mbar_expect_tx(&sm.full[st], kTfBwdStageBytes);
    for (int pl = 0; pl < 2; ++pl)
      sm90::tma_load_3d(sm.w[st][pl], trw, &sm.full[st], c * kTfK, u0, pl);
  };
  uint32_t q = 0;  // chunks issued before this step
  for (int s = 0; s < a.T; ++s) {
    if (leader)
      for (int c = 0; c < ahead; ++c) issue_w(q + c, c);
    sm90::cluster_sync();  // dz[t] of the row tile stored by every block
    if (leader)
      for (int c = 0; c < nch; ++c) {
        const uint32_t st = (q + c) % S;
        if (c >= ahead) issue_w(q + c, c);
        for (int pl = 0; pl < 2; ++pl) {
          float* dst = sm.a[st][pl] + rank * slice * kTfK;
          if (C == 1)
            sm90::tma_load_3d(dst, tdz, &sm.full[st], c * kTfK, r0, pl);
          else
            sm90::tma_load_3d_multicast(dst, tdz, &sm.full[st], mask,
                                        c * kTfK, r0 + rank * slice, pl);
        }
      }
    q += nch;
  }
}

// Prefetch warp: while step s's product runs, bring step s + 1's stash
// rows of this tile into L2.
__device__ void tf_bwd_prefetcher(const TfBwdArgs& a) {
  const int H = a.H, u0 = blockIdx.x * kTfBwdUnits;
  const int r0 = blockIdx.y * kTfBwdRows;
  const int units = min(kTfBwdUnits, H - u0);
  const long long G = 4LL * H;
  for (int s = 0; s < a.T; ++s) {
    sm90::cluster_sync();
    if (s + 1 >= a.T || units <= 0) continue;
    const TfStep sp(a, s + 1);
    for (int i = threadIdx.x % 32; i < kTfBwdRows * 7; i += 32) {
      const int r = r0 + i / 7, seg = i % 7;
      if (r >= a.B) continue;
      const long long row = (long long)sp.t * a.B + r;
      const float* p;
      if (seg < 4) p = a.gates + row * G + seg * H + u0;
      else if (seg == 4) p = a.dh_out + row * H + u0;
      else if (seg == 5) p = a.c + row * H + u0;
      else if (sp.first) p = a.c0 + (long long)r * H + u0;
      else p = a.c + ((long long)sp.t_prev * a.B + r) * H + u0;
      const char* b = reinterpret_cast<const char*>(p);
      for (int off = 0; off < 4 * units; off += 128) sm90::prefetch_l2(b + off);
      sm90::prefetch_l2(b + 4 * units - 1);
    }
  }
}

// Consumer warpgroup wg: the product of rows 64 wg .. 64 wg + 63 of the
// tile and the block's 128 units, in the wgmma accumulator's layout
// (`dh`, the running sum). Between products the dh carry waits in the A
// planes as a row-major tile (dht, tile_at): going into a step's cell
// phase it holds the previous product plus the masked select's bypass (at
// the first step dhT, masked, or 0), and the cell phase leaves the next
// bypass there (0 unmasked), which the next product starts from. In the
// cell phase warp W (of the 8) takes the tile's rows 16W .. 16W + 15 (the
// rows its accumulator holds), lane l the units l + 32k: a warp's loads
// and stores are 128 contiguous bytes.
template <bool MASKED>
__device__ void tf_bwd_consumer(TfBwdSmem& sm, const TfBwdArgs& a,
                                int nch) {
  constexpr int S = kTfBwdStages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int l = tid % 32, g = l / 4, tq = l % 4, w = (tid % 128) / 32;
  const int H = a.H, B = a.B, C = a.cluster;
  const long long G = 4LL * H, BH = (long long)B * H;
  const int u0 = blockIdx.x * kTfBwdUnits, r0 = blockIdx.y * kTfBwdRows;
  const int wt = tid % 128;
  // thread 8k of a warpgroup releases a stage to block k of the cluster
  const bool releases = wt % 8 == 0 && wt / 8 < C;
  float* dht = &sm.a[0][0][0];      // 128 rows x 128 units
  float* dhw = dht + wg * 64 * 128;  // the warpgroup's 64 rows
  const int rw0 = 16 * (tid / 32);   // the warp's first row of the tile
  for (int i = 0; i < 16; ++i)
    for (int k = 0; k < 4; ++k) {
      const int r = r0 + rw0 + i, u = u0 + l + 32 * k;
      dht[tile_at(rw0 + i, l + 32 * k)] =
          MASKED && r < B && u < H ? a.dhT[(long long)r * H + u] : 0.f;
    }
  __syncwarp();
  float fresh[64], dh[64];
  const int a_off = wg * 64 * kTfK;  // the warpgroup's rows of an A tile
  const long long zp = (long long)B * G;  // one plane of dzbuf
  uint32_t q = 0;  // chunks consumed before this step
  for (int s = 0; s < a.T; ++s) {
    const TfStep sp(a, s);
    // ---- cell phase: dz[t] of the warp's rows, a row's 4 cells at a time
    // (their loads issued together first)
#pragma unroll 1
    for (int i = 0; i < 16; ++i) {
      const int rl = rw0 + i, r = r0 + rl;
      if (r >= B) break;
      const long long row = (long long)sp.t * B + r;
      const float m = MASKED ? a.mask[row] : 1.f;
      float gv[4][4], cpv[4], dhov[4], ctv[4], dcv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int u = u0 + l + 32 * k;
        if (u >= H) continue;
        const float* gt = a.gates + row * G + u;
#pragma unroll
        for (int g4 = 0; g4 < 4; ++g4) gv[k][g4] = gt[g4 * H];
        cpv[k] = sp.first ? a.c0[(long long)r * H + u]
                          : a.c[((long long)sp.t_prev * B + r) * H + u];
        dhov[k] = a.dh_out[row * H + u];
        if (!MASKED) ctv[k] = a.c[row * H + u];
        dcv[k] = a.dhc0[BH + (long long)r * H + u];  // the dc carry
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ul = l + 32 * k, u = u0 + ul;
        if (u >= H) continue;
        float* dhc = dht + tile_at(rl, ul);
        const float ig = gv[k][0], fg = gv[k][1], og = gv[k][2], gg = gv[k][3];
        const float c_prev = cpv[k], dho = dhov[k], dcc = dcv[k];
        float dhn, dcn, c_t, byp_h = 0.f, byp_c = 0.f;
        if constexpr (MASKED) {
          const float d_hsel = m * dho + *dhc;
          dhn = m > 0.f ? d_hsel : 0.f;
          byp_h = m > 0.f ? 0.f : d_hsel;
          dcn = m > 0.f ? dcc : 0.f;
          byp_c = m > 0.f ? 0.f : dcc;
          c_t = fg * c_prev + ig * gg;  // the candidate: the stash has c_sel
        } else {
          dhn = dho + *dhc;
          dcn = dcc;
          c_t = ctv[k];
        }
        const float tc = tanh_fast(c_t);
        const float dzo = dhn * tc * og * (1.f - og);
        const float dct =
            dhn * og * (1.f - tc * tc) + dcn + dzo * sm.peep[2][ul];
        const float dzg = dct * ig * (1.f - gg * gg);
        const float dzi = dct * gg * ig * (1.f - ig);
        const float dzf = dct * c_prev * fg * (1.f - fg);
        a.dhc0[BH + (long long)r * H + u] =
            dct * fg + dzi * sm.peep[0][ul] + dzf * sm.peep[1][ul] + byp_c;
        *dhc = byp_h;  // the product adds dz . RW^T to it
        float* d = a.dz + row * G + u;
        d[0] = dzi, d[H] = dzf, d[2 * H] = dzo, d[3 * H] = dzg;
        // dz[t]'s two TF32 parts: the product's A operand
        const long long zi = (long long)r * G + u;
        st_split(a.dzbuf, zp, zi, dzi);
        st_split(a.dzbuf, zp, zi + H, dzf);
        st_split(a.dzbuf, zp, zi + 2 * H, dzo);
        st_split(a.dzbuf, zp, zi + 3 * H, dzg);
      }
    }
    __syncwarp();
    tile_to_acc(dh, dhw, 16 * w, g, tq);
    sm90::fence_proxy_async();  // dz[t] is read back by TMA
    sm90::cluster_sync();
    // ---- product: dh += dz[t][rows, :] . RW[units, :]^T
    for (int c = 0; c < nch; ++c, ++q) {
      const uint32_t st = q % S;
      sm90::mbar_wait(&sm.full[st], (q / S) & 1);
      tf_chunk(fresh, sm.a[st][0] + a_off, sm.a[st][1] + a_off, sm.w[st][0],
               sm.w[st][1]);
      sm90::mbar_arrive_cluster(&sm.empty[st], wt / 8, releases);
      add_chunk(dh, fresh);
    }
    if (sp.first) {  // dh0 = this product + the bypass, in f32
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int r = r0 + 64 * wg + 16 * w + g + 8 * ((e >> 1) & 1);
        const int u = u0 + 8 * (e >> 2) + 2 * tq + (e & 1);
        if (r < B && u < H) a.dhc0[(long long)r * H + u] = dh[e];
      }
    }
    // both warpgroups' products are done with the A planes: stage dh
    named_sync(1, kConsumers);
    acc_to_tile(dhw, dh, 16 * w, g, tq);
    __syncwarp();
  }
}

template <bool MASKED>
__global__ void __launch_bounds__(kClusterThreads, 1)
    lstm_bwd_tf32_kernel(const __grid_constant__ CUtensorMap tdz,
                         const __grid_constant__ CUtensorMap trw,
                         const TfBwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  TfBwdSmem& sm = *reinterpret_cast<TfBwdSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nch = (4 * a.H + kTfK - 1) / kTfK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTfBwdStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      // one arrival per consumer warpgroup of every block of the cluster
      sm90::mbar_init(&sm.empty[s], 2 * a.cluster);
    }
    sm90::mbar_fence_init();
  }
  const int u0 = blockIdx.x * kTfBwdUnits;
  for (int i = threadIdx.x; i < 3 * kTfBwdUnits; i += kClusterThreads) {
    const int k = i / kTfBwdUnits, u = u0 + i % kTfBwdUnits;
    sm.peep[k][i % kTfBwdUnits] = u < a.H ? a.peep[k * a.H + u] : 0.f;
  }
  __syncthreads();
  sm90::cluster_sync();
  if (threadIdx.x < kConsumers)
    tf_bwd_consumer<MASKED>(sm, a, nch);
  else if (threadIdx.x < kConsumers + 32)
    tf_bwd_producer(sm, a, &tdz, &trw, nch);
  else
    tf_bwd_prefetcher(a);
  sm90::cluster_sync();  // no block leaves while others may reach it
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

// ========================================= bf16 forward, small batches
// The bf16 forward at B <= kCoopMaxB rows and H <= 1024 (lstm_fwd_kernel,
// one cooperative launch): a row tile there would stream all of RW
// through L2 every step (the cluster forward above), while RW fits the
// card's shared memory once: 8 MB at H = 1024 over 128 blocks of 64 KB.
// So every block keeps its slice of RW on chip for the whole launch, all
// blocks hold the same (at most 128) rows, and each step's h[t-1] goes to
// every block. A block owns 8 hidden units (32 gate columns); the grid is
// ceil(H / 8) blocks, padded to a whole number of clusters of C blocks (C
// the largest of 8, 4, 2, 1 whose grid is co-resident: 2 at H = 1024,
// where 4- and 8-block clusters place only 120 blocks at once). Each
// step:
//  1. a producer warp waits until every block has published h[t-1] (a
//     counter in global memory that each block raises once a step:
//     flag_arrive / flag_wait; a spin wait is sound only because a
//     cooperative launch makes every block resident, and a grid that
//     does not fit is refused at launch), then loads h[t-1] in 64-wide k
//     chunks (all rows of the chunk, 16 KB at 128 rows) through TMA into
//     a ring of shared-memory stages; block `rank` of a cluster loads the
//     chunks c with c % C == rank and multicasts them to the cluster, so
//     the cluster reads h once from L2. A stage is refilled once every
//     consumer warpgroup of every block of the cluster released it;
//  2. two consumer warpgroups compute z = h[t-1] . RW[:, the block's 32
//     columns] on wgmma m64n32k16 (bf16 in, f32 accumulate): above 64
//     rows, warpgroup wg the rows 64 wg .. 64 wg + 63 over all of K; at
//     64 rows or fewer both hold the same rows and split K (warpgroup wg
//     the chunks c with c % 2 == wg), then hand each other half of their
//     partial sums through shared memory, and each finishes half of the
//     rows as (partial of warpgroup 0 + partial of warpgroup 1) + xw: one
//     order for every row, so rows with equal inputs give equal bits;
//  3. the gate chain runs on the accumulator, whose layout gives a thread
//     all four gates of its cells (RW arranged by the wrapper per 8-unit
//     group, `_rw_by_unit_group(rw, 8, 8)`: column 8 q + j of a block is
//     gate q of its unit j); xw[t] arrived by TMA two steps ahead (double
//     buffered); the c carry (and, masked, the h carry) stays in f32
//     registers for the whole launch; h_t is stored to the ping-pong
//     buffer, fenced for the async proxy, and the block arrives on the
//     counter; only then the stash (h_out, c, gates, h_sel) is stored,
//     while the next step's h[t-1] is on its way.
// The wrapper pads H to a multiple of 8 (TMA boxes of 16 bytes).
constexpr int kCoopUnits = 8;      // hidden units of a block
constexpr int kCoopRows = 128;     // batch rows at most: one row split
constexpr int kCoopStages = 8;     // ring of h[t-1] chunks
constexpr int kCoopMaxH = 1024;    // the RW slice's 16 chunks of 64 k
constexpr int kCoopThreads = kConsumers + 32;  // + a producer warp
constexpr uint32_t kCoopRwBox = 4 * kCoopUnits * kChunk * 2;  // 4 KB

struct CoopSmem {
  bf16 a[kCoopStages][kCoopRows * kChunk];  // h[t-1] chunk rows, swizzled
  bf16 rw[kCoopMaxH / kChunk][4 * kCoopUnits * kChunk];  // RW slice, swizzled
  bf16 x[2][4][kCoopRows * kCoopUnits];  // xw[t]: per gate, rows x 8 units
  float xchg[2][8][128];  // B <= 64: warpgroup wg's partials of the other's rows
  uint64_t full[kCoopStages], empty[kCoopStages], x_full[2], rw_full;
};
constexpr size_t kCoopSmemBytes = sizeof(CoopSmem) + 1024;  // + align

struct CoopArgs {
  const bf16 *xw, *peep, *c0, *mask;
  bf16 *hbuf, *h_out, *hT, *cT, *hsel, *c_stash, *gates;
  unsigned* sync;
  long long plane;
  int T, B, H, ldh, reverse, cluster;
  int rows;   // rows of a TMA box: B rounded up to 8
  int split;  // B <= 64: the warpgroups split K
};

// h loads from hbuf (ldh, Bp, 2) in boxes of 64 columns x `rows`, 128-byte
// swizzle; RW arranged per 8-unit group (Hk, 4 Hu) in boxes of 64 columns
// x 32 rows, swizzled; xw (H, 4, B, T) in boxes of 8 units x `rows`, no
// swizzle
struct CoopMaps {
  CUtensorMap h, w, xw;
};

// xw[t] of step s's block units, one box per gate, into buffer s % 2
__device__ __forceinline__ void coop_load_x(CoopSmem& sm, const CoopArgs& a,
                                            const CoopMaps& m, int s) {
  const int t = a.reverse ? a.T - 1 - s : s, b = s & 1;
  sm90::mbar_expect_tx(&sm.x_full[b], 4 * a.rows * kCoopUnits * 2);
  for (int q = 0; q < 4; ++q)
    sm90::tma_load_4d(sm.x[b][q], &m.xw, &sm.x_full[b],
                      blockIdx.x * kCoopUnits, q, 0, t);
}

// Producer warp: per step, every chunk's stage is armed in order (its
// previous use released by the cluster, its bytes expected); before the
// first chunk this block loads, the wait for every block's h[t-1].
__device__ void coop_producer(CoopSmem& sm, const CoopArgs& a,
                              const CoopMaps& m, int nch) {
  constexpr int S = kCoopStages;
  if (threadIdx.x % 32 != 0) return;
  const int C = a.cluster;
  const int rank = (int)sm90::cluster_rank();
  const uint16_t mask = (uint16_t)((1u << C) - 1);
  const uint32_t abytes = a.rows * kChunk * 2;
  uint32_t q = 0;  // chunks armed before this one
  for (int s = 0; s < a.T; ++s) {
    bool published = s == 0;  // h0 is in hbuf before the launch
    for (int c = 0; c < nch; ++c, ++q) {
      const uint32_t st = q % S;
      sm90::mbar_wait_cluster(&sm.empty[st], ((q / S) & 1) ^ 1);
      sm90::mbar_expect_tx(&sm.full[st], abytes);
      if (c % C != rank) continue;
      if (!published) {  // every block arrived once for each earlier step
        sm90::flag_wait(a.sync, gridDim.x * (unsigned)s);
        published = true;
      }
      if (C == 1)
        sm90::tma_load_3d(sm.a[st], &m.h, &sm.full[st], c * kChunk, 0, s & 1);
      else
        sm90::tma_load_3d_multicast(sm.a[st], &m.h, &sm.full[st], mask,
                                    c * kChunk, 0, s & 1);
    }
  }
}

// Consumer warpgroup wg. Thread (warp w, lane 4g + tq) holds the
// accumulator's rows rb + 8 rr (rb = 64 wg + 16 w + g above 64 rows, 16 w
// + g at 64 or fewer) and the block's units 2 tq, 2 tq + 1 (e = 0, 1): gate
// q of cell (rr, e) is acc[4 q + 2 rr + e]. It finishes the cells of both
// rr above 64 rows, of rr = wg at 64 or fewer.
template <bool MASKED, bool STASH>
__device__ void coop_consumer(CoopSmem& sm, const CoopArgs& a,
                              const CoopMaps& m, int nch) {
  constexpr int S = kCoopStages;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int l = tid % 32, g = l / 4, tq = l % 4, w = wt / 32;
  const int H = a.H, B = a.B, C = a.cluster;
  const bool split = a.split;
  const int u = blockIdx.x * kCoopUnits + 2 * tq;  // units u, u + 1
  const bool live = u < H;  // H is a multiple of 8: u + 1 < H too
  const int rb = (split ? 0 : 64 * wg) + 16 * w + g;
  // does the thread finish the cells of rows rb + 8 rr?
  auto mine = [&](int rr) { return !split || rr == wg; };
  // thread 8k of a warpgroup releases a stage to block k of the cluster
  const bool releases = wt % 8 == 0 && wt / 8 < C;
  float pI[2] = {}, pF[2] = {}, pO[2] = {}, cc[2][2] = {}, hh[2][2] = {};
  if (live) {
    const float2 p0 = ld_pair(a.peep + u), p1 = ld_pair(a.peep + H + u),
                 p2 = ld_pair(a.peep + 2 * H + u);
    pI[0] = p0.x, pI[1] = p0.y, pF[0] = p1.x, pF[1] = p1.y;
    pO[0] = p2.x, pO[1] = p2.y;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rb + 8 * rr;
      if (!mine(rr) || r >= B) continue;
      const float2 c2 = ld_pair(a.c0 + (long long)r * H + u);
      cc[rr][0] = c2.x, cc[rr][1] = c2.y;
      if (MASKED) {  // h0, in hbuf's first plane
        const float2 h2 = ld_pair(a.hbuf + (long long)r * a.ldh + u);
        hh[rr][0] = h2.x, hh[rr][1] = h2.y;
      }
    }
  }
  const char* a_base = reinterpret_cast<const char*>(sm.a[0]) +
                       (split ? 0 : wg * 64 * kChunk * 2);
  const char* w_base = reinterpret_cast<const char*>(sm.rw[0]);
  const int cfirst = split ? wg : 0, cstep = split ? 2 : 1;
  sm90::mbar_wait(&sm.rw_full, 0);
  // one accumulator per 16-wide k step of a chunk: four independent wgmma
  // chains (one chain on one accumulator waits for each product in turn)
  float acc[4][16];
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const bool last = s == a.T - 1;
    float mv[2] = {1.f, 1.f};  // the mask of the thread's rows
    if (MASKED)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = rb + 8 * rr;
        if (mine(rr) && r < B)
          mv[rr] = __bfloat162float(a.mask[(long long)t * B + r]);
      }
    // ---- product: acc = h[t-1][rows, the warpgroup's chunks] . RW^T
    int n = 0;
    uint32_t held = 0;  // the stage of the warpgroup's previous chunk
    for (int c = cfirst; c < nch; c += cstep) {
      const uint32_t q = (uint32_t)s * nch + c, st = q % S;
      sm90::mbar_wait(&sm.full[st], (q / S) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::wgmma_m64n32_ss(
            acc[kk],
            sm90::desc_sw128(a_base + st * sizeof(sm.a[0]) + kk * 32),
            sm90::desc_sw128(w_base + c * sizeof(sm.rw[0]) + kk * 32),
            n > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous chunk's products are done
      sm90::mbar_arrive_cluster(&sm.empty[held], wt / 8, n > 0 && releases);
      held = st;
      ++n;
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(acc[kk]);
    // the four chains added in one order, at once (summed later, with
    // every accumulator live through the cell phase, the kernel measured
    // slower on an H100)
    float sum[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      sum[i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
    sm90::mbar_arrive_cluster(&sm.empty[held], wt / 8, n > 0 && releases);
    // the warpgroup's partial of accumulator element i (split K with one
    // chunk: warpgroup 1 has none)
    auto part = [&](int i) { return n > 0 ? sum[i] : 0.f; };
    float peer[8] = {};  // split K: the other warpgroup's partials
    if (split) {
#pragma unroll
      for (int i = 0; i < 8; ++i)  // the rows rb + 8 (1 - wg)
        sm.xchg[wg][i][wt] = part(4 * (i / 2) + (wg ? 0 : 2) + i % 2);
      sm90::named_bar_sync(1, kConsumers);
#pragma unroll
      for (int i = 0; i < 8; ++i) peer[i] = sm.xchg[1 - wg][i][wt];
    }
    // ---- cell phase: the gate chain of the thread's cells
    sm90::mbar_wait(&sm.x_full[s & 1], (s >> 1) & 1);
    const bf16(*xt)[kCoopRows * kCoopUnits] = sm.x[s & 1];
    float ov[2][2], hv[2][2], cv[2][2], gv[2][4][2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (!mine(rr)) continue;
      const int r = rb + 8 * rr;
      float2 xq[4];
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4)
        xq[q4] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            &xt[q4][r * kCoopUnits + 2 * tq]));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // gate q's pre-activation: the product, then + xw; split K adds
        // the two warpgroups' partials first (the same bits in either
        // order), xw last
        auto z = [&](int q4) {
          const float p = part(4 * q4 + 2 * rr + e);
          const float zp = split ? p + peer[2 * q4 + e] : p;
          return zp + (e ? xq[q4].y : xq[q4].x);
        };
        const float cp = cc[rr][e];
        const float ig = sigm_fast(z(0) + pI[e] * cp);
        const float fg = sigm_fast(z(1) + pF[e] * cp);
        const float gg = tanh_fast(z(3));
        const float cn = fg * cp + ig * gg;
        const float og = sigm_fast(z(2) + pO[e] * cn);
        const float hn = og * tanh_fast(cn);
        float hs = hn, cs = cn, out = hn;
        if (MASKED) {
          hs = mv[rr] > 0.f ? hn : hh[rr][e];
          cs = mv[rr] > 0.f ? cn : cp;
          out = hs * mv[rr];
        }
        cc[rr][e] = cs, hh[rr][e] = hs;
        ov[rr][e] = out, hv[rr][e] = hs, cv[rr][e] = cs;
        gv[rr][0][e] = ig, gv[rr][1][e] = fg, gv[rr][2][e] = og;
        gv[rr][3][e] = gg;
      }
      if (r < B && live)  // h_t, the next step's operand
        st_pair(a.hbuf + ((s + 1) & 1) * a.plane + (long long)r * a.ldh + u,
                hv[rr][0], hv[rr][1]);
    }
    // ---- h_t published: fenced for the TMA loads that read it, then the
    // block arrives once on the step counter
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1, kConsumers);
    if (tid == 0) {
      sm90::flag_arrive(a.sync);
      if (s + 2 < a.T) coop_load_x(sm, a, m, s + 2);  // x[s % 2] is read
    }
    // ---- the stash and the outputs, while the next h[t-1] is on its way
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rb + 8 * rr;
      if (!mine(rr) || r >= B || !live) continue;
      const long long row = (long long)t * B + r, o = row * H + u;
      st_pair(a.h_out + o, ov[rr][0], ov[rr][1]);
      if (STASH) {
        st_pair(a.c_stash + o, cv[rr][0], cv[rr][1]);
        if (MASKED) st_pair(a.hsel + o, hv[rr][0], hv[rr][1]);
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4)
          st_pair(a.gates + row * 4 * H + q4 * H + u, gv[rr][q4][0],
                  gv[rr][q4][1]);
      }
      if (last) {
        st_pair(a.cT + (long long)r * H + u, cv[rr][0], cv[rr][1]);
        if (MASKED) st_pair(a.hT + (long long)r * H + u, hv[rr][0], hv[rr][1]);
      }
    }
  }
}

template <bool MASKED, bool STASH>
__global__ void __launch_bounds__(kCoopThreads, 1)
    lstm_fwd_kernel(const __grid_constant__ CoopMaps maps, const CoopArgs a) {
  extern __shared__ unsigned char smem_raw[];
  CoopSmem& sm = *reinterpret_cast<CoopSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nch = (a.H + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kCoopStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      // one arrival per consuming warpgroup of every block of the cluster
      sm90::mbar_init(&sm.empty[s], (a.split ? 1 : 2) * a.cluster);
    }
    sm90::mbar_init(&sm.x_full[0], 1);
    sm90::mbar_init(&sm.x_full[1], 1);
    sm90::mbar_init(&sm.rw_full, 1);
    sm90::mbar_fence_init();
    // the block's slice of RW for the whole launch, and the first two
    // steps' xw tiles
    sm90::mbar_expect_tx(&sm.rw_full, nch * kCoopRwBox);
    for (int c = 0; c < nch; ++c)
      sm90::tma_load_2d(sm.rw[c], &maps.w, &sm.rw_full, c * kChunk,
                        blockIdx.x * 4 * kCoopUnits);
    coop_load_x(sm, a, maps, 0);
    if (a.T > 1) coop_load_x(sm, a, maps, 1);
  }
  __syncthreads();
  // every block's barriers are initialised before any multicast or remote
  // arrival reaches them
  sm90::cluster_sync();
  if (threadIdx.x < kConsumers)
    coop_consumer<MASKED, STASH>(sm, a, maps, nch);
  else
    coop_producer(sm, a, maps, nch);
  sm90::cluster_sync();  // no block leaves while others may reach it
}

// ------------------------------------------------------------------ host
// Routes: the cooperative bf16 forward (small batches), the bf16 cluster
// forward, the split-TF32 cluster kernels (f32, both passes) and the bf16
// cluster backward.
enum Route { kCoop = 0, kFwdCluster = 1, kTf32 = 2, kBwdCluster = 3 };
// The bf16 forward takes the cooperative kernel up to this many batch
// rows at H <= 1024 (all of them in one row split, kCoopRows): the
// cluster kernel's step costs about the same from 1 to 128 rows a cluster
// (it streams all of RW through L2 every step), while the cooperative
// blocks keep their slices of RW on chip. Measured on an H100 at H =
// 1024, T = 64 (chip_smoke.py phase 17, PERF.md): the cooperative kernel
// wins at 128 rows.
constexpr int kCoopMaxB = 128;
static_assert(kCoopMaxB <= kCoopRows, "one row split holds every row");

int route_of(int kind, int dtype, int B, int H) {
  if (dtype == 0) return kTf32;
  if (kind == 1) return kBwdCluster;
  return B <= kCoopMaxB && H <= 1024 ? kCoop : kFwdCluster;
}

// A launch plan, as dl4j_lstm_plan reports it.
struct Plan {
  int route, gx, gy, rows, active, cluster, units;
  size_t smem;
};

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

// The cooperative forward: ceil(H / 8) blocks of 8 units, padded to a
// whole number of clusters of C, C the largest of 8, 4, 2, 1 for which
// the whole grid is co-resident; `active` blocks fit at once. When none
// fits (C = 1), the plan keeps it and the launch is refused.
int coop_plan(const void* kern, int B, int H, Plan* p) {
  const int gu = (H + kCoopUnits - 1) / kCoopUnits;
  const int rows = ceil_to(B < kCoopRows ? B : kCoopRows, 8);
  *p = Plan{kCoop, gu, 1, rows, 0, 1, kCoopUnits, kCoopSmemBytes};
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
  if (e != cudaSuccess) return (int)e;
  for (int C = 8; C >= 1; C /= 2) {
    if (C > gu) continue;
    Plan t = *p;
    t.cluster = C, t.gx = ceil_to(gu, C);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(t, kCoopThreads, attr,
                                                  nullptr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    t.active = n * C;
    if (t.active >= t.gx || C == 1) *p = t;
    if (t.active >= t.gx) break;
  }
  return 0;
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
  if (route == kCoop) return (const void*)lstm_fwd_kernel<MASKED, STASH>;
  if (route == kTf32)
    return H <= kTfOnePassH
               ? (const void*)lstm_fwd_tf32_kernel<1, MASKED, STASH>
               : (const void*)lstm_fwd_tf32_kernel<2, MASKED, STASH>;
  return H <= 1024 ? (const void*)lstm_fwd_cluster_kernel<128, MASKED, STASH>
                   : (const void*)lstm_fwd_cluster_kernel<64, MASKED, STASH>;
}

template <bool MASKED>
const void* bwd_kernel(int route) {
  return route == kTf32 ? (const void*)lstm_bwd_tf32_kernel<MASKED>
                        : (const void*)lstm_bwd_cluster_kernel<MASKED>;
}

// The plan of kernel `kind` (0 forward, 1 backward) at (dtype, B, H).
template <bool MASKED, bool STASH>
int make_plan(int kind, int dtype, int B, int H, Plan* p) {
  const int route = route_of(kind, dtype, B, H);
  if (route == kCoop)
    return coop_plan(fwd_kernel<MASKED, STASH>(route, H), B, H, p);
  if (route == kTf32 && kind == 0)
    return cluster_plan(fwd_kernel<MASKED, STASH>(route, H), route,
                        kClusterThreads, kTfFwdSmemBytes, kTfFwdRows,
                        (H <= kTfOnePassH ? 1 : 2) * kTfFwdUnits, true, B, H,
                        p);
  if (route == kTf32)
    return cluster_plan(bwd_kernel<MASKED>(route), route, kClusterThreads,
                        kTfBwdSmemBytes, kTfBwdRows, kTfBwdUnits, true, B, H,
                        p);
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

// The split-TF32 forward: h loads from hbuf (H, B, 4 planes) in boxes of
// 32 columns x `slice` rows, RW arranged per 32-unit group (H, 4 Hu) in
// boxes of 32 columns x 128 rows; f32, 128-byte swizzle, zeros outside.
template <bool MASKED, bool STASH>
int launch_fwd_tf32(const FwdArgs& a, const Plan& p, const void* rwp, int Hk,
                    cudaStream_t st) {
  TfFwdMaps maps;
  const int slice = kTfFwdRows / p.cluster < 8 ? 8 : kTfFwdRows / p.cluster;
  const cuuint64_t H = a.H, B = a.B, ldh = a.ldh;
  int rc;
  {
    const cuuint64_t dims[3] = {H, B, 4};
    const cuuint64_t strides[2] = {ldh * 4, ldh * 4 * B};
    const cuuint32_t box[3] = {kTfK, (cuuint32_t)slice, 1};
    rc = sm90::make_map_f32(&maps.h, a.hbuf, 3, dims, strides, box);
  }
  if (rc) return rc;
  {
    const cuuint64_t dims[2] = {H, 4 * (cuuint64_t)ceil_to(a.H, 64)};
    const cuuint64_t strides[1] = {(cuuint64_t)Hk * 4};
    const cuuint32_t box[2] = {kTfK, 128};
    rc = sm90::make_map_f32(&maps.w, rwp, 2, dims, strides, box);
  }
  if (rc) return rc;
  const TfFwdArgs ta{static_cast<const float*>(a.xw),
                     static_cast<const float*>(a.peep),
                     static_cast<const float*>(a.mask),
                     static_cast<float*>(a.hbuf),
                     static_cast<float*>(a.h_out),
                     static_cast<float*>(a.hT),
                     static_cast<float*>(a.cT),
                     static_cast<float*>(a.hsel),
                     static_cast<float*>(a.c_stash),
                     static_cast<float*>(a.gates),
                     (long long)a.B * a.ldh,
                     a.T,
                     a.B,
                     a.H,
                     a.ldh,
                     a.reverse,
                     p.cluster};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(p, kClusterThreads, attr, st);
  cudaError_t e =
      a.H <= kTfOnePassH
          ? cudaLaunchKernelEx(&cfg, lstm_fwd_tf32_kernel<1, MASKED, STASH>,
                               maps, ta)
          : cudaLaunchKernelEx(&cfg, lstm_fwd_tf32_kernel<2, MASKED, STASH>,
                               maps, ta);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The cooperative forward: one launch with the cooperative attribute (and
// clusters of p.cluster blocks), refused when the grid is not
// co-resident; tensor maps as CoopMaps says.
template <bool MASKED, bool STASH>
int launch_fwd_coop(const FwdArgs& a, const Plan& p, const void* rwp, int Hk,
                    cudaStream_t st) {
  CoopMaps maps;
  const cuuint64_t H = a.H, B = a.B, T = a.T;
  const cuuint32_t rows = p.rows;
  int rc;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)a.ldh, (cuuint64_t)a.Bp, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)a.ldh * 2,
                                   (cuuint64_t)a.plane * 2};
    const cuuint32_t box[3] = {kChunk, rows, 1};
    rc = sm90::make_map_bf16(&maps.h, a.hbuf, 3, dims, strides, box);
  }
  if (rc) return rc;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)Hk,
                                4 * (cuuint64_t)ceil_to(a.H, 64)};
    const cuuint64_t strides[1] = {(cuuint64_t)Hk * 2};
    const cuuint32_t box[2] = {kChunk, 4 * kCoopUnits};
    rc = sm90::make_map_bf16(&maps.w, rwp, 2, dims, strides, box);
  }
  if (rc) return rc;
  {
    const cuuint64_t dims[4] = {H, 4, B, T};
    const cuuint64_t strides[3] = {H * 2, H * 8, H * 8 * B};
    const cuuint32_t box[4] = {kCoopUnits, 1, rows, 1};
    rc = sm90::make_map_bf16(&maps.xw, a.xw, 4, dims, strides, box, false);
  }
  if (rc) return rc;
  const CoopArgs ca{static_cast<const bf16*>(a.xw),
                    static_cast<const bf16*>(a.peep),
                    static_cast<const bf16*>(a.c0),
                    static_cast<const bf16*>(a.mask),
                    static_cast<bf16*>(a.hbuf),
                    static_cast<bf16*>(a.h_out),
                    static_cast<bf16*>(a.hT),
                    static_cast<bf16*>(a.cT),
                    static_cast<bf16*>(a.hsel),
                    static_cast<bf16*>(a.c_stash),
                    static_cast<bf16*>(a.gates),
                    a.sync,
                    a.plane,
                    a.T,
                    a.B,
                    a.H,
                    a.ldh,
                    a.reverse,
                    p.cluster,
                    p.rows,
                    a.B <= 64};
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = cluster_config(p, kCoopThreads, attr, st);
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.numAttrs = 2;
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, lstm_fwd_kernel<MASKED, STASH>, maps, ca);
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
  if (p.route == kCoop)
    return launch_fwd_coop<MASKED, STASH>(a, p, rwp, Hk, st);
  if (p.route == kTf32)
    return launch_fwd_tf32<MASKED, STASH>(a, p, rwp, Hk, st);
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
  const cuuint64_t G = 4ull * a.H;
  CUtensorMap tdz, trw;
  if (p.route == kTf32) {
    {  // the dz[t] planes (4H, B, 2): 32 columns x (128 / C) rows
      const cuuint64_t dims[3] = {G, (cuuint64_t)a.B, 2};
      const cuuint64_t strides[2] = {G * 4, G * 4 * a.B};
      const cuuint32_t box[3] = {kTfK, (cuuint32_t)(kTfBwdRows / p.cluster),
                                 1};
      rc = sm90::make_map_f32(&tdz, a.dzbuf, 3, dims, strides, box);
    }
    if (rc) return rc;
    {  // RW's TF32 planes (4H, H, 2): 32 columns x 128 units
      const cuuint64_t dims[3] = {G, (cuuint64_t)a.H, 2};
      const cuuint64_t strides[2] = {G * 4, G * 4 * a.H};
      const cuuint32_t box[3] = {kTfK, kTfBwdUnits, 1};
      rc = sm90::make_map_f32(&trw, a.rwp, 3, dims, strides, box);
    }
    if (rc) return rc;
    const TfBwdArgs ta{static_cast<const float*>(a.gates),
                       static_cast<const float*>(a.c),
                       static_cast<const float*>(a.dh_out),
                       static_cast<const float*>(a.dhT),
                       static_cast<const float*>(a.mask),
                       static_cast<const float*>(a.peep),
                       static_cast<const float*>(a.c0),
                       static_cast<float*>(a.dz),
                       static_cast<float*>(a.dzbuf),
                       a.dhc0,
                       a.T,
                       a.B,
                       a.H,
                       a.reverse,
                       p.cluster};
    const cudaLaunchConfig_t cfg =
        cluster_config(p, kClusterThreads, attr, st);
    cudaError_t e =
        cudaLaunchKernelEx(&cfg, lstm_bwd_tf32_kernel<MASKED>, tdz, trw, ta);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
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
// ldh >= H rounded up to 128); `rwp` is RW arranged for the bf16 forwards
// ((4 Hu, Hk), Hu = H rounded up to 64, Hk to 8: per 64-unit group for the
// cluster forward, `_rw_by_unit_group(rw)`, per 8-unit group for the
// cooperative one, `_rw_by_unit_group(rw, 8, 8)`); `sync` is the
// cooperative forward's step counter, one zeroed unsigned (ignored by the
// other routes). The split-TF32 forward (f32)
// takes instead `hbuf` (4, B, ldh) (ldh = H rounded up to 4; planes
// 0 and 1 the TF32 big and small parts of h0, Bp = B), `rwp` RW arranged
// per 32-unit group ((4 Hu, Hk), Hu = H rounded up to 64, Hk to 4:
// `_rw_by_unit_group(rw, 32, 4)`), and reads the carries from cT (and,
// masked, hT), which hold c0 (h0) at the launch; c0 is unused. The
// split-TF32 backward (f32) takes `rwp` (2, H, 4H), RW's two TF32 planes
// (`_tf32_planes`), a scratch `dzbuf` (2, B, 4H), and reads the dc carry
// from dhc0[1], which holds dcT at the launch; the other routes ignore all
// three. The bf16 kernels take H a
// multiple of 8 (the wrapper pads it). Each entry returns the cudaError_t
// of its launch: a cooperative grid larger than the co-resident blocks
// cudaErrorCooperativeLaunchTooLarge, a cluster kernel whose plan has no
// cluster that fits cudaErrorInvalidConfiguration.
int dl4j_lstm_fwd(const void* xw, const void* rwp, int Hk, const void* peep,
                  const void* c0, const void* mask, void* hbuf, int Bp,
                  int ldh, unsigned* sync, void* h_out, void* hT, void* cT,
                  void* hsel, void* c_stash, void* gates, int dtype, int T,
                  int B, int H, int reverse, void* stream) {
  FwdArgs a{};
  a.xw = xw, a.peep = peep, a.c0 = c0, a.mask = mask;
  a.hbuf = hbuf, a.sync = sync, a.h_out = h_out, a.hT = hT, a.cT = cT;
  a.hsel = hsel, a.c_stash = c_stash, a.gates = gates;
  a.T = T, a.B = B, a.H = H, a.Bp = Bp;
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
                  const void* rw, const void* rwp, const void* peep,
                  const void* c0, void* dz, void* dzbuf, float* dhc0,
                  int dtype, int T, int B, int H, int reverse, void* stream) {
  BwdArgs a{};
  a.gates = gates, a.c = c, a.dh_out = dh_out, a.dhT = dhT, a.dcT = dcT;
  a.mask = mask, a.rw = rw, a.rwp = rwp, a.peep = peep, a.c0 = c0;
  a.dz = dz, a.dzbuf = dzbuf, a.dhc0 = dhc0;
  a.T = T, a.B = B, a.H = H, a.reverse = reverse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mask ? launch_bwd<true>(a, dtype, st)
              : launch_bwd<false>(a, dtype, st);
}

// The launch plan of kernel `kind` (0 forward, 1 backward) at (dtype, B,
// H), out[0..6]: {route (0 cooperative forward, 1 bf16 cluster forward, 2
// split-TF32 clusters (f32), 3 bf16 cluster backward), blocks along x
// (the cooperative grid's blocks, or blocks per cluster), along y (1, or
// row tiles), rows per box or tile, blocks that can be resident at once
// (cooperative) or clusters that fit at once (0: refused), blocks per
// cluster, units per block}. Returns the dynamic shared
// memory of one block in bytes (0 on a CUDA error).
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
