// Paged attention for the serving path: the decode step (C = 1), the
// speculative verify (C = k + 1) and the chunked-prefill chunk
// (C = prefill_chunk), on Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_paged_attention.py
// ::_paged_kernel, both branches. Same contract: q (S, C, H, hd); K pool
// (P+1, Hkv, hd, page) and V pool (P+1, Hkv, page, hd), page 0 the trash
// page; page_table (S, n_pages) int32; positions (S,) int32; active (S,)
// bool or null. Row c of slot s attends to cache entries
// <= positions[s] + c, read page by page through page_table[s, j]. GQA
// folds the G = H / Hkv query heads of one KV head into the rows of one
// tile, as (c, g). Inactive slots and fully masked rows give 0. f32 and
// bf16 q; scores, the online-softmax state (m, l) and the accumulator are
// f32; the output is written in q's type.
//
// Dense pools hold q's type. int8 pools (the quantized KV tier) come with
// two f32 scale pools (P+1, Hkv, page), one scale per (page, head,
// position): K[d, kk] = k_pool[pt, h, d, kk] * k_scale[pt, h, kk] and
// V[kk, d] = v_pool[pt, h, kk, d] * v_scale[pt, h, kk]. An element is
// dequantized as int8 -> f32, times its position's f32 scale, rounded to
// q's type: the rounding point of the TPU kernel (dequantize, cast to the
// product's feed type) and of the plain version
// (ops/attention.py::paged_gather_quant). int8 zeros (the trash page)
// dequantize to exactly 0 under any scale.
//
// Design. The key axis is walked in slices of KS keys that never cross a
// page (KS = min(page, 64), less where a slice of f32 would pass 32 KB), so
// shared memory holds stages x (K slice + V slice), never a whole page,
// at any page and head_dim. Each slot's slices are split into `splits`
// contiguous ranges, one block each: a block writes its range's partial
// (m, l, unnormalized acc) per row, and paged_merge_kernel combines them,
// acc = sum_p exp(m_p - M) acc_p and l = sum_p exp(m_p - M) l_p with
// M = max_p m_p over the splits that saw a key (l_p > 0); with one split
// the block writes the output itself. The wrapper picks the splits so
// that enough blocks fill the card (ops/paged_attention.py::plan). Two
// kernels walk the slices:
//  - paged_attention_mma_kernel (bf16 q, page >= 64, wide tiles: the
//    prefill chunks and wide GQA groups): 64-row query tiles of 4 warps,
//    QK^T and PV on tensor cores (mma.sync m16n8k16, bf16 in, f32
//    accumulate) fed by ldmatrix; the K slice is stored (hd, 64) as the
//    pool holds it and read with ldmatrix.trans, the V slice (64, hd).
//    P is rounded to bf16 before its product, as the TPU kernel casts it
//    to the feed type. Dense slices are staged by cp.async, two stages;
//    int8 slices are staged raw (two stages) and dequantized into one
//    bf16 slice before the products;
//  - paged_attention_kernel (f32, decode, verify, small pages): one block
//    per tile of TR <= 16 rows; scalar f32 FMAs (TF32 stays off for f32);
//    the query tile and the probabilities kept transposed so the inner
//    loops read the TR rows with 16-byte shared loads; int8 elements
//    dequantized where the loops read them.
// Slices are staged with 16-byte cp.async copies (a slice's K rows are
// KS >= 16 contiguous bytes, or the whole contiguous page), scale rows
// with 4-byte copies, so pages of 1 and 2 positions work.
//
// What bounds it on an H100: at decode (C = 1) each K/V slice is read
// once per query row group, about 2 flops per byte in bf16, far below the
// card's ridge: bounded by the K/V bytes, which the split walk reads with
// enough blocks in flight to cover HBM latency. At C = 256 each staged
// slice serves 64 rows per tile, which puts the work near the ridge:
// bounded by the tensor cores' rate at 64-row tiles of mma.sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // ops/attention.py NEG_INF
constexpr int kMmaRows = 64;       // query rows of an mma tile
constexpr int kMmaKeys = 64;       // keys of an mma slice

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// 16-byte and 4-byte asynchronous copies global -> shared (sm_80+), not
// waited for here.
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

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One call's operands as the C entry points receive them.
struct Call {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;  // null for dense pools
  const int *page_table, *positions;
  const unsigned char* active;
  void* out;
  float* part_acc;  // (splits, S, Hkv, C*G, hd), when splits > 1
  float* part_ml;   // (splits, S, Hkv, C*G, 2): m, l
  int S, C, H, Hkv, hd, page, n_pages, ks, splits, tile;
  float sm_scale;
};

// Where a block's keys start and end: slices [j0, j1) of `ks` keys, the
// part of split p's contiguous range that rows up to `last_row` can see.
struct Walk {
  int j0, j1;
  __device__ Walk(const Call& c, int p0, int last_row) {
    const int G = c.H / c.Hkv;
    const int total = c.n_pages * c.page / c.ks;
    const int per = (total + c.splits - 1) / c.splits;
    // slices past the last row's limit hold nothing any row may see
    const int live = min(total, (p0 + last_row / G) / c.ks + 1);
    j0 = (blockIdx.z / (gridDim.z / c.splits)) * per;
    j1 = min(live, j0 + per);
  }
};

// Element offset of the (c, g) row r of slot s, KV head h, in q or out.
__device__ __forceinline__ size_t row_offset(const Call& c, int s, int h,
                                             int r) {
  const int G = c.H / c.Hkv;
  return (((size_t)s * c.C + r / G) * c.H + (size_t)h * G + r % G) * c.hd;
}

// Index of row r's partial result of this block's split.
__device__ __forceinline__ size_t part_row(const Call& c, int s, int h,
                                           int r) {
  const int R = c.C * (c.H / c.Hkv);
  const int split = blockIdx.z / (gridDim.z / c.splits);
  return (((size_t)split * c.S + s) * c.Hkv + h) * R + r;
}

// Stage slice j of KV head h of slot s: K rows (hd, ks) and V rows
// (ks, hd) of TK, and for int8 pools the two scale rows (ks,) f32, into
// the given buffers; the caller commits the group.
template <typename TK>
__device__ __forceinline__ void stage_slice(const Call& c, int s, int h, int j,
                                            TK* dk, int ldk, TK* dv, int ldv,
                                            float* dks, float* dvs) {
  const int ks = c.ks, hd = c.hd, page = c.page;
  const int key = j * ks, off = key % page;
  const size_t pg =
      (size_t)c.page_table[(size_t)s * c.n_pages + key / page] * c.Hkv + h;
  const TK* kp = static_cast<const TK*>(c.k_pool) + pg * hd * page;
  const TK* vp = static_cast<const TK*>(c.v_pool) + (pg * page + off) * hd;
  constexpr int kv = 16 / sizeof(TK);  // elements per 16-byte copy
  if (ks == page && ldk == ks) {       // the whole page, contiguous
    for (int i = threadIdx.x; i < hd * ks / kv; i += blockDim.x)
      cp_async16(dk + i * kv, kp + i * kv);
  } else {  // ks >= kv keys of each of the hd rows
    const int cpr = ks / kv;
    for (int i = threadIdx.x; i < hd * cpr; i += blockDim.x) {
      const int d = i / cpr, x = i % cpr;
      cp_async16(dk + d * ldk + x * kv, kp + (size_t)d * page + off + x * kv);
    }
  }
  const int cpr = hd / kv;
  for (int i = threadIdx.x; i < ks * cpr; i += blockDim.x) {
    const int r = i / cpr, x = i % cpr;
    cp_async16(dv + r * ldv + x * kv, vp + (size_t)r * hd + x * kv);
  }
  if constexpr (std::is_same<TK, int8_t>::value) {
    for (int i = threadIdx.x; i < ks; i += blockDim.x) {
      cp_async4(dks + i, c.k_scale + pg * page + off + i);
      cp_async4(dvs + i, c.v_scale + pg * page + off + i);
    }
  }
}

// One staged K or V element as the products take it: a dense element cast
// up; an int8 element times its position's scale, rounded to q's type T.
template <typename T, typename TK>
__device__ __forceinline__ float kv_value(TK v, float scale) {
  if constexpr (std::is_same<TK, int8_t>::value)
    return to_f32(from_f32<T>((float)v * scale));
  else
    return to_f32(v);
}

// TR consecutive floats of shared memory, 16 bytes per load when TR % 4 == 0
template <int TR>
__device__ __forceinline__ void load_row(float (&v)[TR], const float* p) {
  if constexpr (TR % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TR / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TR; ++i) v[i] = p[i];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ===================================================== scalar kernel
// Dynamic shared memory: two stages of the K and V slices of `elem`-byte
// elements, for int8 pools two stages of the K and V scale rows, then the
// f32 tiles q^T (hd, TR), scores (TR, ks), probabilities^T (ks, TR), acc
// (TR, hd) and the per-row m, l, corr.
size_t smem_scalar(size_t elem, bool quant, int tr, int hd, int ks) {
  return (size_t)2 * 2 * hd * ks * elem +
         (quant ? (size_t)2 * 2 * ks * sizeof(float) : 0) +
         ((size_t)2 * tr * hd + (size_t)2 * tr * ks + 3 * (size_t)tr) *
             sizeof(float);
}

// T: the type of q and out; TK: the pools' element type, T or int8_t.
template <typename T, typename TK, int TR>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const Call c) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  constexpr int NP = TR >= 8 ? 1 : 8 / TR;  // partial sums per row
  const int s = blockIdx.x, h = blockIdx.y;
  const int G = c.H / c.Hkv, R = c.C * G;
  const int r0 = (blockIdx.z % (gridDim.z / c.splits)) * TR;
  const int tr = min(TR, R - r0);
  const int tid = threadIdx.x, hd = c.hd, ks = c.ks;
  const size_t tile = (size_t)hd * ks;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  TK* sK = reinterpret_cast<TK*>(smem_raw);  // 2 x (hd, ks)
  TK* sV = sK + 2 * tile;                    // 2 x (ks, hd)
  // int8 pools: 2 x (ks,) K scales, then as many V scales
  float* sKs = reinterpret_cast<float*>(sV + 2 * tile);
  float* sVs = sKs + (kQuant ? 2 * ks : 0);
  float* sQt = sVs + (kQuant ? 2 * ks : 0);  // (hd, TR)
  float* sS = sQt + TR * hd;                 // (TR, ks)
  float* sPt = sS + TR * ks;                 // (ks, TR)
  float* sAcc = sPt + TR * ks;               // (TR, hd)
  float* sM = sAcc + TR * hd;                // (TR,)
  float* sL = sM + TR;
  float* sCorr = sL + TR;

  T* out = static_cast<T*>(c.out);
  if (c.active != nullptr && c.active[s] == 0) {  // inactive lane: zeros
    if (c.splits == 1)
      for (int i = tid; i < tr * hd; i += blockDim.x)
        out[row_offset(c, s, h, r0 + i / hd) + i % hd] = from_f32<T>(0.f);
    return;  // with splits, the merge writes them
  }

  const int p0 = c.positions[s];
  const Walk w(c, p0, r0 + tr - 1);
  auto stage = [&](int j, int buf) {
    stage_slice<TK>(c, s, h, j, sK + buf * tile, ks, sV + buf * tile, hd,
                    sKs + buf * ks, sVs + buf * ks);
    cp_async_commit();  // one group per slice
  };
  if (w.j0 < w.j1) stage(w.j0, 0);  // the first slice flies while q is staged

  const T* q = static_cast<const T*>(c.q);
  for (int i = tid; i < TR * hd; i += blockDim.x) {
    const int rr = i / hd, d = i % hd;
    sQt[d * TR + rr] =
        rr < tr ? to_f32(q[row_offset(c, s, h, r0 + rr) + d]) : 0.f;
    sAcc[i] = 0.f;
  }
  for (int rr = tid; rr < TR; rr += blockDim.x) {
    sM[rr] = kNegInf;
    sL[rr] = 0.f;
  }
  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;

  for (int j = w.j0; j < w.j1; ++j) {
    const int buf = (j - w.j0) & 1;
    if (j + 1 < w.j1) {
      stage(j + 1, buf ^ 1);  // prefetch the next slice into the other buffer
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice j staged by every thread; q, m, l initialized
    const TK* cK = sK + buf * tile;
    const TK* cV = sV + buf * tile;
    const float* cKs = sKs + buf * ks;  // read only when kQuant
    const float* cVs = sVs + buf * ks;

    // scores (TR, ks) = q . K * scale, masked by position; NP independent
    // partial sums per row keep a short tile's FMA chains from serializing
    for (int kk = tid; kk < ks; kk += blockDim.x) {
      float a[NP][TR];
#pragma unroll
      for (int x = 0; x < NP; ++x)
#pragma unroll
        for (int rr = 0; rr < TR; ++rr) a[x][rr] = 0.f;
      float ksc = 1.f;
      if constexpr (kQuant) ksc = cKs[kk];
      for (int d = 0; d < hd; d += NP) {
#pragma unroll
        for (int x = 0; x < NP; ++x) {
          const float kv = kv_value<T>(cK[(d + x) * ks + kk], ksc);
          float qv[TR];
          load_row<TR>(qv, sQt + (d + x) * TR);
#pragma unroll
          for (int rr = 0; rr < TR; ++rr) a[x][rr] += qv[rr] * kv;
        }
      }
      const int kpos = j * ks + kk;
#pragma unroll
      for (int rr = 0; rr < TR; ++rr) {
        float v = a[0][rr];
#pragma unroll
        for (int x = 1; x < NP; ++x) v += a[x][rr];
        const int cq = (r0 + rr) / G;
        sS[rr * ks + kk] = kpos <= p0 + cq ? v * c.sm_scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int rr = warp; rr < TR; rr += n_warps) {
      float mx = kNegInf;
      for (int kk = lane; kk < ks; kk += 32) mx = fmaxf(mx, sS[rr * ks + kk]);
      mx = warp_max(mx);
      const float m_prev = sM[rr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int kk = lane; kk < ks; kk += 32) {
        const float sc = sS[rr * ks + kk];
        // masked entries stay exactly 0, also on rows masked so far
        const float p = sc <= kNegInf * 0.5f ? 0.f : expf(sc - m_new);
        sPt[kk * TR + rr] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sCorr[rr] = corr;
        sL[rr] = sL[rr] * corr + sum;
        sM[rr] = m_new;
      }
    }
    __syncthreads();

    // acc (TR, hd) = acc * corr + P . V
    for (int d = tid; d < hd; d += blockDim.x) {
      float a[NP][TR];
#pragma unroll
      for (int rr = 0; rr < TR; ++rr) {
        a[0][rr] = sAcc[rr * hd + d] * sCorr[rr];
#pragma unroll
        for (int x = 1; x < NP; ++x) a[x][rr] = 0.f;
      }
      for (int kk = 0; kk < ks; kk += NP) {
#pragma unroll
        for (int x = 0; x < NP; ++x) {
          if (NP > 1 && kk + x >= ks) break;  // slices of fewer keys
          float vsc = 1.f;
          if constexpr (kQuant) vsc = cVs[kk + x];
          const float vv = kv_value<T>(cV[(kk + x) * hd + d], vsc);
          float pv[TR];
          load_row<TR>(pv, sPt + (kk + x) * TR);
#pragma unroll
          for (int rr = 0; rr < TR; ++rr) a[x][rr] += pv[rr] * vv;
        }
      }
#pragma unroll
      for (int rr = 0; rr < TR; ++rr) {
        float v = a[0][rr];
#pragma unroll
        for (int x = 1; x < NP; ++x) v += a[x][rr];
        sAcc[rr * hd + d] = v;
      }
    }
    __syncthreads();  // buffer `buf` and the tiles are free for reuse
  }

  if (c.splits == 1) {
    for (int i = tid; i < tr * hd; i += blockDim.x) {
      const float l = sL[i / hd];
      out[row_offset(c, s, h, r0 + i / hd) + i % hd] =
          from_f32<T>(l > 0.f ? sAcc[i] / l : 0.f);
    }
  } else {
    for (int i = tid; i < tr * hd; i += blockDim.x)
      c.part_acc[part_row(c, s, h, r0 + i / hd) * hd + i % hd] = sAcc[i];
    for (int rr = tid; rr < tr; rr += blockDim.x) {
      const size_t pr = part_row(c, s, h, r0 + rr);
      c.part_ml[2 * pr] = sM[rr];
      c.part_ml[2 * pr + 1] = sL[rr];
    }
  }
}

// ======================================================== mma kernel
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

// B operands of two 8-wide n-tiles (n0, n0 + 8) at k-step k0 from a tile
// stored [k][n] (row k holds the n values): b[0..1] for n0, b[2..3] for
// n0 + 8
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shared memory of the mma kernel at head_dim HD, in bf16 elements unless
// named: Q (64, HD+8); K slices (HD, 64+8) and V slices (64, HD+8), two
// stages of each for dense pools, one for int8 pools, which add two raw
// stages of int8 K (HD, 64) and V (64, HD) bytes and of the two f32 scale
// rows.
template <int HD, bool QUANT>
struct MmaSmem;
template <int HD>
struct MmaSmem<HD, false> {
  static constexpr int kLdk = kMmaKeys + 8, kLdv = HD + 8;
  bf16 q[kMmaRows * kLdv];
  bf16 k[2][HD * kLdk];
  bf16 v[2][kMmaKeys * kLdv];
};
template <int HD>
struct MmaSmem<HD, true> {
  static constexpr int kLdk = kMmaKeys + 8, kLdv = HD + 8;
  bf16 q[kMmaRows * kLdv];
  bf16 k[1][HD * kLdk];
  bf16 v[1][kMmaKeys * kLdv];
  int8_t rk[2][HD * kMmaKeys];
  int8_t rv[2][kMmaKeys * HD];
  float rks[2][kMmaKeys];
  float rvs[2][kMmaKeys];
};

// The dequantization of a raw int8 slice into the bf16 slice, 4 elements
// a thread and step: int8 -> f32, times its position's scale, rounded to
// bf16.
template <int HD>
__device__ __forceinline__ void dequantize(MmaSmem<HD, true>& sm, int buf) {
  constexpr int kLdk = MmaSmem<HD, true>::kLdk, kLdv = MmaSmem<HD, true>::kLdv;
  for (int i = threadIdx.x; i < HD * kMmaKeys / 4; i += kThreads) {
    const int e = 4 * i;
    {  // K (HD, 64): 4 keys of one row d
      const int d = e / kMmaKeys, kk = e % kMmaKeys;
      const char4 x = *reinterpret_cast<const char4*>(&sm.rk[buf][e]);
      const float* sc = sm.rks[buf] + kk;
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(&sm.k[0][d * kLdk + kk]);
      dst[0] = __floats2bfloat162_rn((float)x.x * sc[0], (float)x.y * sc[1]);
      dst[1] = __floats2bfloat162_rn((float)x.z * sc[2], (float)x.w * sc[3]);
    }
    {  // V (64, HD): 4 dims of one key row
      const int kk = e / HD, d = e % HD;
      const char4 x = *reinterpret_cast<const char4*>(&sm.rv[buf][e]);
      const float sc = sm.rvs[buf][kk];
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(&sm.v[0][kk * kLdv + d]);
      dst[0] = __floats2bfloat162_rn((float)x.x * sc, (float)x.y * sc);
      dst[1] = __floats2bfloat162_rn((float)x.z * sc, (float)x.w * sc);
    }
  }
}

// bf16 q; TK the pools' element type (bf16 or int8); HD the head_dim.
// Warp w owns rows 16 w .. 16 w + 15 of the block's 64-row tile; lane
// 4g + t holds rows g, g + 8 and, of each 8-wide accumulator tile,
// columns 2t, 2t + 1.
template <typename TK, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_attention_mma_kernel(const Call c) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  using Smem = MmaSmem<HD, kQuant>;
  constexpr int kLdk = Smem::kLdk, kLdv = Smem::kLdv, NO = HD / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int s = blockIdx.x, h = blockIdx.y;
  const int G = c.H / c.Hkv, R = c.C * G;
  const int r0 = (blockIdx.z % (gridDim.z / c.splits)) * kMmaRows;
  const int tr = min(kMmaRows, R - r0);
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int g = l / 4, t = l % 4, wr = 16 * warp;
  bf16* out = static_cast<bf16*>(c.out);
  if (c.active != nullptr && c.active[s] == 0) {  // inactive lane: zeros
    if (c.splits == 1)
      for (int i = threadIdx.x; i < tr * HD; i += kThreads)
        out[row_offset(c, s, h, r0 + i / HD) + i % HD] = from_f32<bf16>(0.f);
    return;  // with splits, the merge writes them
  }
  const int p0 = c.positions[s];
  const Walk w(c, p0, r0 + tr - 1);
  auto stage = [&](int j, int buf) {
    if constexpr (kQuant)
      stage_slice<int8_t>(c, s, h, j, sm.rk[buf], kMmaKeys, sm.rv[buf], HD,
                          sm.rks[buf], sm.rvs[buf]);
    else
      stage_slice<bf16>(c, s, h, j, sm.k[buf], kLdk, sm.v[buf], kLdv,
                        nullptr, nullptr);
    cp_async_commit();
  };
  if (w.j0 < w.j1) stage(w.j0, 0);
  {  // the query tile; rows past the last are zero
    const bf16* q = static_cast<const bf16*>(c.q);
    for (int i = threadIdx.x; i < kMmaRows * HD / 8; i += kThreads) {
      const int rr = i / (HD / 8), x = i % (HD / 8);
      bf16* dst = sm.q + rr * kLdv + 8 * x;
      if (rr < tr)
        cp_async16(dst, q + row_offset(c, s, h, r0 + rr) + 8 * x);
      else
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
    cp_async_commit();
  }
  // this thread's two rows: their query position limits
  int limit[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) limit[i] = p0 + (r0 + wr + g + 8 * i) / G;
  float o[NO][4], m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int j = w.j0; j < w.j1; ++j) {
    const int buf = (j - w.j0) & 1;
    if (j + 1 < w.j1) {
      stage(j + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice j (and the query tile) staged
    if constexpr (kQuant) {
      dequantize<HD>(sm, buf);
      __syncthreads();
    }
    const bf16* K = sm.k[kQuant ? 0 : buf];
    const bf16* V = sm.v[kQuant ? 0 : buf];
    // scores (16 x 64 per warp) = Q K, K stored (HD, 64)
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < HD; k0 += 16) {
      uint32_t a[4];
      ld_a(a, sm.q, kLdv, wr, k0);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t b[4];
        ld_b_kn(b, K, kLdk, 8 * n, k0);
        mma(sc[n], a, b[0], b[1]);
        mma(sc[n + 1], a, b[2], b[3]);
      }
    }
    const int key0 = j * kMmaKeys;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * n + 2 * t + (e & 1);
        const float x = key <= limit[e >> 1] ? sc[n][e] * c.sm_scale : kNegInf;
        sc[n][e] = x;
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
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked entries stay exactly 0, also on rows masked so far
        const float x = sc[n][e];
        const float p = x <= kNegInf * 0.5f ? 0.f : expf(x - m[e >> 1]);
        sc[n][e] = p;
        lsum[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    // acc += P V: P (16 x 64) from the score registers rounded to bf16,
    // V stored (64, HD)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        ld_b_kn(b, V, kLdv, 8 * n, 16 * kk);
        mma(o[n], a, b[0], b[1]);
        mma(o[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this slice's buffers are restaged two slices on
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) lsum[i] = quad_sum(lsum[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = wr + g + 8 * i;
    if (rr >= tr) continue;
    if (c.splits == 1) {
      const float inv = lsum[i] > 0.f ? 1.f / lsum[i] : 0.f;  // l == 0: 0
      bf16* row = out + row_offset(c, s, h, r0 + rr) + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    } else {
      const size_t pr = part_row(c, s, h, r0 + rr);
      float* row = c.part_acc + pr * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(row + 8 * n) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (t == 0) {
        c.part_ml[2 * pr] = m[i];
        c.part_ml[2 * pr + 1] = lsum[i];
      }
    }
  }
}

// ====================================================== merge kernel
// One warp per (slot, KV head, row): lane p < splits loads split p's
// (m, l), the warp reduces M and L, and each lane combines the splits'
// accumulators for its columns; the result in f32, written in q's type.
// Inactive slots give 0.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_merge_kernel(const Call c) {
  const int G = c.H / c.Hkv, R = c.C * G;
  const long long rows = (long long)c.S * c.Hkv * R;
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int s = (int)(row / ((long long)c.Hkv * R));
  const int h = (int)(row / R % c.Hkv), r = (int)(row % R);
  T* out = static_cast<T*>(c.out) + row_offset(c, s, h, r);
  if (c.active != nullptr && c.active[s] == 0) {
    for (int d = lane; d < c.hd; d += 32) out[d] = from_f32<T>(0.f);
    return;
  }
  float mp = kNegInf, lp = 0.f;  // a split that saw no key has l = 0
  if (lane < c.splits) {
    const float* ml = c.part_ml + 2 * (lane * rows + row);
    mp = ml[0], lp = ml[1];
  }
  const float M = warp_max(lp > 0.f ? mp : kNegInf);
  const float wp = lp > 0.f ? expf(mp - M) : 0.f;
  const float L = warp_sum(wp * lp);
  // each lane's columns lane + 32 j of a 256-column block at once, so a
  // split's loads, and the splits', do not wait on one another (a split
  // that saw no key has w = 0 and an acc of zeros)
  for (int d0 = 0; d0 < c.hd; d0 += 256) {
    float acc[8] = {};
    for (int p = 0; p < c.splits; ++p) {
      const float w = __shfl_sync(0xffffffffu, wp, p);
      const float* src = c.part_acc + (p * rows + row) * c.hd + d0 + lane;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (d0 + lane + 32 * j < c.hd) acc[j] += w * src[32 * j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (d0 + lane + 32 * j < c.hd)
        out[d0 + lane + 32 * j] = from_f32<T>(L > 0.f ? acc[j] / L : 0.f);
  }
}

// -------------------------------------------------------------- launches
size_t smem_mma(bool quant, int hd) {
  switch (hd) {
    case 64:
      return quant ? sizeof(MmaSmem<64, true>) : sizeof(MmaSmem<64, false>);
    case 128:
      return quant ? sizeof(MmaSmem<128, true>) : sizeof(MmaSmem<128, false>);
    case 256:
      return quant ? sizeof(MmaSmem<256, true>) : sizeof(MmaSmem<256, false>);
  }
  return 0;
}

// The shared memory of one block of `route` (0 scalar, 1 mma).
size_t smem_bytes(int route, size_t elem, bool quant, int tile, int hd,
                  int ks) {
  return route == 1 ? smem_mma(quant, hd)
                    : smem_scalar(elem, quant, tile, hd, ks);
}

template <typename K>
int run(K kern, size_t smem, dim3 grid, const Call& c, cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, kThreads, smem, st>>>(c);
  return (int)cudaGetLastError();
}

template <typename T, typename TK>
int launch_scalar(const Call& c, cudaStream_t st) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  const int rows = c.C * (c.H / c.Hkv), tr = c.tile;
  const size_t smem = smem_scalar(sizeof(TK), kQuant, tr, c.hd, c.ks);
  const dim3 grid(c.S, c.Hkv, (rows + tr - 1) / tr * c.splits);
  switch (tr) {
    case 16: return run(paged_attention_kernel<T, TK, 16>, smem, grid, c, st);
    case 8: return run(paged_attention_kernel<T, TK, 8>, smem, grid, c, st);
    case 4: return run(paged_attention_kernel<T, TK, 4>, smem, grid, c, st);
    case 2: return run(paged_attention_kernel<T, TK, 2>, smem, grid, c, st);
    default: return run(paged_attention_kernel<T, TK, 1>, smem, grid, c, st);
  }
}

template <typename TK>
int launch_mma(const Call& c, cudaStream_t st) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  const int rows = c.C * (c.H / c.Hkv);
  const dim3 grid(c.S, c.Hkv, (rows + kMmaRows - 1) / kMmaRows * c.splits);
  const size_t smem = smem_mma(kQuant, c.hd);
  switch (c.hd) {
    case 64: return run(paged_attention_mma_kernel<TK, 64>, smem, grid, c, st);
    case 128:
      return run(paged_attention_mma_kernel<TK, 128>, smem, grid, c, st);
    case 256:
      return run(paged_attention_mma_kernel<TK, 256>, smem, grid, c, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_merge(const Call& c, cudaStream_t st) {
  const long long rows = (long long)c.S * c.Hkv * c.C * (c.H / c.Hkv);
  const int per = kThreads / 32;
  paged_merge_kernel<T><<<(unsigned)((rows + per - 1) / per), kThreads, 0,
                          st>>>(c);
  return (int)cudaGetLastError();
}

// route 1 (the mma kernel) takes bf16 q only (the wrapper's plan).
template <typename T, typename TK>
int dispatch(const Call& c, int route, cudaStream_t st) {
  int rc;
  if constexpr (std::is_same<T, bf16>::value)
    rc = route == 1 ? launch_mma<TK>(c, st) : launch_scalar<T, TK>(c, st);
  else
    rc = route == 1 ? (int)cudaErrorInvalidValue : launch_scalar<T, TK>(c, st);
  if (rc == 0 && c.splits > 1) rc = launch_merge<T>(c, st);
  return rc;
}

}  // namespace

extern "C" {

// One launch (two with splits > 1: the walk, then the merge). dtype: 0 =
// float32, 1 = bfloat16 (q and out); int8: pools of int8 with their f32
// scale pools (P+1, Hkv, page), else pools of q's type and null scales.
// route: 0 the scalar kernel, 1 the mma kernel (bf16 q, page >= 64, hd in
// {64, 128, 256}); ks: keys per slice (a power of two dividing page; 64 for
// route 1); splits: blocks per (slot, KV head, row tile) along the keys (at
// most 32), with part_acc (splits, S, Hkv, C*G, hd) and part_ml (splits,
// S, Hkv, C*G, 2) f32 scratch when splits > 1; tile: (c, g) rows of a
// scalar tile (1, 2, 4, 8 or 16; 64 for route 1). Returns the cudaError_t
// of the launches.
int dl4j_paged_attention(const void* q, const void* k_pool,
                         const void* v_pool, const float* k_scale,
                         const float* v_scale, const int* page_table,
                         const int* positions, const unsigned char* active,
                         void* out, float* part_acc, float* part_ml,
                         int dtype, int int8, int route, int ks, int splits,
                         int tile, int S, int C, int H, int Hkv, int hd,
                         int page, int n_pages, float sm_scale,
                         void* stream) {
  const Call c{q,        k_pool,    v_pool, k_scale, v_scale, page_table,
               positions, active,   out,    part_acc, part_ml, S,
               C,        H,         Hkv,    hd,      page,    n_pages,
               ks,       splits,    tile,   sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return int8 ? dispatch<bf16, int8_t>(c, route, st)
                : dispatch<bf16, bf16>(c, route, st);
  return int8 ? dispatch<float, int8_t>(c, route, st)
              : dispatch<float, float>(c, route, st);
}

// Dynamic shared memory of one block of the walk kernel, in bytes.
size_t dl4j_paged_attention_smem_bytes(int dtype, int int8, int route,
                                       int tile, int hd, int ks) {
  const size_t elem = int8 ? 1 : dtype == 1 ? 2 : 4;
  return smem_bytes(route, elem, int8 != 0, tile, hd, ks);
}

}  // extern "C"
