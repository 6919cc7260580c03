// Paged attention for the serving path: the decode step (C = 1) and the
// chunked-prefill chunk (C = prefill_chunk), on Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_paged_attention.py
// ::_paged_kernel, both branches. Same contract: q (S, C, H, hd); K pool
// (P+1, Hkv, hd, page) and V pool (P+1, Hkv, page, hd), page 0 the trash
// page; page_table (S, n_pages) int32; positions (S,) int32; active (S,)
// bool or null. Row c of slot s attends to cache entries
// <= positions[s] + c, read page by page through page_table[s, j]. GQA
// folds the G = H / Hkv query heads of one KV head into the rows of one
// tile, as (c, g). Inactive slots and fully masked rows give 0. f32 and
// bf16; scores, the online-softmax state (m, l) and the accumulator are
// f32; the output is written in q's type.
//
// Dense pools hold q's type. int8 pools (the quantized KV tier) come with
// two f32 scale pools (P+1, Hkv, page), one scale per (page, head,
// position): K[d, kk] = k_pool[pt, h, d, kk] * k_scale[pt, h, kk] and
// V[kk, d] = v_pool[pt, h, kk, d] * v_scale[pt, h, kk]. The int8 kernel is
// the dense kernel templated on the pool's element type. Where the
// dequantization goes: each page's int8 K and V tiles and its two scale
// rows are staged as they are (half the bf16 bytes, and two page buffers
// fit at any supported shape), and an element is dequantized where the
// inner loops read it: int8 -> f32, times its position's f32 scale,
// rounded to q's type, back to f32 for the FMA. That is the rounding point
// of the TPU kernel (dequantize, cast to the product's feed type, multiply
// with f32 accumulation) and of the plain version
// (ops/attention.py::paged_gather_quant), so kernel and plain agree to
// the order of the sums. Folding the scales into the scores and into P
// would save the per-element multiply but move that rounding point. int8
// zeros (the trash page) dequantize to exactly 0 under any scale.
//
// Design. One block per (slot, KV head, tile of TR <= 16 query rows). The
// block reads its own position and active flag (no scalar prefetch) and
// walks the slot's pages only up to the last one its rows can see. Each K
// page (hd, page) and V page (page, hd) is staged in shared memory with
// 16-byte cp.async copies, all of a page's copies in flight at once; where
// two page buffers fit (bf16 at hd = page = 128: 128 KB) the next page is
// fetched while the current one is computed. Scores and P.V are scalar f32
// FMAs; the query tile and the probabilities are kept transposed so the
// inner loops read the TR rows with 16-byte shared loads. Shared memory
// above the 48 KB default takes the opt-in attribute.
//
// What bounds it on an H100: at decode (C = 1) each page of K/V is read
// once per query row group, so the kernel is bounded by the K/V bytes
// (about 2 flops per byte in bf16, far below the card's ridge). At
// C = 256 chunks each staged page serves 16 rows per tile and 256 rows per
// head, which puts the work near the ridge; the scalar FMAs here do not
// reach the tensor cores, so there the kernel is bounded by its own
// arithmetic. wgmma, TMA and splitting the page walk across blocks when
// S * Hkv is small are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // ops/attention.py NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// 16-byte asynchronous copy global -> shared (sm_80+), not waited for here.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
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

// Start the copies of two arrays of n elements each (one K page and one V
// page, or their two scale rows); the caller commits the group.
// n * sizeof(T) is a multiple of 16 and every pointer is 16-byte aligned
// (checked by the wrapper and by the shared-memory layout).
template <typename T>
__device__ __forceinline__ void stage_pair(T* dst_a, T* dst_b, const T* src_a,
                                           const T* src_b, int n) {
  const int nv = n * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    cp_async16(reinterpret_cast<int4*>(dst_a) + i,
               reinterpret_cast<const int4*>(src_a) + i);
    cp_async16(reinterpret_cast<int4*>(dst_b) + i,
               reinterpret_cast<const int4*>(src_b) + i);
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

// Dynamic shared memory of one block: `stages` K and V page buffers of
// `elem`-byte elements, for int8 pools `stages` K and V scale rows, then
// the f32 tiles q^T (hd, TR), scores (TR, page), probabilities^T
// (page, TR), acc (TR, hd) and the per-row m, l, corr.
size_t smem_bytes(size_t elem, bool quant, int tr, int hd, int page,
                  int stages) {
  return (size_t)stages * 2 * hd * page * elem +
         (quant ? (size_t)stages * 2 * page * sizeof(float) : 0) +
         ((size_t)2 * tr * hd + (size_t)2 * tr * page + 3 * (size_t)tr) *
             sizeof(float);
}

// T: the type of q and out; TK: the pools' element type, T or int8_t.
template <typename T, typename TK, int TR, int STAGES>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,
                           const TK* __restrict__ k_pool,
                           const TK* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ page_table,
                           const int* __restrict__ positions,
                           const unsigned char* __restrict__ active,
                           T* __restrict__ out, int C, int H, int Hkv, int hd,
                           int page, int n_pages, float sm_scale) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / Hkv;
  const int r0 = blockIdx.z * TR;  // first row (c * G + g) of this tile
  const int tr = min(TR, C * G - r0);
  const int tid = threadIdx.x;
  const size_t tile = (size_t)hd * page;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  TK* sK = reinterpret_cast<TK*>(smem_raw);      // STAGES x (hd, page)
  TK* sV = sK + STAGES * tile;                   // STAGES x (page, hd)
  // int8 pools: STAGES x (page,) K scales, then as many V scales
  float* sKs = reinterpret_cast<float*>(sV + STAGES * tile);
  float* sVs = sKs + (kQuant ? STAGES * page : 0);
  float* sQt = sVs + (kQuant ? STAGES * page : 0);  // (hd, TR)
  float* sS = sQt + TR * hd;                     // (TR, page)
  float* sPt = sS + TR * page;                   // (page, TR)
  float* sAcc = sPt + TR * page;                 // (TR, hd)
  float* sM = sAcc + TR * hd;                    // (TR,)
  float* sL = sM + TR;
  float* sCorr = sL + TR;

  // element offset of row rr's (slot, c, query head) vector in q / out
  auto row_off = [&](int rr) -> size_t {
    const int r = r0 + rr;
    const int c = r / G, g = r % G;
    return (((size_t)s * C + c) * H + (size_t)h * G + g) * hd;
  };

  if (active != nullptr && active[s] == 0) {  // inactive lane: zeros
    for (int i = tid; i < tr * hd; i += blockDim.x)
      out[row_off(i / hd) + i % hd] = from_f32<T>(0.f);
    return;
  }

  const int p0 = positions[s];
  // pages past the last row's limit hold nothing any row may see
  const int last_limit = p0 + (r0 + tr - 1) / G;
  const int n_live = min(n_pages, last_limit / page + 1);
  auto stage = [&](int j, int buf) {
    // (pool page, KV head) of logical page j: its tiles and scale rows
    const size_t pg = (size_t)page_table[(size_t)s * n_pages + j] * Hkv + h;
    stage_pair(sK + buf * tile, sV + buf * tile, k_pool + pg * tile,
               v_pool + pg * tile, (int)tile);
    if constexpr (std::is_same<TK, int8_t>::value)
      stage_pair(sKs + buf * page, sVs + buf * page, k_scale + pg * page,
                 v_scale + pg * page, page);
    cp_async_commit();  // one group per page
  };
  stage(0, 0);  // the first page flies while q is staged

  for (int i = tid; i < TR * hd; i += blockDim.x) {
    const int rr = i / hd, d = i % hd;
    sQt[d * TR + rr] = rr < tr ? to_f32(q[row_off(rr) + d]) : 0.f;
    sAcc[i] = 0.f;
  }
  for (int rr = tid; rr < TR; rr += blockDim.x) {
    sM[rr] = kNegInf;
    sL[rr] = 0.f;
  }
  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;

  for (int j = 0; j < n_live; ++j) {
    const int buf = STAGES == 2 ? (j & 1) : 0;
    if (STAGES == 2 && j + 1 < n_live) {
      stage(j + 1, buf ^ 1);  // prefetch the next page into the other buffer
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // page j staged by every thread; q, m, l initialized
    const TK* cK = sK + buf * tile;
    const TK* cV = sV + buf * tile;
    const float* cKs = sKs + buf * page;  // read only when kQuant
    const float* cVs = sVs + buf * page;

    // scores (TR, page) = q . K * scale, masked by position
    for (int kk = tid; kk < page; kk += blockDim.x) {
      float a[TR];
#pragma unroll
      for (int rr = 0; rr < TR; ++rr) a[rr] = 0.f;
      float ksc = 1.f;
      if constexpr (kQuant) ksc = cKs[kk];
      for (int d = 0; d < hd; ++d) {
        const float kv = kv_value<T>(cK[d * page + kk], ksc);
        float qv[TR];
        load_row<TR>(qv, sQt + d * TR);
#pragma unroll
        for (int rr = 0; rr < TR; ++rr) a[rr] += qv[rr] * kv;
      }
      const int kpos = j * page + kk;
#pragma unroll
      for (int rr = 0; rr < TR; ++rr) {
        const int c = (r0 + rr) / G;
        sS[rr * page + kk] = kpos <= p0 + c ? a[rr] * sm_scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int rr = warp; rr < TR; rr += n_warps) {
      float mx = kNegInf;
      for (int kk = lane; kk < page; kk += 32)
        mx = fmaxf(mx, sS[rr * page + kk]);
      mx = warp_max(mx);
      const float m_prev = sM[rr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int kk = lane; kk < page; kk += 32) {
        const float sc = sS[rr * page + kk];
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
      float a[TR];
#pragma unroll
      for (int rr = 0; rr < TR; ++rr) a[rr] = sAcc[rr * hd + d] * sCorr[rr];
      for (int kk = 0; kk < page; ++kk) {
        float vsc = 1.f;
        if constexpr (kQuant) vsc = cVs[kk];
        const float vv = kv_value<T>(cV[kk * hd + d], vsc);
        float pv[TR];
        load_row<TR>(pv, sPt + kk * TR);
#pragma unroll
        for (int rr = 0; rr < TR; ++rr) a[rr] += pv[rr] * vv;
      }
#pragma unroll
      for (int rr = 0; rr < TR; ++rr) sAcc[rr * hd + d] = a[rr];
    }
    __syncthreads();  // buffer `buf` and the tiles are free for reuse
    if (STAGES == 1 && j + 1 < n_live) stage(j + 1, 0);
  }

  for (int i = tid; i < tr * hd; i += blockDim.x) {
    const float l = sL[i / hd];
    out[row_off(i / hd) + i % hd] = from_f32<T>(l > 0.f ? sAcc[i] / l : 0.f);
  }
}

int tile_rows(int rows) {
  return rows >= 16 ? 16 : rows >= 8 ? 8 : rows >= 4 ? 4 : rows >= 2 ? 2 : 1;
}

// Shared memory a block may opt in to on the current device. Cached for
// the process: the port runs on one kind of card.
int smem_optin_limit() {
  static int limit = -1;
  if (limit < 0) {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    limit = v;
  }
  return limit;
}

// One call's operands as the C entry points receive them.
struct Call {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;  // null for dense pools
  const int *page_table, *positions;
  const unsigned char* active;
  void* out;
  int S, C, H, Hkv, hd, page, n_pages;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, typename TK, int TR, int STAGES>
int launch(const Call& c) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  const size_t smem = smem_bytes(sizeof(TK), kQuant, TR, c.hd, c.page, STAGES);
  auto kern = paged_attention_kernel<T, TK, TR, STAGES>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = c.C * (c.H / c.Hkv);
  dim3 grid(c.S, c.Hkv, (rows + TR - 1) / TR);
  kern<<<grid, kThreads, smem, c.stream>>>(
      static_cast<const T*>(c.q), static_cast<const TK*>(c.k_pool),
      static_cast<const TK*>(c.v_pool), c.k_scale, c.v_scale, c.page_table,
      c.positions, c.active, static_cast<T*>(c.out), c.C, c.H, c.Hkv, c.hd,
      c.page, c.n_pages, c.sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, typename TK, int TR>
int launch_stages(const Call& c) {
  // two page buffers (prefetch the next page during the current one's
  // math) where they fit, else one
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  if (smem_bytes(sizeof(TK), kQuant, TR, c.hd, c.page, 2) <=
      (size_t)smem_optin_limit())
    return launch<T, TK, TR, 2>(c);
  return launch<T, TK, TR, 1>(c);
}

template <typename T, typename TK>
int dispatch(const Call& c) {
  switch (tile_rows(c.C * (c.H / c.Hkv))) {
    case 16: return launch_stages<T, TK, 16>(c);
    case 8: return launch_stages<T, TK, 8>(c);
    case 4: return launch_stages<T, TK, 4>(c);
    case 2: return launch_stages<T, TK, 2>(c);
    default: return launch_stages<T, TK, 1>(c);
  }
}

}  // namespace

extern "C" {

// Dense pools of q's type. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch.
int dl4j_paged_attention(const void* q, const void* k_pool,
                         const void* v_pool, const int* page_table,
                         const int* positions, const unsigned char* active,
                         void* out, int dtype, int S, int C, int H, int Hkv,
                         int hd, int page, int n_pages, float sm_scale,
                         void* stream) {
  const Call c{q, k_pool, v_pool, nullptr, nullptr, page_table, positions,
               active, out, S, C, H, Hkv, hd, page, n_pages, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return dispatch<__nv_bfloat16, __nv_bfloat16>(c);
  return dispatch<float, float>(c);
}

// int8 pools with their f32 scale pools (P+1, Hkv, page); q and out of
// `dtype` as above. Returns the cudaError_t of the launch.
int dl4j_paged_attention_int8(const void* q, const void* k_pool,
                              const void* v_pool, const float* k_scale,
                              const float* v_scale, const int* page_table,
                              const int* positions,
                              const unsigned char* active, void* out,
                              int dtype, int S, int C, int H, int Hkv, int hd,
                              int page, int n_pages, float sm_scale,
                              void* stream) {
  const Call c{q, k_pool, v_pool, k_scale, v_scale, page_table, positions,
               active, out, S, C, H, Hkv, hd, page, n_pages, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return dispatch<__nv_bfloat16, int8_t>(c);
  return dispatch<float, int8_t>(c);
}

// Dynamic shared memory one block of this launch needs at least (one page
// buffer), in bytes. int8: 1 for int8 pools, 0 for pools of q's type.
size_t dl4j_paged_attention_smem_bytes(int dtype, int int8, int C, int H,
                                       int Hkv, int hd, int page) {
  const size_t elem = int8 ? 1 : dtype == 1 ? 2 : 4;
  return smem_bytes(elem, int8 != 0, tile_rows(C * (H / Hkv)), hd, page, 1);
}

}  // extern "C"
