// Paged attention for the serving path: the decode step (C = 1) and the
// chunked-prefill chunk (C = prefill_chunk), on Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_paged_attention.py
// ::_paged_kernel (dense branch). Same contract: q (S, C, H, hd); K pool
// (P+1, Hkv, hd, page) and V pool (P+1, Hkv, page, hd), page 0 the trash
// page; page_table (S, n_pages) int32; positions (S,) int32; active (S,)
// bool or null. Row c of slot s attends to cache entries
// <= positions[s] + c, read page by page through page_table[s, j]. GQA
// folds the G = H / Hkv query heads of one KV head into the rows of one
// tile, as (c, g). Inactive slots and fully masked rows give 0. f32 and
// bf16; scores, the online-softmax state (m, l) and the accumulator are
// f32; the output is written in q's type.
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

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // ops/attention.py NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// Issue the copies of one K page and one V page (n elements each) as one
// group. n * sizeof(T) is a multiple of 16 and every pointer is 16-byte
// aligned (checked by the wrapper and by the shared-memory layout).
template <typename T>
__device__ __forceinline__ void stage_page(T* sK, T* sV, const T* k_src,
                                           const T* v_src, int n) {
  const int nv = n * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    cp_async16(reinterpret_cast<int4*>(sK) + i,
               reinterpret_cast<const int4*>(k_src) + i);
    cp_async16(reinterpret_cast<int4*>(sV) + i,
               reinterpret_cast<const int4*>(v_src) + i);
  }
  cp_async_commit();
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

// Dynamic shared memory of one block: `stages` K and V page buffers, then
// the f32 tiles q^T (hd, TR), scores (TR, page), probabilities^T
// (page, TR), acc (TR, hd) and the per-row m, l, corr.
size_t smem_bytes(size_t elem, int tr, int hd, int page, int stages) {
  return (size_t)stages * 2 * hd * page * elem +
         ((size_t)2 * tr * hd + (size_t)2 * tr * page + 3 * (size_t)tr) *
             sizeof(float);
}

template <typename T, int TR, int STAGES>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pool,
                           const T* __restrict__ v_pool,
                           const int* __restrict__ page_table,
                           const int* __restrict__ positions,
                           const unsigned char* __restrict__ active,
                           T* __restrict__ out, int C, int H, int Hkv, int hd,
                           int page, int n_pages, float sm_scale) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / Hkv;
  const int r0 = blockIdx.z * TR;  // first row (c * G + g) of this tile
  const int tr = min(TR, C * G - r0);
  const int tid = threadIdx.x;
  const size_t tile = (size_t)hd * page;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);        // STAGES x (hd, page)
  T* sV = sK + STAGES * tile;                    // STAGES x (page, hd)
  float* sQt = reinterpret_cast<float*>(sV + STAGES * tile);  // (hd, TR)
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
    const size_t src =
        ((size_t)page_table[(size_t)s * n_pages + j] * Hkv + h) * tile;
    stage_page(sK + buf * tile, sV + buf * tile, k_pool + src, v_pool + src,
               (int)tile);
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
    const T* cK = sK + buf * tile;
    const T* cV = sV + buf * tile;

    // scores (TR, page) = q . K * scale, masked by position
    for (int kk = tid; kk < page; kk += blockDim.x) {
      float a[TR];
#pragma unroll
      for (int rr = 0; rr < TR; ++rr) a[rr] = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float kv = to_f32(cK[d * page + kk]);
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
        const float vv = to_f32(cV[kk * hd + d]);
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

template <typename T, int TR, int STAGES>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* page_table, const int* positions,
           const unsigned char* active, void* out, int S, int C, int H,
           int Hkv, int hd, int page, int n_pages, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T), TR, hd, page, STAGES);
  auto kern = paged_attention_kernel<T, TR, STAGES>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = C * (H / Hkv);
  dim3 grid(S, Hkv, (rows + TR - 1) / TR);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), page_table, positions, active,
      static_cast<T*>(out), C, H, Hkv, hd, page, n_pages, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int TR>
int launch_stages(const void* q, const void* k_pool, const void* v_pool,
                  const int* page_table, const int* positions,
                  const unsigned char* active, void* out, int S, int C, int H,
                  int Hkv, int hd, int page, int n_pages, float sm_scale,
                  cudaStream_t stream) {
  // two page buffers (prefetch the next page during the current one's
  // math) where they fit, else one
  if (smem_bytes(sizeof(T), TR, hd, page, 2) <= (size_t)smem_optin_limit())
    return launch<T, TR, 2>(q, k_pool, v_pool, page_table, positions, active,
                            out, S, C, H, Hkv, hd, page, n_pages, sm_scale,
                            stream);
  return launch<T, TR, 1>(q, k_pool, v_pool, page_table, positions, active,
                          out, S, C, H, Hkv, hd, page, n_pages, sm_scale,
                          stream);
}

template <typename T>
int dispatch(int tr, const void* q, const void* k_pool, const void* v_pool,
             const int* page_table, const int* positions,
             const unsigned char* active, void* out, int S, int C, int H,
             int Hkv, int hd, int page, int n_pages, float sm_scale,
             cudaStream_t stream) {
#define DL4J_PA_LAUNCH(N)                                                    \
  return launch_stages<T, N>(q, k_pool, v_pool, page_table, positions,       \
                             active, out, S, C, H, Hkv, hd, page, n_pages,    \
                             sm_scale, stream)
  switch (tr) {
    case 16: DL4J_PA_LAUNCH(16);
    case 8: DL4J_PA_LAUNCH(8);
    case 4: DL4J_PA_LAUNCH(4);
    case 2: DL4J_PA_LAUNCH(2);
    default: DL4J_PA_LAUNCH(1);
  }
#undef DL4J_PA_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int dl4j_paged_attention(const void* q, const void* k_pool,
                         const void* v_pool, const int* page_table,
                         const int* positions, const unsigned char* active,
                         void* out, int dtype, int S, int C, int H, int Hkv,
                         int hd, int page, int n_pages, float sm_scale,
                         void* stream) {
  const int tr = tile_rows(C * (H / Hkv));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(tr, q, k_pool, v_pool, page_table,
                                   positions, active, out, S, C, H, Hkv, hd,
                                   page, n_pages, sm_scale, st);
  return dispatch<float>(tr, q, k_pool, v_pool, page_table, positions,
                         active, out, S, C, H, Hkv, hd, page, n_pages,
                         sm_scale, st);
}

// Dynamic shared memory one block of this launch needs at least (one page
// buffer), in bytes.
size_t dl4j_paged_attention_smem_bytes(int dtype, int C, int H, int Hkv,
                                       int hd, int page) {
  return smem_bytes(dtype == 1 ? 2 : 4, tile_rows(C * (H / Hkv)), hd, page,
                    1);
}

}  // extern "C"
