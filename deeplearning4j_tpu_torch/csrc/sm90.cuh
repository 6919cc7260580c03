// Hopper (sm_90a) building blocks shared by the port's kernels:
// mbarriers (arrivals on a peer block's too), TMA tensor loads (plain and
// cluster multicast), cluster barriers, loads from and stores to a peer
// block's shared memory, counters that the blocks of a cooperative launch
// wait on, named barriers, the split of f32 operands into TF32 parts,
// wgmma (bf16 and TF32) with shared-memory descriptors, and the host-side
// construction of TMA tensor maps through the driver entry point (so a
// library needs no -lcuda).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialisations visible to the cluster and to the async proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive when `pred` holds, the predicate inside the instruction (no
// lane-dependent branch while wgmma operations are in flight)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"((uint32_t)pred)
      : "memory");
}

// arrive on the barrier at the same shared-memory offset in block `cta`
// of this cluster, when `pred` holds; the predicate stays inside the
// instruction, so no lane-dependent branch sits between wgmma operations
// still in flight. The arrival releases at CTA scope (the default): it
// follows a wgmma wait, so the stage's reads are done, and a release at
// cluster scope would fence every earlier store of the thread at each
// arrival
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta,
                                                    bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 remote;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p mapa.shared::cluster.u32 remote, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(cta), "r"((uint32_t)pred)
      : "memory");
}

// mbar_expect_tx when `pred` holds (the predicate inside the instruction)
__device__ __forceinline__ void mbar_expect_tx_if(uint64_t* bar,
                                                  uint32_t bytes, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes), "r"((uint32_t)pred)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. The spin loop is
// inside the PTX, so the compiler sees no divergent branch around it (a C
// loop there makes ptxas serialize the wgmma in flight). A wait that
// lasts 4 s means an arrival or a load was lost: the thread traps, so the
// launch fails with an error instead of hanging the card. CLUSTER waits
// acquire at cluster scope (arrivals from other blocks).
#define SM90_MBAR_WAIT(SEM)                                              \
  asm volatile(                                                          \
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"                           \
      "mov.u64 t0, %%globaltimer;\n"                                     \
      "WAIT:\n"                                                          \
      "mbarrier.try_wait.parity" SEM ".shared::cta.b64 p, [%0], %1;\n"   \
      "@p bra DONE;\n"                                                   \
      "mov.u64 t1, %%globaltimer;\n"                                     \
      "sub.u64 t1, t1, t0;\n"                                            \
      "setp.gt.u64 p, t1, 4000000000;\n"                                 \
      "@p trap;\n"                                                       \
      "bra WAIT;\n"                                                      \
      "DONE:\n}\n" ::"r"(smem_u32(bar)),                                 \
      "r"(parity)                                                        \
      : "memory")

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  SM90_MBAR_WAIT("");
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  SM90_MBAR_WAIT(".acquire.cluster");
}

// -------------------------------------------------------------- cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster arrives, then waits; the
// release/acquire pair orders each block's earlier memory operations
// before the others' later ones
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// ------------------------------------------------------- grid counters
// A counter in global memory that the blocks of one launch raise and wait
// for, across clusters (only under a cooperative launch, which makes
// every block resident). flag_arrive publishes the block's earlier
// memory operations (ordered before the call by a barrier of the block)
// at GPU scope; flag_wait spins until the counter reaches `target`, then
// orders the reads that follow, TMA loads included, after that. A wait
// that lasts 4 s traps, as mbar_wait does.
__device__ __forceinline__ void flag_arrive(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p)
               : "memory");
}

__device__ __forceinline__ void flag_wait(const unsigned* p,
                                          unsigned target) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 v;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "FWAIT:\n"
      "ld.acquire.gpu.global.u32 v, [%0];\n"
      "setp.ge.u32 p, v, %1;\n"
      "@p bra FDONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 4000000000;\n"
      "@p trap;\n"
      "bra FWAIT;\n"
      "FDONE:\n"
      "fence.proxy.async.global;\n}\n" ::"l"(p),
      "r"(target)
      : "memory");
}

// 16 bytes of the shared memory of block `cta` of this cluster, at the
// offset where `p` lies in this block's (distributed shared memory); a
// cluster barrier orders the peer's stores before the load
__device__ __forceinline__ float4 ld_cluster_v4(const void* p, uint32_t cta) {
  float4 v;
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %4, %5;\n"
      "ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [remote];\n}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(smem_u32(p)), "r"(cta)
      : "memory");
  return v;
}

// the address in the shared memory of block `cta` of this cluster at the
// offset where `p` lies in this block's (for st_async_v4)
__device__ __forceinline__ uint32_t map_cluster(const void* p, uint32_t cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(cta));
  return r;
}

// 16 bytes stored asynchronously into a peer block's shared memory at
// `addr` (of map_cluster), their bytes counted on the peer's barrier at
// `bar` (of map_cluster) as a TMA load's are: the storing thread neither
// fences nor waits, and the peer's threads that wait on that barrier's
// phase (mbar_wait_cluster; the peer arms it with mbar_expect_tx) see
// the bytes
__device__ __forceinline__ void st_async_v4(uint32_t addr, float4 v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// order this thread's generic-proxy writes before later async-proxy
// (TMA) reads of the same memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// ------------------------------------------------------------------ TMA
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// one box delivered to the same shared-memory offset, and its bytes to
// the same barrier, in every block of `mask` in this cluster
__device__ __forceinline__ void tma_load_3d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar,
                                                      uint16_t mask, int c0,
                                                      int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a contiguous run of `bytes` (a multiple of 16, both ends 16-byte
// aligned) copied by the bulk-copy engine, its bytes counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// stores of a swizzled shared-memory box through a tensor map (the async
// proxy; clipped at the map's bounds); one bulk group per commit
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups are pending
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// the same, for their reads of shared memory only
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// order this thread's generic-proxy writes of shared memory before later
// async-proxy reads of it (a TMA store)
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// ------------------------------------------------------------ split TF32
// An f32 operand on the TF32 tensor cores as two TF32 parts, x = big +
// small, big = x rounded to TF32 (10 explicit mantissa bits) to nearest,
// ties away from zero; small = the rest, rounded the same way (to 2^-22
// of x in all). Three products, small terms first (a_small b_big + a_big
// b_small + a_big b_big), then give an f32-accurate product.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The same rounding in two integer operations (half a unit of the 13
// dropped bits added to the magnitude, then those bits cleared) where the
// argument is finite: the small part x - big of a finite x. (For an
// infinite or NaN x, big carries the non-finite value and small does not
// matter.)
__device__ __forceinline__ uint32_t tf32_rna_finite(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (to 2^-22 of x), both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna_finite(x - __uint_as_float(big));
}

// ----------------------------------------------------------------- wgmma
// Descriptor of a tile written by TMA with a 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO); `lbo` is the distance
// between 64-element column blocks of an MN-major operand (unused by a
// K-major one). Tiles start on 1024-byte boundaries; a k step of 16
// elements inside a row advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile,
                                               uint32_t lbo = 16) {
  const uint32_t a = smem_u32(tile);
  uint64_t d = (uint64_t)((a & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of accumulator registers across
// an asynchronous wgmma's issue or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SM90_D16(i) SM90_D4(i), SM90_D4(i + 4), SM90_D4(i + 8), SM90_D4(i + 12)
#define SM90_D32 SM90_D16(0), SM90_D16(16)
#define SM90_R32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16) . B^T, A and B K-major in shared
// memory (B stored as 64 rows of k); d is zeroed first when !accumulate.
// Accumulator layout as wgmma_m64n128_ss's, over 8 column blocks of 8.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

#define SM90_D64 SM90_D16(0), SM90_D16(16), SM90_D16(32), SM90_D16(48)
#define SM90_R64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) (+)= A (64 x 16) . B^T, A and B K-major in shared
// memory (B stored as 128 rows of k); d is zeroed first when !accumulate.
// Accumulator layout (warp w of the warpgroup, lane 4g + t): d[4j + e]
// holds row 16w + g + 8 (e >> 1), column 8j + 2t + (e & 1).
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

#define SM90_D128 SM90_D64, SM90_D16(64), SM90_D16(80), SM90_D16(96), \
                  SM90_D16(112)
#define SM90_R128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "  \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "  \
  "%124, %125, %126, %127}"

// d (64 x 256, f32) (+)= A (64 x 16) . B^T, A and B K-major in shared
// memory (B stored as 256 rows of k); d is zeroed first when !accumulate.
// Accumulator layout as wgmma_m64n128_ss's, over 32 column blocks of 8.
__device__ __forceinline__ void wgmma_m64n256_ss(float (&d)[128], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_R128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : SM90_D128
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) (+)= A (64 x 8) . B^T on TF32 operands (f32 registers
// whose low 13 bits the tensor cores ignore), A and B K-major in shared
// memory (B stored as 128 rows of k; a row of a 128-byte-swizzled tile
// holds 32 values, a k step of 8 advances the start address by 32 bytes,
// as for bf16); d is zeroed first when !accumulate. Accumulator layout as
// wgmma_m64n128_ss's.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     uint64_t da, uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " SM90_R64
      ", %64, %65, p, 1, 1;\n}\n"
      : SM90_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

#define SM90_W4(i) "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3])
#define SM90_W16(i) SM90_W4(i), SM90_W4(i + 4), SM90_W4(i + 8), SM90_W4(i + 12)

// The same with d = A . B^T (the accumulator's earlier values ignored,
// and so not kept live by the compiler: a fresh accumulator)
__device__ __forceinline__ void wgmma_m64n128k8_tf32_zero(float (&d)[64],
                                                          uint64_t da,
                                                          uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " SM90_R64
      ", %64, %65, 0, 1, 1;\n"
      : SM90_W16(0), SM90_W16(16), SM90_W16(32), SM90_W16(48)
      : "l"(da), "l"(db));
}

// d (64 x 128) += A (64 x 16, registers: the m16n8k16 A fragment of each
// warp's 16 rows) . B, B MN-major in shared memory (16 rows of k, 128
// columns of n in two 64-column swizzled blocks `lbo` bytes apart)
__device__ __forceinline__ void wgmma_m64n128_rs_mn(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SM90_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define SM90_R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 32, f32) (+)= A (64 x 16) . B^T, A and B K-major in shared
// memory (B stored as 32 rows of k); d is zeroed first when !accumulate.
// Accumulator layout as wgmma_m64n128_ss's, over 4 column blocks of 8.
__device__ __forceinline__ void wgmma_m64n32_ss(float (&d)[16], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SM90_R16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : SM90_D16(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

#define SM90_D96 SM90_D64, SM90_D16(64), SM90_D16(80)
#define SM90_R96                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "   \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "   \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"

// d (64 x 192) += A (64 x 16, registers, as wgmma_m64n128_rs_mn's) . B, B
// MN-major in shared memory (16 rows of k, 192 columns of n in three
// 64-column swizzled blocks `lbo` bytes apart)
__device__ __forceinline__ void wgmma_m64n192_rs_mn(float (&d)[96],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " SM90_R96
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : SM90_D96
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same over 256 columns (four 64-column blocks)
__device__ __forceinline__ void wgmma_m64n256_rs_mn(float (&d)[128],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_R128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : SM90_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the named barrier `id` (1..15; 0 is __syncthreads'): `threads` threads,
// whole warps, arrive and wait; orders their shared-memory accesses
__device__ __forceinline__ void named_bar_sync(uint32_t id,
                                               uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of `rank` dimensions of bf16 or f32 elements (innermost
// first; strides in bytes of dimensions 1..rank-1), boxes of `box`
// elements, 128-byte swizzle (or none: `swizzle` false), out-of-bounds
// elements read as zero. Returns a cudaError_t.
inline int make_map(CUtensorMap* map, CUtensorMapDataType type,
                    const void* base, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box,
                    bool swizzle = true) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims,
                  strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline int make_map_bf16(CUtensorMap* map, const void* base, int rank,
                         const cuuint64_t* dims, const cuuint64_t* strides,
                         const cuuint32_t* box, bool swizzle = true) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims,
                  strides, box, swizzle);
}

inline int make_map_f32(CUtensorMap* map, const void* base, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rank, dims,
                  strides, box);
}

}  // namespace sm90
