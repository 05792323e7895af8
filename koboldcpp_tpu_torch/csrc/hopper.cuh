// Hand-written PTX for Hopper (sm_90a): cp.async (16, 8 and 4 bytes, and
// 16 / 8 with zero fill) with commit / wait groups, the async-proxy fence,
// ldmatrix, shared-memory matrix descriptors, warpgroup MMA (wgmma, A from
// registers, B K-major or MN-major) and mma.sync m16n8k16 / m16n8k8,
// bf16 -> f32, mma.sync m16n8k32, s8 -> s32, and the cluster's
// distributed shared memory. Kept in one small header so that the
// nvcc build needs no CUTLASS / CuTe.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16 (8) bytes of which the first src_bytes are copied and the rest
// zero-filled: src_bytes 0 reads nothing and clears the destination
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 8 and 4 bytes through the L1 (.ca): fields whose rows are not 16-byte
// aligned
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src,
                                                int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix
// m, and thread t receives row t/4, columns 2(t%4), 2(t%4)+1 of each
// (.trans: rows 2(t%4), 2(t%4)+1 of column t/4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)) : "memory");
}

// two floats as one bf16x2 register, each rounded to nearest even; lo in
// the low half (the lower column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// orders this thread's generic-proxy shared-memory writes (cp.async
// included) before later async-proxy reads (wgmma operands)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads of an accumulator across a wait,
// or writes of a wgmma operand (accumulator or A fragment) past the fence
// that must follow them
__device__ __forceinline__ void pin(float& v) {
    asm volatile("" : "+f"(v) :: "memory");
}

__device__ __forceinline__ void pin(uint32_t& v) {
    asm volatile("" : "+r"(v) :: "memory");
}

// Matrix descriptor of a K-major operand in the 128-byte swizzle: rows of
// 64 bf16 (128 B), 8-row atoms of 1024 B (SBO), the atom 1024-aligned; the
// start address moves by 32 B per k16 step inside the atom.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
    return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Matrix descriptor of a K-major operand without swizzle: core matrices of
// 8 rows x 16 B, lbo the byte stride between core matrices along K, sbo
// between 8-row groups along M / N.
__device__ __forceinline__ uint64_t desc_plain(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((saddr & 0x3FFFFu) >> 4)
           | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16)
           | ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}

// Matrix descriptor of an MN-major operand in the 128-byte swizzle: atoms
// of 64 MN-contiguous bf16 (128 B) by 8 K-rows (1024 B, 1024-aligned),
// lbo the byte stride between atoms along MN, sbo between 8-row groups
// along K; the start address moves by 16 rows per k16 step.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t saddr, uint32_t lbo,
                                                  uint32_t sbo) {
    return (uint64_t)((saddr & 0x3FFFFu) >> 4)
           | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16)
           | ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | ((uint64_t)1 << 62);
}

// D (64 x N, f32) += A (64 x 16 bf16, registers: the m16n8k16 A fragment of
// each warp's 16 rows) . B (16 x N bf16 in shared memory: K-major, or
// MN-major with TB = 1)
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
          "n"(TB));
}

template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
          "n"(TB));
}

// D (16 x 8, f32) += A (16 x 16 bf16, row) . B (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the same on four consecutive floats of a flat fragment array
__device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (16 x 8, s32) = A (16 x 32 s8, row) . B (32 x 8 s8, col), exact; A
// register i: row t/4 (+8 for i odd), k 4(t%4)..+3 (+16 for i >= 2); b0 / b1:
// k 4(t%4)..+3 / 16+4(t%4)..+3 of column t/4; D as mma16816's
__device__ __forceinline__ void mma16832_s8(int (&d)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
    d[0] = d[1] = d[2] = d[3] = 0;
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (16 x 8, s32) = A (16 x 16 s8, row) . B (16 x 8 s8, col), exact; a0 /
// a1: rows t/4 / t/4 + 8, k 4(t%4)..+3; b: k 4(t%4)..+3 of column t/4; D as
// mma16816's
__device__ __forceinline__ void mma16816_s8(int (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a0), "r"(a1), "r"(b), "r"(0));
}

// cp_async_wait with a count known at run time only (0..3; more waits for 3)
__device__ __forceinline__ void cp_async_wait_n(int n) {
    switch (n) {
        case 0: cp_async_wait<0>(); break;
        case 1: cp_async_wait<1>(); break;
        case 2: cp_async_wait<2>(); break;
        default: cp_async_wait<3>(); break;
    }
}

// D (16 x 8, f32) += A (16 x 8 bf16, row) . B (8 x 8 bf16, col); A
// registers: rows t/4 and t/4 + 8, k 2(t%4)..+1; b: k 2(t%4)..+1 of
// column t/4; D as mma16816's
__device__ __forceinline__ void mma1688(float (&d)[4], uint32_t a0,
                                        uint32_t a1, uint32_t b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(b));
}

// thread block clusters: this block's rank, a peer block's address of a
// shared-memory location, stores there, and the cluster barrier halves
__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

__device__ __forceinline__ uint32_t peer_smem(const void* p, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
    return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
    asm volatile("st.shared::cluster.u32 [%0], %1;\n" :: "r"(addr), "r"(v)
                 : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint16_t v) {
    asm volatile("st.shared::cluster.u16 [%0], %1;\n" :: "r"(addr), "h"(v)
                 : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// d = a * b on two bf16 lanes, rounded once
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

// d = a * b + c on two bf16 lanes, rounded once
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b,
                                               uint32_t c) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}
