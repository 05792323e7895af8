// K2.q8_0: q8_0 T=1 matvec, y (1, out_f) bf16 = x (1, in_f) . W^T with
// w = q * s per 32-column group (q int8, s bf16).
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec` for q8_0 at
// T=1: body `_q8_0_row_kernel_i8` (the JAX `_mm_i8` default, at every
// in_f). x is quantized per 32-column group to int8 (act_prep_kernel, the
// prep of K1); each group's code dot is an exact int32 sum taken with the
// signed-by-signed __dp4a, and y_r = sum_g (P_rg * sx_g) * s_rg.
//
// The sum runs in one fixed order, which the plain version
// (`q8_0_matvec_plain`) repeats, so the two agree bit for bit: lane l adds
// the terms of groups l, l+32, l+64, ... in turn, starting from 0, then the
// warp adds its 32 lane sums by xor shuffles over offsets 16, 8, 4, 2, 1.
// Every product and add is an explicit __fmul_rn / __fadd_rn, so nothing
// is contracted into an FMA.
//
// Bound on the H100: bytes (1 B/weight plus 2 B of bf16 scale per 32
// weights; the int8 x and its scales stay in L1/L2). Design: one warp per
// output row; a lane owns a whole 32-column group at a time and reads its
// 32 weight bytes as two 16-byte loads, so a warp streams 1 KiB of the row
// per step and no cross-lane combine precedes the scale products.
// Launch counter: ops/_build.launches["K2.q8_0"] (one per matvec).
#include "common.cuh"

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

__device__ __forceinline__ int dot16(const uint4 a, const uint4 b, int acc) {
    acc = __dp4a((int)a.x, (int)b.x, acc);
    acc = __dp4a((int)a.y, (int)b.y, acc);
    acc = __dp4a((int)a.z, (int)b.z, acc);
    return __dp4a((int)a.w, (int)b.w, acc);
}

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
q8_0_matvec_kernel(const int8_t* __restrict__ q,
                   const __nv_bfloat16* __restrict__ scale,
                   const int8_t* __restrict__ xq,
                   const float* __restrict__ sx,
                   __nv_bfloat16* __restrict__ y, int out_f, int in_f) {
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= out_f) return;  // whole warps exit together
    const int ng = in_f / 32;
    const int8_t* qrow = q + (size_t)row * in_f;
    const __nv_bfloat16* srow = scale + (size_t)row * ng;

    float acc = 0.f;
    for (int g = lane; g < ng; g += 32) {
        const uint4* w = reinterpret_cast<const uint4*>(qrow + g * 32);
        const uint4* xv = reinterpret_cast<const uint4*>(xq + g * 32);
        const int p = dot16(w[1], xv[1], dot16(w[0], xv[0], 0));
        // exact: |P| <= 32 * 127 * 127
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn((float)p, sx[g]),
                                       bf2f(srow[g])));
    }
    const float r = warp_sum(acc);
    if (lane == 0) y[row] = f2bf(r);
}

// x (in_f) bf16 -> xq (in_f) int8, sx (in_f/32) f32, xsum (in_f/32) bf16
KCPP_API int k2_q8_0_prep(const void* x, void* xq, void* sx, void* xsum,
                          int in_f, void* stream) {
    return (int)launch_act_prep<32>(x, xq, sx, xsum, in_f, 1,
                                    (cudaStream_t)stream);
}

KCPP_API int k2_q8_0_matvec(const void* q, const void* scale, const void* xq,
                            const void* sx, void* y, int out_f, int in_f,
                            void* stream) {
    dim3 grid((out_f + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    dim3 block(ROWS_PER_BLOCK * 32);
    q8_0_matvec_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const __nv_bfloat16*)scale, (const int8_t*)xq,
        (const float*)sx, (__nv_bfloat16*)y, out_f, in_f);
    return (int)cudaGetLastError();
}
