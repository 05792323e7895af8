// K2.q8_0: q8_0 T=1 matvec, y (1, out_f) bf16 = x (1, in_f) . W^T with
// w = q * s per 32-column group (q int8, s bf16); K2.q8_0_bf16: the same
// with bf16 activations.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec` for q8_0 at
// T=1: bodies `_q8_0_row_kernel_i8` (the JAX `_mm_i8` default, at every
// in_f) and `_q8_0_row_kernel` (KCPP_MM_I8=0). i8: x is quantized per
// 32-column group to int8 (act_prep_kernel, the prep of K1); each group's
// code dot is an exact int32 sum taken with the signed-by-signed __dp4a,
// P_rg = that sum * sx_g. bf16: P_rg is the f32 sum of the products
// x_c * q_c (each exact in f32: 8 + 7 significant bits), added in column
// order from 0. Then y_r = sum_g P_rg * s_rg.
//
// The sums run in one fixed order, which the plain version
// (`q8_0_matvec_plain`) repeats, so the two agree bit for bit: lane l adds
// the terms of groups l, l+32, l+64, ... in turn, starting from 0, then the
// warp adds its 32 lane sums by xor shuffles over offsets 16, 8, 4, 2, 1.
// Every product and add is an explicit __fmul_rn / __fadd_rn, so nothing
// is contracted into an FMA.
//
// Bound on the H100: bytes (1 B/weight plus 2 B of bf16 scale per 32
// weights; x and its int8 codes and scales stay in L1/L2). Design: one
// warp per output row; a lane owns a whole 32-column group at a time and
// reads its 32 weight bytes as two 16-byte loads (the bf16 body also its 64
// bytes of x as four), so a warp streams 1 KiB of the row per step and no
// cross-lane combine precedes the scale products.
// K17b.q8_0 (li set: layer li of layer-stacked fields, the scan decode
// path) replaces `_packed_matvec_stacked` for q8_0: the same bodies with
// the weight pointers moved to layer li (Stacked, common.cuh).
// Launch counters: ops/_build.launches["K2.q8_0"] (int8),
// ["K2.q8_0_bf16"] (bf16), ["K17b.q8_0"] / ["K17b.q8_0_bf16"] (stacked),
// one per matvec.
#include "common.cuh"

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

__device__ __forceinline__ int dot16(const uint4 a, const uint4 b, int acc) {
    acc = __dp4a((int)a.x, (int)b.x, acc);
    acc = __dp4a((int)a.y, (int)b.y, acc);
    acc = __dp4a((int)a.z, (int)b.z, acc);
    return __dp4a((int)a.w, (int)b.w, acc);
}

template <bool I8>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
q8_0_matvec_kernel(const int8_t* __restrict__ q,
                   const __nv_bfloat16* __restrict__ scale,
                   const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ xq,
                   const float* __restrict__ sx,
                   __nv_bfloat16* __restrict__ y, int out_f, int in_f,
                   Stacked stk) {
    q = stk.at(q, 0);
    scale = stk.at(scale, 1);
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= out_f) return;  // whole warps exit together
    const int ng = in_f / 32;
    const int8_t* qrow = q + (size_t)row * in_f;
    const __nv_bfloat16* srow = scale + (size_t)row * ng;

    float acc = 0.f;
    for (int g = lane; g < ng; g += 32) {
        const uint4* w = reinterpret_cast<const uint4*>(qrow + g * 32);
        float pg;
        if (I8) {
            const uint4* xv = reinterpret_cast<const uint4*>(xq + g * 32);
            const int p = dot16(w[1], xv[1], dot16(w[0], xv[0], 0));
            // exact: |P| <= 32 * 127 * 127
            pg = __fmul_rn((float)p, sx[g]);
        } else {
            const uint4 w0 = w[0], w1 = w[1];
            const uint32_t ws[8] = {w0.x, w0.y, w0.z, w0.w,
                                    w1.x, w1.y, w1.z, w1.w};
            const uint4* xv = reinterpret_cast<const uint4*>(x + g * 32);
            pg = 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const uint4 xx = xv[i];
                const uint32_t xs[4] = {xx.x, xx.y, xx.z, xx.w};
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const int c = 8 * i + k;
                    const float xf = __uint_as_float(
                        ((xs[k >> 1] >> (16 * (k & 1))) & 0xFFFFu) << 16);
                    const float qf = (float)(int8_t)(
                        (ws[c >> 2] >> (8 * (c & 3))) & 0xFFu);
                    pg = __fadd_rn(pg, __fmul_rn(xf, qf));
                }
            }
        }
        acc = __fadd_rn(acc, __fmul_rn(pg, bf2f(srow[g])));
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

// i8 = 1: xq / sx from k2_q8_0_prep (x unused); i8 = 0: bf16 x (xq / sx
// unused). in_f % 32 == 0. li set (K17b.q8_0): layer li[0] of stacked
// fields, n0 / n1 the per-layer element counts of q and scale.
KCPP_API int k2_q8_0_matvec(const void* q, const void* scale, const void* x,
                            const void* xq, const void* sx, void* y,
                            int out_f, int in_f, int i8, STACKED_PARAMS,
                            void* stream) {
    dim3 grid((out_f + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    dim3 block(ROWS_PER_BLOCK * 32);
    cudaStream_t st = (cudaStream_t)stream;
#define K2_ARGS (const int8_t*)q, (const __nv_bfloat16*)scale, \
        (const __nv_bfloat16*)x, (const int8_t*)xq, (const float*)sx, \
        (__nv_bfloat16*)y, out_f, in_f, STACKED_ARG
    if (i8)
        q8_0_matvec_kernel<true><<<grid, block, 0, st>>>(K2_ARGS);
    else
        q8_0_matvec_kernel<false><<<grid, block, 0, st>>>(K2_ARGS);
#undef K2_ARGS
    return (int)cudaGetLastError();
}
