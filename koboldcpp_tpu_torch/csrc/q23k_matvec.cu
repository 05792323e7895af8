// K12: q2_k / q3_k T=1 matvec, y (1, out_f) bf16 = x (1, in_f) . W^T with
// w = q2 * s - m (q2_k) or (q3 - 4) * s (q3_k) per 16-column group.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec` for q2_k and
// q3_k at T=1: bodies `_q2k_row_kernel_i8` / `_q3k_row_kernel_i8` (in_f >=
// 512) and `_q2k_row_kernel` / `_q3k_row_kernel` (bf16 activations, in_f <
// 512).
//
// i8 variant: x is quantized per 16-column group to int8 (act_prep_kernel);
// the codes (q2 0..3, q3 0..7) dot the int8 codes exactly in int32 via
// __dp4a, and the affine part is an exact group-sum term over the bf16
// group sums xs: y_r = sum_g sx_g * s_rg * P_rg - sum_g xs_g * m_rg (q2_k)
// or - 4 * sum_g xs_g * s_rg (q3_k).
// bf16 variant: P_rg is the exact f32 dot of bf16 x with the JAX kernels'
// magic-number values over their power of two (q2 + 4, q3 + 8), so the
// constant lands on the rounded group sum as there: y_r = sum_g s_rg * P_rg
// - 4 * sum_g xs_g * s_rg - sum_g xs_g * m_rg (q2_k) or
// - 12 * sum_g xs_g * s_rg (q3_k).
//
// Layout (ops/linear.py): qs (out_f, in_f/4) is ggml's raw 2-bit stream,
// element 256s+128h+32j+l in bits 2j..2j+1 of byte 64s+32h+l; q3_k's hmask
// (out_f, in_f/8) is ggml's raw high-bit mask, bit 4h+j of byte 32s+l;
// scale / min (out_f, in_f/16) bf16 in logical group order.
//
// Bound on the H100: bytes (0.25 B/weight of qs, 0.125 of hmask, plus 2 or
// 4 B of bf16 scale and min per 16 weights). Design, as K2 (q6_k): one warp
// per output row; a lane owns 16 values of l in one half of a superblock,
// i.e. one whole 16-column group in each of the four bit planes, reading 16
// bytes of qs (and 16 of hmask), so no cross-lane combine precedes the
// scale products.
// K17b.q2_k / .q3_k (li set: layer li of layer-stacked fields, the scan
// decode path) replace `_packed_matvec_stacked` for these kinds: the same
// bodies with the weight pointers moved to layer li (Stacked, common.cuh).
// Launch counters: ops/_build.launches["K12.q2_k"], ["K12.q3_k"],
// ["K17b.q2_k"], ["K17b.q3_k"].
#include "common.cuh"

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

template <bool Q3, bool I8>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
q23k_matvec_kernel(const uint8_t* __restrict__ qs,
                   const uint8_t* __restrict__ hmask,
                   const __nv_bfloat16* __restrict__ scale,
                   const __nv_bfloat16* __restrict__ mn,
                   const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ xq,
                   const float* __restrict__ sx,
                   const __nv_bfloat16* __restrict__ xsum,
                   __nv_bfloat16* __restrict__ y, int out_f, int in_f,
                   Stacked stk) {
    qs = stk.at(qs, 0);
    hmask = stk.at(hmask, 1);
    scale = stk.at(scale, 2);
    mn = stk.at(mn, 3);
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= out_f) return;
    const int nchunk = in_f / 64;  // (superblock, half, 16-l block) chunks
    const uint8_t* qrow = qs + (size_t)row * (in_f / 4);
    const uint8_t* hrow = Q3 ? hmask + (size_t)row * (in_f / 8) : nullptr;
    const __nv_bfloat16* srow = scale + (size_t)row * (in_f / 16);
    const __nv_bfloat16* mrow = Q3 ? nullptr : mn + (size_t)row * (in_f / 16);

    float acc = 0.f, accx = 0.f, accm = 0.f;
    for (int c = lane; c < nchunk; c += 32) {
        const int sb = c >> 2, h = (c >> 1) & 1, k = c & 1;
        const uint4 a = *reinterpret_cast<const uint4*>(
            qrow + sb * 64 + h * 32 + k * 16);
        const uint32_t as[4] = {a.x, a.y, a.z, a.w};
        uint32_t hs[4] = {0u, 0u, 0u, 0u};
        if (Q3) {
            const uint4 hv = *reinterpret_cast<const uint4*>(
                hrow + sb * 32 + k * 16);
            hs[0] = hv.x; hs[1] = hv.y; hs[2] = hv.z; hs[3] = hv.w;
        }
        const int col0 = sb * 256 + h * 128 + k * 16;  // plane j adds 32j
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = col0 + 32 * j;
            const int g = col / 16;
            uint32_t v[4];
#pragma unroll
            for (int w = 0; w < 4; ++w) {
                v[w] = (as[w] >> (2 * j)) & 0x03030303u;
                if (Q3)  // bit 4h+j of each hmask byte -> bit 2 of that byte
                    v[w] |= ((hs[w] >> (4 * h + j)) & 0x01010101u) << 2;
            }
            const float s = bf2f(srow[g]);
            if (I8) {
                const uint4 xv = *reinterpret_cast<const uint4*>(xq + col);
                int p = __dp4a((int)v[0], (int)xv.x, 0);
                p = __dp4a((int)v[1], (int)xv.y, p);
                p = __dp4a((int)v[2], (int)xv.z, p);
                p = __dp4a((int)v[3], (int)xv.w, p);
                acc += (float)p * sx[g] * s;
            } else {
                const float off = Q3 ? 8.f : 4.f;
                float p = 0.f;
#pragma unroll
                for (int e = 0; e < 16; ++e)
                    p += ((float)((v[e >> 2] >> (8 * (e & 3))) & 0xFFu) + off)
                         * bf2f(x[col + e]);
                acc += s * p;
            }
            const float xs = bf2f(xsum[g]);
            accx += xs * s;
            if (!Q3) accm += xs * bf2f(mrow[g]);
        }
    }
    // the affine constant per group scale: q3_k i8 4, bf16 12; q2_k i8 0,
    // bf16 4
    const float cx = Q3 ? (I8 ? 4.f : 12.f) : (I8 ? 0.f : 4.f);
    const float t = warp_sum(acc) - cx * warp_sum(accx) - warp_sum(accm);
    if (lane == 0) y[row] = f2bf(t);
}

// x (in_f) bf16 -> xq (in_f) int8, sx (in_f/16) f32, xsum (in_f/16) bf16
KCPP_API int k12_q23k_prep(const void* x, void* xq, void* sx, void* xsum,
                           int in_f, int quant, void* stream) {
    return (int)launch_act_prep<16>(x, xq, sx, xsum, in_f, quant,
                                    (cudaStream_t)stream);
}

// q3 = 0: q2_k (qs, scale, min; hmask unused); q3 = 1: q3_k (qs, hmask,
// scale; min unused). in_f % 256 == 0. li set (K17b.q2_k / .q3_k): layer
// li[0] of stacked fields, n0..n3 the per-layer element counts of qs,
// hmask, scale and min.
KCPP_API int k12_q23k_matvec(int q3, const void* qs, const void* hmask,
                             const void* scale, const void* mn,
                             const void* x, const void* xq, const void* sx,
                             const void* xsum, void* y, int out_f, int in_f,
                             int i8, STACKED_PARAMS, void* stream) {
    dim3 grid((out_f + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    dim3 block(ROWS_PER_BLOCK * 32);
    cudaStream_t st = (cudaStream_t)stream;
#define K12_ARGS (const uint8_t*)qs, (const uint8_t*)hmask, \
        (const __nv_bfloat16*)scale, (const __nv_bfloat16*)mn, \
        (const __nv_bfloat16*)x, (const int8_t*)xq, (const float*)sx, \
        (const __nv_bfloat16*)xsum, (__nv_bfloat16*)y, out_f, in_f, \
        STACKED_ARG
    if (q3) {
        if (i8)
            q23k_matvec_kernel<true, true><<<grid, block, 0, st>>>(K12_ARGS);
        else
            q23k_matvec_kernel<true, false><<<grid, block, 0, st>>>(K12_ARGS);
    } else {
        if (i8)
            q23k_matvec_kernel<false, true><<<grid, block, 0, st>>>(K12_ARGS);
        else
            q23k_matvec_kernel<false, false><<<grid, block, 0, st>>>(K12_ARGS);
    }
#undef K12_ARGS
    return (int)cudaGetLastError();
}
