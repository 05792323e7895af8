// K2: q6_k T=1 matvec, y (1, out_f) bf16 = x (1, in_f) . W^T with
// w = (q6 - 32) * s per 16-column group.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec` for q6_k at
// T=1: body `_q6k_row_kernel_i8` (in_f >= 512) and `_q6k_row_kernel`
// (bf16 activations, in_f < 512).
//
// i8 variant: x is quantized per 16-column group to int8 (act_prep_kernel);
// the 6-bit values (nibble | 2 high bits, 0..63) dot the int8 codes
// exactly in int32 via __dp4a, and the -32 offset folds into an exact
// group-sum term: y_r = sum_g sx_g * s_rg * P_rg - 32 * sum_g xsum_g * s_rg.
// bf16 variant: P_rg is the exact f32 dot of bf16 x with the 6-bit values.
//
// Bound on the H100: bytes (0.75 B/weight of ql+qh, plus 2 B of bf16 scale
// per 16 weights). Design: one warp per output row; a lane owns 16 values
// of l in one half of a superblock, i.e. one whole 16-column group in each
// of the four bit planes, reading 16 bytes of each ql plane pair and 16
// bytes of qh, so no cross-lane combine precedes the scale products.
// Launch counter: ops/_build.launches["K2"] (one per matvec).
#include "common.cuh"

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

template <bool I8>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
q6k_matvec_kernel(const uint8_t* __restrict__ ql,
                  const uint8_t* __restrict__ qh,
                  const __nv_bfloat16* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ xq,
                  const float* __restrict__ sx,
                  const __nv_bfloat16* __restrict__ xsum,
                  __nv_bfloat16* __restrict__ y, int out_f, int in_f) {
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= out_f) return;
    const int nchunk = in_f / 64;  // (superblock, half, 16-l block) chunks
    const uint8_t* qlrow = ql + (size_t)row * (in_f / 2);
    const uint8_t* qhrow = qh + (size_t)row * (in_f / 4);
    const __nv_bfloat16* srow = scale + (size_t)row * (in_f / 16);

    float acc = 0.f, accx = 0.f;
    for (int c = lane; c < nchunk; c += 32) {
        const int sb = c >> 2, h = (c >> 1) & 1, k = c & 1;
        const uint4 a = *reinterpret_cast<const uint4*>(
            qlrow + sb * 128 + h * 64 + k * 16);          // planes 0 / 2
        const uint4 bq = *reinterpret_cast<const uint4*>(
            qlrow + sb * 128 + h * 64 + 32 + k * 16);     // planes 1 / 3
        const uint4 hq = *reinterpret_cast<const uint4*>(
            qhrow + sb * 64 + h * 32 + k * 16);
        const uint32_t as[4] = {a.x, a.y, a.z, a.w};
        const uint32_t bs[4] = {bq.x, bq.y, bq.z, bq.w};
        const uint32_t hs[4] = {hq.x, hq.y, hq.z, hq.w};
        const int col0 = sb * 256 + h * 128 + k * 16;  // plane j adds 32j
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = col0 + 32 * j;
            const int g = col / 16;
            uint32_t v[4];
#pragma unroll
            for (int w = 0; w < 4; ++w) {
                const uint32_t lo = (j & 1) ? bs[w] : as[w];
                const uint32_t nib = (j >= 2) ? ((lo >> 4) & 0x0F0F0F0Fu)
                                              : (lo & 0x0F0F0F0Fu);
                // bits 2j..2j+1 of each qh byte -> bits 4..5 of that byte
                const uint32_t hi = (j == 0) ? (hs[w] << 4)
                                  : (j == 1) ? (hs[w] << 2)
                                  : (j == 2) ? hs[w] : (hs[w] >> 2);
                v[w] = nib | (hi & 0x30303030u);
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
                float p = 0.f;
#pragma unroll
                for (int e = 0; e < 16; ++e)
                    p += (float)((v[e >> 2] >> (8 * (e & 3))) & 0xFFu)
                         * bf2f(x[col + e]);
                acc += s * p;
            }
            accx += bf2f(xsum[g]) * s;
        }
    }
    const float t = warp_sum(acc) - 32.0f * warp_sum(accx);
    if (lane == 0) y[row] = f2bf(t);
}

// x (in_f) bf16 -> xq (in_f) int8, sx (in_f/16) f32, xsum (in_f/16) bf16
KCPP_API int k2_q6k_prep(const void* x, void* xq, void* sx, void* xsum,
                         int in_f, int quant, void* stream) {
    return (int)launch_act_prep<16>(x, xq, sx, xsum, in_f, quant,
                                    (cudaStream_t)stream);
}

KCPP_API int k2_q6k_matvec(const void* ql, const void* qh, const void* scale,
                           const void* x, const void* xq, const void* sx,
                           const void* xsum, void* y, int out_f, int in_f,
                           int i8, void* stream) {
    dim3 grid((out_f + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    dim3 block(ROWS_PER_BLOCK * 32);
    cudaStream_t st = (cudaStream_t)stream;
#define K2_ARGS (const uint8_t*)ql, (const uint8_t*)qh, \
        (const __nv_bfloat16*)scale, (const __nv_bfloat16*)x, \
        (const int8_t*)xq, (const float*)sx, (const __nv_bfloat16*)xsum, \
        (__nv_bfloat16*)y, out_f, in_f
    if (i8)
        q6k_matvec_kernel<true><<<grid, block, 0, st>>>(K2_ARGS);
    else
        q6k_matvec_kernel<false><<<grid, block, 0, st>>>(K2_ARGS);
#undef K2_ARGS
    return (int)cudaGetLastError();
}
