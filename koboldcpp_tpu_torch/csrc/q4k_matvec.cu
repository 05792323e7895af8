// K1: q4_k T=1 matvec, y (1, out_f) bf16 = x (1, in_f) . W^T.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec_q4k` at T=1:
// body `_q4k_decode_kernel_i8` (in_f >= 512) and `_q4k_decode_kernel`
// (bf16 activations, in_f < 512).
//
// i8 variant: x is quantized per 32-column group to int8 (act_prep_kernel,
// the port of `_i8_prep`); the int8 x nibble dot of each group is an exact
// int32 sum taken with __dp4a; y_r = sum_g sx_g * s_rg * P_rg
// - sum_g m_rg * xsum_g (`_i8_combine`), with the group sums kept in bf16.
// bf16 variant: P_rg is the exact f32 dot of bf16 x with the nibbles.
//
// Bound on the H100: bytes. Each weight byte is read once (0.5 B/weight
// plus 4 B of bf16 scale and min per 32 weights); x, its codes and sums
// stay in L1/L2. Design: one warp per output row, each lane loads 16 bytes
// of packed nibbles per step (half of one 32-column group in each nibble
// plane), so a warp reads 512 contiguous bytes per step; the two lanes of a
// group combine their int32 partials with one shuffle before the scale
// products, as the TPU kernel applies scales to whole-group partials.
// Launch counter: ops/_build.launches["K1"] (one per matvec).
#include "common.cuh"

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

template <bool I8>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
q4k_matvec_kernel(const uint8_t* __restrict__ qs2,
                  const __nv_bfloat16* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ mn,
                  const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ xq,
                  const float* __restrict__ sx,
                  const __nv_bfloat16* __restrict__ xsum,
                  __nv_bfloat16* __restrict__ y, int out_f, int in_f) {
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= out_f) return;  // whole warps exit together
    const int ng = in_f / 32;
    const int nchunk = in_f / 32;  // 16-byte chunks per row (in_f/2 bytes)
    const uint8_t* wrow = qs2 + (size_t)row * (in_f / 2);
    const __nv_bfloat16* srow = scale + (size_t)row * ng;
    const __nv_bfloat16* mrow = mn + (size_t)row * ng;

    float acc = 0.f;
    for (int base = 0; base < nchunk; base += 32) {
        const int c = base + lane;
        const bool valid = c < nchunk;  // chunk pairs are valid together
        const int sb = c >> 3;           // superblock
        const int b = (c & 7) * 16;      // byte offset inside the superblock
        const int col_lo = sb * 256 + b;         // logical col of low nibble
        const int col_hi = col_lo + 128;         // ... and of high nibble
        float plo = 0.f, phi = 0.f;
        if (valid) {
            const uint4 w = *reinterpret_cast<const uint4*>(wrow + sb * 128 + b);
            const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
            if (I8) {
                const uint4 xl = *reinterpret_cast<const uint4*>(xq + col_lo);
                const uint4 xh = *reinterpret_cast<const uint4*>(xq + col_hi);
                const uint32_t xls[4] = {xl.x, xl.y, xl.z, xl.w};
                const uint32_t xhs[4] = {xh.x, xh.y, xh.z, xh.w};
                int il = 0, ih = 0;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    il = __dp4a((int)(ws[k] & 0x0F0F0F0Fu), (int)xls[k], il);
                    ih = __dp4a((int)((ws[k] >> 4) & 0x0F0F0F0Fu), (int)xhs[k], ih);
                }
                plo = (float)il;  // exact: |P| <= 16 * 15 * 127
                phi = (float)ih;
            } else {
#pragma unroll
                for (int k = 0; k < 16; ++k) {
                    const uint32_t byte = (ws[k >> 2] >> (8 * (k & 3))) & 0xFFu;
                    plo += (float)(byte & 0xF) * bf2f(x[col_lo + k]);
                    phi += (float)(byte >> 4) * bf2f(x[col_hi + k]);
                }
            }
        }
        // the two lanes of one 32-column group (c, c^1) combine partials
        plo += __shfl_xor_sync(0xffffffffu, plo, 1);
        phi += __shfl_xor_sync(0xffffffffu, phi, 1);
        if (valid && (lane & 1) == 0) {
            const int g_lo = sb * 8 + (c & 7) / 2;  // logical 32-col group
            const int g_hi = g_lo + 4;
            if (I8) {
                acc += plo * sx[g_lo] * bf2f(srow[g_lo]);
                acc += phi * sx[g_hi] * bf2f(srow[g_hi]);
            } else {
                acc += bf2f(srow[g_lo]) * plo;
                acc += bf2f(srow[g_hi]) * phi;
            }
        }
    }
    float accm = 0.f;  // min term: sum_g m_g * xsum_g
    for (int g = lane; g < ng; g += 32) accm += bf2f(mrow[g]) * bf2f(xsum[g]);
    const float t = warp_sum(acc) - warp_sum(accm);
    if (lane == 0) y[row] = f2bf(t);
}

// x (in_f) bf16 -> xq (in_f) int8, sx (in_f/32) f32, xsum (in_f/32) bf16
KCPP_API int k1_q4k_prep(const void* x, void* xq, void* sx, void* xsum,
                         int in_f, int quant, void* stream) {
    return (int)launch_act_prep<32>(x, xq, sx, xsum, in_f, quant,
                                    (cudaStream_t)stream);
}

KCPP_API int k1_q4k_matvec(const void* qs2, const void* scale, const void* mn,
                           const void* x, const void* xq, const void* sx,
                           const void* xsum, void* y, int out_f, int in_f,
                           int i8, void* stream) {
    dim3 grid((out_f + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    dim3 block(ROWS_PER_BLOCK * 32);
    cudaStream_t st = (cudaStream_t)stream;
#define K1_ARGS (const uint8_t*)qs2, (const __nv_bfloat16*)scale, \
        (const __nv_bfloat16*)mn, (const __nv_bfloat16*)x, (const int8_t*)xq, \
        (const float*)sx, (const __nv_bfloat16*)xsum, (__nv_bfloat16*)y, \
        out_f, in_f
    if (i8)
        q4k_matvec_kernel<true><<<grid, block, 0, st>>>(K1_ARGS);
    else
        q4k_matvec_kernel<false><<<grid, block, 0, st>>>(K1_ARGS);
#undef K1_ARGS
    return (int)cudaGetLastError();
}
