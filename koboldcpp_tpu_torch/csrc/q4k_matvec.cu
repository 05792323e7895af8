// K1: q4_k / q5_k T=1 matvec and K7: q4_k / q5_k 2<=T<=8 batched matvec,
// y (T, out_f) bf16 = x (T, in_f) . W^T.
//
// K1 replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec_q4k` at T=1:
// bodies `_q4k_decode_kernel_i8` / `_q5k_decode_kernel_i8` (in_f >= 512)
// and `_q4k_decode_kernel` / `_q5k_decode_kernel` (bf16 activations, in_f <
// 512). K7 replaces the same function at 2 <= T <= 8: bodies
// `_q4k_decode_kernel_i8_t` / `_q5k_decode_kernel_i8_t` (with
// `_i8_prep_t`) and the bf16 decode kernels over per-token stacks (T <= 4).
//
// The code of a weight is its nibble (q4_k, 0..15) or its nibble ORed with
// its 5th bit from the qh bit plane (q5_k, 0..31); w = code * s - m.
// i8 variant: x is quantized per token and per 32-column group to int8
// (act_prep_kernel over the T rows, the port of `_i8_prep(_t)`); the int8 x
// code dot of each group is an exact int32 sum taken with __dp4a (codes
// are below 128, so the signed form multiplies them exactly);
// y_r = sum_g sx_g * s_rg * P_rg - sum_g m_rg * xsum_g (`_i8_combine`), with
// the group sums kept in bf16. bf16 variant: P_rg is the f32 dot of bf16 x
// with the codes.
//
// Bound on the H100: bytes. Each weight byte is read once, whatever T is
// (q4_k 0.5 B/weight, q5_k 0.5 + 0.125 B/weight, plus 4 B of bf16 scale and
// min per 32 weights); x, its codes and sums stay in L1/L2. Design: one warp
// per output row, each lane loads 16 bytes of packed nibbles per step (half
// of one 32-column group in each nibble plane) and, for q5_k, the 2 + 2
// bytes of those 32 columns' 5th bits, so a warp reads 512 contiguous bytes
// of nibbles per step, and keeps T accumulators, one per token; the two
// lanes of a group combine their partials with one shuffle before the scale
// products, as the TPU kernel applies scales to whole-group partials. Every
// product-and-add is an explicit __fmaf_rn / __fmul_rn, so token t goes
// through the same operations in the same order at every T: row t of K7
// equals K1 on x[t] bit for bit, and a request served in a batch gets the
// tokens it gets alone.
// K17a (T=1 over layer li of layer-stacked fields, the scan decode path)
// replaces `_packed_matvec_q4k_stacked`, which runs the same bodies through
// `_stacked_kernel` / `_SqView`: it is K1 with every weight pointer moved
// to layer li, read by each block from device memory (Stacked,
// common.cuh), so it gives K1's result on that layer bit for bit.
// Launch counters: ops/_build.launches["K1"] and ["K7"] (q4_k),
// ["K1.q5_k"] and ["K7.q5_k"] (q5_k), ["K17a"] and ["K17a.q5_k"]
// (stacked), one per matvec.
#include "common.cuh"

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

template <bool I8, int T, bool Q5>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
q4k_matvec_kernel(const uint8_t* __restrict__ qs2,
                  const uint8_t* __restrict__ qh,          // q5_k (out, in/8)
                  const __nv_bfloat16* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ mn,
                  const __nv_bfloat16* __restrict__ x,     // (T, in_f)
                  const int8_t* __restrict__ xq,           // (T, in_f)
                  const float* __restrict__ sx,            // (T, in_f/32)
                  const __nv_bfloat16* __restrict__ xsum,  // (T, in_f/32)
                  __nv_bfloat16* __restrict__ y,           // (T, out_f)
                  int out_f, int in_f, Stacked stk) {
    qs2 = stk.at(qs2, 0);
    qh = stk.at(qh, 1);
    scale = stk.at(scale, 2);
    mn = stk.at(mn, 3);
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= out_f) return;  // whole warps exit together
    const int ng = in_f / 32;
    const int nchunk = in_f / 32;  // 16-byte chunks per row (in_f/2 bytes)
    const uint8_t* wrow = qs2 + (size_t)row * (in_f / 2);
    const __nv_bfloat16* srow = scale + (size_t)row * ng;
    const __nv_bfloat16* mrow = mn + (size_t)row * ng;

    float acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = 0.f;
    for (int base = 0; base < nchunk; base += 32) {
        const int c = base + lane;
        const bool valid = c < nchunk;  // chunk pairs are valid together
        const int sb = c >> 3;           // superblock
        const int b = (c & 7) * 16;      // byte offset inside the superblock
        const int col_lo = sb * 256 + b;         // logical col of low nibble
        const int col_hi = col_lo + 128;         // ... and of high nibble
        const int g_lo = sb * 8 + (c & 7) / 2;   // logical 32-col group
        const int g_hi = g_lo + 4;
        uint32_t ws[4] = {0u, 0u, 0u, 0u};
        uint32_t hlo = 0u, hhi = 0u;  // 5th bits of the 16 cols in each plane
        if (valid) {
            const uint4 w = *reinterpret_cast<const uint4*>(wrow + sb * 128 + b);
            ws[0] = w.x; ws[1] = w.y; ws[2] = w.z; ws[3] = w.w;
            if (Q5) {
                const uint8_t* hrow = qh + (size_t)row * (in_f / 8);
                hlo = *reinterpret_cast<const uint16_t*>(hrow + col_lo / 8);
                hhi = *reinterpret_cast<const uint16_t*>(hrow + col_hi / 8);
            }
        }
        const float s_lo = valid ? bf2f(srow[g_lo]) : 0.f;
        const float s_hi = valid ? bf2f(srow[g_hi]) : 0.f;
#pragma unroll
        for (int t = 0; t < T; ++t) {
            float plo = 0.f, phi = 0.f;
            if (valid) {
                if (I8) {
                    const int8_t* xt = xq + (size_t)t * in_f;
                    const uint4 xl = *reinterpret_cast<const uint4*>(xt + col_lo);
                    const uint4 xh = *reinterpret_cast<const uint4*>(xt + col_hi);
                    const uint32_t xls[4] = {xl.x, xl.y, xl.z, xl.w};
                    const uint32_t xhs[4] = {xh.x, xh.y, xh.z, xh.w};
                    int il = 0, ih = 0;
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        uint32_t lo = ws[k] & 0x0F0F0F0Fu;
                        uint32_t hi = (ws[k] >> 4) & 0x0F0F0F0Fu;
                        if (Q5) {
                            lo |= spread4(hlo >> (4 * k)) << 4;
                            hi |= spread4(hhi >> (4 * k)) << 4;
                        }
                        il = __dp4a((int)lo, (int)xls[k], il);
                        ih = __dp4a((int)hi, (int)xhs[k], ih);
                    }
                    plo = (float)il;  // exact: |P| <= 16 * 31 * 127
                    phi = (float)ih;
                } else {
                    const __nv_bfloat16* xt = x + (size_t)t * in_f;
#pragma unroll
                    for (int k = 0; k < 16; ++k) {
                        const uint32_t byte = (ws[k >> 2] >> (8 * (k & 3))) & 0xFFu;
                        uint32_t clo = byte & 0xF, chi = byte >> 4;
                        if (Q5) {
                            clo |= ((hlo >> k) & 1u) << 4;
                            chi |= ((hhi >> k) & 1u) << 4;
                        }
                        plo = __fmaf_rn((float)clo, bf2f(xt[col_lo + k]), plo);
                        phi = __fmaf_rn((float)chi, bf2f(xt[col_hi + k]), phi);
                    }
                }
            }
            // the two lanes of one 32-column group (c, c^1) combine partials
            plo += __shfl_xor_sync(0xffffffffu, plo, 1);
            phi += __shfl_xor_sync(0xffffffffu, phi, 1);
            if (valid && (lane & 1) == 0) {
                if (I8) {
                    const float* st = sx + (size_t)t * ng;
                    acc[t] = __fmaf_rn(__fmul_rn(plo, st[g_lo]), s_lo, acc[t]);
                    acc[t] = __fmaf_rn(__fmul_rn(phi, st[g_hi]), s_hi, acc[t]);
                } else {
                    acc[t] = __fmaf_rn(s_lo, plo, acc[t]);
                    acc[t] = __fmaf_rn(s_hi, phi, acc[t]);
                }
            }
        }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
        const __nv_bfloat16* xs = xsum + (size_t)t * ng;
        float accm = 0.f;  // min term: sum_g m_g * xsum_g
        for (int g = lane; g < ng; g += 32)
            accm = __fmaf_rn(bf2f(mrow[g]), bf2f(xs[g]), accm);
        const float r = warp_sum(acc[t]) - warp_sum(accm);
        if (lane == 0) y[(size_t)t * out_f + row] = f2bf(r);
    }
}

template <bool I8, bool Q5>
static cudaError_t launch_matvec(int T, const void* qs2, const void* qh,
                                 const void* scale,
                                 const void* mn, const void* x, const void* xq,
                                 const void* sx, const void* xsum, void* y,
                                 int out_f, int in_f, Stacked stk,
                                 cudaStream_t st) {
    dim3 grid((out_f + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    dim3 block(ROWS_PER_BLOCK * 32);
#define KQ_ARGS (const uint8_t*)qs2, (const uint8_t*)qh, \
        (const __nv_bfloat16*)scale, \
        (const __nv_bfloat16*)mn, (const __nv_bfloat16*)x, (const int8_t*)xq, \
        (const float*)sx, (const __nv_bfloat16*)xsum, (__nv_bfloat16*)y, \
        out_f, in_f, stk
    switch (T) {
        case 1: q4k_matvec_kernel<I8, 1, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 2: q4k_matvec_kernel<I8, 2, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 3: q4k_matvec_kernel<I8, 3, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 4: q4k_matvec_kernel<I8, 4, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 5: q4k_matvec_kernel<I8, 5, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 6: q4k_matvec_kernel<I8, 6, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 7: q4k_matvec_kernel<I8, 7, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 8: q4k_matvec_kernel<I8, 8, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        default: return cudaErrorInvalidValue;
    }
#undef KQ_ARGS
    return cudaGetLastError();
}

// x (n = T * in_f) bf16 -> xq (n) int8, sx (n/32) f32, xsum (n/32) bf16; the
// groups never straddle two tokens (in_f is a multiple of 256)
KCPP_API int k1_q4k_prep(const void* x, void* xq, void* sx, void* xsum,
                         int n, int quant, void* stream) {
    return (int)launch_act_prep<32>(x, xq, sx, xsum, n, quant,
                                    (cudaStream_t)stream);
}

// K1 (T == 1), K7 (2 <= T <= 8) and K17a (T == 1, li set: layer li[0] of
// stacked fields, n0..n3 the per-layer element counts of qs2, qh, scale
// and min): the same kernel template; qh is the q5_k bit plane, or null
// for q4_k
KCPP_API int k7_q4k_matvec_t(const void* qs2, const void* qh,
                             const void* scale, const void* mn,
                             const void* x, const void* xq, const void* sx,
                             const void* xsum, void* y, int T, int out_f,
                             int in_f, int i8, STACKED_PARAMS, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const Stacked stk = STACKED_ARG;
#define MV_ARGS T, qs2, qh, scale, mn, x, xq, sx, xsum, y, out_f, in_f, stk, st
    cudaError_t err;
    if (qh)
        err = i8 ? launch_matvec<true, true>(MV_ARGS)
                 : launch_matvec<false, true>(MV_ARGS);
    else
        err = i8 ? launch_matvec<true, false>(MV_ARGS)
                 : launch_matvec<false, false>(MV_ARGS);
#undef MV_ARGS
    return (int)err;
}
