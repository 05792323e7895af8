// K12.iq: the native IQ kinds' T=1 matvec, y (1, out_f) bf16 = x (1, in_f)
// . W^T with w = v * s (- m for iq1p) per group of G = 8, 16 or 32 columns.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec` for the IQ
// kinds at T=1 (in_f >= 32 G): bodies `_iq2p_row_kernel_i8` (iq2p),
// `_iq3p_row_kernel_i8` (iq3px and iq3ps) and `_iq1p_row_kernel_i8`
// (iq1p), with the activation prep `_iq_i8_prep`.
//
// x is quantized per group of G columns to int8 (act_prep_kernel<G>); the
// signed values dot the int8 codes exactly in int32 via __dp4a, and
// y_r = sum_g sx_g * s_rg * P_rg, minus (iq1p) the exact group-sum term
// sum_g xs_g * m_rg over the bf16 group sums xs.
//
// Layout (ops/linear.py): qs (out_f, in_f/4) holds 2-bit codes in q2_k's
// stream order (element 256s+128h+32j+l in bits 2j..2j+1 of byte
// 64s+32h+l); hmask (iq3px, iq3ps: the code's 3rd bit) and sg (iq2p, iq3px,
// iq3ps: the sign) (out_f, in_f/8) in q3_k's hmask order (bit 4h+j of byte
// 32s+l); scale (and iq1p's min) (out_f, in_f/G) bf16 in logical group
// order. Values are decoded four to a 32-bit word by byte-wise arithmetic,
// no grid lookup: iq2p 8 + 17c + (c >> 1); iq3px 4 + 8k, 62 at k = 7;
// iq3ps 2k + 1; iq1p c - 1; every |v| <= 62 fits an int8 lane.
//
// Bound on the H100: bytes (0.25 B/weight of qs, 0.125 each of hmask and
// sg, 2 or 4 B of bf16 scale and min per G weights). Design, as K12
// (q23k_matvec.cu): one warp per output row; a lane owns 16 values of l in
// one half of a superblock, i.e. 16 columns in each of the four bit
// planes, reading 16 bytes of qs (and 16 of hmask / sg); each 16-column run
// lies in one group (G = 16, 32) or two (G = 8). The iq1p min term is a
// separate lane-strided sum over the groups.
// K17b.<kind> (li set: layer li of layer-stacked fields, the scan decode
// path) replaces `_packed_matvec_stacked` for the IQ kinds: the same
// bodies with the weight pointers moved to layer li (Stacked, common.cuh).
// Launch counters: ops/_build.launches["K17b.<kind>"] (stacked),
// ["K12.iq2p"], ["K12.iq3px"],
// ["K12.iq3ps"], ["K12.iq1p"].
#include "common.cuh"

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

// 0 = iq2p, 1 = iq3px, 2 = iq3ps, 3 = iq1p
template <int KIND, int G>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
iq_matvec_kernel(const uint8_t* __restrict__ qs,
                 const uint8_t* __restrict__ hmask,
                 const uint8_t* __restrict__ sg,
                 const __nv_bfloat16* __restrict__ scale,
                 const __nv_bfloat16* __restrict__ mn,
                 const int8_t* __restrict__ xq,
                 const float* __restrict__ sx,
                 const __nv_bfloat16* __restrict__ xsum,
                 __nv_bfloat16* __restrict__ y, int out_f, int in_f,
                 Stacked stk) {
    qs = stk.at(qs, 0);
    hmask = stk.at(hmask, 1);
    sg = stk.at(sg, 2);
    scale = stk.at(scale, 3);
    mn = stk.at(mn, 4);
    constexpr bool HI = KIND == 1 || KIND == 2, SIGN = KIND != 3;
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= out_f) return;
    const int nchunk = in_f / 64;  // (superblock, half, 16-l block) chunks
    const int ng = in_f / G;
    const uint8_t* qrow = qs + (size_t)row * (in_f / 4);
    const __nv_bfloat16* srow = scale + (size_t)row * ng;

    float acc = 0.f;
    for (int c = lane; c < nchunk; c += 32) {
        const int sb = c >> 2, h = (c >> 1) & 1, k = c & 1;
        const uint4 a = *reinterpret_cast<const uint4*>(
            qrow + sb * 64 + h * 32 + k * 16);
        const uint32_t as[4] = {a.x, a.y, a.z, a.w};
        uint32_t hs[4] = {0u, 0u, 0u, 0u}, ss[4] = {0u, 0u, 0u, 0u};
        const size_t off8 = (size_t)row * (in_f / 8) + sb * 32 + k * 16;
        if (HI) {
            const uint4 hv = *reinterpret_cast<const uint4*>(hmask + off8);
            hs[0] = hv.x; hs[1] = hv.y; hs[2] = hv.z; hs[3] = hv.w;
        }
        if (SIGN) {
            const uint4 sv = *reinterpret_cast<const uint4*>(sg + off8);
            ss[0] = sv.x; ss[1] = sv.y; ss[2] = sv.z; ss[3] = sv.w;
        }
        const int col0 = sb * 256 + h * 128 + k * 16;  // plane j adds 32j
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = col0 + 32 * j;
            const int bit = 4 * h + j;  // this plane's bit in hmask / sg
            int v[4];
#pragma unroll
            for (int w = 0; w < 4; ++w) {
                uint32_t q = (as[w] >> (2 * j)) & 0x03030303u;
                uint32_t u;
                if (KIND == 0) {         // 8 + 17c + (c >> 1)
                    u = q * 17u + 0x08080808u + ((q >> 1) & 0x01010101u);
                } else if (KIND == 3) {  // c - 1, byte-wise
                    u = __vsub4(q, 0x01010101u);
                } else {
                    q |= ((hs[w] >> bit) & 0x01010101u) << 2;
                    if (KIND == 1) {     // 4 + 8k, 62 at k = 7
                        const uint32_t k7 = q & (q >> 1) & (q >> 2)
                                            & 0x01010101u;
                        u = q * 8u + 0x04040404u + k7 * 2u;
                    } else {             // 2k + 1
                        u = q * 2u + 0x01010101u;
                    }
                }
                if (SIGN) {  // negate the bytes whose sign bit is set
                    const uint32_t m = ((ss[w] >> bit) & 0x01010101u) * 0xFFu;
                    u = __vsub4(u ^ m, m);
                }
                v[w] = (int)u;
            }
            const uint4 xv = *reinterpret_cast<const uint4*>(xq + col);
            if (G == 8) {
                const int g = col / 8;
                const int p0 = __dp4a(v[1], (int)xv.y, __dp4a(v[0], (int)xv.x, 0));
                const int p1 = __dp4a(v[3], (int)xv.w, __dp4a(v[2], (int)xv.z, 0));
                acc += (float)p0 * sx[g] * bf2f(srow[g]);
                acc += (float)p1 * sx[g + 1] * bf2f(srow[g + 1]);
            } else {
                const int g = col / G;
                int p = __dp4a(v[0], (int)xv.x, 0);
                p = __dp4a(v[1], (int)xv.y, p);
                p = __dp4a(v[2], (int)xv.z, p);
                p = __dp4a(v[3], (int)xv.w, p);
                acc += (float)p * sx[g] * bf2f(srow[g]);
            }
        }
    }
    float accm = 0.f;
    if (KIND == 3) {
        const __nv_bfloat16* mrow = mn + (size_t)row * ng;
        for (int g = lane; g < ng; g += 32)
            accm += bf2f(xsum[g]) * bf2f(mrow[g]);
    }
    const float t = warp_sum(acc) - warp_sum(accm);
    if (lane == 0) y[row] = f2bf(t);
}

// x (in_f) bf16 -> xq (in_f) int8, sx (in_f/G) f32, xsum (in_f/G) bf16
KCPP_API int k12_iq_prep(const void* x, void* xq, void* sx, void* xsum,
                         int in_f, int group, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (group) {
        case 8: return (int)launch_act_prep<8>(x, xq, sx, xsum, in_f, 1, st);
        case 16: return (int)launch_act_prep<16>(x, xq, sx, xsum, in_f, 1, st);
        case 32: return (int)launch_act_prep<32>(x, xq, sx, xsum, in_f, 1, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <int KIND>
static void launch_kind(dim3 grid, dim3 block, cudaStream_t st, int group,
                        const uint8_t* qs, const uint8_t* hmask,
                        const uint8_t* sg, const __nv_bfloat16* scale,
                        const __nv_bfloat16* mn, const int8_t* xq,
                        const float* sx, const __nv_bfloat16* xsum,
                        __nv_bfloat16* y, int out_f, int in_f,
                        Stacked stk) {
#define K12IQ_ARGS qs, hmask, sg, scale, mn, xq, sx, xsum, y, out_f, in_f, stk
    if (group == 8)
        iq_matvec_kernel<KIND, 8><<<grid, block, 0, st>>>(K12IQ_ARGS);
    else if (group == 16)
        iq_matvec_kernel<KIND, 16><<<grid, block, 0, st>>>(K12IQ_ARGS);
    else
        iq_matvec_kernel<KIND, 32><<<grid, block, 0, st>>>(K12IQ_ARGS);
#undef K12IQ_ARGS
}

// kind 0 = iq2p (qs, sg), 1 = iq3px and 2 = iq3ps (qs, hmask, sg), 3 = iq1p
// (qs, min); unused pointers may be null. group G in {8, 16, 32}; in_f %
// 256 == 0. li set (K17b.<kind>): layer li[0] of stacked fields, n0..n4
// the per-layer element counts of qs, hmask, sg, scale and min.
KCPP_API int k12_iq_matvec(int kind, const void* qs, const void* hmask,
                           const void* sg, const void* scale, const void* mn,
                           const void* xq, const void* sx, const void* xsum,
                           void* y, int out_f, int in_f, int group,
                           STACKED_PARAMS, void* stream) {
    if (kind < 0 || kind > 3 || (group != 8 && group != 16 && group != 32)
        || in_f % 256)
        return (int)cudaErrorInvalidValue;
    dim3 grid((out_f + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    dim3 block(ROWS_PER_BLOCK * 32);
    cudaStream_t st = (cudaStream_t)stream;
#define K12IQ_CALL(K) launch_kind<K>(grid, block, st, group, \
        (const uint8_t*)qs, (const uint8_t*)hmask, (const uint8_t*)sg, \
        (const __nv_bfloat16*)scale, (const __nv_bfloat16*)mn, \
        (const int8_t*)xq, (const float*)sx, (const __nv_bfloat16*)xsum, \
        (__nv_bfloat16*)y, out_f, in_f, STACKED_ARG)
    switch (kind) {
        case 0: K12IQ_CALL(0); break;
        case 1: K12IQ_CALL(1); break;
        case 2: K12IQ_CALL(2); break;
        default: K12IQ_CALL(3); break;
    }
#undef K12IQ_CALL
    return (int)cudaGetLastError();
}
