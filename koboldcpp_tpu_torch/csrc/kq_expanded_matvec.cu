// K12 expanded: the T=1 matvec over the expanded layouts of
// KCPP_KQ_LAYOUT=expanded, y (1, out_f) bf16 = x (1, in_f) . W^T with, per
// 16-column group g, w = v * s_g (q6_k_i8f: v = q6 - 32, one int8 per
// weight), w = (q3 - 4) * s_g (q3_k_n4) or w = q2 * s_g - m_g (q2_k_n4; the
// codes as nibbles).
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec` for the
// expanded kinds: bodies `_q6k_i8f_row_kernel`, `_q3k_n4_row_kernel` and
// `_q2k_n4_row_kernel`. x is quantized per 16-column group to int8
// (act_prep_kernel: codes rint(x * (127 / a_g)), sx_g = a_g / 127, and the
// bf16-rounded group sums xs_g); each group's code dot P_g is an exact int32
// sum taken with __dp4a; y_r = sum_g P_rg * sx_g * s_rg, minus
// 4 * sum_g xs_g * s_rg (q3_k_n4) or sum_g xs_g * m_rg (q2_k_n4) in f32.
//
// Layout (ops/linear.py): q6_k_i8f's q (out_f, in_f) int8 in logical
// order; the n4 kinds' n4 (out_f, in_f/2) u8, byte 16b+k holding col 32b+k
// in the low nibble and col 32b+16+k in the high one, so a 16-byte load
// masked with 0x0F0F0F0F gives group 2b's codes and shifted right by 4
// group 2b+1's, each in x's column order; scale / min (out_f, in_f/16)
// bf16 in logical group order.
//
// Bound on the H100: bytes (q6_k_i8f 1 B/weight, the n4 kinds 0.5, plus 2
// or 4 B of bf16 scale and min per 16 weights; the int8 x and its scales
// stay in L1/L2). Design: one warp per output row; a lane owns one 16-byte
// chunk of the row at a time (one group for q6_k_i8f, two for the n4
// kinds), so a warp streams 512 contiguous bytes per step and no
// cross-lane combine precedes the scale products; one shuffle reduction
// per row at the end.
// Launch counters: ops/_build.launches["K12.q6_k_i8f"], ["K12.q3_k_n4"],
// ["K12.q2_k_n4"], one per matvec.
#include "common.cuh"

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

__device__ __forceinline__ int dot16(const uint32_t (&w)[4], const uint4 x) {
    int p = __dp4a((int)w[0], (int)x.x, 0);
    p = __dp4a((int)w[1], (int)x.y, p);
    p = __dp4a((int)w[2], (int)x.z, p);
    return __dp4a((int)w[3], (int)x.w, p);
}

// KIND 0 = q6_k_i8f, 1 = q3_k_n4, 2 = q2_k_n4
template <int KIND>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
kq_expanded_matvec_kernel(const uint8_t* __restrict__ w,
                          const __nv_bfloat16* __restrict__ scale,
                          const __nv_bfloat16* __restrict__ mn,
                          const int8_t* __restrict__ xq,
                          const float* __restrict__ sx,
                          const __nv_bfloat16* __restrict__ xsum,
                          __nv_bfloat16* __restrict__ y, int out_f,
                          int in_f) {
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= out_f) return;  // whole warps exit together
    const int ng = in_f / 16;
    const __nv_bfloat16* srow = scale + (size_t)row * ng;

    float acc = 0.f, accx = 0.f;
    if (KIND == 0) {
        const uint8_t* qrow = w + (size_t)row * in_f;
        for (int g = lane; g < ng; g += 32) {
            const uint4 a = *reinterpret_cast<const uint4*>(qrow + g * 16);
            const uint32_t v[4] = {a.x, a.y, a.z, a.w};
            const int p = dot16(
                v, *reinterpret_cast<const uint4*>(xq + g * 16));
            acc += (float)p * sx[g] * bf2f(srow[g]);
        }
    } else {
        const uint8_t* nrow = w + (size_t)row * (in_f / 2);
        const __nv_bfloat16* mrow = KIND == 2 ? mn + (size_t)row * ng
                                              : nullptr;
        for (int b = lane; b < in_f / 32; b += 32) {
            const uint4 a = *reinterpret_cast<const uint4*>(nrow + b * 16);
            const uint32_t as[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // group 2b (low), 2b+1 (high)
                const int g = 2 * b + h;
                uint32_t v[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    v[i] = (as[i] >> (4 * h)) & 0x0F0F0F0Fu;
                const int p = dot16(
                    v, *reinterpret_cast<const uint4*>(xq + g * 16));
                const float s = bf2f(srow[g]);
                acc += (float)p * sx[g] * s;
                accx += bf2f(xsum[g]) * (KIND == 1 ? s : bf2f(mrow[g]));
            }
        }
    }
    float t = warp_sum(acc);
    if (KIND == 1) t -= 4.f * warp_sum(accx);
    if (KIND == 2) t -= warp_sum(accx);
    if (lane == 0) y[row] = f2bf(t);
}

// x (in_f) bf16 -> xq (in_f) int8, sx (in_f/16) f32, xsum (in_f/16) bf16
KCPP_API int k12_expanded_prep(const void* x, void* xq, void* sx, void* xsum,
                               int in_f, int quant, void* stream) {
    return (int)launch_act_prep<16>(x, xq, sx, xsum, in_f, quant,
                                    (cudaStream_t)stream);
}

// kind 0: q6_k_i8f (w = q, int8; mn unused); 1: q3_k_n4 (w = n4; mn
// unused); 2: q2_k_n4 (w = n4, mn = min). in_f % 256 == 0.
KCPP_API int k12_expanded_matvec(int kind, const void* w, const void* scale,
                                 const void* mn, const void* xq,
                                 const void* sx, const void* xsum, void* y,
                                 int out_f, int in_f, void* stream) {
    dim3 grid((out_f + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    dim3 block(ROWS_PER_BLOCK * 32);
    cudaStream_t st = (cudaStream_t)stream;
#define K12X_ARGS (const uint8_t*)w, (const __nv_bfloat16*)scale, \
        (const __nv_bfloat16*)mn, (const int8_t*)xq, (const float*)sx, \
        (const __nv_bfloat16*)xsum, (__nv_bfloat16*)y, out_f, in_f
    switch (kind) {
        case 0:
            kq_expanded_matvec_kernel<0><<<grid, block, 0, st>>>(K12X_ARGS);
            break;
        case 1:
            kq_expanded_matvec_kernel<1><<<grid, block, 0, st>>>(K12X_ARGS);
            break;
        case 2:
            kq_expanded_matvec_kernel<2><<<grid, block, 0, st>>>(K12X_ARGS);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
#undef K12X_ARGS
    return (int)cudaGetLastError();
}
