// K14: q4_k / q5_k 2<=T<=16 batched matvec over the superblock factors,
// y (T, out_f) bf16 = x (T, in_f) . W^T, W = d * sc * code - min.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec_q4k_sbq`
// (bodies `_q4k_decode_kernel_sbq`, `_q5k_decode_kernel_sbq`, prep
// `_sbq_prep`, combine `_sbq_combine`), the JAX package's batched decode
// path under KCPP_SBQ=1.
//
// Arithmetic, as the TPU kernel's: x is quantized to int8 per token and per
// 128-column segment (logical cols 128k..128k+127, one plane of one
// superblock: rint(x * (127 / amax)), scale amax / 127); the 6-bit integer
// sub-scale sc of each 32-column group folds into the int32 dot, so the
// segment's sum P = sum_c sc_g(c) code_c xq_c is exact (|P| <= 63 * 31 *
// 127 * 128 < 2^31); y_t = sum_s d_s (P_t,2s sx_t,2s + P_t,2s+1 sx_t,2s+1)
// - sum_g m_g xs_tg with the f32 superblock scale d and the bf16 group
// sums xs of x per 32 columns.
//
// Bound on the H100: bytes. Each weight byte is read once for all T tokens
// (0.5 B/weight of nibbles, q5_k 0.125 more of 5th bits, 1 B of sc and
// 2 B of bf16 min per 32 weights, 4 B of d per 256); x's codes stay in
// L1/L2. Design: K7's layout, one warp per output row, each lane loading 16
// bytes of nibbles per step (16 columns of the low-plane segment and 16 of
// the high-plane one of the same superblock), so 8 lanes hold one
// superblock; per token, a lane's two int32 __dp4a partials are multiplied
// by their groups' sc and summed over those 8 lanes by shuffles (exact
// integers), then one lane applies sx and d in f32. The token loop keeps T
// accumulators and every token's arithmetic is its own, so a row of y
// depends on its token alone.
// Launch counters: ops/_build.launches["K14"] (q4_k), ["K14.q5_k"].
#include "common.cuh"

constexpr int SBQ_ROWS = 8;  // one warp per row
constexpr int SBQ_SEG = 128;

// One warp per (token, 128-column segment): lane l takes columns 4l..4l+3.
__global__ void sbq_prep_kernel(const __nv_bfloat16* __restrict__ x,
                                int8_t* __restrict__ xq,
                                float* __restrict__ sx,
                                __nv_bfloat16* __restrict__ xsum,
                                int n_seg) {
    const int seg = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (seg >= n_seg) return;  // whole warps exit together
    const size_t base = (size_t)seg * SBQ_SEG + lane * 4;
    float v[4];
    float part = 0.f, amax = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        v[k] = bf2f(x[base + k]);
        part += v[k];
        amax = fmaxf(amax, fabsf(v[k]));
    }
    const float a = fmaxf(warp_max(amax), 1e-20f);
    const float inv = 127.0f / a;
    char4 q;
    q.x = (int8_t)(int)rintf(v[0] * inv);
    q.y = (int8_t)(int)rintf(v[1] * inv);
    q.z = (int8_t)(int)rintf(v[2] * inv);
    q.w = (int8_t)(int)rintf(v[3] * inv);
    *reinterpret_cast<char4*>(xq + base) = q;
    const float gs = group_sum(part, 8);  // 8 lanes = one 32-column group
    if ((lane & 7) == 0) xsum[(size_t)seg * 4 + (lane >> 3)] = f2bf(gs);
    if (lane == 0) sx[seg] = a / 127.0f;
}

template <int T, bool Q5>
__global__ void __launch_bounds__(SBQ_ROWS * 32)
sbq_matvec_kernel(const uint8_t* __restrict__ qs2,
                  const uint8_t* __restrict__ qh,          // q5_k (out, in/8)
                  const uint8_t* __restrict__ sc,          // (out, in/32)
                  const float* __restrict__ dsb,           // (out, in/256)
                  const __nv_bfloat16* __restrict__ mn,    // (out, in/32)
                  const int8_t* __restrict__ xq,           // (T, in_f)
                  const float* __restrict__ sx,            // (T, in_f/128)
                  const __nv_bfloat16* __restrict__ xsum,  // (T, in_f/32)
                  __nv_bfloat16* __restrict__ y,           // (T, out_f)
                  int out_f, int in_f) {
    const int row = blockIdx.x * SBQ_ROWS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= out_f) return;  // whole warps exit together
    const int ng = in_f / 32;
    const int nseg = in_f / SBQ_SEG;
    const int nsb = in_f / 256;
    const int nchunk = in_f / 32;  // 16-byte chunks per row, 8 per superblock
    const uint8_t* wrow = qs2 + (size_t)row * (in_f / 2);
    const uint8_t* scrow = sc + (size_t)row * ng;
    const float* drow = dsb + (size_t)row * nsb;
    const __nv_bfloat16* mrow = mn + (size_t)row * ng;

    float acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = 0.f;
    for (int base = 0; base < nchunk; base += 32) {
        const int c = base + lane;
        const bool valid = c < nchunk;  // a superblock's 8 lanes together
        const int sb = c >> 3;
        const int b = (c & 7) * 16;
        const int col_lo = sb * 256 + b;
        const int col_hi = col_lo + 128;
        const int g_lo = sb * 8 + (c & 7) / 2;
        uint32_t ws[4] = {0u, 0u, 0u, 0u};
        uint32_t hlo = 0u, hhi = 0u;
        int sc_lo = 0, sc_hi = 0;
        float d = 0.f;
        if (valid) {
            const uint4 w = *reinterpret_cast<const uint4*>(wrow + sb * 128 + b);
            ws[0] = w.x; ws[1] = w.y; ws[2] = w.z; ws[3] = w.w;
            if (Q5) {
                const uint8_t* hrow = qh + (size_t)row * (in_f / 8);
                hlo = *reinterpret_cast<const uint16_t*>(hrow + col_lo / 8);
                hhi = *reinterpret_cast<const uint16_t*>(hrow + col_hi / 8);
            }
            sc_lo = scrow[g_lo];
            sc_hi = scrow[g_lo + 4];
            d = drow[sb];
        }
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            lo[k] = ws[k] & 0x0F0F0F0Fu;
            hi[k] = (ws[k] >> 4) & 0x0F0F0F0Fu;
            if (Q5) {
                lo[k] |= spread4(hlo >> (4 * k)) << 4;
                hi[k] |= spread4(hhi >> (4 * k)) << 4;
            }
        }
#pragma unroll
        for (int t = 0; t < T; ++t) {
            int il = 0, ih = 0;
            if (valid) {
                const int8_t* xt = xq + (size_t)t * in_f;
                const uint4 xl = *reinterpret_cast<const uint4*>(xt + col_lo);
                const uint4 xh = *reinterpret_cast<const uint4*>(xt + col_hi);
                const uint32_t xls[4] = {xl.x, xl.y, xl.z, xl.w};
                const uint32_t xhs[4] = {xh.x, xh.y, xh.z, xh.w};
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    il = __dp4a((int)lo[k], (int)xls[k], il);
                    ih = __dp4a((int)hi[k], (int)xhs[k], ih);
                }
                il *= sc_lo;
                ih *= sc_hi;
            }
            // exact segment sums over the superblock's 8 lanes
#pragma unroll
            for (int o = 1; o < 8; o <<= 1) {
                il += __shfl_xor_sync(0xffffffffu, il, o);
                ih += __shfl_xor_sync(0xffffffffu, ih, o);
            }
            if (valid && (lane & 7) == 0) {
                const float* st = sx + (size_t)t * nseg + 2 * sb;
                const float va = __fadd_rn(__fmul_rn((float)il, st[0]),
                                           __fmul_rn((float)ih, st[1]));
                acc[t] = __fmaf_rn(va, d, acc[t]);
            }
        }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
        const __nv_bfloat16* xs = xsum + (size_t)t * ng;
        float accm = 0.f;  // min term: sum_g m_g * xs_g
        for (int g = lane; g < ng; g += 32)
            accm = __fmaf_rn(bf2f(mrow[g]), bf2f(xs[g]), accm);
        const float r = warp_sum(acc[t]) - warp_sum(accm);
        if (lane == 0) y[(size_t)t * out_f + row] = f2bf(r);
    }
}

template <bool Q5>
static cudaError_t launch_sbq(int T, const void* qs2, const void* qh,
                              const void* sc, const void* dsb, const void* mn,
                              const void* xq, const void* sx,
                              const void* xsum, void* y, int out_f, int in_f,
                              cudaStream_t st) {
    dim3 grid((out_f + SBQ_ROWS - 1) / SBQ_ROWS);
    dim3 block(SBQ_ROWS * 32);
#define SBQ_ARGS (const uint8_t*)qs2, (const uint8_t*)qh, (const uint8_t*)sc, \
        (const float*)dsb, (const __nv_bfloat16*)mn, (const int8_t*)xq, \
        (const float*)sx, (const __nv_bfloat16*)xsum, (__nv_bfloat16*)y, \
        out_f, in_f
#define SBQ_CASE(n) \
    case n: sbq_matvec_kernel<n, Q5><<<grid, block, 0, st>>>(SBQ_ARGS); break;
    switch (T) {
        SBQ_CASE(2) SBQ_CASE(3) SBQ_CASE(4) SBQ_CASE(5) SBQ_CASE(6)
        SBQ_CASE(7) SBQ_CASE(8) SBQ_CASE(9) SBQ_CASE(10) SBQ_CASE(11)
        SBQ_CASE(12) SBQ_CASE(13) SBQ_CASE(14) SBQ_CASE(15) SBQ_CASE(16)
        default: return cudaErrorInvalidValue;
    }
#undef SBQ_CASE
#undef SBQ_ARGS
    return cudaGetLastError();
}

// x (T, in_f) bf16 -> xq (T, in_f) int8, sx (T, in_f/128) f32, xsum
// (T, in_f/32) bf16; a segment never straddles two tokens (in_f % 256 == 0)
KCPP_API int k14_sbq_prep(const void* x, void* xq, void* sx, void* xsum,
                          int T, int in_f, void* stream) {
    const int n_seg = T * (in_f / SBQ_SEG);
    sbq_prep_kernel<<<(n_seg + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (int8_t*)xq, (float*)sx,
        (__nv_bfloat16*)xsum, n_seg);
    return (int)cudaGetLastError();
}

// qh is the q5_k bit plane, or null for q4_k
KCPP_API int k14_sbq_matvec(const void* qs2, const void* qh, const void* sc,
                            const void* dsb, const void* mn, const void* xq,
                            const void* sx, const void* xsum, void* y, int T,
                            int out_f, int in_f, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (in_f % 256) return (int)cudaErrorInvalidValue;
    return (int)(qh ? launch_sbq<true>(T, qs2, qh, sc, dsb, mn, xq, sx, xsum,
                                       y, out_f, in_f, st)
                    : launch_sbq<false>(T, qs2, qh, sc, dsb, mn, xq, sx,
                                        xsum, y, out_f, in_f, st));
}
