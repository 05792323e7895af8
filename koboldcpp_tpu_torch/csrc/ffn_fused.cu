// K15: the q4_k SwiGLU FFN of a decode step in one launch,
// y (T, C) bf16 = down(silu(g) * u), [g; u] = gateup(x), T <= 8.
//
// Replaces koboldcpp_tpu/ops/ffn_fused.py `_ffn_fused_call` (K15b, T = 1,
// body `_ffn_kernel`) and `_ffn_fused_call_2d` (K15a, 2 <= T <= 8, body
// `_ffn_kernel_2d`), the JAX package's FFN under KCPP_FFN_FUSED=1.
//
// Arithmetic, as the TPU kernels': gate/up stay in f32 into the SwiGLU, a =
// u * g * sigmoid(g) in f32; down multiplies bf16(a), and its group sums
// are the f32 sums of a rounded to bf16.
//   K15b (T = 1): the magic-number row math (`_q4k_row_math`): per 32-column
//   group, P/8 = sum (16 + q) x in f32, so y = sum_g s_g (sum_c q_c x_c +
//   16 sum_c x_c) - 16 sum_g s_g xs_g - sum_g m_g xs_g with xs_g the bf16
//   group sum (the offset leaves 16 s_g (sum x - bf16(sum x)) per group);
//   down reads sum_c bf16(a_c) for its offset and bf16(sum a) for xs.
//   K15a: the 2-D math: bf16(q * s) weights, f32 products and sums, minus
//   sum_g m_g xs_tg.
//
// Bound on the H100: bytes (the 1.1B's FFN: 21.6 MB of packed weights at
// 0.625 B/weight). Design: one cooperative launch (cudaLaunchCooperativeKernel,
// the grid sized from cudaOccupancyMaxActiveBlocksPerMultiprocessor times the
// SM count, so every block is resident) with two grid-wide barriers
// (cooperative_groups::this_grid().sync()): every block first sums x per
// 32 columns into shared memory (the x-side prep, no separate launch);
// phase 1 walks the 2F gate/up rows grid-stride, one warp per row in K1's
// layout (a lane takes 16 bytes of nibbles, 16 columns of each plane), and
// writes the f32 results to a global scratch (T * 2F * 4 B); barrier;
// phase 2 computes a, bf16(a) and both group sums per 32 activations, one
// warp per group; barrier; phase 3 walks the C down rows the same way.
// Launch counters: ops/_build.launches["K15b"] (T = 1), ["K15a"].
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int FFN_WARPS = 8;
constexpr int FFN_THREADS = FFN_WARPS * 32;

// 16 consecutive bf16 values at p (32-byte aligned) as f32
__device__ __forceinline__ void load16_bf16(const __nv_bfloat16* p,
                                            float (&v)[16]) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 a = q[0], b = q[1];
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
}

// One q4_k row against T activation rows `act` (T, in_f) bf16; the warp
// returns y_t in every lane. T == 1 takes the magic-number row math (K15b),
// T > 1 the 2-D math (K15a). fsum (T, in_f/32): the f32 sums of the values
// multiplied (T == 1 only); xs (T, in_f/32): the bf16-rounded group sums.
template <int T>
__device__ __forceinline__ void q4k_row(const uint8_t* __restrict__ wrow,
                                        const __nv_bfloat16* __restrict__ srow,
                                        const __nv_bfloat16* __restrict__ mrow,
                                        const __nv_bfloat16* act,
                                        const float* fsum, const float* xs,
                                        int in_f, int lane, float (&out)[T]) {
    constexpr bool MAGIC = T == 1;
    const int ng = in_f / 32;
    const int nchunk = in_f / 32;  // 16-byte chunks of the row
    float acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = 0.f;
    for (int base = 0; base < nchunk; base += 32) {
        const int c = base + lane;
        const bool valid = c < nchunk;
        const int sb = c >> 3;
        const int b = (c & 7) * 16;
        const int col_lo = sb * 256 + b;
        const int col_hi = col_lo + 128;
        const int g_lo = sb * 8 + (c & 7) / 2;
        const int g_hi = g_lo + 4;
        uint32_t ws[4] = {0u, 0u, 0u, 0u};
        float s_lo = 0.f, s_hi = 0.f;
        if (valid) {
            const uint4 w = *reinterpret_cast<const uint4*>(wrow + sb * 128 + b);
            ws[0] = w.x; ws[1] = w.y; ws[2] = w.z; ws[3] = w.w;
            s_lo = bf2f(srow[g_lo]);
            s_hi = bf2f(srow[g_hi]);
        }
        if (MAGIC) {
            float plo = 0.f, phi = 0.f;
            if (valid) {
                float xl[16], xh[16];
                load16_bf16(act + col_lo, xl);
                load16_bf16(act + col_hi, xh);
#pragma unroll
                for (int k = 0; k < 16; ++k) {
                    const uint32_t byte = (ws[k >> 2] >> (8 * (k & 3))) & 0xFFu;
                    plo = __fmaf_rn((float)(byte & 0xFu), xl[k], plo);
                    phi = __fmaf_rn((float)(byte >> 4), xh[k], phi);
                }
            }
            // the two lanes of one 32-column group combine their partials
            plo += __shfl_xor_sync(0xffffffffu, plo, 1);
            phi += __shfl_xor_sync(0xffffffffu, phi, 1);
            if (valid && (lane & 1) == 0) {
                acc[0] = __fmaf_rn(s_lo, __fmaf_rn(16.f, fsum[g_lo], plo),
                                   acc[0]);
                acc[0] = __fmaf_rn(s_hi, __fmaf_rn(16.f, fsum[g_hi], phi),
                                   acc[0]);
            }
        } else if (valid) {
            float wl[16], wh[16];  // bf16(q * s), as the 2-D kernel rounds
#pragma unroll
            for (int k = 0; k < 16; ++k) {
                const uint32_t byte = (ws[k >> 2] >> (8 * (k & 3))) & 0xFFu;
                wl[k] = bf2f(f2bf((float)(byte & 0xFu) * s_lo));
                wh[k] = bf2f(f2bf((float)(byte >> 4) * s_hi));
            }
#pragma unroll
            for (int t = 0; t < T; ++t) {
                float xl[16], xh[16];
                load16_bf16(act + (size_t)t * in_f + col_lo, xl);
                load16_bf16(act + (size_t)t * in_f + col_hi, xh);
#pragma unroll
                for (int k = 0; k < 16; ++k) {
                    acc[t] = __fmaf_rn(wl[k], xl[k], acc[t]);
                    acc[t] = __fmaf_rn(wh[k], xh[k], acc[t]);
                }
            }
        }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
        const float* xt = xs + (size_t)t * ng;
        float accm = 0.f;  // - sum_g (16 s_g + m_g) xs_g (MAGIC), m_g xs_g
        for (int g = lane; g < ng; g += 32) {
            const float m = bf2f(mrow[g]);
            accm = __fmaf_rn(MAGIC ? __fmaf_rn(16.f, bf2f(srow[g]), m) : m,
                             xt[g], accm);
        }
        out[t] = warp_sum(acc[t]) - warp_sum(accm);
    }
}

template <int T>
__global__ void __launch_bounds__(FFN_THREADS)
ffn_fused_kernel(const uint8_t* __restrict__ gu_qs2,
                 const __nv_bfloat16* __restrict__ gu_scale,
                 const __nv_bfloat16* __restrict__ gu_min,
                 const uint8_t* __restrict__ dn_qs2,
                 const __nv_bfloat16* __restrict__ dn_scale,
                 const __nv_bfloat16* __restrict__ dn_min,
                 const __nv_bfloat16* __restrict__ x,  // (T, C)
                 // scratch written and read back across the barriers: no
                 // __restrict__, so no load of it takes the read-only path
                 float* gu,                            // (T, 2F)
                 __nv_bfloat16* abf,                   // (T, F)
                 float* dxs,                           // (T, F/32)
                 float* dfs,                           // (T, F/32)
                 __nv_bfloat16* __restrict__ y,        // (T, C)
                 int C, int F) {
    extern __shared__ float smem[];  // x's group sums: xs (T, C/32), fs
    cg::grid_group grid = cg::this_grid();
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int ngc = C / 32, ngf = F / 32;
    float* xs_s = smem;
    float* fs_s = smem + T * ngc;
    for (int i = warp; i < T * ngc; i += FFN_WARPS) {
        const float s = warp_sum(bf2f(x[(size_t)i * 32 + lane]));
        if (lane == 0) {
            xs_s[i] = bf2f(f2bf(s));
            fs_s[i] = s;
        }
    }
    __syncthreads();
    const int gw = blockIdx.x * FFN_WARPS + warp;
    const int nw = gridDim.x * FFN_WARPS;
    float out[T];

    // phase 1: gate/up rows -> f32 scratch
    for (int r = gw; r < 2 * F; r += nw) {
        q4k_row<T>(gu_qs2 + (size_t)r * (C / 2), gu_scale + (size_t)r * ngc,
                          gu_min + (size_t)r * ngc, x, fs_s, xs_s, C, lane,
                          out);
        if (lane == 0) {
#pragma unroll
            for (int t = 0; t < T; ++t) gu[(size_t)t * 2 * F + r] = out[t];
        }
    }
    grid.sync();

    // phase 2: a = u * g * sigmoid(g), bf16(a) and the group sums
    for (int i = gw; i < T * ngf; i += nw) {
        const int t = i / ngf;
        const int j = (i % ngf) * 32 + lane;
        const float g = gu[(size_t)t * 2 * F + j];
        const float u = gu[(size_t)t * 2 * F + F + j];
        const float a = __fmul_rn(__fmul_rn(u, g), 1.0f / (1.0f + expf(-g)));
        const __nv_bfloat16 ab = f2bf(a);
        abf[(size_t)t * F + j] = ab;
        const float s = warp_sum(a);
        const float sb = warp_sum(bf2f(ab));
        if (lane == 0) {
            dxs[i] = bf2f(f2bf(s));
            dfs[i] = sb;
        }
    }
    grid.sync();

    // phase 3: down rows -> y
    for (int r = gw; r < C; r += nw) {
        q4k_row<T>(dn_qs2 + (size_t)r * (F / 2), dn_scale + (size_t)r * ngf,
                          dn_min + (size_t)r * ngf, abf, dfs, dxs, F, lane,
                          out);
        if (lane == 0) {
#pragma unroll
            for (int t = 0; t < T; ++t) y[(size_t)t * C + r] = f2bf(out[t]);
        }
    }
}

template <int T>
static cudaError_t launch_ffn(const void* gu_qs2, const void* gu_scale,
                              const void* gu_min, const void* dn_qs2,
                              const void* dn_scale, const void* dn_min,
                              const void* x, void* gu, void* abf, void* dxs,
                              void* dfs, void* y, int C, int F,
                              cudaStream_t st) {
    auto kern = ffn_fused_kernel<T>;
    const size_t smem = 2 * (size_t)T * (C / 32) * sizeof(float);
    cudaError_t err;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, FFN_THREADS, smem)) != cudaSuccess)
        return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    const int rows = 2 * F > C ? 2 * F : C;
    int grid = (rows + FFN_WARPS - 1) / FFN_WARPS;
    if (grid > per_sm * sms) grid = per_sm * sms;
    const uint8_t* a0 = (const uint8_t*)gu_qs2;
    const __nv_bfloat16* a1 = (const __nv_bfloat16*)gu_scale;
    const __nv_bfloat16* a2 = (const __nv_bfloat16*)gu_min;
    const uint8_t* a3 = (const uint8_t*)dn_qs2;
    const __nv_bfloat16* a4 = (const __nv_bfloat16*)dn_scale;
    const __nv_bfloat16* a5 = (const __nv_bfloat16*)dn_min;
    const __nv_bfloat16* a6 = (const __nv_bfloat16*)x;
    float* a7 = (float*)gu;
    __nv_bfloat16* a8 = (__nv_bfloat16*)abf;
    float* a9 = (float*)dxs;
    float* a10 = (float*)dfs;
    __nv_bfloat16* a11 = (__nv_bfloat16*)y;
    void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &a7, &a8, &a9, &a10,
                    &a11, &C, &F};
    err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                      dim3(FFN_THREADS), args, smem, st);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// One FFN, T = 1 (K15b, the magic-number row math) or 2 <= T <= 8 (K15a,
// the 2-D math). Scratch: gu (T * 2F) f32, abf (T * F) bf16, dxs and dfs
// (T * F/32) f32 each.
KCPP_API int k15_ffn_fused(const void* gu_qs2, const void* gu_scale,
                           const void* gu_min, const void* dn_qs2,
                           const void* dn_scale, const void* dn_min,
                           const void* x, void* gu, void* abf, void* dxs,
                           void* dfs, void* y, int T, int C, int F,
                           void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (C % 256 || F % 256) return (int)cudaErrorInvalidValue;
#define FFN_ARGS gu_qs2, gu_scale, gu_min, dn_qs2, dn_scale, dn_min, x, gu, \
        abf, dxs, dfs, y, C, F, st
    cudaError_t err;
    switch (T) {
        case 1: err = launch_ffn<1>(FFN_ARGS); break;
        case 2: err = launch_ffn<2>(FFN_ARGS); break;
        case 3: err = launch_ffn<3>(FFN_ARGS); break;
        case 4: err = launch_ffn<4>(FFN_ARGS); break;
        case 5: err = launch_ffn<5>(FFN_ARGS); break;
        case 6: err = launch_ffn<6>(FFN_ARGS); break;
        case 7: err = launch_ffn<7>(FFN_ARGS); break;
        case 8: err = launch_ffn<8>(FFN_ARGS); break;
        default: err = cudaErrorInvalidValue;
    }
#undef FFN_ARGS
    return (int)err;
}
