// K3: q4_k / q6_k tiled matmul for prefill, y (T, out_f) bf16 =
// x (T, in_f) bf16 . W^T with f32 accumulation.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matmul_2d`: bodies
// `_q4k_kernel` (the default KCPP_Q4K_2D=sexp) and `_q6k_kernel`.
// As there, the weight fed to the product is bf16(q * scale) (q4_k: the
// nibble 0..15; q6_k: the 6-bit value 0..63), and the affine part is a
// second, small product over per-group sums of x: q4_k subtracts
// xsum_bf16 . min (groups of 32), q6_k subtracts 32 * xsum_bf16 . scale
// (groups of 16). Both terms run through the same tensor-core loop: the K
// loop first walks in_f with B = the dequantized weight tile, then walks the
// groups with A = the group sums and B = -min (q4_k) or -32*scale (q6_k),
// both exact in bf16.
//
// Bound on the H100: operations at T=512 (2*T*in*out bf16 FLOPs over
// 989 TFLOP/s), bytes at small T. Design: a 64x64 output tile per block of
// 4 warps, 32-column K steps; each step dequantizes the weight tile into
// shared memory as bf16 and runs WMMA 16x16x16 bf16 products with f32
// accumulators (mma.sync underneath). No TMA / wgmma / multi-stage
// pipeline yet.
// Launch counter: ops/_build.launches["K3"] (one per matmul).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32, LDS = BK + 8, LDC = BN + 4;

template <int KIND>  // 0 = q4_k, 1 = q6_k
__global__ void __launch_bounds__(128)
kq_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ xs,
                 const uint8_t* __restrict__ w0,   // q4_k qs2 | q6_k ql
                 const uint8_t* __restrict__ w1,   // q6_k qh (unused q4_k)
                 const __nv_bfloat16* __restrict__ scale,
                 const __nv_bfloat16* __restrict__ mn,  // q4_k min
                 __nv_bfloat16* __restrict__ y, int T, int out_f, int in_f) {
    __shared__ __align__(32) __nv_bfloat16 As[BM][LDS];
    __shared__ __align__(32) __nv_bfloat16 Bs[BN][LDS];
    __shared__ __align__(32) float Cs[BM][LDC];

    const int tid = threadIdx.x, warp = tid >> 5;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int G = KIND == 0 ? in_f / 32 : in_f / 16;  // affine-term groups
    const int nk1 = in_f / BK, nk2 = (G + BK - 1) / BK;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    // each thread fills 16 consecutive K entries of one A row and one B row
    const int r = tid >> 1, c16 = (tid & 1) * 16;
    const int t = m0 + r;          // token row of A
    const int orow = n0 + r;       // weight row of B (out_f % BN == 0)

    for (int kt = 0; kt < nk1 + nk2; ++kt) {
        if (kt < nk1) {
            const int k0 = kt * BK;
            // A: 16 bf16 of x
            if (t < T) {
                const uint4* src = reinterpret_cast<const uint4*>(
                    x + (size_t)t * in_f + k0 + c16);
                *reinterpret_cast<uint4*>(&As[r][c16]) = src[0];
                *reinterpret_cast<uint4*>(&As[r][c16 + 8]) = src[1];
            } else {
                *reinterpret_cast<uint4*>(&As[r][c16]) = make_uint4(0, 0, 0, 0);
                *reinterpret_cast<uint4*>(&As[r][c16 + 8]) = make_uint4(0, 0, 0, 0);
            }
            // B: 16 dequantized weights bf16(q * s)
            const int sb = k0 / 256, within = k0 % 256;
            if (KIND == 0) {
                const int plane = within / 128;           // lo / hi nibble
                const uint4 wv = *reinterpret_cast<const uint4*>(
                    w0 + (size_t)orow * (in_f / 2) + sb * 128
                    + (within % 128) + c16);
                const uint32_t ws[4] = {wv.x, wv.y, wv.z, wv.w};
                const float s = bf2f(scale[(size_t)orow * (in_f / 32) + k0 / 32]);
#pragma unroll
                for (int e = 0; e < 16; ++e) {
                    const uint32_t byte = (ws[e >> 2] >> (8 * (e & 3))) & 0xFFu;
                    const uint32_t q = plane ? (byte >> 4) : (byte & 0xF);
                    Bs[r][c16 + e] = f2bf((float)q * s);
                }
            } else {
                const int h = within / 128, j = (within % 128) / 32;
                const uint4 lv = *reinterpret_cast<const uint4*>(
                    w0 + (size_t)orow * (in_f / 2) + sb * 128 + h * 64
                    + (j & 1) * 32 + c16);
                const uint4 hv = *reinterpret_cast<const uint4*>(
                    w1 + (size_t)orow * (in_f / 4) + sb * 64 + h * 32 + c16);
                const uint32_t ls[4] = {lv.x, lv.y, lv.z, lv.w};
                const uint32_t hs[4] = {hv.x, hv.y, hv.z, hv.w};
                const float s = bf2f(scale[(size_t)orow * (in_f / 16)
                                           + k0 / 16 + (c16 >> 4)]);
#pragma unroll
                for (int e = 0; e < 16; ++e) {
                    const uint32_t lb = (ls[e >> 2] >> (8 * (e & 3))) & 0xFFu;
                    const uint32_t hb = (hs[e >> 2] >> (8 * (e & 3))) & 0xFFu;
                    const uint32_t q = ((j >= 2) ? (lb >> 4) : (lb & 0xF))
                                       | (((hb >> (2 * j)) & 3u) << 4);
                    Bs[r][c16 + e] = f2bf((float)q * s);
                }
            }
        } else {
            // affine term: A = group sums of x, B = -min | -32 * scale
            const int g0 = (kt - nk1) * BK + c16;
#pragma unroll
            for (int e = 0; e < 16; ++e) {
                const int g = g0 + e;
                const bool ok = g < G;
                As[r][c16 + e] = (ok && t < T) ? xs[(size_t)t * G + g]
                                               : f2bf(0.f);
                float b = 0.f;
                if (ok) {
                    b = KIND == 0 ? -bf2f(mn[(size_t)orow * G + g])
                                  : -32.f * bf2f(scale[(size_t)orow * G + g]);
                }
                Bs[r][c16 + e] = f2bf(b);
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], &As[wm + 16 * i][kk], LDS);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(b[j], &Bs[wn + 16 * j][kk], LDS);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j],
                                    LDC, wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < BM * BN; idx += 128) {
        const int rr = idx / BN, cc = idx % BN;
        if (m0 + rr < T)
            y[(size_t)(m0 + rr) * out_f + n0 + cc] = f2bf(Cs[rr][cc]);
    }
}

// x (T, in_f) bf16, xs (T, G) bf16 group sums; q4_k: w0=qs2, mn=min;
// q6_k: w0=ql, w1=qh. y (T, out_f) bf16. out_f % 64 == 0, in_f % 256 == 0.
KCPP_API int k3_kq_matmul(int kind, const void* x, const void* xs,
                          const void* w0, const void* w1, const void* scale,
                          const void* mn, void* y, int T, int out_f, int in_f,
                          void* stream) {
    dim3 grid(out_f / BN, (T + BM - 1) / BM);
    cudaStream_t st = (cudaStream_t)stream;
#define K3_ARGS (const __nv_bfloat16*)x, (const __nv_bfloat16*)xs, \
        (const uint8_t*)w0, (const uint8_t*)w1, \
        (const __nv_bfloat16*)scale, (const __nv_bfloat16*)mn, \
        (__nv_bfloat16*)y, T, out_f, in_f
    if (kind == 0)
        kq_matmul_kernel<0><<<grid, 128, 0, st>>>(K3_ARGS);
    else
        kq_matmul_kernel<1><<<grid, 128, 0, st>>>(K3_ARGS);
#undef K3_ARGS
    return (int)cudaGetLastError();
}
