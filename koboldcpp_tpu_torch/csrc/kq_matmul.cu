// K3: q4_k / q5_k / q6_k / q8_0 tiled matmul for prefill, y (T, out_f)
// bf16 = x (T, in_f) bf16 . W^T with f32 accumulation; K13: its q2_k /
// q3_k, native IQ (iq2p / iq3px / iq3ps / iq1p) and q4_k_i8 bodies.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matmul_2d`: bodies
// `_q4k_kernel` (the default KCPP_Q4K_2D=sexp), `_q5k_kernel`, `_q6k_kernel`
// and `_q8_0_kernel` (K3), `_q2k_kernel`, `_q3k_kernel`, `_iq2p_kernel`,
// `_iq3p_kernel` (iq3px and iq3ps), `_iq1p_kernel` and `_q4k_i8_kernel`
// (K13; the last under KCPP_Q4K_LAYOUT=i8, at every T). As there, the
// weight fed to the product is bf16(q * scale) (q4_k: the nibble 0..15;
// q5_k: the nibble with its 5th bit, 0..31; q6_k: the 6-bit value 0..63;
// q8_0: the int8 code; q2_k: the 2-bit code 0..3; q3_k: the 2-bit code with
// its hmask bit, 0..7; the IQ kinds: the signed alphabet value, |v| <= 62,
// with the scale of its group of G = 8, 16 or 32; q4_k_i8: the int8 code
// 0..15), and the affine part is a second, small product over per-group
// sums of x: q4_k, q5_k and q4_k_i8 subtract xsum_bf16 . min (groups of
// 32), q2_k xsum_bf16 . min (groups of 16), iq1p xsum_bf16 . min (groups
// of G), q6_k 32 * xsum_bf16 . scale and q3_k 4 * xsum_bf16 . scale
// (groups of 16), q8_0 and iq2p / iq3px / iq3ps have none. Both terms run
// through the same tensor-core loop: the K loop first walks in_f with B =
// the dequantized weight tile, then walks the groups with A = the group
// sums and B = -min (q4_k, q5_k, q2_k, iq1p, q4_k_i8), -32*scale (q6_k) or
// -4*scale (q3_k), all exact in bf16.
//
// Bound on the H100: operations at T=512 (2*T*in*out bf16 FLOPs over
// 989 TFLOP/s), bytes at small T. Design: a 64x64 output tile per block of
// 4 warps, 32-column K steps; each step dequantizes the weight tile into
// shared memory as bf16 and runs WMMA 16x16x16 bf16 products with f32
// accumulators (mma.sync underneath). No TMA / wgmma / multi-stage
// pipeline yet.
// Launch counters: ops/_build.launches["K3"] (q4_k, q6_k), ["K3.q5_k"],
// ["K3.q8_0"], ["K13.q2_k"], ["K13.q3_k"], ["K13.iq2p"], ["K13.iq3px"],
// ["K13.iq3ps"], ["K13.iq1p"] and ["K13.q4_k_i8"], one per matmul.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32, LDS = BK + 8, LDC = BN + 4;

// 0 = q4_k, 1 = q6_k, 2 = q5_k, 3 = q8_0, 4 = q2_k, 5 = q3_k, 6 = iq2p,
// 7 = iq3px, 8 = iq3ps, 9 = iq1p, 10 = q4_k_i8
template <int KIND>
__global__ void __launch_bounds__(128)
kq_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ xs,
                 // qs2 | ql | qs2 | q | qs | qs | qs (IQ kinds) | q
                 const uint8_t* __restrict__ w0,
                 // - | qh | qh bits | - | - | hmask | iq3px/iq3ps hmask
                 const uint8_t* __restrict__ w1,
                 // iq2p / iq3px / iq3ps sg
                 const uint8_t* __restrict__ w2,
                 const __nv_bfloat16* __restrict__ scale,
                 // q4_k / q5_k / q2_k / iq1p / q4_k_i8 min
                 const __nv_bfloat16* __restrict__ mn,
                 __nv_bfloat16* __restrict__ y, int T, int out_f, int in_f,
                 int grp) {  // the IQ kinds' scale group G (8, 16, 32)
    __shared__ __align__(32) __nv_bfloat16 As[BM][LDS];
    __shared__ __align__(32) __nv_bfloat16 Bs[BN][LDS];
    __shared__ __align__(32) float Cs[BM][LDC];

    const int tid = threadIdx.x, warp = tid >> 5;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    // affine-term groups (none for q8_0, iq2p, iq3px, iq3ps)
    constexpr bool G16 = KIND == 1 || KIND == 4 || KIND == 5;
    constexpr bool IQ = KIND >= 6 && KIND <= 9;
    const int G = G16 ? in_f / 16 : KIND == 9 ? in_f / grp
                : (KIND == 3 || IQ) ? 0 : in_f / 32;
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
            if (KIND == 0 || KIND == 2) {
                const int plane = within / 128;           // lo / hi nibble
                const uint4 wv = *reinterpret_cast<const uint4*>(
                    w0 + (size_t)orow * (in_f / 2) + sb * 128
                    + (within % 128) + c16);
                const uint32_t ws[4] = {wv.x, wv.y, wv.z, wv.w};
                // q5_k: the 5th bits of logical cols k0+c16 .. +15
                const uint32_t hb = KIND == 2
                    ? *reinterpret_cast<const uint16_t*>(
                          w1 + (size_t)orow * (in_f / 8) + (k0 + c16) / 8)
                    : 0u;
                const float s = bf2f(scale[(size_t)orow * (in_f / 32) + k0 / 32]);
#pragma unroll
                for (int e = 0; e < 16; ++e) {
                    const uint32_t byte = (ws[e >> 2] >> (8 * (e & 3))) & 0xFFu;
                    const uint32_t q = (plane ? (byte >> 4) : (byte & 0xF))
                                       | (((hb >> e) & 1u) << 4);
                    Bs[r][c16 + e] = f2bf((float)q * s);
                }
            } else if (KIND == 3 || KIND == 10) {  // int8 codes
                const uint4 wv = *reinterpret_cast<const uint4*>(
                    w0 + (size_t)orow * in_f + k0 + c16);
                const uint32_t ws[4] = {wv.x, wv.y, wv.z, wv.w};
                const float s = bf2f(scale[(size_t)orow * (in_f / 32) + k0 / 32]);
#pragma unroll
                for (int e = 0; e < 16; ++e) {
                    const int8_t q = (int8_t)((ws[e >> 2] >> (8 * (e & 3))) & 0xFFu);
                    Bs[r][c16 + e] = f2bf((float)q * s);
                }
            } else if (IQ) {
                // cols k0+c16 .. +15 are l = c16 .. c16+15 of plane j, half
                // h; the first 8 lie in group (k0+c16)/grp, the last 8 in
                // (k0+c16+8)/grp (the same group unless grp == 8)
                const int h = within / 128, j = (within % 128) / 32;
                const uint4 qv = *reinterpret_cast<const uint4*>(
                    w0 + (size_t)orow * (in_f / 4) + sb * 64 + h * 32 + c16);
                const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
                const size_t off8 = (size_t)orow * (in_f / 8) + sb * 32 + c16;
                uint32_t hw[4] = {0u, 0u, 0u, 0u}, sw[4] = {0u, 0u, 0u, 0u};
                if (KIND == 7 || KIND == 8) {
                    const uint4 hv = *reinterpret_cast<const uint4*>(w1 + off8);
                    hw[0] = hv.x; hw[1] = hv.y; hw[2] = hv.z; hw[3] = hv.w;
                }
                if (KIND != 9) {
                    const uint4 sv = *reinterpret_cast<const uint4*>(w2 + off8);
                    sw[0] = sv.x; sw[1] = sv.y; sw[2] = sv.z; sw[3] = sv.w;
                }
                const __nv_bfloat16* srow = scale + (size_t)orow * (in_f / grp);
                const float s_lo = bf2f(srow[(k0 + c16) / grp]);
                const float s_hi = bf2f(srow[(k0 + c16 + 8) / grp]);
#pragma unroll
                for (int e = 0; e < 16; ++e) {
                    const int sh = 8 * (e & 3), bit = sh + 4 * h + j;
                    int q = (int)((qw[e >> 2] >> (sh + 2 * j)) & 3u);
                    if (KIND == 7 || KIND == 8)
                        q |= (int)((hw[e >> 2] >> bit) & 1u) << 2;
                    int v = KIND == 6 ? 8 + 17 * q + (q >> 1)
                          : KIND == 7 ? (q == 7 ? 62 : 4 + 8 * q)
                          : KIND == 8 ? 2 * q + 1 : q - 1;
                    if (KIND != 9 && ((sw[e >> 2] >> bit) & 1u)) v = -v;
                    Bs[r][c16 + e] = f2bf((float)v * (e < 8 ? s_lo : s_hi));
                }
            } else if (KIND == 4 || KIND == 5) {
                // cols k0+c16 .. +15 are l = c16 .. c16+15 of plane j, half h
                const int h = within / 128, j = (within % 128) / 32;
                const uint4 qv = *reinterpret_cast<const uint4*>(
                    w0 + (size_t)orow * (in_f / 4) + sb * 64 + h * 32 + c16);
                const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
                uint32_t hw[4] = {0u, 0u, 0u, 0u};
                if (KIND == 5) {
                    const uint4 hv = *reinterpret_cast<const uint4*>(
                        w1 + (size_t)orow * (in_f / 8) + sb * 32 + c16);
                    hw[0] = hv.x; hw[1] = hv.y; hw[2] = hv.z; hw[3] = hv.w;
                }
                const float s = bf2f(scale[(size_t)orow * (in_f / 16)
                                           + k0 / 16 + (c16 >> 4)]);
#pragma unroll
                for (int e = 0; e < 16; ++e) {
                    const int sh = 8 * (e & 3);
                    uint32_t q = (qw[e >> 2] >> (sh + 2 * j)) & 3u;
                    if (KIND == 5)
                        q |= ((hw[e >> 2] >> (sh + 4 * h + j)) & 1u) << 2;
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
            // affine term: A = group sums of x, B = -min | -32 * scale |
            // -4 * scale (never reached for q8_0, iq2p, iq3px, iq3ps: G = 0)
            const int g0 = (kt - nk1) * BK + c16;
#pragma unroll
            for (int e = 0; e < 16; ++e) {
                const int g = g0 + e;
                const bool ok = g < G;
                As[r][c16 + e] = (ok && t < T) ? xs[(size_t)t * G + g]
                                               : f2bf(0.f);
                float b = 0.f;
                if (ok) {
                    b = KIND == 1 ? -32.f * bf2f(scale[(size_t)orow * G + g])
                      : KIND == 5 ? -4.f * bf2f(scale[(size_t)orow * G + g])
                                  : -bf2f(mn[(size_t)orow * G + g]);
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
// q6_k: w0=ql, w1=qh; q5_k: w0=qs2, w1=qh (bit plane), mn=min; q8_0: w0=q,
// no xs; q2_k: w0=qs, mn=min; q3_k: w0=qs, w1=hmask; iq2p: w0=qs, w2=sg,
// no xs; iq3px / iq3ps: w0=qs, w1=hmask, w2=sg, no xs; iq1p: w0=qs,
// mn=min, xs per group of grp. grp: the IQ kinds' scale group (8, 16 or
// 32; ignored by the other kinds); q4_k_i8: w0=q (int8 codes), mn=min.
// y (T, out_f) bf16. out_f % 64 == 0,
// in_f % 256 == 0.
KCPP_API int k3_kq_matmul(int kind, const void* x, const void* xs,
                          const void* w0, const void* w1, const void* w2,
                          const void* scale, const void* mn, void* y, int T,
                          int out_f, int in_f, int grp, void* stream) {
    if (kind >= 6 && kind <= 9 && grp != 8 && grp != 16 && grp != 32)
        return (int)cudaErrorInvalidValue;
    dim3 grid(out_f / BN, (T + BM - 1) / BM);
    cudaStream_t st = (cudaStream_t)stream;
#define K3_ARGS (const __nv_bfloat16*)x, (const __nv_bfloat16*)xs, \
        (const uint8_t*)w0, (const uint8_t*)w1, (const uint8_t*)w2, \
        (const __nv_bfloat16*)scale, (const __nv_bfloat16*)mn, \
        (__nv_bfloat16*)y, T, out_f, in_f, grp
    switch (kind) {
        case 0: kq_matmul_kernel<0><<<grid, 128, 0, st>>>(K3_ARGS); break;
        case 1: kq_matmul_kernel<1><<<grid, 128, 0, st>>>(K3_ARGS); break;
        case 2: kq_matmul_kernel<2><<<grid, 128, 0, st>>>(K3_ARGS); break;
        case 3: kq_matmul_kernel<3><<<grid, 128, 0, st>>>(K3_ARGS); break;
        case 4: kq_matmul_kernel<4><<<grid, 128, 0, st>>>(K3_ARGS); break;
        case 5: kq_matmul_kernel<5><<<grid, 128, 0, st>>>(K3_ARGS); break;
        case 6: kq_matmul_kernel<6><<<grid, 128, 0, st>>>(K3_ARGS); break;
        case 7: kq_matmul_kernel<7><<<grid, 128, 0, st>>>(K3_ARGS); break;
        case 8: kq_matmul_kernel<8><<<grid, 128, 0, st>>>(K3_ARGS); break;
        case 9: kq_matmul_kernel<9><<<grid, 128, 0, st>>>(K3_ARGS); break;
        case 10: kq_matmul_kernel<10><<<grid, 128, 0, st>>>(K3_ARGS); break;
        default: return (int)cudaErrorInvalidValue;
    }
#undef K3_ARGS
    return (int)cudaGetLastError();
}
