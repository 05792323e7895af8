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
// 0.625 B/weight). Both are one cooperative launch
// (cudaLaunchCooperativeKernel, every block resident) with two grid-wide
// barriers (cooperative_groups::this_grid().sync()): phase 1 the 2F gate/up
// rows into a global f32 scratch (T * 2F), barrier, phase 2 a, bf16(a) and
// the group sums of a, one warp per 32 activations, barrier, phase 3 the C
// down rows.
//
// K15b keeps the first design: every block sums x per 32 columns into
// shared memory, and phases 1 and 3 walk their rows grid-stride, one warp
// per row (a lane takes 16 bytes of nibbles, 16 columns of each plane).
//
// K15a is K7's design (csrc/q4k_matvec.cu, through csrc/q4k_ring.cuh) on
// bf16 products. The first one (K15b's row walk with the 2-D math: a
// scalar f32 FMA per column, token and lane, no weight in flight across
// either barrier) ran 10.3-10.6x its bound. This one:
//   * streams 16-row tiles of 8 superblocks of codes, scales and mins
//     through one cp.async ring whose items are the block's phase-1 (tile,
//     K step) pairs, then its phase-3 pairs: the first stages of its down
//     tiles are in flight across both barriers, so the weight stream does
//     not stop for phase 2 (`ffn_plan`: a persistent grid, two blocks an
//     SM);
//   * takes the products on mma.sync m16n8k16 bf16 -> f32: A = bf16(code *
//     s) made in registers from the ldmatrix code words (0x4300 | code is
//     bf16(128 + code), and one bf16x2 fma with s and -128 s rounds the
//     exact code * s once, as JAX's bf16 product does), B = x or bf16(a) of
//     up to 8 tokens with the k order inside 16 columns permuted alike in A
//     and B (lane t's k 2t, 2t+1, 8+2t, 9+2t are columns 4t..4t+3), so that
//     one 4-byte code word makes a lane's fragment. Both are kept in
//     B-fragment order (`ffn_bpos`: two 16-byte loads a lane and span), x
//     in every block's shared memory, bf16(a) in global memory (the L2),
//     where phase 2 writes it so. Four accumulators per thread (plane x
//     half) keep four mma chains in flight;
//   * the min term sum_g m_g xs_tg on mma.sync m16n8k8 bf16 (exact
//     products, f32 sums) once per superblock, xs of x in shared memory
//     and that of a in global memory (bf16).
// Warp w of a block takes superblock w of each stage; a tile's 8 partial
// sums meet in shared memory and are added in warp order. A token's mma
// column and every sum's order are fixed by (C, F) alone, so a token's row
// of y is the same bits at every T.
// Launch counters: ops/_build.launches["K15b"] (T = 1), ["K15a"].
#include <cooperative_groups.h>

#include "common.cuh"
#include "q4k_ring.cuh"

namespace cg = cooperative_groups;

constexpr int FFN_WARPS = 8;
constexpr int FFN_THREADS = FFN_WARPS * 32;
constexpr int FFN_MAX_T = 8;
constexpr int FFN_SMEM_MAX = 232448;

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

// ---------------------------------------------------------------------------
// K15b (T = 1)
// ---------------------------------------------------------------------------

// One q4_k row against one activation row `act` (in_f) bf16, the
// magic-number row math; the warp returns y in every lane. fsum (in_f/32):
// the f32 sums of the values multiplied; xs (in_f/32): the bf16-rounded
// group sums.
__device__ __forceinline__ float q4k_row(const uint8_t* __restrict__ wrow,
                                         const __nv_bfloat16* __restrict__ srow,
                                         const __nv_bfloat16* __restrict__ mrow,
                                         const __nv_bfloat16* act,
                                         const float* fsum, const float* xs,
                                         int in_f, int lane) {
    const int ng = in_f / 32;
    const int nchunk = in_f / 32;  // 16-byte chunks of the row
    float acc = 0.f;
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
            acc = __fmaf_rn(s_lo, __fmaf_rn(16.f, fsum[g_lo], plo), acc);
            acc = __fmaf_rn(s_hi, __fmaf_rn(16.f, fsum[g_hi], phi), acc);
        }
    }
    float accm = 0.f;  // - sum_g (16 s_g + m_g) xs_g
    for (int g = lane; g < ng; g += 32)
        accm = __fmaf_rn(__fmaf_rn(16.f, bf2f(srow[g]), bf2f(mrow[g])), xs[g],
                         accm);
    return warp_sum(acc) - warp_sum(accm);
}

__global__ void __launch_bounds__(FFN_THREADS)
ffn_t1_kernel(const uint8_t* __restrict__ gu_qs2,
              const __nv_bfloat16* __restrict__ gu_scale,
              const __nv_bfloat16* __restrict__ gu_min,
              const uint8_t* __restrict__ dn_qs2,
              const __nv_bfloat16* __restrict__ dn_scale,
              const __nv_bfloat16* __restrict__ dn_min,
              const __nv_bfloat16* __restrict__ x,  // (C)
              // scratch written and read back across the barriers: no
              // __restrict__, so no load of it takes the read-only path
              float* gu,                            // (2F)
              __nv_bfloat16* abf,                   // (F)
              float* dxs,                           // (F/32)
              float* dfs,                           // (F/32)
              __nv_bfloat16* __restrict__ y,        // (C)
              int C, int F) {
    extern __shared__ float smem_f[];  // x's group sums: xs (C/32), fs
    cg::grid_group grid = cg::this_grid();
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int ngc = C / 32, ngf = F / 32;
    float* xs_s = smem_f;
    float* fs_s = smem_f + ngc;
    for (int i = warp; i < ngc; i += FFN_WARPS) {
        const float s = warp_sum(bf2f(x[(size_t)i * 32 + lane]));
        if (lane == 0) {
            xs_s[i] = bf2f(f2bf(s));
            fs_s[i] = s;
        }
    }
    __syncthreads();
    const int gw = blockIdx.x * FFN_WARPS + warp;
    const int nw = gridDim.x * FFN_WARPS;

    // phase 1: gate/up rows -> f32 scratch
    for (int r = gw; r < 2 * F; r += nw) {
        const float out = q4k_row(gu_qs2 + (size_t)r * (C / 2),
                                  gu_scale + (size_t)r * ngc,
                                  gu_min + (size_t)r * ngc, x, fs_s, xs_s, C,
                                  lane);
        if (lane == 0) gu[r] = out;
    }
    grid.sync();

    // phase 2: a = u * g * sigmoid(g), bf16(a) and the group sums
    for (int i = gw; i < ngf; i += nw) {
        const int j = i * 32 + lane;
        const float g = gu[j];
        const float u = gu[F + j];
        const float a = __fmul_rn(__fmul_rn(u, g), 1.0f / (1.0f + expf(-g)));
        const __nv_bfloat16 ab = f2bf(a);
        abf[j] = ab;
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
        const float out = q4k_row(dn_qs2 + (size_t)r * (F / 2),
                                  dn_scale + (size_t)r * ngf,
                                  dn_min + (size_t)r * ngf, abf, dfs, dxs, F,
                                  lane);
        if (lane == 0) y[r] = f2bf(out);
    }
}

// ---------------------------------------------------------------------------
// K15a (2 <= T <= 8)
// ---------------------------------------------------------------------------

// a tile's partial sums per token: the 8 warps' values of its 16 rows and
// 4 floats of padding
constexpr int FFN_PART_T = Q4R_KS * Q4R_RT + 4;

// Byte offsets of K15a's dynamic shared memory, as `ffn_layout` computes
// them (ops/ffn_fused.py): `stages` ring stages (16 rows of 8 superblocks
// of codes, then per row the 8 x 8 bf16 scales, the mins and 16 B of
// padding), x in B-fragment order (per token C bf16 and 16 B of padding,
// so that the 8 tokens of a load fall on different banks), x's group sums
// xs ([T][C/32] bf16), the tile's partial sums ([2][8 tokens][8 warps][16
// rows] f32).
struct FfnLayout {
    int stage, xi_off, xs_off, part_off, total;
};

__host__ __device__ inline FfnLayout ffn_layout(int T, int C, int stages) {
    FfnLayout L;
    L.stage = Q4R_RT * (Q4R_QS_PITCH + Q4R_SM_PITCH);
    L.xi_off = stages * L.stage;
    L.xs_off = L.xi_off + T * (2 * C + 16);
    L.part_off = L.xs_off + T * (C / 32) * 2;
    L.total = L.part_off + 2 * FFN_MAX_T * FFN_PART_T * 4;
    return L;
}

// B-fragment order of the activations (x in shared memory, bf16(a) in
// global memory): column jj of a 256-column superblock (plane p = jj / 128,
// span k, half h of the span's 32 columns, lane tig = (jj / 4) % 4, e =
// jj % 4) sits at k * 64 + tig * 16 + p * 8 + h * 4 + e, so that two
// 16-byte loads give a lane its B words of both planes of a span
__device__ __forceinline__ int ffn_bpos(int jj) {
    return ((jj >> 5) & 3) * 64 + ((jj >> 2) & 3) * 16 + (jj >> 7) * 8
           + ((jj >> 4) & 1) * 4 + (jj & 3);
}

// acc[h] (16 rows x 8 tokens) += bf16(code * s) . B over the 16-column
// half h of 32 columns of one plane: c[e] the code words (e even row gid,
// odd gid + 8; e >= 2 the second half), m0 / m8 the rows' scales as bf16x2,
// b[h] this lane's B words of half h. A = bf16(128 + code) * s - 128 s,
// rounded once: bf16(code * s), JAX's bf16 product
__device__ __forceinline__ void ffn_plane(float (&acc)[2][4],
                                          const uint32_t (&c)[4], uint32_t m0,
                                          uint32_t m8, const uint2 (&b)[2]) {
    const uint32_t neg128 = 0xC300C300u;  // bf16x2 (-128, -128)
    const uint32_t n0 = bf16x2_mul(m0, neg128), n8 = bf16x2_mul(m8, neg128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const uint32_t w0 = c[2 * h], w8 = c[2 * h + 1];
        const uint32_t a[4] = {
            bf16x2_fma(__byte_perm(w0, 0x43434343u, 0x4140), m0, n0),
            bf16x2_fma(__byte_perm(w8, 0x43434343u, 0x4140), m8, n8),
            bf16x2_fma(__byte_perm(w0, 0x43434343u, 0x4342), m0, n0),
            bf16x2_fma(__byte_perm(w8, 0x43434343u, 0x4342), m8, n8)};
        mma16816(acc[h], a, b[h].x, b[h].y);
    }
}

__global__ void __launch_bounds__(FFN_THREADS, 2)
ffn2d_kernel(const uint8_t* __restrict__ gu_qs2,
             const __nv_bfloat16* __restrict__ gu_scale,
             const __nv_bfloat16* __restrict__ gu_min,
             const uint8_t* __restrict__ dn_qs2,
             const __nv_bfloat16* __restrict__ dn_scale,
             const __nv_bfloat16* __restrict__ dn_min,
             const __nv_bfloat16* __restrict__ x,  // (T, C)
             // scratch written and read back across the barriers: no
             // __restrict__, so no load of it takes the read-only path
             float* gu,                            // (T, 2F)
             __nv_bfloat16* abf,                   // (T, F), B order
             __nv_bfloat16* dxs,                   // (T, F/32)
             __nv_bfloat16* __restrict__ y,        // (T, C)
             int T, int C, int F, int stages) {
    extern __shared__ __align__(16) uint8_t smem[];
    cg::grid_group grid = cg::this_grid();
    const FfnLayout L = ffn_layout(T, C, stages);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int G = gridDim.x, b = blockIdx.x;
    // phase 1: 2F rows of C columns; phase 3: C rows of F columns
    const int ks1 = (C / 256 + Q4R_KS - 1) / Q4R_KS;
    const int ks3 = (F / 256 + Q4R_KS - 1) / Q4R_KS;
    const int nt1 = 2 * F / Q4R_RT, nt3 = C / Q4R_RT;
    const int total1 = (b < nt1 ? (nt1 - 1 - b) / G + 1 : 0) * ks1;
    const int total = total1 + (b < nt3 ? (nt3 - 1 - b) / G + 1 : 0) * ks3;
    // item it of the block's walk: its phase, tile row and K step
    auto item = [&](int it, bool& p3, int& row0, int& ks) {
        p3 = it >= total1;
        const int j = p3 ? it - total1 : it, kn = p3 ? ks3 : ks1;
        row0 = (b + (j / kn) * G) * Q4R_RT;
        ks = j % kn;
    };
    auto issue = [&](int it, int slot) {
        bool p3;
        int row0, ks;
        item(it, p3, row0, ks);
        const int in_f = p3 ? F : C;
        uint8_t* st = smem + slot * L.stage;
        q4k_copy_codes(st, p3 ? dn_qs2 : gu_qs2, in_f / 2, row0,
                       ks * Q4R_KS, in_f / 256, tid);
        q4k_copy_scale_min(st + Q4R_RT * Q4R_QS_PITCH, p3 ? dn_scale : gu_scale,
                           p3 ? dn_min : gu_min, in_f / 32, row0, ks * Q4R_KS,
                           in_f / 256, tid);
    };
    // x's bf16 group sums and x in B-fragment order: 4 lanes per (token,
    // group), 8 columns (one 16-byte load) each, 8 loads a thread in
    // flight; the first round's loads go out before the weight stream, so
    // that they do not queue behind it
    const int xpitch = C + 8;  // bf16 per token row of the image
    __nv_bfloat16* xi_s = reinterpret_cast<__nv_bfloat16*>(smem + L.xi_off);
    __nv_bfloat16* xs_s = reinterpret_cast<__nv_bfloat16*>(smem + L.xs_off);
    const int nxt = T * (C / 32) * 4;
    uint4 raw[8];
    auto load_x = [&](int base) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int li = base + u * FFN_THREADS + tid;
            raw[u] = li < nxt ? *reinterpret_cast<const uint4*>(
                                    x + (size_t)(li >> 2) * 32 + 8 * (li & 3))
                              : make_uint4(0u, 0u, 0u, 0u);
        }
    };
    load_x(0);
    for (int s = 0; s < stages - 1; ++s) {
        if (s < total) issue(s, s);
        cp_async_commit();
    }
    for (int base = 0; base < nxt; base += 8 * FFN_THREADS) {
        if (base) load_x(base);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            if (base + u * FFN_THREADS >= nxt) break;  // the same for all
            const int li = base + u * FFN_THREADS + tid;
            const uint32_t w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
            float sm = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                sm = __fadd_rn(sm, __uint_as_float(w[e] << 16));
                sm = __fadd_rn(sm, __uint_as_float(w[e] & 0xFFFF0000u));
            }
            sm = group_sum(sm, 4);  // every lane of the warp takes part
            if (li < nxt) {
                const int t = (li >> 2) / (C / 32);
                const int j = (li >> 2) * 32 - t * C + 8 * (li & 3);
                __nv_bfloat16* d = xi_s + t * xpitch + (j & ~255)
                                   + ffn_bpos(j & 255);
                *reinterpret_cast<uint2*>(d) = make_uint2(w[0], w[1]);
                *reinterpret_cast<uint2*>(d + 16) = make_uint2(w[2], w[3]);
                if ((li & 3) == 0) xs_s[li >> 2] = f2bf(sm);
            }
        }
    }

    // phase 2 between the barriers: a = u * g * sigmoid(g), bf16(a) (in
    // B-fragment order) and the bf16 group sums of the f32 a, one warp per
    // 32 activations
    auto phase2 = [&]() {
        grid.sync();
        const int ngf = F / 32;
        for (int i = b * FFN_WARPS + warp; i < T * ngf; i += G * FFN_WARPS) {
            const int t = i / ngf;
            const int j = (i % ngf) * 32 + lane;
            const float g = gu[(size_t)t * 2 * F + j];
            const float u = gu[(size_t)t * 2 * F + F + j];
            const float a = __fmul_rn(__fmul_rn(u, g), 1.0f / (1.0f + expf(-g)));
            abf[(size_t)t * F + (j & ~255) + ffn_bpos(j & 255)] = f2bf(a);
            const float s = warp_sum(a);
            if (lane == 0) dxs[i] = f2bf(s);
        }
        grid.sync();
    };

    // this thread's C rows gid, gid + 8 and tokens 2 tig, 2 tig + 1
    // (acc[.][.][2 * rowsel + token]): four accumulators, one per plane and
    // half, so that the products' mma chains run side by side; accm: the
    // min term's, the same layout
    float acc[2][2][4] = {}, accm[4] = {0.f, 0.f, 0.f, 0.f};
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row
    const uint4 h0[4] = {};                               // no bit plane
    bool mid = false;
    int slot = 0;
    for (int it = 0; it < total; ++it) {
        if (it == total1) {
            phase2();
            mid = true;
        }
        cp_async_wait_n(stages - 2);
        __syncthreads();
        if (it + stages - 1 < total)
            issue(it + stages - 1, slot == 0 ? stages - 1 : slot - 1);
        cp_async_commit();
        bool p3;
        int row0, ks;
        item(it, p3, row0, ks);
        const int in_f = p3 ? F : C, ng = in_f / 32;
        const int sb = ks * Q4R_KS + warp;
        if (sb < in_f / 256) {
            // token gid's activations of this lane's columns, loaded before
            // the stage's code words are read: bv[k] group k's (low plane),
            // bv[k + 4] group k + 4's, each the span's two halves
            uint2 bv[8][2] = {};
            if (gid < T) {
                const __nv_bfloat16* br =
                    (p3 ? abf + (size_t)gid * F : xi_s + gid * xpitch)
                    + sb * 256 + tig * 16;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const uint4 lo = *reinterpret_cast<const uint4*>(br + k * 64);
                    const uint4 hi = *reinterpret_cast<const uint4*>(br + k * 64 + 8);
                    bv[k][0] = make_uint2(lo.x, lo.y);
                    bv[k][1] = make_uint2(lo.z, lo.w);
                    bv[k + 4][0] = make_uint2(hi.x, hi.y);
                    bv[k + 4][1] = make_uint2(hi.z, hi.w);
                }
            }
            const uint8_t* st = smem + slot * L.stage;
            const uint8_t* scb = st + Q4R_RT * Q4R_QS_PITCH;
            const uint4 s_r = *reinterpret_cast<const uint4*>(
                scb + gid * Q4R_SM_PITCH + warp * 16);
            const uint4 s_r8 = *reinterpret_cast<const uint4*>(
                scb + (gid + 8) * Q4R_SM_PITCH + warp * 16);
            {
                // the min term of the superblock's 8 groups: accm += m
                // (bf16) . xs (bf16), products exact in f32
                const uint8_t* mb = scb + (Q4R_KS + warp) * 16 + 4 * tig;
                const uint32_t m0 = *reinterpret_cast<const uint32_t*>(
                    mb + gid * Q4R_SM_PITCH);
                const uint32_t m1 = *reinterpret_cast<const uint32_t*>(
                    mb + (gid + 8) * Q4R_SM_PITCH);
                const __nv_bfloat16* xs = p3 ? dxs : xs_s;
                uint32_t xs2 = 0u;
                if (gid < T)
                    xs2 = *reinterpret_cast<const uint32_t*>(
                        xs + gid * ng + sb * 8 + 2 * tig);
                mma1688(accm, m0, m1, xs2);
            }
            const uint8_t* arow = st + lrow * Q4R_QS_PITCH + warp * 128;
            // the scale of group g of rows gid / gid + 8 as bf16x2 (s, s)
            auto sdup = [](const uint4& v, int g) {
                return __byte_perm(u4_at(v, g >> 1), 0u,
                                   g & 1 ? 0x3232 : 0x1010);
            };
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                uint32_t clo[4], chi[4];
                q4k_codes<false>(arow, lane, lrow, tig, k, h0, clo, chi);
                // group k (low nibbles), then group k + 4
                ffn_plane(acc[0], clo, sdup(s_r, k), sdup(s_r8, k), bv[k]);
                ffn_plane(acc[1], chi, sdup(s_r, k + 4), sdup(s_r8, k + 4),
                          bv[k + 4]);
            }
        }
        if (ks == (p3 ? ks3 : ks1) - 1) {
            // the tile's 8 K parts meet in shared memory; one thread per
            // (row, token) adds them in warp order
            float* part = reinterpret_cast<float*>(smem + L.part_off);
            constexpr int PM = FFN_MAX_T * FFN_PART_T;  // the min half
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float* pa = part + (2 * tig + (e & 1)) * FFN_PART_T
                            + warp * Q4R_RT + gid + 8 * (e >> 1);
                pa[0] = __fadd_rn(__fadd_rn(acc[0][0][e], acc[0][1][e]),
                                  __fadd_rn(acc[1][0][e], acc[1][1][e]));
                pa[PM] = accm[e];
                acc[0][0][e] = acc[0][1][e] = acc[1][0][e] = acc[1][1][e] = 0.f;
                accm[e] = 0.f;
            }
            __syncthreads();
            if (tid < Q4R_RT * T) {
                const int t = tid / Q4R_RT, r = tid % Q4R_RT;
                const float* pt = part + t * FFN_PART_T + r;
                float sa = pt[0], sm = pt[PM];
#pragma unroll
                for (int w = 1; w < Q4R_KS; ++w) {
                    sa = __fadd_rn(sa, pt[w * Q4R_RT]);
                    sm = __fadd_rn(sm, pt[PM + w * Q4R_RT]);
                }
                const float v = __fsub_rn(sa, sm);
                if (p3)
                    y[(size_t)t * C + row0 + r] = f2bf(v);
                else
                    gu[(size_t)t * 2 * F + row0 + r] = v;
            }
        }
        slot = slot + 1 == stages ? 0 : slot + 1;
    }
    if (!mid) phase2();  // every block meets both barriers
    cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

static cudaError_t blocks_per_sm(const void* kern, int smem, int* n) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, FFN_THREADS, smem)) != cudaSuccess)
        return err;
    *n = per_sm * sms;
    return cudaSuccess;
}

// K15b: one FFN at T = 1 (the magic-number row math). Scratch: gu (2F) f32,
// abf (F) bf16, dxs and dfs (F/32) f32 each.
KCPP_API int k15_ffn_fused(const void* gu_qs2, const void* gu_scale,
                           const void* gu_min, const void* dn_qs2,
                           const void* dn_scale, const void* dn_min,
                           const void* x, void* gu, void* abf, void* dxs,
                           void* dfs, void* y, int C, int F, void* stream) {
    if (C % 256 || F % 256) return (int)cudaErrorInvalidValue;
    const void* kern = (const void*)ffn_t1_kernel;
    const int smem = 2 * (C / 32) * (int)sizeof(float);
    cudaError_t err;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            ffn_t1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    int resident = 0;
    if ((err = blocks_per_sm(kern, smem, &resident)) != cudaSuccess)
        return (int)err;
    if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    const int rows = 2 * F > C ? 2 * F : C;
    int grid = (rows + FFN_WARPS - 1) / FFN_WARPS;
    if (grid > resident) grid = resident;
    void* args[] = {&gu_qs2, &gu_scale, &gu_min, &dn_qs2, &dn_scale, &dn_min,
                    &x, &gu, &abf, &dxs, &dfs, &y, &C, &F};
    err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(FFN_THREADS),
                                      args, smem, (cudaStream_t)stream);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// K15a: one FFN at 2 <= T <= 8 (the 2-D math). grid, stages and smem come
// from `ffn_plan`; a plan whose shared memory differs from this source's
// layout, or whose grid is not all resident, is refused. Scratch: gu (T *
// 2F) f32, abf (T * F) bf16, dxs (T * F/32) bf16.
KCPP_API int k15a_ffn(const void* gu_qs2, const void* gu_scale,
                      const void* gu_min, const void* dn_qs2,
                      const void* dn_scale, const void* dn_min, const void* x,
                      void* gu, void* abf, void* dxs, void* y, int T, int C,
                      int F, int grid, int stages, int smem, void* stream) {
    if (T < 2 || T > FFN_MAX_T || C <= 0 || F <= 0 || C % 256 || F % 256
        || grid < 1 || stages < 3 || stages > 4 || smem > FFN_SMEM_MAX
        || smem != ffn_layout(T, C, stages).total)
        return (int)cudaErrorInvalidValue;
    static bool ready = false;  // the opt-in above 48 KB, once
    cudaError_t err;
    if (!ready) {
        err = cudaFuncSetAttribute(ffn2d_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   FFN_SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    const void* kern = (const void*)ffn2d_kernel;
    int resident = 0;
    if ((err = blocks_per_sm(kern, smem, &resident)) != cudaSuccess)
        return (int)err;
    if (grid > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&gu_qs2, &gu_scale, &gu_min, &dn_qs2, &dn_scale, &dn_min,
                    &x, &gu, &abf, &dxs, &y, &T, &C, &F, &stages};
    err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(FFN_THREADS),
                                      args, smem, (cudaStream_t)stream);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
