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
// 0.625 B/weight, 6.5 us at 3.35 TB/s). Both are one cooperative launch
// (cudaLaunchCooperativeKernel, every block resident) of one kernel with
// two grid-wide barriers (cooperative_groups::this_grid().sync()): phase 1
// the 2F gate/up rows into a global f32 scratch (T * 2F), barrier, phase 2
// a, bf16(a) and the group sums of a, one warp per 32 activations,
// barrier, phase 3 the C down rows. Their first designs (a warp per row,
// grid-stride, one 16-byte load a lane in flight, scalar scale and min
// loads, no weight in flight across either barrier, every block summing
// all of x) ran 5.1x (K15b) and 10.3-10.6x (K15a) their bound. This one
// is K7's design (csrc/q4k_matvec.cu, through csrc/q4k_ring.cuh):
//   * streams 16-row tiles of 8 superblocks of codes, scales and mins
//     through one cp.async ring whose items are the block's phase-1 (tile,
//     K step) pairs, then its phase-3 pairs: the first stages of its down
//     tiles are in flight across both barriers, so the weight stream does
//     not stop for phase 2 (`ffn_plan`: a persistent grid, two blocks an
//     SM);
//   * takes the products on mma.sync m16n8k16 bf16 -> f32 with the k order
//     inside 16 columns permuted alike in A and B (lane t's k 2t, 2t+1,
//     8+2t, 9+2t are columns 4t..4t+3), so that one 4-byte code word from
//     ldmatrix makes a lane's A fragment, and B = x or bf16(a) kept in
//     B-fragment order (`ffn_bpos`: two 16-byte loads a lane and span), x
//     in every block's shared memory (in windows of `kwin` K steps where
//     T tokens of it do not fit: each window prepped anew at its first K
//     step of every phase-1 tile, a template flag), bf16(a) in global
//     memory (the L2), where phase 2 writes it so.
//     K15a: A = bf16(code * s) (0x4300 | code is bf16(128 + code), and one
//     bf16x2 fma with s and -128 s rounds the exact code * s once, as
//     JAX's bf16 product does), B = up to 8 tokens; four accumulators per
//     thread (plane x half) keep four mma chains in flight; the min term
//     sum_g m_g xs_tg on mma.sync m16n8k8 bf16 once per superblock.
//     K15b: A = bf16(16 + code) (0x4180 | code << 3, exact), so each
//     group's two mmas give P/8 = sum (16 + q) x in f32 (exact products)
//     and one f32 fma with s_g adds the group; every B column is the
//     token, so each lane's C holds a row's sum and a lane combines one
//     row; the offset and min terms sum_g (16 s_g + m_g) xs_g on one
//     mma.sync m16n8k16 per superblock, A = [s | m] of 8 groups, B = [16
//     xs | xs] (16 xs exact in bf16), products exact, f32 sums. After
//     phase 2 each block that has down tiles loads a and its sums into its
//     shared memory in one round, so that phase 3 makes no L2 round trip
//     a K step (phase 2 in each such block, over all F, with one barrier
//     less, was slower: 23.0 against 20.8 us).
// Warp w of a block takes superblock w of each stage; a tile's 8 partial
// sums meet in shared memory and are added in warp order. A token's mma
// column and every sum's order are fixed by (C, F) alone, so a K15a
// token's row of y is the same bits at every T.
// Launch counters: ops/_build.launches["K15b"] (T = 1), ["K15a"].
#include <cooperative_groups.h>

#include "common.cuh"
#include "q4k_ring.cuh"

namespace cg = cooperative_groups;

constexpr int FFN_WARPS = 8;
constexpr int FFN_THREADS = FFN_WARPS * 32;
constexpr int FFN_MAX_T = 8;
constexpr int FFN_SMEM_MAX = 232448;

// ---------------------------------------------------------------------------
// K15b (T = 1) and K15a (2 <= T <= 8)
// ---------------------------------------------------------------------------

// a tile's partial sums per token: the 8 warps' values of its 16 rows and
// 4 floats of padding
constexpr int FFN_PART_T = Q4R_KS * Q4R_RT + 4;

// Byte offsets of K15's dynamic shared memory, as `ffn_layout` computes
// them (ops/ffn_fused.py): `stages` ring stages (16 rows of 8 superblocks
// of codes, then per row the 8 x 8 bf16 scales, the mins and 16 B of
// padding), x in B-fragment order (per token C bf16 and 16 B of padding,
// so that the 8 tokens of a load fall on different banks; C: x's columns,
// or those of its window), x's group sums
// xs ([T][C/32] bf16), the tile's partial sums ([2][8 tokens][8 warps][16
// rows] f32). At T = 1 (K15b) the x image and sums then hold phase 3's
// bf16(a) (F columns) and its sums: each region is the larger of the two.
struct FfnLayout {
    int stage, xi_off, xs_off, part_off, total;
};

__host__ __device__ inline FfnLayout ffn_layout(int T, int C, int stages,
                                                int F) {
    FfnLayout L;
    L.stage = Q4R_RT * (Q4R_QS_PITCH + Q4R_SM_PITCH);
    L.xi_off = stages * L.stage;
    const int a = T == 1 ? F : 0;  // K15b: a in the same regions
    L.xs_off = L.xi_off + T * (2 * (C > a ? C : a) + 16);
    L.part_off = L.xs_off + T * ((C > a ? C : a) / 32) * 2;
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

// K15b: the low bytes of bf16(16 + c) of the four nibbles of a code word
// a (low plane: the low nibbles; else the high ones): 0x80 | c << 3, so
// that 0x41 as each high byte makes 0x4180 | c << 3 = bf16(16 + c), exact
__device__ __forceinline__ uint32_t ffn_c16(uint32_t a, bool low) {
    return ((low ? a << 3 : a >> 1) & 0x78787878u) | 0x80808080u;
}

// K15b: one group's P/8 = sum_c (16 + q_c) b_c (16 rows, every column the
// token) over its two 16-column halves: c[e] the `ffn_c16` words (e even
// row gid, odd gid + 8; e >= 2 the second half), b[h] this lane's B words
// of half h; products exact, f32 sums. Returns this lane's row's: gid + 8
// (tig & 1)
__device__ __forceinline__ float ffn_group16(const uint32_t (&c)[4],
                                             const uint2 (&b)[2], int tig) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const uint32_t w0 = c[2 * h], w8 = c[2 * h + 1];
        const uint32_t a[4] = {__byte_perm(w0, 0x41414141u, 0x4140),
                               __byte_perm(w8, 0x41414141u, 0x4140),
                               __byte_perm(w0, 0x41414141u, 0x4342),
                               __byte_perm(w8, 0x41414141u, 0x4342)};
        mma16816(d, a, b[h].x, b[h].y);
    }
    return tig & 1 ? d[2] : d[0];
}

// T1: K15b (T = 1), else K15a; WIN: x in windows of kwin phase-1 K steps
template <bool T1, bool WIN>
__global__ void __launch_bounds__(FFN_THREADS, 2)
ffn_kernel(const uint8_t* __restrict__ gu_qs2,
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
           int T, int C, int F, int stages, int kwin) {
    extern __shared__ __align__(16) uint8_t smem[];
    cg::grid_group grid = cg::this_grid();
    // x's window: its columns (all of x without WIN)
    const int wcols = WIN ? min(C, kwin * Q4R_KS * 256) : C;
    const FfnLayout L = ffn_layout(T, wcols, stages, F);
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
    // x's bf16 group sums and x in B-fragment order, over x or a window of
    // it (columns x0 .. x0 + cols): 4 lanes per (token, group), 8 columns
    // (one 16-byte load) each, 8 loads a thread in flight; the first
    // round's loads go out before the weight stream, so that they do not
    // queue behind it
    const int xpitch = wcols + 8;  // bf16 per token row of the image
    __nv_bfloat16* xi_s = reinterpret_cast<__nv_bfloat16*>(smem + L.xi_off);
    __nv_bfloat16* xs_s = reinterpret_cast<__nv_bfloat16*>(smem + L.xs_off);
    uint4 raw[8];
    auto load_x = [&](int x0, int cols, int base) {
        const int nxt = T * (cols / 32) * 4;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int li = base + u * FFN_THREADS + tid;
            const int t = (li >> 2) / (cols / 32);
            raw[u] = li < nxt ? *reinterpret_cast<const uint4*>(
                                    x + (size_t)t * C + x0
                                    + ((li >> 2) - t * (cols / 32)) * 32
                                    + 8 * (li & 3))
                              : make_uint4(0u, 0u, 0u, 0u);
        }
    };
    load_x(0, wcols, 0);
    for (int s = 0; s < stages - 1; ++s) {
        if (s < total) issue(s, s);
        cp_async_commit();
    }
    auto prep_x = [&](int x0, int cols) {
    const int nxt = T * (cols / 32) * 4;
    for (int base = 0; base < nxt; base += 8 * FFN_THREADS) {
        if (base) load_x(x0, cols, base);
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
                // token t, column j of the window (its group j / 32); the
                // sums at the full window's pitch, as the body reads them
                const int t = (li >> 2) / (cols / 32);
                const int j = (li >> 2) * 32 - t * cols + 8 * (li & 3);
                __nv_bfloat16* d = xi_s + t * xpitch + (j & ~255)
                                   + ffn_bpos(j & 255);
                *reinterpret_cast<uint2*>(d) = make_uint2(w[0], w[1]);
                *reinterpret_cast<uint2*>(d + 16) = make_uint2(w[2], w[3]);
                if ((li & 3) == 0)
                    xs_s[t * (wcols / 32) + (j >> 5)] = f2bf(sm);
            }
        }
    }
    };
    prep_x(0, wcols);

    // K15b, after the second barrier, in each block that has down tiles:
    // a (bf16, B-fragment order) and its group sums from global memory
    // into the x image and sums (dead after phase 1), one round of 16-byte
    // loads, so that phase 3's K steps make no L2 round trip
    auto a_to_smem = [&]() {
        if (b >= nt3) return;
        const int na = F / 8, ns = F / 256;  // 16-byte pieces of a, sums
        for (int i = tid; i < na + ns; i += FFN_THREADS) {
            const uint4 v = __ldcg(reinterpret_cast<const uint4*>(
                                       i < na ? abf : dxs) + (i < na ? i : i - na));
            reinterpret_cast<uint4*>(i < na ? xi_s : xs_s)[i < na ? i : i - na] = v;
        }
    };

    // phase 2 between the barriers: a = u * g * sigmoid(g), bf16(a) (in
    // B-fragment order) and the bf16 group sums of the f32 a, one warp per
    // 32 activations (K15b then `a_to_smem`)
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
        if (T1) a_to_smem();
    };

    // this thread's C rows gid, gid + 8 and tokens 2 tig, 2 tig + 1
    // (acc[.][.][2 * rowsel + token]): four accumulators, one per plane and
    // half, so that the products' mma chains run side by side; accm: the
    // min term's, the same layout. K15b: acc[0][0][0] the sum of this
    // lane's row gid + 8 (tig & 1), accm the offset and min terms' fragment
    float acc[2][2][4] = {}, accm[4] = {0.f, 0.f, 0.f, 0.f};
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row
    const int myrow = gid + 8 * (tig & 1);                // K15b's row
    const uint4 h0[4] = {};                               // no bit plane
    bool mid = false;
    int slot = 0, wsb0 = 0;  // wsb0: the window's first superblock
    for (int it = 0; it < total; ++it) {
        if (it == total1) {
            phase2();
            mid = true;
        }
        bool p3;
        int row0, ks;
        item(it, p3, row0, ks);
        if (WIN && !p3 && it > 0 && ks % kwin == 0) {
            // the next window of x (at a new tile the first again): once
            // every warp is done with the last one, prep it as above
            wsb0 = ks * Q4R_KS;
            __syncthreads();
            const int cols = min(wcols, C - wsb0 * 256);
            load_x(wsb0 * 256, cols, 0);
            prep_x(wsb0 * 256, cols);
        }
        cp_async_wait_n(stages - 2);
        __syncthreads();
        if (it + stages - 1 < total)
            issue(it + stages - 1, slot == 0 ? stages - 1 : slot - 1);
        cp_async_commit();
        const int in_f = p3 ? F : C;
        const int sb = ks * Q4R_KS + warp;
        if (sb < in_f / 256) {
            const int sw = p3 ? sb : sb - wsb0;  // x: in its window
            const uint8_t* st = smem + slot * L.stage;
            const uint8_t* scb = st + Q4R_RT * Q4R_QS_PITCH;
            const uint8_t* arow = st + lrow * Q4R_QS_PITCH + warp * 128;
            // the group sums of this superblock: x's in shared memory (its
            // window), a's in global memory (K15b: in shared memory too)
            const __nv_bfloat16* xsb =
                T1 ? xs_s + sw * 8
                : p3 ? dxs + (size_t)gid * (F / 32) + sb * 8
                     : xs_s + gid * (wcols / 32) + sw * 8;
            if constexpr (T1) {
                // every B column is the token: a lane's B words of its
                // columns (x, or phase 3's a, both in shared memory);
                // bv[k] group k's (low plane), bv[k + 4] group k + 4's
                uint2 bv[8][2];
                const __nv_bfloat16* br = xi_s + sw * 256 + tig * 16;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const uint4 lo = *reinterpret_cast<const uint4*>(br + k * 64);
                    const uint4 hi = *reinterpret_cast<const uint4*>(br + k * 64 + 8);
                    bv[k][0] = make_uint2(lo.x, lo.y);
                    bv[k][1] = make_uint2(lo.z, lo.w);
                    bv[k + 4][0] = make_uint2(hi.x, hi.y);
                    bv[k + 4][1] = make_uint2(hi.z, hi.w);
                }
                {
                    // sum_g (16 s_g + m_g) xs_g of the superblock's 8 groups:
                    // A = [s | m] (rows gid, gid + 8), B = [16 xs | xs]
                    const uint8_t* sr = scb + warp * 16 + 4 * tig;
                    const uint8_t* mr = scb + (Q4R_KS + warp) * 16 + 4 * tig;
                    auto w32 = [](const uint8_t* q) {
                        return *reinterpret_cast<const uint32_t*>(q);
                    };
                    const uint32_t a[4] = {
                        w32(sr + gid * Q4R_SM_PITCH),
                        w32(sr + (gid + 8) * Q4R_SM_PITCH),
                        w32(mr + gid * Q4R_SM_PITCH),
                        w32(mr + (gid + 8) * Q4R_SM_PITCH)};
                    const uint32_t xs2 =
                        *reinterpret_cast<const uint32_t*>(xsb + 2 * tig);
                    mma16816(accm, a, bf16x2_mul(xs2, 0x41804180u), xs2);
                }
                const uint4 s_r = *reinterpret_cast<const uint4*>(
                    scb + myrow * Q4R_SM_PITCH + warp * 16);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    // span k's code words (q4k_codes' ldmatrix), as the
                    // bf16(16 + code) low bytes of group k (low nibbles)
                    // and group k + 4 (high ones)
                    uint32_t a[4], clo[4], chi[4];
                    ldmatrix_x4(a, arow + (((2 * k + (lane >> 4))
                                            ^ (lrow & 7)) << 4));
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        clo[e] = ffn_c16(a[e], true);
                        chi[e] = ffn_c16(a[e], false);
                    }
                    acc[0][0][0] = __fmaf_rn(bf_at(s_r, k),
                                             ffn_group16(clo, bv[k], tig),
                                             acc[0][0][0]);
                    acc[0][0][0] = __fmaf_rn(bf_at(s_r, k + 4),
                                             ffn_group16(chi, bv[k + 4], tig),
                                             acc[0][0][0]);
                }
            } else {
            // token gid's activations of this lane's columns, loaded before
            // the stage's code words are read: bv[k] group k's (low plane),
            // bv[k + 4] group k + 4's, each the span's two halves
            uint2 bv[8][2] = {};
            if (gid < T) {
                const __nv_bfloat16* br =
                    (p3 ? abf + (size_t)gid * F + sb * 256
                        : xi_s + gid * xpitch + sw * 256) + tig * 16;
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
                uint32_t xs2 = 0u;
                if (gid < T)
                    xs2 = *reinterpret_cast<const uint32_t*>(xsb + 2 * tig);
                mma1688(accm, m0, m1, xs2);
            }
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
        }
        if (ks == (p3 ? ks3 : ks1) - 1) {
            // the tile's 8 K parts meet in shared memory; one thread per
            // (row, token) adds them in warp order
            float* part = reinterpret_cast<float*>(smem + L.part_off);
            constexpr int PM = FFN_MAX_T * FFN_PART_T;  // the min half
            if constexpr (T1) {
                if (tig < 2) {
                    part[warp * Q4R_RT + myrow] = acc[0][0][0];
                    part[PM + warp * Q4R_RT + myrow] =
                        tig & 1 ? accm[2] : accm[0];
                }
                acc[0][0][0] = 0.f;
#pragma unroll
                for (int e = 0; e < 4; ++e) accm[e] = 0.f;
            } else {
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

template <bool T1, bool WIN>
static cudaError_t ffn_launch(const void* gu_qs2, const void* gu_scale,
                              const void* gu_min, const void* dn_qs2,
                              const void* dn_scale, const void* dn_min,
                              const void* x, void* gu, void* abf, void* dxs,
                              void* y, int T, int C, int F, int grid,
                              int stages, int smem, int kwin,
                              cudaStream_t st) {
    static bool ready = false;  // the opt-in above 48 KB, once per body
    cudaError_t err;
    if (!ready) {
        err = cudaFuncSetAttribute(ffn_kernel<T1, WIN>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   FFN_SMEM_MAX);
        if (err != cudaSuccess) return err;
        ready = true;
    }
    const void* kern = (const void*)ffn_kernel<T1, WIN>;
    int resident = 0;
    if ((err = blocks_per_sm(kern, smem, &resident)) != cudaSuccess)
        return err;
    if (grid > resident) return cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&gu_qs2, &gu_scale, &gu_min, &dn_qs2, &dn_scale, &dn_min,
                    &x, &gu, &abf, &dxs, &y, &T, &C, &F, &stages, &kwin};
    err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(FFN_THREADS),
                                      args, smem, st);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// K15: one FFN at 1 <= T <= 8, K15b's body (the magic-number row math)
// at T = 1 and K15a's (the 2-D math) above. grid, stages, smem and kwin
// come from `ffn_plan`; a plan whose shared memory differs from this
// source's layout is refused. Scratch: gu (T * 2F) f32, abf (T * F) bf16,
// dxs (T * F/32) bf16.
KCPP_API int k15_ffn(const void* gu_qs2, const void* gu_scale,
                     const void* gu_min, const void* dn_qs2,
                     const void* dn_scale, const void* dn_min, const void* x,
                     void* gu, void* abf, void* dxs, void* y, int T, int C,
                     int F, int grid, int stages, int smem, int kwin,
                     void* stream) {
    const int ks1 = C > 0 ? (C / 256 + Q4R_KS - 1) / Q4R_KS : 0;
    if (T < 1 || T > FFN_MAX_T || C <= 0 || F <= 0
        || C % 256 || F % 256 || grid < 1 || stages < 3 || stages > 4
        || kwin < 1 || kwin > ks1 || smem > FFN_SMEM_MAX
        || smem != ffn_layout(T, min(C, kwin * Q4R_KS * 256), stages,
                              F).total)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define FFN_ARGS gu_qs2, gu_scale, gu_min, dn_qs2, dn_scale, dn_min, x, gu, \
        abf, dxs, y, T, C, F, grid, stages, smem, kwin, st
    const bool win = kwin < ks1;
    cudaError_t err;
    if (T == 1)
        err = win ? ffn_launch<true, true>(FFN_ARGS)
                  : ffn_launch<true, false>(FFN_ARGS);
    else
        err = win ? ffn_launch<false, true>(FFN_ARGS)
                  : ffn_launch<false, false>(FFN_ARGS);
#undef FFN_ARGS
    return (int)err;
}
