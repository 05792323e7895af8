// The T=1 row matvec body of K2 (q6_k, csrc/q6k_matvec.cu), K12 (q2_k /
// q3_k, csrc/q23k_matvec.cu; the expanded layouts q6_k_i8f / q3_k_n4 /
// q2_k_n4, csrc/kq_expanded_matvec.cu), and of K17b's entries for q6_k,
// q2_k and q3_k: y (1, out_f) bf16 = x (1, in_f) . W^T, with 16-column
// groups g of scale s_g (and q2_k's min m_g):
//   q6_k: w = (q6 - 32) * s, q6 0..63 (ql nibble | 2 high bits from qh);
//   q3_k: w = (q3 - 4) * s,  q3 0..7  (2 bits from qs | 1 bit from hmask);
//   q2_k: w = q2 * s - m,    q2 0..3;
//   q6_k_i8f: w = v * s, v = q6 - 32 one int8 a weight in column order;
//   q3_k_n4 / q2_k_n4: q3_k's / q2_k's w over a nibble a code: n4 byte
//         16b + k holds column 32b + k in its low nibble and 32b + 16 + k
//         in its high one, so a 16-byte chunk of a row holds two groups'
//         codes, each in column order.
// The port's layout (ops/linear.py), GGUF's bit orders: element 256s +
// 128h + 32j + l of a row (superblock s, half h, plane j, l 0..31) is
//   q6_k: the low (j < 2) or high (j >= 2) nibble of ql byte 128s + 64h +
//         32(j & 1) + l, ORed with bits 2j..2j+1 of qh byte 64s + 32h + l
//         moved to bits 4..5;
//   q2_k / q3_k: bits 2j..2j+1 of qs byte 64s + 32h + l; q3_k ORs in bit
//         4h+j of hmask byte 32s + l as bit 2;
// and scale / min are bf16 per 16-column group in logical order. So the
// 16 bytes l = 16u..16u+15 of one plane chunk hold one group's 16 codes in
// column order: group 16s + 8h + 2j + u.
//
// The int8-activation bodies (in_f >= 512, the dispatch's default): x is
// quantized per group to codes rint(x * (127 / amax)) (amax clamped at
// 1e-20; sx = amax / 127), the group dot P_g with the codes is an exact
// int32, and with the bf16 group sums xs (the f32 sum, rounded):
//   q6_k  y = sum_g P_g sx_g s_g - 32 sum_g xs_g s_g,
//   q3_k  y = sum_g P_g sx_g s_g -  4 sum_g xs_g s_g   (q3_k_n4 alike),
//   q2_k  y = sum_g P_g sx_g s_g -    sum_g xs_g m_g   (q2_k_n4 alike),
//   q6_k_i8f y = sum_g P_g sx_g s_g (P of the signed values).
// The expanded kinds are int8 only (JAX `_q6k_i8f_row_kernel`,
// `_q3k_n4_row_kernel`, `_q2k_n4_row_kernel`).
// The bf16-activation bodies (in_f < 512, and every width under
// KCPP_MM_I8=0): P_g is the f32 dot of bf16 x with the code plus the JAX
// kernels' offset (q6 + 0, q2 + 4, q3 + 8; exact in bf16), so the
// constants land on the group-sum term as there:
//   q6_k  y = sum_g s_g P_g - 32 sum_g xs_g s_g,
//   q3_k  y = sum_g s_g P_g - 12 sum_g xs_g s_g,
//   q2_k  y = sum_g s_g P_g -  4 sum_g xs_g s_g - sum_g xs_g m_g.
//
// Bound on the H100: bytes, each read once: q6_k 0.75 B/weight of ql + qh
// and 2 B of bf16 scale per 16 (0.875 B/weight: the 1.1B's head, 57.3 MB,
// takes 17.1 us at 3.35 TB/s), q3_k 0.5, q2_k 0.5; q6_k_i8f 1.125, q3_k_n4
// 0.625, q2_k_n4 0.75. The first design (a
// warp per row, a separate activation-prep launch, scalar global loads of
// every scale, sx and xs, bf16 x read one element at a time) ran 2-19x
// its bound. This one, K1's design adapted to 16-column groups:
//   * preps its own activations, in the same launch: every block of a
//     persistent grid (`rowmv_plan`: about two blocks per SM) holds x in
//     shared memory, int8 codes with sx and xs, or bf16 x with xs, laid out
//     so that one 16-byte load gives a lane its mma B fragments of four
//     (int8) or two (bf16) groups. The first x loads go out before the
//     weight stream. The wrapper allocates only y;
//   * streams 16-row tiles of 8 superblocks of every field (q6_k 29.4 KB,
//     q2_k / q3_k 17 KB a stage) through a cp.async ring of `stages` (3-4,
//     the most that let two blocks share an SM where they can), across
//     tile boundaries; every field's row pitch is 16 bytes past a multiple
//     of 128, so that the ldmatrix reads of 8 rows hit 8 bank groups;
//   * takes the group dots on the tensor cores, exact per group: one
//     ldmatrix.x4 gives a lane the 4-byte code words of 2 chunks x 16 rows,
//     which make the A fragments of up to 8 groups by shifts and masks.
//     int8: mma.sync m16n8k16 s8 x s8 -> s32, A = 16 rows x 16 codes, B =
//     the group's 16 x codes in every column (token 0), C = the exact P.
//     bf16: mma.sync m16n8k16 bf16 -> f32, A = the codes plus the offset
//     as bf16 (0x4300 | code is 128 + code; one bf16x2 fma takes 128 -
//     offset off, exactly), B = x; the k order inside a group is permuted
//     alike in A and B (lane t's k 2t, 2t+1 and 8+2t, 9+2t are columns 4t
//     .. 4t+3), so that one 4-byte code word makes a lane's fragment;
//     The expanded kinds' A fragments need no decode: q6_k_i8f's int8
//     values are A as ldmatrix gives them, an n4 word masked (low nibbles)
//     or shifted and masked (high ones) is A of one of its two groups;
//   * takes the group-sum terms on bf16 mma.sync m16n8k16 once per
//     superblock: A = the 16 groups' s (or m) of 16 rows, B = xs, products
//     exact, f32 sums; scaled by the constant at the end;
//   * where x does not fit a block next to the ring (in_f beyond ~67K-130K
//     by kind and body), holds x in windows of `kwin` K steps
//     (`rowmv_plan`): at a window's first K step of every tile the block
//     preps that window anew (a template flag: the body for x whole has no
//     window code). A group's codes, sx and xs are the same values in a
//     window and whole, and the partial sums stay in registers across
//     windows, so the result is the same bits.
// Warp w of a block takes superblock w of each stage (8 superblocks), so
// the 8 warps split K; every lane combines one row (lanes 4r, 4r+1 rows r,
// r+8; every B column holds token 0, so each C fragment holds useful P);
// a tile's partial sums meet in shared memory and are added in warp order.
// Every product and sum is an explicit __fmaf_rn / __fmul_rn / __fadd_rn /
// __fsub_rn or an mma, in an order fixed by (in_f, superblock, group):
// K17b (the same body with the weight pointers moved to layer li,
// Stacked, common.cuh) gives K2's / K12's result on that layer bit for
// bit.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

// the dense kinds, then the expanded layouts (ROWMV_KINDS, ROWMV_X_KINDS)
enum RowKind { RK_Q6 = 0, RK_Q2 = 1, RK_Q3 = 2, RK_X6 = 3, RK_X3 = 4,
               RK_X2 = 5 };

constexpr int RM_THREADS = 256;  // 8 warps
constexpr int RM_KS = 8;         // superblocks per stage: one per warp
constexpr int RM_RT = 16;        // rows per tile: one mma M
constexpr int RM_XR = 4;         // x loads in flight per thread in the prep
constexpr int RM_SMEM_MAX = 232448;

// bytes per superblock row of the codes (ql / qs), the second code field
// (qh / hmask; 0: none), the scales and the mins (q2_k)
__host__ __device__ constexpr int rm_b0(int kind) {
    return kind == RK_X6 ? 256 : kind == RK_Q6 || kind >= RK_X3 ? 128 : 64;
}
__host__ __device__ constexpr int rm_b1(int kind) {
    return kind == RK_Q6 ? 64 : kind == RK_Q3 ? 32 : 0;
}
__host__ __device__ constexpr int rm_bm(int kind) {
    return kind == RK_Q2 || kind == RK_X2 ? 32 : 0;
}
// the window's columns: kwin K steps of 8 superblocks, at most in_f
__host__ __device__ inline int rm_wcols(int in_f, int kwin) {
    return in_f < kwin * RM_KS * 256 ? in_f : kwin * RM_KS * 256;
}

// Byte offsets of the dynamic shared memory, as `rowmv_layout` computes them
// (ops/quant_matmul.py): the ring (per stage, each field's 16 rows of 8
// superblocks at a pitch of 8 superblocks + 16 bytes: codes, second code
// field, scales, mins), the x image of in_f columns (x's, or its window's;
// int8 codes: per 128 columns, lane t's 4 codes of each of the 8 groups in
// 32 bytes; bf16 x: the same in 64),
// the scales sx (f32, int8 only) and sums xs (bf16) per group, and the
// tile's partial sums ([3][8 warps][16 rows] f32).
struct RmLayout {
    int p0, p1, ps, pm, o1, os, om, stage, x_off, sx_off, xs_off, part_off,
        total;
};

__host__ __device__ inline RmLayout rm_layout(int kind, bool i8, int in_f,
                                              int stages) {
    RmLayout L;
    const int b1 = rm_b1(kind), bm = rm_bm(kind);
    L.p0 = RM_KS * rm_b0(kind) + 16;
    L.p1 = b1 ? RM_KS * b1 + 16 : 0;
    L.ps = RM_KS * 32 + 16;
    L.pm = bm ? RM_KS * bm + 16 : 0;
    L.o1 = RM_RT * L.p0;
    L.os = L.o1 + RM_RT * L.p1;
    L.om = L.os + RM_RT * L.ps;
    L.stage = L.om + RM_RT * L.pm;
    L.x_off = stages * L.stage;
    L.sx_off = L.x_off + (i8 ? in_f : 2 * in_f);
    L.xs_off = L.sx_off + (i8 ? (in_f / 16) * 4 : 0);
    L.part_off = L.xs_off + (in_f / 16) * 2;
    L.total = L.part_off + 3 * RM_KS * RM_RT * 4;
    return L;
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// 16 rows x 8 superblocks of one field (b bytes per superblock row, row
// stride row_bytes in global memory) into its stage region, 16-byte
// cp.async chunks; superblocks past nsb skipped
template <int B>
__device__ __forceinline__ void rm_copy(uint8_t* dst, int pitch,
                                        const uint8_t* src, size_t row_bytes,
                                        int row0, int sb0, int nsb, int tid) {
    constexpr int CPR = RM_KS * B / 16;  // chunks per row
#pragma unroll
    for (int c = tid; c < RM_RT * CPR; c += RM_THREADS) {
        const int r = c / CPR, k = c % CPR;
        if (sb0 + k / (B / 16) < nsb)
            cp_async16(dst + r * pitch + k * 16,
                       src + (size_t)(row0 + r) * row_bytes
                           + (size_t)sb0 * B + k * 16);
    }
}

template <int KIND, bool I8, bool WIN>
__global__ void __launch_bounds__(RM_THREADS, 2)
rowmv_kernel(const uint8_t* __restrict__ f0,          // ql / qs / q / n4
             const uint8_t* __restrict__ f1,          // qh / hmask / null
             const __nv_bfloat16* __restrict__ scale,
             const __nv_bfloat16* __restrict__ mn,    // q2_k(_n4) min / null
             const __nv_bfloat16* __restrict__ x,     // (in_f)
             __nv_bfloat16* __restrict__ y,           // (out_f)
             int out_f, int in_f, int stages, Stacked stk, int kwin) {
    extern __shared__ __align__(16) uint8_t smem[];
    constexpr bool XK = KIND >= RK_X6;  // an expanded layout (int8 x)
    static_assert(I8 || !XK, "the expanded kinds take int8 x");
    constexpr int B0 = rm_b0(KIND), B1 = rm_b1(KIND), BM = rm_bm(KIND);
    // the constant of the sum_g xs_g s_g term (0: no such term)
    constexpr float CX = KIND == RK_Q6 ? 32.f
                         : KIND == RK_Q3 || KIND == RK_X3 ? (I8 ? 4.f : 12.f)
                         : KIND == RK_Q2 ? (I8 ? 0.f : 4.f) : 0.f;
    // the bf16 bodies' offset: A holds bf16(code + OFF)
    constexpr float OFF = KIND == RK_Q6 ? 0.f : KIND == RK_Q3 ? 8.f : 4.f;
    f0 = stk.at(f0, 0);
    f1 = stk.at(f1, 1);
    scale = stk.at(scale, 2);
    mn = stk.at(mn, 3);
    const int wcols = WIN ? rm_wcols(in_f, kwin) : in_f;  // x's window
    const RmLayout L = rm_layout(KIND, I8, wcols, stages);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int nsb = in_f / 256, ng = in_f / 16;
    const int ksteps = (nsb + RM_KS - 1) / RM_KS;
    const int ntiles = out_f / RM_RT;
    const int mine = (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
    const int total = mine * ksteps;  // (tile, K step) pairs of this block
    const size_t r0 = (size_t)nsb * B0, r1 = (size_t)nsb * B1,
                 rs = (size_t)ng * 2;

    // activation prep, part 1: two lanes per group, 8 columns (one 16-byte
    // load) each, over x or a window of it (xw: its first column, ntask:
    // its columns / 8); the first RM_XR rounds go out before the weight
    // stream
    uint4 raw[RM_XR];
    auto load_x = [&](const __nv_bfloat16* xw, int ntask, int base) {
#pragma unroll
        for (int u = 0; u < RM_XR; ++u) {
            const int li = base + u * RM_THREADS + tid;
            raw[u] = li < ntask ? *reinterpret_cast<const uint4*>(xw + li * 8)
                                : make_uint4(0u, 0u, 0u, 0u);
        }
    };
    load_x(x, wcols / 8, 0);

    // one stage: rows [tile*16, +16) x superblocks [kstep*8, +8) of every
    // field
    auto issue = [&](int it, int slot) {
        const int row0 = (blockIdx.x + (it / ksteps) * gridDim.x) * RM_RT;
        const int sb0 = (it % ksteps) * RM_KS;
        uint8_t* st = smem + slot * L.stage;
        rm_copy<B0>(st, L.p0, f0, r0, row0, sb0, nsb, tid);
        if constexpr (B1 != 0)
            rm_copy<B1>(st + L.o1, L.p1, f1, r1, row0, sb0, nsb, tid);
        rm_copy<32>(st + L.os, L.ps,
                    reinterpret_cast<const uint8_t*>(scale), rs, row0, sb0,
                    nsb, tid);
        if constexpr (BM != 0)
            rm_copy<32>(st + L.om, L.pm,
                        reinterpret_cast<const uint8_t*>(mn), rs, row0, sb0,
                        nsb, tid);
    };
    for (int s = 0; s < stages - 1; ++s) {
        if (s < total) issue(s, s);
        cp_async_commit();
    }

    // activation prep, part 2, while the first stages arrive. Task li takes
    // columns 8li..8li+7: half v = li & 1 of group g = li >> 1, i.e. lanes
    // tig 2v and 2v+1's 4 columns each. x image: per 128 columns (hb = g >>
    // 3), lane t's words of the 8 groups gl = g & 7 side by side.
    uint8_t* xi = smem + L.x_off;
    float* sxs = reinterpret_cast<float*>(smem + L.sx_off);
    __nv_bfloat16* xss = reinterpret_cast<__nv_bfloat16*>(smem + L.xs_off);
    auto prep_x = [&](const __nv_bfloat16* xw, int ntask) {
    for (int base = 0; base < ntask; base += RM_XR * RM_THREADS) {
        if (base) load_x(xw, ntask, base);
#pragma unroll
        for (int u = 0; u < RM_XR; ++u) {
            if (base + u * RM_THREADS >= ntask) break;  // the same for all
            const int li = base + u * RM_THREADS + tid;
            // ntask is a multiple of 32: whole warps skip, shuffles intact
            if (li >= ntask) continue;
            const int g = li >> 1, v = li & 1, hb = g >> 3, gl = g & 7;
            const uint32_t w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
            float e8[8];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                e8[2 * e] = __uint_as_float(w[e] << 16);
                e8[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
            }
            float sm = e8[0], a = fabsf(e8[0]);
#pragma unroll
            for (int e = 1; e < 8; ++e) {
                sm = __fadd_rn(sm, e8[e]);
                a = fmaxf(a, fabsf(e8[e]));
            }
            sm = __fadd_rn(sm, __shfl_xor_sync(0xffffffffu, sm, 1));
            a = fmaxf(fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1)), 1e-20f);
            if (I8) {
                const float inv = 127.0f / a;
                int c[8];  // rint(x * (127 / amax)), |c| <= 127
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    c[e] = __float2int_rn(__fmul_rn(e8[e], inv));
                uint8_t* dst = xi + hb * 128 + 2 * v * 32 + gl * 4;
                *reinterpret_cast<uint32_t*>(dst) =
                    __byte_perm(__byte_perm(c[0], c[1], 0x0040),
                                __byte_perm(c[2], c[3], 0x0040), 0x5410);
                *reinterpret_cast<uint32_t*>(dst + 32) =
                    __byte_perm(__byte_perm(c[4], c[5], 0x0040),
                                __byte_perm(c[6], c[7], 0x0040), 0x5410);
                if (v == 0) sxs[g] = a / 127.0f;
            } else {
                uint8_t* dst = xi + hb * 256 + 2 * v * 64 + gl * 8;
                *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
                *reinterpret_cast<uint2*>(dst + 64) = make_uint2(w[2], w[3]);
            }
            if (v == 0) xss[g] = f2bf(sm);
        }
    }
    };
    prep_x(x, wcols / 8);

    // lane (gid, tig) combines row myrow of the tile; its ldmatrix row and
    // chunk pick (lanes 8m..8m+7 address matrix m: rows 0-7 / 8-15 of the
    // first chunk, then of the second)
    const int myrow = gid + 8 * (tig & 1);
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int lsel = lane >> 4;
    // bf16x2 (-(128 - OFF)): 0x4300 | code is bf16(128 + code)
    const uint32_t unbias = pack_bf16(OFF - 128.f, OFF - 128.f);
    float acc = 0.f;
    float accx[4] = {0.f, 0.f, 0.f, 0.f}, accm[4] = {0.f, 0.f, 0.f, 0.f};
    int slot = 0, wsb0 = 0;  // wsb0: the window's first superblock
    for (int it = 0; it < total; ++it) {
        const int ks = it % ksteps;
        if (WIN && it > 0 && ks % kwin == 0) {
            // the next window (at a new tile the first again): once every
            // warp is done with the last one, prep it as above
            wsb0 = ks * RM_KS;
            __syncthreads();
            const int nt = min(wcols, in_f - wsb0 * 256) / 8;
            load_x(x + wsb0 * 256, nt, 0);
            prep_x(x + wsb0 * 256, nt);
        }
        cp_async_wait_n(stages - 2);
        __syncthreads();
        if (it + stages - 1 < total)
            issue(it + stages - 1, slot == 0 ? stages - 1 : slot - 1);
        cp_async_commit();
        const int sb = ks * RM_KS + warp;
        const int sw = sb - wsb0;  // in x's window
        if (sb < nsb) {
            const uint8_t* st = smem + slot * L.stage;
            const uint8_t* scb = st + L.os + warp * 32;  // this superblock
            {
                // sum_g xs_g s_g (and m) of the 16 groups on the tensor
                // cores: A = 16 rows x 16 groups of s, B = xs in every
                // column; products exact, f32 sums
                const uint32_t* xw =
                    reinterpret_cast<const uint32_t*>(xss + sw * 16);
                const uint32_t b0 = xw[tig], b1 = xw[4 + tig];
                if (CX != 0.f) {
                    const uint8_t* sr = scb + 4 * tig;
                    const uint32_t a[4] = {
                        lds32(sr + gid * L.ps), lds32(sr + (gid + 8) * L.ps),
                        lds32(sr + gid * L.ps + 16),
                        lds32(sr + (gid + 8) * L.ps + 16)};
                    mma16816(accx, a, b0, b1);
                }
                if (BM) {
                    const uint8_t* mr = st + L.om + warp * 32 + 4 * tig;
                    const uint32_t a[4] = {
                        lds32(mr + gid * L.pm), lds32(mr + (gid + 8) * L.pm),
                        lds32(mr + gid * L.pm + 16),
                        lds32(mr + (gid + 8) * L.pm + 16)};
                    mma16816(accm, a, b0, b1);
                }
            }
            const uint8_t* arow = st + lrow * L.p0 + warp * B0;
            if constexpr (XK) {
                // the expanded layouts: per half h, groups 8h..8h+7 of the
                // superblock. ldmatrix.x4 of chunks c, c + 1 gives q[2u + r]
                // = chunk c + u of row gid + 8r; q6_k_i8f's chunk c is group
                // c (its int8 values: A as they are), an n4 chunk c holds
                // group 2c (low nibbles) and 2c + 1 (high ones)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    uint32_t cw[8][2];  // [group 8h + gl][row gid + 8r]
#pragma unroll
                    for (int i = 0; i < (KIND == RK_X6 ? 4 : 2); ++i) {
                        uint32_t q[4];
                        ldmatrix_x4(q, arow + (((KIND == RK_X6 ? 8 : 4) * h
                                                + 2 * i + lsel) << 4));
#pragma unroll
                        for (int u = 0; u < 2; ++u)
#pragma unroll
                            for (int r = 0; r < 2; ++r) {
                                if (KIND == RK_X6) {
                                    cw[2 * i + u][r] = q[2 * u + r];
                                } else {
                                    cw[4 * i + 2 * u][r] = q[2 * u + r] & 0x0F0F0F0Fu;
                                    cw[4 * i + 2 * u + 1][r] =
                                        (q[2 * u + r] >> 4) & 0x0F0F0F0Fu;
                                }
                            }
                    }
                    // this lane's row's 8 scales, the 8 groups' sx and the
                    // lane's B words of half 2 sb + h
                    const uint4 sv = *reinterpret_cast<const uint4*>(
                        st + L.os + myrow * L.ps + warp * 32 + h * 16);
                    const float4 sxa = *reinterpret_cast<const float4*>(
                        sxs + sw * 16 + 8 * h);
                    const float4 sxb = *reinterpret_cast<const float4*>(
                        sxs + sw * 16 + 8 * h + 4);
                    const float sxv[8] = {sxa.x, sxa.y, sxa.z, sxa.w,
                                          sxb.x, sxb.y, sxb.z, sxb.w};
                    const uint8_t* xb = xi + (2 * sw + h) * 128 + tig * 32;
                    const uint4 xv[2] = {*reinterpret_cast<const uint4*>(xb),
                                         *reinterpret_cast<const uint4*>(xb + 16)};
#pragma unroll
                    for (int gl = 0; gl < 8; ++gl) {
                        int d[4];
                        mma16816_s8(d, cw[gl][0], cw[gl][1],
                                    u4_at(xv[gl >> 2], gl & 3));
                        const float p = (float)(tig & 1 ? d[2] : d[0]);
                        acc = __fmaf_rn(__fmul_rn(p, sxv[gl]), bf_at(sv, gl),
                                        acc);
                    }
                }
            } else {
            uint32_t hm[4];  // q3_k: hmask chunks u = 0, 1 (rows gid, gid+8)
            if (KIND == RK_Q3)
                ldmatrix_x4(hm, st + L.o1 + lrow * L.p1 + warp * 32
                                    + (lsel << 4));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                // code words: cw[u][r] (r 0: row gid, 1: row gid+8) of the
                // chunk u of each plane source
                uint32_t q[2][4], hq[4];
                if (KIND == RK_Q6) {
                    // ql chunks 4h+u (byte group 0) and 4h+2+u (group 1)
                    ldmatrix_x4(q[0], arow + ((4 * h + 2 * lsel) << 4));
                    ldmatrix_x4(q[1], arow + ((4 * h + 1 + 2 * lsel) << 4));
                    // qh chunks 2h, 2h+1
                    ldmatrix_x4(hq, st + L.o1 + lrow * L.p1 + warp * 64
                                        + ((2 * h + lsel) << 4));
                } else {
                    // qs chunks 2h, 2h+1
                    ldmatrix_x4(q[0], arow + ((2 * h + lsel) << 4));
                }
                // this lane's row's 8 scales and the 8 groups' sx of half h
                const uint4 sv = *reinterpret_cast<const uint4*>(
                    st + L.os + myrow * L.ps + warp * 32 + h * 16);
                float4 sxa = make_float4(0.f, 0.f, 0.f, 0.f), sxb = sxa;
                if (I8) {
                    sxa = *reinterpret_cast<const float4*>(sxs + sw * 16 + 8 * h);
                    sxb = *reinterpret_cast<const float4*>(sxs + sw * 16 + 8 * h + 4);
                }
                const float sxv[8] = {sxa.x, sxa.y, sxa.z, sxa.w,
                                      sxb.x, sxb.y, sxb.z, sxb.w};
                // this lane's B words of the 8 groups of half 2 sb + h
                uint4 xv[4];
                const uint8_t* xb = xi + (2 * sw + h) * (I8 ? 128 : 256)
                                    + tig * (I8 ? 32 : 64);
#pragma unroll
                for (int i = 0; i < (I8 ? 2 : 4); ++i)
                    xv[i] = *reinterpret_cast<const uint4*>(xb + 16 * i);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        const int gl = 2 * j + u;  // group 16 sb + 8 h + gl
                        uint32_t cw[2];
#pragma unroll
                        for (int r = 0; r < 2; ++r) {
                            if (KIND == RK_Q6) {
                                // q[k]: ldmatrix k gave chunk 4h+k (rows
                                // gid, gid+8) then 4h+2+k
                                const uint32_t lo = q[u][(j & 1) * 2 + r];
                                const uint32_t nib = j >= 2 ? (lo >> 4) & 0x0F0F0F0Fu
                                                            : lo & 0x0F0F0F0Fu;
                                cw[r] = nib | (((hq[2 * u + r] >> (2 * j))
                                                & 0x03030303u) << 4);
                            } else {
                                cw[r] = (q[0][2 * u + r] >> (2 * j)) & 0x03030303u;
                                if (KIND == RK_Q3)
                                    cw[r] |= ((hm[2 * u + r] >> (4 * h + j))
                                              & 0x01010101u) << 2;
                            }
                        }
                        float p;
                        if (I8) {
                            int d[4];
                            mma16816_s8(d, cw[0], cw[1],
                                        u4_at(xv[gl >> 2], gl & 3));
                            p = (float)(tig & 1 ? d[2] : d[0]);
                            acc = __fmaf_rn(__fmul_rn(p, sxv[gl]),
                                            bf_at(sv, gl), acc);
                        } else {
                            const uint32_t one = 0x3F803F80u;  // bf16x2 1.0
                            const uint32_t a[4] = {
                                bf16x2_fma(__byte_perm(cw[0], 0x43434343u, 0x4140), one, unbias),
                                bf16x2_fma(__byte_perm(cw[1], 0x43434343u, 0x4140), one, unbias),
                                bf16x2_fma(__byte_perm(cw[0], 0x43434343u, 0x4342), one, unbias),
                                bf16x2_fma(__byte_perm(cw[1], 0x43434343u, 0x4342), one, unbias)};
                            float d[4] = {0.f, 0.f, 0.f, 0.f};
                            mma16816(d, a, u4_at(xv[gl >> 1], 2 * (gl & 1)),
                                     u4_at(xv[gl >> 1], 2 * (gl & 1) + 1));
                            p = tig & 1 ? d[2] : d[0];
                            acc = __fmaf_rn(bf_at(sv, gl), p, acc);
                        }
                    }
                }
            }
            }
        }
        if (ks == ksteps - 1) {
            // the tile's 8 K parts meet in shared memory; one thread per row
            // adds them in warp order
            float* part = reinterpret_cast<float*>(smem + L.part_off);
            constexpr int PW = RM_KS * RM_RT;
            if (tig < 2) {
                part[warp * RM_RT + myrow] = acc;
                part[PW + warp * RM_RT + myrow] = tig & 1 ? accx[2] : accx[0];
                part[2 * PW + warp * RM_RT + myrow] = tig & 1 ? accm[2] : accm[0];
            }
            acc = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) accx[e] = accm[e] = 0.f;
            __syncthreads();
            if (tid < RM_RT) {
                float sa = part[tid], sx = part[PW + tid], sm = part[2 * PW + tid];
#pragma unroll
                for (int w = 1; w < RM_KS; ++w) {
                    sa = __fadd_rn(sa, part[w * RM_RT + tid]);
                    sx = __fadd_rn(sx, part[PW + w * RM_RT + tid]);
                    sm = __fadd_rn(sm, part[2 * PW + w * RM_RT + tid]);
                }
                float t = sa;
                if (CX != 0.f) t = __fsub_rn(t, __fmul_rn(CX, sx));
                if (BM) t = __fsub_rn(t, sm);
                const int row0 = (blockIdx.x + (it / ksteps) * gridDim.x) * RM_RT;
                y[row0 + tid] = f2bf(t);
            }
        }
        slot = slot + 1 == stages ? 0 : slot + 1;
    }
    cp_async_wait<0>();
}

template <int KIND, bool I8, bool WIN>
static cudaError_t rowmv_launch1(const void* f0, const void* f1,
                                 const void* scale, const void* mn,
                                 const void* x, void* y, int out_f, int in_f,
                                 int grid, int stages, int smem, Stacked stk,
                                 int kwin, cudaStream_t st) {
    static bool ready = false;  // the opt-in above 48 KB, once per body
    if (!ready) {
        cudaError_t e = cudaFuncSetAttribute(
            rowmv_kernel<KIND, I8, WIN>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, RM_SMEM_MAX);
        if (e != cudaSuccess) return e;
        ready = true;
    }
    rowmv_kernel<KIND, I8, WIN><<<grid, RM_THREADS, smem, st>>>(
        (const uint8_t*)f0, (const uint8_t*)f1, (const __nv_bfloat16*)scale,
        (const __nv_bfloat16*)mn, (const __nv_bfloat16*)x,
        (__nv_bfloat16*)y, out_f, in_f, stages, stk, kwin);
    return cudaGetLastError();
}

// the body for x whole, or (kwin below the K steps) in windows
template <int KIND, bool I8>
static cudaError_t rowmv_launch(const void* f0, const void* f1,
                                const void* scale, const void* mn,
                                const void* x, void* y, int out_f, int in_f,
                                int grid, int stages, int smem, Stacked stk,
                                int kwin, cudaStream_t st) {
    const int ksteps = (in_f / 256 + RM_KS - 1) / RM_KS;
    if (kwin < ksteps)
        return rowmv_launch1<KIND, I8, true>(f0, f1, scale, mn, x, y, out_f,
                                             in_f, grid, stages, smem, stk,
                                             kwin, st);
    return rowmv_launch1<KIND, I8, false>(f0, f1, scale, mn, x, y, out_f,
                                          in_f, grid, stages, smem, stk,
                                          kwin, st);
}

// the launch arguments `rowmv_plan` gives, checked against this source's
// layout: a plan that differs is refused
inline bool rm_plan_ok(int kind, bool i8, int out_f, int in_f, int grid,
                       int stages, int smem, int kwin) {
    const int ksteps = (in_f / 256 + RM_KS - 1) / RM_KS;
    return in_f > 0 && in_f % 256 == 0 && out_f > 0 && out_f % RM_RT == 0
           && grid >= 1 && grid <= out_f / RM_RT && stages >= 3
           && stages <= 4 && smem <= RM_SMEM_MAX && kwin >= 1
           && kwin <= ksteps
           && smem == rm_layout(kind, i8, rm_wcols(in_f, kwin), stages).total;
}
