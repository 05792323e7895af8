// The T=1 row matvec body of K2.q8_0 (csrc/q8_0_matvec.cu) and K12.iq
// (csrc/iq_matvec.cu), and of K17b's entries for these kinds:
// y (1, out_f) bf16 = x (1, in_f) . W^T with scale groups g of G columns:
//   q8_0 (G = 32): w = q * s, q int8;
//   iq2p / iq3px / iq3ps: w = v * s, v the kind's alphabet value of the code
//         (iq2p 8 + 17c + (c >> 1); iq3px 4 + 8k, 62 at k = 7; iq3ps 2k + 1),
//         negated where its sign bit is set;
//   iq1p: w = (c - 1) * s - m.
// The IQ layout of the port (ops/linear.py) is rowmv.cuh's: qs holds the
// 2-bit codes in q2_k's stream order (element 256s + 128h + 32j + l in bits
// 2j..2j+1 of byte 64s + 32h + l), hmask (iq3px, iq3ps: the code's third
// bit) and sg (iq2p, iq3px, iq3ps: the sign) in q3_k's hmask order (bit
// 4h + j of byte 32s + l), scale (and iq1p's min) bf16 per group in logical
// order. So the 16 bytes l = 16u..16u+15 of one plane chunk hold 16
// consecutive columns 256s + 128h + 32j + 16u + i: one 16-column group, half
// a 32-column one or two 8-column ones. q8_0's codes are int8 in column
// order, its scale bf16 per 32 columns.
//
// Int8 bodies (every IQ kind; q8_0 by default): x is quantized per group to
// codes rint(x * (127 / amax)) (amax clamped at 1e-20; sx = amax / 127), the
// group dot P_g of the signed values with the codes is an exact int32, and
//   y = sum_g P_g sx_g s_g  (iq1p: - sum_g xs_g m_g, xs the bf16 group sums;
//   P_g = sum c x - sum x: the mma takes the raw code c, the prep the sum).
// q8_0's bf16 body (KCPP_MM_I8=0): P_g = the f32 sum of the products x_c q_c
// (each exact in f32: 8 + 8 significant bits), added in column order from
// 0; y = sum_g P_g s_g.
// q8_0's sums run in one fixed order, which `q8_0_matvec_plain` repeats, so
// the two agree bit for bit: per row and group i of the 4 in every
// 128-column span (groups 4sp + i), warp w sums its spans sp = 8k + w in
// K-step order from 0: acc_i += (P sx) s (int8) or acc_i += P s (bf16);
// each warp then adds (acc_0 + acc_1) + (acc_2 + acc_3), and the 8 warps'
// sums meet in warp order. Every product and add is an explicit
// __fmul_rn / __fadd_rn, or an FMA whose product is exact.
//
// Bound on the H100: bytes, each read once: q8_0 1.0625 B/weight (the
// 1.1B's head, 69.6 MB, takes 20.8 us at 3.35 TB/s); iq2p 0.375 + 2/G,
// iq3px / iq3ps 0.5 + 2/G, iq1p 0.25 + 4/G. The first design (a warp per
// row, a separate prep launch, scalar global loads of every scale and sx,
// __dp4a dots) ran 2.0-4.6x its bound. This one is rowmv.cuh's:
//   * one launch that preps its own x: every block of a persistent grid
//     (`rowmv_plan`) holds x in shared memory as int8 codes in B-fragment
//     order (rowmv.cuh's image: per 128 columns, lane t's 4-code words of
//     the 8 16-column chunks side by side) with sx (and iq1p's xs and code
//     sums) per G columns, or (q8_0's bf16 body) x as bf16 or f32, each
//     32-column group at a pitch 16 bytes past its size.
//     The first x loads go out before the weight stream; the wrapper
//     allocates only y;
//   * streams 16-row tiles through a cp.async ring of `stages` (2-4, the
//     most that keep two blocks an SM where they can), across tile
//     boundaries: a warp's span is a superblock (256 columns) of qs,
//     hmask, sg, scale and min for the IQ kinds, 128 columns of codes and
//     scales for q8_0 (17.5 KB a stage; a 256-column span would take 35 KB);
//     every code field's row pitch is 16 bytes past a multiple of 128, so
//     ldmatrix reads of 8 rows hit 8 bank groups;
//   * takes the group dots on the tensor cores, exact: q8_0's A fragments
//     come straight from ldmatrix.x4 (16 rows x 32 codes: mma.sync
//     m16n8k32 s8); the IQ kinds' are made in registers from the code
//     words, four values a word, |v| <= 62 (`iq_values4`: byte-permute
//     lookups of the value and its negation, the sign plane selecting):
//     G = 32 one m16n8k32, G = 16 one m16n8k16 per chunk, G = 8 one
//     m16n8k16 per chunk whose even B columns hold the first 8 x codes and
//     odd ones the last 8 (zeros elsewhere), so C's two columns give both
//     groups' dots; lanes tig and tig ^ 2 hold the same row's dots and
//     combine every other group each, adding at the tile's end; iq1p's min
//     term goes on bf16 mma.sync once per superblock, as q2_k's in
//     rowmv.cuh. The decode runs on the integer pipe (half the FP32
//     rate) and is the IQ bodies' largest cost: it bounds their heads
//     (PERF.md);
//   * q8_0's bf16 body takes its dots on the CUDA cores from shared
//     memory (a tensor-core f32 sum does not promise the plain version's
//     order): lane (gid, tig) of a warp takes group tig of rows gid and
//     gid + 8 of the span, so each x it reads serves two rows, a code to
//     f32 by one byte permute and one exact subtraction; x is kept as f32
//     (XF) wherever that costs no block an SM and no ring stage
//     (`rowmv_plan`), which saves the bf16 -> f32 shift of every x;
//   * where x does not fit a block next to the ring (in_f beyond ~78K-
//     174K by kind and body), holds x in windows of `kwin` K steps
//     (`rowmv_plan`), rowmv.cuh's way: each window prepped anew at its
//     first K step of every tile, the same values as x whole (a template
//     flag: the body for x whole has no window code).
// Every sum runs in an order fixed by (in_f, span, group): K17b (the same
// body with the weight pointers moved to layer li, Stacked, common.cuh)
// gives K2.q8_0's / K12.iq's result on that layer bit for bit.
#pragma once

#include "common.cuh"
#include "rowmv.cuh"

// q8_0, then the IQ kinds in IQ_KINDS order (ops/linear.py)
enum GrpKind { GK_Q8 = 0, GK_IQ2 = 1, GK_IQ3X = 2, GK_IQ3S = 3, GK_IQ1 = 4 };

// columns of a warp's span; bytes per span row of the codes, hmask, sg,
// scale and min (0: no such field)
__host__ __device__ constexpr int rg_span(int kind) {
    return kind == GK_Q8 ? 128 : 256;
}
__host__ __device__ constexpr int rg_b0(int kind) {
    return kind == GK_Q8 ? 128 : 64;
}
__host__ __device__ constexpr int rg_bh(int kind) {
    return kind == GK_IQ3X || kind == GK_IQ3S ? 32 : 0;
}
__host__ __device__ constexpr int rg_bg(int kind) {
    return kind == GK_Q8 || kind == GK_IQ1 ? 0 : 32;
}
__host__ __device__ constexpr int rg_bs(int kind, int g) {
    return rg_span(kind) / g * 2;
}
__host__ __device__ constexpr int rg_bm(int kind, int g) {
    return kind == GK_IQ1 ? 512 / g : 0;
}

// Byte offsets of the dynamic shared memory, as `rowmv_layout` computes them
// (ops/quant_matmul.py): the ring (per stage, each field's 16 rows of 8
// spans at a pitch of 8 spans + 16 bytes: codes, hmask, sg, scales, mins),
// the x image of in_f columns (x's, or its window's; int8 codes, in_f bytes; bf16 x or bf16 x as f32, rg_xpitch
// bytes per 32 columns), sx (f32 per
// group, int8 only), iq1p's xs (bf16) and code sums (int32) per group, and
// the tile's partial sums ([2][8 warps][16 rows] f32).
// bytes of one 32-column group of the bf16 body's x image (bf16, or XF: f32),
// 16 past its size: the 4 groups a lane quad reads hit 4 bank groups
__host__ __device__ constexpr int rg_xpitch(bool xf) {
    return 32 * (xf ? 4 : 2) + 16;
}

__device__ __forceinline__ float lds_bf(const uint8_t* p) {
    return __uint_as_float(
        (uint32_t)*reinterpret_cast<const uint16_t*>(p) << 16);
}

struct RgLayout {
    int p0, ph, pg, ps, pm, oh, og, os, om, stage, x_off, sx_off, xs_off,
        xc_off, part_off, total;
};

__host__ __device__ inline RgLayout rg_layout(int kind, int g, bool i8,
                                              bool xf, int in_f, int stages) {
    RgLayout L;
    const int bh = rg_bh(kind), bg = rg_bg(kind), bm = rg_bm(kind, g);
    const int ng = in_f / g;
    L.p0 = RM_KS * rg_b0(kind) + 16;
    L.ph = bh ? RM_KS * bh + 16 : 0;
    L.pg = bg ? RM_KS * bg + 16 : 0;
    L.ps = RM_KS * rg_bs(kind, g) + 16;
    L.pm = bm ? RM_KS * bm + 16 : 0;
    L.oh = RM_RT * L.p0;
    L.og = L.oh + RM_RT * L.ph;
    L.os = L.og + RM_RT * L.pg;
    L.om = L.os + RM_RT * L.ps;
    L.stage = L.om + RM_RT * L.pm;
    L.x_off = stages * L.stage;
    L.sx_off = L.x_off + (i8 ? in_f : in_f / 32 * rg_xpitch(xf));
    L.xs_off = L.sx_off + (i8 ? ng * 4 : 0);
    L.xc_off = L.xs_off + (kind == GK_IQ1 ? ng * 2 : 0);
    L.part_off = L.xc_off + (kind == GK_IQ1 ? ng * 4 : 0);
    L.total = L.part_off + 2 * RM_KS * RM_RT * 4;
    return L;
}

// 16 rows x 8 spans of one field (B bytes per span row, row stride
// row_bytes in global memory) into its stage region, 16-byte cp.async
// chunks; spans past nsp skipped (B = 8: a chunk holds two spans, and nsp
// and the stage's first span are even)
template <int B>
__device__ __forceinline__ void rg_copy(uint8_t* dst, int pitch,
                                        const uint8_t* src, size_t row_bytes,
                                        int row0, int sp0, int nsp, int tid) {
    constexpr int CPR = RM_KS * B / 16;  // chunks per row
#pragma unroll
    for (int c = tid; c < RM_RT * CPR; c += RM_THREADS) {
        const int r = c / CPR, k = c % CPR;
        int first;  // the chunk's first span
        if constexpr (B >= 16) first = k / (B / 16);
        else first = k * (16 / B);
        if (sp0 + first < nsp)
            cp_async16(dst + r * pitch + k * 16,
                       src + (size_t)(row0 + r) * row_bytes
                           + (size_t)sp0 * B + k * 16);
    }
}

// prmt.b32 in its default mode: a selector nibble of 8-15 replicates the
// sign of the byte it selects over the whole byte
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
    return d;
}

// bit b of every byte of w moved to bit `to` of it (other bits: garbage)
__device__ __forceinline__ uint32_t bit_to(uint32_t w, int b, int to) {
    return to >= b ? w << (to - b) : w >> (b - to);
}

// The four columns' signed values (one s8 each) of plane j of the IQ code
// word q, the hmask and sg words hm / sg of the same columns, bit `bit` of
// each byte. iq2p: the 3-bit index code | sign << 2, one nibble a byte, looks
// the value up in a signed table; iq3px: code | hmask bit << 2 looks up the
// value and its negation, iq3ps computes both (2k + 1, 255 - 2k: no borrow),
// and the sign selects; iq1p: the raw code (P takes the code sum of x off).
template <int KIND>
__device__ __forceinline__ uint32_t iq_values4(uint32_t q, uint32_t hm,
                                               uint32_t sg, int j, int bit) {
    const uint32_t c = (q >> (2 * j)) & 0x03030303u;
    if constexpr (KIND == GK_IQ1) {
        return c;
    } else if constexpr (KIND == GK_IQ2) {
        // 8, 25, 43, 60 (8 + 17c + (c >> 1)) and their negations
        const uint32_t t = c | (bit_to(sg, bit, 2) & 0x04040404u);
        const uint32_t u = t | (t >> 4);
        return prmt(0x3C2B1908u, 0xC4D5E7F8u, prmt(u, 0u, 0x0020u));
    } else {
        const uint32_t k = c | (bit_to(hm, bit, 2) & 0x04040404u);
        const uint32_t m = prmt(bit_to(sg, bit, 7), 0u, 0xBA98u);
        uint32_t v, n;
        if constexpr (KIND == GK_IQ3S) {
            v = k * 2u + 0x01010101u;
            n = 0xFFFFFFFFu - k * 2u;
        } else {  // 4 + 8k, 62 at k = 7
            const uint32_t u = k | (k >> 4);
            const uint32_t sel = prmt(u, 0u, 0x0020u);
            v = prmt(0x1C140C04u, 0x3E342C24u, sel);
            n = prmt(0xE4ECF4FCu, 0xC2CCD4DCu, sel);
        }
        return (v & ~m) | (n & m);
    }
}

// the window's columns: kwin K steps of 8 spans, at most in_f
__host__ __device__ inline int rg_wcols(int kind, int in_f, int kwin) {
    const int w = kwin * RM_KS * rg_span(kind);
    return in_f < w ? in_f : w;
}

template <int KIND, bool I8, int G, bool XF, bool WIN>
__global__ void __launch_bounds__(RM_THREADS, 2)
rowmvg_kernel(const uint8_t* __restrict__ f0,          // q8_0 q / IQ qs
              const uint8_t* __restrict__ fh,          // hmask / null
              const uint8_t* __restrict__ fg,          // sg / null
              const __nv_bfloat16* __restrict__ scale,
              const __nv_bfloat16* __restrict__ mn,    // iq1p min / null
              const __nv_bfloat16* __restrict__ x,     // (in_f)
              __nv_bfloat16* __restrict__ y,           // (out_f)
              int out_f, int in_f, int stages, Stacked stk, int kwin) {
    extern __shared__ __align__(16) uint8_t smem[];
    constexpr int SPAN = rg_span(KIND), B0 = rg_b0(KIND), BH = rg_bh(KIND),
                  BG = rg_bg(KIND), BS = rg_bs(KIND, G), BM = rg_bm(KIND, G);
    constexpr bool IQ1 = KIND == GK_IQ1;
    constexpr int LPG = G / 8;     // prep lanes per group, 8 columns each
    constexpr int GH = 128 / G;    // IQ: groups per half superblock
    f0 = stk.at(f0, 0);
    fh = stk.at(fh, 1);
    fg = stk.at(fg, 2);
    scale = stk.at(scale, 3);
    mn = stk.at(mn, 4);
    // x's window: its columns (all of x without WIN)
    const int wcols = WIN ? rg_wcols(KIND, in_f, kwin) : in_f;
    const RgLayout L = rg_layout(KIND, G, I8, XF, wcols, stages);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int nsp = in_f / SPAN, ng = in_f / G;
    const int ksteps = (nsp + RM_KS - 1) / RM_KS;
    const int ntiles = out_f / RM_RT;
    const int mine = (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
    const int total = mine * ksteps;  // (tile, K step) pairs of this block
    const size_t r0 = (size_t)nsp * B0, r1 = (size_t)in_f / 8,
                 rs = (size_t)ng * 2;

    // activation prep, part 1: 8 columns (one 16-byte load) a task, over x
    // or a window of it (xw: its first column, ntask: its columns / 8); the
    // first RM_XR rounds go out before the weight stream
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

    // one stage: rows [tile*16, +16) x spans [kstep*8, +8) of every field
    auto issue = [&](int it, int slot) {
        const int row0 = (blockIdx.x + (it / ksteps) * gridDim.x) * RM_RT;
        const int sp0 = (it % ksteps) * RM_KS;
        uint8_t* st = smem + slot * L.stage;
        rg_copy<B0>(st, L.p0, f0, r0, row0, sp0, nsp, tid);
        if constexpr (BH != 0)
            rg_copy<BH>(st + L.oh, L.ph, fh, r1, row0, sp0, nsp, tid);
        if constexpr (BG != 0)
            rg_copy<BG>(st + L.og, L.pg, fg, r1, row0, sp0, nsp, tid);
        rg_copy<BS>(st + L.os, L.ps,
                    reinterpret_cast<const uint8_t*>(scale), rs, row0, sp0,
                    nsp, tid);
        if constexpr (BM != 0)
            rg_copy<BM>(st + L.om, L.pm,
                        reinterpret_cast<const uint8_t*>(mn), rs, row0, sp0,
                        nsp, tid);
    };
    for (int s = 0; s < stages - 1; ++s) {
        if (s < total) issue(s, s);
        cp_async_commit();
    }

    // activation prep, part 2, while the first stages arrive. Task li takes
    // columns 8li..8li+7, LPG tasks a group: half v = li & 1 of 16-column
    // chunk c = li >> 1, i.e. lanes tig 2v and 2v+1's 4 codes each, at
    // chunk c & 7 of 128-column block c >> 3 (rowmv.cuh's image). The bf16
    // body keeps x in column order, as bf16 or (XF) as f32, each 32-column
    // group 16 bytes past its own size (`rg_xpitch`).
    uint8_t* xi = smem + L.x_off;
    float* sxs = reinterpret_cast<float*>(smem + L.sx_off);
    __nv_bfloat16* xss = reinterpret_cast<__nv_bfloat16*>(smem + L.xs_off);
    int* xcs = reinterpret_cast<int*>(smem + L.xc_off);
    auto prep_x = [&](const __nv_bfloat16* xw, int ntask) {
    for (int base = 0; base < ntask; base += RM_XR * RM_THREADS) {
        if (base) load_x(xw, ntask, base);
#pragma unroll
        for (int u = 0; u < RM_XR; ++u) {
            if (base + u * RM_THREADS >= ntask) break;  // the same for all
            const int li = base + u * RM_THREADS + tid;
            // ntask is a multiple of 32: whole warps skip, shuffles intact
            if (li >= ntask) continue;
            if constexpr (!I8) {
                // group li >> 2 at its pitch, quarter li & 3 of it
                uint8_t* dst = xi + (li >> 2) * rg_xpitch(XF)
                               + (li & 3) * (XF ? 32 : 16);
                const uint4 w = raw[u];
                if constexpr (XF) {
                    *reinterpret_cast<uint4*>(dst) = make_uint4(
                        w.x << 16, w.x & 0xFFFF0000u, w.y << 16,
                        w.y & 0xFFFF0000u);
                    *reinterpret_cast<uint4*>(dst + 16) = make_uint4(
                        w.z << 16, w.z & 0xFFFF0000u, w.w << 16,
                        w.w & 0xFFFF0000u);
                } else {
                    *reinterpret_cast<uint4*>(dst) = w;
                }
            } else {
                const uint32_t w[4] = {raw[u].x, raw[u].y, raw[u].z,
                                       raw[u].w};
                float e8[8];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    e8[2 * e] = __uint_as_float(w[e] << 16);
                    e8[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
                }
                float sm = e8[0], a = fabsf(e8[0]);
#pragma unroll
                for (int e = 1; e < 8; ++e) {
                    if (IQ1) sm = __fadd_rn(sm, e8[e]);
                    a = fmaxf(a, fabsf(e8[e]));
                }
#pragma unroll
                for (int o = 1; o < LPG; o <<= 1) {
                    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
                    if (IQ1)
                        sm = __fadd_rn(sm, __shfl_xor_sync(0xffffffffu, sm, o));
                }
                a = fmaxf(a, 1e-20f);
                const float inv = 127.0f / a;
                int c[8];  // rint(x * (127 / amax)), |c| <= 127
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    c[e] = __float2int_rn(__fmul_rn(e8[e], inv));
                const int ch = li >> 1, v = li & 1;
                uint8_t* dst = xi + (ch >> 3) * 128 + 2 * v * 32 + (ch & 7) * 4;
                *reinterpret_cast<uint32_t*>(dst) =
                    __byte_perm(__byte_perm(c[0], c[1], 0x0040),
                                __byte_perm(c[2], c[3], 0x0040), 0x5410);
                *reinterpret_cast<uint32_t*>(dst + 32) =
                    __byte_perm(__byte_perm(c[4], c[5], 0x0040),
                                __byte_perm(c[6], c[7], 0x0040), 0x5410);
                const int g = li / LPG;
                if (li % LPG == 0) sxs[g] = a / 127.0f;
                if constexpr (IQ1) {
                    int cs = c[0];
#pragma unroll
                    for (int e = 1; e < 8; ++e) cs += c[e];
#pragma unroll
                    for (int o = 1; o < LPG; o <<= 1)
                        cs += __shfl_xor_sync(0xffffffffu, cs, o);
                    if (li % LPG == 0) {
                        xss[g] = f2bf(sm);
                        xcs[g] = cs;
                    }
                }
            }
        }
    }
    };
    prep_x(x, wcols / 8);

    // lane (gid, tig) combines row myrow of the tile (q8_0: group tig of
    // each span in rows gid and gid + 8); its ldmatrix row and chunk pick
    // (lanes 8m..8m+7 address matrix m: rows 0-7 / 8-15 of the first
    // chunk, then of the second).
    const int myrow = gid + 8 * (tig & 1);
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int lsel = lane >> 4;
    // G = 8: this lane's B column takes the chunk's first 8 columns (even
    // columns) or its last 8 (odd)
    const bool keep = (gid & 1) == (tig >> 1);
    float acc = 0.f, acc8 = 0.f;  // q8_0: rows gid and gid + 8
    float accm[4] = {0.f, 0.f, 0.f, 0.f};
    int slot = 0, wsp0 = 0;  // wsp0: the window's first span
    for (int it = 0; it < total; ++it) {
        const int ks = it % ksteps;
        if (WIN && it > 0 && ks % kwin == 0) {
            // the next window (at a new tile the first again): once every
            // warp is done with the last one, prep it as above
            wsp0 = ks * RM_KS;
            __syncthreads();
            const int nt = min(wcols, in_f - wsp0 * SPAN) / 8;
            load_x(x + wsp0 * SPAN, nt, 0);
            prep_x(x + wsp0 * SPAN, nt);
        }
        cp_async_wait_n(stages - 2);
        __syncthreads();
        if (it + stages - 1 < total)
            issue(it + stages - 1, slot == 0 ? stages - 1 : slot - 1);
        cp_async_commit();
        const int sp = ks * RM_KS + warp;
        const int sw = sp - wsp0;  // in x's window
        if (sp < nsp) {
            const uint8_t* st = smem + slot * L.stage;
            if constexpr (KIND == GK_Q8 && I8) {
                // 4 groups of 32: ldmatrix.x4 gives the A fragment of 16
                // rows x 32 codes; B = the lane's words of chunks 2i, 2i+1.
                // The lane takes group tig of rows gid and gid + 8.
                const uint8_t* xb = xi + sw * 128 + tig * 32;
                const uint4 xa = *reinterpret_cast<const uint4*>(xb);
                const uint4 xc = *reinterpret_cast<const uint4*>(xb + 16);
                const uint8_t* arow = st + lrow * L.p0 + warp * 128
                                      + (lsel << 4);
                int d[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    uint32_t a[4];
                    ldmatrix_x4(a, arow + 32 * i);
                    const uint4& xw = i < 2 ? xa : xc;
                    mma16832_s8(d[i], a, u4_at(xw, (2 * i) & 3),
                                u4_at(xw, (2 * i + 1) & 3));
                }
                // exact: |P| <= 32 * 127 * 127
                int p0 = d[0][0], p8 = d[0][2];
#pragma unroll
                for (int i = 1; i < 4; ++i) {
                    p0 = tig == i ? d[i][0] : p0;
                    p8 = tig == i ? d[i][2] : p8;
                }
                const float sxv = sxs[sw * 4 + tig];
                const uint8_t* sr = st + L.os + warp * 8 + tig * 2;
                acc = __fadd_rn(acc, __fmul_rn(__fmul_rn((float)p0, sxv),
                                               lds_bf(sr + gid * L.ps)));
                acc8 = __fadd_rn(acc8, __fmul_rn(__fmul_rn((float)p8, sxv),
                                                 lds_bf(sr + (gid + 8) * L.ps)));
            } else if constexpr (KIND == GK_Q8) {
                // the lane takes group tig of rows gid and gid + 8: x_c q_c
                // added in column order from 0, a code to f32 as (2^23 + 128
                // + q) - (2^23 + 128), exact; x (its 32 columns at a pitch
                // of 32 + 16 bytes a group, `rg_xpitch`) read once for both
                constexpr int XB = XF ? 4 : 2;  // bytes of one x in the image
                const uint8_t* cr = st + gid * L.p0 + warp * 128 + tig * 32;
                const uint8_t* xr = xi + (sw * 4 + tig) * rg_xpitch(XF);
                float p[2] = {0.f, 0.f};  // rows gid, gid + 8
#pragma unroll
                for (int q16 = 0; q16 < 2; ++q16) {
                    uint4 cw[2], xw[XB];  // 16 columns' codes and x
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        cw[r] = *reinterpret_cast<const uint4*>(
                            cr + 8 * r * L.p0 + 16 * q16);
                        cw[r].x ^= 0x80808080u;
                        cw[r].y ^= 0x80808080u;
                        cw[r].z ^= 0x80808080u;
                        cw[r].w ^= 0x80808080u;
                    }
#pragma unroll
                    for (int k = 0; k < XB; ++k)
                        xw[k] = *reinterpret_cast<const uint4*>(
                            xr + XB * 16 * q16 + 16 * k);
#pragma unroll
                    for (int c = 0; c < 16; ++c) {
                        float xf;
                        if constexpr (XF) {
                            xf = __uint_as_float(u4_at(xw[c >> 2], c & 3));
                        } else {
                            const uint32_t xv = u4_at(xw[c >> 3],
                                                      (c >> 1) & 3);
                            xf = __uint_as_float(c & 1 ? xv & 0xFFFF0000u
                                                       : xv << 16);
                        }
#pragma unroll
                        for (int r = 0; r < 2; ++r) {
                            const float qf = __fsub_rn(__uint_as_float(
                                __byte_perm(u4_at(cw[r], c >> 2),
                                            0x4B000000u, 0x7540 | (c & 3))),
                                8388736.0f);
                            p[r] = __fmaf_rn(xf, qf, p[r]);  // exact product
                        }
                    }
                }
                const uint8_t* sr = st + L.os + warp * 8 + tig * 2;
                acc = __fadd_rn(acc, __fmul_rn(p[0], lds_bf(sr + gid * L.ps)));
                acc8 = __fadd_rn(acc8, __fmul_rn(p[1], lds_bf(
                                                     sr + (gid + 8) * L.ps)));
            } else {
                constexpr bool HI = KIND == GK_IQ3X || KIND == GK_IQ3S;
                constexpr bool SIGN = KIND != GK_IQ1;
                if constexpr (IQ1) {
                    // sum_g xs_g m_g of the superblock's 256 / G groups on
                    // the tensor cores: A = 16 rows x the groups' m, B = xs
                    // in every column; products exact, f32 sums
                    const uint8_t* mr = st + L.om + warp * BM + 4 * tig;
                    const uint32_t* xw = reinterpret_cast<const uint32_t*>(
                        xss + sw * (256 / G));
                    if constexpr (G == 32) {
                        mma1688(accm, lds32(mr + gid * L.pm),
                                lds32(mr + (gid + 8) * L.pm), xw[tig]);
                    } else {
#pragma unroll
                        for (int k = 0; k < 256 / G / 16; ++k) {
                            const uint32_t a[4] = {
                                lds32(mr + gid * L.pm + 32 * k),
                                lds32(mr + (gid + 8) * L.pm + 32 * k),
                                lds32(mr + gid * L.pm + 32 * k + 16),
                                lds32(mr + (gid + 8) * L.pm + 32 * k + 16)};
                            mma16816(accm, a, xw[8 * k + tig],
                                     xw[8 * k + 4 + tig]);
                        }
                    }
                }
                const int hh = tig >> 1;
                const uint8_t* arow = st + lrow * L.p0 + warp * 64;
                // hmask / sg chunks u = 0, 1 (rows gid, gid+8)
                uint32_t hm[4] = {0u, 0u, 0u, 0u}, sg[4] = {0u, 0u, 0u, 0u};
                if constexpr (HI)
                    ldmatrix_x4(hm, st + L.oh + lrow * L.ph + warp * 32
                                        + (lsel << 4));
                if constexpr (SIGN)
                    ldmatrix_x4(sg, st + L.og + lrow * L.pg + warp * 32
                                        + (lsel << 4));
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    // qs chunks 2h, 2h+1: q[2u + r], row gid + 8r
                    uint32_t q[4];
                    ldmatrix_x4(q, arow + ((2 * h + lsel) << 4));
                    // 128-column block hb: its GH groups' sx (and code
                    // sums), this lane's row's scales, its B words
                    const int hb = 2 * sw + h;
                    float sxv[GH];
                    int xcv[GH];
                    uint32_t sw[GH / 2];
#pragma unroll
                    for (int k = 0; k < GH; k += 4) {
                        const float4 t = *reinterpret_cast<const float4*>(
                            sxs + hb * GH + k);
                        sxv[k] = t.x; sxv[k + 1] = t.y;
                        sxv[k + 2] = t.z; sxv[k + 3] = t.w;
                        if (IQ1) {
                            const int4 cs = *reinterpret_cast<const int4*>(
                                xcs + hb * GH + k);
                            xcv[k] = cs.x; xcv[k + 1] = cs.y;
                            xcv[k + 2] = cs.z; xcv[k + 3] = cs.w;
                        }
                    }
                    const uint8_t* srow = st + L.os + myrow * L.ps
                                          + warp * BS + h * (BS / 2);
#pragma unroll
                    for (int k = 0; k < GH / 2; k += 2) {
                        const uint2 t = *reinterpret_cast<const uint2*>(
                            srow + 4 * k);
                        sw[k] = t.x;
                        sw[k + 1] = t.y;
                    }
                    const uint8_t* xb = xi + hb * 128 + tig * 32;
                    const uint4 xv[2] = {
                        *reinterpret_cast<const uint4*>(xb),
                        *reinterpret_cast<const uint4*>(xb + 16)};
                    // groups 2m (pa) and 2m + 1 (pb) of the block on this
                    // lane's row: the lane takes the even (hh 0) or odd one
                    auto take = [&](int pa, int pb, int m) {
                        int p = hh ? pb : pa;
                        if (IQ1) p -= hh ? xcv[2 * m + 1] : xcv[2 * m];
                        const float sx = hh ? sxv[2 * m + 1] : sxv[2 * m];
                        const float s = __uint_as_float(
                            hh ? sw[m] & 0xFFFF0000u : sw[m] << 16);
                        acc = __fmaf_rn(__fmul_rn((float)p, sx), s, acc);
                    };
                    int prev = 0;  // G = 32: the even plane's dot
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        uint32_t cw[2][2];  // [u][r]: the signed values
#pragma unroll
                        for (int u = 0; u < 2; ++u)
#pragma unroll
                            for (int r = 0; r < 2; ++r)
                                cw[u][r] = iq_values4<KIND>(
                                    q[2 * u + r], hm[2 * u + r],
                                    sg[2 * u + r], j, 4 * h + j);
                        if constexpr (G == 32) {
                            const uint32_t a[4] = {cw[0][0], cw[0][1],
                                                   cw[1][0], cw[1][1]};
                            int d[4];
                            mma16832_s8(d, a, u4_at(xv[j >> 1], (2 * j) & 3),
                                        u4_at(xv[j >> 1], (2 * j + 1) & 3));
                            const int p = tig & 1 ? d[2] : d[0];
                            if (j & 1) take(prev, p, j >> 1);
                            else prev = p;
                        } else if constexpr (G == 16) {
                            int d0[4], d1[4];
                            mma16816_s8(d0, cw[0][0], cw[0][1],
                                        u4_at(xv[j >> 1], (2 * j) & 3));
                            mma16816_s8(d1, cw[1][0], cw[1][1],
                                        u4_at(xv[j >> 1], (2 * j + 1) & 3));
                            take(tig & 1 ? d0[2] : d0[0],
                                 tig & 1 ? d1[2] : d1[0], j);
                        } else {
#pragma unroll
                            for (int u = 0; u < 2; ++u) {
                                const int ch = 2 * j + u;
                                int d[4];
                                mma16816_s8(d, cw[u][0], cw[u][1],
                                            keep ? u4_at(xv[ch >> 2], ch & 3)
                                                 : 0u);
                                take(tig & 1 ? d[2] : d[0],
                                     tig & 1 ? d[3] : d[1], ch);
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
            if constexpr (KIND == GK_Q8) {
                // each row's 4 groups first: (tig 0 + 1) + (tig 2 + 3)
                float pw[2] = {acc, acc8};
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    pw[r] = __fadd_rn(pw[r],
                                      __shfl_xor_sync(0xffffffffu, pw[r], 1));
                    pw[r] = __fadd_rn(pw[r],
                                      __shfl_xor_sync(0xffffffffu, pw[r], 2));
                }
                if (tig == 0) {
                    part[warp * RM_RT + gid] = pw[0];
                    part[warp * RM_RT + gid + 8] = pw[1];
                }
            } else {
                // the lane pair's halves first: hh 0 + hh 1
                const float pw = __fadd_rn(
                    acc, __shfl_xor_sync(0xffffffffu, acc, 2));
                if (tig < 2) {
                    part[warp * RM_RT + myrow] = pw;
                    if (IQ1)
                        part[PW + warp * RM_RT + myrow] = tig & 1 ? accm[2]
                                                                  : accm[0];
                }
            }
            acc = acc8 = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) accm[e] = 0.f;
            __syncthreads();
            if (tid < RM_RT) {
                float sa = part[tid], sm = part[PW + tid];
#pragma unroll
                for (int w = 1; w < RM_KS; ++w) {
                    sa = __fadd_rn(sa, part[w * RM_RT + tid]);
                    if (IQ1) sm = __fadd_rn(sm, part[PW + w * RM_RT + tid]);
                }
                const int row0 = (blockIdx.x + (it / ksteps) * gridDim.x) * RM_RT;
                y[row0 + tid] = f2bf(IQ1 ? __fsub_rn(sa, sm) : sa);
            }
        }
        slot = slot + 1 == stages ? 0 : slot + 1;
    }
    cp_async_wait<0>();
}

template <int KIND, bool I8, int G, bool XF, bool WIN>
static cudaError_t rowmvg_launch1(const void* f0, const void* fh,
                                  const void* fg, const void* scale,
                                  const void* mn, const void* x, void* y,
                                  int out_f, int in_f, int grid, int stages,
                                  int smem, Stacked stk, int kwin,
                                  cudaStream_t st) {
    static bool ready = false;  // the opt-in above 48 KB, once per body
    if (!ready) {
        cudaError_t e = cudaFuncSetAttribute(
            rowmvg_kernel<KIND, I8, G, XF, WIN>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, RM_SMEM_MAX);
        if (e != cudaSuccess) return e;
        ready = true;
    }
    rowmvg_kernel<KIND, I8, G, XF, WIN><<<grid, RM_THREADS, smem, st>>>(
        (const uint8_t*)f0, (const uint8_t*)fh, (const uint8_t*)fg,
        (const __nv_bfloat16*)scale, (const __nv_bfloat16*)mn,
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, out_f, in_f, stages,
        stk, kwin);
    return cudaGetLastError();
}

// the body for x whole, or (kwin below the K steps) in windows
template <int KIND, bool I8, int G, bool XF = false>
static cudaError_t rowmvg_launch(const void* f0, const void* fh,
                                 const void* fg, const void* scale,
                                 const void* mn, const void* x, void* y,
                                 int out_f, int in_f, int grid, int stages,
                                 int smem, Stacked stk, int kwin,
                                 cudaStream_t st) {
    const int nsp = in_f / rg_span(KIND);
    if (kwin < (nsp + RM_KS - 1) / RM_KS)
        return rowmvg_launch1<KIND, I8, G, XF, true>(
            f0, fh, fg, scale, mn, x, y, out_f, in_f, grid, stages, smem,
            stk, kwin, st);
    return rowmvg_launch1<KIND, I8, G, XF, false>(
        f0, fh, fg, scale, mn, x, y, out_f, in_f, grid, stages, smem, stk,
        kwin, st);
}

// the launch arguments `rowmv_plan` gives, checked against this source's
// layout: a plan that differs is refused
inline bool rg_plan_ok(int kind, int g, bool i8, bool xf, int out_f,
                       int in_f, int grid, int stages, int smem, int kwin) {
    const int nsp = in_f / rg_span(kind);
    return in_f > 0 && in_f % 256 == 0 && out_f > 0 && out_f % RM_RT == 0
           && grid >= 1 && grid <= out_f / RM_RT && stages >= 2
           && stages <= 4 && smem <= RM_SMEM_MAX && kwin >= 1
           && kwin <= (nsp + RM_KS - 1) / RM_KS
           && smem == rg_layout(kind, g, i8, xf, rg_wcols(kind, in_f, kwin),
                                stages).total;
}
