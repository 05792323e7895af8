// K3: q4_k / q5_k / q6_k / q8_0 matmul of prefill chunks and batched steps,
// y (T, out_f) bf16 = x (T, in_f) bf16 . W^T with f32 accumulation; K13: its
// q2_k / q3_k, native IQ (iq2p / iq3px / iq3ps / iq1p) and q4_k_i8 bodies.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matmul_2d`: bodies
// `_q4k_kernel` (the default KCPP_Q4K_2D=sexp), `_q5k_kernel`, `_q6k_kernel`
// and `_q8_0_kernel` (K3), `_q2k_kernel`, `_q3k_kernel`, `_iq2p_kernel`,
// `_iq3p_kernel` (iq3px and iq3ps), `_iq1p_kernel` and `_q4k_i8_kernel`
// (K13; the last under KCPP_Q4K_LAYOUT=i8, at every T), and
// `_q4k_magic_kernel` (KCPP_Q4K_2D=magic: K3.q4_k_magic, kind 11, below).
// As there, the
// weight fed to the product is bf16(q * scale) (q4_k: the nibble 0..15;
// q5_k: the nibble with its 5th bit, 0..31; q6_k: the 6-bit value 0..63;
// q8_0: the int8 code; q2_k: the 2-bit code 0..3; q3_k: the 2-bit code with
// its hmask bit, 0..7; the IQ kinds: the signed alphabet value, |v| <= 62,
// with the scale of its group of G = 8, 16 or 32; q4_k_i8: the int8 code
// 0..15), and the affine part is a second product over per-group sums of
// x: q4_k, q5_k and q4_k_i8 subtract xsum_bf16 . min (groups of 32), q2_k
// xsum_bf16 . min (groups of 16), iq1p xsum_bf16 . min (groups of G), q6_k
// 32 * xsum_bf16 . scale and q3_k 4 * xsum_bf16 . scale (groups of 16);
// q8_0 and iq2p / iq3px / iq3ps have none. Both terms run through the same
// tensor-core loop: after each 256-column superblock, one or two k16 steps
// take A = -min, -32 * scale or -4 * scale (exact in bf16) and B = the
// superblock's group sums.
//
// Design (both variants):
// - Weight rows are the M side of the product and tokens the N side, so
//   each thread dequantizes its own A fragment (the m16n8k16 layout, which
//   wgmma takes from registers too) straight from the packed bytes: no bf16
//   weight tile is written to shared memory.
// - A call first runs a prep kernel: x with its columns permuted inside
//   each superblock (`xp`) so that the 16 k positions of one k16 step are
//   the columns one thread's packed bytes hold, and the group sums in
//   wgmma core-matrix order (`xs`). In superblock terms, thread c of a quad
//   at step s of quarter q holds columns 128h + 32c + 8q + 2s + e (h = 0
//   for k < 8, 1 above; e = 0, 1): every packed field (qs2, ql, qh, qs,
//   hmask, sg, q) holds quarter q's columns of a thread in 8-byte runs of
//   its superblock image, which crosses from L2 / HBM into shared memory
//   once per block, and one q4_k byte feeds both its nibbles to one step.
// - bf16(v * s) is one fma.rn.bf16x2 per pair: (128 + |v|) * (+-s) +
//   (-+128 s), exact before its single rounding (|v| <= 128 keeps 128 + |v|
//   exact in bf16).
// - Determinism: every output element sums its superblocks in order, k16
//   step after k16 step, the affine steps after each superblock; no atomics.
//   Within a variant, row t of y depends on row t of x alone, whatever T is.
//
// (a) "wgmma", T > 8 (prefill chunks, the 16-row bucket, batched waves):
//     bound by operations at T >= 128 (2 T in out bf16 FLOPs over 989
//     TFLOP/s), by bytes below. Blocks of 64 weight rows per warpgroup
//     and x tiles of 64 or 128 tokens; where out_f / 64 tiles leave SMs
//     idle, 2-4 warpgroups split K by superblock and add their tiles in a
//     fixed order through shared memory at the end (`kq_plan` /
//     `kq_split` in ops/quant_matmul.py pick all of it, the split from the
//     weight's shape alone). The x quarters (64 permuted columns) run
//     through a 3-stage ring in the 128-byte swizzle the wgmma descriptor
//     names; each superblock's raw code image, scales, mins, bit planes
//     and group sums arrive whole (16-byte cp.async) in one of two round
//     slots; then fence.proxy.async and a barrier before wgmma reads them.
//     Each quarter dequantizes its four A fragments while the previous
//     quarter's four wgmma.mma_async m64nNk16 run (wait_group 1); the
//     affine steps close each superblock. Epilogue: bf16 through shared
//     memory, 16-byte stores. On the H100 (PERF.md) the loop is
//     bound by its own instruction latency at a few warps per SM (a
//     deeper ring, or dropping the fence or the barrier, barely moved
//     it), so the out_f = 2048 / 2560 shapes, with few tiles, sit
//     furthest from the bound.
// (b) "swap", T <= 8 (batched decode, q4_k_i8 and narrow IQ shapes at
//     T = 1): bound by the packed bytes. Blocks of 4 warps on 16 weight
//     rows (out_f / 16 blocks), K split across the 4 warps by superblock
//     (warp w takes superblocks w, w + 4, ...), each warp with its own
//     4-stage cp.async ring of whole superblocks; mma.sync m16n8k16 with
//     the tokens as N = 8; the four partial tiles are summed in a fixed
//     order through shared memory.
// K3.q4_k_magic (kind Q4KM, the q4_k fields): the weight fed to the
// product is bf16(s * (128 + 8 n)), one bf16x2 multiply of the exact
// magic value 0x4300 | n << 3 by the scale (a rounding of its own, where
// the default body rounds s * n); the one affine k16 step takes A =
// -128 s on k 0-7 and -8 min on k 8-15 against B = the superblock's 8
// group sums on both halves (the prep writes them twice), and the
// epilogue scales the f32 sum by 0.125 (exact): 0.125 x . w - 16 xsum .
// s - xsum . min, the JAX body's terms.
// Launch counters: ops/_build.launches["K3"] (q4_k, q6_k), ["K3.q5_k"],
// ["K3.q8_0"], ["K13.q2_k"], ["K13.q3_k"], ["K13.iq2p"], ["K13.iq3px"],
// ["K13.iq3ps"], ["K13.iq1p"], ["K13.q4_k_i8"] and ["K3.q4_k_magic"], one
// per matmul.
#include "common.cuh"
#include "hopper.cuh"

namespace {

enum { Q4K = 0, Q6K = 1, Q5K = 2, Q80 = 3, Q2K = 4, Q3K = 5, IQ2P = 6,
       IQ3PX = 7, IQ3PS = 8, IQ1P = 9, Q4KI8 = 10, Q4KM = 11 };

template <int K>
struct Kind {
    // 8-byte runs of the code fields per row and quarter superblock
    static constexpr int NRUN = (K == Q4K || K == Q5K || K == Q4KM) ? 4
                              : K == Q6K ? 6
                              : (K == Q80 || K == Q4KI8) ? 8 : 2;
    static constexpr int IMG = 32 * NRUN;  // code bytes per row, superblock
    static constexpr bool MIN = K == Q4K || K == Q5K || K == Q2K
                                || K == IQ1P || K == Q4KI8 || K == Q4KM;
    // a 32-byte bit plane per superblock: q5_k qh, q3_k / iq3 hmask
    static constexpr bool HM = K == Q5K || K == Q3K || K == IQ3PX
                               || K == IQ3PS;
    static constexpr bool SG = K == IQ2P || K == IQ3PX || K == IQ3PS;
    static constexpr bool AFF = MIN || K == Q6K || K == Q3K;
    static constexpr bool IQ = K >= IQ2P && K <= IQ1P;
    static constexpr int GRP = (K == Q6K || K == Q2K || K == Q3K) ? 16 : 32;
    // affine k16 steps per superblock: iq1p's 256 / G groups (G = 8: 32)
    // take two, with zero coefficients and sums past its groups
    static constexpr int NA = !AFF ? 0 : K == IQ1P ? 2 : 1;
};

struct Args {
    const __nv_bfloat16* xp;  // (T, in_f) x, columns permuted per superblock
    const __nv_bfloat16* xs;  // group sums, (nsb, na, t8) blocks of 8 x 16
    const uint8_t* w0;        // qs2 | ql | q | qs
    const uint8_t* w1;        // q6_k qh | q5_k qh | hmask
    const uint8_t* w2;        // sg
    const __nv_bfloat16* scale;
    const __nv_bfloat16* mn;
    __nv_bfloat16* y;
    int T, out_f, in_f, grp, na, t8;
};

// logical column of permuted position p (0..255) of a superblock
__device__ __forceinline__ int perm_col(int p) {
    const int S = p >> 4, kp = p & 15;
    return 128 * (kp >> 3) + 32 * ((kp & 7) >> 1) + 8 * (S >> 2)
           + 2 * (S & 3) + (kp & 1);
}

// Byte offset of code run u of quarter q inside a row's superblock image
// (q6_k: ql's 128 bytes, then qh's 64).
template <int K>
__device__ __forceinline__ int img_off(int u, int q) {
    if (K == Q6K) return u < 4 ? 32 * u + 8 * q : 128 + 32 * (u - 4) + 8 * q;
    if (K == Q80 || K == Q4KI8) return 128 * (u >> 2) + 32 * (u & 3) + 8 * q;
    return 32 * u + 8 * q;
}

template <int K>
__device__ __forceinline__ const uint8_t* img_src(const Args& a, int r,
                                                  int sb, int o) {
    if (K == Q6K && o >= 128)
        return a.w1 + (size_t)r * (a.in_f / 4) + sb * 64 + (o - 128);
    constexpr int IMG0 = K == Q6K ? 128 : Kind<K>::IMG;
    return a.w0 + (size_t)r * (a.in_f / 256 * IMG0) + (size_t)sb * IMG0 + o;
}

// the factor of the f32 sums before the bf16 store (K3.q4_k_magic: 0.125)
template <int K>
constexpr float OUT_SCALE = K == Q4KM ? 0.125f : 1.f;

// Per row and superblock the small fields sit together: scale (512 / grp
// bytes), min (as many, MIN kinds), the 32-byte bit plane (HM), sg (SG).
template <int K>
__host__ __device__ __forceinline__ int sbb_bytes(int grp) {
    const int sc = 512 / grp;
    return sc * (Kind<K>::MIN ? 2 : 1) + (Kind<K>::HM ? 32 : 0)
           + (Kind<K>::SG ? 32 : 0);
}

// What one thread holds of one weight row for one quarter superblock.
struct RowQ {
    uint2 r0, r1, r2, r3;  // 8-byte runs (see load_row)
    uint32_t hb;           // q5_k: qh bytes of h = 0 (bits 0-7), h = 1 (8-15)
    uint32_t s0, n0, s1, n1;  // bf16x2 scale and -128 * scale, h = 0 and 1
};

__device__ __forceinline__ void scale_pair(__nv_bfloat16 s, uint32_t& s2,
                                           uint32_t& n2) {
    const uint32_t sv = __bfloat16_as_ushort(s);
    const uint32_t nv = __bfloat16_as_ushort(f2bf(-128.f * bf2f(s)));
    s2 = sv | (sv << 16);
    n2 = nv | (nv << 16);
}

__device__ __forceinline__ uint2 ld_run(const uint8_t* p) {
    return *reinterpret_cast<const uint2*>(p);
}

// img: the row's superblock code image; sm: the row's small fields of the
// superblock. Runs: q4_k / q5_k r0 = qs2 [32c + 8q]; q6_k r0 / r1 = ql of
// h = 0 / 1 ([64h + 32(c & 1) + 8q]), r2 / r3 = qh of h = 0 / 1 ([32h +
// 8q]); q8_0 / q4_k_i8 r0 / r1 = q [128h + 32c + 8q]; q2_k / q3_k / IQ r0
// / r1 = qs of h = 0 / 1 ([32h + 8q]), r2 = hmask [8q], r3 = sg [8q].
template <int K>
__device__ __forceinline__ RowQ load_row(const uint8_t* img,
                                         const uint8_t* sm, int q, int c,
                                         int grp) {
#define RUN(u) ld_run(img + img_off<K>((u), q))
    RowQ o;
    o.r1 = o.r2 = o.r3 = make_uint2(0u, 0u);
    o.hb = 0u;
    if (K == Q4K || K == Q5K || K == Q4KM) {
        o.r0 = RUN(c);
    } else if (K == Q6K) {
        o.r0 = RUN(c & 1);
        o.r1 = RUN(2 + (c & 1));
        o.r2 = RUN(4);
        o.r3 = RUN(5);
    } else if (K == Q80 || K == Q4KI8) {
        o.r0 = RUN(c);
        o.r1 = RUN(4 + c);
    } else {
        o.r0 = RUN(0);
        o.r1 = RUN(1);
    }
#undef RUN
    const int sc = 512 / grp;
    const uint8_t* hm = sm + sc * (Kind<K>::MIN ? 2 : 1);
    const uint8_t* sg = hm + (Kind<K>::HM ? 32 : 0);
    if (K == Q5K) o.hb = (uint32_t)hm[4 * c + q] | ((uint32_t)hm[16 + 4 * c + q] << 8);
    if (K == Q3K || K == IQ3PX || K == IQ3PS) o.r2 = ld_run(hm + 8 * q);
    if (Kind<K>::SG) o.r3 = ld_run(sg + 8 * q);
    const __nv_bfloat16* s = reinterpret_cast<const __nv_bfloat16*>(sm);
    scale_pair(s[(32 * c + 8 * q) / grp], o.s0, o.n0);
    scale_pair(s[(128 + 32 * c + 8 * q) / grp], o.s1, o.n1);
    return o;
}

// bytes 2s and 2s + 1 of an 8-byte run into the low bytes of two 16-bit
// lanes
__device__ __forceinline__ uint32_t pick2(uint2 r, int s) {
    return __byte_perm(s < 2 ? r.x : r.y, 0u, (s & 1) ? 0x4342 : 0x4140);
}

// |v| pair (16-bit lanes, each <= 128), sign bits (bit 15 of each lane) ->
// bf16x2 of v * s
__device__ __forceinline__ uint32_t wpair(uint32_t mag, uint32_t sgn,
                                          uint32_t s2, uint32_t n2) {
    return bf16x2_fma(mag | 0x43004300u, s2 ^ sgn, n2 ^ sgn);
}

// the same for a pair of int8 codes (two's complement bytes in the lanes)
__device__ __forceinline__ uint32_t wpair_i8(uint32_t p, uint32_t s2,
                                             uint32_t n2) {
    const uint32_t neg = p & 0x00800080u;
    const uint32_t m = (neg >> 7) * 0xFFFFu;
    const uint32_t mag = (p & ~m) | ((0x01000100u - p) & m);
    return wpair(mag, neg << 8, s2, n2);
}

// IQ codes -> alphabet magnitudes (and iq1p's sign), two lanes at a time
template <int K>
__device__ __forceinline__ void iq_mag(uint32_t& v, uint32_t& sgn) {
    if (K == IQ2P) {
        v = 0x00080008u + 17u * v + ((v >> 1) & 0x00010001u);
    } else if (K == IQ3PX) {
        const uint32_t is7 = ((v + 0x00010001u) >> 3) & 0x00010001u;
        v = 0x00040004u + (v << 3) + (is7 << 1);
    } else if (K == IQ3PS) {
        v = (v << 1) | 0x00010001u;
    } else if (K == IQ1P) {  // v = c - 1
        const uint32_t is0 = ((v | (v >> 1)) & 0x00010001u) ^ 0x00010001u;
        v = v + (is0 << 1) - 0x00010001u;
        sgn = is0 << 15;
    }
}

// A-fragment pairs of one row at step s: lo = h 0 (k 2c, 2c + 1), hi = h 1
// (k 2c + 8, 2c + 9)
template <int K>
__device__ __forceinline__ void row_step(const RowQ& o, int s, int c,
                                         uint32_t& lo, uint32_t& hi) {
    if (K == Q4K || K == Q5K) {
        const uint32_t p = pick2(o.r0, s);
        uint32_t v0 = p & 0x000F000Fu, v1 = (p >> 4) & 0x000F000Fu;
        if (K == Q5K) {
            const uint32_t b0 = (o.hb >> (2 * s)) & 3u;
            const uint32_t b1 = (o.hb >> (8 + 2 * s)) & 3u;
            v0 |= ((b0 & 1u) | ((b0 & 2u) << 15)) << 4;
            v1 |= ((b1 & 1u) | ((b1 & 2u) << 15)) << 4;
        }
        lo = wpair(v0, 0u, o.s0, o.n0);
        hi = wpair(v1, 0u, o.s1, o.n1);
    } else if (K == Q4KM) {  // bf16(s * (128 + 8 n)), rounded once
        const uint32_t p = pick2(o.r0, s);
        lo = bf16x2_mul(((p & 0x000F000Fu) << 3) | 0x43004300u, o.s0);
        hi = bf16x2_mul((((p >> 4) & 0x000F000Fu) << 3) | 0x43004300u, o.s1);
    } else if (K == Q6K) {
        const int nsh = 4 * (c >> 1);
        const uint32_t v0 = ((pick2(o.r0, s) >> nsh) & 0x000F000Fu)
                            | (((pick2(o.r2, s) >> (2 * c)) & 0x00030003u) << 4);
        const uint32_t v1 = ((pick2(o.r1, s) >> nsh) & 0x000F000Fu)
                            | (((pick2(o.r3, s) >> (2 * c)) & 0x00030003u) << 4);
        lo = wpair(v0, 0u, o.s0, o.n0);
        hi = wpair(v1, 0u, o.s1, o.n1);
    } else if (K == Q80) {
        lo = wpair_i8(pick2(o.r0, s), o.s0, o.n0);
        hi = wpair_i8(pick2(o.r1, s), o.s1, o.n1);
    } else if (K == Q4KI8) {
        lo = wpair(pick2(o.r0, s), 0u, o.s0, o.n0);
        hi = wpair(pick2(o.r1, s), 0u, o.s1, o.n1);
    } else {
        uint32_t v0 = (pick2(o.r0, s) >> (2 * c)) & 0x00030003u;
        uint32_t v1 = (pick2(o.r1, s) >> (2 * c)) & 0x00030003u;
        if (K == Q3K || K == IQ3PX || K == IQ3PS) {
            const uint32_t m = pick2(o.r2, s);
            v0 |= ((m >> c) & 0x00010001u) << 2;
            v1 |= ((m >> (4 + c)) & 0x00010001u) << 2;
        }
        uint32_t g0 = 0u, g1 = 0u;
        if (Kind<K>::SG) {
            const uint32_t m = pick2(o.r3, s);
            g0 = ((m >> c) & 0x00010001u) << 15;
            g1 = ((m >> (4 + c)) & 0x00010001u) << 15;
        }
        iq_mag<K>(v0, g0);
        iq_mag<K>(v1, g1);
        lo = wpair(v0, g0, o.s0, o.n0);
        hi = wpair(v1, g1, o.s1, o.n1);
    }
}

// the affine coefficient pair: -min, -32 * scale (q6_k), -4 * scale (q3_k)
template <int K>
__device__ __forceinline__ uint32_t coef2(uint32_t v) {
    if (Kind<K>::MIN) return v ^ 0x80008000u;
    const float m = K == Q6K ? -32.f : -4.f;
    const float f0 = __uint_as_float(v << 16), f1 = __uint_as_float(v & 0xFFFF0000u);
    return (uint32_t)__bfloat16_as_ushort(f2bf(f0 * m))
           | ((uint32_t)__bfloat16_as_ushort(f2bf(f1 * m)) << 16);
}

// A-fragment pairs of one row for affine step aa of a superblock: groups
// 16 aa + 2c (+1) and 16 aa + 2c + 8 (+1); zero past the superblock's
// 256 / grp groups
template <int K>
__device__ __forceinline__ void aff_pair(const uint8_t* sm, int grp, int aa,
                                         int c, uint32_t& lo, uint32_t& hi) {
    const int gps = 256 / grp;
    if (K == Q4KM) {  // k 0-7: -128 scale; k 8-15: -8 min (both exact)
        const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(sm);
        const __nv_bfloat16* mn = sc + gps;
        lo = pack_bf16(-128.f * bf2f(sc[2 * c]), -128.f * bf2f(sc[2 * c + 1]));
        hi = pack_bf16(-8.f * bf2f(mn[2 * c]), -8.f * bf2f(mn[2 * c + 1]));
        return;
    }
    const __nv_bfloat16* f = reinterpret_cast<const __nv_bfloat16*>(
        sm + (Kind<K>::MIN ? 512 / grp : 0));
    const int k0 = 16 * aa + 2 * c, k1 = k0 + 8;
    lo = k0 < gps ? coef2<K>(*reinterpret_cast<const uint32_t*>(f + k0)) : 0u;
    hi = k1 < gps ? coef2<K>(*reinterpret_cast<const uint32_t*>(f + k1)) : 0u;
}

// 16-byte copies of `per_row` bytes for each of `rows` rows: row r from
// src + r * stride to dst + r * dpitch; lg = log2(per_row / 16)
__device__ __forceinline__ void copy_rows(uint8_t* dst, int dpitch,
                                          const uint8_t* src, size_t stride,
                                          int rows, int lg, int tid,
                                          int nthr) {
    const int mask = (1 << lg) - 1;
    for (int idx = tid; idx < (rows << lg); idx += nthr) {
        const int r = idx >> lg, ch = idx & mask;
        cp_async16(dst + r * dpitch + 16 * ch, src + r * stride + 16 * ch);
    }
}

__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

// Superblock sb of weight rows m0 .. m0 + rows into shared memory: the code
// image (pitch IMG + 16) at img, then the small fields (pitch sbb), then
// (the affine kinds) the group sums of token blocks tb0 .. tb0 + nb, a
// 256-byte block each per affine step. All 16-byte cp.async, thread tid of
// nthr.
template <int K>
__device__ __forceinline__ void copy_superblock(const Args& a, uint8_t* img,
                                                int m0, int rows, int sb,
                                                int grp, int nb, int tb0,
                                                int tid, int nthr) {
    constexpr int IMG = Kind<K>::IMG, CPR = IMG / 16, IMP = IMG + 16;
    const int sc = 512 / grp, sbb = sbb_bytes<K>(grp);
    if (K == Q6K) {
        copy_rows(img, IMP, img_src<K>(a, m0, sb, 0), (size_t)a.in_f / 2, rows,
                  3, tid, nthr);
        copy_rows(img + 128, IMP, img_src<K>(a, m0, sb, 128),
                  (size_t)a.in_f / 4, rows, 2, tid, nthr);
    } else {
        for (int idx = tid; idx < rows * CPR; idx += nthr) {
            const int r = idx / CPR, ch = idx - r * CPR;
            cp_async16(img + r * IMP + 16 * ch, img_src<K>(a, m0 + r, sb, 16 * ch));
        }
    }
    uint8_t* fd = img + rows * IMP;
    const size_t g0 = (size_t)m0 * (a.in_f / grp) + (size_t)sb * (256 / grp);
    const int lgs = ilog2(sc / 16);
    copy_rows(fd, sbb, reinterpret_cast<const uint8_t*>(a.scale + g0),
              (size_t)a.in_f / grp * 2, rows, lgs, tid, nthr);
    int off = sc;
    if (Kind<K>::MIN) {
        copy_rows(fd + off, sbb, reinterpret_cast<const uint8_t*>(a.mn + g0),
                  (size_t)a.in_f / grp * 2, rows, lgs, tid, nthr);
        off += sc;
    }
    const size_t b0 = (size_t)m0 * (a.in_f / 8) + (size_t)sb * 32;
    if (Kind<K>::HM) {
        copy_rows(fd + off, sbb, a.w1 + b0, (size_t)a.in_f / 8, rows, 1, tid, nthr);
        off += 32;
    }
    if (Kind<K>::SG)
        copy_rows(fd + off, sbb, a.w2 + b0, (size_t)a.in_f / 8, rows, 1, tid, nthr);
    if (Kind<K>::AFF) {
        for (int idx = tid; idx < Kind<K>::NA * nb * 16; idx += nthr) {
            const int blk = idx >> 4, aa = blk / nb, b = blk - aa * nb, pp = idx & 15;
            if (tb0 + b < a.t8)
                cp_async16(fd + rows * sbb + blk * 256 + 16 * pp,
                           reinterpret_cast<const uint8_t*>(a.xs)
                           + ((size_t)(sb * Kind<K>::NA + aa) * a.t8 + tb0 + b) * 256
                           + 16 * pp);
        }
    }
}

// ---------------------------------------------------------------------------
// prep: x -> xp (columns permuted per superblock), and the group sums of
// width ga (0: none) as bf16 of sequential f32 sums, stored for each
// superblock, affine step aa and 8-token block as one 8 x 16 wgmma
// operand block: two core matrices (groups 0-7, 8-15) of 8 tokens x 16 B.
// Groups past the superblock's and tokens past T are zero; with dup
// (K3.q4_k_magic) k 8-15 repeat the sums of groups 0-7.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
kq_prep_kernel(const __nv_bfloat16* __restrict__ x,
               __nv_bfloat16* __restrict__ xp, __nv_bfloat16* __restrict__ xs,
               int T, int in_f, int ga, int na, int t8, bool dup) {
    __shared__ __align__(16) __nv_bfloat16 xt[8][264];
    const int tid = threadIdx.x, sb = blockIdx.x, tb = blockIdx.y;
    const int t = tid >> 5, ch = tid & 31, tok = tb * 8 + t;
    const size_t off = (size_t)tok * in_f + (size_t)sb * 256 + ch * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (tok < T) v = *reinterpret_cast<const uint4*>(x + off);
    *reinterpret_cast<uint4*>(&xt[t][ch * 8]) = v;
    __syncthreads();
    if (tok < T) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const uint32_t lo = __bfloat16_as_ushort(xt[t][perm_col(ch * 8 + 2 * e)]);
            const uint32_t hi = __bfloat16_as_ushort(xt[t][perm_col(ch * 8 + 2 * e + 1)]);
            w[e] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(xp + off) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    if (ga && tid < 128 * na) {
        const int gps = 256 / ga, n = tid & 7, k = tid >> 3;
        const int kg = dup && k >= gps ? k - gps : k;
        float s = 0.f;
        if (kg < gps && tb * 8 + n < T)
            for (int e = 0; e < ga; ++e) s += bf2f(xt[n][kg * ga + e]);
        const int aa = k >> 4, kk = k & 15;
        xs[((size_t)(sb * na + aa) * t8 + tb) * 128
           + ((kk >> 3) * 8 + n) * 8 + (kk & 7)] = f2bf(s);
    }
}

// ---------------------------------------------------------------------------
// (a) wgmma variant
// ---------------------------------------------------------------------------
// Shared memory of the wgmma variant, per K part (ks parts): a ring of 3
// quarter stages of x (BN x 128 B each, 1024-aligned) and 2 round slots,
// each the superblock's code image (rows x IMG at a pitch of IMG + 16),
// small fields (rows x sbb) and group sums; the epilogue reuses it for the
// other parts' partial tiles and the bf16 tile. One quarter is in flight
// while the next is computed: deeper rings measured no faster (the loop
// is bound by its own instruction latency, not by the copies), and the
// smaller footprint leaves room for more blocks on an SM.
constexpr int L_AHEAD = 1, L_STAGES = L_AHEAD + 2, L_ROUND_SLOTS = 2;

template <int K, int BN>
struct LSmem {
    int xsz, ssz, s, total;
    __host__ __device__ LSmem(int rows, int ks, int grp, int na) {
        xsz = BN * 128;
        ssz = rows * (Kind<K>::IMG + 16 + sbb_bytes<K>(grp))
              + (Kind<K>::AFF ? BN * 32 * na : 0);
        s = L_STAGES * ks * xsz;
        const int ring = s + L_ROUND_SLOTS * ks * ssz;
        const int red = (ks - 1) * rows * BN * 4;
        const int epi = BN * (rows + 8) * 2;
        total = ring > red ? ring : red;
        total = (total > epi ? total : epi) + 1024;  // + the 1024 alignment
    }
};

template <int K, int BN>
__global__ void __launch_bounds__(512)
kq_wgmma_kernel(const Args a, const int ks) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    // code images at a pitch of IMG + 16 bytes: a quad's 8-byte run loads
    // of eight rows then meet at most two to a bank
    constexpr int IMP = Kind<K>::IMG + 16;
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int rows = 64 * (nthr / 128 / ks);
    const int wg = tid >> 7, part = wg % ks, mw = wg / ks;
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, c = lane & 3;
    const int m0 = blockIdx.x * rows, n0 = blockIdx.y * BN;
    const int grp = Kind<K>::IQ ? a.grp : Kind<K>::GRP;
    const int nsb = a.in_f / 256, nr = nsb / ks;  // ks divides nsb
    const int sbb = sbb_bytes<K>(grp);
    const LSmem<K, BN> L(rows, ks, grp, a.na);
    uint8_t* const xr = smem;
    uint8_t* const sr = smem + L.s;

    // quarter q of round R (part p: superblock ks * R + p): x, swizzled
    auto load_x = [&](int R, int q) {
        const int slot = (4 * R + q) % L_STAGES;
        for (int p = 0; p < ks; ++p) {
            const int sb = ks * R + p;
            uint8_t* xd = xr + (slot * ks + p) * L.xsz;
            for (int idx = tid; idx < BN * 8; idx += nthr) {
                const int n = idx >> 3, j = idx & 7, t = n0 + n;
                if (t < a.T)
                    cp_async16(xd + n * 128 + ((j ^ (n & 7)) << 4),
                               a.xp + (size_t)t * a.in_f + sb * 256 + q * 64 + j * 8);
            }
        }
    };
    // round R: the code images, small fields and group sums
    auto load_round = [&](int R) {
        for (int p = 0; p < ks; ++p)
            copy_superblock<K>(a, sr + ((R % L_ROUND_SLOTS) * ks + p) * L.ssz, m0,
                               rows, ks * R + p, grp, BN / 8, n0 / 8, tid, nthr);
    };

    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;

    load_x(0, 0);
    load_round(0);
    cp_async_commit();
    for (int j = 1; j < L_AHEAD; ++j) {
        if (j / 4 < nr) {
            load_x(j / 4, j % 4);
            if (j % 4 == 0) load_round(j / 4);
        }
        cp_async_commit();
    }
    const int r0 = 64 * mw + 16 * warp + g;  // this thread's rows r0, r0 + 8
    uint32_t A[2][4][4];  // the A fragments of two quarters (4 steps each)
    for (int R = 0; R < nr; ++R) {
        const uint8_t* slot_s = sr + ((R % L_ROUND_SLOTS) * ks + part) * L.ssz;
        const uint8_t* fs = slot_s + rows * IMP;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            cp_async_wait<L_AHEAD - 1>();
            fence_proxy_async();
            __syncthreads();
            // L_AHEAD quarters ahead, into the x slot of the quarter two
            // before this one and (with quarter 0) the round slot of round
            // R - 1: every warpgroup retired their wgmmas (wait_group 1
            // after each quarter, 0 after each round) and reads (the
            // barrier)
            {
                const int Rn = R + (q + L_AHEAD) / 4, qn = (q + L_AHEAD) % 4;
                if (Rn < nr) {
                    load_x(Rn, qn);
                    if (qn == 0) load_round(Rn);
                }
            }
            cp_async_commit();
            // dequantize the quarter while the previous one's wgmmas run
            const RowQ o0 = load_row<K>(slot_s + r0 * IMP, fs + r0 * sbb, q, c, grp);
            const RowQ o1 = load_row<K>(slot_s + (r0 + 8) * IMP,
                                               fs + (r0 + 8) * sbb, q, c, grp);
            uint32_t (&Aq)[4][4] = A[q & 1];
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                row_step<K>(o0, s, c, Aq[s][0], Aq[s][2]);
                row_step<K>(o1, s, c, Aq[s][1], Aq[s][3]);
            }
            const uint32_t xb = smem_u32(xr + (((4 * R + q) % L_STAGES) * ks + part) * L.xsz);
            wgmma_fence();
#pragma unroll
            for (int s = 0; s < 4; ++s) wgmma_rs(acc, Aq[s], desc_sw128(xb + 32 * s));
            wgmma_commit();
            wgmma_wait<1>();
        }
        if (Kind<K>::AFF) {
            const uint32_t xsb = smem_u32(fs + rows * sbb);
#pragma unroll
            for (int aa = 0; aa < Kind<K>::NA; ++aa) {
                aff_pair<K>(fs + r0 * sbb, grp, aa, c, A[0][aa][0], A[0][aa][2]);
                aff_pair<K>(fs + (r0 + 8) * sbb, grp, aa, c, A[0][aa][1], A[0][aa][3]);
            }
            wgmma_fence();
#pragma unroll
            for (int aa = 0; aa < Kind<K>::NA; ++aa)
                wgmma_rs(acc, A[0][aa], desc_plain(xsb + aa * (BN / 8) * 256, 128, 256));
            wgmma_commit();
        }
        wgmma_wait<0>();
    }
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) pin(acc[j]);
    cp_async_wait_all();
    __syncthreads();

    // the K parts' partial tiles, added to part 0's in part order
    float* red = reinterpret_cast<float*>(smem);
    const int lt = tid & 127, nm = nthr / 128 / ks;
    if (part > 0)
        for (int j = 0; j < BN / 2; ++j)
            red[(((part - 1) * nm + mw) * (BN / 2) + j) * 128 + lt] = acc[j];
    __syncthreads();
    if (part == 0)
        for (int p = 1; p < ks; ++p)
#pragma unroll
            for (int j = 0; j < BN / 2; ++j)
                acc[j] += red[(((p - 1) * nm + mw) * (BN / 2) + j) * 128 + lt];
    __syncthreads();

    // epilogue: the (rows x BN) tile as bf16, token-major, then 16-byte rows
    __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
    const int ld = rows + 8;
    if (part == 0) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int n = 8 * j + 2 * c;
            ys[n * ld + r0] = f2bf(OUT_SCALE<K> * acc[4 * j + 0]);
            ys[(n + 1) * ld + r0] = f2bf(OUT_SCALE<K> * acc[4 * j + 1]);
            ys[n * ld + r0 + 8] = f2bf(OUT_SCALE<K> * acc[4 * j + 2]);
            ys[(n + 1) * ld + r0 + 8] = f2bf(OUT_SCALE<K> * acc[4 * j + 3]);
        }
    }
    __syncthreads();
    const int cpr = rows / 8;
    for (int idx = tid; idx < BN * cpr; idx += nthr) {
        const int n = idx / cpr, ch = idx % cpr, t = n0 + n;
        if (t < a.T)
            *reinterpret_cast<uint4*>(a.y + (size_t)t * a.out_f + m0 + 8 * ch) =
                *reinterpret_cast<const uint4*>(ys + n * ld + 8 * ch);
    }
}

// ---------------------------------------------------------------------------
// (b) swapped-operand variant, T <= 8
// ---------------------------------------------------------------------------
constexpr int S_STAGES = 4, S_AHEAD = 3, S_XROW = 528;  // 256 bf16 + 16 B

template <int K>
__host__ __device__ __forceinline__ int s_stage(int grp, int na) {
    return 8 * S_XROW + 16 * (Kind<K>::IMG + 16) + 16 * sbb_bytes<K>(grp)
           + (Kind<K>::AFF ? 256 * na : 0);
}

template <int K>
__global__ void __launch_bounds__(128)
kq_swap_kernel(const Args a) {
    extern __shared__ __align__(16) uint8_t smem[];
    constexpr int IMG = Kind<K>::IMG;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;
    const int m0 = blockIdx.x * 16;
    const int grp = Kind<K>::IQ ? a.grp : Kind<K>::GRP;
    const int nsb = a.in_f / 256, sbb = sbb_bytes<K>(grp);
    constexpr int IMP = IMG + 16;  // the code images' pitch, as in (a)
    const int XB = 8 * S_XROW, RB = 16 * IMP, SB = 16 * sbb;
    const int STG = s_stage<K>(grp, a.na);
    uint8_t* const base = smem + warp * S_STAGES * STG;
    const int nmine = nsb > warp ? (nsb - warp + 3) / 4 : 0;

    // this warp's k-th superblock (warp + 4k): x rows, code image, small
    // fields, group sums of token block 0
    auto load_stage = [&](int k) {
        if (k < nmine) {
            const int sb = warp + 4 * k;
            uint8_t* st = base + (k % S_STAGES) * STG;
            for (int idx = lane; idx < a.T * 32; idx += 32) {
                const int t = idx >> 5, j = idx & 31;
                cp_async16(st + t * S_XROW + 16 * j,
                           a.xp + (size_t)t * a.in_f + sb * 256 + 8 * j);
            }
            copy_superblock<K>(a, st + XB, m0, 16, sb, grp, 1, 0, lane, 32);
        }
        cp_async_commit();
    };

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < S_AHEAD; ++k) load_stage(k);
    for (int k = 0; k < nmine; ++k) {
        cp_async_wait<S_AHEAD - 1>();
        __syncwarp();
        load_stage(k + S_AHEAD);  // the slot of superblock k - 1, read and done
        const uint8_t* st = base + (k % S_STAGES) * STG;
        const uint8_t* img = st + XB;
        const uint8_t* sm = img + RB;
        for (int q = 0; q < 4; ++q) {
            const RowQ o0 = load_row<K>(img + g * IMP, sm + g * sbb, q, c, grp);
            const RowQ o1 = load_row<K>(img + (g + 8) * IMP,
                                               sm + (g + 8) * sbb, q, c, grp);
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                uint32_t A[4], B[2];
                row_step<K>(o0, s, c, A[0], A[2]);
                row_step<K>(o1, s, c, A[1], A[3]);
                const int kk = 16 * (4 * q + s) + 2 * c;
                B[0] = *reinterpret_cast<const uint32_t*>(st + g * S_XROW + 2 * kk);
                B[1] = *reinterpret_cast<const uint32_t*>(st + g * S_XROW + 2 * kk + 16);
                mma16816(acc, A, B);
            }
        }
        if (Kind<K>::AFF) {
            const uint8_t* xsb = sm + SB;
            for (int aa = 0; aa < a.na; ++aa) {
                uint32_t A[4], B[2];
                aff_pair<K>(sm + g * sbb, grp, aa, c, A[0], A[2]);
                aff_pair<K>(sm + (g + 8) * sbb, grp, aa, c, A[1], A[3]);
                B[0] = *reinterpret_cast<const uint32_t*>(xsb + aa * 256 + g * 16 + 4 * c);
                B[1] = *reinterpret_cast<const uint32_t*>(xsb + aa * 256 + (8 + g) * 16 + 4 * c);
                mma16816(acc, A, B);
            }
        }
        __syncwarp();
    }
    cp_async_wait_all();
    __syncthreads();
    // the four warps' partial tiles, summed in warp order
    float* red = reinterpret_cast<float*>(smem);
    red[(warp * 16 + g) * 8 + 2 * c] = acc[0];
    red[(warp * 16 + g) * 8 + 2 * c + 1] = acc[1];
    red[(warp * 16 + g + 8) * 8 + 2 * c] = acc[2];
    red[(warp * 16 + g + 8) * 8 + 2 * c + 1] = acc[3];
    __syncthreads();
    const int r = tid >> 3, t = tid & 7;
    if (t < a.T) {
        float v = red[r * 8 + t];
        v += red[(16 + r) * 8 + t];
        v += red[(32 + r) * 8 + t];
        v += red[(48 + r) * 8 + t];
        a.y[(size_t)t * a.out_f + m0 + r] = f2bf(OUT_SCALE<K> * v);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
constexpr int MAX_SMEM = 232448;  // the H100's per-block opt-in limit

// above 48 KB of dynamic shared memory a kernel must opt in, once
template <typename F>
static cudaError_t allow_smem(F* kernel, int bytes, bool& done) {
    if (bytes <= 48 * 1024 || done) return cudaSuccess;
    done = true;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                MAX_SMEM);
}

template <int K>
static cudaError_t launch(const Args& a, int variant, int rows, int tokens,
                          int split, int gx, int gy, cudaStream_t st) {
    static bool done_s = false, done_64 = false, done_128 = false;
    const int grp = Kind<K>::IQ ? a.grp : Kind<K>::GRP;
    const dim3 grid(gx, gy);
    cudaError_t e;
    if (variant == 0) {
        const int bytes = 4 * S_STAGES * s_stage<K>(grp, a.na);
        if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
        if ((e = allow_smem(kq_swap_kernel<K>, bytes, done_s)) != cudaSuccess) return e;
        kq_swap_kernel<K><<<grid, 128, bytes, st>>>(a);
        return cudaGetLastError();
    }
    const int threads = 2 * rows * split;
    if (tokens == 64) {
        const int bytes = LSmem<K, 64>(rows, split, grp, a.na).total;
        if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
        if ((e = allow_smem(kq_wgmma_kernel<K, 64>, bytes, done_64)) != cudaSuccess) return e;
        kq_wgmma_kernel<K, 64><<<grid, threads, bytes, st>>>(a, split);
    } else {
        const int bytes = LSmem<K, 128>(rows, split, grp, a.na).total;
        if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
        if ((e = allow_smem(kq_wgmma_kernel<K, 128>, bytes, done_128)) != cudaSuccess) return e;
        kq_wgmma_kernel<K, 128><<<grid, threads, bytes, st>>>(a, split);
    }
    return cudaGetLastError();
}

}  // namespace

// x (T, in_f) bf16; xp (T, in_f) bf16 scratch; xs bf16 scratch of
// (in_f/256) * na * ceil(T/8) * 128 elements for the kinds with an affine
// term (na = 2 for iq1p at G = 8, else 1), null otherwise. q4_k: w0=qs2,
// mn=min; q6_k: w0=ql, w1=qh; q5_k: w0=qs2, w1=qh (bit plane), mn=min;
// q8_0: w0=q; q2_k: w0=qs, mn=min; q3_k: w0=qs, w1=hmask; iq2p: w0=qs,
// w2=sg; iq3px / iq3ps: w0=qs, w1=hmask, w2=sg; iq1p: w0=qs, mn=min;
// q4_k_i8: w0=q (int8 codes), mn=min; kind 11 (K3.q4_k_magic): q4_k's.
// grp: the IQ kinds' scale group (8,
// 16 or 32; ignored by the other kinds). The plan (ops/quant_matmul.py
// `kq_plan`): variant 0 (swap: rows 16, tokens 8, split 4, T <= 8) or 1
// (wgmma: rows 64 or 128, tokens 64 or 128, split 1), grid (gx, gy) =
// (out_f / rows, ceil(T / tokens)). y (T, out_f) bf16. Every pointer
// 16-byte aligned, in_f % 256 == 0.
KCPP_API int k3_kq_matmul(int kind, const void* x, void* xp, void* xs,
                          const void* w0, const void* w1, const void* w2,
                          const void* scale, const void* mn, void* y, int T,
                          int out_f, int in_f, int grp, int variant, int rows,
                          int tokens, int split, int gx, int gy,
                          void* stream) {
    const bool iq = kind >= IQ2P && kind <= IQ1P;
    if (kind < 0 || kind > Q4KM || T < 1 || in_f <= 0 || in_f % 256
        || (iq && grp != 8 && grp != 16 && grp != 32))
        return (int)cudaErrorInvalidValue;
    if (variant == 0) {
        if (T > 8 || rows != 16 || tokens != 8 || split != 4) return (int)cudaErrorInvalidValue;
    } else if (variant == 1) {
        if ((rows != 64 && rows != 128) || (tokens != 64 && tokens != 128)
            || split < 1 || split > 4 || (in_f / 256) % split
            || 2 * rows * split > 512)
            return (int)cudaErrorInvalidValue;
    } else {
        return (int)cudaErrorInvalidValue;
    }
    if (out_f <= 0 || out_f % rows || gx != out_f / rows
        || gy != (T + tokens - 1) / tokens || gy > 65535)
        return (int)cudaErrorInvalidValue;
    const int ga = (kind == Q4K || kind == Q5K || kind == Q4KI8
                    || kind == Q4KM) ? 32
                 : (kind == Q6K || kind == Q2K || kind == Q3K) ? 16
                 : kind == IQ1P ? grp : 0;
    Args a;
    a.xp = (const __nv_bfloat16*)xp;
    a.xs = (const __nv_bfloat16*)xs;
    a.w0 = (const uint8_t*)w0;
    a.w1 = (const uint8_t*)w1;
    a.w2 = (const uint8_t*)w2;
    a.scale = (const __nv_bfloat16*)scale;
    a.mn = (const __nv_bfloat16*)mn;
    a.y = (__nv_bfloat16*)y;
    a.T = T;
    a.out_f = out_f;
    a.in_f = in_f;
    a.grp = iq ? grp : 0;
    a.na = kind == IQ1P ? 2 : ga ? 1 : 0;
    a.t8 = (T + 7) / 8;
    if (ga && xs == nullptr) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    kq_prep_kernel<<<dim3(in_f / 256, a.t8), 256, 0, st>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)xp, (__nv_bfloat16*)xs, T,
        in_f, ga, a.na, a.t8, kind == Q4KM);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    switch (kind) {
        case Q4K: return (int)launch<Q4K>(a, variant, rows, tokens, split, gx, gy, st);
        case Q6K: return (int)launch<Q6K>(a, variant, rows, tokens, split, gx, gy, st);
        case Q5K: return (int)launch<Q5K>(a, variant, rows, tokens, split, gx, gy, st);
        case Q80: return (int)launch<Q80>(a, variant, rows, tokens, split, gx, gy, st);
        case Q2K: return (int)launch<Q2K>(a, variant, rows, tokens, split, gx, gy, st);
        case Q3K: return (int)launch<Q3K>(a, variant, rows, tokens, split, gx, gy, st);
        case IQ2P: return (int)launch<IQ2P>(a, variant, rows, tokens, split, gx, gy, st);
        case IQ3PX: return (int)launch<IQ3PX>(a, variant, rows, tokens, split, gx, gy, st);
        case IQ3PS: return (int)launch<IQ3PS>(a, variant, rows, tokens, split, gx, gy, st);
        case IQ1P: return (int)launch<IQ1P>(a, variant, rows, tokens, split, gx, gy, st);
        case Q4KI8: return (int)launch<Q4KI8>(a, variant, rows, tokens, split, gx, gy, st);
        default: return (int)launch<Q4KM>(a, variant, rows, tokens, split, gx, gy, st);
    }
}
