// The pieces of the q4_k / q5_k tensor-core matvecs that K1 / K7 / K17a
// (csrc/q4k_matvec.cu), K14 (csrc/q4k_sbq.cu) and K15a (csrc/ffn_fused.cu)
// share: the cp.async copies of a ring stage's codes, bit plane and bf16
// scales / mins, the A fragments of one 32-byte span of codes, and the
// activation prep that quantizes x into shared memory in B-fragment order.
//
// A stage holds 16 rows (one mma M) x 8 superblocks (one per warp of the
// 256-thread block). Codes: per row 8 x 128 bytes of the packed `qs2`
// layout (byte j of a superblock holds column j in its low nibble and j +
// 128 in its high one), 16-byte chunks swizzled by row (chunk ch of row r
// at ch ^ (r & 7)), so that an ldmatrix of 8 rows hits 8 bank groups.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

constexpr int Q4R_THREADS = 256;  // 8 warps
constexpr int Q4R_KS = 8;         // superblocks per stage: one per warp
constexpr int Q4R_RT = 16;        // rows per tile: one mma M
constexpr int Q4R_QS_PITCH = Q4R_KS * 128;  // code bytes per stage row
// a stage row of bf16 scale and min: 8 superblocks x 16 B each, 16 B pad
constexpr int Q4R_SM_PITCH = 2 * Q4R_KS * 16 + 16;
constexpr int Q4R_QH_PITCH = Q4R_KS * 32 + 16;  // q5_k's bit plane

// rows [row0, +16) x superblocks [sb0, +8) of the codes (superblocks past
// nsb skipped); qs_row: bytes per weight row (in_f / 2)
__device__ __forceinline__ void q4k_copy_codes(uint8_t* st,
                                               const uint8_t* qs2,
                                               size_t qs_row, int row0,
                                               int sb0, int nsb, int tid) {
    for (int c = tid; c < Q4R_RT * Q4R_KS * 8; c += Q4R_THREADS) {
        const int r = c / (Q4R_KS * 8), s = (c / 8) % Q4R_KS, ch = c % 8;
        if (sb0 + s < nsb)
            cp_async16(st + r * Q4R_QS_PITCH + s * 128 + ((ch ^ (r & 7)) << 4),
                       qs2 + (size_t)(row0 + r) * qs_row + (size_t)(sb0 + s) * 128
                           + ch * 16);
    }
}

// the same rows' bf16 scales, then mins, per superblock 16 bytes (8
// groups); ng: groups per weight row
__device__ __forceinline__ void q4k_copy_scale_min(
        uint8_t* sc, const __nv_bfloat16* scale, const __nv_bfloat16* mn,
        size_t ng, int row0, int sb0, int nsb, int tid) {
    for (int c = tid; c < Q4R_RT * 2 * Q4R_KS; c += Q4R_THREADS) {
        const int r = c / (2 * Q4R_KS), f = (c / Q4R_KS) % 2, s = c % Q4R_KS;
        if (sb0 + s < nsb)
            cp_async16(sc + r * Q4R_SM_PITCH + f * Q4R_KS * 16 + s * 16,
                       (f ? mn : scale) + (size_t)(row0 + r) * ng
                           + (size_t)(sb0 + s) * 8);
    }
}

// the same rows' q5_k bit plane (32 bytes per superblock row)
__device__ __forceinline__ void q4k_copy_qh(uint8_t* hb, const uint8_t* qh,
                                            size_t qh_row, int row0, int sb0,
                                            int nsb, int tid) {
    for (int c = tid; c < Q4R_RT * Q4R_KS * 2; c += Q4R_THREADS) {
        const int r = c / (Q4R_KS * 2), s = (c / 2) % Q4R_KS, h = c % 2;
        if (sb0 + s < nsb)
            cp_async16(hb + r * Q4R_QH_PITCH + s * 32 + h * 16,
                       qh + (size_t)(row0 + r) * qh_row + (size_t)(sb0 + s) * 32
                           + h * 16);
    }
}

// q5_k: the bit-plane words of this lane's rows gid, gid + 8 of the
// superblock at hb (its 32 bytes in the stage): h[0..1] row gid, h[2..3]
// row gid + 8
__device__ __forceinline__ void q4k_load_qh(uint4 (&h)[4], const uint8_t* hb,
                                            int gid) {
    h[0] = *reinterpret_cast<const uint4*>(hb + gid * Q4R_QH_PITCH);
    h[1] = *reinterpret_cast<const uint4*>(hb + gid * Q4R_QH_PITCH + 16);
    h[2] = *reinterpret_cast<const uint4*>(hb + (gid + 8) * Q4R_QH_PITCH);
    h[3] = *reinterpret_cast<const uint4*>(hb + (gid + 8) * Q4R_QH_PITCH + 16);
}

// The code words of span k (0..3) of a superblock's 16 rows (arow: this
// lane's ldmatrix row, lrow, in the stage, at the superblock): one
// ldmatrix.x4 gives register e row gid (e even) or gid + 8, bytes 4 tig..
// +3 (+16 for e >= 2); the low nibbles are 32-column group k, the high
// ones group k + 4. q5_k ORs in the 5th bits (h from q4k_load_qh; word k
// of a row's plane holds group k's bits, word 4 + k group k + 4's). As
// mma.sync m16n8k32 s8 A fragments: alo of group k, ahi of group k + 4.
template <bool Q5>
__device__ __forceinline__ void q4k_codes(const uint8_t* arow, int lane,
                                          int lrow, int tig, int k,
                                          const uint4 (&h)[4],
                                          uint32_t (&alo)[4],
                                          uint32_t (&ahi)[4]) {
    uint32_t a[4];
    ldmatrix_x4(a, arow + (((2 * k + (lane >> 4)) ^ (lrow & 7)) << 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        alo[e] = a[e] & 0x0F0F0F0Fu;
        ahi[e] = (a[e] >> 4) & 0x0F0F0F0Fu;
    }
    if (Q5) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int sh = (e & 2 ? 16 : 0) + 4 * tig;
            alo[e] |= spread4(u4_at(h[(e & 1) * 2], k) >> sh) << 4;
            ahi[e] |= spread4(u4_at(h[(e & 1) * 2 + 1], k) >> sh) << 4;
        }
    }
}

// Activation prep: x (T, in_f) bf16 (or a window of its columns, `window`)
// quantized per token and scale group of G columns (32: K1 / K7, 128: K14)
// to int8 codes rint(x * (127 / amax)) (amax clamped at 1e-20), into shared
// memory:
//   xi: per token a row of in_f (the window's columns) + 64 bytes, the codes in B-fragment order
//       (per superblock 256 bytes: span k, lane tig, then group k's columns
//       4tig..+3 and 16+4tig..+3, then group k+4's; columns 8j..8j+3 of a
//       group are lane 2(j&1)'s, 8j+4.. the next lane's), so that one
//       16-byte load gives a lane its B words of both groups of a span;
//   prep: the scale amax / 127 per scale group and token pair (float2);
//   xsum: the bf16-rounded f32 sums of x per token and 32 columns.
// 4 lanes per (token, 32-column group), 8 columns (one 16-byte load) each,
// 8 loads a thread in flight (16 cost the body registers); the CL blocks
// of a cluster take every CL-th scale group and write what they compute
// into every block of the cluster (distributed shared memory). A padding
// token (odd T) gets no entry: its B column is zero and its sums are never
// stored. load(0) goes out before the weight stream, so that the first x
// loads do not queue behind it.
template <int G, int CL>
struct Q4kPrep {
    static constexpr int U = 8;
    static constexpr int GS = G / 32;     // 32-column groups per scale
    static constexpr int LANES = 4 * GS;  // lanes per scale group
    const __nv_bfloat16* x;
    int T, in_f, ng, np, ntask;
    uint32_t rank;
    float inv_ng;
    uint4 raw[U];

    __device__ __forceinline__ Q4kPrep(const __nv_bfloat16* x_, int T_,
                                       int in_f_, uint32_t rank_)
        : x(x_), T(T_), in_f(in_f_), ng(in_f_ / 32), np((T_ + 1) / 2),
          ntask(T_ * (in_f_ / 32) * 4 / CL), rank(rank_),
          inv_ng(1.0f / (float)(in_f_ / 32)) {}

    // a window of x: columns [0, cols) of the rows at xw (row pitch in_f),
    // indexed from there (K14 where T tokens' codes of every column do not
    // fit a block); T * cols / 32 < 2^13
    __device__ __forceinline__ void window(const __nv_bfloat16* xw, int cols) {
        x = xw;
        ng = cols / 32;
        ntask = T * ng * 4 / CL;
        inv_ng = 1.0f / (float)ng;
    }

    // (token, group) of task li; li & 3 is its lane in the group. q / ng
    // by a float reciprocal: exact, as q < 2^13 and q + 0.5 lies at least
    // 0.5 / ng from a multiple of ng
    __device__ __forceinline__ void task(int li, int& t, int& g) const {
        const int q = ((li / LANES) * CL + (int)rank) * GS + ((li >> 2) & (GS - 1));
        t = (int)(((float)q + 0.5f) * inv_ng);
        g = q - t * ng;
    }

    __device__ __forceinline__ void load(int base, int tid) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int li = base + u * Q4R_THREADS + tid;
            int t, g;
            task(li, t, g);
            raw[u] = make_uint4(0u, 0u, 0u, 0u);
            if (li < ntask)
                raw[u] = *reinterpret_cast<const uint4*>(
                    x + (size_t)t * in_f + g * 32 + 8 * (li & 3));
        }
    }

    __device__ __forceinline__ void run(uint8_t* xi, int xs_pitch,
                                        float* prep,
                                        __nv_bfloat16* xsum, int tid) {
        const uint32_t peer = rank ^ 1u;
        for (int base = 0; base < ntask; base += U * Q4R_THREADS) {
            if (base) load(base, tid);
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (base + u * Q4R_THREADS >= ntask) break;  // the same for all
                const int li = base + u * Q4R_THREADS + tid;
                const int j = li & 3;
                int t, g;
                task(li, t, g);
                const uint32_t w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
                float v[8];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    v[2 * e] = __uint_as_float(w[e] << 16);
                    v[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
                }
                float sm = v[0], a = fabsf(v[0]);
#pragma unroll
                for (int e = 1; e < 8; ++e) {
                    sm = __fadd_rn(sm, v[e]);
                    a = fmaxf(a, fabsf(v[e]));
                }
                sm = group_sum(sm, 4);  // every lane of the warp takes part
                a = fmaxf(group_max(a, LANES), 1e-20f);
                if (li < ntask) {
                    const float inv = 127.0f / a;
                    int c[8];  // rint(x * (127 / amax)), |c| <= 127
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        c[e] = __float2int_rn(__fmul_rn(v[e], inv));
                    const uint32_t q0 =
                        __byte_perm(__byte_perm(c[0], c[1], 0x0040),
                                    __byte_perm(c[2], c[3], 0x0040), 0x5410);
                    const uint32_t q1 =
                        __byte_perm(__byte_perm(c[4], c[5], 0x0040),
                                    __byte_perm(c[6], c[7], 0x0040), 0x5410);
                    const int gg = g & 7;
                    uint8_t* dst = xi + t * xs_pitch + (g >> 3) * 256
                                   + (gg & 3) * 64 + 2 * (j & 1) * 16
                                   + (gg >> 2) * 8 + (j >> 1) * 4;
                    *reinterpret_cast<uint32_t*>(dst) = q0;
                    *reinterpret_cast<uint32_t*>(dst + 16) = q1;
                    if (CL > 1) {
                        st_cluster(peer_smem(dst, peer), q0);
                        st_cluster(peer_smem(dst + 16, peer), q1);
                    }
                    if (j == 0) {
                        const __nv_bfloat16 xs = f2bf(sm);
                        xsum[t * ng + g] = xs;
                        if (CL > 1)
                            st_cluster(peer_smem(xsum + t * ng + g, peer),
                                       __bfloat16_as_ushort(xs));
                        if ((g & (GS - 1)) == 0) {
                            float* ps = prep + ((size_t)(g / GS) * np + (t >> 1)) * 2
                                        + (t & 1);
                            *ps = a / 127.0f;
                            if (CL > 1)
                                st_cluster(peer_smem(ps, peer),
                                           __float_as_uint(*ps));
                        }
                    }
                }
            }
        }
    }
};
