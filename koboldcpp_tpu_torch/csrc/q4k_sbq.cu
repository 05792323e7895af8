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
// Bound on the H100: bytes. Each weight byte is read once for all T tokens:
// 0.5 B/weight of nibbles (q5_k 0.125 more of 5th bits), 1 B of sc and 2 B
// of bf16 min per 32 weights, 4 B of d per 256 (0.609 B/weight for q4_k).
// The first design (a warp per row, a separate prep launch and three
// scratch tensors, T-fold __dp4a and shuffle work per weight byte) ran
// 12-13x its bound. This one is K7's (csrc/q4k_matvec.cu), through the
// pieces they share (csrc/q4k_ring.cuh):
//   * one launch: every block of a persistent grid (`sbq_plan`) quantizes
//     x into shared memory itself, the two blocks of a cluster each half of
//     the 128-column segments, written into both (distributed shared
//     memory). Where T tokens' codes of every column do not fit a block
//     (a 70B-class w_down), x goes in windows of `kwin` K steps: at each
//     window's first K step the cluster quantizes that window's columns
//     anew, so a block holds at most a window of codes at any width. The
//     wrapper allocates only y;
//   * the two blocks of a cluster take tiles 2p and 2p + 1 of each pair of
//     tiles p their cluster walks, so both walk as many tiles (and windows);
//   * 16-row tiles of 8 superblocks of the codes, sc, d, min (and q5_k's
//     bit plane) stream through a cp.async ring of `stages` stages across
//     tile boundaries; sc and d rows are not 16-byte aligned, so they go
//     by 8- and 4-byte copies;
//   * the group dots on mma.sync m16n8k32 s8 (A = 16 rows x 32 codes, the
//     same ldmatrix fragments as K7's; B = 32 x codes of 8 tokens, a second
//     N tile sharing the A fragment for tokens 8-15), then the sub-scale
//     as an int32 multiply-add on the C fragment, C_seg += sc_g P_g,
//     exact; the f32 combine runs once per segment pair (superblock), a
//     quarter as often as K7's per-group one. The min term on mma.sync
//     m16n8k8 bf16 (exact products, f32 sums) once per superblock.
// Warp w of a block takes superblock w of each stage, so the 8 warps split
// K; a tile's partial sums (each warp's less its min term) meet in shared
// memory and are added in warp order. Every f32 product and sum is an
// explicit __fmaf_rn / __fmul_rn / __fadd_rn / __fsub_rn or an mma, in an
// order fixed by in_f alone (superblock, span, warp; x's windows do not
// move it, a thread's sums stay in its registers across them), and an mma
// column's sums do not depend on the other columns: a row of y depends on
// its token alone, bit for bit, at every T.
// Launch counters: ops/_build.launches["K14"] (q4_k), ["K14.q5_k"].
#include "common.cuh"
#include "q4k_ring.cuh"

constexpr int SBQ_SEG = 128;     // columns per activation scale
constexpr int SBQ_MAX_T = 16;    // two mma N tiles
constexpr int SBQ_TOKENS = 8;    // mma N
constexpr int SBQ_CLUSTER = 2;   // blocks that share one prep
constexpr int SBQ_SMEM_MAX = 232448;
// a tile's partial sums per token: the 8 warps' values of its 16 rows and
// 4 floats of padding (a warp's writes, 8 rows x 4 token pairs, fall on
// 32 banks)
constexpr int SBQ_PART_T = Q4R_KS * Q4R_RT + 4;
// a stage row of the factors: sc (8 B per superblock), d (4 B), min (16
// B), 16 B of padding (60 words: 8 rows fall on 8 bank groups)
constexpr int SBQ_SC = 0, SBQ_D = Q4R_KS * 8, SBQ_MIN = Q4R_KS * 12;
constexpr int SBQ_SIDE_PITCH = Q4R_KS * 28 + 16;

// Byte offsets of the dynamic shared memory, as `sbq_layout` computes them
// (ops/quant_matmul.py): `stages` ring stages (per stage: 16 rows of 8
// superblocks of codes, then per row the factors, then q5_k's bit plane),
// the x codes of a window of `cols` columns (per token cols + 64 bytes),
// the scales sx (per segment and token pair a float2), the group sums xs
// ([T][cols/32] bf16), and the tile's partial sums ([8 or 16 tokens][8
// warps][16 rows] f32).
struct SbqLayout {
    int qh_pitch, stage, xs_pitch, x_off, prep_off, sum_off, part_off, total;
};

__host__ __device__ inline SbqLayout sbq_layout(bool q5, int T, int cols,
                                                int stages) {
    SbqLayout L;
    L.qh_pitch = q5 ? Q4R_QH_PITCH : 0;
    L.stage = Q4R_RT * (Q4R_QS_PITCH + SBQ_SIDE_PITCH + L.qh_pitch);
    L.xs_pitch = cols + 64;  // consecutive tokens 64 B apart mod 128
    L.x_off = stages * L.stage;
    L.prep_off = L.x_off + T * L.xs_pitch;
    L.sum_off = L.prep_off + (cols / SBQ_SEG) * ((T + 1) / 2) * 8;
    L.part_off = L.sum_off + T * (cols / 32) * 2;
    L.total = L.part_off + (T > SBQ_TOKENS ? 2 : 1) * SBQ_TOKENS * SBQ_PART_T * 4;
    return L;
}

// NT: mma N tiles of 8 tokens (1: T <= 8, 2: 9 <= T <= 16), sharing each
// A fragment; q5_k's two-tile body needs more registers than two blocks
// an SM leave it. kwin: the K steps of x's window; WIN: kwin < the K
// steps (x in windows). x whole keeps a body without the window code: the
// one with it, run at kwin = K steps, took 5% more time at the 1.1B's
// shapes (its registers; bench_q4k.py, H100 80GB HBM3, 700 W).
template <bool Q5, int NT, bool WIN>
__global__ void __launch_bounds__(Q4R_THREADS, Q5 && NT == 2 ? 1 : 2)
sbq_kernel(const uint8_t* __restrict__ qs2,
           const uint8_t* __restrict__ qh,          // q5_k (out, in/8)
           const uint8_t* __restrict__ sc,          // (out, in/32)
           const float* __restrict__ dsb,           // (out, in/256)
           const __nv_bfloat16* __restrict__ mn,    // (out, in/32)
           const __nv_bfloat16* __restrict__ x,     // (T, in_f)
           __nv_bfloat16* __restrict__ y,           // (T, out_f)
           int T, int out_f, int in_f, int stages, int kwin) {
    extern __shared__ __align__(16) uint8_t smem[];
    const uint32_t rank = cluster_rank();
    const int nsb = in_f / 256, ng = in_f / 32, np = (T + 1) / 2;
    const int ksteps = (nsb + Q4R_KS - 1) / Q4R_KS;
    const int wcols = min(in_f, kwin * Q4R_KS * 256);  // x's window
    const SbqLayout L = sbq_layout(Q5, T, wcols, stages);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    // the cluster's walk: pairs of tiles pair, pair + pairs, ...; this
    // block takes tile 2 * (pair of tiles) + rank of each
    const int pair = (int)blockIdx.x / SBQ_CLUSTER;
    const int pairs = (int)gridDim.x / SBQ_CLUSTER;
    const int npair = out_f / (SBQ_CLUSTER * Q4R_RT);
    const int mine = pair < npair ? (npair - 1 - pair) / pairs + 1 : 0;
    const int total = mine * ksteps;  // (tile, K step) pairs of this block
    auto tile_row0 = [&](int it) {
        return (SBQ_CLUSTER * (pair + (it / ksteps) * pairs) + (int)rank) * Q4R_RT;
    };

    // activation prep, part 1 (Q4kPrep, q4k_ring.cuh): 16 lanes per (token,
    // segment) of the first window; its first loads go out before the
    // weight stream
    Q4kPrep<SBQ_SEG, SBQ_CLUSTER> px(x, T, in_f, rank);
    px.window(x, wcols);
    px.load(0, tid);
    cluster_arrive_relaxed();  // the peer writes here once started

    // one stage: rows [tile*16, +16) x superblocks [kstep*8, +8) of every
    // field (superblocks past in_f skipped)
    auto issue = [&](int it, int slot) {
        const int row0 = tile_row0(it);
        const int sb0 = (it % ksteps) * Q4R_KS;
        uint8_t* st = smem + slot * L.stage;
        q4k_copy_codes(st, qs2, in_f / 2, row0, sb0, nsb, tid);
        uint8_t* side = st + Q4R_RT * Q4R_QS_PITCH;
        {
            // sc (threads 0-127) and d (128-255): one (row, superblock) each
            const int c = tid & 127, r = c >> 3, s = c & 7;
            if (sb0 + s < nsb) {
                const size_t row = (size_t)(row0 + r);
                if (tid < 128)
                    cp_async8(side + r * SBQ_SIDE_PITCH + SBQ_SC + s * 8,
                              sc + row * ng + (size_t)(sb0 + s) * 8);
                else
                    cp_async4(side + r * SBQ_SIDE_PITCH + SBQ_D + s * 4,
                              dsb + row * nsb + sb0 + s);
            }
        }
        if (tid < Q4R_RT * Q4R_KS) {  // min: 16 B per (row, superblock)
            const int r = tid >> 3, s = tid & 7;
            if (sb0 + s < nsb)
                cp_async16(side + r * SBQ_SIDE_PITCH + SBQ_MIN + s * 16,
                           mn + (size_t)(row0 + r) * ng + (size_t)(sb0 + s) * 8);
        }
        if (Q5)
            q4k_copy_qh(side + Q4R_RT * SBQ_SIDE_PITCH, qh, in_f / 8, row0, sb0,
                        nsb, tid);
    };
    for (int s = 0; s < stages - 1; ++s) {
        if (s < total) issue(s, s);
        cp_async_commit();
    }

    // activation prep, part 2, while the first stages arrive: the codes in
    // B-fragment order, sx per segment and token pair, xs per token and
    // group, in both blocks of the cluster
    uint8_t* xi = smem + L.x_off;
    float* prep = reinterpret_cast<float*>(smem + L.prep_off);
    __nv_bfloat16* xsum = reinterpret_cast<__nv_bfloat16*>(smem + L.sum_off);
    cluster_wait();
    px.run(xi, L.xs_pitch, prep, xsum, tid);
    cluster_arrive();  // both blocks' codes, scales and sums in place
    cluster_wait();
    int wsb0 = 0, wng = wcols / 32;  // the window's first superblock, groups

    // body: this thread's C rows gid, gid + 8 and tokens 8n + 2 tig, 8n +
    // 2 tig + 1 of N tile n (acc[n][2 * rowsel + token]); accm: the min
    // term's mma fragment, the same layout
    float acc[NT][4], accm[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = accm[n][e] = 0.f;
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row
    int slot = 0;
    for (int it = 0; it < total; ++it) {
        const int ks = it % ksteps;
        if (WIN && it > 0 && ks % kwin == 0) {
            // the next window (at a new tile the first again): once both
            // blocks are done with the last one, quantize it as above
            wsb0 = ks * Q4R_KS;
            const int cols = min(wcols, in_f - wsb0 * 256);
            wng = cols / 32;
            Q4kPrep<SBQ_SEG, SBQ_CLUSTER> pw(x, T, in_f, rank);
            pw.window(x + wsb0 * 256, cols);
            pw.load(0, tid);
            cluster_arrive();
            cluster_wait();
            pw.run(xi, L.xs_pitch, prep, xsum, tid);
            cluster_arrive();
            cluster_wait();
        }
        cp_async_wait_n(stages - 2);
        __syncthreads();
        if (it + stages - 1 < total)
            issue(it + stages - 1, slot == 0 ? stages - 1 : slot - 1);
        cp_async_commit();
        const int sb = ks * Q4R_KS + warp;
        if (sb < nsb) {
            const int sw = sb - wsb0;  // in the window
            const uint8_t* st = smem + slot * L.stage;
            const uint8_t* side = st + Q4R_RT * Q4R_QS_PITCH;
            const uint8_t* f0 = side + gid * SBQ_SIDE_PITCH;        // row gid
            const uint8_t* f8 = side + (gid + 8) * SBQ_SIDE_PITCH;  // gid + 8
            // the 8 groups' sub-scales (group g in byte g % 4 of word g / 4)
            const uint2 s0 = *reinterpret_cast<const uint2*>(f0 + SBQ_SC + warp * 8);
            const uint2 s8 = *reinterpret_cast<const uint2*>(f8 + SBQ_SC + warp * 8);
            {
                // the min term of the superblock's 8 groups on the tensor
                // cores: accm (16 rows x 8 tokens) += m (bf16) . xs (bf16),
                // products exact in f32
                const int mo = SBQ_MIN + warp * 16 + 4 * tig;
                const uint32_t m0 = *reinterpret_cast<const uint32_t*>(f0 + mo);
                const uint32_t m1 = *reinterpret_cast<const uint32_t*>(f8 + mo);
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    const int tok = 8 * n + gid;
                    uint32_t xs2 = 0u;
                    if (tok < T)
                        xs2 = *reinterpret_cast<const uint32_t*>(
                            xsum + tok * wng + sw * 8 + 2 * tig);
                    mma1688(accm[n], m0, m1, xs2);
                }
            }
            uint4 h[4];  // q5_k: rows gid, gid+8, words 0-3 / 4-7
            if (Q5) q4k_load_qh(h, side + Q4R_RT * SBQ_SIDE_PITCH + warp * 32, gid);
            const uint8_t* arow = st + lrow * Q4R_QS_PITCH + warp * 128;
            const uint8_t* xrow = xi + gid * L.xs_pitch + sw * 256 + tig * 16;
            // the segments' exact sums: cl (low plane, groups 0-3) and chh
            // (high plane, groups 4-7), C-fragment layout
            int cl[NT][4], chh[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) cl[n][e] = chh[n][e] = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                uint32_t alo[4], ahi[4];
                q4k_codes<Q5>(arow, lane, lrow, tig, k, h, alo, ahi);
                // group k's and group k + 4's sub-scales of rows gid, gid+8
                const int sl0 = (s0.x >> (8 * k)) & 0xFF, sl8 = (s8.x >> (8 * k)) & 0xFF;
                const int sh0 = (s0.y >> (8 * k)) & 0xFF, sh8 = (s8.y >> (8 * k)) & 0xFF;
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    uint4 xb = make_uint4(0u, 0u, 0u, 0u);
                    if (8 * n + gid < T)
                        xb = *reinterpret_cast<const uint4*>(
                            xrow + 8 * n * L.xs_pitch + k * 64);
                    int plo[4], phi[4];
                    mma16832_s8(plo, alo, xb.x, xb.y);
                    mma16832_s8(phi, ahi, xb.z, xb.w);
                    cl[n][0] += sl0 * plo[0];
                    cl[n][1] += sl0 * plo[1];
                    cl[n][2] += sl8 * plo[2];
                    cl[n][3] += sl8 * plo[3];
                    chh[n][0] += sh0 * phi[0];
                    chh[n][1] += sh0 * phi[1];
                    chh[n][2] += sh8 * phi[2];
                    chh[n][3] += sh8 * phi[3];
                }
            }
            // the superblock's combine: acc += d (P_lo sx_lo + P_hi sx_hi)
            const float d0 = *reinterpret_cast<const float*>(f0 + SBQ_D + warp * 4);
            const float d8 = *reinterpret_cast<const float*>(f8 + SBQ_D + warp * 4);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int tp = 4 * n + tig;  // token pair
                float2 ql = make_float2(0.f, 0.f), qh2 = ql;
                if (tp < np) {
                    ql = *reinterpret_cast<const float2*>(
                        prep + ((size_t)(2 * sw) * np + tp) * 2);
                    qh2 = *reinterpret_cast<const float2*>(
                        prep + ((size_t)(2 * sw + 1) * np + tp) * 2);
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float sxl = e & 1 ? ql.y : ql.x;
                    const float sxh = e & 1 ? qh2.y : qh2.x;
                    const float va = __fadd_rn(__fmul_rn((float)cl[n][e], sxl),
                                               __fmul_rn((float)chh[n][e], sxh));
                    acc[n][e] = __fmaf_rn(va, e & 2 ? d8 : d0, acc[n][e]);
                }
            }
        }
        if (ks == ksteps - 1) {
            // the tile's 8 K parts (each warp's sums less its min term) meet
            // in shared memory; one thread per (row, token) adds them in
            // warp order
            float* part = reinterpret_cast<float*>(smem + L.part_off);
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    part[(8 * n + 2 * tig + (e & 1)) * SBQ_PART_T
                         + warp * Q4R_RT + gid + 8 * (e >> 1)] =
                        __fsub_rn(acc[n][e], accm[n][e]);
                    acc[n][e] = accm[n][e] = 0.f;
                }
            __syncthreads();
            if (tid < Q4R_RT * T) {
                const int t = tid / Q4R_RT, r = tid % Q4R_RT;
                const float* pt = part + t * SBQ_PART_T + r;
                float sa = pt[0];
#pragma unroll
                for (int w = 1; w < Q4R_KS; ++w) sa = __fadd_rn(sa, pt[w * Q4R_RT]);
                y[(size_t)t * out_f + tile_row0(it) + r] = f2bf(sa);
            }
        }
        slot = slot + 1 == stages ? 0 : slot + 1;
    }
    cp_async_wait<0>();
}

template <bool Q5, int NT, bool WIN>
static cudaError_t launch_sbq(const void* qs2, const void* qh, const void* sc,
                              const void* dsb, const void* mn, const void* x,
                              void* y, int T, int out_f, int in_f, int grid,
                              int stages, int kwin, int smem, cudaStream_t st) {
    static bool ready = false;  // the opt-in above 48 KB, once per body
    if (!ready) {
        cudaError_t e = cudaFuncSetAttribute(
            sbq_kernel<Q5, NT, WIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            SBQ_SMEM_MAX);
        if (e != cudaSuccess) return e;
        ready = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(Q4R_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = SBQ_CLUSTER;  // pairs share the prep
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, sbq_kernel<Q5, NT, WIN>, (const uint8_t*)qs2, (const uint8_t*)qh,
        (const uint8_t*)sc, (const float*)dsb, (const __nv_bfloat16*)mn,
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, T, out_f, in_f, stages,
        kwin);
    return e != cudaSuccess ? e : cudaGetLastError();
}

// One K14 matvec; qh is the q5_k bit plane, or null for q4_k. grid,
// stages, kwin and smem come from `sbq_plan`; a plan whose shared memory
// differs from this source's layout is refused.
KCPP_API int k14_sbq(const void* qs2, const void* qh, const void* sc,
                     const void* dsb, const void* mn, const void* x, void* y,
                     int T, int out_f, int in_f, int grid, int stages,
                     int kwin, int smem, void* stream) {
    const int ksteps = (in_f / 256 + Q4R_KS - 1) / Q4R_KS;
    if (T < 2 || T > SBQ_MAX_T || in_f <= 0 || in_f % 256 || out_f <= 0
        || out_f % (SBQ_CLUSTER * Q4R_RT) || grid < SBQ_CLUSTER
        || grid > out_f / Q4R_RT || grid % SBQ_CLUSTER || stages < 3
        || stages > 4 || kwin < 1 || kwin > ksteps)
        return (int)cudaErrorInvalidValue;
    // the prep's float reciprocal is exact below 2^13 (token, group) tasks
    const int wcols = min(in_f, kwin * Q4R_KS * 256);
    if (T * (wcols / 32) >= 8192 || smem > SBQ_SMEM_MAX
        || smem != sbq_layout(qh != nullptr, T, wcols, stages).total)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define SBQ_ARGS qs2, qh, sc, dsb, mn, x, y, T, out_f, in_f, grid, stages, kwin, smem, st
    cudaError_t err;
    const bool two = T > SBQ_TOKENS, win = kwin < ksteps;
    if (qh)
        err = two ? (win ? launch_sbq<true, 2, true>(SBQ_ARGS)
                         : launch_sbq<true, 2, false>(SBQ_ARGS))
                  : (win ? launch_sbq<true, 1, true>(SBQ_ARGS)
                         : launch_sbq<true, 1, false>(SBQ_ARGS));
    else
        err = two ? (win ? launch_sbq<false, 2, true>(SBQ_ARGS)
                         : launch_sbq<false, 2, false>(SBQ_ARGS))
                  : (win ? launch_sbq<false, 1, true>(SBQ_ARGS)
                         : launch_sbq<false, 1, false>(SBQ_ARGS));
#undef SBQ_ARGS
    return (int)err;
}
