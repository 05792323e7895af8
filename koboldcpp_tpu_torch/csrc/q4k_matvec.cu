// K1: q4_k / q5_k T=1 matvec and K7: q4_k / q5_k 2<=T<=8 batched matvec,
// y (T, out_f) bf16 = x (T, in_f) . W^T.
//
// K1 replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec_q4k` at T=1:
// bodies `_q4k_decode_kernel_i8` / `_q5k_decode_kernel_i8` (in_f >= 512)
// and `_q4k_decode_kernel` / `_q5k_decode_kernel` (bf16 activations, in_f <
// 512). K7 replaces the same function at 2 <= T <= 8: bodies
// `_q4k_decode_kernel_i8_t` / `_q5k_decode_kernel_i8_t` (with
// `_i8_prep_t`) and the bf16 decode kernels over per-token stacks (T <= 4).
// K17a (T=1 over layer li of layer-stacked fields, the scan decode path)
// replaces `_packed_matvec_q4k_stacked`, which runs the same bodies through
// `_stacked_kernel` / `_SqView`: it is K1 with every weight pointer moved
// to layer li, read by each block from device memory (Stacked,
// common.cuh), so it gives K1's result on that layer bit for bit.
//
// The code of a weight is its nibble (q4_k, 0..15) or its nibble ORed with
// its 5th bit from the qh bit plane (q5_k, 0..31); w = code * s - m. In the
// packed `qs2` layout byte j of a 256-column superblock holds column j in
// its low nibble and column j + 128 in its high one, so the 32-byte span k
// (k = 0..3) holds 32-column group k in its low nibbles and group k + 4 in
// its high ones.
//
// The int8-activation bodies (every main-path shape: in_f >= 512 and
// T * (in_f/64) * (in_f/2) <= 4 Mi, `_q45_i8`): x is quantized per token
// and 32-column group to int8 codes rint(x * (127 / amax)) (amax clamped
// at 1e-20; scale sx = amax / 127; group sum xs = bf16 of the f32 sum), the
// group dot P with the codes is an exact int32, and
// y = sum_g P_g sx_g s_g - sum_g m_g xs_g (`_i8_combine`).
//
// Bound on the H100: bytes. Each weight byte is read once, whatever T is:
// q4_k 0.5 B/weight, q5_k 0.625, plus 4 B of bf16 scale and min per 32
// weights; the 1.1B's head (41 MB) takes 12.2 us and w_gateup (14.4 MB)
// 4.3 us at 3.35 TB/s. The first design (a warp per row, 16 B per lane in
// two dependent steps, a separate activation-prep launch, T-fold __dp4a
// work in K7) ran 2.4-10x its bound. This one:
//   * preps its own activations, in the same launch: every block of a
//     persistent grid (`q4k_plan`: about two blocks per SM, so the
//     redundant prep stays small against the weight bytes) holds x (T x
//     in_f) quantized in shared memory, permuted so that one 16-byte load
//     gives a thread its mma B fragments of two groups. At T >= 2 the two
//     blocks of a cluster each quantize half the groups and store them in
//     both blocks (distributed shared memory). The first x loads go out
//     before the weight stream, so they do not queue behind it. The
//     wrapper allocates only y;
//   * streams 16-row tiles of the packed codes, scales, mins (and q5_k's
//     bit plane) through a 4-stage cp.async ring, 8 superblocks of 16 rows
//     (20-25 KB) per stage, three stages in flight while one is consumed,
//     across tile boundaries (1-D bulk copies with mbarriers, one per
//     row and field, were tried and ran slower);
//   * takes the group dots on the tensor cores: mma.sync m16n8k32 s8 x s8 ->
//     s32, A = 16 rows x 32 codes (one ldmatrix.x4 of a span gives both
//     groups' A by one mask and one shift; q5_k ORs in its 5th bits), B =
//     32 x codes x 8 tokens (zero columns past T), C = the exact P; the min
//     term sum_g m xs on mma.sync m16n8k8 bf16 (exact products, f32 sums)
//     once per superblock. Warp w of a block takes superblock w of each
//     stage, so the 8 warps split K; a tile's partial sums meet in shared
//     memory and are added in warp order;
//   * at T = 1 fills every B column with token 0, so each lane's fragment
//     holds useful P and a lane combines one row: a quarter of the general
//     body's f32 work per group;
//   * at T = 1, where x's codes do not fit a block next to the ring (in_f
//     beyond ~107K for q4_k, ~94K for q5_k), holds x in windows of `kwin`
//     K steps (`q4k_plan`): at a window's first K step of every tile the
//     block preps that window anew (a template flag: the body for x whole
//     has no window code). A group's codes, scale and sum are the same
//     values in a window and whole, and the partial sums stay in
//     registers across windows, so the result is the same bits.
// Every product and sum is an explicit __fmaf_rn / __fmul_rn / __fadd_rn
// or an mma, in an order fixed by the superblock and group alone: a (row,
// token) goes through the same operations whatever T is and whichever mma
// column holds it, so row t of K7 equals K1 on x[t] bit for bit, and a
// request served in a batch gets the tokens it gets alone.
//
// The bf16-activation bodies (in_f < 512, the fixtures; KCPP_Q4K_I8=0 at
// T <= KCPP_MATVEC_MAX_T, default 4) keep the first design: a group-sum
// prep launch (group_sums_kernel), then one warp per output row with the
// exact f32 dots of bf16 x and the codes; past 8 tokens (a cap above 8)
// each block row of the grid takes 8 tokens, each token's sums as alone.
// Launch counters: ops/_build.launches["K1"] and ["K7"] (q4_k),
// ["K1.q5_k"] and ["K7.q5_k"] (q5_k), ["K17a"] and ["K17a.q5_k"]
// (stacked), one per matvec.
#include "common.cuh"
#include "q4k_ring.cuh"

// ---------------------------------------------------------------------------
// int8-activation bodies
// ---------------------------------------------------------------------------

constexpr int I8_THREADS = Q4R_THREADS;  // 8 warps
constexpr int I8_KS = Q4R_KS;            // superblocks per stage: one per warp
constexpr int I8_RT = Q4R_RT;            // rows per tile: one mma M
constexpr int I8_STAGES = 4;
constexpr int I8_TOKENS = 8;     // mma N
constexpr int I8_SMEM_MAX = 232448;
constexpr int I8_CLUSTER = 2;    // blocks that share one prep at T >= 2
// a tile's partial sums per token: the 8 warps' values of its 16 rows and
// 4 floats of padding, so that a warp's writes (8 rows x 4 token pairs)
// fall on 32 banks
constexpr int I8_PART_T = I8_KS * I8_RT + 4;

// Byte offsets of the dynamic shared memory, as `q4k_plan` computes them
// (ops/quant_matmul.py): the ring of stages (per stage: 16 rows of 8
// superblocks of codes, 16-byte chunks swizzled by row; then per row the
// 8 x 8 bf16 scales, the 8 x 8 mins and 16 B of padding; q5_k: per row the
// 8 x 32 B bit plane and 16 B of padding), the x codes (per token in_f +
// 64 bytes; in_f: x's columns, or those of its window), the scales sx (per group and token pair a float2), the group
// sums xs ([T][in_f/32] bf16), and the tile's partial sums ([2][8 tokens]
// [8 warps][16 rows] f32, tokens 132 floats apart).
struct I8Layout {
    int qs_pitch, sc_pitch, qh_pitch, stage, xs_pitch, x_off, prep_off,
        sum_off, part_off, total;
};

__host__ __device__ inline I8Layout i8_layout(bool q5, int T, int in_f) {
    I8Layout L;
    L.qs_pitch = Q4R_QS_PITCH;
    L.sc_pitch = Q4R_SM_PITCH;
    L.qh_pitch = q5 ? Q4R_QH_PITCH : 0;
    L.stage = I8_RT * (L.qs_pitch + L.sc_pitch + L.qh_pitch);
    L.xs_pitch = in_f + 64;  // consecutive tokens 64 B apart mod 128
    L.x_off = I8_STAGES * L.stage;
    L.prep_off = L.x_off + T * L.xs_pitch;
    L.sum_off = L.prep_off + (in_f / 32) * ((T + 1) / 2) * 8;
    L.part_off = L.sum_off + T * (in_f / 32) * 2;
    L.total = L.part_off + 2 * I8_TOKENS * I8_PART_T * 4;
    return L;
}

// T1: the T = 1 body. Its B columns all hold token 0, so every lane's C
// holds P of rows gid and gid + 8; lane tig then takes row gid + 8 (tig
// & 1), and its chain of products is the one the general body runs for
// (that row, token 0): the same operations in the same order. WIN (T1
// only): x in windows of kwin K steps.
template <bool Q5, bool T1, bool WIN>
__global__ void __launch_bounds__(I8_THREADS, 2)
q4k_i8_kernel(const uint8_t* __restrict__ qs2,
              const uint8_t* __restrict__ qh,          // q5_k (out, in/8)
              const __nv_bfloat16* __restrict__ scale,
              const __nv_bfloat16* __restrict__ mn,
              const __nv_bfloat16* __restrict__ x,     // (T, in_f)
              __nv_bfloat16* __restrict__ y,           // (T, out_f)
              int T, int out_f, int in_f, Stacked stk, int kwin) {
    static_assert(T1 || !WIN, "x in windows at T = 1 only");
    extern __shared__ __align__(16) uint8_t smem[];
    qs2 = stk.at(qs2, 0);
    qh = stk.at(qh, 1);
    scale = stk.at(scale, 2);
    mn = stk.at(mn, 3);
    // x's window: its columns (all of x without WIN)
    const int wcols = WIN ? min(in_f, kwin * I8_KS * 256) : in_f;
    const I8Layout L = i8_layout(Q5, T, wcols);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int nsb = in_f / 256, ng = in_f / 32, np = (T + 1) / 2;
    const int ksteps = (nsb + I8_KS - 1) / I8_KS;
    const int ntiles = out_f / I8_RT;
    const int mine = (int)blockIdx.x < ntiles
                         ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    const int total = mine * ksteps;  // (tile, K step) pairs of this block
    const size_t qs_row = in_f / 2, sc_row = ng, qh_row = in_f / 8;

    // activation prep (Q4kPrep, q4k_ring.cuh), part 1: 4 lanes per (token,
    // group), 8 columns each; at T >= 2 the two blocks of a cluster take
    // every other group and write the codes into both blocks' shared memory
    // (T1 runs without a cluster: its prep is small). The loads of the
    // first 8 rounds go out before the weight stream so that they do not
    // queue behind it.
    constexpr int CL = T1 ? 1 : I8_CLUSTER;
    Q4kPrep<32, CL> px(x, T, in_f, T1 ? 0u : cluster_rank());
    if (WIN) px.window(x, wcols);
    px.load(0, tid);
    if (!T1) cluster_arrive_relaxed();  // the peer writes here once started

    // one stage: rows [tile*16, +16) x superblocks [kstep*8, +8) of every
    // packed field, 16-byte cp.async chunks (superblocks past in_f skipped)
    auto issue = [&](int it) {
        const int row0 = (blockIdx.x + (it / ksteps) * gridDim.x) * I8_RT;
        const int sb0 = (it % ksteps) * I8_KS;
        uint8_t* st = smem + (it % I8_STAGES) * L.stage;
        q4k_copy_codes(st, qs2, qs_row, row0, sb0, nsb, tid);
        uint8_t* sc = st + I8_RT * L.qs_pitch;
        q4k_copy_scale_min(sc, scale, mn, sc_row, row0, sb0, nsb, tid);
        if (Q5)
            q4k_copy_qh(sc + I8_RT * L.sc_pitch, qh, qh_row, row0, sb0, nsb,
                        tid);
    };
    for (int s = 0; s < I8_STAGES - 1; ++s) {
        if (s < total) issue(s);
        cp_async_commit();
    }

    // activation prep, part 2, while the first stages arrive: the codes in
    // B-fragment order, the scale sx per group and token pair, the sum xs
    // per token and group
    uint8_t* xi = smem + L.x_off;
    float* prep = reinterpret_cast<float*>(smem + L.prep_off);
    __nv_bfloat16* xsum = reinterpret_cast<__nv_bfloat16*>(smem + L.sum_off);
    if (!T1) cluster_wait();
    px.run(xi, L.xs_pitch, prep, xsum, tid);
    // both blocks' codes, scales and sums in place before either reads them
    if (!T1) {
        cluster_arrive();
        cluster_wait();
    }

    // general body: this thread's C rows gid, gid + 8 and tokens 2 tig,
    // 2 tig + 1 (acc[2 * rowsel + token]); T1: acc[0] for row gid + 8 (tig
    // & 1), token 0. accm: the min term's mma fragment, the same layout.
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, accm[4] = {0.f, 0.f, 0.f, 0.f};
    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row
    const int myrow = gid + 8 * (tig & 1);                // T1's row
    uint4 s_r, s_r8;  // rows gid, gid+8 (T1: s_r of myrow): 8 groups
    // acc += P sx s for group e (0..7) of the superblock
    auto combine = [&](const int (&p)[4], const float2& q, int e) {
        if (T1) {
            const float pv = (float)(tig & 1 ? p[2] : p[0]);
            acc[0] = __fmaf_rn(__fmul_rn(pv, q.x), bf_at(s_r, e), acc[0]);
            return;
        }
        const float sr = bf_at(s_r, e), sr8 = bf_at(s_r8, e);
        acc[0] = __fmaf_rn(__fmul_rn((float)p[0], q.x), sr, acc[0]);
        acc[1] = __fmaf_rn(__fmul_rn((float)p[1], q.y), sr, acc[1]);
        acc[2] = __fmaf_rn(__fmul_rn((float)p[2], q.x), sr8, acc[2]);
        acc[3] = __fmaf_rn(__fmul_rn((float)p[3], q.y), sr8, acc[3]);
    };
    int wsb0 = 0;  // the window's first superblock
    for (int it = 0; it < total; ++it) {
        const int ks = it % ksteps;
        if (WIN && it > 0 && ks % kwin == 0) {
            // the next window (at a new tile the first again): once every
            // warp is done with the last one, prep it as above
            wsb0 = ks * I8_KS;
            __syncthreads();
            Q4kPrep<32, CL> pw(x, T, in_f, 0u);
            pw.window(x + wsb0 * 256, min(wcols, in_f - wsb0 * 256));
            pw.load(0, tid);
            pw.run(xi, L.xs_pitch, prep, xsum, tid);
        }
        cp_async_wait<I8_STAGES - 2>();
        __syncthreads();
        if (it + I8_STAGES - 1 < total) issue(it + I8_STAGES - 1);
        cp_async_commit();
        const int sb = ks * I8_KS + warp;
        const int sw = sb - wsb0;  // in x's window
        if (sb < nsb) {
            const uint8_t* st = smem + (it % I8_STAGES) * L.stage;
            const uint8_t* scb = st + I8_RT * L.qs_pitch;
            if (T1) {
                s_r = *reinterpret_cast<const uint4*>(
                    scb + myrow * L.sc_pitch + warp * 16);
            } else {
                s_r = *reinterpret_cast<const uint4*>(
                    scb + gid * L.sc_pitch + warp * 16);
                s_r8 = *reinterpret_cast<const uint4*>(
                    scb + (gid + 8) * L.sc_pitch + warp * 16);
            }
            {
                // the min term of the superblock's 8 groups on the tensor
                // cores: accm (16 rows x 8 tokens) += m (bf16) . xs (bf16),
                // products exact in f32; T1: every column is token 0
                const uint8_t* mb = scb + (I8_KS + warp) * 16 + 4 * tig;
                const uint32_t m0 = *reinterpret_cast<const uint32_t*>(
                    mb + gid * L.sc_pitch);
                const uint32_t m1 = *reinterpret_cast<const uint32_t*>(
                    mb + (gid + 8) * L.sc_pitch);
                uint32_t xs2 = 0u;
                if (T1 || gid < T)
                    xs2 = *reinterpret_cast<const uint32_t*>(
                        xsum + (T1 ? 0 : gid) * ng + sw * 8 + 2 * tig);
                mma1688(accm, m0, m1, xs2);
            }
            uint4 h[4];  // q5_k: rows gid, gid+8, words 0-3 / 4-7
            if (Q5) q4k_load_qh(h, scb + I8_RT * L.sc_pitch + warp * 32, gid);
            const uint8_t* arow = st + lrow * L.qs_pitch + warp * 128;
            // T1: every B column is token 0
            const uint8_t* xrow = xi + (T1 ? 0 : gid) * L.xs_pitch + sw * 256
                                  + tig * 16;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                uint32_t alo[4], ahi[4];
                q4k_codes<Q5>(arow, lane, lrow, tig, k, h, alo, ahi);
                uint4 xb = make_uint4(0u, 0u, 0u, 0u);
                if (T1 || gid < T)
                    xb = *reinterpret_cast<const uint4*>(xrow + k * 64);
                int plo[4], phi[4];
                mma16832_s8(plo, alo, xb.x, xb.y);
                mma16832_s8(phi, ahi, xb.z, xb.w);
                float2 pl = make_float2(0.f, 0.f), ph = pl;
                if (T1 || tig < np) {
                    const int pair = T1 ? 0 : tig;
                    pl = *reinterpret_cast<const float2*>(
                        prep + ((size_t)(sw * 8 + k) * np + pair) * 2);
                    ph = *reinterpret_cast<const float2*>(
                        prep + ((size_t)(sw * 8 + k + 4) * np + pair) * 2);
                }
                // group k, then group k + 4
                combine(plo, pl, k);
                combine(phi, ph, k + 4);
            }
        }
        if (ks == ksteps - 1) {
            // the tile's 8 K parts meet in shared memory; one thread per
            // (row, token) adds them in warp order
            float* part = reinterpret_cast<float*>(smem + L.part_off);
            constexpr int PM = I8_TOKENS * I8_PART_T;  // the min half
            auto at = [&](int t, int r) {
                return part + t * I8_PART_T + warp * I8_RT + r;
            };
            if (T1) {
                if (tig < 2) {
                    at(0, myrow)[0] = acc[0];
                    at(0, myrow)[PM] = tig & 1 ? accm[2] : accm[0];
                }
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float* pa = at(2 * tig + (e & 1), gid + 8 * (e >> 1));
                    pa[0] = acc[e];
                    pa[PM] = accm[e];
                }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[e] = accm[e] = 0.f;
            __syncthreads();
            if (tid < I8_RT * T) {
                const int t = tid / I8_RT, r = tid % I8_RT;
                const float* pt = part + t * I8_PART_T + r;
                float sa = pt[0], sm = pt[PM];
#pragma unroll
                for (int w = 1; w < I8_KS; ++w) {
                    sa = __fadd_rn(sa, pt[w * I8_RT]);
                    sm = __fadd_rn(sm, pt[PM + w * I8_RT]);
                }
                const int row0 = (blockIdx.x + (it / ksteps) * gridDim.x) * I8_RT;
                y[(size_t)t * out_f + row0 + r] = f2bf(__fsub_rn(sa, sm));
            }
        }
    }
    cp_async_wait<0>();
}

template <bool Q5, bool T1, bool WIN = false>
static cudaError_t launch_i8(const void* qs2, const void* qh,
                             const void* scale, const void* mn, const void* x,
                             void* y, int T, int out_f, int in_f, int grid,
                             int smem, Stacked stk, int kwin, cudaStream_t st) {
    static bool ready = false;  // the opt-in above 48 KB, once per body
    if (!ready) {
        cudaError_t e = cudaFuncSetAttribute(
            q4k_i8_kernel<Q5, T1, WIN>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, I8_SMEM_MAX);
        if (e != cudaSuccess) return e;
        ready = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(I8_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = I8_CLUSTER;  // T >= 2: pairs share the prep
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = T1 ? 0 : 1;
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, q4k_i8_kernel<Q5, T1, WIN>, (const uint8_t*)qs2,
        (const uint8_t*)qh, (const __nv_bfloat16*)scale,
        (const __nv_bfloat16*)mn, (const __nv_bfloat16*)x, (__nv_bfloat16*)y,
        T, out_f, in_f, stk, kwin);
    return e != cudaSuccess ? e : cudaGetLastError();
}

// K1 (T == 1), K7 (2 <= T <= 8) and K17a (T == 1, li set: layer li[0] of
// stacked fields, n0..n3 the per-layer element counts of qs2, qh, scale
// and min), int8 activations; qh is the q5_k bit plane, or null for q4_k.
// grid, smem and kwin (x's window in K steps, T == 1 only below the K
// steps) come from `q4k_plan`; a plan whose shared memory differs from
// this source's layout is refused.
KCPP_API int k1_q4k_i8(const void* qs2, const void* qh, const void* scale,
                       const void* mn, const void* x, void* y, int T,
                       int out_f, int in_f, int grid, int smem,
                       STACKED_PARAMS, int kwin, void* stream) {
    const int ksteps = (in_f / 256 + I8_KS - 1) / I8_KS;
    if (T < 1 || T > I8_TOKENS || in_f <= 0 || in_f % 256 || out_f % I8_RT
        || grid < 1 || grid > out_f / I8_RT || grid % I8_CLUSTER
        || smem > I8_SMEM_MAX || kwin < 1 || kwin > ksteps
        || (T > 1 && kwin < ksteps)
        || smem != i8_layout(qh != nullptr, T,
                             min(in_f, kwin * I8_KS * 256)).total)
        return (int)cudaErrorInvalidValue;
    const Stacked stk = STACKED_ARG;
    cudaStream_t st = (cudaStream_t)stream;
    const bool win = kwin < ksteps;
#define I8_ARGS qs2, qh, scale, mn, x, y, T, out_f, in_f, grid, smem, stk, \
        kwin, st
    cudaError_t err;
    if (qh)
        err = T > 1 ? launch_i8<true, false>(I8_ARGS)
              : win ? launch_i8<true, true, true>(I8_ARGS)
                    : launch_i8<true, true>(I8_ARGS);
    else
        err = T > 1 ? launch_i8<false, false>(I8_ARGS)
              : win ? launch_i8<false, true, true>(I8_ARGS)
                    : launch_i8<false, true>(I8_ARGS);
#undef I8_ARGS
    return (int)err;
}

// ---------------------------------------------------------------------------
// bf16-activation bodies (the first design, kept: not on the main path)
// ---------------------------------------------------------------------------

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

template <int T, bool Q5>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
q4k_bf16_kernel(const uint8_t* __restrict__ qs2,
                const uint8_t* __restrict__ qh,          // q5_k (out, in/8)
                const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ mn,
                const __nv_bfloat16* __restrict__ x,     // (T, in_f)
                const __nv_bfloat16* __restrict__ xsum,  // (T, in_f/32)
                __nv_bfloat16* __restrict__ y,           // (T, out_f)
                int out_f, int in_f, Stacked stk, int ntok) {
    qs2 = stk.at(qs2, 0);
    qh = stk.at(qh, 1);
    scale = stk.at(scale, 2);
    mn = stk.at(mn, 3);
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= out_f) return;  // whole warps exit together
    const int ng = in_f / 32;
    // block y takes tokens [T y, T y + T) of ntok (past 8 tokens: blocks of
    // 8, each token summed as alone)
    const int t0 = blockIdx.y * T, nt = min(T, ntok - t0);
    x += (size_t)t0 * in_f;
    xsum += (size_t)t0 * ng;
    y += (size_t)t0 * out_f;
    const int nchunk = in_f / 32;  // 16-byte chunks per row (in_f/2 bytes)
    const uint8_t* wrow = qs2 + (size_t)row * (in_f / 2);
    const __nv_bfloat16* srow = scale + (size_t)row * ng;
    const __nv_bfloat16* mrow = mn + (size_t)row * ng;

    float acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = 0.f;
    for (int base = 0; base < nchunk; base += 32) {
        const int c = base + lane;
        const bool valid = c < nchunk;  // chunk pairs are valid together
        const int sb = c >> 3;           // superblock
        const int b = (c & 7) * 16;      // byte offset inside the superblock
        const int col_lo = sb * 256 + b;         // logical col of low nibble
        const int col_hi = col_lo + 128;         // ... and of high nibble
        const int g_lo = sb * 8 + (c & 7) / 2;   // logical 32-col group
        const int g_hi = g_lo + 4;
        uint32_t ws[4] = {0u, 0u, 0u, 0u};
        uint32_t hlo = 0u, hhi = 0u;  // 5th bits of the 16 cols in each plane
        if (valid) {
            const uint4 w = *reinterpret_cast<const uint4*>(wrow + sb * 128 + b);
            ws[0] = w.x; ws[1] = w.y; ws[2] = w.z; ws[3] = w.w;
            if (Q5) {
                const uint8_t* hrow = qh + (size_t)row * (in_f / 8);
                hlo = *reinterpret_cast<const uint16_t*>(hrow + col_lo / 8);
                hhi = *reinterpret_cast<const uint16_t*>(hrow + col_hi / 8);
            }
        }
        const float s_lo = valid ? bf2f(srow[g_lo]) : 0.f;
        const float s_hi = valid ? bf2f(srow[g_hi]) : 0.f;
#pragma unroll
        for (int t = 0; t < T; ++t) {
            float plo = 0.f, phi = 0.f;
            if (valid && t < nt) {
                const __nv_bfloat16* xt = x + (size_t)t * in_f;
#pragma unroll
                for (int k = 0; k < 16; ++k) {
                    const uint32_t byte = (ws[k >> 2] >> (8 * (k & 3))) & 0xFFu;
                    uint32_t clo = byte & 0xF, chi = byte >> 4;
                    if (Q5) {
                        clo |= ((hlo >> k) & 1u) << 4;
                        chi |= ((hhi >> k) & 1u) << 4;
                    }
                    plo = __fmaf_rn((float)clo, bf2f(xt[col_lo + k]), plo);
                    phi = __fmaf_rn((float)chi, bf2f(xt[col_hi + k]), phi);
                }
            }
            // the two lanes of one 32-column group (c, c^1) combine partials
            plo += __shfl_xor_sync(0xffffffffu, plo, 1);
            phi += __shfl_xor_sync(0xffffffffu, phi, 1);
            if (valid && (lane & 1) == 0) {
                acc[t] = __fmaf_rn(s_lo, plo, acc[t]);
                acc[t] = __fmaf_rn(s_hi, phi, acc[t]);
            }
        }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
        if (t >= nt) break;  // nt is uniform over the block
        const __nv_bfloat16* xs = xsum + (size_t)t * ng;
        float accm = 0.f;  // min term: sum_g m_g * xsum_g
        for (int g = lane; g < ng; g += 32)
            accm = __fmaf_rn(bf2f(mrow[g]), bf2f(xs[g]), accm);
        const float r = warp_sum(acc[t]) - warp_sum(accm);
        if (lane == 0) y[(size_t)t * out_f + row] = f2bf(r);
    }
}

template <bool Q5>
static cudaError_t launch_bf16(int T, const void* qs2, const void* qh,
                               const void* scale, const void* mn,
                               const void* x, const void* xsum, void* y,
                               int out_f, int in_f, Stacked stk,
                               cudaStream_t st) {
    if (T < 1 || (T + 7) / 8 > 65535) return cudaErrorInvalidValue;
    dim3 grid((out_f + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, T > 8 ? (T + 7) / 8 : 1);
    dim3 block(ROWS_PER_BLOCK * 32);
#define KQ_ARGS (const uint8_t*)qs2, (const uint8_t*)qh, \
        (const __nv_bfloat16*)scale, (const __nv_bfloat16*)mn, \
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)xsum, \
        (__nv_bfloat16*)y, out_f, in_f, stk, T
    switch (T > 8 ? 8 : T) {
        case 1: q4k_bf16_kernel<1, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 2: q4k_bf16_kernel<2, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 3: q4k_bf16_kernel<3, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 4: q4k_bf16_kernel<4, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 5: q4k_bf16_kernel<5, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 6: q4k_bf16_kernel<6, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 7: q4k_bf16_kernel<7, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        case 8: q4k_bf16_kernel<8, Q5><<<grid, block, 0, st>>>(KQ_ARGS); break;
        default: return cudaErrorInvalidValue;
    }
#undef KQ_ARGS
    return cudaGetLastError();
}

// x (n = T * in_f) bf16 -> xsum (n/32) bf16, the bf16-rounded f32 sum of
// each 32-column group (the groups never straddle two tokens: in_f is a
// multiple of 256)
KCPP_API int k1_q4k_sums(const void* x, void* xsum, int n, void* stream) {
    return (int)launch_group_sums<32>(x, xsum, n, (cudaStream_t)stream);
}

// K1 / K7 / K17a with bf16 activations (xsum from k1_q4k_sums)
KCPP_API int k7_q4k_bf16(const void* qs2, const void* qh, const void* scale,
                         const void* mn, const void* x, const void* xsum,
                         void* y, int T, int out_f, int in_f, STACKED_PARAMS,
                         void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const Stacked stk = STACKED_ARG;
    return (int)(qh ? launch_bf16<true>(T, qs2, qh, scale, mn, x, xsum, y,
                                        out_f, in_f, stk, st)
                    : launch_bf16<false>(T, qs2, qh, scale, mn, x, xsum, y,
                                         out_f, in_f, stk, st));
}
