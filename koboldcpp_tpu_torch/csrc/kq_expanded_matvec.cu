// K12 expanded: the T=1 matvec over the expanded layouts of
// KCPP_KQ_LAYOUT=expanded, y (1, out_f) bf16 = x (1, in_f) . W^T with, per
// 16-column group g, w = v * s_g (q6_k_i8f: v = q6 - 32, one int8 per
// weight), w = (q3 - 4) * s_g (q3_k_n4) or w = q2 * s_g - m_g (q2_k_n4; the
// codes as nibbles).
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec` for the
// expanded kinds: bodies `_q6k_i8f_row_kernel`, `_q3k_n4_row_kernel` and
// `_q2k_n4_row_kernel` (with `_n4_prep` / `_n4_product`). x is quantized
// per 16-column group to int8 (codes rint(x * (127 / a_g)), sx_g = a_g /
// 127, and the bf16-rounded group sums xs_g); each group's code dot P_g is
// an exact int32; y_r = sum_g P_rg * sx_g * s_rg, minus 4 * sum_g xs_g *
// s_rg (q3_k_n4) or sum_g xs_g * m_rg (q2_k_n4) in f32.
//
// Layout (ops/linear.py): q6_k_i8f's q (out_f, in_f) int8 in logical
// order; the n4 kinds' n4 (out_f, in_f/2) u8, byte 16b+k holding col 32b+k
// in the low nibble and col 32b+16+k in the high one; scale / min (out_f,
// in_f/16) bf16 in logical group order.
//
// Bound on the H100: bytes (q6_k_i8f 1 B/weight, the n4 kinds 0.5, plus 2
// or 4 B of bf16 scale and min per 16 weights). The first design (a warp
// per row, a separate activation-prep launch, __dp4a chains, a scalar bf16
// scale and min load per 16 weights a lane, no asynchronous copy) ran
// 2.1-3.0x its bound. This one is csrc/rowmv.cuh's body (K2's and K12's):
// one launch that preps its own x, a cp.async ring of 16-row tiles of the
// values and the scale (and min) fields, the group dots on mma.sync
// m16n8k16 s8 (q6_k_i8f's int8 values as A; the n4 nibbles masked or
// shifted to s8 codes in registers), the -4 sum xs s and -sum xs m terms
// on the group-sum path (bf16 mma.sync), grid, stages and shared memory
// from `rowmv_plan` (ops/quant_matmul.py). x stays whole: the dispatch's
// `_expanded_fits` keeps in_f near 10K at most.
// Launch counters: ops/_build.launches["K12.q6_k_i8f"], ["K12.q3_k_n4"],
// ["K12.q2_k_n4"], one per matvec.
#include "rowmv.cuh"

// kind 0: q6_k_i8f (w = q, int8; mn null); 1: q3_k_n4 (w = n4; mn null);
// 2: q2_k_n4 (w = n4, mn = min). x is whole (one window of all the K
// steps). A plan whose shared memory differs from this source's layout is
// refused.
KCPP_API int k12_expanded_matvec(int kind, const void* w, const void* scale,
                                 const void* mn, const void* x, void* y,
                                 int out_f, int in_f, int grid, int stages,
                                 int smem, void* stream) {
    const int rk = RK_X6 + kind;
    const int kwin = (in_f / 256 + RM_KS - 1) / RM_KS;
    if (kind < 0 || kind > 2
        || !rm_plan_ok(rk, true, out_f, in_f, grid, stages, smem, kwin)
        || (kind == 2) != (mn != nullptr))
        return (int)cudaErrorInvalidValue;
    const Stacked stk{nullptr, {0, 0, 0, 0, 0}};
    cudaStream_t st = (cudaStream_t)stream;
#define K12X_ARGS w, nullptr, scale, mn, x, y, out_f, in_f, grid, stages, \
        smem, stk, kwin, st
    switch (kind) {
        case 0: return (int)rowmv_launch1<RK_X6, true, false>(K12X_ARGS);
        case 1: return (int)rowmv_launch1<RK_X3, true, false>(K12X_ARGS);
        default: return (int)rowmv_launch1<RK_X2, true, false>(K12X_ARGS);
    }
#undef K12X_ARGS
}
