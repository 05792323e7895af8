// K2: q6_k T=1 matvec, y (1, out_f) bf16 = x (1, in_f) . W^T with
// w = (q6 - 32) * s per 16-column group.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec` for q6_k at
// T=1: body `_q6k_row_kernel_i8` (in_f >= 512) and `_q6k_row_kernel`
// (bf16 activations, in_f < 512 or KCPP_MM_I8=0). K17b (li set: layer li of
// layer-stacked fields, the scan decode path) replaces
// `_packed_matvec_stacked` for q6_k: the same body with the weight
// pointers moved to layer li (Stacked, common.cuh).
//
// The body, its bound on the H100 and its design: csrc/rowmv.cuh (shared
// with K12's q2_k / q3_k). One launch per matvec, which preps its own x;
// grid, stages and shared memory from `rowmv_plan` (ops/quant_matmul.py).
// Launch counters: ops/_build.launches["K2"], ["K17b"] (stacked), one per
// matvec.
#include "rowmv.cuh"

// K2, and K17b (li set: layer li[0] of stacked fields, n0..n2 the
// per-layer element counts of ql, qh and scale). i8: int8 activations,
// else bf16; kwin: x's window in K steps (the K steps: x whole). A plan
// whose shared memory differs from this source's layout is refused.
KCPP_API int k2_q6k_matvec(const void* ql, const void* qh, const void* scale,
                           const void* x, void* y, int out_f, int in_f,
                           int i8, int grid, int stages, int smem,
                           STACKED_PARAMS, int kwin, void* stream) {
    if (!rm_plan_ok(RK_Q6, i8 != 0, out_f, in_f, grid, stages, smem, kwin))
        return (int)cudaErrorInvalidValue;
    const Stacked stk = STACKED_ARG;
    cudaStream_t st = (cudaStream_t)stream;
    return (int)(i8 ? rowmv_launch<RK_Q6, true>(ql, qh, scale, nullptr, x, y,
                                                out_f, in_f, grid, stages,
                                                smem, stk, kwin, st)
                    : rowmv_launch<RK_Q6, false>(ql, qh, scale, nullptr, x,
                                                 y, out_f, in_f, grid,
                                                 stages, smem, stk, kwin,
                                                 st));
}
