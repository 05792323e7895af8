// K12: q2_k / q3_k T=1 matvec, y (1, out_f) bf16 = x (1, in_f) . W^T with
// w = q2 * s - m (q2_k) or (q3 - 4) * s (q3_k) per 16-column group.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec` for q2_k and
// q3_k at T=1: bodies `_q2k_row_kernel_i8` / `_q3k_row_kernel_i8` (in_f >=
// 512) and `_q2k_row_kernel` / `_q3k_row_kernel` (bf16 activations, in_f <
// 512 or KCPP_MM_I8=0). K17b.q2_k / .q3_k (li set: layer li of
// layer-stacked fields, the scan decode path) replace
// `_packed_matvec_stacked` for these kinds: the same bodies with the weight
// pointers moved to layer li (Stacked, common.cuh).
//
// The body, its bound on the H100 and its design: csrc/rowmv.cuh (shared
// with K2's q6_k). One launch per matvec, which preps its own x; grid,
// stages and shared memory from `rowmv_plan` (ops/quant_matmul.py).
// Launch counters: ops/_build.launches["K12.q2_k"], ["K12.q3_k"],
// ["K17b.q2_k"], ["K17b.q3_k"].
#include "rowmv.cuh"

// q3 = 0: q2_k (qs, scale, min; hmask null); q3 = 1: q3_k (qs, hmask,
// scale; min null). i8: int8 activations, else bf16. li set (K17b.q2_k /
// .q3_k): layer li[0] of stacked fields, n0..n3 the per-layer element
// counts of qs, hmask, scale and min. kwin: x's window in K steps (the K
// steps: x whole). A plan whose shared memory differs from this source's
// layout is refused.
KCPP_API int k12_q23k_matvec(int q3, const void* qs, const void* hmask,
                             const void* scale, const void* mn,
                             const void* x, void* y, int out_f, int in_f,
                             int i8, int grid, int stages, int smem,
                             STACKED_PARAMS, int kwin, void* stream) {
    const int kind = q3 ? RK_Q3 : RK_Q2;
    if (!rm_plan_ok(kind, i8 != 0, out_f, in_f, grid, stages, smem, kwin)
        || (q3 ? hmask == nullptr : mn == nullptr))
        return (int)cudaErrorInvalidValue;
    const Stacked stk = STACKED_ARG;
    cudaStream_t st = (cudaStream_t)stream;
#define K12_ARGS qs, hmask, scale, mn, x, y, out_f, in_f, grid, stages, smem, \
        stk, kwin, st
    cudaError_t err;
    if (q3)
        err = i8 ? rowmv_launch<RK_Q3, true>(K12_ARGS)
                 : rowmv_launch<RK_Q3, false>(K12_ARGS);
    else
        err = i8 ? rowmv_launch<RK_Q2, true>(K12_ARGS)
                 : rowmv_launch<RK_Q2, false>(K12_ARGS);
#undef K12_ARGS
    return (int)err;
}
