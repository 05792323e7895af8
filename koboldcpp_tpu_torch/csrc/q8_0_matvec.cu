// K2.q8_0: q8_0 T=1 matvec, y (1, out_f) bf16 = x (1, in_f) . W^T with
// w = q * s per 32-column group (q int8, s bf16); K2.q8_0_bf16: the same
// with bf16 activations.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec` for q8_0 at
// T=1: bodies `_q8_0_row_kernel_i8` (the JAX `_mm_i8` default, at every
// in_f) and `_q8_0_row_kernel` (KCPP_MM_I8=0). K17b.q8_0 (li set: layer li
// of layer-stacked fields, the scan decode path) replaces
// `_packed_matvec_stacked` for q8_0: the same bodies with the weight
// pointers moved to layer li (Stacked, common.cuh).
//
// The body, its fixed summation order (which `q8_0_matvec_plain` repeats,
// so the two agree bit for bit), its bound on the H100 and its design:
// csrc/rowmv_g.cuh (shared with K12.iq). One launch per matvec, which preps
// its own x; grid, stages and shared memory from `rowmv_plan`
// (ops/quant_matmul.py).
// Launch counters: ops/_build.launches["K2.q8_0"] (int8),
// ["K2.q8_0_bf16"] (bf16), ["K17b.q8_0"] / ["K17b.q8_0_bf16"] (stacked),
// one per matvec.
#include "rowmv_g.cuh"

// xmode 1: int8 activations; 0: bf16 x, 2: bf16 x kept as f32 in shared
// memory (`rowmv_plan`'s xf32). li set (K17b.q8_0): layer li[0] of
// stacked fields, n0 / n3 the per-layer element counts of q and scale (n1,
// n2, n4 unused). kwin: x's window in K steps (the K steps: x whole). A
// plan whose shared memory differs from this source's layout is refused.
KCPP_API int k2_q8_0_matvec(const void* q, const void* scale, const void* x,
                            void* y, int out_f, int in_f, int xmode, int grid,
                            int stages, int smem, STACKED_PARAMS, int kwin,
                            void* stream) {
    if (xmode < 0 || xmode > 2
        || !rg_plan_ok(GK_Q8, 32, xmode == 1, xmode == 2, out_f, in_f, grid,
                       stages, smem, kwin))
        return (int)cudaErrorInvalidValue;
    const Stacked stk = STACKED_ARG;
    cudaStream_t st = (cudaStream_t)stream;
#define K2_ARGS q, nullptr, nullptr, scale, nullptr, x, y, out_f, in_f, \
        grid, stages, smem, stk, kwin, st
    const cudaError_t err =
        xmode == 1 ? rowmvg_launch<GK_Q8, true, 32>(K2_ARGS)
        : xmode == 2 ? rowmvg_launch<GK_Q8, false, 32, true>(K2_ARGS)
                     : rowmvg_launch<GK_Q8, false, 32>(K2_ARGS);
#undef K2_ARGS
    return (int)err;
}
