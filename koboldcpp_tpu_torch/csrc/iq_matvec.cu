// K12.iq: the native IQ kinds' T=1 matvec, y (1, out_f) bf16 = x (1, in_f)
// . W^T with w = v * s (- m for iq1p) per group of G = 8, 16 or 32 columns.
//
// Replaces koboldcpp_tpu/ops/quant_matmul.py `_packed_matvec` for the IQ
// kinds at T=1 (in_f >= 32 G): bodies `_iq2p_row_kernel_i8` (iq2p),
// `_iq3p_row_kernel_i8` (iq3px and iq3ps) and `_iq1p_row_kernel_i8`
// (iq1p), with the activation prep `_iq_i8_prep`. K17b.<kind> (li set:
// layer li of layer-stacked fields, the scan decode path) replaces
// `_packed_matvec_stacked` for the IQ kinds: the same bodies with the
// weight pointers moved to layer li (Stacked, common.cuh).
//
// The body, the layout it reads, its bound on the H100 and its design:
// csrc/rowmv_g.cuh (shared with K2.q8_0). One launch per matvec, which
// preps its own x; grid, stages and shared memory from `rowmv_plan`
// (ops/quant_matmul.py).
// Launch counters: ops/_build.launches["K12.iq2p"], ["K12.iq3px"],
// ["K12.iq3ps"], ["K12.iq1p"], ["K17b.<kind>"] (stacked), one per matvec.
#include "rowmv_g.cuh"

// kind 0 = iq2p (qs, sg), 1 = iq3px and 2 = iq3ps (qs, hmask, sg), 3 = iq1p
// (qs, min); unused pointers may be null. group G in {8, 16, 32}. li set
// (K17b.<kind>): layer li[0] of stacked fields, n0..n4 the per-layer
// element counts of qs, hmask, sg, scale and min. kwin: x's window in K
// steps (the K steps: x whole). A plan whose shared memory differs from
// this source's layout is refused.
KCPP_API int k12_iq_matvec(int kind, const void* qs, const void* hmask,
                           const void* sg, const void* scale, const void* mn,
                           const void* x, void* y, int out_f, int in_f,
                           int group, int grid, int stages, int smem,
                           STACKED_PARAMS, int kwin, void* stream) {
    if (kind < 0 || kind > 3 || (group != 8 && group != 16 && group != 32)
        || !rg_plan_ok(kind + 1, group, true, false, out_f, in_f, grid,
                       stages, smem, kwin)
        || (kind == 0 && sg == nullptr)
        || ((kind == 1 || kind == 2) && (hmask == nullptr || sg == nullptr))
        || (kind == 3 && mn == nullptr))
        return (int)cudaErrorInvalidValue;
    const Stacked stk = STACKED_ARG;
    cudaStream_t st = (cudaStream_t)stream;
#define K12_CALL(K, G) rowmvg_launch<K, true, G>(qs, hmask, sg, scale, mn, \
        x, y, out_f, in_f, grid, stages, smem, stk, kwin, st)
#define K12_KIND(K) (group == 8 ? K12_CALL(K, 8) \
                     : group == 16 ? K12_CALL(K, 16) : K12_CALL(K, 32))
    cudaError_t err;
    switch (kind) {
        case 0: err = K12_KIND(GK_IQ2); break;
        case 1: err = K12_KIND(GK_IQ3X); break;
        case 2: err = K12_KIND(GK_IQ3S); break;
        default: err = K12_KIND(GK_IQ1); break;
    }
#undef K12_KIND
#undef K12_CALL
    return (int)err;
}
