// Batched flash decode that also writes this step's K/V row in place, over
// five cache kinds, and the read-only single-sequence decode K16:
//   K5: the fused (B, S, Hkv*D) bf16 slot cache, or the same in f32;
//   K17c: K5 over the row window [li * B, li * B + B) of a pooled
//         (L * B, S, Hkv*D) bf16 or f32 cache, li read from device memory;
//   K6: the same as int8 with (B, S, Hkv) bf16 scales (Q8, --quantkv 1);
//   K8: a paged (NP*P, Hkv*D) bf16 pool addressed through a (B, MP) table;
//   K9: the paged pool as int8 rows with (NP*P, Hkv) bf16 scales;
//   K10: the paged pool as plane-split nibbles (NP*P, Hkv*D/2) uint8 (byte
//        i of a head's D/2 bytes holds element i in the low nibble and
//        element i+D/2 in the high one, as value + 8) with the same scales;
//   K16: one sequence, no new row: softmax over the rows <= pos of an
//        (S, Hkv*D) bf16 cache, nothing written.
//
// Replace koboldcpp_tpu/ops/flash_decode.py `decode_attention_batched`
// (body `_bkernel`), `decode_attention_rows` (`_bkernel` with pos_off=1:
// K17c), `decode_attention` (`_kernel`: K16), `decode_attention_batched_q8`
// (`_bqkernel`),
// `decode_attention_paged` (`_pkernel`), `decode_attention_paged_q8`
// (`_pq8kernel`) and `decode_attention_paged_q4` (`_pq4kernel`).
// Per sequence b: online softmax over the history rows < pos only (no row
// at or past pos is read; pos < 0 attends every row, as the TPU kernels'
// dead-row remap does; pos >= S attends all S rows), scores q . k in f32
// times `scale`, optional softcap, p cast to bf16 before p . V; this step's
// self term folds in f32 from the new row as the cache will hold it; output
// f32 (B, H, D). The new row lands at pos when 0 <= pos < S (an f32 cache
// takes it rounded to bf16, as the TPU kernel's bf16 k_new / v_new operands
// are; scores and p . V then read the f32 rows). K16 attends the rows
// < pos + 1 and has no self term and no write. K17c's sequence b reads and
// writes pool row li * B + b only, so the other layers' rows stay as they
// were; it is otherwise K5, bit for bit. For the paged
// kinds S = MP * P and row r of sequence b lives at pool row
// tab[b, r / P] * P + r % P. The quantized kinds round as their TPU kernels
// do: K6 dequantizes each history element to bf16(int8 * scale) before the
// dot; K9/K10 dot q with the integer values and apply the scales on the
// score side, score = (q . k_int) * k_scale * scale and weight =
// bf16(p * v_scale) before weight . v_int. Each quantizes the new row as
// kv/cache.py `_q8` / kv/paged.py `_quantize_q4` do (amax/127 or amax/7 per
// head, round half to even, scale rounded to bf16), uses its dequantized
// bf16 values for the self term, and writes the codes and the scale.
//
// Bound on the H100: bytes (the live history rows' K and V values plus
// their scales, and the row write). Design: flash-decoding split over the
// sequence — grid (B * Hkv, NSPLIT); each block serves the G = H / Hkv
// query heads of one kv head over a slice of the rows, 4 warps x 32-row
// chunks, a lane scoring one row for all G heads, then owning D/32 output
// columns for p . V. A second small kernel quantizes the new row, merges the
// slices' (max, sum, acc), folds in the self term, writes the output and
// the cache row. The TPU kernels walk a sequence's pages one after another
// (grid (B, MP)); the paged kinds keep the slot kinds' split boundaries and
// arithmetic and only compute each row's address through the page table,
// so K8 over a page table gives bit for bit K5's output on the same history
// laid out contiguously. K17c reads its layer index from device memory in
// both launches, as the TPU kernel takes its row base by scalar prefetch,
// so a captured decode step can point it at a device counter.
// Launch counters: ops/_build.launches["K5"], ["K6"], ["K8"], ["K9"],
// ["K10"], ["K16"], ["K17c"] (one per call).
#include "common.cuh"

constexpr int NW = 4;        // warps per block
constexpr int MAXG = 16;     // query heads per kv head
constexpr int MAXGD = 1024;  // G * D
constexpr int MAXD = 128;

// cache kinds: the element type of the rows and where the scales apply
enum Kind { BF16_ROWS = 0, Q8_VALUE = 1, Q8_SCORE = 2, Q4_SCORE = 3,
            F32_ROWS = 4 };

// the kinds whose rows are integer codes with per-head scales
#define QUANT_KIND(K) ((K) == Q8_VALUE || (K) == Q8_SCORE || (K) == Q4_SCORE)

// cache row of history row `row` of sequence b: contiguous (N, S, KD) at
// sequence row cb (b, or li * B + b in a pool), or through the (B, MP) page
// table of a paged pool (entries clamped to the pool)
__device__ __forceinline__ size_t cache_row(const int* __restrict__ tab,
                                            int b, int cb, int row, int S,
                                            int MP, int P, int NP) {
    if (tab == nullptr) return (size_t)cb * S + row;
    const int page = min(max(tab[(size_t)b * MP + row / P], 0), NP - 1);
    return (size_t)page * P + row % P;
}

// bytes of one head's D elements in a cache row of kind KIND
template <int KIND, int D>
struct Row {
    static constexpr int BYTES = KIND == F32_ROWS ? 4 * D
                                 : KIND == BF16_ROWS ? 2 * D
                                 : KIND == Q4_SCORE ? D / 2 : D;
};

// elements [8c, 8c + 8) of one head's row, as the score dot takes them:
// bf16 or f32 values, bf16(int8 * scale) (K6), or the integer values (K9,
// K10)
template <int KIND, int D>
__device__ __forceinline__ void load8(const uint8_t* __restrict__ head,
                                      int c, float s, float kf[8]) {
    if (KIND == F32_ROWS) {
        const float4* h4 = reinterpret_cast<const float4*>(head);
        const float4 a = h4[2 * c], b = h4[2 * c + 1];
        kf[0] = a.x; kf[1] = a.y; kf[2] = a.z; kf[3] = a.w;
        kf[4] = b.x; kf[5] = b.y; kf[6] = b.z; kf[7] = b.w;
    } else if (KIND == BF16_ROWS) {
        const uint4 kv = reinterpret_cast<const uint4*>(head)[c];
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(k2[e]);
            kf[2 * e] = f.x;
            kf[2 * e + 1] = f.y;
        }
    } else if (KIND == Q4_SCORE) {
        // elements 8c.. are the low nibbles of bytes 8c.. below D/2, the
        // high nibbles of bytes 8c - D/2.. above
        const int hi = 8 * c >= D / 2;
        const uint2 w = reinterpret_cast<const uint2*>(head)[c - hi * (D / 16)];
        const uint32_t ws[2] = {w.x, w.y};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const uint32_t byte = (ws[e >> 2] >> (8 * (e & 3))) & 0xFFu;
            kf[e] = (float)((int)(hi ? byte >> 4 : byte & 0xFu) - 8);
        }
    } else {
        const uint2 w = reinterpret_cast<const uint2*>(head)[c];
        const uint32_t ws[2] = {w.x, w.y};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const float v = (float)(int8_t)((ws[e >> 2] >> (8 * (e & 3))) & 0xFFu);
            kf[e] = KIND == Q8_VALUE ? bf2f(f2bf(v * s)) : v;
        }
    }
}

// element d of one head's row as p . V takes it (see load8)
template <int KIND, int D>
__device__ __forceinline__ float load1(const uint8_t* __restrict__ head,
                                       int d, float s) {
    if (KIND == F32_ROWS) return reinterpret_cast<const float*>(head)[d];
    if (KIND == BF16_ROWS)
        return bf2f(reinterpret_cast<const __nv_bfloat16*>(head)[d]);
    if (KIND == Q4_SCORE) {
        const uint32_t byte = head[d % (D / 2)];
        return (float)((int)(d < D / 2 ? byte & 0xFu : byte >> 4) - 8);
    }
    const float v = (float)reinterpret_cast<const int8_t*>(head)[d];
    return KIND == Q8_VALUE ? bf2f(f2bf(v * s)) : v;
}

template <int KIND, int D>
__global__ void __launch_bounds__(NW * 32)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const uint8_t* __restrict__ kc,
                          const uint8_t* __restrict__ vc,
                          const __nv_bfloat16* __restrict__ ksc,  // or null
                          const __nv_bfloat16* __restrict__ vsc,
                          const int* __restrict__ positions,
                          const int* __restrict__ tab,  // (B, MP) or null
                          const int* __restrict__ li,   // K17c's layer or null
                          int MP, int P, int NP,
                          float* __restrict__ part_acc,  // (B*Hkv, NS, G, D)
                          float* __restrict__ part_ml,   // (B*Hkv, NS, G, 2)
                          int S, int Hkv, int G, int rows_per_split,
                          int inclusive, float scale, float softcap) {
    constexpr int DPL = D / 32;  // output columns per lane
    constexpr int HB = Row<KIND, D>::BYTES;
    constexpr bool SCALED = QUANT_KIND(KIND);
    constexpr bool SCORE_SIDE = KIND == Q8_SCORE || KIND == Q4_SCORE;
    __shared__ float q_s[MAXGD];
    __shared__ float p_s[NW][32][MAXG];
    __shared__ float acc_s[NW][MAXGD];
    __shared__ float m_s[NW][MAXG], l_s[NW][MAXG];

    const int bk = blockIdx.x, split = blockIdx.y, NS = gridDim.y;
    const int b = bk / Hkv, kvh = bk % Hkv;
    const int cb = (li ? li[0] * (int)(gridDim.x / Hkv) : 0) + b;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t row_bytes = (size_t)Hkv * HB;
    const int pos = positions[b];
    // history rows < pos (K16: <= pos); pos < 0 reads every row
    const int n_hist = pos < 0 ? S : min(pos + inclusive, S);
    const int r_begin = split * rows_per_split;
    const int r_end = min(r_begin + rows_per_split, n_hist);

    for (int i = threadIdx.x; i < G * D; i += blockDim.x)
        q_s[i] = bf2f(q[((size_t)b * Hkv * G + (size_t)kvh * G) * D + i]);
    __syncthreads();

    float m[MAXG], l[MAXG], acc[MAXG][DPL];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
        m[g] = -1e30f;
        l[g] = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
    }
    const uint8_t* kbase = kc + (size_t)kvh * HB;
    const uint8_t* vbase = vc + (size_t)kvh * HB;

    for (int r0 = r_begin + warp * 32; r0 < r_end; r0 += NW * 32) {
        const int row = r0 + lane;
        const bool valid = row < r_end;
        // scores of this lane's row for all G heads
        float sc[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) sc[g] = 0.f;
        float ks = 1.f, vs = 0.f;
        if (valid) {
            const size_t cr = cache_row(tab, b, cb, row, S, MP, P, NP);
            if (SCALED) {
                ks = bf2f(ksc[cr * Hkv + kvh]);
                vs = bf2f(vsc[cr * Hkv + kvh]);
            }
            const uint8_t* kr = kbase + cr * row_bytes;
#pragma unroll
            for (int c = 0; c < D / 8; ++c) {
                float kf[8];
                load8<KIND, D>(kr, c, ks, kf);
#pragma unroll
                for (int g = 0; g < MAXG; ++g) {
                    if (g < G) {
#pragma unroll
                        for (int e = 0; e < 8; ++e)
                            sc[g] += q_s[g * D + c * 8 + e] * kf[e];
                    }
                }
            }
        }
        float alpha[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
                float s = SCORE_SIDE ? (sc[g] * ks) * scale : sc[g] * scale;
                if (softcap > 0.f) s = softcap * tanhf(s / softcap);
                s = valid ? s : -1e30f;
                const float m_new = fmaxf(m[g], warp_max(s));
                alpha[g] = expf(m[g] - m_new);
                const float p = expf(s - m_new);
                l[g] = l[g] * alpha[g] + warp_sum(p);
                m[g] = m_new;
                // p . V takes bf16 p (score-side kinds: bf16(p * v_scale))
                p_s[warp][lane][g] = bf2f(f2bf(SCORE_SIDE ? p * vs : p));
            }
        }
        __syncwarp();
        const int nrows = min(32, r_end - r0);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
            if (g < G)
#pragma unroll
                for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha[g];
        for (int rr = 0; rr < nrows; ++rr) {
            const size_t cr = cache_row(tab, b, cb, r0 + rr, S, MP, P, NP);
            const float rvs = KIND == Q8_VALUE ? bf2f(vsc[cr * Hkv + kvh]) : 1.f;
            const uint8_t* vr = vbase + cr * row_bytes;
            float v[DPL];
#pragma unroll
            for (int i = 0; i < DPL; ++i)
                v[i] = load1<KIND, D>(vr, lane + 32 * i, rvs);
#pragma unroll
            for (int g = 0; g < MAXG; ++g)
                if (g < G) {
                    const float p = p_s[warp][rr][g];
#pragma unroll
                    for (int i = 0; i < DPL; ++i) acc[g][i] += p * v[i];
                }
        }
        __syncwarp();
    }
    // merge the NW warps of this block
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
        if (g < G) {
            if (lane == 0) {
                m_s[warp][g] = m[g];
                l_s[warp][g] = l[g];
            }
#pragma unroll
            for (int i = 0; i < DPL; ++i)
                acc_s[warp][g * D + lane + 32 * i] = acc[g][i];
        }
    __syncthreads();
    const size_t part = (size_t)bk * NS + split;
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
        const int g = i / D;
        float mm = -1e30f;
        for (int w = 0; w < NW; ++w) mm = fmaxf(mm, m_s[w][g]);
        float a = 0.f;
        for (int w = 0; w < NW; ++w) a += acc_s[w][i] * expf(m_s[w][g] - mm);
        part_acc[part * G * D + i] = a;
        if (i % D == 0) {
            float ll = 0.f;
            for (int w = 0; w < NW; ++w) ll += l_s[w][g] * expf(m_s[w][g] - mm);
            part_ml[(part * G + g) * 2] = mm;
            part_ml[(part * G + g) * 2 + 1] = ll;
        }
    }
}

// quantize this step's row (quantized kinds), merge the NSPLIT slices, fold
// in the self term, write out and the cache row; K16 (knew null) merges
// the slices alone and writes no row
template <int KIND>
__global__ void flash_decode_merge_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ knew,
        const __nv_bfloat16* __restrict__ vnew,
        uint8_t* __restrict__ kc, uint8_t* __restrict__ vc,
        __nv_bfloat16* __restrict__ ksc, __nv_bfloat16* __restrict__ vsc,
        const int* __restrict__ positions, const int* __restrict__ tab,
        const int* __restrict__ li, int MP, int P, int NP,
        const float* __restrict__ part_acc, const float* __restrict__ part_ml,
        float* __restrict__ out, int S, int Hkv, int G, int D, int NS,
        float scale, float softcap) {
    constexpr float QMAX = KIND == Q4_SCORE ? 7.f : 127.f;
    __shared__ float s_self[MAXG];
    __shared__ float new_s[2][MAXD];  // k, v: the row as the cache holds it
    __shared__ int code_s[2][MAXD];   // their integer codes (quantized kinds)
    __shared__ float amax_s[2];
    const int bk = blockIdx.x, b = bk / Hkv, kvh = bk % Hkv;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const bool self = knew != nullptr;
    if (!self) {  // K16: the slices' merge is the output
        for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
            const int g = i / D;
            float mm = -1e30f;
            for (int sp = 0; sp < NS; ++sp)
                mm = fmaxf(mm, part_ml[(((size_t)bk * NS + sp) * G + g) * 2]);
            float ll = 0.f, a = 0.f;
            for (int sp = 0; sp < NS; ++sp) {
                const size_t part = (size_t)bk * NS + sp;
                const float f = expf(part_ml[(part * G + g) * 2] - mm);
                ll += part_ml[(part * G + g) * 2 + 1] * f;
                a += part_acc[part * G * D + i] * f;
            }
            out[((size_t)b * Hkv * G + (size_t)kvh * G) * D + i] = a / ll;
        }
        return;
    }
    const __nv_bfloat16* kn = knew + ((size_t)b * Hkv + kvh) * D;
    const __nv_bfloat16* vn = vnew + ((size_t)b * Hkv + kvh) * D;
    const __nv_bfloat16* qh = q + ((size_t)b * Hkv * G + (size_t)kvh * G) * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
        new_s[0][d] = bf2f(kn[d]);
        new_s[1][d] = bf2f(vn[d]);
    }
    __syncthreads();
    if (QUANT_KIND(KIND)) {
        if (warp < 2) {  // warp 0: k's amax, warp 1: v's
            float a = 0.f;
            for (int d = lane; d < D; d += 32) a = fmaxf(a, fabsf(new_s[warp][d]));
            a = warp_max(a);
            if (lane == 0) amax_s[warp] = a;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < 2 * D; i += blockDim.x) {
            const int w = i / D, d = i % D;
            const float sc = amax_s[w] / QMAX;
            const float inv = sc > 0.f ? 1.f / sc : 0.f;
            float c = rintf(__fmul_rn(new_s[w][d], inv));
            if (KIND == Q4_SCORE) c = fminf(fmaxf(c, -8.f), 7.f);
            code_s[w][d] = (int)c;
            new_s[w][d] = bf2f(f2bf(__fmul_rn(c, bf2f(f2bf(sc)))));
        }
        __syncthreads();
    }
    for (int g = warp; g < G; g += nwarps) {  // self scores, one warp per head
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += bf2f(qh[g * D + d]) * new_s[0][d];
        s = warp_sum(s) * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        if (lane == 0) s_self[g] = s;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
        const int g = i / D, d = i % D;
        float mm = -1e30f;
        for (int sp = 0; sp < NS; ++sp)
            mm = fmaxf(mm, part_ml[(((size_t)bk * NS + sp) * G + g) * 2]);
        float ll = 0.f, a = 0.f;
        for (int sp = 0; sp < NS; ++sp) {
            const size_t part = (size_t)bk * NS + sp;
            const float f = expf(part_ml[(part * G + g) * 2] - mm);
            ll += part_ml[(part * G + g) * 2 + 1] * f;
            a += part_acc[part * G * D + i] * f;
        }
        const float ss = s_self[g];
        const float m_new = fmaxf(mm, ss);
        const float alpha = expf(mm - m_new);
        const float p_self = expf(ss - m_new);
        const float l_tot = ll * alpha + p_self;
        const float o = (a * alpha + p_self * new_s[1][d]) / l_tot;
        out[((size_t)b * Hkv * G + (size_t)kvh * G + g) * D + d] = o;
    }
    const int pos = positions[b];
    if (pos < 0 || pos >= S) return;
    const int cb = (li ? li[0] * (int)(gridDim.x / Hkv) : 0) + b;
    const size_t r = cache_row(tab, b, cb, pos, S, MP, P, NP);
    if (KIND == F32_ROWS) {  // the bf16 row, widened
        float* kr = reinterpret_cast<float*>(kc) + r * Hkv * D;
        float* vr = reinterpret_cast<float*>(vc) + r * Hkv * D;
        for (int d = threadIdx.x; d < D; d += blockDim.x) {
            kr[(size_t)kvh * D + d] = bf2f(kn[d]);
            vr[(size_t)kvh * D + d] = bf2f(vn[d]);
        }
        return;
    }
    if (KIND == BF16_ROWS) {
        __nv_bfloat16* kr = reinterpret_cast<__nv_bfloat16*>(kc) + r * Hkv * D;
        __nv_bfloat16* vr = reinterpret_cast<__nv_bfloat16*>(vc) + r * Hkv * D;
        for (int d = threadIdx.x; d < D; d += blockDim.x) {
            kr[(size_t)kvh * D + d] = kn[d];
            vr[(size_t)kvh * D + d] = vn[d];
        }
        return;
    }
    if (KIND == Q4_SCORE) {  // plane-split: byte i = code i | code i+D/2 << 4
        const int D2 = D / 2;
        for (int i = threadIdx.x; i < 2 * D2; i += blockDim.x) {
            const int w = i / D2, j = i % D2;
            uint8_t* dst = (w == 0 ? kc : vc) + r * Hkv * D2 + (size_t)kvh * D2;
            dst[j] = (uint8_t)((code_s[w][j] + 8) | ((code_s[w][j + D2] + 8) << 4));
        }
    } else {
        for (int i = threadIdx.x; i < 2 * D; i += blockDim.x) {
            const int w = i / D, d = i % D;
            int8_t* dst = reinterpret_cast<int8_t*>(w == 0 ? kc : vc)
                          + r * Hkv * D + (size_t)kvh * D;
            dst[d] = (int8_t)code_s[w][d];
        }
    }
    if (threadIdx.x < 2)
        (threadIdx.x == 0 ? ksc : vsc)[r * Hkv + kvh] =
            f2bf(amax_s[threadIdx.x] / QMAX);
}

template <int KIND>
static cudaError_t launch_kind(
        const void* q, const void* knew, const void* vnew, void* kc, void* vc,
        void* ksc, void* vsc, const void* positions, const int* tab,
        const int* li, int MP, int P, int NP, void* out, void* part_acc,
        void* part_ml, int B, int S, int H, int Hkv, int D, int nsplit,
        int rows_per_split, float scale, float softcap, cudaStream_t st) {
    const int G = H / Hkv;
    const int inclusive = knew == nullptr;  // K16 attends row pos itself
    dim3 grid(B * Hkv, nsplit);
#define FD_ARGS (const __nv_bfloat16*)q, (const uint8_t*)kc, \
        (const uint8_t*)vc, (const __nv_bfloat16*)ksc, \
        (const __nv_bfloat16*)vsc, (const int*)positions, tab, li, MP, P, \
        NP, (float*)part_acc, (float*)part_ml, S, Hkv, G, rows_per_split, \
        inclusive, scale, softcap
    if (D == 64)
        flash_decode_split_kernel<KIND, 64><<<grid, NW * 32, 0, st>>>(FD_ARGS);
    else
        flash_decode_split_kernel<KIND, 128><<<grid, NW * 32, 0, st>>>(FD_ARGS);
#undef FD_ARGS
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_decode_merge_kernel<KIND><<<B * Hkv, 128, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)knew,
        (const __nv_bfloat16*)vnew, (uint8_t*)kc, (uint8_t*)vc,
        (__nv_bfloat16*)ksc, (__nv_bfloat16*)vsc, (const int*)positions, tab,
        li, MP, P, NP, (const float*)part_acc, (const float*)part_ml,
        (float*)out, S, Hkv, G, D, nsplit, scale, softcap);
    return cudaGetLastError();
}

static cudaError_t launch_flash_decode(
        int kind, const void* q, const void* knew, const void* vnew, void* kc,
        void* vc, void* ksc, void* vsc, const void* positions, const int* tab,
        const int* li, int MP, int P, int NP, void* out, void* part_acc,
        void* part_ml, int B, int S, int H, int Hkv, int D, int nsplit,
        int rows_per_split, float scale, float softcap, cudaStream_t st) {
    const int G = H / Hkv;
    if (G > MAXG || G * D > MAXGD || (D != 64 && D != 128))
        return cudaErrorInvalidValue;
#define FD_CALL(K) launch_kind<K>(q, knew, vnew, kc, vc, ksc, vsc, positions, \
        tab, li, MP, P, NP, out, part_acc, part_ml, B, S, H, Hkv, D, nsplit, \
        rows_per_split, scale, softcap, st)
    switch (kind) {
        case BF16_ROWS: return FD_CALL(BF16_ROWS);
        case Q8_VALUE: return FD_CALL(Q8_VALUE);
        case Q8_SCORE: return FD_CALL(Q8_SCORE);
        case Q4_SCORE: return FD_CALL(Q4_SCORE);
        case F32_ROWS: return FD_CALL(F32_ROWS);
    }
#undef FD_CALL
    return cudaErrorInvalidValue;
}

// K5 (li null) and K17c. q (B, H, D), knew/vnew (B, Hkv, D) bf16; kc/vc
// (N, S, Hkv*D) bf16 (kind 0) or f32 (kind 4), N = B, or L * B for K17c,
// whose sequence b is row li[0] * B + b; positions (B,) int32; out (B, H,
// D) f32; part_acc (B*Hkv, nsplit, G*D), part_ml (B*Hkv, nsplit, G, 2) f32
// scratch.
KCPP_API int k5_flash_decode(int kind, const void* q, const void* knew,
                             const void* vnew, void* kc, void* vc,
                             const void* positions, const void* li,
                             void* out, void* part_acc, void* part_ml, int B,
                             int S, int H, int Hkv, int D, int nsplit,
                             int rows_per_split, float scale, float softcap,
                             void* stream) {
    if (kind != BF16_ROWS && kind != F32_ROWS)
        return (int)cudaErrorInvalidValue;
    return (int)launch_flash_decode(
        kind, q, knew, vnew, kc, vc, nullptr, nullptr, positions, nullptr,
        (const int*)li, 0, 1, 1, out, part_acc, part_ml, B, S, H, Hkv, D,
        nsplit, rows_per_split, scale, softcap, (cudaStream_t)stream);
}

// K16. q (H, D) bf16, kc/vc (S, Hkv*D) bf16, pos (1,) int32; out (H, D)
// f32 over the rows <= pos (all S when pos >= S); nothing is written.
KCPP_API int k16_flash_decode(const void* q, const void* kc, const void* vc,
                              const void* pos, void* out, void* part_acc,
                              void* part_ml, int S, int H, int Hkv, int D,
                              int nsplit, int rows_per_split, float scale,
                              float softcap, void* stream) {
    return (int)launch_flash_decode(
        BF16_ROWS, q, nullptr, nullptr, (void*)kc, (void*)vc, nullptr,
        nullptr, pos, nullptr, nullptr, 0, 1, 1, out, part_acc, part_ml, 1,
        S, H, Hkv, D, nsplit, rows_per_split, scale, softcap,
        (cudaStream_t)stream);
}

// K6. As K5, with kc/vc (B, S, Hkv*D) int8 and ksc/vsc (B, S, Hkv) bf16.
KCPP_API int k6_flash_decode_q8(const void* q, const void* knew,
                                const void* vnew, void* kc, void* vc,
                                void* ksc, void* vsc, const void* positions,
                                void* out, void* part_acc, void* part_ml,
                                int B, int S, int H, int Hkv, int D,
                                int nsplit, int rows_per_split, float scale,
                                float softcap, void* stream) {
    return (int)launch_flash_decode(
        Q8_VALUE, q, knew, vnew, kc, vc, ksc, vsc, positions, nullptr,
        nullptr, 0, 1, 1, out, part_acc, part_ml, B, S, H, Hkv, D, nsplit,
        rows_per_split, scale, softcap, (cudaStream_t)stream);
}

// K8 (kind 0), K9 (kind 2), K10 (kind 3). As K5, with kc/vc the
// (NP*P, Hkv*D) bf16 | int8 or (NP*P, Hkv*D/2) uint8 pools, ksc/vsc the
// (NP*P, Hkv) bf16 scales (null for K8) and tab the (B, MP) int32 page
// table; S = MP * P.
KCPP_API int k8_flash_decode_paged(int kind, const void* q, const void* knew,
                                   const void* vnew, void* kc, void* vc,
                                   void* ksc, void* vsc, const void* tab,
                                   const void* positions, void* out,
                                   void* part_acc, void* part_ml, int B,
                                   int MP, int P, int NP, int H, int Hkv,
                                   int D, int nsplit, int rows_per_split,
                                   float scale, float softcap, void* stream) {
    if (kind != BF16_ROWS && kind != Q8_SCORE && kind != Q4_SCORE)
        return (int)cudaErrorInvalidValue;
    return (int)launch_flash_decode(
        kind, q, knew, vnew, kc, vc, ksc, vsc, positions, (const int*)tab,
        nullptr, MP, P, NP, out, part_acc, part_ml, B, MP * P, H, Hkv, D,
        nsplit, rows_per_split, scale, softcap, (cudaStream_t)stream);
}
