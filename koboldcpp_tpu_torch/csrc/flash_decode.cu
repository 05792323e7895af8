// K5: batched flash decode over the fused (B, S, Hkv*D) bf16 slot cache,
// writing this step's K/V row in place.
//
// Replaces koboldcpp_tpu/ops/flash_decode.py `decode_attention_batched`
// (body `_bkernel`). Per sequence b: online softmax over the history rows
// < pos only (no row at or past pos is read; pos < 0 attends every row, as
// the TPU kernel's dead-row remap does; pos >= S attends all S rows),
// scores bf16 q . bf16 k in f32 times `scale`, optional softcap, p cast to
// bf16 before p . V; this step's self term folds in f32 from k_new/v_new;
// output f32 (B, H, D). The new K/V row lands at pos when 0 <= pos < S.
//
// Bound on the H100: bytes (2 * B * n_hist * Hkv * D * 2 B of history
// plus the row write). Design: flash-decoding split over the sequence —
// grid (B * Hkv, NSPLIT); each block serves the G = H / Hkv query heads of
// one kv head over a slice of the rows, 4 warps x 32-row chunks, a lane
// scoring one row for all G heads, then owning D/32 output columns for
// p . V. A second small kernel merges the slices' (max, sum, acc), folds in
// the self term, writes the output and the cache row.
// Launch counter: ops/_build.launches["K5"] (one per call).
#include "common.cuh"

constexpr int NW = 4;        // warps per block
constexpr int MAXG = 16;     // query heads per kv head
constexpr int MAXGD = 1024;  // G * D

template <int D>
__global__ void __launch_bounds__(NW * 32)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ kc,
                          const __nv_bfloat16* __restrict__ vc,
                          const int* __restrict__ positions,
                          float* __restrict__ part_acc,  // (B*Hkv, NS, G, D)
                          float* __restrict__ part_ml,   // (B*Hkv, NS, G, 2)
                          int S, int Hkv, int G, int rows_per_split,
                          float scale, float softcap) {
    constexpr int DPL = D / 32;  // output columns per lane
    __shared__ float q_s[MAXGD];
    __shared__ float p_s[NW][32][MAXG];
    __shared__ float acc_s[NW][MAXGD];
    __shared__ float m_s[NW][MAXG], l_s[NW][MAXG];

    const int bk = blockIdx.x, split = blockIdx.y, NS = gridDim.y;
    const int b = bk / Hkv, kvh = bk % Hkv;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int KD = Hkv * D;
    const int pos = positions[b];
    const int n_hist = pos < 0 ? S : min(pos, S);
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
    const __nv_bfloat16* kbase = kc + (size_t)b * S * KD + (size_t)kvh * D;
    const __nv_bfloat16* vbase = vc + (size_t)b * S * KD + (size_t)kvh * D;

    for (int r0 = r_begin + warp * 32; r0 < r_end; r0 += NW * 32) {
        const int row = r0 + lane;
        const bool valid = row < r_end;
        // scores of this lane's row for all G heads
        float sc[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) sc[g] = 0.f;
        if (valid) {
            const uint4* kr = reinterpret_cast<const uint4*>(
                kbase + (size_t)row * KD);
#pragma unroll
            for (int d8 = 0; d8 < D / 8; ++d8) {
                const uint4 kv = kr[d8];
                const __nv_bfloat162* k2 =
                    reinterpret_cast<const __nv_bfloat162*>(&kv);
                float kf[8];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float2 f = __bfloat1622float2(k2[e]);
                    kf[2 * e] = f.x;
                    kf[2 * e + 1] = f.y;
                }
#pragma unroll
                for (int g = 0; g < MAXG; ++g) {
                    if (g < G) {
#pragma unroll
                        for (int e = 0; e < 8; ++e)
                            sc[g] += q_s[g * D + d8 * 8 + e] * kf[e];
                    }
                }
            }
        }
        float alpha[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
                float s = sc[g] * scale;
                if (softcap > 0.f) s = softcap * tanhf(s / softcap);
                s = valid ? s : -1e30f;
                const float m_new = fmaxf(m[g], warp_max(s));
                alpha[g] = expf(m[g] - m_new);
                const float p = expf(s - m_new);
                l[g] = l[g] * alpha[g] + warp_sum(p);
                m[g] = m_new;
                p_s[warp][lane][g] = bf2f(f2bf(p));  // p . V takes bf16 p
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
            float v[DPL];
#pragma unroll
            for (int i = 0; i < DPL; ++i)
                v[i] = bf2f(vbase[(size_t)(r0 + rr) * KD + lane + 32 * i]);
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

// merge the NSPLIT slices, fold in the self term, write out and the cache
__global__ void flash_decode_merge_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ knew,
        const __nv_bfloat16* __restrict__ vnew,
        __nv_bfloat16* __restrict__ kc, __nv_bfloat16* __restrict__ vc,
        const int* __restrict__ positions,
        const float* __restrict__ part_acc, const float* __restrict__ part_ml,
        float* __restrict__ out, int S, int Hkv, int G, int D, int NS,
        float scale, float softcap) {
    __shared__ float s_self[MAXG];
    const int bk = blockIdx.x, b = bk / Hkv, kvh = bk % Hkv;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const int KD = Hkv * D;
    const __nv_bfloat16* kn = knew + ((size_t)b * Hkv + kvh) * D;
    const __nv_bfloat16* vn = vnew + ((size_t)b * Hkv + kvh) * D;
    const __nv_bfloat16* qh = q + ((size_t)b * Hkv * G + (size_t)kvh * G) * D;
    for (int g = warp; g < G; g += nwarps) {  // self scores, one warp per head
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += bf2f(qh[g * D + d]) * bf2f(kn[d]);
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
        const float o = (a * alpha + p_self * bf2f(vn[d])) / l_tot;
        out[((size_t)b * Hkv * G + (size_t)kvh * G + g) * D + d] = o;
    }
    const int pos = positions[b];
    if (pos >= 0 && pos < S) {
        for (int d = threadIdx.x; d < D; d += blockDim.x) {
            kc[((size_t)b * S + pos) * KD + (size_t)kvh * D + d] = kn[d];
            vc[((size_t)b * S + pos) * KD + (size_t)kvh * D + d] = vn[d];
        }
    }
}

// q (B, H, D), knew/vnew (B, Hkv, D), kc/vc (B, S, Hkv*D) all bf16;
// positions (B,) int32; out (B, H, D) f32; part_acc (B*Hkv, nsplit, G*D),
// part_ml (B*Hkv, nsplit, G, 2) f32 scratch.
KCPP_API int k5_flash_decode(const void* q, const void* knew, const void* vnew,
                             void* kc, void* vc, const void* positions,
                             void* out, void* part_acc, void* part_ml, int B,
                             int S, int H, int Hkv, int D, int nsplit,
                             int rows_per_split, float scale, float softcap,
                             void* stream) {
    const int G = H / Hkv;
    if (G > MAXG || G * D > MAXGD || (D != 64 && D != 128))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid(B * Hkv, nsplit);
#define K5_ARGS (const __nv_bfloat16*)q, (const __nv_bfloat16*)kc, \
        (const __nv_bfloat16*)vc, (const int*)positions, (float*)part_acc, \
        (float*)part_ml, S, Hkv, G, rows_per_split, scale, softcap
    if (D == 64)
        flash_decode_split_kernel<64><<<grid, NW * 32, 0, st>>>(K5_ARGS);
    else
        flash_decode_split_kernel<128><<<grid, NW * 32, 0, st>>>(K5_ARGS);
#undef K5_ARGS
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    flash_decode_merge_kernel<<<B * Hkv, 128, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)knew,
        (const __nv_bfloat16*)vnew, (__nv_bfloat16*)kc, (__nv_bfloat16*)vc,
        (const int*)positions, (const float*)part_acc, (const float*)part_ml,
        (float*)out, S, Hkv, G, D, nsplit, scale, softcap);
    return (int)cudaGetLastError();
}
