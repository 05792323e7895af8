// K4: causal flash prefill over a chunk that starts at position 0,
// out (B, T, H, D) bf16 = softmax(q . k^T * scale) . v with f32 scores and
// sums, within the chunk only.
//
// Replaces koboldcpp_tpu/models/llama.py `flash_prefill_attention`, which
// calls JAX's library Pallas TPU `flash_attention` with causal=True and
// segment ids: query row i sees key row j iff j <= i and both rows are real
// (position >= 0) or both are padding (position < 0). The engine pads a
// chunk at its end, so a real row never sees a pad row. GQA is by head
// group: query head h reads kv head h / (H / Hkv), nothing is repeated.
// p is rounded to bf16 before p . V, as the library kernel and the plain
// version do.
//
// Bound on the H100: at the 1.1B's 512-row chunk (H=32, Hkv=4, D=64) about
// 1.1 GFLOP of causal products (~1.1 us at 989 TFLOP/s) against ~4.7 MB
// moved (~1.4 us at 3.35 TB/s): both tiny; a simple kernel is bound by its
// latency. Design: one block of 4 warps per (64-row query tile, head,
// sequence); it walks the key tiles up to the diagonal, keeps Q, the current
// K and V tiles, the scores and the f32 output accumulator in shared
// memory, runs both products on the tensor cores (WMMA 16x16x16 bf16, f32
// accumulate; each warp owns 16 query rows), and keeps the online softmax's
// running max and sum per row. No TMA, wgmma or pipelining yet.
// Launch counter: ops/_build.launches["K4"] (one per call).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

constexpr int BQ = 64, BKV = 64, NWARP = 4;

template <int D>
struct Smem {
    static constexpr int LD = D + 8;      // bf16 tiles (skewed rows)
    static constexpr int LDO = D + 4;     // f32 output accumulator
    static constexpr int LDS = BKV + 4;   // f32 scores
    static constexpr int LDP = BKV + 8;   // bf16 probabilities
    static constexpr size_t BYTES =
        3 * (size_t)BQ * LD * 2 + (size_t)BQ * LDO * 4 + (size_t)BQ * LDS * 4
        + (size_t)BQ * LDP * 2 + 2 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(NWARP * 32)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ positions,  // (B, T)
                     __nv_bfloat16* __restrict__ out, int T, int H, int Hkv,
                     float scale) {
    using L = Smem<D>;
    extern __shared__ __align__(128) uint8_t smem[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Ks = Qs + BQ * L::LD;
    __nv_bfloat16* Vs = Ks + BKV * L::LD;
    float* Os = reinterpret_cast<float*>(Vs + BKV * L::LD);
    float* Ss = Os + BQ * L::LDO;
    __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + BQ * L::LDS);
    float* m_s = reinterpret_cast<float*>(Ps + BQ * L::LDP);
    float* l_s = m_s + BQ;

    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / Hkv);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int q0 = qt * BQ;
    const int* pos = positions + (size_t)b * T;
    constexpr int C8 = D / 8;  // 16-byte chunks per row

    // Q tile, zeroed accumulator, running max / sum
    for (int i = tid; i < BQ * C8; i += blockDim.x) {
        const int r = i / C8, c = i % C8;
        *reinterpret_cast<uint4*>(&Qs[r * L::LD + c * 8]) =
            *reinterpret_cast<const uint4*>(
                q + (((size_t)b * T + q0 + r) * H + h) * D + c * 8);
    }
    for (int i = tid; i < BQ * D; i += blockDim.x)
        Os[(i / D) * L::LDO + i % D] = 0.f;
    for (int i = tid; i < BQ; i += blockDim.x) {
        m_s[i] = -INFINITY;
        l_s[i] = 0.f;
    }

    const int wr = warp * 16;  // this warp's 16 query rows
    for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * BKV;
        __syncthreads();  // the previous tile's K/V/P are consumed
        for (int i = tid; i < BKV * C8; i += blockDim.x) {
            const int r = i / C8, c = i % C8;
            const size_t src = (((size_t)b * T + k0 + r) * Hkv + kvh) * D + c * 8;
            *reinterpret_cast<uint4*>(&Ks[r * L::LD + c * 8]) =
                *reinterpret_cast<const uint4*>(k + src);
            *reinterpret_cast<uint4*>(&Vs[r * L::LD + c * 8]) =
                *reinterpret_cast<const uint4*>(v + src);
        }
        __syncthreads();

        // S (16 x 64 per warp) = Q_w . K^T
        {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BKV / 16];
#pragma unroll
            for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
            for (int kk = 0; kk < D; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> a;
                wmma::load_matrix_sync(a, &Qs[wr * L::LD + kk], L::LD);
#pragma unroll
                for (int j = 0; j < BKV / 16; ++j) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                   wmma::col_major> bk;
                    wmma::load_matrix_sync(bk, &Ks[(16 * j) * L::LD + kk], L::LD);
                    wmma::mma_sync(sacc[j], a, bk, sacc[j]);
                }
            }
#pragma unroll
            for (int j = 0; j < BKV / 16; ++j)
                wmma::store_matrix_sync(&Ss[wr * L::LDS + 16 * j], sacc[j],
                                        L::LDS, wmma::mem_row_major);
        }
        __syncwarp();

        // online softmax over the warp's rows: a lane takes 2 of 64 columns
        for (int rr = 0; rr < 16; ++rr) {
            const int row = wr + rr, i = q0 + row;
            const bool seg_i = pos[i] < 0;
            float s[2];
            bool keep[2];
            float mt = -INFINITY;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int c = lane + 32 * e, j = k0 + c;
                keep[e] = j <= i && (pos[j] < 0) == seg_i;
                s[e] = Ss[row * L::LDS + c] * scale;
                if (keep[e]) mt = fmaxf(mt, s[e]);
            }
            mt = warp_max(mt);
            const float m_old = m_s[row];
            const float m_new = fmaxf(m_old, mt);
            const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
            float psum = 0.f;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float p = keep[e] ? expf(s[e] - m_new) : 0.f;
                psum += p;
                Ps[row * L::LDP + lane + 32 * e] = f2bf(p);
            }
            psum = warp_sum(psum);
            // rescale the row's accumulator by alpha
            for (int d = lane; d < D; d += 32) Os[row * L::LDO + d] *= alpha;
            if (lane == 0) {
                m_s[row] = m_new;
                l_s[row] = l_s[row] * alpha + psum;
            }
        }
        __syncwarp();

        // O_w (16 x D) += P_w (16 x 64) . V (64 x D)
#pragma unroll
        for (int n = 0; n < D; n += 16) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
            wmma::load_matrix_sync(oacc, &Os[wr * L::LDO + n], L::LDO,
                                   wmma::mem_row_major);
#pragma unroll
            for (int kk = 0; kk < BKV; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> pa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> vb;
                wmma::load_matrix_sync(pa, &Ps[wr * L::LDP + kk], L::LDP);
                wmma::load_matrix_sync(vb, &Vs[kk * L::LD + n], L::LD);
                wmma::mma_sync(oacc, pa, vb, oacc);
            }
            wmma::store_matrix_sync(&Os[wr * L::LDO + n], oacc, L::LDO,
                                    wmma::mem_row_major);
        }
    }
    __syncwarp();
    // out = O / l, bf16 (every row sees itself, so l > 0)
    for (int rr = 0; rr < 16; ++rr) {
        const int row = wr + rr;
        const float inv = 1.f / l_s[row];
        __nv_bfloat16* o = out + (((size_t)b * T + q0 + row) * H + h) * D;
        for (int d = lane; d < D; d += 32) o[d] = f2bf(Os[row * L::LDO + d] * inv);
    }
}

template <int D>
static cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                                  const void* positions, void* out, int B,
                                  int T, int H, int Hkv, float scale,
                                  cudaStream_t st) {
    const size_t bytes = Smem<D>::BYTES;
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return e;
    dim3 grid(T / BQ, H, B);
    flash_prefill_kernel<D><<<grid, NWARP * 32, bytes, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)positions, (__nv_bfloat16*)out,
        T, H, Hkv, scale);
    return cudaGetLastError();
}

// K4. q (B, T, H, D), k/v (B, T, Hkv, D), out (B, T, H, D) all bf16 and
// contiguous; positions (B, T) int32 (< 0: padding). T % 64 == 0, H % Hkv
// == 0, D in {64, 128, 256}.
KCPP_API int k4_flash_prefill(const void* q, const void* k, const void* v,
                              const void* positions, void* out, int B, int T,
                              int H, int Hkv, int D, float scale,
                              void* stream) {
    if (T % BQ || H % Hkv) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (D) {
        case 64: return (int)launch_prefill<64>(q, k, v, positions, out, B, T,
                                                H, Hkv, scale, st);
        case 128: return (int)launch_prefill<128>(q, k, v, positions, out, B,
                                                  T, H, Hkv, scale, st);
        case 256: return (int)launch_prefill<256>(q, k, v, positions, out, B,
                                                  T, H, Hkv, scale, st);
    }
    return (int)cudaErrorInvalidValue;
}
