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
// moved (~1.4 us at 3.35 TB/s): both small, so a call is bound by how fast
// its blocks walk their key tiles (dependent loads, products and softmax).
// The design (FlashAttention-2 on Hopper):
// - one warpgroup (4 warps) per (64-row query tile, head, sequence); each
//   warp owns 16 query rows. Grid (H, T / 64, B) with the query tile
//   counted down the y axis, so the heaviest tiles of the causal diagonal
//   (the most key tiles) are issued first and do not set the grid's tail.
// - Q, and 64-row K / V tiles, in shared memory in the 128-byte swizzle
//   (64-column sub-tiles of 64 rows x 128 B, 1024-aligned), copied with
//   cp.async in two stages: the next K / V tile (and its positions) is in
//   flight during this one's math.
// - the S tile and the O accumulator stay in registers. At D = 64 and 128
//   both products run as wgmma with A from registers: S (64 x 64) = Q .
//   K^T (K-major B from the K tile) and O (64 x D) += P . V (B = the V tile
//   read MN-major, `desc_mn_sw128`); Q's fragments are reloaded from shared
//   memory for each key tile (kept in registers across tiles, they read
//   back wrong on the card). At D = 256 a
//   64 x 256 f32 accumulator per warpgroup plus S would not fit a
//   thread's registers beside wgmma's, so both products run as mma.sync
//   m16n8k16 (ldmatrix, .trans for V) on the same tiles.
// - the online softmax works on the accumulator fragment: a row's max and
//   sum reduce over the 4 lanes of a quad, the mask (causal and segment)
//   from the key tile's positions, and P goes straight from the score
//   fragment into the A operand of P . V, rounded to bf16.
// Launch counter: ops/_build.launches["K4"] (one per call).
#include "common.cuh"
#include "hopper.cuh"

constexpr int BQ = 64, BKV = 64;  // query / key rows per tile
constexpr int SUB = BKV * 128;    // one 64-column sub-tile of 64 rows

// byte offset of (row, column c) in a tile of 64-column swizzled sub-tiles
__device__ __forceinline__ int swz(int row, int c) {
    return (c >> 6) * SUB + row * 128 + ((((c & 63) >> 3) ^ (row & 7)) << 4)
           + (c & 7) * 2;
}

template <int D>
struct PSmem {
    static constexpr int TILE = D / 64 * SUB;  // Q, K or V tile
    // Q, two stages of (K, V), two stages of key positions, + alignment
    static constexpr size_t BYTES = 5 * (size_t)TILE + 2 * BKV * 4 + 1024;
};

template <int D>
__global__ void __launch_bounds__(128)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ positions,  // (B, T)
                     __nv_bfloat16* __restrict__ out, int T, int H, int Hkv,
                     float scale) {
    constexpr bool WG = D <= 128;  // wgmma; mma.sync at D = 256
    using L = PSmem<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* const Qs = smem;
    uint8_t* const KV = smem + L::TILE;  // stage s: K at 2s, V at 2s + 1
    int* const Ps = reinterpret_cast<int*>(smem + 5 * L::TILE);

    const int h = blockIdx.x, b = blockIdx.z;
    const int nq = T / BQ, qt = nq - 1 - blockIdx.y;  // heaviest first
    const int kvh = h / (H / Hkv);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int q0 = qt * BQ;
    const int* pos = positions + (size_t)b * T;
    constexpr int C8 = D / 8;  // 16-byte chunks per row

    // a 64-row tile of x (rows r0.., head hx of Hx) into swizzled sub-tiles
    auto load_tile = [&](uint8_t* dst, const __nv_bfloat16* x, int Hx, int hx,
                         int r0) {
        for (int i = tid; i < 64 * C8; i += 128) {
            const int r = i / C8, c = i % C8;
            cp_async16(dst + swz(r, 8 * c),
                       x + (((size_t)b * T + r0 + r) * Hx + hx) * D + 8 * c);
        }
    };
    auto issue = [&](int kt) {
        uint8_t* st = KV + (kt & 1) * 2 * L::TILE;
        load_tile(st, k, Hkv, kvh, kt * BKV);
        load_tile(st + L::TILE, v, Hkv, kvh, kt * BKV);
        if (tid < BKV / 4)
            cp_async16(Ps + (kt & 1) * BKV + 4 * tid, pos + kt * BKV + 4 * tid);
    };

    load_tile(Qs, q, H, h, q0);
    issue(0);
    cp_async_commit();

    // this thread's query rows i0 (h 0) and i0 + 8 (h 1) and their segments
    const int i0 = q0 + warp * 16 + (lane >> 2);
    const bool seg[2] = {pos[i0] < 0, pos[i0 + 8] < 0};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[D / 2];  // O fragment: n8 tile j at o[4j..4j+3]
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    // ldmatrix address of this lane in a 16 x 16 block at (row, col) of a
    // swizzled tile: matrices (rows +0/+8) x (cols +0/+8) as A fragments
    auto a_addr = [&](const uint8_t* t, int row, int col) {
        return t + swz(row + ((lane >> 3) & 1) * 8 + (lane & 7), col + (lane >> 4) * 8);
    };

    for (int kt = 0; kt <= qt; ++kt) {  // up to the diagonal's tile
        if (kt < qt) {
            issue(kt + 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        fence_proxy_async();
        __syncthreads();
        const uint8_t* Kt = KV + (kt & 1) * 2 * L::TILE;
        const uint8_t* Vt = Kt + L::TILE;
        const int* pk = Ps + (kt & 1) * BKV;
        // Q's A fragments, from shared memory for every key tile: held in
        // registers across tiles they read back wrong on the card
        uint32_t qa[WG ? D / 16 : 1][4];
        if (WG) {
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
                ldmatrix_x4(qa[WG ? ks : 0], a_addr(Qs, warp * 16, 16 * ks));
#pragma unroll
                for (int r = 0; r < 4; ++r) pin(qa[WG ? ks : 0][r]);
            }
        }

        // S (64 x 64): s[4j..4j+3] is the n8 tile of key columns 8j..
        float s[BKV / 2];
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j) s[j] = 0.f;
        if constexpr (WG) {
            const uint32_t kb = smem_u32(Kt);
            // operands written before the fence (see `pin`)
#pragma unroll
            for (int j = 0; j < BKV / 2; ++j) pin(s[j]);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks)
                wgmma_rs(s, qa[ks], desc_sw128(kb + (ks >> 2) * SUB + 32 * (ks & 3)));
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int j = 0; j < BKV / 2; ++j) pin(s[j]);
        } else {
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
                uint32_t a[4];
                ldmatrix_x4(a, a_addr(Qs, warp * 16, 16 * ks));
#pragma unroll
                for (int np = 0; np < BKV / 16; ++np) {
                    // keys 16 np.. (+8): matrices (keys +0/+8) x (d +0/+8)
                    uint32_t kf[4];
                    ldmatrix_x4(kf, Kt + swz(16 * np + (lane >> 4) * 8 + (lane & 7),
                                             16 * ks + ((lane >> 3) & 1) * 8));
                    mma16816(&s[8 * np], a, kf[0], kf[1]);
                    mma16816(&s[8 * np + 4], a, kf[2], kf[3]);
                }
            }
        }

        // online softmax of the thread's two rows over this key tile
        const int k0 = kt * BKV;
        float alpha[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int i = i0 + 8 * hh;
            float mt = -INFINITY;
#pragma unroll
            for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int c = 8 * j + (lane & 3) * 2 + e;
                    const bool keep = k0 + c <= i && (pk[c] < 0) == seg[hh];
                    const float x = s[4 * j + 2 * hh + e] * scale;
                    s[4 * j + 2 * hh + e] = keep ? x : -INFINITY;
                    mt = fmaxf(mt, keep ? x : -INFINITY);
                }
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
            const float m_new = fmaxf(m[hh], mt);
            alpha[hh] = m_new == -INFINITY ? 1.f : expf(m[hh] - m_new);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float& x = s[4 * j + 2 * hh + e];
                    x = x == -INFINITY ? 0.f : expf(x - m_new);
                    ps += x;
                }
            ps += __shfl_xor_sync(0xffffffffu, ps, 1);
            ps += __shfl_xor_sync(0xffffffffu, ps, 2);
            l[hh] = l[hh] * alpha[hh] + ps;
            m[hh] = m_new;
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            o[4 * j] *= alpha[0];
            o[4 * j + 1] *= alpha[0];
            o[4 * j + 2] *= alpha[1];
            o[4 * j + 3] *= alpha[1];
        }
        // P as A fragments, k16 step kk = key tiles 2 kk, 2 kk + 1
        uint32_t pa[BKV / 16][4];
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
            pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
            pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }

        // O (64 x D) += P . V
        if constexpr (WG) {
            const uint32_t vb = smem_u32(Vt);
#pragma unroll
            for (int j = 0; j < D / 2; ++j) pin(o[j]);
#pragma unroll
            for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
                for (int r = 0; r < 4; ++r) pin(pa[kk][r]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BKV / 16; ++kk)
                wgmma_rs<1>(o, pa[kk], desc_mn_sw128(vb + kk * 16 * 128, SUB, 1024));
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int j = 0; j < D / 2; ++j) pin(o[j]);
        } else {
#pragma unroll
            for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
                for (int np = 0; np < D / 16; ++np) {
                    // keys 16 kk.. (+8) x columns 16 np.. (+8), transposed
                    uint32_t vf[4];
                    ldmatrix_x4_trans(vf, a_addr(Vt, 16 * kk, 16 * np));
                    mma16816(&o[8 * np], pa[kk], vf[0], vf[1]);
                    mma16816(&o[8 * np + 4], pa[kk], vf[2], vf[3]);
                }
        }
        __syncthreads();  // this stage is read before tile kt + 2 lands in it
    }

    // out = O / l, bf16 (every row sees itself, so l > 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const float inv = 1.f / l[hh];
        __nv_bfloat16* orow = out + (((size_t)b * T + i0 + 8 * hh) * H + h) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(orow + 8 * j + (lane & 3) * 2) =
                pack_bf16(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    }
}

template <int D>
static cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                                  const void* positions, void* out, int B,
                                  int T, int H, int Hkv, float scale,
                                  cudaStream_t st) {
    static bool allowed = false;
    const size_t bytes = PSmem<D>::BYTES;
    if (!allowed) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_prefill_kernel<D>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return e;
        allowed = true;
    }
    dim3 grid(H, T / BQ, B);
    flash_prefill_kernel<D><<<grid, 128, bytes, st>>>(
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
