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
// (`_bqkernel`), `decode_attention_paged` (`_pkernel`),
// `decode_attention_paged_q8` (`_pq8kernel`) and `decode_attention_paged_q4`
// (`_pq4kernel`).
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
// were; it is otherwise K5, bit for bit. For the paged kinds S = MP * P and
// row r of sequence b lives at pool row tab[b, r / P] * P + r % P. The
// quantized kinds round as their TPU kernels do: K6 dequantizes each
// history element to bf16(int8 * scale) before the dot; K9/K10 dot q with
// the integer values and apply the scales on the score side, score =
// (q . k_int) * k_scale * scale and weight = bf16(p * v_scale) before
// weight . v_int. Each quantizes the new row as kv/cache.py `_q8` /
// kv/paged.py `_quantize_q4` do (amax/127 or amax/7 per head, round half to
// even, scale rounded to bf16), uses its dequantized bf16 values for the
// self term, and writes the codes and the scale. Head shapes: any head_dim
// D (an even one for K10's nibble planes) and any G = H / Hkv
// query heads per kv head. The tiles hold D padded to Dp, the next multiple
// of 16 (the mma k): the padding columns of Q, K and V are zero-filled as
// they are copied, the output, the new row's write and a quantized row's
// amax cover the D real columns only. A head's bytes in a row need not be
// a multiple of 16: the K / V pieces are the widest of 16, 8 or 4 bytes
// that divide them (cp.async), else 2 or 1 bytes copied by plain loads
// (K10 at D = 20 or 36: 10 or 18 bytes a head); Q and this step's rows go
// by plain loads where D % 8 != 0. DMAX (64, 128, 256, 512) bounds the
// output columns a block accumulates; at D = 512 a block's accumulators
// spill to local memory. Past 512 (the streamed instance, STREAM) the
// output columns go in chunks of DCH = 128 to NC = ceil(D / 128) blocks per
// head group (a grid of B * Hkv * NG * NC units): each block takes the
// scores over the whole head_dim (the same scores in every chunk, so the
// same softmax) and P . V for its columns, and merges its own chunk's
// partials; the cache row is written by chunk 0. No stage of that instance
// holds a whole row: a tile streams through the stages as ceil(Dp / 128) K
// pieces of 128 columns, each beside the same 128 columns of the head
// group's Q, whose score products accumulate in registers, then one V
// piece of the block's own columns (K10's nibbles unpacked to int8 codes
// as they are copied, by plain loads); the merge reads Q's rows and this
// step's rows from global memory and recomputes a quantized row's codes
// from them. So the shared memory of that instance holds two pieces and
// the merge's tables whatever D is, and every head_dim fits. Where a tile
// of 64 rows does not fit next to the merge's tables a tile takes 32 rows
// (two warps' worth), or 16 (an f32 cache at D > ~820 below the streamed
// instance).
//
// Bound on the H100: bytes (the live history rows' K and V values plus
// their scales, and the row write): a 1.1B step at pos 700 reads 0.7 MB, a
// fifth of a microsecond at 3.35 TB/s, so a call is bound by its latency:
// the launch, one round trip to HBM and the merge. The design (Hopper):
// - one launch: grid (B * Hkv * ceil(G / 16), nsplit); a block serves 16
//   query heads of one kv head (a head group: G > 16 takes several, G < 16
//   pads the m16 tile with zero rows) over one split of the history. The
//   split (rows_per_split, nsplit: ops/flash_decode.py `decode_plan`) is a
//   function of (B, Hkv, S) alone, never of the positions, so no host read
//   precedes a launch and the slot, paged and pooled kinds cut a history at
//   the same rows (K8 = K5 and K17c = K5 bit for bit); it gives ~264 blocks
//   to the 132 SMs (64-row splits at B = 1, Hkv = 4). Splits past a
//   sequence's history return at once. Each live split writes its (max,
//   sum, acc) partial; the last of them to finish (an atomic ticket per
//   head group, reset by that block) merges the partials in split order,
//   quantizes the new row, folds in the self term and writes the output
//   and the cache row: the merge no longer costs a second launch. A lone
//   live split (history within one split) merges from shared memory, with
//   no partials and no ticket; the merge loads all splits' partials in one
//   round (float4 a thread).
// - Q, this step's k / v rows and the split's first tile are copied before
//   the position is read (the tile's rows past the history are cleared
//   once it is known), so the position's load and the copies overlap.
// - 64-row tiles of K and V move into shared memory with cp.async (16-byte
//   pieces; 8 or 4 for a row whose bytes are not a multiple of 16 or 8;
//   neighbouring threads on neighbouring pieces of a head's row; rows past
//   the history zero-filled), two stages when they fit in 96 KB, so the
//   next tile's copy runs under this one's math; the paged kinds compute
//   each row's address through the page table. A quantized kind's scales
//   are loaded into registers a tile ahead and parked in shared memory.
// - both products on the tensor cores, mma.sync m16n8k16 bf16 with f32
//   accumulation, each warp on 16 rows of the tile: S (16 heads x 16 rows)
//   = Q . K^T, the online softmax on the accumulator fragment (a head's
//   max and sum reduce over the 4 lanes that hold its row), then P (the
//   score fragment rounded to bf16, straight into the A operand) . V. The
//   operands are exact in bf16: the bf16 rows (ldmatrix, .trans for V),
//   bf16(int8 * scale) (K6), the integer codes of K9/K10 (|v| <= 127), bf16
//   p and bf16(p * v_scale); only the order of the f32 sums changes. The f32
//   rows kind splits each value into bf16 hi + lo (two products each; the
//   residual is 2^-16 of the value), since bf16 alone would miss the f32
//   rows' 2^-7 W tolerance on peaked scores.
// - the four warps' states combine in shared memory in warp order, the
//   partials in split order, so every result is deterministic.
// Partials and the tickets live in a scratch the wrapper keeps across calls
// (tickets zeroed once; every merge leaves its ticket at 0). A block may
// read a row that another block of the same launch writes: the row at pos,
// read ahead in a split's first tile (past the history: masked, V
// cleared), or a live sequence's new row in a page that a dead sequence's
// table also names (only the dead output, which no caller reads, sees it).
// Launch counters: ops/_build.launches["K5"], ["K6"], ["K8"], ["K9"],
// ["K10"], ["K16"], ["K17c"] (one per call).
//
// Built as two libraries that nvcc compiles in parallel: this file takes
// the head_dims up to 256, csrc/flash_decode_wide.cu (this file with
// FD_WIDE set) those past 256 (the instance up to 512 and the streamed
// one); ops/flash_decode.py picks the library by head_dim.
#include "common.cuh"
#include "hopper.cuh"

#ifndef FD_WIDE
#define FD_WIDE 0
#endif

constexpr int NW = 4;        // warps per block
constexpr int TR = 16 * NW;  // history rows per tile: 16 per warp
constexpr int GB = 16;       // query heads per block: one m16 tile
constexpr int MAXNS = 256;   // splits per sequence (decode_plan's cap)
constexpr int DSTREAM = 1024;  // DK of the streamed instance: any D past 512
constexpr int DCH = 128;     // output columns a block takes past D = 512, and
                             // the columns of the streamed instance's pieces
constexpr int SMEM_MAX = 232448;  // a block's dynamic shared memory (227 KB)

// cache kinds: the element type of the rows and where the scales apply
enum Kind { BF16_ROWS = 0, Q8_VALUE = 1, Q8_SCORE = 2, Q4_SCORE = 3,
            F32_ROWS = 4 };

// the kinds whose rows are integer codes with per-head scales
#define QUANT_KIND(K) ((K) == Q8_VALUE || (K) == Q8_SCORE || (K) == Q4_SCORE)

// bytes of one head's D elements in a cache row of kind `kind`
__host__ __device__ constexpr int head_bytes(int kind, int D) {
    return kind == F32_ROWS ? 4 * D : kind == BF16_ROWS ? 2 * D
                                    : kind == Q4_SCORE ? D / 2 : D;
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// output columns a block takes: all D up to 512, DCH-column chunks past it
__host__ __device__ constexpr int chunk_cols(int D) { return D > 512 ? DCH : D; }

// the kind a streamed piece holds: K10's nibbles are unpacked to int8 codes
__host__ __device__ constexpr int piece_kind(int kind) {
    return kind == Q4_SCORE ? (int)Q8_SCORE : kind;
}

// Shared memory of one block at head_dim D: the Q tile (16 rows of Dp
// bf16, pitch qp) and this step's k and v rows (D bf16 each, the pair
// padded to 16 bytes), then `nst` stages of (K tile, V tile: tr rows of a
// head's Dp columns at pitch hp; k and v scales: tr f32 each); after the
// tile loop the same bytes hold the computing warps' states (combine), a
// lone split's partial and the merge's tables. Dp: D padded to 16; DC: the
// output columns of one block (chunk_cols); tr: rows per tile (TR, or 32
// or 16 where a stage of TR rows does not fit a block's 227 KB); nwa: the
// warps that take a tile's rows (16 each). Past D = 512 (stream) a stage
// holds one piece (tr rows of DCH columns at pitch hp) and two tiles' k and
// v scales follow the stages. It holds no Q tile and no new rows: a K
// piece's stage carries the same 128 columns of the head group's Q (16
// rows at pitch qp), the new rows and Q's whole rows are read from global
// memory where the merge needs them, and a quantized row's codes are
// recomputed from them, so its shared memory does not grow with D.
struct Plan {
    int Dp, DC, hp, qp, tr, nwa, stage, nst, q_bytes, comb, total;
    __host__ __device__ Plan(int kind, int D) {
        const bool stream = D > 512;
        Dp = (D + 15) & ~15;
        DC = chunk_cols(D);
        // + 16: 8 ldmatrix rows on distinct banks
        hp = (stream ? head_bytes(piece_kind(kind), DCH) : head_bytes(kind, Dp)) + 16;
        qp = 2 * (stream ? DCH : Dp) + 16;
        q_bytes = stream ? 0 : GB * qp + ((4 * D + 15) & ~15);
        const int merge = 2 * MAXNS * GB * 4 + GB * 2 * 4
                          + (stream ? 0 : 2 * D * 8) + GB * 4 + 16;
        for (tr = TR;; tr /= 2) {
            nwa = tr / 16;
            stage = stream ? tr * hp + GB * qp : 2 * tr * hp + 2 * tr * 4;
            nst = 2 * stage <= 96 * 1024 ? 2 : 1;
            comb = nwa * GB * DC * 4 + nwa * GB * 2 * 4 + GB * DC * 4 + GB * 2 * 4;
            total = q_bytes + imax(nst * stage + (stream ? 4 * tr * 4 : 0), comb + merge);
            if (total <= SMEM_MAX || tr == 16) break;
        }
    }
};

struct Args {
    const __nv_bfloat16* q;
    const __nv_bfloat16* knew;  // null: K16 (no self term, no write)
    const __nv_bfloat16* vnew;
    uint8_t* kc;
    uint8_t* vc;
    __nv_bfloat16* ksc;  // (rows, Hkv) scales of the quantized kinds, or null
    __nv_bfloat16* vsc;
    const int* positions;
    const int* tab;  // (B, MP) page table, or null
    const int* li;   // K17c's layer, or null
    float* part_acc;  // (units, nsplit, 16, DC)
    float* part_ml;   // (units, nsplit, 16, 2)
    int* tickets;     // (units,), zero between calls
    float* out;       // (B, H, D)
    int MP, P, NP, B, S, Hkv, G, D, NG, NC, rps, inclusive;
    float scale, softcap;
};

// cache row of history row `row` of sequence b: contiguous (N, S, KD) at
// sequence row cb (b, or li * B + b in a pool), or through the (B, MP) page
// table of a paged pool (entries clamped to the pool)
__device__ __forceinline__ size_t cache_row(const Args& a, int b, int cb,
                                            int row) {
    if (a.tab == nullptr) return (size_t)cb * a.S + row;
    const int page = min(max(a.tab[(size_t)b * a.MP + row / a.P], 0), a.NP - 1);
    return (size_t)page * a.P + row % a.P;
}

// elements k, k+1 of a head's row as the score product takes them: bf16(int8
// * s) (K6) or the integer values (K9, K10); bf16 rows go through ldmatrix
template <int KIND>
__device__ __forceinline__ uint32_t k_pair(const uint8_t* row, int k, int D,
                                           float s) {
    int v0, v1;
    if (KIND == Q4_SCORE && (D / 2) % 2) {  // a pair may straddle the planes
        auto nib = [&](int e) {
            const int hi = e >= D / 2;
            return (int)((row[e - hi * (D / 2)] >> (4 * hi)) & 0xFu) - 8;
        };
        v0 = nib(k);
        v1 = nib(k + 1);
    } else if (KIND == Q4_SCORE) {  // low nibbles below D/2, high ones above
        const int hi = k >= D / 2;
        const uint32_t w = *reinterpret_cast<const uint16_t*>(row + k - hi * (D / 2));
        const int sh = hi ? 4 : 0;
        v0 = (int)((w >> sh) & 0xFu) - 8;
        v1 = (int)((w >> (8 + sh)) & 0xFu) - 8;
    } else {
        const uint32_t w = *reinterpret_cast<const uint16_t*>(row + k);
        v0 = (int8_t)(w & 0xFFu);
        v1 = (int8_t)(w >> 8);
    }
    return KIND == Q8_VALUE ? pack_bf16((float)v0 * s, (float)v1 * s)
                            : pack_bf16((float)v0, (float)v1);
}

// element d of a head's row as p . V takes it, before the bf16 rounding
template <int KIND>
__device__ __forceinline__ float v_elem(const uint8_t* row, int d, int D,
                                        float s) {
    if (KIND == F32_ROWS) return reinterpret_cast<const float*>(row)[d];
    if (KIND == Q4_SCORE) {
        const uint32_t byte = row[d % (D / 2)];
        return (float)((int)(d < D / 2 ? byte & 0xFu : byte >> 4) - 8);
    }
    const float v = (float)reinterpret_cast<const int8_t*>(row)[d];
    return KIND == Q8_VALUE ? v * s : v;
}

// an f32 pair as bf16 hi + lo (lo = the rounded residual)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
    hi = pack_bf16(x0, x1);
    lo = pack_bf16(x0 - __uint_as_float(hi << 16),
                   x1 - __uint_as_float(hi & 0xFFFF0000u));
}

// DMAX bounds the output columns of a block (Plan.DC), DK the padded
// head_dim Dp that the scores run over; DK past 512 is the streamed
// instance (pieces of DCH columns)
template <int KIND, int DMAX, int DK>
__global__ void __launch_bounds__(NW * 32)
flash_decode_kernel(const Args a) {
    extern __shared__ __align__(16) uint8_t smem[];
    constexpr bool SCALED = QUANT_KIND(KIND);
    constexpr bool SCORE_SIDE = KIND == Q8_SCORE || KIND == Q4_SCORE;
    constexpr bool STREAM = DK > 512;
    // the element kind of the tile or piece rows the products read
    constexpr int PK = STREAM ? piece_kind(KIND) : KIND;
    const int D = a.D;
    const Plan L(KIND, D);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int unit = blockIdx.x, split = blockIdx.y;
    const int cc = unit % a.NC, hgu = unit / a.NC;  // column chunk, head group
    const int hg = hgu % a.NG, bk = hgu / a.NG;
    const int b = bk / a.Hkv, kvh = bk % a.Hkv;
    const int g0 = hg * GB, Gb = min(GB, a.G - g0);
    const int DC = L.DC, c0 = cc * DC, cw = min(DC, D - c0);  // this chunk
    const bool self = a.knew != nullptr;
    uint8_t* const qs = smem;
    uint8_t* const nrow = smem + GB * L.qp;  // this step's k, v rows (bf16)
    uint8_t* const body = smem + L.q_bytes;

    // the head group's query rows (zero rows past G, zero columns past D)
    // and this step's k / v rows, in flight while the position is read
    const __nv_bfloat16* qh = a.q + (((size_t)b * a.Hkv + kvh) * a.G + g0) * D;
    if (STREAM) {  // Q comes with the K pieces, the new rows from global
    } else if (D % 8) {  // rows not in 16-byte pieces: plain loads
        uint16_t* q16 = reinterpret_cast<uint16_t*>(qs);
        const uint16_t* qg = reinterpret_cast<const uint16_t*>(qh);
        for (int i = tid; i < GB * L.Dp; i += blockDim.x) {
            const int g = i / L.Dp, d = i - g * L.Dp;
            q16[g * (L.qp / 2) + d] = g < Gb && d < D ? qg[(size_t)g * D + d] : 0;
        }
        if (self) {
            uint16_t* n16 = reinterpret_cast<uint16_t*>(nrow);
            const size_t off = ((size_t)b * a.Hkv + kvh) * D;
            for (int i = tid; i < 2 * D; i += blockDim.x)
                n16[i] = reinterpret_cast<const uint16_t*>(i < D ? a.knew : a.vnew)[off + i % D];
        }
    } else {
        const int ch = D / 8, chp = L.Dp / 8;
        for (int i = tid; i < (GB + 2) * chp; i += blockDim.x) {
            const int g = i / chp, c = i - g * chp;
            if (g >= GB) {  // the new rows
                if (self && c < ch) {
                    const __nv_bfloat16* src = (g == GB ? a.knew : a.vnew)
                                               + ((size_t)b * a.Hkv + kvh) * D + 8 * c;
                    cp_async16(nrow + (g - GB) * 2 * D + 16 * c, src);
                }
                continue;
            }
            const bool ok = g < Gb && c < ch;
            cp_async16_zfill(qs + g * L.qp + 16 * c,
                             ok ? (const void*)(qh + (size_t)g * D + 8 * c) : (const void*)a.q,
                             ok ? 16 : 0);
        }
    }
    const int cb = (a.li ? a.li[0] * a.B : 0) + b;
    const int r_begin = split * a.rps;  // < S: nsplit = ceil(S / rps)
    const int HB = head_bytes(KIND, D);
    const size_t row_bytes = (size_t)a.Hkv * HB;
    const uint8_t* kbase = a.kc + (size_t)kvh * HB;
    const uint8_t* vbase = a.vc + (size_t)kvh * HB;
    // bytes per copy: the widest piece that divides a head's bytes (and so
    // its offset in a row); below 4, plain loads
    const int CW = HB % 16 == 0 ? 16 : HB % 8 == 0 ? 8 : HB % 4 == 0 ? 4
                 : HB % 2 == 0 ? 2 : 1;
    const int CH = HB / CW;                        // copies of D columns
    const int CHP = head_bytes(KIND, L.Dp) / CW;   // ... of Dp: zero-filled
    const int TRt = L.tr;                          // rows per tile
    auto stage_of = [&](int t) { return body + (t % L.nst) * L.stage; };
    // tile t's K and V rows into its stage, rows from `lim` on and columns
    // past D zero-filled
    auto issue = [&](int t, int lim) {
        uint8_t* st = stage_of(t);
        const int r0 = r_begin + t * TRt;
        for (int i = tid; i < 2 * TRt * CHP; i += blockDim.x) {
            const int w = i / (TRt * CHP), rem = i - w * TRt * CHP;
            const int rr = rem / CHP, c = rem - rr * CHP;
            const int row = r0 + rr;
            const bool ok = row < lim && c < CH;
            const uint8_t* src = a.kc;
            if (ok) src = (w ? vbase : kbase) + cache_row(a, b, cb, row) * row_bytes + c * CW;
            uint8_t* dst = st + (w * TRt + rr) * L.hp + c * CW;
            if (CW == 16) cp_async16_zfill(dst, src, ok ? 16 : 0);
            else if (CW == 8) cp_async8_zfill(dst, src, ok ? 8 : 0);
            else if (CW == 4) cp_async4_zfill(dst, src, ok ? 4 : 0);
            else if (CW == 2)
                *reinterpret_cast<uint16_t*>(dst) = ok ? *reinterpret_cast<const uint16_t*>(src) : 0;
            else *dst = ok ? *src : 0;
        }
    };
    // the streamed instance's piece u of NPC a tile (K pieces j < NKP of
    // DCH columns, then this block's V columns) into its stage, rows from
    // `lim` on and columns past D zero-filled; K10's nibbles as int8 codes
    const int NKP = (L.Dp + DCH - 1) / DCH, NPC = NKP + 1;
    auto issue_piece = [&](int u, int lim) {
        const int t = u / NPC, j = u - t * NPC;
        uint8_t* st = body + (u % L.nst) * L.stage;
        const int r0 = r_begin + t * TRt;
        const uint8_t* base = j < NKP ? kbase : vbase;
        const int col0 = j < NKP ? j * DCH : c0;
        const int w = min(DCH, D - col0);  // columns of the head in the piece
        if (j < NKP) {  // the head group's Q columns col0.. beside the piece
            uint8_t* qt = st + TRt * L.hp;
            if (D % 8) {
                uint16_t* q16 = reinterpret_cast<uint16_t*>(qt);
                const uint16_t* qg = reinterpret_cast<const uint16_t*>(qh) + col0;
                for (int i = tid; i < GB * DCH; i += blockDim.x) {
                    const int g = i / DCH, c = i - g * DCH;
                    q16[g * (L.qp / 2) + c] = g < Gb && c < w ? qg[(size_t)g * D + c] : 0;
                }
            } else {
                for (int i = tid; i < GB * (DCH / 8); i += blockDim.x) {
                    const int g = i / (DCH / 8), c = i - g * (DCH / 8);
                    const bool ok = g < Gb && 8 * c < w;
                    cp_async16_zfill(qt + g * L.qp + 16 * c,
                                     ok ? (const void*)(qh + (size_t)g * D + col0 + 8 * c)
                                        : (const void*)a.q,
                                     ok ? 16 : 0);
                }
            }
        }
        if (KIND == Q4_SCORE) {
            const int D2 = D / 2;
            for (int i = tid; i < TRt * DCH; i += blockDim.x) {
                const int rr = i / DCH, c = i - rr * DCH, row = r0 + rr;
                int v = 0;
                if (row < lim && c < w) {
                    const int e = col0 + c;
                    const uint32_t byte = base[cache_row(a, b, cb, row) * row_bytes + e % D2];
                    v = (int)(e < D2 ? byte & 0xFu : byte >> 4) - 8;
                }
                st[rr * L.hp + c] = (uint8_t)(int8_t)v;
            }
            return;
        }
        constexpr int ES = head_bytes(KIND, 1);  // bytes an element
        const int CHw = w * ES / CW, CHd = DCH * ES / CW;
        for (int i = tid; i < TRt * CHd; i += blockDim.x) {
            const int rr = i / CHd, c = i - rr * CHd, row = r0 + rr;
            const bool ok = row < lim && c < CHw;
            const uint8_t* src = a.kc;
            if (ok) src = base + cache_row(a, b, cb, row) * row_bytes + col0 * ES + c * CW;
            uint8_t* dst = st + rr * L.hp + c * CW;
            if (CW == 16) cp_async16_zfill(dst, src, ok ? 16 : 0);
            else if (CW == 8) cp_async8_zfill(dst, src, ok ? 8 : 0);
            else if (CW == 4) cp_async4_zfill(dst, src, ok ? 4 : 0);
            else if (CW == 2)
                *reinterpret_cast<uint16_t*>(dst) = ok ? *reinterpret_cast<const uint16_t*>(src) : 0;
            else *dst = ok ? *src : 0;
        }
    };
    // tile t's k scales (then its v scales): in its stage, or in the
    // streamed instance's two slots after the stages
    auto scale_at = [&](int t) {
        return reinterpret_cast<float*>(
            STREAM ? body + L.nst * L.stage + (t & 1) * 2 * TRt * 4
                   : stage_of(t) + 2 * TRt * L.hp);
    };
    // tile t's scales: thread tid < TRt loads its row's, parks them later
    auto scales_load = [&](int t, int lim, float& rk, float& rv) {
        rk = rv = 0.f;
        const int row = r_begin + t * TRt + tid;
        if (SCALED && tid < TRt && row < lim) {
            const size_t cr = cache_row(a, b, cb, row) * a.Hkv + kvh;
            rk = bf2f(a.ksc[cr]);
            rv = bf2f(a.vsc[cr]);
        }
    };
    // tile 0 while the position is read: every row of the split's first
    // tile inside the cache; rows past the history are cleared below
    const int lim0 = min(r_begin + a.rps, a.S);
    if (STREAM) issue_piece(0, lim0);
    else issue(0, lim0);
    cp_async_commit();
    float rk0, rv0;
    scales_load(0, lim0, rk0, rv0);
    const int pos = a.positions[b];
    // history rows < pos (K16: <= pos); pos < 0 reads every row
    const int n_hist = pos < 0 ? a.S : min(pos + a.inclusive, a.S);
    const int n_live = max(1, (n_hist + a.rps - 1) / a.rps);
    if (split >= n_live) {
        cp_async_wait<0>();
        return;
    }
    const int r_end = min(r_begin + a.rps, n_hist);
    const int ntiles = r_end > r_begin ? (r_end - r_begin + TRt - 1) / TRt : 0;
    auto scales_store = [&](int t, float rk, float rv) {
        const int row = r_begin + t * TRt + tid;
        if (SCALED && tid < TRt) {
            float* sc = scale_at(t);
            sc[tid] = row < r_end ? rk : 0.f;
            sc[TRt + tid] = row < r_end ? rv : 0.f;
        }
    };

    // this warp's running state: lane holds heads lane/4 (h 0) and lane/4 +
    // 8 (h 1); acc[nt] is the m16n8 fragment of output columns 8 nt..
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    float acc[DMAX / 8][4];
#pragma unroll
    for (int nt = 0; nt < DMAX / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    const int wr = warp * 16;  // this warp's rows of a tile

    const int Dp = L.Dp;
    // S (16 heads x 16 rows) += Q . K^T over one k step: Q's columns kq..
    // of the Q tile or piece qt, the rows' columns kk.. of the tile or
    // piece kt
    auto score_step = [&](const uint8_t* kt, const uint8_t* qt, const float* ksm,
                          int kq, int kk, float (&s)[2][4]) {
        uint32_t qa[4];
        ldmatrix_x4(qa, qt + (((lane >> 3) & 1) * 8 + (lane & 7)) * L.qp
                            + kq * 2 + (lane >> 4) * 16);
        if (KIND == BF16_ROWS) {
            uint32_t kb[4];
            ldmatrix_x4(kb, kt + (wr + (lane >> 4) * 8 + (lane & 7)) * L.hp
                                + kk * 2 + ((lane >> 3) & 1) * 16);
            const uint32_t b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
            mma16816(s[0], qa, b0);
            mma16816(s[1], qa, b1);
        } else {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int rr = wr + 8 * j + (lane >> 2);
                const uint8_t* row = kt + rr * L.hp;
                const int k = kk + (lane & 3) * 2;
                if (KIND == F32_ROWS) {
                    const float2 x0 = *reinterpret_cast<const float2*>(row + 4 * k);
                    const float2 x1 = *reinterpret_cast<const float2*>(row + 4 * k + 32);
                    uint32_t hi[2], lo[2];
                    split_bf16(x0.x, x0.y, hi[0], lo[0]);
                    split_bf16(x1.x, x1.y, hi[1], lo[1]);
                    mma16816(s[j], qa, hi);
                    mma16816(s[j], qa, lo);
                } else {
                    const float sk = KIND == Q8_VALUE ? ksm[rr] : 1.f;
                    const uint32_t kb[2] = {k_pair<PK>(row, k, D, sk),
                                            k_pair<PK>(row, k + 8, D, sk)};
                    mma16816(s[j], qa, kb);
                }
            }
        }
    };
    // tile t's scores s: the online softmax, then O (16 heads x this
    // chunk's columns) += P . V, V's column c0 + d at column cv + d of vt
    auto softmax_pv = [&](int t, float (&s)[2][4], const uint8_t* vt,
                          const float* ksm, const float* vsm, int cv) {
        // online softmax on the fragment: s[j][e] is head lane/4 + 8 (e / 2),
        // row wr + 8 j + 2 (lane % 4) + e % 2
        const int r0 = r_begin + t * TRt;
        float x[2][4];
        bool ok[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int rr = wr + 8 * j + (lane & 3) * 2 + (e & 1);
                ok[j][e] = r0 + rr < r_end;
                float v = SCORE_SIDE ? (s[j][e] * ksm[rr]) * a.scale : s[j][e] * a.scale;
                if (a.softcap > 0.f) v = a.softcap * tanhf(v / a.softcap);
                x[j][e] = v;
            }
        float p[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float mx = -1e30f;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 2 * h; e < 2 * h + 2; ++e)
                    if (ok[j][e]) mx = fmaxf(mx, x[j][e]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[h], mx);
            const float alpha = expf(m[h] - m_new);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 2 * h; e < 2 * h + 2; ++e) {
                    p[j][e] = ok[j][e] ? expf(x[j][e] - m_new) : 0.f;
                    ps += p[j][e];
                }
            ps += __shfl_xor_sync(0xffffffffu, ps, 1);
            ps += __shfl_xor_sync(0xffffffffu, ps, 2);
            l[h] = l[h] * alpha + ps;
            m[h] = m_new;
#pragma unroll
            for (int nt = 0; nt < DMAX / 8; ++nt) {
                acc[nt][2 * h] *= alpha;
                acc[nt][2 * h + 1] *= alpha;
            }
        }
        // P as the A operand (bf16 p; score-side kinds bf16(p * v_scale))
        uint32_t pa[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float p0 = p[j][2 * h], p1 = p[j][2 * h + 1];
                if (SCORE_SIDE) {
                    const int rr = wr + 8 * j + (lane & 3) * 2;
                    p0 *= vsm[rr];
                    p1 *= vsm[rr + 1];
                }
                pa[2 * j + h] = pack_bf16(p0, p1);
            }
#pragma unroll
        for (int np = 0; np < DMAX / 16; ++np) {
            if (np * 16 >= cw) break;
            const int cn = cv + np * 16;  // the column in vt's rows
            if (KIND == BF16_ROWS) {
                uint32_t vb[4];
                ldmatrix_x4_trans(vb, vt + (wr + ((lane >> 3) & 1) * 8 + (lane & 7)) * L.hp
                                          + (cn + (lane >> 4) * 8) * 2);
                const uint32_t b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
                mma16816(acc[2 * np], pa, b0);
                mma16816(acc[2 * np + 1], pa, b1);
            } else {
#pragma unroll
                for (int h2 = 0; h2 < 2; ++h2) {
                    const int nt = 2 * np + h2, d = cn + h2 * 8 + (lane >> 2);
                    const int rr = wr + (lane & 3) * 2;
                    float e4[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int r = rr + (i & 1) + 8 * (i >> 1);
                        e4[i] = v_elem<PK>(vt + r * L.hp, d, D,
                                           KIND == Q8_VALUE ? vsm[r] : 1.f);
                    }
                    if (KIND == F32_ROWS) {
                        uint32_t hi[2], lo[2];
                        split_bf16(e4[0], e4[1], hi[0], lo[0]);
                        split_bf16(e4[2], e4[3], hi[1], lo[1]);
                        mma16816(acc[nt], pa, hi);
                        mma16816(acc[nt], pa, lo);
                    } else {
                        const uint32_t vb[2] = {pack_bf16(e4[0], e4[1]),
                                                pack_bf16(e4[2], e4[3])};
                        mma16816(acc[nt], pa, vb);
                    }
                }
            }
        }
    };
    auto compute = [&](int t) {
        const uint8_t* kt = stage_of(t);
        const float* ksm = scale_at(t);
        float s[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        // unrolled up to D = 512
#pragma unroll (DK <= 512 ? DK / 16 : 1)
        for (int ks = 0; ks < DK / 16; ++ks) {
            if (ks >= Dp / 16) break;
            score_step(kt, qs, ksm, ks * 16, ks * 16, s);
        }
        softmax_pv(t, s, kt + TRt * L.hp, ksm, ksm + TRt, c0);
    };

    // the tile loop: with two stages tile t + 1 is copied during tile t;
    // the streamed instance's loop runs over the pieces, the scores of a
    // tile accumulating in ss over its K pieces
    scales_store(0, rk0, rv0);
    if constexpr (STREAM) {
        float ss[2][4];
        const int NU = ntiles * NPC;
        for (int u = 0; u < NU; ++u) {
            const int t = u / NPC, j = u - t * NPC;
            const bool ahead = L.nst == 2 && u + 1 < NU;
            const bool next_tile = (u + 1) % NPC == 0;  // piece u + 1 opens t + 1
            float rk = 0.f, rv = 0.f;
            if (ahead) {
                issue_piece(u + 1, r_end);
                cp_async_commit();
                if (next_tile) scales_load(t + 1, r_end, rk, rv);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            if (wr < TRt) {  // a 32- or 16-row tile: the first warps
                const uint8_t* pt = body + (u % L.nst) * L.stage;
                const float* ksm = scale_at(t);
                if (j < NKP) {
                    if (j == 0) {
#pragma unroll
                        for (int i = 0; i < 2; ++i)
#pragma unroll
                            for (int e = 0; e < 4; ++e) ss[i][e] = 0.f;
                    }
#pragma unroll
                    for (int ks = 0; ks < DCH / 16; ++ks) {
                        if (j * DCH + ks * 16 >= Dp) break;
                        score_step(pt, pt + TRt * L.hp, ksm, ks * 16, ks * 16, ss);
                    }
                } else {
                    softmax_pv(t, ss, pt, ksm, ksm + TRt, 0);
                }
            }
            if (ahead && next_tile) scales_store(t + 1, rk, rv);
            __syncthreads();
            if (L.nst == 1 && u + 1 < NU) {
                issue_piece(u + 1, r_end);
                cp_async_commit();
                if (next_tile) {
                    scales_load(t + 1, r_end, rk, rv);
                    scales_store(t + 1, rk, rv);
                }
            }
        }
    } else {
        for (int t = 0; t < ntiles; ++t) {
            const bool ahead = L.nst == 2 && t + 1 < ntiles;
            float rk = 0.f, rv = 0.f;
            if (ahead) {
                issue(t + 1, r_end);
                cp_async_commit();
                scales_load(t + 1, r_end, rk, rv);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            if (t == 0 && r_begin + TRt > r_end) {  // V rows past the history: 0
                uint8_t* vt = stage_of(0) + TRt * L.hp;
                const int n8 = L.hp / 8;  // hp is a multiple of 8
                for (int i = (r_end - r_begin) * n8 + tid; i < TRt * n8; i += blockDim.x)
                    *reinterpret_cast<uint2*>(vt + 8 * i) = make_uint2(0, 0);
                __syncthreads();
            }
            if (wr < TRt) compute(t);  // a 32-row tile: warps 0 and 1
            if (ahead) scales_store(t + 1, rk, rv);
            __syncthreads();
            if (L.nst == 1 && t + 1 < ntiles) {
                issue(t + 1, r_end);
                cp_async_commit();
                scales_load(t + 1, r_end, rk, rv);
                scales_store(t + 1, rk, rv);
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    // this split's partial: the computing warps' (max, sum, acc) combined
    // in warp order, into the scratch, or kept here when it is the only
    // split (the other warps took no rows: they add nothing)
    const int NWA = L.nwa;
    float* ow = reinterpret_cast<float*>(body);  // (NWA, 16, DC)
    float* wml = ow + NWA * GB * DC;             // (NWA, 16, 2)
    float* lacc = wml + NWA * GB * 2;            // (16, DC): a lone split's
    float* lml = lacc + GB * DC;                 // (16, 2)
    const bool lone = n_live == 1;
    if (warp < NWA) {
        const int g = lane >> 2;
        if ((lane & 3) == 0) {
            wml[(warp * GB + g) * 2] = m[0];
            wml[(warp * GB + g) * 2 + 1] = l[0];
            wml[(warp * GB + g + 8) * 2] = m[1];
            wml[(warp * GB + g + 8) * 2 + 1] = l[1];
        }
#pragma unroll
        for (int nt = 0; nt < DMAX / 8; ++nt) {
            if (nt * 8 >= cw) break;
            const int d = nt * 8 + (lane & 3) * 2;
#pragma unroll
            for (int e = 0; e < 2; ++e)
                if (d + e < cw) {
                    ow[(warp * GB + g) * DC + d + e] = acc[nt][e];
                    ow[(warp * GB + g + 8) * DC + d + e] = acc[nt][2 + e];
                }
        }
    }
    __syncthreads();
    const size_t pbase = (size_t)unit * gridDim.y;
    float* const pacc = lone ? lacc : a.part_acc + pbase * GB * DC;
    float* const pml = lone ? lml : a.part_ml + pbase * GB * 2;
    for (int i = tid; i < Gb * cw; i += blockDim.x) {
        const int g = i / cw, d = i - g * cw;
        float mm = -1e30f;
        for (int w = 0; w < NWA; ++w) mm = fmaxf(mm, wml[(w * GB + g) * 2]);
        float sacc = 0.f;
        for (int w = 0; w < NWA; ++w)
            sacc += ow[(w * GB + g) * DC + d] * expf(wml[(w * GB + g) * 2] - mm);
        const size_t part = (size_t)split * GB + g;
        pacc[part * DC + d] = sacc;
        if (d == 0) {
            float ll = 0.f;
            for (int w = 0; w < NWA; ++w)
                ll += wml[(w * GB + g) * 2 + 1] * expf(wml[(w * GB + g) * 2] - mm);
            pml[part * 2] = mm;
            pml[part * 2 + 1] = ll;
        }
    }
    // the last live split of this head group to finish merges (a lone
    // split at once, from shared memory)
    __shared__ int last;
    if (!lone) __threadfence();
    __syncthreads();
    if (tid == 0) last = lone || atomicAdd(&a.tickets[unit], 1) == n_live - 1;
    __syncthreads();
    if (!last) return;
    if (!lone) {
        __threadfence();
        if (tid == 0) a.tickets[unit] = 0;
    }
    // partials: read from the scratch bypassing L1 (other blocks wrote
    // them), or from here

    float* fct = lml + GB * 2;                            // (MAXNS, 16)
    float* fsum = fct + MAXNS * GB;                       // (MAXNS, 16)
    float* mml = fsum + MAXNS * GB;                       // (16, 2)
    float* newv = mml + GB * 2;                           // (2, D)
    int* code = reinterpret_cast<int*>(newv + 2 * D);     // (2, D)
    // the streamed instance keeps no newv and no codes: it recomputes them
    float* sself = STREAM ? mml + GB * 2 : reinterpret_cast<float*>(code + 2 * D);  // (16)
    float* amax = sself + GB;                             // (2)
    // every split's (max, sum) in one round of loads, then its factor
    for (int i = tid; i < n_live * Gb; i += blockDim.x) {
        const int sp = i / Gb, g = i - sp * Gb;
        const float2* p = reinterpret_cast<const float2*>(&pml[((size_t)sp * GB + g) * 2]);
        const float2 ml = lone ? *p : __ldcg(p);
        fct[sp * GB + g] = ml.x;
        fsum[sp * GB + g] = ml.y;
    }
    __syncthreads();
    for (int g = warp; g < Gb; g += NW) {
        float mm = -1e30f;
        for (int sp = lane; sp < n_live; sp += 32) mm = fmaxf(mm, fct[sp * GB + g]);
        mm = warp_max(mm);
        float ll = 0.f;
        for (int sp = lane; sp < n_live; sp += 32) {
            const float f = expf(fct[sp * GB + g] - mm);
            fct[sp * GB + g] = f;
            ll += fsum[sp * GB + g] * f;
        }
        ll = warp_sum(ll);
        if (lane == 0) {
            mml[g * 2] = mm;
            mml[g * 2 + 1] = ll;
        }
    }
    // this step's k and v rows: in shared memory, or (streamed) in global
    const size_t noff = ((size_t)b * a.Hkv + kvh) * D;
    const __nv_bfloat16* kn = STREAM ? (self ? a.knew + noff : nullptr)
                                     : reinterpret_cast<const __nv_bfloat16*>(nrow);
    const __nv_bfloat16* vn = STREAM ? (self ? a.vnew + noff : nullptr) : kn + D;
    constexpr float QMAX = KIND == Q4_SCORE ? 7.f : 127.f;
    // element i of the new (k, v) rows, 0 <= i < 2 D: as this step gives it
    // (raw), its code in a quantized row (code_of), and as the cache will
    // hold it (nv)
    auto raw = [&](int i) { return STREAM ? bf2f(i < D ? kn[i] : vn[i - D]) : newv[i]; };
    auto code_of = [&](int i) {
        const float sc = amax[i / D] / QMAX;
        const float inv = sc > 0.f ? 1.f / sc : 0.f;
        float c = rintf(__fmul_rn(raw(i), inv));
        if (KIND == Q4_SCORE) c = fminf(fmaxf(c, -8.f), 7.f);
        return c;
    };
    auto nv = [&](int i) {
        if (!STREAM) return newv[i];
        if (!SCALED) return raw(i);
        return bf2f(f2bf(__fmul_rn(code_of(i), bf2f(f2bf(amax[i / D] / QMAX)))));
    };
    if (self) {  // the new row as the cache will hold it, and its self scores
        if (!STREAM) {
            for (int d = tid; d < D; d += blockDim.x) {
                newv[d] = bf2f(kn[d]);
                newv[D + d] = bf2f(vn[d]);
            }
            __syncthreads();
        }
        if (SCALED) {
            if (warp < 2) {  // warp 0: k's amax, warp 1: v's
                float am = 0.f;
                for (int d = lane; d < D; d += 32) am = fmaxf(am, fabsf(raw(warp * D + d)));
                am = warp_max(am);
                if (lane == 0) amax[warp] = am;
            }
            __syncthreads();
            for (int i = tid; i < 2 * D && !STREAM; i += blockDim.x) {
                const float c = code_of(i);
                code[i] = (int)c;
                newv[i] = bf2f(f2bf(__fmul_rn(c, bf2f(f2bf(amax[i / D] / QMAX)))));
            }
            __syncthreads();
        }
        for (int g = warp; g < Gb; g += NW) {
            const __nv_bfloat16* qg = STREAM ? qh + (size_t)g * D
                                             : reinterpret_cast<const __nv_bfloat16*>(qs + g * L.qp);
            float sc = 0.f;
            for (int d = lane; d < D; d += 32) sc += bf2f(qg[d]) * nv(d);
            sc = warp_sum(sc) * a.scale;
            if (a.softcap > 0.f) sc = a.softcap * tanhf(sc / a.softcap);
            if (lane == 0) sself[g] = sc;
        }
    }
    __syncthreads();
    // the output of column d of head g from its summed partials
    auto finish = [&](int g, int d, float sacc) {
        const float mm = mml[g * 2], ll = mml[g * 2 + 1];
        if (!self) return sacc / ll;
        const float ss = sself[g];
        const float m_new = fmaxf(mm, ss);
        const float alpha = expf(mm - m_new);
        const float p_self = expf(ss - m_new);
        return (sacc * alpha + p_self * nv(D + c0 + d)) / (ll * alpha + p_self);
    };
    float* const outg = a.out + (((size_t)b * a.Hkv + kvh) * a.G + g0) * D + c0;
    if (D % 4 == 0) {
        // four output columns a thread: the partials' float4 loads of all
        // splits in flight together, summed in split order
        const int C4 = cw / 4;
        for (int i = tid; i < Gb * C4; i += blockDim.x) {
            const int g = i / C4, d = 4 * (i - g * C4);
            float sacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
            for (int sp = 0; sp < n_live; ++sp) {
                const float4* p = reinterpret_cast<const float4*>(&pacc[((size_t)sp * GB + g) * DC + d]);
                const float4 v = lone ? *p : __ldcg(p);
                const float f = fct[sp * GB + g];
                sacc[0] += v.x * f;
                sacc[1] += v.y * f;
                sacc[2] += v.z * f;
                sacc[3] += v.w * f;
            }
            *reinterpret_cast<float4*>(&outg[(size_t)g * D + d]) =
                make_float4(finish(g, d, sacc[0]), finish(g, d + 1, sacc[1]),
                            finish(g, d + 2, sacc[2]), finish(g, d + 3, sacc[3]));
        }
    } else {  // one column a thread, in the same split order
        for (int i = tid; i < Gb * cw; i += blockDim.x) {
            const int g = i / cw, d = i - g * cw;
            float sacc = 0.f;
            for (int sp = 0; sp < n_live; ++sp) {
                const float* p = &pacc[((size_t)sp * GB + g) * DC + d];
                sacc += (lone ? *p : __ldcg(p)) * fct[sp * GB + g];
            }
            outg[(size_t)g * D + d] = finish(g, d, sacc);
        }
    }
    // the cache row, once per kv head (head group 0, chunk 0)
    if (!self || hg != 0 || cc != 0 || pos < 0 || pos >= a.S) return;
    const size_t r = cache_row(a, b, cb, pos);
    if (KIND == F32_ROWS) {  // the bf16 row, widened
        float* kr = reinterpret_cast<float*>(a.kc) + r * a.Hkv * D + (size_t)kvh * D;
        float* vr = reinterpret_cast<float*>(a.vc) + r * a.Hkv * D + (size_t)kvh * D;
        for (int d = tid; d < D; d += blockDim.x) {
            kr[d] = bf2f(kn[d]);
            vr[d] = bf2f(vn[d]);
        }
        return;
    }
    if (KIND == BF16_ROWS) {
        __nv_bfloat16* kr = reinterpret_cast<__nv_bfloat16*>(a.kc) + r * a.Hkv * D + (size_t)kvh * D;
        __nv_bfloat16* vr = reinterpret_cast<__nv_bfloat16*>(a.vc) + r * a.Hkv * D + (size_t)kvh * D;
        for (int d = tid; d < D; d += blockDim.x) {
            kr[d] = kn[d];
            vr[d] = vn[d];
        }
        return;
    }
    auto cd = [&](int i) { return STREAM ? (int)code_of(i) : code[i]; };
    if (KIND == Q4_SCORE) {  // plane-split: byte i = code i | code i+D/2 << 4
        const int D2 = D / 2;
        for (int i = tid; i < 2 * D2; i += blockDim.x) {
            const int w = i / D2, j = i % D2;
            uint8_t* dst = (w == 0 ? a.kc : a.vc) + r * a.Hkv * D2 + (size_t)kvh * D2;
            dst[j] = (uint8_t)((cd(w * D + j) + 8) | ((cd(w * D + j + D2) + 8) << 4));
        }
    } else {
        for (int i = tid; i < 2 * D; i += blockDim.x) {
            const int w = i / D, d = i % D;
            int8_t* dst = reinterpret_cast<int8_t*>(w == 0 ? a.kc : a.vc)
                          + r * a.Hkv * D + (size_t)kvh * D;
            dst[d] = (int8_t)cd(i);
        }
    }
    if (tid < 2) (tid == 0 ? a.ksc : a.vsc)[r * a.Hkv + kvh] = f2bf(amax[tid] / QMAX);
}

template <int KIND, int DMAX, int DK>
static cudaError_t launch_dmax(const Args& a, int nsplit, cudaStream_t st) {
    static int allowed = 48 * 1024;  // dynamic shared memory allowed so far
    const int bytes = Plan(KIND, a.D).total;
    if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
    if (bytes > allowed) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_decode_kernel<KIND, DMAX, DK>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return e;
        allowed = bytes;
    }
    dim3 grid(a.B * a.Hkv * a.NG * a.NC, nsplit);
    flash_decode_kernel<KIND, DMAX, DK><<<grid, NW * 32, bytes, st>>>(a);
    return cudaGetLastError();
}

template <int KIND>
static cudaError_t launch_kind(const Args& a, int nsplit, cudaStream_t st) {
    const int Dp = (a.D + 15) & ~15;  // the padded head_dim bounds DMAX
#if FD_WIDE
    if (Dp <= 256) return cudaErrorInvalidValue;  // the other library's
    if (Dp <= 512) return launch_dmax<KIND, 512, 512>(a, nsplit, st);
    return launch_dmax<KIND, DCH, DSTREAM>(a, nsplit, st);
#else
    if (Dp <= 64) return launch_dmax<KIND, 64, 64>(a, nsplit, st);
    if (Dp <= 128) return launch_dmax<KIND, 128, 128>(a, nsplit, st);
    if (Dp <= 256) return launch_dmax<KIND, 256, 256>(a, nsplit, st);
    return cudaErrorInvalidValue;  // the wide library's
#endif
}

static cudaError_t launch_flash_decode(
        int kind, const void* q, const void* knew, const void* vnew, void* kc,
        void* vc, void* ksc, void* vsc, const void* positions, const void* tab,
        const void* li, int MP, int P, int NP, void* out, void* part_acc,
        void* part_ml, void* tickets, int B, int S, int H, int Hkv, int D,
        int nsplit, int rows_per_split, float scale, float softcap,
        cudaStream_t st) {
    if (Hkv <= 0 || H % Hkv || D < 1 || (kind == Q4_SCORE && D % 2)
        || nsplit < 1
        || nsplit > MAXNS || rows_per_split % TR
        || (long long)nsplit * rows_per_split < S)
        return cudaErrorInvalidValue;
    Args a;
    a.q = (const __nv_bfloat16*)q;
    a.knew = (const __nv_bfloat16*)knew;
    a.vnew = (const __nv_bfloat16*)vnew;
    a.kc = (uint8_t*)kc;
    a.vc = (uint8_t*)vc;
    a.ksc = (__nv_bfloat16*)ksc;
    a.vsc = (__nv_bfloat16*)vsc;
    a.positions = (const int*)positions;
    a.tab = (const int*)tab;
    a.li = (const int*)li;
    a.part_acc = (float*)part_acc;
    a.part_ml = (float*)part_ml;
    a.tickets = (int*)tickets;
    a.out = (float*)out;
    a.MP = MP;
    a.P = P;
    a.NP = NP;
    a.B = B;
    a.S = S;
    a.Hkv = Hkv;
    a.G = H / Hkv;
    a.D = D;
    a.NG = (a.G + GB - 1) / GB;
    a.NC = (D + chunk_cols(D) - 1) / chunk_cols(D);
    a.rps = rows_per_split;
    a.inclusive = knew == nullptr;  // K16 attends row pos itself
    a.scale = scale;
    a.softcap = softcap;
    switch (kind) {
        case BF16_ROWS: return launch_kind<BF16_ROWS>(a, nsplit, st);
        case Q8_VALUE: return launch_kind<Q8_VALUE>(a, nsplit, st);
        case Q8_SCORE: return launch_kind<Q8_SCORE>(a, nsplit, st);
        case Q4_SCORE: return launch_kind<Q4_SCORE>(a, nsplit, st);
        case F32_ROWS: return launch_kind<F32_ROWS>(a, nsplit, st);
    }
    return cudaErrorInvalidValue;
}

// Scratch of every entry point, for B sequences of Hkv kv heads with NG =
// ceil(H / Hkv / 16) head groups and NC = ceil(D / DC) column chunks of DC
// = chunk_cols(D) columns (units = B * Hkv * NG * NC): part_acc (units,
// nsplit, 16, DC) and part_ml (units, nsplit, 16, 2) f32, tickets (units,)
// int32, zero before the first call (each call leaves them at zero).

// K5 (li null) and K17c. q (B, H, D), knew/vnew (B, Hkv, D) bf16; kc/vc
// (N, S, Hkv*D) bf16 (kind 0) or f32 (kind 4), N = B, or L * B for K17c,
// whose sequence b is row li[0] * B + b; positions (B,) int32; out (B, H,
// D) f32.
KCPP_API int k5_flash_decode(int kind, const void* q, const void* knew,
                             const void* vnew, void* kc, void* vc,
                             const void* positions, const void* li,
                             void* out, void* part_acc, void* part_ml,
                             void* tickets, int B, int S, int H, int Hkv,
                             int D, int nsplit, int rows_per_split,
                             float scale, float softcap, void* stream) {
    if (kind != BF16_ROWS && kind != F32_ROWS)
        return (int)cudaErrorInvalidValue;
    return (int)launch_flash_decode(
        kind, q, knew, vnew, kc, vc, nullptr, nullptr, positions, nullptr,
        li, 0, 1, 1, out, part_acc, part_ml, tickets, B, S, H, Hkv, D,
        nsplit, rows_per_split, scale, softcap, (cudaStream_t)stream);
}

// K16. q (H, D) bf16, kc/vc (S, Hkv*D) bf16, pos (1,) int32; out (H, D)
// f32 over the rows <= pos (all S when pos >= S); nothing is written.
KCPP_API int k16_flash_decode(const void* q, const void* kc, const void* vc,
                              const void* pos, void* out, void* part_acc,
                              void* part_ml, void* tickets, int S, int H,
                              int Hkv, int D, int nsplit, int rows_per_split,
                              float scale, float softcap, void* stream) {
    return (int)launch_flash_decode(
        BF16_ROWS, q, nullptr, nullptr, (void*)kc, (void*)vc, nullptr,
        nullptr, pos, nullptr, nullptr, 0, 1, 1, out, part_acc, part_ml,
        tickets, 1, S, H, Hkv, D, nsplit, rows_per_split, scale, softcap,
        (cudaStream_t)stream);
}

// K6. As K5, with kc/vc (B, S, Hkv*D) int8 and ksc/vsc (B, S, Hkv) bf16.
KCPP_API int k6_flash_decode_q8(const void* q, const void* knew,
                                const void* vnew, void* kc, void* vc,
                                void* ksc, void* vsc, const void* positions,
                                void* out, void* part_acc, void* part_ml,
                                void* tickets, int B, int S, int H, int Hkv,
                                int D, int nsplit, int rows_per_split,
                                float scale, float softcap, void* stream) {
    return (int)launch_flash_decode(
        Q8_VALUE, q, knew, vnew, kc, vc, ksc, vsc, positions, nullptr,
        nullptr, 0, 1, 1, out, part_acc, part_ml, tickets, B, S, H, Hkv, D,
        nsplit, rows_per_split, scale, softcap, (cudaStream_t)stream);
}

// K8 (kind 0), K9 (kind 2), K10 (kind 3). As K5, with kc/vc the
// (NP*P, Hkv*D) bf16 | int8 or (NP*P, Hkv*D/2) uint8 pools, ksc/vsc the
// (NP*P, Hkv) bf16 scales (null for K8) and tab the (B, MP) int32 page
// table; S = MP * P.
KCPP_API int k8_flash_decode_paged(int kind, const void* q, const void* knew,
                                   const void* vnew, void* kc, void* vc,
                                   void* ksc, void* vsc, const void* tab,
                                   const void* positions, void* out,
                                   void* part_acc, void* part_ml,
                                   void* tickets, int B, int MP, int P,
                                   int NP, int H, int Hkv, int D, int nsplit,
                                   int rows_per_split, float scale,
                                   float softcap, void* stream) {
    if (kind != BF16_ROWS && kind != Q8_SCORE && kind != Q4_SCORE)
        return (int)cudaErrorInvalidValue;
    return (int)launch_flash_decode(
        kind, q, knew, vnew, kc, vc, ksc, vsc, positions, tab, nullptr, MP,
        P, NP, out, part_acc, part_ml, tickets, B, MP * P, H, Hkv, D, nsplit,
        rows_per_split, scale, softcap, (cudaStream_t)stream);
}
