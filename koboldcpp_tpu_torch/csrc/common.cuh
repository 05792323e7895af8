// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every entry point is a plain `extern "C"` function that launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define KCPP_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

__device__ __forceinline__ __nv_bfloat16 f2bf(float v) {
    return __float2bfloat16_rn(v);
}

// reductions over aligned groups of `width` lanes (width a power of two <= 32)
__device__ __forceinline__ float group_sum(float v, int width) {
    for (int o = width >> 1; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float group_max(float v, int width) {
    for (int o = width >> 1; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) { return group_sum(v, 32); }

// bits 0..3 of b -> bit 0 of bytes 0..3 (a q5_k 5th-bit nibble to a byte
// mask)
__device__ __forceinline__ uint32_t spread4(uint32_t b) {
    return ((b & 0xFu) * 0x00204081u) & 0x01010101u;
}
__device__ __forceinline__ float warp_max(float v) { return group_max(v, 32); }

// word i (0..3) of v
__device__ __forceinline__ uint32_t u4_at(const uint4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// element e (0..7) of eight packed bf16 as f32
__device__ __forceinline__ float bf_at(const uint4& v, int e) {
    const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
    return __uint_as_float(e & 1 ? (w & 0xFFFF0000u) : (w << 16));
}

// The bf16-rounded f32 sums of x per group of G consecutive columns (the
// port of `_group_sums`), for the bf16-x bodies of K1 / K7. One thread per
// element; n is a multiple of 32, so every group lies within a warp.
template <int G>
__global__ void group_sums_kernel(const __nv_bfloat16* __restrict__ x,
                                  __nv_bfloat16* __restrict__ xsum, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    float v = i < n ? bf2f(x[i]) : 0.f;
    float s = group_sum(v, G);             // shuffles before any lane exits
    if (i < n && (threadIdx.x & (G - 1)) == 0) xsum[i / G] = f2bf(s);
}

template <int G>
static cudaError_t launch_group_sums(const void* x, void* xsum, int n,
                                     cudaStream_t stream) {
    group_sums_kernel<G><<<(n + 255) / 256, 256, 0, stream>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)xsum, n);
    return cudaGetLastError();
}

// K17a / K17b, the layer-stacked matvecs of the scan decode path: the
// weight fields of a stacked QTensor carry a leading layer axis; every block
// reads the layer index li[0] from device memory (as the TPU kernel takes
// it by scalar prefetch, so a captured launch can point at a device
// counter) and offsets weight field i by li[0] * n[i] elements. li null:
// the fields are one layer's (K1, K2, K12).
struct Stacked {
    const int* li;
    long long n[5];
    template <typename T>
    __device__ __forceinline__ const T* at(const T* p, int i) const {
        return li != nullptr && p != nullptr
                   ? p + (size_t)li[0] * (size_t)n[i] : p;
    }
};

#define STACKED_PARAMS const void *li, long long n0, long long n1, \
        long long n2, long long n3, long long n4
#define STACKED_ARG Stacked{(const int*)li, {n0, n1, n2, n3, n4}}

KCPP_API const char* kcpp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
