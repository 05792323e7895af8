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
__device__ __forceinline__ float warp_max(float v) { return group_max(v, 32); }

// Activation prep for the T=1 matvecs (the port of `_i8_prep` and
// `_group_sums`): per group of G consecutive columns of x, the bf16-rounded
// f32 sum, and (quant != 0) the int8 codes rint(x * (127 / amax)) with
// amax clamped at 1e-20 and the f32 scale amax / 127. One thread per
// element; in_f is a multiple of 32, so every group lies within a warp.
template <int G>
__global__ void act_prep_kernel(const __nv_bfloat16* __restrict__ x,
                                int8_t* __restrict__ xq,
                                float* __restrict__ sx,
                                __nv_bfloat16* __restrict__ xsum,
                                int in_f, int quant) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    float v = i < in_f ? bf2f(x[i]) : 0.f;
    float s = group_sum(v, G);             // shuffles before any lane exits
    float a = fmaxf(group_max(fabsf(v), G), 1e-20f);
    if (i >= in_f) return;
    int lane_in_group = threadIdx.x & (G - 1);
    if (lane_in_group == 0) xsum[i / G] = f2bf(s);
    if (quant) {
        float inv = 127.0f / a;
        xq[i] = (int8_t)(int)rintf(v * inv);
        if (lane_in_group == 0) sx[i / G] = a / 127.0f;
    }
}

template <int G>
static cudaError_t launch_act_prep(const void* x, void* xq, void* sx,
                                   void* xsum, int in_f, int quant,
                                   cudaStream_t stream) {
    act_prep_kernel<G><<<(in_f + 255) / 256, 256, 0, stream>>>(
        (const __nv_bfloat16*)x, (int8_t*)xq, (float*)sx,
        (__nv_bfloat16*)xsum, in_f, quant);
    return cudaGetLastError();
}

KCPP_API const char* kcpp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
