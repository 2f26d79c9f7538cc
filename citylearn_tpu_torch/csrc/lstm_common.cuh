// The stacked-LSTM pieces shared by the kernels that predict an indoor
// temperature (K5 lstm_episode.cu, the neighborhood post-pass
// neighborhood_postpass.cu): the gate activations, the cell's state update
// and the columns of the per-building metadata.
//
// Both kernels read the weights as ops/lstm.py::pack_weights lays them out
// (input by input: column k of [W_ih | W_hh] holds the 4H gate rows of
// input k, torch's order i, f, g, o) and both split layer 1's gate sums in
// two: the static channels' products with the bias, once per building and
// row of the static stream, into a ring in shared memory; and, per window
// position, the dynamic channels' and the hidden vector's products. The
// gate products are explicit fused multiply-adds and the activations use
// the hardware's exp2 and reciprocal, so the results agree with the plain
// PyTorch versions to a tolerance, not to the bit.

#pragma once

#include <cuda_runtime.h>

namespace lstm {

constexpr int MAX_H = 64;   // ops/lstm.py MAX_HIDDEN
constexpr int MAX_F = 32;   // ops/lstm.py MAX_CHANNELS

namespace meta {
// columns of LstmWeights.meta (B, N_META), as ops/lstm.py names them
enum Meta { M_LAYERS, M_HIDDEN, M_CHANNELS, M_TEMP_CH, M_COOL_CH, M_X_OFF, M_W_OFF, M_HEAT_CH,
            N_META };
}  // namespace meta

// the hardware's 2^x and 1/x with subnormals flushed to zero: one
// special-function instruction each, where __expf and __fdividef add the
// rescaling of subnormal inputs around them; on the activations below the
// flush moves no result (1 + 2^x >= 1)
__device__ __forceinline__ float ex2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ float rcp_ftz(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float sigmoidf(float x) {
    return rcp_ftz(1.f + ex2_ftz(-LOG2E * x));
}
// 1 - 2 / (1 + e^2x): exact limits at both ends, absolute error of a few
// 1e-7 near 0, where only the absolute error reaches the gate products
__device__ __forceinline__ float tanh_fast(float x) {
    return 1.f - 2.f * rcp_ftz(1.f + ex2_ftz(2.f * LOG2E * x));
}

// sigmoid(x), or tanh(x) = 2 sigmoid(2x) - 1 where tanh_gate: one exp and
// one reciprocal either way, so that the lanes of a warp that hold the four
// gates of a unit run one instruction stream
__device__ __forceinline__ float gate_act(float x, bool tanh_gate) {
    const float s = sigmoidf(tanh_gate ? 2.f * x : x);
    return tanh_gate ? 2.f * s - 1.f : s;
}

// c' = f c + i g; returns h' = o tanh(c'), the activated gates given
__device__ __forceinline__ float cell_update(float i, float f, float g, float o, float& c) {
    c = f * c + i * g;
    return o * tanh_fast(c);
}

// sum_k w[k] v[k], k < n, in four interleaved partial sums added pairwise:
// w a register array (n = N known at compile time, v 16-byte aligned), else
// read from global memory at w_g[k * stride]
template <int N>
__device__ __forceinline__ float dot(const float* w, const float* __restrict__ w_g, int stride,
                                     int n, const float* v) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    if constexpr (N > 0) {
#pragma unroll
        for (int k = 0; k < N; k += 4) {
            const float4 x = *reinterpret_cast<const float4*>(v + k);
            s0 = __fmaf_rn(w[k], x.x, s0);
            s1 = __fmaf_rn(w[k + 1], x.y, s1);
            s2 = __fmaf_rn(w[k + 2], x.z, s2);
            s3 = __fmaf_rn(w[k + 3], x.w, s3);
        }
    } else {
        int k = 0;
        for (; k + 4 <= n; k += 4) {
            s0 = __fmaf_rn(__ldg(w_g + k * stride), v[k], s0);
            s1 = __fmaf_rn(__ldg(w_g + (k + 1) * stride), v[k + 1], s1);
            s2 = __fmaf_rn(__ldg(w_g + (k + 2) * stride), v[k + 2], s2);
            s3 = __fmaf_rn(__ldg(w_g + (k + 3) * stride), v[k + 3], s3);
        }
        for (; k < n; ++k) s0 = __fmaf_rn(__ldg(w_g + k * stride), v[k], s0);
    }
    return (s0 + s1) + (s2 + s3);
}

}  // namespace lstm
