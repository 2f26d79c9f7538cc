// The stacked-LSTM pieces shared by the kernels that predict an indoor
// temperature (K5 lstm_episode.cu, the neighborhood post-pass
// neighborhood_postpass.cu): the gate activations, one LSTM cell over the
// weights as ops/lstm.py::pack_weights lays them out, the linear head, and
// the columns of the per-building metadata.
//
// The gate products are explicit fused multiply-adds and the activations
// use the hardware's exp2 and reciprocal, so the results agree with the
// plain PyTorch versions to a tolerance, not to the bit.

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

__device__ __forceinline__ float sigmoidf(float x) {
    return __fdividef(1.f, 1.f + __expf(-x));
}
// 1 - 2 / (1 + e^2x): exact limits at both ends, absolute error of a few
// 1e-7 near 0, where only the absolute error reaches the gate products
__device__ __forceinline__ float tanh_fast(float x) {
    return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}

// One LSTM cell: gates = W_ih x + W_hh h + b in torch's order i, f, g, o;
// c' = f c + i g; h' = o tanh(c'). `cols` holds the weights input by
// input: for each of the in_p entries of x and then each of the h_p entries
// of h, the 4H weights of that entry (its column of [W_ih | W_hh]), so that
// one input value feeds 4H independent multiply-adds, whose weights every
// lane of the warp reads from one address, 16 bytes at a time. Each gate
// row accumulates its bias, then x in order, then h in order. Updates c in
// place and writes h' to hnew (h is read until the last product).
// HC and INC are the hidden size and input width where the caller knows
// them at compile time, 0 where they come at run time. UNROLL unrolls the
// loop over the inputs too (the 4H rows always unroll, so that the sums
// stay in registers where HC is known).
template <int HC, int INC, bool UNROLL = true>
__device__ __forceinline__ void lstm_cell(const float* __restrict__ cols,
                                          const float* __restrict__ bias, int H_, int in_p_,
                                          int h_p_, const float* xin, const float* h, float* c,
                                          float* hnew) {
    const int H = HC > 0 ? HC : H_;
    const int in_p = INC > 0 ? INC : in_p_;
    const int h_p = HC > 0 ? HC : h_p_;
    constexpr int ACC = 4 * (HC > 0 ? HC : MAX_H);
    float acc[ACC];
    const float4* b4 = reinterpret_cast<const float4*>(bias);
    const float4* w4 = reinterpret_cast<const float4*>(cols);
#pragma unroll
    for (int r = 0; r < H; ++r) {                 // 4H rows = H groups of 4
        const float4 q = __ldg(b4 + r);
        acc[4 * r + 0] = q.x;
        acc[4 * r + 1] = q.y;
        acc[4 * r + 2] = q.z;
        acc[4 * r + 3] = q.w;
    }
    auto input = [&](int k) {
        const float v = k < in_p ? xin[k] : h[k - in_p];
#pragma unroll
        for (int r = 0; r < H; ++r) {
            const float4 q = __ldg(w4 + k * H + r);
            acc[4 * r + 0] = __fmaf_rn(q.x, v, acc[4 * r + 0]);
            acc[4 * r + 1] = __fmaf_rn(q.y, v, acc[4 * r + 1]);
            acc[4 * r + 2] = __fmaf_rn(q.z, v, acc[4 * r + 2]);
            acc[4 * r + 3] = __fmaf_rn(q.w, v, acc[4 * r + 3]);
        }
    };
    if constexpr (UNROLL) {
#pragma unroll
        for (int k = 0; k < in_p + h_p; ++k) input(k);
    } else {
#pragma unroll 1
        for (int k = 0; k < in_p + h_p; ++k) input(k);
    }
#pragma unroll
    for (int j = 0; j < H; ++j) {
        const float cn = sigmoidf(acc[H + j]) * c[j]
            + sigmoidf(acc[j]) * tanh_fast(acc[2 * H + j]);
        c[j] = cn;
        hnew[j] = sigmoidf(acc[3 * H + j]) * tanh_fast(cn);
    }
}

// bias + sum_j w[j] * h[j] over the padded hidden vector: the linear head
template <int HC>
__device__ __forceinline__ float head(const float* __restrict__ w, const float* h, int h_p,
                                      float bias) {
    const int n = HC > 0 ? HC : h_p;
    float acc = bias;
#pragma unroll
    for (int j = 0; j < n; ++j) acc = __fmaf_rn(__ldg(w + j), h[j], acc);
    return acc;
}

}  // namespace lstm
