// K closed-loop battery+PV steps of a district batch with per-district
// action, non-shiftable-load and solar streams (kernel K2): the env
// recurrence of the batched SAC trainer's chunked collect.
//
// Replaces citylearn_tpu/ops/pallas_collect.py::_collect_chunk_kernel
// (body _collect_kernel, curve lookup _interp). The Pallas kernel puts
// 128 districts on the lane axis of a tile and the buildings on
// sublanes padded to a multiple of 8, and its d_last layout exists only
// to keep districts on TPU lanes end to end. None of that carries over:
// the streams here are (K, D, B) contiguous and one thread owns one
// (district, building) pair, index d * B + b, so a warp's reads and
// writes of step k are one contiguous span of the stream, with no
// padding and no transposes around the launch.
//
// What bounds it on an H100: the bytes are 4 streams of K x D x B floats
// (about 21 MB at D=4096, K=64, B=5: some 6 us at 3.35 TB/s) and the
// operations about 1e2 per building-step; but like K1 the kernel waits on
// each step's dependent chain (two curve lookups, IEEE divisions and
// square roots) K times over, with only D x B threads in flight. The
// state and the curve knots stay in registers (csrc/battery_common.cuh);
// the stream loads of step k do not depend on the chain and can issue
// ahead of it.
//
// Built with -fmad=false and IEEE division/square root so that every
// operation rounds exactly as the plain PyTorch version
// (ops/collect.py::battery_collect_chunk_reference) rounds it.

#include "battery_common.cuh"

namespace {

using battery::Battery;
using battery::max_nan;

__global__ void battery_collect_kernel(
        const float* __restrict__ act, const float* __restrict__ nsl,
        const float* __restrict__ solar, const float* __restrict__ bparams,
        const float* __restrict__ pec_x, const float* __restrict__ pec_y,
        const float* __restrict__ cpc_x, const float* __restrict__ cpc_y,
        const float* __restrict__ soc0, const float* __restrict__ eff0,
        const float* __restrict__ deg0, float* __restrict__ reward,
        float* __restrict__ soc_out, float* __restrict__ eff_out,
        float* __restrict__ deg_out, int D, int B, int K, int n_knots,
        float hours_ratio, float ratio, int first_chunk) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int DB = D * B;
    if (i >= DB) return;
    const Battery bat(bparams, pec_x, pec_y, cpc_x, cpc_y, i % B, B, n_knots);

    float soc = soc0[i], eff = eff0[i], deg = deg0[i];
    for (int k = 0; k < K; ++k) {
        const size_t o = static_cast<size_t>(k) * DB + i;
        const float balance = bat.step(act[o], hours_ratio, ratio, soc, eff, deg);
        // net accounting with the t == 0 triple/double count
        // (building.py:2615-2652); t == 0 is the first step of the first
        // chunk of an episode (the trainer aligns chunks to episodes)
        const bool t0 = first_chunk && k == 0;
        const float nsl_term = t0 ? 3.f * nsl[o] : nsl[o];
        const float bat_term = t0 ? 2.f * balance : balance;
        const float net = nsl_term + bat_term - solar[o];
        reward[o] = -max_nan(net, 0.f);
    }
    soc_out[i] = soc;
    eff_out[i] = eff;
    deg_out[i] = deg;
}

}  // namespace

extern "C" int battery_collect_launch(
        const float* act, const float* nsl, const float* solar,
        const float* bparams, const float* pec_x, const float* pec_y,
        const float* cpc_x, const float* cpc_y, const float* soc0,
        const float* eff0, const float* deg0, float* reward, float* soc,
        float* eff, float* deg, int D, int B, int K, int n_knots,
        float hours_ratio, float ratio, int first_chunk, void* stream) {
    constexpr int threads = 64;
    const int blocks = (D * B + threads - 1) / threads;
    battery_collect_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        act, nsl, solar, bparams, pec_x, pec_y, cpc_x, cpc_y, soc0, eff0, deg0,
        reward, soc, eff, deg, D, B, K, n_knots, hours_ratio, ratio, first_chunk);
    return static_cast<int>(cudaGetLastError());
}
