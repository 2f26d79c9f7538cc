// Whole-episode battery+PV rollout of a batch of districts under one
// shared open-loop action plan (kernel K1).
//
// Replaces citylearn_tpu/ops/pallas_battery.py::battery_episode (body
// _episode_kernel, curve lookup _interp). The Pallas kernel tiles 256
// districts x 128 lanes and streams the series through VMEM in 512-step
// chunks; none of that layout carries over. Here one thread owns one
// (district, building) pair and runs the S-step recurrence with SOC,
// efficiency, degraded capacity and the three sums in registers.
//
// What bounds it on an H100: neither bytes (a few MB in all: the plan
// and 4 series of S x B floats, read by every district from L1/L2) nor
// fp32 throughput (about 1e2 operations per building-step), but the
// latency of each step's dependent chain (three curve lookups, IEEE
// divisions and square roots) times S steps, with only D x B threads in
// flight. The design keeps everything the chain needs in registers: the
// curve knots are loaded once per thread and the lookups unroll over a
// fixed MAX_KNOTS so the knot arrays never spill to local memory; thread
// index d * B + b makes a warp's reads of series row t fall on a few
// neighbouring addresses. Staging the series in shared memory and
// overlapping steps are left for later.
//
// The battery event itself is csrc/battery_common.cuh's, shared with K2.
// Built with -fmad=false and IEEE division/square root so that every
// operation rounds exactly as the plain PyTorch version
// (ops/battery.py::battery_episode_reference) rounds it.

#include "battery_common.cuh"

namespace {

using battery::Battery;
using battery::max_nan;

__global__ void battery_episode_kernel(
        const float* __restrict__ act, const float* __restrict__ nsl,
        const float* __restrict__ solar, const float* __restrict__ price,
        const float* __restrict__ carbon, const float* __restrict__ bparams,
        const float* __restrict__ pec_x, const float* __restrict__ pec_y,
        const float* __restrict__ cpc_x, const float* __restrict__ cpc_y,
        const float* __restrict__ soc0, const float* __restrict__ eff0,
        const float* __restrict__ deg0,
        float* __restrict__ reward_out, float* __restrict__ cost_out,
        float* __restrict__ emission_out, float* __restrict__ soc_out,
        float* __restrict__ eff_out, float* __restrict__ deg_out,
        float* __restrict__ rec, int D, int B, int S, int n_knots,
        float hours_ratio, float ratio) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= D * B) return;
    const int d = i / B;
    const int b = i - d * B;
    const Battery bat(bparams, pec_x, pec_y, cpc_x, cpc_y, b, B, n_knots);

    float soc = soc0[i], eff = eff0[i], deg = deg0[i];
    float rew = 0.f, cost = 0.f, emis = 0.f;
    const bool recording = rec != nullptr && d == 0;

    for (int t = 0; t < S; ++t) {
        const int o = t * B + b;
        const float balance = bat.step(act[o], hours_ratio, ratio, soc, eff, deg);

        // net accounting with the t == 0 triple/double count
        // (building.py:2615-2652)
        const float nsl_term = t == 0 ? 3.f * nsl[o] : nsl[o];
        const float bat_term = t == 0 ? 2.f * balance : balance;
        const float net = nsl_term + bat_term - solar[o];
        if (recording) {
            rec[o] = net;
            rec[S * B + o] = balance;
            rec[2 * S * B + o] = soc;
        }
        // cost is unclamped (building.py:2686), emission clamps at 0
        // (building.py:2691)
        rew = rew - max_nan(net, 0.f);
        cost = cost + net * price[o];
        emis = emis + max_nan(net * carbon[o], 0.f);
    }
    reward_out[i] = rew;
    cost_out[i] = cost;
    emission_out[i] = emis;
    soc_out[i] = soc;
    eff_out[i] = eff;
    deg_out[i] = deg;
}

}  // namespace

extern "C" int battery_episode_launch(
        const float* act, const float* nsl, const float* solar,
        const float* price, const float* carbon, const float* bparams,
        const float* pec_x, const float* pec_y, const float* cpc_x,
        const float* cpc_y, const float* soc0, const float* eff0,
        const float* deg0, float* reward, float* cost, float* emission,
        float* soc, float* eff, float* deg, float* rec, int D, int B, int S,
        int n_knots, float hours_ratio, float ratio, void* stream) {
    constexpr int threads = 64;
    const int blocks = (D * B + threads - 1) / threads;
    battery_episode_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        act, nsl, solar, price, carbon, bparams, pec_x, pec_y, cpc_x, cpc_y,
        soc0, eff0, deg0, reward, cost, emission, soc, eff, deg, rec,
        D, B, S, n_knots, hours_ratio, ratio);
    return static_cast<int>(cudaGetLastError());
}
