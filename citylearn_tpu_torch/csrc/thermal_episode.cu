// Whole-episode rollout of a batch of thermal-storage districts (cooling
// and DHW end uses with tanks, a battery and PV) under shared open-loop
// action plans (kernel K3).
//
// Replaces citylearn_tpu/ops/pallas_thermal.py::thermal_episode (body
// _episode_kernel). The Pallas kernel tiles 256 districts x 128 lanes,
// streams ten series through VMEM in double-buffered 256-step chunks and
// copies district 0's record out by DMA; none of that layout carries
// over. Here one thread owns one (district, building) pair and runs the
// S-step recurrence with its five carried states (two tank SOCs, battery
// SOC, efficiency, degraded capacity) and the three sums in registers;
// the 20 thermal parameter rows and the battery's rows and knots are
// loaded once per thread.
//
// What bounds it on an H100: like K1, neither bytes (the three plans and
// seven series are S x B floats shared by every district and stay in
// L1/L2) nor fp32 throughput (about 2e2 operations per building-step),
// but the latency of each step's dependent chain — two COPs, two tank
// events with their divisions, the battery event's three curve lookups,
// divisions and square roots — times S steps, with only D x B threads in
// flight. The design keeps that chain in registers. Each end use computes
// its COP once per step and only the priority order its action's sign
// selects (the Pallas body computes the COP twice and both orders, then
// selects; the values are the same). Thread index d * B + b makes a warp's
// reads of row t fall on a few neighbouring addresses.
//
// The blocks are csrc/thermal_common.cuh's and the battery event
// csrc/battery_common.cuh's, shared with the other kernels. Built with
// -fmad=false and IEEE division/square root so that every operation
// rounds exactly as the plain PyTorch version
// (ops/thermal.py::thermal_episode_reference) rounds it.

#include "thermal_common.cuh"

namespace {

using battery::Battery;
using battery::max_nan;
using thermal::BlockResult;
using thermal::EndUse;

// recorded rows of district 0, as ops/thermal.py names them
enum Rec { R_NET, R_CBAL, R_DBAL, R_BBAL, R_CSOC, R_DSOC, R_BSOC, R_COUT, R_DOUT };

__global__ void thermal_episode_kernel(
        const float* __restrict__ a_cool, const float* __restrict__ a_dhw,
        const float* __restrict__ a_bat, const float* __restrict__ nsl,
        const float* __restrict__ solar, const float* __restrict__ price,
        const float* __restrict__ carbon, const float* __restrict__ cool_demand,
        const float* __restrict__ dhw_demand, const float* __restrict__ outdoor,
        const float* __restrict__ bparams, const float* __restrict__ pec_x,
        const float* __restrict__ pec_y, const float* __restrict__ cpc_x,
        const float* __restrict__ cpc_y, const float* __restrict__ tparams,
        const float* __restrict__ csoc0, const float* __restrict__ dsoc0,
        const float* __restrict__ soc0, const float* __restrict__ eff0,
        const float* __restrict__ deg0,
        float* __restrict__ reward_out, float* __restrict__ cost_out,
        float* __restrict__ emission_out, float* __restrict__ csoc_out,
        float* __restrict__ dsoc_out, float* __restrict__ soc_out,
        float* __restrict__ eff_out, float* __restrict__ deg_out,
        float* __restrict__ rec, int D, int B, int S, int n_knots,
        float hours_ratio, float ratio) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= D * B) return;
    const int d = i / B;
    const int b = i - d * B;
    const Battery bat(bparams, pec_x, pec_y, cpc_x, cpc_y, b, B, n_knots);
    const EndUse cooling(tparams, thermal::CN, thermal::CT_CAP, thermal::CT_CONV, false, b, B);
    const EndUse dhw(tparams, thermal::DN, thermal::DT_CAP, thermal::DT_CONV, true, b, B);

    float csoc = csoc0[i], dsoc = dsoc0[i];
    float soc = soc0[i], eff = eff0[i], deg = deg0[i];
    float rew = 0.f, cost = 0.f, emis = 0.f;
    const bool recording = rec != nullptr && d == 0;
    const int SB = S * B;

    for (int t = 0; t < S; ++t) {
        const int o = t * B + b;
        const float t0f = t == 0 ? 1.f : 0.f;
        const float cool_d = cool_demand[o], dhw_d = dhw_demand[o];
        const float cop_c = cooling.cop(outdoor[o]);
        const float cop_d = dhw.cop(outdoor[o]);

        // reset-time update_variables consumptions, booked at t == 0
        // (building.py:2554-2558, 2618-2652)
        const float reset_cool = cool_d / cop_c;
        const float reset_dhw = dhw_d / cop_d;

        // cooling takes no hours ratio, DHW does (building.py:1663, 1765)
        const BlockResult c = cooling.step<false>(cool_d, a_cool[o], cop_c, t0f * reset_cool,
                                           1.f, ratio, csoc);
        const BlockResult w = dhw.step<false>(dhw_d, a_dhw[o], cop_d, t0f * reset_dhw,
                                              hours_ratio, ratio, dsoc);
        const float balance = bat.step(a_bat[o], hours_ratio, ratio, soc, eff, deg);

        // update_variables accounting with the t == 0 multi-count
        // (building.py:2615-2703)
        const float uv_cool = (c.out + c.balance) / cop_c;
        const float uv_dhw = (w.out + w.balance) / cop_d;
        const float cool_total = c.cons + t0f * (reset_cool + uv_cool);
        const float dhw_total = w.cons + t0f * (reset_dhw + uv_dhw);
        const float nsl_term = nsl[o] + t0f * 2.f * nsl[o];
        const float bat_term = balance + t0f * balance;
        const float net = cool_total + dhw_total + nsl_term + bat_term - solar[o];
        if (recording) {
            rec[R_NET * SB + o] = net;
            rec[R_CBAL * SB + o] = c.balance;
            rec[R_DBAL * SB + o] = w.balance;
            rec[R_BBAL * SB + o] = balance;
            rec[R_CSOC * SB + o] = csoc;
            rec[R_DSOC * SB + o] = dsoc;
            rec[R_BSOC * SB + o] = soc;
            rec[R_COUT * SB + o] = c.out;
            rec[R_DOUT * SB + o] = w.out;
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
    csoc_out[i] = csoc;
    dsoc_out[i] = dsoc;
    soc_out[i] = soc;
    eff_out[i] = eff;
    deg_out[i] = deg;
}

}  // namespace

extern "C" int thermal_episode_launch(
        const float* a_cool, const float* a_dhw, const float* a_bat, const float* nsl,
        const float* solar, const float* price, const float* carbon,
        const float* cool_demand, const float* dhw_demand, const float* outdoor,
        const float* bparams, const float* pec_x, const float* pec_y, const float* cpc_x,
        const float* cpc_y, const float* tparams, const float* csoc0, const float* dsoc0,
        const float* soc0, const float* eff0, const float* deg0, float* reward, float* cost,
        float* emission, float* csoc, float* dsoc, float* soc, float* eff, float* deg,
        float* rec, int D, int B, int S, int n_knots, float hours_ratio, float ratio,
        void* stream) {
    constexpr int threads = 64;
    const int blocks = (D * B + threads - 1) / threads;
    thermal_episode_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        a_cool, a_dhw, a_bat, nsl, solar, price, carbon, cool_demand, dhw_demand, outdoor,
        bparams, pec_x, pec_y, cpc_x, cpc_y, tparams, csoc0, dsoc0, soc0, eff0, deg0,
        reward, cost, emission, csoc, dsoc, soc, eff, deg, rec,
        D, B, S, n_knots, hours_ratio, ratio);
    return static_cast<int>(cudaGetLastError());
}
