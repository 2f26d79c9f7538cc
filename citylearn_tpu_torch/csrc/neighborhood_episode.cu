// Whole-episode rollout of a batch of neighborhood districts (the EULP
// county neighborhoods and the quebec occupant sets) under shared open-loop
// action plans (kernel K6): partial-load cooling and heating demand from
// the signed cooling_or_heating_device action or the cooling_device and
// heating_device actions, device-only dispatch of the cooling, heating and
// DHW end uses, the standby loss of the DHW tank, the battery, the net
// consumption and the sums of the default reward, cost and emission. The
// LSTM temperature and the occupant interaction are not here: under
// open-loop plans they are the same for every district and run once, after
// this launch, in the post-pass (csrc/neighborhood_postpass.cu).
//
// Replaces citylearn_tpu/ops/pallas_neighborhood.py::neighborhood_episode
// (body _episode_kernel). The Pallas kernel tiles 256 districts x 128
// lanes, streams thirteen series through VMEM in double-buffered 128-step
// chunks and copies district 0's record out by DMA; none of that layout
// carries over. Here one thread owns one (district, building) pair and runs
// the S-step recurrence with its four carried states (DHW tank SOC, battery
// SOC, efficiency, degraded capacity) and the three sums in registers.
// Threads are ordered building-major, so that the 32 threads of a warp hold
// 32 districts of one building and read every plan, series, parameter and
// curve knot of a step from one address.
//
// What bounds it on an H100: operations (about 2e2 per building-step, 7e11
// for D = 4096 districts of 100 buildings over a year), not bytes: the four
// plans and nine series are S x B floats shared by every district and stay
// in L1/L2. In practice the latency of each step's dependent chain (three
// COPs, the partial loads, three device outputs and their divisions, the
// battery event's curve lookups, divisions and square roots) sets the time.
// K6 is the first kernel of the port with more threads than the card holds
// at once (409,600 at D = 4096, B = 100): __launch_bounds__ caps a thread
// at 64 registers so that 8 blocks of 128 threads, 32 warps, share an SM
// and hide each other's latency; the battery's knots are read in place
// (battery::BatteryView) rather than held in 48 registers.
//
// Quirks of the reference kept as the Pallas kernel keeps them: the t == 0
// triple count of the non-shiftable load and double count of the battery
// balance; a heating device that is not a heat pump books its reset-time
// and update-time consumption through the DHW device's efficiency; heating
// takes no hours ratio; control starts at t >= lookback + 1; the DHW tank
// only decays (the reference converts the DHW action through the heating
// tank's capacity, zero on this family). Every division by a capacity or a
// power goes through max(., ZERO), so that a district without a battery
// (capacity and power 0) runs a null battery with finite outputs, as the
// stepped path does. The plans and series hold exactly S rows, so every
// step is live.
//
// Built with -fmad=false and IEEE division and square root, so that every
// operation rounds exactly as the plain PyTorch version
// (ops/neighborhood.py::neighborhood_episode_reference) rounds it.

#include "thermal_common.cuh"

namespace {

using battery::BatteryView;
using battery::max_nan;
using battery::min_nan;
using battery::ZERO;

constexpr int THREADS = 128;

// rows of nparams and of the record, as ops/neighborhood.py names them
enum NRow {
    CN, CE, CTC, CHP,                 // cooling device
    HN, HE, HTH, HHP,                 // heating device
    DN, DE, DTH, DHP,                 // dhw device
    DT_CAP, DT_LOSS,                  // dhw tank
    COOL_ACT, HEAT_ACT, COH_ACT
};
enum Rec { R_NET, R_BBAL, R_BSOC, R_DSOC, R_COUT, R_HOUT, R_DOUT, R_CDEM, R_HDEM };

struct Args {
    const float *a_coh, *a_cdev, *a_hdev, *a_bat;
    const float *nsl, *solar, *price, *carbon, *cool, *heat, *dhw, *outdoor, *mode;
    const float *bparams, *pec_x, *pec_y, *cpc_x, *cpc_y, *nparams;
    const float *dsoc0, *soc0, *eff0, *deg0;
    float *reward, *cost, *emission, *dsoc, *soc, *eff, *deg, *rec;
    int D, B, S, n_knots, lookback;
    float hours_ratio, ratio;
};

// One device's COP inputs: nparams rows off + 1 .. off + 3
struct Device {
    float nominal, eff, target;
    bool is_hp, heating;

    __device__ __forceinline__ Device(const float* __restrict__ nparams, int off, bool heating_,
                                      int b, int B) : heating(heating_) {
        nominal = nparams[(off + 0) * B + b];
        eff = nparams[(off + 1) * B + b];
        target = nparams[(off + 2) * B + b];
        is_hp = nparams[(off + 3) * B + b] > 0.5f;
    }
    __device__ __forceinline__ float cop(float outdoor) const {
        return thermal::cop(eff, target, is_hp, heating, outdoor);
    }
};

__global__ void __launch_bounds__(THREADS, 8) neighborhood_episode_kernel(const Args a) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.D * a.B) return;
    const int B = a.B, S = a.S;
    const int b = i / a.D;
    const int d = i - b * a.D;
    const int j = d * B + b;                     // this pair's entry of a (D, B) tensor

    const BatteryView bat(a.bparams, a.pec_x, a.pec_y, a.cpc_x, a.cpc_y, b, B, a.n_knots);
    const Device cooling(a.nparams, CN, false, b, B);
    const Device heating(a.nparams, HN, true, b, B);
    const Device dhw(a.nparams, DN, true, b, B);
    const float de_eff = a.nparams[DE * B + b];
    const float dt_cap = a.nparams[DT_CAP * B + b];
    const float dt_keep = 1.f - a.nparams[DT_LOSS * B + b];
    const float dt_cap_safe = max_nan(dt_cap, ZERO);
    const bool coh_active = a.nparams[COH_ACT * B + b] > 0.5f;
    const bool cool_ctl = a.nparams[COOL_ACT * B + b] > 0.5f || coh_active;
    const bool heat_ctl = a.nparams[HEAT_ACT * B + b] > 0.5f || coh_active;

    float dsoc = a.dsoc0[j];
    float soc = a.soc0[j], eff = a.eff0[j], deg = a.deg0[j];
    float rew = 0.f, cost = 0.f, emis = 0.f;
    const bool recording = a.rec != nullptr && d == 0;
    const int SB = S * B;

    for (int t = 0; t < S; ++t) {
        const int o = t * B + b;
        const float t0f = t == 0 ? 1.f : 0.f;
        const float outdoor = a.outdoor[o], mode = a.mode[o];
        const float cool_d = a.cool[o], heat_d = a.heat[o], dhw_d = a.dhw[o];
        const float cop_c = cooling.cop(outdoor);
        const float cop_h = heating.cop(outdoor);
        const float cop_d = dhw.cop(outdoor);

        // reset-time update_variables consumptions, booked at t == 0
        // (building.py:2554-2558, 2618-2652); a heating device that is not
        // a heat pump books through the DHW device's efficiency
        // (building.py:2629-2632)
        const float reset_cool = cool_d / cop_c;
        const float reset_heat = heating.is_hp ? heat_d / cop_h : heat_d / de_eff;
        const float reset_dhw = dhw_d / cop_d;
        const float dev_init_c = t0f * reset_cool;
        const float dev_init_h = t0f * reset_heat;
        const float dev_init_d = t0f * reset_dhw;

        // partial-load demand (building.py:3080-3158): the signed
        // cooling_or_heating action splits into the device fractions, the
        // fraction sets the electric power available and demand becomes the
        // device's output under it, gated by hvac_mode, once the LSTM's
        // input window is full; heating takes no hours ratio
        // (building.py:3146)
        const float a_coh = a.a_coh[o];
        const float cool_frac = coh_active ? fabsf(min_nan(a_coh, 0.f)) : a.a_cdev[o];
        const float heat_frac = coh_active ? fabsf(max_nan(a_coh, 0.f)) : a.a_hdev[o];
        const float elec_c = cool_frac * cooling.nominal * a.hours_ratio;
        float partial_c = min_nan(elec_c, cooling.nominal - dev_init_c) * cop_c;
        partial_c = (mode == 1.f || mode == 3.f) ? partial_c : 0.f;
        const float elec_h = heat_frac * heating.nominal;
        float partial_h = min_nan(elec_h, heating.nominal - dev_init_h) * cop_h;
        partial_h = (mode == 2.f || mode == 3.f) ? partial_h : 0.f;
        const bool warm = t >= a.lookback + 1;
        const float cooling_demand = warm && cool_ctl ? partial_c : cool_d;
        const float heating_demand = warm && heat_ctl ? partial_h : heat_d;

        // device-only dispatch: every tank is inert and there is no outage,
        // so the end uses decouple
        const float cout = min_nan(cooling_demand, (cooling.nominal - dev_init_c) * cop_c);
        const float ccons = max_nan(0.f, cout / cop_c);
        const float hout = min_nan(heating_demand, (heating.nominal - dev_init_h) * cop_h);
        const float hcons = max_nan(0.f, hout / cop_h);
        const float dout = min_nan(dhw_d, (dhw.nominal - dev_init_d) * cop_d);
        const float dcons = max_nan(0.f, dout / cop_d);
        // the DHW tank charges 0 each step: its standby loss alone
        dsoc = max_nan(0.f, dsoc * dt_cap * dt_keep) / dt_cap_safe;

        const float balance = battery::event(bat, a.a_bat[o] * bat.nominal * a.hours_ratio,
                                             a.ratio, soc, eff, deg);

        // update_variables accounting with the t == 0 multi-count
        // (building.py:2615-2703)
        const float uv_cool = cout / cop_c;
        const float uv_heat = heating.is_hp ? hout / cop_h : hout / de_eff;
        const float uv_dhw = dout / cop_d;
        const float cool_total = ccons + t0f * (reset_cool + uv_cool);
        const float heat_total = hcons + t0f * (reset_heat + uv_heat);
        const float dhw_total = dcons + t0f * (reset_dhw + uv_dhw);
        const float nsl = a.nsl[o];
        const float nsl_term = nsl + t0f * 2.f * nsl;
        const float bat_term = balance + t0f * balance;
        const float net = cool_total + heat_total + dhw_total + nsl_term + bat_term - a.solar[o];
        if (recording) {
            a.rec[R_NET * SB + o] = net;
            a.rec[R_BBAL * SB + o] = balance;
            a.rec[R_BSOC * SB + o] = soc;
            a.rec[R_DSOC * SB + o] = dsoc;
            a.rec[R_COUT * SB + o] = cout;
            a.rec[R_HOUT * SB + o] = hout;
            a.rec[R_DOUT * SB + o] = dout;
            a.rec[R_CDEM * SB + o] = cooling_demand;
            a.rec[R_HDEM * SB + o] = heating_demand;
        }
        // cost is unclamped (building.py:2686), emission clamps at 0
        // (building.py:2691)
        rew = rew - max_nan(net, 0.f);
        cost = cost + net * a.price[o];
        emis = emis + max_nan(net * a.carbon[o], 0.f);
    }
    a.reward[j] = rew;
    a.cost[j] = cost;
    a.emission[j] = emis;
    a.dsoc[j] = dsoc;
    a.soc[j] = soc;
    a.eff[j] = eff;
    a.deg[j] = deg;
}

}  // namespace

extern "C" int neighborhood_episode_launch(
        const float* a_coh, const float* a_cdev, const float* a_hdev, const float* a_bat,
        const float* nsl, const float* solar, const float* price, const float* carbon,
        const float* cool, const float* heat, const float* dhw, const float* outdoor,
        const float* mode, const float* bparams, const float* pec_x, const float* pec_y,
        const float* cpc_x, const float* cpc_y, const float* nparams, const float* dsoc0,
        const float* soc0, const float* eff0, const float* deg0,
        float* reward, float* cost, float* emission, float* dsoc, float* soc, float* eff,
        float* deg, float* rec, int D, int B, int S, int n_knots, int lookback,
        float hours_ratio, float ratio, void* stream) {
    const Args a = {a_coh, a_cdev, a_hdev, a_bat,
                    nsl, solar, price, carbon, cool, heat, dhw, outdoor, mode,
                    bparams, pec_x, pec_y, cpc_x, cpc_y, nparams,
                    dsoc0, soc0, eff0, deg0,
                    reward, cost, emission, dsoc, soc, eff, deg, rec,
                    D, B, S, n_knots, lookback, hours_ratio, ratio};
    const int blocks = (D * B + THREADS - 1) / THREADS;
    neighborhood_episode_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
