// The thermal end-use blocks shared by the thermal kernels (K3
// thermal_episode.cu, K5 lstm_episode.cu; the neighborhood kernel K6 takes
// the COP alone): one (district, building) thread's per-step device COP, storage
// tank event and device-plus-tank block with both priority orders
// (reference building.py:1641-1823, energy_model.py:157-451, 603-871).
//
// Replaces citylearn_tpu/ops/pallas_thermal.py::_cop, _tank and
// _thermal_block. EndUse::step<false> is the no-outage form (downward
// electrical flexibility is +inf, so the blocks decouple and the cap
// compiles away); step<true> caps the device's electric power by the solar
// generation left during an outage. Every operation rounds as the plain
// PyTorch version (ops/thermal.py) rounds it, when built with -fmad=false
// and IEEE division and square root.

#pragma once

#include "battery_common.cuh"

namespace thermal {

using battery::max_nan;
using battery::min_nan;
using battery::ZERO;

// Rows of tparams (N_TROWS, B), as ops/thermal.py names them
enum Row {
    CN, CE, CTC, CHP,                                   // cooling device
    DN, DE, DTH, DHP,                                   // dhw device
    CT_CAP, CT_RT, CT_LOSS, CT_MI, CT_MO, CT_CONV,      // cooling tank
    DT_CAP, DT_RT, DT_LOSS, DT_MI, DT_MO, DT_CONV,      // dhw tank
    N_TROWS
};

// downward_electrical_flexibility (reference building.py:640-668): under
// an outage the solar generation left after the consumption booked so
// far, +inf otherwise.
__device__ __forceinline__ float flexibility(bool outage, float solar, float accum) {
    return outage ? max_nan(0.f, solar - accum) : __int_as_float(0x7f800000);
}

// Carnot COP clamped to (0, 20] for heat pumps (negative, above 20 and
// NaN from outdoor == target all map to 20), the constant efficiency for
// heaters (energy_model.py:216-250).
__device__ __forceinline__ float cop(float eff, float target, bool is_hp, bool heating,
                                     float outdoor) {
    const float denom = heating ? target - outdoor : outdoor - target;
    float c = eff * (target + 273.15f) / denom;
    c = c < 0.f ? 20.f : c;
    c = c > 20.f ? 20.f : c;
    c = c != c ? 20.f : c;
    return is_hp ? c : eff;
}

// A storage tank's parameters and its charge event
// (energy_model.py:603-871 with the env's pre-divide by time_step_ratio).
struct Tank {
    float cap, rt, keep, max_in, neg_max_out, cap_safe;

    // rows off..off+4: capacity, sqrt(efficiency), loss_coefficient,
    // max_input_power, max_output_power (+inf when unconstrained)
    __device__ __forceinline__ Tank(const float* __restrict__ tparams, int off, int b, int B) {
        cap = tparams[(off + 0) * B + b];
        rt = tparams[(off + 1) * B + b];
        keep = 1.f - tparams[(off + 2) * B + b];
        max_in = tparams[(off + 3) * B + b];
        neg_max_out = -tparams[(off + 4) * B + b];
        cap_safe = max_nan(cap, ZERO);
    }

    // Apply the pre-divided energy request: updates soc and returns the
    // energy balance of the event. A zero-capacity tank stays at 0.
    __device__ __forceinline__ float step(float energy, float ratio, float& soc) const {
        float e = energy >= 0.f ? min_nan(energy, max_in) : max_nan(neg_max_out, energy);
        e = e * ratio;
        const float energy_init = max_nan(0.f, soc * cap * keep);
        const float fin = e >= 0.f ? min_nan(energy_init + e * rt, cap)
                                   : max_nan(0.f, energy_init + e / rt);
        soc = fin / cap_safe;
        const float delta = fin - energy_init;
        return delta >= 0.f ? delta / rt : delta * rt;
    }
};

// What one end use did in a step.
struct BlockResult {
    float balance;   // tank energy balance
    float out;       // energy from the device
    float cons;      // apply-phase consumption: device plus storage charge
};

// One end use: a heat pump or electric heater and its tank.
struct EndUse {
    float nominal, eff, target, conv;
    bool is_hp, heating;
    Tank tank;

    // rows dev_off..dev_off+3: nominal_power, efficiency, target
    // temperature, is-heat-pump; conv_row: the capacity that converts the
    // storage action to energy (DHW uses the heating tank's, building.py:1765)
    __device__ __forceinline__ EndUse(const float* __restrict__ tparams, int dev_off,
                                      int tank_off, int conv_row, bool heating_, int b, int B)
        : heating(heating_), tank(tparams, tank_off, b, B) {
        nominal = tparams[(dev_off + 0) * B + b];
        eff = tparams[(dev_off + 1) * B + b];
        target = tparams[(dev_off + 2) * B + b];
        is_hp = tparams[(dev_off + 3) * B + b] > 0.5f;
        conv = tparams[conv_row * B + b];
    }

    __device__ __forceinline__ float cop(float outdoor) const {
        return thermal::cop(eff, target, is_hp, heating, outdoor);
    }

    // Serve `demand` under the storage `action`: a charging or idle tank
    // (action >= 0) lets the device run first and charges from what
    // nominal power is left; a discharging tank runs before the device.
    // `dev_init` is the device consumption already booked at this index
    // (non-zero at t == 0 only). With FLEX the electric power the device
    // may draw is also capped by flexibility(outage, solar, accum), `accum`
    // being the district-level consumption booked before this block.
    template <bool FLEX>
    __device__ __forceinline__ BlockResult step(float demand, float action, float cop,
                                                float dev_init, float hours_mul, float ratio,
                                                float& soc, bool outage = false,
                                                float solar = 0.f, float accum = 0.f) const {
        const float energy_req = action * conv * hours_mul;
        // the most the device can put out with `booked` consumed by itself
        // and `extra` added to the district's consumption since `accum`
        auto max_out = [&](float booked, float extra) {
            const float avail = nominal - booked;
            if constexpr (FLEX) {
                return min_nan(flexibility(outage, solar, accum + extra), avail) * cop;
            } else {
                return avail * cop;
            }
        };
        BlockResult r;
        if (!(action < 0.f)) {
            r.out = min_nan(demand, max_out(dev_init, 0.f));
            const float cons_dev = max_nan(0.f, r.out / cop);
            const float charge = min_nan(max_out(dev_init + cons_dev, cons_dev), energy_req);
            r.balance = tank.step(charge / ratio, ratio, soc);
            r.cons = cons_dev + max_nan(r.balance, 0.f) / cop;
        } else {
            const float discharge = max_nan(-demand, energy_req);
            r.balance = tank.step(discharge / ratio, ratio, soc);
            // 0 for a true discharge; booked as the stepped path books it
            const float cons_store = max_nan(r.balance, 0.f) / cop;
            const float storage_out = -min_nan(r.balance, 0.f);
            r.out = min_nan(demand - storage_out, max_out(dev_init + cons_store, cons_store));
            r.cons = max_nan(0.f, r.out / cop) + cons_store;
        }
        return r;
    }
};

}  // namespace thermal
