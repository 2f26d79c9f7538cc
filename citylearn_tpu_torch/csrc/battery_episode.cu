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
// Built with -fmad=false and IEEE division/square root so that every
// operation rounds exactly as the plain PyTorch version
// (ops/battery.py::battery_episode_reference) rounds it.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_KNOTS = 12;
constexpr float ZERO = 1e-6f;   // reference citylearn/data.py:19

// NaN-propagating min/max, as torch.minimum/torch.maximum and jnp's
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || b != b) ? a + b : fminf(a, b);
}

// Reference curve lookup (energy_model.py:1083,1103):
// idx = max(0, argmax(q <= x) - 1), all-False -> segment 0. For sorted
// knots the first q <= x is the count of x < q.
__device__ __forceinline__ float interp(float q, const float (&x)[MAX_KNOTS],
                                        const float (&y)[MAX_KNOTS], int n) {
    int first = 0;
#pragma unroll
    for (int k = 0; k < MAX_KNOTS; ++k) {
        if (k < n && x[k] < q) ++first;
    }
    const int idx = first >= n ? 0 : max(0, first - 1);
    float x0 = 0.f, x1 = 0.f, y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_KNOTS - 1; ++k) {
        if (idx == k) {
            x0 = x[k];
            x1 = x[k + 1];
            y0 = y[k];
            y1 = y[k + 1];
        }
    }
    return y0 + (q - x0) * (y1 - y0) / (x1 - x0);
}

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

    // bparams rows: capacity, nominal_power, loss_coefficient, initial_soc,
    // depth_of_discharge, capacity_loss_coefficient (ops/pallas_battery.py)
    const float cap = bparams[0 * B + b];
    const float nominal = bparams[1 * B + b];
    const float keep = 1.f - bparams[2 * B + b];
    const float soc_floor = 1.f - bparams[4 * B + b];
    const float clc = bparams[5 * B + b];
    const float cap_safe = max_nan(cap, ZERO);
    const float nominal_safe = max_nan(nominal, ZERO);

    float px[MAX_KNOTS], py[MAX_KNOTS], cx[MAX_KNOTS], cy[MAX_KNOTS];
#pragma unroll
    for (int k = 0; k < MAX_KNOTS; ++k) {
        const bool in = k < n_knots;
        px[k] = in ? pec_x[k * B + b] : 0.f;
        py[k] = in ? pec_y[k * B + b] : 0.f;
        cx[k] = in ? cpc_x[k * B + b] : 0.f;
        cy[k] = in ? cpc_y[k * B + b] : 0.f;
    }

    float soc = soc0[i], eff = eff0[i], deg = deg0[i];
    float rew = 0.f, cost = 0.f, emis = 0.f;
    const bool recording = rec != nullptr && d == 0;

    for (int t = 0; t < S; ++t) {
        const int o = t * B + b;
        const float energy = act[o] * nominal * hours_ratio;  // /ratio then *ratio cancel
        const float energy_init = max_nan(0.f, soc * cap * keep);
        const float soc_norm = energy_init / cap_safe;
        const float max_power = nominal * interp(soc_norm, cx, cy, n_knots);

        const bool charging = energy >= 0.f;
        float e, new_eff;
        if (charging) {
            e = min_nan(min_nan(max_power, nominal), min_nan(deg - energy_init, energy));
            new_eff = interp(fabsf(min_nan(energy, max_power)) / nominal_safe,
                             px, py, n_knots);
        } else {
            // the DoD floor uses the previous event's efficiency
            const float e_dod = -max_nan((soc - soc_floor) * cap * sqrtf(eff), 0.f);
            e = max_nan(max_nan(-max_power, e_dod), energy);
            new_eff = interp(min_nan(fabsf(energy), max_power) / nominal_safe,
                             px, py, n_knots);
        }
        const float rt = sqrtf(new_eff);
        const float fin = e >= 0.f ? min_nan(energy_init + e * rt, cap)
                                   : max_nan(0.f, energy_init + e / rt);
        const float new_soc = fin / cap_safe;
        const float delta = fin - energy_init;
        const float balance = delta >= 0.f ? delta / rt : delta * rt;
        const float new_deg = max_nan(
            deg - (clc * cap * fabsf(balance) / (2.f * max_nan(deg, ZERO))) * ratio, 0.f);

        // net accounting with the t == 0 triple/double count
        // (building.py:2615-2652)
        const float nsl_term = t == 0 ? 3.f * nsl[o] : nsl[o];
        const float bat_term = t == 0 ? 2.f * balance : balance;
        const float net = nsl_term + bat_term - solar[o];
        if (recording) {
            rec[o] = net;
            rec[S * B + o] = balance;
            rec[2 * S * B + o] = new_soc;
        }
        // cost is unclamped (building.py:2686), emission clamps at 0
        // (building.py:2691)
        rew = rew - max_nan(net, 0.f);
        cost = cost + net * price[o];
        emis = emis + max_nan(net * carbon[o], 0.f);
        soc = new_soc;
        eff = new_eff;
        deg = new_deg;
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
