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
// carries over. Under open-loop plans most of a building-step does not
// depend on the district: the three COPs, the reset-time consumptions, the
// partial loads, the three device outputs and their consumptions are
// functions of the step and the building only. So one launch runs two
// kernels:
//
//   1. the prelude, a stateless thread per (step, building), computes that
//      part once: pre = ((cool_total + heat_total) + dhw_total) + nsl_term
//      and district 0's rows R_COUT ... R_HDEM, and writes pre beside the
//      solar, price, carbon and battery-action rows into a building-major
//      scratch (B, N_STAGE, S_pad) that the wrapper allocates;
//   2. the district pass, grid (ceil(D / THREADS), B): a block holds
//      THREADS districts of one building, a thread one district with its
//      four carried states (DHW tank SOC, battery SOC, efficiency, degraded
//      capacity) and three sums in registers. The block keeps one copy of
//      its building's battery parameters and knots in shared memory (the
//      lookups unrolled over the knot count, fixed at compile time for 5,
//      the knot count of the EULP and quebec batteries, and over MAX_KNOTS
//      predicated for any other) and stages CHUNK
//      steps of its five scratch rows at a time with cp.async, double-
//      buffered, so that a step reads every shared input by a broadcast
//      from shared memory. A step is the battery event, the tank's decay,
//      net = (pre + bat_term) - solar and the three sums.
//
// net keeps the left-to-right order of the reference's sum, so the split
// changes no bit.
//
// What bounds it on an H100: operations (the battery event, the decay and
// the sums per district-building-step, ~1e2 fp32 operations, 3e11 for D =
// 4096 districts of 100 buildings over a year; the prelude's ~70 per
// building-step once), not bytes. In practice the issue rate of the
// ~330 instructions of a district-step (the IEEE divisions and square
// roots of the battery chain, the lookups): the district pass caps a
// thread at 40 registers so that 12 blocks of 128 threads, 48 warps, share
// an SM and keep its four schedulers issuing.
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

#include <cuda_pipeline.h>

#include "thermal_common.cuh"

namespace {

using battery::BatteryShared;
using battery::MAX_KNOTS;
using battery::max_nan;
using battery::min_nan;
using battery::ZERO;

constexpr int PRELUDE_THREADS = 256;
constexpr int THREADS = 128;        // districts per block of the district pass
constexpr int MIN_BLOCKS = 12;      // blocks an SM must hold: 40 registers a thread
constexpr int CHUNK = 128;          // steps staged at a time (ops/neighborhood.py STAGE_CHUNK)

// rows of nparams and of the record, as ops/neighborhood.py names them
enum NRow {
    CN, CE, CTC, CHP,                 // cooling device
    HN, HE, HTH, HHP,                 // heating device
    DN, DE, DTH, DHP,                 // dhw device
    DT_CAP, DT_LOSS,                  // dhw tank
    COOL_ACT, HEAT_ACT, COH_ACT
};
enum Rec { R_NET, R_BBAL, R_BSOC, R_DSOC, R_COUT, R_HOUT, R_DOUT, R_CDEM, R_HDEM };
// rows of the scratch, per building: what the district pass reads per step
enum Stage { ST_PRE, ST_SOLAR, ST_PRICE, ST_CARBON, ST_ABAT, N_STAGE };

struct Args {
    const float *a_coh, *a_cdev, *a_hdev, *a_bat;
    const float *nsl, *solar, *price, *carbon, *cool, *heat, *dhw, *outdoor, *mode;
    const float *bparams, *pec_x, *pec_y, *cpc_x, *cpc_y, *nparams;
    const float *dsoc0, *soc0, *eff0, *deg0;
    float *reward, *cost, *emission, *dsoc, *soc, *eff, *deg, *rec, *stage;
    int D, B, S, S_pad, n_knots, lookback;
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

// 1. The prelude: one thread per (step, building), threads building-fastest.
__global__ void __launch_bounds__(PRELUDE_THREADS) prelude_kernel(const Args a) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;     // t * B + b
    if (o >= a.S * a.B) return;
    const int B = a.B;
    const int t = o / B;
    const int b = o - t * B;

    const Device cooling(a.nparams, CN, false, b, B);
    const Device heating(a.nparams, HN, true, b, B);
    const Device dhw(a.nparams, DN, true, b, B);
    const float de_eff = a.nparams[DE * B + b];
    const bool coh_active = a.nparams[COH_ACT * B + b] > 0.5f;
    const bool cool_ctl = a.nparams[COOL_ACT * B + b] > 0.5f || coh_active;
    const bool heat_ctl = a.nparams[HEAT_ACT * B + b] > 0.5f || coh_active;

    const float t0f = t == 0 ? 1.f : 0.f;
    const float outdoor = a.outdoor[o], mode = a.mode[o];
    const float cool_d = a.cool[o], heat_d = a.heat[o], dhw_d = a.dhw[o];
    const float cop_c = cooling.cop(outdoor);
    const float cop_h = heating.cop(outdoor);
    const float cop_d = dhw.cop(outdoor);

    // reset-time update_variables consumptions, booked at t == 0
    // (building.py:2554-2558, 2618-2652); a heating device that is not a
    // heat pump books through the DHW device's efficiency
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
    // device's output under it, gated by hvac_mode, once the LSTM's input
    // window is full; heating takes no hours ratio (building.py:3146)
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

    // device-only dispatch: every tank is inert and there is no outage, so
    // the end uses decouple
    const float cout = min_nan(cooling_demand, (cooling.nominal - dev_init_c) * cop_c);
    const float ccons = max_nan(0.f, cout / cop_c);
    const float hout = min_nan(heating_demand, (heating.nominal - dev_init_h) * cop_h);
    const float hcons = max_nan(0.f, hout / cop_h);
    const float dout = min_nan(dhw_d, (dhw.nominal - dev_init_d) * cop_d);
    const float dcons = max_nan(0.f, dout / cop_d);

    // update_variables accounting with the t == 0 multi-count
    // (building.py:2615-2703), up to the battery's term
    const float uv_cool = cout / cop_c;
    const float uv_heat = heating.is_hp ? hout / cop_h : hout / de_eff;
    const float uv_dhw = dout / cop_d;
    const float cool_total = ccons + t0f * (reset_cool + uv_cool);
    const float heat_total = hcons + t0f * (reset_heat + uv_heat);
    const float dhw_total = dcons + t0f * (reset_dhw + uv_dhw);
    const float nsl = a.nsl[o];
    const float nsl_term = nsl + t0f * 2.f * nsl;

    float* st = a.stage + static_cast<size_t>(b) * N_STAGE * a.S_pad + t;
    st[ST_PRE * a.S_pad] = cool_total + heat_total + dhw_total + nsl_term;
    st[ST_SOLAR * a.S_pad] = a.solar[o];
    st[ST_PRICE * a.S_pad] = a.price[o];
    st[ST_CARBON * a.S_pad] = a.carbon[o];
    st[ST_ABAT * a.S_pad] = a.a_bat[o];
    if (a.rec != nullptr) {
        const int SB = a.S * B;
        a.rec[R_COUT * SB + o] = cout;
        a.rec[R_HOUT * SB + o] = hout;
        a.rec[R_DOUT * SB + o] = dout;
        a.rec[R_CDEM * SB + o] = cooling_demand;
        a.rec[R_HDEM * SB + o] = heating_demand;
    }
}

// 2. The district pass: block (x, b) holds districts x * THREADS ... of
// building b. Threads past D run on district D - 1's state and write
// nothing. NK > 0 fixes the battery's knot count at compile time.
template <int NK>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) district_kernel(const Args a) {
    __shared__ __align__(16) float rows[2][N_STAGE][CHUNK];
    __shared__ float tab[8];                        // battery rows of this building
    __shared__ float knots[4][MAX_KNOTS];           // pec_x, pec_y, cpc_x, cpc_y
    const int B = a.B, S = a.S, b = blockIdx.y, tid = threadIdx.x;
    const int d = blockIdx.x * THREADS + tid;
    const bool live = d < a.D;
    const int j = (live ? d : a.D - 1) * B + b;    // this pair's entry of a (D, B) tensor

    const float* stage = a.stage + static_cast<size_t>(b) * N_STAGE * a.S_pad;
    auto load_chunk = [&](int c) {
        float(*dst)[CHUNK] = rows[c & 1];
        for (int i = tid; i < N_STAGE * CHUNK / 4; i += THREADS) {
            const int r = i / (CHUNK / 4), q = 4 * (i - r * (CHUNK / 4));
            __pipeline_memcpy_async(&dst[r][q], stage + r * a.S_pad + c * CHUNK + q, 16);
        }
        __pipeline_commit();
    };
    load_chunk(0);
    if (tid < 8) tab[tid] = a.bparams[tid * B + b];
    if (tid < 4 * MAX_KNOTS) {
        const int c = tid / MAX_KNOTS, k = tid - c * MAX_KNOTS;
        const float* curve = c == 0 ? a.pec_x : c == 1 ? a.pec_y : c == 2 ? a.cpc_x : a.cpc_y;
        knots[c][k] = k < a.n_knots ? curve[k * B + b] : 0.f;
    }
    __syncthreads();
    const BatteryShared<NK> bat(tab, knots[0], knots[1], knots[2], knots[3], 0, 1,
                                NK > 0 ? NK : a.n_knots);
    const float dt_cap = a.nparams[DT_CAP * B + b];
    const float dt_keep = 1.f - a.nparams[DT_LOSS * B + b];
    const float dt_cap_safe = max_nan(dt_cap, ZERO);

    float dsoc = a.dsoc0[j];
    float soc = a.soc0[j], eff = a.eff0[j], deg = a.deg0[j];
    float rew = 0.f, cost = 0.f, emis = 0.f;
    const bool recording = a.rec != nullptr && d == 0;
    const int SB = S * B;
    const int n_chunks = (S + CHUNK - 1) / CHUNK;

    for (int c = 0; c < n_chunks; ++c) {
        if (c + 1 < n_chunks) {
            load_chunk(c + 1);        // into the buffer the last chunk was read from
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncthreads();
        const float(*r)[CHUNK] = rows[c & 1];
        const int t0 = c * CHUNK;
        const int n = min(CHUNK, S - t0);
        for (int k = 0; k < n; ++k) {
            const int t = t0 + k;
            // the DHW tank charges 0 each step: its standby loss alone
            dsoc = max_nan(0.f, dsoc * dt_cap * dt_keep) / dt_cap_safe;
            const float balance = battery::event(bat, r[ST_ABAT][k] * bat.nominal * a.hours_ratio,
                                                 a.ratio, soc, eff, deg);
            const float t0f = t == 0 ? 1.f : 0.f;
            const float bat_term = balance + t0f * balance;
            const float net = r[ST_PRE][k] + bat_term - r[ST_SOLAR][k];
            if (recording) {
                const int o = t * B + b;
                a.rec[R_NET * SB + o] = net;
                a.rec[R_BBAL * SB + o] = balance;
                a.rec[R_BSOC * SB + o] = soc;
                a.rec[R_DSOC * SB + o] = dsoc;
            }
            // cost is unclamped (building.py:2686), emission clamps at 0
            // (building.py:2691)
            rew = rew - max_nan(net, 0.f);
            cost = cost + net * r[ST_PRICE][k];
            emis = emis + max_nan(net * r[ST_CARBON][k], 0.f);
        }
        __syncthreads();              // before the next load overwrites this buffer
    }
    if (live) {
        a.reward[j] = rew;
        a.cost[j] = cost;
        a.emission[j] = emis;
        a.dsoc[j] = dsoc;
        a.soc[j] = soc;
        a.eff[j] = eff;
        a.deg[j] = deg;
    }
}

}  // namespace

// `stage`: float32 scratch of B * N_STAGE * S_pad, S_pad a multiple of
// CHUNK at least S.
extern "C" int neighborhood_episode_launch(
        const float* a_coh, const float* a_cdev, const float* a_hdev, const float* a_bat,
        const float* nsl, const float* solar, const float* price, const float* carbon,
        const float* cool, const float* heat, const float* dhw, const float* outdoor,
        const float* mode, const float* bparams, const float* pec_x, const float* pec_y,
        const float* cpc_x, const float* cpc_y, const float* nparams, const float* dsoc0,
        const float* soc0, const float* eff0, const float* deg0,
        float* reward, float* cost, float* emission, float* dsoc, float* soc, float* eff,
        float* deg, float* rec, float* stage, int D, int B, int S, int S_pad, int n_knots,
        int lookback, float hours_ratio, float ratio, void* stream) {
    if (S_pad % CHUNK != 0 || S_pad < S) return static_cast<int>(cudaErrorInvalidValue);
    const Args a = {a_coh, a_cdev, a_hdev, a_bat,
                    nsl, solar, price, carbon, cool, heat, dhw, outdoor, mode,
                    bparams, pec_x, pec_y, cpc_x, cpc_y, nparams,
                    dsoc0, soc0, eff0, deg0,
                    reward, cost, emission, dsoc, soc, eff, deg, rec, stage,
                    D, B, S, S_pad, n_knots, lookback, hours_ratio, ratio};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    prelude_kernel<<<(S * B + PRELUDE_THREADS - 1) / PRELUDE_THREADS, PRELUDE_THREADS, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((D + THREADS - 1) / THREADS, B);
    if (n_knots == 5) {          // a build for 5 knots, any other count at run time
        district_kernel<5><<<grid, THREADS, 0, s>>>(a);
    } else {
        district_kernel<0><<<grid, THREADS, 0, s>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}
