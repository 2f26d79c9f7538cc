// Whole-episode rollout of a batch of EV districts (battery+PV buildings,
// EV chargers, electric vehicles, washing machines) under shared
// open-loop action plans, with the default reward or the
// Electric_Vehicles_Reward_Function (kernel K4).
//
// Replaces citylearn_tpu/ops/pallas_ev.py::ev_episode (body
// _episode_kernel). The Pallas kernel tiles 256 districts x 128 lanes,
// streams sixteen series through VMEM in double-buffered chunks and moves
// state between charger and EV lanes with one-hot matrix products; none of
// that carries over. Here one warp owns one district. Its carried state
// (battery, EV and machine state, the three sums) and the values that
// cross lanes live in shared memory, and each step runs in phases
// separated by __syncwarp():
//
//   1. EV lanes apply the SOC events, machine lanes their trigger;
//   2. building lanes and charger lanes together run ONE battery event
//      each, the building's own or that of the EV connected to the
//      charger, read straight from the EV's row (a direct indexed read and
//      write in place of the gather and scatter products);
//   3. building lanes sum their chargers and machines, in charger order,
//      and do the accounting;
//   4. with the EV reward: a tree sum of the district's net load, the
//      per-building multiplier, the per-charger terms on the charger lanes,
//      and their sum into buildings, in charger order.
//
// Lanes loop in strides of 32, so any count of buildings, chargers, EVs
// and machines up to 128 runs. Every floating-point sum has a fixed order
// and the plain PyTorch version (ops/ev.py::ev_episode_reference) sums in
// the same order; there is no atomic. Built with -fmad=false and IEEE
// division and square root, every operation rounds as the plain version
// rounds it.
//
// What bounds it on an H100: like K1 and K3, neither bytes (plans and
// series are shared by every district and stay in L1/L2) nor fp32
// throughput, but the latency of each step's dependent chain (EV events,
// then a charger lookup and a battery event, then the sums and the
// reward) times S steps, with one warp per district in flight. Phase 2
// takes the building and the EV battery events as one code path, so the
// two events of the chain cost one; the launch bounds keep every
// district of a 4096-district batch resident at once.
//
// Outside the contract: one EV connected to two chargers in the same step
// (the Pallas kernel adds the two updates, the stepped path keeps one);
// the data never holds it.

#include "battery_common.cuh"

namespace {

using battery::BatteryView;
using battery::interp_at;
using battery::max_nan;
using battery::min_nan;

constexpr int WARPS = 4;        // districts per block
// blocks an SM must hold: caps the kernel at 64 registers, so that an SM
// holds 32 warps and 4096 districts run on 132 SMs in one wave
constexpr int MIN_BLOCKS = 8;

// recorded rows of district 0, as ops/ev.py names them
enum Rec { R_NET, R_BBAL, R_BSOC, R_CHC, R_WMC, R_REW };

struct Args {
    // plans and streams, (S, n) with n the count of their lanes
    const float *a_bat, *a_ev, *a_wm, *viol, *nsl, *solar, *price, *carbon;
    const int* conn;
    const float *req, *dep, *force, *drift, *wm_start, *wm_end, *wm_load;
    // tables: battery rows (8, n) and knot-major curves (knots, n)
    const float *bparams, *pec_x, *pec_y, *cpc_x, *cpc_y;
    const float *cparams, *ch_cx, *ch_cy, *ch_dx, *ch_dy;
    const float *evparams, *ev_px, *ev_py, *ev_cx, *ev_cy;
    const int *ch_bld, *wm_bld;
    // state in
    const float *soc0, *eff0, *deg0, *evsoc0, *eveff0, *evdeg0, *wmi0;
    // out
    float *reward, *cost, *emission, *soc, *eff, *deg, *evsoc, *eveff, *evdeg, *wmi, *rec;
    int D, B, C, V, W, S, n_knots, ev_knots, ch_knots, use_ev_reward;
    float hours_ratio, ratio, penalty;
    // reward weights, products of constants taken on the host
    float w_bl, w_imposs, w_under2, w_under_sq, w_close, w_esp, w_esp_half, w_sc, w_sc_half;
};

// floats of shared memory one district needs
__host__ __device__ inline int floats_per_district(int B, int C, int V, int W, int P2) {
    return 9 * B + 4 * V + 2 * W + 4 * C + P2;
}

__host__ __device__ inline int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS) ev_episode_kernel(const Args p) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int d = blockIdx.x * WARPS + warp;
    if (d >= p.D) return;       // whole warps leave; only __syncwarp() follows
    const int B = p.B, C = p.C, V = p.V, W = p.W, S = p.S;
    const int P2 = pow2_at_least(B);

    float* soc = smem + warp * floats_per_district(B, C, V, W, P2);
    float* eff = soc + B;
    float* deg = eff + B;
    float* rew = deg + B;
    float* cost = rew + B;
    float* emis = cost + B;
    float* bal = emis + B;          // battery balance of this step
    float* net = bal + B;
    float* mult = net + B;          // reward multiplier of this step
    float* evsoc = mult + B;        // EV SOC entering the step
    float* evnext = evsoc + V;      // and leaving it
    float* eveff = evnext + V;
    float* evdeg = eveff + V;
    float* wmi = evdeg + V;
    float* wmc = wmi + W;           // machine consumption of this step
    float* cons = wmc + W;          // per charger: consumption,
    float* last = cons + C;         //   energy of the action,
    float* socprev = last + C;      //   its EV's SOC before the step,
    float* perc = socprev + C;      //   reward terms
    float* red = perc + C;          // P2 floats for the tree sum

    for (int b = lane; b < B; b += 32) {
        soc[b] = p.soc0[d * B + b];
        eff[b] = p.eff0[d * B + b];
        deg[b] = p.deg0[d * B + b];
        rew[b] = 0.f;
        cost[b] = 0.f;
        emis[b] = 0.f;
    }
    for (int v = lane; v < V; v += 32) {
        evsoc[v] = p.evsoc0[d * V + v];
        eveff[v] = p.eveff0[d * V + v];
        evdeg[v] = p.evdeg0[d * V + v];
    }
    for (int w = lane; w < W; w += 32) wmi[w] = p.wmi0[d * W + w];
    __syncwarp();

    const bool recording = p.rec != nullptr && d == 0;
    const int SB = S * B;

    for (int t = 0; t < S; ++t) {
        const bool t0 = t == 0;

        // ---- 1. EV SOC events (force, else drift, else the initial SOC
        // at t == 0 and 0 after), machine triggers ----
        for (int v = lane; v < V; v += 32) {
            const float f = p.force[t * V + v], dr = p.drift[t * V + v];
            const float base = t0 ? p.evparams[3 * V + v] : 0.f;
            evnext[v] = f == f ? f
                      : dr == dr ? min_nan(max_nan(evsoc[v] * dr, 0.f), 1.f) : base;
        }
        for (int w = lane; w < W; w += 32) {
            const int o = t * W + w;
            const float ws = p.wm_start[o], we = p.wm_end[o], tf = static_cast<float>(t);
            // a window that differs from the previous step's re-arms the machine
            const bool changed = !t0 && (p.wm_start[o - W] != ws || p.wm_end[o - W] != we);
            const bool initiated = wmi[w] > 0.5f && !changed;
            const bool trigger = !initiated && p.a_wm[o] > 0.f && ws != -1.f && we != -1.f
                && ws <= tf && tf <= we;
            wmc[w] = trigger ? p.wm_load[o] : 0.f;
            wmi[w] = (initiated || trigger) ? 1.f : 0.f;
        }
        __syncwarp();

        // ---- 2. one battery event per building and per charger ----
        for (int i = lane; i < B + C; i += 32) {
            const bool building = i < B;
            const int c = i - B;
            const float *tab, *px, *py, *cx, *cy;
            int idx, N, knots, ev = -1;
            float energy, x_soc, x_eff, x_deg;
            float a_c = 0.f, energy_c = 0.f, eff_c = 1.f;
            if (building) {
                tab = p.bparams, px = p.pec_x, py = p.pec_y, cx = p.cpc_x, cy = p.cpc_y;
                idx = i, N = B, knots = p.n_knots;
                x_soc = soc[i], x_eff = eff[i], x_deg = deg[i];
                energy = p.a_bat[t * B + i] * tab[1 * B + i] * p.hours_ratio;
            } else {
                // the charger's request: power limits, then its efficiency
                // at |action| (electric_vehicle_charger.py:252-329)
                a_c = p.a_ev[t * C + c];
                const float maxc = p.cparams[0 * C + c], minc = p.cparams[1 * C + c];
                const float maxd = p.cparams[2 * C + c], mind = p.cparams[3 * C + c];
                const bool chg = a_c > 0.f;
                energy_c = chg ? max_nan(min_nan(a_c * maxc * p.hours_ratio, maxc), minc)
                               : max_nan(min_nan(a_c * maxd * p.hours_ratio, -mind), -maxd);
                eff_c = chg ? interp_at(fabsf(a_c), p.ch_cx, p.ch_cy, c, C, p.ch_knots)
                            : interp_at(fabsf(a_c), p.ch_dx, p.ch_dy, c, C, p.ch_knots);
                energy = chg ? energy_c * eff_c : energy_c / eff_c;
                // the connected EV's battery; a lane with no EV steps EV 0
                // on constants and drops the result
                ev = p.conn[t * C + c];
                tab = p.evparams, px = p.ev_px, py = p.ev_py, cx = p.ev_cx, cy = p.ev_cy;
                idx = max(ev, 0), N = V, knots = p.ev_knots;
                const bool on = ev >= 0;
                // the charge reads the evented SOC only at t == 0
                x_soc = on ? (t0 ? evnext[idx] : evsoc[idx]) : 0.5f;
                x_eff = on ? eveff[idx] : 1.f;
                x_deg = on ? evdeg[idx] : 1.f;
            }
            const BatteryView view(tab, px, py, cx, cy, idx, N, knots);
            const float balance = battery::event(view, energy, p.ratio, x_soc, x_eff, x_deg);
            if (building) {
                soc[i] = x_soc, eff[i] = x_eff, deg[i] = x_deg;
                bal[i] = balance;
            } else {
                const bool applied = a_c != 0.f && ev >= 0;
                const float b_c = applied ? balance : 0.f;
                cons[c] = applied ? (b_c >= 0.f ? b_c / eff_c : b_c * eff_c) : 0.f;
                last[c] = a_c != 0.f ? energy_c : 0.f;
                if (ev >= 0) socprev[c] = t0 ? p.evparams[3 * V + ev] : evsoc[ev];
                if (applied) evnext[ev] = x_soc, eveff[ev] = x_eff, evdeg[ev] = x_deg;
            }
        }
        __syncwarp();

        // ---- 3. chargers and machines into buildings, accounting with the
        // t == 0 multi-count (building.py:2615-2703) ----
        for (int b = lane; b < B; b += 32) {
            float chc = 0.f, wm_b = 0.f;
            for (int c = 0; c < C; ++c) {
                if (p.ch_bld[c] == b) chc = chc + cons[c];
            }
            for (int w = 0; w < W; ++w) {
                if (p.wm_bld[w] == b) wm_b = wm_b + wmc[w];
            }
            const int o = t * B + b;
            const float nsl = p.nsl[o];
            const float nsl_term = t0 ? 3.f * nsl : nsl;
            const float bat_term = t0 ? 2.f * bal[b] : bal[b];
            const float n = nsl_term + bat_term + chc + wm_b - p.solar[o];
            net[b] = n;
            cost[b] = cost[b] + n * p.price[o];
            emis[b] = emis[b] + max_nan(n * p.carbon[o], 0.f);
            if (recording) {
                p.rec[R_NET * SB + o] = n;
                p.rec[R_BBAL * SB + o] = bal[b];
                p.rec[R_BSOC * SB + o] = soc[b];
                p.rec[R_CHC * SB + o] = chc;
                p.rec[R_WMC * SB + o] = wm_b;
            }
            if (!p.use_ev_reward) {
                const float r = -max_nan(n, 0.f);
                rew[b] = rew[b] + r;
                if (recording) p.rec[R_REW * SB + o] = r;
            }
        }

        // ---- 4. Electric_Vehicles_Reward_Function
        // (reward_function.py:389-517) ----
        if (p.use_ev_reward) {
            __syncwarp();
            // district net load: pairwise tree over P2 slots, zeros past B
            for (int i = lane; i < P2; i += 32) red[i] = i < B ? net[i] : 0.f;
            __syncwarp();
            for (int s = P2 >> 1; s > 0; s >>= 1) {
                for (int i = lane; i < s; i += 32) red[i] = red[i] + red[i + s];
                __syncwarp();
            }
            const float total = max_nan(0.f, red[0]);
            for (int b = lane; b < B; b += 32) {
                const float neg = -net[b];
                const float sign = static_cast<float>((neg > 0.f) - (neg < 0.f));
                const float marl = sign * 0.01f * (neg * neg) * total;
                mult[b] = 1.f / (1.f + fabsf(marl));
            }
            __syncwarp();
            for (int c = lane; c < C; c += 32) {
                const int o = t * C + c;
                const int ev = p.conn[o];
                float r = 0.f;
                if (ev >= 0) {
                    const int bl = p.ch_bld[c];
                    const float m = mult[bl], net_c = net[bl], l = last[c];
                    const float g_cap = p.evparams[0 * V + ev], g_dod = p.evparams[4 * V + ev];
                    const float maxc = p.cparams[0 * C + c], maxd = p.cparams[2 * C + c];
                    const float dep = p.dep[o];
                    const float min_cap = (1.f - g_dod) * g_cap;
                    const float cur_e = socprev[c] * g_cap + l;
                    const float c_bl = (cur_e > g_cap || cur_e < min_cap) ? p.w_bl * m : 0.f;
                    const float soc_diff = evnext[ev] - p.req[o];
                    const float diff_kwh = soc_diff * g_cap;
                    const float mpc = maxc * dep, mpd = maxd * dep;
                    const float c_imp = diff_kwh > mpc ? p.w_imposs * m : 0.f;
                    const bool at_dep = dep == 0.f;
                    const float c_under =
                        (at_dep && -0.25f < soc_diff && soc_diff <= -0.10f) ? p.w_under2 * m
                        : (at_dep && soc_diff <= -0.25f) ? p.w_under_sq * m : 0.f;
                    const float c_close =
                        ((at_dep && -0.10f < soc_diff && soc_diff <= 0.10f) ? p.w_close * m : 0.f)
                        + (fabsf(diff_kwh) <= max_nan(mpc, mpd)
                           ? p.w_close * m * (1.f / (dep + 0.1f)) : 0.f);
                    const float c_esp = (l > 0.f && net_c < 0.f) ? p.w_esp * m
                                      : (l < 0.f && net_c < 0.f) ? p.w_esp_half * m : 0.f;
                    const float c_sc = (l < 0.f && net_c > 0.f) ? p.w_sc * m
                                     : (l > 0.f && net_c > 0.f) ? p.w_sc_half * m : 0.f;
                    r = c_bl + c_imp + c_under + c_close + c_esp + c_sc;
                }
                perc[c] = r;
            }
            __syncwarp();
            for (int b = lane; b < B; b += 32) {
                float r = 0.f;
                for (int c = 0; c < C; ++c) {
                    if (p.ch_bld[c] == b) r = r + perc[c];
                }
                const int o = t * B + b;
                r = r - p.penalty * max_nan(p.viol[o], 0.f);
                rew[b] = rew[b] + r;
                if (recording) p.rec[R_REW * SB + o] = r;
            }
        }
        __syncwarp();
        float* swap = evsoc;
        evsoc = evnext;
        evnext = swap;
    }

    for (int b = lane; b < B; b += 32) {
        const int o = d * B + b;
        p.reward[o] = rew[b];
        p.cost[o] = cost[b];
        p.emission[o] = emis[b];
        p.soc[o] = soc[b];
        p.eff[o] = eff[b];
        p.deg[o] = deg[b];
    }
    for (int v = lane; v < V; v += 32) {
        p.evsoc[d * V + v] = evsoc[v];
        p.eveff[d * V + v] = eveff[v];
        p.evdeg[d * V + v] = evdeg[v];
    }
    for (int w = lane; w < W; w += 32) p.wmi[d * W + w] = wmi[w];
}

}  // namespace

// ptrs: the 51 arrays in Args' order; dims: D, B, C, V, W, S, n_knots,
// ev_knots, ch_knots, use_ev_reward; scalars: hours_ratio, ratio, penalty
// and the nine reward weights. All three are host arrays.
extern "C" int ev_episode_launch(const void* const* ptrs, const int* dims,
                                 const float* scalars, void* stream) {
    Args a;
    int k = 0;
    auto f = [&]() { return static_cast<const float*>(ptrs[k++]); };
    auto n = [&]() { return static_cast<const int*>(ptrs[k++]); };
    auto o = [&]() { return static_cast<float*>(const_cast<void*>(ptrs[k++])); };
    a.a_bat = f(), a.a_ev = f(), a.a_wm = f(), a.viol = f();
    a.nsl = f(), a.solar = f(), a.price = f(), a.carbon = f();
    a.conn = n();
    a.req = f(), a.dep = f(), a.force = f(), a.drift = f();
    a.wm_start = f(), a.wm_end = f(), a.wm_load = f();
    a.bparams = f(), a.pec_x = f(), a.pec_y = f(), a.cpc_x = f(), a.cpc_y = f();
    a.cparams = f(), a.ch_cx = f(), a.ch_cy = f(), a.ch_dx = f(), a.ch_dy = f();
    a.evparams = f(), a.ev_px = f(), a.ev_py = f(), a.ev_cx = f(), a.ev_cy = f();
    a.ch_bld = n(), a.wm_bld = n();
    a.soc0 = f(), a.eff0 = f(), a.deg0 = f();
    a.evsoc0 = f(), a.eveff0 = f(), a.evdeg0 = f(), a.wmi0 = f();
    a.reward = o(), a.cost = o(), a.emission = o(), a.soc = o(), a.eff = o(), a.deg = o();
    a.evsoc = o(), a.eveff = o(), a.evdeg = o(), a.wmi = o(), a.rec = o();
    a.D = dims[0], a.B = dims[1], a.C = dims[2], a.V = dims[3], a.W = dims[4], a.S = dims[5];
    a.n_knots = dims[6], a.ev_knots = dims[7], a.ch_knots = dims[8];
    a.use_ev_reward = dims[9];
    a.hours_ratio = scalars[0], a.ratio = scalars[1], a.penalty = scalars[2];
    a.w_bl = scalars[3], a.w_imposs = scalars[4], a.w_under2 = scalars[5];
    a.w_under_sq = scalars[6], a.w_close = scalars[7], a.w_esp = scalars[8];
    a.w_esp_half = scalars[9], a.w_sc = scalars[10], a.w_sc_half = scalars[11];

    const int per_district = floats_per_district(a.B, a.C, a.V, a.W, pow2_at_least(a.B));
    const size_t shared = sizeof(float) * WARPS * per_district;   // <= 40 KB at 128 lanes
    const int blocks = (a.D + WARPS - 1) / WARPS;
    ev_episode_kernel<<<blocks, 32 * WARPS, shared, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
