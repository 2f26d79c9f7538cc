// Whole-episode rollout of a batch of LSTM-dynamics districts (the 2023
// challenge family) under shared open-loop action plans (kernel K5):
// partial-load cooling from the cooling_device action, the cooling and DHW
// end uses and the battery with the power-outage coupling, the stacked
// LSTM that predicts the indoor temperature over a lookback window (re-run
// every step from its carried hidden state) and the ComfortReward.
//
// Replaces citylearn_tpu/ops/pallas_lstm.py::lstm_episode (body
// _episode_kernel). The Pallas kernel tiles 256 districts x 128 lanes,
// packs every building's LSTM block-diagonally into (256, 512) matrices so
// that a window step is one matrix product for the whole tile, scatters
// the two dynamic channels into the lane layout with one-hot products,
// keeps a (lookback + 1, 256, 128) ring of whole input columns and streams
// 18 series in double-buffered chunks. None of that layout carries over.
//
// Here one thread owns one (district, building) pair and runs the S-step
// recurrence, as K1 and K3 do, with threads ordered building-major so that
// the 32 threads of a warp hold 32 districts of ONE building. The gate
// products are computed in this kernel, thread by thread: every lane of a
// warp multiplies its own input and hidden values by the same weight, which
// all lanes read from the same address through L1 (one 16-byte load serves
// four multiply-adds of 32 districts). The weights are stored input by
// input, so that one input value feeds the 4H gate rows at once: 4H
// independent chains of multiply-adds. Each multiply-add instruction
// therefore does 32 useful ones, the activations run 32 wide, and no value
// crosses lanes: no shuffle, no shared-memory exchange, no barrier. The
// alternative of one warp per (district, building) with a gate row per lane
// needs three shuffles per hidden unit to bring a unit's four gates
// together, H more to hand the new hidden vector to every lane, and runs
// the physics chain on one useful lane in 32: about five times the
// instructions for the same work.
//
// Only the two dynamic channels (normalized cooling demand and temperature)
// differ from district to district, so the carried ring is 2 x (lookback + 1)
// floats per thread, in shared memory, addressed modulo its length; the
// static channels are read from the shared stream at the row of the window
// position. The quirks of the reference are kept: the temperature channel
// reads one position older than the others, the newest temperature is
// overwritten by the prediction once the window is full (t >= lookback),
// (h, c) carry over only from then on (before, the window would start from
// zeros and its result be dropped, so it is not run), and partial load
// starts at t >= lookback + 1.
//
// A building with 8 hidden units and 12 channels (the 2023 datasets) takes
// a path whose loops unroll fully, with x, h and c in registers. Any other
// shape up to MAX_H units and MAX_F channels takes the same code with
// runtime bounds and its vectors in local memory: right, and slower.
//
// What bounds it on an H100: operations. A building-step does about
// lookback x (2*4H*(F+H) + 2*4H*2H) = 27,648 gate operations at H = 8,
// F = 12, two layers, against a few hundred for the physics and a few
// bytes. Measured on an H100 at D = 4096, B = 3 the launch runs at about a
// tenth of that bound and splits about evenly between the multiply-adds,
// the weight loads (the load unit takes 4 cycles to hand 16 bytes to 32
// lanes even from one address) and the activations (two special-function
// instructions each); the physics is a twelfth of it.
// The physics (csrc/thermal_common.cuh's blocks with the
// flexibility cap, csrc/battery_common.cuh's event) is built with
// -fmad=false and IEEE division and square root, so that it rounds as the
// plain PyTorch version (ops/lstm.py::lstm_episode_reference) rounds it and
// the eight physics outputs and eleven physics rows are bit-equal. The gate
// products use explicit fused multiply-adds and the activations the
// hardware's exp2 and reciprocal: the temperature, the reward and their
// sums agree with the plain version to a tolerance, not to the bit.

#include "thermal_common.cuh"

namespace {

using battery::BatteryView;
using battery::max_nan;
using battery::min_nan;
using thermal::BlockResult;
using thermal::EndUse;
using thermal::flexibility;

constexpr int MAX_H = 64;   // ops/lstm.py MAX_HIDDEN
constexpr int MAX_F = 32;   // ops/lstm.py MAX_CHANNELS
constexpr int THREADS = 64;

// rows of lparams and of the record, columns of meta, as ops/lstm.py names them
enum LRow { L_NMIN_CC, L_NSPAN_CC, L_NMIN_TC, L_NSPAN_TC, L_LIN_B, L_COOL_ACTIVE };
enum Rec { R_NET, R_CBAL, R_DBAL, R_BBAL, R_CSOC, R_DSOC, R_BSOC, R_COUT, R_DOUT,
           R_TEMP, R_REWARD, R_CDEM, R_NSLMET };
enum Meta { M_LAYERS, M_HIDDEN, M_CHANNELS, M_TEMP_CH, M_COOL_CH, M_X_OFF, M_W_OFF, N_META };

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
template <int HC, int INC>
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
#pragma unroll
    for (int k = 0; k < in_p + h_p; ++k) {
        const float v = k < in_p ? xin[k] : h[k - in_p];
#pragma unroll
        for (int r = 0; r < H; ++r) {
            const float4 q = __ldg(w4 + k * H + r);
            acc[4 * r + 0] = __fmaf_rn(q.x, v, acc[4 * r + 0]);
            acc[4 * r + 1] = __fmaf_rn(q.y, v, acc[4 * r + 1]);
            acc[4 * r + 2] = __fmaf_rn(q.z, v, acc[4 * r + 2]);
            acc[4 * r + 3] = __fmaf_rn(q.w, v, acc[4 * r + 3]);
        }
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

__device__ __forceinline__ float powe(float d, float e) {
    if (e == 1.f) return d;
    if (e == 2.f) return d * d;
    if (e == 3.f) return d * d * d;
    return powf(d, e);
}

// ComfortReward (reward_function.py:216-340); heating is the kernel's
// test 0 > cooling observation (the heating observation is 0 here)
__device__ __forceinline__ float comfort(float T, float mode, float csp, float hsp, float band,
                                         bool heating, float lo_exp, float hi_exp) {
    if (mode == 1.f || mode == 2.f) {
        const float sp = mode == 1.f ? csp : hsp;
        const float d = fabsf(T - sp);
        if (T < sp - band) return -(mode == 2.f ? powe(d, lo_exp) : powe(d, hi_exp));
        if (T < sp) return heating ? 0.f : -d;
        if (T <= sp + band) return heating ? -d : 0.f;
        return -(heating ? powe(d, hi_exp) : powe(d, lo_exp));
    }
    const float cd = fabsf(T - csp), hd = fabsf(T - hsp);
    if (T < hsp - band) return -(heating ? powe(hd, lo_exp) : powe(hd, hi_exp));
    if (T < hsp) return -hd;
    if (T <= csp) return 0.f;
    if (T < csp + band) return -cd;
    return -(heating ? powe(cd, hi_exp) : powe(cd, lo_exp));
}

struct Args {
    const float *a_cdev, *a_cstor, *a_dstor, *a_bat;
    const float *nsl, *solar, *price, *carbon, *cool, *dhw, *outdoor, *mode, *temp, *csp, *hsp,
        *band, *schan, *outage;
    const float *bparams, *pec_x, *pec_y, *cpc_x, *cpc_y, *tparams, *lparams, *weights;
    const float *csoc0, *dsoc0, *soc0, *eff0, *deg0;
    const int* meta;
    float *reward, *cost, *emission, *csoc, *dsoc, *soc, *eff, *deg, *last_temp, *rec;
    int D, B, S, X, n_knots, lookback;
    float hours_ratio, ratio, lo_exp, hi_exp;
};

// The episode of thread (d, b). HC and FC are the building's hidden size
// and channel count where the caller knows them at compile time (a multiple
// of 4 each), 0 where they are read from meta.
template <int HC, int FC>
__device__ __forceinline__ void run_episode(const Args& a, int d, int b, float* ring) {
    const int B = a.B, S = a.S, lookback = a.lookback;
    const int i = d * B + b;
    const int* meta = a.meta + b * N_META;
    const int L = meta[M_LAYERS];
    const int H = HC > 0 ? HC : meta[M_HIDDEN];
    const int F = FC > 0 ? FC : meta[M_CHANNELS];
    const int tc = meta[M_TEMP_CH], cc = meta[M_COOL_CH];
    const int HP = (H + 3) / 4 * 4, FP = (F + 3) / 4 * 4;
    constexpr int HA = HC > 0 ? HC : MAX_H;     // array lengths
    constexpr int FA = FC > 0 ? FC : MAX_F;
    constexpr int F4 = FC / 4;                  // 0: runtime bounds

    // this building's weights in the flat buffer (ops/lstm.py LstmWeights)
    const float* rows1 = a.weights + meta[M_W_OFF];
    const float* bias1 = rows1 + 4 * H * (FP + HP);
    const float* rows2 = bias1 + 4 * H;
    const float* bias2 = rows2 + 4 * H * (HP + HP);
    const float* lin_w = L == 2 ? bias2 + 4 * H : rows2;
    const float* schan = a.schan + meta[M_X_OFF];

    const BatteryView bat(a.bparams, a.pec_x, a.pec_y, a.cpc_x, a.cpc_y, b, B, a.n_knots);
    const EndUse cooling(a.tparams, thermal::CN, thermal::CT_CAP, thermal::CT_CONV, false, b, B);
    const EndUse dhw(a.tparams, thermal::DN, thermal::DT_CAP, thermal::DT_CONV, true, b, B);
    const float nmin_cc = a.lparams[L_NMIN_CC * B + b], nspan_cc = a.lparams[L_NSPAN_CC * B + b];
    const float nmin_tc = a.lparams[L_NMIN_TC * B + b], nspan_tc = a.lparams[L_NSPAN_TC * B + b];
    const float lin_b = a.lparams[L_LIN_B * B + b];
    const bool cool_active = a.lparams[L_COOL_ACTIVE * B + b] > 0.5f;

    // the ring of this thread: slot s of channel ch at ring[(ch * RING + s) * THREADS]
    const int RING = lookback + 1;
    float* ring_c = ring;
    float* ring_t = ring + RING * THREADS;

    float h1[HA], c1[HA], h2[HA], c2[HA], hn[HA], x[FA];
#pragma unroll
    for (int j = 0; j < HA; ++j) {
        h1[j] = c1[j] = h2[j] = c2[j] = hn[j] = 0.f;
    }
#pragma unroll
    for (int f = 0; f < FA; ++f) x[f] = 0.f;

    float csoc = a.csoc0[i], dsoc = a.dsoc0[i];
    float soc = a.soc0[i], eff = a.eff0[i], deg = a.deg0[i];
    float rew = 0.f, cost = 0.f, emis = 0.f, temp_last = 0.f;
    const bool recording = a.rec != nullptr && d == 0;
    const int SB = S * B;
    int tail = 0;                                // t % RING

    for (int t = 0; t < S; ++t) {
        const int o = t * B + b;
        const float t0f = t == 0 ? 1.f : 0.f;
        const float nsl = a.nsl[o], solar = a.solar[o];
        const float cool_ideal = a.cool[o], dhw_d = a.dhw[o];
        const float mode = a.mode[o], temp_ideal = a.temp[o];
        const bool outage = a.outage[o] > 0.f;
        const float cop_c = cooling.cop(a.outdoor[o]);
        const float cop_d = dhw.cop(a.outdoor[o]);

        // reset-time update_variables consumptions, booked at t == 0
        // (building.py:2554-2558, 2618-2652)
        const float reset_cool = cool_ideal / cop_c;
        const float reset_dhw = dhw_d / cop_d;
        const float dev_init_c = t0f * reset_cool, dev_init_d = t0f * reset_dhw;

        // partial-load cooling demand (building.py:3080-3121): the device
        // action sets the available electric power; demand becomes the
        // device's maximum output, gated by hvac_mode, once the LSTM's
        // input window is full
        const float elec_c = a.a_cdev[o] * cooling.nominal * a.hours_ratio;
        float partial_c = min_nan(elec_c, cooling.nominal - dev_init_c) * cop_c;
        partial_c = (mode == 1.f || mode == 3.f) ? partial_c : 0.f;
        const float cooling_demand =
            (t >= lookback + 1 && cool_active) ? partial_c : cool_ideal;

        // a discharging battery runs first and books its balance
        // (building.py:1606-1609); a charging one runs last, under the
        // flexibility left after every other load (building.py:1791-1812)
        const float bat_energy = a.a_bat[o] * bat.nominal * a.hours_ratio;
        const bool bat_dis = bat_energy < 0.f;
        float balance = 0.f;
        if (bat_dis) balance = battery::event(bat, bat_energy, a.ratio, soc, eff, deg);
        float accum = t0f * (reset_cool + reset_dhw + nsl) + balance;

        // cooling takes no hours ratio, DHW does (building.py:1663, 1765)
        const BlockResult c = cooling.step<true>(cooling_demand, a.a_cstor[o], cop_c, dev_init_c,
                                                 1.f, a.ratio, csoc, outage, solar, accum);
        accum = accum + c.cons;
        const BlockResult w = dhw.step<true>(dhw_d, a.a_dstor[o], cop_d, dev_init_d,
                                             a.hours_ratio, a.ratio, dsoc, outage, solar, accum);
        accum = accum + w.cons;
        const float nsl_met = min_nan(nsl, flexibility(outage, solar, accum));
        accum = accum + nsl_met;
        if (!bat_dis) {
            balance = battery::event(bat, min_nan(bat_energy, flexibility(outage, solar, accum)),
                                     a.ratio, soc, eff, deg);
        }

        // update_variables accounting with the t == 0 multi-count
        // (building.py:2615-2703); an outage zeroes the net
        const float uv_cool = (c.out + c.balance) / cop_c;
        const float uv_dhw = (w.out + w.balance) / cop_d;
        const float cool_total = c.cons + t0f * (reset_cool + uv_cool);
        const float dhw_total = w.cons + t0f * (reset_dhw + uv_dhw);
        const float nsl_term = nsl_met + t0f * (nsl + nsl_met);
        const float bat_term = balance + t0f * balance;
        float net = cool_total + dhw_total + nsl_term + bat_term - solar;
        net = outage ? 0.f : net;

        // ---- LSTM temperature prediction (building.py:2935-3078) ----
        const float cool_obs = c.out + max_nan(-c.balance, 0.f);
        ring_c[tail * THREADS] = (cool_obs - nmin_cc) / nspan_cc;
        float temp_n = (temp_ideal - nmin_tc) / nspan_tc;
        float temp_t = temp_ideal;
        if (t >= lookback) {
            // window position s reads the static channels and the cooling
            // demand of row t - lookback + 1 + s and the temperature of the
            // row before (building.py:3039-3055)
            int slot_t = tail + 1 == RING ? 0 : tail + 1;          // row t - lookback
            for (int s = 0; s < lookback; ++s) {
                const int slot_m = slot_t + 1 == RING ? 0 : slot_t + 1;
                const float4* srow = reinterpret_cast<const float4*>(
                    schan + (size_t)(t - lookback + 1 + s) * a.X);
                const float xc = ring_c[slot_m * THREADS], xt = ring_t[slot_t * THREADS];
                const int n4 = F4 > 0 ? F4 : FP / 4;
#pragma unroll
                for (int k = 0; k < n4; ++k) {
                    const float4 q = __ldg(srow + k);
                    const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int f = 4 * k + e;
                        x[f] = f == cc ? xc : f == tc ? xt : v[e];
                    }
                }
                lstm_cell<HC, FC>(rows1, bias1, H, FP, HP, x, h1, c1, hn);
#pragma unroll
                for (int j = 0; j < H; ++j) h1[j] = hn[j];
                if (L == 2) {
                    lstm_cell<HC, HC>(rows2, bias2, H, HP, HP, h1, h2, c2, hn);
#pragma unroll
                    for (int j = 0; j < H; ++j) h2[j] = hn[j];
                }
                slot_t = slot_m;
            }
            // the head reads the top layer's last hidden output
            temp_n = L == 2 ? head<HC>(lin_w, h2, HP, lin_b) : head<HC>(lin_w, h1, HP, lin_b);
            temp_t = temp_n * nspan_tc + nmin_tc;
        }
        // the newest temperature entry: the data until the window is full,
        // the prediction from then on (building.py:3060-3065)
        ring_t[tail * THREADS] = temp_n;
        tail = tail + 1 == RING ? 0 : tail + 1;

        const float r = comfort(temp_t, mode, a.csp[o], a.hsp[o], a.band[o], 0.f > cool_obs,
                                a.lo_exp, a.hi_exp);
        if (recording) {
            a.rec[R_NET * SB + o] = net;
            a.rec[R_CBAL * SB + o] = c.balance;
            a.rec[R_DBAL * SB + o] = w.balance;
            a.rec[R_BBAL * SB + o] = balance;
            a.rec[R_CSOC * SB + o] = csoc;
            a.rec[R_DSOC * SB + o] = dsoc;
            a.rec[R_BSOC * SB + o] = soc;
            a.rec[R_COUT * SB + o] = c.out;
            a.rec[R_DOUT * SB + o] = w.out;
            a.rec[R_TEMP * SB + o] = temp_t;
            a.rec[R_REWARD * SB + o] = r;
            a.rec[R_CDEM * SB + o] = cooling_demand;
            a.rec[R_NSLMET * SB + o] = nsl_met;
        }
        // cost is unclamped (building.py:2686), emission clamps at 0
        // (building.py:2691)
        rew = rew + r;
        cost = cost + net * a.price[o];
        emis = emis + max_nan(net * a.carbon[o], 0.f);
        temp_last = temp_t;
    }
    a.reward[i] = rew;
    a.cost[i] = cost;
    a.emission[i] = emis;
    a.csoc[i] = csoc;
    a.dsoc[i] = dsoc;
    a.soc[i] = soc;
    a.eff[i] = eff;
    a.deg[i] = deg;
    a.last_temp[i] = temp_last;
}

__global__ void __launch_bounds__(THREADS) lstm_episode_kernel(const Args a) {
    extern __shared__ float ring_all[];
    // building-major: a warp's threads share their building, so they read
    // every weight and every series value from one address
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.D * a.B) return;
    const int b = i / a.D;
    const int d = i - b * a.D;
    float* ring = ring_all + threadIdx.x;
    const int* meta = a.meta + b * N_META;
    if (meta[M_HIDDEN] == 8 && meta[M_CHANNELS] == 12) {
        run_episode<8, 12>(a, d, b, ring);
    } else {
        run_episode<0, 0>(a, d, b, ring);
    }
}

}  // namespace

extern "C" int lstm_episode_launch(
        const float* a_cdev, const float* a_cstor, const float* a_dstor, const float* a_bat,
        const float* nsl, const float* solar, const float* price, const float* carbon,
        const float* cool, const float* dhw, const float* outdoor, const float* mode,
        const float* temp, const float* csp, const float* hsp, const float* band,
        const float* schan, const float* outage,
        const float* bparams, const float* pec_x, const float* pec_y, const float* cpc_x,
        const float* cpc_y, const float* tparams, const float* lparams, const float* weights,
        const float* csoc0, const float* dsoc0, const float* soc0, const float* eff0,
        const float* deg0, const int* meta,
        float* reward, float* cost, float* emission, float* csoc, float* dsoc, float* soc,
        float* eff, float* deg, float* last_temp, float* rec,
        int D, int B, int S, int X, int n_knots, int lookback,
        float hours_ratio, float ratio, float lo_exp, float hi_exp, void* stream) {
    const Args a = {a_cdev, a_cstor, a_dstor, a_bat,
                    nsl, solar, price, carbon, cool, dhw, outdoor, mode, temp, csp, hsp, band,
                    schan, outage,
                    bparams, pec_x, pec_y, cpc_x, cpc_y, tparams, lparams, weights,
                    csoc0, dsoc0, soc0, eff0, deg0, meta,
                    reward, cost, emission, csoc, dsoc, soc, eff, deg, last_temp, rec,
                    D, B, S, X, n_knots, lookback, hours_ratio, ratio, lo_exp, hi_exp};
    const int blocks = (D * B + THREADS - 1) / THREADS;
    const size_t ring_bytes = sizeof(float) * 2 * (lookback + 1) * THREADS;
    lstm_episode_kernel<<<blocks, THREADS, ring_bytes, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
