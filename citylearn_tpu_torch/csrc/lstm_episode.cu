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
// Here a block holds NDB = 256 / G districts of ONE building (grid x:
// district blocks, y: buildings) and splits their work between two kinds of
// warp. The LSTM of each district runs on a group of G = 8 lanes (4 lanes,
// half the warps, ran slower): lane l owns hidden units l, l + G, ...: all four
// gate rows of each, so the gate combine stays in the lane; the lanes write
// the new hidden vector into a second buffer in shared memory, which one
// __syncwarp() hands to the whole group for the next products. At 8 hidden
// units the building's recurrent and layer-2 weights sit in shared memory,
// unit by unit, and a lane reads its four rows of an input as one 16-byte
// load; any other hidden size up to MAX_H reads them through L1. Layer 1's
// bias and products with the static channels of a row (every channel but
// the cooling demand and the temperature) are the same for every district
// and for the lookback positions that read that row: the block computes
// the newest row's once a step, a thread per gate row, into a ring in
// shared memory. The physics of each district runs on one thread of the
// warps after the LSTM groups, as in a thread-per-pair kernel, so that the
// G lanes of a group do not repeat it and the LSTM code holds no physics
// state. The physics does not depend on the temperature, only the reward
// does, so the two kinds of warp meet through shared memory with one lag
// each: in the block's iteration i the physics runs step i, the LSTM step
// i - 1 (on the cooling observations up to row i - 1) and the physics the
// reward of step i - 2 (on that step's temperature), one barrier between
// iterations. At D = 4096, B = 3, G = 8 that is 3,072 LSTM warps and 384
// physics warps, ~6.5 warps per scheduler, against fewer than one with one
// thread per pair.
//
// Only the two dynamic channels (normalized cooling demand and temperature)
// differ from district to district: their ring is 2 x (lookback + 1)
// floats per district in shared memory, addressed modulo its length. The
// quirks of the reference are kept: the temperature channel reads one
// position older than the others, the newest temperature is overwritten by
// the prediction once the window is full (t >= lookback), (h, c) carry
// over only from then on (before, the window would start from zeros and
// its result be dropped, so it is not run), and partial load starts at
// t >= lookback + 1.
//
// What bounds it on an H100: operations. A district-building-step does
// about lookback x (2*4H*(2+H) + 2*4H*2H) = 19,968 gate operations at
// H = 8, two layers, against a few hundred for the physics, a few bytes and
// the static products, which are shared by all districts
// (ops/lstm.py::operation_count). The physics (csrc/thermal_common.cuh's
// blocks with the flexibility cap, csrc/battery_common.cuh's event) is
// built with -fmad=false and IEEE division and square root, so that it
// rounds as the plain PyTorch version
// (ops/lstm.py::lstm_episode_reference) rounds it and the eight physics
// outputs and eleven physics rows are bit-equal. The gate products use
// explicit fused multiply-adds and the activations the hardware's exp2 and
// reciprocal: the temperature, the reward and their sums agree with the
// plain version to a tolerance, not to the bit.

#include "lstm_common.cuh"
#include "thermal_common.cuh"

namespace {

using battery::BatteryView;
using battery::max_nan;
using battery::min_nan;
using thermal::BlockResult;
using thermal::EndUse;
using thermal::flexibility;

using lstm::cell_update;
using lstm::MAX_H;
using lstm::sigmoidf;
using lstm::tanh_fast;
using namespace lstm::meta;

constexpr int LSTM_THREADS = 256;            // a block's LSTM lanes; then its physics warps
constexpr int G = 8;                          // the lanes of a district's LSTM group
constexpr int NDB = LSTM_THREADS / G;         // a block's districts
constexpr int TH = 8;                         // the hidden size with weights in shared memory
constexpr int TW = 3 * TH * 4 * TH;           // their floats: [W_hh1 | W_ih2 | W_hh2]

__device__ __forceinline__ float4 fma4(float4 w, float x, float4 acc) {
    return make_float4(__fmaf_rn(w.x, x, acc.x), __fmaf_rn(w.y, x, acc.y),
                       __fmaf_rn(w.z, x, acc.z), __fmaf_rn(w.w, x, acc.w));
}

// rows of lparams and of the record, as ops/lstm.py names them
enum LRow { L_NMIN_CC, L_NSPAN_CC, L_NMIN_TC, L_NSPAN_TC, L_LIN_B, L_COOL_ACTIVE };
enum Rec { R_NET, R_CBAL, R_DBAL, R_BBAL, R_CSOC, R_DSOC, R_BSOC, R_COUT, R_DOUT,
           R_TEMP, R_REWARD, R_CDEM, R_NSLMET };

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
    int D, B, S, X, n_knots, lookback, max_h;
    float hours_ratio, ratio, lo_exp, hi_exp;
};

// The block of NDB = 256 / G districts of building b from district d0 on.
// Its first 256 threads are the LSTM groups, G lanes per district; the
// NDB threads after them, whole warps, run the districts' physics, one
// each. HC is the building's hidden size where its weights sit in shared
// memory (TH), 0 where they are read from meta and the weights through L1.
// Shared memory: the weights (TW floats), the static products
// [RING][4 max_h], the dynamic channels' rings [2][RING][NDB], per district
// the two layers' hidden vectors, double-buffered, and cell states
// [NDB][6][HS], and the temperatures handed to the physics [2][NDB].
//
// Iteration it of the block runs the physics of step it, the LSTM of step
// it - 1 (its window reads the cooling observations up to row it - 1) and
// the reward of step it - 2 (it reads that step's temperature), with one
// barrier after each of the S + 2 iterations.
template <int HC>
__device__ __forceinline__ void run_block(const Args& a, int b, int d0, float* smem) {
    constexpr int UPL = (HC > 0 ? HC : MAX_H) / G;      // units per lane, at most
    const int B = a.B, S = a.S, lookback = a.lookback;
    const int* meta = a.meta + b * N_META;
    const int L = meta[M_LAYERS];
    const int H = HC > 0 ? HC : meta[M_HIDDEN];
    const int F = meta[M_CHANNELS];
    const int tc = meta[M_TEMP_CH], cc = meta[M_COOL_CH];
    const int HP = (H + 3) / 4 * 4, FP = (F + 3) / 4 * 4;
    const int G4 = 4 * H;

    // this building's weights in the flat buffer (ops/lstm.py LstmWeights):
    // column k of a layer at rows + k * 4H, row q H + j
    const float* rows1 = a.weights + meta[M_W_OFF];
    const float* bias1 = rows1 + G4 * (FP + HP);
    const float* rows2 = bias1 + G4;
    const float* bias2 = rows2 + G4 * (HP + HP);
    const float* lin_w = L == 2 ? bias2 + G4 : rows2;
    const float* schan = a.schan + meta[M_X_OFF];

    const int RING = lookback + 1;
    const int HS = (a.max_h + 3) / 4 * 4 + 4;          // a vector's stride
    float* wts = smem;
    float* sp = smem + TW;
    float* ring_c = sp + RING * 4 * a.max_h;
    float* ring_t = ring_c + RING * NDB;
    float* hb = ring_t + RING * NDB;
    float* tbuf = hb + NDB * 6 * HS;

    // the block's set-up: the weights of a TH-unit building into shared
    // memory unit by unit (entry (k, 4j + q) of a matrix: input k, row
    // q H + j), the rings and hidden vectors to zero
    if constexpr (HC > 0) {
        for (int e = threadIdx.x; e < TW; e += blockDim.x) {
            const int m3 = e / (HC * G4), k = e % (HC * G4) / G4, jq = e % G4;
            const int row = (jq & 3) * HC + (jq >> 2);
            const float* col = m3 == 0 ? rows1 + (FP + k) * G4
                             : m3 == 1 ? rows2 + k * G4 : rows2 + (HP + k) * G4;
            wts[e] = m3 > 0 && L != 2 ? 0.f : __ldg(col + row);
        }
    }
    for (int e = threadIdx.x; e < RING * 2 * NDB + NDB * 6 * HS; e += blockDim.x) ring_c[e] = 0.f;
    __syncthreads();

    const float nmin_cc = a.lparams[L_NMIN_CC * B + b], nspan_cc = a.lparams[L_NSPAN_CC * B + b];
    const float nmin_tc = a.lparams[L_NMIN_TC * B + b], nspan_tc = a.lparams[L_NSPAN_TC * B + b];

    if (threadIdx.x >= LSTM_THREADS) {
        // ---- a physics thread: district p of the block ----
        const int p = threadIdx.x - LSTM_THREADS;
        const bool writer = d0 + p < a.D;
        const int d = writer ? d0 + p : a.D - 1;
        const int i = d * B + b;
        const BatteryView bat(a.bparams, a.pec_x, a.pec_y, a.cpc_x, a.cpc_y, b, B, a.n_knots);
        const EndUse cooling(a.tparams, thermal::CN, thermal::CT_CAP, thermal::CT_CONV, false, b,
                             B);
        const EndUse dhw(a.tparams, thermal::DN, thermal::DT_CAP, thermal::DT_CONV, true, b, B);
        const bool cool_active = a.lparams[L_COOL_ACTIVE * B + b] > 0.5f;
        float csoc = a.csoc0[i], dsoc = a.dsoc0[i];
        float soc = a.soc0[i], eff = a.eff0[i], deg = a.deg0[i];
        float rew = 0.f, cost = 0.f, emis = 0.f, temp_last = 0.f;
        const bool recording = a.rec != nullptr && d == 0 && writer;
        const int SB = S * B;
        float obs1 = 0.f, obs2 = 0.f;            // the cooling observations of steps it - 1, it - 2
        int slot = 0;                            // row it's ring slot
        for (int it = 0; it <= S + 1; ++it) {
            if (it >= 2) {
                // the reward of step it - 2, on the LSTM's temperature
                const int o = (it - 2) * B + b;
                const float temp_t = tbuf[(it & 1) * NDB + p];
                const float r = comfort(temp_t, a.mode[o], a.csp[o], a.hsp[o], a.band[o],
                                        0.f > obs2, a.lo_exp, a.hi_exp);
                if (recording) {
                    a.rec[R_TEMP * SB + o] = temp_t;
                    a.rec[R_REWARD * SB + o] = r;
                }
                rew = rew + r;
                temp_last = temp_t;
            }
            float obs0 = 0.f;
            if (it < S) {
                const int t = it;
                const int o = t * B + b;
                const float t0f = t == 0 ? 1.f : 0.f;
                const float nsl = a.nsl[o], solar = a.solar[o];
                const float cool_ideal = a.cool[o], dhw_d = a.dhw[o];
                const float mode = a.mode[o];
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
                const BlockResult c = cooling.step(cooling_demand, a.a_cstor[o], cop_c, dev_init_c,
                                                   1.f, a.ratio, csoc, outage, solar, accum);
                accum = accum + c.cons;
                const BlockResult w = dhw.step(dhw_d, a.a_dstor[o], cop_d, dev_init_d,
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

                const float cool_obs = c.out + max_nan(-c.balance, 0.f);
                ring_c[slot * NDB + p] = (cool_obs - nmin_cc) / nspan_cc;
                obs0 = cool_obs;
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
                    a.rec[R_CDEM * SB + o] = cooling_demand;
                    a.rec[R_NSLMET * SB + o] = nsl_met;
                }
                // cost is unclamped (building.py:2686), emission clamps at 0
                // (building.py:2691)
                cost = cost + net * a.price[o];
                emis = emis + max_nan(net * a.carbon[o], 0.f);
            }
            obs2 = obs1;
            obs1 = obs0;
            slot = slot + 1 == RING ? 0 : slot + 1;
            __syncthreads();
        }
        if (writer) {
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
        return;
    }

    // ---- an LSTM lane: lane lg of district dl's group ----
    const int dl = threadIdx.x / G, lg = threadIdx.x % G;
    float* dh = hb + dl * 6 * HS;                      // h1[2], h2[2], c1, c2
    float* cs1 = dh + 4 * HS;
    float* cs2 = dh + 5 * HS;
    // the four gate rows (i, f, g, o) of unit j in column k of a matrix:
    // through L1 (g, its first column in the flat buffer) or, where HC > 0,
    // from shared memory (s, the matrix's start there)
    auto gcol4 = [&](const float* g, int k, int j) -> float4 {
        const float* p = g + k * G4 + j;
        return make_float4(__ldg(p), __ldg(p + H), __ldg(p + 2 * H), __ldg(p + 3 * H));
    };
    auto col4 = [&](const float* s, const float* g, int k, int j) -> float4 {
        if constexpr (HC > 0) {
            return *reinterpret_cast<const float4*>(s + k * G4 + 4 * j);
        } else {
            return gcol4(g, k, j);
        }
    };
    // acc + the products of a matrix's columns with the hidden vector v
    auto hprod = [&](const float* s, const float* g, const float* v, int j, float4 acc) {
        if constexpr (HC > 0) {
#pragma unroll
            for (int k = 0; k < HC; k += 4) {
                const float4 h4 = *reinterpret_cast<const float4*>(v + k);
                acc = fma4(col4(s, g, k, j), h4.x, acc);
                acc = fma4(col4(s, g, k + 1, j), h4.y, acc);
                acc = fma4(col4(s, g, k + 2, j), h4.z, acc);
                acc = fma4(col4(s, g, k + 3, j), h4.w, acc);
            }
        } else {
            for (int k = 0; k < H; ++k) acc = fma4(col4(s, g, k, j), v[k], acc);
        }
        return acc;
    };
    auto unit = [&](int u) { return lg + u * G; };
    auto owned = [&](int u) { return HC > 0 || unit(u) < H; };
    const float lin_b = a.lparams[L_LIN_B * B + b];

    // where HC > 0, the cell states of the lane's units, its weights of the
    // two dynamic channels and its layer-2 biases in registers (else the
    // cell states in shared memory, the weights through L1)
    constexpr int UR = HC > 0 ? UPL : 1;
    float c1[UR], c2[UR];
    float4 wc4[UR], wt4[UR], b24[UR];
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < UR; ++u) {
        c1[u] = c2[u] = 0.f;
        wc4[u] = HC > 0 ? gcol4(rows1, cc, unit(u)) : zero4;
        wt4[u] = HC > 0 ? gcol4(rows1, tc, unit(u)) : zero4;
        b24[u] = HC > 0 && L == 2 ? gcol4(bias2, 0, unit(u)) : zero4;
    }
    int tail = 0;                                // row t's ring slot
    int sp_slot = 0;                             // row it's ring slot
    int par = 0;                                 // h1[par], h2[par]: the current vectors
    for (int it = 0; it <= S + 1; ++it) {
        if (it >= 1 && it <= S) {
            // ---- the LSTM temperature prediction of step t = it - 1
            // (building.py:2935-3078) ----
            const int t = it - 1;
            const float temp_ideal = a.temp[t * B + b];
            float temp_n = (temp_ideal - nmin_tc) / nspan_tc;
            float temp_t = temp_ideal;
            if (t >= lookback) {
                // window position s reads the static channels and the cooling
                // demand of row t - lookback + 1 + s and the temperature of
                // the row before (building.py:3039-3055)
                int slot_t = tail + 1 == RING ? 0 : tail + 1;      // row t - lookback
                for (int s = 0; s < lookback; ++s) {
                    const int slot_m = slot_t + 1 == RING ? 0 : slot_t + 1;
                    const float xc = ring_c[slot_m * NDB + dl], xt = ring_t[slot_t * NDB + dl];
                    const float* h1c = dh + par * HS;
                    float* h1n = dh + (par ^ 1) * HS;
                    const float* h2c = dh + (2 + par) * HS;
                    float* h2n = dh + (2 + (par ^ 1)) * HS;
                    // each layer reads the current vectors and writes the next
                    // ones, which one __syncwarp() hands to the group
    #pragma unroll
                    for (int u = 0; u < UPL; ++u) {
                        if (!owned(u)) continue;
                        const int j = unit(u);
                        float4 acc = *reinterpret_cast<const float4*>(sp + slot_m * G4 + 4 * j);
                        acc = fma4(HC > 0 ? wc4[u % UR] : gcol4(rows1, cc, j), xc, acc);
                        acc = fma4(HC > 0 ? wt4[u % UR] : gcol4(rows1, tc, j), xt, acc);
                        acc = hprod(wts, rows1 + FP * G4, h1c, j, acc);
                        float c = HC > 0 ? c1[u % UR] : cs1[j];
                        h1n[j] = cell_update(sigmoidf(acc.x), sigmoidf(acc.y), tanh_fast(acc.z),
                                             sigmoidf(acc.w), c);
                        if constexpr (HC > 0) c1[u % UR] = c; else cs1[j] = c;
                    }
                    __syncwarp();
                    if (L == 2) {
    #pragma unroll
                        for (int u = 0; u < UPL; ++u) {
                            if (!owned(u)) continue;
                            const int j = unit(u);
                            float4 acc = HC > 0 ? b24[u % UR] : gcol4(bias2, 0, j);
                            acc = hprod(wts + HC * G4, rows2, h1n, j, acc);
                            acc = hprod(wts + 2 * HC * G4, rows2 + HP * G4, h2c, j, acc);
                            float c = HC > 0 ? c2[u % UR] : cs2[j];
                            h2n[j] = cell_update(sigmoidf(acc.x), sigmoidf(acc.y), tanh_fast(acc.z),
                                                 sigmoidf(acc.w), c);
                            if constexpr (HC > 0) c2[u % UR] = c; else cs2[j] = c;
                        }
                        __syncwarp();
                    }
                    par ^= 1;
                    slot_t = slot_m;
                }
                // the head reads the top layer's last hidden output, every
                // lane of the group alike
                const float* top = dh + ((L == 2 ? 2 : 0) + par) * HS;
                temp_n = lin_b;
                for (int k = 0; k < H; ++k) temp_n = __fmaf_rn(__ldg(lin_w + k), top[k], temp_n);
                temp_t = temp_n * nspan_tc + nmin_tc;
            }
            // the newest temperature entry: the data until the window is
            // full, the prediction from then on (building.py:3060-3065)
            ring_t[tail * NDB + dl] = temp_n;
            if (lg == 0) tbuf[(t & 1) * NDB + dl] = temp_t;
            tail = tail + 1 == RING ? 0 : tail + 1;
        }
        if (it < S && threadIdx.x < G4) {
            // layer 1's bias and static products of row it, a thread per
            // gate row (building.py:3039-3055 reads row it at the window's
            // last position)
            const int row = (threadIdx.x & 3) * H + (threadIdx.x >> 2);
            const float* srow = schan + (size_t)it * a.X;
            float s = __ldg(bias1 + row);
            for (int f = 0; f < F; ++f) {
                if (f != cc && f != tc) s = __fmaf_rn(__ldg(rows1 + f * G4 + row), __ldg(srow + f), s);
            }
            sp[sp_slot * G4 + threadIdx.x] = s;
        }
        sp_slot = sp_slot + 1 == RING ? 0 : sp_slot + 1;
        __syncthreads();
    }
}

__global__ void __launch_bounds__(LSTM_THREADS + NDB, 3) lstm_episode_kernel(const Args a) {
    extern __shared__ __align__(16) float smem[];
    // a block: NDB districts of building blockIdx.y; a district past the
    // last one runs the last one's episode and writes nothing
    const int b = blockIdx.y;
    const int d0 = blockIdx.x * NDB;
    if (a.meta[b * N_META + M_HIDDEN] == TH) {
        run_block<TH>(a, b, d0, smem);
    } else {
        run_block<0>(a, b, d0, smem);
    }
}

int launch(const Args& a, cudaStream_t stream) {
    const int ring = a.lookback + 1;
    const int hs = (a.max_h + 3) / 4 * 4 + 4;
    const size_t smem_bytes = sizeof(float) * (TW + (size_t)ring * 4 * a.max_h
                                               + (size_t)ring * 2 * NDB + (size_t)NDB * 6 * hs
                                               + 2 * NDB);
    cudaError_t err = cudaFuncSetAttribute(lstm_episode_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.D + NDB - 1) / NDB, a.B);
    lstm_episode_kernel<<<grid, LSTM_THREADS + NDB, smem_bytes, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// max_h: the largest hidden size of the buildings
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
        int D, int B, int S, int X, int n_knots, int lookback, int max_h,
        float hours_ratio, float ratio, float lo_exp, float hi_exp, void* stream) {
    const Args a = {a_cdev, a_cstor, a_dstor, a_bat,
                    nsl, solar, price, carbon, cool, dhw, outdoor, mode, temp, csp, hsp, band,
                    schan, outage,
                    bparams, pec_x, pec_y, cpc_x, cpc_y, tparams, lparams, weights,
                    csoc0, dsoc0, soc0, eff0, deg0, meta,
                    reward, cost, emission, csoc, dsoc, soc, eff, deg, last_temp, rec,
                    D, B, S, X, n_knots, lookback, max_h, hours_ratio, ratio, lo_exp, hi_exp};
    return launch(a, static_cast<cudaStream_t>(stream));
}
