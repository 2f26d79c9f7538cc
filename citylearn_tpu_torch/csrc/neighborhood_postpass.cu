// The temperature and occupant post-pass of the neighborhood family
// (kernel P6): for ONE district, the LSTM indoor-temperature prediction of
// every building over the episode (reference building.py:2935-3078), on
// the demand observations that the neighborhood kernel K6 recorded, and the
// occupant thermostat interaction on the predicted temperature
// (building.py:3160-3353, occupant.py:62-99).
//
// Replaces the single-district XLA scan of
// citylearn_tpu/core/neighborhood_eval.py::temp_setpoint_series, which
// steps citylearn_tpu/core/step.py's dynamics_update and occupant_update
// (there is no Pallas kernel behind it). Under open-loop plans the
// temperature depends only on the demand observations, never on a
// district's storage state, so it is the same for every district and runs
// once after K6, not D times.
//
// One thread runs one building over all S steps, alone in its block, so
// that the buildings' different LSTM shapes never diverge within a warp
// and each building has an SM's L1 to itself; buildings never couple, so
// nothing synchronises. The thread keeps the ring of its two or three
// dynamic channels (normalized cooling and heating observation,
// temperature) in shared memory, reads its static channels from the shared
// stream, runs the stacked LSTM over the lookback window from the carried
// (h, c) with csrc/lstm_common.cuh's cell (hidden sizes 8, 16, 24 and 32
// with the sums in registers, any other up to 64 in local memory) and the
// head, then the occupant update: the logistic interaction probabilities,
// the walk of the increase or decrease decision tree over its node arrays,
// the hold counter and the NaN-coded set-point overrides.
//
// What bounds it on an H100: operations, all in one dependent sequence per
// building — lookback x (2 * 4H * (F + H) + 2 * 4H * 2H) gate operations
// per step, about 3.3e5 at H = 32, F = 12, two layers, lookback 12 — issued
// by one thread. A block per building with the 4H gate rows spread over its
// threads is the faster design this simple one leaves for later work.
//
// The quirks of the reference are kept as core/step.py keeps them: the
// temperature channel reads one position older than the others; the newest
// temperature entry is the prediction once the window is full
// (t >= lookback) and (h, c) carry only from then on; at t == 0 the occupant
// reads the episode's final row (numpy's index -1); the interaction is
// gated by t >= lookback; reversion applies from t + 1. The LSTM's sums and
// activations agree with the plain version to a tolerance; the occupant
// arithmetic (the logistic with expf, comparisons, tree thresholds) is IEEE
// float32 without fused multiply-adds, as the plain version computes it.

#include <math.h>

#include "lstm_common.cuh"

namespace {

using lstm::head;
using lstm::lstm_cell;
using lstm::MAX_F;
using lstm::MAX_H;
using namespace lstm::meta;

// rows of prows and of the occupant's end rows, as ops/postpass.py names them
enum PRow { P_NMIN_TC, P_NSPAN_TC, P_NMIN_CC, P_NSPAN_CC, P_NMIN_HC, P_NSPAN_HC, P_LIN_B };
enum ERow { E_TEMP, E_CSP, E_HSP };

struct Args {
    const float *weights, *prows, *schan;
    const int* meta;
    const float *cobs, *hobs, *temp, *csp, *hsp, *mode;
    // the occupant's inputs, null on a district without occupants
    const float *a_inc, *b_inc, *a_dec, *b_dec, *rand, *end;
    const int *left, *right, *feature;
    const float *threshold, *delta;
    const int *hold, *gate;
    float *temp_out, *csp_out, *hsp_out;
    float *ov_c, *ov_h;
    int* counter;
    float *prev_temp, *prev_csp, *prev_hsp;
    int B, S, X, lookback, n_nodes, depth;
};

// The set-point delta of tree k (0: increase, 1: decrease) of building b on
// the features (current set point, previous set point, previous
// temperature - previous set point): depth + 1 steps from the root, a leaf
// (feature -2) staying where it is.
__device__ float tree_delta(const Args& a, int b, int k, float f0, float f1, float f2) {
    const int base = (b * 2 + k) * a.n_nodes;
    int node = 0;
    for (int level = 0; level <= a.depth; ++level) {
        const int f = a.feature[base + node];
        const int fc = f < 0 ? 0 : (f > 2 ? 2 : f);
        const float x = fc == 0 ? f0 : (fc == 1 ? f1 : f2);
        const int next = x <= a.threshold[base + node] ? a.left[base + node]
                                                        : a.right[base + node];
        node = f >= 0 ? next : node;
    }
    return a.delta[base + node];
}

__device__ __forceinline__ float logistic(float a_, float b_, float temp) {
    return 1.f / (1.f + expf(-(a_ + b_ * temp)));
}

// The episode of building b. HC is its hidden size where a path is compiled
// for it (a multiple of 4), 0 where it is read from meta.
template <int HC>
__device__ void run_building(const Args& a, int b, float* ring) {
    const int B = a.B, S = a.S, lookback = a.lookback;
    const int* m = a.meta + b * N_META;
    const int L = m[M_LAYERS];
    const int H = HC > 0 ? HC : m[M_HIDDEN];
    const int F = m[M_CHANNELS];
    const int tc = m[M_TEMP_CH], cc = m[M_COOL_CH], hc = m[M_HEAT_CH];
    const int HP = (H + 3) / 4 * 4, FP = (F + 3) / 4 * 4;
    constexpr int HA = HC > 0 ? HC : MAX_H;

    // this building's weights in the flat buffer (ops/lstm.py LstmWeights)
    const float* rows1 = a.weights + m[M_W_OFF];
    const float* bias1 = rows1 + 4 * H * (FP + HP);
    const float* rows2 = bias1 + 4 * H;
    const float* bias2 = rows2 + 4 * H * (HP + HP);
    const float* lin_w = L == 2 ? bias2 + 4 * H : rows2;
    const float* schan = a.schan + m[M_X_OFF];
    const float nmin_tc = a.prows[P_NMIN_TC * B + b], nspan_tc = a.prows[P_NSPAN_TC * B + b];
    const float nmin_cc = a.prows[P_NMIN_CC * B + b], nspan_cc = a.prows[P_NSPAN_CC * B + b];
    const float nmin_hc = a.prows[P_NMIN_HC * B + b], nspan_hc = a.prows[P_NSPAN_HC * B + b];
    const float lin_b = a.prows[P_LIN_B * B + b];

    // the ring: slot s of the cooling, heating and temperature channel
    const int RING = lookback + 1;
    float* ring_c = ring;
    float* ring_h = ring + RING;
    float* ring_t = ring + 2 * RING;

    float h1[HA], c1[HA], h2[HA], c2[HA], hn[HA], x[MAX_F];
    for (int j = 0; j < HA; ++j) h1[j] = c1[j] = h2[j] = c2[j] = hn[j] = 0.f;
    for (int f = 0; f < MAX_F; ++f) x[f] = 0.f;

    const bool occupant = a.a_inc != nullptr;
    const float nan = __int_as_float(0x7fc00000);
    float ov_c = nan, ov_h = nan, prev_temp = 0.f, prev_csp = 0.f, prev_hsp = 0.f;
    int counter = -1;
    const int hold = occupant ? a.hold[b] : 0, gate = occupant ? a.gate[b] : 0;
    int tail = 0;                                // t % RING

    for (int t = 0; t < S; ++t) {
        const int o = t * B + b;
        const float temp_ideal = a.temp[o];
        // the dynamic channels of row t (building.py:2960-2990)
        if (cc >= 0) ring_c[tail] = (a.cobs[o] - nmin_cc) / nspan_cc;
        if (hc >= 0) ring_h[tail] = (a.hobs[o] - nmin_hc) / nspan_hc;
        float temp_n = (temp_ideal - nmin_tc) / nspan_tc;
        float temp_t = temp_ideal;
        if (t >= lookback) {
            // window position s reads the static channels and the demand
            // observations of row t - lookback + 1 + s and the temperature
            // of the row before (building.py:3039-3055)
            int slot_t = tail + 1 == RING ? 0 : tail + 1;          // row t - lookback
            for (int s = 0; s < lookback; ++s) {
                const int slot_m = slot_t + 1 == RING ? 0 : slot_t + 1;
                const float* srow = schan + (size_t)(t - lookback + 1 + s) * a.X;
                for (int f = 0; f < F; ++f) {
                    x[f] = f == cc ? ring_c[slot_m]
                         : f == hc ? ring_h[slot_m]
                         : f == tc ? ring_t[slot_t] : srow[f];
                }
                lstm_cell<HC, 0, false>(rows1, bias1, H, FP, HP, x, h1, c1, hn);
                for (int j = 0; j < H; ++j) h1[j] = hn[j];
                if (L == 2) {
                    lstm_cell<HC, 0, false>(rows2, bias2, H, HP, HP, h1, h2, c2, hn);
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
        ring_t[tail] = temp_n;
        tail = tail + 1 == RING ? 0 : tail + 1;
        a.temp_out[o] = temp_t;

        float csp_eff = a.csp[o], hsp_eff = a.hsp[o];
        if (occupant) {
            // the live overrides, else the data
            csp_eff = isfinite(ov_c) ? ov_c : csp_eff;
            hsp_eff = isfinite(ov_h) ? ov_h : hsp_eff;
            if (t == 0) {
                prev_temp = a.end[E_TEMP * B + b];
                prev_csp = a.end[E_CSP * B + b];
                prev_hsp = a.end[E_HSP * B + b];
            }
            const bool heating_mode = a.mode[o] == 2.f;
            const float current_sp = heating_mode ? hsp_eff : csp_eff;
            const float prev_sp = heating_mode ? prev_hsp : prev_csp;
            const float p_inc = logistic(a.a_inc[o], a.b_inc[o], temp_t);
            const float p_dec = logistic(a.a_dec[o], a.b_dec[o], temp_t);
            const float rp = a.rand[t];
            const float f2 = prev_temp - prev_sp;
            float delta = 0.f;
            if (p_inc >= rp && p_dec < rp) {
                delta = tree_delta(a, b, 0, current_sp, prev_sp, f2);
            } else if (p_dec >= rp && p_inc < rp) {
                delta = -tree_delta(a, b, 1, current_sp, prev_sp, f2);
            }
            // the simulate_dynamics gate (building.py:2996)
            if (!(t >= gate)) delta = 0.f;
            const bool trig = fabsf(delta) > 0.f;
            counter = trig ? hold : (counter >= 0 ? counter - 1 : counter);
            if (trig && !heating_mode) ov_c = csp_eff = current_sp + delta;
            if (trig && heating_mode) ov_h = hsp_eff = current_sp + delta;
            // this step keeps the fresh mutation; reversion applies from
            // t + 1 (building.py:3310-3317)
            if (counter == 0) {
                ov_c = ov_h = nan;
                counter = -1;
            }
            prev_temp = temp_t;
            prev_csp = csp_eff;
            prev_hsp = hsp_eff;
        }
        a.csp_out[o] = csp_eff;
        a.hsp_out[o] = hsp_eff;
    }
    if (occupant) {
        a.ov_c[b] = ov_c;
        a.ov_h[b] = ov_h;
        a.counter[b] = counter;
        a.prev_temp[b] = prev_temp;
        a.prev_csp[b] = prev_csp;
        a.prev_hsp[b] = prev_hsp;
    }
}

__global__ void __launch_bounds__(1) neighborhood_postpass_kernel(const Args a) {
    extern __shared__ float ring[];
    const int b = blockIdx.x;
    switch (a.meta[b * N_META + M_HIDDEN]) {
        case 8: run_building<8>(a, b, ring); break;
        case 16: run_building<16>(a, b, ring); break;
        case 24: run_building<24>(a, b, ring); break;
        case 32: run_building<32>(a, b, ring); break;
        default: run_building<0>(a, b, ring);
    }
}

}  // namespace

extern "C" int neighborhood_postpass_launch(
        const float* weights, const int* meta, const float* prows, const float* schan,
        const float* cobs, const float* hobs, const float* temp, const float* csp,
        const float* hsp, const float* mode,
        const float* a_inc, const float* b_inc, const float* a_dec, const float* b_dec,
        const float* rand, const float* end, const int* left, const int* right,
        const int* feature, const float* threshold, const float* delta, const int* hold,
        const int* gate,
        float* temp_out, float* csp_out, float* hsp_out, float* ov_c, float* ov_h,
        int* counter, float* prev_temp, float* prev_csp, float* prev_hsp,
        int B, int S, int X, int lookback, int n_nodes, int depth, void* stream) {
    const Args a = {weights, prows, schan, meta, cobs, hobs, temp, csp, hsp, mode,
                    a_inc, b_inc, a_dec, b_dec, rand, end, left, right, feature,
                    threshold, delta, hold, gate,
                    temp_out, csp_out, hsp_out, ov_c, ov_h, counter, prev_temp, prev_csp,
                    prev_hsp, B, S, X, lookback, n_nodes, depth};
    const size_t ring_bytes = sizeof(float) * 3 * (lookback + 1);
    neighborhood_postpass_kernel<<<B, 1, ring_bytes, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
