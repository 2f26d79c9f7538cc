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
// A block runs one building over all S steps; buildings never couple, so
// blocks never meet. Thread 4j + q of the block owns gate row q H + j (q =
// i, f, g, o in torch's order) of each layer, so the four gates of hidden
// unit j sit in four adjacent lanes and meet by warp shuffles; the units'
// new hidden values go to shared memory, double-buffered, and one barrier a
// cell hands them to every row. Layer 1 of window position s + 1 and layer
// 2 of position s need the same hidden vector of layer 1 and nothing of
// each other, so they run between the same two barriers: lookback + 1
// barrier intervals a step for two layers, lookback for one. A thread keeps
// its rows' recurrent and layer-2 weights in registers for the whole year
// (hidden sizes 8, 16, 24 and 32: paths compiled for them; any other up to
// MAX_H units over MAX_F channels reads them through L1). Layer 1's
// products with the static channels of a row of the stream (all channels
// but the cooling, heating and temperature observations) and its bias are
// the same at the lookback positions that read that row: each thread
// computes its row's once per row of the stream, into a ring in shared
// memory. Every CHUNK steps the block stages the next rows at once, so
// that their loads overlap: the static channels, the normalized cooling
// and heating observations (into the dynamic channels' rings), the data's
// temperature and set points, and from them the static products; a step
// then reads global memory only for the occupant. After the window,
// warp 0 reduces the head over the top layer's hidden vector with shuffles
// and thread 0 runs the occupant update: the logistic interaction
// probabilities, the walk of the increase or decrease decision tree over
// its node arrays, the hold counter and the NaN-coded set-point overrides.
//
// What bounds it on an H100: the chain. The operations are lookback x
// (2 * 4H * (n_dyn + H) + 2 * 4H * 2H) gate operations per building-step
// plus the static products once per row, about 3e5 at H = 32, two layers,
// lookback 12: for 100 buildings and a year a bound of ~1.35 ms at the
// card's fp32 rate (ops/postpass.py::operation_count). But every step runs
// 2 x lookback cells of one building in sequence, ~210,000 cells a year,
// each a multiply-add tree, two activations, the shuffles and a barrier:
// ~100-150 cycles, a floor of ~10-16 ms that no design over idle SMs
// shortens.
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

using lstm::cell_update;
using lstm::dot;
using lstm::gate_act;
using lstm::MAX_F;
using lstm::MAX_H;
using namespace lstm::meta;

constexpr int MAX_THREADS = 4 * MAX_H;    // a gate row a thread
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 32;                 // steps whose inputs a block stages at once

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

// One step of the occupant of building b at step t (thread 0): the live
// overrides, the interaction on the temperature temp_t, the hold counter
// and the reversion; writes the step's effective set points.
struct Occupant {
    float ov_c, ov_h, prev_temp, prev_csp, prev_hsp;
    int counter;
};

__device__ void occupant_step(const Args& a, int b, int t, float temp_t, Occupant& s,
                              float& csp_eff, float& hsp_eff) {
    const int B = a.B, o = t * B + b;
    const float nan = __int_as_float(0x7fc00000);
    // the live overrides, else the data
    csp_eff = isfinite(s.ov_c) ? s.ov_c : csp_eff;
    hsp_eff = isfinite(s.ov_h) ? s.ov_h : hsp_eff;
    if (t == 0) {
        s.prev_temp = a.end[E_TEMP * B + b];
        s.prev_csp = a.end[E_CSP * B + b];
        s.prev_hsp = a.end[E_HSP * B + b];
    }
    const bool heating_mode = a.mode[o] == 2.f;
    const float current_sp = heating_mode ? hsp_eff : csp_eff;
    const float prev_sp = heating_mode ? s.prev_hsp : s.prev_csp;
    const float p_inc = logistic(a.a_inc[o], a.b_inc[o], temp_t);
    const float p_dec = logistic(a.a_dec[o], a.b_dec[o], temp_t);
    const float rp = a.rand[t];
    const float f2 = s.prev_temp - prev_sp;
    float delta = 0.f;
    if (p_inc >= rp && p_dec < rp) {
        delta = tree_delta(a, b, 0, current_sp, prev_sp, f2);
    } else if (p_dec >= rp && p_inc < rp) {
        delta = -tree_delta(a, b, 1, current_sp, prev_sp, f2);
    }
    // the simulate_dynamics gate (building.py:2996)
    if (!(t >= a.gate[b])) delta = 0.f;
    const bool trig = fabsf(delta) > 0.f;
    s.counter = trig ? a.hold[b] : (s.counter >= 0 ? s.counter - 1 : s.counter);
    if (trig && !heating_mode) s.ov_c = csp_eff = current_sp + delta;
    if (trig && heating_mode) s.ov_h = hsp_eff = current_sp + delta;
    // this step keeps the fresh mutation; reversion applies from t + 1
    // (building.py:3310-3317)
    if (s.counter == 0) {
        s.ov_c = s.ov_h = nan;
        s.counter = -1;
    }
    s.prev_temp = temp_t;
    s.prev_csp = csp_eff;
    s.prev_hsp = hsp_eff;
}

// The episode of building b, run by the whole block. HC is its hidden size
// where a path is compiled for it (a multiple of 4: the weights in
// registers), 0 where it is read from meta (the weights read through L1);
// LC its layer count. Shared memory: the hidden vectors
// h[buffer][layer][MAX_H]; the rings of the normalized cooling and heating
// observation and of the temperature channel, [3][RINGS]; the staged
// temperature and set points of a chunk, [2][3][CHUNK]; a chunk's static
// channels [CHUNK][MAX_F]; each thread's static weights [MAX_F][NT]; the
// static products [RINGS][NT]. RINGS = lookback + CHUNK slots, row r of
// the stream in slot r % RINGS.
template <int HC, int LC>
__device__ void run_building(const Args& a, int b, float* smem) {
    const int B = a.B, S = a.S, lookback = a.lookback;
    const int NT = blockDim.x, r = threadIdx.x, lane = r & 31;
    const int* m = a.meta + b * N_META;
    const int H = HC > 0 ? HC : m[M_HIDDEN];
    const int F = m[M_CHANNELS];
    const int tc = m[M_TEMP_CH], cc = m[M_COOL_CH], hc = m[M_HEAT_CH];
    const int HP = (H + 3) / 4 * 4, FP = (F + 3) / 4 * 4;
    const int G4 = 4 * H;

    // thread 4j + q owns gate row q H + j; threads past 4H hold zero
    // weights and write nothing
    const bool active = r < G4;
    const int j = r >> 2, q = r & 3;
    const int row = active ? q * H + j : 0;
    const bool tanh_gate = q == 2;
    const int base = lane & ~3;                    // the lane of unit j's gate i

    // this building's weights in the flat buffer (ops/lstm.py LstmWeights),
    // column k of a layer at rows + k * 4H
    const float* rows1 = a.weights + m[M_W_OFF];
    const float* bias1 = rows1 + G4 * (FP + HP);
    const float* rows2 = bias1 + G4;
    const float* bias2 = rows2 + G4 * (HP + HP);
    const float* lin_w = LC == 2 ? bias2 + G4 : rows2;
    const float* schan = a.schan + m[M_X_OFF];
    auto w1 = [&](int k) { return active ? __ldg(rows1 + k * G4 + row) : 0.f; };
    auto w2 = [&](int k) { return active && LC == 2 ? __ldg(rows2 + k * G4 + row) : 0.f; };
    const float wc = cc >= 0 ? w1(cc) : 0.f, wh = hc >= 0 ? w1(hc) : 0.f, wt = w1(tc);
    const float b1 = active ? __ldg(bias1 + row) : 0.f;
    const float b2 = active && LC == 2 ? __ldg(bias2 + row) : 0.f;
    constexpr int HA = HC > 0 ? HC : 4;
    float w1h[HA], w2x[HA], w2h[HA];
#pragma unroll
    for (int k = 0; k < HA; ++k) {
        w1h[k] = HC > 0 ? w1(FP + k) : 0.f;
        w2x[k] = HC > 0 ? w2(k) : 0.f;
        w2h[k] = HC > 0 ? w2(HP + k) : 0.f;
    }
    const float* g1h = rows1 + FP * G4 + row;     // the same columns through L1
    const float* g2x = rows2 + row;
    const float* g2h = rows2 + HP * G4 + row;

    const float nmin_tc = a.prows[P_NMIN_TC * B + b], nspan_tc = a.prows[P_NSPAN_TC * B + b];
    const float nmin_cc = a.prows[P_NMIN_CC * B + b], nspan_cc = a.prows[P_NSPAN_CC * B + b];
    const float nmin_hc = a.prows[P_NMIN_HC * B + b], nspan_hc = a.prows[P_NSPAN_HC * B + b];
    const float lin_b = a.prows[P_LIN_B * B + b];

    const int RINGS = lookback + CHUNK;
    float* hbuf = smem;                            // [2][2][MAX_H]
    float* ring_c = smem + 4 * MAX_H;
    float* ring_h = ring_c + RINGS;
    float* ring_t = ring_h + RINGS;
    float* stage = ring_t + RINGS;                 // [2][3][CHUNK]
    float* xs = stage + 6 * CHUNK;                 // [CHUNK][MAX_F]
    float* ws = xs + CHUNK * MAX_F;                // [MAX_F][NT]
    float* sp = ws + MAX_F * NT;                   // [RINGS][NT]
    for (int i = r; i < 4 * MAX_H + 3 * RINGS; i += NT) smem[i] = 0.f;
    for (int f = 0; f < F; ++f) ws[f * NT + r] = w1(f);
    __syncthreads();

    // unit j's state, held alike by the four lanes of its gates
    float c1 = 0.f, h1 = 0.f, c2 = 0.f, h2 = 0.f;
    int par = 0;                                   // hbuf[par] holds the current vectors
    const bool occupant = a.a_inc != nullptr;
    const float nan = __int_as_float(0x7fc00000);
    Occupant occ = {nan, nan, 0.f, 0.f, 0.f, -1};
    int slot = 0;                                  // t % RINGS
    int ci = 0;                                    // t % CHUNK
    float* st = stage;                             // this chunk's staged series

    for (int t = 0; t < S; ++t) {
        const int o = t * B + b;
        if (ci == 0) {
            // the chunk's rows t .. t + n - 1, staged at once so that their
            // loads overlap: the static channels, the dynamic ones
            // (building.py:2960-2990) and the series thread 0 reads; then
            // layer 1's bias and static products of each row (read at
            // lookback window positions, building.py:3039-3055)
            const int n = min(CHUNK, S - t);
            for (int e = r; e < n * F; e += NT) {
                const int c = e / F;
                xs[c * MAX_F + e - c * F] = __ldg(schan + (size_t)(t + c) * a.X + e - c * F);
            }
            st = stage + ((t / CHUNK) & 1) * 3 * CHUNK;
            if (r < n) {
                const int oc = (t + r) * B + b, sl = (slot + r) % RINGS;
                if (cc >= 0) ring_c[sl] = (a.cobs[oc] - nmin_cc) / nspan_cc;
                if (hc >= 0) ring_h[sl] = (a.hobs[oc] - nmin_hc) / nspan_hc;
                st[r] = a.temp[oc];
                st[CHUNK + r] = a.csp[oc];
                st[2 * CHUNK + r] = a.hsp[oc];
            }
            __syncthreads();
            if (active) {
                int sl = slot;
                for (int c = 0; c < n; ++c) {
                    float s = b1;
                    for (int f = 0; f < F; ++f) {
                        if (f != cc && f != hc && f != tc) {
                            s = __fmaf_rn(ws[f * NT + r], xs[c * MAX_F + f], s);
                        }
                    }
                    sp[sl * NT + r] = s;
                    sl = sl + 1 == RINGS ? 0 : sl + 1;
                }
            }
        }
        // the staged rows, and the temperature row t - 1 that thread 0 wrote
        __syncthreads();
        float temp_n = 0.f;                        // warp 0's head
        if (t >= lookback) {
            // interval k runs layer 1 at window position k and layer 2 at
            // k - 1, both always, the first and last interval dropping the
            // layer that has no position; position s reads the static
            // channels and the demand observations of row t - lookback + 1 + s
            // and the temperature of the row before (building.py:3039-3055)
            int slot_t = slot - lookback < 0 ? slot - lookback + RINGS : slot - lookback;
            for (int k = 0; k < lookback + LC - 1; ++k) {
                const bool do1 = k < lookback, do2 = LC == 2 && k >= 1;
                const float* h1r = hbuf + par * 2 * MAX_H;
                const float* h2r = h1r + MAX_H;
                float* h1w = hbuf + (par ^ 1) * 2 * MAX_H;
                float* h2w = h1w + MAX_H;
                const int slot_m = slot_t + 1 == RINGS ? 0 : slot_t + 1;
                float g1 = __fmaf_rn(wc, ring_c[slot_m], sp[slot_m * NT + r]);
                g1 = __fmaf_rn(wh, ring_h[slot_m], g1);
                g1 = __fmaf_rn(wt, ring_t[slot_t], g1);
                g1 = g1 + dot<HC>(w1h, g1h, G4, H, h1r);
                const float a1 = gate_act(g1, tanh_gate);
                float c1n = c1;
                const float h1n = cell_update(
                    __shfl_sync(FULL, a1, base), __shfl_sync(FULL, a1, base + 1),
                    __shfl_sync(FULL, a1, base + 2), __shfl_sync(FULL, a1, base + 3), c1n);
                if constexpr (LC == 2) {
                    const float g2 = b2 + dot<HC>(w2x, g2x, G4, H, h1r)
                        + dot<HC>(w2h, g2h, G4, H, h2r);
                    const float a2 = gate_act(g2, tanh_gate);
                    float c2n = c2;
                    const float h2n = cell_update(
                        __shfl_sync(FULL, a2, base), __shfl_sync(FULL, a2, base + 1),
                        __shfl_sync(FULL, a2, base + 2), __shfl_sync(FULL, a2, base + 3), c2n);
                    c2 = do2 ? c2n : c2;
                    h2 = do2 ? h2n : h2;
                }
                c1 = do1 ? c1n : c1;
                h1 = do1 ? h1n : h1;
                if (active && q == 0) {
                    h1w[j] = h1;
                    h2w[j] = h2;
                }
                __syncthreads();
                par ^= 1;
                slot_t = slot_m;
            }
            // the head reads the top layer's last hidden output
            if (r < 32) {
                const float* top = hbuf + par * 2 * MAX_H + (LC == 2 ? MAX_H : 0);
                float p = 0.f;
                for (int u = lane; u < H; u += 32) p = __fmaf_rn(__ldg(lin_w + u), top[u], p);
#pragma unroll
                for (int w = 16; w > 0; w >>= 1) p += __shfl_xor_sync(FULL, p, w);
                temp_n = p + lin_b;
            }
        }
        if (r == 0) {
            const float temp_ideal = st[ci];
            float temp_t = temp_ideal;
            if (t >= lookback) {
                temp_t = temp_n * nspan_tc + nmin_tc;
            } else {
                temp_n = (temp_ideal - nmin_tc) / nspan_tc;
            }
            // the newest temperature entry: the data until the window is
            // full, the prediction from then on (building.py:3060-3065)
            ring_t[slot] = temp_n;
            a.temp_out[o] = temp_t;
            float csp_eff = st[CHUNK + ci], hsp_eff = st[2 * CHUNK + ci];
            if (occupant) occupant_step(a, b, t, temp_t, occ, csp_eff, hsp_eff);
            a.csp_out[o] = csp_eff;
            a.hsp_out[o] = hsp_eff;
        }
        slot = slot + 1 == RINGS ? 0 : slot + 1;
        ci = ci + 1 == CHUNK ? 0 : ci + 1;
    }
    if (occupant && r == 0) {
        a.ov_c[b] = occ.ov_c;
        a.ov_h[b] = occ.ov_h;
        a.counter[b] = occ.counter;
        a.prev_temp[b] = occ.prev_temp;
        a.prev_csp[b] = occ.prev_csp;
        a.prev_hsp[b] = occ.prev_hsp;
    }
}

template <int LC>
__device__ void run(const Args& a, int b, int H, float* smem) {
    switch (H) {
        case 8: run_building<8, LC>(a, b, smem); break;
        case 16: run_building<16, LC>(a, b, smem); break;
        case 24: run_building<24, LC>(a, b, smem); break;
        case 32: run_building<32, LC>(a, b, smem); break;
        default: run_building<0, LC>(a, b, smem);
    }
}

__global__ void __launch_bounds__(MAX_THREADS) neighborhood_postpass_kernel(const Args a) {
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x;
    const int* m = a.meta + b * N_META;
    if (m[M_LAYERS] == 2) {
        run<2>(a, b, m[M_HIDDEN], smem);
    } else {
        run<1>(a, b, m[M_HIDDEN], smem);
    }
}

}  // namespace

// threads: a multiple of 32, at least 4 x the largest hidden size, at most
// 4 x MAX_H (ops/postpass.py::block_threads); the shared memory then takes
// at most 170,228 bytes (lookback 95, 256 threads)
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
        int B, int S, int X, int lookback, int n_nodes, int depth, int threads,
        void* stream) {
    const Args a = {weights, prows, schan, meta, cobs, hobs, temp, csp, hsp, mode,
                    a_inc, b_inc, a_dec, b_dec, rand, end, left, right, feature,
                    threshold, delta, hold, gate,
                    temp_out, csp_out, hsp_out, ov_c, ov_h, counter, prev_temp, prev_csp,
                    prev_hsp, B, S, X, lookback, n_nodes, depth};
    const size_t smem_bytes =
        sizeof(float) * (4 * MAX_H + 6 * CHUNK + CHUNK * MAX_F + MAX_F * threads
                         + (size_t)(lookback + CHUNK) * (3 + threads));
    cudaError_t err = cudaFuncSetAttribute(neighborhood_postpass_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    neighborhood_postpass_kernel<<<B, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        a);
    return static_cast<int>(cudaGetLastError());
}
