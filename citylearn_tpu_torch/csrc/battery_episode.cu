// Whole-episode battery+PV rollout of a batch of districts under one
// shared open-loop action plan (kernel K1).
//
// Replaces citylearn_tpu/ops/pallas_battery.py::battery_episode (body
// _episode_kernel, curve lookup _interp). The Pallas kernel tiles 256
// districts x 128 lanes and streams the series through VMEM in 512-step
// chunks; none of that layout carries over. One launch runs two kernels:
//
//   1. the prelude, a stateless thread per (step, building), writes a
//      building-major scratch (B, N_STAGE, S_pad) that the wrapper
//      allocates: the battery's energy request action * nominal *
//      hours_ratio, the non-shiftable load's term with its t == 0 triple
//      count, and the solar, price and carbon rows;
//   2. the district pass, grid (ceil(D / THREADS), B): a block holds
//      THREADS districts of one building, so every warp takes the same
//      branch of the battery event, and a thread owns one district with
//      its SOC, efficiency, degraded capacity and three sums in
//      registers. The block keeps one copy of its building's battery
//      parameters and knots in shared memory (the lookups unrolled over
//      the knot count, fixed at compile time for 5, the knot count of
//      every battery in the repo's datasets, and over MAX_KNOTS predicated
//      for any other) and stages CHUNK steps of the scratch rows at a
//      time with cp.async, double-buffered, so that a step's inputs are
//      broadcast reads from shared memory that do not wait on L2.
//
// What bounds it on an H100: neither bytes (a few MB in all) nor fp32
// throughput (about 70 operations per district-step), but the latency of
// each step's dependent chain through the carried state (SOC -> energy ->
// two curve lookups -> square root -> SOC, efficiency and degraded
// capacity: IEEE divisions and square roots one after another) times S,
// with only D x B chains in flight (20,480 at D = 4096, B = 5: ~5 warps
// an SM, ~1 a scheduler, so nothing hides a stalled warp). The design takes
// everything else off that chain: the loads, the request's
// multiplications, divergent branches, and the branch that nvcc puts
// around every IEEE division and square root (a range check and a call to
// a slow path, which cut a step into a dozen basic blocks that a warp
// runs one after another): a step runs battery::event_fast, the same
// operations without those branches, and is redone with battery::event
// when one of its operands lies outside the fast sequences' range
// (csrc/battery_common.cuh). The step loop is unrolled twice.
//
// The battery event is csrc/battery_common.cuh's, shared with the other
// kernels. Built with -fmad=false and IEEE division/square root so that
// every operation rounds exactly as the plain PyTorch version
// (ops/battery.py::battery_episode_reference) rounds it.

#include <cuda_pipeline.h>

#include "battery_common.cuh"

namespace {

using battery::BatteryShared;
using battery::MAX_KNOTS;
using battery::max_nan;

constexpr int PRELUDE_THREADS = 256;
constexpr int THREADS = 128;        // districts per block of the district pass
constexpr int CHUNK = 128;          // steps staged at a time (ops/battery.py STAGE_CHUNK)

// recorded rows of district 0: net, battery balance, battery soc
enum Rec { R_NET, R_BAL, R_SOC };
// rows of the scratch, per building (ops/battery.py N_STAGE)
enum Stage { ST_ENERGY, ST_NSL, ST_SOLAR, ST_PRICE, ST_CARBON, N_STAGE };

struct Args {
    const float *act, *nsl, *solar, *price, *carbon;
    const float *bparams, *pec_x, *pec_y, *cpc_x, *cpc_y, *soc0, *eff0, *deg0;
    float *reward, *cost, *emission, *soc, *eff, *deg, *rec, *stage;
    int D, B, S, S_pad, n_knots;
    float hours_ratio, ratio;
};

// 1. The prelude: one thread per (step, building), threads building-fastest.
__global__ void __launch_bounds__(PRELUDE_THREADS) prelude_kernel(const Args a) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;     // t * B + b
    if (o >= a.S * a.B) return;
    const int t = o / a.B;
    const int b = o - t * a.B;
    float* st = a.stage + static_cast<size_t>(b) * N_STAGE * a.S_pad + t;
    // the request as the plain version's action * nominal * hours_ratio
    // (ops/battery.py::battery_event); the t == 0 triple count of the
    // non-shiftable load (building.py:2615-2652)
    st[ST_ENERGY * a.S_pad] = a.act[o] * a.bparams[1 * a.B + b] * a.hours_ratio;
    st[ST_NSL * a.S_pad] = t == 0 ? 3.f * a.nsl[o] : a.nsl[o];
    st[ST_SOLAR * a.S_pad] = a.solar[o];
    st[ST_PRICE * a.S_pad] = a.price[o];
    st[ST_CARBON * a.S_pad] = a.carbon[o];
}

// 2. The district pass: block (x, b) holds districts x * THREADS ... of
// building b. Threads past D run on district D - 1's state and write
// nothing. NK > 0 fixes the battery's knot count at compile time.
template <int NK>
__global__ void __launch_bounds__(THREADS) district_kernel(const Args a) {
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
    for (int i = tid; i < 4 * MAX_KNOTS; i += THREADS) {
        const int c = i / MAX_KNOTS, k = i - c * MAX_KNOTS;
        const float* curve = c == 0 ? a.pec_x : c == 1 ? a.pec_y : c == 2 ? a.cpc_x : a.cpc_y;
        knots[c][k] = k < a.n_knots ? curve[k * B + b] : 0.f;
    }
    __syncthreads();
    const BatteryShared<NK> bat(tab, knots[0], knots[1], knots[2], knots[3], 0, 1,
                                NK > 0 ? NK : a.n_knots);

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
#pragma unroll 2
        for (int k = 0; k < n; ++k) {
            const int t = t0 + k;
            // the event without the division's and square root's branches,
            // redone with them when an operand lies outside their fast range
            const float energy = r[ST_ENERGY][k];
            float soc1 = soc, eff1 = eff, deg1 = deg;
            bool slow = false;
            float balance = battery::event_fast(bat, energy, a.ratio, soc1, eff1, deg1, slow);
            if (slow) {
                soc1 = soc;
                eff1 = eff;
                deg1 = deg;
                balance = battery::event(bat, energy, a.ratio, soc1, eff1, deg1);
            }
            soc = soc1;
            eff = eff1;
            deg = deg1;
            // net accounting with the t == 0 double count of the balance
            // (building.py:2615-2652)
            const float bat_term = t == 0 ? 2.f * balance : balance;
            const float net = r[ST_NSL][k] + bat_term - r[ST_SOLAR][k];
            if (recording) {
                const int o = t * B + b;
                a.rec[R_NET * SB + o] = net;
                a.rec[R_BAL * SB + o] = balance;
                a.rec[R_SOC * SB + o] = soc;
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
        a.soc[j] = soc;
        a.eff[j] = eff;
        a.deg[j] = deg;
    }
}

}  // namespace

// `stage`: float32 scratch of B * N_STAGE * S_pad, S_pad a multiple of
// CHUNK at least S.
extern "C" int battery_episode_launch(
        const float* act, const float* nsl, const float* solar,
        const float* price, const float* carbon, const float* bparams,
        const float* pec_x, const float* pec_y, const float* cpc_x,
        const float* cpc_y, const float* soc0, const float* eff0,
        const float* deg0, float* reward, float* cost, float* emission,
        float* soc, float* eff, float* deg, float* rec, float* stage, int D, int B, int S,
        int S_pad, int n_knots, float hours_ratio, float ratio, void* stream) {
    if (S_pad % CHUNK != 0 || S_pad < S) return static_cast<int>(cudaErrorInvalidValue);
    const Args a = {act, nsl, solar, price, carbon, bparams, pec_x, pec_y, cpc_x, cpc_y,
                    soc0, eff0, deg0, reward, cost, emission, soc, eff, deg, rec, stage,
                    D, B, S, S_pad, n_knots, hours_ratio, ratio};
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
