// Whole-episode rollout of a batch of thermal-storage districts (cooling
// and DHW end uses with tanks, a battery and PV) under shared open-loop
// action plans (kernel K3).
//
// Replaces citylearn_tpu/ops/pallas_thermal.py::thermal_episode (body
// _episode_kernel). The Pallas kernel tiles 256 districts x 128 lanes,
// streams ten series through VMEM in double-buffered 256-step chunks and
// copies district 0's record out by DMA; none of that layout carries
// over. Under open-loop plans most of a building-step does not depend on
// the district: the two COPs, the reset-time consumptions, each end use's
// energy request and, on a charging or idle step, the device's output, its
// consumption and the tank's charge are functions of the step and the
// building only. Only the five carried states (two tank SOCs, battery SOC,
// efficiency, degraded capacity) differ between districts. So one launch
// runs two kernels:
//
//   1. the prelude, a stateless thread per (step, building), computes that
//      part once and writes it into a building-major scratch
//      (B, N_STAGE, S_pad) that the wrapper allocates: per end use the
//      tank's request after its power clamp, already multiplied or divided
//      by sqrt(efficiency) as the tank's event will apply it, the device's
//      output and consumption (charging) or the demand and the booked
//      consumption (discharging), the COP and the reset-time consumption;
//      the action signs as flag bits; the battery's energy request; the
//      non-shiftable load's term and the solar, price and carbon rows;
//   2. the district pass, grid (ceil(D / THREADS), B): a block holds
//      THREADS districts of one building, so every warp takes the same
//      branch of each end use and of the battery event. A thread owns one
//      district with its five states and three sums in registers. The
//      block keeps one copy of its building's battery parameters and knots
//      in shared memory (the lookups unrolled over the knot count, fixed at
//      compile time for 5, the knot count of every battery in the repo's
//      datasets, and over MAX_KNOTS predicated for any other) and stages
//      CHUNK steps of its scratch rows at a time with cp.async,
//      double-buffered, so that a step reads every shared input by a
//      broadcast from shared memory. A step is the two tank events and what
//      depends on their balances (both sides of each end use, selected by
//      the action's sign), the battery event, the net consumption and the
//      three sums.
//
// Every value is computed with the operations and in the order of
// thermal_common.cuh's EndUse::request and EndUse::serve, the two halves
// of its step with no outage, and of the accounting the plain version
// runs, so the split changes no bit: net keeps the reference's
// left-to-right sum, and the t == 0 terms t0f * (reset + uv) are taken at
// every step, as the plain version takes them (0 * inf is NaN, 0 * a
// negative value is -0).
//
// What bounds it on an H100: the latency of a step's dependent chain
// (the battery event's two curve lookups, IEEE divisions and square
// roots; the tanks' shorter chains beside it) times S, with only D x B
// chains in flight (36,864 at D = 4096, B = 9: ~9 warps an SM), not
// bytes nor fp32 throughput. The prelude takes the COP and reset
// divisions, the device side and ten global loads off that chain, the
// staged rows make a step's inputs shared-memory broadcasts, and the block
// per building keeps the warps' branches uniform. Every division and
// square root of a step runs without the branch that nvcc puts around it
// (battery::div_fast, sqrt_fast and event_fast): the step is redone with
// IEEE operations when one of its operands lies outside the fast
// sequences' range.
//
// The battery event is csrc/battery_common.cuh's, shared with the other
// kernels, and the COP and the end use's two halves csrc/thermal_common.cuh's.
// Built with -fmad=false and IEEE division and square root so that every
// operation rounds exactly as the plain PyTorch version
// (ops/thermal.py::thermal_episode_reference) rounds it.

#include <cuda_pipeline.h>

#include "thermal_common.cuh"

namespace {

using battery::BatteryShared;
using battery::MAX_KNOTS;
using battery::max_nan;
using battery::min_nan;
using thermal::EndUse;
using thermal::Served;

constexpr int PRELUDE_THREADS = 256;
constexpr int THREADS = 128;        // districts per block of the district pass
constexpr int CHUNK = 128;          // steps staged at a time (ops/thermal.py STAGE_CHUNK)

// recorded rows of district 0, as ops/thermal.py names them
enum Rec { R_NET, R_CBAL, R_DBAL, R_BBAL, R_CSOC, R_DSOC, R_BSOC, R_COUT, R_DOUT };
// rows of the scratch, per building (ops/thermal.py N_STAGE). Per end
// use: the tank's step (e * rt or e / rt, by the sign of its request e),
// A and Bv (charging: the device's output and consumption; discharging:
// the demand and the consumption booked before the block), the COP and
// the reset-time consumption.
enum Stage {
    ST_C_STEP, ST_C_A, ST_C_B, ST_C_COP, ST_C_RESET,
    ST_D_STEP, ST_D_A, ST_D_B, ST_D_COP, ST_D_RESET,
    ST_FLAGS, ST_NSL, ST_SOLAR, ST_PRICE, ST_CARBON, ST_BAT, N_STAGE
};
// ST_FLAGS bits: the end use charges or idles (its action is not < 0);
// its tank's request is >= 0
enum Flag { F_C_CHARGE = 1, F_C_UP = 2, F_D_CHARGE = 4, F_D_UP = 8 };

struct Args {
    const float *a_cool, *a_dhw, *a_bat, *nsl, *solar, *price, *carbon, *cool, *dhw, *outdoor;
    const float *bparams, *pec_x, *pec_y, *cpc_x, *cpc_y, *tparams;
    const float *csoc0, *dsoc0, *soc0, *eff0, *deg0;
    float *reward, *cost, *emission, *csoc, *dsoc, *soc, *eff, *deg, *rec, *stage;
    int D, B, S, S_pad, n_knots;
    float hours_ratio, ratio;
};

// Writes an end use's five rows at `st` and returns its flag bits.
__device__ __forceinline__ int write_rows(const thermal::Request& q, float cop, float reset,
                                          float* st, int S_pad, int row0, int charge_bit,
                                          int up_bit) {
    st[(row0 + 0) * S_pad] = q.step;
    st[(row0 + 1) * S_pad] = q.a;
    st[(row0 + 2) * S_pad] = q.b;
    st[(row0 + 3) * S_pad] = cop;
    st[(row0 + 4) * S_pad] = reset;
    return (q.charge ? charge_bit : 0) | (q.up ? up_bit : 0);
}

// 1. The prelude: one thread per (step, building), threads building-fastest.
__global__ void __launch_bounds__(PRELUDE_THREADS) prelude_kernel(const Args a) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;     // t * B + b
    if (o >= a.S * a.B) return;
    const int B = a.B;
    const int t = o / B;
    const int b = o - t * B;
    const EndUse cooling(a.tparams, thermal::CN, thermal::CT_CAP, thermal::CT_CONV, false, b, B);
    const EndUse dhw(a.tparams, thermal::DN, thermal::DT_CAP, thermal::DT_CONV, true, b, B);

    const float t0f = t == 0 ? 1.f : 0.f;
    const float cool_d = a.cool[o], dhw_d = a.dhw[o];
    const float cop_c = cooling.cop(a.outdoor[o]);
    const float cop_d = dhw.cop(a.outdoor[o]);
    float* st = a.stage + static_cast<size_t>(b) * N_STAGE * a.S_pad + t;
    // reset-time update_variables consumptions, booked at t == 0
    // (building.py:2554-2558, 2618-2652); cooling takes no hours ratio,
    // DHW does (building.py:1663, 1765)
    const float reset_c = cool_d / cop_c, reset_d = dhw_d / cop_d;
    const int flags =
        write_rows(cooling.request(cool_d, a.a_cool[o], cop_c, t0f * reset_c, 1.f, a.ratio),
                   cop_c, reset_c, st, a.S_pad, ST_C_STEP, F_C_CHARGE, F_C_UP)
        | write_rows(dhw.request(dhw_d, a.a_dhw[o], cop_d, t0f * reset_d, a.hours_ratio, a.ratio),
                     cop_d, reset_d, st, a.S_pad, ST_D_STEP, F_D_CHARGE, F_D_UP);
    const float nsl = a.nsl[o];
    st[ST_FLAGS * a.S_pad] = __int_as_float(flags);
    st[ST_NSL * a.S_pad] = nsl + t0f * 2.f * nsl;
    st[ST_SOLAR * a.S_pad] = a.solar[o];
    st[ST_PRICE * a.S_pad] = a.price[o];
    st[ST_CARBON * a.S_pad] = a.carbon[o];
    st[ST_BAT * a.S_pad] = a.a_bat[o] * a.bparams[1 * B + b] * a.hours_ratio;
}

// The staged request of the end use whose rows start at `row0`.
__device__ __forceinline__ thermal::Request staged(const float (*r)[CHUNK], int row0, int k,
                                                   bool charge, bool up) {
    return {r[row0 + 0][k], r[row0 + 1][k], r[row0 + 2][k], charge, up};
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
    const EndUse cooling(a.tparams, thermal::CN, thermal::CT_CAP, thermal::CT_CONV, false, b, B);
    const EndUse dhw(a.tparams, thermal::DN, thermal::DT_CAP, thermal::DT_CONV, true, b, B);

    float csoc = a.csoc0[j], dsoc = a.dsoc0[j];
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
            const float t0f = t == 0 ? 1.f : 0.f;
            const int flags = __float_as_int(r[ST_FLAGS][k]);
            const thermal::Request cq = staged(r, ST_C_STEP, k, flags & F_C_CHARGE, flags & F_C_UP);
            const thermal::Request dq = staged(r, ST_D_STEP, k, flags & F_D_CHARGE, flags & F_D_UP);
            const float c_cop = r[ST_C_COP][k], c_reset = r[ST_C_RESET][k];
            const float d_cop = r[ST_D_COP][k], d_reset = r[ST_D_RESET][k];
            // every division and square root without nvcc's branch; the step
            // is redone with IEEE operations from its state before it when an
            // operand lay outside the fast range
            float csoc1 = csoc, dsoc1 = dsoc, soc1 = soc, eff1 = eff, deg1 = deg;
            bool slow = false;
            Served cs = cooling.serve<true>(cq, c_cop, c_reset, t0f, csoc1, slow);
            Served ws = dhw.serve<true>(dq, d_cop, d_reset, t0f, dsoc1, slow);
            float balance = battery::event_fast(bat, r[ST_BAT][k], a.ratio, soc1, eff1, deg1,
                                                slow);
            if (slow) {
                csoc1 = csoc;
                dsoc1 = dsoc;
                soc1 = soc;
                eff1 = eff;
                deg1 = deg;
                cs = cooling.serve<false>(cq, c_cop, c_reset, t0f, csoc1, slow);
                ws = dhw.serve<false>(dq, d_cop, d_reset, t0f, dsoc1, slow);
                balance = battery::event(bat, r[ST_BAT][k], a.ratio, soc1, eff1, deg1);
            }
            csoc = csoc1;
            dsoc = dsoc1;
            soc = soc1;
            eff = eff1;
            deg = deg1;
            const float bat_term = balance + t0f * balance;
            const float net = cs.total + ws.total + r[ST_NSL][k] + bat_term - r[ST_SOLAR][k];
            if (recording) {
                const int o = t * B + b;
                a.rec[R_NET * SB + o] = net;
                a.rec[R_CBAL * SB + o] = cs.balance;
                a.rec[R_DBAL * SB + o] = ws.balance;
                a.rec[R_BBAL * SB + o] = balance;
                a.rec[R_CSOC * SB + o] = csoc;
                a.rec[R_DSOC * SB + o] = dsoc;
                a.rec[R_BSOC * SB + o] = soc;
                a.rec[R_COUT * SB + o] = cs.out;
                a.rec[R_DOUT * SB + o] = ws.out;
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
        a.csoc[j] = csoc;
        a.dsoc[j] = dsoc;
        a.soc[j] = soc;
        a.eff[j] = eff;
        a.deg[j] = deg;
    }
}

}  // namespace

// `stage`: float32 scratch of B * N_STAGE * S_pad, S_pad a multiple of
// CHUNK at least S.
extern "C" int thermal_episode_launch(
        const float* a_cool, const float* a_dhw, const float* a_bat, const float* nsl,
        const float* solar, const float* price, const float* carbon,
        const float* cool_demand, const float* dhw_demand, const float* outdoor,
        const float* bparams, const float* pec_x, const float* pec_y, const float* cpc_x,
        const float* cpc_y, const float* tparams, const float* csoc0, const float* dsoc0,
        const float* soc0, const float* eff0, const float* deg0, float* reward, float* cost,
        float* emission, float* csoc, float* dsoc, float* soc, float* eff, float* deg,
        float* rec, float* stage, int D, int B, int S, int S_pad, int n_knots,
        float hours_ratio, float ratio, void* stream) {
    if (S_pad % CHUNK != 0 || S_pad < S) return static_cast<int>(cudaErrorInvalidValue);
    const Args a = {a_cool, a_dhw, a_bat, nsl, solar, price, carbon, cool_demand, dhw_demand,
                    outdoor, bparams, pec_x, pec_y, cpc_x, cpc_y, tparams,
                    csoc0, dsoc0, soc0, eff0, deg0,
                    reward, cost, emission, csoc, dsoc, soc, eff, deg, rec, stage,
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
