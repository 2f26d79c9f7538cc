// K closed-loop battery+PV steps of a district batch with per-district
// action, non-shiftable-load and solar streams (kernel K2): the env
// recurrence of the batched SAC trainer's chunked collect.
//
// Replaces citylearn_tpu/ops/pallas_collect.py::_collect_chunk_kernel
// (body _collect_kernel, curve lookup _interp). The Pallas kernel puts
// 128 districts on the lane axis of a tile and the buildings on
// sublanes padded to a multiple of 8, and its d_last layout exists only
// to keep districts on TPU lanes end to end. None of that carries over:
// the streams here are (K, D, B) contiguous and one thread owns one
// (district, building) pair, index d * B + b, so a warp's reads and
// writes of step k are one contiguous span of the stream, with no
// padding and no transposes around the launch.
//
// What bounds it on an H100: neither bytes (4 streams of K x D x B floats,
// about 21 MB at D=4096, K=64, B=5: some 6 us at 3.35 TB/s) nor fp32
// throughput (about 1e2 operations per pair-step), but the latency of each
// step's dependent chain through the carried state (SOC -> energy -> two
// curve lookups -> square root -> SOC, efficiency and degraded capacity)
// times K, with only D x B chains in flight (20,480 at D=4096, B=5: about
// one warp a scheduler, so nothing hides a stalled warp). The design takes
// everything else off that chain:
//   - the actions are per district, so the lanes of a warp charge and
//     discharge in the same step: a step runs battery::event_select_fast
//     (csrc/battery_common.cuh), both sides of the event by selects with
//     no branch on the sign and none around the divisions and square
//     roots; a lane whose operands left the fast sequences' range redoes
//     its step with battery::event and IEEE operations, so the bits are
//     IEEE's either way;
//   - each thread stages its own stream entries through a ring of RING
//     steps in shared memory with cp.async, step k + RING - 1 requested
//     before step k's chain, so no step waits on L2 or device memory;
//   - the block keeps one copy of the battery rows and knots in shared
//     memory (the lookups unrolled over the knot count, fixed at compile
//     time for 5, the knot count of every battery in the repo's datasets,
//     and over MAX_KNOTS predicated for any other);
//   - blocks of 160 threads: 128 blocks at D=4096, B=5, one an SM.
// What is left is the chain itself: the time does not depend on D (the same
// at D=132 as at D=4096 on an H100), so one warp's step sets the pace, and
// the step loop is not unrolled (unrolled twice it was slower).
//
// Built with -fmad=false and IEEE division/square root so that every
// operation rounds exactly as the plain PyTorch version
// (ops/collect.py::battery_collect_chunk_reference) rounds it.

#include <cuda_pipeline.h>

#include "battery_common.cuh"

namespace {

using battery::BatteryShared;
using battery::max_nan;

constexpr int THREADS = 160;        // (district, building) pairs per block
constexpr int RING = 4;             // steps of each thread's streams staged at a time

struct Args {
    const float *act, *nsl, *solar, *bparams, *pec_x, *pec_y, *cpc_x, *cpc_y;
    const float *soc0, *eff0, *deg0;
    float *reward, *soc, *eff, *deg;
    int D, B, K, n_knots;
    float hours_ratio, ratio;
    int first_chunk;
};

// Thread i of the grid owns pair i = d * B + b. The dynamic shared memory
// holds the battery table: bparams (8, B), then the four curves (n_knots,
// B) knot-major. NK > 0 fixes the knot count at compile time.
template <int NK>
__global__ void __launch_bounds__(THREADS) collect_kernel(const Args a) {
    extern __shared__ float tab[];
    __shared__ float ring[RING][3][THREADS];     // act, nsl, solar of steps k ... k + RING - 1
    const int tid = threadIdx.x;
    const int DB = a.D * a.B;
    const int i = blockIdx.x * THREADS + tid;
    const bool live = i < DB;

    // step k's stream entries into ring slot k % RING, one commit group a step
    auto request = [&](int k) {
        if (live && k < a.K) {
            const size_t o = static_cast<size_t>(k) * DB + i;
            float(*slot)[THREADS] = ring[k % RING];
            __pipeline_memcpy_async(&slot[0][tid], a.act + o, 4);
            __pipeline_memcpy_async(&slot[1][tid], a.nsl + o, 4);
            __pipeline_memcpy_async(&slot[2][tid], a.solar + o, 4);
        }
        __pipeline_commit();
    };
    for (int k = 0; k < RING - 1; ++k) request(k);

    const int B = a.B, nB = a.n_knots * B;
    float* knots = tab + 8 * B;
    for (int j = tid; j < 8 * B; j += THREADS) tab[j] = a.bparams[j];
    for (int j = tid; j < 4 * nB; j += THREADS) {
        const int c = j / nB;
        const float* curve = c == 0 ? a.pec_x : c == 1 ? a.pec_y : c == 2 ? a.cpc_x : a.cpc_y;
        knots[j] = curve[j - c * nB];
    }
    __syncthreads();
    if (!live) return;
    const BatteryShared<NK> bat(tab, knots, knots + nB, knots + 2 * nB, knots + 3 * nB, i % B,
                                B, NK > 0 ? NK : a.n_knots);

    float soc = a.soc0[i], eff = a.eff0[i], deg = a.deg0[i];
    for (int k = 0; k < a.K; ++k) {
        // into the slot that step k - 1 was read from; then step k's group
        // is the oldest of RING outstanding
        request(k + RING - 1);
        __pipeline_wait_prior(RING - 1);
        const float(*slot)[THREADS] = ring[k % RING];
        const float act = slot[0][tid], nsl = slot[1][tid], solar = slot[2][tid];
        // the request as the plain version's action * nominal * hours_ratio
        // (ops/battery.py::battery_event), in its order of operations
        const float energy = act * bat.nominal * a.hours_ratio;
        float soc1 = soc, eff1 = eff, deg1 = deg;
        bool slow = false;
        float balance = battery::event_select_fast(bat, energy, a.ratio, soc1, eff1, deg1, slow);
        if (slow) {          // this lane alone, from the step's saved state
            soc1 = soc;
            eff1 = eff;
            deg1 = deg;
            balance = battery::event(bat, energy, a.ratio, soc1, eff1, deg1);
        }
        soc = soc1;
        eff = eff1;
        deg = deg1;
        // net accounting with the t == 0 triple/double count
        // (building.py:2615-2652); t == 0 is the first step of the first
        // chunk of an episode (the trainer aligns chunks to episodes)
        const bool t0 = a.first_chunk && k == 0;
        const float nsl_term = t0 ? 3.f * nsl : nsl;
        const float bat_term = t0 ? 2.f * balance : balance;
        const float net = nsl_term + bat_term - solar;
        a.reward[static_cast<size_t>(k) * DB + i] = -max_nan(net, 0.f);
    }
    a.soc[i] = soc;
    a.eff[i] = eff;
    a.deg[i] = deg;
}

// The table takes (8 + 4 n_knots) x B floats of dynamic shared memory, 560
// bytes for 5 buildings of 5 knots; a block past 48 KB with the ring's 7,680
// (some 370 buildings) fails to launch, and the wrapper raises.
template <int NK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    const int blocks = (a.D * a.B + THREADS - 1) / THREADS;
    const size_t shared = sizeof(float) * (8 + 4 * a.n_knots) * a.B;
    collect_kernel<NK><<<blocks, THREADS, shared, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" int battery_collect_launch(
        const float* act, const float* nsl, const float* solar,
        const float* bparams, const float* pec_x, const float* pec_y,
        const float* cpc_x, const float* cpc_y, const float* soc0,
        const float* eff0, const float* deg0, float* reward, float* soc,
        float* eff, float* deg, int D, int B, int K, int n_knots,
        float hours_ratio, float ratio, int first_chunk, void* stream) {
    const Args a = {act, nsl, solar, bparams, pec_x, pec_y, cpc_x, cpc_y, soc0, eff0, deg0,
                    reward, soc, eff, deg, D, B, K, n_knots, hours_ratio, ratio, first_chunk};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    // a build for 5 knots, any other count at run time
    return static_cast<int>(n_knots == 5 ? launch<5>(a, s) : launch<0>(a, s));
}
