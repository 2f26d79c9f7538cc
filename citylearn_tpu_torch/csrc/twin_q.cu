// The twin soft-Q pass of the SAC update: both critics of a pair, (q1, q2)
// or (q1_target, q2_target), for every agent, forward and backward, one
// launch a layer for both critics.
//
// Replaces no Pallas kernel: the JAX package leaves the whole update to
// XLA, which fuses the networks' elementwise work into its products. The
// port ran each critic's pass as PyTorch operations, some 12 small kernels
// a hidden layer forward (the product, the broadcast bias add, relu and
// LayerNorm written out) and about twice that backward, each critic on its
// own: ~410 of the update's ~565 kernels outside Adam. These kernels do a
// layer of both critics and every agent at once, with the bias, relu,
// LayerNorm and the value head fused around the product.
//
// What bounds it on an H100: fp32 multiply-adds, A x N x in x out of them a
// layer and critic (no TF32: the update is held to fp32 by the benchmark's
// comparison). At the benchmark's shapes (A=5, N=256, 256x256 nets) the
// second layer's product of both critics is 2 x 5 x 256 x 256^2 = 168M
// multiply-adds (0.34 GFLOP): ~5 us at 67 TFLOP/s. So the products are
// small, and what the design does is keep the launches few and the
// elementwise work out of device memory:
//   - a block owns a tile of 16 rows of one critic and agent (grid critic x
//     agent x row tile), with all of a layer's columns: LayerNorm reduces
//     along the row, so its whole row is in the block's shared memory;
//   - 256 threads, each 4 rows x TN columns strided by 64 (TN = 1, 2, 4, 8
//     for widths up to 64, 128, 256, 512), the product streamed through
//     shared memory in chunks of depth 16 with fmaf in the inner loop
//     (the build's -fmad=false holds everywhere else);
//   - the first layer reads obs and act through their strides, with no
//     concatenation; the value head (width to 1) is a row dot product in
//     the last layer's epilogue;
//   - backward, a row pass (the head's, LayerNorm's and relu's gradient by
//     a warp a row into dz in shared memory, then dx = dz W^T) and a column
//     pass (dW = x^T dz in 64 x 64 tiles over all N rows in order, and the
//     column sums of the bias and LayerNorm gradients).
// No atomics: every sum is taken in one fixed order, so a CUDA graph's
// replay and an eager run give the same bits. A warp's row sums are
// butterflies (__shfl_xor_sync), after which every lane holds the same sum.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 16;                      // rows of a block's tile
constexpr int BK = 16;                      // depth of a chunk of a product; == BM, so the
                                            // forward's epilogue reuses the chunk's buffer
constexpr int TC = 64;                      // threads across a tile's columns
constexpr int TM = BM / (THREADS / TC);     // rows a thread: 4
constexpr int CT = 64;                      // the column pass's tile of dW: CT x CT
constexpr int MAX_WIDTH = 512;
constexpr float LN_EPS = 1e-5f;
static_assert(BK * BM == THREADS, "the forward loads its input's chunk one element a thread");

struct Pair {
    const float* p[2];
};
struct OutPair {
    float* p[2];
};

// A layer's input x[c, a, n, k]: columns k < K from x (critic stride 0
// where both critics read the same input), columns K <= k < K + M from x2.
struct Input {
    const float* x;
    long long sc, sa, sn, sk;
    int K;
    const float* x2;
    long long sa2, sn2, sk2;
    int M;
};

__device__ __forceinline__ float input_at(const Input& in, int c, int a, int n, int k) {
    return k < in.K ? __ldg(in.x + c * in.sc + a * in.sa + n * in.sn + k * in.sk)
                    : __ldg(in.x2 + a * in.sa2 + n * in.sn2 + (k - in.K) * in.sk2);
}

__device__ __forceinline__ float warp_sum(float v) {
    // each step adds a pair in both orders, and addition commutes: every
    // lane ends with the same sum
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// --- forward -------------------------------------------------------------

struct Forward {
    Input in;
    int A, N, H;
    Pair w, b, g, beta;         // (A, K + M, H), (A, H) x 3
    Pair hw, hb;                // the head, (A, H, 1) and (A, 1): the last layer only, else null
    float* y;                   // (2, A, N, H) LayerNorm's output; null on the last layer unsaved
    float* r;                   // (2, A, N, H) relu's output, saved for the backward, or null
    float* mean;                // (2, A, N) saved, or null
    float* sd;                  // (2, A, N) sqrt(var + eps), saved, or null
    OutPair q;                  // (A, N) each: the value, the last layer only
};

template <int TN>
__global__ void __launch_bounds__(THREADS) forward_layer(Forward p) {
    extern __shared__ __align__(16) float smem[];
    const int c = blockIdx.z, a = blockIdx.y, n0 = blockIdx.x * BM;
    const int tid = threadIdx.x, tx = tid % TC, ty = tid / TC;
    constexpr int HP = TC * TN, WS = BK * HP / THREADS;   // WS: weights a thread stages
    const int K = p.in.K + p.in.M, H = p.H;
    float* xs = smem;                       // [BK][BM + 1]: the input's chunk
    float* ws = smem + BK * (BM + 1);       // [BK][HP]: the weights' chunk, then [BM][HP]: relu's output
    const float* w = p.w.p[c] + static_cast<size_t>(a) * K * H;

    // each chunk is staged through registers: the next chunk's loads are in
    // flight while this one's products run
    float xr, wr[WS];
    auto load = [&](int k0) {
        const int kk = tid % BK, m = tid / BK, n = n0 + m, k = k0 + kk;
        xr = (n < p.N && k < K) ? input_at(p.in, c, a, n, k) : 0.f;
#pragma unroll
        for (int s = 0; s < WS; ++s) {
            const int e = tid + THREADS * s, k = k0 + e / HP, j = e % HP;
            wr[s] = (k < K && j < H) ? __ldg(w + static_cast<size_t>(k) * H + j) : 0.f;
        }
    };
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    load(0);
    for (int k0 = 0; k0 < K; k0 += BK) {
        xs[tid % BK * (BM + 1) + tid / BK] = xr;
#pragma unroll
        for (int s = 0; s < WS; ++s) ws[tid + THREADS * s] = wr[s];
        __syncthreads();
        if (k0 + BK < K) load(k0 + BK);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float xv[TM], wv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) xv[i] = xs[kk * (BM + 1) + ty * TM + i];
#pragma unroll
            for (int j = 0; j < TN; ++j) wv[j] = ws[kk * HP + tx + TC * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        }
        __syncthreads();
    }

    // bias and relu into shared memory, a row of HP a tile row
    float* rs = ws;
    const float* bias = p.b.p[c] + static_cast<size_t>(a) * H;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = tx + TC * j;
            if (col < H) {
                const float z = acc[i][j] + __ldg(bias + col);
                rs[(ty * TM + i) * HP + col] = z < 0.f ? 0.f : z;
            }
        }
    __syncthreads();

    // LayerNorm as SoftQ.forward writes it (biased variance, scale, bias),
    // then the head: a warp a row
    const int warp = tid / 32, lane = tid % 32;
    const float* g = p.g.p[c] + static_cast<size_t>(a) * H;
    const float* beta = p.beta.p[c] + static_cast<size_t>(a) * H;
    const float* hw = p.hw.p[0] ? p.hw.p[c] + static_cast<size_t>(a) * H : nullptr;
    for (int m = warp; m < BM; m += WARPS) {
        const int n = n0 + m;
        if (n >= p.N) continue;             // the same in every lane of the warp
        const float* row = rs + m * HP;
        float s = 0.f;
        for (int col = lane; col < H; col += 32) s += row[col];
        const float mu = warp_sum(s) / H;
        float v = 0.f;
        for (int col = lane; col < H; col += 32) {
            const float d = row[col] - mu;
            v += d * d;
        }
        const float sd = sqrtf(warp_sum(v) / H + LN_EPS);
        const size_t at_row = (static_cast<size_t>(c) * p.A + a) * p.N + n;
        const size_t at = at_row * H;
        float h = 0.f;
        for (int col = lane; col < H; col += 32) {
            const float yv = (row[col] - mu) / sd * __ldg(g + col) + __ldg(beta + col);
            if (p.y) p.y[at + col] = yv;
            if (p.r) p.r[at + col] = row[col];
            if (hw) h += yv * __ldg(hw + col);
        }
        if (p.mean && lane == 0) {
            p.mean[at_row] = mu;
            p.sd[at_row] = sd;
        }
        if (hw) {
            h = warp_sum(h);
            if (lane == 0) p.q.p[c][static_cast<size_t>(a) * p.N + n] = h + __ldg(p.hb.p[c] + a);
        }
    }
}

// --- backward: the row pass ----------------------------------------------

struct Rows {
    int A, N, H, K;             // the layer's width and its input's
    const float* dy;            // (2, A, N, H) the gradient of LayerNorm's output; null on the
                                // last layer, whose is the head's: dq x the head's weights
    Pair dq;                    // (A, N) each: the values' gradients, the last layer
    Pair hw;                    // the head's weights, the last layer
    const float* r;             // saved by the forward
    const float* mean;
    const float* sd;
    Pair g, w;
    float* dy_out;              // (2, A, N, H) the last layer's dy, for the column pass, or null
    float* dz;                  // (2, A, N, H) the product's gradient, for the column pass, or null
    float* dx;                  // (2, A, N, hi - lo) the input's gradient in columns [lo, hi), or null
    int lo, hi;
};

template <int TN>
__global__ void __launch_bounds__(THREADS) rows_layer(Rows p) {
    extern __shared__ __align__(16) float smem[];
    const int c = blockIdx.z, a = blockIdx.y, n0 = blockIdx.x * BM;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int H = p.H, HS = (H + BK - 1) / BK * BK;    // dz's rows padded to whole chunks
    float* zs = smem;                                   // [BM][HS]
    const float* g = p.g.p[c] + static_cast<size_t>(a) * H;
    const bool last = p.dy == nullptr;
    const float* hw = last ? p.hw.p[c] + static_cast<size_t>(a) * H : nullptr;

    // dx's product stages W^T's chunks through registers, the first one's
    // loads in flight during LayerNorm's gradient, each next one's during
    // the products of the one before
    constexpr int KP = TC * TN, WT = BK * KP / THREADS;  // WT: weights a thread stages
    const int KO = p.hi - p.lo;
    const float* w = p.w.p[c] + static_cast<size_t>(a) * p.K * H;
    float wr[WT];
    auto load = [&](int j0) {
#pragma unroll
        for (int s = 0; s < WT; ++s) {
            const int e = tid + THREADS * s, kk = e / BK, j = j0 + e % BK;
            wr[s] = (kk < KO && j < H) ? __ldg(w + static_cast<size_t>(p.lo + kk) * H + j) : 0.f;
        }
    };
    if (p.dx) load(0);

    for (int m = warp; m < BM; m += WARPS) {
        const int n = n0 + m;
        float* zrow = zs + m * HS;
        if (n >= p.N) {
            for (int col = lane; col < HS; col += 32) zrow[col] = 0.f;
            continue;
        }
        const size_t at_row = (static_cast<size_t>(c) * p.A + a) * p.N + n;
        const size_t at = at_row * H;
        const float mu = __ldg(p.mean + at_row), sd = __ldg(p.sd + at_row);
        const float dq = last ? __ldg(p.dq.p[c] + static_cast<size_t>(a) * p.N + n) : 0.f;
        float s1 = 0.f, s2 = 0.f;
        for (int col = lane; col < H; col += 32) {
            const float dy = last ? dq * __ldg(hw + col) : __ldg(p.dy + at + col);
            const float xh = (__ldg(p.r + at + col) - mu) / sd;
            const float dxh = dy * __ldg(g + col);
            s1 += dxh;
            s2 += dxh * xh;
        }
        const float m1 = warp_sum(s1) / H, m2 = warp_sum(s2) / H;
        for (int col = lane; col < HS; col += 32) {
            float dz = 0.f;
            if (col < H) {
                const float dy = last ? dq * __ldg(hw + col) : __ldg(p.dy + at + col);
                const float rv = __ldg(p.r + at + col);
                const float xh = (rv - mu) / sd;
                const float dxh = dy * __ldg(g + col);
                // LayerNorm's gradient, then relu's (none where relu gave 0)
                const float dr = (dxh - m1 - xh * m2) / sd;
                dz = rv <= 0.f ? 0.f : dr;
                if (p.dz) p.dz[at + col] = dz;
                if (p.dy_out) p.dy_out[at + col] = dy;
            }
            zrow[col] = dz;
        }
    }
    if (p.dx == nullptr) return;            // the same for the whole block

    // dx = dz W^T over columns [lo, hi) of the input, the depth H in chunks
    // (the loop's first barrier also publishes zs)
    float* wt = zs + BM * HS;               // [BK][KP + 1]: W^T's chunk
    const int tx = tid % TC, ty = tid / TC;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int j0 = 0; j0 < H; j0 += BK) {
#pragma unroll
        for (int s = 0; s < WT; ++s) {
            const int e = tid + THREADS * s;
            wt[e % BK * (KP + 1) + e / BK] = wr[s];
        }
        __syncthreads();
        if (j0 + BK < H) load(j0 + BK);
#pragma unroll
        for (int jj = 0; jj < BK; ++jj) {
            float zv[TM], wv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) zv[i] = zs[(ty * TM + i) * HS + j0 + jj];
#pragma unroll
            for (int j = 0; j < TN; ++j) wv[j] = wt[jj * (KP + 1) + tx + TC * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(zv[i], wv[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int n = n0 + ty * TM + i;
        if (n >= p.N) continue;
        const size_t at = ((static_cast<size_t>(c) * p.A + a) * p.N + n) * KO;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = tx + TC * j;
            if (col < KO) p.dx[at + col] = acc[i][j];
        }
    }
}

// --- backward: the column pass -------------------------------------------

struct Columns {
    Input in;                   // the layer's input, as the forward read it
    int A, N, H;
    const float* dz;            // (2, A, N, H) from the row pass
    const float* dy;            // (2, A, N, H) LayerNorm output's gradient
    const float* r;             // saved by the forward
    const float* mean;
    const float* sd;
    const float* y;             // (2, A, N, H) the last layer's output, for the head's gradient;
                                // null on the other layers
    Pair dq;                    // the values' gradients, the last layer
    OutPair dw, db, dg, dbeta;  // the layer's gradients: (A, K + M, H), (A, H) x 3
    OutPair dhw, dhb;           // the head's: (A, H, 1), (A, 1), the last layer
};

__global__ void __launch_bounds__(THREADS) columns_layer(Columns p) {
    __shared__ float xs[BK][CT];            // the input's chunk: BK rows x CT columns
    __shared__ float zs[BK][CT];            // dz's chunk
    __shared__ float part[4][4][CT];        // the column sums' partials, four a column
    const int c = blockIdx.z, a = blockIdx.y;
    const int K = p.in.K + p.in.M, H = p.H, tiles_j = (H + CT - 1) / CT;
    const int k0 = blockIdx.x / tiles_j * CT, j0 = blockIdx.x % tiles_j * CT;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const size_t rows = (static_cast<size_t>(c) * p.A + a) * p.N;    // the pair's first row

    // the chunks staged through registers, as the forward's
    constexpr int CS = BK * CT / THREADS;   // elements of each a thread stages
    float xr[CS], zr[CS];
    auto load = [&](int n0) {
#pragma unroll
        for (int s = 0; s < CS; ++s) {
            const int e = tid + THREADS * s, n = n0 + e / CT, cc = e % CT;
            xr[s] = (n < p.N && k0 + cc < K) ? input_at(p.in, c, a, n, k0 + cc) : 0.f;
            zr[s] = (n < p.N && j0 + cc < H) ? __ldg(p.dz + (rows + n) * H + j0 + cc) : 0.f;
        }
    };
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    load(0);
    for (int n0 = 0; n0 < p.N; n0 += BK) {
#pragma unroll
        for (int s = 0; s < CS; ++s) {
            const int e = tid + THREADS * s;
            xs[e / CT][e % CT] = xr[s];
            zs[e / CT][e % CT] = zr[s];
        }
        __syncthreads();
        if (n0 + BK < p.N) load(n0 + BK);
#pragma unroll
        for (int nn = 0; nn < BK; ++nn) {
            float xv[4], zv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[i] = xs[nn][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) zv[j] = zs[nn][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], zv[j], acc[i][j]);
        }
        __syncthreads();
    }
    float* dw = p.dw.p[c] + static_cast<size_t>(a) * K * H;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int k = k0 + ty + 16 * i, col = j0 + tx + 16 * j;
            if (k < K && col < H) dw[static_cast<size_t>(k) * H + col] = acc[i][j];
        }
    if (k0 != 0) return;                    // the same for the whole block

    // the first row of tiles also sums its columns over the N rows: four
    // threads a column, each every fourth row, then the four in order
    const int q = tid / CT, cc = tid % CT, col = j0 + cc;
    const bool head = p.y != nullptr;
    const float* dq = head ? p.dq.p[c] + static_cast<size_t>(a) * p.N : nullptr;
    float s_db = 0.f, s_dbeta = 0.f, s_dg = 0.f, s_dhw = 0.f;
    if (col < H) {
        for (int n = q; n < p.N; n += 4) {
            const size_t at = (rows + n) * H + col;
            const float dy = __ldg(p.dy + at);
            const float xh = (__ldg(p.r + at) - __ldg(p.mean + rows + n)) / __ldg(p.sd + rows + n);
            s_db += __ldg(p.dz + at);
            s_dbeta += dy;
            s_dg += dy * xh;
            if (head) s_dhw += __ldg(p.y + at) * __ldg(dq + n);
        }
    }
    part[0][q][cc] = s_db;
    part[1][q][cc] = s_dbeta;
    part[2][q][cc] = s_dg;
    part[3][q][cc] = s_dhw;
    __syncthreads();
    if (tid < CT && col < H) {
        float sum[4];
        for (int s = 0; s < 4; ++s) sum[s] = ((part[s][0][cc] + part[s][1][cc]) + part[s][2][cc])
                                             + part[s][3][cc];
        const size_t at = static_cast<size_t>(a) * H + col;
        p.db.p[c][at] = sum[0];
        p.dbeta.p[c][at] = sum[1];
        p.dg.p[c][at] = sum[2];
        if (head) p.dhw.p[c][at] = sum[3];
    }
    if (head && j0 == 0 && tid / 32 == WARPS - 1) {
        float s = 0.f;
        for (int n = tid % 32; n < p.N; n += 32) s += __ldg(dq + n);
        s = warp_sum(s);
        if (tid % 32 == 0) p.dhb.p[c][a] = s;
    }
}

int columns_per_thread(int width) {
    return width <= 64 ? 1 : width <= 128 ? 2 : width <= 256 ? 4 : 8;
}

// Dynamic shared memory past 48 KB (the row pass at widths past 256) has
// to be asked for.
template <class Kernel>
cudaError_t fit_shared(Kernel kernel, size_t shared) {
    if (shared <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(shared));
}

template <int TN>
cudaError_t forward(const Forward& p, cudaStream_t stream) {
    const size_t shared = sizeof(float) * BK * (BM + 1 + TC * TN);
    const dim3 grid((p.N + BM - 1) / BM, p.A, 2);
    forward_layer<TN><<<grid, THREADS, shared, stream>>>(p);
    return cudaGetLastError();
}

template <int TN>
cudaError_t rows(const Rows& p, cudaStream_t stream) {
    const int HS = (p.H + BK - 1) / BK * BK;
    const size_t shared = sizeof(float) * (BM * HS + (p.dx ? BK * (TC * TN + 1) : 0));
    const cudaError_t err = fit_shared(rows_layer<TN>, shared);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + BM - 1) / BM, p.A, 2);
    rows_layer<TN><<<grid, THREADS, shared, stream>>>(p);
    return cudaGetLastError();
}

Input input(const float* x, long long sc, long long sa, long long sn, long long sk, int K,
            const float* x2, long long sa2, long long sn2, long long sk2, int M) {
    return Input{x, sc, sa, sn, sk, K, x2, sa2, sn2, sk2, M};
}

}  // namespace

// The wrapper (ops/twin_q.py) checks shapes, widths (1 to MAX_WIDTH) and
// devices; these return a CUDA error code, 0 on success.

extern "C" int twin_q_forward_launch(
        const float* x, long long sc, long long sa, long long sn, long long sk, int K,
        const float* x2, long long sa2, long long sn2, long long sk2, int M,
        int A, int N, int H,
        const float* w0, const float* w1, const float* b0, const float* b1,
        const float* g0, const float* g1, const float* beta0, const float* beta1,
        const float* hw0, const float* hw1, const float* hb0, const float* hb1,
        float* y, float* r, float* mean, float* sd, float* q0, float* q1, void* stream) {
    if (H < 1 || H > MAX_WIDTH) return cudaErrorInvalidValue;
    const Forward p = {input(x, sc, sa, sn, sk, K, x2, sa2, sn2, sk2, M), A, N, H,
                       {{w0, w1}}, {{b0, b1}}, {{g0, g1}}, {{beta0, beta1}},
                       {{hw0, hw1}}, {{hb0, hb1}}, y, r, mean, sd, {{q0, q1}}};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (columns_per_thread(H)) {
        case 1: return forward<1>(p, s);
        case 2: return forward<2>(p, s);
        case 4: return forward<4>(p, s);
        default: return forward<8>(p, s);
    }
}

extern "C" int twin_q_rows_launch(
        int A, int N, int H, int K,
        const float* dy, const float* dq0, const float* dq1, const float* hw0, const float* hw1,
        const float* r, const float* mean, const float* sd,
        const float* g0, const float* g1, const float* w0, const float* w1,
        float* dy_out, float* dz, float* dx, int lo, int hi, void* stream) {
    if (H < 1 || H > MAX_WIDTH || (dx && (hi <= lo || hi - lo > MAX_WIDTH)))
        return cudaErrorInvalidValue;
    const Rows p = {A, N, H, K, dy, {{dq0, dq1}}, {{hw0, hw1}}, r, mean, sd,
                    {{g0, g1}}, {{w0, w1}}, dy_out, dz, dx, lo, hi};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dx ? columns_per_thread(hi - lo) : 1) {
        case 1: return rows<1>(p, s);
        case 2: return rows<2>(p, s);
        case 4: return rows<4>(p, s);
        default: return rows<8>(p, s);
    }
}

extern "C" int twin_q_columns_launch(
        const float* x, long long sc, long long sa, long long sn, long long sk, int K,
        const float* x2, long long sa2, long long sn2, long long sk2, int M,
        int A, int N, int H,
        const float* dz, const float* dy, const float* r, const float* mean, const float* sd,
        const float* y, const float* dq0, const float* dq1,
        float* dw0, float* dw1, float* db0, float* db1, float* dg0, float* dg1,
        float* dbeta0, float* dbeta1, float* dhw0, float* dhw1, float* dhb0, float* dhb1,
        void* stream) {
    if (H < 1 || H > MAX_WIDTH) return cudaErrorInvalidValue;
    const Columns p = {input(x, sc, sa, sn, sk, K, x2, sa2, sn2, sk2, M), A, N, H,
                       dz, dy, r, mean, sd, y, {{dq0, dq1}},
                       {{dw0, dw1}}, {{db0, db1}}, {{dg0, dg1}}, {{dbeta0, dbeta1}},
                       {{dhw0, dhw1}}, {{dhb0, dhb1}}};
    const int tiles = (K + M + CT - 1) / CT * ((H + CT - 1) / CT);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    columns_layer<<<dim3(tiles, A, 2), THREADS, 0, s>>>(p);
    return cudaGetLastError();
}
