// BatchNorm batch statistics for NVIDIA Hopper (sm_90a): per-channel sums
// over the (M, C) row view of a channels_last activation.
//
// Replaces keras_object_detection_tpu/ops/pallas_bn.py:_stats_kernel
// (forward, K2: sum(x), sum(x^2)) and :_grad_stats_kernel (backward, K3:
// sum(dy), sum(dy * xhat) with xhat = (x - mean) * rstd). Sums are float32
// from bf16 or f32 input.
//
// What bounds it on this card: bytes. At the flagship step (batch 64,
// 448^2) the 25 BN inputs hold about 13.85 M bf16 values per image, 1.77 GB
// a step: about 0.53 ms at 3.35 TB/s for the statistics, and twice that
// (dy and x) for the gradient statistics. The arithmetic is 2-4 operations
// per byte read, far under the card's ridge. The TPU kernels walked row
// blocks in order on one core into one (2, C) block; here the work must be
// spread over 132 SMs with enough loads in flight on each.
//
// The launch plan is ops/bn.py:bn_launch_plan, a plain Python function (the
// CPU tests check it); the kernel takes it as arguments and refuses a plan
// that does not cover its rows and channels. A block is (tx, ty) threads,
// tx * ty <= 256. Threads run along C, each loading V neighbouring channels
// of a row in one 16-byte load (V = 8 for bf16, 4 for f32; 1 where C or a
// pointer does not allow it). A channel tile is tx * V channels: 128 bytes
// of a row (one cache line, tx a power of two, so a warp covers 32 / tx
// whole rows of it), or a whole row of tx <= 32 groups where 128-byte tiles
// would cut a row whose length is no multiple of 64 bytes (144 bf16
// channels) and so make two tiles fetch the 64-byte pieces at their border.
// Wide C is cut into many tiles (blockIdx.x); rows into gy row blocks of
// rows_per_block (blockIdx.y); threadIdx.y strides over a block's rows.
//
// What the design does about the three causes that kept the first version
// (two launches; chunks of at least 64 rows walked by few threads) at
// 60-74 % of the bound and behind the library call at small M:
// 1. Fill. The plan asks for at least 2 blocks per SM wherever M * C / V
//    allows 256 threads a block one row each: at small M it cuts the rows
//    across threadIdx.y and across more row blocks, not serially within a
//    thread, and at large C it cuts the channels into 128-byte tiles. The
//    blocks fit in one wave: __launch_bounds__(256, 3) keeps both kernels
//    at <= 85 registers, 3 resident blocks an SM, against the plan's 2-2.5.
// 2. Bytes in flight. Each thread issues U independent 16-byte row loads
//    into registers before it accumulates any (U = 8 rows for the
//    statistics, 4 rows of dy and of x for the gradient statistics): 8
//    loads, 128 bytes a thread, 64 KB an SM at 2 blocks of 256 threads,
//    against Little's law's ~18 KB. Unrolled register loads and not a TMA
//    ring: the rows a thread needs are 16 bytes at a stride of C, which a
//    bulk copy would fetch one descriptor per row, and registers already
//    hold the loads the law asks for without a producer warp or barriers.
// 3. One launch. A block adds its rows in a fixed order: shuffles within
//    a warp, then one shared-memory row per warp added in warp order (a
//    shared-memory tree over threadIdx.y, tried first, cost more than the
//    loads at small M: its V-strided columns hit the same banks 8 ways).
//    Where one row block covers all M rows of its tile (gy == 1: the 2-D
//    GAP-head input, 64 rows) it writes the sums and there are no partials.
//    Otherwise it writes its partial row to scratch, fences, and draws a
//    ticket from its tile's counter with atomicInc, which wraps the last
//    ticket back to 0 ("last block done", as in yolo_loss.cu): the counters
//    are 0 again after every launch, under CUDA-graph replay too. The last
//    of a tile's row blocks adds the tile's partial rows, lanes of threads
//    over rows in order with 8 float4 loads in flight, then the lanes in
//    order. One counter per tile, so tiles finish on as many SMs at once;
//    the plan keeps a tile's row blocks near 2 * SMs / tiles, so that read
//    is small against the launch. The plan uses counters only where tiles
//    < 2 * SMs, so the wrapper allocates 2 * SMs counters once per device,
//    and one stream at a time may use them. No float atomics: the
//    summation order depends only on the plan, so two calls give the same
//    sums bit for bit. Not a thread block cluster: a cluster holds at most
//    16 CTAs, and the large shapes need hundreds of blocks.
//
// Numerics: float32 accumulation, xhat = (x - mean) * rstd computed as
// written, under -fmad=false (ops/_build.py), so nothing is contracted into
// an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

#define KOT_BN_THREADS 256
#define KOT_BN_MIN_BLOCKS 3  // resident blocks an SM: <= 85 registers a thread
#define KOT_BN_FINAL_LOADS 8  // float4 partial loads a thread of the last block has in flight
#define KOT_BN_ERR_PLAN (-1)
#define KOT_BN_ERR_ARGS (-2)

enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float bf16_to_f32(unsigned int u) {
    return __uint_as_float(u << 16);
}

// V consecutive values of type T (float or bf16 bits): the raw load, then
// its floats, so that a thread's U loads are all issued before any use
template <typename T, int V> struct Vec;

template <> struct Vec<float, 4> {
    typedef float4 raw;
    static __device__ __forceinline__ raw load(const float* p) {
        return *reinterpret_cast<const float4*>(p);
    }
    static __device__ __forceinline__ void unpack(const raw& v, float* out) {
        out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    }
};
template <> struct Vec<float, 1> {
    typedef float raw;
    static __device__ __forceinline__ raw load(const float* p) { return *p; }
    static __device__ __forceinline__ void unpack(const raw& v, float* out) { out[0] = v; }
};
template <> struct Vec<unsigned short, 8> {
    typedef uint4 raw;
    static __device__ __forceinline__ raw load(const unsigned short* p) {
        return *reinterpret_cast<const uint4*>(p);
    }
    static __device__ __forceinline__ void unpack(const raw& v, float* out) {
        const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            out[2 * k] = bf16_to_f32(w[k] & 0xffffu);
            out[2 * k + 1] = bf16_to_f32(w[k] >> 16);
        }
    }
};
template <> struct Vec<unsigned short, 1> {
    typedef unsigned short raw;
    static __device__ __forceinline__ raw load(const unsigned short* p) { return *p; }
    static __device__ __forceinline__ void unpack(const raw& v, float* out) {
        out[0] = bf16_to_f32(v);
    }
};

// Row stride of a partial row: [sum 0: tx*V][sum 1: tx*V], padded to float4
__host__ __device__ __forceinline__ int partial_stride(int tx, int v) {
    return (2 * tx * v + 3) / 4 * 4;
}

// Block (tile, row block) of the plan. GRAD = false: sum(x), sum(x * x)
// into out (2, C); GRAD = true: sum(dy), sum(dy * xhat).
template <typename T, int V, bool GRAD, int U>
__global__ void __launch_bounds__(KOT_BN_THREADS, KOT_BN_MIN_BLOCKS)
bn_stats_kernel(const T* __restrict__ a, const T* __restrict__ x,
                const float* __restrict__ mean, const float* __restrict__ rstd,
                float* __restrict__ partials, unsigned int* __restrict__ tickets,
                float* __restrict__ out, long long m, int c, long long rows_per_block) {
    extern __shared__ float red[];  // [max(nred, lanes)][P]
    __shared__ unsigned int is_last;
    typedef Vec<T, V> L;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int TX = blockDim.x, TY = blockDim.y;
    const int TCH = TX * V;  // channels of a tile
    const int P = partial_stride(TX, V);
    const int tile = blockIdx.x;
    const int ch0 = tile * TCH + tx * V;
    const bool live = ch0 < c;  // c % V == 0: all V channels live or none
    const long long r0 = (long long)blockIdx.y * rows_per_block;
    const long long r1 = min(m, r0 + rows_per_block);

    float s1[V], s2[V], mu[V], rs[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
        s1[v] = 0.0f;
        s2[v] = 0.0f;
        mu[v] = 0.0f;
        rs[v] = 0.0f;
        if (GRAD && live) {
            mu[v] = mean[ch0 + v];
            rs[v] = rstd[ch0 + v];
        }
    }
    if (live) {
        const long long step = (long long)U * TY;
        for (long long r = r0 + ty; r < r1; r += step) {
            // all U rows' loads in flight before the first add
            typename L::raw av[U], xv[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const long long ru = r + (long long)u * TY;
                if (ru < r1) {
                    av[u] = L::load(a + ru * c + ch0);
                    if (GRAD) xv[u] = L::load(x + ru * c + ch0);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (r + (long long)u * TY < r1) {
                    float af[V];
                    L::unpack(av[u], af);
                    if (GRAD) {
                        float xf[V];
                        L::unpack(xv[u], xf);
#pragma unroll
                        for (int v = 0; v < V; ++v) {
                            const float xhat = (xf[v] - mu[v]) * rs[v];
                            s1[v] = s1[v] + af[v];
                            s2[v] = s2[v] + af[v] * xhat;
                        }
                    } else {
#pragma unroll
                        for (int v = 0; v < V; ++v) {
                            s1[v] = s1[v] + af[v];
                            s2[v] = s2[v] + af[v] * af[v];
                        }
                    }
                }
            }
        }
    }

    // the block's rows in a fixed order. Where TX divides 32, a warp spans
    // 32 / TX whole rows of the tile: a shuffle butterfly over the lane bits
    // above tx sums them, and lanes 0..TX-1 store the warp's sums (row
    // `warp` of red). Otherwise (a whole-row tile of TX channel groups) every
    // thread stores its sums (row ty of red), at column (k * V + v) * TX + tx
    // so that neighbouring threads store to neighbouring banks. Then one
    // thread per output column adds red's rows in order.
    const int t = ty * TX + tx;
    const int nthreads = TX * TY;
    const bool warp_rows = 32 % TX == 0;
    int nred;
    if (warp_rows) {
        const int lane = t & 31, warp = t >> 5;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            for (int o = TX; o < 32; o <<= 1) {
                s1[v] = s1[v] + __shfl_xor_sync(0xffffffffu, s1[v], o);
                s2[v] = s2[v] + __shfl_xor_sync(0xffffffffu, s2[v], o);
            }
        }
        if (lane < TX) {
            float* row = red + warp * P;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                row[tx * V + v] = s1[v];
                row[TCH + tx * V + v] = s2[v];
            }
        }
        nred = nthreads / 32;
    } else {
        float* row = red + ty * P;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            row[v * TX + tx] = s1[v];
            row[(V + v) * TX + tx] = s2[v];
        }
        nred = TY;
    }
    __syncthreads();
    // column j = k * TCH + g * V + v of the block's sums (g: the group's
    // threadIdx.x), from red's rows
    auto block_sum = [&](int j) {
        const int k = j / TCH, g = j % TCH / V, v = j % V;
        const int col = warp_rows ? j : (k * V + v) * TX + g;
        float sum = 0.0f;
        for (int r = 0; r < nred; ++r) sum = sum + red[r * P + col];
        return sum;
    };

    if (gridDim.y == 1) {  // the block covers every row: no partials
        for (int j = t; j < 2 * TCH; j += nthreads) {
            const int ch = tile * TCH + j % TCH;
            if (ch < c) out[(long long)(j / TCH) * c + ch] = block_sum(j);
        }
        return;
    }

    // this block's partial row (the padding to a float4 as zeros), then a
    // ticket from the tile's counter
    float* mine = partials + ((long long)tile * gridDim.y + blockIdx.y) * P;
    for (int j = t; j < P; j += nthreads) mine[j] = j < 2 * TCH ? block_sum(j) : 0.0f;
    __threadfence();
    __syncthreads();
    if (tx == 0 && ty == 0)  // the last ticket wraps the counter to 0
        is_last = atomicInc(tickets + tile, gridDim.y - 1) == gridDim.y - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();

    // the last block of the tile: lane l adds rows l, l + lanes, ... in
    // order, float4 columns, KOT_BN_FINAL_LOADS loads in flight; then the
    // lanes in order
    const int c4 = P / 4, lanes = nthreads / c4;
    const int col = t % c4, part = t / c4;
    const int rows = gridDim.y;
    const float4* base = reinterpret_cast<const float4*>(
        partials + (long long)tile * rows * P);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (part < lanes) {
        for (int r = part; r < rows; r += KOT_BN_FINAL_LOADS * lanes) {
            float4 q[KOT_BN_FINAL_LOADS];
#pragma unroll
            for (int j = 0; j < KOT_BN_FINAL_LOADS; ++j)
                if (r + j * lanes < rows)
                    q[j] = __ldcg(base + (long long)(r + j * lanes) * c4 + col);  // L2: other SMs wrote them
#pragma unroll
            for (int j = 0; j < KOT_BN_FINAL_LOADS; ++j) {
                if (r + j * lanes < rows) {
                    acc.x = acc.x + q[j].x;
                    acc.y = acc.y + q[j].y;
                    acc.z = acc.z + q[j].z;
                    acc.w = acc.w + q[j].w;
                }
            }
        }
    }
    __syncthreads();  // red is reused
    if (part < lanes) reinterpret_cast<float4*>(red + part * P)[col] = acc;
    __syncthreads();
    for (int j = t; j < 2 * TCH; j += nthreads) {
        const int ch = tile * TCH + j % TCH;
        float total = 0.0f;
        for (int l = 0; l < lanes; ++l) total = total + red[l * P + j];
        if (ch < c) out[(long long)(j / TCH) * c + ch] = total;
    }
}

template <typename T, int V, bool GRAD>
static int launch(const void* a, const void* x, const float* mean, const float* rstd,
                  float* partials, unsigned int* tickets, float* out, long long m,
                  int c, int tx, int ty, int gx, int gy, long long rows,
                  cudaStream_t stream) {
    const int P = partial_stride(tx, V);
    const int nred = 32 % tx == 0 ? tx * ty / 32 : ty, lanes = tx * ty / (P / 4);
    const size_t smem = (size_t)(nred > lanes ? nred : lanes) * P * sizeof(float);
    bn_stats_kernel<T, V, GRAD, GRAD ? 4 : 8><<<dim3(gx, gy), dim3(tx, ty), smem, stream>>>(
        (const T*)a, (const T*)x, mean, rstd, partials, tickets, out, m, c, rows);
    return (int)cudaGetLastError();
}

// Refuses a plan that does not cover the (m, c) rows exactly: the channel
// tiles cover c with the last one partly, the row blocks cover m likewise.
template <bool GRAD>
static int run(const void* a, const void* x, const float* mean, const float* rstd,
               float* partials, long long n_partials, unsigned int* tickets,
               int n_tickets, float* out, long long m, int c, int dtype, int v, int tx,
               int ty, int gx, int gy, long long rows, void* stream) {
    if (m < 1 || c < 1 || (dtype != DT_F32 && dtype != DT_BF16)) return KOT_BN_ERR_ARGS;
    const int vec = dtype == DT_BF16 ? 8 : 4;
    const bool aligned = ((uintptr_t)a % 16 == 0) && (!GRAD || (uintptr_t)x % 16 == 0);
    if ((v != 1 && v != vec) || (v > 1 && (!aligned || c % v != 0))) return KOT_BN_ERR_PLAN;
    // where tx divides 32, whole warps, each over 32 / tx rows of the tile
    if (tx < 1 || ty < 1 || tx * ty > KOT_BN_THREADS || (32 % tx == 0 && (tx * ty) % 32 != 0)
        || gx < 1 || gy < 1 || gy > 65535 || rows < 1)
        return KOT_BN_ERR_PLAN;
    const long long tch = (long long)tx * v;
    if (gx * tch < c || (gx - 1) * tch >= c) return KOT_BN_ERR_PLAN;
    if (gy * rows < m || (gy - 1) * rows >= m) return KOT_BN_ERR_PLAN;
    // scratch for one partial row a block, and a counter a tile
    if (gy > 1 && (partials == nullptr || tickets == nullptr || gx > n_tickets
                   || n_partials < (long long)gx * gy * partial_stride(tx, v)))
        return KOT_BN_ERR_ARGS;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == DT_BF16) {
        return v == 8 ? launch<unsigned short, 8, GRAD>(a, x, mean, rstd, partials, tickets,
                                                        out, m, c, tx, ty, gx, gy, rows, s)
                      : launch<unsigned short, 1, GRAD>(a, x, mean, rstd, partials, tickets,
                                                        out, m, c, tx, ty, gx, gy, rows, s);
    }
    return v == 4 ? launch<float, 4, GRAD>(a, x, mean, rstd, partials, tickets, out, m, c,
                                           tx, ty, gx, gy, rows, s)
                  : launch<float, 1, GRAD>(a, x, mean, rstd, partials, tickets, out, m, c,
                                           tx, ty, gx, gy, rows, s);
}

// out (2, C) f32 = [sum(x), sum(x^2)] over the (m, c) rows of x.
// The plan is ops/bn.py:bn_launch_plan's; partials holds n_partials floats,
// tickets n_tickets counters at 0.
extern "C" int kot_bn_stats(const void* x, float* partials, long long n_partials,
                            unsigned int* tickets, int n_tickets, float* out,
                            long long m, int c, int dtype, int v, int tx, int ty,
                            int gx, int gy, long long rows, void* stream) {
    return run<false>(x, nullptr, nullptr, nullptr, partials, n_partials, tickets,
                      n_tickets, out, m, c, dtype, v, tx, ty, gx, gy, rows, stream);
}

// out (2, C) f32 = [sum(dy), sum(dy * (x - mean) * rstd)].
extern "C" int kot_bn_grad_stats(const void* dy, const void* x, const float* mean,
                                 const float* rstd, float* partials,
                                 long long n_partials, unsigned int* tickets,
                                 int n_tickets, float* out, long long m, int c,
                                 int dtype, int v, int tx, int ty, int gx, int gy,
                                 long long rows, void* stream) {
    return run<true>(dy, x, mean, rstd, partials, n_partials, tickets, n_tickets, out, m,
                     c, dtype, v, tx, ty, gx, gy, rows, stream);
}

extern "C" const char* kot_bn_error_string(int code) {
    if (code == KOT_BN_ERR_PLAN)
        return "the launch plan does not fit the input (see ops/bn.py:bn_launch_plan)";
    if (code == KOT_BN_ERR_ARGS) return "invalid arguments";
    return cudaGetErrorString((cudaError_t)code);
}
