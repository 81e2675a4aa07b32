// BatchNorm batch statistics for NVIDIA Hopper (sm_90a): per-channel sums
// over the (M, C) row view of a channels_last activation.
//
// Replaces keras_object_detection_tpu/ops/pallas_bn.py:_stats_kernel
// (forward: sum(x), sum(x^2)) and :_grad_stats_kernel (backward: sum(dy),
// sum(dy * xhat) with xhat = (x - mean) * rstd). Sums are float32 from
// bf16 or f32 input.
//
// The TPU kernels walked row blocks in order on one core and accumulated
// into one (2, C) output block. Here the rows are cut into R chunks; block
// (gx, chunk) sums its chunk for one tile of channels. Threads run along C,
// each loading V neighbouring channels of a row in one 16-byte load (V = 8
// for bf16, 4 for f32; 1 where C or the pointer does not allow it), so a
// warp reads whole rows; threadIdx.y strides over the chunk's rows. A block
// reduces its rows in a fixed order into its slot of an (R, 2, C) f32
// scratch buffer (the wrapper allocates it), and a second launch reduces
// the R slots per channel, one warp per (sum, channel), in a fixed order.
// No atomics: the result is the same from run to run, so the comparison
// with the plain version is not blurred by a changing summation order.
//
// What bounds it on this card: bytes. At the flagship step (batch 64,
// 448^2) the 25 BN inputs hold about 13.85 M bf16 values per image, 1.77 GB
// a step: about 0.53 ms at 3.35 TB/s for the statistics, and twice that
// (dy and x) for the gradient statistics. The arithmetic is 2-4 operations
// per byte read, far under the card's ridge. The design reads every input
// byte once in 16-byte coalesced loads and writes only the small partials.

#include <cuda_runtime.h>
#include <stdint.h>

#define KOT_BN_THREADS 256
#define KOT_BN_MAX_CHUNKS 512
#define KOT_BN_MIN_ROWS 64

enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float bf16_to_f32(unsigned short u) {
    return __uint_as_float(((unsigned int)u) << 16);
}

// V consecutive values of type T (float or bf16 bits) as floats
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float* out);

template <>
__device__ __forceinline__ void load_v<float, 4>(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load_v<float, 1>(const float* p, float* out) {
    out[0] = *p;
}
template <>
__device__ __forceinline__ void load_v<unsigned short, 8>(const unsigned short* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned int w[4] = {v.x, v.y, v.z, v.w};
    for (int k = 0; k < 4; ++k) {
        out[2 * k] = bf16_to_f32((unsigned short)(w[k] & 0xffffu));
        out[2 * k + 1] = bf16_to_f32((unsigned short)(w[k] >> 16));
    }
}
template <>
__device__ __forceinline__ void load_v<unsigned short, 1>(const unsigned short* p, float* out) {
    out[0] = bf16_to_f32(*p);
}

// Block (blockIdx.x, blockIdx.y = chunk) -> partials[chunk][2][C].
// GRAD = false: sum(x), sum(x * x). GRAD = true: sum(dy), sum(dy * xhat).
template <typename T, int V, bool GRAD>
__global__ void __launch_bounds__(KOT_BN_THREADS)
bn_partial_kernel(const T* __restrict__ a, const T* __restrict__ x,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  float* __restrict__ partials, long long m, int c,
                  long long chunk_rows) {
    extern __shared__ float smem[];  // [2][TY][TX * V]
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int TX = blockDim.x, TY = blockDim.y;
    const int group = blockIdx.x * TX + tx;
    const int ch0 = group * V;
    const bool live = ch0 < c;
    const long long r0 = (long long)blockIdx.y * chunk_rows;
    const long long r1 = min(m, r0 + chunk_rows);

    float s1[V], s2[V], mu[V], rs[V];
    for (int v = 0; v < V; ++v) {
        s1[v] = 0.0f;
        s2[v] = 0.0f;
        if (GRAD && live) {
            mu[v] = mean[ch0 + v];
            rs[v] = rstd[ch0 + v];
        }
    }
    if (live) {
        for (long long r = r0 + ty; r < r1; r += TY) {
            float av[V];
            load_v<T, V>(a + r * c + ch0, av);
            if (GRAD) {
                float xv[V];
                load_v<T, V>(x + r * c + ch0, xv);
                for (int v = 0; v < V; ++v) {
                    const float xhat = (xv[v] - mu[v]) * rs[v];
                    s1[v] = s1[v] + av[v];
                    s2[v] = s2[v] + av[v] * xhat;
                }
            } else {
                for (int v = 0; v < V; ++v) {
                    s1[v] = s1[v] + av[v];
                    s2[v] = s2[v] + av[v] * av[v];
                }
            }
        }
    }
    const int width = TX * V;
    for (int v = 0; v < V; ++v) {
        smem[(0 * TY + ty) * width + tx * V + v] = s1[v];
        smem[(1 * TY + ty) * width + tx * V + v] = s2[v];
    }
    __syncthreads();
    if (ty == 0 && live) {
        for (int k = 0; k < 2; ++k) {
            for (int v = 0; v < V; ++v) {
                float s = 0.0f;
                for (int y = 0; y < TY; ++y) s = s + smem[(k * TY + y) * width + tx * V + v];
                partials[((long long)blockIdx.y * 2 + k) * c + ch0 + v] = s;
            }
        }
    }
}

// One warp per (k, channel): lane l sums chunks l, l + 32, ... in order,
// then a fixed shuffle tree; out[k][channel].
__global__ void bn_finish_kernel(const float* __restrict__ partials,
                                 float* __restrict__ out, int chunks, int c) {
    const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long warp = gtid / 32;
    const int lane = threadIdx.x & 31;
    if (warp >= 2LL * c) return;  // whole warps leave together
    const int k = (int)(warp / c);
    const int ch = (int)(warp % c);
    float s = 0.0f;
    for (int r = lane; r < chunks; r += 32) s = s + partials[((long long)r * 2 + k) * c + ch];
    for (int off = 16; off > 0; off >>= 1) s = s + __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[(long long)k * c + ch] = s;
}

static long long rows_per_chunk(long long m) {
    long long rows = (m + KOT_BN_MAX_CHUNKS - 1) / KOT_BN_MAX_CHUNKS;
    return rows < KOT_BN_MIN_ROWS ? KOT_BN_MIN_ROWS : rows;
}

extern "C" int kot_bn_chunks(long long m) {
    const long long rows = rows_per_chunk(m);
    return (int)((m + rows - 1) / rows);
}

template <typename T, int V, bool GRAD>
static int launch_partials(const void* a, const void* x, const float* mean,
                           const float* rstd, float* partials, long long m,
                           int c, cudaStream_t stream) {
    const int groups = c / V;
    const int tx = groups < KOT_BN_THREADS ? groups : KOT_BN_THREADS;
    const int ty = KOT_BN_THREADS / tx;
    const long long rows = rows_per_chunk(m);
    const dim3 grid((groups + tx - 1) / tx, (unsigned)((m + rows - 1) / rows));
    const dim3 block(tx, ty);
    const size_t smem = (size_t)2 * ty * tx * V * sizeof(float);
    bn_partial_kernel<T, V, GRAD><<<grid, block, smem, stream>>>(
        (const T*)a, (const T*)x, mean, rstd, partials, m, c, rows);
    return (int)cudaGetLastError();
}

template <bool GRAD>
static int run(const void* a, const void* x, const float* mean, const float* rstd,
               float* partials, float* out, long long m, int c, int dtype,
               void* stream) {
    if (m < 1 || c < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const bool aligned = ((uintptr_t)a % 16 == 0) && (!GRAD || (uintptr_t)x % 16 == 0);
    int e;
    if (dtype == DT_BF16) {
        e = (aligned && c % 8 == 0)
                ? launch_partials<unsigned short, 8, GRAD>(a, x, mean, rstd, partials, m, c, s)
                : launch_partials<unsigned short, 1, GRAD>(a, x, mean, rstd, partials, m, c, s);
    } else if (dtype == DT_F32) {
        e = (aligned && c % 4 == 0)
                ? launch_partials<float, 4, GRAD>(a, x, mean, rstd, partials, m, c, s)
                : launch_partials<float, 1, GRAD>(a, x, mean, rstd, partials, m, c, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return e;
    const long long threads = 2LL * c * 32;
    bn_finish_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
        partials, out, kot_bn_chunks(m), c);
    return (int)cudaGetLastError();
}

// out (2, C) f32 = [sum(x), sum(x^2)] over the (m, c) rows of x.
extern "C" int kot_bn_stats(const void* x, float* partials, float* out,
                            long long m, int c, int dtype, void* stream) {
    return run<false>(x, nullptr, nullptr, nullptr, partials, out, m, c, dtype, stream);
}

// out (2, C) f32 = [sum(dy), sum(dy * (x - mean) * rstd)].
extern "C" int kot_bn_grad_stats(const void* dy, const void* x, const float* mean,
                                 const float* rstd, float* partials, float* out,
                                 long long m, int c, int dtype, void* stream) {
    return run<true>(dy, x, mean, rstd, partials, out, m, c, dtype, stream);
}

extern "C" const char* kot_bn_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
