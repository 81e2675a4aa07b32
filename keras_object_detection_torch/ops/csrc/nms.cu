// Class-aware greedy NMS for NVIDIA Hopper (sm_90a): one thread-block
// cluster per image.
//
// Replaces keras_object_detection_tpu/ops/pallas_nms.py:_nms_kernel. The
// TPU kernel sorted and compacted with one-hot permutation matmuls because
// Mosaic had no scatter; here each row is scattered to its rank and a
// prefix count places the survivors.
//
// In: (B, N, 6) f32 rows [cls, conf, cx, cy, w, h], N <= 1024.
// Out: (B, N, 6) f32 rows, survivors first then the rest, both in stable
//      confidence-descending order; (B, N) bool (uint8 0/1) survivor mask.
//
// What bounds it on this card: latency. An image is at most 24 KB in and
// out and N^2/2 IoUs (0.5 M flops at N = 1024), far below the memory and
// float32 rates; the time is chains of dependent steps inside one image,
// and at N = 512 and 1024 one SM's instruction rate. An image gets
// a cluster of CSIZE CTAs (1 up to N = 64, 2 up to 128, 4 up to 256, else
// 8), so 8 images of 512 rows run on 64 SMs. The phases:
//   1. load: the image's rows into every CTA's shared memory with 16-byte
//      loads, all of a thread's loads in flight before any store; the sort key
//      of each row: descending confidence (0.0 and -0.0 alike), then
//      ascending input index, unique, so ranks by key are exactly
//      torch.sort(stable=True)'s order;
//   2. rank: CTA r counts, for every row i, the keys below key i among its
//      1/CSIZE of the rows (N^2 / CSIZE compares, a few threads a row) and
//      keeps the counts; after one cluster barrier each row's rank is the
//      sum of its counts in every CTA, read through distributed shared
//      memory (one CTA: a block barrier, no cluster barrier at all);
//   3. geometry: each row's corners, area and class go to its rank, in
//      structure-of-arrays form, with its index and its confidence filter;
//   4. mask: mask[i][w] (32-bit words) bit b is set when j = 32w + b > i,
//      same class and iou(i, j) >= thr. A thread takes a (row i, word w)
//      (two threads a word when N <= 128), first compares the classes of
//      its 32 (16) j's, which is cheap, and runs the IoU only on the
//      matches: about 1 pair in 20 with 20 classes. The CTAs of the
//      cluster share the words and store them straight into the leader
//      CTA's shared memory, then meet at the cluster barrier;
//   5. scan (the leader's warp 0): lane t holds alive word t. For word w,
//      lane b loads row 32w + b's diagonal word; a ballot marks the rows
//      that kill something inside the word, and only those walk the
//      dependent chain (an AND, a find-first-set, a shuffle, an AND). Then
//      what the word's survivors suppress in the later words is ORed up
//      with loads that wait on no chain: by one warp OR reduction a later
//      word up to N = 448, else by each later word's lane over a list of
//      the survivors. One shuffle a word;
//   6. compaction: one warp-wide prefix count over the (<= 32) alive words,
//      each row to its place in a shared staging buffer in output order,
//      then coalesced 16-byte stores; the valid bytes in order.
//
// Exactness: the IoU repeats the plain version's operation order
// (keras_object_detection_torch/core/boxes.py): corners (c -+ s) / 2 (here
// (c -+ s) * 0.5f: both are the correctly rounded c -+ s halved, the same
// bits), intersection clipped to [0, 1], |area|, denominator
// (a_i + a_j) - inter + 1e-6. Built with -fmad=false so nvcc does not
// contract a_i + a_j - iw * ih into an FMA. The test fl(inter / den) >= thr
// takes no division on the common path: with r the hardware reciprocal of
// den (rcp.approx, at most one ulp off: |e1| <= 2^-23), q = fl(inter * r)
// is x(1 + e1)(1 + e2) with x = inter / den and |e2| <= 2^-24 whenever q >=
// 2^-99 (den >= 1e-6 always, so r and q are normal there), and fl(x) =
// x(1 + e3) with |e3| <= 2^-24, so |q - fl(x)| < 2^-21.9 |x|. When q and
// fl(x) fall on two sides of thr, |q - thr| <= |q - fl(x)|, which is below
// 2^-21.8 |thr|: q lies inside the band (lo, hi) = thr -+ 2^-18 |thr| (each
// end rounded, off by at most 2^-23 |thr|), and only there is the quotient
// computed exactly with __fdiv_rn. A q below 2^-99 lies below lo, and then
// x < 2^-97 lies below thr too, as long as |thr| >= 2^-60 (r flushed to 0
// means den > 2^126 and x < 2^-126); for a smaller or non-finite thr the
// band is everything. Output rows are copies
// of input rows, so the result is bit-equal to the plain version's.
// Confidences must not be NaN; 0.0 and -0.0 compare equal, as in torch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define KOT_NMS_MAX_N 1024
#define KOT_NMS_MAX_WORDS (KOT_NMS_MAX_N / 32)
#define KOT_NMS_MAX_CLUSTER 8

typedef unsigned long long u64;

static int padded_n(int n) {
    int np = 64;
    while (np < n) np <<= 1;
    return np;
}

static int cluster_size(int n) {
    const int c = padded_n(n) / 64;
    return c < KOT_NMS_MAX_CLUSTER ? c : KOT_NMS_MAX_CLUSTER;
}

// 256 threads for one CTA an image, else 1024: the rank and mask phases
// spread over them
static int block_threads(int n) { return padded_n(n) == 64 ? 256 : 1024; }

static size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// Shared memory of one CTA, in this order: mask (n x words u32), keys (np
// u64), partial rank counts (one i32 a thread), alive words (32 u32), word
// prefix counts and total (48 i32), the scan's list of survivors (32 i32),
// candidate flags (np u8), geometry (6 x np f32, also the output staging
// rows), raw rows (n x 6 f32), input index by rank (np i32).
static size_t smem_bytes(int n) {
    const size_t np = padded_n(n), words = (n + 31) / 32;
    return align16((size_t)n * words * 4) + np * 8 + (size_t)block_threads(n) * 4
           + 128 + 192 + 128 + np + np * 24 + (size_t)n * 24 + np * 4;
}

__device__ __forceinline__ void cluster_arrive_release() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A barrier of the image's CTAs: the cluster's, or the CTA's alone.
template <bool kCluster>
__device__ __forceinline__ void image_sync() {
    if (kCluster) {
        cluster_arrive_release();
        cluster_wait_acquire();
    } else {
        __syncthreads();
    }
}

// fl(inter / den) >= thr, exactly; the division only inside (lo, hi).
__device__ __forceinline__ bool iou_at_least(float inter, float den, float thr,
                                             float lo, float hi) {
    float r;  // 1 / den within one ulp (PTX ISA), flushed to 0 below 2^-126
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(den));
    const float q = inter * r;
    if (q > hi) return true;
    if (q < lo) return false;
    return __fdiv_rn(inter, den) >= thr;
}

// Sort key: descending confidence (0.0 and -0.0 alike), then ascending index.
__device__ __forceinline__ u64 sort_key(float conf, int index) {
    unsigned u = conf == 0.0f ? 0u : __float_as_uint(conf);
    u ^= (u >> 31) ? 0xffffffffu : 0x80000000u;  // ascending float order
    return ((u64)(~u) << 32) | (unsigned)index;
}

// Copy `count` floats from src to dst (either one in global memory) with
// 16-byte accesses on the global side: a scalar head up to its 16-byte
// boundary, vectors, a scalar tail. Every thread has all its loads in flight
// before its first store; count <= 6 * blockDim.x.
template <bool kToGlobal>
__device__ __forceinline__ void copy_rows(const float* __restrict__ src,
                                          float* __restrict__ dst, int count) {
    const float* g = kToGlobal ? dst : src;
    int head = (int)(((16u - ((unsigned)(uintptr_t)g & 15u)) & 15u) >> 2);
    head = head < count ? head : count;
    const int nvec = (count - head) >> 2;
    const int tail = count - head - 4 * nvec;
    const int t = threadIdx.x, nt = blockDim.x;
    float4 v[2];
    float s = 0.0f;
    const bool has_s = t < head + tail;
    const int si = t < head ? t : head + 4 * nvec + (t - head);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int k = t + r * nt;
        if (k < nvec) {
            if (kToGlobal) {
                const float* p = src + head + 4 * k;
                v[r] = make_float4(p[0], p[1], p[2], p[3]);
            } else {
                v[r] = __ldg(reinterpret_cast<const float4*>(src + head) + k);
            }
        }
    }
    if (has_s) s = src[si];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int k = t + r * nt;
        if (k < nvec) {
            if (kToGlobal) {
                reinterpret_cast<float4*>(dst + head)[k] = v[r];
            } else {
                float* p = dst + head + 4 * k;
                p[0] = v[r].x; p[1] = v[r].y; p[2] = v[r].z; p[3] = v[r].w;
            }
        }
    }
    if (has_s) dst[si] = s;
}

// SPAN: the j's one thread tests for a row (32, or 16 for N <= 128, where
// two threads share a word so that more of the CTA works). kCluster: more
// than one CTA an image (N > 64).
template <int SPAN, bool kCluster>
__global__ void __launch_bounds__(1024, 1)
nms_kernel(const float* __restrict__ boxes, float* __restrict__ out_rows,
           uint8_t* __restrict__ out_valid, int n, int np, int csize,
           float iou_thr, float conf_thr) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int t = threadIdx.x, nt = blockDim.x;
    const int words = (n + 31) >> 5;
    unsigned* mask = reinterpret_cast<unsigned*>(smem);       // n * words
    u64* keys = reinterpret_cast<u64*>(smem + ((n * words * 4 + 15) & ~15));  // np
    int* part = reinterpret_cast<int*>(keys + np);            // nt
    unsigned* alive = reinterpret_cast<unsigned*>(part + nt); // 32
    int* pre = reinterpret_cast<int*>(alive + 32);            // 48
    int* list = pre + 48;                                     // 32
    uint8_t* cand = reinterpret_cast<uint8_t*>(list + 32);    // np
    float* geo = reinterpret_cast<float*>(cand + np);         // 6 * np
    float* raw = geo + 6 * np;                                // n * 6
    int* sidx = reinterpret_cast<int*>(raw + 6 * n);          // np
    float* gx0 = geo;
    float* gy0 = geo + np;
    float* gx1 = geo + 2 * np;
    float* gy1 = geo + 3 * np;
    float* garea = geo + 4 * np;
    float* gcls = geo + 5 * np;

    // np, nt and csize are powers of 2: shifts, no integer division
    const int lane = t & 31, warp = t >> 5, warps = nt >> 5;
    const int log_np = __ffs(np) - 1, log_cs = __ffs(csize) - 1;
    const int image = blockIdx.x >> log_cs;
    const int crank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
    const bool leader = crank == 0;
    const size_t base = (size_t)image * n;

    // 1. load, and each row's key straight from its confidence
    const float* in = boxes + base * 6;
    const float conf_t = t < n ? __ldg(in + t * 6 + 1) : 0.0f;
    copy_rows<false>(in, raw, n * 6);
    if (t < n) keys[t] = sort_key(conf_t, t);
    __syncthreads();

    // 2. rank: each thread counts the keys below its row's among its share
    //    of this CTA's share of the rows; the counts of every thread and
    //    CTA of the image are summed after one barrier
    const int parts = nt >> log_np;  // threads a row: 8 at most with a cluster
    {
        const int i = t & (np - 1), p = t >> log_np;
        const int chunk = (n + csize - 1) >> log_cs;
        const int j_lo = crank * chunk, j_hi = min(n, j_lo + chunk);
        const int len = (j_hi - j_lo + parts - 1) >> (__ffs(parts) - 1);
        const int j0 = j_lo + p * len, j1 = min(j_hi, j0 + len);
        int below = 0;
        if (i < n) {
            const u64 ki = keys[i];
            int j = j0;
            for (; j + 4 <= j1; j += 4) {
                below += (keys[j] < ki) + (keys[j + 1] < ki) + (keys[j + 2] < ki)
                         + (keys[j + 3] < ki);
            }
            for (; j < j1; ++j) below += keys[j] < ki;
        }
        part[t] = below;
    }
    __syncthreads();
    int rank_t = 0;  // thread t < np: its row's count in this CTA, then rank
    if (t < np) {
        for (int p = 0; p < parts; ++p) rank_t += part[p * np + t];
    }
    if (kCluster) {
        __syncthreads();  // every part is read before it is overwritten
        if (t < np) part[t] = rank_t;
        image_sync<kCluster>();  // every CTA's counts are in place
        rank_t = 0;
        if (t < n) {
            // all of a thread's remote loads in flight together
#pragma unroll
            for (int r = 0; r < KOT_NMS_MAX_CLUSTER; ++r)
                if (r < csize) rank_t += cg::this_cluster().map_shared_rank(part, r)[t];
        }
    }

    // 3. geometry, index and filter of each row at its rank
    if (t < n) {
        const int s = rank_t;
        const float* r = raw + t * 6;
        const float x0 = (r[2] - r[4]) * 0.5f;
        const float y0 = (r[3] - r[5]) * 0.5f;
        const float x1 = (r[2] + r[4]) * 0.5f;
        const float y1 = (r[3] + r[5]) * 0.5f;
        gx0[s] = x0;
        gy0[s] = y0;
        gx1[s] = x1;
        gy1[s] = y1;
        garea[s] = fabsf((x1 - x0) * (y1 - y0));
        gcls[s] = r[0];
        sidx[s] = t;
        cand[s] = r[1] > conf_thr;
    }
    __syncthreads();

    // 4. suppression words, into the leader's mask
    if (leader && t < np) {
        const unsigned bits = __ballot_sync(0xffffffffu, t < n && cand[t]);
        if (lane == 0) alive[warp] = bits;
    }
    const float thr = iou_thr;
    float lo = thr - fabsf(thr) * 0x1p-18f, hi = thr + fabsf(thr) * 0x1p-18f;
    if (!(fabsf(thr) >= 0x1p-60f && fabsf(thr) <= FLT_MAX)) {
        lo = -INFINITY;
        hi = INFINITY;
    }
    {
        constexpr int S = 32 / SPAN;  // threads a word
        constexpr int R = 32 / S;     // words a warp takes at once
        unsigned* lmask = kCluster ? cg::this_cluster().map_shared_rank(mask, 0) : mask;
        const int tasks = n * words;  // task k: word w = k / n of row k % n
        const int q = lane / R;
        const float inv_n = 1.0f / (float)n;
        for (int k0 = (crank * warps + warp) * R; k0 < tasks; k0 += csize * warps * R) {
            const int k = k0 + (lane & (R - 1));
            // k / n from a float estimate, off by at most one (k < 2^15)
            int w = (int)((float)k * inv_n);
            w -= w * n > k;
            w += (w + 1) * n <= k;
            const int i = k - w * n;
            const bool active = k < tasks && w >= (i >> 5);
            unsigned bits = 0;
            if (active) {
                const int j0 = w * 32 + q * SPAN;
                const float ci = gcls[i];
                unsigned match = 0;
#pragma unroll
                for (int b = 0; b < SPAN; b += 4) {
                    const float4 c = *reinterpret_cast<const float4*>(gcls + j0 + b);
                    match |= ((unsigned)(c.x == ci) << b) | ((unsigned)(c.y == ci) << (b + 1))
                             | ((unsigned)(c.z == ci) << (b + 2))
                             | ((unsigned)(c.w == ci) << (b + 3));
                }
                const int after = i + 1 - j0;  // bits from here are j > i
                if (after > 0) match &= after >= SPAN ? 0u : (~0u << after);
                const int valid = n - j0;      // bits below here are j < n
                if (valid < SPAN) match &= valid <= 0 ? 0u : ((1u << valid) - 1u);
                const float ax0 = gx0[i], ay0 = gy0[i], ax1 = gx1[i], ay1 = gy1[i];
                const float aa = garea[i];
                while (match) {
                    const int b = __ffs(match) - 1;
                    match &= match - 1u;
                    const int j = j0 + b;
                    const float iw = fminf(fmaxf(fminf(ax1, gx1[j]) - fmaxf(ax0, gx0[j]),
                                                 0.0f), 1.0f);
                    const float ih = fminf(fmaxf(fminf(ay1, gy1[j]) - fmaxf(ay0, gy0[j]),
                                                 0.0f), 1.0f);
                    const float inter = iw * ih;
                    const float den = aa + garea[j] - inter + 1e-6f;
                    if (iou_at_least(inter, den, thr, lo, hi)) bits |= 1u << b;
                }
                bits <<= q * SPAN;
            }
#pragma unroll
            for (int off = R; off < 32; off <<= 1)
                bits |= __shfl_xor_sync(0xffffffffu, bits, off);
            if (active && q == 0) lmask[i * words + w] = bits;
        }
    }
    // the leader's mask is whole; the other CTAs' counts are read
    image_sync<kCluster>();
    if (!leader) return;

    // 5. greedy scan on warp 0
    if (warp == 0) {
        unsigned mine = lane < words ? alive[lane] : 0u;
        for (int w = 0; w < words; ++w) {
            unsigned cur = __shfl_sync(0xffffffffu, mine, w);
            if (!cur) continue;
            const int row = w * 32 + lane;
            const unsigned* rowp = mask + row * words;
            const unsigned diag = row < n ? rowp[w] : 0u;
            // rows that kill inside the word; only they walk the chain
            unsigned killers = __ballot_sync(0xffffffffu, (diag & cur) != 0u) & cur;
            for (unsigned k = killers; k; k = cur & killers) {
                const int b = __ffs(k) - 1;
                killers &= ~1u << b;  // b and the rows before it are done
                cur &= ~__shfl_sync(0xffffffffu, diag, b);
            }
            if (lane == w) mine = cur;
            // the word's survivors remove what they suppress in later words,
            // with loads that wait on no chain: up to 14 words (N <= 448), one
            // warp OR reduction a later word over the survivors' lanes; else
            // each later word's lane ORs the survivors' words, their rows
            // read eight at a time from a list. The reduction is the faster
            // at 2 ... 14 words, the list at 16 and 32
            // (tools/nms_phase_split.py times each alone).
            const bool or_fold = words <= 14;
            const bool kept = (cur >> lane) & 1u;
            const int nkept = __popc(cur);
            if (or_fold) {
                for (int u = w + 1; u < words; ++u) {
                    const unsigned acc = __reduce_or_sync(0xffffffffu, kept ? rowp[u] : 0u);
                    if (lane == u) mine &= ~acc;
                }
            } else {
                if (kept) list[__popc(cur & ((1u << lane) - 1u))] = row * words;
                __syncwarp();
                if (lane > w && lane < words) {
                    unsigned acc = 0u;
                    for (int r = 0; r < nkept; r += 8) {
                        const int4 a = *reinterpret_cast<const int4*>(list + r);
                        const int4 b = *reinterpret_cast<const int4*>(list + r + 4);
                        const int at[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
                        for (int e = 0; e < 8; ++e)
                            if (r + e < nkept) acc |= mask[at[e] + lane];
                    }
                    mine &= ~acc;
                }
                __syncwarp();  // the list is rewritten for the next word
            }
        }
        const int count = lane < words ? __popc(mine) : 0;
        int incl = count;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += v;
        }
        if (lane < words) {
            alive[lane] = mine;
            pre[lane] = incl - count;
        }
        if (lane == 31) pre[KOT_NMS_MAX_WORDS] = incl;
    }
    __syncthreads();

    // 6. stable compaction through the staging rows (the geometry's space)
    const int total = pre[KOT_NMS_MAX_WORDS];
    float* staged = geo;
    if (t < n) {
        const unsigned word = alive[t >> 5];
        const int b = t & 31;
        const int before = pre[t >> 5] + __popc(word & ((1u << b) - 1u));
        const int pos = ((word >> b) & 1u) ? before : total + (t - before);
        const float* r = raw + sidx[t] * 6;
        float* o = staged + pos * 6;
#pragma unroll
        for (int c = 0; c < 6; ++c) o[c] = r[c];
        out_valid[base + t] = (uint8_t)(t < total);
    }
    __syncthreads();
    copy_rows<true>(staged, out_rows + base * 6, n * 6);
}

extern "C" int kot_nms_max_n(void) { return KOT_NMS_MAX_N; }

// The launch shape for n rows an image: cluster size (CTAs an image),
// threads a CTA, dynamic shared memory bytes a CTA.
extern "C" int kot_nms_cluster_size(int n) { return cluster_size(n); }
extern "C" int kot_nms_threads(int n) { return block_threads(n); }
extern "C" int kot_nms_smem_bytes(int n) { return (int)smem_bytes(n); }

template <int SPAN, bool kCluster>
static cudaError_t launch(const float* boxes, float* out_rows, uint8_t* out_valid,
                          int batch, int n, float iou_thr, float conf_thr,
                          cudaStream_t stream) {
    // the shared-memory cap is set once per device, to the largest plan
    static bool configured[64];
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (!configured[device]) {
        e = cudaFuncSetAttribute(nms_kernel<SPAN, kCluster>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_bytes(KOT_NMS_MAX_N));
        if (e != cudaSuccess) return e;
        configured[device] = true;
    }
    const int csize = cluster_size(n);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(batch * csize), 1, 1);
    cfg.blockDim = dim3((unsigned)block_threads(n), 1, 1);
    cfg.dynamicSmemBytes = smem_bytes(n);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)csize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, nms_kernel<SPAN, kCluster>, boxes, out_rows, out_valid, n,
                              padded_n(n), csize, iou_thr, conf_thr);
}

// Launches on `stream` and returns the launch's CUDA error (0 on success).
extern "C" int kot_nms(const float* boxes, float* out_rows, uint8_t* out_valid,
                       int batch, int n, float iou_thr, float conf_thr,
                       void* stream) {
    if (batch < 1 || n < 1 || n > KOT_NMS_MAX_N) return (int)cudaErrorInvalidValue;
    const int np = padded_n(n);
    cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t e =
        np == 64    ? launch<16, false>(boxes, out_rows, out_valid, batch, n, iou_thr,
                                        conf_thr, st)
        : np == 128 ? launch<16, true>(boxes, out_rows, out_valid, batch, n, iou_thr,
                                       conf_thr, st)
                    : launch<32, true>(boxes, out_rows, out_valid, batch, n, iou_thr,
                                       conf_thr, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

extern "C" const char* kot_nms_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
