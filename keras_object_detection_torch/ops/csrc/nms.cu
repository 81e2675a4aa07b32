// Class-aware greedy NMS for NVIDIA Hopper (sm_90a), one block per image.
//
// Replaces keras_object_detection_tpu/ops/pallas_nms.py:_nms_kernel. The
// TPU kernel sorted and compacted with one-hot permutation matmuls because
// Mosaic had no scatter; here each thread scatters its row to its rank.
//
// In: (B, N, 6) f32 rows [cls, conf, cx, cy, w, h], N <= 1024.
// Out: (B, N, 6) f32 rows, survivors first then the rest, both in stable
//      confidence-descending order; (B, N) bool (uint8 0/1) survivor mask.
//
// Steps, all in shared memory:
//   1. load the image's rows;
//   2. stable rank #{conf_j > conf_i} + #{j < i, conf_j == conf_i}, and
//      scatter each row to sorted[rank];
//   3. an N x ceil(N/64) uint64 bitmask: bit j of row i is set when j > i,
//      same class and iou(i, j) >= thr (N = 1024: 128 KB);
//   4. the greedy scan on one warp: lane w holds alive word w; the next
//      surviving row is found with __ffsll on the broadcast word, so the
//      scan takes one step per survivor, not per row;
//   5. stable prefix-count compaction.
//
// What bounds it on this card: not bytes (about 50 KB in and out at
// B=32, N=49) nor arithmetic (N^2/2 IoUs), but latency: one launch, and the
// scan's chain of dependent shuffle + shared-memory steps, one per survivor.
// The design keeps every intermediate in shared memory (one launch, no
// device-memory round trip between steps) and spends the scan's steps only
// on survivors.
//
// Exactness: the IoU repeats the plain version's operation order
// (keras_object_detection_torch/core/boxes.py): corners (c -+ s) / 2,
// intersection clipped to [0, 1], |area|, union (a_i + a_j) - inter + 1e-6,
// IEEE division. Built with -fmad=false so nvcc does not contract
// a_i + a_j - iw * ih into an FMA, which would move the last bit and flip
// decisions at iou == thr. Output rows are copies of input rows, so the
// result is bit-equal to the plain version's. Confidences must not be NaN.

#include <cuda_runtime.h>
#include <stdint.h>

#define KOT_NMS_MAX_N 1024
#define KOT_NMS_MAX_WORDS (KOT_NMS_MAX_N / 64)

static size_t smem_bytes(int n, int words) {
    return ((size_t)n * words + KOT_NMS_MAX_WORDS) * sizeof(unsigned long long)
           + (size_t)n * 12 * sizeof(float);
}

__global__ void __launch_bounds__(1024)
nms_kernel(const float* __restrict__ boxes, float* __restrict__ out_rows,
           uint8_t* __restrict__ out_valid, int n, int words,
           float iou_thr, float conf_thr) {
    extern __shared__ unsigned long long smem[];
    unsigned long long* mask = smem;                      // n * words
    unsigned long long* alive = mask + (size_t)n * words;  // KOT_NMS_MAX_WORDS
    float* rows = reinterpret_cast<float*>(alive + KOT_NMS_MAX_WORDS);  // n * 6
    float* sorted = rows + n * 6;                                       // n * 6

    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const size_t base = (size_t)blockIdx.x * n;
    const float* in = boxes + base * 6;

    // 1. load
    for (int k = tid; k < n * 6; k += nt) rows[k] = in[k];
    if (tid < KOT_NMS_MAX_WORDS) alive[tid] = 0ULL;
    __syncthreads();

    // 2. stable descending rank and scatter
    for (int i = tid; i < n; i += nt) {
        const float ci = rows[i * 6 + 1];
        int rank = 0;
        for (int j = 0; j < n; ++j) {
            const float cj = rows[j * 6 + 1];
            rank += (cj > ci) || (cj == ci && j < i);
        }
        for (int c = 0; c < 6; ++c) sorted[rank * 6 + c] = rows[i * 6 + c];
    }
    __syncthreads();

    // geometry of the sorted rows, structure of arrays over the input rows
    float* xmin = rows;
    float* ymin = rows + n;
    float* xmax = rows + 2 * n;
    float* ymax = rows + 3 * n;
    float* area = rows + 4 * n;
    float* cls = rows + 5 * n;
    for (int i = tid; i < n; i += nt) {
        const float* r = sorted + i * 6;
        const float x0 = (r[2] - r[4]) / 2.0f;
        const float y0 = (r[3] - r[5]) / 2.0f;
        const float x1 = (r[2] + r[4]) / 2.0f;
        const float y1 = (r[3] + r[5]) / 2.0f;
        xmin[i] = x0;
        ymin[i] = y0;
        xmax[i] = x1;
        ymax[i] = y1;
        area[i] = fabsf((x1 - x0) * (y1 - y0));
        cls[i] = r[0];
        if (r[1] > conf_thr) atomicOr(&alive[i >> 6], 1ULL << (i & 63));
    }
    __syncthreads();

    // 3. suppression bitmask; neighbouring threads take neighbouring rows i
    //    of one word w, so the j operands are read without bank conflicts
    for (int k = tid; k < n * words; k += nt) {
        const int w = k / n;
        const int i = k - w * n;
        const int j0 = max(w * 64, i + 1);
        const int j1 = min(w * 64 + 64, n);
        unsigned long long bits = 0ULL;
        if (j0 < j1) {
            const float ax0 = xmin[i], ay0 = ymin[i], ax1 = xmax[i], ay1 = ymax[i];
            const float aa = area[i], ac = cls[i];
            for (int j = j0; j < j1; ++j) {
                if (cls[j] != ac) continue;
                const float iw = fminf(fmaxf(fminf(ax1, xmax[j]) - fmaxf(ax0, xmin[j]), 0.0f), 1.0f);
                const float ih = fminf(fmaxf(fminf(ay1, ymax[j]) - fmaxf(ay0, ymin[j]), 0.0f), 1.0f);
                const float inter = iw * ih;
                const float iou = inter / (aa + area[j] - inter + 1e-6f);
                if (iou >= iou_thr) bits |= 1ULL << (j - w * 64);
            }
        }
        mask[(size_t)i * words + w] = bits;
    }
    __syncthreads();

    // 4. greedy scan on warp 0, one step per survivor
    if (tid < 32) {
        unsigned long long mine = tid < words ? alive[tid] : 0ULL;
        for (int w = 0; w < words; ++w) {
            unsigned long long cur = __shfl_sync(0xffffffffu, mine, w);
            while (cur) {
                const int b = __ffsll((long long)cur) - 1;
                const int i = w * 64 + b;
                if (tid < words) mine &= ~mask[(size_t)i * words + tid];
                cur = __shfl_sync(0xffffffffu, mine, w);
                cur &= b == 63 ? 0ULL : (~0ULL << (b + 1));
            }
        }
        if (tid < words) alive[tid] = mine;
    }
    __syncthreads();

    // 5. stable compaction: survivors first, then the rest, in sorted order
    int total = 0;
    for (int w = 0; w < words; ++w) total += __popcll(alive[w]);
    for (int i = tid; i < n; i += nt) {
        const int wi = i >> 6;
        const int bi = i & 63;
        int before = 0;
        for (int w = 0; w < wi; ++w) before += __popcll(alive[w]);
        const unsigned long long word = alive[wi];
        before += __popcll(word & ((1ULL << bi) - 1ULL));
        const int keep = (int)((word >> bi) & 1ULL);
        const int pos = keep ? before : total + (i - before);
        float* o = out_rows + (base + pos) * 6;
        for (int c = 0; c < 6; ++c) o[c] = sorted[i * 6 + c];
        out_valid[base + pos] = (uint8_t)keep;
    }
}

extern "C" int kot_nms_max_n(void) { return KOT_NMS_MAX_N; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int kot_nms(const float* boxes, float* out_rows, uint8_t* out_valid,
                       int batch, int n, float iou_thr, float conf_thr,
                       void* stream) {
    if (batch < 1 || n < 1 || n > KOT_NMS_MAX_N) return (int)cudaErrorInvalidValue;
    const int words = (n + 63) / 64;
    const size_t smem = smem_bytes(n, words);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int threads = ((n + 31) / 32) * 32;
    nms_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
        boxes, out_rows, out_valid, n, words, iou_thr, conf_thr);
    return (int)cudaGetLastError();
}

extern "C" const char* kot_nms_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
