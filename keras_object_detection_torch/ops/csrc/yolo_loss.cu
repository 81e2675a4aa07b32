// The fused YOLOv1 loss for NVIDIA Hopper (sm_90a): forward (K4) and
// analytic backward (K5).
//
// Replaces keras_object_detection_tpu/ops/pallas_loss.py:_forward_kernel
// (forward) and :_backward_kernel (backward).
//
// In: y_true, y_pred as (N, C + 5B) contiguous f32 rows. Row layout:
//     [class (C)] [conf, x, y, w, h] * B; y_true uses slot 0 only.
// Forward out: 5 f32 [total, box, object, no_object, class].
// Backward out: (N, C + 5B) f32 dL/dy_pred scaled by the cotangent g, which
//     is read from device memory (no host synchronisation for it).
//
// What bounds them on this card. At the flagship step's 3,136 rows x 30
// columns the inputs are 0.75 MB, 0.22 us at the memory rate, and the
// arithmetic (about 150 float32 operations a row) less. Neither bounds a
// launch: latency does. K5: the launch itself, one round trip to memory for
// the rows, one row's chain of dependent IEEE divisions and square roots
// (kept unfused, see below), the write back. K4: the same without the write,
// then three dependent round trips to L2 at its end (a block's fence on its
// partials, its ticket, the last block's read of all partials).
//
// Design, both kernels. A block is one warp and owns a chunk of R = 16 rows
// (KOT_LOSS_ROWS): 3,136 rows make 196 blocks, more than the card's 132
// SMs, so every SM runs a chain at once (R = 32 would leave 34 SMs idle).
// The chunk's rows of t and of p are each one contiguous R (C + 5B) floats;
// the warp copies both into shared memory with 16-byte loads, neighbouring
// lanes on neighbouring addresses, each lane issuing all its loads (up to
// KOT_LOSS_LOADS of each input) before it stores any, so that a chunk costs
// one round trip to memory; lanes 0..R-1 then compute one row each from
// shared memory. The backward assembles its gradient rows in
// shared memory and the warp writes the chunk back with 16-byte stores. B
// is a template parameter (1..8, one instantiation each), so the per-slot
// arrays stay in registers.
//
// Alignment. R is a multiple of 4, so a chunk is a whole number of 16-byte
// pieces for every C + 5B and starts 16-byte aligned whenever the tensor's
// data pointer is. A tensor whose pointer is not (an offset view) is copied
// one float a lane instead, and so is the tail of a ragged last chunk past
// its last whole 16 bytes; the choice is per pointer, inside the kernel, so
// nothing falls back outside it. Shared memory holds 2 chunks (forward) or 3
// (backward, with the gradient); a C + 5B whose plan needs more than the
// card grants one block returns KOT_LOSS_ERR_SMEM, and the wrapper raises.
//
// The forward in one launch, in a fixed summation order: "last block done".
// Each block adds its rows' four terms in a fixed shuffle tree (R -> 1) and
// its chunks in chunk order, stores the 4 partials in its slot of a scratch
// buffer, fences, and draws a ticket from an integer counter with atomicInc,
// which wraps the last ticket back to 0: the counter is 0 again after every
// launch, under CUDA-graph replay too. The block that draws the last ticket
// adds the partials in block order: lane l loads a run of consecutive
// blocks' partials at once and adds them in order, then the 32 run sums go
// through a fixed shuffle tree. A serial sum over
// every block would be the launch's longest dependent chain and gather
// rounding error with the number of blocks; runs and a tree do neither. The
// order depends only on N: two calls give the same 5 floats bit for bit,
// and no float is added atomically. Not a thread block cluster: a cluster
// holds at most 16 CTAs, 16 of the 132 SMs, where this fills the card. The
// grid is capped at KOT_LOSS_MAX_BLOCKS (16,384 rows a pass; blocks loop
// over chunks beyond it), so the scratch buffer has a fixed size: the
// wrapper allocates it and the counter once per device, and one stream at a
// time may use them.
//
// Arithmetic repeats the plain versions in ops/yolo_loss.py operation by
// operation, in f32 literals, built with -fmad=false so nvcc contracts
// nothing into an FMA: per-row terms and gradients are bit-equal to the
// plain torch version on the card; the forward's sums differ from it only
// in summation order. The backward keeps _backward_kernel's tie rules: the
// clip of the intersection side passes gradient only strictly inside (0, 1),
// and a corner tie (true corner == predicted corner) routes the whole
// gradient to the prediction.

#include <cuda_runtime.h>
#include <stdint.h>

#define KOT_LOSS_MAX_B 8
#define KOT_LOSS_ROWS 16
#define KOT_LOSS_THREADS 32
#define KOT_LOSS_MAX_BLOCKS 1024
#define KOT_LOSS_LOADS 4  // 16-byte loads of each input a lane starts before storing any
#define KOT_LOSS_ERR_ARGS (-1)
#define KOT_LOSS_ERR_SMEM (-2)

#define EPS_IOU 1e-6f
#define EPS_SQRT 1e-6f

static_assert(KOT_LOSS_THREADS == 32, "a block is one warp: the sums are warp shuffles");
static_assert(KOT_LOSS_ROWS <= KOT_LOSS_THREADS && (KOT_LOSS_ROWS & (KOT_LOSS_ROWS - 1)) == 0,
              "one lane a row, a power of two for the shuffle tree");
static_assert(KOT_LOSS_ROWS % 4 == 0, "a chunk is whole 16-byte pieces at any width");

#define FULL_MASK 0xffffffffu
#define KOT_STR_(x) #x
#define KOT_STR(x) KOT_STR_(x)

__device__ __forceinline__ float sgn(float v) {
    return (float)(v > 0.0f) - (float)(v < 0.0f);
}

struct IouParts {
    float tx1, ty1, tx2, ty2, px1, py1, px2, py2;
    float iw_raw, ih_raw, iw, ih, inter, uni, iou;
};

__device__ __forceinline__ IouParts iou_parts(const float* tb, const float* pb) {
    IouParts r;
    r.tx1 = (tb[0] - tb[2]) / 2.0f;
    r.ty1 = (tb[1] - tb[3]) / 2.0f;
    r.tx2 = (tb[0] + tb[2]) / 2.0f;
    r.ty2 = (tb[1] + tb[3]) / 2.0f;
    r.px1 = (pb[0] - pb[2]) / 2.0f;
    r.py1 = (pb[1] - pb[3]) / 2.0f;
    r.px2 = (pb[0] + pb[2]) / 2.0f;
    r.py2 = (pb[1] + pb[3]) / 2.0f;
    const float ix1 = fmaxf(r.tx1, r.px1);
    const float iy1 = fmaxf(r.ty1, r.py1);
    const float ix2 = fminf(r.tx2, r.px2);
    const float iy2 = fminf(r.ty2, r.py2);
    r.iw_raw = ix2 - ix1;
    r.ih_raw = iy2 - iy1;
    r.iw = fminf(fmaxf(r.iw_raw, 0.0f), 1.0f);
    r.ih = fminf(fmaxf(r.ih_raw, 0.0f), 1.0f);
    r.inter = r.iw * r.ih;
    const float t_area = fabsf((r.tx2 - r.tx1) * (r.ty2 - r.ty1));
    const float p_area = fabsf((r.px2 - r.px1) * (r.py2 - r.py1));
    r.uni = t_area + p_area - r.inter + EPS_IOU;
    r.iou = r.inter / r.uni;
    return r;
}

// Responsible slot: argmax IoU, strict '>' so ties keep the lower slot. Its
// IoU goes to *best_iou, so the register array is never indexed at run time.
template <int NB>
__device__ __forceinline__ int select_best(const float* ious, float* best_iou) {
    float best = ious[0];
    int idx = 0;
#pragma unroll
    for (int s = 1; s < NB; ++s) {
        if (ious[s] > best) {
            best = ious[s];
            idx = s;
        }
    }
    *best_iou = best;
    return idx;
}

// One row's [box, object, no_object, class] terms.
template <int NB>
__device__ __forceinline__ void row_terms(const float* tr, const float* pr, int nc,
                                          int noobj_all, float terms[4]) {
    const float obj = tr[nc];
    const float noobj = 1.0f - obj;
    const float* tbox = tr + nc + 1;
    float ious[NB];
#pragma unroll
    for (int s = 0; s < NB; ++s) ious[s] = iou_parts(tbox, pr + nc + 5 * s + 1).iou;
    float iou_sel;
    const int best = select_best<NB>(ious, &iou_sel);
    const float conf_sel = pr[nc + 5 * best];
    const float* box_sel = pr + nc + 5 * best + 1;

    const float ex = tbox[0] - box_sel[0];
    const float ey = tbox[1] - box_sel[1];
    const float xy = obj * (ex * ex + ey * ey);
    const float sp0 = sgn(box_sel[2]) * sqrtf(fabsf(box_sel[2]) + EPS_SQRT);
    const float sp1 = sgn(box_sel[3]) * sqrtf(fabsf(box_sel[3]) + EPS_SQRT);
    const float ew = sqrtf(tbox[2]) - sp0;
    const float eh = sqrtf(tbox[3]) - sp1;
    const float wh = obj * (ew * ew + eh * eh);
    const float eo = iou_sel - conf_sel;
    terms[0] = xy + wh;
    terms[1] = obj * (eo * eo);
    if (noobj_all) {
        float sq = 0.0f;
#pragma unroll
        for (int s = 0; s < NB; ++s) {
            const float c = pr[nc + 5 * s];
            sq = sq + c * c;
        }
        terms[2] = noobj * sq;
    } else {
        terms[2] = noobj * (conf_sel * conf_sel);
    }
    float cls = 0.0f;
    for (int k = 0; k < nc; ++k) {
        const float e = tr[k] - pr[k];
        cls = cls + obj * (e * e);
    }
    terms[3] = cls;
}

// One row's gradient into `out`.
template <int NB>
__device__ __forceinline__ void row_grad(const float* tr, const float* pr, float* out,
                                         float g, int nc, float lambda_coord,
                                         float lambda_noobj, int noobj_all) {
    const float obj = tr[nc];
    const float noobj = 1.0f - obj;
    const float* tbox = tr + nc + 1;

    IouParts parts[NB];
    float ious[NB];
#pragma unroll
    for (int s = 0; s < NB; ++s) {
        parts[s] = iou_parts(tbox, pr + nc + 5 * s + 1);
        ious[s] = parts[s].iou;
    }
    float iou_sel;
    const int best = select_best<NB>(ious, &iou_sel);
    const float conf_sel = pr[nc + 5 * best];

    // class term: -2 g obj (t - p)
    for (int k = 0; k < nc; ++k) out[k] = -2.0f * g * obj * (tr[k] - pr[k]);

    const float u = iou_sel - conf_sel;
#pragma unroll
    for (int s = 0; s < NB; ++s) {
        const float sel = s == best ? 1.0f : 0.0f;
        const float conf_s = pr[nc + 5 * s];
        const float* box_s = pr + nc + 5 * s + 1;
        const IouParts& q = parts[s];

        float dconf = sel * (-2.0f * g * obj * u);
        if (noobj_all) {
            dconf = dconf + 2.0f * g * lambda_noobj * noobj * conf_s;
        } else {
            dconf = dconf + sel * (2.0f * g * lambda_noobj * noobj * conf_s);
        }
        out[nc + 5 * s] = dconf;

        const float dx = sel * (-2.0f * g * lambda_coord * obj * (tbox[0] - box_s[0]));
        const float dy = sel * (-2.0f * g * lambda_coord * obj * (tbox[1] - box_s[1]));
        float dwh[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const float pk = box_s[2 + k];
            const float s_p = sgn(pk) * sqrtf(fabsf(pk) + EPS_SQRT);
            const float sk = sgn(pk);
            const float ds = sk * sk / (2.0f * sqrtf(fabsf(pk) + EPS_SQRT));
            const float tgt = sqrtf(tbox[2 + k]);
            dwh[k] = sel * (-2.0f * g * lambda_coord * obj * (tgt - s_p) * ds);
        }

        // IoU chain of the object term
        const float iw_in = (q.iw_raw > 0.0f && q.iw_raw < 1.0f) ? 1.0f : 0.0f;
        const float ih_in = (q.ih_raw > 0.0f && q.ih_raw < 1.0f) ? 1.0f : 0.0f;
        const float g_x1 = q.tx1 <= q.px1 ? 1.0f : 0.0f;
        const float g_y1 = q.ty1 <= q.py1 ? 1.0f : 0.0f;
        const float g_x2 = q.tx2 >= q.px2 ? 1.0f : 0.0f;
        const float g_y2 = q.ty2 >= q.py2 ? 1.0f : 0.0f;
        const float diw_dpx = iw_in * (g_x2 - g_x1) * 0.5f;
        const float diw_dpw = iw_in * (g_x2 + g_x1) * 0.5f;
        const float dih_dpy = ih_in * (g_y2 - g_y1) * 0.5f;
        const float dih_dph = ih_in * (g_y2 + g_y1) * 0.5f;
        const float dI_dpx = q.ih * diw_dpx;
        const float dI_dpw = q.ih * diw_dpw;
        const float dI_dpy = q.iw * dih_dpy;
        const float dI_dph = q.iw * dih_dph;
        const float pw = box_s[2];
        const float ph = box_s[3];
        const float sgn_area = sgn(pw * ph);
        const float dAp_dpw = sgn_area * ph;
        const float dAp_dph = sgn_area * pw;
        const float U = q.uni;
        const float I = q.inter;
        const float scale = 2.0f * g * obj * u * sel / (U * U);
        out[nc + 5 * s + 1] = dx + scale * (dI_dpx * (U + I));
        out[nc + 5 * s + 2] = dy + scale * (dI_dpy * (U + I));
        out[nc + 5 * s + 3] = dwh[0] + scale * (dI_dpw * (U + I) - I * dAp_dpw);
        out[nc + 5 * s + 4] = dwh[1] + scale * (dI_dph * (U + I) - I * dAp_dph);
    }
}

// The warp copies `count` floats of t and of p from device memory into
// shared memory (16-byte aligned): 16-byte loads where both sources are
// 16-byte aligned, KOT_LOSS_LOADS of each a lane started before any is
// stored, so the chunk costs one round trip to memory; then the rest (all of
// it for an unaligned source) one float a lane.
__device__ __forceinline__ void load_chunks(float* ts, const float* __restrict__ t,
                                            float* ps, const float* __restrict__ p,
                                            int count) {
    int done = 0;
    if (((reinterpret_cast<uintptr_t>(t) | reinterpret_cast<uintptr_t>(p)) & 15u) == 0) {
        const int vecs = count >> 2;
        const float4* t4 = reinterpret_cast<const float4*>(t);
        const float4* p4 = reinterpret_cast<const float4*>(p);
        float4* ts4 = reinterpret_cast<float4*>(ts);
        float4* ps4 = reinterpret_cast<float4*>(ps);
        for (int base = threadIdx.x; base < vecs; base += KOT_LOSS_LOADS * KOT_LOSS_THREADS) {
            float4 a[KOT_LOSS_LOADS], b[KOT_LOSS_LOADS];
#pragma unroll
            for (int j = 0; j < KOT_LOSS_LOADS; ++j) {
                const int i = base + j * KOT_LOSS_THREADS;
                if (i < vecs) {
                    a[j] = t4[i];
                    b[j] = p4[i];
                }
            }
#pragma unroll
            for (int j = 0; j < KOT_LOSS_LOADS; ++j) {
                const int i = base + j * KOT_LOSS_THREADS;
                if (i < vecs) {
                    ts4[i] = a[j];
                    ps4[i] = b[j];
                }
            }
        }
        done = vecs << 2;
    }
    for (int i = done + threadIdx.x; i < count; i += KOT_LOSS_THREADS) {
        ts[i] = t[i];
        ps[i] = p[i];
    }
}

// The same from shared memory back to device memory, by `dst`'s alignment.
__device__ __forceinline__ void store_chunk(float* __restrict__ dst, const float* src,
                                            int count) {
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
        const int vecs = count >> 2;
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(dst);
        for (int i = threadIdx.x; i < vecs; i += KOT_LOSS_THREADS) d4[i] = s4[i];
        done = vecs << 2;
    }
    for (int i = done + threadIdx.x; i < count; i += KOT_LOSS_THREADS) dst[i] = src[i];
}

template <int NB>
__global__ void __launch_bounds__(KOT_LOSS_THREADS)
loss_forward_kernel(const float* __restrict__ t, const float* __restrict__ p,
                    float4* partials, unsigned int* tickets, float* __restrict__ out,
                    int n, int nc, int noobj_all, float lambda_coord,
                    float lambda_noobj) {
    extern __shared__ float4 smem[];
    const int d = nc + 5 * NB;
    float* ts = reinterpret_cast<float*>(smem);
    float* ps = ts + KOT_LOSS_ROWS * d;
    const int lane = threadIdx.x;
    const int chunks = (n + KOT_LOSS_ROWS - 1) / KOT_LOSS_ROWS;

    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // box, object, no_object, class
    for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
        const int row0 = chunk * KOT_LOSS_ROWS;
        const int rows = min(KOT_LOSS_ROWS, n - row0);
        const size_t first = (size_t)row0 * d;
        __syncthreads();  // the previous chunk's rows are read
        load_chunks(ts, t + first, ps, p + first, rows * d);
        __syncthreads();
        float terms[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (lane < rows) row_terms<NB>(ts + lane * d, ps + lane * d, nc, noobj_all, terms);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            float v = terms[k];
#pragma unroll
            for (int o = KOT_LOSS_ROWS / 2; o > 0; o >>= 1)
                v = v + __shfl_down_sync(FULL_MASK, v, o);
            acc[k] = acc[k] + v;  // lane 0's is the chunk's sum
        }
    }

    // this block's partials, then a ticket; the last block sums them all
    unsigned int ticket = 0;
    if (lane == 0) {
        partials[blockIdx.x] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        __threadfence();
        ticket = atomicInc(tickets, gridDim.x - 1);  // the last ticket wraps to 0
    }
    ticket = __shfl_sync(FULL_MASK, ticket, 0);
    if (ticket != gridDim.x - 1) return;
    __threadfence();

    const int blocks = gridDim.x;
    const int per = (blocks + KOT_LOSS_THREADS - 1) / KOT_LOSS_THREADS;
    const int b0 = min(lane * per, blocks);
    const int b1 = min(b0 + per, blocks);
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int b = b0; b < b1; b += 2 * KOT_LOSS_LOADS) {
        // the batch's loads all in flight before the first add
        float4 q[2 * KOT_LOSS_LOADS];
#pragma unroll
        for (int j = 0; j < 2 * KOT_LOSS_LOADS; ++j)
            if (b + j < b1) q[j] = __ldcg(partials + b + j);  // L2: other SMs wrote them
#pragma unroll
        for (int j = 0; j < 2 * KOT_LOSS_LOADS; ++j) {
            if (b + j < b1) {
                s[0] = s[0] + q[j].x;
                s[1] = s[1] + q[j].y;
                s[2] = s[2] + q[j].z;
                s[3] = s[3] + q[j].w;
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int o = KOT_LOSS_THREADS / 2; o > 0; o >>= 1)
            s[k] = s[k] + __shfl_down_sync(FULL_MASK, s[k], o);
    }
    if (lane == 0) {
        out[0] = lambda_coord * s[0] + s[1] + lambda_noobj * s[2] + s[3];
        for (int k = 0; k < 4; ++k) out[1 + k] = s[k];
    }
}

template <int NB>
__global__ void __launch_bounds__(KOT_LOSS_THREADS)
loss_backward_kernel(const float* __restrict__ t, const float* __restrict__ p,
                     const float* __restrict__ gptr, float* __restrict__ dp, int n,
                     int nc, float lambda_coord, float lambda_noobj, int noobj_all) {
    extern __shared__ float4 smem[];
    const int d = nc + 5 * NB;
    float* ts = reinterpret_cast<float*>(smem);
    float* ps = ts + KOT_LOSS_ROWS * d;
    float* gs = ps + KOT_LOSS_ROWS * d;
    const int lane = threadIdx.x;
    const int row0 = blockIdx.x * KOT_LOSS_ROWS;
    const int rows = min(KOT_LOSS_ROWS, n - row0);
    const size_t first = (size_t)row0 * d;
    load_chunks(ts, t + first, ps, p + first, rows * d);
    const float g = gptr[0];
    __syncthreads();
    if (lane < rows)
        row_grad<NB>(ts + lane * d, ps + lane * d, gs + lane * d, g, nc, lambda_coord,
                     lambda_noobj, noobj_all);
    __syncthreads();
    store_chunk(dp + first, gs, rows * d);
}

static int chunks_of(int n) { return (n + KOT_LOSS_ROWS - 1) / KOT_LOSS_ROWS; }

static int forward_blocks(int n) {
    const int chunks = chunks_of(n);
    return chunks < KOT_LOSS_MAX_BLOCKS ? chunks : KOT_LOSS_MAX_BLOCKS;
}

// Grants `kernel` `bytes` of dynamic shared memory, beyond the default 48 KB
// where the card allows it; KOT_LOSS_ERR_SMEM where it does not.
template <typename Kernel>
static int fit_shared(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    if (bytes > (size_t)optin) return KOT_LOSS_ERR_SMEM;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

static size_t chunk_bytes(int nc, int nb) {
    return (size_t)KOT_LOSS_ROWS * (size_t)(nc + 5 * nb) * sizeof(float);
}

template <int NB>
static int launch_forward(const float* t, const float* p, float* partials,
                          unsigned int* tickets, float* out, int n, int nc,
                          float lambda_coord, float lambda_noobj, int noobj_all,
                          cudaStream_t stream) {
    const size_t bytes = 2 * chunk_bytes(nc, NB);
    const int fit = fit_shared(loss_forward_kernel<NB>, bytes);
    if (fit) return fit;
    loss_forward_kernel<NB><<<forward_blocks(n), KOT_LOSS_THREADS, bytes, stream>>>(
        t, p, reinterpret_cast<float4*>(partials), tickets, out, n, nc, noobj_all,
        lambda_coord, lambda_noobj);
    return (int)cudaGetLastError();
}

template <int NB>
static int launch_backward(const float* t, const float* p, const float* g, float* dp,
                           int n, int nc, float lambda_coord, float lambda_noobj,
                           int noobj_all, cudaStream_t stream) {
    const size_t bytes = 3 * chunk_bytes(nc, NB);
    const int fit = fit_shared(loss_backward_kernel<NB>, bytes);
    if (fit) return fit;
    loss_backward_kernel<NB><<<chunks_of(n), KOT_LOSS_THREADS, bytes, stream>>>(
        t, p, g, dp, n, nc, lambda_coord, lambda_noobj, noobj_all);
    return (int)cudaGetLastError();
}

typedef int (*ForwardLaunch)(const float*, const float*, float*, unsigned int*, float*,
                             int, int, float, float, int, cudaStream_t);
typedef int (*BackwardLaunch)(const float*, const float*, const float*, float*, int, int,
                              float, float, int, cudaStream_t);

static const ForwardLaunch FORWARD[KOT_LOSS_MAX_B] = {
    launch_forward<1>, launch_forward<2>, launch_forward<3>, launch_forward<4>,
    launch_forward<5>, launch_forward<6>, launch_forward<7>, launch_forward<8>};
static const BackwardLaunch BACKWARD[KOT_LOSS_MAX_B] = {
    launch_backward<1>, launch_backward<2>, launch_backward<3>, launch_backward<4>,
    launch_backward<5>, launch_backward<6>, launch_backward<7>, launch_backward<8>};

extern "C" int kot_loss_max_b(void) { return KOT_LOSS_MAX_B; }

// Blocks one launch runs for n rows (KOT_LOSS_ROWS rows a block).
extern "C" int kot_loss_blocks(int n, int backward) {
    return backward ? chunks_of(n) : forward_blocks(n);
}

// Floats of the forward's scratch buffer (4 partials a block, 16-byte
// aligned); its ticket counter is one int32 that starts at 0.
extern "C" int kot_loss_forward_partials_floats(void) { return 4 * KOT_LOSS_MAX_BLOCKS; }

// One launch on `stream`. Returns 0, a CUDA error, or a negative
// KOT_LOSS_ERR_* code for arguments the kernel does not take.
extern "C" int kot_loss_forward(const float* t, const float* p, float* partials,
                                unsigned int* tickets, float* out, int n, int nc, int nb,
                                float lambda_coord, float lambda_noobj, int noobj_all,
                                void* stream) {
    if (n < 1 || nc < 0 || nb < 1 || nb > KOT_LOSS_MAX_B) return KOT_LOSS_ERR_ARGS;
    return FORWARD[nb - 1](t, p, partials, tickets, out, n, nc, lambda_coord,
                           lambda_noobj, noobj_all, (cudaStream_t)stream);
}

extern "C" int kot_loss_backward(const float* t, const float* p, const float* g,
                                 float* dp, int n, int nc, int nb, float lambda_coord,
                                 float lambda_noobj, int noobj_all, void* stream) {
    if (n < 1 || nc < 0 || nb < 1 || nb > KOT_LOSS_MAX_B) return KOT_LOSS_ERR_ARGS;
    return BACKWARD[nb - 1](t, p, g, dp, n, nc, lambda_coord, lambda_noobj, noobj_all,
                            (cudaStream_t)stream);
}

extern "C" const char* kot_loss_error_string(int code) {
    if (code == KOT_LOSS_ERR_ARGS)
        return "the kernel takes N >= 1, C >= 0, 1 <= B <= " KOT_STR(KOT_LOSS_MAX_B);
    if (code == KOT_LOSS_ERR_SMEM)
        return "C + 5B too wide: the shared-memory plan needs more than a block gets";
    return cudaGetErrorString((cudaError_t)code);
}
