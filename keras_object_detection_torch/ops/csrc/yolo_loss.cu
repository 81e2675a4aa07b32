// The fused YOLOv1 loss for NVIDIA Hopper (sm_90a): forward and analytic
// backward, one thread per grid cell (row).
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
// The TPU kernel walked the rows in 512-row blocks on one core and carried
// the 5 sums in SMEM from one grid step to the next. Here blocks run in
// parallel and in no order, so the forward is two launches: each block
// reduces its rows' four terms in a fixed tree order into its own slot of a
// (blocks, 4) scratch buffer that the wrapper allocates, then one block sums
// the slots in block order and forms the weighted total. The sum is the same
// from run to run (no atomics).
//
// What bounds it on this card: at the flagship step's 3,136 rows x 30
// columns the inputs are 0.75 MB, the arithmetic about 150 operations a row,
// so neither bytes nor operations but launch latency: a few microseconds a
// launch against a bytes bound below a microsecond. The design spends one
// thread per row with every intermediate in registers, and two launches for
// the forward, one for the backward.
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

#define KOT_LOSS_MAX_B 8
#define KOT_LOSS_THREADS 256

#define EPS_IOU 1e-6f
#define EPS_SQRT 1e-6f

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

// Responsible slot: argmax IoU, strict '>' so ties keep the lower slot.
__device__ __forceinline__ int select_best(const float* ious, int nb) {
    float best = ious[0];
    int idx = 0;
    for (int s = 1; s < nb; ++s) {
        if (ious[s] > best) {
            best = ious[s];
            idx = s;
        }
    }
    return idx;
}

__global__ void __launch_bounds__(KOT_LOSS_THREADS)
loss_forward_kernel(const float* __restrict__ t, const float* __restrict__ p,
                    float* __restrict__ partials, int n, int nc, int nb,
                    int noobj_all) {
    __shared__ float red[4][KOT_LOSS_THREADS];
    const int tid = threadIdx.x;
    const int row = blockIdx.x * blockDim.x + tid;
    float terms[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // box, object, no_object, class
    if (row < n) {
        const int d = nc + 5 * nb;
        const float* tr = t + (size_t)row * d;
        const float* pr = p + (size_t)row * d;
        const float obj = tr[nc];
        const float noobj = 1.0f - obj;
        const float* tbox = tr + nc + 1;
        float ious[KOT_LOSS_MAX_B];
        for (int s = 0; s < nb; ++s) ious[s] = iou_parts(tbox, pr + nc + 5 * s + 1).iou;
        const int best = select_best(ious, nb);
        const float conf_sel = pr[nc + 5 * best];
        const float iou_sel = ious[best];
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
            for (int s = 0; s < nb; ++s) {
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
    for (int k = 0; k < 4; ++k) red[k][tid] = terms[k];
    __syncthreads();
    for (int stride = KOT_LOSS_THREADS / 2; stride > 0; stride >>= 1) {
        if (tid < stride) {
            for (int k = 0; k < 4; ++k) red[k][tid] = red[k][tid] + red[k][tid + stride];
        }
        __syncthreads();
    }
    if (tid < 4) partials[(size_t)blockIdx.x * 4 + tid] = red[tid][0];
}

// One block: sums the per-block partials in block order, then the total.
__global__ void loss_finish_kernel(const float* __restrict__ partials,
                                   float* __restrict__ out, int blocks,
                                   float lambda_coord, float lambda_noobj) {
    __shared__ float sums[4];
    const int tid = threadIdx.x;
    if (tid < 4) {
        float s = 0.0f;
        for (int b = 0; b < blocks; ++b) s = s + partials[(size_t)b * 4 + tid];
        sums[tid] = s;
    }
    __syncthreads();
    if (tid == 0) {
        out[0] = lambda_coord * sums[0] + sums[1] + lambda_noobj * sums[2] + sums[3];
        for (int k = 0; k < 4; ++k) out[1 + k] = sums[k];
    }
}

__global__ void __launch_bounds__(KOT_LOSS_THREADS)
loss_backward_kernel(const float* __restrict__ t, const float* __restrict__ p,
                     const float* __restrict__ gptr, float* __restrict__ dp,
                     int n, int nc, int nb, float lambda_coord,
                     float lambda_noobj, int noobj_all) {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= n) return;
    const int d = nc + 5 * nb;
    const float* tr = t + (size_t)row * d;
    const float* pr = p + (size_t)row * d;
    float* out = dp + (size_t)row * d;
    const float g = gptr[0];
    const float obj = tr[nc];
    const float noobj = 1.0f - obj;
    const float* tbox = tr + nc + 1;

    IouParts parts[KOT_LOSS_MAX_B];
    float ious[KOT_LOSS_MAX_B];
    for (int s = 0; s < nb; ++s) {
        parts[s] = iou_parts(tbox, pr + nc + 5 * s + 1);
        ious[s] = parts[s].iou;
    }
    const int best = select_best(ious, nb);
    const float conf_sel = pr[nc + 5 * best];
    const float iou_sel = ious[best];

    // class term: -2 g obj (t - p)
    for (int k = 0; k < nc; ++k) out[k] = -2.0f * g * obj * (tr[k] - pr[k]);

    const float u = iou_sel - conf_sel;
    for (int s = 0; s < nb; ++s) {
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

extern "C" int kot_loss_max_b(void) { return KOT_LOSS_MAX_B; }
extern "C" int kot_loss_threads(void) { return KOT_LOSS_THREADS; }

// Launches both forward kernels on `stream`; `partials` holds
// ceil(n / KOT_LOSS_THREADS) * 4 floats. Returns cudaGetLastError().
extern "C" int kot_loss_forward(const float* t, const float* p, float* partials,
                                float* out, int n, int nc, int nb,
                                float lambda_coord, float lambda_noobj,
                                int noobj_all, void* stream) {
    if (n < 1 || nc < 0 || nb < 1 || nb > KOT_LOSS_MAX_B) return (int)cudaErrorInvalidValue;
    const int blocks = (n + KOT_LOSS_THREADS - 1) / KOT_LOSS_THREADS;
    cudaStream_t s = (cudaStream_t)stream;
    loss_forward_kernel<<<blocks, KOT_LOSS_THREADS, 0, s>>>(t, p, partials, n, nc, nb,
                                                           noobj_all);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    loss_finish_kernel<<<1, 32, 0, s>>>(partials, out, blocks, lambda_coord, lambda_noobj);
    return (int)cudaGetLastError();
}

extern "C" int kot_loss_backward(const float* t, const float* p, const float* g,
                                 float* dp, int n, int nc, int nb,
                                 float lambda_coord, float lambda_noobj,
                                 int noobj_all, void* stream) {
    if (n < 1 || nc < 0 || nb < 1 || nb > KOT_LOSS_MAX_B) return (int)cudaErrorInvalidValue;
    const int blocks = (n + KOT_LOSS_THREADS - 1) / KOT_LOSS_THREADS;
    loss_backward_kernel<<<blocks, KOT_LOSS_THREADS, 0, (cudaStream_t)stream>>>(
        t, p, g, dp, n, nc, nb, lambda_coord, lambda_noobj, noobj_all);
    return (int)cudaGetLastError();
}

extern "C" const char* kot_loss_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
