// The optimizer update for NVIDIA Hopper (sm_90a), K6: one launch updates
// every float32 parameter tensor of a step, with optax's arithmetic.
//
// Replaces no TPU kernel. The JAX package's step is one jitted program, in
// which XLA fuses each parameter's optax update (scale_by_adam, scale(-lr),
// apply_updates) into a few fusions. The port's plain version
// (train/optim.py apply_updates_plain) repeats that update one torch
// operation at a time, in a Python loop over the parameters: 17 (adam) to
// 21 (nadam) launches a tensor, about 2,140 a YOLOv1 step (102 tensors) and
// 5,000 a YOLOv3 step (294), most of them a few microseconds of device work
// behind 15-25 of host issue. Traced on an H100, that loop was 48 % of a
// YOLOv1 train step's host time and 40 % of a YOLOv3 step's, and 84 % / 73 %
// of the device's idle fell under it. It also made three 0-dim bias
// corrections a step from host scalars: pageable copies, which wait for the
// stream to drain.
//
// What bounds it on this card: bytes. The Adam family reads p, g, mu and nu
// and writes p, mu and nu once: 28 bytes a value, 1.950 GB for YOLOv1's
// 69.65 M values (0.582 ms at 3.35 TB/s) and 1.726 GB for YOLOv3's 61.65 M
// (0.515 ms). sgd moves 12 bytes a value, sgdw 20. A few operations a byte,
// far under the card's ridge.
//
// Design. The tensors' pointers and lengths travel in the kernel's
// parameters (Table: up to KOT_OPT_MAX_TENSORS tensors in about 22.5 KB of
// the 32,764-byte parameter space that CUDA 12.1 opened), so a launch
// copies no table to the device and waits for nothing. ops/optim_update.py
// optim_launch_plan cuts the tensor list into launches of at most that many
// tensors: one launch for either model. Each tensor is cut into chunks of
// KOT_OPT_CHUNK values, one block a chunk; block b finds its tensor by a
// binary search over the table's chunk_start, the same for every thread of
// the block and read from the parameter bank (__grid_constant__: no copy
// into local memory). Threads stride over the chunk's 16-byte vectors where
// all of the tensor's pointers are 16-byte aligned (a chunk starts on a
// multiple of 4 values), then over the scalar tail; otherwise over scalars.
// Every tensor is taken as its dense storage span: p, g and the moments
// share one layout, which the wrapper checks, so value k of one is value k
// of the others. Each value is loaded once, updated in registers and stored
// once. The bias corrections come by value; the learning rate is read from
// its 0-dim device tensor, so that set_learning_rate needs nothing rebuilt.
//
// Numerics: the plain loop's operations in its order, each one float32
// rounding, with explicit round-to-nearest intrinsics (and -fmad=false,
// ops/_build.py): no FMA contraction and no reciprocal multiply, so the
// kernel equals the loop on the card bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define KOT_OPT_MAX_TENSORS 512  // as OPT_MAX_TENSORS in ops/optim_update.py
#define KOT_OPT_CHUNK 8192       // values a block; a multiple of 4 (OPT_CHUNK)
#define KOT_OPT_THREADS 256
#define KOT_OPT_ERR_PLAN (-1)
#define KOT_OPT_ERR_ARGS (-2)

// as OPT_CODES in ops/optim_update.py
enum { OPT_ADAM = 0, OPT_NADAM = 1, OPT_ADAMW = 2, OPT_SGD = 3, OPT_SGDW = 4 };

struct Table {
    float* p[KOT_OPT_MAX_TENSORS];
    const float* g[KOT_OPT_MAX_TENSORS];
    float* m[KOT_OPT_MAX_TENSORS];  // mu, or sgdw's trace
    float* v[KOT_OPT_MAX_TENSORS];  // nu
    long long n[KOT_OPT_MAX_TENSORS];
    int chunk_start[KOT_OPT_MAX_TENSORS + 1];  // tensor i: blocks [cs[i], cs[i + 1])
    int count;
};

// train/optim.py's float32 hyperparameters and the step's bias corrections
struct Scalars {
    const float* lr;  // the 0-dim learning rate on the device
    float b1, one_minus_b1, b2, one_minus_b2, eps, bc1, bc2, bc1_next, wd, momentum;
};

static_assert(sizeof(Table) + sizeof(Scalars) <= 32764, "kernel parameter space");

template <int OPT>
__device__ __forceinline__ void update(float& p, const float g, float& m, float& v,
                                       const Scalars& s, const float neg_lr) {
    if (OPT == OPT_SGD) {
        p = __fadd_rn(p, __fmul_rn(neg_lr, g));
    } else if (OPT == OPT_SGDW) {
        // trace = (g + wd * p) + momentum * trace; p + (-lr) * trace
        m = __fadd_rn(__fadd_rn(g, __fmul_rn(s.wd, p)), __fmul_rn(s.momentum, m));
        p = __fadd_rn(p, __fmul_rn(neg_lr, m));
    } else {
        m = __fadd_rn(__fmul_rn(s.one_minus_b1, g), __fmul_rn(s.b1, m));
        v = __fadd_rn(__fmul_rn(s.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
        float mu_hat;
        if (OPT == OPT_NADAM)
            mu_hat = __fadd_rn(__fmul_rn(s.b1, __fdiv_rn(m, s.bc1_next)),
                               __fmul_rn(s.one_minus_b1, __fdiv_rn(g, s.bc1)));
        else
            mu_hat = __fdiv_rn(m, s.bc1);
        float u = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
        if (OPT == OPT_ADAMW) u = __fadd_rn(u, __fmul_rn(s.wd, p));
        p = __fadd_rn(p, __fmul_rn(neg_lr, u));
    }
}

template <int OPT>
__global__ void __launch_bounds__(KOT_OPT_THREADS)
optim_update_kernel(const __grid_constant__ Table t, const __grid_constant__ Scalars s) {
    constexpr bool MOMENT = OPT != OPT_SGD, SECOND = OPT <= OPT_ADAMW;
    const int block = blockIdx.x;
    int lo = 0, hi = t.count - 1;  // the last tensor whose first block <= block
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (t.chunk_start[mid] <= block) lo = mid;
        else hi = mid - 1;
    }
    float* __restrict__ p = t.p[lo];
    const float* __restrict__ g = t.g[lo];
    float* __restrict__ m = t.m[lo];
    float* __restrict__ v = t.v[lo];
    const long long start = (long long)(block - t.chunk_start[lo]) * KOT_OPT_CHUNK;
    const long long end = min(start + KOT_OPT_CHUNK, t.n[lo]);
    const float neg_lr = -*s.lr;
    uintptr_t any = (uintptr_t)p | (uintptr_t)g;
    if (MOMENT) any |= (uintptr_t)m;
    if (SECOND) any |= (uintptr_t)v;
    long long tail = start;
    if (any % 16 == 0) {
        tail = start + ((end - start) & ~3LL);
        for (long long j = start + 4LL * threadIdx.x; j < tail; j += 4LL * KOT_OPT_THREADS) {
            float4 pv = *reinterpret_cast<const float4*>(p + j);
            const float4 gv = *reinterpret_cast<const float4*>(g + j);
            float4 mv = MOMENT ? *reinterpret_cast<const float4*>(m + j) : make_float4(0, 0, 0, 0);
            float4 vv = SECOND ? *reinterpret_cast<const float4*>(v + j) : make_float4(0, 0, 0, 0);
            update<OPT>(pv.x, gv.x, mv.x, vv.x, s, neg_lr);
            update<OPT>(pv.y, gv.y, mv.y, vv.y, s, neg_lr);
            update<OPT>(pv.z, gv.z, mv.z, vv.z, s, neg_lr);
            update<OPT>(pv.w, gv.w, mv.w, vv.w, s, neg_lr);
            *reinterpret_cast<float4*>(p + j) = pv;
            if (MOMENT) *reinterpret_cast<float4*>(m + j) = mv;
            if (SECOND) *reinterpret_cast<float4*>(v + j) = vv;
        }
    }
    for (long long j = tail + threadIdx.x; j < end; j += KOT_OPT_THREADS) {
        float pj = p[j], mj = MOMENT ? m[j] : 0.0f, vj = SECOND ? v[j] : 0.0f;
        update<OPT>(pj, g[j], mj, vj, s, neg_lr);
        p[j] = pj;
        if (MOMENT) m[j] = mj;
        if (SECOND) v[j] = vj;
    }
}

template <int OPT>
static int launch(const Table& t, const Scalars& s, cudaStream_t stream) {
    optim_update_kernel<OPT><<<t.chunk_start[t.count], KOT_OPT_THREADS, 0, stream>>>(t, s);
    return (int)cudaGetLastError();
}

// One launch over `count` tensors. ptrs: 4 * count host values, the
// tensors' p, then g, then mu (sgdw: trace; sgd: unused), then nu (adam,
// nadam, adamw; else unused) pointers; n: their lengths; chunk_start:
// count + 1 block offsets, ops/optim_update.py optim_launch_plan's, which
// must give tensor i ceil(n[i] / KOT_OPT_CHUNK) blocks. scalars: b1, 1 - b1,
// b2, 1 - b2, eps, bc1, bc2, bc1_next, weight decay, momentum (float32, host).
extern "C" int kot_optim_update(int opt, const long long* ptrs, const long long* n,
                                const int* chunk_start, int count, const float* lr,
                                const float* scalars, void* stream) {
    if (opt < OPT_ADAM || opt > OPT_SGDW || ptrs == nullptr || n == nullptr
        || chunk_start == nullptr || lr == nullptr || scalars == nullptr)
        return KOT_OPT_ERR_ARGS;
    if (count < 1 || count > KOT_OPT_MAX_TENSORS || chunk_start[0] != 0) return KOT_OPT_ERR_PLAN;
    const bool moment = opt != OPT_SGD, second = opt <= OPT_ADAMW;
    Table t;
    t.count = count;
    t.chunk_start[0] = 0;
    for (int i = 0; i < count; ++i) {
        if (n[i] < 1 || (long long)chunk_start[i + 1] - chunk_start[i]
                            != (n[i] + KOT_OPT_CHUNK - 1) / KOT_OPT_CHUNK)
            return KOT_OPT_ERR_PLAN;
        t.p[i] = (float*)ptrs[i];
        t.g[i] = (const float*)ptrs[count + i];
        t.m[i] = (float*)ptrs[2 * count + i];
        t.v[i] = (float*)ptrs[3 * count + i];
        t.n[i] = n[i];
        t.chunk_start[i + 1] = chunk_start[i + 1];
        if (t.p[i] == nullptr || t.g[i] == nullptr || (moment && t.m[i] == nullptr)
            || (second && t.v[i] == nullptr))
            return KOT_OPT_ERR_ARGS;
    }
    const Scalars s = {lr, scalars[0], scalars[1], scalars[2], scalars[3], scalars[4],
                       scalars[5], scalars[6], scalars[7], scalars[8], scalars[9]};
    cudaStream_t st = (cudaStream_t)stream;
    switch (opt) {
        case OPT_ADAM: return launch<OPT_ADAM>(t, s, st);
        case OPT_NADAM: return launch<OPT_NADAM>(t, s, st);
        case OPT_ADAMW: return launch<OPT_ADAMW>(t, s, st);
        case OPT_SGD: return launch<OPT_SGD>(t, s, st);
        default: return launch<OPT_SGDW>(t, s, st);
    }
}

extern "C" const char* kot_optim_error_string(int code) {
    if (code == KOT_OPT_ERR_PLAN)
        return "the launch plan does not fit the tensors (see ops/optim_update.py:optim_launch_plan)";
    if (code == KOT_OPT_ERR_ARGS) return "invalid arguments";
    return cudaGetErrorString((cudaError_t)code);
}
