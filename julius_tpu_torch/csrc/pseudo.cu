// The pseudo set-states' scores (-iwcd1), for Hopper: each frame row's
// senone scores aggregated over the member senones of every pseudo
// set-state, written beside the senone scores as the extended outprob
// row that pass 1 reads.
//
// Replaces no TPU kernel: the reference leaves this to XLA
// (julius_tpu/ops/gmm.py:129 `aggregate_pseudo`, a gather and
// `segment_max` under `lax.map`), and the port ran the same in ATen
// (an `index_select` of every member into a [c, L] tensor, an atomic
// `scatter_reduce` amax, a `torch.cat`).  It is
// julius_tpu_torch/ops/gmm.py `aggregate_pseudo_plain` for every row r
// of the [N, S] senone scores and every set-state q with members
// m_1..m_n (in member order):
//   max  - max_i x[r, m_i] (-inf for an empty set-state);
//   best - with nbest > 1, the peel-max: round k takes the largest value
//          below round k-1's (every member at or above a round's maximum
//          leaves with it, so exact ties go together), for nbest rounds
//          or until a round's maximum is not above LOG_ZERO / 2; the
//          maxima summed in round order in f32 from 0, over their count
//          (LOG_ZERO if none); nbest <= 1 is max;
//   avg  - the members above LOG_ZERO / 2 summed in member order in f32
//          from 0, over their count (LOG_ZERO if none).
// Each f32 add and the division are one correctly rounded op
// (__fadd_rn, __fdiv_rn) in the plain version's order, and a maximum is
// exact in any order, so every scheme is bit-equal to the plain version
// on the CPU.
//
// Bound: bytes, and the gather behind them.  A row reads its S senone
// scores and writes S + Q' scores: at the 20k configuration (S = 4874,
// Q' = 9126, L = 226,694 members) 73 KB a row, 1.34 GB and 0.40 ms a
// call of 16 x 1107 rows at the card's 3.35 TB/s.  Every row also
// gathers all L members, 4.0e9 words a call, which only shared memory
// serves fast enough: at 32 words a clock an SM that is about 0.5 ms,
// more where random ids meet in one bank.  On an H100 (700 W) the
// kernel takes 1.85 ms there (`max`), 1.40 ms with the ids moved so no
// two lanes of a quarter warp share a bank: the bank conflicts of the
// gather, not the bytes, bound it.
//
// Design, a block a group of 4 G rows (G = 2 while 8 rows fit in shared
// memory, S up to 7263; else G = 1 up to S = 14,527; else the rows stay
// in device memory, the kernel's `SHARED` = false instance):
//   * the block reads its rows once, coalesced, writes their senone
//     columns to the extended rows, and keeps them in shared memory four
//     rows interleaved, so one 16-byte load gives a member's four scores
//     (a quarter warp's eight loads meet in fewer banks than 32 single
//     words would);
//   * the member ids come in a sliced table (ops/pseudo_kernel.py
//     `sliced`): 32 set-states a slice, their member lists side by side,
//     column j of entry e the e-th member of the slice's j-th set-state,
//     -1 past its end, so a warp reads one coalesced 128-byte line an
//     entry (a list a lane would be a line a lane), eight entries in
//     flight, and each id serves all 4 G rows;
//   * each warp takes the next slice from a counter in shared memory
//     (slices differ in width), a lane a set-state, the G x 4 running
//     values in registers: no atomics, no [c, L] intermediate;
//   * the lane writes its set-state's column of the block's rows; one
//     launch a call, whatever the rows.
// The kernel allocates nothing and makes no host call.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (julius_tpu_torch/ops/pseudo_kernel.py loads it with
// ctypes).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define MAX_THREADS 1024
#define SMEM_MAX 232448       // shared memory a block may opt into
#define MAX_DEVICES 64
#define SLICE 32              // set-states a slice: a warp's lanes
#define PREFETCH 8            // member ids a lane loads at once
#define FULL 0xffffffffu

enum Scheme { MAX = 0, BEST = 1, AVG = 2 };

struct Args {
    const float* in;          // [N, S] senone scores
    const int* slices;        // [n_slices + 1] first entry of each slice
    const int* ids;           // [slices[n_slices], SLICE] member ids
    float* out;               // [N, stride]: set-state q at column col + q
    int N, S, Q, n_slices, stride, col, copy, scheme, nbest;
    float log_zero, neg_half;
};

// The four scores of senone `id` in rows r0 + 4 g .. r0 + 4 g + 3 (a
// row past N repeats the last: its results are never written).
template <bool SHARED>
__device__ __forceinline__ float4 fetch(const float4* sm, const Args& a,
                                        int r0, int g, int id) {
    if (SHARED) return sm[g * a.S + id];
    const float* p = a.in + id;
    const int r = r0 + 4 * g, last = a.N - 1;
    return make_float4(__ldg(p + (size_t)min(r, last) * a.S),
                       __ldg(p + (size_t)min(r + 1, last) * a.S),
                       __ldg(p + (size_t)min(r + 2, last) * a.S),
                       __ldg(p + (size_t)min(r + 3, last) * a.S));
}

// f(k, x) for each member id of a lane's column (`col`, `width`
// entries, -1 past its end), in member order, and each row k of the
// block's 4 G with its score x: the ids loaded PREFETCH at a time, so
// their loads are in flight together.
template <int G, bool SHARED, class F>
__device__ __forceinline__ void each_member(const float4* sm, const Args& a,
                                            int r0, const int* col,
                                            int width, F&& f) {
    for (int e = 0; e < width; e += PREFETCH) {
        int id[PREFETCH];
#pragma unroll
        for (int u = 0; u < PREFETCH; ++u)
            id[u] = e + u < width ? __ldg(col + (size_t)(e + u) * SLICE) : -1;
#pragma unroll
        for (int u = 0; u < PREFETCH; ++u) {
            if (id[u] < 0) continue;
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const float4 v = fetch<SHARED>(sm, a, r0, g, id[u]);
                f(4 * g + 0, v.x);
                f(4 * g + 1, v.y);
                f(4 * g + 2, v.z);
                f(4 * g + 3, v.w);
            }
        }
    }
}

template <int G, bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS) pseudo_kernel(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    float4* sm = reinterpret_cast<float4*>(smem);
    const int tid = threadIdx.x, lane = tid & (SLICE - 1), nt = blockDim.x;
    const int S = a.S, r0 = blockIdx.x * 4 * G;
    // the slice counter after the rows (no static shared memory, so the
    // whole SMEM_MAX is the dynamic opt-in)
    int& next = *reinterpret_cast<int*>(
        smem + (SHARED ? (size_t)16 * G * S : 0));

    // the block's rows: senone columns copied out, kept four a float4
    if (SHARED || a.copy) {
        for (int g = 0; g < G; ++g) {
            for (int i = tid; i < S; i += nt) {
                float v[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int r = r0 + 4 * g + k;
                    v[k] = r < a.N ? a.in[(size_t)r * S + i] : 0.0f;
                    if (a.copy && r < a.N)
                        a.out[(size_t)r * a.stride + i] = v[k];
                }
                if (SHARED) sm[g * S + i] = make_float4(v[0], v[1], v[2], v[3]);
            }
        }
    }
    if (tid == 0) next = 0;
    __syncthreads();

    for (;;) {
        int sl = 0;
        if (lane == 0) sl = atomicAdd(&next, 1);
        sl = __shfl_sync(FULL, sl, 0);
        if (sl >= a.n_slices) break;
        const int q = sl * SLICE + lane;
        const int e0 = a.slices[sl], e1 = a.slices[sl + 1];
        const int* col = a.ids + (size_t)e0 * SLICE + lane;
        const int width = e1 - e0;
        float res[4 * G];
        if (a.scheme == AVG) {
            float s[4 * G], c[4 * G];
#pragma unroll
            for (int k = 0; k < 4 * G; ++k) s[k] = c[k] = 0.0f;
            each_member<G, SHARED>(sm, a, r0, col, width, [&](int k, float x) {
                if (x > a.neg_half) {
                    s[k] = __fadd_rn(s[k], x);
                    c[k] = __fadd_rn(c[k], 1.0f);
                }
            });
#pragma unroll
            for (int k = 0; k < 4 * G; ++k)
                res[k] = c[k] > 0.0f ? __fdiv_rn(s[k], c[k]) : a.log_zero;
        } else if (a.scheme == BEST) {
            float prev[4 * G], s[4 * G], c[4 * G];
            bool live[4 * G];
#pragma unroll
            for (int k = 0; k < 4 * G; ++k) {
                prev[k] = s[k] = c[k] = 0.0f;
                live[k] = true;
            }
            for (int round = 0; round < a.nbest; ++round) {
                float m[4 * G];
#pragma unroll
                for (int k = 0; k < 4 * G; ++k) m[k] = -CUDART_INF_F;
                each_member<G, SHARED>(sm, a, r0, col, width,
                                       [&](int k, float x) {
                    if (round == 0 || x < prev[k]) m[k] = fmaxf(m[k], x);
                });
                bool any = false;
#pragma unroll
                for (int k = 0; k < 4 * G; ++k) {
                    if (!live[k]) continue;
                    if (m[k] > a.neg_half) {
                        s[k] = __fadd_rn(s[k], m[k]);
                        c[k] = __fadd_rn(c[k], 1.0f);
                        prev[k] = m[k];
                    } else {
                        // the plain version adds 0 for a round past the
                        // last maximum (it turns a -0 sum into +0)
                        s[k] = __fadd_rn(s[k], 0.0f);
                        live[k] = false;
                    }
                    any |= live[k];
                }
                if (!any) break;
            }
#pragma unroll
            for (int k = 0; k < 4 * G; ++k)
                res[k] = c[k] > 0.0f ? __fdiv_rn(s[k], c[k]) : a.log_zero;
        } else {
#pragma unroll
            for (int k = 0; k < 4 * G; ++k) res[k] = -CUDART_INF_F;
            each_member<G, SHARED>(sm, a, r0, col, width, [&](int k, float x) {
                res[k] = fmaxf(res[k], x);
            });
        }
        if (q < a.Q) {
#pragma unroll
            for (int k = 0; k < 4 * G; ++k) {
                const int r = r0 + k;
                if (r < a.N) a.out[(size_t)r * a.stride + a.col + q] = res[k];
            }
        }
    }
}

// Opt a shared-memory instance into SMEM_MAX bytes of dynamic shared
// memory on the current device, once.
template <int G>
static cudaError_t opt_in() {
    static bool opted[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!opted[dev]) {
        err = cudaFuncSetAttribute(pseudo_kernel<G, true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_MAX);
        if (err != cudaSuccess) return err;
        opted[dev] = true;
    }
    return cudaSuccess;
}

// The pseudo set-states' scores of N rows of S senone scores (see the
// top of this file) into out [N, stride] at columns col .. col + Q - 1,
// the senone columns copied to 0 .. S - 1 first where `copy`, on
// `stream`.  `scheme` 0 max, 1 best of `nbest` (> 1), 2 avg; G groups of
// 4 rows a block, the rows in shared memory (16 G S bytes, and 16 for the
// slice counter) where `shared`.  Returns the CUDA error of the launch, 0
// when it was queued.
extern "C" int pseudo_launch(
    const void* in, const void* slices, const void* ids, void* out, int N,
    int S, int Q, int n_slices, int stride, int col, int copy, int scheme,
    int nbest, float log_zero, float neg_half, int G, int shared,
    int threads, void* stream) {
    if (N < 1 || S < 1 || Q < 1 || n_slices != (Q + SLICE - 1) / SLICE ||
        col < 0 || stride < col + Q || (copy && (col < S || stride < S)) ||
        scheme < MAX || scheme > AVG || (scheme == BEST && nbest < 2) ||
        threads < SLICE || threads > MAX_THREADS || threads % SLICE ||
        !(G == 1 || G == 2) || (!shared && G != 1) ||
        (shared && (size_t)16 * G * S + 16 > SMEM_MAX))
        return (int)cudaErrorInvalidValue;
    const Args a{(const float*)in, (const int*)slices, (const int*)ids,
                 (float*)out,      N,      S,     Q,      n_slices,
                 stride,           col,    copy,  scheme, nbest,
                 log_zero,         neg_half};
    const cudaStream_t s = (cudaStream_t)stream;
    const int rows = 4 * G, grid = (N + rows - 1) / rows;
    const size_t smem = (shared ? (size_t)16 * G * S : 0) + 16;
    cudaError_t err = cudaSuccess;
    if (shared && G == 2) {
        if ((err = opt_in<2>()) != cudaSuccess) return (int)err;
        pseudo_kernel<2, true><<<grid, threads, smem, s>>>(a);
    } else if (shared) {
        if ((err = opt_in<1>()) != cudaSuccess) return (int)err;
        pseudo_kernel<1, true><<<grid, threads, smem, s>>>(a);
    } else {
        pseudo_kernel<1, false><<<grid, threads, smem, s>>>(a);
    }
    return (int)cudaGetLastError();
}
