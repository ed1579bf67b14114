// The device A*'s suffix estimate rest[t], for Hopper: the backward DP
// over the pass-1 trellis of every utterance of a batch, one block an
// utterance.
//
// Replaces no TPU kernel: the reference computes this estimate on the
// host too (a numpy loop over frames), and so did the port until this
// kernel.  It is julius_tpu_torch/search/pass2_device.py
// `_suffix_estimate_np` on the inputs `prepare` gives it, for each row b
// of the [B, T, M] trellis (word, score, lm, prev, begin) and its first
// Tb = n_frames[b] frames (Tb = 0: the row is skipped):
//   1. each atom slot a with word >= 0 (the others take inc = -inf):
//        inc[a] = ((score[a] - score[prev[a]]) - lm[a]) + lm[a] * ratio
//      in f64, the predecessor's score 0 where prev < 0;
//   2. cfm[t] and cfm0[t], t = 0..Tb: 0, then the f32 running sums of
//      fmax[b, :Tb] and of min(fmax, 0), widened to f64 (zeros without
//      fmax);
//   3. rest[Tb - 1] = 0 and, for t < Tb - 1, the largest
//        ((cfm0[bc] - cfm0[t + 1]) + inc[a]) + rest[e]   (bc >= t + 1)
//        ((cfm[bc] - cfm[t + 1]) + inc[a]) + rest[e]     (bc < t + 1)
//      over the atoms a of rows e > t whose begin lies in
//      [t + 1 - lr, t + 1 + lr] (bc: the begin clamped to [0, Tb]),
//      -inf where none does; rest[t] = -inf for t >= Tb.
// Every f64 operation is one correctly rounded op in numpy's order
// (__dadd_rn and friends: nvcc would contract a * b + c into an FMA), the
// two running sums are sequential f32 adds in one thread as numpy's
// cumsum adds them (a parallel scan rounds differently), and a maximum is
// exact in any order, so rest is bit-equal to `_suffix_estimate_np` and
// to ops/suffix_kernel.py `suffix_plain`.
//
// Bound: latency.  The inputs are 20 bytes an atom slot and 4 a frame
// (at B = 16, T = 1560, M = 32 about 16 MB, 5 us at the card's memory
// rate) and the maxima a few hundred operations a frame; what an
// utterance costs is its chain of Tb dependent frames: rest[e] is final
// only once every row after e has pushed into it.
//
// Design, a block an utterance (at most 64 in every path, so every block
// runs at once):
//   * step 1 is flat over the Tb * M slots (all warps but the first,
//     four slots a thread in flight, the predecessor's score gathered),
//     written to an [B, T, M] f64 scratch; the same pass takes each
//     row's lowest target lo[e] = min (begin - 1 - lr) over its atoms by
//     a shared-memory atomicMin; thread 0 meanwhile runs both running
//     sums;
//   * the chain walks e = Tb - 1 down to 1 in push form: rest[e] is final
//     at e (acc[e], the largest value pushed into it so far), and row e's
//     atoms push into acc[t] for t in [max(lo[e], 0), e - 1].  The
//     pushes of one row are gathered target-major: G lanes a target, each
//     taking every G-th atom of the row (G = the power of two >= M / 8,
//     so a lane weighs at most 8 atoms: M = 32, G = 4, 256 targets a
//     pass of 1024 threads), combined by shuffles, and one lane writes
//     acc[t], which no other lane of the frame writes: no atomics.  Row
//     e waits in shared memory as the chain reads it (each atom's two
//     running sums at its begin, its increment and its window of
//     targets, so a lane's atoms are independent loads and adds); its
//     inc and begin were loaded from the scratch two frames ahead and
//     staged at the end of the frame before; one barrier a frame;
//   * acc, cfm, cfm0 and lo live in shared memory (28 bytes a frame, so
//     up to about 8000 frames) or, for a longer row, in a global scratch
//     (the kernel's `SHARED` instance).
// The kernel allocates nothing and makes no host call.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (julius_tpu_torch/ops/suffix_kernel.py loads it with
// ctypes).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>
#include <stdint.h>

#define MAX_THREADS 1024
#define SMEM_MAX 232448       // shared memory a block may opt into
#define MAX_DEVICES 64
#define SLOTS 4               // atom slots a thread loads at once in step 1
#define FULL 0xffffffffu

struct Args {
    const int* word;          // [B, T, M] trellis
    const float* score;
    const float* lm;
    const int* prev;
    const int* begin;
    const int* n_frames;      // [B]
    const float* fmax;        // [B, T], or null: no slack charge
    int T, M, lr, G;
    double ratio;
    double* inc;              // [B, T, M] scratch
    double* sums;             // [B, 3 T + 2] scratch (global instance)
    int* lows;                // [B, T] scratch (global instance)
    double* rest;             // [B, T] out
};

// Row e's atoms as the chain reads them, staged in shared memory: the
// two running sums at the atom's clamped begin (x = cfm, y = cfm0), its
// increment, and its window [lo, hi] of targets with the clamped begin
// (an empty window for a slot without a word).
__device__ __forceinline__ void stage(double2* sx, double* si, int4* sw,
                                      int m, double inc, int bgn, int Tb,
                                      int lr, const double* cfm,
                                      const double* cfm0) {
    const bool ok = inc != -CUDART_INF;
    const int bc = min(max(bgn, 0), Tb);
    sx[m] = make_double2(ok ? cfm[bc] : 0.0, ok ? cfm0[bc] : 0.0);
    si[m] = inc;
    sw[m] = make_int4(ok ? bgn - 1 - lr : INT_MAX, ok ? bgn - 1 + lr : INT_MIN,
                      bc, 0);
}

template <bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS) suffix_kernel(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int T = a.T, M = a.M, lr = a.lr, G = a.G;
    const int Tb = a.n_frames[b];
    const double NINF = -CUDART_INF;
    double* out = a.rest + (size_t)b * T;
    if (Tb <= 0) {
        for (int t = tid; t < T; t += nt) out[t] = NINF;
        return;
    }
    // shared: two staged rows, then (SHARED) acc, cfm, cfm0, lo
    double2* st_x = reinterpret_cast<double2*>(smem);        // [2][M]
    double* st_inc = reinterpret_cast<double*>(st_x + 2 * M);   // [2][M]
    int4* st_win = reinterpret_cast<int4*>(st_inc + 2 * M);     // [2][M]
    double* acc;                                             // [Tb]
    double* cfm;                                             // [Tb + 1]
    double* cfm0;                                            // [Tb + 1]
    int* lo;                                                 // [Tb]
    if constexpr (SHARED) {
        acc = reinterpret_cast<double*>(st_win + 2 * M);
        cfm = acc + T;
        cfm0 = cfm + T + 1;
        lo = reinterpret_cast<int*>(cfm0 + T + 1);
    } else {
        acc = a.sums + (size_t)b * (3 * T + 2);
        cfm = acc + T;
        cfm0 = cfm + T + 1;
        lo = a.lows + (size_t)b * T;
    }
    const size_t row0 = (size_t)b * T * M;
    const int* wd = a.word + row0;
    const float* sc = a.score + row0;
    const float* lmv = a.lm + row0;
    const int* pv = a.prev + row0;
    const int* bg = a.begin + row0;
    double* inc = a.inc + row0;

    for (int t = tid; t < Tb; t += nt) {
        acc[t] = NINF;
        lo[t] = INT_MAX;
    }
    __syncthreads();

    // ---- the running sums (2. above), one thread
    if (tid == 0) {
        cfm[0] = 0.0;
        cfm0[0] = 0.0;
        if (a.fmax != nullptr) {
            const float* f = a.fmax + (size_t)b * T;
            float s = 0.0f, s0 = 0.0f;
#pragma unroll 8
            for (int t = 0; t < Tb; ++t) {
                const float x = f[t];
                const float x0 = x < 0.0f ? x : 0.0f;
                s = t ? __fadd_rn(s, x) : x;
                s0 = t ? __fadd_rn(s0, x0) : x0;
                cfm[t + 1] = (double)s;
                cfm0[t + 1] = (double)s0;
            }
        } else {
            for (int t = 1; t <= Tb; ++t) {
                cfm[t] = 0.0;
                cfm0[t] = 0.0;
            }
        }
    }
    // ---- per-atom terms (1. above) and each row's lowest target, warps 1..
    if (tid >= 32) {
        const int n = Tb * M, stride = nt - 32;
        for (int i0 = tid - 32; i0 < n; i0 += SLOTS * stride) {
            int w[SLOTS], p[SLOTS], bgn[SLOTS];
            float s[SLOTS], l[SLOTS], ps[SLOTS];
#pragma unroll
            for (int k = 0; k < SLOTS; ++k) {
                const int i = i0 + k * stride;
                const bool ok = i < n;
                w[k] = ok ? wd[i] : -1;
                p[k] = ok ? pv[i] : -1;
                s[k] = ok ? sc[i] : 0.0f;
                l[k] = ok ? lmv[i] : 0.0f;
                bgn[k] = ok ? bg[i] : 0;
            }
#pragma unroll
            for (int k = 0; k < SLOTS; ++k)
                ps[k] = (w[k] >= 0 && p[k] >= 0) ? sc[p[k]] : 0.0f;
#pragma unroll
            for (int k = 0; k < SLOTS; ++k) {
                const int i = i0 + k * stride;
                if (i >= n) break;
                double v = NINF;
                if (w[k] >= 0) {
                    const double asc = (double)s[k], alm = (double)l[k];
                    v = __dadd_rn(__dsub_rn(__dsub_rn(asc, (double)ps[k]),
                                            alm),
                                  __dmul_rn(alm, a.ratio));
                    atomicMin(&lo[i / M], bgn[k] - 1 - lr);
                }
                inc[i] = v;
            }
        }
    }
    __syncthreads();

    // ---- the chain (3. above), one barrier a frame.  Row e is staged in
    // buffer `buf`; row e - 1 waits in registers (loaded a frame earlier)
    // and is staged at the end of frame e, as row e - 2's loads start.
    double nx_inc = NINF;
    int nx_beg = 0;
    if (tid < M) {
        stage(st_x, st_inc, st_win, tid, inc[(size_t)(Tb - 1) * M + tid],
              bg[(size_t)(Tb - 1) * M + tid], Tb, lr, cfm, cfm0);
        if (Tb >= 2) {
            nx_inc = inc[(size_t)(Tb - 2) * M + tid];
            nx_beg = bg[(size_t)(Tb - 2) * M + tid];
        }
    }
    __syncthreads();
    const int per_pass = nt / G;          // targets a pass
    const int g = tid % G, tl = tid / G;
    const int warp_tl = (tid & ~31) / G;  // the warp's first target
    int buf = 0;
    for (int e = Tb - 1; e >= 1; --e) {
        double far_inc = NINF;
        int far_beg = 0;
        if (tid < M && e >= 2) {          // row e - 2, two frames ahead
            far_inc = inc[(size_t)(e - 2) * M + tid];
            far_beg = bg[(size_t)(e - 2) * M + tid];
        }
        const double r = e == Tb - 1 ? 0.0 : acc[e];
        if (r != NINF) {
            const double2* sx = st_x + buf * M;
            const double* si = st_inc + buf * M;
            const int4* sw = st_win + buf * M;
            const int first = max(lo[e], 0);
            for (int base = first; base <= e - 1; base += per_pass) {
                if (base + warp_tl > e - 1) break;    // the whole warp
                const int t = min(base + tl, e - 1);
                const double c1 = cfm[t + 1], c01 = cfm0[t + 1];
                double best = NINF;
#pragma unroll 4
                for (int m = g; m < M; m += G) {
                    const int4 w = sw[m];
                    if (t < w.x || t > w.y) continue;
                    const double2 x = sx[m];
                    const bool gap = w.z >= t + 1;
                    const double adj = __dsub_rn(gap ? x.y : x.x,
                                                 gap ? c01 : c1);
                    const double v = __dadd_rn(__dadd_rn(adj, si[m]), r);
                    best = v > best ? v : best;
                }
                for (int off = G >> 1; off > 0; off >>= 1) {
                    const double o = __shfl_xor_sync(FULL, best, off);
                    best = o > best ? o : best;
                }
                if (g == 0 && base + tl <= e - 1 && best > acc[t])
                    acc[t] = best;
            }
        }
        buf ^= 1;
        if (tid < M) {
            stage(st_x + buf * M, st_inc + buf * M, st_win + buf * M, tid,
                  nx_inc, nx_beg, Tb, lr, cfm, cfm0);
            nx_inc = far_inc;
            nx_beg = far_beg;
        }
        __syncthreads();
    }

    for (int t = tid; t < T; t += nt)
        out[t] = t < Tb - 1 ? acc[t] : (t == Tb - 1 ? 0.0 : NINF);
}

// Opt the shared instance into SMEM_MAX bytes of dynamic shared memory
// on the current device, once.
static cudaError_t opt_in() {
    static bool opted[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!opted[dev]) {
        err = cudaFuncSetAttribute(suffix_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_MAX);
        if (err != cudaSuccess) return err;
        opted[dev] = true;
    }
    return cudaSuccess;
}

// rest [B, T] f64 of the trellis rows (see the top of this file), on
// `stream`.  `in_shared` picks the instance whose frame arrays live in
// shared memory (`smem` bytes: 80 M + 28 T + 16, ops/suffix_kernel.py
// `smem_bytes`); else `sums` and `lows` hold them and `smem` is the two
// staged rows' 80 M.  G lanes a target (a power of two up to 32 that
// divides `threads`).  Returns the CUDA error of the launch, 0 when it
// was queued.
extern "C" int suffix_launch(
    const void* word, const void* score, const void* lm, const void* prev,
    const void* begin, const void* n_frames, const void* fmax, int B, int T,
    int M, int lr, double ratio, int G, int threads, int in_shared,
    long long smem, void* inc, void* sums, void* lows, void* rest,
    void* stream) {
    if (B < 1 || T < 1 || M < 1 || lr < 0 || threads < 64 ||
        threads > MAX_THREADS || threads % 32 || G < 1 || G > 32 ||
        (G & (G - 1)) || threads < M || smem < 0 || smem > SMEM_MAX ||
        (!in_shared && (sums == nullptr || lows == nullptr)))
        return (int)cudaErrorInvalidValue;
    const Args a{(const int*)word,   (const float*)score,
                 (const float*)lm,    (const int*)prev,
                 (const int*)begin,   (const int*)n_frames,
                 (const float*)fmax,  T, M, lr, G, ratio, (double*)inc,
                 (double*)sums,       (int*)lows, (double*)rest};
    const cudaStream_t s = (cudaStream_t)stream;
    if (in_shared) {
        const cudaError_t err = opt_in();
        if (err != cudaSuccess) return (int)err;
        suffix_kernel<true><<<B, threads, (size_t)smem, s>>>(a);
    } else {
        suffix_kernel<false><<<B, threads, (size_t)smem, s>>>(a);
    }
    return (int)cudaGetLastError();
}
