// Windowed seeded word Viterbi (pass-2 scan_word) over K word chains,
// for Hopper.
//
// Replaces the XLA scan `_scan_core_win` (julius_tpu/search/scan.py:317)
// together with the outprob fetch in front of it: the [K, W, N] one-hot
// HIGHEST-precision matmul of the device A* (search/pass2_device.py:592)
// and the gather of scan_words_store_win (search/scan.py:434).  Chain k
// walks frames t0[k] + i, i = 0..W-1, with per-node state sc / efr / sv
// starting at LOG_ZERO / 0 / LOG_ZERO:
//   1. in-word max over j = 0..KL of sc[n-j] + loc[k, j, n] (LOG_ZERO
//      where n-j < 0); the winner is the SMALLEST j reaching the max and
//      carries efr[n-j] and sv[n-j] (0 / LOG_ZERO where n-j < 0);
//   2. entry seed[k, i] + ent[k, n] replaces it only if strictly greater,
//      then carrying efr = t0 + i and sv = seed[k, i];
//   3. emission base + out[b_k, t0 + i, sidx[k, n]] if base > NEG_HALF,
//      else LOG_ZERO (the outprob gather is fused in here);
//   4. word end endv = nsc + ext[k, n] if nsc > NEG_HALF, else LOG_ZERO;
//      g / beg / sv[k, i] are taken at the FIRST n of the max endv.
// Callers keep t0 + W <= T; frame and utterance indices are clamped into
// range before every read so a bad index can never fault.
//
// (efr, sv) is carried as one int, the entry index e: e = -1 stands for
// (0, LOG_ZERO), the initial state and what a shift from n-j < 0 brings
// in; any other e for (t0 + e, seed[k, e]).  Both are recovered from e
// only where a frame's winner is written out.
//
// Bound: at the device A*'s shape (K = 128, W = 160, N = 21, KL = 1) the
// kernel must read 1.7 MB of gathered outprob, 0.08 MB of seeds and
// 0.05 MB of chain tables and write 0.25 MB of outputs, about 2.1 MB, or
// 0.6 us at 3.35 TB/s; the arithmetic is a few adds and compares a node
// a frame.  Neither is the floor: frame i needs frame i-1's state, so a
// chain takes at least W times the latency of one frame's recurrence,
// the dependent chain shuffle of sc -> arc add -> max -> emission add ->
// select (and beside it the entry index's shuffle -> compare -> two
// selects).  On an H100 80GB HBM3 at 700 W that is 35 ns a frame for one
// chain, 5.6 us at W = 160, plus some 6.6 us a launch for the tables,
// the first chunk's gather and the last chunk's argmax; the kernel takes
// 13 us there (julius_tpu_torch/tools/time_scan_win.py).  The design
// keeps everything else off that chain.
//
// N + KL <= 32 and KL <= 3 (every flagship chain): one CTA of four warps
// a chain, one warp on each of the SM's four schedulers, working through
// the window in chunks of CHUNK = 32 frames over two rings of two
// shared-memory stages, each stage handed over by a full and an empty
// mbarrier:
//   - warps 1 and 2, the gather: they copy each chunk's outprob block
//     out[b, t0 + i, sidx[k, n]] (CHUNK x N scattered floats) and its
//     seeds into an input stage with 4-byte cp.async, and the copies
//     themselves arrive on the stage's full barrier
//     (cp.async.mbarrier.arrive).  TMA does not fit: it copies boxes, and
//     a box around N scattered senone columns of a 2004-float row moves
//     some 95 times the bytes;
//   - warp 0, the recurrence: lane n carries (sc, e).  It loads a whole
//     chunk's outprob values and seeds into registers and hands the input
//     stage back at once, so the gather runs up to two chunks ahead
//     whatever the argmax does.  A frame is then the shuffles of sc and e
//     (from lane (n - j) & 31: lanes past the chain hold LOG_ZERO and -1
//     for good, which is what the rules bring in below lane j), the
//     in-word max, the entry and the emission; sc and e go into a state
//     stage.  No reduction, no ballot, no branch on the lane, no global
//     access and no input load in the frame loop;
//   - warp 3, the argmax: one lane a frame of a finished chunk turns the
//     N staged scores into word ends and their order-preserving keys,
//     keeps the first maximum (ties to the lowest n), recovers efr and sv
//     from e, and writes g, beg and sv coalesced, while the recurrence
//     runs the next chunk.
// Other chains: one thread a node, the state double-buffered in shared
// memory with one __syncthreads a frame, the argmax a shuffle butterfly
// whose partials meet in shared memory; outprob values and seeds are
// loaded BLOCK_RING frames ahead into registers; efr and sv are recovered
// from e in an epilogue.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (julius_tpu_torch/ops/scan_kernel.py loads it with ctypes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LOG_ZERO (-1.0e10f)
#define NEG_HALF (-0.5e10f)
#define MAX_K1 9
#define MAX_NODES 1024
#define FULL 0xffffffffu

struct ScanArgs {
  const float* loc;    // [K, K1, N]
  const float* ent;    // [K, N]
  const float* ext;    // [K, N]
  const int* sidx;     // [K, N]
  const float* seed;   // [K, W]
  const float* out;    // [B, T, R]
  const int* bidx;     // [K]
  const int* t0;       // [K]
  int n_nodes, W, B, T, R;
  float* g;            // [K, W]
  int* beg;            // [K, W]
  float* sv;           // [K, W]
};

// Order-preserving key of a float: a larger float gets a larger key, and
// + 0.0f turns -0 into +0 so that equal floats get equal keys.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// ------------------------------------------------ warp-specialised template

constexpr int CHUNK = 32;               // frames a stage: one an argmax lane
constexpr int OUT_STAGES = 2;           // gather -> recurrence ring
constexpr int STATE_STAGES = 2;         // recurrence -> argmax ring
constexpr int STRIDE = CHUNK + 1;       // the argmax walks columns
constexpr int GATHER_WARPS = 2;
constexpr int GATHER_THREADS = 32 * GATHER_WARPS;
// arc spans up to 3 (left-to-right HMMs skip a state or two at most);
// longer ones take the block template, since a frame's shuffles and the
// chunk's inputs held in registers leave ptxas no room without spills
constexpr int WS_MAX_K1 = 4;
constexpr int WS_THREADS = 32 * (GATHER_WARPS + 2);

struct OutStage {
  float out[CHUNK][32];              // outprob block [frame][node]
  float seed[CHUNK];
};

struct StateStage {
  float sc[CHUNK][STRIDE];           // score after the emission [frame][node]
  int e[CHUNK][STRIDE];              // entry index [frame][node]
};

struct WsShared {
  unsigned long long out_full[OUT_STAGES];      // gather -> recurrence
  unsigned long long out_empty[OUT_STAGES];     // recurrence -> gather
  unsigned long long state_full[STATE_STAGES];  // recurrence -> argmax
  unsigned long long state_empty[STATE_STAGES]; // argmax -> recurrence
  OutStage o[OUT_STAGES];
  StateStage s[STATE_STAGES];
  float ext[32];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.  A
// wait lasts microseconds; one that spins millions of times has lost an
// arrival, and traps so that the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 22)) __trap();
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// One frame of the recurrence at lane n: window frame i, stage row u,
// outprob o and seed sd.  Lanes past the chain hold (LOG_ZERO, -1) for
// good, so a shuffle from lane (n - j) & 31 brings in exactly what the
// rules give below lane j (the launcher keeps N + KL <= 32).  The
// emission's input `top` takes the maxima in an order that keeps the
// shuffled value two operations from the next frame's shuffle; `mx`
// (the strict running max) only decides which path carries e.
template <int K1>
__device__ __forceinline__ void frame(StateStage& st, int u, int i, int n,
                                      const float (&l)[K1], float en,
                                      float o, float sd, float& sc, int& e) {
  const float ent_t = sd + en;
  float mx = sc + l[0];
  float top = fmaxf(mx, ent_t);
  bool enter = ent_t > mx;
  int we = e;
#pragma unroll
  for (int j = 1; j < K1; ++j) {
    const int src = (n - j) & 31;
    const float c = __shfl_sync(FULL, sc, src) + l[j];
    const int he = __shfl_sync(FULL, e, src);
    const bool hit = c > mx;          // strict: ties keep the smallest j
    we = hit ? he : we;
    mx = hit ? c : mx;
    top = fmaxf(top, c);
    enter = enter && ent_t > c;       // entry only if strictly greater
  }
  sc = top > NEG_HALF ? top + o : LOG_ZERO;
  e = enter ? i : we;
  st.sc[u][n] = sc;
  st.e[u][n] = e;
}

template <int K1>
__global__ void __launch_bounds__(WS_THREADS) scan_win_ws_kernel(
    const ScanArgs a) {
  __shared__ WsShared sm;
  const int k = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int N = a.n_nodes, W = a.W;
  const int n_chunks = (W + CHUNK - 1) / CHUNK;
  const int tk = a.t0[k];
  const float* seedk = a.seed + (size_t)k * W;

  if (threadIdx.x == 0) {
    for (int s = 0; s < OUT_STAGES; ++s) {
      mbar_init(&sm.out_full[s], GATHER_THREADS);
      mbar_init(&sm.out_empty[s], 32);
    }
    for (int s = 0; s < STATE_STAGES; ++s) {
      mbar_init(&sm.state_full[s], 32);
      mbar_init(&sm.state_empty[s], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // ---- the recurrence; lanes past the chain carry (LOG_ZERO, -1)
    const int n = lane;
    const bool live = n < N;
    const size_t kn = (size_t)k * N + n;
    float l[K1];
#pragma unroll
    for (int j = 0; j < K1; ++j)
      l[j] = live ? a.loc[((size_t)k * K1 + j) * N + n] : -INFINITY;
    const float en = live ? a.ent[kn] : -INFINITY;
    float sc = LOG_ZERO;
    int e = -1;
    for (int c = 0; c < n_chunks; ++c) {
      const int so = c % OUT_STAGES, ss = c % STATE_STAGES;
      const int i0 = c * CHUNK;
      OutStage& ob = sm.o[so];
      StateStage& st = sm.s[ss];
      mbar_wait(&sm.out_full[so], (c / OUT_STAGES) & 1);
      if (W - i0 >= CHUNK) {
        // the whole chunk's inputs into registers, the stage back to the
        // gather at once, then 32 frames that touch no input memory
        float ov[CHUNK], sd[CHUNK];
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          ov[u] = ob.out[u][n];
          sd[u] = ob.seed[u];
        }
        mbar_arrive(&sm.out_empty[so]);
        mbar_wait(&sm.state_empty[ss], ((c / STATE_STAGES) & 1) ^ 1);
#pragma unroll
        for (int u = 0; u < CHUNK; ++u)
          frame<K1>(st, u, i0 + u, n, l, en, ov[u], sd[u], sc, e);
      } else {
        // the last, partial chunk
        mbar_wait(&sm.state_empty[ss], ((c / STATE_STAGES) & 1) ^ 1);
        for (int u = 0; u < W - i0; ++u)
          frame<K1>(st, u, i0 + u, n, l, en, ob.out[u][n], ob.seed[u], sc,
                    e);
        mbar_arrive(&sm.out_empty[so]);
      }
      mbar_arrive(&sm.state_full[ss]);
    }
  } else if (warp == GATHER_WARPS + 1) {
    // ---- the argmax, one lane a frame: word ends, first maximum
    if (lane < N) sm.ext[lane] = a.ext[(size_t)k * N + lane];
    __syncwarp();
    for (int c = 0; c < n_chunks; ++c) {
      const int ss = c % STATE_STAGES;
      mbar_wait(&sm.state_full[ss], (c / STATE_STAGES) & 1);
      const StateStage& st = sm.s[ss];
      const int i = c * CHUNK + lane;
      if (i < W) {
        unsigned best = 0;              // below every key of a float
        int bn = 0;
        for (int n = 0; n < N; ++n) {
          const float v = st.sc[lane][n];
          const unsigned key =
              order_key(v > NEG_HALF ? v + sm.ext[n] : LOG_ZERO);
          if (key > best) {
            best = key;
            bn = n;
          }
        }
        const int e = st.e[lane][bn];
        const size_t o = (size_t)k * W + i;
        a.g[o] = key_value(best);
        a.beg[o] = e < 0 ? 0 : tk + e;
        a.sv[o] = e < 0 ? LOG_ZERO : seedk[e];
      }
      mbar_arrive(&sm.state_empty[ss]);
    }
  } else {
    // ---- the gather: thread gt copies node gn of every GATHER_WARPS-th
    // frame of a chunk, and seed gt
    const int gt = threadIdx.x - 32;
    const int gn = gt & 31;
    const int gu = gt >> 5;
    const bool glive = gn < N;
    const int b = min(max(a.bidx[k], 0), a.B - 1);
    const float* col = a.out + (size_t)b * a.T * a.R
                       + (glive ? a.sidx[(size_t)k * N + gn] : 0);
    for (int c = 0; c < n_chunks; ++c) {
      const int so = c % OUT_STAGES;
      mbar_wait(&sm.out_empty[so], ((c / OUT_STAGES) & 1) ^ 1);
      OutStage& ob = sm.o[so];
      const int i0 = c * CHUNK;
      if (glive) {
        for (int u = gu; u < CHUNK && i0 + u < W; u += GATHER_WARPS) {
          const int t = min(max(tk + i0 + u, 0), a.T - 1);
          cp_async4(&ob.out[u][gn], col + (size_t)t * a.R);
        }
      }
      if (gt < CHUNK && i0 + gt < W) cp_async4(&ob.seed[gt], seedk + i0 + gt);
      cp_async_arrive(&sm.out_full[so]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
}

// ----------------------------------------------------------- block template

constexpr int BLOCK_RING = 4;

struct Best {
  float v;   // endv
  int n;     // node
  int e;     // entry index
};

__device__ __forceinline__ void take_better(Best& a, const Best& b) {
  if (b.v > a.v || (b.v == a.v && b.n < a.n)) a = b;
}

__device__ __forceinline__ Best warp_best(Best a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best b;
    b.v = __shfl_xor_sync(FULL, a.v, off);
    b.n = __shfl_xor_sync(FULL, a.n, off);
    b.e = __shfl_xor_sync(FULL, a.e, off);
    take_better(a, b);
  }
  return a;
}

template <int K1>
__global__ void __launch_bounds__(MAX_NODES) scan_win_block_kernel(
    const ScanArgs a) {
  __shared__ float sc_s[2][MAX_NODES];
  __shared__ int e_s[2][MAX_NODES];
  __shared__ Best red[2][MAX_NODES / 32];

  const int k = blockIdx.x;
  const int n = threadIdx.x;
  const int N = a.n_nodes, W = a.W, T = a.T;
  const bool live = n < N;
  const size_t kn = (size_t)k * N + n;

  float l[K1];
#pragma unroll
  for (int j = 0; j < K1; ++j)
    l[j] = live ? a.loc[((size_t)k * K1 + j) * N + n] : LOG_ZERO;
  const float en = live ? a.ent[kn] : LOG_ZERO;
  const float ex = live ? a.ext[kn] : LOG_ZERO;
  const int si = live ? a.sidx[kn] : 0;
  const int b = min(max(a.bidx[k], 0), a.B - 1);
  const int tk = a.t0[k];
  const float* orow = a.out + (size_t)b * T * a.R + si;
  const float* seedk = a.seed + (size_t)k * W;

  float oring[BLOCK_RING], sring[BLOCK_RING];
#pragma unroll
  for (int u = 0; u < BLOCK_RING; ++u) {
    const int t = min(max(tk + u, 0), T - 1);
    oring[u] = (live && u < W) ? orow[(size_t)t * a.R] : 0.f;
    sring[u] = u < W ? seedk[u] : LOG_ZERO;
  }

  float sc = LOG_ZERO;
  int e = -1;
  // frame 0 reads buffer 1 as its previous state
  sc_s[1][n] = sc;
  e_s[1][n] = e;
  __syncthreads();

  for (int i0 = 0; i0 < W; i0 += BLOCK_RING) {
#pragma unroll
    for (int u = 0; u < BLOCK_RING; ++u) {
      const int i = i0 + u;
      if (i >= W) break;
      const float o = oring[u];
      const float st = sring[u];
      if (i + BLOCK_RING < W) {
        const int t = min(max(tk + i + BLOCK_RING, 0), T - 1);
        oring[u] = live ? orow[(size_t)t * a.R] : 0.f;
        sring[u] = seedk[i + BLOCK_RING];
      }
      // 1. in-word max: running strict > from j = 0 keeps the smallest j
      float mx = sc + l[0];
      int we = e;
      const int p = (i + 1) & 1;        // previous frame's buffer
#pragma unroll
      for (int j = 1; j < K1; ++j) {
        const int m = n >= j ? n - j : 0;
        const float c = (n < j ? LOG_ZERO : sc_s[p][m]) + l[j];
        const int he = n < j ? -1 : e_s[p][m];
        if (c > mx) {
          mx = c;
          we = he;
        }
      }
      // 2. entry, strict
      const float ent_t = st + en;
      const bool enter = ent_t > mx;
      const float base = fmaxf(ent_t, mx);
      // 3. emission
      sc = base > NEG_HALF ? base + o : LOG_ZERO;
      e = enter ? i : we;
      // 4. word end and the first argmax over nodes
      const float endv = sc > NEG_HALF ? sc + ex : LOG_ZERO;
      Best me;
      me.v = live ? endv : -INFINITY;
      me.n = n;
      me.e = e;
      me = warp_best(me);
      const int c = i & 1;
      sc_s[c][n] = sc;
      e_s[c][n] = e;
      if ((n & 31) == 0) red[c][n >> 5] = me;
      __syncthreads();
      if (n == 0) {
        Best best = red[c][0];
        const int nw = blockDim.x >> 5;
        for (int w = 1; w < nw; ++w) take_better(best, red[c][w]);
        const size_t o_ki = (size_t)k * W + i;
        a.g[o_ki] = best.v;
        a.beg[o_ki] = best.e;           // the entry index, until below
      }
    }
  }
  // the entry index of each frame's winner -> its entry frame and seed
  __syncthreads();
  for (int i = n; i < W; i += blockDim.x) {
    const size_t o_ki = (size_t)k * W + i;
    const int we = a.beg[o_ki];
    a.beg[o_ki] = we < 0 ? 0 : tk + we;
    a.sv[o_ki] = we < 0 ? LOG_ZERO : seedk[we];
  }
}

// ------------------------------------------------------------------ launch

template <int K1>
static void launch(int n_chains, const ScanArgs& a, cudaStream_t s) {
  if constexpr (K1 <= WS_MAX_K1) {
    if (a.n_nodes + K1 - 1 <= 32) {
      scan_win_ws_kernel<K1><<<n_chains, WS_THREADS, 0, s>>>(a);
      return;
    }
  }
  const int threads = (a.n_nodes + 31) / 32 * 32;
  scan_win_block_kernel<K1><<<n_chains, threads, 0, s>>>(a);
}

extern "C" int scan_win_launch(
    const void* loc, const void* ent, const void* ext, const void* sidx,
    const void* seed, const void* out, const void* bidx, const void* t0,
    int n_chains, int k1, int n_nodes, int W, int B, int T, int R,
    void* g, void* beg, void* sv, void* stream) {
  if (n_nodes < 1 || n_nodes > MAX_NODES || k1 < 1 || k1 > MAX_K1)
    return (int)cudaErrorInvalidValue;
  const ScanArgs a{(const float*)loc, (const float*)ent, (const float*)ext,
                   (const int*)sidx, (const float*)seed, (const float*)out,
                   (const int*)bidx, (const int*)t0, n_nodes, W, B, T, R,
                   (float*)g, (int*)beg, (float*)sv};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (k1) {
    case 1: launch<1>(n_chains, a, s); break;
    case 2: launch<2>(n_chains, a, s); break;
    case 3: launch<3>(n_chains, a, s); break;
    case 4: launch<4>(n_chains, a, s); break;
    case 5: launch<5>(n_chains, a, s); break;
    case 6: launch<6>(n_chains, a, s); break;
    case 7: launch<7>(n_chains, a, s); break;
    case 8: launch<8>(n_chains, a, s); break;
    default: launch<9>(n_chains, a, s); break;
  }
  return (int)cudaGetLastError();
}
