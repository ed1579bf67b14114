// Pass 1's word-end stage, for Hopper: the corrected word-end records of
// one frame and the cross-word winner, one thread-block cluster of C
// blocks a batch row (C = 1: one block).
//
// Replaces the XLA code the reference runs inside its jitted pass-1 step
// next to its one TPU kernel: `_word_end_candidates`
// (julius_tpu/search/pass1.py:267, the top 2M exits by `approx_max_k` or
// `lax.top_k`, one-hot payload selections, the 2-gram probes, `lax.top_k`
// to M) and `_scalar_entry_batched` (:592, the single best atom).  For
// row b of the [B, N] state (score, ctx, prev):
//   1. sc[e] = score[b, exit_nodes[e]] + exit_nlp[e] over the Ex exits;
//   2. the top k = min(2M, Ex) of them, exactly, ties to the lowest exit
//      index (lax.top_k's order; no approximate selection);
//   3. for each of the k: its payload (prev, ctx, the LM context it
//      passes on, word, LM word, unigram), the exact 2-gram log10
//      P(w | v) by the narrow or wide hash probe of
//      search/ngram_device.py `bigram_score_fast` (MAX_PROBES rows of
//      bi_rows), the factoring-1 swap delta = lw * (bigram - unigram)
//      (none under factoring 2 or without an LM), the LM score
//      lw * bigram + penalty, and corrected = sc + delta where sc >
//      NEG_HALF, else LOG_ZERO;
//   4. the top m = min(M, k) by corrected score, ties to the lower
//      stage-1 rank (a stable sort of the stage-1 order);
//   5. the [B, M] atoms: word (-1 where the score is not above
//      NEG_HALF), score, lm, prev, begin = prev / M + 1 (0 without a
//      predecessor), ectx; slots from m on take the fills -1, LOG_ZERO,
//      0, -1, 0, -1;
//   6. optionally the [B] winner: the first atom of the highest score
//      among those with a word (LOG_ZERO for the others), its score and
//      ectx (LOG_ZERO and -1 when it has no word) and its trellis
//      pointer (t - 1) * M + slot, t read from a [1] device int.
// Every f32 operation is one correctly rounded op in the plain version's
// order (__fadd_rn and friends: nvcc contracts a * b + c into an FMA
// otherwise), the hash is native uint32 arithmetic, and ties are broken
// exactly as the plain version's stable sorts break them, so the records
// are bit-equal to ops/word_end_kernel.py `word_end_plain` on the card.
//
// Bound: latency, not bytes or operations.  A row reads its Ex exit
// scores once (a gather over the node axis, 4 B an exit), the exit
// tables, and for 2M candidates a few payload words and 8 probe rows; at
// B = 16, Ex = 5000 or B = 32, Ex = 20,000 that is well under a
// megabyte, a fraction of a microsecond at the card's memory rate.  What
// a row costs is its chain of dependent steps.  The one-block design this
// replaces, phase by phase (tools/time_word_end.py --phases, H100 SXM):
// at Ex = 5000, M = 32 the gather 2.2 us, four radix passes of four
// block barriers each 6.4, the candidate collection 2.0, the first
// ranking 1.4, payload and probes 2.4, re-rank and writes 2.1 (16.4 in
// the kernel, the same at B = 1 and 64); at Ex = 20,000, M = 128 8.6,
// 17.2, 5.9, 3.2, 4.2 and 4.7.  Two thirds grow with the exits a block
// walks, and one block a row leaves 116 of 132 SMs idle at B = 16.
//
// Design:
//   * the row's exits are cut into C contiguous ranges, one a block of
//     the cluster (rank r takes [r Ex / C, (r + 1) Ex / C)), so the
//     gather, the histograms and the collection walk Ex / C exits;
//     ops/word_end_kernel.py `cluster_plan` picks C from (B, Ex);
//   * each exit score becomes an order-preserving uint32 key (larger key,
//     larger score; -0 and +0 one key, as the stable sort sees them
//     equal), kept in the block's shared memory (in a global scratch row
//     when the block's range is too large for it); a thread starts the
//     loads of KEY_BATCH exits before it uses any, and adds each key to
//     the first radix pass's histogram as it makes it.  The second pass
//     lists the keys inside the first pass's bin (most exits of a row
//     lie outside it, at LOG_ZERO), each warp its own, and the last two
//     walk only those;
//   * an exact radix select finds the k-th largest key of the row in up
//     to four 8-bit passes over 256-bin histograms (a warp's equal digits
//     added once, __match_any_sync).  Each block sends its histogram to
//     every block of the cluster with st.async into distributed shared
//     memory, completing on the receiver's mbarrier: no cluster barrier
//     and no release fence (about 1400 and 950 cycles on an H100, where
//     a block barrier takes 77: tools/probe_cluster.py).  Every block
//     sums the C histograms itself and finds the same bin.  A receive
//     buffer and an mbarrier a pass, each used once.  A block barrier a
//     pass broadcasts the bin (four before);
//   * the select stops as soon as the k-th key's bin is taken whole;
//   * every key above the k-th is a candidate, and so are the lowest-
//     index keys equal to it, as many as are still needed.  The C
//     histograms each block received already say how many keys of each
//     block lie above the k-th and how many equal it, so block r's tie
//     quota is what the ranks below r left and its candidates take the
//     slots after theirs, with no further exchange; only a block that
//     takes some but not all of its equal keys counts them a warp;
//   * a thread a candidate gathers its payload and probes the 2-gram
//     table (the probe chain exit -> ctx -> ctx_info -> table rows runs
//     in every block at once), and sends the 32-byte record to every
//     block of the cluster with st.async;
//   * the two rankings are one: the plain version orders the top m by
//     (corrected, stage-1 rank), and the stage-1 rank is the order of
//     (key, -index), so the records are ranked by (corrected key, key,
//     -index).  Block r ranks the r-th C-th of the k records among all
//     of them by counting (a few threads a record, no barrier) and
//     writes those of rank below m as the atoms at their rank; on rank 0
//     warp 0 meanwhile takes the winner: the valid record of the largest
//     rank key if its rank is below m (scores do not rise along the
//     slots, so it is the first maximum); rank 0 writes the fills.
// Every write into a block's shared memory by another block is awaited
// by the receiver before it reads or exits, and no block reads another's
// shared memory, so no block waits for its peers to exit.  On an H100
// this takes a call on the flagship's states at B = 16 from 22.9 to 15.7
// us (C = 4) and at the 20k-word configuration's B = 32 from 62.4 to
// 39.2 (C = 4; chip_smoke.py); what is left is a chain of short phases,
// a radix pass still 1.1-1.9 us.  A lost
// arrival traps after millions of polls instead of hanging.  The kernel
// allocates nothing and makes no host call: it runs inside pass 1's
// captured CUDA graphs (cluster launches are captured like any other).
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (julius_tpu_torch/ops/word_end_kernel.py loads it with
// ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#define LOG_ZERO (-1.0e10f)
#define NEG_HALF (-0.5e10f)
#define MAX_THREADS 1024
#define KEY_BATCH 4           // exits a thread loads at once in step 1
#define MAX_PROBES 8
#define GOLDEN 0x9E3779B1u
#define SMEM_MAX 232448       // shared memory a block may opt into
#define MAX_DEVICES 64
#define MAX_CLUSTER 8         // the portable cluster size
#define FULL 0xffffffffu

typedef unsigned long long u64;

// Phase stamps: a build with -DWORD_END_PHASES (tools/time_word_end.py
// --phases) has thread 0 of each block write the SM clock and the global
// timer after each phase's barrier into g_stamps; word_end_phase_stamps
// copies them out.  The library pass 1 loads is built without it.
#ifdef WORD_END_PHASES
#define N_STAMPS 11
#define STAMP_BLOCKS 1024
__device__ u64 g_stamps[STAMP_BLOCKS * N_STAMPS * 2];
__device__ __forceinline__ void stamp(int p) {
    if (threadIdx.x == 0 && blockIdx.x < STAMP_BLOCKS) {
        u64 g;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
        u64* s = g_stamps + 2 * ((size_t)blockIdx.x * N_STAMPS + p);
        s[0] = clock64();
        s[1] = g;
    }
}
#define STAMP(p) stamp(p)
#define STAMP_SYNC() __syncthreads()
#else
#define STAMP(p)
#define STAMP_SYNC()
#endif

// Larger key <=> larger float; both zeros map to +0's key.
__device__ __forceinline__ uint32_t ord_key(float f) {
    uint32_t u = (f == 0.0f) ? 0u : __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// search/ngram_device.py `_hash_u32`: Murmur3's finaliser on uint32.
__device__ __forceinline__ uint32_t hash_u32(uint32_t k) {
    k ^= k >> 16;
    k *= 0x85EBCA6Bu;
    k ^= k >> 13;
    k *= 0xC2B2AE35u;
    k ^= k >> 16;
    return k;
}

// search/ngram_device.py `bigram_score_fast` for one query: log10 P(w | v)
// with the caller's unigram uni_w and context back-off v_bo; v_lm < 0
// means no context.  A key sits at most once in a probe chain, so the sum
// of the hits is the hit's value (or +0: -0 + 0 rounds to +0, as the
// plain version's sum does).
__device__ float bigram(const int* __restrict__ rows, uint32_t H, int wide,
                        uint32_t n_words, int v_lm, float v_bo, int w_lm,
                        float uni_w) {
    uint32_t vq = v_lm < 0 ? 0u : (uint32_t)v_lm;
    uint32_t wq = w_lm < 0 ? 0u : (uint32_t)w_lm;
    uint32_t mask = H - 1;
    bool found = false;
    float p = 0.0f;
    if (wide) {
        uint32_t slot = hash_u32(hash_u32(vq) ^ (wq * GOLDEN)) & mask;
#pragma unroll
        for (int i = 0; i < MAX_PROBES; ++i) {
            const int* r = rows + 3 * (size_t)((slot + i) & mask);
            if ((uint32_t)__ldg(r) == vq && (uint32_t)__ldg(r + 1) == wq) {
                found = true;
                p = __fadd_rn(p, __int_as_float(__ldg(r + 2)));
            }
        }
    } else {
        uint32_t key = vq * n_words + wq;
        uint32_t slot = hash_u32(key) & mask;
#pragma unroll
        for (int i = 0; i < MAX_PROBES; ++i) {
            const int* r = rows + 2 * (size_t)((slot + i) & mask);
            if ((uint32_t)__ldg(r) == key) {
                found = true;
                p = __fadd_rn(p, __int_as_float(__ldg(r + 1)));
            }
        }
    }
    float out = found ? p : __fadd_rn(v_bo, uni_w);
    return v_lm < 0 ? uni_w : out;
}

// ---- distributed shared memory: st.async into a peer's shared memory,
// completing on the peer's mbarrier (transaction bytes)

__device__ __forceinline__ uint32_t cta_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of this block's `addr` in block `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}

__device__ __forceinline__ void bar_init(u64* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(cta_addr(bar)) : "memory");
}

// The one arrival of the barrier's current phase, which then completes
// once `bytes` transaction bytes have landed.
__device__ __forceinline__ void bar_expect(u64* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(cta_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.  A
// wait lasts microseconds; one that spins millions of times has lost
// bytes, and traps so that the launch fails instead of hanging.
__device__ __forceinline__ void bar_wait(u64* bar, uint32_t parity) {
    for (uint32_t spins = 0;; ++spins) {
        uint32_t done;
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(cta_addr(bar)), "r"(parity) : "memory");
        if (done) return;
        if (spins == (1u << 24)) __trap();
    }
}

__device__ __forceinline__ void send4(uint32_t dst, uint4 v, uint32_t bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
        "[%0], {%1, %2, %3, %4}, [%5];"
        :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
        : "memory");
}

struct Args {
    const float* score;
    const int* ctx;
    const int* prev;
    long long ld;             // row stride of score / ctx / prev
    int Ex;
    const long long* exit_nodes;
    const float* exit_nlp;
    const int* exit_w;
    const int* exit_wlm;
    const float* exit_uni;
    const unsigned char* exit_transp;
    const float* ctx_info;    // [V, 2]: LM id as f32, back-off; lm_on only
    const int* bi_rows;       // [H, 2 or 3]; lm_on only
    uint32_t H;
    int wide;
    uint32_t n_words;
    int lm_on;                // the 2-gram probe and lm = lw * bigram + pen
    int swap;                 // factoring 1: delta = lw * (bigram - uni)
    float lw, pen;
    int M, k, C;
    const int* t;             // [1] frame index, or null: no winner
    uint32_t* keys_g;         // [B, Ex] scratch, or null: keys in shared
    int* o_word;
    float* o_score;
    float* o_lm;
    int* o_prev;
    int* o_begin;
    int* o_ectx;
    float* o_ent;
    int* o_ectx_e;
    int* o_eprev;
};

// Composite rank key of record r0 = (key, ~exit, corrected key,
// corrected): (corrected key, key) above, ~exit below.
__device__ __forceinline__ bool rec_gt(uint4 y, u64 xh, uint32_t xl) {
    const u64 yh = ((u64)y.z << 32) | y.x;
    return yh > xh || (yh == xh && y.y > xl);
}

// The records rec[2s] = (key, ~exit, corrected key, corrected),
// rec[2s + 1] = (lm, prev, ectx, word) of slots s0 <= s < s1, each ranked
// among all k in descending order of (corrected key, key, ~exit) by
// counting (g threads a record, a share of the others each, summed by
// shuffles); one whose rank p is below m becomes the atom at slot p of
// the row's outputs from ob on.  Called by the nt threads (whole warps)
// from t0 on.
__device__ void rank_write(const uint4* rec, int k, int s0, int s1, int m,
                           const Args& a, size_t ob, int t0, int nt) {
    const int nr = s1 - s0, t = threadIdx.x - t0;
    int g = 32;
    while (g > 1 && g * nr > nt) g >>= 1;
    const int part = t % g;
    for (int base = 0; base < nr; base += nt / g) {
        const int r = s0 + base + t / g;
        const bool in = r < s1;
        const uint4 x = in ? rec[2 * r] : make_uint4(0, 0, 0, 0);
        const u64 xh = ((u64)x.z << 32) | x.x;
        int n = 0;
        if (in)
            for (int j = part; j < k; j += g) n += rec_gt(rec[2 * j], xh, x.y);
        for (int d = g >> 1; d > 0; d >>= 1)
            n += __shfl_xor_sync(FULL, n, d);
        if (in && part == 0 && n < m) {
            const uint4 x1 = rec[2 * r + 1];
            const float csc = __uint_as_float(x.w);
            const int p = (int)x1.y;
            a.o_word[ob + n] = csc > NEG_HALF ? (int)x1.w : -1;
            a.o_score[ob + n] = csc;
            a.o_lm[ob + n] = __uint_as_float(x1.x);
            a.o_prev[ob + n] = p;
            a.o_begin[ob + n] = p >= 0 ? p / a.M + 1 : 0;
            a.o_ectx[ob + n] = (int)x1.z;
        }
    }
}

// The winner of row b from all k records, by warp 0: the first slot
// (rank) below m whose atom has a word and a score above NEG_HALF, since
// scores do not rise along the slots, i.e. the valid record of the
// largest rank key if its rank is below m; else slot 0 with LOG_ZERO.
__device__ void winner(const uint4* rec, int k, int m, const Args& a,
                       int b, int t_frame) {
    const int lane = threadIdx.x & 31;
    u64 bh = 0;
    uint32_t bl = 0;
    int bs = -1;
    for (int j = lane; j < k; j += 32) {
        const uint4 y = rec[2 * j];
        if (__uint_as_float(y.w) > NEG_HALF && (int)rec[2 * j + 1].w >= 0 &&
            (bs < 0 || rec_gt(y, bh, bl))) {
            bh = ((u64)y.z << 32) | y.x;
            bl = y.y;
            bs = j;
        }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        const u64 oh = __shfl_xor_sync(FULL, bh, d);
        const uint32_t ol = __shfl_xor_sync(FULL, bl, d);
        const int os = __shfl_xor_sync(FULL, bs, d);
        if (os >= 0 && (bs < 0 || oh > bh || (oh == bh && ol > bl))) {
            bh = oh;
            bl = ol;
            bs = os;
        }
    }
    int n = 0;
    if (bs >= 0)
        for (int j = lane; j < k; j += 32) n += rec_gt(rec[2 * j], bh, bl);
    n = (int)__reduce_add_sync(FULL, (uint32_t)n);
    if (lane == 0) {
        const bool valid = bs >= 0 && n < m;
        a.o_ent[b] = valid ? __uint_as_float(rec[2 * bs].w) : LOG_ZERO;
        a.o_ectx_e[b] = valid ? (int)rec[2 * bs + 1].z : -1;
        a.o_eprev[b] = (t_frame - 1) * a.M + (valid ? n : 0);
    }
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
    return (x + 15) & ~(size_t)15;
}

// Shared memory of every block: the row's k candidate records, the
// block's own candidates, the local histogram, a receive buffer of C
// histograms for each of the four passes, a few words of block state,
// five mbarriers, then the block's keys and the compact list of those
// inside the first pass's bin when they live here.
struct Layout {
    int k, C;
    __host__ __device__ Layout(int k_, int C_) : k(k_), C(C_) {}
    __host__ __device__ size_t rec() const { return 0; }
    __host__ __device__ size_t loc() const { return rec() + 32 * (size_t)k; }
    __host__ __device__ size_t lh() const {
        return loc() + align16(4 * (size_t)k);
    }
    __host__ __device__ size_t recv() const { return lh() + 4 * 256; }
    __host__ __device__ size_t state() const {
        return recv() + 4 * 4 * 256 * (size_t)C;
    }
    __host__ __device__ size_t bars() const { return state() + 4 * 128; }
    __host__ __device__ size_t keys() const { return bars() + 8 * 8; }
};

// block state words
#define ST_BIN 0
#define ST_REM 1
#define ST_WHOLE 2
#define ST_COUNT 3
#define ST_PBIN 4             // four: each pass's bin
#define ST_GT 8               // a word a block of the cluster: keys above
#define ST_EQ 16              // ... and keys equal to the k-th
#define ST_WEQ 32             // a word a warp: keys equal to the k-th
// mbarriers
#define BAR_HIST 0            // four: each pass's histograms
#define BAR_REC 4             // the row's k records

// Add `key`'s digit at `shift` to `hist` where `in` holds, a warp's equal
// digits at once.  Called by the whole warp.
__device__ __forceinline__ void hist_add(uint32_t* hist, bool in,
                                         uint32_t key, int shift, int lane) {
    const unsigned act = __ballot_sync(FULL, in);
    if (in) {
        const uint32_t bin = (key >> shift) & 255u;
        const unsigned peers = __match_any_sync(act, bin);
        if (lane == __ffs(peers) - 1)
            atomicAdd(&hist[bin], (uint32_t)__popc(peers));
    }
}

// Lane l's 8 bins 255 - 8l ... 248 - 8l of a 256-bin histogram, high to
// low.
__device__ __forceinline__ void lane_bins(const uint32_t* h, int lane,
                                          uint32_t (&c)[8]) {
    const uint4* q = reinterpret_cast<const uint4*>(h);
    const uint4 v0 = q[62 - 2 * lane], v1 = q[63 - 2 * lane];
    c[0] = v1.w; c[1] = v1.z; c[2] = v1.y; c[3] = v1.x;
    c[4] = v0.w; c[5] = v0.z; c[6] = v0.y; c[7] = v0.x;
}

// Block s's keys above the bin of pass q, from its section of that
// pass's histograms, added to ST_GT + s; if `last`, its keys in the bin
// are ST_EQ + s, or also above if the bin is whole.  Called by a warp.
__device__ __forceinline__ void section_counts(const uint32_t* recv,
                                               uint32_t* st, int s, int q,
                                               int C, bool last, bool whole,
                                               int lane) {
    const uint32_t bin = st[ST_PBIN + q];
    uint32_t cs[8], above = 0, inb = 0;
    lane_bins(recv + 256 * (C * q + s), lane, cs);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const uint32_t bj = 255 - 8 * lane - j;
        above += bj > bin ? cs[j] : 0u;
        inb += bj == bin ? cs[j] : 0u;
    }
    above = __reduce_add_sync(FULL, above);
    inb = __reduce_add_sync(FULL, inb);
    if (lane == 0) {
        atomicAdd(&st[ST_GT + s], last && whole ? above + inb : above);
        if (last && !whole) st[ST_EQ + s] = inb;
    }
}

// CL: a cluster of a.C blocks a row (launched with the cluster
// attribute); else one block a row.
template <bool CL>
__global__ void __launch_bounds__(MAX_THREADS)
word_end_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int C = CL ? a.C : 1;
    const int rank = CL ? (int)(blockIdx.x % C) : 0;
    const int b = blockIdx.x / C;
    const int Ex = a.Ex, k = a.k, M = a.M;
    const Layout L(k, C);
    uint4* rec = reinterpret_cast<uint4*>(smem + L.rec());
    int* loc = reinterpret_cast<int*>(smem + L.loc());
    uint32_t* lh = reinterpret_cast<uint32_t*>(smem + L.lh());
    uint32_t* recv = reinterpret_cast<uint32_t*>(smem + L.recv());
    uint32_t* st = reinterpret_cast<uint32_t*>(smem + L.state());
    u64* bars = reinterpret_cast<u64*>(smem + L.bars());
    const int lo = (int)((long long)rank * Ex / C);
    const int n = (int)((long long)(rank + 1) * Ex / C) - lo;
    uint32_t* keys = a.keys_g ? a.keys_g + (size_t)b * Ex + lo
                              : reinterpret_cast<uint32_t*>(smem + L.keys());
    // with the keys in shared memory, passes 3 and 4 walk only the keys
    // inside the first pass's bin, listed by pass 2, each warp its own in
    // a region as large as the keys it walks in a pass
    int* cl = a.keys_g ? nullptr
                       : reinterpret_cast<int*>(smem + L.keys()) + max(n, 0);
    const float* srow = a.score + (size_t)b * a.ld;
    const int* crow = a.ctx + (size_t)b * a.ld;
    const int* prow = a.prev + (size_t)b * a.ld;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nthreads = blockDim.x, nwarps = nthreads >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const bool select = k < Ex;        // k == Ex takes every exit
    // the frame index, loaded now and used last
    const int t_frame = (a.t != nullptr && warp == 0) ? __ldg(a.t) : 0;

    STAMP(0);
    // ---- 0. clear the local histograms and the counts (without a select
    // every key of each block is taken); mbarriers, each expecting its
    // first phase's bytes
    if (tid < 256) {
        lh[tid] = 0;
        if (!CL)
            for (int i = 0; i < 4; ++i) recv[256 * i + tid] = 0;
    }
    if (tid < C) {
        st[ST_GT + tid] = select ? 0u : (uint32_t)(
            (long long)(tid + 1) * Ex / C - (long long)tid * Ex / C);
        st[ST_EQ + tid] = 0;
    }
    if (tid == 0) {
        st[ST_COUNT] = 0;
        if (CL) {
            for (int i = 0; i < 5; ++i) bar_init(&bars[i]);
            for (int i = 0; i < 4; ++i)
                bar_expect(&bars[BAR_HIST + i], C * 1024);
            bar_expect(&bars[BAR_REC], k * 32);
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        }
    }
    if (CL)
        asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    __syncthreads();

    // ---- 1. keys, and the first pass's histogram; a thread starts the
    // loads of KEY_BATCH exits at once
    uint32_t* h0 = CL ? lh : recv;
    for (int base = warp * 32; base < n; base += KEY_BATCH * nthreads) {
        int nd[KEY_BATCH];
        float nl[KEY_BATCH], sv[KEY_BATCH];
#pragma unroll
        for (int j = 0; j < KEY_BATCH; ++j) {
            const int i = base + lane + j * nthreads;
            nd[j] = i < n ? (int)__ldg(a.exit_nodes + lo + i) : 0;
            nl[j] = i < n ? __ldg(a.exit_nlp + lo + i) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < KEY_BATCH; ++j) {
            const int i = base + lane + j * nthreads;
            sv[j] = i < n ? __ldg(srow + nd[j]) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < KEY_BATCH; ++j) {
            const int i = base + lane + j * nthreads;
            const uint32_t key = ord_key(__fadd_rn(sv[j], nl[j]));
            if (i < n) keys[i] = key;
            if (select) hist_add(h0, i < n, key, 24, lane);
        }
    }
    if (CL) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    __syncthreads();
    STAMP(1);

    // ---- 2. the k-th largest key of the row, kth, and rem, how many of
    // the keys equal to it are taken (the lowest-index ones); a bin taken
    // whole ends the select with kth just below it and rem = 0
    uint32_t kth = 0, rem = 0;
    int passes = 0;
    bool whole = false;
    int* cl_w = cl == nullptr
                    ? nullptr
                    : cl + warp * 32 * ((n + nthreads - 1) / nthreads);
    int n_cl = 0;                  // this warp's listed keys
    if (select) {
        uint32_t prefix = 0, pmask = 0;
        rem = k;
        for (; passes < 4 && !whole; ++passes) {
            const int p = passes, shift = 24 - 8 * p;
            uint32_t* sec = recv + 256 * C * p;    // C sections (!CL: 1)
            if (p > 0 && (cl == nullptr || p == 1)) {
                uint32_t* hist = CL ? lh : sec;
                for (int base = warp * 32; base < n; base += nthreads) {
                    const int i = base + lane;
                    const uint32_t key = i < n ? keys[i] : 0u;
                    const bool in = i < n && (key & pmask) == prefix;
                    hist_add(hist, in, key, shift, lane);
                    if (cl != nullptr) {
                        const unsigned lb = __ballot_sync(FULL, in);
                        if (in) cl_w[n_cl + __popc(lb & lt)] = i;
                        n_cl += __popc(lb);
                    }
                }
                __syncthreads();
            } else if (p > 1) {
                uint32_t* hist = CL ? lh : sec;
                for (int base = 0; base < n_cl; base += 32) {
                    const int j = base + lane;
                    const int i = j < n_cl ? cl_w[j] : 0;
                    const uint32_t key = j < n_cl ? keys[i] : 0u;
                    hist_add(hist, j < n_cl && (key & pmask) == prefix, key,
                             shift, lane);
                }
                __syncthreads();
            }
            if (CL && tid < 64) {
                // send the block's histogram to every block of the
                // cluster, section `rank` of their pass-p buffer; clear it
                const uint4 v = reinterpret_cast<const uint4*>(lh)[tid];
                reinterpret_cast<uint4*>(lh)[tid] = make_uint4(0, 0, 0, 0);
                const uint32_t dst = cta_addr(sec + 256 * rank + 4 * tid);
                const uint32_t bar = cta_addr(&bars[BAR_HIST + p]);
                for (int j = 0; j < C; ++j)
                    send4(peer_addr(dst, j), v, peer_addr(bar, j));
            }
            if (p > 0 && warp > 0)
                // while warp 0 waits and scans: each block's counts from
                // its section of the last pass (whose bin was not whole)
                for (int s = warp - 1; s < C; s += nwarps - 1)
                    section_counts(recv, st, s, p - 1, C, false, false,
                                   lane);
            if (warp == 0) {
                if (CL) bar_wait(&bars[BAR_HIST + p], 0);
                // lane l's bins summed over the C sections
                uint32_t c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
                for (int s = 0; s < C; ++s) {
                    uint32_t cs[8];
                    lane_bins(sec + 256 * s, lane, cs);
#pragma unroll
                    for (int j = 0; j < 8; ++j) c[j] += cs[j];
                }
                uint32_t s = 0;
#pragma unroll
                for (int j = 0; j < 8; ++j) s += c[j];
                uint32_t incl = s;
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const uint32_t x = __shfl_up_sync(FULL, incl, d);
                    if (lane >= d) incl += x;
                }
                const uint32_t excl = incl - s;
                if (excl < rem && rem <= incl) {
                    uint32_t cum = excl;
                    for (int j = 0; j < 8; ++j) {
                        if (cum + c[j] >= rem) {
                            const uint32_t bin = 255 - 8 * lane - j;
                            st[ST_PBIN + p] = bin;
                            st[ST_REM] = rem - cum;
                            // whole: every key of the bin is taken (never
                            // at bin 0 of prefix 0: that bin would hold
                            // the whole row)
                            st[ST_WHOLE] = c[j] == rem - cum &&
                                           (prefix | (bin << shift)) != 0;
                            break;
                        }
                        cum += c[j];
                    }
                }
            }
            __syncthreads();
            prefix |= st[ST_PBIN + p] << shift;
            pmask |= 255u << shift;
            rem = st[ST_REM];
            whole = st[ST_WHOLE] != 0;
            STAMP(2 + p);
        }
        kth = prefix;
        if (whole) {
            // taken whole: every key >= prefix, none below
            kth = prefix - 1;
            rem = 0;
            for (int q = passes; q < 4; ++q) STAMP(2 + q);
        }
        // each block's keys above kth and equal to it: the last pass's
        // counts (the earlier passes' were taken during the next)
        for (int s = warp; s < C; s += nwarps)
            section_counts(recv, st, s, passes - 1, C, true, whole, lane);
    } else {
        STAMP(2); STAMP(3); STAMP(4); STAMP(5);
    }
    __syncthreads();

    // ---- 3. this block's first slot and tie quota from the ranks below
    // it: block j takes its keys above kth and, of its keys equal to kth,
    // what the blocks before it left of rem, lowest index first.  Only a
    // block that takes some but not all of its equal keys counts them a
    // warp (its warps' contiguous ranges in index order)
    uint32_t eq_before = 0, slot_base = 0;
    for (int j = 0; j < rank; ++j) {
        const uint32_t eq = st[ST_EQ + j];
        slot_base += st[ST_GT + j] +
                     (rem > eq_before ? min(rem - eq_before, eq) : 0u);
        eq_before += eq;
    }
    const uint32_t neq = st[ST_EQ + rank];
    const uint32_t quota = rem > eq_before ? min(rem - eq_before, neq) : 0u;
    const int span = ((n + nwarps - 1) / nwarps + 31) & ~31;
    const int wlo = min(warp * span, n), whi = min(wlo + span, n);
    uint32_t eqb = 0;              // keys equal to kth before this warp's
    if (quota > 0 && quota < neq) {
        uint32_t m = 0;
        for (int base = wlo; base < whi; base += 32) {
            const int i = base + lane;
            m += __popc(__ballot_sync(FULL, i < whi && keys[i] == kth));
        }
        if (lane == 0) st[ST_WEQ + warp] = m;
        __syncthreads();
        for (int w = 0; w < warp; ++w) eqb += st[ST_WEQ + w];
    }
    STAMP(6);

    // ---- 4. the block's candidates, by local index: every key above kth
    // and the lowest-index keys equal to it while the quota lasts
    for (int base = wlo; base < whi; base += 32) {
        const int i = base + lane;
        const uint32_t key = i < whi ? keys[i] : 0u;
        const bool gt = i < whi && (!select || key > kth);
        const bool eq = i < whi && select && key == kth;
        const unsigned beq = __ballot_sync(FULL, eq);
        const bool take = gt || (eq && eqb + __popc(beq & lt) < quota);
        eqb += __popc(beq);
        const unsigned bt = __ballot_sync(FULL, take);
        if (bt == 0) continue;
        uint32_t slot0 = 0;
        if (lane == 0) slot0 = atomicAdd(&st[ST_COUNT], (uint32_t)__popc(bt));
        slot0 = __shfl_sync(FULL, slot0, 0);
        if (take) loc[slot0 + __popc(bt & lt)] = i;
    }
    __syncthreads();
    STAMP(7);

    // ---- 5. a thread a candidate: payload, 2-gram probe and correction;
    // the record to every block of the cluster, slot slot_base + its
    // place here
    const int n_loc = (int)st[ST_COUNT];
    for (int s = tid; s < n_loc; s += nthreads) {
        const int i = loc[s], e = lo + i;
        const long long node = __ldg(a.exit_nodes + e);
        const float sc = __fadd_rn(__ldg(srow + node), __ldg(a.exit_nlp + e));
        const int c = __ldg(crow + node);
        const int w = __ldg(a.exit_w + e), wlm = __ldg(a.exit_wlm + e);
        const float uni = __ldg(a.exit_uni + e);
        const int p = __ldg(prow + node);
        const int ectx = __ldg(a.exit_transp + e) ? c : w;
        float delta = 0.0f, lm = a.pen;
        if (a.lm_on) {
            const int cq = c < 0 ? 0 : c;
            const float v0 = __ldg(a.ctx_info + 2 * (size_t)cq);
            const float vbo = __ldg(a.ctx_info + 2 * (size_t)cq + 1);
            const int v_lm = c >= 0 ? (int)v0 : -1;
            const float bi = bigram(a.bi_rows, a.H, a.wide, a.n_words, v_lm,
                                    vbo, wlm, uni);
            if (wlm >= 0) {
                if (a.swap) delta = __fmul_rn(a.lw, __fsub_rn(bi, uni));
                lm = __fadd_rn(__fmul_rn(a.lw, bi), a.pen);
            }
        }
        const float corr = sc > NEG_HALF ? __fadd_rn(sc, delta) : LOG_ZERO;
        const uint4 r0 = make_uint4(keys[i], ~(uint32_t)e, ord_key(corr),
                                    __float_as_uint(corr));
        const uint4 r1 = make_uint4(__float_as_uint(lm), (uint32_t)p,
                                    (uint32_t)ectx, (uint32_t)w);
        const int slot = (int)slot_base + s;
        if (CL) {
            const uint32_t dst = cta_addr(rec + 2 * slot);
            const uint32_t bar = cta_addr(&bars[BAR_REC]);
            for (int j = 0; j < C; ++j) {
                send4(peer_addr(dst, j), r0, peer_addr(bar, j));
                send4(peer_addr(dst + 16, j), r1, peer_addr(bar, j));
            }
        } else {
            rec[2 * slot] = r0;
            rec[2 * slot + 1] = r1;
        }
    }
    if (CL) {
        bar_wait(&bars[BAR_REC], 0);
    } else {
        __syncthreads();
    }
    STAMP(8);

    // ---- 6. block r ranks the r-th C-th of the records among all k and
    // writes those in the top m; on rank 0 warp 0 takes the winner
    // meanwhile, and the fills past m follow
    const int m_eff = min(M, k);
    const size_t ob = (size_t)b * M;
    const bool win = rank == 0 && a.t != nullptr;
    if (win && warp == 0)
        winner(rec, k, m_eff, a, b, t_frame);
    else
        rank_write(rec, k, (int)((long long)rank * k / C),
                   (int)((long long)(rank + 1) * k / C), m_eff, a, ob,
                   win ? 32 : 0, win ? nthreads - 32 : nthreads);
    STAMP_SYNC();
    STAMP(9);
    if (rank == 0)
        for (int j = m_eff + tid; j < M; j += nthreads) {
            a.o_word[ob + j] = -1;
            a.o_score[ob + j] = LOG_ZERO;
            a.o_lm[ob + j] = 0.0f;
            a.o_prev[ob + j] = -1;
            a.o_begin[ob + j] = 0;
            a.o_ectx[ob + j] = -1;
        }
    STAMP_SYNC();
    STAMP(10);
}

// Opt both instances into SMEM_MAX bytes of dynamic shared memory on the
// current device, once.
static cudaError_t opt_in(int* dev_out) {
    static bool opted[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!opted[dev]) {
        err = cudaFuncSetAttribute(word_end_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_MAX);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(word_end_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_MAX);
        if (err != cudaSuccess) return err;
        opted[dev] = true;
    }
    *dev_out = dev;
    return cudaSuccess;
}

static bool plan_ok(int C, int threads) {
    return (C == 1 || C == 2 || C == 4 || C == MAX_CLUSTER) &&
           threads >= 256 && threads <= MAX_THREADS && threads % 32 == 0;
}

static cudaLaunchConfig_t cluster_config(int blocks, int C, int threads,
                                         size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

extern "C" {

#ifdef WORD_END_PHASES
// The stamps' phase names, comma-separated: stamp p + 1 ends phase p.
const char* word_end_phase_names(void) {
    return "keys,radix24,radix16,radix8,radix0,count,collect,probes,"
           "rank_write_winner,fills";
}

// Copy the stamps of the first `blocks` blocks of the last launch to
// host memory `dst`: [blocks, N_STAMPS, 2] of (clock64, globaltimer ns),
// zero where a block wrote none; then zero them on the card.
int word_end_phase_stamps(void* dst, int blocks) {
    if (blocks < 0 || blocks > STAMP_BLOCKS)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemcpyFromSymbol(
        dst, g_stamps, (size_t)blocks * N_STAMPS * 2 * sizeof(u64));
    if (err != cudaSuccess) return (int)err;
    void* p = nullptr;
    err = cudaGetSymbolAddress(&p, g_stamps);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemset(p, 0, sizeof(g_stamps));
}
#endif

// Shared memory one block of `threads` takes: the records and own
// candidates of k candidates, the histograms of a cluster of C, and the
// block's ceil(Ex / C) keys and compact list (rounded up to a multiple
// of the threads) unless keys_in_shared is 0.
size_t word_end_smem_bytes(int Ex, int k, int C, int threads,
                           int keys_in_shared) {
    Layout L(k, C);
    const size_t nb = (size_t)((Ex + C - 1) / C);
    const size_t list = (nb + threads - 1) / threads * threads;
    return L.keys() + (keys_in_shared ? 4 * (nb + list) : 0);
}

// How many clusters of C blocks of `threads` threads with `smem` bytes
// of shared memory each the current card runs at once (C = 1: blocks),
// or minus a CUDA error code.
int word_end_max_clusters(int C, int threads, long long smem) {
    if (!plan_ok(C, threads) || smem < 0 || smem > SMEM_MAX)
        return -(int)cudaErrorInvalidValue;
    int dev = 0, n = 0;
    cudaError_t err = opt_in(&dev);
    if (err != cudaSuccess) return -(int)err;
    if (C == 1) {
        int sms = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, word_end_kernel<false>, threads, (size_t)smem);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
        return err != cudaSuccess ? -(int)err : n * sms;
    }
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(C, C, threads, (size_t)smem,
                                            nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(&n, word_end_kernel<true>, &cfg);
    return err != cudaSuccess ? -(int)err : n;
}

// One launch over B rows on `stream`, a cluster of C blocks of `threads`
// threads a row (C = 1: one block, no cluster).  Returns a CUDA error
// code (0 on success); an argument the kernel cannot take returns
// cudaErrorInvalidValue without launching.
int word_end_launch(
    const float* score, const int* ctx, const int* prev, long long ld,
    int B, int Ex, const long long* exit_nodes, const float* exit_nlp,
    const int* exit_w, const int* exit_wlm, const float* exit_uni,
    const unsigned char* exit_transp, const float* ctx_info,
    const int* bi_rows, int H, int wide, int n_words, int lm_on, int swap,
    float lw, float pen, int M, int C, int threads, const int* t,
    unsigned* keys_g, int* o_word, float* o_score, float* o_lm, int* o_prev,
    int* o_begin, int* o_ectx, float* o_ent, int* o_ectx_e, int* o_eprev,
    void* stream) {
    if (B < 1 || Ex < 0 || M < 1 || ld < 1 || !plan_ok(C, threads))
        return (int)cudaErrorInvalidValue;
    if ((long long)B * C > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (lm_on && (H < 16 || (H & (H - 1)) != 0 || !ctx_info || !bi_rows))
        return (int)cudaErrorInvalidValue;
    int k = Ex < 2 * M ? Ex : 2 * M;
    size_t smem = word_end_smem_bytes(Ex, k, C, threads, keys_g == nullptr);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = opt_in(&dev);
    if (err != cudaSuccess) return (int)err;
    Args a;
    a.score = score; a.ctx = ctx; a.prev = prev; a.ld = ld; a.Ex = Ex;
    a.exit_nodes = exit_nodes; a.exit_nlp = exit_nlp; a.exit_w = exit_w;
    a.exit_wlm = exit_wlm; a.exit_uni = exit_uni; a.exit_transp = exit_transp;
    a.ctx_info = ctx_info; a.bi_rows = bi_rows; a.H = (uint32_t)H;
    a.wide = wide; a.n_words = (uint32_t)n_words; a.lm_on = lm_on;
    a.swap = swap; a.lw = lw; a.pen = pen; a.M = M; a.k = k; a.C = C;
    a.t = t; a.keys_g = keys_g; a.o_word = o_word; a.o_score = o_score;
    a.o_lm = o_lm; a.o_prev = o_prev; a.o_begin = o_begin;
    a.o_ectx = o_ectx; a.o_ent = o_ent; a.o_ectx_e = o_ectx_e;
    a.o_eprev = o_eprev;
    if (C == 1) {
        word_end_kernel<false><<<B, threads, smem, (cudaStream_t)stream>>>(a);
        return (int)cudaGetLastError();
    }
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(B * C, C, threads, smem,
                                            (cudaStream_t)stream, &attr);
    err = cudaLaunchKernelEx(&cfg, word_end_kernel<true>, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
