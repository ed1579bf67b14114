// Pass 1's word-end stage, for Hopper: the corrected word-end records of
// one frame and the cross-word winner, one block a batch row.
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
// a row costs is its chain of dependent steps: the gather, four radix
// passes with four block barriers each, two rankings and the probe
// chain (exit -> ctx -> ctx_info -> table rows).
//
// Design, one block of THREADS threads a row:
//   * each exit score becomes an order-preserving uint32 key (larger key,
//     larger score; -0 and +0 one key, as the stable sort sees them
//     equal), kept in shared memory (in a global scratch row when Ex is
//     too large for it).  The gather is the longest chain of a row
//     (node id, then score), so a thread starts the loads of KEY_BATCH
//     exits before it uses any;
//   * an exact radix select finds the k-th largest key in four 8-bit
//     passes over a 256-bin shared histogram.  Most of a row's exits sit
//     at LOG_ZERO, so a warp's equal digits are added once
//     (__match_any_sync) rather than by 32 atomics on one bin;
//   * every key above the k-th is a candidate, and so are the lowest-
//     index keys equal to it, as many as are still needed: a count per
//     warp over contiguous index ranges, then one ordered pass;
//   * the k candidates are ranked by (key, -index), which gives
//     lax.top_k's order: a candidate's rank is the count of larger keys,
//     taken by a few threads a candidate at once (`rank_scatter`: one
//     barrier, where a bitonic sorting network took one a step, 21 at
//     k = 64 and 36 at k = 256, and took 4 us more a row on an H100);
//   * one thread a candidate gathers its payload and probes the 2-gram
//     table, keeping its fields in shared memory by stage-1 rank;
//   * a second ranking over (corrected key, -rank) re-ranks them to M,
//     and one thread a slot writes the atoms;
//   * warp 0 takes the first maximum over the M slots for the winner.
// A row of 20,000 exits and B = 32 rows fill 32 of the card's 132 SMs;
// splitting a row over several blocks is left until it is measured.
// The kernel allocates nothing and makes no host call: it runs inside
// pass 1's captured CUDA graphs.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (julius_tpu_torch/ops/word_end_kernel.py loads it with
// ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#define LOG_ZERO (-1.0e10f)
#define NEG_HALF (-0.5e10f)
#define THREADS 1024
#define KEY_BATCH 4           // exits a thread loads at once in step 1
#define MAX_PROBES 8
#define GOLDEN 0x9E3779B1u
#define SMEM_MAX 232448       // shared memory a block may opt into
#define MAX_DEVICES 64

typedef unsigned long long u64;

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
            if ((uint32_t)r[0] == vq && (uint32_t)r[1] == wq) {
                found = true;
                p = __fadd_rn(p, __int_as_float(r[2]));
            }
        }
    } else {
        uint32_t key = vq * n_words + wq;
        uint32_t slot = hash_u32(key) & mask;
#pragma unroll
        for (int i = 0; i < MAX_PROBES; ++i) {
            const int* r = rows + 2 * (size_t)((slot + i) & mask);
            if ((uint32_t)r[0] == key) {
                found = true;
                p = __fadd_rn(p, __int_as_float(r[1]));
            }
        }
    }
    float out = found ? p : __fadd_rn(v_bo, uni_w);
    return v_lm < 0 ? uni_w : out;
}

// The k distinct u64 values v[0..k) in shared memory, ranked in
// descending order: the value of rank p < limit leaves its low word,
// inverted, in out[p].  Its rank is the count of larger values, taken by
// g threads a value (a share of the others each, summed by shuffles), so
// the whole sort costs one barrier where a sorting network would cost
// one a step.  Called by the whole block; ends on a barrier.
__device__ void rank_scatter(const u64* v, int k, int limit, int* out) {
    int g = 32;
    while (g > 1 && g * k > (int)blockDim.x) g >>= 1;
    const int part = threadIdx.x % g;
    for (int base = 0; base < k; base += blockDim.x / g) {
        const int r = base + threadIdx.x / g;
        const u64 x = r < k ? v[r] : 0;
        int n = 0;
        if (r < k)
            for (int j = part; j < k; j += g) n += v[j] > x;
        for (int d = g >> 1; d > 0; d >>= 1)
            n += __shfl_xor_sync(0xffffffffu, n, d);
        if (r < k && part == 0 && n < limit) out[n] = (int)~(uint32_t)x;
    }
    __syncthreads();
}

// Shared memory: the candidates' composite keys, an order (exit by
// stage-1 rank, then stage-1 rank by slot), the fields by stage-1 rank,
// the histogram and a few words of block state, then the row's keys
// when they live here.
struct Layout {
    int k;
    __host__ __device__ explicit Layout(int k_) : k(k_) {}
    __host__ __device__ size_t cand() const { return 0; }
    __host__ __device__ size_t order() const { return cand() + 8 * (size_t)k; }
    __host__ __device__ size_t corr() const { return order() + 4 * (size_t)k; }
    __host__ __device__ size_t lm() const { return corr() + 4 * (size_t)k; }
    __host__ __device__ size_t prev() const { return lm() + 4 * (size_t)k; }
    __host__ __device__ size_t ectx() const { return prev() + 4 * (size_t)k; }
    __host__ __device__ size_t word() const { return ectx() + 4 * (size_t)k; }
    __host__ __device__ size_t hist() const { return word() + 4 * (size_t)k; }
    __host__ __device__ size_t state() const { return hist() + 4 * 256; }
    __host__ __device__ size_t keys() const { return state() + 4 * 64; }
};

// block state words
#define ST_BIN 0
#define ST_REM 1
#define ST_COUNT 2
#define ST_WARP 32            // one count a warp from here

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
    int M, k;
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

__global__ void __launch_bounds__(THREADS)
word_end_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout L(a.k);
    u64* cand = reinterpret_cast<u64*>(smem + L.cand());
    int* order = reinterpret_cast<int*>(smem + L.order());
    float* r_corr = reinterpret_cast<float*>(smem + L.corr());
    float* r_lm = reinterpret_cast<float*>(smem + L.lm());
    int* r_prev = reinterpret_cast<int*>(smem + L.prev());
    int* r_ectx = reinterpret_cast<int*>(smem + L.ectx());
    int* r_word = reinterpret_cast<int*>(smem + L.word());
    uint32_t* hist = reinterpret_cast<uint32_t*>(smem + L.hist());
    uint32_t* st = reinterpret_cast<uint32_t*>(smem + L.state());
    const int b = blockIdx.x;
    uint32_t* keys = a.keys_g ? a.keys_g + (size_t)b * a.Ex
                              : reinterpret_cast<uint32_t*>(smem + L.keys());
    const float* srow = a.score + (size_t)b * a.ld;
    const int* crow = a.ctx + (size_t)b * a.ld;
    const int* prow = a.prev + (size_t)b * a.ld;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const int Ex = a.Ex, k = a.k, M = a.M;

    // ---- 1. keys; a thread starts the loads of KEY_BATCH exits at once
    if (tid == 0) st[ST_COUNT] = 0;
    for (int base = tid; base < Ex; base += KEY_BATCH * blockDim.x) {
        long long nd[KEY_BATCH];
        float nl[KEY_BATCH], sv[KEY_BATCH];
#pragma unroll
        for (int j = 0; j < KEY_BATCH; ++j) {
            int i = base + j * blockDim.x;
            nd[j] = i < Ex ? a.exit_nodes[i] : 0;
            nl[j] = i < Ex ? a.exit_nlp[i] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < KEY_BATCH; ++j) {
            int i = base + j * blockDim.x;
            sv[j] = i < Ex ? srow[nd[j]] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < KEY_BATCH; ++j) {
            int i = base + j * blockDim.x;
            if (i < Ex) keys[i] = ord_key(__fadd_rn(sv[j], nl[j]));
        }
    }
    __syncthreads();

    // ---- 2. the k-th largest key: kth, and `rem`, how many of the keys
    // equal to it are taken (the lowest-index ones)
    const bool select = k < Ex;        // k == Ex takes every exit
    uint32_t kth = 0, prefix = 0, pmask = 0;
    int rem = 0;
    if (select) {
        rem = k;
        for (int shift = 24; shift >= 0; shift -= 8) {
            for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0;
            __syncthreads();
            for (int base = warp * 32; base < Ex; base += blockDim.x) {
                int i = base + lane;
                uint32_t key = i < Ex ? keys[i] : 0u;
                bool in = i < Ex && (key & pmask) == prefix;
                unsigned act = __ballot_sync(0xffffffffu, in);
                if (in) {
                    uint32_t bin = (key >> shift) & 255u;
                    unsigned peers = __match_any_sync(act, bin);
                    if (lane == __ffs(peers) - 1)
                        atomicAdd(&hist[bin], (uint32_t)__popc(peers));
                }
            }
            __syncthreads();
            if (warp == 0) {
                // lane l holds bins 255 - 8l ... 248 - 8l, high to low
                uint32_t c[8], s = 0;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    c[j] = hist[255 - 8 * lane - j];
                    s += c[j];
                }
                uint32_t incl = s;
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    uint32_t x = __shfl_up_sync(0xffffffffu, incl, d);
                    if (lane >= d) incl += x;
                }
                uint32_t excl = incl - s;
                if (excl < (uint32_t)rem && (uint32_t)rem <= incl) {
                    uint32_t cum = excl;
                    for (int j = 0; j < 8; ++j) {
                        if (cum + c[j] >= (uint32_t)rem) {
                            st[ST_BIN] = 255 - 8 * lane - j;
                            st[ST_REM] = rem - cum;
                            break;
                        }
                        cum += c[j];
                    }
                }
            }
            __syncthreads();
            prefix |= st[ST_BIN] << shift;
            pmask |= 255u << shift;
            rem = (int)st[ST_REM];
            __syncthreads();
        }
        kth = prefix;
    }

    // ---- 3. the k candidates, (key, ~index) each
    const int span = ((Ex + nwarps - 1) / nwarps + 31) & ~31;
    const int lo = min(warp * span, Ex), hi = min(lo + span, Ex);
    uint32_t eq_base = 0;
    if (select) {
        uint32_t n = 0;
        for (int base = lo; base < hi; base += 32) {
            int i = base + lane;
            n += __popc(__ballot_sync(0xffffffffu, i < hi && keys[i] == kth));
        }
        if (lane == 0) st[ST_WARP + warp] = n;
        __syncthreads();
        for (int w = 0; w < warp; ++w) eq_base += st[ST_WARP + w];
    }
    for (int base = lo; base < hi; base += 32) {
        int i = base + lane;
        uint32_t key = i < hi ? keys[i] : 0u;
        bool gt = i < hi && key > kth;
        bool eq = select && i < hi && key == kth;
        unsigned beq = __ballot_sync(0xffffffffu, eq);
        bool take = gt || (eq && eq_base + __popc(beq & lt) < (uint32_t)rem);
        eq_base += __popc(beq);
        unsigned bt = __ballot_sync(0xffffffffu, take);
        if (bt == 0) continue;
        uint32_t slot0 = 0;
        if (lane == 0) slot0 = atomicAdd(&st[ST_COUNT], (uint32_t)__popc(bt));
        slot0 = __shfl_sync(0xffffffffu, slot0, 0);
        if (take)
            cand[slot0 + __popc(bt & lt)] = ((u64)key << 32) | (uint32_t)~i;
    }
    __syncthreads();
    rank_scatter(cand, k, k, order);               // order[rank] = exit

    // ---- 4. payload, 2-gram probe and correction, by stage-1 rank; the
    // re-rank's key (corrected key, ~rank) replaces the candidate's
    for (int r = tid; r < k; r += blockDim.x) {
        int e = order[r];
        long long node = a.exit_nodes[e];
        float sc = __fadd_rn(srow[node], a.exit_nlp[e]);
        int c = crow[node];
        int w = a.exit_w[e], wlm = a.exit_wlm[e];
        float uni = a.exit_uni[e];
        float delta = 0.0f, lm = a.pen;
        if (a.lm_on) {
            int cq = c < 0 ? 0 : c;
            float v0 = a.ctx_info[2 * (size_t)cq];
            float vbo = a.ctx_info[2 * (size_t)cq + 1];
            int v_lm = c >= 0 ? (int)v0 : -1;
            float bi = bigram(a.bi_rows, a.H, a.wide, a.n_words, v_lm, vbo,
                              wlm, uni);
            if (wlm >= 0) {
                if (a.swap) delta = __fmul_rn(a.lw, __fsub_rn(bi, uni));
                lm = __fadd_rn(__fmul_rn(a.lw, bi), a.pen);
            }
        }
        float corr = sc > NEG_HALF ? __fadd_rn(sc, delta) : LOG_ZERO;
        r_corr[r] = corr;
        r_lm[r] = lm;
        r_prev[r] = prow[node];
        r_ectx[r] = a.exit_transp[e] ? c : w;
        r_word[r] = w;
        cand[r] = ((u64)ord_key(corr) << 32) | (uint32_t)~r;
    }
    __syncthreads();

    // ---- 5. re-rank to M, stable on the stage-1 rank: order[slot] = rank
    const int m_eff = min(M, k);
    rank_scatter(cand, k, m_eff, order);
    const size_t ob = (size_t)b * M;
    for (int j = tid; j < M; j += blockDim.x) {
        if (j < m_eff) {
            int r = order[j];
            float csc = r_corr[r];
            int p = r_prev[r];
            a.o_word[ob + j] = csc > NEG_HALF ? r_word[r] : -1;
            a.o_score[ob + j] = csc;
            a.o_lm[ob + j] = r_lm[r];
            a.o_prev[ob + j] = p;
            a.o_begin[ob + j] = p >= 0 ? p / M + 1 : 0;
            a.o_ectx[ob + j] = r_ectx[r];
        } else {
            a.o_word[ob + j] = -1;
            a.o_score[ob + j] = LOG_ZERO;
            a.o_lm[ob + j] = 0.0f;
            a.o_prev[ob + j] = -1;
            a.o_begin[ob + j] = 0;
            a.o_ectx[ob + j] = -1;
        }
    }

    // ---- 6. the winner: first maximum over the slots' scores, LOG_ZERO
    // for a slot without a word
    if (a.t != nullptr && warp == 0) {
        float best = 0.0f;
        int bj = -1;
        for (int j = lane; j < M; j += 32) {
            float v = LOG_ZERO;
            if (j < m_eff) {
                int r = order[j];
                if (r_corr[r] > NEG_HALF && r_word[r] >= 0) v = r_corr[r];
            }
            if (bj < 0 || v > best) {
                best = v;
                bj = j;
            }
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
            float ov = __shfl_down_sync(0xffffffffu, best, d);
            int oj = __shfl_down_sync(0xffffffffu, bj, d);
            if (oj >= 0 && (bj < 0 || ov > best || (ov == best && oj < bj))) {
                best = ov;
                bj = oj;
            }
        }
        if (lane == 0) {
            bool valid = false;
            int ectx = -1;
            if (bj < m_eff) {
                int r = order[bj];
                valid = r_corr[r] > NEG_HALF && r_word[r] >= 0;
                if (valid) ectx = r_ectx[r];
            }
            a.o_ent[b] = valid ? best : LOG_ZERO;
            a.o_ectx_e[b] = ectx;
            a.o_eprev[b] = (a.t[0] - 1) * M + bj;
        }
    }
}

extern "C" {

// Shared memory one block takes: the keys, order and fields of k
// candidates, and the row's Ex keys unless keys_in_shared is 0.
size_t word_end_smem_bytes(int Ex, int k, int keys_in_shared) {
    Layout L(k);
    return L.keys() + (keys_in_shared ? 4 * (size_t)Ex : 0);
}

// One launch over B rows on `stream`.  Returns a CUDA error code (0 on
// success); an argument the kernel cannot take returns
// cudaErrorInvalidValue without launching.
int word_end_launch(
    const float* score, const int* ctx, const int* prev, long long ld,
    int B, int Ex, const long long* exit_nodes, const float* exit_nlp,
    const int* exit_w, const int* exit_wlm, const float* exit_uni,
    const unsigned char* exit_transp, const float* ctx_info,
    const int* bi_rows, int H, int wide, int n_words, int lm_on, int swap,
    float lw, float pen, int M, const int* t, unsigned* keys_g,
    int* o_word, float* o_score, float* o_lm, int* o_prev, int* o_begin,
    int* o_ectx, float* o_ent, int* o_ectx_e, int* o_eprev, void* stream) {
    static bool opted[MAX_DEVICES];
    if (B < 1 || Ex < 0 || M < 1 || ld < 1)
        return (int)cudaErrorInvalidValue;
    if (lm_on && (H < 16 || (H & (H - 1)) != 0 || !ctx_info || !bi_rows))
        return (int)cudaErrorInvalidValue;
    int k = Ex < 2 * M ? Ex : 2 * M;
    size_t smem = word_end_smem_bytes(Ex, k, keys_g == nullptr);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!opted[dev]) {
        err = cudaFuncSetAttribute(word_end_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        opted[dev] = true;
    }
    Args a;
    a.score = score; a.ctx = ctx; a.prev = prev; a.ld = ld; a.Ex = Ex;
    a.exit_nodes = exit_nodes; a.exit_nlp = exit_nlp; a.exit_w = exit_w;
    a.exit_wlm = exit_wlm; a.exit_uni = exit_uni; a.exit_transp = exit_transp;
    a.ctx_info = ctx_info; a.bi_rows = bi_rows; a.H = (uint32_t)H;
    a.wide = wide; a.n_words = (uint32_t)n_words; a.lm_on = lm_on;
    a.swap = swap; a.lw = lw; a.pen = pen; a.M = M; a.k = k;
    a.t = t; a.keys_g = keys_g; a.o_word = o_word; a.o_score = o_score;
    a.o_lm = o_lm; a.o_prev = o_prev; a.o_begin = o_begin;
    a.o_ectx = o_ectx; a.o_ent = o_ent; a.o_ectx_e = o_ectx_e;
    a.o_eprev = o_eprev;
    word_end_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
