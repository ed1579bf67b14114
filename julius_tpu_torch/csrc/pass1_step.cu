// One pass-1 frame of the node-domain Viterbi beam update, for Hopper.
//
// Replaces the TPU kernel `_step_kernel` launched by `fused_step`
// (julius_tpu/ops/pass1_kernel.py:49, pallas_call at :127).  For each
// utterance b and network node n:
//   1. in-word max over k = 0..K of score[b, n-k] + loc_lp[k, n]; ties go
//      to the smallest k and the winner's ctx/prev ride along; n-k < 0
//      reads LOG_ZERO / -1;
//   2. cross-word entry ent_s[b] + entry_total[n], only where
//      entry_total > NEG_HALF, replacing the in-word value only if
//      strictly greater and then carrying ectx_s[b] / eprev_s[b];
//   3. emission: merged + row[b, score_idx[n]] if merged > NEG_HALF,
//      else LOG_ZERO;
//   4. rows with frame_valid[b] false keep their old state.
// The f32 adds run in the plain version's order, so scores are
// bit-equal to it.
//
// Bound: memory traffic, not arithmetic (a handful of adds and compares
// a node).  A frame must read score/ctx/prev and write them anew:
// 6 * 4 * B * N bytes (115 MB at B = 64, N = 74,967), plus the tables
// once, (K+1) * N arc floats, N entry totals and N senone ids (16 B a
// node at K = 1), and the B x R frame row.
//
// The first design launched one thread per (b, n) on a grid of
// (N / 256, B) blocks, and was held back by four things; this design
// answers each:
//   1. Each of the B blocks over a node tile read that tile's tables
//      again (16 B a node, B times).  Here one block takes a tile across
//      all B rows: the tile's tables come into shared memory once and
//      serve every row (at B = 1, with no row to share them, the block
//      reads them itself).
//   2. Each thread did scalar 4-byte loads and stores.  Here a lane holds
//      four consecutive nodes, one 16-byte chunk of the flat [B * N]
//      state, loaded and stored with 16-byte vector accesses.
//   3. Loads waited on loads: the shifted reads score/ctx/prev[b, n-k]
//      went back through L1, and the gather row[b, score_idx[n]] waited
//      for score_idx[n].  Here the shifted reads are shuffles of the
//      chunks of the lanes in front (the first ceil(K / 4) lanes hold the
//      chunks in front of the tile, its halo), score_idx sits in shared
//      memory, and a warp has the next DEPTH rows' state and the next
//      row's emissions in flight while it computes one.
//   4. At B <= 4 the grid was a fraction of one wave.  Here the tile is
//      one warp wide (up to 124 nodes), so B = 1 still has 625 blocks at
//      N = 74,967; the launch plan (ops/pass1_kernel.py `launch_plan`)
//      gives a tile as many warps (rows shared between them) as keep
//      every block resident at once on the card.  A launch at B = 1 still
//      costs its fixed overhead and two dependent round trips (score_idx,
//      then the gather).
// The rows in flight are held in registers, not staged in shared memory
// through cp.async: the gathers read the frame rows through L1, and L1
// is what the SM's 256 KB leave over from shared memory.  Staging the
// state there (one block a tile walking the rows over a ring of
// mbarrier-tracked stages) measured slower than the first design at
// B = 64 and at the 20k-word configuration's B = 32.  The warps of an SM
// walk their rows in step, so they gather from the same few frame rows;
// the state is read without taking L1 lines, and where the three outputs
// outgrow L2 they are stored with the streaming hint.
// Alignment: a chunk is 16 bytes of the flat state, so row b starts
// mid-chunk when N is not a multiple of 4.  The chunks at a tile's edges
// are shared with the neighbouring tile (each block stores its own nodes
// of them with scalar stores), the array's first and last chunks are read
// element by element where they reach past it, and the tables are read
// from shared memory at any offset (a padded layout keeps a warp's reads
// on distinct banks).  The wrapper requires the state arrays to start
// 16-byte aligned; `row` may have any stride.  The main path takes the
// aligned case: pass1_batch pads the node axis to a multiple of 4
// (search/pass1.py `kernel_tables`), so no chunk is shared and every
// store is a whole one.
// Outputs go to fresh buffers (the caller ping-pongs two state sets): a
// tile's halo is the previous tile's last K nodes, so an in-place update
// would race.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (julius_tpu_torch/ops/pass1_kernel.py loads it with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#define LOG_ZERO (-1.0e10f)
#define NEG_HALF (-0.5e10f)
#define MAX_K1 9
#define MAX_WARPS 8
#define DEPTH 2           // rows of state a warp has in flight past the
                          // one it computes

struct StepArgs {
  const float* score;        // [B, N]
  const int* ctx;            // [B, N]
  const int* prev;           // [B, N]
  const float* loc_lp;       // [K1, N]
  const float* entry_total;  // [N]
  const float* row;          // [B, row_stride]
  long long row_stride;
  const int* score_idx;      // [N]
  const float* ent_s;        // [B]
  const int* ectx_s;         // [B]
  const int* eprev_s;        // [B]
  const uint8_t* frame_valid;  // [B]
  float* o_score;
  int* o_ctx;
  int* o_prev;
  int batch, n_nodes;
  int tab_stride;    // words a tile row takes in shared memory
  int stream_out;    // store with the streaming hint (evict first)
};

// Lanes holding the chunks in front of a tile (its halo of K nodes), and
// the nodes a tile: the other lanes less one cover it at any alignment.
template <int K1>
__host__ __device__ constexpr int halo_lanes() { return (K1 + 2) / 4; }
template <int K1>
__host__ __device__ constexpr int tile_nodes() {
  return 4 * (31 - halo_lanes<K1>());
}

// Position of node x of a tile in a shared-memory row of it: one pad
// word every 32, so the warp's reads at x = 4 * lane + c fall on 32
// distinct banks.
__device__ __forceinline__ int tab_pos(int x) { return x + (x >> 5); }

// 16 bytes of state that no thread writes in this launch, through the
// read-only path without taking L1 lines (L1 is kept for the frame rows
// the emissions are gathered from).
__device__ __forceinline__ float4 ld_stream(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0,%1,%2,%3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ int4 ld_stream(const int* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// One 16-byte chunk of each state array: the flat elements 4q..4q+3.
struct Chunk {
  float s[4];
  int c[4], p[4];

  // A chunk reaching past either end of the array is read element by
  // element; the elements outside it stand for n - k < 0 or n >= N and
  // are never used.
  __device__ __forceinline__ void load(const StepArgs& a, long long q,
                                       long long total) {
    const long long e = 4 * q;
    if (e >= 0 && e + 4 <= total) {
      const float4 v = ld_stream(a.score + e);
      const int4 c4 = ld_stream(a.ctx + e);
      const int4 p4 = ld_stream(a.prev + e);
      s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
      c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
      p[0] = p4.x; p[1] = p4.y; p[2] = p4.z; p[3] = p4.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = e + i >= 0 && e + i < total;
        s[i] = in ? __ldg(a.score + e + i) : LOG_ZERO;
        c[i] = in ? __ldg(a.ctx + e + i) : -1;
        p[i] = in ? __ldg(a.prev + e + i) : -1;
      }
    }
  }
};

// One row's scalars: its entry candidate and whether the frame is valid.
struct RowScalars {
  float ent;
  int ectx, eprev;
  bool fv;

  __device__ __forceinline__ void load(const StepArgs& a, int b) {
    fv = __ldg(a.frame_valid + b) != 0;
    ent = __ldg(a.ent_s + b);
    ectx = __ldg(a.ectx_s + b);
    eprev = __ldg(a.eprev_s + b);
  }
};

// Table row r (r < K1: the arc row loc_lp[r], K1: the entry totals) at
// node n of the tile from t0: from the tile's rows in shared memory or,
// with ONE_ROW (a single row, so nothing to share them with), from global
// memory.  Nodes outside the tile read a clamped one; they are never
// stored.
template <int K1, bool ONE_ROW>
__device__ __forceinline__ float table(const StepArgs& a, const float* tab,
                                       int r, int n, int t0) {
  if (ONE_ROW) {
    const int m = min(max(n, 0), a.n_nodes - 1);
    return __ldg(r < K1 ? a.loc_lp + (size_t)r * a.n_nodes + m
                        : a.entry_total + m);
  }
  return tab[r * a.tab_stride
             + tab_pos(min(max(n - t0, 0), tile_nodes<K1>() - 1))];
}

// Lane `lane`'s chunk of row b of the tile [t0, t1): the first
// halo_lanes hold the chunks in front of the tile (its halo of K nodes),
// the others the tile's own.
template <int K1>
__device__ __forceinline__ long long lane_chunk(const StepArgs& a, int t0,
                                                int b, int lane) {
  return (((long long)b * a.n_nodes + t0) >> 2) - halo_lanes<K1>() + lane;
}

// This lane's four emissions row[b, score_idx[n]] (0 outside the tile),
// score_idx from the tile's tables in shared memory or, with sidx null,
// from global memory.
template <int K1>
__device__ __forceinline__ void gather(const StepArgs& a, int t0, int t1,
                                       int b, int lane, const int* sidx,
                                       float (&g)[4]) {
  const float* row = a.row + b * a.row_stride;
  const int n0 = (int)(4 * lane_chunk<K1>(a, t0, b, lane)
                       - (long long)b * a.n_nodes);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + i;
    g[i] = n < t0 || n >= t1 ? 0.0f
           : __ldg(row + (sidx ? sidx[tab_pos(n - t0)]
                               : __ldg(a.score_idx + n)));
  }
}

// Row b of the tile from this lane's chunk `ch` (past the halo): its
// nodes inside [t0, t1) updated and stored.  The shifted reads n - k
// come from the chunks of the lanes in front, by shuffles.
template <int K1, bool ONE_ROW>
__device__ __forceinline__ void step_row(const StepArgs& a, int t0, int t1,
                                         int b, int lane, const Chunk& ch,
                                         const float (&g)[4],
                                         const RowScalars& rs,
                                         const float* tab) {
  constexpr int K = K1 - 1;
  const long long q = lane_chunk<K1>(a, t0, b, lane);
  const int n0 = (int)(4 * q - (long long)b * a.n_nodes);
  float os[4], inw[4];
  int oc[4], op[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    os[i] = ch.s[i];
    oc[i] = ch.c[i];
    op[i] = ch.p[i];
    inw[i] = ch.s[i] + table<K1, ONE_ROW>(a, tab, 0, n0 + i, t0);
  }
  // running strict-> max from k = 0: the first (smallest) k wins ties;
  // every lane shuffles, the halo lanes too
#pragma unroll
  for (int k = 1; k <= K; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i - k;                 // element offset from 4q
      const int d = (j - 3) / 4;           // chunk offset: 0, -1 or -2
      const int pos = j - 4 * d;           // element within that chunk
      float hs = ch.s[pos];
      int hc = ch.c[pos], hp = ch.p[pos];
      if (d != 0) {
        hs = __shfl_sync(0xffffffffu, hs, lane + d);
        hc = __shfl_sync(0xffffffffu, hc, lane + d);
        hp = __shfl_sync(0xffffffffu, hp, lane + d);
      }
      if (n0 + i < k) {                    // n - k < 0
        hs = LOG_ZERO;
        hc = -1;
        hp = -1;
      }
      const float cand = hs + table<K1, ONE_ROW>(a, tab, k, n0 + i, t0);
      if (cand > inw[i]) {
        inw[i] = cand;
        oc[i] = hc;
        op[i] = hp;
      }
    }
  }
  if (lane < halo_lanes<K1>() || n0 + 3 < t0 || n0 >= t1) return;
  if (rs.fv) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float et = table<K1, ONE_ROW>(a, tab, K1, n0 + i, t0);
      const float cand_e = et > NEG_HALF ? rs.ent + et : LOG_ZERO;
      float m = inw[i];
      if (cand_e > m) {
        m = cand_e;
        oc[i] = rs.ectx;
        op[i] = rs.eprev;
      }
      os[i] = m > NEG_HALF ? m + g[i] : LOG_ZERO;
    }
  } else {
    // a frozen row keeps its state
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      oc[i] = ch.c[i];
      op[i] = ch.p[i];
    }
  }
  const long long f = 4 * q;
  if (n0 >= t0 && n0 + 3 < t1) {
    const float4 vs = make_float4(os[0], os[1], os[2], os[3]);
    const int4 vc = make_int4(oc[0], oc[1], oc[2], oc[3]);
    const int4 vp = make_int4(op[0], op[1], op[2], op[3]);
    float4* ps = reinterpret_cast<float4*>(a.o_score + f);
    int4* pc = reinterpret_cast<int4*>(a.o_ctx + f);
    int4* pp = reinterpret_cast<int4*>(a.o_prev + f);
    if (a.stream_out) {
      // a state larger than L2 is not read back from it: stream it out
      __stcs(ps, vs);
      __stcs(pc, vc);
      __stcs(pp, vp);
    } else {
      *ps = vs;
      *pc = vc;
      *pp = vp;
    }
  } else {
    // a chunk shared with the neighbouring tile or row: own nodes only
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + i;
      if (n < t0 || n >= t1) continue;
      a.o_score[f + i] = os[i];
      a.o_ctx[f + i] = oc[i];
      a.o_prev[f + i] = op[i];
    }
  }
}

// One block a tile of tile_nodes nodes.  Its tables come into shared
// memory once, for all B rows (ONE_ROW, B = 1: the one warp reads them
// itself); its W warps share the rows, warp w taking rows w, w + W, ...
// in order, with DEPTH rows of state in flight in registers and the next
// row's emissions gathered while it computes one.  The warps of an SM
// walk their rows in step, so they gather from the same few frame rows
// and find them in L1.
template <int K1, bool ONE_ROW>
__global__ void __launch_bounds__(32 * MAX_WARPS)
pass1_step_kernel(const StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem_base[];
  float* tab = reinterpret_cast<float*>(smem_base);
  const int* sidx = reinterpret_cast<const int*>(tab + (K1 + 1) * a.tab_stride);
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * tile_nodes<K1>();
  const int t1 = min(t0 + tile_nodes<K1>(), a.n_nodes);
  const long long total = (long long)a.batch * a.n_nodes;
  const int rows = warp < a.batch ? (a.batch - warp + W - 1) / W : 0;

  // this warp's first DEPTH rows, its first row's emissions (score_idx
  // from global memory) and scalars, then the tile's tables, once
  Chunk ring[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (d < rows)
      ring[d].load(a, lane_chunk<K1>(a, t0, warp + d * W, lane), total);
  float g[4];
  RowScalars rs;
  if (rows > 0) {
    gather<K1>(a, t0, t1, warp, lane, nullptr, g);
    rs.load(a, warp);
  }
  if (ONE_ROW) {
    // the tables would serve one row once: it reads them itself
    if (rows > 0)
      step_row<K1, true>(a, t0, t1, 0, lane, ring[0], g, rs, nullptr);
    return;
  }
  for (int x = threadIdx.x; x < t1 - t0; x += blockDim.x) {
    const int p = tab_pos(x);
    const int n = t0 + x;
#pragma unroll
    for (int k = 0; k < K1; ++k)
      tab[k * a.tab_stride + p] = __ldg(a.loc_lp + (size_t)k * a.n_nodes + n);
    tab[K1 * a.tab_stride + p] = __ldg(a.entry_total + n);
    reinterpret_cast<int*>(tab)[(K1 + 1) * a.tab_stride + p] =
        __ldg(a.score_idx + n);
  }
  __syncthreads();
  if (rows == 0) return;

  for (int r = 0; r < rows; ++r) {
    const int b = warp + r * W;
    const Chunk cur = ring[0];
#pragma unroll
    for (int d = 0; d + 1 < DEPTH; ++d) ring[d] = ring[d + 1];
    if (r + DEPTH < rows)
      ring[DEPTH - 1].load(a, lane_chunk<K1>(a, t0, b + DEPTH * W, lane),
                           total);
    // the next row's emissions and scalars load while this one is
    // computed
    float g_next[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    RowScalars rs_next = rs;
    if (r + 1 < rows) {
      gather<K1>(a, t0, t1, b + W, lane, sidx, g_next);
      rs_next.load(a, b + W);
    }
    step_row<K1, false>(a, t0, t1, b, lane, cur, g, rs, tab);
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = g_next[i];
    rs = rs_next;
  }
}

template <int K1>
static int launch_k(const StepArgs& a, int threads, int smem,
                    cudaStream_t stream) {
  const int grid = (a.n_nodes + tile_nodes<K1>() - 1) / tile_nodes<K1>();
  if (a.batch == 1)
    pass1_step_kernel<K1, true><<<grid, threads, 0, stream>>>(a);
  else
    pass1_step_kernel<K1, false><<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K1>
static int occupancy_k(int threads, int smem, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, pass1_step_kernel<K1, false>, threads, smem);
}

#define K1_SWITCH(k1, CALL)                                              \
  switch (k1) {                                                          \
    case 1: return CALL(1);                                              \
    case 2: return CALL(2);                                              \
    case 3: return CALL(3);                                              \
    case 4: return CALL(4);                                              \
    case 5: return CALL(5);                                              \
    case 6: return CALL(6);                                              \
    case 7: return CALL(7);                                              \
    case 8: return CALL(8);                                              \
    default: return CALL(9);                                             \
  }

// The launch plan (warps a block, tab_stride, smem_bytes, stream_out)
// comes from ops/pass1_kernel.py `launch_plan`; a plan that does not fit
// the kernel is refused with cudaErrorInvalidValue.  The grid is one
// block a tile.
extern "C" int pass1_step_launch(
    const void* score, const void* ctx, const void* prev, const void* loc_lp,
    int k1, const void* entry_total, const void* row, long long row_stride,
    const void* score_idx, const void* ent_s, const void* ectx_s,
    const void* eprev_s, const void* frame_valid, void* o_score, void* o_ctx,
    void* o_prev, int batch, int n_nodes, void* stream, int warps,
    int tab_stride, int smem_bytes, int stream_out) {
  if (k1 < 1 || k1 > MAX_K1 || batch < 1 || n_nodes < 1 || warps < 1
      || warps > MAX_WARPS || tab_stride < 124 + 124 / 32
      || smem_bytes < 4LL * (k1 + 2) * tab_stride || smem_bytes > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  StepArgs a;
  a.score = (const float*)score;
  a.ctx = (const int*)ctx;
  a.prev = (const int*)prev;
  a.loc_lp = (const float*)loc_lp;
  a.entry_total = (const float*)entry_total;
  a.row = (const float*)row;
  a.row_stride = row_stride;
  a.score_idx = (const int*)score_idx;
  a.ent_s = (const float*)ent_s;
  a.ectx_s = (const int*)ectx_s;
  a.eprev_s = (const int*)eprev_s;
  a.frame_valid = (const uint8_t*)frame_valid;
  a.o_score = (float*)o_score;
  a.o_ctx = (int*)o_ctx;
  a.o_prev = (int*)o_prev;
  a.batch = batch;
  a.n_nodes = n_nodes;
  a.tab_stride = tab_stride;
  a.stream_out = stream_out;
  const int threads = 32 * warps;
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(K) launch_k<K>(a, threads, smem_bytes, st)
  K1_SWITCH(k1, LAUNCH)
#undef LAUNCH
}

// Blocks of `warps` warps with `smem_bytes` of shared memory that one SM
// holds at once (registers decide it), into *blocks.
extern "C" int pass1_step_blocks_per_sm(int k1, int warps, int smem_bytes,
                                        int* blocks) {
  if (k1 < 1 || k1 > MAX_K1 || warps < 1 || warps > MAX_WARPS)
    return (int)cudaErrorInvalidValue;
#define OCCUPANCY(K) occupancy_k<K>(32 * warps, smem_bytes, blocks)
  K1_SWITCH(k1, OCCUPANCY)
#undef OCCUPANCY
}

__global__ void empty_kernel() {}

// An empty launch on the same stream: the floor a launch of this
// library costs, timed the same way as the kernel.
extern "C" int pass1_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
