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
//
// Bound: memory traffic, not arithmetic (a handful of adds and compares
// per node).  A frame must read score/ctx/prev and write them anew:
// 6 * 4 * B * N bytes (115 MB at B = 64, N = 74,967), plus (K+1) * N
// loc_lp floats, N entry totals, N senone ids and the B x R frame row,
// about 1 MB more.  The design does this:
//   - one thread per (b, n), n fastest across threads, so every state
//     load and store is coalesced;
//   - the K shifted reads of score/ctx/prev hit the lines the
//     neighbouring threads of the same warp just loaded, so they come
//     from L1/L2 and not again from device memory: no halo tiles;
//   - the outprob gather row[b, score_idx[n]] is fused in, so no [B, N]
//     out_node tensor is written and read back (19 MB a frame at B = 64);
//   - frozen rows copy their state and skip the arithmetic.
// Outputs go to fresh buffers (the caller ping-pongs two state sets):
// thread n reads the old state at n-1..n-K, so an in-place update
// would race.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (julius_tpu_torch/ops/pass1_kernel.py loads it with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#define LOG_ZERO (-1.0e10f)
#define NEG_HALF (-0.5e10f)

__global__ void pass1_step_kernel(
    const float* __restrict__ score, const int* __restrict__ ctx,
    const int* __restrict__ prev, const float* __restrict__ loc_lp,
    int k1, const float* __restrict__ entry_total,
    const float* __restrict__ row, long long row_stride,
    const int* __restrict__ score_idx, const float* __restrict__ ent_s,
    const int* __restrict__ ectx_s, const int* __restrict__ eprev_s,
    const uint8_t* __restrict__ frame_valid, float* __restrict__ o_score,
    int* __restrict__ o_ctx, int* __restrict__ o_prev, int n_nodes) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= n_nodes) return;
  const size_t base = (size_t)b * n_nodes;
  const float s0 = score[base + n];
  const int c0 = ctx[base + n];
  const int p0 = prev[base + n];
  if (!frame_valid[b]) {
    o_score[base + n] = s0;
    o_ctx[base + n] = c0;
    o_prev[base + n] = p0;
    return;
  }
  // running strict-> max from k = 0: the first (smallest) k wins ties
  float inw = s0 + loc_lp[n];
  int cw = c0, pw = p0;
  for (int k = 1; k < k1; ++k) {
    float hs = LOG_ZERO;
    int hc = -1, hp = -1;
    if (n >= k) {
      hs = score[base + n - k];
      hc = ctx[base + n - k];
      hp = prev[base + n - k];
    }
    const float cand = hs + loc_lp[(size_t)k * n_nodes + n];
    if (cand > inw) {
      inw = cand;
      cw = hc;
      pw = hp;
    }
  }
  const float et = entry_total[n];
  const float cand_e = et > NEG_HALF ? ent_s[b] + et : LOG_ZERO;
  if (cand_e > inw) {
    inw = cand_e;
    cw = ectx_s[b];
    pw = eprev_s[b];
  }
  o_score[base + n] =
      inw > NEG_HALF ? inw + row[b * row_stride + score_idx[n]] : LOG_ZERO;
  o_ctx[base + n] = cw;
  o_prev[base + n] = pw;
}

extern "C" int pass1_step_launch(
    const void* score, const void* ctx, const void* prev, const void* loc_lp,
    int k1, const void* entry_total, const void* row, long long row_stride,
    const void* score_idx, const void* ent_s, const void* ectx_s,
    const void* eprev_s, const void* frame_valid, void* o_score, void* o_ctx,
    void* o_prev, int batch, int n_nodes, void* stream) {
  const int threads = 256;
  const dim3 grid((n_nodes + threads - 1) / threads, batch);
  pass1_step_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)score, (const int*)ctx, (const int*)prev,
      (const float*)loc_lp, k1, (const float*)entry_total, (const float*)row,
      row_stride, (const int*)score_idx, (const float*)ent_s,
      (const int*)ectx_s, (const int*)eprev_s, (const uint8_t*)frame_valid,
      (float*)o_score, (int*)o_ctx, (int*)o_prev, n_nodes);
  return (int)cudaGetLastError();
}
