// What a thread-block cluster costs on this card, in SM clock cycles: the
// numbers behind csrc/word_end.cu's choice to exchange its histograms with
// st.async into distributed shared memory instead of cluster barriers.
// One probe kernel a launch, timed with clock64() inside the block:
//   * a cluster barrier as cooperative_groups' cluster.sync() issues it,
//     the same with relaxed semantics (no memory ordering), with
//     release / acquire, and a release fence at cluster scope alone;
//   * a block barrier;
//   * a chain of dependent loads from a peer block's shared memory and
//     from the block's own;
//   * a ping-pong between ranks 0 and 1: thread 0 arrives on the peer's
//     mbarrier (release at cluster scope), the whole block waits on its
//     own: one hop.
// Built with nvcc for sm_90a into a shared library with a plain C
// interface; tools/probe_cluster.py loads it with ctypes and prints the
// table.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define N_OUT 8

__device__ __forceinline__ uint32_t cta_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
    for (uint32_t spins = 0;; ++spins) {
        uint32_t done;
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
            "[%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(cta_addr(bar)), "r"(parity) : "memory");
        if (done) return;
        if (spins == (1u << 24)) __trap();
    }
}

__global__ void __launch_bounds__(1024) probe(int iters, long long* out) {
    __shared__ int sm[1024];
    __shared__ uint64_t bar;
    cg::cluster_group cl = cg::this_cluster();
    const unsigned rank = cl.block_rank(), C = cl.num_blocks();
    sm[threadIdx.x] = threadIdx.x + 1;
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(cta_addr(&bar)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cl.sync();
    long long t[N_OUT + 1];
    t[0] = clock64();
    for (int i = 0; i < iters; ++i) cl.sync();
    t[1] = clock64();
    for (int i = 0; i < iters; ++i)
        asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\t"
                     "barrier.cluster.wait.aligned;" ::: "memory");
    t[2] = clock64();
    for (int i = 0; i < iters; ++i)
        asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                     "barrier.cluster.wait.acquire.aligned;" ::: "memory");
    t[3] = clock64();
    for (int i = 0; i < iters; ++i)
        asm volatile("fence.acq_rel.cluster;" ::: "memory");
    t[4] = clock64();
    for (int i = 0; i < iters; ++i) __syncthreads();
    t[5] = clock64();
    int v = 0;
    if (threadIdx.x == 0) {
        const int* peer = cl.map_shared_rank(sm, (rank + 1) % C);
        int j = 0;
        for (int i = 0; i < iters; ++i) {
            j = peer[j & 7];
            v += j;
        }
    }
    t[6] = clock64();
    if (threadIdx.x == 0) {
        const volatile int* own = sm;
        int j = 0;
        for (int i = 0; i < iters; ++i) {
            j = own[j & 7];
            v += j;
        }
    }
    t[7] = clock64();
    cl.sync();
    uint32_t peer_bar = 0;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(peer_bar) : "r"(cta_addr(&bar)), "r"(rank ^ 1u));
    const long long h0 = clock64();
    if (C > 1 && rank < 2)
        for (int i = 0; i < iters; ++i) {
            if (rank == 1) wait_parity(&bar, i & 1);
            if (threadIdx.x == 0)
                asm volatile("mbarrier.arrive.release.cluster.shared::cluster"
                             ".b64 _, [%0];" :: "r"(peer_bar) : "memory");
            if (rank == 0) wait_parity(&bar, i & 1);
        }
    t[8] = clock64() - h0 + t[7];
    cl.sync();
    if (threadIdx.x == 0 && blockIdx.x == 0) {
        for (int i = 0; i < N_OUT; ++i) out[i] = (t[i + 1] - t[i]) / iters;
        out[7] /= 2;                       // a round trip is two hops
        out[N_OUT] = v;
    }
}

extern "C" {

// One probe launch: a grid of C blocks of `threads` threads, one cluster;
// out[0..7] receives the cycles of a cluster.sync(), a relaxed cluster
// barrier, a release / acquire one, a cluster-scope fence, a block
// barrier, a dependent load from a peer's shared memory and from the
// block's own, and one mbarrier hop (0 when C = 1).  Returns a CUDA error
// code.
int cluster_probe(int C, int threads, long long* out) {
    long long* d = nullptr;
    cudaError_t err = cudaMalloc(&d, (N_OUT + 1) * sizeof(long long));
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(threads);
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, probe, 200, d);
    if (err == cudaSuccess) err = cudaDeviceSynchronize();
    if (err == cudaSuccess)
        err = cudaMemcpy(out, d, N_OUT * sizeof(long long),
                         cudaMemcpyDeviceToHost);
    cudaFree(d);
    return (int)err;
}

}  // extern "C"
