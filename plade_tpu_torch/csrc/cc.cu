// Morphological close + connected-component labelling for Hopper (sm_90a).
//
// K3  plade_close_and_label  replaces the Pallas kernels
//     plade_tpu/kernels/cc.py::close_and_label_lanes (and, at L = 1,
//     close_and_label): per lane, a G x G occupancy grid is closed with the
//     cross structuring element (dilate, erode, union with the occupied
//     cells), then labelled by `iters` Jacobi rounds of 3 x 3 min-label
//     propagation.  A closed cell's label is the minimum lane-local flat
//     index r * G + c of its 8-connected component (once converged); every
//     other cell holds G * G.
//
// What bounds it on the card: nothing in device memory.  One lane is
// G * G int32 in and out (16 KB at G = 64); the work is up to `iters`
// rounds of a 9-point stencil over shared memory, each ending on a block
// barrier, so one lane's time is the number of rounds it runs times the
// latency of one shared-memory sweep plus a barrier.  Lanes are
// independent and few (6 or 12 per extraction round).
//
// Design: one block per lane, 1024 threads, each owning every 1024-th cell.
// The grid lives in shared memory: a `closed` byte map and two int32 label
// buffers (2 * 16 KB + 4 KB at G = 64; G <= 128 takes 144 KB, opted in as
// dynamic shared memory).  Rounds are double-buffered Jacobi sweeps, as in
// the Pallas kernel: a round reads only the previous round's labels.  The
// loop stops after `iters` rounds or after the first round that changes no
// label (__syncthreads_or over the block): a round that changes nothing
// leaves a fixed point, so every later round would change nothing too, and
// the early stop returns bit for bit the labels of all `iters` rounds.
// Integer-only and without atomics, so the result is exact, also on grids
// that `iters` rounds do not converge.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxGrid = 128;
constexpr int kStaticSmemLimit = 48 * 1024;

size_t smem_bytes(int G) {
  const size_t cells = static_cast<size_t>(G) * G;
  return 2 * cells * sizeof(int) + cells;
}

__global__ void __launch_bounds__(kThreads)
    close_label_kernel(const int* __restrict__ occ, int* __restrict__ out,
                       int G, int iters) {
  extern __shared__ int smem[];
  const int GG = G * G;
  const int INF = GG;
  int* cur = smem;
  int* nxt = smem + GG;
  unsigned char* closed = reinterpret_cast<unsigned char*>(smem + 2 * GG);
  const int* src = occ + static_cast<size_t>(blockIdx.x) * GG;
  int* dst = out + static_cast<size_t>(blockIdx.x) * GG;

  // filled = min(occ, 1) for the non-negative counts the trim produces
  for (int i = threadIdx.x; i < GG; i += blockDim.x) cur[i] = src[i] > 0;
  __syncthreads();
  // dilate with the cross; out-of-grid cells count as 0
  for (int i = threadIdx.x; i < GG; i += blockDim.x) {
    const int r = i / G, c = i - r * G;
    int v = cur[i];
    if (r > 0) v |= cur[i - G];
    if (r < G - 1) v |= cur[i + G];
    if (c > 0) v |= cur[i - 1];
    if (c < G - 1) v |= cur[i + 1];
    nxt[i] = v;
  }
  __syncthreads();
  // erode the dilated grid; out-of-grid cells count as 1; union with filled
  for (int i = threadIdx.x; i < GG; i += blockDim.x) {
    const int r = i / G, c = i - r * G;
    int v = nxt[i];
    if (r > 0) v &= nxt[i - G];
    if (r < G - 1) v &= nxt[i + G];
    if (c > 0) v &= nxt[i - 1];
    if (c < G - 1) v &= nxt[i + 1];
    closed[i] = static_cast<unsigned char>(v | cur[i]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GG; i += blockDim.x)
    cur[i] = closed[i] ? i : INF;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    int changed = 0;
    for (int i = threadIdx.x; i < GG; i += blockDim.x) {
      const int old = cur[i];
      int v = INF;
      if (closed[i]) {
        const int r = i / G, c = i - r * G;
        const int r0 = r > 0 ? r - 1 : 0, r1 = r < G - 1 ? r + 1 : G - 1;
        const int c0 = c > 0 ? c - 1 : 0, c1 = c < G - 1 ? c + 1 : G - 1;
        for (int rr = r0; rr <= r1; ++rr)
          for (int cc = c0; cc <= c1; ++cc) v = min(v, cur[rr * G + cc]);
      }
      nxt[i] = v;
      changed |= v != old;
    }
    int* t = cur;
    cur = nxt;
    nxt = t;
    // the barrier also orders this round's writes before the next reads
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = threadIdx.x; i < GG; i += blockDim.x) dst[i] = cur[i];
}

}  // namespace

extern "C" int plade_close_and_label(const int* occ, int* out, int L, int G,
                                     int iters, cudaStream_t stream) {
  if (G < 1 || G > kMaxGrid || L < 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return static_cast<int>(cudaSuccess);
  const size_t bytes = smem_bytes(G);
  if (bytes > kStaticSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        close_label_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  close_label_kernel<<<L, kThreads, bytes, stream>>>(occ, out, G, iters);
  return static_cast<int>(cudaGetLastError());
}
