// Exact brute-force nearest-neighbour kernels for Hopper (sm_90a).
//
// K2  plade_nearest_neighbor  replaces the Pallas kernel
//     plade_tpu/kernels/nn.py::nearest_neighbor (_nn_kernel): per query the
//     minimum squared distance to the reference points and the index of
//     the nearest one, ties going to the lowest index.
// K1  plade_oriented_min_dist_sq  replaces
//     plade_tpu/kernels/nn.py::oriented_min_dist_sq (_oriented_kernel): per
//     query the minimum squared distance to the references whose normal
//     agrees (qn . rn >= normal_cos), +inf when none does.
//
// What bounds them on the card: both are an O(Q*T) all-pairs pass with no
// reuse beyond the reference tile, about 9 fp32 operations per pair for
// K2 and 15 for K1 (3 subtractions, 3 products, 2 additions, a compare;
// K1 adds the 3-term normal dot and its compare).  At the rescore's shape
// (Q = 16 * 16384, T = 16384) that is 4.3e9 pairs, so the kernels are
// bound by arithmetic and shared-memory loads; device memory traffic is a
// few MB.
//
// Design: one query per thread, held in registers with its running min
// (and argmin).  A block stages a tile of references in shared memory as
// structure-of-arrays (x, y, z, plus nx, ny, nz for K1) so that every
// thread of a warp reads the same word (a broadcast), then scans the tile.
// References are visited in ascending order with a strict '<', which gives
// the Pallas kernel's lowest-index tie rule without any extra work.  There
// is no block padding: the last tile is masked by T.
//
// Parity: d2 = dx*dx + dy*dy + dz*dz is written in that order, as in the
// plain PyTorch version (plade_tpu_torch/kernels/nn.py), and the library
// is compiled with -fmad=false so that no product is fused into an add.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void nn_kernel(const float* __restrict__ q,
                          const float* __restrict__ r,
                          float* __restrict__ out_d,
                          int* __restrict__ out_i, int Q, int T) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = qi < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = q[3 * qi + 0];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
  float best = CUDART_INF_F;
  int best_i = 0;
  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float* p = r + 3 * (base + j);
      sx[j] = p[0];
      sy[j] = p[1];
      sz[j] = p[2];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = qx - sx[j];
      const float dy = qy - sy[j];
      const float dz = qz - sz[j];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < best) {
        best = d2;
        best_i = base + j;
      }
    }
    __syncthreads();
  }
  if (live) {
    out_d[qi] = best;
    out_i[qi] = best_i;
  }
}

__global__ void oriented_kernel(const float* __restrict__ q,
                                const float* __restrict__ qn,
                                const float* __restrict__ r,
                                const float* __restrict__ rn,
                                float normal_cos, float* __restrict__ out_d,
                                int Q, int T) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  __shared__ float snx[kTile];
  __shared__ float sny[kTile];
  __shared__ float snz[kTile];
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = qi < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  if (live) {
    qx = q[3 * qi + 0];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
    nx = qn[3 * qi + 0];
    ny = qn[3 * qi + 1];
    nz = qn[3 * qi + 2];
  }
  float best = CUDART_INF_F;
  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float* p = r + 3 * (base + j);
      const float* m = rn + 3 * (base + j);
      sx[j] = p[0];
      sy[j] = p[1];
      sz[j] = p[2];
      snx[j] = m[0];
      sny[j] = m[1];
      snz[j] = m[2];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dot = nx * snx[j] + ny * sny[j] + nz * snz[j];
      const float dx = qx - sx[j];
      const float dy = qy - sy[j];
      const float dz = qz - sz[j];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (dot >= normal_cos && d2 < best) best = d2;
    }
    __syncthreads();
  }
  if (live) out_d[qi] = best;
}

}  // namespace

extern "C" int plade_nearest_neighbor(const float* q, const float* r,
                                      float* out_d, int* out_i, int Q, int T,
                                      cudaStream_t stream) {
  if (Q > 0) {
    const int blocks = (Q + kThreads - 1) / kThreads;
    nn_kernel<<<blocks, kThreads, 0, stream>>>(q, r, out_d, out_i, Q, T);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plade_oriented_min_dist_sq(const float* q, const float* qn,
                                          const float* r, const float* rn,
                                          float normal_cos, float* out_d,
                                          int Q, int T, cudaStream_t stream) {
  if (Q > 0) {
    const int blocks = (Q + kThreads - 1) / kThreads;
    oriented_kernel<<<blocks, kThreads, 0, stream>>>(q, qn, r, rn, normal_cos,
                                                     out_d, Q, T);
  }
  return static_cast<int>(cudaGetLastError());
}
