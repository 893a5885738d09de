// The spacing's exact top-k for Hopper (sm_90a).
//
// K4  plade_topk_dist_sq  replaces no Pallas kernel: the JAX package selects
//     the spacing's neighbours with lax.approx_min_k
//     (plade_tpu/knn/bruteforce.py:121-149), which XLA lowers by itself.
//     It was added because the port's first spacing did the same work as
//     a blocked cuBLAS product with an inner size of 3, four elementwise
//     passes and torch.topk's radix select over a (P, 64, T) float32 block
//     at a time: ~50 bytes of device traffic a distance, the largest stage
//     of a batch of 131072-row clouds.  This kernel never writes a distance.
//
// What it computes: per query, the k smallest max(qq - 2 cross + rr, 0)
// over the T references of its cloud, ascending, float32, where
// cross = q . r and qq = |q|^2, rr = |r|^2 come in from the wrapper: the
// value of the plain version (plade_tpu_torch/knn/bruteforce.py::
// topk_dist_sq_plain).  P clouds in one launch (blockIdx.z is the cloud);
// padded rows (at 1e8) enter like any other row.
//
// What bounds it on the card: the inputs are a few MB, so device memory is
// not the limit.  Counted as floating-point work a distance is 8 FLOP (the
// dot as a product and two fused multiply-adds, the doubling as a fused
// multiply-add with qq, the add of rr): the spacing's 10000 samples of a
// 131072-row cloud are 1.31e9 distances, 10.5 GFLOP, 0.157 ms at the
// card's 67 TFLOP/s fp32 rate.  The ceiling that binds first is
// instruction issue: 6 thread-instructions a distance (those 5 and the
// compare with the query's k-th smallest, folded into the thread's guard)
// and a branch a reference for the thread's R queries, 6.25 at R = 4; an
// SM issues 128 a clock, so 0.245 ms a cloud of 131072 rows on 132 SMs at
// 1.98 GHz.
//
// Design:
// - Each thread keeps R queries in registers, each with its qq and the
//   sorted list of its k smallest so far (K slots, the k live ones on top):
//   thread t of block b owns queries b * kThreads * R + j * kThreads + t,
//   j < R.  A reference costs each query the 5 operations of d and one
//   compare with its list's largest, and the thread one branch: only when
//   one of its R queries has a smaller d does it insert (a branch-free
//   min/max pass over the K slots, for the queries that need it).  A list
//   takes about k ln(T / k) insertions, nearly all in its first references.
//   A warp pays for each branch that any of its lanes takes: one branch for
//   a thread's R queries, not one each, made the kernel ~1.6x faster on the
//   card at R = 8, and R = 4 was the fastest of R = 2, 3, 4, 6 and 8 at the
//   spacing's shapes (fewer lists a branch take it less often).
// - References stream through shared memory as float4 {x, y, z, rr} tiles,
//   double-buffered with 4-byte cp.async as K2's (csrc/nn.cu): one
//   128-bit broadcast load a reference serves all R queries.
// - When the queries of all clouds are too few blocks to fill the card
//   (one cloud of 10000 samples is 10 blocks), the references are split
//   into slices of whole tiles over blockIdx.y (slice_refs: the fewest
//   tiles on the busiest SM, counting each slice's empty start as
//   kWarmTiles more).  Each slice writes its k smallest a query to scratch
//   the wrapper allocates, and a second small kernel merges the S lists of
//   each query.  The k smallest of a multiset do not depend on the order
//   of the merge, so the result is the same bits on every run and for
//   every split.  The kernels allocate nothing.
// - k is a template bound: K = 8 serves k <= 8, K = 16 k <= 16; the K - k
//   lowest slots hold -inf, which no insertion moves, so the guard reads
//   the k-th smallest.
//
// Parity: qq and rr are the plain version's own torch.sum bits; cross is
// written qx * rx, then fma(qy, ry, .), then fma(qz, rz, .), the order in
// which cuBLAS's fp32 product accumulates an inner size of 3 (on the card
// it matched every product of the plain version's blocks, and the other
// orders did not); then fma(-2, cross, qq) (the doubling is exact, so one
// rounding, as qq - 2.0 * cross), + rr and the clamp.  Explicit
// intrinsics, and the library is compiled with -fmad=false, so nothing
// else contracts: K4 equals the plain version bit for bit
// (tests/test_torch_cuda.py, chip_smoke.py phase (b)).
//
// Status (PERF.md, chip_smoke.py phase (b)): 8 clouds of 10000 x 131072
// in ~4.5 ms, ~44% of the issue ceiling above.  A variant whose lists
// start at each query's true k-th smallest ran within ~10% of the same
// scan without insertions, which itself reaches ~55% of the ceiling: the
// next step is a cheap first pass that bounds each query's k-th smallest
// before the slices scan.
#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueries = 4;                        // R, queries a thread
constexpr int kTile = 512;                         // references per tile
constexpr int kStage = 4 * kTile / kThreads;       // floats a thread stages
constexpr int kWarmTiles = 8;
constexpr int kMaxSlices = 1024;
constexpr int kMaxK = 16;
static_assert(3 * kTile % kThreads == 0, "x, y, z stage evenly");
static_assert(kTile % kThreads == 0, "rr stages evenly");

// Copies references [base, base + n) into float4 rows {x, y, z, rr} of dst
// with 4-byte cp.async: the first 3 kTile floats a tile are the (n, 3)
// coordinates flat, the last kTile the rr lane, so every load coalesces.
__device__ __forceinline__ void stage_tile(float4* dst,
                                           const float* __restrict__ r,
                                           const float* __restrict__ rr,
                                           int base, int n) {
  const float* p = r + 3 * static_cast<size_t>(base);
  float* s = reinterpret_cast<float*>(dst);
#pragma unroll
  for (int m = 0; m < kStage; ++m) {
    const int e = threadIdx.x + m * kThreads;
    const float* from = nullptr;
    float* to = nullptr;
    if (e < 3 * kTile) {
      const int j = e / 3;
      if (e < 3 * n) {
        from = p + e;
        to = s + 4 * j + (e - 3 * j);
      }
    } else if (e - 3 * kTile < n) {
      from = rr + base + (e - 3 * kTile);
      to = s + 4 * (e - 3 * kTile) + 3;
    }
    if (to != nullptr) {
      const unsigned int at =
          static_cast<unsigned int>(__cvta_generic_to_shared(to));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
                   "l"(from)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for this thread's staged copies; a barrier must follow before any
// thread reads them.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Inserts v into the ascending list l, dropping its largest.
template <int K>
__device__ __forceinline__ void insert(float (&l)[K], float v) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float lo = fminf(l[i], v);
    v = fmaxf(l[i], v);
    l[i] = lo;
  }
}

// An empty list of the k smallest in K slots.
template <int K>
__device__ __forceinline__ void clear(float (&l)[K], int k) {
#pragma unroll
  for (int i = 0; i < K; ++i) l[i] = i < K - k ? -CUDART_INF_F : CUDART_INF_F;
}

// Writes the k live slots of l, ascending, at to[0], to[stride], ...
template <int K>
__device__ __forceinline__ void put(const float (&l)[K], int k, float* to,
                                    size_t stride) {
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (i >= K - k) to[(i - (K - k)) * stride] = l[i];
}

// Scans references [blockIdx.y * slice, + slice) of cloud blockIdx.z for
// this thread's R queries; writes each query's k smallest to out (P, Q, k)
// or, with slices, to scratch (S, P, k, Q).
template <int K>
__global__ void __launch_bounds__(kThreads, 2)
    topk_kernel(const float* __restrict__ q, const float* __restrict__ qq,
                const float* __restrict__ r, const float* __restrict__ rr,
                float* __restrict__ out, float* __restrict__ scratch, int P,
                int Q, int T, int k, int slice) {
  __shared__ float4 tile[2][kTile];
  const size_t cloud = blockIdx.z;
  q += 3 * cloud * Q;
  qq += cloud * Q;
  r += 3 * cloud * T;
  rr += cloud * T;
  const int begin = blockIdx.y * slice;
  const int end = min(T, begin + slice);
  constexpr int R = kQueries;
  float qx[R], qy[R], qz[R], qn[R], best[R][K];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int qi = blockIdx.x * kThreads * R + j * kThreads + threadIdx.x;
    const bool live = qi < Q;
    qx[j] = live ? q[3 * qi + 0] : 0.f;
    qy[j] = live ? q[3 * qi + 1] : 0.f;
    qz[j] = live ? q[3 * qi + 2] : 0.f;
    qn[j] = live ? qq[qi] : CUDART_INF_F;   // a row past Q inserts nothing
    clear(best[j], k);
  }
  stage_tile(tile[0], r, rr, begin, min(kTile, end - begin));
  staged();
  __syncthreads();
  int b = 0;
  for (int base = begin; base < end; base += kTile) {
    const int n = min(kTile, end - base);
    const int next = base + kTile;
    if (next < end)
      stage_tile(tile[b ^ 1], r, rr, next, min(kTile, end - next));
    const float4* s = tile[b];
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      const float4 p = s[i];
      float d[R];
      bool hit = false;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float cross = __fmaf_rn(
            qz[j], p.z, __fmaf_rn(qy[j], p.y, __fmul_rn(qx[j], p.x)));
        d[j] = __fadd_rn(__fmaf_rn(-2.f, cross, qn[j]), p.w);
        hit |= d[j] < best[j][K - 1];
      }
      // one branch a reference for the thread's R queries; the guard reads
      // d before the clamp: it differs from the clamped d's only where the
      // k-th smallest is 0, and a 0 entering there leaves the list's
      // values as they are
      if (hit) {
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (d[j] < best[j][K - 1]) insert(best[j], fmaxf(d[j], 0.f));
      }
    }
    staged();
    __syncthreads();
    b ^= 1;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int qi = blockIdx.x * kThreads * R + j * kThreads + threadIdx.x;
    if (qi >= Q) continue;
    if (scratch == nullptr)
      put(best[j], k, out + (cloud * Q + qi) * k, 1);
    else
      put(best[j], k,
          scratch + ((static_cast<size_t>(blockIdx.y) * P + cloud) * k) * Q +
              qi,
          static_cast<size_t>(Q));
  }
}

// Merges the S slices' lists of each of the n = P * Q queries (scratch
// (S, P, k, Q), each list ascending) into out (P, Q, k).
template <int K>
__global__ void merge_slices(const float* __restrict__ scratch,
                             float* __restrict__ out, int n, int Q, int k,
                             int slices) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int cloud = t / Q;
  const float* from =
      scratch + static_cast<size_t>(cloud) * k * Q + (t - cloud * Q);
  float best[K];
  clear(best, k);
  for (int s = 0; s < slices; ++s) {
    const float* list = from + static_cast<size_t>(s) * n * k;
    for (int i = 0; i < k; ++i) {
      const float v = list[static_cast<size_t>(i) * Q];
      if (!(v < best[K - 1])) break;           // the rest of it is larger
      insert(best, v);
    }
  }
  put(best, k, out + static_cast<size_t>(t) * k, 1);
}

int blocks_of(int n, int per_block) { return (n + per_block - 1) / per_block; }

// References per slice (whole tiles) of the instance <K> for P clouds of
// Q queries against T references: the split whose busiest SM scans the
// fewest tiles, counting kWarmTiles more for each slice it scans (a list
// starts empty in each slice, and inserts into nearly every reference
// until it holds values near its query), with every SM holding as many
// blocks at once as the kernel's registers allow; ties go to fewer slices
// (less to merge).
template <int K>
int slice_refs(int P, int Q, int T) {
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_kernel<K>,
                                                kThreads, 0);
  const long long resident = static_cast<long long>(sms) * max(per_sm, 1);
  const long long blocks_x =
      static_cast<long long>(P) * blocks_of(Q, kThreads * kQueries);
  const int tiles = (T + kTile - 1) / kTile;
  long long best_cost = LLONG_MAX;
  int best_len = tiles;
  for (int s = 1; s <= min(tiles, kMaxSlices); ++s) {
    const int len = (tiles + s - 1) / s;
    const long long blocks = blocks_x * ((tiles + len - 1) / len);
    const long long cost =
        (blocks + resident - 1) / resident * (len + kWarmTiles);
    if (cost < best_cost) {
      best_cost = cost;
      best_len = len;
    }
  }
  return best_len * kTile;
}

template <int K>
int launch(const float* q, const float* qq, const float* r, const float* rr,
           float* out, float* scratch, int P, int Q, int T, int k, int slice,
           cudaStream_t stream) {
  const int slices = blocks_of(T, slice);
  const dim3 grid(blocks_of(Q, kThreads * kQueries), slices, P);
  topk_kernel<K><<<grid, kThreads, 0, stream>>>(
      q, qq, r, rr, out, slices > 1 ? scratch : nullptr, P, Q, T, k, slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  merge_slices<K><<<blocks_of(P * Q, kThreads), kThreads, 0, stream>>>(
      scratch, out, P * Q, Q, k, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// References a slice of a K4 launch of P clouds of Q queries against T
// references each, k a query (a multiple of the tile); its slices are
// ceil(T / slice), and a launch of more than one needs scratch of
// slices * P * k * Q floats.  0 when the arguments are out of range.
extern "C" int plade_topk_slice(int P, int Q, int T, int k) {
  if (P <= 0 || Q <= 0 || T <= 0 || k < 1 || k > kMaxK) return 0;
  return k <= 8 ? slice_refs<8>(P, Q, T) : slice_refs<16>(P, Q, T);
}

// q (P, Q, 3), qq (P, Q), r (P, T, 3), rr (P, T) -> out (P, Q, k);
// scratch as plade_topk_slice says, for the slice it gave.
extern "C" int plade_topk_dist_sq(const float* q, const float* qq,
                                  const float* r, const float* rr, float* out,
                                  float* scratch, int P, int Q, int T, int k,
                                  int slice, cudaStream_t stream) {
  if (P < 0 || Q < 0 || T < 0 || P > 65535 || k < 1 || k > kMaxK || k > T ||
      slice <= 0 || slice % kTile != 0 || blocks_of(T, slice) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || Q == 0) return static_cast<int>(cudaGetLastError());
  if (k <= 8)
    return launch<8>(q, qq, r, rr, out, scratch, P, Q, T, k, slice, stream);
  return launch<16>(q, qq, r, rr, out, scratch, P, Q, T, k, slice, stream);
}
