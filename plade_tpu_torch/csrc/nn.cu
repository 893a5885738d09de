// Exact brute-force nearest-neighbour kernels for Hopper (sm_90a).
//
// K2  plade_nearest_neighbor  replaces the Pallas kernel
//     plade_tpu/kernels/nn.py::nearest_neighbor (:66-112, body _nn_kernel
//     :38-63, pallas_call :87; min_dist_sq :115 is its d2): per query the
//     minimum squared distance to the reference points and the index of
//     the nearest one, ties going to the lowest index.
// K1  plade_oriented_min_dist_sq  replaces
//     plade_tpu/kernels/nn.py::oriented_min_dist_sq (:151-192, body
//     _oriented_kernel :123-148, pallas_call :182): per query the minimum
//     squared distance to the references whose normal agrees
//     (qn . rn >= normal_cos), +inf when none does.
//
// Both take a leading axis of P pairs: pair p's queries (Q, 3) scan only
// pair p's references (T, 3), one launch for all pairs (blockIdx.z is the
// pair), so a batch of pairs fills the card by its pairs before the
// references are split.  K2's argmin indexes the pair's own references.
// P = 1 is the single-pair launch, bit for bit.
//
// What bounds them on the card: both are an all-pairs pass over Q x T
// pairs whose inputs and outputs are a few MB, so device memory is not the
// limit.  Counted as floating-point work, K2 is 8 FLOP a pair (3
// subtractions, 3 products, 2 additions) and K1 13 (d2 plus the 3-term
// normal dot); at the rescore ICP's Q = 131072, T = 16384 that is 0.256 ms
// (K2) and 0.417 ms (K1) at the card's 67 TFLOP/s fp32 rate.  The ceiling
// that binds first is instruction issue: without fused multiply-adds
// (see below) a pair costs K2 11 thread-instructions (the 8 FLOPs, a
// compare and the two selects of min and argmin) and K1 16 (the 13, two
// compares, a select), and an SM issues 128 thread-instructions a clock,
// about 0.71 ms (K2) and 1.03 ms (K1) at that shape on 132 SMs at
// 1.98 GHz.  One query per thread with scalar shared-memory loads (the
// design of the first port) added 3 (K2) or 6 (K1) shared-memory loads a
// pair, and those, at about one warp-wide load a clock, set its time.
//
// Design:
// - Each thread keeps R queries in registers: thread t of block b owns
//   queries b * kThreads * R + k * kThreads + t, k < R, so query loads
//   coalesce.  Every reference read from shared memory is used against all
//   R queries: 1/R (K2) or 2/R (K1) shared-memory loads a pair.  K2 takes
//   R = 10 and K1 R = 8, the fastest of R = 8, 10, 12 and 16 on the card
//   for each; at those, two blocks of either fit a SM's registers (ptxas
//   -v in chip_smoke.py phase (a)).  At R = 12 ptxas caps K1 at 128 registers a
//   thread and spills; at 16 it keeps one block a SM.
// - The reference tile sits in shared memory as float4 {x, y, z, unused}
//   (and a second float4 {nx, ny, nz, unused} for K1), so one reference is
//   one (K2) or two (K1) 128-bit broadcast loads.  Tiles are
//   double-buffered with cp.async: each thread starts copying its share of
//   the next tile (coalesced, flat over the (n, 3) floats) into the other
//   buffer before scanning the current one, and waits for it after the
//   scan; one barrier a tile, and no register held for the copy.
// - When the queries of all pairs give fewer than kMinBlocksPerSM blocks per
//   SM,
//   the references are split into slices of whole tiles over blockIdx.y,
//   choosing among the splits that fill the card the one whose busiest SM
//   scans the fewest tiles.  Each slice scans its references in ascending
//   order with a strict '<' (the lowest index wins inside the slice) and
//   posts its result with one atomicMin:
//     K2: 64-bit, key = (bits(d2) << 32) | index.  d2 >= 0, so the order
//         of its bits is the float order, and the low word makes the
//         lowest index win ties across slices: the merge is exact and the
//         same on every run.  The keys live in scratch the wrapper
//         allocates; they are set to all-ones (cudaMemsetAsync) before the
//         scan and unpacked into (d2, index) after it; a key left at
//         all-ones unpacks to (+inf, 0), the plain version's row without a
//         finite candidate.
//     K1: 32-bit on the bits of d2 in the output itself, which a small
//         kernel fills with +inf (bits 0x7f800000, above every finite d2)
//         first.
//   The kernels allocate nothing.
//
// Parity: d2 = dx*dx + dy*dy + dz*dz and dot = nx*rnx + ny*rny + nz*rnz are
// written in that order, as in the plain PyTorch versions
// (plade_tpu_torch/kernels/nn.py), and the library is compiled with
// -fmad=false so that no product is fused into an add: both kernels equal
// their plain versions bit for bit, d2 and argmin.
//
// Status (PERF.md, chip_smoke.py phase (b)): both run at about 80-90% of
// the issue ceiling above, with the SM clock at its 1980 MHz maximum; the
// compiled loop holds the 11 (K2) instructions a pair and one 128-bit
// shared load a reference.  Next steps (ROADMAP Queue 2): fused
// multiply-adds (9 instructions a pair for K2, 12 for K1, at the cost of
// bit parity with the plain versions: a tolerance of a few ulp of d2), and
// skipping the padded query and reference rows by reading the live counts
// on the device.
#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNNQueries = 10;                     // K2's R, queries a thread
constexpr int kOrientedQueries = 8;                // K1's R
constexpr int kNNBlockQueries = kThreads * kNNQueries;
constexpr int kOrientedBlockQueries = kThreads * kOrientedQueries;
constexpr int kTile = 512;                         // references per tile
constexpr int kStage = 3 * kTile / kThreads;       // floats a thread stages
constexpr int kMinBlocksPerSM = 4;
constexpr int kMaxSlices = 1024;
static_assert(3 * kTile % kThreads == 0, "a tile stages evenly");

// Copies references [base, base + n) of an (N, 3) array into float4 rows
// {x, y, z, .} of dst (w is never written) with 4-byte cp.async: thread t
// takes the flat floats t, t + kThreads, ... below 3n, so the loads
// coalesce, and no register is held while the copy is in flight.
__device__ __forceinline__ void stage_tile(float4* dst,
                                           const float* __restrict__ src,
                                           int base, int n) {
  const float* p = src + 3 * static_cast<size_t>(base);
  float* s = reinterpret_cast<float*>(dst);
#pragma unroll
  for (int m = 0; m < kStage; ++m) {
    const int e = threadIdx.x + m * kThreads;
    if (e < 3 * n) {
      const int j = e / 3;
      const unsigned int to = static_cast<unsigned int>(
          __cvta_generic_to_shared(s + 4 * j + (e - 3 * j)));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
                   "l"(p + e)
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

// Query k of this thread (within its pair) when each thread holds R
// queries, or -1 past Q.
template <int R>
__device__ __forceinline__ int query_index(int k, int Q) {
  const int qi = blockIdx.x * kThreads * R + k * kThreads + threadIdx.x;
  return qi < Q ? qi : -1;
}

__global__ void __launch_bounds__(kThreads)
    nn_kernel(const float* __restrict__ q, const float* __restrict__ r,
              unsigned long long* __restrict__ keys, int Q, int T,
              int slice) {
  __shared__ float4 tile[2][kTile];
  const size_t pair = blockIdx.z;
  q += 3 * pair * Q;
  r += 3 * pair * T;
  keys += pair * Q;
  const int begin = blockIdx.y * slice;
  const int end = min(T, begin + slice);
  constexpr int R = kNNQueries;
  float qx[R], qy[R], qz[R], best[R];
  int best_i[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int qi = query_index<R>(k, Q);
    qx[k] = qi >= 0 ? q[3 * qi + 0] : 0.f;
    qy[k] = qi >= 0 ? q[3 * qi + 1] : 0.f;
    qz[k] = qi >= 0 ? q[3 * qi + 2] : 0.f;
    best[k] = CUDART_INF_F;
    best_i[k] = 0;
  }
  stage_tile(tile[0], r, begin, min(kTile, end - begin));
  staged();
  __syncthreads();
  int b = 0;
  for (int base = begin; base < end; base += kTile) {
    const int n = min(kTile, end - base);
    const int next = base + kTile;
    if (next < end) stage_tile(tile[b ^ 1], r, next, min(kTile, end - next));
    const float4* s = tile[b];
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 p = s[j];
      const int idx = base + j;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float dx = qx[k] - p.x;
        const float dy = qy[k] - p.y;
        const float dz = qz[k] - p.z;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best[k]) {
          best[k] = d2;
          best_i[k] = idx;
        }
      }
    }
    staged();
    __syncthreads();
    b ^= 1;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int qi = query_index<R>(k, Q);
    if (qi >= 0)
      atomicMin(keys + qi,
                (static_cast<unsigned long long>(__float_as_uint(best[k]))
                 << 32) | static_cast<unsigned int>(best_i[k]));
  }
}

__global__ void unpack_keys(const unsigned long long* __restrict__ keys,
                            float* __restrict__ out_d, int* __restrict__ out_i,
                            int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const unsigned long long key = keys[t];
  const bool none = key == ~0ull;
  out_d[t] = none ? CUDART_INF_F
                  : __uint_as_float(static_cast<unsigned int>(key >> 32));
  out_i[t] = none ? 0 : static_cast<int>(key & 0xffffffffu);
}

__global__ void __launch_bounds__(kThreads)
    oriented_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                    const float* __restrict__ r, const float* __restrict__ rn,
                    float normal_cos, unsigned int* __restrict__ out_bits,
                    int Q, int T, int slice) {
  __shared__ float4 tp[2][kTile];
  __shared__ float4 tn[2][kTile];
  const size_t pair = blockIdx.z;
  q += 3 * pair * Q;
  qn += 3 * pair * Q;
  r += 3 * pair * T;
  rn += 3 * pair * T;
  out_bits += pair * Q;
  const int begin = blockIdx.y * slice;
  const int end = min(T, begin + slice);
  constexpr int R = kOrientedQueries;
  float qx[R], qy[R], qz[R], nx[R], ny[R], nz[R], best[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int qi = query_index<R>(k, Q);
    qx[k] = qi >= 0 ? q[3 * qi + 0] : 0.f;
    qy[k] = qi >= 0 ? q[3 * qi + 1] : 0.f;
    qz[k] = qi >= 0 ? q[3 * qi + 2] : 0.f;
    nx[k] = qi >= 0 ? qn[3 * qi + 0] : 0.f;
    ny[k] = qi >= 0 ? qn[3 * qi + 1] : 0.f;
    nz[k] = qi >= 0 ? qn[3 * qi + 2] : 0.f;
    best[k] = CUDART_INF_F;
  }
  stage_tile(tp[0], r, begin, min(kTile, end - begin));
  stage_tile(tn[0], rn, begin, min(kTile, end - begin));
  staged();
  __syncthreads();
  int b = 0;
  for (int base = begin; base < end; base += kTile) {
    const int n = min(kTile, end - base);
    const int next = base + kTile;
    if (next < end) {
      stage_tile(tp[b ^ 1], r, next, min(kTile, end - next));
      stage_tile(tn[b ^ 1], rn, next, min(kTile, end - next));
    }
    const float4* sp = tp[b];
    const float4* sn = tn[b];
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 p = sp[j];
      const float4 m = sn[j];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float dot = nx[k] * m.x + ny[k] * m.y + nz[k] * m.z;
        const float dx = qx[k] - p.x;
        const float dy = qy[k] - p.y;
        const float dz = qz[k] - p.z;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (dot >= normal_cos && d2 < best[k]) best[k] = d2;
      }
    }
    staged();
    __syncthreads();
    b ^= 1;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int qi = query_index<R>(k, Q);
    if (qi >= 0) atomicMin(out_bits + qi, __float_as_uint(best[k]));
  }
}

__global__ void fill_inf(float* __restrict__ out, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) out[t] = CUDART_INF_F;
}

int blocks_of(int n, int per_block) { return (n + per_block - 1) / per_block; }

// References per slice (whole tiles) for P pairs of Q queries,
// `block_queries` a block, against T references: among the splits that give
// at least
// kMinBlocksPerSM blocks per SM (or the finest split, when none does), the
// one whose busiest SM scans the fewest tiles; ties go to fewer slices
// (fewer atomics).
int slice_refs(int P, int Q, int T, int block_queries) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks_x =
      static_cast<long long>(P) * blocks_of(Q, block_queries);
  const int tiles = (T + kTile - 1) / kTile;
  const int s_max = min(tiles, kMaxSlices);
  long long best_cost = LLONG_MAX;
  int best_len = tiles;
  for (int s = 1; s <= s_max; ++s) {
    const int len = (tiles + s - 1) / s;
    const long long blocks = blocks_x * ((tiles + len - 1) / len);
    if (blocks < static_cast<long long>(kMinBlocksPerSM) * sms && s < s_max)
      continue;
    const long long cost = (blocks + sms - 1) / sms * len;
    if (cost < best_cost) {
      best_cost = cost;
      best_len = len;
    }
  }
  return best_len * kTile;
}

}  // namespace

// The interface of the entry points below: 2 = with the leading pair axis
// (P before Q and T).
extern "C" int plade_nn_abi() { return 2; }

// Number of reference slices (blockIdx.y) of a K2 launch (oriented == 0)
// or a K1 launch (oriented != 0) of P pairs of Q queries against T
// references each.
extern "C" int plade_nn_ref_slices(int P, int Q, int T, int oriented) {
  if (P <= 0 || Q <= 0 || T <= 0) return 0;
  const int block_queries = oriented ? kOrientedBlockQueries : kNNBlockQueries;
  return blocks_of(T, slice_refs(P, Q, T, block_queries));
}

// q (P, Q, 3), r (P, T, 3) -> out_d, out_i (P, Q); keys: P * Q scratch.
extern "C" int plade_nearest_neighbor(const float* q, const float* r,
                                      float* out_d, int* out_i,
                                      unsigned long long* keys, int P, int Q,
                                      int T, cudaStream_t stream) {
  if (P < 0 || Q < 0 || T < 0 || P > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = P * Q;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(keys, 0xff, sizeof(*keys) * n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T > 0) {
    const int slice = slice_refs(P, Q, T, kNNBlockQueries);
    const dim3 grid(blocks_of(Q, kNNBlockQueries), blocks_of(T, slice), P);
    nn_kernel<<<grid, kThreads, 0, stream>>>(q, r, keys, Q, T, slice);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  unpack_keys<<<blocks_of(n, kThreads), kThreads, 0, stream>>>(keys, out_d,
                                                              out_i, n);
  return static_cast<int>(cudaGetLastError());
}

// q, qn (P, Q, 3), r, rn (P, T, 3) -> out_d (P, Q).
extern "C" int plade_oriented_min_dist_sq(const float* q, const float* qn,
                                          const float* r, const float* rn,
                                          float normal_cos, float* out_d,
                                          int P, int Q, int T,
                                          cudaStream_t stream) {
  if (P < 0 || Q < 0 || T < 0 || P > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = P * Q;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  fill_inf<<<blocks_of(n, kThreads), kThreads, 0, stream>>>(out_d, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || T == 0) return static_cast<int>(err);
  const int slice = slice_refs(P, Q, T, kOrientedBlockQueries);
  const dim3 grid(blocks_of(Q, kOrientedBlockQueries), blocks_of(T, slice),
                  P);
  oriented_kernel<<<grid, kThreads, 0, stream>>>(
      q, qn, r, rn, normal_cos, reinterpret_cast<unsigned int*>(out_d), Q, T,
      slice);
  return static_cast<int>(cudaGetLastError());
}
