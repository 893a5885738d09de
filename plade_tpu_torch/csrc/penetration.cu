// The penetration filter's point-counting walk for Hopper (sm_90a).
//
// K5  plade_penetration_walk  replaces no Pallas kernel: the JAX package
//     walks its compacted tests in plain jnp (plade_tpu/verify/
//     penetration.py::run_tests), which XLA lowers by itself.  It was added
//     because the port's plain walk (plade_tpu_torch/verify/penetration.py::
//     run_tests_plain) makes four (B, 512, M, S) float32 distance blocks a
//     chunk of 512 tests (a batched product with an inner size of 3, four
//     broadcast passes, a compare and a reduction each), over every padded
//     row of M = 2048 and every chunk of the pair with the most tests, with a
//     host read a tier: ~44 bytes of device traffic a distance, the largest
//     stage of the batch cells' registration core.  This kernel never writes
//     a distance.
//
// What it computes (util.cpp:1383-1453, the plain walk's quirks kept): per
// test, a candidate pose (R, t), a source plane, a target plane and a
// segment of their intersection line, sampled at start + (s r) direc,
// s < S.  Side 1: the source plane's live points moved by the pose; a
// sample is live where it lies on the segment (s r < length) and at least
// 2 of the target plane's live points lie within r / 2 of it; a moved
// source point is near where a live sample lies within r; pos1 / neg1
// count the near points whose signed distance to the target plane is above
// min_distance / below -min_distance.  Side 2 the same with the planes'
// roles swapped (the target's points against the moved source plane).  A
// test penetrates where pos1 and neg1 >= min_points, pos2 or neg2 >=
// min_points, and both sides' max(p, n) / max(min(p, n + 1), 1) <=
// max_ratio.  One launch serves every test of every pair; a test whose
// valid is false writes false and returns.
//
// What bounds it on the card: the inputs are a few MB, so device memory is
// not the limit.  Counted as floating-point work a distance is 8 FLOP (the
// dot as a product and two fused multiply-adds, the doubling as a fused
// multiply-add with |p|^2, the add of |s|^2), and a test needs S (n1 + n2)
// of them over its planes' live points (each distance serves both of its
// comparisons): the benchmark's batches hold ~1900-2100 live tests a pair
// of ~1450-2450 live points, 0.8-1.2 GFLOP a pair, 0.012-0.018 ms at
// 67 TFLOP/s fp32.  The ceiling that binds first is instruction issue (~8
// thread-instructions a distance with the compares and the count).
// Measured on an H100: 0.50 / 0.70 ms a batch of 8, 19-20% of that bound.
//
// Design:
// - One block of 256 threads a test.  Lanes take the samples (sample
//   g + lane, groups of 32 for any S), warps the points (point warp + 8 j):
//   a point is one 128-bit broadcast load from shared memory and serves the
//   warp's 32 samples.  Loops run over each plane's live points
//   (ds_counts), never the padded M, so small and large planes share the
//   launch.
// - One plane at a time sits in shared memory as float4 {x, y, z, |p|^2},
//   with its signed distance to the other plane and a near flag:
//   20 M + 24 S bytes (42.5 KB at M = 2048, S = 32).  Three sweeps: the
//   target plane (occupancy of side 1's samples), the moved source plane
//   (occupancy of side 2's samples and side 1's near flags, one distance
//   for both), the target plane again (side 2's near flags).  The third is
//   skipped where side 1 already fails, unless the counts are asked for.
// - Occupancy: each lane counts its sample's close points over its warp's
//   points, then adds into shared memory.  Near: one warp vote a point.
//   The counts of near points above / below the plane: a block reduction.
//
// Parity: every value that feeds a comparison is rounded as the plain walk
// rounds it on the card (tests/test_torch_cuda.py): the pose's einsum and
// the points-by-samples matmul accumulate an inner size of 3 as cuBLAS's
// fp32 product does, x * x', then fma(y, y', .), then fma(z, z', .); the
// batched matrix-vector products (R n, the signed distance p . n) as
// fma(y, y', x * x') + z * z'; torch.sum over 3 squares or products as
// (x + z) + y; then + t, + d, fma(-2, cross, |p|^2) (the doubling is exact,
// so one rounding, as |p|^2 - 2.0 * cross) + |s|^2, s r and start + (s r)
// direc as PyTorch's elementwise passes.  The clamp at 0 moves no
// comparison with a threshold >= 0 and is left out.  Explicit intrinsics,
// and the library is compiled with -fmad=false, so nothing else contracts.
// One caveat (measured on the card, torch 2.11 + CUDA 12.8): cuBLAS picks
// its matrix-vector kernel by shape, and at some of the plain walk's chunk
// shapes (1 pair of 211-512 tests of 2048 rows, 8 pairs of 37 tests of
// 2048 rows or of 211-256 tests of 512 rows, ...) it accumulates p . n as
// fma(z, z', x * x') + y * y' instead.  The plain walk's signed distances
// are then a float32 ulp away from its own at another chunk shape; K5
// keeps the order of the other shapes, for every shape.  A count moves
// only where a near point lies within that ulp of +-min_distance: on the
// benchmark's pool pairs none did (tests/test_torch_cuda.py).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

struct Args {
  const int* cand;            // (B, K) candidate of each test
  const int* src;             // (B, K) source plane
  const int* tgt;             // (B, K) target plane
  const float* start;         // (B, K, 3)
  const float* direc;         // (B, K, 3)
  const float* length;        // (B, K)
  const uint8_t* valid;       // (B, K) bool
  const float* R;             // (B, C, 3, 3)
  const float* t;             // (B, C, 3)
  const float* src_pts;       // (B, Ps, M, 3)
  const int* src_counts;      // (B, Ps)
  const float* tgt_pts;       // (B, Pt, M, 3)
  const int* tgt_counts;      // (B, Pt)
  const float* src_coeffs;    // (B, Ps, 4)
  const float* tgt_coeffs;    // (B, Pt, 4)
  const float* radius;        // (B,) r
  const float* min_d;         // (B,) min_distance
  const float* r_occ;         // (B,) (r / 2)^2
  const float* r_near;        // (B,) r^2
  uint8_t* out;               // (B, K) bool
  int* counts;                // (B, K, 4) pos1, neg1, pos2, neg2, or null
  int K, C, Ps, Pt, M, S, min_points;
  float max_ratio;
};

// torch.sum(a * b, -1) over 3 on the card: (x + z) + y
__device__ __forceinline__ float sum3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(x, z), y);
}

__device__ __forceinline__ float sumsq(float x, float y, float z) {
  return sum3(__fmul_rn(x, x), __fmul_rn(y, y), __fmul_rn(z, z));
}

// a . b as cuBLAS's fp32 product accumulates an inner size of 3
__device__ __forceinline__ float dot_gemm(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

// a . b as the plain walk's batched matrix-vector products accumulate it
__device__ __forceinline__ float dot_gemv(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  return __fadd_rn(__fmaf_rn(ay, by, __fmul_rn(ax, bx)), __fmul_rn(az, bz));
}

__device__ __forceinline__ bool ratio_ok(int pos, int neg, float max_ratio) {
  const float hi = static_cast<float>(max(pos, neg));
  const float lo = static_cast<float>(max(min(pos, neg + 1), 1));
  return __fdiv_rn(hi, lo) <= max_ratio;
}

// The shared memory of one test: the plane of the current sweep, the
// samples, and the per-sample and per-point state.
struct Shared {
  float4* pts;       // M: x, y, z, |p|^2
  float4* samp;      // S: x, y, z, |s|^2
  float* sgn;        // M: signed distance to the other plane
  int* occ1;         // S: target points within r / 2 (side 1's samples)
  int* occ2;         // S: moved source points within r / 2 (side 2's)
  int* tally;        // 4: pos1, neg1, pos2, neg2
  uint8_t* near;     // M
  uint8_t* on_seg;   // S: s r < length
};

__device__ __forceinline__ Shared carve(void* base, int M, int S) {
  Shared s;
  s.pts = static_cast<float4*>(base);
  s.samp = s.pts + M;
  s.sgn = reinterpret_cast<float*>(s.samp + S);
  s.occ1 = reinterpret_cast<int*>(s.sgn + M);
  s.occ2 = s.occ1 + S;
  s.tally = s.occ2 + S;
  s.near = reinterpret_cast<uint8_t*>(s.tally + 4);
  s.on_seg = s.near + M;
  return s;
}

// One sweep over the n points in shared memory, lanes over the samples:
// with kCount, occ[s] += the points within r_occ of sample s; with kNear,
// near[m] = 1 where a live sample (on the segment, live_occ[s] >= 2) lies
// within r_near of point m (near must be 0 before).
template <bool kCount, bool kNear>
__device__ __forceinline__ void sweep(const Shared& sh, int n, int S,
                                      float r_occ, float r_near, int* occ,
                                      const int* live_occ) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int g = 0; g < S; g += 32) {
    const int s = g + lane;
    const bool in = s < S;
    const float4 q = in ? sh.samp[s] : make_float4(0.f, 0.f, 0.f, 0.f);
    const bool live = kNear && in && sh.on_seg[s] && live_occ[s] >= 2;
    const bool any_live = kNear && __any_sync(kFull, live);
    if (!kCount && !any_live) continue;
    int cnt = 0;
#pragma unroll 4
    for (int m = warp; m < n; m += kWarps) {
      const float4 p = sh.pts[m];
      const float cross = dot_gemm(p.x, p.y, p.z, q.x, q.y, q.z);
      const float d2 = __fadd_rn(__fmaf_rn(-2.f, cross, p.w), q.w);
      if (kCount) cnt += d2 <= r_occ;
      if (kNear && any_live) {
        if (__any_sync(kFull, live && d2 <= r_near) && lane == 0)
          sh.near[m] = 1;
      }
    }
    if (kCount && in) atomicAdd(&occ[s], cnt);
  }
}

// tally[0] / tally[1] += the near points of the n in shared memory whose
// signed distance is above md / below -md.
__device__ __forceinline__ void count_sides(const Shared& sh, int n, float md,
                                            int* tally) {
  int pos = 0, neg = 0;
  for (int m = threadIdx.x; m < n; m += kThreads) {
    if (sh.near[m]) {
      pos += sh.sgn[m] > md;
      neg += sh.sgn[m] < -md;
    }
  }
  pos = __reduce_add_sync(kFull, pos);
  neg = __reduce_add_sync(kFull, neg);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&tally[0], pos);
    atomicAdd(&tally[1], neg);
  }
}

// Stages the target plane's n points (unmoved) with their signed distance
// to the plane (nx, ny, nz, d), and clears their near flags.
__device__ __forceinline__ void stage_target(const Shared& sh,
                                             const float* __restrict__ p,
                                             int n, float nx, float ny,
                                             float nz, float d) {
  for (int m = threadIdx.x; m < n; m += kThreads) {
    const float x = p[3 * m + 0], y = p[3 * m + 1], z = p[3 * m + 2];
    sh.pts[m] = make_float4(x, y, z, sumsq(x, y, z));
    sh.sgn[m] = __fadd_rn(dot_gemv(x, y, z, nx, ny, nz), d);
    sh.near[m] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    walk_kernel(const Args a) {
  extern __shared__ float4 smem[];
  const Shared sh = carve(smem, a.M, a.S);
  const size_t test = blockIdx.x;
  const int b = static_cast<int>(test / a.K);
  if (!a.valid[test]) {
    if (threadIdx.x < 4 && a.counts != nullptr)
      a.counts[4 * test + threadIdx.x] = 0;
    if (threadIdx.x == 0) a.out[test] = 0;
    return;
  }
  const int cand = a.cand[test];
  const int sp = a.src[test];
  const int tp = a.tgt[test];
  const float* Rm = a.R + (static_cast<size_t>(b) * a.C + cand) * 9;
  const float* tv = a.t + (static_cast<size_t>(b) * a.C + cand) * 3;
  const float* sc = a.src_coeffs + (static_cast<size_t>(b) * a.Ps + sp) * 4;
  const float* tc = a.tgt_coeffs + (static_cast<size_t>(b) * a.Pt + tp) * 4;
  const int n1 = min(max(a.src_counts[b * a.Ps + sp], 0), a.M);
  const int n2 = min(max(a.tgt_counts[b * a.Pt + tp], 0), a.M);
  const float* p1 = a.src_pts + (static_cast<size_t>(b) * a.Ps + sp) * a.M * 3;
  const float* p2 = a.tgt_pts + (static_cast<size_t>(b) * a.Pt + tp) * a.M * 3;
  const float r = a.radius[b], r_occ = a.r_occ[b], r_near = a.r_near[b];
  const float md = a.min_d[b];

  // the samples, on the segment where s r < length
  const float* st = a.start + 3 * test;
  const float* dr = a.direc + 3 * test;
  const float len = a.length[test];
  for (int s = threadIdx.x; s < a.S; s += kThreads) {
    const float at = __fmul_rn(static_cast<float>(s), r);
    const float x = __fadd_rn(st[0], __fmul_rn(at, dr[0]));
    const float y = __fadd_rn(st[1], __fmul_rn(at, dr[1]));
    const float z = __fadd_rn(st[2], __fmul_rn(at, dr[2]));
    sh.samp[s] = make_float4(x, y, z, sumsq(x, y, z));
    sh.on_seg[s] = at < len;
    sh.occ1[s] = 0;
    sh.occ2[s] = 0;
  }
  if (threadIdx.x < 4) sh.tally[threadIdx.x] = 0;

  // the pose and the moved source plane (side 2's plane): R n, d - (R n) . t
  float Rr[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) Rr[i] = Rm[i];
  const float t0 = tv[0], t1 = tv[1], t2 = tv[2];
  float rn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    rn[i] = dot_gemv(Rr[3 * i], Rr[3 * i + 1], Rr[3 * i + 2], sc[0], sc[1],
                     sc[2]);
  const float rd = __fsub_rn(
      sc[3], sum3(__fmul_rn(rn[0], t0), __fmul_rn(rn[1], t1),
                  __fmul_rn(rn[2], t2)));

  // sweep 1: the target plane's points around side 1's samples
  stage_target(sh, p2, n2, rn[0], rn[1], rn[2], rd);
  __syncthreads();
  sweep<true, false>(sh, n2, a.S, r_occ, r_near, sh.occ1, nullptr);
  __syncthreads();

  // sweep 2: the moved source points, side 2's occupancy and side 1's near
  for (int m = threadIdx.x; m < n1; m += kThreads) {
    const float x = p1[3 * m + 0], y = p1[3 * m + 1], z = p1[3 * m + 2];
    const float cx = __fadd_rn(dot_gemm(Rr[0], Rr[1], Rr[2], x, y, z), t0);
    const float cy = __fadd_rn(dot_gemm(Rr[3], Rr[4], Rr[5], x, y, z), t1);
    const float cz = __fadd_rn(dot_gemm(Rr[6], Rr[7], Rr[8], x, y, z), t2);
    sh.pts[m] = make_float4(cx, cy, cz, sumsq(cx, cy, cz));
    sh.sgn[m] = __fadd_rn(dot_gemv(cx, cy, cz, tc[0], tc[1], tc[2]), tc[3]);
    sh.near[m] = 0;
  }
  __syncthreads();
  sweep<true, true>(sh, n1, a.S, r_occ, r_near, sh.occ2, sh.occ1);
  __syncthreads();
  count_sides(sh, n1, md, sh.tally);
  __syncthreads();
  const int pos1 = sh.tally[0], neg1 = sh.tally[1];
  const bool side1 = pos1 >= a.min_points && neg1 >= a.min_points &&
                     ratio_ok(pos1, neg1, a.max_ratio);
  if (!side1 && a.counts == nullptr) {
    if (threadIdx.x == 0) a.out[test] = 0;
    return;
  }

  // sweep 3: the target plane's points again, side 2's near
  stage_target(sh, p2, n2, rn[0], rn[1], rn[2], rd);
  __syncthreads();
  sweep<false, true>(sh, n2, a.S, r_occ, r_near, nullptr, sh.occ2);
  __syncthreads();
  count_sides(sh, n2, md, sh.tally + 2);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int pos2 = sh.tally[2], neg2 = sh.tally[3];
    const bool side2 = (pos2 >= a.min_points || neg2 >= a.min_points) &&
                       ratio_ok(pos2, neg2, a.max_ratio);
    a.out[test] = side1 && side2;
    if (a.counts != nullptr) {
      a.counts[4 * test + 0] = pos1;
      a.counts[4 * test + 1] = neg1;
      a.counts[4 * test + 2] = pos2;
      a.counts[4 * test + 3] = neg2;
    }
  }
}

size_t smem_bytes(int M, int S) {
  return static_cast<size_t>(M) * (sizeof(float4) + sizeof(float) + 1) +
         static_cast<size_t>(S) * (sizeof(float4) + 2 * sizeof(int) + 1) +
         4 * sizeof(int);
}

}  // namespace

// The walk of B x K tests (tensors as Args lists them, contiguous): writes
// out (B, K) and, where counts is not null, counts (B, K, 4).
extern "C" int plade_penetration_walk(
    const int* cand, const int* src, const int* tgt, const float* start,
    const float* direc, const float* length, const uint8_t* valid,
    const float* R, const float* t, const float* src_pts,
    const int* src_counts, const float* tgt_pts, const int* tgt_counts,
    const float* src_coeffs, const float* tgt_coeffs, const float* radius,
    const float* min_d, const float* r_occ, const float* r_near,
    uint8_t* out, int* counts, int B, int K, int C, int Ps, int Pt, int M,
    int S, int min_points, float max_ratio, cudaStream_t stream) {
  if (B < 0 || K < 0 || C < 0 || Ps < 0 || Pt < 0 || M < 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tests = static_cast<long long>(B) * K;
  if (tests == 0) return static_cast<int>(cudaGetLastError());
  if (tests > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(M, S);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args a{cand,       src,        tgt,        start,  direc,
               length,     valid,      R,          t,      src_pts,
               src_counts, tgt_pts,    tgt_counts, src_coeffs,
               tgt_coeffs, radius,     min_d,      r_occ,  r_near,
               out,        counts,     K,          C,      Ps,
               Pt,         M,          S,          min_points,
               max_ratio};
  walk_kernel<<<static_cast<unsigned>(tests), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
