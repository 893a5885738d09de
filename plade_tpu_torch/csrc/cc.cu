// Morphological close + connected-component labelling for Hopper (sm_90a).
//
// K3  plade_close_and_label  replaces the Pallas kernels
//     plade_tpu/kernels/cc.py::close_and_label_lanes (and, at L = 1,
//     close_and_label): per lane, a G x G occupancy grid is closed with the
//     cross structuring element (dilate, erode, union with the occupied
//     cells), then labelled by `iters` Jacobi rounds of 3 x 3 min-label
//     propagation.  After k rounds a closed cell holds the minimum flat
//     index r * G + c among the closed cells within k 8-connected steps of
//     it (once converged, the minimum of its component); every other cell
//     holds G * G.
//
// What bounds it on the card: nothing in device memory.  One lane is
// G * G int32 in and out (16 KB at G = 64), and lanes are few (6 or 12 per
// extraction round), so each lane is one block on one SM.  Its time is the
// number of rounds it runs times the cost of one round: one SM's issue of a
// round's instructions (at G = 64, 4096 cells x 4 minima, as the separable
// 3 x 3 min takes two vertically and two horizontally), plus the latency of
// the one block barrier that ends each round.  Rounds form a chain: round
// k + 1 reads what round k wrote, across the whole grid.
//
// Design, to spend as few instructions and barriers on a round as it can:
// - Labels are at most G * G <= 16384, so two neighbouring columns share
//   one 32-bit word in 16-bit halves and one `min.u16x2` takes the minimum
//   of both.
// - The grid is specialised at compile time for G = 32 and 64; any other
//   G <= 128, and an input or output that is not 8-byte aligned, runs the
//   G = 128 layout with the grid size at run time (cells outside the grid
//   are never closed and hold G * G).  A thread's cells and their flat
//   indices come from its thread index once, before the rounds.
// - A thread owns S consecutive rows of K adjacent words (2K columns) and
//   keeps their labels and closed masks in registers for the whole loop
//   (S = 2, 4, 8 at G = 32, 64, 128: 256, 512 and 512 threads).  S = 2 and
//   4 gave the fastest rounds of S = 2-16 at G = 32 and 64 in a probe on
//   the card; at G = 128, S = 8 and 16 were within 2% of each other, and
//   S = 8 holds half the registers a thread.  The lanes of a warp (a
//   half warp at G = 32) cover one whole row, so a word's left and right
//   neighbours come from the lane beside it by one `shfl` each way per
//   row, and the grid's left and right edges are the row's first and last
//   lane.
// - A round takes the vertical 3-min in registers, then the horizontal
//   3-min of that across the shuffled neighbour words (the plain version's
//   separable box min, in the other order), and sets non-closed cells to
//   G * G.  Only the strip's top and bottom rows go through shared memory,
//   double-buffered, for the strips above and below; the border slots hold
//   all-ones words, which exceed every label and so never win a minimum.
// - A round ends on one `__syncthreads_or(changed)`: the loop stops after
//   `iters` rounds or after the first round that changes no label, which
//   leaves a fixed point, so every later round would change nothing and
//   the early stop returns bit for bit the labels of all `iters` rounds.
// - The close runs once, on the same packed words with 0xffff per set
//   half: dilate (out-of-grid 0), erode (out-of-grid 1), union with the
//   filled cells; it costs two more barriers per launch.
// Integer-only and without atomics, so the result is exact, also on grids
// that `iters` rounds do not converge.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxGrid = 128;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kOnes = 0xffffffffu;

__device__ __forceinline__ unsigned vmin2(unsigned a, unsigned b) {
  unsigned r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// The word one column to the right of x's columns, with y the word right
// of x: (x's high half, y's low half).  With x the word left of y it is the
// word one column to the left of y's columns.
__device__ __forceinline__ unsigned straddle(unsigned x, unsigned y) {
  return __byte_perm(x, y, 0x5432);
}

template <int GM, int S>
struct Layout {
  static constexpr int kWords = GM / 2;                       // a row
  static constexpr int kLanes = kWords < 32 ? kWords : 32;    // a row
  static constexpr int kK = kWords / kLanes;                  // a lane
  static constexpr int kStrips = GM / S;
  static constexpr int kThreads = kStrips * kLanes;
  static_assert(GM % S == 0 && kWords % kLanes == 0, "layout");
  static_assert(kThreads % 32 == 0, "whole warps");
};

// A lane's words of one row -> the words one column left (l) and right (r)
// of each; the grid's edges give `fill` in the missing half.
template <int LN, int K>
__device__ __forceinline__ void neighbours(const unsigned (&x)[K],
                                           unsigned (&l)[K], unsigned (&r)[K],
                                           unsigned lmask, unsigned rmask,
                                           bool fill_ones) {
  const unsigned from_left = __shfl_up_sync(kFullMask, x[K - 1], 1, LN);
  const unsigned from_right = __shfl_down_sync(kFullMask, x[0], 1, LN);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    l[k] = straddle(k == 0 ? from_left : x[k - 1], x[k]);
    r[k] = straddle(x[k], k == K - 1 ? from_right : x[k + 1]);
  }
  if (fill_ones) {
    l[0] |= lmask;
    r[K - 1] |= rmask;
  } else {
    l[0] &= ~lmask;
    r[K - 1] &= ~rmask;
  }
}

template <int GM, int S, bool kFixed>
__global__ void __launch_bounds__(Layout<GM, S>::kThreads)
    close_label_kernel(const int* __restrict__ occ, int* __restrict__ out,
                       int grid, int iters) {
  using Lay = Layout<GM, S>;
  constexpr int W = Lay::kWords, LN = Lay::kLanes, K = Lay::kK;
  constexpr int NS = Lay::kStrips;
  // [buffer][strip + 1][top row, bottom row][word]; slots 0 and NS + 1 are
  // the borders above and below the grid
  __shared__ unsigned halo[2][NS + 2][2][W];

  const int G = kFixed ? GM : grid;
  const int GG = G * G;
  const unsigned inf2 = static_cast<unsigned>(GG) * 0x10001u;
  const int strip = threadIdx.x / LN;
  const int pos = threadIdx.x % LN;
  const int row0 = strip * S;
  const int word0 = pos * K;
  const unsigned lmask = pos == 0 ? 0x0000ffffu : 0u;
  const unsigned rmask = pos == LN - 1 ? 0xffff0000u : 0u;
  const int* src = occ + static_cast<size_t>(blockIdx.x) * GG;
  int* dst = out + static_cast<size_t>(blockIdx.x) * GG;

  for (int i = threadIdx.x; i < 2 * 2 * W; i += Lay::kThreads) {
    const int b = i / (2 * W), j = i % (2 * W);
    (&halo[b][0][0][0])[j] = kOnes;
    (&halo[b][NS + 1][0][0])[j] = kOnes;
  }

  // filled cells (F), the in-grid mask (M, later the closed mask) and the
  // flat indices (X, later the labels), two columns a word
  unsigned F[S][K], M[S][K], X[S][K];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int r = row0 + i;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = 2 * (word0 + k);
      int a, b;
      unsigned in;
      if (kFixed) {
        const int2 v = *reinterpret_cast<const int2*>(src + r * G + c);
        a = v.x;
        b = v.y;
        in = kOnes;
      } else {
        in = (r < G && c < G ? 0x0000ffffu : 0u) |
             (r < G && c + 1 < G ? 0xffff0000u : 0u);
        a = (in & 0x0000ffffu) ? src[r * G + c] : 0;
        b = (in & 0xffff0000u) ? src[r * G + c + 1] : 0;
      }
      F[i][k] = (a > 0 ? 0x0000ffffu : 0u) | (b > 0 ? 0xffff0000u : 0u);
      M[i][k] = in;
      X[i][k] = static_cast<unsigned>(r * G + c) |
                (static_cast<unsigned>(r * G + c + 1) << 16);
    }
  }

  auto publish = [&](int buf, const unsigned(&v)[S][K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      halo[buf][strip + 1][0][word0 + k] = v[0][k];
      halo[buf][strip + 1][1][word0 + k] = v[S - 1][k];
    }
  };
  auto fetch = [&](int buf, unsigned(&up)[K], unsigned(&down)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      up[k] = halo[buf][strip][1][word0 + k];
      down[k] = halo[buf][strip + 2][0][word0 + k];
    }
  };

  // dilate with the cross; out-of-grid cells count as 0
  publish(0, F);
  __syncthreads();
  unsigned D[S][K];
  {
    unsigned up[K], down[K];
    fetch(0, up, down);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (strip == 0) up[k] = 0u;
      if (strip == NS - 1) down[k] = 0u;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      unsigned l[K], r[K];
      neighbours<LN, K>(F[i], l, r, lmask, rmask, false);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const unsigned above = i == 0 ? up[k] : F[i - 1][k];
        const unsigned below = i == S - 1 ? down[k] : F[i + 1][k];
        // cells outside the grid count as 1 for the erosion
        D[i][k] = F[i][k] | above | below | l[k] | r[k] | ~M[i][k];
      }
    }
  }
  // erode the dilated grid; out-of-grid cells count as 1; union with the
  // filled cells; the labels start from the flat indices of closed cells
  publish(1, D);
  __syncthreads();
  {
    unsigned up[K], down[K];
    fetch(1, up, down);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      unsigned l[K], r[K];
      neighbours<LN, K>(D[i], l, r, lmask, rmask, true);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const unsigned above = i == 0 ? up[k] : D[i - 1][k];
        const unsigned below = i == S - 1 ? down[k] : D[i + 1][k];
        const unsigned ero = D[i][k] & above & below & l[k] & r[k];
        M[i][k] &= ero | F[i][k];
        X[i][k] = (X[i][k] & M[i][k]) | (inf2 & ~M[i][k]);
      }
    }
  }
  publish(0, X);
  __syncthreads();

  int buf = 0;
  for (int it = 0; it < iters; ++it) {
    unsigned up[K], down[K], V[S][K];
    fetch(buf, up, down);
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const unsigned above = i == 0 ? up[k] : X[i - 1][k];
        const unsigned below = i == S - 1 ? down[k] : X[i + 1][k];
        V[i][k] = vmin2(vmin2(above, X[i][k]), below);
      }
    }
    unsigned changed = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      unsigned l[K], r[K];
      neighbours<LN, K>(V[i], l, r, lmask, rmask, true);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const unsigned m = vmin2(vmin2(l[k], V[i][k]), r[k]);
        const unsigned lab = (m & M[i][k]) | (inf2 & ~M[i][k]);
        changed |= lab ^ X[i][k];
        X[i][k] = lab;
      }
    }
    buf ^= 1;
    publish(buf, X);
    // the barrier also orders this round's writes before the next reads
    if (!__syncthreads_or(changed != 0)) break;
  }

#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int r = row0 + i;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = 2 * (word0 + k);
      const int lo = static_cast<int>(X[i][k] & 0xffffu);
      const int hi = static_cast<int>(X[i][k] >> 16);
      if (kFixed) {
        *reinterpret_cast<int2*>(dst + r * G + c) = make_int2(lo, hi);
      } else if (r < G) {
        if (c < G) dst[r * G + c] = lo;
        if (c + 1 < G) dst[r * G + c + 1] = hi;
      }
    }
  }
}

template <int GM, int S, bool kFixed>
cudaError_t launch(const int* occ, int* out, int L, int G, int iters,
                   cudaStream_t stream) {
  close_label_kernel<GM, S, kFixed>
      <<<L, Layout<GM, S>::kThreads, 0, stream>>>(occ, out, G, iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" int plade_close_and_label(const int* occ, int* out, int L, int G,
                                     int iters, cudaStream_t stream) {
  if (G < 1 || G > kMaxGrid || L < 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return static_cast<int>(cudaSuccess);
  // the specialised instances move two cells at a time (8-byte aligned)
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(occ) | reinterpret_cast<uintptr_t>(out)) &
       7) == 0;
  cudaError_t err;
  switch (aligned ? G : 0) {
    case 32: err = launch<32, 2, true>(occ, out, L, G, iters, stream); break;
    case 64: err = launch<64, 4, true>(occ, out, L, G, iters, stream); break;
    default: err = launch<128, 8, false>(occ, out, L, G, iters, stream);
  }
  return static_cast<int>(err);
}
