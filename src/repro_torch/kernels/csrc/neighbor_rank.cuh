// The GUITAR neighbor-ranking kernel (paper Eq. 3 / Eq. 4 keys and the
// adaptive alpha*theta mask), one body for every row source: see
// neighbor_rank.cu (pre-gathered rows) and neighbor_rank_fused.cu (rows by
// id from the resident corpus) for what each replaces and what bounds it.
//
// A lane's rows are in flight at once. A CTA takes ``lanes`` lanes; per
// pass over up to ``rows`` of a lane's B neighbor rows (all of them at the
// serving shape):
//  - the index-fused form first reads the pass's ids, one coalesced read
//    into shared memory, and a barrier;
//  - every load of the pass is issued before any is used, all by
//    cp.async: x[q] and g[q] by 4-byte copies, float32 rows by 16-byte
//    copies where the rows are 16-byte aligned (4-byte otherwise), bf16
//    and int8 rows as stored, by 4-byte copies where their bytes are
//    4-byte aligned (else through a batch of kRankBatch loads in
//    registers), and each int8 row's scale; then one wait and one barrier;
//  - a group of G threads per row (a power of two) sums <d, g>, |d|^2 and
//    |g|^2 over its columns d = gi, gi + G, ... in one pass (an fmaf chain
//    each, d = row - x, a bf16 or int8 element dequantized by the row
//    source as it is read), then adds the G partials with log2 G xor
//    shuffles, and forms the key.
// Columns past ``cols`` are staged in chunks, each thread carrying its
// sums from chunk to chunk, so the order of summation does not depend on
// the chunking. theta is a warp min (max) of each thread's best key, then
// one pass over the lane's warp partials in shared memory; the threads
// that hold the keys write the keys and the mask. The keys need no room
// in shared memory: a thread keeps its last pass's key in a register and
// reads an earlier pass's back from ``key``, which it wrote itself.
#pragma once

#include "rows.cuh"

namespace repro {

constexpr int kRankMaxThreads = 1024;  // threads per CTA at most
constexpr int kRankElems = 10;         // row columns per thread aimed at
constexpr int kRankLanes = 1;          // lanes per CTA
constexpr int kRankMaxCols = 1024;     // columns per chunk at most
constexpr int kRankRowFloats = 16384;  // staged row floats per CTA at most
constexpr int kRankBatch = 8;          // unaligned row loads per thread

// The phases of the body: a copy stopped after one is a cut-down copy of
// the kernel (tools/rank_split.py); kRankAll is the kernel.
enum RankStop : int {
  kRankLaunch = 0,  // nothing done
  kRankLoads = 1,   // + the ids and the staging
  kRankDot = 2,     // + <d, g>, |d|^2, |g|^2 over the group
  kRankKeys = 3,    // + the keys, written
  kRankAll = 4,     // + theta and the mask
};

__host__ __device__ constexpr int rank_min(int a, int b) {
  return a < b ? a : b;
}

__host__ __device__ constexpr int rank_align(int v, int a) {
  return (v + a - 1) / a * a;
}

// Columns per chunk at G threads per row: D up to kRankMaxCols, in
// multiples of max(G, 4) (16-byte copies; a thread's columns gi + G j are
// the same in every chunk).
__host__ __device__ constexpr int rank_cols(int D, int G) {
  return rank_min(rank_align(D, G > 4 ? G : 4), kRankMaxCols);
}

// Floats per staged row: the chunk's columns, one unit max(G, 4) more
// where they are an even number of units, so that the 32 / G rows a warp
// reads at once start on distinct banks.
__host__ __device__ constexpr int rank_pitch(int cols, int G) {
  return G < kWarp && cols / (G > 4 ? G : 4) % 2 == 0 ? cols + (G > 4 ? G : 4)
                                                      : cols;
}

// The launch layout; mirrored by neighbor_rank_plan in
// kernels/neighbor_rank/ops.py.
struct RankPlan {
  int G;             // threads per row: a power of two, 1 to 32
  int lanes;         // lanes per CTA
  int rows;          // rows per pass of a lane
  int cols;          // columns per chunk
  int pitch;         // floats per staged row
  int lane_threads;  // threads per lane, whole warps
  int threads;       // threads per CTA
  int smem;          // dynamic shared memory per CTA, bytes
};

// The plan at G threads per row and ``lanes`` lanes per CTA. Shared
// memory per lane: the pass's staged rows, x and g of a chunk, the pass's
// ids (int64) and its rows' scales; then one partial theta per warp.
inline RankPlan rank_plan_at(int B, int D, int G, int lanes) {
  RankPlan p;
  p.G = G;
  p.lanes = lanes;
  p.cols = rank_cols(D, G);
  p.pitch = rank_pitch(p.cols, G);
  p.rows = rank_min(rank_min(B, kRankMaxThreads / (lanes * G)),
                    kRankRowFloats / (lanes * p.pitch));
  p.lane_threads = rank_align(p.rows * G, kWarp);
  p.threads = lanes * p.lane_threads;
  p.smem = static_cast<int>(
      sizeof(float) * (lanes * (p.rows * p.pitch + 2 * p.cols + 3 * p.rows) +
                       p.threads / kWarp));
  return p;
}

// The plan of a call: the fewest threads per row that leave each at most
// kRankElems columns (4 at D = 40), kRankLanes lanes per CTA: the best
// point of tools/rank_split.py's sweep at the serving shape.
inline RankPlan neighbor_rank_plan(int B, int D) {
  int G = 1;
  while (G < kWarp && G * kRankElems < D) G *= 2;
  return rank_plan_at(B, D, G, kRankLanes);
}

// The kernel's widths: from the plan at run time, or compiled in.
struct RankRuntime {
  static constexpr int kD = 0, kG = 0, kLanes = 0;
};

template <int D, int G, int Lanes>
struct RankFixed {
  static constexpr int kD = D, kG = G, kLanes = Lanes;
};

// the serving width (make_family_measure(..., 40)) at its plan
using RankServing = RankFixed<40, 4, kRankLanes>;

template <class W>
inline bool rank_copy_matches(const RankPlan& p, int D) {
  return D == W::kD && p.G == W::kG && p.lanes == W::kLanes;
}

struct RankArgs {
  int Q, B, D;
  float alpha;
  int by_angle;
  int wide;  // every row 16-byte (float32) or 4-byte (bf16, int8) aligned
  RankPlan plan;
};

// Keys and the alpha*theta mask of ``a.plan.lanes`` lanes per CTA; ``nv``
// is the row source (rows.cuh): pre-gathered float32 rows, or rows by id
// from the resident corpus, staged as stored and dequantized as read.
template <class Rows, class W, int Stop>
__global__ void __launch_bounds__(kRankMaxThreads)
neighbor_rank_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     Rows nv, const unsigned char* __restrict__ valid,
                     float* __restrict__ key, unsigned char* __restrict__ mask,
                     RankArgs a) {
  if (Stop == kRankLaunch) return;
  extern __shared__ __align__(16) float sm[];
  constexpr bool kFixed = W::kD > 0;
  const int D = kFixed ? W::kD : a.D;
  const int G = kFixed ? W::kG : a.plan.G;
  const int lanes = kFixed ? W::kLanes : a.plan.lanes;
  const int cols = kFixed ? rank_cols(W::kD, W::kG) : a.plan.cols;
  const int pitch =
      kFixed ? rank_pitch(rank_cols(W::kD, W::kG), W::kG) : a.plan.pitch;
  const int B = a.B, P = a.plan.rows, LT = a.plan.lane_threads;
  const int tid = threadIdx.x;
  const int l = lanes == 1 ? 0 : tid / LT;
  const int lt = tid - l * LT;
  const int grp = lt / G, gi = lt - grp * G;
  const int q = blockIdx.x * lanes + l;
  const bool lane_ok = q < a.Q;
  const bool by_angle = a.by_angle != 0;
  const float eps = 1e-12f;
  float* rs = sm + l * P * pitch;  // the lane's staged rows, row t at t*pitch
  using T = std::remove_cv_t<
      std::remove_pointer_t<decltype(std::declval<typename Rows::Row>().p)>>;
  constexpr int kPer = 4 / kRowElemBytes<Rows>;  // elements per float
  float* xs = sm + lanes * P * pitch + 2 * l * cols;  // x[q] of the chunk
  float* gs = xs + cols;                              // g[q] of the chunk
  int64_t* ids =
      reinterpret_cast<int64_t*>(sm + lanes * (P * pitch + 2 * cols)) + l * P;
  float* sc = sm + lanes * (P * pitch + 2 * cols + 2 * P) + l * P;  // scales
  float* part = sm + lanes * (P * pitch + 2 * cols + 3 * P);  // per warp
  const float* xq = x + static_cast<size_t>(q) * D;
  const float* gq = g + static_cast<size_t>(q) * D;

  float best = by_angle ? INFINITY : -INFINITY;  // of the thread's keys
  float k = INFINITY;  // the key of the thread's last row, and its valid
  bool v = false;
  for (int b0 = 0; b0 < B; b0 += P) {
    const int nr = rank_min(P, B - b0);
    const bool mine = lane_ok && grp < nr;
    const size_t row0 = static_cast<size_t>(q) * B + b0;
    if constexpr (Rows::kById) {
      if (lane_ok && lt < nr) ids[lt] = nv.id(row0 + lt);
      __syncthreads();
    }
    const bool vb = mine && valid[row0 + grp] != 0;
    auto row_of = [&](int t) {
      if constexpr (Rows::kById)
        return nv.at(ids[t], D);
      else
        return nv.at(row0 + t, D);
    };
    float dp = 0.f, nn = 0.f, gp = 0.f;
    for (int d0 = 0; d0 < D; d0 += cols) {
      const int dc = rank_min(cols, D - d0);
      if (lane_ok) {
        for (int e = lt; e < dc; e += LT) {
          cp_async4(xs + e, xq + d0 + e);
          cp_async4(gs + e, gq + d0 + e);
        }
        if constexpr (kF32Rows<Rows>) {
          if (a.wide) {
            const int c4 = dc >> 2;
            for (int e = lt; e < nr * c4; e += LT) {
              const int t = e / c4, c = (e - t * c4) * 4;
              cp_async16(rs + t * pitch + c, row_of(t).p + d0 + c);
            }
          } else {
            for (int e = lt; e < nr * dc; e += LT) {
              const int t = e / dc, c = e - t * dc;
              cp_async4(rs + t * pitch + c, row_of(t).p + d0 + c);
            }
          }
        } else {
          if constexpr (Rows::kScaled)
            if (d0 == 0 && lt < nr) cp_async4(sc + lt, nv.scales + ids[lt]);
          if (a.wide) {  // the rows' bytes as stored, 4 at a time
            const int w = dc / kPer;
            for (int e = lt; e < nr * w; e += LT) {
              const int t = e / w, c = e - t * w;
              cp_async4(rs + t * pitch + c,
                        reinterpret_cast<const float*>(row_of(t).p + d0) + c);
            }
          } else {  // every load of a batch in flight before any store
            T* rt = reinterpret_cast<T*>(rs);
            for (int e0 = lt; e0 < nr * dc; e0 += kRankBatch * LT) {
              T val[kRankBatch];
              int at[kRankBatch];
#pragma unroll
              for (int j = 0; j < kRankBatch; ++j) {
                const int e = e0 + j * LT, t = e / dc, c = e - t * dc;
                at[j] = e < nr * dc ? t * pitch * kPer + c : -1;
                if (at[j] >= 0) val[j] = row_of(t).p[d0 + c];
              }
#pragma unroll
              for (int j = 0; j < kRankBatch; ++j)
                if (at[j] >= 0) rt[at[j]] = val[j];
            }
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (Stop >= kRankDot && mine) {
        const float* r = rs + grp * pitch;
        const float s = Rows::kScaled ? sc[grp] : 1.f;
        auto elem = [&](int d) {  // float32, or dequantized by the source
          if constexpr (kF32Rows<Rows>)
            return r[d];
          else
            return nv.get(
                typename Rows::Row{reinterpret_cast<const T*>(r), s}, d);
        };
        for (int d = gi; d < dc; d += G) {
          const float df = elem(d) - xs[d];
          dp = fmaf(df, gs[d], dp);
          nn = fmaf(df, df, nn);
          gp = fmaf(gs[d], gs[d], gp);
        }
      }
      // the next chunk's copies may not land before every thread has read
      if (d0 + cols < D || b0 + P < B) __syncthreads();
    }
    if (Stop == kRankLoads) {  // keep the staging alive
      if (mine && gi == 0 && rs[grp * pitch] == 1234.5f) key[row0] = xs[0];
      continue;
    }
    for (int o = G / 2; o > 0; o >>= 1) {
      dp += __shfl_xor_sync(kFull, dp, o);
      nn += __shfl_xor_sync(kFull, nn, o);
      gp += __shfl_xor_sync(kFull, gp, o);
    }
    if (Stop == kRankDot) {
      if (mine && gi == 0 && dp == 1234.5f) key[row0] = nn + gp;
      continue;
    }
    float kb;
    if (by_angle) {
      const float dn = sqrtf(nn) + eps, gn = sqrtf(gp) + eps;
      const float c = fminf(fmaxf(dp / (dn * gn), -1.f), 1.f);
      kb = vb ? acosf(c) : INFINITY;
    } else {
      kb = vb ? -(dp / (sqrtf(gp) + eps)) : INFINITY;
    }
    if (mine) {
      if (gi == 0) key[row0 + grp] = kb;
      // the projection's rank value is -key: the projection, or -inf
      best = by_angle ? fminf(best, kb) : fmaxf(best, -kb);
      k = kb;
      v = vb;
    }
  }
  if (Stop < kRankAll) return;

  best = by_angle ? warp_min(best) : warp_max(best);
  if (tid % kWarp == 0) part[tid / kWarp] = best;
  __syncthreads();
  const int nw = LT / kWarp;
  float theta = part[l * nw];
  for (int w = 1; w < nw; ++w)
    theta = by_angle ? fminf(theta, part[l * nw + w])
                     : fmaxf(theta, part[l * nw + w]);
  if (!lane_ok || gi != 0) return;
  for (int b = grp; b < B; b += P) {  // the thread's rows; the last is k
    const size_t qb = static_cast<size_t>(q) * B + b;
    const bool last = b + P >= B;
    const float kb = last ? k : key[qb];
    const bool vb = last ? v : valid[qb] != 0;
    bool in;
    if (by_angle) {
      in = vb && (kb <= a.alpha * theta + eps);
    } else {
      const float bound = theta >= 0.f ? theta / a.alpha : theta * a.alpha;
      in = vb && (-kb >= bound - eps);
    }
    mask[qb] = in ? 1 : 0;
  }
}

template <class Rows, class W, int Stop = kRankAll>
inline cudaError_t launch_neighbor_rank_as(const void* x, const void* g,
                                           Rows nv, const void* valid,
                                           void* key, void* mask, int Q,
                                           int B, int D, float alpha,
                                           int by_angle, const RankPlan& plan,
                                           void* stream) {
  // 16-byte copies of float32 rows, 4-byte copies of bf16 and int8 rows
  constexpr int kAlign = kF32Rows<Rows> ? 16 : 4;
  const bool wide =
      D * kRowElemBytes<Rows> % kAlign == 0 &&
      reinterpret_cast<uintptr_t>(nv.base()) % kAlign == 0;
  const RankArgs a{Q, B, D, alpha, by_angle, wide, plan};
  auto kernel = neighbor_rank_kernel<Rows, W, Stop>;
  allow_smem(kernel, plan.smem);
  kernel<<<(Q + plan.lanes - 1) / plan.lanes, plan.threads, plan.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), nv,
      static_cast<const unsigned char*>(valid), static_cast<float*>(key),
      static_cast<unsigned char*>(mask), a);
  return cudaGetLastError();
}

// One launch of the plan's CTAs over Q lanes: the copy compiled for the
// serving width where it matches, the run-time-width copy otherwise.
template <class Rows, int Stop = kRankAll>
inline cudaError_t launch_neighbor_rank(const void* x, const void* g, Rows nv,
                                        const void* valid, void* key,
                                        void* mask, int Q, int B, int D,
                                        float alpha, int by_angle,
                                        void* stream) {
  if (Q <= 0 || B <= 0) return cudaGetLastError();
  const RankPlan plan = neighbor_rank_plan(B, D);
  if (rank_copy_matches<RankServing>(plan, D))
    return launch_neighbor_rank_as<Rows, RankServing, Stop>(
        x, g, nv, valid, key, mask, Q, B, D, alpha, by_angle, plan, stream);
  return launch_neighbor_rank_as<Rows, RankRuntime, Stop>(
      x, g, nv, valid, key, mask, Q, B, D, alpha, by_angle, plan, stream);
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the kernel at a plan
template <class Rows, class W>
inline cudaError_t rank_blocks_per_sm(const RankPlan& plan, int* n) {
  auto kernel = neighbor_rank_kernel<Rows, W, kRankAll>;
  allow_smem(kernel, plan.smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, plan.threads,
                                                       plan.smem);
}

}  // namespace repro
