// The MLP measure's kernels (mlp_score, mlp_score_fused, mlp_grad,
// mlp_grad_fused) and the DeepFM measure's (deepfm_score,
// deepfm_score_fused, deepfm_grad, deepfm_grad_fused): one body, a tile of
// T rows per thread-block cluster of n CTAs, run as the value and
// analytic df/dx (mlp_grad_cluster_kernel, T = 4) or forward only as the
// score (mlp_score_cluster_kernel, T = 8).
//
//   MLP:    f(x, q) = sigmoid(MLP([x | q]))
//   DeepFM: f(x, q) = sigmoid(MLP([q_deep | x_deep]) + <x_fm, q_fm>)
//
// df/dx by the hand-derived backward. The body serves both measures over
// an input policy (MLPInput, DeepFMInput): the DeepFM measure's deep part
// is an MLP (D = fm + dd: [q[fm:] | x[fm:]], 2 dd -> H0 -> H1 -> 1) whose
// input has the x half second, so its backward reads W_0's rows [dd, 2
// dd); the FM term is local to a row: the grad's CTAs each add <x_fm,
// q_fm> to their tile's logits after the top layer's dot and bias, and
// CTA 0 writes the gradient's first fm columns, g_logit * q_fm; the
// score's CTA 0 adds it after the partial dots and the bias. The policy's
// branches, the tile and the score's dropping of the backward are
// resolved at compile time, so the MLP instantiations keep their
// arithmetic and its order (and, but for the grad's run-time-width copy
// over pre-gathered rows, their SASS opcode counts; PERF.md).
//
// Layout. The host plans n from the widths: about 8 hidden units per CTA,
// a power of two from 2 to the portable cluster size of 8 for the grad,
// to 4 for the score (the grad's n = 8 at 80 -> 64 -> 64 -> 1, and at the
// serving DeepFM's 64 -> 64 -> 64 -> 1, configs/guitar_deepfm.py; the
// score's 4 at both; 1 without a hidden layer). CTA c owns a
// contiguous slice of the units of every hidden layer (a multiple of 4
// units) and of the Dx gradient columns (Dx = dd for DeepFM: 4 of 32 at
// serving), and computes only those outputs, in both directions, from
// full inputs:
//
//  - forward: relu(z_i)[:, own units] from the full relu(z_{i-1}), with
//    the columns W_i[:, own units];
//  - backward (grad): g_{i-1}[:, own units] = mask * (g_i W_i^T) from the
//    full g_i, with the rows W_i[own units, :], and at the end gx[:, own
//    columns] from the full g_0 and the rows W_0[own columns, :];
//  - the value: for the grad, the full dot of the top layer with the last
//    layer's weights for the tile's rows in every CTA (each needs f');
//    for the score, each CTA's partial dot over its own units of the top
//    layer, which it keeps rather than pushes, sent to CTA 0, which adds
//    the n partials in rank order, the bias and (DeepFM) the FM term, and
//    writes the score.
#pragma once

#include <stdint.h>

#include <type_traits>
#include <utility>

#include "deepfm.cuh"
#include "mlp.cuh"
#include "rows.cuh"
#include "tc.cuh"

namespace repro {

constexpr int kMLPGradThreads = 256;
constexpr int kMLPGradMaxCluster = 8;      // the portable cluster size
constexpr int kMLPGradUnitsPerCTA = 8;     // hidden units per CTA aimed at
constexpr int kMLPGradTile = 4;            // the grad's rows per cluster
constexpr size_t kMLPGradSmemCap = 232448; // opt-in shared memory per block
constexpr int kMLPGradBarFloats = 32;      // 2 * kMaxMLPLayers - 3 mbarriers
constexpr int kMLPGradAll = 3;

__host__ __device__ constexpr int mlp_grad_align4(int v) {
  return (v + 3) & ~3;
}

// A launch's layout: cluster size, slice widths and shared-memory
// offsets in floats. Mirrored by mlp_grad_plan and mlp_score_plan in
// kernels/mlp_grad/ops.py.
struct MLPGradPlan {
  int n;                     // CTAs per cluster
  int s[kMaxMLPLayers];      // units of hidden layer i per CTA (4 | s)
  int ks;                    // Dx gradient columns per CTA
  int wf[kMaxMLPLayers];     // W_i[:, own units], align4(dim[i]) x s[i]
  int bf[kMaxMLPLayers];     // b_i[own units]
  int wb[kMaxMLPLayers];     // i >= 1: W_i[own units of layer i - 1, :],
                             // s[i - 1] x align4(dim[i + 1]); i = 0:
                             // W_0[own x columns, :], align4(ks) x
                             // align4(dim[1]) (grad only)
  int wl, bl;                // the last layer's weights and bias
  int x;                     // the tile's [x | q], T x align4(dim[0])
                             // (the score's row pitches: mlp_cluster_plan)
  int a[kMaxMLPLayers];      // hidden layer i's relu(z) and
  int g[kMaxMLPLayers];      // cotangent (grad), T x align4(dim[i + 1])
                             // each; the score's g[0]: dense4's partial
                             // sums
  int gl;                    // grad: f * (1 - f) per row; score: the top
                             // layer's partial dots, n x T (CTA 0's)
  int floats;
};

// Plan a launch for ``net`` at a tile of T rows on at most n_max CTAs
// per cluster, with the backward's buffers (``grad``) or without them;
// false if a CTA's shared memory does not fit. The grad's plan (T = 4)
// and the score's at T <= 8 fit every network the MLP kernels admit
// (mlp_smem_bytes; tests/test_torch_mlp.py).
inline bool mlp_cluster_plan(MLPGradPlan& p, const MLPNet& net, int T,
                             int n_max, bool grad) {
  const int L = net.layers;
  int n = 1;
  if (L > 1) {
    n = 2;
    while (n < n_max && n * kMLPGradUnitsPerCTA < net.gmax) n *= 2;
  }
  p.n = n;
  for (int i = 0; i + 1 < L; ++i) {
    p.s[i] = mlp_grad_align4((net.dim[i + 1] + n - 1) / n);
  }
  p.ks = (net.dx + n - 1) / n;
  int off = kMLPGradBarFloats;
  auto take = [&off](int floats) {
    const int o = off;
    off += mlp_grad_align4(floats);
    return o;
  };
  for (int i = 0; i + 1 < L; ++i) {
    p.wf[i] = take(mlp_grad_align4(net.dim[i]) * p.s[i]);
    p.bf[i] = take(p.s[i]);
    p.wb[i] = grad ? take((i > 0 ? p.s[i - 1] : mlp_grad_align4(p.ks)) *
                          mlp_grad_align4(net.dim[i + 1]))
                   : 0;
  }
  p.wl = take(mlp_grad_align4(net.dim[L - 1]));
  p.bl = take(1);
  // the score's row pitches are odd multiples of 4 floats (dense4's
  // kWarpK), and its g[0] holds dense4's partial sums
  auto pitch = [grad](int d) {
    return grad ? mlp_grad_align4(d) : mlp_grad_align4(d) | 4;
  };
  p.x = take(T * pitch(net.dim[0]));
  for (int i = 0; i + 1 < L; ++i) {
    p.a[i] = take(T * pitch(net.dim[i + 1]));
    p.g[i] = grad ? take(T * mlp_grad_align4(net.dim[i + 1])) : 0;
  }
  if (!grad && L > 1) p.g[0] = take(4 * kMLPGradThreads);
  p.gl = take(grad ? T : n * T);
  p.floats = off;
  return sizeof(float) * off <= kMLPGradSmemCap;
}

inline bool mlp_grad_plan(MLPGradPlan& p, const MLPNet& net) {
  return mlp_cluster_plan(p, net, kMLPGradTile, kMLPGradMaxCluster, true);
}

inline bool mlp_score_plan(MLPGradPlan& p, const MLPNet& net, int T,
                           int n_max) {
  return mlp_cluster_plan(p, net, T, n_max, false);
}

namespace mlpg {

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of ``addr`` (a local shared address) in
// CTA ``rank``'s shared memory.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 (4) bytes into a CTA's shared memory, counted on its mbarrier.
__device__ __forceinline__ void st_async4(uint32_t addr, float4 v,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n"
      :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async1(uint32_t addr, float v,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n"
      :: "r"(addr), "f"(v), "r"(bar) : "memory");
}

// Push the first ``valid`` (1-4) floats of ``v`` to address ``at`` of
// ranks g, g + KS, ... < n, each counted on that rank's ``bar``.
__device__ __forceinline__ void push(uint32_t at, float4 v, int valid,
                                     uint32_t bar, int g, int KS, int n) {
  for (int r = g; r < n; r += KS) {
    const uint32_t ra = map_rank(at, r), rb = map_rank(bar, r);
    if (valid == 4) {
      st_async4(ra, v, rb);
    } else {
      st_async1(ra, v.x, rb);
      if (valid > 1) st_async1(ra + 4, v.y, rb);
      if (valid > 2) st_async1(ra + 8, v.z, rb);
    }
  }
}

// Wait for phase 0 of an exchange's mbarrier: every byte pushed to this
// CTA has landed, and the pushers' writes are visible (cluster scope).
__device__ __forceinline__ void wait_exchange(uint64_t* bar) {
  const uint32_t a = tc::smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a) : "memory");
  } while (!done);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// f(e) for e < count, spread over the block: a loop of constant length
// when ``count`` is a constant, so that its copies go out back to back.
template <class F>
__device__ __forceinline__ void for_each(int count, F f) {
#pragma unroll 4
  for (int m = 0; m < (count + kMLPGradThreads - 1) / kMLPGradThreads; ++m) {
    const int e = m * kMLPGradThreads + static_cast<int>(threadIdx.x);
    if (e < count) f(e);
  }
}

// The CTA's slice [lo, lo + width) of ``units`` split s per CTA over n.
struct Slice {
  int lo, width;
};

__device__ __forceinline__ Slice slice_of(int rank, int s, int units,
                                          int n) {
  if (s * n == units) return {rank * s, s};
  const int lo = rank * s;
  const int hi = lo + s < units ? lo + s : units;
  return {lo, hi > lo ? hi - lo : 0};
}

// cp.async of a (rows, cols) row-major block (source row stride ld) into
// shared memory (row stride dld): 16-byte copies where the widths and both
// bases allow, 4-byte ones otherwise.
__device__ __forceinline__ void stage_rows(float* dst, int dld,
                                           const float* src, int ld,
                                           int rows, int cols) {
  if (((cols | ld | dld) & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(src) | tc::smem_u32(dst)) & 15) == 0) {
    const int w = cols >> 2;
    for_each(rows * w, [&](int e) {
      const int r = e / w, j = (e - r * w) * 4;
      cp_async16(dst + r * dld + j, src + static_cast<size_t>(r) * ld + j);
    });
  } else {
    for_each(rows * cols, [&](int e) {
      const int r = e / cols, j = e - r * cols;
      cp_async4(dst + r * dld + j, src + static_cast<size_t>(r) * ld + j);
    });
  }
}

// Zero columns [c0, c1) of ``rows`` rows (row stride ld).
__device__ __forceinline__ void zero_cols(float* p, int ld, int rows, int c0,
                                          int c1) {
  const int w = c1 - c0;
  if (w > 0)
    for_each(rows * w, [&](int e) {
      const int r = e / w;
      p[r * ld + c0 + e - r * w] = 0.f;
    });
}

// log2 of a power of two
__host__ __device__ constexpr int ilog2(int v) {
  return v > 1 ? 1 + ilog2(v >> 1) : 0;
}

// a0..a3 (units j0 + 0..3) += sum over k' in [k, k + 4) of v[k' - k] times
//   kRowW = false: W[k'][j0 + j]  (W: [k][unit], row stride ws)
//   kRowW = true:  W[j0 + j][k']  (W: [unit][k], row stride ws)
template <bool kRowW>
__device__ __forceinline__ void fma4x4(float4 v, const float* W, int ws, int k,
                                       int j0, float& a0, float& a1,
                                       float& a2, float& a3) {
  if constexpr (!kRowW) {
    const float4 w0 = ld4(W + (k + 0) * ws + j0);
    const float4 w1 = ld4(W + (k + 1) * ws + j0);
    const float4 w2 = ld4(W + (k + 2) * ws + j0);
    const float4 w3 = ld4(W + (k + 3) * ws + j0);
    a0 = fmaf(v.w, w3.x, fmaf(v.z, w2.x, fmaf(v.y, w1.x,
                                              fmaf(v.x, w0.x, a0))));
    a1 = fmaf(v.w, w3.y, fmaf(v.z, w2.y, fmaf(v.y, w1.y,
                                              fmaf(v.x, w0.y, a1))));
    a2 = fmaf(v.w, w3.z, fmaf(v.z, w2.z, fmaf(v.y, w1.z,
                                              fmaf(v.x, w0.z, a2))));
    a3 = fmaf(v.w, w3.w, fmaf(v.z, w2.w, fmaf(v.y, w1.w,
                                              fmaf(v.x, w0.w, a3))));
  } else {
    const float4 w0 = ld4(W + (j0 + 0) * ws + k);
    const float4 w1 = ld4(W + (j0 + 1) * ws + k);
    const float4 w2 = ld4(W + (j0 + 2) * ws + k);
    const float4 w3 = ld4(W + (j0 + 3) * ws + k);
    a0 = fmaf(v.w, w0.w, fmaf(v.z, w0.z, fmaf(v.y, w0.y,
                                              fmaf(v.x, w0.x, a0))));
    a1 = fmaf(v.w, w1.w, fmaf(v.z, w1.z, fmaf(v.y, w1.y,
                                              fmaf(v.x, w1.x, a1))));
    a2 = fmaf(v.w, w2.w, fmaf(v.z, w2.z, fmaf(v.y, w2.y,
                                              fmaf(v.x, w2.x, a2))));
    a3 = fmaf(v.w, w3.w, fmaf(v.z, w3.z, fmaf(v.y, w3.y,
                                              fmaf(v.x, w3.x, a3))));
  }
}

// out[t][j0 + j] (j < 4) for the tile's T rows and the CTA's ``w`` output
// units, summed over k < K4 (a multiple of 4; the pads are zero) of
// in[t][k] times W (fma4x4), plus bias[j] (nullable). A thread computes
// one row by four units; the K sum is split over KS threads (chunks of 4
// k, chunk = g, g + KS, ...), their sums added pairwise, g + KS / 2 into
// g first, then g + KS / 4, ... emit(t, j0, g, KS, out) receives the four
// units in each of the KS threads. The KS threads of a tile are
//  - kWarpK = false: KS neighbouring lanes, added by xor shuffles;
//  - kWarpK = true: threads tile, tile + tp, ... (tp: the tiles rounded up
//    to a power of two), so that a warp's lanes take rows t at one chunk
//    (one 16-byte load of W for the warp, and of inputs one per row: with
//    a row pitch of an odd multiple of 4 floats, 32 rows hit 32 distinct
//    banks), added through ``red`` (KS x tp float4) in shared memory.
//    The same sums in the same order as kWarpK = false.
template <int T, bool kRowW, bool kWarpK, class Emit>
__device__ __forceinline__ void dense4(const float* in, int pin, int K4,
                                       const float* W, int ws,
                                       const float* bias, int w, Emit emit,
                                       float4* red) {
  constexpr int lt = ilog2(T);
  const int tiles = ((w + 3) >> 2) << lt;
  int lks = 0;  // log2(KS)
  while (lks < 5 && (tiles << (lks + 1)) <= kMLPGradThreads) ++lks;
  const int KS = 1 << lks, chunks = K4 >> 2, span = tiles << lks;
  const int steps = (chunks + KS - 1) >> lks;
  if constexpr (kWarpK) {
    if (KS > 1) {  // then KS * tp <= kMLPGradThreads: one round
      int ltp = 0;
      while ((1 << ltp) < tiles) ++ltp;
      const int e = threadIdx.x;
      const int tile = e & ((1 << ltp) - 1), g = e >> ltp;
      const bool live = tile < tiles && g < KS;
      const int t = tile & (T - 1);
      const int j0 = (tile >> lt) * 4;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      if (live) {
        const float* x = in + t * pin;
#pragma unroll 5
        for (int m = 0; m < steps; ++m) {
          const int cc = g + (m << lks);
          if (cc >= chunks) break;
          fma4x4<kRowW>(ld4(x + cc * 4), W, ws, cc * 4, j0, a0, a1, a2, a3);
        }
      }
      __syncthreads();  // the previous call's sums are read
      if (g < KS) red[e] = make_float4(a0, a1, a2, a3);
      __syncthreads();
      for (int h = KS >> 1; h > 0; h >>= 1) {
        if (g < h) {
          const float4 p = red[e], q = red[e + (h << ltp)];
          red[e] = make_float4(p.x + q.x, p.y + q.y, p.z + q.z, p.w + q.w);
        }
        __syncthreads();
      }
      if (live) {
        float4 r = red[tile];
        if (bias != nullptr) {
          const float4 b = ld4(bias + j0);
          r = make_float4(r.x + b.x, r.y + b.y, r.z + b.z, r.w + b.w);
        }
        emit(t, j0, g, KS, r);
      }
      return;
    }
  }
  for (int base = 0; base < span; base += kMLPGradThreads) {
    const int e = base + threadIdx.x;
    const int tile = e >> lks, g = e & (KS - 1);
    const bool live = tile < tiles;
    const int t = tile & (T - 1);
    const int j0 = (tile >> lt) * 4;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    if (live) {
      const float* x = in + t * pin;
#pragma unroll 5
      for (int m = 0; m < steps; ++m) {
        const int cc = g + (m << lks);
        if (cc >= chunks) break;
        const int k = cc * 4;
        fma4x4<kRowW>(ld4(x + k), W, ws, k, j0, a0, a1, a2, a3);
      }
    }
    for (int o = KS >> 1; o > 0; o >>= 1) {
      a0 += __shfl_xor_sync(kFull, a0, o);
      a1 += __shfl_xor_sync(kFull, a1, o);
      a2 += __shfl_xor_sync(kFull, a2, o);
      a3 += __shfl_xor_sync(kFull, a3, o);
    }
    if (live) {
      if (bias != nullptr) {
        const float4 b = ld4(bias + j0);
        a0 += b.x;
        a1 += b.y;
        a2 += b.z;
        a3 += b.w;
      }
      emit(t, j0, g, KS, make_float4(a0, a1, a2, a3));
    }
  }
}

// How a launch's rows and queries make the network's input, and what a
// gradient row holds (the kernel's last parameter, so that the MLP's
// parameters lie where they did before there was a policy):
//  - MLPInput: the input [x | q]; rows and gradients Dx wide, queries Dq;
//  - DeepFMInput: the input [q[fm:] | x[fm:]] (Dq = Dx = dd); rows,
//    queries and gradients D = fm + dd wide; the FM term <x_fm, q_fm> in
//    the logit and g_logit * q_fm as the gradient's first fm columns. The
//    tile's x[:fm] and q[:fm] (T x align4(fm) floats each) lie at xf and
//    qf in shared memory, past the plan's buffers (deepfm_cluster_plan).
struct MLPInput {
  static constexpr bool kFM = false;
  static constexpr int fm = 0, xf = 0, qf = 0;
};
struct DeepFMInput {
  static constexpr bool kFM = true;
  int fm, xf, qf;
};

// The widths a launch runs at, read from its parameters ...
struct RuntimeWidths {
  const MLPNet& net;
  const MLPGradPlan& p;
  __device__ RuntimeWidths(const MLPNet& nt, const MLPGradPlan& pl)
      : net(nt), p(pl) {}
  __device__ int L() const { return net.layers; }
  __device__ int dim(int i) const { return net.dim[i]; }
  __device__ int dx() const { return net.dx; }
  __device__ int dq() const { return net.dq; }
  __device__ int n() const { return p.n; }
  __device__ int s(int i) const { return p.s[i]; }
  __device__ int ks() const { return p.ks; }
  __device__ int pw(int i) const { return mlp_grad_align4(net.dim[i + 1]); }
  __device__ int px() const { return mlp_grad_align4(net.dim[0]); }
  template <class In>
  __device__ int fm(const In& in) const {
    return in.fm;
  }
};

// ... or fixed at compile time (equal to the plan's): kD0 inputs, kDx of
// them x, kL - 1 hidden layers of kH units, kN CTAs, kFm FM columns
// (DeepFM). Every loop over layers, units and k then has a constant count
// and every index folds.
template <int kD0, int kDx, int kH, int kL, int kN, int kFm = 0>
struct FixedWidths {
  __device__ FixedWidths(const MLPNet&, const MLPGradPlan&) {}
  __host__ __device__ static constexpr int L() { return kL; }
  __host__ __device__ static constexpr int dim(int i) {
    return i == 0 ? kD0 : i == kL ? 1 : kH;
  }
  __host__ __device__ static constexpr int dx() { return kDx; }
  __host__ __device__ static constexpr int dq() { return kD0 - kDx; }
  __host__ __device__ static constexpr int n() { return kN; }
  __host__ __device__ static constexpr int s(int) {
    return mlp_grad_align4((kH + kN - 1) / kN);
  }
  __host__ __device__ static constexpr int ks() { return (kDx + kN - 1) / kN; }
  __host__ __device__ static constexpr int pw(int) {
    return mlp_grad_align4(kH);
  }
  __host__ __device__ static constexpr int px() {
    return mlp_grad_align4(kD0);
  }
  template <class In>
  __host__ __device__ static constexpr int fm(const In&) {
    return kFm;
  }
  // whether ``net`` launched with ``plan`` (and ``fm`` FM columns) runs
  // at these widths
  static bool matches(const MLPNet& net, const MLPGradPlan& plan,
                      int fm = 0) {
    if (net.layers != kL || net.dx != kDx || plan.n != kN || fm != kFm)
      return false;
    for (int i = 0; i <= kL; ++i)
      if (net.dim[i] != dim(i)) return false;
    return true;
  }
};

}  // namespace mlpg

// The serving nets: make_family_measure('mlp', ..., 40), 80 -> 64 -> 64 ->
// 1 at Dx = 40, and make_family_measure('deepfm', ..., 40), D = 40 with
// fm = 8 (configs/guitar_deepfm.py): a deep part of 64 -> 64 -> 64 -> 1 at
// dd = 32; the grad's a cluster of 8.
using MLPGradServing = mlpg::FixedWidths<80, 40, 64, 3, 8>;
using DeepFMGradServing = mlpg::FixedWidths<64, 32, 64, 3, 8, 8>;
// The score's tile: rows and at most CTAs per cluster, from the sweep of
// both at the serving MLP (tools/mlp_grad_split.py --sweep, PERF.md), at
// every width of both measures (a tile of 8 rows fits every network the
// MLP kernels admit, and every DeepFM net of up to 512 FM columns that the
// one-warp-per-row score layout took; above that, the tile's staged
// x[:fm] and q[:fm] can refuse a net with few first-layer units:
// tests/test_torch_deepfm_score.py).
constexpr int kMLPScoreTile = 8;
constexpr int kMLPScoreCluster = 4;
using MLPScoreServing = mlpg::FixedWidths<80, 40, 64, 3, kMLPScoreCluster>;
using DeepFMScoreServing =
    mlpg::FixedWidths<64, 32, 64, 3, kMLPScoreCluster, 8>;

namespace mlpg {

// One tile of T rows per cluster, as the top of this file sets out. kGrad:
// the value and df/dx (``vals``, ``grads``, ``xout``); otherwise the score
// alone (``vals``): no row slices of W, no cotangents, no backward
// exchanges, a row that ``mask`` (nullable) clears scored -inf, and a tile
// that it clears entirely skipped, staging and all.
template <class Rows, int Stop, class Widths, class In, int T, bool kGrad>
__device__ __forceinline__ void cluster_body(
    Rows rows, const float* __restrict__ query, int q_shared,
    const MLPNet& net, const MLPGradPlan& plan, float* __restrict__ vals,
    float* __restrict__ grads, float* __restrict__ xout,
    const unsigned char* __restrict__ mask, int M, In in) {
  static_assert((T & (T - 1)) == 0 && T * 8 <= kMLPGradThreads,
                "a tile is a power of two of at most 32 rows");
  extern __shared__ __align__(16) float sm[];
  const Widths wd(net, plan);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);
  const int c = static_cast<int>(cluster_rank());
  const int n = wd.n();
  constexpr int lt = ilog2(T);
  const int L = wd.L(), Dx = wd.dx(), Dq = wd.dq(), D0 = wd.dim(0);
  // the input policy's widths: FM columns (0 for an MLP), a row's (and a
  // gradient row's) width, where x and q start in the network's input,
  // and a query row's width and first column there
  const int fm = wd.fm(in), pf = mlp_grad_align4(fm);
  const int D = fm + Dx;
  const int xo = In::kFM ? Dq : 0, qo = In::kFM ? 0 : Dx;
  const int qld = In::kFM ? D : Dq;
  const int tid = threadIdx.x;
  // the tile's row pitches: the grad's as the widths give them; the
  // score's padded to an odd multiple of 4 floats (dense4's kWarpK)
  auto pitch = [](int v) { return kGrad ? v : v | 4; };
  const int row0 = (blockIdx.x / n) * T;
  const int nrows = min(T, M - row0);
  // the score's mask, read for row tid (the row whose score this thread
  // writes): a tile with no live row writes -inf and leaves before its
  // staging, in every CTA of the cluster alike (they read the same
  // bytes), so before any cluster barrier
  [[maybe_unused]] bool live_row = true;
  if constexpr (!kGrad) {
    if (mask != nullptr) {
      live_row = tid < nrows && mask[row0 + tid] != 0;
      if (!__syncthreads_or(live_row)) {
        if (c == 0 && tid < nrows) vals[row0 + tid] = -INFINITY;
        return;
      }
    }
  }
  // exchange j < L - 1 fills relu(z_j), exchange L - 1 + j fills g_j;
  // the score's exchange L - 2 brings CTA 0 the top layer's partial dots,
  // n per row, in place of relu(z_{L-2})
  if (tid == kMLPGradThreads - kWarp) {
    for (int j = 0; j + 1 < L; ++j) tc::mbar_init(bars + j, 1);
    if constexpr (kGrad)
      for (int j = 0; j + 2 < L; ++j) tc::mbar_init(bars + L - 1 + j, 1);
    tc::mbar_fence_init();
    const uint32_t tile_bytes = sizeof(float) * T;
    for (int j = 0; j + (kGrad ? 1 : 2) < L; ++j)
      tc::mbar_expect_tx(bars + j, tile_bytes * wd.dim(j + 1));
    if constexpr (kGrad) {
      for (int j = 0; j + 2 < L; ++j)
        tc::mbar_expect_tx(bars + L - 1 + j, tile_bytes * wd.dim(j + 1));
    } else {
      if (L > 1 && c == 0) tc::mbar_expect_tx(bars + L - 2, tile_bytes * n);
    }
  }
  // the exchange buffers' pads (never pushed to) are zero
#pragma unroll
  for (int i = 0; i + 1 < L; ++i) {
    const int H = wd.dim(i + 1);
    zero_cols(sm + plan.a[i], pitch(wd.pw(i)), T, H, mlp_grad_align4(H));
    if constexpr (kGrad)
      zero_cols(sm + plan.g[i], wd.pw(i), T, H, mlp_grad_align4(H));
  }
  // every CTA's mbarriers are set before any push (waited after staging)
  cluster_arrive_relaxed();
  if (Stop == 0) {
    cluster_wait();
    return;
  }

  // -- staging: the CTA's slices of the network and the tile's rows,
  //    every copy in flight at once
#pragma unroll
  for (int i = 0; i + 1 < L; ++i) {
    const int K = wd.dim(i), H = wd.dim(i + 1), si = wd.s(i);
    const Slice u = slice_of(c, si, H, n);
    stage_rows(sm + plan.wf[i], si, net.w[i] + u.lo, H, K, u.width);
    zero_cols(sm + plan.wf[i] + K * si, si, mlp_grad_align4(K) - K, 0, si);
    stage_rows(sm + plan.bf[i], 0, net.b[i] + u.lo, 0, 1, u.width);
    if constexpr (kGrad) {
      // the backward's rows: of W_i the own units of layer i - 1, of W_0
      // the own x columns (rows xo + own columns)
      const Slice v = i > 0 ? slice_of(c, wd.s(i - 1), K, n)
                            : slice_of(c, wd.ks(), Dx, n);
      const int H4 = mlp_grad_align4(H);
      stage_rows(sm + plan.wb[i], H4,
                 net.w[i] + static_cast<size_t>(v.lo + (i > 0 ? 0 : xo)) * H,
                 H, v.width, H);
      zero_cols(sm + plan.wb[i], H4, v.width, H, H4);
    }
  }
  {
    const int H = wd.dim(L - 1);
    stage_rows(sm + plan.wl, 0, net.w[L - 1], 0, 1, H);
    zero_cols(sm + plan.wl, 0, 1, H, mlp_grad_align4(H));
    if (tid == 0) cp_async4(sm + plan.bl, net.b[L - 1]);
  }
  float* X = sm + plan.x;
  float* XF = sm + in.xf;  // DeepFM: x[:fm] and q[:fm] of the tile
  float* QF = sm + in.qf;
  const int px = pitch(wd.px());
  {
    // the input of rows t < nrows; zeros past them and past D0. Column k
    // of row t goes to X at xo + k - fm, or (DeepFM, k < fm) to XF at k:
    // to_x gives the address, at_x its offset from X (the float32 copies
    // take addresses and the dequant offsets, as before the policy, so
    // that the MLP's code does not change)
    auto to_x = [&](int t, int k) {
      return In::kFM && k < fm ? XF + t * pf + k : X + t * px + xo + k - fm;
    };
    const int xf = in.xf - plan.x;
    auto at_x = [&](int t, int k) {
      return In::kFM && k < fm ? xf + t * pf + k : t * px + xo + k - fm;
    };
    const int D4 = mlp_grad_align4(D0);
    zero_cols(X, px, nrows, D0, D4);
    zero_cols(X + nrows * px, px, T - nrows, 0, D4);
    if constexpr (In::kFM) {
      zero_cols(XF + nrows * pf, pf, T - nrows, 0, pf);
      zero_cols(QF + nrows * pf, pf, T - nrows, 0, pf);
    }
    if constexpr (kF32Rows<Rows>) {
      const bool v4 = ((fm | Dx) & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(
                           rows.row(static_cast<size_t>(row0), D).p) &
                       15) == 0;
      if (v4) {
        for_each(nrows * (D >> 2), [&](int e) {
          const int t = e / (D >> 2), k = (e - t * (D >> 2)) * 4;
          cp_async16(to_x(t, k),
                     rows.row(static_cast<size_t>(row0 + t), D).p + k);
        });
      } else {
        for_each(nrows * D, [&](int e) {
          const int t = e / D, k = e - t * D;
          cp_async4(to_x(t, k),
                    rows.row(static_cast<size_t>(row0 + t), D).p + k);
        });
      }
    } else {
      // loads in flight before any store; 4 for DeepFM, whose two
      // destinations cost the registers that 8 would need (ptxas keeps
      // the kernel at 32 and spilled the id pointer at 8; at the serving
      // widths a thread stages one element either way)
      constexpr int kBatch = In::kFM ? 4 : 8;
      for (int e0 = tid; e0 < nrows * D; e0 += kBatch * kMLPGradThreads) {
        float v[kBatch];
        int at[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int e = e0 + j * kMLPGradThreads;
          const int t = e / D, k = e - t * D;
          at[j] = e < nrows * D ? at_x(t, k) : -1;
          if (at[j] >= 0)
            v[j] = rows.get(rows.row(static_cast<size_t>(row0 + t), D), k);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (at[j] >= 0) X[at[j]] = v[j];
      }
    }
    const float* qrow =
        query + (q_shared ? 0 : static_cast<size_t>(row0) * qld);
    stage_rows(X + qo, px, qrow + fm, q_shared ? 0 : qld, nrows, Dq);
    if constexpr (In::kFM)
      stage_rows(QF, pf, qrow, q_shared ? 0 : qld, nrows, fm);
  }
  cp_async_wait_all();
  __syncthreads();
  cluster_wait();
  if (kGrad && xout != nullptr && c == 0) {
    const int t = tid >> 3, l = tid & 7;
    if (t < nrows) {
#pragma unroll 4
      for (int k = l; k < D; k += 8)
        xout[static_cast<size_t>(row0 + t) * D + k] =
            In::kFM && k < fm ? XF[t * pf + k] : X[t * px + xo + k - fm];
    }
  }
  if (Stop == 1) return;

  // -- forward: each CTA's units of every hidden layer, pushed to all
  //    (the score keeps its units of the top hidden layer)
#pragma unroll
  for (int i = 0; i + 1 < L; ++i) {
    const Slice u = slice_of(c, wd.s(i), wd.dim(i + 1), n);
    if (i > 0) wait_exchange(bars + i - 1);
    const float* in = i == 0 ? X : sm + plan.a[i - 1];
    const int pin = i == 0 ? px : pitch(wd.pw(i - 1));
    const int pout = pitch(wd.pw(i));
    float* own = sm + plan.a[i] + u.lo;
    const uint32_t dst = tc::smem_u32(own);
    const uint32_t bar = tc::smem_u32(bars + i);
    const bool keep = !kGrad && i + 2 == L;
    dense4<T, false, !kGrad>(
        in, pin, mlp_grad_align4(wd.dim(i)), sm + plan.wf[i], wd.s(i),
        sm + plan.bf[i], u.width,
        [&](int t, int j0, int g, int KS, float4 z) {
          z = make_float4(fmaxf(z.x, 0.f), fmaxf(z.y, 0.f), fmaxf(z.z, 0.f),
                          fmaxf(z.w, 0.f));
          if (!keep)
            push(dst + 4u * (t * pout + j0), z, min(4, u.width - j0), bar, g,
                 KS, n);
          else if (g == 0)
            *reinterpret_cast<float4*>(own + t * pout + j0) = z;
        },
        reinterpret_cast<float4*>(sm + plan.g[0]));
  }
  // -- the value: the full top layer (the input if there is none) against
  //    the last layer's weights, 8 lanes per row (16-byte columns l,
  //    l + 8, ...), reduced by xor shuffles
  const int H = wd.dim(L - 1), HC = mlp_grad_align4(H) >> 2;
  const float* top = L > 1 ? sm + plan.a[L - 2] : X;
  const int ptop = L > 1 ? pitch(wd.pw(L - 2)) : px;
  const float* wl = sm + plan.wl;
  if constexpr (!kGrad) {
    // -- the score: each CTA's partial dot of its units of the top layer
    //    (the whole input without a hidden layer, n = 1) with the last
    //    layer's weights, one row per thread, pushed to CTA 0, which adds
    //    the n partials in rank order, then the bias, then (DeepFM) the
    //    row's FM term, and writes the sigmoid (-inf for a masked row)
    const Slice u = L > 1 ? slice_of(c, wd.s(L - 2), H, n) : Slice{0, H};
    __syncthreads();  // this CTA's units of the top layer are in
    float p = 0.f;
    [[maybe_unused]] float fmt = 0.f;
    if (tid < T) {
      for (int j = u.lo; j < u.lo + u.width; ++j)
        p = fmaf(top[tid * ptop + j], wl[j], p);
      // DeepFM: CTA 0's FM term of row tid, one fmaf chain over k = 0, 1,
      // ..., fm - 1 of x[k] q[k] (before the wait: it needs no exchange)
      if constexpr (In::kFM) {
        if (c == 0)
          for (int k = 0; k < fm; ++k)
            fmt = fmaf(XF[tid * pf + k], QF[tid * pf + k], fmt);
      }
    }
    if (L > 1) {
      if (tid < T)
        st_async1(map_rank(tc::smem_u32(sm + plan.gl + c * T + tid), 0), p,
                  map_rank(tc::smem_u32(bars + L - 2), 0));
      // every push to this CTA has landed (to CTA 0, once the partials
      // have): it may leave once all have
      if (c != 0) {
        cluster_arrive_relaxed();
        cluster_wait();
        return;
      }
      wait_exchange(bars + L - 2);
      cluster_arrive_relaxed();
      if (tid < T) {
        p = 0.f;
        for (int r = 0; r < n; ++r) p += sm[plan.gl + r * T + tid];
      }
    }
    if (tid < nrows) {
      float logit = p + sm[plan.bl];
      if constexpr (In::kFM) logit += fmt;
      vals[row0 + tid] = live_row ? 1.f / (1.f + expf(-logit)) : -INFINITY;
    }
    if (L > 1) cluster_wait();
    return;
  }
  float* GL = sm + plan.gl;
  // DeepFM: the FM term of row t = tid / 8, lane l = tid % 8 taking
  // columns l, l + 8, ..., reduced by xor shuffles (before the wait: it
  // needs no exchange)
  float fmt = 0.f;
  if constexpr (In::kFM) {
    const int t = tid >> 3, l = tid & 7;
    if (t < T) {
      for (int k = l; k < fm; k += 8)
        fmt = fmaf(XF[t * pf + k], QF[t * pf + k], fmt);
    }
    fmt += __shfl_xor_sync(kFull, fmt, 4);
    fmt += __shfl_xor_sync(kFull, fmt, 2);
    fmt += __shfl_xor_sync(kFull, fmt, 1);
  }
  if (L > 1) wait_exchange(bars + L - 2);
  {
    const int t = tid >> 3, l = tid & 7;
    const bool live = t < T;
    float p = 0.f;
    if (live) {
#pragma unroll
      for (int m = 0; m < (HC + 7) / 8; ++m) {
        const int cc = l + 8 * m;
        if (cc >= HC) break;
        const float4 a = ld4(top + t * ptop + 4 * cc), w = ld4(wl + 4 * cc);
        p = fmaf(a.w, w.w, fmaf(a.z, w.z, fmaf(a.y, w.y, fmaf(a.x, w.x, p))));
      }
    }
    p += __shfl_xor_sync(kFull, p, 4);
    p += __shfl_xor_sync(kFull, p, 2);
    p += __shfl_xor_sync(kFull, p, 1);
    if (live && l == 0) {
      const float logit =
          In::kFM ? (p + sm[plan.bl]) + fmt : p + sm[plan.bl];
      const float val = 1.f / (1.f + expf(-logit));
      GL[t] = val * (1.f - val);
      if (c == 0 && t < nrows) vals[row0 + t] = val;
    }
  }
  __syncthreads();
  if (Stop == 2) return;
  if constexpr (In::kFM) {  // CTA 0: the FM columns, g_logit * q_fm
    const int t = tid >> 3, l = tid & 7;
    if (c == 0 && t < nrows)
      for (int k = l; k < fm; k += 8)
        grads[static_cast<size_t>(row0 + t) * D + k] = GL[t] * QF[t * pf + k];
  }
  if (L == 1) {  // no hidden layer (n = 1): gx = f' w[x columns]
    const int t = tid >> 3, l = tid & 7;
    if (t < nrows)
      for (int k = l; k < Dx; k += 8)
        grads[static_cast<size_t>(row0 + t) * D + fm + k] =
            GL[t] * wl[xo + k];
    return;
  }

  // -- backward: the top layer's cotangent (full, local), then each CTA's
  //    units of g_{i-1} = mask * (g_i W_i^T), pushed to all
  {
    float* G = sm + plan.g[L - 2];
    for_each(HC << lt, [&](int e) {
      const int t = e & (T - 1), j = (e >> lt) * 4;
      const float4 a = ld4(top + t * ptop + j), w = ld4(wl + j);
      const float f = GL[t];
      *reinterpret_cast<float4*>(G + t * ptop + j) = make_float4(
          a.x > 0.f ? f * w.x : 0.f, a.y > 0.f ? f * w.y : 0.f,
          a.z > 0.f ? f * w.z : 0.f, a.w > 0.f ? f * w.w : 0.f);
    });
  }
  __syncthreads();
#pragma unroll
  for (int i = L - 2; i >= 1; --i) {
    if (i < L - 2) wait_exchange(bars + L - 1 + i);
    const Slice v = slice_of(c, wd.s(i - 1), wd.dim(i), n);
    const int pout = wd.pw(i - 1);
    const float* A = sm + plan.a[i - 1] + v.lo;
    const uint32_t dst = tc::smem_u32(sm + plan.g[i - 1] + v.lo);
    const uint32_t bar = tc::smem_u32(bars + L - 1 + i - 1);
    const int H4 = mlp_grad_align4(wd.dim(i + 1));
    dense4<T, true, false>(
        sm + plan.g[i], wd.pw(i), H4, sm + plan.wb[i], H4, nullptr, v.width,
        [&](int t, int j0, int g, int KS, float4 s) {
          const float4 a = ld4(A + t * pout + j0);
          const float4 z =
              make_float4(a.x > 0.f ? s.x : 0.f, a.y > 0.f ? s.y : 0.f,
                          a.z > 0.f ? s.z : 0.f, a.w > 0.f ? s.w : 0.f);
          push(dst + 4u * (t * pout + j0), z, min(4, v.width - j0), bar, g,
               KS, n);
        },
        nullptr);
  }
  if (L > 2) wait_exchange(bars + L - 1);
  // every push to this CTA has landed: it may leave once all have
  cluster_arrive_relaxed();
  // -- gx[:, own columns] from the full g_0 and W_0's own rows
  const Slice k = slice_of(c, wd.ks(), Dx, n);
  const int H4 = mlp_grad_align4(wd.dim(1));
  dense4<T, true, false>(
      sm + plan.g[0], wd.pw(0), H4, sm + plan.wb[0], H4, nullptr, k.width,
      [&](int t, int j0, int g, int, float4 s) {
        if (g != 0 || t >= nrows) return;
        float* out =
            grads + static_cast<size_t>(row0 + t) * D + fm + k.lo + j0;
        const int valid = min(4, k.width - j0);
        out[0] = s.x;
        if (valid > 1) out[1] = s.y;
        if (valid > 2) out[2] = s.z;
        if (valid > 3) out[3] = s.w;
      },
      nullptr);
  cluster_wait();
}

// The launch of ``clusters`` clusters of plan.n CTAs (used in place: cfg
// points at attr).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int clusters, const MLPGradPlan& plan, void* stream) {
    cfg.gridDim = dim3(clusters * plan.n);
    cfg.blockDim = dim3(kMLPGradThreads);
    cfg.dynamicSmemBytes = sizeof(float) * static_cast<size_t>(plan.floats);
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = plan.n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

}  // namespace mlpg

// Value and df/dx of each row; ``xout`` (nullable) receives the float32
// row the kernel scored (the dequantized frontier rows of the fused form).
template <class Rows, int Stop, class Widths, class In>
__global__ void __launch_bounds__(kMLPGradThreads)
mlp_grad_cluster_kernel(Rows rows, const float* __restrict__ query,
                        int q_shared, MLPNet net, MLPGradPlan plan,
                        float* __restrict__ vals, float* __restrict__ grads,
                        float* __restrict__ xout, int M, In in) {
  mlpg::cluster_body<Rows, Stop, Widths, In, kMLPGradTile, true>(
      rows, query, q_shared, net, plan, vals, grads, xout, nullptr, M, in);
}

// The score of each row (-inf where ``mask``, nullable, clears it): the
// same body, forward only, T rows per cluster.
template <class Rows, int Stop, class Widths, int T, class In>
__global__ void __launch_bounds__(kMLPGradThreads)
mlp_score_cluster_kernel(Rows rows, const float* __restrict__ query,
                         int q_shared, const unsigned char* __restrict__ mask,
                         MLPNet net, MLPGradPlan plan,
                         float* __restrict__ out, int M, In in) {
  mlpg::cluster_body<Rows, Stop, Widths, In, T, false>(
      rows, query, q_shared, net, plan, out, nullptr, nullptr, mask, M, in);
}

template <class Rows, int Stop, class Widths, class In>
inline cudaError_t launch_mlp_grad_cluster_as(Rows rows, const void* query,
                                              int q_shared, const MLPNet& net,
                                              const MLPGradPlan& plan,
                                              void* vals, void* grads,
                                              void* xout, int M, In in,
                                              void* stream) {
  auto kernel = mlp_grad_cluster_kernel<Rows, Stop, Widths, In>;
  const mlpg::ClusterLaunch launch((M + kMLPGradTile - 1) / kMLPGradTile,
                                   plan, stream);
  allow_smem(kernel, launch.cfg.dynamicSmemBytes);
  const cudaError_t err = cudaLaunchKernelEx(
      &launch.cfg, kernel, rows, static_cast<const float*>(query), q_shared,
      net, plan, static_cast<float*>(vals), static_cast<float*>(grads),
      static_cast<float*>(xout), M, in);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// One launch over M rows: ceil(M / 4) clusters of n CTAs, at the serving
// widths by the kernel fixed to them. A refused launch (shared memory,
// cluster resources) is returned, never rerouted.
template <class Rows, int Stop = kMLPGradAll>
inline cudaError_t launch_mlp_grad_cluster(Rows rows, const void* query,
                                           int q_shared, const MLPNet& net,
                                           void* vals, void* grads,
                                           void* xout, int M, void* stream) {
  if (M <= 0) return cudaGetLastError();
  MLPGradPlan plan;
  if (!mlp_grad_plan(plan, net)) return cudaErrorInvalidValue;
  const mlpg::MLPInput in;
  if (MLPGradServing::matches(net, plan))
    return launch_mlp_grad_cluster_as<Rows, Stop, MLPGradServing>(
        rows, query, q_shared, net, plan, vals, grads, xout, M, in, stream);
  return launch_mlp_grad_cluster_as<Rows, Stop, mlpg::RuntimeWidths>(
      rows, query, q_shared, net, plan, vals, grads, xout, M, in, stream);
}

// The DeepFM measure's net (rows and queries D wide, fm FM columns, the
// deep part 2 (D - fm) -> H0 -> H1 -> 1 at Dx = Dq = D - fm) planned at a
// tile of T rows on at most n_max CTAs, with the backward's buffers
// (``grad``) or without, and the tile's x[:fm] and q[:fm] past the plan's
// buffers (``in``); false if refused. Mirrored by deepfm_grad_plan and
// deepfm_score_plan (kernels/deepfm_grad/ops.py, deepfm_score/ops.py).
inline bool deepfm_cluster_plan(MLPNet& net, MLPGradPlan& plan,
                                mlpg::DeepFMInput& in, const DeepFMWeights& w,
                                int D, int fm, int H0, int H1, int T,
                                int n_max, bool grad) {
  const int dd = D - fm;
  const void* ws[3] = {w.w0, w.w1, w.w2};
  const void* bs[3] = {w.b0, w.b1, w.b2};
  const int dims[4] = {2 * dd, H0, H1, 1};
  if (fm <= 0 || dd <= 0 || !mlp_net(net, ws, bs, dims, 3, dd, dd) ||
      !mlp_cluster_plan(plan, net, T, n_max, grad))
    return false;
  const int f4 = T * mlp_grad_align4(fm);
  in = mlpg::DeepFMInput{fm, plan.floats, plan.floats + f4};
  plan.floats += 2 * f4;
  return sizeof(float) * plan.floats <= kMLPGradSmemCap;
}

// The grad for the DeepFM measure: the cluster body over DeepFMInput, at
// the serving widths by the kernel fixed to them.
template <class Rows, int Stop = kMLPGradAll>
inline cudaError_t launch_deepfm_grad_cluster(Rows rows, const void* query,
                                              int q_shared,
                                              const DeepFMWeights& w,
                                              void* vals, void* grads,
                                              void* xout, int M, int D,
                                              int fm, int H0, int H1,
                                              void* stream) {
  if (M <= 0) return cudaGetLastError();
  MLPNet net;
  MLPGradPlan plan;
  mlpg::DeepFMInput in;
  if (!deepfm_cluster_plan(net, plan, in, w, D, fm, H0, H1, kMLPGradTile,
                           kMLPGradMaxCluster, true))
    return cudaErrorInvalidValue;
  if (DeepFMGradServing::matches(net, plan, fm))
    return launch_mlp_grad_cluster_as<Rows, Stop, DeepFMGradServing>(
        rows, query, q_shared, net, plan, vals, grads, xout, M, in, stream);
  return launch_mlp_grad_cluster_as<Rows, Stop, mlpg::RuntimeWidths>(
      rows, query, q_shared, net, plan, vals, grads, xout, M, in, stream);
}

// The score's launch at a plan, T rows per cluster.
template <class Rows, int Stop, class Widths, int T,
          class In = mlpg::MLPInput>
inline cudaError_t launch_mlp_score_cluster_as(Rows rows, const void* query,
                                               int q_shared, const void* mask,
                                               const MLPNet& net,
                                               const MLPGradPlan& plan,
                                               void* out, int M,
                                               void* stream, In in = In{}) {
  auto kernel = mlp_score_cluster_kernel<Rows, Stop, Widths, T, In>;
  const mlpg::ClusterLaunch launch((M + T - 1) / T, plan, stream);
  allow_smem(kernel, launch.cfg.dynamicSmemBytes);
  const cudaError_t err = cudaLaunchKernelEx(
      &launch.cfg, kernel, rows, static_cast<const float*>(query), q_shared,
      static_cast<const unsigned char*>(mask), net, plan,
      static_cast<float*>(out), M, in);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// cudaOccupancyMaxActiveClusters of the score's kernel at ``plan``.
template <class Rows, class Widths, int T, class In = mlpg::MLPInput>
inline cudaError_t mlp_score_max_clusters(const MLPGradPlan& plan,
                                          int* clusters) {
  auto kernel = mlp_score_cluster_kernel<Rows, kMLPGradAll, Widths, T, In>;
  const mlpg::ClusterLaunch launch(1, plan, nullptr);
  allow_smem(kernel, launch.cfg.dynamicSmemBytes);
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(clusters, kernel, &launch.cfg);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// A copy of the score's kernel: its widths and its tile.
template <class W, int T>
struct ScoreCopy {
  using Widths = W;
  static constexpr int kTile = T;
};

// fn(plan, ScoreCopy<...>{}) with the copy that scores ``net`` and its
// plan: the serving widths compiled in, or the run-time-width copy.
template <class Fn>
inline cudaError_t with_score_copy(const MLPNet& net, Fn fn) {
  MLPGradPlan plan;
  if (!mlp_score_plan(plan, net, kMLPScoreTile, kMLPScoreCluster))
    return cudaErrorInvalidValue;
  if (MLPScoreServing::matches(net, plan))
    return fn(plan, ScoreCopy<MLPScoreServing, kMLPScoreTile>{});
  return fn(plan, ScoreCopy<mlpg::RuntimeWidths, kMLPScoreTile>{});
}

// The same for a DeepFM net: fn(net, plan, in, ScoreCopy<...>{}) at
// deepfm_cluster_plan's score plan.
template <class Fn>
inline cudaError_t with_deepfm_score_copy(const DeepFMWeights& w, int D,
                                          int fm, int H0, int H1, Fn fn) {
  MLPNet net;
  MLPGradPlan plan;
  mlpg::DeepFMInput in;
  if (!deepfm_cluster_plan(net, plan, in, w, D, fm, H0, H1, kMLPScoreTile,
                           kMLPScoreCluster, false))
    return cudaErrorInvalidValue;
  if (DeepFMScoreServing::matches(net, plan, fm))
    return fn(net, plan, in, ScoreCopy<DeepFMScoreServing, kMLPScoreTile>{});
  return fn(net, plan, in, ScoreCopy<mlpg::RuntimeWidths, kMLPScoreTile>{});
}

// The score of M rows (-inf where ``mask``, nullable, clears a row): one
// launch of ceil(M / T) clusters. A refused launch is returned, never
// rerouted.
template <class Rows, int Stop = kMLPGradAll>
inline cudaError_t launch_mlp_score_cluster(Rows rows, const void* query,
                                            int q_shared, const void* mask,
                                            const MLPNet& net, void* out,
                                            int M, void* stream) {
  if (M <= 0) return cudaGetLastError();
  return with_score_copy(net, [&](const MLPGradPlan& plan, auto copy) {
    using C = decltype(copy);
    return launch_mlp_score_cluster_as<Rows, Stop, typename C::Widths,
                                       C::kTile>(
        rows, query, q_shared, mask, net, plan, out, M, stream);
  });
}

// The same for the DeepFM measure: the score body over DeepFMInput.
template <class Rows, int Stop = kMLPGradAll>
inline cudaError_t launch_deepfm_score_cluster(Rows rows, const void* query,
                                               int q_shared, const void* mask,
                                               const DeepFMWeights& w,
                                               void* out, int M, int D,
                                               int fm, int H0, int H1,
                                               void* stream) {
  if (M <= 0) return cudaGetLastError();
  return with_deepfm_score_copy(
      w, D, fm, H0, H1,
      [&](const MLPNet& net, const MLPGradPlan& plan,
          const mlpg::DeepFMInput& in, auto copy) {
        using C = decltype(copy);
        return launch_mlp_score_cluster_as<Rows, Stop, typename C::Widths,
                                           C::kTile>(
            rows, query, q_shared, mask, net, plan, out, M, stream, in);
      });
}

}  // namespace repro
