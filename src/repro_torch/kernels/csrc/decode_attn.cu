// Flash-decode GQA attention: one query position per (batch, head)
// against a length-masked KV cache, online softmax in float32. Two chunk
// kernels share one split and one merge: a tensor-core kernel for a bf16
// cache at hd >= 16 (decode_tc_kernel), and a CUDA-core kernel for a
// float32 cache (TF32 stays off) and for bf16 at hd = 8, under mma's k16
// depth (decode_chunk_kernel).
//
// Replaces: src/repro/kernels/decode_attn/kernel.py, decode_attention_pallas
// (the Pallas kernel that walks the cache in T-chunks along a sequential
// grid axis, the G = H / KV query heads of a kv head together as the MXU's
// M dimension, with the running max m, normalizer l and accumulator in
// VMEM scratch across the chunks).
//
// What bounds it on an H100: bytes. Every valid cache position is read
// once (K and V: 2 * KV * hd elements), for 4 * G * hd FLOPs per position
// and kv head; at Yi-9B's G = 8, hd = 128 in bf16 that is ~8 FLOP per
// byte, under the float32 FMA rate's ~20 and far under the tensor cores'.
//
// Split: the TPU walks T in order on one core; here one block per
// (T-chunk, kv head, batch) row runs in parallel and a second small kernel
// merges the chunks (flash-decode), so even long_500k (B = 1, KV = 4) puts
// ~500 blocks on the 132 SMs instead of 4. Guards as in the Pallas kernel:
// a masked logit contributes 0, a chunk with no valid position writes
// m = -inf and l = 0, and the merge divides by max(l, 1e-30), so length
// = 0 gives zeros. ``length`` is read from device memory, as the Pallas
// kernel reads it from SMEM, so a decode loop never syncs the host;
// positions at or beyond it are neither read nor counted, so the cache
// needs no padding.
//
// decode_tc_kernel (bf16 cache): the CUDA-core kernel ran bf16 at 2.1x the
// byte bound, held back by shared-memory loads feeding scalar FMAs and by
// few bytes in flight. Here a block of four warps streams its chunk in
// tiles of 64 positions (K and V, 16-byte cp.async, zero fill past the
// length) through a three-stage ring, so up to two tiles (32 KB at hd =
// 128) are in flight per block while one is consumed. Each warp takes 16
// positions of a tile and keeps its own running (m, l, O) over the chunk
// (merged across the four warps once, at the end): logits S (16 x 16) =
// q K^T by mma.sync m16n8k16 with the G heads as the M rows (padded to
// 16; q is the A operand, held in registers for the whole chunk; a float32
// q is split hi + lo and multiplied twice), K through ldmatrix; the S
// accumulator becomes P's A fragment in registers, split hi + lo, and
// O (16 x hd) += P V with V through ldmatrix.trans. Rows are padded by 16
// bytes in shared memory, so the ldmatrix reads are free of bank
// conflicts. Unlike the Pallas kernel, which rounds P to v's dtype, P
// keeps ~2^-17 through the split.
//
// decode_chunk_kernel (float32 cache, bf16 at hd = 8): a block takes its
// chunk 128 positions at a time: (1) each thread scores one position
// against the G query heads (its K row in 16-byte loads, q transposed in
// shared memory and read four heads per load), (2) a warp per head folds
// the tile into the running (m, l) and rescales, (3) each thread owns one
// channel of the accumulator for its heads and streams V rows, coalesced
// along hd, reading P four heads per shared-memory load. P stays in
// float32.
#include "elem.cuh"
#include "tc.cuh"

namespace repro {
namespace {

constexpr int kDecThreads = 128;
constexpr int kDecTile = 128;  // positions per tile: one per thread
constexpr int kMaxG = 16;      // query heads per kv head

template <typename T, int HD>
__global__ void __launch_bounds__(kDecThreads)
    decode_chunk_kernel(const void* __restrict__ q, int q_f32,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const int* __restrict__ len_ptr, int len_val, int T_,
                        int KV, int G, int chunk, float scale,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml) {
  constexpr int kVec = 16 / sizeof(T) < HD ? 16 / sizeof(T) : HD;
  constexpr int kHeadStep = kDecThreads / HD;  // heads sharing a channel
  constexpr int kMyHeads = (kMaxG + kHeadStep - 1) / kHeadStep;
  __shared__ __align__(16) float qs[HD][kMaxG];    // q transposed: [d][g]
  __shared__ __align__(16) float ps[kDecTile][kMaxG + 4];  // logits, p
  __shared__ float ms[kMaxG], ls[kMaxG], cs[kMaxG];

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int tid = threadIdx.x;
  const int H = KV * G;
  int n = len_ptr ? *len_ptr : len_val;
  n = n < 0 ? 0 : (n > T_ ? T_ : n);
  const int start = c * chunk;
  const int end = start + chunk < n ? start + chunk : n;

  for (int e = tid; e < HD * kMaxG; e += kDecThreads) {
    const int d = e / kMaxG, g = e % kMaxG;
    float x = 0.0f;
    if (g < G) {
      const size_t off = (static_cast<size_t>(b) * H + kvh * G + g) * HD + d;
      x = q_f32 ? static_cast<const float*>(q)[off]
                : Elem<T>::to_f32(static_cast<const T*>(q)[off]);
    }
    qs[d][g] = x;
  }
  if (tid < kMaxG) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.0f;
  }
  const int d_own = tid % HD, g_own = tid / HD;
  float acc[kMyHeads];
#pragma unroll
  for (int i = 0; i < kMyHeads; ++i) acc[i] = 0.0f;
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(KV) * HD;
  const T* kb = k + (static_cast<size_t>(b) * T_ * KV + kvh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * T_ * KV + kvh) * HD;
  const int warp = tid / kWarp, lane = tid % kWarp;

  for (int t0 = start; t0 < end; t0 += kDecTile) {
    // (1) one position per thread: logits against the G heads
    const int t = t0 + tid;
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.0f;
    if (t < end) {
      const T* kr = kb + static_cast<size_t>(t) * row_stride;
#pragma unroll 4
      for (int d0 = 0; d0 < HD; d0 += kVec) {
        float kv[kVec];
        load_f32<T, kVec>(kr + d0, kv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float4* q4 = reinterpret_cast<const float4*>(qs[d0 + e]);
#pragma unroll
          for (int g4 = 0; g4 < kMaxG / 4; ++g4) {
            if (g4 * 4 < G) {
              const float4 qv = q4[g4];
              s[4 * g4 + 0] = fmaf(qv.x, kv[e], s[4 * g4 + 0]);
              s[4 * g4 + 1] = fmaf(qv.y, kv[e], s[4 * g4 + 1]);
              s[4 * g4 + 2] = fmaf(qv.z, kv[e], s[4 * g4 + 2]);
              s[4 * g4 + 3] = fmaf(qv.w, kv[e], s[4 * g4 + 3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) ps[tid][g] = t < end ? s[g] * scale : -INFINITY;
    __syncthreads();

    // (2) a warp per head: fold the tile into the running (m, l)
    for (int g = warp; g < G; g += kDecThreads / kWarp) {
      float x[kDecTile / kWarp];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kDecTile / kWarp; ++i) {
        x[i] = ps[lane + i * kWarp][g];
        mx = fmaxf(mx, x[i]);
      }
      mx = warp_max(mx);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = m_prev == -INFINITY ? 0.0f : expf(m_prev - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kDecTile / kWarp; ++i) {
        const float p = x[i] == -INFINITY ? 0.0f : expf(x[i] - m_new);
        ps[lane + i * kWarp][g] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
        cs[g] = corr;
      }
    }
    __syncthreads();

    // (3) each thread: its channel of its heads, over the tile's V rows
    const int nt = end - t0 < kDecTile ? end - t0 : kDecTile;
#pragma unroll
    for (int i = 0; i < kMyHeads; ++i) {
      const int g = g_own + i * kHeadStep;
      if (g < G) acc[i] *= cs[g];
    }
    const T* vr = vb + static_cast<size_t>(t0) * row_stride + d_own;
#pragma unroll 8
    for (int tt = 0; tt < nt; ++tt) {
      const float vv = Elem<T>::to_f32(__ldg(vr + tt * row_stride));
      if constexpr (kHeadStep == 1) {   // heads 0..G-1: four per load
        const float4* p4 = reinterpret_cast<const float4*>(ps[tt]);
#pragma unroll
        for (int g4 = 0; g4 < kMaxG / 4; ++g4) {
          if (g4 * 4 < G) {
            const float4 p = p4[g4];
            acc[4 * g4 + 0] = fmaf(p.x, vv, acc[4 * g4 + 0]);
            acc[4 * g4 + 1] = fmaf(p.y, vv, acc[4 * g4 + 1]);
            acc[4 * g4 + 2] = fmaf(p.z, vv, acc[4 * g4 + 2]);
            acc[4 * g4 + 3] = fmaf(p.w, vv, acc[4 * g4 + 3]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kMyHeads; ++i) {
          const int g = g_own + i * kHeadStep;
          if (g < G) acc[i] = fmaf(ps[tt][g], vv, acc[i]);
        }
      }
    }
    __syncthreads();
  }

  // this chunk's (acc, m, l) per head; m = -inf, l = 0 if it held no
  // valid position
  const size_t part = (static_cast<size_t>(b) * KV + kvh) * n_chunks + c;
#pragma unroll
  for (int i = 0; i < kMyHeads; ++i) {
    const int g = g_own + i * kHeadStep;
    if (g < G) part_acc[(part * G + g) * HD + d_own] = acc[i];
  }
  if (tid < G) {
    part_ml[(part * G + tid) * 2 + 0] = ms[tid];
    part_ml[(part * G + tid) * 2 + 1] = ls[tid];
  }
}

// --- the tensor-core chunk kernel (bf16 cache, hd >= 16) -------------------

constexpr int kTcThreads = 128;   // four warps
constexpr int kTcTile = 64;       // positions per tile: 16 per warp
constexpr int kTcStages = 3;

template <int HD>
constexpr size_t tc_smem_bytes() {
  constexpr size_t ring =
      static_cast<size_t>(kTcStages) * 2 * kTcTile * (HD + 8) * 2;
  constexpr size_t merge = sizeof(float) * (4 * 16 * HD + 2 * 4 * 16);
  return ring > merge ? ring : merge;
}

template <int HD, bool QF32>
__global__ void __launch_bounds__(kTcThreads)
    decode_tc_kernel(const void* __restrict__ q,
                     const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v,
                     const int* __restrict__ len_ptr, int len_val, int T_,
                     int KV, int G, int chunk, float scale,
                     float* __restrict__ part_acc,
                     float* __restrict__ part_ml) {
  using namespace tc;
  constexpr int P = HD + 8;      // row pitch in elements (16-byte pad)
  constexpr int KS = HD / 16;    // k16 steps of q K^T
  constexpr int NT = HD / 8;     // n8 tiles of O
  constexpr int CPR = HD / 8;    // 16-byte pieces per row
  extern __shared__ __align__(16) unsigned char dsmem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(dsmem);  // [st][K|V][pos][P]

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane / 4, t = lane % 4;
  const int H = KV * G;
  int n = len_ptr ? *len_ptr : len_val;
  n = n < 0 ? 0 : (n > T_ ? T_ : n);
  const int start = c * chunk;
  const int end = start + chunk < n ? start + chunk : n;
  const int n_tiles = end > start ? (end - start + kTcTile - 1) / kTcTile : 0;

  const size_t row_stride = static_cast<size_t>(KV) * HD;
  const uint16_t* kb = k + (static_cast<size_t>(b) * T_ * KV + kvh) * HD;
  const uint16_t* vb = v + (static_cast<size_t>(b) * T_ * KV + kvh) * HD;
  auto load_tile = [&](int tile, int stage) {
    const int t0 = start + tile * kTcTile;
    uint16_t* ks = ring + static_cast<size_t>(stage) * 2 * kTcTile * P;
    uint16_t* vs = ks + kTcTile * P;
    for (int e = tid; e < kTcTile * CPR; e += kTcThreads) {
      const int r = e / CPR, cc = e % CPR, pos = t0 + r;
      const bool ok = pos < end;
      const size_t off = static_cast<size_t>(ok ? pos : start) * row_stride +
                         cc * 8;
      cp_async_16(smem_u32(ks + r * P + cc * 8), kb + off, ok);
      cp_async_16(smem_u32(vs + r * P + cc * 8), vb + off, ok);
    }
  };

  // q as the A operand of every k16 step, heads g and g + 8 (0 past G)
  uint32_t qa[KS][4], ql[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i & 1), col = kk * 16 + 2 * t + 8 * (i >> 1);
      const size_t off = (static_cast<size_t>(b) * H + kvh * G + row) * HD +
                         col;
      if (QF32) {
        float2 x = make_float2(0.0f, 0.0f);
        if (row < G) x = *reinterpret_cast<const float2*>(
                         static_cast<const float*>(q) + off);
        split_bf16x2(x.x, x.y, qa[kk][i], ql[kk][i]);
      } else {
        qa[kk][i] = row < G ? *reinterpret_cast<const uint32_t*>(
                                  static_cast<const uint16_t*>(q) + off)
                            : 0u;
        ql[kk][i] = 0u;
      }
    }
  }

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();               // tile it landed; tile it - 1 is free
    const int nx = it + kTcStages - 1;
    if (nx < n_tiles) load_tile(nx, nx % kTcStages);
    cp_async_commit();

    const uint16_t* kw = ring +
        static_cast<size_t>(it % kTcStages) * 2 * kTcTile * P + warp * 16 * P;
    const uint16_t* vw = kw + kTcTile * P;

    // S = q K^T over this warp's 16 positions (two n8 tiles)
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(smem_u32(kw + ((lane % 8) + (lane / 16) * 8) * P + kk * 16 +
                       ((lane / 8) % 2) * 8),
              b0, b1, b2, b3);
      mma_16816(s[0], qa[kk], b0, b1);
      mma_16816(s[1], qa[kk], b2, b3);
      if (QF32) {
        mma_16816(s[0], ql[kk], b0, b1);
        mma_16816(s[1], ql[kk], b2, b3);
      }
    }

    // online softmax per head row (g: e = 0, 1; g + 8: e = 2, 3)
    const int p0 = start + it * kTcTile + warp * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = p0 + 8 * j + 2 * t + (e & 1) < end ? s[j][e] * scale
                                                     : -INFINITY;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                       fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float base = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = expf(m[r] - base);       // 0 while m = -inf
      m[r] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = expf(s[j][e] - base);         // a masked logit gives 0
          sum += s[j][e];
        }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }

    // O += P V: P (16 heads x 16 positions) as one A fragment, hi and lo
    uint32_t ph[4], pl[4];
    split_bf16x2(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16x2(s[0][2], s[0][3], ph[1], pl[1]);
    split_bf16x2(s[1][0], s[1][1], ph[2], pl[2]);
    split_bf16x2(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(smem_u32(vw + ((lane % 8) + ((lane / 8) % 2) * 8) * P +
                             jj * 16 + (lane / 16) * 8),
                    b0, b1, b2, b3);
      mma_16816(o[2 * jj], ph, b0, b1);
      mma_16816(o[2 * jj], pl, b0, b1);
      mma_16816(o[2 * jj + 1], ph, b2, b3);
      mma_16816(o[2 * jj + 1], pl, b2, b3);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring becomes the merge buffer

  // merge the four warps' (m, l, O) of this chunk
  float* mo = reinterpret_cast<float*>(dsmem);     // [warp * 16 + row][HD]
  float* mm = mo + 4 * 16 * HD;                     // [warp * 16 + row]
  float* ml = mm + 4 * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(mo + row * HD + 8 * j + 2 * t) =
          make_float2(o[j][2 * r], o[j][2 * r + 1]);
    if (t == 0) {
      mm[row] = m[r];
      ml[row] = l[r];
    }
  }
  __syncthreads();
  const size_t part = (static_cast<size_t>(b) * KV + kvh) * gridDim.x + c;
  for (int e = tid; e < G * HD; e += kTcThreads) {
    const int row = e / HD, d = e % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, mm[w * 16 + row]);
    float lsum = 0.0f, acc = 0.0f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float mw = mm[w * 16 + row];
        const float f = mw == -INFINITY ? 0.0f : expf(mw - mx);
        lsum = fmaf(ml[w * 16 + row], f, lsum);
        acc = fmaf(mo[(w * 16 + row) * HD + d], f, acc);
      }
    }
    part_acc[(part * G + row) * HD + d] = acc;
    if (d == 0) {
      part_ml[(part * G + row) * 2 + 0] = mx;
      part_ml[(part * G + row) * 2 + 1] = lsum;
    }
  }
}

// One block per (batch, head), one thread per channel: rescale each
// chunk's partial sums to the common max and divide once. The chunk loops
// are unrolled so that their loads are in flight together: with hundreds
// of chunks (long_500k) a loop of dependent loads dominated the call.
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    float* __restrict__ out, int n_chunks,
                                    int KV, int G, int hd) {
  const int bh = blockIdx.x;             // b * H + kvh * G + g
  const int H = KV * G;
  const int b = bh / H, h = bh % H, kvh = h / G, g = h % G;
  const int d = threadIdx.x;
  const size_t base = (static_cast<size_t>(b) * KV + kvh) * n_chunks;
  float m = -INFINITY;
#pragma unroll 8
  for (int c = 0; c < n_chunks; ++c)
    m = fmaxf(m, part_ml[((base + c) * G + g) * 2]);
  float l = 0.0f, acc = 0.0f;
#pragma unroll 8
  for (int c = 0; c < n_chunks; ++c) {
    const size_t p = (base + c) * G + g;
    const float mc = part_ml[p * 2];
    // an empty chunk (m = -inf) wrote l = 0 and acc = 0, and adds nothing
    const float f = mc == -INFINITY ? 0.0f : expf(mc - m);
    l = fmaf(part_ml[p * 2 + 1], f, l);
    acc = fmaf(part_acc[p * hd + d], f, acc);
  }
  out[static_cast<size_t>(bh) * hd + d] = acc / fmaxf(l, 1e-30f);
}

// The arguments of one decode call, as the C entry points take them.
struct Args {
  const void* q;
  int q_f32;
  const void* k;
  const void* v;
  const int* len_ptr;
  int len_val, B, T, KV, G, chunk, n_chunks;
  float* part_acc;
  float* part_ml;
  float* out;
};

// After a chunk kernel's launch: the merge over its n_chunks partials.
cudaError_t merge(const Args& a, int hd, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<<<a.B * a.KV * a.G, hd, 0, stream>>>(
      a.part_acc, a.part_ml, a.out, a.n_chunks, a.KV, a.G, hd);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_cuda_core(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.n_chunks, a.KV, a.B);
  decode_chunk_kernel<T, HD><<<grid, kDecThreads, 0, stream>>>(
      a.q, a.q_f32, static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.len_ptr, a.len_val, a.T, a.KV, a.G, a.chunk,
      1.0f / sqrtf(static_cast<float>(HD)), a.part_acc, a.part_ml);
  return merge(a, HD, stream);
}

template <int HD>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HD>();
  auto kernel = a.q_f32 ? decode_tc_kernel<HD, true>
                        : decode_tc_kernel<HD, false>;
  allow_smem(kernel, smem);
  const dim3 grid(a.n_chunks, a.KV, a.B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      a.q, static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), a.len_ptr, a.len_val, a.T, a.KV,
      a.G, a.chunk, 1.0f / sqrtf(static_cast<float>(HD)), a.part_acc,
      a.part_ml);
  return merge(a, HD, stream);
}

template <int HD>
int tc_resident(int q_f32) {
  constexpr size_t smem = tc_smem_bytes<HD>();
  auto kernel = q_f32 ? decode_tc_kernel<HD, true>
                      : decode_tc_kernel<HD, false>;
  allow_smem(kernel, smem);
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kTcThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace
}  // namespace repro

// q (B, H, hd) float32 (q_f32) or in the cache's dtype; k, v (B, T, KV, hd)
// in the cache's dtype; the valid prefix is *len_ptr if len_ptr is not
// NULL, else len_val (clamped to [0, T]). The chunk kernel runs n_chunks
// blocks of ``chunk`` positions (a multiple of 128) per (batch, kv head)
// into part_acc (B, KV, n_chunks, G, hd) and part_ml (B, KV, n_chunks, G,
// 2); the merge writes out (B, H, hd) float32. Both entry points return
// cudaGetLastError(), or cudaErrorInvalidValue for arguments they do not
// take.

// The CUDA-core kernel: a float32 cache (dtype 0) at hd in {8, 16, 32,
// 64, 128}, or a bfloat16 cache (dtype 1) at hd = 8.
extern "C" int decode_attention(const void* q, int q_f32, const void* k,
                                const void* v, int dtype, const int* len_ptr,
                                int len_val, int B, int T, int KV, int G,
                                int hd, int chunk, int n_chunks,
                                void* part_acc, void* part_ml, void* out,
                                void* stream) {
  using namespace repro;
  if (G < 1 || G > kMaxG || chunk % kDecTile != 0 || n_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, q_f32, k, v, len_ptr, len_val, B, T, KV, G, chunk,
               n_chunks, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDTypeBF16)
    return static_cast<int>(hd == 8 ? launch_cuda_core<uint16_t, 8>(a, s)
                                    : cudaErrorInvalidValue);
  if (dtype != kDTypeF32) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 8: return static_cast<int>(launch_cuda_core<float, 8>(a, s));
    case 16: return static_cast<int>(launch_cuda_core<float, 16>(a, s));
    case 32: return static_cast<int>(launch_cuda_core<float, 32>(a, s));
    case 64: return static_cast<int>(launch_cuda_core<float, 64>(a, s));
    case 128: return static_cast<int>(launch_cuda_core<float, 128>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-core kernel: a bfloat16 cache at hd in {16, 32, 64, 128}; q
// 8-byte aligned.
extern "C" int decode_attention_tc(const void* q, int q_f32, const void* k,
                                   const void* v, const int* len_ptr,
                                   int len_val, int B, int T, int KV, int G,
                                   int hd, int chunk, int n_chunks,
                                   void* part_acc, void* part_ml, void* out,
                                   void* stream) {
  using namespace repro;
  if (G < 1 || G > kMaxG || chunk % kTcTile != 0 || n_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, q_f32, k, v, len_ptr, len_val, B, T, KV, G, chunk,
               n_chunks, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(launch_tc<16>(a, s));
    case 32: return static_cast<int>(launch_tc<32>(a, s));
    case 64: return static_cast<int>(launch_tc<64>(a, s));
    case 128: return static_cast<int>(launch_tc<128>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the tensor-core chunk kernel at hd (and q_f32) that fit on one
// SM of the current device at once, as the occupancy calculator counts
// them; -1 on error or for a head width it does not take.
extern "C" int decode_attention_tc_resident(int hd, int q_f32) {
  using namespace repro;
  switch (hd) {
    case 16: return tc_resident<16>(q_f32);
    case 32: return tc_resident<32>(q_f32);
    case 64: return tc_resident<64>(q_f32);
    case 128: return tc_resident<128>(q_f32);
    default: return -1;
  }
}
