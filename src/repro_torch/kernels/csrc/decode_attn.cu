// Flash-decode GQA attention: one query position per (batch, head)
// against a length-masked KV cache, online softmax in float32.
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
// Design: the TPU walks T in order on one core; here one block per
// (T-chunk, kv head, batch) row runs in parallel and a second small kernel
// merges the chunks (flash-decode), so even long_500k (B = 1, KV = 4) puts
// ~500 blocks on the 132 SMs instead of 4. A block takes its chunk 128
// positions at a time: (1) each thread scores one position against the G
// query heads (its K row in 16-byte loads, q transposed in shared memory
// and read four heads per load), (2) a warp per head folds the tile into
// the running (m, l) and rescales, as the Pallas kernel does, with its
// guards: a masked logit contributes 0, a chunk with no valid position
// writes m = -inf and l = 0, and the merge divides by max(l, 1e-30), so
// length = 0 gives zeros; (3) each thread owns one channel of the
// accumulator for its heads (all G heads at hd = 128) and streams V rows,
// coalesced along hd, reading P four heads per shared-memory load (this
// halved the kernel's time on the card: shared-memory loads, not bytes
// from device memory, were its limit). P stays in float32 (no rounding to
// v's dtype before the product, unlike the MXU path). ``length`` is read
// from device memory, as the Pallas kernel reads it from SMEM, so a decode
// loop never syncs the host; positions at or beyond it are neither read
// nor counted, so the cache needs no padding.
#include "elem.cuh"

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

// One block per (batch, head), one thread per channel: rescale each
// chunk's partial sums to the common max and divide once.
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
  for (int c = 0; c < n_chunks; ++c)
    m = fmaxf(m, part_ml[((base + c) * G + g) * 2]);
  float l = 0.0f, acc = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t p = (base + c) * G + g;
    const float mc = part_ml[p * 2];
    if (mc == -INFINITY) continue;
    const float f = expf(mc - m);
    l = fmaf(part_ml[p * 2 + 1], f, l);
    acc = fmaf(part_acc[p * hd + d], f, acc);
  }
  out[static_cast<size_t>(bh) * hd + d] = acc / fmaxf(l, 1e-30f);
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, int q_f32, const void* k, const void* v,
                      const int* len_ptr, int len_val, int B, int T_, int KV,
                      int G, int chunk, int n_chunks, float* part_acc,
                      float* part_ml, float* out, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  dim3 grid(n_chunks, KV, B);
  decode_chunk_kernel<T, HD><<<grid, kDecThreads, 0, stream>>>(
      q, q_f32, static_cast<const T*>(k), static_cast<const T*>(v), len_ptr,
      len_val, T_, KV, G, chunk, scale, part_acc, part_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<<<B * KV * G, HD, 0, stream>>>(part_acc, part_ml, out,
                                                     n_chunks, KV, G, HD);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int hd, const void* q, int q_f32, const void* k,
                   const void* v, const int* len_ptr, int len_val, int B,
                   int T_, int KV, int G, int chunk, int n_chunks,
                   float* part_acc, float* part_ml, float* out,
                   cudaStream_t s) {
  switch (hd) {
    case 8:
      return launch_hd<T, 8>(q, q_f32, k, v, len_ptr, len_val, B, T_, KV, G,
                             chunk, n_chunks, part_acc, part_ml, out, s);
    case 16:
      return launch_hd<T, 16>(q, q_f32, k, v, len_ptr, len_val, B, T_, KV,
                              G, chunk, n_chunks, part_acc, part_ml, out, s);
    case 32:
      return launch_hd<T, 32>(q, q_f32, k, v, len_ptr, len_val, B, T_, KV,
                              G, chunk, n_chunks, part_acc, part_ml, out, s);
    case 64:
      return launch_hd<T, 64>(q, q_f32, k, v, len_ptr, len_val, B, T_, KV,
                              G, chunk, n_chunks, part_acc, part_ml, out, s);
    case 128:
      return launch_hd<T, 128>(q, q_f32, k, v, len_ptr, len_val, B, T_, KV,
                               G, chunk, n_chunks, part_acc, part_ml, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q (B, H, hd) float32 (q_f32) or in the cache's dtype; k, v (B, T, KV, hd)
// in dtype (0 float32, 1 bfloat16); the valid prefix is *len_ptr if
// len_ptr is not NULL, else len_val (clamped to [0, T]). The chunk kernel
// runs n_chunks blocks of ``chunk`` positions (a multiple of 128) per
// (batch, kv head) into part_acc (B, KV, n_chunks, G, hd) and part_ml
// (B, KV, n_chunks, G, 2); the merge writes out (B, H, hd) float32.
// Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, int q_f32, const void* k,
                                const void* v, int dtype, const int* len_ptr,
                                int len_val, int B, int T, int KV, int G,
                                int hd, int chunk, int n_chunks,
                                void* part_acc, void* part_ml, void* out,
                                void* stream) {
  using namespace repro;
  if (G < 1 || G > kMaxG || chunk % kDecTile != 0 || n_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  float* o = static_cast<float*>(out);
  if (dtype == kDTypeF32)
    return static_cast<int>(launch<float>(hd, q, q_f32, k, v, len_ptr,
                                          len_val, B, T, KV, G, chunk,
                                          n_chunks, pa, pm, o, s));
  if (dtype == kDTypeBF16)
    return static_cast<int>(launch<uint16_t>(hd, q, q_f32, k, v, len_ptr,
                                             len_val, B, T, KV, G, chunk,
                                             n_chunks, pa, pm, o, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
