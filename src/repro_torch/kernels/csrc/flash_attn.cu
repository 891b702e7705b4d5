// Causal FlashAttention-2 forward on CUDA cores: per (batch, head) and
// query tile, the online softmax over the key tiles up to the diagonal, in
// float32. It serves only bf16 q/k/v at hd = 8, under wgmma's k16 depth;
// bf16 at hd >= 16 runs on the tensor cores (flash_attn_tc.cu), and
// float32 at every width too, in 3xTF32 (flash_attn_tf32.cu), which
// replaced this kernel's float32 instantiations.
//
// Replaces: src/repro/kernels/flash_attn/kernel.py, flash_attention_pallas
// (the Pallas kernel over a (batch*heads, q-blocks, k-blocks) grid with k
// innermost, the running max, normalizer and (Bq, hd) accumulator in VMEM
// scratch across k, and the tiles above the diagonal skipped by pl.when),
// for bf16 inputs at hd = 8.
//
// What bounds it on an H100: operations, at the 67 TFLOP/s FMA peak (the
// causal forward does ~S * hd / 2 FLOPs for each byte of q, k, v and o).
//
// Design: one block of 256 threads per (query tile of 64 rows, batch*head),
// the heaviest (last) query tiles scheduled first. The block keeps its Q
// tile in shared memory and walks key tiles of 64 only up to the diagonal
// (the Pallas pl.when skip); each key tile is staged twice through one
// buffer, K for S = Q K^T, then V for O += P V. Rows are padded to
// hd + 1 floats, so the row-major reads of S = Q K^T and the V reads are
// free of bank conflicts; P goes through shared memory transposed, read as
// float4. Each thread holds a 4 x 4 tile of S and 4 rows x hd/16 channels
// of the accumulator; the running (m, l) of a row lives in the 16 lanes
// that share it and is reduced with half-warp shuffles. Masked logits add
// 0, the output is acc / max(l, 1e-30), as in the Pallas kernel. The
// public (B, S, H, hd) layout is read through its strides (no transpose to
// (BH, S, hd)), and the ragged S edge is masked in the kernel, not padded.
#include "elem.cuh"

namespace repro {
namespace {

constexpr int kFlashThreads = 256;
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key rows per tile
constexpr int kPStride = kBQ + 4;

struct Strides {
  long long b, s, h;  // elements; the channel stride is 1
};

template <int HD>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + kBK) * (HD + 1) + kBK * kPStride);
}

template <typename T, int HD>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const T* __restrict__ src,
                                           Strides st, int b, int h, int row0,
                                           int rows, int S) {
  constexpr int P = HD + 1;
  for (int e = threadIdx.x; e < rows * HD; e += kFlashThreads) {
    const int r = e / HD, d = e % HD, s = row0 + r;
    dst[r * P + d] = s < S ? Elem<T>::to_f32(__ldg(
                                 src + b * st.b + s * st.s + h * st.h + d))
                           : 0.0f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kFlashThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ out, int S,
                     int H, Strides sq, Strides sk, Strides sv, float scale) {
  constexpr int P = HD + 1;
  constexpr int CPT = (HD + 15) / 16;  // accumulator channels per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [kBQ][P]
  float* KVs = Qs + kBQ * P;           // [kBK][P]: K, then V
  float* Ps = KVs + kBK * P;           // [kBK][kPStride]: P transposed

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  stage_tile<T, HD>(Qs, q, sq, b, h, q0, kBQ, S);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.0f;
  }
  const int last_q = (q0 + kBQ < S ? q0 + kBQ : S) - 1;

  for (int k0 = 0; k0 <= last_q; k0 += kBK) {
    __syncthreads();                   // the last tile's V reads are done
    stage_tile<T, HD>(KVs, k, sk, b, h, k0, kBK, S);
    __syncthreads();

    // S = Q K^T on this thread's rows ty*4 + i and keys tx + 16*c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * P + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = KVs[(tx + 16 * c) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // online softmax over the tile, row by row (16 lanes share a row)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        s[i][c] = (kpos <= qpos && kpos < S) ? s[i][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = s[i][c] == -INFINITY ? 0.0f : expf(s[i][c] - m_new);
        sum += s[i][c];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[i][cc] *= corr;
    }
    __syncthreads();                   // every thread is done with K

#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * c) * kPStride + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    stage_tile<T, HD>(KVs, v, sv, b, h, k0, kBK, S);
    __syncthreads();

    // O += P V
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[j * kPStride +
                                                            ty * 4]);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int d = tx + 16 * cc;
        if (d < HD) {
          const float vv = KVs[j * P + d];
          acc[0][cc] = fmaf(p.x, vv, acc[0][cc]);
          acc[1][cc] = fmaf(p.y, vv, acc[1][cc]);
          acc[2][cc] = fmaf(p.z, vv, acc[2][cc]);
          acc[3][cc] = fmaf(p.w, vv, acc[3][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    float* o = out + ((static_cast<size_t>(b) * S + row) * H + h) * HD;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int d = tx + 16 * cc;
      if (d < HD) o[d] = acc[i][cc] * inv;
    }
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, float* out,
                      int B, int S, int H, Strides sq, Strides sk, Strides sv,
                      cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<T, HD>;
  allow_smem(kernel, smem);
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, S, H, sq, sk, sv,
      1.0f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q, k, v (B, S, H, 8) bfloat16, channels contiguous, batch/sequence/head
// strides in elements (strides[0..2] for q, [3..5] for k, [6..8] for v);
// out (B, S, H, 8) float32, contiguous. Causal. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for another hd.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const long long* strides, void* out, int B,
                               int S, int H, int hd, void* stream) {
  using namespace repro;
  if (hd != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0 || B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  return static_cast<int>(launch_hd<uint16_t, 8>(
      q, k, v, static_cast<float*>(out), B, S, H, sq, sk, sv,
      static_cast<cudaStream_t>(stream)));
}
