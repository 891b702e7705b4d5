// Causal flash-attention forward for bf16 q, k, v on Hopper's tensor
// cores: S = Q K^T and O += P V as wgmma (bf16 in, float32 out), K and V
// tiles streamed by TMA through a two-stage mbarrier ring.
//
// Replaces: src/repro/kernels/flash_attn/kernel.py, flash_attention_pallas
// (the Pallas kernel over a (batch*heads, q-blocks, k-blocks) grid with k
// innermost, the running max, normalizer and (Bq, hd) accumulator in VMEM
// scratch across k, and the tiles above the diagonal skipped by pl.when),
// for bfloat16 inputs and hd in {16, 32, 64, 128}. Float32 inputs, and
// bf16 at hd = 8 (under wgmma's k16 depth), stay on the CUDA-core kernel
// of flash_attn.cu.
//
// What bounds it on an H100: operations. At Yi-9B's train_4k width (S =
// 4096, hd = 128) the causal forward does ~S * hd / 2 FLOPs per byte of
// q, k, v and o, far above the ~295 FLOP/byte at which bf16 tensor cores
// stop waiting on memory. P is split into bf16 hi + lo and multiplied
// twice (P V = P_hi V + P_lo V): rounding P once to bf16, as the Pallas
// kernel does, misses the port's 1e-4 relative check by ~150x at this
// width, and the split keeps ~2^-17. So the tensor work is 1.5x the
// function's 4 * hd FLOPs per causal pair, and the bound 1.5x the plain
// bf16 one.
//
// Design (the FlashAttention-3 shape, without its ping-pong scheduling
// between warpgroups): one block per (batch*head, query tile of 128), the
// heaviest (last) query tiles scheduled first. A producer warpgroup
// (setmaxnreg down to 24 registers) has one thread issue TMA: Q once, then
// the K and V tiles of 128 keys, each on its own "full" mbarrier, into a
// two-stage ring; the consumers release K and V separately ("empty"
// mbarriers), so K of tile j + 1 loads while V of tile j is still in use.
// Two consumer warpgroups (setmaxnreg up to 240) own 64 query rows each:
// S (64 x 128) by wgmma m64n128k16 with Q and K both read from shared
// memory (K-major); the online softmax on the accumulator fragments in
// the log2 domain (each row's max across the 4 lanes that share it, the
// sum kept per lane and reduced once at the end); P converted in
// registers to the A fragments of P V (no shared-memory round trip),
// split hi/lo; and O (64 x hd) += P V by wgmma m64n{hd}k16 with V read
// MN-major through the descriptor's transpose. Tile j's S is issued
// before tile j - 1's P V, so tile j's exponentials run while P V is on
// the tensor cores. Tiles are 128-byte (64-byte, 32-byte for hd = 32, 16)
// swizzled by TMA and read with the matching descriptor layout; hd = 128
// is two column blocks of 64. Causal: key tiles above the diagonal are
// never loaded, the diagonal tile is masked; rows beyond S are
// zero-filled by TMA and never stored. Guards as in the Pallas kernel: a
// masked logit contributes 0, a row with no valid key keeps m = -inf (its
// exponent base is taken as 0), the output is acc / max(l, 1e-30), the
// scale is 1/sqrt(hd). The public (B, S, H, hd) layout is read through
// one TMA descriptor per tensor with dims (hd, H, S, B) and the tensor's
// own strides, so no transposed copy is made.
#include "tc.cuh"

namespace repro {
namespace {

using namespace tc;

constexpr int kBM = 128;                 // query rows per block
constexpr int kBN = 128;                 // keys per tile
constexpr int kConsumerWarps = 8;        // two warpgroups of 64 rows
constexpr int kThreads = kConsumerWarps * kWarp + 128;  // + producer WG
constexpr int kStages = 2;
// registers per thread after setmaxnreg: the producer warpgroup gives up
// what the consumers' S, P (hi, lo) and O fragments need
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int HD>
struct Cfg {
  static constexpr int SW = HD * 2 < 128 ? HD * 2 : 128;  // swizzle bytes
  static constexpr int BOXC = SW / 2;       // elements per TMA box row
  static constexpr int NCB = HD / BOXC;     // column blocks of a tile
  static constexpr int CB = kBN * SW;       // bytes of one column block
  static constexpr int TILE = kBN * HD * 2; // bytes of a Q, K or V tile
  static constexpr int LAYOUT = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
};

struct Bars {
  uint64_t q_full, k_full[kStages], v_full[kStages], k_empty[kStages],
      v_empty[kStages];
};

template <int HD>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(Cfg<HD>::TILE) * (1 + 2 * kStages) +
         sizeof(Bars);
}

// S (64 x 128) = Q K^T for this warpgroup from the descriptors of its Q
// rows and of a K tile: hd / 16 steps of k16, each a column block and 32
// bytes inside it. Committed as one group.
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[64], uint64_t dq,
                                        uint64_t dk) {
  using C = Cfg<HD>;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk * 16 / C::BOXC) * C::CB + (kk * 16 % C::BOXC) * 2;
    wgmma_m64n128k16_ss(s, dq + (off >> 4), dk + (off >> 4), kk > 0);
  }
  wgmma_commit();
}

// O (64 x hd) += P_hi V + P_lo V from the descriptor of a V tile: 8 steps
// of k16 keys, V MN-major. Committed as one group.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&ph)[8][4],
                                         const uint32_t (&pl)[8][4],
                                         uint64_t dv) {
  using C = Cfg<HD>;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t d = dv + ((kk * 16 * C::SW) >> 4);
    wgmma_rs<HD>(o, ph[kk], d);
    wgmma_rs<HD>(o, pl[kk], d);
  }
  wgmma_commit();
}

// The online softmax of one tile in the log2 domain, in place: logits s
// -> weights p = 2^(s * scale_log2 - m); m and l updated; corr, the
// factor for O. Only the diagonal tile is masked (key > query); a masked
// logit gives p = 0, and a row with no valid key yet keeps m = -inf with
// exponent base 0. The scale is folded into one FMA per logit (the row
// max is taken on the raw logits: the scale is positive).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool diag, int key0, int row0,
                                             int t, float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    if (diag && key0 + (i >> 2) * 8 + 2 * t + (i & 1) > row0 + 8 * r)
      s[i] = -INFINITY;
    mx[r] = fmaxf(mx[r], s[i]);
  }
  float neg_base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    const float base = m_new == -INFINITY ? 0.0f : m_new;
    corr[r] = ex2_approx(m[r] - base);          // 0 while m = -inf
    m[r] = m_new;
    l[r] *= corr[r];
    neg_base[r] = -base;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2_approx(fmaf(s[i], scale_log2, neg_base[r]));
    l[r] += s[i];                               // per lane; reduced at end
  }
}

// P (float32, in the S fragment) -> the A fragments of P V, hi and lo:
// n8 chunks 2kk and 2kk + 1 make k16 step kk.
__device__ __forceinline__ void split_p(const float (&s)[64],
                                        uint32_t (&ph)[8][4],
                                        uint32_t (&pl)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split_bf16x2(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1], ph[kk][q],
                   pl[kk][q]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    float* __restrict__ out, int S, int H,
                    float scale_log2) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char raw[];
  // swizzled tiles need 1024-byte alignment (the 128-byte pattern's span)
  unsigned char* sm = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  unsigned char* qs = sm;
  unsigned char* ks = qs + C::TILE;
  unsigned char* vs = ks + kStages * C::TILE;
  Bars* bar = reinterpret_cast<Bars*>(vs + kStages * C::TILE);

  // query tiles fastest, heaviest first within each (batch, head): the
  // blocks that run together share one head's K and V in L2
  const int nq = (S + kBM - 1) / kBM;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x % nq);
  const int q0 = qt * kBM;
  const int bh = static_cast<int>(blockIdx.x / nq);
  const int b = bh / H, h = bh % H;
  const int n_tiles = qt + 1;              // key tiles up to the diagonal
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  if (threadIdx.x == 0) {
    mbar_init(&bar->q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar->k_full[s], 1);
      mbar_init(&bar->v_full[s], 1);
      mbar_init(&bar->k_empty[s], kConsumerWarps);
      mbar_init(&bar->v_empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {            // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(&bar->q_full, C::TILE);
      for (int cb = 0; cb < C::NCB; ++cb)
        tma_load_4d(qs + cb * C::CB, &tq, &bar->q_full, cb * C::BOXC, h, q0,
                    b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages, reuse = (j / kStages - 1) & 1;
        if (j >= kStages) mbar_wait(&bar->k_empty[st], reuse);
        mbar_expect_tx(&bar->k_full[st], C::TILE);
        for (int cb = 0; cb < C::NCB; ++cb)
          tma_load_4d(ks + st * C::TILE + cb * C::CB, &tk, &bar->k_full[st],
                      cb * C::BOXC, h, j * kBN, b);
        if (j >= kStages) mbar_wait(&bar->v_empty[st], reuse);
        mbar_expect_tx(&bar->v_full[st], C::TILE);
        for (int cb = 0; cb < C::NCB; ++cb)
          tma_load_4d(vs + st * C::TILE + cb * C::CB, &tv, &bar->v_full[st],
                      cb * C::BOXC, h, j * kBN, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));

  // a consumer warpgroup: rows wg * 64 .. + 63 of the tile; this lane's
  // rows are row0 and row0 + 8
  const int wg = warp / 4;
  const int t = lane % 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  // descriptors: Q (this warpgroup's 64 rows) and K read K-major, V
  // MN-major (the leading offset steps a column block)
  const uint64_t dq = gmma_desc(smem_u32(qs) + wg * 64 * C::SW, 16,
                                8 * C::SW, C::LAYOUT);
  const uint64_t dk0 = gmma_desc(smem_u32(ks), 16, 8 * C::SW, C::LAYOUT);
  const uint64_t dv0 = gmma_desc(smem_u32(vs), C::CB, 8 * C::SW, C::LAYOUT);
  constexpr uint32_t kTileDesc = C::TILE >> 4;   // a stage, in desc units
  auto release = [&](uint64_t* empty) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
  };

  float s[64], o[HD / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float corr[2];
  uint32_t ph[8][4], pl[8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;

  // tile 0: S, softmax, P; then each tile j issues its S before tile
  // j - 1's P V, so tile j's softmax runs while P V is on the tensor cores
  mbar_wait(&bar->q_full, 0);
  mbar_wait(&bar->k_full[0], 0);
  issue_s<HD>(s, dq, dk0);
  wgmma_wait<0>();
  fence_regs(s);
  release(&bar->k_empty[0]);
  softmax_tile(s, m, l, corr, qt == 0, 0, row0, t, scale_log2);
  split_p(s, ph, pl);
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % kStages, pst = (j - 1) % kStages;
    mbar_wait(&bar->k_full[st], (j / kStages) & 1);
    issue_s<HD>(s, dq, dk0 + st * kTileDesc);
    mbar_wait(&bar->v_full[pst], ((j - 1) / kStages) & 1);
    issue_pv<HD>(o, ph, pl, dv0 + pst * kTileDesc);
    wgmma_wait<1>();                       // S of tile j is in
    fence_regs(s);
    release(&bar->k_empty[st]);
    softmax_tile(s, m, l, corr, j == qt, j * kBN, row0, t, scale_log2);
    wgmma_wait<0>();                       // P V of tile j - 1 is in
    fence_regs(o);
    release(&bar->v_empty[pst]);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[4 * i] *= corr[0];
      o[4 * i + 1] *= corr[0];
      o[4 * i + 2] *= corr[1];
      o[4 * i + 3] *= corr[1];
    }
    split_p(s, ph, pl);
  }
  const int last = (n_tiles - 1) % kStages;
  mbar_wait(&bar->v_full[last], ((n_tiles - 1) / kStages) & 1);
  issue_pv<HD>(o, ph, pl, dv0 + last * kTileDesc);
  wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    float* op = out + ((static_cast<size_t>(b) * S + row) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<float2*>(op + 8 * i + 2 * t) =
          make_float2(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
  }
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const long long* strides, float* out, int B, int S,
                      int H, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap mq, mk, mv;
  constexpr CUtensorMapDataType kBF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map(&mq, q, kBF16, 2, B, S, H, HD, strides, C::BOXC, kBM,
                C::SW) ||
      !make_map(&mk, k, kBF16, 2, B, S, H, HD, strides + 3, C::BOXC, kBN,
                C::SW) ||
      !make_map(&mv, v, kBF16, 2, B, S, H, HD, strides + 6, C::BOXC, kBN,
                C::SW))
    return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_tc_kernel<HD>;
  allow_smem(kernel, smem);
  const unsigned grid =
      static_cast<unsigned>(B) * H * ((S + kBM - 1) / kBM);
  const float scale_log2 = 1.4426950408889634f /     // log2(e) / sqrt(hd)
                           sqrtf(static_cast<float>(HD));
  kernel<<<grid, kThreads, smem, stream>>>(mq, mk, mv, out, S, H,
                                           scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q, k, v (B, S, H, hd) bfloat16, channels contiguous, batch/sequence/head
// strides in elements (strides[0..2] for q, [3..5] for k, [6..8] for v),
// every base 16-byte aligned and every stride a multiple of 8 elements
// (TMA's rule); hd in {16, 32, 64, 128}; out (B, S, H, hd) float32,
// contiguous. Causal. Returns cudaGetLastError(), or cudaErrorInvalidValue
// if a TMA descriptor cannot be made.
extern "C" int flash_attention_tc(const void* q, const void* k,
                                  const void* v, const long long* strides,
                                  void* out, int B, int S, int H, int hd,
                                  void* stream) {
  using namespace repro;
  if (S == 0 || B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (hd) {
    case 16: return static_cast<int>(
        launch_hd<16>(q, k, v, strides, o, B, S, H, s));
    case 32: return static_cast<int>(
        launch_hd<32>(q, k, v, strides, o, B, S, H, s));
    case 64: return static_cast<int>(
        launch_hd<64>(q, k, v, strides, o, B, S, H, s));
    case 128: return static_cast<int>(
        launch_hd<128>(q, k, v, strides, o, B, S, H, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
