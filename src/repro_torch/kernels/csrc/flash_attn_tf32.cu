// Causal flash-attention forward for float32 q, k, v on Hopper's tensor
// cores, accurate to float32: S = Q K^T by wgmma and O += P V by mma.sync,
// both TF32 products in 3xTF32; K and V tiles streamed by TMA through a
// two-stage mbarrier ring.
//
// Replaces: src/repro/kernels/flash_attn/kernel.py, flash_attention_pallas
// (the Pallas kernel over a (batch*heads, q-blocks, k-blocks) grid with k
// innermost, the running max, normalizer and (Bq, hd) accumulator in VMEM
// scratch across k, and the tiles above the diagonal skipped by pl.when),
// for float32 inputs at every head width (8, 16, 32, 64, 128).
//
// Not TF32 mode. torch's allow_tf32 stays False and no operand is rounded
// to TF32 alone: each float32 operand x is split into big = TF32(x)
// (cvt.rna's rule) and small = x - big (read by the tensor cores as TF32),
// and each product is taken as big * big + big * small + small * big,
// summed in float32 (the 3xTF32 form of CUTLASS's OpMultiplyAddFastF32).
// That keeps ~2^-21 relative, float32's accuracy for these sums; one TF32
// product (~2^-11) misses the port's 1e-4 check ~55x at hd = 128 over 512
// keys (tests/test_torch_attention.py). The split is three integer and
// float instructions (tc.cuh: cvt.rna.tf32.f32 itself is ~5 on sm_90).
//
// What bounds it on an H100: operations. At Yi-9B's train_4k width (S =
// 4096, hd = 128) the causal forward does ~S * hd / 2 FLOPs per byte of
// q, k, v and o. The function's own FLOPs take 0.278 ms at B = 1 at the
// 495 TFLOP/s TF32 rate (2.05 ms at the 67 TFLOP/s FMA peak); the split
// triples the tensor work, so this design's floor is 0.833 ms. mma.sync
// runs TF32 at about half that rate on Hopper: with both products on
// mma.sync this kernel took 2.25 ms, and 2.4x less with one product per
// GEMM instead of three, so its time was its HMMA count. S, half the
// work, therefore goes to wgmma (1.82 ms; PERF.md).
//
// Design: one block per (batch*head, query tile of 128), the heaviest
// (last) query tiles first within each head. A producer warpgroup
// (setmaxnreg down to 40 registers): one thread issues TMA, Q once, then
// the K and V tiles of 64 keys into a two-stage ring, each on its own
// "full" mbarrier; its other three warps split each K tile once for the
// block, big in place and small into a plane of its own (one buffer,
// "km" mbarriers), in the swizzled layout TMA wrote, then fence it for
// the async proxy. Two consumer warpgroups (setmaxnreg up to 232) own 64
// query rows each, eight warps of 16:
// - S (64 x 64) by wgmma m64n64k8 with A = Q from registers (loaded from
//   shared memory and split per k8 step, four steps per commit group, two
//   groups in flight) and B = K's big or small plane through a K-major
//   descriptor; three wgmma per k8 step.
// - The online softmax on the accumulator in the log2 domain, the scale
//   folded into one FMA per logit, ex2.approx (as flash_attn_tc.cu).
// - P V by mma.sync m16n8k8 per warp: wgmma's .tf32 B is K-major only, so
//   V (keys x hd, as TMA lands it) cannot be its B operand, and there is
//   no room for a transposed, split V beside Q (64 KB), the K ring (64
//   KB), K's small plane (32 KB) and the V ring (64 KB): 224 KB of 227.
//   P's A fragment is S's accumulator as it stands (its columns 2t, 2t + 1
//   taken as k t, t + 4: inside a k8 step any order of the sum is as
//   good), so V's B fragment is read from key rows 8j + 2t and 8j + 2t + 1
//   and split in registers; the output columns are permuted the same way
//   (lane g = lane / 4 reads floats 4g .. 4g + 3 of a V row, four n8
//   chunks in one 16-byte load; the store undoes it).
// K and V are released separately ("empty" mbarriers, one arrival per
// warp), so K of tile j + 1 loads and is split while V of tile j is in
// use. Overlapping the next tile's S wgmma with P V was slower (2.42 ms:
// ptxas fenced the warpgroup around the mma.sync), as were eight k8 steps
// per commit group (spills).
//
// Bank conflicts: TMA's 128-byte swizzle puts 16-byte chunk c of row r at
// chunk c ^ (r % 8). V's 16-byte loads hit, per quarter warp, rows 2t at
// chunks g ^ 2t, g in {0, 1}: 8 distinct chunks; Q's 4-byte loads hit rows
// g at chunk c ^ g, words t: 32 banks. (At hd = 16 and 8 rows are 64 and
// 32 bytes, with the 64- and 32-byte swizzles; V's loads there are 2-way
// conflicted.)
//
// Causal: key tiles above the diagonal are never loaded, the two diagonal
// tiles are masked (key > query), and a warpgroup whose 64 rows all lie
// above a tile's first key skips its products (it still waits and
// releases the stage). Guards as in the Pallas kernel: a masked logit
// contributes 0, a row with no valid key keeps m = -inf (its exponent
// base is taken as 0), the output is acc / max(l, 1e-30), the scale
// 1/sqrt(hd). Rows beyond S are zero-filled by TMA and never stored. The
// public (B, S, H, hd) layout is read through one TMA descriptor per
// tensor over its own strides.
#include "tc.cuh"

namespace repro {
namespace {

using namespace tc;

constexpr int kBM = 128;                 // query rows per block
constexpr int kBN = 64;                  // keys per tile
constexpr int kConsumerWarps = 8;        // two warpgroups of 64 rows
constexpr int kThreads = kConsumerWarps * kWarp + 128;  // + producer WG
constexpr int kStages = 2;
constexpr int kSplitters = 96;           // producer warps 1-3 split K
// registers per thread after setmaxnreg: the producer warpgroup keeps
// what the K split needs and gives the rest to the consumers' O, S, P V
// fragments and Q's A fragments in flight
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kChunks = kBN / 8;         // n8 chunks of S, k8 steps of P V

template <int HD>
struct Cfg {
  static constexpr int SW = HD * 4 < 128 ? HD * 4 : 128;  // swizzle bytes
  static constexpr int BOXC = SW / 4;    // floats per column-block row
  static constexpr int NCB = HD / BOXC;  // column blocks of a tile
  static constexpr int CPR = SW / 16;    // 16-byte chunks per row
  static constexpr int FV = BOXC / 8;    // floats per lane of a V row
  static constexpr int LAYOUT = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  static constexpr int QTILE = kBM * HD * 4;
  static constexpr int KTILE = kBN * HD * 4;
  // the byte offset of float f of row r in a column block, as TMA's
  // swizzle placed it (16-byte chunk index XOR address bits 7.. of the row)
  static __device__ __forceinline__ int off(int r, int f) {
    return r * SW + (((f >> 2) ^ ((r * SW >> 7) & (CPR - 1))) << 4) +
           ((f & 3) << 2);
  }
};

struct Bars {
  uint64_t q_full, k_full[kStages], v_full[kStages], k_empty[kStages],
      v_empty[kStages], km_full, km_empty;  // km: K split (one buffer)
};

template <int HD>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(Cfg<HD>::QTILE) +
         (2 * kStages + 1) * static_cast<size_t>(Cfg<HD>::KTILE) +
         sizeof(Bars);
}

// N consecutive floats f0 .. f0 + N - 1 (f0 a multiple of N) of row r of
// a swizzled column block: 16-byte loads, or one of 8 or 4 bytes.
template <int HD, int N>
__device__ __forceinline__ void load_row(float (&x)[N],
                                         const unsigned char* cb, int r,
                                         int f0) {
  using C = Cfg<HD>;
  if constexpr (N >= 4) {
#pragma unroll
    for (int u = 0; u < N / 4; ++u) {
      const float4 v =
          *reinterpret_cast<const float4*>(cb + C::off(r, f0 + 4 * u));
      x[4 * u] = v.x;
      x[4 * u + 1] = v.y;
      x[4 * u + 2] = v.z;
      x[4 * u + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(cb + C::off(r, f0));
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = *reinterpret_cast<const float*>(cb + C::off(r, f0));
  }
}

// S (64 x 64) = Q K^T for this warpgroup by wgmma in 3xTF32: Q's A
// fragments (rows qr, qr + 8; k t and t + 4 of each k8 step, as the B
// descriptor reads K) loaded from shared memory and split in registers;
// K's big plane (dkb, in place of the TMA tile) and small plane (dkm)
// read through K-major descriptors. KG k8 steps per commit group; a
// group's A registers are reused two groups on.
template <int HD>
__device__ __forceinline__ void tile_s(float (&s)[kChunks][4],
                                       const unsigned char* qs,
                                       uint64_t dkb, uint64_t dkm, int qr,
                                       int t) {
  using C = Cfg<HD>;
  constexpr int KSTEPS = HD / 8;
  constexpr int KG = KSTEPS < 4 ? KSTEPS : 4;
  fence_regs(s);
#pragma unroll
  for (int g0 = 0; g0 < KSTEPS; g0 += KG) {
    if (g0 >= 2 * KG) wgmma_wait<1>();
    uint32_t ab[KG][4], am[KG][4];
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      const int k0 = (g0 + u) * 8;
      const unsigned char* qc = qs + (k0 / C::BOXC) * kBM * C::SW;
      const int f = k0 % C::BOXC + t;
      auto q_at = [&](int r, int c) {
        return *reinterpret_cast<const float*>(qc + C::off(r, c));
      };
      split_tf32(q_at(qr, f), ab[u][0], am[u][0]);
      split_tf32(q_at(qr + 8, f), ab[u][1], am[u][1]);
      split_tf32(q_at(qr, f + 4), ab[u][2], am[u][2]);
      split_tf32(q_at(qr + 8, f + 4), ab[u][3], am[u][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < KG; ++u) {
      const int k0 = (g0 + u) * 8;
      const uint32_t off =
          ((k0 / C::BOXC) * kBN * C::SW + (k0 % C::BOXC) * 4) >> 4;
      wgmma_m64n64k8_tf32_rs(s, am[u], dkb + off, g0 + u > 0);
      wgmma_m64n64k8_tf32_rs(s, ab[u], dkm + off, 1);
      wgmma_m64n64k8_tf32_rs(s, ab[u], dkb + off, 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(s);
}

// O (16 x hd) += P V for this warp from a V tile, in 3xTF32: k8 step j
// takes P's A fragment from S's chunk j as it stands (columns 2t, 2t + 1
// as k t, t + 4), so V's B fragment comes from key rows 8j + 2t and
// 8j + 2t + 1; lane g reads floats FV*g .. FV*g + FV - 1 of a column
// block's row, one column of FV n8 chunks (chunk cb*FV + i holds the
// output columns cb*BOXC + FV*n + i, n = 0..7).
template <int HD>
__device__ __forceinline__ void tile_pv(float (&o)[HD / 8][4],
                                        const float (&p)[kChunks][4],
                                        const unsigned char* vt, int g,
                                        int t) {
  using C = Cfg<HD>;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    uint32_t pb[4], pm[4];
    split_tf32(p[j][0], pb[0], pm[0]);
    split_tf32(p[j][2], pb[1], pm[1]);
    split_tf32(p[j][1], pb[2], pm[2]);
    split_tf32(p[j][3], pb[3], pm[3]);
#pragma unroll
    for (int cb = 0; cb < C::NCB; ++cb) {
      const unsigned char* vc = vt + cb * kBN * C::SW;
      float v0[C::FV], v1[C::FV];
      load_row<HD>(v0, vc, 8 * j + 2 * t, C::FV * g);
      load_row<HD>(v1, vc, 8 * j + 2 * t + 1, C::FV * g);
#pragma unroll
      for (int i = 0; i < C::FV; ++i) {
        uint32_t vb0, vm0, vb1, vm1;
        split_tf32(v0[i], vb0, vm0);
        split_tf32(v1[i], vb1, vm1);
        mma_3xtf32(o[cb * C::FV + i], pb, pm, vb0, vb1, vm0, vm1);
      }
    }
  }
}

// The online softmax of one tile in the log2 domain, in place: logits s
// -> weights p = 2^(s * scale_log2 - m); m and l updated; corr, the
// factor for O. With ``diag`` keys above the query are masked; a masked
// logit gives p = 0, and a row with no valid key yet keeps m = -inf with
// exponent base 0. The scale is folded into one FMA per logit (the row
// max is taken on the raw logits: the scale is positive). Lane (g, t)
// holds rows row0 (s[n][0..1]) and row0 + 8 (s[n][2..3]), keys key0 +
// 8n + 2t and + 1.
__device__ __forceinline__ void softmax_tile(float (&s)[kChunks][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool diag,
                                             int key0, int row0, int t,
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kChunks; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c >> 1;
      if (diag && key0 + 8 * n + 2 * t + (c & 1) > row0 + 8 * r)
        s[n][c] = -INFINITY;
      mx[r] = fmaxf(mx[r], s[n][c]);
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
  for (int n = 0; n < kChunks; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c >> 1;
      s[n][c] = ex2_approx(fmaf(s[n][c], scale_log2, neg_base[r]));
      l[r] += s[n][c];                          // per lane; reduced at end
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      float* __restrict__ out, int S, int H,
                      float scale_log2) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char raw[];
  // swizzled tiles need 1024-byte alignment (the 128-byte pattern's span)
  unsigned char* sm = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  unsigned char* qs = sm;
  unsigned char* ks = qs + C::QTILE;
  unsigned char* vs = ks + kStages * C::KTILE;
  unsigned char* kms = vs + kStages * C::KTILE;   // K's small plane
  Bars* bar = reinterpret_cast<Bars*>(kms + C::KTILE);

  // query tiles fastest, heaviest first within each (batch, head): the
  // blocks that run together share one head's K and V in L2
  const int nq = (S + kBM - 1) / kBM;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x % nq);
  const int q0 = qt * kBM;
  const int bh = static_cast<int>(blockIdx.x / nq);
  const int b = bh / H, h = bh % H;
  const int n_keys = q0 + kBM < S ? q0 + kBM : S;   // up to the diagonal
  const int n_tiles = (n_keys + kBN - 1) / kBN;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  if (threadIdx.x == 0) {
    mbar_init(&bar->q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar->k_full[s], 1);
      mbar_init(&bar->v_full[s], 1);
      mbar_init(&bar->k_empty[s], kConsumerWarps);
      mbar_init(&bar->v_empty[s], kConsumerWarps);
    }
    mbar_init(&bar->km_full, kSplitters);
    mbar_init(&bar->km_empty, kConsumerWarps);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {            // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(&bar->q_full, C::QTILE);
      for (int cb = 0; cb < C::NCB; ++cb)
        tma_load_4d(qs + cb * kBM * C::SW, &tq, &bar->q_full, cb * C::BOXC,
                    h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages, reuse = (j / kStages - 1) & 1;
        if (j >= kStages) mbar_wait(&bar->k_empty[st], reuse);
        mbar_expect_tx(&bar->k_full[st], C::KTILE);
        for (int cb = 0; cb < C::NCB; ++cb)
          tma_load_4d(ks + st * C::KTILE + cb * kBN * C::SW, &tk,
                      &bar->k_full[st], cb * C::BOXC, h, j * kBN, b);
        if (j >= kStages) mbar_wait(&bar->v_empty[st], reuse);
        mbar_expect_tx(&bar->v_full[st], C::KTILE);
        for (int cb = 0; cb < C::NCB; ++cb)
          tma_load_4d(vs + st * C::KTILE + cb * kBN * C::SW, &tv,
                      &bar->v_full[st], cb * C::BOXC, h, j * kBN, b);
      }
    } else if (warp > kConsumerWarps) {
      // each K tile split once for the block: big (cvt.rna's rule) in
      // place, small into its plane, at the same swizzled offsets
      const int ct = threadIdx.x - (kConsumerWarps + 1) * kWarp;
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&bar->k_full[st], (j / kStages) & 1);
        if (j > 0) mbar_wait(&bar->km_empty, (j - 1) & 1);
        unsigned char* kt = ks + st * C::KTILE;
        for (int c = ct; c < C::KTILE / 16; c += kSplitters) {
          const float4 x = *reinterpret_cast<const float4*>(kt + 16 * c);
          uint4 big, small;
          split_tf32(x.x, big.x, small.x);
          split_tf32(x.y, big.y, small.y);
          split_tf32(x.z, big.z, small.z);
          split_tf32(x.w, big.w, small.w);
          *reinterpret_cast<uint4*>(kt + 16 * c) = big;
          *reinterpret_cast<uint4*>(kms + 16 * c) = small;
        }
        // the wgmma read these through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&bar->km_full);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));

  // a consumer warp: rows qr and qr + 8 of the Q tile for this lane; its
  // warpgroup owns rows wg * 64 .. + 63
  const int g = lane / 4, t = lane % 4;
  const int qr = warp * 16 + g;
  const int row0 = q0 + qr;
  const int first_row = q0 + warp * 16;   // the warp's first query row
  const int wg_last_row = q0 + (warp / 4) * 64 + 63;
  const uint64_t dk0 = gmma_desc(smem_u32(ks), 16, 8 * C::SW, C::LAYOUT);
  const uint64_t dkm = gmma_desc(smem_u32(kms), 16, 8 * C::SW, C::LAYOUT);
  constexpr uint32_t kTileDesc = C::KTILE >> 4;   // a stage, in desc units
  auto release = [&](uint64_t* empty) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
  };

  float o[HD / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.0f;

  mbar_wait(&bar->q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages, parity = (j / kStages) & 1;
    const int key0 = j * kBN;
    mbar_wait(&bar->km_full, j & 1);     // K landed and split
    if (key0 > wg_last_row) {
      // every key of the tile lies above this warpgroup's rows: nothing
      // to add. The stage is released only once it has landed, so that
      // this warp's arrivals count towards this tile's phases.
      release(&bar->km_empty);
      release(&bar->k_empty[st]);
      mbar_wait(&bar->v_full[st], parity);
      release(&bar->v_empty[st]);
      continue;
    }
    float s[kChunks][4], corr[2];
    tile_s<HD>(s, qs, dk0 + st * kTileDesc, dkm, qr, t);
    release(&bar->km_empty);
    release(&bar->k_empty[st]);
    softmax_tile(s, m, l, corr, key0 + kBN - 1 > first_row, key0, row0, t,
                 scale_log2);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }
    mbar_wait(&bar->v_full[st], parity);
    tile_pv<HD>(o, s, vs + st * C::KTILE, g, t);
    release(&bar->v_empty[st]);
  }

  // lane t holds output columns cb*BOXC + 2t*FV .. + 2*FV - 1 of each
  // column block: chunk cb*FV + i, column n = 2t + u is float FV*u + i
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    float* op = out + ((static_cast<size_t>(b) * S + row) * H + h) * HD;
#pragma unroll
    for (int cb = 0; cb < C::NCB; ++cb) {
      float w[2 * C::FV];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < C::FV; ++i)
          w[C::FV * u + i] = o[cb * C::FV + i][2 * r + u] * inv;
      float* dst = op + cb * C::BOXC + 2 * t * C::FV;
      if constexpr (2 * C::FV >= 4) {
#pragma unroll
        for (int u = 0; u < 2 * C::FV; u += 4)
          *reinterpret_cast<float4*>(dst + u) =
              make_float4(w[u], w[u + 1], w[u + 2], w[u + 3]);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(w[0], w[1]);
      }
    }
  }
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const long long* strides, float* out, int B, int S,
                      int H, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap mq, mk, mv;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!make_map(&mq, q, kF32, 4, B, S, H, HD, strides, C::BOXC, kBM,
                C::SW) ||
      !make_map(&mk, k, kF32, 4, B, S, H, HD, strides + 3, C::BOXC, kBN,
                C::SW) ||
      !make_map(&mv, v, kF32, 4, B, S, H, HD, strides + 6, C::BOXC, kBN,
                C::SW))
    return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_tf32_kernel<HD>;
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

// q, k, v (B, S, H, hd) float32, channels contiguous, batch/sequence/head
// strides in elements (strides[0..2] for q, [3..5] for k, [6..8] for v),
// every base 16-byte aligned and every stride a multiple of 4 elements
// (TMA's rule); hd in {8, 16, 32, 64, 128}; out (B, S, H, hd) float32,
// contiguous. Causal. Returns cudaGetLastError(), or cudaErrorInvalidValue
// if a TMA descriptor cannot be made.
extern "C" int flash_attention_tf32(const void* q, const void* k,
                                    const void* v, const long long* strides,
                                    void* out, int B, int S, int H, int hd,
                                    void* stream) {
  using namespace repro;
  if (S == 0 || B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (hd) {
    case 8: return static_cast<int>(
        launch_hd<8>(q, k, v, strides, o, B, S, H, s));
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
