// Causal flash-attention forward over [B, T, H, Dh] (kernel K2).
//
// Replaces the TPU kernel superconductor_vae_tpu/ops/pallas_attention.py
// pallas_attention (body _attn_kernel).  For every (batch row b, head h)
// and query t it computes
//     out[b,t,h,:] = sum_{u <= t} softmax_u(q[b,t,h,:] . k[b,u,h,:] * scale) v[b,u,h,:]
// with an online softmax over key tiles, float32 running max / sum /
// accumulator, masked scores -1e30, and a final division by max(l, 1e-30),
// as the TPU kernel does.  Like it, the predicate is always causal.  The
// scale is 1/sqrt(real Dh), given by the caller, and multiplies the float32
// dot product.  In bfloat16 the probabilities are rounded to bfloat16
// before the P.V product, as the TPU kernel's p.astype(v.dtype) does; the
// row sums add the unrounded float32 probabilities.
//
// Bound on an H100 SXM: q, k, v read once and out written once,
// 4 * B*T*H*Dh elements; 4 * Dh * B*H * T(T+1)/2 causal FLOPs.  At B=64,
// H=8, Dh=72 in float32 that is 75.5 MB / 22.5 us at 3.35 TB/s for T=128
// and 151 MB / 45.1 us for T=256.  On the tensor cores in 3xTF32 (three
// TF32 products per float32 product, 495 TFLOP/s) the 1.22 and 4.85 GFLOP
// take 7.4 and 29.4 us, so the bytes bound both; on the CUDA cores' float32
// FMA (67 TFLOP/s) they took 18.2 and 72.4 us.  In bfloat16 the bytes halve
// (37.7 MB / 11.3 us at T=128, 75.5 MB / 22.5 us at T=256) and bound both:
// at 989 TFLOP/s on the tensor cores the FLOPs take 1.2 and 4.9 us.  The
// work has T/4 FLOPs per byte, 32-64 here, far below the card's ridge of
// ~295 (bf16), so a kernel that keeps the tensor cores fed and overlaps its
// loads lands near the byte bound; mma.sync is enough for that, and
// wgmma/TMA pay only at T in the thousands.
//
// Both instances share one structure, flash-attention-2 style:
//   - one block of 4 warps per (b*h, 64-query tile), heaviest tiles first;
//     warp w owns query rows 16w..16w+15 of the tile;
//   - Dh is padded in shared memory only, to a template parameter DHP; the
//     pad columns are zeroed once and nothing padded is read from or
//     written to device memory;
//   - the Q tile is loaded once with cp.async (16 B, src-size 0 zero-fills
//     rows past T); K/V tiles go through a two-stage cp.async ring, tile
//     j+1 in flight while tile j is computed, K and V in separate commit
//     groups so that Q.K^T starts before V has landed; key tiles wholly
//     above the diagonal are never loaded;
//   - S = Q.K^T and O += P.V on the tensor cores with mma.sync, float32
//     accumulators; the scale in float32 after the product and, on the
//     diagonal tiles only (a separate instance of the tile code), the
//     causal mask and a warp's skip of the key blocks past its last row;
//   - the online softmax runs in registers (expf, as the plain version):
//     each thread holds 2 rows of the fragment, row max and sum reduced as
//     trees and over the 4-lane quad with shuffles; P stays in registers;
//   - the epilogue divides by max(l, 1e-30) (one reciprocal a row), stages
//     the warp's 16 rows in its own rows of the Q tile and stores the real
//     Dh columns of rows < T with 16-byte stores.
//
// float32 instance (tc::flash_attention_f32_kernel, any Dh that is a
// multiple of 4 up to 256; DHP = 64, 72, 128 or 256, so run4's 72 runs
// unpadded):
//   - mma.sync m16n8k8 in TF32, three products per k-step (3xTF32, as the
//     CUTLASS kernel behind torch's float32 SDPA): each operand x is split
//     into hi = x rounded to TF32 and lo = x - hi; a.b = a_lo.b_hi +
//     a_hi.b_lo + a_hi.b_hi, the small terms first;
//   - Q is split once into registers at DHP <= 72 (72 registers of hi and
//     lo parts); above, its fragments are read from shared memory and split
//     at each k-step.  K and V are split per fragment in registers by each
//     warp;
//   - Q and K fragments load with ldmatrix (an 8x8 b16 matrix is an 8x4
//     float32 matrix in the TF32 A and B layouts), V's with 32-bit loads;
//     row pitch DHP + 4 floats keeps both free of bank conflicts;
//   - P.V takes P from the S accumulators with the keys of each k8 step
//     permuted (see the layouts at the kernel);
//   - 64-key tiles at DHP <= 72 (97 KB of shared memory, two blocks an SM),
//     32-key tiles above (DHP 128: 101 KB, two blocks; DHP 256: 195 KB,
//     one block).
//
// bfloat16 instance (tc::flash_attention_bf16_kernel, any Dh that is a
// multiple of 8 up to 256; DHP = 64, 80, 128 or 256, so 72 pads to 80):
//   - row pitch DHP + 8 bf16 (176 B at DHP 80) puts the 8 rows of each
//     ldmatrix on distinct banks;
//   - mma.sync m16n8k16 (bf16 in): Q as A-fragments by ldmatrix.x4 (kept in
//     registers for DHP <= 128, re-read per k-step at 256), K as
//     B-fragments by ldmatrix.x4 straight from its row-major tile;
//   - P.V: the S accumulators of two n8 tiles are exactly the A-fragment
//     of one k16 step (m16n8 C layout = m16k16 A layout), so P is rounded
//     to bf16 in registers; V is read as B-fragments by ldmatrix.x4.trans;
//   - the output is rounded once to bf16 before the store.
// What measurement on the H100 decided for bfloat16 (chip_smoke.py times
// the result):
//   - the work per key tile is what bounds these shapes, more than the
//     bytes: every runtime guard in the unrolled tile loops cost a branch,
//     so only the diagonal tile (a separate instance of the tile code)
//     masks and lets a warp skip the 16-key blocks past its last row;
//     below the diagonal nothing is guarded, and all DHP/8 output n-tiles
//     and DHP/16 k-steps run (the pad columns are zeros);
//   - four blocks an SM (16 warps) beat fewer blocks with more registers:
//     DHP 64 and 80 are held to 128 registers (no spills), and shared
//     memory is 5 tiles of 64 x (DHP + 8) bf16 (56 KB at DHP 80, with the
//     carveout set to all shared memory).  A block that stays resident
//     over several query tiles, prefetching the next one's Q and first K/V
//     tile, needed 167 registers, lost a block an SM and ran slower; a
//     third ring stage would cost a block too;
//   - at DHP 256 the 16 x 256 float32 accumulator alone takes 128 registers
//     a thread; ptxas fits the instance in 255 registers, 165 KB of shared
//     memory, one block an SM.  Spills would be allowed there only.

// What measurement on the H100 decided for float32 (chip_smoke.py times
// the result; superconductor_vae_tpu_torch/tools/k2_f32_variants.py builds
// and times the alternatives below in one call):
//   - cvt.rna.tf32.f32 takes several SASS instructions; rounding hi with
//     two integer instructions gives the same hi for finite x, and lo is
//     left to the tensor core's truncation, as CUTLASS's FastF32 does;
//   - splitting K and V per fragment in registers, though each of the 4
//     warps splits the same tile, beat splitting once a tile into hi/lo
//     planes in shared memory: the planes need a barrier after the split,
//     give up the K/V overlap and, with 64-key tiles, a block an SM;
//   - at DHP 72, 64-key tiles and two blocks an SM beat 32-key tiles with
//     two or three (three spill under the 168-register cap);
//   - ptxas fits every instance without spills (DHP 72: 227 registers).

// Built with nvcc into a plain-C shared library and called through ctypes
// (ops/fused_attention.py); the launchers return the launch's cudaError_t.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// -- bfloat16 instance: tensor cores ----------------------------------------

namespace tc {

constexpr int kRows = 64;               // query rows per block = keys per tile
constexpr int kWarps = 4;               // 16 query rows each
constexpr int kThreads = 32 * kWarps;

template <int DHP>
struct Cfg {
  static constexpr int kPitch = DHP + 8;           // bf16 per shared-memory row
  static constexpr int kTile = kRows * kPitch;     // bf16 per tile
  static constexpr int kSmemBytes = 5 * kTile * 2; // Q + 2 stages of K and V
  static constexpr int kMinBlocks = DHP <= 80 ? 4 : 1;  // an SM; 4: <= 128 registers
  static constexpr int kKSteps = DHP / 16;         // k16 steps of Q.K^T
  static constexpr int kNTiles = DHP / 8;          // n8 tiles of P.V
  static constexpr bool kQInRegs = DHP <= 128;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros when !valid (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one 32-bit register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

template <bool B>
struct Bool { static constexpr bool value = B; };

// Max and sum of N values as a tree (depth log2 N, not N)
template <int N>
__device__ __forceinline__ float tree_max(const float* x) {
  if constexpr (N == 1) return x[0];
  else return fmaxf(tree_max<N / 2>(x), tree_max<N / 2>(x + N / 2));
}
template <int N>
__device__ __forceinline__ float tree_sum(const float* x) {
  if constexpr (N == 1) return x[0];
  else return tree_sum<N / 2>(x) + tree_sum<N / 2>(x + N / 2);
}

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A a0..a3: (row g, cols 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
//   B b0, b1: (rows 2t..2t+1, col g), (rows 2t+8..2t+9, col g)
//   C c0..c3: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
template <int DHP>
__global__ void __launch_bounds__(kThreads, Cfg<DHP>::kMinBlocks)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out,
                            int t_len, int heads, int dh, float scale) {
  using C = Cfg<DHP>;
  constexpr int P = C::kPitch;
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* ks = qs + C::kTile;          // 2 stages
  __nv_bfloat16* vs = ks + 2 * C::kTile;      // 2 stages

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - b * heads;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int q0 = qt * kRows;
  const size_t ld = static_cast<size_t>(heads) * dh;
  const size_t base = (static_cast<size_t>(b) * t_len * heads + h) * dh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nvec = dh >> 3;                   // 16-byte chunks of a row

  // Zero the pad columns [dh, DHP) of all five tiles; cp.async never writes them.
  const int npad = (DHP - dh) >> 3;
  for (int c = tid; c < 5 * kRows * npad; c += kThreads) {
    const int r = c / npad, x = c - r * npad;
    *reinterpret_cast<uint4*>(qs + r * P + dh + 8 * x) = make_uint4(0, 0, 0, 0);
  }

  // Rows row0..row0+63 of one (b, h) slice into a tile; rows past T are
  // zeros.  Thread tid copies chunks tid, tid + 128, ...: its (row, chunk)
  // steps by (dr, dx), so the loop divides nothing.
  const int r0 = tid / nvec, x0 = tid - r0 * nvec;
  const int dr = kThreads / nvec, dx = kThreads - dr * nvec;
  auto load_tile = [&](const __nv_bfloat16* src, int row0, __nv_bfloat16* dst) {
    for (int r = r0, x = x0; r < kRows;) {
      const int t = row0 + r;
      const bool valid = t < t_len;
      cp_async16(smem_addr(dst + r * P + 8 * x),
                 src + static_cast<size_t>(valid ? t : 0) * ld + 8 * x, valid);
      r += dr;
      x += dx;
      if (x >= nvec) { x -= nvec; ++r; }
    }
  };

  // cp.async groups, in order: (Q, K_0), V_0, then K_j, V_j for each later
  // tile, so that Q.K^T can start while V is still in flight
  load_tile(q + base, q0, qs);
  load_tile(k + base, 0, ks);
  cp_async_commit();
  load_tile(v + base, 0, vs);
  cp_async_commit();

  // Each lane's row and column in the ldmatrix address patterns:
  // Q (A, rows 0-15 x k 0-15): matrices (r0-7,k0-7) (r8-15,k0-7) (r0-7,k8-15) (r8-15,k8-15)
  const int a_row = 16 * warp + (lane & 15), a_col = 8 * (lane >> 4);
  // K (B of two n8 tiles, keys 0-15 x k 0-15): (n0-7,k0-7) (n0-7,k8-15) (n8-15,k0-7) (n8-15,k8-15)
  const int kb_row = (lane & 7) + 8 * (lane >> 4), kb_col = 8 * ((lane >> 3) & 1);
  // V (B of two n8 tiles, .trans, keys 0-15 x dims 0-15): (k0-7,n0-7) (k8-15,n0-7) (k0-7,n8-15) (k8-15,n8-15)
  const int vb_row = (lane & 7) + 8 * ((lane >> 3) & 1), vb_col = 8 * (lane >> 4);

  uint32_t qf[C::kQInRegs ? C::kKSteps : 1][4];
  float o[C::kNTiles][4];
#pragma unroll
  for (int n = 0; n < C::kNTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g and g + 8

  const int n_kt = qt + 1;                    // key tiles at or below the diagonal
  for (int j = 0; j < n_kt; ++j) {
    const int stage = j & 1;
    const bool more = j + 1 < n_kt;
    cp_async_wait<1>();           // K_j is in; only V_j may be pending
    __syncthreads();              // ... for every thread; and every warp is done
                                  // with tile j-1, so its stage can be refilled
    if (more) {                   // tile j+1 in flight while j computes
      load_tile(k + base, (j + 1) * kRows, ks + (stage ^ 1) * C::kTile);
      cp_async_commit();
      load_tile(v + base, (j + 1) * kRows, vs + (stage ^ 1) * C::kTile);
      cp_async_commit();
    }
    if constexpr (C::kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int s = 0; s < C::kKSteps; ++s)
          ldsm_x4(qf[s], smem_addr(qs + a_row * P + 16 * s + a_col));
      }
    }
    const __nv_bfloat16* kt_s = ks + stage * C::kTile;
    const __nv_bfloat16* vt_s = vs + stage * C::kTile;

    // One key tile.  On the diagonal (kDiag) the causal mask applies, and a
    // warp skips the 16-key blocks past its last row: their probabilities
    // are zero.  Below it, no key is masked and nothing is skipped.
    auto tile = [&](auto diag) {
      constexpr bool kDiag = decltype(diag)::value;
      // S = Q . K^T over the tile's 64 keys, float32
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk) {
        uint32_t a[4];
        if constexpr (C::kQInRegs) {
          a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
        } else {
          ldsm_x4(a, smem_addr(qs + a_row * P + 16 * kk + a_col));
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (!kDiag || p <= warp) {
            uint32_t bk[4];
            ldsm_x4(bk, smem_addr(kt_s + (16 * p + kb_row) * P + 16 * kk + kb_col));
            mma_bf16(s[2 * p], a, bk[0], bk[1]);
            mma_bf16(s[2 * p + 1], a, bk[2], bk[3]);
          }
        }
      }

      // scale in float32 after the product; on the diagonal, the causal mask
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= scale;
          if (kDiag && 8 * n + 2 * t4 + (e & 1) > 16 * warp + g + 8 * (e >> 1))
            s[n][e] = kNegInf;
        }
      }
      // online softmax in registers; a row's 4 lanes share its max
      float mx[2], alpha[2], rs[2];
      {
        float lo[16], hi[16];                 // rows g and g + 8
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          lo[2 * n] = s[n][0]; lo[2 * n + 1] = s[n][1];
          hi[2 * n] = s[n][2]; hi[2 * n + 1] = s[n][3];
        }
        mx[0] = tree_max<16>(lo);
        mx[1] = tree_max<16>(hi);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
      {
        float lo[16], hi[16];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - m[e >> 1]);
          lo[2 * n] = s[n][0]; lo[2 * n + 1] = s[n][1];
          hi[2 * n] = s[n][2]; hi[2 * n + 1] = s[n][3];
        }
        rs[0] = tree_sum<16>(lo);             // the unrounded p, as _attn_kernel
        rs[1] = tree_sum<16>(hi);
      }
      l[0] = l[0] * alpha[0] + rs[0];         // per lane; the quad adds up at the end
      l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
      for (int n = 0; n < C::kNTiles; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }

      if (more) cp_async_wait<2>(); // V_j is in; K_j+1 and V_j+1 may be pending
      else cp_async_wait<0>();
      __syncthreads();

      // O += P . V: two n8 tiles of S are one k16 A-fragment of P, in bf16.
      // All DHP/8 n-tiles: V's pad columns are zeros, and O's are not stored.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (!kDiag || kk <= warp) {
          const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                 pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                 pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                 pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int np = 0; np < C::kNTiles / 2; ++np) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, smem_addr(vt_s + (16 * kk + vb_row) * P + 16 * np + vb_col));
            mma_bf16(o[2 * np], a, bv[0], bv[1]);
            mma_bf16(o[2 * np + 1], a, bv[2], bv[3]);
          }
        }
      }
    };
    if (j == qt) tile(Bool<true>());
    else tile(Bool<false>());
  }

  // Epilogue: O / max(l, 1e-30), rounded once to bf16, staged in the warp's
  // own 16 rows of the Q tile (no other warp reads them), stored 16 B at a time.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r] + __shfl_xor_sync(kFullMask, l[r], 1);
    sum += __shfl_xor_sync(kFullMask, sum, 2);
    inv[r] = 1.f / fmaxf(sum, 1e-30f);
  }
  __nv_bfloat16* os = qs + 16 * warp * P;
#pragma unroll
  for (int n = 0; n < C::kNTiles; ++n) {
    if (n < nvec) {
      __nv_bfloat16* d = os + g * P + 8 * n + 2 * t4;
      *reinterpret_cast<uint32_t*>(d) = pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(d + 8 * P) = pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * nvec; c += 32) {
    const int r = c / nvec, x = c - r * nvec;
    const int t = q0 + 16 * warp + r;
    if (t < t_len)
      *reinterpret_cast<uint4*>(out + base + static_cast<size_t>(t) * ld + 8 * x) =
          *reinterpret_cast<const uint4*>(os + r * P + 8 * x);
  }
}

template <int DHP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int t_len, int heads, int dh, float scale,
                   void* stream) {
  static bool smem_set = false;
  if (!smem_set) {   // above 48 KB a block's shared memory must be asked for
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<DHP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<DHP>::kSmemBytes);
    if (err != cudaSuccess) return err;
    // all of the SM's shared memory, so that kMinBlocks blocks fit
    const cudaError_t err2 = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<DHP>,
        cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err2 != cudaSuccess) return err2;
    smem_set = true;
  }
  const dim3 grid(batch * heads, (t_len + kRows - 1) / kRows);
  flash_attention_bf16_kernel<DHP><<<grid, kThreads, Cfg<DHP>::kSmemBytes,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      t_len, heads, dh, scale);
  return cudaGetLastError();
}

// -- float32 instance: tensor cores in 3xTF32 --------------------------------

template <int DHP>
struct CfgF32 {
  static constexpr int kPitch = DHP + 4;              // floats per shared-memory row
  static constexpr int kKeys = DHP <= 72 ? 64 : 32;   // keys per K/V tile
  static constexpr int kQTile = kRows * kPitch;       // floats
  static constexpr int kKvTile = kKeys * kPitch;      // floats
  static constexpr int kStage = 2 * kKvTile;          // floats: K and V
  static constexpr int kSmemBytes = (kQTile + 2 * kStage) * 4;   // Q + 2 stages
  static constexpr int kMinBlocks = DHP <= 128 ? 2 : 1;          // an SM
  static constexpr int kKSteps = DHP / 8;             // k8 steps of Q.K^T
  static constexpr int kNTiles = DHP / 8;             // n8 tiles of P.V
  static constexpr int kSTiles = kKeys / 8;           // n8 tiles of S = k8 steps of P.V
  static constexpr bool kQInRegs = DHP <= 72;
};

// x = hi + lo in TF32, split as CUTLASS's OpMultiplyAddFastF32 splits it:
// hi is x rounded to the nearest TF32 (half an ulp added, the 13 low bits
// cleared: cvt.rna.tf32.f32's result for finite x, in two integer
// instructions where cvt takes more), and lo = x - hi exactly, whose 13
// low bits the tensor core ignores.  hi + lo keeps about 21 of float32's
// 24 significant bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: c += a * b to near float32 accuracy, as CUTLASS's
// OpMultiplyAddFastF32 orders it: the two small products first, then the
// big one (a_lo * b_lo is below float32's rounding and left out)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// Fragment layouts of mma.m16n8k8 with TF32 (g = lane / 4, t = lane % 4):
//   A a0..a3: (row g, col t), (g+8, t), (g, t+4), (g+8, t+4)
//   B b0, b1: (row t, col g), (row t+4, col g)
//   C c0..c3: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
// An 8x8 b16 ldmatrix gives lane l the 32-bit word l % 4 of row l / 4: one
// float of an 8-row x 4-float matrix at (row g, col t).  So Q's A-fragment
// and K's B-fragment (b0 = K[key g][dim t], b1 = K[key g][dim t+4]) load
// with ldmatrix.x4 as they do in bf16.
// P.V: unlike bf16's m16n8k16, the C layout of S is not the A layout of
// P.  P.V sums over keys, so the keys of each k8 step may be permuted: A
// column t stands for key 8j+2t and column t+4 for key 8j+2t+1.  Then the
// A-fragment of k8 step j is S's n8 tile j as (c0, c2, c1, c3), and V's
// B-fragment is read in the same order, b0 = V[8j+2t][n=g] and
// b1 = V[8j+2t+1][n=g], with plain 32-bit loads (no ldmatrix serves it).
template <int DHP>
__global__ void __launch_bounds__(kThreads, CfgF32<DHP>::kMinBlocks)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           int t_len, int heads, int dh, float scale) {
  using C = CfgF32<DHP>;
  constexpr int P = C::kPitch;
  constexpr int BK = C::kKeys;
  extern __shared__ uint4 smem_f32[];
  float* qs = reinterpret_cast<float*>(smem_f32);
  float* kv = qs + C::kQTile;                 // 2 stages of K and V

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - b * heads;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int q0 = qt * kRows;
  const size_t ld = static_cast<size_t>(heads) * dh;
  const size_t base = (static_cast<size_t>(b) * t_len * heads + h) * dh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nvec = dh >> 2;                   // 16-byte chunks of a row

  // Zero the pad columns [dh, DHP) of the Q tile and the four K/V tiles
  // (kRows + 4 BK rows of pitch P, one after the other); cp.async never
  // writes them.
  const int npad = (DHP - dh) >> 2;
  for (int c = tid; c < (kRows + 4 * BK) * npad; c += kThreads) {
    const int r = c / npad, x = c - r * npad;
    *reinterpret_cast<float4*>(qs + r * P + dh + 4 * x) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Rows row0..row0+rows-1 of one (b, h) slice into a tile; rows past T
  // are zeros.  Thread tid copies chunks tid, tid + 128, ... as in bf16.
  const int r0 = tid / nvec, x0 = tid - r0 * nvec;
  const int dr = kThreads / nvec, dx = kThreads - dr * nvec;
  auto load_tile = [&](const float* src, int row0, int rows, float* dst) {
    for (int r = r0, x = x0; r < rows;) {
      const int t = row0 + r;
      const bool valid = t < t_len;
      cp_async16(smem_addr(dst + r * P + 4 * x),
                 src + static_cast<size_t>(valid ? t : 0) * ld + 4 * x, valid);
      r += dr;
      x += dx;
      if (x >= nvec) { x -= nvec; ++r; }
    }
  };

  // cp.async groups, in order: (Q, K_0), V_0, then K_j, V_j for each later tile
  load_tile(q + base, q0, kRows, qs);
  load_tile(k + base, 0, BK, kv);
  cp_async_commit();
  load_tile(v + base, 0, BK, kv + C::kKvTile);
  cp_async_commit();

  // Each lane's row and column (in floats) in the ldmatrix address patterns:
  // Q (A, rows 0-15 x k 0-7): matrices (r0-7,k0-3) (r8-15,k0-3) (r0-7,k4-7) (r8-15,k4-7)
  const int a_row = 16 * warp + (lane & 15), a_col = 4 * (lane >> 4);
  // K (B of two n8 tiles, keys 0-15 x k 0-7): (n0-7,k0-3) (n0-7,k4-7) (n8-15,k0-3) (n8-15,k4-7)
  const int kb_row = (lane & 7) + 8 * (lane >> 4), kb_col = 4 * ((lane >> 3) & 1);

  // Q's A-fragment of k8 step kk, split into its TF32 parts
  auto q_frag = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    uint32_t r[4];
    ldsm_x4(r, smem_addr(qs + a_row * P + 8 * kk + a_col));
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), ah[e], al[e]);
  };

  constexpr int kQRegs = C::kQInRegs ? C::kKSteps : 1;
  uint32_t qh[kQRegs][4], ql[kQRegs][4];
  float o[C::kNTiles][4];
#pragma unroll
  for (int n = 0; n < C::kNTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g and g + 8

  const int n_kt = (q0 + kRows) / BK;         // key tiles at or below the diagonal
  for (int j = 0; j < n_kt; ++j) {
    const int stage = j & 1;
    const bool more = j + 1 < n_kt;
    const float* kt_s = kv + stage * C::kStage;
    const float* vt_s = kt_s + C::kKvTile;
    cp_async_wait<1>();           // K_j is in; only V_j may be pending
    __syncthreads();              // ... for every thread; and every warp is done
                                  // with tile j-1, so its stage can be refilled
    if (more) {                   // tile j+1 in flight while j computes
      float* next = kv + (stage ^ 1) * C::kStage;
      load_tile(k + base, (j + 1) * BK, BK, next);
      cp_async_commit();
      load_tile(v + base, (j + 1) * BK, BK, next + C::kKvTile);
      cp_async_commit();
    }
    if constexpr (C::kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < C::kKSteps; ++kk) q_frag(kk, qh[kk], ql[kk]);
      }
    }
    // the warp's first query row, counted from the tile's first key
    const int dq = q0 + 16 * warp - j * BK;

    // One key tile.  On the diagonal (kDiag: a key of the tile lies past a
    // query row of the block) the causal mask applies, and a warp skips
    // the key blocks past its last row, dq + 15: their probabilities are
    // zero.  Below it, no key is masked and nothing is skipped.
    auto tile = [&](auto diag) {
      constexpr bool kDiag = decltype(diag)::value;
      // S = Q . K^T over the tile's BK keys, float32
      float s[C::kSTiles][4];
#pragma unroll
      for (int n = 0; n < C::kSTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk) {
        uint32_t ah[4], al[4];
        if constexpr (C::kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) { ah[e] = qh[kk][e]; al[e] = ql[kk][e]; }
        } else {
          q_frag(kk, ah, al);
        }
#pragma unroll
        for (int p = 0; p < C::kSTiles / 2; ++p) {
          if (!kDiag || 16 * p <= dq + 15) {
            uint32_t r[4], bh[4], bl[4];
            ldsm_x4(r, smem_addr(kt_s + (16 * p + kb_row) * P + 8 * kk + kb_col));
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), bh[e], bl[e]);
            mma_3xtf32(s[2 * p], ah, al, {bh[0], bh[1]}, {bl[0], bl[1]});
            mma_3xtf32(s[2 * p + 1], ah, al, {bh[2], bh[3]}, {bl[2], bl[3]});
          }
        }
      }

      // scale in float32 after the product; on the diagonal, the causal mask
#pragma unroll
      for (int n = 0; n < C::kSTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= scale;
          if (kDiag && 8 * n + 2 * t4 + (e & 1) > dq + g + 8 * (e >> 1))
            s[n][e] = kNegInf;
        }
      }
      // online softmax in registers; a row's 4 lanes share its max
      constexpr int kPerRow = 2 * C::kSTiles;
      float mx[2], alpha[2], rs[2];
      {
        float lo[kPerRow], hi[kPerRow];       // rows g and g + 8
#pragma unroll
        for (int n = 0; n < C::kSTiles; ++n) {
          lo[2 * n] = s[n][0]; lo[2 * n + 1] = s[n][1];
          hi[2 * n] = s[n][2]; hi[2 * n + 1] = s[n][3];
        }
        mx[0] = tree_max<kPerRow>(lo);
        mx[1] = tree_max<kPerRow>(hi);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
      {
        float lo[kPerRow], hi[kPerRow];
#pragma unroll
        for (int n = 0; n < C::kSTiles; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - m[e >> 1]);
          lo[2 * n] = s[n][0]; lo[2 * n + 1] = s[n][1];
          hi[2 * n] = s[n][2]; hi[2 * n + 1] = s[n][3];
        }
        rs[0] = tree_sum<kPerRow>(lo);
        rs[1] = tree_sum<kPerRow>(hi);
      }
      l[0] = l[0] * alpha[0] + rs[0];         // per lane; the quad adds up at the end
      l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
      for (int n = 0; n < C::kNTiles; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }

      if (more) cp_async_wait<2>(); // V_j is in; K_j+1 and V_j+1 may be pending
      else cp_async_wait<0>();
      __syncthreads();

      // O += P . V in 3xTF32, the keys of each k8 step permuted (above).
      // All DHP/8 n-tiles: V's pad columns are zeros, and O's are not stored.
#pragma unroll
      for (int kk = 0; kk < C::kSTiles; ++kk) {
        if (!kDiag || 8 * kk <= dq + 15) {
          uint32_t ah[4], al[4];
          split_tf32(s[kk][0], ah[0], al[0]);
          split_tf32(s[kk][2], ah[1], al[1]);
          split_tf32(s[kk][1], ah[2], al[2]);
          split_tf32(s[kk][3], ah[3], al[3]);
          const float* v0 = vt_s + (8 * kk + 2 * t4) * P + g;
#pragma unroll
          for (int n = 0; n < C::kNTiles; ++n) {
            uint32_t bh[2], bl[2];
            split_tf32(v0[8 * n], bh[0], bl[0]);
            split_tf32(v0[P + 8 * n], bh[1], bl[1]);
            mma_3xtf32(o[n], ah, al, bh, bl);
          }
        }
      }
    };
    if (q0 - j * BK >= BK) tile(Bool<false>());   // every key <= the block's first row
    else tile(Bool<true>());
  }

  // Epilogue: O / max(l, 1e-30), staged in the warp's own 16 rows of the Q
  // tile (no other warp reads them), stored 16 B at a time.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r] + __shfl_xor_sync(kFullMask, l[r], 1);
    sum += __shfl_xor_sync(kFullMask, sum, 2);
    inv[r] = 1.f / fmaxf(sum, 1e-30f);
  }
  float* os = qs + 16 * warp * P;
#pragma unroll
  for (int n = 0; n < C::kNTiles; ++n) {
    if (8 * n < dh) {
      float* d = os + g * P + 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(d) = make_float2(o[n][0] * inv[0], o[n][1] * inv[0]);
      *reinterpret_cast<float2*>(d + 8 * P) = make_float2(o[n][2] * inv[1], o[n][3] * inv[1]);
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * nvec; c += 32) {
    const int r = c / nvec, x = c - r * nvec;
    const int t = q0 + 16 * warp + r;
    if (t < t_len)
      *reinterpret_cast<float4*>(out + base + static_cast<size_t>(t) * ld + 4 * x) =
          *reinterpret_cast<const float4*>(os + r * P + 4 * x);
  }
}

template <int DHP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int batch, int t_len, int heads, int dh, float scale,
                       void* stream) {
  static bool smem_set = false;
  if (!smem_set) {   // above 48 KB a block's shared memory must be asked for
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<DHP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, CfgF32<DHP>::kSmemBytes);
    if (err != cudaSuccess) return err;
    // all of the SM's shared memory, so that kMinBlocks blocks fit
    const cudaError_t err2 = cudaFuncSetAttribute(
        flash_attention_f32_kernel<DHP>,
        cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err2 != cudaSuccess) return err2;
    smem_set = true;
  }
  const dim3 grid(batch * heads, (t_len + kRows - 1) / kRows);
  flash_attention_f32_kernel<DHP><<<grid, kThreads, CfgF32<DHP>::kSmemBytes,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), t_len, heads, dh, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// q, k, v, out: [batch, t_len, heads, dh], contiguous, on the current
// device, 16-byte aligned.  Requires batch*heads > 0, t_len > 0 and
// 0 < dh <= 256 with dh * sizeof(element) a multiple of 16.  `scale`
// multiplies the float32 scores (the caller passes 1/sqrt(real Dh)).  Runs
// on `stream`; does not synchronise.  Returns the launch's error code.
cudaError_t sc_flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int batch, int t_len, int heads,
                                   int dh, float scale, void* stream) {
  if (dh <= 0 || dh % 4) return cudaErrorInvalidValue;
  if (dh <= 64) return tc::launch_f32<64>(q, k, v, out, batch, t_len, heads, dh, scale, stream);
  if (dh <= 72) return tc::launch_f32<72>(q, k, v, out, batch, t_len, heads, dh, scale, stream);
  if (dh <= 128) return tc::launch_f32<128>(q, k, v, out, batch, t_len, heads, dh, scale, stream);
  if (dh <= 256) return tc::launch_f32<256>(q, k, v, out, batch, t_len, heads, dh, scale, stream);
  return cudaErrorInvalidValue;
}

cudaError_t sc_flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, int batch, int t_len, int heads,
                                    int dh, float scale, void* stream) {
  if (dh <= 0 || dh % 8) return cudaErrorInvalidValue;
  if (dh <= 64) return tc::launch<64>(q, k, v, out, batch, t_len, heads, dh, scale, stream);
  if (dh <= 80) return tc::launch<80>(q, k, v, out, batch, t_len, heads, dh, scale, stream);
  if (dh <= 128) return tc::launch<128>(q, k, v, out, batch, t_len, heads, dh, scale, stream);
  if (dh <= 256) return tc::launch<256>(q, k, v, out, batch, t_len, heads, dh, scale, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
