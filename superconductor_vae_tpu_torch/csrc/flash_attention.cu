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
// H=8, Dh=72 in float32 that is 75.5 MB / 22.5 us against 1.22 GFLOP /
// 18.2 us at 67 TFLOP/s for T=128 (bytes bound), and 151 MB / 45.1 us
// against 4.85 GFLOP / 72.4 us for T=256 (bound by the float32 rate).  In
// bfloat16 the bytes halve (37.7 MB / 11.3 us at T=128, 75.5 MB / 22.5 us
// at T=256) and bound both: at 989 TFLOP/s on the tensor cores the FLOPs
// take 1.2 and 4.9 us.  The work has T/4 FLOPs per byte, 32-64 here,
// far below the card's ridge of ~295, so a kernel that keeps the tensor
// cores fed and overlaps its loads lands near the byte bound; mma.sync is
// enough for that, and wgmma/TMA pay only at T in the thousands.
//
// float32 instance (flash_attention_kernel, a plain SIMT kernel, Dh <= 128):
//   - one block of 256 threads per (b*h, 64-query tile), the tiles with the
//     most key tiles launched first;
//   - Q, K and V tiles of 64 rows are staged in shared memory as float32,
//     read straight from the [B, T, H, Dh] layout (row stride H*Dh) with
//     16-byte loads, rows past T filled with zeros; row pitch Dh + 4
//     floats keeps the 16-byte reads free of bank conflicts;
//   - thread (rg, cg) = (tid / 16, tid % 16) owns query rows 4rg..4rg+3
//     and, for the scores, keys cg + 16j (j < 4); the 16 lanes of a row
//     group reduce the row max by shuffles; the row sums stay per lane
//     until the end;
//   - P goes to shared memory transposed ([key][row]), so the P.V product
//     reads four rows' probabilities as one 16-byte word; each thread
//     accumulates its 4 rows x output chunks cg and cg + 16 (4 channels
//     each) in registers;
//   - key tiles wholly above the diagonal are skipped (masked anyway), and
//     the P.V loop stops at the last key any row of the tile can see.
//
// bfloat16 instance (tc::flash_attention_bf16_kernel, tensor cores, any Dh
// that is a multiple of 8 up to 256), flash-attention-2 style:
//   - one block of 4 warps per (b*h, 64-query tile), heaviest tiles first;
//     warp w owns query rows 16w..16w+15 of the tile;
//   - Dh is padded in shared memory only, to DHP = 64, 80, 128 or 256 (a
//     template parameter; 72 pads to 80).  The pad columns are zeroed once
//     and nothing padded is read from or written to device memory;
//   - the Q tile is loaded once with cp.async (16 B, src-size 0 zero-fills
//     rows past T); 64-key K/V tiles go through a two-stage cp.async ring,
//     tile j+1 in flight while tile j is computed, K and V in separate
//     commit groups so that Q.K^T starts before V has landed; key tiles
//     wholly above the diagonal are never loaded.  Row pitch DHP + 8 bf16
//     (176 B at DHP 80) puts the 8 rows of each ldmatrix on distinct banks;
//   - S = Q.K^T with mma.sync m16n8k16 (bf16 in, float32 accumulators):
//     Q as A-fragments by ldmatrix.x4 (kept in registers for DHP <= 128,
//     re-read per k-step at 256), K as B-fragments by ldmatrix.x4 straight
//     from its row-major tile; then * scale in float32 and, on the
//     diagonal tile only, the causal mask;
//   - the online softmax runs in registers: each thread holds 2 rows of
//     the fragment, row max and sum reduced as trees and over the 4-lane
//     quad with shuffles;
//   - P.V without shared memory: the S accumulators of two n8 tiles are
//     exactly the A-fragment of one k16 step (m16n8 C layout = m16k16 A
//     layout), so P is rounded to bf16 in registers; V is read as
//     B-fragments by ldmatrix.x4.trans;
//   - the epilogue divides by max(l, 1e-30) (one reciprocal a row), rounds
//     once to bf16, stages the warp's 16 rows in its own rows of the Q tile
//     and stores the real Dh columns of rows < T with 16-byte stores.
// What measurement on the H100 decided (chip_smoke.py times the result):
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

// Built with nvcc into a plain-C shared library and called through ctypes
// (ops/fused_attention.py); the launchers return the launch's cudaError_t.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kThreads = 256;
constexpr int kMaxDh = 128;
constexpr int kLdp = kBQ + 4;           // pitch of the transposed P tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int smem_floats(int dh) {
  return (kBQ + 2 * kBK) * (dh + 4) + kBK * kLdp;
}

// Rows row0..row0+63 of one (b, h) slice into shared memory as float32.
// `src` points at element (b, 0, h, 0); rows are `ld` elements apart.
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int row0, int t_len, size_t ld,
                                          int dh, float* __restrict__ dst) {
  const int nvec = dh >> 2;
  const int lds = dh + 4;
  for (int c = threadIdx.x; c < kBQ * nvec; c += kThreads) {
    const int r = c / nvec, v = c - r * nvec;
    const int t = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < t_len) x = *reinterpret_cast<const float4*>(src + t * ld + 4 * v);
    *reinterpret_cast<float4*>(dst + r * lds + 4 * v) = x;
  }
}

// The probability as the P.V product sees it (the float32 instance's
// counterpart of the TPU kernel's p.astype(v.dtype)).
__device__ __forceinline__ float p_for_pv(float p, float) { return p; }

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void fma4(float4& acc, float p, float4 v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int t_len, int heads, int dh, float scale) {
  extern __shared__ float4 smem4[];
  const int lds = dh + 4;
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * lds;
  float* vs = ks + kBK * lds;
  float* ps = vs + kBK * lds;                 // [kBK][kLdp]: P transposed

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest tiles first
  const size_t ld = static_cast<size_t>(heads) * dh;
  const size_t base = (static_cast<size_t>(b) * t_len * heads + h) * dh;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int nchunk = dh >> 2;                 // 4-channel output chunks

  load_tile(q + base, q0, t_len, ld, dh, qs);

  float m[4], l[4];
  float4 acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int q_last = min(q0 + kBQ, t_len) - 1;  // last real query of the tile
  const int n_kt = q_last / kBK + 1;            // key tiles at or below the diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();            // the last tile's P.V is done with ks, vs, ps
    load_tile(k + base, k0, t_len, ld, dh, ks);
    load_tile(v + base, k0, t_len, ld, dh, vs);
    __syncthreads();

    // scores s[i][j] = q[4rg+i] . k[cg+16j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int d = 0; d < dh; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * rg + i) * lds + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (cg + 16 * j) * lds + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // online softmax per row; the 16 lanes of a row group share the max
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * rg + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg + 16 * j;
        s[i][j] = (kpos <= qpos) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store4(ps + (cg + 16 * j) * kLdp + 4 * rg,
             make_float4(p_for_pv(s[0][j], T()), p_for_pv(s[1][j], T()),
                         p_for_pv(s[2][j], T()), p_for_pv(s[3][j], T())));
    __syncthreads();

    // acc[i][c] += sum_u p[4rg+i][u] v[u][4(cg+16c) .. +3]
    const int u_end = min(kBK, q_last + 1 - k0);
    for (int u = 0; u < u_end; ++u) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + u * kLdp + 4 * rg);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int chunk = cg + 16 * c;
        if (chunk < nchunk) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + u * lds + 4 * chunk);
          fma4(acc[0][c], p4.x, vv);
          fma4(acc[1][c], p4.y, vv);
          fma4(acc[2][c], p4.z, vv);
          fma4(acc[3][c], p4.w, vv);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lsum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(kFullMask, lsum, off);
    const float denom = fmaxf(lsum, 1e-30f);
    const int row = q0 + 4 * rg + i;
    if (row >= t_len) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = cg + 16 * c;
      if (chunk < nchunk) {
        const float4 a = acc[i][c];
        store4(out + base + row * ld + 4 * chunk,
               make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int t_len, int heads, int dh, float scale,
                   void* stream) {
  static bool smem_set = false;
  if (!smem_set) {   // above 48 KB a block's shared memory must be asked for
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(kMaxDh) * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(batch * heads, (t_len + kBQ - 1) / kBQ);
  const size_t smem = smem_floats(dh) * sizeof(float);
  flash_attention_kernel<T><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), t_len, heads, dh, scale);
  return cudaGetLastError();
}

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

}  // namespace tc

}  // namespace

extern "C" {

// q, k, v, out: [batch, t_len, heads, dh], contiguous, on the current
// device, 16-byte aligned.  Requires batch*heads > 0, t_len > 0 and
// dh * sizeof(element) a multiple of 16, with dh <= 128 in float32 and
// dh <= 256 in bfloat16.  Runs on `stream`; does not synchronise.  Returns
// the launch's error code.
cudaError_t sc_flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int batch, int t_len, int heads,
                                   int dh, float scale, void* stream) {
  return launch<float>(q, k, v, out, batch, t_len, heads, dh, scale, stream);
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
