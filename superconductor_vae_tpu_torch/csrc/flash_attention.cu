// Causal flash-attention forward over [B, T, H, Dh] (kernel K2).
//
// Replaces the TPU kernel superconductor_vae_tpu/ops/pallas_attention.py
// pallas_attention (body _attn_kernel).  For every (batch row b, head h)
// and query t it computes
//     out[b,t,h,:] = sum_{u <= t} softmax_u(q[b,t,h,:] . k[b,u,h,:] * scale) v[b,u,h,:]
// with an online softmax over key tiles, float32 running max / sum /
// accumulator, masked scores -1e30, and a final division by max(l, 1e-30),
// as the TPU kernel does.  Like it, the predicate is always causal.  The
// scale is 1/sqrt(real Dh), given by the caller.  In bfloat16 the
// probabilities are rounded to bfloat16 before the P.V product, as the TPU
// kernel's p.astype(v.dtype) does; all sums stay float32.
//
// Bound on an H100 SXM: q, k, v read once and out written once,
// 4 * B*T*H*Dh elements; 4 * Dh * B*H * T(T+1)/2 causal FLOPs.  At B=64,
// H=8, Dh=72 in float32 that is 75.5 MB / 22.5 us against 1.22 GFLOP /
// 18.2 us at 67 TFLOP/s for T=128 (bytes bound), and 151 MB / 45.1 us
// against 4.85 GFLOP / 72.4 us for T=256 (bound by the float32 rate).  In
// bfloat16 the bytes halve and bound both (tensor-core rate 989 TFLOP/s).
//
// Design (a plain SIMT kernel; wgmma and TMA are later work):
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

__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          int row0, int t_len, size_t ld,
                                          int dh, float* __restrict__ dst) {
  const int nvec = dh >> 3;
  const int lds = dh + 4;
  for (int c = threadIdx.x; c < kBQ * nvec; c += kThreads) {
    const int r = c / nvec, v = c - r * nvec;
    const int t = row0 + r;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (t < t_len) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + t * ld + 8 * v);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
      const float2 c2 = __bfloat1622float2(p[2]), d = __bfloat1622float2(p[3]);
      lo = make_float4(a.x, a.y, b.x, b.y);
      hi = make_float4(c2.x, c2.y, d.x, d.y);
    }
    float* o = dst + r * lds + 8 * v;
    *reinterpret_cast<float4*>(o) = lo;
    *reinterpret_cast<float4*>(o + 4) = hi;
  }
}

// The probability as the P.V product sees it: float32, or rounded to
// bfloat16 as the TPU kernel's p.astype(v.dtype).
__device__ __forceinline__ float p_for_pv(float p, float) { return p; }
__device__ __forceinline__ float p_for_pv(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = w;
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

}  // namespace

extern "C" {

// q, k, v, out: [batch, t_len, heads, dh], contiguous, on the current
// device, 16-byte aligned.  Requires batch*heads > 0, t_len > 0,
// dh <= 128 and dh * sizeof(element) a multiple of 16.  Runs on `stream`;
// does not synchronise.  Returns the launch's error code.
cudaError_t sc_flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int batch, int t_len, int heads,
                                   int dh, float scale, void* stream) {
  return launch<float>(q, k, v, out, batch, t_len, heads, dh, scale, stream);
}

cudaError_t sc_flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, int batch, int t_len, int heads,
                                    int dh, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, batch, t_len, heads, dh, scale,
                               stream);
}

}  // extern "C"
