// Decode-step self-attention with an in-place KV-cache row write (kernel K1).
//
// Replaces the TPU kernel superconductor_vae_tpu/ops/pallas_decode.py
// decode_step_attention (body _decode_kernel).  For every (batch row b,
// head h) it
//   1. writes k_new[b,h,:] and v_new[b,h,:] into row `pos` of the
//      [B, H, T, Dh] caches, IN PLACE;
//   2. attends the single query q[b,h,:] over cache slots 0..pos:
//      scores scaled by 1/sqrt(Dh) (the real Dh), softmax over the slots,
//      weighted sum of the V rows, all accumulated in float32;
//   3. writes out[b,h,:] in the input dtype (float32 or bfloat16).
//
// Bound on an H100 SXM: the bytes.  The call reads the K and V slots
// 0..pos-1 once, the three [B,H,Dh] rows once, and writes the output and
// the two cache rows once: at B=256, H=8, Dh=72, pos=29, float32 about
// 37.7 MB, 11.3 us at 3.35 TB/s (2*B*H*30*Dh*4 B = 35.4 MB, 10.6 us, if
// all 30 slots are counted).  Its 17.7 MFLOP take 0.26 us at 67 TFLOP/s.
// A greedy rollout at max_len 30 launches it once per layer and step:
// 12 * 29 = 348 launches per batch at most.
//
// Design: one warp per (b, h), four warps per block.  T <= 32, so lane t
// owns cache slot t: it forms the 72-wide dot product q.K[t] from 16-byte
// loads, the warp takes max and sum by shuffles, and the probabilities are
// broadcast by shuffle while each lane accumulates output channels lane,
// lane+32 and lane+64 from coalesced reads of the V rows.  Slot `pos` is
// read from k_new/v_new, never from the cache row being written, so the
// write and the reads of one warp touch different addresses.
//
// Built with nvcc into a plain-C shared library and called through ctypes
// (ops/decode_attention.py); the launchers return the launch's cudaError_t.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxChunks = 4;          // Dh <= 128: channels lane + 32*j
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// q . k over one row of Dh elements, in float32, from 16-byte loads.
// Dh * sizeof(T) is a multiple of 16 and both rows are 16-byte aligned
// (checked by the wrapper).
template <typename T>
__device__ __forceinline__ float dot_row(const T* __restrict__ a,
                                         const T* __restrict__ b, int dh) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  float acc = 0.f;
  for (int i = 0; i < dh / kVec; ++i) {
    const uint4 va = a4[i];
    const uint4 vb = b4[i];
    const T* ea = reinterpret_cast<const T*>(&va);
    const T* eb = reinterpret_cast<const T*>(&vb);
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc = fmaf(to_f32(ea[j]), to_f32(eb[j]), acc);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, T* __restrict__ k_cache,
                        T* __restrict__ v_cache, T* __restrict__ out,
                        int bh_total, int t_cap, int dh, int pos, float scale) {
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bh >= bh_total) return;  // the whole warp leaves together

  const size_t row = static_cast<size_t>(bh) * dh;
  const T* qr = q + row;
  const T* knr = k_new + row;
  const T* vnr = v_new + row;
  T* kc = k_cache + static_cast<size_t>(bh) * t_cap * dh;
  T* vc = v_cache + static_cast<size_t>(bh) * t_cap * dh;

  // 1. the new K/V row at `pos`, coalesced over the lanes
  for (int c = lane; c < dh; c += 32) {
    kc[static_cast<size_t>(pos) * dh + c] = knr[c];
    vc[static_cast<size_t>(pos) * dh + c] = vnr[c];
  }

  // 2. scores: lane t owns slot t (t <= pos < t_cap <= 32)
  const int t = lane;
  float s = -1e30f;
  if (t <= pos) {
    const T* krow = (t == pos) ? knr : kc + static_cast<size_t>(t) * dh;
    s = dot_row(qr, krow, dh) * scale;
  }
  float m = s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
  float p = (t <= pos) ? expf(s - m) : 0.f;
  float l = p;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(kFullMask, l, off);
  p = p / l;

  // 3. out = sum_u p_u V[u], channels lane + 32*j
  float acc[kMaxChunks];
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) acc[j] = 0.f;
  for (int u = 0; u <= pos; ++u) {
    const float pu = __shfl_sync(kFullMask, p, u);
    const T* vrow = (u == pos) ? vnr : vc + static_cast<size_t>(u) * dh;
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = lane + 32 * j;
      if (c < dh) acc[j] = fmaf(pu, to_f32(vrow[c]), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int c = lane + 32 * j;
    if (c < dh) out[row + c] = from_f32<T>(acc[j]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_cache, void* v_cache, void* out, int batch,
                   int heads, int t_cap, int dh, int pos, float scale,
                   void* stream) {
  const int bh_total = batch * heads;
  const int blocks = (bh_total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  decode_attention_kernel<T><<<blocks, kWarpsPerBlock * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_cache),
      static_cast<T*>(v_cache), static_cast<T*>(out), bh_total, t_cap, dh,
      pos, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k_new, v_new, out: [batch, heads, dh]; k_cache, v_cache:
// [batch, heads, t_cap, dh], all contiguous, on the current device.
// Requires batch*heads > 0, t_cap <= 32, 0 <= pos < t_cap, dh <= 128 and
// dh * sizeof(element) a multiple of 16.  Runs on `stream`; does not
// synchronise.  Returns the launch's error code.
cudaError_t sc_decode_attention_f32(const void* q, const void* k_new,
                                    const void* v_new, void* k_cache,
                                    void* v_cache, void* out, int batch,
                                    int heads, int t_cap, int dh, int pos,
                                    float scale, void* stream) {
  return launch<float>(q, k_new, v_new, k_cache, v_cache, out, batch, heads,
                       t_cap, dh, pos, scale, stream);
}

cudaError_t sc_decode_attention_bf16(const void* q, const void* k_new,
                                     const void* v_new, void* k_cache,
                                     void* v_cache, void* out, int batch,
                                     int heads, int t_cap, int dh, int pos,
                                     float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, out, batch,
                               heads, t_cap, dh, pos, scale, stream);
}

}  // extern "C"
