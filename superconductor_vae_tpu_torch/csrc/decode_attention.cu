// Decode-step self-attention with an in-place KV-cache row write (kernel K1).
//
// Replaces the TPU kernel superconductor_vae_tpu/ops/pallas_decode.py
// decode_step_attention (body _decode_kernel).  For every (batch row b,
// head h) it
//   1. writes k_new[b,h,:] and v_new[b,h,:] into row `pos` of the
//      [B, H, T, Dh] caches, IN PLACE;
//   2. attends the single query q[b,h,:] over cache slots 0..pos: scores
//      q.K[t] in float32 times the caller's scale (1/sqrt(real Dh)), masked
//      softmax over the slots (expf, one division), the weighted sum of the
//      V rows accumulated in float32;
//   3. writes out[b,h,:] in the input dtype (float32 or bfloat16).
// Any T, any 0 <= pos < T, Dh up to 256.
//
// Bound on an H100 SXM: the bytes.  The call reads the K and V slots
// 0..pos-1 once, the three [B,H,Dh] rows once, and writes the output and
// the two cache rows once: at B=256, H=8, Dh=72, pos=29 in float32 that is
// 37.7 MB, 11.3 us at 3.35 TB/s (bfloat16: 18.9 MB, 5.6 us).  Its 17.7
// MFLOP take 0.26 us at 67 TFLOP/s, and one query row per (b, h) gives the
// tensor cores nothing to do.  A greedy rollout at max_len 30 launches it
// once per layer and step: 12 * 29 = 348 launches per batch.
//
// Design, for the memory system: the slots 0..pos-1 of one (b, h) are one
// contiguous run of pos * Dh elements in each cache, and the kernel streams
// them in with 16-byte cp.async, every request of a work unit sent before
// any is used, while the unit before it is computed.
//   - Work units: a (b, h) row's slots in tiles of up to 32 (T=30 is one
//     tile), with an online softmax across tiles (running max, sum and
//     accumulator, as K2 over key tiles).
//   - Persistent blocks of 4 warps: as many as fit on the card (occupancy
//     calculator), block i takes the row groups i, i + gridDim, ...  Each
//     warp takes 8 slots of every tile of its row on its own: it fetches
//     its K and V rows and its copy of q into its own ring of two stages,
//     one unit ahead (cp.async groups), scores them, keeps its own online
//     softmax, and waits for no other warp until a group's last tile,
//     where each row's warps' (max, sum, accumulator) are combined through
//     shared memory and divided.  A row takes the fewest warps (1, 2 or 4)
//     whose 8 slots cover pos + 1, and a block that many rows at once, so
//     that at the first positions of a rollout no warp idles.  Row `pos`
//     comes from k_new / v_new, never from the cache row being written: no
//     stage holds a half-written row, and the warp whose slots hold it
//     writes it into both caches from its stage at the end.
//   - Row chunks: 16 bytes (4 floats, 8 bfloat16), Dh instantiated on a
//     padded width DHP (float32 64, 72, 128, 256, so run4's 72 runs
//     unpadded; bfloat16 64, 80, 128, 256), so that every loop over a row
//     unrolls; nothing padded is read or written.  A Dh that is not a whole
//     number of 16-byte chunks runs in an instance with one-element chunks
//     (4-byte cp.async in float32, 2-byte loads in bfloat16) at DHP 256.
//   - q.K: four lanes a slot (lanes s, s+8, s+16, s+24), each over every
//     fourth chunk of the row, reduced by two shuffles; the K rows' pitch
//     is an odd number of chunks, so the eight slots that a quarter warp
//     reads lie in eight bank groups.  Max and sum over a warp's eight
//     slots by three shuffles each.
//   - P.V without a serial chain: lanes own a row's chunks (V rows
//     unpadded, so a warp's reads are consecutive) and add the warp's
//     eight slots, each probability taken by one shuffle.
//   - Each width has two instances: one whose warps all take one row
//     (pos >= 16 at four warps), where the compiler knows the split, and
//     one that works the split out at run time.
// What measurement decided (superconductor_vae_tpu_torch/tools/
// k1_variants.py, NVIDIA H100 80GB HBM3 at 700 W, B=256 and B=1024): one
// block per row group instead of persistent blocks, three stages, 64 or
// 256 threads a block, other register caps, and a fetch that walks each
// lane through the slice in order were each as fast or slower; four warps
// a row at every position was as fast from position 16 and 1.5 times as
// slow at position 3.  The fetches alone run at about 2.9 TB/s; the launch,
// the output and cache-row writes and the arithmetic take the rest
// (PERF.md).
//
// Built with nvcc into a plain-C shared library and called through ctypes
// (ops/decode_attention.py); the launchers return the launch's cudaError_t.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;          // a block
constexpr int kWarps = kThreads / 32;
constexpr int kLogWarps = kWarps >= 8 ? 3 : kWarps >= 4 ? 2 : kWarps >= 2 ? 1 : 0;
constexpr int kParts = 4;              // lanes per slot in q.K
constexpr int kWarpSlots = 32 / kParts;  // slots a warp scores at once
constexpr int kStages = 2;             // work units in flight a warp
constexpr int kMinBlocks = 4;          // resident blocks an SM asked of the compiler
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNegInf = -1e30f;      // the masked score of the TPU kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A chunk of E elements of type T, moved as one load: 16, 4 or 2 bytes.
template <typename T, int E>
using Chunk = std::conditional_t<
    sizeof(T) * E == 16, uint4,
    std::conditional_t<sizeof(T) * E == 4, uint32_t, uint16_t>>;

// (by value: one load of the whole chunk, then register moves)
template <typename T, int E, typename R>
__device__ __forceinline__ void unpack(const R raw, float (&f)[E]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < E; ++i) f[i] = to_f32(e[i]);
}

template <typename T, int E, typename R>
__device__ __forceinline__ R pack(const float (&f)[E]) {
  R raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < E; ++i) e[i] = from_f32<T>(f[i]);
  return raw;
}

// One chunk global -> shared: cp.async for 16 bytes (bypassing L1) and 4
// bytes; a 2-byte chunk, which cp.async cannot move, by load and store.
template <typename R>
__device__ __forceinline__ void fetch(R* dst, const R* src) {
  if constexpr (sizeof(R) == 2) {
    *dst = *src;
  } else {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if constexpr (sizeof(R) == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// T elements, E a chunk, NVP chunks a padded row (the real row has nv <= NVP).
template <typename T, int E, int NVP>
struct Cfg {
  using Raw = Chunk<T, E>;
  static constexpr int kKPitch = NVP | 1;                  // chunks; odd
  static constexpr int kQBytes = (NVP * static_cast<int>(sizeof(Raw)) + 15) & ~15;
  static constexpr int kKBytes = (kWarpSlots * kKPitch * static_cast<int>(sizeof(Raw)) + 15) & ~15;
  static constexpr int kVBytes = (kWarpSlots * NVP * static_cast<int>(sizeof(Raw)) + 15) & ~15;
  // a warp's stage: its copy of q, its slots' K rows, then their V rows
  static constexpr int kStageBytes = kQBytes + kKBytes + kVBytes;
  static constexpr int kQChunks = (NVP + kParts - 1) / kParts;  // a lane's share of q.K
  static constexpr int kLaneChunks = (NVP + 31) / 32;  // a row's chunks a lane fetches and sums
  // the warps' partial results of one group: acc [kWarps][NVP][E], then m, l
  static constexpr int kCombBytes = kWarps * (NVP * E + 2) * 4;
  static constexpr int kSmemBytes = kStages * kWarps * kStageBytes + kCombBytes;
};

// How a block's warps share the (b, h) rows at position pos: 2^shift
// warps a row, each with kWarpSlots slots of a tile of `width` slots, so
// `rows` rows at once; the fewest warps whose slots cover pos + 1, so that
// at a short cache no warp idles.  kFull: all the block's warps on one row,
// which the compiler then knows (an instance of its own, for pos >= 16).
template <bool kFull>
struct Split {
  int shift, rows, width;
  __host__ __device__ explicit Split(int pos) : shift(kFull ? kLogWarps : 0) {
    if (!kFull)
      while ((1 << shift) < kWarps && (kWarpSlots << shift) <= pos) ++shift;
    rows = kWarps >> shift;
    width = kWarpSlots << shift;
  }
};

// What a work unit (tile `tile` of the block's k-th group of sp.rows rows)
// gives this warp: its (b, h) row, its first slot, and its count of slots
// <= pos (none past the last row, or past pos).
struct Unit {
  size_t bh;
  int t0, rows;
  template <class S>
  __device__ __forceinline__ Unit(int k, int tile, const S& sp, int bh_total, int pos) {
    const int warp = threadIdx.x >> 5;
    bh = (blockIdx.x + static_cast<size_t>(k) * gridDim.x) * sp.rows + (warp >> sp.shift);
    t0 = tile * sp.width + (warp & ((1 << sp.shift) - 1)) * kWarpSlots;
    rows = bh < static_cast<size_t>(bh_total) ? min(kWarpSlots, pos + 1 - t0) : 0;
  }
};

// The warp's slice of a work unit in flight into its stage `st`, as one
// commit group (empty if the unit is past the block's last): q, then the K
// and V rows of its slots, every request sent before any is waited for.
// Row `pos` comes from k_new / v_new, never from the cache row being
// written.
template <typename T, int E, int NVP>
__device__ __forceinline__ void prefetch(int st, bool live, const Unit& u,
                                         unsigned char* stages, const T* q,
                                         const T* k_new, const T* v_new,
                                         const T* k_cache, const T* v_cache,
                                         int t_cap, int nv, int pos) {
  using C = Cfg<T, E, NVP>;
  using Raw = typename C::Raw;
  if (live && u.rows > 0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned char* stage = stages + (st * kWarps + warp) * C::kStageBytes;
    Raw* qs = reinterpret_cast<Raw*>(stage);
    Raw* ks = reinterpret_cast<Raw*>(stage + C::kQBytes);
    Raw* vs = reinterpret_cast<Raw*>(stage + C::kQBytes + C::kKBytes);
    const size_t bh = u.bh;
    const int t0 = u.t0, rows = u.rows;
    for (int c = lane; c < nv; c += 32)
      fetch(qs + c, reinterpret_cast<const Raw*>(q) + bh * nv + c);
    const Raw* kc = reinterpret_cast<const Raw*>(k_cache) + (bh * t_cap + t0) * nv;
    const Raw* vc = reinterpret_cast<const Raw*>(v_cache) + (bh * t_cap + t0) * nv;
#pragma unroll
    for (int r = 0; r < kWarpSlots; ++r) {   // lanes over a row's chunks
      if (r < rows) {
        const bool is_new = t0 + r == pos;
        const Raw* krow = is_new ? reinterpret_cast<const Raw*>(k_new) + bh * nv : kc + r * nv;
        const Raw* vrow = is_new ? reinterpret_cast<const Raw*>(v_new) + bh * nv : vc + r * nv;
#pragma unroll
        for (int j = 0; j < C::kLaneChunks; ++j) {
          const int c = lane + 32 * j;
          if (c < nv) {
            fetch(ks + r * C::kKPitch + c, krow + c);
            fetch(vs + r * NVP + c, vrow + c);
          }
        }
      }
    }
  }
  cp_async_commit();
}

// One block works through the groups of sp.rows (b, h) rows blockIdx.x,
// blockIdx.x + gridDim.x, ... (its k-th group is blockIdx.x + k gridDim.x)
// and through each one's slot tiles: a stream of work units (k, tile).
// Each warp takes its slice of every tile on its own: it fetches it
// kStages - 1 units ahead into its own ring of stages, scores it, keeps
// its own online softmax (running max, sum and accumulator) across the
// tiles of a row, and waits for no other warp until the group's last
// tile, where the partial results of each row's warps are combined
// through shared memory.
template <typename T, int E, int NVP, bool kFull>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, T* __restrict__ k_cache,
                        T* __restrict__ v_cache, T* __restrict__ out, int bh_total,
                        int t_cap, int nv, int pos, float scale) {
  using C = Cfg<T, E, NVP>;
  using Raw = typename C::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* comb_acc = reinterpret_cast<float*>(smem + kStages * kWarps * C::kStageBytes);
  float* comb_m = comb_acc + kWarps * NVP * E;
  float* comb_l = comb_m + kWarps;

  const Split<kFull> sp(pos);
  const int n_tiles = pos / sp.width + 1;
  const int n_groups = (bh_total + sp.rows - 1) / sp.rows;
  const int my_groups = (n_groups - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int r_pos = pos % sp.width;    // slot `pos` in the last tile
  const int slot = lane & 7, part = lane >> 3;   // q.K: slot of the warp's, chunks part + 4 i

  float acc[C::kLaneChunks][E];          // P.V: chunks lane + 32 j
  float m_run = kNegInf, l_run = 0.f;

  int ik = 0, itile = 0;               // the next unit to fetch
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    prefetch<T, E, NVP>(st, ik < my_groups, Unit(ik, itile, sp, bh_total, pos), smem, q,
                        k_new, v_new, k_cache, v_cache, t_cap, nv, pos);
    if (++itile == n_tiles) itile = 0, ++ik;
  }
  int k = 0, tile = -1;                // the unit w
  for (int w = 0; w < my_groups * n_tiles; ++w) {
    if (++tile == n_tiles) tile = 0, ++k;
    // unit w + kStages - 1 into the stage freed at the end of unit w - 1
    prefetch<T, E, NVP>((w + kStages - 1) % kStages, ik < my_groups,
                        Unit(ik, itile, sp, bh_total, pos), smem, q, k_new, v_new, k_cache,
                        v_cache, t_cap, nv, pos);
    if (++itile == n_tiles) itile = 0, ++ik;
    cp_async_wait<kStages - 1>();      // this lane's part of unit w is in
    __syncwarp();                      // and the warp's
    const Unit u(k, tile, sp, bh_total, pos);
    const int rows = u.rows;
    const unsigned char* stage = smem + ((w % kStages) * kWarps + warp) * C::kStageBytes;
    const Raw* qs = reinterpret_cast<const Raw*>(stage);
    const Raw* ks = reinterpret_cast<const Raw*>(stage + C::kQBytes);
    const Raw* vs = reinterpret_cast<const Raw*>(stage + C::kQBytes + C::kKBytes);
    if (tile == 0) {
#pragma unroll
      for (int j = 0; j < C::kLaneChunks; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
      m_run = kNegInf;
      l_run = 0.f;
    }

    // 1. scores: four lanes a slot (lanes slot, slot + 8, slot + 16, slot
    //    + 24), reduced by two shuffles; the eight lanes of a part read one
    //    q chunk, and the K pitch is odd, so the eight slots a quarter warp
    //    reads lie in eight bank groups
    float sc = kNegInf;
    {
      float d = 0.f;
      if (slot < rows) {
        const Raw* krow = ks + slot * C::kKPitch;
#pragma unroll 8
        for (int j = 0; j < C::kQChunks; ++j) {
          const int c = part + kParts * j;
          if (c < nv) {
            float qf[E], kf[E];
            unpack<T, E>(qs[c], qf);
            unpack<T, E>(krow[c], kf);
#pragma unroll
            for (int e = 0; e < E; ++e) d = fmaf(qf[e], kf[e], d);
          }
        }
      }
      d += __shfl_xor_sync(kFullMask, d, 8);
      d += __shfl_xor_sync(kFullMask, d, 16);
      if (slot < rows) sc = d * scale;
    }

    // 2. online softmax over the warp's slots of the tile: max and sum over
    //    the eight slots by three shuffles each
    float mt = sc;
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(kFullMask, mt, off));
    const float m_new = fmaxf(m_run, mt);
    const float alpha = expf(m_run - m_new);
    const float p = slot < rows ? expf(sc - m_new) : 0.f;
    float lt = p;
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) lt += __shfl_xor_sync(kFullMask, lt, off);
    l_run = l_run * alpha + lt;
    m_run = m_new;

    // 3. acc = alpha acc + sum over the warp's slots of p_s V[s]; lanes own
    //    chunks, so a warp's V reads are consecutive
#pragma unroll
    for (int j = 0; j < C::kLaneChunks; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] *= alpha;
#pragma unroll
    for (int s = 0; s < kWarpSlots; ++s) {
      const float ps = __shfl_sync(kFullMask, p, s);
      if (s < rows) {
        const Raw* vrow = vs + s * NVP;
#pragma unroll
        for (int j = 0; j < C::kLaneChunks; ++j) {
          const int c = lane + 32 * j;
          if (c < nv) {
            float vf[E];
            unpack<T, E>(vrow[c], vf);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[j][e] = fmaf(ps, vf[e], acc[j][e]);
          }
        }
      }
    }

    if (tile == n_tiles - 1) {
      // 4. the new K/V row at `pos`, in place, by the warp whose slots hold
      //    it, from its stage, which fetched it from k_new / v_new
      if (rows > 0 && (warp & ((1 << sp.shift) - 1)) == r_pos / kWarpSlots) {
        const int r = r_pos % kWarpSlots;
        Raw* kc = reinterpret_cast<Raw*>(k_cache) + (u.bh * t_cap + pos) * nv;
        Raw* vc = reinterpret_cast<Raw*>(v_cache) + (u.bh * t_cap + pos) * nv;
        for (int c = lane; c < nv; c += 32) {
          kc[c] = ks[r * C::kKPitch + c];
          vc[c] = vs[r * NVP + c];
        }
      }
      // 5. each row's warps' partial results, combined: m = max m_j,
      //    weights exp(m_j - m), out = sum_j w_j acc_j / sum_j w_j l_j in
      //    the input dtype
#pragma unroll
      for (int j = 0; j < C::kLaneChunks; ++j) {
        const int c = lane + 32 * j;
        if (c < nv) {
#pragma unroll
          for (int e = 0; e < E; ++e) comb_acc[(warp * NVP + c) * E + e] = acc[j][e];
        }
      }
      if (lane == 0) {
        comb_m[warp] = m_run;
        comb_l[warp] = l_run;
      }
      __syncthreads();
      // warp j combines row j of the group, lanes over its chunks
      const size_t bh_row = u.bh - (warp >> sp.shift) + warp;
      if (warp < sp.rows && bh_row < static_cast<size_t>(bh_total)) {
        const int w0 = warp << sp.shift, n = 1 << sp.shift;
        float m = comb_m[w0];
#pragma unroll
        for (int j = 1; j < kWarps; ++j)
          if (j < n) m = fmaxf(m, comb_m[w0 + j]);
        float wt[kWarps], l = 0.f;
#pragma unroll
        for (int j = 0; j < kWarps; ++j) {
          wt[j] = j < n ? expf(comb_m[w0 + j] - m) : 0.f;
          if (j < n) l = fmaf(wt[j], comb_l[w0 + j], l);
        }
        Raw* orow = reinterpret_cast<Raw*>(out) + bh_row * nv;
#pragma unroll
        for (int jj = 0; jj < C::kLaneChunks; ++jj) {
          const int c = lane + 32 * jj;
          if (c < nv) {
            float o[E];
#pragma unroll
            for (int e = 0; e < E; ++e) o[e] = 0.f;
#pragma unroll
            for (int j = 0; j < kWarps; ++j)
              if (j < n) {
#pragma unroll
                for (int e = 0; e < E; ++e)
                  o[e] = fmaf(wt[j], comb_acc[((w0 + j) * NVP + c) * E + e], o[e]);
              }
#pragma unroll
            for (int e = 0; e < E; ++e) o[e] = o[e] / l;
            orow[c] = pack<T, E, Raw>(o);
          }
        }
      }
      __syncthreads();                 // the combine space is free again
    }
    __syncwarp();                      // the warp's stage is free again
  }
  cp_async_wait<0>();                  // no group left pending at exit
}

template <typename T, int E, int NVP, bool kFull>
cudaError_t launch_instance(const void* q, const void* k_new, const void* v_new,
                            void* k_cache, void* v_cache, void* out, int bh_total,
                            int t_cap, int nv, int pos, float scale, void* stream) {
  using C = Cfg<T, E, NVP>;
  const auto kernel = decode_attention_kernel<T, E, NVP, kFull>;
  // per device: blocks an SM, found once with the occupancy calculator
  constexpr int kDevices = 16;
  static int resident[kDevices] = {};
  static int sms[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (!resident[dev]) {
    // above 48 KB a block's shared memory must be asked for; all of the
    // SM's shared memory, so that as many blocks fit as the registers allow
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    resident[dev] = n > 0 ? n : 1;
  }
  const long long fill = static_cast<long long>(resident[dev]) * sms[dev];
  const Split<kFull> sp(pos);
  const int groups = (bh_total + sp.rows - 1) / sp.rows;
  const int grid = static_cast<int>(groups < fill ? groups : fill);
  kernel<<<grid, kThreads, C::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_cache),
      static_cast<T*>(v_cache), static_cast<T*>(out), bh_total, t_cap, nv, pos,
      scale);
  return cudaGetLastError();
}

template <typename T, int E, int NVP>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_cache, void* v_cache, void* out, int bh_total,
                   int t_cap, int nv, int pos, float scale, void* stream) {
  const bool full = Split<false>(pos).shift == kLogWarps;
  return (full ? launch_instance<T, E, NVP, true> : launch_instance<T, E, NVP, false>)(
      q, k_new, v_new, k_cache, v_cache, out, bh_total, t_cap, nv, pos, scale, stream);
}

// The instance for Dh: 16-byte chunks on the smallest padded width that
// holds Dh (float32 64, 72, 128, 256; bfloat16 64, 80, 128, 256), or
// one-element chunks at 256 when Dh is not a whole number of 16-byte chunks.
template <typename T>
cudaError_t dispatch(const void* q, const void* k_new, const void* v_new,
                     void* k_cache, void* v_cache, void* out, int batch,
                     int heads, int t_cap, int dh, int pos, float scale,
                     void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kMid = sizeof(T) == 4 ? 72 : 80;
  const int bh = batch * heads;
  if (bh <= 0 || dh <= 0 || dh > 256 || pos < 0 || pos >= t_cap)
    return cudaErrorInvalidValue;
  if (dh % kVec)
    return launch<T, 1, 256>(q, k_new, v_new, k_cache, v_cache, out, bh, t_cap,
                             dh, pos, scale, stream);
  const int nv = dh / kVec;
  if (dh <= 64)
    return launch<T, kVec, 64 / kVec>(q, k_new, v_new, k_cache, v_cache, out, bh,
                                      t_cap, nv, pos, scale, stream);
  if (dh <= kMid)
    return launch<T, kVec, kMid / kVec>(q, k_new, v_new, k_cache, v_cache, out,
                                        bh, t_cap, nv, pos, scale, stream);
  if (dh <= 128)
    return launch<T, kVec, 128 / kVec>(q, k_new, v_new, k_cache, v_cache, out,
                                       bh, t_cap, nv, pos, scale, stream);
  return launch<T, kVec, 256 / kVec>(q, k_new, v_new, k_cache, v_cache, out, bh,
                                     t_cap, nv, pos, scale, stream);
}

}  // namespace

extern "C" {

// q, k_new, v_new, out: [batch, heads, dh]; k_cache, v_cache:
// [batch, heads, t_cap, dh], all contiguous, on the current device; 16-byte
// aligned when dh * sizeof(element) is a multiple of 16, element-aligned
// otherwise.  Requires batch*heads > 0, 0 <= pos < t_cap and 0 < dh <= 256.
// Runs on `stream`; does not synchronise.  Returns the launch's error code.
cudaError_t sc_decode_attention_f32(const void* q, const void* k_new,
                                    const void* v_new, void* k_cache,
                                    void* v_cache, void* out, int batch,
                                    int heads, int t_cap, int dh, int pos,
                                    float scale, void* stream) {
  return dispatch<float>(q, k_new, v_new, k_cache, v_cache, out, batch, heads,
                         t_cap, dh, pos, scale, stream);
}

cudaError_t sc_decode_attention_bf16(const void* q, const void* k_new,
                                     const void* v_new, void* k_cache,
                                     void* v_cache, void* out, int batch,
                                     int heads, int t_cap, int dh, int pos,
                                     float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, out, batch,
                                 heads, t_cap, dh, pos, scale, stream);
}

}  // extern "C"
