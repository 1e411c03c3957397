// Paged-cache GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_gqa/kernel.py::
// paged_decode_gqa_kernel (body _paged_decode_kernel, oracle
// paged_decode_gqa_ref). It is the paged read of every Molecular Transformer
// decoder layer under the streaming engine: the T = DL+1 fed tokens of each
// row attend to the keys of the pool pages the row's block table maps
// (logical block j of row b is page bt[b, j], -1 = unmapped), masked on the
// stored positions (-1 = empty slot, causal k_pos <= q_pos, optional sliding
// window k_pos > q_pos - window). A query row with no visible key outputs 0.
//
// What bounds it on this card: bytes, as for the dense kernel (4*T*G*hd
// flops per visible key against 2*hd*4 bytes of K/V). The TPU kernel walked
// the logical blocks on a sequential grid axis, one page per grid step, and
// DMAed page 0 for unmapped blocks. Here one block owns one (row b, kv head
// g) and walks the row's logical keys itself in tiles of BK keys, keeping
// the online-softmax state in shared memory. Each tile first loads the
// tile's block-table entries and stored positions only; a key is loaded
// when its block is mapped and some query of the row can see it, and a tile
// without such a key is skipped whole. So unmapped blocks, empty slots and
// keys past the newest query cost no K/V traffic, and every loaded byte is
// read once per (row, kv head) and reused by all T*G query rows. The pool is
// read in the model's (P, ps, Kv, hd) layout through its strides, with no
// transposed copy.
//
// Plain C interface, loaded with ctypes: paged_decode_gqa_launch returns the
// cudaError_t of the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BK = 32;         // keys per tile: one per lane in the softmax
constexpr int THREADS = 128;   // four warps
constexpr int NW = THREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int TG, int T_q, int hd) {
  size_t floats = 2 * (size_t)TG * hd      // q rows + accumulator
                  + (size_t)BK * (hd + 1)  // K tile (padded rows)
                  + (size_t)BK * hd        // V tile
                  + (size_t)TG * BK        // scores / probabilities
                  + 2 * (size_t)TG;        // running max and sum
  // stored position and K/V pool offsets of each tile key, query positions
  return floats * sizeof(float) + (size_t)BK * (2 * sizeof(long long) + sizeof(int))
         + (size_t)T_q * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        const int* __restrict__ bt,
                        const int* __restrict__ q_pos, T* __restrict__ out,
                        int T_q, int H, int Kv, int ps, int nb, int hd,
                        long long k_sp, long long k_ss, long long k_sh,
                        long long v_sp, long long v_ss, long long v_sh,
                        int window, float scale) {
  const int b = blockIdx.x, g = blockIdx.y;
  const int G = H / Kv;
  const int TG = T_q * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ks = hd + 1;  // padded K row: lanes on different keys, no conflict
  const int S = nb * ps;  // logical keys of the row

  extern __shared__ float smem[];
  float* q_s = smem;               // (TG, hd)
  float* acc = q_s + TG * hd;      // (TG, hd)
  float* k_s = acc + TG * hd;      // (BK, hd + 1)
  float* v_s = k_s + BK * ks;      // (BK, hd)
  float* p_s = v_s + BK * hd;      // (TG, BK)
  float* m_s = p_s + TG * BK;      // (TG,)
  float* l_s = m_s + TG;           // (TG,)
  long long* koff_s = reinterpret_cast<long long*>(l_s + TG);  // (BK,)
  long long* voff_s = koff_s + BK;                              // (BK,)
  int* kp_s = reinterpret_cast<int*>(voff_s + BK);              // (BK,)
  int* qp_s = kp_s + BK;                                        // (T_q,)

  // row r = t*G + gi holds q[b, t, g*G + gi, :]
  for (int i = tid; i < TG * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int t = r / G, gi = r - t * G;
    q_s[i] = to_f(q[(((long long)b * T_q + t) * H + g * G + gi) * hd + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < TG; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  for (int t = tid; t < T_q; t += THREADS)
    qp_s[t] = q_pos[(long long)b * T_q + t];
  __syncthreads();
  // the widest query range of the row: a key outside it is seen by no query
  int q_lo = qp_s[0], q_hi = qp_s[0];
  for (int t = 1; t < T_q; ++t) {
    q_lo = min(q_lo, qp_s[t]);
    q_hi = max(q_hi, qp_s[t]);
  }

  const int* btb = bt + (long long)b * nb;
  for (int s0 = 0; s0 < S; s0 += BK) {
    __syncthreads();  // previous tile consumed
    // stage 1: block-table entries and stored positions of the tile's keys
    int seen = 0;
    if (tid < BK) {
      const int s = s0 + tid;
      int kp = -1;
      if (s < S) {
        const int blk = s / ps, j = s - blk * ps;
        const int page = btb[blk];  // -1: unmapped block, nothing is loaded
        if (page >= 0) {
          kp = pos[(long long)page * ps + j];
          // a key that no query of the row can see is never loaded
          if (!(kp >= 0 && kp <= q_hi && (window <= 0 || kp > q_lo - window)))
            kp = -1;
          koff_s[tid] = (long long)page * k_sp + (long long)j * k_ss + g * k_sh;
          voff_s[tid] = (long long)page * v_sp + (long long)j * v_ss + g * v_sh;
        }
      }
      kp_s[tid] = kp;
      seen = kp >= 0;
    }
    if (!__syncthreads_or(seen)) continue;  // no visible key in this tile

    // stage 2: K/V of the visible keys (zeros elsewhere; masked below)
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int j = i / hd, d = i - j * hd;
      float kx = 0.f, vx = 0.f;
      if (kp_s[j] >= 0) {
        kx = to_f(k[koff_s[j] + d]);
        vx = to_f(v[voff_s[j] + d]);
      }
      k_s[j * ks + d] = kx;
      v_s[j * hd + d] = vx;
    }
    __syncthreads();

    // scores of every (row, key) pair of the tile; invisible keys -> -inf
    for (int i = tid; i < TG * BK; i += THREADS) {
      const int r = i / BK, j = i - r * BK;
      const int qp = qp_s[r / G], kp = kp_s[j];
      const bool vis = kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
      float sc = -INFINITY;
      if (vis) {
        const float* qr = q_s + r * hd;
        const float* kr = k_s + j * ks;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      p_s[i] = sc;
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w + NW, ... for the whole loop
    for (int r = warp; r < TG; r += NW) {
      const float sc = p_s[r * BK + lane];
      float tmax = sc;
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {  // some key of this row is visible so far
        alpha = expf(m_old - m_new);
        p = sc == -INFINITY ? 0.f : expf(sc - m_new);
      }
      float psum = p;
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      p_s[r * BK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
      }
      for (int d = lane; d < hd; d += 32) {
        float a = acc[r * hd + d] * alpha;
        for (int j = 0; j < BK; ++j) a = fmaf(p_s[r * BK + j], v_s[j * hd + d], a);
        acc[r * hd + d] = a;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < TG * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int t = r / G, gi = r - t * G;
    const float l = l_s[r];
    const float o = l > 0.f ? acc[i] / l : 0.f;  // no visible key -> 0
    out[(((long long)b * T_q + t) * H + g * G + gi) * hd + d] = from_f<T>(o);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos,
                   const int* bt, const int* q_pos, void* out, int B, int T_q,
                   int H, int Kv, int ps, int nb, int hd, long long k_sp,
                   long long k_ss, long long k_sh, long long v_sp,
                   long long v_ss, long long v_sh, int window, float scale,
                   cudaStream_t stream) {
  const int TG = T_q * (H / Kv);
  const size_t smem = smem_bytes(TG, T_q, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_gqa_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, Kv);
  paged_decode_gqa_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, bt, q_pos, static_cast<T*>(out), T_q, H,
      Kv, ps, nb, hd, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pool strides (page, slot, head) are in
// elements; the head_dim axis of the pools must be contiguous, pos (P, ps),
// bt (B, nb) and q_pos (B, T) contiguous int32. Returns a cudaError_t.
extern "C" int paged_decode_gqa_launch(
    const void* q, const void* k, const void* v, const int* pos, const int* bt,
    const int* q_pos, void* out, int B, int T_q, int H, int Kv, int ps, int nb,
    int hd, long long k_sp, long long k_ss, long long k_sh, long long v_sp,
    long long v_ss, long long v_sh, int window, float scale, int dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, pos, bt, q_pos, out, B, T_q, H, Kv, ps,
                              nb, hd, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh,
                              window, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, pos, bt, q_pos, out, B, T_q, H,
                                      Kv, ps, nb, hd, k_sp, k_ss, k_sh, v_sp,
                                      v_ss, v_sh, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
