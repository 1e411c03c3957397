// Full-sequence (flash) attention for Hopper (sm_90a), forward and backward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel (body _attn_kernel, oracle flash_attention_ref) and
// adds the backward that the JAX package lacks (JAX differentiates its
// einsum). It is the Molecular Transformer's full-sequence self-attention:
// the encoder at every serving call and admission, and in training the
// encoder and the teacher-forced causal decoder, forward and backward.
//
// Masking: a key is visible to a query when it lies inside the sequence,
// its key_mask entry (B, S) is set (NULL = every key valid: the TPU
// kernel's contract), and, when causal, key <= query and, with window > 0,
// key > query - window. Invisible keys get exactly 0 weight. A query row
// with no visible key outputs 0, stores lse = -inf and receives zero
// gradient (the TPU kernel averages V over its padded tile there).
//
// Three kernels, three launches per forward plus backward, no atomics (so
// the gradients are deterministic):
//   flash_fwd        one block per (batch*head, 32-query tile); streams the
//                    32-key tiles with the online softmax (running max, sum
//                    and accumulator in shared memory), writes O and the
//                    fp32 log-sum-exp lse (B, H, S);
//   flash_bwd_dkdv   one block per (batch*head, 32-key tile); loops over
//                    the query tiles that can see it, recomputes
//                    P = exp(s*scale - lse) and D = rowsum(dO*O) on the fly,
//                    accumulates dV = P^T dO and dK = scale * dS^T Q;
//   flash_bwd_dq     one block per (batch*head, 32-query tile); loops over
//                    the key tiles it can see, accumulates dQ = scale * dS K.
//
// What bounds it on this card: at the port's shapes (S <= 128, hd 32) each
// (batch, head) moves 4*S*hd*4 bytes and does 4*S^2*hd flops, about S/4
// flops per byte, so fp32 arithmetic (67 TFLOP/s outside the tensor cores)
// and bytes (3.35 TB/s) are within a factor of two of each other. The TPU
// kernel walked the keys on a sequential grid axis with VMEM scratch;
// blocks here run in no order, so each block loops over the other axis
// itself. Tiles are staged through shared memory once and shared by the
// block's 32 rows; causal and windowed blocks skip tiles nobody can see.
// Q, K, V, O and dO are read in the model's (B, S, H, hd) layout through
// their strides (no transposed copy). This is a first, simple version:
// scalar fp32 FMAs, no tensor cores (wgmma) and no TMA.
//
// Plain C interface, loaded with ctypes: each launch function returns the
// cudaError_t of its launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;       // query rows and keys per tile (a warp wide)
constexpr int THREADS = 128;   // four warps
constexpr int NW = THREADS / 32;
constexpr int PS = TILE + 1;   // padded row of a (TILE, TILE) score tile

struct Str {                   // element strides of a (B, S, H, hd) tensor
  long long b, s, h;
};

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// may query qp see key kp (both inside [0, S); the key's own validity is
// checked by the caller)
__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  if (qp >= S) return false;   // padding row of the last query tile
  if (causal) {
    if (kp > qp) return false;
    if (window > 0 && kp <= qp - window) return false;
  }
  return true;
}

// rows [r0, r0 + TILE) of head h of batch b into dst (TILE, ld) as fp32;
// rows past S read as 0
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* __restrict__ x, Str st,
                          int b, int h, int r0, int S, int hd) {
  for (int i = threadIdx.x; i < TILE * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int s = r0 + r;
    dst[r * ld + d] =
        s < S ? to_f(x[b * st.b + (long long)s * st.s + h * st.h + d]) : 0.f;
  }
}

// validity of keys [k0, k0 + TILE): inside S and set in key_mask
__device__ void load_key_valid(int* kv_s, const unsigned char* key_mask,
                               int b, int k0, int S) {
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    const int s = k0 + j;
    kv_s[j] = s < S && (key_mask == nullptr ||
                        key_mask[(long long)b * S + s] != 0);
  }
}

// the key tiles a query tile [q0, q0 + TILE) can see: [lo, hi)
__device__ __forceinline__ void key_range(int q0, int S, int causal,
                                          int window, int* lo, int* hi) {
  *lo = 0;
  *hi = S;
  if (causal) {
    *hi = min(S, q0 + TILE);
    if (window > 0) *lo = max(0, q0 - window + 1);
  }
  *lo = (*lo / TILE) * TILE;
}

// ---------------------------------------------------------------------------
// forward

size_t fwd_smem(int hd) {
  const int ld = hd + 1;
  return (3 * (size_t)TILE * ld + (size_t)TILE * hd + (size_t)TILE * PS +
          2 * (size_t)TILE) * sizeof(float) + TILE * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const unsigned char* __restrict__ key_mask,
          T* __restrict__ out, float* __restrict__ lse, int S, int H, int hd,
          Str qs, Str ks, Str vs, int causal, int window, float scale) {
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = hd + 1;  // padded rows: lanes on different keys, no conflict

  extern __shared__ float smem[];
  float* q_s = smem;               // (TILE, ld)
  float* k_s = q_s + TILE * ld;    // (TILE, ld)
  float* v_s = k_s + TILE * ld;    // (TILE, ld)
  float* acc = v_s + TILE * ld;    // (TILE, hd)
  float* p_s = acc + TILE * hd;    // (TILE, PS) scores, then probabilities
  float* m_s = p_s + TILE * PS;    // (TILE,) running max
  float* l_s = m_s + TILE;         // (TILE,) running sum
  int* kv_s = reinterpret_cast<int*>(l_s + TILE);  // (TILE,) key valid

  load_tile(q_s, ld, q, qs, b, h, q0, S, hd);
  for (int i = tid; i < TILE * hd; i += THREADS) acc[i] = 0.f;
  for (int r = tid; r < TILE; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  int k_lo, k_hi;
  key_range(q0, S, causal, window, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += TILE) {
    __syncthreads();  // set-up written / previous tile consumed
    load_tile(k_s, ld, k, ks, b, h, k0, S, hd);
    load_tile(v_s, ld, v, vs, b, h, k0, S, hd);
    load_key_valid(kv_s, key_mask, b, k0, S);
    __syncthreads();

    // scores of every (row, key) pair of the tile; invisible -> -inf
    for (int i = tid; i < TILE * TILE; i += THREADS) {
      const int r = i / TILE, j = i - r * TILE;
      float sc = -INFINITY;
      if (kv_s[j] && visible(q0 + r, k0 + j, S, causal, window)) {
        const float* qr = q_s + r * ld;
        const float* kr = k_s + j * ld;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      p_s[r * PS + j] = sc;
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w + NW, ... for the whole loop
    for (int r = warp; r < TILE; r += NW) {
      const float sc = p_s[r * PS + lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(sc));
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {  // some key of this row is visible so far
        alpha = expf(m_old - m_new);
        p = sc == -INFINITY ? 0.f : expf(sc - m_new);
      }
      const float psum = warp_sum(p);
      p_s[r * PS + lane] = p;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
      }
      for (int d = lane; d < hd; d += 32) {
        float a = acc[r * hd + d] * alpha;
        for (int j = 0; j < TILE; ++j)
          a = fmaf(p_s[r * PS + j], v_s[j * ld + d], a);
        acc[r * hd + d] = a;
      }
    }
  }
  __syncthreads();

  // out (B, S, H, hd) contiguous; lse (B, H, S)
  for (int i = tid; i < TILE * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int s = q0 + r;
    if (s < S) {
      const float l = l_s[r];
      out[(((long long)b * S + s) * H + h) * hd + d] =
          from_f<T>(l > 0.f ? acc[i] / l : 0.f);  // no visible key -> 0
    }
  }
  for (int r = tid; r < TILE; r += THREADS) {
    const int s = q0 + r;
    if (s < S)
      lse[(long long)bh * S + s] =
          l_s[r] > 0.f ? m_s[r] + logf(l_s[r]) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// backward (fp32)

// lse and D = rowsum(dO * O) of query rows [q0, q0 + TILE); do_s holds the
// dO tile already. Rows past S get 0.
__device__ void load_row_stats(float* lse_s, float* D_s, const float* do_s,
                               int ld, const float* __restrict__ o, Str os,
                               const float* __restrict__ lse, int b, int h,
                               int bh, int q0, int S, int hd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE; r += NW) {
    const int s = q0 + r;
    float acc = 0.f;
    if (s < S) {
      const float* orow = o + b * os.b + (long long)s * os.s + h * os.h;
      for (int d = lane; d < hd; d += 32) acc = fmaf(do_s[r * ld + d], orow[d], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      D_s[r] = acc;
      lse_s[r] = s < S ? lse[(long long)bh * S + s] : 0.f;
    }
  }
}

// P (if p_s) and dS of one (query tile q0, key tile k0) pair into (TILE, PS)
// tiles: P = exp(s*scale - lse) on visible pairs and exactly 0 elsewhere,
// dS = P * (dO . V - D).
__device__ void p_ds_tile(float* p_s, float* ds_s, const float* q_s,
                          const float* do_s, const float* k_s,
                          const float* v_s, int ld, const float* lse_s,
                          const float* D_s, const int* kv_s, int q0, int k0,
                          int S, int hd, int causal, int window, float scale) {
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int r = i / TILE, j = i - r * TILE;
    float p = 0.f, ds = 0.f;
    if (kv_s[j] && visible(q0 + r, k0 + j, S, causal, window)) {
      const float* qr = q_s + r * ld;
      const float* kr = k_s + j * ld;
      const float* dr = do_s + r * ld;
      const float* vr = v_s + j * ld;
      float dot = 0.f, dp = 0.f;
      for (int d = 0; d < hd; ++d) {
        dot = fmaf(qr[d], kr[d], dot);
        dp = fmaf(dr[d], vr[d], dp);
      }
      p = expf(dot * scale - lse_s[r]);
      ds = p * (dp - D_s[r]);
    }
    if (p_s != nullptr) p_s[r * PS + j] = p;
    ds_s[r * PS + j] = ds;
  }
}

size_t dkdv_smem(int hd) {
  const int ld = hd + 1;
  return (4 * (size_t)TILE * ld + 2 * (size_t)TILE * hd +
          2 * (size_t)TILE * PS + 2 * (size_t)TILE) * sizeof(float) +
         TILE * sizeof(int);
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ o,
               const float* __restrict__ dout,
               const unsigned char* __restrict__ key_mask,
               const float* __restrict__ lse, float* __restrict__ dk,
               float* __restrict__ dv, int S, int H, int hd, Str qs, Str ks,
               Str vs, Str os, Str dos, int causal, int window, float scale) {
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * TILE;
  const int tid = threadIdx.x;
  const int ld = hd + 1;

  extern __shared__ float smem[];
  float* k_s = smem;                // (TILE, ld)
  float* v_s = k_s + TILE * ld;     // (TILE, ld)
  float* q_s = v_s + TILE * ld;     // (TILE, ld)
  float* do_s = q_s + TILE * ld;    // (TILE, ld)
  float* dk_acc = do_s + TILE * ld; // (TILE, hd)
  float* dv_acc = dk_acc + TILE * hd;
  float* p_s = dv_acc + TILE * hd;  // (TILE, PS)
  float* ds_s = p_s + TILE * PS;    // (TILE, PS)
  float* lse_s = ds_s + TILE * PS;  // (TILE,)
  float* D_s = lse_s + TILE;        // (TILE,)
  int* kv_s = reinterpret_cast<int*>(D_s + TILE);

  load_tile(k_s, ld, k, ks, b, h, k0, S, hd);
  load_tile(v_s, ld, v, vs, b, h, k0, S, hd);
  load_key_valid(kv_s, key_mask, b, k0, S);
  for (int i = tid; i < TILE * hd; i += THREADS) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  // a tile of masked keys gets no gradient: skip its query loop
  const int any_key = __syncthreads_or(tid < TILE && kv_s[tid]);

  // the query tiles that can see keys [k0, k0 + TILE)
  int q_lo = 0, q_hi = S;
  if (causal) {
    q_lo = k0;
    if (window > 0) q_hi = min(S, k0 + TILE - 1 + window);
  }
  q_lo = (q_lo / TILE) * TILE;
  for (int q0 = q_lo; any_key && q0 < q_hi; q0 += TILE) {
    __syncthreads();  // previous tile consumed
    load_tile(q_s, ld, q, qs, b, h, q0, S, hd);
    load_tile(do_s, ld, dout, dos, b, h, q0, S, hd);
    __syncthreads();
    load_row_stats(lse_s, D_s, do_s, ld, o, os, lse, b, h, bh, q0, S, hd);
    __syncthreads();
    p_ds_tile(p_s, ds_s, q_s, do_s, k_s, v_s, ld, lse_s, D_s, kv_s, q0, k0,
              S, hd, causal, window, scale);
    __syncthreads();
    // thread per (key j, dim d): dV += P^T dO, dK += dS^T Q
    for (int i = tid; i < TILE * hd; i += THREADS) {
      const int j = i / hd, d = i - j * hd;
      float a = dv_acc[i], c = dk_acc[i];
      for (int r = 0; r < TILE; ++r) {
        a = fmaf(p_s[r * PS + j], do_s[r * ld + d], a);
        c = fmaf(ds_s[r * PS + j], q_s[r * ld + d], c);
      }
      dv_acc[i] = a;
      dk_acc[i] = c;
    }
  }
  __syncthreads();

  for (int i = tid; i < TILE * hd; i += THREADS) {
    const int j = i / hd, d = i - j * hd;
    const int s = k0 + j;
    if (s < S) {
      const long long at = (((long long)b * S + s) * H + h) * hd + d;
      dk[at] = dk_acc[i] * scale;
      dv[at] = dv_acc[i];
    }
  }
}

size_t dq_smem(int hd) {
  const int ld = hd + 1;
  return (4 * (size_t)TILE * ld + (size_t)TILE * hd + (size_t)TILE * PS +
          2 * (size_t)TILE) * sizeof(float) + TILE * sizeof(int);
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ o,
             const float* __restrict__ dout,
             const unsigned char* __restrict__ key_mask,
             const float* __restrict__ lse, float* __restrict__ dq, int S,
             int H, int hd, Str qs, Str ks, Str vs, Str os, Str dos,
             int causal, int window, float scale) {
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * TILE;
  const int tid = threadIdx.x;
  const int ld = hd + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                // (TILE, ld)
  float* do_s = q_s + TILE * ld;    // (TILE, ld)
  float* k_s = do_s + TILE * ld;    // (TILE, ld)
  float* v_s = k_s + TILE * ld;     // (TILE, ld)
  float* dq_acc = v_s + TILE * ld;  // (TILE, hd)
  float* ds_s = dq_acc + TILE * hd; // (TILE, PS)
  float* lse_s = ds_s + TILE * PS;  // (TILE,)
  float* D_s = lse_s + TILE;        // (TILE,)
  int* kv_s = reinterpret_cast<int*>(D_s + TILE);

  load_tile(q_s, ld, q, qs, b, h, q0, S, hd);
  load_tile(do_s, ld, dout, dos, b, h, q0, S, hd);
  for (int i = tid; i < TILE * hd; i += THREADS) dq_acc[i] = 0.f;
  __syncthreads();
  load_row_stats(lse_s, D_s, do_s, ld, o, os, lse, b, h, bh, q0, S, hd);

  int k_lo, k_hi;
  key_range(q0, S, causal, window, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += TILE) {
    __syncthreads();  // row stats written / previous tile consumed
    load_tile(k_s, ld, k, ks, b, h, k0, S, hd);
    load_tile(v_s, ld, v, vs, b, h, k0, S, hd);
    load_key_valid(kv_s, key_mask, b, k0, S);
    __syncthreads();
    p_ds_tile(nullptr, ds_s, q_s, do_s, k_s, v_s, ld, lse_s, D_s, kv_s, q0,
              k0, S, hd, causal, window, scale);
    __syncthreads();
    // thread per (row r, dim d): dQ += dS K
    for (int i = tid; i < TILE * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      float a = dq_acc[i];
      for (int j = 0; j < TILE; ++j)
        a = fmaf(ds_s[r * PS + j], k_s[j * ld + d], a);
      dq_acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < TILE * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int s = q0 + r;
    if (s < S) dq[(((long long)b * S + s) * H + h) * hd + d] = dq_acc[i] * scale;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const unsigned char* key_mask, void* out, float* lse,
                       int B, int S, int H, int hd, Str qs, Str ks, Str vs,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem(hd);
  cudaError_t e = allow_smem(flash_fwd<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (S + TILE - 1) / TILE);
  flash_fwd<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), key_mask, static_cast<T*>(out), lse, S, H, hd,
      qs, ks, vs, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// Forward. q, k, v: (B, S, H, hd) read through their (b, s, h) element
// strides, head_dim contiguous; key_mask: (B, S) bytes or NULL; out:
// (B, S, H, hd) contiguous in q's dtype; lse: (B, H, S) fp32. dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, float* lse, int B, int S, int H, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, int window, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* km = static_cast<const unsigned char*>(key_mask);
  const Str qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  if (dtype == 0)
    return (int)launch_fwd<float>(q, k, v, km, out, lse, B, S, H, hd, qs, ks,
                                  vs, causal, window, scale, st);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(q, k, v, km, out, lse, B, S, H, hd,
                                          qs, ks, vs, causal, window, scale,
                                          st);
  return (int)cudaErrorInvalidValue;
}

// Backward, fp32. q, k, v, o, dout: (B, S, H, hd) through their strides,
// head_dim contiguous; lse: (B, H, S) from the forward; dq, dk, dv:
// (B, S, H, hd) contiguous. Two launches on the stream (dK/dV, then dQ).
// Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const void* key_mask, const float* lse, float* dq,
    float* dk, float* dv, int B, int S, int H, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long do_sb,
    long long do_ss, long long do_sh, int causal, int window, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* km = static_cast<const unsigned char*>(key_mask);
  const Str qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh}, dos{do_sb, do_ss, do_sh};
  dim3 grid(B * H, (S + TILE - 1) / TILE);

  size_t smem = dkdv_smem(hd);
  cudaError_t e = allow_smem(flash_bwd_dkdv, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv<<<grid, THREADS, smem, st>>>(q, k, v, o, dout, km, lse, dk,
                                              dv, S, H, hd, qs, ks, vs, os,
                                              dos, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  smem = dq_smem(hd);
  e = allow_smem(flash_bwd_dq, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<<<grid, THREADS, smem, st>>>(q, k, v, o, dout, km, lse, dq, S,
                                            H, hd, qs, ks, vs, os, dos, causal,
                                            window, scale);
  return (int)cudaGetLastError();
}
