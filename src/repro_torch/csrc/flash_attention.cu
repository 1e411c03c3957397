// Full-sequence (flash) attention for Hopper (sm_90a), forward and backward,
// on the tensor cores.
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
// the gradients are deterministic). Each warp owns 16 rows, two warps a
// block, and streams 32-row tiles of the other side:
//   flash_fwd        per (batch*head, 32 queries); streams the key tiles
//                    with the online softmax in registers, writes O and,
//                    when asked (training), the fp32 log-sum-exp lse
//                    (B, H, S); inference passes lse = NULL;
//   flash_bwd_dq     runs first: per (batch*head, 32 queries); computes
//                    D = rowsum(dO*O) once per query row into a (B, H, S)
//                    buffer, then streams the key tiles: recomputes
//                    S = QK^T and dP = dO V^T, P = exp(S*scale - lse) and
//                    dS = P (dP - D), accumulates dQ = scale * dS K;
//   flash_bwd_dkdv   runs second: per (batch*head, 32 keys; in the 128
//                    bucket, half the head_dim columns: two accumulators of
//                    16 x 128 a warp would spill); streams the query
//                    tiles that can see them, recomputes S^T = K Q^T
//                    and dP^T = V dO^T with lse and D read from memory,
//                    accumulates dV = P^T dO and dK = scale * dS^T Q.
//
// What bounds it on this card, and the design. At the port's shapes (S <=
// 128, hd 32) a (batch, head) moves 4*S*hd*4 bytes and needs 4*S^2*hd
// flops forward: S/4 flops per byte, so neither the 3.35 TB/s nor the
// tensor cores bound a block; its own chain does: a global load, then
// three or four tiles of dependent products and a softmax. So every
// product runs on the tensor cores, with few instructions between loads:
//   - every product is mma.sync.m16n8k8 with TF32 operands and fp32
//     accumulation. S, P, dS and the O/dQ/dK/dV accumulators stay in
//     registers. The accumulator fragment (rows g, g+8; columns 2t, 2t+1)
//     is not the A fragment's layout (columns t, t+4), so the second
//     product of each pair permutes its k axis instead of moving data:
//     k index t stands for tile row 2t and t+4 for row 2t+1, both in the
//     A fragment taken from the accumulator and in the B fragment read
//     from shared memory. No shuffle, no staging tile;
//   - 3xTF32 for fp32 inputs: each operand x splits into hi = tf32(x) and
//     lo = tf32(x - hi) (cvt.rna), and a product is hi*lo + lo*hi + hi*hi.
//     One TF32 product keeps 11 significant bits, a relative error up to
//     2^-11 (5e-4) per operand, 25x the 2e-5 the forward is held to
//     against its fp32 plain version; the split leaves errors near 2^-22
//     relative (the dropped lo*lo term, lo's own rounding), close to
//     fp32's 2^-24, and the kernels agree with the plain versions within
//     1e-5 at every check shape (chip_smoke.py). bf16 inputs are exact in
//     TF32, so the bf16 forward runs one TF32 product, P rounded to TF32
//     (held to 2e-2);
//   - tiles arrive by 16-byte cp.async, double-buffered: the next tile's
//     copy is issued before the current one is computed; two barriers a
//     tile. Rows past S and head_dim columns past hd arrive as zeros
//     (zero-fill), so every head_dim runs in the next bucket of 16, 32, 64
//     or 128 (a template parameter) with zero-padded fragments. Tensors
//     whose pointer, strides or hd are not whole 16-byte chunks are
//     copied by plain loads instead;
//   - rows are padded by 16 bytes in shared memory: fragment reads of one
//     warp then fall in 32 distinct banks;
//   - a tile whose keys are all masked is skipped (__syncthreads_or), and
//     a key block with no valid key writes zero gradients and returns.
// Q, K, V, O and dO are read in the model's (B, S, H, hd) layout through
// their strides (no transposed copy).
//
// Plain C interface, loaded with ctypes: each launch function returns the
// cudaError_t of its launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper_common.cuh"

namespace {

constexpr int NW = 2;          // warps per block
constexpr int NT = 32 * NW;    // threads per block
constexpr int ROWS = 16 * NW;  // the block's own rows: queries (keys: dK/dV)
constexpr int TILE = 32;       // a streamed tile's rows: keys (queries: dK/dV)
constexpr int NJ = TILE / 8;   // 8-column accumulator tiles across a tile
constexpr unsigned FULL = 0xffffffffu;
static_assert(NT >= TILE && NT >= ROWS, "one thread per row for flags/stats");

struct Str {                   // element strides of a (B, S, H, hd) tensor
  long long b, s, h;
};

// Everything a launch passes its kernels (by value).
struct Params {
  const void *q, *k, *v, *o, *dout;
  const unsigned char* key_mask;
  void* out;
  float *lse, *D, *dq, *dk, *dv;
  Str qs, ks, vs, os, dos;
  int S, H, hd, causal, window, vec;
  float scale;
};

// row pitch of a shared tile in elements: 16 bytes of padding keep rows
// 16-byte aligned and put the 8 rows of a fragment read in distinct banks
template <typename T, int HD>
__host__ __device__ constexpr int pitch() {
  return HD + 16 / (int)sizeof(T);
}

// may query qp see key kp (the key's own validity is checked by the caller)
__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  if (qp >= S) return false;   // padding row of the last query block
  if (causal) {
    if (kp > qp) return false;
    if (window > 0 && kp <= qp - window) return false;
  }
  return true;
}

__device__ __forceinline__ int key_ok(const unsigned char* km, int b, int kp,
                                      int S) {
  return kp < S && (km == nullptr || km[(long long)b * S + kp] != 0);
}

// ---------------------------------------------------------------------------
// asynchronous copies

// rows [r0, r0 + R) of head h of batch b of x (B, S, H, hd) into dst (R,
// pitch) of T; rows past S and columns past hd read as 0
template <typename T, int HD, int R>
__device__ __forceinline__ void load_rows(T* dst, const T* x, Str st, int b,
                                          int h, int r0, int S, int hd,
                                          int vec) {
  constexpr int LD = pitch<T, HD>(), EPC = 16 / (int)sizeof(T),
                CPR = HD / EPC;
  const T* base = x + b * st.b + h * st.h;
  if (vec) {
    for (int i = threadIdx.x; i < R * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * EPC, s = r0 + r;
      const bool ok = s < S && c < hd;
      cp_async16(dst + r * LD + c, ok ? base + s * st.s + c : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * HD; i += NT) {
      const int r = i / HD, d = i % HD, s = r0 + r;
      dst[r * LD + d] =
          s < S && d < hd ? base[s * st.s + d] : from_f<T>(0.f);
    }
  }
}

// the key range a query block [q0, q0 + ROWS) can see: [lo, hi)
__device__ __forceinline__ void key_range(int q0, int S, int causal,
                                          int window, int* lo, int* hi) {
  *lo = 0;
  *hi = S;
  if (causal) {
    *hi = min(S, q0 + ROWS);
    if (window > 0) *lo = max(0, q0 - window + 1);
  }
  *lo = (*lo / TILE) * TILE;
}

// ---------------------------------------------------------------------------
// forward

template <typename T, int HD>
constexpr size_t fwd_smem() {
  return (size_t)(ROWS + 4 * TILE) * pitch<T, HD>() * sizeof(T) +
         2 * TILE * sizeof(int);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd(const __grid_constant__ Params p) {
  constexpr int LD = pitch<T, HD>(), NK = HD / 8;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  const int S = p.S, bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, t = lane_t();
  const T *q = static_cast<const T*>(p.q), *k = static_cast<const T*>(p.k),
          *v = static_cast<const T*>(p.v);

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);   // (ROWS, LD)
  T* k_s = q_s + ROWS * LD;              // 2 x (TILE, LD)
  T* v_s = k_s + 2 * TILE * LD;          // 2 x (TILE, LD)
  int* kv_s = reinterpret_cast<int*>(v_s + 2 * TILE * LD);  // 2 x (TILE,)

  int k_lo, k_hi;
  key_range(q0, S, p.causal, p.window, &k_lo, &k_hi);
  const int ntiles = (k_hi - k_lo + TILE - 1) / TILE;
  // copies of key tile it into buffer it & 1 (one commit group); returns
  // this thread's key flag, stored once the buffer is free
  auto issue = [&](int it) {
    const int buf = it & 1, k0 = k_lo + it * TILE;
    load_rows<T, HD, TILE>(k_s + buf * TILE * LD, k, p.ks, b, h, k0, S,
                           p.hd, p.vec);
    load_rows<T, HD, TILE>(v_s + buf * TILE * LD, v, p.vs, b, h, k0, S,
                           p.hd, p.vec);
    cp_commit();
    return tid < TILE ? key_ok(p.key_mask, b, k0 + tid, S) : 0;
  };
  load_rows<T, HD, ROWS>(q_s, q, p.qs, b, h, q0, S, p.hd, p.vec);
  const int flag0 = issue(0);
  if (tid < TILE) kv_s[tid] = flag0;

  float o[NK][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row = q0 + warp * 16 + lane_g();   // rows row and row + 8
  const bool active = q0 + warp * 16 < S;      // the warp has a real row
  for (int it = 0; it < ntiles; ++it) {
    const int cur = it & 1, k0 = k_lo + it * TILE;
    int next = 0;
    if (it + 1 < ntiles) {
      next = issue(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    // tile `it` is in shared memory; skip it if all its keys are masked
    const int any = __syncthreads_or(tid < TILE && kv_s[cur * TILE + tid]);
    if (any && active) {
      const T* kt = k_s + cur * TILE * LD;
      const T* vt = v_s + cur * TILE * LD;
      const int* kv = kv_s + cur * TILE;
      float s[NJ][4] = {};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        Frag<4> a;
        frag_a<SPLIT>(a, q_s, LD, warp * 16, kk * 8);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          Frag<2> bk;
          frag_b_nk<SPLIT>(bk, kt, LD, j * 8, kk * 8);
          mma3<SPLIT>(s[j], a, bk);
        }
      }
      // mask and scale; the row max across the quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = j * 8 + 2 * t + (e & 1), r = e >> 1;
          const bool ok = kv[kj] && visible(row + 8 * r, k0 + kj, S,
                                            p.causal, p.window);
          s[j][e] = ok ? s[j][e] * p.scale : -INFINITY;
          mx[r] = fmaxf(mx[r], s[j][e]);
        }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // no visible key in the row so far: keep everything as it is
        alpha[r] = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float pe = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m[r]);
          s[j][e] = pe;
          psum[r] += pe;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
      // O += P V
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        Frag<4> a;
        frag_a_acc<SPLIT>(a, s[j]);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          Frag<2> bv;
          frag_b_kn<SPLIT>(bv, vt, LD, j * 8, n * 8);
          mma3<SPLIT>(o[n], a, bv);
        }
      }
    }
    if (it + 1 < ntiles && tid < TILE) kv_s[(cur ^ 1) * TILE + tid] = next;
    __syncthreads();   // buffer `cur` consumed before its next copy
  }

  // out (B, S, H, hd) contiguous; lse (B, H, S) when asked for
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    const int s = row + 8 * r;
    if (s >= S) continue;
    T* orow = static_cast<T*>(p.out) +
              (((long long)b * S + s) * p.H + h) * p.hd;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = n * 8 + 2 * t + c;
        if (d < p.hd)   // no visible key -> 0
          orow[d] = from_f<T>(l[r] > 0.f ? o[n][2 * r + c] / l[r] : 0.f);
      }
    if (p.lse != nullptr && t == 0)
      p.lse[(long long)bh * S + s] =
          l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// backward (fp32)

template <int HD>
constexpr size_t dq_smem() {
  return (size_t)(2 * ROWS + 4 * TILE) * pitch<float, HD>() * sizeof(float) +
         2 * TILE * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const __grid_constant__ Params p) {
  constexpr int LD = pitch<float, HD>(), NK = HD / 8;
  const int S = p.S, bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5,
            g = lane_g(), t = lane_t();
  const float *q = static_cast<const float*>(p.q),
              *k = static_cast<const float*>(p.k),
              *v = static_cast<const float*>(p.v),
              *o = static_cast<const float*>(p.o),
              *dout = static_cast<const float*>(p.dout);

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);   // (ROWS, LD)
  float* do_s = q_s + ROWS * LD;                 // (ROWS, LD)
  float* k_s = do_s + ROWS * LD;                 // 2 x (TILE, LD)
  float* v_s = k_s + 2 * TILE * LD;              // 2 x (TILE, LD)
  int* kv_s = reinterpret_cast<int*>(v_s + 2 * TILE * LD);  // 2 x (TILE,)

  int k_lo, k_hi;
  key_range(q0, S, p.causal, p.window, &k_lo, &k_hi);
  const int ntiles = (k_hi - k_lo + TILE - 1) / TILE;
  auto issue = [&](int it) {
    const int buf = it & 1, k0 = k_lo + it * TILE;
    load_rows<float, HD, TILE>(k_s + buf * TILE * LD, k, p.ks, b, h, k0, S,
                               p.hd, p.vec);
    load_rows<float, HD, TILE>(v_s + buf * TILE * LD, v, p.vs, b, h, k0, S,
                               p.hd, p.vec);
    cp_commit();
    return tid < TILE ? key_ok(p.key_mask, b, k0 + tid, S) : 0;
  };
  load_rows<float, HD, ROWS>(q_s, q, p.qs, b, h, q0, S, p.hd, p.vec);
  load_rows<float, HD, ROWS>(do_s, dout, p.dos, b, h, q0, S, p.hd, p.vec);
  cp_commit();
  const int flag0 = issue(0);
  if (tid < TILE) kv_s[tid] = flag0;
  cp_wait<1>();   // Q and dO have arrived
  __syncthreads();

  // D = rowsum(dO * O) of the warp's 16 rows, once per query row: two
  // lanes per row; written out for the dK/dV kernel
  const int row = q0 + warp * 16 + g;   // rows row and row + 8
  float D_r[2], lse_r[2];
  {
    const int r = warp * 16 + (lane >> 1), s = q0 + r;
    float acc = 0.f;
    if (s < S) {
      const float* orow = o + b * p.os.b + s * p.os.s + h * p.os.h;
      const float* drow = do_s + r * LD;
      for (int d = lane & 1; d < p.hd; d += 2)
        acc = fmaf(drow[d], orow[d], acc);
    }
    acc += __shfl_xor_sync(FULL, acc, 1);
    if ((lane & 1) == 0 && s < S) p.D[(long long)bh * S + s] = acc;
    D_r[0] = __shfl_sync(FULL, acc, 2 * g);
    D_r[1] = __shfl_sync(FULL, acc, 2 * (g + 8));
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lse_r[i] = row + 8 * i < S ? p.lse[(long long)bh * S + row + 8 * i]
                                 : 0.f;
  }

  float dqa[NK][4] = {};
  const bool active = q0 + warp * 16 < S;
  for (int it = 0; it < ntiles; ++it) {
    const int cur = it & 1, k0 = k_lo + it * TILE;
    int next = 0;
    if (it + 1 < ntiles) {
      next = issue(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    const int any = __syncthreads_or(tid < TILE && kv_s[cur * TILE + tid]);
    if (any && active) {
      const float* kt = k_s + cur * TILE * LD;
      const float* vt = v_s + cur * TILE * LD;
      const int* kv = kv_s + cur * TILE;
      float s[NJ][4] = {}, dp[NJ][4] = {};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        Frag<4> aq, ado;
        frag_a<true>(aq, q_s, LD, warp * 16, kk * 8);
        frag_a<true>(ado, do_s, LD, warp * 16, kk * 8);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          Frag<2> bk, bv;
          frag_b_nk<true>(bk, kt, LD, j * 8, kk * 8);
          mma3<true>(s[j], aq, bk);
          frag_b_nk<true>(bv, vt, LD, j * 8, kk * 8);
          mma3<true>(dp[j], ado, bv);
        }
      }
      // P = exp(S * scale - lse) on visible pairs, 0 elsewhere;
      // dS = P (dP - D), into s
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = j * 8 + 2 * t + (e & 1), r = e >> 1;
          const bool ok = kv[kj] && visible(row + 8 * r, k0 + kj, S,
                                            p.causal, p.window);
          const float pe = ok ? expf(s[j][e] * p.scale - lse_r[r]) : 0.f;
          s[j][e] = pe * (dp[j][e] - D_r[r]);
        }
      // dQ += dS K
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        Frag<4> a;
        frag_a_acc<true>(a, s[j]);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          Frag<2> bk;
          frag_b_kn<true>(bk, kt, LD, j * 8, n * 8);
          mma3<true>(dqa[n], a, bk);
        }
      }
    }
    if (it + 1 < ntiles && tid < TILE) kv_s[(cur ^ 1) * TILE + tid] = next;
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row + 8 * r;
    if (s >= S) continue;
    float* drow = p.dq + (((long long)b * S + s) * p.H + h) * p.hd;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = n * 8 + 2 * t + c;
        if (d < p.hd) drow[d] = dqa[n][2 * r + c] * p.scale;
      }
  }
}

// blocks that share the head_dim columns of a dK/dV row block: two in the
// 128 bucket, where a warp's two (16, 128) accumulators alone would take
// 128 registers a thread; each recomputes S^T and dP^T in full
template <int HD>
__host__ __device__ constexpr int dkdv_splits() {
  return HD > 64 ? 2 : 1;
}

template <int HD>
constexpr size_t dkdv_smem() {
  return (size_t)(2 * ROWS + 4 * TILE) * pitch<float, HD>() * sizeof(float) +
         (4 * TILE + ROWS) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const __grid_constant__ Params p) {
  constexpr int LD = pitch<float, HD>(), NK = HD / 8,
                NC = NK / dkdv_splits<HD>();   // the block's column tiles
  const int c0 = blockIdx.z * NC;
  const int S = p.S, bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int k0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, g = lane_g(), t = lane_t();
  const float *q = static_cast<const float*>(p.q),
              *k = static_cast<const float*>(p.k),
              *v = static_cast<const float*>(p.v),
              *dout = static_cast<const float*>(p.dout);

  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);   // (ROWS, LD)
  float* v_s = k_s + ROWS * LD;                  // (ROWS, LD)
  float* q_s = v_s + ROWS * LD;                  // 2 x (TILE, LD)
  float* do_s = q_s + 2 * TILE * LD;               // 2 x (TILE, LD)
  float* lse_s = do_s + 2 * TILE * LD;             // 2 x (TILE,)
  float* D_s = lse_s + 2 * TILE;                   // 2 x (TILE,)
  int* kv_s = reinterpret_cast<int*>(D_s + 2 * TILE);   // (ROWS,)

  const int flag = tid < ROWS ? key_ok(p.key_mask, b, k0 + tid, S) : 0;
  if (tid < ROWS) kv_s[tid] = flag;
  if (!__syncthreads_or(flag)) {   // a block of masked keys: zero gradient
    for (int i = tid; i < ROWS * p.hd; i += NT) {
      const int j = i / p.hd, d = i - j * p.hd, s = k0 + j;
      if (s < S) {
        const long long at = (((long long)b * S + s) * p.H + h) * p.hd + d;
        p.dk[at] = 0.f;
        p.dv[at] = 0.f;
      }
    }
    return;
  }

  // the query range that can see keys [k0, k0 + ROWS)
  int q_lo = 0, q_hi = S;
  if (p.causal) {
    q_lo = k0;
    if (p.window > 0) q_hi = min(S, k0 + ROWS - 1 + p.window);
  }
  q_lo = (q_lo / TILE) * TILE;
  const int ntiles = (q_hi - q_lo + TILE - 1) / TILE;
  // copies of query tile it into buffer it & 1; returns this thread's row
  // statistics (lse, D), stored once the buffer is free
  auto issue = [&](int it) {
    const int buf = it & 1, q0 = q_lo + it * TILE;
    load_rows<float, HD, TILE>(q_s + buf * TILE * LD, q, p.qs, b, h, q0, S,
                               p.hd, p.vec);
    load_rows<float, HD, TILE>(do_s + buf * TILE * LD, dout, p.dos, b, h,
                               q0, S, p.hd, p.vec);
    cp_commit();
    const int s = q0 + tid;
    return tid < TILE && s < S
               ? make_float2(p.lse[(long long)bh * S + s],
                             p.D[(long long)bh * S + s])
               : make_float2(0.f, 0.f);
  };
  load_rows<float, HD, ROWS>(k_s, k, p.ks, b, h, k0, S, p.hd, p.vec);
  load_rows<float, HD, ROWS>(v_s, v, p.vs, b, h, k0, S, p.hd, p.vec);
  const float2 stat0 = issue(0);   // one group: K, V and query tile 0
  if (tid < TILE) {
    lse_s[tid] = stat0.x;
    D_s[tid] = stat0.y;
  }

  const int key = k0 + warp * 16 + g;   // keys key and key + 8
  const int kv_r[2] = {kv_s[warp * 16 + g], kv_s[warp * 16 + g + 8]};
  const bool active = __any_sync(FULL, kv_r[0] | kv_r[1]);
  float dka[NC][4] = {}, dva[NC][4] = {};
  for (int it = 0; it < ntiles; ++it) {
    const int cur = it & 1, q0 = q_lo + it * TILE;
    float2 next = make_float2(0.f, 0.f);
    if (it + 1 < ntiles) {
      next = issue(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* qt = q_s + cur * TILE * LD;
      const float* dot = do_s + cur * TILE * LD;
      const float* ls = lse_s + cur * TILE;
      const float* Ds = D_s + cur * TILE;
      float st[NJ][4] = {}, dpt[NJ][4] = {};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        Frag<4> ak, av;
        frag_a<true>(ak, k_s, LD, warp * 16, kk * 8);
        frag_a<true>(av, v_s, LD, warp * 16, kk * 8);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          Frag<2> bq, bd;
          frag_b_nk<true>(bq, qt, LD, j * 8, kk * 8);
          mma3<true>(st[j], ak, bq);
          frag_b_nk<true>(bd, dot, LD, j * 8, kk * 8);
          mma3<true>(dpt[j], av, bd);
        }
      }
      // P^T and dS^T = P^T (dP^T - D) on visible pairs, 0 elsewhere
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qj = j * 8 + 2 * t + (e & 1), r = e >> 1;
          const bool ok = kv_r[r] && visible(q0 + qj, key + 8 * r, S,
                                             p.causal, p.window);
          const float pe = ok ? expf(st[j][e] * p.scale - ls[qj]) : 0.f;
          st[j][e] = pe;
          dpt[j][e] = pe * (dpt[j][e] - Ds[qj]);
        }
      // dV += P^T dO, dK += dS^T Q on the block's columns
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        Frag<4> ap, ads;
        frag_a_acc<true>(ap, st[j]);
        frag_a_acc<true>(ads, dpt[j]);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          Frag<2> bd, bq;
          frag_b_kn<true>(bd, dot, LD, j * 8, (c0 + n) * 8);
          mma3<true>(dva[n], ap, bd);
          frag_b_kn<true>(bq, qt, LD, j * 8, (c0 + n) * 8);
          mma3<true>(dka[n], ads, bq);
        }
      }
    }
    if (it + 1 < ntiles && tid < TILE) {
      lse_s[(cur ^ 1) * TILE + tid] = next.x;
      D_s[(cur ^ 1) * TILE + tid] = next.y;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = key + 8 * r;
    if (s >= S) continue;
    const long long at = (((long long)b * S + s) * p.H + h) * p.hd;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = (c0 + n) * 8 + 2 * t + c;
        if (d < p.hd) {
          p.dk[at + d] = dka[n][2 * r + c] * p.scale;
          p.dv[at + d] = dva[n][2 * r + c];
        }
      }
  }
}

// ---------------------------------------------------------------------------
// launches

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// may every tile row be copied in 16-byte chunks: pointers 16-byte
// aligned, strides and hd whole chunks of `epc` elements
int whole_chunks(int epc, int hd, std::initializer_list<const void*> ptrs,
                 std::initializer_list<Str> strides) {
  if (hd % epc) return 0;
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return 0;
  for (const Str& st : strides)
    if (st.b % epc || st.s % epc || st.h % epc) return 0;
  return 1;
}

template <typename T, int HD>
cudaError_t launch_fwd(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = fwd_smem<T, HD>();
  cudaError_t e = allow_smem(flash_fwd<T, HD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.H, (p.S + ROWS - 1) / ROWS);
  flash_fwd<T, HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_bucket(const Params& p, int B, cudaStream_t stream) {
  if (p.hd <= 16) return launch_fwd<T, 16>(p, B, stream);
  if (p.hd <= 32) return launch_fwd<T, 32>(p, B, stream);
  if (p.hd <= 64) return launch_fwd<T, 64>(p, B, stream);
  if (p.hd <= 128) return launch_fwd<T, 128>(p, B, stream);
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_bwd(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid(B * p.H, (p.S + ROWS - 1) / ROWS),
      grid_kv(grid.x, grid.y, dkdv_splits<HD>());
  size_t smem = dq_smem<HD>();
  cudaError_t e = allow_smem(flash_bwd_dq<HD>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dq<HD><<<grid, NT, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  smem = dkdv_smem<HD>();
  e = allow_smem(flash_bwd_dkdv<HD>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv<HD><<<grid_kv, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t bwd_bucket(const Params& p, int B, cudaStream_t stream) {
  if (p.hd <= 16) return launch_bwd<16>(p, B, stream);
  if (p.hd <= 32) return launch_bwd<32>(p, B, stream);
  if (p.hd <= 64) return launch_bwd<64>(p, B, stream);
  if (p.hd <= 128) return launch_bwd<128>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Forward. q, k, v: (B, S, H, hd) read through their (b, s, h) element
// strides, head_dim contiguous; key_mask: (B, S) bytes or NULL; out:
// (B, S, H, hd) contiguous in q's dtype; lse: (B, H, S) fp32, or NULL when
// no backward follows. dtype: 0 = float32, 1 = bfloat16. hd <= 128.
// Returns a cudaError_t.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, float* lse, int B, int S, int H, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, int window, float scale, int dtype, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.key_mask = static_cast<const unsigned char*>(key_mask);
  p.out = out;
  p.lse = lse;
  p.qs = Str{q_sb, q_ss, q_sh};
  p.ks = Str{k_sb, k_ss, k_sh};
  p.vs = Str{v_sb, v_ss, v_sh};
  p.S = S;
  p.H = H;
  p.hd = hd;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    p.vec = whole_chunks(4, hd, {q, k, v}, {p.qs, p.ks, p.vs});
    return (int)fwd_bucket<float>(p, B, st);
  }
  if (dtype == 1) {
    p.vec = whole_chunks(8, hd, {q, k, v}, {p.qs, p.ks, p.vs});
    return (int)fwd_bucket<__nv_bfloat16>(p, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Backward, fp32. q, k, v, o, dout: (B, S, H, hd) through their strides,
// head_dim contiguous; lse: (B, H, S) from the forward; D: (B, H, S) fp32
// scratch the dQ kernel fills with rowsum(dO * O) for the dK/dV kernel;
// dq, dk, dv: (B, S, H, hd) contiguous. Two launches on the stream (dQ,
// then dK/dV). hd <= 128. Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const void* key_mask, const float* lse, float* D,
    float* dq, float* dk, float* dv, int B, int S, int H, int hd,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, int causal,
    int window, float scale, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.key_mask = static_cast<const unsigned char*>(key_mask);
  p.lse = const_cast<float*>(lse);
  p.D = D;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.qs = Str{q_sb, q_ss, q_sh};
  p.ks = Str{k_sb, k_ss, k_sh};
  p.vs = Str{v_sb, v_ss, v_sh};
  p.os = Str{o_sb, o_ss, o_sh};
  p.dos = Str{do_sb, do_ss, do_sh};
  p.S = S;
  p.H = H;
  p.hd = hd;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  // O is read by plain loads (for D), so only the tiled tensors count
  p.vec = whole_chunks(4, hd, {q, k, v, dout}, {p.qs, p.ks, p.vs, p.dos});
  return (int)bwd_bucket(p, B, static_cast<cudaStream_t>(stream));
}
