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
// Grouped-query attention: q has H heads, k and v Kv heads (H % Kv == 0,
// q_per_kv = H / Kv); query head h reads kv head h / q_per_kv, the JAX
// package's (Kv, q_per_kv) split of the heads. The decoder-only models
// train through it (SmolLM-135M: 9 query heads over 3 kv heads).
//
// Masking: a key is visible to a query when it lies inside the sequence,
// its key_mask entry (B, S) is set (NULL = every key valid: the TPU
// kernel's contract), and, when causal, kpos <= qpos and, with window > 0,
// kpos > qpos - window. Positions are the indices, or with q_pos / k_pos
// (B, S) int32 (the JAX model's attention(positions=)) the stored ones.
// Invisible keys get exactly 0 weight. A query row with no visible key
// outputs 0, stores lse = -inf and receives zero gradient (the TPU kernel
// averages V over its padded tile there).
//
// Three kernels, three launches per forward plus backward, no atomics (so
// the gradients are deterministic). Each warp owns 16 rows, two warps a
// block, and streams 32-row tiles of the other side:
//   flash_fwd        per (batch, head, 32 queries); streams the key tiles
//                    of the head's kv head with the online softmax in
//                    registers, writes O and, when asked (training), the
//                    fp32 log-sum-exp lse (B, H, S); inference passes
//                    lse = NULL;
//   flash_bwd_dq     runs first: per (batch, head, 32 queries); computes
//                    D = rowsum(dO*O) once per query row into a (B, H, S)
//                    buffer, then streams the key tiles: recomputes
//                    S = QK^T and dP = dO V^T, P = exp(S*scale - lse) and
//                    dS = P (dP - D), accumulates dQ = scale * dS K;
//   flash_bwd_dkdv   runs second: per (batch*kv head, 32 keys; in the 128
//                    bucket, half the head_dim columns: two accumulators of
//                    16 x 128 a warp would spill); streams, for each query
//                    head of the kv head's group in turn, the query tiles
//                    that can see the keys, recomputes S^T = K Q^T and
//                    dP^T = V dO^T with lse and D read from memory, and
//                    accumulates dV = P^T dO and dK = scale * dS^T Q over
//                    the whole group in registers: the group's sum needs
//                    no float atomics and no second pass.
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
//     a key block with no valid key writes zero gradients and returns;
//   - without positions a causal or windowed block streams only the tiles
//     its rows can see (key_range, and its mirror in dK/dV). With positions
//     (a template flag, POS) nothing orders the keys by position, so every
//     tile streams and the positions decide; without them the kernels are
//     the index-masked code, unchanged. POS is built for fp32 only: the
//     models pass positions only where they train, in fp32.
// Q, K, V, O and dO are read in the model's (B, S, H, hd) layout through
// their strides (no transposed copy).
//
// The forward is this file; the backward kernels are in
// flash_attention_bwd.cu, and what both use in flash_attention.cuh (two
// sources, so that nvcc compiles their instances in parallel).
//
// Plain C interface, loaded with ctypes: each launch function returns the
// cudaError_t of its launches (0 = success).

#include "flash_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// forward

template <typename T, int HD>
constexpr size_t fwd_smem() {
  return (size_t)(ROWS + 4 * TILE) * pitch<T, HD>() * sizeof(T) +
         4 * TILE * sizeof(int);
}

template <typename T, int HD, bool POS>
__global__ void __launch_bounds__(NT)
flash_fwd(const __grid_constant__ Params p) {
  constexpr int LD = pitch<T, HD>(), NK = HD / 8;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  // grid (B * Hkv, query blocks, q_per_kv): query head h of kv head hk
  const int S = p.S, b = blockIdx.x / p.Hkv, hk = blockIdx.x - b * p.Hkv,
            h = hk * p.qpk + blockIdx.z, bh = b * p.H + h;
  const int q0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, t = lane_t();
  const T *q = static_cast<const T*>(p.q), *k = static_cast<const T*>(p.k),
          *v = static_cast<const T*>(p.v);

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);   // (ROWS, LD)
  T* k_s = q_s + ROWS * LD;              // 2 x (TILE, LD)
  T* v_s = k_s + 2 * TILE * LD;          // 2 x (TILE, LD)
  int* kv_s = reinterpret_cast<int*>(v_s + 2 * TILE * LD);  // 2 x (TILE,)
  int* kp_s = kv_s + 2 * TILE;   // 2 x (TILE,) key positions (POS)

  int k_lo, k_hi;
  key_range(q0, S, p.causal, p.window, POS, &k_lo, &k_hi);
  const int ntiles = (k_hi - k_lo + TILE - 1) / TILE;
  // copies of key tile it into buffer it & 1 (one commit group); returns
  // this thread's key flag, stored once the buffer is free
  auto issue = [&](int it) {
    const int buf = it & 1, k0 = k_lo + it * TILE;
    load_rows<T, HD, TILE>(k_s + buf * TILE * LD, k, p.ks, b, hk, k0, S,
                           p.hd, p.vec);
    load_rows<T, HD, TILE>(v_s + buf * TILE * LD, v, p.vs, b, hk, k0, S,
                           p.hd, p.vec);
    cp_commit();
    return tid < TILE ? key_ok(p.key_mask, b, k0 + tid, S) : 0;
  };
  // this thread's key position in tile it (POS)
  auto key_pos = [&](int it) {
    return tid < TILE ? row_pos<POS>(p.k_pos, b, k_lo + it * TILE + tid, S)
                      : 0;
  };
  load_rows<T, HD, ROWS>(q_s, q, p.qs, b, h, q0, S, p.hd, p.vec);
  const int flag0 = issue(0);
  if (tid < TILE) {
    kv_s[tid] = flag0;
    if (POS) kp_s[tid] = key_pos(0);
  }

  float o[NK][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row = q0 + warp * 16 + lane_g();   // rows row and row + 8
  const int qp_r[2] = {row_pos<POS>(p.q_pos, b, row, S),
                       row_pos<POS>(p.q_pos, b, row + 8, S)};
  const bool active = q0 + warp * 16 < S;      // the warp has a real row
  for (int it = 0; it < ntiles; ++it) {
    const int cur = it & 1, k0 = k_lo + it * TILE;
    int next = 0, next_pos = 0;
    if (it + 1 < ntiles) {
      next = issue(it + 1);
      if (POS) next_pos = key_pos(it + 1);
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
      const int* kp = kp_s + cur * TILE;
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
          const bool ok = kv[kj] && visible(row + 8 * r, qp_r[r],
                                            POS ? kp[kj] : k0 + kj, S,
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
    if (it + 1 < ntiles && tid < TILE) {
      kv_s[(cur ^ 1) * TILE + tid] = next;
      if (POS) kp_s[(cur ^ 1) * TILE + tid] = next_pos;
    }
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
// launches

template <typename T, int HD, bool POS>
cudaError_t launch_fwd(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = fwd_smem<T, HD>();
  cudaError_t e = allow_smem(flash_fwd<T, HD, POS>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.Hkv, (p.S + ROWS - 1) / ROWS, p.qpk);
  flash_fwd<T, HD, POS><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool POS>
cudaError_t fwd_bucket(const Params& p, int B, cudaStream_t stream) {
  if (p.hd <= 16) return launch_fwd<T, 16, POS>(p, B, stream);
  if (p.hd <= 32) return launch_fwd<T, 32, POS>(p, B, stream);
  if (p.hd <= 64) return launch_fwd<T, 64, POS>(p, B, stream);
  if (p.hd <= 128) return launch_fwd<T, 128, POS>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Forward. q: (B, S, H, hd), k, v: (B, S, Hkv, hd), read through their
// (b, s, h) element strides, head_dim contiguous; key_mask: (B, S) bytes or
// NULL; q_pos, k_pos: (B, S) int32, both or neither (NULL: the indices;
// fp32 only); out: (B, S, H, hd) contiguous in q's dtype; lse: (B, H, S)
// fp32, or NULL when no backward follows. dtype: 0 = float32, 1 =
// bfloat16. hd <= 128, H % Hkv == 0. Returns a cudaError_t.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* q_pos, const void* k_pos, void* out, float* lse, int B,
    int S, int H, int Hkv, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float scale, int dtype, void* stream) {
  Params p{};
  if (!set_heads(p, H, Hkv, q_pos, k_pos)) return (int)cudaErrorInvalidValue;
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
  p.hd = hd;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    p.vec = whole_chunks(4, hd, {q, k, v}, {p.qs, p.ks, p.vs});
    return (int)(p.q_pos ? fwd_bucket<float, true>(p, B, st)
                         : fwd_bucket<float, false>(p, B, st));
  }
  if (dtype == 1 && p.q_pos == nullptr) {
    p.vec = whole_chunks(8, hd, {q, k, v}, {p.qs, p.ks, p.vs});
    return (int)fwd_bucket<__nv_bfloat16, false>(p, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

