// The backward of the full-sequence (flash) attention for Hopper (sm_90a),
// fp32: flash_bwd_dq, then flash_bwd_dkdv. The design (the GQA head
// mapping, the masks, 3xTF32 products, the tiles) is described in
// csrc/flash_attention.cu; the shared pieces are in flash_attention.cuh.
//
// Plain C interface, loaded with ctypes: the launch function returns the
// cudaError_t of its launches (0 = success).

#include "flash_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// backward (fp32)

template <int HD>
constexpr size_t dq_smem() {
  return (size_t)(2 * ROWS + 4 * TILE) * pitch<float, HD>() * sizeof(float) +
         4 * TILE * sizeof(int);
}

template <int HD, bool POS>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const __grid_constant__ Params p) {
  constexpr int LD = pitch<float, HD>(), NK = HD / 8;
  // grid (B * Hkv, query blocks, q_per_kv): query head h of kv head hk
  const int S = p.S, b = blockIdx.x / p.Hkv, hk = blockIdx.x - b * p.Hkv,
            h = hk * p.qpk + blockIdx.z, bh = b * p.H + h;
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
  int* kp_s = kv_s + 2 * TILE;   // 2 x (TILE,) key positions (POS)

  int k_lo, k_hi;
  key_range(q0, S, p.causal, p.window, POS, &k_lo, &k_hi);
  const int ntiles = (k_hi - k_lo + TILE - 1) / TILE;
  auto issue = [&](int it) {
    const int buf = it & 1, k0 = k_lo + it * TILE;
    load_rows<float, HD, TILE>(k_s + buf * TILE * LD, k, p.ks, b, hk, k0, S,
                               p.hd, p.vec);
    load_rows<float, HD, TILE>(v_s + buf * TILE * LD, v, p.vs, b, hk, k0, S,
                               p.hd, p.vec);
    cp_commit();
    return tid < TILE ? key_ok(p.key_mask, b, k0 + tid, S) : 0;
  };
  // this thread's key position in tile it (POS)
  auto key_pos = [&](int it) {
    return tid < TILE ? row_pos<POS>(p.k_pos, b, k_lo + it * TILE + tid, S)
                      : 0;
  };
  load_rows<float, HD, ROWS>(q_s, q, p.qs, b, h, q0, S, p.hd, p.vec);
  load_rows<float, HD, ROWS>(do_s, dout, p.dos, b, h, q0, S, p.hd, p.vec);
  cp_commit();
  const int flag0 = issue(0);
  if (tid < TILE) {
    kv_s[tid] = flag0;
    if (POS) kp_s[tid] = key_pos(0);
  }
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
  const int qp_r[2] = {row_pos<POS>(p.q_pos, b, row, S),
                       row_pos<POS>(p.q_pos, b, row + 8, S)};
  const bool active = q0 + warp * 16 < S;
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
    const int any = __syncthreads_or(tid < TILE && kv_s[cur * TILE + tid]);
    if (any && active) {
      const float* kt = k_s + cur * TILE * LD;
      const float* vt = v_s + cur * TILE * LD;
      const int* kv = kv_s + cur * TILE;
      const int* kp = kp_s + cur * TILE;
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
          const bool ok = kv[kj] && visible(row + 8 * r, qp_r[r],
                                            POS ? kp[kj] : k0 + kj, S,
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
    if (it + 1 < ntiles && tid < TILE) {
      kv_s[(cur ^ 1) * TILE + tid] = next;
      if (POS) kp_s[(cur ^ 1) * TILE + tid] = next_pos;
    }
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
         (6 * TILE + ROWS) * sizeof(float);
}

// a query tile's row statistics as the dK/dV kernel reads them
struct RowStat {
  float lse, D;
  int qp;   // the row's position (POS)
};

// blocks an SM must hold: at hd <= 32 (the MT's bucket) eight, i.e. at most
// the 128 registers a thread the single-head kernel had (left free, ptxas
// gave the instance 148 once the group loop came in: six blocks an SM)
template <int HD>
__host__ __device__ constexpr int dkdv_min_blocks() {
  return HD <= 32 ? 8 : 1;
}

// GQA: the block loops over a group of several query heads; without it
// (q_per_kv 1) the kernel is the single-head code
template <int HD, bool POS, bool GQA>
__global__ void __launch_bounds__(NT, dkdv_min_blocks<HD>())
flash_bwd_dkdv(const __grid_constant__ Params p) {
  constexpr int LD = pitch<float, HD>(), NK = HD / 8,
                NC = NK / dkdv_splits<HD>();   // the block's column tiles
  const int c0 = blockIdx.z * NC;
  // the block's kv head hk and the query heads of its group
  const int S = p.S, bk = blockIdx.x, b = bk / p.Hkv, hk = bk - b * p.Hkv,
            h0 = hk * p.qpk;
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
  int* qp_s = reinterpret_cast<int*>(D_s + 2 * TILE);   // 2 x (TILE,) (POS)
  int* kv_s = qp_s + 2 * TILE;                     // (ROWS,)

  const int flag = tid < ROWS ? key_ok(p.key_mask, b, k0 + tid, S) : 0;
  if (tid < ROWS) kv_s[tid] = flag;
  if (!__syncthreads_or(flag)) {   // a block of masked keys: zero gradient
    for (int i = tid; i < ROWS * p.hd; i += NT) {
      const int j = i / p.hd, d = i - j * p.hd, s = k0 + j;
      if (s < S) {
        const long long at =
            (((long long)b * S + s) * p.Hkv + hk) * p.hd + d;
        p.dk[at] = 0.f;
        p.dv[at] = 0.f;
      }
    }
    return;
  }

  // the query range that can see keys [k0, k0 + ROWS): every query with
  // positions
  int q_lo = 0, q_hi = S;
  if (p.causal && !POS) {
    q_lo = k0;
    if (p.window > 0) q_hi = min(S, k0 + ROWS - 1 + p.window);
  }
  q_lo = (q_lo / TILE) * TILE;
  const int ntiles = (q_hi - q_lo + TILE - 1) / TILE;
  // copies of query tile it of query head h into buffer it & 1; returns
  // this thread's row statistics, stored once the buffer is free
  auto issue = [&](int h, int it) {
    const int buf = it & 1, q0 = q_lo + it * TILE;
    load_rows<float, HD, TILE>(q_s + buf * TILE * LD, q, p.qs, b, h, q0, S,
                               p.hd, p.vec);
    load_rows<float, HD, TILE>(do_s + buf * TILE * LD, dout, p.dos, b, h,
                               q0, S, p.hd, p.vec);
    cp_commit();
    const int s = q0 + tid;
    const long long bh = (long long)b * p.H + h;
    RowStat st{0.f, 0.f, 0};
    if (tid < TILE && s < S) {
      st.lse = p.lse[bh * S + s];
      st.D = p.D[bh * S + s];
      st.qp = row_pos<POS>(p.q_pos, b, s, S);
    }
    return st;
  };
  load_rows<float, HD, ROWS>(k_s, k, p.ks, b, hk, k0, S, p.hd, p.vec);
  load_rows<float, HD, ROWS>(v_s, v, p.vs, b, hk, k0, S, p.hd, p.vec);
  const RowStat stat0 = issue(h0, 0);   // one group: K, V and query tile 0
  if (tid < TILE) {
    lse_s[tid] = stat0.lse;
    D_s[tid] = stat0.D;
    if (POS) qp_s[tid] = stat0.qp;
  }

  const int key = k0 + warp * 16 + g;   // keys key and key + 8
  const int kv_r[2] = {kv_s[warp * 16 + g], kv_s[warp * 16 + g + 8]};
  const int kp_r[2] = {row_pos<POS>(p.k_pos, b, key, S),
                       row_pos<POS>(p.k_pos, b, key + 8, S)};
  const bool active = __any_sync(FULL, kv_r[0] | kv_r[1]);
  float dka[NC][4] = {}, dva[NC][4] = {};
  // query head h's tiles into the accumulators (tile 0 already issued)
  auto stream_head = [&](int h) {
    for (int it = 0; it < ntiles; ++it) {
      const int cur = it & 1, q0 = q_lo + it * TILE;
      RowStat next{0.f, 0.f, 0};
      if (it + 1 < ntiles) {
        next = issue(h, it + 1);
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
        const int* qps = qp_s + cur * TILE;
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
            const bool ok = kv_r[r] && visible(q0 + qj,
                                               POS ? qps[qj] : q0 + qj,
                                               kp_r[r], S, p.causal, p.window);
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
        lse_s[(cur ^ 1) * TILE + tid] = next.lse;
        D_s[(cur ^ 1) * TILE + tid] = next.D;
        if (POS) qp_s[(cur ^ 1) * TILE + tid] = next.qp;
      }
      __syncthreads();
    }
  };
  stream_head(h0);
  // with GQA, the group's other query heads in turn (the last barrier
  // freed buffer 0); a loop around the single-head stream slowed the MT's
  // instance (its trip count of one was not folded away)
  for (int h = h0 + 1; GQA && h < h0 + p.qpk; ++h) {
    const RowStat st = issue(h, 0);
    if (tid < TILE) {
      lse_s[tid] = st.lse;
      D_s[tid] = st.D;
      if (POS) qp_s[tid] = st.qp;
    }
    stream_head(h);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = key + 8 * r;
    if (s >= S) continue;
    const long long at = (((long long)b * S + s) * p.Hkv + hk) * p.hd;
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

template <int HD, bool POS, bool GQA>
cudaError_t launch_bwd(const Params& p, int B, cudaStream_t stream) {
  // dQ: a block per (batch*kv head, 32 queries, query head of the
  // group); dK/dV: per (batch*kv head, 32 keys, column split)
  const dim3 grid(B * p.Hkv, (p.S + ROWS - 1) / ROWS, p.qpk),
      grid_kv(B * p.Hkv, grid.y, dkdv_splits<HD>());
  size_t smem = dq_smem<HD>();
  cudaError_t e = allow_smem(flash_bwd_dq<HD, POS>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dq<HD, POS><<<grid, NT, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  smem = dkdv_smem<HD>();
  e = allow_smem(flash_bwd_dkdv<HD, POS, GQA>, smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv<HD, POS, GQA><<<grid_kv, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool POS, bool GQA>
cudaError_t bwd_bucket(const Params& p, int B, cudaStream_t stream) {
  if (p.hd <= 16) return launch_bwd<16, POS, GQA>(p, B, stream);
  if (p.hd <= 32) return launch_bwd<32, POS, GQA>(p, B, stream);
  if (p.hd <= 64) return launch_bwd<64, POS, GQA>(p, B, stream);
  if (p.hd <= 128) return launch_bwd<128, POS, GQA>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Backward, fp32. q, o, dout: (B, S, H, hd), k, v: (B, S, Hkv, hd) through
// their strides, head_dim contiguous; key_mask, q_pos, k_pos as for the
// forward; lse: (B, H, S) from the forward; D: (B, H, S) fp32 scratch the
// dQ kernel fills with rowsum(dO * O) for the dK/dV kernel; dq: (B, S, H,
// hd), dk, dv: (B, S, Hkv, hd), contiguous. Two launches on the stream
// (dQ, then dK/dV). hd <= 128. Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const void* key_mask, const void* q_pos,
    const void* k_pos, const float* lse, float* D, float* dq, float* dk,
    float* dv, int B, int S, int H, int Hkv, int hd,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, int causal,
    int window, float scale, void* stream) {
  Params p{};
  if (!set_heads(p, H, Hkv, q_pos, k_pos)) return (int)cudaErrorInvalidValue;
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
  p.hd = hd;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  // O is read by plain loads (for D), so only the tiled tensors count
  p.vec = whole_chunks(4, hd, {q, k, v, dout}, {p.qs, p.ks, p.vs, p.dos});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the position-masked instances always take the group loop
  if (p.q_pos) return (int)bwd_bucket<true, true>(p, B, st);
  return (int)(p.qpk > 1 ? bwd_bucket<false, true>(p, B, st)
                         : bwd_bucket<false, false>(p, B, st));
}
