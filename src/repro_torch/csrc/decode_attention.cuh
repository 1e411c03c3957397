// The shared body of the port's cached (decode) attention kernels for Hopper
// (sm_90a): decode_gqa.cu reads a dense (B, S, Kv, hd) cache, and
// paged_decode_gqa.cu a (P, ps, Kv, hd) pool through a block table. Each
// source defines a key-address policy (where key s of row b lives, and its
// stored position) and instantiates decode_attention_kernel on it.
//
// What it computes. The T fed queries of row b (q: (B, T, H, hd)) attend
// to the row's keys, masked on their stored positions: -1 = empty slot,
// causal k_pos <= q_pos, optional sliding window k_pos > q_pos - window. A
// query row with no visible key outputs 0. The G = H / Kv query heads of a
// kv head share its keys, so a block takes the T*G query rows of one
// (row, kv head) and reads each key once for all of them.
//
// What bounded the first kernels of these files: one block per (row, kv
// head) walked the keys in 32-key tiles, one after another, each tile a
// load -> barrier -> scores -> barrier -> softmax and P.V -> barrier chain
// with scalar 4-byte loads; at B 1 that was 8 blocks on 132 SMs and 3-4
// dependent device-memory round trips a launch, and at T*G = 1 three warps
// of four idled. Every FMA read both operands from shared memory.
//
// This design:
//   - Everything a block needs in flight at once, in two round trips
//     (paged: three). The set-up issues the query rows, their positions
//     and every key's stored position as cp.async copies together (paged:
//     each position after its block-table entry); then, from the row's
//     widest query range, the 16-byte copies of every visible key's K and
//     V rows, neighbouring threads on neighbouring chunks of a row, before
//     any compute. Keys no query of the row can see (empty slots, past the
//     newest query, outside the window, unmapped blocks) are never read:
//     their rows are zero-filled. A block's keys that do not fit a 64 KB
//     stage stream through a ring of two 32 KB stages instead (long rows
//     at a batch that fills the card). Tensors whose pointers, strides or
//     rows are no whole 16-byte chunks are copied by plain loads (the
//     wrapper decides, kernel.py's vector_loads).
//   - Keys split across warps. Each warp takes its own 32-key steps of the
//     block's keys and keeps its own online-softmax state (max, sum,
//     accumulator) in registers; a step whose keys are all invisible is
//     skipped. With T*G > 1 (the verify pass, T = DL + 1) a step is two
//     tensor-core products, S = Q K^T and O += P V, on mma.sync m16n8k8
//     with the query rows as M, 16 a pass (3xTF32 for fp32, as in
//     flash_attention.cu, whose fragments hopper_common.cuh shares). At
//     T*G = 1 (greedy) 15 of 16 rows would be padding, so the step is FMAs
//     over registers: lane = key for the scores (q as broadcast float4),
//     then groups of hd/4 lanes a key for P.V (V and P as float4, 16 FMAs
//     a P read). head_dim 256 takes the FMAs with 8 rows a pass. Scores
//     are kept in log2 units (exp2f). The warps merge once, through shared
//     memory, in warp order: one thread a row turns the warps' maxima into
//     factors, then every output element is a short weighted sum.
//   - Keys split across blocks where B*Kv leaves the card idle and the row
//     is long (kernel.py's plan_splits; a row of fewer than 8 key tiles,
//     S <= 224, is one block's: its warps take it at once, and a split
//     only adds round trips). Each split
//     block writes a partial (max, sum, unnormalised accumulator) to a
//     scratch buffer the wrapper allocates; the last block of a (row, kv
//     head) to finish (a ticket counter it resets to 0 afterwards)
//     combines the partials in split order and writes the output. A
//     ticket keeps it one launch: a second combine kernel would add a
//     launch and a round trip. A split with no visible key has max -inf
//     and sum 0 and adds nothing.
//   - Query rows split across blocks where the blocks of the (row, kv head,
//     split) grid leave the card idle and there are many rows (a prompt
//     chunk: T 32 x G 3 = 96 rows at B 8), or where the rows would
//     overflow a block's shared memory (a one-shot prefill of hundreds of
//     tokens): each block takes a group of whole 16-row passes
//     (kernel.py's plan_groups), loads only its rows' queries and only
//     the keys they can see, and the split combine runs per group (its own
//     ticket). One group (all T*G rows, the layout and arithmetic of
//     before) elsewhere.
//   - Deterministic: every sum runs in a fixed order (lane trees, warp
//     order, split order), no float atomics; the plan depends on shapes
//     only, so two calls agree bitwise.
// What bounds it now (PERF.md, H100): at B 200 (the verify pass of 8 slots
// x 25 drafts) 1600 blocks, five on an SM by shared memory, so three waves
// of each block's chain: the set-up trip, the K/V trip (at about half the
// card's 3.35 TB/s in these short bursts), one tensor-core step a warp, the
// merge. At B 1 and B 24 one wave: a launch (about 4.8 us of a
// one-element kernel under the same timing) plus that chain.
//
// head_dim runs in buckets of 16, 32, 64, 128 and 256 (a template
// parameter; a smaller hd is zero-padded to its bucket).

#pragma once

#include <climits>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace decode_attention {

constexpr int MAX_WARPS = 4;
constexpr int STEP = 32;                  // keys per warp step: one a lane
constexpr int RESIDENT_BYTES = 64 << 10;  // K+V of a block held whole
constexpr int RING_BYTES = 32 << 10;      // K+V of one ring stage
constexpr unsigned FULL = 0xffffffffu;

// Everything a launch passes the kernel besides the key policy.
struct Params {
  const void* q;        // (B, T, H, hd), contiguous
  void* out;            // (B, T, H, hd)
  const int* q_pos;     // (B, T)
  float* part;          // split partials: (B*Kv, n_split, TG, hd) accumulators
  float* part_ml;       //   and (B*Kv, n_split, TG, 2) max, sum
  int* tickets;         // (B*Kv*q_groups,) zeros; each combining block
                        // resets its own
  int T, H, Kv, hd, G, TG, window;
  float scale;
  int n_split, chunk;   // keys [split*chunk, +chunk) per block
  int q_groups, group_rows;   // query rows [qg*group_rows, +group_rows)
  int stage_keys;       // keys per stage (a multiple of STEP)
  int n_stages;         // 1: the block's keys are resident; else a ring of 2
  int vec;              // 16-byte cp.async (1) or plain loads (0)
};

inline Params make_params(const void* q, void* out, const int* q_pos,
                          float* part, float* part_ml, int* tickets, int T,
                          int H, int Kv, int hd, int window, float scale,
                          int n_split, int chunk, int q_groups,
                          int group_rows, int vec) {
  Params p{};
  p.q = q;
  p.out = out;
  p.q_pos = q_pos;
  p.part = part;
  p.part_ml = part_ml;
  p.tickets = tickets;
  p.T = T;
  p.H = H;
  p.Kv = Kv;
  p.hd = hd;
  p.G = H / Kv;
  p.TG = T * p.G;
  p.window = window;
  p.scale = scale;
  p.n_split = n_split;
  p.chunk = chunk;
  p.q_groups = q_groups;
  p.group_rows = group_rows;
  p.vec = vec;
  return p;
}

// four consecutive elements of a shared row as floats (16 or 8 bytes)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// 4 bytes, cached in L1 (positions)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ bool sees(int qp, int kp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
}

// shared row pitch in elements of a K/V row and of a query row
// (T too): 16 bytes of padding keep rows 16-byte aligned and put the rows
// that lanes read together in distinct banks
template <typename T, int HD>
__host__ __device__ constexpr int pitch() {
  return HD + 16 / (int)sizeof(T);
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// the dynamic shared memory of one block, in the kernel's order. With
// alias, the warps' merge rows (pm) share the K/V buffers, which a single
// pass is done with by then (MmaRows keep no step scratch there). The
// split combine's factors (n_split x rows floats) reuse the start when
// they fit below the output offsets.
struct Layout {
  size_t kv, q, pm, ml, kp, off, qp, oo, comb, total;
};
template <typename T, int HD, int R>
__host__ __device__ Layout layout(int stage_keys, int n_stages, int TG,
                                  int nw, int n_split, bool alias) {
  const int nbuf = n_stages > 1 ? 2 : 1;
  const int rows = round_up(TG, R);   // query rows, padded to whole passes
  const int pm_cols = HD > STEP ? HD : STEP;   // P a step, or a merge row
  const size_t kv = (size_t)nbuf * 2 * stage_keys * pitch<T, HD>() * sizeof(T);
  const size_t pm = (size_t)nw * R * pm_cols * sizeof(float);
  const size_t q = (size_t)rows * pitch<T, HD>() * sizeof(T);
  Layout L;
  L.kv = 0;
  if (alias) {
    L.pm = 0;
    L.q = round_up((int)(kv > pm ? kv : pm), 16);
    L.ml = L.q + q;
  } else {
    L.q = kv;
    L.pm = L.q + q;
    L.ml = L.pm + pm;
  }
  L.kp = L.ml + (size_t)2 * nw * R * sizeof(float);
  L.off = round_up((int)(L.kp + (size_t)nbuf * stage_keys * sizeof(int)), 16);
  L.qp = L.off + (size_t)nbuf * stage_keys * 2 * sizeof(long long);
  L.oo = round_up((int)(L.qp + (size_t)(rows + 3) * sizeof(int)), 16);
  L.total = L.oo + (size_t)rows * sizeof(long long);
  const size_t comb = (size_t)n_split * rows * sizeof(float);
  L.comb = comb <= L.oo ? 0 : L.total;   // never over the output offsets
  if (L.comb) L.total += comb;
  return L;
}

// What a warp's step sees: this stage's K and V rows (pitch LD) and stored
// positions, the step's first key, the block's query rows and positions
// (padded rows at INT_MIN see no key), the pass's first row and its
// row count, and the warp's (R, PMC) scratch rows.
template <typename T>
struct StepIn {
  const T *ks, *vs;
  const int* kp;
  int key0;
  const T* q_s;
  const int* qp_s;
  int r0, nr, window;
  float scale;
  float* pw;
};

// Plain FMAs over registers, R query rows a pass: the greedy step (T*G = 1,
// R = 1), and head_dim 256. Scores: lane = key, q as broadcast float4.
// P.V: lanes in groups of DL, each group KPG keys of the step, each lane
// float4 columns of the head dim.
template <typename T, int HD, int R>
struct FmaRows {
  static constexpr int LD = pitch<T, HD>(), LDQ = LD;
  static constexpr int DL = HD / 4 < 32 ? HD / 4 : 32;  // lanes on a key
  static constexpr int NG = 32 / DL;                    // key groups
  static constexpr int KPG = STEP / NG;                 // keys a group
  static constexpr int CPL = HD / (4 * DL);             // float4s a lane
  static constexpr int PMC = HD > STEP ? HD : STEP;
  static_assert(KPG % 4 == 0, "P is read four keys at a time");
  static constexpr bool kScratch = true;   // P of a step in the merge rows

  float m[R], l[R];
  float4 acc[R][CPL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void step(const StepIn<T>& in) {
    const int lane = threadIdx.x & 31, grp = lane / DL, cl = lane - grp * DL;
    const int key = in.key0 + lane, kp = in.kp[key];
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const T* kr = in.ks + key * LD;
#pragma unroll 4
    for (int c = 0; c < HD / 4; ++c) {
      const float4 k4 = load4(kr + 4 * c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < in.nr) {
          const float4 q4 = load4(in.q_s + (in.r0 + r) * LDQ + 4 * c);
          s[r] = fmaf(q4.x, k4.x, s[r]);
          s[r] = fmaf(q4.y, k4.y, s[r]);
          s[r] = fmaf(q4.z, k4.z, s[r]);
          s[r] = fmaf(q4.w, k4.w, s[r]);
        }
      }
    }
    // online softmax, one row at a time (m is the same in every lane)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < in.nr) {
        const bool vis = sees(in.qp_s[in.r0 + r], kp, in.window);
        const float sc = vis ? s[r] * in.scale : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(sc));
        float pr = 0.f, alpha = 1.f;
        if (m_new != -INFINITY) {   // some key of this row seen so far
          alpha = exp2f(m[r] - m_new);
          pr = vis ? exp2f(sc - m_new) : 0.f;
        }
        m[r] = m_new;
        l[r] = l[r] * alpha + pr;   // this lane's keys; summed at the end
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          acc[r][c].x *= alpha;
          acc[r][c].y *= alpha;
          acc[r][c].z *= alpha;
          acc[r][c].w *= alpha;
        }
        in.pw[r * PMC + lane] = pr;
      }
    }
    __syncwarp();
#pragma unroll
    for (int j0 = 0; j0 < KPG; j0 += 4) {
      const int kj = grp * KPG + j0;
      float4 vv[4][CPL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          vv[u][c] = load4(in.vs + (in.key0 + kj + u) * LD + 4 * (c * DL + cl));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < in.nr) {
          const float4 p4 = load4(in.pw + r * PMC + kj);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            float4& a = acc[r][c];
            a.x = fmaf(p4.x, vv[0][c].x, a.x);
            a.y = fmaf(p4.x, vv[0][c].y, a.y);
            a.z = fmaf(p4.x, vv[0][c].z, a.z);
            a.w = fmaf(p4.x, vv[0][c].w, a.w);
            a.x = fmaf(p4.y, vv[1][c].x, a.x);
            a.y = fmaf(p4.y, vv[1][c].y, a.y);
            a.z = fmaf(p4.y, vv[1][c].z, a.z);
            a.w = fmaf(p4.y, vv[1][c].w, a.w);
            a.x = fmaf(p4.z, vv[2][c].x, a.x);
            a.y = fmaf(p4.z, vv[2][c].y, a.y);
            a.z = fmaf(p4.z, vv[2][c].z, a.z);
            a.w = fmaf(p4.z, vv[2][c].w, a.w);
            a.x = fmaf(p4.w, vv[3][c].x, a.x);
            a.y = fmaf(p4.w, vv[3][c].y, a.y);
            a.z = fmaf(p4.w, vv[3][c].z, a.z);
            a.w = fmaf(p4.w, vv[3][c].w, a.w);
          }
        }
      }
    }
    __syncwarp();   // P of this step consumed
  }

  // sum l over the lanes and the accumulator over the key groups (after a
  // block barrier: pw is merge space now), then store the warp's (m, l,
  // accumulator) rows: m at ml[r], l at ml_l[r], the accumulator at pw
  __device__ __forceinline__ void store(float* pw, float* ml, float* ml_l,
                                        int nr) {
    const int lane = threadIdx.x & 31, cl = lane % DL;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l[r] = warp_sum(l[r]);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
#pragma unroll
        for (int o = DL; o < 32; o <<= 1) {
          acc[r][c].x += __shfl_xor_sync(FULL, acc[r][c].x, o);
          acc[r][c].y += __shfl_xor_sync(FULL, acc[r][c].y, o);
          acc[r][c].z += __shfl_xor_sync(FULL, acc[r][c].z, o);
          acc[r][c].w += __shfl_xor_sync(FULL, acc[r][c].w, o);
        }
      }
      if (r < nr) {
        if (lane == 0) {
          ml[r] = m[r];
          ml_l[r] = l[r];
        }
        if (lane < DL) {
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            *reinterpret_cast<float4*>(pw + r * PMC + 4 * (c * DL + cl)) =
                acc[r][c];
        }
      }
    }
  }
};

// Tensor cores, 16 query rows a pass (T*G > 1, head_dim <= 128): S = Q K^T
// and O += P V as mma.sync m16n8k8 (flash_attention.cu's fragments and k
// permutation), 3xTF32 for fp32 inputs, one TF32 product for bf16 (exact
// in TF32). Lane (g, t) holds rows g and g + 8 of the pass: two maxima and
// sums, S as four 16 x 8 tiles of the step's keys, O as HD/8 tiles.
template <typename T, int HD>
struct MmaRows {
  static constexpr int R = 16, NO = HD / 8;
  static constexpr int LD = pitch<T, HD>(), LDQ = LD;
  static constexpr int PMC = HD > STEP ? HD : STEP;
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr bool kScratch = false;

  float m[2], l[2], o[NO][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  }

  __device__ __forceinline__ void step(const StepIn<T>& in) {
    const int g = lane_g(), t = lane_t();
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      Frag<4> a;
      frag_a<SPLIT>(a, in.q_s, LDQ, in.r0, kk * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Frag<2> bk;
        frag_b_nk<SPLIT>(bk, in.ks, LD, in.key0 + j * 8, kk * 8);
        mma3<SPLIT>(s[j], a, bk);
      }
    }
    // online softmax of rows g + 8h: the row's 32 keys lie in the 4 lanes
    // of its quad, 8 a lane
    int kp[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) kp[j][c] = in.kp[in.key0 + j * 8 + 2 * t + c];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = in.qp_s[in.r0 + g + 8 * h];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[j][2 * h + c];
          x = sees(qp, kp[j][c], in.window) ? x * in.scale : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new != -INFINITY) alpha = exp2f(m[h] - m_new);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[j][2 * h + c];
          x = x == -INFINITY ? 0.f : exp2f(x - m_new);
          sum += x;
        }
      m[h] = m_new;
      l[h] = l[h] * alpha + sum;   // this lane's keys; summed at the end
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Frag<4> a;
      frag_a_acc<SPLIT>(a, s[j]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        Frag<2> bv;
        frag_b_kn<SPLIT>(bv, in.vs, LD, in.key0 + j * 8, n * 8);
        mma3<SPLIT>(o[n], a, bv);
      }
    }
  }

  __device__ __forceinline__ void store(float* pw, float* ml, float* ml_l,
                                        int nr) {
    const int g = lane_g(), t = lane_t();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(FULL, l[h], 1);
      l[h] += __shfl_xor_sync(FULL, l[h], 2);
      const int r = g + 8 * h;
      if (r < nr) {
        if (t == 0) {
          ml[r] = m[h];
          ml_l[r] = l[h];
        }
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            pw[r * PMC + n * 8 + 2 * t + c] = o[n][2 * h + c];
      }
    }
  }
};

// Keys: the key-address policy. Keys::n_keys() is the row's key count;
// Keys::position(b, g, s, kp, ko, vo) copies key s's stored position to
// the shared int kp (cp.async; -1 when the slot is unmapped) and writes
// the element offsets of its K and V rows for kv head g to ko and vo. Rows: FmaRows or MmaRows, the warp's per-pass state.
template <typename T, int HD, int R, typename Rows, typename Keys>
__global__ void __launch_bounds__(MAX_WARPS * 32)
decode_attention_kernel(const __grid_constant__ Params p,
                        const __grid_constant__ Keys keys,
                        const T* __restrict__ k, const T* __restrict__ v) {
  constexpr int LD = pitch<T, HD>();           // K, V and q rows alike
  constexpr int EPC = 16 / (int)sizeof(T);     // elements a 16-byte copy
  constexpr int CPR = HD / EPC;                // copies a row
  constexpr int PMC = HD > STEP ? HD : STEP;
  constexpr int C4 = HD / 4;                   // float4s a merge row

  const int b = blockIdx.x, g = blockIdx.y;
  const int split = blockIdx.z % p.n_split, qg = blockIdx.z / p.n_split;
  const int bg = b * p.Kv + g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, nt = blockDim.x;
  const int TG = p.TG, hd = p.hd, G = p.G;
  // this block's query rows: [row0, row0 + NR) of the (row, kv head)'s TG
  const int GR = p.group_rows, row0 = qg * GR, NR = min(GR, TG - row0);
  const int rows = round_up(GR, R);
  const int SK = p.stage_keys;
  const int c0 = split * p.chunk;
  const int c1 = min(keys.n_keys(), c0 + p.chunk);

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T, HD, R>(SK, p.n_stages, GR, nw, p.n_split,
                                    !Rows::kScratch && rows == R);
  T* kv_s = reinterpret_cast<T*>(smem + L.kv);
  T* q_s = reinterpret_cast<T*>(smem + L.q);             // (rows, LD)
  float* pm_s = reinterpret_cast<float*>(smem + L.pm);   // (nw, R, PMC)
  float* ml_s = reinterpret_cast<float*>(smem + L.ml);   // (2, nw, R)
  int* kp_s = reinterpret_cast<int*>(smem + L.kp);       // (nbuf, SK)
  long long* off_s = reinterpret_cast<long long*>(smem + L.off);  // (nbuf, SK, 2)
  int* qp_s = reinterpret_cast<int*>(smem + L.qp);   // (rows,), flag, range
  int* flag_s = qp_s + rows;
  int* qr_s = flag_s + 1;                            // q_lo, q_hi
  long long* oo_s = reinterpret_cast<long long*>(smem + L.oo);  // (rows,)
  float* comb_s = reinterpret_cast<float*>(smem + L.comb);  // (n_split, NR)

  // A stage st of the block's keys goes to buffer buf in two steps, a
  // barrier apart. resolve: each key's stored position into kp_s (copied;
  // paged: after its block-table entry) and its K and V row offsets into
  // off_s. issue, by 16-byte chunks (neighbouring threads on neighbouring
  // chunks of a row): the copies of every key some query of the row can
  // see, zero rows for the rest, whose kp_s becomes -1.
  auto resolve = [&](int st, int buf) {
    const int base = c0 + st * SK;
    for (int i = tid; i < SK; i += nt) {
      const int s = base + i, j = buf * SK + i;
      if (s < c1)
        keys.position(b, g, s, kp_s + j, off_s + 2 * j, off_s + 2 * j + 1);
      else
        kp_s[j] = -1;
    }
  };
  // one work item: chunk c (elements) of key `key`
  auto copy = [&](T* ks, T* vs, int* kpb, const long long* ofb, int key,
                  int c, bool vec, int q_lo, int q_hi) {
    const int kp = kpb[key];
    const bool vis = kp >= 0 && kp <= q_hi &&
                     (p.window <= 0 || kp > q_lo - p.window);
    if (!vis && c == 0) kpb[key] = -1;   // every reader decides alike
    const bool ok = vis && c < hd;
    const long long ko = ok ? ofb[2 * key] + c : 0;
    const long long vo = ok ? ofb[2 * key + 1] + c : 0;
    if (vec) {
      cp_async16(ks + key * LD + c, k + ko, ok);
      cp_async16(vs + key * LD + c, v + vo, ok);
    } else {
      ks[key * LD + c] = ok ? k[ko] : from_f<T>(0.f);
      vs[key * LD + c] = ok ? v[vo] : from_f<T>(0.f);
    }
  };
  auto issue = [&](int buf, int q_lo, int q_hi) {
    T* ks = kv_s + (size_t)buf * 2 * SK * LD;
    T* vs = ks + (size_t)SK * LD;
    int* kpb = kp_s + buf * SK;
    const long long* ofb = off_s + 2 * buf * SK;
    if (p.vec) {
      for (int i = tid; i < SK * CPR; i += nt)
        copy(ks, vs, kpb, ofb, i / CPR, (i % CPR) * EPC, true, q_lo, q_hi);
    } else {
      for (int i = tid; i < SK * HD; i += nt)
        copy(ks, vs, kpb, ofb, i / HD, i % HD, false, q_lo, q_hi);
    }
  };

  // set-up, all in one round trip (paged: two): the group's query rows
  // (local row r = row0 + r = t*G + gi holds q[b, t, g*G + gi]) in T,
  // zero-padded to whole passes and to HD (by 16-byte copies where q's rows
  // allow it); each row's position (padded rows at INT_MIN see no key) and
  // output offset; stage 0's (and 1's) key positions; and in warp 0 the
  // group's widest query range (a key outside it is seen by no query of
  // the group and never loaded)
  const int* qpb = p.q_pos + (long long)b * p.T;
  {
    const T* q = static_cast<const T*>(p.q);
    const bool qvec = (hd * sizeof(T)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(q) % 16 == 0;
    const int per = qvec ? CPR : HD;
    for (int i = tid; i < rows * per; i += nt) {
      const int r = i / per, c = (i - r * per) * (qvec ? EPC : 1);
      const int t = (row0 + r) / G, gi = row0 + r - t * G;
      const bool ok = r < NR && c < hd;
      const T* src = q + (((long long)b * p.T + t) * p.H + g * G + gi) * hd + c;
      if (qvec) {
        cp_async16(q_s + r * LD + c, ok ? src : q, ok);
      } else {
        q_s[r * LD + c] = ok ? *src : from_f<T>(0.f);
      }
    }
    for (int r = tid; r < rows; r += nt) {
      if (r < NR) {
        const int t = (row0 + r) / G, gi = row0 + r - t * G;
        cp_async4(qp_s + r, qpb + t);
        oo_s[r] = (((long long)b * p.T + t) * p.H + g * G + gi) * hd;
      } else {
        qp_s[r] = INT_MIN;
      }
    }
  }
  resolve(0, 0);   // after the query copies: paged positions wait on the table
  if (p.n_stages > 1) resolve(1, 1);
  cp_commit();
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    const int t_end = (row0 + NR - 1) / G;   // the group's fed positions
    for (int t = row0 / G + lane; t <= t_end; t += 32) {
      lo = min(lo, qpb[t]);
      hi = max(hi, qpb[t]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(FULL, lo, o));
      hi = max(hi, __shfl_xor_sync(FULL, hi, o));
    }
    if (lane == 0) {
      qr_s[0] = lo;
      qr_s[1] = hi;
    }
  }
  cp_wait<0>();
  __syncthreads();
  const int q_lo = qr_s[0], q_hi = qr_s[1];
  const float scale = p.scale * 1.4426950408889634f;   // scores in log2 units

  const bool resident = p.n_stages == 1;
  const int n_steps = SK / STEP;
  float* pw = pm_s + (size_t)warp * R * PMC;   // this warp's (R, PMC) rows

  for (int r0 = 0; r0 < NR; r0 += R) {
    const int nr = min(R, NR - r0);
    Rows state;
    state.init();
    for (int st = 0; st < p.n_stages; ++st) {
      const int buf = st & 1;
      if (!resident || r0 == 0) {
        if (st == 0) {
          if (r0 > 0) {   // the ring again, for the next rows
            resolve(0, 0);
            if (p.n_stages > 1) resolve(1, 1);
            cp_commit();
            cp_wait<0>();
            __syncthreads();
          }
          issue(0, q_lo, q_hi);
          cp_commit();
          if (p.n_stages > 1) {
            issue(1, q_lo, q_hi);
            cp_commit();
          }
        }
        if (st + 1 < p.n_stages) cp_wait<1>(); else cp_wait<0>();
      }
      __syncthreads();   // the stage is in shared memory

      StepIn<T> in;
      in.ks = kv_s + (size_t)buf * 2 * SK * LD;
      in.vs = in.ks + (size_t)SK * LD;
      in.kp = kp_s + buf * SK;
      in.q_s = q_s;
      in.qp_s = qp_s;
      in.r0 = r0;
      in.nr = nr;
      in.window = p.window;
      in.scale = scale;
      in.pw = pw;
      for (int step = warp; step < n_steps; step += nw) {
        in.key0 = step * STEP;
        if (!__any_sync(FULL, in.kp[in.key0 + lane] >= 0)) continue;
        state.step(in);
      }

      if (st + 2 < p.n_stages) {
        __syncthreads();   // buffer buf consumed by every warp
        resolve(st + 2, buf);
        cp_commit();
        cp_wait<0>();      // (stage st + 1's copies too)
        __syncthreads();
        issue(buf, q_lo, q_hi);
        cp_commit();
      }
    }

    __syncthreads();   // every warp is done with its step scratch
    state.store(pw, ml_s + warp * R, ml_s + (nw + warp) * R, nr);
    __syncthreads();

    // merge the warps in warp order: one thread a row turns the warps'
    // maxima into a factor for each warp's accumulator, 2^(m_w - M), over
    // the row's sum L when this block writes the output (no visible key:
    // every factor 0, so the row gives 0); a split keeps (M, L) instead
    for (int r = tid; r < nr; r += nt) {
      float M = -INFINITY;
      for (int w = 0; w < nw; ++w) M = fmaxf(M, ml_s[w * R + r]);
      float Ls = 0.f;
      for (int w = 0; w < nw; ++w) {
        const float mw = ml_s[w * R + r];
        const float e = mw == -INFINITY ? 0.f : exp2f(mw - M);
        Ls += ml_s[(nw + w) * R + r] * e;
        ml_s[w * R + r] = e;
      }
      if (p.n_split == 1) {
        const float inv = Ls > 0.f ? 1.f / Ls : 0.f;
        for (int w = 0; w < nw; ++w) ml_s[w * R + r] *= inv;
      } else {
        const long long pr =
            ((long long)bg * p.n_split + split) * TG + row0 + r0 + r;
        p.part_ml[2 * pr] = M;
        p.part_ml[2 * pr + 1] = Ls;
      }
    }
    __syncthreads();
    for (int i = tid; i < nr * C4; i += nt) {
      const int r = i / C4, d = (i - r * C4) * 4;
      if (d >= hd) continue;
      float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < nw; ++w) {
        const float f = ml_s[w * R + r];
        const float4 x = load4(pm_s + ((size_t)w * R + r) * PMC + d);
        O.x = fmaf(x.x, f, O.x);
        O.y = fmaf(x.y, f, O.y);
        O.z = fmaf(x.z, f, O.z);
        O.w = fmaf(x.w, f, O.w);
      }
      const float o4[4] = {O.x, O.y, O.z, O.w};
      const int row = r0 + r;
      if (p.n_split == 1) {
        T* dst = static_cast<T*>(p.out) + oo_s[row] + d;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (d + u < hd) dst[u] = from_f<T>(o4[u]);
      } else {
        float* dst = p.part +
            (((long long)bg * p.n_split + split) * TG + row0 + row) * hd +
            d;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (d + u < hd) dst[u] = o4[u];
      }
    }
    __syncthreads();   // merge space and step scratch reused by the next rows
  }

  if (p.n_split == 1) return;
  // the last split block of (b, g, query group) to finish combines the
  // partials of the group's rows
  __threadfence();
  __syncthreads();
  const int ticket = bg * p.q_groups + qg;
  if (tid == 0) *flag_s = atomicAdd(p.tickets + ticket, 1) == p.n_split - 1;
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();
  // per row: the splits' factors 2^(m_s - M) / L, then the sums
  for (int r = tid; r < NR; r += nt) {
    const long long p0 = (long long)bg * p.n_split * TG + row0 + r;
    float M = -INFINITY;
    for (int sp = 0; sp < p.n_split; ++sp)
      M = fmaxf(M, __ldcg(p.part_ml + 2 * (p0 + (long long)sp * TG)));
    float Ls = 0.f;
    for (int sp = 0; sp < p.n_split; ++sp) {
      const long long pr = p0 + (long long)sp * TG;
      const float ms = __ldcg(p.part_ml + 2 * pr);
      const float e = ms == -INFINITY ? 0.f : exp2f(ms - M);
      Ls += __ldcg(p.part_ml + 2 * pr + 1) * e;
      comb_s[sp * NR + r] = e;   // a split with no visible key: 0
    }
    const float inv = Ls > 0.f ? 1.f / Ls : 0.f;
    for (int sp = 0; sp < p.n_split; ++sp) comb_s[sp * NR + r] *= inv;
  }
  __syncthreads();
  for (int i = tid; i < NR * hd; i += nt) {
    const int row = i / hd, d = i - row * hd;
    const long long p0 = (long long)bg * p.n_split * TG + row0 + row;
    float O = 0.f;
    for (int sp = 0; sp < p.n_split; ++sp)
      O += __ldcg(p.part + (p0 + (long long)sp * TG) * hd + d) *
           comb_s[sp * NR + row];
    static_cast<T*>(p.out)[oo_s[row] + d] = from_f<T>(O);
  }
  if (tid == 0) p.tickets[ticket] = 0;   // ready for the next launch
}

template <typename T, int HD, int R, typename Rows, typename Keys>
cudaError_t launch_instance(Params p, const Keys& keys, const void* k,
                            const void* v, int B, cudaStream_t stream) {
  constexpr int LD = pitch<T, HD>();
  const long long key_bytes = 2LL * LD * sizeof(T);
  const int chunk_keys = round_up(p.chunk, STEP);
  if (chunk_keys * key_bytes <= RESIDENT_BYTES) {
    p.stage_keys = chunk_keys;
    p.n_stages = 1;
  } else {
    p.stage_keys = (int)(RING_BYTES / key_bytes) / STEP * STEP;
    if (p.stage_keys < STEP) p.stage_keys = STEP;
    p.n_stages = (p.chunk + p.stage_keys - 1) / p.stage_keys;
  }
  const int steps = p.stage_keys / STEP;
  const int nw = steps < MAX_WARPS ? steps : MAX_WARPS;
  const size_t smem =
      layout<T, HD, R>(p.stage_keys, p.n_stages, p.group_rows, nw,
                       p.n_split,
                       !Rows::kScratch && round_up(p.group_rows, R) == R)
          .total;
  auto kern = decode_attention_kernel<T, HD, R, Rows, Keys>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, p.Kv, p.n_split * p.q_groups);
  kern<<<grid, nw * 32, smem, stream>>>(p, keys, static_cast<const T*>(k),
                                        static_cast<const T*>(v));
  return cudaGetLastError();
}

// T*G = 1 (greedy): FMAs, one row; else tensor cores, 16 rows a pass
// (head_dim 256: FMAs, 8 rows a pass, the accumulators a lane can hold)
template <typename T, int HD, typename Keys>
cudaError_t launch_rows(const Params& p, const Keys& keys, const void* k,
                        const void* v, int B, cudaStream_t stream) {
  if (p.TG == 1)
    return launch_instance<T, HD, 1, FmaRows<T, HD, 1>>(p, keys, k, v, B,
                                                         stream);
  if constexpr (HD <= 128)
    return launch_instance<T, HD, 16, MmaRows<T, HD>>(p, keys, k, v, B,
                                                      stream);
  else
    return launch_instance<T, HD, 8, FmaRows<T, HD, 8>>(p, keys, k, v, B,
                                                        stream);
}

template <typename T, typename Keys>
cudaError_t launch_hd(const Params& p, const Keys& keys, const void* k,
                      const void* v, int B, cudaStream_t stream) {
  if (p.hd <= 16) return launch_rows<T, 16>(p, keys, k, v, B, stream);
  if (p.hd <= 32) return launch_rows<T, 32>(p, keys, k, v, B, stream);
  if (p.hd <= 64) return launch_rows<T, 64>(p, keys, k, v, B, stream);
  if (p.hd <= 128) return launch_rows<T, 128>(p, keys, k, v, B, stream);
  if (p.hd <= 256) return launch_rows<T, 256>(p, keys, k, v, B, stream);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16
template <typename Keys>
cudaError_t launch(const Params& p, const Keys& keys, const void* k,
                   const void* v, int B, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_hd<float>(p, keys, k, v, B, stream);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(p, keys, k, v, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace decode_attention
