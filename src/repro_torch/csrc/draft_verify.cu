// Fused draft verification for Hopper (sm_90a): vocab argmax + accepted
// prefix length.
//
// Replaces the TPU kernel src/repro/kernels/draft_verify/kernel.py::
// draft_verify_kernel (body _verify_kernel, oracle draft_verify_ref). In the
// speculative greedy step (and the plain greedy step, DL = 0) it takes the
// verify pass's (N, T = DL+1, V) logits and returns, per row, the argmax
// token at every position and the length of the longest prefix with
// drafts[i] == argmax[i] (0 where the row's mask is off or DL = 0). The
// argmax follows torch.argmax: a NaN is above every number, and the lower
// index wins among equals (two NaNs too). That order is total, so every
// merge below is exact and its result does not depend on the merge order.
//
// What bounds it on this card. At the Molecular Transformer's vocab (27
// synthetic, 320 USPTO-MIT) a call moves kilobytes to a quarter of a
// megabyte, and its time is the launch plus the memory round trips in
// series. At a language model's vocab (32k-152k) it moves megabytes and is
// bound by bytes. Two paths, chosen in Python (kernels/draft_verify/
// kernel.py::plan), one launch each:
//
// * Row path (verify_rows): `warps` warps own one row, all T positions
//   (one warp at the MT's T 11 x V 27; more as T*V grows, so that a lane
//   scans a few dozen entries); a block holds `rows` rows, so the grid
//   reaches ~132 blocks where N allows. The row's T*V logits (one
//   contiguous run), its DL drafts and its mask byte are all requested
//   before anything is compared: 16-byte cp.async copies of the aligned
//   body into shared memory, plain loads of a head and tail of under 16
//   bytes each (rows of 108 bytes at V 27 fp32 start anywhere), 4-byte
//   cp.async copies of the drafts. One trip, then `lanes` lanes scan each
//   position (positions past one pass loop) and merge by shuffles; the
//   row's first warp matches the prefix with one __ballot_sync per 32
//   drafts, its length the first zero bit. At T 1 (greedy: no drafts) and
//   V <= 256, verify_greedy takes the row straight into registers instead,
//   one warp a row: staging it cost ~0.0005 ms more on the H100.
// * Split path (verify_split): one block of 256 threads per (row, position,
//   vocab split). Each thread keeps four 16-byte loads in flight (eight
//   were slower at 24 x 11 x 49,152) and a running (max, index); warps
//   merge by shuffles, then the block in warp order, and the block writes
//   its partial to a scratch. The last block of
//   a row to finish (a ticket per row, reset by that block: no float
//   atomics, bitwise deterministic) merges each position's partials in
//   split order, writes the tokens and runs the ballot prefix.
//
// Plain C interface, loaded with ctypes: draft_verify_launch returns the
// cudaError_t of the launch (0 = success).

#include <climits>
#include <cstdint>
#include <math.h>

#include "hopper_common.cuh"

namespace {

constexpr int MAX_WARPS = 8;         // row path: warps a block
constexpr int GREEDY_LOADS = 8;      // verify_greedy: entries a lane
constexpr int SPLIT_THREADS = 256;   // split path: threads a block
constexpr int UNROLL = 4;            // split path: 16-byte loads in flight
constexpr long long SMEM_LIMIT = 48 * 1024;   // no opt-in needed

struct Params {
  const void* logits;          // (N, T, V)
  const int* drafts;           // (N, DL)
  const unsigned char* mask;   // (N,) bool as bytes
  int* tokens;                 // (N, T)
  int* n_acc;                  // (N,)
  float* part_v;               // split path: (N, T, n_split) partial maxima
  int* part_i;                 // ... and their indices
  int* tickets;                // split path: (N,) zeros, reset by the combiner
  int N, T, V, DL;
  int rows, warps, lanes;      // row path: rows a block, warps a row
  int n_split, chunk;          // split path: vocab entries a split
};

__host__ __device__ constexpr long long round16(long long x) {
  return (x + 15) & ~15LL;
}

// A row's shared memory on the row path: the T*V logits with 16 bytes of
// slack (the run starts at its source's offset mod 16, so that the 16-byte
// copies land aligned), then the drafts, then the tokens. Mirrored by
// kernel.py::row_bytes.
template <typename E>
__host__ __device__ long long row_bytes(int T, int V, int DL) {
  return round16((long long)T * V * sizeof(E)) + 16 + round16(4LL * DL) +
         round16(4LL * T);
}

// A byte loaded where it stands: the compiler may not sink it to its first
// use (past the barrier that follows), where it would be a second trip.
__device__ __forceinline__ bool load_flag(const unsigned char* p) {
  unsigned short v;
  asm volatile("ld.global.u8 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v != 0;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// (v2, i2) is above (v1, i1) in torch.argmax's order. An empty slot is
// (-inf, INT_MAX): every entry is above it.
__device__ __forceinline__ bool above(float v2, int i2, float v1, int i1) {
  const bool n1 = v1 != v1, n2 = v2 != v2;
  if (n1 || n2) return n2 && (!n1 || i2 < i1);
  return v2 > v1 || (v2 == v1 && i2 < i1);
}

__device__ __forceinline__ void take(float& v, int& i, float v2, int i2) {
  if (above(v2, i2, v, i)) {
    v = v2;
    i = i2;
  }
}

// the greatest (value, index) over each aligned group of `width` lanes
__device__ __forceinline__ void group_max(float& v, int& i, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    take(v, i, ov, oi);
  }
}

// The longest prefix with draft(j) == tok(j), j < DL: lane t tests entry
// j0 + t, and the length is the first zero bit of the ballot. Every lane of
// the warp calls it and gets the result.
template <typename Tok, typename Draft>
__device__ __forceinline__ int accepted(int DL, int lane, Tok tok,
                                        Draft draft) {
  for (int j0 = 0; j0 < DL; j0 += 32) {
    const int j = j0 + lane;
    const unsigned hit =
        __ballot_sync(0xffffffffu, j < DL && draft(j) == tok(j));
    if (hit != 0xffffffffu) return j0 + __ffs(~hit) - 1;
  }
  return DL;
}

// the 16 bytes at `r` hold entries i0, i0+1, ... in memory order
__device__ __forceinline__ void scan16(const uint4& r, float, int i0,
                                       float& v, int& i) {
  take(v, i, __uint_as_float(r.x), i0);
  take(v, i, __uint_as_float(r.y), i0 + 1);
  take(v, i, __uint_as_float(r.z), i0 + 2);
  take(v, i, __uint_as_float(r.w), i0 + 3);
}
__device__ __forceinline__ void scan16(const uint4& r, __nv_bfloat16, int i0,
                                       float& v, int& i) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {   // little-endian: the low half comes first
    take(v, i, __uint_as_float(w[k] << 16), i0 + 2 * k);
    take(v, i, __uint_as_float(w[k] & 0xffff0000u), i0 + 2 * k + 1);
  }
}

// T = 1 (greedy, DL = 0): the argmax alone, one warp a row, each lane
// taking entries lane, lane + 32, ... (V <= 32 * GREEDY_LOADS) straight
// from device memory into registers, all loads before any compare
template <typename E>
__global__ void __launch_bounds__(32 * MAX_WARPS) verify_greedy(Params p) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * p.rows + (threadIdx.x >> 5);
  if (n >= p.N) return;
  const E* x = static_cast<const E*>(p.logits) + (long long)n * p.V;
  float e[GREEDY_LOADS];
#pragma unroll
  for (int k = 0; k < GREEDY_LOADS; ++k) {
    const int c = lane + 32 * k;
    e[k] = c < p.V ? to_f(x[c]) : -INFINITY;
  }
  float v = -INFINITY;
  int i = INT_MAX;
#pragma unroll
  for (int k = 0; k < GREEDY_LOADS; ++k)
    if (lane + 32 * k < p.V) take(v, i, e[k], lane + 32 * k);
  group_max(v, i, 32);
  if (lane == 0) {
    p.tokens[n] = i;
    p.n_acc[n] = 0;
  }
}

template <typename E, bool WHOLE>
__global__ void __launch_bounds__(32 * MAX_WARPS) verify_rows(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EPC = 16 / sizeof(E);   // entries a 16-byte chunk
  const int nt = 32 * p.warps;          // a row's threads
  const int r = threadIdx.x / nt, rt = threadIdx.x - r * nt;
  const int n = blockIdx.x * p.rows + r;
  const bool live = n < p.N;   // no early exit: the block meets at barriers
  const int T = p.T, V = p.V, DL = p.DL;
  const long long len = (long long)T * V;
  unsigned char* region = smem + r * row_bytes<E>(T, V, DL);
  int* dr_s = reinterpret_cast<int*>(region + round16(len * sizeof(E)) + 16);
  int* tok_s = dr_s + round16(4LL * DL) / 4;

  // one trip: every copy of the row is issued before any is waited on
  const E* src = static_cast<const E*>(p.logits) + n * len;
  const int mis = WHOLE ? 0 : (int)(reinterpret_cast<uintptr_t>(src) & 15);
  E* buf = reinterpret_cast<E*>(region + mis);
  const long long head =
      WHOLE ? 0 : min(len, (long long)(((16 - mis) & 15) / sizeof(E)));
  const long long body = (len - head) / EPC;   // whole 16-byte chunks
  const int* dr = p.drafts + (long long)n * DL;
  if (live) {
    for (long long c = rt; c < body; c += nt)
      cp_async16(buf + head + c * EPC, src + head + c * EPC, true);
    for (int j = rt; j < DL; j += nt) cp_async4(dr_s + j, dr + j);
  }
  cp_commit();
  const bool on = live && DL > 0 && load_flag(p.mask + n);
  if (!WHOLE && live) {   // head and tail, under 16 bytes each: one a thread
    const long long e = rt < head ? rt : head + body * EPC + (rt - head);
    if (e < len) buf[e] = src[e];
  }
  cp_wait<0>();
  __syncthreads();

  // `lanes` lanes a position, nt / lanes positions a pass
  const int G = p.lanes, sub = rt & (G - 1);
  for (int t0 = 0; t0 < T; t0 += nt / G) {
    const int t = t0 + rt / G;
    float v = -INFINITY;
    int i = INT_MAX;
    if (live && t < T) {
      const E* x = buf + (long long)t * V;
#pragma unroll 4
      for (int c = sub; c < V; c += G) take(v, i, to_f(x[c]), c);
    }
    group_max(v, i, G);
    if (live && sub == 0 && t < T) {
      tok_s[t] = i;
      p.tokens[(long long)n * T + t] = i;
    }
  }
  __syncthreads();
  if (rt >= 32) return;   // the row's first warp matches the prefix
  const int acc = on ? accepted(DL, rt, [&](int j) { return tok_s[j]; },
                                [&](int j) { return dr_s[j]; })
                     : 0;
  if (live && rt == 0) p.n_acc[n] = acc;
}

template <typename E, bool WHOLE>
__global__ void __launch_bounds__(SPLIT_THREADS) verify_split(Params p) {
  constexpr int EPC = 16 / sizeof(E);
  constexpr int WARPS = SPLIT_THREADS / 32;
  __shared__ float wv[WARPS];
  __shared__ int wi[WARPS];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x % p.n_split;
  const long long nt = blockIdx.x / p.n_split;   // row * T + position
  const int n = (int)(nt / p.T);
  const int lo = s * p.chunk, len = min(p.V - lo, p.chunk);
  const E* seg = static_cast<const E*>(p.logits) + nt * p.V + lo;

  float v = -INFINITY;
  int i = INT_MAX;
  const int mis = WHOLE ? 0 : (int)(reinterpret_cast<uintptr_t>(seg) & 15);
  const int head = WHOLE ? 0 : min(len, (int)(((16 - mis) & 15) / sizeof(E)));
  const int body = (len - head) / EPC;
  if (!WHOLE) {   // head and tail, under 16 bytes each: one entry a thread
    const int e = tid < head ? tid : head + body * EPC + (tid - head);
    if (e < len) take(v, i, to_f(seg[e]), lo + e);
  }
  const uint4* chunks = reinterpret_cast<const uint4*>(seg + head);
  for (int c0 = tid; c0 < body; c0 += SPLIT_THREADS * UNROLL) {
    uint4 r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u * SPLIT_THREADS;
      if (c < body) r[u] = __ldcs(chunks + c);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u * SPLIT_THREADS;
      if (c < body) scan16(r[u], E(), lo + head + c * EPC, v, i);
    }
  }
  group_max(v, i, 32);
  if (lane == 0) {
    wv[warp] = v;
    wi[warp] = i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < WARPS; ++w) take(v, i, wv[w], wi[w]);
    p.part_v[nt * p.n_split + s] = v;
    p.part_i[nt * p.n_split + s] = i;
    __threadfence();
    last = atomicAdd(p.tickets + n, 1) == p.T * p.n_split - 1;
  }
  __syncthreads();
  if (!last) return;

  // the row's last block: each position's partials in split order
  __threadfence();
  const long long row = (long long)n * p.T;
  for (int t = warp; t < p.T; t += WARPS) {
    const long long b = (row + t) * p.n_split;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int sp = lane; sp < p.n_split; sp += 32)
      take(bv, bi, __ldcg(p.part_v + b + sp), __ldcg(p.part_i + b + sp));
    group_max(bv, bi, 32);
    if (lane == 0) p.tokens[row + t] = bi;
  }
  __syncthreads();   // the tokens written above are visible to warp 0
  if (warp != 0) return;
  const int* tok = p.tokens + row;
  const int* dr = p.drafts + (long long)n * p.DL;
  const int acc = p.mask[n] ? accepted(p.DL, lane,
                                       [&](int j) { return tok[j]; },
                                       [&](int j) { return dr[j]; })
                            : 0;
  if (lane == 0) {
    p.n_acc[n] = acc;
    p.tickets[n] = 0;   // ready for the next launch
  }
}

template <typename E>
cudaError_t launch(const Params& p, bool whole, cudaStream_t stream) {
  if (p.rows > 0 && p.lanes == 0) {
    if (p.T != 1 || p.V > 32 * GREEDY_LOADS || p.rows > MAX_WARPS)
      return cudaErrorInvalidValue;
    const int grid = (p.N + p.rows - 1) / p.rows;
    verify_greedy<E><<<grid, 32 * p.rows, 0, stream>>>(p);
  } else if (p.rows > 0) {
    const long long smem = p.rows * row_bytes<E>(p.T, p.V, p.DL);
    const int G = p.lanes;
    if (p.warps < 1 || p.rows * p.warps > MAX_WARPS || smem > SMEM_LIMIT ||
        G < 1 || G > 32 || (G & (G - 1)))
      return cudaErrorInvalidValue;
    const int grid = (p.N + p.rows - 1) / p.rows;
    auto kernel = whole ? verify_rows<E, true> : verify_rows<E, false>;
    kernel<<<grid, 32 * p.rows * p.warps, smem, stream>>>(p);
  } else {
    const long long grid = (long long)p.N * p.T * p.n_split;
    if (p.n_split < 1 || p.chunk < 1 || grid > INT_MAX ||
        (long long)(p.n_split - 1) * p.chunk >= p.V ||
        (long long)p.n_split * p.chunk < p.V ||
        (long long)p.T * p.n_split > INT_MAX)
      return cudaErrorInvalidValue;
    auto kernel = whole ? verify_split<E, true> : verify_split<E, false>;
    kernel<<<(int)grid, SPLIT_THREADS, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// logits (N, T, V) contiguous, drafts (N, T - 1) int32, mask (N,) bool as
// bytes; tokens (N, T) and n_acc (N,) int32 out. rows > 0: the row path
// (rows a block, warps a row, lanes a position; lanes 0: verify_greedy);
// rows = 0: the split path (n_split blocks a (row, position), chunk vocab
// entries each; part: 2 * N * T * n_split floats of scratch, tickets: N
// zeroed ints). whole: every run the kernel copies (a row's T*V logits on
// the row path, a split on the split path) starts on a 16-byte boundary and
// is whole 16-byte chunks.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int draft_verify_launch(const void* logits, const int* drafts,
                                   const unsigned char* mask, int* tokens,
                                   int* n_acc, float* part, int* tickets,
                                   int N, int T, int V, int rows, int warps,
                                   int lanes, int n_split, int chunk,
                                   int whole, int dtype, void* stream) {
  if (N < 1 || T < 1 || V < 1 || rows < 0) return (int)cudaErrorInvalidValue;
  Params p{logits, drafts, mask, tokens, n_acc, part,
           part ? reinterpret_cast<int*>(part + (long long)N * T * n_split)
                : nullptr,
           tickets, N, T, V, T - 1, rows, warps, lanes, n_split, chunk};
  if (rows == 0 && (part == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, whole != 0, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, whole != 0, st);
  return (int)cudaErrorInvalidValue;
}
