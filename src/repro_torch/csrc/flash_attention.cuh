// Shared by the flash attention kernels, csrc/flash_attention.cu (forward)
// and csrc/flash_attention_bwd.cu (backward): the launch parameters, the
// masks, the tile copies and the launch helpers. Two sources so that the
// forward and the backward instances compile in parallel; the design is
// described in csrc/flash_attention.cu.

#pragma once

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
  const int *q_pos, *k_pos;   // (B, S) each, or NULL (the indices)
  void* out;
  float *lse, *D, *dq, *dk, *dv;
  Str qs, ks, vs, os, dos;
  int S, H, Hkv, qpk, hd, causal, window, vec;   // qpk = H / Hkv
  float scale;
};

// row pitch of a shared tile in elements: 16 bytes of padding keep rows
// 16-byte aligned and put the 8 rows of a fragment read in distinct banks
template <typename T, int HD>
__host__ __device__ constexpr int pitch() {
  return HD + 16 / (int)sizeof(T);
}

// may query row qi, at position qp, see a key at position kp (the key's
// own validity is checked by the caller); without positions qp = qi and kp
// is the key's index
__device__ __forceinline__ bool visible(int qi, int qp, int kp, int S,
                                        int causal, int window) {
  if (qi >= S) return false;   // padding row of the last query block
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

// the key range a query block [q0, q0 + ROWS) can see: [lo, hi); with
// positions (pos) every key
__device__ __forceinline__ void key_range(int q0, int S, int causal,
                                          int window, bool pos, int* lo,
                                          int* hi) {
  *lo = 0;
  *hi = S;
  if (causal && !pos) {
    *hi = min(S, q0 + ROWS);
    if (window > 0) *lo = max(0, q0 - window + 1);
  }
  *lo = (*lo / TILE) * TILE;
}

// the position of row i of batch b: its index without positions
template <bool POS>
__device__ __forceinline__ int row_pos(const int* pos, int b, int i, int S) {
  if (!POS) return i;
  return i < S ? pos[(long long)b * S + i] : 0;
}

// ---------------------------------------------------------------------------
// launch helpers

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

// H, Hkv and the positions into p; false on a bad head split or on one of
// q_pos / k_pos without the other
bool set_heads(Params& p, int H, int Hkv, const void* q_pos,
               const void* k_pos) {
  if (Hkv <= 0 || H % Hkv != 0 || (q_pos == nullptr) != (k_pos == nullptr))
    return false;
  p.H = H;
  p.Hkv = Hkv;
  p.qpk = H / Hkv;
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  return true;
}

}  // namespace
