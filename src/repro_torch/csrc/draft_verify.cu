// Fused draft verification for Hopper (sm_90a): vocab argmax + accepted
// prefix length.
//
// Replaces the TPU kernel src/repro/kernels/draft_verify/kernel.py::
// draft_verify_kernel (body _verify_kernel, oracle draft_verify_ref). In the
// speculative greedy step it takes the verify pass's (N, T = DL+1, V) logits
// and returns, per row, the argmax token at every position (the first index
// wins ties) and the length of the longest prefix with
// drafts[i] == argmax[i] (0 where the draft is masked out or DL = 0).
//
// What bounds it on this card: at the serving shapes (N = 200, T = 11,
// V of a few dozen to a few hundred) it reads well under a megabyte and is
// bound by its launch, not by bytes or flops. The TPU kernel streamed the
// vocab in 512-wide tiles on a sequential grid axis and so had to pad V;
// here one block owns one row and one warp owns one position, each lane
// keeps a running (max, index) over a strided slice of the vocab, and a
// butterfly of warp shuffles merges the lanes with "greater value, else lower
// index", which is the first-index argmax with no padding. The block then
// runs the DL-long prefix match on the tokens it keeps in shared memory, so
// the logits are read once and only (N, T) tokens and (N,) lengths are
// written.
//
// Plain C interface, loaded with ctypes: draft_verify_launch returns the
// cudaError_t of the launch (0 = success).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_T = 32;  // one warp per position, at most 1024 threads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void draft_verify_kernel(const T* __restrict__ logits,
                                    const int* __restrict__ drafts,
                                    const unsigned char* __restrict__ mask,
                                    int* __restrict__ tokens,
                                    int* __restrict__ n_acc, int T_q, int V,
                                    int DL) {
  const int n = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ int tok_s[MAX_T];

  const T* row = logits + ((long long)n * T_q + warp) * V;
  float best = -INFINITY;
  int idx = INT_MAX;  // INT_MAX = this lane has seen no entry yet
  for (int c = lane; c < V; c += 32) {
    const float x = to_f(row[c]);
    if (idx == INT_MAX || x > best) {  // strict: the lane's lower index wins
      best = x;
      idx = c;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  if (lane == 0) {
    tok_s[warp] = idx;
    tokens[(long long)n * T_q + warp] = idx;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    int acc = 0;
    if (mask[n]) {
      const int* d = drafts + (long long)n * DL;
      while (acc < DL && d[acc] == tok_s[acc]) ++acc;
    }
    n_acc[n] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const int* drafts,
                   const unsigned char* mask, int* tokens, int* n_acc, int N,
                   int T_q, int V, cudaStream_t stream) {
  draft_verify_kernel<T><<<N, 32 * T_q, 0, stream>>>(
      static_cast<const T*>(logits), drafts, mask, tokens, n_acc, T_q, V,
      T_q - 1);
  return cudaGetLastError();
}

}  // namespace

// logits (N, T_q, V) contiguous, drafts (N, T_q - 1) int32, mask (N,) bool
// as bytes. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int draft_verify_launch(const void* logits, const int* drafts,
                                   const unsigned char* mask, int* tokens,
                                   int* n_acc, int N, int T_q, int V, int dtype,
                                   void* stream) {
  if (T_q < 1 || T_q > MAX_T || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(logits, drafts, mask, tokens, n_acc, N, T_q, V,
                              st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(logits, drafts, mask, tokens, n_acc, N,
                                      T_q, V, st);
  return (int)cudaErrorInvalidValue;
}
