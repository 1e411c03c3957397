// Device helpers that the port's CUDA kernels share (flash_attention.cu,
// and decode_attention.cuh for decode_gqa.cu and paged_decode_gqa.cu):
// fp32/bf16 conversions, 16-byte cp.async copies, and the tensor-core
// fragments of mma.sync m16n8k8 with TF32 operands and fp32 sums, with the
// 3xTF32 split (hi*lo + lo*hi + hi*hi) that keeps fp32 products within
// ~2^-22 of fp32 (flash_attention.cu's notes give the layouts and why).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// ---------------------------------------------------------------------------
// asynchronous copies

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  // ok false: the 16 bytes are zero-filled and nothing is read
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// tensor-core fragments (mma.sync m16n8k8, TF32 operands, fp32 sums)
// lane = 4 g + t; A (16 x 8): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); B (8 x 8): b0 (t, g), b1 (t+4, g); C (16 x 8): c0 (g, 2t),
// c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

template <int N> struct Frag {
  unsigned hi[N], lo[N];
};

template <bool SPLIT, int N>
__device__ __forceinline__ void split(Frag<N>& f, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.hi[i] = to_tf32(x[i]);
    if (SPLIT) f.lo[i] = to_tf32(x[i] - __uint_as_float(f.hi[i]));
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b: 3xTF32 (small terms first) when SPLIT, else one TF32 product
template <bool SPLIT>
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  if (SPLIT) {
    mma(d, a.lo, b.hi);
    mma(d, a.hi, b.lo);
  }
  mma(d, a.hi, b.hi);
}

// A from a row-major (row, k) shared tile at (r0, k0)
template <bool SPLIT, typename T>
__device__ __forceinline__ void frag_a(Frag<4>& f, const T* s, int ld, int r0,
                                       int k0) {
  const T* p = s + (r0 + lane_g()) * ld + k0 + lane_t();
  const float x[4] = {to_f(p[0]), to_f(p[8 * ld]), to_f(p[4]),
                      to_f(p[8 * ld + 4])};
  split<SPLIT>(f, x);
}

// B (k x n) from a shared tile stored as (n, k) rows: K in QK^T, Q in KQ^T
template <bool SPLIT, typename T>
__device__ __forceinline__ void frag_b_nk(Frag<2>& f, const T* s, int ld,
                                          int n0, int k0) {
  const T* p = s + (n0 + lane_g()) * ld + k0 + lane_t();
  const float x[2] = {to_f(p[0]), to_f(p[4])};
  split<SPLIT>(f, x);
}

// B (k x n) from a shared tile stored as (k, n) rows, k permuted (index t
// is row 2t, t + 4 is row 2t + 1): V in PV, K in dS K, dO and Q in dV, dK
template <bool SPLIT, typename T>
__device__ __forceinline__ void frag_b_kn(Frag<2>& f, const T* s, int ld,
                                          int k0, int n0) {
  const T* p = s + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  const float x[2] = {to_f(p[0]), to_f(p[ld])};
  split<SPLIT>(f, x);
}

// A from an accumulator tile (16 x 8), with frag_b_kn's k permutation
template <bool SPLIT>
__device__ __forceinline__ void frag_a_acc(Frag<4>& f, const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split<SPLIT>(f, x);
}

}  // namespace
