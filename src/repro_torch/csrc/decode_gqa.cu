// Dense-cache GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_gqa/kernel.py::
// decode_gqa_kernel (body _decode_kernel, oracle decode_gqa_ref). It is the
// cached self-attention of every Molecular Transformer decoder layer under
// the one-shot engine and the dense streaming cache: the T = DL+1 fed
// tokens of each draft row (T = 1 greedy) attend to the row's (S, Kv, hd)
// cache, masked on the stored positions (-1 = empty slot, causal k_pos <=
// q_pos, optional sliding window k_pos > q_pos - window). The cache may be
// a wrapped ring buffer, so keys are pruned by stored position, never by
// slot. A query row with no visible key outputs 0.
//
// The body is decode_attention.cuh's (its notes give the design and what
// bounds the kernel); this file is the dense key-address policy: key s of
// row b is slot s, at k + b*k_sb + s*k_ss + g*k_sh, its position
// k_pos[b, s]. The first kernel of this file walked 32-key tiles
// serially in one block per (row, kv head): 0.0794 ms on an H100 at the
// verify pass of 8 slots (B 200, T 11, S 108, hd 32), 8.5x its byte bound,
// and 8 blocks on the card at B 1 (PERF.md).
//
// Plain C interface, loaded with ctypes: decode_gqa_launch returns the
// cudaError_t of the launch (0 = success).

#include "decode_attention.cuh"

namespace {

struct DenseKeys {
  const int* k_pos;   // (B, S)
  int S;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;

  __device__ __forceinline__ int n_keys() const { return S; }
  __device__ __forceinline__ void position(int b, int g, int s, int* kp,
                                           long long* ko,
                                           long long* vo) const {
    decode_attention::cp_async4(kp, k_pos + (long long)b * S + s);
    *ko = b * k_sb + s * k_ss + g * k_sh;
    *vo = b * v_sb + s * v_ss + g * v_sh;
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head_dim
// axis of the cache must be contiguous. part / part_ml: the split partials
// (n_split > 1 only, else NULL), tickets: B*Kv*q_groups zeros (n_split > 1
// only); chunk: keys per split; q_groups x group_rows: the query rows of a
// (row, kv head) in groups, one block each; vec: 16-byte copies (pointers,
// strides and rows 16-byte aligned) or plain loads. Returns a cudaError_t.
extern "C" int decode_gqa_launch(
    const void* q, const void* k, const void* v, const int* k_pos,
    const int* q_pos, void* out, float* part, float* part_ml, int* tickets,
    int B, int T, int H, int Kv, int S, int hd, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int window, float scale, int n_split, int chunk,
    int q_groups, int group_rows, int vec, int dtype, void* stream) {
  const decode_attention::Params p = decode_attention::make_params(
      q, out, q_pos, part, part_ml, tickets, T, H, Kv, hd, window, scale,
      n_split, chunk, q_groups, group_rows, vec);
  const DenseKeys keys{k_pos, S, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  return (int)decode_attention::launch(p, keys, k, v, B, dtype,
                                       static_cast<cudaStream_t>(stream));
}
