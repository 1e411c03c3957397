// Paged-cache GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_gqa/kernel.py::
// paged_decode_gqa_kernel (body _paged_decode_kernel, oracle
// paged_decode_gqa_ref). It is the paged read of every Molecular
// Transformer decoder layer under the streaming engine: the T = DL+1 fed
// tokens of each row attend to the keys of the pool pages the row's block
// table maps (logical block j of row b is page bt[b, j], -1 = unmapped;
// page 0 is the trash page), masked on the stored positions (-1 = empty
// slot, causal k_pos <= q_pos, optional sliding window k_pos > q_pos -
// window). A query row with no visible key outputs 0.
//
// The body is decode_attention.cuh's (its notes give the design and what
// bounds the kernel); this file is the paged key-address policy: logical
// key s of row b is slot j = s % ps of page bt[b, s / ps], at k + page*k_sp
// + j*k_ss + g*k_sh, its position pos[page, j]. Each thread reads its keys'
// block-table entries and stored positions first; a key of an unmapped
// block, an empty slot or a key no query of the row can see is never
// loaded, and a 32-key step with none visible is skipped. The pool is read
// in the model's (P, ps, Kv, hd) layout through its strides. The first
// kernel of this file walked 32-key tiles serially in one block per
// (row, kv head): 0.0504 ms on an H100 at the verify pass of 8 slots (B
// 200, T 11, 7 blocks of 16), 9x its byte bound (PERF.md).
//
// Plain C interface, loaded with ctypes: paged_decode_gqa_launch returns
// the cudaError_t of the launch (0 = success).

#include "decode_attention.cuh"

namespace {

struct PagedKeys {
  const int* pos;   // (P, ps)
  const int* bt;    // (B, nb)
  int ps, nb;
  long long k_sp, k_ss, k_sh, v_sp, v_ss, v_sh;

  __device__ __forceinline__ int n_keys() const { return nb * ps; }
  __device__ __forceinline__ void position(int b, int g, int s, int* kp,
                                           long long* ko,
                                           long long* vo) const {
    const int blk = s / ps, j = s - blk * ps;
    const int page = bt[(long long)b * nb + blk];
    if (page < 0) {
      *kp = -1;   // unmapped block: nothing is read
      return;
    }
    decode_attention::cp_async4(kp, pos + (long long)page * ps + j);
    *ko = page * k_sp + j * k_ss + g * k_sh;
    *vo = page * v_sp + j * v_ss + g * v_sh;
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pool strides (page, slot, head) are in
// elements; the head_dim axis of the pools must be contiguous, pos (P, ps),
// bt (B, nb) and q_pos (B, T) contiguous int32. part / part_ml / tickets,
// chunk, q_groups / group_rows and vec as for decode_gqa_launch. Returns a
// cudaError_t.
extern "C" int paged_decode_gqa_launch(
    const void* q, const void* k, const void* v, const int* pos, const int* bt,
    const int* q_pos, void* out, float* part, float* part_ml, int* tickets,
    int B, int T, int H, int Kv, int ps, int nb, int hd, long long k_sp,
    long long k_ss, long long k_sh, long long v_sp, long long v_ss,
    long long v_sh, int window, float scale, int n_split, int chunk,
    int q_groups, int group_rows, int vec, int dtype, void* stream) {
  const decode_attention::Params p = decode_attention::make_params(
      q, out, q_pos, part, part_ml, tickets, T, H, Kv, hd, window, scale,
      n_split, chunk, q_groups, group_rows, vec);
  const PagedKeys keys{pos, bt, ps, nb, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh};
  return (int)decode_attention::launch(p, keys, k, v, B, dtype,
                                       static_cast<cudaStream_t>(stream));
}
