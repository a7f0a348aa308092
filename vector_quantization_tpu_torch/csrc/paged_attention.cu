// Paged decode attention for Hopper: one query token per row attends over
// that row's pages of a (L, P, ps, H, Dh) key/value pool, read through the
// row's page table, with per-row valid lengths:
//   out[b, h*Dh + d] = sum_s softmax_s(q[b,h].k[s,h] * Dh^-0.5 [* ksc[s,h]])
//                      [* vsc[s,h]] * v[s,h,d]       over s < lengths[b].
//
// Replaces the TPU kernel vector_quantization_tpu/ops/paged_attention.py
// `paged_decode_attention` (kernel body `_kernel`).
//
// What bounds it on the H100: bytes. Each live position is read once per
// head (Dh int8 keys + Dh int8 values + two f32 scales) and used for 4*Dh
// operations, about one operation per byte, so the time floor is the live
// pages' bytes at 3.35 TB/s. What the design does about it:
// - one warp per (row, head); the warp loads its own page-table row and
//   length and walks pages 0..(length-1)/ps only (never past the page
//   table's width), so no byte of a dead page or a padded position is read;
// - scores: lane j takes position j of each 32-position chunk and reads its
//   key row (Dh contiguous values) with 16-byte loads; the query, scaled by
//   Dh^-0.5 in f32, sits in shared memory and is read as a broadcast;
// - online softmax (m, l, o) in registers, Dh/32 output values per lane;
//   the INT8 key scale multiplies the score, the value scale is folded into
//   the probability after l is accumulated, as the TPU kernel does;
// - values: for each position the warp reads one contiguous Dh row, lane
//   j taking elements [j*Dh/32, (j+1)*Dh/32).
// The pool is passed whole with `layer` as an argument: no per-layer copy.
// Templated on the query type (f32, bf16) and the pool type (int8 with
// scale planes, bf16, f32); Dh in {32, 64, 128}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // heads per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// q . row over DH contiguous pool values (16-byte loads; rows are aligned
// because DH * sizeof(T) is a multiple of 16 and the pool base is)
template <typename T, int DH>
__device__ __forceinline__ float dot_row(const float* qs, const T* row) {
  constexpr int PER = 16 / sizeof(T);
  float acc = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < DH; d0 += PER) {
    union {
      uint4 v;
      T e[PER];
    } u;
    u.v = *reinterpret_cast<const uint4*>(row + d0);
#pragma unroll
    for (int j = 0; j < PER; ++j) acc = fmaf(qs[d0 + j], to_f32(u.e[j]), acc);
  }
  return acc;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename QT, typename KT, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
paged_attn_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                  const KT* __restrict__ vp, const float* __restrict__ ksc,
                  const float* __restrict__ vsc,
                  const int* __restrict__ table, long long table_stride,
                  const int* __restrict__ lengths, float* __restrict__ out,
                  int H, int P, int ps, int p_cap, int layer, float scale) {
  constexpr int DH = 32 * DPL;
  __shared__ __align__(16) float qs_all[WARPS][DH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x * WARPS + warp;
  const int b = blockIdx.y;
  if (h >= H) return;  // whole warp leaves; no block-wide barrier below
  float* qs = qs_all[warp];
  const size_t qoff = ((size_t)b * H + h) * DH;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    qs[lane + 32 * i] = to_f32(q[qoff + lane + 32 * i]) * scale;
  __syncwarp();

  const int len = lengths[b];
  float m = -INFINITY, l = 0.f;
  float o[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) o[i] = 0.f;

  const int n_pages = len > 0 ? min((len - 1) / ps + 1, p_cap) : 0;
  const int* trow = table + (size_t)b * table_stride;
  for (int p = 0; p < n_pages; ++p) {
    const int page = trow[p];
    // index of (layer, page, position 0) in the (L, P, ps) position space
    const size_t pos0 = ((size_t)layer * P + page) * ps;
    for (int s0 = 0; s0 < ps; s0 += 32) {
      const int base = p * ps + s0;  // logical position of lane 0
      if (base >= len) break;
      const int s = s0 + lane;
      const bool valid = s < ps && base + lane < len;
      float score = -INFINITY;
      if (valid) {
        const size_t r = (pos0 + s) * H + h;
        score = dot_row<KT, DH>(qs, kp + r * DH);
        if (ksc != nullptr) score *= ksc[r];
      }
      const float m_new = fmaxf(m, warp_max(score));
      const float alpha = expf(m - m_new);
      float prob = valid ? expf(score - m_new) : 0.f;
      l = l * alpha + warp_sum(prob);
      if (valid && vsc != nullptr) prob *= vsc[(pos0 + s) * H + h];
#pragma unroll
      for (int i = 0; i < DPL; ++i) o[i] *= alpha;
      const int n_valid = min(min(32, ps - s0), len - base);
#pragma unroll 8
      for (int j = 0; j < n_valid; ++j) {
        const float pj = __shfl_sync(0xffffffffu, prob, j);
        const KT* vrow = vp + ((pos0 + s0 + j) * H + h) * DH + lane * DPL;
#pragma unroll
        for (int i = 0; i < DPL; ++i) o[i] = fmaf(pj, to_f32(vrow[i]), o[i]);
      }
      m = m_new;
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-9f);
  float* dst = out + ((size_t)b * H + h) * DH + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) dst[i] = o[i] * inv;
}

template <typename QT, typename KT>
int launch(const void* q, const void* kp, const void* vp, const void* ksc,
           const void* vsc, const int* table, long long table_stride,
           const int* lengths, float* out, int B, int H, int Dh, int P, int ps,
           int p_cap, int layer, float scale, cudaStream_t stream) {
  const dim3 grid((H + WARPS - 1) / WARPS, B);
#define VQT_LAUNCH(DPL)                                                     \
  paged_attn_kernel<QT, KT, DPL><<<grid, WARPS * 32, 0, stream>>>(          \
      (const QT*)q, (const KT*)kp, (const KT*)vp, (const float*)ksc,        \
      (const float*)vsc, table, table_stride, lengths, out, H, P, ps, p_cap, \
      layer, scale)
  switch (Dh) {
    case 32: VQT_LAUNCH(1); break;
    case 64: VQT_LAUNCH(2); break;
    case 128: VQT_LAUNCH(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef VQT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pool only; needs scales)
extern "C" int vqt_paged_decode_attention(
    const void* q, int q_dtype, const void* k_pool, const void* v_pool,
    int kv_dtype, const void* k_scale, const void* v_scale, const int* table,
    long long table_stride, const int* lengths, void* out, int B, int H,
    int Dh, int P, int ps, int p_cap, int layer, float scale, void* stream) {
  if (B < 1 || H < 1 || ps < 1 || p_cap < 1 || (kv_dtype == 2) != (k_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
#define VQT_ARGS                                                          \
  q, k_pool, v_pool, k_scale, v_scale, table, table_stride, lengths, o, B, \
      H, Dh, P, ps, p_cap, layer, scale, s
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch<float, float>(VQT_ARGS);
    if (kv_dtype == 1) return launch<float, __nv_bfloat16>(VQT_ARGS);
    if (kv_dtype == 2) return launch<float, int8_t>(VQT_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch<__nv_bfloat16, float>(VQT_ARGS);
    if (kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(VQT_ARGS);
    if (kv_dtype == 2) return launch<__nv_bfloat16, int8_t>(VQT_ARGS);
  }
#undef VQT_ARGS
  return (int)cudaErrorInvalidValue;
}
