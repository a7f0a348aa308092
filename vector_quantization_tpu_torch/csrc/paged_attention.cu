// Paged decode attention for Hopper: one query token per row attends over
// that row's pages of a (L, P, ps, H, Dh) key/value pool, read through the
// row's page table, with per-row valid lengths:
//   out[b, h*Dh + d] = sum_s softmax_s(q[b,h].k[s,h] * Dh^-0.5 [* ksc[s,h]])
//                      [* vsc[s,h]] * v[s,h,d]       over s < lengths[b].
//
// Replaces the TPU kernel vector_quantization_tpu/ops/paged_attention.py
// `paged_decode_attention` (kernel body `_kernel`), whose grid step takes
// one page of all H heads and carries (m, l, o) across the page axis.
//
// What bounds it on the H100: bytes. Each live position is read once per
// head (Dh keys + Dh values [+ two f32 scales]) and used for 4*Dh
// operations, about one operation per byte, so the time floor is the live
// pages' bytes at 3.35 TB/s. What the design does about it (flash-decoding
// over the TPU kernel's page step):
// - one block per (split, row, head group): a split is a run of
//   `pages_per_split` pages of the row, a head group all H heads up to 16
//   (one warp per head). Splits that lie past the row's length exit at
//   once; no page past the length or past p_cap is read;
// - a page's (ps, H, Dh) slab is contiguous: the block streams it in
//   position chunks through a ring of shared-memory stages with 16-byte
//   `cp.async` copies (the (ps, H) scale planes with 4-byte ones, stored
//   head-major), so the next chunk loads while this one is computed. Each
//   position's row of heads is padded so that a warp's 16-byte reads hit
//   distinct banks;
// - a warp owns one head. Lane (g, c) takes the c-th 16-byte piece of the
//   rows of positions g, g + G, ... (G = 32 / pieces per row), keeps its
//   Dh^-0.5 * log2(e)-scaled f32 query piece in registers, and gets a
//   position's score by a shuffle sum over the row's pieces; int8 and bf16
//   are widened by byte permutes (exact), not by conversion instructions;
// - base-2 online softmax per chunk: one max and one sum per chunk over
//   the warp, the k scale on the score, the v scale folded into the
//   probability after l is summed, as the TPU kernel does;
// - each split writes its (m, l) and unnormalised o to a workspace, and a
//   second small kernel combines the splits of a row:
//   m* = max m_s, l = sum l_s 2^(m_s - m*), o = sum o_s 2^(m_s - m*),
//   out = o / max(l, 1e-9). With one split the block writes `out` itself.
//   No counter or ticket is kept between launches, so the two launches
//   replay in a CUDA graph as they are.
// The pool is passed whole with `layer` as an argument: no per-layer copy.
// Templated on the query type (f32, bf16), the pool type (int8 with scale
// planes, bf16, f32) and Dh in {32, 64, 128}. The plan (pages per split,
// chunk, row pitch, heads per group) comes from the Python wrapper
// (`ops/paged_attention.py` `decode_plan`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_HEADS = 16;   // warps per block, one per head of the group
constexpr int MAX_ROUNDS = 4;   // positions per lane per chunk (score registers)
constexpr int MAX_STAGES = 4;   // shared-memory stages of the chunk ring
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ksc;
  const float* vsc;
  const int* table;
  long long table_stride;
  const int* lengths;
  float* out;
  float* part;  // splits > 1: o sums (B, S, H, Dh), then (m, l) (B, S, H, 2)
  int B, H, P, ps, p_cap, layer;
  float scale;
  int heads_per_group, chunk, pitch, pages_per_split, splits, stage_bytes, stages;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n copy groups are pending (n < MAX_STAGES)
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of pool values -> VPC floats, in memory order
template <typename T>
struct Pool;

template <>
struct Pool<int8_t> {
  static constexpr int VPC = 16;
  // 0x4B0000uu is the float 2^23 + uu: with uu = b + 128 (the byte's sign
  // bit flipped), subtracting 2^23 + 128 leaves b exactly
  __device__ static __forceinline__ void unpack(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + j)) - 8388736.f;
    }
  }
};

template <>
struct Pool<__nv_bfloat16> {
  static constexpr int VPC = 8;
  __device__ static __forceinline__ void unpack(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Pool<float> {
  static constexpr int VPC = 4;
  __device__ static __forceinline__ void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

// pages a row attends (never past p_cap); 0 for a length-0 row
__device__ __forceinline__ int row_pages(int len, int ps, int p_cap) {
  return len > 0 ? min((len - 1) / ps + 1, p_cap) : 0;
}

template <typename QT, typename KT, int DH>
__global__ void __launch_bounds__(MAX_HEADS * 32, 2) paged_split_kernel(const Args a) {
  using PT = Pool<KT>;
  constexpr int VPC = PT::VPC;
  constexpr int ROW = DH * (int)sizeof(KT);  // bytes of one (position, head) row
  constexpr int NC = ROW / 16;               // 16-byte pieces per row: lanes per position
  constexpr int G = 32 / NC;                 // positions a warp covers per round
  constexpr bool INT8 = std::is_same<KT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x, b = blockIdx.y;
  const int hg = a.heads_per_group, h0 = blockIdx.z * hg;
  const int nh = min(hg, a.H - h0);  // heads of this group
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = a.lengths[b];
  const int n_pages = row_pages(len, a.ps, a.p_cap);
  const int p_begin = split * a.pages_per_split;
  if (p_begin >= n_pages) {  // nothing to attend in this split
    if (a.splits == 1)
      for (int e = tid; e < nh * DH; e += blockDim.x) a.out[((size_t)b * a.H + h0) * DH + e] = 0.f;
    return;
  }
  const int p_end = min(p_begin + a.pages_per_split, n_pages);
  const int cpp = (a.ps + a.chunk - 1) / a.chunk;  // chunks per page
  const int live = min(len, p_end * a.ps) - p_begin * a.ps;
  const int n_items = (live / a.ps) * cpp + (live % a.ps + a.chunk - 1) / a.chunk;
  const int kv_bytes = a.chunk * a.pitch;
  const int* trow = a.table + (size_t)b * a.table_stride;

  // A chunk cursor walks the split's chunks in order: (page, first position).
  // Its length is the chunk's positions that lie before the row's length.
  struct Cursor {
    int p, c0;
  };
  auto advance = [&](Cursor& u) {
    u.c0 += a.chunk;
    if (u.c0 >= a.ps) {
      u.c0 = 0;
      ++u.p;
    }
  };
  auto chunk_len = [&](const Cursor& u) {
    return min(min(a.chunk, a.ps - u.c0), len - (u.p * a.ps + u.c0));
  };

  // copy roles, fixed for the kernel: thread -> (position lane, 16-byte
  // piece of the position's heads) for K/V, (position lane, head) for scales
  const int row_pieces = nh * NC;
  const int kv_step = blockDim.x / row_pieces, kv_s0 = tid / row_pieces;
  const int kv_r = (tid - kv_s0 * row_pieces) * 16;
  const int sc_step = blockDim.x / nh, sc_s0 = tid / nh, sc_h = tid - sc_s0 * nh;
  const size_t gstride = (size_t)a.H * ROW;
  Cursor in{p_begin, 0};
  int issued = 0, in_stage = 0;
  auto issue = [&]() {
    if (issued < n_items) {
      unsigned char* sk = smem + in_stage * a.stage_bytes;
      const int n = chunk_len(in);
      const size_t pos = ((size_t)a.layer * a.P + trow[in.p]) * a.ps + in.c0;  // (layer, page, c0)
      const char* gk = (const char*)a.kp + (pos * a.H + h0) * ROW + kv_r;
      const char* gv = (const char*)a.vp + (pos * a.H + h0) * ROW + kv_r;
      if (kv_s0 < kv_step)
        for (int s = kv_s0; s < n; s += kv_step) {
          cp_async16(sk + s * a.pitch + kv_r, gk + s * gstride);
          cp_async16(sk + kv_bytes + s * a.pitch + kv_r, gv + s * gstride);
        }
      if constexpr (INT8) {
        float* ks = reinterpret_cast<float*>(sk + 2 * kv_bytes) + sc_h * a.chunk;
        float* vs = ks + hg * a.chunk;
        const size_t g0 = pos * a.H + h0 + sc_h;
        if (sc_s0 < sc_step)
          for (int s = sc_s0; s < n; s += sc_step) {
            cp_async4(ks + s, a.ksc + g0 + (size_t)s * a.H);
            cp_async4(vs + s, a.vsc + g0 + (size_t)s * a.H);
          }
      }
      advance(in);
    }
    ++issued;
    if (++in_stage == a.stages) in_stage = 0;
    cp_commit();  // an empty group past the end keeps the wait counts uniform
  };

  const bool computes = warp < nh;
  const int g = lane / NC, c = lane % NC;
  const int h = h0 + warp;
  float qv[VPC], acc[VPC];
  float m = -INFINITY, l = 0.f;
#pragma unroll
  for (int j = 0; j < VPC; ++j) acc[j] = 0.f;
  if (computes) {
    const QT* qp = reinterpret_cast<const QT*>(a.q) + ((size_t)b * a.H + h) * DH + c * VPC;
#pragma unroll
    for (int j = 0; j < VPC; ++j) qv[j] = to_f32(qp[j]) * a.scale * LOG2E;
  }

  for (int i = 0; i < a.stages; ++i) issue();
  Cursor cur{p_begin, 0};
  for (int i = 0, st = 0; i < n_items; ++i, st = st + 1 == a.stages ? 0 : st + 1) {
    cp_wait(a.stages - 1);
    __syncthreads();
    const int n = chunk_len(cur);
    advance(cur);
    if (computes) {
      const unsigned char* sk = smem + st * a.stage_bytes + warp * ROW + c * 16;
      const unsigned char* sv = sk + kv_bytes;
      const float* ks = reinterpret_cast<const float*>(smem + st * a.stage_bytes + 2 * kv_bytes) +
                        warp * a.chunk;
      const float* vs = ks + hg * a.chunk;
      float sc[MAX_ROUNDS];
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < MAX_ROUNDS; ++r) {
        sc[r] = -INFINITY;
        if (r * G < n) {  // warp-uniform
          const int s = r * G + g;
          float part = 0.f;
          if (s < n) {
            float f[VPC], p2[2] = {0.f, 0.f};  // two chains: half the dependent latency
            PT::unpack(*reinterpret_cast<const uint4*>(sk + s * a.pitch), f);
#pragma unroll
            for (int j = 0; j < VPC; ++j) p2[j & 1] = fmaf(qv[j], f[j], p2[j & 1]);
            part = p2[0] + p2[1];
          }
#pragma unroll
          for (int o = NC / 2; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
          if (s < n) {
            if constexpr (INT8) part *= ks[s];
            sc[r] = part;
          }
          mx = fmaxf(mx, sc[r]);
        }
      }
#pragma unroll
      for (int o = NC; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m, mx);  // finite: the chunk holds a valid position
      const float alpha = exp2f(m - m_new);
      float prob[MAX_ROUNDS], psum = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_ROUNDS; ++r) {
        prob[r] = exp2f(sc[r] - m_new);  // 0 where the position is not valid
        psum += prob[r];
      }
#pragma unroll
      for (int o = NC; o < 32; o <<= 1) psum += __shfl_xor_sync(FULL, psum, o);
      l = l * alpha + psum;
      if (m_new != m)  // warp-uniform
#pragma unroll
        for (int j = 0; j < VPC; ++j) acc[j] *= alpha;
#pragma unroll
      for (int r = 0; r < MAX_ROUNDS; ++r) {
        const int s = r * G + g;
        if (r * G < n && s < n) {
          float pv = prob[r];
          if constexpr (INT8) pv *= vs[s];
          float f[VPC];
          PT::unpack(*reinterpret_cast<const uint4*>(sv + s * a.pitch), f);
#pragma unroll
          for (int j = 0; j < VPC; ++j) acc[j] = fmaf(pv, f[j], acc[j]);
        }
      }
      m = m_new;
    }
    __syncthreads();
    issue();
  }

  if (!computes) return;
#pragma unroll
  for (int j = 0; j < VPC; ++j)
#pragma unroll
    for (int o = NC; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(FULL, acc[j], o);
  if (g != 0) return;
  float* dst;
  if (a.splits == 1) {
    const float inv = 1.f / fmaxf(l, 1e-9f);
#pragma unroll
    for (int j = 0; j < VPC; ++j) acc[j] *= inv;
    dst = a.out + ((size_t)b * a.H + h) * DH + c * VPC;
  } else {
    const size_t idx = ((size_t)b * a.splits + split) * a.H + h;
    dst = a.part + idx * DH + c * VPC;
    if (c == 0) {
      float* ml = a.part + (size_t)a.B * a.splits * a.H * DH + 2 * idx;
      ml[0] = m;
      ml[1] = l;
    }
  }
#pragma unroll
  for (int j = 0; j < VPC; j += 4)
    *reinterpret_cast<float4*>(dst + j) = make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
}

// out[b, h] = the splits' partial sums of (row b, head h), rescaled to one
// max: one warp per (b, h); the splits' (m, l) and o loads are independent,
// so each lane waits for device memory about twice
template <int DH>
__global__ void __launch_bounds__(MAX_HEADS * 32) paged_combine_kernel(const Args a) {
  constexpr int DPL = DH / 32;  // output values per lane
  const int b = blockIdx.x, h = blockIdx.y * MAX_HEADS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (h >= a.H) return;
  const int n_live = (row_pages(a.lengths[b], a.ps, a.p_cap) + a.pages_per_split - 1) /
                     a.pages_per_split;
  const size_t row0 = (size_t)b * a.splits * a.H + h;  // (b, split 0, h)
  const float2* ml = reinterpret_cast<const float2*>(a.part + (size_t)a.B * a.splits * a.H * DH);
  float mx = -INFINITY;
  for (int s = lane; s < n_live; s += 32) mx = fmaxf(mx, ml[row0 + (size_t)s * a.H].x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  float l = 0.f, o[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) o[j] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_live; ++s) {
    const size_t idx = row0 + (size_t)s * a.H;
    const float2 sml = ml[idx];
    const float w = exp2f(sml.x - mx);
    l = fmaf(w, sml.y, l);
    const float* src = a.part + idx * DH + lane * DPL;
#pragma unroll
    for (int j = 0; j < DPL; ++j) o[j] = fmaf(w, src[j], o[j]);
  }
  const float inv = 1.f / fmaxf(l, 1e-9f);
  float* dst = a.out + ((size_t)b * a.H + h) * DH + lane * DPL;
#pragma unroll
  for (int j = 0; j < DPL; ++j) dst[j] = o[j] * inv;
}

template <typename QT, typename KT, int DH>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int ROW = DH * (int)sizeof(KT);
  constexpr int G = 32 / (ROW / 16);
  constexpr bool INT8 = std::is_same<KT, int8_t>::value;
  const int hg = a.heads_per_group;
  const int need = 2 * a.chunk * a.pitch + (INT8 ? 8 * hg * a.chunk : 0);
  if (a.chunk < 1 || a.chunk > MAX_ROUNDS * G || a.pitch % 16 != 0 || a.pitch < hg * ROW ||
      a.stage_bytes < need || a.stage_bytes % 16 != 0 || a.stages < 1 ||
      a.stages > MAX_STAGES || a.stages * a.stage_bytes > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int smem = a.stages * a.stage_bytes;
  auto kernel = paged_split_kernel<QT, KT, DH>;
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid(a.splits, a.B, (a.H + hg - 1) / hg);
  kernel<<<grid, hg * 32, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  paged_combine_kernel<DH><<<dim3(a.B, (a.H + MAX_HEADS - 1) / MAX_HEADS), MAX_HEADS * 32, 0,
                             stream>>>(a);
  return (int)cudaGetLastError();
}

// resident blocks per SM of the split kernel under the plan's shared memory
template <typename QT, typename KT, int DH>
int occupancy(const Args& a, cudaStream_t) {
  auto kernel = paged_split_kernel<QT, KT, DH>;
  const int smem = a.stages * a.stage_bytes;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, a.heads_per_group * 32, smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

template <typename QT, typename KT, bool PLAN>
int launch_dh(const Args& a, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 32: return PLAN ? occupancy<QT, KT, 32>(a, stream) : launch<QT, KT, 32>(a, stream);
    case 64: return PLAN ? occupancy<QT, KT, 64>(a, stream) : launch<QT, KT, 64>(a, stream);
    case 128: return PLAN ? occupancy<QT, KT, 128>(a, stream) : launch<QT, KT, 128>(a, stream);
    default: return PLAN ? -(int)cudaErrorInvalidValue : (int)cudaErrorInvalidValue;
  }
}

template <bool PLAN>
int dispatch(const Args& a, int q_dtype, int kv_dtype, int Dh, cudaStream_t s) {
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_dh<float, float, PLAN>(a, Dh, s);
    if (kv_dtype == 1) return launch_dh<float, __nv_bfloat16, PLAN>(a, Dh, s);
    if (kv_dtype == 2) return launch_dh<float, int8_t, PLAN>(a, Dh, s);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_dh<__nv_bfloat16, float, PLAN>(a, Dh, s);
    if (kv_dtype == 1) return launch_dh<__nv_bfloat16, __nv_bfloat16, PLAN>(a, Dh, s);
    if (kv_dtype == 2) return launch_dh<__nv_bfloat16, int8_t, PLAN>(a, Dh, s);
  }
  return PLAN ? -(int)cudaErrorInvalidValue : (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pool only; needs scales).
// `workspace` holds B * splits * H * (Dh + 2) floats when splits > 1 (else
// null); pages_per_split * splits must cover p_cap.
extern "C" int vqt_paged_decode_attention(
    const void* q, int q_dtype, const void* k_pool, const void* v_pool, int kv_dtype,
    const void* k_scale, const void* v_scale, const int* table, long long table_stride,
    const int* lengths, void* out, void* workspace, int B, int H, int Dh, int P, int ps,
    int p_cap, int layer, float scale, int heads_per_group, int chunk, int pitch,
    int pages_per_split, int splits, int stage_bytes, int stages, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || ps < 1 || p_cap < 1 || heads_per_group < 1 ||
      heads_per_group > MAX_HEADS || splits < 1 || pages_per_split < 1 ||
      (long long)pages_per_split * splits < p_cap ||
      (long long)pages_per_split * (splits - 1) >= p_cap || (splits > 1) != (workspace != nullptr) ||
      (kv_dtype == 2) != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, (const float*)k_scale, (const float*)v_scale, table,
               table_stride, lengths, (float*)out, (float*)workspace, B, H, P, ps, p_cap,
               layer, scale, heads_per_group, chunk, pitch, pages_per_split, splits,
               stage_bytes, stages};
  return dispatch<false>(a, q_dtype, kv_dtype, Dh, (cudaStream_t)stream);
}

// Resident blocks per SM of the split kernel for these types, Dh, heads per
// group, stage size and stage count (negative: a CUDA error).
extern "C" int vqt_paged_decode_attention_occupancy(int q_dtype, int kv_dtype, int Dh,
                                                    int heads_per_group, int stage_bytes,
                                                    int stages) {
  Args a{};
  a.heads_per_group = heads_per_group;
  a.stage_bytes = stage_bytes;
  a.stages = stages;
  return dispatch<true>(a, q_dtype, kv_dtype, Dh, nullptr);
}
