// Weight-only INT8 matmul (W8A16) for Hopper: out (B, F) f32 =
//   (x (B, D) bf16 @ w (D, F) int8 converted to bf16) * scale (F,) f32,
// with f32 accumulation and the per-output-channel scale applied to the f32
// sum on the way out.
//
// Replaces the TPU kernel vector_quantization_tpu/ops/int8_matmul.py
// `_int8_matmul_pallas` (kernel body `_kernel`).
//
// What bounds it on the H100: bytes. At the decode batch (B = 64) the
// product does 2*B = 128 operations per weight byte, far below the card's
// ~295 bf16 operations per byte of HBM, so the time floor is one read of
// the int8 weight (D*F bytes) at 3.35 TB/s. What the design does about it:
// - each weight byte is read from HBM once, as 16-byte vector loads where
//   the row pitch allows, and converted to bf16 in registers (int8 values
//   are exact in bf16); the bf16 copy never exists in memory;
// - the products run on the tensor cores (mma.sync m16n8k16 bf16 -> f32),
//   so arithmetic is never the limit;
// - the grid covers F in 128-column tiles AND splits D (split-K) so that
//   about two blocks per SM are in flight even at F = 1024, and the next
//   K tile's loads are issued before the current tile's products (register
//   prefetch). Split partial sums are scaled and added with f32 atomics
//   into an output the caller zeroed; with one split the kernel stores.
// Any B >= 1, D >= 1 and F >= 1 are taken: ragged edges (F = 17385, a D
// that is not a multiple of 32) load with per-element bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // rows of x per block (the decode batch)
constexpr int BN = 128;   // output columns per block
constexpr int BK = 32;    // depth per shared-memory tile
constexpr int THREADS = 256;  // 8 warps; warp w owns columns [16w, 16w+16)
constexpr int XP = BK + 8;    // x tile pitch (bf16): conflict-free fragments
constexpr int WP = BN + 16;   // w tile pitch (bytes)

__device__ __forceinline__ uint32_t pack_bf16(int8_t lo, int8_t hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn((float)lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn((float)hi));
  return l | (h << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

union Vec16 {
  uint4 v;
  __nv_bfloat16 h[8];
  int8_t b[16];
};

__global__ void __launch_bounds__(THREADS)
w8a16_kernel(const __nv_bfloat16* __restrict__ x,
             const int8_t* __restrict__ w,
             const float* __restrict__ scale,
             float* __restrict__ out,
             int B, int D, int F, int k_chunk, int atomic) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM * XP];
  __shared__ __align__(16) int8_t ws[BK * WP];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(D, k_begin + k_chunk);
  const int m0 = blockIdx.z * BM;
  if (k_begin >= k_end) return;

  // loader mapping: x row tid/4, 8 bf16 at column 8*(tid%4);
  //                 w row tid/8, 16 bytes at column 16*(tid%8)
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const int wr = tid >> 3, wc = (tid & 7) * 16;
  const bool x_vec = (D % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const bool w_vec = (F % 16 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);

  Vec16 xreg, wreg;
  auto load_tile = [&](int k0) {
    const int row = m0 + xr, col = k0 + xc;
    if (x_vec && row < B && col + 8 <= k_end) {
      xreg.v = *reinterpret_cast<const uint4*>(x + (size_t)row * D + col);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        xreg.h[j] = (row < B && col + j < k_end)
                        ? x[(size_t)row * D + col + j]
                        : __float2bfloat16_rn(0.f);
    }
    const int krow = k0 + wr, ncol = n0 + wc;
    if (w_vec && krow < k_end && ncol + 16 <= F) {
      wreg.v = *reinterpret_cast<const uint4*>(w + (size_t)krow * F + ncol);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        wreg.b[j] = (krow < k_end && ncol + j < F)
                        ? w[(size_t)krow * F + ncol + j]
                        : (int8_t)0;
    }
  };

  float acc[4][2][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  const int ntiles = (k_end - k_begin + BK - 1) / BK;
  load_tile(k_begin);
  for (int it = 0; it < ntiles; ++it) {
    *reinterpret_cast<uint4*>(&xs[xr * XP + xc]) = xreg.v;
    *reinterpret_cast<uint4*>(&ws[wr * WP + wc]) = wreg.v;
    __syncthreads();
    if (it + 1 < ntiles) load_tile(k_begin + (it + 1) * BK);

#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* base = &xs[(mi * 16 + g) * XP + ks + 2 * t];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * XP);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * XP + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int n = warp * 16 + ni * 8 + g;
        const int k = ks + 2 * t;
        const uint32_t b0 = pack_bf16(ws[k * WP + n], ws[(k + 1) * WP + n]);
        const uint32_t b1 =
            pack_bf16(ws[(k + 8) * WP + n], ws[(k + 9) * WP + n]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: c0,c1 -> row g, cols 2t, 2t+1; c2,c3 -> row g+8
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int col0 = n0 + warp * 16 + ni * 8 + 2 * t;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + mi * 16 + g + (c >> 1) * 8;
        const int col = col0 + (c & 1);
        if (row < B && col < F) {
          const float v = acc[mi][ni][c] * scale[col];
          float* dst = out + (size_t)row * F + col;
          if (atomic) atomicAdd(dst, v);
          else *dst = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" int vqt_int8_matmul(const void* x, const void* w, const void* scale,
                               void* out, int B, int D, int F, int k_chunk,
                               void* stream) {
  if (B < 1 || D < 1 || F < 1 || k_chunk < BK || k_chunk % BK != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((F + BN - 1) / BN, (D + k_chunk - 1) / k_chunk,
                  (B + BM - 1) / BM);
  const int atomic = grid.y > 1 ? 1 : 0;
  w8a16_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale,
      (float*)out, B, D, F, k_chunk, atomic);
  return (int)cudaGetLastError();
}
