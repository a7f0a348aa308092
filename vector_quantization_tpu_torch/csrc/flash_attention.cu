// Causal flash attention for Hopper, forward and backward, in three kernels:
//   K4-fwd:  o = softmax(q k^T * scale, causal) v  and  lse = m + log(l)
//   K4-dkv:  dk, dv  from q, k, v, dO, lse and di = sum(o * dO)
//   K4-dq:   dq      from the same
// q, k, v, o, dO, dq, dk, dv are bf16 in the model's (B, T, H, Dh) layout,
// contiguous (row t of head h at (b*T + t)*H*Dh + h*Dh); lse and di are f32
// (B, H, T). Sums are f32; P and dS are rounded to bf16 before the products
// that take them, as the TPU kernels do.
//
// Replaces the TPU kernels that vector_quantization_tpu/models/transformers/
// llama.py `_flash_train_attention` reaches through
// jax.experimental.pallas.ops.tpu.flash_attention: `_flash_attention_kernel`
// (forward), `_flash_attention_dkv_kernel` and `_flash_attention_dq_kernel`.
//
// What bounds them on the H100: at the training shape (T = 257, Dh = 64)
// the causal products do ~2 * T/2 * Dh * 2 operations per (row, head) for
// ~4 * Dh * 2 bytes, about 130 operations per byte: under the card's ~295
// bf16 operations per byte, so bytes bound the ideal kernel, and the
// operations' floor is within a factor of ~4 of it. What the design does:
// - one block per (64-row tile, batch * head): 4 warps, 16 rows each; the
//   block stages its 64-row tile and then each 64-row tile of the other
//   side in shared memory (16-byte loads, ragged rows zero-filled, never
//   padded by a copy in memory);
// - the products run on the tensor cores (mma.sync m16n8k16 bf16 -> f32);
//   S, P and dS stay in registers and are never written to memory, and a
//   C fragment of P or dS is repacked in registers as the A operand of the
//   next product;
// - the causal walk stops at the diagonal tile (forward and dq walk the
//   k/v tiles up to it, dkv walks the q tiles from it), and blocks with the
//   longest walks are scheduled first;
// - no atomics: dkv owns its k/v rows, dq its q rows, as in the TPU kernels.
// Left for later: wgmma, TMA or cp.async pipelining of the tiles, ldmatrix.
// Dh = 32, 64 and 128 are compiled; any T >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;        // rows per tile, on both the q and the k/v side
constexpr int THREADS = 128;  // 4 warps; warp w owns rows [16w, 16w + 16)

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from different rows of a tile, `lo` in the low half
__device__ __forceinline__ uint32_t pair(const bf16* lo, const bf16* hi) {
  return (uint32_t)__bfloat16_as_ushort(*lo) |
         ((uint32_t)__bfloat16_as_ushort(*hi) << 16);
}

// rows [row0, row0 + BM) of one head -> a (BM, DH + 8) shared tile; rows
// at or past T read as 0
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int T, size_t rs) {
  constexpr int P = DH + 8, CHUNKS = DH / 8;
  for (int i = threadIdx.x; i < BM * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * P + c) = val;
  }
}

// A operand (16 x 16, row-major) from rows [r0, r0 + 16) of a shared tile
template <int P>
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* tile, int r0,
                                       int ks, int g, int t) {
  const bf16* p = tile + (r0 + g) * P + ks + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * P);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * P + 8);
}

// A operand of k-step kk from the C fragments of a 16 x BM product
__device__ __forceinline__ void frag_a_regs(uint32_t* a, const float (*c)[4],
                                            int kk) {
  a[0] = pack2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// S (16 x BM) += A-tile rows [r0, r0+16) . B-tile^T, both (BM, DH) in shared
// memory with the contraction (DH) contiguous
template <int DH>
__device__ __forceinline__ void rows_dot_rows(float (*s)[4], const bf16* at,
                                              const bf16* bt, int r0, int g,
                                              int t) {
  constexpr int P = DH + 8;
#pragma unroll
  for (int ks = 0; ks < DH; ks += 16) {
    uint32_t a[4];
    frag_a<P>(a, at, r0, ks, g, t);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
      const bf16* bp = bt + (nt * 8 + g) * P + ks + 2 * t;
      mma_bf16(s[nt], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc (16 x DH) += C (16 x BM, registers, rounded to bf16) . tile (BM, DH)
template <int DH>
__device__ __forceinline__ void regs_dot_tile(float (*acc)[4],
                                              const float (*c)[4],
                                              const bf16* tile, int g, int t) {
  constexpr int P = DH + 8;
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk) {
    uint32_t a[4];
    frag_a_regs(a, c, kk);
    const bf16* row = tile + (kk * 16 + 2 * t) * P + g;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      const bf16* p = row + dt * 8;
      mma_bf16(acc[dt], a, pair(p, p + P), pair(p + 8 * P, p + 9 * P));
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// store a warp's 16 x DH accumulator (rows ra, ra + 8) as bf16 rows < T
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, const float (*acc)[4],
                                           int ra, int T, size_t rs, int t,
                                           float mul_a, float mul_b) {
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (ra < T)
      *reinterpret_cast<uint32_t*>(dst + (size_t)ra * rs + col) =
          pack2(acc[dt][0] * mul_a, acc[dt][1] * mul_a);
    if (ra + 8 < T)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(ra + 8) * rs + col) =
          pack2(acc[dt][2] * mul_b, acc[dt][3] * mul_b);
  }
}

// grid (B*H, ceil(T/BM)); q tiles with the longest k/v walk run first
template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int H, float scale) {
  constexpr int P = DH + 8, NT = BM / 8, DT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * P;
  bf16* Vs = Ks + BM * P;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const size_t rs = (size_t)H * DH;
  const size_t base = (size_t)b * T * rs + (size_t)h * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;

  load_tile<DH>(Qs, q + base, q0, T, rs);
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;

  const int kv_end = min(T, q0 + BM);
  for (int j0 = 0; j0 < kv_end; j0 += BM) {
    __syncthreads();
    load_tile<DH>(Ks, k + base, j0, T, rs);
    load_tile<DH>(Vs, v + base, j0, T, rs);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
    rows_dot_rows<DH>(s, Qs, Ks, warp * 16, g, t);

    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j0 + nt * 8 + 2 * t + (c & 1);
        const int row = c < 2 ? ra : rb;
        float x = s[nt][c] * scale;
        if (col > row || col >= T) x = -INFINITY;
        s[nt][c] = x;
        if (c < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    // a row with every score so far masked keeps m = -inf: exp base 0
    const float e_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float e_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = expf(m_a - e_a), al_b = expf(m_b - e_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[nt][c] - (c < 2 ? e_a : e_b));
        s[nt][c] = p;
        if (c < 2) sum_a += p;
        else sum_b += p;
      }
    l_a = l_a * al_a + sum_a;  // this thread's columns; summed over the quad below
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= al_a;
      acc[dt][1] *= al_a;
      acc[dt][2] *= al_b;
      acc[dt][3] *= al_b;
    }
    regs_dot_tile<DH>(acc, s, Vs, g, t);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  store_rows<DH>(o + base, acc, ra, T, rs, t, 1.f / l_a, 1.f / l_b);
  if (t == 0) {
    if (ra < T) lse[(size_t)bh * T + ra] = m_a + logf(l_a);
    if (rb < T) lse[(size_t)bh * T + rb] = m_b + logf(l_b);
  }
}

// grid (B*H, ceil(T/BM)); the k/v tile j0 = blockIdx.y * BM walks the q
// tiles from the diagonal on (the first tiles have the longest walks)
template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int T, int H, float scale) {
  constexpr int P = DH + 8, NT = BM / 8, DT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BM * P;
  bf16* Qs = Vs + BM * P;
  bf16* Ds = Qs + BM * P;  // dO tile
  float* Ls = reinterpret_cast<float*>(Ds + BM * P);
  float* Is = Ls + BM;     // di tile

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j0 = blockIdx.y * BM;
  const size_t rs = (size_t)H * DH;
  const size_t base = (size_t)b * T * rs + (size_t)h * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ka = j0 + warp * 16 + g, kb = ka + 8;

  load_tile<DH>(Ks, k + base, j0, T, rs);
  load_tile<DH>(Vs, v + base, j0, T, rs);
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[dt][c] = dv_acc[dt][c] = 0.f;

  for (int i0 = j0; i0 < T; i0 += BM) {
    __syncthreads();
    load_tile<DH>(Qs, q + base, i0, T, rs);
    load_tile<DH>(Ds, dout + base, i0, T, rs);
    for (int r = tid; r < BM; r += THREADS) {
      const int i = i0 + r;
      Ls[r] = i < T ? lse[(size_t)bh * T + i] : INFINITY;
      Is[r] = i < T ? di[(size_t)bh * T + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 k/v rows x BM q rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
    rows_dot_rows<DH>(s, Ks, Qs, warp * 16, g, t);
    rows_dot_rows<DH>(dp, Vs, Ds, warp * 16, g, t);

#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int il = nt * 8 + 2 * t + (c & 1);
        const int i = i0 + il;
        const int kv = c < 2 ? ka : kb;
        const bool live = kv <= i && i < T && kv < T;
        const float p = live ? expf(s[nt][c] * scale - Ls[il]) : 0.f;
        s[nt][c] = p;                                   // P^T
        dp[nt][c] = p * (dp[nt][c] - Is[il]) * scale;   // dS^T, scaled
      }
    regs_dot_tile<DH>(dv_acc, s, Ds, g, t);   // dV += P^T dO
    regs_dot_tile<DH>(dk_acc, dp, Qs, g, t);  // dK += dS^T Q
  }

  store_rows<DH>(dk + base, dk_acc, ka, T, rs, t, 1.f, 1.f);
  store_rows<DH>(dv + base, dv_acc, ka, T, rs, t, 1.f, 1.f);
}

// grid (B*H, ceil(T/BM)); the q tile walks the k/v tiles up to the diagonal
template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, bf16* __restrict__ dq,
                    int T, int H, float scale) {
  constexpr int P = DH + 8, NT = BM / 8, DT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + BM * P;  // dO tile
  bf16* Ks = Ds + BM * P;
  bf16* Vs = Ks + BM * P;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const size_t rs = (size_t)H * DH;
  const size_t base = (size_t)b * T * rs + (size_t)h * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const float lse_a = ra < T ? lse[(size_t)bh * T + ra] : 0.f;
  const float lse_b = rb < T ? lse[(size_t)bh * T + rb] : 0.f;
  const float di_a = ra < T ? di[(size_t)bh * T + ra] : 0.f;
  const float di_b = rb < T ? di[(size_t)bh * T + rb] : 0.f;

  load_tile<DH>(Qs, q + base, q0, T, rs);
  load_tile<DH>(Ds, dout + base, q0, T, rs);
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;

  const int kv_end = min(T, q0 + BM);
  for (int j0 = 0; j0 < kv_end; j0 += BM) {
    __syncthreads();
    load_tile<DH>(Ks, k + base, j0, T, rs);
    load_tile<DH>(Vs, v + base, j0, T, rs);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
    rows_dot_rows<DH>(s, Qs, Ks, warp * 16, g, t);   // S = Q K^T
    rows_dot_rows<DH>(dp, Ds, Vs, warp * 16, g, t);  // dP = dO V^T

#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j0 + nt * 8 + 2 * t + (c & 1);
        const int row = c < 2 ? ra : rb;
        const bool live = col <= row && col < T && row < T;
        const float p =
            live ? expf(s[nt][c] * scale - (c < 2 ? lse_a : lse_b)) : 0.f;
        s[nt][c] = p * (dp[nt][c] - (c < 2 ? di_a : di_b)) * scale;  // dS
      }
    regs_dot_tile<DH>(acc, s, Ks, g, t);  // dQ += dS K
  }

  store_rows<DH>(dq + base, acc, ra, T, rs, t, 1.f, 1.f);
}

template <typename Kernel>
int launch_prep(Kernel kernel, int smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return 0;
}

template <int DH>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int T, int H, float scale, cudaStream_t stream) {
  const int smem = 3 * BM * (DH + 8) * (int)sizeof(bf16);
  if (int err = launch_prep(flash_fwd_kernel<DH>, smem)) return err;
  const dim3 grid(B * H, (T + BM - 1) / BM);
  flash_fwd_kernel<DH><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      T, H, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* di, void* dk, void* dv, int B, int T,
            int H, float scale, cudaStream_t stream) {
  const int smem =
      4 * BM * (DH + 8) * (int)sizeof(bf16) + 2 * BM * (int)sizeof(float);
  if (int err = launch_prep(flash_bwd_dkv_kernel<DH>, smem)) return err;
  const dim3 grid(B * H, (T + BM - 1) / BM);
  flash_bwd_dkv_kernel<DH><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)di, (bf16*)dk, (bf16*)dv, T, H, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* di, void* dq, int B, int T, int H,
           float scale, cudaStream_t stream) {
  const int smem = 4 * BM * (DH + 8) * (int)sizeof(bf16);
  if (int err = launch_prep(flash_bwd_dq_kernel<DH>, smem)) return err;
  const dim3 grid(B * H, (T + BM - 1) / BM);
  flash_bwd_dq_kernel<DH><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)di, (bf16*)dq, T, H, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int T, int H) {
  return B < 1 || T < 1 || H < 1 || (long long)B * H > 0x7fffffffLL ||
         (T + BM - 1) / BM > 65535;
}

}  // namespace

extern "C" int vqt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int T, int H, int Dh,
                             float scale, void* stream) {
  if (bad_shape(B, T, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 32: return fwd<32>(q, k, v, o, lse, B, T, H, scale, s);
    case 64: return fwd<64>(q, k, v, o, lse, B, T, H, scale, s);
    case 128: return fwd<128>(q, k, v, o, lse, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int vqt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* di, void* dk, void* dv, int B,
                                 int T, int H, int Dh, float scale,
                                 void* stream) {
  if (bad_shape(B, T, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 32: return bwd_dkv<32>(q, k, v, dout, lse, di, dk, dv, B, T, H, scale, s);
    case 64: return bwd_dkv<64>(q, k, v, dout, lse, di, dk, dv, B, T, H, scale, s);
    case 128: return bwd_dkv<128>(q, k, v, dout, lse, di, dk, dv, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int vqt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, void* dq, int B, int T, int H,
                                int Dh, float scale, void* stream) {
  if (bad_shape(B, T, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 32: return bwd_dq<32>(q, k, v, dout, lse, di, dq, B, T, H, scale, s);
    case 64: return bwd_dq<64>(q, k, v, dout, lse, di, dq, B, T, H, scale, s);
    case 128: return bwd_dq<128>(q, k, v, dout, lse, di, dq, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
