// Causal flash attention for Hopper, forward and backward, in three kernels:
//   K4-fwd:  o = softmax(q k^T * scale, causal) v  and  lse = m + log(l)
//   K4-dkv:  dk, dv  from q, k, v, dO, lse and di = sum(o * dO)
//   K4-dq:   dq      from the same
// q, k, v, o, dO, dq, dk, dv are bf16 in the model's (B, T, H, Dh) layout,
// contiguous (row t of head h at (b*T + t)*H*Dh + h*Dh); lse and di are f32
// (B, H, T), lse in the natural log. Sums are f32; P and dS are rounded to
// bf16 before the products that take them, as the TPU kernels do.
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
// operations' floor is within a factor of ~4 of it.
//
// What the forward does about it:
// - one block per (batch, head) reads that head's k and v from device
//   memory once, by TMA (cp.async.bulk.tensor over the (Dh, H, T, B) view of
//   each tensor, 64-row boxes of at most 64 columns, 128-byte swizzle;
//   64-byte at Dh 32), into shared-memory stages that each sit behind an
//   mbarrier. The block's first thread issues the q tiles of both
//   warpgroups and every k/v tile of the head at the start; the warpgroups
//   multiply the tiles that have landed while later ones are in flight, and
//   the warp that frees a q buffer last loads the next q tile into it. When
//   the head's k/v tiles do not fit in shared memory (T > 832 at Dh 64) they
//   stream through a ring of 4 stages, reloaded per walk, each by the warp
//   that frees the stage last. There is no producer warp: with a ninth warp
//   ptxas caps two blocks per SM at 96 registers, where the forward spills;
//   with eight it has 128;
// - tiles are end-aligned: tile j of n covers rows [T - 64 (n - j),
//   T - 64 (n - j) + 64), so only tile 0 is partial; TMA fills its rows
//   before 0 with zeros, and the products over it take only its live
//   8-column and 16-row steps; a warp whose 16 q rows all lie before row 0
//   issues none. Q tiles go to the warpgroups longest walk first;
// - fragments come from ldmatrix (.trans for V), addressed through the
//   swizzle; a warp keeps its q rows' A fragments in registers for its
//   whole walk, so its q buffer refills while it walks. The products run on
//   the tensor cores (mma.sync m16n8k16 bf16 -> f32), a full tile's S one
//   contraction slice at a time into 8 independent accumulators; S and P
//   stay in registers, P repacked as the A operand of P V; the online
//   softmax runs in base 2 (ex2 of scores scaled by scale * log2(e)).
// What dkv does: one block per (batch, head), three warpgroups at Dh <= 64
// (two at Dh 128); each head's q and dO tiles are read from device memory
// once, by TMA, with their lse and di rows (plain loads), into stages behind
// mbarriers: all at the start while they fit (T <= 640 at Dh 64), else
// through a ring of 4 stages. Warpgroups take the k/v tiles longest walk
// first, snaking as the forward's q tiles do; a warp keeps its 16 k/v rows'
// K and V A fragments in registers, so its k/v buffer refills with the next
// round's tile while it walks. Tiles are end-aligned, a warp with no live
// k/v row issues nothing, and on the diagonal a warp takes only the 16-row
// q slices from its first live row. Fragments come from ldmatrix (.trans
// for the B operands of dV += P^T dO and dK += dS^T Q); P is 2^x of scores
// scaled by scale * log2(e) against lse * log2(e); dk and dv leave in
// 16-byte stores (a shuffle transpose within each quad). No atomics: dkv
// owns its k/v rows. What bounds it at the training shape on an H100: the
// warps' product chains and the stores (without its loads it runs about as
// long; its loads alone take under half its time).
// What dq does: one block per (64-row tile, batch * head), 4 warps of 16
// rows; the block stages its q tile and then each k/v tile up to the
// diagonal in shared memory (16-byte loads, ragged rows zero-filled), the
// longest walks first; no atomics: dq owns its q rows, as in the TPU kernel.
// Left for later: wgmma; TMA and ldmatrix in dq.
// Dh = 32, 64 and 128 are compiled; any T >= 1.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
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

// ---- K4-fwd ---------------------------------------------------------------
// Tiles are end-aligned: tile j of n = ceil(T / BM) covers rows
// [T - BM (n - j), T - BM (n - j) + BM), so only tile 0 is partial, and its
// first `dead` = n BM - T rows lie before row 0 (read as 0, never stored).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Byte offset of row rb + rr (rb a multiple of 8, rr < 8), column c (a
// multiple of 8) in a BM x DH tile as TMA writes it: boxes of BM rows by
// BOXC = min(DH, 64) columns, one after the other, whose 16-byte chunks are
// XOR-swizzled by row (128-byte swizzle: chunk ^ row % 8; 64-byte swizzle at
// DH 32: chunk ^ (row / 2) % 4). The 8 rows of an ldmatrix then fall in
// distinct banks. Tiles start on 1024-byte boundaries.
template <int DH>
struct SwizzledRows {
  static constexpr int BOXC = DH < 64 ? DH : 64, ROWB = 2 * BOXC;
  static __device__ __forceinline__ uint32_t off(int rb, int rr, int c) {
    const int chunk = (c % BOXC) / 8, phase = ROWB == 128 ? rr : rr >> 1;
    return (uint32_t)((c / BOXC) * BM * ROWB + (rb + rr) * ROWB +
                      ((chunk ^ phase) << 4));
  }
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the arrival of the thread that issues a stage's loads, with their bytes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// The warp is done reading a buffer that `every` warps share: lane 0 counts
// it, and returns true in the warp that counts last, which then issues the
// buffer's next load (the fences order the warps' reads of the buffer
// before that load's writes).
__device__ __forceinline__ bool warp_release(unsigned* count, unsigned every,
                                             int lane) {
  __syncwarp();
  if (lane != 0) return false;
  __threadfence_block();
  if (atomicAdd(count, 1u) % every != every - 1) return false;
  __threadfence_block();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  return true;
}

// A wait that has not ended after ~2^34 cycles (seconds; the loads take
// microseconds) traps: a broken protocol fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// rows [row0, row0 + BM) of head h of batch b -> a swizzled BM x DH tile at
// dst, completing on `bar`; rows outside [0, T) arrive as zeros
template <int DH>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int h,
                                         int b) {
  constexpr int BOXC = SwizzledRows<DH>::BOXC;
#pragma unroll
  for (int c = 0; c < DH; c += BOXC)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
        "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
            dst + (uint32_t)((c / BOXC) * BM * BOXC * 2)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h), "r"(row0),
        "r"(b), "r"(bar)
        : "memory");
}

// One warp's running softmax over its 16 q rows: g and g + 8 of the warp
// (a, b), m in base-2 units (scores times scale * log2(e))
template <int DH>
struct FwdState {
  float acc[DH / 8][4];
  float m_a, m_b, l_a, l_b;
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
    m_a = m_b = -INFINITY;
    l_a = l_b = 0.f;
  }
};

// 2^x (ex2.approx, subnormals flushed: a probability under 2^-126 is 0
// after it is rounded to bf16 for P V anyway)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A operands of a warp's 16 q rows [r0, r0 + 16), all DH / 16 of them,
// kept in registers for the whole walk
template <int DH, class L>
__device__ __forceinline__ void fwd_load_q(uint32_t (*qa)[4], uint32_t qs,
                                           int r0, int lane) {
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc)
    ldsm_x4(qa[kc], qs + L::off(r0 + (mi & 1) * 8, rr, kc * 16 + (mi >> 1) * 8));
}

// S (16 x BM) = Q . K^T over the live 8-column steps [nt0, nt1); the other
// steps stay 0. A full tile runs contraction slice by slice: 4 B fragment
// loads, then 8 independent products. A partial one runs 16-column step by
// step: all the step's B fragments, then its products.
template <int DH, class L>
__device__ __forceinline__ void fwd_scores(float (*s)[4],
                                           const uint32_t (*qa)[4],
                                           uint32_t ks, int nt0, int nt1,
                                           int lane) {
  constexpr int KC = DH / 16;
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
  if (nt0 == 0 && nt1 == BM / 8) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t b[BM / 16][4];
#pragma unroll
      for (int np = 0; np < BM / 16; ++np)
        ldsm_x4(b[np], ks + L::off(np * 16 + (mi >> 1) * 8, rr, kc * 16 + (mi & 1) * 8));
#pragma unroll
      for (int np = 0; np < BM / 16; ++np) {
        mma_bf16(s[2 * np], qa[kc], b[np][0], b[np][1]);
        mma_bf16(s[2 * np + 1], qa[kc], b[np][2], b[np][3]);
      }
    }
    return;
  }
#pragma unroll
  for (int np = 0; np < BM / 16; ++np) {
    const bool lo = 2 * np >= nt0 && 2 * np < nt1;
    const bool hi = 2 * np + 1 >= nt0 && 2 * np + 1 < nt1;
    if (!lo && !hi) continue;
    uint32_t b[KC][4];  // k rows [16 np, 16 np + 8): b[.][0..1]; the next 8: b[.][2..3]
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      ldsm_x4(b[kc], ks + L::off(np * 16 + (mi >> 1) * 8, rr, kc * 16 + (mi & 1) * 8));
    if (lo && hi) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        mma_bf16(s[2 * np], qa[kc], b[kc][0], b[kc][1]);
        mma_bf16(s[2 * np + 1], qa[kc], b[kc][2], b[kc][3]);
      }
    } else {  // a 16-column step half outside the live columns
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (lo) mma_bf16(s[2 * np], qa[kc], b[kc][0], b[kc][1]);
        if (hi) mma_bf16(s[2 * np + 1], qa[kc], b[kc][2], b[kc][3]);
      }
    }
  }
}

// O += P V over the 16-row step kk of the v tile (a constant once unrolled:
// it indexes P's registers): the step's B fragments, then its products
template <int DH, class L>
__device__ __forceinline__ void fwd_pv_step(FwdState<DH>& st,
                                            const float (*p)[4], uint32_t vs,
                                            int kk, int lane) {
  constexpr int DT = DH / 8;
  const int mi = lane >> 3, rr = lane & 7;
  uint32_t a[4], b[DT / 2][4];  // v columns [16 dp, 16 dp + 8): b[dp][0..1]; the next 8: b[dp][2..3]
  frag_a_regs(a, p, kk);
#pragma unroll
  for (int dp = 0; dp < DT / 2; ++dp)
    ldsm_x4_t(b[dp], vs + L::off(kk * 16 + (mi & 1) * 8, rr, dp * 16 + (mi >> 1) * 8));
#pragma unroll
  for (int dp = 0; dp < DT / 2; ++dp) {
    mma_bf16(st.acc[2 * dp], a, b[dp][0], b[dp][1]);
    mma_bf16(st.acc[2 * dp + 1], a, b[dp][2], b[dp][3]);
  }
}

// The online softmax of S (base 2) and O += P V over the live 16-row steps
// [kk0, kk1) of the v tile. Columns before `dead` and, on the diagonal tile,
// after the row are masked; `mask` is false when neither applies.
template <int DH, class L>
__device__ __forceinline__ void fwd_softmax_pv(FwdState<DH>& st,
                                               float (*s)[4], uint32_t vs,
                                               int r0, int dead, bool diag,
                                               int kk0, int kk1,
                                               float scale2, int lane) {
  constexpr int NT = BM / 8, DT = DH / 8;
  const int g = lane >> 2, t = lane & 3;
  const bool mask = dead > 0 || diag;
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (mask) {
        const int col = nt * 8 + 2 * t + (c & 1);
        const int row = r0 + g + (c < 2 ? 0 : 8);
        if (col < dead || (diag && col > row)) s[nt][c] = -INFINITY;
      }
      if (c < 2) mx_a = fmaxf(mx_a, s[nt][c]);
      else mx_b = fmaxf(mx_b, s[nt][c]);
    }
  // the scale is positive: the max of the scaled scores is the scaled max
  const float mn_a = fmaxf(st.m_a, quad_max(mx_a) * scale2);
  const float mn_b = fmaxf(st.m_b, quad_max(mx_b) * scale2);
  // a row with every score so far masked keeps m = -inf: exp base 0
  const float e_a = mn_a == -INFINITY ? 0.f : mn_a;
  const float e_b = mn_b == -INFINITY ? 0.f : mn_b;
  const float al_a = exp2_approx(st.m_a - e_a), al_b = exp2_approx(st.m_b - e_b);
  st.m_a = mn_a;
  st.m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = exp2_approx(fmaf(s[nt][c], scale2, c < 2 ? -e_a : -e_b));
      s[nt][c] = p;
      if (c < 2) sum_a += p;
      else sum_b += p;
    }
  st.l_a = st.l_a * al_a + sum_a;  // this thread's columns; summed over the quad at the end
  st.l_b = st.l_b * al_b + sum_b;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    st.acc[dt][0] *= al_a;
    st.acc[dt][1] *= al_a;
    st.acc[dt][2] *= al_b;
    st.acc[dt][3] *= al_b;
  }
  if (kk0 == 0 && kk1 == NT / 2) {  // a full tile: no branch between the steps
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) fwd_pv_step<DH, L>(st, s, vs, kk, lane);
    return;
  }
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk)
    if (kk >= kk0 && kk < kk1) fwd_pv_step<DH, L>(st, s, vs, kk, lane);
}

// The live 8-column steps [nt0, nt1) and 16-row steps [kk0, kk1) of a k/v
// tile for the warp whose q rows start at r0 (tile-local)
struct FwdSteps {
  int nt0, nt1, kk0, kk1;
  __device__ __forceinline__ FwdSteps(int r0, int dead, bool diag)
      : nt0(dead >> 3), nt1(diag ? (r0 >> 3) + 2 : BM / 8),
        kk0(dead >> 4), kk1(diag ? (r0 >> 4) + 1 : BM / 16) {}
};

// o rows row_a = q0 + r0 + g and row_a + 8 (those in [0, T)) as bf16, and
// lse = m ln 2 + ln l
template <int DH>
__device__ __forceinline__ void fwd_store(bf16* o, float* lse_row,
                                          FwdState<DH>& st, int row_a, int T,
                                          size_t rs, int lane) {
  const int t = lane & 3;
  const float l_a = quad_sum(st.l_a), l_b = quad_sum(st.l_b);
  const float mul_a = 1.f / l_a, mul_b = 1.f / l_b;
  const int row_b = row_a + 8;
  const bool in_a = row_a >= 0 && row_a < T, in_b = row_b >= 0 && row_b < T;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (in_a)
      *reinterpret_cast<uint32_t*>(o + (size_t)row_a * rs + col) =
          pack2(st.acc[dt][0] * mul_a, st.acc[dt][1] * mul_a);
    if (in_b)
      *reinterpret_cast<uint32_t*>(o + (size_t)row_b * rs + col) =
          pack2(st.acc[dt][2] * mul_b, st.acc[dt][3] * mul_b);
  }
  constexpr float LN2 = 0.6931471805599453f;
  if (t == 0) {
    if (in_a) lse_row[row_a] = st.m_a * LN2 + logf(l_a);
    if (in_b) lse_row[row_b] = st.m_b * LN2 + logf(l_b);
  }
}

constexpr int FWD_WG = 2;  // warpgroups, 4 warps of 16 q rows each
constexpr int FWD_THREADS = 128 * FWD_WG;
constexpr int FWD_STREAM_STAGES = 4;  // k/v ring when a head does not fit
constexpr int FWD_BAR_BYTES = 1024;   // mbarriers and counters, then the tiles

// Q tile of warpgroup g in round r: the longest walks first, snaking over
// the warpgroups so that their walks even out; negative when none is left
__device__ __forceinline__ int fwd_q_tile(int n, int r, int g) {
  return n - 1 - (FWD_WG * r + ((r & 1) ? FWD_WG - 1 - g : g));
}

// k/v tile of the c-th streamed load: round r walks tiles 0 .. n - 1 - FWD_WG r
__device__ __forceinline__ int fwd_seq_tile(int n, int c) {
  for (int len = n; c >= len; len -= FWD_WG) c -= len;
  return c;
}

// One block per (batch, head); `stages` k/v stages (each a k and a v tile)
// follow FWD_WG q tiles in shared memory. When stages >= n the head stays
// resident: tile j is loaded once, into stage j, all at the start.
// Otherwise round r's walk (shared by the round's q tiles) streams through
// the ring, and every warp releases each stage. The first thread issues the
// first loads; after that, the warp that frees a q buffer or a stage last
// issues its next load.
template <int DH>
__global__ void __launch_bounds__(FWD_THREADS, DH <= 64 ? 2 : 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int H, int stages,
                 float scale2) {
  using L = SwizzledRows<DH>;
  constexpr uint32_t TILE = BM * DH * 2;
  extern __shared__ unsigned char smem_fwd[];
  // the swizzle repeats every 1024 bytes: tiles start on such a boundary
  const uint32_t pad =
      ((smem_u32(smem_fwd) + 1023u) & ~1023u) - smem_u32(smem_fwd);
  const uint32_t full = smem_u32(smem_fwd) + pad, qfull = full + 8 * stages;
  unsigned* kv_count =
      reinterpret_cast<unsigned*>(smem_fwd + pad + 8 * (stages + FWD_WG));
  unsigned* q_count = kv_count + stages;
  const uint32_t qbuf = full + FWD_BAR_BYTES, kvbuf = qbuf + FWD_WG * TILE;

  const int n = (T + BM - 1) / BM, dead = n * BM - T;
  const int rounds = (n + FWD_WG - 1) / FWD_WG;
  const bool resident = stages >= n;
  int total = n;  // k/v loads of the block
  if (!resident)
    for (int r = 1; r < rounds; ++r) total += n - FWD_WG * r;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const CUtensorMap *mq = &tq, *mk = &tk, *mv = &tv;
  auto load_q = [&](int r, int g) {
    mbar_expect_tx(qfull + 8 * g, TILE);
    tma_tile<DH>(qbuf + g * TILE, mq, qfull + 8 * g,
                 T - (n - fwd_q_tile(n, r, g)) * BM, h, b);
  };
  auto load_kv = [&](int c) {  // the c-th k/v load, into stage c % stages
    const int s = c % stages, j = resident ? c : fwd_seq_tile(n, c);
    mbar_expect_tx(full + 8 * s, 2 * TILE);
    tma_tile<DH>(kvbuf + 2 * s * TILE, mk, full + 8 * s, T - (n - j) * BM, h,
                 b);
    tma_tile<DH>(kvbuf + (2 * s + 1) * TILE, mv, full + 8 * s,
                 T - (n - j) * BM, h, b);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      kv_count[s] = 0;
    }
    for (int g = 0; g < FWD_WG; ++g) {
      mbar_init(qfull + 8 * g, 1);
      q_count[g] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int g = 0; g < FWD_WG; ++g)
      if (fwd_q_tile(n, 0, g) >= 0) load_q(0, g);
    for (int c = 0; c < min(total, stages); ++c) load_kv(c);
  }
  __syncthreads();

  // warpgroup g; the warp's q rows [r0, r0 + 16) of the tile
  const int g = warp >> 2, r0 = (warp & 3) * 16;
  const uint32_t qs = qbuf + g * TILE;
  const size_t rs = (size_t)H * DH;
  bf16* ob = o + (size_t)b * T * rs + (size_t)h * DH;
  float* lb = lse + (size_t)bh * T;
  int c = 0;  // k/v loads consumed so far
  for (int r = 0; r < rounds; ++r) {
    const int i = fwd_q_tile(n, r, g);
    const int walk = resident ? i + 1 : n - FWD_WG * r;
    // a warp whose 16 rows all lie before row 0 issues no products
    const bool live = i > 0 || (i == 0 && r0 + 15 >= dead);
    uint32_t qa[DH / 16][4];
    if (i >= 0) {
      mbar_wait(qfull + 8 * g, r & 1);
      if (live) fwd_load_q<DH, L>(qa, qs, r0, lane);
      // the q buffer is no longer read: its last reader loads the next tile
      if (warp_release(q_count + g, 4, lane) && r + 1 < rounds &&
          fwd_q_tile(n, r + 1, g) >= 0)
        load_q(r + 1, g);
    }
    FwdState<DH> st;
    st.init();
    for (int j = 0; j < walk; ++j, ++c) {
      const int s = resident ? j : c % stages;
      mbar_wait(full + 8 * s, resident ? 0 : (c / stages) & 1);
      if (live && j <= i) {
        const int dj = j == 0 ? dead : 0;
        const FwdSteps sp(r0, dj, j == i);
        float sc[BM / 8][4];
        fwd_scores<DH, L>(sc, qa, kvbuf + 2 * s * TILE, sp.nt0, sp.nt1, lane);
        fwd_softmax_pv<DH, L>(st, sc, kvbuf + (2 * s + 1) * TILE, r0, dj,
                              j == i, sp.kk0, sp.kk1, scale2, lane);
      }
      if (!resident && warp_release(kv_count + s, 4 * FWD_WG, lane) &&
          c + stages < total)
        load_kv(c + stages);
    }
    if (live)
      fwd_store<DH>(ob, lb, st, T - (n - i) * BM + r0 + (lane >> 2), T, rs,
                    lane);
  }
}

// ---- K4-dkv ---------------------------------------------------------------
// Tiles are end-aligned as in the forward. A warp owns 16 k/v rows of one
// k/v tile, keeps their K and V A fragments in registers, and walks the q
// tiles from the diagonal on, 16 q rows (a slice) at a time: S^T = K Q^T and
// dP^T = V dO^T for the slice's columns, P^T = 2^(S^T scale log2 e - lse
// log2 e), dS^T = P^T (dP^T - di) scale, then dV += P^T dO and dK += dS^T Q
// with ldmatrix .trans B fragments (dO and q are read along their rows).

constexpr float LOG2E = 1.4426950408889634f;

// dK and dV of the warp's 16 k/v rows (A fragments ka, va) over q slice kk
// of the q tile qs and dO tile ds (layout L); lse (natural log) and di are
// the tile's 64 rows in shared memory. On the diagonal tile q rows before
// the k/v row are masked.
template <int DH, class L>
__device__ __forceinline__ void dkv_slice(float (*dk)[4], float (*dv)[4],
                                          const uint32_t (*ka)[4],
                                          const uint32_t (*va)[4], uint32_t qs,
                                          uint32_t ds, const float* lse,
                                          const float* dis, int kk, bool diag,
                                          int r0, float scale2, float scale,
                                          int lane) {
  constexpr int KC = DH / 16, DT = DH / 8;
  const int mi = lane >> 3, rr = lane & 7, g = lane >> 2, t = lane & 3;
  float s[2][4], dp[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[h][c] = dp[h][c] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    // q / dO rows [16 kk, 16 kk + 8): b[0..1]; the next 8: b[2..3]
    uint32_t bq[4], bd[4];
    const uint32_t o = L::off(kk * 16 + (mi >> 1) * 8, rr, kc * 16 + (mi & 1) * 8);
    ldsm_x4(bq, qs + o);
    ldsm_x4(bd, ds + o);
    mma_bf16(s[0], ka[kc], bq[0], bq[1]);
    mma_bf16(s[1], ka[kc], bq[2], bq[3]);
    mma_bf16(dp[0], va[kc], bd[0], bd[1]);
    mma_bf16(dp[1], va[kc], bd[2], bd[3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = kk * 16 + h * 8 + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(lse + col);
    const float2 d = *reinterpret_cast<const float2*>(dis + col);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float nl = (c & 1 ? l.y : l.x) * -LOG2E;
      float p = exp2_approx(fmaf(s[h][c], scale2, nl));
      if (diag && col + (c & 1) < r0 + g + (c < 2 ? 0 : 8)) p = 0.f;
      s[h][c] = p;                                            // P^T
      dp[h][c] = p * (dp[h][c] - (c & 1 ? d.y : d.x)) * scale;  // dS^T
    }
  }
  uint32_t ap[4], as[4];
  frag_a_regs(ap, s, 0);
  frag_a_regs(as, dp, 0);
#pragma unroll
  for (int dq = 0; dq < DT / 2; ++dq) {
    // columns [16 dq, 16 dq + 8) of the slice's rows: b[0..1]; the next 8: b[2..3]
    uint32_t bo[4], bq[4];
    const uint32_t o = L::off(kk * 16 + (mi & 1) * 8, rr, dq * 16 + (mi >> 1) * 8);
    ldsm_x4_t(bo, ds + o);
    ldsm_x4_t(bq, qs + o);
    mma_bf16(dv[2 * dq], ap, bo[0], bo[1]);
    mma_bf16(dv[2 * dq + 1], ap, bo[2], bo[3]);
    mma_bf16(dk[2 * dq], as, bq[0], bq[1]);
    mma_bf16(dk[2 * dq + 1], as, bq[2], bq[3]);
  }
}

// One q tile: every slice of a full tile, straight-line; on the diagonal
// only the slices from the warp's first live q row `lo` on
template <int DH, class L>
__device__ __forceinline__ void dkv_tile(float (*dk)[4], float (*dv)[4],
                                         const uint32_t (*ka)[4],
                                         const uint32_t (*va)[4], uint32_t qs,
                                         uint32_t ds, const float* lse,
                                         const float* dis, bool diag, int r0,
                                         int lo, float scale2, float scale,
                                         int lane) {
  if (!diag) {
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      dkv_slice<DH, L>(dk, dv, ka, va, qs, ds, lse, dis, kk, false, r0, scale2,
                       scale, lane);
    return;
  }
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk)
    if (kk >= (lo >> 4))
      dkv_slice<DH, L>(dk, dv, ka, va, qs, ds, lse, dis, kk, true, r0, scale2,
                       scale, lane);
}

// Within each quad (lanes 4k .. 4k + 3), lane t's x[u] becomes lane u's
// x[t]: two butterfly exchanges (lanes t ^ 1, then t ^ 2)
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4], int t) {
#pragma unroll
  for (int bit = 1; bit <= 2; bit <<= 1) {
    const bool hi = t & bit;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u & bit) continue;  // the pair (u, u | bit)
      const uint32_t recv =
          __shfl_xor_sync(0xffffffffu, hi ? x[u] : x[u | bit], bit);
      if (hi) x[u] = recv;
      else x[u | bit] = recv;
    }
  }
}

// dk, dv rows row_a = k0 + r0 + g and row_a + 8 (those >= 0) as bf16, 16
// bytes a store: a quad's 4 x 4 transpose of its packed words gives lane t
// the 8 columns of step 4m + t of its row
template <int DH>
__device__ __forceinline__ void dkv_store(bf16* dk, bf16* dv,
                                          const float (*dka)[4],
                                          const float (*dva)[4], int row_a,
                                          size_t rs, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + 8 * half;
#pragma unroll
    for (int m = 0; m < DH / 32; ++m) {
      uint32_t xk[4], xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xk[u] = pack2(dka[4 * m + u][2 * half], dka[4 * m + u][2 * half + 1]);
        xv[u] = pack2(dva[4 * m + u][2 * half], dva[4 * m + u][2 * half + 1]);
      }
      quad_transpose(xk, t);
      quad_transpose(xv, t);
      if (row >= 0) {
        const size_t off = (size_t)row * rs + (4 * m + t) * 8;
        *reinterpret_cast<uint4*>(dk + off) = make_uint4(xk[0], xk[1], xk[2], xk[3]);
        *reinterpret_cast<uint4*>(dv + off) = make_uint4(xv[0], xv[1], xv[2], xv[3]);
      }
    }
  }
}

// Warpgroups (4 warps of 16 k/v rows each) of the dK/dV kernel: three at
// Dh <= 64 (12 warps per SM; at T = 257 the five k/v tiles' walks split
// 5 / 5 / 5), two at Dh 128, whose 16 rows' dK and dV sums alone take 128
// registers of a thread
template <int DH>
struct Dkv {
  static constexpr int WG = DH <= 64 ? 3 : 2, THREADS = 128 * WG;
};
constexpr int DKV_STREAM_STAGES = 4;  // q/dO ring when a head does not fit
constexpr int DKV_BAR_BYTES = 1024;   // mbarriers and counters, then the tiles
constexpr int ROW_BYTES = BM * 4;     // one tile's lse (or di) rows, f32

// K/V tile of warpgroup g (of WG) in round r: the longest walks (the first
// tiles) first, snaking over the warpgroups so that their walks even out;
// negative when none is left
template <int WG>
__device__ __forceinline__ int dkv_kv_tile(int n, int r, int g) {
  const int j = WG * r + ((r & 1) ? WG - 1 - g : g);
  return j < n ? j : -1;
}

// q tile of the c-th streamed q/dO load: round r walks tiles WG r .. n - 1
template <int WG>
__device__ __forceinline__ int dkv_seq_tile(int n, int c) {
  int first = 0;
  for (int len = n; c >= len; len -= WG) {
    c -= len;
    first += WG;
  }
  return first + c;
}

// One block per (batch, head), WG warpgroups; warpgroup g holds k/v tile
// dkv_kv_tile(n, r, g) in round r. `stages` q/dO stages (each a q
// tile and a dO tile by TMA, their lse and di rows by plain loads) follow
// the warpgroups' k/v buffers in shared memory. When stages >= n the head
// stays resident: q tile i is loaded once, into stage i, all at the start,
// and each warpgroup walks its tiles j .. n - 1. Otherwise round r's walk
// (tiles WG r .. n - 1, shared by the round's k/v tiles) streams
// through the ring, and every warp releases each stage. The first thread
// issues the first tile loads and the block the first rows; after that,
// the warp that frees a k/v buffer or a stage last issues its next load
// (the rows before the barrier's arrival).
template <int DH>
__global__ void __launch_bounds__(Dkv<DH>::THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int T, int H, int stages,
                     float scale2, float scale) {
  using L = SwizzledRows<DH>;
  constexpr int KC = DH / 16, DT = DH / 8, WG = Dkv<DH>::WG;
  constexpr uint32_t TILE = BM * DH * 2;
  extern __shared__ unsigned char smem_dkv[];
  // the swizzle repeats every 1024 bytes: tiles start on such a boundary
  unsigned char* base =
      smem_dkv + (((smem_u32(smem_dkv) + 1023u) & ~1023u) - smem_u32(smem_dkv));
  const uint32_t kvfull = smem_u32(base), qfull = kvfull + 8 * WG;
  unsigned* kv_count = reinterpret_cast<unsigned*>(base + 8 * (WG + stages));
  unsigned* q_count = kv_count + WG;
  const uint32_t kvbuf = kvfull + DKV_BAR_BYTES, qbuf = kvbuf + 2 * WG * TILE;
  const uint32_t rowbuf = qbuf + 2 * stages * TILE;  // lse, di of each stage
  float* rows = reinterpret_cast<float*>(base + (rowbuf - kvfull));

  const int n = (T + BM - 1) / BM, dead = n * BM - T;
  const int rounds = (n + WG - 1) / WG;
  const bool resident = stages >= n;
  int total = n;  // q/dO loads of the block
  if (!resident)
    for (int r = 1; r < rounds; ++r) total += n - WG * r;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const CUtensorMap *mq = &tq, *mk = &tk, *mv = &tv, *mdo = &tdo;
  auto load_kv = [&](int r, int g) {
    const int row0 = T - (n - dkv_kv_tile<WG>(n, r, g)) * BM;
    mbar_expect_tx(kvfull + 8 * g, 2 * TILE);
    tma_tile<DH>(kvbuf + 2 * g * TILE, mk, kvfull + 8 * g, row0, h, b);
    tma_tile<DH>(kvbuf + (2 * g + 1) * TILE, mv, kvfull + 8 * g, row0, h, b);
  };
  auto load_q = [&](int c) {  // the c-th q/dO load, into stage c % stages
    const int s = c % stages, i = resident ? c : dkv_seq_tile<WG>(n, c);
    const int row0 = T - (n - i) * BM;
    const uint32_t bar = qfull + 8 * s;
    mbar_expect_tx(bar, 2 * TILE);
    tma_tile<DH>(qbuf + 2 * s * TILE, mq, bar, row0, h, b);
    tma_tile<DH>(qbuf + (2 * s + 1) * TILE, mdo, bar, row0, h, b);
  };
  auto load_row = [&](int c, int rr) {  // row rr of the c-th load's lse, di
    const int s = c % stages, i = resident ? c : dkv_seq_tile<WG>(n, c);
    const int row = T - (n - i) * BM + rr;
    rows[2 * s * BM + rr] = row >= 0 ? lse[(size_t)bh * T + row] : 0.f;
    rows[(2 * s + 1) * BM + rr] = row >= 0 ? di[(size_t)bh * T + row] : 0.f;
  };
  if (threadIdx.x == 0) {
    for (int g = 0; g < WG; ++g) {
      mbar_init(kvfull + 8 * g, 1);
      kv_count[g] = 0;
    }
    for (int s = 0; s < stages; ++s) {
      mbar_init(qfull + 8 * s, 1);
      q_count[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int g = 0; g < WG; ++g)
      if (dkv_kv_tile<WG>(n, 0, g) >= 0) load_kv(0, g);
    for (int c = 0; c < min(total, stages); ++c) load_q(c);
  }
  for (int e = threadIdx.x; e < min(total, stages) * BM; e += Dkv<DH>::THREADS)
    load_row(e / BM, e % BM);
  __syncthreads();

  // warpgroup g; the warp's k/v rows [r0, r0 + 16) of the tile
  const int g = warp >> 2, r0 = (warp & 3) * 16;
  const uint32_t ks = kvbuf + 2 * g * TILE, vs = ks + TILE;
  const size_t rs = (size_t)H * DH, head = (size_t)b * T * rs + (size_t)h * DH;
  int c = 0;  // q/dO loads consumed so far
  for (int r = 0; r < rounds; ++r) {
    const int j = dkv_kv_tile<WG>(n, r, g);
    // a warp whose 16 k/v rows all lie before row 0 issues no products
    const bool live = j > 0 || (j == 0 && r0 + 15 >= dead);
    uint32_t ka[KC][4], va[KC][4];
    if (j >= 0) {
      mbar_wait(kvfull + 8 * g, r & 1);
      if (live) {
        fwd_load_q<DH, L>(ka, ks, r0, lane);
        fwd_load_q<DH, L>(va, vs, r0, lane);
      }
      // the k/v buffer is no longer read: its last reader loads the next tile
      if (warp_release(kv_count + g, 4, lane) && r + 1 < rounds &&
          dkv_kv_tile<WG>(n, r + 1, g) >= 0)
        load_kv(r + 1, g);
    }
    float dka[DT][4], dva[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;
    const int first = resident ? j : WG * r;
    const int walk = resident ? (j >= 0 ? n - j : 0) : n - WG * r;
    for (int w = 0; w < walk; ++w, ++c) {
      const int i = first + w, s = resident ? i : c % stages;
      mbar_wait(qfull + 8 * s, resident ? 0 : (c / stages) & 1);
      if (live && i >= j) {
        const float* ls = rows + 2 * s * BM;
        dkv_tile<DH, L>(dka, dva, ka, va, qbuf + 2 * s * TILE,
                        qbuf + (2 * s + 1) * TILE, ls, ls + BM, i == j, r0,
                        max(r0, i == 0 ? dead : 0), scale2, scale, lane);
      }
      // the stage is no longer read: its last reader's warp loads the next
      // rows into it, then lane 0 the next tiles (the barrier's arrival
      // orders the rows before the readers')
      if (!resident &&
          __shfl_sync(0xffffffffu, warp_release(q_count + s, 4 * WG, lane), 0) &&
          c + stages < total) {
        for (int rr = lane; rr < BM; rr += 32) load_row(c + stages, rr);
        __syncwarp();
        if (lane == 0) load_q(c + stages);
      }
    }
    if (live)
      dkv_store<DH>(dk + head, dv + head, dka, dva,
                    T - (n - j) * BM + r0 + (lane >> 2), rs, lane);
  }
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

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query (the library links libcudart only)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the (Dh, H, T, B) view of a (B, T, H, Dh) bf16 tensor, in boxes of
// min(Dh, 64) columns x 1 head x BM rows x 1 batch
template <int DH>
int tile_map(CUtensorMap* map, const void* ptr, int B, int T, int H) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  constexpr cuuint32_t BOXC = SwizzledRows<DH>::BOXC;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * 2, (cuuint64_t)H * DH * 2,
                                 (cuuint64_t)T * H * DH * 2};
  const cuuint32_t box[4] = {BOXC, 1, BM, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult err = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      BOXC == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return err == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// k/v stages of the forward at length T: the whole head when its tiles and
// the q buffers fit in a block's shared memory, else a ring
template <int DH>
int fwd_stages(int T) {
  constexpr int TILE = BM * DH * 2, MAX_SMEM = 227 * 1024;
  const int n = (T + BM - 1) / BM;
  const bool fits = 1024 + FWD_BAR_BYTES + (FWD_WG + 2 * n) * TILE <= MAX_SMEM &&
                    12 * (n + FWD_WG) <= FWD_BAR_BYTES;
  return fits ? n : FWD_STREAM_STAGES;
}

// 1024 bytes of slack to align the tiles, the barriers, q buffers, stages
template <int DH>
int fwd_smem(int T) {
  return 1024 + FWD_BAR_BYTES + (FWD_WG + 2 * fwd_stages<DH>(T)) * BM * DH * 2;
}

template <int DH>
int fwd_plan(int T, int* smem, int* blocks_per_sm) {
  *smem = fwd_smem<DH>(T);
  if (int err = launch_prep(flash_fwd_kernel<DH>, *smem)) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_fwd_kernel<DH>, FWD_THREADS, *smem);
}

template <int DH>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int T, int H, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (int err = tile_map<DH>(&mq, q, B, T, H)) return err;
  if (int err = tile_map<DH>(&mk, k, B, T, H)) return err;
  if (int err = tile_map<DH>(&mv, v, B, T, H)) return err;
  const int smem = fwd_smem<DH>(T);
  if (int err = launch_prep(flash_fwd_kernel<DH>, smem)) return err;
  flash_fwd_kernel<DH><<<B * H, FWD_THREADS, smem, stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, T, H, fwd_stages<DH>(T),
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// q/dO stages of the dK/dV kernel at length T: the whole head when its
// tiles and rows fit in a block's shared memory beside the k/v buffers,
// else a ring
template <int DH>
int dkv_stages(int T) {
  constexpr int TILE = BM * DH * 2, MAX_SMEM = 227 * 1024;
  const int n = (T + BM - 1) / BM;
  constexpr int WG = Dkv<DH>::WG;
  const bool fits = 1024 + DKV_BAR_BYTES + (2 * WG + 2 * n) * TILE +
                            2 * n * ROW_BYTES <= MAX_SMEM &&
                    12 * (n + WG) <= DKV_BAR_BYTES;
  return fits ? n : DKV_STREAM_STAGES;
}

// 1024 bytes of slack to align the tiles, the barriers, k/v buffers,
// q/dO stages, their lse/di rows
template <int DH>
int dkv_smem(int T) {
  const int stages = dkv_stages<DH>(T);
  return 1024 + DKV_BAR_BYTES + (2 * Dkv<DH>::WG + 2 * stages) * BM * DH * 2 +
         2 * stages * ROW_BYTES;
}

template <int DH>
int dkv_plan(int T, int* smem, int* blocks_per_sm) {
  *smem = dkv_smem<DH>(T);
  if (int err = launch_prep(flash_bwd_dkv_kernel<DH>, *smem)) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_bwd_dkv_kernel<DH>, Dkv<DH>::THREADS, *smem);
}

template <int DH>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* di, void* dk, void* dv, int B, int T,
            int H, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (int err = tile_map<DH>(&mq, q, B, T, H)) return err;
  if (int err = tile_map<DH>(&mk, k, B, T, H)) return err;
  if (int err = tile_map<DH>(&mv, v, B, T, H)) return err;
  if (int err = tile_map<DH>(&mdo, dout, B, T, H)) return err;
  const int smem = dkv_smem<DH>(T);
  if (int err = launch_prep(flash_bwd_dkv_kernel<DH>, smem)) return err;
  flash_bwd_dkv_kernel<DH><<<B * H, Dkv<DH>::THREADS, smem, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)di, (bf16*)dk,
      (bf16*)dv, T, H, dkv_stages<DH>(T),
      scale * LOG2E, scale);
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
  // TMA takes 16-byte aligned bases (and strides: Dh, H Dh and T H Dh
  // elements are multiples of 16 bytes at every Dh taken)
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 32: return fwd<32>(q, k, v, o, lse, B, T, H, scale, s);
    case 64: return fwd<64>(q, k, v, o, lse, B, T, H, scale, s);
    case 128: return fwd<128>(q, k, v, o, lse, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the forward's launch at length T: dynamic shared memory per block and the
// blocks that fit on one SM of the current device
extern "C" int vqt_flash_fwd_plan(int T, int Dh, int* smem,
                                  int* blocks_per_sm) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 32: return fwd_plan<32>(T, smem, blocks_per_sm);
    case 64: return fwd_plan<64>(T, smem, blocks_per_sm);
    case 128: return fwd_plan<128>(T, smem, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int vqt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* di, void* dk, void* dv, int B,
                                 int T, int H, int Dh, float scale,
                                 void* stream) {
  if (bad_shape(B, T, H)) return (int)cudaErrorInvalidValue;
  // TMA takes 16-byte aligned bases; dk and dv are held to the same
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)lse | (uintptr_t)di | (uintptr_t)dk | (uintptr_t)dv) & 15)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 32: return bwd_dkv<32>(q, k, v, dout, lse, di, dk, dv, B, T, H, scale, s);
    case 64: return bwd_dkv<64>(q, k, v, dout, lse, di, dk, dv, B, T, H, scale, s);
    case 128: return bwd_dkv<128>(q, k, v, dout, lse, di, dk, dv, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the dK/dV kernel's launch at length T, as vqt_flash_fwd_plan
extern "C" int vqt_flash_bwd_dkv_plan(int T, int Dh, int* smem,
                                      int* blocks_per_sm) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 32: return dkv_plan<32>(T, smem, blocks_per_sm);
    case 64: return dkv_plan<64>(T, smem, blocks_per_sm);
    case 128: return dkv_plan<128>(T, smem, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int vqt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, void* dq, int B, int T, int H,
                                int Dh, float scale, void* stream) {
  if (bad_shape(B, T, H)) return (int)cudaErrorInvalidValue;
  // the kernel reads its operands 16 bytes at a time; dq is held to the same
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)dq) & 15)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 32: return bwd_dq<32>(q, k, v, dout, lse, di, dq, B, T, H, scale, s);
    case 64: return bwd_dq<64>(q, k, v, dout, lse, di, dq, B, T, H, scale, s);
    case 128: return bwd_dq<128>(q, k, v, dout, lse, di, dq, B, T, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
