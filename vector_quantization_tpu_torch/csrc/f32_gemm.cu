// f32 matrix product for Hopper on the TF32 tensor cores at f32 accuracy:
//   C (I, J) f32 = sum_r A(i, r) B(j, r) (+ bias),
// with f32 inputs and f32 sums. GPT-2's dense layers and its tied head
// (models/transformers/gpt2.py) take it through ops/f32_gemm.py, in the
// forward and in both products of the backward.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA,
// which runs them on the TPU's matrix unit. On the H100 PyTorch's f32
// product runs on the CUDA cores (67 TFLOP/s at most), and plain TF32 keeps
// too few digits for the model's f32 training. It was added because GPT-2's
// 291 products of a training step at 16,448 rows (31.56 TFLOP) took most of
// the AR step on the CUDA cores.
//
// What bounds it on the H100: operations. Each f32 operand v is split as
// hi = tf32(v), lo = tf32(v - hi) (round to nearest, ties away), and the
// product takes lo.hi + hi.lo + hi.hi (the dropped lo.lo is ~2^-22 of a
// term): three TF32 products, so the floor is 3 x 2 I J R operations at
// 495 TFLOP/s. Bytes are far below that: at (16448, 1024, 3072) the inputs
// and the output are 0.28 GB (84 us at 3.35 TB/s) against 0.62 ms of
// operations.
//
// What the design does:
// - the products run on wgmma m64n128k8 (TF32 operands, f32 sums). wgmma
//   reads TF32 B tiles from shared memory only K-major, so B arrives split
//   already: a prologue launch (`split_kernel`) writes its hi and lo parts
//   K-major (J rows of R) into a workspace, transposing where the source is
//   not. The wrapper makes the smaller operand B (the weight in the forward
//   and the input gradient, the narrower side in the weight gradient), so
//   the prologue moves little. A is taken from registers: each consumer
//   thread reads its fragment of the f32 tile from shared memory and splits
//   it there, so A may lie either way in device memory (A_TRANS: I is the
//   contiguous dimension, as in a weight gradient's sum over rows);
// - a tile is 128 x 128 of C; two consumer warpgroups own 64 rows each. A's
//   128 x 32 f32 tile (or four 32 x 32 boxes when transposed) and B's two
//   128 x 32 tiles arrive by TMA (128-byte swizzle) into a ring of 4 stages
//   of 48 KB behind mbarriers, issued by one thread of a producer warpgroup
//   (its registers given to the consumers by setmaxnreg);
// - the grid is persistent: one block per SM walks the tiles, rows grouped
//   8 tiles at a time so that the blocks at work share A's and B's tiles in
//   L2, and the producer fills the next tile's stages while the consumers
//   store. Where the tiles do not fill the card the sum over R is split
//   across blocks (split-K: the wrapper sums the parts);
// - accuracy over long sums: the tensor cores add a k-step's products into
//   the accumulator with truncation, which drifts over the 2,056 k-steps of
//   a weight gradient at R = 16,448. The wgmmas of one stage (12 of them,
//   32 deep) and of the next PROMOTE - 1 stages sum into an inner
//   accumulator from zero, which is then added into an f32 outer
//   accumulator on the CUDA cores (round to nearest), as Hopper FP8 GEMMs
//   promote their sums. Between promotions the wgmmas run on across stages;
// - a k-step's fragments are read and split while the last k-step's
//   wgmmas run (two fragment register sets), a stage's first ones while
//   the stage before drains;
// - the epilogue adds the bias (per column of the stored C) and stores from
//   registers: 8-byte words where rows allow, or C transposed (`trans_c`,
//   a store per element, 8 rows to a 32-byte sector). Rows past I and
//   columns past J are masked, so any I, J >= 1 is taken.
// A's base and row pitch and B's split rows must be 16-byte aligned for TMA
// (the wrapper's dispatch: K and N multiples of 4).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BM = 128;                    // rows of C per tile: two warpgroups of 64
constexpr int BN = 128;                    // columns of C per tile: the wgmma's N
constexpr int BK = 32;                     // depth per stage: a 128-byte row of f32
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;             // two warpgroups (warps 0-7)
constexpr int THREADS = CONSUMERS + 128;   // and a producer warpgroup
constexpr int A_STAGE = BM * BK * 4;       // 16384
constexpr int B_STAGE = BN * BK * 4;       // 16384, hi or lo
constexpr int STAGE = A_STAGE + 2 * B_STAGE;
constexpr int HEADER = 1024;               // mbarriers: full[s] at 8 s, empty[s] at 64 + 8 s
constexpr int SMEM = 1024 + HEADER + STAGES * STAGE;  // 1024: the ring's alignment slack
constexpr int GROUP = 8;                   // row tiles walked together
// stages (32 deep, 12 wgmmas) whose products the tensor cores sum before
// the sum joins the f32 accumulator (gemm_probe.py --sweeps: the error
// against float64 and the time at 1, 2, 4, 8 and once a tile)
constexpr int PROMOTE = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// A wait that has not ended after ~2^34 cycles (seconds; a stage takes
// microseconds) traps: a broken protocol fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
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

// box (c0, c1) of a 2-d tensor map -> dst, completing on `bar`
__device__ __forceinline__ void tma2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                      int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// B operand descriptor of a 128 x 32 f32 tile at `addr` (K-major rows of
// 128 bytes as TMA writes them with the 128-byte swizzle; 8-row groups 1024
// bytes apart); + 2 per k-step of 8 (32 bytes)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

#define ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
    "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (the warpgroup's 64 x 128 f32, 64 a thread) = a . b + (accumulate ? d : 0),
// a: this warp's 16 x 8 TF32 fragment of A in registers, b: a B tile
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// keeps the compiler from moving an accumulator across an asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps a fragment's registers live (not reused) until its wgmmas are done
__device__ __forceinline__ void fence_frag(uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(hi[i]), "+r"(lo[i])::"memory");
}

struct Params {
  const float* bias;  // per column of the stored C, or null
  float* out;
  long long split_stride;  // elements between the parts of a split sum
  int I, J, R, ldc, trans_c, tiles_i, tiles_j, tiles, kps;
};

// tile t -> its part of the sum over R and its (row, column) tile: the
// parts one after another, in each rows in groups of GROUP tiles, columns
// walked within a group
__device__ __forceinline__ void tile_of(const Params& p, int t, int& part, int& ti, int& tj) {
  const int per = p.tiles_i * p.tiles_j;
  part = t / per;
  const int r = t - part * per, band = GROUP * p.tiles_j;
  const int first = r / band * GROUP, rows = min(p.tiles_i - first, GROUP), q = r % band;
  ti = first + q % rows;
  tj = q / rows;
}

__device__ __forceinline__ int k_stages(const Params& p, int part) {
  const int k0 = part * p.kps;
  return (min(p.kps, p.R - k0) + BK - 1) / BK;
}

// ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile,
// warp w of it [64 wg + 16 w, + 16); lane (g, t4) rows g and g + 8 of those
// at depths t4 and t4 + 4 of each k-step
template <bool A_TRANS>
__device__ __forceinline__ void consume(const Params& p, uint32_t ring, uint32_t full,
                                        uint32_t empty, int tid) {
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int il = 64 * wg + 16 * warp + g;  // the lane's first row in the tile; the second is il + 8
  int s = 0;
  uint32_t ph = 0;
  float inner[64], outer[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) inner[i] = 0.f;
  uint32_t h0[4], l0[4], h1[4], l1[4];

  // the lane's A values of k-step ks of the stage at `a`, split: rows il,
  // il + 8 at depths r, r + 4 (r = 8 ks + t4), as the 128-byte swizzle
  // placed them
  auto frag = [&](uint32_t (&hi)[4], uint32_t (&lo)[4], uint32_t a, int ks) {
    float v[4];
    const int r = 8 * ks + t4;
    if (A_TRANS) {  // four 32 x 32 boxes, rows of 32 along I, one per depth
      const uint32_t box = a + (il >> 5) * 4096, c = ((il & 31) >> 2), w = (il & 3) * 4;
      const uint32_t c8 = (((il + 8) & 31) >> 2);
      v[0] = lds(box + r * 128 + ((c ^ (r & 7)) << 4) + w);
      v[1] = lds(box + r * 128 + ((c8 ^ (r & 7)) << 4) + w);
      v[2] = lds(box + (r + 4) * 128 + ((c ^ ((r + 4) & 7)) << 4) + w);
      v[3] = lds(box + (r + 4) * 128 + ((c8 ^ ((r + 4) & 7)) << 4) + w);
    } else {  // rows of 32 depths, one per row of the tile
      const uint32_t row = a + il * 128, x = il & 7, w = t4 * 4;
      v[0] = lds(row + (((2 * ks) ^ x) << 4) + w);
      v[1] = lds(row + 1024 + (((2 * ks) ^ x) << 4) + w);
      v[2] = lds(row + (((2 * ks + 1) ^ x) << 4) + w);
      v[3] = lds(row + 1024 + (((2 * ks + 1) ^ x) << 4) + w);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) split(v[q], hi[q], lo[q]);
  };
  // k-step ks's three products into `inner`, small ones first
  auto step = [&](const uint32_t (&hi)[4], const uint32_t (&lo)[4], uint32_t bh, int ks,
                  int accumulate) {
    const uint64_t dh = b_desc(bh) + 2 * ks, dl = b_desc(bh + B_STAGE) + 2 * ks;
    wg_fence();
    wgmma_tf32(inner, lo, dh, accumulate);
    wgmma_tf32(inner, hi, dl, 1);
    wgmma_tf32(inner, hi, dh, 1);
    wg_commit();
  };

  // this warp is done with stage st
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };

  // Each k-step's fragments are read while the k-step before runs, the
  // first of a stage while the stage before drains (the block's first one
  // here). Between promotions the wgmmas run on across stages: a stage is
  // released once the next stage's first k-step has been issued and the
  // stage's last one has finished (`pend`).
  if (blockIdx.x < p.tiles) {
    mbar_wait(full, 0);
    frag(h0, l0, ring, 0);
  }
  int pend = -1;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    int part, ti, tj;
    tile_of(p, t, part, ti, tj);
    const int nk = k_stages(p, part);
#pragma unroll
    for (int i = 0; i < 64; ++i) outer[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      const uint32_t a = ring + s * STAGE, bh = a + A_STAGE;
      step(h0, l0, bh, 0, kb % PROMOTE != 0);
      if (pend >= 0) {
        wg_wait<1>();
        fence_frag(h1, l1);
        release(pend);
        pend = -1;
      }
      frag(h1, l1, a, 1);
      step(h1, l1, bh, 1, 1);
      wg_wait<1>();
      fence_frag(h0, l0);
      frag(h0, l0, a, 2);
      step(h0, l0, bh, 2, 1);
      wg_wait<1>();
      fence_frag(h1, l1);
      frag(h1, l1, a, 3);
      step(h1, l1, bh, 3, 1);
      wg_wait<1>();
      fence_frag(h0, l0);
      const int cur = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
      const bool last = kb == nk - 1;
      if (!last || t + (int)gridDim.x < p.tiles) {
        mbar_wait(full + 8 * s, ph);
        frag(h0, l0, ring + s * STAGE, 0);
      }
      if (last || (kb + 1) % PROMOTE == 0) {
        wg_wait<0>();
        fence_frag(h1, l1);
        fence_acc(inner);
        release(cur);
#pragma unroll
        for (int i = 0; i < 64; ++i) outer[i] += inner[i];
        fence_acc(inner);
      } else {
        pend = cur;
      }
    }

    // the tile's sums (+ bias) -> C: acc[4 j + 2 h + e] is row il + 8 h,
    // column 8 j + 2 t4 + e
    float* out = p.out + part * p.split_stride;
    const bool bias = p.bias != nullptr && part == 0;
    const int i0 = ti * BM + il, c0 = tj * BN + 2 * t4;
    float rb[2] = {0.f, 0.f};
    if (bias && p.trans_c) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (i0 + 8 * h < p.I) rb[h] = p.bias[i0 + 8 * h];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j;
      float cb0 = 0.f, cb1 = 0.f;
      if (bias && !p.trans_c) {
        if (c < p.J) cb0 = p.bias[c];
        if (c + 1 < p.J) cb1 = p.bias[c + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 8 * h;
        if (i >= p.I || c >= p.J) continue;
        const float x0 = outer[4 * j + 2 * h] + cb0 + rb[h];
        const float x1 = outer[4 * j + 2 * h + 1] + cb1 + rb[h];
        if (p.trans_c) {
          out[(size_t)c * p.ldc + i] = x0;
          if (c + 1 < p.J) out[(size_t)(c + 1) * p.ldc + i] = x1;
        } else if (c + 1 < p.J && (p.ldc & 1) == 0) {
          *reinterpret_cast<float2*>(out + (size_t)i * p.ldc + c) = make_float2(x0, x1);
        } else {
          out[(size_t)i * p.ldc + c] = x0;
          if (c + 1 < p.J) out[(size_t)i * p.ldc + c + 1] = x1;
        }
      }
    }
  }
}

template <bool A_TRANS>
__global__ void __launch_bounds__(THREADS, 1)
f32_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tbh,
                const __grid_constant__ CUtensorMap tbl, const Params p) {
  extern __shared__ unsigned char smem_gemm[];
  const uint32_t base = (smem_u32(smem_gemm) + 1023u) & ~1023u;
  const uint32_t full = base, empty = base + 64, ring = base + HEADER;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != CONSUMERS) return;
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int part, ti, tj;
      tile_of(p, t, part, ti, tj);
      const int nk = k_stages(p, part), i0 = ti * BM, j0 = tj * BN;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t st = ring + s * STAGE, bar = full + 8 * s;
        const int k = part * p.kps + kb * BK;
        mbar_expect_tx(bar, STAGE);
        if (A_TRANS) {
#pragma unroll
          for (int q = 0; q < BM / 32; ++q) tma2d(st + q * 4096, &ta, bar, i0 + 32 * q, k);
        } else {
          tma2d(st, &ta, bar, k, i0);
        }
        tma2d(st + A_STAGE, &tbh, bar, k, j0);
        tma2d(st + A_STAGE + B_STAGE, &tbl, bar, k, j0);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<A_TRANS>(p, ring, full, empty, tid);
  }
}

// ---- the prologue: hi and lo parts of B, K-major ----------------------------

// hi, lo (J rows of `ldd`, the first R of each written) = split(B), B(j, r) =
// src[j * lds + r] or, TRANS, src[r * lds + j]; 32 x 32 tiles through
// shared memory where the source is transposed
template <bool TRANS>
__global__ void __launch_bounds__(256) split_kernel(const float* __restrict__ src, int lds_,
                                                     float* __restrict__ hi,
                                                     float* __restrict__ lo, int ldd, int J, int R) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.x * 32, j0 = blockIdx.y * 32;
  if (TRANS) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + ty + 8 * q, j = j0 + tx;
      tile[ty + 8 * q][tx] = r < R && j < J ? src[(size_t)r * lds_ + j] : 0.f;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + ty + 8 * q, r = r0 + tx;
    if (j >= J || r >= R) continue;
    const float v = TRANS ? tile[tx][ty + 8 * q] : src[(size_t)j * lds_ + r];
    uint32_t h, l;
    split(v, h, l);
    hi[(size_t)j * ldd + r] = __uint_as_float(h);
    lo[(size_t)j * ldd + r] = __uint_as_float(l);
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query (the library links libcudart only)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// a row-major f32 matrix of `rows` x `cols`, `pitch` elements a row, in
// boxes of 32 columns (128 bytes) x box_rows with the 128-byte swizzle;
// reads outside it arrive as zeros
int map2d(CUtensorMap* map, const void* ptr, int cols, int rows, long long pitch, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult err = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return err == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// 0 where `smem` bytes fit one block on the current card, else the error
int check_smem(int smem) {
  int device, limit;
  if (int err = (int)cudaGetDevice(&device)) return err;
  if (int err = (int)cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device))
    return err;
  return smem > limit ? (int)cudaErrorInvalidValue : 0;
}

template <bool A_TRANS>
int launch(const CUtensorMap& ta, const CUtensorMap& tbh, const CUtensorMap& tbl, const Params& p,
           int blocks, cudaStream_t stream) {
  if (int err = (int)cudaFuncSetAttribute(f32_gemm_kernel<A_TRANS>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM))
    return err;
  f32_gemm_kernel<A_TRANS><<<blocks, THREADS, SMEM, stream>>>(ta, tbh, tbl, p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// The prologue: hi, lo (J x ldd f32, the first R columns written) = the TF32
// parts of B (J x R), B(j, r) = src[j * lds + r] (trans 0) or src[r * lds + j]
// (trans 1).
extern "C" int vqt_f32_split(const void* src, int lds, int trans, void* hi, void* lo, int ldd,
                             int J, int R, void* stream) {
  if (J < 1 || R < 1 || ldd < R || lds < (trans ? J : R) || (J + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + 31) / 32, (J + 31) / 32), block(32, 8);
  const float* s = static_cast<const float*>(src);
  float *h = static_cast<float*>(hi), *l = static_cast<float*>(lo);
  if (trans) split_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(s, lds, h, l, ldd, J, R);
  else split_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(s, lds, h, l, ldd, J, R);
  return (int)cudaGetLastError();
}

// C (I x J) = sum_r A(i, r) B(j, r) (+ bias) over r in [0, R), split in
// `splits` parts of `kps` (a multiple of 32) whose sums go `split_stride`
// elements apart from `out`. A(i, r) = a[i * lda + r] (a_trans 0) or
// a[r * lda + i] (a_trans 1); B's parts bh, bl (J x ldb, from
// vqt_f32_split). C(i, j) goes to out[i * ldc + j] or, trans_c,
// out[j * ldc + i]; bias (or null) is added to the first part, per column of
// the stored matrix. At most `blocks` persistent blocks.
extern "C" int vqt_f32_gemm(const void* a, int a_trans, int lda, const void* bh, const void* bl,
                            int ldb, const void* bias, void* out, int ldc, int trans_c,
                            long long split_stride, int I, int J, int R, int kps, int splits,
                            int blocks, void* stream) {
  if (I < 1 || J < 1 || R < 1 || kps < BK || kps % BK || splits < 1 || blocks < 1 ||
      (long long)(splits - 1) * kps >= R || (long long)splits * kps < R || ldb < R ||
      lda < (a_trans ? I : R) || ldc < (trans_c ? I : J))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(a) || !aligned16(bh) || !aligned16(bl) || lda % 4 || ldb % 4)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap ta, tbh, tbl;
  int err = a_trans ? map2d(&ta, a, I, R, lda, 32) : map2d(&ta, a, R, I, lda, BM);
  if (!err) err = map2d(&tbh, bh, R, J, ldb, BN);
  if (!err) err = map2d(&tbl, bl, R, J, ldb, BN);
  if (!err) err = check_smem(SMEM);
  if (err) return err;
  const int tiles_i = (I + BM - 1) / BM, tiles_j = (J + BN - 1) / BN;
  const Params p = {static_cast<const float*>(bias), static_cast<float*>(out), split_stride, I, J, R,
                    ldc, trans_c, tiles_i, tiles_j, tiles_i * tiles_j * splits, kps};
  const int grid = p.tiles < blocks ? p.tiles : blocks;
  return a_trans ? launch<true>(ta, tbh, tbl, p, grid, (cudaStream_t)stream)
                 : launch<false>(ta, tbh, tbl, p, grid, (cudaStream_t)stream);
}
