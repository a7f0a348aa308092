// A redesign of K2 (csrc/int8_matmul.cu) that is NOT shipped: it is not
// built by ops/_build.py and no wrapper calls it. int8_matmul_probe.py
// times it (`python3 int8_matmul_probe.py --source
// vector_quantization_tpu_torch/csrc/designs/int8_matmul_stripe.cu`), with
// its plan (`stripe_plan` there). On an H100 it beat the bf16 library call
// at the qkv, o and lm head shapes of the decode step but not at gate+up
// and down (PERF.md), so the shipped K2 stays the split-K design.
//
// Weight-only INT8 matmul (W8A16) for Hopper: out (B, F) f32 =
//   (x (B, D) bf16 @ w (D, F) int8 converted to bf16) * scale (F,) f32,
// with f32 accumulation and the per-output-channel scale applied to the f32
// sum on the way out.
//
// Replaces the TPU kernel vector_quantization_tpu/ops/int8_matmul.py
// `_int8_matmul_pallas` (kernel body `_kernel`), and keeps its
// decomposition: a grid step owns a stripe of output columns over the whole
// depth D, so no sum crosses a block.
//
// What bounds it on the H100: at the decode batch (B = 64) the product does
// 2 B = 128 operations per weight byte, far below the card's ~295 bf16
// operations per byte of HBM, so the ideal kernel is bound by one read of
// the int8 weight (D F bytes) at 3.35 TB/s: 0.3-2.2 us at Llama-medium's
// per-layer shapes, about what one graph node costs. In practice a call is
// bound by latency: the chain of loads, products and the final sum of one
// block. What the design does about it:
// - one launch per call: no memset, no atomics, no workspace. A block owns
//   32 output columns over a run of k tiles and up to 64 rows of x (B > 64
//   adds row tiles, grid y); the run is all of D, or a 1/KS share of it
//   when a cluster of KS blocks (2 or 4) splits D for a shape with too few
//   column stripes to fill the card;
// - depth inside the block: each of 8 warps takes the k tiles i with
//   i % 8 == warp and keeps its 64 x 32 f32 partial in 64 registers. The
//   partials meet once, in shared memory, at the end; with a split, the
//   blocks' sums then meet through distributed shared memory, each block
//   adding and storing 64 / KS rows, where the scale is applied and each
//   output is stored once;
// - each warp streams its own tiles (x 64 rows x KT bf16, w KT x 32 int8,
//   KT = 32 or 64 deep) through a private ring of 1-4 stages with 16-byte
//   cp.async copies spread over its lanes, written swizzled so that ldmatrix
//   reads them without bank conflicts. No barrier is shared between warps
//   until the end. A block's time follows the bytes it pulls (most of them
//   x, read by every block), so the plan trades ring depth against two
//   blocks to an SM;
// - where a row pitch or base is not a multiple of 16 bytes (the lm head's
//   F = 17385, a D of 100), that operand is copied 4 bytes at a time from
//   the aligned words around each row into a raw ring and shifted into
//   place (funnel shifts);
// - fragments: ldmatrix for x (A); ldmatrix .trans over the int8 tile seen
//   as b16 for w (B): a register then holds 2 depths x 2 columns, which
//   become the B fragments of two n8 tiles whose column index is permuted
//   (mma column g is weight column 2g or 2g + 1). int8 is widened exactly by
//   byte permutes into 2^23 + (v + 128), an f32 subtract, and a bf16 pack;
//   the products run on the tensor cores (mma.sync m16n8k16 bf16 -> f32).
// Any B >= 1, D >= 1 and F >= 1 are taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;      // rows of x per block
constexpr int BN = 32;      // output columns per block
constexpr int WARPS = 8;    // warp w takes the k tiles i with i % 8 == w
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_STAGES = 4;
constexpr int RED_PITCH = 36;  // f32 per row of a warp's partial
constexpr int RED = WARPS * BM * RED_PITCH * 4;  // the warps' partials
constexpr int SUM = BM * BN * 4;                 // the block's sums
constexpr int MAX_SMEM = 227 * 1024;

// a k tile of KT depths: x 64 x KT bf16 (2 KT-byte rows), w KT x 32 int8
template <int KT>
struct Tile {
  static constexpr int X = BM * KT * 2, W = KT * BN, STAGE = X + W;
  static constexpr int RAW_X = BM * (2 * KT + 4), RAW_W = KT * (BN + 4);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset o in a tile of SEG-byte rows as TMA writes it with a SEG-byte
// swizzle (SEG = 32, 64 or 128): 16-byte chunk bits [4, 4 + log2(SEG/16))
// XOR address bits [7, ...). Tiles start on 1024-byte boundaries.
template <int SEG>
__device__ __forceinline__ uint32_t swz(uint32_t o) {
  return o ^ (((o >> 7) & (SEG / 16 - 1)) << 4);
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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bytes p and p + 2 of u (int8 values with their sign bit flipped, so
// v + 128) -> a bf16 pair, byte p in the low half. 0x4B0000uu is the float
// 2^23 + uu, exact; minus 2^23 + 128 it is v, which bf16 holds exactly.
__device__ __forceinline__ uint32_t widen2(uint32_t u, int p) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + p)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652 + p)) - 8388736.f;
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One operand read 4 bytes at a time: rows [row0, row0 + ROWS) of a byte matrix
// with `rows` rows of `len` bytes at `pitch` bytes (any alignment), bytes
// [col0, col0 + SEG) of each, zero outside the matrix. A warp copies the
// aligned words around each row (LPR lanes a row), then shifts them into
// place.
template <int SEG, int ROWS>
struct RawCopy {
  static constexpr int WORDS = SEG / 4 + 1;  // aligned words around a row
  static constexpr int LPR = WORDS <= 16 ? 16 : 32, WPL = (WORDS + LPR - 1) / LPR;
  static constexpr int OUT = SEG / 4, LPO = OUT < 32 ? OUT : 32;  // words placed per row
  unsigned long long base;  // the matrix's address
  long long pitch, bytes;
  int rows, len;

  // the 4-byte copies of one tile into `raw` (ROWS rows of WORDS words)
  __device__ __forceinline__ void issue(uint32_t raw, int row0, int col0, int lane) const {
    const int nb = min(len - col0, SEG);
    if (nb <= 0) return;
    const unsigned long long end = base + bytes;
    for (int r = lane / LPR; r < ROWS && row0 + r < rows; r += 32 / LPR) {
      const unsigned long long p = base + (row0 + r) * pitch + col0;
      const unsigned long long lim = min(p + nb, end);
#pragma unroll
      for (int k = 0; k < WPL; ++k) {
        const int q = lane % LPR + k * LPR;
        const unsigned long long src = (p & ~3ull) + 4 * q;
        if (q < WORDS && src < lim)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                       ::"r"(raw + 4 * (r * WORDS + q)), "l"(src), "r"((int)min(4ull, end - src))
                       : "memory");
      }
    }
  }

  // the landed words of one tile, shifted into place, into a SEG-swizzled tile
  __device__ __forceinline__ void place(uint32_t dst, const uint32_t* raw, int row0,
                                        int col0, int lane) const {
    const int nb = min(len - col0, SEG), o = lane % LPO, keep = nb - 4 * o;
    for (int r = lane / LPO; r < ROWS; r += 32 / LPO) {
      uint32_t v = 0;
      if (row0 + r < rows && keep > 0) {
        const int sh = (int)((base + (row0 + r) * pitch + col0) & 3) * 8;
        const uint32_t lo = raw[r * WORDS + o];
        v = sh ? __funnelshift_r(lo, raw[r * WORDS + o + 1], sh) : lo;
        if (keep < 4) v &= (1u << (8 * keep)) - 1u;
      }
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst + swz<SEG>(r * SEG + 4 * o)), "r"(v)
                   : "memory");
    }
  }
};

// One operand read 16 bytes at a time: rows [row0, row0 + ROWS) of a byte
// matrix with `rows` rows of `len` bytes at a pitch of a multiple of 16
// bytes, bytes [col0, col0 + SEG) of each, zero outside the matrix, copied
// into a SEG-swizzled tile by one warp
template <int SEG, int ROWS>
struct VecCopy {
  static constexpr int CHUNKS = SEG / 16;
  const unsigned char* base;
  long long pitch;
  int rows, len;

  __device__ __forceinline__ void issue(uint32_t dst, int row0, int col0, int lane) const {
#pragma unroll
    for (int e = lane; e < ROWS * CHUNKS; e += 32) {
      const int r = e / CHUNKS, c = e % CHUNKS, col = col0 + 16 * c;
      const int size = row0 + r < rows ? max(0, min(16, len - col)) : 0;
      const unsigned char* src = size ? base + (row0 + r) * pitch + col : base;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   ::"r"(dst + swz<SEG>(r * SEG + 16 * c)), "l"(src), "r"(size)
                   : "memory");
    }
  }
};

// x (B, D) bf16 and w (D, F) int8 as byte matrices, each read 16 bytes at a
// time (vec) or 4 bytes at a time into the raw ring (raw)
struct Params {
  const unsigned char* x;
  const unsigned char* w;
  const float* scale;
  float* out;
  int B, D, F, stages, split, x_vec, w_vec;
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the 4 f32 at the same shared offset in the cluster's block `rank`
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float4 v;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote));
  return v;
}

__device__ __forceinline__ void wait_copies(int pending) {  // all but `pending` groups landed
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Shared memory: each warp's ring of `stages` tiles (the warps' partials
// reuse it at the end), each warp's raw ring for the operands read 4 bytes
// at a time, the block's sums.
template <int KT>
__global__ void __launch_bounds__(THREADS, 2)
w8a16_stripe_kernel(const Params a) {
  using T = Tile<KT>;
  extern __shared__ unsigned char smem_mm[];
  unsigned char* base =
      smem_mm + (((smem_u32(smem_mm) + 1023u) & ~1023u) - smem_u32(smem_mm));
  const int S = a.stages, KS = a.split;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi8 = lane >> 3, r8 = lane & 7;
  // a cluster of KS blocks splits D: rank = blockIdx.x % KS
  const int rank = blockIdx.x % KS, n0 = (blockIdx.x / KS) * BN, m0 = blockIdx.y * BM;
  const int ntiles = (a.D + KT - 1) / KT;
  const int kb = rank * ntiles / KS, ke = (rank + 1) * ntiles / KS;
  const int raw_x = a.x_vec ? 0 : T::RAW_X, raw_w = a.w_vec ? 0 : T::RAW_W, raw_t = raw_x + raw_w;
  const int ring_bytes = max(WARPS * S * T::STAGE, RED);
  const uint32_t ring = smem_u32(base) + warp * S * T::STAGE;
  const uint32_t raw = smem_u32(base) + ring_bytes + warp * S * raw_t;
  const uint32_t* rawp =
      reinterpret_cast<const uint32_t*>(base + ring_bytes + warp * S * raw_t);
  float* sums = reinterpret_cast<float*>(base + ring_bytes + WARPS * S * raw_t);

  const VecCopy<2 * KT, BM> vx{a.x, 2ll * a.D, a.B, 2 * a.D};
  const VecCopy<BN, KT> vw{a.w, (long long)a.F, a.D, a.F};
  const RawCopy<2 * KT, BM> rx{(unsigned long long)a.x, 2ll * a.D, 2ll * a.D * a.B, a.B, 2 * a.D};
  const RawCopy<BN, KT> rw{(unsigned long long)a.w, (long long)a.F, (long long)a.F * a.D, a.D, a.F};
  // the warp's j-th tile (k tile kb + warp + 8 j) into its stage j % S
  auto issue = [&](int j) {
    const int i = kb + warp + WARPS * j;
    if (i < ke) {
      const uint32_t slot = ring + (j % S) * T::STAGE, rs = raw + (j % S) * raw_t;
      if (a.x_vec) vx.issue(slot, m0, 2 * i * KT, lane);
      else rx.issue(rs, m0, 2 * i * KT, lane);
      if (a.w_vec) vw.issue(slot + T::X, i * KT, n0, lane);
      else rw.issue(rs + raw_x, i * KT, n0, lane);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][nt][c] = 0.f;
  for (int j = 0; j < S - 1; ++j) issue(j);
  for (int j = 0; kb + warp + WARPS * j < ke; ++j) {
    issue(j + S - 1);
    wait_copies(S - 1);  // tile j landed
    __syncwarp();
    const uint32_t xs = ring + (j % S) * T::STAGE, ws = xs + T::X;
    if (raw_t) {  // shift the raw words into place
      const int i = kb + warp + WARPS * j;
      const uint32_t* src = rawp + (j % S) * (raw_t / 4);
      if (!a.x_vec) rx.place(xs, src, m0, 2 * i * KT, lane);
      if (!a.w_vec) rw.place(ws, src + raw_x / 4, i * KT, n0, lane);
      __syncwarp();
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      // w rows [16 kk, 16 kk + 16), columns [0, 16) and [16, 32): matrices
      // (rows 0-7, half 0), (rows 8-15, half 0), (0-7, 1), (8-15, 1)
      uint32_t bw[4];
      ldsm_x4_t(bw, ws + swz<BN>((kk * 16 + (mi8 & 1) * 8 + r8) * BN + (mi8 >> 1) * 16));
      uint32_t bb[4][2];  // n8 tile 2h + p: weight columns 16 h + 2 g' + p
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t lo = bw[2 * h] ^ 0x80808080u, hi = bw[2 * h + 1] ^ 0x80808080u;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          bb[2 * h + p][0] = widen2(lo, p);
          bb[2 * h + p][1] = widen2(hi, p);
        }
      }
      uint32_t ax[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(ax[mi], xs + swz<2 * KT>((mi * 16 + (mi8 & 1) * 8 + r8) * (2 * KT) +
                                         (kk * 16 + (mi8 >> 1) * 8) * 2));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mi][nt], ax[mi], bb[nt][0], bb[nt][1]);
    }
    __syncwarp();  // the stage is refilled by the next issue
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // the partials meet: every warp is past its last tile
  __syncthreads();
  float* red = reinterpret_cast<float*>(base);
  float* mine = red + warp * BM * RED_PITCH;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)  // rows g and g + 8 of the m16 tile
#pragma unroll
      for (int h = 0; h < 2; ++h)  // columns 16 h + 4 t + [0, 4)
        *reinterpret_cast<float4*>(mine + (mi * 16 + g + 8 * hr) * RED_PITCH + 16 * h + 4 * t) =
            make_float4(acc[mi][2 * h][2 * hr], acc[mi][2 * h + 1][2 * hr],
                        acc[mi][2 * h][2 * hr + 1], acc[mi][2 * h + 1][2 * hr + 1]);
  __syncthreads();
  // the block's sums, 4 columns a thread (one float4 each: 64 x 32 / 4 = 2 x 256)
  for (int e = threadIdx.x; e < BM * BN / 4; e += THREADS) {
    const int row = e / (BN / 4), col = 4 * (e % (BN / 4));
    const float* src = red + row * RED_PITCH + col;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(src + w * BM * RED_PITCH);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (KS > 1) {
      *reinterpret_cast<float4*>(sums + row * BN + col) = sum;
      continue;
    }
    const float part[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (m0 + row < a.B && n0 + col + u < a.F)
        a.out[(size_t)(m0 + row) * a.F + n0 + col + u] = part[u] * a.scale[n0 + col + u];
  }
  if (KS == 1) return;
  // with a split: block `rank` adds rows [rank, rank + KS, ...) of the
  // cluster's sums, read through distributed shared memory, 4 columns at a
  // time, every block's load issued before the adds
  cluster_sync();
  for (int e = threadIdx.x; e < BM * BN / 4 / KS; e += THREADS) {
    const int row = rank + KS * (e / (BN / 4)), col = 4 * (e % (BN / 4));
    const uint32_t at = smem_u32(sums + row * BN + col);
    float4 v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r < KS) v[r] = ld_cluster4(at, r);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r < KS) {
        part[0] += v[r].x;
        part[1] += v[r].y;
        part[2] += v[r].z;
        part[3] += v[r].w;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (m0 + row < a.B && n0 + col + u < a.F)
        a.out[(size_t)(m0 + row) * a.F + n0 + col + u] = part[u] * a.scale[n0 + col + u];
  }
  cluster_sync();  // no block leaves while a peer may still read its sums
}

template <int KT>
int smem_bytes(int stages, int x_vec, int w_vec) {
  using T = Tile<KT>;
  const int ring = WARPS * stages * T::STAGE;
  const int raw = (x_vec ? 0 : T::RAW_X) + (w_vec ? 0 : T::RAW_W);
  return 1024 + (ring > RED ? ring : RED) + WARPS * stages * raw + SUM;
}

template <int KT>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_bytes<KT>(p.stages, p.x_vec, p.w_vec);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (int err = (int)cudaFuncSetAttribute(
          w8a16_stripe_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.F + BN - 1) / BN * p.split, (p.B + BM - 1) / BM, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;  // an unsplit launch is no cluster
  if (int err = (int)cudaLaunchKernelEx(&cfg, w8a16_stripe_kernel<KT>, p)) return err;
  return (int)cudaGetLastError();
}

template <int KT>
int occupancy(int stages, int x_vec, int w_vec, int* smem, int* blocks_per_sm) {
  *smem = smem_bytes<KT>(stages, x_vec, w_vec);
  if (int err = (int)cudaFuncSetAttribute(
          w8a16_stripe_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem))
    return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, w8a16_stripe_kernel<KT>, THREADS, *smem);
}

}  // namespace

// x (B, D) bf16, w (D, F) int8, scale (F,) f32 -> out (B, F) f32 under the
// plan (int8_matmul_probe.py `stripe_plan`): k tiles of kt (32 or 64) depths,
// D split over clusters of `split` (1, 2 or 4) blocks, `stages` (1-4) tiles
// in each warp's ring, and each operand read 16 bytes at a time (x_vec,
// w_vec: base and row pitch multiples of 16 bytes) or 4 bytes at a time.
extern "C" int vqt_int8_matmul(const void* x, const void* w, const void* scale, void* out,
                               int B, int D, int F, int kt, int split, int stages, int x_vec,
                               int w_vec, void* stream) {
  if (B < 1 || D < 1 || F < 1 || stages < 1 || stages > MAX_STAGES ||
      (split != 1 && split != 2 && split != 4))
    return (int)cudaErrorInvalidValue;
  if ((x_vec && ((uintptr_t)x % 16 || D % 8)) || (w_vec && ((uintptr_t)w % 16 || F % 16)))
    return (int)cudaErrorMisalignedAddress;
  const Params p{(const unsigned char*)x, (const unsigned char*)w, (const float*)scale,
                 (float*)out, B, D, F, stages, split, x_vec, w_vec};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kt) {
    case 32: return launch<32>(p, s);
    case 64: return launch<64>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// shared memory per block of a launch and the blocks that fit on one SM
extern "C" int vqt_int8_matmul_occupancy(int kt, int stages, int x_vec, int w_vec, int* smem,
                                         int* blocks_per_sm) {
  switch (kt) {
    case 32: return occupancy<32>(stages, x_vec, w_vec, smem, blocks_per_sm);
    case 64: return occupancy<64>(stages, x_vec, w_vec, smem, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
