// Weight-only INT8 matmul (W8A16) for Hopper, the wide design: out (B, F)
// f32 = (x (B, D) bf16 @ w (D, F) int8 converted to bf16) * scale (F,) f32,
// with f32 accumulation and the per-output-channel scale applied to the f32
// sum on the way out.
//
// Replaces the TPU kernel vector_quantization_tpu/ops/int8_matmul.py
// `_int8_matmul_pallas` (kernel body `_kernel`), and keeps its
// decomposition: a grid step owns a stripe of output columns over all of D
// or a cluster's share of it, so no sum leaves a cluster. The wrapper
// (ops/int8_matmul.py `plan`) launches this kernel where x's and w's rows
// are 16-byte aligned and a block's share fits, and the split-K design of
// csrc/int8_matmul.cu elsewhere (the lm head's F = 17385).
//
// What bounds it on the H100: at the decode batch (B = 64) the product does
// 2 B = 128 operations per weight byte, far below the card's ~295 bf16
// operations per byte of HBM, so the ideal kernel is bound by one read of
// the int8 weight (D F bytes) at 3.35 TB/s: 0.3-2.2 us at Llama-medium's
// per-layer shapes, about what one graph node costs. In practice a call is
// bound by latency: the chain of loads, products and the final sum of one
// block. What the design does about it:
// - one launch per call: no memset, no atomics, no workspace. A block owns
//   128 output columns over a 1/KS share of D, the KS blocks of a cluster
//   splitting D (KS = 1, 2, 4 or 8), and up to 64 rows of x (B > 64 adds
//   row tiles, grid y). The x bytes all blocks pull are (F / 128) B D 2,
//   B / 64 times the weight's own: a block reads x's share once;
// - x's share (64 rows x D / KS bf16, k tile by k tile) is copied once into
//   shared memory and stays there; the weight's k tiles (64 deep x 128)
//   stream through a ring of `stages` slots. Every copy of the first
//   `stages` tiles is issued before any wait; a tile's slot is refilled
//   once every warp is past it (one barrier per tile). Copies are 16-byte
//   cp.async, written swizzled so that ldmatrix reads them without bank
//   conflicts;
// - warp w owns the 16 columns [16 w, 16 w + 16): both n8 tiles of one
//   ldmatrix .trans over 16 bytes, all 64 rows, every x fragment read by
//   each warp; a lane keeps 32 f32 sums;
// - fragments: ldmatrix for x (A); ldmatrix .trans over the int8 tile seen
//   as b16 for w (B): a register then holds 2 depths x 2 columns, which
//   become the B fragments of two n8 tiles whose column index is permuted
//   (mma column g is weight column 2g or 2g + 1). int8 is widened exactly by
//   byte permutes into 2^23 + (v + 128), an f32 subtract, and a bf16 pack;
//   the products run on the tensor cores (mma.sync m16n8k16 bf16 -> f32);
// - with KS > 1 the sums meet by push: block r of the cluster owns rows
//   [64 r / KS, 64 (r + 1) / KS), whole 8-row groups of the mma fragments,
//   so each warp stores its 512 bytes of a group into the owner's shared
//   memory as one contiguous run, in fragment order; one barrier.cluster
//   arrive/wait pair, then the owner adds the KS copies in the same
//   register layout, applies the scale and stores each output once. (A
//   relaxed arrive at entry, waited on before the first remote store, makes
//   sure every peer has started.)
// x's rows must be 16-byte aligned (D % 8 == 0) and w's (F % 16 == 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                      // rows of x per block
constexpr int WN = 128;                     // output columns per block
constexpr int WKT = 64;                     // depth of a k tile
constexpr int WARPS = 8;                    // warp w owns columns [16 w, 16 w + 16)
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_STAGES = 8;               // ring slots (wait_group immediates)
constexpr int X_TILE = BM * WKT * 2;        // an x tile: 64 rows of 128 bytes
constexpr int W_TILE = WKT * WN;            // a weight tile: 64 rows of 128 bytes
constexpr int GROUPS = BM / 8;              // 8-row groups of the block's rows
constexpr int RECV = GROUPS * WARPS * 32 * 16;  // KS copies of the owned groups

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset o in a tile of SEG-byte rows as TMA writes it with a SEG-byte
// swizzle (SEG = 32, 64 or 128; the copies here write 128): 16-byte chunk
// bits [4, 4 + log2(SEG/16)) XOR address bits [7, ...). Tiles start on
// 1024-byte boundaries.
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
// 2^23 + uu, exact; minus 2^23 + 128 it is v, whose float has no bits below
// its top 8, so its high half is v in bf16, exactly: one byte permute packs
// the pair. (A conversion instruction packs the same pair; on the H100 it
// measured no faster, PERF.md.)
__device__ __forceinline__ uint32_t widen2(uint32_t u, int p) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + p)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652 + p)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wait_copies(int pending) {  // all but `pending` groups landed
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

struct Params {
  const unsigned char* x;
  const unsigned char* w;
  const float* scale;
  float* out;
  int B, D, F, split, stages, tiles;  // tiles: x slots, the largest share in k tiles
};

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int size) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(size)
               : "memory");
}

// 4 f32 into the shared memory of the cluster's block `rank`, at the offset
// `addr` has in this block
__device__ __forceinline__ void st_cluster4(uint32_t addr, uint32_t rank, float4 v) {
  uint32_t remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// every output goes through here
__device__ __forceinline__ void put4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__global__ void __launch_bounds__(THREADS, 2)
w8a16_wide_kernel(const Params a) {
  extern __shared__ unsigned char smem_mm[];
  unsigned char* base =
      smem_mm + (((smem_u32(smem_mm) + 1023u) & ~1023u) - smem_u32(smem_mm));
  const int KS = a.split, S = a.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, mi8 = lane >> 3, r8 = lane & 7;
  // a cluster of KS blocks splits D: rank = blockIdx.x % KS
  const int rank = blockIdx.x % KS, n0 = (blockIdx.x / KS) * WN, m0 = blockIdx.y * BM;
  if (KS > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int ntiles = (a.D + WKT - 1) / WKT;
  const int kb = rank * ntiles / KS, T = (rank + 1) * ntiles / KS - kb;
  const uint32_t xs0 = smem_u32(base), ring = xs0 + a.tiles * X_TILE;
  const uint32_t recv = ring + S * W_TILE;

  // the block's local tile j: x into its slot j, w into ring slot j % S
  auto issue = [&](int j) {
    if (j < T) {
      const int k0 = (kb + j) * WKT;
      for (int e = tid; e < BM * 8; e += THREADS) {
        const int r = e >> 3, c = e & 7, col = k0 + 8 * c;
        const bool ok = m0 + r < a.B && col < a.D;
        cp16(xs0 + j * X_TILE + swz<128>(r * 128 + 16 * c),
             ok ? a.x + ((size_t)(m0 + r) * a.D + col) * 2 : a.x, ok ? 16 : 0);
      }
      for (int e = tid; e < WKT * 8; e += THREADS) {
        const int r = e >> 3, c = e & 7, col = n0 + 16 * c;
        const bool ok = k0 + r < a.D && col < a.F;
        cp16(ring + (j % S) * W_TILE + swz<128>(r * 128 + 16 * c),
             ok ? a.w + (size_t)(k0 + r) * a.F + col : a.w, ok ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[4][2][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][nt][c] = 0.f;
  for (int j = 0; j < S; ++j) issue(j);
  for (int j = 0; j < T; ++j) {
    wait_copies(j == 0 ? S - 1 : S - 2);  // this thread's copies of tile j landed
    __syncthreads();  // everyone's have; every warp is past tile j - 1
    if (j > 0) issue(j - 1 + S);  // into tile j - 1's ring slot
    const uint32_t xs = xs0 + j * X_TILE, ws = ring + (j % S) * W_TILE;
#pragma unroll
    for (int kk = 0; kk < WKT / 32; ++kk) {
      // depths [32 kk, 32 kk + 32) of the warp's 16 bytes: matrices of rows
      // 0-7, 8-15 (k step 2 kk), 16-23, 24-31 (k step 2 kk + 1)
      uint32_t bw[4];
      ldsm_x4_t(bw, ws + swz<128>((kk * 32 + mi8 * 8 + r8) * 128 + 16 * warp));
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ks = 2 * kk + q;
        uint32_t ax[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldsm_x4(ax[mi], xs + swz<128>((mi * 16 + (mi8 & 1) * 8 + r8) * 128 +
                                        (ks * 16 + (mi8 >> 1) * 8) * 2));
        const uint32_t lo = bw[2 * q] ^ 0x80808080u, hi = bw[2 * q + 1] ^ 0x80808080u;
        uint32_t bb[2][2];  // n8 tile p: weight columns 16 warp + 2 g' + p
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          bb[p][0] = widen2(lo, p);
          bb[p][1] = widen2(hi, p);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int p = 0; p < 2; ++p) mma_bf16(acc[mi][p], ax[mi], bb[p][0], bb[p][1]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // group q = 2 mi + hr: a lane holds rows 8 q + g, columns 16 warp + 4 t +
  // [0, 4) (the two n8 tiles interleaved)
  auto sums = [&](int q) {
    return make_float4(acc[q >> 1][0][2 * (q & 1)], acc[q >> 1][1][2 * (q & 1)],
                       acc[q >> 1][0][2 * (q & 1) + 1], acc[q >> 1][1][2 * (q & 1) + 1]);
  };
  const int col = n0 + 16 * warp + 4 * t;
  auto store = [&](int q, float4 v) {
    const int row = m0 + 8 * q + g;
    if (row < a.B && col < a.F) {
      const float* sc = a.scale + col;
      put4(a.out + (size_t)row * a.F + col,
           make_float4(v.x * sc[0], v.y * sc[1], v.z * sc[2], v.w * sc[3]));
    }
  };
  if (KS == 1) {
#pragma unroll
    for (int q = 0; q < GROUPS; ++q) store(q, sums(q));
    return;
  }
  // group q belongs to block q / GPB; its copy from block `rank` lands at
  // slot (rank, q % GPB) of the owner's receive area, a warp's 32 lanes in
  // a row
  const int GPB = GROUPS / KS;
  auto slot = [&](int src, int ql) { return ((src * GPB + ql) * WARPS + warp) * 32 + lane; };
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every peer has started
#pragma unroll
  for (int q = 0; q < GROUPS; ++q) st_cluster4(recv + 16 * slot(rank, q % GPB), q / GPB, sums(q));
  cluster_sync();  // every copy has landed; nothing reads or writes this block's after
  const float4* got = reinterpret_cast<const float4*>(base + (recv - xs0));
  for (int ql = 0; ql < GPB; ++ql) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < KS; ++src) {
      const float4 v = got[slot(src, ql)];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    store(rank * GPB + ql, sum);
  }
}

int smem_bytes(int tiles, int stages, int split) {
  return 1024 + tiles * X_TILE + stages * W_TILE + (split > 1 ? RECV : 0);
}

// 0 where `smem` bytes fit one block on the current card, else the error;
// checked before any call that would fail on it
int check_smem(int smem) {
  int device, limit;
  if (int err = (int)cudaGetDevice(&device)) return err;
  if (int err = (int)cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                            device))
    return err;
  return smem > limit ? (int)cudaErrorInvalidValue : 0;
}

cudaLaunchConfig_t config(const Params& p, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.F + WN - 1) / WN * p.split, (p.B + BM - 1) / BM, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;  // an unsplit launch is no cluster
  return cfg;
}

int launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_bytes(p.tiles, p.stages, p.split);
  if (int err = check_smem(smem)) return err;
  if (int err = (int)cudaFuncSetAttribute(
          w8a16_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(p, smem, stream, attr);
  if (int err = (int)cudaLaunchKernelEx(&cfg, w8a16_wide_kernel, p)) return err;
  return (int)cudaGetLastError();
}

Params params(const void* x, const void* w, const void* scale, void* out, int B, int D, int F,
              int split, int stages) {
  const int ntiles = (D + WKT - 1) / WKT;
  return Params{(const unsigned char*)x, (const unsigned char*)w, (const float*)scale,
                (float*)out, B, D, F, split, stages, (ntiles + split - 1) / split};
}

}  // namespace

// x (B, D) bf16, w (D, F) int8, scale (F,) f32 -> out (B, F) f32 under the
// plan (ops/int8_matmul.py `wide_plan`): D split over clusters of `split`
// (1, 2, 4 or 8) blocks, `stages` (2-8) weight tiles in the ring; x and w
// read 16 bytes at a time (bases and row pitches multiples of 16 bytes).
extern "C" int vqt_int8_matmul_wide(const void* x, const void* w, const void* scale, void* out,
                                    int B, int D, int F, int split, int stages, void* stream) {
  if (B < 1 || D < 1 || F < 1 || (split != 1 && split != 2 && split != 4 && split != 8) ||
      stages < 2 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || D % 8 || (uintptr_t)w % 16 || F % 16)
    return (int)cudaErrorMisalignedAddress;
  return launch(params(x, w, scale, out, B, D, F, split, stages), (cudaStream_t)stream);
}

// a plan's shared memory per block, the blocks that fit on one SM, and the
// clusters of its grid that can run at once on the current card
extern "C" int vqt_int8_matmul_wide_occupancy(int B, int D, int F, int split, int stages,
                                              int* smem, int* blocks_per_sm, int* clusters) {
  const Params p = params(nullptr, nullptr, nullptr, nullptr, B, D, F, split, stages);
  *smem = smem_bytes(p.tiles, p.stages, p.split);
  if (int err = check_smem(*smem)) return err;
  if (int err = (int)cudaFuncSetAttribute(
          w8a16_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem))
    return err;
  if (int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                                   w8a16_wide_kernel, THREADS,
                                                                   *smem))
    return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(p, *smem, nullptr, attr);
  cfg.numAttrs = 1;  // a cluster of 1 when unsplit
  return (int)cudaOccupancyMaxActiveClusters(clusters, w8a16_wide_kernel, &cfg);
}
