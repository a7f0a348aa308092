// Nearest-codebook lookup for Hopper, on the tensor cores: codes (N,) int32 =
//   argmin_k ( esq[k] - x[n] . e[k] ),  esq[k] = 0.5 * ||e[k]||^2,
// which has the argmin of ||x[n] - e[k]||^2. An exact tie goes to the lowest
// index. The N x K score matrix is never written.
//
// Replaces the TPU kernel vector_quantization_tpu/ops/vq_lookup.py:94
// `_nearest_codes_pallas` (kernel body `_nearest_kernel`): a running
// (min, argmin) over codebook tiles.
//
// What bounds it on the H100: operations. At the tokenizer's shape (N = K =
// 16384, D = 8) the inputs are 1.2 MB, read in 0.35 us, while x . e takes
// 2*N*K*D = 4.3 GFLOP a pass. On the f32 FMA pipes (67 TFLOP/s) the call
// could not take under 72 us; on the TF32 tensor cores (495 TFLOP/s) three
// passes take at least 26 us, and one compare per score 4 us.
//
// What the design does:
// - products on the tensor cores: wgmma m64n128k8 with TF32 operands and
//   f32 sums, one warpgroup per 64 rows, the A operand (-x) in registers and
//   the B operand (a 128-code tile of the codebook) in shared memory. An f32
//   operand v is split as hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi);
//   the score takes x_lo.e_hi + x_hi.e_lo + x_hi.e_hi (the dropped
//   x_lo.e_lo is ~2^-22 |x||e|). A bf16 operand is exact in TF32, so its lo
//   pass is skipped: 3 passes for f32 x f32, 2 for a mixed pair, 1 for bf16
//   x bf16. D is zero-padded to a multiple of 8;
// - the A operand is -x, so the accumulator holds -x . e; esq is added by
//   one more wgmma after the last k-step, its A operand 1 in three columns
//   and its B tile esq's three TF32 parts (hi + mid + lo = esq exactly), so
//   that the sums round at the size of x . e and the scores need no
//   instruction outside the tensor cores (on an H100 at D = 8, loading esq
//   into the accumulator first took 23 us more a call, adding it after the
//   products 34 us more);
// - a prologue launch writes esq and the codebook's hi/lo split as wgmma B
//   tiles (K-major 8 x 4 core matrices, no swizzle), one contiguous run per
//   (codebook tile, D-chunk), fills the row keys and zeroes the
//   per-row-tile counters (and, where x's tile does not fit in shared
//   memory, packs x's D-chunks the same way);
// - a block owns 128 rows (two warpgroups) and walks its run of 128-code
//   tiles (the codebook is split across blocks, grid.y, by the wrapper's
//   plan so that the grid fills the card). The tiles arrive by bulk copies
//   (cp.async.bulk) into a ring of 8 stages (4 at D > 8) behind mbarriers,
//   issued by a ninth warp as soon as the eight compute warps have left a
//   stage;
// - x stays resident: at D <= 8 each warp keeps its split fragments of -x
//   in registers for the whole loop, and two accumulators alternate, so
//   that a tile's products run on the tensor cores while the warp selects
//   on the tile before; elsewhere the block's x tile stays in shared memory
//   when it fits (D <= 256 in f32) and is split as it is read;
// - the argmin is taken on the accumulator fragments: a thread folds its 32
//   scores of a row with an fminf tree, the quad of lanes sharing the row
//   folds the four minima, and only where that beats the row's best does a
//   lane whose own minimum improves look for the lowest of its codes
//   holding it (a strict < across tiles, which come in ascending order). A
//   lane keeps its own (best, code); the quad's lanes meet at the end, the
//   blocks that split the codebook in one 64-bit atomicMin per row on a key
//   with the order-preserving bits of the score above the index (smaller
//   score first, then smaller index); the last block of a row tile to finish
//   turns the keys into codes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WGS = 2;                        // warpgroups per block
constexpr int WARPS = 4 * WGS;                // warps that compute; one more issues the copies
constexpr int THREADS = 32 * (WARPS + 1);
constexpr int BM = 64 * WGS;                  // 128 rows per block
constexpr int BN = 128;                       // codes per codebook tile: the wgmma's N
constexpr int B_TILE = BN * 8;                // floats of one k-step's B tile (hi, lo or esq)
constexpr int KC = 2;                         // k-steps of 8 dimensions per ring stage (D > 8)
constexpr int STAGES_REG = 8, STAGES = 4;     // ring stages at D <= 8 and above
constexpr int BAR_BYTES = 16 * STAGES_REG;    // the ring's mbarriers: full, then empty

template <typename T> constexpr bool is_f32 = sizeof(T) == 4;
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// the arrival of the thread that issues a stage's copies, with their bytes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A wait that has not ended after ~2^34 cycles (seconds; the copies take
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

// one arrival on `bar` (a compute warp is done with a stage)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// smaller float <-> smaller unsigned key (-0.0 folded into +0.0 first)
__device__ __forceinline__ unsigned long long make_key(float s, int idx) {
  if (idx < 0) return ~0ull;
  uint32_t u = __float_as_uint(s);
  if ((u & 0x7fffffffu) == 0) u = 0;
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | (uint32_t)idx;
}

// B operand descriptor of a B_TILE at p: K-major core matrices of 8 codes x
// 4 dimensions (128 bytes), the two dimension halves 128 bytes apart (LBO),
// successive 8-code groups 256 bytes apart (SBO), no swizzle
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3fff) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

#define ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
    "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (the warpgroup's 64 x 128 f32, 64 a thread) = a . b + (accumulate ? d : 0),
// a: this warp's 16 x 8 fragment of the A operand in registers, b: a B tile
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

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving an accumulator across an asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- shapes shared by the host and the kernels ----------------------------

// a row of `dims` elements of `size` bytes, padded to a pitch of 4 mod 8
// words: the 8 rows x 4 columns of an mma fragment then fall in 32 banks
__host__ __device__ inline int pitch(int dims, int size) {
  const int words = dims * size / 4;
  return (words + ((4 - words) % 8 + 8) % 8) * 4 / size;
}

struct Shape {
  int N, K, D, KS, kc, n_chunks, KSp, k_tiles, row_tiles, Kp, eblocks, xsize;
  bool reg;
};

// KS k-steps of 8 dimensions, walked kc at a time (1 at KS = 1, else 2);
// KSp = KS rounded up to whole chunks, the extra k-step all zeros
inline Shape make_shape(int N, int K, int D, int x_dtype, int e_dtype) {
  Shape s;
  s.N = N; s.K = K; s.D = D;
  s.KS = (D + 7) / 8;
  s.reg = s.KS == 1;
  s.kc = s.reg ? 1 : KC;
  s.n_chunks = (s.KS + s.kc - 1) / s.kc;
  s.KSp = s.n_chunks * s.kc;
  s.k_tiles = (K + BN - 1) / BN;
  s.row_tiles = (N + BM - 1) / BM;
  s.Kp = s.k_tiles * BN;
  s.eblocks = e_dtype == 0 ? 2 : 1;  // B tiles per k-step: hi (+ lo)
  s.xsize = x_dtype == 0 ? 4 : 2;
  return s;
}

inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// bytes of one stage's B tiles, and of one packed x chunk
inline int e_bytes(const Shape& s) { return s.kc * s.eblocks * B_TILE * 4; }
inline int xc_bytes(const Shape& s) { return BM * pitch(s.kc * 8, s.xsize) * s.xsize; }

// workspace: keys (N x 8) | counters (row tiles x 4) | esq (a B tile per
// codebook tile) | split
// codebook (k_tiles x n_chunks stages) | packed x (row_tiles x n_chunks
// chunks; only where x is not resident)
struct Workspace {
  size_t keys, counters, esq, eb, xw, bytes;
};

inline Workspace carve(const Shape& s, bool x_res) {
  Workspace w;
  w.keys = 0;
  w.counters = round16((size_t)s.N * 8);
  w.esq = w.counters + round16((size_t)s.row_tiles * 4);
  w.eb = w.esq + (size_t)s.k_tiles * B_TILE * 4;
  w.xw = w.eb + (size_t)s.k_tiles * s.n_chunks * e_bytes(s);
  w.bytes = w.xw + (x_res ? 0 : (size_t)s.row_tiles * s.n_chunks * xc_bytes(s));
  return w;
}

inline int stage_bytes(const Shape& s, bool x_res) {
  return e_bytes(s) + B_TILE * 4 + (x_res ? 0 : xc_bytes(s));
}

inline int smem_bytes(const Shape& s, bool x_res) {
  return BAR_BYTES + (s.reg ? STAGES_REG : STAGES) * stage_bytes(s, x_res) +
         (x_res && !s.reg ? BM * pitch(s.KSp * 8, s.xsize) * s.xsize : 0);
}

// ---- prologue ---------------------------------------------------------------

struct Prep {
  const void* x;
  const void* e;
  float* esq;
  float* eb;
  void* xw;
  unsigned long long* keys;
  int* counters;
  int N, K, D, KSp, kc, n_chunks, k_tiles, row_tiles, pack_x;
};

// A warp per 8-code n-tile writes its B tiles for every k-step (lane (g, t)
// of k-step ks holds e[8 nt + g][8 ks + t] and [.. + t + 4], split, at row g
// of the n-tile's two core matrices) and its part of the esq B tile; then
// keys, counters and, where asked, packed x.
template <typename TX, typename TE>
__global__ void prep_kernel(const Prep p) {
  constexpr int EBL = is_f32<TE> ? 2 : 1;
  const TE* e = static_cast<const TE*>(p.e);
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  const long long first_warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  for (long long nt = first_warp; nt < (long long)p.k_tiles * (BN / 8); nt += warps) {
    const int code = (int)nt * 8 + g;
    const int t = (int)nt / (BN / 8), i = (int)nt % (BN / 8);
    const bool row = code < p.K;
    float s = 0.f;
    for (int ks = 0; ks < p.KSp; ++ks) {
      const int d0 = ks * 8 + t4;
      const float v0 = row && d0 < p.D ? to_f32(e[(size_t)code * p.D + d0]) : 0.f;
      const float v1 = row && d0 + 4 < p.D ? to_f32(e[(size_t)code * p.D + d0 + 4]) : 0.f;
      s = fmaf(v1, v1, fmaf(v0, v0, s));
      const int c = ks / p.kc, kk = ks % p.kc;
      float* hi = p.eb + (((size_t)t * p.n_chunks + c) * p.kc + kk) * EBL * B_TILE + i * 64 + g * 4 + t4;
      if (is_f32<TE>) {
        uint32_t h0, l0, h1, l1;
        split(v0, h0, l0);
        split(v1, h1, l1);
        hi[0] = __uint_as_float(h0);
        hi[32] = __uint_as_float(h1);
        hi[B_TILE] = __uint_as_float(l0);
        hi[B_TILE + 32] = __uint_as_float(l1);
      } else {  // a widened bf16 is a TF32 value already
        hi[0] = v0;
        hi[32] = v1;
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    // esq as a B tile: dimensions 0, 1, 2 of code g hold its three TF32
    // parts (hi + mid + lo = esq exactly), the rest 0; +inf past K
    const float q = row ? 0.5f * s : __int_as_float(0x7f800000);
    uint32_t hi, mid, lo, rest;
    split(q, hi, rest);
    split(q - __uint_as_float(hi), mid, lo);
    const uint32_t part = t4 == 0 ? hi : t4 == 1 ? mid : t4 == 2 ? lo : 0u;
    float* qt = p.esq + (size_t)t * B_TILE + i * 64 + g * 4 + t4;
    qt[0] = row || t4 == 0 ? __uint_as_float(part) : 0.f;
    qt[32] = 0.f;
  }
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = first; n < p.N; n += stride) p.keys[n] = ~0ull;
  for (long long r = first; r < p.row_tiles; r += stride) p.counters[r] = 0;
  if (p.pack_x) {  // [row tile][chunk][BM rows][pitch], zero past N and D
    const TX* x = static_cast<const TX*>(p.x);
    TX* xw = static_cast<TX*>(p.xw);
    const int xp = pitch(p.kc * 8, sizeof(TX));
    const long long total = (long long)p.row_tiles * p.n_chunks * BM * xp;
    for (long long q = first; q < total; q += stride) {
      const int col = (int)(q % xp);
      const long long rest = q / xp;
      const int r = (int)(rest % BM), c = (int)(rest / BM % p.n_chunks);
      const int row = (int)(rest / BM / p.n_chunks) * BM + r, d = c * p.kc * 8 + col;
      xw[q] = row < p.N && col < p.kc * 8 && d < p.D ? x[(size_t)row * p.D + d] : TX(0.f);
    }
  }
}

// ---- main kernel ------------------------------------------------------------

struct Args {
  const void* x;
  const float* eb;
  const float* esq;
  const void* xw;
  unsigned long long* keys;
  int* counters;
  int32_t* codes;
  int N, D, KSp, n_chunks, k_tiles, tiles_per_split, x_res;
};

// x rows [row0, row0 + BM) x dims [0, dims) into shared memory rows of `p`
// elements, zero past N and D: 16-byte copies where rows allow them, else
// one element at a time through registers
template <typename TX>
__device__ __forceinline__ void load_x(TX* dst, int p, const TX* x, int N, int D, int row0,
                                       int dims) {
  constexpr int PER = 16 / sizeof(TX);
  if ((D * sizeof(TX)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int units = dims / PER;
    for (int i = threadIdx.x; i < BM * units; i += THREADS) {
      const int r = i / units, c = (i % units) * PER;
      const bool ok = row0 + r < N && c < D;
      cp_async16(dst + r * p + c, ok ? x + (size_t)(row0 + r) * D + c : x, ok);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < BM * dims; i += THREADS) {
      const int r = i / dims, c = i % dims;
      dst[r * p + c] = row0 + r < N && c < D ? x[(size_t)(row0 + r) * D + c] : TX(0.f);
    }
  }
}

// Each row's best so far: the quad's (rbest), and this lane's over its own
// codes (best, at code bidx). acc[4 j + 2 h + i] holds row h (g, g + 8) and
// code cbase + 8 j + i, ascending in (j, i). Each row's minimum over the
// lane's codes by an fminf tree and over the quad's by shuffles filters:
// only where the tile improves the row does a lane whose own minimum
// improves look for the lowest of its codes holding it.
__device__ __forceinline__ void select_tile(const float (&acc)[64], int cbase, float (&rbest)[2],
                                            float (&best)[2], int (&bidx)[2]) {
  float m[2], qm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = fminf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = fminf(v[i], v[i + 8]);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = fminf(v[i], v[i + 4]);
    m[h] = fminf(fminf(v[0], v[2]), fminf(v[1], v[3]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) qm[h] = fminf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
#pragma unroll
  for (int h = 0; h < 2; ++h) qm[h] = fminf(qm[h], __shfl_xor_sync(0xffffffffu, qm[h], 2));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qm[h] < rbest[h]) {  // the same for the 4 lanes of the quad
      rbest[h] = qm[h];
      if (m[h] < best[h]) {
        int idx = 0;
#pragma unroll
        for (int j = 15; j >= 0; --j) {
          if (acc[4 * j + 2 * h + 1] == m[h]) idx = cbase + 8 * j + 1;
          if (acc[4 * j + 2 * h] == m[h]) idx = cbase + 8 * j;
        }
        best[h] = m[h];
        bidx[h] = idx;
      }
    }
  }
}

template <typename TX, typename TE, bool REG>
__global__ void __launch_bounds__(THREADS, 1) nearest_tc_kernel(const Args a) {
  constexpr bool XLO = is_f32<TX>, ELO = is_f32<TE>;
  constexpr int EBL = ELO ? 2 : 1;                  // B tiles per k-step: hi (+ lo)
  constexpr int KCE = REG ? 1 : KC;                 // k-steps per chunk
  constexpr int ST = REG ? STAGES_REG : STAGES;     // ring stages
  constexpr int E_STAGE = KCE * EBL * B_TILE;       // floats of B tiles per stage
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;

  const TX* x = static_cast<const TX*>(a.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // this lane's rows: r0, r0 + 8
  const int row0 = blockIdx.x * BM;
  const int t_begin = blockIdx.y * a.tiles_per_split;
  const int t_end = min(a.k_tiles, t_begin + a.tiles_per_split);
  const int iters = (t_end - t_begin) * a.n_chunks;
  const bool x_res = REG || a.x_res;
  const int xc = x_res ? 0 : BM * pitch(KCE * 8, sizeof(TX)) * (int)sizeof(TX);
  const int xp = pitch(x_res ? a.KSp * 8 : KCE * 8, sizeof(TX));
  const int stage = (E_STAGE + B_TILE) * 4 + xc;
  const uint32_t full = smem_addr(smem), empty = full + 8 * ST;  // ST mbarriers each
  unsigned char* ring = smem + BAR_BYTES;
  TX* xs = reinterpret_cast<TX*>(ring + ST * stage);  // the resident x tile

  auto st_e = [&](int s) { return reinterpret_cast<float*>(ring + s * stage); };
  auto st_q = [&](int s) { return st_e(s) + E_STAGE; };
  auto st_x = [&](int s) { return reinterpret_cast<TX*>(st_q(s) + B_TILE); };

  // iteration j = (tile, chunk) into stage j % ST: the chunk's B tiles, the
  // tile's esq with its last chunk, x's chunk where x is not resident; the
  // copy warp's lane 0 issues it
  auto issue = [&](int j) {
    const int s = j % ST, t = t_begin + j / a.n_chunks, c = j % a.n_chunks;
    const bool last = c == a.n_chunks - 1;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, E_STAGE * 4 + (last ? B_TILE * 4 : 0) + xc);
    bulk_copy(st_e(s), a.eb + ((size_t)t * a.n_chunks + c) * E_STAGE, E_STAGE * 4, bar);
    if (last) bulk_copy(st_q(s), a.esq + (size_t)t * B_TILE, B_TILE * 4, bar);
    if (!x_res)
      bulk_copy(st_x(s), static_cast<const unsigned char*>(a.xw) + ((size_t)blockIdx.x * a.n_chunks + c) * xc,
                xc, bar);
  };

  // -x's fragment of a k-step: rows r0, r0 + 8 at columns t4 and t4 + 4
  uint32_t ahi[4], alo[4];
  auto frag_x = [&](auto get) {
    const float v[4] = {-get(r0, 0), -get(r0 + 8, 0), -get(r0, 4), -get(r0 + 8, 4)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (XLO) split(v[q], ahi[q], alo[q]);
      else ahi[q] = __float_as_uint(v[q]);
    }
  };
  // A operand of the esq pass: columns 0, 1, 2 of every row are 1, so that
  // the pass adds the esq tile's three parts to every row's scores
  const uint32_t ones[4] = {t4 < 3 ? 0x3f800000u : 0u, t4 < 3 ? 0x3f800000u : 0u, 0u, 0u};
  // the passes of one k-step whose B tiles start at b: small products first
  auto products = [&](float (&acc)[64], const float* b, int accumulate) {
    if (XLO) {
      wgmma_tf32(acc, alo, b_desc(b), accumulate);
      if (ELO) wgmma_tf32(acc, ahi, b_desc(b + B_TILE), 1);
      wgmma_tf32(acc, ahi, b_desc(b), 1);
    } else if (ELO) {
      wgmma_tf32(acc, ahi, b_desc(b + B_TILE), accumulate);
      wgmma_tf32(acc, ahi, b_desc(b), 1);
    } else {
      wgmma_tf32(acc, ahi, b_desc(b), accumulate);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (REG) {  // one k-step: the fragments come from device memory, once
    if (warp < WARPS)
      frag_x([&](int r, int dd) {
        const int row = row0 + r, d = t4 + dd;
        return row < a.N && d < a.D ? to_f32(x[(size_t)row * a.D + d]) : 0.f;
      });
  } else if (x_res) {
    load_x(xs, xp, x, a.N, a.D, row0, a.KSp * 8);
  }
  __syncthreads();

  float rbest[2], best[2];
  int bidx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rbest[h] = best[h] = __int_as_float(0x7f800000);
    bidx[h] = -1;
  }

  if (warp == WARPS) {  // the copy warp: a stage is refilled once every compute warp left it
    if (lane == 0)
      for (int j = 0; j < iters; ++j) {
        if (j >= ST) mbar_wait(empty + 8 * (j % ST), (j / ST - 1) & 1);
        issue(j);
      }
  } else if (REG) {
    // two accumulators alternate: tile j's products are in flight while the
    // warp selects on tile j - 1
    float acc0[64], acc1[64];
    auto begin = [&](float (&acc)[64], int j) {  // the tile's products, then esq
      const int s = j % ST;
      mbar_wait(full + 8 * s, (j / ST) & 1);
      fence_acc(acc);
      wg_fence();
      products(acc, st_e(s), 0);
      wgmma_tf32(acc, ones, b_desc(st_q(s)), 1);
      wg_commit();
      fence_acc(acc);
    };
    auto finish = [&](float (&acc)[64], int j) {  // after the scores have landed
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + 8 * (j % ST));
      select_tile(acc, (t_begin + j) * BN + 2 * t4, rbest, best, bidx);
    };
    int j = 0;
    if (iters > 0) begin(acc0, 0);
    for (; j + 1 < iters; j += 2) {
      begin(acc1, j + 1);
      wg_wait<1>();
      finish(acc0, j);
      if (j + 2 < iters) {
        begin(acc0, j + 2);
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      finish(acc1, j + 1);
    }
    if (j < iters) {
      wg_wait<0>();
      finish(acc0, j);
    }
  } else {
    float acc[64];
    int t = t_begin, c = 0;
    for (int j = 0; j < iters; ++j) {
      const int s = j % ST;
      mbar_wait(full + 8 * s, (j / ST) & 1);
      const TX* xb = x_res ? xs + c * KCE * 8 : st_x(s);
#pragma unroll
      for (int ks = 0; ks < KCE; ++ks) {
        frag_x([&](int r, int dd) { return to_f32(xb[r * xp + ks * 8 + t4 + dd]); });
        fence_acc(acc);
        wg_fence();
        products(acc, st_e(s) + ks * EBL * B_TILE, c > 0 || ks > 0);
        wg_commit();
        wg_wait<0>();  // the A registers change at the next k-step
        fence_acc(acc);
      }
      const bool last = c == a.n_chunks - 1;
      if (last) {
        wg_fence();
        wgmma_tf32(acc, ones, b_desc(st_q(s)), 1);
        wg_commit();
        wg_wait<0>();
        fence_acc(acc);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (last) select_tile(acc, t * BN + 2 * t4, rbest, best, bidx);
      if (++c == a.n_chunks) { c = 0; ++t; }
    }
  }

  // the quad's lanes meet in registers, the blocks splitting the codebook in
  // the row's key
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned long long key = make_key(best[h], bidx[h]);
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
      key = other < key ? other : key;
    }
    const int row = row0 + r0 + 8 * h;
    if (t4 == 0 && warp < WARPS && row < a.N && key != ~0ull) atomicMin(&a.keys[row], key);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&a.counters[blockIdx.x], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (s_last) {  // every split of this row tile has met in the keys
    __threadfence();
    for (int i = threadIdx.x; i < BM && row0 + i < a.N; i += THREADS)
      a.codes[row0 + i] = (int32_t)(uint32_t)(__ldcg(&a.keys[row0 + i]) & 0xffffffffull);
  }
}

template <typename TX, typename TE, bool REG>
int set_smem(int smem) {
  if (int err = (int)cudaFuncSetAttribute(nearest_tc_kernel<TX, TE, REG>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return err;
  // shared memory before L1, so that the ring fits
  return (int)cudaFuncSetAttribute(nearest_tc_kernel<TX, TE, REG>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
}

template <typename TX, typename TE, bool REG>
int run(const Args& args, const Shape& s, bool x_res, int splits, cudaStream_t stream) {
  const int smem = smem_bytes(s, x_res);
  if (int err = set_smem<TX, TE, REG>(smem)) return err;
  nearest_tc_kernel<TX, TE, REG><<<dim3(s.row_tiles, splits), THREADS, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename TX, typename TE>
int launch(const Shape& s, const void* x, const void* e, unsigned char* ws, void* codes,
           int tiles_per_split, bool x_res, cudaStream_t stream) {
  const Workspace w = carve(s, x_res);
  const int splits = (s.k_tiles + tiles_per_split - 1) / tiles_per_split;
  const Prep p{x, e, reinterpret_cast<float*>(ws + w.esq), reinterpret_cast<float*>(ws + w.eb),
               ws + w.xw, reinterpret_cast<unsigned long long*>(ws + w.keys),
               reinterpret_cast<int*>(ws + w.counters), s.N, s.K, s.D, s.KSp, s.kc, s.n_chunks,
               s.k_tiles, s.row_tiles, x_res ? 0 : 1};
  // a warp per n-tile of the codebook, at least a thread per row for the keys
  const long long threads = (long long)s.Kp / 8 * 32 > s.N ? (long long)s.Kp / 8 * 32 : s.N;
  const int prep_blocks = (int)((threads + 255) / 256 < 2048 ? (threads + 255) / 256 : 2048);
  // the same carveout as the lookup's, so that the card does not switch
  // between the two launches
  if (int err = (int)cudaFuncSetAttribute(prep_kernel<TX, TE>,
                                          cudaFuncAttributePreferredSharedMemoryCarveout,
                                          (int)cudaSharedmemCarveoutMaxShared))
    return err;
  prep_kernel<TX, TE><<<prep_blocks, 256, 0, stream>>>(p);
  if (int err = (int)cudaGetLastError()) return err;

  const Args args{x, p.eb, p.esq, p.xw, p.keys, p.counters, (int32_t*)codes, s.N, s.D, s.KSp,
                  s.n_chunks, s.k_tiles, tiles_per_split, x_res ? 1 : 0};
  return s.reg ? run<TX, TE, true>(args, s, true, splits, stream)
               : run<TX, TE, false>(args, s, x_res, splits, stream);
}

template <typename TX, typename TE>
int occupancy(bool reg, int smem, int* blocks) {
  if (reg) {
    if (int err = set_smem<TX, TE, true>(smem)) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, nearest_tc_kernel<TX, TE, true>,
                                                              THREADS, smem);
  }
  if (int err = set_smem<TX, TE, false>(smem)) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, nearest_tc_kernel<TX, TE, false>,
                                                            THREADS, smem);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. `workspace` holds `workspace_bytes`
// (at least what the shape needs: keys, counters, esq, the split codebook
// and, where x is not resident, packed x); `tiles_per_split` codebook tiles
// of 128 codes per block; `x_resident`: the block's x tile stays in shared
// memory (always at D <= 8, where x is held in registers).
extern "C" int vqt_nearest_codes(const void* x, int x_dtype, const void* e, int e_dtype,
                                 void* workspace, long long workspace_bytes, void* codes,
                                 int N, int K, int D, int tiles_per_split, int x_resident,
                                 void* stream) {
  if (N < 1 || K < 1 || D < 1 || tiles_per_split < 1 || x_dtype < 0 || x_dtype > 1 ||
      e_dtype < 0 || e_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(N, K, D, x_dtype, e_dtype);
  const bool xr = x_resident != 0 || s.reg;
  if ((long long)carve(s, xr).bytes > workspace_bytes) return (int)cudaErrorInvalidValue;
  unsigned char* ws = (unsigned char*)workspace;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 0 && e_dtype == 0) return launch<float, float>(s, x, e, ws, codes, tiles_per_split, xr, st);
  if (x_dtype == 0) return launch<float, __nv_bfloat16>(s, x, e, ws, codes, tiles_per_split, xr, st);
  if (e_dtype == 0) return launch<__nv_bfloat16, float>(s, x, e, ws, codes, tiles_per_split, xr, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(s, x, e, ws, codes, tiles_per_split, xr, st);
}

// resident blocks per SM of the lookup kernel for these types, variant
// (`reg`: D <= 8) and dynamic shared memory, into *blocks
extern "C" int vqt_nearest_blocks_per_sm(int x_dtype, int e_dtype, int reg, int smem, int* blocks) {
  if (x_dtype == 0 && e_dtype == 0) return occupancy<float, float>(reg != 0, smem, blocks);
  if (x_dtype == 0) return occupancy<float, __nv_bfloat16>(reg != 0, smem, blocks);
  if (e_dtype == 0) return occupancy<__nv_bfloat16, float>(reg != 0, smem, blocks);
  return occupancy<__nv_bfloat16, __nv_bfloat16>(reg != 0, smem, blocks);
}
