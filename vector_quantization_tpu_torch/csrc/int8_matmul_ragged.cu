// Weight-only INT8 matmul (W8A16) for Hopper where the weight's rows are
// not 16-byte aligned, the ragged design: out (B, F) f32 = (x (B, D) bf16 @
// w (D, F) int8 converted to bf16) * scale (F,) f32, with f32 accumulation
// and the per-output-channel scale applied to the f32 sum on the way out.
//
// Replaces the TPU kernel vector_quantization_tpu/ops/int8_matmul.py:43
// `_kernel` (under `_int8_matmul_pallas` :54, `pallas_call` :77) where the
// weight's rows are not 16-byte aligned (F % 16 != 0) and x has fewer rows
// than the tiled design takes: the decode lm head, (64, 1024, 17385) in
// Llama-medium C2I, once per decode step. The wrapper (ops/int8_matmul.py
// `plan`) launches it there; the wide design keeps the aligned decode
// shapes, the tiled design 2048 rows and more, and the split-K design of
// csrc/int8_matmul.cu what none of them takes (x's rows not 16-byte
// aligned).
//
// What bounds it on the H100: bytes. At B = 64 the product does 2 B = 128
// operations per weight byte, below the card's ~295 bf16 operations per
// byte of HBM: the floor is one read of the int8 weight (17.8 MB at the
// head: 5.3 us at 3.35 TB/s; 6.70 us with x, the scale and the f32
// output). What the design does about it:
// - one wave, one block an SM: a block owns 16 U output columns (U = 9:
//   144 columns, 121 blocks at the head; U = 8: 128) and 64 rows of x over
//   all of D, so no sum leaves the block: no memset, no atomics, and every
//   output is stored once. x is not held whole: 256-deep chunks of it come
//   by TMA into two buffers (32 KB each), the next one while the last is
//   read, with a block barrier at each chunk's start;
// - 16 warps in 4 warpgroups: warpgroup (cg, h) owns column group cg (units
//   0 .. U/2 - 1 or U - U/2 .. U - 1, 16 columns a unit; with U odd, the
//   middle unit's even columns go to group 0 and its odd columns to group
//   1) over the 64-deep stages j with j % 2 == h. Its warp ks streams rows
//   16 ks .. + 15 of each of them through a ring of `stages` slots of its
//   own, with no block barrier. The rows lie at any offset, so each comes in
//   as the aligned 16-byte words that cover the group's bytes (cp.async,
//   `stages` - 1 of the warp's stages ahead: ~48 KB of weight in flight an
//   SM at 3), then the warp shifts them into place (funnel shifts by the
//   row's offset, the same at every stage) in its aligned tile, whose
//   pitch, an odd number of 16-byte words, keeps ldmatrix free of bank
//   conflicts; a stage's shift is interleaved with the last one's widening;
// - the products run on wgmma (m64nNk16, bf16 -> f32, both operands in
//   shared memory), N = 72 (or 64) of the group's columns: A is x's tile as
//   TMA wrote it, B the warpgroup's weight rows widened once each
//   (ldmatrix .trans over the int8 tile seen as b16, then byte permutes
//   into 2^23 + (v + 128), an f32 subtract and a bf16 pack: exact) and
//   stored K-major with the 128-byte swizzle, every store of a warp on 32
//   banks. A stage's wgmmas run while the warps shift and read the next
//   stage's rows; they are waited on before its widened rows overwrite the
//   B tile;
// - each output's two partial sums (the two halves of the stages) meet in
//   shared memory: every warp writes its sums into its warpgroup's f32
//   image of the block's tile, each row shifted by the float offset of its
//   first output column past a 16-byte boundary (row pitch 16 U + 4 or +
//   20 floats, 4 modulo 32: the writes hit 32 banks at the head's F % 4 ==
//   1); then each thread adds the two images at one output 16-byte word,
//   scales it and stores it whole where it lies within the row's columns,
//   float by float at the row's two ends: one pass over the output at any
//   row pitch.
// x's base and rows must be 16-byte aligned (D % 8 == 0; TMA reads them); w
// may have any alignment and any F; any B >= 1 (B > 64: more row tiles,
// grid y).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                   // rows of x per block
constexpr int KT = 64;                   // depth of a stage
constexpr int WARPS = 16;                // 4 warpgroups (column group, half of the stages) x 4 warps
constexpr int THREADS = 32 * WARPS;
constexpr int WROWS = 16;                // weight rows of a warp's share of a stage
constexpr int MIN_STAGES = 3, MAX_STAGES = 8;
constexpr int X_TILE = BM * KT * 2;      // x's 64 x 64 bf16 tile: 128-byte rows, 128-byte swizzle
constexpr int X_CHUNK = 4;               // stages per x chunk
constexpr int X_BUF = X_CHUNK * X_TILE;  // 32 KB
constexpr int HEADER = 1024;             // x's mbarriers at 0 and 8; the stripe's scale at 256

template <int U>
struct Shape {
  static constexpr int N = 16 * U;                       // columns per block
  static constexpr int H = U / 2;                        // whole units per column group
  static constexpr int WU = H + (U & 1);                 // units a group's rows hold
  static constexpr int RAW = WROWS * 16 * (WU + 1);      // a warp's stage of covering words
  static constexpr int AP = 16 * (WU | 1);               // aligned row pitch: odd in 16-byte words
  static constexpr int ALIGNED = WROWS * AP;             // a warp's shifted rows
  static constexpr int NW = 16 * H + 8 * (U & 1);       // a warpgroup's columns: wgmma's N
  static constexpr int BT = NW * 128;                    // its B tile: NW rows of 64 bf16 depths
  static constexpr int ACC = NW / 2;                     // its sums a thread: 64 x NW / 128
  static constexpr int P = 16 * U + ((U & 1) ? 20 : 4);  // image pitch (floats), 4 mod 32
  static constexpr int EPI = 2 * BM * P * 4;             // the tile's two images (stage halves)
  static constexpr int WORDS = N / 4 + 1;                // output 16-byte words a row may touch
};

__host__ __device__ constexpr int smem_for(int work, int epi) {
  return 1024 + HEADER + (work > epi ? work : epi);  // 1024: the x buffers' alignment slack
}

template <int U>
__host__ __device__ constexpr int work_bytes(int stages) {
  return 2 * X_BUF + 4 * Shape<U>::BT + WARPS * (stages * Shape<U>::RAW + 2 * Shape<U>::ALIGNED);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// bytes p and p + 2 of u (int8 values with their sign bit flipped, so
// v + 128) -> a bf16 pair, byte p in the low half (csrc/int8_matmul_wide.cu's
// widening: exact for every int8)
__device__ __forceinline__ uint32_t widen2(uint32_t u, int p) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + p)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652 + p)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

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

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A wait that has not ended after ~2^34 cycles (seconds; a chunk takes
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

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// K-major operand descriptor of a tile of 128-byte rows (64 bf16 depths) as
// the 128-byte swizzle lays it out, 8-row groups 1024 bytes apart; + 2 per
// k16 step (32 bytes)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 rows x N columns, f32, N / 2 a thread) = a . b + (accumulate ? d : 0),
// a: x's 64 x 16 tile, b: the weight's N x 16 (K-major), both in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<72>(float (&d)[36], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35}, %36, %37, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// keeps the compiler from moving an accumulator across an asynchronous wgmma
template <int M>
__device__ __forceinline__ void fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

struct Params {
  const unsigned char* w;  // int8 (D, F), any alignment
  const float* scale;
  float* out;
  int B, D, F, stages;
};

template <int U>
__global__ void __launch_bounds__(THREADS, 1)
w8a16_ragged_kernel(const __grid_constant__ CUtensorMap tx, const Params a) {
  using Sh = Shape<U>;
  extern __shared__ unsigned char smem_rg[];
  unsigned char* const base =
      smem_rg + (((smem_u32(smem_rg) + 1023u) & ~1023u) - smem_u32(smem_rg));
  const int S = a.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, mi8 = lane >> 3, r8 = lane & 7;
  // warpgroup wg: column group cg, stages j with j % 2 == h; rows 16 ks .. of a stage
  const int wg = warp >> 2, cg = wg & 1, h = wg >> 1, ks = warp & 3;
  const int n0 = blockIdx.x * Sh::N, m0 = blockIdx.y * BM;
  const int nb = min(Sh::N, a.F - n0);      // the stripe's columns within F
  const int T = (a.D + KT - 1) / KT, chunks = (T + X_CHUNK - 1) / X_CHUNK;
  const uint32_t xbar = smem_u32(base), xbuf = xbar + HEADER;
  float* const scale_s = reinterpret_cast<float*>(base + 256);
  const int TL = max(0, (T - h + 1) / 2);  // this warpgroup's stages: j = 2 jl + h
  // the warpgroup's B tile; this warp's ring of covering words and its
  // shifted rows (two stages')
  const uint32_t btile = xbuf + 2 * X_BUF + wg * Sh::BT;
  const uint32_t ring = xbuf + 2 * X_BUF + 4 * Sh::BT + warp * (S * Sh::RAW + 2 * Sh::ALIGNED);
  const uint32_t aligned = ring + S * Sh::RAW;

  auto issue_x = [&](int c) {  // x's chunk c (its stages' tiles, at most 4) into buffer c % 2
    const int q_end = min(X_CHUNK, T - c * X_CHUNK);
    mbar_expect_tx(xbar + 8 * (c & 1), q_end * X_TILE);
    for (int q = 0; q < q_end; ++q)
      tma2d(xbuf + (c & 1) * X_BUF + q * X_TILE, &tx, xbar + 8 * (c & 1), (c * X_CHUNK + q) * KT, m0);
  };
  if (tid == 0) {
    mbar_init(xbar, 1);
    mbar_init(xbar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue_x(0);
    if (chunks > 1) issue_x(1);
  }
  for (int c = tid; c < nb; c += THREADS) scale_s[c] = a.scale[n0 + c];

  // the group's bytes of the stripe's rows: [cb, cb + 16 WU) of its 16 U,
  // those within nb. Row 16 ks + r of every stage starts `off` bytes into
  // its first aligned word, the same at every stage (64 F is a multiple of
  // 16), so each lane's copies and shifts are fixed once: copy task i (its
  // row, the word's slot, its source at stage 0) and shift task i (the
  // word's place in the ring and in the shifted rows, the shift)
  const int cb = 64 * cg, seg = max(0, min(16 * Sh::WU, nb - cb));
  constexpr int CP = (WROWS * (Sh::WU + 1) + 31) / 32, SH = (WROWS * Sh::WU + 31) / 32;
  const size_t stage_bytes = (size_t)KT * a.F;  // the weight's bytes a stage on
  auto row_off = [&](int r) {
    return (int)(((uintptr_t)a.w + (size_t)(16 * ks + r) * a.F + n0 + cb) & 15);
  };
  int cp_row[CP];
  uint32_t cp_dst[CP];
  const unsigned char* cp_src[CP];
#pragma unroll
  for (int i = 0; i < CP; ++i) {
    const int e = lane + 32 * i, r = e / (Sh::WU + 1), c = e - r * (Sh::WU + 1), off = row_off(r);
    // -1: no word (past the tasks, or holding no byte of the group's
    // segment: a word of a row past the segment's last byte, or every word
    // where the group has none, seg 0, whose first would lie past the row)
    cp_row[i] = e < WROWS * (Sh::WU + 1) && seg > 0 && 16 * c < off + seg ? 16 * ks + r : -1;
    cp_dst[i] = r * 16 * (Sh::WU + 1) + 16 * c;
    cp_src[i] = a.w + (size_t)(16 * ks + r) * a.F + n0 + cb - off + 16 * c;
  }
  uint32_t sh_src[SH], sh_dst[SH];
  int sh_shift[SH];
#pragma unroll
  for (int i = 0; i < SH; ++i) {
    const int e = lane + 32 * i, r = e / Sh::WU, c = e - r * Sh::WU, off = row_off(r);
    sh_src[i] = e < WROWS * Sh::WU ? r * 16 * (Sh::WU + 1) + 16 * c + (off & ~3) : 0xFFFFFFFFu;
    sh_dst[i] = r * Sh::AP + 16 * c;
    sh_shift[i] = 8 * (off & 3);
  }
  // the warpgroup's next stage to copy, in_jl (stage 2 in_jl + h, its first
  // row in_k, in_off bytes past stage 0): this warp's words of its rows into
  // ring slot in_slot (= in_jl % S); one call a stage, in order
  int in_jl = 0, in_slot = 0, in_k = h * KT;
  size_t in_off = (size_t)h * stage_bytes;
  auto issue = [&]() {
    if (in_jl < TL) {
      const uint32_t st = ring + in_slot * Sh::RAW;
#pragma unroll
      for (int i = 0; i < CP; ++i)
        if (cp_row[i] >= 0 && in_k + cp_row[i] < a.D) cp16(st + cp_dst[i], cp_src[i] + in_off);
    }
    commit();
    ++in_jl;
    in_slot = in_slot + 1 == S ? 0 : in_slot + 1;
    in_k += 2 * KT;
    in_off += 2 * stage_bytes;
  };
  // the warpgroup's next stage's rows shifted into place (its ring slot
  // sh_slot), in two halves so that the loads of one stage and the products
  // of another interleave: word c of row r is bytes [off + 16 c, off + 16 c +
  // 16) of its covering words
  uint32_t sh_w[SH][5];
  int sh_slot = 0;
  auto shift_load = [&]() {
    const uint32_t raw = ring + sh_slot * Sh::RAW;
#pragma unroll
    for (int i = 0; i < SH; ++i)
      if (sh_src[i] != 0xFFFFFFFFu)
#pragma unroll
        for (int q = 0; q < 5; ++q) sh_w[i][q] = lds32(raw + sh_src[i] + 4 * q);
    sh_slot = sh_slot + 1 == S ? 0 : sh_slot + 1;
  };
  auto shift_store = [&](int j) {
    const uint32_t dst = aligned + (j & 1) * Sh::ALIGNED;
#pragma unroll
    for (int i = 0; i < SH; ++i)
      if (sh_src[i] != 0xFFFFFFFFu) {
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = __funnelshift_r(sh_w[i][q], sh_w[i][q + 1], sh_shift[i]);
        sts128(dst + sh_dst[i], v);
      }
  };

  float acc[Sh::ACC];
#pragma unroll
  for (int i = 0; i < Sh::ACC; ++i) acc[i] = 0.f;
  // the group's whole units and middle unit within its rows: group 0 holds
  // units 0 .. WU - 1 (its middle one last), group 1 units 4 .. (its middle
  // one first)
  const int wl0 = (U & 1) && cg ? 1 : 0, mid_l = cg ? 0 : Sh::H;
  const int fu0 = cg ? U - Sh::H : 0;  // the group's first whole unit
  // where lane (g, t) puts its widened words in the B tile: whole unit i's n8
  // tile p is rows 16 i + 8 p + g (column 16 u + 2 g + p), the middle unit
  // rows 16 H + g (column 16 H + 2 g + cg); depths 16 ks + 8 m + 2 t, + 1 are
  // 4 bytes of 16-byte chunk 2 ks + m, which the swizzle XORs with g
  const uint32_t b_lane = g * 128 + 4 * t;
  auto b_at = [&](int group, int m) { return group * 1024 + (((2 * ks + m) ^ g) << 4); };

  for (int i = 0; i < S - 1; ++i) issue();
  wait_copies(S - 2);  // this lane's words of stage 0 landed
  __syncwarp();
  if (TL > 0) {
    shift_load();
    shift_store(0);
  }
  __syncthreads();  // x's mbarriers initialised, the scale in place
  int jl = 0;
  for (int c = 0; c < chunks; ++c) {  // x's chunk c: stages 4 c .. 4 c + 3
    if (c > 0) {
      wg_wait<0>();     // this warpgroup's products of chunk c - 1 are done
      fence_acc(acc);
      __syncthreads();  // every warp is past chunk c - 1: its buffer takes chunk c + 1
      if (tid == 0 && c + 1 < chunks) issue_x(c + 1);
    }
    mbar_wait(xbar + 8 * (c & 1), (c >> 1) & 1);
    for (int q = h; q < X_CHUNK && X_CHUNK * c + q < T; q += 2, ++jl) {
      issue();             // stage jl + S - 1 into stage jl - 1's slot, shifted last stage
      wait_copies(S - 2);  // this lane's words of stage jl + 1 landed
      __syncwarp();        // stage jl's rows in place, stage jl + 1's words landed
      if (jl + 1 < TL) shift_load();
      // this warp's 16 rows of stage jl: each unit's two 8-deep halves,
      // widened into the B tile (n8 tile p of a unit: its columns 2 g + p)
      const uint32_t wrow = aligned + (jl & 1) * Sh::ALIGNED + ((mi8 & 1) * 8 + r8) * Sh::AP;
      uint32_t bw[Sh::H / 2][4], bm[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < Sh::H; i += 2)  // matrices: unit i depths 0-7, 8-15, unit i + 1 alike
        ldsm_x4_t(bw[i / 2], wrow + 16 * (wl0 + i + (mi8 >> 1)));
      if constexpr ((U & 1) != 0) ldsm_x2_t(bm, wrow + 16 * mid_l);
      if (jl + 1 < TL) shift_store(jl + 1);
      wg_wait<0>();  // the last stage's products are done: the B tile is free
      fence_acc(acc);
      const uint32_t bt = btile + b_lane;
#pragma unroll
      for (int i = 0; i < Sh::H; i += 2)
#pragma unroll
        for (int qq = 0; qq < 2; ++qq)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const uint32_t u = bw[i / 2][2 * qq + m] ^ 0x80808080u;
#pragma unroll
            for (int p = 0; p < 2; ++p) sts32(bt + b_at(2 * (i + qq) + p, m), widen2(u, p));
          }
      if constexpr ((U & 1) != 0) {
#pragma unroll
        for (int m = 0; m < 2; ++m) sts32(bt + b_at(2 * Sh::H, m), widen2(bm[m] ^ 0x80808080u, cg));
      }
      fence_proxy_async();  // the B tile's stores, seen by wgmma
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the warpgroup's B tile is whole
      // the stage's products: x's tile by the B tile, 4 k16 steps, left to
      // run while the next stage's rows are widened
      const uint64_t xd = kmajor_desc(xbuf + (c & 1) * X_BUF + q * X_TILE);
      const uint64_t bd = kmajor_desc(btile);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<Sh::NW>(acc, xd + 2 * kk, bd + 2 * kk, jl > 0 || kk > 0);
      wg_commit();
    }
  }
  wg_wait<0>();
  fence_acc(acc);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // every warp past its last stage: x's buffers and the rings are free

  // this warp's sums into image h, row r shifted by a_r (its first
  // column's float offset past a 16-byte boundary of out): wgmma's lane (g,
  // t) of warp ks holds rows 16 ks + g and + 8, B rows 8 jj + 2 t and + 1,
  // which are columns 16 u + 4 t + [0, 4) of whole unit u (n8 tiles p = 0, 1
  // of unit i are jj = 2 i + p) and 16 H + 4 t + cg and + 2 of the middle one
  float* const image = reinterpret_cast<float*>(base + HEADER) + h * BM * Sh::P;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * ks + g + 8 * hh;
    const int ar = (int)((((uintptr_t)(a.out + (size_t)(m0 + r) * a.F + n0)) >> 2) & 3);
    float* const rw = image + r * Sh::P + ar;
#pragma unroll
    for (int i = 0; i < Sh::H; ++i) {
      const int c = 16 * (fu0 + i) + 4 * t;
      rw[c] = acc[8 * i + 2 * hh];
      rw[c + 1] = acc[8 * i + 4 + 2 * hh];
      rw[c + 2] = acc[8 * i + 2 * hh + 1];
      rw[c + 3] = acc[8 * i + 4 + 2 * hh + 1];
    }
    if constexpr ((U & 1) != 0) {
      const int c = 16 * Sh::H + 4 * t + cg;
      rw[c] = acc[8 * Sh::H + 2 * hh];
      rw[c + 2] = acc[8 * Sh::H + 2 * hh + 1];
    }
  }
  __syncthreads();
  // output word l of row r: the two images' floats [4 l, 4 l + 4), the row's columns
  // c0 = 4 l - a_r .. c0 + 3, a 16-byte aligned word of out
  const float* const images = reinterpret_cast<const float*>(base + HEADER);
  const int words = min(BM, a.B - m0) * Sh::WORDS;
  for (int e = tid; e < words; e += THREADS) {
    const int r = e / Sh::WORDS, l = e - r * Sh::WORDS;
    float* const dst = a.out + (size_t)(m0 + r) * a.F + n0;
    const int c0 = 4 * l - (int)(((uintptr_t)dst >> 2) & 3);
    if (c0 >= nb) continue;
    const float* const sc = scale_s + c0;
    const float4 s0 = *reinterpret_cast<const float4*>(images + r * Sh::P + 4 * l);
    const float4 s1 = *reinterpret_cast<const float4*>(images + (BM + r) * Sh::P + 4 * l);
    const float4 s = make_float4(s0.x + s1.x, s0.y + s1.y, s0.z + s1.z, s0.w + s1.w);
    if (c0 >= 0 && c0 + 4 <= nb) {
      *reinterpret_cast<float4*>(dst + c0) =
          make_float4(s.x * sc[0], s.y * sc[1], s.z * sc[2], s.w * sc[3]);
    } else {
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c0 + i >= 0 && c0 + i < nb) dst[c0 + i] = sv[i] * sc[i];
    }
  }
}

template <int U>
int smem_bytes(int stages) {
  return smem_for(work_bytes<U>(stages), Shape<U>::EPI);
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

// x (B, D) bf16 in boxes of 64 columns (128 bytes) x 64 rows, the 128-byte
// swizzle; reads outside it arrive as zeros
int map_x(CUtensorMap* map, const void* x, int B, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {KT, BM};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult err = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return err == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// 0 where `smem` bytes fit one block on the current card, else the error
int check_smem(int smem) {
  int device, limit;
  if (int err = (int)cudaGetDevice(&device)) return err;
  if (int err = (int)cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                            device))
    return err;
  return smem > limit ? (int)cudaErrorInvalidValue : 0;
}

template <int U>
int prepare(int stages, int* smem) {
  *smem = smem_bytes<U>(stages);
  if (int err = check_smem(*smem)) return err;
  return (int)cudaFuncSetAttribute(w8a16_ragged_kernel<U>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

template <int U>
int launch(const CUtensorMap& tx, const Params& p, cudaStream_t stream) {
  int smem;
  if (int err = prepare<U>(p.stages, &smem)) return err;
  const dim3 grid((p.F + 16 * U - 1) / (16 * U), (p.B + BM - 1) / BM, 1);
  w8a16_ragged_kernel<U><<<grid, THREADS, smem, stream>>>(tx, p);
  return (int)cudaGetLastError();
}

template <int U>
int occupancy(int stages, int* smem, int* blocks_per_sm) {
  if (int err = prepare<U>(stages, smem)) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, w8a16_ragged_kernel<U>,
                                                            THREADS, *smem);
}

}  // namespace

// x (B, D) bf16, w (D, F) int8, scale (F,) f32 -> out (B, F) f32 under the
// plan (ops/int8_matmul.py `ragged_plan`): `n` columns a block (128 or
// 144), `stages` slots in each warp's ring (3-8). x's base and rows must be
// 16-byte aligned (D % 8 == 0); w may have any alignment.
extern "C" int vqt_int8_matmul_ragged(const void* x, const void* w, const void* scale, void* out,
                                      int B, int D, int F, int n, int stages, void* stream) {
  if (B < 1 || D < 1 || F < 1 || (n != 128 && n != 144) || stages < MIN_STAGES ||
      stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || D % 8) return (int)cudaErrorMisalignedAddress;
  CUtensorMap tx;
  if (int err = map_x(&tx, x, B, D)) return err;
  const Params p = {(const unsigned char*)w, (const float*)scale, (float*)out, B, D, F, stages};
  return n == 128 ? launch<8>(tx, p, (cudaStream_t)stream) : launch<9>(tx, p, (cudaStream_t)stream);
}

// a plan's dynamic shared memory per block and the blocks that fit on one
// SM of the current card
extern "C" int vqt_int8_matmul_ragged_occupancy(int n, int stages, int* smem, int* blocks_per_sm) {
  if ((n != 128 && n != 144) || stages < MIN_STAGES || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  return n == 128 ? occupancy<8>(stages, smem, blocks_per_sm)
                  : occupancy<9>(stages, smem, blocks_per_sm);
}
