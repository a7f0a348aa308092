// Weight-only INT8 matmul (W8A16) for Hopper at many rows, the tiled
// design: out (B, F) f32 = (x (B, D) bf16 @ w (D, F) int8 converted to bf16)
// * scale (F,) f32, with f32 accumulation and the per-output-channel scale
// applied to the f32 sum on the way out.
//
// Replaces the TPU kernel vector_quantization_tpu/ops/int8_matmul.py:54
// `_int8_matmul_pallas` (kernel body `_kernel`) where x has many rows: the
// prefill of `generate` (64 rows x 129 positions = 8256 rows through every
// projection and the head of an INT8 Llama) and the INT8 cache-free
// forward. The wrapper (ops/int8_matmul.py `plan`) launches it at B >=
// `TILED_MIN_ROWS` and keeps the wide and split-K designs below.
//
// What bounds it on the H100: operations. Each weight byte meets B rows, so
// the product does about 2 B operations per weight byte (16,512 at B =
// 8256), far above the card's ~295 bf16 operations per byte of HBM. The
// floor is 2 B D F operations at 989 TFLOP/s (48 us at (8256, 1024, 2816),
// 297 us at the head's 17385 columns); the f32 output, written once, is
// the largest stream of bytes (4 B F: 574 MB at the head, 171 us of HBM).
// What the design does about it:
// - the products run on wgmma (m64n256k16, bf16 -> f32) with the product
//   swapped: out^T = w^T x^T, so the weight, widened to bf16 in registers,
//   is wgmma's register-sourced A operand and x's tile its shared-memory B
//   operand (as CUTLASS's mixed-input GEMMs do). The other way, the widened
//   weight would be written to shared memory as a bf16 B tile and read back
//   by both warpgroups: three passes of shared memory per weight byte where
//   this takes one ldmatrix;
// - a tile is 128 output columns x 256 rows of x over all of D (no split of
//   D: no atomics, no memset). Two consumer warpgroups own 64 columns each
//   and share the x tile; each weight element is widened once per tile, by
//   the one warp that owns its column, with byte permutes (int8 v -> the
//   float 2^23 + v + 128 -> minus 2^23 + 128 -> its high half, exactly v in
//   bf16). Each warp's 16 columns are one 16-byte ldmatrix .trans column of
//   the int8 tile; A row g of the warp is column 2 g, row g + 8 column
//   2 g + 1;
// - x's 256 x 64 tiles arrive by TMA (128-byte swizzle) into a ring of 4
//   stages behind mbarriers; the weight's 64 x 128 int8 tiles by TMA too
//   where its rows are 16-byte aligned (F % 16 == 0). Elsewhere (the head's
//   F = 17385) each of the 128 producer threads copies the aligned 16-byte
//   words that cover its half of a row's 128 bytes (cp.async, at most 5)
//   and, two stages later, shifts them into place (funnel shifts by the
//   row's offset) and stores the aligned half row: no load is narrower than
//   16 bytes;
// - the grid is persistent: one block per SM walks the tiles (columns
//   fastest, so the blocks at work share x's rows in L2), and the producer
//   warpgroup (its registers given to the consumers by setmaxnreg: 168 ->
//   232 and 40) fills the next tile's stages while the consumers store;
// - one stage's wgmmas are queued behind the last stage's, and the next
//   stage's A fragments are read and widened while they run (two fragment
//   register sets);
// - the epilogue stores from registers: a lane swaps half of its sums with
//   lane g ^ 1 (one shuffle a pair) to hold 4 columns of one row, scales
//   them and stores them as one 16-byte word where the rows are 16-byte
//   aligned (F % 4 == 0). At the head's F = 17385 a row's 16 columns start
//   `off` floats past a 16-byte boundary: each lane stores the aligned word
//   that ends `off` columns into its 4, taking the columns before from the
//   lane 8 below (the row's previous 4), and single floats only at the
//   row's two ends. Rows past B and columns past F are masked. Every
//   block's tile ends at about the same time, so the stores meet at the
//   card's write rate (53 of 171 us at the prefill's gate+up on an H100:
//   int8_matmul_probe.py --cuts); holding a tile's sums while the next one
//   runs, in a second register set on 128-row tiles or in a shared-memory
//   image drained by two warps on 192-row tiles, measured slower (PERF.md).
// Any B, D, F >= 1 is taken; x is read by TMA, so its base and row pitch
// (`ldx` elements) must be 16-byte aligned (the wrapper copies x into a
// padded buffer where they are not).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TN = 128;                       // output columns per tile: 64 a warpgroup
constexpr int TM = 256;                       // rows of x per tile: wgmma's N
constexpr int TK = 64;                        // depth per stage: a 128-byte row of x
constexpr int CONSUMERS = 256;                // two warpgroups (warps 0-7)
constexpr int PRODUCERS = 128;                // a warpgroup: TMA from one thread, the
constexpr int ROW_THREADS = PRODUCERS;        // unaligned weight's rows from all (half a row each)
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int STAGES = 4;                     // ring depth: more than the producers' lag of 2
constexpr int X_STAGE = TM * TK * 2;          // 32768: x's tile, 128-byte swizzle
constexpr int W_STAGE = TK * TN;              // 8192: the weight's int8 tile, swizzled alike
constexpr int RAW_PITCH = 144;                // 9 aligned words cover 128 bytes at any offset
constexpr int RAW_STAGE = TK * RAW_PITCH;     // 9216: the covering words of an unaligned tile
constexpr int STAGE = X_STAGE + W_STAGE + RAW_STAGE;  // 49 KB, so every slot stays 1024-aligned
constexpr int HEADER = 1024;                  // mbarriers: full[s] at 8 s, empty[s] at 64 + 8 s
constexpr int GROUPS = TM / 8;                // 8-row groups of a tile's sums
constexpr int ACC = TM / 2;                   // a consumer thread's sums: 64 columns x TM rows / 128

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// bytes p and p + 2 of u (int8 values with their sign bit flipped, so
// v + 128) -> a bf16 pair, byte p in the low half. 0x4B0000uu is the float
// 2^23 + uu, exact; minus 2^23 + 128 it is v, whose float has no bits below
// its top 8, so its high half is v in bf16, exactly: one byte permute packs
// the pair (csrc/int8_matmul_wide.cu's widening).
__device__ __forceinline__ uint32_t widen2(uint32_t u, int p) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + p)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652 + p)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
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

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// B operand descriptor of x's 256 x 64 tile at `addr` (K-major rows of 128
// bytes as TMA writes them with the 128-byte swizzle; 8-row groups 1024
// bytes apart); + 2 per k step of 16 (32 bytes)
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

#define ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
    "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (the warpgroup's 64 columns x 256 rows of x, f32, 128 a thread) =
// a . b + (accumulate ? d : 0); a: the warp's 16 x 16 fragment of the
// widened weight in registers, b: x's tile
__device__ __forceinline__ void wgmma_256(float (&d)[ACC], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, "
      "{%128,%129,%130,%131}, %132, p, 1, 1, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56),
        ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// keeps the compiler from moving an accumulator across an asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps an A fragment's registers live (not reused) until its wgmmas are done
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

struct Params {
  const unsigned char* w;  // read by the producer threads where TMA cannot
  const float* scale;
  float* out;
  int B, D, F, w_tma, out_aligned, tiles_n, tiles;
};

// a weight row that a producer thread copied and has yet to put in place
struct Pending {
  int s, off, nb;  // stage (-1: none), the row's offset in its first word, its bytes
};

// half `half` (bytes [64 half, 64 half + 64)) of row `row` of stage s's
// weight tile from its covering words: output word m is bytes [4 m, 4 m + 4)
// of the row, which start at byte off + 4 m of the copied words; bytes past
// nb are zeros. Then the stage has this thread's half row.
__device__ __forceinline__ void realign(uint32_t stage, const Pending& q, int row, int half,
                                        uint32_t full) {
  const uint32_t raw = stage + X_STAGE + W_STAGE + row * RAW_PITCH;
  const uint32_t dst = stage + X_STAGE + row * 128;
  const int shift = 8 * (q.off & 3);
  const uint32_t words = raw + 4 * (q.off >> 2) + 64 * half;
  uint32_t prev = lds32(words);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 4 * c + e;
      const uint32_t next = lds32(words + 4 * (m + 1));
      const uint32_t u = __funnelshift_r(prev, next, shift);
      prev = next;
      const int left = q.nb - 64 * half - 4 * m;
      v[e] = left >= 4 ? u : left <= 0 ? 0u : u & ((1u << (8 * left)) - 1u);
    }
    sts128(dst + (((4 * half + c) ^ (row & 7)) << 4), v);
  }
  mbar_arrive(full + 8 * q.s);
}

// where a finished tile's sums go: its rows, the 4 columns this lane stores
// and their scales
struct Out {
  int m0, col;  // col: the first of the lane's 4 columns (past F: none stored)
  float4 sc;
};

// 8-row group G of a finished tile: lanes g and g ^ 1 swap halves so that
// each holds 4 columns of one row (even g: row 2 t of the group, columns
// 2 g .. 2 g + 3 of the warp's 16; odd g: row 2 t + 1, columns 2 g - 2 ..
// 2 g + 1), and scales them. Where the rows are 16-byte aligned they go out
// as one 16-byte word. Elsewhere a row's 16 columns start `off` floats past
// a 16-byte boundary: each lane takes the aligned word that ends `off`
// columns into its 4 (the columns before come from the lane 8 below, which
// holds the row's previous 4) and stores it whole where it lies within the
// warp's columns and F; the first lane of the row stores the part of its
// word that is the warp's, the last one also its last `off` columns.
template <int G>
__device__ __forceinline__ void store_group(const Params& p, const float (&d)[ACC], const Out& o,
                                            int g, int t4) {
  const bool even = (g & 1) == 0;
  const float x0 = d[4 * G], x1 = d[4 * G + 1], x2 = d[4 * G + 2], x3 = d[4 * G + 3];
  const float r0 = __shfl_xor_sync(0xffffffffu, even ? x1 : x0, 4);
  const float r1 = __shfl_xor_sync(0xffffffffu, even ? x3 : x2, 4);
  const int row = o.m0 + 8 * G + 2 * t4 + (even ? 0 : 1);
  const float4 v = even ? make_float4(x0, x2, r0, r1) : make_float4(r0, r1, x1, x3);
  const float4 y = make_float4(v.x * o.sc.x, v.y * o.sc.y, v.z * o.sc.z, v.w * o.sc.w);
  if (p.out_aligned) {
    if (row < p.B && o.col < p.F)
      *reinterpret_cast<float4*>(p.out + (size_t)row * p.F + o.col) = y;
    return;
  }
  const float py = __shfl_up_sync(0xffffffffu, y.y, 8);
  const float pz = __shfl_up_sync(0xffffffffu, y.z, 8);
  const float pw = __shfl_up_sync(0xffffffffu, y.w, 8);
  if (row >= p.B) return;
  const int q = g >> 1, cw = o.col - 4 * q;  // the warp's first column
  float* const base = p.out + (size_t)row * p.F + cw;
  const int off = (int)(((uintptr_t)base >> 2) & 3), c = 4 * q - off;
  const float w0 = off == 0 ? y.x : off == 1 ? pw : off == 2 ? pz : py;
  const float w1 = off == 0 ? y.y : off == 1 ? y.x : off == 2 ? pw : pz;
  const float w2 = off == 0 ? y.z : off == 1 ? y.y : off == 2 ? y.x : pw;
  const float w3 = off == 0 ? y.w : off == 1 ? y.z : off == 2 ? y.y : y.x;
  if (c >= 0 && cw + c + 3 < p.F) {
    *reinterpret_cast<float4*>(base + c) = make_float4(w0, w1, w2, w3);
  } else {
    if (c >= 0 && cw + c < p.F) base[c] = w0;
    if (c + 1 >= 0 && cw + c + 1 < p.F) base[c + 1] = w1;
    if (c + 2 >= 0 && cw + c + 2 < p.F) base[c + 2] = w2;
    if (cw + c + 3 < p.F) base[c + 3] = w3;
  }
  if (q == 3 && off > 0) {  // the row's last `off` columns: this lane's last
    if (off == 3 && cw + 13 < p.F) base[13] = y.y;
    if (off >= 2 && cw + 14 < p.F) base[14] = y.z;
    if (cw + 15 < p.F) base[15] = y.w;
  }
}

template <int G = 0>
__device__ __forceinline__ void store_tile(const Params& p, const float (&d)[ACC], const Out& o,
                                           int g, int t4) {
  store_group<G>(p, d, o, g, t4);
  if constexpr (G + 1 < GROUPS) store_tile<G + 1>(p, d, o, g, t4);
}

// ---- consumers: warpgroup wg owns columns [64 wg, 64 wg + 64) of the
// tile, warp w of it [64 wg + 16 w, + 16): A row g is column 16 w + 2 g,
// row g + 8 column 16 w + 2 g + 1
__device__ __forceinline__ void consume(const Params& p, uint32_t ring, uint32_t full,
                                        uint32_t empty, int tid) {
  const int warp = tid >> 5, lane = tid & 31, nk = (p.D + TK - 1) / TK;
  const int wg = tid >> 7, w = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int chunk = 4 * wg + w;  // the warp's 16-byte column of the weight tile
  int s = 0;
  uint32_t ph = 0;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  uint32_t a0[4][4], a1[4][4];

  // stage st's A fragments, k steps 0-3: ldmatrix .trans of the int8 tile
  // seen as b16 (matrix m: depths 8 m .. 8 m + 7 of a 32-deep half), lane
  // (g, t) then holds depths 2 t, 2 t + 1 of columns 2 g, 2 g + 1
  auto load_a = [&](uint32_t (&a)[4][4], int st) {
    const uint32_t ws = ring + st * STAGE + X_STAGE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t bw[4];
      ldsm_x4_t(bw, ws + (32 * h + (lane >> 3) * 8 + (lane & 7)) * 128 +
                        ((chunk ^ (lane & 7)) << 4));
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t lo = bw[2 * q] ^ 0x80808080u, hi = bw[2 * q + 1] ^ 0x80808080u;
        a[2 * h + q][0] = widen2(lo, 0);
        a[2 * h + q][1] = widen2(lo, 1);
        a[2 * h + q][2] = widen2(hi, 0);
        a[2 * h + q][3] = widen2(hi, 1);
      }
    }
  };
  // this warp is done with stage st (its ldmatrix reads returned before
  // the fragments were widened; the wgmmas that read x's tile are done)
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };
  // stage s's four k steps on the fragments `frag`, queued behind the last
  // stage's; once those are done, the last stage is released and `nxt`
  // (its fragments) takes the next stage's while these run
  int last = -1;
  auto step = [&](uint32_t (&frag)[4][4], uint32_t (&nxt)[4][4], int kb) {
    wg_fence();
    const uint64_t desc = x_desc(ring + s * STAGE);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_256(acc, frag[kk], desc + 2 * kk, kb > 0 || kk > 0);
    wg_commit();
    wg_wait<1>();
    fence_frag(nxt);
    if (last >= 0) release(last);
    last = s;
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
    if (kb + 1 < nk) {
      mbar_wait(full + 8 * s, ph);
      load_a(nxt, s);
    }
  };

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    mbar_wait(full + 8 * s, ph);
    load_a(a0, s);
    for (int kb = 0; kb < nk; kb += 2) {
      step(a0, a1, kb);
      if (kb + 1 < nk) step(a1, a0, kb + 1);
    }
    wg_wait<0>();
    fence_acc(acc);
    fence_frag(a0);
    fence_frag(a1);
    release(last);
    last = -1;
    // the tile's sums, scaled, one 8-row group after another
    Out o;
    o.m0 = (t / p.tiles_n) * TM;
    o.col = (t % p.tiles_n) * TN + 64 * wg + 16 * w + 4 * (g >> 1);
    o.sc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.out_aligned && o.col < p.F) {
      o.sc = *reinterpret_cast<const float4*>(p.scale + o.col);
    } else {
      if (o.col < p.F) o.sc.x = p.scale[o.col];
      if (o.col + 1 < p.F) o.sc.y = p.scale[o.col + 1];
      if (o.col + 2 < p.F) o.sc.z = p.scale[o.col + 2];
      if (o.col + 3 < p.F) o.sc.w = p.scale[o.col + 3];
    }
    store_tile(p, acc, o, g, t4);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
w8a16_tiled_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const Params p) {
  extern __shared__ unsigned char smem_tiled[];
  const uint32_t base = (smem_u32(smem_tiled) + 1023u) & ~1023u;
  const uint32_t full = base, empty = base + 64, ring = base + HEADER;
  const int tid = threadIdx.x, nk = (p.D + TK - 1) / TK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1 + (p.w_tma ? 0 : ROW_THREADS));
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producers: x's tiles (and aligned weight tiles) by TMA from
    // thread 0; an unaligned weight's rows half a row a thread, put in
    // place two stages after their copies were issued (before the wait for
    // a free stage, so that the consumers' pace does not hold them back)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - CONSUMERS, row = pt >> 1, half = pt & 1;
    if (p.w_tma && pt != 0) return;  // one thread issues every copy
    int s = 0;
    uint32_t ph = 0;
    Pending q1 = {-1, 0, 0}, q2 = {-1, 0, 0};
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = (t / p.tiles_n) * TM, n0 = (t % p.tiles_n) * TN;
      for (int kb = 0; kb < nk; ++kb) {
        if (!p.w_tma && q2.s >= 0) {
          cp_wait<1>();  // this thread's copies of stage q2 landed
          realign(ring + q2.s * STAGE, q2, row, half, full);
        }
        mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t st = ring + s * STAGE;
        if (pt == 0) {
          mbar_expect_tx(full + 8 * s, X_STAGE + (p.w_tma ? W_STAGE : 0));
          tma2d(st, &tx, full + 8 * s, kb * TK, m0);
          if (p.w_tma) tma2d(st + X_STAGE, &tw, full + 8 * s, n0, kb * TK);
        }
        if (!p.w_tma) {
          // the aligned words that cover this thread's half row (the one
          // that holds its last byte may be the other half's first)
          Pending cur = {s, 0, 0};
          const int k = kb * TK + row;
          if (k < p.D) {
            const unsigned char* src = p.w + (size_t)k * p.F + n0;
            cur.nb = min(TN, p.F - n0);
            cur.off = (int)((uintptr_t)src & 15);
            const unsigned char* first = src - cur.off;
            const int lo = 64 * half, hi = min(lo + 64, cur.nb);
            if (lo < hi)
              for (int j = (cur.off + lo) >> 4; j <= (cur.off + hi - 1) >> 4; ++j)
                cp16(st + X_STAGE + W_STAGE + row * RAW_PITCH + 16 * j, first + 16 * j);
          }
          asm volatile("cp.async.commit_group;\n" ::: "memory");
          q2 = q1;
          q1 = cur;
        }
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    if (q2.s >= 0) {
      cp_wait<1>();
      realign(ring + q2.s * STAGE, q2, row, half, full);
    }
    if (q1.s >= 0) {
      cp_wait<0>();
      realign(ring + q1.s * STAGE, q1, row, half, full);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume(p, ring, full, empty, tid);
  }
}

constexpr int SMEM = 1024 + HEADER + STAGES * STAGE;  // 1024: the ring's alignment slack

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

// a 2-d row-major tensor of `rows` x `cols` elements, `pitch` bytes a row,
// in boxes of box_cols (128 bytes) x box_rows with the 128-byte swizzle;
// reads outside it arrive as zeros
int map2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int cols, int rows,
          size_t pitch, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult err = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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

}  // namespace

// x (B, D) bf16 with rows `ldx` elements apart, w (D, F) int8, scale (F,)
// f32 -> out (B, F) f32 under the plan (ops/int8_matmul.py `tiled_plan`):
// at most `blocks` persistent blocks. x's base
// and row pitch must be 16-byte aligned; w may have any alignment.
extern "C" int vqt_int8_matmul_tiled(const void* x, const void* w, const void* scale, void* out,
                                     int B, int D, int F, int ldx, int blocks,
                                     void* stream) {
  if (B < 1 || D < 1 || F < 1 || ldx < D || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || ldx % 8) return (int)cudaErrorMisalignedAddress;
  CUtensorMap tx, tw;
  memset(&tw, 0, sizeof tw);
  if (int err = map2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, D, B, (size_t)ldx * 2, TK, TM))
    return err;
  const int w_tma = (uintptr_t)w % 16 == 0 && F % 16 == 0;
  if (w_tma) {
    if (int err = map2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, F, D, (size_t)F, TN, TK)) return err;
  }
  if (int err = check_smem(SMEM)) return err;
  if (int err = (int)cudaFuncSetAttribute(w8a16_tiled_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM))
    return err;
  const int tiles_n = (F + TN - 1) / TN;
  const int tiles = tiles_n * ((B + TM - 1) / TM);
  // 16-byte stores from registers need every output row and the scale
  // 16-byte aligned
  const int out_aligned = (uintptr_t)out % 16 == 0 && (uintptr_t)scale % 16 == 0 && F % 4 == 0;
  const Params p = {(const unsigned char*)w, (const float*)scale, (float*)out, B, D, F,
                    w_tma, out_aligned, tiles_n, tiles};
  w8a16_tiled_kernel<<<tiles < blocks ? tiles : blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      tx, tw, p);
  return (int)cudaGetLastError();
}

// the kernel's dynamic shared memory and the blocks that fit on one SM of
// the current card
extern "C" int vqt_int8_matmul_tiled_occupancy(int* smem, int* blocks_per_sm) {
  *smem = SMEM;
  if (int err = check_smem(SMEM)) return err;
  if (int err = (int)cudaFuncSetAttribute(w8a16_tiled_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM))
    return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, w8a16_tiled_kernel,
                                                            THREADS, SMEM);
}
