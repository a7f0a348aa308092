// Nearest-codebook lookup for Hopper: codes (N,) int32 =
//   argmin_k ( esq[k] - x[n] . e[k] ),  esq[k] = 0.5 * ||e[k]||^2 (f32,
// computed by the caller), which has the argmin of ||x[n] - e[k]||^2.
// Products and sums in f32 (bf16 inputs are widened exactly); an exact tie
// goes to the lowest index. The N x K score matrix is never written.
//
// Replaces the TPU kernel vector_quantization_tpu/ops/vq_lookup.py:93
// `_nearest_codes_pallas` (kernel body `_nearest_kernel`).
//
// What bounds it on the H100: operations. At the tokenizer's shape
// (N = 16384 rows, K = 16384 codes, D = 8) the inputs are 1.2 MB, read in
// 0.35 us, while the work is 2*N*K*D + 2*N*K = 4.8 G operations, ~72 us at
// the 67 TFLOP/s of f32 outside the tensor cores. At D = 8 each (row, code)
// pair costs 8 FMAs plus a compare and a select, so the FMA pipe and the
// selection logic, not the matmul, set the pace. What the design does:
// - a block owns a 128-row x 128-code tile; each of its 256 threads keeps an
//   8 x 8 micro-tile of scores in registers (acc starts at esq and takes
//   one FMA per dimension with the negated x), reading x and codebook
//   values from shared memory as float4s;
// - after the last D chunk of a codebook tile each thread folds its 8 codes
//   per row into a running (best, index) in registers, in ascending code
//   order with a strict `<`, so the lowest index wins within a thread;
// - the codebook is split across blocks (grid.y) so that 128 row tiles
//   still give the card many blocks; each block reduces its rows' (best,
//   index) over the 16 threads sharing them with warp shuffles, then does
//   one 64-bit atomicMin per row on a key with the order-preserving bits of
//   the score above the index: the smaller score wins and, on an exact tie,
//   the smaller index. A last pass turns the keys into int32 codes;
// - the next chunk's global loads are issued before the current chunk's
//   FMAs (register prefetch); ragged N, K and D are masked, not padded.
// Tensor cores (x . e^T on mma/wgmma) and cp.async/TMA pipelining are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;       // rows per block
constexpr int BK = 128;       // codes per codebook tile
constexpr int DK = 8;         // dimensions per shared-memory chunk
constexpr int THREADS = 256;  // 16 row groups x 16 code groups
constexpr int PITCH = BN + 4; // conflict-free transposed stores, float4-aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 4 consecutive elements starting at p (16 bytes for f32, 8 for bf16)
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  out[0] = __low2float(lo); out[1] = __high2float(lo);
  out[2] = __low2float(hi); out[3] = __high2float(hi);
}

template <typename T>
__device__ __forceinline__ void load_row4(const T* base, int rows, int D, int row,
                                          int d0, bool vec, float* out) {
  if (row < rows && vec && d0 + 4 <= D) {
    load4(base + (size_t)row * D + d0, out);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[q] = (row < rows && d0 + q < D) ? to_f32(base[(size_t)row * D + d0 + q]) : 0.f;
  }
}

// smaller float <-> smaller unsigned key (-0.0 folded into +0.0 first)
__device__ __forceinline__ unsigned long long make_key(float s, int idx) {
  if (idx < 0) return ~0ull;
  uint32_t u = __float_as_uint(s);
  if ((u & 0x7fffffffu) == 0) u = 0;
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | (uint32_t)idx;
}

template <typename TX, typename TE>
__global__ void __launch_bounds__(THREADS, 2)
nearest_kernel(const TX* __restrict__ x, const TE* __restrict__ e,
               const float* __restrict__ esq, unsigned long long* __restrict__ keys,
               int N, int K, int D, int tiles_per_split) {
  __shared__ __align__(16) float xs[DK * PITCH];  // -x, transposed: [d][row]
  __shared__ __align__(16) float es[DK * PITCH];  // e, transposed: [d][code]
  __shared__ __align__(16) float qs[BK];          // esq of the tile, +inf past K

  const int tid = threadIdx.x;
  const int tn = tid & 15, tm = tid >> 4;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(k_tiles, t_begin + tiles_per_split);
  if (t_begin >= t_end) return;
  const int n_chunks = (D + DK - 1) / DK;
  const int iters = (t_end - t_begin) * n_chunks;

  // loader: row (or code) tid/2 of the tile, dimensions 4*(tid%2) .. +3 of
  // the chunk; at D = 8 a warp reads 512 contiguous bytes of x and of e
  const int lr = tid >> 1, lc = (tid & 1) * 4;
  const bool x_vec = (D % 4 == 0) && ((reinterpret_cast<uintptr_t>(x) % (4 * sizeof(TX))) == 0);
  const bool e_vec = (D % 4 == 0) && ((reinterpret_cast<uintptr_t>(e) % (4 * sizeof(TE))) == 0);
  float xr[4], er[4], qr = 0.f;
  auto load = [&](int it) {
    const int t = t_begin + it / n_chunks, c = it % n_chunks;
    const int d0 = c * DK + lc;
    load_row4(x, N, D, n0 + lr, d0, x_vec, xr);
    load_row4(e, K, D, t * BK + lr, d0, e_vec, er);
    if (c == 0 && tid < BK) {
      const int code = t * BK + tid;
      qr = code < K ? esq[code] : __int_as_float(0x7f800000);  // +inf
    }
  };

  float best[8];
  int bidx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) { best[i] = __int_as_float(0x7f800000); bidx[i] = -1; }
  float acc[8][8];

  load(0);
  for (int it = 0; it < iters; ++it) {
    const int t = t_begin + it / n_chunks, c = it % n_chunks;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      xs[(lc + q) * PITCH + lr] = -xr[q];
      es[(lc + q) * PITCH + lr] = er[q];
    }
    if (c == 0 && tid < BK) qs[tid] = qr;
    __syncthreads();
    if (it + 1 < iters) load(it + 1);

    if (c == 0) {
      float q8[8];
      *reinterpret_cast<float4*>(&q8[0]) = *reinterpret_cast<const float4*>(&qs[tn * 4]);
      *reinterpret_cast<float4*>(&q8[4]) = *reinterpret_cast<const float4*>(&qs[64 + tn * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = q8[j];
    }
#pragma unroll
    for (int dd = 0; dd < DK; ++dd) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(&a[0]) = *reinterpret_cast<const float4*>(&xs[dd * PITCH + tm * 4]);
      *reinterpret_cast<float4*>(&a[4]) = *reinterpret_cast<const float4*>(&xs[dd * PITCH + 64 + tm * 4]);
      *reinterpret_cast<float4*>(&b[0]) = *reinterpret_cast<const float4*>(&es[dd * PITCH + tn * 4]);
      *reinterpret_cast<float4*>(&b[4]) = *reinterpret_cast<const float4*>(&es[dd * PITCH + 64 + tn * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (c == n_chunks - 1) {
      // codes of this thread, ascending: tn*4 + 0..3, then 64 + tn*4 + 0..3
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int code = t * BK + (j >> 2) * 64 + tn * 4 + (j & 3);
          if (acc[i][j] < best[i]) { best[i] = acc[i][j]; bidx[i] = code; }
        }
    }
    __syncthreads();
  }

  // the 16 threads of a row group are lanes differing in bits 0..3
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    unsigned long long key = make_key(best[i], bidx[i]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
      key = other < key ? other : key;
    }
    const int row = n0 + (i >> 2) * 64 + tm * 4 + (i & 3);
    if (tn == 0 && row < N) atomicMin(&keys[row], key);
  }
}

__global__ void fill_keys(unsigned long long* keys, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) keys[i] = ~0ull;
}

__global__ void decode_keys(const unsigned long long* keys, int32_t* codes, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) codes[i] = (int32_t)(uint32_t)(keys[i] & 0xffffffffull);
}

template <typename TX, typename TE>
void launch(const void* x, const void* e, const float* esq, unsigned long long* keys,
            int N, int K, int D, int tiles_per_split, cudaStream_t stream) {
  const int k_tiles = (K + BK - 1) / BK;
  const dim3 grid((N + BN - 1) / BN, (k_tiles + tiles_per_split - 1) / tiles_per_split);
  nearest_kernel<TX, TE><<<grid, THREADS, 0, stream>>>(
      (const TX*)x, (const TE*)e, esq, keys, N, K, D, tiles_per_split);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. `keys` is (N,) 64-bit scratch.
extern "C" int vqt_nearest_codes(const void* x, int x_dtype, const void* e, int e_dtype,
                                 const void* esq, void* keys, void* codes,
                                 int N, int K, int D, int tiles_per_split, void* stream) {
  if (N < 1 || K < 1 || D < 1 || tiles_per_split < 1 || x_dtype < 0 || x_dtype > 1 ||
      e_dtype < 0 || e_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* k64 = (unsigned long long*)keys;
  const int fill_blocks = (N + 255) / 256;
  fill_keys<<<fill_blocks, 256, 0, s>>>(k64, N);
  const float* q = (const float*)esq;
  if (x_dtype == 0 && e_dtype == 0) launch<float, float>(x, e, q, k64, N, K, D, tiles_per_split, s);
  else if (x_dtype == 0) launch<float, __nv_bfloat16>(x, e, q, k64, N, K, D, tiles_per_split, s);
  else if (e_dtype == 0) launch<__nv_bfloat16, float>(x, e, q, k64, N, K, D, tiles_per_split, s);
  else launch<__nv_bfloat16, __nv_bfloat16>(x, e, q, k64, N, K, D, tiles_per_split, s);
  decode_keys<<<fill_blocks, 256, 0, s>>>(k64, (int32_t*)codes, N);
  return (int)cudaGetLastError();
}
