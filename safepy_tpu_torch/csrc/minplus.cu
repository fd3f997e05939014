// Min-plus (tropical) relaxation kernels for the blocked Floyd-Warshall round
// of safepy_tpu_torch/ops/apsp_cuda.py, written for Hopper (sm_90a) behind a
// plain C interface that safepy_tpu_torch/native.py loads with ctypes.
//
// Which TPU kernels they replace (safepy_tpu/ops/apsp_pallas.py):
//   relax_panel      <- _relax_rows :95 and _relax_cols :128. Both are
//                       min(C, A (x) B) with one 128-wide operand: the pivot row
//                       panel against the closed diagonal, or the pivot column
//                       panel against it.
//   relax_band_row   <- _relax_panel :111: min(C, Q (x) P) on one (block, W)
//                       window row of the row-sharded band FW
//                       (safepy_tpu/parallel/band_sharded.py:98,141), Q the
//                       row's own pivot-column tile, P a slice of the
//                       inf-extended pivot row. The relax_panel computation
//                       under a second kernel name (one row of 2 x W / 64
//                       CTAs a launch, 2 bt + 1 launches a round); bound like
//                       it by the FP32 add+min issue rate.
//   relax_window_sym <- _relax_full_banded_sym :193 (kernel_a + kernel_b):
//                       relax the upper in-band tiles of a window and mirror
//                       each into its lower twin, here in place on the matrix.
//   close_diag       <- _close_diag :258, the in-tile closure of the pivot
//                       tile (a jnp fori_loop in the JAX package, not Pallas).
//   relax_full       <- _relax_full :144 and _relax_full_banded :161: the
//                       classic phase 3, D = min(D, Q (x) P) in place over a
//                       whole (possibly rectangular) matrix or window, each
//                       64x64 tile by its own block against Q and P, which
//                       are separate buffers; with a tile band, blocks beyond
//                       it return at entry and their tiles keep their values.
//                       Bound by the FP32 add+min instruction rate: each D
//                       tile is read and written once per 64 x 64 x K
//                       candidates.
//   minplus_product  <- min_plus_pallas :62 (_minplus_kernel :46): out =
//                       A (x) B into a new buffer, the accumulators started
//                       at +inf in registers; the Pallas (i, j, k) grid's
//                       sequential k axis becomes the loop inside the block,
//                       and the wrapper pads the ragged edges with +inf.
//                       Bound by the FP32 add+min instruction rate, more so
//                       than the relax kernels: K is the whole matrix width
//                       (4,096 at the Example_1 shape), so the output store
//                       is negligible.
// and in safepy_tpu/ops/apsp_bandstore.py (phase 3 of the band-storage FW):
//   relax_skew_sym   <- _relax_skew_sym_pallas :324 (pass A + pass B): relax
//                       the upper wedge of the skewed (W, W) pivot window and
//                       write each off-diagonal tile's transpose into its
//                       lower mirror, in place on the band.
//   relax_skew       <- _relax_skew_pallas :281: relax every in-band tile of
//                       the skewed window, no mirror.
//
// What bounds them on the H100: a min-plus product has no tensor-core route.
// Every candidate a[i,k] + b[k,j] costs one FP32 add and one FP32 min on the
// CUDA cores, so the kernels are bound by FP32 add+min issue, not by memory:
// a 64x64 output tile reads 2 * 64 * K operands and does 64 * 64 * K
// candidates, 32 candidates per operand loaded from device memory.
//
// What the design does about it: each block of 256 threads owns a 64x64
// output tile, stages 32-deep chunks of A (transposed) and B in shared memory,
// and each thread keeps a 4x4 micro-tile of the result in registers across the
// whole contraction. Every shared-memory value a thread loads feeds four
// candidates, so the inner loop issues 16 adds and 16 mins per 8 shared loads.
// Making this fast (wider micro-tiles, vectorised loads, a persistent grid,
// CUDA graphs around the round loop) is later work.
//
// Bitwise contract: every candidate is one f32 rounding of a + b, and min is
// exact and order-free on the non-NaN inputs Floyd-Warshall produces, so any
// tiling and any k order gives the bits of the plain torch versions. Build
// without --use_fast_math: +inf must pass through the adds and mins exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;   // output sub-tile edge owned by one thread block
constexpr int KC = 32;     // contraction chunk staged in shared memory
constexpr int TPB = 256;   // 16 x 16 threads
constexpr int MICRO = 4;   // each thread: rows ty + 16 r, cols tx + 16 c

struct TileSmem {
  float a[KC][TILE + 1];  // A chunk, k-major; the +1 pad keeps the transposing store conflict-free
  float b[KC][TILE];      // B chunk, row-major
};

__device__ __forceinline__ void load_acc(const float* c, int64_t ldc,
                                         float acc[MICRO][MICRO]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < MICRO; ++r)
#pragma unroll
    for (int q = 0; q < MICRO; ++q)
      acc[r][q] = c[(int64_t)(ty + 16 * r) * ldc + tx + 16 * q];
}

__device__ __forceinline__ void store_acc(float* out, int64_t ldo,
                                          const float acc[MICRO][MICRO]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < MICRO; ++r)
#pragma unroll
    for (int q = 0; q < MICRO; ++q)
      out[(int64_t)(ty + 16 * r) * ldo + tx + 16 * q] = acc[r][q];
}

// Write the transpose of a thread block's 64x64 accumulator at dst (leading
// dimension ld): stage it in shared memory, then store rows of the transpose
// so that consecutive threads write consecutive addresses.
__device__ __forceinline__ void store_transposed(float* dst, int64_t ld,
                                                 const float acc[MICRO][MICRO],
                                                 float (*t)[TILE + 1]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < MICRO; ++r)
#pragma unroll
    for (int c = 0; c < MICRO; ++c) t[ty + 16 * r][tx + 16 * c] = acc[r][c];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < (TILE * TILE) / TPB; ++e) {
    const int idx = threadIdx.x + e * TPB;
    const int i = idx / TILE, jj = idx % TILE;
    dst[(int64_t)i * ld + jj] = t[jj][i];
  }
}

// acc = min(acc, A (x) B) for one 64x64 tile: A points at the tile's first
// row (64 x K, leading dimension lda), B at its first column (K x 64, ldb).
__device__ __forceinline__ void minplus_tile(const float* A, int64_t lda,
                                             const float* B, int64_t ldb,
                                             int K, float acc[MICRO][MICRO],
                                             TileSmem& s) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += KC) {
    // consecutive threads read consecutive k of one A row (coalesced)
#pragma unroll
    for (int e = 0; e < (TILE * KC) / TPB; ++e) {
      const int idx = tid + e * TPB;
      const int row = idx / KC, kk = idx % KC;
      s.a[kk][row] = A[(int64_t)row * lda + k0 + kk];
    }
#pragma unroll
    for (int e = 0; e < (TILE * KC) / TPB; ++e) {
      const int idx = tid + e * TPB;
      const int kk = idx / TILE, col = idx % TILE;
      s.b[kk][col] = B[(int64_t)(k0 + kk) * ldb + col];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float a[MICRO], b[MICRO];
#pragma unroll
      for (int r = 0; r < MICRO; ++r) a[r] = s.a[kk][ty + 16 * r];
#pragma unroll
      for (int q = 0; q < MICRO; ++q) b[q] = s.b[kk][tx + 16 * q];
#pragma unroll
      for (int r = 0; r < MICRO; ++r)
#pragma unroll
        for (int q = 0; q < MICRO; ++q)
          acc[r][q] = fminf(acc[r][q], a[r] + b[q]);
    }
    __syncthreads();
  }
}

// out = min(C, A (x) B) for the 64x64 tile of this thread block; grid
// (n / 64, m / 64). C and out may not alias.
__device__ __forceinline__ void relax_out_tile(const float* a, int64_t lda,
                                               const float* b, int64_t ldb,
                                               const float* c, int64_t ldc,
                                               float* out, int64_t ldo, int k,
                                               TileSmem& s) {
  const int64_t row0 = (int64_t)blockIdx.y * TILE;
  const int64_t col0 = (int64_t)blockIdx.x * TILE;
  float acc[MICRO][MICRO];
  load_acc(c + row0 * ldc + col0, ldc, acc);
  minplus_tile(a + row0 * lda, lda, b + col0, ldb, k, acc, s);
  store_acc(out + row0 * ldo + col0, ldo, acc);
}

__global__ void __launch_bounds__(TPB)
relax_panel_kernel(const float* a, int64_t lda, const float* b, int64_t ldb,
                   const float* c, int64_t ldc, float* out, int64_t ldo,
                   int k) {
  __shared__ TileSmem s;
  relax_out_tile(a, lda, b, ldb, c, ldc, out, ldo, k, s);
}

// The same computation under its own name, so that a profile tells the
// band-sharded window rows (B3) from the pivot panels (B2/B4): out = min(C,
// Q (x) P) for one (block, W) window row, Q its (block, block) pivot-column
// tile and P a W-wide slice of the inf-extended pivot row.
__global__ void __launch_bounds__(TPB)
relax_band_row_kernel(const float* q, int64_t ldq, const float* p,
                      int64_t ldp, const float* c, int64_t ldc, float* out,
                      int64_t ldo, int k) {
  __shared__ TileSmem s;
  relax_out_tile(q, ldq, p, ldp, c, ldc, out, ldo, k, s);
}

// In place on the (w, w) window of d that starts at (lo, lo). Block
// (x, y, z) owns 64x64 sub-tile z of the upper block-tile (i, j) = (x, x + y):
// it relaxes that sub-tile against q (w x block) and p (block x w), writes it
// back and, off the diagonal, writes its transpose into tile (j, i). Only
// upper tiles are read and q, p are separate buffers, so no block reads what
// another writes. Tiles further than band_tiles from the diagonal are never
// touched.
__global__ void __launch_bounds__(TPB)
relax_window_sym_kernel(const float* q, const float* p, float* d, int64_t ld,
                        int64_t lo, int w, int block) {
  __shared__ TileSmem s;
  __shared__ float t[TILE][TILE + 1];
  const int ti = blockIdx.x;
  const int tj = blockIdx.x + blockIdx.y;
  if (tj >= w / block) return;  // whole block leaves together
  const int subs = block / TILE;
  const int si = blockIdx.z / subs, sj = blockIdx.z % subs;
  const int64_t r0 = (int64_t)ti * block + si * TILE;
  const int64_t c0 = (int64_t)tj * block + sj * TILE;
  float* win = d + lo * ld + lo;

  float acc[MICRO][MICRO];
  load_acc(win + r0 * ld + c0, ld, acc);
  minplus_tile(q + r0 * block, block, p + c0, w, block, acc, s);
  store_acc(win + r0 * ld + c0, ld, acc);
  if (tj == ti) return;
  store_transposed(win + c0 * ld + r0, ld, acc, t);
}

// Phase 3 of the band-storage round, in place on the (w, w) skewed window
// (w = (2 bt + 1) block, row stride ld). Window tile (o, j) is relaxed
// against q tile o (the snapshot of window tile (o, 2 bt - o), the pivot
// column) and pivot-row tile o + j - bt of p (b x w, row stride ldp).
//
// Symmetric form, grid (2 bt + 1, bt + 1, subs^2): block (o, jj, z) owns
// 64x64 sub-tile z of the upper tile (o, bt + jj), computed where
// o + jj <= 2 bt, and for jj >= 1 writes its transpose into the lower mirror
// (o + jj, bt - jj). Upper tiles are read only by their own block and
// mirrors are lower tiles, so no block reads what another writes; q and p
// are separate buffers. Every other tile keeps its value.
__global__ void __launch_bounds__(TPB)
relax_skew_sym_kernel(const float* q, const float* p, int64_t ldp, float* win,
                      int64_t ld, int bt, int block) {
  __shared__ TileSmem s;
  __shared__ float t[TILE][TILE + 1];
  const int o = blockIdx.x, jj = blockIdx.y;
  if (o + jj > 2 * bt) return;  // pivot-row tile beyond the slab
  const int subs = block / TILE;
  const int si = blockIdx.z / subs, sj = blockIdx.z % subs;
  const int64_t r0 = (int64_t)o * block + si * TILE;
  const int64_t c0 = (int64_t)(bt + jj) * block + sj * TILE;
  const int64_t pc = (int64_t)(o + jj) * block + sj * TILE;

  float acc[MICRO][MICRO];
  load_acc(win + r0 * ld + c0, ld, acc);
  minplus_tile(q + r0 * block, block, p + pc, ldp, block, acc, s);
  store_acc(win + r0 * ld + c0, ld, acc);
  if (jj == 0) return;
  const int64_t mr0 = (int64_t)(o + jj) * block + sj * TILE;
  const int64_t mc0 = (int64_t)(bt - jj) * block + si * TILE;
  store_transposed(win + mr0 * ld + mc0, ld, acc, t);
}

// Non-symmetric form, grid (2 bt + 1, 2 bt + 1, subs^2): block (o, j, z)
// relaxes sub-tile z of tile (o, j) where |o + j - 2 bt| <= bt (the
// pivot-row tile lies in the slab); every other tile keeps its value.
__global__ void __launch_bounds__(TPB)
relax_skew_kernel(const float* q, const float* p, int64_t ldp, float* win,
                  int64_t ld, int bt, int block) {
  __shared__ TileSmem s;
  const int o = blockIdx.x, j = blockIdx.y;
  const int off = o + j - 2 * bt;
  if (off > bt || off < -bt) return;
  const int subs = block / TILE;
  const int si = blockIdx.z / subs, sj = blockIdx.z % subs;
  const int64_t r0 = (int64_t)o * block + si * TILE;
  const int64_t c0 = (int64_t)j * block + sj * TILE;
  const int64_t pc = (int64_t)(off + bt) * block + sj * TILE;

  float acc[MICRO][MICRO];
  load_acc(win + r0 * ld + c0, ld, acc);
  minplus_tile(q + r0 * block, block, p + pc, ldp, block, acc, s);
  store_acc(win + r0 * ld + c0, ld, acc);
}

// Classic phase 3, in place: D = min(D, Q (x) P) over an (m, n) D with row
// stride ldd; grid (n / 64, m / 64). Q is (m, k), P is (k, n), both apart
// from D, so each block reads and writes only its own D tile and in place is
// safe. With band_tiles >= 0 the band is counted in k-wide block-tiles (the
// FW block): a block whose tile (row0 / k, col0 / k) lies further than
// band_tiles from the diagonal returns at once, uniformly, and its tile keeps
// its value.
__global__ void __launch_bounds__(TPB)
relax_full_kernel(const float* q, int64_t ldq, const float* p, int64_t ldp,
                  float* d, int64_t ldd, int k, int band_tiles) {
  __shared__ TileSmem s;
  const int64_t row0 = (int64_t)blockIdx.y * TILE;
  const int64_t col0 = (int64_t)blockIdx.x * TILE;
  if (band_tiles >= 0) {
    const int64_t off = row0 / k - col0 / k;
    if (off > band_tiles || off < -band_tiles) return;
  }
  float acc[MICRO][MICRO];
  load_acc(d + row0 * ldd + col0, ldd, acc);
  minplus_tile(q + row0 * ldq, ldq, p + col0, ldp, k, acc, s);
  store_acc(d + row0 * ldd + col0, ldd, acc);
}

// out = A (x) B into a new (m, n) buffer; grid (n / 64, m / 64), k a
// multiple of 32. Reads no C: the accumulators start at +inf.
__global__ void __launch_bounds__(TPB)
minplus_product_kernel(const float* a, int64_t lda, const float* b,
                       int64_t ldb, float* out, int64_t ldo, int k) {
  __shared__ TileSmem s;
  const int64_t row0 = (int64_t)blockIdx.y * TILE;
  const int64_t col0 = (int64_t)blockIdx.x * TILE;
  float acc[MICRO][MICRO];
#pragma unroll
  for (int r = 0; r < MICRO; ++r)
#pragma unroll
    for (int c = 0; c < MICRO; ++c) acc[r][c] = __int_as_float(0x7f800000);
  minplus_tile(a + row0 * lda, lda, b + col0, ldb, k, acc, s);
  store_acc(out + row0 * ldo + col0, ldo, acc);
}

// In-tile Floyd-Warshall closure of one (B, B) tile, one block of 8 B
// threads. Thread (g, j) keeps column j of rows g, g + 8, ... in registers.
// Step k snapshots row k and column k into shared memory before anyone
// updates, as the jnp fori_loop reads them from the pre-step tile; the two
// buffers alternate, so one barrier per step suffices.
template <int B>
__global__ void __launch_bounds__(8 * B)
close_diag_kernel(const float* tile, int64_t ldt, float* out) {
  constexpr int R = B / 8;
  __shared__ float row_buf[2][B];
  __shared__ float col_buf[2][B];
  const int j = threadIdx.x % B;
  const int g = threadIdx.x / B;
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = tile[(int64_t)(g + 8 * r) * ldt + j];

#pragma unroll
  for (int kr = 0; kr < R; ++kr) {
    for (int ks = 0; ks < 8; ++ks) {
      const int k = 8 * kr + ks;
      const int buf = k & 1;
      if (g == ks) row_buf[buf][j] = v[kr];  // this thread holds row k
      if (j == k) {
#pragma unroll
        for (int r = 0; r < R; ++r) col_buf[buf][g + 8 * r] = v[r];
      }
      __syncthreads();
      const float rk = row_buf[buf][j];
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = fminf(v[r], col_buf[buf][g + 8 * r] + rk);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[(int64_t)(g + 8 * r) * B + j] = v[r];
}

}  // namespace

// C entry points. Each launches on the given stream, allocates nothing and
// returns cudaGetLastError() (0 = launched). Shapes are checked by the
// Python wrappers: m, n, w multiples of 64; k multiple of 32 (of 64 for a
// banded relax_full); block 64 or 128.
extern "C" {

int safepy_relax_panel(const float* a, int64_t lda, const float* b,
                       int64_t ldb, const float* c, int64_t ldc, float* out,
                       int64_t ldo, int m, int n, int k, void* stream) {
  const dim3 grid(n / TILE, m / TILE);
  relax_panel_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(
      a, lda, b, ldb, c, ldc, out, ldo, k);
  return (int)cudaGetLastError();
}

int safepy_relax_band_row(const float* q, int64_t ldq, const float* p,
                          int64_t ldp, const float* c, int64_t ldc, float* out,
                          int64_t ldo, int m, int n, int k, void* stream) {
  const dim3 grid(n / TILE, m / TILE);
  relax_band_row_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(
      q, ldq, p, ldp, c, ldc, out, ldo, k);
  return (int)cudaGetLastError();
}

int safepy_relax_window_sym(const float* q, const float* p, float* d,
                            int64_t ld, int64_t lo, int w, int block,
                            int band_tiles, void* stream) {
  const int nbw = w / block;
  const int reach = band_tiles < nbw - 1 ? band_tiles : nbw - 1;
  const int subs = block / TILE;
  const dim3 grid(nbw, reach + 1, subs * subs);
  relax_window_sym_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(
      q, p, d, ld, lo, w, block);
  return (int)cudaGetLastError();
}

int safepy_relax_skew_sym(const float* q, const float* p, int64_t ldp,
                          float* win, int64_t ld, int bt, int block,
                          void* stream) {
  const int subs = block / TILE;
  const dim3 grid(2 * bt + 1, bt + 1, subs * subs);
  relax_skew_sym_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(
      q, p, ldp, win, ld, bt, block);
  return (int)cudaGetLastError();
}

int safepy_relax_skew(const float* q, const float* p, int64_t ldp, float* win,
                      int64_t ld, int bt, int block, void* stream) {
  const int subs = block / TILE;
  const dim3 grid(2 * bt + 1, 2 * bt + 1, subs * subs);
  relax_skew_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(q, p, ldp, win, ld,
                                                            bt, block);
  return (int)cudaGetLastError();
}

int safepy_relax_full(const float* q, int64_t ldq, const float* p,
                      int64_t ldp, float* d, int64_t ldd, int m, int n, int k,
                      int band_tiles, void* stream) {
  const dim3 grid(n / TILE, m / TILE);
  relax_full_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(
      q, ldq, p, ldp, d, ldd, k, band_tiles);
  return (int)cudaGetLastError();
}

int safepy_minplus_product(const float* a, int64_t lda, const float* b,
                           int64_t ldb, float* out, int64_t ldo, int m, int n,
                           int k, void* stream) {
  const dim3 grid(n / TILE, m / TILE);
  minplus_product_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(
      a, lda, b, ldb, out, ldo, k);
  return (int)cudaGetLastError();
}

int safepy_close_diag(const float* tile, int64_t ldt, float* out, int block,
                      void* stream) {
  if (block == 128) {
    close_diag_kernel<128><<<1, 8 * 128, 0, (cudaStream_t)stream>>>(tile, ldt,
                                                                     out);
  } else if (block == 64) {
    close_diag_kernel<64><<<1, 8 * 64, 0, (cudaStream_t)stream>>>(tile, ldt,
                                                                   out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
