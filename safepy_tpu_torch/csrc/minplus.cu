// Min-plus (tropical) relaxation kernels for the blocked Floyd-Warshall round
// of safepy_tpu_torch/ops/apsp_cuda.py, written for Hopper (sm_90a) behind a
// plain C interface that safepy_tpu_torch/native.py loads with ctypes.
//
// Which TPU kernels they replace (safepy_tpu/ops/apsp_pallas.py):
//   relax_panel      <- _relax_rows :95 and _relax_cols :128. Both are
//                       min(C, A (x) B) with one 128-wide operand: the pivot row
//                       panel against the closed diagonal, or the pivot column
//                       panel against it.
//   relax_band_row   <- _relax_panel :111: min(C, Q (x) P) on the (block, W)
//                       window rows of the row-sharded band FW
//                       (safepy_tpu/parallel/band_sharded.py:98,141), Q each
//                       row's own pivot-column tile, P a slice of the
//                       inf-extended pivot row. The relax_panel tile body
//                       under a second kernel name, with a grid dimension
//                       over the rows: one launch a round for all of a
//                       rank's window rows.
//   relax_window_sym <- _relax_full_banded_sym :193 (kernel_a + kernel_b):
//                       relax the upper in-band tiles of a window and mirror
//                       each into its lower twin, here in place on the matrix,
//                       over a list of those tiles: whole tiles on the tile
//                       engine where the list is long, 32x32 sub-tiles on the
//                       panel body where it is short (design at the kernels).
//   close_diag       <- _close_diag :258, the in-tile closure of the pivot
//                       tile (a jnp fori_loop in the JAX package, not Pallas).
//   relax_full       <- _relax_full :144: the classic phase 3, D = min(D, Q
//                       (x) P) in place over a whole (possibly rectangular)
//                       matrix or window, each 64x64 tile by its own block
//                       against Q and P, which are separate buffers. Bound
//                       by the FP32 add+min instruction rate: each D tile
//                       is read and written once per 64 x 64 x K
//                       candidates.
//   relax_full_banded <- _relax_full_banded :161: the same on the tiles
//                       within a tile band only, over a list of them; the
//                       tiles beyond keep their values (design at the
//                       kernel).
//   minplus_product  <- min_plus_pallas :62 (_minplus_kernel :46): out =
//                       A (x) B into a new buffer, the accumulators started
//                       at +inf in registers; the Pallas (i, j, k) grid's
//                       sequential k axis becomes the slab loop of the tile
//                       engine, one 128x128 tile a CTA, and the wrapper pads
//                       the ragged edges with +inf. K is the whole matrix
//                       width (4,096 at the Example_1 shape), so the output
//                       store is negligible.
// and in safepy_tpu/ops/apsp_bandstore.py (phase 3 of the band-storage FW):
//   relax_skew_sym   <- _relax_skew_sym_pallas :324 (pass A + pass B): relax
//                       the upper wedge of the skewed (W, W) pivot window and
//                       write each off-diagonal tile's transpose into its
//                       lower mirror, in place on the band.
//   relax_skew       <- _relax_skew_pallas :281: relax every in-band tile of
//                       the skewed window, no mirror. Both run over a list
//                       of live tiles: a whole 128x128 tile a CTA on the
//                       tile engine where the list is long, 64x64 sub-tiles
//                       where it is short (design at the kernels).
//
// What bounds them on the H100: a min-plus product has no tensor-core route.
// Every candidate a[i,k] + b[k,j] costs one FP32 add and one FP32 min on the
// CUDA cores, so the kernels are bound by FP32 add+min issue, not by memory:
// a 64x64 output tile reads 2 * 64 * K operands and does 64 * 64 * K
// candidates, 32 candidates per operand loaded from device memory. The min
// issues at half the add's rate (16 lanes a clock in each SM quarter), so
// one candidate a clock on every lane pair, 64 an SM (16.7 T/s on 132 SMs
// at 1.98 GHz), is the ceiling; addmin_probe_kernel below measures the
// rate reached.
//
// What the designs do about it, from the oldest: the classic relax
// (relax_full) and the skew kernels' sub-tile form run minplus_tile below,
// where each block of 256 threads owns a 64x64 output tile, stages 32-deep
// chunks of A (transposed) and B in shared memory, and each thread keeps a
// 4x4 micro-tile of the result in registers across the whole contraction:
// every shared value a thread loads feeds four candidates, so the inner loop
// issues 16 adds and 16 mins per 8 shared loads, and the loads and the
// arithmetic take turns behind two barriers a chunk. The panel relax
// (panel_tile), the tile engine (engine_tile: the product and the whole-
// tile forms of the skew and window relax) and close_diag have designs of
// their own, below at their code.
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

// ---------------------------------------------------------------------------
// The panel relax (relax_panel, relax_band_row): out = min(C, A (x) B) with
// a 128-deep contraction over a thin panel, 128 x 1,024 to 128 x 3,200.
//
// One 64x64 tile a CTA would give such a panel only 32-100 CTAs on 132
// SMs. Here a CTA of 128 threads owns a 32x32 output tile, so a 128 x 1,024
// panel gives 128 CTAs of four warps (one warp on each SM sub-partition) and
// a 128 x 3,200 band row 400. The whole k slab of A (32 x 128, kept row-major) and B
// (128 x 32) is copied into shared memory at once by cp.async, 16 bytes a
// copy, and the CTA waits on it once. A thread keeps a 2 x 4 micro-tile (rows
// ty and ty + 16, columns 4 tx .. 4 tx + 3): per four k-steps it loads two
// float4 of A (four k of each of its rows; the row stride is padded to 132
// floats, so the four rows a warp reads fall in different banks) and four
// float4 of B, and issues 64 FP32 instructions. Bound by the FP32 add + min
// issue rate. Splitting k over two or four such thread groups of a CTA, their
// partial tiles min-reduced in shared memory, measured no faster on the
// panels and slower on a round's batched window rows on the H100, and was
// not kept.

constexpr int PT = 32;         // panel output tile edge
constexpr int PTPB = 128;      // threads: 8 column groups x 16 row pairs
constexpr int PKS = 128;       // k staged at once (one slab for k <= 128)
constexpr int PLDA = PKS + 4;  // padded row stride of the staged A

struct PanelSmem {
  float a[PT][PLDA];  // A rows, k contiguous
  float b[PKS][PT];   // B rows
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A thread's 2 x 4 block of a 32x32 tile at c (row stride ldc): rows ty and
// ty + 16, columns 4 tx .. 4 tx + 3.
__device__ __forceinline__ void panel_load(const float* c, int64_t ldc,
                                           float (&acc)[2][4]) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(
        c + (int64_t)(ty + 16 * h) * ldc + 4 * tx);
    acc[h][0] = v.x, acc[h][1] = v.y, acc[h][2] = v.z, acc[h][3] = v.w;
  }
}

__device__ __forceinline__ void panel_store(float* out, int64_t ldo,
                                            const float (&acc)[2][4]) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<float4*>(out + (int64_t)(ty + 16 * h) * ldo + 4 * tx) =
        make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
}

// acc = min(acc, A (x) B) over the staged k-steps k0 .. k1 - 1 (multiples
// of 4) of a 32x32 tile
__device__ __forceinline__ void panel_steps(float (&acc)[2][4],
                                            const PanelSmem& s, int k0,
                                            int k1) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll 2
  for (int kk = k0; kk < k1; kk += 4) {
    const float4 a4[2] = {*reinterpret_cast<const float4*>(&s.a[ty][kk]),
                          *reinterpret_cast<const float4*>(&s.a[ty + 16][kk])};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b4 = *reinterpret_cast<const float4*>(&s.b[kk + j][4 * tx]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float av = j == 0 ? a4[h].x : j == 1 ? a4[h].y
                       : j == 2 ? a4[h].z : a4[h].w;
        acc[h][0] = fminf(acc[h][0], av + b4.x);
        acc[h][1] = fminf(acc[h][1], av + b4.y);
        acc[h][2] = fminf(acc[h][2], av + b4.z);
        acc[h][3] = fminf(acc[h][3], av + b4.w);
      }
    }
  }
}

// Copy k-steps c0 .. c0 + cw - 1 of the slab at k0 (A columns, B rows) into
// s, asynchronously.
__device__ __forceinline__ void panel_stage(const float* a, int64_t lda,
                                            const float* b, int64_t ldb,
                                            int k0, int c0, int cw,
                                            PanelSmem& s) {
  const int ach = cw / 4;  // 16-byte chunks of an A row
  for (int e = threadIdx.x; e < PT * ach; e += PTPB) {
    const int r = e / ach, ch = e % ach;
    cp_async16(&s.a[r][c0 + 4 * ch], a + (int64_t)r * lda + k0 + c0 + 4 * ch);
  }
  for (int e = threadIdx.x; e < cw * (PT / 4); e += PTPB) {
    const int kk = c0 + e / (PT / 4), ch = e % (PT / 4);
    cp_async16(&s.b[kk][4 * ch], b + (int64_t)(k0 + kk) * ldb + 4 * ch);
  }
}

// acc = min(acc, A (x) B) on a 32x32 tile: a at its first row (32 x k, lda),
// b at its first column (k x 32, ldb). Every pointer is 16-byte aligned and
// every leading dimension a multiple of 4 (checked by the wrappers).
__device__ __forceinline__ void panel_relax(const float* a, int64_t lda,
                                            const float* b, int64_t ldb,
                                            int k, float (&acc)[2][4],
                                            PanelSmem& s) {
  for (int k0 = 0; k0 < k; k0 += PKS) {
    const int kc = k - k0 < PKS ? k - k0 : PKS;  // a multiple of 32
    panel_stage(a, lda, b, ldb, k0, 0, kc, s);
    cp_async_wait_all();
    __syncthreads();
    panel_steps(acc, s, 0, kc);
    if (k0 + PKS < k) __syncthreads();  // the next slab overwrites s
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0 .. 3) of this thread's committed copy groups are
// still in flight
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n >= 3) asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (n == 2) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// panel_relax for k <= PKS, the slab copied in 32-deep chunks, one copy
// group each, all in flight at once, and each chunk relaxed as soon as it
// has landed: the operand fetch overlaps the arithmetic inside the CTA.
__device__ __forceinline__ void panel_relax_chunked(const float* a,
                                                    int64_t lda,
                                                    const float* b,
                                                    int64_t ldb, int k,
                                                    float (&acc)[2][4],
                                                    PanelSmem& s) {
  constexpr int CH = 32;
  for (int c0 = 0; c0 < k; c0 += CH) {
    panel_stage(a, lda, b, ldb, 0, c0, CH, s);
    cp_async_commit();
  }
  for (int c0 = 0; c0 < k; c0 += CH) {
    cp_async_wait_pending((k - c0) / CH - 1);
    __syncthreads();
    panel_steps(acc, s, c0, c0 + CH);
  }
}

// out = min(C, A (x) B) for the 32x32 tile (blockIdx.y, blockIdx.x). A points
// at the panel's first row (m x k, lda), B at its first column (k x n, ldb).
// C may be out: each CTA reads its own C tile before it writes it, and A and
// B must then lie apart from out.
__device__ __forceinline__ void panel_tile(const float* a, int64_t lda,
                                           const float* b, int64_t ldb,
                                           const float* c, int64_t ldc,
                                           float* out, int64_t ldo, int k,
                                           PanelSmem& s) {
  const int64_t row0 = (int64_t)blockIdx.y * PT;
  const int64_t col0 = (int64_t)blockIdx.x * PT;
  float acc[2][4];
  panel_load(c + row0 * ldc + col0, ldc, acc);
  panel_relax(a + row0 * lda, lda, b + col0, ldb, k, acc, s);
  panel_store(out + row0 * ldo + col0, ldo, acc);
}

// out = min(C, A (x) B) into a separate buffer; grid (n / 32, m / 32).
__global__ void __launch_bounds__(PTPB)
relax_panel_kernel(const float* a, int64_t lda, const float* b, int64_t ldb,
                   const float* c, int64_t ldc, float* out, int64_t ldo,
                   int k) {
  __shared__ __align__(16) PanelSmem s;
  panel_tile(a, lda, b, ldb, c, ldc, out, ldo, k, s);
}

// The sharded band FW's window rows, under their own name so that a profile
// tells them from the pivot panels: grid (n / 32, m / 32, rows), where z is
// one (m, n) = (block, W) window row, relaxed as out_z = min(C_z, Q_z (x)
// P_z). Operand X of row z starts x_rs elements after row 0's: for the rows
// of a round, Q_z is row z's snapshotted pivot-column tile, P_z the pivot row
// slice one block further right, and out_z = C_z (in place).
__global__ void __launch_bounds__(PTPB)
relax_band_row_kernel(const float* q, int64_t ldq, int64_t q_rs,
                      const float* p, int64_t ldp, int64_t p_rs,
                      const float* c, int64_t ldc, int64_t c_rs, float* out,
                      int64_t ldo, int64_t o_rs, int k) {
  __shared__ __align__(16) PanelSmem s;
  const int64_t z = blockIdx.z;
  panel_tile(q + z * q_rs, ldq, p + z * p_rs, ldp, c + z * c_rs, ldc,
             out + z * o_rs, ldo, k, s);
}

// ---------------------------------------------------------------------------
// The tile engine: C = min(C, Q (x) P) (or, for the product, C = Q (x) P
// from +inf) on whole B x B tiles, one CTA of (B / 8)^2 threads (256 at B =
// 128) for each tile. It runs the whole-tile forms of the skew relax (B8,
// B9) and of the window relax (B7), and the min-plus product (B1).
//
// What bounds it: the FP32 min, which the H100 issues at half the FP32 add's
// rate (16 lanes a clock in each SM quarter), one a candidate: B^2 K mins a
// tile for 2 B K floats of operands, so the bytes are a small share (bt 12
// skew: 518 M candidates, 31 us at 16.7 T/s, against 15 us of bytes; the
// 4096^3 product: 4.1 ms against 0.06 ms). The design keeps the issue slots
// on the arithmetic and overlaps the operand copies with it:
//   - each thread holds an 8 x 8 block of the tile in registers (rows ty*4 +
//     {0..3} and B/2 + ty*4 + {0..3}, columns likewise from tx): 64
//     candidates a k-step for four float4 shared loads (two of Q, k-major,
//     two of P);
//   - k in slabs of 16, double buffered: slab s + 1 is copied by cp.async
//     (Q 4 bytes at a time, transposed into the k-major slab; P 16 bytes
//     at a time) while slab s is relaxed. No CTA-wide barrier in the loop:
//     a "full" mbarrier per buffer completes when every thread's copies
//     have landed, an "empty" one when every thread is done with the slab,
//     so warps drift up to a slab apart;
//   - the accumulators start at +inf. Where there is a C (K = B), it comes
//     in during the loop: each slab loads 8 / (B / 16) of the thread's rows
//     of C (two float4 a row) at its start and folds them in at its end, so
//     the C read overlaps the arithmetic (min is exact and order-free: the
//     same bits as starting from C). The tile goes back with float4 stores;
//     a mirror is written straight from the registers, a thread's 8 x 8
//     block as 8 rows of two float4 each, with no shared staging.
// The Q copy's mapping (8 threads on 8 consecutive k of one row, 4 rows a
// warp) reads one 32-byte sector a row and, with the slab's rows padded to
// B + 4 floats, stores to 32 different banks. Measured on the H100 for the
// skew kernels at bt 12 and not kept: two CTA-wide barriers a slab in place
// of the mbarriers (slower), C loaded whole at entry (slower; faster at
// block 64, a shape the band slice does not run), three buffers (no
// faster), C staged in shared memory by cp.async (slower: register spills),
// slabs of 8 or 32 and one CTA an SM (no faster).

constexpr int SKS = 16;  // k staged per slab

template <int B>
struct EngineSmem {
  float a[2][SKS][B + 4];  // Q slabs, k-major
  float b[2][SKS][B];      // P slabs, row-major
  uint64_t full[2];        // mbarriers: every thread's copies of the slab landed
  uint64_t empty[2];       // mbarriers: every thread done with the slab
};

// One tile of the engine: Q (B x K) at q with row stride ldq, P (K x B) at p
// with row stride ldp, C at c with row stride ldc; where m is not null, the
// tile's transpose also goes to m (row stride ldc).
struct EngineTile {
  const float* q;
  int64_t ldq;
  const float* p;
  int64_t ldp;
  float* c;
  float* m;
  int64_t ldc;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}"
      ::"r"(smem_u32(bar)) : "memory");
}

// arrive on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Copy k rows k0 .. k0 + SKS - 1 of tile t's Q and P into buffer ``buf``,
// asynchronously.
template <int B>
__device__ __forceinline__ void engine_stage(EngineSmem<B>& s, int buf,
                                             const EngineTile& t, int k0) {
  constexpr int NT = (B / 8) * (B / 8);
#pragma unroll
  for (int i = 0; i < B * SKS / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int g = e / 8, r = g % B, kk = (g / B) * 8 + e % 8;
    cp_async4(&s.a[buf][kk][r], t.q + (int64_t)r * t.ldq + k0 + kk);
  }
#pragma unroll
  for (int i = 0; i < SKS * (B / 4) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int kk = e / (B / 4), ch = e % (B / 4);
    cp_async16(&s.b[buf][kk][4 * ch],
               t.p + (int64_t)(k0 + kk) * t.ldp + 4 * ch);
  }
}

// acc = min(acc, Q (x) P) over the SKS k-steps of buffer buf
template <int B>
__device__ __forceinline__ void engine_slab(float (&acc)[8][8],
                                            const EngineSmem<B>& s, int buf) {
  constexpr int TN = B / 8, H = B / 2;
  const int tx = threadIdx.x % TN, ty = threadIdx.x / TN;
#pragma unroll
  for (int kk = 0; kk < SKS; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&s.a[buf][kk][ty * 4]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&s.a[buf][kk][H + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&s.b[buf][kk][tx * 4]);
    const float4 b1 =
        *reinterpret_cast<const float4*>(&s.b[buf][kk][H + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fminf(acc[i][j], a[i] + b[j]);
  }
}

// The thread's 8 x 8 block into the tile at c and, where m is not null, its
// transpose into the tile at m (both row stride ldc), with float4 stores
template <int B>
__device__ __forceinline__ void engine_store(const float (&acc)[8][8],
                                             float* c, float* m,
                                             int64_t ldc) {
  constexpr int TN = B / 8, H = B / 2;
  const int tx = threadIdx.x % TN, ty = threadIdx.x / TN;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = c + (int64_t)((i / 4) * H + ty * 4 + i % 4) * ldc;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + H + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (m == nullptr) return;
  // mirror[c][r] = tile[r][c]: column j of the thread's block is a row of
  // the mirror, and its rows ty*4 .. and H + ty*4 .. are that row's columns
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* row = m + (int64_t)((j / 4) * H + tx * 4 + j % 4) * ldc;
    *reinterpret_cast<float4*>(row + ty * 4) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(row + H + ty * 4) =
        make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
}

// One tile a CTA, ns slabs deep: FOLD_C, C = min(C, Q (x) P) in place (K =
// B: the whole-tile forms of the skew and window relax); else C = Q (x) P
// from +inf, C only written (the product).
template <int B, bool FOLD_C>
__device__ __forceinline__ void engine_tile(const EngineTile t, int ns,
                                            EngineSmem<B>& s) {
  constexpr int TN = B / 8, H = B / 2;
  const int tx = threadIdx.x % TN, ty = threadIdx.x / TN;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&s.full[b], TN * TN);
      mbar_init(&s.empty[b], TN * TN);
    }
  }
  __syncthreads();
  engine_stage<B>(s, 0, t, 0);
  mbar_arrive_copies(&s.full[0]);

  // C is folded in a few rows a slab (see above)
  constexpr int CR = FOLD_C ? 8 / (B / SKS) : 1;  // 1 at B 128, 2 at 64
  static_assert(!FOLD_C || CR * (B / SKS) == 8,
                "every row of C folded in exactly once");
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = __int_as_float(0x7f800000);

#pragma unroll 1
  for (int st = 0; st < ns; ++st) {
    const int buf = st & 1;
    float4 cv[CR][2];
    if constexpr (FOLD_C) {
#pragma unroll
      for (int h = 0; h < CR; ++h) {
        const int i = st * CR + h;
        const float* row =
            t.c + (int64_t)((i / 4) * H + ty * 4 + i % 4) * t.ldc;
        cv[h][0] = *reinterpret_cast<const float4*>(row + tx * 4);
        cv[h][1] = *reinterpret_cast<const float4*>(row + H + tx * 4);
      }
    }
    if (st + 1 < ns) {
      // slab st + 1 goes where slab st - 1 was: wait until every thread
      // is done with that one, then copy
      if (st >= 1) mbar_wait(&s.empty[buf ^ 1], ((st - 1) / 2) & 1);
      engine_stage<B>(s, buf ^ 1, t, (st + 1) * SKS);
      mbar_arrive_copies(&s.full[buf ^ 1]);
    }
    mbar_wait(&s.full[buf], (st / 2) & 1);
    engine_slab<B>(acc, s, buf);
    mbar_arrive(&s.empty[buf]);
    if constexpr (FOLD_C) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i / CR != st) continue;  // static indices: acc stays in registers
        const float4 lo = cv[i % CR][0], hi = cv[i % CR][1];
        acc[i][0] = fminf(acc[i][0], lo.x), acc[i][1] = fminf(acc[i][1], lo.y);
        acc[i][2] = fminf(acc[i][2], lo.z), acc[i][3] = fminf(acc[i][3], lo.w);
        acc[i][4] = fminf(acc[i][4], hi.x), acc[i][5] = fminf(acc[i][5], hi.y);
        acc[i][6] = fminf(acc[i][6], hi.z), acc[i][7] = fminf(acc[i][7], hi.w);
      }
    }
  }
  engine_store<B>(acc, t.c, t.m, t.ldc);
}

// A listed tile of a window relax, in place on the window at win (row
// stride ld): list row t = (i, j, mi, mj) is tile (i, j), Q its row tile i
// of q (contiguous, w x B) and P a column tile of p (B x w, row stride ldp):
// tile i + j - bt for the skewed band window (bt >= 0), tile j for the
// plain window (bt < 0); where mi >= 0, its transpose goes into tile (mi,
// mj).
template <int B>
__device__ __forceinline__ EngineTile list_tile(const int4 t, const float* q,
                                                const float* p, int64_t ldp,
                                                float* win, int64_t ld,
                                                int bt) {
  const int pj = bt < 0 ? t.y : t.x + t.y - bt;
  return {q + (int64_t)t.x * B * B, B, p + (int64_t)pj * B, ldp,
          win + (int64_t)t.x * B * ld + (int64_t)t.y * B,
          t.z < 0 ? nullptr : win + (int64_t)t.z * B * ld + (int64_t)t.w * B,
          ld};
}

// ---------------------------------------------------------------------------
// Phase 3 of the band-storage round (relax_skew_sym, relax_skew), in place on
// the (w, w) skewed window (w = (2 bt + 1) B for block B, row stride ld).
// Window tile (o, j) becomes min(C, Q_o (x) P_{o + j - bt}): Q_o is q's tile
// o (the snapshot of window tile (o, 2 bt - o), the pivot column; q is
// (w, B) and contiguous), P_t the pivot-row tile t of p (B x w, row stride
// ldp). The tiles to relax are listed in ``tiles`` as int4 (o, j, mo, mj):
// the tile and, where mo >= 0, the lower tile (mo, mj) that receives its
// transpose (the symmetric form's mirror). The wrapper builds the list once
// per (bt, form), so the grid holds live tiles only: 247 at bt 12
// symmetric (the upper wedge), 469 non-symmetric. At B = 128 each CTA owns
// one whole tile on the tile engine when the list holds at least half as
// many tiles as the card has SMs. A shorter list (small bt: 35 tiles at bt
// 4) would leave most SMs idle, so it is relaxed in 64x64 sub-tiles, four
// CTAs a tile, on the minplus_tile body, as B = 64 always is (a whole 64x64
// tile a CTA of 64 threads measured slower there at bt 3, mixed at bt 12).
// Only listed tiles are read, no listed tile is a mirror, and q and p lie
// apart from the window, so no CTA reads what another writes; every other
// tile keeps its value.

// A listed tile as 64x64 sub-tiles, one CTA of TPB threads each on the
// minplus_tile body, grid (tiles, (B / 64)^2): the form for a short list
// (small bt), where whole tiles would leave most SMs idle, and for B = 64.
// Sub-tile z of tile (o, j) goes transposed into sub-tile (z % subs,
// z / subs) of the mirror.
template <int B>
__device__ __forceinline__ void skew_subtile(const int4 t, const float* q,
                                             const float* p, int64_t ldp,
                                             float* win, int64_t ld, int bt) {
  __shared__ TileSmem s;
  __shared__ float tr[TILE][TILE + 1];
  constexpr int subs = B / TILE;
  const int si = blockIdx.y / subs, sj = blockIdx.y % subs;
  const int64_t r0 = (int64_t)t.x * B + si * TILE;
  const int64_t c0 = (int64_t)t.y * B + sj * TILE;
  const int64_t pc = (int64_t)(t.x + t.y - bt) * B + sj * TILE;
  float acc[MICRO][MICRO];
  load_acc(win + r0 * ld + c0, ld, acc);
  minplus_tile(q + r0 * B, B, p + pc, ldp, B, acc, s);
  store_acc(win + r0 * ld + c0, ld, acc);
  if (t.z < 0) return;
  const int64_t mr0 = (int64_t)t.z * B + sj * TILE;
  const int64_t mc0 = (int64_t)t.w * B + si * TILE;
  store_transposed(win + mr0 * ld + mc0, ld, acc, tr);
}

// The two forms under their own names, so that a profile tells them apart.
// WHOLE (B = 128 only): grid (tiles), (B / 8)^2 threads; else grid
// (tiles, (B / 64)^2), TPB threads.
template <int B, bool WHOLE>
__global__ void __launch_bounds__(WHOLE ? (B / 8) * (B / 8) : TPB, 2)
relax_skew_sym_kernel(const int4* tiles, const float* q, const float* p,
                      int64_t ldp, float* win, int64_t ld, int bt) {
  if constexpr (WHOLE) {
    __shared__ __align__(16) EngineSmem<B> s;
    engine_tile<B, true>(
        list_tile<B>(tiles[blockIdx.x], q, p, ldp, win, ld, bt), B / SKS, s);
  } else {
    skew_subtile<B>(tiles[blockIdx.x], q, p, ldp, win, ld, bt);
  }
}

template <int B, bool WHOLE>
__global__ void __launch_bounds__(WHOLE ? (B / 8) * (B / 8) : TPB, 2)
relax_skew_kernel(const int4* tiles, const float* q, const float* p,
                  int64_t ldp, float* win, int64_t ld, int bt) {
  if constexpr (WHOLE) {
    __shared__ __align__(16) EngineSmem<B> s;
    engine_tile<B, true>(
        list_tile<B>(tiles[blockIdx.x], q, p, ldp, win, ld, bt), B / SKS, s);
  } else {
    skew_subtile<B>(tiles[blockIdx.x], q, p, ldp, win, ld, bt);
  }
}

// Whole 128x128 tiles when the list holds at least half as many tiles as
// the current device has SMs (bt 8 and up on the H100's 132), else 64x64
// sub-tiles.
bool skew_whole_tiles(int n_tiles) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return 2 * n_tiles >= sms;
}

using SkewKernel = void (*)(const int4*, const float*, const float*, int64_t,
                            float*, int64_t, int);

// One skew form's launch over tiles, n_tiles int4 (o, j, mo, mj) on the
// device from the wrapper's list: whole tiles at block 128 where the list
// is long enough, else 64x64 sub-tiles.
int launch_skew(SkewKernel whole128, SkewKernel sub128, SkewKernel sub64,
                const int* tiles, int n_tiles, const float* q, const float* p,
                int64_t ldp, float* win, int64_t ld, int bt, int block,
                void* stream) {
  const int4* t = reinterpret_cast<const int4*>(tiles);
  const cudaStream_t st = (cudaStream_t)stream;
  if (block == 128 && skew_whole_tiles(n_tiles)) {
    whole128<<<n_tiles, 256, 0, st>>>(t, q, p, ldp, win, ld, bt);
  } else if (block == 128) {
    sub128<<<dim3(n_tiles, 4), TPB, 0, st>>>(t, q, p, ldp, win, ld, bt);
  } else if (block == 64) {
    sub64<<<n_tiles, TPB, 0, st>>>(t, q, p, ldp, win, ld, bt);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Phase 3 of the symmetric window round (relax_window_sym), in place on the
// (w, w) window at win (row stride ld): each listed upper tile (i, j) of
// ``tiles`` (int4 (i, j, mi, mj), as the skew lists: 0 <= j - i <=
// band_tiles, and (mi, mj) = (j, i) off the diagonal) becomes min(C, Q_i (x)
// P_j), Q_i the row tile i of q (w x block, contiguous) and P_j the column
// tile j of p (block x w, contiguous), and its transpose goes into tile
// (j, i). The wrapper builds the list once per (w / block, band_tiles), so
// no CTA starts for a tile outside the band. Only listed tiles are read, no
// listed tile is a mirror, and q and p lie apart from the window, so no CTA
// reads what another writes; every other tile keeps its value.
//
// What bounds it: the FP32 min, one a candidate, as for the engine; the
// work is block^3 candidates a listed tile (Example_1's window, w 1,024 at
// band_tiles 6: 35 tiles, 73 M candidates, 4.4 us at 16.7 T/s). Two forms,
// chosen by the wrapper (apsp_cuda.window_sym_whole) from the list's length:
//   - whole tiles on the tile engine, one CTA a tile (block 128), where
//     their waves of two CTAs an SM come out at least 90% full: the dense
//     FW's 528 tiles at 4,096 are two full waves on the H100;
//   - 32x32 sub-tiles on the panel body otherwise (Example_1's 35 whole
//     tiles would fill 35 of 132 SMs), one CTA of 128 threads each (560 at
//     Example_1, about four an SM, all resident at once): float4 operand
//     loads, 2 x 4 outputs a thread, the k slab copied by cp.async in
//     32-deep groups, all in flight at once and each relaxed as it lands
//     (panel_relax_chunked), so the CTAs, which start together, do not all
//     wait for their whole operands first (faster than one wait for the
//     slab). The mirror goes from registers, a thread's block as 4 rows of
//     two floats.
// Measured on the H100 at 35 to 528 tiles: sub-tiles faster at 35, 150,
// 297 and 408 tiles, whole tiles at 252 and 528, even at 338; a part-full
// last wave of whole tiles costs nearly a full one.

// grid (tiles, (block / 32)^2), PTPB threads: sub-tile (si, sj) of listed
// tile t, its transpose into sub-tile (sj, si) of the mirror.
__global__ void __launch_bounds__(PTPB)
relax_window_sym_sub_kernel(const int4* tiles, const float* q, const float* p,
                            float* win, int64_t ld, int w, int block) {
  __shared__ __align__(16) PanelSmem s;
  const int4 t = tiles[blockIdx.x];
  const int subs = block / PT;
  const int si = blockIdx.y / subs, sj = blockIdx.y % subs;
  const int64_t r0 = (int64_t)t.x * block + si * PT;
  const int64_t c0 = (int64_t)t.y * block + sj * PT;
  float acc[2][4];
  panel_load(win + r0 * ld + c0, ld, acc);
  panel_relax_chunked(q + r0 * block, block, p + c0, w, block, acc, s);
  panel_store(win + r0 * ld + c0, ld, acc);
  if (t.z < 0) return;
  // mirror[c][r] = sub-tile[r][c]: the thread's column 4 tx + j is a row of
  // the mirror, and its rows ty, ty + 16 are that row's columns
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  float* m = win + ((int64_t)t.z * block + sj * PT) * ld + (int64_t)t.w * block +
             si * PT;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* row = m + (int64_t)(4 * tx + j) * ld;
    row[ty] = acc[0][j];
    row[ty + 16] = acc[1][j];
  }
}

// grid (tiles), 256 threads: one whole 128x128 listed tile a CTA
__global__ void __launch_bounds__(256, 2)
relax_window_sym_kernel(const int4* tiles, const float* q, const float* p,
                        float* win, int64_t ld, int w) {
  __shared__ __align__(16) EngineSmem<128> s;
  engine_tile<128, true>(
      list_tile<128>(tiles[blockIdx.x], q, p, w, win, ld, -1), 128 / SKS,
      s);
}

// ---------------------------------------------------------------------------
// The min-plus product (minplus_product): out = A (x) B, (m, n) = (m, k) (x)
// (k, n), m and n multiples of 128, k of SKS (the wrapper pads with +inf).
// One 128x128 output tile a CTA on the tile engine with no C, grid (n / 128,
// m / 128), two CTAs an SM (at most 128 registers a thread, no spills): the
// 1,024 tiles of a 4,096^2 product are 3.9 waves of the H100's 264 slots.
// Measured on the H100 at 4096^3 and not kept: a persistent grid of two
// CTAs an SM walking the tiles, each staging the next tile's first slab
// before it stores the current one; one CTA an SM with more registers,
// persistent or not; the slabs brought in by bulk copies (the TMA unit,
// cp.async.bulk behind expect_tx mbarriers) issued by one warp, from an A
// transposed by the wrapper (all three slower); the copy addresses set up
// once a tile (no faster, with spills). With its copies and waits taken
// out, the slab loop alone measured only a little faster: the add and min
// issue, not the pipeline, is most of the gap to the bound.
__global__ void __launch_bounds__(256, 2)
minplus_product_kernel(const float* a, int64_t lda, const float* b,
                       int64_t ldb, float* out, int64_t ldo, int k) {
  __shared__ __align__(16) EngineSmem<128> s;
  const int64_t r0 = (int64_t)blockIdx.y * 128, c0 = (int64_t)blockIdx.x * 128;
  engine_tile<128, false>(
      EngineTile{a + r0 * lda, lda, b + c0, ldb, out + r0 * ldo + c0, nullptr,
                 ldo},
      k / SKS, s);
}

// ---------------------------------------------------------------------------
// A register-only probe of the FP32 add + min rate: each thread runs
// PROBE_CHAINS independent chains x = min(x, x + step), one FP32 add and
// one FP32 min a step, as a min-plus candidate is, with no memory access in
// the loop. Candidates issued = threads x PROBE_CHAINS x iters; the time of
// a launch over every SM gives the rate the min-plus kernels can reach.
constexpr int PROBE_CHAINS = 32;

__global__ void __launch_bounds__(256)
addmin_probe_kernel(float* out, float step, int iters) {
  float x[PROBE_CHAINS];
#pragma unroll
  for (int c = 0; c < PROBE_CHAINS; ++c) x[c] = threadIdx.x * 1e-3f + c;
#pragma unroll 4
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < PROBE_CHAINS; ++c) x[c] = fminf(x[c], x[c] + step);
  float m = x[0];
#pragma unroll
  for (int c = 1; c < PROBE_CHAINS; ++c) m = fminf(m, x[c]);
  out[(int64_t)blockIdx.x * blockDim.x + threadIdx.x] = m;
}

// Classic phase 3, in place: D = min(D, Q (x) P) over an (m, n) D with row
// stride ldd; grid (n / 64, m / 64). Q is (m, k), P is (k, n), both apart
// from D, so each block reads and writes only its own D tile and in place is
// safe. The banded form has a kernel of its own, below.
__global__ void __launch_bounds__(TPB)
relax_full_kernel(const float* q, int64_t ldq, const float* p, int64_t ldp,
                  float* d, int64_t ldd, int k) {
  __shared__ TileSmem s;
  const int64_t row0 = (int64_t)blockIdx.y * TILE;
  const int64_t col0 = (int64_t)blockIdx.x * TILE;
  float acc[MICRO][MICRO];
  load_acc(d + row0 * ldd + col0, ldd, acc);
  minplus_tile(q + row0 * ldq, ldq, p + col0, ldp, k, acc, s);
  store_acc(d + row0 * ldd + col0, ldd, acc);
}

// ---------------------------------------------------------------------------
// The banded classic relax (relax_full with band_tiles), in place on an
// (m, n) D (row stride ldd): each listed block-tile (i, j) of ``tiles``
// (int4 (i, j, -1, -1), every tile with |i - j| <= band_tiles, built once
// per (tile grid, band) by the wrapper, so no CTA starts outside the band)
// becomes min(D, Q_i (x) P_j), Q (m x block, row stride ldq) and P (block x
// n, row stride ldp) apart from D. Only listed tiles are read or written.
//
// What bounds it: the FP32 min, one a candidate (Example_1's window, w 1,024
// at band_tiles 6: 62 tiles, 130 M candidates, 7.8 us at 16.7 T/s).
// relax_full_kernel's body gives each 64x64 tile one CTA of 4 x 4 outputs a
// thread: 8 scalar shared loads for 16 candidates a k-step (the shared pipe
// saturates with the adds and mins), and no copy in flight while a CTA
// computes. Two forms here, chosen by the wrapper
// (apsp_cuda.full_banded_whole) from the list's length:
//   - 64x64 sub-tiles (relax_full_banded_sub_kernel), one CTA of two k
//     groups of 64 threads each (Example_1: 62 tiles, 248 CTAs, all
//     resident at once):
//     - a thread holds an 8 x 8 block of the sub-tile (rows ty*4 + {0..3}
//       and 32 + ty*4 + {0..3}, columns likewise from tx), the tile
//       engine's ratio: four float4 shared loads for 64 candidates a k-step;
//     - group g relaxes k-steps g block/2 .. (g + 1) block/2 - 1: it copies
//       its own Q rows (4 bytes at a time, transposed k-major, rows padded
//       to 68 floats: 32 banks a warp) and P columns (16 bytes at a time)
//       by cp.async in 8-deep copy groups, two in flight ahead of the
//       arithmetic, each relaxed as it lands behind a barrier of the
//       group's own 64 threads;
//     - the two partial minima meet in shared memory, where the operands
//       were; each thread loads its 32 values of C (coalesced 4-byte
//       loads, so D may have any row stride) while they are written, then
//       folds and stores (min is exact and order-free: the bits of
//       min(C, Q (x) P));
//   - whole 128x128 tiles on the tile engine, one CTA a tile
//     (relax_full_banded_whole_kernel), where their waves of two CTAs an SM
//     come out at least 90% full (every tile of a 4,096 window: 1,024).
// Measured on the H100 over the banded list at 62 to 1,024 tiles
// (chip_smoke.py's full relax forms line): sub-tiles fastest at 62 and 154
// tiles, the three forms level at 304, whole tiles fastest at 518 and
// 1,024; relax_window_sym's 32x32 sub-tiles over the same list never
// fastest. Not kept: four k groups (as fast at 62 tiles, slower from
// 154), 8 x 4 outputs a thread in 128-thread groups, copy groups of 4 or
// 16 k-steps or one for the whole slab, every copy group in flight at once,
// C loaded before the first wait (spills), a register barrier id (it
// reserves all 16 barriers), group 0 alone folding group 1's partial
// (faster from 154 tiles, slower at 62), and one CTA over two sub-tiles
// side by side that share Q (a little faster at 62, slower from 154). With
// the copies and the partial minima taken out, the 62-tile launch kept
// about four fifths of its time: most of the gap to the bound is the add
// and min issue and the start of a single wave, as for the other bodies.

constexpr int FT = 64;                   // output sub-tile edge
constexpr int FG = 2;                    // k groups a CTA
constexpr int FGT = 64;                  // threads a k group, 8 x 8 outputs each
constexpr int FKC = 64;                  // k-steps a group holds at once
constexpr int FSK = 8;                   // k-steps a copy group
constexpr int FCV = FT * FT / (FG * FGT);  // values of C a thread folds

struct FullGroupSmem {
  float a[FKC][FT + 4];  // Q rows, k-major
  float b[FKC][FT];      // P columns
};
constexpr int FULL_SMEM = FG * (int)sizeof(FullGroupSmem);  // 67,584 bytes
static_assert(FULL_SMEM >= FG * FT * FT * (int)sizeof(float),
              "the partial minima fit where the operands were");

// a barrier of k group g's 64 threads only; the barrier ids are
// immediates, so that the kernel holds three hardware barriers, not all
// sixteen that a register id reserves
static_assert(FG == 2, "one barrier id a k group");
__device__ __forceinline__ void group_sync(int g) {
  if (g == 0) asm volatile("bar.sync 1, %0;" ::"n"(FGT) : "memory");
  else asm volatile("bar.sync 2, %0;" ::"n"(FGT) : "memory");
}

// Copy k-steps k0 .. k0 + FSK - 1 of the group's Q rows (q, row stride ldq)
// and P columns (p, row stride ldp) into rows c .. c + FSK - 1 of its chunk,
// asynchronously; lt is the thread's index in the group.
__device__ __forceinline__ void full_stage(FullGroupSmem& s, int lt,
                                           const float* q, int64_t ldq,
                                           const float* p, int64_t ldp,
                                           int k0, int c) {
#pragma unroll
  for (int i = 0; i < FT * FSK / FGT; ++i) {
    const int e = lt + i * FGT;
    const int kk = e % FSK, r = e / FSK;  // 8 threads on 8 k of one row
    cp_async4(&s.a[c + kk][r], q + (int64_t)r * ldq + k0 + kk);
  }
#pragma unroll
  for (int i = 0; i < FSK * (FT / 4) / FGT; ++i) {
    const int e = lt + i * FGT;
    const int kk = e / (FT / 4), ch = e % (FT / 4);
    cp_async16(&s.b[c + kk][4 * ch], p + (int64_t)(k0 + kk) * ldp + 4 * ch);
  }
}

// acc = min(acc, Q (x) P) over rows c .. c + FSK - 1 of the group's chunk
__device__ __forceinline__ void full_steps(float (&acc)[8][8],
                                           const FullGroupSmem& s, int lt,
                                           int c) {
  const int tx = lt % 8, ty = lt / 8;
#pragma unroll
  for (int j = 0; j < FSK; ++j) {
    const int kk = c + j;
    const float4 a0 = *reinterpret_cast<const float4*>(&s.a[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&s.a[kk][32 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&s.b[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&s.b[kk][32 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fminf(acc[i][jj], a[i] + b[jj]);
  }
}

// grid (tiles, (k / 64)^2), FG * FGT threads, FULL_SMEM bytes of dynamic
// shared memory: sub-tile (y / subs, y % subs) of listed tile x, k = block
// (a multiple of 64); sub-tiles past m or n (a ragged last tile) return.
__global__ void __launch_bounds__(FG * FGT, 2)
relax_full_banded_sub_kernel(const int4* tiles, const float* q, int64_t ldq,
                             const float* p, int64_t ldp, float* d,
                             int64_t ldd, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char full_smem[];
  const int4 t = tiles[blockIdx.x];
  const int subs = k / FT;
  const int64_t r0 = (int64_t)t.x * k + (blockIdx.y / subs) * FT;
  const int64_t c0 = (int64_t)t.y * k + (blockIdx.y % subs) * FT;
  if (r0 >= m || c0 >= n) return;
  const int g = threadIdx.x / FGT, lt = threadIdx.x % FGT;

  FullGroupSmem& s = reinterpret_cast<FullGroupSmem*>(full_smem)[g];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = __int_as_float(0x7f800000);
  const int kq = k / FG;  // the group's k-steps: g kq .. (g + 1) kq - 1
  const float* qg = q + r0 * ldq + g * kq;
  const float* pg = p + (int64_t)g * kq * ldp + c0;
  for (int k0 = 0; k0 < kq; k0 += FKC) {
    const int kc = kq - k0 < FKC ? kq - k0 : FKC;  // 32 or 64
    if (k0 > 0) group_sync(g);  // the group is done with the last chunk
    // two copy groups in flight ahead of the arithmetic
    for (int c = 0; c < kc && c < 2 * FSK; c += FSK) {
      full_stage(s, lt, qg, ldq, pg, ldp, k0 + c, c);
      cp_async_commit();
    }
    for (int c = 0; c < kc; c += FSK) {
      if (c + 2 * FSK < kc) {
        full_stage(s, lt, qg, ldq, pg, ldp, k0 + c + 2 * FSK, c + 2 * FSK);
        cp_async_commit();
        cp_async_wait_pending(2);
      } else {
        cp_async_wait_pending(c + FSK < kc ? 1 : 0);
      }
      group_sync(g);
      full_steps(acc, s, lt, c);
    }
  }

  // the partial minima go where the operands were, once every group is
  // done with its operands
  __syncthreads();
  float(*red)[FT][FT] = reinterpret_cast<float(*)[FT][FT]>(full_smem);
  const int tx = lt % 8, ty = lt / 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = red[g][(i / 4) * 32 + ty * 4 + i % 4];
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 32 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  // C comes in while the other group writes its partial
  float* dt = d + r0 * ldd + c0;
  float cv[FCV];
#pragma unroll
  for (int e = 0; e < FCV; ++e) {
    const int idx = threadIdx.x + e * FG * FGT;
    cv[e] = dt[(int64_t)(idx / FT) * ldd + idx % FT];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < FCV; ++e) {
    const int idx = threadIdx.x + e * FG * FGT;
    const int r = idx / FT, c = idx % FT;
    float v = cv[e];
#pragma unroll
    for (int h = 0; h < FG; ++h) v = fminf(v, red[h][r][c]);
    dt[(int64_t)r * ldd + c] = v;
  }
}

// grid (tiles), 256 threads: one whole 128x128 listed tile a CTA on the tile
// engine (block 128, m and n multiples of it, q contiguous, d and p 16-byte
// aligned); q's row stride is the constant 128, which keeps the engine's
// registers within its two CTAs an SM (a runtime stride spilled)
__global__ void __launch_bounds__(256, 2)
relax_full_banded_whole_kernel(const int4* tiles, const float* q,
                               const float* p, int64_t ldp, float* d,
                               int64_t ldd) {
  __shared__ __align__(16) EngineSmem<128> s;
  engine_tile<128, true>(
      list_tile<128>(tiles[blockIdx.x], q, p, ldp, d, ldd, -1), 128 / SKS, s);
}

// In-tile Floyd-Warshall closure of one (B, B) tile, one CTA of B^2 / 32
// threads (512 at B = 128), k-sequential as the jnp fori_loop: step k sets
// t[i][j] = min(t[i][j], t[i][k] + t[k][j]) from row k and column k as they
// stood before the step. A blocked closure would reassociate path sums and
// change last bits, so the B dependent steps stay, on one SM.
//
// What bounds it: a step is 2 B^2 FP32 instructions on the SM's 128 lanes
// (256 cycles at B = 128), so B steps take at least 2 B^3 / 128 cycles on one
// SM, plus a barrier and a shared-memory round trip a step. The design keeps
// the shared-memory traffic well under the arithmetic: each thread holds an
// 8 x 4 block of the tile in registers (rows r0 .. r0 + 7, columns c0 ..
// c0 + 3; a warp covers 32 rows x 32 columns). After its update of step k,
// the threads holding row k + 1 store their four values of it with one
// float4 store, and those holding column k + 1 their eight with two, into
// the other half of a double buffer; after the step's one barrier every
// thread reads its values of the pre-step row and column with three float4
// loads. On the H100, blocks of 4 x 4, 4 x 8, 8 x 8 and 16 x 4 a thread
// measured slower at B = 128, and so did a split arrive / wait (an
// mbarrier each warp arrives on once row and column k + 1 are out, relaxing
// the rest of its block while the others arrive) in place of the barrier.

constexpr int CRM = 8;  // rows of the tile a thread holds
constexpr int CCN = 4;  // columns of the tile a thread holds
constexpr int CU = CRM > CCN ? CRM : CCN;  // steps unrolled together

template <int B>
constexpr int close_threads() { return B * B / (CRM * CCN); }

// Row k and column k from the threads that hold them into buffer half
// (k & 1); KK = k % CU.
template <int B, int KK>
__device__ __forceinline__ void close_publish(float (&v)[CRM][CCN], int k,
                                              int r0, int c0,
                                              float (*row_buf)[B],
                                              float (*col_buf)[B]) {
  if (k / CRM == r0 / CRM) {
#pragma unroll
    for (int j = 0; j < CCN; j += 4)
      *reinterpret_cast<float4*>(&row_buf[k & 1][c0 + j]) =
          make_float4(v[KK % CRM][j], v[KK % CRM][j + 1], v[KK % CRM][j + 2],
                      v[KK % CRM][j + 3]);
  }
  if (k / CCN == c0 / CCN) {
#pragma unroll
    for (int i = 0; i < CRM; i += 4)
      *reinterpret_cast<float4*>(&col_buf[k & 1][r0 + i]) =
          make_float4(v[i][KK % CCN], v[i + 1][KK % CCN], v[i + 2][KK % CCN],
                      v[i + 3][KK % CCN]);
  }
}

// Steps k .. k + CU - 1 from step KK on: relax the thread's block against
// the published pre-step row and column, publish row and column k + 1 into
// the other half (last read in step k - 1, before its barrier), then the
// step's barrier.
template <int B, int KK>
__device__ __forceinline__ void close_steps(float (&v)[CRM][CCN], int k,
                                            int r0, int c0,
                                            float (*row_buf)[B],
                                            float (*col_buf)[B]) {
  if constexpr (KK < CU) {
    float rv[CCN], cv[CRM];
#pragma unroll
    for (int j = 0; j < CCN; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(&row_buf[k & 1][c0 + j]);
      rv[j] = x.x, rv[j + 1] = x.y, rv[j + 2] = x.z, rv[j + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < CRM; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(&col_buf[k & 1][r0 + i]);
      cv[i] = x.x, cv[i + 1] = x.y, cv[i + 2] = x.z, cv[i + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < CRM; ++i)
#pragma unroll
      for (int j = 0; j < CCN; ++j) v[i][j] = fminf(v[i][j], cv[i] + rv[j]);
    close_publish<B, (KK + 1) % CU>(v, k + 1, r0, c0, row_buf, col_buf);
    __syncthreads();
    close_steps<B, KK + 1>(v, k + 1, r0, c0, row_buf, col_buf);
  }
}

template <int B>
__global__ void __launch_bounds__(B * B / (CRM * CCN))
close_diag_kernel(const float* tile, int64_t ldt, float* out) {
  __shared__ __align__(16) float row_buf[2][B];
  __shared__ __align__(16) float col_buf[2][B];
  // a warp: 4 x 8 threads, 4 CRM rows x 8 CCN columns of the tile
  constexpr int WC = B / (8 * CCN);  // warps across a row
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = 4 * CRM * (warp / WC) + CRM * (lane / 8);
  const int c0 = 8 * CCN * (warp % WC) + CCN * (lane % 8);
  float v[CRM][CCN];
#pragma unroll
  for (int i = 0; i < CRM; ++i)
#pragma unroll
    for (int j = 0; j < CCN; ++j)
      v[i][j] = tile[(int64_t)(r0 + i) * ldt + c0 + j];

  close_publish<B, 0>(v, 0, r0, c0, row_buf, col_buf);
  __syncthreads();
  for (int k = 0; k < B; k += CU)
    close_steps<B, 0>(v, k, r0, c0, row_buf, col_buf);
#pragma unroll
  for (int i = 0; i < CRM; ++i)
#pragma unroll
    for (int j = 0; j < CCN; j += 4)
      *reinterpret_cast<float4*>(out + (int64_t)(r0 + i) * B + c0 + j) =
          make_float4(v[i][j], v[i][j + 1], v[i][j + 2], v[i][j + 3]);
}

}  // namespace

// C entry points. Each launches on the given stream, allocates nothing and
// returns cudaGetLastError() (0 = launched). Shapes are checked by the
// Python wrappers: m, n, w multiples of 64 (of 32 for the panel relax, of
// 128 for the product); k multiple of 32 (of 64 for a banded relax_full, of
// 16 for the product); block 64 or 128; for every kernel but relax_full,
// 16-byte aligned operands with leading dimensions that are multiples of 4
// (for the banded relax_full, P only).
extern "C" {

int safepy_relax_panel(const float* a, int64_t lda, const float* b,
                       int64_t ldb, const float* c, int64_t ldc, float* out,
                       int64_t ldo, int m, int n, int k, void* stream) {
  const dim3 grid(n / PT, m / PT);
  relax_panel_kernel<<<grid, PTPB, 0, (cudaStream_t)stream>>>(
      a, lda, b, ldb, c, ldc, out, ldo, k);
  return (int)cudaGetLastError();
}

int safepy_relax_band_rows(const float* q, int64_t ldq, int64_t q_rs,
                           const float* p, int64_t ldp, int64_t p_rs,
                           const float* c, int64_t ldc, int64_t c_rs,
                           float* out, int64_t ldo, int64_t o_rs, int rows,
                           int m, int n, int k, void* stream) {
  const dim3 grid(n / PT, m / PT, rows);
  relax_band_row_kernel<<<grid, PTPB, 0, (cudaStream_t)stream>>>(
      q, ldq, q_rs, p, ldp, p_rs, c, ldc, c_rs, out, ldo, o_rs, k);
  return (int)cudaGetLastError();
}

// tiles: n_tiles int4 (i, j, mi, mj) on the device; whole: the tile-engine
// form (block 128), else 32x32 sub-tiles
int safepy_relax_window_sym(const int* tiles, int n_tiles, const float* q,
                            const float* p, float* d, int64_t ld, int64_t lo,
                            int w, int block, int whole, void* stream) {
  const int4* t = reinterpret_cast<const int4*>(tiles);
  const cudaStream_t st = (cudaStream_t)stream;
  float* win = d + lo * ld + lo;
  if (whole && block == 128) {
    relax_window_sym_kernel<<<n_tiles, 256, 0, st>>>(t, q, p, win, ld, w);
  } else if (!whole && (block == 128 || block == 64)) {
    const int subs = block / PT;
    relax_window_sym_sub_kernel<<<dim3(n_tiles, subs * subs), PTPB, 0, st>>>(
        t, q, p, win, ld, w, block);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int safepy_relax_skew_sym(const int* tiles, int n_tiles, const float* q,
                          const float* p, int64_t ldp, float* win, int64_t ld,
                          int bt, int block, void* stream) {
  return launch_skew(relax_skew_sym_kernel<128, true>,
                     relax_skew_sym_kernel<128, false>,
                     relax_skew_sym_kernel<64, false>, tiles, n_tiles, q, p,
                     ldp, win, ld, bt, block, stream);
}

int safepy_relax_skew(const int* tiles, int n_tiles, const float* q,
                      const float* p, int64_t ldp, float* win, int64_t ld,
                      int bt, int block, void* stream) {
  return launch_skew(relax_skew_kernel<128, true>,
                     relax_skew_kernel<128, false>,
                     relax_skew_kernel<64, false>, tiles, n_tiles, q, p, ldp,
                     win, ld, bt, block, stream);
}

// blocks x 256 threads of the probe; out holds one float a thread
int safepy_addmin_probe(float* out, float step, int iters, int blocks,
                        void* stream) {
  addmin_probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, step,
                                                                iters);
  return (int)cudaGetLastError();
}

int safepy_relax_full(const float* q, int64_t ldq, const float* p,
                      int64_t ldp, float* d, int64_t ldd, int m, int n, int k,
                      void* stream) {
  const dim3 grid(n / TILE, m / TILE);
  relax_full_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(q, ldq, p, ldp, d,
                                                            ldd, k);
  return (int)cudaGetLastError();
}

// tiles: n_tiles int4 (i, j, -1, -1) on the device; whole: the tile-engine
// form (block 128, m and n multiples of it, q contiguous, d 16-byte aligned
// with ldd % 4 == 0), else 64x64 sub-tiles (block a multiple of 64)
int safepy_relax_full_banded(const int* tiles, int n_tiles, const float* q,
                             int64_t ldq, const float* p, int64_t ldp,
                             float* d, int64_t ldd, int m, int n, int block,
                             int whole, void* stream) {
  const int4* t = reinterpret_cast<const int4*>(tiles);
  const cudaStream_t st = (cudaStream_t)stream;
  if (whole) {
    if (block != 128 || ldq != 128 || m % 128 || n % 128)
      return (int)cudaErrorInvalidValue;
    relax_full_banded_whole_kernel<<<n_tiles, 256, 0, st>>>(t, q, p, ldp, d,
                                                            ldd);
    return (int)cudaGetLastError();
  }
  if (block % FT) return (int)cudaErrorInvalidValue;
  // above 48 KB of shared memory only by this opt-in, once a device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        relax_full_banded_sub_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, FULL_SMEM);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const int subs = block / FT;
  relax_full_banded_sub_kernel<<<dim3(n_tiles, subs * subs), FG * FGT,
                                 FULL_SMEM, st>>>(t, q, ldq, p, ldp, d, ldd,
                                                  m, n, block);
  return (int)cudaGetLastError();
}

int safepy_minplus_product(const float* a, int64_t lda, const float* b,
                           int64_t ldb, float* out, int64_t ldo, int m, int n,
                           int k, void* stream) {
  const dim3 grid(n / 128, m / 128);
  minplus_product_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      a, lda, b, ldb, out, ldo, k);
  return (int)cudaGetLastError();
}

int safepy_close_diag(const float* tile, int64_t ldt, float* out, int block,
                      void* stream) {
  if (block == 128) {
    close_diag_kernel<128><<<1, close_threads<128>(), 0,
                             (cudaStream_t)stream>>>(tile, ldt, out);
  } else if (block == 64) {
    close_diag_kernel<64><<<1, close_threads<64>(), 0,
                            (cudaStream_t)stream>>>(tile, ldt, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
