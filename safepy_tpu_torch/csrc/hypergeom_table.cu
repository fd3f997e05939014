// The class table of the binary hypergeometric test in one launch, written
// for Hopper (sm_90a) behind a plain C interface that
// safepy_tpu_torch/native.py loads with ctypes.
//
// What it computes: safepy_tpu_torch/ops/hypergeom_table.py
// build_logsf_table, the (S_max, C, R) f32 table of threshold-nudged
// log sf(k; M, K, n) over the classes K = K_dist[c], the neighborhood sizes
// n = 0..R-1 and the counts k = S_max-1-s of slot s. It replaces no Pallas
// kernel: the JAX package builds the table with a jit'd lax.scan over the
// slots (safepy_tpu/ops/hypergeom_table.py:108), one fused program on the
// TPU. The port's torch version of that scan, _build_logsf_table_torch,
// stays the CPU path and the plain version this kernel is held to: it runs
// about 50 elementwise ops on (C, R) f64 tensors a slot, 256 slots a chunk,
// every one a launch paced by the host.
//
// What bounds it on the H100: the table is written once, 4 R S_max C bytes
// (67 MB at R = S_max = C = 256, 20 us at 3.35 TB/s), and the f64
// arithmetic of the live slots (hi - lo of a thread's S_max, two f64 logs
// and one division each) is of the same order at the card's f64 rate; but
// each (c, n) pair's slots form one serial recurrence that must round as
// the loop rounds, so a thread's chain of dependent f64 logs and divisions
// sets the time (PERF.md's kernel table). The design keeps everything in
// registers and the chain short:
//   * one thread a (class c, size n) pair, n fastest, so a warp's stores of
//     one slot are 128 contiguous bytes of table[s, c, :];
//   * the anchor log pmf(hi) and the recurrence's state (log pmf, the
//     mantissa tm and exponent te of T) live in the thread; slots above hi
//     (the sentinel) and at or below lo (0) are stores with no arithmetic;
//   * the anchor is computed once a warp, not once for each lane's hi;
//   * nothing is read but the thread's K, once.
//
// Bitwise equal to the torch loop run on the card: every operation that the
// torch code runs as an op of its own is one correctly rounded operation
// here (__dadd_rn, __dsub_rn, __dmul_rn, __ddiv_rn: nvcc contracts none of
// them into an FMA), in the torch code's order, with libdevice's log as
// torch's CUDA log uses it. Where torch on the card divides a tensor by a
// Python float it multiplies by the float's reciprocal (ATen's
// div_true_kernel_cuda with a CPU scalar), and so does this kernel:
// zi2 / 1680 and tm / 1e250. The NaN rules of torch's clamp, minimum and
// maximum are kept, so even the cells that the table masks agree.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// ln(1e250) and 0.5 ln(2 pi) as numpy computes them on the host
// (hypergeom_table._LN_RENORM, 0.5 * _LN_2PI)
constexpr double kRenorm = 1e250;
constexpr double kInvRenorm = 1.0 / 1e250;
constexpr double kLnRenorm = 0x1.1fd2b914f1517p+9;
constexpr double kHalfLn2Pi = 0x1.d67f1c864beb4p-1;
constexpr double kInv1680 = 1.0 / 1680.0;
// the stored f32 of impossible slots (k > support), float32(-1e30)
constexpr float kSentinel = -0x1.93e594p+99f;
// the smallest normal f32 (flush_subnormal's bound)
constexpr float kF32Tiny = 0x1p-126f;
constexpr int kThreads = 128;

// torch.clamp(v, max=0.0) / clamp(v, min=0.0) on the card: NaN passes
__device__ __forceinline__ double clamp_max0(double v) {
  return v != v ? v : fmin(v, 0.0);
}
__device__ __forceinline__ double clamp_min0(double v) {
  return v != v ? v : fmax(v, 0.0);
}
// torch.minimum / torch.maximum on the card: the first NaN wins
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ double nan_min(double a, double b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}

// hypergeom_table.log_factorial: ln(x!) by the Stirling series at z = x + 1
// shifted to z >= 17, the shift divided out with one log of the exactly
// accumulated product, op for op
__device__ double log_factorial(double x) {
  const double z = __dadd_rn(x, 1.0);
  const bool shift = z < 17.0;
  double prod = 1.0;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    prod = __dmul_rn(prod, shift ? __dadd_rn(z, (double)i) : 1.0);
  const double zb = shift ? __dadd_rn(z, 16.0) : z;
  // 1.0 / t is reciprocal(t) * 1.0 in torch: one correctly rounded division
  const double zi2 = __ddiv_rn(1.0, __dmul_rn(zb, zb));
  double a = __dsub_rn(1.0 / 1260.0, __dmul_rn(zi2, kInv1680));
  a = __dadd_rn(__dmul_rn(zi2, a), -1.0 / 360.0);
  a = __dadd_rn(1.0 / 12.0, __dmul_rn(zi2, a));
  const double series = __ddiv_rn(a, zb);
  double lg = __dmul_rn(__dsub_rn(zb, 0.5), log(zb));
  lg = __dadd_rn(__dsub_rn(lg, zb), kHalfLn2Pi);
  lg = __dadd_rn(lg, series);
  return __dsub_rn(lg, log(prod));
}

// log pmf(hi) = log [C(K,hi) C(M-K,n-hi) / C(M,n)], in the torch code's
// order of terms
__device__ double anchor_log_pmf(double K, double n, double hi, double M) {
  const double mk = __dsub_rn(M, K);
  double a = __dsub_rn(log_factorial(K), log_factorial(hi));
  a = __dsub_rn(a, log_factorial(__dsub_rn(K, hi)));
  a = __dadd_rn(a, log_factorial(mk));
  a = __dsub_rn(a, log_factorial(__dsub_rn(n, hi)));
  a = __dsub_rn(a, log_factorial(__dadd_rn(__dsub_rn(mk, n), hi)));
  double b = __dsub_rn(log_factorial(M), log_factorial(n));
  b = __dsub_rn(b, log_factorial(__dsub_rn(M, n)));
  return __dsub_rn(a, b);
}

// The stored f32 of one live slot: log sf = log pmf + log T, clamped at 0,
// rounded to f32 with subnormals flushed, nudged off the f32 threshold by
// the f64 decision
__device__ __forceinline__ float nudged(double log_pmf, double tm, int te,
                                        double log_thr, float thr32,
                                        float thr_lo32) {
  const double log_sf = clamp_max0(__dadd_rn(
      __dadd_rn(log_pmf, log(tm)), __dmul_rn((double)te, kLnRenorm)));
  float val32 = __double2float_rn(log_sf);
  if (fabsf(val32) < kF32Tiny) val32 = 0.0f;
  return log_sf < log_thr ? nan_min(val32, thr_lo32) : nan_max(val32, thr32);
}

// One thread a (c, n) cell of every slot, walking t = S_max-1-s down in
// three runs: the sentinel (t > hi, t > lo), the live slots (lo < t <= hi)
// and 0 (t <= lo), the torch loop's where precedence. The state starts as
// the loop's (log pmf 0, T = 1 x 1e250^0) and changes only at t <= hi: at
// t = hi the anchor resets it, below hi the recurrence steps it. The
// anchor is computed between the runs, where a warp's lanes meet, so a
// warp whose lanes have different hi pays it once; rho and log rho of a
// slot depend on t alone, so each is computed a slot ahead of the state.
// K_dist holds finite class totals.
__global__ void __launch_bounds__(kThreads)
    logsf_table_kernel(float* __restrict__ table,
                       const double* __restrict__ K_dist, int R, int S_max,
                       int64_t cells, double M, double log_thr, float thr32,
                       float thr_lo32) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= cells) return;
  const double K = K_dist[idx / R];
  const double n = (double)(int)(idx % R);
  const double lo = clamp_min0(__dsub_rn(__dadd_rn(n, K), M));
  const double hi = nan_min(K, n);
  const double mkn = __dsub_rn(__dsub_rn(M, K), n);
  float* out = table + idx;
  int s = 0;
  for (; s < S_max; ++s, out += cells) {
    const double t = (double)(S_max - 1 - s);
    if (lo >= t || hi >= t) break;
    *out = kSentinel;
  }
  double log_pmf = 0.0, tm = 1.0;
  int te = 0;
  if (s < S_max && hi == (double)(S_max - 1 - s) && lo < hi) {
    log_pmf = anchor_log_pmf(K, n, hi, M);
    *out = nudged(log_pmf, tm, te, log_thr, thr32, thr_lo32);
    ++s;
    out += cells;
  }
  // rho(t) = pmf(t+1) / pmf(t), an exact ratio of small integers
  auto rho_at = [&](double t) {
    const double num = __dmul_rn(__dsub_rn(K, t), __dsub_rn(n, t));
    const double den = __dmul_rn(__dadd_rn(t, 1.0),
                                 __dadd_rn(__dadd_rn(mkn, t), 1.0));
    return __ddiv_rn(num, den == 0.0 ? 1.0 : den);
  };
  double t = (double)(S_max - 1 - s);
  double rho = rho_at(t);
  double log_rho = log(rho > 0.0 ? rho : 1.0);
  for (; s < S_max && lo < t; ++s, out += cells) {
    log_pmf = __dsub_rn(log_pmf, log_rho);
    tm = __dadd_rn(1.0, __dmul_rn(rho, tm));
    if (tm > kRenorm) {
      tm = __dmul_rn(tm, kInvRenorm);
      te += 1;
    }
    t = __dsub_rn(t, 1.0);
    rho = rho_at(t);
    log_rho = log(rho > 0.0 ? rho : 1.0);
    *out = nudged(log_pmf, tm, te, log_thr, thr32, thr_lo32);
  }
  for (; s < S_max; ++s, out += cells) *out = 0.0f;
}

}  // namespace

extern "C" {

// table: (S_max, C, R) f32, contiguous; K_dist: (C,) f64, contiguous
int safepy_logsf_table(float* table, const double* K_dist, int R, int S_max,
                       int C, double M, double log_thr, float thr32,
                       float thr_lo32, void* stream) {
  const int64_t cells = (int64_t)C * R;
  const int64_t blocks = (cells + kThreads - 1) / kThreads;
  logsf_table_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      table, K_dist, R, S_max, cells, M, log_thr, thr32, thr_lo32);
  return (int)cudaGetLastError();
}

}  // extern "C"
