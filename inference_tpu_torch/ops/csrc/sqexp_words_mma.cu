// Probe P3: kernel B3's function with the squared distance's cross term from
// exact integer matmuls on the tensor cores, for Hopper (sm_90a), at any
// coordinate dimension d. One library per d (-DP3_D=<d>): every size below is
// fixed at compile time. Up to d = 411, where the smallest resident plan (16
// rows of words resident, one stage of 16 columns) still fits a block's
// shared memory, the resident kernel below; above, the wrapper builds the
// library with -DP3_STREAMED=1, whose kernel streams each class's K through
// shared memory in chunks (the end of this file's kernels).
//
// Replaces the Pallas kernel of benchmarks/df64_mxu_d2_experiment.py::
// _matvec_mxu_pallas (kernel :72-161, launched at :179). The plain PyTorch
// version is inference_tpu_torch/probes/df64_mxu_d2_experiment.py::
// _words_reference; the wrapper that launches this kernel is _launch_words in
// the same module.
//
// What it computes. Each coordinate is split on the host into NW = 7 integer
// words of 7 bits, u = sum_a q_a 2^(s - 7(a + 1)) with |q_a| <= 64 (s a global
// exponent from max |u|). With C_c[i, j] = sum_{a + b = c} q_a(i) . q_b(j),
// the class-c cross term, u_i . u_j = sum_{c < 7} C_c 2^(2s - 7(c + 2)) up to
// the dropped classes c >= 7, and
//   y_i = sum_j exp(m_i + m_j + S_ij 2^(2s - 56)) v_j,
//   S = sum_c C_c 2^(7 (6 - c)),   m = -|u|^2 / 2 in FP64.
// Operands: rows_a (n, KA) int8, the words of row i word-major (a d + k),
// zero beyond 7 d; cols_b (n, KB) int8, for each class c a slice of
// class_k(c) bytes (at class_off(c)) holding the words q_{c-a}(j) at a d + k
// for a <= c and zeros after, so that rows_a[i, :class_k(c)] . that slice
// = C_c[i, j]. KA and each class_k are multiples of 16 bytes.
//
// The cross term. Every C_c is a sum of mma.sync instructions of int8
// operands with int32 sums (|C_c| <= 7 d 2^12 < 2^31 up to d = 74,898), written by hand in
// PTX: m16n8k32 for each pair of 16-byte chunks of the class's K and
// m16n8k16 for an odd last one, 7 a 16 x 8 tile at d = 2 (all k16), 21 at
// d = 20. S needs up to 63 bits, and a 64-bit integer fold costs about 13
// integer instructions an entry, so S never forms: runs of classes whose
// sums fit int32 ("parts", part_fits: three at d = 2 and 20, four at d = 33-411)
// are combined in 32 bits as they leave the MMAs, each part is converted to
// double and added by one fma into the argument, the largest first, where
// m_i + m_j and the cross term cancel exactly inside the fma:
//   t = m_i + m_j;  t = fma(P_k, 2^(shift + 7 (6 - b_k)), t) for each part.
// The argument rounds at each part (the plain version rounds S once): a few
// units of its last place, below 1e-15 of sum_j |E_ij| |v_j| on the card.
// The exp of the argument, always <= 0, is exp_nonpos (a table of 64 and a
// degree-4 polynomial, 9 FP64 instructions against CUDA's 18, within 2.5e-15
// of it); an fma accumulates with v widened to double.
//
// What bounds it. Per entry 14 FP64 instructions, 25 flops (the add of the
// norms, three part fmas, the exp's 9, the accumulate): 2.4 ms at n = 53,248
// on the 132 SMs' FP64 lanes at 1.98 GHz. Beside them on other pipes: the
// parts' integer combines and conversions, the exp's integer work and table
// load, and the MMAs, 112 int8 MACs an entry at d = 2 and 608 at d = 20 (0.3
// and 1.7 ms at the dense int8 rate). On the H100 the MMAs do not hide under
// the FP64 work: timed without them the kernel ran 2.8 ms faster at d = 2 and
// 6.6 ms at d = 20 (PERF.md), an mma.sync costing about 20 cycles of its SM
// sub-partition whatever its K; wgmma (B from shared memory, every class in
// flight, one wait) ran slower still. So the tensor work, and not the FP64
// pipe, sets the time.
//
// The design. A block of 16 warps owns BM = 256 rows, 16 a warp (one m16
// tile, its A fragments in registers for short rows, KA <= 32, d <= 4, else
// read by ldmatrix at each use), their words resident in shared memory, and
// walks its split of the columns in tiles of TJ through a cp.async ring of
// STAGES buffers (the class words as 8-column core matrices that ldmatrix
// reads without bank conflicts, the norms and v). A warp takes a tile in
// 16 x 16 sub-tiles, 8 entries a thread, one a trip of the innermost loop:
// each class's MMAs (every offset and size a constant), the parts, the
// exps. The registers are held to 64 so that two blocks, 32 warps, share an
// SM and hide each other's latencies (a few spills; one block an SM of
// 115-128 registers ran up to 2% slower at d = 2 and 20, PERF.md); BM, TJ
// and STAGES follow from d to fit two blocks in the 228 KB of shared memory
// (choose_plan), one where two do not fit. The column range is split over blockIdx.y so that the blocks fill the
// SMs in whole waves (sqexp_words_mma_plan); the wrapper adds the splits.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef P3_D
#define P3_D 2
#endif
#ifndef P3_STREAMED
#define P3_STREAMED 0  // 1: the streamed kernel (any d), else the resident one
#endif

namespace {

constexpr int NW = 7;         // words per coordinate (df64_mxu_d2_experiment.py NW)
constexpr int D = P3_D;       // coordinate dimension of this library
constexpr int KS = 16;        // bytes of a K chunk: each class's K is a multiple
static_assert(D >= 1, "P3_D must be positive");

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
constexpr int KA = round_up(NW * D, KS);  // bytes of a row's words
// bytes of class c's words in a column, and where they start (a loop, not a
// recursion, so that a call with a constant c inlines to a constant)
__host__ __device__ constexpr int class_k(int c) { return round_up((c + 1) * D, KS); }
__host__ __device__ constexpr int class_off(int c) {
  int off = 0;
  for (int i = 0; i < c; ++i) off += class_k(i);
  return off;
}
constexpr int KB = class_off(NW);  // bytes of a column's words
constexpr int SA = round_up(KA, 32) + 16;  // a row's shared pitch: an odd multiple of 16 bytes
// A stage's column words in shared memory: for each 8 columns, KB / 16 core
// matrices of 8 columns x 16 bytes (128 contiguous bytes) along k, which
// ldmatrix reads without bank conflicts
constexpr int BGROUP = 8 * KB;  // bytes of 8 columns' words
__host__ __device__ constexpr int b_at(int col, int kbyte) {  // kbyte a multiple of 16
  return (col >> 3) * BGROUP + (kbyte >> 4) * 128 + (col & 7) * 16;
}

// The parts of S = sum_c C_c 2^(7 (6 - c)): runs of consecutive classes a..b
// whose P = sum_{c=a..b} C_c 2^(7 (b - c)) fits int32 for words of +-64
// (|C_c| <= (c + 1) d 2^12), taken greedily from class 0. Three parts at
// d = 2 and 20 (classes 0-2, 3-5, 6 and 0-2, 3-4, 5-6), four at d = 33-411.
constexpr bool part_fits(int a, int b) {
  double bound = 0.0;
  for (int c = a; c <= b; ++c) {
    double w = (c + 1.0) * D * 4096.0;
    for (int k = c; k < b; ++k) w *= 128.0;
    bound += w;
  }
  return bound < 2147483648.0;
}
constexpr int part_ends() {  // bit c set: class c ends a part
  int mask = 0;
  for (int a = 0; a < NW;) {
    int b = a;
    while (b + 1 < NW && part_fits(a, b + 1)) ++b;
    mask |= 1 << b;
    a = b + 1;
  }
  return mask;
}
constexpr int PART_ENDS = part_ends();
__host__ __device__ constexpr bool part_last(int c) { return (PART_ENDS >> c) & 1; }
__host__ __device__ constexpr bool part_first(int c) { return c == 0 || part_last(c - 1); }
__host__ __device__ constexpr int n_parts() {
  int n = 0;
  for (int c = 0; c < NW; ++c) n += part_last(c);
  return n;
}
static_assert(P3_STREAMED || (part_fits(0, 0) && part_fits(NW - 1, NW - 1)),
              "a class alone must fit int32");

#if !P3_STREAMED

// A's fragments live in registers where a row's words are short (KA <= 32,
// d <= 4), else ldmatrix reads them at each use: at d = 20 their 18
// registers spilled under the cap of 64, 14-26% slower (PERF.md)
constexpr bool AREG = KA <= 32;
constexpr int WARPS = 16;     // warps of a block at most: 16 x 16 rows
constexpr int MINB_ASKED = 2;  // blocks an SM that registers and shared memory leave room for

// dynamic shared memory of one block on the H100 when `blocks` share an SM
// (228 KB an SM, 1 KB of it reserved for each block)
__host__ __device__ constexpr int smem_max(int blocks) { return (233472 - 1024 * blocks) / blocks; }
// a stage of tj columns: their words, norms and v
__host__ __device__ constexpr int stage_bytes(int tj) { return tj * (KB + 8 + 4); }

struct Plan { int bm, tj, stages; };
// the most rows a block (sixteen warps of 16: fewest column re-reads), then
// the widest tile and the deepest ring that fit the shared memory of one of
// `blocks` blocks an SM
constexpr Plan choose_plan(int blocks) {
  const int tjs[7] = {64, 64, 32, 32, 16, 32, 16};
  const int sts[7] = {3, 2, 3, 2, 2, 1, 1};
  for (int bm = 16 * WARPS; bm >= 16; bm /= 2)
    for (int i = 0; i < 7; ++i)
      if (bm * SA + sts[i] * stage_bytes(tjs[i]) + 512 <= smem_max(blocks))
        return {bm, tjs[i], sts[i]};
  return {0, 0, 0};
}
// the blocks an SM asked for where a plan fits them, else one
constexpr int MINB = choose_plan(MINB_ASKED).bm > 0 ? MINB_ASKED : 1;
constexpr Plan PLAN = choose_plan(MINB);
constexpr int BM = PLAN.bm, TJ = PLAN.tj, STAGES = PLAN.stages;
static_assert(BM > 0, "no plan fits the shared memory");
constexpr int WARPS_M = BM / 16;  // one m16 tile of rows a warp
constexpr int WARPS_N = WARPS / WARPS_M < TJ / 16 ? WARPS / WARPS_M : TJ / 16;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int NSUB = TJ / 16 / WARPS_N;  // 16-column sub-tiles of a warp in one stage
constexpr int SMEM = BM * SA + STAGES * stage_bytes(TJ) + 512;  // + exp_nonpos's table
static_assert(WARPS_N * BM * 8 <= SMEM, "the row reduction reuses the shared memory");
constexpr int LAUNCH_SMEM = SMEM;  // dynamic shared bytes of a launch
constexpr int TILE_THREADS = 32, TILE_SMEM = 16 * SA + 16 * KB;  // the tile check's launch
constexpr bool TILE_FITS = true;  // the tile check's int32 class sums (|C_c| < 2^31 here)
#endif  // !P3_STREAMED
constexpr unsigned FULL_MASK = 0xffffffffu;

__constant__ double EXP2_64[64] = {
    1.0, 1.0108892860517005, 1.0218971486541166, 1.0330248790212284, 1.0442737824274138,
    1.0556451783605572, 1.0671404006768237, 1.0787607977571199, 1.0905077326652577,
    1.102382583307841, 1.1143867425958924, 1.1265216186082418, 1.1387886347566916,
    1.1511892299529827, 1.1637248587775775, 1.1763969916502812, 1.189207115002721,
    1.202156731452703, 1.215247359980469, 1.22848053610687, 1.241857812073484,
    1.255380757024691, 1.2690509571917332, 1.2828700160787783, 1.2968395546510096,
    1.3109612115247644, 1.3252366431597413, 1.339667524053303, 1.3542555469368927,
    1.3690024229745905, 1.383909881963832, 1.3989796725383112, 1.4142135623730951,
    1.42961333839197, 1.4451808069770467, 1.460917794180647, 1.4768261459394993,
    1.4929077282912648, 1.5091644275934228, 1.5255981507445384, 1.5422108254079407,
    1.559004400237837, 1.5759808451078865, 1.593142151342267, 1.6104903319492543,
    1.6280274218573478, 1.645755478153965, 1.6636765803267364, 1.681792830507429,
    1.7001063537185235, 1.718619298122478, 1.7373338352737062, 1.7562521603732995,
    1.7753764925265212, 1.7947090750031072, 1.8142521755003989, 1.8340080864093424,
    1.8539791250833855, 1.8741676341103, 1.8945759815869656, 1.9152065613971474,
    1.9360617934922943, 1.9571441241754002, 1.978456026387951};  // 2^(i / 64), rounded

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async of 16 bytes from device to shared memory, through the L2 only
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 16-byte matrices; lanes 8 m .. 8 m + 7 give matrix m's row addresses
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// two 8 x 16-byte matrices, from lanes 0-7 and 8-15
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// D (16 x 8, int32) += A (16 x 32, int8, row) . B (32 x 8, int8, col). Lane
// 4 g + t holds A[g][4t..], A[g + 8][4t..], A[g][16 + 4t..], A[g + 8][16 + 4t..]
// in a, B[4t..][g], B[16 + 4t..][g] in b0, b1, and D[g][2t], D[g][2t + 1],
// D[g + 8][2t], D[g + 8][2t + 1].
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the same with K = 16: a0, a1 and b0 as above
__device__ __forceinline__ void mma_s8_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// e^x for x <= 0: x = j ln2 / 64 + r with j = rint(64 x / ln2), |r| <= ln2 /
// 128, e^x = 2^(j >> 6) tab[j & 63] p(r) with tab[i] = 2^(i / 64) and p a
// degree-4 Chebyshev fit of e^r (max relative error 2.5e-15 with its
// rounding); below -708 x is taken as -708 (e^-708 = 3.3e-308) by the high
// word of the negative double, which grows with its magnitude. 9 FP64
// instructions against CUDA's exp's 18.
__device__ __forceinline__ double exp_nonpos(double x, const double* tab) {
  constexpr double SHIFTER = 6755399441055744.0;  // 1.5 2^52: kf - SHIFTER = rint
  x = __hiloint2double((int)min((unsigned)__double2hiint(x), 0xC0862000u), __double2loint(x));
  const double kf = fma(x, 92.33248261689366, SHIFTER);
  const double jf = kf - SHIFTER;
  double r = fma(jf, -0.010830424696249145, x);
  r = fma(jf, -3.623510646634843e-19, r);
  double p = 0.041666717577326616;
  p = fma(p, r, 0.16666697213067969);
  p = fma(p, r, 0.49999999999962674);
  p = fma(p, r, 0.9999999999977606);
  p = fma(p, r, 1.0);
  const int j = __double2loint(kf);
  const double y = p * tab[j & 63];
  return __hiloint2double(__double2hiint(y) + ((j >> 6) << 20), __double2loint(y));
}

#if !P3_STREAMED
using AFrags = uint32_t[KA / KS][2];  // the warp's A fragments, 16 bytes of k at a time

// the thread's ldmatrix row of A (the warp's m16 tile from row r16, k step 0)
// and of B (columns col0.., class 0, k step 0; k moves 8 bytes of shared
// memory per byte), matching mma_s8's fragments
__device__ __forceinline__ unsigned a_lane_addr(const int8_t* sa, int r16, int lane) {
  return smem_addr(sa + (r16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SA + (lane >> 4) * 16);
}
__device__ __forceinline__ unsigned b_lane_addr(const int8_t* sb, int col0, int lane) {
  return smem_addr(sb + b_at(col0 + (lane & 7) + (lane >> 4) * 8, ((lane >> 3) & 1) * 16));
}
// B's row for a K = 16 step (ldsm_x2: columns col0.. and col0 + 8..)
__device__ __forceinline__ unsigned b_lane_addr16(const int8_t* sb, int col0, int lane) {
  return smem_addr(sb + b_at(col0 + (lane & 15), 0));
}

// the warp's A fragments, 16 bytes of k at a time: a pair by ldsm_x4, an odd
// last one by ldsm_x2
__device__ __forceinline__ void load_a(AFrags& a, unsigned a_addr) {
#pragma unroll
  for (int k = 0; k < KA / KS; k += 2) {
    if (k + 1 < KA / KS) {
      uint32_t r[4];
      ldsm_x4(r, a_addr + k * KS);
      a[k][0] = r[0];
      a[k][1] = r[1];
      a[k + 1][0] = r[2];
      a[k + 1][1] = r[3];
    } else {
      ldsm_x2(a[k], a_addr + k * KS);
    }
  }
}

// a class index as a type, so that every size and offset of class C is a
// constant expression
template <int C>
struct Class {
  static constexpr int value = C;
};
template <class F, int... Cs>
__device__ __forceinline__ void each_class(F&& f, Class<Cs>...) {
  (f(Class<Cs>{}), ...);
}
static_assert(NW == 7, "each_class lists the 7 classes");

// The thread's 8 entries of a 16 x 16 sub-tile: entry i = 4 nt + e (n8 tile
// nt, fragment slot e) in row slot e / 2 (rows g, g + 8) and column slot
// 2 nt + e % 2. Each class's MMAs; P of each part, then t += P 2^(7 (6 - b))
// scale in FP64 in the part's order (the largest first, where the norms
// cancel exactly inside the fma); sink(c, C, P) sees the sums (the tile
// check's window).
template <class Sink>
__device__ __forceinline__ void sub_tile_args(double (&t)[8], const AFrags& areg, unsigned a_addr,
                                              unsigned b_addr, unsigned b16_addr, double scale,
                                              Sink sink) {
  int P[8];
  each_class([&](auto cls) {
    constexpr int c = decltype(cls)::value;
    constexpr int KC = class_k(c) / KS;            // 16-byte chunks of the class's K
    constexpr unsigned KB0 = class_off(c) * 8;     // shared bytes of its first chunk
    int C[2][4] = {};
    // class c's K in chunks of 16: m16n8k32 for each pair, m16n8k16 for an odd last
#pragma unroll
    for (int k = 0; k < KC; k += 2) {
      const unsigned kb = KB0 + k * KS * 8;
      if (k + 1 < KC) {
        uint32_t a[4], b[4];
        if constexpr (AREG) {
          a[0] = areg[k][0];
          a[1] = areg[k][1];
          a[2] = areg[k + 1][0];
          a[3] = areg[k + 1][1];
        } else {
          ldsm_x4(a, a_addr + k * KS);
        }
        ldsm_x4(b, b_addr + kb);
        mma_s8(C[0], a, b[0], b[1]);
        mma_s8(C[1], a, b[2], b[3]);
      } else {
        uint32_t a[2], b[2];
        if constexpr (AREG) {
          a[0] = areg[k][0];
          a[1] = areg[k][1];
        } else {
          ldsm_x2(a, a_addr + k * KS);
        }
        ldsm_x2(b, b16_addr + kb);
        mma_s8_k16(C[0], a[0], a[1], b[0]);
        mma_s8_k16(C[1], a[0], a[1], b[1]);
      }
    }
    constexpr double WEIGHT = (double)(1LL << (7 * (NW - 1 - c)));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int x = C[i >> 2][i & 3];
      if constexpr (part_first(c)) {
        P[i] = x;
      } else {
        P[i] = P[i] * 128 + x;
      }
      if constexpr (part_last(c)) t[i] = fma((double)P[i], scale * WEIGHT, t[i]);
    }
    sink(c, C, P);
  }, Class<0>{}, Class<1>{}, Class<2>{}, Class<3>{}, Class<4>{}, Class<5>{}, Class<6>{});
}

// a sub-tile's arguments and its 4 columns' v, between its MMAs and its exps
struct Args {
  double t[8];
  double cv[4];
};

// the exps of a sub-tile's 8 entries into the thread's 2 row sums
__device__ __forceinline__ void accumulate(double (&acc)[2], const Args& s, const double* tab) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i & 3) >> 1;
    acc[r] = fma(exp_nonpos(s.t[i], tab), s.cv[2 * (i >> 2) + (i & 1)], acc[r]);
  }
}

// the arguments of the sub-tile at column col0 of a stage
__device__ __forceinline__ void args_of(Args& s, const double (&rm)[2], const AFrags& areg,
                                        unsigned a_addr, const int8_t* sb, const double* sn,
                                        const float* sv, int col0, int lane, double scale) {
  const int t4 = lane & 3;
  double cn[4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const double2 nn = *reinterpret_cast<const double2*>(sn + col0 + nt * 8 + 2 * t4);
    const float2 vv = *reinterpret_cast<const float2*>(sv + col0 + nt * 8 + 2 * t4);
    cn[2 * nt] = nn.x;
    cn[2 * nt + 1] = nn.y;
    s.cv[2 * nt] = (double)vv.x;
    s.cv[2 * nt + 1] = (double)vv.y;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s.t[i] = rm[(i & 3) >> 1] + cn[2 * (i >> 2) + (i & 1)];
  sub_tile_args(s.t, areg, a_addr, b_lane_addr(sb, col0, lane), b_lane_addr16(sb, col0, lane),
                scale, [](int, const int (&)[2][4], const int (&)[8]) {});
}

__global__ void __launch_bounds__(THREADS, MINB)
sqexp_words_mma_kernel(const int8_t* __restrict__ rows_a, const int8_t* __restrict__ cols_b,
                       const double* __restrict__ norms, const float* __restrict__ v,
                       double scale, double* __restrict__ partial, int n, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* const sa = reinterpret_cast<int8_t*>(smem);
  unsigned char* const ring = smem + BM * SA;
  auto sb = [&](int buf) { return reinterpret_cast<int8_t*>(ring + buf * stage_bytes(TJ)); };
  auto sn = [&](int buf) {
    return reinterpret_cast<double*>(ring + buf * stage_bytes(TJ) + TJ * KB);
  };
  auto sv = [&](int buf) {
    return reinterpret_cast<float*>(ring + buf * stage_bytes(TJ) + TJ * KB + TJ * 8);
  };
  double* const tab = reinterpret_cast<double*>(ring + STAGES * stage_bytes(TJ));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  for (int i = tid; i < 64; i += THREADS) tab[i] = EXP2_64[i];  // seen after stage_begin(0)
  const int row_base = blockIdx.x * BM;
  const int rows_here = min(BM, n - row_base);
  const bool active = wm * 16 < rows_here;  // n is a multiple of 128: whole warps
  const int n_tiles = n / TJ;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_count = min(tiles_per_split, n_tiles - t_begin);

  auto load_stage = [&](int u) {  // tile t_begin + u into buffer u % STAGES
    const int buf = u % STAGES;
    const size_t j0 = (size_t)(t_begin + u) * TJ;
    int8_t* const b = sb(buf);
    // a warp copies 4 consecutive 16-byte chunks of 8 columns: 64 contiguous
    // bytes of each column read, 4 whole core matrices written
    for (int idx = tid; idx < TJ * (KB / 16); idx += THREADS) {
      const int grp = idx / (8 * (KB / 16)), rem = idx - grp * 8 * (KB / 16);
      const int col = grp * 8 + (rem & 7), ch = rem >> 3;
      cp_async16(b + b_at(col, ch * 16), cols_b + (j0 + col) * KB + ch * 16);
    }
    for (int idx = tid; idx < TJ / 2; idx += THREADS)
      cp_async16(sn(buf) + 2 * idx, norms + j0 + 2 * idx);
    for (int idx = tid; idx < TJ / 4; idx += THREADS) cp_async16(sv(buf) + 4 * idx, v + j0 + 4 * idx);
  };
  for (int idx = tid; idx < rows_here * (KA / 16); idx += THREADS) {
    const int r = idx / (KA / 16), ch = idx - r * (KA / 16);
    cp_async16(sa + r * SA + ch * 16, rows_a + (size_t)(row_base + r) * KA + ch * 16);
  }
  load_stage(0);
  cp_async_commit();
#pragma unroll
  for (int u = 1; u < STAGES - 1; ++u) {
    if (u < t_count) load_stage(u);
    cp_async_commit();
  }
  // stage u's copies landed and every warp is done with stage u - 1's buffer,
  // which then takes stage u + STAGES - 1
  auto stage_begin = [&](int u) {
    if constexpr (STAGES > 1) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (u + STAGES - 1 < t_count) load_stage(u + STAGES - 1);
      cp_async_commit();
    } else {
      if (u > 0) {
        __syncthreads();
        load_stage(u);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
    }
  };

  const int row0 = wm * 16;  // the warp's rows in the block; the thread's: row0 + g, + 8
  double rm[2], acc[2] = {0.0, 0.0};
#pragma unroll
  for (int r = 0; r < 2; ++r) rm[r] = active ? norms[row_base + row0 + g + 8 * r] : 0.0;
  const unsigned a_addr = a_lane_addr(sa, row0, lane);

  stage_begin(0);
  AFrags areg;
  if constexpr (AREG) load_a(areg, a_addr);
  // a stage at a time; in it the warp's NSUB sub-tiles of 16 columns, one a
  // trip of the innermost loop, which holds nothing else
  for (int u = 0; u < t_count; ++u) {
    if (u > 0) stage_begin(u);
    const int buf = u % STAGES;
    if (!active) continue;
#pragma unroll 1
    for (int j = 0; j < NSUB; ++j) {
      Args st;
      args_of(st, rm, areg, a_addr, sb(buf), sn(buf), sv(buf), (j * WARPS_N + wn) * 16, lane,
              scale);
      accumulate(acc, st, tab);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    acc[r] += __shfl_xor_sync(FULL_MASK, acc[r], 1);
    acc[r] += __shfl_xor_sync(FULL_MASK, acc[r], 2);
  }
  double* const out = partial + (size_t)blockIdx.y * n + row_base;
  if constexpr (WARPS_N == 1) {
    if (active && t4 == 0) {
      out[row0 + g] = acc[0];
      out[row0 + g + 8] = acc[1];
    }
  } else {
    // the warps of one row band add their column shares in a fixed order
    double* const red = reinterpret_cast<double*>(smem);
    __syncthreads();
    if (t4 == 0) {
      red[wn * BM + row0 + g] = acc[0];
      red[wn * BM + row0 + g + 8] = acc[1];
    }
    __syncthreads();
    for (int r = tid; r < rows_here; r += THREADS) {
      double s = 0.0;
      for (int w = 0; w < WARPS_N; ++w) s += red[w * BM + r];
      out[r] = s;
    }
  }
}

// one warp: the class sums C_c and the parts P of rows 0-31 and columns 0-15
// by the matvec's own staging, fragments and combine, two m16 tiles in turn,
// each staged alone (16 rows of words, as the matvec's smallest plan);
// out_c (7, 32, 16), out_p (n_parts, 32, 16)
__global__ void words_mma_tile_kernel(const int8_t* __restrict__ rows_a,
                                      const int8_t* __restrict__ cols_b, int* __restrict__ out_c,
                                      int* __restrict__ out_p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* const sa = reinterpret_cast<int8_t*>(smem);
  int8_t* const sb = sa + 16 * SA;  // 16 columns: two 8-column groups
  const int lane = threadIdx.x, g = lane >> 2, t4 = lane & 3;
  for (int idx = lane; idx < 16 * (KB / 16); idx += 32)
    cp_async16(sb + b_at(idx / (KB / 16), (idx % (KB / 16)) * 16), cols_b + idx * 16);
  for (int r16 = 0; r16 < 32; r16 += 16) {
    __syncwarp();
    for (int idx = lane; idx < 16 * (KA / 16); idx += 32)
      cp_async16(sa + (idx / (KA / 16)) * SA + (idx % (KA / 16)) * 16,
                 rows_a + (size_t)r16 * KA + idx * 16);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    const unsigned a_addr = a_lane_addr(sa, 0, lane);
    AFrags areg;
    if constexpr (AREG) load_a(areg, a_addr);
    auto at = [&](int i) {  // (row, column) of the thread's entry i
      return (r16 + g + 8 * ((i & 3) >> 1)) * 16 + (i >> 2) * 8 + 2 * t4 + (i & 1);
    };
    double t[8] = {};
    int p = 0;
    sub_tile_args(t, areg, a_addr, b_lane_addr(sb, 0, lane), b_lane_addr16(sb, 0, lane), 1.0,
                  [&](int c, const int (&C)[2][4], const int (&P)[8]) {
                    for (int i = 0; i < 8; ++i) out_c[c * 512 + at(i)] = C[i >> 2][i & 3];
                    if (part_last(c)) {
                      for (int i = 0; i < 8; ++i) out_p[p * 512 + at(i)] = P[i];
                      ++p;
                    }
                  });
  }
}

cudaError_t configure() {
  static cudaError_t rc = [] {
    cudaError_t e = cudaFuncSetAttribute(sqexp_words_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(words_mma_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TILE_SMEM);
    return e;
  }();
  return rc;
}

#else  // P3_STREAMED

// The streamed kernel, for any d (the wrapper takes it where the resident
// plan does not fit, d > 411). A block of 4 warps owns BM = 64 rows, 16 a
// warp, and walks its split of the columns in tiles of TJ = 16 columns, one
// 16 x 16 sub-tile a warp. For each tile and class it streams the class's K
// through shared memory in chunks of KCH bytes (the rows' words and the
// columns' class slice, zero-padded to the MMA's 32), an m16n8k32 pair a
// 32-byte step into int32 sums (below 2^21 a chunk), added into 64-bit class
// sums, so that no class sum can overflow at any d. S then forms exactly in
// two int64 words as in the plain version (S = hi 2^42 + lo, 0 <= lo <
// 2^42), rounds once to FP64, and t = fma(S, 2^shift, m_i + m_j) is the plain
// version's argument to the bit. No ring and no reuse of a row's words
// across tiles: the path is for correctness at any d, not for speed.
constexpr int BM = 64, TJ = 16, STAGES = 1, THREADS = 128;
constexpr bool AREG = false;
constexpr int KCH = 512;          // bytes of a K chunk
constexpr int PITCH = KCH + 16;   // a staged row's bytes: lane 4 g + t4 reads bank 4 g + t4
constexpr int LO_BITS = 7 * (NW - 1);  // S = hi 2^LO_BITS + lo
constexpr int SMEM = (BM + TJ) * PITCH + 512;  // static: the staged rows, columns, exp table
constexpr int LAUNCH_SMEM = 0;
constexpr int TILE_ROWS = 32, TILE_THREADS = 64, TILE_SMEM = 0;
// the tile check writes the class sums as int32: |C_c| <= 7 d 2^12
constexpr bool TILE_FITS = 7.0 * D * 4096.0 < 2147483648.0;

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The class sums of the warp's 16 x 16 sub-tile: rows r0.. of the `rows`
// staged from row_base, the TJ columns from col_base. For each class c, its
// sums C64[i] of entry i (row r0 + g + 8 ((i & 3) >> 1), column 8 (i >> 2) +
// 2 t4 + (i & 1), as the resident kernel's) go to f(c, C64). Every thread of
// the block calls it: the chunks are staged by all.
template <class F>
__device__ __forceinline__ void stream_classes(int8_t* sa, int8_t* sb, const int8_t* rows_a,
                                               const int8_t* cols_b, size_t row_base, int rows,
                                               size_t col_base, int r0, F&& f) {
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int8_t* const a = sa + (r0 + g) * PITCH + 4 * t4;
  const int8_t* const b = sb + g * PITCH + 4 * t4;
#pragma unroll 1
  for (int c = 0; c < NW; ++c) {
    const int kc = class_k(c), off = class_off(c);
    long long C64[8] = {};
#pragma unroll 1
    for (int k0 = 0; k0 < kc; k0 += KCH) {
      const int kk = min(KCH, kc - k0), k32 = round_up(kk, 32), chunks = k32 / 16;
      __syncthreads();  // every warp is done with the last chunk
      for (int idx = tid; idx < (rows + TJ) * chunks; idx += blockDim.x) {
        const int r = idx / chunks, ch = idx - r * chunks;
        const bool row = r < rows;
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (ch * 16 < kk)
          w = *reinterpret_cast<const uint4*>(
              row ? rows_a + (row_base + r) * KA + k0 + ch * 16
                  : cols_b + (col_base + r - rows) * KB + off + k0 + ch * 16);
        *reinterpret_cast<uint4*>((row ? sa + r * PITCH : sb + (r - rows) * PITCH) + ch * 16) = w;
      }
      __syncthreads();
      int C[2][4] = {};
      for (int k = 0; k < k32; k += 32) {
        const uint32_t af[4] = {ld32(a + k), ld32(a + 8 * PITCH + k), ld32(a + k + 16),
                                ld32(a + 8 * PITCH + k + 16)};
        mma_s8(C[0], af, ld32(b + k), ld32(b + k + 16));
        mma_s8(C[1], af, ld32(b + 8 * PITCH + k), ld32(b + 8 * PITCH + k + 16));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) C64[i] += C[i >> 2][i & 3];
    }
    f(c, C64);
  }
}

__global__ void __launch_bounds__(THREADS)
sqexp_words_mma_kernel(const int8_t* __restrict__ rows_a, const int8_t* __restrict__ cols_b,
                       const double* __restrict__ norms, const float* __restrict__ v,
                       double scale, double* __restrict__ partial, int n, int tiles_per_split) {
  __shared__ __align__(16) int8_t sa[BM * PITCH];
  __shared__ __align__(16) int8_t sb[TJ * PITCH];
  __shared__ double tab[64];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  for (int i = tid; i < 64; i += THREADS) tab[i] = EXP2_64[i];  // seen after the first chunk
  const int row_base = blockIdx.x * BM, row0 = warp * 16;
  const int n_tiles = n / TJ;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_count = min(tiles_per_split, n_tiles - t_begin);
  double rm[2], acc[2] = {0.0, 0.0};
#pragma unroll
  for (int r = 0; r < 2; ++r) rm[r] = norms[row_base + row0 + g + 8 * r];
  for (int u = 0; u < t_count; ++u) {
    const int col0 = (t_begin + u) * TJ;
    long long hi[8] = {}, lo[8] = {};
    stream_classes(sa, sb, rows_a, cols_b, row_base, BM, col0, row0,
                   [&](int c, const long long (&C)[8]) {
                     // C_c 2^(42 - 7 c): floor(C_c / 2^(7 c)) into hi, the rest into lo
                     const int low = 7 * c;
#pragma unroll
                     for (int i = 0; i < 8; ++i) {
                       const long long q = C[i] >> low;
                       hi[i] += q;
                       lo[i] += (C[i] - q * (1LL << low)) << (LO_BITS - low);
                     }
                   });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = col0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const long long carry = lo[i] >> LO_BITS;
      const double S = fma((double)(hi[i] + carry), 4398046511104.0 /* 2^42 */,
                           (double)(lo[i] - carry * (1LL << LO_BITS)));
      const double t = fma(S, scale, rm[(i & 3) >> 1] + norms[col]);
      acc[(i & 3) >> 1] = fma(exp_nonpos(t, tab), (double)v[col], acc[(i & 3) >> 1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    acc[r] += __shfl_xor_sync(FULL_MASK, acc[r], 1);
    acc[r] += __shfl_xor_sync(FULL_MASK, acc[r], 2);
  }
  double* const out = partial + (size_t)blockIdx.y * n + row_base;
  if (t4 == 0) {
    out[row0 + g] = acc[0];
    out[row0 + g + 8] = acc[1];
  }
}

// two warps: the class sums C_c and the parts P of rows 0-31 and columns
// 0-15 by the streamed kernel's own staging and fragments; out_c (7, 32,
// 16), out_p (n_parts, 32, 16)
__global__ void __launch_bounds__(TILE_THREADS)
words_mma_tile_kernel(const int8_t* __restrict__ rows_a, const int8_t* __restrict__ cols_b,
                      int* __restrict__ out_c, int* __restrict__ out_p) {
  __shared__ __align__(16) int8_t sa[TILE_ROWS * PITCH];
  __shared__ __align__(16) int8_t sb[TJ * PITCH];
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  auto at = [&](int i) {  // (row, column) of the thread's entry i
    return (row0 + g + 8 * ((i & 3) >> 1)) * 16 + (i >> 2) * 8 + 2 * t4 + (i & 1);
  };
  int P[8], p = 0;
  stream_classes(sa, sb, rows_a, cols_b, 0, TILE_ROWS, 0, row0,
                 [&](int c, const long long (&C)[8]) {
                   for (int i = 0; i < 8; ++i) {
                     out_c[c * 512 + at(i)] = (int)C[i];
                     P[i] = part_first(c) ? (int)C[i] : P[i] * 128 + (int)C[i];
                   }
                   if (part_last(c)) {
                     for (int i = 0; i < 8; ++i) out_p[p * 512 + at(i)] = P[i];
                     ++p;
                   }
                 });
}

cudaError_t configure() { return cudaSuccess; }  // static shared memory below 48 KB

#endif  // P3_STREAMED

}  // namespace

// The launch plan of this library for n rows on the current device: out =
// {d, BM, TJ, STAGES, threads, shared bytes, blocks per SM, splits, KA, KB,
// parts of S, A in registers}.
// splits divides the column tiles evenly and, of those that do, takes the
// fewest waves of blocks times tiles per block (one tile more for a split's
// fill). Returns the CUDA error code (0 on success).
extern "C" int sqexp_words_mma_plan(int n, int* out) {
  if (n < 128 || n % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t rc = configure();
  int dev = 0, sms = 0, per_sm = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sqexp_words_mma_kernel, THREADS,
                                                       LAUNCH_SMEM);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = n / TJ, row_blocks = (n + BM - 1) / BM;
  const long long slots = (long long)sms * per_sm;
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= n_tiles && s <= 65535; ++s) {
    const int tps = (n_tiles + s - 1) / s;
    if ((n_tiles + tps - 1) / tps != s) continue;
    const long long waves = ((long long)row_blocks * s + slots - 1) / slots;
    const long long cost = waves * (tps + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  const int plan[12] = {D,  BM, TJ, STAGES, THREADS, SMEM, per_sm, best, KA, KB,
                        P3_STREAMED ? 0 : n_parts(), AREG};
  for (int i = 0; i < 12; ++i) out[i] = plan[i];
  return 0;
}

// partial (splits, n) = the column splits' sums of exp(m_i + m_j + S_ij
// 2^shift) v_j, on `stream`, with rows_a (n, KA) and cols_b (n, KB) int8,
// norms (n,) FP64, v (n,) float32; n a multiple of 128, d this library's,
// splits one that divides the column tiles evenly (sqexp_words_mma_plan's).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sqexp_words_mma(const void* rows_a, const void* cols_b, const void* norms,
                               const void* v, void* partial, int shift, int n, int d, int splits,
                               void* stream) {
  if (d != D || n < 128 || n % 128 != 0 || shift < -1000 || shift > 1000)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = n / TJ;
  if (splits < 1 || splits > n_tiles || splits > 65535) return (int)cudaErrorInvalidValue;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  if ((n_tiles + tiles_per_split - 1) / tiles_per_split != splits)
    return (int)cudaErrorInvalidValue;
  const cudaError_t rc = configure();
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((n + BM - 1) / BM, splits);
  sqexp_words_mma_kernel<<<grid, THREADS, LAUNCH_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(rows_a), static_cast<const int8_t*>(cols_b),
      static_cast<const double*>(norms), static_cast<const float*>(v), ldexp(1.0, shift),
      static_cast<double*>(partial), n, tiles_per_split);
  return (int)cudaGetLastError();
}

// out_c (7, 32, 16) and out_p (n_parts, 32, 16) int32 = the class sums C_c and
// the parts P of rows 0-31 and columns 0-15 (n >= 32), by one warp of the
// matvec's own staging, fragments and combine: the layout's check.
extern "C" int words_mma_tile(const void* rows_a, const void* cols_b, void* out_c, void* out_p,
                              int n, int d, void* stream) {
  if (d != D || n < 32 || !TILE_FITS) return (int)cudaErrorInvalidValue;
  const cudaError_t rc = configure();
  if (rc != cudaSuccess) return (int)rc;
  words_mma_tile_kernel<<<1, TILE_THREADS, TILE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(rows_a), static_cast<const int8_t*>(cols_b),
      static_cast<int*>(out_c), static_cast<int*>(out_p));
  return (int)cudaGetLastError();
}
