// Kernels B6 and B8: the product of the stored squared-exponential entries
// with a block of right-hand sides, accumulated in native FP64, for Hopper
// (sm_90a).
//
// B6 replaces inference_tpu/ops/df64.py::_stored_matmat_kernel (launched by
// _sqexp_stored_matmat_pallas), which contracted a float32-pair entry store
// with pair products and compensated sums because the TPU has no float64.
// Here the store is kernel B5's FP64 (n, n) matrix and the sums are FP64. B8
// replaces _stored_f32_matmat_kernel (launched by
// _sqexp_stored_f32_matmat_pallas), which contracted kernel B7's float32 store
// with exact Dekker products and compensated pair sums: here a float32 entry
// times a float32 right-hand side, both widened to double, is exact (24 + 24
// significant bits fit in FP64's 53), and the sums are FP64. Both kernels are
// launched by inference_tpu_torch/ops/df64.py::_launch_stored; their plain
// PyTorch version is _stored_reference in the same module.
//
// What it computes. For E (n_rows, n_cols), FP64 (B6) or float32 (B8),
// row-major, and float32 right-hand sides v (n_cols, q), 1 <= q <= 16:
//   y[p, i, c] = sum_{j in part p} E[i, j] * v[j, c]
// for each part p of the columns (the two column halves of every stage of
// every split of the launch); the wrapper sums the parts.
//
// What bounds it on this card. The read of E, once per launch for all q
// columns: at n = 53,248, 22.7 GB (B6) or 11.3 GB (B8), 6.8 or 3.4 ms at
// 3.35 TB/s. The FP64 work, 2 q n^2 flops, stays under that bound for
// q <= 16 on the FP64 tensor cores (67 TFLOP/s).
//
// What the design does about it.
// - A ring of STAGES tiles of E in shared memory, each BM = 32 rows of 1 KiB
//   (128 doubles or 256 floats). One producer warp keeps it full with TMA
//   copies through a 2D tensor map of E, eight boxes of 4 rows a stage, that
//   complete on the stage's "full" mbarrier with their byte count; the
//   consumer warps release a stage on its "empty" mbarrier. No
//   __syncthreads in the steady state, and the bytes in flight cost no
//   registers. E's lines are marked evict-first in L2, which keeps the
//   partial sums there. (On the H100 these boxes stream E faster than
//   cp.async.bulk copies of 1 KiB row segments, or of whole 32 KiB rows.)
// - The launch is a grid of (row groups, column splits), one block per SM. A
//   block owns a contiguous range of rows and a split of column tiles, which
//   it walks in panels of up to `panel` columns. The rows, the splits and the
//   panel width are the wrapper's plan (df64.py stored_plan), which the
//   kernel takes as given and the launcher checks. A stager warp widens each
//   panel's rows of v to double once, into one of two panel buffers, while
//   the consumers work on the other, so v is read from L2 once per block
//   and panel, not once per 64 rows, and no one waits for it.
// - Four consumer warps, each 16 rows by one column half of a stage,
//   contract it with v on the FP64 tensor cores, mma.sync m16n8k4 (one or
//   two 8-column n-tiles; q < 8 pads v with zero columns). The contraction
//   order of k is free, so lane (g, t) reads 4 adjacent entries of rows g
//   and g + 8 per 16-column chunk (128-bit shared loads, ordered so that a
//   quarter warp hits 8 distinct banks) and feeds them to 4 MMAs; v's panel
//   is staged in exactly that fragment order, so its B fragments are two
//   128-bit loads per chunk and n-tile. A float32 entry is widened to
//   double on the way, which is exact.
// - Each warp keeps its sums over a row tile of a panel and writes them to
//   its own plane of the partial sums, added to what earlier panels left,
//   which it loaded when the row tile began: no sum crosses warps or
//   blocks, and no flush waits on memory.
// - sqexp_stored_mma_tile runs one m16n8k4 MMA with the kernel's fragment
//   mapping on a 16 x 4 by 4 x 8 tile, so the layout can be checked alone.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 3;
constexpr int BM = 32;                    // rows per stage
constexpr int BOX_ROWS = 4;               // rows per TMA box: 8 boxes of 1 KiB rows a stage
constexpr int CONSUMERS = 4;              // consumer warps: 16 rows x half a stage each
constexpr int PRODUCER = CONSUMERS;       // the warp that keeps the ring full
constexpr int STAGER = CONSUMERS + 1;     // the warp that stages v's panels
constexpr int THREADS = 32 * (CONSUMERS + 2);
constexpr int PANEL_BYTES = 64 * 1024;    // shared memory of one of v's two panel buffers
constexpr int TILE_COLS = 128;            // column tile of the splits (df64.py _TJ)
constexpr int MAX_GRID = 256;             // row groups, and column splits, of a launch

// The wrapper's plan of a launch: row group r owns rows [rows[r], rows[r + 1]),
// column split s the columns [cols[s], cols[s + 1]), walked in panels of
// `panel` columns of v.
struct Plan {
  int rows[MAX_GRID + 1];
  int cols[MAX_GRID + 1];
  int panel;
};

template <typename TE> struct Layout;
// BK columns (1 KiB of a row) per stage, rows dense as the TMA writes them
template <> struct Layout<double> {
  static constexpr int BK = 128;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
};
template <> struct Layout<float> {
  static constexpr int BK = 256;
  static constexpr CUtensorMapDataType TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// ---- shared-memory barriers and TMA copies (PTX) ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// copy the box of E at (column col, row row) to shared `dst` by the TMA,
// completing on `bar`. E is read once per launch, so its lines are marked
// first to leave L2 (`policy`), which keeps the partial sums there.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int col, int row,
                                        uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_addr(bar)),
      "l"(policy)
      : "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// D (16 x 8) += A (16 x 4) B (4 x 8) on the FP64 tensor cores. Lane (g, t) =
// (lane / 4, lane % 4) holds a0 = A[g][t], a1 = A[g + 8][t], b0 = B[t][g];
// d0, d1 = D[g][2t], D[g][2t + 1] and d2, d3 the same of row g + 8.
__device__ __forceinline__ void mma_16x8x4(double (&d)[4], double a0, double a1, double b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// A lane's fragment entries of one row for two consecutive 16-column chunks
// of a stage, `p` pointing at its first entry. Stage rows are 1 KiB apart,
// so the lanes of a quarter warp (rows g and g + 1, t = 0..3) would read the
// same banks; lanes of odd g read their two 16-byte words (double) or two
// chunks (float) in the other order, which puts the quarter warp's 8 words
// of each load in 8 distinct banks.
__device__ __forceinline__ void load_pair(const double* p, int odd, double (&x)[2][4]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const double2* w = reinterpret_cast<const double2*>(p + 16 * c);
    const double2 a = w[odd], b = w[odd ^ 1];
    const double2 lo = odd ? b : a, hi = odd ? a : b;
    x[c][0] = lo.x; x[c][1] = lo.y; x[c][2] = hi.x; x[c][3] = hi.y;
  }
}
__device__ __forceinline__ void load_pair(const float* p, int odd, float (&x)[2][4]) {
  const float4 a = *reinterpret_cast<const float4*>(p + 16 * odd);
  const float4 b = *reinterpret_cast<const float4*>(p + 16 * (odd ^ 1));
  const float4 c0 = odd ? b : a, c1 = odd ? a : b;
  x[0][0] = c0.x; x[0][1] = c0.y; x[0][2] = c0.z; x[0][3] = c0.w;
  x[1][0] = c1.x; x[1][1] = c1.y; x[1][2] = c1.z; x[1][3] = c1.w;
}

// four adjacent entries from shared memory, by 128-bit loads
__device__ __forceinline__ void load4(const double* p, double (&x)[4]) {
  const double2 lo = reinterpret_cast<const double2*>(p)[0];
  const double2 hi = reinterpret_cast<const double2*>(p)[1];
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}

// ---- the consumer ----
// Consumer warp w owns rows [16 (w % 2), 16 (w % 2) + 16) of a stage and its
// column half h = w / 2. A stage holds `ncols` columns (a multiple of 128,
// at most BK: a float32 panel's last stage can be half full) starting at
// column `lc` of v's panel. Each warp keeps the sums of its rows and half
// over a row tile of a panel and, at flush(), writes them to its own plane of
// the partial sums, added to what earlier panels left there: begin() loads
// that at the start of the row tile, so no flush waits on memory and no sum
// crosses warps.
//
// NT n-tiles of 8 right-hand-side columns. v's panel holds, for each
// 16-column chunk and n-tile, lane-major groups of 4 doubles: lane (g, t)'s
// B fragments v[4t + k][8 nt + g] for its 4 MMAs k = 0..3. Two accumulator
// sets (even and odd chunks) halve the dependent MMA chain.
template <int NT>
struct MmaConsumer {
  double acc[2][NT][4];

  // where v[j][c] of the panel goes
  __device__ static int slot(int j, int c) {
    return (((j >> 4) * NT + (c >> 3)) * 32 + ((c & 7) << 2) + ((j >> 2) & 3)) * 4 + (j & 3);
  }

  double old[NT][4];  // the plane's sums of earlier panels, loaded at begin()

  // zero the sums of the 16 rows from `row` and load what earlier panels
  // left in out (first = none), to be added at flush()
  __device__ void begin(const double* out, int row, int row_end, int q, int lane, bool first) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = row + g + 8 * (k >> 1), c = 8 * nt + 2 * t + (k & 1);
        acc[0][nt][k] = acc[1][nt][k] = 0.0;
        old[nt][k] = first || r >= row_end || c >= q ? 0.0 : out[(size_t)r * q + c];
      }
  }

  template <typename TE>
  __device__ void consume(const TE* stage, const double* sv, int lc, int ncols, int warp,
                          int lane) {
    constexpr int HALF = Layout<TE>::BK / 2, STRIDE = Layout<TE>::BK;
    const int col = (warp >> 1) * HALF;
    if (col >= ncols) return;
    const int g = lane >> 2, t = lane & 3;
    const TE* a_lo = stage + (16 * (warp & 1) + g) * STRIDE + col + 4 * t;
    const TE* a_hi = a_lo + 8 * STRIDE;
    const double* b = sv + (size_t)((lc + col) / 16) * NT * 128 + 4 * lane;
#pragma unroll
    for (int ch = 0; ch < HALF / 16; ch += 2) {
      TE x0[2][4], x1[2][4];
      load_pair(a_lo + 16 * ch, g & 1, x0);
      load_pair(a_hi + 16 * ch, g & 1, x1);
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          double y[4];
          load4(b + ((ch + c) * NT + nt) * 128, y);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            mma_16x8x4(acc[c][nt], (double)x0[c][k], (double)x1[c][k], y[k]);
        }
    }
  }

  // write the 16 rows' sums, added to old, to out[row][c] for rows < row_end
  __device__ void flush(double* out, int row, int row_end, int q, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = row + g + 8 * (k >> 1), c = 8 * nt + 2 * t + (k & 1);
        if (r < row_end && c < q)
          out[(size_t)r * q + c] = old[nt][k] + (acc[0][nt][k] + acc[1][nt][k]);
      }
  }
};

// v's rows [p0, p0 + pw) into a panel buffer, widened to double, by the
// stager warp: 16-byte loads of the contiguous rows, eight in flight per
// lane, each value written to the consumer's slot
template <int NT>
__device__ void stage_v(double* sv, const float* v, int p0, int pw, int q, int lane) {
  constexpr int BATCH = 8, STEP = 32;
  const float4* src = reinterpret_cast<const float4*>(v + (size_t)p0 * q);
  const int n4 = pw * q / 4;
  for (int f0 = lane; f0 < n4; f0 += BATCH * STEP) {
    float4 buf[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
      if (f0 + b * STEP < n4) buf[b] = __ldg(src + f0 + b * STEP);
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      if (f0 + b * STEP >= n4) break;
      const float x[4] = {buf[b].x, buf[b].y, buf[b].z, buf[b].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * (f0 + b * STEP) + i, j = e / q;
        sv[MmaConsumer<NT>::slot(j, e - j * q)] = (double)x[i];
      }
    }
  }
}

template <typename TE>
constexpr size_t shared_bytes() {
  return (size_t)STAGES * BM * Layout<TE>::BK * sizeof(TE) + 2 * PANEL_BYTES +
         2 * (STAGES + 2) * sizeof(uint64_t);
}

template <typename TE, int NT>
__global__ void __launch_bounds__(THREADS, 1)
sqexp_stored_kernel(const __grid_constant__ CUtensorMap emap, const __grid_constant__ Plan plan,
                    const float* __restrict__ v, double* __restrict__ partial, int n_rows,
                    int q) {
  constexpr int BK = Layout<TE>::BK;
  extern __shared__ __align__(1024) unsigned char smem[];
  TE* ring = reinterpret_cast<TE*>(smem);
  double* sv = reinterpret_cast<double*>(smem + (size_t)STAGES * BM * BK * sizeof(TE));
  constexpr int PANEL_DOUBLES = PANEL_BYTES / sizeof(double);
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + 2 * PANEL_DOUBLES);
  uint64_t* empty = full + STAGES;
  uint64_t* vfull = empty + STAGES;  // v's two panel buffers
  uint64_t* vempty = vfull + 2;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = plan.rows[blockIdx.x], row1 = plan.rows[blockIdx.x + 1];
  const int col0 = plan.cols[blockIdx.y], col1 = plan.cols[blockIdx.y + 1];
  const int width = plan.panel;
  // split s's partial sums: plane 2 s + h for the column half h of a stage
  double* out = partial + (size_t)(2 * blockIdx.y + warp / 2) * n_rows * q;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMERS);
    }
    for (int b = 0; b < 2; ++b) {
      bar_init(&vfull[b], 32);
      bar_init(&vempty[b], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // panels, then row tiles, then stages of up to BK columns: the producer
  // and the consumers walk the same sequence; panel k's v lies in buffer k % 2
  if (warp == STAGER) {
    // the slots of the columns c >= q stay zero
    for (int i = lane; i < 2 * PANEL_DOUBLES; i += 32) sv[i] = 0.0;
    __syncwarp();
    int k = 0;
    for (int p0 = col0; p0 < col1; p0 += width, ++k) {
      if (k >= 2) bar_wait(&vempty[k & 1], ((k >> 1) - 1) & 1);
      stage_v<NT>(sv + (k & 1) * PANEL_DOUBLES, v, p0, min(width, col1 - p0), q, lane);
      bar_arrive(&vfull[k & 1]);
    }
    return;
  }
  if (warp == PRODUCER) {
    const uint64_t policy = evict_first_policy();
    int stage = 0;
    uint32_t phase = 0;
    for (int p0 = col0; p0 < col1; p0 += width) {
      const int p1 = min(p0 + width, col1);
      for (int r0 = row0; r0 < row1; r0 += BM) {
        const int boxes = min(BM, row1 - r0) / BOX_ROWS;
        for (int c0 = p0; c0 < p1; c0 += BK) {
          // a box is BK columns wide even where the stage uses fewer (a
          // float32 panel's last 128 columns); the TMA fills columns past the
          // matrix with zeros
          bar_wait(&empty[stage], phase ^ 1);
          if (lane == 0) bar_expect(&full[stage], boxes * BOX_ROWS * BK * sizeof(TE));
          __syncwarp();
          if (lane < boxes)
            tma_box(ring + ((size_t)stage * BM + BOX_ROWS * lane) * BK, &emap, c0,
                    r0 + BOX_ROWS * lane, &full[stage], policy);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  MmaConsumer<NT> cons;
  int stage = 0, k = 0;
  uint32_t phase = 0;
  for (int p0 = col0; p0 < col1; p0 += width, ++k) {
    const int p1 = min(p0 + width, col1);
    const double* panel = sv + (k & 1) * PANEL_DOUBLES;
    bar_wait(&vfull[k & 1], (k >> 1) & 1);
    for (int r0 = row0; r0 < row1; r0 += BM) {
      const int row = r0 + 16 * (warp & 1);
      cons.begin(out, row, row1, q, lane, p0 == col0);
      for (int c0 = p0; c0 < p1; c0 += BK) {
        bar_wait(&full[stage], phase);
        cons.template consume<TE>(ring + (size_t)stage * BM * BK, panel, c0 - p0,
                                  min(BK, p1 - c0), warp, lane);
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      cons.flush(out, row, row1, q, lane);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&vempty[k & 1]);
  }
}

// The attribute is per device, so it is set at every launch.
template <typename TE, int NT>
int launch(const CUtensorMap& emap, const Plan& plan, const float* v, double* partial,
           int n_rows, int q, int groups, int splits, cudaStream_t stream) {
  constexpr size_t bytes = shared_bytes<TE>();
  const cudaError_t rc = cudaFuncSetAttribute(
      sqexp_stored_kernel<TE, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  sqexp_stored_kernel<TE, NT>
      <<<dim3(groups, splits), THREADS, bytes, stream>>>(emap, plan, v, partial, n_rows, q);
  return (int)cudaGetLastError();
}

// The TMA's view of E: rows of n_cols entries, boxes of BOX_ROWS rows by BK
// columns. cuTensorMapEncodeTiled is a driver function, reached through the
// runtime so that the library links against nothing else. Returns 0, a CUDA
// error code, or 10000 plus the driver's error code.
template <typename TE>
int encode(CUtensorMap* map, const void* E, int n_rows, int n_cols) {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&fn), cudaEnableDefault, &found);
    if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr) {
      fn = nullptr;
      return rc != cudaSuccess ? (int)rc : (int)cudaErrorSymbolNotFound;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)n_cols, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n_cols * sizeof(TE)};
  const cuuint32_t box[2] = {(cuuint32_t)Layout<TE>::BK, (cuuint32_t)BOX_ROWS};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult cr = fn(map, Layout<TE>::TYPE, 2, const_cast<void*>(E), dims, strides, box, steps,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return cr == CUDA_SUCCESS ? 0 : 10000 + (int)cr;
}

// the plan from `bounds` (groups + 1 row bounds, then splits + 1 column
// bounds), or false where a bound is out of order, off its box or tile, or
// the panel does not fit a panel buffer or is not whole tiles
bool make_plan(Plan* plan, const int* bounds, int n_rows, int n_cols, int groups, int splits,
               int panel, int nt) {
  if (groups < 1 || groups > MAX_GRID || splits < 1 || splits > MAX_GRID || panel < TILE_COLS ||
      panel % TILE_COLS != 0 || panel * nt * 8 * (int)sizeof(double) > PANEL_BYTES)
    return false;
  const int* cols = bounds + groups + 1;
  if (bounds[0] != 0 || bounds[groups] != n_rows || cols[0] != 0 || cols[splits] != n_cols)
    return false;
  for (int r = 0; r <= groups; ++r) {
    if (bounds[r] % BOX_ROWS != 0 || (r > 0 && bounds[r] <= bounds[r - 1])) return false;
    plan->rows[r] = bounds[r];
  }
  for (int s = 0; s <= splits; ++s) {
    if (cols[s] % TILE_COLS != 0 || (s > 0 && cols[s] <= cols[s - 1])) return false;
    plan->cols[s] = cols[s];
  }
  plan->panel = panel;
  return true;
}

template <typename TE>
int stored(const void* E, const void* v, void* partial, const void* bounds, int n_rows,
           int n_cols, int q, int groups, int splits, int panel, void* stream) {
  const int nt = q <= 8 ? 1 : 2;
  Plan plan;
  if (n_rows < BOX_ROWS || n_rows % BOX_ROWS != 0 || n_cols < TILE_COLS ||
      n_cols % TILE_COLS != 0 || q < 1 || q > 16 ||
      (reinterpret_cast<uintptr_t>(E) & 15) != 0 || (reinterpret_cast<uintptr_t>(v) & 15) != 0 ||
      !make_plan(&plan, static_cast<const int*>(bounds), n_rows, n_cols, groups, splits, panel,
                 nt))
    return (int)cudaErrorInvalidValue;
  CUtensorMap emap;
  const int rc = encode<TE>(&emap, E, n_rows, n_cols);
  if (rc != 0) return rc;
  const float* vv = static_cast<const float*>(v);
  double* out = static_cast<double*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt == 1) return launch<TE, 1>(emap, plan, vv, out, n_rows, q, groups, splits, s);
  return launch<TE, 2>(emap, plan, vv, out, n_rows, q, groups, splits, s);
}

__global__ void mma_tile_kernel(const double* A, const double* B, double* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double d[4] = {0.0, 0.0, 0.0, 0.0};
  mma_16x8x4(d, A[g * 4 + t], A[(g + 8) * 4 + t], B[t * 8 + g]);
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

}  // namespace

// Kernel B6: partial (2 splits, n_rows, q) FP64 for E (n_rows, n_cols) FP64
// and v (n_cols, q) float32, whose planes 2 s and 2 s + 1 sum to E[:, split
// s] @ v[split s], on a grid of `groups` row groups by `splits` column
// splits, on `stream`. `bounds` is host memory: the groups + 1 row bounds and
// the splits + 1 column bounds of the wrapper's plan, increasing from 0 to
// n_rows and n_cols in steps of whole multiples of 4 rows and 128 columns;
// `panel` is a multiple of 128 columns, at most 1024 for q <= 8 and 512 for
// q <= 16. n_rows and n_cols must be positive multiples of 4 and 128,
// 1 <= q <= 16, E and v 16-byte aligned. Returns 0 on success, else the CUDA
// error code of the launch or 10000 plus the driver's error code of the
// tensor map.
extern "C" int sqexp_stored_f64(const void* E, const void* v, void* partial, const void* bounds,
                                int n_rows, int n_cols, int q, int groups, int splits, int panel,
                                void* stream) {
  return stored<double>(E, v, partial, bounds, n_rows, n_cols, q, groups, splits, panel, stream);
}

// Kernel B8: the same with E float32.
extern "C" int sqexp_stored_f32(const void* E, const void* v, void* partial, const void* bounds,
                                int n_rows, int n_cols, int q, int groups, int splits, int panel,
                                void* stream) {
  return stored<float>(E, v, partial, bounds, n_rows, n_cols, q, groups, splits, panel, stream);
}

// D (16 x 8) = A (16 x 4) @ B (4 x 8), all FP64 row-major, by one m16n8k4
// MMA with the kernel's fragment mapping: the layout check.
extern "C" int sqexp_stored_mma_tile(const void* A, const void* B, void* D, void* stream) {
  mma_tile_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(A), static_cast<const double*>(B), static_cast<double*>(D));
  return (int)cudaGetLastError();
}
