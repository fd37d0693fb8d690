// Kernel K3: the search's upper-level descent, fused, for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package's mxu_descent
// (duckdb_vss_tpu/models/graph.py) left this product to XLA, one bf16
// matmul on the MXU with a blockwise selection, whose [B, U] score matrix
// never reached HBM. The port's plain version (ops/fused_descent.py,
// flat_topk over 16,384-row blocks) writes that matrix to device memory
// and selects from it in a dozen passes; this kernel keeps it on chip.
//
// What it computes, for queries q [B, D] f32, an upper table V [U, D]
// bf16 with its f32 squared norms v_sq [U] and owning nodes node [U]:
// for every query, the k smallest index-metric scores over the rows with
// node >= 0, ascending, equal scores to the lowest slot, and their slots.
// The query is rounded to bf16 (as dot_scores casts it to the table's
// dtype), products and sums are f32 (a bf16 x bf16 product is exact in
// f32: the tensor cores' mma with f32 accumulators keeps the precision),
// q_sq is the f32 query's. Epilogue as ops/distance.score_matrix: l2sq
// max(q_sq - 2 dot + v_sq, 0), ip 1 - dot, cosine 1 - dot / max(sqrt(
// q_sq v_sq), 1e-30) with usearch's zero-norm rule (sqrt and division
// correctly rounded). Places past a query's live rows carry INF_SCORE
// and slot -1.
//
// What bounds it on the H100: bf16 tensor-core operations for B >= 64
// (2 B U D operations over 989 TFLOP/s: 0.139 ms at B = 8,192, U =
// 65,536, D = 128), the bytes of the table for a single query (16.8 MB
// over 3.35 TB/s, about 5 us). Nothing of the [B, U] scores is written.
//
// Design. Kernel 1 (scan): a block of W warps (16 at D = 128) owns 16 W
// queries, 16 rows a warp, and one slice of the table. It converts its
// queries to bf16 into shared memory once (all of D, in 128-wide panels,
// XOR swizzled for conflict-free ldmatrix) and sums their f32 norms. It
// then streams the slice in tiles of 64 rows x 128 depth through a
// double buffer of cp.async copies (the whole table, 16.8 MB at the main
// path's shape, stays in the 50 MB L2 across query tiles), and each warp
// runs mma.sync m16n8k16 over its 16 x 64 tile of scores, in registers.
// The epilogue applies the metric and tests each score against its
// row's bound, the smaller of the C-th best scores (C = 8 for k <= 8,
// else 32) of the two lanes that keep the row's lists; the few that
// pass are appended, with their columns, to the row's list of passing
// scores in shared memory. Then the row's two lanes take every other
// passing score into their own sorted lists of C, in registers, by one
// bubble pass in exact (score, slot) order. The bound tightens as the
// slice goes by, so after its first tiles few scores pass and most rows
// have nothing to take. At the slice's end each row's two lists are
// merged (the pairs of a row are distinct, so the order is total). A
// block writes its slice's top k to a partial [S, B, k]; kernel 2
// (merge), one warp a query, takes the k smallest (score, slot) pairs
// of the S partials, the same order. With one slice the scan writes the
// result itself and the merge does not run.
//
// Where the time goes (B = 8,192, U = 65,536, H100): 0.99 ms, of which
// about 0.55 ms are the products alone (their B fragments are re-read
// from shared memory by every warp: a scan that stops after them takes
// that long). Next: two row tiles a warp, which halves those reads.
//
// The number of slices S comes from B and U alone (the wrapper's plan):
// enough query tiles times slices to fill the card's resident blocks
// once, at most 128 slices of at least one tile each. So B = 8,192
// takes 32 query tiles x 4 slices, B = 1 one query tile x 128 slices.
//
// The kernel allocates nothing; the C entry points return a cudaError_t
// and the ctypes wrapper (ops/fused_descent.py) raises if it is non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kInfScore = 3.0e38f;  // utils/padding.INF_SCORE
constexpr float kEps = 1e-30f;
constexpr int kTileRows = 64;   // table rows a tile
constexpr int kPanel = 128;     // depth of one staged panel, bf16 values
constexpr int kMaxK = 32;
constexpr int kMaxThreads = 512;  // 16 warps: 128 registers a thread
constexpr int kNoSlot = 0x7fffffff;
constexpr unsigned kAll = 0xffffffffu;
enum Metric { kL2sq = 0, kIp = 1, kCosine = 2 };

// The dynamic shared memory of one scan block: ops/fused_descent.py's
// smem_bytes is the same sum.
struct Layout {
  int a, b, vsq, node, qsq, bound, count, pass_s, pass_c, total;
  __host__ __device__ Layout(int warps, int d) {
    const int rows = 16 * warps;
    a = 0;                                    // [D/128][rows][128] bf16
    b = a + rows * d * 2;                     // [2][64][128] bf16
    vsq = b + 2 * kTileRows * kPanel * 2;     // [2][64] f32
    node = vsq + 2 * kTileRows * 4;           // [2][64] i32
    qsq = node + 2 * kTileRows * 4;           // [rows] f32
    bound = qsq + rows * 4;                   // [rows] f32
    count = bound + rows * 4;                 // [rows] i32
    pass_s = count + rows * 4;                // [rows][64] f32
    pass_c = pass_s + rows * kTileRows * 4;   // [rows][64] u8
    total = pass_c + rows * kTileRows;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// (s, i) before (ts, ti): by score, then by slot
__device__ __forceinline__ bool before(float s, int i, float ts, int ti) {
  return s < ts || (s == ts && i < ti);
}

// offset, in bf16 values, of (row, col) in a [rows][128] panel whose
// 16-byte chunks are XOR-swizzled by the row's low three bits
__device__ __forceinline__ int swz(int row, int col) {
  return row * kPanel + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

// the index-metric score of one product; a dead column adds +inf
template <int kMetric>
__device__ __forceinline__ float metric_score(float dot, float qsq,
                                              float vsq, float dead) {
  if (kMetric == kL2sq) return fmaxf(qsq - 2.f * dot + vsq, 0.f) + dead;
  if (kMetric == kIp) return (1.f - dot) + dead;
  const bool qz = qsq <= 0.f, vz = vsq <= 0.f;
  float s = 1.f - dot / fmaxf(sqrtf(qsq * vsq), kEps);
  if (qz || vz) s = 1.f;
  if (qz && vz) s = 0.f;
  return s + dead;
}

// A warp's 16 x 64 tile of scores from its products: each one at or
// below its row's bound (a dead column scores +inf) is appended to the
// row's list of passing scores, with its column
template <int kMetric>
__device__ __forceinline__ void pass_scores(const float (&acc)[8][4],
                                            const float* vsq, const int* nd,
                                            float qsq_a, float qsq_b,
                                            const float* bound, int* count,
                                            float* pass_s,
                                            unsigned char* pass_c, int g,
                                            int quad) {
  const float bound_a = bound[g], bound_b = bound[g + 8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + quad * 2;
    const float2 v2 = *reinterpret_cast<const float2*>(vsq + col);
    const int2 n2 = *reinterpret_cast<const int2*>(nd + col);
    const float dead0 = n2.x < 0 ? __int_as_float(0x7f800000) : 0.f;
    const float dead1 = n2.y < 0 ? __int_as_float(0x7f800000) : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = c < 2 ? g : g + 8;
      const float s = metric_score<kMetric>(
          acc[j][c], c < 2 ? qsq_a : qsq_b, (c & 1) ? v2.y : v2.x,
          (c & 1) ? dead1 : dead0);
      if (s <= (c < 2 ? bound_a : bound_b)) {
        const int at = atomicAdd(count + row, 1);
        pass_s[row * kTileRows + at] = s;
        pass_c[row * kTileRows + at] = static_cast<unsigned char>(col + (c & 1));
      }
    }
  }
}

// Insert (s, i) into the ascending list of kC pairs if it comes before
// the last: it takes the last place, then one bubble pass moves it up.
template <int kC>
__device__ __forceinline__ void insert(float (&ls)[kC], int (&li)[kC],
                                       float s, int i) {
  if (!before(s, i, ls[kC - 1], li[kC - 1])) return;
  ls[kC - 1] = s;
  li[kC - 1] = i;
#pragma unroll
  for (int e = kC - 1; e > 0; --e) {
    if (before(ls[e], li[e], ls[e - 1], li[e - 1])) {
      const float ts = ls[e];
      const int ti = li[e];
      ls[e] = ls[e - 1];
      li[e] = li[e - 1];
      ls[e - 1] = ts;
      li[e - 1] = ti;
    }
  }
}

// Stage tile `tile`'s panel `panel` into panel buffer `buf` and, at
// panel 0, its norms and nodes into the buffer of the tile's parity.
// Rows past U read row U - 1 and carry node -1, so they are never
// selected.
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ tbl,
                                      const float* __restrict__ t_sq,
                                      const int* __restrict__ nodes,
                                      unsigned char* smem, const Layout& L,
                                      int u, int d, int tile, int panel,
                                      int buf) {
  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(smem + L.b) +
                       buf * kTileRows * kPanel;
  const int64_t row0 = static_cast<int64_t>(tile) * kTileRows;
  for (int c = threadIdx.x; c < kTileRows * (kPanel / 8); c += blockDim.x) {
    const int r = c >> 4, ch = c & 15;
    const int64_t g = min(row0 + r, static_cast<int64_t>(u) - 1);
    cp_async16(dst + swz(r, ch * 8), tbl + g * d + panel * kPanel + ch * 8);
  }
  if (panel == 0) {
    float* vsq = reinterpret_cast<float*>(smem + L.vsq) + (tile & 1) * kTileRows;
    int* nd = reinterpret_cast<int*>(smem + L.node) + (tile & 1) * kTileRows;
    for (int r = threadIdx.x; r < kTileRows; r += blockDim.x) {
      const int64_t g = row0 + r;
      if (g < u) {
        cp_async4(vsq + r, t_sq + g);
        cp_async4(nd + r, nodes + g);
      } else {
        vsq[r] = 0.f;
        nd[r] = -1;
      }
    }
  }
}

template <int kC>
__global__ void __launch_bounds__(kMaxThreads, 1)
    descent_scan_kernel(const float* __restrict__ queries,
                        const __nv_bfloat16* __restrict__ tbl,
                        const float* __restrict__ t_sq,
                        const int* __restrict__ nodes,
                        float* __restrict__ out_s, int* __restrict__ out_i,
                        int b, int u, int d, int k, int metric) {
  const int rows = 16 * (blockDim.x / 32);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(blockDim.x / 32, d);
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem + L.a);
  const __nv_bfloat16* b_s =
      reinterpret_cast<const __nv_bfloat16*>(smem + L.b);
  const float* vsq_s = reinterpret_cast<const float*>(smem + L.vsq);
  const int* node_s = reinterpret_cast<const int*>(smem + L.node);
  float* qsq_s = reinterpret_cast<float*>(smem + L.qsq);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warp's rows: each one's bound (the smaller of its two lanes'
  // C-th best), and the scores of the tile that met it, with their
  // columns
  float* bound = reinterpret_cast<float*>(smem + L.bound) + warp * 16;
  int* count = reinterpret_cast<int*>(smem + L.count) + warp * 16;
  float* pass_s =
      reinterpret_cast<float*>(smem + L.pass_s) + warp * 16 * kTileRows;
  unsigned char* pass_c =
      reinterpret_cast<unsigned char*>(smem + L.pass_c) + warp * 16 * kTileRows;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int slice = blockIdx.y, n_slices = gridDim.y;
  const int n_tiles = (u + kTileRows - 1) / kTileRows;
  const int t_begin =
      static_cast<int>(static_cast<int64_t>(n_tiles) * slice / n_slices);
  const int t_end =
      static_cast<int>(static_cast<int64_t>(n_tiles) * (slice + 1) / n_slices);
  const int panels = d / kPanel;

  // the first panel's copies go out before the queries are converted
  stage(tbl, t_sq, nodes, smem, L, u, d, t_begin, 0, 0);
  asm volatile("cp.async.commit_group;\n" ::);

  // queries: each warp its 16 rows, all loads in flight at once, bf16
  // into the swizzled panels, the f32 norms by warp sums (rows past B
  // are zeros)
  {
    float ss[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) ss[r] = 0.f;
    for (int c4 = lane; c4 < d / 4; c4 += 32) {
      float4 v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int64_t gq = q0 + warp * 16 + r;
        v[r] = gq < b ? __ldg(reinterpret_cast<const float4*>(
                                  queries + gq * d) + c4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const int col = 4 * c4;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        ss[r] += v[r].x * v[r].x + v[r].y * v[r].y + v[r].z * v[r].z +
                 v[r].w * v[r].w;
        __nv_bfloat162 lo = __floats2bfloat162_rn(v[r].x, v[r].y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v[r].z, v[r].w);
        uint2 pk;
        pk.x = *reinterpret_cast<uint32_t*>(&lo);
        pk.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(a_s + (col / kPanel) * rows * kPanel +
                                  swz(warp * 16 + r, col % kPanel)) = pk;
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float t = ss[r];
      for (int off = 16; off > 0; off >>= 1)
        t += __shfl_xor_sync(kAll, t, off);
      if (lane == 0) qsq_s[warp * 16 + r] = t;
    }
  }
  if (lane < 16) {  // a row past B takes nothing
    bound[lane] = q0 + warp * 16 + lane < b ? kInfScore
                                            : -__int_as_float(0x7f800000);
    count[lane] = 0;
  }
  __syncthreads();

  const bool active = q0 + warp * 16 < b;
  const int g = lane >> 2, quad = lane & 3;
  const float qsq_a = qsq_s[warp * 16 + g], qsq_b = qsq_s[warp * 16 + g + 8];
  // the selection: lane r and lane r + 16 each keep a sorted list of the
  // warp's row r, over the scores of its half of every tile
  const int sel_row = lane & 15, half = lane >> 4;
  const bool sel_ok = q0 + warp * 16 + sel_row < b;
  float ls[kC];
  int li[kC];
#pragma unroll
  for (int e = 0; e < kC; ++e) {
    ls[e] = kInfScore;
    li[e] = kNoSlot;
  }
  float other_last = kInfScore;  // the other lane's C-th best score
  float acc[8][4];

  int buf = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    for (int panel = 0; panel < panels; ++panel, buf ^= 1) {
      const bool last_panel = panel + 1 == panels;
      if (!last_panel)
        stage(tbl, t_sq, nodes, smem, L, u, d, tile, panel + 1, buf ^ 1);
      else if (tile + 1 < t_end)
        stage(tbl, t_sq, nodes, smem, L, u, d, tile + 1, 0, buf ^ 1);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncthreads();
      if (!active) {
        __syncthreads();
        continue;
      }
      if (panel == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
      }
      const __nv_bfloat16* bt = b_s + buf * kTileRows * kPanel;
      const __nv_bfloat16* at = a_s + panel * rows * kPanel;
      // a warp issues in order and these are volatile: a k-step's B
      // fragments are all loaded before its eight products, so the
      // loads' latency is paid once a k-step, not once a product
#pragma unroll
      for (int kk = 0; kk < kPanel / 16; ++kk) {
        uint32_t a[4], bf[4][4];
        ldmatrix_x4(smem_u32(at + swz(warp * 16 + (lane & 15),
                                      kk * 16 + (lane >> 4) * 8)),
                    a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const int n = nn * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(smem_u32(bt + swz(n, kk * 16 + ((lane >> 3) & 1) * 8)),
                      bf[nn][0], bf[nn][1], bf[nn][2], bf[nn][3]);
        }
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          mma_bf16(acc[2 * nn], a[0], a[1], a[2], a[3], bf[nn][0], bf[nn][1]);
          mma_bf16(acc[2 * nn + 1], a[0], a[1], a[2], a[3], bf[nn][2],
                   bf[nn][3]);
        }
      }

      if (last_panel) {
        // epilogue: the scores that meet their row's bound, into the
        // row's list of passing scores
        const float* vsq = vsq_s + (tile & 1) * kTileRows;
        const int* nd = node_s + (tile & 1) * kTileRows;
        if (metric == kL2sq)
          pass_scores<kL2sq>(acc, vsq, nd, qsq_a, qsq_b, bound, count, pass_s,
                             pass_c, g, quad);
        else if (metric == kIp)
          pass_scores<kIp>(acc, vsq, nd, qsq_a, qsq_b, bound, count, pass_s,
                           pass_c, g, quad);
        else
          pass_scores<kCosine>(acc, vsq, nd, qsq_a, qsq_b, bound, count,
                               pass_s, pass_c, g, quad);
        __syncwarp();
        // selection: row r's two lanes take every other passing score
        // into their own lists, which keep exact (score, slot) order;
        // most rows have none once a slice is under way
        if (sel_ok) {
          const int n = count[sel_row];
          const float* ps = pass_s + sel_row * kTileRows;
          const unsigned char* pc = pass_c + sel_row * kTileRows;
          const int slot0 = tile * kTileRows;
          for (int e = half; e < n; e += 2)
            insert<kC>(ls, li, ps[e], slot0 + pc[e]);
        }
        other_last = __shfl_xor_sync(kAll, ls[kC - 1], 16);
        __syncwarp();  // the lists of passing scores are the next tile's
        if (half == 0) {
          if (sel_ok) bound[sel_row] = fminf(ls[kC - 1], other_last);
          count[sel_row] = 0;
        }
        __syncwarp();
      }
      __syncthreads();  // the buffer just read is the next copy's target
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // this slice's top k of the block's rows (the result, with one
  // slice): lane r takes lane r + 16's list into its own
  if (active) {
#pragma unroll
    for (int e = 0; e < kC; ++e) {
      const float os = __shfl_xor_sync(kAll, ls[e], 16);
      const int oi = __shfl_xor_sync(kAll, li[e], 16);
      if (half == 0) insert<kC>(ls, li, os, oi);
    }
    if (half == 0 && sel_ok) {
      const int64_t base =
          (static_cast<int64_t>(slice) * b + q0 + warp * 16 + sel_row) * k;
#pragma unroll
      for (int e = 0; e < kC; ++e) {
        if (e < k) {
          const bool live = ls[e] < kInfScore;
          out_s[base + e] = live ? ls[e] : kInfScore;
          out_i[base + e] = live ? li[e] : -1;
        }
      }
    }
  }
}

// One warp a query: the k smallest (score, slot) pairs of its S partial
// lists, k rounds of a warp-wide minimum over the pairs after the last
// one taken (every pair is distinct: a slot lies in one slice).
__global__ void __launch_bounds__(256)
    descent_merge_kernel(const float* __restrict__ part_s,
                         const int* __restrict__ part_i,
                         float* __restrict__ out_s, int* __restrict__ out_i,
                         int b, int k, int n_slices) {
  const int lane = threadIdx.x & 31;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (q >= b) return;
  const int n = n_slices * k;
  float last_s = -__int_as_float(0x7f800000);
  int last_i = -kNoSlot - 1;
  for (int r = 0; r < k; ++r) {
    float best_s = __int_as_float(0x7f800000);
    int best_i = kNoSlot;
    for (int j = lane; j < n; j += 32) {
      const int64_t at = (static_cast<int64_t>(j / k) * b + q) * k + j % k;
      const float s = part_s[at];
      const int i = part_i[at];
      if (before(last_s, last_i, s, i) && before(s, i, best_s, best_i)) {
        best_s = s;
        best_i = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best_s, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (before(os, oi, best_s, best_i)) {
        best_s = os;
        best_i = oi;
      }
    }
    if (lane == 0) {
      const bool live = best_s < kInfScore;
      out_s[q * k + r] = live ? best_s : kInfScore;
      out_i[q * k + r] = live ? best_i : -1;
    }
    last_s = best_s;
    last_i = best_i;
  }
}

template <int kC>
cudaError_t launch_scan(const float* q, const __nv_bfloat16* tbl,
                        const float* t_sq, const int* nodes, float* out_s,
                        int* out_i, int b, int u, int d, int k, int metric,
                        int warps, int n_slices, int smem, cudaStream_t stream,
                        int* occupancy) {
  auto kernel = descent_scan_kernel<kC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel,
                                                         warps * 32, smem);
  const dim3 grid((b + 16 * warps - 1) / (16 * warps), n_slices);
  kernel<<<grid, warps * 32, smem, stream>>>(q, tbl, t_sq, nodes, out_s,
                                             out_i, b, u, d, k, metric);
  return cudaGetLastError();
}

// The scan, its lists of 8 places for k <= 8, else of 32; or, with
// `occupancy` set, only the number of its blocks one SM holds at once.
cudaError_t scan(int metric, const float* q, const __nv_bfloat16* tbl,
                 const float* t_sq, const int* nodes, float* out_s,
                 int* out_i, int b, int u, int d, int k, int warps,
                 int n_slices, int smem, cudaStream_t stream,
                 int* occupancy = nullptr) {
  if (warps < 1 || warps * 32 > kMaxThreads || metric < kL2sq ||
      metric > kCosine)
    return cudaErrorInvalidValue;
  if (k <= 8)
    return launch_scan<8>(q, tbl, t_sq, nodes, out_s, out_i, b, u, d, k,
                          metric, warps, n_slices, smem, stream, occupancy);
  return launch_scan<32>(q, tbl, t_sq, nodes, out_s, out_i, b, u, d, k,
                         metric, warps, n_slices, smem, stream, occupancy);
}

}  // namespace

extern "C" {

const char* fused_descent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Scan blocks of `warps` warps for k with `smem` bytes that one SM holds
// at once, into *blocks. Returns a cudaError_t.
int fused_descent_occupancy(int warps, int k, int smem, int* blocks) {
  return static_cast<int>(scan(kL2sq, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, 0, 0, 0, k, warps, 0, smem,
                               nullptr, blocks));
}

// The scan on the caller's stream, and the merge after it when
// n_slices > 1 (the scan then writes part_s / part_i, [n_slices, b, k]).
// The wrapper (ops/fused_descent.py) checks shapes, types, alignment and
// the plan (warps, n_slices, smem). Returns a cudaError_t.
int fused_descent_launch(const float* queries, const void* table,
                         const float* table_sq, const int* nodes,
                         float* out_s, int* out_i, float* part_s,
                         int* part_i, int b, int u, int d, int k, int metric,
                         int warps, int n_slices, int smem, void* stream) {
  if (b <= 0) return 0;
  if (u <= 0 || d <= 0 || d % kPanel || k < 1 || k > kMaxK ||
      n_slices < 1 || smem < Layout(warps, d).total)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* tbl = static_cast<const __nv_bfloat16*>(table);
  float* scan_s = n_slices == 1 ? out_s : part_s;
  int* scan_i = n_slices == 1 ? out_i : part_i;
  const cudaError_t err = scan(metric, queries, tbl, table_sq, nodes, scan_s,
                               scan_i, b, u, d, k, warps, n_slices, smem, st);
  if (err != cudaSuccess || n_slices == 1) return static_cast<int>(err);
  descent_merge_kernel<<<(b + 7) / 8, 256, 0, st>>>(part_s, part_i, out_s,
                                                    out_i, b, k, n_slices);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
