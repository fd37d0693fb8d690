// Kernel K1: the fused base-layer HNSW beam search, for Hopper (sm_90a).
//
// Replaces duckdb_vss_tpu/ops/pallas_beam.py::_kernel (the Pallas TPU
// kernel launched by beam_search_pallas). It computes the same function:
// beam steps over the int8 neighborhood layout
// (models/graph.make_neighborhood_tables + ops/fused_beam.pack_meta),
// with the beam kept on chip for all steps, and returns the same beam,
// ids and counts as ops/fused_beam.beam_search_plain. It is not a
// block-by-block copy: the TPU kernel advances a tile of 64 queries in
// lockstep with lane-vector ops and a bitonic merge network; here one
// thread block of 128 threads owns one query.
//
// What bounds it on the H100, as measured. Its floor is bytes: every live
// selection must read one meta row of a random node, and every candidate
// the dedup keeps one row of D int8; two operations per row byte are far
// below the card's ~295 (so no wgmma: each query scores its own rows, and
// a tensor-core product would not round each product to bf16). At B=8192,
// ef 64, expand 4 it runs at about 40% of that floor, and at about 80% of
// the time its own reads would take, because it copies the whole
// M0*D-byte tile of a selection and not the kept rows alone: copying
// only those measured slower, since what it spends is not the wait for
// bytes. With clock64() sums per phase (tools/k1_phases.py) a block
// waits for its tiles 1% and for its meta rows 10% of the time it is
// resident; the rest is instruction slots and barriers: scoring 33%,
// dedup 30%, selection and the start of the copies (one warp's serial
// chain) 21%, merge 5%. The first port of this kernel (fixed trip count,
// argmin passes, every candidate scored, a rank merge over the whole
// pool) took eight times as long: half of its steps ran after the
// query's last expansion, more than half of the rows it scored were then
// dropped, and its merge compared (ef + C)^2 pairs. So the design spends
// instructions only where the data needs them, and leaves the reads to
// the copy engine while the other eight blocks of the SM compute:
//
//   1. selection by position: the beam is ascending (the wrapper's
//      precondition on the seeds; the merge keeps it), so the E best
//      unexpanded entries are the first E positions that are unexpanded
//      and finite: one ballot per 32 positions, no argmin passes;
//   2. early exit: a step that selects nothing changes nothing, and no
//      later step can select, so the block writes its beam and returns;
//   3. asynchronous copies, ids first: the lanes of warp 0 start, per
//      live selection, one bulk copy (cp.async.bulk, completion counted
//      in bytes on an mbarrier) of the meta row and one of the int8
//      [M0, D] tile, on separate barriers;
//   4. dedup while the tiles are in flight: beam ids and candidate ids go
//      into a small hash table in shared memory, one slot per id that
//      holds the id and the least position it came from (atomicCAS, then
//      atomicMin), beam positions below candidate positions; a candidate
//      is kept when its slot holds its own position, so the first copy
//      in the block wins whatever the order of the threads. The kept ones
//      are compacted by ballot, and n_dist counts them. (Comparing each
//      candidate with the beam and the earlier candidates took 5% longer
//      at ef 64 / expand 4 and 22% longer at ef 128 / expand 8);
//   5. scoring of the kept candidates only: eight lanes per 16-byte
//      slice of a row, int8 -> bf16 exactly, products rounded to bf16
//      two at a time (__hmul2, the TPU kernel's arithmetic), summed in
//      f32 in one stated order that the plain version follows add for
//      add (ordered_row_sum), times the dequant scale, then the metric
//      epilogue with one rounding per operation;
//   6. pruning: a candidate whose score is >= the beam's last score can
//      never enter (the beam wins ties; an unfilled beam ends in INF),
//      so only the others ("survivors") reach the merge;
//   7. merge by position: a survivor's place is its rank among the
//      survivors (score, then block position) plus the beam entries
//      <= it (binary search); a beam entry's place is its index plus
//      the survivors strictly below it. That is exactly the stable sort
//      of [beam, candidates], at a cost of survivors x (survivors +
//      ef) compares instead of (ef + C)^2.
//
// The kernel allocates nothing; the C entry point returns
// cudaGetLastError() after the launch, and the ctypes wrapper
// (ops/fused_beam.py) raises if it is non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Hooks for tools/k1_phases.py, which compiles this file with a header
// that defines them to sum clock64() per phase. Empty otherwise.
#ifndef K1_PHASE_BEGIN
#define K1_PHASE_BEGIN()
#define K1_PHASE(n)
#define K1_PHASE_END()
#endif

namespace {

constexpr float kInf = 3.0e38f;  // utils/padding.INF_SCORE
constexpr float kEps = 1e-30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 9;  // what shared memory allows at ef 64, E 4
constexpr int kEmptySlot = -1;  // the table holds no negative id
constexpr unsigned kFull = 0xffffffffu;
enum Metric { kL2sq = 0, kIp = 1, kCosine = 2 };
enum Misc { kLive = 0, kKept = 1, kSurv = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes % 16 == 0, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Puts id into the table (open addressing, linear probing) and lowers its
// slot's position to pos: the slot of an id keeps the least position given
// for it, whatever the order of the threads. Returns the slot.
__device__ __forceinline__ int table_insert(int* tbl_id, int* tbl_pos,
                                            int log_h, int id, int pos) {
  uint32_t h = (static_cast<uint32_t>(id) * 2654435761u) >> (32 - log_h);
  while (true) {
    const int old = atomicCAS(&tbl_id[h], kEmptySlot, id);
    if (old == kEmptySlot || old == id) break;
    h = (h + 1) & ((1u << log_h) - 1u);
  }
  atomicMin(&tbl_pos[h], pos);
  return static_cast<int>(h);
}

// byte k of v (an int8 plus 128) as an exact float, by writing it into the
// mantissa of 2^23 and subtracting 2^23 + 128
template <int k>
__device__ __forceinline__ float i8_to_float(uint32_t v_plus_128) {
  return __uint_as_float(__byte_perm(v_plus_128, 0x4B000000u, 0x7440 + k)) -
         8388736.f;
}

// acc plus, one after the other, the four products bf16(int8 * q): rounded
// to bf16 two at a time, widened and added in f32
__device__ __forceinline__ float add4(float acc, uint32_t v, uint32_t q01,
                                      uint32_t q23) {
  const uint32_t u = v ^ 0x80808080u;
  const __nv_bfloat162 a = __floats2bfloat162_rn(i8_to_float<0>(u),
                                                 i8_to_float<1>(u));
  const __nv_bfloat162 b = __floats2bfloat162_rn(i8_to_float<2>(u),
                                                 i8_to_float<3>(u));
  const __nv_bfloat162 pa =
      __hmul2(a, *reinterpret_cast<const __nv_bfloat162*>(&q01));
  const __nv_bfloat162 pb =
      __hmul2(b, *reinterpret_cast<const __nv_bfloat162*>(&q23));
  acc += __low2float(pa);
  acc += __high2float(pa);
  acc += __low2float(pb);
  return acc + __high2float(pb);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    fused_beam_kernel(const float* __restrict__ queries,
                      const float* __restrict__ q_sq,
                      const float* __restrict__ seed_s,
                      const int* __restrict__ seed_i,
                      const int* __restrict__ meta,
                      const int8_t* __restrict__ vecs,
                      float* __restrict__ out_s, int* __restrict__ out_i,
                      int* __restrict__ counts, int ef, int expand, int m0,
                      int d, int w, int max_steps, int metric,
                      int meta_bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c_n = expand * m0;
  const int mrow = (3 * m0 + 3) & ~3;  // ints per staged meta row
  const int log_h = 32 - __clz(ef + c_n);
  const int h_n = 1 << log_h;  // table slots: more than ef + C
  const uint32_t meta_bytes = mrow * 4;
  const uint32_t tile_bytes = m0 * d;
  // layout (ops/fused_beam.py::smem_bytes, which sizes it)
  int8_t* tiles = reinterpret_cast<int8_t*>(smem);       // [E, M0, D]
  int* meta_s = reinterpret_cast<int*>(tiles + (size_t)c_n * d);  // [E, mrow]
  __nv_bfloat16* q =
      reinterpret_cast<__nv_bfloat16*>(meta_s + expand * mrow);   // [D]
  int2* surv_key = reinterpret_cast<int2*>(q + d);  // [C] (score bits, pos)
  uint64_t* bars = reinterpret_cast<uint64_t*>(surv_key + c_n);   // [2]
  int* tbl_id = reinterpret_cast<int*>(bars + 2);  // [H] the dedup's table:
  int* tbl_pos = tbl_id + h_n;                     // [H] ids, least positions
  float* beam_s0 = reinterpret_cast<float*>(tbl_pos + h_n);  // two beams of
  int* beam_i0 = reinterpret_cast<int*>(beam_s0 + 2 * ef);  // [ef] each:
  int* beam_e0 = beam_i0 + 2 * ef;   // scores, ids, expanded flags
  int* surv_id = beam_e0 + 2 * ef;   // [C]; table slots during the dedup
  int* kept = surv_id + c_n;         // [C] (e << 16) | j of kept candidates
  int* sel_node = kept + c_n;        // [E]
  int* misc = sel_node + expand;     // [4]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const float qsq = q_sq[b];
  const uint32_t bar_meta = smem_addr(bars);
  const uint32_t bar_tile = smem_addr(bars + 1);

  if (tid == 0) {
    mbar_init(bar_meta, 1);
    mbar_init(bar_tile, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < d; j += kThreads)
    q[j] = __float2bfloat16_rn(queries[b * d + j]);
  for (int j = tid; j < ef; j += kThreads) {
    beam_s0[j] = seed_s[b * ef + j];
    beam_i0[j] = seed_i[b * ef + j];
    beam_e0[j] = 0;
  }
  int cur = 0;           // which of the two beams is current
  uint32_t phase = 0;    // parity of the copy barriers
  int n_dist = 0;        // kept candidates, accumulated by thread 0
  int n_exp = 0;         // live selections, accumulated by thread 0
  K1_PHASE_BEGIN();
  __syncthreads();

  for (int step = 0; step < max_steps; ++step) {
    float* cur_s = beam_s0 + cur * ef;
    int* cur_i = beam_i0 + cur * ef;
    int* cur_e = beam_e0 + cur * ef;

    // -- 1. warp 0: select by position, start the copies; the other
    //       warps empty the table ----------------------------------------
    if (warp != 0) {
      for (int k = tid - 32; k < h_n; k += kThreads - 32) {
        tbl_id[k] = kEmptySlot;
        tbl_pos[k] = 0x7fffffff;
      }
    } else {
      int found = 0;
      for (int j0 = 0; j0 < ef && found < expand; j0 += 32) {
        const int j = j0 + lane;
        const bool ok = j < ef && cur_e[j] == 0 && cur_s[j] < kInf;
        const unsigned m = __ballot_sync(kFull, ok);
        const int order = found + __popc(m & ((1u << lane) - 1u));
        if (ok && order < expand) {
          sel_node[order] = max(cur_i[j], 0);
          cur_e[j] = 1;
        }
        found += __popc(m);
      }
      const int n_live = min(found, expand);
      if (lane == 0) {
        misc[kLive] = n_live;
        misc[kKept] = 0;
        misc[kSurv] = 0;
        n_exp += n_live;
        if (n_live > 0) {
          if (meta_bulk) mbar_expect_tx(bar_meta, n_live * meta_bytes);
          mbar_expect_tx(bar_tile, n_live * tile_bytes);
        }
      }
      __syncwarp();
      for (int e = lane; e < n_live; e += 32) {
        const int64_t node = sel_node[e];
        if (meta_bulk)
          bulk_copy(meta_s + e * mrow, meta + node * w, meta_bytes, bar_meta);
        bulk_copy(tiles + (size_t)e * tile_bytes, vecs + node * tile_bytes,
                  tile_bytes, bar_tile);
      }
    }
    __syncthreads();
    const int n_live = misc[kLive];
    // nothing to expand: no later step can select either, the beam is final
    if (n_live == 0) break;
    const int c_live = n_live * m0;
    const float last = cur_s[ef - 1];
    K1_PHASE(0);

    // -- 2. the beam's ids into the table, then the meta rows (ids first) --
    for (int j = tid; j < ef; j += kThreads) {
      const int id = cur_i[j];
      if (id >= 0) table_insert(tbl_id, tbl_pos, log_h, id, j);
    }
    if (meta_bulk) {
      mbar_wait(bar_meta, phase);
    } else {  // rows that are not 16-byte aligned: plain loads
      for (int t = tid; t < n_live * 3 * m0; t += kThreads) {
        const int e = t / (3 * m0);
        const int r = t - e * 3 * m0;
        meta_s[e * mrow + r] = __ldg(meta + (int64_t)sel_node[e] * w + r);
      }
      __syncthreads();
    }
    K1_PHASE(1);

    // -- 3. mask + dedup through the table; compact the kept -------------
    for (int c = tid; c < c_live; c += kThreads) {
      const int e = c / m0;
      const int id = meta_s[e * mrow + (c - e * m0)];
      surv_id[c] =
          id >= 0 ? table_insert(tbl_id, tbl_pos, log_h, id, ef + c) : -1;
    }
    __syncthreads();
    for (int c0 = 0; c0 < c_live; c0 += kThreads) {
      const int c = c0 + tid;
      bool keep = false;
      int e = 0, j = 0;
      if (c < c_live) {
        e = c / m0;
        j = c - e * m0;
        const int slot = surv_id[c];
        // kept: the id is in no beam entry and in no earlier candidate
        keep = slot >= 0 && tbl_pos[slot] == ef + c;
      }
      const unsigned m = __ballot_sync(kFull, keep);
      if (m != 0) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&misc[kKept], __popc(m));
        base = __shfl_sync(kFull, base, 0);
        if (keep) kept[base + __popc(m & ((1u << lane) - 1u))] = (e << 16) | j;
      }
    }
    __syncthreads();
    const int n_kept = misc[kKept];
    if (tid == 0) n_dist += n_kept;
    K1_PHASE(2);

    // -- 4. the tiles, then score the kept candidates --------------------
    mbar_wait(bar_tile, phase);
    phase ^= 1u;
    K1_PHASE(3);
    {
      const int sub = lane & 7;    // eight lanes share a row
      const int slot = lane >> 3;  // four rows per warp at a time
      for (int r0 = warp * 4; r0 < n_kept; r0 += kWarps * 4) {
        const int r = r0 + slot;
        const bool active = r < n_kept;
        const int ej = active ? kept[r] : 0;
        const int e = ej >> 16;
        const int j = ej & 0xffff;
        const int c = e * m0 + j;
        // The f32 sum has one stated order, which the plain version
        // (ops/fused_beam.py::ordered_row_sum) follows add for add: sums
        // of 128 bf16 products are not always exact. Lane sub takes the 16
        // elements at sub * 16 of every 128; a[i] adds its elements 4 * i
        // to 4 * i + 3 one after the other; the lane's sum is (a0 + a1) +
        // (a2 + a3); the eight lanes add by xor 4, 2, 1.
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        if (active) {
          const int8_t* row = tiles + (size_t)c * d;
          for (int k = sub * 16; k < d; k += 128) {
            const uint4 v = *reinterpret_cast<const uint4*>(row + k);
            const uint4 qa = *reinterpret_cast<const uint4*>(q + k);
            const uint4 qb = *reinterpret_cast<const uint4*>(q + k + 8);
            a0 = add4(a0, v.x, qa.x, qa.y);
            a1 = add4(a1, v.y, qa.z, qa.w);
            a2 = add4(a2, v.z, qb.x, qb.y);
            a3 = add4(a3, v.w, qb.z, qb.w);
          }
        }
        float acc = (a0 + a1) + (a2 + a3);
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
          acc += __shfl_xor_sync(kFull, acc, off);
        if (active && sub == 0) {
          // one rounding per operation, as the plain version: the _rn
          // intrinsics are never contracted into fused multiply-adds
          const int* mr = meta_s + e * mrow;
          const float dot = __fmul_rn(acc, __int_as_float(mr[m0 + j]));
          const float vsq = __int_as_float(mr[2 * m0 + j]);
          float s;
          if (metric == kIp) {
            s = __fsub_rn(1.f, dot);
          } else if (metric == kL2sq) {
            s = fmaxf(__fadd_rn(__fsub_rn(qsq, __fmul_rn(2.f, dot)), vsq),
                      0.f);
          } else {
            const float denom = sqrtf(__fmul_rn(qsq, vsq));
            s = __fsub_rn(1.f, __fdiv_rn(dot, fmaxf(denom, kEps)));
            if (qsq <= 0.f || vsq <= 0.f) s = 1.f;
            if (qsq <= 0.f && vsq <= 0.f) s = 0.f;
          }
          // the beam wins ties, so s >= its last score never enters
          if (s < last) {
            const int pos = atomicAdd(&misc[kSurv], 1);
            surv_key[pos] = make_int2(__float_as_int(s), c);
            surv_id[pos] = mr[j];
          }
        }
      }
    }
    __syncthreads();
    const int n_surv = misc[kSurv];
    K1_PHASE(4);

    // -- 5. merge the survivors into the other beam ------------------------
    if (n_surv == 0) {
      // the beam stands; the first merge still turns the ids of INF
      // entries (repeated seeds) into -1
      if (step == 0)
        for (int j = tid; j < ef; j += kThreads)
          if (cur_s[j] >= kInf) cur_i[j] = -1;
    } else {
      float* nxt_s = beam_s0 + (cur ^ 1) * ef;
      int* nxt_i = beam_i0 + (cur ^ 1) * ef;
      int* nxt_e = beam_e0 + (cur ^ 1) * ef;
      // beam entry j moves down by the survivors strictly below it
      for (int j = tid; j < ef; j += kThreads) {
        const float s = cur_s[j];
        int pos = j;
        for (int t = 0; t < n_surv; ++t)
          pos += __int_as_float(surv_key[t].x) < s;
        if (pos < ef) {
          nxt_s[pos] = s;
          nxt_i[pos] = s >= kInf ? -1 : cur_i[j];
          nxt_e[pos] = cur_e[j];
        }
      }
      // survivor t lands at its rank among the survivors (score, then
      // block position) plus the beam entries <= it; the last threads
      // take these, so that they run beside the loop above
      for (int t = kThreads - 1 - tid; t < n_surv; t += kThreads) {
        const int2 key = surv_key[t];
        const float s = __int_as_float(key.x);
        int pos = 0;
        for (int u = 0; u < n_surv; ++u) {
          const int2 other = surv_key[u];
          const float so = __int_as_float(other.x);
          pos += (so < s) | ((so == s) & (other.y < key.y));
        }
        int lo = 0, hi = ef;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cur_s[mid] <= s) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        pos += lo;
        if (pos < ef) {
          nxt_s[pos] = s;
          nxt_i[pos] = surv_id[t];
          nxt_e[pos] = 0;
        }
      }
      cur ^= 1;
    }
    __syncthreads();
    K1_PHASE(5);
  }

  {
    const float* cur_s = beam_s0 + cur * ef;
    const int* cur_i = beam_i0 + cur * ef;
    for (int j = tid; j < ef; j += kThreads) {
      const float s = cur_s[j];
      out_s[b * ef + j] = s;
      // every merge writes -1 beside INF; so does a search that stops
      // before its first merge
      out_i[b * ef + j] = (max_steps > 0 && s >= kInf) ? -1 : cur_i[j];
    }
  }
  if (tid == 0) {
    counts[2 * b] = n_dist;
    counts[2 * b + 1] = n_exp;
  }
  K1_PHASE_END();
}

}  // namespace

extern "C" {

const char* fused_beam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One block per query on the caller's stream, with smem bytes of dynamic
// shared memory; the wrapper (ops/fused_beam.py) sizes it with smem_bytes
// and checks the shapes. Meta rows go by bulk copy when every row starts
// on a 16-byte boundary. Returns a cudaError_t.
int fused_beam_launch(const float* queries, const float* q_sq,
                      const float* seed_s, const int* seed_i, const int* meta,
                      const int8_t* vecs, float* out_s, int* out_i,
                      int* counts, int b, int ef, int expand, int m0, int d,
                      int w, int max_steps, int metric, int smem,
                      void* stream) {
  if (b <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int meta_bulk =
      w % 4 == 0 && reinterpret_cast<uintptr_t>(meta) % 16 == 0;
  fused_beam_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      queries, q_sq, seed_s, seed_i, meta, vecs, out_s, out_i, counts, ef,
      expand, m0, d, w, max_steps, metric, meta_bulk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
