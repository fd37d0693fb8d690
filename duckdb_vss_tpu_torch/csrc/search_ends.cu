// Kernels K4 and K5: the two ends of the base-layer search around kernel
// K1, for Hopper (sm_90a).
//
// They replace no TPU kernel. In the JAX package (and in the port's plain
// versions, models/graph.seed_beam and models/graph._finish_search) the
// seed and the finish are chains of small operators that XLA fuses on the
// TPU; run eagerly on the card they were some fifty launches a chunk,
// each a few microseconds of card work and tens of microseconds of host
// issue, and the finish made a [B, ef, D] f32 block of gathered rows
// (268 MB at B 8,192, ef 64, D 128) to score it. Each end here is one
// launch that reads every row it scores once, straight into registers.
//
// K4, the seed beam (graph.seed_beam): per query, the P descent seeds
// scored against the query, a repeated seed (a later copy of an id
// already seen, as triu(seeds == seeds^T, 1).any(0) marks it) keeps its
// id with INF_SCORE, a seed < 0 gets INF_SCORE and -1, and the P entries
// sorted ascending, equal scores by position (a stable sort), into K1's
// starting beam [ef] with INF_SCORE / -1 past them (the first ef when
// P > ef). It also adds the number of seeds >= 0 (repeats included) to
// the search's distance count, one atomic add a block. One warp a query,
// eight queries a block; four lanes a seed, eight seeds in flight.
//
// K5, the finish (graph._finish_search; the one-hop expansion,
// graph._one_hop, runs after it in PyTorch where it is asked for):
// per query, each beam entry rescored exactly against the store, where
// its id is >= 0, its slot is live (valid_mask) and its beam score is
// below INF_SCORE, else INF_SCORE; then the first k of the order (score
// ascending, id descending, position ascending), with -1 where the score
// is INF_SCORE. One block of 128 threads a query; eight lanes a beam
// entry, sixteen entries in flight; the order is each entry's rank
// counted over the ef entries in shared memory (ef <= a few hundred on
// the search's paths, so ef^2 / 128 comparisons a thread is less than
// one row's loads). A beam whose scores and ids do not fit a block's
// shared memory (ef > 29,056: a LIMIT that large) keeps them in a
// global buffer of the caller's, 2 ef words a query, instead.
//
// Scores follow graph.gather_scores + graph.metric_epilogue: an f32 store
// in f32, a bf16 store with the query rounded to bf16 (round to nearest
// even) and f32 sums; the row's squared norm from vec_sq; then, with one
// rounding per operation (the _rn intrinsics, so nvcc contracts nothing):
//   l2sq    max((q_sq - 2 dot) + v_sq, 0)
//   ip      1 - dot
//   cosine  1 - dot / max(sqrt_rn(q_sq v_sq), eps); 1 if exactly one
//           norm is <= 0, 0 if both are.
// The dot's additions run in another order than the plain version's
// (cuBLAS's), so scores differ within f32 rounding (the tests' bound).
//
// What bounds them on the H100: bytes. Each live entry reads one random
// row (D * 4 bytes in f32, D * 2 in bf16) for 2 D flops. The loads are
// 16 bytes a lane, a row's vectors spread over the lanes of its group and
// unrolled, so many rows are in flight per warp.
//
// Neither kernel allocates; each C entry point returns cudaGetLastError()
// after its launch and the ctypes wrapper (ops/search_ends.py) raises on
// a non-zero code. Row offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;  // utils/padding.INF_SCORE
constexpr float kEps = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
enum Metric { kL2sq = 0, kIp = 1, kCosine = 2 };

constexpr int kSeedWarps = 8;  // K4: queries a block, one warp each
constexpr int kSeedLanes = 4;  // K4: lanes a seed
constexpr int kFinishThreads = 128;  // K5: one block a query
constexpr int kFinishLanes = 8;  // K5: lanes a beam entry

// Sum of the products of one 16-byte vector v of a row with the same
// elements of the f32 query, added into acc. A bf16 row rounds the query
// elements to bf16 first (gather_scores casts the query to the store's
// dtype).
__device__ __forceinline__ float dot_vec(const float* row, const float* q,
                                         int v, float acc) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row) + v);
  const float4 b = __ldg(reinterpret_cast<const float4*>(q) + v);
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float dot_vec(const __nv_bfloat16* row,
                                         const float* q, int v, float acc) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row) + v);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4* qv = reinterpret_cast<const float4*>(q) + 2 * v;
  const float4 q0 = __ldg(qv);
  const float4 q1 = __ldg(qv + 1);
  const float qs[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    acc = fmaf(f.x, bf16_round(qs[2 * j]), acc);
    acc = fmaf(f.y, bf16_round(qs[2 * j + 1]), acc);
  }
  return acc;
}

// One lane's share of the dot of row `id` with the query: the row's
// 16-byte vectors sub, sub + lanes, ...
template <typename T, int kLanes>
__device__ __forceinline__ float partial_dot(const T* vectors, int64_t id,
                                             const float* q, int d, int sub) {
  const T* row = vectors + id * d;
  const int nvec = d * static_cast<int>(sizeof(T)) / 16;
  float acc = 0.f;
#pragma unroll 4
  for (int v = sub; v < nvec; v += kLanes) acc = dot_vec(row, q, v, acc);
  return acc;
}

__device__ __forceinline__ float metric_score(float dot, float v_sq,
                                              float q_sq, int metric) {
  if (metric == kIp) return __fsub_rn(1.f, dot);
  if (metric == kL2sq)
    return fmaxf(__fadd_rn(__fsub_rn(q_sq, __fmul_rn(2.f, dot)), v_sq), 0.f);
  const float denom = __fsqrt_rn(__fmul_rn(q_sq, v_sq));
  float s = __fsub_rn(1.f, __fdiv_rn(dot, fmaxf(denom, kEps)));
  if (q_sq <= 0.f || v_sq <= 0.f) s = 1.f;
  if (q_sq <= 0.f && v_sq <= 0.f) s = 0.f;
  return s;
}

// K4. Shared memory: per warp, the P scores then the P ids.
template <typename T>
__global__ void __launch_bounds__(kSeedWarps * 32)
    search_seed_kernel(const T* __restrict__ vectors,
                       const float* __restrict__ vec_sq,
                       const int* __restrict__ seeds,
                       const float* __restrict__ queries,
                       const float* __restrict__ q_sq,
                       float* __restrict__ out_s, int* __restrict__ out_i,
                       unsigned long long* __restrict__ n_dist, int n_q,
                       int p, int d, int ef, int metric) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int block_valid[kSeedWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kSeedWarps + warp;
  float* s_sm = reinterpret_cast<float*>(smem) + 2 * p * warp;
  int* i_sm = reinterpret_cast<int*>(s_sm + p);
  int n_valid = 0;
  if (b < n_q) {  // uniform over the warp
    const float* q = queries + b * d;
    const float qsq = q_sq[b];
    const int sub = lane % kSeedLanes;
    for (int base = 0; base < p; base += 32 / kSeedLanes) {
      const int c = base + lane / kSeedLanes;
      const int id = c < p ? seeds[b * p + c] : -1;
      float dot = id >= 0 ? partial_dot<T, kSeedLanes>(vectors, id, q, d, sub)
                          : 0.f;
#pragma unroll
      for (int off = kSeedLanes / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      const bool head = sub == 0 && c < p;
      n_valid += __popc(__ballot_sync(kFull, head && id >= 0));
      if (head) {
        s_sm[c] = id >= 0 ? metric_score(dot, vec_sq[id], qsq, metric)
                          : kInf;
        i_sm[c] = id;
      }
    }
    __syncwarp();
    // a repeat of an earlier seed keeps its id with INF_SCORE
    for (int c = lane; c < p; c += 32) {
      const int id = i_sm[c];
      bool dup = false;
      for (int j = 0; j < c; ++j) dup |= i_sm[j] == id;
      if (dup) s_sm[c] = kInf;
    }
    __syncwarp();
    // stable ascending order: the rank among the P entries, ties by place
    for (int c = lane; c < p; c += 32) {
      const float s = s_sm[c];
      int rank = 0;
      for (int j = 0; j < p; ++j) {
        const float t = s_sm[j];
        rank += t < s || (t == s && j < c);
      }
      if (rank < ef) {
        out_s[b * ef + rank] = s;
        out_i[b * ef + rank] = i_sm[c] >= 0 ? i_sm[c] : -1;
      }
    }
    for (int c = p + lane; c < ef; c += 32) {
      out_s[b * ef + c] = kInf;
      out_i[b * ef + c] = -1;
    }
  }
  if (lane == 0) block_valid[warp] = n_valid;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kSeedWarps; ++w) total += block_valid[w];
    if (total) atomicAdd(n_dist, static_cast<unsigned long long>(total));
  }
}

// K5. The ef exact scores, then the ef ids: in shared memory, or with
// kSpill in the query's 2 ef words of `spill`.
template <typename T, bool kSpill>
__global__ void __launch_bounds__(kFinishThreads)
    search_finish_kernel(const T* __restrict__ vectors,
                         const float* __restrict__ vec_sq,
                         const bool* __restrict__ valid_mask,
                         const float* __restrict__ queries,
                         const float* __restrict__ q_sq,
                         const float* __restrict__ beam_s,
                         const int* __restrict__ beam_i,
                         float* __restrict__ out_s, int* __restrict__ out_i,
                         float* __restrict__ spill, int d, int ef, int k,
                         int metric) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  float* s_sm = kSpill ? spill + 2 * b * ef : reinterpret_cast<float*>(smem);
  int* i_sm = reinterpret_cast<int*>(s_sm + ef);
  const float* q = queries + b * d;
  const float qsq = q_sq[b];
  const int sub = tid % kFinishLanes;
  for (int base = 0; base < ef; base += kFinishThreads / kFinishLanes) {
    const int c = base + tid / kFinishLanes;
    int id = -1;
    bool live = false;
    if (c < ef) {
      id = beam_i[b * ef + c];
      live = id >= 0 && beam_s[b * ef + c] < kInf && valid_mask[id];
    }
    float dot = live ? partial_dot<T, kFinishLanes>(vectors, id, q, d, sub)
                     : 0.f;
#pragma unroll
    for (int off = kFinishLanes / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(kFull, dot, off);
    if (sub == 0 && c < ef) {
      s_sm[c] = live ? metric_score(dot, vec_sq[id], qsq, metric) : kInf;
      i_sm[c] = id;
    }
  }
  __syncthreads();
  // the place of each entry in (score ascending, id descending, position
  // ascending): a stable sort by -id, then a stable sort by score
  for (int c = tid; c < ef; c += kFinishThreads) {
    const float s = s_sm[c];
    const int id = i_sm[c];
    int rank = 0;
    for (int j = 0; j < ef; ++j) {
      const float t = s_sm[j];
      const int u = i_sm[j];
      rank += t < s || (t == s && (u > id || (u == id && j < c)));
    }
    if (rank < k) {
      out_s[b * k + rank] = s;
      out_i[b * k + rank] = s >= kInf ? -1 : id;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, bool kSpill>
cudaError_t launch_finish(const void* vectors, const float* vec_sq,
                          const bool* valid_mask, const float* queries,
                          const float* q_sq, const float* beam_s,
                          const int* beam_i, float* out_s, int* out_i,
                          float* spill, int b, int d, int ef, int k,
                          int metric, cudaStream_t st) {
  auto kernel = search_finish_kernel<T, kSpill>;
  const int smem = kSpill ? 0 : ef * 8;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<b, kFinishThreads, smem, st>>>(
      static_cast<const T*>(vectors), vec_sq, valid_mask, queries, q_sq,
      beam_s, beam_i, out_s, out_i, spill, d, ef, k, metric);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* search_ends_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4 on the caller's stream: ceil(b / 8) blocks of 8 warps, 8 p floats
// and ints of dynamic shared memory. bf16 selects a bf16 store (else
// f32). The wrapper (ops/search_ends.py) checks shapes, types and
// alignment. Returns a cudaError_t.
int search_seed_launch(const void* vectors, int bf16, const float* vec_sq,
                       const int* seeds, const float* queries,
                       const float* q_sq, float* out_s, int* out_i,
                       long long* n_dist, int b, int p, int d, int ef,
                       int metric, void* stream) {
  if (b <= 0) return 0;
  const int smem = kSeedWarps * p * 8;
  const int blocks = (b + kSeedWarps - 1) / kSeedWarps;
  auto* n = reinterpret_cast<unsigned long long*>(n_dist);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    auto kernel = search_seed_kernel<__nv_bfloat16>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, kSeedWarps * 32, smem, st>>>(
        static_cast<const __nv_bfloat16*>(vectors), vec_sq, seeds, queries,
        q_sq, out_s, out_i, n, b, p, d, ef, metric);
  } else {
    auto kernel = search_seed_kernel<float>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, kSeedWarps * 32, smem, st>>>(
        static_cast<const float*>(vectors), vec_sq, seeds, queries, q_sq,
        out_s, out_i, n, b, p, d, ef, metric);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5 on the caller's stream: b blocks of 128 threads, ef floats and ints
// of dynamic shared memory, or none where the caller gives `spill` (b x
// 2 ef floats). Returns a cudaError_t.
int search_finish_launch(const void* vectors, int bf16, const float* vec_sq,
                         const bool* valid_mask, const float* queries,
                         const float* q_sq, const float* beam_s,
                         const int* beam_i, float* out_s, int* out_i,
                         float* spill, int b, int d, int ef, int k,
                         int metric, void* stream) {
  if (b <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = bf16 ? (spill ? launch_finish<__nv_bfloat16, true>
                              : launch_finish<__nv_bfloat16, false>)
                     : (spill ? launch_finish<float, true>
                              : launch_finish<float, false>);
  return static_cast<int>(launch(vectors, vec_sq, valid_mask, queries, q_sq,
                                 beam_s, beam_i, out_s, out_i, spill, b, d,
                                 ef, k, metric, st));
}

}  // extern "C"
