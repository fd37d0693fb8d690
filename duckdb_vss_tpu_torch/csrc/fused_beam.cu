// Kernel K1: the fused base-layer HNSW beam search, for Hopper (sm_90a).
//
// Replaces duckdb_vss_tpu/ops/pallas_beam.py::_kernel (the Pallas TPU
// kernel launched by beam_search_pallas). It computes the same function:
// a fixed number of beam steps over the int8 neighborhood layout
// (models/graph.make_neighborhood_tables + ops/fused_beam.pack_meta),
// with the beam kept on chip for all steps. It is not a block-by-block
// copy: the TPU kernel advances a tile of 64 queries in lockstep with
// lane-vector ops and a bitonic merge network; here one thread block
// owns one query, and the beam lives in shared memory.
//
// Per step, per query (one block of 256 threads):
//   1. warp 0 picks the E best unexpanded beam entries by E argmin
//      passes (ties to the lowest position, as jnp.argmin);
//   2. all threads copy the live selections' int8 [M0, D] tiles
//      (16-byte loads) and the 3*M0 meta ints into shared memory;
//   3. one warp per candidate scores int8 x bf16(q) products, rounded
//      to bf16 and summed in f32 (the TPU kernel's arithmetic), times
//      the dequant scale, then the metric epilogue;
//   4. one thread per candidate drops id < 0, dead selections, ids in
//      the beam and earlier repeats in the block;
//   5. every pool entry (beam, then candidates) counts its stable rank,
//      and the first ef ranks become the new beam.
//
// What bounds it on the H100: bytes. Each live selection reads one
// M0*D-byte tile and 3*M0*4 bytes of meta from a random row (18.4 KB
// per query and step at E=4, M0=32, D=128), and the scoring does two
// flops per tile byte: far below the card's ~295 flops per byte, so
// tensor cores (wgmma) would not help. The design keeps everything but
// those row reads on chip; overlapping the next step's reads with this
// step's merge (cp.async / TMA) is the next lever.
//
// The kernel allocates nothing; the C entry point returns
// cudaGetLastError() after the launch, and the ctypes wrapper
// (ops/fused_beam.py) raises if it is non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;  // utils/padding.INF_SCORE
constexpr float kEps = 1e-30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
enum Metric { kL2sq = 0, kIp = 1, kCosine = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
    fused_beam_kernel(const float* __restrict__ queries,
                      const float* __restrict__ q_sq,
                      const float* __restrict__ seed_s,
                      const int* __restrict__ seed_i,
                      const int* __restrict__ meta,
                      const int8_t* __restrict__ vecs,
                      float* __restrict__ out_s, int* __restrict__ out_i,
                      int* __restrict__ counts, int ef, int expand, int m0,
                      int d, int w, int max_steps, int metric) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c_n = expand * m0;
  const int p_n = ef + c_n;
  // layout (ops/fused_beam.py::smem_bytes, which sizes it): int8 tiles
  // first, so they are 16-byte aligned
  int8_t* tiles = reinterpret_cast<int8_t*>(smem);
  float* q = reinterpret_cast<float*>(smem + (size_t)c_n * d);
  float* pool_s = q + d;  // [0, ef) the beam, [ef, ef + C) candidates
  int* pool_i = reinterpret_cast<int*>(pool_s + p_n);
  int* pool_e = pool_i + p_n;  // expanded flags
  float* new_s = reinterpret_cast<float*>(pool_e + p_n);
  int* new_i = reinterpret_cast<int*>(new_s + ef);
  int* new_e = new_i + ef;
  float* key = reinterpret_cast<float*>(new_e + ef);
  int* raw_id = reinterpret_cast<int*>(key + ef);  // [C] ids as fetched
  int* meta_s = raw_id + c_n;                       // [E, 3*M0]
  int* sel_node = meta_s + 3 * c_n;                 // [E]
  int* sel_ok = sel_node + expand;                  // [E]
  int* misc = sel_ok + expand;  // [0] kept this step, [1] live selections

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const float qsq = q_sq[b];

  for (int j = tid; j < d; j += kThreads) q[j] = bf16_round(queries[b * d + j]);
  for (int j = tid; j < ef; j += kThreads) {
    pool_s[j] = seed_s[b * ef + j];
    pool_i[j] = seed_i[b * ef + j];
    pool_e[j] = 0;
  }
  int n_dist = 0;  // kept candidates, accumulated by thread 0
  int n_exp = 0;   // live selections, accumulated by thread 0
  __syncthreads();

  for (int step = 0; step < max_steps; ++step) {
    // -- 1. select the E best unexpanded entries (warp 0) ---------------
    if (warp == 0) {
      for (int j = lane; j < ef; j += 32)
        key[j] = (pool_e[j] != 0 || pool_s[j] >= kInf) ? kInf : pool_s[j];
      __syncwarp();
      int live = 0;
      for (int e = 0; e < expand; ++e) {
        float best = INFINITY;
        int bpos = 0x7fffffff;
        for (int j = lane; j < ef; j += 32) {
          const float v = key[j];
          if (v < best) {
            best = v;
            bpos = j;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, off);
          const int op = __shfl_xor_sync(0xffffffffu, bpos, off);
          if (ob < best || (ob == best && op < bpos)) {
            best = ob;
            bpos = op;
          }
        }
        const bool ok = best < kInf;
        if (lane == 0) {
          sel_ok[e] = ok;
          sel_node[e] = ok ? pool_i[bpos] : 0;
          if (ok) {
            pool_e[bpos] = 1;
            key[bpos] = kInf;
          }
        }
        __syncwarp();
        live += ok;
      }
      if (lane == 0) {
        misc[0] = 0;
        misc[1] = live;
        n_exp += live;
      }
    }
    __syncthreads();
    // live selections are a prefix: once a pass finds no entry, so do
    // all later ones
    const int n_live = misc[1];

    // -- 2. fetch tiles + meta of the live selections --------------------
    const int tile_vec = m0 * d / 16;  // int4 per tile
    for (int t = tid; t < n_live * tile_vec; t += kThreads) {
      const int e = t / tile_vec;
      const int r = t - e * tile_vec;
      const int4* src =
          reinterpret_cast<const int4*>(vecs + (int64_t)sel_node[e] * m0 * d);
      reinterpret_cast<int4*>(tiles + (size_t)e * m0 * d)[r] = __ldg(src + r);
    }
    for (int t = tid; t < n_live * 3 * m0; t += kThreads) {
      const int e = t / (3 * m0);
      const int r = t - e * 3 * m0;
      meta_s[t] = __ldg(meta + (int64_t)sel_node[e] * w + r);
    }
    __syncthreads();

    // -- 3. score: one warp per candidate, lanes across D -----------------
    for (int c = warp; c < c_n; c += kWarps) {
      const int e = c / m0;
      const int j = c - e * m0;
      if (e >= n_live) {
        if (lane == 0) {
          pool_s[ef + c] = kInf;
          raw_id[c] = -1;
        }
        continue;
      }
      const int8_t* row = tiles + (size_t)c * d;
      float acc = 0.f;
      for (int off = lane * 4; off < d; off += 128) {
        const char4 v = *reinterpret_cast<const char4*>(row + off);
        const float4 qv = *reinterpret_cast<const float4*>(q + off);
        acc += bf16_round((float)v.x * qv.x);
        acc += bf16_round((float)v.y * qv.y);
        acc += bf16_round((float)v.z * qv.z);
        acc += bf16_round((float)v.w * qv.w);
      }
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const int* mrow = meta_s + e * 3 * m0;
        const float dot = acc * __int_as_float(mrow[m0 + j]);
        const float vsq = __int_as_float(mrow[2 * m0 + j]);
        float s;
        if (metric == kIp) {
          s = 1.f - dot;
        } else if (metric == kL2sq) {
          s = fmaxf(qsq - 2.f * dot + vsq, 0.f);
        } else {
          const float denom = sqrtf(qsq * vsq);
          s = 1.f - dot / fmaxf(denom, kEps);
          if (qsq <= 0.f || vsq <= 0.f) s = 1.f;
          if (qsq <= 0.f && vsq <= 0.f) s = 0.f;
        }
        pool_s[ef + c] = s;
        raw_id[c] = mrow[j];
      }
    }
    __syncthreads();

    // -- 4. mask + dedup: one thread per candidate ------------------------
    for (int c = tid; c < c_n; c += kThreads) {
      const int id = raw_id[c];
      bool keep = (c / m0) < n_live && id >= 0;
      for (int j = 0; keep && j < ef; ++j) keep = pool_i[j] != id;
      for (int j = 0; keep && j < c; ++j) keep = raw_id[j] != id;
      if (!keep) pool_s[ef + c] = kInf;
      pool_i[ef + c] = keep ? id : -1;
      pool_e[ef + c] = 0;
      if (keep) atomicAdd(&misc[0], 1);
    }
    __syncthreads();

    // -- 5. merge: stable rank of every pool entry, keep the first ef ----
    for (int p = tid; p < p_n; p += kThreads) {
      const float s = pool_s[p];
      int rank = 0;
      for (int j = 0; j < p; ++j) rank += pool_s[j] <= s;
      for (int j = p + 1; j < p_n; ++j) rank += pool_s[j] < s;
      if (rank < ef) {
        new_s[rank] = s;
        new_i[rank] = s >= kInf ? -1 : pool_i[p];
        new_e[rank] = pool_e[p];
      }
    }
    __syncthreads();
    for (int j = tid; j < ef; j += kThreads) {
      pool_s[j] = new_s[j];
      pool_i[j] = new_i[j];
      pool_e[j] = new_e[j];
    }
    if (tid == 0) n_dist += misc[0];
    __syncthreads();
  }

  for (int j = tid; j < ef; j += kThreads) {
    out_s[b * ef + j] = pool_s[j];
    out_i[b * ef + j] = pool_i[j];
  }
  if (tid == 0) {
    counts[2 * b] = n_dist;
    counts[2 * b + 1] = n_exp;
  }
}

}  // namespace

extern "C" {

const char* fused_beam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One block per query on the caller's stream, with smem bytes of dynamic
// shared memory; the wrapper (ops/fused_beam.py) sizes it with smem_bytes
// and checks the shapes. Returns a cudaError_t.
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
  fused_beam_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      queries, q_sq, seed_s, seed_i, meta, vecs, out_s, out_i, counts, ef,
      expand, m0, d, w, max_steps, metric);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
