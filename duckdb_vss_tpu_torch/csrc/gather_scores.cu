// Kernel K2: fused row gather + distance scoring, for Hopper (sm_90a).
//
// Replaces duckdb_vss_tpu/ops/pallas_gather.py::_kernel (the Pallas TPU
// kernel launched by gather_scores_pallas). It computes the same
// function: out[b, c] = metric(q[b], vectors[ids[b, c]]) for candidate
// ids [B, C] against an f32 table [N, D], without a gathered [B, C, D]
// block in device memory, and INF_SCORE where ids[b, c] < 0. The dot
// and the row's squared norm both come from the fetched row, in f32.
// It is not a block-by-block copy: the TPU kernel's 8 query rows per
// program, its padding of C to 128 lanes, its [2, C, D] scratch and its
// DMA semaphores belong to that machine.
//
// One thread block (256 threads, 8 warps) owns one query row. The query
// is staged in shared memory once. Each warp takes candidates c = warp,
// warp + 8, ...: the lanes read the row as 16-byte loads (32 lanes x
// float4 = 128 floats per pass, D / 128 passes), accumulate dot and
// squared norm in registers, reduce them with warp shuffles, and lane 0
// applies the metric epilogue and stores one float. A candidate with
// id < 0 reads nothing. Row offsets are 64-bit.
//
// What bounds it on the H100: bytes. Every live candidate moves D * 4
// bytes of a random row for 4 * D flops (one flop per byte), far below
// the card's ~20 f32 flops per byte. The design keeps the loads wide
// and coalesced within a row; more rows in flight per warp (cp.async,
// several candidates per warp) is the next lever.
//
// The kernel allocates nothing; the C entry point returns
// cudaGetLastError() after the launch, and the ctypes wrapper
// (ops/fused_gather.py) raises if it is non-zero.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;  // utils/padding.INF_SCORE
constexpr float kEps = 1e-30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
enum Metric { kL2sq = 0, kIp = 1, kCosine = 2 };

__global__ void __launch_bounds__(kThreads)
    gather_scores_kernel(const float* __restrict__ vectors,
                         const int* __restrict__ ids,
                         const float* __restrict__ queries,
                         const float* __restrict__ q_sq,
                         float* __restrict__ out, int c_n, int d,
                         int metric) {
  extern __shared__ __align__(16) float q[];  // [D]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;

  const float4* q_src = reinterpret_cast<const float4*>(queries + b * d);
  for (int j = tid; j < d / 4; j += kThreads)
    reinterpret_cast<float4*>(q)[j] = q_src[j];
  const float qsq = q_sq[b];
  __syncthreads();

  for (int c = warp; c < c_n; c += kWarps) {
    const int id = ids[b * c_n + c];
    if (id < 0) {
      if (lane == 0) out[b * c_n + c] = kInf;
      continue;
    }
    const float4* row =
        reinterpret_cast<const float4*>(vectors + (int64_t)id * d);
    float dot = 0.f;
    float vsq = 0.f;
    for (int j = lane; j < d / 4; j += 32) {
      const float4 v = __ldg(row + j);
      const float4 qv = reinterpret_cast<const float4*>(q)[j];
      dot += v.x * qv.x + v.y * qv.y + v.z * qv.z + v.w * qv.w;
      vsq += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    for (int off = 16; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
      vsq += __shfl_xor_sync(0xffffffffu, vsq, off);
    }
    if (lane == 0) {
      float s;
      if (metric == kIp) {
        s = 1.f - dot;
      } else if (metric == kL2sq) {
        s = fmaxf(qsq + vsq - 2.f * dot, 0.f);
      } else {
        const float denom = sqrtf(qsq * vsq);
        s = 1.f - dot / fmaxf(denom, kEps);
        if (qsq <= 0.f || vsq <= 0.f) s = 1.f;
        if (qsq <= 0.f && vsq <= 0.f) s = 0.f;
      }
      out[b * c_n + c] = s;
    }
  }
}

}  // namespace

extern "C" {

const char* gather_scores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One block per query row on the caller's stream, with d floats of
// dynamic shared memory for the query. The wrapper (ops/fused_gather.py)
// checks shapes, types and alignment. Returns a cudaError_t.
int gather_scores_launch(const float* vectors, const int* ids,
                         const float* queries, const float* q_sq, float* out,
                         int b, int c_n, int d, int metric, void* stream) {
  if (b <= 0 || c_n <= 0) return 0;
  const int smem = d * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gather_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_scores_kernel<<<b, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      vectors, ids, queries, q_sq, out, c_n, d, metric);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
