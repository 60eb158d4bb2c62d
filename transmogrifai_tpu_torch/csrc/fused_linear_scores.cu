// Fused cross-model linear scores: every row scored under its own
// model out of K stacked linear heads, in one launch.
//
// Replaces the TPU kernel transmogrifai_tpu/models/serving_kernels.py
// fused_linear_scores -> _fused_db_kernel (Pallas: X and the model-id
// vector stream HBM->VMEM double-buffered, one masked (n, K*L) MXU
// contraction against the resident (p+1, K*L) weight block, then a
// 0/1 group-sum down to each row's own L columns).
//
// What it computes (the same function, not the same blocks):
//
//   out[i, l] = sum_j r(X[i, j]) * r(W[mid[i], j, l]) + W[mid[i], p, l]
//
// with r() rounding an operand to bf16 when `bf16` is set (the serve
// dtype) and the identity otherwise, f32 accumulation, and the
// intercept row added in f32 after the dot. A row whose mid lies
// outside [0, K) scores 0, as the TPU formulation's all-false mask
// gives. X is (n, p), W is (K, p+1, L), mid is (n,), out is (n, L);
// all contiguous, f32 / int32.
//
// Why gathering is safe: the TPU version zeroes the non-selected
// lanes with `where` BEFORE the reduction, so summing exact zeros onto
// the selected model's score changes nothing and a non-selected
// model's inf never reaches a row. Reading only the row's own (p+1, L)
// block keeps both properties by construction: no other model's
// weights are ever read into the sum.
//
// What bounds it on an H100: at serving shapes (n = 64, p = 24, K = 4,
// L = 1) one call moves ~7 KB (fused_cost_floor) and does ~3 kFLOP —
// a microsecond of HBM time at 3.35 TB/s even at n = 32768, so the
// fixed cost of a launch and memory bound it, never the tensor cores
// (chip_smoke.py times an empty launch through the same C entry path,
// tm_empty_launch below, as the floor under the wrapper's call time).
// The design follows from that: no MMA, one warp per row (lanes stride
// the p features, so X is read coalesced), a shuffle reduction per
// output column, and the K*(p+1)*L weight block staged once per block
// in shared memory when it fits in 48 KB (read through L1/L2 from
// global memory otherwise). Blocks grid-stride over rows so each block
// stages the weights once; the loop bound masks a ragged n.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr long long kMaxSharedFloats = 48 * 1024 / 4;
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ float round_operand(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
fused_linear_scores_kernel(const float* __restrict__ X,
                           const float* __restrict__ W,
                           const int32_t* __restrict__ mid,
                           float* __restrict__ out,
                           int n, int p, int K, int L, int bf16) {
  extern __shared__ float w_smem[];
  const float* w = W;
  if (kShared) {
    const long long wsize = (long long)K * (p + 1) * L;
    for (long long t = threadIdx.x; t < wsize; t += blockDim.x) {
      w_smem[t] = W[t];
    }
    __syncthreads();
    w = w_smem;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool rnd = bf16 != 0;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < n;
       row += stride) {
    const int m = mid[row];
    float* o = out + row * L;
    if (m < 0 || m >= K) {
      for (int l = lane; l < L; l += 32) o[l] = 0.0f;
      continue;
    }
    const float* x = X + row * p;
    const float* wm = w + (long long)m * (p + 1) * L;
    for (int l = 0; l < L; ++l) {
      float acc = 0.0f;
      for (int j = lane; j < p; j += 32) {
        acc = fmaf(round_operand(x[j], rnd),
                   round_operand(wm[(long long)j * L + l], rnd), acc);
      }
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) o[l] = acc + wm[(long long)p * L + l];
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    int c = 0;
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    count = c > 0 ? c : 132;
  }
  return count;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream, as a CUstream handle)
// and returns cudaGetLastError() right after the launch: 0 on success.
// Allocates nothing and does not synchronise.
extern "C" int tm_fused_linear_scores(const float* X, const float* W,
                                      const int32_t* mid, float* out,
                                      int n, int p, int K, int L, int bf16,
                                      void* stream) {
  if (n <= 0) return 0;
  const long long wsize = (long long)K * (p + 1) * L;
  long long blocks = ((long long)n + kWarps - 1) / kWarps;
  const long long cap = (long long)sm_count() * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wsize <= kMaxSharedFloats) {
    fused_linear_scores_kernel<true>
        <<<(unsigned)blocks, kThreads, (size_t)wsize * sizeof(float), s>>>(
            X, W, mid, out, n, p, K, L, bf16);
  } else {
    fused_linear_scores_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        X, W, mid, out, n, p, K, L, bf16);
  }
  return (int)cudaGetLastError();
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// One launch of an empty kernel on `stream`, through the same C entry
// path as tm_fused_linear_scores: what a launch costs the host with no
// work in it. Returns cudaGetLastError() as above.
extern "C" int tm_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
