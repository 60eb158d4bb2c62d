// Fused cross-model serving pass: every row scored under its own model
// out of K stacked linear heads, its features built from the raw
// boundary values by its model's prefix, and the head's activation
// applied, in one launch.
//
// Replaces two pieces of the JAX package's fused serving pass:
//   - the TPU kernel transmogrifai_tpu/models/serving_kernels.py:224
//     fused_linear_scores -> _fused_db_kernel (Pallas: rows and the
//     model-id vector stream HBM->VMEM double-buffered, one masked
//     (n, K*L) MXU contraction against the resident (p+1, K*L) weight
//     block, then a 0/1 group-sum down to each row's own L columns);
//   - the jitted pass around it, transmogrifai_tpu/serving/fusion.py:265
//     (each member's prefix -- impute with null indicators, concat,
//     keep_cols -- a per-row `where` select of the member's features,
//     the kernel, the activation), which XLA fuses into one program.
//
// What it computes, for each row i with m = mid[i] in [0, K):
//
//   x[j] = op[m,j] == NULL   ? (isnan(v) ? 1 : 0)
//        : op[m,j] == FILLED ? (isnan(v) ? fill[m,j] : v)
//        :                     v,            v = V[i, src[m,j]]
//   z[l] = sum_j r(x[j]) * r(W[m, j, l]) + W[m, p, l]
//   out[i] = act(z)
//
// with r() rounding an operand to bf16 when `bf16` is set (the serve
// dtype) and the identity otherwise, f32 accumulation, the intercept
// row added in f32 after the dot. act is the identity (n_out = L), the
// softmax over L (max, expf(z - max), sum in order, divide: the order
// of the plain version's torch.softmax), or the sigmoid pair of a
// binary head (L = 1, n_out = 2), computed as the two-way softmax of
// [0, z] as models/linear.py's sigmoid_pair does. A row whose mid lies
// outside [0, K) gets z = 0 before the activation, as the TPU
// formulation's all-false mask gives. Null tables (src == nullptr) are
// the identity table: x[j] = V[i, j] as is, with C = p. That is the
// plain fused_linear_scores(X, W, mid) of the JAX package.
//
// Shapes: V (n, C) f32, mid (n,) i32, src (K, p) i32, op (K, p) u8,
// fill (K, p) f32, W (K, p+1, L) f32, out (n, n_out) f32; contiguous.
// A src outside [0, C) reads NaN instead of memory outside the row.
//
// Why gathering is safe: the TPU version zeroes the non-selected lanes
// with `where` BEFORE the reduction, so a non-selected model's inf
// never reaches a row. Reading only the row's own table and (p+1, L)
// block keeps that by construction, and an out-of-range row reads no
// block at all.
//
// What bounds it on an H100: a serving pass (n = 64 rows, C = 13
// boundary columns, p = 22 features, K = 4 models, L = 1) moves ~5 KB
// and does ~3 kFLOP: under 2 ns at 3.35 TB/s. So the kernel itself is
// bound by a launch's fixed cost (chip_smoke.py times an empty launch
// through the same C entry path, tm_empty_launch below), and the pass
// around it by the host and device operations it takes. The design
// answers both: the prefix and the activation run inside this one
// launch, so a bucket slice of a fused pass is one host-to-device copy
// (V and mid packed in one pinned buffer), this kernel and one
// device-to-host copy, where the eager pass took 273 device operations
// for 60 rows over 4 models (fused_pass_probe.py on an H100).
// Inside, a warp owns a row and its lanes own features (p <= 32 is one
// feature a lane, built once and kept in a register), so a row is one
// gather and five shuffles a head column; lanes over rows would walk the
// p features one after another in each thread. The tables and W are
// staged once per block in shared memory, up to the card's opt-in limit
// (227 KB on an H100); a larger group reads them through L1 from global
// memory. Built without fast math (isnan, expf exact).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 8;
constexpr long long kDefaultSharedBytes = 48 * 1024;

// activation codes (models/serving_kernels.py ACTIVATIONS); 0 is the
// identity, which needs no epilogue
constexpr int kSigmoidPair = 1;
constexpr int kSoftmax = 2;

// per-feature op codes (models/serving_kernels.py OP_*)
constexpr uint8_t kFilled = 1;
constexpr uint8_t kNullIndicator = 2;

__device__ __forceinline__ float round_operand(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool kTables>
__device__ __forceinline__ float feature(const float* vrow, int C,
                                         const int32_t* src,
                                         const uint8_t* op,
                                         const float* fill, int j) {
  if (!kTables) return vrow[j];
  const int s = src[j];
  const float v = (unsigned)s < (unsigned)C ? vrow[s] : __int_as_float(0x7fc00000);
  const bool null = isnan(v);
  const uint8_t o = op[j];
  if (o == kNullIndicator) return null ? 1.0f : 0.0f;
  return (o == kFilled && null) ? fill[j] : v;
}

template <bool kShared, bool kTables>
__global__ void __launch_bounds__(kThreads)
fused_scores_kernel(const float* __restrict__ V,
                    const int32_t* __restrict__ mid,
                    const int32_t* __restrict__ src,
                    const uint8_t* __restrict__ op,
                    const float* __restrict__ fill,
                    const float* __restrict__ W,
                    float* __restrict__ out,
                    int n, int C, int p, int K, int L, int act, int bf16) {
  extern __shared__ __align__(16) float smem[];
  const float* w = W;
  const float* fl = fill;
  const int32_t* sr = src;
  const uint8_t* o = op;
  if (kShared) {
    // W, then fill, src and op: 4 (K (p+1) L) + 9 (K p) bytes
    const long long wsize = (long long)K * (p + 1) * L;
    const long long tsize = kTables ? (long long)K * p : 0;
    float* ws = smem;
    float* fs = ws + wsize;
    int32_t* ss = reinterpret_cast<int32_t*>(fs + tsize);
    uint8_t* os = reinterpret_cast<uint8_t*>(ss + tsize);
    for (long long t = threadIdx.x; t < wsize; t += blockDim.x) ws[t] = W[t];
    for (long long t = threadIdx.x; t < tsize; t += blockDim.x) {
      fs[t] = fill[t];
      ss[t] = src[t];
      os[t] = op[t];
    }
    __syncthreads();
    w = ws;
    fl = fs;
    sr = ss;
    o = os;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool rnd = bf16 != 0;
  const int n_out = act == kSigmoidPair ? 2 : L;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < n;
       row += stride) {
    const int m = mid[row];
    const bool valid = m >= 0 && m < K;
    const float* vrow = V + row * C;
    const float* wm = w + (long long)(valid ? m : 0) * (p + 1) * L;
    const long long tb = (long long)(valid ? m : 0) * p;
    const int32_t* srm = sr + tb;
    const uint8_t* om = o + tb;
    const float* fm = fl + tb;
    float* orow = out + row * n_out;
    // the lane's first feature, built once for every head column
    const float x0 = (valid && lane < p)
        ? round_operand(feature<kTables>(vrow, C, srm, om, fm, lane), rnd)
        : 0.0f;
    float z = 0.0f;          // lane 0's last head column (L = 1: the only)
    for (int l = 0; l < L; ++l) {
      float acc = 0.0f;
      if (valid) {
        if (lane < p) acc = x0 * round_operand(wm[(long long)lane * L + l], rnd);
        for (int j = lane + 32; j < p; j += 32) {
          acc = fmaf(round_operand(feature<kTables>(vrow, C, srm, om, fm, j),
                                   rnd),
                     round_operand(wm[(long long)j * L + l], rnd), acc);
        }
        for (int off = 16; off > 0; off >>= 1) {
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        }
        z = acc + wm[(long long)p * L + l];
      }
      if (lane == 0 && act != kSigmoidPair) orow[l] = z;
    }
    if (lane != 0) continue;
    if (act == kSigmoidPair) {
      const float mx = fmaxf(0.0f, z);
      const float e0 = expf(0.0f - mx);
      const float e1 = expf(z - mx);
      const float s = e0 + e1;
      orow[0] = e0 / s;
      orow[1] = e1 / s;
    } else if (act == kSoftmax) {
      float mx = orow[0];
      for (int l = 1; l < L; ++l) mx = fmaxf(mx, orow[l]);
      float s = 0.0f;
      for (int l = 0; l < L; ++l) s += expf(orow[l] - mx);
      for (int l = 0; l < L; ++l) orow[l] = expf(orow[l] - mx) / s;
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

long long shared_optin_bytes() {
  static long long bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    int b = 0;
    cudaDeviceGetAttribute(&b, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    bytes = b > 0 ? b : kDefaultSharedBytes;
  }
  return bytes;
}

typedef void (*KernelFn)(const float*, const int32_t*, const int32_t*,
                         const uint8_t*, const float*, const float*, float*,
                         int, int, int, int, int, int, int);

}  // namespace

// Launches on `stream` (PyTorch's current stream, as a CUstream handle)
// and returns the first CUDA error of the launch (0 on success): a
// refused shared-memory request, or cudaGetLastError() right after the
// launch. Allocates nothing and does not synchronise. src, op and fill
// are all null (the identity table, C == p) or all set.
extern "C" int tm_fused_scores(const float* V, const int32_t* mid,
                               const int32_t* src, const uint8_t* op,
                               const float* fill, const float* W, float* out,
                               int n, int C, int p, int K, int L, int act,
                               int bf16, void* stream) {
  if (n <= 0) return 0;
  const bool tables = src != nullptr;
  const long long smem = 4LL * K * (p + 1) * L + (tables ? 9LL * K * p : 0);
  const bool shared = smem <= shared_optin_bytes();
  KernelFn kern = shared
      ? (tables ? fused_scores_kernel<true, true> : fused_scores_kernel<true, false>)
      : (tables ? fused_scores_kernel<false, true> : fused_scores_kernel<false, false>);
  const size_t dyn = shared ? (size_t)smem : 0;
  if (dyn > (size_t)kDefaultSharedBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = ((long long)n + kWarps - 1) / kWarps;
  if (blocks > sm_count()) {
    // grid-stride past what fits at once, so each block stages once
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, dyn);
    if (per_sm < 1) per_sm = 1;
    if (per_sm > kBlocksPerSM) per_sm = kBlocksPerSM;
    const long long cap = (long long)sm_count() * per_sm;
    if (blocks > cap) blocks = cap;
  }
  kern<<<(unsigned)blocks, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      V, mid, src, op, fill, W, out, n, C, p, K, L, act, bf16);
  return (int)cudaGetLastError();
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// One launch of an empty kernel on `stream`, through the same C entry
// path as tm_fused_scores: what a launch costs the host with no work in
// it. Returns cudaGetLastError() as above.
extern "C" int tm_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
