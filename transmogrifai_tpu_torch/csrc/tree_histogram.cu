// Grid-folded tree histograms: node x feature x bin sums of per-row
// statistics for G tree-growing instances over one shared binned matrix.
//
// Replaces the TPU kernels of transmogrifai_tpu/models/kernels.py
// histogram_pallas_grid: _hist_db_kernel (pallas_call at :612, the
// double-buffered manual-DMA variant) and _hist_grid_kernel
// (pallas_call at :649, the BlockSpec row-block grid; also reached
// through histogram_pallas). Both build a (rows, d*B) bins one-hot and
// a node-masked (rows, G*m*S) stats matrix in VMEM and contract them on
// the MXU, accumulating row blocks in a resident VMEM output block.
//
// What it computes (the same function, not the same blocks):
//
//   out[g, node, s, j, b] = sum_i r(stats[g, i, s])
//                           * [pos[g, i] == node] * [bins[i, j] == b]
//
// bins (n, d) int32, stats (G, n, S) f32, pos (G, n) int32, out
// (G, m, S, d, B) f32 — the (G, m*S, d*B) layout with column j*B + b
// that grow_tree_grid reads, written straight out (no unscramble). r()
// rounds a stat to bf16 when `bf16` is set and is the identity
// otherwise; accumulation is f32. A row whose node lies outside [0, m),
// or whose bin lies outside [0, B), adds nothing (the one-hot
// formulation's all-zero row; a NaN stat is the one difference: the
// one-hot matmul spreads NaN*0 into every node, this kernel skips the
// other nodes).
//
// What bounds it on an H100: it is a scatter-add, not a matrix
// product. One call does G*n*d*S adds (448 M at the histogram capture
// shape G=16 n=200k d=28 B=32 S=5 m=8) and must move every input once
// plus the output (~101 MB there), so the bound is bytes: ~30 us at
// 3.35 TB/s (6.7 us of f32 adds at 67 TFLOP/s). The TPU's one-hot
// trick would turn those adds into G*m*S*d*B*n multiply-adds (a GEMM
// of 229 GFLOP at that shape) to feed its matrix unit.
//
// The design, deterministic by construction:
//
// * Rows are first grouped by node, per instance: a stable counting
//   sort (count per (node, row chunk), one exclusive scan, then each
//   chunk's rows ranked in row order with warp match masks) writes a
//   permutation of each instance's rows, node by node, rows in their
//   original order inside a node.
// * The histogram pass takes one block of one warp per (instance g,
//   node, run of R consecutive rows of that node, chunk of 32
//   features), a lane per feature. The block's node is fixed, so lane j
//   owns only the S*B cells of its feature: a shared-memory slab laid
//   out [s][b][lane] (B+1 bin rows; row B takes out-of-range bins),
//   ~21 KB at S=5, B=32. A cell is touched by one lane only — no
//   atomics, every cell sums its rows in row order — and a warp's
//   read-modify-writes hit 32 distinct banks whatever bins its lanes
//   hold. Without the node sort a lane would own m times the cells,
//   and an SM would hold a few warps instead of tens.
// * Rows come through shared memory in tiles of kTileRows, two tiles in
//   flight with cp.async: the run's row indices, then each row's bins
//   (the chunk's features) and stats, the stats rounded to the operand
//   dtype once per (row, stat) in the tile.
// * Each block writes its run's partial histogram; a last pass sums a
//   node's runs in run order (zeros for an empty node). R and the row
//   chunks depend on n alone, and each instance's sort and runs on its
//   own pos, so an instance's histogram is bitwise the same alone or
//   inside any batch, and a re-run gives bitwise the same result (float
//   atomics from several warps into one cell would break both).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;      // threads of a histogram block: features
constexpr int kTileRows = 32;  // rows a histogram block stages at a time

__device__ __forceinline__ float round_operand(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// component i of a float4 (i a constant once the caller's loop unrolls)
__device__ __forceinline__ float lane_of(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// Workspace of int32 words, per instance g (offsets in words):
//   base  [G][m][nch]  counts, then (in place) each (node, chunk)'s
//                      first slot in perm
//   seg   [G][m][2]    a node's first slot in perm and its row count
//   items [G][m+1]     a node's first run; items[g][m] = runs of g
//   perm  [G][n]       rows of g grouped by node, row order inside
struct Workspace {
  int32_t* base;
  int32_t* seg;
  int32_t* items;
  int32_t* perm;
};

inline long long ws_words(int G, int n, int m, int nch) {
  return (long long)G * m * nch + 2LL * G * m + (long long)G * (m + 1) +
         (long long)G * n;
}

inline Workspace carve(int32_t* w, int G, int n, int m, int nch) {
  Workspace s;
  s.base = w;
  s.seg = s.base + (long long)G * m * nch;
  s.items = s.seg + 2LL * G * m;
  s.perm = s.items + (long long)G * (m + 1);
  return s;
}

// (1) rows of each node in chunk c of instance g. Block (g, c).
__global__ void tree_hist_sort_count(const int32_t* __restrict__ pos,
                                     int32_t* __restrict__ base, int n, int m,
                                     int nch, int chunk_rows) {
  extern __shared__ int32_t cnt[];
  const int g = blockIdx.x / nch;
  const int c = blockIdx.x % nch;
  for (int e = threadIdx.x; e < m; e += blockDim.x) cnt[e] = 0;
  __syncthreads();
  const long long r0 = (long long)c * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const int32_t* pg = pos + (long long)g * n;
  for (long long i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const int node = pg[i];
    if ((unsigned)node < (unsigned)m) atomicAdd(&cnt[node], 1);
  }
  __syncthreads();
  int32_t* bg = base + (long long)g * m * nch;
  for (int e = threadIdx.x; e < m; e += blockDim.x)
    bg[(long long)e * nch + c] = cnt[e];
}

// Exclusive scan of one int per thread over the block (blockDim a
// multiple of 32, at most 1024); *total gets the sum. Integer sums, so
// the order of the adds does not matter.
__device__ int32_t block_exclusive_scan(int32_t v, int32_t* warp_sums,
                                        int32_t* total) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    const int32_t s = lane < nw ? warp_sums[lane] : 0;
    int32_t xs = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, xs, o);
      if (lane >= o) xs += y;
    }
    if (lane < nw) warp_sums[lane] = xs - s;
    if (lane == 31) *total = xs;
  }
  __syncthreads();
  const int32_t out = warp_sums[w] + x - v;
  __syncthreads();  // warp_sums and *total may be reused after this
  return out;
}

// (2) exclusive scan of g's counts in (node, chunk) order, in place; a
// node's first slot and row count; its first run of R rows. Block g.
__global__ void tree_hist_sort_scan(int32_t* __restrict__ base,
                                    int32_t* __restrict__ seg,
                                    int32_t* __restrict__ items, int m, int nch,
                                    int R) {
  __shared__ int32_t warp_sums[32];
  __shared__ int32_t total_s;
  const int g = blockIdx.x;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long L = (long long)m * nch;
  int32_t* bg = base + (long long)g * L;
  // each thread scans a contiguous range of the (node, chunk) counts
  const long long per = (L + T - 1) / T;
  const long long a = min(L, (long long)t * per);
  const long long b = min(L, a + per);
  int32_t local = 0;
  for (long long e = a; e < b; ++e) local += bg[e];
  int32_t run = block_exclusive_scan(local, warp_sums, &total_s);
  const int32_t total = total_s;  // read before the next scan rewrites it
  for (long long e = a; e < b; ++e) {
    const int32_t v = bg[e];
    bg[e] = run;
    run += v;
  }
  __syncthreads();  // every first slot is written
  int32_t* sg = seg + 2LL * g * m;
  int32_t* ig = items + (long long)g * (m + 1);
  int32_t carry = 0;
  for (int node0 = 0; node0 < m; node0 += T) {
    const int node = node0 + t;
    int32_t runs = 0;
    if (node < m) {
      const int32_t start = bg[(long long)node * nch];
      const int32_t end =
          node + 1 < m ? bg[(long long)(node + 1) * nch] : total;
      sg[2 * node] = start;
      sg[2 * node + 1] = end - start;
      runs = (end - start + R - 1) / R;
    }
    const int32_t first = block_exclusive_scan(runs, warp_sums, &total_s);
    if (node < m) ig[node] = carry + first;
    carry += total_s;
    __syncthreads();  // total_s is read by every thread before reuse
  }
  if (t == 0) ig[m] = carry;
}

// (3) stable scatter of chunk c of instance g: one warp walks the
// chunk's rows in order, 32 at a time; lanes on one node rank among
// themselves with a match mask and take consecutive slots. Block (g, c)
// of 32 threads.
__global__ void tree_hist_sort_scatter(const int32_t* __restrict__ pos,
                                       const int32_t* __restrict__ base,
                                       int32_t* __restrict__ perm, int n, int m,
                                       int nch, int chunk_rows) {
  extern __shared__ int32_t next[];
  const int g = blockIdx.x / nch;
  const int c = blockIdx.x % nch;
  const int lane = threadIdx.x;
  const int32_t* bg = base + (long long)g * m * nch;
  for (int e = lane; e < m; e += 32) next[e] = bg[(long long)e * nch + c];
  __syncwarp();
  const long long r0 = (long long)c * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const int32_t* pg = pos + (long long)g * n;
  int32_t* out = perm + (long long)g * n;
  const unsigned below = (1u << lane) - 1u;
  for (long long i0 = r0; i0 < r1; i0 += 32) {
    const long long i = i0 + lane;
    const int node = i < r1 ? pg[i] : -1;
    const bool ok = (unsigned)node < (unsigned)m;
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? node : -1);
    const int rank = __popc(peers & below);
    int slot = 0;
    if (ok) slot = next[node] + rank;
    __syncwarp();
    if (ok) {
      out[slot] = (int32_t)i;
      if (rank == 0) next[node] += __popc(peers);
    }
    __syncwarp();
  }
}

// (4) the histogram pass. Block (g, run, feature chunk): one warp,
// lane = feature; see the design note. Shared memory: the slab
// [S][B+1][32] floats, then two tiles of kTileRows rows, each [r][32]
// raw bins and [r][SP] raw stats (SP = S rounded up to 4, so a row's
// stats are whole 16-byte vectors, read by the warp as one broadcast).
// kS and kB are S and B when the kernel is built for them (S = 3 and 5,
// the tree families' counts, at B = 32, their bins), else 0 (read at
// run time; a stat's add after another's). On an H100 the specialised
// loop takes 0.55 ms at the histogram capture shape where the run-time
// loop takes 0.94-0.98 ms (both timed in one run of chip_smoke.py;
// PERF.md). Stats are rounded to the operand dtype in the tile, once
// per (row, stat).
template <bool kBf16, int kS, int kB>
__global__ void __launch_bounds__(32)
tree_hist_run(const int32_t* __restrict__ bins,
              const float* __restrict__ stats,
              const int32_t* __restrict__ perm,
              const int32_t* __restrict__ seg,
              const int32_t* __restrict__ items,
              float* __restrict__ partial, int n, int d, int S_run, int m,
              int B_run, int R, int nchunks, int runs_cap) {
  const int S = kS > 0 ? kS : S_run;
  const int B = kB > 0 ? kB : B_run;
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int c = (int)(blockIdx.x % nchunks);
  const long long rest = blockIdx.x / nchunks;
  const int run = (int)(rest % runs_cap);
  const int g = (int)(rest / runs_cap);
  const int32_t* ig = items + (long long)g * (m + 1);
  if (run >= ig[m]) return;
  // the node whose runs hold `run`: the last node with ig[node] <= run
  int lo = 0, hi = m - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ig[mid] <= run) lo = mid; else hi = mid - 1;
  }
  const int k = run - ig[lo];
  const int32_t* sg = seg + 2LL * g * m;
  const int first = sg[2 * lo] + k * R;
  const int rows = min(R, sg[2 * lo + 1] - k * R);

  const int j0 = c * kWarp;
  const int fc = min(kWarp, d - j0);
  const int plane = (B + 1) * kWarp;  // one stat's cells
  float* slab = smem;
  int32_t* tiles = reinterpret_cast<int32_t*>(slab + (size_t)S * plane);
  const int SP = (S + 3) & ~3;
  const int tile_words = kTileRows * (kWarp + SP);
  for (int e = lane; e < S * plane; e += kWarp) slab[e] = 0.0f;

  const int32_t* pr = perm + (long long)g * n + first;
  const float* sgs = stats + (long long)g * n * S;
  const int ntiles = (rows + kTileRows - 1) / kTileRows;
  // lane r holds the row index of a tile's row r
  auto row_index = [&](int it) {
    const int r = it * kTileRows + lane;
    return r < rows ? pr[r] : 0;
  };
  // start the copies of tile `it` (row indices `idx`) into buffer it & 1
  auto issue = [&](int it, int idx) {
    int32_t* tb = tiles + (it & 1) * tile_words;
    float* ts = reinterpret_cast<float*>(tb + kTileRows * kWarp);
    const int tr = min(kTileRows, rows - it * kTileRows);
    for (int r = 0; r < tr; ++r) {
      const int row = __shfl_sync(0xffffffffu, idx, r);
      if (lane < fc)
        __pipeline_memcpy_async(tb + r * kWarp + lane,
                                bins + (long long)row * d + j0 + lane, 4);
    }
    for (int e0 = 0; e0 < tr * S; e0 += kWarp) {
      const int e = e0 + lane;
      const int r = min(e / S, tr - 1);
      const int row = __shfl_sync(0xffffffffu, idx, r);
      if (e < tr * S)
        __pipeline_memcpy_async(ts + r * SP + (e - r * S),
                                sgs + (long long)row * S + (e - r * S), 4);
    }
    __pipeline_commit();
  };

  int idx_next = 0;
  if (ntiles > 0) issue(0, row_index(0));
  if (ntiles > 1) idx_next = row_index(1);
  for (int it = 0; it < ntiles; ++it) {
    // the copies of tile it + 1 overlap the adds of tile it; its buffer
    // was released by the __syncwarp that ended tile it - 1
    if (it + 1 < ntiles) {
      issue(it + 1, idx_next);
      if (it + 2 < ntiles) idx_next = row_index(it + 2);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    const int32_t* tb = tiles + (it & 1) * tile_words;
    float* ts = reinterpret_cast<float*>(tiles + (it & 1) * tile_words +
                                         kTileRows * kWarp);
    const int tr = min(kTileRows, rows - it * kTileRows);
    if (kBf16) {  // the stats this lane copied (see issue), rounded
      for (int e = lane; e < tr * S; e += kWarp) {
        float* p = ts + (e / S) * SP + e % S;
        *p = round_operand(*p, true);
      }
    }
    __syncwarp();
    if (lane < fc) {
      if constexpr (kS > 0) {
        // a row's S cells are distinct: read them all, then write them
        // all; the next row's bin and stats are read before this row's
        // writes (its cells are read after them: rows add in order)
        constexpr int kV = (kS + 3) / 4;  // 16-byte vectors a row
        constexpr int kPlane = (kB + 1) * kWarp;
        constexpr int kSP = kV * 4;
        int b = tb[lane];
        float4 q[kV];
#pragma unroll
        for (int k = 0; k < kV; ++k)
          q[k] = reinterpret_cast<const float4*>(ts)[k];
#pragma unroll 2
        for (int r = 0; r < tr; ++r) {
          float* cell =
              slab + ((unsigned)b < (unsigned)kB ? b : kB) * kWarp + lane;
          float cur[kS];
#pragma unroll
          for (int s = 0; s < kS; ++s) cur[s] = cell[s * kPlane];
          const int rn = min(r + 1, tr - 1);
          const int bn = tb[rn * kWarp + lane];
          float4 qn[kV];
#pragma unroll
          for (int k = 0; k < kV; ++k)
            qn[k] = reinterpret_cast<const float4*>(ts + rn * kSP)[k];
#pragma unroll
          for (int s = 0; s < kS; ++s)
            cell[s * kPlane] = cur[s] + lane_of(q[s / 4], s % 4);
          b = bn;
#pragma unroll
          for (int k = 0; k < kV; ++k) q[k] = qn[k];
        }
      } else {
        for (int r = 0; r < tr; ++r) {
          const int b = tb[r * kWarp + lane];
          const int off = ((unsigned)b < (unsigned)B ? b : B) * kWarp + lane;
          for (int s = 0; s < S; ++s) slab[s * plane + off] += ts[r * SP + s];
        }
      }
    }
    __syncwarp();
  }
  // partial (g, run, s, j0 + lane, b): each lane its own B cells a stat
  if (lane < fc) {
    const long long SDB = (long long)S * d * B;
    float* o = partial + ((long long)g * runs_cap + run) * SDB;
    for (int s = 0; s < S; ++s) {
      float* os = o + ((long long)s * d + j0 + lane) * B;
      for (int b = 0; b < B; ++b) os[b] = slab[s * plane + b * kWarp + lane];
    }
  }
}

// (5) out[g, node, e] = sum over the node's runs, in run order.
__global__ void tree_hist_reduce(const float* __restrict__ partial,
                                 const int32_t* __restrict__ items,
                                 float* __restrict__ out, int G, int m,
                                 long long SDB, int runs_cap) {
  const long long count = (long long)G * m * SDB;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       x < count; x += stride) {
    const long long gn = x / SDB;
    const long long e = x % SDB;
    const int g = (int)(gn / m);
    const int node = (int)(gn % m);
    const int32_t* ig = items + (long long)g * (m + 1);
    const int r0 = ig[node];
    const int r1 = ig[node + 1];
    const float* p = partial + ((long long)g * runs_cap) * SDB + e;
    float acc = 0.0f;
    for (int r = r0; r < r1; ++r) acc += p[(long long)r * SDB];
    out[x] = acc;
  }
}

int max_smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    bytes = v > 0 ? v : 48 * 1024;
  }
  return bytes;
}

unsigned grid_for(long long count) {
  long long blocks = (count + 255) / 256;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  return (unsigned)(blocks > 0 ? blocks : 1);
}


template <bool kBf16, int kS, int kB>
void launch_run(const int32_t* bins, const float* stats, const Workspace& w,
                float* partial, int n, int d, int S, int m, int B, int R,
                int nchunks, int runs_cap, long long blocks, size_t smem,
                cudaStream_t st) {
  cudaFuncSetAttribute(tree_hist_run<kBf16, kS, kB>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  tree_hist_run<kBf16, kS, kB><<<(unsigned)blocks, kWarp, smem, st>>>(
      bins, stats, w.perm, w.seg, w.items, partial, n, d, S, m, B, R,
      nchunks, runs_cap);
}

template <bool kBf16>
void launch_run_for(int S, const int32_t* bins, const float* stats,
                    const Workspace& w, float* partial, int n, int d, int m,
                    int B, int R, int nchunks, int runs_cap, long long blocks,
                    size_t smem, cudaStream_t st) {
  if (S == 3 && B == 32)
    launch_run<kBf16, 3, 32>(bins, stats, w, partial, n, d, S, m, B, R,
                             nchunks, runs_cap, blocks, smem, st);
  else if (S == 5 && B == 32)
    launch_run<kBf16, 5, 32>(bins, stats, w, partial, n, d, S, m, B, R,
                             nchunks, runs_cap, blocks, smem, st);
  else
    launch_run<kBf16, 0, 0>(bins, stats, w, partial, n, d, S, m, B, R,
                            nchunks, runs_cap, blocks, smem, st);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream, as a CUstream handle)
// and returns the first CUDA error of its launches: 0 on success. The
// wrapper allocates the scratch: `work`, `work_words` int32 words (the
// Workspace layout), and `partial`, `partial_floats` floats (G *
// runs_cap * S*d*B, runs_cap >= ceil(n/R) + m: the most runs an
// instance can need); too little of either is an invalid value.
// Allocates nothing and does not synchronise.
extern "C" int tm_tree_histogram(const int32_t* bins, const float* stats,
                                 const int32_t* pos, float* out,
                                 int32_t* work, long long work_words,
                                 float* partial, long long partial_floats,
                                 int n, int d, int G, int S, int m, int B,
                                 int bf16, int R, int chunk_rows,
                                 int runs_cap, void* stream) {
  if (G <= 0 || d <= 0) return 0;
  if (R <= 0 || chunk_rows <= 0 || S <= 0 || m <= 0 || B <= 0 || n < 0 ||
      runs_cap < (n + R - 1) / R + m || (long long)m * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int nch = n > 0 ? (n + chunk_rows - 1) / chunk_rows : 1;
  if (work_words < ws_words(G, n, m, nch) ||
      partial_floats < (long long)G * runs_cap * S * d * B)
    return (int)cudaErrorInvalidValue;
  const int nchunks = (d + kWarp - 1) / kWarp;
  // the slab, then two row tiles (see tree_hist_run)
  const size_t smem =
      ((size_t)S * (B + 1) * kWarp +
       2 * (size_t)kTileRows * (kWarp + ((S + 3) & ~3))) * sizeof(float);
  if (smem > (size_t)max_smem_optin()) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)G * runs_cap * nchunks;
  if (blocks > 0x7fffffffLL || (long long)G * nch > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Workspace w = carve(work, G, n, m, nch);

  const size_t node_smem = (size_t)m * sizeof(int32_t);
  tree_hist_sort_count<<<(unsigned)(G * nch), 256, node_smem, st>>>(
      pos, w.base, n, m, nch, chunk_rows);
  tree_hist_sort_scan<<<(unsigned)G, 1024, 0, st>>>(w.base, w.seg, w.items,
                                                    m, nch, R);
  tree_hist_sort_scatter<<<(unsigned)(G * nch), 32, node_smem, st>>>(
      pos, w.base, w.perm, n, m, nch, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (bf16)
    launch_run_for<true>(S, bins, stats, w, partial, n, d, m, B, R, nchunks,
                         runs_cap, blocks, smem, st);
  else
    launch_run_for<false>(S, bins, stats, w, partial, n, d, m, B, R, nchunks,
                          runs_cap, blocks, smem, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long SDB = (long long)S * d * B;
  tree_hist_reduce<<<grid_for((long long)G * m * SDB), 256, 0, st>>>(
      partial, w.items, out, G, m, SDB, runs_cap);
  return (int)cudaGetLastError();
}

extern "C" const char* tm_tree_histogram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
