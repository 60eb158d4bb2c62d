// Ring all-gather and all-reduce over the ranks of a data mesh.
//
// Replaces the TPU kernel transmogrifai_tpu/models/kernels.py
// ring_allgather -> _ring_gather_kernel (Pallas: after a neighbour
// barrier, ndev-1 `make_async_remote_copy` hops push the chunk held in
// slot s to the right neighbour's slot s+1; outside the kernel the slots
// are remapped to origin order, and ring_allreduce sums them there).
//
// What it computes (the same function, not the same blocks). Rank r of
// ndev holds x_r, a float32 vector of numel values. Slot j of rank r
// ends up holding x_{(r-j) mod ndev}, the vector j hops to its left;
// slot 0 is x_r itself, read straight from the input. Then, per element
// i and on every rank,
//
//   all-reduce:  out[i] = ((x_0[i] + x_1[i]) + x_2[i]) + ... + x_{ndev-1}[i]
//   all-gather:  out[o * numel + i] = x_o[i]
//
// summed left to right in origin order 0..ndev-1 in f32, so every rank
// holds the same bits, equal to the plain version's
// (models/kernels.py ring_allreduce_torch).
//
// Launch model. One process drives every rank, as JAX's single
// controller does: one host call (tm_ring_launch_all) launches rank r's
// kernel on rank r's own stream for every rank, with no host
// synchronisation between the launches, each passed every rank's slot
// buffer and flag words and the call's epoch (a count the host raises
// by one per call). Ranks may be distinct cards (peer access enabled
// by tm_ring_enable_peer) or several streams on one card; the protocol
// is the same.
//
// Protocol, per block b of rank r (block b owns elements
// [b*chunk, b*chunk + chunk) of every slot):
//   1. neighbour barrier: store `epoch` into the left neighbour's
//      "from right" word and the right neighbour's "from left" word of
//      block b, then wait for both of its own. A rank's kernels run in
//      stream order, so a neighbour that reached this point of call e is
//      done with every slot of call e-1: call e's pushes cannot land in
//      slots it is still summing.
//   2. step s = 0..ndev-2: wait until its own slot s of block b has
//      arrived (s > 0), copy that chunk into the right neighbour's slot
//      s+1, then (a block barrier, then one thread) release-store
//      `epoch` into the neighbour's arrival word [s+1][b]: at GPU scope
//      when every rank is on one card, at system scope across peers. Per-block words pipeline the
//      steps with no grid-wide synchronisation.
//   3. wait for slot ndev-1, then sum (or lay out) the ndev slots of its
//      chunk in origin order and write the output.
// Flags only ever rise (the epoch), so nothing is reset between calls.
// Each wait is bounded by %globaltimer; past the bound the block prints
// what it waited for and traps, so a protocol fault surfaces as a CUDA
// error at the next synchronisation, not as a hang.
//
// Co-residency. A rank spins on words its neighbours write, so every
// block of every rank must be resident at once: the wrapper caps a
// call's blocks at kWaveBlocks / ndev (one block an SM on one card even
// when all ranks share it) and derives the chunking from numel and ndev
// alone (models/kernels.py ring_plan). Module loading is forced before
// the first launch (tm_ring_prepare): with CUDA's lazy loading, a
// kernel loaded while another rank spins could wait on that rank.
//
// What bounds it on an H100. A call moves each rank's chunk ndev-1
// times and reads ndev slots to sum: ~(3 ndev - 1) x 4 x numel bytes a
// rank against the 8 x numel of reading an input and writing an output
// (models/kernels.py ring_cost); on one card those bytes share one HBM
// and mostly hit the 50 MB L2. Memory, and at small numel the launch
// and the flag round trips, bound it; there is no arithmetic to speak
// of. The design is the simple one that is right: 1024 threads a block,
// 16-byte vector copies where the pointers allow, slots read through
// L2 (ld.global.cg), since neighbours write them behind L1's back.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kWaveBlocks = 132;     // blocks a call may have, all ranks
// a block a rank per SM at most (co-residency), so a block is wide:
// 1024 threads keep 64 KB of 16-byte loads in flight on its SM
constexpr int kThreads = 1024;

// Flag words of one rank: row 0 "barrier from the left neighbour", row 1
// "barrier from the right neighbour", row 1+j "slot j arrived" (j >= 1);
// kWaveBlocks words a row. Slot j (j >= 1) of a rank lives at
// slots[(j - 1) * cap].
constexpr int kFlagRows = kMaxRanks + 1;

struct RingPeers {
  float* slots[kMaxRanks];
  unsigned int* flags[kMaxRanks];
};

// Flag accesses at the scope the ranks share: the GPU when every rank
// is on one card, the system when ranks sit on peer cards. A release
// store is cumulative: after a block barrier it orders the whole
// block's earlier writes before the flag.
template <bool kSys>
__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  if (kSys) {
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  } else {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
  }
  return v;
}

template <bool kSys>
__device__ __forceinline__ void st_release(unsigned int* p, unsigned int v) {
  if (kSys) {
    asm volatile("st.release.sys.global.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
  } else {
    asm volatile("st.release.gpu.global.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin (one thread) until *p has reached `epoch`; trap past the bound.
template <bool kSys>
__device__ void wait_epoch(const unsigned int* p, unsigned int epoch,
                           long long timeout_ns, int rank, int row, int b) {
  const unsigned long long t0 = global_ns();
  while ((int)(ld_acquire<kSys>(p) - epoch) < 0) {
    if ((long long)(global_ns() - t0) > timeout_ns) {
      printf("ring_allreduce: rank %d block %d timed out on flag row %d "
             "(epoch %u, saw %u)\n", rank, b, row, epoch,
             ld_acquire<kSys>(p));
      __trap();
    }
    __nanosleep(100);
  }
}

// Block-wide copy of `len` floats; `kVec`: both pointers 16-byte
// aligned. Four 16-byte loads a thread are issued before their stores
// (the compiler may not hoist a load above a store that could alias it),
// so an L2 round trip is paid once per four vectors.
template <bool kVec>
__device__ __forceinline__ void copy_chunk(float* dst, const float* src,
                                           long long len) {
  long long done = 0;
  if (kVec) {
    const long long n4 = len >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const long long step = blockDim.x;
    long long t = threadIdx.x;
    for (; t + 3 * step < n4; t += 4 * step) {
      const float4 a = __ldcg(s4 + t);
      const float4 b = __ldcg(s4 + t + step);
      const float4 c = __ldcg(s4 + t + 2 * step);
      const float4 d = __ldcg(s4 + t + 3 * step);
      __stcg(d4 + t, a);
      __stcg(d4 + t + step, b);
      __stcg(d4 + t + 2 * step, c);
      __stcg(d4 + t + 3 * step, d);
    }
    for (; t < n4; t += step) {
      __stcg(d4 + t, __ldcg(s4 + t));
    }
    done = n4 << 2;
  }
  for (long long t = done + threadIdx.x; t < len; t += blockDim.x) {
    __stcg(dst + t, __ldcg(src + t));
  }
}

template <bool kVec, bool kSys>
__global__ void __launch_bounds__(kThreads)
ring_kernel(const float* __restrict__ in, float* __restrict__ out,
            RingPeers peers, int rank, int ndev, long long numel,
            long long chunk, long long cap, unsigned int epoch, int gather,
            long long timeout_ns) {
  const int b = blockIdx.x;
  const long long lo = (long long)b * chunk;
  const long long len = min(chunk, numel - lo);
  const int right = (rank + 1) % ndev;
  const int left = (rank + ndev - 1) % ndev;
  unsigned int* own = peers.flags[rank];
  const float* mine = peers.slots[rank];

  // 1. neighbour barrier
  if (threadIdx.x == 0) {
    st_release<kSys>(peers.flags[right] + 0 * kWaveBlocks + b, epoch);
    st_release<kSys>(peers.flags[left] + 1 * kWaveBlocks + b, epoch);
    wait_epoch<kSys>(own + 0 * kWaveBlocks + b, epoch, timeout_ns, rank, 0,
                     b);
    wait_epoch<kSys>(own + 1 * kWaveBlocks + b, epoch, timeout_ns, rank, 1,
                     b);
  }
  __syncthreads();

  // 2. ndev-1 pushes: own slot s -> right neighbour's slot s+1
  for (int s = 0; s + 1 < ndev; ++s) {
    if (s > 0) {
      if (threadIdx.x == 0) {
        wait_epoch<kSys>(own + (1 + s) * kWaveBlocks + b, epoch, timeout_ns,
                         rank, 1 + s, b);
      }
      __syncthreads();
    }
    const float* src = s == 0 ? in + lo : mine + (long long)(s - 1) * cap + lo;
    float* dst = peers.slots[right] + (long long)s * cap + lo;
    copy_chunk<kVec>(dst, src, len);
    __syncthreads();      // the block's writes, then the flag's release
    if (threadIdx.x == 0) {
      st_release<kSys>(peers.flags[right] + (2 + s) * kWaveBlocks + b, epoch);
    }
  }
  if (ndev > 1) {
    if (threadIdx.x == 0) {
      wait_epoch<kSys>(own + ndev * kWaveBlocks + b, epoch, timeout_ns, rank,
                       ndev, b);
    }
    __syncthreads();
  }

  // 3. origin order: origin o sits in slot (rank - o) mod ndev, whose
  // chunk origin_chunk() finds (computed, not kept in an array that
  // would live in local memory)
  auto origin_chunk = [&](int o) -> const float* {
    const int j = (rank - o + ndev) % ndev;
    return j == 0 ? in + lo : mine + (long long)(j - 1) * cap + lo;
  };
  if (gather) {
    for (int o = 0; o < ndev; ++o) {
      copy_chunk<kVec>(out + (long long)o * numel + lo, origin_chunk(o), len);
    }
    return;
  }
  long long done = 0;
  if (kVec) {
    const long long n4 = len >> 2;
    float4* o4 = reinterpret_cast<float4*>(out + lo);
    for (long long t = threadIdx.x; t < n4; t += blockDim.x) {
      float4 acc = __ldcg(reinterpret_cast<const float4*>(origin_chunk(0)) + t);
      for (int o = 1; o < ndev; ++o) {
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(origin_chunk(o)) + t);
        acc.x = __fadd_rn(acc.x, v.x);
        acc.y = __fadd_rn(acc.y, v.y);
        acc.z = __fadd_rn(acc.z, v.z);
        acc.w = __fadd_rn(acc.w, v.w);
      }
      o4[t] = acc;
    }
    done = n4 << 2;
  }
  for (long long t = done + threadIdx.x; t < len; t += blockDim.x) {
    float acc = __ldcg(origin_chunk(0) + t);
    for (int o = 1; o < ndev; ++o) {
      acc = __fadd_rn(acc, __ldcg(origin_chunk(o) + t));
    }
    out[lo + t] = acc;
  }
}

}  // namespace

// Loads every instantiation of the kernel into the current device's
// context (CUDA's lazy loading would otherwise load one at its first
// launch, possibly while another rank's kernel spins). Returns
// cudaGetLastError().
extern "C" int tm_ring_prepare(void) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ring_kernel<true, false>);
  if (e == cudaSuccess) {
    e = cudaFuncGetAttributes(&attr, ring_kernel<false, false>);
  }
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, ring_kernel<true, true>);
  if (e == cudaSuccess) {
    e = cudaFuncGetAttributes(&attr, ring_kernel<false, true>);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// Lets device `dev` read and write device `peer`'s memory. Returns 0 on
// success (or when already enabled), -1 when the pair cannot access each
// other, else the CUDA error. Restores the current device.
extern "C" int tm_ring_enable_peer(int dev, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return -1;
  int prev = 0;
  cudaGetDevice(&prev);
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)e;
}

// Launches one call: rank r's kernel on streams[r] (that rank's stream,
// a CUstream handle) on device devices[r], for every rank in order, all
// from this one host call so that the ranks start close together (a
// rank that starts first spins until its neighbours arrive). `ins` and
// `outs` are each rank's input (numel floats) and output (numel floats,
// or ndev x numel when `gather`); `vecs[r]` says rank r's two pointers
// are 16-byte aligned; `sys_scope`: the ranks are not all on one card,
// so flags are released and acquired at system scope (else GPU scope).
// `slots` and `flags` are every rank's slot buffer
// ((ndev-1) x cap floats) and flag words (kFlagRows x kWaveBlocks
// uint32, zeroed once). Returns cudaGetLastError() after the launch
// that failed, with its rank in *failed_rank, or 0. Restores the
// current device; allocates nothing, does not synchronise.
extern "C" int tm_ring_launch_all(int ndev, const int* devices,
                                  void* const* ins, void* const* outs,
                                  void* const* slots, void* const* flags,
                                  void* const* streams, const int* vecs,
                                  long long numel, long long chunk,
                                  int nblocks, long long cap,
                                  unsigned int epoch, int gather,
                                  int sys_scope, long long timeout_ns,
                                  int* failed_rank) {
  *failed_rank = -1;
  if (ndev < 1 || ndev > kMaxRanks || nblocks < 1 ||
      nblocks * ndev > kWaveBlocks || chunk < 1 ||
      (long long)nblocks * chunk < numel || cap < numel) {
    return (int)cudaErrorInvalidValue;
  }
  RingPeers peers;
  for (int r = 0; r < kMaxRanks; ++r) {
    peers.slots[r] = r < ndev ? static_cast<float*>(slots[r]) : nullptr;
    peers.flags[r] = r < ndev ? static_cast<unsigned int*>(flags[r]) : nullptr;
  }
  int prev = 0;
  cudaGetDevice(&prev);
  int err = 0;
  for (int r = 0; r < ndev && err == 0; ++r) {
    err = (int)cudaSetDevice(devices[r]);
    if (err == 0) {
      const float* in = static_cast<const float*>(ins[r]);
      float* out = static_cast<float*>(outs[r]);
      cudaStream_t s = static_cast<cudaStream_t>(streams[r]);
      auto kernel = vecs[r] ? (sys_scope ? ring_kernel<true, true>
                                         : ring_kernel<true, false>)
                            : (sys_scope ? ring_kernel<false, true>
                                         : ring_kernel<false, false>);
      kernel<<<nblocks, kThreads, 0, s>>>(in, out, peers, r, ndev, numel,
                                          chunk, cap, epoch, gather,
                                          timeout_ns);
      err = (int)cudaGetLastError();
    }
    if (err) *failed_rank = r;
  }
  cudaSetDevice(prev);
  return err;
}

extern "C" const char* tm_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shape of the flag words the wrapper allocates per rank.
extern "C" int tm_ring_flag_words(void) { return kFlagRows * kWaveBlocks; }
extern "C" int tm_ring_max_ranks(void) { return kMaxRanks; }
extern "C" int tm_ring_wave_blocks(void) { return kWaveBlocks; }
