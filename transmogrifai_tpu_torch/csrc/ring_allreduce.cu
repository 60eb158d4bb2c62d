// All-gather and all-reduce over the ranks of a data mesh, as a direct
// exchange between two barriers.
//
// Replaces the TPU kernel transmogrifai_tpu/models/kernels.py
// ring_allgather -> _ring_gather_kernel (Pallas: after a neighbour
// barrier, ndev-1 `make_async_remote_copy` hops push the chunk held in
// slot s to the right neighbour's slot s+1; outside the kernel the slots
// are remapped to origin order, and ring_allreduce sums them there).
// The names keep "ring" after that counterpart; the schedule is no
// longer a ring. A TPU chip reaches its neighbours over the ICI ring, so
// the Pallas kernel hops. Here every rank's input and output can be
// addressed by every rank (on one card trivially, across cards through
// peer access), so no data needs to hop: a ring's ndev-1 dependent
// steps, each a flag round trip behind a copy, collapse into one round
// of loads and stores between two barriers.
//
// What it computes (the same function, not the same blocks). Rank r of
// ndev holds x_r, a float32 vector of numel values. Per element i and on
// every rank,
//
//   all-reduce:  out[i] = ((x_0[i] + x_1[i]) + x_2[i]) + ... + x_{ndev-1}[i]
//   all-gather:  out[o * numel + i] = x_o[i]
//
// summed left to right in origin order 0..ndev-1 in f32 (__fadd_rn), so
// every rank holds the same bits, equal to the plain version's
// (models/kernels.py ring_allreduce_torch).
//
// Launch model. One process drives every rank, as JAX's single
// controller does: one host call (tm_ring_launch_all) launches rank r's
// kernel on rank r's own stream for every rank, with no host
// synchronisation between the launches, each passed every rank's input,
// output and flag words and the call's epoch (a count the host raises
// by one per call). Ranks may be distinct cards (peer access enabled
// between every pair by tm_ring_enable_peer) or several streams on one
// card; the protocol is the same.
//
// Protocol, per block b of rank r (every rank launches the same number
// of blocks; block b of each rank pairs with block b of the others):
//   1. entry barrier: release-store `epoch` into block b's "arrived"
//      word for rank r in every rank's flags, then wait until the ndev
//      "arrived" words of block b in its own flags reach `epoch`. After
//      this every rank's kernel of this call has started, so each
//      rank's stream is past all earlier work on its input and output,
//      and past its kernel of the previous call.
//   2. exchange. All-reduce: rank r owns partition r of the elements
//      (`part` values, a multiple of 4, split over its blocks in chunks
//      of `chunk`); block b reads its chunk of partition r from all ndev
//      inputs, sums them in origin order and writes the sum into the
//      same place of every rank's output. Each element is summed once,
//      so every rank holds the same bits. All-gather: block b of rank r
//      writes its chunk of x_r into slot r of every rank's output.
//   3. exit barrier: after a block barrier, release-store `epoch` into
//      block b's "done" word for rank r in every rank's flags, then wait
//      for the ndev "done" words of block b in its own flags. When every
//      block of rank r has passed it, every rank has written its part
//      of rank r's output and no rank reads rank r's input any more: the
//      caller may free or overwrite it once rank r's stream is past the
//      kernel.
// Each of a block's ndev stores and waits is done by its own thread, so
// the round trips to the ranks overlap. Flags only ever rise (the
// epoch), so nothing is reset between calls. Flag accesses use GPU scope
// when every rank is on one card, system scope across peers; a release
// after a block barrier orders the whole block's earlier writes before
// the flag. Each wait is bounded by %globaltimer; past the bound the
// block prints what it waited for and traps, so a protocol fault
// surfaces as a CUDA error at the next synchronisation, not as a hang.
//
// Co-residency. A block spins on words the other ranks' blocks write, so
// every block of every rank must be resident at once: the wrapper caps a
// call's blocks at kWaveBlocks / ndev (one block an SM on one card even
// when all ranks share it) and derives the chunking from numel and ndev
// alone (models/kernels.py ring_plan). Module loading is forced before
// the first launch (tm_ring_prepare): with CUDA's lazy loading, a
// kernel loaded while another rank spins could wait on that rank.
//
// What bounds it on an H100. An all-reduce reads each input once and
// writes each output once: 8 x numel bytes a rank, 8 x ndev x numel a
// call on one card (models/kernels.py ring_cost), mostly through the
// 50 MB L2; there is no arithmetic to speak of. At the parts the grow
// reduces (~2 MB a rank) the two barrier round trips and the launch
// cost about as much as the bytes. 1024 threads a block keep 64 KB of
// 16-byte loads in flight on its SM; inputs and outputs of other ranks
// are read and written through L2 (ld/st.global.cg), since other SMs
// write them behind L1's back.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kWaveBlocks = 132;     // blocks a call may have, all ranks
constexpr int kThreads = 1024;

// Flag words of one rank: row src ("arrived" from rank src) and row
// kMaxRanks + src ("done" from rank src), kWaveBlocks words a row.
constexpr int kFlagRows = 2 * kMaxRanks;

// Every rank's pointers. The kernel takes it as a __grid_constant__
// parameter, so the loops over ranks index it in constant memory
// rather than copying it into local memory.
struct RingPeers {
  const float* ins[kMaxRanks];
  float* outs[kMaxRanks];
  unsigned int* flags[kMaxRanks];
};

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
    __nanosleep(64);
  }
}

// A barrier of block b across the ranks on flag row `row0 + src`: thread
// q < ndev tells rank q that this rank arrived, then waits for rank q.
template <bool kSys>
__device__ __forceinline__ void rank_barrier(const RingPeers& peers,
                                             int rank, int ndev, int row0,
                                             unsigned int epoch,
                                             long long timeout_ns) {
  const int b = blockIdx.x;
  const int q = threadIdx.x;
  if (q < ndev) {
    st_release<kSys>(peers.flags[q] + (row0 + rank) * kWaveBlocks + b,
                     epoch);
    wait_epoch<kSys>(peers.flags[rank] + (row0 + q) * kWaveBlocks + b, epoch,
                     timeout_ns, rank, row0 + q, b);
  }
  __syncthreads();
}

// Block-wide copy of `len` floats to every rank's `dst + off`; `kVec`:
// every pointer 16-byte aligned. Each load is issued once and stored
// ndev times.
template <bool kVec>
__device__ __forceinline__ void push_chunk(const RingPeers& peers, int ndev,
                                           long long off, const float* src,
                                           long long len) {
  long long done = 0;
  if (kVec) {
    const long long n4 = len >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (long long t = threadIdx.x; t < n4; t += blockDim.x) {
      const float4 v = __ldcg(s4 + t);
      for (int q = 0; q < ndev; ++q)
        __stcg(reinterpret_cast<float4*>(peers.outs[q] + off) + t, v);
    }
    done = n4 << 2;
  }
  for (long long t = done + threadIdx.x; t < len; t += blockDim.x) {
    const float v = __ldcg(src + t);
    for (int q = 0; q < ndev; ++q) __stcg(peers.outs[q] + off + t, v);
  }
}

// Origin-order sum of [lo, lo + len) over every rank's input, written
// into the same place of every rank's output.
template <bool kVec>
__device__ __forceinline__ void reduce_chunk(const RingPeers& peers,
                                             int ndev, long long lo,
                                             long long len) {
  long long done = 0;
  if (kVec) {
    const long long n4 = len >> 2;
    for (long long t = threadIdx.x; t < n4; t += blockDim.x) {
      float4 acc = __ldcg(reinterpret_cast<const float4*>(peers.ins[0] + lo)
                          + t);
      for (int o = 1; o < ndev; ++o) {
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(peers.ins[o] + lo) + t);
        acc.x = __fadd_rn(acc.x, v.x);
        acc.y = __fadd_rn(acc.y, v.y);
        acc.z = __fadd_rn(acc.z, v.z);
        acc.w = __fadd_rn(acc.w, v.w);
      }
      for (int q = 0; q < ndev; ++q)
        __stcg(reinterpret_cast<float4*>(peers.outs[q] + lo) + t, acc);
    }
    done = n4 << 2;
  }
  for (long long t = done + threadIdx.x; t < len; t += blockDim.x) {
    float acc = __ldcg(peers.ins[0] + lo + t);
    for (int o = 1; o < ndev; ++o)
      acc = __fadd_rn(acc, __ldcg(peers.ins[o] + lo + t));
    for (int q = 0; q < ndev; ++q) __stcg(peers.outs[q] + lo + t, acc);
  }
}

template <bool kVec, bool kSys>
__global__ void __launch_bounds__(kThreads)
ring_kernel(const __grid_constant__ RingPeers peers, int rank, int ndev,
            long long numel, long long part, long long chunk,
            unsigned int epoch, int gather, long long timeout_ns) {
  const int b = blockIdx.x;
  rank_barrier<kSys>(peers, rank, ndev, 0, epoch, timeout_ns);     // 1.
  if (gather) {                                                    // 2.
    const long long lo = (long long)b * chunk;
    const long long len = min(chunk, numel - lo);
    if (len > 0)
      push_chunk<kVec>(peers, ndev, (long long)rank * numel + lo,
                       peers.ins[rank] + lo, len);
  } else {
    const long long p_lo = (long long)rank * part;
    const long long p_hi = min(numel, p_lo + part);
    const long long lo = p_lo + (long long)b * chunk;
    const long long len = min(chunk, p_hi - lo);
    if (len > 0) reduce_chunk<kVec>(peers, ndev, lo, len);
  }
  __syncthreads();        // the block's writes, then the flags' release
  rank_barrier<kSys>(peers, rank, ndev, kMaxRanks, epoch, timeout_ns);  // 3.
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
// rank that starts first spins until the others arrive). `ins` and
// `outs` are each rank's input (numel floats) and output (numel floats,
// or ndev x numel when `gather`); `vec`: every pointer is 16-byte
// aligned (and numel a multiple of 4 when `gather`); `part` and `chunk`
// (multiples of 4 when `vec`) cut the elements as ring_kernel says;
// `sys_scope`: the ranks are not all on one card, so flags are
// released and acquired at system scope (else GPU scope). `flags` are
// every rank's flag words (kFlagRows x kWaveBlocks uint32, zeroed once).
// Returns cudaGetLastError() after the launch that failed, with its
// rank in *failed_rank, or 0. Restores the current device; allocates
// nothing, does not synchronise.
extern "C" int tm_ring_launch_all(int ndev, const int* devices,
                                  void* const* ins, void* const* outs,
                                  void* const* flags, void* const* streams,
                                  int vec, long long numel, long long part,
                                  long long chunk, int nblocks,
                                  unsigned int epoch, int gather,
                                  int sys_scope, long long timeout_ns,
                                  int* failed_rank) {
  *failed_rank = -1;
  const long long per_rank = gather ? numel : part;
  if (ndev < 1 || ndev > kMaxRanks || nblocks < 1 ||
      nblocks * ndev > kWaveBlocks || chunk < 1 || part < 1 ||
      (long long)nblocks * chunk < per_rank || (long long)ndev * part < numel ||
      (vec && (part % 4 || chunk % 4))) {
    return (int)cudaErrorInvalidValue;
  }
  RingPeers peers;
  for (int r = 0; r < kMaxRanks; ++r) {
    peers.ins[r] = r < ndev ? static_cast<const float*>(ins[r]) : nullptr;
    peers.outs[r] = r < ndev ? static_cast<float*>(outs[r]) : nullptr;
    peers.flags[r] = r < ndev ? static_cast<unsigned int*>(flags[r]) : nullptr;
  }
  int prev = 0;
  cudaGetDevice(&prev);
  int err = 0;
  for (int r = 0; r < ndev && err == 0; ++r) {
    err = (int)cudaSetDevice(devices[r]);
    if (err == 0) {
      cudaStream_t s = static_cast<cudaStream_t>(streams[r]);
      auto kernel = vec ? (sys_scope ? ring_kernel<true, true>
                                     : ring_kernel<true, false>)
                        : (sys_scope ? ring_kernel<false, true>
                                     : ring_kernel<false, false>);
      kernel<<<nblocks, kThreads, 0, s>>>(peers, r, ndev, numel, part, chunk,
                                          epoch, gather, timeout_ns);
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
