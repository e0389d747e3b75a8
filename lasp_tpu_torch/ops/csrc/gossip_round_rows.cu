// K2 and K3 — the row-sparse frontier round's gather + join for Hopper
// (sm_90a): K2 the leafwise family, K3 the vclock (OR-SWOT) family.
//
// Replaces: lasp_tpu/ops/pallas_gossip.py pallas_gossip_round_rows[_grouped]
// (_rows_kernel, _rows_call, pallas_call at :439), with the leafwise join
// (_leafwise_join_fn) for K2 and _vclock_join (:259-272) for K3. For each
// group member g and slot f, with row = rows[g, f]:
//     acc = state[g][row]
//     for k in 0..K-1 (in k order), skipping dead edges under the mask:
//         acc = join(acc, state[g][neighbors[row, k]])
//     out[g, f] = acc;  changed[g, f] = any(acc != state[g][row])
// K2's join is one elementwise or / max over one or two leaves of one dtype
// and row width. K3's is lattice/dots.py merge_dots over (clock int32[A],
// dots int32[E, A]):
//     keep_a = (da > 0) & ((da == db) | (da > cb))
//     keep_b = (db > 0) & ((db == da) | (db > ca))
//     dots = max(keep_a ? da : 0, keep_b ? db : 0);  clock = max(ca, cb)
// where ca is the accumulated clock BEFORE step k and cb the neighbour's.
// Skipping a dead edge equals the dense round's own-state substitution:
// or and max absorb the own state already in acc, and on reachable OR-SWOT
// states (dots <= own clock pointwise) merging an absorbed ancestor is the
// identity. The scatter of out back into the population stays outside the
// kernel (the caller's epilogue): slots of one bucket may name each other
// as neighbours, and the round must read the state from before the round.
//
// Members are separate tensors: each launch takes, per leaf, a table of the
// G members' base pointers as a __grid_constant__ kernel parameter (at most
// kMaxGroup per launch; the launcher walks larger groups in chunks). A
// planned round therefore reads each member where it lies and never stacks
// the members' whole populations into a [G, R, ...] copy.
//
// What bounds them on the card: bytes — (K+1) gathered rows and one written
// row per slot (K3: 4·(A + E·A) bytes a row), one join per element read.
// The frontier's slots are scattered rows of an HBM-resident population,
// so each row read comes from HBM.
//
// What the design does about it: one block per slot; the block stages the
// slot's K neighbour indices (dead edges marked -1) in shared memory once,
// then its threads stride over the row's elements so every load of a warp
// is a contiguous segment of one row; the fold runs in registers, and the
// changed flag is the block's own reduction (__syncthreads_or), as the TPU
// kernel computes it in-kernel. K3 also stages the own clock and the K
// neighbour clocks ((K+1)·A words) in shared memory: the thread that owns
// dots column a keeps the running clock ca[a] of the fold's prefix in a
// register and reads cb[a] from shared memory at each step.
//
// Plain C interface, bound with ctypes (lasp_tpu_torch/ops/cuda_gossip.py);
// each launcher returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kOr = 0, kMax = 1 };
enum Dtype { kU8 = 0, kI32 = 1, kU32 = 2 };

constexpr int kMaxGroup = 64;
constexpr size_t kMaxSmem = 48 * 1024;

// base pointers of the members of one leaf, for one launch
struct Members {
  const void* p[kMaxGroup];
};

int block_threads(long long width) {
  int threads = 32;
  while (threads < width && threads < 256) threads <<= 1;
  return threads;
}

template <typename T, int OP>
__device__ __forceinline__ T join(T a, T b) {
  if (OP == kOr) return static_cast<T>(a | b);
  return a > b ? a : b;
}

// the slot's neighbour rows, -1 for a dead edge
__device__ __forceinline__ void stage_neighbours(
    int32_t* s_nbr, long long row, const int32_t* __restrict__ nbrs,
    const uint8_t* __restrict__ mask, int k) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    int32_t nb = nbrs[row * k + j];
    if (mask != nullptr && mask[row * k + j] == 0) nb = -1;
    s_nbr[j] = nb;
  }
}

template <typename T, int OP>
__global__ void gossip_round_rows_kernel(
    const __grid_constant__ Members plane0,
    const __grid_constant__ Members plane1, T* __restrict__ out0,
    T* __restrict__ out1, int n_leaves, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ nbrs, const uint8_t* __restrict__ mask,
    int32_t* __restrict__ changed, long long n_slots, long long width, int k) {
  extern __shared__ int32_t s_nbr[];
  const long long f = blockIdx.x;
  const int g = blockIdx.y;
  const long long row = rows[g * n_slots + f];
  stage_neighbours(s_nbr, row, nbrs, mask, k);
  __syncthreads();
  const long long out_off = (g * n_slots + f) * width;
  int diff = 0;
  for (int leaf = 0; leaf < n_leaves; ++leaf) {
    const T* plane =
        static_cast<const T*>(leaf == 0 ? plane0.p[g] : plane1.p[g]);
    T* out = leaf == 0 ? out0 : out1;
    for (long long i = threadIdx.x; i < width; i += blockDim.x) {
      const T own = plane[row * width + i];
      T acc = own;
      for (int j = 0; j < k; ++j) {
        const int32_t nb = s_nbr[j];
        if (nb < 0) continue;
        acc = join<T, OP>(acc, plane[(long long)nb * width + i]);
      }
      out[out_off + i] = acc;
      diff |= (acc != own);
    }
  }
  const int any = __syncthreads_or(diff);
  if (threadIdx.x == 0) changed[g * n_slots + f] = any ? 1 : 0;
}

template <typename T, int OP>
int launch_rows(const void* const* ptrs0, const void* const* ptrs1, void* out0,
                void* out1, int n_leaves, const int32_t* rows,
                const int32_t* nbrs, const uint8_t* mask, int32_t* changed,
                long long n_groups, long long n_slots, long long width, int k,
                cudaStream_t stream) {
  const int threads = block_threads(width);
  const size_t smem = (size_t)(k > 0 ? k : 1) * sizeof(int32_t);
  for (long long g0 = 0; g0 < n_groups; g0 += kMaxGroup) {
    const int gc = (int)(n_groups - g0 < kMaxGroup ? n_groups - g0 : kMaxGroup);
    Members m0 = {}, m1 = {};
    for (int i = 0; i < gc; ++i) {
      m0.p[i] = ptrs0[g0 + i];
      m1.p[i] = n_leaves > 1 ? ptrs1[g0 + i] : nullptr;
    }
    const long long slot0 = g0 * n_slots;
    gossip_round_rows_kernel<T, OP>
        <<<dim3((unsigned)n_slots, (unsigned)gc), threads, smem, stream>>>(
            m0, m1, static_cast<T*>(out0) + slot0 * width,
            n_leaves > 1 ? static_cast<T*>(out1) + slot0 * width : nullptr,
            n_leaves, rows + slot0, nbrs, mask, changed + slot0, n_slots,
            width, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

__global__ void gossip_round_rows_vclock_kernel(
    const __grid_constant__ Members clocks,
    const __grid_constant__ Members dots, int32_t* __restrict__ out_clock,
    int32_t* __restrict__ out_dots, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ nbrs, const uint8_t* __restrict__ mask,
    int32_t* __restrict__ changed, long long n_slots, int n_elems,
    int n_actors, int k) {
  extern __shared__ int32_t smem[];
  int32_t* s_nbr = smem;          // [k]
  int32_t* s_clock = smem + k;    // [(k+1) * A]: own clock, then neighbours'
  const long long f = blockIdx.x;
  const int g = blockIdx.y;
  const long long row = rows[g * n_slots + f];
  const int32_t* clock = static_cast<const int32_t*>(clocks.p[g]);
  const int32_t* dts = static_cast<const int32_t*>(dots.p[g]);
  const int a_n = n_actors;
  stage_neighbours(s_nbr, row, nbrs, mask, k);
  __syncthreads();
  for (int i = threadIdx.x; i < (k + 1) * a_n; i += blockDim.x) {
    const int j = i / a_n;
    const long long src = j == 0 ? row : (long long)s_nbr[j - 1];
    s_clock[i] = src < 0 ? 0 : clock[src * a_n + (i - j * a_n)];
  }
  __syncthreads();
  const long long slot = g * n_slots + f;
  int diff = 0;
  for (int a = threadIdx.x; a < a_n; a += blockDim.x) {
    const int32_t own = s_clock[a];
    int32_t c = own;
    for (int j = 0; j < k; ++j) {
      if (s_nbr[j] < 0) continue;
      const int32_t cb = s_clock[(j + 1) * a_n + a];
      c = c > cb ? c : cb;
    }
    out_clock[slot * a_n + a] = c;
    diff |= (c != own);
  }
  const long long row_words = (long long)n_elems * a_n;
  for (long long i = threadIdx.x; i < row_words; i += blockDim.x) {
    const int a = (int)(i % a_n);
    int32_t ca = s_clock[a];
    const int32_t own = dts[row * row_words + i];
    int32_t da = own;
    for (int j = 0; j < k; ++j) {
      const int32_t nb = s_nbr[j];
      if (nb < 0) continue;
      const int32_t cb = s_clock[(j + 1) * a_n + a];
      const int32_t db = dts[(long long)nb * row_words + i];
      const bool keep_a = da > 0 && (da == db || da > cb);
      const bool keep_b = db > 0 && (db == da || db > ca);
      const int32_t va = keep_a ? da : 0;
      const int32_t vb = keep_b ? db : 0;
      da = va > vb ? va : vb;
      ca = ca > cb ? ca : cb;
    }
    out_dots[slot * row_words + i] = da;
    diff |= (da != own);
  }
  const int any = __syncthreads_or(diff);
  if (threadIdx.x == 0) changed[slot] = any ? 1 : 0;
}

}  // namespace

// K2. ptrs0 / ptrs1: host arrays of the n_groups members' base pointers for
// leaf 0 / leaf 1, each member T[n_rows, width] (ptrs1 unused when n_leaves
// is 1); out0/out1: T[n_groups, n_slots, width]; rows: int32[n_groups,
// n_slots] and neighbors: int32[n_rows, k], entries in [0, n_rows); mask:
// uint8[n_rows, k] or null; changed: int32[n_groups, n_slots].
extern "C" int lasp_gossip_round_rows(
    int dtype, int op, const void* const* ptrs0, const void* const* ptrs1,
    void* out0, void* out1, int n_leaves, const void* rows,
    const void* neighbors, const void* mask, void* changed, long long n_groups,
    long long n_slots, long long width, int k, void* stream) {
  if (n_groups <= 0 || n_slots <= 0) return 0;
  if (n_leaves < 1 || n_leaves > 2 || k < 0 || n_slots > 0x7fffffffLL ||
      width <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const int32_t* nb = static_cast<const int32_t*>(neighbors);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int32_t* c = static_cast<int32_t*>(changed);
  if (dtype == kU8 && op == kOr) {
    return launch_rows<uint8_t, kOr>(ptrs0, ptrs1, out0, out1, n_leaves, r, nb,
                                     m, c, n_groups, n_slots, width, k, s);
  }
  if (dtype == kI32 && op == kMax) {
    return launch_rows<int32_t, kMax>(ptrs0, ptrs1, out0, out1, n_leaves, r,
                                      nb, m, c, n_groups, n_slots, width, k, s);
  }
  if (dtype == kU32 && op == kOr) {
    return launch_rows<uint32_t, kOr>(ptrs0, ptrs1, out0, out1, n_leaves, r,
                                      nb, m, c, n_groups, n_slots, width, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K3. clock_ptrs / dots_ptrs: host arrays of the n_groups members' base
// pointers, each member's clock int32[n_rows, n_actors] and dots
// int32[n_rows, n_elems, n_actors]; out_clock: int32[n_groups, n_slots,
// n_actors]; out_dots: int32[n_groups, n_slots, n_elems, n_actors]; rows,
// neighbors, mask and changed as for K2.
extern "C" int lasp_gossip_round_rows_vclock(
    const void* const* clock_ptrs, const void* const* dots_ptrs,
    void* out_clock, void* out_dots, const void* rows, const void* neighbors,
    const void* mask, void* changed, long long n_groups, long long n_slots,
    int n_elems, int n_actors, int k, void* stream) {
  if (n_groups <= 0 || n_slots <= 0) return 0;
  const size_t smem = (size_t)(k + (k + 1) * (long long)n_actors) * sizeof(int32_t);
  if (k < 0 || n_slots > 0x7fffffffLL || n_elems <= 0 || n_actors <= 0 ||
      smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = block_threads((long long)n_elems * n_actors);
  for (long long g0 = 0; g0 < n_groups; g0 += kMaxGroup) {
    const int gc = (int)(n_groups - g0 < kMaxGroup ? n_groups - g0 : kMaxGroup);
    Members mc = {}, md = {};
    for (int i = 0; i < gc; ++i) {
      mc.p[i] = clock_ptrs[g0 + i];
      md.p[i] = dots_ptrs[g0 + i];
    }
    const long long slot0 = g0 * n_slots;
    gossip_round_rows_vclock_kernel<<<dim3((unsigned)n_slots, (unsigned)gc),
                                      threads, smem, s>>>(
        mc, md, static_cast<int32_t*>(out_clock) + slot0 * n_actors,
        static_cast<int32_t*>(out_dots) + slot0 * n_elems * n_actors,
        static_cast<const int32_t*>(rows) + slot0,
        static_cast<const int32_t*>(neighbors),
        static_cast<const uint8_t*>(mask), static_cast<int32_t*>(changed) + slot0,
        n_slots, n_elems, n_actors, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
