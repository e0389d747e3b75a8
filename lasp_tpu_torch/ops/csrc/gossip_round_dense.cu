// K1 — gossip_round_dense: one dense pull-gossip round over the two packed
// OR-Set planes, for Hopper (sm_90a).
//
// Replaces: lasp_tpu/ops/pallas_gossip.py pallas_gossip_round (body
// _round_kernel, pallas_call at :125). For every replica r and both planes:
//     out[r] = plane[r] | OR_k plane[neighbors[r, k]]
//
// What bounds it on the card: bytes. Each output word costs one own-row
// load, K gathered neighbour loads and one store, and a single bitwise OR
// per load, so the kernel sits far below the card's ops:byte balance. The
// floor is the bytes the round must move: each row read once, each output
// row written once, the index table read once.
//
// Whole rows, one after another, cannot reach that floor when the planes
// are larger than the 50 MB L2: a gathered neighbour row is then a random
// row of HBM, and every one of the K re-reads of a row comes from HBM again.
// What the design does about it: the L2-blocked column-slab schedule.
//   * Each output word depends only on the same word of the own row and of
//     the K neighbour rows, so the round is cut into column slabs: W words
//     of one plane for all R rows. The wrapper (ops/cuda_gossip.py
//     dense_slab_words) picks W from the shape.
//   * A persistent grid (SMs x resident blocks) walks work items (plane,
//     slab, row chunk) in plane-major, slab-major order with stride
//     gridDim.x, so every SM works on the same slab at the same time: the
//     first touch of a row's slab segment comes from HBM, the K re-reads
//     from L2.
//   * Loads carry an L2 evict-last policy (createpolicy + ld.global.nc
//     .L2::cache_hint), outputs go out with streaming stores (st.global.cs),
//     so the written plane does not evict the slab being gathered.
//   * The K neighbour indices of a row chunk are staged in shared memory
//     once per item; the index table (re-read once per slab) is loaded with
//     the same evict-last policy.
//   * 16-byte vector loads (uint4) when the row width, the slab width and
//     every pointer allow it, 8- or 4-byte loads otherwise; the own load and
//     up to four neighbour loads are issued before they are joined.
//   * The output goes to a separate buffer: the round reads the state from
//     before the round (the fused loops ping-pong two buffers).
//
// Plain C interface, bound from Python with ctypes (lasp_tpu_torch/ops/
// cuda_gossip.py). The launcher returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

template <int V> struct Vec;
template <> struct Vec<4> { using T = uint4; };
template <> struct Vec<2> { using T = uint2; };
template <> struct Vec<1> { using T = uint32_t; };

__device__ __forceinline__ uint4 vor(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint2 vor(uint2 a, uint2 b) {
  return make_uint2(a.x | b.x, a.y | b.y);
}
__device__ __forceinline__ uint32_t vor(uint32_t a, uint32_t b) { return a | b; }

template <typename T> __device__ __forceinline__ T vzero();
template <> __device__ __forceinline__ uint4 vzero<uint4>() { return make_uint4(0, 0, 0, 0); }
template <> __device__ __forceinline__ uint2 vzero<uint2>() { return make_uint2(0, 0); }
template <> __device__ __forceinline__ uint32_t vzero<uint32_t>() { return 0u; }

// the L2 policy of every load: evict-last on every line
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// read-only loads under an L2 cache policy (not volatile: the inputs do
// not change during the kernel, and the compiler may batch the loads)
__device__ __forceinline__ uint4 ld_policy(const uint4* p, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ uint2 ld_policy(const uint2* p, uint64_t pol) {
  uint2 v;
  asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ uint32_t ld_policy(const uint32_t* p, uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ int32_t ld_policy(const int32_t* p, uint64_t pol) {
  return static_cast<int32_t>(ld_policy(reinterpret_cast<const uint32_t*>(p), pol));
}

constexpr int kThreads = 256;
// row chunk of one work item = rows_per_iteration * kIters, fewer when K is
// large (the chunk's indices stay under kMaxChunkIndices in shared memory)
constexpr int kIters = 4;
constexpr int kMaxChunkIndices = 8192;

// blockDim.x = kThreads = rows_per_iter * threads_per_row; threads_per_row
// is a power of two. Shared memory holds chunk_rows * K indices.
template <int V>
__global__ void __launch_bounds__(kThreads)
gossip_round_dense_kernel(const typename Vec<V>::T* __restrict__ exists,
                          const typename Vec<V>::T* __restrict__ removed,
                          const int32_t* __restrict__ nbrs,
                          typename Vec<V>::T* __restrict__ out_e,
                          typename Vec<V>::T* __restrict__ out_r,
                          long long n_rows, long long n_vec, int k,
                          int threads_per_row, long long slab_vec,
                          long long n_slabs, int chunk_rows,
                          long long n_chunks) {
  using T = typename Vec<V>::T;
  extern __shared__ int32_t s_nbr[];
  const uint64_t pol = evict_last_policy();
  const int local = threadIdx.x / threads_per_row;
  const int lane = threadIdx.x % threads_per_row;
  const int rows_per_iter = blockDim.x / threads_per_row;
  const long long per_plane = n_slabs * n_chunks;
  for (long long item = blockIdx.x; item < 2 * per_plane; item += gridDim.x) {
    const int p = (int)(item / per_plane);
    const long long in_plane = item - p * per_plane;
    const long long slab = in_plane / n_chunks;
    const long long row0 = (in_plane - slab * n_chunks) * chunk_rows;
    const int rows_here =
        (int)(n_rows - row0 < chunk_rows ? n_rows - row0 : chunk_rows);
    __syncthreads();  // the previous item's readers of s_nbr are done
    for (int i = threadIdx.x; i < rows_here * k; i += blockDim.x) {
      s_nbr[i] = ld_policy(nbrs + row0 * k + i, pol);
    }
    __syncthreads();
    const long long col0 = slab * slab_vec;
    const long long cols = n_vec - col0 < slab_vec ? n_vec - col0 : slab_vec;
    const T* plane = p == 0 ? exists : removed;
    T* out = p == 0 ? out_e : out_r;
    for (int lr = local; lr < rows_here; lr += rows_per_iter) {
      const int32_t* my_nbr = s_nbr + lr * k;
      const long long own = (row0 + lr) * n_vec + col0;
      for (long long i = lane; i < cols; i += threads_per_row) {
        T acc = ld_policy(plane + own + i, pol);
        for (int j = 0; j < k; j += 4) {
          // up to four gathered loads in flight before they are joined
          const T a = ld_policy(plane + (long long)my_nbr[j] * n_vec + col0 + i, pol);
          const T b = j + 1 < k
              ? ld_policy(plane + (long long)my_nbr[j + 1] * n_vec + col0 + i, pol)
              : vzero<T>();
          const T c = j + 2 < k
              ? ld_policy(plane + (long long)my_nbr[j + 2] * n_vec + col0 + i, pol)
              : vzero<T>();
          const T d = j + 3 < k
              ? ld_policy(plane + (long long)my_nbr[j + 3] * n_vec + col0 + i, pol)
              : vzero<T>();
          acc = vor(acc, vor(vor(a, b), vor(c, d)));
        }
        __stcs(out + own + i, acc);
      }
    }
  }
}

// resident blocks of the kernel on one SM times the SMs of the current
// device; both depend only on the device and the shared-memory size, so
// each (device, size) is asked once, not on every launch
template <int V>
int persistent_blocks(size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> known;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, smem);
  const auto hit = known.find(key);
  if (hit != known.end()) return hit->second;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gossip_round_dense_kernel<V>, kThreads, smem) != cudaSuccess) {
    return 0;
  }
  return known[key] = sms * (per_sm > 0 ? per_sm : 1);
}

template <int V>
int launch(const void* exists, const void* removed, const int32_t* nbrs,
           void* out_e, void* out_r, long long n_rows, long long n_words, int k,
           long long slab_words, cudaStream_t stream) {
  using T = typename Vec<V>::T;
  const long long n_vec = n_words / V;
  const long long slab_vec = slab_words / V;
  int threads_per_row = 1;
  while (threads_per_row < slab_vec && threads_per_row < kThreads) threads_per_row <<= 1;
  const int rows_per_iter = kThreads / threads_per_row;
  int iters = kIters;
  while (iters > 1 && (long long)rows_per_iter * iters * k > kMaxChunkIndices) iters >>= 1;
  const int chunk_rows = rows_per_iter * iters;
  const size_t smem = (size_t)chunk_rows * k * sizeof(int32_t);
  const long long n_slabs = (n_vec + slab_vec - 1) / slab_vec;
  const long long n_chunks = (n_rows + chunk_rows - 1) / chunk_rows;
  const long long n_items = 2 * n_slabs * n_chunks;
  const int resident = persistent_blocks<V>(smem);
  if (resident <= 0) return (int)cudaGetLastError();
  const int blocks = (int)(n_items < resident ? n_items : resident);
  gossip_round_dense_kernel<V><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(exists), static_cast<const T*>(removed), nbrs,
      static_cast<T*>(out_e), static_cast<T*>(out_r), n_rows, n_vec, k,
      threads_per_row, slab_vec, n_slabs, chunk_rows, n_chunks);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// exists, removed, out_e, out_r: uint32[n_rows, n_words], contiguous;
// neighbors: int32[n_rows, k], every entry in [0, n_rows); k <= 32.
// slab_words: the column slab's width in words (n_words or more = whole
// rows).
extern "C" int lasp_gossip_round_dense(const void* exists, const void* removed,
                                       const void* neighbors, void* out_e,
                                       void* out_r, long long n_rows,
                                       long long n_words, int k,
                                       long long slab_words, void* stream) {
  if (n_rows <= 0 || n_words <= 0) return 0;
  if (k < 0 || k > 32 || n_rows > 0x7fffffffLL || slab_words <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (slab_words > n_words) slab_words = n_words;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* nbrs = static_cast<const int32_t*>(neighbors);
  const bool all16 = aligned(exists, 16) && aligned(removed, 16) &&
                     aligned(out_e, 16) && aligned(out_r, 16);
  const bool all8 = aligned(exists, 8) && aligned(removed, 8) &&
                    aligned(out_e, 8) && aligned(out_r, 8);
  // a row or slab width that is not a multiple of the vector takes the
  // narrower loads: every row and every slab then starts on a vector boundary
  if (n_words % 4 == 0 && slab_words % 4 == 0 && all16) {
    return launch<4>(exists, removed, nbrs, out_e, out_r, n_rows, n_words, k,
                     slab_words, s);
  }
  if (n_words % 2 == 0 && slab_words % 2 == 0 && all8) {
    return launch<2>(exists, removed, nbrs, out_e, out_r, n_rows, n_words, k,
                     slab_words, s);
  }
  return launch<1>(exists, removed, nbrs, out_e, out_r, n_rows, n_words, k,
                   slab_words, s);
}
