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
// Both kernels read rows as int64 (the runtime's index dtype) or int32, the
// edge mask as the bytes of a bool tensor, and write changed as 0 / 1 bytes
// into a bool tensor, so a wrapper call puts exactly one kernel on the card.
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
// K2's rows are narrow (64 B for the plan's G-Set and G-Counter rows, 512 B
// a leaf for the engine's packed OR-Set) and nothing is reused within a
// slot, so what holds it back is bytes in flight: many independent 16-byte
// loads, not a staging ring. K2's design:
//   * Sub-warp teams. A team of T lanes (a power of two, at most 32) owns one
//     (member, slot) work item; each lane owns V bytes (16, 8, 4 or 1) of
//     each leaf row, and a row wider than T·V bytes is walked by the team in
//     steps of T·V. The wrapper (ops/cuda_gossip.py rows_schedule) picks V
//     from the row's byte width and every pointer's alignment, and T from
//     the row's vectors: at 64-byte rows T = 4 (8 slots a warp), at 512-byte
//     leaves T = 32.
//   * A persistent grid (SMs x resident blocks, asked once per device)
//     strides over the G·F items warp by warp; the loop is uniform across a
//     warp, so lanes of teams past the last item still reach the shuffles.
//   * No shared memory and no block barrier: each lane loads the slot's row
//     index and the neighbour indices and mask bytes itself. A team's lanes
//     load the same addresses, which the load unit serves as one request.
//   * The own row and up to kFanoutChunk neighbour rows of every leaf are
//     loaded before the fold (an unrolled register array; K = 3 on the main
//     path). A dead edge is a load not issued, its register left at the
//     join's identity (0 for or, INT32_MIN for max), so the fold has no
//     branch. A larger fanout walks the same code in chunks of kFanoutChunk,
//     in k order.
//   * The join works on the vector: bool rows OR bytewise (their bytes are
//     0 / 1, so this is logical or), packed words OR as words, int32 rows
//     take max per 4-byte lane. Joined rows go out with streaming stores;
//     changed is a shuffle-xor OR over the team, written by its lane 0.
//
// K3's rows are wide (4,160 B at the store's default OR-SWOT, 64 elements x
// 16 actors), so what holds it back is bytes in flight, not bytes: one block
// per slot with scalar loads behind a data-dependent neighbour loop issues
// each gathered load after the previous fold step. K3 is therefore a
// persistent, warp-specialised kernel around a ring of stages in shared
// memory:
//   * Each block takes a contiguous range of (member, slot) work items. Its
//     producer warp reads the rows, neighbour indices and edge mask of 32
//     slots at once (one lane a slot), then fills one stage per slot: the
//     own row and the K neighbour rows, clocks then dots, with 1-D bulk
//     copies (cp.async.bulk ... mbarrier::complete_tx::bytes) on the stage's
//     full barrier, which carries the expected byte count. Dead edges issue
//     no copy and are marked in the stage's header.
//   * Rows whose clock or dots are not 16-byte multiples (A % 4 != 0) or
//     whose members are not 16-byte aligned take the same ring with 4-byte
//     cp.async copies from the whole producer warp, completing on the full
//     barrier through cp.async.mbarrier.arrive.noinc.
//   * A dots row larger than a stage is staged in column chunks, each stage
//     carrying the slot's clock rows again (a few percent more bytes, all L2
//     hits): one barrier ring serves every row width, and the word fold is
//     independent per column once the clocks are known.
//   * Eight consumer warps fold a stage from shared memory: each thread owns
//     4 consecutive actors of one element (16-byte shared loads; one actor
//     on the 4-byte path) and keeps the running clock ca of the fold's
//     prefix in registers, in k order, skipping dead edges; then it releases
//     the stage on its empty barrier (one arrival per warp). changed is one
//     named-barrier OR over the consumers per slot.
//   * Full and empty barriers are tracked by phase parity across the ring's
//     wrap-around; the producer refills a stage only after every consumer
//     warp has released it.
//
// Plain C interface, bound with ctypes (lasp_tpu_torch/ops/cuda_gossip.py);
// each launcher returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

enum Op { kOr = 0, kMax = 1 };

constexpr int kMaxGroup = 64;

// base pointers of the members of one leaf, for one launch
struct Members {
  const void* p[kMaxGroup];
};

// rows[i] of an int64 (rows_i64) or int32 index array
__device__ __forceinline__ long long load_row(const void* rows, int rows_i64, long long i) {
  return rows_i64 ? __ldg(static_cast<const long long*>(rows) + i)
                  : (long long)__ldg(static_cast<const int32_t*>(rows) + i);
}

const void* row_at(const void* rows, int rows_i64, long long i) {
  return static_cast<const char*>(rows) + i * (rows_i64 ? 8 : 4);
}

__device__ __forceinline__ int32_t vmax(int32_t a, int32_t b) { return a > b ? a : b; }
__device__ __forceinline__ int4 vmax(int4 a, int4 b) {
  return make_int4(vmax(a.x, b.x), vmax(a.y, b.y), vmax(a.z, b.z), vmax(a.w, b.w));
}
__device__ __forceinline__ int vne(int32_t a, int32_t b) { return a != b; }
__device__ __forceinline__ int vne(int2 a, int2 b) { return (a.x != b.x) | (a.y != b.y); }
__device__ __forceinline__ int vne(int4 a, int4 b) {
  return (a.x != b.x) | (a.y != b.y) | (a.z != b.z) | (a.w != b.w);
}
__device__ __forceinline__ int vne(uint8_t a, uint8_t b) { return a != b; }

// -- K2: sub-warp teams --------------------------------------------------------

constexpr int kRowsThreads = 256;
// neighbour rows whose loads are issued together, before their fold
constexpr int kFanoutChunk = 4;

// the type of one V-byte vector of a row
template <int V> struct Bytes;
template <> struct Bytes<16> { using T = int4; };
template <> struct Bytes<8> { using T = int2; };
template <> struct Bytes<4> { using T = int32_t; };
template <> struct Bytes<1> { using T = uint8_t; };

template <int OP>
__device__ __forceinline__ int32_t join1(int32_t a, int32_t b) {
  return OP == kOr ? (a | b) : vmax(a, b);
}
template <int OP>
__device__ __forceinline__ int4 join(int4 a, int4 b) {
  return make_int4(join1<OP>(a.x, b.x), join1<OP>(a.y, b.y), join1<OP>(a.z, b.z),
                   join1<OP>(a.w, b.w));
}
template <int OP>
__device__ __forceinline__ int2 join(int2 a, int2 b) {
  return make_int2(join1<OP>(a.x, b.x), join1<OP>(a.y, b.y));
}
template <int OP>
__device__ __forceinline__ int32_t join(int32_t a, int32_t b) { return join1<OP>(a, b); }
template <int OP>
__device__ __forceinline__ uint8_t join(uint8_t a, uint8_t b) {
  static_assert(OP == kOr, "byte rows join by or only");
  return static_cast<uint8_t>(a | b);
}

// the join's identity: 0 for or, INT32_MIN in every int32 lane for max
__device__ __forceinline__ void splat(int4& v, int32_t x) { v = make_int4(x, x, x, x); }
__device__ __forceinline__ void splat(int2& v, int32_t x) { v = make_int2(x, x); }
__device__ __forceinline__ void splat(int32_t& v, int32_t x) { v = x; }
__device__ __forceinline__ void splat(uint8_t& v, int32_t x) { v = static_cast<uint8_t>(x); }

// OP: kOr / kMax; V: bytes a lane loads at once; NL: leaves (1 or 2). A team
// is 1 << team_shift lanes; n_vec is the V-byte vectors of one leaf row.
template <int OP, int V, int NL>
__global__ void __launch_bounds__(kRowsThreads)
gossip_round_rows_kernel(const __grid_constant__ Members plane0,
                         const __grid_constant__ Members plane1,
                         uint8_t* __restrict__ out0, uint8_t* __restrict__ out1,
                         const void* __restrict__ rows, int rows_i64,
                         const int32_t* __restrict__ nbrs,
                         const uint8_t* __restrict__ mask,
                         uint8_t* __restrict__ changed, long long n_slots,
                         long long n_items, long long n_vec, int team_shift, int k) {
  using T = typename Bytes<V>::T;
  const int team_lanes = 1 << team_shift;
  const int lane = threadIdx.x & 31;
  const int lt = lane & (team_lanes - 1);
  const int per_warp = 32 >> team_shift;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  T ident;
  splat(ident, OP == kOr ? 0 : INT32_MIN);
  // uniform across the warp: every lane reaches the team reduction
  for (long long base = warp * per_warp; base < n_items; base += n_warps * per_warp) {
    const long long item = base + (lane >> team_shift);
    int diff = 0;
    if (item < n_items) {
      const int g = (int)(item / n_slots);
      const long long row = load_row(rows, rows_i64, item);
      const T* plane[NL];
      T* out[NL];
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        plane[l] = static_cast<const T*>(l == 0 ? plane0.p[g] : plane1.p[g]);
        out[l] = reinterpret_cast<T*>(l == 0 ? out0 : out1) + item * n_vec;
      }
      for (long long v = lt; v < n_vec; v += team_lanes) {
        T own[NL], acc[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) acc[l] = own[l] = __ldg(plane[l] + row * n_vec + v);
        for (int c0 = 0; c0 < k; c0 += kFanoutChunk) {
          long long src[kFanoutChunk];
          bool live[kFanoutChunk];
#pragma unroll
          for (int j = 0; j < kFanoutChunk; ++j) {
            const int e = c0 + j;
            live[j] = e < k && (mask == nullptr || __ldg(mask + row * k + e) != 0);
            src[j] = live[j] ? (long long)__ldg(nbrs + row * k + e) : 0;
          }
          T x[NL][kFanoutChunk];
#pragma unroll
          for (int l = 0; l < NL; ++l) {
#pragma unroll
            for (int j = 0; j < kFanoutChunk; ++j) {
              x[l][j] = live[j] ? __ldg(plane[l] + src[j] * n_vec + v) : ident;
            }
          }
#pragma unroll
          for (int l = 0; l < NL; ++l) {
#pragma unroll
            for (int j = 0; j < kFanoutChunk; ++j) acc[l] = join<OP>(acc[l], x[l][j]);
          }
        }
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          __stcs(out[l] + v, acc[l]);
          diff |= vne(acc[l], own[l]);
        }
      }
    }
    for (int off = team_lanes >> 1; off > 0; off >>= 1) {
      diff |= __shfl_xor_sync(0xffffffffu, diff, off);
    }
    if (item < n_items && lt == 0) changed[item] = diff ? 1 : 0;
  }
}

// resident blocks of one K2 instance on the current device (SMs x blocks
// an SM holds); depends only on the device, so each is asked once
template <int OP, int V, int NL>
cudaError_t rows_resident(long long* resident) {
  static std::mutex mu;
  static std::map<int, long long> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = known.find(dev);
  if (hit != known.end()) {
    *resident = hit->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gossip_round_rows_kernel<OP, V, NL>, kRowsThreads, 0)) !=
          cudaSuccess) {
    return err;
  }
  *resident = known[dev] = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <int OP, int V, int NL>
int launch_rows(const void* const* ptrs0, const void* const* ptrs1, void* out0,
                void* out1, const void* rows, int rows_i64, const int32_t* nbrs,
                const uint8_t* mask, uint8_t* changed, long long n_groups,
                long long n_slots, long long row_bytes, int team_shift, int k,
                cudaStream_t stream) {
  long long resident = 0;
  cudaError_t err = rows_resident<OP, V, NL>(&resident);
  if (err != cudaSuccess) return (int)err;
  const long long n_vec = row_bytes / V;
  const int per_warp = 32 >> team_shift;
  for (long long g0 = 0; g0 < n_groups; g0 += kMaxGroup) {
    const int gc = (int)(n_groups - g0 < kMaxGroup ? n_groups - g0 : kMaxGroup);
    Members m0 = {}, m1 = {};
    for (int i = 0; i < gc; ++i) {
      m0.p[i] = ptrs0[g0 + i];
      m1.p[i] = NL > 1 ? ptrs1[g0 + i] : nullptr;
    }
    const long long slot0 = g0 * n_slots;
    const long long n_items = gc * n_slots;
    const long long warps = (n_items + per_warp - 1) / per_warp;
    const long long wanted = (warps * 32 + kRowsThreads - 1) / kRowsThreads;
    const int blocks = (int)(wanted < resident ? wanted : resident);
    gossip_round_rows_kernel<OP, V, NL><<<blocks, kRowsThreads, 0, stream>>>(
        m0, m1, static_cast<uint8_t*>(out0) + slot0 * row_bytes,
        NL > 1 ? static_cast<uint8_t*>(out1) + slot0 * row_bytes : nullptr,
        row_at(rows, rows_i64, slot0), rows_i64, nbrs, mask, changed + slot0,
        n_slots, n_items, n_vec, team_shift, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <int OP, int V>
int launch_rows_leaves(int n_leaves, const void* const* ptrs0, const void* const* ptrs1,
                       void* out0, void* out1, const void* rows, int rows_i64,
                       const int32_t* nbrs, const uint8_t* mask, uint8_t* changed,
                       long long n_groups, long long n_slots, long long row_bytes,
                       int team_shift, int k, cudaStream_t stream) {
  if (n_leaves == 2) {
    return launch_rows<OP, V, 2>(ptrs0, ptrs1, out0, out1, rows, rows_i64, nbrs, mask,
                                 changed, n_groups, n_slots, row_bytes, team_shift, k,
                                 stream);
  }
  return launch_rows<OP, V, 1>(ptrs0, ptrs1, out0, out1, rows, rows_i64, nbrs, mask,
                               changed, n_groups, n_slots, row_bytes, team_shift, k,
                               stream);
}

// -- K3: the ring ------------------------------------------------------------

constexpr int kProducerThreads = 32;
constexpr int kConsumerThreads = 256;
constexpr int kVclockThreads = kProducerThreads + kConsumerThreads;
constexpr int kHeaderBatch = 32;  // slots whose indices the producer reads at once
constexpr int kStages = 4;        // depth of the ring
constexpr size_t kMaxDynamicSmem = 227 * 1024;

// Shared memory of one K3 block, in bytes from the base: full and empty
// barriers, the stages' live-edge headers, the producer's index batch, then
// the stages (128-byte aligned; every row area starts on 16 bytes).
struct VclockLayout {
  int clock_stride;   // words of one staged clock row (A rounded up to 4)
  int dots_stride;    // words of one staged dots chunk (rounded up to 4)
  int stage_words;    // (K + 1) * (clock_stride + dots_stride)
  int header_off;     // int32[kStages][K + 1]: 1 = live source, 0 = dead edge
  int batch_off;      // int32[kHeaderBatch][K + 1]: row, then neighbours
  int stage_off;
  size_t bytes;
};

VclockLayout vclock_layout(int k, int n_actors, int chunk_words) {
  VclockLayout l;
  l.clock_stride = (n_actors + 3) / 4 * 4;
  l.dots_stride = (chunk_words + 3) / 4 * 4;
  l.stage_words = (k + 1) * (l.clock_stride + l.dots_stride);
  size_t off = 2 * (size_t)kStages * sizeof(uint64_t);
  l.header_off = (int)off;
  off += (size_t)kStages * (k + 1) * sizeof(int32_t);
  l.batch_off = (int)off;
  off += (size_t)kHeaderBatch * (k + 1) * sizeof(int32_t);
  off = (off + 127) / 128 * 128;
  l.stage_off = (int)off;
  l.bytes = off + (size_t)kStages * l.stage_words * sizeof(int32_t);
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

// arrive on bar once every cp.async this thread issued has landed
__device__ __forceinline__ void copy4_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// OR of v over the first n_threads threads that reach named barrier 1
__device__ __forceinline__ int consumers_any(int v, int n_threads) {
  int out;
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.s32 q, %1, 0;\n"
      "bar.red.or.pred p, 1, %2, q;\n"
      "selp.s32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(out)
      : "r"(v), "r"(n_threads)
      : "memory");
  return out;
}

template <int V> struct IVec;
template <> struct IVec<4> { using T = int4; };
template <> struct IVec<1> { using T = int32_t; };

template <typename T>
__device__ __forceinline__ T lds(const int32_t* p) {
  return *reinterpret_cast<const T*>(p);
}

template <typename T>
__device__ __forceinline__ void stg(int32_t* p, T v) {
  *reinterpret_cast<T*>(p) = v;
}

// one step of merge_dots: (da, ca) is the accumulated dots word and clock
// before this step, (db, cb) the neighbour's
__device__ __forceinline__ void fold(int32_t& da, int32_t& ca, int32_t db, int32_t cb) {
  const bool keep_a = da > 0 && (da == db || da > cb);
  const bool keep_b = db > 0 && (db == da || db > ca);
  const int32_t va = keep_a ? da : 0;
  const int32_t vb = keep_b ? db : 0;
  da = va > vb ? va : vb;
  ca = ca > cb ? ca : cb;
}
__device__ __forceinline__ void fold(int4& da, int4& ca, int4 db, int4 cb) {
  fold(da.x, ca.x, db.x, cb.x);
  fold(da.y, ca.y, db.y, cb.y);
  fold(da.z, ca.z, db.z, cb.z);
  fold(da.w, ca.w, db.w, cb.w);
}

// V = 4: bulk copies, 4 actors a consumer thread; V = 1: 4-byte cp.async
// copies, one actor a consumer thread.
template <int V>
__global__ void __launch_bounds__(kVclockThreads)
gossip_round_rows_vclock_kernel(
    const __grid_constant__ Members clocks,
    const __grid_constant__ Members dots, int32_t* __restrict__ out_clock,
    int32_t* __restrict__ out_dots, const void* __restrict__ rows, int rows_i64,
    const int32_t* __restrict__ nbrs, const uint8_t* __restrict__ mask,
    uint8_t* __restrict__ changed, long long n_slots, long long n_items,
    int n_elems, int n_actors, int k, int chunk_words, const VclockLayout lay) {
  using VT = typename IVec<V>::T;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  int32_t* live = reinterpret_cast<int32_t*>(smem + lay.header_off);
  int32_t* batch = reinterpret_cast<int32_t*>(smem + lay.batch_off);
  int32_t* ring = reinterpret_cast<int32_t*>(smem + lay.stage_off);
  const int kc = k + 1;
  const int a_n = n_actors;
  const long long row_words = (long long)n_elems * a_n;
  const int n_chunks = (int)((row_words + chunk_words - 1) / chunk_words);
  const long long per_block = (n_items + gridDim.x - 1) / gridDim.x;
  const long long first = (long long)blockIdx.x * per_block;
  const long long last = first + per_block < n_items ? first + per_block : n_items;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // bulk: the producer's arrive.expect_tx; 4-byte: each producer lane's
      // copy-completion arrival plus lane 0's arrival after the header
      mbar_init(&full[s], V == 4 ? 1 : kProducerThreads + 1);
      mbar_init(&empty[s], kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 0) {
    // producer: fill one stage per (slot, chunk), in the consumers' order
    int stage = 0;
    uint32_t phase = 0;
    for (long long s0 = first; s0 < last; s0 += kHeaderBatch) {
      __syncwarp();  // the previous batch is read
      const long long s = s0 + lane;
      if (s < last) {
        int32_t* h = batch + lane * kc;
        const long long row = load_row(rows, rows_i64, s);
        h[0] = (int32_t)row;
        for (int j = 0; j < k; ++j) {
          int32_t nb = nbrs[row * k + j];
          if (mask != nullptr && mask[row * k + j] == 0) nb = -1;
          h[1 + j] = nb;
        }
      }
      __syncwarp();
      const int in_batch = (int)(last - s0 < kHeaderBatch ? last - s0 : kHeaderBatch);
      for (int t = 0; t < in_batch; ++t) {
        const int g = (int)((s0 + t) / n_slots);
        const int32_t* clock = static_cast<const int32_t*>(clocks.p[g]);
        const int32_t* dts = static_cast<const int32_t*>(dots.p[g]);
        const int32_t* h = batch + t * kc;
        for (int c = 0; c < n_chunks; ++c) {
          const long long c0 = (long long)c * chunk_words;
          const int cw = (int)(row_words - c0 < chunk_words ? row_words - c0 : chunk_words);
          mbar_wait(&empty[stage], phase ^ 1);
          int32_t* st_clock = ring + (size_t)stage * lay.stage_words;
          int32_t* st_dots = st_clock + kc * lay.clock_stride;
          if (lane == 0) {
            for (int j = 0; j < kc; ++j) live[stage * kc + j] = h[j] >= 0;
          }
          if (V == 4) {
            if (lane == 0) {
              uint32_t n_live = 0;
              for (int j = 0; j < kc; ++j) n_live += h[j] >= 0;
              mbar_arrive_expect_tx(&full[stage], n_live * (uint32_t)(a_n + cw) * 4u);
            }
            __syncwarp();
            for (int j = lane; j < kc; j += 32) {
              const long long src = h[j];
              if (src < 0) continue;
              bulk_copy(st_clock + j * lay.clock_stride, clock + src * a_n,
                        (uint32_t)a_n * 4u, &full[stage]);
              bulk_copy(st_dots + j * lay.dots_stride, dts + src * row_words + c0,
                        (uint32_t)cw * 4u, &full[stage]);
            }
          } else {
            for (int j = 0; j < kc; ++j) {
              const long long src = h[j];
              if (src < 0) continue;
              for (int w = lane; w < a_n; w += 32) {
                copy4(st_clock + j * lay.clock_stride + w, clock + src * a_n + w);
              }
              for (int w = lane; w < cw; w += 32) {
                copy4(st_dots + j * lay.dots_stride + w, dts + src * row_words + c0 + w);
              }
            }
            copy4_arrive(&full[stage]);
            if (lane == 0) mbar_arrive(&full[stage]);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  // consumers: fold each stage from shared memory in k order
  const int ct = threadIdx.x - kProducerThreads;
  int stage = 0;
  uint32_t phase = 0;
  int diff = 0;
  for (long long slot = first; slot < last; ++slot) {
    for (int c = 0; c < n_chunks; ++c) {
      const long long c0 = (long long)c * chunk_words;
      const int cw = (int)(row_words - c0 < chunk_words ? row_words - c0 : chunk_words);
      mbar_wait(&full[stage], phase);
      const int32_t* st_clock = ring + (size_t)stage * lay.stage_words;
      const int32_t* st_dots = st_clock + kc * lay.clock_stride;
      const int32_t* lv = live + stage * kc;
      if (c == 0) {
        for (int q = ct * V; q < a_n; q += kConsumerThreads * V) {
          const VT own = lds<VT>(st_clock + q);
          VT acc = own;
          for (int j = 1; j < kc; ++j) {
            if (!lv[j]) continue;
            acc = vmax(acc, lds<VT>(st_clock + j * lay.clock_stride + q));
          }
          stg(out_clock + slot * a_n + q, acc);
          diff |= vne(acc, own);
        }
      }
      for (int q = ct * V; q < cw; q += kConsumerThreads * V) {
        const long long w = c0 + q;
        const int a0 = (int)(w % a_n);
        const VT own = lds<VT>(st_dots + q);
        VT da = own;
        VT ca = lds<VT>(st_clock + a0);
        for (int j = 1; j < kc; ++j) {
          if (!lv[j]) continue;
          fold(da, ca, lds<VT>(st_dots + j * lay.dots_stride + q),
               lds<VT>(st_clock + j * lay.clock_stride + a0));
        }
        stg(out_dots + slot * row_words + w, da);
        diff |= vne(da, own);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (c == n_chunks - 1) {
        __syncwarp();  // bar.red wants each warp converged
        const int any = consumers_any(diff, kConsumerThreads);
        if (ct == 0) changed[slot] = static_cast<uint8_t>(any);
        diff = 0;
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// resident blocks of the V kernel with `smem` bytes of dynamic shared
// memory on the current device, after its dynamic shared-memory limit is
// raised to kMaxDynamicSmem there; both depend only on the device and the
// size, so each (device, size) is asked once, not on every launch
template <int V>
cudaError_t vclock_resident(size_t smem, long long* resident) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, long long> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, smem);
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *resident = hit->second;
    return cudaSuccess;
  }
  auto kernel = gossip_round_rows_vclock_kernel<V>;
  int sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kMaxDynamicSmem)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kVclockThreads, smem)) != cudaSuccess) {
    return err;
  }
  *resident = known[key] = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <int V>
int launch_vclock(const void* const* clock_ptrs, const void* const* dots_ptrs,
                  int32_t* out_clock, int32_t* out_dots, const void* rows,
                  int rows_i64, const int32_t* nbrs, const uint8_t* mask,
                  uint8_t* changed, long long n_groups, long long n_slots,
                  int n_elems, int n_actors, int k, int chunk_words,
                  const VclockLayout& lay, cudaStream_t stream) {
  long long resident = 0;
  cudaError_t err = vclock_resident<V>(lay.bytes, &resident);
  if (err != cudaSuccess) return (int)err;
  const long long row_words = (long long)n_elems * n_actors;
  for (long long g0 = 0; g0 < n_groups; g0 += kMaxGroup) {
    const int gc = (int)(n_groups - g0 < kMaxGroup ? n_groups - g0 : kMaxGroup);
    Members mc = {}, md = {};
    for (int i = 0; i < gc; ++i) {
      mc.p[i] = clock_ptrs[g0 + i];
      md.p[i] = dots_ptrs[g0 + i];
    }
    const long long slot0 = g0 * n_slots;
    const long long n_items = gc * n_slots;
    const int blocks = (int)(n_items < resident ? n_items : resident);
    gossip_round_rows_vclock_kernel<V><<<blocks, kVclockThreads, lay.bytes, stream>>>(
        mc, md, out_clock + slot0 * n_actors, out_dots + slot0 * row_words,
        row_at(rows, rows_i64, slot0), rows_i64, nbrs, mask, changed + slot0,
        n_slots, n_items, n_elems, n_actors, k, chunk_words, lay);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

bool aligned_to(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0;
}

}  // namespace

// K2. op: 0 = or (bool bytes or packed words), 1 = int32 max; ptrs0 /
// ptrs1: host arrays of the n_groups members' base pointers for leaf 0 /
// leaf 1 (ptrs1 unused when n_leaves is 1), each member [n_rows] rows of
// row_bytes bytes; out0 / out1: [n_groups, n_slots] rows of row_bytes;
// rows: int64 (rows_i64 = 1) or int32 [n_groups, n_slots]; neighbors:
// int32[n_rows, k], entries in [0, n_rows); mask: the bytes of a bool
// [n_rows, k] or null; changed: the bytes of a bool [n_groups, n_slots],
// written 0 or 1. The schedule comes from the wrapper (ops/cuda_gossip.py
// rows_schedule): vec_bytes (16, 8, 4 or 1; at least 4 for max) divides
// row_bytes and every member and output address; team_lanes is a power of
// two, at most 32.
extern "C" int lasp_gossip_round_rows(
    int op, int vec_bytes, int team_lanes, const void* const* ptrs0,
    const void* const* ptrs1, void* out0, void* out1, int n_leaves,
    const void* rows, int rows_i64, const void* neighbors, const void* mask,
    void* changed, long long n_groups, long long n_slots, long long row_bytes, int k,
    void* stream) {
  if (n_groups <= 0 || n_slots <= 0) return 0;
  const bool vec_ok = vec_bytes == 16 || vec_bytes == 8 || vec_bytes == 4 ||
                      (vec_bytes == 1 && op == kOr);
  if (n_leaves < 1 || n_leaves > 2 || k < 0 || n_slots > 0x7fffffffLL ||
      row_bytes <= 0 || (op != kOr && op != kMax) || !vec_ok ||
      row_bytes % vec_bytes != 0 || team_lanes < 1 || team_lanes > 32 ||
      (team_lanes & (team_lanes - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  bool ok = aligned_to(out0, vec_bytes) && (n_leaves < 2 || aligned_to(out1, vec_bytes));
  for (long long i = 0; ok && i < n_groups; ++i) {
    ok = aligned_to(ptrs0[i], vec_bytes) && (n_leaves < 2 || aligned_to(ptrs1[i], vec_bytes));
  }
  if (!ok) return (int)cudaErrorMisalignedAddress;
  int team_shift = 0;
  while ((1 << team_shift) < team_lanes) ++team_shift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* nb = static_cast<const int32_t*>(neighbors);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  uint8_t* c = static_cast<uint8_t*>(changed);
#define LASP_ROWS_LAUNCH(OP, V)                                                       \
  return launch_rows_leaves<OP, V>(n_leaves, ptrs0, ptrs1, out0, out1, rows, rows_i64, \
                                   nb, m, c, n_groups, n_slots, row_bytes, team_shift, \
                                   k, s)
  if (op == kOr) {
    switch (vec_bytes) {
      case 16: LASP_ROWS_LAUNCH(kOr, 16);
      case 8: LASP_ROWS_LAUNCH(kOr, 8);
      case 4: LASP_ROWS_LAUNCH(kOr, 4);
      default: LASP_ROWS_LAUNCH(kOr, 1);
    }
  }
  switch (vec_bytes) {
    case 16: LASP_ROWS_LAUNCH(kMax, 16);
    case 8: LASP_ROWS_LAUNCH(kMax, 8);
    default: LASP_ROWS_LAUNCH(kMax, 4);
  }
#undef LASP_ROWS_LAUNCH
}

// K3. clock_ptrs / dots_ptrs: host arrays of the n_groups members' base
// pointers, each member's clock int32[n_rows, n_actors] and dots
// int32[n_rows, n_elems, n_actors]; out_clock: int32[n_groups, n_slots,
// n_actors]; out_dots: int32[n_groups, n_slots, n_elems, n_actors]; rows,
// rows_i64, neighbors, mask and changed as for K2. The schedule comes from
// the wrapper (ops/cuda_gossip.py vclock_schedule): bulk = 1 for 1-D bulk
// copies (n_actors % 4 == 0 and every pointer 16-byte aligned), 0 for
// 4-byte cp.async copies; chunk_words: the dots words of one row a stage
// holds (a multiple of 4 under bulk). The ring is kStages deep.
extern "C" int lasp_gossip_round_rows_vclock(
    const void* const* clock_ptrs, const void* const* dots_ptrs,
    void* out_clock, void* out_dots, const void* rows, int rows_i64,
    const void* neighbors, const void* mask, void* changed, long long n_groups,
    long long n_slots, int n_elems, int n_actors, int k, int bulk, int chunk_words,
    void* stream) {
  if (n_groups <= 0 || n_slots <= 0) return 0;
  if (k < 0 || n_slots > 0x7fffffffLL || n_elems <= 0 || n_actors <= 0 ||
      chunk_words <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const VclockLayout lay = vclock_layout(k, n_actors, chunk_words);
  if (lay.bytes > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* oc = static_cast<int32_t*>(out_clock);
  int32_t* od = static_cast<int32_t*>(out_dots);
  const int32_t* nb = static_cast<const int32_t*>(neighbors);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  uint8_t* c = static_cast<uint8_t*>(changed);
  if (bulk) {
    bool ok = n_actors % 4 == 0 && chunk_words % 4 == 0 && aligned_to(out_clock, 16) &&
              aligned_to(out_dots, 16);
    for (long long i = 0; ok && i < n_groups; ++i) {
      ok = aligned_to(clock_ptrs[i], 16) && aligned_to(dots_ptrs[i], 16);
    }
    if (!ok) return (int)cudaErrorMisalignedAddress;
    return launch_vclock<4>(clock_ptrs, dots_ptrs, oc, od, rows, rows_i64, nb, m, c,
                            n_groups, n_slots, n_elems, n_actors, k, chunk_words, lay, s);
  }
  return launch_vclock<1>(clock_ptrs, dots_ptrs, oc, od, rows, rows_i64, nb, m, c,
                          n_groups, n_slots, n_elems, n_actors, k, chunk_words, lay, s);
}
