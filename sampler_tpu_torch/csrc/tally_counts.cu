// Per-position value counts over the chains, for Hopper (sm_90a).
//
// Replaces: sampler_tpu/engine/multichain.py, the tallies of
// _run_inference_mc.  No Pallas kernel stands behind it: the JAX package
// sums `vals == k` for each k inside its jitted sweep loop, where XLA fuses
// each compare into its sum.  The port's eager version of those passes
// (ops/tally.py, tally_plain) built a bool [P, NC] for every k.
//
// For worlds values [P, NC] (int8, or int32 above card 127) and counts
// [K, P] int32, in place:
//     counts[k, p] += #{n : values[p, n] == k}      for 0 <= k < K
// A value outside [0, K) counts nowhere.
//
// What bounds it on the card: bytes.  It reads the world once and reads and
// writes counts once: at the 1024² Ising flagship (1,048,577 rows, 512
// chains, K = 2) 0.54 GB, 0.16 ms at 3.35 TB/s; at the 5120² grid's 128
// chains 3.78 GB, 1.127 ms; at one chain on a 2048² lattice (4,194,304
// rows, K = 2) 4.19 MB of world and 67.1 MB of counts, 71.3 MB, 21.3 us.
//
// Design.  Rows under 16 bytes (1-15 int8 chains, 1-3 int32) at K <= kRegK
// take the tile way:
//   * a block owns a tile of kTilePositions consecutive positions, whose
//     world is one contiguous run of bytes: consecutive threads read it with
//     16-byte loads into shared memory, the run's head and tail off the
//     16-byte grid a byte at a time;
//   * in each counts row a thread owns four consecutive positions on the
//     row's 16-byte grid (row k begins at byte 4kP, so each row has its own
//     phase): it reads them as one vector before the block's barrier, adds
//     its positions' counts (a compare a value, from shared memory) and
//     writes the vector back, with no atomics (a block owns its positions).
//     The tile's positions before the row's first grid line and after its
//     last, and the ragged end, go one counter at a time.  A thread's four
//     counters at t, t + 256, t + 512, t + 768 as 4-byte accesses (no
//     phase) took 0.0265 ms at 2048² one chain against the vectors'
//     0.0236-0.0250, 0.0361 against 0.0337 at four chains, and read 83% of
//     the benchmark's roofline against 95%.  Every counter is
//     read and written, zeros too: the traffic is the bound's count, and no
//     skipped sector can carry the share past it.  A warp a row left 31 of
//     32 lanes idle and moved one byte of world a warp: 0.54-0.65 ms a
//     launch at 2048², 3.3-3.9% of the bound; tiles 0.024-0.027 ms, 79-90%
//     (NVIDIA H100 80GB HBM3, power limit 700 W).
// Wider rows: each lane reads 16 bytes at a time (16 int8 values, or 4
// int32) where the chain count and the pointer allow it, else one value.
// Three ways to count them, chosen by the launcher on K:
//   * K <= kRegK, rows of at most 32 16-byte loads (512 int8 chains):
//     a segment of S lanes a row, S the row's loads rounded up to a power
//     of two (8 lanes at 128 int8 chains, 4 rows a warp), U rows a segment
//     (4 up to K = 4, 2 to 8, 1 to 16): a lane issues the loads of its U
//     rows before it counts anything, so a warp has U times as many bytes
//     in flight as rows of 16-byte loads.  A lane keeps its counters in
//     registers (the int8 words compared four bytes at a time with
//     __vcmpeq4, whose 0xFF per equal byte popc counts as 8), a butterfly
//     within the segment sums them, and the block writes its rows'
//     counters through shared memory: counter k of its consecutive rows by
//     consecutive threads (no atomics: a block owns its rows).  With a
//     warp a row, 128 chains left 24 of 32 lanes idle and 128 bytes in
//     flight a warp: 22% of the bound at the 5120² grid (NVIDIA H100
//     80GB HBM3, power limit 700 W);
//   * K <= kRegK, wider rows (1024 chains) and byte rows: a warp a row,
//     the counters in registers as above, the warp's butterfly, lane k
//     adding counter k into counts (a warp's row is two or more loads a
//     lane in flight already; the segments did not beat it there);
//   * K <= kSharedK: a warp a row, a warp's histogram of K counters in
//     shared memory, filled with shared atomics, then added into counts by
//     the warp's lanes, K/32 counters a lane (zero counters skip their
//     write);
//   * larger K: a warp a row, one global atomic add a value.
// Templates on the value type, the way and (in registers and tiles) K
// rounded up to 2, 4, 8 or 16, with its U in registers.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;       // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRegK = 16;       // counters a lane holds in registers
constexpr int kSharedK = 1024;  // a warp's histogram: 4 KB, 32 KB a block
constexpr int kTableInts = 4096;  // a block's row counters: 16 KB
constexpr int kTilePositions = 4 * kThreads;  // a block's tile in tile way
constexpr int kTileBytes = 15 * kTilePositions;  // its world: rows < 16 B

// the ways to count; kSegments only names the register way's segments
// in what the launcher reports
enum Way { kRegisters = 0, kShared = 1, kGlobal = 2, kTile = 3,
           kSegments = 4 };

template <typename V>
struct Wide;
template <>
struct Wide<int8_t> {
  static constexpr int kPer = 16;  // values a 16-byte load
};
template <>
struct Wide<int32_t> {
  static constexpr int kPer = 4;
};

// Adds to c[k] (k < KR) the count of value k among the values of word w,
// each count in units of 8 for int8 words (popc of __vcmpeq4's 0xFF a
// byte), of 1 for int32.  Counters k >= K count values the caller drops.
template <int KR>
__device__ __forceinline__ void count_word(uint32_t w, int8_t,
                                           int (&c)[KR]) {
#pragma unroll
  for (int k = 0; k < KR; ++k) c[k] += __popc(__vcmpeq4(w, 0x01010101u * k));
}
template <int KR>
__device__ __forceinline__ void count_word(uint32_t w, int32_t,
                                           int (&c)[KR]) {
#pragma unroll
  for (int k = 0; k < KR; ++k) c[k] += w == static_cast<uint32_t>(k) ? 1 : 0;
}

// One value v in register mode (units as count_word's).
template <int KR, typename V>
__device__ __forceinline__ void count_one(V v, int (&c)[KR]) {
  constexpr int unit = sizeof(V) == 1 ? 8 : 1;
#pragma unroll
  for (int k = 0; k < KR; ++k) c[k] += v == k ? unit : 0;
}

// A warp a row: the register, shared and global ways.
template <typename V, int WAY, int KR>
__device__ __forceinline__ void tally_row_a_warp(const V* __restrict__ values,
                                                 long long P, int NC,
                                                 bool wide,
                                                 int32_t* __restrict__ counts,
                                                 int K, long long row0) {
  constexpr int kPer = Wide<V>::kPer;
  constexpr int unit = sizeof(V) == 1 ? 8 : 1;
  __shared__ int hist[WAY == kShared ? kWarps : 1]
                     [WAY == kShared ? kSharedK : 1];
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const long long p =
      row0 + static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (p >= P) return;  // a whole warp leaves together
  const V* row = values + static_cast<size_t>(p) * NC;

  if constexpr (WAY == kRegisters) {
    int c[KR] = {};
    if (wide) {
      const uint4* r4 = reinterpret_cast<const uint4*>(row);
      for (int i = lane; i < NC / kPer; i += 32) {
        const uint4 q = __ldcs(r4 + i);  // read once: stream past L2
        count_word<KR>(q.x, V{}, c);
        count_word<KR>(q.y, V{}, c);
        count_word<KR>(q.z, V{}, c);
        count_word<KR>(q.w, V{}, c);
      }
    } else {
      for (int n = lane; n < NC; n += 32) count_one<KR>(row[n], c);
    }
    // lane k ends with the warp's total of counter k
    int mine = 0;
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      int s = c[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
      }
      if (lane == k) mine = s / unit;
    }
    if (lane < K && mine != 0) {
      counts[static_cast<size_t>(lane) * P + p] += mine;
    }
  } else if constexpr (WAY == kShared) {
    int* h = hist[warp];
    for (int k = lane; k < K; k += 32) h[k] = 0;
    __syncwarp();
    for (int n = lane; n < NC; n += 32) {
      const int v = static_cast<int>(row[n]);
      if (v >= 0 && v < K) atomicAdd(h + v, 1);
    }
    __syncwarp();
    for (int k = lane; k < K; k += 32) {
      if (h[k] != 0) counts[static_cast<size_t>(k) * P + p] += h[k];
    }
  } else {
    for (int n = lane; n < NC; n += 32) {
      const int v = static_cast<int>(row[n]);
      if (v >= 0 && v < K) {
        atomicAdd(counts + static_cast<size_t>(v) * P + p, 1);
      }
    }
  }
}

// The four positions (tile offsets j) a thread owns in one counts row,
// ``row`` pointing at the row's counter of the tile's first position: s + 4t
// onwards on the row's 16-byte grid (s the tile's positions before its first
// grid line), the last thread taking the s positions before it and the
// 4 - s after the last full vector.  ``vec``: one 16-byte access.
struct Quad {
  int j[4];
  bool vec;
};

__device__ __forceinline__ Quad quad_of(const int32_t* row, int t, int n) {
  const int s = static_cast<int>(
      ((16u - (reinterpret_cast<uintptr_t>(row) & 15u)) & 15u) >> 2);
  const bool edge = s != 0 && t == kThreads - 1;
  Quad q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q.j[i] = edge ? (i < s ? i : kTilePositions - 4 + i) : s + 4 * t + i;
  }
  q.vec = !edge && q.j[3] < n;
  return q;
}

// The tile way (rows under 16 bytes, K <= KR): a block's tile of
// kTilePositions consecutive positions from row0 + blockIdx.x * tile.
template <typename V, int KR>
__device__ __forceinline__ void tally_tile(const V* __restrict__ values,
                                           long long P, int NC,
                                           int32_t* __restrict__ counts,
                                           int K, long long row0) {
  __shared__ __align__(16) unsigned char stage[kTileBytes + 16];
  const int t = static_cast<int>(threadIdx.x);
  const long long p0 =
      row0 + static_cast<long long>(blockIdx.x) * kTilePositions;
  const int n = static_cast<int>(
      P - p0 < kTilePositions ? P - p0 : kTilePositions);
  // the tile's world, bytes [g0, g1), lands at stage[g - a0], a0 the 16-byte
  // line at or below g0: whole lines [h, e) as 16-byte loads, the bytes
  // before h and from e one at a time
  const size_t R = static_cast<size_t>(NC) * sizeof(V);
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(values) +
                       static_cast<uintptr_t>(p0) * R;
  const uintptr_t g1 = g0 + static_cast<uintptr_t>(n) * R;
  const uintptr_t a0 = g0 & ~uintptr_t{15};
  const uintptr_t up = (g0 + 15) & ~uintptr_t{15};
  const uintptr_t h = up < g1 ? up : g1;
  const uintptr_t down = g1 & ~uintptr_t{15};
  const uintptr_t e = down > h ? down : h;
  for (uintptr_t a = h + 16u * t; a < e; a += 16u * kThreads) {
    // read once: stream past L2
    *reinterpret_cast<uint4*>(stage + (a - a0)) =
        __ldcs(reinterpret_cast<const uint4*>(a));
  }
  if (t < static_cast<int>(h - g0)) {
    stage[g0 - a0 + t] = *reinterpret_cast<const unsigned char*>(g0 + t);
  }
  if (t < static_cast<int>(g1 - e)) {
    stage[e - a0 + t] = *reinterpret_cast<const unsigned char*>(e + t);
  }
  // this thread's counters of each row, read before the barrier so that
  // their loads overlap the world's
  int c[KR][4];
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    if (k >= K) continue;
    const int32_t* row = counts + static_cast<size_t>(k) * P + p0;
    const Quad q = quad_of(row, t, n);
    if (q.vec) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(row + q.j[0]));
      c[k][0] = v.x;
      c[k][1] = v.y;
      c[k][2] = v.z;
      c[k][3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) c[k][i] = q.j[i] < n ? row[q.j[i]] : 0;
    }
  }
  __syncthreads();
  const V* sv = reinterpret_cast<const V*>(stage + (g0 - a0));
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    if (k >= K) continue;
    int32_t* row = counts + static_cast<size_t>(k) * P + p0;
    const Quad q = quad_of(row, t, n);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (q.j[i] >= n) continue;
      const V* r = sv + static_cast<size_t>(q.j[i]) * NC;
      int m = 0;
      for (int x = 0; x < NC; ++x) m += static_cast<int>(r[x]) == k ? 1 : 0;
      c[k][i] += m;
    }
    if (q.vec) {
      __stcs(reinterpret_cast<int4*>(row + q.j[0]),
             make_int4(c[k][0], c[k][1], c[k][2], c[k][3]));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (q.j[i] < n) row[q.j[i]] = c[k][i];
      }
    }
  }
}

// A warp a row (kWarps rows a block), or in the tile way a block a tile.
// KR: the counters a lane holds in register mode and a thread in tile way
// (K rounded up to 2, 4, 8 or 16); 1 in the other ways.
template <typename V, int WAY, int KR>
__global__ void __launch_bounds__(kThreads)
    tally_counts_kernel(const V* __restrict__ values, long long P, int NC,
                        bool wide, int32_t* __restrict__ counts, int K,
                        long long row0) {
  if constexpr (WAY == kTile) {
    tally_tile<V, KR>(values, P, NC, counts, K, row0);
  } else {
    tally_row_a_warp<V, WAY, KR>(values, P, NC, wide, counts, K, row0);
  }
}


// Register mode on rows of at most 32 16-byte loads: a segment of S lanes
// a row (S a power of two, 32 / S segments a warp), U rows a segment at a
// time.  Each lane issues the loads of its U rows before it counts; a
// butterfly within the segment gives each row's counters; a segment's
// first lane puts them into the block's table in shared memory, and the
// block adds the table into counts a counter at a time, consecutive
// threads on consecutive rows.
template <typename V, int KR, int U>
__global__ void __launch_bounds__(kThreads)
    tally_rows_kernel(const V* __restrict__ values, long long P, int NC,
                      int S, int32_t* __restrict__ counts, int K,
                      long long row0) {
  constexpr int kPer = Wide<V>::kPer;
  constexpr int unit = sizeof(V) == 1 ? 8 : 1;
  __shared__ int table[kTableInts];
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int NS = 32 / S;            // segments a warp
  const int seg = lane / S, sl = lane & (S - 1);
  const int RW = NS * U;            // rows a warp
  const int RB = kWarps * RW;       // rows a block
  const long long base = row0 + static_cast<long long>(blockIdx.x) * RB;
  // this segment's rows: base + warp * RW + u * NS + seg
  const uint4* row[U];
  bool live[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long p = base + warp * RW + u * NS + seg;
    live[u] = p < P;
    row[u] = reinterpret_cast<const uint4*>(
        values + static_cast<size_t>(live[u] ? p : 0) * NC);
  }
  int c[U][KR] = {};
  for (int i = sl; i < NC / kPer; i += S) {
    uint4 q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // read once: stream past L2
      q[u] = live[u] ? __ldcs(row[u] + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      count_word<KR>(q[u].x, V{}, c[u]);
      count_word<KR>(q[u].y, V{}, c[u]);
      count_word<KR>(q[u].z, V{}, c[u]);
      count_word<KR>(q[u].w, V{}, c[u]);
    }
  }
  // each row's counters, summed over its segment's lanes
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      int s = c[u][k];
      for (int off = S / 2; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
      }
      if (sl == 0 && k < K) {
        table[k * RB + warp * RW + u * NS + seg] = s / unit;
      }
    }
  }
  __syncthreads();
  for (int j = static_cast<int>(threadIdx.x); j < K * RB; j += kThreads) {
    const int k = j / RB;
    const long long p = base + (j - k * RB);
    const int v = table[j];
    if (p < P && v != 0) counts[static_cast<size_t>(k) * P + p] += v;
  }
}

// rows a launch, inside the grid's 2^31 - 1 blocks of ``rows_a_block``
template <typename Launch>
int launch_chunks(long long P, long long rows_a_block, Launch&& one) {
  const long long per = static_cast<long long>(INT_MAX) * rows_a_block;
  for (long long r = 0; r < P; r += per) {
    const long long rows = P - r < per ? P - r : per;
    one(static_cast<unsigned>((rows + rows_a_block - 1) / rows_a_block), r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// the way, K's counters and U rows a segment of register mode: rows under
// 16 bytes take the tiles, rows of at most 32 16-byte loads the segments,
// the others a warp a row; ``way`` gets the Way taken
template <typename V, int WAY, int KR, int U>
int launch_rows(const V* values, long long P, int NC, bool wide,
                int32_t* counts, int K, cudaStream_t s, int* way) {
  const int loads = NC / Wide<V>::kPer;
  if constexpr (WAY == kRegisters) {
    static_assert(KR * kWarps * 32 * U <= kTableInts, "a block's counters");
    if (static_cast<size_t>(NC) * sizeof(V) < 16) {
      *way = kTile;
      return launch_chunks(P, kTilePositions, [&](unsigned grid, long long r) {
        tally_counts_kernel<V, kTile, KR>
            <<<grid, kThreads, 0, s>>>(values, P, NC, false, counts, K, r);
      });
    }
    if (wide && loads <= 32) {
      int S = 1;  // lanes a row: its loads rounded up to a power of two
      while (S < loads) S <<= 1;
      *way = kSegments;
      return launch_chunks(
          P, static_cast<long long>(kWarps) * (32 / S) * U,
          [&](unsigned grid, long long r) {
            tally_rows_kernel<V, KR, U>
                <<<grid, kThreads, 0, s>>>(values, P, NC, S, counts, K, r);
          });
    }
  }
  *way = WAY;
  return launch_chunks(P, kWarps, [&](unsigned grid, long long r) {
    tally_counts_kernel<V, WAY, KR>
        <<<grid, kThreads, 0, s>>>(values, P, NC, wide, counts, K, r);
  });
}

template <typename V>
int launch_way(const void* values, long long P, int NC, int32_t* counts,
               int K, cudaStream_t s, int* way) {
  const auto* v = static_cast<const V*>(values);
  const bool wide = NC % Wide<V>::kPer == 0 &&
                    reinterpret_cast<uintptr_t>(values) % 16 == 0;
  if (K <= 2) {
    return launch_rows<V, kRegisters, 2, 4>(v, P, NC, wide, counts, K, s,
                                            way);
  }
  if (K <= 4) {
    return launch_rows<V, kRegisters, 4, 4>(v, P, NC, wide, counts, K, s,
                                            way);
  }
  if (K <= 8) {
    return launch_rows<V, kRegisters, 8, 2>(v, P, NC, wide, counts, K, s,
                                            way);
  }
  if (K <= kRegK) {
    return launch_rows<V, kRegisters, kRegK, 1>(v, P, NC, wide, counts, K,
                                                s, way);
  }
  if (K <= kSharedK) {
    return launch_rows<V, kShared, 1, 1>(v, P, NC, wide, counts, K, s,
                                         way);
  }
  return launch_rows<V, kGlobal, 1, 1>(v, P, NC, wide, counts, K, s,
                                       way);
}

}  // namespace

// values int8 (value_bytes 1) or int32 (value_bytes 4) [P, NC]; counts
// int32 [K, P], added to in place.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for K < 1, a value size other than 1 or 4, or
// NC < 0); ``way`` gets the Way launched (3 the tiles, 4 the segments), or
// -1 where nothing was.
extern "C" int tally_counts_launch(const void* values, long long P, int NC,
                                   int value_bytes, void* counts, int K,
                                   void* stream, int* way) {
  *way = -1;
  if (P == 0 || NC == 0) return static_cast<int>(cudaSuccess);
  if (K < 1 || NC < 0 || P < 0 || (value_bytes != 1 && value_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* c = static_cast<int32_t*>(counts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return value_bytes == 1
             ? launch_way<int8_t>(values, P, NC, c, K, s, way)
             : launch_way<int32_t>(values, P, NC, c, K, s, way);
}
