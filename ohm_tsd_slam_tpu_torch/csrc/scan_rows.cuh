// Exclusive prefix of the 128-lane row counts, shared by the two compactions
// (csrc/pack_rows.cu and csrc/compact_channels.cu): a device function that
// the kernel which places the rows calls itself, so the prefix costs no
// launch of its own and every SM works on it.
//
// Single pass with a decoupled look-back.  A block takes a tile of kTileRows
// rows, one a thread, in the order of an atomic ticket (a tile's
// predecessors have all started, so waiting on them cannot starve them of an
// SM).  It scans its counts, publishes the tile's sum in the status array,
// then its first warp looks back over the tiles before it, 32 at a time,
// adding sums until it meets a tile that already knows its inclusive prefix;
// then it publishes its own inclusive prefix.  A status word holds the flag
// in its high and the value in its low 32 bits and is stored and loaded
// whole (relaxed, device scope), so a reader never sees a flag without its
// value and no fence is needed.
//
// place_rows() then walks the tile's rows that hold a set lane: the block
// lists them in shared memory and deals them to its warps in turns (the set
// rows of a field cluster: a wall crosses neighbouring grid lines), and a
// warp loads a row's four mask words and the next row's before it places
// the first, so the loads of one row hide behind the stores of another.
//
// A launch of one tile needs neither: its block takes tile 0 without a
// ticket, its prefix is 0 and it stores no status word (the look-back's
// waits and stores cost more there than they save, csrc/compact_channels.cu).
//
// The caller provides `status`: scan_tiles(rows) + 1 words of 64 bits, ALL
// ZERO when the kernel starts (the last word is the ticket); one tile reads
// none.  Launch scan_tiles(rows) blocks of kTileRows threads.  Both callers
// keep the words behind their pack, so the one memset that zeroes the pack
// zeroes them too.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 256;
constexpr unsigned long long kTileSum = 1ull;     // flag: the tile's own sum
constexpr unsigned long long kTilePrefix = 2ull;  // flag: inclusive prefix

__host__ __device__ __forceinline__ int scan_tiles(int rows) {
  return (rows + kTileRows - 1) / kTileRows;
}

__device__ __forceinline__ void status_store(unsigned long long* p,
                                             unsigned long long flag,
                                             int value) {
  const unsigned long long word =
      (flag << 32) | static_cast<unsigned int>(value);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(word)
               : "memory");
}

__device__ __forceinline__ unsigned long long status_load(
    const unsigned long long* p) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(word)
               : "l"(p)
               : "memory");
  return word;
}

// A thread's row of its block's tile, the row's count and the count of all
// rows before it.
struct RowPrefix {
  int row;  // may lie past `rows` in the last tile (cnt 0 then)
  int cnt;
  int off;
};

// The tile this block takes, the same in every thread: by the atomic ticket
// in status[tiles] (blocks start in no set order), or 0 for a single tile.
// Every thread of the block calls this once.
__device__ __forceinline__ int take_tile(unsigned long long* status,
                                         int tiles) {
  __shared__ int s_tile;
  if (tiles == 1) return 0;  // uniform over the launch
  if (threadIdx.x == 0)
    s_tile = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned int*>(status + tiles), 1u));
  __syncthreads();
  return s_tile;
}

// The prefix of thread t's row tile * kTileRows + t, whose count `cnt` the
// caller gives (0 past `rows`).  Every thread of a block of kTileRows
// threads calls this once, with the block's take_tile().  Stores the sum of
// all counts to *total (the block of the last tile does).
__device__ RowPrefix row_prefix(int tile, int cnt, int rows,
                                unsigned long long* status,
                                int* __restrict__ total) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kTileWarps = kTileRows / 32;
  __shared__ int s_base;
  __shared__ int s_warp[kTileWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = scan_tiles(rows);
  RowPrefix r;
  r.row = tile * kTileRows + static_cast<int>(threadIdx.x);
  r.cnt = cnt;

  int inc = r.cnt;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();

  if (warp == 0) {
    const int w = lane < kTileWarps ? s_warp[lane] : 0;
    int winc = w;  // inclusive scan of the warps' sums
#pragma unroll
    for (int d = 1; d < kTileWarps; d <<= 1) {
      const int v = __shfl_up_sync(kFull, winc, d);
      if (lane >= d) winc += v;
    }
    const int sum = __shfl_sync(kFull, winc, kTileWarps - 1);
    if (lane < kTileWarps) s_warp[lane] = winc - w;

    int base = 0;
    if (tile > 0) {
      if (lane == 0) status_store(status + tile, kTileSum, sum);
      for (int look = tile - 1;; look -= 32) {
        // lane l reads tile look - l; before the first tile stands a
        // prefix of 0
        const int t = look - lane;
        unsigned long long word = kTilePrefix << 32;
        if (t >= 0) {
          do {
            word = status_load(status + t);
          } while ((word >> 32) == 0);
        }
        const unsigned known =
            __ballot_sync(kFull, (word >> 32) == kTilePrefix);
        const int first = __ffs(known) - 1;  // the nearest prefix; -1: none
        int v = (first < 0 || lane <= first)
                    ? static_cast<int>(static_cast<unsigned int>(word))
                    : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
        base += v;
        if (first >= 0) break;
      }
    }
    if (lane == 0) {
      if (tiles > 1) status_store(status + tile, kTilePrefix, base + sum);
      s_base = base;
      if (tile == tiles - 1) *total = base + sum;
    }
  }
  __syncthreads();
  r.off = s_base + s_warp[warp] + (inc - r.cnt);
  return r;
}

// Every thread of a block of kTileRows threads calls this once: the
// prefix of its row of the tile the block takes, from the row counts in
// global memory.
__device__ __forceinline__ RowPrefix tile_prefix(
    const int* __restrict__ row_cnt, int rows, unsigned long long* status,
    int* __restrict__ total) {
  const int tile = take_tile(status, scan_tiles(rows));
  const int row = tile * kTileRows + static_cast<int>(threadIdx.x);
  return row_prefix(tile, row < rows ? row_cnt[row] : 0, rows, status,
                    total);
}

// The tile's rows that hold a set lane and start inside the pack, in row
// order: row[0..n) their threads' indices in the tile, off[t] the offset of
// thread t's row.  Every thread of the block calls this once, after its
// prefix.
struct RowList {
  const int* row;
  const int* off;
  int n;
};

__device__ __forceinline__ RowList list_rows(const RowPrefix& mine,
                                             int cap) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kTileWarps = kTileRows / 32;
  __shared__ int s_off[kTileRows];
  __shared__ int s_list[kTileRows];
  __shared__ int s_n[kTileWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool todo = mine.cnt > 0 && mine.off < cap;
  const unsigned bal = __ballot_sync(kFull, todo);
  if (lane == 0) s_n[warp] = __popc(bal);
  s_off[threadIdx.x] = mine.off;
  __syncthreads();
  int before = 0, n_list = 0;
#pragma unroll
  for (int w = 0; w < kTileWarps; ++w) {
    const int c = s_n[w];
    if (w < warp) before += c;
    n_list += c;
  }
  if (todo)
    s_list[before + __popc(bal & ((1u << lane) - 1u))] =
        static_cast<int>(threadIdx.x);
  __syncthreads();
  return RowList{s_list, s_off, n_list};
}

// Every thread of the block calls this once, after tile_prefix.  For every
// set lane f (flat index, is_set(f) true) of the tile's rows, in flat order,
// calls place(f, slot) with slot = the count of set lanes before f, as long
// as slot < cap.  Rows without a set lane are never read.
template <typename IsSet, typename Place>
__device__ __forceinline__ void place_rows(const RowPrefix& mine, int cap,
                                           IsSet is_set, Place place) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kTileWarps = kTileRows / 32;
  constexpr int kLanes = 128;  // lanes a row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const RowList list = list_rows(mine, cap);
  const int* s_list = list.row;
  const int* s_off = list.off;
  const int n_list = list.n;

  const long row0 = mine.row - static_cast<int>(threadIdx.x);  // the tile's
  bool cur[4] = {false, false, false, false};
  bool nxt[4] = {false, false, false, false};
  if (warp < n_list) {
    const long f0 = (row0 + s_list[warp]) * kLanes + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) cur[q] = is_set(f0 + 32 * q);
  }
  for (int i = warp; i < n_list; i += kTileWarps) {  // uniform over the warp
    if (i + kTileWarps < n_list) {
      const long f0 = (row0 + s_list[i + kTileWarps]) * kLanes + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) nxt[q] = is_set(f0 + 32 * q);
    }
    const int t = s_list[i];
    const long f0 = (row0 + t) * kLanes + lane;
    int base = s_off[t];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned ballot = __ballot_sync(kFull, cur[q]);
      const int slot = base + __popc(ballot & ((1u << lane) - 1u));
      if (cur[q] && slot < cap) place(f0 + 32 * q, slot);
      base += __popc(ballot);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) cur[q] = nxt[q];
  }
}

}  // namespace
