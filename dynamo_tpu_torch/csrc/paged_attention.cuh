// The bf16 paged-attention core shared by K1 (ragged_paged_attention.cu)
// and K4 (paged_attention_decode.cu).
//
// Function: query row t (one head group per KV head g) attends the KV
// positions s <= qpos[t] of its lane, whose pages are tables[lane, s / P],
// clamped to the first max_pages pages; GQA (G = H/KVH query heads share a
// KV head); scores scaled by 1/sqrt(D); fp32 online softmax; P·V from P
// split into a bf16 head and a bf16 tail (two MMAs), so P keeps ~16 bits
// where one bf16 rounding kept 8: the phase path's chunk attention reads
// as the plain fp32 version does to about a bf16 ulp of the output (one
// rounding of P drifted Llama-3-8B's logits by up to 0.14 in bf16 and
// 0.70 under w8a8 activations, on an H100); rows with qpos < 0 write
// exact zeros and read no page.
// K1 passes qpos and lanes per row. K4 (kDecode) passes lengths: row b is
// lane b with qpos = lengths[b] - 1, so a length-0 lane is a zero row.
//
// Work. A tile is a run of consecutive rows of one lane inside an aligned
// block of TR = 64/G rows (K4: one row), so a tile is at most 64 MMA rows
// of (row, head) pairs: every staged K/V page is read from shared memory
// once per tile, and a decode row gives G live MMA rows, not 1. An item is
// (tile, KV head); its work is the tile's visible pages (those of its
// deepest row). The grid is fixed by the caller (2 CTAs per SM). Of the W
// units (item, page), items in row order and KV heads inside a tile, CTA
// c < m = min(n, W) owns the window [c·W/m, (c+1)·W/m); each item is cut
// into pieces of B = ceil(W/m) pages from its own start, and a CTA runs
// the pieces that start in its window — so the work is split by pages, in
// decode and mixed rounds alike (a CTA runs at most about 2B pages), and
// two identical lanes are cut and reduced identically wherever they sit
// (greedy streams of identical requests stay identical). No host reads
// qpos or lengths: every CTA scans the rows itself (a block prefix sum
// over tile works) to find W and its window. `work_split` in
// engine/paged_core.py mirrors this arithmetic.
//
// Pipeline. Warp 4 is the producer: for each 16-key stage it waits for a
// free ring slot (empty mbarrier), then its 32 lanes copy the stage's K and
// V rows in 16-byte cp.async copies into rows padded to D+8 elements (so
// ldmatrix reads are conflict-free), each lane arriving on the slot's full
// mbarrier when its copies land (cp.async.mbarrier.arrive.noinc). The ring
// has 8 stages and stays bf16. (A page is P·D contiguous elements, but one
// 1-D TMA bulk copy of it lands unpadded and every ldmatrix of it then
// conflicts 8 ways; a TMA bulk copy per padded row was no faster than
// cp.async — PERF.md.) Warps 0..3 consume: an item's MMA rows are split in
// m16 groups (MG = ceil(rows·G/16)) and the stages among KG = 4/MG key
// groups, so a decode item has four warps on alternate stages and a 16-row
// chunk tile four warps on every stage. S = Q·K^T and O += P·V run on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), K fragments by ldmatrix,
// V by ldmatrix.trans.
//
// Combine, in the same launch. At the end of each piece the warps merge
// their key groups in shared memory. A piece that is its whole item writes
// the output; otherwise it writes (m, l, acc) to the partial slot its start
// unit names (`slot_of`) and takes a ticket on the item's counter. The
// last of the item's CTAs folds the pieces in order and resets the
// counter to 0 for the next call (so a captured graph replays without a
// host memset). One launch per call.
//
// Bound: bytes at decode (each visible K/V element is read once per item
// and used for 4·G flops); at prefill tiles share pages across 16 rows and
// the flops are on tensor cores. Left for later (PERF.md §6-7): each CTA
// pays a few microseconds of prologue and first-load latency, and stages
// stream at well under the bound's rate. Geometry: G <= 8, D in {16, 32,
// 64, 96, 128}, P a power of two <= 64; the wrapper checks it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pa {

constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (kConsumerWarps + 1);   // + the producer warp
constexpr int kStages = 8;                             // ring slots
constexpr int kStageKeys = 16;                         // keys per slot
constexpr int kTileMmaRows = 16 * kConsumerWarps;      // 64
constexpr int kMaxGroup = 8;
constexpr int kRowsPerThread = 8;                      // prologue scan
constexpr int kChunkRows = kThreads * kRowsPerThread;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;   // (T, H, D)
  const __nv_bfloat16* k;   // (KVH, N, P, D)
  const __nv_bfloat16* v;
  const int* qpos;          // (T,) K1
  const int* lanes;         // (T,) K1
  const int* lengths;       // (T,) K4
  const int* tables;        // (L, max_pages)
  __nv_bfloat16* out;       // (T, H, D)
  float* part;              // 2·gridDim.x slots of 64·(D+2) floats
  int* counters;            // T·KVH, all 0 between calls
  int rows, n_heads, n_kv_heads, n_pages, page_size, max_pages, tile_rows;
  float scale_log2;         // log2(e) / sqrt(D)
};

inline size_t smem_bytes(int head_dim) {
  return 128 + sizeof(__nv_bfloat16) * kStages * 2 * kStageKeys *
                   (head_dim + 8) +
         sizeof(float) * kConsumerWarps * 16 * (head_dim + 4);
}

// --- rows and tiles ---------------------------------------------------------

template <bool kDecode>
__device__ __forceinline__ int row_qpos(const Args& a, int t) {
  return kDecode ? a.lengths[t] - 1 : a.qpos[t];
}

struct Tile {
  int s, nr, lane, pages;   // first row, rows, lane, visible pages
  bool solo;                // the lane's only row (a decode row; K4: all)
};

// the tile that starts at row s (a row t starts a tile when t % tile_rows
// is 0 or its lane differs from row t-1's; K4: every row)
template <bool kDecode>
__device__ Tile tile_at(const Args& a, int s) {
  Tile tl;
  tl.s = s;
  tl.nr = 1;
  tl.lane = kDecode ? s : a.lanes[s];
  int maxq = row_qpos<kDecode>(a, s);
  if (!kDecode)
    while (tl.nr < a.tile_rows && s + tl.nr < a.rows &&
           (s + tl.nr) % a.tile_rows != 0 && a.lanes[s + tl.nr] == tl.lane) {
      maxq = max(maxq, a.qpos[s + tl.nr]);
      ++tl.nr;
    }
  tl.pages = maxq < 0 ? 0 : min(maxq / a.page_size + 1, a.max_pages);
  tl.solo = kDecode ||
            (tl.nr == 1 && (s == 0 || a.lanes[s - 1] != tl.lane) &&
             (s + 1 >= a.rows || a.lanes[s + 1] != tl.lane));
  return tl;
}

// Work units (page, KV head) of rows [base, base + kChunkRows): this
// thread's rows base + 8·tid ..., its exclusive prefix inside the chunk
// and the chunk's total. Every thread of the CTA calls it. The chunk's
// qpos and lanes (and the 64 rows after it, where a tile may end) are
// staged in shared memory `s_q` / `s_l` first, so the tile walks read no
// global memory.
template <bool kDecode>
__device__ void chunk_scan(const Args& a, int base,
                           int (&works)[kRowsPerThread], int& excl,
                           int& chunk_total, int* warp_sums, int* s_q,
                           int* s_l) {
  const int n = min(a.rows - base, kChunkRows + kTileMmaRows);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s_q[i] = row_qpos<kDecode>(a, base + i);
    if (!kDecode) s_l[i] = a.lanes[base + i];
  }
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int u = threadIdx.x * kRowsPerThread + i, t = base + u;
    works[i] = 0;
    if (t >= a.rows) continue;
    int maxq = s_q[u];
    if (!kDecode) {
      const int lane = s_l[u];
      if (t % a.tile_rows != 0 &&
          (u > 0 ? s_l[u - 1] : a.lanes[t - 1]) == lane)
        continue;   // not a tile start
      for (int nr = 1; nr < a.tile_rows && t + nr < a.rows &&
                       (t + nr) % a.tile_rows != 0 && s_l[u + nr] == lane;
           ++nr)
        maxq = max(maxq, s_q[u + nr]);
    }
    works[i] = maxq < 0 ? 0
                        : a.n_kv_heads *
                              min(maxq / a.page_size + 1, a.max_pages);
    sum += works[i];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    total += warp_sums[w];
  }
  excl = before + incl - sum;
  chunk_total = total;
  __syncthreads();   // warp_sums and the staged rows are reused
}

// The CTA's pieces in order. Item (tile, kvh) covers the global units
// [ia, ib); its pieces are its pages [j·B, min((j+1)·B, pages)), cut from
// the item's own start (so identical lanes are cut, and reduced, alike),
// and the CTA takes the pieces that start in its window [w0, w1). The
// current piece is pages [p0, p1).
template <bool kDecode>
struct Walker {
  Tile tl;
  long long tbase;       // unit of (tile, kvh 0, page 0)
  long long w1, ia, ib;
  int kvh, p0, p1, B;

  // the first piece that starts at or after unit w (w inside tile tl)
  __device__ bool start(const Args& a, long long w) {
    kvh = (int)((w - tbase) / tl.pages);
    ia = tbase + (long long)kvh * tl.pages;
    ib = ia + tl.pages;
    p0 = (int)((w - ia + B - 1) / B) * B;
    return p0 < tl.pages ? take() : item_at(a, ib);
  }
  __device__ bool advance(const Args& a) {
    if (p1 < tl.pages) {
      p0 = p1;
      return take();
    }
    return item_at(a, ib);
  }

 private:
  __device__ bool take() {
    if (ia + p0 >= w1) return false;
    p1 = min(p0 + B, tl.pages);
    return true;
  }
  // piece 0 of the item that starts at unit u
  __device__ bool item_at(const Args& a, long long u) {
    if (u >= w1) return false;
    if (u == tbase + (long long)a.n_kv_heads * tl.pages) {
      tbase = u;
      int s = tl.s + tl.nr;
      do {   // skip tiles without work (padding rows)
        tl = tile_at<kDecode>(a, s);
        s += tl.nr;
      } while (tl.pages == 0 && s < a.rows);
    }
    kvh = (int)((u - tbase) / tl.pages);
    ia = u;
    ib = ia + tl.pages;
    p0 = 0;
    return take();
  }
};

// Partial slot of a piece of a split item that starts at unit u. Within
// any B units at most one non-last piece (B long) and one item's last
// piece start, so 2·floor(u/B) + (last ? 0 : 1) never collides.
__device__ __forceinline__ size_t slot_of(long long u, int B, bool last) {
  return 2 * (size_t)(u / B) + (last ? 0 : 1);
}

// --- PTX ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 16 bytes global -> shared, through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// arrive on `bar` once this thread's earlier cp.async copies have landed
// (noinc: the barrier's count already holds this arrival)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a · b for one m16n8k16 tile, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// what pack_f32 rounded away from (lo, hi), itself packed as two bf16
__device__ __forceinline__ uint32_t pack_tail(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return pack_f32(lo - __low2float(h), hi - __high2float(h));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);   // 2 bf16, 4-byte aligned
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
}

// --- the kernel ---------------------------------------------------------------

// Fragment ownership (PTX m16n8k16): lane = 4·gid + tig holds accumulator
// rows gid and gid+8, columns 2·tig and 2·tig+1 of each 8-wide n tile.
template <int D, bool kDecode>
__global__ void __launch_bounds__(kThreads, 2)
    paged_attention_core(const Args a) {
  constexpr int KS = D + 8;                  // padded shared row, bf16
  constexpr int kKT = D / 16;                // k tiles over D (S = QK^T)
  constexpr int kDT = D / 8;                 // n tiles over D (O)
  constexpr int kStageElems = 2 * kStageKeys * KS;
  constexpr int kEpRow = D + 4;              // acc[D], m, l (16-byte rows)
  constexpr int kEp = 16 * kEpRow;           // floats per warp's epilogue
  constexpr int kSlot = kTileMmaRows * (D + 2);   // floats per partial slot
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + 128);
  float* ep = reinterpret_cast<float*>(
      smem + 128 + sizeof(__nv_bfloat16) * kStages * kStageElems);
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int found_row;
  __shared__ long long found_base;
  __shared__ int last_flag;
  __shared__ float row_m[kTileMmaRows], row_l[kTileMmaRows];
  __shared__ int row_t[kTileMmaRows];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = gridDim.x, c = blockIdx.x;
  const int G = a.n_heads / a.n_kv_heads, P = a.page_size;

  // the prologue stages rows in the ring, which is free until then
  int* s_q = reinterpret_cast<int*>(ring);
  int* s_l = s_q + kChunkRows + kTileMmaRows;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);   // the producer's lanes
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    found_row = -1;
  }

  // rows that attend nothing: exact zeros, spread over the CTAs
  const int row_vecs = a.n_heads * D / 8;
  for (int t = c; t < a.rows; t += n)
    if (a.max_pages <= 0 || row_qpos<kDecode>(a, t) < 0) {
      uint4* o = reinterpret_cast<uint4*>(a.out + (size_t)t * a.n_heads * D);
      for (int i = tid; i < row_vecs; i += kThreads)
        o[i] = make_uint4(0u, 0u, 0u, 0u);
    }

  // total work, then this CTA's range and its first item
  int works[kRowsPerThread], excl = 0, chunk_total = 0;
  long long total = 0;
  for (int base = 0; base < a.rows; base += kChunkRows) {
    chunk_scan<kDecode>(a, base, works, excl, chunk_total, warp_sums,
                        s_q, s_l);
    total += chunk_total;
  }
  // the work goes to the first min(n, W) CTAs, so no working range is
  // empty and an item's pieces are held by consecutive CTAs
  const int nw = (int)min((long long)n, total);
  if (c >= nw) return;
  const long long w0 = (long long)c * total / nw;
  const long long w1 = (long long)(c + 1) * total / nw;
  long long cbase = 0;
  for (int base = 0; base < a.rows; base += kChunkRows) {
    if (a.rows > kChunkRows)   // else pass 1's values are still here
      chunk_scan<kDecode>(a, base, works, excl, chunk_total, warp_sums,
                        s_q, s_l);
    long long u = cbase + excl;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      if (works[i] > 0 && u <= w0 && w0 < u + works[i]) {
        found_row = base + tid * kRowsPerThread + i;
        found_base = u;
      }
      u += works[i];
    }
    __syncthreads();
    if (found_row >= 0) break;
    cbase += chunk_total;
  }

  Walker<kDecode> wk;
  wk.tl = tile_at<kDecode>(a, found_row);
  wk.tbase = found_base;
  wk.w1 = w1;
  wk.B = (int)((total + nw - 1) / nw);   // piece size: the mean share
  if (!wk.start(a, w0)) return;           // no piece starts in the window

  if (warp == kConsumerWarps) {   // ---- producer ----
    constexpr int kChunks = D / 8;        // 16-byte chunks per row
    int k = 0;
    do {
      const int* table = a.tables + (size_t)wk.tl.lane * a.max_pages;
      const int kbeg = wk.p0 * P, kend = wk.p1 * P;
      const size_t head = (size_t)wk.kvh * a.n_pages * P * D;
      for (int key0 = kbeg; key0 < kend; key0 += kStageKeys, ++k) {
        const int slot = k % kStages;
        mbar_wait(empty + slot, ((k / kStages) & 1) ^ 1);
        // lane x < 16 finds key x's row; keys past the segment repeat its
        // last key (finite, masked)
        const int key = min(key0 + (lane & 15), kend - 1);
        const int j = key / P;
        const unsigned long long row_of_lane =
            head + ((size_t)table[j] * P + (key - j * P)) * D;
        __nv_bfloat16* dst = ring + slot * kStageElems;
#pragma unroll 4
        for (int i = lane; i < 2 * kStageKeys * kChunks; i += 32) {
          const int row = i / kChunks;          // K rows, then V rows
          const int ch = i - row * kChunks;
          const unsigned long long src =
              __shfl_sync(0xffffffffu, row_of_lane, row % kStageKeys);
          cp_async16(dst + row * KS + ch * 8,
                     (row < kStageKeys ? a.k : a.v) + src + ch * 8);
        }
        cp_async_arrive(full + slot);
      }
    } while (wk.advance(a));
    return;
  }

  // ---- consumers ----
  const int gid = lane >> 2, tig = lane & 3;
  float* my_ep = ep + warp * kEp;
  int k = 0;
  do {
    const Tile tl = wk.tl;
    const int MR = tl.nr * G;
    // Key groups only for a lane's only row: a row's reduction order must
    // not depend on which of its lane's rows share its tile (two identical
    // requests must give identical tokens)
    const int MG = (MR + 15) >> 4;
    const int KG = tl.solo ? kConsumerWarps / MG : 1;
    const int mg = warp % MG, kg = warp / MG;
    const bool active = warp < MG * KG;
    const int mr0 = mg * 16 + gid, mr1 = mr0 + 8;
    const bool in0 = active && mr0 < MR, in1 = active && mr1 < MR;
    const int qp0 = in0 ? row_qpos<kDecode>(a, tl.s + mr0 / G) : -1;
    const int qp1 = in1 ? row_qpos<kDecode>(a, tl.s + mr1 / G) : -1;
    const int head0 = wk.kvh * G;

    uint32_t qf[kKT][4];
    {
      const __nv_bfloat16* q0 =
          a.q + ((size_t)(tl.s + (in0 ? mr0 / G : 0)) * a.n_heads + head0 +
                 (in0 ? mr0 % G : 0)) * D;
      const __nv_bfloat16* q1 =
          a.q + ((size_t)(tl.s + (in1 ? mr1 / G : 0)) * a.n_heads + head0 +
                 (in1 ? mr1 % G : 0)) * D;
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt) {
        const int col = kt * 16 + tig * 2;
        qf[kt][0] = in0 ? ld_pair(q0 + col) : 0u;
        qf[kt][1] = in1 ? ld_pair(q1 + col) : 0u;
        qf[kt][2] = in0 ? ld_pair(q0 + col + 8) : 0u;
        qf[kt][3] = in1 ? ld_pair(q1 + col + 8) : 0u;
      }
    }
    float o[kDT][4];
#pragma unroll
    for (int nt = 0; nt < kDT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;   // running max, log2 units
    float l0 = 0.f, l1 = 0.f;               // this thread's part of the sum

    const int kbeg = wk.p0 * P, kend = wk.p1 * P;
    int i = 0;
    for (int key0 = kbeg; key0 < kend; key0 += kStageKeys, ++i, ++k) {
      const int slot = k % kStages;
      mbar_wait(full + slot, (k / kStages) & 1);
      if (active && i % KG == kg) {
        const __nv_bfloat16* ks = ring + slot * kStageElems;
        const __nv_bfloat16* vs = ks + kStageKeys * KS;
        // S = Q K^T over the stage's 16 keys (two n tiles), even and odd
        // k tiles in separate accumulators: four short MMA chains
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float sc_odd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const __nv_bfloat16* krow =
            ks + ((lane & 7) + (lane >> 4) * 8) * KS + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kt = 0; kt < kKT; ++kt) {
          uint32_t kb[4];
          ldsm_x4(kb, krow + kt * 16);
          float (&acc)[2][4] = (kt & 1) ? sc_odd : sc;
          mma_bf16(acc[0], qf[kt], kb[0], kb[1]);
          mma_bf16(acc[1], qf[kt], kb[2], kb[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] += sc_odd[nt][e];
        // log2 units; mask kv > qpos and keys past the segment
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kv = key0 + nt * 8 + tig * 2 + e;
            const bool live = kv < kend;
            sc[nt][e] = live && kv <= qp0 ? sc[nt][e] * a.scale_log2 : -INFINITY;
            sc[nt][2 + e] =
                live && kv <= qp1 ? sc[nt][2 + e] * a.scale_log2 : -INFINITY;
            mx0 = fmaxf(mx0, sc[nt][e]);
            mx1 = fmaxf(mx1, sc[nt][2 + e]);
          }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        const float base0 = mn0 == -INFINITY ? 0.f : mn0;   // nothing seen yet
        const float base1 = mn1 == -INFINITY ? 0.f : mn1;
        const float alpha0 = exp2f(m0 - base0);             // m = -inf -> 0
        const float alpha1 = exp2f(m1 - base1);
        m0 = mn0;
        m1 = mn1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          sc[nt][0] = exp2f(sc[nt][0] - base0);
          sc[nt][1] = exp2f(sc[nt][1] - base0);
          sc[nt][2] = exp2f(sc[nt][2] - base1);
          sc[nt][3] = exp2f(sc[nt][3] - base1);
          rs0 += sc[nt][0] + sc[nt][1];
          rs1 += sc[nt][2] + sc[nt][3];
        }
        l0 = l0 * alpha0 + rs0;
        l1 = l1 * alpha1 + rs1;
#pragma unroll
        for (int nt = 0; nt < kDT; ++nt) {
          o[nt][0] *= alpha0;
          o[nt][1] *= alpha0;
          o[nt][2] *= alpha1;
          o[nt][3] *= alpha1;
        }
        // O += P V: the two score tiles are one A fragment over 16 keys,
        // P as its bf16 head plus its bf16 tail
        const uint32_t pa[4] = {pack_f32(sc[0][0], sc[0][1]),
                                pack_f32(sc[0][2], sc[0][3]),
                                pack_f32(sc[1][0], sc[1][1]),
                                pack_f32(sc[1][2], sc[1][3])};
        const uint32_t pt[4] = {pack_tail(sc[0][0], sc[0][1]),
                                pack_tail(sc[0][2], sc[0][3]),
                                pack_tail(sc[1][0], sc[1][1]),
                                pack_tail(sc[1][2], sc[1][3])};
        const __nv_bfloat16* vrow =
            vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * KS + (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < kDT / 2; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vrow + dp * 16);
          mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dp], pt, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
          mma_bf16(o[2 * dp + 1], pt, vb[2], vb[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }

    // each warp's (acc, m, l) of its 16 MMA rows into shared memory
    if (active) {
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      float* e0 = my_ep + gid * kEpRow;
      float* e1 = e0 + 8 * kEpRow;
#pragma unroll
      for (int nt = 0; nt < kDT; ++nt) {
        const int col = nt * 8 + tig * 2;
        *reinterpret_cast<float2*>(e0 + col) = make_float2(o[nt][0], o[nt][1]);
        *reinterpret_cast<float2*>(e1 + col) = make_float2(o[nt][2], o[nt][3]);
      }
      if (tig == 0) {
        e0[D] = m0;
        e0[D + 1] = l0;
        e1[D] = m1;
        e1[D + 1] = l1;
      }
    }
    consumer_sync();

    // per MMA row: (M, L) over the key groups, and the output row or -1
    if (tid < MR) {
      const float* e0 = ep + (tid >> 4) * kEp + (tid & 15) * kEpRow;
      float M = -INFINITY, L = 0.f;
      for (int kk = 0; kk < KG; ++kk) M = fmaxf(M, e0[kk * MG * kEp + D]);
      if (M != -INFINITY)
        for (int kk = 0; kk < KG; ++kk)
          L += exp2f(e0[kk * MG * kEp + D] - M) * e0[kk * MG * kEp + D + 1];
      row_m[tid] = M;
      row_l[tid] = L;
      const int t = tl.s + tid / G;
      row_t[tid] = tid / G < tl.nr && row_qpos<kDecode>(a, t) >= 0 ? t : -1;
    }
    consumer_sync();

    // merge the key groups, 8 columns per thread: the output, or this
    // CTA's partial (un-normalised acc, M, L)
    const bool whole = wk.p0 == 0 && wk.p1 == tl.pages;
    float* mine = a.part + slot_of(wk.ia + wk.p0, wk.B, wk.p1 == tl.pages) *
                               (size_t)kSlot;
    for (int idx = tid; idx < MR * (D / 8); idx += 32 * kConsumerWarps) {
      const int r = idx / (D / 8), d0 = (idx - r * (D / 8)) * 8;
      const float M = row_m[r];
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (M != -INFINITY)
        for (int kk = 0; kk < KG; ++kk) {
          const float* e =
              ep + ((r >> 4) + kk * MG) * kEp + (r & 15) * kEpRow;
          const float w = exp2f(e[D] - M);
          const float4 x0 = *reinterpret_cast<const float4*>(e + d0);
          const float4 x1 = *reinterpret_cast<const float4*>(e + d0 + 4);
          acc[0] += w * x0.x; acc[1] += w * x0.y;
          acc[2] += w * x0.z; acc[3] += w * x0.w;
          acc[4] += w * x1.x; acc[5] += w * x1.y;
          acc[6] += w * x1.z; acc[7] += w * x1.w;
        }
      if (whole) {
        const int t = row_t[r];
        if (t >= 0) {
          const float inv = row_l[r] > 0.f ? 1.f / row_l[r] : 0.f;
          uint4 pk;
          pk.x = pack_f32(acc[0] * inv, acc[1] * inv);
          pk.y = pack_f32(acc[2] * inv, acc[3] * inv);
          pk.z = pack_f32(acc[4] * inv, acc[5] * inv);
          pk.w = pack_f32(acc[6] * inv, acc[7] * inv);
          *reinterpret_cast<uint4*>(
              a.out + ((size_t)t * a.n_heads + head0 + r % G) * D + d0) = pk;
        }
      } else {
        float4* dst = reinterpret_cast<float4*>(mine + r * D + d0);
        dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      }
    }
    if (!whole) {
      if (tid < MR) {
        mine[kTileMmaRows * D + 2 * tid] = row_m[tid];
        mine[kTileMmaRows * D + 2 * tid + 1] = row_l[tid];
      }
      const int pieces = (tl.pages + wk.B - 1) / wk.B;
      int* counter = a.counters + (size_t)tl.s * a.n_kv_heads + wk.kvh;
      consumer_sync();   // every partial store of this CTA is issued
      if (tid == 0) {
        __threadfence();
        last_flag = atomicAdd(counter, 1) == pieces - 1;
        if (last_flag) __threadfence();
      }
      consumer_sync();
      if (last_flag) {
        // every piece is written: fold them in piece order (the same
        // reduction wherever the pieces ran), kEG float4 columns per thread
        // against kPB pieces at a time, all loads in flight at once.
        constexpr int kEG = 4, kPB = 4;
        const int n_el = MR * (D / 4);
        const float* __restrict__ part = a.part;
        for (int e0 = tid; e0 < n_el; e0 += 32 * kConsumerWarps * kEG) {
          int rr[kEG];
          float4 acc[kEG];
          float M[kEG], L[kEG];
#pragma unroll
          for (int g = 0; g < kEG; ++g) {
            const int e = e0 + g * 32 * kConsumerWarps;
            rr[g] = e < n_el && row_t[e / (D / 4)] >= 0 ? e / (D / 4) : -1;
            acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
            M[g] = -INFINITY;
            L[g] = 0.f;
          }
          for (int p0 = 0; p0 < pieces; p0 += kPB) {
            float2 ml[kPB][kEG];
            float4 x[kPB][kEG];
#pragma unroll
            for (int u = 0; u < kPB; ++u) {
              const int pj = min(p0 + u, pieces - 1);
              const float* sl =
                  part + slot_of(wk.ia + (long long)pj * wk.B, wk.B,
                                 pj == pieces - 1) * (size_t)kSlot;
#pragma unroll
              for (int g = 0; g < kEG; ++g) {
                const bool live = p0 + u < pieces && rr[g] >= 0;
                const int r = max(rr[g], 0);
                const int d0 = (e0 + g * 32 * kConsumerWarps) % (D / 4) * 4;
                ml[u][g] = live ? __ldcg(reinterpret_cast<const float2*>(
                                      sl + kTileMmaRows * D + 2 * r))
                                : make_float2(-INFINITY, 0.f);
                x[u][g] = live ? __ldcg(reinterpret_cast<const float4*>(
                                     sl + r * D + d0))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
              }
            }
#pragma unroll
            for (int u = 0; u < kPB; ++u)
#pragma unroll
              for (int g = 0; g < kEG; ++g) {
                const float mn = fmaxf(M[g], ml[u][g].x);
                if (mn == -INFINITY) continue;
                const float sa = exp2f(M[g] - mn), sb = exp2f(ml[u][g].x - mn);
                acc[g].x = acc[g].x * sa + x[u][g].x * sb;
                acc[g].y = acc[g].y * sa + x[u][g].y * sb;
                acc[g].z = acc[g].z * sa + x[u][g].z * sb;
                acc[g].w = acc[g].w * sa + x[u][g].w * sb;
                L[g] = L[g] * sa + ml[u][g].y * sb;
                M[g] = mn;
              }
          }
#pragma unroll
          for (int g = 0; g < kEG; ++g) {
            if (rr[g] < 0) continue;
            const int r = rr[g];
            const int d0 = (e0 + g * 32 * kConsumerWarps) % (D / 4) * 4;
            const float inv = L[g] > 0.f ? 1.f / L[g] : 0.f;
            uint2 pk;
            pk.x = pack_f32(acc[g].x * inv, acc[g].y * inv);
            pk.y = pack_f32(acc[g].z * inv, acc[g].w * inv);
            *reinterpret_cast<uint2*>(
                a.out + ((size_t)row_t[r] * a.n_heads + head0 + r % G) * D +
                d0) = pk;
          }
        }
        if (tid == 0) *counter = 0;   // ready for the next call
      }
    }
    consumer_sync();   // the epilogue area and row state are reused
  } while (wk.advance(a));
}

template <int D, bool kDecode>
int launch_d(const Args& a, int n_ctas, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  // once per kernel instance, not per launch
  // (the whole carveout for shared memory, so two CTAs fit on an SM)
  static const cudaError_t attr = [smem] {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_core<D, kDecode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        paged_attention_core<D, kDecode>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  paged_attention_core<D, kDecode><<<n_ctas, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Checks the geometry, then one launch of n_ctas CTAs. `a` without
// tile_rows and scale_log2, which this fills in.
template <bool kDecode>
int launch(Args a, int head_dim, float scale, int n_ctas,
           cudaStream_t stream) {
  if (a.rows == 0) return 0;
  const int P = a.page_size;
  if (a.n_kv_heads <= 0 || a.n_heads % a.n_kv_heads != 0 ||
      a.n_heads / a.n_kv_heads > kMaxGroup || P <= 0 || P > 64 ||
      (P & (P - 1)) != 0 || n_ctas < 1 || a.part == nullptr ||
      a.counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.tile_rows = kTileMmaRows / (a.n_heads / a.n_kv_heads);
  a.scale_log2 = scale * kLog2e;
  switch (head_dim) {
    case 16: return launch_d<16, kDecode>(a, n_ctas, stream);
    case 32: return launch_d<32, kDecode>(a, n_ctas, stream);
    case 64: return launch_d<64, kDecode>(a, n_ctas, stream);
    case 96: return launch_d<96, kDecode>(a, n_ctas, stream);
    case 128: return launch_d<128, kDecode>(a, n_ctas, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace pa
