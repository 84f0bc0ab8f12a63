// The general family's cluster-resident forward on Hopper (K4g and K3g's
// route for the trunks whose widest width does not fit one block,
// policy_general.cu): the resident forward of policy_resident.cuh with a
// tile of 64 rows shared by a thread-block cluster of C blocks (2, 4 or 8)
// on neighbouring SMs. With policy_general.cu's entries it replaces
// pyflyt_tpu/ops/pallas_policy.py::build_policy_value_forward and
// pyflyt_tpu/ops/pallas_sgd.py::build_logp_forward at those trunks.
//
// The weight image is policy_resident.cuh's, unchanged (ops/cuda_general.py::
// pack_resident): each layer's output in chunks of NC units, each chunk's
// weight blocks in k order. Rank c of a cluster owns a run of every tanh
// layer's output chunks, [c P, (c + 1) P) with P = ceil(chunks / C), and
// stores chunk j, bf16, from local column (j - c P) NC of its own
// activation buffers. Every rank loads
// the whole obs tile (the first layer's input). So a block holds `width`
// (ops/cuda_general.py::cluster_width) columns: the obs and rank 0's share
// of the widest layer, not the layer. An activation buffer is laid out as
// the weight blocks are: k blocks of KC columns, each TILE rows of 64 bytes
// with resident::swizzle's 16-byte groups, so that one k block of a
// layer's input is 64 TILE contiguous bytes in the rank that owns it.
//
// Warp 0 streams only the rank's weight blocks, in the order the rank
// consumes them, through the bulk-copy ring, as many of a chunk's
// consecutive blocks a stage as fit it (8 of a 32-unit head's). For a k
// block the rank owns, the warps read the A fragments from its own buffer
// by ldmatrix; a k block a peer owns is copied first, 16 bytes a thread in
// one coalesced pass (mapa, ld.shared::cluster.v4), into one of two local
// stages, the next such block's loads in flight while the warps multiply
// the current one, a block barrier between. A head of one chunk of at
// most RELAY_UNITS outputs is relayed instead: input chunk kc is summed on
// the rank that owns it, from its own buffer, and the warps' f32 sums go
// on to the next rank (st.shared::cluster into its stages, a cluster
// barrier a hand-off: C - 1 at most); the last chunk's rank writes the
// outputs.
// Any other head is rank 0's, with the peers' blocks staged. One cluster
// barrier before each layer but the first makes the layer below whole in
// every rank, and one after the head frees the tile's buffers (and lets no
// block leave while a peer may read it). Each output's accumulator still
// runs its k16 steps in order from 0 on the same bf16 fragments and
// mma.sync m16n8k16: the outputs are the per-layer route's bit for bit,
// and K3g's log-probs stay K2g's forward.
//
// K4g: grid (C tiles, 2), a cluster a tile of one trunk (blockIdx.y). K3g:
// persistent clusters (as many as fit the card at once, at most one a
// tile), each walking the tiles q, q + Q, ...; its head's f32 means are
// staged in the shared memory of the rank that writes the head, where one
// thread a row sums the log-prob (general::row_logp) in the action order.
// The wrapper picks C (ops/cuda_general.py::cluster_plan): the smallest
// that fits, or, where the rows leave SMs idle, the largest that keeps one
// block a tile on every SM.
//
// What bounds it on an H100: at the 2 x 1024 trunk (obs 21, act 4) K4g over
// 8192 rows is ~35 GFLOP of bf16 MMA (36 us at 989 TFLOP/s) and K3g over
// 262,144 rows ~563 GFLOP (0.57 ms), against a few MB: operations bound
// both. The design keeps every activation on chip; what it adds to the
// resident kernel is the peers' k blocks, (C - 1) / C of each layer's
// input, over the SM-to-SM network once a block and chunk, and the
// relayed head's hand-offs, one cluster barrier each. What holds it back
// is latency: a tanh chunk's exact tanhf epilogue (~4 us a 128 x 256
// chunk), a block barrier a peer's k block and the cluster barriers
// (~1 us each), with mma.sync at a fraction of the tensor cores' rate.
#pragma once

#include "policy_resident.cuh"

namespace cluster {

using resident::KC;
using resident::NC;
using resident::Ring;
using resident::STAGE_BYTES;
using resident::STAGES;
using resident::swizzle;
using resident::Warps;
using resident::WN;

constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int TILE_ROWS = 64;   // rows a tile (ops/cuda_general.py::CLUSTER_TILE)
constexpr int A_STAGES = 2;     // a peer's k blocks, staged in turn
constexpr int RELAY_UNITS = 32; // the widest head whose sums are relayed (4 n8 tiles a warp)

__host__ __device__ constexpr int chunks(int n) { return (n + NC - 1) / NC; }

// chunks of an n-unit layer a rank owns at most: rank c of C owns the run
// [c per(n, C), (c + 1) per(n, C)) of them, rank 0 a whole run
__host__ __device__ constexpr int per(int n, int C) { return (chunks(n) + C - 1) / C; }

// one k block of a tile's activations: TILE rows of KC bf16
__host__ __device__ constexpr int kblock_bytes(int tile) { return tile * KC * 2; }

// The dynamic shared memory of a launch: the ring, the two activation
// buffers of `width` columns, the peers' k-block stages, two bias buffers
// (a layer's and the next one's, by local column), K3g's staged means and
// the ring's full and empty barriers.
__host__ __device__ constexpr int smem_bytes(int tile, int width, int act_dim, bool logp) {
  return STAGES * STAGE_BYTES + 2 * tile * width * 2 + A_STAGES * kblock_bytes(tile) +
         2 * resident::bias_floats(width, act_dim) * 4 + (logp ? tile * resident::stage_stride(act_dim) * 4 : 0) +
         STAGES * 16;
}

// Whether a trunk is one ops/cuda_general.py::resident_layout writes for
// `in` inputs and a head of `outs` outputs, its obs and rank 0's share of
// each tanh layer inside `width` columns at clusters of C.
inline bool trunk_ok(const ResidentTrunk& T, int in, int outs, int width, int C) {
  if (!resident::trunk_ok(T, in, outs, 1 << 30) || T.k[0] > width) return false;
  for (int l = 0; l + 1 < T.layers; ++l)
    if (per(T.n[l], C) * NC > width) return false;
  return true;
}

__device__ __forceinline__ uint32_t ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// every thread of the cluster: the writes before it are seen by every thread after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the shared::cluster address of this block's shared::cta address `a` in rank `r`
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t r) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(r));
  return d;
}

__device__ __forceinline__ uint4 ld_cluster(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}


// byte offset of activation (row r, column c) in a buffer
template <int TILE>
__device__ __forceinline__ int act_offset(int r, int c) {
  return (c / KC) * kblock_bytes(TILE) + swizzle(r, c % KC);
}

// What a rank computes of each layer, as items i = first(l) .. items(l) - 1:
// item i is output chunk chunk(l, i) over inputs [kbegin(l, i), kend(l,
// i)). A tanh layer's items are the rank's run of its chunks, each over
// every input. A relayed head (one chunk of at most RELAY_UNITS outputs
// over a spread input) is summed in k order across the ranks: its items
// are the rank's run of input chunks, and the rank of the last one
// (`last`) finishes it. Any other head is rank 0's alone, every chunk over
// every input.
struct Share {
  const ResidentTrunk* T;
  int rank, C, head;  // head: the trunk's last layer
  bool relay;

  __device__ __forceinline__ bool relayed(int l) const { return relay && l == head; }
  // the chunks the items run over: a relayed head's input chunks, else the outputs
  __device__ __forceinline__ int units(int l) const { return relayed(l) ? T->k[l] : T->n[l]; }
  __device__ __forceinline__ int first(int l) const {
    return l == head && !relay ? (rank == 0 ? 0 : 1 << 20) : rank * per(units(l), C);
  }
  __device__ __forceinline__ int items(int l) const {
    return l == head && !relay ? chunks(T->n[l]) : min(chunks(units(l)), (rank + 1) * per(units(l), C));
  }
  __device__ __forceinline__ int chunk(int l, int i) const { return relayed(l) ? 0 : i; }
  __device__ __forceinline__ int kbegin(int l, int i) const { return relayed(l) ? i * NC : 0; }
  __device__ __forceinline__ int kend(int l, int i) const { return relayed(l) ? min(T->k[l], (i + 1) * NC) : T->k[l]; }
  // the rank that owns input chunk kc of layer l (> 0), and the chunk's first column there
  __device__ __forceinline__ int owner(int l, int kc) const { return kc / per(T->k[l], C); }
  __device__ __forceinline__ int column(int l, int kc) const { return kc % per(T->k[l], C) * NC; }
  // the rank that writes the head's outputs
  __device__ __forceinline__ int last() const { return relay ? owner(head, chunks(T->k[head]) - 1) : 0; }
};

// The weight blocks a ring stage takes from output chunk j of layer l at
// k0 (below k1): as many of the chunk's consecutive blocks (each `lines` x
// KC bf16, one run in the image) as fit STAGE_BYTES, so that a narrow
// chunk (the head's) streams in few copies.
__device__ __forceinline__ int span(const ResidentTrunk& T, int l, int j, int k0, int k1) {
  return min(STAGE_BYTES / (min(NC, T.n[l] - j * NC) * KC * 2), (k1 - k0) / KC);
}

// Warp 0's walk over a rank's weight blocks: layer, item, k step, the
// run's byte offset (a stage's `span` of blocks); a layer where the rank
// has no item is passed over, and after the rank's last block of a tile the
// walk goes back to its first (the next tile). A rank with no block at all
// never issues a copy, and its walk never moves.
struct Walk {
  const ResidentTrunk* T;
  const uint8_t* img;
  Share sh;
  int l, i, j, k0, k1, off;

  __device__ __forceinline__ Walk(const ResidentTrunk* t, const uint8_t* im, Share s) : T(t), img(im), sh(s) {
    start(0);
  }

  __device__ __forceinline__ void item() {
    j = sh.chunk(l, i);
    k0 = sh.kbegin(l, i);
    k1 = sh.kend(l, i);
    off = T->w[l] + j * NC * T->k[l] * 2 + k0 / KC * min(NC, T->n[l] - j * NC) * KC * 2;
  }

  // the first layer from l0 on (cyclic) where the rank has an item
  __device__ __forceinline__ void start(int l0) {
    for (int c = 0; c < T->layers; ++c) {
      l = (l0 + c) % T->layers;
      i = sh.first(l);
      if (i < sh.items(l)) {
        item();
        return;
      }
    }
  }

  __device__ __forceinline__ int bytes() const { return span(*T, l, j, k0, k1) * min(NC, T->n[l] - j * NC) * KC * 2; }
  __device__ __forceinline__ const uint8_t* src() const { return img + off; }

  __device__ __forceinline__ void next() {
    const int b = bytes();
    k0 += span(*T, l, j, k0, k1) * KC;
    off += b;
    if (k0 < k1) return;
    if (++i < sh.items(l)) {
      item();
      return;
    }
    start(l + 1);
  }
};

// acc (32 x WN, the warp's rows wm.. and columns wn.. of the chunk) += the
// k block of activations at `a` (TILE rows of KC, swizzled) times the
// weight block's lines at `w`, k16 step by k16 step; lines past `rows` are
// skipped unless FULL (resident::product's fragments, from this layout)
template <int NT, bool FULL>
__device__ __forceinline__ void product(float (&acc)[2][NT][4], uint32_t a, int wm, int wn, uint32_t w, int rows) {
  const int lane = threadIdx.x & 31, q = lane >> 3, j = lane & 7;
#pragma unroll
  for (int ks = 0; ks < KC; ks += 16) {
    // fragment matrix q of A: rows + 8 (q & 1), k + 8 (q >> 1); of the
    // block's lines: units + 8 (q >> 1), k + 8 (q & 1)
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) general::ldsm4(af[mi], a + swizzle(wm + mi * 16 + (q & 1) * 8 + j, ks + (q >> 1) * 8));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int r = wn + np * 16;
      if (FULL || r < rows) {
        uint32_t bf[4];
        general::ldsm4(bf, w + swizzle(r + (q >> 1) * 8 + j, ks + (q & 1) * 8));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          general::mma(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          general::mma(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
}

// One layer of a rank over the tile: for each of its chunks j (Share), the
// warp's 32 x WN accumulators over T.k[l] inputs, weight block by weight
// block from the ring (a stage holds `span` of them), then epi(acc, j, rows). With `spread` (every layer
// but the first) input chunk kc lies at rank kc % C, local column (kc / C)
// NC; else the input is the rank's own, column for column. `in` is the
// input buffer's shared::cta address (the same offset in every rank),
// `stage` the A_STAGES local stages of a peer's k block.
template <int TILE, class Epi>
__device__ __forceinline__ void layer(const ResidentTrunk& T, int l, const Share& sh, bool spread, uint32_t in,
                                      uint32_t stage, Ring& rg, Walk& walk, Epi&& epi) {
  using W = Warps<TILE>;
  constexpr int NT = W::NT;
  constexpr int KB = kblock_bytes(TILE);
  static_assert(W::THREADS * 16 == KB, "a k block is one 16-byte load a thread");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % W::MW) * 32, wn = (warp / W::MW) * WN;
  constexpr int CK = NC / KC;  // k steps an input chunk
  const int steps = T.k[l] / KC;
  // with `spread`, the rank's own input chunks are one run: steps [lo, hi)
  const int run = spread ? per(T.k[l], sh.C) * CK : steps, lo = spread ? sh.rank * run : 0, hi = lo + run;
  // k step s's input block: its rank and its byte offset there
  auto owner = [&](int s) { return spread ? s / run : sh.rank; };
  auto offset = [&](int s) { return (spread ? s % run : s) * KB; };
  // the first step from s whose block a peer owns
  auto next_remote = [&](int s) { return s < lo || s >= hi ? s : min(hi, steps); };
  // peer blocks staged so far in the layer: the next one's stage is staged %
  // A_STAGES. Counted across the chunks, so that a chunk's first peer block
  // never takes the stage of the one before it, which a warp may still read:
  // only the block barrier after the next stage's store holds the warps
  int staged = 0;
  for (int j = sh.first(l); j < sh.items(l); ++j) {
    const int rows = min(NC, T.n[l] - j * NC), per_stage = STAGE_BYTES / (rows * KC * 2);
    float acc[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;
    int r = next_remote(0);
    uint4 ahead = r < steps ? ld_cluster(mapa(in + offset(r), owner(r)) + threadIdx.x * 16) : uint4{};
    for (int s0 = 0; s0 < steps; ++rg.step) {
      if (warp == 0) {  // the copies up to STAGES - 1 steps ahead, each once its stage is free
        for (; rg.issued < rg.total && rg.issued < rg.step + STAGES; ++rg.issued) {
          const int si = rg.issued % STAGES;
          if (rg.issued >= STAGES) resident::mbar_wait(rg.empty + 8 * si, (rg.issued / STAGES - 1) & 1);
          resident::issue(walk, rg, si);
        }
      }
      const int st = rg.step % STAGES, blocks = min(per_stage, steps - s0);  // span(T, l, j, s0 KC, T.k[l])
      resident::mbar_wait(rg.full + 8 * st, (rg.step / STAGES) & 1);
      for (int b = 0; b < blocks; ++b) {
        const int s = s0 + b;
        uint32_t a = in + offset(s);
        if (s == r) {  // a peer's block: into the next stage; the next peer block's loads go out
          a = stage + (staged++ % A_STAGES) * KB;
          st_shared(a + threadIdx.x * 16, ahead);
          __syncthreads();  // the stage is whole; every warp is done with the one before it
          r = next_remote(s + 1);
          if (r < steps) ahead = ld_cluster(mapa(in + offset(r), owner(r)) + threadIdx.x * 16);
        }
        const uint32_t blk = rg.base + st * STAGE_BYTES + b * rows * KC * 2;
        if (wn + WN <= rows)  // every column of the warp's is a unit of the chunk
          product<NT, true>(acc, a, wm, wn, blk, rows);
        else if (wn < rows)
          product<NT, false>(acc, a, wm, wn, blk, rows);
      }
      s0 += blocks;
      __syncwarp();  // the warp is done with the stage
      if (lane == 0) resident::mbar_arrive(rg.empty + 8 * st);
    }
    epi(acc, j, rows);
  }
}

// The relayed head (Share::relay): its one chunk of `rows` <= RELAY_UNITS
// outputs summed over the input chunks in order, each rank over its run of
// them from its own buffer, the warps' accumulators handed to the next
// rank through `relay` (its stages' shared memory: TILE threads x 32
// floats, float e of thread t at (e / 4 TILE + t) 16 + (e % 4) 4 bytes), a
// cluster barrier a hand-off; then epi(acc, 0, rows) on the last rank. Each
// output still takes its k16 steps in order from 0.
template <int TILE, class Epi>
__device__ __forceinline__ void relay_head(const ResidentTrunk& T, int l, const Share& sh, uint32_t in, uint32_t relay,
                                           Ring& rg, Walk& walk, Epi&& epi) {
  using W = Warps<TILE>;
  constexpr int NT = W::NT;
  constexpr int KB = kblock_bytes(TILE);
  constexpr int HELD = RELAY_UNITS / 8;  // the n8 tiles of a warp that hold the head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % W::MW) * 32, wn = (warp / W::MW) * WN;
  const int rows = T.n[l], last = sh.last();
  const bool holds = wn < rows;  // the warps of the chunk's first WN columns: threadIdx.x < TILE
  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;
  for (int o = 0; o <= last; ++o) {  // rank o's run of input chunks, in order
    if (o == sh.rank) {
      if (o > 0 && holds) {  // the sums so far, from the rank before
#pragma unroll
        for (int e = 0; e < 2 * HELD; ++e) {
          float* v = acc[e / HELD][e % HELD];
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                       : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                       : "r"(relay + (e * TILE + threadIdx.x) * 16)
                       : "memory");
        }
      }
      for (int kc = sh.first(l); kc < sh.items(l); ++kc) {
        const int k1 = sh.kend(l, kc);
        for (int k0 = sh.kbegin(l, kc); k0 < k1; ++rg.step) {
          if (warp == 0) {  // the copies up to STAGES - 1 steps ahead, each once its stage is free
            for (; rg.issued < rg.total && rg.issued < rg.step + STAGES; ++rg.issued) {
              const int si = rg.issued % STAGES;
              if (rg.issued >= STAGES) resident::mbar_wait(rg.empty + 8 * si, (rg.issued / STAGES - 1) & 1);
              resident::issue(walk, rg, si);
            }
          }
          const int st = rg.step % STAGES, blocks = span(T, l, 0, k0, k1);
          resident::mbar_wait(rg.full + 8 * st, (rg.step / STAGES) & 1);
          const uint32_t a0 = in + (sh.column(l, kc) + k0 % NC) / KC * KB;
          for (int b = 0; b < blocks; ++b) {
            const uint32_t a = a0 + b * KB;
            if (holds) product<NT, false>(acc, a, wm, wn, rg.base + st * STAGE_BYTES + b * rows * KC * 2, rows);
          }
          k0 += blocks * KC;
          __syncwarp();  // the warp is done with the stage
          if (lane == 0) resident::mbar_arrive(rg.empty + 8 * st);
        }
      }
      if (o == last) {
        epi(acc, 0, rows);
      } else if (holds) {  // the sums, to the next rank
        const uint32_t to = mapa(relay, o + 1);
#pragma unroll
        for (int e = 0; e < 2 * HELD; ++e) {
          const float* v = acc[e / HELD][e % HELD];
          asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(to + (e * TILE + threadIdx.x) * 16),
                       "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
                       : "memory");
        }
      }
    }
    if (o < last) cluster_sync();  // the hand-off has landed
  }
}

// TILE rows of f32 x (row stride ld, row0 first, zero past n and `cols`)
// into a buffer's first k / KC k blocks, two columns a thread a step, the
// loads of U steps in flight before their stores
template <int TILE>
__device__ __forceinline__ void load_rows(uint8_t* dst, const float* x, int ld, int n, int cols, int k, int row0) {
  constexpr int THREADS = Warps<TILE>::THREADS, U = 4;
  const int half = k / 2, total = TILE * half;
  for (int i0 = threadIdx.x; i0 < total; i0 += U * THREADS) {
    float v[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS, r = i / half, c = 2 * (i % half), row = row0 + r;
      v[u][0] = v[u][1] = 0.f;
      if (i < total && row < n) {
        const float* src = x + static_cast<long long>(row) * ld;
        if (c < cols) v[u][0] = __ldg(src + c);
        if (c + 1 < cols) v[u][1] = __ldg(src + c + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS, r = i / half, c = 2 * (i % half);
      if (i < total)
        *reinterpret_cast<__nv_bfloat162*>(dst + act_offset<TILE>(r, c)) = __floats2bfloat162_rn(v[u][0], v[u][1]);
    }
  }
}

// The epilogue of one chunk (resident::forward_epilogue's, into this
// layout): fragment c of (mi, ni) is row wm + 16 mi + gr + 8 (c / 2),
// column wn + 8 ni + 2 t4 + c % 2 of the chunk. A tanh layer stores
// tanhf(acc + bias) rounded to bf16 at local column c0 + column of `out`;
// the head passes each pair of acc + bias to head_fn(r, c0 + column, v0, v1).
template <int TILE, int NT, class Head>
__device__ __forceinline__ void epilogue(const float (&acc)[2][NT][4], const float* bias, int c0, int rows, bool head,
                                         uint8_t* out, Head&& head_fn) {
  using W = Warps<TILE>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % W::MW) * 32, wn = (warp / W::MW) * WN;
  const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int col = wn + ni * 8 + 2 * t4;
    if (col >= rows) continue;
    const float2 bb = *reinterpret_cast<const float2*>(bias + c0 + col);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mi * 16 + gr + 8 * h, cc = c0 + col;
        const float v0 = acc[mi][ni][2 * h] + bb.x, v1 = acc[mi][ni][2 * h + 1] + bb.y;
        if (!head)
          *reinterpret_cast<__nv_bfloat162*>(out + act_offset<TILE>(r, cc)) = __floats2bfloat162_rn(tanhf(v0), tanhf(v1));
        else
          head_fn(r, cc, v0, v1);
      }
    }
  }
}

template <int TILE, bool LOGP>
__global__ void __launch_bounds__(Warps<TILE>::THREADS, 1) cluster_kernel(const __grid_constant__ ResidentArgs p) {
  using W = Warps<TILE>;
  constexpr int THREADS = W::THREADS;
  extern __shared__ __align__(128) uint8_t smem[];
  const int job = LOGP ? 0 : blockIdx.y;
  const ResidentTrunk& T = p.trunk[job];
  const uint8_t* img = p.image[job];
  uint8_t* act0 = smem + STAGES * STAGE_BYTES;
  uint8_t* act1 = act0 + TILE * p.width * 2;
  uint8_t* stage = act1 + TILE * p.width * 2;
  const int nb = resident::bias_floats(p.width, p.act_dim);
  float* biases = reinterpret_cast<float*>(stage + A_STAGES * kblock_bytes(TILE));  // layer l's at + (l % 2) nb
  float* means = biases + 2 * nb;                                                   // K3g, rank 0
  const int ms = resident::stage_stride(p.act_dim);
  const uint32_t full = general::smem_addr(means + (LOGP ? TILE * ms : 0));

  const int tid = threadIdx.x;
  const Share sh{&T, static_cast<int>(ctarank()), static_cast<int>(nctarank()), T.layers - 1,
                 T.layers > 1 && T.n[T.layers - 1] <= RELAY_UNITS};
  // cluster q of Q walks the tiles q, q + Q, ... (rows past n: zeros, no store)
  const int q = blockIdx.x / sh.C, Q = gridDim.x / sh.C;
  const int tiles = (p.n + TILE - 1) / TILE;
  const int my_tiles = q < tiles ? (tiles - q + Q - 1) / Q : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      resident::mbar_init(full + 8 * s, 1);
      resident::mbar_init(full + 8 * (STAGES + s), THREADS / 32);  // empty: every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the barriers exist before a copy or an arrival lands in them

  int per_tile = 0;  // ring steps a tile
  for (int l = 0; l < T.layers; ++l)
    for (int i = sh.first(l); i < sh.items(l); ++i) {
      const int j = sh.chunk(l, i), k1 = sh.kend(l, i);
      for (int k0 = sh.kbegin(l, i); k0 < k1; k0 += span(T, l, j, k0, k1) * KC) ++per_tile;
    }
  Ring rg{general::smem_addr(smem), full, full + 8 * STAGES, 0, 0, my_tiles * per_tile};
  Walk walk(&T, img, sh);  // warp 0's: the next block to copy
  if (tid < 32)  // the first copies go out while the obs load
    for (; rg.issued < rg.total && rg.issued < STAGES; ++rg.issued) resident::issue(walk, rg, rg.issued);

  for (int g = 0; g < my_tiles; ++g) {
    const int row0 = (q + g * Q) * TILE;
    load_rows<TILE>(act0, p.x, p.ld, p.n, p.obs_dim, T.k[0], row0);
    for (int l = 0; l < T.layers; ++l) {
      const bool head = l == sh.head;
      float* bias = biases + (l % 2) * nb;  // the layer before reads the other buffer
      const float* src = reinterpret_cast<const float*>(img + T.b[l]);
      if (head) {
        if (sh.rank == sh.last())
          for (int i = tid; i < T.n[l]; i += THREADS) bias[i] = src[i];
      } else {  // the rank's run of chunks, from local column 0
        const int u0 = sh.first(l) * NC, u1 = min(T.n[l], sh.items(l) * NC);
        for (int i = tid; u0 + i < u1; i += THREADS) bias[i] = src[u0 + i];
      }
      // the layer's input (every rank's share) and bias are written; every
      // thread of the cluster is done reading what the layer writes
      if (l == 0)
        __syncthreads();
      else
        cluster_sync();
      uint8_t* out = l % 2 ? act0 : act1;
      const uint32_t in = general::smem_addr(l % 2 ? act1 : act0);
      auto epi = [&](const auto& acc, int j, int rows) {
        // a tanh layer's chunk at its local column, the head's at its unit
        epilogue<TILE>(acc, bias, head ? j * NC : (j - sh.first(l)) * NC, rows, head, out,
                       [&](int r, int cc, float v0, float v1) {
          if constexpr (LOGP) {
            if (cc < p.act_dim) means[r * ms + cc] = v0;
            if (cc + 1 < p.act_dim) means[r * ms + cc + 1] = v1;
          } else if (row0 + r < p.n) {
            const long long row = row0 + r;
            if (job == 0) {
              if (cc < p.act_dim) p.out[0][row * p.act_dim + cc] = v0;
              if (cc + 1 < p.act_dim) p.out[0][row * p.act_dim + cc + 1] = v1;
            } else if (cc == 0) {
              p.out[1][row] = v0;
            }
          }
        });
      };
      if (sh.relayed(l))
        relay_head<TILE>(T, l, sh, in, general::smem_addr(stage), rg, walk, epi);
      else
        layer<TILE>(T, l, sh, l > 0, in, general::smem_addr(stage), rg, walk, epi);
    }
    // the head's means are staged; every rank is done reading its peers'
    // buffers for this tile (and none leaves while a peer may read it)
    cluster_sync();
    if constexpr (LOGP) {
      if (sh.rank == sh.last()) {
        for (int r = tid; r < TILE; r += THREADS) {
          const long long row = row0 + r;
          if (row < p.n)
            p.out[0][row] = general::row_logp(p.x + row * p.ld + p.obs_dim, means + r * ms, p.log_std, p.act_dim,
                                              p.has_range, p.ls_lo, p.ls_hi);
        }
      }
    }
  }
}

// Enqueues one launch in clusters of C blocks: K4g (LOGP false: grid (C
// tiles, 2)) or K3g (persistent: as many clusters as fit the card at once,
// at most one a tile).
template <int TILE, bool LOGP>
cudaError_t launch(const ResidentArgs& p, int C, cudaStream_t stream) {
  auto kernel = cluster_kernel<TILE, LOGP>;
  const int smem = smem_bytes(TILE, p.width, p.act_dim, LOGP);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (p.n + TILE - 1) / TILE;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * tiles, LOGP ? 1 : 2);
  cfg.blockDim = dim3(Warps<TILE>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (LOGP) {
    int fit = 0;
    if ((e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg)) != cudaSuccess) return e;
    if (fit <= 0) return cudaErrorInvalidConfiguration;
    cfg.gridDim = dim3(C * (fit < tiles ? fit : tiles));
  }
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

}  // namespace cluster
