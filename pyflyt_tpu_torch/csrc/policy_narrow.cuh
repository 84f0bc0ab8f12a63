// The narrow tanh trunks' tile MLP on Hopper's warp-level tensor-core MMA
// (mma.sync m16n8k16, bf16 inputs, f32 accumulation), shared by K4n and
// K3n (policy_narrow.cu) and K2n (fused_epoch_narrow.cu).
//
// The family covers what the 2 x 256 wgmma kernels of policy_mlp.cuh do
// not: 1 to 4 tanh layers a trunk, each at most 128 wide, obs <= 64 and
// act <= 8, actor and critic trunks that may differ. Widths are runtime
// values: every loop below is unrolled to the envelope's largest width and
// guarded by the padded width, so one build covers every trunk of the
// envelope and the fragments stay in registers (static indices).
//
// One trunk's image (ops/cuda_narrow.py::pack_trunk writes it on the host,
// K2n's Adam on the device): for each layer l = 0..depth-1 and the head
// (l = depth), Wt_l = W_l^T as n_l rows of k_l + 8 bf16 (k contiguous),
// k_l and n_l the input and output widths rounded up to 16 (the head's
// outputs to 16), then every bias as n_l f32. The padding is zero, so a
// padded unit computes tanh(0) = 0 and feeds zero weights: it changes no
// value. A row of k + 8 bf16 is an odd multiple of 16 bytes, so the eight
// row addresses of one ldmatrix land in eight distinct 16-byte bank groups.
//
// Each warp owns 16 rows of a 64-row tile. A layer's product is
// acc(16 x n) = A(16 x k) Wt^T: the A fragments in registers, B read from
// the resident image by ldmatrix (Wt's rows are the B operand's columns).
// The accumulator fragment of two adjacent n8 tiles is, register for
// register, the A fragment of the next layer's k16 chunk, so activations
// never leave registers between layers. The backward reads the same image
// transposed (ldmatrix .trans: W_l as B for dz W_l^T).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace narrow {

constexpr int MAX_DEPTH = 4;       // tanh layers a trunk
constexpr int MAX_WIDTH = 128;     // a layer's outputs (and the obs, <= 64)
constexpr int MAX_KC = MAX_WIDTH / 16;  // k16 chunks of a layer's input
constexpr int MAX_NT = MAX_WIDTH / 8;   // n8 tiles of a layer's output
constexpr int MAX_OBS = 64;
constexpr int MAX_ACT = 8;
constexpr int HEAD_PAD = 16;       // the head's outputs in the image
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE_ROWS = 16 * WARPS;  // rows a block tile
constexpr int LAYERS = MAX_DEPTH + 1;  // with the head
constexpr float LOG2PI = 1.8378770664093453f;  // log(2 pi)

}  // namespace narrow

// One trunk's image layout. Must match ops/cuda_narrow.py::_TrunkC.
struct NarrowTrunk {
  int depth;                    // tanh layers, 1..4; entry `depth` of each array is the head
  int k[narrow::LAYERS];        // padded input width (multiple of 16)
  int n[narrow::LAYERS];        // padded output width (multiple of 16; the head 16)
  int kr[narrow::LAYERS];       // the real input width
  int nr[narrow::LAYERS];       // the real output width
  int w_off[narrow::LAYERS];    // byte offset of Wt (n rows x (k + 8) bf16)
  int b_off[narrow::LAYERS];    // byte offset of the bias (n f32)
  int bytes;                    // the image's size, a multiple of 16
};

namespace narrow {

// Whether a host-side NarrowTrunk is a layout ops/cuda_narrow.py::layout
// writes for obs_dim inputs and a head of outs outputs: every width padded
// to 16 within the envelope, real widths chained layer to layer, every
// region 16-byte aligned and inside the image.
inline bool trunk_ok(const NarrowTrunk& T, int obs_dim, int outs) {
  if (T.depth < 1 || T.depth > MAX_DEPTH || T.bytes <= 0 || T.bytes % 16 != 0 || T.k[0] < obs_dim ||
      T.kr[0] != obs_dim || T.nr[T.depth] != outs)
    return false;
  for (int l = 0; l <= T.depth; ++l) {
    const int wmax = l == T.depth ? HEAD_PAD : MAX_WIDTH;
    if (T.k[l] <= 0 || T.k[l] % 16 != 0 || T.k[l] > MAX_WIDTH || T.n[l] <= 0 || T.n[l] % 16 != 0 ||
        T.n[l] > wmax || T.kr[l] > T.k[l] || T.nr[l] > T.n[l] || T.w_off[l] % 16 != 0 || T.b_off[l] % 16 != 0 ||
        T.w_off[l] + T.n[l] * (T.k[l] + 8) * 2 > T.bytes || T.b_off[l] + T.n[l] * 4 > T.bytes ||
        (l > 0 && (T.k[l] != T.n[l - 1] || T.kr[l] != T.nr[l - 1])))
      return false;
  }
  return true;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b: one m16n8k16 product, bf16 inputs, f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices; lane 8q + j gives row j of matrix q
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the image into shared memory, 16 bytes a thread a step (bytes % 16 == 0)
__device__ __forceinline__ void load_image(uint8_t* dst, const uint8_t* src, int bytes) {
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
}

// A fragments of a warp's 16 rows of f32 inputs (row stride `ld`, columns
// past `cols` and rows at or past `n` read as 0), bf16-rounded
__device__ __forceinline__ void load_rows(uint32_t (&a)[MAX_KC][4], const float* x, int ld, int cols, int row0,
                                          int n, int k_pad) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
  auto at = [&](int r, int c) -> float {
    return (r < n && c < cols) ? x[static_cast<size_t>(r) * ld + c] : 0.f;
  };
#pragma unroll
  for (int kc = 0; kc < MAX_KC; ++kc) {
    if (kc * 16 < k_pad) {
      const int c = kc * 16 + 2 * t;
      a[kc][0] = pack_bf16(at(r0, c), at(r0, c + 1));
      a[kc][1] = pack_bf16(at(r1, c), at(r1, c + 1));
      a[kc][2] = pack_bf16(at(r0, c + 8), at(r0, c + 9));
      a[kc][3] = pack_bf16(at(r1, c + 8), at(r1, c + 9));
    }
  }
}

// acc (16 x n) = a (16 x k) Wt^T for the resident Wt at `w` (n rows of
// k + 8 bf16); two n8 tiles and one k16 chunk an ldmatrix
__device__ __forceinline__ void layer_product(float (&acc)[MAX_NT][4], const uint32_t (&a)[MAX_KC][4],
                                              const uint8_t* w, int k, int n) {
  const int lane = threadIdx.x & 31, q = lane >> 3, j = lane & 7;
  const int stride = 2 * (k + 8);
  const uint32_t base = smem_addr(w);
#pragma unroll
  for (int np = 0; np < MAX_NT / 2; ++np) {
    if (np * 16 < n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[2 * np][c] = acc[2 * np + 1][c] = 0.f;
#pragma unroll
      for (int kc = 0; kc < MAX_KC; ++kc) {
        if (kc * 16 < k) {
          uint32_t b[4];
          ldsm4(b, base + (np * 16 + (q >> 1) * 8 + j) * stride + (kc * 16 + (q & 1) * 8) * 2);
          mma(acc[2 * np], a[kc], b[0], b[1]);
          mma(acc[2 * np + 1], a[kc], b[2], b[3]);
        }
      }
    }
  }
}

// acc (16 x k) = bf16(dz) (16 x n) Wt: the data gradient through a layer,
// W read transposed from the same image
__device__ __forceinline__ void layer_product_t(float (&acc)[MAX_NT][4], const uint32_t (&dz)[MAX_KC][4],
                                                const uint8_t* w, int k, int n) {
  const int lane = threadIdx.x & 31, q = lane >> 3, j = lane & 7;
  const int stride = 2 * (k + 8);
  const uint32_t base = smem_addr(w);
#pragma unroll
  for (int np = 0; np < MAX_NT / 2; ++np) {
    if (np * 16 < k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[2 * np][c] = acc[2 * np + 1][c] = 0.f;
#pragma unroll
      for (int kc = 0; kc < MAX_KC; ++kc) {
        if (kc * 16 < n) {
          uint32_t b[4];
          ldsm4_t(b, base + (kc * 16 + (q & 1) * 8 + j) * stride + (np * 16 + (q >> 1) * 8) * 2);
          mma(acc[2 * np], dz[kc], b[0], b[1]);
          mma(acc[2 * np + 1], dz[kc], b[2], b[3]);
        }
      }
    }
  }
}

// acc += bias (f32, column 8 nt + 2t + e of the accumulator fragment)
__device__ __forceinline__ void add_bias(float (&acc)[MAX_NT][4], const float* b, int n) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt) {
    if (nt * 8 < n) {
      const float2 bb = *reinterpret_cast<const float2*>(b + nt * 8 + 2 * t);
      acc[nt][0] += bb.x;
      acc[nt][1] += bb.y;
      acc[nt][2] += bb.x;
      acc[nt][3] += bb.y;
    }
  }
}

__device__ __forceinline__ void tanh_all(float (&acc)[MAX_NT][4], int n) {
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt)
    if (nt * 8 < n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] = tanhf(acc[nt][c]);
}

// the accumulator (16 x n, f32) as the next product's A fragments (bf16)
__device__ __forceinline__ void to_fragments(uint32_t (&a)[MAX_KC][4], const float (&acc)[MAX_NT][4], int n) {
#pragma unroll
  for (int kc = 0; kc < MAX_KC; ++kc) {
    if (kc * 16 < n) {
      a[kc][0] = pack_bf16(acc[2 * kc][0], acc[2 * kc][1]);
      a[kc][1] = pack_bf16(acc[2 * kc][2], acc[2 * kc][3]);
      a[kc][2] = pack_bf16(acc[2 * kc + 1][0], acc[2 * kc + 1][1]);
      a[kc][3] = pack_bf16(acc[2 * kc + 1][2], acc[2 * kc + 1][3]);
    }
  }
}

// A trunk's forward for a warp's 16 rows: a (the input fragments) through
// the tanh layers and the head, whose outputs (bias added) end in acc[0]
// (columns 0-7). With `spill`, layer l's f32 activations go to
// spill[(nt_base + nt) * 32 + lane] (nt_base the layers before it).
__device__ __forceinline__ void trunk_forward(float (&acc)[MAX_NT][4], uint32_t (&a)[MAX_KC][4],
                                              const uint8_t* img, const NarrowTrunk& T, float4* spill) {
  const int lane = threadIdx.x & 31;
  int nt_base = 0;
  for (int l = 0; l < T.depth; ++l) {
    layer_product(acc, a, img + T.w_off[l], T.k[l], T.n[l]);
    add_bias(acc, reinterpret_cast<const float*>(img + T.b_off[l]), T.n[l]);
    tanh_all(acc, T.n[l]);
    if (spill != nullptr) {
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt)
        if (nt * 8 < T.n[l])
          spill[(nt_base + nt) * 32 + lane] = make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
      nt_base += T.n[l] / 8;
    }
    to_fragments(a, acc, T.n[l]);
  }
  const int h = T.depth;
  layer_product(acc, a, img + T.w_off[h], T.k[h], T.n[h]);
  add_bias(acc, reinterpret_cast<const float*>(img + T.b_off[h]), T.n[h]);
}

}  // namespace narrow
