// Modulated deformable convolution (DCNv2) forward and backward for NVIDIA
// Hopper (sm_90a). The forward is described here; the backward after the
// forward's launcher.
//
// Replaces the TPU kernels visualdet3d_tpu/ops/deform_conv.py::_lerp_matmul_kernel
// (bf16, launched by _lerp_matmul_pallas) and ::_lerp_matmul_f32_kernel (f32,
// _lerp_matmul_f32_pallas), with the XLA gather that fed them (the all-taps
// and pre-multiplied forward variants and the backward follow the forward's
// launcher):
//
//   out[b,p,:] = bias + sum_k bilinear_zero(x[b], base_p + tap_k*dil + off[b,p,k])
//                               * mask[b,p,k] @ W_k          (W_k: [C_in, C_out])
//
// NHWC x and output, offsets [B,Ho,Wo,2K] ((dy, dx) of tap k at channels 2k,
// 2k+1, taps row-major), mask [B,Ho,Wo,K], W [K, C_in, C_out]. Offsets and
// mask may be channel slices of a wider NHWC tensor: each takes its own
// stride between pixels.
//
// What bounds it on the card: the tap products, 2*K*C_in*C_out operations
// per output pixel against (C_in + 3K + C_out) values moved: at the KM3D
// neck's shapes ~100-300 FLOPs per byte, above the f32 balance point of an
// H100 (67 TFLOP/s over 3.35 TB/s = 20) and near the bf16 one (~295). The
// TPU kernel's u32 row-pair packing, [v00|v01|v10|v11] rows, taps-outer
// gather layout and VMEM row budgets answered a TPU without an in-kernel
// gather; none is kept. The design (the second; the first ran one serial loop):
//   * per (pixel, tap), once: the f32 coordinate, the four corner indices
//     (-1 for a corner outside the unpadded image: it contributes 0) and the
//     four lerp weights, formed in the input dtype as the plain version forms
//     them (corner_entry);
//   * the four corners gathered with 16-byte loads (8 bf16 or 4 f32
//     channels of a corner pixel; scalar loads where C_in or the base
//     pointer does not allow it) and lerped in f32 with explicitly rounded
//     products and sums (__fmul_rn/__fadd_rn: nvcc would otherwise contract
//     them into FMAs and differ from the plain version before the bf16
//     rounding), the sampled value rounded to bf16 in the bf16 kernel where
//     K3 rounds;
//   * a persistent block per SM whose producer warps gather a tile of 128
//     or 64 output pixels x 64 (bf16) or 32 (f32) input channels of one
//     tap into a ring of shared-memory stages, beside the W_k chunk copied
//     by cp.async, while its consumer warps accumulate the tile's products
//     over all its output channels (64, 128 or 256) in f32 registers:
//     mma.sync m16n8k16 in bf16, 8x8 FMA tiles in f32 (the section "gather,
//     then MMA, pipelined between warps" below);
//   * an epilogue that rounds to the output dtype, then adds the bias in
//     that dtype.
// The all-taps (K4) and pre-multiplied (K6) variants keep their own designs.
//
// Plain C interface for ctypes; each entry returns the cudaError_t of the
// launch (0 on success). The launch goes on the caller's stream and does not
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTileP = 64;   // output pixels per block
constexpr int kTileO = 64;   // output channels per block
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a value rounded to T, back in f32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The all-taps kernel's input channels per staged chunk, and row strides of
// its staged tiles in elements: multiples of 8 (WMMA), 16-byte rows, so that
// a thread stores its 16-byte group of sampled values at once.
template <typename T> struct Tiles;
template <> struct Tiles<__nv_bfloat16> {
  static constexpr int chunk = 64;
  static constexpr int a_ld = chunk + 8;
  static constexpr int b_ld = kTileO + 8;
  static constexpr int c_ld = kTileO + 4;
};

// V consecutive values as f32: one 16-byte load when V = 16 / sizeof(T)
// (the caller guarantees the alignment), else V scalar loads.
template <typename T, int V>
__device__ __forceinline__ void load_vals(const T* p, float (&out)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f32(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f32(p[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vals(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) t[j] = from_f32<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = from_f32<T>(v[j]);
  }
}

// The sampled [kTileP x CHUNK] tile of channels c0.. (row stride A_LD), V
// channels a thread at a time (the 8 threads of a bf16 pixel row read 128
// contiguous bytes of each corner). With V > 1 the caller guarantees
// C_in % V == 0, so a group is wholly inside or wholly outside C_in.
template <typename T, int V, int CHUNK = Tiles<T>::chunk, int A_LD = Tiles<T>::a_ld>
__device__ __forceinline__ void gather_tile(const T* __restrict__ xb, int C_in, int c0,
                                            const int (&s_idx)[4][kTileP],
                                            const float (&s_wt)[4][kTileP], T* s_a, int tid) {
  constexpr int chunk = CHUNK, a_ld = A_LD, groups = chunk / V;
  for (int e = tid; e < kTileP * groups; e += kThreads) {
    const int pl = e / groups, cl = (e - pl * groups) * V;
    const int c = c0 + cl;
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
    if (c < C_in) {
      float corner[4][V];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = s_idx[q][pl];
        if (idx >= 0) {
          load_vals<T, V>(xb + (long long)idx * C_in + c, corner[q]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) corner[q][j] = 0.f;
        }
      }
      const float wx0 = s_wt[0][pl], wx1 = s_wt[1][pl];
      const float wy0 = s_wt[2][pl], wy1 = s_wt[3][pl];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        // corners (y0,x0) (y0,x0+1) (y0+1,x0) (y0+1,x0+1): the y lerp of each
        // column, then the x lerp
        const float vx0 = __fadd_rn(__fmul_rn(corner[0][j], wy0), __fmul_rn(corner[2][j], wy1));
        const float vx1 = __fadd_rn(__fmul_rn(corner[1][j], wy0), __fmul_rn(corner[3][j], wy1));
        v[j] = __fadd_rn(__fmul_rn(vx0, wx0), __fmul_rn(vx1, wx1));
      }
    }
    store_vals<T, V>(s_a + pl * a_ld + cl, v);
  }
}

// The W_k chunk [chunk x COLS] of rows c0.. and columns o0.., zero outside
// C_in x C_out; V columns a thread at a time (C_out % V == 0 when V > 1).
template <typename T, int V, int COLS = kTileO, int B_LD = Tiles<T>::b_ld>
__device__ __forceinline__ void load_weight_tile(const T* __restrict__ wk, int C_in, int C_out,
                                                 int c0, int o0, T* s_b, int tid) {
  constexpr int chunk = Tiles<T>::chunk, b_ld = B_LD, groups = COLS / V;
  for (int e = tid; e < chunk * groups; e += kThreads) {
    const int cl = e / groups, ol = (e - cl * groups) * V;
    const int c = c0 + cl, o = o0 + ol;
    float v[V];
    if (c < C_in && o < C_out) {
      load_vals<T, V>(wk + (long long)c * C_out + o, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
    store_vals<T, V>(s_b + cl * b_ld + ol, v);
  }
}

// The corner origin of output pixel p (of image b, flat index pix = b*P +
// p) and tap k: (y0, x0), clamped to [-2, H] x [-2, W] (which keeps every
// corner's inside/outside verdict), and the four lerp weights 1-fx, fx,
// (1-fy)*mask, fy*mask, formed in T as the plain version forms them.
template <typename T>
__device__ __forceinline__ void corner_origin(const T* __restrict__ offset,
                                              const T* __restrict__ mask, long long pix, int p,
                                              int k, int H, int W, int Wo, int kw, int stride,
                                              int pad, int dil, int off_stride, int mask_stride,
                                              int& y0, int& x0, float (&wt)[4]) {
  const int ho = p / Wo, wo = p - ho * Wo;
  const float dy = to_f32(offset[pix * off_stride + 2 * k]);
  const float dx = to_f32(offset[pix * off_stride + 2 * k + 1]);
  const float m = to_f32(mask[pix * mask_stride + k]);
  const float py = (float)(ho * stride - pad + (k / kw) * dil) + dy;
  const float px = (float)(wo * stride - pad + (k % kw) * dil) + dx;
  const float fy0 = floorf(py), fx0 = floorf(px);
  // fractional parts, then the lerp weights, rounded to T as the plain
  // version forms them in the input dtype
  const float fy = round_to<T>(py - fy0), fx = round_to<T>(px - fx0);
  wt[0] = round_to<T>(__fsub_rn(1.f, fx));
  wt[1] = fx;
  wt[2] = round_to<T>(__fmul_rn(round_to<T>(__fsub_rn(1.f, fy)), m));
  wt[3] = round_to<T>(__fmul_rn(fy, m));
  // the integer cast is safe after the clamp (NaN goes to -2)
  y0 = (int)fminf(fmaxf(fy0, -2.f), (float)H);
  x0 = (int)fminf(fmaxf(fx0, -2.f), (float)W);
}

// The corner table entry of output pixel p and tap k: the four corner
// pixels (y0,x0) (y0,x0+1) (y0+1,x0) (y0+1,x0+1) as indices into the image
// (-1 for a corner outside the unpadded image: it contributes 0) and the
// four lerp weights (corner_origin).
template <typename T>
__device__ __forceinline__ void corner_entry(const T* __restrict__ offset,
                                             const T* __restrict__ mask, long long pix, int p,
                                             int k, int H, int W, int Wo, int kw, int stride,
                                             int pad, int dil, int off_stride, int mask_stride,
                                             int (&idx)[4], float (&wt)[4]) {
  int y0, x0;
  corner_origin<T>(offset, mask, pix, p, k, H, W, Wo, kw, stride, pad, dil, off_stride,
                   mask_stride, y0, x0, wt);
  const bool y0_in = y0 >= 0 && y0 < H, y1_in = y0 + 1 >= 0 && y0 + 1 < H;
  const bool x0_in = x0 >= 0 && x0 < W, x1_in = x0 + 1 >= 0 && x0 + 1 < W;
  idx[0] = y0_in && x0_in ? y0 * W + x0 : -1;
  idx[1] = y0_in && x1_in ? y0 * W + x0 + 1 : -1;
  idx[2] = y1_in && x0_in ? (y0 + 1) * W + x0 : -1;
  idx[3] = y1_in && x1_in ? (y0 + 1) * W + x0 + 1 : -1;
}

// Asynchronous copies into shared memory (cp.async), BYTES = 4 or 16; with
// pred false nothing is read and the destination is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(pred ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(pred ? 4 : 0));
  }
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The per-tap forward (K3 in bf16, K5 in f32) and the dW pass of the
// backward (kernel B, after the dx kernels) share one design: gather, then
// MMA, pipelined between warps. The first designs ran every block through
// one serial loop (corner table, barrier, gather and lerp, barrier, a few
// 16x16x16 MMAs, barrier): on an H100 at the KM3D neck's shapes the gather
// and the MMA steps each took about half of the time and never overlapped
// (each phase compiled out in turn), and the dW kernel re-gathered each
// sampled tile once per 64 output channels. Here a block has two roles:
//   * producer warps (12 or 8, in groups that take the stages in turn)
//     fill a ring of kWsStages stages in shared memory: per stage the
//     sampled tile, gathered with 16-byte loads (four corners of 4 samples
//     in flight a thread, at element offsets into the image kept in the
//     corner tables) and lerped with the explicitly rounded products and
//     sums of gather_tile (rounded to bf16 in the bf16 kernels);
//   * consumer warps (4 where the block's tile is 64 output channels wide,
//     else 8) each own a 32 x 64 tile of the block's f32 accumulators and
//     run the stage's products: mma.sync m16n8k16 (bf16 in, f32
//     accumulate) with operands loaded by ldmatrix in bf16, an 8 x 8
//     register tile of FMAs a thread in f32; 8 consumer warps in bf16 also
//     copy each stage's second operand (a W_k chunk or a dy tile) by
//     cp.async and build the forward's next corner tables (corner_entry, as
//     before), work the producers do where the consumers are the busier;
//   * named barriers hand a stage over (full: producers arrive, consumers
//     wait; empty: the reverse), so that the gather of the next stages runs
//     while the tensor cores (or the FMA units) work on this one.
// A block is 512 threads with one block an SM (up to ~215 KB of dynamic
// shared memory); every sample is gathered once for all the output
// channels a block holds (up to 256). The corner tables of all taps of a
// tile (2 x K x pixels x 32 bytes) bound K: 3x3 kernels fit every shape.
// ---------------------------------------------------------------------------

constexpr int kWsThreads = 512;  // a block: consumer warps, then producer warps
constexpr int kWsStages = 4;
// The producers form groups that fill the stages in turn, so that one
// group's loads are in flight while another lerps: with 12 producer warps
// (4 consumers) 3 groups in the forward and 4 in dW, with 8 producer warps
// 2 (the fastest on an H100 at the KM3D neck's shapes, against 1 to 4 groups).
__host__ __device__ constexpr int producer_groups(int cw, bool dw) {
  return cw == 4 ? (dw ? 4 : 3) : 2;
}
// named barriers (0 is __syncthreads): stage s is full at 1 + s and empty at
// 1 + kWsStages + s; the producers' own barrier follows
constexpr int kBarProducers = 1 + 2 * kWsStages;
constexpr int kBarConsumers = 2 + 2 * kWsStages;  // the consumers' own barrier
constexpr int kBarTables = 3 + 2 * kWsStages;     // the next tile's tables are built
constexpr int kWsMaxSmem = 232448;  // the opt-in limit of a block on sm_90

// Consumer warps (a 32 x 64 accumulator tile each) of a block whose tiles
// are NT x 64 output channels wide: 4 at NT = 1, where the gather dominates
// and more warps gather, else 8. The other warps of the block produce.
// (At NT = 1 in bf16, 8 consumers were 7% slower at the 96x320 forward and
// 2 were 1.5x slower on an H100.)
__host__ __device__ constexpr int consumer_warps(int nt) { return nt == 1 ? 4 : 8; }

__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16_16816(float* c, const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage of a consumer warp: its 32 x 64 tile at rows m0, columns n0 of
// the block's accumulators += A . B over KD steps of the reduction. B is
// [k][n] (row k at B + k * b_ld); A is [m][k] (A_KMAJOR false: row m at
// A + m * a_ld) or [k][m] (true). bf16: mma.sync m16n8k16, acc[(i*8+j)*4+e]
// the fragment of m16 tile i, n8 tile j; f32: lane (mg, ng) = (lane / 8,
// lane % 8) owns rows m0 + 8 mg + i, columns n0 + 8 ng + j, acc[i*8+j], one
// FMA per product in k order.
template <typename T, bool A_KMAJOR, int KD>
__device__ __forceinline__ void warp_mma_stage(float (&acc)[64], const T* A, int a_ld, const T* B,
                                               int b_ld, int m0, int n0, int lane) {
  if constexpr (std::is_same<T, float>::value) {
    const int mg = lane >> 3, ng = lane & 7;
#pragma unroll 4
    for (int k = 0; k < KD; ++k) {
      float av[8], bv[8];
      if constexpr (A_KMAJOR) {
        const float4 lo = *reinterpret_cast<const float4*>(A + k * a_ld + m0 + 8 * mg);
        const float4 hi = *reinterpret_cast<const float4*>(A + k * a_ld + m0 + 8 * mg + 4);
        av[0] = lo.x; av[1] = lo.y; av[2] = lo.z; av[3] = lo.w;
        av[4] = hi.x; av[5] = hi.y; av[6] = hi.z; av[7] = hi.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = A[(m0 + 8 * mg + i) * a_ld + k];
      }
      const float4 b_lo = *reinterpret_cast<const float4*>(B + k * b_ld + n0 + 8 * ng);
      const float4 b_hi = *reinterpret_cast<const float4*>(B + k * b_ld + n0 + 8 * ng + 4);
      bv[0] = b_lo.x; bv[1] = b_lo.y; bv[2] = b_lo.z; bv[3] = b_lo.w;
      bv[4] = b_hi.x; bv[5] = b_hi.y; bv[6] = b_hi.z; bv[7] = b_hi.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
    }
  } else {
#pragma unroll
    for (int k0 = 0; k0 < KD; k0 += 16) {
      unsigned a[2][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (A_KMAJOR) {
          ldsm_x4_trans(a[i], A + (k0 + (lane & 7) + (lane >> 4) * 8) * a_ld + m0 + 16 * i +
                                  ((lane >> 3) & 1) * 8);
        } else {
          ldsm_x4(a[i], A + (m0 + 16 * i + (lane & 15)) * a_ld + k0 + (lane >> 4) * 8);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ldsm_x4_trans(b[jj], B + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * b_ld + n0 + 16 * jj +
                                 (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma_bf16_16816(acc + (i * 8 + j) * 4, a[i], b[j >> 1][(j & 1) * 2],
                         b[j >> 1][(j & 1) * 2 + 1]);
    }
  }
}

// Where accumulator e of a consumer lane lies in its warp's 32 x 64 tile:
// (row, column), for the layouts of warp_mma_stage.
template <typename T>
__device__ __forceinline__ void acc_pos(int e, int lane, int& row, int& col) {
  if constexpr (std::is_same<T, float>::value) {
    row = 8 * (lane >> 3) + (e >> 3);
    col = 8 * (lane & 7) + (e & 7);
  } else {
    const int i = e >> 5, j = (e >> 2) & 7, f = e & 3;
    row = 16 * i + (lane >> 2) + (f >> 1) * 8;
    col = 8 * j + (lane & 3) * 2 + (f & 1);
  }
}

// Two adjacent values rounded to T, one store (p aligned to the pair).
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ int comp(const int4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// G samples of V channels each (V = 16 / sizeof(T): one 16-byte load a
// corner; V = 1: scalar loads): corner q of sample g is at xc + off[g].q
// (xc: the image's base plus the channel; off: the corner pixel's element
// offset in the image, < 0 or !ok[g]: zero); the four corners of all G
// samples are loaded before any is used. The lerp is gather_tile's
// (explicitly rounded products and sums); the results go to dst[g] rounded
// to T, as one 16-byte store where VEC_DST, else one store a value.
template <typename T, int V, int G, bool VEC_DST>
__device__ __forceinline__ void sample_groups(const T* __restrict__ xc, const int4 (&off)[G],
                                              const float4 (&wt)[G], const bool (&ok)[G],
                                              T* const (&dst)[G]) {
  constexpr bool kVec = V * sizeof(T) == 16;
  using Raw = typename std::conditional<kVec, uint4, T>::type;
  Raw raw[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = comp(off[g], q);
      if (ok[g] && i >= 0) {
        raw[g][q] = __ldg(reinterpret_cast<const Raw*>(xc + i));
      } else if constexpr (kVec) {
        raw[g][q] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        raw[g][q] = from_f32<T>(0.f);
      }
    }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (!ok[g]) continue;
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float cv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (kVec) {
          cv[q] = to_f32(reinterpret_cast<const T*>(&raw[g][q])[j]);
        } else {
          cv[q] = to_f32(raw[g][q]);
        }
      }
      const float vx0 = __fadd_rn(__fmul_rn(cv[0], wt[g].z), __fmul_rn(cv[2], wt[g].w));
      const float vx1 = __fadd_rn(__fmul_rn(cv[1], wt[g].z), __fmul_rn(cv[3], wt[g].w));
      v[j] = __fadd_rn(__fmul_rn(vx0, wt[g].x), __fmul_rn(vx1, wt[g].y));
    }
    if constexpr (VEC_DST) {
      store_vals<T, V>(dst[g], v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[g][j] = from_f32<T>(v[j]);
    }
  }
}

// dst[r][cc] = src[r * src_ld + col0 + cc] for r < rows_valid and
// col0 + cc < cols_valid, else 0: ROWS x COLS, by the PT producer threads.
// vec: 16-byte cp.async copies left in flight (cols_valid % (16 / sizeof(T))
// == 0, 16-byte aligned rows); else plain loads and stores.
template <typename T, int ROWS, int COLS, int PT>
__device__ __forceinline__ void producer_copy(T* dst, int dst_ld, const T* __restrict__ src,
                                              long long src_ld, long long rows_valid, int col0,
                                              int cols_valid, bool vec, int ptid) {
  if (vec) {
    constexpr int kV = 16 / sizeof(T), groups = COLS / kV;
    for (int e = ptid; e < ROWS * groups; e += PT) {
      const int r = e / groups, cc = (e - r * groups) * kV;
      const bool ok = r < rows_valid && col0 + cc < cols_valid;
      cp_async<16>(dst + r * dst_ld + cc, ok ? src + r * src_ld + col0 + cc : src, ok);
    }
  } else {
    for (int e = ptid; e < ROWS * COLS; e += PT) {
      const int r = e / COLS, cc = e - r * COLS;
      const bool ok = r < rows_valid && col0 + cc < cols_valid;
      dst[r * dst_ld + cc] = ok ? src[r * src_ld + col0 + cc] : from_f32<T>(0.f);
    }
  }
}

struct DcnGeom {
  int B, H, W, C_in, Ho, Wo, C_out, kh, kw, stride, pad, dil, off_stride, mask_stride;
};

// The corner table entry of output pixel p of image b and tap k: the four
// corners as element offsets in the image (corner pixel x C_in; -1 outside
// it) and the lerp weights; a pixel past the map (p >= P) gets offsets -1
// and weights 0 (its samples are 0).
template <typename T>
__device__ __forceinline__ void table_entry(const T* __restrict__ offset, const T* __restrict__ mask,
                                            long long b, int p, int k, const DcnGeom& g,
                                            int4& off, float4& wt) {
  int id[4] = {-1, -1, -1, -1};
  float w[4] = {0.f, 0.f, 0.f, 0.f};
  const int P = g.Ho * g.Wo;
  if (p < P)
    corner_entry<T>(offset, mask, b * P + p, p, k, g.H, g.W, g.Wo, g.kw, g.stride, g.pad, g.dil,
                    g.off_stride, g.mask_stride, id, w);
#pragma unroll
  for (int j = 0; j < 4; ++j) id[j] = id[j] >= 0 ? id[j] * g.C_in : -1;
  off = make_int4(id[0], id[1], id[2], id[3]);
  wt = make_float4(w[0], w[1], w[2], w[3]);
}


// The per-tap forward's tile: P output pixels of one image x N
// output channels, NT = N / 64 (1, 2 or 4); CH input channels a stage; CW
// consumer warps (P = 32 CW / NT), PT producer threads.
template <typename T, int NT>
struct FwdCfg {
  static constexpr bool kBf16 = !std::is_same<T, float>::value;
  static constexpr int CW = consumer_warps(NT), PT = kWsThreads - 32 * CW;
  // a group's producer threads; a stage is handed over between the
  // consumers and one group
  static constexpr int G = producer_groups(CW, false), GPT = PT / G;
  static constexpr int kHandoff = 32 * CW + GPT;
  static constexpr int P = 32 * CW / NT, N = 64 * NT;
  static constexpr int CH = kBf16 ? 64 : 32;
  // A [P][a_ld] sampled: bf16 rows padded to 16 bytes past 128 (ldmatrix
  // without bank conflicts); f32 rows of 33 floats (the 8 x 8 tiles' column
  // reads fall in 4 distinct banks). B [CH][b_ld]: the W_k chunk.
  static constexpr int a_ld = kBf16 ? CH + 8 : CH + 1;
  static constexpr int b_ld = kBf16 ? N + 8 : N + 4;
  static constexpr int a_bytes = (int)sizeof(T) * P * a_ld;
  static constexpr int stage_bytes = a_bytes + (int)sizeof(T) * CH * b_ld;
  // then the corner tables of two tiles, [tap][pixel]: indices, then weights
  static int smem(int taps) {
    return kWsStages * stage_bytes + 2 * taps * P * (int)(sizeof(int4) + sizeof(float4));
  }
};

// One block per SM, persistent over the tiles (blockIdx.x, + gridDim.x,
// ...: (image, run of P pixels, column tile), the column tile fastest);
// per tile, the corner tables of all taps once, then stages in the
// order taps, then C_in chunks: the old kernel's order of taps, chunks and
// 16-wide products, so that each output is summed in the same order.
template <typename T, int NT>
__global__ void __launch_bounds__(kWsThreads, 1)
deform_conv_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                   const T* __restrict__ mask, const T* __restrict__ weight,
                   const T* __restrict__ bias, T* __restrict__ out, DcnGeom g, bool vec_x,
                   bool vec_w) {
  using C = FwdCfg<T, NT>;
  extern __shared__ __align__(128) unsigned char ws_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = g.kh * g.kw, P = g.Ho * g.Wo;
  const int n_cb = (g.C_out + C::N - 1) / C::N, tpi = (P + C::P - 1) / C::P;
  const long long n_tiles = (long long)g.B * tpi * n_cb;
  const int per_tile = K * ((g.C_in + C::CH - 1) / C::CH);
  const long long my_tiles =
      n_tiles > blockIdx.x ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = my_tiles * per_tile;  // stages this block runs
  auto stage_a = [&](long long it) {
    return reinterpret_cast<T*>(ws_smem + (it % kWsStages) * C::stage_bytes);
  };
  auto stage_b = [&](long long it) {
    return reinterpret_cast<T*>(ws_smem + (it % kWsStages) * C::stage_bytes + C::a_bytes);
  };
  // the corner tables of the block's tile tj: t_idx, t_wt + (tj & 1) K P
  int4* t_idx = reinterpret_cast<int4*>(ws_smem + kWsStages * C::stage_bytes);
  float4* t_wt = reinterpret_cast<float4*>(t_idx + 2 * K * C::P);
  auto build_tables = [&](long long t, int buf, int ctid, int nth) {
    const long long b = t / n_cb / tpi;
    const int p0 = (int)(t / n_cb % tpi) * C::P;
    for (int e = ctid; e < K * C::P; e += nth) {
      const int k = e / C::P, pl = e - k * C::P;
      table_entry<T>(offset, mask, b, p0 + pl, k, g, t_idx[buf * K * C::P + e],
                     t_wt[buf * K * C::P + e]);
    }
  };
  // Where the consumers wait on the gather most of the time (bf16, 8
  // consumer warps), they copy the second operand of each stage and build
  // the next tile's tables; else (4 consumer warps, or FMA consumers in f32)
  // the producers do both (on an H100 each choice 5-10% faster than the
  // other at the neck's shapes on its side).
  constexpr bool kConsumersCopy = C::kBf16 && C::CW == 8;
  if (kConsumersCopy) {  // the first tile's tables, by the whole block
    if (blockIdx.x < n_tiles) build_tables(blockIdx.x, 0, tid, kWsThreads);
    __syncthreads();
  }
  // The second operand of stage it, the W_k chunk of its (tile, tap, chunk),
  // by NTH threads as cp.async copies left in flight.
  const int n_chunks = (g.C_in + C::CH - 1) / C::CH;
  auto copy_w = [&](long long it, int ctid, auto nth) {
    constexpr int NTH = decltype(nth)::value;
    const long long t = blockIdx.x + it / per_tile * gridDim.x;
    const int j = (int)(it % per_tile), k = j / n_chunks, c0 = (j - k * n_chunks) * C::CH;
    producer_copy<T, C::CH, C::N, NTH>(stage_b(it), C::b_ld,
                                       weight + ((long long)k * g.C_in + c0) * g.C_out, g.C_out,
                                       g.C_in - c0, (int)(t % n_cb) * C::N, g.C_out, vec_w, ctid);
  };

  if (warp >= C::CW) {
    // producers: per tile the corner tables, per (tap, chunk) a stage, by
    // the groups in turn
    const int ptid = tid - 32 * C::CW;
    const int grp = ptid / C::GPT, gtid = ptid - grp * C::GPT;
    constexpr int kV = 16 / sizeof(T), kG = 4;
    long long it = 0;
    int tj = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++tj) {
      const T* xb = x + t / n_cb / tpi * g.H * g.W * g.C_in;
      const int buf = kConsumersCopy ? tj & 1 : 0;
      if (kConsumersCopy) {
        if (tj > 0) named_bar_sync(kBarTables, kWsThreads);  // the consumers built them
      } else {
        // every producer is done with the last tile's tables
        if (tj > 0) named_bar_sync(kBarProducers, C::PT);
        build_tables(t, 0, ptid, C::PT);
        named_bar_sync(kBarProducers, C::PT);
      }
      for (int k = 0; k < K; ++k) {
        const int4* k_idx = t_idx + (buf * K + k) * C::P;
        const float4* k_wt = t_wt + (buf * K + k) * C::P;
        for (int c0 = 0; c0 < g.C_in; c0 += C::CH, ++it) {
          if (it % C::G != grp) continue;
          if (it >= kWsStages) named_bar_sync(1 + kWsStages + it % kWsStages, C::kHandoff);
          T* s_a = stage_a(it);
          if (!kConsumersCopy) copy_w(it, gtid, std::integral_constant<int, C::GPT>());
          if (vec_x) {
            // thread's channels fixed (the groups of a row divide the producers)
            constexpr int groups = C::CH / kV, rows = C::GPT / groups;
            static_assert(C::GPT % groups == 0, "a producer's channels must be fixed");
            const int cl = (gtid % groups) * kV;
            const bool c_ok = c0 + cl < g.C_in;
            for (int pl0 = gtid / groups; pl0 < C::P; pl0 += rows * kG) {
              int4 idx[kG];
              float4 wt[kG];
              bool ok[kG];
              T* dst[kG];
#pragma unroll
              for (int j = 0; j < kG; ++j) {
                const int pl = pl0 + j * rows;
                ok[j] = pl < C::P;
                const int pr = ok[j] ? pl : 0;
                idx[j] = c_ok ? k_idx[pr] : make_int4(-1, -1, -1, -1);  // past C_in: zeros
                wt[j] = k_wt[pr];
                dst[j] = s_a + pr * C::a_ld + cl;
              }
              sample_groups<T, kV, kG, C::kBf16>(xb + c0 + cl, idx, wt, ok, dst);
            }
          } else {
            // scalar loads (C_in odd or x unaligned), one sample at a time
            for (int e = gtid; e < C::P * C::CH; e += C::GPT) {
              const int pl = e / C::CH, cl = e - pl * C::CH;
              const bool c_ok = c0 + cl < g.C_in;
              const int4 idx[1] = {c_ok ? k_idx[pl] : make_int4(-1, -1, -1, -1)};
              const float4 wt[1] = {k_wt[pl]};
              const bool ok[1] = {true};
              T* const dst[1] = {s_a + pl * C::a_ld + cl};
              sample_groups<T, 1, 1, false>(xb + (c_ok ? c0 + cl : 0), idx, wt, ok, dst);
            }
          }
          cp_async_wait_all();
          named_bar_arrive(1 + it % kWsStages, C::kHandoff);
        }
      }
    }
  } else {
    // consumers: warp (wm, wn) owns pixels 32 wm.., channels 64 wn.. of the tile
    const int wm = warp / NT, wn = warp % NT;
    using Consumers = std::integral_constant<int, 32 * C::CW>;
    if (kConsumersCopy) {  // the first stages' W chunks, a cp.async group each
      for (int j = 0; j < kWsStages; ++j) {
        if (j < total) copy_w(j, tid, Consumers());
        cp_async_commit();
      }
    }
    long long it = 0;
    int tj = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++tj) {
      const long long b = t / n_cb / tpi;
      const int p0 = (int)(t / n_cb % tpi) * C::P, o0 = (int)(t % n_cb) * C::N;
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      for (int j = 0; j < per_tile; ++j, ++it) {
        named_bar_sync(1 + it % kWsStages, C::kHandoff);
        if (kConsumersCopy && j == 0 && t + gridDim.x < n_tiles) {
          // the producers are done with the last tile (they filled this
          // stage after it): its table buffer takes the next tile's tables
          build_tables(t + gridDim.x, (tj + 1) & 1, tid, Consumers::value);
          named_bar_arrive(kBarTables, kWsThreads);
        }
        if (kConsumersCopy) {
          // this stage's W chunk has landed (the next one may be in flight);
          // the barrier shows every consumer's copies, and that every
          // consumer is done with the last stage, whose W buffer is refilled
          // for kWsStages stages ahead
          cp_async_wait_group<kWsStages - 2>();
          named_bar_sync(kBarConsumers, Consumers::value);
          if (it > 0 && it - 1 + kWsStages < total) copy_w(it - 1 + kWsStages, tid, Consumers());
          cp_async_commit();
        }
        warp_mma_stage<T, false, C::CH>(acc, stage_a(it), C::a_ld, stage_b(it), C::b_ld, 32 * wm,
                                        64 * wn, lane);
        if (it + kWsStages < total) named_bar_arrive(1 + kWsStages + it % kWsStages, C::kHandoff);
      }
      // epilogue: round to T, then + bias in T; pairs of adjacent channels,
      // one store a pair where C_out is even
      T* out_w = out + (b * P + p0 + 32 * wm) * g.C_out + o0 + 64 * wn;
      const bool pairs = (g.C_out & 1) == 0;
#pragma unroll
      for (int e = 0; e < 64; e += 2) {
        int row, col;
        acc_pos<T>(e, lane, row, col);
        const int o = o0 + 64 * wn + col;
        if (p0 + 32 * wm + row >= P || o >= g.C_out) continue;
        const bool second = o + 1 < g.C_out;
        float v0 = round_to<T>(acc[e]), v1 = round_to<T>(acc[e + 1]);
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, to_f32(bias[o]));
          if (second) v1 = __fadd_rn(v1, to_f32(bias[o + 1]));
        }
        T* dst = out_w + row * g.C_out + col;
        if (pairs) {
          store_pair(dst, v0, v1);
        } else {
          dst[0] = from_f32<T>(v0);
          if (second) dst[1] = from_f32<T>(v1);
        }
      }
    }
  }
}

template <typename T, int NT>
int launch_fwd(const T* x, const T* offset, const T* mask, const T* weight, const T* bias, T* out,
               const DcnGeom& g, bool vec_x, bool vec_w, cudaStream_t stream) {
  using C = FwdCfg<T, NT>;
  const int smem = C::smem(g.kh * g.kw);
  if (smem > kWsMaxSmem) return (int)cudaErrorInvalidValue;
  // set on every launch: the opt-in holds for the current device only
  if (const cudaError_t e = cudaFuncSetAttribute(
          deform_conv_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      e != cudaSuccess)
    return (int)e;
  int device = 0, n_sm = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const long long n_tiles = (long long)g.B * ((g.Ho * g.Wo + C::P - 1) / C::P) *
                            ((g.C_out + C::N - 1) / C::N);
  const unsigned grid = (unsigned)(n_tiles < n_sm ? n_tiles : n_sm);
  deform_conv_kernel<T, NT><<<grid, kWsThreads, smem, stream>>>(x, offset, mask, weight, bias, out,
                                                                g, vec_x, vec_w);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask, const void* weight,
           const void* bias, void* out, int B, int H, int W, int C_in, int Ho, int Wo,
           int C_out, int kh, int kw, int stride, int pad, int dil, int off_stride,
           int mask_stride, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C_in <= 0 || Ho <= 0 || Wo <= 0 || C_out <= 0 ||
      kh <= 0 || kw <= 0 || stride <= 0 || dil <= 0 || pad < 0 ||
      off_stride < 2 * kh * kw || mask_stride < kh * kw)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W > (1ll << 31) || (long long)B * Ho * Wo > (1ll << 31) ||
      (long long)H * W * C_in > (1ll << 31))
    return (int)cudaErrorInvalidValue;
  // 16-byte loads where every row of x (C_in) and of W (C_out) starts
  // 16-byte aligned
  constexpr int vec = 16 / sizeof(T);
  const bool vec_x = C_in % vec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = C_out % vec == 0 && reinterpret_cast<uintptr_t>(weight) % 16 == 0;
  const DcnGeom g{B, H, W, C_in, Ho, Wo, C_out, kh, kw, stride, pad, dil, off_stride, mask_stride};
  const T* args[5] = {static_cast<const T*>(x), static_cast<const T*>(offset),
                      static_cast<const T*>(mask), static_cast<const T*>(weight),
                      static_cast<const T*>(bias)};
  T* o = static_cast<T*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  if (C_out <= 64)
    return launch_fwd<T, 1>(args[0], args[1], args[2], args[3], args[4], o, g, vec_x, vec_w, s);
  if (C_out <= 128)
    return launch_fwd<T, 2>(args[0], args[1], args[2], args[3], args[4], o, g, vec_x, vec_w, s);
  return launch_fwd<T, 4>(args[0], args[1], args[2], args[3], args[4], o, g, vec_x, vec_w, s);
}

// ---------------------------------------------------------------------------
// All-taps forward, bf16 (replaces the TPU kernel
// visualdet3d_tpu/ops/deform_conv.py::_lerp_matmul_alltaps_kernel, launched by
// _lerp_matmul_pallas under VD3D_DCN_ALLTAPS=1): the same function as the
// per-tap kernel above. The TPU kernel's point was one pass over a pixel
// tile for every tap and every output channel, with the whole tap weight
// resident; the per-tap kernel above tiles C_out by 64, so at C_out = 256 it
// gathers and lerps every corner four times. Here:
//   * one block per (image, 64 output pixels, up to 256 output channels):
//     the NT = ceil(C_out / 64) <= 4 tiles of 64 channels of a pixel tile
//     accumulate in the same block, in WMMA registers (each warp keeps
//     2 * NT 16x16 f32 fragments: 64 values a thread at NT = 4). Past 256
//     output channels the launch falls back to more blocks, one per 256
//     channels, each gathering the tile again;
//   * per tap, the corner table of the 64 pixels (corner_entry);
//   * per (tap, 64-channel C_in chunk), the sampled [64 x 64] tile gathered
//     and lerped once (gather_tile) and reused by all NT output tiles; the
//     W_k chunk [64 x 64 NT] streams through shared memory beside it;
//   * the per-tap kernel's rounding points and, per output element, its
//     order of taps, C_in chunks and 16-wide MMA steps on the same
//     fragments: the two give the same bits.
// What bounds it is the per-tap kernel's: the tap products. Shared memory:
// 43 KB of staged tiles at NT = 4 (the epilogue reuses it, one output tile
// at a time) and 2 KB of corner table, under the 48 KB of static memory.
// ---------------------------------------------------------------------------

constexpr int kAllTapsMaxTiles = 4;  // 64-channel C_out tiles a block accumulates

template <int NT>
__global__ void __launch_bounds__(kThreads)
deform_conv_alltaps_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ offset,
                           const __nv_bfloat16* __restrict__ mask,
                           const __nv_bfloat16* __restrict__ weight,
                           const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                           int H, int W, int C_in, int Ho, int Wo, int C_out, int kh, int kw,
                           int stride, int pad, int dil, int off_stride, int mask_stride,
                           bool vec_x, bool vec_w) {
  using T = __nv_bfloat16;
  constexpr int a_ld = Tiles<T>::a_ld, chunk = Tiles<T>::chunk, c_ld = Tiles<T>::c_ld;
  constexpr int cols = NT * kTileO, b_ld = cols + 8;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int tile_bytes = (int)sizeof(T) * (kTileP * a_ld + chunk * b_ld);
  constexpr int out_bytes = (int)sizeof(float) * kTileP * c_ld;
  __shared__ __align__(128) unsigned char staging[tile_bytes > out_bytes ? tile_bytes : out_bytes];
  __shared__ int s_idx[4][kTileP];
  __shared__ float s_wt[4][kTileP];
  T* s_a = reinterpret_cast<T*>(staging);  // [kTileP][a_ld] sampled
  T* s_b = s_a + kTileP * a_ld;            // [chunk][b_ld] W_k chunk, NT tiles wide

  const int tid = threadIdx.x, warp = tid / 32;
  const int o0 = blockIdx.x * cols;
  const int p0 = blockIdx.y * kTileP;
  const long long b = blockIdx.z;
  const int P = Ho * Wo;
  const int K = kh * kw;
  const T* xb = x + b * H * W * (long long)C_in;

  // warp owns, in each output tile t, the 16 x 32 block at rows 16*(warp/2),
  // columns 64t + 32*(warp%2): the per-tap kernel's fragments
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> frag_c[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    wmma::fill_fragment(frag_c[t][0], 0.f);
    wmma::fill_fragment(frag_c[t][1], 0.f);
  }
  const int row = 16 * (warp >> 1), col = 32 * (warp & 1);

  for (int k = 0; k < K; ++k) {
    __syncthreads();  // the previous tap's table and tiles are no longer read
    if (tid < kTileP) {
      int idx[4] = {-1, -1, -1, -1};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (p0 + tid < P)
        corner_entry<T>(offset, mask, b * P + p0 + tid, p0 + tid, k, H, W, Wo, kw, stride, pad,
                        dil, off_stride, mask_stride, idx, wt);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_idx[q][tid] = idx[q];
        s_wt[q][tid] = wt[q];
      }
    }
    const T* wk = weight + (long long)k * C_in * C_out;
    for (int c0 = 0; c0 < C_in; c0 += chunk) {
      __syncthreads();  // the corner table written; the previous chunk consumed
      if (vec_x) {
        gather_tile<T, kVec>(xb, C_in, c0, s_idx, s_wt, s_a, tid);
      } else {
        gather_tile<T, 1>(xb, C_in, c0, s_idx, s_wt, s_a, tid);
      }
      if (vec_w) {
        load_weight_tile<T, kVec, cols, b_ld>(wk, C_in, C_out, c0, o0, s_b, tid);
      } else {
        load_weight_tile<T, 1, cols, b_ld>(wk, C_in, C_out, c0, o0, s_b, tid);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < chunk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, s_a + row * a_ld + kk, a_ld);
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::load_matrix_sync(fb, s_b + kk * b_ld + kTileO * t + col + 16 * j, b_ld);
            wmma::mma_sync(frag_c[t][j], fa, fb, frag_c[t][j]);
          }
      }
    }
  }

  // epilogue, one output tile at a time through shared memory: round to
  // bf16, then + bias in bf16
  float* s_c = reinterpret_cast<float*>(staging);  // [kTileP][c_ld]
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    __syncthreads();  // the last chunk's tiles, or the previous output tile, are consumed
    wmma::store_matrix_sync(s_c + row * c_ld + col, frag_c[t][0], c_ld, wmma::mem_row_major);
    wmma::store_matrix_sync(s_c + row * c_ld + col + 16, frag_c[t][1], c_ld, wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < kTileP * kTileO; e += kThreads) {
      const int pl = e / kTileO, ol = e - pl * kTileO;
      const int p = p0 + pl, o = o0 + kTileO * t + ol;
      if (p >= P || o >= C_out) continue;
      float v = round_to<T>(s_c[pl * c_ld + ol]);
      if (bias != nullptr) v = __fadd_rn(v, to_f32(bias[o]));
      out[(b * P + p) * C_out + o] = from_f32<T>(v);
    }
  }
}

int launch_alltaps(const void* x, const void* offset, const void* mask, const void* weight,
                   const void* bias, void* out, int B, int H, int W, int C_in, int Ho, int Wo,
                   int C_out, int kh, int kw, int stride, int pad, int dil, int off_stride,
                   int mask_stride, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C_in <= 0 || Ho <= 0 || Wo <= 0 || C_out <= 0 ||
      kh <= 0 || kw <= 0 || stride <= 0 || dil <= 0 || pad < 0 ||
      off_stride < 2 * kh * kw || mask_stride < kh * kw)
    return (int)cudaErrorInvalidValue;
  const long long P = (long long)Ho * Wo;
  const int tiles = (C_out + kTileO - 1) / kTileO;
  const int nt = tiles < kAllTapsMaxTiles ? tiles : kAllTapsMaxTiles;
  const dim3 grid((C_out + nt * kTileO - 1) / (nt * kTileO), (unsigned)((P + kTileP - 1) / kTileP),
                  B);
  if (grid.y > 65535 || grid.z > 65535 || (long long)H * W * C_in > (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const bool vec_x = C_in % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = C_out % 8 == 0 && reinterpret_cast<uintptr_t>(weight) % 16 == 0;
  using T = __nv_bfloat16;
#define VD3D_ALLTAPS_LAUNCH(NT_)                                                             \
  deform_conv_alltaps_kernel<NT_><<<grid, kThreads, 0, (cudaStream_t)stream>>>(             \
      static_cast<const T*>(x), static_cast<const T*>(offset), static_cast<const T*>(mask), \
      static_cast<const T*>(weight), static_cast<const T*>(bias), static_cast<T*>(out), H, W, \
      C_in, Ho, Wo, C_out, kh, kw, stride, pad, dil, off_stride, mask_stride, vec_x, vec_w)
  switch (nt) {
    case 1: VD3D_ALLTAPS_LAUNCH(1); break;
    case 2: VD3D_ALLTAPS_LAUNCH(2); break;
    case 3: VD3D_ALLTAPS_LAUNCH(3); break;
    default: VD3D_ALLTAPS_LAUNCH(4); break;
  }
#undef VD3D_ALLTAPS_LAUNCH
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Lerp-accumulate over the pre-multiplied table, bf16 (replaces the TPU
// kernel visualdet3d_tpu/ops/deform_conv.py::_lerp_accum_kernel, launched by
// _premul_conv_impl under VD3D_DCN_PREMUL=1, with the XLA gather and the u32
// row-pair packing and per-tap transpose before it):
//
//   out[b,p,:] = bias + sum_k bilinear_zero(Y[b,:,:,k,:], base_p + tap_k*dil + off[b,p,k])
//                              * mask[b,p,k]            (Y = x @ W_k, [B,H,W,K,C_out])
//
// the bilinear sample of each tap's C_out slice of Y, in f32, summed over
// the taps in f32 in tap order, rounded once to bf16, then + bias in bf16
// (the sampled value is not rounded: the TPU kernel accumulates it in f32).
// Y comes from one matmul in the wrapper ([B*H*W, C_in] x [C_in, K*C_out]);
// its [B, H*W, K*C_out] layout needs no transpose: tap k of a corner pixel
// is a contiguous C_out slice.
//
// What bounds it: bytes. There is no product, only four corners lerped per
// (pixel, tap, channel): Y read once (plus offsets, mask and the output)
// over the memory rate; each Y element is read by up to four neighbouring
// samples a tap, from L2. The design, simple first:
//   * one block per (image, 32 output pixels), 256 threads;
//   * the corner tables of all K taps of the block's pixels built once
//     (corner_entry, as the other kernels) in dynamic shared memory
//     (K * 32 * 32 bytes: 9 KB at K = 9);
//   * each thread takes (pixel, 16 bytes = 8 channels of C_out; scalar where
//     C_out % 8 != 0 or Y is not 16-byte aligned), keeps 8 f32 accumulators
//     in registers across the K taps, reads the four corners of each tap as
//     16-byte loads and lerps them with the explicitly rounded products and
//     sums of the other kernels (__fmul_rn/__fadd_rn), so that it equals its
//     plain version bit for bit.
// ---------------------------------------------------------------------------

constexpr int kPremulTileP = 32;  // output pixels per block

template <int V>
__global__ void __launch_bounds__(kThreads)
premul_lerp_accum_kernel(const __nv_bfloat16* __restrict__ y,
                         const __nv_bfloat16* __restrict__ offset,
                         const __nv_bfloat16* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                         int H, int W, int Ho, int Wo, int C_out, int kh, int kw, int stride,
                         int pad, int dil, int off_stride, int mask_stride) {
  using T = __nv_bfloat16;
  constexpr int tp = kPremulTileP;
  extern __shared__ __align__(16) unsigned char premul_smem[];
  const int K = kh * kw;
  int* s_idx = reinterpret_cast<int*>(premul_smem);  // [K][4][tp]
  float* s_wt = reinterpret_cast<float*>(s_idx + K * 4 * tp);  // [K][4][tp]

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * tp;
  const long long b = blockIdx.y;
  const int P = Ho * Wo;
  const long long row = (long long)K * C_out;  // one pixel of Y
  const T* yb = y + b * H * W * row;

  for (int e = tid; e < K * tp; e += kThreads) {
    const int k = e / tp, pl = e - k * tp;
    int idx[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (p0 + pl < P)
      corner_entry<T>(offset, mask, b * P + p0 + pl, p0 + pl, k, H, W, Wo, kw, stride, pad, dil,
                      off_stride, mask_stride, idx, wt);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s_idx[(k * 4 + q) * tp + pl] = idx[q];
      s_wt[(k * 4 + q) * tp + pl] = wt[q];
    }
  }
  __syncthreads();

  const int groups = (C_out + V - 1) / V;  // with V > 1, C_out % V == 0
  for (int e = tid; e < tp * groups; e += kThreads) {
    const int pl = e / groups, c = (e - pl * groups) * V;
    const int p = p0 + pl;
    if (p >= P) continue;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float corner[4][V];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = s_idx[(k * 4 + q) * tp + pl];
        if (idx >= 0) {
          load_vals<T, V>(yb + idx * row + (long long)k * C_out + c, corner[q]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) corner[q][j] = 0.f;
        }
      }
      const float wx0 = s_wt[(k * 4 + 0) * tp + pl], wx1 = s_wt[(k * 4 + 1) * tp + pl];
      const float wy0 = s_wt[(k * 4 + 2) * tp + pl], wy1 = s_wt[(k * 4 + 3) * tp + pl];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float vx0 = __fadd_rn(__fmul_rn(corner[0][j], wy0), __fmul_rn(corner[2][j], wy1));
        const float vx1 = __fadd_rn(__fmul_rn(corner[1][j], wy0), __fmul_rn(corner[3][j], wy1));
        acc[j] = __fadd_rn(acc[j], __fadd_rn(__fmul_rn(vx0, wx0), __fmul_rn(vx1, wx1)));
      }
    }
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j] = round_to<T>(acc[j]);
      if (bias != nullptr) v[j] = __fadd_rn(v[j], to_f32(bias[c + j]));
    }
    store_vals<T, V>(out + (b * P + p) * (long long)C_out + c, v);
  }
}

int launch_premul(const void* y, const void* offset, const void* mask, const void* bias,
                  void* out, int B, int H, int W, int Ho, int Wo, int C_out, int kh, int kw,
                  int stride, int pad, int dil, int off_stride, int mask_stride, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || C_out <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || dil <= 0 || pad < 0 || off_stride < 2 * kh * kw || mask_stride < kh * kw)
    return (int)cudaErrorInvalidValue;
  const long long P = (long long)Ho * Wo;
  const int smem = kh * kw * kPremulTileP * 8 * (int)sizeof(int);
  const long long tiles = (P + kPremulTileP - 1) / kPremulTileP;
  if (smem > 48 * 1024 || tiles > 2147483647ll || B > 65535 ||
      (long long)H * W * kh * kw * C_out > (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, B);
  // 16-byte loads and stores where every C_out slice of Y and every output
  // row starts 16-byte aligned
  const bool vec = C_out % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  using T = __nv_bfloat16;
  if (vec) {
    premul_lerp_accum_kernel<8><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(y), static_cast<const T*>(offset), static_cast<const T*>(mask),
        static_cast<const T*>(bias), static_cast<T*>(out), H, W, Ho, Wo, C_out, kh, kw, stride,
        pad, dil, off_stride, mask_stride);
  } else {
    premul_lerp_accum_kernel<1><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(y), static_cast<const T*>(offset), static_cast<const T*>(mask),
        static_cast<const T*>(bias), static_cast<T*>(out), H, W, Ho, Wo, C_out, kh, kw, stride,
        pad, dil, off_stride, mask_stride);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward (replaces the TPU kernel _lerp_matmul_bwd_kernel, launched by
// _packed_conv_bwd, with the XLA gather before it and the bf16 row scatter
// after it). With ds = dy . W_k^T (f32 accumulate of T products), per output
// pixel p, tap k and input channel c:
//   dW_k[c,:]  += sampled[p,k,c] * dy[p,:]           (kernel B, below)
//   dvx0 = ds*(1-fx), dvx1 = ds*fx                    (kernel A)
//   d(1-fx) += ds*vx0, d(fx) += ds*vx1,
//   d((1-fy)m) += dvx0*v00 + dvx1*v01, d(fy m) += dvx0*v10 + dvx1*v11,
//   dx[corner] += dvx * (1-fy)m or dvx * fy m        (f32 atomics)
// The four lerp-weight gradients go out per (pixel, tap) in f32; the wrapper
// carries them to d_offset and d_mask through the same torch ops that form
// the weights in the plain version. sampled is recomputed exactly as the
// forward rounds it (bf16 in the bf16 kernel), so dW is the exact vjp of
// what the forward multiplied; ds stays f32, as in the TPU kernel.
//
// What bounds it: twice the forward's products (ds and dW), the gather of
// the four corners of x for every (pixel, tap, channel), as in the forward,
// and the dx scatter, 4 corners x K taps x C_in adds per output pixel (10.33
// G a KM3D training step at batch 16). Most of the four corners of the nine
// taps of neighbouring pixels fall on the same few input pixels. The TPU
// kernel's u32 packing, taps-outer grid with a dW block revisited across
// pixel steps, and its VMEM fallback answered TPU costs; none is kept.
//   * kernel A (dx and the lerp-weight gradients): in bf16, one block per
//     (image, 2-D tile of 64 output pixels) sums each corner's gradients
//     for a 16-channel chunk of C_in in a shared-memory window of the input
//     pixels that the tile's taps reach with offsets up to +-R, and adds the
//     window into dx once; in f32 the row design, which adds every corner
//     into dx itself, is the faster; both are described before their kernels
//     below;
//   * kernel B (dW), on the forward's warp-specialised design: a block per
//     (tile of (tap, C_in) rows x output channels, split of the batch's
//     pixels) gathers each sampled tile once for all its output channels
//     and accumulates sampled^T . dy; the splits' f32 partial sums are
//     added by a second kernel in split order (no atomics), after the dx
//     kernel's section.
// dx is an f32 buffer the wrapper zeroes and rounds once; dW is f32, rounded
// by the wrapper.
// ---------------------------------------------------------------------------

constexpr int kTileC = 64;  // input channels per backward tile
constexpr int kDsLd = kTileC + 4;

template <typename T> struct BwdTiles;
template <> struct BwdTiles<float> {
  static constexpr int o_chunk = 32;        // C_out per step of the ds product
  static constexpr int dy_ld = o_chunk + 1;  // s_dy [kTileP][dy_ld]
  static constexpr int w_rows = o_chunk;     // s_w = W_k^T chunk [o_chunk][w_ld]
  static constexpr int w_ld = kTileC + 4;
};
template <> struct BwdTiles<__nv_bfloat16> {
  static constexpr int o_chunk = 64;
  static constexpr int dy_ld = o_chunk + 8;  // row_major A
  static constexpr int w_rows = kTileC;      // s_w = W_k chunk [kTileC][w_ld], col_major B
  static constexpr int w_ld = o_chunk + 8;
};

// dst[r][cc] = src[r * ld_src + col0 + cc] for r < rows_valid and
// col0 + cc < cols, else 0: R rows x C columns, V columns a thread at a time
// (cols % V == 0 and 16-byte aligned rows when V > 1).
template <typename T, int V, int R, int C, int DST_LD>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, long long ld_src,
                                           long long rows_valid, int col0, int cols, T* dst,
                                           int tid) {
  constexpr int groups = C / V;
  for (int e = tid; e < R * groups; e += kThreads) {
    const int r = e / groups, cc = (e - r * groups) * V;
    float v[V];
    if (r < rows_valid && col0 + cc < cols) {
      load_vals<T, V>(src + r * ld_src + col0 + cc, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
    if constexpr ((DST_LD * sizeof(T)) % 16 == 0) {
      store_vals<T, V>(dst + r * DST_LD + cc, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[r * DST_LD + cc + j] = from_f32<T>(v[j]);
    }
  }
}

template <int V>
__device__ __forceinline__ void atomic_add_vals(float* p, const float (&v)[V]) {
#if __CUDA_ARCH__ >= 900
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      atomicAdd(reinterpret_cast<float4*>(p + j), make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]));
    return;
  }
#endif
#pragma unroll
  for (int j = 0; j < V; ++j) atomicAdd(p + j, v[j]);
}

// ---------------------------------------------------------------------------
// The dx pass in f32: a block per (image, run of 64 output pixels along the
// rows); per tap the corner table, per 64-channel chunk of C_in the ds tile
// [64 x 64] (4x4 FMA a thread) from staged dy and W_k tiles, then each
// thread takes (pixel, 4 channels), gathers the four corners, adds into dx
// with float4 atomics in device memory and sums the four weight gradients
// over the pixel's lanes. In f32 this row design beats the window design
// below (on an H100, 29 against 59-65 ms over a KM3D training step's 16
// DCNs: the window design's f32 ds products and its shared memory, one
// block an SM at most shapes, cost more than the device atomics it saves).
// ---------------------------------------------------------------------------

// Its elementwise stage for channels c0.. of one tap: dx atomics and the
// per-pixel sums of the four lerp-weight gradients (into s_dwts). With V > 1
// the caller guarantees C_in % V == 0.
template <typename T, int V>
__device__ __forceinline__ void bwd_scatter_tile(const T* __restrict__ xb, float* __restrict__ dxb,
                                                 int C_in, int c0, const int (&s_idx)[4][kTileP],
                                                 const float (&s_wt)[4][kTileP],
                                                 const float* s_ds, float (&s_dwts)[4][kTileP],
                                                 int tid) {
  constexpr int groups = kTileC / V;
  constexpr int lanes = groups < 32 ? groups : 32;  // adjacent lanes of one pixel
  // kTileP * groups is a multiple of kThreads: every lane reaches the shuffles
  for (int e = tid; e < kTileP * groups; e += kThreads) {
    const int pl = e / groups, cl = (e - pl * groups) * V;
    const int c = c0 + cl;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    if (c < C_in) {
      int idx[4];
      float corner[4][V];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        idx[q] = s_idx[q][pl];
        if (idx[q] >= 0) {
          load_vals<T, V>(xb + (long long)idx[q] * C_in + c, corner[q]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) corner[q][j] = 0.f;
        }
      }
      const float wx0 = s_wt[0][pl], wx1 = s_wt[1][pl];
      const float wy0 = s_wt[2][pl], wy1 = s_wt[3][pl];
      float d[4][V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float ds = s_ds[pl * kDsLd + cl + j];
        const float vx0 = __fadd_rn(__fmul_rn(corner[0][j], wy0), __fmul_rn(corner[2][j], wy1));
        const float vx1 = __fadd_rn(__fmul_rn(corner[1][j], wy0), __fmul_rn(corner[3][j], wy1));
        const float dvx0 = ds * wx0, dvx1 = ds * wx1;
        sum[0] += ds * vx0;
        sum[1] += ds * vx1;
        sum[2] += dvx0 * corner[0][j] + dvx1 * corner[1][j];
        sum[3] += dvx0 * corner[2][j] + dvx1 * corner[3][j];
        d[0][j] = dvx0 * wy0;
        d[1][j] = dvx1 * wy0;
        d[2][j] = dvx0 * wy1;
        d[3][j] = dvx1 * wy1;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (idx[q] >= 0) atomic_add_vals<V>(dxb + (long long)idx[q] * C_in + c, d[q]);
    }
#pragma unroll
    for (int s = lanes / 2; s > 0; s >>= 1)
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], s);
    if ((tid & (lanes - 1)) == 0)
#pragma unroll
      for (int q = 0; q < 4; ++q) atomicAdd(&s_dwts[q][pl], sum[q]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_conv_bwd_input_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                             const T* __restrict__ mask, const T* __restrict__ weight,
                             const T* __restrict__ dy, float* __restrict__ dx,
                             float* __restrict__ dwts, int H, int W, int C_in, int Ho, int Wo,
                             int C_out, int kh, int kw, int stride, int pad, int dil,
                             int off_stride, int mask_stride, bool vec_x, bool vec_o) {
  using BT = BwdTiles<T>;
  constexpr int oc = BT::o_chunk, dy_ld = BT::dy_ld, w_ld = BT::w_ld;
  constexpr int kVec = 16 / sizeof(T);
  __shared__ __align__(128) T s_dy[kTileP * dy_ld];
  __shared__ __align__(128) T s_w[BT::w_rows * w_ld];
  __shared__ __align__(128) float s_ds[kTileP * kDsLd];
  __shared__ int s_idx[4][kTileP];
  __shared__ float s_wt[4][kTileP];
  __shared__ float s_dwts[4][kTileP];

  const int tid = threadIdx.x, warp = tid / 32;
  const int p0 = blockIdx.x * kTileP;
  const long long b = blockIdx.y;
  const int P = Ho * Wo;
  const int K = kh * kw;
  const int n_rows = min(kTileP, P - p0);
  const T* xb = x + b * H * W * (long long)C_in;
  float* dxb = dx + b * H * W * (long long)C_in;
  const T* dyb = dy + (b * P + p0) * (long long)C_out;  // rows p0.. of this image

  using namespace nvcuda;
  float acc[4][4];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> frag_c[2];

  for (int k = 0; k < K; ++k) {
    __syncthreads();  // the previous tap's tables and sums are no longer read
    if (tid < kTileP) {
      int idx[4] = {-1, -1, -1, -1};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (tid < n_rows)
        corner_entry<T>(offset, mask, b * P + p0 + tid, p0 + tid, k, H, W, Wo, kw, stride, pad,
                        dil, off_stride, mask_stride, idx, wt);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_idx[q][tid] = idx[q];
        s_wt[q][tid] = wt[q];
        s_dwts[q][tid] = 0.f;
      }
    }
    const T* wk = weight + (long long)k * C_in * C_out;

    for (int c0 = 0; c0 < C_in; c0 += kTileC) {
      // ds [kTileP x kTileC] = dy [kTileP x C_out] . W_k[c0.., :]^T
      if constexpr (std::is_same<T, float>::value) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      } else {
        wmma::fill_fragment(frag_c[0], 0.f);
        wmma::fill_fragment(frag_c[1], 0.f);
      }
      for (int o0 = 0; o0 < C_out; o0 += oc) {
        __syncthreads();  // the previous step's tiles, and s_ds, are consumed
        if (vec_o) {
          stage_tile<T, kVec, kTileP, oc, dy_ld>(dyb, C_out, n_rows, o0, C_out, s_dy, tid);
        } else {
          stage_tile<T, 1, kTileP, oc, dy_ld>(dyb, C_out, n_rows, o0, C_out, s_dy, tid);
        }
        if constexpr (std::is_same<T, float>::value) {
          // W_k^T chunk: s_w[o][c] (consecutive threads read consecutive o)
          for (int e = tid; e < kTileC * oc; e += kThreads) {
            const int cl = e / oc, ol = e - cl * oc;
            const int c = c0 + cl, o = o0 + ol;
            s_w[ol * w_ld + cl] = (c < C_in && o < C_out) ? wk[(long long)c * C_out + o] : 0.f;
          }
        } else if (vec_o) {
          stage_tile<T, kVec, kTileC, oc, w_ld>(wk + (long long)c0 * C_out, C_out, C_in - c0,
                                                o0, C_out, s_w, tid);
        } else {
          stage_tile<T, 1, kTileC, oc, w_ld>(wk + (long long)c0 * C_out, C_out, C_in - c0, o0,
                                             C_out, s_w, tid);
        }
        __syncthreads();
        if constexpr (std::is_same<T, float>::value) {
          // thread owns pixels ty + 16i and channels 4tx + j
          const int tx = tid & 15, ty = tid >> 4;
#pragma unroll 4
          for (int ol = 0; ol < oc; ++ol) {
            const float4 bv = *reinterpret_cast<const float4*>(s_w + ol * w_ld + 4 * tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float av = s_dy[(ty + 16 * i) * dy_ld + ol];
              acc[i][0] = fmaf(av, bv.x, acc[i][0]);
              acc[i][1] = fmaf(av, bv.y, acc[i][1]);
              acc[i][2] = fmaf(av, bv.z, acc[i][2]);
              acc[i][3] = fmaf(av, bv.w, acc[i][3]);
            }
          }
        } else {
          // warp owns the 16 x 32 tile at pixels 16*(warp/2), channels 32*(warp%2)
          const int row = 16 * (warp >> 1), col = 32 * (warp & 1);
#pragma unroll
          for (int kk = 0; kk < oc; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
            wmma::load_matrix_sync(fa, s_dy + row * dy_ld + kk, dy_ld);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              wmma::load_matrix_sync(fb, s_w + (col + 16 * j) * w_ld + kk, w_ld);
              wmma::mma_sync(frag_c[j], fa, fb, frag_c[j]);
            }
          }
        }
      }
      if constexpr (std::is_same<T, float>::value) {
        const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(s_ds + (ty + 16 * i) * kDsLd + 4 * tx) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        const int row = 16 * (warp >> 1), col = 32 * (warp & 1);
        wmma::store_matrix_sync(s_ds + row * kDsLd + col, frag_c[0], kDsLd, wmma::mem_row_major);
        wmma::store_matrix_sync(s_ds + row * kDsLd + col + 16, frag_c[1], kDsLd,
                                wmma::mem_row_major);
      }
      __syncthreads();
      if (vec_x) {
        bwd_scatter_tile<T, kVec>(xb, dxb, C_in, c0, s_idx, s_wt, s_ds, s_dwts, tid);
      } else {
        bwd_scatter_tile<T, 1>(xb, dxb, C_in, c0, s_idx, s_wt, s_ds, s_dwts, tid);
      }
    }
    __syncthreads();
    if (tid < n_rows) {
      float4 v = make_float4(s_dwts[0][tid], s_dwts[1][tid], s_dwts[2][tid], s_dwts[3][tid]);
      *reinterpret_cast<float4*>(dwts + ((b * P + p0 + tid) * K + k) * 4) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// The dx pass in bf16 on a shared-memory window.
//
// A block owns a 2-D tile of 64 output pixels (8x8, or 4x16 where that
// covers the map with fewer tiles) of one image. The input pixels that the
// tile's taps reach with offsets up to +-R (the plan in ops/deform_conv.py,
// dx_plan, passes R) form a window of
//   win_h = (tile_h - 1) * stride + (kh - 1) * dil + 2R + 2
// rows (and as many columns). Once per block, every corner of every (pixel,
// tap) that lands inside the image is put in the bucket of its window cell,
// or in the spill bucket when it lies outside the window (an offset beyond
// +-R): a counting sort in shared memory with integer atomics. Then per
// chunk of 16 input channels:
//   * the chunk's channels of x over the window, and the W_k chunks of as
//     many taps as shared memory holds with two blocks an SM, arrive by
//     cp.async (all copies of a round in flight at once);
//   * ds_k = dy . W_k^T [64 x 16] for every tap k, two taps at a time on the
//     two halves of the block (WMMA), from the dy tile staged once per
//     block, kept in shared memory for all taps (f32);
//   * the four lerp-weight gradients: a thread per (tap, pixel) reads the
//     four corners from the window (from x for a corner outside it) and sums
//     over the chunk into per-(tap, pixel) sums that live in shared memory
//     across chunks and are written once;
//   * dx: a thread per window cell adds the gradients of the corners in the
//     cell's bucket in registers, 16 channels, then adds them into dx with
//     float4 atomics (halos overlap the neighbouring blocks' windows); cells
//     no corner reached are skipped; the spilled corners go to dx with
//     float4 atomics each.
// No float atomic touches shared memory. The sums are the same terms as the
// plain version's in another order. On an H100 at the KM3D neck's shapes
// this moves 5.7x fewer adds into device memory than the row design and
// runs a little faster than it in bf16; in f32 the row design above is
// faster and runs instead. What bounds it is latency: 16 warps an SM
// (shared memory and 123 registers a thread) wait on cp.async copies,
// barriers and shared-memory reads in every phase.
// ---------------------------------------------------------------------------

constexpr int kDxChunk = 16;           // input channels per chunk
constexpr int kDxDsLd = kDxChunk + 4;  // row of the ds tiles, floats
constexpr int kDxMaxOut = 256;         // output channels of dy staged at once
constexpr int kDxPixels = 64;          // output pixels per block
// shared memory of a block for two an SM: (228 KB less 1 KB a block) / 2
constexpr int kDxSmemTarget = (228 * 1024 - 2 * 1024) / 2;
constexpr int kDxMaxTaps = 9;          // taps of one round
constexpr int kPackNone = -1;

struct DxGeom {
  int tile_h, tile_w, tiles_x, radius, win_h, win_w, oc_max, dy_ld, w_ld, w_buf, n_oc, taps;
  int off_ds, off_dy, off_w, off_x, off_pack, off_wt, off_dwts, off_cnt, off_first, off_ent,
      smem;
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory of the dx kernel: ds of all taps, the dy tile, the chunk's
// channels of x over the window, the W_k chunks of the taps of one round (as many as keep the block within
// kDxSmemTarget, or within twice that where the rest alone exceeds it; at
// least 1, at most kDxMaxTaps), per (tap, pixel) the
// corner origin, the four lerp weights and their gradient sums, and the
// corner buckets.
template <typename T>
DxGeom dx_geometry(int Ho, int Wo, int C_out, int K, int kh, int kw, int stride, int dil,
                   int tile_w, int radius) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the window kernel is bf16");
  DxGeom g;
  g.tile_w = tile_w;
  g.tile_h = kDxPixels / tile_w;
  g.tiles_x = (Wo + tile_w - 1) / tile_w;
  g.radius = radius;
  g.win_h = radius < 0 ? 0 : (g.tile_h - 1) * stride + (kh - 1) * dil + 2 * radius + 2;
  g.win_w = radius < 0 ? 0 : (g.tile_w - 1) * stride + (kw - 1) * dil + 2 * radius + 2;
  g.oc_max = round_up(C_out, 16) < kDxMaxOut ? round_up(C_out, 16) : kDxMaxOut;
  g.n_oc = (C_out + g.oc_max - 1) / g.oc_max;
  g.dy_ld = g.oc_max + 8;
  g.w_ld = g.oc_max + 8;           // W_k [chunk][oc]
  g.w_buf = kDxChunk * g.w_ld;     // elements of one tap's chunk
  const int buckets = g.win_h * g.win_w + 1;       // the cells, then the spill
  for (int pass = 0; pass < 2; ++pass) {  // the layout without W, then with its taps
    int off = 0;
    g.off_ds = off;
    off = round_up(off + (int)sizeof(float) * K * kDxPixels * kDxDsLd, 128);
    g.off_dy = off;
    off = round_up(off + (int)sizeof(T) * kDxPixels * g.dy_ld, 128);
    g.off_x = off;  // the chunk's channels of x over the window
    off = round_up(off + (int)sizeof(T) * g.win_h * g.win_w * kDxChunk, 128);
    g.off_pack = off;
    off = round_up(off + (int)sizeof(int) * K * kDxPixels, 128);
    g.off_wt = off;
    off = round_up(off + (int)sizeof(float) * K * 4 * kDxPixels, 128);
    g.off_dwts = off;
    off = round_up(off + (int)sizeof(float) * K * 4 * kDxPixels, 128);
    g.off_cnt = off;
    off = round_up(off + (int)sizeof(int) * buckets, 128);
    g.off_first = off;
    off = round_up(off + (int)sizeof(int) * (buckets + 1), 128);
    g.off_ent = off;
    off = round_up(off + (int)sizeof(short) * K * kDxPixels * 4, 128);
    if (pass == 0) {
      // where not even one tap keeps two blocks an SM, fill one block's share
      const int per_tap = (int)sizeof(T) * g.w_buf;
      g.taps = (kDxSmemTarget - off - 128) / per_tap;
      if (g.taps < 1) g.taps = (2 * kDxSmemTarget - off - 128) / per_tap;
      const int most = K < kDxMaxTaps ? K : kDxMaxTaps;
      g.taps = g.taps < 1 ? 1 : (g.taps > most ? most : g.taps);
    } else {
      g.off_w = off;
      g.smem = round_up(off + (int)sizeof(T) * g.taps * g.w_buf, 128);
    }
  }
  return g;
}

// Rows of the dy tile: output channels o0 .. o0 + oc_max of the block's
// pixels (zero outside the map and past C_out), V channels a thread at a
// time (C_out % V == 0 when V > 1).
template <typename T, int V>
__device__ __forceinline__ void stage_dy(const T* __restrict__ dyb, int C_out, int Wo, int Ho,
                                         int oy0, int ox0, const DxGeom& g, int o0, T* s_dy,
                                         int tid) {
  const int groups = g.oc_max / V;
  for (int e = tid; e < kDxPixels * groups; e += kThreads) {
    const int pl = e / groups, ol = (e - pl * groups) * V;
    const int oy = oy0 + pl / g.tile_w, ox = ox0 + pl % g.tile_w, o = o0 + ol;
    float v[V];
    if (oy < Ho && ox < Wo && o < C_out) {
      load_vals<T, V>(dyb + ((long long)oy * Wo + ox) * C_out + o, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
    store_vals<T, V>(s_dy + pl * g.dy_ld + ol, v);
  }
}

// V consecutive values of shared memory as f32 (one 16-byte load when V =
// 16 / sizeof(T)).
template <typename T, int V>
__device__ __forceinline__ void load_shared_vals(const T* p, float (&out)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f32(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f32(p[j]);
  }
}

// stage_w's copies issued as cp.async and left in flight, 16 bytes a copy
// (C_out % 8 == 0, 16-byte aligned rows).
template <typename T>
__device__ __forceinline__ void stage_w_async(const T* __restrict__ wk, int C_in, int C_out,
                                              int c0, int o0, const DxGeom& g, T* s_w, int tid) {
  const int groups = g.oc_max / 8;
  for (int e = tid; e < kDxChunk * groups; e += kThreads) {
    const int cl = e / groups, ol = (e - cl * groups) * 8;
    const int c = c0 + cl, o = o0 + ol;
    const bool ok = c < C_in && o < C_out;
    cp_async<16>(s_w + cl * g.w_ld + ol, ok ? wk + (long long)c * C_out + o : wk, ok);
  }
}

// The chunk's channels c0.. of x over the window (zero outside the image and
// past C_in), as cp.async left in flight: [cell][chunk], 16 bytes a copy
// (C_in % (16 / sizeof(T)) == 0, 16-byte aligned x).
template <typename T>
__device__ __forceinline__ void stage_x_async(const T* __restrict__ xb, int H, int W, int C_in,
                                              int c0, int org_y, int org_x, const DxGeom& g,
                                              T* s_x, int tid) {
  constexpr int kC = kDxChunk, kV = 16 / (int)sizeof(T), kPieces = kC / kV;
  for (int e = tid; e < g.win_h * g.win_w * kPieces; e += kThreads) {
    const int cell = e / kPieces, cl = (e - cell * kPieces) * kV;
    const int y = org_y + cell / g.win_w, x = org_x + cell % g.win_w, c = c0 + cl;
    const bool ok = y >= 0 && y < H && x >= 0 && x < W && c < C_in;
    cp_async<16>(s_x + cell * kC + cl, ok ? xb + ((long long)y * W + x) * C_in + c : xb, ok);
  }
}

// The W_k chunk of input channels c0.. and output channels o0.. (zero
// outside C_in x C_out) as [chunk][oc], a col-major B of ds = dy . W^T, V
// columns a thread at a time (C_out % V == 0 when V > 1).
template <typename T, int V>
__device__ __forceinline__ void stage_w(const T* __restrict__ wk, int C_in, int C_out, int c0,
                                        int o0, const DxGeom& g, T* s_w, int tid) {
  const int groups = g.oc_max / V;
  for (int e = tid; e < kDxChunk * groups; e += kThreads) {
    const int cl = e / groups, ol = (e - cl * groups) * V;
    const int c = c0 + cl, o = o0 + ol;
    float v[V];
    if (c < C_in && o < C_out) {
      load_vals<T, V>(wk + (long long)c * C_out + o, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
    store_vals<T, V>(s_w + cl * g.w_ld + ol, v);
  }
}

// The four lerp-weight gradient sums of channels c0.. (one chunk) for every
// (tap, pixel), one thread each: the four corners of x come from the chunk's
// window (s_x, when given and the corner lies in it) or from x, V channels a
// load. With V > 1 the caller guarantees C_in % V == 0 and 16-byte aligned
// rows.
template <typename T, int V>
__device__ __forceinline__ void dx_weight_grads(const T* __restrict__ xb, int H, int W, int C_in,
                                                int c0, int K, const int* s_pack,
                                                const float* s_wt, const float* s_ds,
                                                float* s_dwts, const T* s_x, int org_y,
                                                int org_x, const DxGeom& g, int tid) {
  for (int kp = tid; kp < K * kDxPixels; kp += kThreads) {  // kp = k * kDxPixels + pl
    const int pack = s_pack[kp];
    if (pack == kPackNone) continue;
    const int k = kp / kDxPixels, pl = kp - k * kDxPixels;
    const int y0 = (pack >> 16) - 2, x0 = (pack & 0xffff) - 2;
    const float* wt = s_wt + k * 4 * kDxPixels + pl;
    const float wx0 = wt[0], wx1 = wt[kDxPixels];
    const float wy0 = wt[2 * kDxPixels], wy1 = wt[3 * kDxPixels];
    // where each corner's channels come from: the window, x, or nowhere (0)
    const T* src[4];
    bool shared[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int y = y0 + (q >> 1), x = x0 + (q & 1);
      const int ry = y - org_y, rx = x - org_x;
      shared[q] = s_x != nullptr && ry >= 0 && ry < g.win_h && rx >= 0 && rx < g.win_w;
      src[q] = shared[q] ? s_x + (ry * g.win_w + rx) * kDxChunk
               : (y >= 0 && y < H && x >= 0 && x < W) ? xb + ((long long)y * W + x) * C_in + c0
                                                      : nullptr;
    }
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int cl = 0; cl < kDxChunk; cl += V) {
      if (c0 + cl >= C_in) break;
      float corner[4][V];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (src[q] == nullptr) {
#pragma unroll
          for (int j = 0; j < V; ++j) corner[q][j] = 0.f;
        } else if (shared[q]) {
          load_shared_vals<T, V>(src[q] + cl, corner[q]);
        } else {
          load_vals<T, V>(src[q] + cl, corner[q]);
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float ds = s_ds[kp * kDxDsLd + cl + j];
        const float vx0 = __fadd_rn(__fmul_rn(corner[0][j], wy0), __fmul_rn(corner[2][j], wy1));
        const float vx1 = __fadd_rn(__fmul_rn(corner[1][j], wy0), __fmul_rn(corner[3][j], wy1));
        const float dvx0 = ds * wx0, dvx1 = ds * wx1;
        sum[0] += ds * vx0;
        sum[1] += ds * vx1;
        sum[2] += dvx0 * corner[0][j] + dvx1 * corner[1][j];
        sum[3] += dvx0 * corner[2][j] + dvx1 * corner[3][j];
      }
    }
    // one thread per (tap, pixel) and chunk: a plain sum across chunks
#pragma unroll
    for (int q = 0; q < 4; ++q) s_dwts[(k * 4 + q) * kDxPixels + pl] += sum[q];
  }
}

// The gradient of corner q of (tap, pixel) kp at 4 channels cl.. of the
// chunk: ds * (1-fx or fx) * ((1-fy)m or fy m), rounded as the plain version.
template <int LD>
__device__ __forceinline__ float4 corner_grad(const float* s_ds, const float* s_wt, int kp, int q,
                                              int cl) {
  const int k = kp / kDxPixels, pl = kp - k * kDxPixels;
  const float wx = s_wt[(k * 4 + (q & 1)) * kDxPixels + pl];
  const float wy = s_wt[(k * 4 + 2 + (q >> 1)) * kDxPixels + pl];
  const float4 ds = *reinterpret_cast<const float4*>(s_ds + kp * LD + cl);
  return make_float4((ds.x * wx) * wy, (ds.y * wx) * wy, (ds.z * wx) * wy, (ds.w * wx) * wy);
}

__device__ __forceinline__ void add_dx4(float* dst, float4 v, int c, int C_in, bool vec_dx) {
  if (vec_dx) {
    const float a[4] = {v.x, v.y, v.z, v.w};
    atomic_add_vals<4>(dst, a);
  } else {
    if (c < C_in) atomicAdd(dst, v.x);
    if (c + 1 < C_in) atomicAdd(dst + 1, v.y);
    if (c + 2 < C_in) atomicAdd(dst + 2, v.z);
    if (c + 3 < C_in) atomicAdd(dst + 3, v.w);
  }
}

// ds_k [64 x chunk] = dy [64 x oc_max] . W_k[chunk, :]^T for taps k0 and, if
// n = 2, k0 + 1 (W_k chunks at s_w, s_w + w_buf), into s_ds, or added to it
// (add: a later piece of dy), on WMMA: warp owns row tile warp % 4 of tap
// k0 + warp / 4 (one accumulator a warp).
__device__ __forceinline__ void ds_pair(const __nv_bfloat16* s_dy, const __nv_bfloat16* s_w,
                                        float* s_ds, int k0, int n, bool add, const DxGeom& g,
                                        int tid) {
  using namespace nvcuda;
  const int warp = tid / 32, row = 16 * (warp & 3), h = warp >> 2;
  if (h >= n) return;
  float* ds = s_ds + ((k0 + h) * kDxPixels + row) * kDxDsLd;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  if (add) {
    wmma::load_matrix_sync(acc, ds, kDxDsLd, wmma::mem_row_major);
  } else {
    wmma::fill_fragment(acc, 0.f);
  }
  for (int kk = 0; kk < g.oc_max; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
    wmma::load_matrix_sync(fa, s_dy + row * g.dy_ld + kk, g.dy_ld);
    wmma::load_matrix_sync(fb, s_w + h * g.w_buf + kk, g.w_ld);
    wmma::mma_sync(acc, fa, fb, acc);
  }
  wmma::store_matrix_sync(ds, acc, kDxDsLd, wmma::mem_row_major);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
deform_conv_bwd_input_window_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                             const T* __restrict__ mask, const T* __restrict__ weight,
                             const T* __restrict__ dy, float* __restrict__ dx,
                             float* __restrict__ dwts, int H, int W, int C_in, int Ho, int Wo,
                             int C_out, int kh, int kw, int stride, int pad, int dil,
                             int off_stride, int mask_stride, bool vec_x, bool vec_o,
                             bool vec_dx, DxGeom g) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the window kernel is bf16");
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char dx_smem[];
  float* s_ds = reinterpret_cast<float*>(dx_smem + g.off_ds);  // [K][64][chunk + 4]
  T* s_dy = reinterpret_cast<T*>(dx_smem + g.off_dy);
  T* s_w = reinterpret_cast<T*>(dx_smem + g.off_w);  // the round's taps' chunks
  T* s_x = reinterpret_cast<T*>(dx_smem + g.off_x);  // x over the window
  int* s_pack = reinterpret_cast<int*>(dx_smem + g.off_pack);
  float* s_wt = reinterpret_cast<float*>(dx_smem + g.off_wt);
  float* s_dwts = reinterpret_cast<float*>(dx_smem + g.off_dwts);
  int* s_cnt = reinterpret_cast<int*>(dx_smem + g.off_cnt);      // [buckets]
  int* s_first = reinterpret_cast<int*>(dx_smem + g.off_first);  // [buckets + 1]
  short* s_ent = reinterpret_cast<short*>(dx_smem + g.off_ent);  // corners by bucket

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int oy0 = (blockIdx.x / g.tiles_x) * g.tile_h;
  const int ox0 = (blockIdx.x % g.tiles_x) * g.tile_w;
  const long long b = blockIdx.y;
  const int P = Ho * Wo;
  const int K = kh * kw;
  const int org_y = oy0 * stride - pad - g.radius, org_x = ox0 * stride - pad - g.radius;
  const int cells = g.win_h * g.win_w, buckets = cells + 1;  // bucket `cells`: the spill
  const T* xb = x + b * H * W * (long long)C_in;
  float* dxb = dx + b * H * W * (long long)C_in;
  const T* dyb = dy + b * P * (long long)C_out;

  // per (tap, pixel): the corner origin (packed, kPackNone outside the
  // output), the four lerp weights; their gradient sums start at 0
  for (int e = tid; e < K * kDxPixels; e += kThreads) {
    const int k = e / kDxPixels, pl = e - k * kDxPixels;
    const int oy = oy0 + pl / g.tile_w, ox = ox0 + pl % g.tile_w;
    int pack = kPackNone;
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (oy < Ho && ox < Wo) {
      const int p = oy * Wo + ox;
      int y0, x0;
      corner_origin<T>(offset, mask, b * P + p, p, k, H, W, Wo, kw, stride, pad, dil, off_stride,
                       mask_stride, y0, x0, wt);
      pack = ((y0 + 2) << 16) | (x0 + 2);
    }
    s_pack[e] = pack;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s_wt[(k * 4 + q) * kDxPixels + pl] = wt[q];
      s_dwts[(k * 4 + q) * kDxPixels + pl] = 0.f;
    }
  }
  for (int e = tid; e < buckets; e += kThreads) s_cnt[e] = 0;
  if (g.n_oc == 1) {  // the dy tile, once per block
    if (vec_o) {
      stage_dy<T, kVec>(dyb, C_out, Wo, Ho, oy0, ox0, g, 0, s_dy, tid);
    } else {
      stage_dy<T, 1>(dyb, C_out, Wo, Ho, oy0, ox0, g, 0, s_dy, tid);
    }
  }
  __syncthreads();

  // the corners by bucket: count, scan, place (corner e = (k * 64 + pl) * 4 + q)
  auto bucket_of = [&](int e) -> int {
    const int pack = s_pack[e >> 2];
    if (pack == kPackNone) return -1;
    const int y = (pack >> 16) - 2 + ((e & 3) >> 1), xx = (pack & 0xffff) - 2 + (e & 1);
    if (y < 0 || y >= H || xx < 0 || xx >= W) return -1;  // contributes nothing
    const int ry = y - org_y, rx = xx - org_x;
    return ry >= 0 && ry < g.win_h && rx >= 0 && rx < g.win_w ? ry * g.win_w + rx : cells;
  };
  for (int e = tid; e < K * kDxPixels * 4; e += kThreads) {
    const int bk = bucket_of(e);
    if (bk >= 0) atomicAdd(&s_cnt[bk], 1);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the counts
    const int per = (buckets + 31) / 32, lo = lane * per;
    const int hi = lo + per < buckets ? lo + per : buckets;
    int local = 0;
    for (int i = lo; i < hi; ++i) local += s_cnt[i];
    int incl = local;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += v;
    }
    int run = incl - local;
    for (int i = lo; i < hi; ++i) {
      const int c = s_cnt[i];
      s_first[i] = run;
      s_cnt[i] = 0;  // from here a cursor
      run += c;
    }
    if (lane == 31) s_first[buckets] = incl;
  }
  __syncthreads();
  for (int e = tid; e < K * kDxPixels * 4; e += kThreads) {
    const int bk = bucket_of(e);
    if (bk >= 0) s_ent[s_first[bk] + atomicAdd(&s_cnt[bk], 1)] = (short)e;
  }
  // (the barrier after the first ds product orders these writes before use)

  using namespace nvcuda;
  for (int c0 = 0; c0 < C_in; c0 += kDxChunk) {
    // the chunk's x window: its copies land while the ds products run
    if (vec_x && cells > 0) stage_x_async<T>(xb, H, W, C_in, c0, org_y, org_x, g, s_x, tid);
    // ds_k [64 x chunk] = dy [64 x C_out] . W_k[c0.., :]^T for every tap,
    // g.taps taps a round
    for (int k0 = 0; k0 < K; k0 += g.taps) {
      const int n_taps = K - k0 < g.taps ? K - k0 : g.taps;
      for (int oc = 0; oc < g.n_oc; ++oc) {
        if (g.n_oc > 1) {
          __syncthreads();  // the previous piece of dy is consumed
          if (vec_o) {
            stage_dy<T, kVec>(dyb, C_out, Wo, Ho, oy0, ox0, g, oc * g.oc_max, s_dy, tid);
          } else {
            stage_dy<T, 1>(dyb, C_out, Wo, Ho, oy0, ox0, g, oc * g.oc_max, s_dy, tid);
          }
        }
        for (int h = 0; h < n_taps; ++h) {
          const T* wk = weight + (long long)(k0 + h) * C_in * C_out;
          if (vec_o) {  // all of the round's copies in flight at once
            stage_w_async<T>(wk, C_in, C_out, c0, oc * g.oc_max, g, s_w + h * g.w_buf, tid);
          } else {
            stage_w<T, 1>(wk, C_in, C_out, c0, oc * g.oc_max, g, s_w + h * g.w_buf, tid);
          }
        }
        cp_async_wait_all();  // (the x window's copies too, at the first round)
        __syncthreads();
        // ds of the round's taps, two at a time (the first piece of dy writes,
        // later ones add)
        for (int h = 0; h < n_taps; h += 2)
          ds_pair(s_dy, s_w + h * g.w_buf, s_ds, k0 + h, n_taps - h < 2 ? 1 : 2, oc > 0, g, tid);
        if (g.n_oc > 1 || k0 + n_taps < K) __syncthreads();  // s_w (and s_dy, s_ds) consumed
      }
    }
    __syncthreads();  // ds of every tap is in shared memory

    if (vec_x) {
      dx_weight_grads<T, kVec>(xb, H, W, C_in, c0, K, s_pack, s_wt, s_ds, s_dwts,
                               cells > 0 ? s_x : nullptr, org_y, org_x, g, tid);
    } else {
      dx_weight_grads<T, 1>(xb, H, W, C_in, c0, K, s_pack, s_wt, s_ds, s_dwts, nullptr, org_y,
                            org_x, g, tid);
    }
    // dx: each window cell's corners summed in registers, one thread a cell
    constexpr int kGroups = kDxChunk / 4;
    for (int cell = tid; cell < cells; cell += kThreads) {
      const int first = s_first[cell], last = s_first[cell + 1];
      if (first == last) continue;
      float4 sum[kGroups];
#pragma unroll
      for (int j = 0; j < kGroups; ++j) sum[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = first; i < last; ++i) {
        const int ent = s_ent[i];
#pragma unroll
        for (int j = 0; j < kGroups; ++j) {
          const float4 d = corner_grad<kDxDsLd>(s_ds, s_wt, ent >> 2, ent & 3, 4 * j);
          sum[j].x += d.x;
          sum[j].y += d.y;
          sum[j].z += d.z;
          sum[j].w += d.w;
        }
      }
      const int y = org_y + cell / g.win_w, xx = org_x + cell % g.win_w;
      float* dst = dxb + ((long long)y * W + xx) * C_in + c0;
#pragma unroll
      for (int j = 0; j < kGroups; ++j)
        if (c0 + 4 * j < C_in) add_dx4(dst + 4 * j, sum[j], c0 + 4 * j, C_in, vec_dx);
    }
    // the spill: corners outside their window, one add each
    const int s0 = s_first[cells], n_spill = s_first[cells + 1] - s0;
    for (int i = tid; i < n_spill; i += kThreads) {
      const int ent = s_ent[s0 + i], kp = ent >> 2, q = ent & 3;
      const int pack = s_pack[kp];
      const int y = (pack >> 16) - 2 + (q >> 1), xx = (pack & 0xffff) - 2 + (q & 1);
      float* dst = dxb + ((long long)y * W + xx) * C_in + c0;
#pragma unroll
      for (int j = 0; j < kGroups; ++j)
        if (c0 + 4 * j < C_in)
          add_dx4(dst + 4 * j, corner_grad<kDxDsLd>(s_ds, s_wt, kp, q, 4 * j), c0 + 4 * j,
                  C_in, vec_dx);
    }
    __syncthreads();  // ds is read before the next chunk overwrites it
  }

  for (int e = tid; e < K * kDxPixels; e += kThreads) {
    const int k = e / kDxPixels, pl = e - k * kDxPixels;
    const int oy = oy0 + pl / g.tile_w, ox = ox0 + pl % g.tile_w;
    if (oy >= Ho || ox >= Wo) continue;
    const float* sw = s_dwts + k * 4 * kDxPixels + pl;
    *reinterpret_cast<float4*>(dwts + ((b * P + oy * Wo + ox) * K + k) * 4) =
        make_float4(sw[0], sw[kDxPixels], sw[2 * kDxPixels], sw[3 * kDxPixels]);
  }
}

// ---------------------------------------------------------------------------
// Kernel B, dW: dW_k[c,o] = sum_p sampled_k[p,c] dy[p,o], as GEMMs whose
// rows are the (tap, input channel) pairs, whose columns are the output
// channels and whose reduction runs over the output pixels of the batch.
// The warp-specialised design of the forward: a block owns a tile of M rows
// x N columns (M N = 16384, N = 64, 128 or 256 as C_out needs): tpb taps x
// ci input channels (tpb ci <= M; ci = min(C_in, M), tpb = K split into
// equal groups, e.g. 3 taps x 64 channels at C_in = 64), and a range of
// pixels (its split). Per stage of PK pixels the producers build the corner
// tables of the rows' taps, gather and lerp the sampled [PK x M] tile (each
// sample once for all N columns, rounded to bf16 in bf16, as the forward
// multiplies it) and copy the dy tile [PK x N] by cp.async (one copy serves
// every tap of the rows); the consumers run the products (mma.sync with A =
// sampled^T by ldmatrix.trans in bf16, 8 x 8 FMA tiles in f32). No
// atomics: each block writes its tile of f32 sums into its split's slice of
// a partials buffer, and deform_conv_bwd_weight_reduce_kernel adds the
// splits in split order into dW (deterministic). The split count is
// ops/deform_conv.py's (dw_plan): the blocks fill the SMs in whole waves.
// ---------------------------------------------------------------------------

template <typename T, int NT>
struct DwCfg {
  static constexpr bool kBf16 = !std::is_same<T, float>::value;
  static constexpr int CW = consumer_warps(NT), PT = kWsThreads - 32 * CW;
  static constexpr int G = producer_groups(CW, true), GPT = PT / G;  // as FwdCfg
  static constexpr int kHandoff = 32 * CW + GPT;
  static constexpr int N = 64 * NT, M = 32 * CW / NT;
  static constexpr int PK = kBf16 ? 64 : 32;  // pixels a stage
  static constexpr int TS = 4;                // stages whose corner tables are built at once
  // A [PK][a_ld] sampled, the block's rows; B [PK][b_ld] dy
  static constexpr int a_ld = kBf16 ? M + 8 : M + 4;
  static constexpr int b_ld = kBf16 ? N + 8 : N + 4;
  static constexpr int a_bytes = (int)sizeof(T) * PK * a_ld;
  static constexpr int stage_bytes = a_bytes + (int)sizeof(T) * PK * b_ld;
  // then the corner tables of TS stages, [tap][pixel]: indices, then weights
  static int smem(int taps) {
    return kWsStages * stage_bytes + taps * TS * PK * (int)(sizeof(int4) + sizeof(float4));
  }
};

// The rows of a dW block: tpb taps x ci input channels. Returns tpb; ci,
// and the blocks along the taps (n_kb) and along C_in (n_ccb), through the
// references.
__host__ __device__ inline int dw_rows(int M, int C_in, int K, int& ci, int& n_kb, int& n_ccb) {
  ci = C_in < M ? C_in : M;
  n_ccb = (C_in + ci - 1) / ci;
  n_kb = (K + M / ci - 1) / (M / ci);
  return (K + n_kb - 1) / n_kb;
}

template <typename T, int NT>
__global__ void __launch_bounds__(kWsThreads, 1)
deform_conv_bwd_weight_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                              const T* __restrict__ mask, const T* __restrict__ dy,
                              float* __restrict__ part, DcnGeom g, int chunks_per_split,
                              bool vec_x, bool vec_o) {
  using C = DwCfg<T, NT>;
  extern __shared__ __align__(128) unsigned char ws_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = g.kh * g.kw, P = g.Ho * g.Wo;
  int ci, n_kb, n_ccb;
  const int tpb = dw_rows(C::M, g.C_in, K, ci, n_kb, n_ccb);
  const int n_cb = (g.C_out + C::N - 1) / C::N, n_rb = n_kb * n_ccb;
  const int split = blockIdx.x / (n_rb * n_cb), rem = blockIdx.x - split * n_rb * n_cb;
  const int rb = rem / n_cb, n0 = (rem % n_cb) * C::N;
  const int k_lo = (rb / n_ccb) * tpb, c_lo = (rb % n_ccb) * ci;
  const int n_taps = min(tpb, K - k_lo);
  // the split's stages: chunks chunk0 .. chunk0 + n_it - 1 of PK pixels
  // of one image each (cpi an image)
  const int cpi = (P + C::PK - 1) / C::PK;
  const long long chunk0 = (long long)split * chunks_per_split;
  const long long chunks = (long long)g.B * cpi;
  const int n_it = (int)min((long long)chunks_per_split, chunks - chunk0);
  auto stage_a = [&](int it) {
    return reinterpret_cast<T*>(ws_smem + (it % kWsStages) * C::stage_bytes);
  };
  auto stage_b = [&](int it) {
    return reinterpret_cast<T*>(ws_smem + (it % kWsStages) * C::stage_bytes + C::a_bytes);
  };
  constexpr int kTabPix = C::TS * C::PK;  // pixels of one build of the tables
  int4* t_idx = reinterpret_cast<int4*>(ws_smem + kWsStages * C::stage_bytes);
  float4* t_wt = reinterpret_cast<float4*>(t_idx + tpb * kTabPix);
  // The dy tile of stage it, by NTH threads as cp.async copies left in
  // flight: the consumers' or the producers', as the forward's W chunk.
  constexpr bool kConsumersCopy = C::kBf16 && C::CW == 8;
  auto copy_dy = [&](int it, int ctid, auto nth) {
    constexpr int NTH = decltype(nth)::value;
    const long long b = (chunk0 + it) / cpi;
    const int p0 = (int)((chunk0 + it) % cpi) * C::PK;
    producer_copy<T, C::PK, C::N, NTH>(stage_b(it), C::b_ld, dy + (b * P + p0) * g.C_out,
                                       g.C_out, P - p0, n0, g.C_out, vec_o, ctid);
  };

  if (warp >= C::CW) {
    // producers: the corner tables of TS stages at once, then each stage by
    // one group, the groups in turn
    const int ptid = tid - 32 * C::CW;
    const int grp = ptid / C::GPT, gtid = ptid - grp * C::GPT;
    constexpr int kV = 16 / sizeof(T), kG = 4;
    for (int it = 0; it < n_it; ++it) {
      if (it % C::TS == 0) {
        // the corner tables of the next TS stages' pixels, [tap][pixel]
        if (it > 0) named_bar_sync(kBarProducers, C::PT);  // the last ones are no longer read
        for (int e = ptid; e < n_taps * kTabPix; e += C::PT) {
          const int kk = e / kTabPix, pl = e - kk * kTabPix, j = pl / C::PK;
          const long long ch = chunk0 + it + j;
          // past the split: p = P, no sample
          const int p = it + j < n_it ? (int)(ch % cpi) * C::PK + pl - j * C::PK : P;
          table_entry<T>(offset, mask, ch / cpi, p, k_lo + kk, g, t_idx[e], t_wt[e]);
        }
        named_bar_sync(kBarProducers, C::PT);
      }
      if (it % C::G != grp) continue;
      const int p_off = (it % C::TS) * C::PK;  // the stage's pixels in the tables
      if (it >= kWsStages) named_bar_sync(1 + kWsStages + it % kWsStages, C::kHandoff);
      T* s_a = stage_a(it);
      const T* xb = x + (chunk0 + it) / cpi * g.H * g.W * g.C_in;
      if (!kConsumersCopy) copy_dy(it, gtid, std::integral_constant<int, C::GPT>());
      if (vec_x) {
        // the thread's rows fixed: kV channels of one tap (ci % kV == 0)
        constexpr int groups = C::M / kV, rows = C::GPT / groups;
        static_assert(C::GPT % groups == 0, "a producer's rows must be fixed");
        const int rl = (gtid % groups) * kV, kk = rl / ci, c = c_lo + rl - kk * ci;
        const bool r_ok = kk < n_taps && c < g.C_in;
        const int4* e_idx = t_idx + (r_ok ? kk : 0) * kTabPix + p_off;
        const float4* e_wt = t_wt + (r_ok ? kk : 0) * kTabPix + p_off;
        for (int pl0 = gtid / groups; pl0 < C::PK; pl0 += rows * kG) {
          int4 idx[kG];
          float4 wt[kG];
          bool ok[kG];
          T* dst[kG];
#pragma unroll
          for (int j = 0; j < kG; ++j) {
            const int pl = pl0 + j * rows;
            ok[j] = pl < C::PK;
            const int pr = ok[j] ? pl : 0;
            idx[j] = r_ok ? e_idx[pr] : make_int4(-1, -1, -1, -1);
            wt[j] = e_wt[pr];
            dst[j] = s_a + pr * C::a_ld + rl;
          }
          sample_groups<T, kV, kG, true>(xb + c, idx, wt, ok, dst);
        }
      } else {
        // scalar loads (C_in odd or x unaligned), one sample at a time
        for (int e = gtid; e < C::PK * C::M; e += C::GPT) {
          const int pl = e / C::M, rl = e - pl * C::M, kk = rl / ci, c = c_lo + rl - kk * ci;
          const bool r_ok = kk < n_taps && c < g.C_in;
          const int4 idx[1] = {r_ok ? t_idx[kk * kTabPix + p_off + pl] : make_int4(-1, -1, -1, -1)};
          const float4 wt[1] = {t_wt[(r_ok ? kk : 0) * kTabPix + p_off + pl]};
          const bool ok[1] = {true};
          T* const dst[1] = {s_a + pl * C::a_ld + rl};
          sample_groups<T, 1, 1, false>(xb + (r_ok ? c : 0), idx, wt, ok, dst);
        }
      }
      cp_async_wait_all();
      named_bar_arrive(1 + it % kWsStages, C::kHandoff);
    }
  } else {
    const int wm = warp / NT, wn = warp % NT;
    using Consumers = std::integral_constant<int, 32 * C::CW>;
    if (kConsumersCopy) {  // the first stages' dy tiles, a cp.async group each
      for (int it = 0; it < kWsStages; ++it) {
        if (it < n_it) copy_dy(it, tid, Consumers());
        cp_async_commit();
      }
    }
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    for (int it = 0; it < n_it; ++it) {
      named_bar_sync(1 + it % kWsStages, C::kHandoff);
      if (kConsumersCopy) {  // as the forward's W chunk
        cp_async_wait_group<kWsStages - 2>();
        named_bar_sync(kBarConsumers, Consumers::value);
        if (it > 0 && it - 1 + kWsStages < n_it) copy_dy(it - 1 + kWsStages, tid, Consumers());
        cp_async_commit();
      }
      warp_mma_stage<T, true, C::PK>(acc, stage_a(it), C::a_ld, stage_b(it), C::b_ld, 32 * wm,
                                     64 * wn, lane);
      if (it + kWsStages < n_it) named_bar_arrive(1 + kWsStages + it % kWsStages, C::kHandoff);
    }
    // the block's f32 sums into its split's slice of the partials [K C_in, C_out]
    float* dst = part + (long long)split * K * g.C_in * g.C_out;
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      int row, col;
      acc_pos<T>(e, lane, row, col);
      const int rl = 32 * wm + row, kk = rl / ci, c = c_lo + rl - kk * ci;
      const int o = n0 + 64 * wn + col;
      if (kk < n_taps && c < g.C_in && o < g.C_out)
        dst[((long long)(k_lo + kk) * g.C_in + c) * g.C_out + o] = acc[e];
    }
  }
}

// dW [n] = the sum of the splits' partials [splits][n], in split order.
__global__ void __launch_bounds__(256)
deform_conv_bwd_weight_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                     long long n, int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = part[e];
    for (int j = 1; j < splits; ++j) s += part[j * n + e];
    dw[e] = s;
  }
}

template <typename T, int NT>
int launch_dw(const T* x, const T* offset, const T* mask, const T* dy, float* part, float* dw,
              const DcnGeom& g, int splits, bool vec_x, bool vec_o, cudaStream_t stream) {
  using C = DwCfg<T, NT>;
  const int K = g.kh * g.kw;
  int ci, n_kb, n_ccb;
  const int smem = C::smem(dw_rows(C::M, g.C_in, K, ci, n_kb, n_ccb));
  if (smem > kWsMaxSmem) return (int)cudaErrorInvalidValue;
  // set on every launch: the opt-in holds for the current device only
  if (const cudaError_t e = cudaFuncSetAttribute(
          deform_conv_bwd_weight_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      e != cudaSuccess)
    return (int)e;
  const long long chunks = (long long)g.B * ((g.Ho * g.Wo + C::PK - 1) / C::PK);
  if (splits < 1 || splits > chunks) return (int)cudaErrorInvalidValue;
  const long long per_split = (chunks + splits - 1) / splits;
  if ((chunks + per_split - 1) / per_split != splits || per_split > 2147483647ll)
    return (int)cudaErrorInvalidValue;  // every split non-empty
  const long long blocks =
      (long long)splits * n_kb * n_ccb * ((g.C_out + C::N - 1) / C::N);
  if (blocks > 2147483647ll) return (int)cudaErrorInvalidValue;
  deform_conv_bwd_weight_kernel<T, NT><<<(unsigned)blocks, kWsThreads, smem, stream>>>(
      x, offset, mask, dy, part, g, (int)per_split, vec_x, vec_o);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long n = (long long)K * g.C_in * g.C_out;
  const long long reduce_blocks = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  deform_conv_bwd_weight_reduce_kernel<<<(unsigned)reduce_blocks, 256, 0, stream>>>(part, dw, n,
                                                                                   splits);
  return (int)cudaGetLastError();
}

// Launch the bf16 dx kernel on its window: the geometry, and the window only
// where it fits in shared memory (else every corner goes to dx).
template <typename T>
int launch_dx_window(const void* x, const void* offset, const void* mask, const void* weight,
                     const void* dy, void* dx, void* dwts, int H, int W, int C_in, int Ho, int Wo,
                     int C_out, int kh, int kw, int stride, int pad, int dil, int off_stride,
                     int mask_stride, int tile_w, int radius, bool vec_x, bool vec_o, int B,
                     void* stream) {
  constexpr int kMaxSmem = kWsMaxSmem;
  const bool vec_dx = C_in % 4 == 0 && reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  DxGeom g = dx_geometry<T>(Ho, Wo, C_out, kh * kw, kh, kw, stride, dil, tile_w, radius);
  if (g.smem > kMaxSmem)
    g = dx_geometry<T>(Ho, Wo, C_out, kh * kw, kh, kw, stride, dil, tile_w, -1);
  if (g.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // set on every launch: the opt-in holds for the current device only
  if (const cudaError_t e = cudaFuncSetAttribute(
          deform_conv_bwd_input_window_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem);
      e != cudaSuccess)
    return (int)e;
  const long long tiles = (long long)g.tiles_x * ((Ho + g.tile_h - 1) / g.tile_h);
  const dim3 grid_a((unsigned)tiles, B);
  deform_conv_bwd_input_window_kernel<T><<<grid_a, kThreads, g.smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset), static_cast<const T*>(mask),
      static_cast<const T*>(weight), static_cast<const T*>(dy), static_cast<float*>(dx),
      static_cast<float*>(dwts), H, W, C_in, Ho, Wo, C_out, kh, kw, stride, pad, dil,
      off_stride, mask_stride, vec_x, vec_o, vec_dx, g);
  return 0;
}

template <typename T>
int launch_backward(const void* x, const void* offset, const void* mask, const void* weight,
                    const void* dy, void* dx, void* dwts, void* dw, void* dw_part, int B, int H,
                    int W, int C_in, int Ho, int Wo, int C_out, int kh, int kw, int stride,
                    int pad, int dil, int off_stride, int mask_stride, int tile_w, int radius,
                    int dw_splits, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C_in <= 0 || Ho <= 0 || Wo <= 0 || C_out <= 0 ||
      kh <= 0 || kw <= 0 || stride <= 0 || dil <= 0 || pad < 0 ||
      off_stride < 2 * kh * kw || mask_stride < kh * kw ||
      (tile_w != 8 && tile_w != 16) || H > 32000 || W > 32000 || kh * kw > 127)
    return (int)cudaErrorInvalidValue;
  const long long P = (long long)Ho * Wo;
  if ((P + kTileP - 1) / kTileP > 2147483647ll || B > 65535 ||
      (long long)B * H * W > (1ll << 31) || (long long)B * P > (1ll << 31) ||
      (long long)kh * kw * C_in * C_out > (1ll << 31) || (long long)H * W * C_in > (1ll << 31))
    return (int)cudaErrorInvalidValue;
  constexpr int vec = 16 / sizeof(T);
  const bool vec_x = C_in % vec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const bool vec_o = C_out % vec == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(weight) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(dwts) % 16 != 0) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid_rows((unsigned)((P + kTileP - 1) / kTileP), B);
    deform_conv_bwd_input_kernel<T><<<grid_rows, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(offset), static_cast<const T*>(mask),
        static_cast<const T*>(weight), static_cast<const T*>(dy), static_cast<float*>(dx),
        static_cast<float*>(dwts), H, W, C_in, Ho, Wo, C_out, kh, kw, stride, pad, dil,
        off_stride, mask_stride, vec_x, vec_o);
  } else {
    const int err = launch_dx_window<T>(x, offset, mask, weight, dy, dx, dwts, H, W, C_in, Ho, Wo,
                                        C_out, kh, kw, stride, pad, dil, off_stride, mask_stride,
                                        tile_w, radius, vec_x, vec_o, B, stream);
    if (err != 0) return err;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  // dW: the split count is the caller's (dw_plan)
  const DcnGeom g{B, H, W, C_in, Ho, Wo, C_out, kh, kw, stride, pad, dil, off_stride, mask_stride};
  const T* xs = static_cast<const T*>(x);
  const T* os = static_cast<const T*>(offset);
  const T* ms = static_cast<const T*>(mask);
  const T* ds = static_cast<const T*>(dy);
  float* part = static_cast<float*>(dw_part);
  float* dws = static_cast<float*>(dw);
  const cudaStream_t s = (cudaStream_t)stream;
  if (C_out <= 64)
    return launch_dw<T, 1>(xs, os, ms, ds, part, dws, g, dw_splits, vec_x, vec_o, s);
  if (C_out <= 128)
    return launch_dw<T, 2>(xs, os, ms, ds, part, dws, g, dw_splits, vec_x, vec_o, s);
  return launch_dw<T, 4>(xs, os, ms, ds, part, dws, g, dw_splits, vec_x, vec_o, s);
}

}  // namespace

extern "C" {

int vd3d_modulated_deform_conv_f32(const void* x, const void* offset, const void* mask,
                                   const void* weight, const void* bias, void* out, int B,
                                   int H, int W, int C_in, int Ho, int Wo, int C_out, int kh,
                                   int kw, int stride, int pad, int dil, int off_stride,
                                   int mask_stride, void* stream) {
  return launch<float>(x, offset, mask, weight, bias, out, B, H, W, C_in, Ho, Wo, C_out, kh,
                       kw, stride, pad, dil, off_stride, mask_stride, stream);
}

int vd3d_modulated_deform_conv_bf16(const void* x, const void* offset, const void* mask,
                                    const void* weight, const void* bias, void* out, int B,
                                    int H, int W, int C_in, int Ho, int Wo, int C_out, int kh,
                                    int kw, int stride, int pad, int dil, int off_stride,
                                    int mask_stride, void* stream) {
  return launch<__nv_bfloat16>(x, offset, mask, weight, bias, out, B, H, W, C_in, Ho, Wo,
                               C_out, kh, kw, stride, pad, dil, off_stride, mask_stride,
                               stream);
}

// The all-taps forward: arguments as the per-tap one.
int vd3d_modulated_deform_conv_alltaps_bf16(const void* x, const void* offset, const void* mask,
                                            const void* weight, const void* bias, void* out,
                                            int B, int H, int W, int C_in, int Ho, int Wo,
                                            int C_out, int kh, int kw, int stride, int pad,
                                            int dil, int off_stride, int mask_stride,
                                            void* stream) {
  return launch_alltaps(x, offset, mask, weight, bias, out, B, H, W, C_in, Ho, Wo, C_out, kh, kw,
                        stride, pad, dil, off_stride, mask_stride, stream);
}

// The lerp-accumulate: y [B,H,W,K*C_out] contiguous (Y = x @ W'), offsets and
// mask as in the forward, bias [C_out] or null, out [B,Ho,Wo,C_out].
int vd3d_premul_lerp_accumulate_bf16(const void* y, const void* offset, const void* mask,
                                     const void* bias, void* out, int B, int H, int W, int Ho,
                                     int Wo, int C_out, int kh, int kw, int stride, int pad,
                                     int dil, int off_stride, int mask_stride, void* stream) {
  return launch_premul(y, offset, mask, bias, out, B, H, W, Ho, Wo, C_out, kh, kw, stride, pad,
                       dil, off_stride, mask_stride, stream);
}

// Backward: x, offset, mask and W as in the forward, dy [B,Ho,Wo,C_out]
// contiguous; dx [B,H,W,C_in] f32, zeroed by the caller; dw [K,C_in,C_out]
// f32 (every entry written); dw_part [dw_splits,K*C_in,C_out] f32 scratch
// (the splits' partial sums); dwts [B,Ho,Wo,K,4] f32 (every entry written):
// the gradients of 1-fx, fx, (1-fy)*mask and fy*mask. The dx kernel's tile
// is 64 / tile_w x tile_w output pixels (tile_w 8 or 16), its window reaches
// offsets up to +-radius (radius < 0: no window), as ops/deform_conv.py's
// dx_plan says; dw_splits is its dw_plan's.
int vd3d_modulated_deform_conv_backward_f32(
    const void* x, const void* offset, const void* mask, const void* weight, const void* dy,
    void* dx, void* dwts, void* dw, void* dw_part, int B, int H, int W, int C_in, int Ho, int Wo,
    int C_out, int kh, int kw, int stride, int pad, int dil, int off_stride, int mask_stride,
    int tile_w, int radius, int dw_splits, void* stream) {
  return launch_backward<float>(x, offset, mask, weight, dy, dx, dwts, dw, dw_part, B, H, W,
                                C_in, Ho, Wo, C_out, kh, kw, stride, pad, dil, off_stride,
                                mask_stride, tile_w, radius, dw_splits, stream);
}

int vd3d_modulated_deform_conv_backward_bf16(
    const void* x, const void* offset, const void* mask, const void* weight, const void* dy,
    void* dx, void* dwts, void* dw, void* dw_part, int B, int H, int W, int C_in, int Ho, int Wo,
    int C_out, int kh, int kw, int stride, int pad, int dil, int off_stride, int mask_stride,
    int tile_w, int radius, int dw_splits, void* stream) {
  return launch_backward<__nv_bfloat16>(x, offset, mask, weight, dy, dx, dwts, dw, dw_part, B,
                                        H, W, C_in, Ho, Wo, C_out, kh, kw, stride, pad, dil,
                                        off_stride, mask_stride, tile_w, radius, dw_splits,
                                        stream);
}

const char* vd3d_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
