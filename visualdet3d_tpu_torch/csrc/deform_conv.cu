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
// The all-taps variant (K4) runs on the same ring; the pre-multiplied one (K6)
// keeps its own design.
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

constexpr int kTileP = 64;   // output pixels of the backward's refusal count
constexpr int kThreads = 256;  // a block of the premul and bf16 dx kernels

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
//     corner tables) and lerped with explicitly rounded products and sums
//     (sample_groups; rounded to bf16 in the bf16 kernels);
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
// samples are loaded before any is used. The lerp: the y lerp of each
// corner column, then the x lerp, with explicitly rounded products and sums
// (__fmul_rn/__fadd_rn: no FMA contraction); the results go to dst[g] rounded
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

// The ring of the forward, the body of the per-tap kernel (K3/K5) and of
// the all-taps one (K4). One block per SM, persistent over the tiles
// (blockIdx.x, + gridDim.x, ...: (image, run of P pixels, column tile), the
// column tile fastest); per tile, the corner tables of all taps once, then
// stages in the order taps, then C_in chunks: the first kernel's order of
// taps, chunks and 16-wide products, so that each output is summed in the
// same order.
template <typename T, int NT>
__device__ __forceinline__ void fwd_ring(const T* __restrict__ x, const T* __restrict__ offset,
                                         const T* __restrict__ mask, const T* __restrict__ weight,
                                         const T* __restrict__ bias, T* __restrict__ out,
                                         const DcnGeom& g, bool vec_x, bool vec_w) {
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
__global__ void __launch_bounds__(kWsThreads, 1)
deform_conv_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                   const T* __restrict__ mask, const T* __restrict__ weight,
                   const T* __restrict__ bias, T* __restrict__ out, DcnGeom g, bool vec_x,
                   bool vec_w) {
  fwd_ring<T, NT>(x, offset, mask, weight, bias, out, g, vec_x, vec_w);
}

// ---------------------------------------------------------------------------
// All-taps forward, bf16 (replaces the TPU kernel
// visualdet3d_tpu/ops/deform_conv.py::_lerp_matmul_alltaps_kernel, launched by
// _lerp_matmul_pallas under VD3D_DCN_ALLTAPS=1): the same function as the
// per-tap kernel. The TPU kernel's point was one pass over a pixel tile for
// every tap and every output channel, each sample gathered once, with the
// whole tap weight resident in VMEM. The per-tap kernel's ring above makes
// that pass on this card: its tile spans up to 256 output channels (NT =
// ceil(C_out / 64) <= 4; past 256, column tiles), each sample is gathered
// once for all of them, and it walks the taps, then the C_in chunks, in the
// order the TPU kernel sums them (its fori_loop over taps). So K4 is that
// ring under its own symbol (the profile tells the two apart): it keeps
// K3's bits and its time. What bounds it is K3's: the tap products. (Its
// first design, one block per 64 pixels with the gather, the corner table
// and the WMMA steps serialised by barriers, was 1.5x slower than the ring
// on an H100 at the KM3D neck's shapes.)
// ---------------------------------------------------------------------------

template <int NT>
__global__ void __launch_bounds__(kWsThreads, 1)
deform_conv_alltaps_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ offset,
                           const __nv_bfloat16* __restrict__ mask,
                           const __nv_bfloat16* __restrict__ weight,
                           const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                           DcnGeom g, bool vec_x, bool vec_w) {
  fwd_ring<__nv_bfloat16, NT>(x, offset, mask, weight, bias, out, g, vec_x, vec_w);
}

template <typename T, int NT, typename Kernel>
int launch_fwd(Kernel kernel, const T* x, const T* offset, const T* mask, const T* weight,
               const T* bias, T* out, const DcnGeom& g, bool vec_x, bool vec_w,
               cudaStream_t stream) {
  using C = FwdCfg<T, NT>;
  const int smem = C::smem(g.kh * g.kw);
  if (smem > kWsMaxSmem) return (int)cudaErrorInvalidValue;
  // set on every launch: the opt-in holds for the current device only
  if (const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      e != cudaSuccess)
    return (int)e;
  int device = 0, n_sm = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const long long n_tiles = (long long)g.B * ((g.Ho * g.Wo + C::P - 1) / C::P) *
                            ((g.C_out + C::N - 1) / C::N);
  const unsigned grid = (unsigned)(n_tiles < n_sm ? n_tiles : n_sm);
  kernel<<<grid, kWsThreads, smem, stream>>>(x, offset, mask, weight, bias, out, g, vec_x, vec_w);
  return (int)cudaGetLastError();
}

// The ring's tile width for C_out: NT x 64 output channels, NT = 1, 2 or 4
// (past 256 output channels, column tiles of 256); K4 takes its symbol.
template <typename T, int NT>
int launch_nt(bool alltaps, const T* x, const T* offset, const T* mask, const T* weight,
              const T* bias, T* out, const DcnGeom& g, bool vec_x, bool vec_w,
              cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (alltaps)
      return launch_fwd<T, NT>(deform_conv_alltaps_kernel<NT>, x, offset, mask, weight, bias, out,
                               g, vec_x, vec_w, stream);
  }
  return launch_fwd<T, NT>(deform_conv_kernel<T, NT>, x, offset, mask, weight, bias, out, g,
                           vec_x, vec_w, stream);
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask, const void* weight,
           const void* bias, void* out, int B, int H, int W, int C_in, int Ho, int Wo,
           int C_out, int kh, int kw, int stride, int pad, int dil, int off_stride,
           int mask_stride, bool alltaps, void* stream) {
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
    return launch_nt<T, 1>(alltaps, args[0], args[1], args[2], args[3], args[4], o, g, vec_x,
                           vec_w, s);
  if (C_out <= 128)
    return launch_nt<T, 2>(alltaps, args[0], args[1], args[2], args[3], args[4], o, g, vec_x,
                           vec_w, s);
  return launch_nt<T, 4>(alltaps, args[0], args[1], args[2], args[3], args[4], o, g, vec_x, vec_w,
                         s);
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
// over the memory rate. Each Y element is read by about four samples a tap
// (one per corner role), so about four times Y's bytes cross from L2 to the
// SMs. The first design (one block per 32 output pixels: the corner tables
// of all taps built by the whole block, a block barrier, then a runtime tap
// loop with one tap's four corner loads in flight a thread) reached 28% of
// the bound on an H100. This one:
//   * a block owns a 2-D tile of 8 x 16 output pixels (a warp a row of 16)
//     and 64 output channels (8 lanes a pixel, 16 bytes = 8 channels a
//     lane; scalar, 1 channel a lane, where C_out % 8 != 0 or Y or the
//     output is not 16-byte aligned); the channel chunks are a grid axis;
//   * each warp builds the corner entries of its own 16 pixels x K taps
//     (corner_entry, as the other kernels: the four corners' element
//     offsets in the table, -1 outside the image, and the four lerp
//     weights, read back as two 16-byte words) in its own piece of shared
//     memory and passes __syncwarp: no block barrier, so a warp's gathers
//     start while the block's other warps still read their offsets;
//   * a lane takes 4 pixels of the row; with the tap count fixed at compile
//     time (9; a generic instance takes any K) the taps are unrolled, and a
//     tap's 16 corner loads (4 pixels x 4 corners, 16 bytes each) are all
//     issued before its lerps;
//   * the lerp keeps the explicitly rounded products and sums of the other
//     kernels (__fmul_rn/__fadd_rn) and the f32 sum over taps in tap order,
//     so that it equals its plain version bit for bit.
// What bounds it now (stream_study.py premul, on an H100): the corner
// reads through L2 (about four times Y's bytes) and the lerp's instruction
// issue (14 a value, the explicit roundings kept); with every corner read
// hitting L1 it takes 3/4 of its time. Reading around L1 costs 1-2%: L1
// catches almost no reuse between samples. A shared-memory window of a
// tap's table around the tile does not pay at a size the SM holds: with
// offsets of std 2 px an 8 x 16 tile's window of +-4 px is 17 x 25 pixels,
// nearly as many bytes as its 512 corner reads.
// ---------------------------------------------------------------------------

constexpr int kPremulRows = 8;   // output rows of a block's tile (a warp each)
constexpr int kPremulPix = 4;    // pixels a lane (columns 4 i + slot of the warp's row)
constexpr int kPremulCols = 4 * kPremulPix;  // output columns of the tile
constexpr int kPremulTaps = 9;   // the compiled tap count (3 x 3)
constexpr int kPremulMaxTaps = 56;  // the generic instance's limit (shared memory)

// shared memory of a block: each warp's corner entries, [K][16 pixels][8 words]
__host__ __device__ constexpr int premul_smem(int taps) {
  return kPremulRows * taps * 8 * kPremulCols * (int)sizeof(int);
}

// bf16 value v of 8 loaded as one uint4 (or the one loaded alone), in f32
__device__ __forceinline__ float bf16_at(const uint4& r, int v) {
  const unsigned w = v < 2 ? r.x : v < 4 ? r.y : v < 6 ? r.z : r.w;
  return __uint_as_float((v & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float bf16_at(const __nv_bfloat16& r, int) { return to_f32(r); }

static_assert(kThreads == 32 * kPremulRows, "a warp a row of the premul tile");

template <int KT, int V>  // KT: the tap count, or 0 for any (kh * kw); V: channels a lane
__global__ void __launch_bounds__(kThreads, 2)
premul_lerp_accum_kernel(const __nv_bfloat16* __restrict__ y,
                         const __nv_bfloat16* __restrict__ offset,
                         const __nv_bfloat16* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                         int H, int W, int Ho, int Wo, int C_out, int kh, int kw, int stride,
                         int pad, int dil, int off_stride, int mask_stride, int tiles_x) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char premul_smem_buf[];
  const int K = KT > 0 ? KT : kh * kw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane >> 3, j = lane & 7;
  int* tab = reinterpret_cast<int*>(premul_smem_buf) + warp * K * 8 * kPremulCols;

  const int ho = (blockIdx.x / tiles_x) * kPremulRows + warp;
  const int wo0 = (blockIdx.x % tiles_x) * kPremulCols;
  const int c = blockIdx.y * 8 * V + j * V;
  const long long b = blockIdx.z;
  const int P = Ho * Wo;
  if (ho >= Ho) return;  // a warp below the map: no barrier waits for it

  // the warp's corner entries, 8 words of tap k and pixel px at (k * 16 + px) * 8:
  // the element offsets of the four corners' tap-k slices in the image's
  // table (-1: the corner is outside the image, or px past the map's edge),
  // then the four lerp weights
  const long long row = (long long)K * C_out;  // one pixel of Y
  for (int e = lane; e < K * kPremulCols; e += 32) {
    const int k = e / kPremulCols, px = e - k * kPremulCols;
    int idx[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    const int wo = wo0 + px;
    if (wo < Wo)
      corner_entry<T>(offset, mask, b * P + ho * Wo + wo, ho * Wo + wo, k, H, W, Wo, kw, stride,
                      pad, dil, off_stride, mask_stride, idx, wt);
    int4 offs;
    offs.x = idx[0] >= 0 ? (int)(idx[0] * row) + k * C_out : -1;
    offs.y = idx[1] >= 0 ? (int)(idx[1] * row) + k * C_out : -1;
    offs.z = idx[2] >= 0 ? (int)(idx[2] * row) + k * C_out : -1;
    offs.w = idx[3] >= 0 ? (int)(idx[3] * row) + k * C_out : -1;
    *reinterpret_cast<int4*>(tab + e * 8) = offs;
    *reinterpret_cast<float4*>(tab + e * 8 + 4) = make_float4(wt[0], wt[1], wt[2], wt[3]);
  }
  __syncwarp();
  if (c >= C_out) return;  // with V = 8, C_out % 8 == 0: whole vectors

  const T* yb = y + b * H * W * row + c;
  using Raw = typename std::conditional<V == 8, uint4, T>::type;  // V channels as loaded
  float acc[kPremulPix][V];
#pragma unroll
  for (int i = 0; i < kPremulPix; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[i][v] = 0.f;

  // tap k: the corner loads of the lane's pixels first (16 at 4 pixels), then the lerps
  auto tap = [&](int k) {
    Raw raw[kPremulPix][4];  // [pixel][corner]
#pragma unroll
    for (int i = 0; i < kPremulPix; ++i) {
      const int4 offs = *reinterpret_cast<const int4*>(tab + (k * kPremulCols + 4 * i + slot) * 8);
      const int off[4] = {offs.x, offs.y, offs.z, offs.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (V == 8) {
          raw[i][q] = off[q] >= 0 ? __ldg(reinterpret_cast<const uint4*>(yb + off[q]))
                                  : make_uint4(0u, 0u, 0u, 0u);
        } else {
          raw[i][q] = off[q] >= 0 ? yb[off[q]] : from_f32<T>(0.f);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPremulPix; ++i) {
      // the lerp weights 1-fx, fx, (1-fy)*mask, fy*mask
      const float4 wt =
          *reinterpret_cast<const float4*>(tab + (k * kPremulCols + 4 * i + slot) * 8 + 4);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float vx0 = __fadd_rn(__fmul_rn(bf16_at(raw[i][0], v), wt.z),
                                    __fmul_rn(bf16_at(raw[i][2], v), wt.w));
        const float vx1 = __fadd_rn(__fmul_rn(bf16_at(raw[i][1], v), wt.z),
                                    __fmul_rn(bf16_at(raw[i][3], v), wt.w));
        acc[i][v] = __fadd_rn(acc[i][v], __fadd_rn(__fmul_rn(vx0, wt.x), __fmul_rn(vx1, wt.y)));
      }
    }
  };
  if constexpr (KT > 0) {
#pragma unroll
    for (int k = 0; k < KT; ++k) tap(k);
  } else {
#pragma unroll 1
    for (int k = 0; k < K; ++k) tap(k);
  }

#pragma unroll
  for (int i = 0; i < kPremulPix; ++i) {
    const int wo = wo0 + 4 * i + slot;
    if (wo >= Wo) continue;
    float v[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      v[u] = round_to<T>(acc[i][u]);
      if (bias != nullptr) v[u] = __fadd_rn(v[u], to_f32(bias[c + u]));
    }
    store_vals<T, V>(out + (b * P + ho * Wo + wo) * (long long)C_out + c, v);
  }
}

template <int KT, int V>
int launch_premul_kernel(const __nv_bfloat16* y, const __nv_bfloat16* offset,
                         const __nv_bfloat16* mask, const __nv_bfloat16* bias,
                         __nv_bfloat16* out, int B, int H, int W, int Ho, int Wo, int C_out,
                         int kh, int kw, int stride, int pad, int dil, int off_stride,
                         int mask_stride, cudaStream_t stream) {
  const int smem = premul_smem(kh * kw);
  if (smem > 48 * 1024) {
    // above 48 KB (the generic instance past 11 taps): opted in once per
    // device for the instance's largest size, which holds for smaller ones
    static unsigned long long devices_set = 0;
    int device = 0;
    if (const cudaError_t e = cudaGetDevice(&device); e != cudaSuccess) return (int)e;
    const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
    if (bit == 0 || (devices_set & bit) == 0) {
      if (const cudaError_t e =
              cudaFuncSetAttribute(premul_lerp_accum_kernel<KT, V>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   premul_smem(kPremulMaxTaps));
          e != cudaSuccess)
        return (int)e;
      devices_set |= bit;
    }
  }
  const int tiles_x = (Wo + kPremulCols - 1) / kPremulCols;
  const long long tiles = (long long)tiles_x * ((Ho + kPremulRows - 1) / kPremulRows);
  const int chunks = (C_out + 8 * V - 1) / (8 * V);
  if (tiles > 2147483647ll || chunks > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, chunks, B);
  premul_lerp_accum_kernel<KT, V><<<grid, kThreads, smem, stream>>>(
      y, offset, mask, bias, out, H, W, Ho, Wo, C_out, kh, kw, stride, pad, dil, off_stride,
      mask_stride, tiles_x);
  return (int)cudaGetLastError();
}

int launch_premul(const void* y, const void* offset, const void* mask, const void* bias,
                  void* out, int B, int H, int W, int Ho, int Wo, int C_out, int kh, int kw,
                  int stride, int pad, int dil, int off_stride, int mask_stride, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || C_out <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || dil <= 0 || pad < 0 || off_stride < 2 * kh * kw || mask_stride < kh * kw ||
      kh * kw > kPremulMaxTaps || (long long)H * W * kh * kw * C_out > (1ll << 31))
    return (int)cudaErrorInvalidValue;
  // 16-byte loads and stores where every C_out slice of Y and every output
  // row starts 16-byte aligned
  const bool vec = C_out % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  using T = __nv_bfloat16;
  const T* args[4] = {static_cast<const T*>(y), static_cast<const T*>(offset),
                      static_cast<const T*>(mask), static_cast<const T*>(bias)};
  T* o = static_cast<T*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  if (kh * kw == kPremulTaps)
    return vec ? launch_premul_kernel<kPremulTaps, 8>(args[0], args[1], args[2], args[3], o, B, H,
                                                      W, Ho, Wo, C_out, kh, kw, stride, pad, dil,
                                                      off_stride, mask_stride, s)
               : launch_premul_kernel<kPremulTaps, 1>(args[0], args[1], args[2], args[3], o, B, H,
                                                      W, Ho, Wo, C_out, kh, kw, stride, pad, dil,
                                                      off_stride, mask_stride, s);
  return vec ? launch_premul_kernel<0, 8>(args[0], args[1], args[2], args[3], o, B, H, W, Ho, Wo,
                                          C_out, kh, kw, stride, pad, dil, off_stride, mask_stride,
                                          s)
             : launch_premul_kernel<0, 1>(args[0], args[1], args[2], args[3], o, B, H, W, Ho, Wo,
                                          C_out, kh, kw, stride, pad, dil, off_stride, mask_stride,
                                          s);
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
//   * kernel A (dx and the lerp-weight gradients): in f32 a persistent,
//     warp-specialised block an SM whose FMA warps compute ds into a ring of
//     shared-memory stages while its scatter warps add each stage's corner
//     gradients into dx; in bf16 one block per (image, 2-D tile of 64 output
//     pixels) sums each corner's gradients for a 16-channel chunk of C_in in
//     a shared-memory window of the input pixels that the tile's taps reach
//     with offsets up to +-R, and adds the window into dx once; both are
//     described before their kernels below;
//   * kernel B (dW), on the forward's warp-specialised design: a block per
//     (tile of (tap, C_in) rows x output channels, split of the batch's
//     pixels) gathers each sampled tile once for all its output channels
//     and accumulates sampled^T . dy; the splits' f32 partial sums are
//     added by a second kernel in split order (no atomics), after the dx
//     kernel's section.
// dx is an f32 buffer the wrapper zeroes and rounds once; dW is f32, rounded
// by the wrapper.
// ---------------------------------------------------------------------------

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

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// The dx pass in f32 (kernel A in f32: dx and the four lerp-weight
// gradients), warp-specialised. Per stage (tap k, chunk of 64 input
// channels) of a tile of output pixels it computes ds_k = dy . W_k^T, then
// scatters ds_k's four corner gradients into dx and sums the lerp-weight
// gradients. It replaced a row design (a non-persistent 256-thread block
// per 64 pixels that ran the two halves in turn, barriers between them, and
// staged the dy tile again for every (tap, chunk, 32 output channels)).
//
// What bounds it on this card: the products, 2 K C_in C_out FLOPs a pixel
// in true f32 FMA (the f32 contract: no TF32), and a scatter of 4 corners x
// K x C_in float adds a pixel into dx in device memory beside the gathers
// of the same corners, both through L2. On an H100 at the KM3D neck's
// shapes the products run at about half the FMA rate, bound with it by
// shared-memory wavefronts (an 8 x 8 register tile needs 16 wavefronts for
// 64 FMAs a warp: the card's 1 wavefront against 4 FMA warp-instructions a
// cycle; a first version's 4 x 4 tiles needed 8 for 16 and ran at 24%); at
// 64 output channels the scatter, whose gathers and adds load L2, is the
// slower side. Fewer adds did not pay in f32 (the bf16 window design below,
// in f32: 59-65 ms over a training step's 16 DCNs, its f32 ds tiles and
// shared memory leaving one block an SM).
//
// The design is the forward's ring with the roles reversed (there producers
// gather and consumers multiply; here FMA warps produce and scatter warps
// consume):
//   * one 512-thread block an SM, persistent over the tiles: (image, 2-D
//     tile of TP = 64 output pixels, TP / tw rows of tw = 8 or 16 as
//     ops/deform_conv.py's dx_plan picks; TP = 32 where 64 does not fit);
//   * FMA groups (kDxWsFmaGroups, two warps each) take the stages in turn;
//     a group's warps compute the stage's ds [TP x 64] in 8 x 8 register
//     tiles (dx_ws_products, one FMA a product, in o order) from the dy
//     tile, copied transposed ([o][pixel]) once per tile, and pieces of 32
//     rows of W_k^T (the wrapper passes W transposed) that arrive by
//     16-byte cp.async, two buffers a group (where the dy tile does not fit
//     beside the rest, a dy piece rides with each W piece instead); they
//     write ds into a ring of kDxWsStages stages in shared memory. The FMA
//     warpgroup takes 152 registers a thread by setmaxnreg, the scatter
//     warpgroups keep 120 (at 128 each the accumulators spilled, at 112 the
//     scatter);
//   * scatter warps (the rest) take (pixel, 4 channels) items of each full
//     stage, all of a thread's items with their corner loads in flight at
//     once: four float4 corner gathers, the lerp gradients (explicitly
//     rounded lerps, as the forward), four float4 atomic adds into dx, and
//     the four lerp-weight sums reduced over a pixel's 16 lanes in 5
//     shuffles into per-(tap, pixel) sums that their owner lanes keep in a
//     shared-memory slot of their own across the tap's chunks and store
//     straight to dwts after the last; a warp's items are the same pixels in
//     every stage, so each warp builds its pixels' corner tables (all taps,
//     int32 element offsets into one image, as the forward) one tile ahead,
//     without a block barrier;
//   * named barriers hand a stage over (full: its group arrives, the
//     scatter warps wait; empty: the reverse); each group has its own
//     barrier for its W pieces, all FMA warps one for the dy tile.
// ---------------------------------------------------------------------------

constexpr int kDxWsThreads = 512;  // a block: FMA warps, then scatter warps
constexpr int kDxWsFmaGroups = 2;  // FMA groups of two warps, each a stage at a time
constexpr int kDxWsStages = 4;     // ds stages of the ring
constexpr int kDxWsCh = 64;        // input channels a stage
constexpr int kDxWsOc = 32;        // output channels a W piece
constexpr int kDxWsPieces = 2;     // W pieces of a group in shared memory: one in flight
// named barriers: stage s is full at 1 + s and empty at 1 + kDxWsStages + s;
// then each FMA group's own, and all FMA warps'
constexpr int kDxBarFma = 1 + 2 * kDxWsStages;
constexpr int kDxBarFmaAll = kDxBarFma + kDxWsFmaGroups;
static_assert(kDxBarFmaAll < 16, "16 named barriers");
// a stage's full and empty barriers must serve one group: two groups at one
// barrier could complete each other's generations
static_assert(kDxWsStages % kDxWsFmaGroups == 0, "the groups take the ring's slots in turn");

// The f32 dx kernel's tile: TP output pixels, FG FMA groups. A group's two
// warps own the two 32 x 64 halves of a stage's ds [TP x 64] (8 x 8 f32
// register tiles, dx_ws_products's layout; at TP = 32 the second warp only
// copies); the scatter threads take G (pixel, 4 channel) items a stage each.
template <int TP, int FG>
struct DxWsCfg {
  static constexpr int FT = 64 * FG, ST = kDxWsThreads - FT;  // FMA, scatter threads
  static constexpr int G = (TP * (kDxWsCh / 4) + ST - 1) / ST;
  static constexpr int kHandoff = 64 + ST;  // a group and the scatter warps
  // rows of the ds stages [pixel][c], the W pieces [o][c] and dy [o][pixel]:
  // 16-byte rows, row stride = 4 mod 32 words (the transposing copies write
  // 32 distinct banks a warp)
  static constexpr int ds_ld = kDxWsCh + 4, w_ld = kDxWsCh + 4, dy_ld = TP + 4;
  static_assert(TP == 32 || TP == 64, "one or two 32-pixel halves");
  static_assert(FG > 0 && 64 * FG < kDxWsThreads && ST % 32 == 0, "whole warps of each role");
};

// Byte offsets of the f32 dx kernel's shared memory: the ds ring, the W
// pieces (each with its dy piece where the dy tile does not fit), the dy
// tile, the corner tables of two tiles [tile][tap][pixel] (int4 offsets,
// then float4 weights), the lerp-weight sums [tap][pixel] (float4).
struct DxWsLayout {
  int tp, dy_resident, oc_pad, pieces, piece_bytes, dy, tables, sums, smem;
};

__host__ __device__ inline DxWsLayout dx_ws_layout(int tp, int K, int C_out, bool dy_resident) {
  DxWsLayout l;
  const int ds_ld = kDxWsCh + 4, w_ld = kDxWsCh + 4, dy_ld = tp + 4;
  l.tp = tp;
  l.dy_resident = dy_resident;
  l.oc_pad = round_up(C_out, kDxWsOc);
  int off = 4 * kDxWsStages * tp * ds_ld;
  l.piece_bytes = 4 * kDxWsOc * (w_ld + (dy_resident ? 0 : dy_ld));
  l.pieces = off;
  off += kDxWsFmaGroups * kDxWsPieces * l.piece_bytes;
  l.dy = off;
  if (dy_resident) off += 4 * l.oc_pad * dy_ld;
  l.tables = off;
  off += 2 * K * tp * 32;
  l.sums = off;
  off += K * tp * 16;
  l.smem = off;
  return l;
}

// The f32 dx kernel's 2-D tile of output pixels: TP = th x tw (tw = 8 or
// 16, ops/deform_conv.py's dx_plan), tiles_x along a row of the map, t =
// (image, tile row, tile column) with the column fastest.
struct DxTile {
  int tw_shift, tiles_x, tpi;  // log2 tw, tiles a row of the map, tiles an image
  __device__ __forceinline__ void origin(long long t, long long& b, int& oy0, int& ox0,
                                         int th) const {
    b = t / tpi;
    const int r = (int)(t - b * tpi);
    oy0 = r / tiles_x * th;
    ox0 = (r - r / tiles_x * tiles_x) << tw_shift;
  }
};

// A dy tile transposed: dst[o * dst_ld + pl] = dyb[p(pl) * C_out + o] for
// o < O and the tile's pixel pl at (oy0 + pl / tw, ox0 + pl % tw), zero
// outside the map and where o >= o_valid (dyb: the image's dy at output
// channel o0); 4-byte cp.async left in flight, by NTH threads (a multiple
// of 32). A warp takes 8 consecutive o x 4 consecutive pixels: it reads 4
// runs of 32 bytes and, with dst_ld = 4 mod 32, writes 32 distinct banks.
// `safe`: a valid address for the copies that read nothing.
template <int O, int TP, int NTH>
__device__ __forceinline__ void copy_dy_transposed(float* dst, int dst_ld, const float* dyb,
                                                   int C_out, int o_valid, int oy0, int ox0,
                                                   int tw_shift, int Ho, int Wo,
                                                   const float* safe, int t) {
  static_assert(O % 8 == 0 && TP % 4 == 0 && NTH % 32 == 0, "whole 8 x 4 blocks, whole warps");
  for (int e = t; e < O * TP; e += NTH) {
    const int blk = e >> 5, ln = e & 31;
    const int o = (blk % (O / 8)) * 8 + (ln & 7), i = (blk / (O / 8)) * 4 + (ln >> 3);
    const int oy = oy0 + (i >> tw_shift), ox = ox0 + (i & ((1 << tw_shift) - 1));
    const bool ok = oy < Ho && ox < Wo && o < o_valid;
    cp_async<4>(dst + o * dst_ld + i, ok ? dyb + ((long long)oy * Wo + ox) * C_out + o : safe, ok);
  }
}

// One W piece's products of an FMA warp: its 32 x 64 tile of ds at pixels
// m0.. += a (dy, [o][pixel], row stride A_LD) . w (W_k^T, [o][c], W_LD)
// over KD output channels, one FMA a product, in o order. Lane (mg, ng) =
// (lane / 8, lane % 8) owns pixels m0 + 8 mg + i (i < 8) and channels
// 4 ng + j, 32 + 4 ng + j (j < 4; acc[8 i + j], acc[8 i + 4 + j]): a quarter
// warp reads one broadcast address of a and one contiguous 128-byte run of
// w, no bank conflict (8 wavefronts of a, 8 of w for 64 FMAs a warp). The
// next o's operands are loaded before this one's FMAs.
template <int KD, int A_LD, int W_LD>
__device__ __forceinline__ void dx_ws_products(float (&acc)[64], const float* a, const float* w,
                                               int m0, int lane) {
  const float* ap = a + m0 + 8 * (lane >> 3);
  const float* wp = w + 4 * (lane & 7);
  auto ld4 = [](const float* p) { return *reinterpret_cast<const float4*>(p); };
  float4 a0 = ld4(ap), a1 = ld4(ap + 4), b0 = ld4(wp), b1 = ld4(wp + 32);
#pragma unroll 2
  for (int o = 0; o < KD; ++o) {
    const int on = o + 1 < KD ? o + 1 : o;
    const float4 na0 = ld4(ap + on * A_LD), na1 = ld4(ap + on * A_LD + 4);
    const float4 nb0 = ld4(wp + on * W_LD), nb1 = ld4(wp + on * W_LD + 32);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[8 * i + j] = fmaf(av[i], bv[j], acc[8 * i + j]);
    a0 = na0;
    a1 = na1;
    b0 = nb0;
    b1 = nb1;
  }
}

// Hopper's per-warpgroup register budget (every warp of a warpgroup runs it):
// the FMA warpgroup takes registers the scatter warpgroups give back.
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
// registers a thread of the FMA warpgroups with FG groups (one warpgroup: 128
// x 152 + 384 x 120 = 65536; two: 256 x 136 + 256 x 120), and of the scatter
// warpgroups; 0: no reallocation (the groups do not fill whole warpgroups)
__host__ __device__ constexpr int dx_fma_regs(int fg) { return fg == 2 ? 152 : fg == 4 ? 136 : 0; }
constexpr int kDxScatterRegs = 120;

// Corner q's gradient at 4 channels c.. into dx (VEC: one float4 atomic;
// else one atomic a channel below C_in).
template <bool VEC>
__device__ __forceinline__ void dx_add_corner(float* dst, const float (&d)[4], int c, int C_in) {
  if constexpr (VEC) {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(d[0], d[1], d[2], d[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < C_in) atomicAdd(dst + j, d[j]);
  }
}

// The sum of s[q] over the 16 lanes of a half warp, for q = 0..3, in 5
// shuffles: lane (lane & 3) == 0 returns the sum for q = 2 bit3 + bit2 of
// its lane id (any value on the others).
__device__ __forceinline__ float reduce4_over_16_lanes(const float (&s)[4], int lane) {
  const bool hi8 = lane & 8, hi4 = lane & 4;
  float k0 = hi8 ? s[2] : s[0], k1 = hi8 ? s[3] : s[1];
  k0 += __shfl_xor_sync(0xffffffffu, hi8 ? s[0] : s[2], 8);
  k1 += __shfl_xor_sync(0xffffffffu, hi8 ? s[1] : s[3], 8);
  float v = hi4 ? k1 : k0;
  v += __shfl_xor_sync(0xffffffffu, hi4 ? k0 : k1, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// One full stage of the scatter warps: channels c0.. of tap k (tables k_idx,
// k_wt), ds from the stage s_ds [pixel][c]. Item e = (pixel e / 16, 4
// channels 4 (e % 16)..): a pixel's items on the 16 lanes of a half warp; a
// thread's G items have their corner loads in flight together. The
// lerp-weight sums of a (pixel, tap) are kept by their owner lanes in
// s_sum_k [pixel][4] across the tap's chunks (first: set, else added) and
// stored to dwts_k [pixel][K][4] after the last (pixels past the map: p
// = P, nothing stored). VEC: C_in % 4 == 0 and 16-byte aligned x and dx.
template <int TP, int FG, bool VEC>
__device__ __forceinline__ void dx_ws_scatter(const float* __restrict__ xb, float* __restrict__ dxb,
                                              int C_in, int c0, const int4* k_idx,
                                              const float4* k_wt, const float* s_ds,
                                              float* s_sum_k, float* __restrict__ dwts_k,
                                              const DxTile& tl, int oy0, int ox0, int Ho, int Wo,
                                              int K, bool first, bool last, int stid, int lane) {
  using C = DxWsCfg<TP, FG>;
  constexpr int groups = kDxWsCh / 4, items = TP * groups, G = C::G;
  int pl[G], c[G];
  bool on[G];
  int4 idx[G];
  float4 wt[G];
  float cv[G][4][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int e = stid + g * C::ST;
    pl[g] = e < items ? e / groups : -1;
    c[g] = c0 + 4 * (e % groups);
    on[g] = pl[g] >= 0 && c[g] < C_in;
    idx[g] = on[g] ? k_idx[pl[g]] : make_int4(-1, -1, -1, -1);
    wt[g] = k_wt[pl[g] >= 0 ? pl[g] : 0];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = comp(idx[g], q);
      if constexpr (VEC) {
        const float4 v = i >= 0 ? __ldg(reinterpret_cast<const float4*>(xb + i + c[g]))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        cv[g][q][0] = v.x; cv[g][q][1] = v.y; cv[g][q][2] = v.z; cv[g][q][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cv[g][q][j] = i >= 0 && c[g] + j < C_in ? __ldg(xb + i + c[g] + j) : 0.f;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4 dsv = on[g] ? *reinterpret_cast<const float4*>(s_ds + pl[g] * C::ds_ld +
                                                                (c[g] - c0))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    const float ds[4] = {dsv.x, dsv.y, dsv.z, dsv.w};
    const float wx0 = wt[g].x, wx1 = wt[g].y, wy0 = wt[g].z, wy1 = wt[g].w;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float(&v)[4][4] = cv[g];
      const float vx0 = __fadd_rn(__fmul_rn(v[0][j], wy0), __fmul_rn(v[2][j], wy1));
      const float vx1 = __fadd_rn(__fmul_rn(v[1][j], wy0), __fmul_rn(v[3][j], wy1));
      const float dvx0 = ds[j] * wx0, dvx1 = ds[j] * wx1;
      s[0] += ds[j] * vx0;
      s[1] += ds[j] * vx1;
      s[2] += dvx0 * v[0][j] + dvx1 * v[1][j];
      s[3] += dvx0 * v[2][j] + dvx1 * v[3][j];
      d[0][j] = dvx0 * wy0;
      d[1][j] = dvx1 * wy0;
      d[2][j] = dvx0 * wy1;
      d[3][j] = dvx1 * wy1;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = comp(idx[g], q);
      if (i >= 0) dx_add_corner<VEC>(dxb + i + c[g], d[q], c[g], C_in);
    }
    float sum = reduce4_over_16_lanes(s, lane);
    if (pl[g] >= 0 && (lane & 3) == 0) {
      const int q = ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
      float* slot = s_sum_k + pl[g] * 4 + q;
      if (!first) sum += *slot;
      if (!last) {
        *slot = sum;
      } else {
        const int oy = oy0 + (pl[g] >> tl.tw_shift);
        const int ox = ox0 + (pl[g] & ((1 << tl.tw_shift) - 1));
        if (oy < Ho && ox < Wo) dwts_k[((long long)oy * Wo + ox) * K * 4 + q] = sum;
      }
    }
  }
}

template <int TP, int FG>
__global__ void __launch_bounds__(kDxWsThreads, 1)
deform_conv_bwd_input_ws_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                                const float* __restrict__ mask, const float* __restrict__ weight_t,
                                const float* __restrict__ dy, float* __restrict__ dx,
                                float* __restrict__ dwts, DcnGeom g, DxWsLayout l, DxTile tl,
                                bool vec_x, bool vec_w) {
  using C = DxWsCfg<TP, FG>;
  extern __shared__ __align__(128) unsigned char dxws_smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int K = g.kh * g.kw, P = g.Ho * g.Wo, th = TP >> tl.tw_shift;
  const long long n_tiles = (long long)g.B * tl.tpi;
  const int n_chunks = (g.C_in + kDxWsCh - 1) / kDxWsCh, per_tile = K * n_chunks;
  const int n_oc = l.oc_pad / kDxWsOc;
  const long long my_tiles =
      n_tiles > blockIdx.x ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = my_tiles * per_tile;  // stages this block runs
  auto slot = [&](long long it) {
    return reinterpret_cast<float*>(dxws_smem) + (it % kDxWsStages) * TP * C::ds_ld;
  };
  // the corner tables of tile j: t_idx + (j & 1) K TP, t_wt + (j & 1) K TP
  int4* t_idx = reinterpret_cast<int4*>(dxws_smem + l.tables);
  float4* t_wt = reinterpret_cast<float4*>(t_idx + 2 * K * TP);
  // the lerp-weight sums [tap][pixel][4], each entry its owner lane's
  float* s_sum = reinterpret_cast<float*>(dxws_smem + l.sums);
  // the FMA warpgroups' 64 accumulators a thread get registers the scatter
  // warpgroups do not need
  constexpr bool kRealloc = dx_fma_regs(FG) > 0;
  if (tid < C::FT) {
    if constexpr (kRealloc) reg_alloc<dx_fma_regs(FG)>();
    // FMA warps: group grp takes the stages it = grp, grp + FG, ...; its
    // warp wm owns pixels 32 wm.. of each
    const int ftid = tid, grp = tid >> 6, gtid = tid & 63, wm = (tid >> 5) & 1;
    const bool rows = 32 * wm < TP;
    float* s_dy = reinterpret_cast<float*>(dxws_smem + l.dy);
    auto piece_w = [&](long long qg) {
      return reinterpret_cast<float*>(dxws_smem + l.pieces +
                                      (grp * kDxWsPieces + qg % kDxWsPieces) * l.piece_bytes);
    };
    auto piece_dy = [&](long long qg) { return piece_w(qg) + kDxWsOc * C::w_ld; };
    const long long n_stages = total > grp ? (total - 1 - grp) / FG + 1 : 0;
    const long long n_pieces = n_stages * n_oc;  // the group's
    // the group's piece qg: W_k^T [o][c] of its stage's tap and chunk (and
    // where dy is not resident, its tile's dy [o][pixel]), output channels
    // o0.. of the piece, by the group's threads
    auto copy_piece = [&](long long qg) {
      const long long itq = grp + qg / n_oc * FG;
      const int jt = (int)(itq % per_tile), k = jt / n_chunks;
      const int c0 = (jt - k * n_chunks) * kDxWsCh, o0 = (int)(qg % n_oc) * kDxWsOc;
      producer_copy<float, kDxWsOc, kDxWsCh, 64>(
          piece_w(qg), C::w_ld, weight_t + ((long long)k * g.C_out + o0) * g.C_in, g.C_in,
          g.C_out - o0, c0, g.C_in, vec_w, gtid);
      if (!l.dy_resident) {
        long long b;
        int oy0, ox0;
        tl.origin(blockIdx.x + itq / per_tile * gridDim.x, b, oy0, ox0, th);
        copy_dy_transposed<kDxWsOc, TP, 64>(piece_dy(qg), C::dy_ld, dy + b * P * g.C_out + o0,
                                            g.C_out, g.C_out - o0, oy0, ox0, tl.tw_shift, g.Ho,
                                            g.Wo, dy, gtid);
      }
    };
    if (n_pieces > 0) copy_piece(0);  // the first piece in flight
    cp_async_commit();
    long long it = grp, qg = 0;
    long long tile_end = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      tile_end += per_tile;
      if (l.dy_resident) {
        // the tile's dy, once, by every FMA thread: all are done with the last one's
        named_bar_sync(kDxBarFmaAll, C::FT);
        long long b;
        int oy0, ox0;
        tl.origin(t, b, oy0, ox0, th);
        for (int o0 = 0; o0 < l.oc_pad; o0 += kDxWsOc)
          copy_dy_transposed<kDxWsOc, TP, C::FT>(s_dy + o0 * C::dy_ld, C::dy_ld,
                                                 dy + b * P * g.C_out + o0, g.C_out,
                                                 g.C_out - o0, oy0, ox0, tl.tw_shift, g.Ho,
                                                 g.Wo, dy, ftid);
        cp_async_wait_all();  // (and the group's piece in flight)
        named_bar_sync(kDxBarFmaAll, C::FT);
      }
      for (; it < tile_end; it += FG) {
        float acc[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] = 0.f;
        for (int jo = 0; jo < n_oc; ++jo, ++qg) {
          // piece qg has landed; the group's barrier shows every thread's
          // copies, and that every thread is done with piece qg - 1, whose
          // buffer takes piece qg + 1
          cp_async_wait_all();
          named_bar_sync(kDxBarFma + grp, 64);
          if (qg + 1 < n_pieces) copy_piece(qg + 1);
          cp_async_commit();
          const float* a = l.dy_resident ? s_dy + jo * kDxWsOc * C::dy_ld : piece_dy(qg);
          if (rows)
            dx_ws_products<kDxWsOc, C::dy_ld, C::w_ld>(acc, a, piece_w(qg), 32 * wm, lane);
        }
        if (it >= kDxWsStages) named_bar_sync(1 + kDxWsStages + it % kDxWsStages, C::kHandoff);
        if (rows) {  // dx_ws_products's layout
          float* ds = slot(it) + (32 * wm + 8 * (lane >> 3)) * C::ds_ld + 4 * (lane & 7);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float4*>(ds + i * C::ds_ld + 32 * h) =
                  make_float4(acc[8 * i + 4 * h], acc[8 * i + 4 * h + 1], acc[8 * i + 4 * h + 2],
                              acc[8 * i + 4 * h + 3]);
        }
        named_bar_arrive(1 + it % kDxWsStages, C::kHandoff);
      }
    }
    cp_async_wait_all();
  } else {
    if constexpr (kRealloc) reg_dealloc<kDxScatterRegs>();
    // scatter warps: per tile the stages, per full stage the scatter. A
    // warp's items are the same pixels in every stage (two a round), and
    // only it reads their corner tables: it builds them itself, one tile
    // ahead, and no scatter warp waits for another
    const int stid = tid - C::FT, wbase = stid & ~31;
    // the corner tables of this warp's pixels of tile t into buffer buf:
    // pixels outside the map get offsets -1 and weights 0 (table_entry at p = P)
    auto build_tables = [&](long long t, int buf) {
      long long b;
      int oy0, ox0;
      tl.origin(t, b, oy0, ox0, th);
      for (int e = lane; e < C::G * 2 * K; e += 32) {
        const int j = e / (2 * K), r = e - j * 2 * K, half = r / K, k = r - half * K;
        const int item = wbase + j * C::ST + 16 * half;  // a half warp's first item
        if (item >= TP * (kDxWsCh / 4)) continue;
        const int pl = item / (kDxWsCh / 4);
        const int oy = oy0 + (pl >> tl.tw_shift), ox = ox0 + (pl & ((1 << tl.tw_shift) - 1));
        const int p = oy < g.Ho && ox < g.Wo ? oy * g.Wo + ox : P;
        table_entry<float>(offset, mask, b, p, k, g, t_idx[(buf * K + k) * TP + pl],
                           t_wt[(buf * K + k) * TP + pl]);
      }
      __syncwarp();
    };
    if (blockIdx.x < n_tiles) build_tables(blockIdx.x, 0);
    long long it = 0;
    int tj = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++tj) {
      long long b;
      int oy0, ox0;
      tl.origin(t, b, oy0, ox0, th);
      const float* xb = x + b * g.H * g.W * g.C_in;
      float* dxb = dx + b * g.H * g.W * g.C_in;
      const int buf = tj & 1;  // (the warp built this tile's tables in it)
      for (int k = 0; k < K; ++k) {
        for (int c0 = 0; c0 < g.C_in; c0 += kDxWsCh, ++it) {
          named_bar_sync(1 + it % kDxWsStages, C::kHandoff);
          const bool first = c0 == 0, last = c0 + kDxWsCh >= g.C_in;
          if (vec_x) {
            dx_ws_scatter<TP, FG, true>(xb, dxb, g.C_in, c0, t_idx + (buf * K + k) * TP,
                                        t_wt + (buf * K + k) * TP, slot(it), s_sum + k * TP * 4,
                                        dwts + (b * P * K + k) * 4, tl, oy0, ox0, g.Ho, g.Wo, K,
                                        first, last, stid, lane);
          } else {
            dx_ws_scatter<TP, FG, false>(xb, dxb, g.C_in, c0, t_idx + (buf * K + k) * TP,
                                         t_wt + (buf * K + k) * TP, slot(it), s_sum + k * TP * 4,
                                         dwts + (b * P * K + k) * 4, tl, oy0, ox0, g.Ho, g.Wo, K,
                                         first, last, stid, lane);
          }
          if (it + kDxWsStages < total)
            named_bar_arrive(1 + kDxWsStages + it % kDxWsStages, C::kHandoff);
          // after the tile's first stage: the next tile's tables (the warp is
          // done with the last tile's), their loads' latency behind the
          // other warps' stages
          if (k == 0 && c0 == 0 && t + gridDim.x < n_tiles)
            build_tables(t + gridDim.x, buf ^ 1);
        }
      }
    }
  }
}

// The f32 dx kernel's tile and dy: 64 pixels with the dy tile resident
// where it fits in shared memory, else dy in pieces, else the same for 32
// pixels (ops/deform_conv.py's dx_f32_plan mirrors this); smem >
// kWsMaxSmem: nothing fits.
inline DxWsLayout dx_ws_plan(int K, int C_out) {
  DxWsLayout l{};
  for (int tp = 64; tp >= 32; tp -= 32)
    for (int resident = 1; resident >= 0; --resident) {
      l = dx_ws_layout(tp, K, C_out, resident != 0);
      if (l.smem <= kWsMaxSmem) return l;
    }
  return l;
}

template <int TP>
int launch_dx_ws_tp(const float* x, const float* offset, const float* mask, const float* weight_t,
                    const float* dy, float* dx, float* dwts, const DcnGeom& g,
                    const DxWsLayout& l, int tile_w, bool vec_x, cudaStream_t stream) {
  // 16-byte copies of the W^T pieces where every row (C_in) starts 16-byte aligned
  const bool vec_w = g.C_in % 4 == 0 && reinterpret_cast<uintptr_t>(weight_t) % 16 == 0;
  const auto kernel = deform_conv_bwd_input_ws_kernel<TP, kDxWsFmaGroups>;
  // set on every launch: the opt-in holds for the current device only
  if (const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
      e != cudaSuccess)
    return (int)e;
  int device = 0, n_sm = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const int tw = tile_w;  // (8 or 16: TP / tw rows)
  DxTile tl;
  tl.tw_shift = 0;
  while ((1 << tl.tw_shift) < tw) ++tl.tw_shift;
  const int th = TP / tw;
  tl.tiles_x = (g.Wo + tw - 1) / tw;
  tl.tpi = tl.tiles_x * ((g.Ho + th - 1) / th);
  const long long n_tiles = (long long)g.B * tl.tpi;
  const unsigned grid = (unsigned)(n_tiles < n_sm ? n_tiles : n_sm);
  kernel<<<grid, kDxWsThreads, l.smem, stream>>>(x, offset, mask, weight_t, dy, dx, dwts, g, l,
                                                  tl, vec_x, vec_w);
  return (int)cudaGetLastError();
}

// weight_t: W^T [K, C_out, C_in]; tile_w: the width of the 2-D pixel tile,
// 8 or 16 (ops/deform_conv.py's dx_plan)
int launch_dx_ws(const float* x, const float* offset, const float* mask, const float* weight_t,
                 const float* dy, float* dx, float* dwts, const DcnGeom& g, int tile_w,
                 bool vec_x, cudaStream_t stream) {
  const DxWsLayout l = dx_ws_plan(g.kh * g.kw, g.C_out);
  if (l.smem > kWsMaxSmem) return (int)cudaErrorInvalidValue;
  if (l.tp == 64)
    return launch_dx_ws_tp<64>(x, offset, mask, weight_t, dy, dx, dwts, g, l, tile_w, vec_x,
                               stream);
  return launch_dx_ws_tp<32>(x, offset, mask, weight_t, dy, dx, dwts, g, l, tile_w, vec_x,
                             stream);
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
// this moves 5.7x fewer adds into device memory than a design that adds
// every corner into dx (the f32 kernel's) and ran a little faster than the
// first such design in bf16; in f32 that design was the faster, and the
// warp-specialised kernel above runs instead. What bounds it is latency:
// 16 warps an SM (shared memory and 123 registers a thread) wait on
// cp.async copies, barriers and shared-memory reads in every phase.
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
  const DcnGeom g{B, H, W, C_in, Ho, Wo, C_out, kh, kw, stride, pad, dil, off_stride, mask_stride};
  if constexpr (std::is_same<T, float>::value) {
    const int err = launch_dx_ws(static_cast<const T*>(x), static_cast<const T*>(offset),
                                 static_cast<const T*>(mask), static_cast<const T*>(weight),
                                 static_cast<const T*>(dy), static_cast<float*>(dx),
                                 static_cast<float*>(dwts), g, tile_w, vec_x,
                                 (cudaStream_t)stream);
    if (err != 0) return err;
  } else {
    const int err = launch_dx_window<T>(x, offset, mask, weight, dy, dx, dwts, H, W, C_in, Ho, Wo,
                                        C_out, kh, kw, stride, pad, dil, off_stride, mask_stride,
                                        tile_w, radius, vec_x, vec_o, B, stream);
    if (err != 0) return err;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  // dW: the split count is the caller's (dw_plan)
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
                       kw, stride, pad, dil, off_stride, mask_stride, false, stream);
}

int vd3d_modulated_deform_conv_bf16(const void* x, const void* offset, const void* mask,
                                    const void* weight, const void* bias, void* out, int B,
                                    int H, int W, int C_in, int Ho, int Wo, int C_out, int kh,
                                    int kw, int stride, int pad, int dil, int off_stride,
                                    int mask_stride, void* stream) {
  return launch<__nv_bfloat16>(x, offset, mask, weight, bias, out, B, H, W, C_in, Ho, Wo,
                               C_out, kh, kw, stride, pad, dil, off_stride, mask_stride, false,
                               stream);
}

// The all-taps forward: arguments as the per-tap one.
int vd3d_modulated_deform_conv_alltaps_bf16(const void* x, const void* offset, const void* mask,
                                            const void* weight, const void* bias, void* out,
                                            int B, int H, int W, int C_in, int Ho, int Wo,
                                            int C_out, int kh, int kw, int stride, int pad,
                                            int dil, int off_stride, int mask_stride,
                                            void* stream) {
  return launch<__nv_bfloat16>(x, offset, mask, weight, bias, out, B, H, W, C_in, Ho, Wo,
                               C_out, kh, kw, stride, pad, dil, off_stride, mask_stride, true,
                               stream);
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

// Backward: x, offset, mask as in the forward, W as in the forward in bf16
// and transposed, [K, C_out, C_in], in f32 (the f32 dx kernel's pieces are
// rows of W_k^T), dy [B,Ho,Wo,C_out] contiguous; dx [B,H,W,C_in] f32, zeroed by the caller; dw [K,C_in,C_out]
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
