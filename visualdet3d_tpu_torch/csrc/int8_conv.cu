// int8 implicit-GEMM convolution for NVIDIA Hopper (sm_90a).
//
// The JAX package has no Pallas kernel for this: its int8 inference runs each
// selected conv as XLA's conv_general_dilated on s8 inputs with s32
// accumulation (visualdet3d_tpu/models/quant.py, _int8_conv :285-306, and the
// stride-2 form _s2d_conv_int8 :254-282, whose s32 result is the direct
// stride-2 conv's). PyTorch has no CUDA int8 convolution, so this kernel is
// the port's. It also covers the int8 probes of tools/probe_pallas_int8.py: the
// s8 GEMM (:34) is a 1x1 conv, the 9-tap shifted accumulate (:56) and the
// concat-576 dot (:85) are one on the concatenated shifted slices.
//
//   acc[b,y,x,n] = sum_{ky,kx,c} xq[b, y*sh - ph + ky*dh, x*sw - pw + kx*dw, c]
//                               * w[n, ky, kx, c]                  (s32)
//   out = acc                                   (raw, s32)
//   out = acc * scale[n] (+ bias[n])            (f32, or rounded to bf16)
//
// with zero outside the image (exact under symmetric quantization: 0 -> 0).
// The input is NHWC s8 (the port's channels_last activations), the weights
// [C_out, kh, kw, C_in] s8 (k = (ky*kw + kx)*C_in + c contiguous), the output
// NHWC. scale = w_scale * act_scale is formed by the caller in f32, as JAX
// forms it; the epilogue multiplies and adds with explicit round-to-nearest
// (__fmul_rn, __fadd_rn: no fused multiply-add), the plain version's order.
//
// As a GEMM: M = B*Ho*Wo output pixels, N = C_out, K = kh*kw*C_in. What bounds
// it on the card: the int8 tensor cores for the wide convs of the stereo path
// (3x3 over 256-1408 channels: hundreds of operations per byte), and behind
// them the L2 traffic that feeds shared memory (a 128 x 256 tile reads 48 KB
// per 8.4 M operations: ~11 TB/s at the peak rate); device memory for the
// 64-channel convs at stride 4. The source has two paths, chosen per shape by
// the plan of ops/int8_conv.py (plan_int8_conv):
//
//   * the wgmma path (stride 1, C_in % 16 == 0, 16-byte aligned bases: every
//     int8 conv of the stereo predict but the two at C_in = 72), described
//     before its kernel below: TMA loads of shifted boxes of the NHWC input
//     and of the weights into a 4-stage ring kept by one producer warp,
//     wgmma.mma_async s8 on two consumer warpgroups, split K where few
//     tiles meet a long K, the epilogue staged through shared memory;
//   * the cp.async path, for every other shape (stride 2, C_in not a multiple
//     of 16, a misaligned base): a block owns a 128-pixel x 128-channel
//     output tile (64 channels where C_out < 128) and walks K in steps of
//     64, gathering its im2col tile [128 x 64] of the input and the weight
//     tile into shared memory with cp.async (16, 8 or 4 bytes a copy, by
//     what C_in and the pointers allow; zero fill for the border, the
//     padding and the K and N tails), three stages deep. Eight warps each
//     compute a 64 x 32 piece (32 x 32 in the 64-channel tile) with
//     mma.sync m16n8k32 (s8 x s8 -> s32), their fragments loaded by
//     ldmatrix. Rows of shared memory are padded to 80 bytes, so the eight
//     rows of an ldmatrix hit 32 distinct banks. A table in shared memory
//     keeps each tile row's image base and top-left input coordinate, so the
//     gather does one division per step (K index -> tap, channel) and none
//     per row.
//
// The same source holds the activation quantize that feeds it,
//
//   xq = clip(rint(x * inv[i % n_inv]), -127, 127)       (s8; x f32 or bf16)
//
// one pass over the activation (read once, written once as s8; memory-bound),
// with the product rounded on its own (__fmul_rn), as torch rounds
// x.float() * inv before its round and clamp.
//
// Plain C interface for ctypes; each entry returns the cudaError_t of the
// launch (0 on success). The launch goes on the caller's stream and does not
// synchronise.
#include <cuda.h>  // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

using namespace vd3d_int8;

constexpr int kBM = 128;        // output pixels per block
constexpr int kBK = 64;         // K per step
constexpr int kRow = kBK + 16;  // padded shared-memory row, bytes
constexpr int kThreads = 256;
constexpr int kStages = 3;

enum Epilogue { kRawS32 = 0, kScaleF32 = 1, kScaleBF16 = 2 };

struct Conv {
  const int8_t* x;
  const int8_t* w;
  void* out;
  const float* scale;
  const float* bias;
  int H, W, C, N, kw, sh, sw, ph, pw, dh, dw, Ho, Wo, K;
  long long M;
};

// Gather step kt of the im2col tile [kBM x kBK] and the weight tile
// [BN x kBK] into one stage.
template <int VEC, int BN>
__device__ __forceinline__ void load_step(const Conv& p, int kt, int8_t* As, int8_t* Bs,
                                          const long long* row_base, const int* row_iy,
                                          const int* row_ix, long long n0) {
  constexpr int kCpr = kBK / VEC;          // copies per row
  constexpr int kRstep = kThreads / kCpr;  // rows between a thread's copies
  const int col = (threadIdx.x % kCpr) * VEC;
  const int r0 = threadIdx.x / kCpr;
  const int k = kt * kBK + col;
  const bool k_ok = k < p.K;
  int ci = 0, dy = 0, dx = 0;
  if (k_ok) {
    const int tap = k / p.C;
    ci = k - tap * p.C;
    const int ky = tap / p.kw;
    dy = ky * p.dh;
    dx = (tap - ky * p.kw) * p.dw;
  }
#pragma unroll 4
  for (int r = r0; r < kBM; r += kRstep) {
    const long long base = row_base[r];
    const int iy = row_iy[r] + dy, ix = row_ix[r] + dx;
    const bool ok = k_ok && base >= 0 && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
    const int8_t* src = ok ? p.x + base + ((long long)iy * p.W + ix) * p.C + ci : p.x;
    int8_t* dst = As + r * kRow + col;
    if constexpr (VEC >= 4) {
      cp_async<VEC>(dst, src, ok);
    } else {
      *dst = ok ? *src : (int8_t)0;
    }
  }
#pragma unroll 4
  for (int r = r0; r < BN; r += kRstep) {
    const long long n = n0 + r;
    const bool ok = k_ok && n < p.N;
    const int8_t* src = ok ? p.w + n * p.K + k : p.w;
    int8_t* dst = Bs + r * kRow + col;
    if constexpr (VEC >= 4) {
      cp_async<VEC>(dst, src, ok);
    } else {
      *dst = ok ? *src : (int8_t)0;
    }
  }
}

template <int EPI>
__device__ __forceinline__ void store_pair(const Conv& p, long long m, int n, int v0, int v1) {
  if (m >= p.M || n >= p.N) return;
  const long long o = m * p.N + n;
  const bool pair = n + 1 < p.N;
  if constexpr (EPI == kRawS32) {
    int* out = static_cast<int*>(p.out) + o;
    if (pair && (p.N % 2 == 0)) {
      *reinterpret_cast<int2*>(out) = make_int2(v0, v1);
    } else {
      out[0] = v0;
      if (pair) out[1] = v1;
    }
  } else {
    float f0 = __fmul_rn(__int2float_rn(v0), p.scale[n]);
    float f1 = pair ? __fmul_rn(__int2float_rn(v1), p.scale[n + 1]) : 0.f;
    if (p.bias != nullptr) {
      f0 = __fadd_rn(f0, p.bias[n]);
      if (pair) f1 = __fadd_rn(f1, p.bias[n + 1]);
    }
    if constexpr (EPI == kScaleF32) {
      float* out = static_cast<float*>(p.out) + o;
      if (pair && (p.N % 2 == 0)) {
        *reinterpret_cast<float2*>(out) = make_float2(f0, f1);
      } else {
        out[0] = f0;
        if (pair) out[1] = f1;
      }
    } else {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + o;
      if (pair && (p.N % 2 == 0)) {
        *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(f0, f1);
      } else {
        out[0] = __float2bfloat16_rn(f0);
        if (pair) out[1] = __float2bfloat16_rn(f1);
      }
    }
  }
}

// ldmatrix.x4: four 8x8 matrices of 16-bit pairs (here 8 rows x 16 s8);
// lane L gives the row address of matrix L / 8, row L % 8.
__device__ __forceinline__ void ldmatrix_x4(int (&r)[4], const int8_t* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// BN = 128: eight warps as 2 (M) x 4 (N), a warp computing 64 x 32;
// BN = 64: 4 x 2 warps of 32 x 32.
template <int VEC, int EPI, int BN>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(Conv p) {
  constexpr int kWarpsN = BN / 32, kWarpsM = 8 / kWarpsN;
  constexpr int kWM = kBM / kWarpsM;       // warp rows
  constexpr int kMT = kWM / 16, kNT = 4;   // m16 and n8 tiles of a warp
  constexpr int kStage = (kBM + BN) * kRow;
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ long long row_base[kBM];
  __shared__ int row_iy[kBM], row_ix[kBM];

  const long long m0 = (long long)blockIdx.x * kBM;
  const long long n0 = (long long)blockIdx.y * BN;
  if (threadIdx.x < kBM) {
    const long long m = m0 + threadIdx.x;
    if (m < p.M) {
      const long long hw = (long long)p.Ho * p.Wo;
      const long long b = m / hw;
      const int r = (int)(m - b * hw);
      const int oy = r / p.Wo, ox = r - (r / p.Wo) * p.Wo;
      row_base[threadIdx.x] = b * p.H * p.W * p.C;
      row_iy[threadIdx.x] = oy * p.sh - p.ph;
      row_ix[threadIdx.x] = ox * p.sw - p.pw;
    } else {
      row_base[threadIdx.x] = -1;
      row_iy[threadIdx.x] = 0;
      row_ix[threadIdx.x] = 0;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp % kWarpsM) * kWM, wn = (warp / kWarpsM) * 32;
  // this lane's ldmatrix row: A (rows +8 for matrices 1, 3; bytes +16 for 2, 3),
  // B (rows +8 for matrices 2, 3; bytes +16 for 1, 3)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;
  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_step<VEC, BN>(p, s, smem + s * kStage, smem + s * kStage + kBM * kRow, row_base,
                         row_iy, row_ix, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < steps) {
      int8_t* st = smem + (nxt % kStages) * kStage;
      load_step<VEC, BN>(p, nxt, st, st + kBM * kRow, row_base, row_iy, row_ix, n0);
    }
    cp_async_commit();
    const int8_t* A = smem + (kt % kStages) * kStage;
    const int8_t* Bt = A + kBM * kRow;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      int a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(a[i], A + (wm + i * 16 + a_row) * kRow + ks + a_col);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        int r[4];
        ldmatrix_x4(r, Bt + (wn + j * 8 + b_row) * kRow + ks + b_col);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_s8(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const long long m = m0 + wm + i * 16 + g;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = (int)n0 + wn + j * 8 + 2 * t;
      store_pair<EPI>(p, m, n, acc[i][j][0], acc[i][j][1]);
      store_pair<EPI>(p, m + 8, n, acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <int VEC, int EPI, int BN>
cudaError_t launch_tile(const Conv& p, cudaStream_t stream) {
  constexpr int smem = kStages * (kBM + BN) * kRow;
  static bool attribute_set = false;  // set once per instance, not at every launch
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_conv_kernel<VEC, EPI, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attribute_set = true;
  }
  const dim3 grid((unsigned)((p.M + kBM - 1) / kBM), (unsigned)((p.N + BN - 1) / BN));
  int8_conv_kernel<VEC, EPI, BN><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// 128 output channels a block where there are as many, else 64.
template <int VEC, int EPI>
cudaError_t launch_epi(const Conv& p, cudaStream_t stream) {
  return p.N >= 128 ? launch_tile<VEC, EPI, 128>(p, stream) : launch_tile<VEC, EPI, 64>(p, stream);
}

template <int VEC>
cudaError_t launch_vec(const Conv& p, int epilogue, cudaStream_t stream) {
  switch (epilogue) {
    case kRawS32: return launch_epi<VEC, kRawS32>(p, stream);
    case kScaleF32: return launch_epi<VEC, kScaleF32>(p, stream);
    case kScaleBF16: return launch_epi<VEC, kScaleBF16>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The widest copy that C_in and the two pointers allow.
int copy_width(const void* x, const void* w, int C) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w);
  for (int v = 16; v >= 4; v /= 2)
    if (C % v == 0 && a % v == 0) return v;
  return 1;
}

// ---------------------------------------------------------------------------
// The wgmma path: stride 1, C_in % 16 == 0, 16-byte aligned x and w (every
// int8 conv of the stereo predict but the two at C_in = 72). The plan
// (ops/int8_conv.py, plan_int8_conv) picks the box, the K step, the N tile
// and the split; this source takes them as they come.
//
//   * A block owns two boxes of 64 output pixels (box_h x box_w, a rectangle
//     of one image's output: whole rows, row segments or an 8x8 patch,
//     whichever wastes least at the map's size) and BN output channels
//     (64, 128 or 256). Boxes are numbered image by image, row of boxes by
//     row of boxes, and a block takes boxes 2t and 2t+1.
//   * K is walked as (tap, channel chunk of BK = 128, 64 or 32 bytes). The A
//     tile of one consumer and one step is ONE TMA load: the box of the NHWC
//     input at (c0, ox0 - pw + kx*dw, oy0 - ph + ky*dh, b). Coordinates
//     outside the image (the padding, the border, a ragged box, a channel
//     tail) are zero-filled by the TMA unit, so the gather has no predicate.
//     The B tile is one TMA load of the [N, K] weights at (tap*C + c0, n0).
//     Both land swizzled (32, 64 or 128-byte swizzle for BK = 32, 64, 128),
//     one row per pixel or output channel, K-major: the layout wgmma takes
//     for 8-bit operands.
//   * Warp 8 is the producer: one thread keeps a ring of 4 stages in flight
//     (full/empty mbarriers, the full one counting the TMA's bytes).
//     Warps 0-3 and 4-7 are two consumer warpgroups, one per box, each
//     running wgmma.mma_async m64nBNk32 s8 x s8 -> s32 on its 64 x BN tile
//     with the accumulators in registers, one wgmma group in flight while
//     the previous stage is released.
//   * Epilogue on the accumulators: the raw s32 sums, acc*scale (+bias) in
//     f32 (__fmul_rn/__fadd_rn), or that rounded to bf16; the tile goes
//     through shared memory (the drained stage ring) and out in 16-byte
//     row pieces, each pixel row masked against the output's bounds.
//   * Split K (the plan's choice where the tiles fill at most a third of
//     the SMs and K runs 64 steps or more; elsewhere, on an H100, the
//     unsplit kernel was faster on the device and needs no zeroing or
//     second pass): block (t, s) takes steps [s*per, (s+1)*per) and adds
//     its s32 partial sums into a zeroed s32 buffer with integer atomics,
//     exact in any order; for a float output a second pass applies scale
//     and bias to the full sums (never to a partial one).
// ---------------------------------------------------------------------------

constexpr int kTmaStages = 4;
constexpr int kTmaThreads = 288;  // consumer warpgroups 0 (warps 0-3), 1 (4-7); producer warp 8
constexpr int kBoxPixels = 64;    // pixels of one box = rows of one consumer's tile

struct TmaConv {
  void* out;
  const float* scale;
  const float* bias;
  int* acc;  // split K: the zeroed s32 sums (the output itself for raw s32)
  int B, Ho, Wo, N, C, kw, ph, pw, dh, dw;
  int box_h, box_w, boxes_x, boxes_per_image, m_boxes;
  int bk, chunks, k_steps, steps_per_split, n_tiles, split;
  int stage_bytes, bar_offset, out_vec;  // out_vec: N * element size % 16 == 0
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are BK bytes
// (BK = the swizzle span): start address, LBO 1 (unused when swizzled), SBO
// = 8 rows, the swizzle (1: 128 B, 2: 64 B, 3: 32 B). The start address
// moves by 32 bytes (2 units) per k32 step inside a row.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int bk) {
  const uint64_t layout = bk == 128 ? 1 : (bk == 64 ? 2 : 3);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * bk) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// D[64 x 64] += A[64 x 32] . B[64 x 32]^T (s8 x s8 -> s32), both K-major
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 32] . B[128 x 32]^T (s8 x s8 -> s32), both K-major
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// D[64 x 256] += A[64 x 32] . B[256 x 32]^T (s8 x s8 -> s32), both K-major
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 64) {
    wgmma_s8_n64(d, a, b);
  } else if constexpr (BN == 128) {
    wgmma_s8_n128(d, a, b);
  } else {
    wgmma_s8_n256(d, a, b);
  }
}

template <int EPI>
struct OutT;
template <>
struct OutT<kRawS32> { using T = int; };
template <>
struct OutT<kScaleF32> { using T = float; };
template <>
struct OutT<kScaleBF16> { using T = __nv_bfloat16; };

template <int EPI>
__device__ __forceinline__ typename OutT<EPI>::T epilogue_value(int v, const float* scale,
                                                                const float* bias, int n) {
  if constexpr (EPI == kRawS32) {
    return v;
  } else {
    float f = __fmul_rn(__int2float_rn(v), scale[n]);
    if (bias != nullptr) f = __fadd_rn(f, bias[n]);
    if constexpr (EPI == kScaleF32) {
      return f;
    } else {
      return __float2bfloat16_rn(f);
    }
  }
}

template <int BN, int EPI>
__global__ void __launch_bounds__(kTmaThreads, BN == 256 ? 1 : 2)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap, TmaConv p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle is a function of the shared-memory address: align the ring
  // to the 128-byte swizzle's 1024-byte period
  const uint32_t raw_addr = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw_addr & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full0 = base + p.bar_offset, empty0 = full0 + 8 * kTmaStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tile = blockIdx.x % p.n_tiles;
  const int m_tile = blockIdx.x / p.n_tiles;
  const int n0 = n_tile * BN;
  const int s_begin = blockIdx.y * p.steps_per_split;
  const int n_steps = min(p.k_steps, s_begin + p.steps_per_split) - s_begin;
  const int bk = p.bk;

  if (tid >= 256) {  // the producer warp
    if (tid == 256) {
      int bb[2], by[2], bx[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = 2 * m_tile + c;  // q >= m_boxes: b = B, wholly outside, zero-filled
        bb[c] = q / p.boxes_per_image;
        const int r = q - bb[c] * p.boxes_per_image;
        by[c] = (r / p.boxes_x) * p.box_h - p.ph;
        bx[c] = (r % p.boxes_x) * p.box_w - p.pw;
      }
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % kTmaStages;
        if (i >= kTmaStages) mbar_wait(empty0 + 8 * st, ((i / kTmaStages) - 1) & 1);
        const int s = s_begin + i;
        const int tap = s / p.chunks, c0 = (s - tap * p.chunks) * bk;
        const int ky = tap / p.kw, kx = tap - ky * p.kw;
        const uint32_t full = full0 + 8 * st, dst = base + st * p.stage_bytes;
        mbar_expect_tx(full, p.stage_bytes);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          tma_load_4d(dst + c * kBoxPixels * bk, &xmap, full, c0, bx[c] + kx * p.dw,
                      by[c] + ky * p.dh, bb[c]);
        tma_load_2d(dst + 2 * kBoxPixels * bk, &wmap, full, tap * p.C + c0, n0);
      }
    }
    return;
  }

  // a consumer warpgroup: box wg of the pair, a 64 x BN tile
  const int wg = tid / 128, t = tid % 128;
  int acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0;
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kTmaStages;
    mbar_wait(full0 + 8 * st, (i / kTmaStages) & 1);
    const uint32_t stage = base + st * p.stage_bytes;
    const uint64_t da = wgmma_desc(stage + wg * kBoxPixels * bk, bk);
    const uint64_t db = wgmma_desc(stage + 2 * kBoxPixels * bk, bk);
    wgmma_fence();
    for (int kk = 0; kk < bk / 32; ++kk) wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();
    // the previous step's products are done: its stage goes back to the producer
    if (i > 0 && t == 0) mbar_arrive(empty0 + 8 * ((i - 1) % kTmaStages));
  }
  wgmma_wait<0>();

  // this thread's accumulators: rows r_lo and r_lo + 8 of the box, columns
  // 8j + 2(lane % 4) + {0, 1} (the wgmma D fragment)
  const int warp = t / 32, lane = t % 32;
  const int r_lo = 16 * warp + lane / 4, col = 2 * (lane % 4);
  const int q = 2 * m_tile + wg;
  const int b = q / p.boxes_per_image, rq = q - b * p.boxes_per_image;
  const int oy0 = (rq / p.boxes_x) * p.box_h, ox0 = (rq % p.boxes_x) * p.box_w;
  // output pixel of box row r, or -1 outside the output
  auto pixel = [&](int r) -> long long {
    const int oy = oy0 + r / p.box_w, ox = ox0 + r % p.box_w;
    if (q >= p.m_boxes || oy >= p.Ho || ox >= p.Wo) return -1;
    return ((long long)b * p.Ho + oy) * p.Wo + ox;
  };

  if (p.split > 1) {  // partial sums: exact integer atomics into the zeroed s32 buffer
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = pixel(r_lo + 8 * h);
      if (m < 0) continue;
      int* dst = p.acc + m * p.N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + col;
        if (n < p.N) atomicAdd(dst + n, acc[4 * j + 2 * h]);
        if (n + 1 < p.N) atomicAdd(dst + n + 1, acc[4 * j + 2 * h + 1]);
      }
    }
    return;
  }

  using T = typename OutT<EPI>::T;
  constexpr int kPitch = BN * (int)sizeof(T) + 16;  // staging row, bytes (padded)
  named_barrier(1, 256);  // both warpgroups are done reading the stage ring
  uint8_t* stg = smem + wg * kBoxPixels * kPitch;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    T* row = reinterpret_cast<T*>(stg + (r_lo + 8 * h) * kPitch);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int nl = 8 * j + col, n = n0 + nl;
      row[nl] = n < p.N ? epilogue_value<EPI>(acc[4 * j + 2 * h], p.scale, p.bias, n) : T{};
      row[nl + 1] =
          n + 1 < p.N ? epilogue_value<EPI>(acc[4 * j + 2 * h + 1], p.scale, p.bias, n + 1) : T{};
    }
  }
  named_barrier(2 + wg, 128);
  T* out = static_cast<T*>(p.out);
  if (p.out_vec) {  // 16-byte pieces of each pixel row
    constexpr int kVec = 16 / (int)sizeof(T), kPieces = BN / kVec;
    for (int e = t; e < kBoxPixels * kPieces; e += 128) {
      const int r = e / kPieces, v = e - r * kPieces;
      const int n = n0 + v * kVec;
      const long long m = pixel(r);
      if (m < 0 || n >= p.N) continue;
      *reinterpret_cast<uint4*>(out + m * p.N + n) =
          *reinterpret_cast<const uint4*>(stg + r * kPitch + v * 16);
    }
  } else {
    for (int e = t; e < kBoxPixels * BN; e += 128) {
      const int r = e / BN, nl = e - r * BN;
      const long long m = pixel(r);
      if (m < 0 || n0 + nl >= p.N) continue;
      out[m * p.N + n0 + nl] = reinterpret_cast<const T*>(stg + r * kPitch)[nl];
    }
  }
}

// Split K, float outputs: out = sums * scale (+ bias), after every split.
template <int EPI>
__global__ void __launch_bounds__(256) int8_conv_finalize_kernel(const int* __restrict__ acc,
                                                                  TmaConv p, long long total) {
  using T = typename OutT<EPI>::T;
  T* out = static_cast<T*>(p.out);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = epilogue_value<EPI>(acc[i], p.scale, p.bias, (int)(i % p.N));
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

CUtensorMapSwizzle swizzle_of(int bk) {
  return bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : (bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int BN, int EPI>
cudaError_t launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap, TmaConv p,
                         cudaStream_t stream) {
  using T = typename OutT<EPI>::T;
  const int ring = kTmaStages * p.stage_bytes;
  const int staging = 2 * kBoxPixels * (BN * (int)sizeof(T) + 16);
  p.bar_offset = ((ring > staging ? ring : staging) + 7) / 8 * 8;
  p.out_vec = (p.N * (int)sizeof(T)) % 16 == 0;
  const int smem = p.bar_offset + 16 * kTmaStages + 1024;  // + the 1024-byte alignment
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(int8_conv_wgmma_kernel<BN, EPI>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               232448);
    if (e != cudaSuccess) return e;
    attribute_set = true;
  }
  const long long tiles = (long long)((p.m_boxes + 1) / 2) * p.n_tiles;
  const dim3 grid((unsigned)tiles, (unsigned)p.split);
  int8_conv_wgmma_kernel<BN, EPI><<<grid, kTmaThreads, smem, stream>>>(xmap, wmap, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.split == 1 || EPI == kRawS32) return e;
  const long long total = (long long)p.B * p.Ho * p.Wo * p.N;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  int8_conv_finalize_kernel<EPI><<<(unsigned)blocks, 256, 0, stream>>>(p.acc, p, total);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_wgmma_epi(const CUtensorMap& xmap, const CUtensorMap& wmap, const TmaConv& p,
                             int epilogue, cudaStream_t stream) {
  switch (epilogue) {
    case kRawS32: return launch_wgmma<BN, kRawS32>(xmap, wmap, p, stream);
    case kScaleF32: return launch_wgmma<BN, kScaleF32>(xmap, wmap, p, stream);
    case kScaleBF16: return launch_wgmma<BN, kScaleBF16>(xmap, wmap, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int8_t quantize_one(float x, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.f), 127.f);
  return (int8_t)__float2int_rn(q);
}

// Four values a thread, grid-stride; n_inv is 1 (a per-tensor scale) or the
// channel count of the innermost axis.
template <typename T>
__global__ void __launch_bounds__(256) quantize_kernel(const T* __restrict__ x,
                                                       const float* __restrict__ inv,
                                                       int8_t* __restrict__ out, long long n,
                                                       int n_inv) {
  const long long stride = (long long)gridDim.x * blockDim.x * 4;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4; i < n; i += stride) {
    if (i + 4 <= n && n_inv % 4 == 0) {
      const int c = (int)(i % n_inv);
      char4 q;
      q.x = quantize_one(to_f32(x[i]), inv[c]);
      q.y = quantize_one(to_f32(x[i + 1]), inv[c + 1]);
      q.z = quantize_one(to_f32(x[i + 2]), inv[c + 2]);
      q.w = quantize_one(to_f32(x[i + 3]), inv[c + 3]);
      *reinterpret_cast<char4*>(out + i) = q;
    } else if (i + 4 <= n && n_inv == 1) {
      const float s = inv[0];
      char4 q;
      q.x = quantize_one(to_f32(x[i]), s);
      q.y = quantize_one(to_f32(x[i + 1]), s);
      q.z = quantize_one(to_f32(x[i + 2]), s);
      q.w = quantize_one(to_f32(x[i + 3]), s);
      *reinterpret_cast<char4*>(out + i) = q;
    } else {
      for (long long j = i; j < i + 4 && j < n; ++j)
        out[j] = quantize_one(to_f32(x[j]), inv[j % n_inv]);
    }
  }
}

template <typename T>
int launch_quantize(const void* x, const void* inv, void* out, long long n, int n_inv,
                    void* stream) {
  long long blocks = (n + 1023) / 1024;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  quantize_kernel<T><<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(inv), static_cast<int8_t*>(out), n,
      n_inv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n] f32 (x_bf16 = 0) or bf16 (1), inv [n_inv] f32, out [n] s8; the
// innermost axis of x has n_inv values when n_inv > 1.
int vd3d_int8_quantize(const void* x, const void* inv, void* out, long long n, int n_inv,
                       int x_bf16, void* stream) {
  if (n <= 0 || n_inv <= 0 || n % n_inv) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 4) return (int)cudaErrorMisalignedAddress;
  return x_bf16 ? launch_quantize<__nv_bfloat16>(x, inv, out, n, n_inv, stream)
                : launch_quantize<float>(x, inv, out, n, n_inv, stream);
}

// x [B,H,W,C] s8, w [N,kh,kw,C] s8, out [B,Ho,Wo,N] (s32, f32 or bf16 by
// epilogue 0, 1, 2); scale [N] f32 (epilogues 1, 2), bias [N] f32 or null.
int vd3d_int8_conv2d(const void* x, const void* w, void* out, const void* scale,
                     const void* bias, int B, int H, int W, int C, int N, int kh, int kw,
                     int sh, int sw, int ph, int pw, int dh, int dw, int Ho, int Wo,
                     int epilogue, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || kh <= 0 || kw <= 0 || sh <= 0 ||
      sw <= 0 || dh <= 0 || dw <= 0 || Ho <= 0 || Wo <= 0 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  if (epilogue != kRawS32 && scale == nullptr) return (int)cudaErrorInvalidValue;
  const long long K = (long long)kh * kw * C;
  const long long M = (long long)B * Ho * Wo;
  if (K > (1LL << 30) || (M + kBM - 1) / kBM > 0x7fffffffLL || (N + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out = out;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.H = H; p.W = W; p.C = C; p.N = N; p.kw = kw;
  p.sh = sh; p.sw = sw; p.ph = ph; p.pw = pw; p.dh = dh; p.dw = dw;
  p.Ho = Ho; p.Wo = Wo; p.K = (int)K; p.M = M;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (copy_width(x, w, C)) {
    case 16: return (int)launch_vec<16>(p, epilogue, s);
    case 8: return (int)launch_vec<8>(p, epilogue, s);
    case 4: return (int)launch_vec<4>(p, epilogue, s);
    default: return (int)launch_vec<1>(p, epilogue, s);
  }
}

// The wgmma path, with the plan of ops/int8_conv.py (plan_int8_conv): x, w,
// out, scale, bias and the shapes as vd3d_int8_conv2d (stride 1); acc: with
// split > 1, the zeroed s32 sums [B*Ho*Wo, N] (the output itself for raw
// s32), else unused; box_h * box_w = 64; bk = 32, 64 or 128 bytes (C >= bk);
// bn = 64, 128 or 256; block (t, s) of the split takes K steps
// [s * steps_per_split, (s + 1) * steps_per_split).
int vd3d_int8_conv2d_wgmma(const void* x, const void* w, void* out, const void* scale,
                           const void* bias, void* acc, int B, int H, int W, int C, int N, int kh,
                           int kw, int ph, int pw, int dh, int dw, int Ho, int Wo, int epilogue,
                           int box_h, int box_w, int bk, int bn, int split, int steps_per_split,
                           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || kh <= 0 || kw <= 0 || dh <= 0 ||
      dw <= 0 || Ho <= 0 || Wo <= 0 || ph < 0 || pw < 0 || box_h <= 0 || box_w <= 0 ||
      box_h * box_w != kBoxPixels || (bk != 32 && bk != 64 && bk != 128) || C < bk ||
      C % 16 != 0 || split <= 0 || steps_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  if (epilogue != kRawS32 && scale == nullptr) return (int)cudaErrorInvalidValue;
  if (split > 1 && (epilogue == kRawS32 ? out : acc) == nullptr) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const long long K = (long long)kh * kw * C;
  const int chunks = (C + bk - 1) / bk;
  const long long k_steps = (long long)kh * kw * chunks;
  if (K > (1LL << 30) || (long long)split * steps_per_split < k_steps ||
      (long long)(split - 1) * steps_per_split >= k_steps || split > 65535)
    return (int)cudaErrorInvalidValue;
  TmaConv p;
  p.out = out;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.acc = static_cast<int*>(epilogue == kRawS32 ? out : acc);
  p.B = B; p.Ho = Ho; p.Wo = Wo; p.N = N; p.C = C; p.kw = kw;
  p.ph = ph; p.pw = pw; p.dh = dh; p.dw = dw;
  p.box_h = box_h; p.box_w = box_w;
  p.boxes_x = (Wo + box_w - 1) / box_w;
  const long long per_image = (long long)p.boxes_x * ((Ho + box_h - 1) / box_h);
  const long long m_boxes = per_image * B;
  const long long tiles = (m_boxes + 1) / 2 * ((N + bn - 1) / bn);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.boxes_per_image = (int)per_image;
  p.m_boxes = (int)m_boxes;
  p.bk = bk; p.chunks = chunks; p.k_steps = (int)k_steps;
  p.steps_per_split = steps_per_split; p.split = split;
  p.n_tiles = (N + bn - 1) / bn;
  p.stage_bytes = (2 * kBoxPixels + bn) * bk;
  p.bar_offset = 0; p.out_vec = 0;

  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap, wmap;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)C, (cuuint64_t)W * C, (cuuint64_t)H * W * C};
  const cuuint32_t xbox[4] = {(cuuint32_t)bk, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), xdims, xstrides, xbox,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(bk),
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t wdims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t wstrides[1] = {(cuuint64_t)K};
  const cuuint32_t wbox[2] = {(cuuint32_t)bk, (cuuint32_t)bn};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), wdims, wstrides, wbox,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(bk),
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return (int)launch_wgmma_epi<64>(xmap, wmap, p, epilogue, s);
    case 128: return (int)launch_wgmma_epi<128>(xmap, wmap, p, epilogue, s);
    case 256: return (int)launch_wgmma_epi<256>(xmap, wmap, p, epilogue, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* vd3d_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
