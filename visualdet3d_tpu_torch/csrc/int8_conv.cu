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
// [C_out, kh, kw, pitch] s8 (k = (ky*kw + kx)*pitch + c contiguous; the
// channel pitch below), the output NHWC. scale = w_scale * act_scale is formed by the caller in f32, as JAX
// forms it; the epilogue multiplies and adds with explicit round-to-nearest
// (__fmul_rn, __fadd_rn: no fused multiply-add), the plain version's order.
//
// As a GEMM: M = B*Ho*Wo output pixels, N = C_out, K = kh*kw*C_in. What bounds
// it on the card: the int8 tensor cores for the wide convs (3x3 over 256-1408
// channels: hundreds of operations per byte), and behind them the L2 traffic
// that feeds shared memory (a 128 x 256 tile reads 48 KB per 8.4 M operations:
// ~11 TB/s at the peak rate); device memory for the 64-72-channel convs at
// strides 4 and 8. Every shape takes the one path described before its kernel
// below (TMA loads of shifted boxes of the NHWC input and of the weights into
// a 4-stage ring kept by one producer warp, wgmma.mma_async s8 on two consumer
// warpgroups, split K where few tiles meet a long K, the epilogue staged
// through shared memory), with the plan of ops/int8_conv.py (plan_int8_conv).
//
// Channel pitch: the input's and the weights' channels are stored in rows of
// `pitch` bytes, a multiple of 16 (the TMA unit's stride unit) and at least
// 32 (one k32 step of wgmma), C_in of them used; Int8Conv2d keeps its
// weights with a zero tail, and the quantize below writes its output so.
// The input's tensor map is C_in channels wide with a `pitch` stride: the
// TMA unit zero-fills every channel past C_in, so the tails are never read
// into a product.
//
// The same source holds the activation quantize that feeds it, which replaces
// XLA's elementwise _quantize_act (visualdet3d_tpu/models/quant.py:396; no
// Pallas kernel),
//
//   xq = clip(rint(x * inv[i % n_inv]), -127, 127)       (s8; x f32 or bf16)
//
// one pass over the activation (read once, written once as s8; memory-bound),
// with the product rounded on its own (__fmul_rn), as torch rounds
// x.float() * inv before its round and clamp; its design is described before
// its kernel below.
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

enum Epilogue { kRawS32 = 0, kScaleF32 = 1, kScaleBF16 = 2 };

// ---------------------------------------------------------------------------
// The convolution. The plan (ops/int8_conv.py, plan_int8_conv) picks the
// box, the K step, the N tile and the split; this source takes them as they
// come. A 1x1 conv without padding comes as one row of B*H*W pixels.
//
//   * A block owns two boxes of 64 output pixels (box_h x box_w, a rectangle
//     of one image's output: whole rows, row segments or an 8x8 patch,
//     whichever wastes least at the map's size) and BN output channels
//     (64, 128 or 256). Boxes are numbered image by image, row of boxes by
//     row of boxes, and a block takes boxes 2t and 2t+1.
//   * K is walked as (tap, channel chunk of BK = 128, 64 or 32 bytes). The A
//     tile of one consumer and one step is ONE TMA load: the box of the NHWC
//     input at (c0, ox0*sw - pw + kx*dw, oy0*sh - ph + ky*dh, b), traversed
//     with element strides (sw, sh) on W and H, so a strided conv loads its
//     box_w x box_h taps densely. Coordinates outside the image (the
//     padding, the border, a ragged box, the channels past C_in) are
//     zero-filled by the TMA unit, so the gather has no predicate.
//     The B tile is one TMA load of the [N, kh*kw*pitch] weights at
//     (tap*pitch + c0, n0); where the chunk runs past the tap's pitch it
//     reads the next tap's weights, which meet the zero-filled A channels.
//     Both land swizzled (32, 64 or 128-byte swizzle for BK = 32, 64, 128),
//     one row per pixel or output channel, K-major: the layout wgmma takes
//     for 8-bit operands.
//   * Warp 8 is the producer: one thread keeps a ring of STAGES stages in
//     flight (full/empty mbarriers, the full one counting the TMA's bytes):
//     4, or 3 where K runs few steps and that lets a second block onto the
//     SM (the plan's `stages`: 128-channel tiles on 128-byte chunks, whose 4
//     stages of 32 KB leave no room for one), so that two blocks' loads hide
//     each other's latency. The count is a template parameter: a runtime one
//     cost the 4-stage kernels 5-7% (int8_study.py b8 on an H100).
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

constexpr int kTmaThreads = 288;  // consumer warpgroups 0 (warps 0-3), 1 (4-7); producer warp 8
constexpr int kBoxPixels = 64;    // pixels of one box = rows of one consumer's tile

struct TmaConv {
  void* out;
  const float* scale;
  const float* bias;
  int* acc;  // split K: the zeroed s32 sums (the output itself for raw s32)
  int B, Ho, Wo, N, pitch, kw, sh, sw, ph, pw, dh, dw;
  int box_h, box_w, boxes_x, boxes_per_image, m_boxes;
  int bk, chunks, k_steps, steps_per_split, n_tiles;  // the split: gridDim.y
  int stage_bytes, bar_offset;
};
// 128 bytes at most: on an H100 one int more (136 bytes) ran the kernel
// 1.45-1.75x slower at every shape timed (int8_study.py params)
static_assert(sizeof(TmaConv) <= 128, "TmaConv: keep the kernel's parameters within 128 bytes");

// wgmma shared-memory descriptor of a K-major tile whose rows are BK bytes
// (BK = the swizzle span): start address, LBO 1 (unused when swizzled), SBO
// = 8 rows, the swizzle (1: 128 B, 2: 64 B, 3: 32 B). The start address
// moves by 32 bytes (2 units) per k32 step inside a row.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int bk) {
  const uint64_t layout = bk == 128 ? 1 : (bk == 64 ? 2 : 3);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * bk) >> 4) << 32) | (layout << 62);
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

template <int BN, int EPI, int STAGES>
__global__ void __launch_bounds__(kTmaThreads, BN == 256 ? 1 : 2)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap, TmaConv p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle is a function of the shared-memory address: align the ring
  // to the 128-byte swizzle's 1024-byte period
  const uint32_t raw_addr = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw_addr & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full0 = base + p.bar_offset, empty0 = full0 + 8 * STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
        by[c] = (r / p.boxes_x) * p.box_h * p.sh - p.ph;
        bx[c] = (r % p.boxes_x) * p.box_w * p.sw - p.pw;
      }
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * st, ((i / STAGES) - 1) & 1);
        const int s = s_begin + i;
        const int tap = s / p.chunks, c0 = (s - tap * p.chunks) * bk;
        const int ky = tap / p.kw, kx = tap - ky * p.kw;
        const uint32_t full = full0 + 8 * st, dst = base + st * p.stage_bytes;
        mbar_expect_tx(full, p.stage_bytes);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          tma_load_4d(dst + c * kBoxPixels * bk, &xmap, full, c0, bx[c] + kx * p.dw,
                      by[c] + ky * p.dh, bb[c]);
        tma_load_2d(dst + 2 * kBoxPixels * bk, &wmap, full, tap * p.pitch + c0, n0);
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
    const int st = i % STAGES;
    mbar_wait(full0 + 8 * st, (i / STAGES) & 1);
    const uint32_t stage = base + st * p.stage_bytes;
    const uint64_t da = wgmma_desc(stage + wg * kBoxPixels * bk, bk);
    const uint64_t db = wgmma_desc(stage + 2 * kBoxPixels * bk, bk);
    wgmma_fence();
    for (int kk = 0; kk < bk / 32; ++kk) wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();
    // the previous step's products are done: its stage goes back to the producer
    if (i > 0 && t == 0) mbar_arrive(empty0 + 8 * ((i - 1) % STAGES));
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

  if (gridDim.y > 1) {  // split K: exact integer atomics into the zeroed s32 buffer
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
  if ((p.N * (int)sizeof(T)) % 16 == 0) {  // 16-byte pieces of each pixel row
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

CUtensorMapSwizzle swizzle_of(int bk) {
  return bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : (bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int BN, int EPI, int STAGES>
cudaError_t launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap, TmaConv p, int split,
                         cudaStream_t stream) {
  using T = typename OutT<EPI>::T;
  const int ring = STAGES * p.stage_bytes;
  const int staging = 2 * kBoxPixels * (BN * (int)sizeof(T) + 16);
  p.bar_offset = ((ring > staging ? ring : staging) + 7) / 8 * 8;
  const int smem = p.bar_offset + 16 * STAGES + 1024;  // + the 1024-byte alignment
  static unsigned long long devices_set = 0;  // per instance
  if (const cudaError_t e =
          opt_in_smem(int8_conv_wgmma_kernel<BN, EPI, STAGES>, 232448, devices_set);
      e != cudaSuccess)
    return e;
  const long long tiles = (long long)((p.m_boxes + 1) / 2) * p.n_tiles;
  const dim3 grid((unsigned)tiles, (unsigned)split);
  int8_conv_wgmma_kernel<BN, EPI, STAGES><<<grid, kTmaThreads, smem, stream>>>(xmap, wmap, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1 || EPI == kRawS32) return e;
  const long long total = (long long)p.B * p.Ho * p.Wo * p.N;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  int8_conv_finalize_kernel<EPI><<<(unsigned)blocks, 256, 0, stream>>>(p.acc, p, total);
  return cudaGetLastError();
}

template <int BN, int STAGES>
cudaError_t launch_wgmma_epi(const CUtensorMap& xmap, const CUtensorMap& wmap, const TmaConv& p,
                             int split, int epilogue, cudaStream_t stream) {
  switch (epilogue) {
    case kRawS32: return launch_wgmma<BN, kRawS32, STAGES>(xmap, wmap, p, split, stream);
    case kScaleF32: return launch_wgmma<BN, kScaleF32, STAGES>(xmap, wmap, p, split, stream);
    case kScaleBF16: return launch_wgmma<BN, kScaleBF16, STAGES>(xmap, wmap, p, split, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The activation quantize: one streaming pass, bound by device memory (2 or 4
// bytes read and 1 written an element, nothing reused).
//
//   * The body goes in vectors of 16 elements: 2 (bf16) or 4 (f32) 16-byte
//     loads issued together, then one 16-byte store of the 16 s8 values.
//   * A base of x that is not 16-byte aligned (a slice of a larger tensor)
//     is taken: a scalar head up to x's first 16-byte boundary, the body, a
//     scalar tail. Where the head leaves the output unaligned, the body
//     stores byte by byte.
//   * The channel of a vector is found without a modulo per element: a
//     thread computes its first vector's channel once; the grid is rounded
//     to a whole number of channel periods (the stride between a thread's
//     vectors a multiple of n_inv) where that keeps at least half the
//     blocks, and then the thread's 16 scales stay in registers; otherwise
//     its channel moves by a fixed step and wraps.
//   * kQBlocksPerSm blocks of 256 threads an SM (the card's count), grid
//     stride. The arithmetic is the plain version's: __fmul_rn(x, inv),
//     rintf, clip to +-127.
// tests/test_torch_int8_block_tiles.py (quantize_plan) mirrors the split and the grid.
// ---------------------------------------------------------------------------

constexpr int kQVec = 16;       // elements of a vector: one 16-byte store
constexpr int kQThreads = 256;
constexpr int kQBlocksPerSm = 8;

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

// 16 values from a 16-byte aligned address, all loads issued first.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kQVec]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __ldg(q + i);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[4 * i] = __uint_as_float(r[i].x);
    v[4 * i + 1] = __uint_as_float(r[i].y);
    v[4 * i + 2] = __uint_as_float(r[i].z);
    v[4 * i + 3] = __uint_as_float(r[i].w);
  }
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[kQVec]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) r[i] = __ldg(q + i);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t w[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // a bf16 is the top half of its f32
      v[8 * i + 2 * k] = __uint_as_float(w[k] << 16);
      v[8 * i + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// The scales of channels c, c + 1, ... (wrapping at n_inv) for one vector.
__device__ __forceinline__ void load_scales(float (&s)[kQVec], const float* inv, int c,
                                            int n_inv) {
#pragma unroll
  for (int e = 0; e < kQVec; ++e) {
    s[e] = __ldg(inv + c);
    if (++c == n_inv) c = 0;
  }
}

template <typename T, bool kPerChannel>
__global__ void __launch_bounds__(kQThreads) quantize_kernel(const T* __restrict__ x,
                                                             const float* __restrict__ inv,
                                                             int8_t* __restrict__ out,
                                                             long long n, int n_inv,
                                                             long long head, long long n_vec,
                                                             int phase_step) {
  const long long tid = (long long)blockIdx.x * kQThreads + threadIdx.x;
  const long long threads = (long long)gridDim.x * kQThreads;
  // the head [0, head) and the tail [head + 16 n_vec, n), element by element
  const long long tail0 = head + n_vec * kQVec;
  const long long scalars = head + (n - tail0);
  for (long long k = tid; k < scalars; k += threads) {
    const long long i = k < head ? k : tail0 + (k - head);
    out[i] = quantize_one(to_f32(x[i]), __ldg(inv + (kPerChannel ? i % n_inv : 0)));
  }
  if (tid >= n_vec) return;
  const T* xb = x + head;
  int8_t* ob = out + head;
  const bool out_aligned = (reinterpret_cast<uintptr_t>(ob) & 15) == 0;
  float s[kQVec];
  int c = 0;
  if constexpr (kPerChannel) {
    c = (int)((head + tid * kQVec) % n_inv);  // once a thread
    load_scales(s, inv, c, n_inv);
  } else {
    const float s0 = __ldg(inv);
#pragma unroll
    for (int e = 0; e < kQVec; ++e) s[e] = s0;
  }
  for (long long v = tid; v < n_vec; v += threads) {
    float xv[kQVec];
    load_vec(xb + v * kQVec, xv);
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[k] |= (uint32_t)(uint8_t)quantize_one(xv[4 * k + e], s[4 * k + e]) << (8 * e);
    }
    int8_t* o = ob + v * kQVec;
    if (out_aligned) {
      *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * k + e] = (int8_t)(w[k] >> (8 * e));
    }
    if constexpr (kPerChannel) {
      if (phase_step != 0) {
        c += phase_step;
        if (c >= n_inv) c -= n_inv;
        load_scales(s, inv, c, n_inv);
      }
    }
  }
}

long long gcd_ll(long long a, long long b) {
  while (b != 0) {
    const long long r = a % b;
    a = b;
    b = r;
  }
  return a;
}

template <typename T>
int launch_quantize(const void* x, const void* inv, void* out, long long n, int n_inv,
                    void* stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  // elements before x's first 16-byte boundary (all of them for a base that
  // is not even element-aligned)
  long long head = xa % sizeof(T) ? n : (long long)((16 - xa % 16) % 16 / sizeof(T));
  if (head > n) head = n;
  const long long n_vec = (n - head) / kQVec;
  const long long scalars = n - n_vec * kQVec;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long work = n_vec > scalars ? n_vec : scalars;
  long long blocks = (work + kQThreads - 1) / kQThreads;
  if (blocks > (long long)sms * kQBlocksPerSm) blocks = (long long)sms * kQBlocksPerSm;
  if (blocks < 1) blocks = 1;
  int phase_step = 0;
  if (n_inv > 1) {
    const long long period = n_inv / gcd_ll(n_inv, (long long)kQVec * kQThreads);
    if (blocks >= period) blocks = blocks / period * period;
    phase_step = (int)((long long)kQVec * kQThreads * blocks % n_inv);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* it = static_cast<const float*>(inv);
  int8_t* ot = static_cast<int8_t*>(out);
  if (n_inv > 1) {
    quantize_kernel<T, true><<<(unsigned)blocks, kQThreads, 0, s>>>(xt, it, ot, n, n_inv, head,
                                                                    n_vec, phase_step);
  } else {
    quantize_kernel<T, false><<<(unsigned)blocks, kQThreads, 0, s>>>(xt, it, ot, n, n_inv, head,
                                                                     n_vec, phase_step);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The pitched quantize: x [rows, C] -> out [rows, pitch] s8, each row's C
// values and then zeros up to the pitch (the conv's channel pitch, a
// multiple of 16: C_in = 72 -> 80, 1025 -> 1040). Bound by device memory as
// the flat pass is.
//
//   * A thread takes one 16-byte vector of the output (16 channels of one
//     row) at a time, grid stride over rows x pitch / 16: every store is 16
//     bytes and aligned, neighbouring threads write neighbouring vectors.
//   * Its 16 inputs start at x + r*C + 16j, whose alignment changes from row
//     to row where a row is not a whole number of 16-byte words (C = 1025
//     in bf16: 2050-byte rows). They are read as the aligned 16-byte words
//     that hold them (3 in bf16, 5 in f32) and shifted into place, a word
//     offset and then __funnelshift_r by the bytes left: no unaligned
//     access; the extra word is the neighbouring thread's too (L1 serves it).
//     The vector that holds a row's last C % 16 channels reads on into the
//     next row the same way and keeps its first C % 16 values.
//   * A vector whose aligned words would reach outside x (at the tensor's
//     two ends) is read element by element: the scalar head and tail.
//     Channels past C are written as 0. The arithmetic is the flat pass's.
// ---------------------------------------------------------------------------

// 16 values from an element-aligned address, through aligned 16-byte loads.
template <typename T>
__device__ __forceinline__ void load_vec_shifted(const T* p, float (&v)[kQVec]) {
  constexpr int kWords = kQVec * (int)sizeof(T) / 4;  // 8 (bf16) or 16 (f32)
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* q = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
  uint32_t w[kWords + 4];
#pragma unroll
  for (int i = 0; i <= kWords / 4; ++i) {
    const uint4 r = __ldg(q + i);
    w[4 * i] = r.x;
    w[4 * i + 1] = r.y;
    w[4 * i + 2] = r.z;
    w[4 * i + 3] = r.w;
  }
  const int wo = (int)(a & 15) >> 2, bits = (int)(a & 3) * 8;
  uint32_t u[kWords + 1];
#pragma unroll
  for (int i = 0; i <= kWords; ++i)
    u[i] = wo == 0 ? w[i] : (wo == 1 ? w[i + 1] : (wo == 2 ? w[i + 2] : w[i + 3]));
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint32_t word = __funnelshift_r(u[i], u[i + 1], bits);
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(word);
    } else {  // a bf16 is the top half of its f32
      v[2 * i] = __uint_as_float(word << 16);
      v[2 * i + 1] = __uint_as_float(word & 0xffff0000u);
    }
  }
}

template <typename T, bool kPerChannel>
__global__ void __launch_bounds__(kQThreads) quantize_pitched_kernel(
    const T* __restrict__ x, const float* __restrict__ inv, int8_t* __restrict__ out,
    int rows, int C, int pitch) {
  constexpr int kSpan = (kQVec * (int)sizeof(T) / 16 + 1) * 16;  // bytes a shifted load reads
  const int per_row = pitch / kQVec;
  const int total = rows * per_row;  // below 2**31 (the entry's check)
  const uintptr_t lo = reinterpret_cast<uintptr_t>(x);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(x + (long long)rows * C);
  const float s0 = kPerChannel ? 0.f : __ldg(inv);
  for (int v = blockIdx.x * kQThreads + threadIdx.x; v < total; v += gridDim.x * kQThreads) {
    const int r = v / per_row;
    const int c0 = (v - r * per_row) * kQVec;
    const T* src = x + (long long)r * C + c0;
    const int n = min(kQVec, C - c0);  // the row's channels in this vector (none past C)
    const uintptr_t a = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
    float xv[kQVec];
    if (n > 0 && a >= lo && a + kSpan <= hi) {
      load_vec_shifted(src, xv);
    } else {
#pragma unroll
      for (int e = 0; e < kQVec; ++e) xv[e] = e < n ? to_f32(src[e]) : 0.f;
    }
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * k + e;
        if (c < n)
          w[k] |= (uint32_t)(uint8_t)quantize_one(xv[c], kPerChannel ? __ldg(inv + c0 + c) : s0)
                  << (8 * e);
      }
    }
    *reinterpret_cast<uint4*>(out + (long long)r * pitch + c0) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T>
int launch_quantize_pitched(const void* x, const void* inv, void* out, int rows, int C,
                            int pitch, int n_inv, void* stream) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)rows * (pitch / kQVec);
  long long blocks = (total + kQThreads - 1) / kQThreads;
  if (blocks > (long long)sms * kQBlocksPerSm) blocks = (long long)sms * kQBlocksPerSm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* it = static_cast<const float*>(inv);
  int8_t* ot = static_cast<int8_t*>(out);
  if (n_inv > 1) {
    quantize_pitched_kernel<T, true><<<(unsigned)blocks, kQThreads, 0, s>>>(xt, it, ot, rows, C,
                                                                           pitch);
  } else {
    quantize_pitched_kernel<T, false><<<(unsigned)blocks, kQThreads, 0, s>>>(xt, it, ot, rows, C,
                                                                            pitch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n] f32 (x_bf16 = 0) or bf16 (1), any base; inv [n_inv] f32; out [n] s8;
// the innermost axis of x has n_inv values when n_inv > 1.
int vd3d_int8_quantize(const void* x, const void* inv, void* out, long long n, int n_inv,
                       int x_bf16, void* stream) {
  if (n <= 0 || n_inv <= 0 || n % n_inv) return (int)cudaErrorInvalidValue;
  return x_bf16 ? launch_quantize<__nv_bfloat16>(x, inv, out, n, n_inv, stream)
                : launch_quantize<float>(x, inv, out, n, n_inv, stream);
}

// x [rows, c] f32 (x_bf16 = 0) or bf16 (1), element-aligned; inv [n_inv] f32,
// n_inv 1 or c; out [rows, pitch] s8, 16-byte aligned, pitch a multiple of 16
// and at least c: each row's c values, then zeros.
int vd3d_int8_quantize_pitched(const void* x, const void* inv, void* out, long long rows, int c,
                               int pitch, int n_inv, int x_bf16, void* stream) {
  if (rows <= 0 || c <= 0 || pitch < c || pitch % kQVec || (n_inv != 1 && n_inv != c) ||
      rows * (pitch / kQVec) >= (1LL << 31) || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(x) % (x_bf16 ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  const int r = (int)rows;
  return x_bf16 ? launch_quantize_pitched<__nv_bfloat16>(x, inv, out, r, c, pitch, n_inv, stream)
                : launch_quantize_pitched<float>(x, inv, out, r, c, pitch, n_inv, stream);
}

// The int8 conv, with the plan of ops/int8_conv.py (plan_int8_conv): x
// [B,H,W,pitch] s8 and w [N,kh,kw,pitch] s8, C of each pitch-byte row used;
// out [B,Ho,Wo,N] (s32, f32 or bf16 by epilogue 0, 1, 2); scale [N] f32
// (epilogues 1, 2), bias [N] f32 or null; acc: with split > 1, the zeroed
// s32 sums [B*Ho*Wo, N] (the output itself for raw s32), else unused;
// box_h * box_w = 64, box_w * sw and box_h * sh at most 256; bk = 32, 64 or
// 128 bytes; bn = 64, 128 or 256; stages 4, or 3 at bn = 128; block (t, s) of
// the split takes K steps [s * steps_per_split, (s + 1) * steps_per_split).
int vd3d_int8_conv2d_wgmma(const void* x, const void* w, void* out, const void* scale,
                           const void* bias, void* acc, int B, int H, int W, int C, int pitch,
                           int N, int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw,
                           int Ho, int Wo, int epilogue, int box_h, int box_w, int bk, int bn,
                           int stages, int split, int steps_per_split, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || kh <= 0 || kw <= 0 || sh <= 0 ||
      sw <= 0 || sh > 8 || sw > 8 || dh <= 0 || dw <= 0 || Ho <= 0 || Wo <= 0 || ph < 0 ||
      pw < 0 || box_h <= 0 || box_w <= 0 || box_h * box_w != kBoxPixels || box_h * sh > 256 ||
      box_w * sw > 256 || (bk != 32 && bk != 64 && bk != 128) || pitch < C || pitch < 32 ||
      pitch % 16 != 0 || (stages != 4 && !(stages == 3 && bn == 128)) || split <= 0 ||
      steps_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  if (epilogue != kRawS32 && scale == nullptr) return (int)cudaErrorInvalidValue;
  if (split > 1 && (epilogue == kRawS32 ? out : acc) == nullptr) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const long long K = (long long)kh * kw * pitch;
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
  p.B = B; p.Ho = Ho; p.Wo = Wo; p.N = N; p.pitch = pitch; p.kw = kw;
  p.sh = sh; p.sw = sw; p.ph = ph; p.pw = pw; p.dh = dh; p.dw = dw;
  p.box_h = box_h; p.box_w = box_w;
  p.boxes_x = (Wo + box_w - 1) / box_w;
  const long long per_image = (long long)p.boxes_x * ((Ho + box_h - 1) / box_h);
  const long long m_boxes = per_image * B;
  const long long tiles = (m_boxes + 1) / 2 * ((N + bn - 1) / bn);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.boxes_per_image = (int)per_image;
  p.m_boxes = (int)m_boxes;
  p.bk = bk; p.chunks = chunks; p.k_steps = (int)k_steps;
  p.steps_per_split = steps_per_split;
  p.n_tiles = (N + bn - 1) / bn;
  p.stage_bytes = (2 * kBoxPixels + bn) * bk;
  p.bar_offset = 0;

  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap, wmap;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  // C channels wide, pitch bytes apart: the channels past C are zero-filled
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)pitch, (cuuint64_t)W * pitch,
                                  (cuuint64_t)H * W * pitch};
  // a box of box_w x box_h taps, every sw-th column and sh-th row
  const cuuint32_t xbox[4] = {(cuuint32_t)bk, (cuuint32_t)(box_w * sw), (cuuint32_t)(box_h * sh),
                              1};
  const cuuint32_t xsteps[4] = {1, (cuuint32_t)sw, (cuuint32_t)sh, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), xdims, xstrides, xbox,
             xsteps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(bk),
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
    case 64: return (int)launch_wgmma_epi<64, 4>(xmap, wmap, p, split, epilogue, s);
    case 128:
      return (int)(stages == 3 ? launch_wgmma_epi<128, 3>(xmap, wmap, p, split, epilogue, s)
                               : launch_wgmma_epi<128, 4>(xmap, wmap, p, split, epilogue, s));
    case 256: return (int)launch_wgmma_epi<256, 4>(xmap, wmap, p, split, epilogue, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* vd3d_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
