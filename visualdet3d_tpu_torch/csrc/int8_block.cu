// Fused int8 identity BasicBlock (64 channels) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel visualdet3d_tpu/ops/int8_block.py::_block_kernel
// (launched by int8_basic_block_fused): for the quantized input xq (s8, NHWC,
// C = 64) of a stride-1 BasicBlock with both 3x3 convs quantized,
//
//   acc1 = conv3x3(xq, w1)                                  (s32, zero padding)
//   h    = relu(acc1 * p[0] + p[1]) * p[2]                  (f32; p[2] = 1/act2)
//   hq   = clip(rint(h), -127, 127)                         (s8; 0 outside the image)
//   acc2 = conv3x3(hq, w2)                                  (s32)
//   out  = relu((acc2 * p[3] + p[4]) + xq * p[5])           (f32 or bf16; p[5] = act1)
//
// p[0] = w1_scale*act1*bn1_scale, p[1] = bn1_shift, p[3] = w2_scale*act2*bn2_scale,
// p[4] = bn2_shift, formed by the caller in f32 as the JAX wrapper forms them.
// Each product and sum is rounded on its own (__fmul_rn, __fadd_rn), in the
// plain version's order. The residual is the dequantized input xq * act1, as
// in the TPU kernel.
//
// What bounds it on the card: at layer1 of the stereo trunk (batch 16: 32 x
// 72 x 320 x 64) it does 108.7 G int8 operations and moves 47.2 MB of s8 in
// and 94.4 MB of bf16 out, so the tensor cores and the memory bound it about
// equally (0.055 ms against 0.042 ms at 1979 TOPS and 3.35 TB/s). What the
// design does (ops/int8_block.py, block_plan, mirrors its tiles and grid):
//
//   * Every intermediate stays on chip. A persistent block (one an SM) holds
//     both weight sets (2 x 64 x 576 s8) in shared memory for its whole life
//     and walks over output tiles of TH = 6 rows x TW = 64 pixels.
//   * The TPU kernel's flat-row layout, kept for a reason of its own: the
//     staged input tile (TH + 4 rows, 2-pixel halo) and conv1's output hq
//     (TH + 2 rows, 1-pixel halo) share one row pitch P = TW + 4, so tap
//     (ky, kx) of flat position q reads staged position q + ky*P + kx. Each
//     tap's A operand is then the tile itself with its start moved by whole
//     pixels: implicit im2col without a copy. conv1 runs over the flat
//     region in 64-position units (the positions past the region's width,
//     and past its last row, are computed and discarded); conv2 runs one
//     unit per output row (64 pixels, none discarded).
//   * Shared memory holds operands in wgmma's non-swizzled K-major layout as
//     16-byte channel planes [chunk][position][16 B]: a core matrix (8
//     positions x 16 channels) is 128 contiguous bytes, so a start moved by
//     one pixel (16 bytes) is a legal descriptor start and every core matrix
//     read hits 32 distinct banks. The K-adjacent core matrix is one plane
//     on (LBO), the next 8 rows 128 bytes on (SBO). The weights are planes
//     [tap][chunk][output channel][16 B].
//   * Products: wgmma.mma_async m64n64k32 s8 x s8 -> s32, N = all 64 output
//     channels, 18 an output unit (9 taps x 2 k-steps), A and B from shared
//     memory.
//   * The input tile comes by TMA: a 5-D tensor map of xq (16 bytes, chunk,
//     W, H, B) whose out-of-bounds fill is the zero halo, one box a channel
//     plane, into a 2-stage ring kept by one producer thread (full/empty
//     mbarriers), so the next tile lands while this one computes.
//   * Three consumer warpgroups share a tile: conv1's 9 units and conv2's 6
//     rows, 3 and 2 each, on two accumulator sets (a unit's products run
//     while the one before it is requantized or stored). conv1's
//     accumulators are requantized from registers into hq (0 outside the
//     image and at the discarded positions: the TPU kernel's ok mask, not
//     conv1 evaluated there). One barrier waits for every consumer's hq rows
//     before conv2; another, once a consumer's first conv1 unit of a tile is
//     done, for every consumer's conv2 reads of the last tile's hq.
//   * Measured on an H100 (int8_study.py variants): the products alone take
//     about 70% of the int8 peak for the work computed (A and B both read
//     from shared memory); the two epilogues add to them almost in full,
//     because the barriers keep the three consumers in step. A third
//     accumulator set, and issuing the next tile's first units before this
//     tile's last row is stored, were slower.
//   * The epilogue (conv2's scale and shift, the residual from the staged
//     tile, ReLU) goes through a per-warpgroup staging buffer (64 pixels x
//     128 bytes, 16-byte chunks XOR-swizzled by the pixel, so the writes
//     and the reads hit 32 distinct banks) and out in 16-byte pieces, each
//     masked at the image's edges; f32 in two passes of 32 channels.
//
// Plain C interface for ctypes; the entry returns the cudaError_t of the
// launch (0 on success). The launch goes on the caller's stream and does not
// synchronise.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

using namespace vd3d_int8;

constexpr int C = 64;
constexpr int TH = 6, TW = 64;                   // output tile: rows x pixels
constexpr int P = TW + 4;                        // row pitch of the staged tile and of hq
constexpr int XR = TH + 4;                       // staged rows (2-pixel halo)
constexpr int kUnits1 = ((TH + 2) * P + 63) / 64;  // conv1's 64-position units
constexpr int kUnits2 = TH;                      // conv2: one unit an output row
constexpr int kWGs = 3;                          // consumer warpgroups
constexpr int kThreads = 128 * kWGs + 32;        // + the producer warp
// staged positions: the last conv1 unit's last tap reads position
// 64 kUnits1 - 1 + 2P + 2; the TMA box fills XR * P of them, the rest is
// read only for discarded positions
constexpr int kXPos = (64 * kUnits1 + 2 * P + 2 + 7) / 8 * 8;
constexpr int kHPos = 64 * kUnits1;              // hq positions conv1 writes
constexpr int kWPlane = C * 16;                  // weights: one (tap, chunk) plane
constexpr int kWBytes = 9 * 4 * kWPlane;         // one weight set
constexpr int kXPlane = kXPos * 16, kXBytes = 4 * kXPlane;
constexpr int kHPlane = kHPos * 16, kHBytes = 4 * kHPlane;
constexpr int kStgBytes = 64 * 128;              // a warpgroup's output staging
constexpr int kOffX = 2 * kWBytes;
constexpr int kOffH = kOffX + 2 * kXBytes;
constexpr int kOffStg = kOffH + kHBytes;
constexpr int kOffP = kOffStg + kWGs * kStgBytes;
constexpr int kOffBar = kOffP + 6 * C * (int)sizeof(float);
constexpr int kSmem = kOffBar + 4 * 8 + 128;     // + the 128-byte alignment of the base
constexpr uint32_t kBoxBytes = 16 * P * XR;      // one channel plane of a staged tile

static_assert(kUnits1 == 3 * kWGs && kUnits2 == 2 * kWGs,
              "a consumer takes 3 conv1 units and 2 conv2 rows a tile");
static_assert(kXPlane % 128 == 0 && kHPlane % 128 == 0 && kOffH % 128 == 0 &&
              kOffStg % 128 == 0, "TMA destinations and planes 128-byte aligned");
static_assert(64 * kUnits1 >= (TH + 2) * P, "conv1 covers hq's rows");
static_assert((TH + 1) * P + 2 + 64 <= kHPos, "conv2 reads only what conv1 wrote");
static_assert(kSmem <= 232448, "227 KB of shared memory a block");

struct Block {
  const int8_t* w1;
  const int8_t* w2;
  const float* params;  // [6, 64]
  void* out;
  int H, W, tiles_y, tiles_x, tiles;
};

// wgmma descriptor of a non-swizzled K-major operand: start address, LBO
// (the K-adjacent core matrix: the next channel plane), SBO (the next 8 rows:
// 128 bytes), layout 0.
__device__ __forceinline__ uint64_t plane_desc(uint32_t addr, uint32_t plane_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(plane_bytes >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// Issue the products of one 64-row unit as one wgmma group (not waited
// for; the first product overwrites acc): rows pos0 .. pos0 + 63 of the flat layout whose planes start at
// a_base (plane stride A_PLANE), each tap's A the same planes from
// pos0 + ky*P + kx; weights at w_base.
template <int A_PLANE>
__device__ __forceinline__ void issue_unit(int (&acc)[32], uint32_t a_base, int pos0,
                                           uint32_t w_base) {
  const uint64_t da = plane_desc(a_base + pos0 * 16, A_PLANE);
  const uint64_t db = plane_desc(w_base, kWPlane);
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3) * P + tap % 3;  // pixels = 16-byte units
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_s8_n64(acc, da + off + kk * (2 * A_PLANE >> 4),
                   db + (tap * 4 + 2 * kk) * (kWPlane >> 4), tap + kk > 0);
  }
  wgmma_commit();
}

// relu(acc * sc + sh) * inv rounded half to even and clipped to +-127; the
// clip after the conversion (which saturates) equals the plain version's
// clip before it for every finite value
__device__ __forceinline__ int8_t requant(int acc, float sc, float sh, float inv) {
  float h = __fadd_rn(__fmul_rn(__int2float_rn(acc), sc), sh);
  h = __fmul_rn(fmaxf(h, 0.f), inv);
  return (int8_t)max(min(__float2int_rn(h), 127), -127);
}

template <typename T>
__device__ __forceinline__ void stage2(uint8_t* p, float v0, float v1);
template <>
__device__ __forceinline__ void stage2<float>(uint8_t* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void stage2<__nv_bfloat16>(uint8_t* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

struct TileAt {
  int b, y0, x0;
};

__device__ __forceinline__ TileAt tile_at(const Block& p, int tile) {
  const int per_img = p.tiles_y * p.tiles_x;
  const int b = tile / per_img;
  const int r = tile - b * per_img;
  return {b, (r / p.tiles_x) * TH, (r % p.tiles_x) * TW};
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    int8_block_kernel(const __grid_constant__ CUtensorMap xmap, Block p) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const uint32_t base = smem_addr(smem);
  const uint32_t full0 = base + kOffBar, empty0 = full0 + 16;
  float* ps = reinterpret_cast<float*>(smem + kOffP);
  const int tid = threadIdx.x;

  // both weight sets into planes [set][tap][chunk][n][16 B] (w is [n][tap][c])
  for (int i = tid; i < 2 * C * 36; i += kThreads) {
    const int set = i / (C * 36), r = i - set * (C * 36);
    const int n = r / 36, plane = r - n * 36;  // plane = tap * 4 + chunk
    cp_async<16>(smem + set * kWBytes + plane * kWPlane + n * 16,
                 (set ? p.w2 : p.w1) + n * 9 * C + plane * 16, true);
  }
  cp_async_commit();
  for (int i = tid; i < 6 * C; i += kThreads) ps[i] = p.params[i];
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait<0>();
  fence_proxy_async();  // the weights, for wgmma
  __syncthreads();

  if (tid >= 128 * kWGs) {  // the producer warp: one thread keeps the ring
    if (tid == 128 * kWGs) {
      int i = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++i) {
        const int s = i & 1;
        if (i >= 2) mbar_wait(empty0 + 8 * s, ((i >> 1) + 1) & 1);
        const TileAt at = tile_at(p, tile);
        const uint32_t full = full0 + 8 * s, dst = base + kOffX + s * kXBytes;
        mbar_expect_tx(full, 4 * kBoxBytes);
#pragma unroll
        for (int chunk = 0; chunk < 4; ++chunk)
          tma_load_5d(dst + chunk * kXPlane, &xmap, full, 0, chunk, at.x0 - 2, at.y0 - 2, at.b);
      }
    }
    return;
  }

  const int wg = tid / 128, t = tid % 128;
  const int r_lo = 16 * (t / 32) + (t % 32) / 4, col = 2 * (t % 4);
  uint8_t* hs = smem + kOffH;
  uint8_t* stg = smem + kOffStg + wg * kStgBytes;
  T* out = static_cast<T*>(p.out);
  int i = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++i) {
    const int s = i & 1;
    const TileAt at = tile_at(p, tile);
    const uint32_t xs_addr = base + kOffX + s * kXBytes;
    const uint8_t* xs = smem + kOffX + s * kXBytes;

    // conv1 unit u requantized into hq (0 outside the image and at the
    // discarded positions)
    auto requant_unit = [&](const int(&acc)[32], int u) {
      bool inside[2];
      int q[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        q[h] = 64 * u + r_lo + 8 * h;
        const int rr = q[h] / P, cc = q[h] - rr * P;
        const int y = at.y0 - 1 + rr, x = at.x0 - 1 + cc;
        inside[h] = rr < TH + 2 && cc < TW + 2 && y >= 0 && y < p.H && x >= 0 && x < p.W;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + col;
        const float2 sc = *reinterpret_cast<const float2*>(ps + n);
        const float2 sh = *reinterpret_cast<const float2*>(ps + C + n);
        const float2 iv = *reinterpret_cast<const float2*>(ps + 2 * C + n);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int8_t q0 = 0, q1 = 0;
          if (inside[h]) {
            q0 = requant(acc[4 * j + 2 * h], sc.x, sh.x, iv.x);
            q1 = requant(acc[4 * j + 2 * h + 1], sc.y, sh.y, iv.y);
          }
          *reinterpret_cast<uint16_t*>(hs + (j >> 1) * kHPlane + q[h] * 16 + (n & 15)) =
              (uint16_t)(((unsigned)(uint8_t)q1 << 8) | (uint8_t)q0);
        }
      }
    };

    // conv2's output row oy: scale and shift, the residual, ReLU, through
    // the staging buffer to the output
    auto store_row = [&](const int(&acc)[32], int oy) {
      const int y = at.y0 + oy;
      constexpr int kPasses = (int)sizeof(T) / 2;  // 128-byte staging rows: bf16 1, f32 2
      constexpr int kJ = 8 / kPasses;              // n8 column groups a pass
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass) {
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int j = pass * kJ + jj, n = 8 * j + col;
          const float2 sc = *reinterpret_cast<const float2*>(ps + 3 * C + n);
          const float2 sh = *reinterpret_cast<const float2*>(ps + 4 * C + n);
          const float2 a1 = *reinterpret_cast<const float2*>(ps + 5 * C + n);
          const int byte = (n - pass * (C / kPasses)) * (int)sizeof(T);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int px = r_lo + 8 * h;
            const uint16_t r2 = *reinterpret_cast<const uint16_t*>(
                xs + (j >> 1) * kXPlane + ((oy + 2) * P + px + 2) * 16 + (n & 15));
            const float yf0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sc.x), sh.x);
            const float yf1 =
                __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sc.y), sh.y);
            const float rf0 = __fmul_rn((float)(int8_t)(r2 & 0xff), a1.x);
            const float rf1 = __fmul_rn((float)(int8_t)(r2 >> 8), a1.y);
            stage2<T>(stg + px * 128 + (((byte >> 4) ^ (px & 7)) << 4) + (byte & 15),
                      fmaxf(__fadd_rn(yf0, rf0), 0.f), fmaxf(__fadd_rn(yf1, rf1), 0.f));
          }
        }
        named_barrier(3 + wg, 128);
        if (y < p.H) {
          uint8_t* row = reinterpret_cast<uint8_t*>(out + ((long long)at.b * p.H + y) * p.W * C);
#pragma unroll
          for (int e = t; e < 64 * 8; e += 128) {
            const int px = e >> 3, v = e & 7;
            if (at.x0 + px < p.W)
              *reinterpret_cast<uint4*>(row + ((long long)(at.x0 + px) * C) * sizeof(T) +
                                        pass * 128 + v * 16) =
                  *reinterpret_cast<const uint4*>(stg + px * 128 + ((v ^ (px & 7)) << 4));
          }
        }
        named_barrier(3 + wg, 128);  // the staging is free again
      }
    };

    // units u = wg, wg + 3, wg + 6 of conv1 and rows wg, wg + 3 of conv2, two
    // accumulator sets: the next unit's products run while this one's
    // epilogue does
    int acc0[32], acc1[32];
    mbar_wait(full0 + 8 * s, (i >> 1) & 1);
    issue_unit<kXPlane>(acc0, xs_addr, 64 * wg, base);
    issue_unit<kXPlane>(acc1, xs_addr, 64 * (wg + kWGs), base);
    wgmma_wait<1>();
    named_barrier(1, 128 * kWGs);  // every consumer's conv2 of the last tile is done
    requant_unit(acc0, wg);
    issue_unit<kXPlane>(acc0, xs_addr, 64 * (wg + 2 * kWGs), base);
    wgmma_wait<1>();
    requant_unit(acc1, wg + kWGs);
    wgmma_wait<0>();
    requant_unit(acc0, wg + 2 * kWGs);
    fence_proxy_async();           // hq, for wgmma
    named_barrier(2, 128 * kWGs);  // every consumer's hq rows are written

    issue_unit<kHPlane>(acc0, base + kOffH, wg * P, base + kWBytes);
    issue_unit<kHPlane>(acc1, base + kOffH, (wg + kWGs) * P, base + kWBytes);
    wgmma_wait<1>();
    store_row(acc0, wg);
    wgmma_wait<0>();
    store_row(acc1, wg + kWGs);
    // this consumer's reads of the staged tile are done: its stage goes back
    if (t == 0) mbar_arrive(empty0 + 8 * s);
  }
}

template <typename T>
int launch(const CUtensorMap& xmap, const Block& p, int grid, cudaStream_t stream) {
  static unsigned long long devices_set = 0;  // per instance
  if (const cudaError_t e = opt_in_smem(int8_block_kernel<T>, kSmem, devices_set);
      e != cudaSuccess)
    return (int)e;
  int8_block_kernel<T><<<grid, kThreads, kSmem, stream>>>(xmap, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xq [B,H,W,64] s8; w1, w2 [64,3,3,64] s8; params [6,64] f32; out [B,H,W,64]
// f32 (out_bf16 = 0) or bf16 (1). grid: the number of persistent blocks
// (ops/int8_block.py, block_plan: the card's SM count, at most the tiles).
int vd3d_int8_basic_block(const void* xq, const void* w1, const void* w2, const void* params,
                          void* out, int B, int H, int W, int out_bf16, int grid,
                          void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(w1) |
                      reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(out);
  if (a % 16) return (int)cudaErrorMisalignedAddress;
  Block p;
  p.w1 = static_cast<const int8_t*>(w1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.params = static_cast<const float*>(params);
  p.out = out;
  p.H = H; p.W = W;
  p.tiles_y = (H + TH - 1) / TH;
  p.tiles_x = (W + TW - 1) / TW;
  const long long tiles = (long long)B * p.tiles_y * p.tiles_x;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  if (grid > p.tiles) grid = p.tiles;

  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // xq as (16 bytes, chunk, W, H, B): a box is one channel plane of a staged tile
  CUtensorMap xmap;
  const cuuint64_t dims[5] = {16, 4, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[4] = {16, (cuuint64_t)C, (cuuint64_t)W * C, (cuuint64_t)H * W * C};
  const cuuint32_t box[5] = {16, 1, (cuuint32_t)P, (cuuint32_t)XR, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(xq), dims, strides, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(xmap, p, grid, s) : launch<float>(xmap, p, grid, s);
}

const char* vd3d_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
