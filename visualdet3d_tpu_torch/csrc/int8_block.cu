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
// The TPU kernel held a whole padded batch item in VMEM in a flat-row layout
// with pad columns, because Mosaic only took static slice offsets. Here the
// math is kept and space is tiled with a halo. What bounds the block on the
// card: at layer1 of the stereo trunk (batch 16: 32 x 72 x 320 x 64) it does
// 108.7 G int8 operations and moves 47.2 MB of s8 in and 94.4 MB of bf16 out,
// so the tensor cores and the memory bound it about equally (0.055 ms against
// 0.042 ms at 1979 TOPS and 3.35 TB/s). What the design does: every
// intermediate stays on chip. A persistent block (one per SM) loads both
// weight sets (2 x 64 x 576 s8) into shared memory once and walks over output
// tiles of 8 x 32 pixels x 64 channels. For a tile it stages the input with a
// 2-pixel halo (12 x 36 x 64 s8, zero outside the image) by cp.async, the
// next tile's input while this one computes; computes conv1 on the tile plus
// a 1-pixel halo (10 x 34 pixels), requantized to s8 in shared memory, with
// the halo pixels that lie outside the image set to zero (zero padding of h
// for conv2, not conv1 evaluated there: the ok mask of the TPU kernel); then
// conv2 and the epilogue, writing only the output. The products are
// mma.sync m16n8k32 (s8 x s8 -> s32) on fragments read straight from the
// staged tiles (implicit im2col: tap (ky, kx) of output pixel (y, x) is staged
// pixel (y + ky, x + kx)); pixels and weight rows are padded by 16 bytes, so a
// warp's fragment loads hit distinct banks.
//
// Plain C interface for ctypes; the entry returns the cudaError_t of the
// launch (0 on success). The launch goes on the caller's stream and does not
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

using namespace vd3d_int8;

constexpr int C = 64;
constexpr int TH = 8, TW = 32;            // output tile
constexpr int XH = TH + 4, XW = TW + 4;   // staged input: 2-pixel halo
constexpr int RH = TH + 2, RW = TW + 2;   // conv1 region: 1-pixel halo
constexpr int kPix = C + 16;              // bytes per staged pixel
constexpr int kWRow = 9 * C + 16;         // bytes per staged weight row
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

constexpr int kWBytes = C * kWRow;             // one weight set
constexpr int kXBytes = XH * XW * kPix;        // one input tile
constexpr int kHBytes = RH * RW * kPix;        // conv1 tile
constexpr int kSmem = 2 * kWBytes + 2 * kXBytes + kHBytes + 6 * C * (int)sizeof(float);

struct Block {
  const int8_t* xq;
  const int8_t* w1;
  const int8_t* w2;
  const float* params;  // [6, 64]
  void* out;
  int B, H, W, tiles_y, tiles_x, tiles;
};

__device__ __forceinline__ void stage_input(const Block& p, int tile, int8_t* xs) {
  const int per_img = p.tiles_y * p.tiles_x;
  const int b = tile / per_img;
  const int r = tile - b * per_img;
  const int y0 = (r / p.tiles_x) * TH - 2, x0 = (r % p.tiles_x) * TW - 2;
  for (int i = threadIdx.x; i < XH * XW * (C / 16); i += kThreads) {
    const int pix = i / (C / 16), chunk = i % (C / 16);
    const int y = y0 + pix / XW, x = x0 + pix % XW;
    const bool ok = y >= 0 && y < p.H && x >= 0 && x < p.W;
    const int8_t* src = ok ? p.xq + (((long long)b * p.H + y) * p.W + x) * C + chunk * 16 : p.xq;
    cp_async<16>(xs + pix * kPix + chunk * 16, src, ok);
  }
}

// The s32 products of one unit: 16 rows (output pixels r0..r0+15 of a region
// of width rw) x 32 channels (half nh), reading the staged tile src of width
// sw pixels and the weights ws.
__device__ __forceinline__ void conv_unit(const int8_t* src, int sw, int rw, int rows, int mt,
                                          int nh, const int8_t* ws, int (&acc)[4][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = min(mt * 16 + g, rows - 1), r1 = min(mt * 16 + g + 8, rows - 1);
  const int p0 = (r0 / rw) * sw + r0 % rw, p1 = (r1 / rw) * sw + r1 % rw;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3) * sw + tap % 3;
    const int8_t* a0p = src + (p0 + off) * kPix + 4 * t;
    const int8_t* a1p = src + (p1 + off) * kPix + 4 * t;
    const int8_t* bp = ws + (nh * 32 + g) * kWRow + tap * C + 4 * t;
#pragma unroll
    for (int kk = 0; kk < C; kk += 32) {
      const int a0 = lds32(a0p + kk), a1 = lds32(a1p + kk);
      const int a2 = lds32(a0p + kk + 16), a3 = lds32(a1p + kk + 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* b = bp + j * 8 * kWRow + kk;
        mma_s8(acc[j], a0, a1, a2, a3, lds32(b), lds32(b + 16));
      }
    }
  }
}

__device__ __forceinline__ int8_t requant(int acc, float sc, float sh, float inv) {
  float h = __fadd_rn(__fmul_rn(__int2float_rn(acc), sc), sh);
  h = __fmul_rn(fmaxf(h, 0.f), inv);
  h = fminf(fmaxf(rintf(h), -127.f), 127.f);
  return (int8_t)__float2int_rn(h);
}

template <typename T>
__device__ __forceinline__ void store2(T* out, float v0, float v1);
template <>
__device__ __forceinline__ void store2<float>(float* out, float v0, float v1) {
  *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* out, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) int8_block_kernel(Block p) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* w1s = smem;
  int8_t* w2s = w1s + kWBytes;
  int8_t* xs_base = w2s + kWBytes;  // two input tiles, this one and the next
  int8_t* hs = xs_base + 2 * kXBytes;
  float* ps = reinterpret_cast<float*>(hs + kHBytes);

  for (int i = threadIdx.x; i < 2 * C * (9 * C / 16); i += kThreads) {
    const int set = i / (C * 9 * C / 16), rem = i % (C * 9 * C / 16);
    const int n = rem / (9 * C / 16), chunk = rem % (9 * C / 16);
    const int8_t* src = (set ? p.w2 : p.w1) + n * 9 * C + chunk * 16;
    cp_async<16>((set ? w2s : w1s) + n * kWRow + chunk * 16, src, true);
  }
  for (int i = threadIdx.x; i < 6 * C; i += kThreads) ps[i] = p.params[i];
  if ((int)blockIdx.x < p.tiles) stage_input(p, blockIdx.x, xs_base);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    const int8_t* xs = xs_base + (it & 1) * kXBytes;
    const int nxt = tile + gridDim.x;
    if (nxt < p.tiles) stage_input(p, nxt, xs_base + ((it + 1) & 1) * kXBytes);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int per_img = p.tiles_y * p.tiles_x;
    const int b = tile / per_img;
    const int rr = tile - b * per_img;
    const int y0 = (rr / p.tiles_x) * TH, x0 = (rr % p.tiles_x) * TW;

    // conv1 on the 10 x 34 region (staged pixel (ry + ky, rx + kx)),
    // requantized into hs; pixels outside the image are zero
    constexpr int kRows1 = RH * RW, kUnits1 = 2 * ((kRows1 + 15) / 16);
    for (int u = warp; u < kUnits1; u += kWarps) {
      const int mt = u >> 1, nh = u & 1;
      int acc[4][4];
      conv_unit(xs, XW, RW, kRows1, mt, nh, w1s, acc);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + g + 8 * half;
        if (r >= kRows1) continue;
        const int y = y0 - 1 + r / RW, x = x0 - 1 + r % RW;
        const bool inside = y >= 0 && y < p.H && x >= 0 && x < p.W;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = nh * 32 + j * 8 + 2 * t;
          int8_t q0 = 0, q1 = 0;
          if (inside) {
            q0 = requant(acc[j][2 * half], ps[n], ps[C + n], ps[2 * C + n]);
            q1 = requant(acc[j][2 * half + 1], ps[n + 1], ps[C + n + 1], ps[2 * C + n + 1]);
          }
          *reinterpret_cast<short*>(hs + r * kPix + n) =
              (short)(((unsigned)(uint8_t)q1 << 8) | (uint8_t)q0);
        }
      }
    }
    __syncthreads();

    // conv2 on the 8 x 32 tile (conv1 pixel (oy + ky, ox + kx)), the
    // dequantized residual, ReLU, the output
    T* out = static_cast<T*>(p.out);
    constexpr int kRows2 = TH * TW, kUnits2 = 2 * (kRows2 / 16);
    for (int u = warp; u < kUnits2; u += kWarps) {
      const int mt = u >> 1, nh = u & 1;
      int acc[4][4];
      conv_unit(hs, RW, TW, kRows2, mt, nh, w2s, acc);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + g + 8 * half;
        const int oy = r / TW, ox = r % TW;
        const int y = y0 + oy, x = x0 + ox;
        if (y >= p.H || x >= p.W) continue;
        const int8_t* res = xs + ((oy + 2) * XW + ox + 2) * kPix;
        T* o = out + (((long long)b * p.H + y) * p.W + x) * C;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = nh * 32 + j * 8 + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float yf = __fadd_rn(
                __fmul_rn(__int2float_rn(acc[j][2 * half + e]), ps[3 * C + n + e]),
                ps[4 * C + n + e]);
            const float rf = __fmul_rn((float)res[n + e], ps[5 * C + n + e]);
            v[e] = fmaxf(__fadd_rn(yf, rf), 0.f);
          }
          store2<T>(o + n, v[0], v[1]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <typename T>
int launch(const Block& p, int grid, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(int8_block_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  int8_block_kernel<T><<<grid, kThreads, kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xq [B,H,W,64] s8; w1, w2 [64,3,3,64] s8; params [6,64] f32; out [B,H,W,64]
// f32 (out_bf16 = 0) or bf16 (1). grid: the number of persistent blocks
// (the card's SM count).
int vd3d_int8_basic_block(const void* xq, const void* w1, const void* w2, const void* params,
                          void* out, int B, int H, int W, int out_bf16, int grid,
                          void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(w1) |
                      reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(out);
  if (a % 16) return (int)cudaErrorMisalignedAddress;
  Block p;
  p.xq = static_cast<const int8_t*>(xq);
  p.w1 = static_cast<const int8_t*>(w1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.params = static_cast<const float*>(params);
  p.out = out;
  p.B = B; p.H = H; p.W = W;
  p.tiles_y = (H + TH - 1) / TH;
  p.tiles_x = (W + TW - 1) / TW;
  const long long tiles = (long long)B * p.tiles_y * p.tiles_x;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  if (grid > p.tiles) grid = p.tiles;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(p, grid, s) : launch<float>(p, grid, s);
}

const char* vd3d_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
