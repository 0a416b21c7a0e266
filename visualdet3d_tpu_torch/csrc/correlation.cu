// Correlation (PSM cosine) cost volume for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels visualdet3d_tpu/ops/cost_volume.py::_corr_kernel_eyes
// (interleaved dual-eye input, launched by correlation_volume_pallas_interleaved)
// and ::_corr_kernel (separate left/right input, correlation_volume_pallas):
//
//     cost[b,h,w,d] = (1/C) * sum_c L[b,h,w,c] * R[b,h,w-d,c],   0 where w < d
//
// for NHWC inputs and a [B,H,W,D] output, D innermost. One kernel serves both:
// the left and right base pointers and the stride between pairs are
// arguments (interleaved: right = left + H*W*C, pair stride 2*H*W*C;
// separate eyes: two bases, pair stride H*W*C).
//
// What bounds it on the card: device-memory bytes. Each pixel brings 2*C
// input values and takes D outputs for C*D multiply-adds: about 2.5 FMAs per
// byte moved at C = 64, D = 24 in f32, below the ~10 FMAs per byte at which
// an H100's f32 units (67 TFLOP/s against 3.35 TB/s) rather than its memory
// would be the limit. What the design does about that: each block owns one
// (pair b, row h, tile of TW columns) and stages its left tile [TW, C] and the
// right tile [TW + D - 1, C] (a left halo of D - 1 columns, zero where
// w - d < 0) in shared memory once, converted to f32; all D shifted products
// then reuse the staged rows, so every input byte is read from device memory
// once (the right halo is re-read by the neighbouring tile, mostly from L2)
// and the output is written once. Accumulation is f32 for f32 and bf16
// inputs; the output has the input's type. Rows are padded to C + 1 floats so
// that the 32 threads of a warp, which own 32 consecutive columns, read 32
// distinct banks. Each thread keeps L[w, c] in a register across DG
// disparities. The [TW, D] output tile is staged in shared memory and written
// as one contiguous run: the [B,H,W,D] volume is the channels_last NCHW
// tensor that the next 1x1 conv reads, so no transpose follows.
//
// Plain C interface for ctypes; each entry returns the cudaError_t of the
// launch (0 on success). The launch goes on the caller's stream and does not
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;        // output columns per block (one warp wide)
constexpr int kDispPerThread = 4;  // disparities each thread accumulates
constexpr int kMaxThreads = 256;
constexpr size_t kMaxSmem = 232448;  // per-block opt-in limit on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
correlation_kernel(const T* __restrict__ left, const T* __restrict__ right,
                   T* __restrict__ out, int H, int W, int C, int D,
                   long long pair_stride, float scale) {
  extern __shared__ float smem[];
  const int cp = C + 1;  // padded row stride in floats
  const int halo = D - 1;
  float* l_s = smem;                        // [kTileW][cp]
  float* r_s = l_s + kTileW * cp;           // [kTileW + halo][cp]
  float* o_s = r_s + (kTileW + halo) * cp;  // [kTileW][D]

  const int w0 = blockIdx.x * kTileW;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long row = b * pair_stride + (long long)h * W * C;
  const T* l_row = left + row;
  const T* r_row = right + row;

  // Stage left columns [w0, w0 + kTileW) and right columns
  // [w0 - halo, w0 + kTileW); out-of-image columns are zero.
  for (int i = threadIdx.x; i < kTileW * C; i += blockDim.x) {
    const int col = i / C, c = i - col * C;
    const int w = w0 + col;
    l_s[col * cp + c] = (w < W) ? to_f32(l_row[(long long)w * C + c]) : 0.f;
  }
  for (int i = threadIdx.x; i < (kTileW + halo) * C; i += blockDim.x) {
    const int col = i / C, c = i - col * C;
    const int w = w0 - halo + col;
    r_s[col * cp + c] = (w >= 0 && w < W) ? to_f32(r_row[(long long)w * C + c]) : 0.f;
  }
  __syncthreads();

  // Thread t owns column t % kTileW and disparities d0 .. d0 + kDispPerThread - 1;
  // a warp is one disparity group over the 32 columns of the tile.
  const int groups = (D + kDispPerThread - 1) / kDispPerThread;
  for (int t = threadIdx.x; t < kTileW * groups; t += blockDim.x) {
    const int wl = t % kTileW;
    const int d0 = (t / kTileW) * kDispPerThread;
    float acc[kDispPerThread];
#pragma unroll
    for (int j = 0; j < kDispPerThread; ++j) acc[j] = 0.f;
    const float* lp = l_s + wl * cp;
    // column w0 + wl - d sits at staged right row wl - d + halo
    const float* rp = r_s + (wl + halo) * cp;
    for (int c = 0; c < C; ++c) {
      const float lv = lp[c];
#pragma unroll
      for (int j = 0; j < kDispPerThread; ++j) {
        const int d = d0 + j;
        if (d < D) acc[j] = fmaf(lv, rp[c - d * cp], acc[j]);
      }
    }
    const int w = w0 + wl;
#pragma unroll
    for (int j = 0; j < kDispPerThread; ++j) {
      const int d = d0 + j;
      if (d < D) o_s[wl * D + d] = (w >= d) ? acc[j] * scale : 0.f;
    }
  }
  __syncthreads();

  // The tile's outputs are one contiguous run of out: coalesced stores.
  const int cols = min(kTileW, W - w0);
  T* o_row = out + (((long long)b * H + h) * W + w0) * D;
  for (int i = threadIdx.x; i < cols * D; i += blockDim.x) o_row[i] = from_f32<T>(o_s[i]);
}

template <typename T>
int launch(const void* left, const void* right, void* out, int B, int H, int W,
           int C, int D, long long pair_stride, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || D <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)(2 * kTileW + D - 1) * (C + 1) + (size_t)kTileW * D) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        correlation_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = (D + kDispPerThread - 1) / kDispPerThread;
  int threads = kTileW * groups;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid((W + kTileW - 1) / kTileW, H, B);
  correlation_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right), static_cast<T*>(out),
      H, W, C, D, pair_stride, 1.0f / (float)C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int vd3d_correlation_f32(const void* left, const void* right, void* out, int B, int H,
                         int W, int C, int D, long long pair_stride, void* stream) {
  return launch<float>(left, right, out, B, H, W, C, D, pair_stride, stream);
}

int vd3d_correlation_bf16(const void* left, const void* right, void* out, int B, int H,
                          int W, int C, int D, long long pair_stride, void* stream) {
  return launch<__nv_bfloat16>(left, right, out, B, H, W, C, D, pair_stride, stream);
}

const char* vd3d_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
