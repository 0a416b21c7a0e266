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
// (3x3 over 256-1408 channels: hundreds of operations per byte), device memory
// for the 64-channel convs at stride 4. What the design does: a block owns a
// 128-pixel x 128-channel output tile (64 channels where C_out < 128) and
// walks K in steps of 64, gathering its im2col tile [128 x 64] of the input and
// the weight tile into shared memory with cp.async (16, 8 or 4 bytes a copy,
// by what C_in and the pointers allow; zero fill for the border, the padding
// and the K and N tails), three stages deep, so the next steps' gathers
// overlap this step's products. Eight warps each compute a 64 x 32 piece
// (32 x 32 in the 64-channel tile) with mma.sync m16n8k32 (s8 x s8 -> s32),
// their fragments loaded by ldmatrix. Rows of shared memory are padded to 80
// bytes, so the eight rows of an ldmatrix hit 32 distinct banks. A table in
// shared memory keeps each tile row's image base and top-left input
// coordinate, so the gather does one division per step (K index -> tap,
// channel) and none per row.
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

const char* vd3d_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
