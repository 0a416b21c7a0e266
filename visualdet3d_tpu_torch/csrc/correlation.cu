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
// would be the limit. The first design (one block per 32-column tile, a
// scalar staging loop converting to f32, one shared-memory load per FMA, the
// load, the products and the store strictly in turn) ran at the same time in
// bf16 and f32, a quarter of the f32 bound and an eighth of the bf16 one.
// This one keeps the device-memory stream busy:
//   * the work is items of (pair b, row h, 64-column tile, chunk of at most
//     28 disparities), each walked in 128-byte channel chunks (64 bf16 or 32
//     f32 channels); a persistent block of 4 warps takes items in turn and
//     keeps a ring of kStages stages in shared memory filled by 16-byte
//     cp.async in the input dtype: per stage, the left tile's 64 rows and
//     the right tile's 64 + halo rows (columns outside the image, w - d < 0
//     among them, are zero-filled), so the next stage's loads are in flight
//     while this one is multiplied. Two stages (48 KB) leave four blocks an
//     SM; three or four stages, with fewer blocks, and 128-column items were
//     slower on an H100 (stream_study.py corr);
//   * each 128-byte row of a stage is stored with its 16-byte pieces
//     permuted (swizzle below), so that ldmatrix of 8 consecutive rows and
//     float4 loads of rows 4 apart read 8 distinct bank groups;
//   * bf16, tensor cores: per row, the volume is the band 0 <= w - w' < D of
//     L . R^T. Each warp owns 16 columns w and multiplies them against the
//     8 * NT columns w' that their band touches (mma.sync m16n8k16, ldmatrix
//     operands, f32 accumulators), then keeps the band;
//   * f32, FMA units (never TF32): each thread owns a 4 x 4 block of L . R^T
//     on the band's k-th diagonal (4 columns w against 4 columns w' = w - 4k
//     + ...), reading 4 float4 of L and 4 of R per 16 FMAs x 4 channels;
//   * each warp scatters its band entries (scaled by 1/C) into its own piece
//     of shared memory and stores its 16 columns x D disparities as one
//     contiguous run of the [B,H,W,D] volume, which is the channels_last
//     NCHW tensor that the next 1x1 conv reads: no transpose follows.
// Accumulation is f32 for f32 and bf16 inputs; the output has the input's
// type. ops/cost_volume.py::correlation_plan mirrors the host-side plan and
// tests/test_torch_corr_tiles.py writes the order of work out in torch.
//
// Plain C interface for ctypes; each entry returns the cudaError_t of the
// launch (0 on success). The launch goes on the caller's stream and does not
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTileW = 64;      // output columns of an item
constexpr int kWarps = 4;       // a warp: 16 columns of the tile
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDc = 28;      // disparities of an item (chunks of D)
constexpr int kMaxHalo = 32;    // right-tile columns left of the tile (bf16 at dc = 28)
constexpr int kRowBytes = 128;  // one stage: 128 bytes of channels a row
constexpr int kStages = 2;
constexpr int kRowsR = kTileW + kMaxHalo;
constexpr int kStageBytes = (kTileW + kRowsR) * kRowBytes;
constexpr int kOutFloats = 16 * kMaxDc;  // a warp's band entries
constexpr int kSmem = kStages * kStageBytes + kWarps * kOutFloats * (int)sizeof(float);
constexpr int kMaxBf16Ntiles = (kMaxDc + 15 + 7) / 8;  // n8 tiles of a bf16 warp

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T from f32 values (rounded to nearest even in bf16)
template <typename T> __device__ __forceinline__ uint4 pack16(const float* v);
template <> __device__ __forceinline__ uint4 pack16<float>(const float* v) {
  const float4 f = *reinterpret_cast<const float4*>(v);
  return make_uint4(__float_as_uint(f.x), __float_as_uint(f.y), __float_as_uint(f.z),
                    __float_as_uint(f.w));
}
template <> __device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* v) {
  unsigned u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    u[j] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j])) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1])) << 16);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// The 16-byte piece q of stage row r sits at piece q ^ swz(r). For 8
// consecutive rows (ldmatrix) and for 8 rows 4 apart (the f32 diagonals)
// swz takes 8 distinct values, so those reads hit 8 distinct bank groups.
__host__ __device__ __forceinline__ int swz(int r) { return (r ^ (r >> 2)) & 7; }

// The halo of a chunk of dc disparities: right-tile columns left of the tile.
template <typename T> __host__ __device__ __forceinline__ int halo_of(int dc) {
  if constexpr (std::is_same<T, float>::value) {
    return 4 * ((dc - 1 + 3) / 4);  // 4 * (diagonal blocks - 1)
  } else {
    return 8 * ((dc + 15 + 7) / 8) - 16;  // 8 * n8 tiles - 16
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float& c0, float& c1, float& c2, float& c3,
                                         const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An item: pair b, row h, tile of columns from w0, disparities d0 .. d0 + dc.
struct Item {
  long long row;  // element offset of (b, h, 0, 0) in an eye
  long long out;  // element offset of (b, h, 0, 0) in the output
  int w0, d0, dc, halo;
};

struct Geom {
  int H, W, C, D, n_tiles, n_dchunks, dchunk, n_cc;
  long long pair_stride;
};

// Item i of the grid's list, (pair, row, tile, disparity chunk) with the
// chunk fastest; 32-bit arithmetic, once per item.
template <typename T>
__device__ __forceinline__ Item item_of(int i, const Geom& g) {
  Item r;
  const int dci = i % g.n_dchunks;
  i /= g.n_dchunks;
  const int t = i % g.n_tiles;
  i /= g.n_tiles;
  const int h = i % g.H, b = i / g.H;
  r.row = b * g.pair_stride + (long long)h * g.W * g.C;
  r.out = ((long long)b * g.H + h) * g.W * g.D;
  r.w0 = t * kTileW;
  r.d0 = dci * g.dchunk;
  r.dc = min(g.dchunk, g.D - r.d0);
  r.halo = halo_of<T>(r.dc);
  return r;
}

// Copy chunk cc (128 bytes of channels) of an item's left rows w0 .. w0+63
// and right rows w0 - d0 - halo .. w0 + 63 - d0 into a stage; columns
// outside the image and channels past C are zero. VEC: 16-byte cp.async
// (C and both bases allow it), else element loads and 16-byte stores.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(unsigned char* st, const T* __restrict__ left,
                                           const T* __restrict__ right, const Item& it, int cc,
                                           const Geom& g) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = kRowBytes / 16;
  const int rows = 2 * kTileW + it.halo;
  for (int e = threadIdx.x; e < rows * kPieces; e += kThreads) {
    const int r = e / kPieces, q = e - r * kPieces;
    const bool is_left = r < kTileW;
    const int rr = is_left ? r : r - kTileW;  // row within the left or right tile
    const int w = is_left ? it.w0 + rr : it.w0 - it.d0 - it.halo + rr;
    const int ch = cc * (kRowBytes / (int)sizeof(T)) + q * kVec;
    const bool ok = w >= 0 && w < g.W && ch < g.C;
    const T* src = (is_left ? left : right) + it.row + (ok ? (long long)w * g.C + ch : 0);
    unsigned char* dst = st + (is_left ? 0 : kTileW * kRowBytes) + rr * kRowBytes +
                         ((q ^ swz(rr)) << 4);
    if constexpr (VEC) {
      cp_async16(dst, src, ok);
    } else {
      alignas(16) T v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = (ok && ch + j < g.C) ? src[j] : from_f32<T>(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
correlation_kernel(const T* __restrict__ left, const T* __restrict__ right,
                   T* __restrict__ out, Geom g, int n_items, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* band = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wband = band + warp * kOutFloats;

  // the next stage to load: item ld (its Item ld_it), channel chunk ld_cc
  int ld = blockIdx.x, ld_cc = 0;
  Item ld_it = item_of<T>(ld < n_items ? ld : 0, g);
  auto load_next = [&](int slot) {
    if (ld < n_items) load_stage<T, VEC>(smem + slot * kStageBytes, left, right, ld_it, ld_cc, g);
    cp_async_commit();
    if (++ld_cc == g.n_cc) {
      ld_cc = 0;
      ld += gridDim.x;
      if (ld < n_items) ld_it = item_of<T>(ld, g);
    }
  };
  // prologue: the first kStages - 1 stages in flight
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_next(s);

  // f32: [i][j] of the lane's 4 x 4 block; bf16: [n8 tile][fragment]
  constexpr int kAcc = std::is_same<T, float>::value ? 16 : 4 * kMaxBf16Ntiles;
  float acc[kAcc];
  int slot = 0;  // the ring slot of the stage being multiplied
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Item it = item_of<T>(item, g);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int cc = 0; cc < g.n_cc; ++cc) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // this stage landed for all threads; the previous one is free
      load_next(slot == 0 ? kStages - 1 : slot - 1);
      const unsigned char* sl = smem + slot * kStageBytes;
      slot = slot == kStages - 1 ? 0 : slot + 1;
      const unsigned char* sr = sl + kTileW * kRowBytes;
      const bool live = it.w0 + 16 * warp < g.W;  // a warp past the image's edge idles

      if constexpr (std::is_same<T, float>::value) {
        // lane (g4, k): columns 16 warp + 4 g4 + i against right rows
        // 16 warp + 4 g4 - 4k + j + halo (w' = w - 4k - (i - j) ...), i, j < 4
        const int g4 = lane >> 3, k = lane & 7;
        const int nk = (it.dc - 1 + 3) / 4 + 1;  // diagonal blocks
        if (live && k < nk) {
          const int lrow = 16 * warp + 4 * g4;
          const int rrow = lrow - 4 * k + it.halo;
#pragma unroll 2
          for (int q = 0; q < kRowBytes / 16; ++q) {
            float4 lv[4], rv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              lv[i] = *reinterpret_cast<const float4*>(sl + (lrow + i) * kRowBytes +
                                                       ((q ^ swz(lrow + i)) << 4));
              rv[i] = *reinterpret_cast<const float4*>(sr + (rrow + i) * kRowBytes +
                                                       ((q ^ swz(rrow + i)) << 4));
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float a = acc[4 * i + j];
                a = fmaf(lv[i].x, rv[j].x, a);
                a = fmaf(lv[i].y, rv[j].y, a);
                a = fmaf(lv[i].z, rv[j].z, a);
                a = fmaf(lv[i].w, rv[j].w, a);
                acc[4 * i + j] = a;
              }
          }
        }
        if (cc == g.n_cc - 1) {
          if (live && k < nk) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int d = 4 * k + i - j;  // disparity within the chunk
                if (d >= 0 && d < it.dc) wband[(4 * g4 + i) * it.dc + d] = acc[4 * i + j] * scale;
              }
          }
        }
      } else {
        // warp: columns 16 warp .. +15 (A, 16 rows) against right rows 16 warp
        // .. 16 warp + 8 nt - 1 (B); accumulator (row rw, column col) is
        // disparity rw + halo - col
        const int nt = (it.dc + 15 + 7) / 8;
        if (live) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {  // two 32-channel halves of the chunk
            unsigned a[2][4];
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int r = 16 * warp + (lane & 15);
              const int piece = 4 * kk + 2 * h2 + (lane >> 4);
              ldsm_x4(a[h2], sl + r * kRowBytes + ((piece ^ swz(r)) << 4));
            }
#pragma unroll
            for (int n = 0; n < kMaxBf16Ntiles; ++n) {
              if (n < nt) {
                unsigned b[4];
                const int r = 16 * warp + 8 * n + (lane & 7);
                ldsm_x4(b, sr + r * kRowBytes + (((4 * kk + (lane >> 3)) ^ swz(r)) << 4));
                mma_bf16(acc[4 * n], acc[4 * n + 1], acc[4 * n + 2], acc[4 * n + 3], a[0], b[0],
                         b[1]);
                mma_bf16(acc[4 * n], acc[4 * n + 1], acc[4 * n + 2], acc[4 * n + 3], a[1], b[2],
                         b[3]);
              }
            }
          }
        }
        if (cc == g.n_cc - 1 && live) {
          const int gr = lane >> 2, t = lane & 3;
#pragma unroll
          for (int n = 0; n < kMaxBf16Ntiles; ++n) {
            if (n < nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int rw = gr + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
                const int d = rw + it.halo - col;
                if (d >= 0 && d < it.dc) wband[rw * it.dc + d] = acc[4 * n + e] * scale;
              }
            }
          }
        }
      }

      if (cc == g.n_cc - 1 && live) {
        // the warp's 16 columns x dc disparities; one contiguous run when dc == D
        __syncwarp();
        const int wc = it.w0 + 16 * warp;
        const int n = min(16, g.W - wc) * it.dc;
        T* o = out + it.out + (long long)wc * g.D + it.d0;
        constexpr int kV = 16 / sizeof(T);
        if (it.dc == g.D && n % kV == 0 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
          for (int e = lane * kV; e < n; e += 32 * kV)
            *reinterpret_cast<uint4*>(o + e) = pack16<T>(wband + e);
        } else if (it.dc == g.D) {
          for (int e = lane; e < n; e += 32) o[e] = from_f32<T>(wband[e]);
        } else {
          for (int e = lane; e < n; e += 32) {
            const int wl = e / it.dc, d = e - wl * it.dc;
            o[(long long)wl * g.D + d] = from_f32<T>(wband[e]);
          }
        }
        __syncwarp();
      }
    }
  }
  cp_async_wait<0>();
}

// Blocks of the persistent grid on the current device: the SM count times
// the blocks an SM holds. The opt-in to kSmem bytes of dynamic shared memory
// holds for one device, so it is set, and the grid computed, once per
// (kernel instance, device).
template <typename Kernel>
cudaError_t grid_for_device(Kernel kernel, unsigned long long& devices_set, int (&grid)[64],
                            int& blocks) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit != 0 && (devices_set & bit) != 0) {
    blocks = grid[device];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, n_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  blocks = per_sm * n_sm;
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  if (bit != 0) {
    grid[device] = blocks;
    devices_set |= bit;
  }
  return cudaSuccess;
}

template <typename T, bool VEC>
int launch_kernel(const T* left, const T* right, T* out, const Geom& g, int n_items,
                  float scale, cudaStream_t stream) {
  static unsigned long long devices_set = 0;
  static int grid[64];
  int blocks = 0;
  const cudaError_t e = grid_for_device(correlation_kernel<T, VEC>, devices_set, grid, blocks);
  if (e != cudaSuccess) return (int)e;
  if (n_items < blocks) blocks = n_items;
  correlation_kernel<T, VEC><<<blocks, kThreads, kSmem, stream>>>(left, right, out, g, n_items,
                                                                   scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* left, const void* right, void* out, int B, int H, int W, int C, int D,
           long long pair_stride, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  Geom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.D = D;
  g.n_tiles = (W + kTileW - 1) / kTileW;
  // balanced chunks of at most kMaxDc disparities, none empty
  g.dchunk = (D + (D + kMaxDc - 1) / kMaxDc - 1) / ((D + kMaxDc - 1) / kMaxDc);
  g.n_dchunks = (D + g.dchunk - 1) / g.dchunk;
  g.n_cc = (C * (int)sizeof(T) + kRowBytes - 1) / kRowBytes;
  g.pair_stride = pair_stride;
  const long long n_items = (long long)B * H * g.n_tiles * g.n_dchunks;
  if (n_items > 2147483647ll) return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = C % kVec == 0 && reinterpret_cast<uintptr_t>(left) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(right) % 16 == 0;
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  T* o = static_cast<T*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  const float scale = 1.0f / (float)C;
  return vec ? launch_kernel<T, true>(l, r, o, g, (int)n_items, scale, s)
             : launch_kernel<T, false>(l, r, o, g, (int)n_items, scale, s);
}

// ---------------------------------------------------------------------------
// The backward: the gradients of both eyes from the volume's gradient g.
//
// It replaces no Pallas kernel: the JAX package differentiates the TPU
// kernels through the XLA vjp of correlation_volume_xla
// (visualdet3d_tpu/ops/cost_volume.py::_corr_eyes_bwd and ::_corr_tpu_bwd).
// Per (pair, row, channel), both sums over w - d >= 0 only:
//
//     dL[w]  = (1/C) * sum_d g[w, d]     * R[w - d]
//     dR[w'] = (1/C) * sum_d g[w' + d, d] * L[w' + d]
//
// What bounds it on the card: device-memory bytes. It reads L, R and g once
// and writes dL and dR once, and does 2 C D multiply-adds a pixel: at C = 64,
// D = 24 about 1.5 FMAs per byte in bf16, far below the ~10 at which the f32
// units would be the limit. The design keeps the stream busy and every
// output in one writer:
//   * an item is (pair b, row h, 64-column tile), as in the forward; its
//     128 threads own 16 groups of 4 columns x one 16-byte channel piece,
//     and each item writes both dL and dR of its 64 columns for every
//     channel, so no output has two writers: no atomics, a deterministic
//     result;
//   * a persistent block takes items in turn through a 2-stage ring of
//     128-byte channel chunks filled by 16-byte cp.async in the input
//     dtype: per stage, L rows w0 .. w0 + 63 + D - 1 (the halo to the right,
//     for dR) and R rows w0 - D + 1 .. w0 + 63 (the halo to the left, for
//     dL), zero outside the image; the first chunk of an item also brings
//     g's rows w0 .. w0 + 63 + D - 1, one contiguous run of the [B,H,W,D]
//     gradient, which the block converts once an item to f32 rows padded
//     with 3 zero columns on each side (so the band's ends need no branch)
//     and a row stride that puts the 4 column groups of a warp on 4
//     distinct banks;
//   * per stage, each thread walks the D + 3 rows its 4 columns' bands
//     touch, reading one 16-byte piece of L and one of R a row and the g
//     entries its columns need from shared memory, and accumulates in f32
//     registers (FMA units, never TF32); 1/C scales the sums (exact for a
//     power-of-two C), which are rounded once to the input dtype and
//     stored as 16-byte vectors into the two eyes' rows (rows 2b and
//     2b + 1 of the interleaved [2B,H,W,C] gradient).
// D is at most kBwdMaxD. ops/cost_volume.py::correlation_bwd_plan mirrors
// the host-side plan, and tests/test_torch_cost_volume_grad.py writes the
// order of work out in torch.
constexpr int kBwdMaxD = 32;
constexpr int kBwdGPad = 3;  // zero g columns on each side of a row
static_assert(kThreads == 2 * kTileW, "the backward's 4-column groups of 8 pieces cover a tile");

struct BwdGeom {
  int H, W, C, D, n_tiles, n_cc, rows, gstride, stage_bytes;
  long long pair_stride;
};

__host__ __device__ __forceinline__ int bwd_rows(int D) { return kTileW + D - 1; }
__host__ __device__ __forceinline__ int bwd_gstride(int D) {
  const int s = D + 2 * kBwdGPad;  // 4 * stride must hit 4 distinct banks mod 32
  return s % 4 == 0 ? s + 1 : s;
}
__host__ __device__ __forceinline__ int bwd_stage_bytes(int D, int isz) {
  const int rows = bwd_rows(D);
  return 2 * rows * kRowBytes + (rows * D * isz + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int bwd_smem(int D, int isz) {
  return kStages * bwd_stage_bytes(D, isz) + bwd_rows(D) * bwd_gstride(D) * (int)sizeof(float);
}

__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

// 16 bytes of T as f32 values
template <typename T> __device__ __forceinline__ void unpack16(const unsigned char* p, float* v);
template <> __device__ __forceinline__ void unpack16<float>(const unsigned char* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const unsigned char* p,
                                                                    float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Stage chunk cc of item (row offset row, g offset grow, tile w0): L rows
// w0 .. w0 + rows - 1, then R rows w0 - D + 1 .. w0 + 63, 128 bytes each;
// with_g: then g's rows w0 .. w0 + rows - 1 (rows x D values in the input
// dtype), zero past the row's end.
template <typename T, bool VEC>
__device__ __forceinline__ void bwd_load_stage(unsigned char* st, const T* __restrict__ left,
                                               const T* __restrict__ right,
                                               const T* __restrict__ g, long long row,
                                               long long grow, int w0, int cc, bool with_g,
                                               const BwdGeom& G) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = kRowBytes / 16;
  const int rows = G.rows;
  for (int e = threadIdx.x; e < 2 * rows * kPieces; e += kThreads) {
    const int r = e / kPieces, q = e - r * kPieces;
    const bool is_l = r < rows;
    const int rr = is_l ? r : r - rows;
    const int w = is_l ? w0 + rr : w0 - (G.D - 1) + rr;
    const int ch = cc * (kRowBytes / (int)sizeof(T)) + q * kVec;
    const bool ok = w >= 0 && w < G.W && ch < G.C;
    const T* src = (is_l ? left : right) + row + (ok ? (long long)w * G.C + ch : 0);
    unsigned char* dst = st + r * kRowBytes + q * 16;
    if constexpr (VEC) {
      cp_async16(dst, src, ok);
    } else {
      alignas(16) T v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = (ok && ch + j < G.C) ? src[j] : from_f32<T>(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
  if (with_g) {
    const int n = rows * G.D;
    const int avail = max(0, min(rows, G.W - w0)) * G.D;  // elements inside row h
    unsigned char* dst0 = st + 2 * rows * kRowBytes;
    const T* src0 = g + grow + (long long)w0 * G.D;
    if constexpr (VEC) {
      for (int e = threadIdx.x * kVec; e < n; e += kThreads * kVec) {
        const int inside = avail - e;
        const int bytes = inside <= 0 ? 0 : min(inside, kVec) * (int)sizeof(T);
        cp_async16_n(dst0 + e * (int)sizeof(T), bytes ? src0 + e : src0, bytes);
      }
    } else {
      T* dst = reinterpret_cast<T*>(dst0);
      for (int e = threadIdx.x; e < n; e += kThreads) dst[e] = e < avail ? src0[e] : from_f32<T>(0.f);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
correlation_bwd_kernel(const T* __restrict__ left, const T* __restrict__ right,
                       const T* __restrict__ g, T* __restrict__ dleft, T* __restrict__ dright,
                       BwdGeom G, int n_items, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kV = 16 / sizeof(T);  // channels of a 16-byte piece
  float* gs = reinterpret_cast<float*>(smem + kStages * G.stage_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = threadIdx.x & 7, cg = threadIdx.x >> 3;  // piece, 4-column group
  const int S = G.gstride, D = G.D, rows = G.rows;

  auto item_row = [&](int i, long long& row, long long& grow, int& w0) {
    const int t = i % G.n_tiles;
    i /= G.n_tiles;
    const int h = i % G.H, b = i / G.H;
    row = b * G.pair_stride + (long long)h * G.W * G.C;
    grow = ((long long)b * G.H + h) * G.W * D;
    w0 = t * kTileW;
  };

  int ld = blockIdx.x, ld_cc = 0, ld_w0 = 0;
  long long ld_row = 0, ld_grow = 0;
  if (ld < n_items) item_row(ld, ld_row, ld_grow, ld_w0);
  auto load_next = [&](int slot) {
    if (ld < n_items)
      bwd_load_stage<T, VEC>(smem + slot * G.stage_bytes, left, right, g, ld_row, ld_grow,
                             ld_w0, ld_cc, ld_cc == 0, G);
    cp_async_commit();
    if (++ld_cc == G.n_cc) {
      ld_cc = 0;
      ld += gridDim.x;
      if (ld < n_items) item_row(ld, ld_row, ld_grow, ld_w0);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_next(s);

  int slot = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    long long row, grow;
    int w0;
    item_row(item, row, grow, w0);
    for (int cc = 0; cc < G.n_cc; ++cc) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // this stage landed for all threads; the previous one is free
      load_next(slot == 0 ? kStages - 1 : slot - 1);
      const unsigned char* sl = smem + slot * G.stage_bytes;
      slot = slot == kStages - 1 ? 0 : slot + 1;
      const unsigned char* sr = sl + rows * kRowBytes;
      if (cc == 0) {
        // g's rows to f32, kBwdGPad zero columns each side: gs[r][d + kBwdGPad]
        const T* raw = reinterpret_cast<const T*>(sl + 2 * rows * kRowBytes);
        for (int r = warp; r < rows; r += kWarps)
          for (int col = lane; col < S; col += 32) {
            const int d = col - kBwdGPad;
            gs[r * S + col] = (d >= 0 && d < D) ? to_f32(raw[r * D + d]) : 0.f;
          }
        __syncthreads();
      }

      float aL[4][kV], aR[4][kV];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kV; ++j) aL[i][j] = aR[i][j] = 0.f;
      // row k = 4 cg + m of both stages: R row k serves column 4 cg + i at
      // d = i + D - 1 - m (dL), L row k at d = m - i (dR, g row k)
      const float* gl_base = gs + (4 * cg) * S + D - 1 + kBwdGPad;
      const float* gr_base = gs + (4 * cg) * S + kBwdGPad;
      for (int m = 0; m < D + 3; ++m) {
        const int k = 4 * cg + m;
        float lv[kV], rv[kV];
        unpack16<T>(sl + k * kRowBytes + p * 16, lv);
        unpack16<T>(sr + k * kRowBytes + p * 16, rv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float gl = gl_base[i * S + i - m];
          const float gr = gr_base[m * S + m - i];
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            aL[i][j] = fmaf(gl, rv[j], aL[i][j]);
            aR[i][j] = fmaf(gr, lv[j], aR[i][j]);
          }
        }
      }

      const int ch = cc * (kRowBytes / (int)sizeof(T)) + p * kV;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = w0 + 4 * cg + i;
        if (w >= G.W || ch >= G.C) continue;
        const long long off = row + (long long)w * G.C + ch;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          aL[i][j] *= scale;
          aR[i][j] *= scale;
        }
        if constexpr (VEC) {
          *reinterpret_cast<uint4*>(dleft + off) = pack16<T>(aL[i]);
          *reinterpret_cast<uint4*>(dright + off) = pack16<T>(aR[i]);
        } else {
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            if (ch + j < G.C) {
              dleft[off + j] = from_f32<T>(aL[i][j]);
              dright[off + j] = from_f32<T>(aR[i][j]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The persistent grid for D on the current device: the opt-in to the largest
// shared memory (kBwdMaxD) is set once per (kernel instance, device), the
// blocks an SM holds at D's shared memory computed once per (instance,
// device, D).
template <typename T, bool VEC>
int launch_bwd_kernel(const T* left, const T* right, const T* g, T* dleft, T* dright,
                      const BwdGeom& G, int n_items, float scale, cudaStream_t stream) {
  static unsigned long long devices_set = 0;
  static int grid[64][kBwdMaxD + 1];
  auto kernel = correlation_bwd_kernel<T, VEC>;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  const int smem = bwd_smem(G.D, (int)sizeof(T));
  int blocks = device < 64 ? grid[device][G.D] : 0;
  if (blocks == 0) {
    const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
    if (bit == 0 || (devices_set & bit) == 0) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bwd_smem(kBwdMaxD, (int)sizeof(T)));
      if (e != cudaSuccess) return (int)e;
      devices_set |= bit;
    }
    int per_sm = 0, n_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    blocks = per_sm * n_sm;
    if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
    if (device < 64) grid[device][G.D] = blocks;
  }
  if (n_items < blocks) blocks = n_items;
  kernel<<<blocks, kThreads, smem, stream>>>(left, right, g, dleft, dright, G, n_items, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* left, const void* right, const void* g, void* dleft, void* dright,
               int B, int H, int W, int C, int D, long long pair_stride, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || D <= 0 || D > kBwdMaxD)
    return (int)cudaErrorInvalidValue;
  BwdGeom G;
  G.H = H;
  G.W = W;
  G.C = C;
  G.D = D;
  G.n_tiles = (W + kTileW - 1) / kTileW;
  G.n_cc = (C * (int)sizeof(T) + kRowBytes - 1) / kRowBytes;
  G.rows = bwd_rows(D);
  G.gstride = bwd_gstride(D);
  G.stage_bytes = bwd_stage_bytes(D, (int)sizeof(T));
  G.pair_stride = pair_stride;
  const long long n_items = (long long)B * H * G.n_tiles;
  if (n_items > 2147483647ll) return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const bool vec = C % kVec == 0 && (long long)W * D % kVec == 0 && aligned(left) &&
                   aligned(right) && aligned(g) && aligned(dleft) && aligned(dright);
  const cudaStream_t s = (cudaStream_t)stream;
  const float scale = 1.0f / (float)C;
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  const T* gg = static_cast<const T*>(g);
  T* dl = static_cast<T*>(dleft);
  T* dr = static_cast<T*>(dright);
  return vec ? launch_bwd_kernel<T, true>(l, r, gg, dl, dr, G, (int)n_items, scale, s)
             : launch_bwd_kernel<T, false>(l, r, gg, dl, dr, G, (int)n_items, scale, s);
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

int vd3d_correlation_backward_f32(const void* left, const void* right, const void* g,
                                  void* dleft, void* dright, int B, int H, int W, int C, int D,
                                  long long pair_stride, void* stream) {
  return launch_bwd<float>(left, right, g, dleft, dright, B, H, W, C, D, pair_stride, stream);
}

int vd3d_correlation_backward_bf16(const void* left, const void* right, const void* g,
                                   void* dleft, void* dright, int B, int H, int W, int C, int D,
                                   long long pair_stride, void* stream) {
  return launch_bwd<__nv_bfloat16>(left, right, g, dleft, dright, B, H, W, C, D, pair_stride,
                                   stream);
}

const char* vd3d_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
