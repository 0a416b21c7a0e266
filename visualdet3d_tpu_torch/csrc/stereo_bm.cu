// OpenCV's StereoBM block matcher at the disparity precompute's parameters
// (cv2.StereoBM_create(192, 25): XSOBEL prefilter with cap 31, a 25x25 SAD
// window over 192 disparities, texture threshold 10, uniqueness ratio 15,
// no speckle filter, no left-right check), bit for bit.
//
// It replaces no Pallas kernel: the JAX package runs this on the host
// through OpenCV (visualdet3d_tpu/cli/disparity_compute.py:41). The plain
// version, the reference of every check, is
// visualdet3d_tpu_torch/ops/stereo_bm.py::stereo_bm_plain, whose docstring
// states the arithmetic. Everything here is integer arithmetic, so the two
// agree bit for bit.
//
// Bound: operations. A 288x1280 pair computes ~54M (pixel, disparity) SADs
// on 1.1 MB of images; each takes an absolute difference and the running
// sums' adds, so the integer units bound it, not memory.
//
// Design (a first, simple one):
//  * prefilter_kernel: one thread a pixel, both eyes, read through any
//    strides, into a u8 scratch [2, H, W]; it also writes FILTERED where the
//    matcher computes nothing (outside OpenCV's valid region);
//  * match_kernel: a block a (band of BAND_H output rows, tile of TILE_W
//    output columns), one thread a disparity index d (D = 191 - d). The
//    band's prefiltered rows of both eyes sit in shared memory. Each thread
//    keeps, in registers, the vertical 25-row sums of |L - R| of the tile's
//    TILE_W + 24 window columns, moved down a row at a time, and their
//    horizontal 25-wide running sums give its SAD at each output column.
//    The arg-min over d is a warp min (redux.sync) and ballot per column
//    (the least d wins a tie, as OpenCV's strict < over increasing d), then
//    a pass over the 6 warps; the uniqueness check takes a second warp min
//    over the d's away from the best; the texture sums run the same way
//    over the left eye. The subpixel step uses the SADs next to the best.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ND = 192;                // disparities; thread d is index d
constexpr int R = 12;                  // the 25x25 window's radius
constexpr int WIN = 2 * R + 1;
constexpr int CAP = 31;                // preFilterCap
constexpr int TEXTURE = 10;            // textureThreshold
constexpr int UNIQ = 15;               // uniquenessRatio
constexpr int FILTERED = -16;          // (minDisparity - 1) << 4
constexpr int TILE_W = 32;             // output columns of a block
constexpr int BAND_H = 32;             // output rows of a block
constexpr int COLS = TILE_W + 2 * R;   // the tile's window columns (left eye)
constexpr int RCOLS = COLS + ND - 1;   // the right eye's columns a tile reads
constexpr int ROWS = BAND_H + 2 * R;   // the band's window rows
constexpr int WARPS = ND / 32;
constexpr int BIG = 0x7fffffff;

__device__ __forceinline__ int sobel_dx(const uint8_t* img, long long sy, long long sx, int y,
                                        int x) {
  const uint8_t* row = img + y * sy;
  return (int)row[(x + 1) * sx] - (int)row[(x - 1) * sx];
}

__device__ __forceinline__ uint8_t xsobel(const uint8_t* img, long long sy, long long sx, int y,
                                          int x, int up, int down) {
  int v = sobel_dx(img, sy, sx, up, x) + 2 * sobel_dx(img, sy, sx, y, x) +
          sobel_dx(img, sy, sx, down, x);
  v = v < -CAP ? -CAP : (v > CAP ? CAP : v);
  return (uint8_t)(v + CAP);
}

__global__ void prefilter_kernel(const uint8_t* __restrict__ left, long long lsy, long long lsx,
                                 const uint8_t* __restrict__ right, long long rsy, long long rsx,
                                 uint8_t* __restrict__ pf, int16_t* __restrict__ out, int H,
                                 int W, int y0, int y1, int x0, int x1) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long n = (long long)H * W;
  if (i >= n) return;
  int y = (int)(i / W), x = (int)(i % W);
  uint8_t vl = CAP, vr = CAP;
  // OpenCV filters rows in pairs: with an odd height the last row keeps CAP
  bool edge = H < 2 || x == 0 || x == W - 1 || ((H & 1) && y == H - 1);
  if (!edge) {
    int up = y > 0 ? y - 1 : 1;
    int down = y < H - 1 ? y + 1 : H - 2;
    vl = xsobel(left, lsy, lsx, y, x, up, down);
    vr = xsobel(right, rsy, rsx, y, x, up, down);
  }
  pf[i] = vl;
  pf[n + i] = vr;
  if (y < y0 || y >= y1 || x < x0 || x >= x1) out[i] = FILTERED;
}

__global__ void __launch_bounds__(ND) match_kernel(const uint8_t* __restrict__ pf,
                                                   int16_t* __restrict__ out, int H, int W,
                                                   int y0, int y1, int x0, int x1) {
  __shared__ uint8_t sl[ROWS][COLS];
  __shared__ uint8_t sr[ROWS][RCOLS];
  __shared__ int wmin[WARPS][TILE_W];
  __shared__ int widx[WARPS][TILE_W];
  __shared__ int womin[WARPS][TILE_W];
  __shared__ int bestd[TILE_W];
  __shared__ int pv[TILE_W];
  __shared__ int nv[TILE_W];
  __shared__ int tcs[COLS];

  const int d = threadIdx.x;
  const int warp = d >> 5, lane = d & 31;
  const int xt = x0 + blockIdx.x * TILE_W;          // the tile's first output column
  const int yb = y0 + blockIdx.y * BAND_H;          // the band's first output row
  const int ye = min(yb + BAND_H, y1);
  const int rows = ye - yb + 2 * R;
  const uint8_t* pl = pf;
  const uint8_t* pr = pf + (long long)H * W;

  // the band's prefiltered rows: left columns [xt - R, xt + TILE_W + R),
  // right columns [xt - R - (ND - 1), xt + TILE_W + R); columns past the
  // image feed only outputs past x1, which are not written
  for (int k = d; k < rows * COLS; k += ND) {
    int r = k / COLS, c = k % COLS;
    int gx = xt - R + c;
    sl[r][c] = gx < W ? pl[(long long)(yb - R + r) * W + gx] : 0;
  }
  for (int k = d; k < rows * RCOLS; k += ND) {
    int r = k / RCOLS, c = k % RCOLS;
    int gx = xt - R - (ND - 1) + c;
    sr[r][c] = gx < W ? pr[(long long)(yb - R + r) * W + gx] : 0;
  }
  __syncthreads();

  // vertical sums of the first output row's window; left column c meets
  // right column c + d (the right eye at x - D, D = ND - 1 - d)
  int colsum[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) colsum[c] = 0;
  for (int r = 0; r < WIN; ++r) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) colsum[c] += abs((int)sl[r][c] - (int)sr[r][c + d]);
  }
  int tcol = 0;  // thread c < COLS: the texture's vertical sum of column c
  if (d < COLS)
    for (int r = 0; r < WIN; ++r) tcol += abs((int)sl[r][d] - CAP);

  for (int j = 0; j < ye - yb; ++j) {
    if (j > 0) {
      const int rn = j + 2 * R, ro = j - 1;
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        colsum[c] += abs((int)sl[rn][c] - (int)sr[rn][c + d]) -
                     abs((int)sl[ro][c] - (int)sr[ro][c + d]);
      if (d < COLS) tcol += abs((int)sl[rn][d] - CAP) - abs((int)sl[ro][d] - CAP);
    }
    if (d < COLS) tcs[d] = tcol;

    // SAD at each output column, and each warp's least and its least d
    int sad[TILE_W];
    int s = 0;
#pragma unroll
    for (int c = 0; c < WIN; ++c) s += colsum[c];
#pragma unroll
    for (int x = 0; x < TILE_W; ++x) {
      if (x > 0) s += colsum[x + WIN - 1] - colsum[x - 1];
      sad[x] = s;
    }
#pragma unroll
    for (int x = 0; x < TILE_W; ++x) {
      int m = __reduce_min_sync(0xffffffffu, sad[x]);
      unsigned at = __ballot_sync(0xffffffffu, sad[x] == m);
      if (lane == 0) {
        wmin[warp][x] = m;
        widx[warp][x] = warp * 32 + __ffs(at) - 1;
      }
    }
    __syncthreads();

    int best = BIG, bd = 0, tsum = 0;
    if (d < TILE_W) {  // thread x: the arg-min over the warps, the texture sum
      for (int w = 0; w < WARPS; ++w) {
        if (wmin[w][d] < best) {
          best = wmin[w][d];
          bd = widx[w][d];
        }
      }
      bestd[d] = bd;
      for (int c = 0; c < WIN; ++c) tsum += tcs[d + c];
    }
    __syncthreads();

    // the least SAD away from the best, and the SADs next to it (mirrored
    // at the ends: SAD[-1] = SAD[1], SAD[ND] = SAD[ND - 2])
#pragma unroll
    for (int x = 0; x < TILE_W; ++x) {
      int b = bestd[x];
      int v = abs(d - b) > 1 ? sad[x] : BIG;
      int m = __reduce_min_sync(0xffffffffu, v);
      if (lane == 0) womin[warp][x] = m;
      if (d == (b == ND - 1 ? ND - 2 : b + 1)) pv[x] = sad[x];
      if (d == (b == 0 ? 1 : b - 1)) nv[x] = sad[x];
    }
    __syncthreads();

    if (d < TILE_W && xt + d < x1) {
      int other = BIG;
      for (int w = 0; w < WARPS; ++w) other = min(other, womin[w][d]);
      int v = FILTERED;
      if (tsum >= TEXTURE && other > best + best * UNIQ / 100) {
        int p = pv[d], n = nv[d];
        int k = p + n - 2 * best + abs(p - n);
        int frac = k != 0 ? (p - n) * 256 / k : 0;
        v = ((ND - 1 - bd) * 256 + frac + 15) >> 4;
      }
      out[(long long)(yb + j) * W + xt + d] = (int16_t)v;
    }
  }
}

}  // namespace

extern "C" {

int vd3d_stereo_bm(const void* left, long long lsy, long long lsx, const void* right,
                   long long rsy, long long rsx, void* scratch, void* out, int H, int W,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // OpenCV's getValidDisparityROI: rows [R, H - R), columns [ND - 1 + R, W - R)
  int y0 = R, y1 = H - R, x0 = ND - 1 + R, x1 = W - R;
  bool any = y1 > y0 && x1 > x0;
  if (!any) y0 = y1 = x0 = x1 = 0;
  long long n = (long long)H * W;
  prefilter_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const uint8_t*)left, lsy, lsx, (const uint8_t*)right, rsy, rsx, (uint8_t*)scratch,
      (int16_t*)out, H, W, y0, y1, x0, x1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !any) return (int)err;
  dim3 grid((x1 - x0 + TILE_W - 1) / TILE_W, (y1 - y0 + BAND_H - 1) / BAND_H);
  match_kernel<<<grid, ND, 0, s>>>((const uint8_t*)scratch, (int16_t*)out, H, W, y0, y1, x0, x1);
  return (int)cudaGetLastError();
}

const char* vd3d_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
