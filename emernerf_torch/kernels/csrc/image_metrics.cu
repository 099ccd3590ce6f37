// Image metrics of the eval render: PSNR's squared-error sums and SSIM.
//
// Replaces: emernerf_tpu/eval/metrics.py:compute_psnr and compute_ssim as
// emernerf_tpu/eval/renderer.py:render_split calls them.  They are no TPU
// kernel: both packages run them in float64 numpy on the host, after the
// frame's last fetch, while the device waits (~0.5 s a 640x960 frame on
// the H100's host).  Here they run on the card, on the render's outputs
// where they already lie, and only the sums cross to the host.
//
// What bounds it on the H100: the least work is the bytes.  A 640x960
// frame reads the rendered rgb and the ground truth (7.4 MB each, fp32)
// and the mask (0.6 MB): 4.6 us at 3.35 TB/s.  The direct float64 window
// sums below (~2.5e8 operations a frame, ~7 us at the 34 TFLOP/s of
// float64 outside the tensor cores) and the blocks' barriers take longer
// (PERF.md §6 has the kernel's time), against a frame of ~1 s: so the
// design keeps the sums direct, each window summed in one order, rather
// than running sums.
//
// Design.  The SSIM map covers the "valid" positions (H - win + 1, W - win
// + 1) of compute_ssim, whose map the caller pads back to the image by
// repeating its edge.  So each valid position owns a rectangle of pixels:
// its window's centre, and at the map's edge the pixels beyond it that the
// padding gives its value.  The rectangles tile the image, so one pass over
// the valid positions forms every sum:
//   - the squared errors of the unclipped values over the image, under the
//     mask and off it (PSNR), and the mask's pixel count;
//   - the SSIM of the values clipped to [0, 1], averaged over channels,
//     summed over the valid positions (the mean SSIM) and, weighted by the
//     masked pixels each owns, under the mask (the masked mean of the
//     padded map, which need not exist).
// A block takes 16 x 32 valid positions, a thread each.  Channel by
// channel it stages its tile plus the window's (win - 1)-pixel halo as
// clipped float64 in shared memory, forms the five window sums by a row
// pass, then a column pass, and adds the channel's SSIM (compute_ssim's
// formula, uniform window, K1 = 0.01, K2 = 0.03, the N / (N - 1)
// covariance factor) into a register.  Window sums are direct sums of
// exact float64 products: nearer the exact sums than the integral images'
// differences of the numpy version.  Each thread then reads its rectangle's
// unclipped values from device memory.  The block sums its threads' six
// values by shuffles in a fixed order and writes one row of float64
// partials; a one-block finish kernel adds the rows in a fixed order, so
// two runs agree bit for bit.  With SSIM off (the feature head's PSNR, C =
// 64) the window is one pixel: a thread a pixel, no staging.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32, kTileY = 16;  // valid positions a block (a warp a row)
constexpr int kThreads = kTileX * kTileY;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWin = 7;
constexpr int kRows = kTileY + kMaxWin - 1;
constexpr int kCols = kTileX + kMaxWin - 1;
constexpr int kSums = 6;  // se all, se under the mask, se off it, mask pixels, ssim, ssim masked
constexpr double kC1 = 0.01 * 0.01;  // (K1 * data_range)^2, data_range 1
constexpr double kC2 = 0.03 * 0.03;

// np.clip's [0, 1], NaN kept (fmaxf alone would make it 0): a NaN in the
// render is NaN in every SSIM whose window holds it, as on the host
__device__ __forceinline__ double clip01(float v) {
  return static_cast<double>(v != v ? v : fminf(fmaxf(v, 0.f), 1.f));
}

// Sums v over the block into out[0..kSums) (thread 0's registers), in a
// fixed order: within each warp by shuffles, then over the warps.
__device__ void block_sums(double (&v)[kSums], double* red, double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    if (lane == 0) red[warp * kSums + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      double x = lane < kWarps ? red[lane * kSums + k] : 0.0;
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) out[k] = x;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)  // 2 blocks an SM: at most 64 registers
image_metrics_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
                     const unsigned char* __restrict__ mask, int h, int w, int c, int win,
                     int ssim, double* __restrict__ partials) {
  __shared__ double sx[kRows][kCols], sy[kRows][kCols];
  __shared__ double rs[5][kRows][kTileX];
  __shared__ double red[kWarps * kSums];
  const int hv = h - win + 1, wv = w - win + 1;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int vy0 = blockIdx.y * kTileY, vx0 = blockIdx.x * kTileX;
  const int vi = vy0 + ty, vj = vx0 + tx;
  const bool active = vi < hv && vj < wv;

  double s = 0.0;  // the SSIM at (vi, vj), summed over channels
  if (ssim) {
    const int npts = win * win;
    const double cov_norm = npts > 1 ? static_cast<double>(npts) / (npts - 1) : 1.0;
    // times 1 / N where compute_ssim divides by N: within an ulp, and one
    // float64 division a position and channel in place of six
    const double inv_npts = 1.0 / npts;
    const int rows = kTileY + win - 1, cols = kTileX + win - 1;
    for (int ch = 0; ch < c; ++ch) {
      __syncthreads();  // the previous channel's column pass has read rs
      for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
        const int r = e / cols, q = e - r * cols;
        const int gy = vy0 + r, gx = vx0 + q;
        const bool in = gy < h && gx < w;
        const long long at = (static_cast<long long>(gy) * w + gx) * c + ch;
        sx[r][q] = in ? clip01(__ldg(pred + at)) : 0.0;
        sy[r][q] = in ? clip01(__ldg(gt + at)) : 0.0;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < rows * kTileX; e += kThreads) {
        const int r = e / kTileX, t = e - r * kTileX;
        double a = 0.0, b = 0.0, aa = 0.0, bb = 0.0, ab = 0.0;
#pragma unroll
        for (int j = 0; j < kMaxWin; ++j) {
          if (j >= win) break;
          const double x = sx[r][t + j], y = sy[r][t + j];
          a += x;
          b += y;
          aa += x * x;
          bb += y * y;
          ab += x * y;
        }
        rs[0][r][t] = a;
        rs[1][r][t] = b;
        rs[2][r][t] = aa;
        rs[3][r][t] = bb;
        rs[4][r][t] = ab;
      }
      __syncthreads();
      if (active) {
        double sum[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int i = 0; i < kMaxWin; ++i) {
          if (i >= win) break;
#pragma unroll
          for (int k = 0; k < 5; ++k) sum[k] += rs[k][ty + i][tx];
        }
        const double ux = sum[0] * inv_npts, uy = sum[1] * inv_npts;
        const double uxx = sum[2] * inv_npts, uyy = sum[3] * inv_npts, uxy = sum[4] * inv_npts;
        const double vx = cov_norm * (uxx - ux * ux);
        const double vy = cov_norm * (uyy - uy * uy);
        const double vxy = cov_norm * (uxy - ux * uy);
        const double a1 = 2 * ux * uy + kC1, a2 = 2 * vxy + kC2;
        const double b1 = ux * ux + uy * uy + kC1, b2 = vx + vy + kC2;
        s += (a1 * a2) / (b1 * b2);
      }
    }
    s /= c;
  }

  double v[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (active) {
    // the pixels whose padded SSIM is this position's: its window's centre,
    // and at the map's edge those beyond it
    const int p0 = (win - 1) / 2;
    const int r0 = vi == 0 ? 0 : vi + p0, r1 = vi == hv - 1 ? h : vi + p0 + 1;
    const int q0 = vj == 0 ? 0 : vj + p0, q1 = vj == wv - 1 ? w : vj + p0 + 1;
    for (int r = r0; r < r1; ++r)
      for (int q = q0; q < q1; ++q) {
        const long long px = static_cast<long long>(r) * w + q;
        const float* pp = pred + px * c;
        const float* gp = gt + px * c;
        double se = 0.0;
        for (int k = 0; k < c; ++k) {
          const double d = static_cast<double>(__ldg(pp + k)) - static_cast<double>(__ldg(gp + k));
          se += d * d;
        }
        v[0] += se;
        if (mask != nullptr && __ldg(mask + px)) {
          v[1] += se;
          v[3] += 1.0;
          v[5] += s;
        } else {
          v[2] += se;
        }
      }
    v[4] = s;
  }
  block_sums(v, red, partials + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * kSums);
}

// Adds the n rows of partials into out, in a fixed order.
__global__ void __launch_bounds__(kThreads)
image_metrics_finish_kernel(const double* __restrict__ partials, int n, double* __restrict__ out) {
  __shared__ double red[kWarps * kSums];
  double v[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < n; b += kThreads)
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] += partials[static_cast<long long>(b) * kSums + k];
  block_sums(v, red, out);
}

}  // namespace

// pred, gt: (h, w, c) fp32; mask: (h, w) bytes, nonzero under the mask, or
// NULL (no pixel under it); win: the SSIM window (odd, 1..7, at most h and
// w), 1 where ssim is 0; partials: scratch of kSums doubles for each of the
// ceil((w - win + 1) / 32) x ceil((h - win + 1) / 16) blocks
// (ops/image_metrics.py:n_blocks); out: kSums doubles, in the order of
// kSums' comment.
extern "C" int emt_image_metrics(const void* pred, const void* gt, const void* mask, int h, int w,
                                 int c, int win, int ssim, void* partials, void* out,
                                 void* stream) {
  if (win < 1 || win > kMaxWin || win % 2 == 0 || win > h || win > w || c < 1 ||
      (!ssim && win != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((w - win + 1 + kTileX - 1) / kTileX, (h - win + 1 + kTileY - 1) / kTileY);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  double* part = static_cast<double*>(partials);
  image_metrics_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(pred), static_cast<const float*>(gt),
      static_cast<const unsigned char*>(mask), h, w, c, win, ssim, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  image_metrics_finish_kernel<<<1, kThreads, 0, s>>>(part, static_cast<int>(grid.x * grid.y),
                                                     static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
