// Fused ResNet-trunk inference kernels for Hopper (sm_90a), fp32 and bf16
// storage with fp32 accumulation. NHWC activations, HWIO / [in, out]
// weights with BatchNorm already folded in (ops/conv_fused.py folds).
//
// Replaces the four Pallas kernels of simpb_tpu/ops/conv_fused.py:
//   maxpool_3x3_s2_kernel   <- maxpool_3x3_s2_fused        (_maxpool_kernel)
//   bottleneck_kernel<down> <- bottleneck_down_fused_infer (_kernel_down)
//   bottleneck_kernel<id>   <- bottleneck_fused_infer      (_kernel)
//   conv3x3_bias_kernel     <- conv3x3_bias_fused          (_conv3x3_kernel)
//
// What bounds them on an H100: the max-pool moves bytes (one read of the
// input, one write of the output) and does no arithmetic worth counting.
// The bottlenecks and the 3x3 conv are products: at the trunk's shapes
// they are bound by operations. The design keeps what the TPU kernels
// keep out of device memory out of it here too: a bottleneck block runs
// its three convolutions in ONE launch, with the 1x1 output (plus a
// one-pixel halo) and the 3x3 output held in shared memory, so the
// block reads its input once and writes its output once.
//
// The TPU kernels' H-tiling with halo BlockSpecs, `_destride` and the
// parity planes worked around the TPU compiler; none of that is needed
// here: strided addresses cost nothing, so stride 2 is plain index
// arithmetic. This is the first, simple version: every product is an
// fp32 FMA on the CUDA cores over 64-row register tiles fed from shared
// memory (no tensor cores, TMA or pipelining yet).
//
// Rounding follows the Pallas kernels so that the plain PyTorch versions
// in ops/conv_fused.py agree: the 1x1 and 3x3 intermediates are stored
// in the storage type; the identity bottleneck rounds y3 to the storage
// type before the residual add; the downsample bottleneck adds in fp32
// and rounds last.
//
// C interface (ctypes): every pointer and the stream are void*, every
// function returns cudaGetLastError() after its launch (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int KC = 16;   // depth of one staged weight chunk
constexpr int MAX_COLS = 256;  // widest block tile (64 thread columns x 4)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch
}

// Thread columns for a P x N block product: a block tile is
// (256 / tn) * 4 rows by tn * 4 columns; few rows -> wider columns so
// that small pixel tiles keep every thread busy.
__host__ __device__ inline int pick_tn(int P, int N) {
  int tn = P >= 64 ? 16 : (P >= 32 ? 32 : 64);
  while (tn > 16 && tn * 4 > N) tn /= 2;
  return tn;
}

// acc[i][j] += sum_k A[row_off(p_i) + k_off(k0) + kk] * B[k][n_j] over
// one (p0, n0) block tile. A row offset < 0 reads as zero (padding).
// k_off is called once per chunk of KC: a chunk never crosses a 3x3 tap
// because the wrappers require channel counts divisible by KC. The
// weight chunk is staged in shared memory (b_s, KC x MAX_COLS floats);
// every thread of the block must call this with the same arguments.
template <typename T, typename RowF, typename KF>
__device__ __forceinline__ void gemm_acc(
    float (&acc)[4][4], int p0, int n0, int P, int N, int K,
    const T* __restrict__ A, RowF row_off, KF k_off,
    const T* __restrict__ Bw, float* b_s, int tn) {
  const int tid = threadIdx.x, tm = NT / tn;
  const int tx = tid % tn, ty = tid / tn, ncols = tn * 4;
  long long ro[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + tm * i;
    ro[i] = p < P ? row_off(p) : -1;
  }
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int e = tid; e < KC * ncols; e += NT) {
      const int kk = e / ncols, nn = e - kk * ncols;
      const int k = k0 + kk, n = n0 + nn;
      b_s[e] = (k < K && n < N) ? to_f(Bw[(long long)k * N + n]) : 0.f;
    }
    __syncthreads();
    const long long ko = k_off(k0);
    const int kend = min(KC, K - k0);
    for (int kk = 0; kk < kend; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = ro[i] >= 0 ? to_f(A[ro[i] + ko + kk]) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[kk * ncols + tx + tn * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Calls epi(p, n, i, j) for every in-range element of a block tile.
template <typename Epi>
__device__ __forceinline__ void for_tile(int p0, int n0, int P, int N,
                                         int tn, Epi epi) {
  const int tid = threadIdx.x, tm = NT / tn;
  const int tx = tid % tn, ty = tid / tn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + tm * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + tn * j;
      if (n < N) epi(p, n, i, j);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------------------- K1
// 3x3 / stride 2 / pad 1 max-pool, -inf padding; the output is
// ceil(H/2) x ceil(W/2), as F.max_pool2d gives for any H and W. One
// thread per output element, channels fastest, so a warp's loads are
// contiguous.
template <typename T>
__global__ void __launch_bounds__(NT) maxpool_3x3_s2_kernel(
    const T* __restrict__ x, T* __restrict__ y, int B, int H, int W, int C) {
  const int OH = (H + 1) / 2, OW = (W + 1) / 2;
  const long long total = (long long)B * OH * OW * C;
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  long long t = idx / C;
  const int ox = (int)(t % OW);
  t /= OW;
  const int oy = (int)(t % OH);
  const int b = (int)(t / OH);
  float m = -INFINITY;
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = 2 * oy - 1 + dy;
    if (iy < 0 || iy >= H) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = 2 * ox - 1 + dx;
      if (ix < 0 || ix >= W) continue;
      m = fmaxf(m, to_f(x[(((long long)b * H + iy) * W + ix) * C + c]));
    }
  }
  y[idx] = from_f<T>(m);
}

// ---------------------------------------------------------------- K2/K3
// One block = one th x tw output tile of one image, all channels.
//   stage 1: y1 = relu(x . W1 + b1) over the tile's input region plus a
//            one-pixel halo ((th-1)*s+3 x (tw-1)*s+3), zero outside the
//            image (the 3x3 conv's zero padding), in shared memory;
//   stage 2: y2 = relu(conv3x3_s(y1) + b2) in shared memory;
//   stage 3: out = relu(y2 . W3 + b3 + skip), skip = x (DOWN false) or
//            x[::s, ::s] . Wd + bd (DOWN true).
// Weights are read through L2 in KC-deep chunks, never staged whole.
template <typename T, bool DOWN>
__global__ void __launch_bounds__(NT) bottleneck_kernel(
    const T* __restrict__ x, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, const T* __restrict__ w3,
    const float* __restrict__ b3, const T* __restrict__ wd,
    const float* __restrict__ bd, T* __restrict__ y, int H, int W, int C,
    int Cm, int Co, int s, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* b_s = reinterpret_cast<float*>(smem);
  const int OH = H / s, OW = W / s;
  const int ntw = (OW + tw - 1) / tw;
  const int oy0 = (blockIdx.x / ntw) * th, ox0 = (blockIdx.x % ntw) * tw;
  const int b = blockIdx.y;
  const int Rh = (th - 1) * s + 3, Rw = (tw - 1) * s + 3;
  const int Rp = Rh * Rw, P = th * tw;
  T* y1 = reinterpret_cast<T*>(smem + KC * MAX_COLS * sizeof(float));
  T* y2 = y1 + (long long)Rp * Cm;
  const T* xb = x + (long long)b * H * W * C;
  T* yb = y + (long long)b * OH * OW * Co;

  // region pixel r -> input pixel offset, or -1 outside the image
  auto region_off = [&](int r) -> long long {
    const int iy = oy0 * s - 1 + r / Rw, ix = ox0 * s - 1 + r % Rw;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return -1;
    return ((long long)iy * W + ix) * C;
  };
  float acc[4][4], acc2[4][4];

  // stage 1: 1x1 conv over the halo region
  {
    const int tn = pick_tn(Rp, Cm);
    const int rows = (NT / tn) * 4, cols = tn * 4;
    for (int p0 = 0; p0 < Rp; p0 += rows)
      for (int n0 = 0; n0 < Cm; n0 += cols) {
        zero(acc);
        gemm_acc(acc, p0, n0, Rp, Cm, C, xb, region_off,
                 [](int k0) -> long long { return k0; }, w1, b_s, tn);
        for_tile(p0, n0, Rp, Cm, tn, [&](int p, int n, int i, int j) {
          const float v = fmaxf(acc[i][j] + b1[n], 0.f);
          y1[(long long)p * Cm + n] = from_f<T>(region_off(p) >= 0 ? v : 0.f);
        });
      }
  }
  __syncthreads();

  // stage 2: 3x3 / stride s conv of y1, K = 9 * Cm in tap-major order
  {
    const int tn = pick_tn(P, Cm);
    const int rows = (NT / tn) * 4, cols = tn * 4;
    auto row = [&](int p) -> long long {
      return ((long long)(p / tw) * s * Rw + (p % tw) * s) * Cm;
    };
    auto koff = [&](int k0) -> long long {
      const int tap = k0 / Cm;
      return ((long long)(tap / 3) * Rw + tap % 3) * Cm + (k0 - tap * Cm);
    };
    for (int p0 = 0; p0 < P; p0 += rows)
      for (int n0 = 0; n0 < Cm; n0 += cols) {
        zero(acc);
        gemm_acc(acc, p0, n0, P, Cm, 9 * Cm, y1, row, koff, w2, b_s, tn);
        for_tile(p0, n0, P, Cm, tn, [&](int p, int n, int i, int j) {
          y2[(long long)p * Cm + n] = from_f<T>(fmaxf(acc[i][j] + b2[n], 0.f));
        });
      }
  }
  __syncthreads();

  // stage 3: 1x1 expansion + residual
  {
    const int tn = pick_tn(P, Co);
    const int rows = (NT / tn) * 4, cols = tn * 4;
    auto out_off = [&](int p) -> long long {  // output pixel, or -1
      const int oy = oy0 + p / tw, ox = ox0 + p % tw;
      if (oy >= OH || ox >= OW) return -1;
      return (long long)oy * OW + ox;
    };
    auto skip_row = [&](int p) -> long long {
      const int oy = oy0 + p / tw, ox = ox0 + p % tw;
      if (oy >= OH || ox >= OW) return -1;
      return ((long long)oy * s * W + (long long)ox * s) * C;
    };
    auto ident = [](int k0) -> long long { return k0; };
    for (int p0 = 0; p0 < P; p0 += rows)
      for (int n0 = 0; n0 < Co; n0 += cols) {
        zero(acc);
        gemm_acc(acc, p0, n0, P, Co, Cm, y2,
                 [&](int p) -> long long { return (long long)p * Cm; },
                 ident, w3, b_s, tn);
        if constexpr (DOWN) {
          zero(acc2);
          gemm_acc(acc2, p0, n0, P, Co, C, xb, skip_row, ident, wd, b_s, tn);
        }
        for_tile(p0, n0, P, Co, tn, [&](int p, int n, int i, int j) {
          const long long o = out_off(p);
          if (o < 0) return;
          float v;
          if constexpr (DOWN) {
            v = (acc[i][j] + b3[n]) + (acc2[i][j] + bd[n]);
          } else {
            // y3 rounds to the storage type before the residual add
            const float y3 = to_f(from_f<T>(acc[i][j] + b3[n]));
            v = y3 + to_f(xb[skip_row(p) + n]);
          }
          yb[o * Co + n] = from_f<T>(fmaxf(v, 0.f));
        });
      }
  }
}

// ---------------------------------------------------------------- K4
// Same-padding 3x3 conv + bias. One block = one th x tw output tile, all
// output channels; the input halo tile ((th+2) x (tw+2) x C, zero
// outside the image) is staged in shared memory once, and the weights
// stream through shared memory in KC-deep chunks.
template <typename T>
__global__ void __launch_bounds__(NT) conv3x3_bias_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ y, int H, int W, int C,
    int Co, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* b_s = reinterpret_cast<float*>(smem);
  T* halo = reinterpret_cast<T*>(smem + KC * MAX_COLS * sizeof(float));
  const int ntw = (W + tw - 1) / tw;
  const int oy0 = (blockIdx.x / ntw) * th, ox0 = (blockIdx.x % ntw) * tw;
  const int b = blockIdx.y;
  const int Rw = tw + 2, Rp = (th + 2) * Rw, P = th * tw;
  const T* xb = x + (long long)b * H * W * C;
  T* yb = y + (long long)b * H * W * Co;

  for (long long e = threadIdx.x; e < (long long)Rp * C; e += NT) {
    const int r = (int)(e / C), c = (int)(e % C);
    const int iy = oy0 - 1 + r / Rw, ix = ox0 - 1 + r % Rw;
    halo[e] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                  ? xb[((long long)iy * W + ix) * C + c]
                  : from_f<T>(0.f);
  }
  __syncthreads();

  const int tn = pick_tn(P, Co);
  const int rows = (NT / tn) * 4, cols = tn * 4;
  auto row = [&](int p) -> long long {
    return ((long long)(p / tw) * Rw + p % tw) * C;
  };
  auto koff = [&](int k0) -> long long {
    const int tap = k0 / C;
    return ((long long)(tap / 3) * Rw + tap % 3) * C + (k0 - tap * C);
  };
  float acc[4][4];
  for (int p0 = 0; p0 < P; p0 += rows)
    for (int n0 = 0; n0 < Co; n0 += cols) {
      zero(acc);
      gemm_acc(acc, p0, n0, P, Co, 9 * C, halo, row, koff, w, b_s, tn);
      for_tile(p0, n0, P, Co, tn, [&](int p, int n, int i, int j) {
        const int oy = oy0 + p / tw, ox = ox0 + p % tw;
        if (oy < H && ox < W)
          yb[((long long)oy * W + ox) * Co + n] =
              from_f<T>(acc[i][j] + bias[n]);
      });
    }
}

size_t bottleneck_smem(int Cm, int s, int th, int tw, int itemsize) {
  const size_t rp = (size_t)((th - 1) * s + 3) * ((tw - 1) * s + 3);
  return KC * MAX_COLS * sizeof(float) +
         (rp + (size_t)th * tw) * Cm * itemsize;
}

template <typename T, bool DOWN>
int launch_bottleneck(const void* x, const void* w1, const float* b1,
                      const void* w2, const float* b2, const void* w3,
                      const float* b3, const void* wd, const float* bd,
                      void* y, int B, int H, int W, int C, int Cm, int Co,
                      int s, int th, int tw, cudaStream_t stream) {
  const size_t smem = bottleneck_smem(Cm, s, th, tw, sizeof(T));
  cudaFuncSetAttribute(bottleneck_kernel<T, DOWN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int OH = H / s, OW = W / s;
  dim3 grid(((OH + th - 1) / th) * ((OW + tw - 1) / tw), B);
  bottleneck_kernel<T, DOWN><<<grid, NT, smem, stream>>>(
      (const T*)x, (const T*)w1, b1, (const T*)w2, b2, (const T*)w3, b3,
      (const T*)wd, bd, (T*)y, H, W, C, Cm, Co, s, th, tw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_conv3x3(const void* x, const void* w, const float* bias, void* y,
                   int B, int H, int W, int C, int Co, int th, int tw,
                   cudaStream_t stream) {
  const size_t smem = KC * MAX_COLS * sizeof(float) +
                      (size_t)(th + 2) * (tw + 2) * C * sizeof(T);
  cudaFuncSetAttribute(conv3x3_bias_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(((H + th - 1) / th) * ((W + tw - 1) / tw), B);
  conv3x3_bias_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)x, (const T*)w, bias, (T*)y, H, W, C, Co, th, tw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_maxpool(const void* x, void* y, int B, int H, int W, int C,
                   cudaStream_t stream) {
  const long long total = (long long)B * ((H + 1) / 2) * ((W + 1) / 2) * C;
  const unsigned blocks = (unsigned)((total + NT - 1) / NT);
  maxpool_3x3_s2_kernel<T><<<blocks, NT, 0, stream>>>(
      (const T*)x, (T*)y, B, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Return: cudaGetLastError() code.
extern "C" {

int simpb_maxpool_3x3_s2(const void* x, void* y, int B, int H, int W, int C,
                         int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dtype ? launch_maxpool<__nv_bfloat16>(x, y, B, H, W, C, st)
               : launch_maxpool<float>(x, y, B, H, W, C, st);
}

// wd == NULL: identity residual (requires C == Co, stride 1).
int simpb_bottleneck(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, const void* w3,
                     const void* b3, const void* wd, const void* bd, void* y,
                     int B, int H, int W, int C, int Cm, int Co, int stride,
                     int th, int tw, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *fb1 = (const float*)b1, *fb2 = (const float*)b2,
              *fb3 = (const float*)b3, *fbd = (const float*)bd;
  if (wd) {
    return dtype ? launch_bottleneck<__nv_bfloat16, true>(
                       x, w1, fb1, w2, fb2, w3, fb3, wd, fbd, y, B, H, W, C,
                       Cm, Co, stride, th, tw, st)
                 : launch_bottleneck<float, true>(
                       x, w1, fb1, w2, fb2, w3, fb3, wd, fbd, y, B, H, W, C,
                       Cm, Co, stride, th, tw, st);
  }
  return dtype ? launch_bottleneck<__nv_bfloat16, false>(
                     x, w1, fb1, w2, fb2, w3, fb3, nullptr, nullptr, y, B, H,
                     W, C, Cm, Co, 1, th, tw, st)
               : launch_bottleneck<float, false>(
                     x, w1, fb1, w2, fb2, w3, fb3, nullptr, nullptr, y, B, H,
                     W, C, Cm, Co, 1, th, tw, st);
}

int simpb_conv3x3_bias(const void* x, const void* w, const void* bias,
                       void* y, int B, int H, int W, int C, int Co, int th,
                       int tw, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* fb = (const float*)bias;
  return dtype ? launch_conv3x3<__nv_bfloat16>(x, w, fb, y, B, H, W, C, Co,
                                               th, tw, st)
               : launch_conv3x3<float>(x, w, fb, y, B, H, W, C, Co, th, tw,
                                       st);
}

}  // extern "C"
