// Hopper counterparts of the TPU compiler probes in tools/mosaic_probe.py:
// six small strided copies of a bf16 NHWC array, each computing what its
// Pallas body computes. One kernel per probe function:
//   probe_lane_kernel       <- p_lane       (P1, call :47)
//   probe_chunk_kernel      <- p_chunk      (P2, call :75)
//   probe_reshape_kernel    <- p_reshape    (P4, call :98)
//   probe_outer_kernel      <- p_outer_bf16 (P5, call :118)
//   probe_refshape_kernel   <- p_refshape   (P6, call :141)
//   probe_chunk_flat_kernel <- p_chunk_flat (P7, call :171)
//
// On the TPU the probes asked which strided VMEM loads the deployment
// Mosaic compiler could lower. On Hopper a strided address costs nothing,
// so each kernel just does the same staging and selection: the ones whose
// Pallas body stages the input as fp32 in a VMEM scratch stage it as fp32
// in shared memory, in the scratch's layout, and read the selection back
// from there; P4 and P5 read straight from device memory. bf16 -> fp32 ->
// bf16 is exact, so every kernel must equal its plain version bit for bit.
//
// What bounds them: bytes (one read of the input, one write of the
// output, a few KB at the probes' 16x16 shapes), so a launch's time is its
// launch latency. A scratch of [16, 16, 256] fp32 (256 KB) exceeds a
// block's 227 KB of shared memory, so each staging block holds one chunk
// of at most 128 channels: the grid runs over (batch, channel chunk), as
// the Pallas grid ran over the batch.
//
// C interface (ctypes): x, y and the stream are void*, shapes are int;
// each function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int NT = 256;  // threads per block
constexpr int CHUNK = 128;  // channels staged by one block (a TPU lane row)

__device__ __forceinline__ long long pix(int b, int i, int j, int h, int w) {
  return ((long long)b * h + i) * w + j;
}

// Stage the block's [H, W, cw] slice of x as fp32 at s[(i * W + j) * ld + k]
// (the scratch layout [H, W, C]; P6's [H, W/2, 2, C] is the same memory).
__device__ __forceinline__ void stage(const bf16* __restrict__ x, float* s,
                                      int b, int h, int w, int c, int c0,
                                      int cw, int ld) {
  for (int e = threadIdx.x; e < h * w * cw; e += blockDim.x) {
    const int k = e % cw, p = e / cw;
    s[p * ld + k] = __bfloat162float(x[((long long)b * h * w + p) * c + c0 + k]);
  }
  __syncthreads();
}

// P1: s[:] = x[0].astype(f32); o[0] = s[0:H:2, 0:W:2, :]
__global__ void probe_lane_kernel(const bf16* __restrict__ x,
                                  bf16* __restrict__ y, int h, int w, int c) {
  extern __shared__ float s[];
  const int b = blockIdx.x, c0 = blockIdx.y * CHUNK, cw = min(CHUNK, c - c0);
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  stage(x, s, b, h, w, c, c0, cw, cw);
  for (int e = threadIdx.x; e < oh * ow * cw; e += blockDim.x) {
    const int k = e % cw, p = e / cw, i = p / ow, j = p % ow;
    y[pix(b, i, j, oh, ow) * c + c0 + k] =
        __float2bfloat16_rn(s[(2 * i * w + 2 * j) * cw + k]);
  }
}

// P2: s[g] = x[0, :, :, 128g:128(g+1)] (scratch [G, H, W, 128]);
// o[0, :, :, 128g:128(g+1)] = s[g, 0:H:2, 0:W:2, :]. Block y = chunk g.
__global__ void probe_chunk_kernel(const bf16* __restrict__ x,
                                   bf16* __restrict__ y, int h, int w,
                                   int c) {
  extern __shared__ float s[];  // s[g] of the scratch: [H, W, 128]
  const int b = blockIdx.x, g = blockIdx.y;
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  stage(x, s, b, h, w, c, g * CHUNK, CHUNK, CHUNK);
  for (int e = threadIdx.x; e < oh * ow * CHUNK; e += blockDim.x) {
    const int k = e % CHUNK, p = e / CHUNK, i = p / ow, j = p % ow;
    y[pix(b, i, j, oh, ow) * c + g * CHUNK + k] =
        __float2bfloat16_rn(s[((2 * i) * w + 2 * j) * CHUNK + k]);
  }
}

// P4: v.reshape(H/2, 2, W/2, 2, C)[:, 0, :, 0, :], read straight from x.
__global__ void probe_reshape_kernel(const bf16* __restrict__ x,
                                     bf16* __restrict__ y, int n, int h,
                                     int w, int c) {
  const int oh = h / 2, ow = w / 2;
  const long long total = (long long)n * oh * ow * c;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(e % c);
    const long long p = e / c;
    const int j = (int)(p % ow), i = (int)(p / ow % oh), b = (int)(p / ow / oh);
    y[e] = x[pix(b, 2 * i, 2 * j, h, w) * c + k];
  }
}

// P5: o[0] = x[0, 0:H:2, :, :], bf16 rows strided, read straight from x.
__global__ void probe_outer_kernel(const bf16* __restrict__ x,
                                   bf16* __restrict__ y, int n, int h, int w,
                                   int c) {
  const int oh = (h + 1) / 2;
  const long long row = (long long)w * c;
  const long long total = (long long)n * oh * row;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / row;
    const int i = (int)(r % oh), b = (int)(r / oh);
    y[e] = x[((long long)b * h + 2 * i) * row + e % row];
  }
}

// P6: s[:] = x[0].astype(f32).reshape(H, W/2, 2, C); o[0] = s[:, :, 0, :]
__global__ void probe_refshape_kernel(const bf16* __restrict__ x,
                                      bf16* __restrict__ y, int h, int w,
                                      int c) {
  extern __shared__ float s[];  // [H, W/2, 2, cw]
  const int b = blockIdx.x, c0 = blockIdx.y * CHUNK, cw = min(CHUNK, c - c0);
  const int hw = w / 2;
  stage(x, s, b, h, w, c, c0, cw, cw);
  for (int e = threadIdx.x; e < h * hw * cw; e += blockDim.x) {
    const int k = e % cw, p = e / cw, i = p / hw, j = p % hw;
    y[pix(b, i, j, h, hw) * c + c0 + k] =
        __float2bfloat16_rn(s[((i * hw + j) * 2 + 0) * cw + k]);
  }
}

// P7: s[gH:(g+1)H] = x[0, :, :, 128g:128(g+1)] (scratch [G*H, W, 128]);
// o[0, :, :, 128g:128(g+1)] = s[gH:(g+1)H:2, 0:W:2, :]. Block y = chunk g
// holds scratch rows gH .. gH + H - 1.
__global__ void probe_chunk_flat_kernel(const bf16* __restrict__ x,
                                        bf16* __restrict__ y, int h, int w,
                                        int c) {
  extern __shared__ float s[];  // scratch rows [gH, (g+1)H): [H, W, 128]
  const int b = blockIdx.x, g = blockIdx.y;
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  stage(x, s, b, h, w, c, g * CHUNK, CHUNK, CHUNK);
  for (int e = threadIdx.x; e < oh * ow * CHUNK; e += blockDim.x) {
    const int k = e % CHUNK, p = e / CHUNK, i = p / ow, j = p % ow;
    const int row = g * h + 2 * i;  // a row of the flat [G*H, W, 128] scratch
    y[pix(b, i, j, oh, ow) * c + g * CHUNK + k] =
        __float2bfloat16_rn(s[((row - g * h) * w + 2 * j) * CHUNK + k]);
  }
}

typedef void (*StagedKernel)(const bf16*, bf16*, int, int, int);

int launch_staged(StagedKernel k, const void* x, void* y, int n, int h, int w,
                  int c, cudaStream_t st) {
  const int cw = c < CHUNK ? c : CHUNK;
  const int smem = h * w * cw * (int)sizeof(float);
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(n, (c + CHUNK - 1) / CHUNK);
  k<<<grid, NT, smem, st>>>((const bf16*)x, (bf16*)y, h, w, c);
  return (int)cudaGetLastError();
}

unsigned copy_blocks(long long total) {
  const long long b = (total + NT - 1) / NT;
  return (unsigned)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

}  // namespace

// x [N, H, W, C] bf16 contiguous; y as the probe's output. The wrappers in
// simpb_tpu_torch/tools/mosaic_probe.py check C % 128 == 0 for P2 and P7
// and even H, W where the probe needs them.
extern "C" {

int simpb_probe_lane(const void* x, void* y, int n, int h, int w, int c,
                     void* stream) {
  return launch_staged(probe_lane_kernel, x, y, n, h, w, c,
                       (cudaStream_t)stream);
}

int simpb_probe_chunk(const void* x, void* y, int n, int h, int w, int c,
                      void* stream) {
  return launch_staged(probe_chunk_kernel, x, y, n, h, w, c,
                       (cudaStream_t)stream);
}

int simpb_probe_reshape(const void* x, void* y, int n, int h, int w, int c,
                        void* stream) {
  const long long total = (long long)n * (h / 2) * (w / 2) * c;
  probe_reshape_kernel<<<copy_blocks(total), NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (bf16*)y, n, h, w, c);
  return (int)cudaGetLastError();
}

int simpb_probe_outer(const void* x, void* y, int n, int h, int w, int c,
                      void* stream) {
  const long long total = (long long)n * ((h + 1) / 2) * w * c;
  probe_outer_kernel<<<copy_blocks(total), NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (bf16*)y, n, h, w, c);
  return (int)cudaGetLastError();
}

int simpb_probe_refshape(const void* x, void* y, int n, int h, int w, int c,
                         void* stream) {
  return launch_staged(probe_refshape_kernel, x, y, n, h, w, c,
                       (cudaStream_t)stream);
}

int simpb_probe_chunk_flat(const void* x, void* y, int n, int h, int w, int c,
                           void* stream) {
  return launch_staged(probe_chunk_flat_kernel, x, y, n, h, w, c,
                       (cudaStream_t)stream);
}

}  // extern "C"
