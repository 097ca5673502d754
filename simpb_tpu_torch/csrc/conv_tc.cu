// Tensor-core kernels for the bf16 trunk on Hopper (sm_90a): K2
// (stage-head bottleneck with the strided 1x1 downsample skip), K3
// (bottleneck with identity residual) and K4 (3x3 conv + bias). NHWC
// activations, HWIO / [in, out] bf16 weights with BatchNorm folded, fp32
// biases, fp32 accumulation.
//
// Replace, for bf16, the CUDA-core kernels of csrc/conv_fused.cu, which
// replace the Pallas kernels of simpb_tpu/ops/conv_fused.py:
//   bottleneck_down_tc_kernel <- bottleneck_down_fused_infer (_kernel_down)
//   bottleneck_tc_kernel      <- bottleneck_fused_infer      (_kernel)
//   conv3x3_tc_kernel         <- conv3x3_bias_fused          (_conv3x3_kernel)
// The fp32 kernels stay on conv_fused.cu.
//
// What bounds them: both are products, bound by operations at the
// trunk's shapes (PERF.md). Every product runs on the tensor cores
// through one building block, `tc_pass`:
//
//   acc[bm x bn] += A[bm rows, K] . W[K, n0 : n0 + bn]
//
// * A rows sit at per-row shared-memory addresses and are read with
//   `ldmatrix`; the row address of each lane does a 3x3 conv's im2col
//   shift for free (tap (dy, dx) is the halo tile read at offset
//   (dy * Rw + dx) rows). Or A is streamed from device memory through
//   the ring with the weights (a 1x1 conv over the input), rows outside
//   the image zero-filled by `cp.async`.
// * W streams through a ring of STAGES shared-memory stages, BK (32 or
//   64) rows deep, with 16-byte `cp.async` copies.
// * Every shared-memory row is padded by 16 bytes, so the 8 row
//   addresses of one `ldmatrix` 8x8 load fall on 8 different 16-byte
//   bank groups (row strides are multiples of 128 B plus 16).
// * Operands stay bf16 from device memory to `mma.sync.m16n8k16`; the
//   sum stays in fp32 registers. Each warp owns a (16 MT) x 64 tile of a
//   pass; a pass is 8 warps laid out wm x (8 / wm).
//
// This is `mma.sync`, not yet `wgmma`: it takes the fragments `ldmatrix`
// gives as they are and needs no descriptor layout for W. The `wgmma`
// version keeps A in registers from the same `ldmatrix` loads and reads
// W from the ring through a shared-memory descriptor, in its 8x8
// core-matrix (swizzled) layout, on 64-row warpgroup tiles (ROADMAP B.6).
//
// Rounding is the plain versions' (ops/conv_fused.py): y1 = bf16(relu(.)),
// y2 = bf16(relu(.)); K3 out = bf16(relu(bf16(y3) + x)); K2 out =
// bf16(relu(y3 + skip)), the add in fp32; K4 bf16(acc + b).
//
// C interface (ctypes): every pointer and the stream are void*; the
// caller (ops/conv_fused.py's planner) passes the tile plan and the
// dynamic shared memory it sized; each function returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue when
// the plan's shared memory is short of what the kernel lays out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;        // threads per block
constexpr int NWARPS = NT / 32;
constexpr int STAGES = 3;      // ring depth
constexpr int PAD = 8;         // bf16 added to every shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; `valid` false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One pass tile: wm warps along M, NWARPS / wm along N.
struct Pass {
  int wm, bm, bn;
};
template <int MT>
__host__ __device__ inline Pass make_pass(int wm) {
  return Pass{wm, 16 * MT * wm, 64 * (NWARPS / wm)};
}
// bf16 elements of one ring stage: the streamed A chunk (rows BK + PAD
// apart), then W's chunk
__host__ __device__ inline int stage_elems(Pass p, bool stream_a, int bk) {
  return (stream_a ? p.bm * (bk + PAD) : 0) + bk * (p.bn + PAD);
}
// bf16 elements of a bottleneck's ring stage: the largest of its passes
// (K2's last pass layout also streams the skip's A from x)
__host__ __device__ inline int ring_stage(Pass a, Pass b, Pass c, int bk,
                                          bool c_streams = false) {
  const int sa = stage_elems(a, true, bk), sb = stage_elems(b, false, bk),
            sc = stage_elems(c, c_streams, bk);
  return sa > sb ? (sa > sc ? sa : sc) : (sb > sc ? sb : sc);
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][8][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// The building block: acc += A[m0 : m0 + bm, :] . w[:, n0 : n0 + bn] over
// nk chunks of BK. w is [nk * BK, N] row-major in device memory.
//   STREAM_A: A row m is xa[row_off(m) + k] in device memory
//             (row_off < 0: a zero row), streamed with the weights;
//   else:     A row m, chunk kc is as[row_off(m) + k_off(kc) + k] in
//             shared memory (resident).
// Rows m >= M compute garbage that tc_store never writes. Every thread
// of the block calls this with the same arguments. On return the ring
// is free and every copy has landed.
template <int MT, int BK, bool STREAM_A, typename RowF, typename KF>
__device__ __forceinline__ void tc_pass(
    float (&acc)[MT][8][4], const Pass ps, int m0, int M, int n0, int nk,
    const bf16* __restrict__ w, int N, bf16* ring, int st_elems,
    const bf16* __restrict__ xa, const bf16* as, RowF row_off, KF k_off) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm0 = (warp % ps.wm) * 16 * MT, wn0 = (warp / ps.wm) * 64;
  constexpr int A_LD = BK + PAD;  // row stride of a streamed A chunk
  const int a_elems = STREAM_A ? ps.bm * A_LD : 0;
  const int b_ld = ps.bn + PAD, bchunks = ps.bn / 8;
  const bool live = m0 + wm0 < M;

  auto load = [&](int slot, int kc) {
    bf16* st = ring + slot * st_elems;
    bf16* bs = st + a_elems;
    for (int e = tid; e < BK * bchunks; e += NT) {
      const int r = e / bchunks, c = e - r * bchunks;
      cp_async16(bs + r * b_ld + c * 8,
                 w + (long long)(kc * BK + r) * N + n0 + c * 8, true);
    }
    if constexpr (STREAM_A) {
      for (int e = tid; e < ps.bm * (BK / 8); e += NT) {
        const int r = e / (BK / 8), c = e % (BK / 8), m = m0 + r;
        const long long off = m < M ? row_off(m) : -1;
        cp_async16(st + r * A_LD + c * 8,
                   off >= 0 ? xa + off + kc * BK + c * 8 : xa, off >= 0);
      }
    }
  };

  // resident A: this lane's ldmatrix row of each 16-row sub-tile
  long long ro[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = m0 + wm0 + i * 16 + (lane & 15);
    ro[i] = STREAM_A ? 0 : row_off(m < M ? m : m0);
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nx = kc + STAGES - 1;
    if (nx < nk) load(nx % STAGES, nx);
    cp_commit();
    if (!live) continue;
    const bf16* st = ring + (kc % STAGES) * st_elems;
    const bf16* bs = st + a_elems;
    const long long ko = STREAM_A ? 0 : k_off(kc);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int col = ks * 16 + (lane >> 4) * 8;
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if constexpr (STREAM_A)
          ldsm_x4(af[i], st + (wm0 + i * 16 + (lane & 15)) * A_LD + col);
        else
          ldsm_x4(af[i], as + ro[i] + ko + col);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, bs + (ks * 16 + (lane & 15)) * b_ld + wn0 + j * 16 +
                           (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * j], af[i], bfr[0], bfr[1]);
          mma_bf16(acc[i][2 * j + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
}

// Calls epi(m, n, v0, v1) for each live row m < M of the pass tile and
// each column pair (n, n + 1) of this thread's accumulators.
template <int MT, typename Epi>
__device__ __forceinline__ void tc_store(float (&acc)[MT][8][4],
                                         const Pass ps, int m0, int M,
                                         int n0, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp % ps.wm) * 16 * MT, wn0 = (warp / ps.wm) * 64;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        epi(m, n0 + wn0 + j * 8 + 2 * t, acc[i][j][2 * h],
            acc[i][j][2 * h + 1]);
    }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------- K4
// One block = one th x tw output tile of one image and bn output
// channels (blockIdx.y). The input halo tile ((th + 2) x (tw + 2) x C,
// zero outside the image) is copied into shared memory once, by
// cp.async in its own group ahead of the first weight stages; then
// 9 taps x C / BK chunks walk over it (K = 9 C, tap-major, matching
// the HWIO weights' row order).
template <int MT, int BK>
__global__ void __launch_bounds__(NT) conv3x3_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ bias, bf16* __restrict__ y, int H, int W,
    int C, int Co, int th, int tw, int wm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* halo = reinterpret_cast<bf16*>(smem_raw);
  const int ntw = (W + tw - 1) / tw;
  const int oy0 = (blockIdx.x / ntw) * th, ox0 = (blockIdx.x % ntw) * tw;
  const int b = blockIdx.z;
  const Pass ps = make_pass<MT>(wm);
  const int n0 = blockIdx.y * ps.bn;
  const int Rw = tw + 2, Rp = (th + 2) * Rw, P = th * tw, Cs = C + PAD;
  bf16* ring = halo + (long long)Rp * Cs;
  const int st = stage_elems(ps, false, BK);
  const bf16* xb = x + (long long)b * H * W * C;

  const int cchunks = C / 8;
  for (int e = threadIdx.x; e < Rp * cchunks; e += NT) {
    const int r = e / cchunks, c = e - r * cchunks;
    const int iy = oy0 - 1 + r / Rw, ix = ox0 - 1 + r % Rw;
    const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
    cp_async16(halo + r * Cs + c * 8,
               in ? xb + ((long long)iy * W + ix) * C + c * 8 : xb, in);
  }
  cp_commit();

  const int kpt = C / BK;  // chunks per tap
  auto row = [&](int p) -> long long {
    return ((long long)(p / tw) * Rw + p % tw) * Cs;
  };
  auto koff = [&](int kc) -> long long {
    const int tap = kc / kpt;
    return ((long long)(tap / 3) * Rw + tap % 3) * Cs + (kc - tap * kpt) * BK;
  };
  float acc[MT][8][4];
  for (int m0 = 0; m0 < P; m0 += ps.bm) {
    zero(acc);
    tc_pass<MT, BK, false>(acc, ps, m0, P, n0, 9 * kpt, w, Co, ring, st,
                       nullptr, halo, row, koff);
    tc_store(acc, ps, m0, P, n0, [&](int p, int n, float v0, float v1) {
      const int oy = oy0 + p / tw, ox = ox0 + p % tw;
      if (oy < H && ox < W)
        store2(y + (((long long)b * H + oy) * W + ox) * Co + n,
               v0 + bias[n], v1 + bias[n + 1]);
    });
  }
}

// ---------------------------------------------------------------- K3
// One block = one th x tw output tile of one image, all channels, the
// three products in one launch with the intermediates in shared memory:
//   (a) y1 = relu(x . W1 + b1) over the tile plus a one-pixel halo,
//       zero outside the image; A streamed from x (zero-filled rows
//       outside the image);
//   (b) y2 = relu(conv3x3(y1) + b2); A = y1 with tap-shifted rows;
//   (c) out = relu(bf16(y2 . W3 + b3) + x); A = y2.
// wma, wmb, wmc: each product's warp layout (make_pass).
template <int MT, int BK>
__global__ void __launch_bounds__(NT) bottleneck_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const bf16* __restrict__ w3,
    const float* __restrict__ b3, bf16* __restrict__ y, int H, int W, int C,
    int Cm, int th, int tw, int wma, int wmb, int wmc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ntw = (W + tw - 1) / tw;
  const int oy0 = (blockIdx.x / ntw) * th, ox0 = (blockIdx.x % ntw) * tw;
  const int b = blockIdx.y;
  const int Rw = tw + 2, Rp = (th + 2) * Rw, P = th * tw, Cs = Cm + PAD;
  bf16* y1 = reinterpret_cast<bf16*>(smem_raw);
  bf16* y2 = y1 + (long long)Rp * Cs;
  bf16* ring = y2 + (long long)P * Cs;
  const Pass pa = make_pass<MT>(wma), pb = make_pass<MT>(wmb),
             pc = make_pass<MT>(wmc);
  const int st = ring_stage(pa, pb, pc, BK);
  const bf16* xb = x + (long long)b * H * W * C;
  bf16* yb = y + (long long)b * H * W * C;

  // region pixel r -> offset of its input row, or -1 outside the image
  auto region_off = [&](int r) -> long long {
    const int iy = oy0 - 1 + r / Rw, ix = ox0 - 1 + r % Rw;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return -1;
    return ((long long)iy * W + ix) * C;
  };
  auto out_off = [&](int p) -> long long {  // output pixel, or -1
    const int oy = oy0 + p / tw, ox = ox0 + p % tw;
    if (oy >= H || ox >= W) return -1;
    return ((long long)oy * W + ox) * C;
  };
  auto lin = [](int kc) -> long long { return (long long)kc * BK; };
  float acc[MT][8][4];

  // (a) 1x1 reduce over the halo region
  for (int m0 = 0; m0 < Rp; m0 += pa.bm)
    for (int n0 = 0; n0 < Cm; n0 += pa.bn) {
      zero(acc);
      tc_pass<MT, BK, true>(acc, pa, m0, Rp, n0, C / BK, w1, Cm, ring, st, xb,
                        nullptr, region_off, lin);
      tc_store(acc, pa, m0, Rp, n0, [&](int r, int n, float v0, float v1) {
        const bool in = region_off(r) >= 0;
        store2(y1 + r * Cs + n, in ? fmaxf(v0 + b1[n], 0.f) : 0.f,
               in ? fmaxf(v1 + b1[n + 1], 0.f) : 0.f);
      });
    }
  __syncthreads();

  // (b) 3x3 conv of y1, K = 9 Cm in tap-major order
  {
    const int kpt = Cm / BK;
    auto row = [&](int p) -> long long {
      return ((long long)(p / tw) * Rw + p % tw) * Cs;
    };
    auto koff = [&](int kc) -> long long {
      const int tap = kc / kpt;
      return ((long long)(tap / 3) * Rw + tap % 3) * Cs +
             (kc - tap * kpt) * BK;
    };
    for (int m0 = 0; m0 < P; m0 += pb.bm)
      for (int n0 = 0; n0 < Cm; n0 += pb.bn) {
        zero(acc);
        tc_pass<MT, BK, false>(acc, pb, m0, P, n0, 9 * kpt, w2, Cm, ring, st,
                           nullptr, y1, row, koff);
        tc_store(acc, pb, m0, P, n0, [&](int p, int n, float v0, float v1) {
          store2(y2 + p * Cs + n, fmaxf(v0 + b2[n], 0.f),
                 fmaxf(v1 + b2[n + 1], 0.f));
        });
      }
  }
  __syncthreads();

  // (c) 1x1 expansion + identity residual
  for (int m0 = 0; m0 < P; m0 += pc.bm)
    for (int n0 = 0; n0 < C; n0 += pc.bn) {
      zero(acc);
      tc_pass<MT, BK, false>(
          acc, pc, m0, P, n0, Cm / BK, w3, C, ring, st, nullptr, y2,
          [&](int p) -> long long { return (long long)p * Cs; }, lin);
      tc_store(acc, pc, m0, P, n0, [&](int p, int n, float v0, float v1) {
        const long long o = out_off(p);
        if (o < 0) return;
        // y3 rounds to bf16 before the residual add
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xb + o + n));
        const float s0 = __bfloat162float(__float2bfloat16(v0 + b3[n])) + r.x;
        const float s1 =
            __bfloat162float(__float2bfloat16(v1 + b3[n + 1])) + r.y;
        store2(yb + o + n, fmaxf(s0, 0.f), fmaxf(s1, 0.f));
      });
    }
}

// ---------------------------------------------------------------- K2
// y1's shared-memory rows: region pixel (ry, rx) of a tile's input region
// -> its row. Stride 1: one (th + 2) x (tw + 2) plane, K3's layout.
// Stride 2: four parity planes (ry % 2, rx % 2), each pw = tw + 1 rows
// wide and th + 1 (even ry) or th (odd ry) high, pixel (ry, rx) at
// (ry / 2, rx / 2) of its plane. Why: the 8 rows of one ldmatrix are 8
// neighbouring output pixels. In one plane, a stride-2 tap puts them 2
// region pixels apart, 4 Cm + 32 bytes, which is 32 mod 128 for Cm a
// multiple of 64: 4 of the 8 16-byte bank groups, a 2-way conflict on
// every A load of the 3x3. In the parity planes tap (dy, dx) of output
// (oy, ox) reads plane (dy % 2, dx % 2) at (oy + dy / 2, ox + dx / 2):
// neighbouring outputs read neighbouring rows, 2 Cm + 16 bytes apart, 8
// bank groups. (The Pallas kernel built the same planes for the TPU
// compiler's sake, _fill_parity_planes.) In both layouts
//   row(s oy + dy, s ox + dx) = oy pw + ox + row(dy, dx),
// so a tap's offset adds to a pixel's, as tc_pass wants.
struct Y1Rows {
  int s, pw, h0;  // stride, plane width, height of the even-row planes
  __host__ __device__ Y1Rows(int s_, int th, int tw)
      : s(s_), pw(s_ == 1 ? tw + 2 : tw + 1), h0(s_ == 1 ? th + 2 : th + 1) {}
  __host__ __device__ int count() const {
    return s == 1 ? h0 * pw : 2 * (2 * h0 - 1) * pw;
  }
  __device__ int operator()(int ry, int rx) const {
    if (s == 1) return ry * pw + rx;
    const int py = ry & 1, px = rx & 1;
    return (2 * h0 * py + px * (h0 - py) + (ry >> 1)) * pw + (rx >> 1);
  }
};

// One block = one th x tw output tile of one image, all channels, the
// four products in one launch with the intermediates in shared memory:
//   (a) y1 = relu(x . W1 + b1) over the tile's input region plus a
//       one-pixel halo, ((th - 1) s + 3) x ((tw - 1) s + 3) pixels, zero
//       outside the image; A streamed from x; stored in Y1Rows' layout;
//   (b) y2 = relu(conv3x3/s(y1) + b2); A = y1 at tap-shifted rows;
//   (c) y2 . W3 and (d) x[s oy, s ox] . Wd into one fp32 accumulator,
//       (c)'s A resident (y2), (d)'s streamed from x at strided rows;
//   out = bf16(relu(acc + b3 + bd)): y3 is not rounded before the skip
//   add (the Pallas kernel's rounding points).
// wma, wmb, wmc: the warp layouts of (a), (b), and (c) and (d).
template <int MT, int BK>
__global__ void __launch_bounds__(NT) bottleneck_down_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ b2, const bf16* __restrict__ w3,
    const float* __restrict__ b3, const bf16* __restrict__ wd,
    const float* __restrict__ bd, bf16* __restrict__ y, int H, int W, int C,
    int Cm, int Co, int s, int th, int tw, int wma, int wmb, int wmc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int OH = H / s, OW = W / s, ntw = (OW + tw - 1) / tw;
  const int oy0 = (blockIdx.x / ntw) * th, ox0 = (blockIdx.x % ntw) * tw;
  const int b = blockIdx.y;
  const int Rw = (tw - 1) * s + 3, Rp = ((th - 1) * s + 3) * Rw;
  const int P = th * tw, Cs = Cm + PAD;
  const Y1Rows yrow(s, th, tw);
  bf16* y1 = reinterpret_cast<bf16*>(smem_raw);
  bf16* y2 = y1 + (long long)yrow.count() * Cs;
  bf16* ring = y2 + (long long)P * Cs;
  const Pass pa = make_pass<MT>(wma), pb = make_pass<MT>(wmb),
             pc = make_pass<MT>(wmc);
  const int st = ring_stage(pa, pb, pc, BK, true);
  const bf16* xb = x + (long long)b * H * W * C;
  bf16* yb = y + (long long)b * OH * OW * Co;

  // region pixel r -> offset of its input row, or -1 outside the image
  auto region_off = [&](int r) -> long long {
    const int iy = oy0 * s - 1 + r / Rw, ix = ox0 * s - 1 + r % Rw;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return -1;
    return ((long long)iy * W + ix) * C;
  };
  // output pixel p -> offset of its skip input row x[s oy, s ox], or -1
  auto skip_off = [&](int p) -> long long {
    const int oy = oy0 + p / tw, ox = ox0 + p % tw;
    if (oy >= OH || ox >= OW) return -1;
    return ((long long)oy * s * W + (long long)ox * s) * C;
  };
  auto lin = [](int kc) -> long long { return (long long)kc * BK; };
  float acc[MT][8][4];

  // (a) 1x1 reduce over the input region
  for (int m0 = 0; m0 < Rp; m0 += pa.bm)
    for (int n0 = 0; n0 < Cm; n0 += pa.bn) {
      zero(acc);
      tc_pass<MT, BK, true>(acc, pa, m0, Rp, n0, C / BK, w1, Cm, ring, st, xb,
                        nullptr, region_off, lin);
      tc_store(acc, pa, m0, Rp, n0, [&](int r, int n, float v0, float v1) {
        const bool in = region_off(r) >= 0;
        store2(y1 + (long long)yrow(r / Rw, r % Rw) * Cs + n,
               in ? fmaxf(v0 + b1[n], 0.f) : 0.f,
               in ? fmaxf(v1 + b1[n + 1], 0.f) : 0.f);
      });
    }
  __syncthreads();

  // (b) 3x3 / stride s conv of y1, K = 9 Cm in tap-major order
  {
    const int kpt = Cm / BK;
    auto row = [&](int p) -> long long {
      return ((long long)(p / tw) * yrow.pw + p % tw) * Cs;
    };
    auto koff = [&](int kc) -> long long {
      const int tap = kc / kpt;
      return (long long)yrow(tap / 3, tap % 3) * Cs + (kc - tap * kpt) * BK;
    };
    for (int m0 = 0; m0 < P; m0 += pb.bm)
      for (int n0 = 0; n0 < Cm; n0 += pb.bn) {
        zero(acc);
        tc_pass<MT, BK, false>(acc, pb, m0, P, n0, 9 * kpt, w2, Cm, ring, st,
                           nullptr, y1, row, koff);
        tc_store(acc, pb, m0, P, n0, [&](int p, int n, float v0, float v1) {
          store2(y2 + p * Cs + n, fmaxf(v0 + b2[n], 0.f),
                 fmaxf(v1 + b2[n + 1], 0.f));
        });
      }
  }
  __syncthreads();

  // (c) 1x1 expansion and (d) strided 1x1 skip, one accumulator
  for (int m0 = 0; m0 < P; m0 += pc.bm)
    for (int n0 = 0; n0 < Co; n0 += pc.bn) {
      zero(acc);
      tc_pass<MT, BK, false>(
          acc, pc, m0, P, n0, Cm / BK, w3, Co, ring, st, nullptr, y2,
          [&](int p) -> long long { return (long long)p * Cs; }, lin);
      tc_pass<MT, BK, true>(acc, pc, m0, P, n0, C / BK, wd, Co, ring, st, xb,
                        nullptr, skip_off, lin);
      tc_store(acc, pc, m0, P, n0, [&](int p, int n, float v0, float v1) {
        const int oy = oy0 + p / tw, ox = ox0 + p % tw;
        if (oy >= OH || ox >= OW) return;
        store2(yb + ((long long)oy * OW + ox) * Co + n,
               fmaxf(v0 + b3[n] + bd[n], 0.f),
               fmaxf(v1 + b3[n + 1] + bd[n + 1], 0.f));
      });
    }
}

template <int MT, int BK>
int launch_conv3x3(const void* x, const void* w, const void* bias, void* y,
                   int B, int H, int W, int C, int Co, int th, int tw,
                   int wm, int smem, cudaStream_t stream) {
  const Pass ps = make_pass<MT>(wm);
  const long long need =
      2LL * ((long long)(th + 2) * (tw + 2) * (C + PAD) +
             STAGES * stage_elems(ps, false, BK));
  if (need > smem || Co % ps.bn || C % BK) return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // the attribute only grows (one card)
  if (smem > smem_set) {
    cudaFuncSetAttribute(conv3x3_tc_kernel<MT, BK>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set = smem;
  }
  dim3 grid(((H + th - 1) / th) * ((W + tw - 1) / tw), Co / ps.bn, B);
  conv3x3_tc_kernel<MT, BK><<<grid, NT, smem, stream>>>(
      (const bf16*)x, (const bf16*)w, (const float*)bias, (bf16*)y, H, W, C,
      Co, th, tw, wm);
  return (int)cudaGetLastError();
}

template <int MT, int BK>
int launch_bottleneck(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, const void* w3,
                      const void* b3, void* y, int B, int H, int W, int C,
                      int Cm, int th, int tw, int wma, int wmb, int wmc,
                      int smem, cudaStream_t stream) {
  const Pass pa = make_pass<MT>(wma), pb = make_pass<MT>(wmb),
             pc = make_pass<MT>(wmc);
  const int st = ring_stage(pa, pb, pc, BK);
  const long long need =
      2LL * (((long long)(th + 2) * (tw + 2) + th * tw) * (Cm + PAD) +
             STAGES * st);
  if (need > smem || Cm % pa.bn || Cm % pb.bn || C % pc.bn || C % BK ||
      Cm % BK)
    return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // the attribute only grows (one card)
  if (smem > smem_set) {
    cudaFuncSetAttribute(bottleneck_tc_kernel<MT, BK>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set = smem;
  }
  dim3 grid(((H + th - 1) / th) * ((W + tw - 1) / tw), B);
  bottleneck_tc_kernel<MT, BK><<<grid, NT, smem, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (bf16*)y, H, W, C,
      Cm, th, tw, wma, wmb, wmc);
  return (int)cudaGetLastError();
}

template <int MT, int BK>
int launch_bottleneck_down(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* w3,
                           const void* b3, const void* wd, const void* bd,
                           void* y, int B, int H, int W, int C, int Cm,
                           int Co, int s, int th, int tw, int wma, int wmb,
                           int wmc, int smem, cudaStream_t stream) {
  if ((s != 1 && s != 2) || H % s || W % s) return (int)cudaErrorInvalidValue;
  const Pass pa = make_pass<MT>(wma), pb = make_pass<MT>(wmb),
             pc = make_pass<MT>(wmc);
  const long long need =
      2LL * ((long long)(Y1Rows(s, th, tw).count() + th * tw) * (Cm + PAD) +
             STAGES * ring_stage(pa, pb, pc, BK, true));
  if (need > smem || Cm % pa.bn || Cm % pb.bn || Co % pc.bn || C % BK ||
      Cm % BK)
    return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // the attribute only grows (one card)
  if (smem > smem_set) {
    cudaFuncSetAttribute(bottleneck_down_tc_kernel<MT, BK>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set = smem;
  }
  dim3 grid(((H / s + th - 1) / th) * ((W / s + tw - 1) / tw), B);
  bottleneck_down_tc_kernel<MT, BK><<<grid, NT, smem, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (const bf16*)wd,
      (const float*)bd, (bf16*)y, H, W, C, Cm, Co, s, th, tw, wma, wmb, wmc);
  return (int)cudaGetLastError();
}

}  // namespace

// One instance for each (mt, bk) pair the planner may pick. K2 has no
// mt 1: ptxas holds that instance to 128 registers, and it spills.
#define TC_DISPATCH_MT24(LAUNCH, ...)                               \
  switch (mt * 100 + bk) {                                          \
    case 232: return LAUNCH<2, 32>(__VA_ARGS__);                    \
    case 264: return LAUNCH<2, 64>(__VA_ARGS__);                    \
    case 432: return LAUNCH<4, 32>(__VA_ARGS__);                    \
    case 464: return LAUNCH<4, 64>(__VA_ARGS__);                    \
  }                                                                 \
  return (int)cudaErrorInvalidValue;
#define TC_DISPATCH(LAUNCH, ...)                                    \
  if (mt == 1 && bk == 32) return LAUNCH<1, 32>(__VA_ARGS__);       \
  if (mt == 1 && bk == 64) return LAUNCH<1, 64>(__VA_ARGS__);       \
  TC_DISPATCH_MT24(LAUNCH, __VA_ARGS__)

// Return: cudaGetLastError() code of the launch.
extern "C" {

int simpb_conv3x3_tc(const void* x, const void* w, const void* bias, void* y,
                     int B, int H, int W, int C, int Co, int th, int tw,
                     int mt, int bk, int wm, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  TC_DISPATCH(launch_conv3x3, x, w, bias, y, B, H, W, C, Co, th, tw, wm,
              smem, st)
}

int simpb_bottleneck_tc(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, const void* w3,
                        const void* b3, void* y, int B, int H, int W, int C,
                        int Cm, int th, int tw, int mt, int bk, int wma,
                        int wmb, int wmc, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  TC_DISPATCH(launch_bottleneck, x, w1, b1, w2, b2, w3, b3, y, B, H, W, C,
              Cm, th, tw, wma, wmb, wmc, smem, st)
}

int simpb_bottleneck_down_tc(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* w3,
                             const void* b3, const void* wd, const void* bd,
                             void* y, int B, int H, int W, int C, int Cm,
                             int Co, int stride, int th, int tw, int mt,
                             int bk, int wma, int wmb, int wmc, int smem,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  TC_DISPATCH_MT24(launch_bottleneck_down, x, w1, b1, w2, b2, w3, b3, wd,
                   bd, y, B, H, W, C, Cm, Co, stride, th, tw, wma, wmb, wmc,
                   smem, st)
}

}  // extern "C"
