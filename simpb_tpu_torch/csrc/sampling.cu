// Deformable sampling kernels for Hopper (sm_90a): the forward passes of
// the detection head's two sampling ops, fp32 or bf16 features with fp32
// sums. On the TPU both ops were XLA gathers, not Pallas kernels (Pallas
// had no vector gather there); they replace
//   dfa_rank_kernel + dfa_kernel <- simpb_tpu/ops/sampling.py::
//       deformable_aggregation (capacity compaction :417-436, plain
//       sample_core :569-608; no sel_levels, no level_capacity)
//   msda_sel_kernel              <- simpb_tpu/ops/sampling.py::
//       _msda_patch_sel (:892-1007, window placement _window_base :168)
// and compute what their plain PyTorch versions in ops/sampling.py compute.
//
// What bounds them on an H100: bytes. DFA reads a few rows of C values per
// sample and does about ten operations per value read; the windowed MSDA
// reads an 8x8 window of C values per (query, level) and does 2 x heads
// operations per value, far below the ~20 fp32 operations per byte where
// the CUDA cores would become the limit. The design reads every gathered
// row once per block, with the channel index on the threads so that a
// warp reads contiguous bytes of a row, and keeps all per-sample and
// per-window intermediates in shared memory and registers: only the
// output touches device memory.
//
// DFA: `dfa_rank_kernel` (one block per camera row) ranks the in-range
// slots of each camera in slot order a * P + p with a block scan and marks
// those ranked below the capacity M -- the set the plain version's stable
// top-k keeps. `dfa_kernel` runs one block per (batch, anchor): its
// threads first place every (camera, point, level) sample of the anchor in
// shared memory, then each thread sums its channel over them. The sum is
// in-block and in a fixed order, so results are deterministic (no
// atomics; the plain version's index_add_ is atomic on the card).
//
// Rounding points. The plain version runs in the storage type: for bf16,
// the pixel position, the corner weights, each corner product, each pair
// sum, the sample and the weighted sample round to bf16 one by one. A
// kernel that kept positions in fp32 would compute another function
// (near x = 88 at a 176-wide level bf16 steps by 0.5 px), so every
// rounding is written out with __float2bfloat16_rn, and products and sums
// use __fmul_rn / __fadd_rn so that nvcc fuses nothing into an FMA. In
// fp32 the same explicit operations make every sample bit-identical to the
// plain version's; only the order of the fp32 sums differs.
//
// MSDA-sel: one block per (camera row, query): the attention mass of each
// level, the top-k levels (lower index first among ties, as topk_stable),
// each window's midrange base (rintf: round half to even, as torch.round),
// the taper-clamped samples, the per-head window weights [k, heads, ph*pw]
// in shared memory, then each thread contracts the window pixels of its
// channel with them. Everything fp32, as the plain version.
//
// C interface (ctypes): pointers and the stream are void*; shapes come in
// a host int array, strides in a host int64 array; each function returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int MAX_LEVELS = 8;
constexpr int MAX_HEADS = 16;
constexpr int RANK_NT = 1024;  // threads of a rank block (32 warps)

struct Levels {
  int n;
  int h[MAX_LEVELS], w[MAX_LEVELS], start[MAX_LEVELS];
};

// Loads and the storage type's rounding: R(v) rounds an fp32 result to T.
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ float R(float v);
template <> __device__ __forceinline__ float R<float>(float v) { return v; }
template <> __device__ __forceinline__ float R<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ bool in_range(float x, float y) {
  return x > 0.f && x < 1.f && y > 0.f && y < 1.f;
}

// ---------------------------------------------------------------- DFA
// pts [bs, A, P, cams, 2] and wts [bs, A, P, cams, L, G] by element
// strides; col [bs, cams, T, C] contiguous.
struct DfaArgs {
  int bs, cams, A, P, G, C, T, M;
  long long sp[5], sw[6];
};

// counted[bc, a * P + p] = 1 iff the slot is in range and fewer than M
// in-range slots of camera row bc come before it.
template <typename T>
__global__ void __launch_bounds__(RANK_NT)
dfa_rank_kernel(const T* __restrict__ pts, DfaArgs g,
                uint8_t* __restrict__ counted) {
  __shared__ int warp_sum[RANK_NT / 32];
  __shared__ int base;
  const int bc = blockIdx.x, batch = bc / g.cams, cam = bc % g.cams;
  const int S = g.A * g.P, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int s0 = 0; s0 < S; s0 += RANK_NT) {
    const int s = s0 + threadIdx.x;
    int flag = 0;
    if (s < S) {
      const T* q = pts + batch * g.sp[0] + (s / g.P) * g.sp[1] +
                   (s % g.P) * g.sp[2] + cam * g.sp[3];
      flag = in_range(ld(q), ld(q + g.sp[4]));
    }
    int v = flag;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      int t = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += u;
      }
      warp_sum[lane] = t;
    }
    __syncthreads();
    const int rank = base + (warp ? warp_sum[warp - 1] : 0) + v - flag;
    if (s < S) counted[(long long)bc * S + s] = flag && rank < g.M;
    __syncthreads();
    if (threadIdx.x == 0) base += warp_sum[RANK_NT / 32 - 1];
    __syncthreads();
  }
}

// One block per (anchor, batch); out [bs, A, C] fp32. Shared memory per
// sample e = (cam * P + p) * L + l: corner weights wx0 wx1 wy0 wy1, the
// G group weights, four corner rows (pixel index within the camera's
// column) and a live flag.
template <typename T>
__global__ void dfa_kernel(const T* __restrict__ col, const T* __restrict__ pts,
                           const T* __restrict__ wts,
                           const uint8_t* __restrict__ counted, DfaArgs g,
                           Levels lv, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int a = blockIdx.x, batch = blockIdx.y;
  const int L = lv.n, E = g.cams * g.P * L, S = g.A * g.P;
  float* cw = smem;                  // [E][4]
  float* gw = cw + 4 * E;            // [E][G]
  int* rows = (int*)(gw + E * g.G);  // [E][4]
  int* live = rows + 4 * E;          // [E]

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int l = e % L, p = e / L % g.P, cam = e / L / g.P;
    const T* q = pts + batch * g.sp[0] + a * g.sp[1] + p * g.sp[2] +
                 cam * g.sp[3];
    const float locx = ld(q), locy = ld(q + g.sp[4]);
    const int on = counted
        ? counted[(long long)(batch * g.cams + cam) * S + a * g.P + p]
        : in_range(locx, locy);
    live[e] = on;
    if (!on) continue;
    const int h = lv.h[l], w = lv.w[l];
    // x = loc * w - 0.5, each step rounded to T (_corner_weights)
    const float x = R<T>(__fsub_rn(R<T>(__fmul_rn(locx, (float)w)), 0.5f));
    const float y = R<T>(__fsub_rn(R<T>(__fmul_rn(locy, (float)h)), 0.5f));
    const float x0f = floorf(x), y0f = floorf(y);
    const float fx = R<T>(__fsub_rn(x, x0f)), fy = R<T>(__fsub_rn(y, y0f));
    const int x0 = (int)x0f, y0 = (int)y0f;
    cw[4 * e + 0] = (x0 >= 0 && x0 < w) ? R<T>(__fsub_rn(1.f, fx)) : 0.f;
    cw[4 * e + 1] = (x0 + 1 >= 0 && x0 + 1 < w) ? fx : 0.f;
    cw[4 * e + 2] = (y0 >= 0 && y0 < h) ? R<T>(__fsub_rn(1.f, fy)) : 0.f;
    cw[4 * e + 3] = (y0 + 1 >= 0 && y0 + 1 < h) ? fy : 0.f;
    const int xc0 = min(max(x0, 0), w - 1), xc1 = min(max(x0 + 1, 0), w - 1);
    const int r0 = lv.start[l] + min(max(y0, 0), h - 1) * w;
    const int r1 = lv.start[l] + min(max(y0 + 1, 0), h - 1) * w;
    rows[4 * e + 0] = r0 + xc0;
    rows[4 * e + 1] = r0 + xc1;
    rows[4 * e + 2] = r1 + xc0;
    rows[4 * e + 3] = r1 + xc1;
    const T* wq = wts + batch * g.sw[0] + a * g.sw[1] + p * g.sw[2] +
                  cam * g.sw[3] + l * g.sw[4];
    for (int k = 0; k < g.G; ++k) gw[e * g.G + k] = ld(wq + k * g.sw[5]);
  }
  __syncthreads();

  const int gd = g.C / g.G;
  for (int c = threadIdx.x; c < g.C; c += blockDim.x) {
    const int grp = c / gd;
    float acc = 0.f;
    for (int e = 0; e < E; ++e) {
      if (!live[e]) continue;
      const int cam = e / L / g.P;
      const T* base =
          col + (long long)(batch * g.cams + cam) * g.T * g.C + c;
      const float wx0 = cw[4 * e], wx1 = cw[4 * e + 1];
      const float wy0 = cw[4 * e + 2], wy1 = cw[4 * e + 3];
      // a corner of zero weight adds a zero product: skip its read
      float vx0 = 0.f, vx1 = 0.f;
      if (wy0 != 0.f) {
        const float p0 = wx0 != 0.f
            ? R<T>(__fmul_rn(wx0, ld(base + (long long)rows[4 * e] * g.C)))
            : 0.f;
        const float p1 = wx1 != 0.f
            ? R<T>(__fmul_rn(wx1, ld(base + (long long)rows[4 * e + 1] * g.C)))
            : 0.f;
        vx0 = R<T>(__fadd_rn(p0, p1));
      }
      if (wy1 != 0.f) {
        const float p0 = wx0 != 0.f
            ? R<T>(__fmul_rn(wx0, ld(base + (long long)rows[4 * e + 2] * g.C)))
            : 0.f;
        const float p1 = wx1 != 0.f
            ? R<T>(__fmul_rn(wx1, ld(base + (long long)rows[4 * e + 3] * g.C)))
            : 0.f;
        vx1 = R<T>(__fadd_rn(p0, p1));
      }
      const float smp = R<T>(__fadd_rn(R<T>(__fmul_rn(wy0, vx0)),
                                       R<T>(__fmul_rn(wy1, vx1))));
      acc = __fadd_rn(acc, R<T>(__fmul_rn(smp, gw[e * g.G + grp])));
    }
    out[((long long)batch * g.A + a) * g.C + c] = acc;
  }
}

int dfa_smem_bytes(const DfaArgs& g, int L) {
  const int E = g.cams * g.P * L;
  return E * (4 + g.G) * (int)sizeof(float) + E * 5 * (int)sizeof(int);
}

template <typename T>
int launch_dfa(const void* col, const void* pts, const void* wts,
               uint8_t* counted, float* out, const DfaArgs& g,
               const Levels& lv, cudaStream_t st) {
  const bool rank = g.M >= 0 && g.M < g.A * g.P;
  if (rank) {
    dfa_rank_kernel<T><<<g.bs * g.cams, RANK_NT, 0, st>>>((const T*)pts, g,
                                                           counted);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int smem = dfa_smem_bytes(g, lv.n);
  cudaFuncSetAttribute(dfa_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int nt = g.C < 256 ? ((g.C + 31) / 32) * 32 : 256;
  dfa_kernel<T><<<dim3(g.A, g.bs), nt, smem, st>>>(
      (const T*)col, (const T*)pts, (const T*)wts, rank ? counted : nullptr,
      g, lv, out);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ MSDA-sel
struct MsdaArgs {
  int B, Q, n, heads, C, T, K, ph, pw;
};

// pixel position loc * size - 0.5 in fp32, two roundings as in torch
__device__ __forceinline__ float pix(float loc, int size) {
  return __fsub_rn(__fmul_rn(loc, (float)size), 0.5f);
}

// value [B, T, C]; loc [B, Q, L, n, 2] and attw [B, Q, L, n] fp32 with the
// n = heads * points samples head-major; sampled [B, Q, heads, C] and
// wsum [B, Q, heads] fp32. One block per (query, camera row).
template <typename T>
__global__ void msda_sel_kernel(const T* __restrict__ value,
                                const float* __restrict__ loc,
                                const float* __restrict__ attw, MsdaArgs g,
                                Levels lv, float* __restrict__ sampled,
                                float* __restrict__ wsum) {
  extern __shared__ float smem[];
  __shared__ float mass[MAX_LEVELS];
  __shared__ int lsel[MAX_LEVELS], bxs[MAX_LEVELS], bys[MAX_LEVELS];
  const int q = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int L = lv.n, n = g.n, K = g.K, win = g.ph * g.pw;
  const int np = n / g.heads;
  const long long bq = (long long)b * g.Q + q;
  const float* lq = loc + bq * L * n * 2;
  const float* aq = attw + bq * L * n;
  float* W = smem;                      // [K][heads][win]
  float* fx = W + K * g.heads * win;    // [K][n] fractional x
  float* fy = fx + K * n;               // [K][n]
  float* ak = fy + K * n;               // [K][n] attention * keep
  int* ix = (int*)(ak + K * n);         // [K][n] floor(ax) - base_x
  int* iy = ix + K * n;                 // [K][n]

  // 1. attention mass of each level; the top-K levels
  if (tid < L) {
    float m = 0.f;
    for (int i = 0; i < n; ++i) m = __fadd_rn(m, aq[tid * n + i]);
    mass[tid] = m;
  }
  __syncthreads();
  if (tid == 0) {
    bool taken[MAX_LEVELS] = {};
    for (int j = 0; j < K; ++j) {
      int best = -1;
      for (int l = 0; l < L; ++l)  // strict >: the lower index wins a tie
        if (!taken[l] && (best < 0 || mass[l] > mass[best])) best = l;
      taken[best] = true;
      lsel[j] = best;
    }
  }
  __syncthreads();

  // 2-3. each selected level's window base: the midrange of its kept
  // samples (1e9 sentinels when none is kept), rounded half to even,
  // clamped into [0, size - window]
  if (tid < K) {
    const int l = lsel[tid], h = lv.h[l], w = lv.w[l];
    float mnx = 1e9f, mxx = -1e9f, mny = 1e9f, mxy = -1e9f;
    for (int i = 0; i < n; ++i) {
      const float px = pix(lq[(l * n + i) * 2], w);
      const float py = pix(lq[(l * n + i) * 2 + 1], h);
      if (px > -1.f && px < (float)w && py > -1.f && py < (float)h) {
        mnx = fminf(mnx, px); mxx = fmaxf(mxx, px);
        mny = fminf(mny, py); mxy = fmaxf(mxy, py);
      }
    }
    const float midx = __fmul_rn(0.5f, __fadd_rn(mnx, mxx));
    const float midy = __fmul_rn(0.5f, __fadd_rn(mny, mxy));
    const int bx = (int)rintf(__fsub_rn(midx, (g.pw - 1) / 2.0f));
    const int by = (int)rintf(__fsub_rn(midy, (g.ph - 1) / 2.0f));
    bxs[tid] = min(max(bx, 0), w - g.pw);
    bys[tid] = min(max(by, 0), h - g.ph);
  }
  __syncthreads();

  // 4. taper-clamp every sample into [base - 1 + 1e-4, base + p - 1e-4]
  for (int e = tid; e < K * n; e += blockDim.x) {
    const int j = e / n, i = e % n, l = lsel[j], h = lv.h[l], w = lv.w[l];
    const float px = pix(lq[(l * n + i) * 2], w);
    const float py = pix(lq[(l * n + i) * 2 + 1], h);
    const bool keep = px > -1.f && px < (float)w && py > -1.f && py < (float)h;
    const int bx = bxs[j], by = bys[j];
    const float ax = fmaxf(fminf(px, __fsub_rn((float)(bx + g.pw), 1e-4f)),
                           __fadd_rn((float)(bx - 1), 1e-4f));
    const float ay = fmaxf(fminf(py, __fsub_rn((float)(by + g.ph), 1e-4f)),
                           __fadd_rn((float)(by - 1), 1e-4f));
    const float x0 = floorf(ax), y0 = floorf(ay);
    fx[e] = __fsub_rn(ax, x0);
    fy[e] = __fsub_rn(ay, y0);
    ix[e] = (int)x0 - bx;
    iy[e] = (int)y0 - by;
    ak[e] = __fmul_rn(aq[l * n + i], keep ? 1.f : 0.f);
  }
  __syncthreads();

  // 5. per-head window weights: separable bilinear one-hots (a corner
  // outside the window adds nothing) times the attention, summed over
  // the head's points
  for (int t = tid; t < K * g.heads * win; t += blockDim.x) {
    const int px = t % win, jh = t / win, hh = jh % g.heads, j = jh / g.heads;
    const int ey = px / g.pw, ex = px % g.pw;
    float acc = 0.f;
    for (int p = 0; p < np; ++p) {
      const int s = j * n + hh * np + p;
      const float wy = ey == iy[s] ? __fsub_rn(1.f, fy[s])
                                   : (ey == iy[s] + 1 ? fy[s] : 0.f);
      const float wx = ex == ix[s] ? __fsub_rn(1.f, fx[s])
                                   : (ex == ix[s] + 1 ? fx[s] : 0.f);
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wy, wx), ak[s]));
    }
    W[t] = acc;
  }
  __syncthreads();

  // 7. wsum: each head's total window weight
  if (tid < g.heads) {
    float s = 0.f;
    for (int j = 0; j < K; ++j)
      for (int e = 0; e < win; ++e) s += W[(j * g.heads + tid) * win + e];
    wsum[bq * g.heads + tid] = s;
  }

  // 6. contract the window pixels of each channel with the weights
  for (int c = tid; c < g.C; c += blockDim.x) {
    float acc[MAX_HEADS];
#pragma unroll
    for (int hh = 0; hh < MAX_HEADS; ++hh) acc[hh] = 0.f;
    for (int j = 0; j < K; ++j) {
      const int l = lsel[j], w = lv.w[l];
      const T* vb = value + ((long long)b * g.T + lv.start[l] +
                             (long long)bys[j] * w + bxs[j]) * g.C + c;
      const float* Wj = W + j * g.heads * win;
      for (int e = 0; e < win; ++e) {
        const float v = ld(vb + ((long long)(e / g.pw) * w + e % g.pw) * g.C);
#pragma unroll
        for (int hh = 0; hh < MAX_HEADS; ++hh)
          if (hh < g.heads) acc[hh] = fmaf(Wj[hh * win + e], v, acc[hh]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < MAX_HEADS; ++hh)
      if (hh < g.heads) sampled[(bq * g.heads + hh) * g.C + c] = acc[hh];
  }
}

template <typename T>
int launch_msda_sel(const void* value, const float* loc, const float* attw,
                    float* sampled, float* wsum, const MsdaArgs& g,
                    const Levels& lv, cudaStream_t st) {
  const int smem = (g.K * g.heads * g.ph * g.pw + 5 * g.K * g.n) *
                   (int)sizeof(float);
  cudaFuncSetAttribute(msda_sel_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int nt = g.C < 256 ? ((g.C + 31) / 32) * 32 : 256;
  msda_sel_kernel<T><<<dim3(g.Q, g.B), nt, smem, st>>>(
      (const T*)value, loc, attw, g, lv, sampled, wsum);
  return (int)cudaGetLastError();
}

Levels read_levels(int L, const int* d) {
  Levels lv;
  lv.n = L;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = d[l];
    lv.w[l] = d[L + l];
    lv.start[l] = d[2 * L + l];
  }
  return lv;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (col / value; DFA's points and weights
// share it). The wrappers in ops/sampling.py check every shape and limit.
extern "C" {

// dims: bs, cams, A, P, L, G, C, T, M (-1: no capacity), then the L
// level heights, widths and start rows. strides: points (5), weights (6).
// counted: uint8 [bs * cams, A * P] scratch, used when 0 <= M < A * P.
int simpb_dfa(const void* col, const void* pts, const void* wts,
              void* counted, void* out, const int* dims,
              const long long* strides, int dtype, void* stream) {
  DfaArgs g;
  g.bs = dims[0]; g.cams = dims[1]; g.A = dims[2]; g.P = dims[3];
  g.G = dims[5]; g.C = dims[6]; g.T = dims[7]; g.M = dims[8];
  for (int i = 0; i < 5; ++i) g.sp[i] = strides[i];
  for (int i = 0; i < 6; ++i) g.sw[i] = strides[5 + i];
  const Levels lv = read_levels(dims[4], dims + 9);
  cudaStream_t st = (cudaStream_t)stream;
  return dtype ? launch_dfa<bf16>(col, pts, wts, (uint8_t*)counted,
                                  (float*)out, g, lv, st)
               : launch_dfa<float>(col, pts, wts, (uint8_t*)counted,
                                   (float*)out, g, lv, st);
}

// dims: B, Q, L, n, heads, C, T, K, ph, pw, then the L level heights,
// widths and start rows.
int simpb_msda_sel(const void* value, const void* loc, const void* attw,
                   void* sampled, void* wsum, const int* dims, int dtype,
                   void* stream) {
  MsdaArgs g;
  g.B = dims[0]; g.Q = dims[1]; g.n = dims[3]; g.heads = dims[4];
  g.C = dims[5]; g.T = dims[6]; g.K = dims[7]; g.ph = dims[8];
  g.pw = dims[9];
  const Levels lv = read_levels(dims[2], dims + 10);
  cudaStream_t st = (cudaStream_t)stream;
  return dtype ? launch_msda_sel<bf16>(value, (const float*)loc,
                                       (const float*)attw, (float*)sampled,
                                       (float*)wsum, g, lv, st)
               : launch_msda_sel<float>(value, (const float*)loc,
                                        (const float*)attw, (float*)sampled,
                                        (float*)wsum, g, lv, st);
}

}  // extern "C"
