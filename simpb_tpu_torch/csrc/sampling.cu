// Deformable sampling kernels for Hopper (sm_90a): the forward passes of
// the detection head's two sampling ops, fp32 or bf16 features with fp32
// sums. On the TPU both ops were XLA gathers, not Pallas kernels (Pallas
// had no vector gather there); they replace
//   dfa_rank_kernel + dfa_kernel <- simpb_tpu/ops/sampling.py::
//       deformable_aggregation (capacity compaction :417-436, plain
//       sample_core :569-608; no sel_levels, no level_capacity)
//   msda_sel_tc_kernel (bf16), msda_sel_kernel (fp32)
//                                <- simpb_tpu/ops/sampling.py::
//       _msda_patch_sel (:892-1007, window placement _window_base :168)
//   msda_kernel                  <- simpb_tpu/ops/sampling.py::msda
//       (:611-715, raw_heads; the exact configurations' 2D sampling)
// and, for the hybrid configuration's msda_hybrid (:1032-1209),
//   msda_levels_tc_kernel (H1; fp32 values: msda_sel_kernel with every
//       level)                   <- msda_patch's all-level loop (:718,
//       called at :1125 with sel_levels=None)
//   msda_hybrid_kernel (H2)      <- msda_hybrid's exact lane and its
//       scatter back (:1132-1209)
//   clamp_select_kernel, clamp_demand_kernel (H3)
//                                <- _lost_weights (:208) as msda_hybrid's
//       priority and selection (:1100-1120) and msda_clamp_demand (:1008)
// and compute what their plain PyTorch versions in ops/sampling.py compute.
//
// Exact MSDA: one half-warp per (camera row, query, head), two queries'
// heads a block, a lane two packs of 8 channels of the full-width value
// row, a sample's corner rows of its two packs in flight at once, bf16
// pairs one native instruction an operation. Its time is its corner-row
// loads (four rows a sample, 16 samples a head, through L1 and L2) plus
// its arithmetic (ten operations per value read): timed apart on the
// card, the two add up to it, and more rows in flight do not shorten it
// (PERF.md).
// Every bilinear sample rounds as the plain version's (the corner
// weights, the x pairs and the y combine in the value's type; the
// position in fp32, as the locations are); the attention weighting and
// the sums are fp32, in another order than the plain einsum's. The output
// is written once, with no atomics.
//
// DFA: bound by bytes (four feature rows per live sample, ten operations
// per value read). `dfa_rank_kernel` (one block per camera row) finds
// the capacity's threshold: the slot, in slot order a * P + p, of each
// camera's M-th in-range slot (a slot counts iff it is in range and
// comes before it, the set the plain version's stable top-k keeps). Its
// threads load the slots' flags with neighbouring threads on neighbouring
// slots, all loads issued before use, then rank contiguous runs of them
// with one block scan. `dfa_kernel` runs one block per (batch, anchor).
// Its threads first place the anchor's (camera, point, level) entries, a
// contiguous run of two a thread with every load issued before use, and
// compact the live ones, in entry order, into shared memory (one block
// scan). Then a team of C / 8 threads takes one entry at a time, a thread
// 8 channels as one 16-byte load (two for fp32), so that a warp
// instruction reads a whole 512-byte feature row; the teams take
// interleaved entries of the list, two at a time with all eight corner
// loads issued before the first is used. The teams' partial sums add in
// shared memory in team order: results are deterministic (no atomics; the
// plain version's index_add_ is atomic on the card).
//
// Rounding points. The plain version runs in the storage type: for bf16,
// the pixel position, the corner weights, each corner product, each pair
// sum, the sample and the weighted sample round to bf16 one by one. A
// kernel that kept positions in fp32 would compute another function
// (near x = 88 at a 176-wide level bf16 steps by 0.5 px), so every
// rounding is written out with __float2bfloat16_rn, and products and sums
// use __fmul_rn / __fadd_rn so that nvcc fuses nothing into an FMA. A
// product of two bf16 values is exact in fp32, so bf16 products run two
// channels an instruction (__hmul2, one rounding); sums still round
// through fp32, as torch's bf16 add does. In fp32 the same explicit
// operations make every sample bit-identical to the plain version's; only
// the order of the fp32 sums differs.
//
// MSDA-sel: per (camera row, query) the attention mass of each level,
// the top-k levels (lower index first among ties, as topk_stable), each
// window's midrange base (rintf: round half to even, as torch.round), the
// taper-clamped samples and the per-head window weights W [heads, k x
// ph x pw] (fp32), then out[h, c] = sum_px W[h, px] * V[px, c] over the
// k windows. bf16 values: `msda_sel_tc_kernel`, bound by its per-query
// latency chain (the prologue) and the windows' bytes once the
// contraction is on the tensor cores (mma.sync.m16n8k16, fp32 sums).
// Each fp32 weight is split into three bf16 parts, W = hi + mid + lo
// (exact for any normal W: 3 x 8 significand bits), and each part times a
// bf16 value is exact in fp32, so the kernel computes the plain version's
// fp32 products exactly; only the order of the fp32 sums differs (a
// two-part split would leave 2^-16 of sum |W| |v|). The 3 x heads rows of
// parts are A, the window pixels B, staged in shared memory by cp.async,
// 16 bytes a copy, with each pixel row's 16-byte chunks swizzled so that
// the 8 rows of an ldmatrix fall on 8 bank groups. The level masses sum
// in the plain order (a different order can flip a near-tied top-2);
// min and max of the window bases are exact in any order and reduce with
// shuffles. A block takes one query, three blocks an SM, so that the
// blocks hide each other's prologue latencies. fp32 values keep the CUDA-core
// `msda_sel_kernel`, one block per (query, camera row), each thread
// contracting its channel.
//
// C interface (ctypes): pointers and the stream are void*; shapes and the
// launch plan (threads, shared memory) come in a host
// int array from the planners in ops/sampling.py, strides in a host int64
// array; each function returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for a plan whose shared memory is short of what
// the kernel lays out.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;
constexpr int MAX_LEVELS = 8;
constexpr int MAX_HEADS = 16;
constexpr int MAX_GROUPS = 8;  // DFA weight groups
constexpr int DFA_RUN = 2;     // most entries a DFA thread places at once
constexpr int RANK_NT = 1024;  // threads of a rank block (32 warps)
constexpr int RANK_RUN = 16;   // most slots a rank thread loads at once
constexpr int MSDA_NT = 256;   // threads of an MSDA-sel tensor-core block

struct Levels {
  int n;
  int h[MAX_LEVELS], w[MAX_LEVELS], start[MAX_LEVELS];
};

// Loads, stores (rounded to T) and the storage type's rounding: R(v)
// rounds an fp32 result to T.
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float R(float v);
template <> __device__ __forceinline__ float R<float>(float v) { return v; }
template <> __device__ __forceinline__ float R<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ bool in_range(float x, float y) {
  return x > 0.f && x < 1.f && y > 0.f && y < 1.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// ---------------------------------------------------------------- DFA
// pts [bs, A, P, cams, 2] and wts [bs, A, P, cams, L, G] by element
// strides; col [bs, cams, T, C] contiguous.
struct DfaArgs {
  int bs, cams, A, P, G, C, T, M;
  long long sp[5], sw[6];
};

// Inclusive block scan of one int a thread (blockDim.x a multiple of 32,
// at most 1024); `tot` gets the block's total.
template <typename I>
__device__ __forceinline__ I block_scan(I v, I* warp_sum, I& tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const I u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    I t = lane < nw ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const I u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += u;
    }
    warp_sum[lane] = t;
  }
  __syncthreads();
  tot = warp_sum[nw - 1];
  return v + (warp ? warp_sum[warp - 1] : 0);
}

// thr[bc] = 1 + the slot index of camera row bc's M-th in-range slot in
// slot order a * P + p (S when it has fewer than M): a slot counts iff it
// is in range and its index is below thr, the set the plain version's
// stable top-k keeps. A thread takes a contiguous run of up to RANK_RUN
// slots (one pass when S <= 16384).
template <typename T>
__global__ void __launch_bounds__(RANK_NT)
dfa_rank_kernel(const T* __restrict__ pts, DfaArgs g, int* __restrict__ thr) {
  __shared__ int warp_sum[32];
  __shared__ uint8_t flag[RANK_NT * RANK_RUN];
  const int bc = blockIdx.x, batch = bc / g.cams, cam = bc % g.cams;
  const int S = g.A * g.P, tid = threadIdx.x;
  const T* pb = pts + batch * g.sp[0] + cam * g.sp[3];
  int base = 0;
  for (int s0 = 0; s0 < S; s0 += RANK_NT * RANK_RUN) {
    const int len = min(S - s0, RANK_NT * RANK_RUN);
    const int run = (len + RANK_NT - 1) / RANK_NT;
    // the slots' in-range flags, loaded with neighbouring threads on
    // neighbouring slots, every load before any use
    float x[RANK_RUN], y[RANK_RUN];
    int an = (s0 + tid) / g.P, pt = (s0 + tid) % g.P;  // slot s0 + tid
    const int da = RANK_NT / g.P, dp = RANK_NT % g.P;   // a step of NT
#pragma unroll
    for (int k = 0; k < RANK_RUN; ++k) {
      const int i = k * RANK_NT + tid;
      x[k] = y[k] = -1.f;
      if (i < len) {
        const T* q = pb + an * g.sp[1] + pt * g.sp[2];
        x[k] = ld(q);
        y[k] = ld(q + g.sp[4]);
      }
      an += da;
      pt += dp;
      if (pt >= g.P) {
        pt -= g.P;
        ++an;
      }
    }
#pragma unroll
    for (int k = 0; k < RANK_RUN; ++k) {
      const int i = k * RANK_NT + tid;
      if (i < len) flag[i] = in_range(x[k], y[k]);
    }
    __syncthreads();
    // a thread ranks a contiguous run of them: one block scan
    const int first = tid * run;
    unsigned flags = 0;
#pragma unroll
    for (int i = 0; i < RANK_RUN; ++i)
      if (i < run && first + i < len) flags |= (unsigned)flag[first + i] << i;
    int tot;
    int rank = base + block_scan(__popc(flags), warp_sum, tot) -
               __popc(flags);
#pragma unroll
    for (int i = 0; i < RANK_RUN; ++i)
      if ((flags >> i) & 1u) {
        if (rank == g.M - 1) thr[bc] = s0 + first + i + 1;
        ++rank;
      }
    base += tot;
    __syncthreads();  // flag and warp_sum are rewritten by the next pass
  }
  if (tid == 0 && (g.M == 0 || base < g.M)) thr[bc] = g.M == 0 ? 0 : S;
}

// A thread's 8 channels of one feature row: one 16-byte load for bf16,
// two for fp32.
template <typename T>
struct Row8 {
  uint4 u[sizeof(T) / 2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < (int)(sizeof(T) / 2); ++k) u[k] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int k = 0; k < (int)(sizeof(T) / 2); ++k)
      u[k] = *reinterpret_cast<const uint4*>(p + k * (16 / sizeof(T)));
  }
  // channel i (a constant after unrolling): bf16 widens by a shift
  __device__ __forceinline__ float operator[](int i) const {
    const uint4& q = u[sizeof(T) == 2 ? 0 : i / 4];
    const int k = sizeof(T) == 2 ? i / 2 : i % 4;
    const uint32_t w = k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
    if constexpr (sizeof(T) == 2)
      return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
    else
      return __uint_as_float(w);
  }
};

// One live entry's 8 channels: the two-corner rows, the sample, its group
// weight, each rounding as the plain version's; adds to acc in fp32.
template <typename T>
__device__ __forceinline__ void dfa_accumulate(
    float (&acc)[8], const float4 w, float gw, const Row8<T>& v00,
    const Row8<T>& v01, const Row8<T>& v10, const Row8<T>& v11) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float vx0 = R<T>(__fadd_rn(R<T>(__fmul_rn(w.x, v00[i])),
                                     R<T>(__fmul_rn(w.y, v01[i]))));
    const float vx1 = R<T>(__fadd_rn(R<T>(__fmul_rn(w.x, v10[i])),
                                     R<T>(__fmul_rn(w.y, v11[i]))));
    const float smp = R<T>(__fadd_rn(R<T>(__fmul_rn(w.z, vx0)),
                                     R<T>(__fmul_rn(w.w, vx1))));
    acc[i] = __fadd_rn(acc[i], R<T>(__fmul_rn(smp, gw)));
  }
}

// bf16, two channels an instruction: a product of two bf16 values is
// exact in fp32, so __hmul2's one rounding is R(__fmul_rn(a, b)); a sum
// rounds through fp32 as torch's bf16 add does (a native bf16 add would
// round once, not twice).
__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ __nv_bfloat162 add2_rn(__nv_bfloat162 a,
                                                  __nv_bfloat162 b) {
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return __floats2bfloat162_rn(__fadd_rn(fa.x, fb.x), __fadd_rn(fa.y, fb.y));
}
template <>
__device__ __forceinline__ void dfa_accumulate<bf16>(
    float (&acc)[8], const float4 w, float gw, const Row8<bf16>& v00,
    const Row8<bf16>& v01, const Row8<bf16>& v10, const Row8<bf16>& v11) {
  const __nv_bfloat162 wx0 = __float2bfloat162_rn(w.x),
                       wx1 = __float2bfloat162_rn(w.y),
                       wy0 = __float2bfloat162_rn(w.z),
                       wy1 = __float2bfloat162_rn(w.w),
                       g2 = __float2bfloat162_rn(gw);
  const uint32_t a00[4] = {v00.u[0].x, v00.u[0].y, v00.u[0].z, v00.u[0].w};
  const uint32_t a01[4] = {v01.u[0].x, v01.u[0].y, v01.u[0].z, v01.u[0].w};
  const uint32_t a10[4] = {v10.u[0].x, v10.u[0].y, v10.u[0].z, v10.u[0].w};
  const uint32_t a11[4] = {v11.u[0].x, v11.u[0].y, v11.u[0].z, v11.u[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 vx0 =
        add2_rn(__hmul2(wx0, bf2(a00[i])), __hmul2(wx1, bf2(a01[i])));
    const __nv_bfloat162 vx1 =
        add2_rn(__hmul2(wx0, bf2(a10[i])), __hmul2(wx1, bf2(a11[i])));
    const __nv_bfloat162 smp = add2_rn(__hmul2(wy0, vx0), __hmul2(wy1, vx1));
    const float2 t = __bfloat1622float2(__hmul2(smp, g2));
    acc[2 * i] = __fadd_rn(acc[2 * i], t.x);
    acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], t.y);
  }
}

// Loads the four corner rows of live entry i (a corner of zero weight
// adds a zero product: its row is not read).
template <typename T>
__device__ __forceinline__ void dfa_corners(const T* cb, const float4 w,
                                            const int4 r, int C,
                                            Row8<T> (&v)[4]) {
  const int rr[4] = {r.x, r.y, r.z, r.w};
  const bool need[4] = {w.z != 0.f && w.x != 0.f, w.z != 0.f && w.y != 0.f,
                        w.w != 0.f && w.x != 0.f, w.w != 0.f && w.y != 0.f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k].zero();
    if (need[k]) v[k].load(cb + (long long)rr[k] * C);
  }
}

// One block per (anchor, batch); out [bs, A, C] fp32. Shared memory: the
// teams' partial sums [teams][C], then per live entry (compacted in entry
// order e = (cam * P + p) * L + l) its corner weights wx0 wx1 wy0 wy1, its
// four corner rows (row of the batch's [cams * T, C] column) and its G
// group weights.
template <typename T>
__global__ void __launch_bounds__(256)
dfa_kernel(const T* __restrict__ col, const T* __restrict__ pts,
           const T* __restrict__ wts, const int* __restrict__ thr,
           DfaArgs g, Levels lv, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_sum[32];
  const int a = blockIdx.x, batch = blockIdx.y, tid = threadIdx.x;
  const int L = lv.n, E = g.cams * g.P * L, G = g.G;
  const int CH = g.C / 8, teams = blockDim.x / CH;
  float* red = reinterpret_cast<float*>(smem_raw);  // [teams][C]
  float4* cw = reinterpret_cast<float4*>(red + teams * g.C);  // [E]
  int4* rows = reinterpret_cast<int4*>(cw + E);               // [E]
  float* gw = reinterpret_cast<float*>(rows + E);             // [E][G]

  // 1. place every entry: a thread takes a contiguous run of up to
  // DFA_RUN entries with all their loads issued before use; one block
  // scan compacts the live ones in entry order
  int nlive = 0;
  for (int r0 = 0; r0 < E; r0 += blockDim.x * DFA_RUN) {
    const int run = min(DFA_RUN, (E - r0 + blockDim.x - 1) / blockDim.x);
    const int e0 = r0 + tid * run;
    float lx[DFA_RUN], ly[DFA_RUN], gv[DFA_RUN][MAX_GROUPS];
    int lim[DFA_RUN], lvl[DFA_RUN], cams[DFA_RUN];
    int l = e0 % L, p = e0 / L % g.P, cam = e0 / L / g.P;  // entry e0
#pragma unroll
    for (int u = 0; u < DFA_RUN; ++u) {
      const int e = e0 + u;
      lx[u] = -1.f;
      ly[u] = -1.f;
      lim[u] = 0;
      if (u) {  // the next entry: level, then point, then camera (no
                // division)
        if (++l == L) {
          l = 0;
          if (++p == g.P) {
            p = 0;
            ++cam;
          }
        }
      }
      lvl[u] = l;
      cams[u] = cam;
      if (u < run && e < E) {
        const T* q = pts + batch * g.sp[0] + a * g.sp[1] + p * g.sp[2] +
                     cam * g.sp[3];
        const T* wq = wts + batch * g.sw[0] + a * g.sw[1] + p * g.sw[2] +
                      cam * g.sw[3] + l * g.sw[4];
        lx[u] = ld(q);
        ly[u] = ld(q + g.sp[4]);
        lim[u] = thr ? thr[batch * g.cams + cam] - a * g.P - p : 1;
#pragma unroll
        for (int k = 0; k < MAX_GROUPS; ++k)
          if (k < G) gv[u][k] = ld(wq + k * g.sw[5]);
      }
    }
    unsigned live = 0;
#pragma unroll
    for (int u = 0; u < DFA_RUN; ++u)
      live |= (unsigned)(in_range(lx[u], ly[u]) && lim[u] > 0) << u;
    int tot;
    int pos = nlive + block_scan(__popc(live), warp_sum, tot) - __popc(live);
#pragma unroll
    for (int u = 0; u < DFA_RUN; ++u) {
      if (!((live >> u) & 1u)) continue;
      const int h = lv.h[lvl[u]], w = lv.w[lvl[u]];
      // x = loc * w - 0.5, each step rounded to T (_corner_weights)
      const float x =
          R<T>(__fsub_rn(R<T>(__fmul_rn(lx[u], (float)w)), 0.5f));
      const float y =
          R<T>(__fsub_rn(R<T>(__fmul_rn(ly[u], (float)h)), 0.5f));
      const float x0f = floorf(x), y0f = floorf(y);
      const float fx = R<T>(__fsub_rn(x, x0f)), fy = R<T>(__fsub_rn(y, y0f));
      const int x0 = (int)x0f, y0 = (int)y0f;
      cw[pos] = make_float4(
          (x0 >= 0 && x0 < w) ? R<T>(__fsub_rn(1.f, fx)) : 0.f,
          (x0 + 1 >= 0 && x0 + 1 < w) ? fx : 0.f,
          (y0 >= 0 && y0 < h) ? R<T>(__fsub_rn(1.f, fy)) : 0.f,
          (y0 + 1 >= 0 && y0 + 1 < h) ? fy : 0.f);
      const int xc0 = min(max(x0, 0), w - 1), xc1 = min(max(x0 + 1, 0), w - 1);
      const int base = cams[u] * g.T + lv.start[lvl[u]];
      const int ra = base + min(max(y0, 0), h - 1) * w;
      const int rb = base + min(max(y0 + 1, 0), h - 1) * w;
      rows[pos] = make_int4(ra + xc0, ra + xc1, rb + xc0, rb + xc1);
#pragma unroll
      for (int k = 0; k < MAX_GROUPS; ++k)
        if (k < G) gw[pos * G + k] = gv[u][k];
      ++pos;
    }
    nlive += tot;
    __syncthreads();  // warp_sum is rewritten by the next round
  }

  // 2. each team sums interleaved entries, two at a time
  const int team = tid / CH, ci = tid % CH;
  const int grp = (8 * ci) / (g.C / G);
  const T* cb = col + (long long)batch * g.cams * g.T * g.C + ci * 8;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  if (team < teams) {
    for (int i = team; i < nlive; i += 2 * teams) {
      const int j = i + teams;
      const bool two = j < nlive;
      const float4 wa = cw[i];
      const float4 wb = two ? cw[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      Row8<T> va[4], vb[4];
      dfa_corners(cb, wa, rows[i], g.C, va);
      dfa_corners(cb, wb, two ? rows[j] : rows[i], g.C, vb);
      dfa_accumulate(acc, wa, gw[i * G + grp], va[0], va[1], va[2], va[3]);
      if (two)
        dfa_accumulate(acc, wb, gw[j * G + grp], vb[0], vb[1], vb[2], vb[3]);
    }
    float4* rt = reinterpret_cast<float4*>(red + team * g.C + ci * 8);
    rt[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    rt[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();

  // 3. the teams' partial sums, in team order
  for (int c = tid; c < g.C; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < teams; ++t) s = __fadd_rn(s, red[t * g.C + c]);
    out[((long long)batch * g.A + a) * g.C + c] = s;
  }
}

int dfa_smem_bytes(const DfaArgs& g, int L, int threads) {
  const int E = g.cams * g.P * L, teams = threads / (g.C / 8);
  return 4 * (teams * g.C + 8 * E + E * g.G);
}

template <typename T>
int launch_dfa(const void* col, const void* pts, const void* wts, int* thr,
               float* out, const DfaArgs& g, const Levels& lv, int threads,
               int smem, cudaStream_t st) {
  if (g.C % 8 || (g.C / g.G) % 8 || g.G > MAX_GROUPS || threads % 32 ||
      threads > 256 || threads < g.C / 8 ||
      dfa_smem_bytes(g, lv.n, threads) > smem)
    return (int)cudaErrorInvalidValue;
  const bool rank = g.M >= 0 && g.M < g.A * g.P;
  if (rank) {
    dfa_rank_kernel<T><<<g.bs * g.cams, RANK_NT, 0, st>>>((const T*)pts, g,
                                                           thr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  static int smem_set = 0;  // the attribute only grows (one card)
  if (smem > smem_set) {
    cudaFuncSetAttribute(dfa_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set = smem;
  }
  dfa_kernel<T><<<dim3(g.A, g.bs), threads, smem, st>>>(
      (const T*)col, (const T*)pts, (const T*)wts, rank ? thr : nullptr, g,
      lv, out);
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

// fp32 values: value [B, T, C]; loc [B, Q, L, n, 2] and attw [B, Q, L, n]
// fp32 with the n = heads * points samples head-major; sampled [B, Q,
// heads, C] and wsum [B, Q, heads] fp32. One block per (query, camera
// row), a thread per channel.
__global__ void msda_sel_kernel(const float* __restrict__ value,
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

  // 1. attention mass of each level; the top-K levels (every level, in
  // level order, when K == L: msda_patch's all-level loop)
  if (tid < L) {
    float m = 0.f;
    for (int i = 0; i < n; ++i) m = __fadd_rn(m, aq[tid * n + i]);
    mass[tid] = m;
  }
  __syncthreads();
  if (tid == 0) {
    bool taken[MAX_LEVELS] = {};
    for (int j = 0; j < K; ++j) {
      if (K == L) {
        lsel[j] = j;
        continue;
      }
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
      const float* vb = value + ((long long)b * g.T + lv.start[l] +
                                 (long long)bys[j] * w + bxs[j]) * g.C + c;
      const float* Wj = W + j * g.heads * win;
      for (int e = 0; e < win; ++e) {
        const float v = vb[((long long)(e / g.pw) * w + e % g.pw) * g.C];
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

// The bf16 tensor-core kernel's fixed head shape: 8x8 windows, 4 points
// a head, at most 8 heads (every configuration of the repo), its levels
// staged SEL_K at a time: the top 2 (the flagship's MSDA-sel) or every
// level in groups of 2 (H1, the hybrid's windowed lane); channels, levels
// and queries are the launch's.
constexpr int SEL_K = 2, WIN_H = 8, WIN_W = 8, PTS = 4, TC_HEADS = 8;
constexpr int WIN = WIN_H * WIN_W, KW = SEL_K * WIN;  // a group's K
constexpr int AL = KW + 8;  // bf16 a row of the weight parts A

// Shared memory of one MSDA-sel tensor-core block (offsets in bytes): the
// windows' pixel rows V [KW][C] bf16, whose 16-byte chunks are swizzled by
// the row (chunk c of row r at c ^ (r % 8), so the 8 rows of an ldmatrix
// fall on 8 bank groups); the weight parts A [25][AL] bf16: 8 rows a part,
// then a zero row; the query's loc [L][n][2], attw [L][n] and its levels
// and window bases [K].
struct MsdaSmem {
  static constexpr int a_rows = 3 * TC_HEADS + 1;
  int a, loc, attw, lsel, bx, by, total;
  __host__ __device__ MsdaSmem(const MsdaArgs& g, int L) {
    a = KW * g.C * 2;
    loc = a + a_rows * AL * 2;
    attw = loc + L * g.n * 2 * 4;
    lsel = attw + L * g.n * 4;
    bx = lsel + g.K * 4;
    by = bx + g.K * 4;
    total = by + g.K * 4;
  }
};

// bf16 values: the same function with the contraction on the tensor
// cores. Block bq takes query bq of the B * Q: the prologue (level masses,
// the top K levels, or every level in order when K == L; the window bases)
// and then, for each group of SEL_K levels in turn, the window copies, the
// weights W, split into their three bf16 parts, wsum's part and the
// product out[h, c] += sum_k W[h, k] V[k, c] over the group's KW window
// pixels, summed in the mma registers across the groups (so that the
// shared memory a block holds, and three blocks an SM, do not grow with
// K). A is two m16 tiles: part p of head h sits in row 8 p + h, row
// (p % 2) * 8 + h of tile p / 2, and the second tile's last 8 rows read
// the zero row; so the thread holding row h of a tile's accumulator holds
// all three parts of its head. GPW: 16-channel groups a warp takes (C <=
// GPW * 128). ONE: K == SEL_K, one group known at compile time (the
// flagship's MSDA-sel, with no loop around its group).
template <int GPW, bool ONE>
__global__ void __launch_bounds__(MSDA_NT, 3)
msda_sel_tc_kernel(const bf16* __restrict__ value,
                   const float* __restrict__ loc,
                   const float* __restrict__ attw, MsdaArgs g, Levels lv,
                   float* __restrict__ sampled, float* __restrict__ wsum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = lv.n, H = g.heads, n = H * PTS, C = g.C, cch = C / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bq = blockIdx.x, b = bq / g.Q;
  const MsdaSmem sm(g, L);
  bf16* sv = reinterpret_cast<bf16*>(smem_raw);
  bf16* A = reinterpret_cast<bf16*>(smem_raw + sm.a);
  float* sl = reinterpret_cast<float*>(smem_raw + sm.loc);
  float* sa = reinterpret_cast<float*>(smem_raw + sm.attw);
  int* lsel = reinterpret_cast<int*>(smem_raw + sm.lsel);
  int* bxs = reinterpret_cast<int*>(smem_raw + sm.bx);
  int* bys = reinterpret_cast<int*>(smem_raw + sm.by);
  // rows of A that no head fills stay zero (heads past H, the zero row)
  for (int i = tid; i < MsdaSmem::a_rows * AL / 8; i += MSDA_NT)
    reinterpret_cast<uint4*>(A)[i] = make_uint4(0, 0, 0, 0);

  const float* lq = loc + (long long)bq * L * n * 2;
  const float* aq = attw + (long long)bq * L * n;
  for (int i = tid; i < L * n * 2; i += MSDA_NT) sl[i] = lq[i];
  for (int i = tid; i < L * n; i += MSDA_NT) sa[i] = aq[i];
  __syncthreads();
  if (warp < g.K) {  // warp j: the j-th level, its window base
    int l = warp;    // every level: level j
    if (g.K < L) {   // the j-th by mass
      float m = 0.f;  // lane l < L: level l's mass, summed in plain order
      if (lane < L) {
#pragma unroll 8
        for (int i = 0; i < n; ++i) m = __fadd_rn(m, sa[lane * n + i]);
      }
      unsigned taken = 0;
      for (int jj = 0; jj <= warp; ++jj) {
        int best = -1;
        float bm = 0.f;
        for (int ll = 0; ll < L; ++ll) {  // strict >: the lower index wins
          const float ml = __shfl_sync(0xffffffffu, m, ll);
          if (!((taken >> ll) & 1u) && (best < 0 || ml > bm)) {
            best = ll;
            bm = ml;
          }
        }
        taken |= 1u << best;
        l = best;
      }
    }
    const int h = lv.h[l], w = lv.w[l];
    float mnx = 1e9f, mxx = -1e9f, mny = 1e9f, mxy = -1e9f;
    for (int i = lane; i < n; i += 32) {
      const float px = pix(sl[(l * n + i) * 2], w);
      const float py = pix(sl[(l * n + i) * 2 + 1], h);
      if (px > -1.f && px < (float)w && py > -1.f && py < (float)h) {
        mnx = fminf(mnx, px); mxx = fmaxf(mxx, px);
        mny = fminf(mny, py); mxy = fmaxf(mxy, py);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {  // min and max: exact in any order
      mnx = fminf(mnx, __shfl_xor_sync(0xffffffffu, mnx, o));
      mxx = fmaxf(mxx, __shfl_xor_sync(0xffffffffu, mxx, o));
      mny = fminf(mny, __shfl_xor_sync(0xffffffffu, mny, o));
      mxy = fmaxf(mxy, __shfl_xor_sync(0xffffffffu, mxy, o));
    }
    if (lane == 0) {
      const float midx = __fmul_rn(0.5f, __fadd_rn(mnx, mxx));
      const float midy = __fmul_rn(0.5f, __fadd_rn(mny, mxy));
      const int bx = (int)rintf(__fsub_rn(midx, (WIN_W - 1) / 2.0f));
      const int by = (int)rintf(__fsub_rn(midy, (WIN_H - 1) / 2.0f));
      lsel[warp] = l;
      bxs[warp] = min(max(bx, 0), w - WIN_W);
      bys[warp] = min(max(by, 0), h - WIN_H);
    }
  }
  __syncthreads();

  const bf16* vb = value + (long long)b * g.T * C;
  const int eya = lane >> 3, eyb = eya + 4, ex = lane & 7;
  const int gid = lane >> 2, tig = lane & 3;
  // this lane's ldmatrix row of each A tile: part 2 m + (lane & 15) / 8
  int arow[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int p = 2 * m + ((lane & 15) >> 3);
    arow[m] = (p < 3 ? 8 * p + (lane & 7) : MsdaSmem::a_rows - 1) * AL +
              (lane >> 4) * 8;
  }
  float acc[GPW][2][2][4];
#pragma unroll
  for (int gi = 0; gi < GPW; ++gi)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][m][nn][e] = 0.f;
  float wsum_t = 0.f;  // thread h < H: head h's weight, in plain order
  const int K = ONE ? SEL_K : g.K;
  for (int j0 = 0; j0 < K; j0 += SEL_K) {
    if (j0) __syncthreads();  // the previous group's V and A are read
    // the group's windows into shared memory: a window row (8 pixels) is
    // 8 C contiguous values; a thread copies its 16-byte chunk i of each
    for (int i = tid; i < WIN_W * cch; i += MSDA_NT) {
      const int ex_ = i / cch, c = i - ex_ * cch;
#pragma unroll
      for (int j = 0; j < SEL_K; ++j) {
        const int l = lsel[j0 + j], w = lv.w[l];
        const bf16* src = vb + ((long long)lv.start[l] +
                                (long long)bys[j0 + j] * w + bxs[j0 + j]) *
                                   C + i * 8;
#pragma unroll
        for (int ey = 0; ey < WIN_H; ++ey) {
          const int r = (j * WIN_H + ey) * WIN_W + ex_;
          cp_async16(sv + r * C + ((c ^ (r & 7)) << 3),
                     src + (long long)ey * w * C);
        }
      }
    }
    cp_commit();
    // the weights: warp w takes the (level j, head h) rows jh = w, w + 8,
    // ...; lanes p < 4 taper-clamp the row's points into [base - 1 +
    // 1e-4, base + 8 - 1e-4], then every lane weighs pixels lane and
    // lane + 32 of the window (separable bilinear one-hots, a corner
    // outside the window adds nothing, times the attention, summed over
    // the points) and writes their three bf16 parts into A's rows
    // 8 part + h
    for (int jh = warp; jh < SEL_K * H; jh += MSDA_NT / 32) {
      const int j = jh / H, hh = jh - j * H;
      float fxp = 0.f, fyp = 0.f, ap = 0.f;
      int ixp = 0, iyp = 0;
      if (lane < PTS) {
        const int l = lsel[j0 + j], h = lv.h[l], w = lv.w[l],
                  i = hh * PTS + lane;
        const float px = pix(sl[(l * n + i) * 2], w);
        const float py = pix(sl[(l * n + i) * 2 + 1], h);
        const bool keep =
            px > -1.f && px < (float)w && py > -1.f && py < (float)h;
        const int bx = bxs[j0 + j], by = bys[j0 + j];
        const float ax =
            fmaxf(fminf(px, __fsub_rn((float)(bx + WIN_W), 1e-4f)),
                  __fadd_rn((float)(bx - 1), 1e-4f));
        const float ay =
            fmaxf(fminf(py, __fsub_rn((float)(by + WIN_H), 1e-4f)),
                  __fadd_rn((float)(by - 1), 1e-4f));
        const float x0 = floorf(ax), y0 = floorf(ay);
        fxp = __fsub_rn(ax, x0);
        fyp = __fsub_rn(ay, y0);
        ixp = (int)x0 - bx;
        iyp = (int)y0 - by;
        ap = __fmul_rn(sa[l * n + i], keep ? 1.f : 0.f);
      }
      float acca = 0.f, accb = 0.f;
#pragma unroll
      for (int p = 0; p < PTS; ++p) {
        const float fy = __shfl_sync(0xffffffffu, fyp, p);
        const float fx = __shfl_sync(0xffffffffu, fxp, p);
        const float a = __shfl_sync(0xffffffffu, ap, p);
        const int yi = __shfl_sync(0xffffffffu, iyp, p);
        const int xi = __shfl_sync(0xffffffffu, ixp, p);
        const float wx =
            ex == xi ? __fsub_rn(1.f, fx) : (ex == xi + 1 ? fx : 0.f);
        const float wya = eya == yi ? __fsub_rn(1.f, fy)
                                    : (eya == yi + 1 ? fy : 0.f);
        const float wyb = eyb == yi ? __fsub_rn(1.f, fy)
                                    : (eyb == yi + 1 ? fy : 0.f);
        acca = __fadd_rn(acca, __fmul_rn(__fmul_rn(wya, wx), a));
        accb = __fadd_rn(accb, __fmul_rn(__fmul_rn(wyb, wx), a));
      }
      bf16* row = A + hh * AL + j * WIN + lane;
      const float accs[2] = {acca, accb};
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const bf16 hi = __float2bfloat16_rn(accs[t]);
        const float r = __fsub_rn(accs[t], __bfloat162float(hi));
        const bf16 mid = __float2bfloat16_rn(r);
        row[32 * t] = hi;
        row[32 * t + 8 * AL] = mid;
        row[32 * t + 16 * AL] =
            __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
      }
    }
    __syncthreads();
    if (tid < H) {  // wsum: each head's total window weight, plain order
      const bf16* a = A + tid * AL;
#pragma unroll
      for (int k = 0; k < KW; k += 8) {  // 8 a load; hi + mid + lo is W
        const uint4 h4 = *reinterpret_cast<const uint4*>(a + k);
        const uint4 m4 = *reinterpret_cast<const uint4*>(a + k + 8 * AL);
        const uint4 l4 = *reinterpret_cast<const uint4*>(a + k + 16 * AL);
        const uint32_t hw[4] = {h4.x, h4.y, h4.z, h4.w},
                       mw[4] = {m4.x, m4.y, m4.z, m4.w},
                       lw[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 hf = __bfloat1622float2(bf2(hw[i])),
                       mf = __bfloat1622float2(bf2(mw[i])),
                       lf = __bfloat1622float2(bf2(lw[i]));
          wsum_t += __fadd_rn(__fadd_rn(hf.x, mf.x), lf.x);
          wsum_t += __fadd_rn(__fadd_rn(hf.y, mf.y), lf.y);
        }
      }
    }
    cp_wait_all();
    __syncthreads();

    // the group's product on the tensor cores, into the running sums
#pragma unroll
    for (int ks = 0; ks < KW / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) ldsm_x4(af[m], A + arow[m] + ks * 16);
      const int r = ks * 16 + (lane & 15);
#pragma unroll
      for (int gi = 0; gi < GPW; ++gi) {
        const int grp = warp + 8 * gi;
        if (grp * 16 >= C) continue;
        uint32_t bfr[4];
        ldsm_x4_t(bfr,
                  sv + r * C + (((2 * grp + (lane >> 4)) ^ (r & 7)) << 3));
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(acc[gi][m][0], af[m], bfr[0], bfr[1]);
          mma_bf16(acc[gi][m][1], af[m], bfr[2], bfr[3]);
        }
      }
    }
  }
  if (tid < H) wsum[(long long)bq * H + tid] = wsum_t;
  // epilogue: out[h, c] = hi + mid + lo
#pragma unroll
  for (int gi = 0; gi < GPW; ++gi) {
    const int grp = warp + 8 * gi;
    if (grp * 16 >= C || gid >= H) continue;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {  // tile 0: hi, mid; tile 1: lo
      const float* h0 = acc[gi][0][nn];
      const float* h1 = acc[gi][1][nn];
      const int c = grp * 16 + nn * 8 + 2 * tig;
      *reinterpret_cast<float2*>(sampled + ((long long)bq * H + gid) * C + c) =
          make_float2(__fadd_rn(__fadd_rn(h0[0], h0[2]), h1[0]),
                      __fadd_rn(__fadd_rn(h0[1], h0[3]), h1[1]));
    }
  }
}

int launch_msda_sel_fp32(const float* value, const float* loc,
                         const float* attw, float* sampled, float* wsum,
                         const MsdaArgs& g, const Levels& lv, int threads,
                         int smem, cudaStream_t st) {
  const int need = (g.K * g.heads * g.ph * g.pw + 5 * g.K * g.n) * 4;
  if (need > smem || g.heads > MAX_HEADS) return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // the attribute only grows (one card)
  if (smem > smem_set) {
    cudaFuncSetAttribute(msda_sel_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set = smem;
  }
  msda_sel_kernel<<<dim3(g.Q, g.B), threads, smem, st>>>(
      value, loc, attw, g, lv, sampled, wsum);
  return (int)cudaGetLastError();
}

template <int GPW, bool ONE>
int launch_msda_sel_tc(const void* value, const float* loc, const float* attw,
                       float* sampled, float* wsum, const MsdaArgs& g,
                       const Levels& lv, int threads, int smem,
                       cudaStream_t st) {
  if (threads != MSDA_NT || MsdaSmem(g, lv.n).total > smem ||
      g.K % SEL_K || g.K > lv.n || g.K > MSDA_NT / 32 || g.ph != WIN_H ||
      g.pw != WIN_W ||
      g.n != g.heads * PTS || g.C % 64 || g.C > GPW * 128 ||
      g.heads > TC_HEADS)
    return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // the attribute only grows (one card)
  if (smem > smem_set) {
    cudaFuncSetAttribute(msda_sel_tc_kernel<GPW, ONE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(msda_sel_tc_kernel<GPW, ONE>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    smem_set = smem;
  }
  msda_sel_tc_kernel<GPW, ONE><<<g.B * g.Q, MSDA_NT, smem, st>>>(
      (const bf16*)value, loc, attw, g, lv, sampled, wsum);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ H1, the windowed lane
// Kernel H1 for bf16 values, `msda_levels_tc_kernel`: msda_patch's
// all-level loop (:718; msda_hybrid's windowed lane, called at :1125 with
// sel_levels=None), every level in level order. It computes what
// msda_sel_tc_kernel computes with k = L (each level's window base, the
// same weights split into the same three bf16 parts, the same mma.sync
// products, summed in fp32 in the mma registers across the levels), laid
// out for a stream of windows instead of one query's pairs of levels:
// - A (query, level) item's window, 64 pixel rows of C bf16 (32 KB at C
//   256), is one cp.async commit group into a ring of `stages` stages
//   (LevelsSmem). Every level's window base is known from the query's
//   locations before its first copy, so item t + stages is issued as
//   soon as item t's product has read its stage, while items t + 1 ...
//   are in flight: a block waits on a copy only when every stage it has
//   in flight is still landing.
// - Blocks are persistent: as many as fit on the card at once, block b
//   taking queries b, b + grid, ... (no tail wave). A block reads its
//   next query's locations and weights into registers before it weighs
//   the current query's first level, and stages them (window bases,
//   which levels carry weight) after the product of level L - stages,
//   just before the next query's first window is due.
// - An item whose every kept sample has weight 0 (the corrected entries,
//   whose weights msda_hybrid's selection zeroes, and the items with no
//   sample on the level) adds nothing: its window is neither copied nor
//   multiplied. The plain version, JAX's msda_patch and the fp32 instance
//   multiply that window by zeros instead, so they differ from this
//   kernel only where the window holds a non-finite value: there they
//   give NaN and this kernel does not (ROADMAP C.10). On finite values
//   both add exact zeros.
// Locations and weights are read in msda_patch's [B, Q, L, n] layout
// (layout 0) or msda_hybrid's own [B, Q, heads, L, P] (layout 1), so that
// the hybrid passes its tensors without a permuted copy. What bounds it:
// the window rows it copies (up to 32 KB an item, mostly from L2: at r50
// 1,248 queries x 4 levels are up to 164 MB a call, 3.5 times the value
// column); its products are small (three bf16 products a weight on the
// tensor cores). On the card its time is set by each block's serial
// chain of phases (weights, barrier, product, barrier, copies), hidden by
// the other blocks of its SM: the ring's depth barely moves it and a
// third block an SM does (PERF.md §6), so the planner's ring is 2
// stages at C 256, three blocks an SM.
constexpr int LV_NT = 256;          // threads of an H1 block: 8 warps
constexpr int LV_MAX_STAGES = 4;    // window stages of the ring at most
constexpr int LV_AL = WIN + 8;      // bf16 a row of one level's weights

struct LevelsArgs {
  int B, Q, heads, C, T, stages, layout;
};

// Shared memory of an H1 block (offsets in bytes): the ring of `stages`
// windows V [64][C] bf16 (rows swizzled as MSDA-sel's), the weight parts
// A [25][LV_AL] bf16 (MSDA-sel's rows, one level wide), and two query
// slots (the current query and the next): locations [L][n] float2,
// weights [L][n], window bases [L] int2 and whether each level carries
// weight [L].
struct LevelsSmem {
  int a, loc, attw, base, live, total;
  __host__ __device__ LevelsSmem(int C, int L, int n, int stages) {
    a = stages * WIN * C * 2;
    loc = a + MsdaSmem::a_rows * LV_AL * 2;
    attw = loc + 2 * L * n * 8;
    base = attw + 2 * L * n * 4;
    live = base + 2 * L * 8;
    total = live + 2 * L * 4;
  }
};

// Wait until at most n (a uniform 0-3) commit groups are pending.
__device__ __forceinline__ void cp_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// Sample i = h * PTS + p of level l of query bq in layout 0 ([B, Q, L,
// n]) or 1 ([B, Q, heads, L, P]); locations at twice it.
__device__ __forceinline__ long long lv_sample(long long bq, int l, int i,
                                               int L, int H, int layout) {
  return layout ? ((bq * H + i / PTS) * L + l) * PTS + i % PTS
                : (bq * L + l) * (H * PTS) + i;
}

template <int GPW>
__global__ void __launch_bounds__(LV_NT, 3)
msda_levels_tc_kernel(const bf16* __restrict__ value,
                      const float* __restrict__ loc,
                      const float* __restrict__ attw, LevelsArgs g,
                      Levels lv, float* __restrict__ sampled,
                      float* __restrict__ wsum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = lv.n, H = g.heads, n = H * PTS, C = g.C, cch = C / 8;
  const int S = g.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const LevelsSmem sm(C, L, n, S);
  bf16* sv = reinterpret_cast<bf16*>(smem_raw);
  bf16* A = reinterpret_cast<bf16*>(smem_raw + sm.a);
  float2* sl = reinterpret_cast<float2*>(smem_raw + sm.loc);
  float* sa = reinterpret_cast<float*>(smem_raw + sm.attw);
  int2* sb = reinterpret_cast<int2*>(smem_raw + sm.base);
  int* slive = reinterpret_cast<int*>(smem_raw + sm.live);
  const long long BQ = (long long)g.B * g.Q;
  const int nq = (int)((BQ - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const int items = nq * L;
  // rows of A that no head fills stay zero (heads past H, the zero row)
  for (int i = tid; i < MsdaSmem::a_rows * LV_AL / 8; i += LV_NT)
    reinterpret_cast<uint4*>(A)[i] = make_uint4(0, 0, 0, 0);

  // warp l < L, lane i < n: sample i of level l of query bq, in registers
  float2 nl = make_float2(0.f, 0.f);
  float na = 0.f;
  auto fetch = [&](long long bq) {
    if (warp < L && lane < n) {
      const long long s = lv_sample(bq, warp, lane, L, H, g.layout);
      nl = make_float2(loc[2 * s], loc[2 * s + 1]);
      na = attw[s];
    }
  };
  // ... then into query slot `slot`: the samples, level l's window base
  // (the midrange of its kept samples, 1e9 sentinels when none is kept,
  // rounded half to even, clamped into [0, size - 8]; min and max are
  // exact in any order) and whether a kept sample has weight
  auto stage_query = [&](int slot) {
    if (warp < L) {
      const int l = warp, h = lv.h[l], w = lv.w[l], e = slot * L + l;
      const float px = pix(nl.x, w), py = pix(nl.y, h);
      const bool keep = lane < n && px > -1.f && px < (float)w &&
                        py > -1.f && py < (float)h;
      if (lane < n) {
        sl[e * n + lane] = nl;
        sa[e * n + lane] = na;
      }
      float mnx = keep ? px : 1e9f, mxx = keep ? px : -1e9f;
      float mny = keep ? py : 1e9f, mxy = keep ? py : -1e9f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mnx = fminf(mnx, __shfl_xor_sync(0xffffffffu, mnx, o));
        mxx = fmaxf(mxx, __shfl_xor_sync(0xffffffffu, mxx, o));
        mny = fminf(mny, __shfl_xor_sync(0xffffffffu, mny, o));
        mxy = fmaxf(mxy, __shfl_xor_sync(0xffffffffu, mxy, o));
      }
      const bool live = __any_sync(0xffffffffu, keep && na != 0.f);
      if (lane == 0) {
        const float midx = __fmul_rn(0.5f, __fadd_rn(mnx, mxx));
        const float midy = __fmul_rn(0.5f, __fadd_rn(mny, mxy));
        const int bx = (int)rintf(__fsub_rn(midx, (WIN_W - 1) / 2.0f));
        const int by = (int)rintf(__fsub_rn(midy, (WIN_H - 1) / 2.0f));
        sb[e] = make_int2(min(max(bx, 0), w - WIN_W),
                          min(max(by, 0), h - WIN_H));
        slive[e] = live;
      }
    }
  };
  // item u's window into stage u % S, one commit group (empty when the
  // item carries no weight or is past the block's last)
  auto issue = [&](int u) {
    if (u < items) {
      const int iu = u / L, l = u - iu * L, e = (iu & 1) * L + l;
      if (slive[e]) {
        const long long bq = blockIdx.x + (long long)iu * gridDim.x;
        const int2 base = sb[e];
        const int w = lv.w[l];
        const bf16* src =
            value + ((bq / g.Q) * g.T + lv.start[l] +
                     (long long)base.y * w + base.x) * C;
        bf16* dst = sv + (u % S) * WIN * C;
        const long long row_stride = (long long)w * C;
        for (int i = tid; i < WIN_W * cch; i += LV_NT) {
          const int ex_ = i / cch, c = i - ex_ * cch;
          const bf16* sp = src + ex_ * C + c * 8;
#pragma unroll
          for (int ey = 0; ey < WIN_H; ++ey) {
            const int r = ey * WIN_W + ex_;
            cp_async16(dst + r * C + ((c ^ (r & 7)) << 3),
                       sp + ey * row_stride);
          }
        }
      }
    }
    cp_commit();
  };

  fetch(blockIdx.x);
  stage_query(0);
  __syncthreads();
  for (int u = 0; u < S; ++u) issue(u);  // S <= L: all of the first query

  const int eya = lane >> 3, eyb = eya + 4, ex = lane & 7;
  const int gid = lane >> 2, tig = lane & 3;
  int arow[2];  // this lane's ldmatrix row of each A tile, as MSDA-sel's
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int p = 2 * m + ((lane & 15) >> 3);
    arow[m] = (p < 3 ? 8 * p + (lane & 7) : MsdaSmem::a_rows - 1) * LV_AL +
              (lane >> 4) * 8;
  }
  float acc[GPW][2][2][4];
#pragma unroll
  for (int gi = 0; gi < GPW; ++gi)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][m][nn][e] = 0.f;
  float wsum_t = 0.f;  // warp h < H: head h's window weight, fp32
  for (int t = 0; t < items; ++t) {
    const int i = t / L, l = t - i * L, slot = i & 1, e = slot * L + l;
    const long long bq = blockIdx.x + (long long)i * gridDim.x;
    const bool more = i + 1 < nq;
    if (more && l == 0) fetch(bq + gridDim.x);
    const bool live = slive[e];
    if (live && warp < H) {
      // warp h, head h's row of the level's weights: lanes p < 4
      // taper-clamp the head's points into [base - 1 + 1e-4, base + 8 -
      // 1e-4], then every lane weighs pixels lane and lane + 32 of the
      // window (separable bilinear one-hots, a corner outside the window
      // adds nothing, times the attention, summed over the points) and
      // writes their three bf16 parts into A's rows 8 part + h
      float fxp = 0.f, fyp = 0.f, ap = 0.f;
      int ixp = 0, iyp = 0;
      if (lane < PTS) {
        const int h = lv.h[l], w = lv.w[l], s = warp * PTS + lane;
        const float2 p2 = sl[e * n + s];
        const float px = pix(p2.x, w), py = pix(p2.y, h);
        const bool keep =
            px > -1.f && px < (float)w && py > -1.f && py < (float)h;
        const int2 base = sb[e];
        const float ax =
            fmaxf(fminf(px, __fsub_rn((float)(base.x + WIN_W), 1e-4f)),
                  __fadd_rn((float)(base.x - 1), 1e-4f));
        const float ay =
            fmaxf(fminf(py, __fsub_rn((float)(base.y + WIN_H), 1e-4f)),
                  __fadd_rn((float)(base.y - 1), 1e-4f));
        const float x0 = floorf(ax), y0 = floorf(ay);
        fxp = __fsub_rn(ax, x0);
        fyp = __fsub_rn(ay, y0);
        ixp = (int)x0 - base.x;
        iyp = (int)y0 - base.y;
        ap = __fmul_rn(sa[e * n + s], keep ? 1.f : 0.f);
      }
      float acca = 0.f, accb = 0.f;
#pragma unroll
      for (int p = 0; p < PTS; ++p) {
        const float fy = __shfl_sync(0xffffffffu, fyp, p);
        const float fx = __shfl_sync(0xffffffffu, fxp, p);
        const float a = __shfl_sync(0xffffffffu, ap, p);
        const int yi = __shfl_sync(0xffffffffu, iyp, p);
        const int xi = __shfl_sync(0xffffffffu, ixp, p);
        const float wx =
            ex == xi ? __fsub_rn(1.f, fx) : (ex == xi + 1 ? fx : 0.f);
        const float wya = eya == yi ? __fsub_rn(1.f, fy)
                                    : (eya == yi + 1 ? fy : 0.f);
        const float wyb = eyb == yi ? __fsub_rn(1.f, fy)
                                    : (eyb == yi + 1 ? fy : 0.f);
        acca = __fadd_rn(acca, __fmul_rn(__fmul_rn(wya, wx), a));
        accb = __fadd_rn(accb, __fmul_rn(__fmul_rn(wyb, wx), a));
      }
      bf16* row = A + warp * LV_AL + lane;
      const float accs[2] = {acca, accb};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const bf16 hi = __float2bfloat16_rn(accs[k]);
        const float r = __fsub_rn(accs[k], __bfloat162float(hi));
        const bf16 mid = __float2bfloat16_rn(r);
        row[32 * k] = hi;
        row[32 * k + 8 * LV_AL] = mid;
        row[32 * k + 16 * LV_AL] =
            __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
      }
      // the head's weight: its 64 pixels in a fixed butterfly (every
      // lane ends with the same bits)
      float ws = __fadd_rn(acca, accb);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ws = __fadd_rn(ws, __shfl_xor_sync(0xffffffffu, ws, o));
      wsum_t = __fadd_rn(wsum_t, ws);
    }
    cp_wait_pending(S - 1);  // item t's window has landed
    __syncthreads();
    if (live) {  // the level's product on the tensor cores
      const bf16* vs = sv + (t % S) * WIN * C;
#pragma unroll
      for (int ks = 0; ks < WIN / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) ldsm_x4(af[m], A + arow[m] + ks * 16);
        const int r = ks * 16 + (lane & 15);
#pragma unroll
        for (int gi = 0; gi < GPW; ++gi) {
          const int grp = warp + 8 * gi;
          if (grp * 16 >= C) break;
          uint32_t bfr[4];
          ldsm_x4_t(bfr,
                    vs + r * C + (((2 * grp + (lane >> 4)) ^ (r & 7)) << 3));
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[gi][m][0], af[m], bfr[0], bfr[1]);
            mma_bf16(acc[gi][m][1], af[m], bfr[2], bfr[3]);
          }
        }
      }
    }
    // the next query staged as late as its first window's issue allows,
    // so that its loads have had the items since l == 0 to land
    if (more && l == L - S) stage_query(slot ^ 1);
    if (l == L - 1) {  // the query's outputs: out[h, c] = hi + mid + lo
      if (warp < H && lane == 0) wsum[bq * H + warp] = wsum_t;
      wsum_t = 0.f;
#pragma unroll
      for (int gi = 0; gi < GPW; ++gi) {
        const int grp = warp + 8 * gi;
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          float* h0 = acc[gi][0][nn];
          float* h1 = acc[gi][1][nn];
          if (grp * 16 < C && gid < H) {
            const int c = grp * 16 + nn * 8 + 2 * tig;
            *reinterpret_cast<float2*>(sampled + (bq * H + gid) * C + c) =
                make_float2(__fadd_rn(__fadd_rn(h0[0], h0[2]), h1[0]),
                            __fadd_rn(__fadd_rn(h0[1], h0[3]), h1[1]));
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) h0[k] = h1[k] = 0.f;
        }
      }
    }
    __syncthreads();  // stage t % S and A are read; next query staged
    issue(t + S);
  }
}

// The H1 grid: as many blocks as fit on the card at once at `smem` bytes
// (the occupancy of the instance, times the SMs), at most one a query.
template <int GPW>
int levels_grid(int smem, long long queries) {
  static int smem_attr = 0, smem_at = -1, per_sm = 0, sms = 0;
  if (smem != smem_at) {
    if (smem > smem_attr) {  // the attribute only grows (one card)
      cudaFuncSetAttribute(msda_levels_tc_kernel<GPW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      cudaFuncSetAttribute(msda_levels_tc_kernel<GPW>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
      smem_attr = smem;
    }
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, msda_levels_tc_kernel<GPW>, LV_NT, smem);
    smem_at = smem;
  }
  return (int)(queries < (long long)per_sm * sms ? queries
                                                 : (long long)per_sm * sms);
}

bool levels_takes(const LevelsArgs& g, const Levels& lv, int threads,
                  int smem) {
  return threads == LV_NT && g.stages >= 1 && g.stages <= LV_MAX_STAGES &&
         g.stages <= lv.n && lv.n >= 1 && g.C % 64 == 0 && g.C <= 256 &&
         g.heads >= 1 && g.heads <= TC_HEADS &&
         (g.layout == 0 || g.layout == 1) && (long long)g.B * g.Q >= 1 &&
         LevelsSmem(g.C, lv.n, g.heads * PTS, g.stages).total <= smem;
}

template <int GPW>
int launch_msda_levels(const void* value, const float* loc, const float* attw,
                       float* sampled, float* wsum, const LevelsArgs& g,
                       const Levels& lv, int threads, int smem,
                       cudaStream_t st) {
  if (!levels_takes(g, lv, threads, smem)) return (int)cudaErrorInvalidValue;
  const int grid = levels_grid<GPW>(smem, (long long)g.B * g.Q);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  msda_levels_tc_kernel<GPW><<<grid, LV_NT, smem, st>>>(
      (const bf16*)value, loc, attw, g, lv, sampled, wsum);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- DFA backward
// Kernel B: the gradients of dfa_kernel's output g [bs, A, C] (fp32) to
// the feature column, to the points (through the corner weights: d x /
// d loc = the level's width, d y / d loc its height) and to the weights
// (a group's channels of g dotted with the sample). It replaces the
// gradient of simpb_tpu/ops/sampling.py::deformable_aggregation (:350;
// XLA's scatter-adds on the TPU). Three launches, no atomics: every
// output element has one owner, sums in a fixed order and is written
// once in its input's type, so repeat launches are bit-identical.
//
// B0, `dfa_bwd_rank_kernel`: one block per camera row counts each
// anchor's live slots (in range, and kept by the forward's capacity
// thresholds `thr`, which the forward's rank pass wrote and the autograd
// Function saved) and scans them: the live slots before each anchor's
// first (`base`) and in all (`cnt`). A live slot's rank in its row is
// then its place in slot order a * P + p among the live slots, the order
// the plain version's stable top-k keeps.
//
// B1, `dfa_bwd_kernel`: one block per (anchor, batch), as the forward.
// Its threads place the anchor's entries again and compact the live
// ones. A team of C / 8 threads takes one live entry at a time, a thread
// 8 channels; the teams step through the list in lockstep so that their
// shuffles (the group sums of the weight gradient over C / G / 8
// threads, the point gradient over the team) see whole warps. A weight
// gradient belongs to one (entry, group) and a point gradient to one
// (camera, point): both are written once (zeros included), the point's
// levels summed in level order. The sample that the weight gradient dots
// with is rounded as the forward rounds it (bf16: two channels an
// instruction, as the forward); the rest sums in fp32. For the feature
// gradient B1 only writes each live entry's record to scratch at its
// rank: the corner base, the four corner weights, the group weights and
// the anchor.
//
// B2, `dfa_bwd_gcol_kernel`: the feature gradient, owner computes. One
// block per (camera row, 8x8 pixel tile of a level) owns those feature
// rows and writes each once, zeros included, in the column's type. It
// walks its row's records in rank order and lists those whose 2x2
// footprint reaches its tile (one block scan per round of records); warp
// y, the tile's pixel row y, keeps the hits that reach its row and adds
// g[anchor, c] x group weight x corner weight for the entry's one or two
// corners in the row into fp32 sums in registers (8 pixels x 8 channels
// a lane), skipping corners of zero weight, and rounds each sum once. A
// pixel gets one corner of an entry at most, so its sum runs in rank
// order. Balance: every live slot samples every level, so a small
// level's tile sees far more entries than a large level's (at the step's
// widths the 8x22 level has 1/64 of the pixels of the 64x176 one); the
// warps walk their lists without a block barrier, and the tiles are
// numbered smallest level first, so that the crowded blocks start first.
//
// What bounds it: bytes (the feature rows the live entries read, the
// dense feature gradient written once); on the card B1's team loop is
// bound by its instructions (some 30 a channel of a live entry) and B2
// by the latency of its crowded tiles. A scatter of the feature gradient
// by B1's blocks (fp32 atomicAdd, 4 corners x C a live entry, onto rows
// that neighbouring samples share) would contend and sum in a different
// order on every run, into an fp32 copy of the column; B2's owners do
// neither and write the column's type directly.

// B1's records of the live entries, by camera row and rank (N a row):
// wk [rows][L][N] the corner weights wy0 wx0, wy0 wx1, wy1 wx0, wy1 wx1
// (fp32 products of the rounded weights, 0 for a corner off the level),
// gw [rows][L][N][G], pos [rows][L][N] (x0 + 1) | (y0 + 1) << 16,
// anc [rows][N] the anchor; B0's base [rows][A] and cnt [rows].
struct DfaRec {
  float4* wk;
  float* gw;
  int *pos, *anc, *base, *cnt;
  int N;
};

// B2's tiles: level l in B2_TILE x B2_TILE pixel tiles, numbered from
// first[l] (row-major within the level).
constexpr int B2_TILE = 8;
constexpr int B2_NT = 32 * B2_TILE;  // B2's threads: a warp a tile row
struct DfaTiles {
  int first[MAX_LEVELS];
};

template <typename T>
__global__ void __launch_bounds__(RANK_NT)
dfa_bwd_rank_kernel(const T* __restrict__ pts, const int* __restrict__ thr,
                    DfaArgs g, DfaRec rec) {
  __shared__ int warp_sum[32];
  const int bc = blockIdx.x, batch = bc / g.cams, cam = bc % g.cams;
  const int tid = threadIdx.x;
  const T* pb = pts + batch * g.sp[0] + cam * g.sp[3];
  const int lim = thr ? thr[bc] : g.A * g.P;
  int base = 0;
  for (int a0 = 0; a0 < g.A; a0 += RANK_NT) {
    const int a = a0 + tid;
    int n = 0;
    if (a < g.A)
      for (int p = 0; p < g.P; ++p) {
        const T* q = pb + a * g.sp[1] + p * g.sp[2];
        n += in_range(ld(q), ld(q + g.sp[4])) && a * g.P + p < lim;
      }
    int tot;
    const int incl = block_scan(n, warp_sum, tot);
    if (a < g.A) rec.base[bc * g.A + a] = base + incl - n;
    base += tot;
    __syncthreads();  // warp_sum is rewritten by the next pass
  }
  if (tid == 0) rec.cnt[bc] = base;
}

// One live entry's 8 samples, each rounded as the forward rounds it
// (dfa_accumulate): the two-corner rows, then the sample.
template <typename T>
__device__ __forceinline__ void dfa_sample8(float (&smp)[8], const float4 w,
                                            const Row8<T> (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float sx0 = R<T>(__fadd_rn(R<T>(__fmul_rn(w.x, v[0][i])),
                                     R<T>(__fmul_rn(w.y, v[1][i]))));
    const float sx1 = R<T>(__fadd_rn(R<T>(__fmul_rn(w.x, v[2][i])),
                                     R<T>(__fmul_rn(w.y, v[3][i]))));
    smp[i] = R<T>(__fadd_rn(R<T>(__fmul_rn(w.z, sx0)),
                            R<T>(__fmul_rn(w.w, sx1))));
  }
}

// bf16, two channels an instruction, as dfa_accumulate<bf16>.
template <>
__device__ __forceinline__ void dfa_sample8<bf16>(float (&smp)[8],
                                                  const float4 w,
                                                  const Row8<bf16> (&v)[4]) {
  const __nv_bfloat162 wx0 = __float2bfloat162_rn(w.x),
                       wx1 = __float2bfloat162_rn(w.y),
                       wy0 = __float2bfloat162_rn(w.z),
                       wy1 = __float2bfloat162_rn(w.w);
  const uint32_t a00[4] = {v[0].u[0].x, v[0].u[0].y, v[0].u[0].z, v[0].u[0].w};
  const uint32_t a01[4] = {v[1].u[0].x, v[1].u[0].y, v[1].u[0].z, v[1].u[0].w};
  const uint32_t a10[4] = {v[2].u[0].x, v[2].u[0].y, v[2].u[0].z, v[2].u[0].w};
  const uint32_t a11[4] = {v[3].u[0].x, v[3].u[0].y, v[3].u[0].z, v[3].u[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 vx0 =
        add2_rn(__hmul2(wx0, bf2(a00[i])), __hmul2(wx1, bf2(a01[i])));
    const __nv_bfloat162 vx1 =
        add2_rn(__hmul2(wx0, bf2(a10[i])), __hmul2(wx1, bf2(a11[i])));
    const float2 t =
        __bfloat1622float2(add2_rn(__hmul2(wy0, vx0), __hmul2(wy1, vx1)));
    smp[2 * i] = t.x;
    smp[2 * i + 1] = t.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
dfa_bwd_kernel(const T* __restrict__ col, const T* __restrict__ pts,
               const T* __restrict__ wts, const int* __restrict__ thr,
               const float* __restrict__ gout, DfaArgs g, Levels lv,
               DfaRec rec, T* __restrict__ gpts, T* __restrict__ gwts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_sum[32];
  const int a = blockIdx.x, batch = blockIdx.y, tid = threadIdx.x;
  const int L = lv.n, E = g.cams * g.P * L, G = g.G;
  const int CH = g.C / 8, teams = blockDim.x / CH, gsz = CH / G;
  float4* cw = reinterpret_cast<float4*>(smem_raw);  // [E] corner weights
  int4* rows = reinterpret_cast<int4*>(cw + E);      // [E] corner rows
  float2* gl = reinterpret_cast<float2*>(rows + E);  // [E] by entry
  float2* dl = gl + E;                               // [E] level w, h
  int* eid = reinterpret_cast<int*>(dl + E);         // [E] entry index
  int* msk = eid + E;                                // [E] corner masks
  float* gw = reinterpret_cast<float*>(msk + E);     // [E][G]
  int* live_pc = reinterpret_cast<int*>(gw + E * G);  // [cams * P]
  int* abase = live_pc + g.cams * g.P;  // [cams] B0's counts before a

  const long long aw = ((long long)batch * g.A + a) * g.P;  // (a, p = 0)
  for (int e = tid; e < E; e += blockDim.x) gl[e] = make_float2(0.f, 0.f);
  for (int pc = tid; pc < g.cams * g.P; pc += blockDim.x) {
    const int cam = pc / g.P, p = pc % g.P;
    const T* q = pts + batch * g.sp[0] + a * g.sp[1] + p * g.sp[2] +
                 cam * g.sp[3];
    live_pc[pc] = in_range(ld(q), ld(q + g.sp[4])) &&
                  (!thr || a * g.P + p < thr[batch * g.cams + cam]);
  }
  for (int cam = tid; cam < g.cams; cam += blockDim.x)
    abase[cam] = rec.base[(batch * g.cams + cam) * g.A + a];
  __syncthreads();
  // 1. place every entry, compact the live ones in entry order; records
  // of the live ones at their rank, zero weight gradients for the rest
  int nlive = 0;
  for (int r0 = 0; r0 < E; r0 += blockDim.x) {
    const int e = r0 + tid;
    const int l = e % L, p = e / L % g.P, cam = e / L / g.P;
    float lx = -1.f, ly = -1.f, gv[MAX_GROUPS];
    int live = 0;
    if (e < E) {
      const T* q = pts + batch * g.sp[0] + a * g.sp[1] + p * g.sp[2] +
                   cam * g.sp[3];
      const T* wq = wts + batch * g.sw[0] + a * g.sw[1] + p * g.sw[2] +
                    cam * g.sw[3] + l * g.sw[4];
      live = live_pc[cam * g.P + p];
      lx = ld(q);
      ly = ld(q + g.sp[4]);
#pragma unroll
      for (int k = 0; k < MAX_GROUPS; ++k)
        if (k < G) gv[k] = ld(wq + k * g.sw[5]);
      if (!live) {
        T* o = gwts + (((aw + p) * g.cams + cam) * L + l) * G;
#pragma unroll
        for (int k = 0; k < MAX_GROUPS; ++k)
          if (k < G) store_as(o + k, 0.f);
      }
    }
    int tot;
    const int pos = nlive + block_scan(live, warp_sum, tot) - live;
    if (live) {
      const int h = lv.h[l], w = lv.w[l];
      const float x = R<T>(__fsub_rn(R<T>(__fmul_rn(lx, (float)w)), 0.5f));
      const float y = R<T>(__fsub_rn(R<T>(__fmul_rn(ly, (float)h)), 0.5f));
      const float x0f = floorf(x), y0f = floorf(y);
      const float fx = R<T>(__fsub_rn(x, x0f)), fy = R<T>(__fsub_rn(y, y0f));
      const int x0 = (int)x0f, y0 = (int)y0f;
      const bool mx0 = x0 >= 0 && x0 < w, mx1 = x0 + 1 >= 0 && x0 + 1 < w;
      const bool my0 = y0 >= 0 && y0 < h, my1 = y0 + 1 >= 0 && y0 + 1 < h;
      const float4 c4 = make_float4(mx0 ? R<T>(__fsub_rn(1.f, fx)) : 0.f,
                                    mx1 ? fx : 0.f,
                                    my0 ? R<T>(__fsub_rn(1.f, fy)) : 0.f,
                                    my1 ? fy : 0.f);
      cw[pos] = c4;
      const int xc0 = min(max(x0, 0), w - 1), xc1 = min(max(x0 + 1, 0), w - 1);
      const int base = cam * g.T + lv.start[l];
      const int ra = base + min(max(y0, 0), h - 1) * w;
      const int rb = base + min(max(y0 + 1, 0), h - 1) * w;
      rows[pos] = make_int4(ra + xc0, ra + xc1, rb + xc0, rb + xc1);
      dl[pos] = make_float2((float)w, (float)h);
      eid[pos] = e;
      msk[pos] = (int)mx0 | (int)mx1 << 1 | (int)my0 << 2 | (int)my1 << 3;
#pragma unroll
      for (int k = 0; k < MAX_GROUPS; ++k)
        if (k < G) gw[pos * G + k] = gv[k];
      // the record, at the slot's rank among its row's live slots
      const int bc = batch * g.cams + cam;
      int rank = abase[cam];
      for (int q = 0; q < p; ++q) rank += live_pc[cam * g.P + q];
      const long long ri = ((long long)bc * L + l) * rec.N + rank;
      rec.wk[ri] = make_float4(__fmul_rn(c4.z, c4.x), __fmul_rn(c4.z, c4.y),
                               __fmul_rn(c4.w, c4.x), __fmul_rn(c4.w, c4.y));
      rec.pos[ri] = (x0 + 1) | (y0 + 1) << 16;
#pragma unroll
      for (int k = 0; k < MAX_GROUPS; ++k)
        if (k < G) rec.gw[ri * G + k] = gv[k];
      if (l == 0) rec.anc[(long long)bc * rec.N + rank] = a;
    }
    nlive += tot;
    __syncthreads();
  }

  // 2. the teams step through the live entries in lockstep
  const int team = tid / CH, ci = tid % CH;
  const int grp = ci / gsz;
  const T* cb = col + (long long)batch * g.cams * g.T * g.C + ci * 8;
  float go[8];
  {
    const float* gq = gout + ((long long)batch * g.A + a) * g.C + ci * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) go[i] = gq[i];
  }
  for (int base = 0; base < nlive; base += teams) {
    const int i = base + team;
    const bool ok = i < nlive;
    float wdot = 0.f, glx = 0.f, gly = 0.f;
    if (ok) {
      const float4 w = cw[i];
      const int4 r = rows[i];
      const int m = msk[i];
      const bool need[4] = {(m & 5) == 5, (m & 6) == 6, (m & 9) == 9,
                            (m & 10) == 10};
      const int rr[4] = {r.x, r.y, r.z, r.w};
      Row8<T> v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k].zero();
        if (need[k]) v[k].load(cb + (long long)rr[k] * g.C);
      }
      const float gwv = gw[i * G + grp];
      const float fmx0 = m & 1 ? 1.f : 0.f, fmx1 = m & 2 ? 1.f : 0.f;
      const float fmy0 = m & 4 ? 1.f : 0.f, fmy1 = m & 8 ? 1.f : 0.f;
      float smp[8];
      dfa_sample8<T>(smp, w, v);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float v00 = v[0][c], v01 = v[1][c], v10 = v[2][c],
                    v11 = v[3][c];
        wdot += go[c] * smp[c];
        const float gg = go[c] * gwv;
        const float vx0 = w.x * v00 + w.y * v01, vx1 = w.x * v10 + w.y * v11;
        glx += gg * (w.z * (fmx1 * v01 - fmx0 * v00) +
                     w.w * (fmx1 * v11 - fmx0 * v10));
        gly += gg * (fmy1 * vx1 - fmy0 * vx0);
      }
    }
    for (int o = gsz >> 1; o; o >>= 1)
      wdot += __shfl_xor_sync(0xffffffffu, wdot, o);
    for (int o = CH >> 1; o; o >>= 1) {
      glx += __shfl_xor_sync(0xffffffffu, glx, o);
      gly += __shfl_xor_sync(0xffffffffu, gly, o);
    }
    if (ok) {
      const int e = eid[i];
      if (ci % gsz == 0) {
        const int l = e % L, p = e / L % g.P, cam = e / L / g.P;
        store_as(gwts + (((aw + p) * g.cams + cam) * L + l) * G + grp, wdot);
      }
      if (ci == 0) gl[e] = make_float2(glx * dl[i].x, gly * dl[i].y);
    }
  }
  __syncthreads();

  // 3. each (camera, point): its levels' point gradients in level order
  for (int pc = tid; pc < g.cams * g.P; pc += blockDim.x) {
    const int cam = pc / g.P, p = pc % g.P;
    float sx = 0.f, sy = 0.f;
    for (int l = 0; l < L; ++l) {
      sx += gl[pc * L + l].x;
      sy += gl[pc * L + l].y;
    }
    T* o = gpts + ((aw + p) * g.cams + cam) * 2;
    store_as(o, sx);
    store_as(o + 1, sy);
  }
}

// Eight fp32 sums stored as T: one 16-byte store for bf16, two for fp32.
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

constexpr int B2_RUN = 8;     // records a B2 thread tests a round
constexpr int B2_UNROLL = 4;  // hits whose g rows a B2 warp loads together

// B2 (see above): gcol [bs, cams, T, C] in the column's type T, lane i
// of warp y owning channels 8i..8i+7 of the tile's row y. A round tests
// B2_NT * B2_RUN records, all loads issued before use, and lists the hits
// in rank order with one block scan; B2_NT hits at a time are staged, and
// each warp ballots its own list of them.
template <typename T>
__global__ void __launch_bounds__(B2_NT, 2)
dfa_bwd_gcol_kernel(const float* __restrict__ gout, DfaArgs g, Levels lv,
                    DfaRec rec, DfaTiles tl, T* __restrict__ gcol) {
  constexpr int TS = B2_TILE, NT = B2_NT;
  __shared__ int warp_sum[32];
  __shared__ int lst[NT * B2_RUN];           // a round's hits (ranks)
  __shared__ uint8_t hf[NT * B2_RUN];        // a round's hit flags
  __shared__ int sPos[NT];                   // (x0 + 1) | (y0 + 1) << 8
  __shared__ float4 sWk[NT];                 // in the tile's frame
  __shared__ int sAnc[NT];
  __shared__ float sGw[NT * MAX_GROUPS];
  __shared__ uint16_t wl[TS][NT];            // each warp's hits
  const int bc = blockIdx.x, batch = bc / g.cams, tid = threadIdx.x;
  const int lane = tid & 31, yy = tid >> 5, L = lv.n, C = g.C, G = g.G;
  const int N = rec.N;
  int t = blockIdx.y, l = 0;
  for (; l < L; ++l) {
    const int n = (lv.h[l] + TS - 1) / TS * ((lv.w[l] + TS - 1) / TS);
    if (t >= tl.first[l] && t < tl.first[l] + n) break;
  }
  t -= tl.first[l];
  const int h = lv.h[l], w = lv.w[l], ntx = (w + TS - 1) / TS;
  const int tx0 = t % ntx * TS, ty0 = t / ntx * TS;
  const int c0 = lane * 8;
  const bool chans = c0 < C;  // this lane has channels
  const int grp = c0 / (C / G);
  float acc[TS][8];
#pragma unroll
  for (int p = 0; p < TS; ++p)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[p][c] = 0.f;

  const int n = rec.cnt[bc];
  const long long rl = ((long long)bc * L + l) * N;  // this level's records
  const float* gb = gout + (long long)batch * g.A * C + c0;
  for (int r0 = 0; r0 < n; r0 += NT * B2_RUN) {
    // the round's records that reach the tile, listed in rank order:
    // loads with neighbouring threads on neighbouring records, then a
    // thread ranks a contiguous run of the flags
    const int len = min(n - r0, NT * B2_RUN);
    int pk[B2_RUN];
#pragma unroll
    for (int k = 0; k < B2_RUN; ++k) {
      const int i = k * NT + tid;
      pk[k] = i < len ? rec.pos[rl + r0 + i] : 0;
    }
#pragma unroll
    for (int k = 0; k < B2_RUN; ++k) {
      const int i = k * NT + tid;
      const int x0 = (pk[k] & 0xffff) - 1 - tx0, y0 = (pk[k] >> 16) - 1 - ty0;
      if (i < len) hf[i] = x0 >= -1 && x0 < TS && y0 >= -1 && y0 < TS;
    }
    __syncthreads();
    const int run = (len + NT - 1) / NT, first = tid * run;
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < B2_RUN; ++i)
      if (i < run && first + i < len) bits |= (unsigned)hf[first + i] << i;
    int tot;
    int at = block_scan(__popc(bits), warp_sum, tot) - __popc(bits);
#pragma unroll
    for (int i = 0; i < B2_RUN; ++i)
      if ((bits >> i) & 1u) lst[at++] = r0 + first + i;
    __syncthreads();
    for (int s0 = 0; s0 < tot; s0 += NT) {
      // stage NT hits: the corner base in the tile's frame, the corner
      // weights, the anchor, the group weights
      const int m = min(NT, tot - s0);
      if (tid < m) {
        const int r = lst[s0 + tid], q = rec.pos[rl + r];
        sPos[tid] = ((q & 0xffff) - tx0) | ((q >> 16) - ty0) << 8;
        sWk[tid] = rec.wk[rl + r];
        sAnc[tid] = rec.anc[(long long)bc * N + r];
        for (int k = 0; k < G; ++k)
          sGw[tid * G + k] = rec.gw[(rl + r) * G + k];
      }
      __syncthreads();
      // this warp's hits: a corner in tile row yy
      int cnt = 0;
      for (int b = 0; b < m; b += 32) {
        const int i = b + lane;
        const int y0 = i < m ? (sPos[i] >> 8) - 1 : -9;
        const bool mine = y0 == yy || y0 + 1 == yy;
        const unsigned bal = __ballot_sync(0xffffffffu, mine);
        if (mine) wl[yy][cnt + __popc(bal & ((1u << lane) - 1))] = i;
        cnt += __popc(bal);
      }
      __syncwarp();
      for (int j0 = 0; j0 < cnt; j0 += B2_UNROLL) {
        float4 gr[B2_UNROLL][2];
#pragma unroll
        for (int u = 0; u < B2_UNROLL; ++u)
          if (j0 + u < cnt && chans) {
            const float4* q = reinterpret_cast<const float4*>(
                gb + (long long)sAnc[wl[yy][j0 + u]] * C);
            gr[u][0] = q[0];
            gr[u][1] = q[1];
          } else {
            gr[u][0] = gr[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
        for (int u = 0; u < B2_UNROLL; ++u) {
          if (j0 + u >= cnt) break;
          const int e = wl[yy][j0 + u], pe = sPos[e];
          const int x0 = (pe & 0xff) - 1, dy = yy - ((pe >> 8) - 1);
          const float4 w4 = sWk[e];
          const float gwv = sGw[e * G + grp];
          const float gv[8] = {gr[u][0].x, gr[u][0].y, gr[u][0].z,
                               gr[u][0].w, gr[u][1].x, gr[u][1].y,
                               gr[u][1].z, gr[u][1].w};
          float gg[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) gg[c] = __fmul_rn(gv[c], gwv);
          // corner k = 2 dy + dx of the entry, weight wc, at pixel p
          const int ka = 2 * dy;
          const float wa = dy ? w4.z : w4.x, wb = dy ? w4.w : w4.y;
          auto add = [&](float (&a)[8], int k, float wc) {
#pragma unroll
            for (int c = 0; c < 8; ++c)
              if (wc != 0.f)
                a[c] = __fadd_rn(a[c], __fmul_rn(gg[c], wc));
          };
          switch (x0) {
            case -1: add(acc[0], ka + 1, wb); break;
            case 0: add(acc[0], ka, wa); add(acc[1], ka + 1, wb); break;
            case 1: add(acc[1], ka, wa); add(acc[2], ka + 1, wb); break;
            case 2: add(acc[2], ka, wa); add(acc[3], ka + 1, wb); break;
            case 3: add(acc[3], ka, wa); add(acc[4], ka + 1, wb); break;
            case 4: add(acc[4], ka, wa); add(acc[5], ka + 1, wb); break;
            case 5: add(acc[5], ka, wa); add(acc[6], ka + 1, wb); break;
            case 6: add(acc[6], ka, wa); add(acc[7], ka + 1, wb); break;
            case 7: add(acc[7], ka, wa); break;
          }
        }
      }
      __syncthreads();  // the staging is rewritten by the next window
    }
  }
  // the warp's tile row on the level, 8 pixels x 8 channels a lane
  const int y = ty0 + yy;
  if (y >= h || !chans) return;
  T* out = gcol + ((long long)bc * g.T + lv.start[l] + (long long)y * w) * C +
           c0;
#pragma unroll
  for (int p = 0; p < TS; ++p)
    if (tx0 + p < w) store8(out + (long long)(tx0 + p) * C, acc[p]);
}

int dfa_bwd_smem_bytes(const DfaArgs& g, int L) {
  const int E = g.cams * g.P * L;
  return E * (16 + 16 + 8 + 8 + 4 + 4 + 4 * g.G) + 4 * g.cams * (g.P + 1);
}

// stages: 1 B0, 2 B1, 4 B2 (the wrapper launches all three; chip_smoke
// times them apart on one scratch).
template <typename T>
int launch_dfa_bwd(const void* col, const void* pts, const void* wts,
                   const int* thr, const float* gout, T* gcol, T* gpts,
                   T* gwts, void* scratch, const DfaArgs& g,
                   const Levels& lv, int threads, int smem, int tiles,
                   const DfaTiles& tl, int stages, cudaStream_t st) {
  const int CH = g.C / 8, rows = g.bs * g.cams, L = lv.n;
  int want = 0;
  for (int l = 0; l < L; ++l)
    want += (lv.h[l] + B2_TILE - 1) / B2_TILE *
            ((lv.w[l] + B2_TILE - 1) / B2_TILE);
  if (g.C % 8 || (g.C / g.G) % 8 || g.G > MAX_GROUPS || CH > 32 ||
      (CH & (CH - 1)) || ((CH / g.G) & (CH / g.G - 1)) || threads % CH ||
      threads % 32 || threads > 256 || dfa_bwd_smem_bytes(g, L) > smem ||
      tiles != want || stages & ~7)
    return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // the attribute only grows (one card)
  if (smem > smem_set) {
    cudaFuncSetAttribute(dfa_bwd_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set = smem;
  }
  DfaRec rec;
  rec.N = g.M >= 0 ? g.M : g.A * g.P;
  const long long n = (long long)rows * L * rec.N;
  rec.wk = reinterpret_cast<float4*>(scratch);
  rec.gw = reinterpret_cast<float*>(rec.wk + n);
  rec.pos = reinterpret_cast<int*>(rec.gw + n * g.G);
  rec.anc = rec.pos + n;
  rec.base = rec.anc + (long long)rows * rec.N;
  rec.cnt = rec.base + (long long)rows * g.A;
  if (stages & 1) {
    dfa_bwd_rank_kernel<T><<<rows, RANK_NT, 0, st>>>((const T*)pts, thr, g,
                                                     rec);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (stages & 2) {
    dfa_bwd_kernel<T><<<dim3(g.A, g.bs), threads, smem, st>>>(
        (const T*)col, (const T*)pts, (const T*)wts, thr, gout, g, lv, rec,
        gpts, gwts);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (stages & 4)
    dfa_bwd_gcol_kernel<T><<<dim3(rows, tiles), B2_NT, 0, st>>>(
        gout, g, lv, rec, tl, gcol);
  return (int)cudaGetLastError();
}

// -------------------------------------------------- MSDA-sel backward
// Kernel C: the gradients of MSDA-sel's (sampled [B, Q, heads, C], wsum
// [B, Q, heads]) to the value, to the locations (through the
// taper-clamped bilinear fractions; the window bases and the top-k level
// choice are discrete; a sample exactly on a clamp bound passes half, as
// min and max split a tie) and to the attention weights. It replaces the
// gradient of simpb_tpu/ops/sampling.py::_msda_patch_sel (:892; XLA's
// scatter-adds on the TPU). Two launches, no atomics: every output
// element has one owner and sums in a fixed order, so repeat launches
// are bit-identical.
//
// C1, `msda_sel_bwd_kernel`: one block per (query, camera row). It does
// not reuse the forward: it recomputes the levels, windows and per-head
// window weights W from loc and attw (steps 1-5 of msda_sel_kernel), so
// the autograd Function saves only its inputs; a warp finds each
// window's base (shuffle min and max). Then each pixel's gradient G[h,
// px] = g_sampled[h] . V[px] + g_wsum[h]: a lane per window pixel keeps
// its heads' sums in registers (at most BWD_HEADS, a compile-time count)
// over one channel half, reading g_sampled from shared memory as [C][8]
// broadcasts; the two halves add in order. A thread per sample reads the
// four G of its corners: the location and weight gradients, each written
// once. It writes W [B, Q, K, heads, ph * pw] and each window's (level,
// base) to scratch for C3.
//
// C3, `msda_sel_gvalue_kernel`: the value gradient, owner computes. One
// block per (8x8 pixel tile of a level, camera row, channel slice of 32
// * CPL) owns those gvalue elements and writes each once, zeros
// included. It walks its row's windows in (query, k) order, keeps those
// that reach its tile (a block scan compacts a chunk of 256 at a time),
// and for each stages the window's weights, re-cut to the tile (zero
// outside the window), and the query's g_sampled slice in shared memory
// (loaded into registers while the previous window adds up; two buffers,
// one barrier a window); warp y, the tile's pixel row y, adds W[h, px]
// g_sampled[h, c] over the heads into fp32 registers (8 pixels x CPL
// channels a lane), skipping windows that miss its row, and rounds to the
// value's type once.
//
// What bounds it: fp32 operations (2 per (query, level, head, pixel,
// channel) for G and as many for the value gradient) and the dense
// value gradient written once. A scatter of the value gradient by the
// query's block (fp32 atomicAdd, up to 2 x 64 x 256 a block, onto rows
// that neighbouring queries share) would contend and sum in a
// different order on every run; C3's owners do neither.
constexpr int BWD_HEADS = 8;  // kernel C's heads at most (sums in registers)

// Four channels of a value row as fp32 (16 bytes of fp32, 8 of bf16).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__global__ void __launch_bounds__(256)
msda_sel_bwd_kernel(const T* __restrict__ value,
                    const float* __restrict__ loc,
                    const float* __restrict__ attw,
                    const float* __restrict__ gsamp,
                    const float* __restrict__ gwsum, MsdaArgs g, Levels lv,
                    float* __restrict__ gloc, float* __restrict__ gattw,
                    float* __restrict__ wscr, unsigned* __restrict__ wins) {
  constexpr int HP = BWD_HEADS;
  extern __shared__ __align__(16) float smem[];
  __shared__ float mass[MAX_LEVELS], gws[HP];
  __shared__ int lsel[MAX_LEVELS], bxs[MAX_LEVELS], bys[MAX_LEVELS];
  const int q = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int L = lv.n, n = g.n, K = g.K, win = g.ph * g.pw, H = g.heads;
  const int np = n / H, KW = K * win;
  const long long bq = (long long)b * g.Q + q;
  const float* lq = loc + bq * L * n * 2;
  const float* aq = attw + bq * L * n;
  float* gsT = smem;               // [C][HP] g_sampled, zero past H
  float* Gp = gsT + g.C * HP;      // [2][KW][HP] channel halves' sums
  float* W = Gp + 2 * KW * HP;     // [K][heads][win]
  float* Gm = W + K * H * win;     // [K][heads][win] pixel gradients
  float* fx = Gm + K * H * win;    // [K][n]
  float* fy = fx + K * n;          // [K][n]
  float* ak = fy + K * n;          // [K][n] attention * keep
  int* ix = (int*)(ak + K * n);    // [K][n]
  int* iy = ix + K * n;            // [K][n]
  int* fl = iy + K * n;            // [K][n] keep | clamp x | clamp y

  // 1-3. levels and window bases, as msda_sel_kernel
  if (tid < L) {
    float m = 0.f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) m = __fadd_rn(m, aq[tid * n + i]);
    mass[tid] = m;
  }
  if (tid < HP) gws[tid] = tid < H ? gwsum[bq * H + tid] : 0.f;
  for (int t = tid; t < H * g.C; t += blockDim.x)
    gsT[t % g.C * HP + t / g.C] = gsamp[bq * H * g.C + t];
  for (int t = tid; t < (HP - H) * g.C; t += blockDim.x)
    gsT[t / (HP - H) * HP + H + t % (HP - H)] = 0.f;
  __syncthreads();
  if (tid == 0) {
    bool taken[MAX_LEVELS] = {};
    for (int j = 0; j < K; ++j) {
      int best = -1;
      for (int l = 0; l < L; ++l)
        if (!taken[l] && (best < 0 || mass[l] > mass[best])) best = l;
      taken[best] = true;
      lsel[j] = best;
    }
  }
  __syncthreads();
  // warp j: window j's base (min and max are exact in any order)
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  if (warp < K) {
    const int j = warp, l = lsel[j], h = lv.h[l], w = lv.w[l];
    float mnx = 1e9f, mxx = -1e9f, mny = 1e9f, mxy = -1e9f;
    for (int i = lane; i < n; i += 32) {
      const float px = pix(lq[(l * n + i) * 2], w);
      const float py = pix(lq[(l * n + i) * 2 + 1], h);
      if (px > -1.f && px < (float)w && py > -1.f && py < (float)h) {
        mnx = fminf(mnx, px); mxx = fmaxf(mxx, px);
        mny = fminf(mny, py); mxy = fmaxf(mxy, py);
      }
    }
    for (int o = 16; o; o >>= 1) {
      mnx = fminf(mnx, __shfl_xor_sync(0xffffffffu, mnx, o));
      mxx = fmaxf(mxx, __shfl_xor_sync(0xffffffffu, mxx, o));
      mny = fminf(mny, __shfl_xor_sync(0xffffffffu, mny, o));
      mxy = fmaxf(mxy, __shfl_xor_sync(0xffffffffu, mxy, o));
    }
    if (lane == 0) {
      const float midx = __fmul_rn(0.5f, __fadd_rn(mnx, mxx));
      const float midy = __fmul_rn(0.5f, __fadd_rn(mny, mxy));
      const int bx = (int)rintf(__fsub_rn(midx, (g.pw - 1) / 2.0f));
      const int by = (int)rintf(__fsub_rn(midy, (g.ph - 1) / 2.0f));
      bxs[j] = min(max(bx, 0), w - g.pw);
      bys[j] = min(max(by, 0), h - g.ph);
      wins[bq * K + j] = (unsigned)l | (unsigned)bxs[j] << 3 |
                         (unsigned)bys[j] << 17;
    }
  }
  __syncthreads();
  // 4. the taper-clamped samples; whether the clamp passed each axis
  for (int e = tid; e < K * n; e += blockDim.x) {
    const int j = e / n, i = e % n, l = lsel[j], h = lv.h[l], w = lv.w[l];
    const float px = pix(lq[(l * n + i) * 2], w);
    const float py = pix(lq[(l * n + i) * 2 + 1], h);
    const bool keep = px > -1.f && px < (float)w && py > -1.f && py < (float)h;
    const int bx = bxs[j], by = bys[j];
    const float hx = __fsub_rn((float)(bx + g.pw), 1e-4f);
    const float lx = __fadd_rn((float)(bx - 1), 1e-4f);
    const float hy = __fsub_rn((float)(by + g.ph), 1e-4f);
    const float ly = __fadd_rn((float)(by - 1), 1e-4f);
    const float ax = fmaxf(fminf(px, hx), lx);
    const float ay = fmaxf(fminf(py, hy), ly);
    const float x0 = floorf(ax), y0 = floorf(ay);
    fx[e] = __fsub_rn(ax, x0);
    fy[e] = __fsub_rn(ay, y0);
    ix[e] = (int)x0 - bx;
    iy[e] = (int)y0 - by;
    ak[e] = __fmul_rn(aq[l * n + i], keep ? 1.f : 0.f);
    // the clamp's gradient, in halves: 2 strictly inside, 1 on a bound
    // (min / max split a tie evenly, in torch and in JAX), 0 outside
    const int cx = (px > lx && px < hx) ? 2 : (px == lx || px == hx);
    const int cy = (py > ly && py < hy) ? 2 : (py == ly || py == hy);
    fl[e] = (int)keep | cx << 1 | cy << 3;
  }
  __syncthreads();
  // 5. per-head window weights, as msda_sel_kernel; C3 reads them
  float* wq = wscr + bq * K * H * win;
  for (int t = tid; t < K * H * win; t += blockDim.x) {
    const int px = t % win, jh = t / win, hh = jh % H, j = jh / H;
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
    wq[t] = acc;
  }
  __syncthreads();

  // 6. G: a lane per window pixel, its heads' sums in registers; warps
  // take (32 pixels, channel half) items, the halves added in order
  const int units = (KW + 31) / 32, half_c = g.C / 2;
  for (int it = warp; it < 2 * units; it += nw) {
    const int half = it / units, p = it % units * 32 + lane;
    float acc[HP];
#pragma unroll
    for (int h = 0; h < HP; ++h) acc[h] = 0.f;
    if (p < KW) {
      const int j = p / win, e = p % win, l = lsel[j], w = lv.w[l];
      const long long row = (long long)b * g.T + lv.start[l] +
                            (long long)(bys[j] + e / g.pw) * w + bxs[j] +
                            e % g.pw;
      const T* vr = value + row * g.C;
      const int c0 = half * half_c;
#pragma unroll 4
      for (int c = c0; c < c0 + half_c; c += 4) {
        const float4 v = ld4(vr + c);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* gc = gsT + (c + i) * HP;
#pragma unroll
          for (int h = 0; h < HP; h += 4) {
            const float4 s4 = *reinterpret_cast<const float4*>(gc + h);
            acc[h] = fmaf(s4.x, vv[i], acc[h]);
            acc[h + 1] = fmaf(s4.y, vv[i], acc[h + 1]);
            acc[h + 2] = fmaf(s4.z, vv[i], acc[h + 2]);
            acc[h + 3] = fmaf(s4.w, vv[i], acc[h + 3]);
          }
        }
      }
      float* gp = Gp + (half * KW + p) * HP;
#pragma unroll
      for (int h = 0; h < HP; ++h) gp[h] = acc[h];
    }
  }
  __syncthreads();
  for (int t = tid; t < K * H * win; t += blockDim.x) {
    const int e = t % win, jh = t / win, hh = jh % H, j = jh / H;
    const int p = j * win + e;
    Gm[t] = (Gp[p * HP + hh] + Gp[(KW + p) * HP + hh]) + gws[hh];
  }
  __syncthreads();

  // 7. a thread per sample: its four corners' G
  for (int s = tid; s < K * n; s += blockDim.x) {
    const int j = s / n, i = s % n, hh = i / np, l = lsel[j];
    const float* Gh = Gm + (j * H + hh) * win;
    const int x0 = ix[s], y0 = iy[s];
    auto at = [&](int y, int x) {
      return (y >= 0 && y < g.ph && x >= 0 && x < g.pw) ? Gh[y * g.pw + x]
                                                        : 0.f;
    };
    const float g00 = at(y0, x0), g01 = at(y0, x0 + 1);
    const float g10 = at(y0 + 1, x0), g11 = at(y0 + 1, x0 + 1);
    const float wx1 = fx[s], wx0 = 1.f - wx1, wy1 = fy[s], wy0 = 1.f - wy1;
    const float a = ak[s];
    const int f = fl[s];
    const float ga = wy0 * (wx0 * g00 + wx1 * g01) +
                     wy1 * (wx0 * g10 + wx1 * g11);
    const float glx = 0.5f * (float)((f >> 1) & 3) * a *
                      (wy0 * (g01 - g00) + wy1 * (g11 - g10));
    const float gly = 0.5f * (float)((f >> 3) & 3) * a *
                      (wx0 * (g10 - g00) + wx1 * (g11 - g01));
    const long long o = (bq * L + l) * n + i;
    gloc[o * 2] = glx * (float)lv.w[l];
    gloc[o * 2 + 1] = gly * (float)lv.h[l];
    gattw[o] = (f & 1) ? ga : 0.f;
  }
}

constexpr int GV_TILE = 8;     // C3's pixel tile (GV_TILE x GV_TILE)
constexpr int GV_NT = 256;     // C3's threads: a warp a tile row
static_assert(GV_NT == 32 * GV_TILE, "one warp a tile row");

// C3 (see above): gvalue [B, T, C] in the value's type T, each element
// summed in fp32 and rounded once, written once. Tiles are numbered level
// by level, row-major within a level.
template <typename T, int CPL>
__global__ void __launch_bounds__(GV_NT)
msda_sel_gvalue_kernel(const float* __restrict__ wscr,
                       const unsigned* __restrict__ wins,
                       const float* __restrict__ gsamp, MsdaArgs g,
                       Levels lv, T* __restrict__ gvalue) {
  constexpr int CS = 32 * CPL;  // channels a block
  constexpr int TP = GV_TILE * GV_TILE, HP = BWD_HEADS;
  // a thread's staging: WS weights (heads h0 + k * GV_NT / TP at its tile
  // pixel) and GV 16-byte pieces of g_sampled
  constexpr int WS = HP * TP / GV_NT, GQ = CS / 4;
  constexpr int GV = (HP * GQ + GV_NT - 1) / GV_NT;
  __shared__ __align__(16) float Wt[2][HP][TP];
  __shared__ __align__(16) float gsS[2][HP][CS];
  __shared__ int hits[GV_NT];
  __shared__ int warp_sum[32];
  int t = blockIdx.x, l = 0, ntx = 1;
  for (; l < lv.n; ++l) {
    ntx = (lv.w[l] + GV_TILE - 1) / GV_TILE;
    const int nt = ntx * ((lv.h[l] + GV_TILE - 1) / GV_TILE);
    if (t < nt) break;
    t -= nt;
  }
  const int tx0 = t % ntx * GV_TILE, ty0 = t / ntx * GV_TILE;
  const int b = blockIdx.y, c0 = blockIdx.z * CS;
  const int tid = threadIdx.x, lane = tid & 31, y = tid >> 5;
  const int H = g.heads, QK = g.Q * g.K, win = g.ph * g.pw;
  const int yy = ty0 + y;
  const bool row_in = yy < lv.h[l];
  const unsigned* wb = wins + (long long)b * QK;
  const int sp = tid % TP, sh = tid / TP;  // this thread's staged pixel
  float acc[GV_TILE][CPL];
#pragma unroll
  for (int p = 0; p < GV_TILE; ++p)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[p][c] = 0.f;

  // the next window's weights re-cut to the tile and its query's
  // g_sampled slice, into registers while the current window adds up
  float wreg[WS];
  float4 greg[GV];
  auto fetch = [&](int e) {
    const unsigned d = wb[e];
    const int lx = tx0 + sp % GV_TILE - (int)((d >> 3) & 0x3fff);
    const int ly = ty0 + sp / GV_TILE - (int)(d >> 17);
    const bool in = lx >= 0 && lx < g.pw && ly >= 0 && ly < g.ph;
    const float* we =
        wscr + ((long long)b * QK + e) * H * win + ly * g.pw + lx;
#pragma unroll
    for (int k = 0; k < WS; ++k) {
      const int h = sh + k * (GV_NT / TP);
      wreg[k] = in && h < H ? we[h * win] : 0.f;
    }
    const float* gq = gsamp + ((long long)b * g.Q + e / g.K) * H * g.C + c0;
#pragma unroll
    for (int k = 0; k < GV; ++k) {
      const int s = tid + k * GV_NT, h = s / GQ, c = s % GQ * 4;
      greg[k] = h < H && c0 + c < g.C
                    ? *reinterpret_cast<const float4*>(gq + h * g.C + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  int buf = 0;
  for (int base = 0; base < QK; base += GV_NT) {
    // this chunk's windows that reach the tile, in (query, k) order
    int hit = 0;
    if (base + tid < QK) {
      const unsigned d = wb[base + tid];
      const int bx = (d >> 3) & 0x3fff, by = d >> 17;
      hit = (int)(d & 7) == l && bx < tx0 + GV_TILE && bx + g.pw > tx0 &&
            by < ty0 + GV_TILE && by + g.ph > ty0;
    }
    int tot;
    const int pos = block_scan(hit, warp_sum, tot) - hit;
    if (hit) hits[pos] = base + tid;
    __syncthreads();
    if (tot) fetch(hits[0]);
    for (int i = 0; i < tot; ++i, buf ^= 1) {
      const int e = hits[i];  // window e = query * K + k of the row
      const unsigned d = wb[e];
      const int bx = (d >> 3) & 0x3fff, by = d >> 17;
      // two buffers: one barrier a window (the other buffer was last
      // read before the previous window's barrier)
#pragma unroll
      for (int k = 0; k < WS; ++k) Wt[buf][sh + k * (GV_NT / TP)][sp] = wreg[k];
#pragma unroll
      for (int k = 0; k < GV; ++k) {
        const int s = tid + k * GV_NT;
        if (s < HP * GQ)
          *reinterpret_cast<float4*>(&gsS[buf][s / GQ][s % GQ * 4]) =
              greg[k];
      }
      __syncthreads();
      if (i + 1 < tot) fetch(hits[i + 1]);
      if (row_in && yy >= by && yy < by + g.ph) {
        for (int h = 0; h < H; ++h) {
          const float4 w0 =
              *reinterpret_cast<const float4*>(&Wt[buf][h][y * GV_TILE]);
          const float4 w1 =
              *reinterpret_cast<const float4*>(&Wt[buf][h][y * GV_TILE + 4]);
          const float wp[GV_TILE] = {w0.x, w0.y, w0.z, w0.w,
                                     w1.x, w1.y, w1.z, w1.w};
          float gv[CPL];
          if constexpr (CPL == 4) {
            const float4 g4 =
                *reinterpret_cast<const float4*>(&gsS[buf][h][lane * 4]);
            gv[0] = g4.x, gv[1] = g4.y, gv[2] = g4.z, gv[3] = g4.w;
          } else {
#pragma unroll
            for (int c = 0; c < CPL; ++c) gv[c] = gsS[buf][h][lane * CPL + c];
          }
#pragma unroll
          for (int p = 0; p < GV_TILE; ++p)
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              acc[p][c] = fmaf(wp[p], gv[c], acc[p][c]);
        }
      }
    }
    __syncthreads();  // hits is free for the next chunk
  }
  if (!row_in) return;
  const int w = lv.w[l];
  T* out =
      gvalue + ((long long)b * g.T + lv.start[l] + (long long)yy * w) * g.C;
#pragma unroll
  for (int p = 0; p < GV_TILE; ++p) {
    if (tx0 + p >= w) break;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = c0 + lane * CPL + c;
      if (ch < g.C) store_as(out + (long long)(tx0 + p) * g.C + ch, acc[p][c]);
    }
  }
}

int msda_bwd_smem_bytes(const MsdaArgs& g) {
  const int kw = g.K * g.ph * g.pw;
  return 4 * (g.C * BWD_HEADS + 2 * kw * BWD_HEADS + 2 * kw * g.heads +
              6 * g.K * g.n);
}

template <typename T, int CPL>
void launch_gvalue(const float* wscr, const unsigned* wins,
                   const float* gsamp, const MsdaArgs& g, const Levels& lv,
                   int tiles, T* gvalue, cudaStream_t st) {
  msda_sel_gvalue_kernel<T, CPL>
      <<<dim3(tiles, g.B, (g.C + 32 * CPL - 1) / (32 * CPL)), GV_NT, 0, st>>>(
          wscr, wins, gsamp, g, lv, gvalue);
}

template <typename T>
int launch_msda_sel_bwd(const void* value, const float* loc,
                        const float* attw, const float* gsamp,
                        const float* gwsum, void* gvalue, float* gloc,
                        float* gattw, float* scratch, const MsdaArgs& g,
                        const Levels& lv, int threads, int smem, int tiles,
                        int cpl, cudaStream_t st) {
  int want = 0;
  for (int l = 0; l < lv.n; ++l)
    want += (lv.w[l] + GV_TILE - 1) / GV_TILE *
            ((lv.h[l] + GV_TILE - 1) / GV_TILE);
  if (msda_bwd_smem_bytes(g) > smem || g.heads > BWD_HEADS ||
      threads != 256 || g.K > threads / 32 || g.C % 8 || tiles != want ||
      (cpl != 1 && cpl != 2 && cpl != 4))
    return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // the attribute only grows (one card)
  if (smem > smem_set) {
    cudaFuncSetAttribute(msda_sel_bwd_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set = smem;
  }
  float* wscr = scratch;
  unsigned* wins = reinterpret_cast<unsigned*>(
      scratch + (long long)g.B * g.Q * g.K * g.heads * g.ph * g.pw);
  msda_sel_bwd_kernel<T><<<dim3(g.Q, g.B), threads, smem, st>>>(
      (const T*)value, loc, attw, gsamp, gwsum, g, lv, gloc, gattw, wscr,
      wins);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  T* gv = (T*)gvalue;
  if (cpl == 4) launch_gvalue<T, 4>(wscr, wins, gsamp, g, lv, tiles, gv, st);
  else if (cpl == 2)
    launch_gvalue<T, 2>(wscr, wins, gsamp, g, lv, tiles, gv, st);
  else launch_gvalue<T, 1>(wscr, wins, gsamp, g, lv, tiles, gv, st);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- exact MSDA
struct MsdaExactArgs {
  int B, Q, heads, L, P, C, T;
};

// The exact kernels' items: one (camera row, query, head) a half-warp,
// MX_ITEMS of them a block in (row, query, head) order, so that a block
// holds two queries' heads (the L1 keeps the rows they share). A lane
// takes MX_PACKS packs of 8 channels, 16 * MX_PACKS packs (256 channels)
// a pass over the channels.
constexpr int MX_NT = 256;
constexpr int MX_ITEMS = MX_NT / 16;
constexpr int MX_PACKS = 2;

// One sample's corner weights (wx0, wx1, wy0, wy1; rounded to T as
// _corner_weights rounds them, drop_out_of_range off) and the rows of its
// four corners in the camera row's [T, C] table, indices clamped into the
// level. The position stays fp32 (the locations are fp32). Border tests
// compare floors as floats: exact for any finite position.
template <typename T>
__device__ __forceinline__ void msda_corners(float lx, float ly, int h, int w,
                                             int start, float4& cw,
                                             int4& rows) {
  const float x = pix(lx, w), y = pix(ly, h);
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = R<T>(__fsub_rn(x, x0f)), fy = R<T>(__fsub_rn(y, y0f));
  const float wf = (float)w, hf = (float)h;
  cw = make_float4((x0f >= 0.f && x0f < wf) ? R<T>(__fsub_rn(1.f, fx)) : 0.f,
                   (x0f >= -1.f && x0f < wf - 1.f) ? fx : 0.f,
                   (y0f >= 0.f && y0f < hf) ? R<T>(__fsub_rn(1.f, fy)) : 0.f,
                   (y0f >= -1.f && y0f < hf - 1.f) ? fy : 0.f);
  const int xc0 = (int)fminf(fmaxf(x0f, 0.f), wf - 1.f);
  const int xc1 = (int)fminf(fmaxf(x0f + 1.f, 0.f), wf - 1.f);
  const int r0 = start + (int)fminf(fmaxf(y0f, 0.f), hf - 1.f) * w;
  const int r1 = start + (int)fminf(fmaxf(y0f + 1.f, 0.f), hf - 1.f) * w;
  rows = make_int4(r0 + xc0, r0 + xc1, r1 + xc0, r1 + xc1);
}

// bf16 pairs with one rounding each, written out so that nothing fuses:
// a product of two bf16 values is exact in fp32, and a bf16 sum rounded
// once equals torch's fp32 sum rounded to bf16 (double rounding through
// a format of at least 2 x 8 + 2 significand bits is innocuous), so both
// are the plain version's roundings, at one instruction a pair.
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bsplat(float v) {  // v is a bf16 value
  const __nv_bfloat162 b = __float2bfloat162_rn(v);
  return *reinterpret_cast<const uint32_t*>(&b);
}
__device__ __forceinline__ float blo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bhi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// A sample's 8 channels from its four corner rows, each rounding as the
// plain version's (_sample_rows: the x pairs vx0, vx1, then y, in T).
template <typename T>
__device__ __forceinline__ void msda_bilinear(float (&s)[8], float (&vx0)[8],
                                              float (&vx1)[8], const float4 w,
                                              const Row8<T> (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    vx0[i] = R<T>(__fadd_rn(R<T>(__fmul_rn(w.x, v[0][i])),
                            R<T>(__fmul_rn(w.y, v[1][i]))));
    vx1[i] = R<T>(__fadd_rn(R<T>(__fmul_rn(w.x, v[2][i])),
                            R<T>(__fmul_rn(w.y, v[3][i]))));
    s[i] = R<T>(__fadd_rn(R<T>(__fmul_rn(w.z, vx0[i])),
                          R<T>(__fmul_rn(w.w, vx1[i]))));
  }
}
template <>
__device__ __forceinline__ void msda_bilinear<bf16>(
    float (&s)[8], float (&vx0)[8], float (&vx1)[8], const float4 w,
    const Row8<bf16> (&v)[4]) {
  const uint32_t wx0 = bsplat(w.x), wx1 = bsplat(w.y), wy0 = bsplat(w.z),
                 wy1 = bsplat(w.w);
  const uint4 q0 = v[0].u[0], q1 = v[1].u[0], q2 = v[2].u[0], q3 = v[3].u[0];
  const uint32_t a00[4] = {q0.x, q0.y, q0.z, q0.w};
  const uint32_t a01[4] = {q1.x, q1.y, q1.z, q1.w};
  const uint32_t a10[4] = {q2.x, q2.y, q2.z, q2.w};
  const uint32_t a11[4] = {q3.x, q3.y, q3.z, q3.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x0 = badd2(bmul2(wx0, a00[i]), bmul2(wx1, a01[i]));
    const uint32_t x1 = badd2(bmul2(wx0, a10[i]), bmul2(wx1, a11[i]));
    const uint32_t t = badd2(bmul2(wy0, x0), bmul2(wy1, x1));
    s[2 * i] = blo(t);
    s[2 * i + 1] = bhi(t);
    vx0[2 * i] = blo(x0);
    vx0[2 * i + 1] = bhi(x0);
    vx1[2 * i] = blo(x1);
    vx1[2 * i + 1] = bhi(x1);
  }
}

// value [B, T, C] (T storage), loc [B, Q, heads, L, P, 2] and attw [B,
// Q, heads, L, P] fp32; sampled [B, Q, heads, C] and wsum [B, Q, heads]
// fp32, each written once. A half-warp per item: lane j places sample j
// of each group of 16 of the head's L x P (its corner weights, rows and
// attention weight, to shared memory), then the half-warp walks the
// samples in order, a lane's corner rows of its two packs (eight 16-byte
// loads for bf16) in flight before it uses them; a lane sums its packs
// of each sample per level in fp32, then the levels in order, as the
// plain version does. A spare half-warp of the last block repeats the
// last item and writes nothing.
// U: the samples whose corner rows a lane loads before it uses the
// first. MODE 0 is the kernel; chip_smoke times probes of what bounds it
// beside it (PERF.md): U 2 (more rows in flight: no faster), MODE 1
// loads the corner rows and skips the arithmetic (each row word still
// feeds the sums), MODE 2 does the arithmetic on rows it does not load.
template <typename T, int U = 1, int MODE = 0>
__global__ void __launch_bounds__(MX_NT, 2)
msda_kernel(const T* __restrict__ value, const float* __restrict__ loc,
            const float* __restrict__ attw,
            const __grid_constant__ MsdaExactArgs g,
            const __grid_constant__ Levels lv, float* __restrict__ sampled,
            float* __restrict__ wsum) {
  __shared__ float4 sCw[MX_ITEMS][16];
  __shared__ int4 sRow[MX_ITEMS][16];
  __shared__ float sA[MX_ITEMS][16];
  const int hw = threadIdx.x >> 4, j = threadIdx.x & 15;
  const long long items = (long long)g.B * g.Q * g.heads;
  const long long item = (long long)blockIdx.x * MX_ITEMS + hw;
  const long long bqh = item < items ? item : items - 1;
  const int packs = g.C / 8, S = g.L * g.P;
  const float* lq = loc + bqh * g.L * g.P * 2;
  const float* aq = attw + bqh * g.L * g.P;
  const T* vrow = value + bqh / ((long long)g.Q * g.heads) * g.T * g.C;
  float wsum_h = 0.f;
  for (int pk0 = 0; pk0 < packs; pk0 += 16 * MX_PACKS) {
    bool on[MX_PACKS];
    float acc[MX_PACKS][8], lacc[MX_PACKS][8];
#pragma unroll
    for (int i = 0; i < MX_PACKS; ++i) {
      on[i] = pk0 + j + 16 * i < packs;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = lacc[i][c] = 0.f;
    }
    float lw = 0.f;
    int p = 0;
    for (int s0 = 0; s0 < S; s0 += 16) {
      const int n = min(16, S - s0);
      __syncwarp();  // the previous group is read
      if (j < n) {
        const int s = s0 + j, l = s / g.P;
        float4 cw;
        int4 cr;
        msda_corners<T>(lq[2 * s], lq[2 * s + 1], lv.h[l], lv.w[l],
                        lv.start[l], cw, cr);
        sCw[hw][j] = cw;
        sRow[hw][j] = cr;
        sA[hw][j] = aq[s];
      }
      __syncwarp();
      for (int t = 0; t < n; t += U) {
        Row8<T> v[U][MX_PACKS][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = min(t + u, n - 1);
          const float4 w = sCw[hw][k];
          const int4 r = sRow[hw][k];
#pragma unroll
          for (int i = 0; i < MX_PACKS; ++i) {
            const T* vl = vrow + (pk0 + j + 16 * i) * 8;
            const bool ld = MODE != 2 && on[i] && t + u < n;
            if (ld) dfa_corners(vl, w, r, g.C, v[u][i]);
            else {
#pragma unroll
              for (int c = 0; c < 4; ++c) v[u][i][c].zero();
            }
            if (MODE == 2)  // rows the loads did not bring
#pragma unroll
              for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int q = 0; q < (int)(sizeof(T) / 2); ++q)
                  v[u][i][c].u[q] = make_uint4(r.x, r.y, r.z, r.w);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (t + u >= n) break;
          const float4 w = sCw[hw][t + u];
          const float a = sA[hw][t + u];
#pragma unroll
          for (int i = 0; i < MX_PACKS; ++i) {
            if (MODE == 1) {  // the loads alone
#pragma unroll
              for (int c = 0; c < 4; ++c)
                lacc[i][c] += __uint_as_float(v[u][i][c].u[0].x & 0x3f800000u);
              continue;
            }
            float smp[8], vx0[8], vx1[8];
            msda_bilinear<T>(smp, vx0, vx1, w, v[u][i]);
#pragma unroll
            for (int c = 0; c < 8; ++c)
              lacc[i][c] = __fadd_rn(lacc[i][c], __fmul_rn(smp[c], a));
          }
          // in-image bilinear mass (wx0 + wx1)(wy0 + wy1), sums in T
          const float mass = __fmul_rn(R<T>(__fadd_rn(w.x, w.y)),
                                       R<T>(__fadd_rn(w.z, w.w)));
          lw = __fadd_rn(lw, __fmul_rn(a, mass));
          if (++p == g.P) {  // a level ends
            p = 0;
#pragma unroll
            for (int i = 0; i < MX_PACKS; ++i)
#pragma unroll
              for (int c = 0; c < 8; ++c) {
                acc[i][c] = __fadd_rn(acc[i][c], lacc[i][c]);
                lacc[i][c] = 0.f;
              }
            wsum_h = pk0 ? wsum_h : __fadd_rn(wsum_h, lw);
            lw = 0.f;
          }
        }
      }
    }
    if (item < items) {
#pragma unroll
      for (int i = 0; i < MX_PACKS; ++i)
        if (on[i]) store8(sampled + bqh * g.C + (pk0 + j + 16 * i) * 8,
                          acc[i]);
    }
  }
  if (j == 0 && item < items) wsum[bqh] = wsum_h;
}

int msda_blocks(const MsdaExactArgs& g) {
  const long long items = (long long)g.B * g.Q * g.heads;
  return (int)((items + MX_ITEMS - 1) / MX_ITEMS);
}

bool msda_takes(const MsdaExactArgs& g, const Levels& lv, int threads) {
  return g.C % 8 == 0 && g.C >= 8 && g.heads >= 1 && g.heads <= 8 &&
         g.P >= 1 && g.L == lv.n && threads == MX_NT && g.B * g.Q >= 1;
}

// --------------------------------------------------- hybrid exact lane
// Kernel H2, msda_hybrid's exact correction lane. It replaces the exact
// lane of simpb_tpu/ops/sampling.py::msda_hybrid (:1132-1185) and its
// one-hot scatter back (:1189-1209). `sel` [B, Q, L] (uint8) marks the
// (camera row, query, level) entries the selection corrects. For each
// (row, query, head) item of a query with a marked level, it adds each
// marked level's exact sum, in level order, into H1's sampled [B, Q,
// heads, C] and wsum [B, Q, heads] (fp32) in place: the level's points'
// bilinear samples weighted by attention, summed in point order in fp32
// with msda_kernel's roundings (msda_corners, msda_bilinear; the same
// bits as msda_kernel's sums), and attention x in-image mass. Items with
// no marked level return at once: the windowed lane's sums stand.
// Bound: bytes, the corrected queries' rows of sampled and wsum read and
// written (16 KB a query at 8 heads x 256 channels) and each distinct
// corner row once. What sets its time on the card is the exact
// forward's: a corner row (512 bytes in bf16) loaded per sample and
// corner, then the sample's arithmetic, in series in each half-warp;
// with every row in L1 a frame call's work takes 9 % less, with the
// samples spread over the levels 55 % more (PERF.md §6). A
// persistent grid whose warps walk static shares of the marked items
// was tried first and lost: a warp's items run one after the other, so
// the warp with the most sets the time, where the hardware's block
// scheduler balances short blocks. So the grid stays a block a query
// (HX_NT / 16 items), each item a half-warp (a lane two packs of 8
// channels, one sample's corner rows in flight, msda_kernel's engine),
// and the item's chain is cut:
// - the level mask (its L bytes loaded at once) and sample j's location
//   and weight (lane j, the item's first 16 samples, before the mask is
//   known) go out together, one round trip; lane k then takes its
//   sample of the walk from lane l * P + p by a shuffle;
// - lane k places sample k's corner weights, its corner rows (-1 for a
//   corner of weight 0, which is not read) and attention x mass in the
//   half-warp's shared memory, so a sample costs the other lanes its
//   loads and its arithmetic only;
// - a block is one query's heads at 8 heads: 4 blocks an SM (bf16),
//   16 warps, and an empty query frees its block at once; fp32 runs 2
//   blocks an SM (its registers) without spilling.
// Each item owns its rows of sampled and wsum: no atomics, and repeats
// are bit-identical.
constexpr int HX_NT = 128;  // threads of an H2 block: 8 items
constexpr int HX_ITEMS = HX_NT / 16;

template <typename T>
__global__ void __launch_bounds__(HX_NT, sizeof(T) == 2 ? 4 : 2)
msda_hybrid_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                   const float* __restrict__ attw,
                   const unsigned char* __restrict__ sel,
                   const __grid_constant__ MsdaExactArgs g,
                   const __grid_constant__ Levels lv,
                   float* __restrict__ sampled, float* __restrict__ wsum) {
  __shared__ float4 sW[HX_ITEMS][16];  // a sample's corner weights
  __shared__ int4 sRow[HX_ITEMS][16];  // its corner rows (-1: not read)
  __shared__ float2 sA[HX_ITEMS][16];  // its attention, attention x mass
  const int hw = threadIdx.x >> 4, j = threadIdx.x & 15;
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  const long long items = (long long)g.B * g.Q * g.heads;
  const long long item = (long long)blockIdx.x * HX_ITEMS + hw;
  const long long bqh = item < items ? item : items - 1;
  const int LP = g.L * g.P, packs = g.C / 8;
  const float* lq = loc + bqh * LP * 2;
  const float* aq = attw + bqh * LP;
  const unsigned char* sq = sel + bqh / g.heads * g.L;
  unsigned marked = 0;
#pragma unroll
  for (int l = 0; l < MAX_LEVELS; ++l)
    if (l < g.L) marked |= (sq[l] ? 1u : 0u) << l;
  float x0 = 0.f, y0 = 0.f, a0 = 0.f;
  if (j < LP) {
    x0 = lq[2 * j];
    y0 = lq[2 * j + 1];
    a0 = aq[j];
  }
  const int S = __popc(marked) * g.P;  // the walk: marked levels' points
  if (!S) return;
  const T* vrow = value + bqh / ((long long)g.Q * g.heads) * g.T * g.C;
  float wsum_h = wsum[bqh];
  for (int pk0 = 0; pk0 < packs; pk0 += 16 * MX_PACKS) {
    bool on[MX_PACKS];
    float acc[MX_PACKS][8], lacc[MX_PACKS][8];
#pragma unroll
    for (int i = 0; i < MX_PACKS; ++i) {
      on[i] = pk0 + j + 16 * i < packs;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = lacc[i][c] = 0.f;
      if (on[i]) {
        const float4* src = reinterpret_cast<const float4*>(
            sampled + bqh * g.C + (pk0 + j + 16 * i) * 8);
        const float4 p0 = src[0], p1 = src[1];
        acc[i][0] = p0.x; acc[i][1] = p0.y; acc[i][2] = p0.z;
        acc[i][3] = p0.w; acc[i][4] = p1.x; acc[i][5] = p1.y;
        acc[i][6] = p1.z; acc[i][7] = p1.w;
      }
    }
    float lw = 0.f;
    int p = 0;
    for (int s0 = 0; s0 < S; s0 += 16) {
      // lane j's sample of the walk, s0 + j: its index s = l * P + p
      // among the item's samples, from lane s where s < 16
      const int k = s0 + j;
      int n = k / g.P, l = 0;  // the n-th marked level
      for (; l < g.L; ++l)
        if (((marked >> l) & 1u) && n-- == 0) break;
      const int s = l * g.P + k % g.P;
      float x = x0, y = y0, a = a0;
      if (LP <= 16) {
        x = __shfl_sync(half, x0, s, 16);
        y = __shfl_sync(half, y0, s, 16);
        a = __shfl_sync(half, a0, s, 16);
      } else if (k < S) {
        x = lq[2 * s];
        y = lq[2 * s + 1];
        a = aq[s];
      }
      __syncwarp(half);  // the previous group is read
      if (k < S) {
        float4 cw;
        int4 cr;
        msda_corners<T>(x, y, lv.h[l], lv.w[l], lv.start[l], cw, cr);
        sW[hw][j] = cw;
        sRow[hw][j] = make_int4(cw.z != 0.f && cw.x != 0.f ? cr.x : -1,
                                cw.z != 0.f && cw.y != 0.f ? cr.y : -1,
                                cw.w != 0.f && cw.x != 0.f ? cr.z : -1,
                                cw.w != 0.f && cw.y != 0.f ? cr.w : -1);
        // in-image bilinear mass (wx0 + wx1)(wy0 + wy1), sums in T
        const float mass = __fmul_rn(R<T>(__fadd_rn(cw.x, cw.y)),
                                     R<T>(__fadd_rn(cw.z, cw.w)));
        sA[hw][j] = make_float2(a, __fmul_rn(a, mass));
      }
      __syncwarp(half);
      const int ns = min(16, S - s0);
      for (int t = 0; t < ns; ++t) {
        const int4 r = sRow[hw][t];
        const int rr[4] = {r.x, r.y, r.z, r.w};
        Row8<T> v[MX_PACKS][4];
#pragma unroll
        for (int i = 0; i < MX_PACKS; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            v[i][c].zero();
            if (on[i] && rr[c] >= 0)
              v[i][c].load(vrow + (long long)rr[c] * g.C +
                           (pk0 + j + 16 * i) * 8);
          }
        const float4 w = sW[hw][t];
        const float2 am = sA[hw][t];
#pragma unroll
        for (int i = 0; i < MX_PACKS; ++i) {
          float smp[8], vx0[8], vx1[8];
          msda_bilinear<T>(smp, vx0, vx1, w, v[i]);
#pragma unroll
          for (int c = 0; c < 8; ++c)
            lacc[i][c] = __fadd_rn(lacc[i][c], __fmul_rn(smp[c], am.x));
        }
        lw = __fadd_rn(lw, am.y);
        if (++p == g.P) {  // a level ends
          p = 0;
#pragma unroll
          for (int i = 0; i < MX_PACKS; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              acc[i][c] = __fadd_rn(acc[i][c], lacc[i][c]);
              lacc[i][c] = 0.f;
            }
          wsum_h = pk0 ? wsum_h : __fadd_rn(wsum_h, lw);
          lw = 0.f;
        }
      }
    }
    if (item < items) {
#pragma unroll
      for (int i = 0; i < MX_PACKS; ++i)
        if (on[i]) store8(sampled + bqh * g.C + (pk0 + j + 16 * i) * 8,
                          acc[i]);
    }
  }
  if (j == 0 && item < items) wsum[bqh] = wsum_h;
}

template <typename T>
int launch_msda_hybrid(const void* value, const float* loc,
                       const float* attw, const unsigned char* sel,
                       float* sampled, float* wsum, const MsdaExactArgs& g,
                       const Levels& lv, int threads, cudaStream_t st) {
  if (!msda_takes(g, lv, MX_NT) || threads != HX_NT)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)g.B * g.Q * g.heads;
  msda_hybrid_kernel<T>
      <<<(int)((items + HX_ITEMS - 1) / HX_ITEMS), HX_NT, 0, st>>>(
          (const T*)value, loc, attw, sel, g, lv, sampled, wsum);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_msda(const void* value, const float* loc, const float* attw,
                float* sampled, float* wsum, const MsdaExactArgs& g,
                const Levels& lv, int threads, cudaStream_t st) {
  if (!msda_takes(g, lv, threads)) return (int)cudaErrorInvalidValue;
  msda_kernel<T><<<msda_blocks(g), MX_NT, 0, st>>>(
      (const T*)value, loc, attw, g, lv, sampled, wsum);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- clamp priority
// Kernel H3: msda_hybrid's clamp priority. It replaces
// simpb_tpu/ops/sampling.py::_lost_weights (:208-257) with the priority
// msda_hybrid makes of it (:1100-1108), the selection of the corrected
// entries (:1108-1120) and msda_clamp_demand's count (:1008-1029). Per
// (camera row, query, level) entry of loc [B, Q, heads, L, P, 2] (fp32):
// the level's window (shrink_patch's size, placed at the midrange of the
// entry's in-image samples as _window_base places it), each sample's lost
// bilinear weight (its corners inside the image but outside the window,
// the four in _lost_weights' order: x0 then x0 + 1, y0 then y0 + 1 within
// each), and
//   prio = sum(lost > 0 ? attw : 0) + 1e-6   if any sample loses weight,
//          0                                 else,
// fp32 (`clamp_entry`): a warp an entry, a lane a sample (heads x points
// <= 32); the window's min and max reduce with shuffles (exact in any
// order), and the sum is a fixed tree, lane l + 16 onto lane l, then + 8,
// + 4, + 2, + 1, read from lane 0, so that the plain version
// (ops/sampling.py::clamp_priority_plain) repeats it bit for bit: one ulp
// at the capacity's boundary would swap which entry the hybrid corrects.
// Two instances, a thread-block cluster of CS_CL blocks a camera row each
// (the row's selection needs all of its entries, and one block a row left
// 6 of 132 SMs to fetch the row's locations: latency-bound at 3x the
// time), block k taking the k-th slice of the row's queries, a warp a
// query, the next query's samples loaded before the current one's are
// used:
// - `clamp_select_kernel`, the op's: every entry's priority as a sort
//   key (the priority's bits made monotonic and inverted, then the
//   entry's index: ascending keys are descending priorities, the lower
//   index first among ties), stored into every block of the cluster
//   through distributed shared memory; an entry's rank is the number of
//   the row's keys below its own, and the entry at rank r is corrected iff
//   r < k_cap and its priority > 0: `_hybrid_selection`'s and
//   jax.lax.top_k's order. It writes the mask sel [B, Q, L] and the
//   windowed lane's weights attw_win = attw x (1 - sel) in attw's layout,
//   which H1 reads.
// - `clamp_demand_kernel`, the guards': the entries of the valid queries
//   with a sample that loses weight, counted in integers (order-free, so
//   the eager count's value) and added across the cluster in block 0,
//   written once as demand [B] float32.
// Both are bound by their latency: the row's loads (12 bytes a sample),
// the shuffle trees, the cluster's barriers and, for the op, the ranks'
// counting (Q x L keys an entry).
struct ClampArgs {
  int B, Q, heads, L, P, ph, pw;
};

// The clamp flag of this lane's sample of an entry at level l (`in`: the
// lane holds a sample, at location (lx, ly)): in the image and losing
// bilinear weight to the entry's window. A whole warp.
__device__ __forceinline__ bool clamp_entry(float lx, float ly, bool in,
                                            int l, const Levels& lv,
                                            int ph0, int pw0) {
  const int h = lv.h[l], w = lv.w[l];
  const int ph = min(ph0, h);  // shrink_patch: at most the level, even
  int pw = min(pw0, w);
  pw = max(2, pw - pw % 2);
  const float px = pix(lx, w), py = pix(ly, h);
  const bool keep =
      in && px > -1.f && px < (float)w && py > -1.f && py < (float)h;
  float mnx = keep ? px : 1e9f, mxx = keep ? px : -1e9f;
  float mny = keep ? py : 1e9f, mxy = keep ? py : -1e9f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mnx = fminf(mnx, __shfl_xor_sync(0xffffffffu, mnx, o));
    mxx = fmaxf(mxx, __shfl_xor_sync(0xffffffffu, mxx, o));
    mny = fminf(mny, __shfl_xor_sync(0xffffffffu, mny, o));
    mxy = fmaxf(mxy, __shfl_xor_sync(0xffffffffu, mxy, o));
  }
  const float midx = __fmul_rn(0.5f, __fadd_rn(mnx, mxx));
  const float midy = __fmul_rn(0.5f, __fadd_rn(mny, mxy));
  const int bx = min(max((int)rintf(__fsub_rn(midx, (pw - 1) / 2.0f)), 0),
                     w - pw);
  const int by = min(max((int)rintf(__fsub_rn(midy, (ph - 1) / 2.0f)), 0),
                     h - ph);
  const float x0f = floorf(px), y0f = floorf(py);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float fx = __fsub_rn(px, x0f), fy = __fsub_rn(py, y0f);
  float lost = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int cx = x0 + i;
    const float wx = i ? fx : __fsub_rn(1.f, fx);
    const bool in_x = cx >= 0 && cx <= w - 1;
    const bool out_x = cx < bx || cx > bx + pw - 1;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int cy = y0 + k;
      const float wy = k ? fy : __fsub_rn(1.f, fy);
      const bool in_y = cy >= 0 && cy <= h - 1;
      const bool out_y = cy < by || cy > by + ph - 1;
      const float c = in_x && in_y && (out_x || out_y) ? 1.f : 0.f;
      lost = __fadd_rn(lost, __fmul_rn(__fmul_rn(c, wx), wy));
    }
  }
  return in && __fmul_rn(lost, keep ? 1.f : 0.f) > 0.f;
}

constexpr int CS_NT = 512;  // threads of an H3 block: 16 warps
constexpr int CS_CL = 8;    // H3 blocks a camera row: one cluster
constexpr int CS_MAX_KEYS = 8192;  // a row's sort keys at most (64 KB)

// A warp's samples of query q of a row: lane i = h * P + p < n holds
// sample (h, p) of every level (x, y, weight); `a` may be NULL (weight 1).
struct ClampQuery {
  float x[MAX_LEVELS], y[MAX_LEVELS], a[MAX_LEVELS];
  __device__ __forceinline__ void load(const float* loc, const float* attw,
                                       const ClampArgs& g, long long bq,
                                       int lane) {
    const int hh = lane / g.P, pt = lane - hh * g.P;
#pragma unroll
    for (int l = 0; l < MAX_LEVELS; ++l) {
      x[l] = y[l] = a[l] = 0.f;
      if (l < g.L && lane < g.heads * g.P) {
        const long long s = ((bq * g.heads + hh) * g.L + l) * g.P + pt;
        x[l] = loc[2 * s];
        y[l] = loc[2 * s + 1];
        a[l] = attw ? attw[s] : 1.f;
      }
    }
  }
};

// Sort keys: the priority's bits made monotonic (NaN as the canonical
// NaN, above +inf, where torch.sort puts it; -0 as +0), inverted, then
// the entry's index: ascending keys are descending priorities, the lower
// index first among ties, and no two keys are equal.
__device__ __forceinline__ unsigned long long select_key(float p, int e) {
  uint32_t u = isnan(p) ? 0x7fc00000u : __float_as_uint(p == 0.f ? 0.f : p);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)~u << 32) | (uint32_t)e;
}
__device__ __forceinline__ float key_priority(unsigned long long k) {
  const uint32_t u = ~(uint32_t)(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// A block's slice of its camera row's queries: [qa, qb).
__device__ __forceinline__ void clamp_slice(const ClampArgs& g, unsigned k,
                                            int& qa, int& qb) {
  const int qs = (g.Q + CS_CL - 1) / CS_CL;
  qa = min(g.Q, (int)k * qs);
  qb = min(g.Q, qa + qs);
}

// The op's instance: a cluster of CS_CL blocks a camera row, block k
// taking the k-th slice of its queries. 1. A warp a query: its entries'
// keys, stored into every block of the cluster (each holds the row's Q x L
// keys), and the weights copied into attw_win. 2. Each of the slice's
// entries ranked by counting the row's keys below its own, a group of
// `te` neighbouring threads an entry, each an interleaved share of the
// keys, the shares added by shuffles (integers: any order); rank r is
// corrected iff r < k_cap and its priority > 0, its mask written once
// and its weights zeroed (attw x 0, after step 1's copy).
__global__ void __launch_bounds__(CS_NT)
clamp_select_kernel(const float* __restrict__ loc,
                    const float* __restrict__ attw, ClampArgs g, Levels lv,
                    int k_cap, unsigned char* __restrict__ sel,
                    float* __restrict__ attw_win) {
  extern __shared__ __align__(16) unsigned long long key[];  // [Q * L]
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = g.L, n = g.heads * g.P, QL = g.Q * L, nw = CS_NT / 32;
  const long long row = blockIdx.x / CS_CL, q0 = row * g.Q;
  int qa, qb;
  clamp_slice(g, cluster.block_rank(), qa, qb);
  ClampQuery cur, nxt;
  if (qa + warp < qb) cur.load(loc, attw, g, q0 + qa + warp, lane);
  cluster.sync();  // every block of the cluster runs: its keys may be set
  for (int q = qa + warp; q < qb; q += nw) {
    if (q + nw < qb) nxt.load(loc, attw, g, q0 + q + nw, lane);
#pragma unroll
    for (int l = 0; l < MAX_LEVELS; ++l) {
      if (l >= L) break;
      const bool flag = clamp_entry(cur.x[l], cur.y[l], lane < n, l, lv,
                                    g.ph, g.pw);
      float t = __fmul_rn(flag ? 1.f : 0.f, lane < n ? cur.a[l] : 0.f);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, o));
      const bool any = __any_sync(0xffffffffu, flag);
      // every lane holds lane 0's sum: the butterfly adds the same pairs
      if (lane < CS_CL)
        cluster.map_shared_rank(key, lane)[q * L + l] =
            select_key(any ? __fadd_rn(t, 1e-6f) : 0.f, q * L + l);
      if (lane < n) {
        const int hh = lane / g.P, pt = lane - hh * g.P;
        attw_win[(((q0 + q) * g.heads + hh) * L + l) * g.P + pt] =
            __fmul_rn(cur.a[l], 1.f);
      }
    }
    cur = nxt;
  }
  cluster.sync();  // every block holds the row's keys
  const int es = (qb - qa) * L, e0 = qa * L;
  int te = 1;  // threads an entry: a power of two, at most a warp
  while (te < 32 && 2 * te * es <= CS_NT) te <<= 1;
  for (int base = 0; base < es * te; base += CS_NT) {
    const int idx = base + tid, i = idx / te, c = idx - i * te;
    const bool has = i < es;
    const unsigned long long mine = has ? key[e0 + i] : 0ull;
    int below = 0;
    if (has)
      for (int j = c; j < QL; j += te) below += key[j] < mine;
    for (int o = te >> 1; o > 0; o >>= 1)
      below += __shfl_xor_sync(0xffffffffu, below, o);
    if (has && c == 0) {
      const bool taken = below < k_cap && key_priority(mine) > 0.f;
      const int e = e0 + i, q = e / L, l = e - q * L;
      sel[row * QL + e] = taken;
      if (taken) {
        for (int s = 0; s < n; ++s) {
          const int hh = s / g.P, pt = s - hh * g.P;
          const long long o =
              (((q0 + q) * g.heads + hh) * L + l) * g.P + pt;
          attw_win[o] = __fmul_rn(attw[o], 0.f);
        }
      }
    }
  }
}

// The guards' instance: a cluster of CS_CL blocks a camera row, block k
// counting the valid queries of the k-th slice (valid [B, Q] uint8, or
// NULL) with a clamped entry each, warp by warp, then block 0 adding the
// blocks' counts in rank order (integers) into demand [B] float32.
__global__ void __launch_bounds__(CS_NT)
clamp_demand_kernel(const float* __restrict__ loc,
                    const unsigned char* __restrict__ valid, ClampArgs g,
                    Levels lv, float* __restrict__ demand) {
  __shared__ int counts[CS_NT / 32], slices[CS_CL];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = g.heads * g.P, nw = CS_NT / 32;
  const unsigned k = cluster.block_rank();
  const long long row = blockIdx.x / CS_CL, q0 = row * g.Q;
  int qa, qb;
  clamp_slice(g, k, qa, qb);
  int count = 0;
  ClampQuery cur, nxt;
  if (qa + warp < qb) cur.load(loc, nullptr, g, q0 + qa + warp, lane);
  for (int q = qa + warp; q < qb; q += nw) {
    if (q + nw < qb) nxt.load(loc, nullptr, g, q0 + q + nw, lane);
    if (!valid || valid[q0 + q]) {
#pragma unroll
      for (int l = 0; l < MAX_LEVELS; ++l) {
        if (l >= g.L) break;
        count += __any_sync(0xffffffffu,
                            clamp_entry(cur.x[l], cur.y[l], lane < n, l, lv,
                                        g.ph, g.pw));
      }
    }
    cur = nxt;
  }
  if (lane == 0) counts[warp] = count;
  cluster.sync();  // block 0 runs; this block's counts are set
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < nw; ++w) total += counts[w];
    cluster.map_shared_rank(slices, 0)[k] = total;
  }
  cluster.sync();
  if (k == 0 && tid == 0) {
    int total = 0;
    for (int r = 0; r < CS_CL; ++r) total += slices[r];
    demand[row] = (float)total;
  }
}

bool clamp_takes(const ClampArgs& g, const Levels& lv, int threads) {
  return threads == CS_NT && g.heads >= 1 && g.P >= 1 &&
         g.heads * g.P <= 32 && g.L == lv.n && g.L <= MAX_LEVELS &&
         g.ph >= 1 && g.pw >= 1 && g.B >= 1 && g.Q >= 1;
}

// One H3 launch: B clusters of CS_CL blocks (the arguments take the
// kernel's parameter types).
template <typename T> struct Same { typedef T type; };
template <typename... Args>
int launch_clusters(void (*kernel)(Args...), int rows, int smem,
                    cudaStream_t st, typename Same<Args>::type... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS_CL * rows);
  cfg.blockDim = dim3(CS_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = CS_CL;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  return err ? err : (int)cudaGetLastError();
}

int launch_clamp_select(const float* loc, const float* attw,
                        unsigned char* sel, float* attw_win,
                        const ClampArgs& g, const Levels& lv, int k_cap,
                        int threads, int smem, cudaStream_t st) {
  const int ql = g.Q * g.L;
  if (!clamp_takes(g, lv, threads) || ql > CS_MAX_KEYS || ql * 8 > smem ||
      k_cap < 0 || k_cap > ql)
    return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // the attribute only grows (one card)
  if (smem > smem_set) {
    cudaFuncSetAttribute(clamp_select_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set = smem;
  }
  return launch_clusters(clamp_select_kernel, g.B, smem, st, loc, attw, g,
                         lv, k_cap, sel, attw_win);
}

int launch_clamp_demand(const float* loc, const unsigned char* valid,
                        float* demand, const ClampArgs& g, const Levels& lv,
                        int threads, cudaStream_t st) {
  if (!clamp_takes(g, lv, threads)) return (int)cudaErrorInvalidValue;
  return launch_clusters(clamp_demand_kernel, g.B, 0, st, loc, valid, g, lv,
                         demand);
}

// ------------------------------------------------- exact MSDA backward
// Kernel D: the gradients of msda_kernel's (sampled [B, Q, heads, C],
// wsum [B, Q, heads]) to the value, to the locations (through the corner
// weights: d x / d loc = the level's width, d y / d loc its height; a
// corner off the level has a masked weight, whose derivative is 0, so
// the location gradient is one-sided at a border) and to the attention
// weights (the sample dotted with g_sampled[q, h], plus g_wsum[q, h]
// times the in-image mass). It replaces the gradient of
// simpb_tpu/ops/sampling.py::msda (:611; XLA's autodiff of gathers under
// jax.checkpoint on the TPU). No atomics: every output element has one
// owner, sums in a fixed order and is written once, so repeat launches
// are bit-identical.
//
// D1, `msda_bwd_kernel`: the forward's items (a half-warp per camera
// row, query and head). Lane j places sample j of each group of 16 (its
// corner weights, rounded as the forward rounds them, its corner rows
// and which corners lie on the level), and the half-warp walks the
// samples in order: a lane reads the four corners of its packs (a
// corner off the level reads as 0, a corner on it is read even where its
// weight rounds to 0, since the location gradient needs it) and dots
// g_sampled (read once an item) with them in fp32: with the four corner
// rows (the x derivatives, and for fp32 values everything: the sample
// and the y pairs are bilinear in them), and for bf16 values also with
// the sample and the two x pairs as the forward rounds them. Shuffles
// add the half-warp's lanes in a fixed order, and the sample's lane
// writes its location and weight gradients once. It recomputes the
// samples from the inputs (the autograd Function saves only them) and
// writes each sample's record at its natural index (q * heads + h) * P
// + p of its (camera row, level) list: the four corner weights times the
// attention weight, and the corner base (x0 + 1) | (y0 + 1) << 16, or -1
// when no corner weighs.
//
// The bin pass (`msda_bin_kernel` twice, `msda_bin_scan_kernel` between)
// lists each (camera row, level)'s records under the 8x8 pixel tiles
// that own their weighing corners (up to four tiles a record, once a
// tile), each list in record order. A warp takes a segment of a level's
// records, eight a step with a lane a (record, corner), so that lane
// order is record order; __match_any_sync finds the lanes of one tile,
// and the lowest of them bumps the segment's counter of that tile
// (shared memory, or the count array when a level has too many tiles).
// Counting first, then an exclusive scan of the counts by (tile,
// segment), then the same walk writing each record at its tile's running
// offset: the lists come out in record order with no atomics.
//
// D2: the value gradient, owner computes: a tile's 64 value rows over
// 256 channels are summed by one block (or one cluster) and written once
// in the value's type, zeros included, each sum in list order in fp32
// (fused multiply-adds of g_sampled[q, h, c] and the corner weight).
// `msda_bwd_gvalue_kernel` takes the tiles whose lists fit a chunk (the
// plan's, D_CHUNK records): warp y its pixel row y, a lane 8 channels of
// its 8 pixels in registers, adding the records with a corner in its
// row. `msda_bwd_gsplit_kernel` takes the crowded ones: a thread-block
// cluster of D2_CLUSTER blocks, block k summing the k-th of D2_CLUSTER
// equal runs of the list, two channels a thread with the tile's 64
// pixels in shared memory (so that no warp idles when the corners crowd
// into one row: every level's tile (0, 0) holds every padded slot's
// samples, on pixel (0, 0), and the small levels' few tiles hold every
// sample's); block k then adds the blocks' sums of its 4 pixels in chunk
// order through distributed shared memory and writes them. The two run
// side by side on two streams (disjoint rows of the value gradient).
//
// What bounds it (PERF.md): D1 its operations (the dots of g with four
// corner rows and, for bf16 values, the rounded sample and x pairs, a
// sample and channel); D2 its operations and the g_sampled row it reads
// for each record of a tile: in registers by rows where the corners
// spread over the rows, in shared memory where they crowd (there every
// corner's read and write of 256 sums through shared memory sets the
// time); the bin pass a few bytes a record. A scatter of the value
// gradient by D1's items (fp32 atomicAdd onto rows that neighbouring
// queries share) would contend and sum in a different order on every
// run, into an fp32 copy of the value; D2's owners do neither and write
// its type directly.
template <typename T>
__global__ void __launch_bounds__(MX_NT, 2)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attw,
                const float* __restrict__ gsamp,
                const float* __restrict__ gwsum,
                const __grid_constant__ MsdaExactArgs g,
                const __grid_constant__ Levels lv, float* __restrict__ gloc,
                float* __restrict__ gattw, float4* __restrict__ rwk,
                int* __restrict__ rpos) {
  constexpr int U = 1;  // samples whose corner rows a lane loads together
  __shared__ float4 sCw[MX_ITEMS][16];
  __shared__ int4 sRow[MX_ITEMS][16];
  __shared__ int sM[MX_ITEMS][16];
  const int hw = threadIdx.x >> 4, j = threadIdx.x & 15;
  const long long items = (long long)g.B * g.Q * g.heads;
  const long long item = (long long)blockIdx.x * MX_ITEMS + hw;
  const long long bqh = item < items ? item : items - 1;
  const long long qh = (long long)g.Q * g.heads, row = bqh / qh;
  const int S = g.L * g.P, packs = g.C / 8;
  const float* lq = loc + bqh * S * 2;
  const float* aq = attw + bqh * S;
  const float* gq = gsamp + bqh * g.C;
  const T* vrow = value + row * g.T * g.C;
  const float gw = gwsum[bqh];
  // records: N a (camera row, level), this head's from its natural index
  const long long N = qh * g.P;
  const long long rbase = row * g.L * N + bqh % qh * g.P;
  for (int s0 = 0; s0 < S; s0 += 16) {
    const int s = s0 + j, n = min(16, S - s0);
    float4 cw = make_float4(0.f, 0.f, 0.f, 0.f);
    int4 cr = make_int4(0, 0, 0, 0);
    float a = 0.f, x0f = 0.f, y0f = 0.f;
    int m = 0;  // bit k: corner k = 2 dy + dx on the level; 4-7: mx0..my1
    if (j < n) {
      const int l = s / g.P, h = lv.h[l], w = lv.w[l];
      a = aq[s];
      msda_corners<T>(lq[2 * s], lq[2 * s + 1], h, w, lv.start[l], cw, cr);
      x0f = floorf(pix(lq[2 * s], w));
      y0f = floorf(pix(lq[2 * s + 1], h));
      const int mx0 = x0f >= 0.f && x0f < (float)w;
      const int mx1 = x0f >= -1.f && x0f < (float)(w - 1);
      const int my0 = y0f >= 0.f && y0f < (float)h;
      const int my1 = y0f >= -1.f && y0f < (float)(h - 1);
      m = (mx0 & my0) | (mx1 & my0) << 1 | (mx0 & my1) << 2 |
          (mx1 & my1) << 3 | mx0 << 4 | mx1 << 5 | my0 << 6 | my1 << 7;
    }
    __syncwarp();  // the previous group is read
    sCw[hw][j] = cw;
    sRow[hw][j] = cr;
    sM[hw][j] = m;
    __syncwarp();
    // this lane's sample: g.smp, then the derivatives to wx0, wx1, wy0,
    // wy1 of g.smp, all before the attention weight
    float mine[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int pk0 = 0; pk0 < packs; pk0 += 16 * MX_PACKS) {
      bool on[MX_PACKS];
      float gs[MX_PACKS][8];
#pragma unroll
      for (int i = 0; i < MX_PACKS; ++i) {
        const int pk = pk0 + j + 16 * i;
        on[i] = pk < packs;
        const float4 g0 = on[i] ? *reinterpret_cast<const float4*>(gq + pk * 8)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 g1 = on[i]
                              ? *reinterpret_cast<const float4*>(gq + pk * 8 + 4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        gs[i][0] = g0.x; gs[i][1] = g0.y; gs[i][2] = g0.z; gs[i][3] = g0.w;
        gs[i][4] = g1.x; gs[i][5] = g1.y; gs[i][6] = g1.z; gs[i][7] = g1.w;
      }
      for (int t = 0; t < n; t += U) {
        Row8<T> v[U][MX_PACKS][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = min(t + u, n - 1);
          const int4 r = sRow[hw][k];
          const int rr[4] = {r.x, r.y, r.z, r.w};
          const int mk = t + u < n ? sM[hw][k] : 0;
#pragma unroll
          for (int i = 0; i < MX_PACKS; ++i) {
            const T* vl = vrow + (pk0 + j + 16 * i) * 8;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              v[u][i][c].zero();
              if (on[i] && (mk >> c) & 1)
                v[u][i][c].load(vl + (long long)rr[c] * g.C);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (t + u >= n) break;
          if constexpr (sizeof(T) == 4) {
            // fp32: the four corner rows dotted with g; the five sums
            // follow from them and the corner weights once reduced
            float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < MX_PACKS; ++i)
#pragma unroll
              for (int c = 0; c < 8; ++c)
#pragma unroll
                for (int k = 0; k < 4; ++k) d[k] += gs[i][c] * v[u][i][k][c];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
#pragma unroll
              for (int o = 8; o; o >>= 1)
                d[k] += __shfl_xor_sync(0xffffffffu, d[k], o);
              if (j == t + u) mine[k] += d[k];
            }
          } else {
            // bf16: the sample and the x pairs round to bf16, so g.smp
            // and the y derivatives sum per channel; the x derivatives
            // follow from the four corner dots
            const float4 w = sCw[hw][t + u];
            float part[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < MX_PACKS; ++i) {
              float smp[8], vx0[8], vx1[8];
              msda_bilinear<T>(smp, vx0, vx1, w, v[u][i]);
#pragma unroll
              for (int c = 0; c < 8; ++c) {
                part[0] += gs[i][c] * smp[c];
                part[1] += gs[i][c] * vx0[c];
                part[2] += gs[i][c] * vx1[c];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  part[3 + k] += gs[i][c] * v[u][i][k][c];
              }
            }
#pragma unroll
            for (int k = 0; k < 7; ++k) {
#pragma unroll
              for (int o = 8; o; o >>= 1)
                part[k] += __shfl_xor_sync(0xffffffffu, part[k], o);
            }
            if (j == t + u) {
              mine[0] += part[0];
              mine[1] += w.z * part[3] + w.w * part[5];
              mine[2] += w.z * part[4] + w.w * part[6];
              mine[3] += part[1];
              mine[4] += part[2];
            }
          }
        }
      }
    }
    if (j >= n || item >= items) continue;
    if constexpr (sizeof(T) == 4) {
      // d00, d01, d10, d11 (corners x0y0, x1y0, x0y1, x1y1) to the sums
      const float d00 = mine[0], d01 = mine[1], d10 = mine[2], d11 = mine[3];
      mine[3] = cw.x * d00 + cw.y * d01;
      mine[4] = cw.x * d10 + cw.y * d11;
      mine[1] = cw.z * d00 + cw.w * d10;
      mine[2] = cw.z * d01 + cw.w * d11;
      mine[0] = cw.z * mine[3] + cw.w * mine[4];
    }
    const int l = s / g.P, p = s % g.P;
    const float sx = R<T>(__fadd_rn(cw.x, cw.y));
    const float sy = R<T>(__fadd_rn(cw.z, cw.w));
    gattw[bqh * S + s] = mine[0] + gw * __fmul_rn(sx, sy);
    // d wsum / d wx = a (wy0 + wy1), d wsum / d wy = a (wx0 + wx1)
    const float ga = gw * a;
    const float dx0 = a * mine[1] + ga * sy, dx1 = a * mine[2] + ga * sy;
    const float dy0 = a * mine[3] + ga * sx, dy1 = a * mine[4] + ga * sx;
    // wx0 = (1 - fx) mx0, wx1 = fx mx1: d / d fx = mx1 dx1 - mx0 dx0
    const float gx = ((m >> 5) & 1 ? dx1 : 0.f) - ((m >> 4) & 1 ? dx0 : 0.f);
    const float gy = ((m >> 7) & 1 ? dy1 : 0.f) - ((m >> 6) & 1 ? dy0 : 0.f);
    gloc[(bqh * S + s) * 2] = gx * (float)lv.w[l];
    gloc[(bqh * S + s) * 2 + 1] = gy * (float)lv.h[l];
    const float az = __fmul_rn(a, cw.z), aw = __fmul_rn(a, cw.w);
    const float4 wk = make_float4(__fmul_rn(az, cw.x), __fmul_rn(az, cw.y),
                                  __fmul_rn(aw, cw.x), __fmul_rn(aw, cw.y));
    const long long ri = rbase + l * N + p;
    rwk[ri] = wk;
    // a weighing corner puts x0 in [-1, w - 1] and y0 in [-1, h - 1]
    const bool live = wk.x != 0.f || wk.y != 0.f || wk.z != 0.f ||
                      wk.w != 0.f;
    rpos[ri] = live ? ((int)x0f + 1) | ((int)y0f + 1) << 16 : -1;
  }
}

// The bin pass's and D2's scratch (see simpb_msda_bwd) and plan.
constexpr int TILE = 8;          // a D2 tile's side (pixels)
constexpr int BIN_WARPS = 4;     // segments a bin block, a warp each
constexpr int BIN_RUN = 8;       // steps of 8 records a lane loads at once
constexpr int D2_CLUSTER = 16;   // blocks that share a crowded tile
constexpr int D2_NT = 32 * TILE;  // D2's threads: a warp a tile row
constexpr int D2_RUN = 4;         // records whose g rows a warp loads at once
constexpr int D2_NT2 = 128;       // the split's threads: two channels each
constexpr int D2_STAGE2 = 256;    // records the split stages at a time
constexpr int D2_RUN2 = 16;       // records whose g values it loads at once
struct MsdaBin {
  const float4* rwk;  // D1's records [rows][L][N]: corner weights
  const int* rpos;    // and corner bases
  unsigned* cnt;     // [rows][tiles][nseg]: counts, then running offsets
  unsigned* tstart;  // [rows][tiles]: a tile's start in its level's list
  unsigned* tcnt;    // [rows][tiles]: its length
  int* list;    // [rows][L][4N]: record indices, by tile, in record order
  int N, tiles, nseg, seg, chunk, smem_tiles;
  int first[MAX_LEVELS];  // each level's first tile (smallest level first)
};

// FILL false: count each tile's records in the warp's segment; true:
// write each at its tile's running offset (the scan's).
template <bool FILL>
__global__ void __launch_bounds__(32 * BIN_WARPS)
msda_bin_kernel(const __grid_constant__ MsdaExactArgs g,
                const __grid_constant__ Levels lv,
                const __grid_constant__ MsdaBin b) {
  extern __shared__ unsigned bin_smem[];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int seg = blockIdx.x * BIN_WARPS + wp, l = blockIdx.y,
            row = blockIdx.z;
  if (seg >= b.nseg) return;
  const int ntx = (lv.w[l] + TILE - 1) / TILE;
  const int nt = ntx * ((lv.h[l] + TILE - 1) / TILE);
  const long long rl = ((long long)row * g.L + l) * b.N;
  // the segment's column of the counts, a tile every nseg words
  unsigned* col =
      b.cnt + ((long long)row * b.tiles + b.first[l]) * b.nseg + seg;
  unsigned* ctr = b.smem_tiles ? bin_smem + wp * b.smem_tiles : col;
  const long long st = b.smem_tiles ? 1 : b.nseg;
  if (b.smem_tiles || !FILL)
    for (int t = lane; t < nt; t += 32)
      ctr[t * st] = FILL ? col[(long long)t * b.nseg] : 0;
  __syncwarp();
  int* lst = b.list + 4 * rl;  // the level's list
  const int k = lane & 3;
  const unsigned below = (1u << lane) - 1;
  const int end = min(b.N, (seg + 1) * b.seg);
  for (int r0 = seg * b.seg; r0 < end; r0 += 8 * BIN_RUN) {
    int pos[BIN_RUN];
    float wkk[BIN_RUN];
#pragma unroll
    for (int v = 0; v < BIN_RUN; ++v) {
      const int r = r0 + 8 * v + (lane >> 2);
      pos[v] = r < end ? b.rpos[rl + r] : -1;
      wkk[v] = r < end ? reinterpret_cast<const float*>(b.rwk + rl + r)[k]
                       : 0.f;
    }
#pragma unroll
    for (int v = 0; v < BIN_RUN; ++v) {
      const int r = r0 + 8 * v + (lane >> 2);
      int key0 = -1;  // the tile of this lane's corner k = 2 dy + dx
      if (pos[v] >= 0 && wkk[v] != 0.f) {
        const int px = (pos[v] & 0xffff) - 1 + (k & 1);
        const int py = (pos[v] >> 16) - 1 + (k >> 1);
        key0 = py / TILE * ntx + px / TILE;
      }
      // a tile that an earlier corner of the record holds lists it once
      int key = key0;
#pragma unroll
      for (int d = 1; d < 4; ++d) {
        const int other = __shfl_up_sync(0xffffffffu, key0, d);
        if (k >= d && other == key0) key = -1;
      }
      const unsigned mm = __match_any_sync(0xffffffffu, key);
      const int rank = __popc(mm & below);
      if (FILL && key >= 0) lst[ctr[key * st] + rank] = r;
      __syncwarp();
      if (key >= 0 && rank == 0) ctr[key * st] += (unsigned)__popc(mm);
      __syncwarp();
    }
  }
  if (!FILL && b.smem_tiles)
    for (int t = lane; t < nt; t += 32) col[(long long)t * b.nseg] = ctr[t];
}

// One block per (level, camera row): the level's counts by (tile,
// segment) to exclusive offsets in its list (below 4N), and each of its
// tiles' start and length.
__global__ void __launch_bounds__(1024)
msda_bin_scan_kernel(const __grid_constant__ Levels lv,
                     const __grid_constant__ MsdaBin b) {
  __shared__ unsigned warp_sum[32];
  const int l = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  const int nt = (lv.h[l] + TILE - 1) / TILE * ((lv.w[l] + TILE - 1) / TILE);
  unsigned* c = b.cnt + ((long long)row * b.tiles + b.first[l]) * b.nseg;
  const int E = nt * b.nseg;
  unsigned total = 0;  // 1024 counts a pass, neighbours on neighbours
  for (int e0 = 0; e0 < E; e0 += 1024) {
    const int e = e0 + tid;
    const unsigned v = e < E ? c[e] : 0u;
    unsigned tot;
    const unsigned at = total + block_scan(v, warp_sum, tot) - v;
    if (e < E) c[e] = at;
    total += tot;
    __syncthreads();  // warp_sum is rewritten by the next pass
  }
  unsigned* ts = b.tstart + (long long)row * b.tiles + b.first[l];
  unsigned* tc = b.tcnt + (long long)row * b.tiles + b.first[l];
  for (int t = tid; t < nt; t += 1024) {
    const unsigned s = c[t * b.nseg];
    const unsigned e = t + 1 < nt ? c[(t + 1) * b.nseg] : total;
    ts[t] = s;
    tc[t] = e - s;
  }
}

// Tile t of a camera row: its level and corner.
__device__ __forceinline__ int d2_tile(const Levels& lv, const MsdaBin& b,
                                       int t, int& tx0, int& ty0) {
  int l = 0;
  for (; l < lv.n; ++l) {
    const int n = (lv.h[l] + TILE - 1) / TILE * ((lv.w[l] + TILE - 1) / TILE);
    if (t >= b.first[l] && t < b.first[l] + n) break;
  }
  const int ntx = (lv.w[l] + TILE - 1) / TILE;
  tx0 = (t - b.first[l]) % ntx * TILE;
  ty0 = (t - b.first[l]) / ntx * TILE;
  return l;
}

// Two fp32 sums stored as T.
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// D2 over the tiles that fit a chunk: block x is tile lo + x of camera
// row y, channel slice z of 256 (a crowded tile is left to
// msda_bwd_gsplit_kernel). Warp y owns the tile's pixel row y, lane i
// channels 8i..8i+7 of the slice: 8 pixels x 8 channels of sums in
// registers. The block stages its list D2_NT records at a time (each
// record's corner base in the tile's frame, its four corner weights and
// its row of g); each warp lists, by ballot, the staged records with a
// corner in its row, in list order, and adds g x corner weight for their
// one or two corners in the row, the g rows of D2_RUN records loaded
// together.
template <typename T>
__global__ void __launch_bounds__(D2_NT, 2)
msda_bwd_gvalue_kernel(const float* __restrict__ gsamp,
                       const __grid_constant__ MsdaExactArgs g,
                       const __grid_constant__ Levels lv,
                       const __grid_constant__ MsdaBin b, int lo,
                       T* __restrict__ gvalue) {
  __shared__ int sPos[D2_NT], sG[D2_NT];
  __shared__ float4 sWk[D2_NT];
  __shared__ uint16_t wl[TILE][D2_NT];  // each warp's records
  const int tid = threadIdx.x, lane = tid & 31, yy = tid >> 5;
  const int row = blockIdx.y, c0 = blockIdx.z * 256 + lane * 8;
  const bool chans = c0 < g.C;
  const float* gb = gsamp + (long long)row * g.Q * g.heads * g.C + c0;
  const int tile = lo + blockIdx.x;
  const unsigned n = b.tcnt[(long long)row * b.tiles + tile];
  if (n > (unsigned)b.chunk) return;
  const unsigned e0 = b.tstart[(long long)row * b.tiles + tile];
  int tx0, ty0;
  const int l = d2_tile(lv, b, tile, tx0, ty0);
  const long long rl = ((long long)row * g.L + l) * b.N;
  const int* lst = b.list + 4 * rl;  // the level's list
  float acc[TILE][8];
#pragma unroll
  for (int p = 0; p < TILE; ++p)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[p][c] = 0.f;
  for (unsigned s0 = e0; s0 < e0 + n; s0 += D2_NT) {
    const int m = (int)min((unsigned)D2_NT, e0 + n - s0);
    __syncthreads();  // the previous stage is read
    if (tid < m) {
      const int r = lst[s0 + tid], q = b.rpos[rl + r];
      sPos[tid] = ((q & 0xffff) - tx0) | ((q >> 16) - ty0) << 8;
      sWk[tid] = b.rwk[rl + r];
      sG[tid] = r / g.P;
    }
    __syncthreads();
    // this warp's records: a corner in tile row yy
    int cnt = 0;
    for (int b0 = 0; b0 < m; b0 += 32) {
      const int i = b0 + lane;
      const int y0 = i < m ? (sPos[i] >> 8) - 1 : -9;
      const bool mine = y0 == yy || y0 + 1 == yy;
      const unsigned bal = __ballot_sync(0xffffffffu, mine);
      if (mine) wl[yy][cnt + __popc(bal & ((1u << lane) - 1))] = i;
      cnt += __popc(bal);
    }
    __syncwarp();
    for (int j0 = 0; j0 < cnt; j0 += D2_RUN) {
      float4 gr[D2_RUN][2];
#pragma unroll
      for (int u = 0; u < D2_RUN; ++u)
        if (j0 + u < cnt && chans) {
          const float4* q = reinterpret_cast<const float4*>(
              gb + (long long)sG[wl[yy][j0 + u]] * g.C);
          gr[u][0] = q[0];
          gr[u][1] = q[1];
        } else {
          gr[u][0] = gr[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int u = 0; u < D2_RUN; ++u) {
        if (j0 + u >= cnt) break;
        const int e = wl[yy][j0 + u], pe = sPos[e];
        const int x0 = (pe & 0xff) - 1, dy = yy - ((pe >> 8) - 1);
        const float4 w4 = sWk[e];
        const float wa = dy ? w4.z : w4.x, wb = dy ? w4.w : w4.y;
        const float gv[8] = {gr[u][0].x, gr[u][0].y, gr[u][0].z, gr[u][0].w,
                             gr[u][1].x, gr[u][1].y, gr[u][1].z, gr[u][1].w};
        // corner (x0, weight wa) and (x0 + 1, weight wb) of the row
        auto add = [&](float (&a)[8], float wc) {
          if (wc != 0.f)
#pragma unroll
            for (int c = 0; c < 8; ++c) a[c] = fmaf(gv[c], wc, a[c]);
        };
        switch (x0) {
          case -1: add(acc[0], wb); break;
          case 0: add(acc[0], wa); add(acc[1], wb); break;
          case 1: add(acc[1], wa); add(acc[2], wb); break;
          case 2: add(acc[2], wa); add(acc[3], wb); break;
          case 3: add(acc[3], wa); add(acc[4], wb); break;
          case 4: add(acc[4], wa); add(acc[5], wb); break;
          case 5: add(acc[5], wa); add(acc[6], wb); break;
          case 6: add(acc[6], wa); add(acc[7], wb); break;
          case 7: add(acc[7], wa); break;
        }
      }
    }
  }
  // the warp's tile row, 8 pixels x 8 channels a lane
  const int y = ty0 + yy, h = lv.h[l], w = lv.w[l];
  if (y >= h || !chans) return;
  T* out = gvalue + ((long long)row * g.T + lv.start[l] + (long long)y * w) *
                        g.C + c0;
#pragma unroll
  for (int p = 0; p < TILE; ++p)
    if (tx0 + p < w) store8(out + (long long)(tx0 + p) * g.C, acc[p]);
}

// Entries [e0, e1) of a crowded tile's list (level l, corner (tx0, ty0))
// into this thread's column of the block's sums acc [64 pixels]
// [blockDim] (two channels a thread), in list order. The block stages
// each record's weighing corners in the tile, in corner order: their
// number and pixels packed in one word (3 + 4 x 6 bits) and their
// weights first in a float4. A record's corners lie on distinct pixels,
// so their sums load together, add and store; a run of records that
// weigh one and the same pixel (padded slots) adds in registers (`cur`,
// pixel `cp`). The g values of the next D2_RUN2 records load while the
// current ones add.
__device__ __forceinline__ void d2_sum(float2* acc, const MsdaExactArgs& g,
                                       const MsdaBin& b, int row, int l,
                                       int tx0, int ty0, unsigned e0,
                                       unsigned e1, const float* gsr,
                                       bool has) {
  __shared__ int sPix[D2_STAGE2], sG[D2_STAGE2];
  __shared__ float4 sWk[D2_STAGE2];
  const int t = threadIdx.x, nt = blockDim.x;
  const long long rl = ((long long)row * g.L + l) * b.N;
  const int* lst = b.list + 4 * rl;  // the level's list
  const float2 zero = make_float2(0.f, 0.f);
  auto fma2 = [](float2 a, float2 v, float w) {
    return make_float2(fmaf(v.x, w, a.x), fmaf(v.y, w, a.y));
  };
  float2 cur = zero;
  int cp = -1;
  auto load = [&](float2 (&gv)[D2_RUN2], int i0, int m) {
#pragma unroll
    for (int u = 0; u < D2_RUN2; ++u)
      gv[u] = has && i0 + u < m
                  ? *reinterpret_cast<const float2*>(
                        gsr + (long long)sG[i0 + u] * g.C)
                  : zero;
  };
  auto add = [&](const float2 (&gv)[D2_RUN2], int i0, int m) {
#pragma unroll
    for (int u = 0; u < D2_RUN2; ++u) {
      if (i0 + u >= m) break;
      const int pix = sPix[i0 + u], n = pix & 7;
      const float4 w = sWk[i0 + u];
      const int p0 = pix >> 3 & 63;
      if (n == 1 && p0 == cp) {
        cur = fma2(cur, gv[u], w.x);
        continue;
      }
      if (cp >= 0) acc[cp * nt + t] = cur;
      if (n == 1) {
        cur = fma2(acc[p0 * nt + t], gv[u], w.x);
        cp = p0;
        continue;
      }
      cp = -1;
      const int p1 = pix >> 9 & 63;
      const int p2 = n > 2 ? pix >> 15 & 63 : p1;
      const int p3 = n > 3 ? pix >> 21 & 63 : p1;
      const float2 v0 = fma2(acc[p0 * nt + t], gv[u], w.x);
      const float2 v1 = fma2(acc[p1 * nt + t], gv[u], w.y);
      const float2 v2 = fma2(acc[p2 * nt + t], gv[u], w.z);
      const float2 v3 = fma2(acc[p3 * nt + t], gv[u], w.w);
      acc[p0 * nt + t] = v0;
      acc[p1 * nt + t] = v1;
      if (n > 2) acc[p2 * nt + t] = v2;
      if (n > 3) acc[p3 * nt + t] = v3;
    }
  };
  for (unsigned s0 = e0; s0 < e1; s0 += D2_STAGE2) {
    const int m = (int)min((unsigned)D2_STAGE2, e1 - s0);
    __syncthreads();  // the previous stage is read
    for (int i = t; i < m; i += nt) {
      const int r = lst[s0 + i], q = b.rpos[rl + r];
      const float4 wk = b.rwk[rl + r];
      const float wc[4] = {wk.x, wk.y, wk.z, wk.w};
      const int dx = (q & 0xffff) - 1 - tx0, dy = (q >> 16) - 1 - ty0;
      int pix = 0;
      float wv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = dx + (k & 1), y = dy + (k >> 1);
        if (x >= 0 && x < TILE && y >= 0 && y < TILE && wc[k] != 0.f) {
          const int c = pix & 7;
          pix = (pix & ~7) | (y * TILE + x) << (3 + 6 * c) | (c + 1);
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (v == c) wv[v] = wc[k];
        }
      }
      sPix[i] = pix;
      sG[i] = r / g.P;
      sWk[i] = make_float4(wv[0], wv[1], wv[2], wv[3]);
    }
    __syncthreads();
    float2 ga[D2_RUN2], gb[D2_RUN2];
    load(ga, 0, m);
    for (int i0 = 0; i0 < m; i0 += 2 * D2_RUN2) {
      load(gb, i0 + D2_RUN2, m);
      add(ga, i0, m);
      load(ga, i0 + 2 * D2_RUN2, m);
      add(gb, i0 + D2_RUN2, m);
    }
  }
  if (cp >= 0) acc[cp * nt + t] = cur;
}

// D2 over the crowded tiles (lists longer than a chunk): cluster x /
// D2_CLUSTER of camera row y takes the crowded ones among tiles lo + x /
// D2_CLUSTER, lo + x / D2_CLUSTER + gridDim.x / D2_CLUSTER, ... below hi
// (the crowded tiles, the small levels' and every level's tile (0, 0),
// fall to different clusters), block x % D2_CLUSTER summing its equal
// run of the list, channel slice
// z of 256, two channels a thread, the 64 pixels' sums in shared memory,
// so that no warp idles however the corners fall (padded slots put all
// of theirs on pixel (0, 0), so in one row). Then block k adds the
// cluster's sums of its 4 pixels in chunk order through distributed
// shared memory and writes them.
template <typename T>
__global__ void __launch_bounds__(D2_NT2)
msda_bwd_gsplit_kernel(const float* __restrict__ gsamp,
                       const __grid_constant__ MsdaExactArgs g,
                       const __grid_constant__ Levels lv,
                       const __grid_constant__ MsdaBin b, int lo, int hi,
                       T* __restrict__ gvalue) {
  constexpr int CL = D2_CLUSTER, PX = 64 / CL;  // pixels a block adds
  extern __shared__ __align__(16) float2 d2_acc[];  // [64][blockDim]
  const int t = threadIdx.x, nt = blockDim.x, row = blockIdx.y;
  const int ch = blockIdx.z * 256 + 2 * t;
  const bool has = ch < g.C;
  const float* gsr = gsamp + (long long)row * g.Q * g.heads * g.C + ch;
  const unsigned k = blockIdx.x % CL;
  cg::cluster_group cluster = cg::this_cluster();
  for (int tile = lo + blockIdx.x / CL; tile < hi; tile += gridDim.x / CL) {
    const unsigned n = b.tcnt[(long long)row * b.tiles + tile];
    if (n <= (unsigned)b.chunk) continue;  // msda_bwd_gvalue_kernel's
    int tx0, ty0;
    const int l = d2_tile(lv, b, tile, tx0, ty0);
    const unsigned s = b.tstart[(long long)row * b.tiles + tile];
    const unsigned len = (n + CL - 1) / CL;
#pragma unroll 8
    for (int p = 0; p < 64; ++p) d2_acc[p * nt + t] = make_float2(0.f, 0.f);
    d2_sum(d2_acc, g, b, row, l, tx0, ty0, s + min(n, k * len),
           s + min(n, (k + 1) * len), gsr, has);
    cluster.sync();
    const int h = lv.h[l], w = lv.w[l];
    T* out = gvalue + ((long long)row * g.T + lv.start[l]) * g.C + ch;
#pragma unroll
    for (int pp = 0; pp < PX; ++pp) {
      const int p = k * PX + pp;
      float2 v = cluster.map_shared_rank(d2_acc, 0)[p * nt + t];
#pragma unroll
      for (int r = 1; r < CL; ++r) {
        const float2 u = cluster.map_shared_rank(d2_acc, r)[p * nt + t];
        v = make_float2(__fadd_rn(v.x, u.x), __fadd_rn(v.y, u.y));
      }
      const int y = ty0 + p / TILE, x = tx0 + p % TILE;
      if (has && y < h && x < w) store2(out + ((long long)y * w + x) * g.C, v);
    }
    cluster.sync();  // no block leaves or reuses its sums while read
  }
}

// D2's launches over the tiles [lo, hi): stage 4 the tiles that fit a
// chunk, stage 8 the crowded ones.
template <typename T>
int launch_gvalue(const float* gs, const MsdaExactArgs& g, const Levels& lv,
                  const MsdaBin& b, int lo, int hi, T* gvalue, int slices,
                  int clusters, int stages, cudaStream_t st) {
  const int threads = min(D2_NT2, (g.C / 2 + 31) / 32 * 32);
  const int smem = 64 * threads * 8;  // the split's sums
  static int smem_set = 0;  // the attribute only grows (one card)
  if (smem > smem_set) {
    cudaFuncSetAttribute(msda_bwd_gsplit_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // 16 blocks a cluster: Hopper's non-portable size
    cudaFuncSetAttribute(msda_bwd_gsplit_kernel<T>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    smem_set = smem;
  }
  const int rows = g.B;
  // both launches: the crowded tiles' on a second stream of the device,
  // so that the two kernels (they write disjoint rows) fill each other's
  // idle SMs; the caller's stream waits for it
  constexpr int DEVICES = 16;
  static cudaStream_t side[DEVICES];
  static cudaEvent_t ready[DEVICES], done[DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  const bool both = (stages & 12) == 12 && hi > lo && dev < DEVICES;
  if (both && !side[dev]) {
    cudaStreamCreateWithFlags(&side[dev], cudaStreamNonBlocking);
    cudaEventCreateWithFlags(&ready[dev], cudaEventDisableTiming);
    cudaEventCreateWithFlags(&done[dev], cudaEventDisableTiming);
  }
  const cudaStream_t st8 = both ? side[dev] : st;
  if (both) {
    cudaEventRecord(ready[dev], st);
    cudaStreamWaitEvent(side[dev], ready[dev], 0);
  }
  if ((stages & 4) && hi > lo) {
    msda_bwd_gvalue_kernel<T><<<dim3(hi - lo, rows, slices), D2_NT, 0, st>>>(
        gs, g, lv, b, lo, gvalue);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if ((stages & 8) && hi > lo) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(D2_CLUSTER * clusters, rows, slices);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st8;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = D2_CLUSTER;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    const int err = (int)cudaLaunchKernelEx(
        &cfg, msda_bwd_gsplit_kernel<T>, gs, g, lv, b, lo, hi, gvalue);
    if (err) return err;
  }
  if (both) {
    cudaEventRecord(done[dev], side[dev]);
    cudaStreamWaitEvent(st, done[dev], 0);
  }
  return (int)cudaGetLastError();
}

// stages: 1 D1, 2 the bin pass, 4 D2 over the tiles of [lo, hi) that
// fit a chunk, 8 D2 over the crowded ones (the wrapper launches all four
// over all tiles; chip_smoke times them apart, D2 level by level).
template <typename T>
int launch_msda_bwd(const T* value, const float* loc, const float* attw,
                    const float* gs, const float* gw, T* gvalue, float* gloc,
                    float* gattw, void* scratch, const MsdaExactArgs& g,
                    const Levels& lv, int threads, MsdaBin b, int slices,
                    int clusters, int stages, int lo, int hi,
                    cudaStream_t st) {
  int want = 0;
  for (int l = 0; l < lv.n; ++l)
    want += (lv.h[l] + TILE - 1) / TILE * ((lv.w[l] + TILE - 1) / TILE);
  const long long N = (long long)g.Q * g.heads * g.P;
  const int rows = g.B;
  const int bin_smem = BIN_WARPS * b.smem_tiles * 4;
  if (g.C % 8 || g.C < 8 || g.heads < 1 || g.heads > 8 || g.P < 1 ||
      g.L != lv.n || threads != MX_NT || g.B * g.Q < 1 || b.tiles != want ||
      slices != (g.C + 255) / 256 || lo < 0 || lo > hi || hi > b.tiles ||
      stages & ~15 || N > (1LL << 30) || b.N != N ||
      b.seg < 1 || b.nseg != (int)((N + b.seg - 1) / b.seg) || b.chunk < 1 ||
      clusters < 1 || bin_smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const long long R = (long long)rows * g.L * N;
  float4* rwk = reinterpret_cast<float4*>(scratch);
  int* rpos = reinterpret_cast<int*>(rwk + R);
  b.rwk = rwk;
  b.rpos = rpos;
  b.cnt = reinterpret_cast<unsigned*>(rpos + R);
  b.tstart = b.cnt + (long long)rows * b.tiles * b.nseg;
  b.tcnt = b.tstart + (long long)rows * b.tiles;
  b.list = reinterpret_cast<int*>(b.tcnt + (long long)rows * b.tiles);
  if (stages & 1) {
    msda_bwd_kernel<T><<<msda_blocks(g), MX_NT, 0, st>>>(
        value, loc, attw, gs, gw, g, lv, gloc, gattw, rwk, rpos);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (stages & 2) {
    static int smem_set = 0;  // the attribute only grows (one card)
    if (bin_smem > 48 * 1024 && bin_smem > smem_set) {
      cudaFuncSetAttribute(msda_bin_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bin_smem);
      cudaFuncSetAttribute(msda_bin_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bin_smem);
      smem_set = bin_smem;
    }
    const dim3 grid((b.nseg + BIN_WARPS - 1) / BIN_WARPS, g.L, rows);
    msda_bin_kernel<false><<<grid, 32 * BIN_WARPS, bin_smem, st>>>(g, lv, b);
    msda_bin_scan_kernel<<<dim3(g.L, rows), 1024, 0, st>>>(lv, b);
    msda_bin_kernel<true><<<grid, 32 * BIN_WARPS, bin_smem, st>>>(g, lv, b);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_gvalue<T>(gs, g, lv, b, lo, hi, gvalue, slices, clusters,
                          stages, st);
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

// H1's dims (simpb_msda_levels) and H3's (simpb_clamp_select,
// simpb_clamp_demand) as arguments.
LevelsArgs levels_args(const int* dims) {
  LevelsArgs g;
  g.B = dims[0]; g.Q = dims[1]; g.heads = dims[4]; g.C = dims[5];
  g.T = dims[6]; g.stages = dims[7]; g.layout = dims[8];
  return g;
}

// H3's dims: B, Q, heads, L, P, ph, pw, threads, smem (the op's keys),
// then the L level heights, widths and start rows.
ClampArgs clamp_args(const int* dims) {
  ClampArgs g;
  g.B = dims[0]; g.Q = dims[1]; g.heads = dims[2]; g.L = dims[3];
  g.P = dims[4]; g.ph = dims[5]; g.pw = dims[6];
  return g;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (col / value; DFA's points and weights
// share it). The planners and wrappers in ops/sampling.py check every
// shape and limit.
extern "C" {

// dims: bs, cams, A, P, L, G, C, T, M (-1: no capacity), threads, smem,
// then the L level heights, widths and start rows. strides: points (5),
// weights (6). thr: int32 [bs * cams] scratch (the rank pass's count
// thresholds), used when 0 <= M < A * P.
int simpb_dfa(const void* col, const void* pts, const void* wts,
              void* thr, void* out, const int* dims,
              const long long* strides, int dtype, void* stream) {
  DfaArgs g;
  g.bs = dims[0]; g.cams = dims[1]; g.A = dims[2]; g.P = dims[3];
  g.G = dims[5]; g.C = dims[6]; g.T = dims[7]; g.M = dims[8];
  const int threads = dims[9], smem = dims[10];
  for (int i = 0; i < 5; ++i) g.sp[i] = strides[i];
  for (int i = 0; i < 6; ++i) g.sw[i] = strides[5 + i];
  const Levels lv = read_levels(dims[4], dims + 11);
  cudaStream_t st = (cudaStream_t)stream;
  return dtype ? launch_dfa<bf16>(col, pts, wts, (int*)thr, (float*)out, g,
                                  lv, threads, smem, st)
               : launch_dfa<float>(col, pts, wts, (int*)thr, (float*)out, g,
                                   lv, threads, smem, st);
}

// dims: B, Q, L, n, heads, C, T, K, ph, pw, threads, smem, then the L
// level heights, widths and start rows. bf16: the tensor-core kernel, one
// block per query (GPW channel groups a warp by C, at most 256 channels);
// fp32: one block per (query, camera row).
int simpb_msda_sel(const void* value, const void* loc, const void* attw,
                   void* sampled, void* wsum, const int* dims, int dtype,
                   void* stream) {
  MsdaArgs g;
  g.B = dims[0]; g.Q = dims[1]; g.n = dims[3]; g.heads = dims[4];
  g.C = dims[5]; g.T = dims[6]; g.K = dims[7]; g.ph = dims[8];
  g.pw = dims[9];
  const int threads = dims[10], smem = dims[11];
  const Levels lv = read_levels(dims[2], dims + 12);
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)loc;
  const float* a = (const float*)attw;
  float* sp = (float*)sampled;
  float* ws = (float*)wsum;
  if (!dtype)
    return launch_msda_sel_fp32((const float*)value, l, a, sp, ws, g, lv,
                                threads, smem, st);
  if (g.K == SEL_K)
    return g.C <= 128 ? launch_msda_sel_tc<1, true>(value, l, a, sp, ws, g,
                                                    lv, threads, smem, st)
                      : launch_msda_sel_tc<2, true>(value, l, a, sp, ws, g,
                                                    lv, threads, smem, st);
  return g.C <= 128 ? launch_msda_sel_tc<1, false>(value, l, a, sp, ws, g, lv,
                                                   threads, smem, st)
                    : launch_msda_sel_tc<2, false>(value, l, a, sp, ws, g, lv,
                                                   threads, smem, st);
}

// dims: B, Q, heads, L, P, C, T, threads (MX_NT), then the L level
// heights, widths and start rows. A half-warp per (camera row, query,
// head), MX_ITEMS of them a block.
int simpb_msda(const void* value, const void* loc, const void* attw,
               void* sampled, void* wsum, const int* dims, int dtype,
               void* stream) {
  MsdaExactArgs g;
  g.B = dims[0]; g.Q = dims[1]; g.heads = dims[2]; g.L = dims[3];
  g.P = dims[4]; g.C = dims[5]; g.T = dims[6];
  const Levels lv = read_levels(dims[3], dims + 8);
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)loc;
  const float* a = (const float*)attw;
  return dtype ? launch_msda<bf16>(value, l, a, (float*)sampled,
                                   (float*)wsum, g, lv, dims[7], st)
               : launch_msda<float>(value, l, a, (float*)sampled,
                                    (float*)wsum, g, lv, dims[7], st);
}

// Kernel H2, msda_hybrid's exact lane: adds the exact samples of the
// (row, query, level) entries `sel` [B, Q, L] (uint8) marks into sampled
// and wsum in place; dims as simpb_msda's, threads HX_NT.
int simpb_msda_hybrid(const void* value, const void* loc, const void* attw,
                      const void* sel, void* sampled, void* wsum,
                      const int* dims, int dtype, void* stream) {
  MsdaExactArgs g;
  g.B = dims[0]; g.Q = dims[1]; g.heads = dims[2]; g.L = dims[3];
  g.P = dims[4]; g.C = dims[5]; g.T = dims[6];
  const Levels lv = read_levels(dims[3], dims + 8);
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)loc;
  const float* a = (const float*)attw;
  const unsigned char* m = (const unsigned char*)sel;
  return dtype ? launch_msda_hybrid<bf16>(
                     value, l, a, m, (float*)sampled, (float*)wsum, g, lv,
                     dims[7], st)
               : launch_msda_hybrid<float>(
                     value, l, a, m, (float*)sampled, (float*)wsum, g, lv,
                     dims[7], st);
}

// Kernel H1 for bf16 values: dims B, Q, L, n, heads, C, T, stages,
// layout (0: loc [B, Q, L, n, 2], 1: loc [B, Q, heads, L, P, 2]; attw
// alike), threads (LV_NT), smem, then the L level heights, widths and
// start rows.
int simpb_msda_levels(const void* value, const void* loc, const void* attw,
                      void* sampled, void* wsum, const int* dims,
                      void* stream) {
  const LevelsArgs g = levels_args(dims);
  const Levels lv = read_levels(dims[2], dims + 11);
  if (dims[3] != g.heads * PTS) return (int)cudaErrorInvalidValue;
  const float* l = (const float*)loc;
  const float* a = (const float*)attw;
  cudaStream_t st = (cudaStream_t)stream;
  return g.C <= 128
             ? launch_msda_levels<1>(value, l, a, (float*)sampled,
                                     (float*)wsum, g, lv, dims[9], dims[10],
                                     st)
             : launch_msda_levels<2>(value, l, a, (float*)sampled,
                                     (float*)wsum, g, lv, dims[9], dims[10],
                                     st);
}

// Kernel H3, the op's instance: sel [B, Q, L] (uint8) and attw_win
// (attw's layout) of the k_cap = min(capacity, Q * L) corrected entries.
int simpb_clamp_select(const void* loc, const void* attw, void* sel,
                       void* attw_win, const int* dims, int k_cap,
                       void* stream) {
  const ClampArgs g = clamp_args(dims);
  const Levels lv = read_levels(dims[3], dims + 9);
  return launch_clamp_select((const float*)loc, (const float*)attw,
                             (unsigned char*)sel, (float*)attw_win, g, lv,
                             k_cap, dims[7], dims[8], (cudaStream_t)stream);
}

// Kernel H3, the guards' instance: demand [B] float32 over the valid
// queries (valid [B, Q] uint8, or NULL: every query); dims as above.
int simpb_clamp_demand(const void* loc, const void* valid, void* demand,
                       const int* dims, void* stream) {
  const ClampArgs g = clamp_args(dims);
  const Levels lv = read_levels(dims[3], dims + 9);
  return launch_clamp_demand((const float*)loc, (const unsigned char*)valid,
                             (float*)demand, g, lv, dims[7],
                             (cudaStream_t)stream);
}

// The exact MSDA kernel's probes (bf16 values only; see msda_kernel):
// ahead 1 (the kernel's) or 2 samples' rows in flight, mode 0 the
// kernel, 1 loads only, 2 arithmetic only; dims as simpb_msda's.
int simpb_msda_probe(const void* value, const void* loc, const void* attw,
                     void* sampled, void* wsum, const int* dims, int ahead,
                     int mode, void* stream) {
  MsdaExactArgs g;
  g.B = dims[0]; g.Q = dims[1]; g.heads = dims[2]; g.L = dims[3];
  g.P = dims[4]; g.C = dims[5]; g.T = dims[6];
  const Levels lv = read_levels(dims[3], dims + 8);
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* v = (const bf16*)value;
  const float *l = (const float*)loc, *a = (const float*)attw;
  float *sp = (float*)sampled, *ws = (float*)wsum;
  const int blocks = msda_blocks(g);
  if (ahead == 1 && mode == 0)
    msda_kernel<bf16, 1, 0><<<blocks, MX_NT, 0, st>>>(v, l, a, g, lv, sp, ws);
  else if (ahead == 2 && mode == 0)
    msda_kernel<bf16, 2, 0><<<blocks, MX_NT, 0, st>>>(v, l, a, g, lv, sp, ws);
  else if (ahead == 1 && mode == 1)
    msda_kernel<bf16, 1, 1><<<blocks, MX_NT, 0, st>>>(v, l, a, g, lv, sp, ws);
  else if (ahead == 1 && mode == 2)
    msda_kernel<bf16, 1, 2><<<blocks, MX_NT, 0, st>>>(v, l, a, g, lv, sp, ws);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The backward passes (kernels B and C). Kernel B: dims as simpb_dfa's
// (threads, smem: B1's), then B2's tile count and the L levels' first
// tiles; strides as the forward's; thr: the forward's saved count
// thresholds (NULL without a capacity); gout [bs, A, C] fp32; gcol [bs,
// cams, T, C], gpts [bs, A, P, cams, 2] and gwts [bs, A, P, cams, L, G]
// in the column's type, every element written; scratch: B1's records
// and B0's counts, rows * (L * N * (5 + G) + N + A + 1) words with rows
// = bs * cams and N = M (A * P without a capacity); stages: 1 B0, 2 B1,
// 4 B2 (7: the whole pass).
int simpb_dfa_bwd(const void* col, const void* pts, const void* wts,
                  const void* thr, const void* gout, void* gcol, void* gpts,
                  void* gwts, void* scratch, const int* dims,
                  const long long* strides, int dtype, int stages,
                  void* stream) {
  DfaArgs g;
  g.bs = dims[0]; g.cams = dims[1]; g.A = dims[2]; g.P = dims[3];
  g.G = dims[5]; g.C = dims[6]; g.T = dims[7]; g.M = dims[8];
  const int threads = dims[9], smem = dims[10], L = dims[4];
  for (int i = 0; i < 5; ++i) g.sp[i] = strides[i];
  for (int i = 0; i < 6; ++i) g.sw[i] = strides[5 + i];
  const Levels lv = read_levels(L, dims + 11);
  const int* d2 = dims + 11 + 3 * L;
  DfaTiles tl;
  for (int l = 0; l < L; ++l) tl.first[l] = d2[1 + l];
  cudaStream_t st = (cudaStream_t)stream;
  const int* t = (const int*)thr;
  const float* go = (const float*)gout;
  return dtype ? launch_dfa_bwd<bf16>(col, pts, wts, t, go, (bf16*)gcol,
                                      (bf16*)gpts, (bf16*)gwts, scratch, g,
                                      lv, threads, smem, d2[0], tl, stages,
                                      st)
               : launch_dfa_bwd<float>(col, pts, wts, t, go, (float*)gcol,
                                       (float*)gpts, (float*)gwts, scratch,
                                       g, lv, threads, smem, d2[0], tl,
                                       stages, st);
}

// Kernel D: dims B, Q, heads, L, P, C, T, D1's threads (MX_NT), D2's
// tile count and channel slices (of 256), the bin pass's segments and
// segment length (records), the chunk length (a longer tile list is
// split over a cluster), the tiles a bin warp counts in shared memory (0:
// in the count array), D2's clusters a camera row, then the L level
// heights, widths and start rows, then the L levels' first tiles; gsamp
// [B, Q, heads, C] and gwsum [B, Q, heads] fp32; gvalue [B, T, C] in the
// value's type, gloc [B, Q, heads, L, P, 2] and gattw [B, Q, heads, L, P]
// fp32, every element written; scratch (int32 words, R = B * L * Q *
// heads * P records): D1's records (5 R), the counts (B * tiles *
// segments), the tiles' starts and lengths (2 B * tiles), the lists (4
// R); stages: 1 D1, 2 the bin pass,
// 4 D2 over the tiles [lo, hi) that fit a chunk, 8 D2 over the crowded
// ones.
int simpb_msda_bwd(const void* value, const void* loc, const void* attw,
                   const void* gsamp, const void* gwsum, void* gvalue,
                   void* gloc, void* gattw, void* scratch, const int* dims,
                   int dtype, int stages, int lo, int hi, void* stream) {
  MsdaExactArgs g;
  g.B = dims[0]; g.Q = dims[1]; g.heads = dims[2]; g.L = dims[3];
  g.P = dims[4]; g.C = dims[5]; g.T = dims[6];
  const int threads = dims[7], slices = dims[9], clusters = dims[14];
  MsdaBin b = {};
  b.tiles = dims[8]; b.nseg = dims[10]; b.seg = dims[11];
  b.chunk = dims[12]; b.smem_tiles = dims[13];
  b.N = (int)((long long)g.Q * g.heads * g.P);
  const Levels lv = read_levels(g.L, dims + 15);
  for (int l = 0; l < g.L; ++l) b.first[l] = dims[15 + 3 * g.L + l];
  cudaStream_t st = (cudaStream_t)stream;
  const float *l = (const float*)loc, *a = (const float*)attw;
  const float *gs = (const float*)gsamp, *gw = (const float*)gwsum;
  float *gl = (float*)gloc, *ga = (float*)gattw;
  return dtype ? launch_msda_bwd<bf16>((const bf16*)value, l, a, gs, gw,
                                       (bf16*)gvalue, gl, ga, scratch, g, lv,
                                       threads, b, slices, clusters, stages,
                                       lo, hi, st)
               : launch_msda_bwd<float>((const float*)value, l, a, gs, gw,
                                        (float*)gvalue, gl, ga, scratch, g,
                                        lv, threads, b, slices, clusters,
                                        stages, lo, hi, st);
}

// dims as simpb_msda_sel's, then C3's tile count and channels a lane
// (1, 2 or 4), then the level table; gsamp [B, Q, heads, C] and gwsum
// [B, Q, heads] fp32; gvalue [B, T, C] in the value's type (every
// element written);
// gloc [B, Q, L, n, 2] and gattw [B, Q, L, n] fp32, zeroed by the caller
// (unselected levels stay 0); scratch: B * Q * K * (heads * ph * pw + 1)
// words (C1's window weights, then the windows).
int simpb_msda_sel_bwd(const void* value, const void* loc, const void* attw,
                       const void* gsamp, const void* gwsum, void* gvalue,
                       void* gloc, void* gattw, void* scratch,
                       const int* dims, int dtype, void* stream) {
  MsdaArgs g;
  g.B = dims[0]; g.Q = dims[1]; g.n = dims[3]; g.heads = dims[4];
  g.C = dims[5]; g.T = dims[6]; g.K = dims[7]; g.ph = dims[8];
  g.pw = dims[9];
  const int threads = dims[10], smem = dims[11], tiles = dims[12];
  const int cpl = dims[13];
  const Levels lv = read_levels(dims[2], dims + 14);
  cudaStream_t st = (cudaStream_t)stream;
  const float *l = (const float*)loc, *a = (const float*)attw;
  const float *gs = (const float*)gsamp, *gw = (const float*)gwsum;
  float *gl = (float*)gloc, *ga = (float*)gattw;
  float* sc = (float*)scratch;
  return dtype ? launch_msda_sel_bwd<bf16>(value, l, a, gs, gw, gvalue, gl,
                                           ga, sc, g, lv, threads, smem,
                                           tiles, cpl, st)
               : launch_msda_sel_bwd<float>(value, l, a, gs, gw, gvalue, gl,
                                            ga, sc, g, lv, threads, smem,
                                            tiles, cpl, st);
}

}  // extern "C"
