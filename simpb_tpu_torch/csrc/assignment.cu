// Exact linear assignment for Hopper (sm_90a): kernel A, the batched
// min-cost row -> column assignment of the training targets. It replaces
//   lsa_warp_kernel <- simpb_tpu/training/matching.py::linear_sum_assignment
//                      (:25-108, `lax` loops on the TPU, vmapped by
//                      batched_assignment :130)
// and computes what `linear_sum_assignment_plain` in
// training/matching.py computes, step for step: rows in order; for each,
// a Dijkstra search over the columns from that row (shortest augmenting
// path with dual potentials u, v, the Jonker-Volgenant scheme); the dual
// updates; the augmentation along the path.
//
// What bounds it: not bytes but a serial chain. Each Dijkstra step needs
// the previous step's argmin (which row comes next), and a matrix with
// padded rows takes thousands of steps (the padded rows tie at the pad
// cost, so padded row k walks the columns of every earlier padded row).
// So the design shortens one step:
// - One warp a matrix, no block barrier anywhere. Column j lives in
//   lane j % 32 at slot j / 32: v and the shortest-path costs spc sit in
//   registers (NPL slots a lane, a compile-time count), the unscanned
//   columns in a bitmask. path, row4col, u, col4row and the row flags sit
//   in the warp's share of shared memory (read by index, not by slot).
//   A step's column updates are branch-free (selects, and the path as a
//   predicated store): a branch a column, with its convergence barrier,
//   cost nvcc's first version 75 cycles a column.
// - A padded row (row_valid false) costs pad_cost in every column: its
//   step reads no cost row, and ((min + pad) - u[i]) is one lane-uniform
//   value. A valid row reads its row of the masked cost matrix, coalesced,
//   every load issued before the first is used.
// - The argmin: each lane reduces its slots in a tree (a later slot wins
//   only when strictly smaller, so the lower column wins a tie, as
//   jnp.argmin), then two `redux.sync` minima over the warp: the value
//   (as an order-preserving unsigned key) and, among the lanes holding
//   it, the column. The reduced cost is summed in the JAX order,
//   ((min + cost[i][j]) - u[i]) - v[j], each add rounded.
// - The dual updates run on every lane over its own scanned columns (a
//   scanned column's row is the scanned row it led to); the augmentation
//   walk runs on lane 0; __syncwarp orders the shared-memory updates.
// A block holds LSA_WARPS matrices, a warp each, that never wait for one
// another: 1, 2 or 4 a block took the same time, and this form compiled
// to a 20 % shorter step than a kernel written for one warp a block
// (PERF.md §6, kernel A).
//
// `lsa_argmin_chain_kernel` measures the latency floor: one warp runs a
// chain of dependent warp argmins, each exactly the step's reduction of
// the instance (an add a slot, the lane tree over NPL slots and the two
// redux minima), so that a Dijkstra step can take no less than one link
// of it.
//
// C interface (ctypes): cost [B, R, C] fp32 contiguous (finite where
// row_valid), row_valid [B, R] uint8, col4row [B, R] int32 out, R <= C <=
// 32 * MAX_NPL; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float INF = 1e30f;
constexpr int MAX_NPL = 32;  // columns a lane: C <= 1024
constexpr unsigned FULL = 0xffffffffu;
constexpr int LSA_WARPS = 4;  // matrices a block, one warp each

// a matrix's shared memory in words: path, row4col [C], u, col4row [R],
// the row flags [R] bytes
__host__ __device__ inline int lsa_words(int R, int C) {
  return 2 * C + 2 * R + (R + 3) / 4;
}

// an fp32 value as an unsigned key of the same order (+0 for -0, so
// that equal values tie)
__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.f));
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

// The warp's argmin over its columns: m[k] is column lane + 32 k's
// masked value; returns the least value (in every lane) and its column,
// the lowest among equal minima.
template <int NPL>
__device__ __forceinline__ int warp_argmin(float (&m)[NPL], int lane,
                                           float& best) {
  int slot[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) slot[k] = k;
#pragma unroll
  for (int s = 1; s < NPL; s *= 2)
#pragma unroll
    for (int k = 0; k + s < NPL; k += 2 * s)
      if (m[k + s] < m[k]) {
        m[k] = m[k + s];
        slot[k] = slot[k + s];
      }
  const unsigned key = key_of(m[0]);
  const unsigned kmin = __reduce_min_sync(FULL, key);
  const unsigned col = __reduce_min_sync(
      FULL, key == kmin ? (unsigned)(lane + 32 * slot[0]) : 0xffffffffu);
  best = value_of(kmin);
  return (int)col;
}

// *p = x where `pred`, as one predicated shared-memory store (no branch)
__device__ __forceinline__ void store_if(bool pred, int* p, int x) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %0, 0;\n"
      " @q st.shared.b32 [%1], %2;\n}\n" ::"r"((int)pred),
      "r"((unsigned)__cvta_generic_to_shared(p)), "r"(x)
      : "memory");
}

template <int NPL>
__global__ void __launch_bounds__(32 * LSA_WARPS)
lsa_warp_kernel(const float* __restrict__ cost,
                const uint8_t* __restrict__ row_valid, float pad,
                int* __restrict__ out, int B, int R, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mat = blockIdx.x * LSA_WARPS + warp;
  if (mat >= B) return;  // a whole warp: no barrier follows
  int* path = reinterpret_cast<int*>(smem) + warp * lsa_words(R, C);  // [C]
  int* row4col = path + C;                                  // [C]
  float* u = reinterpret_cast<float*>(row4col + C);         // [R]
  int* col4row = reinterpret_cast<int*>(u + R);             // [R]
  uint8_t* valid = reinterpret_cast<uint8_t*>(col4row + R); // [R]
  const float* cm = cost + (long long)mat * R * C;
  for (int j = lane; j < C; j += 32) row4col[j] = -1;
  for (int r = lane; r < R; r += 32) {
    u[r] = 0.f;
    col4row[r] = -1;
    valid[r] = row_valid[(long long)mat * R + r];
  }
  float v[NPL], spc[NPL];
  unsigned cols = 0;  // this lane's slots that hold a column
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    v[k] = 0.f;
    if (lane + 32 * k < C) cols |= 1u << k;
  }
  __syncwarp();

  for (int cur = 0; cur < R; ++cur) {
#pragma unroll
    for (int k = 0; k < NPL; ++k) spc[k] = INF;
    unsigned open = cols;  // this lane's unscanned columns
    int i = cur, sink;
    float mv = 0.f;
    // Dijkstra over the columns from row `cur`
    while (true) {
      const float ui = u[i];
      float red[NPL];  // ((min + cost[i][j]) - u[i]) - v[j]
      if (valid[i]) {
        const float* ci = cm + (long long)i * C + lane;
        float c[NPL];
#pragma unroll
        for (int k = 0; k < NPL; ++k)
          c[k] = (cols >> k) & 1u ? ci[32 * k] : 0.f;
#pragma unroll
        for (int k = 0; k < NPL; ++k)
          red[k] = __fsub_rn(__fsub_rn(__fadd_rn(mv, c[k]), ui), v[k]);
      } else {
        const float t = __fsub_rn(__fadd_rn(mv, pad), ui);
#pragma unroll
        for (int k = 0; k < NPL; ++k) red[k] = __fsub_rn(t, v[k]);
      }
      // branch-free: a predicated store of the path, selects for the rest
      float m[NPL];
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        const bool o = (open >> k) & 1u;
        const bool better = o & (red[k] < spc[k]);
        spc[k] = better ? red[k] : spc[k];
        store_if(better, path + lane + 32 * k, i);
        m[k] = o ? spc[k] : INF;
      }
      const int j = warp_argmin<NPL>(m, lane, mv);
      if ((j & 31) == lane) open &= ~(1u << (j >> 5));
      const int nxt = row4col[j];
      if (nxt < 0) {
        sink = j;
        break;
      }
      i = nxt;
    }
    const unsigned sc = cols & ~open;  // this lane's scanned columns

    // dual updates: each scanned column, and the scanned row it led to
    // (every scanned row but `cur`; row4col still holds the old matching)
#pragma unroll
    for (int k = 0; k < NPL; ++k)
      if ((sc >> k) & 1u) {
        const int j = lane + 32 * k;
        v[k] = __fsub_rn(v[k], __fsub_rn(mv, spc[k]));
        const int r = row4col[j];
        if (r >= 0) u[r] = __fsub_rn(__fadd_rn(u[r], mv), spc[k]);
      }
    __syncwarp();
    if (lane == 0) {
      u[cur] = __fadd_rn(u[cur], mv);
      // augment along the alternating path
      while (true) {
        const int r = path[sink];
        row4col[sink] = r;
        const int old = col4row[r];
        col4row[r] = sink;
        if (r == cur) break;
        sink = old;
      }
    }
    __syncwarp();
  }
  for (int r = lane; r < R; r += 32)
    out[(long long)mat * R + r] = col4row[r];
}

template <int NPL>
__global__ void lsa_argmin_chain_kernel(int n, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  float x = 0.f;
  for (int s = 0; s < n; ++s) {
    float m[NPL];
#pragma unroll
    for (int k = 0; k < NPL; ++k)
      m[k] = __fadd_rn(x, (float)((lane * 7 + k * 13 + s) & 63));
    float best;
    const int j = warp_argmin<NPL>(m, lane, best);
    x = __fadd_rn(best, (float)(j & 1));
  }
  if (lane == 0) *out = x;
}

int smem_bytes(int R, int C) { return 4 * LSA_WARPS * lsa_words(R, C); }

template <int NPL>
int launch(const float* cost, const uint8_t* valid, float pad, int* out,
           int B, int R, int C, cudaStream_t st) {
  const int smem = smem_bytes(R, C);
  static int smem_set = 0;  // the attribute only grows (one card)
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaFuncSetAttribute(lsa_warp_kernel<NPL>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set = smem;
  }
  lsa_warp_kernel<NPL><<<(B + LSA_WARPS - 1) / LSA_WARPS, 32 * LSA_WARPS,
                         smem, st>>>(cost, valid, pad, out, B, R, C);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, NPL>) for the instance that takes C
// columns: the least NPL >= C / 32. 29 is the 900 columns of every
// configuration's anchors: at 32 the step took 1.7x as long (PERF.md §6,
// kernel A).
template <typename F>
int with_npl(int C, F f) {
  const int npl = (C + 31) / 32;
  if (npl <= 1) return f(std::integral_constant<int, 1>());
  if (npl <= 2) return f(std::integral_constant<int, 2>());
  if (npl <= 4) return f(std::integral_constant<int, 4>());
  if (npl <= 8) return f(std::integral_constant<int, 8>());
  if (npl <= 16) return f(std::integral_constant<int, 16>());
  if (npl <= 29) return f(std::integral_constant<int, 29>());
  return f(std::integral_constant<int, 32>());
}

}  // namespace

extern "C" {

int simpb_lsa(const void* cost, const void* row_valid, void* col4row, int B,
              int R, int C, float pad, void* stream) {
  if (R > C || R <= 0 || B <= 0 || C > 32 * MAX_NPL ||
      smem_bytes(R, C) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  return with_npl(C, [&](auto npl) {
    return launch<decltype(npl)::value>(
        (const float*)cost, (const uint8_t*)row_valid, pad, (int*)col4row, B,
        R, C, (cudaStream_t)stream);
  });
}

// n dependent warp argmins of the instance that takes C columns (one
// warp); out: one float (keeps the chain live).
int simpb_lsa_argmin_chain(void* out, int n, int C, void* stream) {
  if (C <= 0 || C > 32 * MAX_NPL) return (int)cudaErrorInvalidValue;
  return with_npl(C, [&](auto npl) {
    lsa_argmin_chain_kernel<decltype(npl)::value>
        <<<1, 32, 0, (cudaStream_t)stream>>>(n, (float*)out);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
