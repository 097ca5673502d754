// Exact linear assignment for Hopper (sm_90a): kernel A, the batched
// min-cost row -> column assignment of the training targets. It replaces
//   lsa_kernel <- simpb_tpu/training/matching.py::linear_sum_assignment
//                 (:25-108, `lax` loops on the TPU, vmapped by
//                 batched_assignment :130)
// and computes what `linear_sum_assignment_plain` in
// training/matching.py computes, step for step: rows in order; for each,
// a Dijkstra search over the columns from that row (shortest augmenting
// path with dual potentials u, v, the Jonker-Volgenant scheme); the dual
// updates; the augmentation along the path.
//
// One block per cost matrix. Its shared memory holds v, the shortest
// path costs spc, path and row4col (one entry a column), the scanned
// columns' flags, and u, col4row and the scanned rows' flags (one entry
// a row). The cost matrix stays in global memory: each Dijkstra step
// reads one row, coalesced. A step's threads update their columns
// (column j by thread j mod blockDim) and reduce (value, index) pairs to
// the block's minimum, the lower index winning a tie, as jnp.argmin does;
// thread 0 then scans the column and moves to the row matched to it. The
// reduced cost is summed in the JAX order, ((min + cost[i][j]) - u[i]) -
// v[j], each add rounded (no FMA has a product to fuse here). The
// augmentation is a serial walk by thread 0.
//
// Correct and simple first: a matrix is one block, so a step costs a few
// block barriers and a batch of B matrices fills B SMs (ROADMAP queues a
// faster design).
//
// C interface (ctypes): cost [B, R, C] fp32 contiguous (finite, R <= C),
// col4row [B, R] int32 out; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LSA_NT = 256;
constexpr float INF = 1e30f;

struct Best {
  float v;
  int i;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v < a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ Best warp_min(Best b) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    Best t;
    t.v = __shfl_xor_sync(0xffffffffu, b.v, o);
    t.i = __shfl_xor_sync(0xffffffffu, b.i, o);
    b = better(b, t);
  }
  return b;
}

__global__ void __launch_bounds__(LSA_NT)
lsa_kernel(const float* __restrict__ cost, int* __restrict__ out, int R,
           int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);        // [C]
  float* spc = v + C;                               // [C]
  int* path = reinterpret_cast<int*>(spc + C);      // [C]
  int* row4col = path + C;                          // [C]
  float* u = reinterpret_cast<float*>(row4col + C); // [R]
  int* col4row = reinterpret_cast<int*>(u + R);     // [R]
  uint8_t* sc = reinterpret_cast<uint8_t*>(col4row + R);  // [C]
  uint8_t* sr = sc + C;                                   // [R]
  __shared__ float red_v[LSA_NT / 32];
  __shared__ int red_i[LSA_NT / 32];
  __shared__ float s_min;
  __shared__ int s_row, s_sink;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cm = cost + (long long)blockIdx.x * R * C;
  for (int j = tid; j < C; j += LSA_NT) {
    v[j] = 0.f;
    row4col[j] = -1;
  }
  for (int r = tid; r < R; r += LSA_NT) {
    u[r] = 0.f;
    col4row[r] = -1;
  }
  __syncthreads();

  for (int cur = 0; cur < R; ++cur) {
    for (int j = tid; j < C; j += LSA_NT) {
      spc[j] = INF;
      path[j] = -1;
      sc[j] = 0;
    }
    for (int r = tid; r < R; r += LSA_NT) sr[r] = 0;
    if (tid == 0) {
      s_row = cur;
      s_min = 0.f;
      s_sink = -1;
    }
    __syncthreads();

    // Dijkstra over the columns from row `cur`
    while (true) {
      const int i = s_row;
      const float mv = s_min;
      const float ui = u[i];
      const float* ci = cm + (long long)i * C;
      Best b{INF, C};
      for (int j = tid; j < C; j += LSA_NT) {
        float m = INF;  // a scanned column's masked value
        if (!sc[j]) {
          const float red =
              __fsub_rn(__fsub_rn(__fadd_rn(mv, ci[j]), ui), v[j]);
          if (red < spc[j]) {
            path[j] = i;
            spc[j] = red;
          }
          m = spc[j];
        }
        b = better(b, Best{m, j});
      }
      b = warp_min(b);
      if (lane == 0) {
        red_v[warp] = b.v;
        red_i[warp] = b.i;
      }
      __syncthreads();
      if (tid == 0) {
        Best t{red_v[0], red_i[0]};
        for (int w = 1; w < LSA_NT / 32; ++w)
          t = better(t, Best{red_v[w], red_i[w]});
        sr[i] = 1;
        const int j = t.i;
        s_min = t.v;
        sc[j] = 1;
        const int nxt = row4col[j];
        s_sink = nxt < 0 ? j : -1;
        s_row = nxt < 0 ? 0 : nxt;
      }
      __syncthreads();
      if (s_sink >= 0) break;
    }

    // dual updates (u of the other scanned rows reads col4row before the
    // augmentation)
    const float mv = s_min;
    for (int r = tid; r < R; r += LSA_NT)
      if (sr[r] && r != cur)
        u[r] = __fsub_rn(__fadd_rn(u[r], mv), spc[max(col4row[r], 0)]);
    for (int j = tid; j < C; j += LSA_NT)
      if (sc[j]) v[j] = __fsub_rn(v[j], __fsub_rn(mv, spc[j]));
    __syncthreads();
    if (tid == 0) {
      u[cur] = __fadd_rn(u[cur], mv);
      // augment along the alternating path
      int sink = s_sink;
      while (true) {
        const int i = path[sink];
        row4col[sink] = i;
        const int old = col4row[i];
        col4row[i] = sink;
        if (i == cur) break;
        sink = old < 0 ? 0 : old;
      }
    }
    __syncthreads();
  }
  for (int r = tid; r < R; r += LSA_NT)
    out[(long long)blockIdx.x * R + r] = col4row[r];
}

}  // namespace

extern "C" {

int simpb_lsa(const void* cost, void* col4row, int B, int R, int C,
              void* stream) {
  if (R > C || R <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const int smem = 17 * C + 9 * R;
  static int smem_set = 0;  // the attribute only grows (one card)
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaFuncSetAttribute(lsa_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set = smem;
  }
  lsa_kernel<<<B, LSA_NT, smem, (cudaStream_t)stream>>>(
      (const float*)cost, (int*)col4row, R, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
