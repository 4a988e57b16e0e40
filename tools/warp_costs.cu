// Cycles one warp spends on the patterns the local BA kernel's LU is built
// from (csrc/local_ba.cu lu_solve), on one card: broadcasting a pivot row of
// 40 entries to the warp by shuffles or through shared memory (16-byte
// stores by its lane, a warp sync, 16-byte broadcast loads) with the two
// rows' updates, the updates alone, two dependent integer reductions (a
// pivot), __frcp_rn, and one back-substitution row summed by a shuffle tree
// or from shared memory. Each pattern 40 times in one block's warp 0,
// clock64() around, the best of 5 launches; cycles a repetition.
//
//   mkdir -p libcml_tpu_torch/_build
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o libcml_tpu_torch/_build/warp_costs tools/warp_costs.cu
//   libcml_tpu_torch/_build/warp_costs
#include <cstdio>
#include <cuda_runtime.h>
template <int MODE>
__global__ void k(float* io, long long* out) {
  __shared__ __align__(16) float sm[64 * 68];
  const int lane = threadIdx.x & 31;
  float r0[40], r1[40];
#pragma unroll
  for (int c = 0; c < 40; ++c) { r0[c] = io[lane * 40 + c]; r1[c] = io[(32 + lane) * 40 + c]; }
  for (int i = threadIdx.x; i < 64 * 68; i += blockDim.x) sm[i] = io[i % 1000];
  __syncthreads();
  long long t0 = clock64();
  if (threadIdx.x < 32) {
    int src = (int)io[2000] & 31;
    float m0 = io[2001 + lane], m1 = io[2033 + lane];
    float x = r0[0];
    for (int it = 0; it < 40; ++it) {
      if (MODE == 0) {        // the column update by shuffles: 39 shuffles and 78 FMAs
#pragma unroll
        for (int c = 0; c < 39; ++c) {
          const float u = __shfl_sync(0xffffffffu, r0[c + 1], src);
          r0[c] = r0[c + 1] - m0 * u;
          r1[c] = r1[c + 1] - m1 * u;
        }
        src = (src + 7) & 31;
      } else if (MODE == 1) { // FMAs only
#pragma unroll
        for (int c = 0; c < 39; ++c) {
          r0[c] = r0[c + 1] - m0 * r1[c];
          r1[c] = r1[c + 1] - m1 * r0[c + 1];
        }
      } else if (MODE == 2) { // the column update by shared memory: one lane's 10 STS.128, a warp sync, 10 LDS.128
        if (lane == src) {
#pragma unroll
          for (int c = 0; c < 40; c += 4)
            *reinterpret_cast<float4*>(&sm[(it & 1) * 68 + c]) = make_float4(r0[c], r0[c + 1], r0[c + 2], r0[c + 3]);
        }
        __syncwarp();
        float u[40];
#pragma unroll
        for (int c = 0; c < 40; c += 4) {
          const float4 q = *reinterpret_cast<const float4*>(&sm[(it & 1) * 68 + c]);
          u[c] = q.x; u[c + 1] = q.y; u[c + 2] = q.z; u[c + 3] = q.w;
        }
#pragma unroll
        for (int c = 0; c < 39; ++c) {
          r0[c] = r0[c + 1] - m0 * u[c + 1];
          r1[c] = r1[c + 1] - m1 * u[c + 1];
        }
        src = (src + 7) & 31;
      } else if (MODE == 3) { // two dependent REDUX a step
        unsigned a = __float_as_uint(x) & 0x7fffffffu;
        unsigned mm = __reduce_max_sync(0xffffffffu, a);
        unsigned w = __reduce_min_sync(0xffffffffu, a == mm ? (unsigned)lane : 99u);
        x += (float)(w & 1u);
      } else if (MODE == 4) { // a back-substitution row: partial, sync, 8 x LDS.128, 31 adds
        float acc = sm[it * 68 + lane] * x;
        float* part = sm + 3000 + 32 * (it & 1);
        part[lane] = acc;
        __syncwarp();
        float t[32];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 q = reinterpret_cast<const float4*>(part)[i];
          t[4 * i] = q.x; t[4 * i + 1] = q.y; t[4 * i + 2] = q.z; t[4 * i + 3] = q.w;
        }
#pragma unroll
        for (int l = 0; l < 16; ++l) t[l] = t[l] + t[l + 16];
#pragma unroll
        for (int l = 0; l < 8; ++l) t[l] = t[l] + t[l + 8];
#pragma unroll
        for (int l = 0; l < 4; ++l) t[l] = t[l] + t[l + 4];
#pragma unroll
        for (int l = 0; l < 2; ++l) t[l] = t[l] + t[l + 2];
        x = (t[0] + t[1]) * 0.5f;
      } else if (MODE == 5) { // a back-substitution row by the shuffle tree
        float acc = sm[it * 68 + lane] * x;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        x = acc * 0.5f;
      } else if (MODE == 6) { // frcp_rn chain
        x = __frcp_rn(x + 1.5f);
      } else if (MODE == 7) { // shuffles only, independent
#pragma unroll
        for (int c = 0; c < 39; ++c) r0[c] = __shfl_sync(0xffffffffu, r1[c + 1], src);
        src = (src + 7) & 31;
#pragma unroll
        for (int c = 0; c < 39; ++c) r1[c] = r0[c] + 1.0f;
      }
    }
    r0[0] += x;
  }
  __syncthreads();
  long long t1 = clock64();
  if (threadIdx.x == 0) out[MODE] = t1 - t0;
  float s = 0;
#pragma unroll
  for (int c = 0; c < 40; ++c) s += r0[c] + r1[c];
  if (s == 1234.5f) io[0] = s;
}
template <int MODE>
long long run(float* io, long long* out) {
  long long best = 1ll << 60;
  for (int rep = 0; rep < 5; ++rep) {
    k<MODE><<<1, 256>>>(io, out);
    long long c[8]; cudaMemcpy(c, out, 64, cudaMemcpyDeviceToHost);
    best = c[MODE] < best ? c[MODE] : best;
  }
  return best;
}
int main() {
  float* io; long long* out; cudaMalloc(&io, 8192 * 4); cudaMalloc(&out, 64);
  float h[8192]; for (int i = 0; i < 8192; ++i) h[i] = 0.001f * (i % 97) + 0.5f;
  h[2000] = 5.0f; cudaMemcpy(io, h, sizeof(h), cudaMemcpyHostToDevice);
  long long c[8] = {run<0>(io, out), run<1>(io, out), run<2>(io, out), run<3>(io, out),
                    run<4>(io, out), run<5>(io, out), run<6>(io, out), run<7>(io, out)};
  const char* names[] = {"col update by shfl (39 shfl, 78 ffma)", "ffma only (78)", "col update by smem (10 STS.128 1 lane, 10 LDS.128, 78 ffma)",
                         "2 dependent redux", "backsub row smem tree", "backsub row shfl tree", "frcp_rn", "39 shfl independent + 39 fadd"};
  for (int i = 0; i < 8; ++i) printf("%-60s %lld cycles a step  %s\n", names[i], c[i] / 40, cudaGetErrorString(cudaGetLastError()));
  return 0;
}
