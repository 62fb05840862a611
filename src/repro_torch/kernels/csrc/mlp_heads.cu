// P stacked 3-layer MLP surrogate heads over N feature rows -> (P, N),
// and the single unstandardized head (N, F) -> (N,).
//
// Replaces: src/repro/kernels/mlp_surrogate.py:mlp_surrogate_heads (the
// pallas_call with every head's weights VMEM-resident), reached through
// Surrogate.predict_heads -> _predict_mlp_stacked; and
// mlp_surrogate.py:mlp_surrogate (one head, no standardizers), which is
// the same template at P = 1 with the identity standardizer (null
// pointers in the Stack: x - 0, / 1, * 1 + 0, each exact in fp32).
//
// Bound on the H100: operations. On the LIF path (F = 10 or 12, H1 = 100,
// H2 = 50, P <= 3) a row costs ~6,250 multiply-adds per head against
// ~50 bytes of input and 4 bytes of output per head; on the crossbar path
// (F = 68 or 70) ~12,000 against ~280 bytes. Both sit far right of the
// fp32 ridge point.
//
// Design: all P heads' weights and standardizers are staged once per block
// into shared memory, unpadded (~77 KB for three F = 12 heads, ~97 KB for
// the crossbar's two F = 68 heads, so the block opts into more than 48 KB
// of dynamic shared memory); each thread then carries one row through
// every head — features in a thread-local array of 16 floats (F <= 16,
// kept in registers) or 72 (crossbar rows), the first hidden layer in
// local memory, the second accumulated eight units at a time. Every
// thread of a warp reads the same weight at the same time, which shared
// memory serves as a broadcast. The TPU wrapper's padding of F/H1/H2 to
// 128 lanes has no counterpart here.

#include "heads.cuh"

namespace {

constexpr int kThreads = 128;

template <int KF>
__global__ void mlp_heads_kernel(const float* __restrict__ x, repro::Stack s,
                                 float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  repro::stage(s, 0, s.p, smem);
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float feat[KF];
#pragma unroll
  for (int k = 0; k < KF; ++k)
    feat[k] = k < s.f ? x[(size_t)r * s.f + k] : 0.0f;
  for (int h = 0; h < s.p; ++h) {
    const repro::Head hd = repro::head_at(smem, s, h);
    float xs[KF];
    repro::standardize(hd, feat, s.f, xs);
    const float y = repro::mlp3(hd, xs, s.f, s.h1, s.h2);
    out[(size_t)h * n + r] = y * hd.y_sd + hd.y_mu;
  }
}

template <int KF>
cudaError_t launch(const float* x, const repro::Stack& s, float* out, int n,
                   size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_heads_kernel<KF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (n + kThreads - 1) / kThreads;
  mlp_heads_kernel<KF><<<blocks, kThreads, bytes, stream>>>(x, s, out, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mlp_heads_launch(const float* x, const float* const* arrays,
                                float* out, int n, int p, int f, int h1,
                                int h2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (f > repro::kWideF || h1 > repro::kMaxH1) return cudaErrorInvalidValue;
  const repro::Stack s{arrays[0], arrays[1], arrays[2], arrays[3], arrays[4],
                       arrays[5], arrays[6], arrays[7], arrays[8], arrays[9],
                       nullptr, p, f, h1, h2, f};
  const size_t bytes = sizeof(float) * p * repro::head_floats(f, h1, h2);
  if (bytes > repro::kMaxSmem) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f <= repro::kNarrowF) return launch<repro::kNarrowF>(x, s, out, n, bytes, st);
  return launch<repro::kWideF>(x, s, out, n, bytes, st);
}

extern "C" int mlp_surrogate_launch(const float* x, const float* const* arrays,
                                    float* out, int n, int f, int h1, int h2,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (f > repro::kWideF || h1 > repro::kMaxH1) return cudaErrorInvalidValue;
  // arrays: w1 (F, H1), b1 (H1), w2 (H1, H2), b2 (H2), w3 (H2, 1), b3 (1)
  const repro::Stack s{nullptr, nullptr, nullptr, nullptr, arrays[0],
                       arrays[1], arrays[2], arrays[3], arrays[4], arrays[5],
                       nullptr, 1, f, h1, h2, f};
  const size_t bytes = sizeof(float) * repro::head_floats(f, h1, h2);
  if (bytes > repro::kMaxSmem) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f <= repro::kNarrowF) return launch<repro::kNarrowF>(x, s, out, n, bytes, st);
  return launch<repro::kWideF>(x, s, out, n, bytes, st);
}
