// CSR bucket scorer for Hopper (sm_90a): the fine-rerank hot path.
//
// Replaces the four Pallas TPU kernels of mevi_tpu/ops/bucket.py:
//
//   _kernel_v3    (bucket_scores_v3, bounds given)        -> bucket_kernel, kBounds
//   _fused_kernel (bucket_scores_fused, offsets in-kernel) -> bucket_kernel, kFused
//   _kernel       (bucket_scores, v1: raw window scores)   -> bucket_kernel, kRaw
//   _kernel_v2    (bucket_scores_v2, double-buffered)      -> bucket_kernel_v2
//
// Masked modes (v3, fused, v2): for G (query, beam) buckets with CSR
// bounds [s, e) and window start al = floor(s / align) * align,
//
//   scores[g, j] = q[g] . semb[al + j]   if s <= al + j < e, else -1e30
//   rows[g, j]   = al + j                if valid,           else -1
//
// for j < cap.  Raw mode (v1): scores[g, j] = q[g] . semb[min(start_g + j,
// N - 1)] for every j < cap, no mask and no rows (the caller masks).
// All modes accumulate in float32 after upcasting the corpus row (bf16,
// f32 or int8) and the query row (bf16 or f32).  align = 8 is the TPU
// contract (Mosaic slice alignment); align = 1 gives the unaligned
// [s, s + cap) window of the XLA path.
//
// What bounds them: a gather-GEMV, 2 flops per corpus element read, so
// device memory bandwidth (3.35 TB/s on an H100 SXM), not compute.  The
// masked modes never read rows outside [max(s, al), min(e, al + cap)):
// their slots are written as -1e30 / -1 straight away, so they move
// sum_g valid_g * d * itemsize corpus bytes, not the full G * cap * d
// window the TPU kernels DMA, and need no slack rows past the last real
// row.  Raw mode reads the whole clipped window: G * cap * d * itemsize.
//
// bucket_kernel (v3, fused, raw; simple and right first): one block per
// (bucket, tile of kTile window slots); the query row is staged once in
// shared memory as float32; each warp takes one slot at a time and its
// lanes stream the row as 16-byte vectors (8 bf16, 4 f32 or 16 int8),
// reduced with warp shuffles; lane 0 writes the score and row id.
//
// bucket_kernel_v2 (the design v2 set out to have on the TPU: this
// tile's compute overlaps the next tile's copy): one block per bucket
// loops over tiles of valid rows with a 2-stage cp.async pipeline
// (16-byte cp.async.cg, commit_group / wait_group): tile t + 1 is copied
// into shared memory while the warps score tile t out of shared memory.
// cp.async rather than TMA: a tile is a few contiguous rows at an
// arbitrary row offset, which 16-byte cp.async covers with no tensor map
// and no mbarrier bookkeeping; TMA bulk copies are a later option.  The
// query is staged as float32 in a lane-major layout (float4 m of vector
// k at [m * nvec + k]), so a lane reads both its corpus vector and its
// query values as contiguous 16-byte words with no bank conflicts
// (bucket_kernel's lanes read the query kEpv floats apart, which puts
// several lanes on one bank).  Invalid slots are written first, by all
// threads, coalesced.
//
// Left for later work: wgmma, TMA bulk copies, L2 reuse of hot clusters
// shared by several queries, a persistent grid, coalesced score writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;             // window slots per block (bucket_kernel)
constexpr int kStageBytes = 32 << 10; // corpus bytes per v2 pipeline stage
constexpr int kMaxStageRows = 64;
constexpr float kNeg = -1e30f;
constexpr int kBounds = 0, kFused = 1, kRaw = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of corpus row dotted with the matching float32 query values.
__device__ __forceinline__ float dot16(const uint4& v, const float* q,
                                       const float*) {
  const float* f = reinterpret_cast<const float*>(&v);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc = fmaf(f[i], q[i], acc);
  return acc;
}
__device__ __forceinline__ float dot16(const uint4& v, const float* q,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc = fmaf(f.x, q[2 * i], acc);
    acc = fmaf(f.y, q[2 * i + 1], acc);
  }
  return acc;
}
__device__ __forceinline__ float dot16(const uint4& v, const float* q,
                                       const int8_t*) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc = fmaf(static_cast<float>(c[i]), q[i], acc);
  return acc;
}

template <typename T, typename Q, int kMode>
__global__ void __launch_bounds__(kThreads)
bucket_kernel(const T* __restrict__ semb, int d, long long n_rows,
              const int* __restrict__ starts, const int* __restrict__ ends,
              const int* __restrict__ offsets, const int* __restrict__ cidx,
              const Q* __restrict__ qemb, int cap, int align,
              float* __restrict__ scores, int* __restrict__ rows) {
  extern __shared__ float qs[];   // d floats
  constexpr int kEpv = 16 / sizeof(T);
  const int g = blockIdx.x;
  int s, e;
  if (kMode == kFused) {
    const int c = cidx[g];
    s = offsets[c];
    e = offsets[c + 1];
  } else {
    s = starts[g];
    e = (kMode == kRaw) ? 0 : ends[g];
  }
  const int al = (kMode == kRaw) ? s : (s / align) * align;
  const int j0 = blockIdx.y * kTile;
  const int j1 = min(j0 + kTile, cap);
  const bool any = (kMode == kRaw) || max(s, al + j0) < min(e, al + j1);
  if (any) {
    const Q* qrow = qemb + static_cast<size_t>(g) * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = to_f32(qrow[i]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = d / kEpv;
  float* out_s = scores + static_cast<size_t>(g) * cap;
  int* out_r = (kMode == kRaw) ? nullptr : rows + static_cast<size_t>(g) * cap;
  for (int j = j0 + warp; j < j1; j += kWarps) {
    long long row = static_cast<long long>(al) + j;
    bool ok;                               // uniform across the warp
    if (kMode == kRaw) {
      row = min(row, n_rows - 1);
      ok = true;
    } else {
      ok = row >= s && row < e;
    }
    float acc = 0.f;
    if (ok) {
      const uint4* src =
          reinterpret_cast<const uint4*>(semb + static_cast<size_t>(row) * d);
#pragma unroll 4
      for (int k = lane; k < nvec; k += 32)
        acc += dot16(__ldg(src + k), qs + k * kEpv, semb);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) {
      out_s[j] = ok ? acc : kNeg;
      if (kMode != kRaw) out_r[j] = ok ? static_cast<int>(row) : -1;
    }
  }
}

// ---------------------------------------------------------------------------
// v2: 2-stage cp.async pipeline over tiles of a bucket's valid rows
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of `nrows` contiguous corpus rows starting at `row0`
// into a stage; every thread takes 16-byte chunks tid, tid + kThreads, ...
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* stage,
                                           const T* semb, long long row0,
                                           int nrows, int d) {
  const int nvec = d * static_cast<int>(sizeof(T)) / 16;
  const uint4* src =
      reinterpret_cast<const uint4*>(semb + static_cast<size_t>(row0) * d);
  uint4* dst = reinterpret_cast<uint4*>(stage);
  const int n = nrows * nvec;
  for (int i = threadIdx.x; i < n; i += kThreads) cp_async16(dst + i, src + i);
}

template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads)
bucket_kernel_v2(const T* __restrict__ semb, int d,
                 const int* __restrict__ starts, const int* __restrict__ ends,
                 const Q* __restrict__ qemb, int cap, int align,
                 int stage_rows_n, float* __restrict__ scores,
                 int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kEpv = 16 / sizeof(T);
  constexpr int kQv = kEpv / 4;            // float4 query words per vector
  const int nvec = d / kEpv;
  const int row_bytes = d * static_cast<int>(sizeof(T));
  float4* qs4 = reinterpret_cast<float4*>(smem);          // d floats
  unsigned char* stage0 = smem + static_cast<size_t>(d) * sizeof(float);
  const size_t stage_bytes = static_cast<size_t>(stage_rows_n) * row_bytes;

  const int g = blockIdx.x;
  const int s = starts[g];
  const int e = ends[g];
  const int al = (s / align) * align;
  const int lo = max(s, al);
  const int hi = min(e, al + cap);
  const int nvalid = max(hi - lo, 0);
  float* out_s = scores + static_cast<size_t>(g) * cap;
  int* out_r = rows + static_cast<size_t>(g) * cap;

  // invalid slots, coalesced, before anything else
  for (int j = threadIdx.x; j < cap; j += kThreads) {
    const int row = al + j;
    if (row < lo || row >= hi) {
      out_s[j] = kNeg;
      out_r[j] = -1;
    }
  }
  if (nvalid == 0) return;                 // uniform across the block

  const int ntiles = (nvalid + stage_rows_n - 1) / stage_rows_n;
  stage_rows(stage0, semb, lo, min(stage_rows_n, nvalid), d);
  cp_async_commit();

  // query -> float32, lane-major: float4 m of vector k at qs4[m*nvec + k]
  const Q* qrow = qemb + static_cast<size_t>(g) * d;
  for (int i = threadIdx.x; i < d / 4; i += kThreads) {
    const int el = 4 * i;
    const int k = el / kEpv;
    const int m = (el % kEpv) / 4;
    qs4[m * nvec + k] = make_float4(to_f32(qrow[el]), to_f32(qrow[el + 1]),
                                    to_f32(qrow[el + 2]),
                                    to_f32(qrow[el + 3]));
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int t = 0; t < ntiles; ++t) {
    const int r0 = t * stage_rows_n;
    const int nrows = min(stage_rows_n, nvalid - r0);
    if (t + 1 < ntiles) {                  // stage t+1 while scoring t
      const int r1 = r0 + stage_rows_n;
      stage_rows(stage0 + ((t + 1) & 1) * stage_bytes, semb,
                 static_cast<long long>(lo) + r1,
                 min(stage_rows_n, nvalid - r1), d);
      cp_async_commit();
      cp_async_wait<1>();                  // all but tile t+1 have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // tile t visible to every warp
    const unsigned char* st = stage0 + (t & 1) * stage_bytes;
    for (int r = warp; r < nrows; r += kWarps) {
      const uint4* src = reinterpret_cast<const uint4*>(
          st + static_cast<size_t>(r) * row_bytes);
      float acc = 0.f;
      for (int k = lane; k < nvec; k += 32) {
        const uint4 v = src[k];            // one 16-byte shared load
        float qf[kEpv];
#pragma unroll
        for (int m = 0; m < kQv; ++m) {
          const float4 w = qs4[m * nvec + k];
          qf[4 * m] = w.x;
          qf[4 * m + 1] = w.y;
          qf[4 * m + 2] = w.z;
          qf[4 * m + 3] = w.w;
        }
        acc += dot16(v, qf, semb);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        const int row = lo + r0 + r;
        out_s[row - al] = acc;
        out_r[row - al] = row;
      }
    }
    __syncthreads();                       // stage t&1 free for tile t+2
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, typename Q>
cudaError_t launch(const void* semb, int d, long long n_rows,
                   const int* starts, const int* ends, const int* offsets,
                   const int* cidx, const void* qemb, int G, int cap,
                   int align, bool raw, float* scores, int* rows,
                   cudaStream_t stream) {
  const dim3 grid(G, (cap + kTile - 1) / kTile);
  const dim3 block(kThreads);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  const T* e = static_cast<const T*>(semb);
  const Q* q = static_cast<const Q*>(qemb);
  if (raw) {
    bucket_kernel<T, Q, kRaw><<<grid, block, smem, stream>>>(
        e, d, n_rows, starts, nullptr, nullptr, nullptr, q, cap, 1, scores,
        nullptr);
  } else if (offsets != nullptr) {
    bucket_kernel<T, Q, kFused><<<grid, block, smem, stream>>>(
        e, d, n_rows, nullptr, nullptr, offsets, cidx, q, cap, align, scores,
        rows);
  } else {
    bucket_kernel<T, Q, kBounds><<<grid, block, smem, stream>>>(
        e, d, n_rows, starts, ends, nullptr, nullptr, q, cap, align, scores,
        rows);
  }
  return cudaGetLastError();
}

// Rows per v2 stage: as many as fit kStageBytes (at least 1, at most
// kMaxStageRows).  At d = 768 that is 21 bf16, 42 int8 or 10 f32 rows,
// so a block takes 3 KB + 2 x ~32 KB of shared memory and three blocks
// fit an SM.
inline int v2_stage_rows(int row_bytes) {
  return max(1, min(kMaxStageRows, kStageBytes / row_bytes));
}

template <typename T, typename Q>
cudaError_t launch_v2(const void* semb, int d, const int* starts,
                      const int* ends, const void* qemb, int G, int cap,
                      int align, float* scores, int* rows,
                      cudaStream_t stream) {
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int nrows = v2_stage_rows(row_bytes);
  const size_t smem = static_cast<size_t>(d) * sizeof(float) +
                      2 * static_cast<size_t>(nrows) * row_bytes;
  auto kernel = bucket_kernel_v2<T, Q>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<G, kThreads, smem, stream>>>(
      static_cast<const T*>(semb), d, starts, ends,
      static_cast<const Q*>(qemb), cap, align, nrows, scores, rows);
  return cudaGetLastError();
}

// Dispatch on (corpus dtype, query dtype) to F<T, Q>::run(args...).
template <template <typename, typename> class F, typename... Args>
cudaError_t dispatch(int semb_dtype, int q_dtype, Args... args) {
  if (q_dtype != 0 && q_dtype != 1) return cudaErrorInvalidValue;
  const bool qf = q_dtype == 0;
  switch (semb_dtype) {
    case 0:
      return qf ? F<float, float>::run(args...)
                : F<float, __nv_bfloat16>::run(args...);
    case 1:
      return qf ? F<__nv_bfloat16, float>::run(args...)
                : F<__nv_bfloat16, __nv_bfloat16>::run(args...);
    case 2:
      return qf ? F<int8_t, float>::run(args...)
                : F<int8_t, __nv_bfloat16>::run(args...);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename Q>
struct Launch {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch<T, Q>(args...); }
};
template <typename T, typename Q>
struct LaunchV2 {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch_v2<T, Q>(args...); }
};

}  // namespace

// dtype codes: corpus 0 = float32, 1 = bfloat16, 2 = int8;
// query 0 = float32, 1 = bfloat16.  Each entry returns the cudaError_t of
// its launch (0 on success).

// v3 / fused: bounds mode with starts/ends given (offsets == NULL), else
// offsets[cidx[g]], offsets[cidx[g] + 1].
extern "C" int mevi_bucket_scores(const void* semb, int semb_dtype, int d,
                                  const int* starts, const int* ends,
                                  const int* offsets, const int* cidx,
                                  const void* qemb, int q_dtype, int G,
                                  int cap, int align, float* scores,
                                  int* rows, void* stream) {
  return dispatch<Launch>(semb_dtype, q_dtype, semb, d, 0LL, starts, ends,
                          offsets, cidx, qemb, G, cap, align, false, scores,
                          rows, static_cast<cudaStream_t>(stream));
}

// v1 raw: scores only, rows min(starts[g] + j, n_rows - 1).
extern "C" int mevi_bucket_scores_raw(const void* semb, int semb_dtype,
                                      int d, long long n_rows,
                                      const int* starts, const void* qemb,
                                      int q_dtype, int G, int cap,
                                      float* scores, void* stream) {
  return dispatch<Launch>(
      semb_dtype, q_dtype, semb, d, n_rows, starts,
      static_cast<const int*>(nullptr), static_cast<const int*>(nullptr),
      static_cast<const int*>(nullptr), qemb, G, cap, 1, true, scores,
      static_cast<int*>(nullptr), static_cast<cudaStream_t>(stream));
}

// v2 pipelined: v3's contract, starts/ends given.
extern "C" int mevi_bucket_scores_v2(const void* semb, int semb_dtype, int d,
                                     const int* starts, const int* ends,
                                     const void* qemb, int q_dtype, int G,
                                     int cap, int align, float* scores,
                                     int* rows, void* stream) {
  return dispatch<LaunchV2>(semb_dtype, q_dtype, semb, d, starts, ends, qemb,
                            G, cap, align, scores, rows,
                            static_cast<cudaStream_t>(stream));
}

extern "C" const char* mevi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
