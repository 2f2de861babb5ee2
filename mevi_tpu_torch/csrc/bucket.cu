// CSR bucket scorer for Hopper (sm_90a): the fine-rerank hot path.
//
// Replaces the four Pallas TPU kernels of mevi_tpu/ops/bucket.py:
//
//   _kernel_v3    (bucket_scores_v3, bounds given)        -> bucket_kernel, kBounds
//   _fused_kernel (bucket_scores_fused, offsets in-kernel) -> bucket_kernel, kFused
//   _kernel       (bucket_scores, v1: raw window scores)   -> bucket_kernel, kRaw
//                   (int8); raw_tile_kernel (bf16, f32)
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
// bucket_kernel: one block per bucket, for every mode of an int8 corpus
// and the masked modes (v3, fused) of a bf16 or f32 one.  A first,
// simpler design (one block per (bucket, tile of 64 slots), one row per
// warp at a time, lane 0 storing each slot) was bound by latency, issue and
// block count, not bytes: a warp held one row in flight and waited out a
// shuffle tree and two single-lane stores per slot, each corpus vector
// re-read its query floats from shared memory, and at cap 4096, where
// ~97% of the slots are empty, 64 blocks a bucket each only wrote -1e30 /
// -1 with single-lane stores (1.2 ms against a 0.05 ms bound on an H100).
// The design:
//   1. outputs first: all threads write the invalid slots [0, j0) and
//      [j1, cap) with 16-byte stores (float4 of -1e30, int4 of -1) where
//      the output rows are 16-byte aligned (cap % 4 == 0), scalar stores at
//      the ragged ends; an empty bucket exits after that fill, before its
//      query is read; the warps then visit only the valid slots.  For bf16
//      and f32 a window over kChunk = 1024 slots is split into one block
//      a chunk (grid (G, ceil(cap / 1024))): at cap 4096 one block would
//      otherwise stream a bucket of up to 4096 rows (6-12 MB) alone and
//      end the grid late; at cap 512 nothing changes.  int8 keeps one
//      block a bucket (its chunks cost more in extra blocks at 2 blocks an
//      SM than they saved).
//   2. rows in flight, query in registers: a row is split over a group of
//      `lanes` lanes, each lane taking at most kMaxV of its nvec 16-byte
//      vectors (8 bf16, 4 f32 or 16 int8 elements; row_lanes): at d = 768
//      32 lanes x 3 vectors for bf16, 32 x 6 for f32, 16 x 3 for int8.
//      Each lane's source issues the loads of R rows (4, or 2 when a lane
//      holds 4 or more vectors) before any arithmetic: 12 loads, 6 KB in
//      flight a warp at d = 768 for all three.  The lane-to-vector map is
//      fixed, so the lane's query slice (24 floats for bf16 and f32 at
//      d = 768, 48 for int8) is converted to float32 and loaded into
//      registers once a bucket.  Past 32 * kMaxV vectors a row (bf16 d >
//      1024, f32 d > 768, int8 d > 2048; V = 0) the row is taken in passes
//      of 4 vectors a lane and the query read from shared memory, in the
//      same kernel.  bf16 widens with __bfloat1622float2, f32 needs none.
//   3. one transposed butterfly (reduce_rows) reduces a lane's R partial
//      sums (R - 1 + log2(lanes / R) shuffles, 5 for 4 rows over 32 lanes)
//      and leaves each row's sum on a lane of its own; those lanes store a
//      warp's R * 32 / lanes contiguous slots (score and row id) with one
//      instruction each, so no lane-0 stores and no staging in shared
//      memory.
//   4. int8 only: exact widening without I2F: byte b ^ 0x80 = b + 128
//      goes into the low mantissa byte of 2^23 with one PRMT, and an FADD
//      of -(2^23 + 128) leaves b exactly, so the scores equal the I2F ones
//      up to the order of the float32 sums.
// Bound: the valid rows' bytes (each unique row once) plus G * cap * 8
// bytes of outputs at 3.35 TB/s; at cap 4096 the outputs dominate.
// Occupancy: __launch_bounds__(256, Corpus<T>::kMinBlocks): int8 2 blocks
// an SM (128 registers; 112 at d = 768), bf16 and f32 3 (80 registers at
// d = 768, no spills), whose blocks are short at cap 4096 and gain from
// more of them in flight (PERF.md lists the registers of each instance).
// The raw mode of bf16 and f32 corpora keeps the tiled loop
// (raw_tile_kernel, below): it scores every slot of the window and
// reaches ~70% of its window bound.  No wgmma or TMA: a bucket is one
// query against its own rows, a GEMV bound by bytes; tensor cores would
// need several queries that share a cluster (left for later, below).
//
// bucket_kernel_v2 (replaces _kernel_v2, mevi_tpu/ops/bucket.py:206; the
// design v2 set out to have on the TPU: this tile's compute overlaps the
// next tile's copy): one block per bucket loops over tiles of valid rows
// with a 2-stage cp.async pipeline (16-byte cp.async.cg, commit_group /
// wait_group): tile t + 1 is copied into shared memory while the warps
// score tile t out of shared memory.  cp.async rather than TMA: a tile is
// a few contiguous rows at an arbitrary row offset, which 16-byte
// cp.async covers with no tensor map and no mbarrier bookkeeping.
// Invalid slots are written first, by all threads, coalesced.
//   bf16 and f32 corpora: each warp takes one row at a time; the query is
//   staged as float32 in a lane-major layout (float4 m of vector k at
//   [m * nvec + k]), so a lane reads both its corpus vector and its query
//   values as contiguous 16-byte words with no bank conflicts.
//   int8 corpora (the overload on const int8_t*; bound by the valid rows'
//   bytes at 3.35 TB/s, like the masked bucket_kernel): the row-per-warp
//   loop re-read 64 bytes of query from shared memory per 16 corpus
//   bytes and paid an I2F a byte, so it was bound by arithmetic, not by
//   the copies.  Its design is bucket_kernel's int8 one fed from the
//   stages: (1) a row split over a lane group (16 lanes x 3 vectors at
//   d = 768), R = 4 rows a group with all R * V 16-byte shared loads
//   before the arithmetic, the lane's query slice in registers for the
//   whole bucket (in shared memory past d = 2048), PRMT + FADD widening,
//   one transposed butterfly and writer-lane stores; (2) stages of a
//   whole number of the block's rounds of 8 warps x R x groups rows
//   (64 rows, 48 KB at d = 768), 2 blocks an SM.  A ring of 1-D bulk
//   copies (TMA) across a persistent walk over the buckets, with a
//   producer warp and full / empty mbarriers, measured no faster on an
//   H100 (PERF.md), so the copies stay per-thread cp.async.
//
// Left for later work: wgmma and L2 reuse of hot clusters shared by
// several queries, and coalesced score writes for the raw tiled loop and
// the bf16 and f32 instances of bucket_kernel_v2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;             // window slots per block (bf16, f32)
constexpr int kStageBytes = 32 << 10; // corpus bytes per v2 pipeline stage
constexpr int kMaxStageRows = 64;
constexpr int kStageBytesI8 = 48 << 10; // corpus bytes per int8 v2 stage
constexpr float kNeg = -1e30f;
constexpr int kBounds = 0, kFused = 1, kRaw = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// bucket_kernel: one block per bucket, several rows in flight per warp
// ---------------------------------------------------------------------------

// Per corpus type: elements a 16-byte vector; the most vectors a lane
// holds with their query values in registers (at most 32 query floats for
// bf16 and f32, 64 for int8); blocks an SM (__launch_bounds__: 128
// registers a thread for 2, 80 for 3); and whether a bucket's window is
// split into blocks of kChunk slots.
template <typename T>
struct Corpus;
template <>
struct Corpus<int8_t> {
  static constexpr int kEpv = 16, kMaxV = 4, kMinBlocks = 2;
  static constexpr bool kChunked = false;
};
template <>
struct Corpus<__nv_bfloat16> {
  static constexpr int kEpv = 8, kMaxV = 4, kMinBlocks = 3;
  static constexpr bool kChunked = true;
};
template <>
struct Corpus<float> {
  static constexpr int kEpv = 4, kMaxV = 6, kMinBlocks = 3;
  static constexpr bool kChunked = true;
};
constexpr int kChunk = 1024;    // window slots a block takes (kChunked)

// acc + 16 bytes of corpus row dotted with the matching float32 query
// values, one FMA chain (from acc = 0: the vector's own dot product).
__device__ __forceinline__ float dot_acc(const uint4& v, const float* q,
                                         float acc, const float*) {
  acc = fmaf(__uint_as_float(v.x), q[0], acc);
  acc = fmaf(__uint_as_float(v.y), q[1], acc);
  acc = fmaf(__uint_as_float(v.z), q[2], acc);
  return fmaf(__uint_as_float(v.w), q[3], acc);
}
__device__ __forceinline__ float dot_acc(const uint4& v, const float* q,
                                         float acc, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc = fmaf(f.x, q[2 * i], acc);
    acc = fmaf(f.y, q[2 * i + 1], acc);
  }
  return acc;
}

// 16 int8 values dotted with 16 float32 query values, added to acc.  Each
// byte is widened exactly without I2F: b ^ 0x80 = b + 128 in [0, 255]
// goes into the low mantissa byte of 2^23 (PRMT), and subtracting
// 2^23 + 128 = 8388736 (FADD) leaves b as float32.
__device__ __forceinline__ float dot_acc(const uint4& v, const float* q,
                                         float acc, const int8_t*) {
  const unsigned w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                         v.z ^ 0x80808080u, v.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc = fmaf(__int_as_float(static_cast<int>(
                     __byte_perm(w[j], 0x4B000000u, 0x7540u | b))) -
                     8388736.0f,
                 q[4 * j + b], acc);
  return acc;
}

// Lanes a corpus row is split over: each lane takes at most maxv of the
// row's nvec 16-byte vectors, and a row has at least 4 lanes (as many as
// the rows a lane keeps in flight).
__host__ __device__ inline int row_lanes(int nvec, int maxv) {
  int lanes = 4;
  while (lanes < 32 && lanes * maxv < nvec) lanes <<= 1;
  return lanes;
}

// Vectors a lane holds with the query slice in registers (1 to maxv), or
// 0 when the slice would not fit (nvec > 32 * maxv) and the query is read
// from shared memory instead.
inline int lane_vectors(int nvec, int maxv) {
  return nvec > 32 * maxv ? 0
                          : (nvec + row_lanes(nvec, maxv) - 1) /
                                row_lanes(nvec, maxv);
}

// The E query floats of vector k out of shared memory (zeros past the
// row).
template <int E>
__device__ __forceinline__ void query_vec(float (&out)[E], const float* qs,
                                          int k, int nvec) {
#pragma unroll
  for (int m = 0; m < E / 4; ++m) {
    const float4 v = k < nvec
                         ? reinterpret_cast<const float4*>(qs)[E / 4 * k + m]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    out[4 * m] = v.x;
    out[4 * m + 1] = v.y;
    out[4 * m + 2] = v.z;
    out[4 * m + 3] = v.w;
  }
}

// Sums each of a lane's R partial sums over the `lanes` lanes of its
// group with one butterfly: every transposed level halves the values a
// lane holds (it keeps one half, sends the other to its partner), so R
// rows cost R - 1 + log2(lanes / R) shuffles.  Lane l ends with the
// full sum of row l * R / lanes.
template <int R>
__device__ __forceinline__ float reduce_rows(float (&acc)[R], int l,
                                             int lanes) {
#pragma unroll
  for (int n = R; n > 1; n >>= 1) {
    const int o = lanes * n / (2 * R);
    const bool up = (l & o) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? acc[i] : acc[i + n / 2];
      const float keep = up ? acc[i + n / 2] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  for (int o = lanes / (2 * R); o > 0; o >>= 1)
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
  return acc[0];
}

// Slots [a, b) of a bucket's outputs set to -1e30 / -1 by every thread of
// the block: 16-byte stores (float4, int4) where the output rows are
// 16-byte aligned (vec), scalar stores at the ragged ends and otherwise.
__device__ __forceinline__ void fill_invalid(float* s, int* r, int a, int b,
                                             bool vec) {
  const int va = vec ? min((a + 3) & ~3, b) : b;  // [va, vb): 4 slots a store
  const int vb = vec ? max(b & ~3, va) : b;
  for (int j = a + threadIdx.x; j < va; j += kThreads) {
    s[j] = kNeg;
    r[j] = -1;
  }
  float4* s4 = reinterpret_cast<float4*>(s);
  int4* r4 = reinterpret_cast<int4*>(r);
  for (int j = (va >> 2) + threadIdx.x; j < (vb >> 2); j += kThreads) {
    s4[j] = make_float4(kNeg, kNeg, kNeg, kNeg);
    r4[j] = make_int4(-1, -1, -1, -1);
  }
  for (int j = vb + threadIdx.x; j < b; j += kThreads) {
    s[j] = kNeg;
    r[j] = -1;
  }
}

// bucket_kernel, one block per bucket or per (bucket, chunk of kChunk
// window slots) (design in the note at the head of the file): every mode
// of an int8 corpus, the masked modes (v3, fused) of a bf16 or f32 one.  V: vectors a lane holds, the query slice in
// registers (1 to Corpus<T>::kMaxV), or 0 for the query in shared
// memory.  Window slots [j0, j1) hold the rows to score; masked modes
// fill the others first.  Lane l of group grp takes vectors k = l,
// l + lanes, ... of the rows of slots jb + r * groups + grp, r < R.
template <typename T, typename Q, int kMode, int V>
__global__ void __launch_bounds__(kThreads, Corpus<T>::kMinBlocks)
bucket_kernel(const T* __restrict__ semb, int d, long long n_rows,
              const int* __restrict__ starts, const int* __restrict__ ends,
              const int* __restrict__ offsets, const int* __restrict__ cidx,
              const Q* __restrict__ qemb, int cap, int align,
              float* __restrict__ scores, int* __restrict__ rows) {
  extern __shared__ float qs[];   // d floats
  constexpr int kEpv = Corpus<T>::kEpv;
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
  const Q* qrow = qemb + static_cast<size_t>(g) * d;
  float* out_s = scores + static_cast<size_t>(g) * cap;
  int* out_r = (kMode == kRaw) ? nullptr : rows + static_cast<size_t>(g) * cap;
  constexpr int kV = V > 0 ? V : 4;        // vectors a lane takes per pass
  constexpr int R = kV >= 4 ? 2 : 4;       // rows in flight per lane group
  int j0 = 0, j1 = cap;
  if (kMode != kRaw) {                     // invalid slots, coalesced
    // this block's slots [c0, c1): the whole window, or chunk blockIdx.y
    const int c0 = blockIdx.y * kChunk;
    const int c1 = Corpus<T>::kChunked ? min(c0 + kChunk, cap) : cap;
    j0 = min(max(max(s, al) - al, c0), c1);
    j1 = max(min(min(e, al + cap) - al, c1), j0);
    const bool vec = (cap & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(scores) |
                       reinterpret_cast<uintptr_t>(rows)) & 15) == 0;
    fill_invalid(out_s, out_r, c0, j0, vec);
    fill_invalid(out_s, out_r, j1, c1, vec);
    if (j0 >= j1) return;                  // uniform across the block
  }
  for (int i = threadIdx.x; i < d; i += kThreads) qs[i] = to_f32(qrow[i]);
  __syncthreads();

  const int nvec = d / kEpv;
  const int lanes = V > 0 ? row_lanes(nvec, Corpus<T>::kMaxV) : 32;
  const int lane = threadIdx.x & 31;
  const int l = lane & (lanes - 1);        // lane within its group
  const int groups = 32 / lanes;
  const int grp = lane / lanes;
  const int step = kV * lanes;             // vectors a pass covers
  float qf[V > 0 ? V : 1][kEpv];
  if (V > 0) {
#pragma unroll
    for (int i = 0; i < kV; ++i) query_vec(qf[i], qs, l + lanes * i, nvec);
  }
  const int per_warp = R * groups;         // slots a warp takes per round
  for (int jb = j0 + (threadIdx.x >> 5) * per_warp; jb < j1;
       jb += kWarps * per_warp) {
    const uint4* src[R];
    bool ok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = jb + r * groups + grp;
      ok[r] = j < j1;
      long long row = static_cast<long long>(al) + j;
      if (kMode == kRaw) row = min(row, n_rows - 1);
      src[r] = reinterpret_cast<const uint4*>(
          semb + static_cast<size_t>(ok[r] ? row : 0) * d);
    }
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int kb = l; kb < nvec; kb += step) {  // V > 0: one pass
      uint4 x[R][kV];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const int k = kb + lanes * i;
          x[r][i] = (ok[r] && k < nvec) ? __ldg(src[r] + k)
                                        : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        float qv[kEpv];
        if (V == 0) query_vec(qv, qs, kb + lanes * i, nvec);
        const float* qp = V > 0 ? qf[V > 0 ? i : 0] : qv;
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = dot_acc(x[r][i], qp, acc[r], semb);
      }
    }
    const float sum = reduce_rows<R>(acc, l, lanes);
    if ((l & (lanes / R - 1)) == 0) {      // one writer lane per row
      const int j = jb + (l * R / lanes) * groups + grp;
      if (j < j1) {
        out_s[j] = sum;
        if (kMode != kRaw) out_r[j] = al + j;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 and f32 raw mode (v1): one block per (bucket, tile of kTile window
// slots), one warp per slot at a time
// ---------------------------------------------------------------------------

template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads)
raw_tile_kernel(const T* __restrict__ semb, int d, long long n_rows,
                const int* __restrict__ starts, const int*, const int*,
                const int*, const Q* __restrict__ qemb, int cap, int,
                float* __restrict__ scores, int*) {
  extern __shared__ float qs[];   // d floats
  constexpr int kEpv = 16 / sizeof(T);
  const int g = blockIdx.x;
  const int s = starts[g];
  const int j0 = blockIdx.y * kTile;
  const int j1 = min(j0 + kTile, cap);
  const Q* qrow = qemb + static_cast<size_t>(g) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = to_f32(qrow[i]);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = d / kEpv;
  float* out_s = scores + static_cast<size_t>(g) * cap;
  for (int j = j0 + warp; j < j1; j += kWarps) {
    const long long row = min(static_cast<long long>(s) + j, n_rows - 1);
    const uint4* src =
        reinterpret_cast<const uint4*>(semb + static_cast<size_t>(row) * d);
    float acc = 0.f;
#pragma unroll 4
    for (int k = lane; k < nvec; k += 32)
      acc += dot_acc(__ldg(src + k), qs + k * kEpv, 0.f, semb);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out_s[j] = acc;
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
        acc += dot_acc(v, qf, 0.f, semb);
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

// v2 for an int8 corpus (the overload on const int8_t*): bucket_kernel's
// int8 arithmetic fed from the 2-stage cp.async tiles above.  V: vectors
// a lane holds, the query slice in registers (1-4), or 0 for the query
// in shared memory; R rows a lane group scores at once (V2I8<V>).  The
// stage holds a whole number of the block's rounds of kWarps * R *
// groups rows where it can, so no warp sits out a tile's last round.
template <int V>
struct V2I8 {
  static constexpr int kV = V > 0 ? V : 4;      // vectors a lane per chunk
  static constexpr int R = V == 4 ? 2 : 4;      // rows a lane group
  static constexpr int kBlocks = 2;             // blocks an SM
};

template <typename Q, int V>
__global__ void __launch_bounds__(kThreads, V2I8<V>::kBlocks)
bucket_kernel_v2(const int8_t* __restrict__ semb, int d,
                 const int* __restrict__ starts, const int* __restrict__ ends,
                 const Q* __restrict__ qemb, int cap, int align,
                 int stage_rows_n, float* __restrict__ scores,
                 int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kV = V2I8<V>::kV;
  constexpr int R = V2I8<V>::R;
  float* qs = reinterpret_cast<float*>(smem);               // d floats
  unsigned char* stage0 = smem + static_cast<size_t>(d) * sizeof(float);
  const size_t stage_bytes = static_cast<size_t>(stage_rows_n) * d;

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
  const Q* qrow = qemb + static_cast<size_t>(g) * d;
  for (int i = threadIdx.x; i < d; i += kThreads) qs[i] = to_f32(qrow[i]);
  __syncthreads();

  const int nvec = d >> 4;
  const int lanes = V > 0 ? row_lanes(nvec, 4) : 32;
  const int lane = threadIdx.x & 31;
  const int l = lane & (lanes - 1);        // lane within its group
  const int groups = 32 / lanes;
  const int grp = lane / lanes;
  const int step = kV * lanes;             // vectors a chunk covers
  float qf[V > 0 ? V : 1][16];
  if (V > 0) {
#pragma unroll
    for (int i = 0; i < kV; ++i) query_vec(qf[i], qs, l + lanes * i, nvec);
  }
  const int per_warp = R * groups;         // rows a warp takes per round
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
    for (int jb = (threadIdx.x >> 5) * per_warp; jb < nrows;
         jb += kWarps * per_warp) {
      const uint4* src[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = jb + r * groups + grp;
        src[r] = reinterpret_cast<const uint4*>(
            st + static_cast<size_t>(j < nrows ? j : 0) * d);
      }
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      for (int kb = l; kb < nvec; kb += step) {  // V > 0: one chunk
        uint4 x[R][kV];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int i = 0; i < kV; ++i) {
            const int k = kb + lanes * i;
            x[r][i] = k < nvec ? src[r][k] : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          float qv[16];
          if (V == 0) query_vec(qv, qs, kb + lanes * i, nvec);
          const float* qp = V > 0 ? qf[V > 0 ? i : 0] : qv;
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r] = dot_acc(x[r][i], qp, acc[r], semb);
        }
      }
      const float sum = reduce_rows<R>(acc, l, lanes);
      if ((l & (lanes / R - 1)) == 0) {    // one writer lane per row
        const int j = jb + (l * R / lanes) * groups + grp;
        if (j < nrows) {
          const int row = lo + r0 + j;
          out_s[row - al] = sum;
          out_r[row - al] = row;
        }
      }
    }
    __syncthreads();                       // stage t&1 free for tile t+2
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// One instance of bucket_kernel: one block per bucket, or per (bucket,
// chunk of kChunk window slots) for the masked modes of a kChunked type.
template <typename T, typename Q, int kMode, int V, typename... A>
void launch_v(int G, int cap, size_t smem, cudaStream_t stream, A... args) {
  const bool split = Corpus<T>::kChunked && kMode != kRaw;
  const dim3 grid(G, split ? (cap + kChunk - 1) / kChunk : 1);
  bucket_kernel<T, Q, kMode, V><<<grid, kThreads, smem, stream>>>(args...);
}

// One mode's launch: bucket_kernel's instance for the vectors a lane
// holds (lane_vectors; f32's 5 take the instance of 6), except the raw
// mode of bf16 and f32 corpora, which takes one block per (bucket, tile).
template <typename T, typename Q, int kMode, typename... A>
void launch_mode(int G, int cap, int d, cudaStream_t stream, A... args) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if constexpr (!std::is_same<T, int8_t>::value && kMode == kRaw) {
    const dim3 grid(G, (cap + kTile - 1) / kTile);
    raw_tile_kernel<T, Q><<<grid, kThreads, smem, stream>>>(args...);
  } else {
    constexpr int kMaxV = Corpus<T>::kMaxV;
    const int v = lane_vectors(d / Corpus<T>::kEpv, kMaxV);
    if constexpr (kMaxV > 4) {
      if (v > 4)
        return launch_v<T, Q, kMode, kMaxV>(G, cap, smem, stream, args...);
    }
    switch (v) {
      case 1:
        return launch_v<T, Q, kMode, 1>(G, cap, smem, stream, args...);
      case 2:
        return launch_v<T, Q, kMode, 2>(G, cap, smem, stream, args...);
      case 3:
        return launch_v<T, Q, kMode, 3>(G, cap, smem, stream, args...);
      case 4:
        return launch_v<T, Q, kMode, 4>(G, cap, smem, stream, args...);
      default:
        return launch_v<T, Q, kMode, 0>(G, cap, smem, stream, args...);
    }
  }
}

template <typename T, typename Q>
cudaError_t launch(const void* semb, int d, long long n_rows,
                   const int* starts, const int* ends, const int* offsets,
                   const int* cidx, const void* qemb, int G, int cap,
                   int align, bool raw, float* scores, int* rows,
                   cudaStream_t stream) {
  const T* e = static_cast<const T*>(semb);
  const Q* q = static_cast<const Q*>(qemb);
  if (raw) {
    launch_mode<T, Q, kRaw>(G, cap, d, stream, e, d, n_rows, starts, nullptr,
                            nullptr, nullptr, q, cap, 1, scores, nullptr);
  } else if (offsets != nullptr) {
    launch_mode<T, Q, kFused>(G, cap, d, stream, e, d, n_rows, nullptr,
                              nullptr, offsets, cidx, q, cap, align, scores,
                              rows);
  } else {
    launch_mode<T, Q, kBounds>(G, cap, d, stream, e, d, n_rows, starts, ends,
                               nullptr, nullptr, q, cap, align, scores, rows);
  }
  return cudaGetLastError();
}

// Rows per bf16 / f32 v2 stage: as many as fit kStageBytes (at least 1,
// at most kMaxStageRows).  At d = 768 that is 21 bf16 or 10 f32 rows, so
// a block takes 3 KB + 2 x ~32 KB of shared memory and three blocks fit
// an SM.
inline int v2_stage_rows(int row_bytes) {
  return max(1, min(kMaxStageRows, kStageBytes / row_bytes));
}

// int8 v2 launch: rows per stage are a whole number of the block's
// rounds (kWarps * R * groups rows) inside kStageBytesI8 where a round
// fits, else as many rows as fit.  At d = 768: 64 rows (48 KB) a stage,
// 3 KB + 2 x 48 KB of shared memory a block.
template <typename Q, int V>
cudaError_t launch_v2_i8(const int8_t* semb, int d, const int* starts,
                         const int* ends, const Q* qemb, int G, int cap,
                         int align, float* scores, int* rows,
                         cudaStream_t stream) {
  const int groups = V > 0 ? 32 / row_lanes(d / 16, 4) : 1;
  const int round = kWarps * V2I8<V>::R * groups;
  const int fit = max(1, kStageBytesI8 / d);
  const int nrows = fit >= round ? fit / round * round : fit;
  const size_t smem = static_cast<size_t>(d) * sizeof(float) +
                      2 * static_cast<size_t>(nrows) * d;
  auto kernel = bucket_kernel_v2<Q, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<G, kThreads, smem, stream>>>(semb, d, starts, ends, qemb, cap,
                                        align, nrows, scores, rows);
  return cudaGetLastError();
}

// int8 v2: the instance for the vectors a lane holds (lane_vectors).
template <typename Q>
cudaError_t launch_v2_int8(const void* semb, int d, const int* starts,
                           const int* ends, const void* qemb, int G, int cap,
                           int align, float* scores, int* rows,
                           cudaStream_t stream) {
  const int8_t* e = static_cast<const int8_t*>(semb);
  const Q* q = static_cast<const Q*>(qemb);
  switch (lane_vectors(d / 16, 4)) {
    case 1:
      return launch_v2_i8<Q, 1>(e, d, starts, ends, q, G, cap, align, scores,
                                rows, stream);
    case 2:
      return launch_v2_i8<Q, 2>(e, d, starts, ends, q, G, cap, align, scores,
                                rows, stream);
    case 3:
      return launch_v2_i8<Q, 3>(e, d, starts, ends, q, G, cap, align, scores,
                                rows, stream);
    case 4:
      return launch_v2_i8<Q, 4>(e, d, starts, ends, q, G, cap, align, scores,
                                rows, stream);
    default:
      return launch_v2_i8<Q, 0>(e, d, starts, ends, q, G, cap, align, scores,
                                rows, stream);
  }
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
  static cudaError_t run(Args... args) {
    if constexpr (std::is_same<T, int8_t>::value) {
      return launch_v2_int8<Q>(args...);
    } else {
      return launch_v2<T, Q>(args...);
    }
  }
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
