// distances_sq — D[i, j] = max(|a_i|^2 - 2 a_i . b_j + |b_j|^2, 0).
//
// Replaces: dislib_tpu/ops/pallas_kernels.py, distances_sq (a row-tiled
// Pallas kernel: grid over 128-row tiles of a with b whole; the cross term
// is one MXU dot, the norms are row sums, the epilogue clamps at zero).
//
// What bounds it on an H100: bytes.  On the main path (the KMeans E-step,
// predict and score) a is (1,000,000 x 100) f32 and b is the (10 x 100)
// centers: the kernel must read 400 MB of a and write 40 MB of distances
// while doing only ~2.2 GFLOP, so the card's 3.35 TB/s memory rate, not its
// arithmetic, sets the floor (~0.13 ms).
//
// Design against that bound: read a exactly once, with coalesced loads, and
// spend as little shared-memory traffic per value of a as the FMAs allow.
// A block owns 256 rows of a, one row per thread, and walks all rows of b
// in chunks of 16.  For each chunk it first computes |b|^2 of those 16 rows
// into shared memory (one warp reduces each row), then streams a and the
// chunk of b through shared memory in 32-wide slices of d: the a slice
// row-major with one column of padding, so the 32 threads of a warp read 32
// rows in 32 distinct banks; the b slice d-major, so every thread reads the
// same 16 values of b as four 16-byte broadcasts.  Each thread keeps its
// row's 16 cross terms in registers and accumulates them in f32 FMA: one
// shared read of a feeds 16 FMAs.  |a|^2 is summed by the same thread from
// the same values during the first chunk and stays in a register.  When b
// has at most 16 rows — every KMeans with k <= 16 — a crosses the memory
// bus once.  Ragged edges are masked: out-of-range loads read zero and
// out-of-range outputs are not stored.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 256;              // rows of a per block, one per thread
constexpr int TN = 16;               // rows of b per chunk
constexpr int TD = 32;               // slice of d staged per step
constexpr int THREADS = TM;
constexpr int WARPS = THREADS / 32;
static_assert(TN % 4 == 0, "b is read as float4 broadcasts");

__global__ void __launch_bounds__(THREADS)
distances_sq_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ out, int M, int K, int D) {
    __shared__ float As[TM][TD + 1];
    __shared__ __align__(16) float Bt[TD][TN];   // chunk of b, d-major
    __shared__ float bsq[TN];

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const long row0 = (long)blockIdx.x * TM;
    const long row = row0 + tid;

    float asq = 0.f;   // complete after the first chunk
    for (int c0 = 0; c0 < K; c0 += TN) {
        const bool first = (c0 == 0);
        // |b|^2 of this chunk, one warp per row
        for (int q = warp; q < TN; q += WARPS) {
            const int br = c0 + q;
            float s = 0.f;
            if (br < K)
                for (int t = lane; t < D; t += 32) {
                    const float v = B[(long)br * D + t];
                    s = fmaf(v, v, s);
                }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                s += __shfl_xor_sync(0xffffffffu, s, off);
            if (lane == 0) bsq[q] = s;
        }
        __syncthreads();

        float acc[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[j] = 0.f;

        for (int d0 = 0; d0 < D; d0 += TD) {
            // a slice: TM x TD, consecutive threads on consecutive d
#pragma unroll 8
            for (int l = 0; l < (TM * TD) / THREADS; ++l) {
                const int e = tid + l * THREADS;
                const int r = e / TD, c = e % TD;
                const long gr = row0 + r;
                const int gc = d0 + c;
                As[r][c] = (gr < M && gc < D) ? A[gr * D + gc] : 0.f;
            }
            // b slice: TN x TD, stored transposed
#pragma unroll
            for (int l = 0; l < (TN * TD) / THREADS; ++l) {
                const int e = tid + l * THREADS;
                const int r = e / TD, c = e % TD;
                const int gr = c0 + r;
                const int gc = d0 + c;
                Bt[c][r] = (gr < K && gc < D) ? B[(long)gr * D + gc] : 0.f;
            }
            __syncthreads();
#pragma unroll 4
            for (int dd = 0; dd < TD; ++dd) {
                const float a = As[tid][dd];
                if (first) asq = fmaf(a, a, asq);
                const float4* bv = reinterpret_cast<const float4*>(Bt[dd]);
#pragma unroll
                for (int q = 0; q < TN / 4; ++q) {
                    const float4 b = bv[q];
                    acc[4 * q + 0] = fmaf(a, b.x, acc[4 * q + 0]);
                    acc[4 * q + 1] = fmaf(a, b.y, acc[4 * q + 1]);
                    acc[4 * q + 2] = fmaf(a, b.z, acc[4 * q + 2]);
                    acc[4 * q + 3] = fmaf(a, b.w, acc[4 * q + 3]);
                }
            }
            __syncthreads();
        }
        if (row < M) {
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int col = c0 + j;
                // clamp at zero, but let a NaN through (fmaxf would
                // swallow it, hiding a non-finite input from the fit's
                // health check)
                const float v = asq - 2.f * acc[j] + bsq[j];
                if (col < K) out[row * K + col] = v < 0.f ? 0.f : v;
            }
        }
        __syncthreads();   // bsq is rewritten by the next chunk
    }
}

}  // namespace

// C entry point, bound with ctypes.  a (m, d) and b (k, d) float32,
// row-major and contiguous; out (m, k) float32, allocated by the caller.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int dslib_distances_sq_f32(const void* a, const void* b, void* out,
                                      int m, int k, int d, void* stream) {
    if (m <= 0 || k <= 0) return 0;
    distances_sq_kernel<<<(m + TM - 1) / TM, THREADS, 0,
                          (cudaStream_t)stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), m, k, d);
    return (int)cudaGetLastError();
}
