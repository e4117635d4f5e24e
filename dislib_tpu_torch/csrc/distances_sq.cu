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
// arithmetic, sets the floor (~0.13 ms).  The cross term stays f32 FMA, the
// float32-faithful contraction: no tensor cores.
//
// Two paths, chosen by the caller's plan (ops/kernels.py, dist_plan):
//
// The stream (dist_bulk), when a's base is 16-byte aligned, d * 4 is a
// multiple of 16 and a tile of at least 32 rows fits: a is row-major, so a
// tile of R rows is one contiguous run of R * d * 4 bytes.  About one
// persistent block per SM walks its tiles through a two-stage ring in
// shared memory, each stage filled by one thread with cp.async.bulk (TMA's
// 1-D bulk copy: no tensor map) whose completion lands on the stage's
// mbarrier; the next tile's copy runs while the current one is computed,
// and a stage is refilled as soon as the block has finished with it.  At
// d = 100, R = 256 rows (102,400 bytes a stage).  b and |b|^2 are loaded
// into shared memory once (k <= 16) or per chunk of 16 rows of b and tile
// (k > 16: the tile is then re-read from shared memory, not from device
// memory).  Each thread owns a row: it reads it with 16-byte loads and
// keeps its row's cross terms in registers, NJ of them, the chunk's width
// rounded up to 4 (k = 10: 12 FMAs per value of a, not 16).  The row
// stride is d / 4 float4s; a quarter-warp's 8 lanes read 8 rows, in 8
// distinct 4-bank groups when d / 4 is odd (d = 100: 25): free of bank
// conflicts for d = 4 (mod 8); d / 4 = 2 (mod 4) costs 2-way conflicts,
// d / 4 = 4 (mod 8) 4-way, d / 4 = 0 (mod 8) 8-way.  b is read as float4
// broadcasts.  The (R, k) distances of a tile are contiguous in out: they
// are staged in shared memory (row stride 17, conflict-free) and written
// with coalesced stores.
//
// The slices (dist_sliced), for every other shape (d = 1, 3, 33, ..., an a
// that is a view at an unaligned offset, d too large for a tile): a block
// owns 256 rows of a, one row per thread, and streams a and a chunk of 16
// rows of b through shared memory in 32-wide slices of d with 4-byte loads.
//
// Both clamp at zero but let a NaN through (fmaxf would swallow it, hiding
// a non-finite input from the fit's health check); ragged edges are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 16;               // rows of b per chunk
constexpr int OST = KC + 1;          // row stride of the staged output

// ---------------------------------------------------------------------------
// the stream
// ---------------------------------------------------------------------------

constexpr int BULK_THREADS = 256;    // rows of a tile at most, one a thread
constexpr int BULK_STAGES = 2;
constexpr int BULK_HEAD = 128;       // bytes before the stages: mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// one thread: expect `bytes` on `bar`, then copy them from global memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// the chunk of b at rows [c0, c0 + KC) into bt (d-major, zero past k) and
// its squared norms into bsq, one warp a row
__device__ void load_b_chunk(const float* __restrict__ B, float* bt,
                             float* bsq, int c0, int K, int D) {
    for (int e = threadIdx.x; e < KC * D; e += BULK_THREADS) {
        const int r = e / D, c = e - r * D;
        bt[c * KC + r] = c0 + r < K ? B[(long long)(c0 + r) * D + c] : 0.f;
    }
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int q = warp; q < KC; q += BULK_THREADS / 32) {
        float s = 0.f;
        if (c0 + q < K)
            for (int t = lane; t < D; t += 32) {
                const float v = B[(long long)(c0 + q) * D + t];
                s = fmaf(v, v, s);
            }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) bsq[q] = s;
    }
}

// one row's NJ cross terms (and |a|^2 when `first`) from shared memory
template <int NJ>
__device__ __forceinline__ void row_chunk(const float* arow, const float* bt,
                                          int D, bool first, float& asq,
                                          float (&acc)[KC]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
    const float4* a4 = reinterpret_cast<const float4*>(arow);
#pragma unroll 2
    for (int q = 0; q < D / 4; ++q) {
        const float4 av = a4[q];
        const float ac[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const float a = ac[c];
            if (first) asq = fmaf(a, a, asq);
            const float4* bv =
                reinterpret_cast<const float4*>(bt + (4 * q + c) * KC);
#pragma unroll
            for (int g = 0; g < NJ / 4; ++g) {
                const float4 b = bv[g];
                acc[4 * g + 0] = fmaf(a, b.x, acc[4 * g + 0]);
                acc[4 * g + 1] = fmaf(a, b.y, acc[4 * g + 1]);
                acc[4 * g + 2] = fmaf(a, b.z, acc[4 * g + 2]);
                acc[4 * g + 3] = fmaf(a, b.w, acc[4 * g + 3]);
            }
        }
    }
}

__global__ void __launch_bounds__(BULK_THREADS)
dist_bulk(const float* __restrict__ A, const float* __restrict__ B,
          float* __restrict__ out, int M, int K, int D, int R) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    float* stage = reinterpret_cast<float*>(smem + BULK_HEAD);
    float* bt = stage + BULK_STAGES * R * D;          // [D][KC]
    float* bsq = bt + D * KC;                         // [KC]
    float* ost = bsq + KC;                            // [R][OST]

    const int tid = threadIdx.x;
    const int n_tiles = (M + R - 1) / R;
    if (tid == 0) {
        for (int s = 0; s < BULK_STAGES; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    auto issue = [&](int s, int tile) {
        const int rows = min(R, M - tile * R);
        bulk_load(stage + s * R * D, A + (long long)tile * R * D,
                  (uint32_t)rows * D * 4, &full[s]);
    };
    if (tid == 0)
        for (int s = 0; s < BULK_STAGES; ++s) {
            const int tile = blockIdx.x + s * gridDim.x;
            if (tile < n_tiles) issue(s, tile);
        }
    if (K <= KC) {
        load_b_chunk(B, bt, bsq, 0, K, D);
        __syncthreads();
    }

    float acc[KC];
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
        const int s = it % BULK_STAGES;
        mbar_wait(&full[s], (it / BULK_STAGES) & 1);
        const int rows = min(R, M - tile * R);
        const float* arow = stage + s * R * D + tid * D;
        float asq = 0.f;
        for (int c0 = 0; c0 < K; c0 += KC) {
            if (K > KC) {
                load_b_chunk(B, bt, bsq, c0, K, D);
                __syncthreads();
            }
            const int nj = min(KC, K - c0);
            const bool first = c0 == 0;
            if (tid < R) {
                switch ((nj + 3) / 4) {
                    case 1: row_chunk<4>(arow, bt, D, first, asq, acc); break;
                    case 2: row_chunk<8>(arow, bt, D, first, asq, acc); break;
                    case 3: row_chunk<12>(arow, bt, D, first, asq, acc); break;
                    default: row_chunk<16>(arow, bt, D, first, asq, acc);
                }
#pragma unroll
                for (int j = 0; j < KC; ++j) {
                    if (j >= nj) break;
                    const float v = asq - 2.f * acc[j] + bsq[j];
                    ost[tid * OST + j] = v < 0.f ? 0.f : v;
                }
            }
            __syncthreads();
            float* o = out + (long long)tile * R * K + c0;
            for (int e = tid; e < rows * nj; e += BULK_THREADS) {
                const int r = e / nj, j = e - r * nj;
                o[(long long)r * K + j] = ost[r * OST + j];
            }
            __syncthreads();   // ost, bt and (last chunk) the stage are free
        }
        if (tid == 0 && tile + BULK_STAGES * gridDim.x < n_tiles)
            issue(s, tile + BULK_STAGES * gridDim.x);
    }
}

// ---------------------------------------------------------------------------
// the slices
// ---------------------------------------------------------------------------

constexpr int TM = 256;              // rows of a per block, one per thread
constexpr int TD = 32;               // slice of d staged per step
constexpr int SL_THREADS = TM;
constexpr int SL_WARPS = SL_THREADS / 32;

__global__ void __launch_bounds__(SL_THREADS)
dist_sliced(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ out, int M, int K, int D) {
    __shared__ float As[TM][TD + 1];
    __shared__ __align__(16) float Bt[TD][KC];   // chunk of b, d-major
    __shared__ float bsq[KC];

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const long row0 = (long)blockIdx.x * TM;
    const long row = row0 + tid;

    float asq = 0.f;   // complete after the first chunk
    for (int c0 = 0; c0 < K; c0 += KC) {
        const bool first = (c0 == 0);
        for (int q = warp; q < KC; q += SL_WARPS) {
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

        float acc[KC];
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[j] = 0.f;

        for (int d0 = 0; d0 < D; d0 += TD) {
#pragma unroll 8
            for (int l = 0; l < (TM * TD) / SL_THREADS; ++l) {
                const int e = tid + l * SL_THREADS;
                const int r = e / TD, c = e % TD;
                const long gr = row0 + r;
                const int gc = d0 + c;
                As[r][c] = (gr < M && gc < D) ? A[gr * D + gc] : 0.f;
            }
#pragma unroll
            for (int l = 0; l < (KC * TD) / SL_THREADS; ++l) {
                const int e = tid + l * SL_THREADS;
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
                for (int q = 0; q < KC / 4; ++q) {
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
            for (int j = 0; j < KC; ++j) {
                const int col = c0 + j;
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
// The plan comes from the caller (ops/kernels.py, dist_plan): rows > 0
// takes the stream with tiles of `rows` rows, `grid` blocks and `smem`
// bytes of dynamic shared memory (a 16-byte aligned, d % 4 == 0);
// rows == 0 takes the slices.  Returns the launch's cudaError_t (0 =
// launched).
extern "C" int dslib_distances_sq_f32(const void* a, const void* b, void* out,
                                      int m, int k, int d, int rows, int grid,
                                      int smem, void* stream) {
    if (m <= 0 || k <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* A = static_cast<const float*>(a);
    const float* B = static_cast<const float*>(b);
    float* O = static_cast<float*>(out);
    if (rows > 0) {
        if (d % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0
            || rows > BULK_THREADS || grid <= 0)
            return (int)cudaErrorInvalidValue;
        cudaError_t e = cudaFuncSetAttribute(
            dist_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        dist_bulk<<<grid, BULK_THREADS, smem, st>>>(A, B, O, m, k, d, rows);
    } else {
        dist_sliced<<<(m + TM - 1) / TM, SL_THREADS, 0, st>>>(A, B, O, m, k,
                                                              d);
    }
    return (int)cudaGetLastError();
}
