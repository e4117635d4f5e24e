// node_histogram — the weighted (node, feature, bin) histogram of one tree
// level, for every tree of a forest in one call:
//
//   out[t, p, f, b, s] = sum over rows i with node[t, i] == p and
//                        bx[i, f] == b of  w[t, i] * stats[i, s]
//
// Replaces: dislib_tpu/ops/pallas_kernels.py, node_histogram (a Pallas
// kernel that one-hot encodes each row's (node, bin) pair and contracts the
// one-hot matrix with the per-row stats on the MXU, grid (feature,
// row tile), the output block carried across row tiles).  The reference
// runs it per tree under jax.vmap; here the tree is a leading dimension.
// The one-hot GEMM was the TPU's way to its matrix unit; on Hopper a
// histogram is shared-memory accumulation, and what costs is finding each
// item's rows.
//
// What bounds it on an H100: bytes.  At the forest's deepest level on the
// main path (16 trees, 1,000,000 x 100 rows, 2048 nodes x 32 bins x 2
// stats) the inputs are 536 MB and the output 839 MB: ~0.41 ms at
// 3.35 TB/s, counting bx read once.  Each tree reads the bx rows it keeps,
// so this design moves ~4 GB of bx at every level (~1.2 ms) besides the
// output; reading bx once for several trees is later work.
//
// Design: a counting sort of the rows by node, then a histogram over the
// sorted rows.  Four kernels, launched in order on one stream by one call:
//
//  1. part_count   grid (partition chunk, tree): the rows of a chunk of
//     CHUNK = 8 warps x rows_per_warp rows are counted per node in shared
//     memory (warp-aggregated atomics: one per distinct node in a warp).
//     A row is kept when its node is in [0, n_nodes) and some product
//     w * stats[s] is not +-0 (a NaN or inf product is not zero: it is
//     kept and added, as the plain version adds it).  This drops the ~37%
//     of rows a Poisson bootstrap weighs 0.
//  2. part_scan    grid (tree): an exclusive scan of the (node, chunk)
//     counts in node-major order gives each (node, chunk) its first slot in
//     the tree's sorted index list, and node_start[p]; a second scan gives
//     each node's first work item: ceil(count / rows_per_item) items, at
//     least one, so an empty node still writes its zeros.
//  3. part_scatter grid (partition chunk, tree): a stable scatter.  Warp w
//     of a block owns rows [w * rows_per_warp, (w + 1) * rows_per_warp) of
//     the chunk; it counts its rows per node into its own shared counters,
//     the block turns them into per-warp offsets (warps in row order), and
//     each warp walks its rows again, ranking equal nodes among its lanes
//     with __match_any_sync.  Every node's rows land in ascending order, so
//     the histogram's gathers of bx walk memory forward.  The same kernel
//     zeroes the output of every node that has more than one work item
//     (those items meet with global atomics).
//  4. hist_kernel  grid (G, tree), persistent: a work item is (node, row
//     chunk of the node, feature group, slice of the node's n_bins * S
//     entries).  It reads only its own rows.  Lanes run over features: a
//     warp takes one row at a time, lane l reads bx[i, f0 + l] (one
//     coalesced read of the row's bins) and adds into its own feature's
//     histogram, which lives at [entry][lane] in shared memory: the 32
//     addresses of a warp's add are distinct and in 32 distinct banks, at
//     any level, whatever the bins.  Each lane holds the w * stats of one
//     row of its warp's batch of 32, loaded at once, and the warp loads the
//     bins of the next ROWS rows (16, 8, 4, 4 for J = 1..4) while it adds
//     the current ones, so a row costs no chain of dependent loads.  The
//     block shares one copy of the histogram and adds with shared atomics
//     (on sm_90 a compare-and-swap loop), which meet only across warps.
//     Where nodes have many rows (the first levels) and eight copies fit
//     beside the features, each warp keeps its own copy (PRIVATE) and adds
//     with plain loads and stores.  An item writes its histogram out
//     through a small tile per warp (32 features x 8 entries), so that
//     every store writes whole 32-byte sectors.  An item that owns its
//     whole node stores plainly (and need not have zeroed output); the
//     items of a node with several row chunks add their non-zero entries
//     with global atomics into the output zeroed by part_scatter.
//
// Exactness.  Every sum is a sum of f32 products w * stats[s], each formed
// by one multiply as in the reference.  For classification the products
// are integers (Poisson weights x one-hot counts) and every partial sum
// stays below 2^24, so the order of the adds does not matter and the result
// is bit-equal to the plain scatter.  A product that is +0 or -0 is
// skipped: the sums start at +0, and adding a zero of either sign to a sum
// leaves its bits unchanged.  Rows whose node is out of range, and bins out
// of [0, n_bins), are dropped.
//
// Costs this version still pays: with fewer than 32 features per group the
// other lanes idle (n = 3: 3 of 32); each tree gathers its own rows of bx;
// the partition reads node, w and stats twice (count and scatter).

#include <cuda_runtime.h>

namespace {

constexpr int PWARPS = 8;               // warps of a partition block
constexpr int PTHREADS = 32 * PWARPS;
constexpr int HWARPS = 8;               // warps of a histogram block
constexpr int HBLOCKS = 4;              // histogram blocks per SM, at least
constexpr int HTHREADS = 32 * HWARPS;
constexpr int TILE_E = 8;               // the flush's tile: 32 features x
constexpr int TILE_STRIDE = TILE_E + 1; // TILE_E entries, per warp
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_PER_THREAD = 16;
constexpr unsigned FULL = 0xffffffffu;

// the partition's key of row i of tree t: its node, or -1 if dropped
__device__ __forceinline__ int row_key(const int* node_t, const float* w_t,
                                       const float* stats, long long i,
                                       int n_nodes, int S) {
    const int p = node_t[i];
    if ((unsigned)p >= (unsigned)n_nodes) return -1;
    const float wt = w_t[i];
    const float* st = stats + i * S;
    for (int s = 0; s < S; ++s)
        if (wt * st[s] != 0.f) return p;        // NaN != 0: kept
    return -1;
}

__global__ void __launch_bounds__(PTHREADS)
part_count(const int* __restrict__ node, const float* __restrict__ w,
           const float* __restrict__ stats, int* __restrict__ counts, int m,
           int n_nodes, int S, int chunk, int n_pc) {
    extern __shared__ int cnt[];                   // [n_nodes]
    const int c = blockIdx.x, t = blockIdx.y;
    const int lane = threadIdx.x % 32;
    for (int p = threadIdx.x; p < n_nodes; p += PTHREADS) cnt[p] = 0;
    __syncthreads();
    const int* node_t = node + (long long)t * m;
    const float* w_t = w + (long long)t * m;
    const long long r0 = (long long)c * chunk;
    const long long r1 = min((long long)m, r0 + chunk);
    for (long long base = r0; base < r1; base += PTHREADS) {
        const long long i = base + threadIdx.x;
        const int key = i < r1 ? row_key(node_t, w_t, stats, i, n_nodes, S)
                               : -1;
        const unsigned peers = __match_any_sync(FULL, key);
        if (key >= 0 && lane == __ffs(peers) - 1)
            atomicAdd(&cnt[key], __popc(peers));
    }
    __syncthreads();
    int* out = counts + (long long)t * n_nodes * n_pc + c;
    for (int p = threadIdx.x; p < n_nodes; p += PTHREADS)
        out[(long long)p * n_pc] = cnt[p];
}

// exclusive scan, in place, of v[0, len) by one block; returns the total
__device__ long long block_scan(int* v, long long len) {
    __shared__ long long warp_sum[SCAN_THREADS / 32];
    __shared__ long long carry_s;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    long long carry = 0;
    constexpr int TILE = SCAN_THREADS * SCAN_PER_THREAD;
    for (long long t0 = 0; t0 < len; t0 += TILE) {
        const long long b = t0 + (long long)threadIdx.x * SCAN_PER_THREAD;
        int x[SCAN_PER_THREAD];
        long long sum = 0;
#pragma unroll
        for (int k = 0; k < SCAN_PER_THREAD; ++k) {
            x[k] = b + k < len ? v[b + k] : 0;
            sum += x[k];
        }
        long long inc = sum;                       // warp inclusive scan
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const long long y = __shfl_up_sync(FULL, inc, o);
            if (lane >= o) inc += y;
        }
        if (lane == 31) warp_sum[warp] = inc;
        __syncthreads();
        if (warp == 0) {
            long long ws = warp_sum[lane];
            long long wi = ws;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const long long y = __shfl_up_sync(FULL, wi, o);
                if (lane >= o) wi += y;
            }
            warp_sum[lane] = wi - ws;              // exclusive over warps
            if (lane == 31) carry_s = wi;          // the tile's total
        }
        __syncthreads();
        long long run = carry + warp_sum[warp] + inc - sum;
#pragma unroll
        for (int k = 0; k < SCAN_PER_THREAD; ++k) {
            if (b + k < len) v[b + k] = (int)run;
            run += x[k];
        }
        carry += carry_s;
        __syncthreads();                           // warp_sum is reused
    }
    return carry;
}

__global__ void __launch_bounds__(SCAN_THREADS)
part_scan(int* __restrict__ counts, int* __restrict__ node_start,
          int* __restrict__ item_start, int n_nodes, int n_pc,
          int rows_per_item) {
    const int t = blockIdx.x;
    int* cnt = counts + (long long)t * n_nodes * n_pc;
    int* ns = node_start + (long long)t * (n_nodes + 1);
    int* is = item_start + (long long)t * (n_nodes + 1);
    const long long total = block_scan(cnt, (long long)n_nodes * n_pc);
    __syncthreads();
    for (int p = threadIdx.x; p < n_nodes; p += SCAN_THREADS)
        ns[p] = cnt[(long long)p * n_pc];
    if (threadIdx.x == 0) ns[n_nodes] = (int)total;
    __syncthreads();
    for (int p = threadIdx.x; p < n_nodes; p += SCAN_THREADS) {
        const int rows = ns[p + 1] - ns[p];
        is[p] = max(1, (rows + rows_per_item - 1) / rows_per_item);
    }
    __syncthreads();
    const long long items = block_scan(is, n_nodes);
    if (threadIdx.x == 0) is[n_nodes] = (int)items;
}

__global__ void __launch_bounds__(PTHREADS)
part_scatter(const int* __restrict__ node, const float* __restrict__ w,
             const float* __restrict__ stats, const int* __restrict__ counts,
             const int* __restrict__ item_start, int* __restrict__ idx,
             float* __restrict__ out, int m, int n_nodes, int S,
             int rows_per_warp, int n_pc, long long node_entries) {
    extern __shared__ int wcnt[];                  // [PWARPS][n_nodes]
    const int c = blockIdx.x, t = blockIdx.y;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const unsigned lt = (1u << lane) - 1u;
    for (int k = threadIdx.x; k < PWARPS * n_nodes; k += PTHREADS)
        wcnt[k] = 0;
    __syncthreads();
    const int* node_t = node + (long long)t * m;
    const float* w_t = w + (long long)t * m;
    const long long s0 = ((long long)c * PWARPS + warp) * rows_per_warp;
    const long long s1 = min((long long)m, s0 + rows_per_warp);
    int* mine = wcnt + warp * n_nodes;
    // 1: this warp's rows per node
    for (long long base = s0; base < s1; base += 32) {
        const long long i = base + lane;
        const int key = i < s1 ? row_key(node_t, w_t, stats, i, n_nodes, S)
                               : -1;
        const unsigned peers = __match_any_sync(FULL, key);
        if (key >= 0 && lane == __ffs(peers) - 1) mine[key] += __popc(peers);
        __syncwarp();
    }
    __syncthreads();
    // 2: per-warp first slots: the chunk's slot for the node, then the
    //    warps in row order
    const int* cnt = counts + (long long)t * n_nodes * n_pc + c;
    for (int p = threadIdx.x; p < n_nodes; p += PTHREADS) {
        int run = cnt[(long long)p * n_pc];
        for (int v = 0; v < PWARPS; ++v) {
            const int k = wcnt[v * n_nodes + p];
            wcnt[v * n_nodes + p] = run;
            run += k;
        }
    }
    __syncthreads();
    // 3: the stable scatter
    int* idx_t = idx + (long long)t * m;
    for (long long base = s0; base < s1; base += 32) {
        const long long i = base + lane;
        const int key = i < s1 ? row_key(node_t, w_t, stats, i, n_nodes, S)
                               : -1;
        const unsigned peers = __match_any_sync(FULL, key);
        if (key >= 0) idx_t[mine[key] + __popc(peers & lt)] = (int)i;
        __syncwarp();
        if (key >= 0 && lane == __ffs(peers) - 1) mine[key] += __popc(peers);
        __syncwarp();
    }
    // the output of every node split into several items starts at zero
    const int* is = item_start + (long long)t * (n_nodes + 1);
    for (int p = c; p < n_nodes; p += n_pc) {
        if (is[p + 1] - is[p] < 2) continue;
        float* o = out + ((long long)t * n_nodes + p) * node_entries;
        if (node_entries % 4 == 0) {
            float4* o4 = reinterpret_cast<float4*>(o);
            for (long long k = threadIdx.x; k < node_entries / 4;
                 k += PTHREADS)
                o4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
            for (long long k = threadIdx.x; k < node_entries; k += PTHREADS)
                o[k] = 0.f;
        }
    }
}

// the bins of rows base .. base + ROWS of the warp's batch (row index il
// in lane k for row k), lane = feature slot; -1 past nr or nf
template <int ROWS, int J>
__device__ __forceinline__ void load_bins(int (&dst)[ROWS][J],
                                          const int* __restrict__ bx, int il,
                                          int base, int nr, int n, int f0,
                                          int nf, int lane) {
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
        const int iu = __shfl_sync(FULL, il, base + u);
        const int* row = bx + (long long)iu * n + f0;
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int f = j * 32 + lane;
            dst[u][j] = base + u < nr && f < nf ? __ldg(row + f) : -1;
        }
    }
}

struct HistArgs {
    const int* bx;
    const float* w;
    const float* stats;
    const int* idx;
    const int* node_start;
    const int* item_start;
    float* out;
    int m, n, n_nodes, n_bins, S;
    int fgs, n_fgroups, slice_len, n_slices, rows_per_item;
};

// J: feature slots per lane (features f0 + 32 j + lane); PRIVATE: one
// histogram copy per warp, added to with plain loads and stores.  Four
// blocks per SM (64 registers): on an H100 the row phase, which waits on
// its gathers, ran fastest with its bin loads pipelined at 4 resident
// blocks (3 and 5 were slower; chip_smoke.py reports the occupancy)
template <int J, bool PRIVATE>
__global__ void __launch_bounds__(HTHREADS, HBLOCKS)
hist_kernel(const HistArgs a) {
    // [copy][j][entry of slice][lane], then a 32 x 33 tile per warp
    extern __shared__ float hist[];
    constexpr int COPIES = PRIVATE ? HWARPS : 1;
    // rows whose bins a warp loads at once: 16 loads (12 for J = 3)
    constexpr int ROWS = J == 1 ? 16 : J == 2 ? 8 : 4;
    const int t = blockIdx.y;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int E = a.n_bins * a.S;
    const long long node_entries = (long long)a.n * E;
    const int* ns = a.node_start + (long long)t * (a.n_nodes + 1);
    const int* is = a.item_start + (long long)t * (a.n_nodes + 1);
    const int* idx_t = a.idx + (long long)t * a.m;
    const float* w_t = a.w + (long long)t * a.m;
    const int per_chunk = a.n_fgroups * a.n_slices;
    const long long items = (long long)is[a.n_nodes] * per_chunk;
    const int copy_len = J * a.slice_len * 32;
    float* mine = hist + (PRIVATE ? warp * copy_len : 0);
    float* tiles = hist + COPIES * copy_len;

    for (long long q = blockIdx.x; q < items; q += gridDim.x) {
        const int cg = (int)(q / per_chunk);
        const int rem = (int)(q - (long long)cg * per_chunk);
        const int fgi = rem / a.n_slices, sl = rem % a.n_slices;
        // the node of item chunk cg: the last p with is[p] <= cg
        int lo = 0, hi = a.n_nodes - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) / 2;
            if (is[mid] <= cg) lo = mid; else hi = mid - 1;
        }
        const int p = lo;
        const int ch = cg - is[p];
        const bool direct = is[p + 1] - is[p] == 1;
        const int rs = ns[p] + ch * a.rows_per_item;
        const int re = min(ns[p + 1], rs + a.rows_per_item);
        const int f0 = fgi * a.fgs;
        const int nf = min(a.fgs, a.n - f0);
        const int e0 = sl * a.slice_len;
        const int el = min(a.slice_len, E - e0);
        float* o = a.out + ((long long)t * a.n_nodes + p) * node_entries
                   + (long long)f0 * E + e0;
        // units of (slot, TILE_E entries); in a store, lane = (feature
        // r = lane / TILE_E + 4 k, entry lane % TILE_E): 32-byte runs
        const int units = J * ((el + TILE_E - 1) / TILE_E);
        const int le = lane % TILE_E;

        if (re <= rs) {                            // an empty node: zeros
            for (int u = warp; u < units; u += HWARPS) {
                const int j = u % J, eb = (u / J) * TILE_E;
                const int rows = min(32, nf - j * 32);
                if (eb + le < el)
                    for (int r = lane / TILE_E; r < rows; r += 32 / TILE_E)
                        o[(long long)(j * 32 + r) * E + eb + le] = 0.f;
            }
            continue;
        }

        float4* h4 = reinterpret_cast<float4*>(hist);
        for (int k = threadIdx.x; k < COPIES * copy_len / 4; k += HTHREADS)
            h4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        __syncthreads();

        for (int r0 = rs + warp * 32; r0 < re; r0 += HTHREADS) {
            // lane k holds row r0 + k: its index and, four stats at a
            // time, its contributions w * stats[s], all loaded at once
            const int nr = min(32, re - r0);
            const int il = lane < nr ? idx_t[r0 + lane] : 0;
            const float wl = lane < nr ? w_t[il] : 0.f;
            const float* stl = a.stats + (long long)il * a.S;
            for (int s0 = 0; s0 < a.S; s0 += 4) {
                const int ns = min(4, a.S - s0);
                float cl[4];
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    cl[q] = lane < nr && q < ns ? wl * __ldg(stl + s0 + q)
                                                : 0.f;
                // the bins of the next ROWS rows load while these add
                int b[ROWS][J], bn[ROWS][J];
                load_bins<ROWS, J>(bn, a.bx, il, 0, nr, a.n, f0, nf, lane);
                for (int u0 = 0; u0 < nr; u0 += ROWS) {
#pragma unroll
                    for (int u = 0; u < ROWS; ++u)
#pragma unroll
                        for (int j = 0; j < J; ++j) b[u][j] = bn[u][j];
                    if (u0 + ROWS < nr)
                        load_bins<ROWS, J>(bn, a.bx, il, u0 + ROWS, nr, a.n,
                                           f0, nf, lane);
#pragma unroll
                    for (int u = 0; u < ROWS; ++u) {
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
                            const float c = __shfl_sync(FULL, cl[q], u0 + u);
                            if (c == 0.f) continue;    // also rows past nr
                            const int s = s0 + q;
#pragma unroll
                            for (int j = 0; j < J; ++j) {
                                if ((unsigned)b[u][j] >= (unsigned)a.n_bins)
                                    continue;
                                const int e = b[u][j] * a.S + s - e0;
                                if ((unsigned)e >= (unsigned)el) continue;
                                float* h = mine + (j * a.slice_len + e) * 32
                                           + lane;
                                if (PRIVATE) *h += c;
                                else atomicAdd(h, c);
                            }
                        }
                    }
                }
            }
        }
        __syncthreads();

        // out[t, p, f0 + f, e0 + e], a unit at a time: lane = feature
        // reads its TILE_E entries (bank = lane) into the warp's tile, then
        // each store writes four features' runs of TILE_E entries, whole
        // 32-byte sectors (tile stride 9, odd: writes conflict-free, reads
        // at most 2-way)
        float* tile = tiles + warp * 32 * TILE_STRIDE;
        for (int u = warp; u < units; u += HWARPS) {
            const int j = u % J, eb = (u / J) * TILE_E;
#pragma unroll
            for (int k = 0; k < TILE_E; ++k) {
                float v = 0.f;
                if (eb + k < el)
#pragma unroll
                    for (int cp = 0; cp < COPIES; ++cp)
                        v += hist[cp * copy_len
                                  + (j * a.slice_len + eb + k) * 32 + lane];
                tile[lane * TILE_STRIDE + k] = v;
            }
            __syncwarp();
            const int rows = min(32, nf - j * 32);
            if (eb + le < el) {
                for (int r = lane / TILE_E; r < rows; r += 32 / TILE_E) {
                    const float v = tile[r * TILE_STRIDE + le];
                    float* dst = o + (long long)(j * 32 + r) * E + eb + le;
                    if (direct) *dst = v;
                    else if (v != 0.f) atomicAdd(dst, v);
                }
            }
            __syncwarp();
        }
        __syncthreads();       // hist is zeroed again by the next item
    }
}

template <int J, bool PRIVATE>
cudaError_t launch_hist(const HistArgs& a, int grid_x, int T, size_t smem,
                        cudaStream_t st) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_kernel<J, PRIVATE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    hist_kernel<J, PRIVATE><<<dim3(grid_x, T), HTHREADS, smem, st>>>(a);
    return cudaGetLastError();
}

}  // namespace

// Resident histogram blocks per SM for a plan's (J, priv) and dynamic
// shared memory, as the CUDA runtime computes them; for the record.
extern "C" int dslib_node_histogram_occupancy(int J, int priv, int smem,
                                              int* blocks) {
    const void* fns[8] = {
        (const void*)hist_kernel<1, false>, (const void*)hist_kernel<1, true>,
        (const void*)hist_kernel<2, false>, (const void*)hist_kernel<2, true>,
        (const void*)hist_kernel<3, false>, (const void*)hist_kernel<3, true>,
        (const void*)hist_kernel<4, false>, (const void*)hist_kernel<4, true>};
    if (J < 1 || J > 4) return (int)cudaErrorInvalidValue;
    const void* fn = fns[(J - 1) * 2 + (priv ? 1 : 0)];
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                          HTHREADS, smem);
    return (int)e;
}

// C entry point, bound with ctypes.  node (T, m) int32, bx (m, n) int32,
// w (T, m) float32, stats (m, S) float32, all row-major and contiguous;
// out (T, n_nodes, n, n_bins, S) float32, allocated by the caller (not
// zeroed); scratch int32 of T*m + T*n_nodes*n_pc + 2*T*(n_nodes+1)
// entries.  The plan (rows_per_warp .. grid_x) comes from the caller
// (ops/kernels.py, hist_plan).  Launches the four kernels on `stream`;
// returns the first cudaError_t (0 = all launched).
extern "C" int dslib_node_histogram_f32(
        const void* node, const void* bx, const void* w, const void* stats,
        void* out, void* scratch, int T, int m, int n, int n_nodes,
        int n_bins, int S, int rows_per_warp, int n_pc, int J, int fgs,
        int n_fgroups, int slice_len, int n_slices, int priv,
        int rows_per_item, int grid_x, void* stream) {
    if (T <= 0 || m <= 0 || n <= 0 || n_nodes <= 0 || n_bins <= 0 || S <= 0)
        return 0;
    if (J < 1 || J > 4 || slice_len % 4 != 0 || rows_per_item <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* node_p = static_cast<const int*>(node);
    const float* w_p = static_cast<const float*>(w);
    const float* stats_p = static_cast<const float*>(stats);
    float* out_p = static_cast<float*>(out);
    int* idx = static_cast<int*>(scratch);
    int* counts = idx + (long long)T * m;
    int* node_start = counts + (long long)T * n_nodes * n_pc;
    int* item_start = node_start + (long long)T * (n_nodes + 1);
    const int chunk = PWARPS * rows_per_warp;
    const long long node_entries = (long long)n * n_bins * S;

    const size_t count_smem = (size_t)n_nodes * sizeof(int);
    const size_t scatter_smem = (size_t)PWARPS * n_nodes * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        part_count, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)count_smem);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(part_scatter,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)scatter_smem);
    if (e != cudaSuccess) return (int)e;
    part_count<<<dim3(n_pc, T), PTHREADS, count_smem, st>>>(
        node_p, w_p, stats_p, counts, m, n_nodes, S, chunk, n_pc);
    part_scan<<<T, SCAN_THREADS, 0, st>>>(counts, node_start, item_start,
                                          n_nodes, n_pc, rows_per_item);
    part_scatter<<<dim3(n_pc, T), PTHREADS, scatter_smem, st>>>(
        node_p, w_p, stats_p, counts, item_start, idx, out_p, m, n_nodes, S,
        rows_per_warp, n_pc, node_entries);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    const HistArgs a{static_cast<const int*>(bx), w_p, stats_p, idx,
                     node_start, item_start, out_p, m, n, n_nodes, n_bins, S,
                     fgs, n_fgroups, slice_len, n_slices, rows_per_item};
    const size_t smem = ((size_t)(priv ? HWARPS : 1) * J * slice_len * 32
                         + HWARPS * 32 * TILE_STRIDE) * sizeof(float);
    switch (J * 2 + (priv ? 1 : 0)) {
        case 2: e = launch_hist<1, false>(a, grid_x, T, smem, st); break;
        case 3: e = launch_hist<1, true>(a, grid_x, T, smem, st); break;
        case 4: e = launch_hist<2, false>(a, grid_x, T, smem, st); break;
        case 5: e = launch_hist<2, true>(a, grid_x, T, smem, st); break;
        case 6: e = launch_hist<3, false>(a, grid_x, T, smem, st); break;
        case 7: e = launch_hist<3, true>(a, grid_x, T, smem, st); break;
        case 8: e = launch_hist<4, false>(a, grid_x, T, smem, st); break;
        default: e = launch_hist<4, true>(a, grid_x, T, smem, st); break;
    }
    return (int)e;
}
