// node_histogram — the weighted (node, feature, bin) histogram of one tree
// level, for every tree of a forest in one launch:
//
//   out[t, p, f, b, s] = sum over rows i with node[t, i] == p and
//                        bx[i, f] == b of  w[t, i] * stats[i, s]
//
// Replaces: dislib_tpu/ops/pallas_kernels.py, node_histogram (a Pallas
// kernel that one-hot encodes each row's (node, bin) pair and contracts the
// one-hot matrix with the per-row stats on the MXU, grid (feature,
// row tile), the output block carried across row tiles).  The reference
// runs it per tree under jax.vmap; here the tree is a leading dimension.
//
// What bounds it on an H100: bytes.  At the forest's deepest level on the
// main path (16 trees, 1,000,000 x 100 rows, 2048 nodes x 32 bins x 2
// stats) the inputs are 536 MB and the output 839 MB, against ~3.2e9
// scalar adds: ~0.41 ms at 3.35 TB/s, while the adds would take a few
// microseconds of the card's arithmetic.
//
// Design (a first version that is right; the ways it is slow are listed
// below).  The one-hot GEMM was the TPU's way to reach its matrix unit; on
// Hopper a histogram is shared-memory accumulation.  The launch is a list
// of work items, each one (tree, group of features, slice of the
// per-feature (node, bin, stat) range, chunk of rows), walked by a
// grid-stride loop.  A block zeroes a histogram of the slice for each
// feature of its group in shared memory, adds each of its rows'
// w * stats[s] to it with shared atomics, and writes it out.  The host
// plans the items (ops/kernels.py, hist_plan): the slice is the whole
// per-feature range when it fits in shared memory, so shallow levels put
// many features in one block; deep levels (up to 2048 nodes, and up to 1024
// bins) split the range into slices, so any shape the estimators give fits.
// When one chunk covers every row, each output element is owned by exactly
// one item, which stores it plainly (the output need not be zeroed); with
// several chunks the items add their non-zero entries to a zeroed output
// with global atomics.
//
// Exactness.  Every sum is a sum of f32 products w * stats[s], each formed
// by one multiply as in the reference.  For classification the products
// are integers (Poisson weights x one-hot counts) and every partial sum
// stays below 2^24, so the atomics' order does not matter and the result
// is bit-equal to the plain scatter.  A product that is +0 or -0 is
// skipped: the sums start at +0, and adding a zero of either sign to a sum
// leaves its bits unchanged (a NaN or inf product is not zero and is
// added).  Rows whose node or bin is out of range are dropped.
//
// What this version pays for its simplicity:
//  - every item re-reads node and w of its whole row chunk, and a slice
//    uses only the rows whose node falls in it: at the deepest level each
//    row is visited once per (feature, slice), from L2 for the most part;
//  - a row's bins are read with a stride of n * 4 bytes (one 32-byte
//    sector per 4 useful bytes); with many features per item the rest of
//    the sector is used from L1, with one feature per item only the items
//    of neighbouring features, running at the same time, share it in L2;
//  - at the first levels every row of a tree hits one node's bins, so the
//    shared atomics of a warp collide.
// Sorting the rows by node so that an item reads only its own rows, and
// privatised sub-histograms against the collisions, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
node_histogram_kernel(const int* __restrict__ node, const int* __restrict__ bx,
                      const float* __restrict__ w,
                      const float* __restrict__ stats, float* __restrict__ out,
                      int T, int m, int n, int n_nodes, int n_bins, int S,
                      int fg, int slice_len, int n_slices, int n_fgroups,
                      int n_chunks, int rows_per_chunk, int direct) {
    extern __shared__ float hist[];   // [feature of the group][slice entry]

    const long long nbS = (long long)n_bins * S;        // one node's entries
    const long long per_feat = (long long)n_nodes * nbS;
    const long long items = (long long)T * n_chunks * n_slices * n_fgroups;

    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        // feature group fastest: items that run together share a tree's
        // node and w and neighbouring columns of bx in L2
        long long r = item;
        const int fgi = (int)(r % n_fgroups); r /= n_fgroups;
        const int sl = (int)(r % n_slices); r /= n_slices;
        const int ch = (int)(r % n_chunks); r /= n_chunks;
        const int t = (int)r;

        const int f0 = fgi * fg;
        const int nf = min(fg, n - f0);
        const long long c0 = (long long)sl * slice_len;
        const int clen = (int)min((long long)slice_len, per_feat - c0);
        const int size = nf * clen;
        // nodes whose entries meet [c0, c0 + clen)
        const int p_lo = (int)(c0 / nbS);
        const int p_hi = (int)((c0 + clen - 1) / nbS);

        for (int k = threadIdx.x; k < size; k += THREADS) hist[k] = 0.f;
        __syncthreads();

        const long long r0 = (long long)ch * rows_per_chunk;
        const long long r1 = min((long long)m, r0 + rows_per_chunk);
        const int* node_t = node + (long long)t * m;
        const float* w_t = w + (long long)t * m;
        for (long long i = r0 + threadIdx.x; i < r1; i += THREADS) {
            const int p = node_t[i];
            if (p < p_lo || p > p_hi) continue;      // also drops p < 0
            const float wt = w_t[i];
            const long long base = (long long)p * nbS - c0;
            const int* bxi = bx + i * n + f0;
            const float* st = stats + i * S;
            for (int s = 0; s < S; ++s) {
                const float c = wt * st[s];
                if (c == 0.f) continue;
                for (int f = 0; f < nf; ++f) {
                    const int b = bxi[f];
                    if ((unsigned)b >= (unsigned)n_bins) continue;
                    const long long q = base + (long long)b * S + s;
                    if (q >= 0 && q < clen)
                        atomicAdd(&hist[f * clen + (int)q], c);
                }
            }
        }
        __syncthreads();

        // out[t, p, f0 + f, b, s]: consecutive entries of one node are
        // consecutive in memory (n_bins * S floats), so the writes coalesce
        for (int k = threadIdx.x; k < size; k += THREADS) {
            const int f = k / clen;
            const long long e = c0 + (k - f * clen);
            const long long p = e / nbS;
            const long long g = (((long long)t * n_nodes + p) * n + f0 + f)
                                * nbS + (e - p * nbS);
            const float v = hist[k];
            if (direct)
                out[g] = v;
            else if (v != 0.f)
                atomicAdd(out + g, v);
        }
        __syncthreads();    // hist is zeroed again by the next item
    }
}

}  // namespace

// C entry point, bound with ctypes.  node (T, m) int32, bx (m, n) int32,
// w (T, m) float32, stats (m, S) float32, all row-major and contiguous;
// out (T, n_nodes, n, n_bins, S) float32, allocated by the caller, zeroed
// unless direct != 0.  The plan (fg .. direct) comes from the caller and
// needs fg * slice_len * 4 bytes of shared memory per block.  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int dslib_node_histogram_f32(
        const void* node, const void* bx, const void* w, const void* stats,
        void* out, int T, int m, int n, int n_nodes, int n_bins, int S,
        int fg, int slice_len, int n_slices, int n_fgroups, int n_chunks,
        int rows_per_chunk, int direct, void* stream) {
    const long long items =
        (long long)T * n_chunks * n_slices * n_fgroups;
    if (items <= 0 || m <= 0) return 0;
    const size_t smem = (size_t)fg * slice_len * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        node_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)(items < 0x7fffffffLL ? items
                                                          : 0x7fffffffLL);
    node_histogram_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const int*>(node), static_cast<const int*>(bx),
        static_cast<const float*>(w), static_cast<const float*>(stats),
        static_cast<float*>(out), T, m, n, n_nodes, n_bins, S, fg, slice_len,
        n_slices, n_fgroups, n_chunks, rows_per_chunk, direct);
    return (int)cudaGetLastError();
}
