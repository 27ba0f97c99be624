// The VQ quantizer's nearest-code search and its EMA sums, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the quantizer to XLA
// (midi_vae_tpu/models/vq.py). Run eagerly on the card, the same
// arithmetic is six passes over an [N, K] matrix (the f64 cross term, its
// f32 copy, 2·cross, the two norm terms, the argmin), ~12 GiB of traffic a
// call at N = 524,288 and K = 512, to produce N indices; then the code
// gather and two scatter-adds of float atomics for the EMA counts and sums.
//
// What bounds it: 2·N·K·D f64 operations (8.6 GFLOP at N = 524,288, K = 512,
// D = 16) against a few bytes a vector, so the f64 units, once [N, K]
// never leaves the chip. The design:
//
// - vq_search_kernel: persistent blocks of 8 warps walk tiles of 256
//   vectors, 32 a warp. A block holds a tile of the codebook in shared
//   memory as f64, laid out as the tensor cores' B fragments, with the
//   codes' squared norms (f32) beside it; for K = 512 and D = 16 the whole
//   codebook is one tile, loaded once per block. A tile holds as many codes
//   as fit 110 KB with the statistics' block sums, so that two blocks share
//   an SM; larger codebooks loop over code tiles. A warp keeps its 32
//   vectors in registers as f64 A fragments (16 dimensions at a time) and
//   forms the cross terms of each 8 codes with f64 tensor-core products
//   (mma.sync m16n8k16, Hopper's full-rate f64 shape: each product of two
//   f32 values is exact in f64, the sums are f64). Each lane rounds its cross terms to f32 and forms the
//   distance as the plain version forms it, (‖z‖² − 2·cross) + ‖e‖², every
//   step an IEEE f32 operation (no contraction); ‖z‖² and ‖e‖² come in from
//   the caller, computed by the plain version's own expressions. A lane
//   sees a fixed quarter of the codes, in increasing order, and keeps the
//   first of its least distances; the four lanes of a vector then agree on
//   the least distance, the smaller index on a tie, a NaN before any
//   number, as torch.argmin orders them. The epilogue writes the index
//   (int64) and z_q = codebook[index] (f32).
// - In training the same pass sums the EMA statistics: each vector adds
//   one and its f32 values into its code's row [D + 1] (count, then the D
//   sums) of the block's sums in shared memory, with shared-memory atomics
//   (the four lanes of a vector take a quarter of its dimensions each), and
//   the block writes its rows into its row [K, D + 1] of a partial buffer
//   at its end. Where the block's rows do not fit 36 KB, they are summed a
//   band of codes at a time, a tile at a time, into the partial row. No
//   global float atomics; the order of the shared ones varies from run to
//   run, so the sums are the same up to f32 reordering, as the plain
//   version's index_add_ is.
// - vq_code_sums_kernel sums the partial rows over the blocks in a fixed
//   order (eight warps, then the eight in order) into [K, D + 1]. The
//   counts are whole numbers below 2^24 and come out exact.
//
// No host synchronisation, no allocation (the caller gives every buffer),
// launches on the caller's stream: the kernels can be captured in a CUDA
// graph. Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMB = 4;                 // 8-vector row blocks a warp holds (two 16-row blocks of A)
constexpr int kVT = kWarps * kMB * 8;  // vectors a block tile covers (a warp: 32)
constexpr int kKS = 4;                 // k-steps of 4 dimensions held in registers at once
constexpr int kDC = 4 * kKS;           // dimensions held in registers at once
constexpr int kPartBudget = 36 * 1024;   // shared memory of the statistics' block sums
constexpr int kSmemBudget = 110 * 1024;  // dynamic shared memory a block, so that two share an SM
constexpr int kNone = 0x7fffffff;        // no code yet
constexpr int kSumCols = 32;             // columns a block of the sums kernel covers
constexpr int kSumWarps = 8;

struct Plan {
    int dpad;  // D rounded up to kDC
    int kt;    // codes a shared tile holds (a multiple of 8)
    int n_ct;  // code tiles
    int pc;    // codes whose sums shared memory holds at once
    int smem;  // dynamic shared memory, bytes
};

int round_up(int a, int b) { return (a + b - 1) / b * b; }

Plan plan(int k, int d) {
    Plan p;
    p.dpad = round_up(d, kDC);
    const int row_bytes = (d + 1) * 4;
    p.pc = k * row_bytes <= kPartBudget ? k : kPartBudget / row_bytes;
    const int fit = (kSmemBudget - p.pc * row_bytes) / (p.dpad * 8 + 4) / 8 * 8;
    p.kt = round_up(k, 8) < fit ? round_up(k, 8) : fit;
    p.n_ct = p.kt > 0 ? (k + p.kt - 1) / p.kt : 0;
    p.smem = p.kt * p.dpad * 8 + p.kt * 4 + p.pc * row_bytes;
    return p;
}

// D[16x8] += A[16x16] B[16x8] in f64 on the tensor cores, a shape sm_90 adds (the search ran ~20 % slower on
// m8n8k4). With g = lane / 4 and t = lane % 4, lane l holds A[g + 8 (i % 2)][t + 4 (i / 2)] in a[i],
// B[t + 4 j][g] in b[j] and D[g + 8 (i / 2)][2 t + i % 2] in acc[i].
__device__ __forceinline__ void dmma(double (&acc)[4], const double (&a)[8], const double (&b)[4]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
        : "+d"(acc[0]), "+d"(acc[1]), "+d"(acc[2]), "+d"(acc[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
          "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Whether (da, ia) goes before (db, ib) in torch.argmin's order: a NaN first, then the smaller, then the smaller index.
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
    const bool na = isnan(da), nb = isnan(db);
    if (na != nb) return na;
    if (da < db) return true;
    if (db < da) return false;
    return ia < ib;
}

__device__ __forceinline__ void load_codes(const float* __restrict__ cb, const float* __restrict__ ee, int k, int d,
                                           int dpad, int kt, int first, double* s_b, float* s_ee) {
    // code-major reads (coalesced); stored as B fragments: code c, dimension j at ((c / 8) k-steps + j / 4) 32 +
    // (c % 8) 4 + j % 4, so that a lane's value of one k-step of one 8-code block is one of 32 consecutive
    // doubles; zeros past K and past D
    const int ks = dpad / 4;
    for (int i = threadIdx.x; i < kt * dpad; i += kThreads) {
        const int c = i / dpad, j = i - c * dpad;
        const int code = first + c;
        const float v = (code < k && j < d) ? cb[static_cast<size_t>(code) * d + j] : 0.0f;
        s_b[((c >> 3) * ks + (j >> 2)) * 32 + ((c & 7) << 2) + (j & 3)] = static_cast<double>(v);
    }
    for (int c = threadIdx.x; c < kt; c += kThreads) s_ee[c] = first + c < k ? ee[first + c] : 0.0f;
}

__global__ void __launch_bounds__(kThreads, 2)
vq_search_kernel(const float* __restrict__ z, const float* __restrict__ cb, const float* __restrict__ zz,
                 const float* __restrict__ ee, int64_t n, int k, int d, int dpad, int kt, int n_ct, int pc,
                 int64_t* __restrict__ idx_out, float* __restrict__ zq, float* __restrict__ partials) {
    extern __shared__ __align__(16) unsigned char smem[];
    double* s_b = reinterpret_cast<double*>(smem);
    float* s_ee = reinterpret_cast<float*>(s_b + static_cast<size_t>(kt) * dpad);
    float* s_part = s_ee + kt;  // [pc, D + 1]: this block's counts and sums of codes lo .. lo + pc
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
    const int ks_all = dpad / 4;
    const int row = d + 1;
    float* part = partials == nullptr ? nullptr : partials + static_cast<size_t>(blockIdx.x) * k * row;
    const bool whole = pc == k;  // the block's sums stay in shared memory until its last tile
    if (part != nullptr) {
        for (int i = t; i < pc * row; i += kThreads) s_part[i] = 0.0f;
        if (!whole) {
            for (int i = t; i < k * row; i += kThreads) part[i] = 0.0f;
        }
    }
    if (n_ct == 1) load_codes(cb, ee, k, d, dpad, kt, 0, s_b, s_ee);
    __syncthreads();

    const int64_t n_tiles = (n + kVT - 1) / kVT;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int64_t base = tile * kVT;
        // this lane's vectors: row g of each of the warp's row blocks
        int64_t v[kMB];
        float zzv[kMB], best[kMB];
        int bi[kMB];
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb) {
            v[mb] = base + warp * 32 + mb * 8 + g;
            zzv[mb] = v[mb] < n ? zz[v[mb]] : 0.0f;
            best[mb] = __int_as_float(0x7f800000);
            bi[mb] = kNone;
        }
        // A fragments of two 16-row blocks: a[m][i] is dimension t + 4 (i / 2) of vector v[2 m + i % 2]
        double a[kMB / 2][2 * kKS];
        auto load_a = [&](int s0) {  // dimensions 4 s0 .. 4 s0 + 16
#pragma unroll
            for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
                for (int s = 0; s < kKS; ++s) {
                    const int col = (s0 + s) * 4 + q;
                    a[mb / 2][2 * s + mb % 2] = (v[mb] < n && col < d) ? static_cast<double>(z[v[mb] * d + col]) : 0.0;
                }
        };
        if (ks_all == kKS) load_a(0);

        for (int ct = 0; ct < n_ct; ++ct) {
            const int first = ct * kt;
            if (n_ct > 1) {
                __syncthreads();
                load_codes(cb, ee, k, d, dpad, kt, first, s_b, s_ee);
                __syncthreads();
            }
            const int kc = k - first < kt ? k - first : kt;
            for (int nb = 0; nb < (kc + 7) / 8; ++nb) {
                double acc[kMB / 2][4];  // acc[m][2 h + i]: vector v[2 m + h], code 2 q + i of the block
#pragma unroll
                for (int m = 0; m < kMB / 2; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.0;
                const double* bp = s_b + static_cast<size_t>(nb) * ks_all * 32 + lane;
                for (int s0 = 0; s0 < ks_all; s0 += kKS) {
                    if (ks_all != kKS) load_a(s0);
                    double b[kKS];
#pragma unroll
                    for (int s = 0; s < kKS; ++s) b[s] = bp[(s0 + s) * 32];
#pragma unroll
                    for (int m = 0; m < kMB / 2; ++m) dmma(acc[m], a[m], b);
                }
                // this lane's two codes of the block: 2 q and 2 q + 1
                const float2 e2 = *reinterpret_cast<const float2*>(s_ee + nb * 8 + 2 * q);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int code = first + nb * 8 + 2 * q + i;
                    if (code < k) {
                        const float e = i == 0 ? e2.x : e2.y;
#pragma unroll
                        for (int mb = 0; mb < kMB; ++mb) {
                            const float cross = __double2float_rn(acc[mb / 2][2 * (mb % 2) + i]);
                            const float dist = __fadd_rn(__fsub_rn(zzv[mb], __fmul_rn(2.0f, cross)), e);
                            // codes come in increasing order: the first is taken, then only what goes before
                            if (bi[mb] == kNone || dist < best[mb] || (isnan(dist) && !isnan(best[mb]))) {
                                best[mb] = dist;
                                bi[mb] = code;
                            }
                        }
                    }
                }
            }
        }

        // the four lanes of a row hold the best of codes ≡ 2q, 2q + 1 (mod 8): the row's best, in all four
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                const float od = __shfl_xor_sync(0xffffffffu, best[mb], off);
                const int oi = __shfl_xor_sync(0xffffffffu, bi[mb], off);
                if (before(od, oi, best[mb], bi[mb])) {
                    best[mb] = od;
                    bi[mb] = oi;
                }
            }
            if (v[mb] < n) {
                if (q == 0) idx_out[v[mb]] = bi[mb];
                const float* src = cb + static_cast<size_t>(bi[mb]) * d;
                float* dst = zq + v[mb] * d;
                for (int j = q; j < d; j += 4) dst[j] = src[j];
            }
        }

        if (part != nullptr) {
            // each vector adds one and its values into its code's row with shared-memory atomics: lane q of its
            // four adds dimensions q, q + 4, ..., and lane 0 the one
            for (int lo = 0; lo < k; lo += pc) {
#pragma unroll
                for (int mb = 0; mb < kMB; ++mb) {
                    if (v[mb] >= n || bi[mb] < lo || bi[mb] >= lo + pc) continue;
                    float* dst = s_part + (bi[mb] - lo) * row;
                    if (q == 0) atomicAdd(dst, 1.0f);
                    if (ks_all == kKS) {  // the A fragments hold the values
#pragma unroll
                        for (int s = 0; s < kKS; ++s) {
                            const float value = static_cast<float>(a[mb / 2][2 * s + mb % 2]);
                            if (4 * s + q < d) atomicAdd(dst + 1 + 4 * s + q, value);
                        }
                    } else {
                        for (int j = q; j < d; j += 4) atomicAdd(dst + 1 + j, z[v[mb] * d + j]);
                    }
                }
                if (!whole) {  // this pass's codes into the block's rows, then zero again
                    __syncthreads();
                    for (int i = t; i < (k - lo < pc ? k - lo : pc) * row; i += kThreads) {
                        part[static_cast<size_t>(lo) * row + i] += s_part[i];
                        s_part[i] = 0.0f;
                    }
                    __syncthreads();
                }
            }
        }
    }
    if (part != nullptr && whole) {
        __syncthreads();
        for (int i = t; i < k * row; i += kThreads) part[i] = s_part[i];
    }
}

__global__ void __launch_bounds__(kSumCols * kSumWarps)
vq_code_sums_kernel(const float* __restrict__ partials, int blocks, int cols, float* __restrict__ out) {
    __shared__ float s[kSumWarps][kSumCols];
    const int lane = threadIdx.x % kSumCols, w = threadIdx.x / kSumCols;
    const int col = blockIdx.x * kSumCols + lane;
    float acc = 0.0f;
    if (col < cols) {
        for (int g = w; g < blocks; g += kSumWarps) acc += partials[static_cast<size_t>(g) * cols + col];
    }
    s[w][lane] = acc;
    __syncthreads();
    if (w == 0 && col < cols) {
        float total = 0.0f;
        for (int i = 0; i < kSumWarps; ++i) total += s[i][lane];
        out[col] = total;
    }
}

int use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
    return static_cast<int>(err);
}

}  // namespace

// The C interface the Python wrapper calls through ctypes.

// How many blocks of the search for K codes of dimension d the device holds at once, and the vectors a block's
// tile covers. Writes 0 blocks when the shape does not fit (a code tile of 8 codes needs more than the
// shared-memory budget).
extern "C" int vq_search_capacity(int k, int d, int device, int* blocks, int* tile) {
    *blocks = 0;
    *tile = kVT;
    if (const int err = use_device(device)) return err;
    const Plan p = plan(k, d);
    if (p.kt < 8) return 0;
    cudaError_t err = cudaFuncSetAttribute(vq_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vq_search_kernel, kThreads, p.smem);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    *blocks = per_sm * sms;
    return 0;
}

// idx [n] int64 and zq [n, d] f32 always; partials [blocks, k, d + 1] f32 in training, else null.
extern "C" int vq_search(const float* z, const float* cb, const float* zz, const float* ee, long long n, int k, int d,
                         long long* idx, float* zq, float* partials, int blocks, int device, void* stream) {
    if (const int err = use_device(device)) return err;
    const Plan p = plan(k, d);
    cudaError_t err = cudaFuncSetAttribute(vq_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    vq_search_kernel<<<blocks, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
        z, cb, zz, ee, n, k, d, p.dpad, p.kt, p.n_ct, p.pc, reinterpret_cast<int64_t*>(idx), zq, partials);
    return static_cast<int>(cudaGetLastError());
}

// out [k, d + 1] f32: the partial rows summed over the blocks, in block order by eight warps, then in warp order.
extern "C" int vq_code_sums(const float* partials, int blocks, int k, int d, float* out, int device, void* stream) {
    if (const int err = use_device(device)) return err;
    const int cols = k * (d + 1);
    vq_code_sums_kernel<<<(cols + kSumCols - 1) / kSumCols, kSumCols * kSumWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(partials, blocks, cols, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vq_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
