// Forward-only flash attention, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sige_tpu/ops/flash.py:_fwd_kernel
// (launched by flash_mha_bhsd). It computes the same function:
//
//   out[b, n, h, :] = softmax_m(scale * q[b, n, h, :] . k[b, m, h, :] + bias[m])
//                     . v[b, :, h, :]
//
// with an online softmax that keeps the running max and sum of every
// query row in fp32 (running max starts at -1e30, as on the TPU), the P.V
// product accumulated in fp32, and one division by the row sum at the
// end. bias is an optional fp32 additive key bias [R, M] (0 / -1e9:
// ragged-KV padding and the masked stale/fresh K/V form): R = 1 shares one
// row with every (b, h); R = S gives each of S sessions of B / S batch
// rows its own, batch row b reading row b / (B / R) (a plan stacked over
// sessions lays out its batch as S blocks of B / S samples).
//
// Two attention kernels share that contract, chosen by the head dim D:
// flash_fwd_f32_tc for every D that is a multiple of 8 up to 256 (the
// U-Nets' 40, 64, 80 and 160), flash_fwd_f32 for the rest (D = 512: the
// DDPM U-Net, the VAE). Both cut the key range into tiles staged with
// cp.async and, when the grid of query blocks is smaller than the card,
// into `splits` contiguous runs of whole tiles (split-KV, flash-decoding):
// a block of a split writes its unnormalised partial O and its rows' max
// and sum to scratch the wrapper allocated, and flash_combine_f32 rescales
// the partials by exp(m_s - max_s m_s) and divides by the rescaled sum.
// With one split the attention kernel normalises and writes the output.
//
// flash_fwd_f32_tc: both inner products on the tensor cores in split TF32.
// The work is 4*N*M*D flops on a few MB, far above the ridge, so the
// tensor cores bound it. Plain TF32 (10 mantissa bits) misses fp32 by
// ~1e-3 on the U-Nets' outputs, so every fp32 operand x is split into
// big = tf32(x) and small = tf32(x - big) (3xTF32), and each product is
// a.small * b.big + a.big * b.small + a.big * b.big, the small terms
// first, into fp32 accumulators: the dropped small * small and the
// rounding of small are ~2^-22 of |x|, fp32's own order. Three products
// a tile put the ceiling at 495 / 3 = 165 TFLOP/s; the warp-level
// mma.sync used here issues TF32 at about 319 TFLOP/s on an H100 SXM (a
// third below wgmma's rate), 106 at three products; below that, the split
// values double the shared-memory reads of every fragment, and the
// softmax's expf, the rescales and the splits run on the SIMT units. The
// design:
//
//  * Four warps, each owning 16 query rows (two m16 tiles of 16 at
//    D <= 64, so every K or V fragment it reads feeds two products),
//    mma.sync.m16n8k8 TF32 tiles, fp32 accumulators in registers: S for
//    the warp's rows and the tile's keys, O for its rows and all of D.
//  * The tensor cores add into an accumulator with truncation, so a chain
//    of thousands of products into one drifts toward zero (5e-5 of the
//    output over a 4996-key range). No chain is longer than 4 k8 steps
//    (12 products): S sums D in such chains, and each tile's P.V goes
//    into fresh accumulators, added to O (rescaled) in fp32 FFMA.
//  * Split once, not once per product: q when it lands (once a block),
//    each K and V tile when it lands, P in registers once a tile. Each
//    thread splits the 16-byte chunks it copied itself, right after its
//    cp.async.wait_all (big over the raw values, small into a second
//    plane), so a tile takes two barriers, as the SIMT kernel's does. The
//    m16n8k8 A fragment wants keys t and t+4 where S's accumulators hold
//    keys 2t and 2t+1: the P.V product takes the tile's keys in that
//    order, and reads V's rows in the same one.
//  * One instantiation per head width 40, 64, 80, 128, 160 and 256 (a
//    narrower D zero-filled to the next): rows of width + 4 floats, so
//    every shared-memory offset is a constant and the fragment reads of q,
//    K (rows g, columns t) and V (rows 2t, columns g) are free of bank
//    conflicts; 2 to 3 blocks an SM at widths up to 80.
//  * The same staging as the SIMT kernel: V[t] lands while S(t) computes,
//    K[t+1] while P.V(t) computes, 32-key tiles (16 at D > 160, where q,
//    K and V's two planes take 195 KB of shared memory at D = 256).
//
// flash_fwd_f32 (the SIMT kernel, D not a multiple of 8 or above 256).
// The fp32 FMA rate of the SIMT units bounds it once the card is full. At
// the DDPM main path's shapes (one head, D = 512, N = M = 256 or 64) the
// card is not full: with 16 query rows per block only ceil(N/16) blocks
// exist, one per SM (the tiles take ~188 KB of shared memory at D = 512),
// so split-KV fills the SMs (8 splits at N = M = 256: 128 blocks of one
// tile each). Each 16-byte cp.async of a tile is issued before any is
// waited on, and each of the one K and one V buffer is refilled only
// after the barrier that ends its last read; rows past M (and query rows
// past N) are zero-filled by cp.async with a source size of 0, never
// read. Eight warps: for S, the reduction over D is split across the
// warps and each lane sums a 4-row x 4-key tile, so every float4 it reads
// from shared memory feeds four rows or keys; the warps' partial tiles
// are summed through shared memory. Softmax: a warp owns 2 rows, a lane a
// key; the row max is a warp shuffle reduction, the row sum stays per
// lane until the end. P.V: a thread owns one float4 column of V and the
// rows slot + (256 / (D/4)) * j, reads P four keys at a time as a float4
// broadcast and keeps its accumulators in registers (8 float4 at D = 512,
// no spill). Rows are padded in shared memory so that D/4 + pad/4 is odd:
// per-lane K-row float4 reads are free of bank conflicts.
//
// The kernels allocate nothing and do not synchronise. The C entry launches
// the attention kernel and (only when the key range is split) the combine,
// and returns cudaGetLastError() so the caller can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
// kBK, kBQ and the tc_ shapes below must match block_k and block_q in
// ops/flash.py, which choose the split count from them.
constexpr int kBK = 32;         // keys per tile: one per lane in the S phase
constexpr int kBQ = 16;         // query rows per block
constexpr int kRJ = 8;          // most P.V rows a thread owns
constexpr int kLdp = kBK + 4;   // smem row stride of the P tile (float4 rows)

__host__ __device__ constexpr int smem_ld(int D) {
  return D + ((D & 4) ? 8 : 4);
}

// S's reduction over D is split across the warps; the per-warp partial S
// tiles [kWarps][kBQ][kLdr] are summed in shared memory.
constexpr int kLdr = 40;  // row stride: lanes (r, k) hit banks 8r + k
constexpr int kRedFloats = kWarps * kBQ * kLdr;

// The tensor-core kernel: four warps. Each instantiation holds heads up
// to kW wide in shared-memory rows of kW + 4 floats, every offset a
// constant; columns past D are zero-filled and computed (an exact fit for
// the U-Nets' 40, 64, 80 and 160).
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;

__host__ __device__ constexpr bool tc_head(int D) {
  return D % 8 == 0 && D <= 256;
}
__host__ __device__ constexpr int tc_width(int D) {
  return D <= 40 ? 40 : D <= 64 ? 64 : D <= 80 ? 80 : D <= 128 ? 128
       : D <= 160 ? 160 : 256;
}
// m16 row tiles per warp, query rows per block, keys per tile
__host__ __device__ constexpr int tc_mtiles(int w) { return w <= 64 ? 2 : 1; }
__host__ __device__ constexpr int tc_block_q(int w) {
  return 16 * kTcWarps * tc_mtiles(w);
}
__host__ __device__ constexpr int tc_block_k(int w) {
  return w <= 160 ? 32 : 16;
}
__host__ __device__ constexpr size_t tc_smem(int w) {
  return sizeof(float) * 2 * (tc_block_q(w) + 2 * tc_block_k(w)) * (w + 4);
}

// 16-byte asynchronous copy global -> shared; valid == false zero-fills
// the destination without reading the source.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copies of `rows` rows of D floats, global rows r0.., into dst
// (row stride ld); rows at or past r_end are zero-filled. A warp copies
// whole rows, its lanes on consecutive float4s (no division).
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int64_t sn,
                                           int r0, int r_end, int rows,
                                           int d4) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    const bool valid = r0 + r < r_end;
    const float* row = valid ? src + (r0 + r) * sn : src;
    for (int c4 = lane; c4 < d4; c4 += 32)
      cp_async16(dst + r * ld + 4 * c4, valid ? row + 4 * c4 : src, valid);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// x = big + small + O(2^-22 |x|) with big and small TF32 values. cvt.rna
// leaves the low 13 bits of its result undefined: big's are cleared for
// the subtraction; the tensor cores ignore small's.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  big &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(small)
      : "f"(x - __uint_as_float(big)));
}

// d += a . b: one m16n8k8 TF32 product with fp32 accumulators. a: rows g
// and g + 8, columns t and t + 4; b: rows t and t + 4, column g (g = lane
// / 4, t = lane % 4); d: rows g and g + 8, columns 2t and 2t + 1.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 3xTF32 product: the two small terms first, then big . big.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b)[4]) {
  mma_tf32(d, a_small, b[0], b[1]);
  mma_tf32(d, a_big, b[2], b[3]);
  mma_tf32(d, a_big, b[0], b[1]);
}

// Issue the copies of `rows` rows of D floats, global rows r0.., into dst
// (rows of kW + 4 floats); columns past D and rows at or past r_end are
// zero-filled.
template <int kW>
__device__ __forceinline__ void stage_tc_rows(float* dst, const float* src,
                                              int64_t sn, int r0, int r_end,
                                              int rows, int d4) {
  constexpr int kW4 = kW / 4;
  for (int i = threadIdx.x; i < rows * kW4; i += kTcThreads) {
    const int r = i / kW4;
    const int c4 = i - r * kW4;
    const bool valid = r0 + r < r_end && c4 < d4;
    cp_async16(dst + r * (kW + 4) + 4 * c4,
               valid ? src + (r0 + r) * sn + 4 * c4 : src, valid);
  }
}

// Split the chunks this thread staged with stage_tc_rows (the same walk of
// the tile), once cp.async.wait_all has landed them: big over the raw
// values, small into the plane `plane` floats further on. A thread reads
// only its own copies, so no barrier comes between landing and splitting.
template <int kW, int kPlane>
__device__ __forceinline__ void split_tc_rows(float* dst, int rows) {
  constexpr int kW4 = kW / 4;
  for (int i = threadIdx.x; i < rows * kW4; i += kTcThreads) {
    const int r = i / kW4;
    float* p = dst + r * (kW + 4) + 4 * (i - r * kW4);
    const float4 x = *reinterpret_cast<const float4*>(p);
    uint4 big, small;
    split_tf32(x.x, big.x, small.x);
    split_tf32(x.y, big.y, small.y);
    split_tf32(x.z, big.z, small.z);
    split_tf32(x.w, big.w, small.w);
    *reinterpret_cast<uint4*>(p) = big;
    *reinterpret_cast<uint4*>(p + kPlane) = small;
  }
}

// The tensor cores add into their accumulators with truncation, so a long
// chain of products into one accumulator drifts toward zero (5e-5 of the
// output over 157 key tiles). Every chain here is at most kChain k8 steps
// (3 * kChain products) into fresh accumulators, then added in fp32.
constexpr int kChain = 4;

template <int kW>
__global__ void __launch_bounds__(kTcThreads,
                                  (int)(232448 / tc_smem(kW)))
flash_fwd_f32_tc(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ o_part,
                 float* __restrict__ m_part, float* __restrict__ l_part,
                 int H, int N, int M, int D, int bias_div, float scale,
                 int64_t q_sb, int64_t q_sn, int64_t q_sh,
                 int64_t k_sb, int64_t k_sn, int64_t k_sh,
                 int64_t v_sb, int64_t v_sn, int64_t v_sh,
                 int64_t o_sb, int64_t o_sn, int64_t o_sh) {
  constexpr int kNT = kW / 8;    // k8 steps of S, n8 column tiles of O
  constexpr int kMT = tc_mtiles(kW);
  constexpr int BQ = tc_block_q(kW);
  constexpr int BK = tc_block_k(kW);
  constexpr int kKN = BK / 8;    // n8 key tiles of S, k8 steps of P.V
  constexpr int kNG = 8 / kMT;   // n8 column tiles of O a P.V chain holds
  constexpr int ld = kW + 4;
  constexpr int kQPlane = BQ * ld;
  constexpr int kKVPlane = BK * ld;
  static_assert(kKN <= kChain, "a tile's P.V is one chain");
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                 // [2][BQ][ld]: big, then small
  float* sk = sq + 2 * kQPlane;     // [2][BK][ld]
  float* sv = sk + 2 * kKVPlane;    // [2][BK][ld]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // fragment row (and B column)
  const int tq = lane & 3;   // fragment column (and B row)
  const int g = blockIdx.y;
  const int b = g / H;
  const int h = g - b * H;
  const int n0 = blockIdx.x * BQ;
  const int d4 = D >> 2;
  const int split = blockIdx.z;
  const int tiles = (M + BK - 1) / BK;
  const int t_begin = (int)((int64_t)split * tiles / gridDim.z);
  const int t_end = (int)((int64_t)(split + 1) * tiles / gridDim.z);

  const float* qg = q + b * q_sb + h * q_sh;
  const float* kg = k + b * k_sb + h * k_sh;
  const float* vg = v + b * v_sb + h * v_sh;
  // this batch row's key bias: row b / bias_div of [R, M]
  const float* kbias =
      bias == nullptr ? nullptr : bias + (int64_t)(b / bias_div) * M;

  stage_tc_rows<kW>(sq, qg, q_sn, n0, N, BQ, d4);
  stage_tc_rows<kW>(sk, kg, k_sn, t_begin * BK, M, BK, d4);
  cp_async_wait_all();
  split_tc_rows<kW, kQPlane>(sq, BQ);

  // the warp's rows: wr + 16 * mt + gr (+ 8 for accumulator half 1)
  const int wr = 16 * kMT * warp;
  const float* qf = sq + (wr + gr) * ld + tq;  // q fragments, big plane
  const float* kf = sk + gr * ld + tq;         // K fragments, big plane
  const float* vf = sv + 2 * tq * ld + gr;     // V fragments, big plane
  float o[kMT][kNT][4];
  float m_run[kMT][2];
  float l_thr[kMT][2];  // this thread's share of each row sum
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_run[mt][hh] = -1e30f;
      l_thr[mt][hh] = 0.f;
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    cp_async_wait_all();
    split_tc_rows<kW, kKVPlane>(sk, BK);
    __syncthreads();  // split q and K[t] visible; the last P.V is done with sv
    stage_tc_rows<kW>(sv, vg, v_sn, k0, M, BK, d4);

    // S = q . K^T: the warp's rows x the tile's keys, in chains of kChain
    // k8 steps over the head
    float s[kMT][kKN][4];
#pragma unroll
    for (int c0 = 0; c0 < kNT; c0 += kChain) {
      float acc[kMT][kKN][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kKN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
      for (int ks = c0; ks < c0 + kChain && ks < kNT; ++ks) {
        uint32_t a_big[kMT][4], a_small[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const float* qr = qf + 16 * mt * ld + 8 * ks;
          a_big[mt][0] = __float_as_uint(qr[0]);
          a_big[mt][1] = __float_as_uint(qr[8 * ld]);
          a_big[mt][2] = __float_as_uint(qr[4]);
          a_big[mt][3] = __float_as_uint(qr[8 * ld + 4]);
          a_small[mt][0] = __float_as_uint(qr[kQPlane]);
          a_small[mt][1] = __float_as_uint(qr[kQPlane + 8 * ld]);
          a_small[mt][2] = __float_as_uint(qr[kQPlane + 4]);
          a_small[mt][3] = __float_as_uint(qr[kQPlane + 8 * ld + 4]);
        }
#pragma unroll
        for (int j = 0; j < kKN; ++j) {
          const float* kr = kf + 8 * j * ld + 8 * ks;
          const uint32_t bk[4] = {
              __float_as_uint(kr[0]), __float_as_uint(kr[4]),
              __float_as_uint(kr[kKVPlane]), __float_as_uint(kr[kKVPlane + 4])};
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            mma_3xtf32(acc[mt][j], a_big[mt], a_small[mt], bk);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kKN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][j][e] = c0 == 0 ? acc[mt][j][e] : s[mt][j][e] + acc[mt][j][e];
    }

    // online softmax; this thread's keys are k0 + 8j + 2tq + e
    float kb[kKN][2];
    bool live[kKN][2];
#pragma unroll
    for (int j = 0; j < kKN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * tq + e;
        live[j][e] = key < M;
        kb[j][e] = (live[j][e] && kbias != nullptr) ? kbias[key] : 0.f;
      }
    float alpha[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // ragged edge: keys past M get probability exactly 0
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kKN; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][j][2 * hh + e];
            x = live[j][e] ? fmaf(x, scale, kb[j][e]) : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[mt][hh], mx);
        alpha[mt][hh] = expf(m_run[mt][hh] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKN; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][j][2 * hh + e];
            x = expf(x - m_new);
            sum += x;
          }
        l_thr[mt][hh] = fmaf(l_thr[mt][hh], alpha[mt][hh], sum);
        m_run[mt][hh] = m_new;
      }
    // P split once; the k8 step kk takes keys 8kk + (0, 2, 4, 6, 1, 3, 5,
    // 7), so P's accumulators are its A fragment as they lie
    uint32_t p_big[kMT][kKN][4], p_small[kMT][kKN][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int kk = 0; kk < kKN; ++kk) {
        split_tf32(s[mt][kk][0], p_big[mt][kk][0], p_small[mt][kk][0]);
        split_tf32(s[mt][kk][2], p_big[mt][kk][1], p_small[mt][kk][1]);
        split_tf32(s[mt][kk][1], p_big[mt][kk][2], p_small[mt][kk][2]);
        split_tf32(s[mt][kk][3], p_big[mt][kk][3], p_small[mt][kk][3]);
      }

    cp_async_wait_all();
    split_tc_rows<kW, kKVPlane>(sv, BK);
    __syncthreads();  // split V[t] visible; every warp is done with sk
    if (t + 1 < t_end) stage_tc_rows<kW>(sk, kg, k_sn, k0 + BK, M, BK, d4);

    // O = alpha O + P . V[t], kNG column tiles at a time: one chain of
    // kKN k8 steps each
#pragma unroll
    for (int n8 = 0; n8 < kNT; n8 += kNG) {
      float acc[kMT][kNG][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int ng = 0; ng < kNG; ++ng)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][ng][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKN; ++kk)
#pragma unroll
        for (int ng = 0; ng < kNG && n8 + ng < kNT; ++ng) {
          const float* vc = vf + 8 * kk * ld + 8 * (n8 + ng);
          const uint32_t bv[4] = {
              __float_as_uint(vc[0]), __float_as_uint(vc[ld]),
              __float_as_uint(vc[kKVPlane]), __float_as_uint(vc[kKVPlane + ld])};
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            mma_3xtf32(acc[mt][ng], p_big[mt][kk], p_small[mt][kk], bv);
        }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int ng = 0; ng < kNG && n8 + ng < kNT; ++ng)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[mt][n8 + ng][e] = fmaf(o[mt][n8 + ng][e], alpha[mt][e >> 1],
                                     acc[mt][ng][e]);
    }
  }

  const int nd = D >> 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_thr[mt][hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int n = n0 + wr + 16 * mt + 8 * hh + gr;
      if (n >= N) continue;
      if (o_part == nullptr) {
        float* orow = out + b * o_sb + h * o_sh + n * o_sn + 2 * tq;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          if (nt < nd)
            *reinterpret_cast<float2*>(orow + 8 * nt) = make_float2(
                o[mt][nt][2 * hh] / l, o[mt][nt][2 * hh + 1] / l);
      } else {
        // scratch [splits, G, N, D] and [splits, G, N]
        const int64_t pr = ((int64_t)split * gridDim.y + g) * N + n;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          if (nt < nd)
            *reinterpret_cast<float2*>(o_part + pr * D + 8 * nt + 2 * tq) =
                make_float2(o[mt][nt][2 * hh], o[mt][nt][2 * hh + 1]);
        if (tq == 0) {
          m_part[pr] = m_run[mt][hh];
          l_part[pr] = l;
        }
      }
    }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              float* __restrict__ out, float* __restrict__ o_part,
              float* __restrict__ m_part, float* __restrict__ l_part,
              int H, int N, int M, int D, int bias_div, float scale,
              int64_t q_sb, int64_t q_sn, int64_t q_sh,
              int64_t k_sb, int64_t k_sn, int64_t k_sh,
              int64_t v_sb, int64_t v_sn, int64_t v_sh,
              int64_t o_sb, int64_t o_sn, int64_t o_sh) {
  constexpr int BQ = kBQ;
  constexpr int RJ = kRJ;
  constexpr int RW = BQ / kWarps;  // S-phase query rows per warp
  extern __shared__ __align__(16) float smem[];
  const int ld = smem_ld(D);
  float* sq = smem;                // [BQ][ld]
  float* sk = sq + BQ * ld;        // [kBK][ld]
  float* sv = sk + kBK * ld;       // [kBK][ld]
  float* sp = sv + kBK * ld;       // [BQ][kLdp]  P of the current tile
  float* salpha = sp + BQ * kLdp;  // [BQ]  rescale of the current tile
  float* sl = salpha + BQ;         // [BQ]  final row sums
  float* sm = sl + BQ;             // [BQ]  final row maxima
  float* sred = sm + BQ;           // kRedFloats: partial S per warp

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = blockIdx.y;
  const int b = g / H;
  const int h = g - b * H;
  const int n0 = blockIdx.x * BQ;
  const int d4 = D >> 2;
  const int split = blockIdx.z;
  const int tiles = (M + kBK - 1) / kBK;
  const int t_begin = (int)((int64_t)split * tiles / gridDim.z);
  const int t_end = (int)((int64_t)(split + 1) * tiles / gridDim.z);

  const float* qg = q + b * q_sb + h * q_sh;
  const float* kg = k + b * k_sb + h * k_sh;
  const float* vg = v + b * v_sb + h * v_sh;
  // this batch row's key bias: row b / bias_div of [R, M]
  const float* kbias =
      bias == nullptr ? nullptr : bias + (int64_t)(b / bias_div) * M;

  stage_rows(sq, ld, qg, q_sn, n0, N, BQ, d4);
  stage_rows(sk, ld, kg, k_sn, t_begin * kBK, M, kBK, d4);

  // P.V layout: float4 column c4, rows slot + rg * j (slot >= rg: idle)
  const int rg = kThreads / d4;
  const int c4 = tid % d4;
  const int slot = tid / d4;

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc[RJ];
#pragma unroll
  for (int j = 0; j < RJ; ++j) acc[j] = zero4;
  float m_run[RW];
  float l_lane[RW];  // this lane's share of each row sum
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m_run[r] = -1e30f;
    l_lane[r] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    cp_async_wait_all();
    __syncthreads();  // K[t] (and q) in; the previous P.V is done with sv, sp
    stage_rows(sv, ld, vg, v_sn, k0, M, kBK, d4);

    // S for rows RW*warp + r, key k0 + lane. Warp w sums the float4
    // columns w, w + 8, ... of all 16 x 32 logits; lane (rq, kq) holds
    // rows rq + 4i and keys kq + 8j, so each q or K float4 it loads feeds
    // four rows or keys (8 loads, one wavefront each, per 64 FMA). Then
    // the 8 warps' tiles are summed through shared memory.
    float s[RW];
    {
      const int rq = lane >> 3;
      const int kq = lane & 7;
      float part[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll 2
      for (int c = 4 * warp; c < D; c += 4 * kWarps) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(sq + (rq + 4 * i) * ld + c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(sk + (kq + 8 * j) * ld + c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            part[i][j] = fmaf(qv[i].x, kv[j].x, part[i][j]);
            part[i][j] = fmaf(qv[i].y, kv[j].y, part[i][j]);
            part[i][j] = fmaf(qv[i].z, kv[j].z, part[i][j]);
            part[i][j] = fmaf(qv[i].w, kv[j].w, part[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sred[(warp * BQ + rq + 4 * i) * kLdr + kq + 8 * j] = part[i][j];
      __syncthreads();  // every warp's partial tile is written
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        float acc_s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          acc_s += sred[(w * BQ + RW * warp + r) * kLdr + lane];
        s[r] = acc_s;
      }
    }
    const int key = k0 + lane;
    const bool live = key < M;
    const float kb = (live && kbias != nullptr) ? kbias[key] : 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      // ragged edge: keys past M get probability exactly 0
      const float x = live ? fmaf(s[r], scale, kb) : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(x));
      const float alpha = expf(m_run[r] - m_new);
      const float p = expf(x - m_new);
      l_lane[r] = fmaf(l_lane[r], alpha, p);
      m_run[r] = m_new;
      const int row = RW * warp + r;
      sp[row * kLdp + lane] = p;
      if (lane == 0) salpha[row] = alpha;
    }
    cp_async_wait_all();
    __syncthreads();  // V[t] in; sk is free; P and alpha visible
    if (t + 1 < t_end)
      stage_rows(sk, ld, kg, k_sn, k0 + kBK, M, kBK, d4);

    if (slot < rg) {
      const float* vc = sv + c4 * 4;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int row = slot + rg * j;
        if (row < BQ) {
          const float a = salpha[row];
          acc[j].x *= a;
          acc[j].y *= a;
          acc[j].z *= a;
          acc[j].w *= a;
        }
      }
#pragma unroll 2
      for (int kk = 0; kk < kBK; kk += 4) {
        const float4 v0 = *reinterpret_cast<const float4*>(vc + kk * ld);
        const float4 v1 = *reinterpret_cast<const float4*>(vc + (kk + 1) * ld);
        const float4 v2 = *reinterpret_cast<const float4*>(vc + (kk + 2) * ld);
        const float4 v3 = *reinterpret_cast<const float4*>(vc + (kk + 3) * ld);
        // every P load of this step before any FMA (rows past BQ load row
        // BQ - 1, unused)
        float4 pj[RJ];
#pragma unroll
        for (int j = 0; j < RJ; ++j)
          pj[j] = *reinterpret_cast<const float4*>(
              sp + min(slot + rg * j, BQ - 1) * kLdp + kk);
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int row = slot + rg * j;
          if (row < BQ) {
            const float4 p = pj[j];
            float4 a = acc[j];
            a.x = fmaf(p.x, v0.x, a.x);
            a.y = fmaf(p.x, v0.y, a.y);
            a.z = fmaf(p.x, v0.z, a.z);
            a.w = fmaf(p.x, v0.w, a.w);
            a.x = fmaf(p.y, v1.x, a.x);
            a.y = fmaf(p.y, v1.y, a.y);
            a.z = fmaf(p.y, v1.z, a.z);
            a.w = fmaf(p.y, v1.w, a.w);
            a.x = fmaf(p.z, v2.x, a.x);
            a.y = fmaf(p.z, v2.y, a.y);
            a.z = fmaf(p.z, v2.z, a.z);
            a.w = fmaf(p.z, v2.w, a.w);
            a.x = fmaf(p.w, v3.x, a.x);
            a.y = fmaf(p.w, v3.y, a.y);
            a.z = fmaf(p.w, v3.z, a.z);
            a.w = fmaf(p.w, v3.w, a.w);
            acc[j] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const float l = warp_sum(l_lane[r]);
    if (lane == 0) {
      sl[RW * warp + r] = l;
      sm[RW * warp + r] = m_run[r];
    }
  }
  __syncthreads();
  if (slot >= rg) return;

#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    const int row = slot + rg * j;
    const int n = n0 + row;
    if (row >= BQ || n >= N) continue;
    if (o_part == nullptr) {
      const float l = sl[row];
      float4 o;
      o.x = acc[j].x / l;
      o.y = acc[j].y / l;
      o.z = acc[j].z / l;
      o.w = acc[j].w / l;
      *reinterpret_cast<float4*>(out + b * o_sb + h * o_sh + n * o_sn +
                                 c4 * 4) = o;
    } else {
      // scratch [splits, G, N, D] and [splits, G, N]
      const int64_t pr = ((int64_t)split * gridDim.y + g) * N + n;
      *reinterpret_cast<float4*>(o_part + pr * D + c4 * 4) = acc[j];
      if (c4 == 0) {
        m_part[pr] = sm[row];
        l_part[pr] = sl[row];
      }
    }
  }
}

// out[b, n, h, :] = sum_s e^{m_s - m*} O_s / sum_s e^{m_s - m*} l_s,
// m* = max_s m_s; one thread per float4 of the output.
__global__ void __launch_bounds__(kThreads)
flash_combine_f32(const float* __restrict__ o_part,
                  const float* __restrict__ m_part,
                  const float* __restrict__ l_part, float* __restrict__ out,
                  int splits, int G, int H, int N, int D, int64_t o_sb,
                  int64_t o_sn, int64_t o_sh) {
  const int d4 = D >> 2;
  const int64_t rows = (int64_t)G * N;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * d4) return;
  const int64_t row = i / d4;
  const int c = (int)(i - row * d4) * 4;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m_part[s * rows + row]);
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const int64_t pr = s * rows + row;
    const float w = expf(m_part[pr] - mx);
    l = fmaf(w, l_part[pr], l);
    const float4 x = *reinterpret_cast<const float4*>(o_part + pr * D + c);
    o.x = fmaf(w, x.x, o.x);
    o.y = fmaf(w, x.y, o.y);
    o.z = fmaf(w, x.z, o.z);
    o.w = fmaf(w, x.w, o.w);
  }
  const int g = (int)(row / N);
  const int n = (int)(row - (int64_t)g * N);
  const int b = g / H;
  const int h = g - b * H;
  o.x /= l;
  o.y /= l;
  o.z /= l;
  o.w /= l;
  *reinterpret_cast<float4*>(out + b * o_sb + h * o_sh + n * o_sn + c) = o;
}

// The attention kernel `kernel` with `threads` threads, BQ query rows per
// block and `smem` bytes of shared memory, on the grid (query blocks,
// B * H, splits).
template <typename Kernel>
cudaError_t launch(Kernel kernel, bool& configured, int threads, int BQ,
                   size_t smem, const float* q, const float* k,
                   const float* v, const float* bias, float* out,
                   float* o_part, float* m_part, float* l_part, int B, int H,
                   int N, int M, int D, int splits, int bias_div, float scale,
                   const int64_t* st, cudaStream_t stream) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((N + BQ - 1) / BQ, B * H, splits);
  kernel<<<grid, threads, smem, stream>>>(
      q, k, v, bias, out, o_part, m_part, l_part, H, N, M, D, bias_div,
      scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <int kW>
cudaError_t launch_tc(const float* q, const float* k, const float* v,
                      const float* bias, float* out, float* o_part,
                      float* m_part, float* l_part, int B, int H, int N, int M,
                      int D, int splits, int bias_div, float scale,
                      const int64_t* st, cudaStream_t stream) {
  static bool configured = false;
  return launch(flash_fwd_f32_tc<kW>, configured, kTcThreads,
                tc_block_q(kW), tc_smem(kW), q, k, v, bias, out, o_part,
                m_part, l_part, B, H, N, M, D, splits, bias_div, scale, st,
                stream);
}

cudaError_t launch_simt(const float* q, const float* k, const float* v,
                        const float* bias, float* out, float* o_part,
                        float* m_part, float* l_part, int B, int H, int N,
                        int M, int D, int splits, int bias_div, float scale,
                        const int64_t* st, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + 2 * kBK) * smem_ld(D) + kBQ * kLdp +
                       3 * kBQ + kRedFloats);
  return launch(flash_fwd_f32, configured, kThreads, kBQ, smem, q, k, v,
                bias, out, o_part, m_part, l_part, B, H, N, M, D, splits,
                bias_div, scale, st, stream);
}

// out[b, n, h, :] from the split partials in `scratch` (splits > 1).
cudaError_t launch_combine(const float* o_part, const float* m_part,
                           const float* l_part, float* out, int B, int H,
                           int N, int D, int splits, const int64_t* st,
                           cudaStream_t stream) {
  const int64_t items = (int64_t)B * H * N * (D >> 2);
  const unsigned blocks = (unsigned)((items + kThreads - 1) / kThreads);
  flash_combine_f32<<<blocks, kThreads, 0, stream>>>(
      o_part, m_part, l_part, out, splits, B * H, H, N, D, st[9], st[10],
      st[11]);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: fp32 with unit stride along D; strides are in elements,
// (batch, sequence, head) for each of q, k, v, out. bias: fp32 [R, M],
// contiguous, or null; bias_rows = R divides B (batch row b reads row
// b / (B / R)). D must be a multiple of 4 and at most 512, pointers 16-byte
// aligned, strides multiples of 4 (the wrapper checks all of this). D a
// multiple of 8 up to 256 takes flash_fwd_f32_tc, any other D
// flash_fwd_f32. splits: 1 (scratch null; the attention kernel writes out)
// or 2..ceil(M / key tile) (scratch holds splits*B*H*N*(D + 2) floats: the
// attention kernel writes the partials o_part [splits, B*H, N, D], then
// m_part and l_part [splits, B*H, N], and flash_combine_f32, launched next
// on the same stream, merges them into out).
extern "C" int sige_flash_attn_f32(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* scratch, int B, int H, int N, int M, int D, int splits,
    int bias_rows, float scale, int64_t q_sb, int64_t q_sn, int64_t q_sh, int64_t k_sb,
    int64_t k_sn, int64_t k_sh, int64_t v_sb, int64_t v_sn, int64_t v_sh,
    int64_t o_sb, int64_t o_sn, int64_t o_sh, void* stream) {
  const int64_t st[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                          v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D > 512 || (D & 3) != 0) return (int)cudaErrorInvalidValue;
  if (N <= 0 || M <= 0 || B * H <= 0) return (int)cudaErrorInvalidValue;
  const int bk = tc_head(D) ? tc_block_k(tc_width(D)) : kBK;
  if (splits < 1 || splits > (M + bk - 1) / bk)
    return (int)cudaErrorInvalidValue;
  if ((splits > 1) != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  if (bias_rows < 1 || B % bias_rows != 0) return (int)cudaErrorInvalidValue;
  const int bias_div = B / bias_rows;
  float* op = static_cast<float*>(scratch);
  const int64_t rows = (int64_t)splits * B * H * N;
  float* mp = op == nullptr ? nullptr : op + rows * D;
  float* lp = op == nullptr ? nullptr : mp + rows;
  cudaError_t (*attention)(const float*, const float*, const float*,
                           const float*, float*, float*, float*, float*, int,
                           int, int, int, int, int, int, float,
                           const int64_t*, cudaStream_t) = launch_simt;
  if (tc_head(D)) {
    switch (tc_width(D)) {
      case 40: attention = launch_tc<40>; break;
      case 64: attention = launch_tc<64>; break;
      case 80: attention = launch_tc<80>; break;
      case 128: attention = launch_tc<128>; break;
      case 160: attention = launch_tc<160>; break;
      default: attention = launch_tc<256>;
    }
  }
  const cudaError_t err = attention(qf, kf, vf, bf, of, op, mp, lp, B, H, N,
                                    M, D, splits, bias_div, scale, st, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)launch_combine(op, mp, lp, of, B, H, N, D, splits, st, s);
}
