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
// What bounds it on this card. The work is 4*N*M*D flops on a few MB, far
// above the fp32 ridge, so the fp32 FMA rate of the SIMT units bounds it
// once the card is full. At the DDPM main path's shapes (one head, D = 512,
// N = M = 256 or 64) the card is not full: with 16 query rows per block
// only ceil(N/16) blocks exist, one per SM (the tiles take ~188 KB of
// shared memory at D = 512). The design does three things about that:
//
//  * Split-KV (flash-decoding). The launch's third grid axis cuts the key
//    range into `splits` contiguous runs of whole 32-key tiles, chosen by
//    the wrapper to fill the SMs (8 at N = M = 256: 128 blocks of one tile
//    each). A block of a split writes its unnormalised partial O [BQ, D]
//    and its rows' max and sum to scratch the wrapper allocated;
//    flash_combine_f32 then rescales the partials by exp(m_s - max_s m_s)
//    and divides by the rescaled sum. With one split the main kernel
//    normalises and writes the output itself.
//  * Asynchronous K/V staging. Every 16-byte cp.async of a tile is issued
//    before any is waited on, and the copies run under the compute: V[t]
//    lands while S(t) computes, K[t+1] while P.V(t) computes. Each of the
//    one K and one V buffer is refilled only after the barrier that ends
//    its last read. Rows past M (and query rows past N) are zero-filled by
//    cp.async with a source size of 0, never read.
//  * Eight warps per block, laid out per phase. The query block BQ grows
//    as D shrinks (16 at D > 128, 32 at D <= 128, 64 at D <= 64), so
//    narrow heads keep every warp busy without paying for D = 512's
//    registers. S, wide heads (BQ = 16): the reduction over D is split
//    across the warps and each lane sums a 4-row x 4-key tile, so every
//    float4 it reads from shared memory feeds four rows or keys; the
//    warps' partial tiles are summed through shared memory. S, narrow
//    heads: a warp owns BQ/8 >= 4 query rows and a lane one of the tile's
//    32 keys (the q reads are warp broadcasts). Softmax: a warp owns
//    BQ/8 rows, a lane a key; the row max is a warp shuffle reduction,
//    the row sum stays per lane until the end. P.V: a thread owns one
//    float4 column of V and the rows slot + (256 / (D/4)) * j, reads P
//    four keys at a time as a float4 broadcast and keeps its
//    accumulators in registers (8 float4 at D = 512, no spill). Rows are
//    padded in shared memory so that D/4 + pad/4 is odd: per-lane K-row
//    float4 reads are free of bank conflicts.
//
// The kernels allocate nothing and do not synchronise. The C entry launches
// both (the combine only when the key range is split) and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
// kBK and block_q must match BLOCK_K and block_q in ops/flash.py, which
// choose the split count from them.
constexpr int kBK = 32;         // keys per tile: one per lane in the S phase
constexpr int kLdp = kBK + 4;   // smem row stride of the P tile (float4 rows)

__host__ __device__ constexpr int block_q(int D) {
  return D <= 64 ? 64 : (D <= 128 ? 32 : 16);
}

__host__ __device__ constexpr int smem_ld(int D) {
  return D + ((D & 4) ? 8 : 4);
}

// Wide heads (BQ = 16) split S's reduction over D across the warps; the
// per-warp partial S tiles [kWarps][BQ][kLdr] are summed in shared memory.
constexpr int kLdr = 40;  // row stride: lanes (r, k) hit banks 8r + k
__host__ __device__ constexpr int red_floats(int BQ) {
  return BQ == 16 ? kWarps * BQ * kLdr : 0;
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
// (row stride ld); rows at or past r_end are zero-filled. Wide rows: a
// warp copies whole rows, its lanes on consecutive float4s (no division).
// Narrow rows (D/4 <= 32 would idle lanes): the block's threads walk the
// flattened tile.
template <bool kWide>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int64_t sn,
                                           int r0, int r_end, int rows,
                                           int d4) {
  if constexpr (kWide) {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
      const bool valid = r0 + r < r_end;
      const float* row = valid ? src + (r0 + r) * sn : src;
      for (int c4 = lane; c4 < d4; c4 += 32)
        cp_async16(dst + r * ld + 4 * c4, valid ? row + 4 * c4 : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d4; i += kThreads) {
      const int r = i / d4;
      const int c = (i - r * d4) * 4;
      const bool valid = r0 + r < r_end;
      cp_async16(dst + r * ld + c, valid ? src + (r0 + r) * sn + c : src,
                 valid);
    }
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

// BQ query rows per block; RJ: most P.V rows a thread owns.
template <int BQ, int RJ>
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
  float* sred = sm + BQ;           // red_floats(BQ): partial S per warp

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

  stage_rows<BQ == 16>(sq, ld, qg, q_sn, n0, N, BQ, d4);
  stage_rows<BQ == 16>(sk, ld, kg, k_sn, t_begin * kBK, M, kBK, d4);

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
    stage_rows<BQ == 16>(sv, ld, vg, v_sn, k0, M, kBK, d4);

    // S for rows RW*warp + r, key k0 + lane
    float s[RW];
    if constexpr (BQ == 16) {
      // Wide heads: warp w sums the float4 columns w, w + 8, ... of all
      // 16 x 32 logits; lane (rq, kq) holds rows rq + 4i and keys kq + 8j,
      // so each q or K float4 it loads feeds four rows or keys (8 loads,
      // one wavefront each, per 64 FMA). Then the 8 warps' tiles are
      // summed through shared memory.
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
    } else {
      // narrow heads: a lane sums all of D for its key; the warp's RW >= 4
      // rows are RW independent FMA chains
      const float* kr = sk + lane * ld;
      const float* qr = sq + RW * warp * ld;
#pragma unroll
      for (int r = 0; r < RW; ++r) s[r] = 0.f;
      for (int c = 0; c < D; c += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + r * ld + c);
          s[r] = fmaf(qv.x, kv.x, s[r]);
          s[r] = fmaf(qv.y, kv.y, s[r]);
          s[r] = fmaf(qv.z, kv.z, s[r]);
          s[r] = fmaf(qv.w, kv.w, s[r]);
        }
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
      stage_rows<BQ == 16>(sk, ld, kg, k_sn, k0 + kBK, M, kBK, d4);

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
        // wide heads: every P load of this step before any FMA (rows past
        // BQ load row BQ - 1, unused); narrow heads load each row's P where
        // it is used, which keeps them within 128 registers
        float4 pj[RJ];
        if constexpr (BQ == 16) {
#pragma unroll
          for (int j = 0; j < RJ; ++j)
            pj[j] = *reinterpret_cast<const float4*>(
                sp + min(slot + rg * j, BQ - 1) * kLdp + kk);
        }
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int row = slot + rg * j;
          if (row < BQ) {
            const float4 p = BQ == 16 ? pj[j]
                                      : *reinterpret_cast<const float4*>(
                                            sp + row * kLdp + kk);
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

template <int BQ, int RJ>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* out, float* o_part,
                   float* m_part, float* l_part, int B, int H, int N, int M,
                   int D, int splits, int bias_div, float scale,
                   const int64_t* st, cudaStream_t stream) {
  const int ld = smem_ld(D);
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * kBK) * ld + BQ * kLdp + 3 * BQ +
                       red_floats(BQ));
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<BQ, RJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        232448);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((N + BQ - 1) / BQ, B * H, splits);
  flash_fwd_f32<BQ, RJ><<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, out, o_part, m_part, l_part, H, N, M, D, bias_div,
      scale, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return cudaGetLastError();
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
// aligned, strides multiples of 4 (the wrapper checks all of this).
// splits: 1 (scratch null; flash_fwd_f32 writes out) or 2..ceil(M/32)
// (scratch holds splits*B*H*N*(D + 2) floats: flash_fwd_f32 writes the
// partials o_part [splits, B*H, N, D], then m_part and l_part
// [splits, B*H, N], and flash_combine_f32, launched next on the same
// stream, merges them into out).
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
  if (splits < 1 || splits > (M + kBK - 1) / kBK)
    return (int)cudaErrorInvalidValue;
  if ((splits > 1) != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  if (bias_rows < 1 || B % bias_rows != 0) return (int)cudaErrorInvalidValue;
  const int bias_div = B / bias_rows;
  float* op = static_cast<float*>(scratch);
  const int64_t rows = (int64_t)splits * B * H * N;
  float* mp = op == nullptr ? nullptr : op + rows * D;
  float* lp = op == nullptr ? nullptr : mp + rows;
  cudaError_t err;
  if (D <= 64) {
    err = launch<block_q(64), 4>(qf, kf, vf, bf, of, op, mp, lp, B, H, N, M,
                                 D, splits, bias_div, scale, st, s);
  } else if (D <= 128) {
    err = launch<block_q(128), 4>(qf, kf, vf, bf, of, op, mp, lp, B, H, N, M,
                                  D, splits, bias_div, scale, st, s);
  } else if (D <= 256) {
    err = launch<block_q(256), 4>(qf, kf, vf, bf, of, op, mp, lp, B, H, N, M,
                                  D, splits, bias_div, scale, st, s);
  } else {
    err = launch<block_q(512), 8>(qf, kf, vf, bf, of, op, mp, lp, B, H, N, M,
                                  D, splits, bias_div, scale, st, s);
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)launch_combine(op, mp, lp, of, B, H, N, D, splits, st, s);
}
