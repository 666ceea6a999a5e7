// Forward-only flash attention, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sige_tpu/ops/flash.py:_fwd_kernel
// (launched by flash_mha_bhsd). It computes the same function:
//
//   out[b, n, h, :] = softmax_m(scale * q[b, n, h, :] . k[b, m, h, :] + bias[m])
//                     . v[b, :, h, :]
//
// with an online softmax that keeps the running max and sum of every
// query row in fp32 (running max starts at -1e30, as on the TPU), and the
// P.V product accumulated in fp32. bias is an optional fp32 [M] additive
// key bias shared by every (b, h) (0 / -1e9: ragged-KV padding and the
// masked stale/fresh K/V form).
//
// What bounds it on this card. At the engine's shapes (DDPM: one head,
// D = 512, N = M = 256 or 64) the work is 4*N*M*D flops on ~2 MB, far
// above the card's fp32 ridge, so the fp32 FMA rate bounds it, and with
// G = B*H = 1 only ceil(N/16) blocks exist: few SMs are busy. The design
// does three things about that:
//  * The TPU's sequential third grid axis (KV blocks) becomes a loop
//    inside the block; the [N, M] logits never leave shared memory.
//  * Tiles are sized for shared memory, not VMEM: 16 query rows and a
//    32-row K/V tile, each row padded by 4 floats so the float4 reads of
//    the S and P.V loops are free of bank conflicts. At D = 512 that is
//    ~163 KB of dynamic shared memory; narrow heads (D = 40) use ~17 KB
//    and several blocks share an SM. The accumulator (16 x D) lives in
//    registers: thread t owns query row t/8 and columns 4*(t%8) + 32*j.
//  * Ragged N and M are masked inside the kernel (rows past N are never
//    stored, keys past M get probability 0), so no shape is padded and
//    no multiple-of-128 gate exists.
// Later work (tensor cores through split-TF32, TMA, split-KV to fill the
// SMs at G = 1) is not in this version.
//
// The kernel allocates nothing and does not synchronise. The C entry
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 16;        // query rows per block
constexpr int kBK = 32;        // K/V rows per tile
constexpr int kThreads = 128;  // 8 threads per query row
constexpr int kPad = 4;        // floats of padding per smem row

template <int NJ>  // NJ = ceil(D / 32) float4 accumulator columns a thread owns
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              float* __restrict__ out, int H, int N, int M, int D,
              float scale,
              int64_t q_sb, int64_t q_sn, int64_t q_sh,
              int64_t k_sb, int64_t k_sn, int64_t k_sh,
              int64_t v_sb, int64_t v_sn, int64_t v_sh,
              int64_t o_sb, int64_t o_sn, int64_t o_sh) {
  extern __shared__ __align__(16) float smem[];
  const int ld = D + kPad;          // smem row stride of the q/k/v tiles
  const int ldp = kBK + 1;          // smem row stride of the P tile
  float* sq = smem;                 // [kBQ][ld]
  float* sk = sq + kBQ * ld;        // [kBK][ld]
  float* sv = sk + kBK * ld;        // [kBK][ld]
  float* sp = sv + kBK * ld;        // [kBQ][ldp]

  const int tid = threadIdx.x;
  const int row = tid >> 3;         // this thread's query row in the tile
  const int sub = tid & 7;          // its place among the row's 8 threads
  const int g = blockIdx.y;
  const int b = g / H;
  const int h = g - b * H;
  const int n0 = blockIdx.x * kBQ;
  const int d4 = D >> 2;

  const float* qg = q + b * q_sb + h * q_sh;
  const float* kg = k + b * k_sb + h * k_sh;
  const float* vg = v + b * v_sb + h * v_sh;

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < kBQ * d4; i += kThreads) {
    const int r = i / d4;
    const int c = (i - r * d4) * 4;
    float4 val = zero4;
    if (n0 + r < N) {
      val = *reinterpret_cast<const float4*>(qg + (n0 + r) * q_sn + c);
    }
    *reinterpret_cast<float4*>(sq + r * ld + c) = val;
  }

  float4 acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = zero4;
  float m_run = -1e30f;
  float l_run = 0.f;

  for (int k0 = 0; k0 < M; k0 += kBK) {
    __syncthreads();  // the previous tile's K/V reads are done
    for (int i = tid; i < kBK * d4; i += kThreads) {
      const int r = i / d4;
      const int c = (i - r * d4) * 4;
      float4 kv = zero4;
      float4 vv = zero4;
      if (k0 + r < M) {
        kv = *reinterpret_cast<const float4*>(kg + (k0 + r) * k_sn + c);
        vv = *reinterpret_cast<const float4*>(vg + (k0 + r) * v_sn + c);
      }
      *reinterpret_cast<float4*>(sk + r * ld + c) = kv;
      *reinterpret_cast<float4*>(sv + r * ld + c) = vv;
    }
    __syncthreads();

    // S for this thread's row and keys sub + 8*i (strided so the eight
    // threads of a row read eight distinct bank groups)
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qr = sq + row * ld;
    for (int c = 0; c < D; c += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kv =
            *reinterpret_cast<const float4*>(sk + (sub + 8 * i) * ld + c);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k0 + sub + 8 * i;
      if (kk < M) {
        s[i] = s[i] * scale + (bias != nullptr ? bias[kk] : 0.f);
      } else {
        s[i] = -INFINITY;  // ragged edge: probability exactly 0
      }
      mx = fmaxf(mx, s[i]);
    }
    // the row's 8 threads are 8 consecutive lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(s[i] - m_new);
      sp[row * ldp + sub + 8 * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    psum += __shfl_xor_sync(0xffffffffu, psum, 4);
    l_run = l_run * alpha + psum;
    m_run = m_new;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[j].x *= alpha;
      acc[j].y *= alpha;
      acc[j].z *= alpha;
      acc[j].w *= alpha;
    }
    __syncwarp();  // P row written and read by the same 8 lanes

    const float* pr = sp + row * ldp;
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = pr[kk];
      const float* vr = sv + kk * ld + sub * 4;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (sub * 4 + 32 * j < D) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 32 * j);
          acc[j].x = fmaf(p, vv.x, acc[j].x);
          acc[j].y = fmaf(p, vv.y, acc[j].y);
          acc[j].z = fmaf(p, vv.z, acc[j].z);
          acc[j].w = fmaf(p, vv.w, acc[j].w);
        }
      }
    }
  }

  if (n0 + row < N) {
    float* og = out + b * o_sb + h * o_sh + (n0 + row) * o_sn + sub * 4;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (sub * 4 + 32 * j < D) {
        float4 o;
        o.x = acc[j].x / l_run;
        o.y = acc[j].y / l_run;
        o.z = acc[j].z / l_run;
        o.w = acc[j].w / l_run;
        *reinterpret_cast<float4*>(og + 32 * j) = o;
      }
    }
  }
}

template <int NJ>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* out, int B, int H, int N, int M,
                   int D, float scale, const int64_t* st,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + kPad) + kBQ * (kBK + 1));
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        232448);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((N + kBQ - 1) / kBQ, B * H);
  flash_fwd_f32<NJ><<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, out, H, N, M, D, scale, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: fp32 with unit stride along D; strides are in elements,
// (batch, sequence, head) for each of q, k, v, out. bias: fp32 [M] or
// null. D must be a multiple of 4 and at most 512, pointers 16-byte
// aligned, strides multiples of 4 (the wrapper checks all of this).
extern "C" int sige_flash_attn_f32(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int B, int H, int N, int M, int D, float scale, int64_t q_sb,
    int64_t q_sn, int64_t q_sh, int64_t k_sb, int64_t k_sn, int64_t k_sh,
    int64_t v_sb, int64_t v_sn, int64_t v_sh, int64_t o_sb, int64_t o_sn,
    int64_t o_sh, void* stream) {
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
  cudaError_t err;
  if (D <= 64) {
    err = launch<2>(qf, kf, vf, bf, of, B, H, N, M, D, scale, st, s);
  } else if (D <= 128) {
    err = launch<4>(qf, kf, vf, bf, of, B, H, N, M, D, scale, st, s);
  } else if (D <= 256) {
    err = launch<8>(qf, kf, vf, bf, of, B, H, N, M, D, scale, st, s);
  } else {
    err = launch<16>(qf, kf, vf, bf, of, B, H, N, M, D, scale, st, s);
  }
  return (int)err;
}
