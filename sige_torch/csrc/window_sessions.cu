// Crop and paste with per-session window origins, for Hopper (sm_90a).
//
// S editing sessions of B samples each run as one forward at batch S*B
// (sige_torch.parallel.SessionServer). Each session carries its own
// window origins, as device data: sample n = s*B + b reads and writes its
// windows at session s's origin. The two kernels below are the port's own:
// no Pallas kernel has them. sige_tpu computes the same thing in XLA, as
// dynamic_slice / dynamic_update_slice with a batched start under vmap
// (sige_tpu/ops/window.py:47-66, 176-218).
//
//   crop_sessions_f32   out[n, i, j, c] = x[n, r_s + i, c_s + j, c], zero
//                       outside the image, then an optional fused epilogue
//                       (scale * v + shift and an activation, in either
//                       order, in fp32 registers) and the ring re-zeroed
//                       where edge[s, i, j] is false.
//   paste_sessions_f32  out = base with win[n] written at session s's
//                       origin where cov[s, i, j] is set (or everywhere in
//                       the window); out has win's dtype, so a bf16 cache
//                       (SIGEModel(cache_dtype=torch.bfloat16)) is widened
//                       exactly as it is copied.
//
// An origin row is (r, c), or the planner's 4-form window meta
// (clamped_r, clamped_c, roll_r, roll_c), whose virtual origin is
// clamped - roll; a null origin pointer means one host origin for every
// session. With `clamp` the origin is clamped so that the window fits in
// the map, as jax.lax.dynamic_slice clamps its start.
//
// What bounds them on this card: bytes. Each output element costs one
// read and one write and a few integer operations, so the least time is
// the bytes moved over 3.35 TB/s; at the DDPM shapes (windows of ~10^5 to
// 10^6 elements, maps of up to 8 x 256 x 256 x 128) both are far shorter
// than the ~20-40 us that a launch costs the host, and a launch, not the
// kernel, is what they save: in the single-session path an in-image crop
// is a free view, while in a stacked forward it has to gather S windows
// from S places, which the plain PyTorch version does in several launches
// (index arithmetic, advanced indexing, torch.where). The design is the
// simple one: one thread per output element, channels innermost so a
// warp reads and writes consecutive addresses, the epilogue in registers,
// no shared memory. Inputs may be strided views (strides in elements);
// outputs are contiguous.
//
// The C entries launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// dtype codes, as the wrapper (sige_torch/ops/sessions.py) passes them
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// activation codes, as the wrapper passes them (sige_torch/ops/sessions.py
// _ACTS); the functions are sige_torch/ops/gather.py _ACTIVATIONS
constexpr int kIdentity = 0;
constexpr int kSwish = 1;
constexpr int kRelu = 2;
constexpr int kLeaky = 3;
constexpr int kSigmoid = 4;
constexpr int kTanh = 5;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// the same arithmetic as PyTorch's CUDA kernels for these activations
__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kSwish: return __fmul_rn(v, sigmoid(v));
    case kRelu: return v > 0.0f ? v : 0.0f;
    case kLeaky: return v > 0.0f ? v : __fmul_rn(v, 0.2f);
    case kSigmoid: return sigmoid(v);
    case kTanh: return tanhf(v);
    case kIdentity:
    default: return v;
  }
}

struct Origin {
  const int64_t* rows;  // [S, k] or null
  int k;                // 2 or 4
  int r, c;             // the host origin when rows is null
  int clamp;            // clamp into [0, limit - extent]
};

__device__ __forceinline__ void origin_of(const Origin& o, int64_t s,
                                          int H, int W, int EH, int EW,
                                          int* r, int* c) {
  int rr = o.r, cc = o.c;
  if (o.rows != nullptr) {
    const int64_t* row = o.rows + s * o.k;
    rr = static_cast<int>(row[0]);
    cc = static_cast<int>(row[1]);
    if (o.k == 4) {  // virtual origin of a 4-form meta
      rr -= static_cast<int>(row[2]);
      cc -= static_cast<int>(row[3]);
    }
  }
  if (o.clamp) {
    rr = max(0, min(rr, H - EH));
    cc = max(0, min(cc, W - EW));
  }
  *r = rr;
  *c = cc;
}

struct Epilogue {
  const float* scale;  // [C] or [N, C], or null
  const float* shift;
  int scale_rows, shift_rows;  // 1 or N
  int act, act_first;
  int on;  // any of the above
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
crop_sessions_f32(const T* __restrict__ x, T* __restrict__ out, Origin o,
                  int64_t N, int B, int H, int W, int C, int EH, int EW,
                  int64_t sx0, int64_t sx1, int64_t sx2, int64_t sx3,
                  const bool* __restrict__ edge, int edge_per_session,
                  Epilogue e) {
  const int64_t total = N * EH * EW * C;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(idx % C);
    int64_t t = idx / C;
    const int j = static_cast<int>(t % EW);
    t /= EW;
    const int i = static_cast<int>(t % EH);
    const int64_t n = t / EH;
    const int64_t s = n / B;
    int r0, c0;
    origin_of(o, s, H, W, EH, EW, &r0, &c0);
    const int h = r0 + i, w = c0 + j;
    float v = 0.0f;
    if (h >= 0 && h < H && w >= 0 && w < W) {
      v = to_f32(x[n * sx0 + h * sx1 + w * sx2 + c * sx3]);
    }
    if (e.on) {
      const float sc = e.scale == nullptr
          ? 1.0f : e.scale[(e.scale_rows == 1 ? 0 : n) * C + c];
      const float sh = e.shift == nullptr
          ? 0.0f : e.shift[(e.shift_rows == 1 ? 0 : n) * C + c];
      // __fmul_rn / __fadd_rn: never contracted into an FMA, so the
      // roundings are those of PyTorch's separate multiply and add
      if (e.act_first) {
        v = activate(v, e.act);
        if (e.scale != nullptr) v = __fmul_rn(v, sc);
        if (e.shift != nullptr) v = __fadd_rn(v, sh);
      } else {
        if (e.scale != nullptr) v = __fmul_rn(v, sc);
        if (e.shift != nullptr) v = __fadd_rn(v, sh);
        v = activate(v, e.act);
      }
    }
    if (edge != nullptr &&
        !edge[((edge_per_session ? s : 0) * EH + i) * EW + j]) {
      v = 0.0f;
    }
    out[idx] = from_f32<T>(v);
  }
}

template <typename TB, typename TW>
__global__ void __launch_bounds__(kThreads)
paste_sessions_f32(const TB* __restrict__ base, const TW* __restrict__ win,
                   TW* __restrict__ out, Origin o, int64_t N, int B, int H,
                   int W, int C, int WH, int WW, int64_t sb0, int64_t sb1,
                   int64_t sb2, int64_t sb3, int64_t sw0, int64_t sw1,
                   int64_t sw2, int64_t sw3, const bool* __restrict__ cov,
                   int cov_per_session) {
  const int64_t total = N * H * W * C;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(idx % C);
    int64_t t = idx / C;
    const int w = static_cast<int>(t % W);
    t /= W;
    const int h = static_cast<int>(t % H);
    const int64_t n = t / H;
    const int64_t s = n / B;
    int r0, c0;
    origin_of(o, s, H, W, WH, WW, &r0, &c0);
    const int i = h - r0, j = w - c0;
    bool take = i >= 0 && i < WH && j >= 0 && j < WW;
    if (take && cov != nullptr) {
      take = cov[((cov_per_session ? s : 0) * WH + i) * WW + j];
    }
    if (take) {
      out[idx] = win[n * sw0 + i * sw1 + j * sw2 + c * sw3];
    } else {
      out[idx] = from_f32<TW>(to_f32(base[n * sb0 + h * sb1 + w * sb2 +
                                          c * sb3]));
    }
  }
}

int blocks_for(int64_t total) {
  // a grid-stride loop: enough blocks to fill the card several times over
  const int64_t want = (total + kThreads - 1) / kThreads;
  return static_cast<int>(want < 132 * 64 ? (want > 0 ? want : 1)
                                          : 132 * 64);
}

}  // namespace

extern "C" int sige_crop_sessions(
    int dtype, const void* x, void* out, const void* org, int org_k,
    int r_const, int c_const, int clamp, int64_t N, int B, int H, int W,
    int C, int EH, int EW, int64_t sx0, int64_t sx1, int64_t sx2,
    int64_t sx3, const void* edge, int edge_per_session, const void* scale,
    int scale_rows, const void* shift, int shift_rows, int act,
    int act_first, int epilogue, void* stream) {
  Origin o{static_cast<const int64_t*>(org), org_k, r_const, c_const, clamp};
  Epilogue e{static_cast<const float*>(scale),
             static_cast<const float*>(shift), scale_rows, shift_rows, act,
             act_first, epilogue};
  const int64_t total = N * EH * EW * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    crop_sessions_f32<float><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), o, N, B, H,
        W, C, EH, EW, sx0, sx1, sx2, sx3, static_cast<const bool*>(edge),
        edge_per_session, e);
  } else if (dtype == kBF16) {
    crop_sessions_f32<__nv_bfloat16><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), o, N, B, H, W, C, EH, EW, sx0,
        sx1, sx2, sx3, static_cast<const bool*>(edge), edge_per_session, e);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sige_paste_sessions(
    int base_dtype, int win_dtype, const void* base, const void* win,
    void* out, const void* org, int org_k, int r_const, int c_const,
    int clamp, int64_t N, int B, int H, int W, int C, int WH, int WW,
    int64_t sb0, int64_t sb1, int64_t sb2, int64_t sb3, int64_t sw0,
    int64_t sw1, int64_t sw2, int64_t sw3, const void* cov,
    int cov_per_session, void* stream) {
  Origin o{static_cast<const int64_t*>(org), org_k, r_const, c_const, clamp};
  const int64_t total = N * H * W * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool* cv = static_cast<const bool*>(cov);
  if (base_dtype == kF32 && win_dtype == kF32) {
    paste_sessions_f32<float, float><<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(base), static_cast<const float*>(win),
        static_cast<float*>(out), o, N, B, H, W, C, WH, WW, sb0, sb1, sb2,
        sb3, sw0, sw1, sw2, sw3, cv, cov_per_session);
  } else if (base_dtype == kBF16 && win_dtype == kF32) {
    paste_sessions_f32<__nv_bfloat16, float>
        <<<blocks_for(total), kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(base),
            static_cast<const float*>(win), static_cast<float*>(out), o, N,
            B, H, W, C, WH, WW, sb0, sb1, sb2, sb3, sw0, sw1, sw2, sw3, cv,
            cov_per_session);
  } else if (base_dtype == kBF16 && win_dtype == kBF16) {
    paste_sessions_f32<__nv_bfloat16, __nv_bfloat16>
        <<<blocks_for(total), kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(base),
            static_cast<const __nv_bfloat16*>(win),
            static_cast<__nv_bfloat16*>(out), o, N, B, H, W, C, WH, WW, sb0,
            sb1, sb2, sb3, sw0, sw1, sw2, sw3, cv, cov_per_session);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
