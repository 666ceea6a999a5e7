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
//                       where edge[s, i, j] is false. A pixel outside the
//                       image holds the epilogue of zero, not zero.
//   paste_sessions_f32  out = base with win[n] written at session s's
//                       origin where cov[s, i, j] is set (or everywhere in
//                       the window); out has win's dtype, so a bf16 cache
//                       (SIGEModel(cache_dtype=torch.bfloat16)) is widened
//                       exactly as it is copied. Out of place: the base
//                       stays as it was.
//
// An origin row is (r, c), or the planner's 4-form window meta
// (clamped_r, clamped_c, roll_r, roll_c), whose virtual origin is
// clamped - roll; a null origin pointer means one host origin for every
// session. With `clamp` the origin is clamped so that the window fits in
// the map, as jax.lax.dynamic_slice clamps its start.
//
// What bounds them on this card: bytes. Each output element is written
// once and read from one source, and there is no arithmetic to speak of,
// so the least time is those bytes over 3.35 TB/s. The design spends no
// instructions per byte beyond the copy and keeps 16-byte accesses in
// flight:
//   - A block per output row (n, i), or per chunk of one when there are
//     few rows (grid.y chunks, chosen by the wrapper so that the grid
//     fills the 132 SMs several times over). The block decodes n, i and
//     s = n / B once, in 32-bit arithmetic; one thread reads the session's
//     origin row, subtracts the roll and clamps, and shares it through
//     shared memory; the row's in-image (crop) or in-window (paste) run
//     of pixels is two bounds per block. A crop row outside the image and
//     a paste row outside the window are one run each.
//   - Channels are innermost, so a row is EW x C elements: a thread walks
//     them as VEC-element vectors f = j * (C / VEC) + q, in steps of the
//     block's threads, with one division when it starts and an add and a
//     compare a step (no 64-bit division, no per-element index decode).
//   - VEC = 16 bytes of the output type (4 fp32 or 8 bf16; a bf16 base
//     under an fp32 window: 8 bytes read, 16 written) where the wrapper
//     finds C a multiple of VEC, channels at stride 1, and pointers and
//     the other strides aligned to VEC elements; otherwise VEC = 1, the
//     scalar instantiation of the same kernel, for any strides.
//   - A thread issues kUnroll vectors' loads before its first store (the
//     compiler cannot tell that the output aliases no mask, so a load
//     placed after a store would wait for it): a crop's data and edge
//     bytes together; a paste's coverage bytes, then each output vector
//     from exactly one source (window or base). The wrapper cuts rows
//     into chunks of at least kThreads * kUnroll vectors.
//   - The epilogue has an instantiation of its own (EPI), so that a crop
//     without one holds no registers for it. Its params ([C] or [N, C])
//     are read as vectors, once per thread where C / VEC divides
//     kThreads (C = 128, 256, 512), and its activation is chosen once per
//     vector, not per element. `edge` and `cov` are read once per pixel
//     vector, the same byte for the threads of a pixel.
// Device ms per call on an NVIDIA H100 80GB HBM3 at 700 W, S = 4 sessions
// of 128 channels (torch.profiler, median of 3 traces of 50 calls:
// scripts/session_kernel_time.py, both versions in one process each, in
// turns), the first version (one thread per element, 64-bit index
// decode, a grid-stride loop) -> this one, beside one Tensor.copy_ of the
// output's bytes and the bound (the bytes the function must move over
// 3.35 TB/s; inputs that stay in the 50 MB L2 between calls can beat it):
//   crop 256^2 -> 48^2, 4-form metas     0.0120 -> 0.0035  copy 0.0025  0.0028
//   crop 48^2, swish epilogue, edge      0.0152 -> 0.0054  copy 0.0025  0.0027
//   crop 48^2, edge                      0.0121 -> 0.0034  copy 0.0025  0.0027
//   crop 256^2 -> 192^2 box, clamped     0.1361 -> 0.0571  copy 0.0513  0.0451
//   paste 46^2 into 48^2, clamped        0.0120 -> 0.0036  copy 0.0025  0.0028
//   paste 46^2 into 48^2, session cov    0.0126 -> 0.0035  copy 0.0026  0.0028
//   paste 192^2 box into 256^2, cov      0.2626 -> 0.0974  copy 0.0904  0.0802
// The epilogue row stays at 2.2x its copy: an expf and an IEEE division
// per element, kept so that the crop equals PyTorch bit for bit.
//
// The C entries launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() (or -1 for arguments they do
// not take) so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // a block (sige_torch/ops/sessions.py THREADS)
constexpr int kUnroll = 4;     // vectors a thread loads before it stores

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

// VEC elements moved as one access (16 bytes on the vector path)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& v) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = v;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> zeros() {
  Pack<T, VEC> z;
#pragma unroll
  for (int k = 0; k < VEC; ++k) z.v[k] = from_f32<T>(0.0f);
  return z;
}

// a base vector in the window's dtype: the same bits when the dtypes
// agree, else widened exactly (bf16 -> fp32)
template <typename TW, typename TB, int VEC>
__device__ __forceinline__ Pack<TW, VEC> widen(const Pack<TB, VEC>& b) {
  if constexpr (std::is_same<TB, TW>::value) {
    return b;
  } else {
    Pack<TW, VEC> w;
#pragma unroll
    for (int k = 0; k < VEC; ++k) w.v[k] = from_f32<TW>(to_f32(b.v[k]));
    return w;
  }
}

struct Origin {
  const int64_t* rows;  // [S, k] or null
  int k;                // 2 or 4
  int r, c;             // the host origin when rows is null
  int clamp;            // clamp into [0, limit - extent]
};

__device__ __forceinline__ int2 origin_of(const Origin& o, int s, int H,
                                          int W, int EH, int EW) {
  int rr = o.r, cc = o.c;
  if (o.rows != nullptr) {
    const int64_t* row = o.rows + static_cast<int64_t>(s) * o.k;
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
  return make_int2(rr, cc);
}

struct Epilogue {
  const float* scale;  // [C] or [N, C], or null
  const float* shift;
  int scale_rows, shift_rows;  // 1 or N
  int act, act_first;
};

// the VEC epilogue params from channel c of sample n, [C] or [N, C]
template <int VEC>
__device__ __forceinline__ void params(const Epilogue& e, int n, int C,
                                       int c, Pack<float, VEC>& sc,
                                       Pack<float, VEC>& sh) {
  if (e.scale != nullptr) {
    sc = load<float, VEC>(
        e.scale + static_cast<int64_t>(e.scale_rows == 1 ? 0 : n) * C + c);
  }
  if (e.shift != nullptr) {
    sh = load<float, VEC>(
        e.shift + static_cast<int64_t>(e.shift_rows == 1 ? 0 : n) * C + c);
  }
}

template <int ACT>
__device__ __forceinline__ float act_of(float v) {
  if constexpr (ACT == kSwish) return __fmul_rn(v, sigmoid(v));
  if constexpr (ACT == kRelu) return v > 0.0f ? v : 0.0f;
  if constexpr (ACT == kLeaky) return v > 0.0f ? v : __fmul_rn(v, 0.2f);
  if constexpr (ACT == kSigmoid) return sigmoid(v);
  if constexpr (ACT == kTanh) return tanhf(v);
  return v;
}

// scale * v + shift and the activation ACT, in either order, on VEC values
template <int ACT, int VEC>
__device__ __forceinline__ void apply_act(Pack<float, VEC>& v,
                                          const Epilogue& e,
                                          const Pack<float, VEC>& sc,
                                          const Pack<float, VEC>& sh) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float a = v.v[k];
    // __fmul_rn / __fadd_rn: never contracted into an FMA, so the
    // roundings are those of PyTorch's separate multiply and add
    if (e.act_first) {
      a = act_of<ACT>(a);
      if (e.scale != nullptr) a = __fmul_rn(a, sc.v[k]);
      if (e.shift != nullptr) a = __fadd_rn(a, sh.v[k]);
    } else {
      if (e.scale != nullptr) a = __fmul_rn(a, sc.v[k]);
      if (e.shift != nullptr) a = __fadd_rn(a, sh.v[k]);
      a = act_of<ACT>(a);
    }
    v.v[k] = a;
  }
}

// the epilogue on VEC values: the activation chosen once per vector, not
// per element
template <int VEC>
__device__ __forceinline__ void apply(Pack<float, VEC>& v, const Epilogue& e,
                                      const Pack<float, VEC>& sc,
                                      const Pack<float, VEC>& sh) {
  switch (e.act) {
    case kSwish: apply_act<kSwish>(v, e, sc, sh); break;
    case kRelu: apply_act<kRelu>(v, e, sc, sh); break;
    case kLeaky: apply_act<kLeaky>(v, e, sc, sh); break;
    case kSigmoid: apply_act<kSigmoid>(v, e, sc, sh); break;
    case kTanh: apply_act<kTanh>(v, e, sc, sh); break;
    default: apply_act<kIdentity>(v, e, sc, sh); break;
  }
}

// A thread's walk over the vectors of one row, f = j * CV + q (pixel j,
// channel vector q of CV), in steps of kThreads: one division when it
// starts, then an add and a compare a step.
struct Walk {
  int f, j, q, CV, dj, dq;
  __device__ __forceinline__ Walk(int f0, int cv)
      : f(f0), j(f0 / cv), q(f0 - (f0 / cv) * cv), CV(cv),
        dj(kThreads / cv), dq(kThreads - (kThreads / cv) * cv) {}
  __device__ __forceinline__ void next() {
    f += kThreads;
    j += dj;
    q += dq;
    if (q >= CV) {
      q -= CV;
      ++j;
    }
  }
};

// [begin, end) of this block's chunk of a row of len vectors
__device__ __forceinline__ int2 chunk(int len) {
  const int per = (len + gridDim.y - 1) / gridDim.y;
  const int begin = blockIdx.y * per;
  return make_int2(begin, min(len, begin + per));
}

struct CropArgs {
  const void* x;
  void* out;
  Origin o;
  int B, H, W, C, EH, EW;
  int64_t sx0, sx1, sx2, sx3;  // x's strides, in elements
  const bool* edge;            // [S, EH, EW], [EH, EW] or null
  int edge_per_session;
  Epilogue e;
};

// EPI: the fused epilogue (fp32 only; a thread holds the params of its
// channel vector in registers)
template <typename T, int VEC, bool EPI>
__global__ void __launch_bounds__(kThreads)
crop_sessions_f32(const CropArgs a) {
  const T* __restrict__ x = static_cast<const T*>(a.x);
  T* __restrict__ out = static_cast<T*>(a.out);
  __shared__ int2 org;
  const int row = blockIdx.x;  // the output row (n, i)
  const int n = row / a.EH, i = row - n * a.EH, s = n / a.B;
  if (threadIdx.x == 0) org = origin_of(a.o, s, a.H, a.W, a.EH, a.EW);
  __syncthreads();
  const int CV = a.C / VEC, len = a.EW * CV;
  const int2 span = chunk(len);
  const int h = org.x + i;
  // the in-image vectors of the row: columns [max(0, -c0), min(EW, W - c0))
  int lo = 0, hi = 0;
  if (h >= 0 && h < a.H) {
    lo = max(0, -org.y) * CV;
    hi = min(a.EW, a.W - org.y) * CV;
  }
  const int64_t xrow = n * a.sx0 + h * a.sx1 + org.y * a.sx2;
  const int64_t sq = VEC * a.sx3;  // from one channel vector to the next
  T* orow = out + static_cast<int64_t>(row) * len * VEC;
  const bool* erow = a.edge == nullptr ? nullptr
      : a.edge + (static_cast<int64_t>(a.edge_per_session ? s : 0) * a.EH
                  + i) * a.EW;
  Walk w(span.x + threadIdx.x, CV);
  // the epilogue params of the thread's channel vector: loaded with its
  // first data, again only where a step moves it to another channel group
  // (never when CV divides kThreads, as at C = 128, 256, 512)
  int qp = w.q;
  Pack<float, VEC> sc, sh;
  if constexpr (EPI) {
    if (w.f < span.y) params(a.e, n, a.C, qp * VEC, sc, sh);
  }
  while (w.f < span.y) {
    Pack<T, VEC> v[kUnroll];
    int fs[kUnroll], qs[kUnroll];
    bool keep[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      fs[u] = w.f;
      qs[u] = w.q;
      v[u] = zeros<T, VEC>();
      keep[u] = true;
      if (w.f < span.y) {
        if (w.f >= lo && w.f < hi) {
          v[u] = load<T, VEC>(x + xrow + w.j * a.sx2 + w.q * sq);
        }
        if (erow != nullptr) keep[u] = erow[w.j];
      }
      w.next();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (fs[u] < span.y) {
        if constexpr (EPI) {
          if (qs[u] != qp) {
            qp = qs[u];
            params(a.e, n, a.C, qp * VEC, sc, sh);
          }
          apply(v[u], a.e, sc, sh);
        }
        if (!keep[u]) v[u] = zeros<T, VEC>();
        store(orow + static_cast<int64_t>(fs[u]) * VEC, v[u]);
      }
    }
  }
}

struct PasteArgs {
  const void* base;
  const void* win;
  void* out;
  Origin o;
  int B, H, W, C, WH, WW;
  int64_t sb0, sb1, sb2, sb3;  // base's strides, in elements
  int64_t sw0, sw1, sw2, sw3;  // win's
  const bool* cov;             // [S, WH, WW], [WH, WW] or null
  int cov_per_session;
};

template <typename TB, typename TW, int VEC>
__global__ void __launch_bounds__(kThreads)
paste_sessions_f32(const PasteArgs a) {
  const TB* __restrict__ base = static_cast<const TB*>(a.base);
  const TW* __restrict__ win = static_cast<const TW*>(a.win);
  TW* __restrict__ out = static_cast<TW*>(a.out);
  __shared__ int2 org;
  const int row = blockIdx.x;  // the output row (n, h)
  const int n = row / a.H, h = row - n * a.H, s = n / a.B;
  if (threadIdx.x == 0) org = origin_of(a.o, s, a.H, a.W, a.WH, a.WW);
  __syncthreads();
  const int CV = a.C / VEC, len = a.W * CV;
  const int2 span = chunk(len);
  const int i = h - org.x;
  // the window's vectors of the row: columns [c0, c0 + WW) within [0, W);
  // base on either side, and on the whole of a row outside the window
  int lo = 0, hi = 0;
  if (i >= 0 && i < a.WH) {
    lo = max(0, org.y) * CV;
    hi = min(a.W, org.y + a.WW) * CV;
  }
  const int64_t brow = n * a.sb0 + h * a.sb1;
  const int64_t wrow = n * a.sw0 + i * a.sw1 - org.y * a.sw2;
  const int64_t bq = VEC * a.sb3, wq = VEC * a.sw3;
  TW* orow = out + static_cast<int64_t>(row) * len * VEC;
  const int64_t crow = (static_cast<int64_t>(a.cov_per_session ? s : 0)
                        * a.WH + i) * a.WW - org.y;
  for (Walk w(span.x + threadIdx.x, CV); w.f < span.y;) {
    int fs[kUnroll], js[kUnroll], qs[kUnroll];
    bool take[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      fs[u] = w.f;
      js[u] = w.j;
      qs[u] = w.q;
      take[u] = w.f < span.y && w.f >= lo && w.f < hi;
      w.next();
    }
    if (a.cov != nullptr) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (take[u]) take[u] = a.cov[crow + js[u]];
      }
    }
    Pack<TW, VEC> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (take[u]) {
        v[u] = load<TW, VEC>(win + wrow + js[u] * a.sw2 + qs[u] * wq);
      } else if (fs[u] < span.y) {
        v[u] = widen<TW, TB, VEC>(
            load<TB, VEC>(base + brow + js[u] * a.sb2 + qs[u] * bq));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (fs[u] < span.y) store(orow + static_cast<int64_t>(fs[u]) * VEC, v[u]);
    }
  }
}

template <typename T, bool EPI>
int launch_crop(int vec, dim3 grid, cudaStream_t st, const CropArgs& a) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {
    crop_sessions_f32<T, kVec, EPI><<<grid, kThreads, 0, st>>>(a);
  } else if (vec == 1) {
    crop_sessions_f32<T, 1, EPI><<<grid, kThreads, 0, st>>>(a);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TB, typename TW>
int launch_paste(int vec, dim3 grid, cudaStream_t st, const PasteArgs& a) {
  constexpr int kVec = 16 / sizeof(TW);
  if (vec == kVec) {
    paste_sessions_f32<TB, TW, kVec><<<grid, kThreads, 0, st>>>(a);
  } else if (vec == 1) {
    paste_sessions_f32<TB, TW, 1><<<grid, kThreads, 0, st>>>(a);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sige_crop_sessions(
    int dtype, int vec, int chunks, const void* x, void* out,
    const void* org, int org_k, int r_const, int c_const, int clamp, int N,
    int B, int H, int W, int C, int EH, int EW, int64_t sx0, int64_t sx1,
    int64_t sx2, int64_t sx3, const void* edge, int edge_per_session,
    const void* scale, int scale_rows, const void* shift, int shift_rows,
    int act, int act_first, int epilogue, void* stream) {
  CropArgs a{x, out,
             Origin{static_cast<const int64_t*>(org), org_k, r_const,
                    c_const, clamp},
             B, H, W, C, EH, EW, sx0, sx1, sx2, sx3,
             static_cast<const bool*>(edge), edge_per_session,
             Epilogue{static_cast<const float*>(scale),
                      static_cast<const float*>(shift), scale_rows,
                      shift_rows, act, act_first}};
  const dim3 grid(static_cast<unsigned>(N) * EH, chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && epilogue) {
    return launch_crop<float, true>(vec, grid, st, a);
  }
  if (dtype == kF32) return launch_crop<float, false>(vec, grid, st, a);
  if (dtype == kBF16 && !epilogue) {
    return launch_crop<__nv_bfloat16, false>(vec, grid, st, a);
  }
  return -1;  // a bf16 epilogue runs in PyTorch, after the crop
}

extern "C" int sige_paste_sessions(
    int base_dtype, int win_dtype, int vec, int chunks, const void* base,
    const void* win, void* out, const void* org, int org_k, int r_const,
    int c_const, int clamp, int N, int B, int H, int W, int C, int WH,
    int WW, int64_t sb0, int64_t sb1, int64_t sb2, int64_t sb3, int64_t sw0,
    int64_t sw1, int64_t sw2, int64_t sw3, const void* cov,
    int cov_per_session, void* stream) {
  PasteArgs a{base, win, out,
              Origin{static_cast<const int64_t*>(org), org_k, r_const,
                     c_const, clamp},
              B, H, W, C, WH, WW, sb0, sb1, sb2, sb3, sw0, sw1, sw2, sw3,
              static_cast<const bool*>(cov), cov_per_session};
  const dim3 grid(static_cast<unsigned>(N) * H, chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (base_dtype == kF32 && win_dtype == kF32) {
    return launch_paste<float, float>(vec, grid, st, a);
  }
  if (base_dtype == kBF16 && win_dtype == kF32) {
    return launch_paste<__nv_bfloat16, float>(vec, grid, st, a);
  }
  if (base_dtype == kBF16 && win_dtype == kBF16) {
    return launch_paste<__nv_bfloat16, __nv_bfloat16>(vec, grid, st, a);
  }
  return -1;
}
