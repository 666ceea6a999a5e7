// Native host planner of the PyTorch port: the per-edit planning that
// SIGEModel.set_masks runs on the host before the plan's one copy to the
// card (mask dilation, active-tile reduction, scatter source maps).
//
// A C ABI for ctypes (sige_torch/native/__init__.py builds this file with
// g++ at first use). The semantics are exactly those of the numpy paths
// in sige_torch/core/masks.py and sige_torch/core/scatter_map.py, which the
// tests hold it to bit for bit.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Binary box dilation by (dh, dw) via shift-OR
// (semantics of sige_torch.core.masks.dilate_mask).
void dilate_mask(const uint8_t* mask, uint8_t* out, int64_t H, int64_t W,
                 int64_t dh, int64_t dw) {
    std::memcpy(out, mask, H * W);
    // vertical passes
    for (int64_t d = 1; d <= dh; ++d) {
        for (int64_t i = 0; i < H - d; ++i)
            for (int64_t j = 0; j < W; ++j)
                out[i * W + j] |= mask[(i + d) * W + j];
        for (int64_t i = d; i < H; ++i)
            for (int64_t j = 0; j < W; ++j)
                out[i * W + j] |= mask[(i - d) * W + j];
    }
    // horizontal passes read the ORIGINAL mask (cross-shaped dilation,
    // exactly the reference's semantics: sige/utils.py:40-71)
    for (int64_t d = 1; d <= dw; ++d) {
        for (int64_t i = 0; i < H; ++i) {
            for (int64_t j = 0; j < W - d; ++j)
                out[i * W + j] |= mask[i * W + j + d];
            for (int64_t j = d; j < W; ++j)
                out[i * W + j] |= mask[i * W + j - d];
        }
    }
}

// Active-tile reduction: pad by (offset) top-left / (block) bottom-right,
// max-pool with (block, stride) windows, emit top-left indices in padded
// input coordinates (semantics of sige_torch.core.masks.reduce_mask,
// matching reference: sige/utils.py:8-37). Returns the live count;
// indices buffer must hold capacity rows of 2 int32 and is SENTINEL-padded.
int64_t reduce_mask(const uint8_t* mask, int64_t H, int64_t W,
                    int64_t bh, int64_t bw, int64_t sh, int64_t sw,
                    int64_t ph, int64_t pw, int32_t* indices,
                    int64_t capacity, int32_t sentinel) {
    const int64_t padded_h = H + ph + bh;
    const int64_t padded_w = W + pw + bw;
    const int64_t oh = (padded_h - bh) / sh + 1;
    const int64_t ow = (padded_w - bw) / sw + 1;
    int64_t n = 0;
    for (int64_t wy = 0; wy < oh; ++wy) {
        for (int64_t wx = 0; wx < ow; ++wx) {
            bool active = false;
            const int64_t y0 = wy * sh, x0 = wx * sw;
            for (int64_t dy = 0; dy < bh && !active; ++dy) {
                const int64_t y = y0 + dy - ph;
                if (y < 0 || y >= H) continue;
                for (int64_t dx = 0; dx < bw; ++dx) {
                    const int64_t x = x0 + dx - pw;
                    if (x < 0 || x >= W) continue;
                    if (mask[y * W + x]) { active = true; break; }
                }
            }
            if (active) {
                if (n < capacity) {
                    indices[2 * n] = static_cast<int32_t>(y0 - ph);
                    indices[2 * n + 1] = static_cast<int32_t>(x0 - pw);
                }
                ++n;
            }
        }
    }
    for (int64_t i = n; i < capacity; ++i) {
        indices[2 * i] = sentinel;
        indices[2 * i + 1] = sentinel;
    }
    return n;
}

// Per-pixel flat tile-pixel source map (semantics of
// sige_torch.core.scatter_map.build_src_map): owner = highest covering tile,
// src = (owner * R + ih) * S + iw, -1 uncovered.
void build_src_map(const int32_t* indices, int64_t count,
                   int64_t R, int64_t S, int64_t sh, int64_t sw,
                   int64_t oh, int64_t ow, int64_t H, int64_t W,
                   int32_t* src /* H*W, pre-filled by callee */) {
    std::fill(src, src + H * W, -1);
    for (int64_t k = 0; k < count; ++k) {
        const int64_t bi_h = (oh + static_cast<int64_t>(indices[2 * k])) / sh;
        const int64_t bi_w = (ow + static_cast<int64_t>(indices[2 * k + 1])) / sw;
        for (int64_t r = 0; r < R; ++r) {
            const int64_t y = bi_h + r;
            if (y < 0 || y >= H) continue;
            for (int64_t s = 0; s < S; ++s) {
                const int64_t x = bi_w + s;
                if (x < 0 || x >= W) continue;
                // ascending k: last writer wins = highest tile (the
                // reference's sequential CPU loop ordering)
                src[y * W + x] = static_cast<int32_t>((k * R + r) * S + s);
            }
        }
    }
}

// Fused scatter->re-gather lookups (semantics of
// sige_torch.core.scatter_map.build_sg_sources).
void build_sg_sources(const int32_t* indices, int64_t K, int64_t count,
                      const int32_t* src /* H*W */, int64_t H, int64_t W,
                      int64_t bh, int64_t bw,
                      int32_t* sg_src, int32_t* sg_flat /* K*bh*bw */) {
    for (int64_t k = 0; k < K; ++k) {
        const bool live = k < count;
        const int64_t r0 = indices[2 * k];
        const int64_t c0 = indices[2 * k + 1];
        for (int64_t r = 0; r < bh; ++r) {
            for (int64_t c = 0; c < bw; ++c) {
                const int64_t i = (k * bh + r) * bw + c;
                const int64_t y = r0 + r, x = c0 + c;
                const bool inb = live && y >= 0 && y < H && x >= 0 && x < W;
                const int64_t yc = std::min(std::max(y, int64_t(0)), H - 1);
                const int64_t xc = std::min(std::max(x, int64_t(0)), W - 1);
                sg_flat[i] = static_cast<int32_t>(yc * W + xc);
                sg_src[i] = inb ? src[yc * W + xc] : -2;
            }
        }
    }
}

}  // extern "C"
