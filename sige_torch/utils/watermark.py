"""Invisible watermark for generated images (DWT + DCT quantization) —
the port of ``sige_tpu.utils.watermark`` (numpy only, kept as a copy: the
port imports nothing of ``sige_tpu``).

The reference stamps every saved Stable Diffusion sample with an
invisible watermark: ``put_watermark`` (reference:
stable-diffusion/utils.py:42-47) runs imwatermark's ``dwtDct`` encoder
over the BGR image, with the payload ``b"StableDiffusionV1"`` set in
``BaseRunner.__init__`` (reference:
stable-diffusion/runners/base_runner.py:63-65) and applied to each saved
sample (base_runner.py:93).

This is a clean-room implementation of the same scheme family —
frequency-domain quantization-index modulation:

  1. RGB -> YUV (BT.601, the cv2 convention); bits go into the U chroma
     plane where they are least visible.
  2. One-level Haar DWT; only the LL (low-low) subband is touched, which
     makes the mark survive mild resampling/compression.
  3. The LL plane is tiled into 4x4 blocks; each block's DCT DC
     coefficient is quantized to an even or odd multiple of ``scale``
     (QIM) to carry one payload bit, cycling through the payload.

Decoding reads the quantization parity back and majority-votes each bit
position across all blocks that carried it.  Everything is plain numpy;
no cv2/pywt dependency.
"""

from __future__ import annotations

import numpy as np

# BT.601 full-range RGB<->YUV (what cv2.COLOR_BGR2YUV uses, expressed
# for RGB input).
_RGB2YUV = np.array(
    [[0.299, 0.587, 0.114],
     [-0.14713, -0.28886, 0.436],
     [0.615, -0.51499, -0.10001]], np.float64)
_YUV2RGB = np.linalg.inv(_RGB2YUV)

_BLOCK = 4


def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (rows are basis vectors)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] *= np.sqrt(0.5)
    return m


_DCT4 = _dct_matrix(_BLOCK)


def _haar_dwt2(x: np.ndarray):
    """One-level 2D Haar DWT -> (LL, (LH, HL, HH)). Even dims required."""
    a = (x[0::2] + x[1::2]) / np.sqrt(2.0)
    d = (x[0::2] - x[1::2]) / np.sqrt(2.0)
    ll = (a[:, 0::2] + a[:, 1::2]) / np.sqrt(2.0)
    lh = (a[:, 0::2] - a[:, 1::2]) / np.sqrt(2.0)
    hl = (d[:, 0::2] + d[:, 1::2]) / np.sqrt(2.0)
    hh = (d[:, 0::2] - d[:, 1::2]) / np.sqrt(2.0)
    return ll, (lh, hl, hh)


def _haar_idwt2(ll, bands):
    lh, hl, hh = bands
    a = np.empty((ll.shape[0], 2 * ll.shape[1]), ll.dtype)
    d = np.empty_like(a)
    a[:, 0::2] = (ll + lh) / np.sqrt(2.0)
    a[:, 1::2] = (ll - lh) / np.sqrt(2.0)
    d[:, 0::2] = (hl + hh) / np.sqrt(2.0)
    d[:, 1::2] = (hl - hh) / np.sqrt(2.0)
    x = np.empty((2 * a.shape[0], a.shape[1]), ll.dtype)
    x[0::2] = (a + d) / np.sqrt(2.0)
    x[1::2] = (a - d) / np.sqrt(2.0)
    return x


def _blocks(plane: np.ndarray):
    """View the plane as [nby, nbx, B, B] blocks (truncating remainders)."""
    h, w = plane.shape
    nby, nbx = h // _BLOCK, w // _BLOCK
    t = plane[:nby * _BLOCK, :nbx * _BLOCK]
    return t.reshape(nby, _BLOCK, nbx, _BLOCK).swapaxes(1, 2), nby, nbx


def bytes_to_bits(payload: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(payload, np.uint8))


def bits_to_bytes(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, np.uint8)).tobytes()


class WatermarkEncoder:
    """Embed/extract a byte payload (API mirrors imwatermark enough for
    the runner: ``set_watermark('bytes', payload)`` + ``encode``)."""

    def __init__(self, payload: bytes = b"StableDiffusionV1",
                 scale: float = 36.0):
        self.scale = float(scale)
        self.bits = bytes_to_bits(payload)
        self.n_payload_bytes = len(payload)

    def set_watermark(self, kind: str, payload: bytes) -> None:
        if kind != "bytes":
            raise ValueError(f"unsupported watermark kind: {kind}")
        self.bits = bytes_to_bits(payload)
        self.n_payload_bytes = len(payload)

    # -- embed ---------------------------------------------------------
    def encode(self, img: np.ndarray) -> np.ndarray:
        """img: [H, W, 3] uint8 RGB; returns the stamped uint8 copy."""
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError("expected [H, W, 3] RGB image")
        h, w = img.shape[:2]
        he, we = h - h % 2, w - w % 2  # Haar needs even dims
        yuv = img[:he, :we].astype(np.float64) @ _RGB2YUV.T
        u = yuv[:, :, 1]
        ll, bands = _haar_dwt2(u)
        blk, nby, nbx = _blocks(ll)
        # DCT per block; QIM on the DC coefficient
        dct = np.einsum("ab,yxbc,dc->yxad", _DCT4, blk, _DCT4)
        dc = dct[:, :, 0, 0]
        idx = (np.arange(nby * nbx) % self.bits.size).reshape(nby, nbx)
        bit = self.bits[idx].astype(np.float64)
        q = np.floor(dc / self.scale)
        # choose the multiple with matching parity nearest to dc
        parity = np.mod(q, 2.0)
        q = np.where(parity == bit, q, q + 1.0)  # (q+1) flips parity
        dct[:, :, 0, 0] = (q + 0.5) * self.scale
        blk2 = np.einsum("ba,yxbc,cd->yxad", _DCT4, dct, _DCT4)
        ll2 = ll.copy()
        ll2[:nby * _BLOCK, :nbx * _BLOCK] = (
            blk2.swapaxes(1, 2).reshape(nby * _BLOCK, nbx * _BLOCK))
        u2 = _haar_idwt2(ll2, bands)
        yuv[:, :, 1] = u2
        out = img.astype(np.float64).copy()
        out[:he, :we] = yuv @ _YUV2RGB.T
        return np.clip(np.round(out), 0, 255).astype(np.uint8)

    # -- extract -------------------------------------------------------
    def decode(self, img: np.ndarray) -> bytes:
        """Recover the payload bytes by per-bit majority vote."""
        h, w = img.shape[:2]
        he, we = h - h % 2, w - w % 2
        yuv = img[:he, :we].astype(np.float64) @ _RGB2YUV.T
        ll, _ = _haar_dwt2(yuv[:, :, 1])
        blk, nby, nbx = _blocks(ll)
        dct = np.einsum("ab,yxbc,dc->yxad", _DCT4, blk, _DCT4)
        dc = dct[:, :, 0, 0].ravel()
        votes = np.mod(np.floor(dc / self.scale), 2.0)
        idx = np.arange(dc.size) % self.bits.size
        ones = np.bincount(idx, weights=votes, minlength=self.bits.size)
        tot = np.bincount(idx, minlength=self.bits.size)
        bits = (ones * 2 > tot).astype(np.uint8)
        return bits_to_bytes(bits)[:self.n_payload_bytes]


def put_watermark(img: np.ndarray,
                  wm_encoder: "WatermarkEncoder | None" = None) -> np.ndarray:
    """Stamp a uint8 RGB image; no-op when no encoder is given
    (reference: stable-diffusion/utils.py:42-47)."""
    if wm_encoder is None:
        return img
    return wm_encoder.encode(img)
