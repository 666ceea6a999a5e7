"""Quality-metric dispatcher (reference: diffusion/get_metric.py,
gaugan/get_metric.py) — the port of ``sige_tpu.cli.get_metric``.

  python -m sige_torch.cli.get_metric --metric psnr \
      --root results/ --gt_root database/gt/ [--mask_root masks/]
  python -m sige_torch.cli.get_metric --metric fid --root a/ --gt_root b/ \
      --inception_weights inception_v3.pth
  python -m sige_torch.cli.get_metric --metric lpips --root a/ --gt_root b/ \
      --backbone_weights alexnet.pth --lpips_weights alex.pth
  python -m sige_torch.cli.get_metric --metric miou --root preds/ --gt_root gts/ \
      [--drn_weights drn-d-105_ms_cityscapes.pth]

Images are matched by filename between --root and --gt_root; mIoU expects
.npy label maps (raw Cityscapes ids are mapped to trainIds), or segments
the images of --root with --drn_weights. The backbones run on the GPU
unless ``--device cpu`` is given; PSNR needs neither.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .common import add_device_flag


def _pairs(root, gt_root, exts=(".png", ".jpg", ".npy")):
    names = sorted(
        f for f in os.listdir(root) if os.path.splitext(f)[1] in exts)
    for name in names:
        stem = os.path.splitext(name)[0]
        for ext in (os.path.splitext(name)[1], ".npy", ".png", ".jpg"):
            gt = os.path.join(gt_root, stem + ext)
            if os.path.exists(gt):
                yield name, os.path.join(root, name), gt
                break


def _load(path):
    if path.endswith(".npy"):
        return np.load(path)
    from ..data import load_image

    return load_image(path) * 255.0


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--metric", required=True,
                   choices=("psnr", "lpips", "fid", "miou"))
    p.add_argument("--root", required=True, help="generated results dir")
    p.add_argument("--gt_root", required=True, help="ground-truth dir")
    p.add_argument("--mask_root", default=None,
                   help="optional .npy masks restricting PSNR/LPIPS/mIoU")
    p.add_argument("--inception_weights", default=None,
                   help="local torchvision inception_v3 state dict (FID)")
    p.add_argument("--backbone_weights", "--vgg_weights", dest="backbone_weights",
                   default=None,
                   help="local torchvision alexnet state dict (LPIPS)")
    p.add_argument("--lpips_weights", default=None,
                   help="the lpips package's alex.pth lin heads")
    p.add_argument("--drn_weights", default=None,
                   help="local drn-d-105_ms_cityscapes.pth; with it, mIoU "
                        "segments the images in --root instead of reading "
                        "precomputed .npy predictions")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None) -> float:
    """Run the CLI on ``argv`` (default: the command line); prints the
    metric's line and returns its value."""
    args = get_args(argv)
    from .. import metrics

    def mask_for(name):
        if args.mask_root is None:
            return None
        path = os.path.join(args.mask_root,
                            os.path.splitext(name)[0] + ".npy")
        return np.load(path) if os.path.exists(path) else None

    if args.metric == "psnr":
        vals = [metrics.psnr(_load(a), _load(b), mask=mask_for(n))
                for n, a, b in _pairs(args.root, args.gt_root)]
        value = float(np.mean(vals))
        print(f"PSNR: {value:.4f} over {len(vals)} images")
    elif args.metric == "lpips":
        lp = metrics.LPIPS(args.backbone_weights, args.lpips_weights,
                           device=args.device)
        vals = [lp(_load(a) / 255.0, _load(b) / 255.0, mask=mask_for(n))
                for n, a, b in _pairs(args.root, args.gt_root)]
        value = float(np.mean(vals))
        print(f"LPIPS: {value:.4f} over {len(vals)} images")
    elif args.metric == "fid":
        feat = metrics.fid.make_inception_feature_fn(args.inception_weights,
                                                     device=args.device)
        pairs = list(_pairs(args.root, args.gt_root))
        a = np.stack([_load(a) / 255.0 for _, a, _ in pairs])
        b = np.stack([_load(b) / 255.0 for _, _, b in pairs])
        value = metrics.compute_fid(a, b, feat)
        print(f"FID: {value:.4f}")
    else:  # miou
        seg = None
        if args.drn_weights:
            from ..metrics.backbones import CityscapesSegmenter
            from ..utils.convert import load_torch_state_dict

            seg = CityscapesSegmenter(load_torch_state_dict(args.drn_weights),
                                      device=args.device)
        conf = np.zeros((19, 19), np.int64)
        n = 0
        exts = (".png", ".jpg") if seg else (".npy",)
        for name, a, b in _pairs(args.root, args.gt_root, exts=exts):
            if seg is not None:
                pred = seg(_load(a) / 255.0)  # already trainIds
            else:
                pred = metrics.to_train_ids(np.load(a))
            gt = metrics.to_train_ids(np.load(b))
            conf += metrics.confusion_matrix(pred, gt, mask=mask_for(name))
            n += 1
        value = metrics.mean_iou(conf)
        print(f"mIoU: {value:.4f} over {n} maps")
    return value


if __name__ == "__main__":
    main()
