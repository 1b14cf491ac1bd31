"""Image-set (Kodak-protocol) rate–distortion evaluation harness.

North-star extension — the reference evaluates only the single overfit
asset (``Projects/image_compression.py:482-489`` of
21K1113/Neural_Image_Compression_V2 prints per-mip PSNR of the one trained
image); nothing in it can walk a directory. This harness takes ANY
directory of images (point it at Kodak when available; the bundled
``data/`` works out of the box) and reports per-image + mean PSNR/bpp as
one JSON:

- ``--codec ntc`` — the reference's own protocol generalized to a set:
  each image is independently overfit by the NTC feature-pyramid trainer
  (``NUM_EPOCHS`` epochs at ``FP_BITS``) and scored against its true
  artifact payload (packed grids + stored-dtype MLP weights, entropy
  coding honored). Non-square inputs are center-cropped to the largest
  square and resized to ``IMAGE_SIZE`` (the pyramid needs a power-of-two
  square) — recorded in the JSON so numbers are comparable.
- ``--codec hyperprior`` — a single TRAINED model (from a
  ``hyperprior_comp`` run's checkpoint) evaluated across the set, with
  both the estimated rate and the real rANS bitstream size.

Run:
  python -m nic.cli.eval_rd --dir data --codec ntc NUM_EPOCHS=2000 FP_BITS=8
  python -m nic.cli.eval_rd --dir kodak --codec hyperprior \
      --ckpt runs/ckpt/hyperprior_lam0.01_n96_m128
"""

from __future__ import annotations

import argparse
import datetime
import glob
import json
import os
import sys

import numpy as np

from nic.obs.log import RunLog, make_filename_by_seq

_EXTS = ("*.png", "*.jpg", "*.jpeg")


def list_images(directory: str) -> list[str]:
    paths = sorted(q for e in _EXTS for q in glob.glob(os.path.join(directory, e)))
    if not paths:
        raise FileNotFoundError(f"no images under {directory}")
    return paths


def _load_native(path: str) -> np.ndarray:
    """[3, H, W] float in [0, 1] at the file's OWN geometry (no crop, no
    resize). H and W must be multiples of 4 (the pyramid downsamples 4x;
    Kodak's 768x512 / 512x768 qualify natively)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    if h % 4 or w % 4:
        raise ValueError(f"{path}: native geometry needs H, W % 4 == 0 "
                         f"(got {h}x{w})")
    return (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)


def _load_square(path: str, size: int) -> np.ndarray:
    """[3, size, size] float in [0, 1]: center-crop to square, resize."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2, (w - s) // 2 + s, (h - s) // 2 + s))
    if s != size:
        img = img.resize((size, size), Image.BILINEAR)
    return (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)


def eval_ntc(paths: list[str], cfg, log, chunk: int = 2000,
             native: bool = False) -> dict:
    """Per-image NTC overfit (the reference protocol, per set member).

    ``native=True`` scores every image at its OWN geometry (768x512 Kodak
    frames train and decode rectangular — no center-crop, no resize);
    the per-image config carries IMAGE_SIZE(_W) from the file."""
    import dataclasses
    import tempfile

    from nic.core.metrics import psnr as psnr_fn
    from nic.core.quant import quantize_to_bit
    from nic.io.artifacts import save_compressed
    from nic.train.ntc import NTCTrainer

    rows = []
    for path in paths:
        if native:
            img = _load_native(path)
            cfg_i = dataclasses.replace(
                cfg, image_size=img.shape[1], image_size_w=img.shape[2],
                tf_no_mip=True)
        else:
            img = _load_square(path, cfg.image_size)
            cfg_i = cfg
        trainer = NTCTrainer(cfg_i, [img])
        trainer.train_many(cfg.num_epochs, chunk=chunk)
        trainer.freeze_and_quantize()
        rec = np.asarray(trainer.decode(0))
        rec_codes = np.asarray(quantize_to_bit(rec, cfg.output_bits))
        tgt = np.asarray(
            quantize_to_bit(img.transpose(1, 2, 0), cfg.output_bits)
        )
        p = float(psnr_fn(rec_codes, tgt, max_value=255.0))
        with tempfile.TemporaryDirectory() as td:
            bits = save_compressed(
                os.path.join(td, "a.npz"), trainer.state.mlp,
                trainer.state.fp, cfg.fp_bits, {"save_name": "eval_rd"},
                mlp_store_bits=cfg.mlp_store_bits,
                entropy_coded=cfg.entropy_code_grids,
            )
        bpp = bits / (img.shape[1] * img.shape[2])
        rows.append({"image": os.path.basename(path), "psnr": p, "bpp": bpp})
        log(f"{os.path.basename(path)}: psnr {p:.2f} bpp {bpp:.3f}")
    return {
        "codec": "ntc",
        "protocol": {
            "image_size": cfg.image_size, "fp_bits": cfg.fp_bits,
            "num_epochs": cfg.num_epochs,
            "mlp_store_bits": cfg.mlp_store_bits,
            "entropy_code_grids": cfg.entropy_code_grids,
            "geometry": ("native (per-image rectangular)" if native else
                         "center-crop to square, bilinear resize"),
        },
        "images": rows,
        "mean_psnr": float(np.mean([r["psnr"] for r in rows])),
        "mean_bpp": float(np.mean([r["bpp"] for r in rows])),
    }


def eval_hyperprior(paths: list[str], args, log) -> dict:
    """One trained hyperprior model across the set (PSNR, estimated bpp,
    real rANS bitstream bpp)."""
    from PIL import Image

    from nic.io.artifacts import CheckpointManager
    from nic.train.hyperprior import (HyperpriorCodec, HyperpriorTrainer,
                                      eval_image_set)

    trainer = HyperpriorTrainer(n=args.n, m=args.m, lam=args.lam,
                                patch=64, batch=1, seed=0)
    ckpt = args.ckpt
    if os.path.isdir(ckpt):
        mgr = CheckpointManager(ckpt)
        newest = mgr.paths_newest_first()
        if not newest:
            raise FileNotFoundError(f"no checkpoints under {ckpt}")
        ckpt = newest[0]
    trainer.load_checkpoint(ckpt)
    log(f"hyperprior from {ckpt} (step {trainer.step})")

    res = eval_image_set(trainer, paths)
    codec = HyperpriorCodec(trainer)
    real_bpps = []
    for path, row in zip(paths, res["images"]):
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        blob = codec.compress(img)
        real = codec.num_bits(blob) / (img.shape[0] * img.shape[1])
        row["bpp_bitstream"] = real
        real_bpps.append(real)
        log(f"{row['image']}: psnr {row['psnr']:.2f} bpp_est {row['bpp']:.3f} "
            f"bpp_real {real:.3f}")
    res["codec"] = "hyperprior"
    res["checkpoint"] = ckpt
    res["mean_bpp_bitstream"] = float(np.mean(real_bpps))
    return res


def run(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    # split UPPERCASE KEY=VALUE config overrides (NTC protocol knobs) from
    # the harness's own --flags
    overrides = [a for a in argv if "=" in a and not a.startswith("-")]
    rest = [a for a in argv if a not in overrides]

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", default="data", help="directory of images")
    p.add_argument("--native-geometry", action="store_true",
                   help="score each image at its own (possibly "
                        "rectangular) geometry - no crop/resize")
    p.add_argument("--codec", choices=("ntc", "hyperprior"), default="ntc")
    p.add_argument("--ckpt", default=None,
                   help="hyperprior checkpoint file or directory")
    p.add_argument("--lam", type=float, default=0.01)
    p.add_argument("--n", type=int, default=96)
    p.add_argument("--m", type=int, default=128)
    p.add_argument("--out", default=None, help="output JSON path")
    p.add_argument("--output_root", default="runs")
    args = p.parse_args(rest)

    from nic.config import parse_overrides

    cfg = parse_overrides(overrides)
    name = f"eval_rd_{args.codec}_{os.path.basename(os.path.abspath(args.dir))}"
    if args.codec == "ntc":
        name += f"_fp{cfg.fp_bits}"  # one JSON per rate point, no clobber
    log = RunLog(make_filename_by_seq(
        os.path.join(args.output_root, "printlog"), f"{name}.txt"))
    log(datetime.datetime.now())

    paths = list_images(args.dir)
    log(f"{len(paths)} images under {args.dir}")
    if args.codec == "ntc":
        res = eval_ntc(paths, cfg, log, native=args.native_geometry)
    else:
        if not args.ckpt:
            raise SystemExit("--codec hyperprior requires --ckpt")
        res = eval_hyperprior(paths, args, log)
    res["dir"] = args.dir
    log(f"mean psnr {res['mean_psnr']:.2f}  mean bpp {res['mean_bpp']:.3f}")
    out_path = args.out or os.path.join(args.output_root, f"{name}.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    log(f"wrote {out_path}")
    log(datetime.datetime.now())
    return res


if __name__ == "__main__":
    run()
