"""Compress / decompress real hyperprior bitstream files (.nicx).

The codec half of the hyperprior workload: `hyperprior_comp` trains the
model; this entry turns a trained checkpoint into a practical codec —
image → single-file bitstream → image, with the bitstream bound to its
checkpoint by a parameter digest (decoding with the wrong model fails
loudly instead of producing garbage). No reference counterpart (the
reference has no entropy coding, SURVEY.md §0); this completes the north
star's "bitstream I/O kept host-side".

Run:
  python -m nic.cli.hyperprior_codec compress data/sancho_512.png \
      --ckpt runs/ckpt/hyperprior_lam0.018_n96_m128 --out sancho.nicx
  python -m nic.cli.hyperprior_codec decompress sancho.nicx \
      --ckpt runs/ckpt/hyperprior_lam0.018_n96_m128 --out sancho_dec.png
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _load_codec(ckpt: str, n: int, m: int):
    from nic.io.artifacts import CheckpointManager
    from nic.io.bitstream import params_digest
    from nic.train.hyperprior import HyperpriorCodec, HyperpriorTrainer

    trainer = HyperpriorTrainer(n=n, m=m, lam=0.0, patch=64, batch=1, seed=0)
    if os.path.isdir(ckpt):
        newest = CheckpointManager(ckpt).paths_newest_first()
        if not newest:
            raise FileNotFoundError(f"no checkpoints under {ckpt}")
        ckpt = newest[0]
    trainer.load_checkpoint(ckpt)  # asserts stored parameter shapes
    codec = HyperpriorCodec(trainer)
    info = {"n": n, "m": m, "params_digest": params_digest(trainer.params),
            "ckpt": os.path.basename(ckpt)}
    return codec, info


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("compress", help="image → .nicx bitstream")
    pc.add_argument("image")
    pc.add_argument("--out", default=None, help="default: <image>.nicx")
    pd = sub.add_parser("decompress", help=".nicx bitstream → image")
    pd.add_argument("bitstream")
    pd.add_argument("--out", default=None, help="default: <bitstream>.png")
    pd.add_argument("--allow_model_mismatch", action="store_true",
                    help="decode even if the checkpoint digest differs "
                         "(output will NOT match the encoded image)")
    for q in (pc, pd):
        q.add_argument("--ckpt", required=True,
                       help="checkpoint file or directory (newest used)")
        q.add_argument("--n", type=int, default=96)
        q.add_argument("--m", type=int, default=128)
    args = p.parse_args(argv)

    codec, info = _load_codec(args.ckpt, args.n, args.m)

    if args.cmd == "compress":
        from PIL import Image

        from nic.io.bitstream import write_nicx

        img = np.asarray(Image.open(args.image).convert("RGB"),
                         np.float32) / 255.0
        blob = codec.compress(img)
        out = args.out or (os.path.splitext(args.image)[0] + ".nicx")
        total = write_nicx(out, blob, info)
        px = img.shape[0] * img.shape[1]
        res = {"out": out, "bytes": total,
               "bpp": round(total * 8 / px, 4),
               "bpp_payload": round(codec.num_bits(blob) / px, 4)}
        print(f"wrote {out}: {total} bytes "
              f"({res['bpp']} bpp incl. header, {res['bpp_payload']} payload)")
        return res

    from nic.io.bitstream import read_nicx

    blob, model = read_nicx(args.bitstream)
    if model.get("params_digest") != info["params_digest"]:
        msg = (f"{args.bitstream} was encoded by model "
               f"{model.get('params_digest')} (ckpt {model.get('ckpt')}), "
               f"but --ckpt resolves to {info['params_digest']}")
        if not args.allow_model_mismatch:
            raise ValueError(msg + " — pass --allow_model_mismatch to force")
        print("WARNING:", msg)
    rec = codec.decompress(blob)
    out = args.out or (os.path.splitext(args.bitstream)[0] + ".png")
    from PIL import Image

    Image.fromarray((np.asarray(rec) * 255.0 + 0.5).astype(np.uint8)).save(out)
    print(f"wrote {out} ({rec.shape[0]}x{rec.shape[1]})")
    return {"out": out, "shape": list(rec.shape)}


if __name__ == "__main__":
    run(sys.argv[1:])
