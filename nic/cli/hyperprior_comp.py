"""Hyperprior rate–distortion codec workload (north-star extension; no
reference counterpart — the reference's rate is fixed num_bits).

Train R+λD on a directory of images, then evaluate PSNR/bpp (estimated
rate AND the real rANS bitstream size) on an eval set — the Kodak-style
harness (point it at a Kodak directory when one is available).

Run:
  python -m nic.cli.hyperprior_comp --train_dir data --eval_dir data \
      --steps 20000 --lam 0.01
"""

from __future__ import annotations

import argparse
import datetime
import glob
import json
import os
import sys

import numpy as np

from nic.obs.log import RunLog, ScalarWriter, make_filename_by_seq


def _load_images(paths):
    from PIL import Image

    out = []
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        out.append(img)
    return out


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_dir", default="data")
    p.add_argument("--eval_dir", default="data")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--lam", type=float, default=0.01)
    p.add_argument("--n", type=int, default=96)
    p.add_argument("--m", type=int, default=128)
    p.add_argument("--patch", type=int, default=256)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--interval_print", type=int, default=500)
    p.add_argument("--interval_checkpoint", type=int, default=2000)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint for this "
                        "(lam, n, m) config — segmented-run pattern for "
                        "flaky chips")
    p.add_argument("--output_root", default="runs")
    args = p.parse_args(argv)

    from nic.train.hyperprior import HyperpriorCodec, HyperpriorTrainer, eval_image_set

    name = f"hyperprior_lam{args.lam}_{args.steps}"
    out = lambda *q: os.path.join(args.output_root, *q)
    log = RunLog(make_filename_by_seq(out("printlog"), f"{name}.txt"))
    log(datetime.datetime.now())

    exts = ("*.png", "*.jpg", "*.jpeg")
    train_paths = sorted(q for e in exts for q in glob.glob(os.path.join(args.train_dir, e)))
    eval_paths = sorted(q for e in exts for q in glob.glob(os.path.join(args.eval_dir, e)))
    if not train_paths:
        raise FileNotFoundError(f"no images under {args.train_dir}")
    log(f"train images: {len(train_paths)}, eval images: {len(eval_paths)}")

    # patch size must fit the smallest training image
    imgs = _load_images(train_paths)
    min_side = min(min(i.shape[0], i.shape[1]) for i in imgs)
    patch = min(args.patch, 1 << (min_side.bit_length() - 1))
    trainer = HyperpriorTrainer(
        n=args.n, m=args.m, lam=args.lam, lr=args.lr, patch=patch,
        batch=args.batch, seed=args.seed,
    )
    writer = ScalarWriter(out("log", name), out("log", f"{name}_scalars.csv"))
    rng = np.random.default_rng(args.seed + 1)

    from nic.io.artifacts import CheckpointManager

    # step-count-agnostic key so a stalled run resumes under a larger --steps
    ckpt_mgr = CheckpointManager(
        out("ckpt", f"hyperprior_lam{args.lam}_n{args.n}_m{args.m}"), keep=2
    )
    if args.resume:
        for ckpt_path in ckpt_mgr.paths_newest_first():
            try:
                trainer.load_checkpoint(ckpt_path)
            except Exception as e:  # noqa: BLE001
                log(f"checkpoint {ckpt_path} unreadable ({e!r}); trying older")
                continue
            # the patch RNG stream restarts; statistically equivalent crops
            rng = np.random.default_rng(args.seed + 1 + trainer.step)
            log(f"resumed from {ckpt_path} at step {trainer.step}")
            break

    # compiled lax.scan chunks with on-device crop sampling: one dispatch
    # (zero per-step uploads/syncs) per interval — the per-step path moves
    # ~6 MB host→device and syncs every step
    staged = trainer.stage_images(imgs)
    import time as _time

    with log.span("train time"):
        while trainer.step < args.steps:
            start = trainer.step
            n = min(args.interval_print - start % args.interval_print,
                    args.steps - start)
            next_ckpt = ((start // args.interval_checkpoint) + 1) * args.interval_checkpoint
            n = min(n, next_ckpt - start)
            t0 = _time.perf_counter()
            lh, bh, mh = trainer.train_chunk(staged, n)
            dt = _time.perf_counter() - t0
            for i in range(n):
                writer.add_scalar("Loss/rd", float(lh[i]), start + i + 1)
                writer.add_scalar("Rate/bpp", float(bh[i]), start + i + 1)
            step = trainer.step
            if step % args.interval_print == 0:
                log(f"step {step}/{args.steps} loss {float(lh[-1]):.4f} "
                    f"bpp {float(bh[-1]):.3f} mse {float(mh[-1]):.6f} "
                    f"({n / dt:.1f} steps/s)")
            if step % args.interval_checkpoint == 0:
                trainer.save_checkpoint(ckpt_mgr.path_for(step))
                ckpt_mgr.prune()

    res = eval_image_set(trainer, eval_paths)
    codec = HyperpriorCodec(trainer)
    real_bpps = []
    for path, row in zip(eval_paths, res["images"]):
        img = _load_images([path])[0]
        blob = codec.compress(img)
        real = codec.num_bits(blob) / (img.shape[0] * img.shape[1])
        row["bpp_bitstream"] = real
        real_bpps.append(real)
        log(f"{row['image']}: psnr {row['psnr']:.2f} bpp_est {row['bpp']:.3f} "
            f"bpp_real {real:.3f}")
    res["mean_bpp_bitstream"] = float(np.mean(real_bpps))
    log(f"mean psnr {res['mean_psnr']:.2f}  mean bpp {res['mean_bpp']:.3f}  "
        f"mean bpp (bitstream) {res['mean_bpp_bitstream']:.3f}")
    json.dump(res, open(out(f"{name}_eval.json"), "w"), indent=1)
    writer.close()
    log(datetime.datetime.now())
    return res


if __name__ == "__main__":
    run(sys.argv[1:])
