"""Shared scaffolding for the conv-AE / pixel workload CLIs.

Each reference entry script repeats the same skeleton: parse simple flags,
train/load, encode→uint8 .npy, decode, PSNR, export (SURVEY.md §2.2).
This module centralizes it; unlike the reference, all scripts share one
tested implementation (and the ``basename``-undefined import crash of
pixel_comp.py:32 / image_comp.py:29 is gone by construction).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nic.core.metrics import psnr, average_psnr
from nic.obs.log import RunLog, ScalarWriter


def standard_parser(description: str, **defaults) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--image_path", default=defaults.get("image_path", "data/sancho_512.png"))
    p.add_argument("--num_epochs", type=int, default=defaults.get("num_epochs", 1000))
    p.add_argument("--num_bits", type=int, default=defaults.get("num_bits", 8))
    p.add_argument("--image_size", type=int, default=defaults.get("image_size", 512))
    p.add_argument("--latent_channels", type=int, default=defaults.get("latent_channels", 8))
    p.add_argument("--hidden_channels", type=int, default=defaults.get("hidden_channels", 16))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--train_model", type=lambda v: v.lower() in ("true", "1"), default=True)
    p.add_argument("--save_model", type=lambda v: v.lower() in ("true", "1"), default=True)
    p.add_argument("--resume", default=None, help="checkpoint path to resume from")
    p.add_argument("--resume_step", type=int, default=None)
    p.add_argument("--interval_print", type=int, default=100)
    p.add_argument("--interval_checkpoint", type=int, default=100000)
    p.add_argument("--qat_ste", type=lambda v: v.lower() in ("true", "1"), default=False)
    p.add_argument("--output_root", default="runs")
    p.add_argument("--data_parallel", type=lambda v: v.lower() in ("true", "1"),
                   default=False,
                   help="shard the frame/sheet-row axis over the device mesh")
    return p


def maybe_mesh(args, log: RunLog):
    """('data', 'pixel') mesh over all visible devices when
    --data_parallel is set (frames/sheet rows shard over 'data')."""
    if not getattr(args, "data_parallel", False):
        return None
    from nic.parallel.mesh import make_mesh

    mesh = make_mesh()
    log(f"data parallel over mesh {dict(mesh.shape)}")
    return mesh


def save_name(project: str, args) -> str:
    base = os.path.basename(args.image_path)
    return f"{project}_jax_{base}_{args.num_epochs}_{args.num_bits}"


def run_training(trainer, args, log: RunLog, writer: ScalarWriter | None,
                 project: str):
    """Shared train loop with interval prints and checkpoints."""
    import time

    from nic.io.artifacts import save_checkpoint

    out_dir = os.path.join(args.output_root, "model")
    name = save_name(project, args)
    with log.span("train time"):
        for epoch in range(trainer.step, args.num_epochs):
            t0 = time.perf_counter()
            loss = trainer.train_step()
            step = epoch + 1
            if writer is not None:
                writer.add_scalar("Loss/train_epoch_label", float(loss), step)
                writer.add_scalar("Time/epoch_label", time.perf_counter() - t0, step)
            if step % args.interval_print == 0:
                log(f"Epoch [{step}/{args.num_epochs}], Loss: {float(loss):.4f}")
            if step % args.interval_checkpoint == 0:
                save_checkpoint(
                    os.path.join(out_dir, f"{name}_{epoch}.ckpt.npz"),
                    step, trainer.params, trainer.opt_state,
                )
    save_checkpoint(os.path.join(out_dir, f"{name}.ckpt.npz"),
                    trainer.step, trainer.params, trainer.opt_state)


def maybe_resume(trainer, args, log: RunLog, project: str) -> None:
    """encode_from_middle parity (movie_3d_comp.py:29-35): restore params
    + opt state from a step-tagged checkpoint."""
    from nic.io.artifacts import load_checkpoint

    path = args.resume
    if path is None and args.resume_step is not None:
        path = os.path.join(
            args.output_root, "model",
            f"{save_name(project, args)}_{args.resume_step}.ckpt.npz",
        )
    if path:
        step, trainer.params, trainer.opt_state = load_checkpoint(
            path, trainer.params, trainer.opt_state
        )
        trainer.step = step
        log(f"resumed from {path} at step {step}")


def report_image(log: RunLog, original_hw3: np.ndarray, rec_hw3: np.ndarray,
                 path_png: str | None):
    rec_u8 = np.clip(np.asarray(rec_hw3) * 255.0, 0, 255).astype(np.uint8)
    if path_png:
        from nic.data.assets import save_png

        save_png(rec_u8, path_png)
    p = float(psnr(original_hw3 * 255.0, rec_u8.astype(np.float32)))
    p255 = float(psnr(original_hw3 * 255.0, rec_u8.astype(np.float32), max_value=255.0))
    log(f"psnr: {p} (255-max: {p255})")
    return p


def report_video(log: RunLog, original_thw3: np.ndarray, rec_thw3: np.ndarray,
                 path_avi: str | None):
    rec_u8 = np.clip(np.asarray(rec_thw3) * 255.0, 0, 255).astype(np.uint8)
    if path_avi:
        from nic.data.assets import write_timelaps

        write_timelaps(rec_u8, path_avi)
    p = float(average_psnr(original_thw3 * 255.0, rec_u8.astype(np.float32)))
    log(f"average psnr: {p}")
    return p
