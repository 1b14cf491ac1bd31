"""Flagship NTC/LUT compression workload.

Mirrors the reference's ``Projects/image_compression.py`` flow
(21K1113/Neural_Image_Compression_V2) end-to-end: config echo → asset load
(image mips / video volume / npy LUT, method-2 3D→2D flattening) → QAT
training with TensorBoard scalars and periodic full-decode PSNR → packed
artifact save (single .npz instead of model/ + feature_pyramid/ dirs) →
per-mip decode + PNG/AVI export → PSNR report (both the reference's
256-max convention and the standard 255 one) + bpp.

Run: ``python -m nic.cli.image_compression [KEY=VALUE ...]`` with the
reference's UPPERCASE keys (var2.py whitelist).
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np

from nic.config import CompressionConfig, config_echo, parse_overrides
from nic.core.metrics import psnr, average_psnr
from nic.core.quant import quantize_to_bit
from nic.data import assets
from nic.io.artifacts import load_compressed, save_compressed
from nic.obs.log import RunLog, ScalarWriter, log_safe_statistics, make_filename_by_seq


def load_asset(cfg: CompressionConfig):
    """images list per mip (image_compression.py:429-477 semantics)."""
    if cfg.image_dimension == 2:
        if cfg.compression_method != 1:
            raise ValueError("COMPRESSION_METHOD must be 1 for 2d image")
        return assets.load_image_mips(
            cfg.image_path, cfg.image_size, cfg.effective_max_mip_level,
            image_size_w=cfg.image_size_w,
        )
    # 3D input
    if cfg.compression_method == 1:
        raise ValueError("COMPRESSION_METHOD must not be 1 for 3d image")
    volume = assets.load_volume(cfg.image_path, cfg.image_bits)  # [T,H,W,3] codes
    if cfg.compression_method == 2:
        sheet = assets.flatten_3d_to_2d(volume.astype(np.uint8), cfg.image_size)
        mips = []
        for i in range(cfg.effective_max_mip_level + 1):
            s = cfg.image_size // (2**i)
            arr = assets.resize_bilinear(sheet, s, s).astype(np.float32) / 255.0
            mips.append(arr.transpose(2, 0, 1))
        return mips
    # methods 3/4: [3, T, H, W] in [0,1); the reference divides by 2^bits
    # (image_compression.py:475) and reuses the full-res volume at every mip
    vol = volume.transpose(3, 0, 1, 2).astype(np.float32) / (2.0**cfg.image_bits)
    return [vol] * (cfg.effective_max_mip_level + 1)


def run(argv=None) -> dict:
    cfg = parse_overrides(argv if argv is not None else sys.argv[1:])
    out = lambda *parts: os.path.join(cfg.output_root, *parts)
    log = RunLog(make_filename_by_seq(out("printlog"), f"{cfg.save_name}.txt"))
    log(datetime.datetime.now())
    for line in config_echo(cfg):
        log(line)

    writer = ScalarWriter(
        out("log", cfg.save_name) if (cfg.tf_write_time or cfg.tf_write_psnr) else None,
        out("log", f"{cfg.save_name}_scalars.csv"),
    )
    images = load_asset(cfg)
    artifact = out("artifacts", f"{cfg.save_name}.npz")

    def fetch(fn):
        # SDC_GUARD_DECODE=True: two executions must agree bit-for-bit
        # before a decode is scored or exported (nic.obs.integrity)
        if cfg.sdc_guard_decode:
            from nic.obs.integrity import verified_result

            return verified_result(fn, warn=log)
        return fn()

    from nic.train.ntc import NTCTrainer

    mesh = None
    if cfg.data_parallel:
        from nic.parallel.mesh import make_mesh

        mesh = make_mesh()  # all visible devices, crops data-parallel
        log(f"data parallel over mesh {mesh.shape}")
    trainer = NTCTrainer(cfg, images, mesh=mesh, log=log)
    for g in trainer.state.fp:
        log_safe_statistics(g, log)

    import time

    # preemption-safe checkpoints (params + optimizer state + step), kept
    # alongside the interval artifacts; TF_RESUME=True continues from the
    # newest one
    from nic.io.artifacts import CheckpointManager

    # epoch-count-agnostic checkpoint key: the same asset/method/bits run
    # resumes whether re-launched identically (stall recovery) or with a
    # larger NUM_EPOCHS (run extension)
    ckpt_key = (f"{cfg.project_name}_{cfg.basename}_{cfg.compression_method}_"
                f"{cfg.fp_bits}_{cfg.mlp_num_dtype}")
    ckpt_mgr = CheckpointManager(out("ckpt", ckpt_key), keep=2)
    if cfg.tf_resume:
        # newest-first with fallback: writes are atomic, but a snapshot can
        # still be bad (disk error, older format) — never let one dead file
        # kill the resume when an older good one exists
        for ckpt_path in ckpt_mgr.paths_newest_first():
            try:
                trainer.load_checkpoint(ckpt_path)
            except Exception as e:  # noqa: BLE001 — any unreadable snapshot
                log(f"checkpoint {ckpt_path} unreadable ({e!r}); trying older")
                continue
            log(f"resumed from {ckpt_path} at step {trainer.state.step}")
            break

    results = {"psnr": [], "psnr_255": [], "bpp": None, "train_chunks": []}
    if cfg.tf_train_model:
        with log.span("train time"):
            # chunked compiled training: one device dispatch per
            # interval_print block (lax.scan) instead of per epoch
            chunk_idx = 0
            while trainer.state.step < cfg.num_epochs:
                start = trainer.state.step
                n = min(cfg.interval_print - start % cfg.interval_print,
                        cfg.num_epochs - start)
                next_save = ((start // cfg.interval_save_model) + 1) * cfg.interval_save_model
                n = min(n, next_save - start)
                t0 = time.perf_counter()
                # PROFILE_DIR: capture the device timeline of exactly one
                # post-warmup compiled chunk (chunk 0 pays the compile)
                if cfg.profile_dir and chunk_idx == 1:
                    from nic.obs.trace import profile_trace

                    with profile_trace(cfg.profile_dir):
                        losses, psnrs = trainer.train_many(n)
                    log(f"jax.profiler trace ({n} steps) → {cfg.profile_dir}")
                else:
                    losses, psnrs = trainer.train_many(n)
                chunk_idx += 1
                chunk_s = time.perf_counter() - t0
                elapsed = chunk_s / n
                # (steps, wall seconds incl. the loss fetch, last loss,
                # mean loss)
                results["train_chunks"].append(
                    (int(n), chunk_s, float(losses[-1]),
                     float(np.mean(losses))))
                for i in range(n):
                    step = start + i + 1
                    writer.add_scalar("Loss/train_epoch_label", float(losses[i]), step)
                    if cfg.tf_write_time:
                        writer.add_scalar("Time/epoch_label", elapsed, step)
                    if cfg.tf_write_psnr:
                        writer.add_scalar("PSNR/epoch", float(psnrs[i]), step)
                step = trainer.state.step
                if step % cfg.interval_print == 0:
                    if cfg.tf_print_psnr:
                        rec = fetch(lambda: np.asarray(trainer.decode(0)))
                        tgt = np.moveaxis(np.asarray(images[0]), 0, -1)
                        full_psnr = float(
                            psnr(
                                np.asarray(quantize_to_bit(rec, cfg.output_bits)),
                                np.asarray(quantize_to_bit(tgt, cfg.output_bits)),
                            )
                        )
                        writer.add_scalar("PSNR/mip0", full_psnr, step)
                        log(
                            f"Epoch [{step}/{cfg.num_epochs}], "
                            f"Loss: {float(losses[-1]):.4f} PSNR: {full_psnr:.4f}"
                        )
                    elif cfg.tf_print_log:
                        log(f"Epoch [{step}/{cfg.num_epochs}], Loss: {float(losses[-1]):.4f}")
                if step % cfg.interval_save_model == 0:
                    save_compressed(
                        out("artifacts", f"{cfg.save_name}_{step - 1}.npz"),
                        trainer.state.mlp, trainer.state.fp, cfg.fp_bits,
                        {"save_name": cfg.save_name, "epoch": step - 1},
                    )
                if step % cfg.interval_print == 0:
                    # resumable snapshot (params + opt state) each interval
                    trainer.save_checkpoint(ckpt_mgr.path_for(step))
                    ckpt_mgr.prune()
        for g in trainer.state.fp:
            log_safe_statistics(g, log)
        trainer.freeze_and_quantize()
        payload_bits = save_compressed(
            artifact, trainer.state.mlp, trainer.state.fp, cfg.fp_bits,
            {
                "save_name": cfg.save_name,
                "config": {
                    "image_size": cfg.image_size,
                    "image_size_w": cfg.image_size_w,
                    "pe_channels": cfg.pe_channels,
                    "tf_use_tri_pe": cfg.tf_use_tri_pe,
                    "tf_no_mip": cfg.tf_no_mip,
                    "compression_method": cfg.compression_method,
                    "image_dimension": cfg.image_dimension,
                },
            },
            mlp_store_bits=cfg.mlp_store_bits,
            entropy_coded=cfg.entropy_code_grids,
        )
    else:
        import dataclasses

        from nic.io.artifacts import compressed_num_bits

        mlp, fp, _ = load_compressed(artifact, trainer.dtype)
        trainer.state = dataclasses.replace(
            trainer.state, mlp=mlp, fp=fp, frozen=True
        )
        # payload from what the artifact actually stores (entropy-coded
        # blobs, fp16 MLP weights), not the upcast in-memory params
        payload_bits = compressed_num_bits(artifact)

    # per-mip decode + export + PSNR (image_compression.py:398-427, 482-489)
    reconstructed = []
    for mip in range(cfg.effective_max_mip_level + 1):
        with log.span("decode time"):
            rec = fetch(lambda m=mip: np.asarray(trainer.decode(m)))
        rec_codes = np.asarray(quantize_to_bit(rec, cfg.output_bits)).astype(np.uint8)
        reconstructed.append(rec_codes)
        if cfg.image_dimension == 2:
            assets.save_png(
                rec_codes,
                make_filename_by_seq(out("image", cfg.save_name), f"{cfg.save_name}_{mip}.png"),
            )
        orig = np.moveaxis(np.asarray(images[mip]), 0, -1).astype(np.float32) * 255.0
        if orig.shape != rec_codes.shape:
            # 3D methods 3/4 reuse the full-res volume at every mip
            # (image_compression.py:471-477); the mip-i decode samples the
            # volume at stride 2^i, so compare against the strided target.
            # (The reference would crash here — its per-mip PSNR :482-489
            # broadcasts mismatched shapes; latent defect, fixed by
            # construction.)
            f = orig.shape[0] // rec_codes.shape[0]
            orig = orig[tuple(slice(None, None, f) for _ in range(orig.ndim - 1))]
        p_ref = float(psnr(orig, rec_codes.astype(np.float32)))
        p_255 = float(psnr(orig, rec_codes.astype(np.float32), max_value=255.0))
        results["psnr"].append(p_ref)
        results["psnr_255"].append(p_255)
        log(f"psnr: {p_ref}")

    if cfg.compression_method == 2:
        movie = assets.unflatten_2d_to_3d(reconstructed[0], cfg.image_3d_size,
                                          cfg.image_3d_size)
        assets.write_timelaps(
            movie,
            make_filename_by_seq(out("image", cfg.save_name), f"{cfg.save_name}_0.avi"),
        )
    elif cfg.compression_method in (3, 4):
        assets.write_timelaps(
            reconstructed[0],
            make_filename_by_seq(out("image", cfg.save_name), f"{cfg.save_name}_0.avi"),
        )
        orig_vol = np.moveaxis(np.asarray(images[0]), 0, -1) * 255.0
        log(f"average psnr: {float(average_psnr(orig_vol, reconstructed[0].astype(np.float32)))}")
        if cfg.save_lut_csv:
            # 3D-LUT CSV export (sample22-2/3 lineage, utils.py:97-113 layout;
            # native writer when libnic_native.so is built)
            from nic.native import write_lut_csv

            for mip, rec in enumerate(reconstructed):
                write_lut_csv(
                    rec.astype(np.float32),
                    make_filename_by_seq(out("LUT", cfg.save_name),
                                         f"{cfg.save_name}_{mip}.csv"),
                )

    if cfg.tf_show_result and cfg.image_dimension == 2:
        # headless stand-in for the reference's matplotlib side-by-side
        # display (image_compression.py:494-510): write a comparison PNG
        orig_u8 = (np.moveaxis(np.asarray(images[0]), 0, -1) * 255).astype(np.uint8)
        side = np.concatenate([orig_u8, reconstructed[0]], axis=1)
        assets.save_png(
            side, make_filename_by_seq(out("image", cfg.save_name),
                                       f"{cfg.save_name}_compare.png")
        )

    num_pixels = np.asarray(images[0]).size // 3
    results["bpp"] = payload_bits / num_pixels
    log(f"bpp: {results['bpp']}")
    writer.close()
    log(datetime.datetime.now())
    return results


if __name__ == "__main__":
    run()
