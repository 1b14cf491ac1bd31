"""Sweep driver: grid runs of the flagship workload.

Replaces the reference's Windows ``仮想環境起動 python実行 改.bat`` launcher
(21K1113/Neural_Image_Compression_V2 repo root), which swept
FP_BITS ∈ {2,4,8} × COMPRESSION_METHOD ∈ {3,4} over its LUT datasets at
NUM_EPOCHS=320000, CROP_MIP_LEVEL=5. Runs sequentially in one process (one
JAX process per GPU) and records each run's PSNR/bpp to a JSON summary.

Usage:
  python scripts/sweep.py --image_path data/misty_64_64.avi \
      --bits 2 4 8 --methods 3 4 --num_epochs 320000 --crop_mip_level 5
  python scripts/sweep.py --image_path data/sancho_512.png --bits 2 4 8 \
      --methods 1 --dimension 2 --num_epochs 320000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--image_path", default="data/misty_64_64.avi")
    p.add_argument("--bits", type=int, nargs="+", default=[2, 4, 8])
    p.add_argument("--methods", type=int, nargs="+", default=[3, 4])
    p.add_argument("--dimension", type=int, default=3)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--max_mip_level", type=int, default=6)
    p.add_argument("--num_epochs", type=int, default=320000)
    p.add_argument("--crop_mip_level", type=int, default=5)
    p.add_argument("--output_root", default="runs/sweep")
    p.add_argument("--summary", default="runs/sweep/summary.json")
    args = p.parse_args()

    from nic.cli.image_compression import run

    rows = []
    for method in args.methods:
        for bits in args.bits:
            overrides = [
                f"IMAGE_PATH={args.image_path}",
                f"IMAGE_DIMENSION={args.dimension}",
                f"COMPRESSION_METHOD={method}",
                f"IMAGE_SIZE={args.image_size}",
                f"MAX_MIP_LEVEL={args.max_mip_level}",
                f"FP_BITS={bits}",
                f"NUM_EPOCHS={args.num_epochs}",
                f"CROP_MIP_LEVEL={args.crop_mip_level}",
                f"OUTPUT_ROOT={args.output_root}",
                "INTERVAL_PRINT=10000",
            ]
            print(f"=== sweep method={method} bits={bits} ===", flush=True)
            t0 = time.time()
            res = run(overrides)
            rows.append({
                "method": method, "fp_bits": bits,
                "psnr": res["psnr"][0], "psnr_255": res["psnr_255"][0],
                "bpp": res["bpp"], "wall_s": round(time.time() - t0, 1),
            })
            os.makedirs(os.path.dirname(args.summary), exist_ok=True)
            json.dump(rows, open(args.summary, "w"), indent=1)
    print(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
