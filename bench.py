"""Benchmark: NTC decode and training throughput on one GPU.

Times the two choices the program makes by measurement:

- decode: the fused Triton kernel (``nic.kernels.decode_triton``) against
  the folded XLA decode (``nic.grids.fastdecode.fast_decode``) at 512²,
  2048², the 512×768 Kodak geometry and the misty 64³ volume (methods 3
  and 4), flagship widths (C=12, PE 6, MLP 73→64→64→3), random weights
  from a seed. Each mode's worst u8 error against the float32 reference
  decode (the unfused ``decoder_input`` + ``apply_mlp`` graph at
  ``"highest"`` precision) is printed beside its rate.
- training: ``TRAIN_FORWARD=gather`` against ``folded`` at the flagship
  configuration (8 × 256² crops per step), steps/s.

Timing: host clock around ``block_until_ready``, compile and warm-up
excluded, median of ``--repeats`` runs. Every line is one JSON object that
names the platform, ``device_kind`` and device count. Without a GPU the
script exits non-zero.

Run: ``python bench.py [--only decode|train] [--repeats N] [--tune]``
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

CHANNELS, PE, HIDDEN = 12, 6, 64
DECODE_2D = ((512, 512), (2048, 2048), (512, 768))


def _device():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _emit(name: str, **fields) -> None:
    print(json.dumps({"name": name, **fields, "device": _device()}),
          flush=True)


def median_time(fn, *args, repeats: int = 10) -> float:
    """Median seconds of ``fn(*args)`` to ``block_until_ready`` (one
    warm-up call first, which also compiles)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def setup_decode(hw, ndim: int = 2, sparse_g0: bool = False, seed: int = 0):
    """Seeded flagship-width pyramid + MLP for one decode geometry."""
    import jax

    from nic.grids.pyramid import create_pyramid, pyramid_mip_levels
    from nic.models.mlp import init_mlp

    base = tuple(s // 4 for s in hw) if ndim == 2 else hw[0] // 4
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    fp, _ = create_pyramid(k1, base, CHANNELS, num_bits=8, ndim=ndim,
                           no_mip=True)
    m2l = pyramid_mip_levels(hw[0], min(hw) // 4, no_mip=True)
    corners = 4 if sparse_g0 else 2**ndim
    mlp = init_mlp(k2, CHANNELS * (corners + 1) + PE * ndim + 1, HIDDEN, 3)
    return fp, mlp, m2l


def decode_fns(hw, m2l, ndim: int = 2, sparse_g0: bool = False, **kernel):
    """jitted {name: fn(fp, mlp)} for the float32 reference (the unfused
    graph at "highest" precision), fast_decode and the kernel's modes at
    one geometry (nic.kernels.decode dispatch)."""
    import jax

    from nic.grids.fastdecode import fast_decode
    from nic.kernels.decode import decode
    from nic.kernels.decode_triton import decode_fused

    n = tuple(hw) if ndim == 2 else hw[0]
    kw = dict(image_size=hw[0], mip_to_level=m2l, pe_channels=PE,
              use_tri_pe=not sparse_g0, ndim=ndim, sparse_g0=sparse_g0, n=n)
    fns = {
        "reference": jax.jit(
            lambda fp, mlp: decode(fp, mlp, 0, backend="xla", **kw)),
        "fast_decode": jax.jit(
            lambda fp, mlp: decode(fp, mlp, 0, backend="fast", **kw)),
        "fast_decode_default_precision": jax.jit(
            lambda fp, mlp: fast_decode(fp, mlp, 0, **kw)),
    }
    for dtype in ("fp32", "bf16"):
        for gelu in ("exact", "tanh"):
            fns[f"kernel_{dtype}_{gelu}"] = jax.jit(
                lambda fp, mlp, dtype=dtype, gelu=gelu: decode_fused(
                    fp, mlp, 0, dtype=dtype, gelu=gelu, **kw, **kernel))
    return fns


def u8(x) -> np.ndarray:
    return np.clip(np.asarray(x, np.float32) * 255 + 0.5, 0, 255).astype(
        np.int32)


def u8_err(a, b) -> int:
    """Worst difference of two decodes in u8 output steps."""
    return int(np.abs(u8(a) - u8(b)).max())


def bench_decode(repeats: int) -> None:
    cases = [(hw, 2, False) for hw in DECODE_2D]
    cases += [((64, 64, 64), 3, False), ((64, 64, 64), 3, True)]
    for hw, ndim, sparse in cases:
        fp, mlp, m2l = setup_decode(hw, ndim, sparse)
        fns = decode_fns(hw, m2l, ndim, sparse)
        ref = np.asarray(fns["reference"](fp, mlp))
        npix = int(np.prod(ref.shape[:-1]))
        geom = "x".join(map(str, hw)) + (f"_m{4 if sparse else 3}"
                                         if ndim == 3 else "")
        for name, fn in fns.items():
            t = median_time(fn, fp, mlp, repeats=repeats)
            _emit(f"decode_{geom}_{name}", ms=t * 1e3,
                  gpix_s=npix / t / 1e9,
                  max_u8_err_vs_reference=u8_err(fn(fp, mlp), ref))


def bench_decode_tune(repeats: int) -> None:
    """Block size / warps sweep of the kernel at 512², 2048² and 64³."""
    for hw, ndim in (((2048, 2048), 2), ((512, 512), 2), ((64, 64, 64), 3)):
        fp, mlp, m2l = setup_decode(hw, ndim)
        for block, warps in ((32, 4), (64, 4), (64, 8), (128, 8), (128, 16),
                             (256, 16)):
            fns = decode_fns(hw, m2l, ndim, block=block, num_warps=warps)
            for name in ("kernel_fp32_exact", "kernel_bf16_exact"):
                t = median_time(fns[name], fp, mlp, repeats=repeats)
                _emit(f"tune_{'x'.join(map(str, hw))}_{name}", block=block,
                      num_warps=warps, ms=t * 1e3,
                      gpix_s=math.prod(hw) / t / 1e9)


def train_steps_s(num_steps: int, **overrides) -> tuple[float, float]:
    """(steps/s, compile-and-first-chunk seconds) of ``train_many`` at the
    flagship configuration with ``overrides``."""
    from nic.cli.image_compression import load_asset
    from nic.config import CompressionConfig
    from nic.train.ntc import NTCTrainer

    cfg = CompressionConfig(num_epochs=10**6, **overrides)
    trainer = NTCTrainer(cfg, load_asset(cfg))
    t0 = time.perf_counter()
    trainer.train_many(num_steps, chunk=num_steps)  # compiles
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.train_many(num_steps, chunk=num_steps)
    return num_steps / (time.perf_counter() - t0), first


def bench_train(repeats: int) -> None:
    for forward in ("gather", "folded"):
        for dtype in (16, 32):
            rates = []
            for _ in range(max(1, repeats // 5)):
                rate, first = train_steps_s(500, train_forward=forward,
                                            sdc_guard_train=False,
                                            mlp_num_dtype=dtype)
                rates.append(rate)
            _emit(f"train_flagship_{forward}_mlp{dtype}",
                  steps_s=float(np.median(rates)), runs=len(rates),
                  first_chunk_s=first)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", choices=["decode", "train"], default=None)
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--tune", action="store_true",
                   help="also sweep the kernel's block/warps/stages")
    args = p.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {jax.devices()[0].platform}",
              file=sys.stderr)
        return 1
    if args.only in (None, "decode"):
        bench_decode(args.repeats)
        if args.tune:
            bench_decode_tune(args.repeats)
    if args.only in (None, "train"):
        bench_train(args.repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
