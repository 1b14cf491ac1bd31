"""Decoder-only runtime: decode a compressed artifact without any training
state — the "ship it" loader (SURVEY.md §5 checkpoint row: one artifact
format, loader = decoder-only runtime).

Run:
  python -m nic.cli.decode runs/artifacts/name.npz --mip 0 --out out.png
  python -m nic.cli.decode art.npz --backend fast       # folded XLA
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def run(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("artifact")
    p.add_argument("--mip", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--backend", choices=["auto", "pallas", "fast", "xla"],
                   default="auto",
                   help="auto = the measured-fastest backend "
                        "(nic.kernels.decode.AUTO_BACKEND); pallas = the "
                        "fused Triton kernel; fast = folded XLA; xla = "
                        "unfused XLA")
    p.add_argument("--gelu", choices=["exact", "tanh"], default="exact",
                   help="pallas backend GELU: exact (erf) or the tanh "
                        "approximation")
    p.add_argument("--dtype", choices=["fp32", "bf16"], default="fp32",
                   help="pallas backend: fp32 (float32 planes, W2 in three "
                        "bfloat16 passes: float32-class) or bf16 "
                        "(bfloat16 W2 operands, float32 accumulation)")
    p.add_argument("--image_size", type=int, default=None,
                   help="override the stored image size")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the decode over this many local devices "
                        "(rows in 2D, frames in 3D — "
                        "nic.kernels.decode_sharded); 1 = single device")
    p.add_argument("--verify", action="store_true",
                   help="decode twice and require bit-identical results "
                        "(nic.obs.integrity.verified_result)")
    args = p.parse_args(argv)

    import jax

    from nic.grids.pyramid import pyramid_mip_levels
    from nic.io.artifacts import load_compressed

    mlp, fp, meta = load_compressed(args.artifact)
    cfg_meta = meta.get("config", {})
    image_size = args.image_size or cfg_meta.get("image_size")
    image_size_w = cfg_meta.get("image_size_w", 0)
    if image_size is None:
        # infer 2D size from the G0 grid: base = size-1, image = 4*base
        image_size = (fp[0].shape[1] - 1) * 4
    pe_channels = cfg_meta.get("pe_channels", 6)
    no_mip = cfg_meta.get("tf_no_mip", len(fp) == 2)
    base = fp[0].shape[1] - 1
    mip_to_level = pyramid_mip_levels(image_size, base, no_mip)
    ndim = fp[0].ndim - 1
    # decode-graph switches come from the SAME rule the trainer used
    # (method 4 → sparse G0 + sinusoidal PE; 3D method 3 → triangular),
    # not the raw TF_USE_TRI_PE flag — a method-3 3D artifact trained with
    # TF_USE_TRI_PE=False must still decode with triangular PE
    from nic.grids.sample import effective_pe_flags

    use_tri_pe, sparse_g0 = effective_pe_flags(
        cfg_meta.get("compression_method", 1 if ndim == 2 else 3),
        ndim, cfg_meta.get("tf_use_tri_pe", True),
    )

    mip = args.mip
    n = image_size // (2**mip)
    rect = ndim == 2 and bool(image_size_w) and image_size_w != image_size
    ns = (n, image_size_w // (2**mip)) if rect else (n,) * ndim

    from nic.kernels.decode import resolve_backend

    backend = resolve_backend(args.backend)
    if backend != "pallas" and (args.dtype, args.gelu) != ("fp32", "exact"):
        p.error(f"--dtype/--gelu apply to the pallas backend, not {backend}")
    kw = dict(backend=backend, image_size=image_size,
              mip_to_level=mip_to_level, pe_channels=pe_channels,
              use_tri_pe=use_tri_pe, ndim=ndim, sparse_g0=sparse_g0, n=ns,
              dtype=args.dtype, gelu=args.gelu)
    if args.devices > 1:
        from nic.kernels.decode_sharded import decode_sharded
        from nic.parallel.mesh import make_mesh

        mesh = make_mesh(args.devices, data_axis=args.devices)
        decode = jax.jit(
            lambda fp, mlp: decode_sharded(fp, mlp, mip, mesh, **kw))
    else:
        from nic.kernels.decode import decode as decode_one

        decode = jax.jit(lambda fp, mlp: decode_one(fp, mlp, mip, **kw))

    t0 = time.perf_counter()
    out = jax.block_until_ready(decode(fp, mlp))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(decode(fp, mlp))
    dt = time.perf_counter() - t0
    if args.verify:
        from nic.obs.integrity import verified_result

        out = verified_result(lambda: np.asarray(decode(fp, mlp)),
                              warn=print)
    rec = np.clip(np.asarray(out, np.float32), 0, 1)
    npix = rec.size // 3
    print(f"decoded {rec.shape} in {dt*1e3:.3f} ms "
          f"({npix/dt/1e9:.4f} GPix/s, backend={backend}, "
          f"dtype={args.dtype}, gelu={args.gelu}, "
          f"first call {compile_s:.2f} s, on {jax.devices()[0].platform})")
    if args.out:
        from nic.data.assets import save_png, write_timelaps

        u8 = (rec * 255 + 0.5).astype(np.uint8)
        if ndim == 2:
            save_png(u8, args.out)
        else:
            write_timelaps(u8, args.out)
        print(f"wrote {args.out}")
    return rec


if __name__ == "__main__":
    run(sys.argv[1:])
