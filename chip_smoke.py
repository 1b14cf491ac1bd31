"""Smoke test of the NTC train and decode path on one GPU.

Drives the flagship workload through its normal entry points at the
reference's full width (C=12 grid channels, MLP 73→64→64→3, PE 6,
8 × 256² crops per step, FP_BITS=8), in one process, phase by phase:

1. device: a GPU, its name and power limit;
2. 2D training, no mip (``nic.cli.image_compression.run``, sancho 512²);
3. 2D training in mip/LOD mode;
4. decode of the phase-2 artifact through ``nic.cli.decode.run``;
5. the decode kernel and ``fast_decode`` against the float32 reference
   at 2048² and 512×768, seeded weights;
6. one training step of the ``auto`` forward against ``gather``;
7. 3D: misty 64³, methods 3 and 4, trained and decoded through the CLIs.

Each phase prints one line; any failed check raises and the script exits
non-zero. The last line of a passing run is one JSON object naming the
device. ``--multi`` runs only the four-device path (data-parallel training
and the row-sharded decode, each against one device).

Run: ``python chip_smoke.py [--multi]``
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from bench import median_time, setup_decode, u8_err

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "runs", "chip_smoke")

# Decode tolerances against the float32 reference decode (decoder_input +
# apply_mlp at "highest" precision), in u8 steps of the output and, for
# the fp32 mode, as the largest absolute difference of the float output.
# fp32: the kernel's 3-pass bf16 W2 product and the folded sums differ
# from the reference only in float32 rounding, which can flip a value
# lying on a rounding boundary by one step.
FP32_MAX_LSB = 1
# The u8 bound alone is met by the bf16 mode too. The float bound sits
# between the fp32 mode's reading and the bf16 mode's (PERF.md), so a
# single-pass bf16 W2 product, or TF32 anywhere, fails it.
FP32_MAX_ABS = 4e-6
# bf16 dot operands (and the tanh GELU): 1 step measured on an H100 at
# these shapes with seeded flagship-width weights; 2 allows one more for
# other weights.
FAST_MAX_LSB = 2
# Training step: the auto forward (folded, bf16 dot operands by default)
# against gather in float32 at "highest" precision. bf16 operands keep 8
# mantissa bits, so gradients agree to ~1e-2 relative; the two float32
# forms compute the same sums in another order.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_RTOL = 5e-2
TRAIN_FP32_LOSS_RTOL = 1e-5
TRAIN_FP32_GRAD_RTOL = 1e-3


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def say(phase: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def train_cli(tag: str, args: list, size: dict) -> dict:
    """One ``nic.cli.image_compression`` run; checks the loss and returns
    its results plus the steady step rate."""
    from nic.cli.image_compression import run

    argv = args + [f"{k}={v}" for k, v in size.items()] + [
        f"OUTPUT_ROOT={OUT}", "TF_WRITE_TIME=False"]
    t0 = time.perf_counter()
    res = run(argv)
    wall = time.perf_counter() - t0
    chunks = res["train_chunks"]
    losses = [c[3] for c in chunks]  # mean loss per chunk
    check(all(np.isfinite(losses)), f"{tag}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall {losses}")
    # the first chunk compiles the unfrozen step, the one that crosses
    # the 95% boundary the frozen one: the fastest chunk is steady state
    rate = max(c[0] / c[1] for c in chunks[1:])
    first = chunks[0][1] - chunks[0][0] / rate
    say(tag, steps_s=f"{rate:.1f}", compile_s=f"{first:.1f}",
        mean_loss=" -> ".join(f"{x:.5f}" for x in losses),
        psnr=f"{res['psnr'][0]:.3f}", bpp=f"{res['bpp']:.4f}",
        wall_s=f"{wall:.1f}")
    return res


def artifact_path(args: list, size: dict) -> str:
    from nic.config import parse_overrides

    cfg = parse_overrides(args + [f"{k}={v}" for k, v in size.items()])
    return os.path.join(OUT, "artifacts", f"{cfg.save_name}.npz")


def phase_decode_cli(args: list, size: dict) -> None:
    from nic.cli.decode import run

    art = artifact_path(args, size)
    got = run([art, "--mip", "0"])
    ref = run([art, "--mip", "0", "--backend", "xla"])
    check(np.isfinite(got).all(), "decode CLI: non-finite output")
    err = u8_err(got, ref)
    check(err <= FP32_MAX_LSB, f"decode CLI: {err} u8 steps from xla")
    say("4 decode cli", shape=got.shape, max_u8_err_vs_xla=err)


def phase_decode_kernel(shapes) -> None:
    import jax

    from nic.kernels.decode import decode

    modes = (("pallas", "fp32", "exact", FP32_MAX_LSB, FP32_MAX_ABS),
             ("fast", "fp32", "exact", FP32_MAX_LSB, FP32_MAX_ABS),
             ("pallas", "bf16", "exact", FAST_MAX_LSB, None),
             ("pallas", "bf16", "tanh", FAST_MAX_LSB, None))
    for hw in shapes:
        fp, mlp, m2l = setup_decode(hw)
        kw = dict(image_size=hw[0], mip_to_level=m2l, pe_channels=6, n=hw)
        ref = np.asarray(jax.jit(
            lambda fp, mlp: decode(fp, mlp, 0, backend="xla", **kw))(fp, mlp))
        check(ref.shape == tuple(hw) + (3,), f"reference shape {ref.shape}")
        for backend, dtype, gelu, tol, abs_tol in modes:
            fn = jax.jit(lambda fp, mlp, b=backend, d=dtype, g=gelu: decode(
                fp, mlp, 0, backend=b, dtype=d, gelu=g, **kw))
            t0 = time.perf_counter()
            out = np.asarray(fn(fp, mlp))
            compile_s = time.perf_counter() - t0
            t = median_time(fn, fp, mlp)
            err = u8_err(out, ref)
            diff = float(np.abs(out - ref).max())
            check(np.isfinite(out).all(), f"{backend} {dtype}: non-finite")
            check(err <= tol, f"{backend} {dtype} {gelu} at {hw}: {err} u8 "
                  f"steps from the reference (bound {tol})")
            check(abs_tol is None or diff <= abs_tol,
                  f"{backend} {dtype} {gelu} at {hw}: max |diff| {diff:.3e} "
                  f"from the reference (bound {abs_tol})")
            say("5 decode vs reference", hw="x".join(map(str, hw)),
                backend=backend, dtype=dtype, gelu=gelu, ms=f"{t * 1e3:.3f}",
                gpix_s=f"{hw[0] * hw[1] / t / 1e9:.4f}",
                max_u8_err=f"{err}/{tol}",
                max_abs_diff=f"{diff:.3e}/{abs_tol}",
                first_call_s=f"{compile_s:.2f}")


def count_compiles() -> list:
    """A one-element list that counts XLA backend compilations from now."""
    import jax

    count = [0]

    def listen(event, secs, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            count[0] += 1

    jax.monitoring.register_event_duration_secs_listener(listen)
    return count


def rel_err(a, b) -> float:
    import jax

    worst = 0.0
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        worst = max(worst, float(np.abs(x - y).max()
                                 / (np.abs(y).max() + 1e-30)))
    return worst


def phase_train_step(size: dict) -> None:
    import jax

    from nic.cli.image_compression import load_asset
    from nic.config import parse_overrides
    from nic.train.ntc import NTCTrainer

    key = jax.random.key(123, impl="rbg")
    args = [f"{k}={v}" for k, v in size.items()]

    def grads(*extra):
        cfg = parse_overrides(args + list(extra))
        tr = NTCTrainer(cfg, load_asset(cfg))
        return tr.loss_and_grads(key), cfg.resolved_train_forward

    with jax.default_matmul_precision("highest"):
        (l_ref, g_ref), _ = grads("TRAIN_FORWARD=gather", "MLP_NUM_DTYPE=32")
        (l_f32, g_f32), _ = grads("TRAIN_FORWARD=auto", "MLP_NUM_DTYPE=32")
    (l_auto, g_auto), fwd = grads()
    l_ref, l_f32, l_auto = float(l_ref), float(l_f32), float(l_auto)
    e_f32 = (abs(l_f32 - l_ref) / l_ref, rel_err(g_f32, g_ref))
    e_auto = (abs(l_auto - l_ref) / l_ref, rel_err(g_auto, g_ref))
    check(e_f32[0] <= TRAIN_FP32_LOSS_RTOL and e_f32[1] <= TRAIN_FP32_GRAD_RTOL,
          f"auto fp32 vs gather: loss/grad rel err {e_f32}")
    check(e_auto[0] <= TRAIN_LOSS_RTOL and e_auto[1] <= TRAIN_GRAD_RTOL,
          f"auto default vs gather fp32: loss/grad rel err {e_auto}")
    say("6 train step vs reference", auto=fwd, loss_ref=f"{l_ref:.6f}",
        loss_auto=f"{l_auto:.6f}",
        fp32_loss_rel=f"{e_f32[0]:.2e}/{TRAIN_FP32_LOSS_RTOL}",
        fp32_grad_rel=f"{e_f32[1]:.2e}/{TRAIN_FP32_GRAD_RTOL}",
        default_loss_rel=f"{e_auto[0]:.2e}/{TRAIN_LOSS_RTOL}",
        default_grad_rel=f"{e_auto[1]:.2e}/{TRAIN_GRAD_RTOL}")


def run_single(sizes: dict) -> None:
    img2d = ["IMAGE_PATH=data/sancho_512.png"]
    train_cli("2 train 2d no-mip", img2d, sizes["2d"])
    train_cli("3 train 2d mip", img2d + ["TF_NO_MIP=False"], sizes["2d"])
    phase_decode_cli(img2d, sizes["2d"])
    phase_decode_kernel(sizes["decode"])
    phase_train_step(sizes["step"])
    for method in (3, 4):
        args = ["IMAGE_PATH=data/misty_64_64.avi", "IMAGE_DIMENSION=3",
                f"COMPRESSION_METHOD={method}"]
        train_cli(f"7 train 3d m{method}", args, sizes["3d"])
        from nic.cli.decode import run

        rec = run([artifact_path(args, sizes["3d"]), "--mip", "0"])
        check(np.isfinite(rec).all() and rec.shape == (64, 64, 64, 3),
              f"3D decode: shape {rec.shape}")
        say(f"7 decode 3d m{method}", shape=rec.shape)


def run_multi(sizes: dict, n: int) -> None:
    """K flagship train steps on an n-device data mesh against one device,
    and a row-sharded decode against one device."""
    import jax

    from nic.cli.image_compression import load_asset
    from nic.config import parse_overrides
    from nic.kernels.decode import decode
    from nic.kernels.decode_sharded import decode_sharded
    from nic.parallel.mesh import make_mesh
    from nic.train.ntc import NTCTrainer

    check(len(jax.devices()) >= n, f"--multi needs {n} devices")
    mesh = make_mesh(n)
    steps, chunk = sizes["multi_steps"], sizes["multi_chunk"]
    # every step below stays before the 95% freeze: one phase, one program
    cfg = parse_overrides(["IMAGE_PATH=data/sancho_512.png"]
                          + [f"{k}={v}" for k, v in sizes["2d"].items()]
                          + [f"NUM_EPOCHS={2 * (steps + 2 * chunk)}"])
    images = load_asset(cfg)
    compiles = count_compiles()
    hist = {}
    for name, m in (("one", None), ("mesh", mesh)):
        tr = NTCTrainer(cfg, images, mesh=m)
        # both start from the same seeded state; every call below runs the
        # one program of this phase and chunk size (the step count is
        # traced). The first call compiles it, the second may compile again
        # for the state's new sharding, the timed third must not.
        hist[name] = np.asarray(tr.train_many(steps, chunk=chunk)[0])
        tr.train_many(chunk, chunk=chunk)
        before = compiles[0]
        t0 = time.perf_counter()
        tr.train_many(chunk, chunk=chunk)
        hist[name + "_s"] = time.perf_counter() - t0
        hist[name + "_compiles"] = compiles[0] - before
    rel = float(np.max(np.abs(hist["mesh"] - hist["one"])
                       / np.abs(hist["one"])))
    check(np.isfinite(hist["mesh"]).all(), "mesh training: non-finite loss")
    check(rel <= 1e-3, f"mesh vs one-device losses: rel err {rel}")
    say("multi train", devices=n, steps=steps, max_loss_rel_err=f"{rel:.2e}",
        timed_steps=chunk, one_steps_s=f"{chunk / hist['one_s']:.1f}",
        mesh_steps_s=f"{chunk / hist['mesh_s']:.1f}",
        timed_compiles=f"{hist['one_compiles']}/{hist['mesh_compiles']}")

    hw = sizes["multi_decode"]
    fp, mlp, m2l = setup_decode(hw)
    kw = dict(backend="pallas", image_size=hw[0], mip_to_level=m2l,
              pe_channels=6, n=hw)
    one = jax.jit(lambda fp, mlp: decode(fp, mlp, 0, **kw))
    shard = jax.jit(lambda fp, mlp: decode_sharded(fp, mlp, 0, mesh, **kw))
    a, b = np.asarray(one(fp, mlp)), np.asarray(shard(fp, mlp))
    diff = float(np.abs(a - b).max())
    check(a.shape == b.shape and diff <= 1e-6,
          f"sharded decode differs from one device by {diff}")
    say("multi decode", hw="x".join(map(str, hw)), devices=n,
        max_abs_diff=diff, one_ms=f"{median_time(one, fp, mlp) * 1e3:.3f}",
        sharded_ms=f"{median_time(shard, fp, mlp) * 1e3:.3f}")


FULL = {
    "2d": {"NUM_EPOCHS": 300, "INTERVAL_PRINT": 100},
    "step": {"IMAGE_PATH": "data/sancho_512.png"},
    "decode": ((2048, 2048), (512, 768)),
    "3d": {"IMAGE_SIZE": 64, "MAX_MIP_LEVEL": 6, "CROP_MIP_LEVEL": 5,
           "FP_BITS": 4, "NUM_EPOCHS": 300, "INTERVAL_PRINT": 100},
    "multi_steps": 20,
    "multi_chunk": 500,
    "multi_decode": (2048, 2048),
}

# CPU rehearsal: the same phases at toy sizes, the kernel interpreted
TINY = {
    "2d": {"NUM_EPOCHS": 40, "INTERVAL_PRINT": 20, "IMAGE_SIZE": 64,
           "MAX_MIP_LEVEL": 6, "CROP_MIP_LEVEL": 4},
    "step": {"IMAGE_PATH": "data/sancho_512.png", "IMAGE_SIZE": 64,
             "MAX_MIP_LEVEL": 6, "CROP_MIP_LEVEL": 4},
    "decode": ((64, 64), (32, 48)),
    "3d": {"IMAGE_SIZE": 64, "MAX_MIP_LEVEL": 6, "CROP_MIP_LEVEL": 3,
           "FP_BITS": 4, "NUM_EPOCHS": 40, "INTERVAL_PRINT": 20},
    "multi_steps": 4,
    "multi_chunk": 8,
    "multi_decode": (64, 64),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the 4-device path and its comparison")
    p.add_argument("--rehearse-on-cpu", action="store_true",
                   help="run every phase at toy sizes on the CPU with the "
                        "kernel interpreted; prints no result")
    args = p.parse_args(argv)

    os.chdir(HERE)
    sys.path.insert(0, HERE)
    import jax

    import nic.kernels.decode_triton as decode_triton

    dev = jax.devices()[0]
    sizes = FULL
    if args.rehearse_on_cpu:
        decode_triton.INTERPRET = True
        sizes = TINY
    elif dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    card = "cpu rehearsal" if args.rehearse_on_cpu else smi()
    mods = {}
    for name in ("flax", "PIL", "cv2"):
        try:
            __import__(name)
            mods[name] = "yes"
        except ImportError:
            mods[name] = "no"
    say("1 device", platform=dev.platform, kind=repr(dev.device_kind),
        count=len(jax.devices()), card=repr(card),
        **{f"imports_{k}": v for k, v in mods.items()})
    t0 = time.perf_counter()
    if args.multi:
        run_multi(sizes, 4)
    else:
        run_single(sizes)
    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    if args.rehearse_on_cpu:
        print("rehearsal passed", flush=True)
        return 0
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
