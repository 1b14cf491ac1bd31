"""NTC feature-pyramid trainer — the flagship ``image_compression`` loop.

Re-architects the reference's per-epoch loop
(``Projects/image_compression.py:215-303`` of
21K1113/Neural_Image_Compression_V2) for JAX/XLA:

- the whole step (crop sampling → grid sampling → MLP fwd/bwd → Adam →
  clamp) is ONE jitted function; shapes are static per (lod, phase), so
  the step is compiled once per LOD bucket (≤ max_mip_level+1 buckets,
  exactly the shape family the reference produces host-side);
- crop origins are drawn on-device from a threaded PRNG key; the LOD
  bucket itself is drawn host-side (it picks the compiled step), with the
  reference's schedule: an accumulator fires a uniform draw every
  1/UNIFORM_DISTRIBUTION_RATE steps, otherwise ``floor(-log2(U)/2)``
  clamped to max mip (image_compression.py:26-50, sample19 lineage);
- QAT phases: first 95% adds uniform noise and trains grids + MLP with
  per-step clamp (fp lr 0.01 / mlp lr 0.005, cosine-annealed —
  image_compression.py:361-365); the final 5% hard-quantizes and freezes
  the grids and fine-tunes the MLP only (two separate optax chains — the
  exact analogue of the reference's param groups + requires_grad freeze,
  :227-231);
- full-image decode is tiled (div_size semantics of
  image_compression.py:307-346) and vmapped over tiles;
- data parallelism: crops shard over a ``('data',)`` mesh axis, grids and
  MLP replicated — jit + sharding annotations insert the gradient psum
  (no reference counterpart; SURVEY.md §5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


import jax
import jax.numpy as jnp
import numpy as np
import optax

from nic.config import CompressionConfig
from nic.core.metrics import psnr
from nic.core.quant import qat_noise, quantize_to_bit
from nic.grids import pyramid as fp_lib
from nic.grids.fastdecode import first_layer_acc, precompute_first_layer
from nic.grids.sample import decoder_input
from nic.models.mlp import apply_mlp, apply_mlp_tail, init_mlp
from nic.parallel.mesh import data_pixel_spec, replicate, shard_batch

__all__ = ["NTCState", "NTCTrainer", "sample_lod", "UniformLodSchedule"]


class UniformLodSchedule:
    """Accumulator gate: fires True every 1/rate steps
    (image_compression.py:221-226)."""

    def __init__(self, rate: float):
        self.rate = rate
        self.acc = 0.0

    def __call__(self) -> bool:
        self.acc += self.rate
        if self.acc >= 1.0:
            self.acc -= 1.0
            return True
        return False


def sample_lod(rng: np.random.Generator, uniform: bool, max_mip: int) -> int:
    """LOD draw (image_compression.py:29-34): uniform over [0, max_mip] or
    exponential floor(-log2(U)/2) clamped."""
    if uniform:
        return int(rng.integers(0, max_mip + 1))
    lod = int(math.floor(-math.log2(rng.random()) / 2))
    return min(lod, max_mip)


@dataclass
class NTCState:
    fp: tuple
    mlp: dict
    opt_fp: object
    opt_mlp: object
    step: int = 0
    frozen: bool = False


class NTCTrainer:
    def __init__(self, cfg: CompressionConfig, images, *, mesh=None,
                 log=None):
        """images: list indexed by mip level of [3, s, s] (2D) or
        [3, s, s, s] (3D) float arrays in [0, 1].

        ``log``: optional ``RunLog``-style callable; when set, the
        trainer emits one line per (lod, frozen) train-step build and per
        mip decode build saying which forward/backend ``auto`` resolved
        to."""
        self.cfg = cfg
        self.log = log if log is not None else (lambda *_a, **_k: None)
        self._gate_logged: set = set()
        # true mixed precision (unlike the reference's broken all-fp16 path,
        # readme.md:9): params/optimizer state stay fp32 masters; the
        # forward/backward compute in bf16 when MLP_NUM_DTYPE=16
        self.compute_dtype = cfg.compute_dtype()
        self.dtype = jnp.float32 if self.compute_dtype == jnp.bfloat16 else self.compute_dtype
        self.ndim = cfg.fp_dimension
        self.max_mip = cfg.effective_max_mip_level
        self.mesh = mesh
        self.images = [jnp.asarray(im, self.dtype) for im in images]

        # rbg keys are the cheaper generator for the QAT noise ([pixels,
        # 73] uniforms per step); statistical parity only (the reference
        # used torch RNG)
        key = jax.random.key(cfg.seed, impl=cfg.rng_impl)
        k_fp, k_mlp, self._key = jax.random.split(key, 3)
        if cfg.is_rectangular and self.ndim != 2:
            raise ValueError(
                "rectangular geometry (IMAGE_SIZE_W) is 2D-only")
        fp, self.levels = fp_lib.create_pyramid(
            k_fp,
            cfg.feature_pyramid_hw if self.ndim == 2
            else cfg.feature_pyramid_size,
            cfg.feature_pyramid_channels,
            cfg.fp_bits,
            ndim=self.ndim,
            dtype=self.dtype,
            no_mip=cfg.tf_no_mip,
        )
        mlp = init_mlp(
            k_mlp, cfg.decoder_input_channels, cfg.hidden_layer_channels, 3, self.dtype
        )
        # the mip→level map's level count must match create_pyramid's,
        # which uses the SMALLEST axis for rectangular grids
        base_for_levels = (min(cfg.feature_pyramid_hw) if self.ndim == 2
                           else cfg.feature_pyramid_size)
        self.mip_to_level = fp_lib.pyramid_mip_levels(
            cfg.image_size, base_for_levels, cfg.tf_no_mip
        )

        # two optax chains = the reference's two param groups
        # (image_compression.py:361-365) + CosineAnnealingLR(T_max=epochs)
        self._tx_fp = optax.adam(
            optax.cosine_decay_schedule(0.01, cfg.num_epochs, alpha=0.0)
        )
        self._tx_mlp = optax.adam(
            optax.cosine_decay_schedule(0.005, cfg.num_epochs, alpha=0.0)
        )
        if mesh is not None:
            fp = replicate(fp, mesh)
            mlp = replicate(mlp, mesh)
            self.images = [replicate(im, mesh) for im in self.images]
        self.state = NTCState(
            fp=fp,
            mlp=mlp,
            opt_fp=self._tx_fp.init(fp),
            opt_mlp=self._tx_mlp.init(mlp),
        )
        self._step_fns: dict = {}
        self._decode_fns: dict = {}
        self._lod_rng = np.random.default_rng(cfg.seed + 1)
        self._uniform_gate = UniformLodSchedule(cfg.uniform_distribution_rate)
        self._probe_key = jax.random.key(cfg.seed + 7, impl=cfg.rng_impl)
        self._tree_eq = None

    # ------------------------------------------------------------------
    # sampling geometry (static per lod)
    # ------------------------------------------------------------------

    def _geometry(self, lod: int):
        fl = self.mip_to_level[lod]
        n = max(1, self.cfg.crop_size // (2**lod))
        step = 2.0 ** (lod - (fl + 1) * 2)
        return fl, n, step

    def _sparse_g0(self) -> bool:
        from nic.grids.sample import effective_pe_flags

        return effective_pe_flags(
            self.cfg.compression_method, self.ndim, self.cfg.tf_use_tri_pe
        )[1]

    def _use_tri_pe(self) -> bool:
        from nic.grids.sample import effective_pe_flags

        return effective_pe_flags(
            self.cfg.compression_method, self.ndim, self.cfg.tf_use_tri_pe
        )[0]

    # ------------------------------------------------------------------
    # jitted train step, specialized per (lod, frozen-phase)
    # ------------------------------------------------------------------

    def _build_step(self, lod: int, frozen: bool, jit: bool = True,
                    grads_only: bool = False):
        cfg = self.cfg
        fl, n, step = self._geometry(lod)
        ndim = self.ndim
        dataset = self.images[lod if lod < len(self.images) else -1]
        data_hw = tuple(dataset.shape[1:1 + ndim])
        num_crops = cfg.num_crops
        sparse_g0 = self._sparse_g0()
        use_tri_pe = self._use_tri_pe()
        # Surgical mixed precision (MLP_NUM_DTYPE=16): grid gather/interp,
        # QAT noise, grid gradients, and grid updates all stay fp32 — the
        # grid-parameter gradients do not survive bf16 sampling (an early
        # A/B: 30.01 vs 38.97 dB at 20k steps). Only the MLP dot
        # products run with bf16 inputs (fp32 accumulation).
        mixed = self.compute_dtype == jnp.bfloat16
        dtype = jnp.float32 if mixed else self.compute_dtype
        matmul_dtype = jnp.bfloat16 if mixed else None

        mesh = self.mesh
        forward = cfg.resolved_train_forward
        use_folded = forward == "folded"
        self._forward_mode = forward
        gate_key = ("step", lod, frozen)
        if gate_key not in self._gate_logged:
            self._gate_logged.add(gate_key)
            self.log(f"train forward (lod={lod}, frozen={frozen}): {forward}"
                     f" [TRAIN_FORWARD={cfg.train_forward}]")
        noise_node = cfg.qat_noise_where == "node"
        mip_to_level = self.mip_to_level

        def noised_grids(fp, noise_key):
            # node-resolution QAT noise: perturb the two ACTIVE grids'
            # nodes instead of every per-pixel decoder-input channel. This
            # models what hard quantization actually does at eval (node
            # errors, bilinearly interpolated and correlated across pixels
            # sharing corners) and draws ~100× fewer uniforms per step than
            # the reference's [N, F] feature noise. PE/lod channels carry
            # no noise in this mode — they are never quantized.
            k0, k1 = jax.random.split(noise_key)
            fp = list(fp)
            fp[fl * 2] = fp[fl * 2] + qat_noise(
                k0, fp[fl * 2].shape, cfg.fp_bits, jnp.float32
            )
            fp[fl * 2 + 1] = fp[fl * 2 + 1] + qat_noise(
                k1, fp[fl * 2 + 1].shape, cfg.fp_bits, jnp.float32
            )
            return tuple(fp)

        def gather_features(fp, origins, noise_key):
            """The reference-shaped [N, F] decoder-input build (grid
            gather/interp + PE + QAT noise) of the gather forward."""
            fp = tuple(g.astype(dtype) for g in fp)
            if not frozen and noise_node:
                fp = noised_grids(fp, noise_key)

            def one(origin):
                return decoder_input(
                    fp, fl, origin, step, n,
                    pe_channels=cfg.pe_channels, mip_level=lod, ndim=ndim,
                    use_tri_pe=use_tri_pe, sparse_g0=sparse_g0, dtype=dtype,
                    g1_quirk=cfg.tf_g1_quirk, grid_vjp=cfg.grid_vjp,
                )

            x = jax.vmap(one)(origins)  # [crops, n^ndim, F]
            # data parallel over crops + pixel ("sequence") parallel inside
            # a crop; the partitioner psums grid/MLP grads over the mesh
            x = shard_batch(x, mesh, data_pixel_spec(1))
            x = x.reshape(num_crops * n**ndim, -1)
            if not frozen and not noise_node:
                # QAT noise must be added in fp32: at FP_BITS=8 its amplitude
                # (2^-9) is below bf16 resolution near 0.5 (ε≈2^-8), so a
                # bf16 activation silently drops it and QAT degenerates.
                x = x.astype(jnp.float32) + qat_noise(
                    noise_key, x.shape, cfg.fp_bits, jnp.float32
                )
            return x

        def batch_forward(fp, mlp, origins, noise_key):
            if use_folded:
                fpc = tuple(g.astype(dtype) for g in fp)
                if not frozen and noise_node:
                    fpc = noised_grids(fpc, noise_key)
                return folded_forward(fpc, mlp, origins, noise_key)
            x = gather_features(fp, origins, noise_key)
            return apply_mlp(mlp, x, matmul_dtype=matmul_dtype)

        def folded_forward(fp, mlp, origins, noise_key):
            # Folded-first-layer training forward (TRAIN_FORWARD=folded):
            # the decode-side fastdecode algebra, differentiated through.
            # W1 is folded into the grids ONCE per step at node resolution,
            # so the [N, F] feature matrix is never built and the first
            # layer's pixel-resolution matmul disappears; the backward pass
            # scatter-adds into the H-lane planes and reaches G0/G1 through
            # the tiny node-resolution fold matmuls.
            planes = precompute_first_layer(
                fp, fl, mlp, ndim=ndim,
                channels=cfg.feature_pyramid_channels,
                pe_channels=cfg.pe_channels, sparse_g0=sparse_g0,
            )

            def one(origin):
                return first_layer_acc(
                    fp, mlp, lod, image_size=cfg.image_size,
                    mip_to_level=mip_to_level, pe_channels=cfg.pe_channels,
                    use_tri_pe=use_tri_pe, ndim=ndim, sparse_g0=sparse_g0,
                    origin=tuple(origin[d] for d in range(ndim)), n=n,
                    g1_quirk=cfg.tf_g1_quirk, planes=planes,
                )

            acc = jax.vmap(one)(origins)  # [crops, n.., H]
            acc = shard_batch(acc, mesh, data_pixel_spec(1))
            acc = acc.reshape(num_crops * n**ndim, -1)
            if not frozen and not noise_node:
                # feature noise in the folded basis: (x+ε)·W1 = x·W1 + ε·W1
                # (same ε draw as the gather path — equal key and shape)
                eps = qat_noise(
                    noise_key, (num_crops * n**ndim, mlp["w1"].shape[0]),
                    cfg.fp_bits, jnp.float32,
                )
                if matmul_dtype is None:
                    acc = acc + eps @ mlp["w1"]
                else:
                    acc = acc + jnp.dot(
                        eps.astype(matmul_dtype),
                        mlp["w1"].astype(matmul_dtype),
                        preferred_element_type=jnp.float32,
                    )
            return apply_mlp_tail(mlp, acc, matmul_dtype=matmul_dtype)

        def targets_of(origins):
            def one(origin):
                sizes = (3,) + (n,) * ndim
                start = (jnp.zeros((), jnp.int32),) + tuple(origin)
                return jax.lax.dynamic_slice(dataset, start, sizes)

            t = jax.vmap(one)(origins)  # [B, 3, n, ...]
            t = jnp.moveaxis(t, 1, -1).reshape(num_crops, n**ndim, 3)
            t = shard_batch(t, mesh, data_pixel_spec(1))
            return t.reshape(-1, 3)

        def loss_fn(fp, mlp, origins, noise_key):
            out = batch_forward(fp, mlp, origins, noise_key)
            tgt = targets_of(origins)
            return jnp.mean((out - tgt) ** 2), (out, tgt)

        if grads_only:
            def value_and_grads(fp, mlp, key):
                # the train step's loss and raw gradients, before Adam
                k_crop, k_noise = jax.random.split(key)
                origins = jax.random.randint(
                    k_crop, (num_crops, ndim), 0,
                    jnp.asarray([d - n + 1 for d in data_hw], jnp.int32),
                )
                (loss, _), grads = jax.value_and_grad(
                    loss_fn, argnums=(0, 1), has_aux=True
                )(fp, mlp, origins, k_noise)
                return loss, grads

            return jax.jit(value_and_grads)

        tx_fp, tx_mlp = self._tx_fp, self._tx_mlp

        def train_step(fp, mlp, opt_fp, opt_mlp, key):
            k_crop, k_noise = jax.random.split(key)
            origins = jax.random.randint(
                k_crop, (num_crops, ndim), 0,
                jnp.asarray([d - n + 1 for d in data_hw], jnp.int32),
            )
            if frozen:
                (loss, (out, tgt)), g_mlp = jax.value_and_grad(
                    lambda m: loss_fn(fp, m, origins, k_noise), has_aux=True
                )(mlp)
                upd, opt_mlp = tx_mlp.update(g_mlp, opt_mlp, mlp)
                mlp = optax.apply_updates(mlp, upd)
            else:
                (loss, (out, tgt)), (g_fp, g_mlp) = jax.value_and_grad(
                    loss_fn, argnums=(0, 1), has_aux=True
                )(fp, mlp, origins, k_noise)
                upd_fp, opt_fp = tx_fp.update(g_fp, opt_fp, fp)
                fp = optax.apply_updates(fp, upd_fp)
                upd_mlp, opt_mlp = tx_mlp.update(g_mlp, opt_mlp, mlp)
                mlp = optax.apply_updates(mlp, upd_mlp)
                fp = fp_lib.pyramid_clamp(fp, fl, cfg.fp_bits)
            if cfg.tf_write_psnr:
                # per-step PSNR of the quantized crop batch — the reference
                # computes this only under TF_WRITE_PSNR
                # (image_compression.py:259-261); skipping it saves a full
                # quantize+reduce over every trained pixel each step
                step_psnr = psnr(
                    quantize_to_bit(out, cfg.output_bits),
                    quantize_to_bit(tgt, cfg.output_bits),
                )
            else:
                step_psnr = jnp.float32(jnp.nan)
            return fp, mlp, opt_fp, opt_mlp, loss, step_psnr

        return jax.jit(train_step, donate_argnums=(0, 1, 2, 3)) if jit else train_step

    def loss_and_grads(self, key, lod: int = 0):
        """(loss, (grid grads, MLP grads)) of one unfrozen train step at
        ``lod`` from the current state, with the step's own crop and noise
        draws from ``key`` — what the optimizer would be fed."""
        fn = self._build_step(lod, False, grads_only=True)
        return fn(self.state.fp, self.state.mlp, key)

    def _step_fn(self, lod: int, frozen: bool):
        key = (lod, frozen)
        if key not in self._step_fns:
            self._step_fns[key] = self._build_step(lod, frozen)
        return self._step_fns[key]

    def _loop_fn(self, frozen: bool, chunk: int):
        """Compiled multi-step loop: up to ``chunk`` train steps per host
        dispatch (the reference's Python epoch loop,
        image_compression.py:220, re-done the XLA way). The step count
        ``n`` is a traced argument of a ``fori_loop``, so one program per
        (phase, chunk) serves every chunk length, boundary chunks included,
        and runs exactly ``n`` steps. Step ``i`` takes the key
        ``fold_in(key, i)``; losses land in a ``chunk``-sized buffer.

        LOD/mip training feeds the host-drawn per-step LOD sequence (same
        accumulator gate + RNG stream as ``train_step``) to a
        ``lax.switch`` over per-LOD branches, each traced once with its
        own static crop geometry (image_compression.py:221-245,
        sample18–21); XLA's conditional runs only the selected branch."""
        key = ("loop", frozen, chunk)
        if key not in self._step_fns:
            branches = [
                self._build_step(lod, frozen, jit=False)
                for lod in range(self.max_mip + 1)
            ]

            def run(fp, mlp, opt_fp, opt_mlp, key, lods, n):
                def body(i, val):
                    carry, lh, ph = val
                    *carry, loss, p = jax.lax.switch(
                        lods[i], branches, *carry, jax.random.fold_in(key, i))
                    return (tuple(carry),
                            lh.at[i].set(loss.astype(jnp.float32)),
                            ph.at[i].set(p.astype(jnp.float32)))

                nan = jnp.full((chunk,), jnp.nan, jnp.float32)
                carry, lh, ph = jax.lax.fori_loop(
                    0, n, body, ((fp, mlp, opt_fp, opt_mlp), nan, nan))
                return carry, (lh, ph)

            self._step_fns[key] = jax.jit(run, donate_argnums=(0, 1, 2, 3))
        return self._step_fns[key]

    # ------------------------------------------------------------------
    # opt-in in-train SDC guard (SDC_GUARD_TRAIN=True, nic.obs.integrity).
    # After each compiled chunk, one train step is executed TWICE from the
    # identical carry and key through a NON-donating compile, and every
    # output (params, optimizer state, loss) is compared bit-for-bit on
    # device. XLA executions are deterministic, so any disagreement is
    # hardware corruption. The probe results are DISCARDED (training is
    # bit-identical with the guard on or off). Persistent mismatch raises
    # SDCError; resume from the last interval checkpoint (TF_RESUME) is
    # the recovery.
    # ------------------------------------------------------------------

    def _probe_fn(self, lod: int, frozen: bool):
        key = ("probe", lod, frozen)
        if key not in self._step_fns:
            self._step_fns[key] = jax.jit(
                self._build_step(lod, frozen, jit=False))
        return self._step_fns[key]

    def _sdc_probe(self, lod: int) -> None:
        from nic.obs.integrity import SDCError, tree_equal_fn

        if self._tree_eq is None:
            self._tree_eq = tree_equal_fn()
        s = self.state
        # independent key stream: the guard must not perturb training
        # (bit-identical runs with the guard on or off)
        self._probe_key, sub = jax.random.split(self._probe_key)
        fn = self._probe_fn(lod, s.frozen)
        args = (s.fp, s.mlp, s.opt_fp, s.opt_mlp, sub)
        for attempt in range(3):
            a = fn(*args)
            b = fn(*args)
            if bool(self._tree_eq(a, b)):
                return
            import warnings

            warnings.warn(
                f"in-train SDC probe mismatch at step {s.step} "
                f"(attempt {attempt + 1}/3) — two executions of the same "
                "train step disagree; device corruption suspected")
        raise SDCError(
            f"persistent train-step corruption at step {s.step}; restart "
            "the process and resume from the newest checkpoint (TF_RESUME)")

    def train_many(self, num_steps: int, chunk: int = 1000):
        """Run ``num_steps`` epochs in compiled chunks of at most ``chunk``
        steps — one host dispatch per chunk (``_loop_fn``). Returns
        (loss_hist, psnr_hist) arrays.

        Handles the 95% freeze boundary exactly like the per-step path.
        With ``sdc_guard_train`` (opt-in), each chunk is followed by a
        double-executed probe step (see ``_sdc_probe``).
        """
        s = self.state
        cfg = self.cfg
        loss_hist: list = []
        psnr_hist: list = []
        remaining = num_steps
        while remaining > 0:
            # steps until the freeze boundary (first step with step > 95% —
            # image_compression.py:227 checks before the step runs)
            if not s.frozen:
                boundary = int(cfg.num_epochs * 0.95) + 1 - s.step
                if boundary <= 0:
                    self.freeze_and_quantize()
                    continue
                n = min(remaining, boundary, chunk)
            else:
                n = min(remaining, chunk)
            self._key, sub = jax.random.split(self._key)
            lods = np.zeros(chunk, np.int32)
            if self.max_mip > 0:
                lods[:n] = [
                    sample_lod(self._lod_rng, self._uniform_gate(),
                               self.max_mip)
                    for _ in range(n)
                ]
            run = self._loop_fn(s.frozen, chunk)
            (s.fp, s.mlp, s.opt_fp, s.opt_mlp), (lh, ph) = run(
                s.fp, s.mlp, s.opt_fp, s.opt_mlp, sub, jnp.asarray(lods),
                jnp.int32(n)
            )
            s.step += n
            remaining -= n
            loss_hist.append(np.asarray(lh)[:n])
            psnr_hist.append(np.asarray(ph)[:n])
            if cfg.sdc_guard_train and n >= 64:
                # guard full-size chunks only (tiny boundary chunks would
                # pay a probe per handful of steps); LOD 0 probes the
                # largest compiled geometry
                self._sdc_probe(0)
        return np.concatenate(loss_hist), np.concatenate(psnr_hist)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def freeze_and_quantize(self) -> None:
        """End-of-QAT transition (image_compression.py:227-231)."""
        self.state.fp = fp_lib.pyramid_quantize_all(self.state.fp, self.cfg.fp_bits)
        self.state.frozen = True

    def train_step(self):
        """One epoch: host LOD draw → jitted device step. Returns
        (loss, step_psnr, lod) as device scalars + python int."""
        s = self.state
        cfg = self.cfg
        if not s.frozen and s.step > cfg.num_epochs * 0.95:
            self.freeze_and_quantize()
        lod = sample_lod(self._lod_rng, self._uniform_gate(), self.max_mip)
        self._key, sub = jax.random.split(self._key)
        fn = self._step_fn(lod, s.frozen)
        s.fp, s.mlp, s.opt_fp, s.opt_mlp, loss, step_psnr = fn(
            s.fp, s.mlp, s.opt_fp, s.opt_mlp, sub
        )
        s.step += 1
        return loss, step_psnr, lod

    # ------------------------------------------------------------------
    # checkpoint / resume (preemption-safe training; replaces the
    # reference's encode_from_middle flags, movie_3d_comp.py:29-35)
    # ------------------------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        from nic.io.artifacts import save_checkpoint

        save_checkpoint(
            path, self.state.step,
            {"fp": self.state.fp, "mlp": self.state.mlp},
            {"fp": self.state.opt_fp, "mlp": self.state.opt_mlp},
            extra={"frozen": self.state.frozen},
        )

    def load_checkpoint(self, path: str) -> None:
        import json

        import numpy as _np

        from nic.io.artifacts import load_checkpoint

        s = self.state
        step, params, opt = load_checkpoint(
            path, {"fp": s.fp, "mlp": s.mlp}, {"fp": s.opt_fp, "mlp": s.opt_mlp}
        )
        with _np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
        frozen = bool(meta.get("frozen", False))
        if frozen and step <= self.cfg.num_epochs * 0.95:
            # protocol EXTENSION: the checkpoint comes from a run whose
            # freeze point (95% of ITS num_epochs) already passed, but the
            # new schedule's freeze lies ahead — unfreeze so the grids
            # train again (from their quantized values) until the new 95%
            # mark, matching the requested protocol. Keeping them frozen
            # silently degrades an extended run to the old run's quality
            # (observed: a 100k→320k extension pinned at the 100k PSNR).
            import warnings

            warnings.warn(
                f"resumed a post-freeze checkpoint (step {step}) into a "
                f"{self.cfg.num_epochs}-epoch schedule; unfreezing grids "
                "for the extended training phase"
            )
            frozen = False
        self.state = NTCState(
            fp=params["fp"], mlp=params["mlp"],
            opt_fp=opt["fp"], opt_mlp=opt["mlp"],
            step=step, frozen=frozen,
        )

    # ------------------------------------------------------------------
    # tiled full-image decode (image_compression.py:307-346 semantics)
    # ------------------------------------------------------------------

    def _build_decode(self, mip: int, div_size: int):
        cfg = self.cfg
        ndim = self.ndim
        decode_size = cfg.image_size // (2**mip)
        hw = cfg.image_hw if ndim == 2 else (cfg.image_size,) * ndim
        decode_hw = tuple(s // (2**mip) for s in hw)
        rect = len(set(decode_hw)) > 1
        backend = cfg.resolved_decode_backend
        kw = dict(backend=backend, image_size=cfg.image_size,
                  mip_to_level=self.mip_to_level,
                  pe_channels=cfg.pe_channels, use_tri_pe=self._use_tri_pe(),
                  ndim=ndim, sparse_g0=self._sparse_g0(),
                  g1_quirk=cfg.tf_g1_quirk)
        power = self.max_mip - mip
        div_slice = 2 ** max(power - div_size, 0)
        mesh = self.mesh
        if backend == "pallas" or rect or div_slice == 1:
            # whole-asset decode: the kernel's footprint is its output, so
            # it never tiles; rectangular decodes run full-frame
            from nic.kernels.decode import decode as decode_one
            from nic.kernels.decode_sharded import decode_sharded, shardable

            if shardable(decode_hw, mesh) and mesh.devices.size > 1:
                branch = f"{backend} rows over {mesh.devices.size} devices"

                def decode(fp, mlp):
                    return decode_sharded(fp, mlp, mip, mesh, n=decode_hw,
                                          **kw)
            else:
                branch = backend

                def decode(fp, mlp):
                    return decode_one(fp, mlp, mip, n=decode_hw, **kw)
        else:
            # tile origins on a regular ndim lattice (div_size semantics of
            # image_compression.py:307-346, :335-340 for 3D); vmap over all
            # tiles then stitch by reshape/transpose — compile time is
            # O(1) in the tile count
            n = decode_size // div_slice
            ij = jnp.stack(
                jnp.meshgrid(*([jnp.arange(div_slice)] * ndim),
                             indexing="ij"),
                axis=-1,
            ).reshape(-1, ndim)
            origins = ij * n
            # interleave (tile_i, intile_i) axes: 2D (0,2,1,3,4),
            # 3D (0,3,1,4,2,5,6)
            perm = tuple(
                a for d in range(ndim) for a in (d, ndim + d)
            ) + (2 * ndim,)
            from nic.kernels.decode import decode as decode_one

            branch = f"{backend} ({div_slice ** ndim} tiles)"

            def decode(fp, mlp):
                tiles = jax.vmap(lambda o: decode_one(
                    fp, mlp, mip, n=n,
                    origin=tuple(o[d] for d in range(ndim)), **kw))(origins)
                if mesh is not None:
                    # decode tiles data-parallel over the mesh (grids/MLP
                    # replicated; no halo needed — gathers are local)
                    from jax.sharding import PartitionSpec as P

                    tiles = shard_batch(
                        tiles, mesh, P("data", *([None] * (ndim + 1)))
                    )
                t = tiles.reshape((div_slice,) * ndim + (n,) * ndim + (3,))
                return t.transpose(perm).reshape((decode_size,) * ndim + (3,))

        gate_key = ("decode", mip, div_size)
        if gate_key not in self._gate_logged:
            self._gate_logged.add(gate_key)
            self.log(f"decode backend (mip={mip}): {branch} "
                     f"[DECODE_BACKEND={cfg.decode_backend}]")
        return jax.jit(decode)
    def decode(self, mip: int, div_size: int | None = None,
               quantized: bool = True):
        """Decode the full asset at ``mip`` from (optionally) hard-quantized
        grids. Returns [s, s(, s), 3] in [0, 1]. ``div_size`` defaults to
        the DIV_SIZE config key (reference default 10,
        image_compression.py:307)."""
        if div_size is None:
            div_size = self.cfg.div_size
        key = (mip, div_size)
        if key not in self._decode_fns:
            self._decode_fns[key] = self._build_decode(mip, div_size)
        fp = self.state.fp
        if quantized and not self.state.frozen:
            fp = fp_lib.pyramid_quantize_all(fp, self.cfg.fp_bits)
        return self._decode_fns[key](fp, self.state.mlp)
