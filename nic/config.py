"""Typed config with reference-parity ``KEY=VALUE`` CLI overrides.

Replaces the reference's exec-based flag system
(``Projects/var2.py:6-125`` of 21K1113/Neural_Image_Compression_V2): the
same UPPERCASE flag names and defaults, accepted verbatim on the command
line (so the reference's ``.bat`` sweep invocations work unchanged), but
parsed into a frozen dataclass — no ``exec``, every key type-checked
against the whitelist.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

# TRAIN_FORWARD=auto: the faster forward of the flagship training cell on
# the GPU (PERF.md); both compute the same value and gradients.
AUTO_TRAIN_FORWARD = "folded"


def _parse_bool(value: str, key: str) -> bool:
    v = value.lower()
    if v in ("true", "1"):
        return True
    if v in ("false", "0"):
        return False
    raise ValueError(f"{key} must be a boolean (True/False or 1/0)")


@dataclass(frozen=True)
class CompressionConfig:
    """Flags of the flagship ``image_compression`` workload (var2.py:38-87).

    Field names are pythonic; CLI keys are the reference's UPPERCASE names
    (see ``_CLI_KEYS``). Defaults match var2.py exactly.
    """

    image_path: str = "data/sancho_512.png"
    project_name: str = "image_compression"
    compression_method: int = 1  # 1: 2D | 2: 3D→2D tiles | 3: 3D pyramid | 4: sparse-G0 3D
    mlp_num_dtype: int = 16      # 16 → bf16 MLP dot operands (replaces the reference's
                                 # broken fp16, readme.md:9), 32 → fp32 (the reference
                                 # default). 16 converged to fp32 parity at 320k steps
                                 # at every FP_BITS (41.95 vs 41.96 dB @FP8); grid
                                 # sampling, grid updates, QAT noise and the loss stay
                                 # fp32.
    num_epochs: int = 1000
    uniform_distribution_rate: float = 0.05
    image_3d_size: int = 64
    image_size: int = 512
    image_size_w: int = 0        # 0 → square (image_size). Non-zero enables
                                 # NATIVE rectangular geometry (2D, tf_no_mip):
                                 # [image_size, image_size_w] images, per-axis
                                 # feature-pyramid sizes — the reference is
                                 # square-only (var2.py:60); this is the Kodak
                                 # 768x512 native-eval extension (round 4)
    image_dimension: int = 2
    max_mip_level: int = 9
    image_bits: int = 8
    output_bits: int = 8
    feature_pyramid_channels: int = 12
    pe_channels: int = 6
    fp_bits: int = 8
    hidden_layer_channels: int = 64
    crop_mip_level: int = 8
    num_crops: int = 8
    interval_print: int = 100
    interval_save_model: int = 100000
    tf_no_mip: bool = True
    tf_use_tri_pe: bool = True
    tf_train_model: bool = True
    tf_show_result: bool = False
    tf_print_log: bool = True
    tf_print_psnr: bool = True
    tf_write_time: bool = True
    tf_write_psnr: bool = True
    # --- new framework knobs (no reference counterpart) ---
    seed: int = 0
    decode_backend: str = "auto"     # "auto" (the measured-fastest backend,
                                     # nic.kernels.decode.AUTO_BACKEND) | "pallas"
                                     # (fused Triton kernel) | "fast" (folded
                                     # layer 1, XLA) | "xla" (unfused)
    qat_ste: bool = False            # straight-through estimator (off = reference parity)
    data_parallel: bool = False      # shard crops over a device mesh
    output_root: str = "runs"        # artifact root (reference wrote to cwd-relative dirs)
    save_lut_csv: bool = False       # export decoded 3D LUTs as CSV (sample22-x lineage)
    rng_impl: str = "rbg"            # "rbg" = cheaper on-device bits for QAT noise
                                     # (320k convergence runs with rbg landed at fp32
                                     # parity, 41.95/41.97 dB);
                                     # "threefry2x32" = JAX's default counter PRNG
    tf_g1_quirk: bool = True         # reference's step==2 unweighted G1 sum (readme.md:7)
    mlp_store_bits: int = 32         # 16 → float16 decoder weights in the artifact
    entropy_code_grids: bool = False  # rANS-code grid codes vs fixed-length packing
    tf_resume: bool = False          # resume training from the newest checkpoint
    sdc_guard_train: bool = False    # opt-in SDC probe: after each scan chunk, run
                                     # ONE train step twice (non-donating) and
                                     # compare every output bit-for-bit on device;
                                     # probe results are discarded, so training is
                                     # bit-identical either way
                                     # (nic/obs/integrity.py); raises SDCError when
                                     # persistent
    sdc_guard_decode: bool = False   # opt-in: CLI decodes run twice and must
                                     # agree bit-for-bit before they are scored
                                     # or exported (nic/obs/integrity.py)
    train_forward: str = "auto"      # "auto" (the measured-faster of the two,
                                     # AUTO_TRAIN_FORWARD) | "gather"
                                     # (reference-shaped [N,F] feature build) |
                                     # "folded" (first MLP layer folded into the
                                     # grids at node resolution, fastdecode
                                     # algebra; same value and gradients)
    grid_vjp: str = "scatter"        # grid-gradient path for the train-step gather:
                                     # "scatter" (autodiff take → scatter-add) |
                                     # "dense" (hand-written phase-reshape-sum VJP,
                                     # sample._axis_take_dense_vjp; bit-identical
                                     # forward, summation-order-equal grads)
    qat_noise_where: str = "feature"  # "feature" (parity: iid noise on every decoder
                                     # input channel, image_compression.py:248-254) |
                                     # "node" (noise the active grids' nodes — models
                                     # the interpolated quantization error the decoder
                                     # actually sees at eval; ~100× fewer RNG draws)
    div_size: int = 10               # tiled-decode granularity (decode_image div_size,
                                     # image_compression.py:307-346): tiles/axis =
                                     # 2^max(max_mip - mip - div_size, 0)
    profile_dir: str = ""            # non-empty → capture a jax.profiler trace
                                     # (nic.obs.trace.profile_trace) of one compiled
                                     # training chunk (the second interval, post-warmup)
                                     # into this TensorBoard logdir

    # ---- derived (var2.py:99-125 semantics) ----

    @property
    def resolved_decode_backend(self) -> str:
        from nic.kernels.decode import resolve_backend

        return resolve_backend(self.decode_backend)

    @property
    def resolved_train_forward(self) -> str:
        if self.train_forward == "auto":
            return AUTO_TRAIN_FORWARD
        if self.train_forward not in ("gather", "folded"):
            raise ValueError("TRAIN_FORWARD must be auto, gather or folded, "
                             f"got {self.train_forward!r}")
        return self.train_forward

    @property
    def basename(self) -> str:
        return os.path.basename(self.image_path)

    @property
    def image_ext(self) -> str:
        return os.path.splitext(self.image_path)[1][1:]

    @property
    def image_dtype(self) -> str:
        ext = self.image_ext.lower()
        if ext in ("npy", "npz"):
            return "ndarray"
        if ext in ("avi", "mp4"):
            return "movie"
        if ext in ("png", "jpg", "jpeg"):
            return "image"
        raise ValueError(f"unsupported asset extension: {self.image_ext}")

    @property
    def feature_pyramid_size(self) -> int:
        return self.image_size // 4

    @property
    def image_hw(self) -> tuple[int, int]:
        """(rows, cols) of the 2D asset; cols default to square."""
        return (self.image_size, self.image_size_w or self.image_size)

    @property
    def is_rectangular(self) -> bool:
        return self.image_size_w not in (0, self.image_size)

    @property
    def feature_pyramid_hw(self) -> tuple[int, int]:
        h, w = self.image_hw
        return (h // 4, w // 4)

    @property
    def fp_dimension(self) -> int:
        return 2 if self.compression_method == 2 else self.image_dimension

    @property
    def effective_max_mip_level(self) -> int:
        return 0 if self.tf_no_mip else self.max_mip_level

    @property
    def decoder_input_channels(self) -> int:
        """var2.py:114-118: C·(2^dim + 1) + PE·dim + 1; method 4 uses a sparse
        4-corner G0 so its grid term is C·(2^2 + 1)."""
        c, pe, dim = self.feature_pyramid_channels, self.pe_channels, self.fp_dimension
        g0_corners = 4 if self.compression_method == 4 else 2**dim
        return c * (g0_corners + 1) + pe * dim + 1

    @property
    def crop_size(self) -> int:
        return 2**self.crop_mip_level

    @property
    def save_name(self) -> str:
        """Artifact stem (var2.py:123 scheme, device name → 'jax')."""
        return (
            f"{self.project_name}_jax_{self.basename}_{self.mlp_num_dtype}_"
            f"{self.tf_no_mip}_{self.tf_use_tri_pe}_{self.compression_method}_"
            f"{self.num_epochs}_{self.fp_bits}"
        )

    def compute_dtype(self):
        import jax.numpy as jnp

        # 16 selects bf16: the replacement for the reference's broken
        # fp16 training path (readme.md:9).
        return {16: jnp.bfloat16, 32: jnp.float32, 64: jnp.float64}[self.mlp_num_dtype]


# CLI key (reference var2.py:6-36 whitelist) → dataclass field
_CLI_KEYS: dict[str, str] = {
    "FP_BITS": "fp_bits",
    "NUM_EPOCHS": "num_epochs",
    "IMAGE_SIZE": "image_size",
    "IMAGE_SIZE_W": "image_size_w",
    "IMAGE_3D_SIZE": "image_3d_size",
    "MAX_MIP_LEVEL": "max_mip_level",
    "FEATURE_PYRAMID_CHANNELS": "feature_pyramid_channels",
    "PE_CHANNELS": "pe_channels",
    "IMAGE_PATH": "image_path",
    "PROJECT_NAME": "project_name",
    "COMPRESSION_METHOD": "compression_method",
    "MLP_NUM_DTYPE": "mlp_num_dtype",
    "UNIFORM_DISTRIBUTION_RATE": "uniform_distribution_rate",
    "IMAGE_DIMENSION": "image_dimension",
    "IMAGE_BITS": "image_bits",
    "OUTPUT_BITS": "output_bits",
    "HIDDEN_LAYER_CHANNELS": "hidden_layer_channels",
    "CROP_MIP_LEVEL": "crop_mip_level",
    "NUM_CROPS": "num_crops",
    "INTERVAL_PRINT": "interval_print",
    "INTERVAL_SAVE_MODEL": "interval_save_model",
    "TF_NO_MIP": "tf_no_mip",
    "TF_USE_TRI_PE": "tf_use_tri_pe",
    "TF_TRAIN_MODEL": "tf_train_model",
    "TF_SHOW_RESULT": "tf_show_result",
    "TF_PRINT_LOG": "tf_print_log",
    "TF_PRINT_PSNR": "tf_print_psnr",
    "TF_WRITE_TIME": "tf_write_time",
    "TF_WRITE_PSNR": "tf_write_psnr",
    # new-framework keys (lowercase field names accepted directly too)
    "SEED": "seed",
    "DECODE_BACKEND": "decode_backend",
    "QAT_STE": "qat_ste",
    "DATA_PARALLEL": "data_parallel",
    "OUTPUT_ROOT": "output_root",
    "SAVE_LUT_CSV": "save_lut_csv",
    "RNG_IMPL": "rng_impl",
    "TF_G1_QUIRK": "tf_g1_quirk",
    "MLP_STORE_BITS": "mlp_store_bits",
    "ENTROPY_CODE_GRIDS": "entropy_code_grids",
    "TF_RESUME": "tf_resume",
    "SDC_GUARD_TRAIN": "sdc_guard_train",
    "SDC_GUARD_DECODE": "sdc_guard_decode",
    "DIV_SIZE": "div_size",
    "TRAIN_FORWARD": "train_forward",
    "GRID_VJP": "grid_vjp",
    "QAT_NOISE_WHERE": "qat_noise_where",
    "PROFILE_DIR": "profile_dir",
}


def parse_overrides(argv: list[str], base: CompressionConfig | None = None) -> CompressionConfig:
    """Apply ``KEY=VALUE`` argv overrides (var2.py:90-95 semantics, no exec)."""
    cfg = base or CompressionConfig()
    fields = {f.name: f for f in dataclasses.fields(CompressionConfig)}
    updates: dict = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"expected KEY=VALUE, got {arg!r}")
        key, value = arg.split("=", 1)
        field_name = _CLI_KEYS.get(key, key if key in fields else None)
        if field_name is None:
            raise ValueError(f"unknown config key {key!r}")
        ftype = fields[field_name].type
        if ftype in ("bool", bool):
            updates[field_name] = _parse_bool(value, key)
        elif ftype in ("int", int):
            updates[field_name] = int(value)
        elif ftype in ("float", float):
            updates[field_name] = float(value)
        else:
            updates[field_name] = value
    return dataclasses.replace(cfg, **updates)


def config_echo(cfg: CompressionConfig) -> list[str]:
    """Reference-style config echo lines (image_compression.py:20-23)."""
    lines = []
    for key, field_name in _CLI_KEYS.items():
        lines.append(f"{key} : {getattr(cfg, field_name)}")
    return lines
