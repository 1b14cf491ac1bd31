"""nic — neural image/LUT compression in JAX.

A JAX/XLA/Pallas implementation of the capabilities of the reference repo
21K1113/Neural_Image_Compression_V2 (PyTorch):

- ``nic.core``     quantization / positional encodings / metrics (pure fns)
- ``nic.grids``    multiresolution feature pyramid (G0/G1) + vectorized sampling
- ``nic.kernels``  the fused decode kernel (Pallas through Triton) + decode dispatch
- ``nic.models``   tiny-MLP decoder + conv autoencoders (2D/3D)
- ``nic.train``    jitted train loops (QAT schedule, LOD sampling, crops)
- ``nic.parallel`` device-mesh sharding (data/pixel parallel via jax.sharding)
- ``nic.data``     host-side asset I/O (images, video, npy LUTs, mip chains)
- ``nic.io``       compressed artifact format, checkpoints, versioned names
- ``nic.obs``      logging, TensorBoard scalars, span timers, tensor audits
- ``nic.cli``      entry points mirroring the reference workloads
"""

__version__ = "0.1.0"

import os as _os


def _setup_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache for this process.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing
    here overrides it. Otherwise the cache lives in ``.jax_cache/`` at the
    repo root (gitignored): a fixed path, so a later process finds it.
    Opt out with ``NIC_COMPILE_CACHE=0``.
    """
    if _os.environ.get("NIC_COMPILE_CACHE", "1").lower() in ("0", "off", ""):
        return
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache")
        _os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache anything that took >1s to compile; small entries included
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_setup_compilation_cache()
