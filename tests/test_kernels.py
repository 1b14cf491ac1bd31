"""The Triton decode kernel (nic/kernels/decode_triton.py) and the decode
dispatch (nic/kernels/decode.py) against the folded XLA decode and the
unfused float32 reference. On the CPU the kernel runs in the Pallas
interpreter (tests/conftest.py); its timings come from bench.py and
chip_smoke.py on the GPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nic.grids.fastdecode import fast_decode
from nic.grids.pyramid import create_pyramid, pyramid_mip_levels
from nic.kernels import decode_triton
from nic.kernels.decode import decode, resolve_backend
from nic.kernels.decode_triton import decode_fused
from nic.models.mlp import init_mlp


def _setup(ndim=2, size=64, c=4, pe=4, hidden=16, sparse=False, seed=3,
           no_mip=False, hw=None):
    """Seeded pyramid + MLP; ``hw`` gives a rectangular 2D geometry."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    if hw is not None:
        base = tuple(s // 4 for s in hw)
        m2l = pyramid_mip_levels(hw[0], min(base), no_mip=no_mip)
    else:
        base = size // 4
        m2l = pyramid_mip_levels(size, base, no_mip=no_mip)
    fp, _ = create_pyramid(k1, base, c, 8, ndim=ndim, no_mip=no_mip)
    corners = 4 if sparse else 2**ndim
    mlp = init_mlp(k2, c * (corners + 1) + pe * ndim + 1, hidden, 3)
    return fp, mlp, m2l


def _u8(a):
    return np.clip(np.asarray(a) * 255 + 0.5, 0, 255).astype(np.int32)


@pytest.mark.parametrize("use_tri_pe", [True, False])
@pytest.mark.parametrize("mip", [0, 1, 2, 3, 4, 5, 6])
def test_kernel_matches_fastdecode_2d_mips(mip, use_tri_pe):
    """Every mip of the protocol map, thumbnails included: e ranges over
    {-2, -1, 0, 1 (the step==2 raw-sum quirk), 2+} and both levels."""
    fp, mlp, m2l = _setup()
    kw = dict(image_size=64, mip_to_level=m2l, pe_channels=4,
              use_tri_pe=use_tri_pe)
    want = np.asarray(fast_decode(fp, mlp, mip, **kw))
    got = np.asarray(decode_fused(fp, mlp, mip, **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("sparse_g0", [False, True])
@pytest.mark.parametrize("mip", [0, 1, 2, 3, 4])
def test_kernel_matches_fastdecode_3d(mip, sparse_g0):
    """Methods 3 (dense 8-corner G0, tri-PE) and 4 (sparse even-parity
    G0, sinusoidal PE) across mips."""
    fp, mlp, m2l = _setup(ndim=3, size=32, sparse=sparse_g0, seed=11)
    kw = dict(image_size=32, mip_to_level=m2l, pe_channels=4,
              use_tri_pe=not sparse_g0, ndim=3, sparse_g0=sparse_g0)
    want = np.asarray(fast_decode(fp, mlp, mip, **kw))
    got = np.asarray(decode_fused(fp, mlp, mip, **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("hw", [(64, 96), (96, 64), (32, 128)])
@pytest.mark.parametrize("mip", [0, 1, 2])
def test_kernel_rectangular(hw, mip):
    fp, mlp, m2l = _setup(hw=hw, no_mip=True, seed=11)
    ns = tuple(s >> mip for s in hw)
    kw = dict(image_size=hw[0], mip_to_level=m2l, pe_channels=4, n=ns)
    want = np.asarray(fast_decode(fp, mlp, mip, **kw))
    got = np.asarray(decode_fused(fp, mlp, mip, **kw))
    assert got.shape == ns + (3,)
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("block,num_warps", [(16, 1), (32, 4), (128, 8),
                                             (1024, 8)])
def test_kernel_block_sizes(block, num_warps):
    """Many programs (block < pixels), one program, and a last block
    whose spare lanes write only the output padding."""
    fp, mlp, m2l = _setup(size=48, no_mip=True)
    kw = dict(image_size=48, mip_to_level=m2l, pe_channels=4, n=(48, 40))
    want = np.asarray(fast_decode(fp, mlp, 0, **kw))
    got = np.asarray(decode_fused(fp, mlp, 0, block=block,
                                  num_warps=num_warps, **kw))
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("hidden", [8, 16, 24, 64])
def test_kernel_pads_hidden_width(hidden):
    """Widths that are not a power of two ≥ 16 are zero-padded; the pad
    channels stay 0 through both GELUs and contribute nothing."""
    fp, mlp, m2l = _setup(hidden=hidden, c=12, pe=6, no_mip=True, seed=7)
    kw = dict(image_size=64, mip_to_level=m2l, pe_channels=6)
    want = np.asarray(fast_decode(fp, mlp, 0, **kw))
    got = np.asarray(decode_fused(fp, mlp, 0, **kw))
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("ndim", [2, 3])
def test_kernel_matches_unfused_reference(ndim):
    """Against the plain float32 reference (decoder_input + apply_mlp at
    "highest" precision): within one u8 step, float rounding only."""
    size = 64 if ndim == 2 else 32
    fp, mlp, m2l = _setup(ndim=ndim, size=size, c=12, pe=6, hidden=64,
                          no_mip=True)
    kw = dict(image_size=size, mip_to_level=m2l, pe_channels=6, ndim=ndim)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(decode(fp, mlp, 0, backend="xla", **kw))
    got = np.asarray(decode(fp, mlp, 0, backend="pallas", **kw))
    assert np.abs(got - ref).max() < 1e-5
    assert np.abs(_u8(got) - _u8(ref)).max() <= 1


@pytest.mark.parametrize("dtype,gelu,tol", [
    ("fp32", "tanh", 2e-3),   # |Δgelu| ≤ 4.7e-4 through the tail
    ("bf16", "exact", 3e-3),  # 8-bit mantissa W2 operands
    ("bf16", "tanh", 4e-3),
])
def test_kernel_fast_modes_close(dtype, gelu, tol):
    """The fast modes stay under one u8 step (1/255 ≈ 3.9e-3) of the
    exact decode at flagship widths."""
    fp, mlp, m2l = _setup(c=12, pe=6, hidden=64, no_mip=True, seed=5)
    kw = dict(image_size=64, mip_to_level=m2l, pe_channels=6)
    want = np.asarray(fast_decode(fp, mlp, 0, **kw))
    got = np.asarray(decode_fused(fp, mlp, 0, dtype=dtype, gelu=gelu, **kw))
    assert np.abs(got - want).max() < tol
    assert np.abs(_u8(got) - _u8(want)).max() <= 1


@pytest.mark.parametrize("dtype,gelu", [("bf16", "exact"), ("fp32", "tanh")])
def test_kernel_fast_modes_close_3d(dtype, gelu):
    fp, mlp, m2l = _setup(ndim=3, size=32, c=12, pe=6, hidden=64,
                          no_mip=True, seed=9)
    kw = dict(image_size=32, mip_to_level=m2l, pe_channels=6, ndim=3)
    want = np.asarray(fast_decode(fp, mlp, 0, **kw))
    got = np.asarray(decode_fused(fp, mlp, 0, dtype=dtype, gelu=gelu, **kw))
    assert np.abs(_u8(got) - _u8(want)).max() <= 1


@pytest.mark.parametrize("traced", [False, True])
def test_kernel_tile_origin(traced):
    """A tile at an origin equals that slice of the whole decode, with
    static origins and with traced ones (which need ``full_n``)."""
    fp, mlp, m2l = _setup(no_mip=True)
    kw = dict(image_size=64, mip_to_level=m2l, pe_channels=4)
    full = np.asarray(decode_fused(fp, mlp, 0, **kw))
    if traced:
        tile = jax.jit(lambda o: decode_fused(
            fp, mlp, 0, n=(16, 32), origin=(o[0], o[1]), full_n=(64, 64),
            **kw))(jnp.asarray([16, 32], jnp.int32))
    else:
        tile = decode_fused(fp, mlp, 0, n=(16, 32), origin=(16, 32), **kw)
    np.testing.assert_allclose(np.asarray(tile), full[16:32, 32:64],
                               atol=1e-6)


def test_kernel_g1_quirk_off():
    """TF_G1_QUIRK=False applies the G1 weights at step == 2 too."""
    fp, mlp, m2l = _setup()
    mip = next(m for m in sorted(m2l) if m - (m2l[m] + 1) * 2 == 1)
    kw = dict(image_size=64, mip_to_level=m2l, pe_channels=4,
              g1_quirk=False)
    np.testing.assert_allclose(
        np.asarray(decode_fused(fp, mlp, mip, **kw)),
        np.asarray(fast_decode(fp, mlp, mip, **kw)), atol=2e-6)


def test_kernel_rejects_unknown_dtype():
    fp, mlp, m2l = _setup()
    with pytest.raises(ValueError, match="dtype"):
        decode_fused(fp, mlp, 0, image_size=64, mip_to_level=m2l,
                     pe_channels=4, dtype="i16")


def test_gelu_polynomials():
    """The in-kernel exact GELU (erf polynomial) sits at float32 rounding
    of jax's erf GELU; the tanh form within its known 4.7e-4."""
    x = jnp.linspace(-9.0, 9.0, 20001, dtype=jnp.float32)
    exact = jax.nn.gelu(x, approximate=False)
    assert float(jnp.abs(decode_triton._gelu_exact(x) - exact).max()) < 2e-6
    assert float(jnp.abs(decode_triton._gelu_tanh(x) - exact).max()) < 5e-4


def test_dot_bf16x3_is_float32_class():
    """The fp32 mode's three-pass bf16 product: ~2⁻¹⁶ relative error per
    product, against ~2⁻⁸ for one bf16 pass."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    a = jax.random.normal(k1, (128, 64), jnp.float32)
    b = jax.random.normal(k2, (64, 64), jnp.float32)
    with jax.default_matmul_precision("highest"):
        want = a @ b
    three = decode_triton._dot_bf16x3(a, b)
    one = jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                  preferred_element_type=jnp.float32)
    scale = float(jnp.abs(want).max())
    assert float(jnp.abs(three - want).max()) / scale < 1e-4
    assert float(jnp.abs(one - want).max()) / scale > 1e-3


@pytest.mark.parametrize("ndim,dtype", [(2, "fp32"), (2, "bf16"),
                                        (3, "fp32"), (3, "bf16")])
def test_kernel_lowers_to_triton(ndim, dtype, monkeypatch):
    """The kernel at flagship width lowers to Triton IR for CUDA without
    a GPU (what the card's compiler then refuses shows only there)."""
    monkeypatch.setattr(decode_triton, "INTERPRET", False)
    size = 256 if ndim == 2 else 32
    fp, mlp, m2l = _setup(ndim=ndim, size=size, c=12, pe=6, hidden=64,
                          no_mip=True)
    lowered = jax.jit(lambda fp, mlp: decode_fused(
        fp, mlp, 0, image_size=size, mip_to_level=m2l, pe_channels=6,
        ndim=ndim, dtype=dtype)).trace(fp, mlp).lower(
            lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text()


def test_resolve_backend_and_mode_checks():
    assert resolve_backend("auto") == "pallas"
    assert resolve_backend("fast") == "fast"
    with pytest.raises(ValueError, match="decode backend"):
        resolve_backend("mosaic")
    fp, mlp, m2l = _setup()
    with pytest.raises(ValueError, match="pallas backend only"):
        decode(fp, mlp, 0, backend="fast", image_size=64, mip_to_level=m2l,
               pe_channels=4, dtype="bf16")


@pytest.mark.parametrize("backend", ["pallas", "fast", "xla"])
def test_dispatch_backends_agree(backend):
    fp, mlp, m2l = _setup(no_mip=True)
    kw = dict(image_size=64, mip_to_level=m2l, pe_channels=4)
    want = np.asarray(fast_decode(fp, mlp, 0, **kw))
    got = np.asarray(decode(fp, mlp, 0, backend=backend, **kw))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_trainer_pallas_backend_matches_fast():
    """NTCTrainer with DECODE_BACKEND=pallas must decode the same image
    as the fast XLA backend, tiled (DIV_SIZE small) or not."""
    from nic.config import CompressionConfig
    from nic.train.ntc import NTCTrainer

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (3, 32, 32)).astype(np.float32)
    outs = {}
    for backend in ("fast", "pallas"):
        cfg = CompressionConfig(
            image_size=32, crop_mip_level=4, num_crops=2, num_epochs=5,
            fp_bits=8, feature_pyramid_channels=4, pe_channels=4,
            hidden_layer_channels=16, tf_no_mip=True, seed=0,
            decode_backend=backend,
        )
        trainer = NTCTrainer(cfg, [img])
        outs[backend] = np.asarray(trainer.decode(0, div_size=10))
        outs[backend + "_tiled"] = np.asarray(trainer.decode(0, div_size=-2))
    for k in ("pallas", "pallas_tiled", "fast_tiled"):
        assert outs[k].shape == (32, 32, 3)
        np.testing.assert_allclose(outs[k], outs["fast"], atol=2e-5)


@pytest.mark.gpu
def test_kernel_on_gpu(gpu):
    """On the card: the compiled kernel against the float32 reference at
    flagship width (run by ``pytest -m gpu`` on a GPU machine)."""
    fp, mlp, m2l = _setup(size=512, c=12, pe=6, hidden=64, no_mip=True)
    kw = dict(image_size=512, mip_to_level=m2l, pe_channels=6)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(decode(fp, mlp, 0, backend="xla", **kw))
    for dtype in ("fp32", "bf16"):
        got = np.asarray(decode(fp, mlp, 0, backend="pallas", dtype=dtype,
                                **kw))
        assert np.abs(_u8(got) - _u8(ref)).max() <= (1 if dtype == "fp32"
                                                     else 2)
