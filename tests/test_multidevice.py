"""Multi-device sharding tests on the 8-device virtual CPU mesh (the
reference has no fake-cluster fixtures — SURVEY.md §4)."""

import numpy as np
import jax
import pytest

from nic.config import CompressionConfig
from nic.parallel.mesh import make_mesh
from nic.train.ntc import NTCTrainer


requires_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _toy_image(size):
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    return np.clip(np.stack([x, y, x * y], axis=0), 0, 1)


def _cfg(num_crops):
    return CompressionConfig(
        image_size=32, crop_mip_level=4, num_crops=num_crops, num_epochs=40,
        fp_bits=4, feature_pyramid_channels=4, pe_channels=4,
        hidden_layer_channels=16, tf_no_mip=True, seed=0,
    )


@requires_8
def test_dp_mesh_train_step_matches_single_device():
    """Sharded training must compute the same update as unsharded (same
    PRNG keys → same crops → grads psum to the same replicated result)."""
    img = _toy_image(32)
    mesh = make_mesh(8, data_axis=8)
    with mesh:
        tr_sharded = NTCTrainer(_cfg(8), [img], mesh=mesh)
        for _ in range(3):
            loss_s, _, _ = tr_sharded.train_step()
    tr_single = NTCTrainer(_cfg(8), [img])
    for _ in range(3):
        loss_1, _, _ = tr_single.train_step()
    assert abs(float(loss_s) - float(loss_1)) < 1e-5
    for a, b in zip(tr_sharded.state.fp, tr_single.state.fp):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@requires_8
def test_2d_mesh_data_x_pixel():
    img = _toy_image(32)
    mesh = make_mesh(8, data_axis=4)  # (data=4, pixel=2)
    with mesh:
        tr = NTCTrainer(_cfg(4), [img], mesh=mesh)
        for _ in range(4):
            loss, _, _ = tr.train_step()
        assert np.isfinite(float(loss))
        rec = np.asarray(tr.decode(0))
    assert rec.shape == (32, 32, 3)


def test_graft_entry():
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (64, 64, 3)
    ge.dryrun_multichip(min(8, len(jax.devices())))


@requires_8
def test_cli_data_parallel_flag(tmp_path):
    from nic.data.assets import save_png
    from nic.cli.image_compression import run

    rng = np.random.default_rng(0)
    img = (rng.uniform(0, 255, (32, 32, 3))).astype(np.uint8)
    p = str(tmp_path / "t.png")
    save_png(img, p)
    res = run([
        f"IMAGE_PATH={p}", "IMAGE_SIZE=32", "NUM_EPOCHS=30",
        "CROP_MIP_LEVEL=4", "NUM_CROPS=8", "FP_BITS=4",
        "FEATURE_PYRAMID_CHANNELS=4", "PE_CHANNELS=4",
        "HIDDEN_LAYER_CHANNELS=16", "DATA_PARALLEL=True",
        f"OUTPUT_ROOT={tmp_path}/runs",
    ])
    assert np.isfinite(res["psnr"][0])


@requires_8
def test_movie_label_frames_data_parallel_parity():
    """Frames sharded over 'data' must train to the same params as
    single-device (frame-axis parallelism for the movie family: params
    replicated, per-frame grads psum over the mesh)."""
    from nic.train.movie_label import MovieLabelTrainer

    rng = np.random.default_rng(0)
    movie = rng.uniform(0, 1, (8, 16, 16, 3)).astype(np.float32)
    mesh = make_mesh(8, data_axis=8)
    with mesh:
        tr_s = MovieLabelTrainer(movie, num_bits=4, num_epochs=20, seed=0,
                                 mesh=mesh)
        for _ in range(3):
            loss_s = tr_s.train_step()
        rec_s = tr_s.reconstruct()
    tr_1 = MovieLabelTrainer(movie, num_bits=4, num_epochs=20, seed=0)
    for _ in range(3):
        loss_1 = tr_1.train_step()
    rec_1 = tr_1.reconstruct()
    assert abs(float(loss_s) - float(loss_1)) < 1e-5
    np.testing.assert_allclose(np.asarray(tr_s.params["emb"]),
                               np.asarray(tr_1.params["emb"]), atol=1e-5)
    np.testing.assert_allclose(rec_s, rec_1, atol=1e-4)


@requires_8
def test_conv_ae_3d_time_axis_parallel_parity():
    """movie_3d: the volume's time axis shards over the mesh (the SPMD
    partitioner inserts the conv halo exchanges); training and the shared
    batched spatiotemporal decode must match single-device."""
    from nic.train.conv_ae import ConvAETrainer

    rng = np.random.default_rng(1)
    vol = rng.uniform(0, 1, (8, 16, 16, 3)).astype(np.float32)
    mesh = make_mesh(8, data_axis=8)
    with mesh:
        tr_s = ConvAETrainer(vol, num_bits=4, num_epochs=20, seed=0, mesh=mesh)
        for _ in range(3):
            loss_s = tr_s.train_step()
        rec_s = tr_s.reconstruct()
    tr_1 = ConvAETrainer(vol, num_bits=4, num_epochs=20, seed=0)
    for _ in range(3):
        loss_1 = tr_1.train_step()
    rec_1 = tr_1.reconstruct()
    assert abs(float(loss_s) - float(loss_1)) < 1e-5
    np.testing.assert_allclose(rec_s, rec_1, atol=1e-4)


@requires_8
def test_movie_frame_sheet_rows_parallel_parity():
    """movie_frame/movie_2d: the flattened frame sheet's row axis shards
    over the mesh."""
    from nic.train.conv_ae import ConvAETrainer

    rng = np.random.default_rng(2)
    sheet = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    mesh = make_mesh(8, data_axis=8)
    with mesh:
        tr_s = ConvAETrainer(sheet, num_bits=4, num_epochs=20, seed=0,
                             mesh=mesh)
        for _ in range(3):
            loss_s = tr_s.train_step()
        rec_s = tr_s.reconstruct()
    tr_1 = ConvAETrainer(sheet, num_bits=4, num_epochs=20, seed=0)
    for _ in range(3):
        loss_1 = tr_1.train_step()
    rec_1 = tr_1.reconstruct()
    assert abs(float(loss_s) - float(loss_1)) < 1e-5
    np.testing.assert_allclose(rec_s, rec_1, atol=1e-4)


@requires_8
def test_hyperprior_data_parallel_parity():
    """HyperpriorTrainer on the mesh (batch over 'data', params replicated)
    must match the single-device trainer bit-near: same seed → same crops →
    psum'd grads reproduce the unsharded update."""
    from nic.train.hyperprior import HyperpriorTrainer

    rng = np.random.default_rng(3)
    imgs = [rng.uniform(0, 1, (96, 96, 3)).astype(np.float32)]

    def make(mesh):
        return HyperpriorTrainer(n=8, m=12, lam=0.01, patch=64, batch=8,
                                 seed=0, mesh=mesh)

    mesh = make_mesh(8, data_axis=8)
    with mesh:
        tr_s = make(mesh)
        staged_s = tr_s.stage_images(imgs)
        lh_s, bh_s, _ = tr_s.train_chunk(staged_s, 4)
    tr_1 = make(None)
    lh_1, bh_1, _ = tr_1.train_chunk(tr_1.stage_images(imgs), 4)
    np.testing.assert_allclose(lh_s, lh_1, rtol=2e-4)
    np.testing.assert_allclose(bh_s, bh_1, rtol=2e-4)
    for a, b in zip(jax.tree.leaves(tr_s.params), jax.tree.leaves(tr_1.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


_SHARD_GEOMS = {
    # name: (ndim, hw, sparse_g0, mip)
    "2d": (2, (64, 64), False, 0),
    "2d-mip1": (2, (64, 64), False, 1),
    "rect": (2, (64, 96), False, 0),
    "3d-m3": (3, (16, 16, 16), False, 0),
    "3d-m4": (3, (16, 16, 16), True, 0),
}


@requires_8
@pytest.mark.parametrize("geom,backend", [
    (g, "pallas") for g in sorted(_SHARD_GEOMS)] + [("2d", "fast"),
                                                   ("3d-m4", "fast")])
def test_sharded_decode_matches_single_device(geom, backend):
    """Rows (2D) / frames (3D) split one block per device, each decoded
    by the single-device decode at its origin: the same values as one
    device decoding everything."""
    from nic.grids.pyramid import create_pyramid, pyramid_mip_levels
    from nic.kernels.decode import decode
    from nic.kernels.decode_sharded import decode_sharded
    from nic.models.mlp import init_mlp

    ndim, hw, sparse, mip = _SHARD_GEOMS[geom]
    c, pe = 4, 4
    base = tuple(s // 4 for s in hw[:2]) if ndim == 2 else hw[0] // 4
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    fp, _ = create_pyramid(k1, base, c, 8, ndim=ndim)
    m2l = pyramid_mip_levels(hw[0], min(hw) // 4)
    corners = 4 if sparse else 2**ndim
    mlp = init_mlp(k2, c * (corners + 1) + pe * ndim + 1, 16, 3)
    n = tuple(s >> mip for s in hw)
    kw = dict(backend=backend, image_size=hw[0], mip_to_level=m2l,
              pe_channels=pe, use_tri_pe=not sparse, ndim=ndim,
              sparse_g0=sparse, n=n)
    want = np.asarray(decode(fp, mlp, mip, **kw))
    got = np.asarray(decode_sharded(fp, mlp, mip, make_mesh(4, data_axis=4),
                                    **kw))
    assert got.shape == n + (3,)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharded_decode_rejects_uneven_rows():
    from nic.grids.pyramid import create_pyramid, pyramid_mip_levels
    from nic.kernels.decode_sharded import decode_sharded, shardable
    from nic.models.mlp import init_mlp

    fp, _ = create_pyramid(jax.random.PRNGKey(0), 4, 4, 8, ndim=2)
    mlp = init_mlp(jax.random.PRNGKey(1), 4 * 5 + 4 * 2 + 1, 16, 3)
    mesh = make_mesh(4, data_axis=4)
    assert shardable((16, 16), mesh) and not shardable((6, 16), mesh)
    assert not shardable((16, 16), None)
    with pytest.raises(ValueError, match="do not split"):
        decode_sharded(fp, mlp, 0, mesh, backend="fast", image_size=16,
                       mip_to_level=pyramid_mip_levels(16, 4),
                       pe_channels=4, n=(6, 16))
