"""Opt-in SDC guards (nic/obs/integrity.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from nic.obs.integrity import verified_fetch, verified_result


def test_verified_fetch_stable():
    x = jnp.arange(1024, dtype=jnp.float32).reshape(32, 32)
    out = verified_fetch(x)
    np.testing.assert_array_equal(out, np.asarray(x))


def test_verified_result_stable():
    calls = []

    def fn():
        calls.append(1)
        return np.full((8, 8), 3.0)

    out = verified_result(fn)
    assert len(calls) == 2  # exactly one confirmation run
    np.testing.assert_array_equal(out, np.full((8, 8), 3.0))


def test_verified_result_retries_past_one_corruption():
    vals = [np.zeros(4), np.ones(4), np.ones(4)]  # first fetch corrupted
    warns = []
    out = verified_result(
        lambda: vals.pop(0), warn=lambda m: warns.append(m)
    )
    np.testing.assert_array_equal(out, np.ones(4))
    assert len(warns) == 1 and "corruption" in warns[0]


def test_verified_result_raises_on_persistent_corruption():
    import itertools

    counter = itertools.count()

    def always_different():
        return np.full(4, next(counter), dtype=np.float64)

    with pytest.raises(RuntimeError, match="no stable result"):
        verified_result(always_different, retries=3)


def test_verified_result_nan_stable():
    out = verified_result(lambda: np.array([np.nan, 1.0]))
    assert np.isnan(out[0]) and out[1] == 1.0


def test_verified_result_tuple_output():
    a, b = verified_result(lambda: (np.ones(3), np.zeros((2, 2))))
    np.testing.assert_array_equal(a, np.ones(3))
    np.testing.assert_array_equal(b, np.zeros((2, 2)))

    vals = [(np.zeros(2), np.ones(2)), (np.ones(2), np.ones(2)),
            (np.ones(2), np.ones(2))]
    warns = []
    a, b = verified_result(lambda: vals.pop(0),
                           warn=lambda m: warns.append(m))
    np.testing.assert_array_equal(a, np.ones(2))
    assert len(warns) == 1


def test_in_train_sdc_guard_noop_and_bit_identical():
    """The post-chunk SDC probe must pass on healthy hardware and leave
    the training stream bit-identical to a guard-off run."""
    from nic.cli.image_compression import load_asset
    from nic.config import CompressionConfig
    from nic.train.ntc import NTCTrainer

    res = {}
    for guard in (True, False):
        cfg = CompressionConfig(
            image_size=64, max_mip_level=6, crop_mip_level=5, num_epochs=300,
            qat_noise_where="node", sdc_guard_train=guard,
        )
        tr = NTCTrainer(cfg, load_asset(cfg))
        losses, _ = tr.train_many(128, chunk=64)
        res[guard] = np.asarray(losses)
    np.testing.assert_array_equal(res[True], res[False])


def test_in_train_sdc_guard_trips_on_injected_corruption():
    from nic.cli.image_compression import load_asset
    from nic.config import CompressionConfig
    from nic.obs.integrity import SDCError
    from nic.train.ntc import NTCTrainer

    cfg = CompressionConfig(
        image_size=64, max_mip_level=6, crop_mip_level=5, num_epochs=300,
        qat_noise_where="node", sdc_guard_train=True,
    )
    assert not CompressionConfig().sdc_guard_train  # opt-in
    tr = NTCTrainer(cfg, load_asset(cfg))

    class FlakyStep:
        """Simulates per-execution corruption: every call perturbs the
        loss output differently."""

        def __init__(self, fn):
            self.fn = fn
            self.calls = 0

        def __call__(self, *args):
            out = self.fn(*args)
            self.calls += 1
            return out[:4] + (out[4] + self.calls * 1e-6,) + out[5:]

    import jax

    real = jax.jit(tr._build_step(0, frozen=False, jit=False))
    tr._step_fns[("probe", 0, False)] = FlakyStep(real)
    with pytest.raises(SDCError):
        tr.train_many(64, chunk=64)
