"""Backend names: 'auto' is the host tier on every platform (the device path
won end to end at no canvas size measured on an H100); explicit names and
the 'tpu' alias pass through."""

import jax
import numpy as np
import pytest

from image_stitch_tpu import concat_to_buffer
from image_stitch_tpu.ops import backend as B
from image_stitch_tpu.utils.observability import COUNTERS


def _no_backend_query(monkeypatch):
    def boom():
        raise AssertionError("asked JAX for its backend")

    monkeypatch.setattr(jax, "default_backend", boom)


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_auto_is_host_tier_on_any_platform(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert B.resolve_backend_name("auto") == "numpy"


def test_auto_never_asks_jax(monkeypatch):
    _no_backend_query(monkeypatch)
    assert B.resolve_backend_name("auto") == "numpy"


def test_auto_on_the_cpu_test_platform_is_host():
    assert B.resolve_backend_name("auto") == "numpy"


@pytest.mark.parametrize(
    "name,expected",
    [("numpy", "numpy"), ("oracle", "numpy"), ("auto", "numpy"),
     ("jax", "jax"), ("tpu", "jax")],
)
def test_explicit_names_resolve(monkeypatch, name, expected):
    _no_backend_query(monkeypatch)
    assert B.resolve_backend_name(name) == expected


@pytest.mark.parametrize("name", ["cuda", "gpu", ""])
def test_unknown_backend_name_rejected(name):
    with pytest.raises(ValueError):
        B.get_backend(name)


def test_get_backend_numpy_is_host_tier():
    assert B.get_backend("numpy").name == "numpy"
    assert B.get_backend("auto") is B.get_backend("numpy")


def test_get_backend_tpu_alias_is_the_device_backend():
    assert B.get_backend("tpu") is B.get_backend("jax")


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_auto_runs_no_device_program(fmt):
    """The default backend stitches on the host tier: no device counter
    moves, and the bytes equal backend='numpy'."""
    rng = np.random.default_rng(3)
    tiles = [rng.integers(0, 256, (32, 40, 4), dtype=np.uint8) for _ in range(4)]
    opts = {"inputs": tiles, "layout": {"columns": 2}, "outputFormat": fmt}
    before = dict(COUNTERS)
    out = concat_to_buffer(opts)
    moved = {k for k, v in COUNTERS.items() if v != before.get(k, 0)}
    assert not {k for k in moved if k.startswith("device_")}
    assert out == concat_to_buffer({**opts, "backend": "numpy"})
