"""A private build of the JAX package's native ``.pcd`` codec, for the tests
that hold the port's ``read_pcd`` to the JAX package's."""

import pytest

from rfnet_tpu.data import native as jnative


@pytest.fixture
def private_jax_codec(tmp_path, monkeypatch):
    """The JAX package's codec, built for this test alone (one ``g++`` run).

    ``rfnet_tpu/data/native.py`` compiles straight to a path under
    ``~/.cache`` that every test process shares, and loads whatever file it
    finds there: a process that finds another's half-written library reads
    with the numpy parser instead, whose float64 parse of ascii differs from
    the codec's float32 read by up to 5e-8. With the library's path under
    ``tmp_path`` and the module's load state reset, the JAX ``read_pcd``
    takes its native codec whatever other processes do."""
    monkeypatch.setattr(jnative, "_SO", str(tmp_path / "jax_codec" / "libpcdcodec.so"))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.get_lib() is not None, "the JAX package's native codec did not build"
