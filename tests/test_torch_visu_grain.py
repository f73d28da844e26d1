"""The port's plots, ball renderer and Grain dataflow against the JAX
package's (``rfnet_tpu/visu.py``, ``rfnet_tpu/data/grain_pipeline.py``), as
``tests/test_data_eval.py`` holds those."""

import importlib.util
import os

import numpy as np
import pytest

from rfnet_tpu import visu as jvisu
from rfnet_tpu.data.grain_pipeline import grain_dataflow as jgrain_dataflow
from rfnet_tpu_torch import visu
from rfnet_tpu_torch.data import native
from rfnet_tpu_torch.data.dataset import synthetic_pairs
from rfnet_tpu_torch.data.grain_pipeline import grain_dataflow


@pytest.fixture
def private_jax_renderer(tmp_path, monkeypatch):
    """The JAX package's renderer, built for this test alone: its
    ``_render_lib`` compiles to a path under ``~/.cache`` that every test
    process shares and loads whatever file it finds there, so HOME points
    into ``tmp_path`` and its load state is reset."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(jvisu, "_render_cache", [])
    assert jvisu._render_lib() is not None, "the JAX package's renderer did not build"


def test_visu_contract(tmp_path, rng):
    """File tree and pixel sanity of both reference plot contracts
    (visu_util.py:34-67 and :68-117) and of the combined grid; each plot
    writes the same files as the JAX package's."""
    pcds = [rng.rand(50, 3).astype(np.float32) * 0.4 - 0.2 for _ in range(2)]
    fn = os.path.join(tmp_path, "model.png")
    visu.plot_pcd_three_views(fn, pcds, ["input", "output"], "sup")
    folder = os.path.join(tmp_path, "model")
    assert sorted(os.listdir(folder)) == sorted(
        f"{t}_{i}.png" for t in ["input", "output"] for i in range(3))
    views = [open(os.path.join(folder, f"input_{i}.png"), "rb").read() for i in range(3)]
    assert all(len(v) > 1000 for v in views)
    assert views[0] != views[1] != views[2]

    colors = [np.zeros(50, np.float32), np.zeros(50, np.float32)]
    colors[0][:5] = -1.0  # highlight markers, drawn enlarged
    visu.plot_pcd_atten_views(os.path.join(tmp_path, "atten.png"), pcds, ["a", "b"],
                              colorlist=colors)
    jvisu.plot_pcd_atten_views(os.path.join(tmp_path, "jax_atten.png"), pcds, ["a", "b"],
                               colorlist=colors)
    assert sorted(os.listdir(tmp_path / "atten")) == sorted(os.listdir(tmp_path / "jax_atten")) \
        == sorted(f"{t}_{i}.png" for t in ["a", "b"] for i in range(3))

    for mod, name in ((visu, "combined"), (jvisu, "jax_combined")):
        mod.plot_pcd_three_views_combined(os.path.join(tmp_path, "grid", f"{name}.png"), pcds,
                                          ["input", "output"], "sup")
    port, jax = (open(tmp_path / "grid" / f"{n}.png", "rb").read()
                 for n in ("combined", "jax_combined"))
    assert len(port) > 1000 and len(port) == len(jax)


@pytest.mark.usefixtures("private_jax_renderer")
@pytest.mark.parametrize("native_path", [True, False])
def test_render_balls_equals_jax(rng, monkeypatch, native_path):
    """render_balls draws the JAX package's image pixel for pixel on the
    same points, on the native rasteriser and on the numpy z-buffer; the
    native one is built under rfnet_tpu_torch/_build/."""
    if not native_path:
        monkeypatch.setattr(visu, "_render_lib", lambda: None)
        monkeypatch.setattr(jvisu, "_render_cache", [None])
    else:
        lib = visu._render_lib()
        assert lib is not None and os.path.dirname(lib._name) == native.BUILD_DIR
    pts = rng.rand(500, 3)
    img = visu.render_balls(pts, image_size=128, radius=2)
    assert img.shape == (128, 128, 3) and img.dtype == np.uint8
    assert img.max() > 0  # something was drawn
    np.testing.assert_array_equal(img, jvisu.render_balls(pts, image_size=128, radius=2))
    col = rng.randint(0, 256, (500, 3))
    np.testing.assert_array_equal(
        visu.render_balls(pts, image_size=96, radius=5, colors=col, background=7),
        jvisu.render_balls(pts, image_size=96, radius=5, colors=col, background=7))


def test_render_balls_sphere_shading(monkeypatch):
    """Balls are shaded spheres (dz/r falloff + depth intensity,
    render_balls_so.cpp:18-29,49-52), not flat discs — and the native and
    numpy paths agree."""
    pts = np.array([[0.5, 0.5, 0.5]])
    col = np.array([[255, 255, 255]])
    assert visu._render_lib() is not None
    img_native = visu.render_balls(pts, image_size=64, radius=8, colors=col)
    monkeypatch.setattr(visu, "_render_lib", lambda: None)  # the numpy path
    img_np = visu.render_balls(pts, image_size=64, radius=8, colors=col)
    for img in (img_native, img_np):
        lit = img[..., 0][img[..., 0] > 0]
        assert lit.size and int(lit.min()) < int(lit.max()), "flat splat"
    np.testing.assert_allclose(img_native.astype(int), img_np.astype(int), atol=1)


def _needs_grain():
    if importlib.util.find_spec("grain") is None:
        pytest.skip("grain not installed")


def test_grain_pipeline_contract():
    """The grain-backed dataflow yields the batch contract."""
    _needs_grain()
    items = list(synthetic_pairs(8, 64, 128))
    gen = grain_dataflow(items, batch_size=4, input_size=32, gt_size=128, prefetch=16)
    ids, inputs, npts, gts = next(gen)
    assert inputs.shape == (4, 32, 3) and inputs.dtype == np.float32
    assert gts.shape == (4, 128, 3) and npts == 32 and len(ids) == 4


@pytest.mark.parametrize("is_training,shard_id", [(True, 0), (True, 1), (False, 1)])
def test_grain_pipeline_equals_jax(is_training, shard_id):
    """From the same items and seed the port's dataflow yields the JAX
    package's batches element for element: the shuffle, the shards and the
    resampling. (Both map in grain's reader threads and draw their padding
    from one shared RNG, so only clouds that need no padding give the same
    values run to run: the inputs are cut to their first points.)"""
    _needs_grain()
    items = list(synthetic_pairs(12, 64, 128, seed=3))
    kw = dict(batch_size=2, input_size=48, gt_size=128, is_training=is_training, seed=5,
              shard_id=shard_id, num_shards=2, prefetch=4)
    ours, theirs = grain_dataflow(items, **kw), jgrain_dataflow(items, **kw)
    for _ in range(5):  # past the 3 batches of a shard: the repeat
        a, b = next(ours), next(theirs)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2] == 48
        np.testing.assert_array_equal(a[3], b[3])
        assert a[1].dtype == a[3].dtype == np.float32
        want = {mid: (p[:48], g) for mid, p, g in items}
        for mid, inp, gt in zip(a[0], a[1], a[3]):
            np.testing.assert_array_equal(inp, want[str(mid)][0])
            np.testing.assert_array_equal(gt, want[str(mid)][1])
