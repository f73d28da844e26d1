"""Point-cloud renders — copies of the JAX package's ``rfnet_tpu/visu.py``.

* ``plot_pcd_three_views`` is the reference contract (`visu_util.py:34-67`):
  a FOLDER named after the file stem holding one PNG per (title, view),
  ``<title>_<i>.png`` for views i=0..2 at elevation 30 and azimuths
  −45/45/135, cmap ``inferno``, point size 5, colour = x coordinate;
* ``plot_pcd_atten_views`` (`visu_util.py:68-117`) takes a per-point colour
  list; points whose colour equals −1.0 are markers, drawn enlarged (s=50,
  alpha=1) over the s=20/alpha=0.5 base scatter;
* ``plot_pcd_three_views_combined`` is the single-figure grid the JAX
  package keeps as an extra;
* ``render_balls`` is the z-buffered sphere-sprite rasteriser of the
  reference's ``render_balls_so.cpp``, without matplotlib: the C++ source
  ``native/render_balls.cpp`` built with ``g++`` at first use into
  ``rfnet_tpu_torch/_build/`` (``data.native.build_shared``), else a numpy
  z-buffer with the same arithmetic.

matplotlib is imported only when a plot is drawn.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

from rfnet_tpu_torch.data import native

RENDER_SOURCE = os.path.join(os.path.dirname(native.SOURCE), "render_balls.cpp")


def _folder_for(filename: str) -> str:
    # the reference derives the folder as filename.split('.')[0]
    folder = filename.split(".")[0]
    os.makedirs(folder, exist_ok=True)
    return folder


def plot_pcd_three_views(
    filename: str,
    pcds,
    titles,
    suptitle: str = "",
    sizes=None,
    cmap: str = "inferno",
    zdir: str = "y",
    xlim=(-0.3, 0.3),
    ylim=(-0.3, 0.3),
    zlim=(-0.3, 0.3),
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # the reference overrides the sizes argument to 5
    sizes = [5 for _ in pcds]
    folder = _folder_for(filename)
    for i in range(3):
        elev, azim = 30, -45 + 90 * i
        for j, (pcd, size) in enumerate(zip(pcds, sizes)):
            pcd = np.asarray(pcd)
            fig = plt.figure()
            out = os.path.join(folder, "%s_%s.png" % (titles[j], str(i)))
            ax = fig.add_subplot(projection="3d")
            ax.view_init(elev, azim)
            ax.scatter(
                pcd[:, 0], pcd[:, 1], pcd[:, 2], zdir=zdir, c=pcd[:, 0], s=size,
                cmap=cmap, vmin=-1, vmax=0.5,
            )
            ax.set_axis_off()
            ax.set_xlim(xlim)
            ax.set_ylim(ylim)
            ax.set_zlim(zlim)
            plt.subplots_adjust(left=0.0, right=1.0, bottom=0.0, top=1.0, wspace=0.0, hspace=0.0)
            plt.suptitle(suptitle)
            fig.savefig(out)
            plt.close(fig)


def plot_pcd_three_views_combined(
    filename: str,
    pcds,
    titles,
    suptitle: str = "",
    sizes=None,
    cmap: str = "inferno",
    zdir: str = "y",
    xlim=(-0.3, 0.3),
    ylim=(-0.3, 0.3),
    zlim=(-0.3, 0.3),
):
    """One figure with a 3×len(pcds) grid, written to ``filename`` (the
    shape of the reference's commented-out variant, `visu_util.py:8-33`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if sizes is None:
        sizes = [0.5 for _ in pcds]
    fig = plt.figure(figsize=(len(pcds) * 3, 9))
    elev = 30
    for i in range(3):
        azim = -45 + 90 * i
        for j, (pcd, size) in enumerate(zip(pcds, sizes)):
            pcd = np.asarray(pcd)
            ax = fig.add_subplot(3, len(pcds), i * len(pcds) + j + 1, projection="3d")
            ax.view_init(elev, azim)
            ax.scatter(
                pcd[:, 0], pcd[:, 1], pcd[:, 2], zdir=zdir, c=pcd[:, 0], s=size,
                cmap=cmap, vmin=-1, vmax=0.5,
            )
            ax.set_title(titles[j])
            ax.set_axis_off()
            ax.set_xlim(xlim)
            ax.set_ylim(ylim)
            ax.set_zlim(zlim)
    plt.subplots_adjust(left=0.05, right=0.95, bottom=0.05, top=0.9, wspace=0.1, hspace=0.1)
    plt.suptitle(suptitle)
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    fig.savefig(filename)
    plt.close(fig)


def render_balls(
    points: np.ndarray,
    image_size: int = 512,
    radius: int = 3,
    colors: np.ndarray | None = None,
    background: int = 0,
) -> np.ndarray:
    """Z-buffered point-sprite render (the reference's
    ``render_balls_so.cpp``): an (H, W, 3) uint8 image.

    Runs the native rasteriser where it builds, else the numpy z-buffer."""
    pts = np.asarray(points, np.float64)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    scale = (image_size * 0.8) / max(float((hi - lo).max()), 1e-9)
    xy = ((pts[:, :2] - lo[:2]) * scale + image_size * 0.1).astype(np.int32)
    z = ((pts[:, 2] - lo[2]) * scale * 1000).astype(np.int32)
    if colors is None:
        t = (pts[:, 0] - lo[0]) / max(float(hi[0] - lo[0]), 1e-9)
        colors = np.stack([255 * t, 80 + 0 * t, 255 * (1 - t)], axis=1)
    colors = np.asarray(colors, np.int32)
    img = np.full((image_size, image_size, 3), background, np.uint8)

    lib = _render_lib()
    if lib is not None:
        xyzs = np.ascontiguousarray(np.stack([xy[:, 0], xy[:, 1], z], axis=1), np.int32)
        c0, c1, c2 = (np.ascontiguousarray(colors[:, k]) for k in range(3))
        lib.render_ball(image_size, image_size, img.ctypes.data, len(pts), xyzs.ctypes.data,
                        c0.ctypes.data, c1.ctypes.data, c2.ctypes.data, radius)
        return img

    # the numpy path: the native path's sphere-sprite arithmetic — per-pixel
    # depth z + dz with dz = √(r²−dx²−dy²), colour scaled by (dz/r) and the
    # global depth-range intensity (render_balls_so.cpp:18-29,49-52)
    r = max(radius, 1)
    dx, dy = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1), indexing="ij")
    disc = dx * dx + dy * dy < r * r
    dxs, dys = dx[disc], dy[disc]
    dzs = np.sqrt(r * r - dxs * dxs - dys * dys)
    shade = dzs / r
    dzi = dzs.astype(np.int64)
    zmin, zmax = float(z.min() - r), float(z.max() + r)
    zrange = max(zmax - zmin, 1e-9)
    depth = np.full((image_size, image_size), -(2**31), np.int64)
    for i in range(len(pts)):
        px, py, pz = xy[i, 0] + dxs, xy[i, 1] + dys, z[i] + dzi
        ok = (px >= 0) & (px < image_size) & (py >= 0) & (py < image_size)
        px, py, pz, sh = px[ok], py[ok], pz[ok], shade[ok]
        upd = pz > depth[px, py]
        px, py, pz, sh = px[upd], py[upd], pz[upd], sh[upd]
        depth[px, py] = pz
        intensity = np.minimum(1.0, (pz - zmin) / zrange * 0.7 + 0.3)
        img[px, py] = np.clip(colors[i][None, :] * (sh * intensity)[:, None], 0, 255).astype(
            np.uint8)
    return img


_render_lock = threading.Lock()
_render: list = []  # the loaded rasteriser (or None), once tried


def _render_lib() -> ctypes.CDLL | None:
    """The native rasteriser, built at first call; None where it could not
    be built or loaded (reported once on stderr)."""
    with _render_lock:
        if not _render:
            lib = None
            try:
                lib = ctypes.CDLL(native.build_shared(RENDER_SOURCE, "renderballs"))
                lib.render_ball.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                lib.render_ball.restype = None
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as exc:
                print(f"rfnet_tpu_torch: the native ball renderer is unavailable, rendering "
                      f"with numpy ({exc})", file=sys.stderr)
            _render.append(lib)
        return _render[0]


def plot_pcd_atten_views(
    filename: str,
    pcds,
    titles,
    colorlist=None,
    sizes=None,
    cmap: str = "inferno",
    zdir: str = "y",
    xlim=(-0.3, 0.3),
    ylim=(-0.3, 0.3),
    zlim=(-0.3, 0.3),
):
    """Per-point-coloured views (`visu_util.py:68-117`): one PNG per
    (title, view) in a folder named after the file stem; colour comes from
    ``colorlist[j]`` (default: the x coordinate); points whose colour is
    exactly −1.0 are markers, drawn enlarged at s=50/alpha=1 on top of the
    s=20/alpha=0.5 base scatter."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    folder = _folder_for(filename)
    for i in range(3):
        elev, azim = 30, -45 + 90 * i
        for j, pcd in enumerate(pcds):
            pcd = np.asarray(pcd)
            color = pcd[:, 0] if colorlist is None else np.asarray(colorlist[j]).reshape(-1)
            idx = color == -1.0
            pt_sizes = np.ones_like(color, dtype=np.float64) * 20
            pt_sizes[idx] = 50
            fig = plt.figure()
            out = os.path.join(folder, "%s_%s.png" % (titles[j], str(i)))
            ax = fig.add_subplot(projection="3d")
            ax.view_init(elev, azim)
            ax.scatter(
                pcd[:, 0], pcd[:, 1], pcd[:, 2], zdir=zdir, c=color,
                s=pt_sizes, cmap=cmap, vmin=-1.0, vmax=0.5, alpha=0.5,
            )
            ax.scatter(
                pcd[idx, 0], pcd[idx, 1], pcd[idx, 2], zdir=zdir,
                c=-1 * np.ones_like(pcd[idx, 0]), s=50, cmap=cmap,
                vmin=-1.0, vmax=0.5, alpha=1,
            )
            ax.set_axis_off()
            ax.set_xlim(xlim)
            ax.set_ylim(ylim)
            ax.set_zlim(zlim)
            plt.subplots_adjust(left=0.0, right=1.0, bottom=0.0, top=1.0, wspace=0.0, hspace=0.0)
            fig.savefig(out)
            plt.close(fig)
