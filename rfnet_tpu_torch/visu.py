"""Matplotlib point-cloud renders — a copy of the JAX package's
``plot_pcd_three_views`` (``rfnet_tpu/visu.py``).

The reference contract: a FOLDER named after the file stem holding one PNG
per (title, view), ``<title>_<i>.png`` for views i=0..2 at elevation 30 and
azimuths −45/45/135, cmap ``inferno``, point size 5, colour = x coordinate.
matplotlib is imported only when a plot is drawn.
"""

from __future__ import annotations

import os

import numpy as np


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
