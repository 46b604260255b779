"""Analysis scatter plots (counterpart of vae_segmentation_tpu/obs/draw.py;
reference utils/draw.py:10-82): pseudo-loss against recon-loss per case,
saved to figure/analysis_figure/<title>.jpg, driven by
--analysis_figure_name (main_target.py:956-995).

matplotlib is loaded, with the Agg backend, only when a figure is drawn;
``require_matplotlib`` lets a CLI fail at start-up when it is missing."""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

FIGURE_DIR = os.path.join("figure", "analysis_figure")


def require_matplotlib() -> None:
    """Raise ImportError now when matplotlib cannot be loaded."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError("--analysis_figure_name draws its figures with "
                          "matplotlib, which is not installed") from e


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _fit_line(x: Sequence[float], y: Sequence[float]):
    a, b = np.polyfit(np.asarray(x), np.asarray(y), 1)
    return float(a), float(b)


def _save(plt, title: str) -> str:
    os.makedirs(FIGURE_DIR, exist_ok=True)
    path = os.path.join(FIGURE_DIR, f"{title}.jpg")
    plt.savefig(path)
    plt.close()
    return path


def scatter_plot(data: Dict, title=None, x_label="x_label", y_label="y_label",
                 color_point="red") -> str:
    plt = _pyplot()
    plt.figure()
    xs = [v[0] for v in data.values()]
    ys = [v[1] for v in data.values()]
    plt.scatter(xs, ys, 25, color_point)
    if len(xs) >= 2:
        _fit_line(xs, ys)  # fit computed as in the reference; line not drawn
    plt.title(title)
    plt.xlabel(x_label)
    plt.ylabel(y_label)
    plt.xlim(0.0, 1.0)
    plt.ylim(0.0, 1.0)
    return _save(plt, title)


def scatter_plot_multi(data1: Dict, data2: Dict, title=None,
                       x_label="x_label", y_label="y_label",
                       color1="red", color2="blue") -> str:
    plt = _pyplot()
    plt.figure()
    xs = [v[0] for v in data1.values()]
    ys = [v[1] for v in data1.values()]
    plt.scatter(xs, ys, 25, color1)
    if len(xs) >= 2:
        a, b = _fit_line(xs, ys)
        x1 = np.arange(0, 1, 0.005)
        plt.plot(x1, a * x1 + b, color1)
    xs = [v[0] for v in data2.values()]
    ys = [v[1] for v in data2.values()]
    plt.scatter(xs, ys, 25, color2)
    if len(xs) >= 2:
        _fit_line(xs, ys)
    plt.title(title)
    plt.xlabel(x_label)
    plt.ylabel(y_label)
    plt.xlim(0.0, 1.0)
    plt.ylim(0.0, 1.0)
    return _save(plt, title)
