"""Plot and image-grid artifacts (the port's own copy of
``downgan_tpu/utils/plots.py``; reference
``DoWnGAN/mlflow_tools/gen_grid_plots.py`` and the legacy ``gen_plots.py``).

numpy and matplotlib only (``torchvision.make_grid`` is a numpy tiler here).
matplotlib is imported at first use (:func:`pyplot`), so this module
imports where matplotlib is absent; :func:`have_matplotlib` says whether
the figures can be drawn. Figures go into a run's artifact directory:
every epoch to a fixed file name, every 10th epoch to a numbered one
(reference ``gen_grid_plots.py:42-58``).
"""
from __future__ import annotations

import importlib.util
import os
from typing import Optional

import numpy as np


def have_matplotlib() -> bool:
    """Whether matplotlib is importable here (the figures need it)."""
    return importlib.util.find_spec("matplotlib") is not None


def pyplot():
    """``matplotlib.pyplot`` on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def make_grid(
    images: np.ndarray, nrow: int = 8, padding: int = 2, pad_value: float = 0.0
) -> np.ndarray:
    """Tile (N, H, W) images into one 2-D grid array, ``nrow`` per row.

    numpy re-design of ``torchvision.utils.make_grid`` for single-channel
    fields (the reference grids channel 0 only, ``gen_grid_plots.py:27-39``).
    """
    n, h, w = images.shape
    ncol = int(np.ceil(n / nrow))
    grid = np.full(
        (ncol * (h + padding) + padding, nrow * (w + padding) + padding),
        pad_value,
        dtype=images.dtype,
    )
    for idx in range(n):
        r, c = divmod(idx, nrow)
        y = r * (h + padding) + padding
        x = c * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[idx]
    return grid


def grid_sample_indices(
    pool_size: int, n_samples: int = 20, seed: int = 0
) -> np.ndarray:
    """Fixed-seed random sample selection WITH replacement.

    Parity with the reference's selection (``gen_grid_plots.py:17-18``:
    ``torch.manual_seed(0); torch.randint(0, hp.batch_size, (20,))`` —
    randint samples with replacement, so ``n_samples`` can exceed the
    pool). Deterministic: the same (pool_size, seed) always selects the
    same indices, so successive epochs grid the same samples.
    """
    return np.random.default_rng(seed).integers(0, pool_size, size=n_samples)


def gen_grid_images(
    artifact_dir: str,
    coarse: np.ndarray,
    fake: np.ndarray,
    real: np.ndarray,
    epoch: int,
    train_or_test: str = "train",
    n_samples: int = 20,
    seed: int = 0,
    cmap: str = "viridis",
    select: bool = True,
) -> str:
    """Fixed-seed sample selection + 3-row coarse/fake/real figure.

    Parity with ``gen_grid_plots.py:9-61``: ``n_samples`` samples chosen
    with a fixed seed (with replacement — see :func:`grid_sample_indices`),
    channel 0 gridded per row, saved to ``<artifact_dir>/train_images.png``
    (fixed name, every epoch) and ``..._epoch_<N>.png`` every 10th epoch.
    Inputs are NHWC numpy arrays. ``select=False`` grids the rows as given
    (for callers that pre-selected, e.g. to regenerate fake only for the
    chosen samples the way the reference does, ``gen_grid_plots.py:19``).
    """
    if select:
        idx = grid_sample_indices(coarse.shape[0], n_samples, seed)
    else:
        idx = np.arange(coarse.shape[0])

    rows = {
        "Coarse": coarse[idx, :, :, 0],
        "Generated": fake[idx, :, :, 0],
        "Real": real[idx, :, :, 0],
    }
    n = len(idx)
    plt = pyplot()
    fig, axes = plt.subplots(3, 1, figsize=(16, 8))
    for ax, (title, imgs) in zip(axes, rows.items()):
        # 10 samples per grid row (reference layout, gen_grid_plots.py:23,28,33)
        ax.imshow(make_grid(np.asarray(imgs), nrow=min(n, 10)), cmap=cmap, origin="lower")
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()

    os.makedirs(artifact_dir, exist_ok=True)
    fixed = os.path.join(artifact_dir, f"{train_or_test}_images.png")
    fig.savefig(fixed, dpi=100)
    if epoch % 10 == 0:
        fig.savefig(
            os.path.join(artifact_dir, f"{train_or_test}_images_epoch_{epoch}.png"),
            dpi=100,
        )
    plt.close(fig)
    return fixed


def colorize(
    value: np.ndarray,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    cmap: str = "viridis",
) -> np.ndarray:
    """Map a 2-D field to RGBA uint8 via a colormap (parity with the legacy
    TensorBoard helper, ``mlflow_tools/gen_plots.py:7-40``)."""
    value = np.asarray(value, dtype=np.float32)
    vmin = float(np.min(value)) if vmin is None else vmin
    vmax = float(np.max(value)) if vmax is None else vmax
    span = (vmax - vmin) or 1.0
    norm = np.clip((value - vmin) / span, 0.0, 1.0)
    return (pyplot().get_cmap(cmap)(norm) * 255).astype(np.uint8)


def generate_comparison_plot(
    artifact_dir: str,
    fake: np.ndarray,
    real: np.ndarray,
    coarse: np.ndarray,
    low_pass_fake: Optional[np.ndarray] = None,
    epoch: int = 0,
    n_cols: int = 5,
    cmap: str = "viridis",
) -> str:
    """Per-sample comparison figure (parity with the legacy
    ``gen_plots.py:75-133`` 3x5 / 4x5 layout): rows = generated / real /
    coarse (+ optional low-pass of generated), columns = samples."""
    rows = [("Generated", fake), ("Real", real), ("Coarse", coarse)]
    if low_pass_fake is not None:
        rows.append(("Low-pass gen", low_pass_fake))
    n_cols = min(n_cols, fake.shape[0])
    plt = pyplot()
    fig, axes = plt.subplots(len(rows), n_cols, figsize=(3 * n_cols, 3 * len(rows)))
    axes = np.atleast_2d(axes)
    for r, (title, arr) in enumerate(rows):
        for c in range(n_cols):
            ax = axes[r, c]
            ax.imshow(arr[c, :, :, 0], cmap=cmap, origin="lower")
            ax.axis("off")
            if c == 0:
                ax.set_title(title, loc="left")
    fig.tight_layout()
    os.makedirs(artifact_dir, exist_ok=True)
    path = os.path.join(artifact_dir, f"comparison_epoch_{epoch}.png")
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path
