"""TensorBoard metric and image sink (the port's own copy of
``downgan_tpu/tracking/tensorboard.py``; reference
``DoWnGAN/mlflow_tools/gen_plots.py:43-72`` ``plot_to_tensorboard``).

It writes through ``tensorboardX`` only, imported when a sink is made;
without it every call does nothing. It logs beside the filesystem tracker,
not instead of it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def fig_to_array(fig) -> np.ndarray:
    """Rasterize a matplotlib figure to (3, H, W) uint8 (the CHW layout of
    TensorBoard's image API, reference ``gen_plots.py:43-72``)."""
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    return np.transpose(buf, (2, 0, 1))


class TensorBoardSink:
    """Epoch-metric and image writer; does nothing without tensorboardX."""

    def __init__(self, logdir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._writer = None
        else:
            self._writer = SummaryWriter(logdir)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if self._writer is None:
            return
        for key, value in metrics.items():
            self._writer.add_scalar(key, float(value), step)

    def log_figure(self, tag: str, fig, step: int) -> None:
        if self._writer is None:
            return
        self._writer.add_image(tag, fig_to_array(fig), step)

    def log_image_array(self, tag: str, chw: np.ndarray, step: int) -> None:
        if self._writer is None:
            return
        self._writer.add_image(tag, chw, step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
