"""Disk-streamed dataset: batches read lazily from preprocessed NetCDFs
(counterpart of ``downgan_tpu/data/stream.py``).

The third residency tier of the data layer: ``DeviceDataset`` keeps a
split on the device, :class:`~downgan_tpu_torch.data.feed.HostDataset` in
host RAM, and :class:`StreamDataset` leaves it on disk in the
preprocessed ``(time, var, lat, lon)`` files of
``staging.write_preprocessed``; only the batches that
:func:`~downgan_tpu_torch.data.feed.prefetch_batches` asks for are read and
CF-decoded, on its reader thread. ``StreamDataset`` has the
``HostDataset`` interface, so the trainer's host-fed loop runs it
unchanged, and training takes the same bits as from the device.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional, Tuple

import numpy as np

from downgan_tpu_torch.data.feed import HostDataset
from downgan_tpu_torch.data.netcdf import _decode_cf, _h5_attrs


class LazyField:
    """NHWC view of a preprocessed ``(time, var, lat, lon)`` variable, read
    lazily by time index.

    ``source`` is a file path (the variable ``var`` of that NetCDF, opened
    with h5py, its CF attributes read from the file) or any object with an
    h5py Dataset's ``shape`` and ``__getitem__`` (an ``h5py.Dataset``, or a
    ``np.memmap`` of the same layout), whose CF attributes (``scale_factor``,
    ``add_offset``, ``_FillValue``) are then ``attrs``.

    ``field[idx]`` takes an int or any integer index array, unsorted and
    with duplicates (h5py's fancy indexing needs sorted unique indices, so
    reads go through ``np.unique`` and its inverse). It returns float32
    NHWC, CF-decoded.
    """

    def __init__(self, source, var: str = "data",
                 attrs: Optional[Mapping[str, object]] = None):
        self._file = None
        if isinstance(source, (str, os.PathLike)):
            import h5py

            self.path = os.fspath(source)
            self._file = h5py.File(self.path, "r")
            source = self._file[var]
            attrs = _h5_attrs(source)
        else:
            self.path = f"<{type(source).__name__}>"
        self._ds = source
        self._attrs = dict(attrs or {})
        if len(self._ds.shape) != 4:
            raise ValueError(
                f"{self.path}:{var} has {len(self._ds.shape)} dims, expected 4 "
                "(time, var, lat, lon) — the write_preprocessed layout")
        t, v, h, w = self._ds.shape
        self.shape: Tuple[int, int, int, int] = (t, h, w, v)

    def __len__(self) -> int:
        return int(self.shape[0])

    def __getitem__(self, idx) -> np.ndarray:
        scalar = np.isscalar(idx) or (isinstance(idx, np.ndarray) and idx.ndim == 0)
        sel = np.atleast_1d(np.asarray(idx))
        if sel.dtype.kind not in "iu":
            raise TypeError(f"LazyField indices must be integers, got {sel.dtype}")
        uniq, inv = np.unique(sel, return_inverse=True)
        raw = self._ds[uniq] if uniq.size > 1 else self._ds[int(uniq[0])][None]
        data = _decode_cf(np.asarray(raw), self._attrs)
        out = np.ascontiguousarray(
            np.transpose(data[inv.reshape(sel.shape)], (0, 2, 3, 1)), dtype=np.float32)
        return out[0] if scalar else out

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        """Every sample, in one sequential pass."""
        out = self[np.arange(len(self))]
        return out if dtype is None else out.astype(dtype, copy=False)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()


class StreamDataset(HostDataset):
    """Paired (coarse, fine) :class:`LazyField`s over a preprocessed file
    pair (paths) or over two given fields. The :class:`HostDataset`
    interface; only batches are materialized."""

    def __init__(self, coarse, fine):
        self.coarse = coarse if isinstance(coarse, LazyField) else LazyField(coarse)
        self.fine = fine if isinstance(fine, LazyField) else LazyField(fine)
        if len(self.coarse) != len(self.fine):
            raise ValueError(
                f"coarse/fine sample counts differ: {len(self.coarse)} "
                f"({self.coarse.path}) vs {len(self.fine)} ({self.fine.path})")

    @classmethod
    def from_preprocessed(cls, config, split: str) -> "StreamDataset":
        """Open the ``<kind>_<split>_<region>.nc`` pair written by
        ``staging.write_preprocessed`` / the ``prepare-data`` CLI."""
        from downgan_tpu_torch.data.staging import preprocessed_path

        coarse = preprocessed_path(config, "coarse", split)
        fine = preprocessed_path(config, "fine", split)
        for p in (coarse, fine):
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"preprocessed file not found: {p} — run `python -m "
                    "downgan_tpu_torch.cli prepare-data` first (streaming reads "
                    "the preprocessed layout only)")
        return cls(coarse, fine)

    def close(self) -> None:
        self.coarse.close()
        self.fine.close()

    def __enter__(self) -> "StreamDataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
