"""Host data-layer kernels by ctypes (counterpart of
``downgan_tpu/data/native.py``): CF int16/int8 decode, NaN-skipping
moments, in-place standardization and block-mean coarsening.

``cfdecode.cpp`` beside this file is compiled with ``g++`` at first use
into ``build/torch_ext/`` at the repository root (the file name carries a
hash of the source and flags, so an edit rebuilds) and loaded with ctypes.
This is host code, not a device kernel: where no toolchain builds it,
every entry point runs a numpy version of the same arithmetic in the same
order (double sums taken sequentially, the same float32 roundings), so the
staged and streamed arrays have the same bits either way. ``-ffp-contract=off``
keeps the compiler from fusing a multiply and an add into one rounding.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).with_name("cfdecode.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_state: dict = {}  # "lib": the loaded library or None once a load was tried


def _build_and_load() -> Optional[ctypes.CDLL]:
    """Build ``cfdecode.cpp`` if this source has no build yet and load it;
    None where that fails (no ``g++``, a failed compile or load)."""
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        _state["lib"] = None
        digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"libcfdecode_{digest[:16]}.so"
        if not so.exists():
            # A private temporary name, renamed into place: processes that
            # build at once never load a half-written library.
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            try:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            except (OSError, subprocess.SubprocessError):
                return None
            finally:
                tmp.unlink(missing_ok=True)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        f32p, i16p, i8p = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_int16,
                                                        ctypes.c_int8))
        size, dbl = ctypes.c_size_t, ctypes.c_double
        lib.cf_unpack_i16.argtypes = [i16p, size, dbl, dbl, ctypes.c_int16, ctypes.c_int, f32p]
        lib.cf_unpack_i8.argtypes = [i8p, size, dbl, dbl, ctypes.c_int8, ctypes.c_int, f32p]
        lib.nan_moments.argtypes = [f32p, size, ctypes.POINTER(dbl), ctypes.POINTER(dbl),
                                    ctypes.POINTER(size)]
        lib.standardize_inplace.argtypes = [f32p, size, dbl, dbl]
        lib.block_mean_coarsen.argtypes = [f32p, size, size, size, size, f32p]
        for fn in (lib.cf_unpack_i16, lib.cf_unpack_i8, lib.nan_moments,
                   lib.standardize_inplace, lib.block_mean_coarsen):
            fn.restype = None
        _state["lib"] = lib
        return lib


def available() -> bool:
    return _build_and_load() is not None


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def cf_unpack(raw: np.ndarray, scale: float, offset: float, fill: Optional[int]) -> np.ndarray:
    """Unpack an int16/int8 CF payload to float32 (``raw * scale + offset``
    in float64, then rounded; fill -> NaN)."""
    lib = _build_and_load()
    if lib is None or raw.dtype not in (np.int16, np.int8):
        out = (raw.astype(np.float64) * float(scale) + float(offset)).astype(np.float32)
        if fill is not None:
            out = np.where(raw == fill, np.float32(np.nan), out).astype(np.float32)
        return out
    raw = np.ascontiguousarray(raw)
    out = np.empty(raw.shape, np.float32)
    fn, ctype = ((lib.cf_unpack_i16, ctypes.c_int16) if raw.dtype == np.int16
                 else (lib.cf_unpack_i8, ctypes.c_int8))
    fn(raw.ctypes.data_as(ctypes.POINTER(ctype)), raw.size, float(scale), float(offset),
       ctype(int(fill) if fill is not None else 0), 1 if fill is not None else 0, _f32(out))
    return out


def nan_moments(data: np.ndarray) -> Tuple[float, float, int]:
    """NaN-skipping (mean, std, count), population std as numpy's
    ``nanstd``. A float32 array takes two passes, each a sequential float64
    sum; other dtypes numpy's ``nanmean``/``nanstd``."""
    if data.dtype != np.float32:
        return float(np.nanmean(data)), float(np.nanstd(data)), int(np.sum(~np.isnan(data)))
    lib = _build_and_load()
    if lib is None:
        valid = np.asarray(data, np.float64).ravel()
        valid = valid[~np.isnan(valid)]
        if not valid.size:
            return float("nan"), float("nan"), 0
        mean = float(np.cumsum(valid)[-1]) / valid.size
        ss = float(np.cumsum(np.square(valid - mean))[-1])
        return mean, float(np.sqrt(ss / valid.size)), int(valid.size)
    data = np.ascontiguousarray(data)
    mean, std, count = ctypes.c_double(), ctypes.c_double(), ctypes.c_size_t()
    lib.nan_moments(_f32(data), data.size, ctypes.byref(mean), ctypes.byref(std),
                    ctypes.byref(count))
    return mean.value, std.value, int(count.value)


def standardize_inplace(data: np.ndarray, mean: float, std: float) -> np.ndarray:
    """``(x - float32(mean)) * float32(1 / std)`` in float32; in place on a
    C-contiguous float32 array with the library, else into a new array."""
    lib = _build_and_load()
    if lib is None or data.dtype != np.float32 or not data.flags.c_contiguous:
        return (np.asarray(data, np.float32) - np.float32(mean)) * np.float32(1.0 / float(std))
    lib.standardize_inplace(_f32(data), data.size, float(mean), 1.0 / float(std))
    return data


def block_mean_coarsen(data: np.ndarray, factor: int) -> np.ndarray:
    """(T, H, W) -> (T, H/f, W/f) float32 block means. A float32 field has
    each block summed row by row in float64, times 1/f**2, rounded."""
    t, h, w = data.shape
    if h % factor or w % factor:
        raise ValueError(f"spatial dims ({h},{w}) not divisible by {factor}")
    ho, wo = h // factor, w // factor
    if data.dtype != np.float32:
        return data.reshape(t, ho, factor, wo, factor).mean(axis=(2, 4)).astype(np.float32)
    lib = _build_and_load()
    if lib is None:
        blocks = np.asarray(data, np.float64).reshape(t, ho, factor, wo, factor)
        blocks = blocks.transpose(0, 1, 3, 2, 4).reshape(t, ho, wo, factor * factor)
        inv = 1.0 / float(factor * factor)
        return (np.cumsum(blocks, axis=-1)[..., -1] * inv).astype(np.float32)
    data = np.ascontiguousarray(data)
    out = np.empty((t, ho, wo), np.float32)
    lib.block_mean_coarsen(_f32(data), t, h, w, factor, _f32(out))
    return out
