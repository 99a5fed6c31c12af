"""NetCDF4 (HDF5-backed) reading/writing via h5py — no netCDF4/xarray. The
port's own copy of ``downgan_tpu/data/netcdf.py``; ``h5py`` is imported
where a file is opened, never when this module is imported, so the rest of
the port runs where ``h5py`` is absent.

The reference reads its climate data with xarray/netCDF4
(``DoWnGAN/helpers/gen_experiment_datasets.py:79-84``). Neither is in this
environment; NetCDF4 files *are* HDF5 files, so this module implements the
subset of the format the workload needs directly on h5py:

  * variable read with CF packed-data decoding (``scale_factor`` /
    ``add_offset`` over int16/int8 payloads + ``_FillValue``/``missing_value``
    masking) — the reference's ERA fixture is int16-packed (SURVEY §7);
  * dimension discovery via HDF5 dimension scales (the netCDF4 convention);
  * a writer that produces netCDF4-compatible HDF5 (dimension scales +
    CF attributes) for the preprocessed train/test files
    (parity with ``helpers/gen_train_test_netcdfs.py:20-26``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Variable:
    name: str
    data: np.ndarray
    dims: List[str]
    attrs: Dict[str, object]


def _decode_cf(raw: np.ndarray, attrs: Dict[str, object]) -> np.ndarray:
    """Apply CF unpacking: out = raw * scale_factor + add_offset, with
    fill/missing values mapped to NaN."""
    scale = attrs.get("scale_factor")
    offset = attrs.get("add_offset")
    fill = attrs.get("_FillValue", attrs.get("missing_value"))

    if scale is None and offset is None and fill is None:
        return raw

    # Fast path: the common ERA packing (int16/int8 payload, scalar attrs)
    # decodes through the native C++ kernel (data/native.py; numpy fallback
    # inside).
    if raw.dtype in (np.int16, np.int8):
        fill_s = np.asarray(fill).ravel() if fill is not None else None
        if fill_s is None or fill_s.size == 1:
            from downgan_tpu_torch.data import native

            return native.cf_unpack(
                raw,
                float(np.asarray(scale).ravel()[0]) if scale is not None else 1.0,
                float(np.asarray(offset).ravel()[0]) if offset is not None else 0.0,
                int(fill_s[0]) if fill_s is not None else None,
            )

    out = raw.astype(np.float64 if raw.dtype.kind in "iu" else raw.dtype)
    if fill is not None:
        fill_arr = np.asarray(fill).ravel()
        mask = np.isin(raw, fill_arr)
    else:
        mask = None
    if scale is not None:
        out = out * np.asarray(scale).ravel()[0]
    if offset is not None:
        out = out + np.asarray(offset).ravel()[0]
    if mask is not None and mask.any():
        out = out.astype(np.float64)
        out[mask] = np.nan
    return out


def _h5_attrs(obj) -> Dict[str, object]:
    """An h5py object's attributes, bytes decoded to str."""
    out: Dict[str, object] = {}
    for k, v in obj.attrs.items():
        if isinstance(v, bytes):
            v = v.decode("utf-8", "replace")
        out[k] = v
    return out


def _dims_of(ds) -> List[str]:
    dims: List[str] = []
    for i, dim in enumerate(ds.dims):
        if len(dim) > 0 and dim[0].name:
            dims.append(dim[0].name.rsplit("/", 1)[-1])
        else:
            label = ds.dims[i].label
            dims.append(label if label else f"dim_{i}")
    return dims


class NetCDFFile:
    """Read-only view of a NetCDF4/HDF5 file."""

    def __init__(self, path: str):
        import h5py

        self.path = path
        self._f = h5py.File(path, "r")

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "NetCDFFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def variable_names(self) -> List[str]:
        """Data variables: datasets that are not pure dimension scales."""
        import h5py

        names = []
        for name, item in self._f.items():
            if not isinstance(item, h5py.Dataset):
                continue
            if item.attrs.get("CLASS", b"") == b"DIMENSION_SCALE":
                continue
            names.append(name)
        return names

    @property
    def coordinate_names(self) -> List[str]:
        import h5py

        return [
            name
            for name, item in self._f.items()
            if isinstance(item, h5py.Dataset)
            and item.attrs.get("CLASS", b"") == b"DIMENSION_SCALE"
        ]

    def variable(self, name: str, sel: Optional[tuple] = None) -> Variable:
        ds = self._f[name]
        raw = ds[sel] if sel is not None else ds[()]
        attrs = _h5_attrs(ds)
        data = _decode_cf(raw, attrs)
        return Variable(name=name, data=data, dims=_dims_of(ds), attrs=attrs)

    def coord(self, name: str) -> np.ndarray:
        return np.asarray(self._f[name][()])


def read_variable(path: str, name: str, sel: Optional[tuple] = None) -> Variable:
    with NetCDFFile(path) as f:
        return f.variable(name, sel)


class NetCDFStreamWriter:
    """Incremental netCDF4-compatible writer: create the full-size file
    once, assign slabs as they are generated, close. Host memory stays at
    one slab regardless of series length (the in-memory ``write_netcdf``
    needs the whole array; the reference's ``gen_fake_ds.py:156-162`` also
    materializes every generated chunk before its one ``to_netcdf``).

    ``var_shapes``: name -> full dataset shape (created empty, ``f4``);
    ``dims``/``coords``/``attrs``/``chunks`` as in :func:`write_netcdf`.
    Use as a context manager; ``write(name, index, arr)`` assigns any
    h5py-style index (an int, slice, or tuple of them).
    """

    def __init__(
        self,
        path: str,
        var_shapes: Dict[str, tuple],
        dims: Dict[str, Sequence[str]],
        coords: Optional[Dict[str, np.ndarray]] = None,
        attrs: Optional[Dict[str, Dict[str, object]]] = None,
        chunks: Optional[Dict[str, tuple]] = None,
    ):
        import h5py

        self._f = h5py.File(path, "w")
        scales: Dict[str, h5py.Dataset] = {}
        for dim_name, values in (coords or {}).items():
            d = self._f.create_dataset(dim_name, data=np.asarray(values))
            d.make_scale(dim_name)
            d.attrs["_Netcdf4Coordvar"] = np.int32(1)
            scales[dim_name] = d
        self._vars: Dict[str, h5py.Dataset] = {}
        for name, shape in var_shapes.items():
            d = self._f.create_dataset(
                name, shape=shape, dtype="f4",
                chunks=(chunks or {}).get(name))
            for i, dim_name in enumerate(dims[name]):
                if dim_name in scales:
                    d.dims[i].attach_scale(scales[dim_name])
                d.dims[i].label = dim_name
            for k, v in ((attrs or {}).get(name) or {}).items():
                d.attrs[k] = v
            self._vars[name] = d

    def write(self, name: str, index, arr: np.ndarray) -> None:
        self._vars[name][index] = np.asarray(arr, np.float32)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "NetCDFStreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_netcdf(
    path: str,
    variables: Dict[str, np.ndarray],
    dims: Dict[str, Sequence[str]],
    coords: Optional[Dict[str, np.ndarray]] = None,
    attrs: Optional[Dict[str, Dict[str, object]]] = None,
    chunks: Optional[Dict[str, tuple]] = None,
) -> None:
    """Write a netCDF4-compatible HDF5 file.

    variables: name -> array; dims: name -> dim-name tuple per variable;
    coords: dim name -> 1-D coordinate array (written as dimension scales).
    """
    import h5py

    coords = coords or {}
    attrs = attrs or {}
    chunks = chunks or {}
    with h5py.File(path, "w") as f:
        scales: Dict[str, h5py.Dataset] = {}
        for dim_name, values in coords.items():
            d = f.create_dataset(dim_name, data=np.asarray(values))
            d.make_scale(dim_name)
            d.attrs["_Netcdf4Coordvar"] = np.int32(1)
            scales[dim_name] = d
        for var_name, arr in variables.items():
            var_dims = dims[var_name]
            d = f.create_dataset(
                var_name, data=np.asarray(arr), chunks=chunks.get(var_name)
            )
            for i, dim_name in enumerate(var_dims):
                if dim_name in scales:
                    d.dims[i].attach_scale(scales[dim_name])
                d.dims[i].label = dim_name
            for k, v in attrs.get(var_name, {}).items():
                d.attrs[k] = v
