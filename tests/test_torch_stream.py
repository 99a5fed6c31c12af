"""The port's disk-streaming tier (``downgan_tpu_torch/data/stream.py``) on
the CPU: ``LazyField`` against the JAX package's on the same preprocessed
files (unsorted and duplicate indices, scalars, CF-packed payloads), over a
``np.memmap`` of the same layout, ``StreamDataset``'s checks, training
straight off disk equal to device-resident training bit for bit, and
``cli train --stream`` with its refusals."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

from downgan_tpu_torch.cli.__main__ import main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset  # noqa: E402
from downgan_tpu_torch.data.netcdf import write_netcdf  # noqa: E402
from downgan_tpu_torch.data.staging import preprocessed_path, write_preprocessed  # noqa: E402
from downgan_tpu_torch.data.stream import LazyField, StreamDataset  # noqa: E402
from downgan_tpu_torch.training.trainer import Trainer  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401


def tiny_config(proc_dir) -> Config:
    return Config(coarse_size=8, fine_size=32, filters=8, num_res_blocks=1,
                  proc_data_dir=str(proc_dir), already_preprocessed=True,
                  hp=HyperParams(batch_size=4, metrics_to_calculate=("MAE", "MSE", "Wass"),
                                 fused_epoch=False))


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    """A synthetic set written through the preprocessed-NetCDF layout: 16
    training and 7 test samples (a test batch of 4 and a ragged tail of 3)."""
    config = tiny_config(tmp_path_factory.mktemp("proc"))
    coarse, fine = synthetic_dataset(n_samples=23, coarse_size=8, fine_size=32, seed=0)
    write_preprocessed(config, coarse[:16], fine[:16], coarse[16:], fine[16:])
    return config, coarse, fine


def test_lazy_field_random_access_matches_jax(preprocessed):
    from downgan_tpu.data.stream import LazyField as JaxLazyField

    config, coarse, fine = preprocessed
    with StreamDataset.from_preprocessed(config, "train") as ds:
        assert len(ds) == 16 and ds.coarse.shape == (16, 8, 8, 7) and ds.fine.shape == (16, 32, 32, 2)
        for field, kind, want in ((ds.coarse, "coarse", coarse), (ds.fine, "fine", fine)):
            ref = JaxLazyField(preprocessed_path(config, kind, "train"))
            sel = np.array([3, 1, 1, 11, 0])  # unsorted, with a duplicate
            np.testing.assert_array_equal(field[sel], ref[sel])
            np.testing.assert_array_equal(field[sel], want[sel])
            np.testing.assert_array_equal(field[7], ref[7])
            np.testing.assert_array_equal(field[np.int64(5)], ref[np.int64(5)])
            np.testing.assert_array_equal(np.asarray(field), np.asarray(ref))
            ref.close()
        with pytest.raises(TypeError, match="integers"):
            ds.coarse[np.array([0.5])]


def test_lazy_field_over_a_memmap_equals_the_packed_file(tmp_path):
    """The same int16 CF-packed ``(time, var, lat, lon)`` payload read from
    a NetCDF (h5py) and from a ``np.memmap`` with the same attributes."""
    rng = np.random.default_rng(3)
    packed = rng.integers(-30000, 30000, size=(6, 2, 4, 5)).astype(np.int16)
    packed[2, 1, 0, :2] = -32767
    attrs = {"scale_factor": np.float64(0.0123), "add_offset": np.float64(5.0),
             "_FillValue": np.int16(-32767)}
    path = tmp_path / "packed.nc"
    write_netcdf(str(path), variables={"data": packed},
                 dims={"data": ("time", "var", "lat", "lon")},
                 coords={"time": np.arange(6, dtype=np.float64)}, attrs={"data": attrs})
    raw = tmp_path / "packed.int16"
    packed.tofile(raw)
    on_disk = np.memmap(raw, dtype=np.int16, mode="r", shape=packed.shape)
    from_file, from_memmap = LazyField(str(path)), LazyField(on_disk, attrs=attrs)
    sel = np.array([4, 0, 2, 4])
    want = np.transpose(packed[sel] * 0.0123 + 5.0, (0, 2, 3, 1)).astype(np.float32)
    want[np.transpose(packed[sel], (0, 2, 3, 1)) == -32767] = np.nan
    np.testing.assert_array_equal(from_memmap[sel], from_file[sel])
    np.testing.assert_array_equal(from_memmap[sel], want)
    assert from_memmap.shape == (6, 4, 5, 2) and from_memmap[sel].dtype == np.float32
    from_file.close()
    with pytest.raises(ValueError, match="expected 4"):
        LazyField(np.zeros((6, 4, 5), np.int16))


def test_stream_dataset_validation(tmp_path, preprocessed):
    config, _, _ = preprocessed
    with pytest.raises(FileNotFoundError, match="prepare-data"):
        StreamDataset.from_preprocessed(tiny_config(tmp_path / "nowhere"), "train")
    with pytest.raises(ValueError, match="differ"):
        StreamDataset(preprocessed_path(config, "coarse", "train"),
                      preprocessed_path(config, "fine", "test"))


def test_stream_matches_device_trajectory(preprocessed):
    """Training straight off disk equals device-resident training bit for
    bit, the test pass's ragged tail included."""
    config, coarse, fine = preprocessed
    device = Trainer(config, DeviceDataset.from_numpy(coarse[:16], fine[:16], "cpu"),
                     DeviceDataset.from_numpy(coarse[16:], fine[16:], "cpu"), device="cpu",
                     print_every=100)
    device.train(epochs=2)
    with StreamDataset.from_preprocessed(config, "train") as train_ds, \
            StreamDataset.from_preprocessed(config, "test") as test_ds:
        streamed = Trainer(config, train_ds, test_ds, device="cpu", print_every=100)
        streamed.train(epochs=2)
    assert streamed.state.step == device.state.step == 8
    for part in ("generator", "critic"):
        a = getattr(device.state, part).state_dict()
        for k, v in getattr(streamed.state, part).state_dict().items():
            torch.testing.assert_close(v, a[k], rtol=0, atol=0)
    assert [r["train"] for r in streamed.history] == [r["train"] for r in device.history]
    assert [r["test"] for r in streamed.history] == [r["test"] for r in device.history]


def test_cli_train_stream(tmp_path, preprocessed, capsys):
    config, _, _ = preprocessed
    cfg = tmp_path / "cfg.json"
    cfg.write_text(config.to_json())
    trainer = main(["train", "--config", str(cfg), "--stream", "--epochs", "1",
                    "--device", "cpu", "--tracking-root", str(tmp_path / "exps")])
    assert isinstance(trainer.train_ds, StreamDataset) and len(trainer.train_ds) == 16
    assert trainer.history[0]["steps"] == 4 and "test" in trainer.history[0]
    for argv, match in ((["--stream", "--synthetic"], "no files to stream"),
                        (["--stream", "--host-feed"], "pick one")):
        with pytest.raises(SystemExit):
            main(["train", "--config", str(cfg), *argv, "--device", "cpu"])
        assert match in capsys.readouterr().err
