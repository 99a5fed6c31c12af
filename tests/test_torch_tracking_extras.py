"""The port's tracking extras held against the JAX package's on the CPU:
the grid figures of the trainer (``training/trainer.py::grid_rows``,
``utils/plots.py``), the TensorBoard sink, the MLflow FileStore export and
live mirror (``tracking/mlflow_export.py``, ``Run.attach_sink``), the
tracking UI server (``tracking/server.py``) and the interactive experiment
picker. Tolerance: the grid's fake against the flax generator's forward on
the same weights, 2e-5 absolute and 1e-5 relative (the two packages' fp32
convolutions round differently); everything else is compared exactly."""
import builtins
import contextlib
import io
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from downgan_tpu_torch.cli.__main__ import main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset  # noqa: E402
from downgan_tpu_torch.tracking import TrackingStore, define_experiment, write_tags  # noqa: E402
from downgan_tpu_torch.training import trainer as trainer_module  # noqa: E402
from downgan_tpu_torch.training.trainer import Trainer, grid_rows  # noqa: E402
from downgan_tpu_torch.utils import plots  # noqa: E402

from _torch_parity import flax_generator, one_thread  # noqa: E402,F401

ATOL, RTOL = 2e-5, 1e-5
KW = dict(filters=8, num_res_blocks=1, coarse_size=8, fine_size=64)
METRICS = ("MAE", "MSE", "Wass")


def tiny_config(**hp):
    return Config(hp=HyperParams(**{"batch_size": 2, "metrics_to_calculate": METRICS, **hp}), **KW)


def tiny_sets(cfg, n=12):
    coarse, fine = synthetic_dataset(n_samples=n, coarse_size=cfg.coarse_size,
                                     fine_size=cfg.fine_size, n_covariates=cfg.n_covariates,
                                     n_predictands=cfg.n_predictands, seed=cfg.seed)
    return coarse, fine


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cli train`` for 2 epochs with --tensorboard and --mlflow-dir."""
    d = tmp_path_factory.mktemp("trained")
    (d / "tiny.json").write_text(tiny_config().to_json())
    trainer = main(["train", "--config", str(d / "tiny.json"), "--synthetic", "--samples", "12",
                    "--epochs", "2", "--device", "cpu", "--tracking-root", str(d / "exps"),
                    "--tensorboard", "--mlflow-dir", str(d / "mlruns")])
    return trainer, d


def tree(root):
    """Relative path -> bytes of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


# -- grid figures -------------------------------------------------------------

@pytest.mark.parametrize("pool,seed", [(1, 0), (7, 0), (144, 0), (144, 3)])
def test_grid_sample_indices_equal_jax(pool, seed):
    from downgan_tpu.utils.plots import grid_sample_indices

    got = plots.grid_sample_indices(pool, 20, seed)
    assert np.array_equal(got, grid_sample_indices(pool, 20, seed)) and len(got) == 20


def test_grid_rows_match_the_jax_trainer_s(tmp_path):
    """The JAX trainer's _plot_split on the same weights and set: the same
    20 samples, the fake within ATOL/RTOL of the flax generator's."""
    import jax.numpy as jnp

    from downgan_tpu.config.config import Config as JConfig
    from downgan_tpu_torch.training.state import load_generator
    from downgan_tpu_torch.utils.port_weights import generator_state_dict_from_flax

    cfg = tiny_config()
    jcfg = JConfig.from_json(cfg.to_json())
    jgen, params = flax_generator(jcfg, cfg)
    gen = load_generator(cfg, generator_state_dict_from_flax(params, 1), "cpu")
    coarse, fine = tiny_sets(cfg, 30)
    got = grid_rows(cfg, gen, DeviceDataset.from_numpy(coarse, fine, "cpu"))
    idx = plots.grid_sample_indices(30, 20)
    want_fake = np.asarray(jgen.apply(params, jnp.asarray(coarse[idx])))
    assert np.array_equal(got[0], coarse[idx]) and np.array_equal(got[2], fine[idx])
    np.testing.assert_allclose(got[1], want_fake, atol=ATOL, rtol=RTOL)
    # a host-RAM set gives the same rows
    from downgan_tpu_torch.data.feed import HostDataset

    host = grid_rows(cfg, gen, HostDataset(coarse, fine))
    assert all(np.array_equal(a, b) for a, b in zip(host, got))


@pytest.mark.parametrize("select", [False, True])
def test_grid_figure_png_equals_jax_byte_for_byte(tmp_path, select):
    from downgan_tpu.utils.plots import gen_grid_images

    rng = np.random.default_rng(5)
    coarse = rng.standard_normal((20, 8, 8, 7)).astype(np.float32)
    fake = rng.standard_normal((20, 64, 64, 2)).astype(np.float32)
    real = rng.standard_normal((20, 64, 64, 2)).astype(np.float32)
    port = plots.gen_grid_images(str(tmp_path / "p"), coarse, fake, real, 10, "test",
                                 select=select)
    jax_png = gen_grid_images(str(tmp_path / "j"), coarse, fake, real, 10, "test", select=select)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j")) == [
        "test_images.png", "test_images_epoch_10.png"]
    with open(port, "rb") as a, open(jax_png, "rb") as b:
        assert a.read() == b.read()


def tracked_trainer(tmp_path, **kw):
    cfg = tiny_config()
    coarse, fine = tiny_sets(cfg)
    store = TrackingStore(str(tmp_path / "exps"))
    run = store.create_run(store.create_experiment("grid")).start()
    train = DeviceDataset.from_numpy(coarse[:10], fine[:10], "cpu")
    test = DeviceDataset.from_numpy(coarse[10:], fine[10:], "cpu")
    return Trainer(cfg, train, test, device="cpu", run=run, **kw), run


@pytest.mark.parametrize("epoch,names", [
    (1, ["train_images.png"]), (10, ["train_images.png", "train_images_epoch_10.png"])])
def test_grid_file_names_by_epoch(tmp_path, epoch, names):
    from downgan_tpu.utils.plots import gen_grid_images

    trainer, run = tracked_trainer(tmp_path)
    trainer.epoch = epoch
    trainer._plot_split("train", trainer.train_ds)
    pngs = sorted(n for n in os.listdir(run.artifact_dir) if n.endswith(".png"))
    assert pngs == names and trainer.plot_forwards == 1
    rows = np.zeros((2, 8, 8, 1), np.float32)
    gen_grid_images(str(tmp_path / "j"), rows, rows, rows, epoch, "train", select=False)
    assert sorted(os.listdir(tmp_path / "j")) == names


def test_grid_cadence_and_forwards(tmp_path):
    """plot_every=2 over 2 epochs: epoch 0 plots both splits (two forwards
    of 20 samples, apart from the step's and the test pass's forwards)."""
    trainer, run = tracked_trainer(tmp_path, plot_every=2)
    trainer.train(2)
    assert trainer.plot_forwards == 2
    assert trainer.forwards == {"critic_fake": 10, "update": 2, "metric": 10, "test": 2}
    assert sorted(n for n in os.listdir(run.artifact_dir) if n.endswith(".png")) == [
        "test_images.png", "test_images_epoch_0.png", "train_images.png",
        "train_images_epoch_0.png"]
    with pytest.raises(ValueError, match="plot_every"):
        tracked_trainer(tmp_path / "x", plot_every=0)


def test_no_grid_without_matplotlib_or_after_sigterm(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_module, "have_matplotlib", lambda: False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        trainer, run = tracked_trainer(tmp_path / "a")
        trainer.train(1)
    assert err.getvalue().count("grid figures skipped: matplotlib is not installed here") == 1
    assert trainer.plot_forwards == 0
    assert not [n for n in os.listdir(run.artifact_dir) if n.endswith(".png")]
    monkeypatch.undo()
    trainer, run = tracked_trainer(tmp_path / "b")
    trainer.preempted = True  # SIGTERM asked to stop: the epoch ends without plots
    trainer.train(1)
    assert trainer.plot_forwards == 0 and trainer.epoch == 1
    # no tracked run (a rank other than 0): no figures either
    cfg = tiny_config()
    coarse, fine = tiny_sets(cfg)
    untracked = Trainer(cfg, DeviceDataset.from_numpy(coarse, fine, "cpu"), device="cpu")
    untracked.train(1)
    assert untracked.plot_forwards == 0


# -- TensorBoard ----------------------------------------------------------------

def event_scalars(logdir):
    """tag -> [(step, value)] of every scalar in the TFRecord event files
    under ``logdir`` (length, its CRC, the Event proto, its CRC)."""
    import glob
    import struct

    from tensorboardX.proto import event_pb2

    out = {}
    for path in sorted(glob.glob(os.path.join(logdir, "events.out.tfevents.*"))):
        with open(path, "rb") as f:
            data = f.read()
        i = 0
        while i < len(data):
            (n,) = struct.unpack("<Q", data[i:i + 8])
            event = event_pb2.Event()
            event.ParseFromString(data[i + 12:i + 12 + n])
            i += 12 + n + 4
            for v in event.summary.value:
                out.setdefault(v.tag, []).append((event.step, v.simple_value))
    return out


def test_tensorboard_scalars_equal_the_run_history(trained):
    trainer, _ = trained
    run = trainer.run
    scalars = event_scalars(os.path.join(run.artifact_dir, "tensorboard"))
    assert sorted(scalars) == sorted(run.metric_names)
    for tag, got in scalars.items():
        want = [(h["step"], float(np.float32(h["value"]))) for h in run.metric_history(tag)]
        assert got == want and [s for s, _ in got] == [0, 1]


def test_tensorboard_flag_without_tensorboardx_says_so(tmp_path, capsys, monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "tensorboardX" else real(name, *a))
    (tmp_path / "tiny.json").write_text(tiny_config().to_json())
    main(["train", "--config", str(tmp_path / "tiny.json"), "--synthetic", "--samples", "6",
          "--epochs", "1", "--device", "cpu", "--tracking-root", str(tmp_path / "e"),
          "--tensorboard", "--plot-every", "1000"])
    assert capsys.readouterr().err.count("tensorboardX is not installed here") == 1


# -- MLflow ------------------------------------------------------------------------

def test_live_mirror_then_export_changes_nothing(trained):
    trainer, d = trained
    run = trainer.run
    before = tree(d / "mlruns")
    (exp_dir,) = [p for p in os.listdir(d / "mlruns")]
    (run_dir,) = [p for p in os.listdir(d / "mlruns" / exp_dir) if p != "meta.yaml"]
    lines = before[f"{exp_dir}/{run_dir}/metrics/MAE_train"].decode().splitlines()
    assert [int(ln.split()[2]) for ln in lines] == [0, 1]
    meta = yaml.safe_load(before[f"{exp_dir}/{run_dir}/meta.yaml"])
    assert meta["status"] == 3 and meta["run_name"] == run.meta["run_name"]
    main(["export-mlflow", "--run", run.run_id, "--tracking-root", str(d / "exps"),
          "--out", str(d / "mlruns")])
    assert tree(d / "mlruns") == before


@pytest.mark.parametrize("scope", ["run", "experiment", "store"])
def test_export_mlflow_equals_jax_export_file_by_file(trained, tmp_path, capsys, scope):
    """The JAX package's export-mlflow of the same port run: the same
    files with the same bytes, meta.yaml's file:// locations aside."""
    from click.testing import CliRunner

    from downgan_tpu.cli.__main__ import cli

    trainer, d = trained
    flags = {"run": ["--run", trainer.run.run_id], "experiment": ["--experiment", "downgan-tpu"],
             "store": []}[scope]
    common = ["export-mlflow", "--tracking-root", str(d / "exps"), *flags]
    written = main([*common, "--out", str(tmp_path / "p")])
    res = CliRunner().invoke(cli, [*common, "--out", str(tmp_path / "j")], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    assert capsys.readouterr().out.splitlines()[0] == \
        f"exported 1 run(s) to MLflow FileStore {tmp_path / 'p'}"
    assert res.output.splitlines()[0] == f"exported 1 run(s) to MLflow FileStore {tmp_path / 'j'}"
    port, jax_tree = tree(tmp_path / "p"), tree(tmp_path / "j")
    assert sorted(port) == sorted(jax_tree) and len(written) == 1
    for rel, data in port.items():
        if rel.endswith("meta.yaml"):
            a = yaml.safe_load(data.decode().replace(str(tmp_path / "p"), "DEST"))
            b = yaml.safe_load(jax_tree[rel].decode().replace(str(tmp_path / "j"), "DEST"))
            assert a == b, rel
        else:
            assert data == jax_tree[rel], rel
    assert not [r for r in port if "/checkpoints/" in r]


def test_export_mlflow_refusals_equal_jax(trained, tmp_path, capsys):
    from click.testing import CliRunner

    from downgan_tpu.cli.__main__ import cli

    trainer, d = trained
    for flags, text in ((["--run", "feedfeedfeedfeed"], "not found"),
                        (["--experiment", "nope"], "experiment 'nope' not found"),
                        (["--run", trainer.run.run_id, "--experiment", "other"],
                         "does not belong to experiment 'other'")):
        argv = ["export-mlflow", "--tracking-root", str(d / "exps"), *flags, "--out",
                str(tmp_path / "o")]
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2 and text in capsys.readouterr().err
        res = CliRunner().invoke(cli, argv)
        assert res.exit_code == 2 and text in res.output


# -- the tracking server ---------------------------------------------------------------

@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The JAX package's server and the port's over one store the port wrote."""
    from downgan_tpu.tracking.server import serve as jax_serve
    from downgan_tpu_torch.tracking.server import serve

    store = TrackingStore(str(tmp_path_factory.mktemp("served") / "exps"))
    eid = store.create_experiment("exp-page")
    run = store.create_run(eid, run_name="r").start()
    run.log_params({"lr": 1e-3})
    run.log_metric("MAE", 0.5, 0)
    run.log_metric("MAE", 0.25, 1)
    with open(run.artifact_path("note.txt"), "w") as f:
        f.write("artifact-body")
    os.makedirs(os.path.join(run.artifact_dir, "checkpoints"))
    os.makedirs(run.artifact_dir + "_evil")
    with open(os.path.join(run.artifact_dir + "_evil", "secret.txt"), "w") as f:
        f.write("secret")
    running = []
    for make in (serve, jax_serve):
        server = make(store.root, host="127.0.0.1", port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        running.append(server)
    yield store, eid, run, [f"http://127.0.0.1:{s.server_address[1]}" for s in running]
    for server in running:
        server.shutdown()
        server.server_close()


PATHS = ["/", "/exp/{eid}", "/run/{rid}", "/metric/{rid}/MAE", "/artifact/{rid}/note.txt",
         "/artifact/{rid}/..%2f..%2f..%2fexperiments.json", "/run/..",
         "/artifact/../experiments.json", "/run/%2e%2e", "/metric/../x",
         "/artifact/{rid}/..%2fartifacts_evil%2fsecret.txt", "/exp/..", "/exp/%2e%2e",
         "/exp/<img%20src=x%20onerror=alert(1)>", "/artifact/{rid}/checkpoints", "/nope/x"]


def fetch(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("path", PATHS)
def test_server_answers_as_the_jax_server(servers, path):
    store, eid, run, (port_url, jax_url) = servers
    path = path.format(eid=eid, rid=run.run_id)
    got, want = fetch(port_url + path), fetch(jax_url + path)
    assert got == want
    if path in ("/", f"/exp/{eid}", f"/run/{run.run_id}"):
        assert got[0] == 200
    if "%2f" in path or ".." in path or "%2e" in path or "checkpoints" in path:
        assert got[0] == 404
    # reads create nothing outside the run tree
    assert not os.path.exists(os.path.join(os.path.dirname(store.root), "artifacts"))


def test_server_artifact_stream_bounded_by_content_length(servers, monkeypatch):
    """A file that grew after the server's fstat: the body stops at the
    declared Content-Length."""
    import socket
    import types

    import downgan_tpu_torch.tracking.server as server_mod

    store, _, run, (port_url, _) = servers
    body = b"0123456789ABCDEF"
    with open(run.artifact_path("live.csv"), "wb") as f:
        f.write(body)
    real_fstat = os.fstat

    def shrunk_fstat(fd):
        st = real_fstat(fd)
        return types.SimpleNamespace(st_size=st.st_size - 4) if st.st_size == len(body) else st

    monkeypatch.setattr(server_mod.os, "fstat", shrunk_fstat)
    port = int(port_url.rsplit(":", 1)[1])
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(b"GET /artifact/%s/live.csv HTTP/1.0\r\n\r\n" % run.run_id.encode())
        raw = b""
        while chunk := s.recv(4096):
            raw += chunk
    head, _, payload = raw.partition(b"\r\n\r\n")
    assert b"200" in head.split(b"\r\n", 1)[0] and payload == body[:-4]


# -- the interactive picker ---------------------------------------------------------

def answers(monkeypatch, *replies):
    it = iter(replies)
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(it))


@pytest.mark.parametrize("reply", ["0", "a-new-one"])
def test_interactive_picker_equals_jax(tmp_path, capsys, monkeypatch, reply):
    from downgan_tpu.tracking import TrackingStore as JaxStore
    from downgan_tpu.tracking import define_experiment as jax_define
    from downgan_tpu.tracking import write_tags as jax_write_tags

    got_store = TrackingStore(str(tmp_path / "p"))
    want_store = JaxStore(str(tmp_path / "j"))
    for store in (got_store, want_store):
        store.create_experiment("existing")
    answers(monkeypatch, reply, "described")
    got = define_experiment(got_store, interactive=True)
    run = got_store.create_run(got).start()
    write_tags(run, interactive=True)
    port_out = capsys.readouterr().out
    answers(monkeypatch, reply, "described")
    want = jax_define(want_store, interactive=True)
    jrun = want_store.create_run(want).start()
    jax_write_tags(jrun, interactive=True)
    assert got == want and port_out == capsys.readouterr().out
    assert {i["name"] for i in got_store.experiments().values()} == \
        {i["name"] for i in want_store.experiments().values()}
    assert run.meta["tags"] == jrun.meta["tags"] == {"description": "described"}
    with pytest.raises(ValueError, match="experiment name required"):
        define_experiment(got_store)


def test_train_interactive(tmp_path, capsys, monkeypatch):
    (tmp_path / "tiny.json").write_text(tiny_config().to_json())
    argv = ["train", "--config", str(tmp_path / "tiny.json"), "--synthetic", "--samples", "6",
            "--epochs", "1", "--device", "cpu", "--tracking-root", str(tmp_path / "e"),
            "--plot-every", "1000", "--interactive"]
    answers(monkeypatch, "picked-on-stdin", "first run")
    first = main(argv)
    assert "Which experiment would you like to use?" in capsys.readouterr().out
    store = TrackingStore(str(tmp_path / "e"))
    assert store.experiments()[first.run.experiment_id]["name"] == "picked-on-stdin"
    assert first.run.meta["tags"] == {"description": "first run"}
    # --experiment names it: only the description is asked for
    answers(monkeypatch, "second run")
    second = main([*argv, "--experiment", "named"])
    assert "Which experiment" not in capsys.readouterr().out
    assert store.experiments()[second.run.experiment_id]["name"] == "named"
    assert second.run.meta["tags"] == {"description": "second run"}


def test_colorize_and_comparison_plot_equal_jax(tmp_path):
    from downgan_tpu.utils.plots import colorize, generate_comparison_plot

    rng = np.random.default_rng(9)
    field = rng.standard_normal((16, 16)).astype(np.float32)
    assert np.array_equal(plots.colorize(field), colorize(field))
    assert np.array_equal(plots.colorize(field, -1.0, 1.0, "magma"), colorize(field, -1.0, 1.0,
                                                                              "magma"))
    arrays = [rng.standard_normal((5, 16, 16, 2)).astype(np.float32) for _ in range(4)]
    got = plots.generate_comparison_plot(str(tmp_path / "p"), *arrays, epoch=3)
    want = generate_comparison_plot(str(tmp_path / "j"), *arrays, epoch=3)
    assert os.path.basename(got) == "comparison_epoch_3.png"
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_tensorboard_images(tmp_path):
    from downgan_tpu_torch.tracking.tensorboard import TensorBoardSink, fig_to_array

    plt = plots.pyplot()
    fig, ax = plt.subplots(figsize=(2, 1))
    ax.plot([0, 1])
    chw = fig_to_array(fig)
    sink = TensorBoardSink(str(tmp_path / "tb"))
    assert chw.shape[0] == 3 and chw.dtype == np.uint8
    sink.log_figure("grid", fig, 0)
    sink.log_image_array("grid", chw, 1)
    sink.close()
    plt.close(fig)
    from tensorboardX.proto import event_pb2

    (path,) = os.listdir(tmp_path / "tb")
    data = (tmp_path / "tb" / path).read_bytes()
    images, i = [], 0
    import struct

    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        event = event_pb2.Event()
        event.ParseFromString(data[i + 12:i + 12 + n])
        i += 12 + n + 4
        images += [(event.step, v.image.width, v.image.height) for v in event.summary.value
                   if v.HasField("image")]
    assert images == [(0, chw.shape[2], chw.shape[1]), (1, chw.shape[2], chw.shape[1])]
