"""A run the port's trainer wrote, read back through the JAX package's
tracking (``TrackingStore``, the ``serve-tracking`` viewer and
``export-mlflow``); the port's ``hyperparams_dict`` against the JAX one;
and the slice as a whole: the port trains with EMA and best-epoch tracking,
and its best bundle's ``generator.pt``, laid out by the JAX package's own
``port_generator``, gives the flax generator the port's field."""
import csv
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.tracking import TrackingStore as JaxTrackingStore  # noqa: E402
from downgan_tpu.tracking import hyperparams_dict as jax_hyperparams_dict  # noqa: E402
from downgan_tpu.tracking import server as jax_tracking_server  # noqa: E402
from downgan_tpu.tracking.mlflow_export import export_run, widen_run_id  # noqa: E402
from downgan_tpu.training.state import make_models  # noqa: E402
from downgan_tpu.utils.port_weights import port_generator  # noqa: E402

from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset  # noqa: E402
from downgan_tpu_torch.inference import load_bundle  # noqa: E402
from downgan_tpu_torch.tracking import (  # noqa: E402
    TrackingStore,
    define_experiment,
    hyperparams_dict,
    log_hyperparams,
    write_tags,
)
from downgan_tpu_torch.training.state import load_generator  # noqa: E402
from downgan_tpu_torch.training.trainer import Trainer  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

KW = dict(filters=8, num_res_blocks=1, coarse_size=16, fine_size=128)
# The flax and the port generator on the same weights: fp32 on both sides,
# sums in another order.
FIELD_ATOL = 1e-5


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Two epochs of the port's Trainer with EMA and --track-best MSSSIM,
    as a tracked run of the port's store."""
    root = str(tmp_path_factory.mktemp("tracking"))
    cfg = Config(hp=HyperParams(batch_size=2, critic_iterations=2, ema_decay=0.5), **KW)
    coarse, fine = synthetic_dataset(n_samples=7, seed=8)
    store = TrackingStore(root)
    run = store.create_run(define_experiment(store, "parity", tag="port run"),
                           run_name="port").start()
    log_hyperparams(run, cfg)
    write_tags(run, "written by the port")
    trainer = Trainer(cfg, DeviceDataset.from_numpy(coarse[:4], fine[:4], "cpu"),
                      DeviceDataset.from_numpy(coarse[4:], fine[4:], "cpu"), device="cpu",
                      run=run, track_best="MSSSIM")
    trainer.train(2)
    run.end("FINISHED")
    return root, run, trainer


def test_port_run_reads_back_through_the_jax_store(port_run):
    root, run, trainer = port_run
    theirs = JaxTrackingStore(root)
    assert theirs.experiments() == TrackingStore(root).experiments()
    assert theirs.experiments()["0"]["tags"] == {"mlflow.note.content": "port run"}
    jrun = theirs.get_run(run.run_id)
    assert jrun.meta["status"] == "FINISHED" and jrun.meta["run_name"] == "port"
    assert jrun.meta["tags"] == {"description": "written by the port"}
    assert jrun.params == json.loads(json.dumps(hyperparams_dict(trainer.config)))
    names = jrun.metric_names
    assert names == run.metric_names
    assert {"MAE_train", "gen_loss_train", "MSSSIM_test", "MSSSIM_ema_test",
            "best_MSSSIM_test"} <= set(names)
    for name in names:
        assert jrun.metric_history(name) == run.metric_history(name)
    for split in ("train", "test"):
        history = jrun.metric_history(f"MAE_{split}")
        assert [h["step"] for h in history] == [0, 1]
        assert [h["value"] for h in history] == [r[split]["MAE"] for r in trainer.history]
        with open(os.path.join(jrun.artifact_dir, f"{split}_metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        assert [int(r["epoch"]) for r in rows] == [0, 1]
        assert [float(r["MAE"]) for r in rows] == [r[split]["MAE"] for r in trainer.history]


def test_jax_viewer_and_mlflow_export_read_the_port_run(port_run, tmp_path):
    root, run, trainer = port_run
    server = jax_tracking_server.serve(root, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        page = urllib.request.urlopen(f"{url}/run/{run.run_id}", timeout=30).read().decode()
        listing = urllib.request.urlopen(f"{url}/exp/0", timeout=30).read().decode()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert "MSSSIM_ema_test" in page and "ema_decay" in page
    assert run.run_id in listing and "FINISHED" in listing

    out = export_run(JaxTrackingStore(root).get_run(run.run_id), str(tmp_path / "mlruns"))
    assert os.path.basename(out) == widen_run_id(run.run_id)
    with open(os.path.join(out, "metrics", "MAE_train")) as f:
        rows = [ln.split() for ln in f.read().splitlines()]
    assert [(float(v), int(s)) for _, v, s in rows] == [
        (r["train"]["MAE"], e) for e, r in enumerate(trainer.history)]
    assert os.path.exists(os.path.join(out, "artifacts", "best", "generator.pt"))


@pytest.mark.parametrize("source", ["default", "florida", "tiny_ema"])
def test_hyperparams_dict_matches_jax(source):
    if source == "florida":
        with open("examples/florida.json") as f:
            text = f.read()
    else:
        hp = HyperParams(batch_size=2, ema_decay=0.999) if source == "tiny_ema" else HyperParams()
        text = Config(hp=hp, **(KW if source == "tiny_ema" else {})).to_json()
    ours, theirs = hyperparams_dict(Config.from_json(text)), jax_hyperparams_dict(
        JaxConfig.from_json(text))
    assert ours == theirs and len(ours) > 40


def test_best_bundle_through_jax_port_generator(port_run):
    """The slice end to end: the port's best EMA bundle, read by the JAX
    package's ``port_generator``, gives the flax generator the port's field
    on the same covariates."""
    _, run, trainer = port_run
    best_dir = os.path.join(run.artifact_dir, "best")
    with open(os.path.join(best_dir, "best.json")) as f:
        best = json.load(f)
    assert best["metric"] == "MSSSIM" and best["ema"] is True
    config, g_weights, _ = load_bundle(best_dir)
    params = port_generator({k: v.numpy() for k, v in g_weights.items()},
                            num_res_blocks=config.num_res_blocks,
                            num_upsample=config.num_upsample)
    flax_gen, _ = make_models(JaxConfig.from_json(config.to_json()))
    x = np.random.default_rng(3).standard_normal((2, 16, 16, 7)).astype(np.float32)
    want = np.asarray(jax.jit(flax_gen.apply)(params, jnp.asarray(x)))
    gen = load_generator(config, g_weights, "cpu")
    with torch.no_grad():
        got = gen(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 128, 128, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=FIELD_ATOL)
    # the bundle is the EMA generator of the best epoch, not the live one
    if best["epoch"] == trainer.epoch - 1:
        ema = trainer.state.g_ema.state_dict()
        assert all(torch.equal(g_weights[k], ema[k]) for k in ema)
    live = trainer.state.generator.state_dict()
    assert not all(torch.equal(g_weights[k], live[k]) for k in live)
