"""The port's ``cli train --multihost`` on two gloo ranks of the CPU, the
counterpart of ``tests/test_parallel.py::test_two_process_full_trainer``:
on a device-resident set (replicated, each rank gathering its rows) and
from host RAM (``--host-feed``, each rank reading only its rows), two
epochs, then one epoch and a ``--resume`` to two. The ranks end with the
same state and the same epoch records, bit for bit; the resumed run equals
the uninterrupted one; only rank 0 tracks and writes checkpoints and best
bundles; and the run matches one process on the same global batches. The
ranks are spawned once for the module (``tests/_torch_dp_worker.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.multiprocessing")

from downgan_tpu_torch.cli.__main__ import main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402

import _torch_dp_worker as worker  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

WORLD = 2
PATHS = ("device", "host_feed")
# As tests/test_torch_dp.py (the port's step tolerances of
# tests/test_torch_train.py), over two epochs of 5 steps: 10 critic and 2
# generator updates.
METRIC_RTOL, METRIC_ATOL = 1e-6, 5e-6
ADAM_ATOL, MEDIAN_ATOL = 2 * 2.5e-4, 1e-6
UPDATES = {"generator": 2, "critic": 10}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_trainer")
    config_path = tmp / "tiny.json"
    config_path.write_text(Config(
        coarse_size=8, fine_size=32, filters=8, num_res_blocks=1,
        hp=HyperParams(batch_size=8, metrics_to_calculate=("MAE", "MSE", "Wass"))).to_json())
    worker.spawn(worker.trainer_cases, (WORLD, str(tmp / "store"), str(tmp), str(config_path)),
                 WORLD)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]
    one = main(worker.train_argv(str(config_path), str(tmp / "ckpt_one"), str(tmp / "track_one"),
                                 2, host_feed=False))
    return {"ranks": ranks, "one": {"history": one.history, "state": worker.flat_state(one)}}


def assert_same_run(a: dict, b: dict, what: str):
    assert a["history"] and len(a["history"]) == len(b["history"]), what
    for ra, rb in zip(a["history"], b["history"]):
        for split in ("train", "test"):
            assert ra[split] == rb[split], (what, ra["epoch"], split)
    assert a["state"].keys() == b["state"].keys()
    unequal = [k for k, v in a["state"].items() if not torch.equal(v, b["state"][k])]
    assert not unequal, (what, unequal[:5])


@pytest.mark.parametrize("path", PATHS)
def test_ranks_end_with_the_same_run(trained, path):
    r0, r1 = (r[path]["runs"] for r in trained["ranks"])
    for name in ("full", "resumed"):
        assert_same_run(r0[name], r1[name], f"{path} {name}")


@pytest.mark.parametrize("path", PATHS)
def test_resume_reproduces_the_uninterrupted_run(trained, path):
    for rank_out in trained["ranks"]:
        runs = rank_out[path]["runs"]
        assert [r["epoch"] for r in runs["resumed"]["history"]] == [1]
        assert_same_run({"history": runs["full"]["history"][1:], "state": runs["full"]["state"]},
                        runs["resumed"], f"{path} resume")


def test_only_rank_0_writes(trained):
    r0, r1 = trained["ranks"]
    assert all(r0[p]["tracking_exists"] for p in PATHS)
    assert not any(r1[p]["tracking_exists"] for p in PATHS)
    # Per path: 2 epochs + 1 epoch + 1 resumed epoch, each epoch saved, and
    # the final save of each run skipped as already written.
    assert r0["writes"]["checkpoints"] == 2 * 4 and r1["writes"]["checkpoints"] == 0
    assert r0["writes"]["bundles"] > 0 and r1["writes"]["bundles"] == 0


@pytest.mark.parametrize("path", PATHS)
def test_two_ranks_match_one_process(trained, path):
    got, want = trained["ranks"][0][path]["runs"]["full"], trained["one"]
    for rg, rw in zip(got["history"], want["history"]):
        for split in ("train", "test"):
            assert rg[split].keys() == rw[split].keys()
            for k, v in rw[split].items():
                np.testing.assert_allclose(rg[split][k], v, rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                           err_msg=f"{path} epoch {rw['epoch']} {split} {k}")
    for k, w in want["state"].items():
        part = k.split(".")[0]
        if part not in UPDATES or not w.is_floating_point():
            continue
        diff = (got["state"][k].double() - w.double()).abs()
        assert diff.max() <= ADAM_ATOL * UPDATES[part], (path, k, diff.max().item())
        assert diff.median() <= MEDIAN_ATOL, (path, k, diff.median().item())
