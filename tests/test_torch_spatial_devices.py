"""Overlap tiling split over several devices (``parallel/spatial.py``,
``SRModel(devices=)``, ``serve --mesh``): the fold and the dispatch count
equal the JAX package's over tile and device counts, and two replicas give
one device's fields bit for bit, deterministic and stochastic. JAX is
imported only inside the tests that compare with it, so the ``cuda`` leg,
two replicas on one card, runs on the card:
``python -m pytest tests/test_torch_spatial_devices.py -m cuda --noconftest``."""
import itertools
import json
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from downgan_tpu_torch.cli.__main__ import build_parser  # noqa: E402
from downgan_tpu_torch.config.config import Config  # noqa: E402
from downgan_tpu_torch.parallel.spatial import (  # noqa: E402
    count_tiled_dispatches,
    effective_fold,
    tiled_sr_inference,
)
from downgan_tpu_torch.serving import SRModel, generate_domain_remote, serve_model  # noqa: E402
from downgan_tpu_torch.training.state import make_generator  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

KW = dict(filters=8, num_res_blocks=1, coarse_size=8, fine_size=32)
# (tiles_per_dispatch, devices): a fold the devices divide, one they do not,
# one of a single tile each, and the ragged last dispatch padded.
SPLITS = [(4, 2), (3, 2), (2, 2), (5, 3)]


def weights(noise):
    cfg = Config(noise_channels=noise, **KW)
    return cfg, make_generator(cfg, "cpu", rng=torch.Generator().manual_seed(3)).state_dict()


def domain(b=2, h=20, w=12, seed=0):
    return np.random.default_rng(seed).standard_normal((b, h, w, 7)).astype(np.float32)


def test_fold_and_dispatch_count_are_the_jax_ones():
    pytest.importorskip("jax")
    from downgan_tpu.parallel import spatial as jax_spatial

    for tpd, n in itertools.product((0, 1, 2, 3, 4, 7, 8, 9, 16), (1, 2, 3, 4, 8)):
        assert effective_fold(tpd, n) == jax_spatial.effective_fold(tpd, n), (tpd, n)
    for (b, h, w), rows, cols, tpd, n in itertools.product(
            ((1, 24, 16), (2, 25, 16), (3, 56, 112)), (4, 8, 16), (0, 8), (1, 3, 8), (1, 2, 4)):
        args = (b, h, w, rows, cols, tpd)
        assert count_tiled_dispatches(*args, n) == jax_spatial.count_tiled_dispatches(
            *args, mesh_size=n), (args, n)


@pytest.mark.parametrize("noise", [0, 2])
@pytest.mark.parametrize("tpd,n", SPLITS)
def test_replicas_give_one_devices_fields(noise, tpd, n):
    """Each dispatch's tiles split over ``n`` replicas on the CPU equal one
    device's fields bit for bit; a stochastic generator's whole-domain
    latent is drawn before the split. Where each replica takes a single
    tile, both sides run with oneDNN off: PyTorch's CPU convolution takes
    another kernel at batch 1 than at batch 2 and up on these small bands
    (a sample's outputs then differ in the last bits, up to 2e-5 on a
    3x3 conv of 16 channels), and the native kernel computes each sample
    alone at any batch."""
    cfg, sd = weights(noise)
    x = domain()
    kw = dict(tile_rows=4, overlap=2, tiles_per_dispatch=tpd)
    with torch.backends.mkldnn.flags(enabled=effective_fold(tpd, n) // n > 1):
        one = tiled_sr_inference(cfg, sd, x, device="cpu", **kw)
        split = tiled_sr_inference(cfg, sd, x, devices=["cpu"] * n, **kw)
        assert split.shape == (2, 80, 48, 2)
        np.testing.assert_array_equal(split, one)
        cols = tiled_sr_inference(cfg, sd, x, devices=["cpu"] * n, tile_cols=4, **kw)
        np.testing.assert_array_equal(cols, tiled_sr_inference(cfg, sd, x, device="cpu",
                                                               tile_cols=4, **kw))


@pytest.mark.parametrize("noise", [0, 2])
def test_srmodel_domain_over_replicas(noise):
    """``SRModel(devices=)``'s domain requests: one device's fields, and
    ``/metrics`` counts the dispatches of a fold rounded up to the replicas;
    patch requests stay on ``device``."""
    cfg, sd = weights(noise)
    one = SRModel(cfg, sd, batch_size=4, device="cpu")
    two = SRModel(cfg, sd, batch_size=4, device="cpu", devices=["cpu", "cpu"])
    x = domain(b=1, h=20, w=12, seed=1)
    want = one.generate_domain(x, tile_rows=4, overlap=2, tiles_per_dispatch=3)
    server = serve_model(two, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        got = generate_domain_remote(url, x, tile_rows=4, overlap=2, tiles_per_dispatch=3)
        metrics = json.loads(urllib.request.urlopen(f"{url}/metrics").read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    np.testing.assert_array_equal(got, want)
    # 5 bands, a fold of 3 rounded up to 4: 2 dispatches (one device: 2 of 3).
    assert metrics["dispatches"] == count_tiled_dispatches(1, 20, 12, 4, 0, 3, 2) == 2
    patches = domain(b=3, h=8, w=8, seed=2)
    np.testing.assert_array_equal(two.generate(patches), one.generate(patches))


def test_serve_mesh_flag():
    parser = build_parser()
    assert parser.parse_args(["serve", "--weights", "g.pt"]).mesh is True
    assert parser.parse_args(["serve", "--weights", "g.pt", "--no-mesh"]).mesh is False


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the replicas' DRB kernels run only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [0, 2])
def test_cuda_replicas_give_one_devices_fields(cuda_device, noise):
    """Two replicas on the one card (each with its own DRB pack cache)
    against one, bit for bit: the replicas run the convolutions outside the
    DRB trunk at half the batch, with the algorithms cuDNN picks there."""
    cfg, sd = weights(noise)
    x = domain(b=2, h=32, w=24)
    kw = dict(tile_rows=8, overlap=4, tiles_per_dispatch=4)
    one = tiled_sr_inference(cfg, sd, x, device=cuda_device, **kw)
    two = tiled_sr_inference(cfg, sd, x, devices=[cuda_device] * 2, **kw)
    np.testing.assert_array_equal(two, one)
