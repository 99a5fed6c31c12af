"""Ranks of the port's spatial-sharding tests
(``tests/test_torch_spatial_sharding.py``): four gloo ranks, spawned once
through ``tests/_torch_dp_worker.py::spawn``, laid out as a 2 x 2 (data,
spatial) grid. The 2-shard cases run in each spatial group of the grid,
the 4-shard cases over the whole job. Every rank records what it computed;
the test compares. Imports nothing of JAX, so the card's ``-m cuda`` leg
runs it too."""
from __future__ import annotations

import os

import torch

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.parallel import spatial
from downgan_tpu_torch.parallel.dp import GroupSync
from downgan_tpu_torch.parallel.mesh import batch_rows, field_rows, make_grid
from downgan_tpu_torch.training.state import make_critic, make_generator, make_train_state
from downgan_tpu_torch.training.wgan import build_train_step, gradient_penalty

import _torch_dp_worker as dp_worker

GRID = (2, 2)  # (data, spatial)


def load_state(case: dict, device: str):
    cfg = Config.from_json(case["config"])
    state = make_train_state(cfg, device)
    state.generator.load_state_dict(case["generator"])
    state.critic.load_state_dict(case["critic"])
    return cfg, state


def halo_case(case: dict, group, device: str) -> dict:
    """The halo bands of ``case["x"]`` (whole, the same on every rank) at
    each k, zero-filled and clipped; and a scalar of the k = 5 band, its
    gradient with respect to the whole field (kept as a graph) and the
    gradient of that gradient's square sum: the exchange, its adjoint and
    the adjoint's own backward."""
    x = case["x"].to(device)
    shards, index = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
    local = spatial.scatter_rows(x, group)
    out = {f"band_k{k}": spatial.halo_exchange(local, k, group).cpu() for k in case["ks"]}
    out["clipped_k5"] = spatial.halo_exchange(local, 5, group, fill=False).cpu()
    whole = x.detach().clone().requires_grad_(True)
    band = spatial.halo_exchange(spatial.scatter_rows(whole, group), 5, group)
    weight = case["band_weights"][shards][index].to(device)
    loss = spatial.row_sum((band.pow(3) * weight).sum(), group)
    (grad,) = torch.autograd.grad(loss, whole, create_graph=True)
    (grad2,) = torch.autograd.grad(grad.square().sum(), whole)
    out.update(loss=loss.detach().cpu(), grad=grad.detach().cpu(), grad2=grad2.cpu())
    return out


def conv_case(case: dict, group, device: str) -> dict:
    """``make_sharded_conv`` on the whole field; and through it a scalar,
    its input gradient as a graph, and that gradient's square sum
    differentiated in the field and the weight (each rank's share of the
    weight's, summed)."""
    x, w, b = (case[k].to(device) for k in ("x", "weight", "bias"))
    conv = spatial.make_sharded_conv(group)
    out = {"y": conv(x, w, b).cpu()}
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    loss = (torch.tanh(conv(xg, wg, b)) * case["r"].to(device)).sum()
    (gx,) = torch.autograd.grad(loss, xg, create_graph=True)
    gx2, gw2 = torch.autograd.grad(gx.square().sum(), (xg, wg))
    torch.distributed.all_reduce(gw2, group=group)  # a rank's rows' share of the weight's
    out.update(gx=gx.detach().cpu(), gx2=gx2.cpu(), gw2=gw2.cpu())
    return out


def linear_case(case: dict, group, device: str) -> dict:
    """``spatial.RowShardedLinear`` on this rank's rows of an NCHW activation: the
    output, and its weight gradient summed over the group."""
    x = case["x"].to(device)
    linear = torch.nn.Linear(x[0].numel(), 5).to(device)
    linear.load_state_dict({k: v.to(device) for k, v in case["linear"].items()})
    y = spatial.RowShardedLinear(linear, group)(spatial.scatter_rows(x, group))
    (y * case["r"].to(device)).sum().backward()
    spatial.SpatialSync(group, [linear.bias]).gradients([linear.weight, linear.bias])
    return {"y": y.detach().cpu(), "weight_grad": linear.weight.grad.cpu(),
            "bias_grad": linear.bias.grad.cpu()}


def generator_case(case: dict, group, device: str) -> dict:
    """The sharded generator's output, and the parameter gradients of a
    scalar of it (the DRBs' backward over their bands, the halos' adjoints,
    the gather's backward), summed over the group by :class:`SpatialSync`'s
    rule."""
    cfg, state = load_state(case, device)
    fine = spatial.sharded_generator_apply(cfg, group)(state.generator, case["coarse"].to(device))
    (fine * case["r"].to(device)).sum().backward()
    spatial.SpatialSync(group).gradients(list(state.generator.parameters()))
    return {"fine": fine.detach().cpu(), "grads": gradients(state.generator)}


def critic_case(case: dict, group, device: str) -> dict:
    """The sharded critic's scores, the GP through it and the GP's
    parameter gradients (the double backward through the collectives),
    summed over the group by :class:`SpatialSync`'s rule."""
    cfg, state = load_state(case, device)
    sharded = spatial.ShardedCritic(state.critic, group)
    real, fake, alpha = (case[k].to(device) for k in ("real", "fake", "alpha"))
    with torch.no_grad():
        scores = spatial.sharded_critic_apply(cfg, group)(state.critic, real)
    gp = gradient_penalty(sharded, real, fake, alpha)
    gp.backward()
    params = list(state.critic.parameters())
    spatial.SpatialSync(group, sharded.replicated_parameters()).gradients(params)
    return {"scores": scores.cpu(), "gp": gp.detach().cpu(), "grads": gradients(state.critic)}


def gradients(module) -> dict:
    """Each parameter's gradient on the CPU, zeros where autograd left none
    (the GP does not reach a bias that only shifts a LeakyReLU's input)."""
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
            for k, p in module.named_parameters()}


def step_case(case: dict, build, device: str, sync_rows=None) -> dict:
    """``case["steps"]`` train steps of the step ``build(cfg, state)``
    makes, on the case's global batches (each data replica on its rows
    when ``sync_rows`` = (rank, world)); alphas, latents and flips are the
    case's, for the global batch. Returns the metrics and final weights."""
    cfg, state = load_state(case, device)
    step = build(cfg, state)
    metrics = []
    for i in range(len(case["coarse"])):
        c, f = case["coarse"][i], case["fine"][i]
        if sync_rows is not None:
            c, f = (batch_rows(t, *sync_rows) for t in (c, f))
        kw = {"alpha": case["alphas"][i].to(device)}
        if "latents" in case:
            kw["latents"] = {k: v[i].to(device) for k, v in case["latents"].items()}
        if "flips" in case:
            kw["flips"] = tuple(m[i].to(device) for m in case["flips"])
        metrics.append(dp_worker.to_cpu(step(state, c.to(device), f.to(device), **kw)))
    return {"metrics": metrics, "generator": dp_worker.to_cpu(state.generator.state_dict()),
            "critic": dp_worker.to_cpu(state.critic.state_dict()), "step": state.step,
            "forwards": dict(step.forwards)}


def refusals(cases: dict, group, device: str) -> dict:
    """The message of each refusal (None where nothing was refused)."""
    def message(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            return f"{type(e).__name__}: {e}"
        return None

    ref = Config.from_json(cases["step"]["config"])
    srresnet = ref.replace(generator_arch="srresnet")
    return {
        "critic_conditional": message(lambda: spatial.build_spatial_train_step(
            ref.replace(critic_conditional=True), None, None, group)),
        "srresnet_apply": message(lambda: spatial.sharded_generator_apply(srresnet, group)),
        "srresnet_module": message(lambda: spatial.ShardedGenerator(
            make_generator(srresnet, device), group)),
        "fine_size": message(lambda: spatial.ShardedCritic(
            make_critic(ref.replace(fine_size=32, coarse_size=4), device), None)),
        "odd_local_rows": message(lambda: spatial.sharded_conv3x3(
            torch.zeros(1, 1, 3, 4, device=device), torch.zeros(1, 1, 3, 3, device=device),
            None, group, stride=2)),
        "rows_not_divisible": message(lambda: field_rows(6, 4, 0)),
    }


def spatial_cases(rank: int, world: int, store: str, workdir: str, device: str) -> None:
    """Rank ``rank``'s part of the test: every case of ``workdir/cases.pt``
    at 2 shards (this rank's spatial group of the 2 x 2 grid) and 4 (the
    job), the spatial steps, the DP x spatial step and the 2-rank DP step
    on its data group, and the refusals; results to ``workdir/rank<r>.pt``."""
    dp_worker.join(rank, world, store, device)
    data_group, spatial_group = make_grid(*GRID)
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=True)
    out = {}
    for shards, group in ((2, spatial_group), (4, None)):
        out[f"halo_{shards}"] = halo_case(cases["halo"], group, device)
        out[f"conv_{shards}"] = conv_case(cases["conv"], group, device)
        out[f"linear_{shards}"] = linear_case(cases["linear"], group, device)
        out[f"generator_{shards}"] = generator_case(cases["generator"], group, device)
        out[f"critic_{shards}"] = critic_case(cases["critic"], group, device)

    def spatial_step(cfg, state):
        return spatial.build_spatial_train_step(cfg, state.generator, state.critic,
                                                spatial_group)

    out["step"] = step_case(cases["step"], spatial_step, device)
    out["step_noise_flips"] = step_case(cases["step_noise_flips"], spatial_step, device)
    data_rows = (torch.distributed.get_rank(data_group), GRID[0])
    out["dp_spatial"] = step_case(
        cases["dp"], lambda cfg, state: spatial.build_dp_spatial_train_step(
            cfg, state.generator, state.critic, spatial_group, data_group), device, data_rows)
    out["dp"] = step_case(
        cases["dp"], lambda cfg, state: build_train_step(cfg, state.generator, state.critic,
                                                          sync=GroupSync(data_group)),
        device, data_rows)
    out["refusals"] = refusals(cases, spatial_group, device)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
