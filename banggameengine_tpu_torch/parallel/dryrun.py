"""The sharded modes end to end on a mesh of ``n`` ranks.

Counterpart of ``__graft_entry__.dryrun_multichip``: the vmapped
many-world step with metrics, the flat step sharded over the world axis,
the entity-sharded contact phase and the fully sharded world step (a
falling-box pile, then the demo topology), each on its mesh of ``n``
ranks, each checked finite.  ``dryrun_multichip(4, device="cpu")`` runs
it on 4 gloo ranks on the CPU; on CUDA it takes one rank a card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from banggameengine_tpu_torch.parallel import ranks


def _check_finite(t: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(t).all()):
        raise RuntimeError(f"non-finite values in {what}")


def _run(n: int, device: str) -> list[str]:
    """The dry run's body on this rank of an initialised group of ``n``;
    returns its report lines."""
    from torch.distributed.tensor import Shard

    from banggameengine_tpu_torch.parallel import manyworld as mw
    from banggameengine_tpu_torch.parallel import sharded_world as sw
    from banggameengine_tpu_torch.parallel import spatial
    from banggameengine_tpu_torch.scene.synthetic import (
        build_demo_like, build_falling_boxes)
    from banggameengine_tpu_torch.state import (
        BODY_DYNAMIC, COMP_CHARACTER, COMP_COLLIDER, InputFrame)

    if dist.get_world_size() != n:
        raise ValueError(f"dryrun_multichip({n}) on a group of "
                         f"{dist.get_world_size()} ranks")
    dev_type = torch.device(device).type
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dev_type == "cuda" else torch.device("cpu"))
    lines = []

    # the vmapped step with metrics, 2 worlds a rank
    mesh = mw.make_world_mesh(device_type=dev_type)
    state, static = build_demo_like(device=dev)
    worlds = 2 * n
    bstate = mw.shard_batched(mw.replicate_state(state, worlds), mesh)
    binp = mw.shard_batched(
        mw.replicate_input(InputFrame.zero(dev), worlds), mesh)
    step = mw.make_sharded_many_world_step(static, mesh, with_metrics=True)
    out, metrics = step(bstate, binp)
    ke = float(metrics["mean_kinetic_energy"])
    if ke != ke:
        raise RuntimeError("NaN in the vmapped step's metrics")
    lines.append(f"{worlds} worlds over {n} ranks OK (vmapped); mean KE="
                 f"{ke:.4f} mean height="
                 f"{float(metrics['mean_height']):.3f}")

    # the flat layout sharded over the world axis: each rank its own worlds
    fstep = mw.make_flat_many_world_step(static, worlds, state.comp_mask,
                                         num_steps=2, mesh=mesh)
    fout = fstep(mw.shard_batched(mw.replicate_state(state, worlds), mesh),
                 binp)
    if fout.pos.placements != (Shard(0),):
        raise RuntimeError("the flat-sharded step lost its world sharding")
    _check_finite(fout.pos.full_tensor(), "the flat-sharded step")
    lines.append(f"flat-sharded lockstep step OK ({worlds} worlds x "
                 f"{worlds // n} a rank, 2 steps)")

    # one world sharded over the entity axis: narrowphase + solve rows a
    # rank, a velocity all-gather an iteration
    emesh = ranks.make_mesh(spatial.AXIS, dev_type)
    estate, estatic = build_falling_boxes(2 * n, seed=1, spread=3.0,
                                          device=dev)
    if estate.capacity % n == 0:
        solid = estate.alive & (
            (estate.comp_mask & (COMP_COLLIDER | COMP_CHARACTER)) != 0)
        is_dyn = (estatic.body_type == BODY_DYNAMIC) & estate.alive
        phase = spatial.make_entity_sharded_contact_phase(estatic, emesh)
        v, _w = phase(estate.pos, estate.quat, estate.lin_vel,
                      estate.ang_vel, is_dyn, solid, estatic.fixed_dt)
        _check_finite(v, "the entity-sharded contact phase")
        lines.append(f"entity-sharded contact phase OK ({estate.capacity} "
                     f"bodies / {n} ranks)")

    # the fully sharded world: a pile, then the demo topology
    fmesh = sw.make_entity_axis_mesh(n, dev_type)
    fstate, fstatic = build_falling_boxes(4 * n, seed=2, spread=4.0,
                                          device=dev)
    if fstate.capacity % n == 0:
        ss, sst = sw.shard_world(fstate, fstatic, fmesh)
        out2, _ev = sw.make_fully_sharded_step(fstatic, fmesh)(
            ss, InputFrame.zero(dev), sst)
        if out2.pos.placements != (Shard(0),):
            raise RuntimeError("the fully sharded step lost its sharding")
        _check_finite(out2.pos.full_tensor(), "the fully sharded step")
        lines.append(f"fully sharded WorldState step OK ({fstate.capacity} "
                     f"bodies row-sharded / {n} ranks)")
    if state.capacity % n == 0:
        ds, dst = sw.shard_world(state, static, fmesh)
        dstep = sw.make_fully_sharded_step(static, fmesh)
        for _ in range(3):
            ds, _ev = dstep(ds, InputFrame.zero(dev), dst)
        pos = ds.pos.full_tensor()
        _check_finite(pos, "the fully sharded demo topology")
        lines.append(f"demo topology fully sharded OK (character + trigger "
                     f"+ ground over {n} ranks; lowest y="
                     f"{float(pos[:, 1].min()):.3f})")
    return lines


def _rank(rank: int, world_size: int, device: str) -> list[str]:
    return _run(world_size, device)


def dryrun_multichip(n: int, device: str = "cuda") -> list[str]:
    """Run the sharded modes on a mesh of ``n`` ranks and return the
    report lines (also printed, by rank 0).

    Inside an initialised process group of ``n`` ranks every rank calls
    this (the caller started the ranks: one a card under NCCL, or gloo
    ranks on the CPU); outside one, it starts ``n`` ranks on ``device``
    through :func:`ranks.run_ranks` (``device="cpu"``: gloo ranks) and
    returns rank 0's lines.
    """
    if dist.is_initialized():
        lines = _run(n, device)
        if dist.get_rank() == 0:
            for line in lines:
                print(f"[dryrun_multichip] {line}")
        return lines
    lines = ranks.run_ranks(_rank, n, device, device=device)[0]
    for line in lines:
        print(f"[dryrun_multichip] {line}")
    return lines

