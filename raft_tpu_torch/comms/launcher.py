"""Launcher-driven comms bootstrap, the ``mpi_comms`` deployment path
(counterpart of ``raft_tpu.comms.launcher``).

A job launcher (SLURM, OpenMPI, or explicit ``RAFT_TPU_*`` variables)
publishes rank, size and coordinator in the environment; this module
reads them (the JAX package's variables, in its priority order), joins
the process world (``bootstrap.initialize_distributed``) and hands back
a :class:`~raft_tpu_torch.core.resources.Resources` with comms injected.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from raft_tpu_torch.comms.comms import build_comms, inject_comms
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import Resources

__all__ = ["LauncherWorld", "build_launcher_resources", "detect_launcher"]


@dataclass(frozen=True)
class LauncherWorld:
    """The launcher-provided process world (the MPI_COMM_WORLD role)."""

    kind: str                      # "explicit" | "slurm" | "ompi" | "single"
    num_processes: int
    process_id: int
    coordinator: Optional[str]     # host:port of process 0, None if local


def detect_launcher(env=None) -> LauncherWorld:
    """Read the launcher environment. Priority: explicit ``RAFT_TPU_*``
    > SLURM > OpenMPI > single-process fallback."""
    e = os.environ if env is None else env

    def get(n):
        v = e.get(n)
        return v if v and str(v).strip() else None

    def geti(*names):
        for n in names:
            v = get(n)
            if v is not None:
                try:
                    return int(v)
                except ValueError:  # graftlint: disable=GL006
                    # justified swallow: an unparseable value means "not
                    # set by this launcher"; detection falls through
                    pass
        return None

    coord = get("RAFT_TPU_COORDINATOR")
    n = geti("RAFT_TPU_NUM_PROCS")
    r = geti("RAFT_TPU_PROC_ID")
    if n is not None and r is not None:
        return LauncherWorld("explicit", n, r, coord)

    n = geti("SLURM_NTASKS", "SLURM_NPROCS")
    r = geti("SLURM_PROCID")
    if n is not None and r is not None:
        return LauncherWorld("slurm", n, r, coord)

    n = geti("OMPI_COMM_WORLD_SIZE")
    r = geti("OMPI_COMM_WORLD_RANK")
    if n is not None and r is not None:
        return LauncherWorld("ompi", n, r, coord)

    return LauncherWorld("single", 1, 0, None)


def build_launcher_resources(
    axis_names: Tuple[str, ...] = ("data",),
    mesh_shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence] = None,
    world: Optional[LauncherWorld] = None,
    abort_timeout_s: float = 60.0,
) -> Resources:
    """Mesh + comms straight from the launcher world (the
    ``build_comms_mpi`` role). A multi-process world needs
    ``RAFT_TPU_COORDINATOR=host:port`` and becomes a process mesh, one
    rank a process: on the card (NCCL), or on the CPU (gloo) when
    ``devices`` names the CPU. A single-process world builds the mesh
    over ``devices`` (default: every card)."""
    from raft_tpu_torch.comms import bootstrap
    from raft_tpu_torch.parallel import mesh as mesh_mod
    w = world if world is not None else detect_launcher()
    if w.num_processes > 1:
        expects(w.coordinator is not None,
                "launcher comms: multi-process world needs "
                "RAFT_TPU_COORDINATOR=host:port (the ncclUniqueId analogue)")
        if mesh_mod.process_world() is None:
            cpu = (devices is not None
                   and torch.device(list(devices)[0]).type == "cpu")
            bootstrap.initialize_distributed(
                w.coordinator, w.num_processes, w.process_id,
                backend="gloo" if cpu else None)
        mesh = mesh_mod.make_mesh(mesh_shape, axis_names)
        dev = mesh.devices_flat[mesh.process_rank]
    else:
        mesh = mesh_mod.make_mesh(mesh_shape, axis_names, devices)
        dev = mesh.devices_flat[0]
    res = Resources(dev, mesh=mesh)
    inject_comms(res, build_comms(mesh, axis_names[0],
                                  abort_timeout_s=abort_timeout_s))
    for ax in axis_names[1:]:
        res.set_subcomm(ax, build_comms(mesh, ax,
                                        abort_timeout_s=abort_timeout_s))
    return res
