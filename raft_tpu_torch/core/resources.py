"""Resources: the device and stream an entry point runs on.

Counterpart of ``raft_tpu.core.resources.Resources`` (and of
``raft::handle_t``): a ``torch.device`` plus, on CUDA, the stream work
is enqueued on, which is always PyTorch's current stream for the
device: the kernel wrappers launch there. The default device is
``cuda``; the CPU is used only when asked for. Asking for CUDA on a host without a card raises — an
entry point never drops to the CPU on its own.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from raft_tpu_torch.core.error import LogicError

DeviceLike = Union[str, torch.device, None]


class Resources:
    """Execution context: one ``torch.device`` and its stream, and the
    JAX package's mesh and communicator slots.

    ``stream`` is the CUDA stream kernels launch on: PyTorch's current
    stream for the device, read at each access; ``None`` on the CPU.
    ``mesh`` is the one given (``parallel.mesh.Mesh``), else a one-rank
    mesh over ``device``; ``set_comms``/``get_comms`` and
    ``set_subcomm``/``get_subcomm`` hold the communicators
    (``comms.inject_comms``).
    """

    def __init__(self, device: DeviceLike = "cuda", mesh=None):
        dev = torch.device(device if device is not None else "cuda")
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise LogicError(
                    "Resources: CUDA device requested but torch sees no "
                    "GPU; pass device='cpu' to run on the CPU")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise LogicError(f"Resources: unsupported device {dev}")
        self.device = dev
        self._mesh = mesh
        self._comms = None
        self._subcomms: dict = {}
        self._lock = threading.Lock()

    @property
    def mesh(self):
        """The device mesh; lazily a one-rank mesh over ``device``."""
        with self._lock:
            if self._mesh is None:
                from raft_tpu_torch.parallel.mesh import Mesh
                self._mesh = Mesh([self.device], ("data",))
            return self._mesh

    def set_mesh(self, mesh) -> None:
        with self._lock:
            self._mesh = mesh

    # -- comms slot (reference handle.hpp:239-264) --------------------------
    def set_comms(self, comms) -> None:
        self._comms = comms

    def get_comms(self):
        if self._comms is None:
            raise LogicError("ERROR: communicator was not initialized\n")
        return self._comms

    @property
    def comms_initialized(self) -> bool:
        return self._comms is not None

    def set_subcomm(self, key: str, comms) -> None:
        self._subcomms[key] = comms

    def get_subcomm(self, key: str):
        if key not in self._subcomms:
            raise LogicError(
                f"ERROR: subcommunicator {key} was not initialized\n")
        return self._subcomms[key]

    @property
    def stream(self):
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device)

    def __repr__(self) -> str:
        return f"Resources(device={self.device})"


_default: Optional[Resources] = None
_default_lock = threading.Lock()


def default_resources() -> Resources:
    """Process-default resources on ``cuda`` (created on first use)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Resources()
        return _default


def ensure_resources(res: Optional[Resources],
                     device: DeviceLike = None) -> Resources:
    """``res`` as given, else a handle on ``device``, else
    :func:`default_resources`. Passing both with different device
    types is an error."""
    if res is not None:
        if device is not None and torch.device(device).type != \
                res.device.type:
            raise LogicError(
                f"ensure_resources: device={device} contradicts "
                f"res.device={res.device}")
        return res
    return Resources(device) if device is not None else default_resources()


def resources_for(x, res: Optional[Resources] = None) -> Resources:
    """The handle an entry point given the input ``x`` runs on: ``res``
    if given, else the device of ``x`` when it is a tensor, else
    :func:`default_resources` (``cuda``). A tensor on one device type
    with ``res`` on another is an error."""
    if isinstance(x, torch.Tensor):
        return ensure_resources(res, x.device)
    return ensure_resources(res)
