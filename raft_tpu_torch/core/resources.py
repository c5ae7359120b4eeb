"""Resources: the device and stream an entry point runs on.

Counterpart of ``raft_tpu.core.resources.Resources`` (and of
``raft::handle_t``): a ``torch.device`` plus, on CUDA, the stream work
is enqueued on, which is always PyTorch's current stream for the
device: the kernel wrappers launch there. The default device is
``cuda``; the CPU is used only when asked for. Asking for CUDA on a host without a card raises — an
entry point never drops to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from raft_tpu_torch.core.error import LogicError

DeviceLike = Union[str, torch.device, None]


class Resources:
    """Execution context: one ``torch.device`` and its stream.

    ``stream`` is the CUDA stream kernels launch on: PyTorch's current
    stream for the device, read at each access; ``None`` on the CPU.
    """

    def __init__(self, device: DeviceLike = "cuda"):
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

    @property
    def stream(self):
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device)

    def __repr__(self) -> str:
        return f"Resources(device={self.device})"


def ensure_resources(res: Optional[Resources] = None,
                     device: DeviceLike = None) -> Resources:
    """``res`` as given, else a fresh handle on ``device`` (default
    ``cuda``). Passing both with different devices is an error."""
    if res is not None:
        if device is not None and torch.device(device).type != \
                res.device.type:
            raise LogicError(
                f"ensure_resources: device={device} contradicts "
                f"res.device={res.device}")
        return res
    return Resources(device if device is not None else "cuda")
