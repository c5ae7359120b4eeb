"""Communication (counterpart of ``raft_tpu.comms``).

``Comms`` collectives over a ``parallel.mesh`` (an in-process rendezvous
of logical ranks, or ``torch.distributed`` across processes), the
in-library collective checks, session and launcher bootstrap, tagged
host p2p over an in-process registry, the ``torch.distributed`` store or
the native TCP broker, and the heartbeat health monitor.
"""

from raft_tpu_torch.comms.comms import (
    Comms,
    ReduceOp,
    Status,
    build_comms,
    inject_comms,
)
from raft_tpu_torch.comms.collective_checks import (
    test_collective_allreduce,
    test_collective_broadcast,
    test_collective_reduce,
    test_collective_allgather,
    test_collective_gather,
    test_collective_reducescatter,
    test_pointToPoint_simple_send_recv,
    test_commsplit,
)
from raft_tpu_torch.comms.bootstrap import (Session, initialize_distributed,
                                            local_handle)
from raft_tpu_torch.comms.host_p2p import HostP2P, Request
from raft_tpu_torch.comms.health import HealthMonitor, suspects_from_gauges
from raft_tpu_torch.comms.native_p2p import NativeKVClient, NativeKVServer
from raft_tpu_torch.comms.launcher import (
    LauncherWorld,
    build_launcher_resources,
    detect_launcher,
)

__all__ = [
    "Comms", "ReduceOp", "Status", "build_comms", "inject_comms",
    "test_collective_allreduce", "test_collective_broadcast",
    "test_collective_reduce", "test_collective_allgather",
    "test_collective_gather", "test_collective_reducescatter",
    "test_pointToPoint_simple_send_recv", "test_commsplit",
    "Session", "local_handle", "initialize_distributed",
    "HostP2P", "Request", "HealthMonitor", "suspects_from_gauges",
    "NativeKVClient", "NativeKVServer",
    "LauncherWorld", "build_launcher_resources", "detect_launcher",
]
