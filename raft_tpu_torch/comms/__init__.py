"""Communication (counterpart of ``raft_tpu.comms``): only the health
plane's gauge parser, :func:`raft_tpu_torch.comms.health.
suspects_from_gauges`, is ported. The communicator, the bootstrap, the
host point-to-point channels and the health monitor are ROADMAP.md queue
1 item 6."""
