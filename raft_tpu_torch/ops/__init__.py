"""Kernel wrappers. Each module holds one hand-written CUDA kernel's
wrapper (dispatching on tensor device), its plain PyTorch version and a
plain-integer launch counter; ``_build`` compiles and loads the
kernels from ``csrc/``."""

KERNEL_MODULES = ("fused_l2_nn", "select_k", "ivf_scan")


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    import importlib
    for name in KERNEL_MODULES:
        importlib.import_module(f"raft_tpu_torch.ops.{name}").launches = 0


def launch_counts() -> dict:
    """``{module: launches}`` of every kernel wrapper."""
    import importlib
    return {name: importlib.import_module(
        f"raft_tpu_torch.ops.{name}").launches for name in KERNEL_MODULES}
