"""Kernel wrappers. Each module holds hand-written CUDA kernels'
wrappers (dispatching on tensor device), their plain PyTorch versions
and plain-integer launch counters; ``_build`` compiles and loads the
kernels from ``csrc/``."""

# launch-count key -> (module, counter attribute)
KERNEL_COUNTERS = {
    "fused_l2_nn": ("fused_l2_nn", "launches"),
    "fused_l2_nn_f32": ("fused_l2_nn", "launches_f32"),
    "select_k": ("select_k", "launches"),
    "select_k_payload": ("select_k", "launches_payload"),
    "ivf_scan": ("ivf_scan", "launches"),
    "ivf_scan_bf16": ("ivf_scan", "launches_bf16"),
    "ivf_scan_int8": ("ivf_scan", "launches_int8"),
    "ivf_list_scan": ("ivf_scan", "launches_list"),
    "ivf_list_scan_bf16": ("ivf_scan", "launches_list_bf16"),
    "ivf_list_scan_int8": ("ivf_scan", "launches_list_int8"),
    "ivf_pq_scan": ("ivf_pq_scan", "launches"),
    "ivf_pq_scan_fused": ("ivf_pq_scan", "launches_fused"),
    "ivf_pq_scan_f32": ("ivf_pq_scan", "launches_f32"),
    "ivf_pq_scan_fused_f32": ("ivf_pq_scan", "launches_fused_f32"),
    "ivf_bq_scan": ("ivf_bq_scan", "launches"),
    "ivf_bq_scan_fused": ("ivf_bq_scan", "launches_fused"),
    "fused_knn": ("fused_knn", "launches"),
    "fused_knn_f32": ("fused_knn", "launches_f32"),
    "fused_knn_ktiled": ("fused_knn", "launches_ktiled"),
    "fused_knn_ktiled_f32": ("fused_knn", "launches_ktiled_f32"),
    "elementwise_dist": ("elementwise_dist", "launches"),
}


def _module(name: str):
    import importlib
    return importlib.import_module(f"raft_tpu_torch.ops.{name}")


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0 (and clear fused L2-NN's
    launches by shape)."""
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(_module(mod), attr, 0)
    _module("fused_l2_nn").shapes.clear()


def launch_counts() -> dict:
    """``{kernel: launches}`` of every kernel wrapper."""
    return {key: getattr(_module(mod), attr)
            for key, (mod, attr) in KERNEL_COUNTERS.items()}
