"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""


def _wrappers() -> dict:
    # imported here: ops.paged_attention imports layers.attention, which
    # imports ops.flash_attention - a package-level import would cycle
    from paddle_tpu_torch.ops.flash_attention import (flash_bwd_dkdv_cuda,
                                                      flash_bwd_dq_cuda,
                                                      flash_fwd_cuda)
    from paddle_tpu_torch.ops.fused_rnn import gru_step_cuda, lstm_step_cuda
    from paddle_tpu_torch.ops.paged_attention import paged_decode_cuda
    from paddle_tpu_torch.ops.conv_bn import (conv3x3_stats_cuda,
                                              matmul_stats_cuda)
    from paddle_tpu_torch.ops.fused_bn import (bn_bwd_stats_cuda,
                                               bn_fwd_stats_cuda)
    from paddle_tpu_torch.ops.flash_variants import run_fwd_cuda
    return {"flash_fwd": flash_fwd_cuda,
            "flash_bwd_dkdv": flash_bwd_dkdv_cuda,
            "flash_bwd_dq": flash_bwd_dq_cuda,
            "paged_decode": paged_decode_cuda,
            "lstm_step": lstm_step_cuda,
            "gru_step": gru_step_cuda,
            "bn_fwd_stats": bn_fwd_stats_cuda,
            "bn_bwd_stats": bn_bwd_stats_cuda,
            "matmul_stats": matmul_stats_cuda,
            "conv3x3_stats": conv3x3_stats_cuda,
            "flash_variants": run_fwd_cuda}


def launch_counts() -> dict:
    """Launches of each kernel so far in this process (the plain versions
    are not counted): ``name`` counts every launch of the wrapper, at any
    dtype; ``name_bf16`` those of its bf16 instances alone, for the
    wrappers that have them."""
    counts = {}
    for name, fn in _wrappers().items():
        counts[name] = fn.launches
        if hasattr(fn, "launches_bf16"):
            counts[name + "_bf16"] = fn.launches_bf16
    return counts


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0
