"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""


def _wrappers() -> dict:
    # imported here: ops.paged_attention imports layers.attention, which
    # imports ops.flash_attention - a package-level import would cycle
    from paddle_tpu_torch.ops.flash_attention import (flash_bwd_dkdv_cuda,
                                                      flash_bwd_dq_cuda,
                                                      flash_fwd_cuda)
    from paddle_tpu_torch.ops.paged_attention import paged_decode_cuda
    return {"flash_fwd": flash_fwd_cuda,
            "flash_bwd_dkdv": flash_bwd_dkdv_cuda,
            "flash_bwd_dq": flash_bwd_dq_cuda,
            "paged_decode": paged_decode_cuda}


def launch_counts() -> dict:
    """Launches of each kernel so far in this process (the plain versions
    are not counted)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
