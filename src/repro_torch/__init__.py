"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Same subpackages and module names as the JAX package; the hot-path kernels
are CUDA C++ written for ``sm_90a`` (``csrc/``), built at first use by
``kernels/_build.py``.  Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``.
"""
import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card.  Without a GPU, only an explicit CPU device
    is accepted: nothing quietly runs on the CPU.  ``"meta"`` (shapes and
    dtypes, no data) is what the dry run traces on (``launch/dryrun.py``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
