"""qm_control_tpu_torch — the PyTorch/CUDA port of qm_control_tpu.

A second package beside the JAX reference (`qm_control_tpu/`), with the
same layout and function names. Plain tensor code is PyTorch (torch.func
stands in for the JAX transforms, Python loops for lax.scan); the TPU's
Pallas kernel is a CUDA kernel written by hand for Hopper
(kernels/csrc/). The port imports neither jax nor the JAX package.

Device rule: every entry point takes `device`, default "cuda". Without a
GPU it raises unless the caller passes device="cpu", where each kernel
wrapper runs its plain PyTorch version.
"""
import torch

# The control stack needs true f32 products (the IP/null-space cascade is
# ill-conditioned); the JAX package forces "highest" for the same reason.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when a CUDA device is asked for
    and none is present (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "qm_control_tpu_torch: device='cuda' requested but no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch versions")
    return dev
