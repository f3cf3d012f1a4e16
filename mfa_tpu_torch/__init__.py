"""mfa_tpu_torch — the PyTorch + CUDA (Hopper, sm_90a) port of mfa_tpu.

The JAX package `mfa_tpu` stays in the repository as the reference; this
package mirrors its module names (dispatch/config.py, kernels/prefill.py,
...) so each counterpart is easy to find. Every Pallas kernel on the
ported path is a hand-written CUDA kernel (mfa_tpu_torch/csrc), built with
nvcc at first use; on CPU tensors each kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"

from mfa_tpu_torch.interface import (flash_attn_func, flash_attn_varlen_func,
                                     flash_attn_with_kvcache)

__all__ = [
    "flash_attn_func",
    "flash_attn_varlen_func",
    "flash_attn_with_kvcache",
    "__version__",
]
