"""snesimage-torch: the PyTorch and CUDA (Hopper) port of snesimage-tpu.

Public API:
    QuantConfig, QuantState, new_state — configuration and state of tensors
    core.pipeline.run_fused — initialize, cluster and refine in one call
    io.json_out.state_to_json — the reference-compatible output contract
"""

from snesimage_torch.config import QuantConfig
from snesimage_torch.core.state import QuantState, new_state

__version__ = "0.1.0"

__all__ = ["QuantConfig", "QuantState", "new_state", "__version__"]
