"""TCE-RVOS in PyTorch for NVIDIA GPUs: the port of ``tce_rvos_tpu``.

Mirrors the JAX package's layout (``ops/``, ``models/``, ``utils/``,
``infer.py``, ``config.py``) and imports nothing from it. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from tce_rvos_tpu_torch.config import ModelConfig, flagship_config

__all__ = ["ModelConfig", "flagship_config"]
