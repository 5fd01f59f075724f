"""Model configuration of the port.

The reference package's ``ModelConfig`` is a framework-free dataclass, so
both packages read one set of options; it is re-exported here so that users
of the port import only ``coponerf_tpu_torch``.
"""

from coponerf_tpu.config import ModelConfig

__all__ = ["ModelConfig"]
