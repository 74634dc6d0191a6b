"""mxtpu_torch.contrib — the port's counterparts of ``mxtpu.contrib``
modules: ``chaos`` (the serving tier's fault injection)."""
from . import chaos

__all__ = ["chaos"]
