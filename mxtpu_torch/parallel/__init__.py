"""One-device training: the port of ``mxtpu/parallel``'s ``step``, with
the optax transforms it takes written out in torch (``optim``). Meshes,
sharding rules and collectives come with the multi-device slice."""
from . import optim, step

__all__ = ["optim", "step"]
