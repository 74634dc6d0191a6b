"""One-device training: the port of ``mxtpu/parallel``'s ``step``, with
the optax transforms it takes written out in torch (``optim``), and the
MoE expert bank (``moe``). Meshes, sharding rules, collectives and
expert parallelism come with the multi-device slice."""
from . import moe, optim, step

__all__ = ["moe", "optim", "step"]
