"""One-device training: the port of ``mxtpu/parallel``'s ``step``, with
the optax transforms it takes written out in torch (``optim``), the
MoE expert bank (``moe``), and the one-device subset of meshes and
sharding rules (``mesh``, ``sharding``: what ``HybridBlock.shard`` and
``Trainer.make_fused_step`` take). Meshes across cards, collectives
and expert parallelism come with the multi-device slice."""
from . import mesh, moe, optim, sharding, step

__all__ = ["mesh", "moe", "optim", "sharding", "step"]
