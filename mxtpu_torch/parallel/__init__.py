"""One-device training: the port of ``mxtpu/parallel``'s ``step``, with
the optax transforms it takes written out in torch (``optim``), the
MoE expert bank (``moe``), and the one-device subset of meshes and
sharding rules (``mesh``, ``sharding``: what ``HybridBlock.shard`` and
``Trainer.make_fused_step`` take). Meshes across cards, collectives
and expert parallelism come with the multi-device slice."""
from . import mesh, moe, optim, sharding, step
from .mesh import (MESH_AXES, MeshConfig, axis_size, create_mesh,
                   current_mesh, mesh_axes, use_mesh)
from .sharding import P, ShardingRules, batch_spec, named, replicated
from .step import TrainState, init_state, make_eval_step, make_train_step

__all__ = ["mesh", "moe", "optim", "sharding", "step",
           "MESH_AXES", "MeshConfig", "axis_size", "create_mesh",
           "current_mesh", "mesh_axes", "use_mesh",
           "P", "ShardingRules", "batch_spec", "named", "replicated",
           "TrainState", "init_state", "make_eval_step", "make_train_step"]

# the reference's other names wait for the multi-device slice
_LATER = ("constrain", "shard_pytree", "allgather", "allreduce", "alltoall",
          "axis_index", "barrier_sync", "pmean", "ppermute_ring",
          "reduce_scatter", "ElasticCoordinator", "ElasticError",
          "ElasticMember", "ElasticTrainer", "FusedProgram",
          "JournaledData", "StepProgram", "dist")


def __getattr__(name):
    if name in _LATER:
        raise AttributeError(f"mxtpu_torch.parallel.{name} comes with "
                             "ROADMAP Queue A item 11")
    raise AttributeError(
        f"module 'mxtpu_torch.parallel' has no attribute {name!r}")
