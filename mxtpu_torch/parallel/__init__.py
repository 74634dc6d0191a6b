"""Training on one device or over a mesh of ranks: the port of
``mxtpu/parallel`` — meshes over ``torch.distributed`` (``mesh``,
``dist``), sharding rules as DTensor layouts (``sharding``), the
collectives and ``shard_map`` (``collectives``), the train step
(``step``, with the optax transforms it takes written out in torch,
``optim``), and expert, pipeline and embedding parallelism (``moe``,
``pipeline``, ``sparse_embed``). Elastic training comes with ROADMAP
Queue A item 11c."""
from . import (collectives, dist, mesh, moe, optim, pipeline, sharding,
               sparse_embed, step)
from .collectives import (allgather, allreduce, alltoall, axis_index,
                          barrier_sync, pmean, ppermute_ring, reduce_scatter,
                          shard_map)
from .mesh import (MESH_AXES, MeshConfig, axis_size, create_mesh,
                   current_mesh, mesh_axes, use_mesh)
from .sharding import (P, ShardingRules, batch_spec, constrain, named,
                       replicated, shard_pytree)
from .step import TrainState, init_state, make_eval_step, make_train_step

__all__ = ["collectives", "dist", "mesh", "moe", "optim", "pipeline",
           "sharding", "sparse_embed", "step",
           "MESH_AXES", "MeshConfig", "axis_size", "create_mesh",
           "current_mesh", "mesh_axes", "use_mesh",
           "P", "ShardingRules", "batch_spec", "constrain", "named",
           "replicated", "shard_pytree",
           "allgather", "allreduce", "alltoall", "axis_index",
           "barrier_sync", "pmean", "ppermute_ring", "reduce_scatter",
           "shard_map",
           "TrainState", "init_state", "make_eval_step", "make_train_step"]

# the reference's elastic training waits for its slice
_LATER = ("ElasticCoordinator", "ElasticError", "ElasticMember",
          "ElasticTrainer", "FusedProgram", "JournaledData", "StepProgram")


def __getattr__(name):
    if name in _LATER:
        raise AttributeError(f"mxtpu_torch.parallel.{name} comes with "
                             "ROADMAP Queue A item 11c")
    raise AttributeError(
        f"module 'mxtpu_torch.parallel' has no attribute {name!r}")
