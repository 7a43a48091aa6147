"""Parallelism on `torch.distributed`: meshes, sharded indexes, the
meshed embedding exchange and pooled-negatives training.

Port of `recommenders_tpu/parallel/`. Every rank runs the same program
(SPMD): it calls the same entry points with the same arguments and gets
the same replicated result, as `shard_map`'s `out_specs=P()` gives.
`launch.run_ranks` starts the ranks.
"""

from recommenders_tpu_torch.parallel.ann import ShardedBucketed
from recommenders_tpu_torch.parallel.ann import ShardedScaNN
from recommenders_tpu_torch.parallel.corpus import ShardedBruteForce
from recommenders_tpu_torch.parallel.corpus import make_sharded_top_k
from recommenders_tpu_torch.parallel.launch import run_ranks
from recommenders_tpu_torch.parallel.mesh import DATA_AXIS
from recommenders_tpu_torch.parallel.mesh import MODEL_AXIS
from recommenders_tpu_torch.parallel.mesh import Mesh
from recommenders_tpu_torch.parallel.mesh import batch_shardings
from recommenders_tpu_torch.parallel.mesh import create_mesh
from recommenders_tpu_torch.parallel.mesh import local_data_parallel_mesh
from recommenders_tpu_torch.parallel.mesh import replicated
from recommenders_tpu_torch.parallel.mesh import shard_batch

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "PooledNegativesTrainer",
    "ShardedBruteForce",
    "ShardedBucketed",
    "ShardedScaNN",
    "create_mesh",
    "local_data_parallel_mesh",
    "make_pooled_negatives_train_step",
    "make_sharded_top_k",
    "batch_shardings",
    "replicated",
    "run_ranks",
    "shard_batch",
]


def __getattr__(name):
    # Lazy, as the JAX package's: retrieval_step imports the models
    # package, which (through the hybrid trainer -> embedding engine)
    # imports back into `parallel.embedding_lookup`; loading it here
    # would form a cycle.
    if name in ("PooledNegativesTrainer", "make_pooled_negatives_train_step"):
        from recommenders_tpu_torch.parallel import retrieval_step

        return getattr(retrieval_step, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
