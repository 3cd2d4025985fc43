"""Distribution on torch.distributed (port of `starst3r_tpu/parallel/`):
process-group bring-up, meshes, pair-parallel inference, Gaussian-sharded
splat training and tensor parallelism of the ViT."""

from .distributed import (initialize_distributed, pair_sharding, replicate,
                          shard_gs_state, gather_gs_state)
from .mesh import (make_mesh, local_mesh, replicated, shard_along, P,
                   NamedSharding)
from .tp import tp_param_specs, tp_shard_params
