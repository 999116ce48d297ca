"""Parallelism: meshes over torch.distributed ranks, data-parallel steps and
generation, sequence-, tensor- and pipeline-parallel programs, multi-node
init (counterpart of ``edge_diffusion_tts_tpu/parallel``).

Collectives run in one process per rank over ``torch.distributed``;
data-parallel generation runs in one process over a list of devices.
``launch.spawn`` runs a function on N local ranks.
"""

from .data_parallel import (
    make_dp_consistency_step,
    make_dp_diffusion_step,
    make_dp_generate,
    make_dp_progressive_step,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from .multihost import (
    host_local_batch,
    init_multihost,
    make_pod_mesh,
)
from .pipeline_parallel import (
    PIPE_AXIS,
    PPTrainer,
    create_pp_state,
    make_pp_backbone,
    make_pp_diffusion_step,
    make_pp_trainer,
    pp_pack_params,
    pp_unpack_params,
)
from .sequence_parallel import (
    make_seq_parallel_generate,
    seq_parallel_generate,
)
from .tensor_parallel import (
    encoder_param_shardings,
    make_tp_encode,
    shard_encoder_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "PPTrainer",
    "create_pp_state",
    "make_pp_backbone",
    "make_pp_diffusion_step",
    "make_pp_trainer",
    "pp_pack_params",
    "pp_unpack_params",
    "batch_sharding",
    "make_dp_consistency_step",
    "make_dp_diffusion_step",
    "make_dp_generate",
    "make_dp_progressive_step",
    "encoder_param_shardings",
    "make_tp_encode",
    "shard_encoder_params",
    "host_local_batch",
    "init_multihost",
    "make_mesh",
    "make_pod_mesh",
    "make_seq_parallel_generate",
    "replicate",
    "seq_parallel_generate",
    "replicated",
    "shard_batch",
]
