"""Multi-node scaffolding: process-group init, the pod mesh, the local data
feed (counterpart of ``edge_diffusion_tts_tpu/parallel/multihost.py``).

1. ``init_multihost()`` initializes the default process group from
   ``torchrun``'s environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
   ``WORLD_SIZE``, ``LOCAL_RANK``) or from explicit arguments.  With neither
   it degrades to one process, (0, 1).  Explicit arguments never degrade:
   a missing one or a failed connect raises.
2. ``make_pod_mesh()`` lays the ranks out so that the data axis is the one
   that spans nodes, and the model and pipe axes stay inside a node: the
   gradient all-reduce amortizes over a step, the tensor- and
   pipeline-parallel collectives sit on its critical path.
3. ``host_local_batch()``: each rank feeds only the examples it loaded; the
   global batch is the ranks' local batches concatenated in rank order
   along the data axis, which is what the data-parallel steps reduce over.

Launch, e.g. on each of 2 nodes with 8 cards:
``torchrun --nnodes 2 --nproc-per-node 8 --rdzv-endpoint HOST:PORT train.py``
with ``init_multihost()`` first in the script (backend NCCL, each rank on
card ``LOCAL_RANK``).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, Mesh, make_mesh

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def default_backend(local_world_size: int) -> str:
    """NCCL when every rank of this node owns a card; anything else must
    be asked for by name (``backend="gloo"``)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    raise ValueError(
        f"{local_world_size} ranks on this node but {torch.cuda.device_count()} CUDA devices: "
        "NCCL needs a card per rank; pass backend='gloo' to run the ranks over gloo")


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: float = 1800.0,
) -> Tuple[int, int]:
    """Initialize the default process group; returns ``(rank, world_size)``.

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` name the cluster explicitly (all three); without them
    ``torchrun``'s environment does.  With neither, or when the group is
    already up and nothing explicit is asked, nothing is initialized.  The
    backend is ``backend``, else NCCL when every local rank owns a card
    (each rank then takes card ``LOCAL_RANK``).  A connect that fails
    within ``timeout`` seconds raises."""
    explicit = (coordinator_address is not None or num_processes not in (None, 1)
                or process_id is not None)
    if dist.is_available() and dist.is_initialized():
        if explicit:
            raise RuntimeError("a process group is already initialized")
        return dist.get_rank(), dist.get_world_size()
    from_env = all(k in os.environ for k in _ENV)
    if not explicit and not from_env:
        return 0, 1
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("an explicit cluster needs coordinator_address, num_processes "
                             "and process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    else:
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    backend = backend or default_backend(int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return dist.get_rank(), dist.get_world_size()


def make_pod_mesh(ici_shape: Sequence[int], axis_names: Sequence[str],
                  dcn_data_parallelism: int = 1) -> Mesh:
    """A mesh whose FIRST axis spans ``dcn_data_parallelism`` nodes.

    ``ici_shape`` is one node's layout (its product the ranks per node), e.g.
    ``make_pod_mesh((4, 2), ("data", "model"), dcn_data_parallelism=8)`` on 8
    nodes of 8 ranks gives ``{"data": 32, "model": 2}``, the model axis never
    leaving a node.  ``torchrun`` numbers ranks node by node, so the
    row-major layout keeps every line of the inner axes inside one node."""
    ici_shape, axis_names = tuple(int(s) for s in ici_shape), tuple(axis_names)
    if len(ici_shape) != len(axis_names):
        raise ValueError(f"{ici_shape} vs axis names {axis_names}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    per_node = int(np.prod(ici_shape))
    if per_node * dcn_data_parallelism != world:
        raise ValueError(f"{dcn_data_parallelism} nodes x {ici_shape} = "
                         f"{per_node * dcn_data_parallelism} ranks, the group has {world}")
    shape = (ici_shape[0] * dcn_data_parallelism,) + ici_shape[1:]
    return make_mesh(shape, axis_names)


def host_local_batch(batch: Dict[str, np.ndarray], mesh: Mesh,
                     axis: str = DATA_AXIS) -> Dict[str, torch.Tensor]:
    """This rank's own examples as its shard of the global batch (the ranks'
    local batches in rank order along ``axis``).  Every rank of the axis must
    hold the same number of rows, which is checked here."""
    out = {k: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
           for k, v in batch.items()}
    rows = {int(v.shape[0]) for v in out.values()}
    if len(rows) != 1:
        raise ValueError(f"the local batch's arrays disagree on their rows: {sorted(rows)}")
    ax = mesh.axis(axis)
    # NCCL reduces CUDA tensors only.
    nccl = ax.size > 1 and dist.get_backend(ax.group) == "nccl"
    counts = ax.all_gather(torch.tensor([rows.pop()], dtype=torch.int64,
                                        device="cuda" if nccl else "cpu"))
    if len(set(counts.tolist())) != 1:
        raise ValueError(f"the ranks of the {axis!r} axis hold {counts.tolist()} rows: "
                         "data-parallel steps need equal shards")
    return out
