"""Multi-host execution (the reference's MPI analog).

The reference distributes by assigning target-DB splits to MPI ranks
and merging result files (Prefiltering::runMpiSplits,
lib/mmseqs/src/prefiltering/Prefiltering.cpp:559-600). Here the same
work distribution is expressed once in `sharded_search_step`: the
global mesh spans all hosts' devices, targets shard over the ``t``
axis, and the per-shard top-k merge is an on-device collective instead
of a filesystem merge. XLA lowers the collectives to NCCL: NVLink
between the GPUs of one host, the network between hosts.

Launch one process per host and pass the cluster explicitly (nothing
on a plain GPU host tells JAX of a cluster):

    from spacepharer_tpu.parallel.distributed import initialize
    initialize("host0:12345", num_processes=2, process_id=rank)
    mesh = make_mesh(n_query_shards=jax.process_count())
    step = sharded_search_step(mesh, top_k=...)

Data feeding follows jax.make_array_from_process_local_data: each host
loads only its target shard's SetDB slice (`shard_indices` below).
"""
import jax
import numpy as np


def initialize(coordinator_address=None, num_processes=None,
               process_id=None):
    """jax.distributed.initialize; without arguments JAX falls back to
    its cluster auto-detection (SLURM, Open MPI, ...)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
    return jax.process_index(), jax.process_count()


def shard_indices(n_items: int, n_shards: int, shard: int) -> np.ndarray:
    """Contiguous, balanced split of item indices (target ORFs per host),
    mirroring the reference's round-capacity split assignment."""
    bounds = np.linspace(0, n_items, n_shards + 1).astype(np.int64)
    return np.arange(bounds[shard], bounds[shard + 1])


def host_local_targets(target_db, n_shards: int, shard: int):
    """The ORF slice this host contributes to the global t-sharded array."""
    idx = shard_indices(target_db.n_orfs, n_shards, shard)
    from ..alphabet import encode_aa
    return [encode_aa(target_db.orf_aa(int(i)).tobytes()) for i in idx], idx
