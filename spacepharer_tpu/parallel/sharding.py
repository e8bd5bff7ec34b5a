"""Device-mesh sharding of the search step.

Device translation of the reference's split modes (SURVEY.md §2.3):
the target ORF database shards across the mesh's ``t`` axis (the
analog of target-DB splits, Prefiltering.cpp:709-740) and query
batches ride the ``q`` axis (query splits / MPI ranks). The per-split
filesystem merge (Prefiltering::mergeTargetSplits) becomes an
on-device top-k + all-gather, which XLA hands to NCCL over NVLink.
The GPUs of one host are joined all to all, so the (q, t) mesh shape
follows the algorithm, not a physical topology.

All functions are pure and jit-able over a jax.sharding.Mesh; with one
device they degrade to the single-device path.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_query_shards: int = 1, n_target_shards: int = None,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_target_shards is None:
        n_target_shards = n // n_query_shards
    dev_grid = np.asarray(devices).reshape(n_query_shards, n_target_shards)
    return Mesh(dev_grid, axis_names=("q", "t"))


def sharded_search_step(mesh: Mesh, top_k: int = 8):
    """Build a jitted sharded scoring step.

    step(q_prof, q_len, t_seqs, t_len) -> (scores, idx):
      q_prof: int32 [Q, LQ, A]  per-position query profiles (q-sharded)
      q_len:  int32 [Q]
      t_seqs: int32 [T, LT]     target sequences, numeric (t-sharded)
      t_len:  int32 [T]
    Computes all-pairs SW scores [Q, T], takes global top-k per query.
    The (Q x T) score matrix is materialized only shard-locally;
    the cross-shard merge is a collective top-k.
    """
    @partial(jax.jit,
             in_shardings=(NamedSharding(mesh, P("q", None, None)),
                           NamedSharding(mesh, P("q")),
                           NamedSharding(mesh, P("t", None)),
                           NamedSharding(mesh, P("t"))),
             out_shardings=(NamedSharding(mesh, P("q", None)),
                            NamedSharding(mesh, P("q", None))))
    def step(q_prof, q_len, t_seqs, t_len):
        scores = sw_score_allpairs(q_prof, q_len, t_seqs, t_len, 16, 2)
        top_scores, top_idx = jax.lax.top_k(scores, top_k)
        return top_scores, top_idx

    return step


@partial(jax.jit, static_argnames=("gap_open", "gap_extend"))
def sw_score_allpairs(q_prof, q_len, t_seqs, t_len,
                      gap_open: int, gap_extend: int):
    """All-pairs SW scores [Q, T] without materializing the pair tensor.

    One lax.scan over target columns; the per-column substitution slice
    sub[q, j, t] = q_prof[q, j, t_seqs[t, i]] is gathered on the fly.
    State rides [Q, LQ, T] with T on the lane dimension. Semantics match
    ops.align._forward_pass / ops.sw_tpu.sw_score_batch cell for cell.
    """
    Q, LQ, A = q_prof.shape
    T, LT = t_seqs.shape
    go = jnp.int32(gap_open)
    ge = jnp.int32(gap_extend)
    jpos = jnp.arange(LQ, dtype=jnp.int32)
    q_mask = (jpos[None, :] < q_len[:, None])[:, :, None]    # [Q, LQ, 1]
    NEG = jnp.int32(-(10 ** 6))

    def col_step(carry, xs):
        H, E, best, i = carry          # H,E: [Q, LQ, T]; best: [Q, T]
        letters = xs                   # [T] column letters
        sub_col = jnp.take(q_prof, letters, axis=2)          # [Q, LQ, T]
        h_diag = jnp.pad(H, ((0, 0), (1, 0), (0, 0)))[:, :LQ, :]
        h_pre = jnp.maximum(jnp.maximum(h_diag + sub_col, E), 0)
        h_pre = jnp.where(q_mask, h_pre, 0)
        E2 = jnp.maximum(jnp.maximum(h_pre - go, E - ge), 0)
        g = h_pre - go + (ge * (jpos + 1))[None, :, None]
        cm = jax.lax.cummax(g, axis=1)
        F = jnp.pad(cm, ((0, 0), (1, 0), (0, 0)),
                    constant_values=NEG)[:, :LQ, :] - (ge * jpos)[None, :, None]
        h = jnp.where(q_mask, jnp.maximum(h_pre, F), 0)
        col_valid = (i < t_len)[None, :]                     # [1, T]
        best = jnp.where(col_valid, jnp.maximum(best, h.max(axis=1)), best)
        keep = col_valid[:, None, :]
        H = jnp.where(keep, h, H)
        E = jnp.where(keep, E2, E)
        return (H, E, best, i + 1), None

    H0 = jnp.zeros((Q, LQ, T), dtype=jnp.int32)
    E0 = jnp.zeros((Q, LQ, T), dtype=jnp.int32)
    best0 = jnp.zeros((Q, T), dtype=jnp.int32)
    (_, _, best, _), _ = jax.lax.scan(
        col_step, (H0, E0, best0, jnp.int32(0)), t_seqs.T)
    return best


def sharded_search_pipeline(mesh: Mesh, top_k: int, n_sets: int,
                            n_qsets: int = 0):
    """Jitted full sharded search step: per-shard all-pairs SW, global
    top-k merge over the ``t`` axis (the reference's per-split result
    merge, Prefiltering.h:49 mergeTargetSplits, as an on-device
    collective), best-hit-per-target-set aggregation (multihit/
    besthitperset.cpp as segment_max + pmax), and — when ``n_qsets`` is
    given — the combinescore-shaped query-set aggregation
    (CombineScore.cpp:41-98's exceedance sum re-expressed as a
    segment_sum over the sharded ``q`` axis + psum collective; query
    sets may span q shards, so this exercises cross-shard aggregation).

    step(q_prof, q_len, t_seqs, t_len, set_of_t[, set_of_q]) ->
      (top_scores [Q, k], top_idx [Q, k] global target ids,
       best_per_set [Q, n_sets][, combined [n_qsets, n_sets]]).
    """
    def _core(q_prof, q_len, t_seqs, t_len, set_of_t):
        scores = sw_score_allpairs(q_prof, q_len, t_seqs, t_len, 16, 2)
        t_local = t_seqs.shape[0]
        sc, idx = jax.lax.top_k(scores, top_k)
        idx = idx + jax.lax.axis_index("t") * t_local
        sc_all = jax.lax.all_gather(sc, "t", axis=1, tiled=True)
        idx_all = jax.lax.all_gather(idx, "t", axis=1, tiled=True)
        sc2, pos = jax.lax.top_k(sc_all, top_k)
        idx2 = jnp.take_along_axis(idx_all, pos, axis=1)
        best_set = jax.ops.segment_max(
            scores.T, set_of_t, num_segments=n_sets,
            indices_are_sorted=False).T          # [Q_local, n_sets]
        best_set = jnp.maximum(best_set, 0)
        best_set = jax.lax.pmax(best_set, "t")
        return sc2, idx2, best_set

    def local_step(q_prof, q_len, t_seqs, t_len, set_of_t):
        return _core(q_prof, q_len, t_seqs, t_len, set_of_t)

    def local_step_agg(q_prof, q_len, t_seqs, t_len, set_of_t, set_of_q):
        sc2, idx2, best_set = _core(q_prof, q_len, t_seqs, t_len,
                                    set_of_t)
        # combinescore analog: per (query set, target set), the sum of
        # member best-hit exceedances above the threshold (0 here —
        # best_set is already floored). Members of one query set may
        # live on different q shards: segment_sum locally, psum across
        # the mesh's q axis.
        comb = jax.ops.segment_sum(best_set, set_of_q,
                                   num_segments=n_qsets,
                                   indices_are_sorted=False)
        comb = jax.lax.psum(comb, "q")
        return sc2, idx2, best_set, comb

    if n_qsets:
        f = jax.shard_map(
            local_step_agg, mesh=mesh,
            in_specs=(P("q", None, None), P("q"), P("t", None), P("t"),
                      P("t"), P("q")),
            out_specs=(P("q", None), P("q", None), P("q", None),
                       P(None, None)),
            check_vma=False)
    else:
        f = jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(P("q", None, None), P("q"), P("t", None), P("t"),
                      P("t")),
            out_specs=(P("q", None), P("q", None), P("q", None)),
            check_vma=False)
    return jax.jit(f)


def pack_queries(q_list, matrix_scores, lq, bias_list=None):
    """Queries -> per-position profiles [Q, LQ, A] (int32) + lengths."""
    A = matrix_scores.shape[0]
    Q = len(q_list)
    prof = np.full((Q, lq, A), -(10 ** 6), dtype=np.int32)
    q_len = np.zeros(Q, dtype=np.int32)
    for i, q in enumerate(q_list):
        q = np.asarray(q, dtype=np.int64)[:lq]
        q_len[i] = len(q)
        p = matrix_scores[q].astype(np.int32)
        if bias_list is not None:
            p = p + np.asarray(bias_list[i], dtype=np.int32)[:len(q), None]
        prof[i, :len(q)] = p
    return prof, q_len


def pack_targets(t_list, lt, x_index: int):
    T = len(t_list)
    seqs = np.full((T, lt), x_index, dtype=np.int32)
    t_len = np.zeros(T, dtype=np.int32)
    for i, t in enumerate(t_list):
        t = np.asarray(t, dtype=np.int64)[:lt]
        t_len[i] = len(t)
        seqs[i, :len(t)] = t
    return seqs, t_len
