"""XLA batched SW scorer vs the exact host engine."""
import numpy as np
import pytest

from spacepharer_tpu.ops.align import _forward_pass
from spacepharer_tpu.ops.matrices import load_matrix
from spacepharer_tpu.ops.sw_tpu import build_pair_batch, sw_score_batch


def _random_pairs(rng, n, lq_range, lt_range):
    qs = [rng.integers(0, 20, rng.integers(*lq_range)) for _ in range(n)]
    ts = [rng.integers(0, 20, rng.integers(*lt_range)) for _ in range(n)]
    return qs, ts


def test_sw_batch_matches_host_engine():
    rng = np.random.default_rng(7)
    m = load_matrix("VTML40.out", 2.0)
    qs, ts = _random_pairs(rng, 24, (5, 24), (10, 120))
    batch = build_pair_batch(qs, ts, m.scores)
    scores = np.asarray(sw_score_batch(*batch, 16, 2))
    for b in range(len(qs)):
        ref_sub = m.scores[qs[b]].astype(np.int64)[:, ts[b]].T
        ref, _, _ = _forward_pass(ref_sub, 16, 2)
        assert scores[b] == ref, f"pair {b}: {scores[b]} != {ref}"


def test_sw_batch_with_bias():
    rng = np.random.default_rng(11)
    m = load_matrix("VTML40.out", 2.0)
    qs, ts = _random_pairs(rng, 16, (8, 20), (30, 80))
    biases = [rng.integers(-3, 4, len(q)) for q in qs]
    batch = build_pair_batch(qs, ts, m.scores, biases)
    scores = np.asarray(sw_score_batch(*batch, 16, 2))
    for b in range(len(qs)):
        prof = m.scores[qs[b]].astype(np.int64) + biases[b][:, None]
        ref, _, _ = _forward_pass(prof[:, ts[b]].T, 16, 2)
        assert scores[b] == ref


def test_allpairs_matches_batch():
    from spacepharer_tpu.parallel.sharding import (
        pack_queries, pack_targets, sw_score_allpairs)
    rng = np.random.default_rng(3)
    m = load_matrix("VTML40.out", 2.0)
    qs = [rng.integers(0, 20, rng.integers(6, 16)) for _ in range(6)]
    ts = [rng.integers(0, 20, rng.integers(20, 60)) for _ in range(9)]
    q_prof, q_len = pack_queries(qs, m.scores, 16)
    t_seqs, t_len = pack_targets(ts, 64, x_index=20)
    scores = np.asarray(sw_score_allpairs(q_prof, q_len, t_seqs, t_len, 16, 2))
    for qi in range(len(qs)):
        for ti in range(len(ts)):
            ref_sub = m.scores[qs[qi]].astype(np.int64)[:, ts[ti]].T
            ref, _, _ = _forward_pass(ref_sub, 16, 2)
            assert scores[qi, ti] == ref, (qi, ti)
