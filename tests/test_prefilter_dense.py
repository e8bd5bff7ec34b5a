"""Parity of the dense device prefilter vs the host prefilter engine.

The dense engine must reproduce the host path *exactly*: same match
stream (order included — it feeds the order-dependent dup filter), same
final hits (target, score, diagonal). Host = prefilter_query
(QueryMatcher.cpp analog, exercised against the reference binary by the
golden suite)."""
import numpy as np
import pytest

from spacepharer_tpu.ops.matrices import load_matrix
from spacepharer_tpu.ops.bias import local_aa_bias
from spacepharer_tpu.ops.prefilter import (
    PrefilterParams, SimilarKmerEnumerator, build_target_index,
    prefilter_query)
from spacepharer_tpu.ops import prefilter as pf_mod
from spacepharer_tpu.ops.prefilter_dense import (
    build_query_batch, device_prefilter, hits_to_streams,
    match_pairs_numpy, match_pairs_device, target_boundary_valid)


def make_corpus(seed, n_targets=40, n_queries=12, plant=True):
    rng = np.random.default_rng(seed)
    targets = []
    for _ in range(n_targets):
        L = int(rng.integers(5, 120))
        s = rng.integers(0, 20, size=L).astype(np.uint8)
        # sprinkle X (masked positions)
        s[rng.random(L) < 0.05] = 20
        targets.append(s)
    queries = []
    for _ in range(n_queries):
        L = int(rng.integers(9, 14))
        q = rng.integers(0, 20, size=L).astype(np.uint8)
        queries.append(q)
    if plant:
        # plant query substrings into targets so real hits exist
        for qi, q in enumerate(queries):
            for _ in range(3):
                ti = int(rng.integers(0, n_targets))
                t = targets[ti]
                if len(t) <= len(q):
                    continue
                pos = int(rng.integers(0, len(t) - len(q)))
                t[pos:pos + len(q)] = q
    return queries, targets


def _host_hits_and_streams(queries, targets, params, enum, seed_m):
    index = build_target_index(targets, params)
    captured = []
    orig_native = pf_mod._finalize_native
    orig_py = pf_mod._finalize_py

    def cap_native(lib, m_t, m_d, index, profile, cap, params, q_num):
        captured.append((np.asarray(m_t).copy(), np.asarray(m_d).copy()))
        return orig_native(lib, m_t, m_d, index, profile, cap, params,
                           q_num)

    def cap_py(m_t, m_d, index, profile, cap, params, q_num=None):
        captured.append((np.asarray(m_t).copy(), np.asarray(m_d).copy()))
        return orig_py(m_t, m_d, index, profile, cap, params, q_num)

    pf_mod._finalize_native = cap_native
    pf_mod._finalize_py = cap_py
    try:
        hits = []
        streams = []
        for q in queries:
            n_before = len(captured)
            h = prefilter_query(np.asarray(q, np.int64), index, params,
                                enumerator=enum,
                                bias80=local_aa_bias(
                                    np.asarray(q, np.int64), seed_m))
            hits.append(h)
            if len(captured) == n_before:     # no matches -> no finalize
                captured.append((np.zeros(0, np.int64),
                                 np.zeros(0, np.int64)))
            streams.append(captured[-1])
    finally:
        pf_mod._finalize_native = orig_native
        pf_mod._finalize_py = orig_py
    return index, hits, streams


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mask", [False, True])
def test_dense_stream_and_hits_match_host(seed, mask):
    queries, targets = make_corpus(seed)
    params = PrefilterParams(mask=mask)
    seed_m = load_matrix(params.seed_matrix, 8.0)
    ungapped_m = load_matrix(params.ungapped_matrix, 2.0)
    enum = SimilarKmerEnumerator(seed_m.scores)
    index, host_hits, host_streams = _host_hits_and_streams(
        queries, targets, params, enum, seed_m)

    flat, starts = index.packed_masked()
    q_all = [np.asarray(q, np.int64) for q in queries]
    bias80 = [local_aa_bias(q, seed_m) for q in q_all]
    keys = list(range(len(queries)))

    # stream-level parity (order matters: it feeds the dup filter)
    batch = build_query_batch(q_all, keys, bias80, params)
    t_bval = target_boundary_valid(np.asarray(starts, np.int64),
                                   batch.span)
    gi, gj = match_pairs_numpy(batch, np.asarray(flat, np.uint8), t_bval,
                               seed_m.scores, params.kmer_threshold(),
                               chunk=777)
    streams = hits_to_streams(batch, gi, gj, np.asarray(flat, np.uint8),
                              np.asarray(starts, np.int64), enum)
    n_stream = 0
    for k in keys:
        m_t, m_d = streams[k]
        h_t, h_d = host_streams[k]
        np.testing.assert_array_equal(m_t, h_t, err_msg=f"m_t query {k}")
        np.testing.assert_array_equal(
            np.asarray(m_d) & 0xFFFF, np.asarray(h_d) & 0xFFFF,
            err_msg=f"m_d query {k}")
        n_stream += len(m_t)
    assert n_stream > 0, "corpus produced no matches; test is vacuous"

    # endpoint parity
    dev_hits = device_prefilter(q_all, keys, bias80, flat, starts, params,
                                enum, seed_m, ungapped_m, backend="numpy")
    for k in keys:
        got = [(h.target, h.score, h.diagonal) for h in dev_hits[k]]
        want = [(h.target, h.score, h.diagonal) for h in host_hits[k]]
        assert got == want, f"query {k}"


def test_dense_xla_backend_matches_numpy():
    queries, targets = make_corpus(7)
    params = PrefilterParams(mask=False)
    seed_m = load_matrix(params.seed_matrix, 8.0)
    q_all = [np.asarray(q, np.int64) for q in queries]
    bias80 = [local_aa_bias(q, seed_m) for q in q_all]
    keys = list(range(len(queries)))
    batch = build_query_batch(q_all, keys, bias80, params)
    flat = np.concatenate([np.asarray(t, np.uint8) for t in targets])
    starts = np.zeros(len(targets) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in targets], out=starts[1:])
    t_bval = target_boundary_valid(starts, batch.span)
    thr = params.kmer_threshold()
    gi0, gj0 = match_pairs_numpy(batch, flat, t_bval, seed_m.scores, thr)
    gi1, gj1 = match_pairs_device(batch, flat, t_bval, seed_m.scores, thr,
                                  chunk=2048, extract_b=8)
    a = sorted(zip(gi0.tolist(), gj0.tolist()))
    b = sorted(zip(gi1.tolist(), gj1.tolist()))
    assert a == b
    assert len(a) > 0


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("mask", [False, True])
def test_dense_device_chunks_match_numpy(seed, mask):
    """match_pairs_device over several chunks (each counted per tile and
    only hit tiles extracted) gives the oracle's exact match set, with
    and without tantan masking of the target."""
    queries, targets = make_corpus(seed, n_targets=24, n_queries=5)
    params = PrefilterParams(mask=mask)
    seed_m = load_matrix(params.seed_matrix, 8.0)
    q_all = [np.asarray(q, np.int64) for q in queries]
    bias80 = [local_aa_bias(q, seed_m) for q in q_all]
    keys = list(range(len(queries)))
    batch = build_query_batch(q_all, keys, bias80, params)
    flat, starts = build_target_index(targets, params).packed_masked()
    flat = np.asarray(flat, np.uint8)
    starts = np.asarray(starts, np.int64)
    t_bval = target_boundary_valid(starts, batch.span)
    thr = params.kmer_threshold()
    gi0, gj0 = match_pairs_numpy(batch, flat, t_bval, seed_m.scores, thr)
    gi1, gj1 = match_pairs_device(batch, flat, t_bval, seed_m.scores, thr,
                                  chunk=256, extract_b=8)
    assert len(flat) > 2 * 256
    a = sorted(zip(gi0.tolist(), gj0.tolist()))
    b = sorted(zip(gi1.tolist(), gj1.tolist()))
    assert a == b
    assert len(a) > 0
