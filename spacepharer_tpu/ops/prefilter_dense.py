"""Device-resident dense k-mer prefilter (the device QueryMatcher).

The reference prefilter is output-sensitive CPU code: per query k-mer it
*enumerates* the similar-k-mer set (KmerGenerator.cpp:186-), walks a
hash/CSR postings index (IndexTable.h:25-38) and streams (target,
diagonal) matches into the dup filter (QueryMatcher.cpp:84-323). That
shape — pointer-chasing over an index — is what a wide vector machine
does worst.

This module re-derives the same match set *densely on the tensor
cores*:

    K[i, j] = sum_p S80[q[i + off_p], t[j + off_p]]      (6 spaced offsets)

is a single matmul  K = Qexp @ Texp^T  with

    Qexp[i, p*21 + a] = S80[q[i + off_p], a]   (host-built, bf16-exact:
                                                |S80| <= 127 < 256)
    Texp[j, p*21 + a] = [t[j + off_p] == a]    (device-built one-hot)

whose contraction dim is 6*21 = 126 ~ 128 — a natural matrix-unit
shape. The bf16 x bf16 products summed in f32 are exact: each product
is an integer of magnitude <= 127 (one operand is one-hot), and of the
126 terms at most 6 are nonzero (|K| <= 762), so no rounding and no
summation order can change K. A target position j matches query k-mer
i iff

    K[i, j] >= thr_i           (thr_i = max(kmerThr - bias_i, 0),
                                QueryMatcher.cpp:205-219)
    and j is a *valid indexed* k-mer: self-score >= kmerThr, no X at
    the informative offsets, and the 8-residue span stays inside one
    target ORF (IndexBuilder.cpp:54-257 skip rules).

The index's "one posting per (code, seq) at its first position"
(IndexTable.h:341-) becomes a dedup over extracted hits, and the
reference's exact match-stream order — k-mer position ascending, then
KmerGenerator enumeration order (half-1 rank, half-2 rank), then
sequence ascending — is reconstructed per hit from the enumerator's
half-list ranks. The stream then feeds the *existing exact host
finalize* (dup filter with its bin-state leak + ungapped diagonal
rescore + histogram/max_seqs selection), so the output is byte-identical
to the host engine by construction.

Consequence: the device path needs NO postings index at all — only the
tantan-masked flat target — so a fresh-index search skips the postings
build entirely (the dominant host cost at scale).

Backends: "numpy" (oracle, tests) and "xla" (the device engine, plain
jit on any XLA backend): hit counts per (query tile, target tile), then
only the tiles with hits are re-masked in batches and cross to the host
as bit-packed masks (1 bit per cell), where their coordinates are
read off — work proportional to the number of hit tiles. (jnp.nonzero
on the device measured ~40x slower on the H100: PERF.md.)"""
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..logging import log
from .bias import round_half_away

X_IDX = 20
THR_INVALID = 1 << 30
TILE_Q = 128   # k-mer rows per tile
TILE_T = 128   # target positions per tile
KDIM = 128     # padded contraction dim (6 * 21 = 126 used)


@dataclass
class QueryKmerBatch:
    """Flat-packed query k-mers of a key subset (host-side prep)."""
    keys: list
    q_flat: np.ndarray      # uint8 [NQ + span - 1] (X-padded tail)
    q_starts: np.ndarray    # int64 [len(keys) + 1] offsets into q_flat
    kmer_thr: np.ndarray    # int32 [NQ] per-position threshold
    kmer_valid: np.ndarray  # bool  [NQ]
    span: int
    offsets: np.ndarray
    n_rows: int             # NQ (k-mer start positions incl. invalid)


def build_query_batch(q_all, keys, bias80_all, params) -> QueryKmerBatch:
    """Pack the selected query ORFs into one flat k-mer batch.

    Validity/threshold semantics mirror prefilter_query: no X at the
    informative offsets, the last k-mer position of every ORF dropped
    (the indexTo quirk, CacheFriendlyOperations.cpp:43-46 +
    QueryMatcher.cpp:289-293), thr_i = max(kmerThr - biasK_i, 0)."""
    offsets = np.asarray(params.offsets)
    span = params.pattern_span
    kmer_thr = params.kmer_threshold()
    lens = [len(q_all[k]) for k in keys]
    starts = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    nq = int(starts[-1])
    q_flat = np.full(nq + span - 1, X_IDX, dtype=np.uint8)
    thr = np.full(nq, THR_INVALID, dtype=np.int32)
    valid = np.zeros(nq, dtype=bool)
    for ki, k in enumerate(keys):
        q = np.asarray(q_all[k], dtype=np.int64)
        L = len(q)
        q_flat[starts[ki]:starts[ki] + L] = q
        n_kmers = L - span + 1
        if n_kmers <= 0:
            continue
        v = np.ones(n_kmers, dtype=bool)
        for off in offsets:
            v &= q[off:off + n_kmers] != X_IDX
        v[n_kmers - 1] = False
        kpos = np.flatnonzero(v)
        if len(kpos) == 0:
            continue
        kbias = round_half_away(
            np.asarray(bias80_all[k])[kpos[:, None]
                                      + offsets[None, :]].sum(axis=1))
        thr[starts[ki] + kpos] = np.maximum(kmer_thr - kbias, 0)
        valid[starts[ki] + kpos] = True
    return QueryKmerBatch(keys=list(keys), q_flat=q_flat, q_starts=starts,
                          kmer_thr=thr, kmer_valid=valid, span=span,
                          offsets=offsets, n_rows=nq)


def build_qexp(batch: QueryKmerBatch, seed_scores: np.ndarray,
               pad_rows: int) -> np.ndarray:
    """Qexp[i, p*21+a] = S80[q[i+off_p], a], float32 [pad_rows, KDIM].

    Pad rows keep thr = THR_INVALID so they can never match."""
    assert int(np.abs(seed_scores).max()) < 256, \
        "seed matrix exceeds the bf16-exact integer range"
    out = np.zeros((pad_rows, KDIM), dtype=np.float32)
    s = seed_scores.astype(np.float32)
    n = batch.n_rows
    for p, off in enumerate(batch.offsets):
        out[:n, p * 21:(p + 1) * 21] = s[batch.q_flat[off:off + n]]
    return out


def target_boundary_valid(t_starts: np.ndarray, span: int) -> np.ndarray:
    """bool [t_res]: position j starts a k-mer fully inside one ORF.

    (The flat target has no separators; k-mers spanning two ORFs never
    exist in the reference index.)"""
    n = int(t_starts[-1])
    valid = np.ones(n, dtype=bool)
    s0 = np.asarray(t_starts[:-1], dtype=np.int64)
    s1 = np.asarray(t_starts[1:], dtype=np.int64)
    for o in range(1, span):
        idx = s1 - o
        ok = idx >= s0
        valid[idx[ok]] = False
    return valid


def match_pairs_numpy(batch: QueryKmerBatch, t_flat: np.ndarray,
                      t_bval: np.ndarray, seed_scores: np.ndarray,
                      kmer_thr: int, chunk: int = 1 << 16):
    """Oracle: all (gi, gj) with K >= thr_i over valid positions."""
    span = batch.span
    offsets = batch.offsets
    self_scores = np.diag(seed_scores).astype(np.int64)
    qexp = build_qexp(batch, seed_scores, batch.n_rows)
    thr = batch.kmer_thr.astype(np.float32)
    t_res = len(t_flat)
    gis, gjs = [], []
    for c0 in range(0, t_res, chunk):
        c1 = min(c0 + chunk, t_res)
        n = c1 - c0
        win = np.full(n + span - 1, X_IDX, dtype=np.uint8)
        avail = min(c1 + span - 1, t_res) - c0
        win[:avail] = t_flat[c0:c0 + avail]
        self_sc = np.zeros(n, dtype=np.int64)
        has_x = np.zeros(n, dtype=bool)
        texp = np.zeros((n, KDIM), dtype=np.float32)
        for p, off in enumerate(offsets):
            col = win[off:off + n]
            self_sc += self_scores[col]
            has_x |= col == X_IDX
            texp[np.arange(n), p * 21 + col] = 1.0
        tval = (self_sc >= kmer_thr) & ~has_x & t_bval[c0:c1]
        K = qexp @ texp.T
        mask = (K >= thr[:, None]) & tval[None, :]
        gi, gj = np.nonzero(mask)
        gis.append(gi.astype(np.int64))
        gjs.append(gj.astype(np.int64) + c0)
    if not gis:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(gis), np.concatenate(gjs)


# ---------------------------------------------------------------------------
# device backends
# ---------------------------------------------------------------------------

_JIT_CACHE = {}


def _device_prep_fn(span: int, offsets: tuple, kmer_thr: int):
    """jit: chunk letters -> (Texp tiles [ntt, TILE_T, KDIM] bf16,
    tval tiles [ntt, TILE_T] bool). Runs once per target chunk."""
    import jax
    import jax.numpy as jnp
    key = ("prep", span, offsets, kmer_thr)
    fn = _JIT_CACHE.get(key)
    if fn is not None:
        return fn

    @jax.jit
    def f(letters, bval, diag21):
        # letters int32 [C + span - 1]; bval bool [C]; C % TILE_T == 0
        C = letters.shape[0] - (span - 1)
        iota21 = jax.lax.broadcasted_iota(jnp.int32, (C, 21), 1)
        ohs = []
        self_sc = jnp.zeros((C,), dtype=jnp.float32)
        has_x = jnp.zeros((C,), dtype=jnp.bool_)
        diag_f = diag21.astype(jnp.float32)
        for off in offsets:
            col = jax.lax.dynamic_slice(letters, (off,), (C,))
            oh = iota21 == col[:, None]                    # [C, 21]
            ohs.append(oh.astype(jnp.bfloat16))
            self_sc = self_sc + (oh * diag_f[None, :]).sum(axis=1)
            has_x = has_x | oh[:, X_IDX]
        ohs.append(jnp.zeros((C, KDIM - 21 * len(offsets)), jnp.bfloat16))
        texp = jnp.concatenate(ohs, axis=1)                # [C, KDIM]
        tval = (self_sc >= kmer_thr) & ~has_x & bval
        # tval tiles [ntt, 1, TT]; the counts broadcast it against
        # their [ntt, TT, TQ] masks
        return (texp.reshape(C // TILE_T, TILE_T, KDIM),
                tval.reshape(C // TILE_T, 1, TILE_T))

    _JIT_CACHE[key] = f
    return f


def _extract_fn(B: int):
    """jit: hit masks of B (query-tile, target-tile) pairs, bit-packed
    (uint8 [B, TQ, TT / 8]): the tiles are gathered and re-masked on
    the device, and only 1 bit per cell crosses to the host. Slots at or
    past `n_valid` are pad (all zero)."""
    import jax
    import jax.numpy as jnp
    key = ("extract", B)
    fn = _JIT_CACHE.get(key)
    if fn is not None:
        return fn

    @jax.jit
    def f(qexp, thr, texp_tiles, tval_tiles, q_tile_idx, t_tile_idx,
          n_valid):
        rows = (q_tile_idx[:, None] * TILE_Q
                + jnp.arange(TILE_Q)[None, :])             # [B, TQ]
        qe = qexp[rows]                                    # [B, TQ, KDIM]
        th = thr[rows, 0]                                  # [B, TQ]
        tx = texp_tiles[t_tile_idx]                        # [B, TT, KDIM]
        tv = tval_tiles[t_tile_idx]                        # [B, 1, TT]
        K = jax.lax.dot_general(
            qe, tx, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)            # [B, TQ, TT]
        live = (jnp.arange(B) < n_valid)[:, None, None]
        return jnp.packbits((K >= th[:, :, None]) & tv & live, axis=-1)

    _JIT_CACHE[key] = f
    return f


def _unpack_hits(packed):
    """(slot, row, col) of the set bits of a [B, TQ, TT / 8] uint8 mask,
    touching only its nonzero bytes."""
    b, i, byte = np.nonzero(packed)
    bits = np.unpackbits(packed[b, i, byte][:, None], axis=1)  # MSB first
    k, bit = np.nonzero(bits)
    return b[k], i[k], byte[k].astype(np.int64) * 8 + bit


def _counts_xla_fn():
    """jit: per-tile hit counts int32 [ntt, nqt] in plain XLA. A loop
    over query tiles bounds the f32 K block to [C, TILE_Q]; XLA's dot
    writes it to device memory and the compare-and-count reads it back
    (a fused Pallas-on-Triton counts kernel measured slower: PERF.md)."""
    import jax
    import jax.numpy as jnp
    fn = _JIT_CACHE.get("counts_xla")
    if fn is not None:
        return fn

    @jax.jit
    def f(qexp, thr, texp_tiles, tval_tiles):
        nqt = qexp.shape[0] // TILE_Q
        valid = jnp.swapaxes(tval_tiles, 1, 2)              # [ntt, TT, 1]

        def one_query_tile(args):
            q, th = args                                    # [TQ, KDIM], [TQ]
            K = jax.lax.dot_general(
                texp_tiles, q, (((2,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)         # [ntt, TT, TQ]
            return jnp.sum((K >= th[None, None, :]) & valid, axis=(1, 2),
                           dtype=jnp.int32)                 # [ntt]

        counts = jax.lax.map(one_query_tile,
                             (qexp.reshape(nqt, TILE_Q, KDIM),
                              thr.reshape(nqt, TILE_Q)))    # [nqt, ntt]
        return counts.T

    _JIT_CACHE["counts_xla"] = f
    return f


def default_chunk(pad_rows: int = TILE_Q) -> int:
    """Target positions per device chunk: the largest power of two whose
    working set stays under 1 GB of the 80 GB card. Per position: the
    one-hot Texp row (256 B, bf16 x 128) plus one query tile's K column
    and mask (5 B x TILE_Q). Chunks stream, so a bigger chunk only saves
    dispatches; powers of two let runs share compiled shapes."""
    per_pos = 2 * KDIM + 5 * TILE_Q
    chunk = TILE_T
    while 2 * chunk * per_pos <= (1 << 30):
        chunk *= 2
    return chunk


def match_pairs_device(batch: QueryKmerBatch, t_flat: np.ndarray,
                       t_bval: np.ndarray, seed_scores: np.ndarray,
                       kmer_thr: int, chunk: Optional[int] = None,
                       extract_b: int = 2048):
    """(gi, gj) match pairs via the device: per-tile hit counts, then
    bit-packed masks of the tiles with hits only."""
    import jax.numpy as jnp
    span = batch.span
    offsets = tuple(int(o) for o in batch.offsets)
    # pow2 q-tile bucket: query batches share a few compiled shapes
    nqt = 1
    while nqt * TILE_Q < batch.n_rows:
        nqt *= 2
    pad_rows = nqt * TILE_Q
    qexp_np = build_qexp(batch, seed_scores, pad_rows)
    thr_np = np.full((pad_rows, 1), float(THR_INVALID), dtype=np.float32)
    thr_np[:batch.n_rows, 0] = batch.kmer_thr.astype(np.float32)
    qexp = jnp.asarray(qexp_np, dtype=jnp.bfloat16)
    thr = jnp.asarray(thr_np)
    diag21 = jnp.asarray(np.diag(seed_scores).astype(np.int32))
    prep = _device_prep_fn(span, offsets, int(kmer_thr))

    t_res = len(t_flat)
    if chunk is None:
        chunk = default_chunk(pad_rows)
    chunk = max((chunk // TILE_T) * TILE_T, TILE_T)
    # pow2 tile bucket so small runs don't pay the full-chunk pad
    C = TILE_T
    while C < min(t_res, chunk):
        C *= 2
    C = min(C, chunk)
    gis, gjs = [], []
    for c0 in range(0, t_res, C):
        letters_np = np.full(C + span - 1, X_IDX, dtype=np.int32)
        avail = min(c0 + C + span - 1, t_res) - c0
        letters_np[:avail] = t_flat[c0:c0 + avail]
        bval_np = np.zeros(C, dtype=bool)
        bn = min(c0 + C, t_res) - c0
        bval_np[:bn] = t_bval[c0:c0 + bn]
        texp_tiles, tval_tiles = prep(jnp.asarray(letters_np),
                                      jnp.asarray(bval_np), diag21)
        counts = _counts_xla_fn()(qexp, thr, texp_tiles, tval_tiles)
        ti_idx, qi_idx = np.nonzero(np.asarray(counts))
        for lo in range(0, len(ti_idx), extract_b):
            hi = min(lo + extract_b, len(ti_idx))
            qsel = np.zeros(extract_b, dtype=np.int32)
            tsel = np.zeros(extract_b, dtype=np.int32)
            qsel[:hi - lo] = qi_idx[lo:hi]
            tsel[:hi - lo] = ti_idx[lo:hi]
            packed = np.asarray(_extract_fn(extract_b)(
                qexp, thr, texp_tiles, tval_tiles, jnp.asarray(qsel),
                jnp.asarray(tsel), np.int32(hi - lo)))
            bsel, ii, jj = _unpack_hits(packed)
            gis.append(ii.astype(np.int64)
                       + qi_idx[lo + bsel].astype(np.int64) * TILE_Q)
            gjs.append(jj + ti_idx[lo + bsel].astype(np.int64) * TILE_T + c0)
    if not gis:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    gi = np.concatenate(gis)
    gj = np.concatenate(gjs)
    keep = (gi < batch.n_rows) & (gj < t_res)
    return gi[keep], gj[keep]


# ---------------------------------------------------------------------------
# reference-order stream reconstruction + finalize
# ---------------------------------------------------------------------------

def hits_to_streams(batch: QueryKmerBatch, gi, gj, t_flat, t_starts,
                    enumerator) -> dict:
    """Map (gi, gj) pairs to per-query (m_t, m_d) match streams in the
    reference's exact emission order: k-mer position ascending, then
    KmerGenerator enumeration order — (half-1 rank, half-2 rank) under
    each half-list's (score desc, code asc) sort (KmerGenerator.cpp:
    186-) — then target sequence ascending; one entry per (code, seq)
    at its first target position (IndexTable.h:341- unique-insert)."""
    offsets = batch.offsets
    half = enumerator.half
    out = {}
    if len(gi) == 0:
        return {k: (np.zeros(0, np.int64), np.zeros(0, np.int64))
                for k in batch.keys}
    order = np.argsort(gi, kind="stable")
    gi = gi[order]
    gj = gj[order]
    t_seq = np.searchsorted(t_starts, gj, side="right") - 1
    t_pos = gj - t_starts[t_seq]
    letters = t_flat[gj[:, None] + offsets[None, :]].astype(np.int64)
    c1 = letters[:, 0] * 400 + letters[:, 1] * 20 + letters[:, 2]
    c2 = letters[:, 3] * 400 + letters[:, 4] * 20 + letters[:, 5]
    bounds = np.searchsorted(gi, batch.q_starts)
    for ki, k in enumerate(batch.keys):
        lo, hi = bounds[ki], bounds[ki + 1]
        if lo == hi:
            out[k] = (np.zeros(0, np.int64), np.zeros(0, np.int64))
            continue
        i_local = gi[lo:hi] - batch.q_starts[ki]
        s1 = t_seq[lo:hi]
        p1 = t_pos[lo:hi]
        cc1 = c1[lo:hi]
        cc2 = c2[lo:hi]
        r1 = np.empty(hi - lo, dtype=np.int64)
        r2 = np.empty(hi - lo, dtype=np.int64)
        qf = batch.q_flat
        for i in np.unique(i_local):
            sel = i_local == i
            g0 = int(batch.q_starts[ki] + i)
            kl = qf[g0 + offsets].astype(np.int64)
            r1[sel] = enumerator.half_rank(kl[:half])[cc1[sel]]
            r2[sel] = enumerator.half_rank(kl[half:])[cc2[sel]]
        srt = np.lexsort((p1, s1, r2, r1, i_local))
        i_s, r1_s, r2_s, seq_s, pos_s = (i_local[srt], r1[srt], r2[srt],
                                         s1[srt], p1[srt])
        first = np.ones(len(srt), dtype=bool)
        first[1:] = ((i_s[1:] != i_s[:-1]) | (r1_s[1:] != r1_s[:-1])
                     | (r2_s[1:] != r2_s[:-1]) | (seq_s[1:] != seq_s[:-1]))
        m_t = seq_s[first]
        m_d = (i_s[first] - pos_s[first]) & 0xFFFF
        out[k] = (m_t, m_d)
    return out


def device_prefilter(q_all, keys, bias80_all, t_flat_masked, t_starts,
                     params, enumerator, seed_m, ungapped_m,
                     backend: str = "xla",
                     chunk: Optional[int] = None) -> dict:
    """Full device prefilter: {key: [PrefilterHit]} byte-identical to
    prefilter_query (the match set/stream is exact; the dup filter,
    diagonal rescore and max_seqs selection run in the existing host
    finalize on the reconstructed stream)."""
    from .prefilter import (TargetIndex, _finalize_native, _finalize_py,
                            ungapped_profile_cap)
    from ..native import get_lib

    t_flat_masked = np.ascontiguousarray(t_flat_masked, dtype=np.uint8)
    t_starts = np.asarray(t_starts, dtype=np.int64)
    t_bval = target_boundary_valid(t_starts, params.pattern_span)
    kmer_thr = params.kmer_threshold()
    kwargs = {} if chunk is None else {"chunk": chunk}

    # query-side chunking: at catalog scale (10^5-10^6 query ORFs) one
    # flat Qexp would be GBs; keys stream through the device in
    # residue-bounded groups instead (the query-split analog of the
    # reference's MPI query ranks), and every group reuses one compiled
    # query-tile shape. Per-key output is unaffected.
    MAX_Q_ROWS = 1 << 15
    key_chunks = []
    cur, cur_rows = [], 0
    for k in keys:
        n = len(q_all[k])
        if cur and cur_rows + n > MAX_Q_ROWS:
            key_chunks.append(cur)
            cur, cur_rows = [], 0
        cur.append(k)
        cur_rows += n
    if cur or not key_chunks:
        key_chunks.append(cur)

    streams = {}
    t_match = t_streams = 0.0
    n_hits = 0
    for kchunk in key_chunks:
        t0 = time.perf_counter()
        batch = build_query_batch(q_all, kchunk, bias80_all, params)
        if backend == "numpy":
            gi, gj = match_pairs_numpy(batch, t_flat_masked, t_bval,
                                       seed_m.scores, kmer_thr, **kwargs)
        else:
            gi, gj = match_pairs_device(batch, t_flat_masked, t_bval,
                                        seed_m.scores, kmer_thr, **kwargs)
        t1 = time.perf_counter()
        streams.update(hits_to_streams(batch, gi, gj, t_flat_masked,
                                       t_starts, enumerator))
        t_match += t1 - t0
        t_streams += time.perf_counter() - t1
        n_hits += len(gi)
    t0 = time.perf_counter()

    # finalize needs the masked sequences (rescoring) but no postings
    n_seqs = len(t_starts) - 1
    shim = TargetIndex(
        seqs_masked=[t_flat_masked[t_starts[i]:t_starts[i + 1]]
                     for i in range(n_seqs)],
        seq_lengths=np.diff(t_starts),
        post_seq=np.zeros(0, np.int32), post_pos=np.zeros(0, np.uint16),
        uniq_codes=np.zeros(0, np.int64), uniq_start=np.zeros(1, np.int64),
        uniq_letters=np.zeros((0, params.kmer_size), np.int8),
        db_residues=int(t_starts[-1]),
        flat_masked=t_flat_masked, masked_starts=t_starts)
    lib = get_lib()
    out = {}
    for k in keys:
        m_t, m_d = streams[k]
        if len(m_t) == 0:
            out[k] = []
            continue
        profile, cap = ungapped_profile_cap(
            np.asarray(q_all[k], dtype=np.int64), bias80_all[k], ungapped_m)
        q_num = np.asarray(q_all[k], dtype=np.int64)
        if lib is not None:
            out[k] = _finalize_native(lib, m_t, m_d, shim, profile, cap,
                                      params, q_num)
        else:
            out[k] = _finalize_py(m_t, m_d, shim, profile, cap, params,
                                  q_num)
    log(2, f"dense prefilter: match {t_match:.3f}s ({n_hits} hits), "
           f"streams {t_streams:.3f}s, finalize "
           f"{time.perf_counter() - t0:.3f}s")
    return out
