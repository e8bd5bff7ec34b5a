"""Batched Smith-Waterman scoring in plain JAX (the portable XLA scorer).

The alignment hot loop as a tensor program instead of a translation of
the SSE kernel (StripedSmithWaterman.cpp): a lax.scan over target
columns carries (H, E, best) for a whole batch of pairs at once; the
in-column F-gap propagation collapses to a cumulative max via the
affine-gap identity

    F[j] = max_k<j (H[k] - gapO - (j-k-1) gapE)
         = cummax(H[k] - gapO + gapE*(k+1))[j-1] - gapE*j

(F-through-F chains are dominated because gapO >= gapE). Scores match
the exact host engine (ops/align.py) cell for cell, including the
Farrar E-update-from-pre-F semantics, so the device can bulk-score
candidate pairs and only surviving pairs (E <= threshold) take the
exact host path for coordinates and backtraces.

It runs on any XLA backend. On a GPU the CUDA kernel (ops/sw_cuda.py)
serves the short spacer queries; this scorer takes the queries that
kernel cannot hold, and every pair on the CPU.

Layout: per-pair query profiles [B, LQ, A] and target letters [B, LT];
the substitution column is gathered on the device, so host memory stays
O(B * (LQ * A + LT)) however long the targets are. Pairs are bucketed
by target length (powers of two), so a few long ORFs never pad the rest.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(10 ** 6)
X_LETTER = 20


@partial(jax.jit, static_argnames=("gap_open", "gap_extend"))
def sw_score_batch(q_prof: jnp.ndarray, q_len: jnp.ndarray,
                   t_seqs: jnp.ndarray, t_len: jnp.ndarray,
                   gap_open: int, gap_extend: int) -> jnp.ndarray:
    """Max local alignment scores for a batch of pairs.

    q_prof: int32 [B, LQ, A] query profiles incl. bias
            (q_prof[b, j, a] = S[q_b[j]][a] + bias_b[j]).
    q_len:  int32 [B] true query lengths.
    t_seqs: int32 [B, LT] target letters; t_len: int32 [B].
    Returns int32 [B] best scores.
    """
    B, LQ, _ = q_prof.shape
    jpos = jnp.arange(LQ, dtype=jnp.int32)
    q_mask = jpos[None, :] < q_len[:, None]              # [B, LQ]
    ge = jnp.int32(gap_extend)
    go = jnp.int32(gap_open)

    def col_step(carry, letters):
        H, E, best, i = carry
        sub_col = jnp.take_along_axis(
            q_prof, letters[:, None, None], axis=2)[:, :, 0]  # [B, LQ]
        h_diag = jnp.pad(H, ((0, 0), (1, 0)))[:, :LQ]
        h_pre = jnp.maximum(jnp.maximum(h_diag + sub_col, E), 0)
        h_pre = jnp.where(q_mask, h_pre, 0)
        E2 = jnp.maximum(jnp.maximum(h_pre - go, E - ge), 0)
        # F via cumulative max (see module docstring)
        g = h_pre - go + ge * (jpos + 1)[None, :]
        cm = jax.lax.cummax(g, axis=1)
        F = jnp.pad(cm, ((0, 0), (1, 0)), constant_values=NEG)[:, :LQ] \
            - ge * jpos[None, :]
        h = jnp.maximum(h_pre, F)
        h = jnp.where(q_mask, h, 0)
        col_valid = i < t_len                             # [B]
        colmax = jnp.max(h, axis=1)
        best = jnp.where(col_valid, jnp.maximum(best, colmax), best)
        H = jnp.where(col_valid[:, None], h, H)
        E = jnp.where(col_valid[:, None], E2, E)
        return (H, E, best, i + 1), None

    H0 = jnp.zeros((B, LQ), dtype=jnp.int32)
    E0 = jnp.zeros((B, LQ), dtype=jnp.int32)
    best0 = jnp.zeros(B, dtype=jnp.int32)
    (H, E, best, _), _ = jax.lax.scan(
        col_step, (H0, E0, best0, jnp.int32(0)), jnp.swapaxes(t_seqs, 0, 1))
    return best


def query_profile(q, matrix_scores: np.ndarray, bias=None,
                  lq: int = None) -> np.ndarray:
    """int32 [lq, A] profile S[q_j][a] + bias_j; rows past len(q) = NEG."""
    q = np.asarray(q, dtype=np.int64)
    lq = lq or max(len(q), 1)
    out = np.full((lq, matrix_scores.shape[1]), NEG, dtype=np.int32)
    p = matrix_scores[q].astype(np.int32)
    if bias is not None:
        p = p + np.asarray(bias, dtype=np.int32)[:len(q), None]
    out[:len(q)] = p
    return out


def build_pair_batch(q_list, t_list, matrix_scores: np.ndarray,
                     bias_list=None, lq: int = None, lt: int = None):
    """Host-side packing: numeric seqs -> (q_prof [B, LQ, A], q_len,
    t_seqs [B, LT], t_len), the inputs of sw_score_batch.

    Padded query rows are masked by q_len and padded target columns by
    t_len inside the kernel."""
    B = len(q_list)
    lq = lq or max((len(q) for q in q_list), default=1)
    lt = lt or max((len(t) for t in t_list), default=1)
    q_prof = np.empty((B, lq, matrix_scores.shape[1]), dtype=np.int32)
    t_seqs = np.full((B, lt), X_LETTER, dtype=np.int32)
    q_len = np.zeros(B, dtype=np.int32)
    t_len = np.zeros(B, dtype=np.int32)
    for b, (q, t) in enumerate(zip(q_list, t_list)):
        q_prof[b] = query_profile(
            q, matrix_scores, None if bias_list is None else bias_list[b], lq)
        q_len[b] = len(q)
        t_len[b] = len(t)
        t_seqs[b, :len(t)] = t
    return q_prof, q_len, t_seqs, t_len


def pow2_at_least(n: int, floor: int) -> int:
    return max(floor, 1 << max(int(n) - 1, 0).bit_length())


def length_buckets(t_lens, floor: int = 256):
    """Pair indices grouped by pow2 target-length bucket:
    [(lt_pad, idx), ...], shortest bucket first."""
    t_lens = np.asarray(t_lens, dtype=np.int64)
    lt = np.array([pow2_at_least(n, floor) for n in t_lens],
                  dtype=np.int64)
    return [(int(b), np.flatnonzero(lt == b)) for b in np.unique(lt)]


def batch_size(lq_pad: int) -> int:
    """Pairs per dispatch: 512, fewer for long queries so the profile
    batch [B, LQ, A] stays a few MB."""
    return int(max(8, min(512, (512 * 64) // lq_pad)))


def fill_batch(chunk, pair_q, pair_t, profs, q_seqs, t_seqs, B, lq_pad,
               lt_pad, n_letters):
    """Padded sw_score_batch inputs for pair indices `chunk` (<= B)."""
    q_prof = np.full((B, lq_pad, n_letters), NEG, dtype=np.int32)
    q_len = np.zeros(B, dtype=np.int32)
    ts = np.full((B, lt_pad), X_LETTER, dtype=np.int32)
    t_len = np.zeros(B, dtype=np.int32)
    for b, i in enumerate(chunk):
        qi, ti = int(pair_q[i]), int(pair_t[i])
        q_prof[b] = profs[qi]
        q_len[b] = len(q_seqs[qi])
        t = t_seqs[ti]
        ts[b, :len(t)] = t
        t_len[b] = len(t)
    return q_prof, q_len, ts, t_len


def score_pairs_bucketed(pairs, q_seqs, t_seqs, matrix_scores,
                         biases=None, gap_open: int = 16, gap_extend: int = 2,
                         lq_pad: int = 32):
    """Score (query, target) index pairs with the XLA scan in buckets.

    pairs: [(q_idx, t_idx), ...]; q_seqs/t_seqs: numeric sequences;
    biases: optional per-query int bias arrays. Pairs are bucketed by
    target length (powers of two, >= 256) and padded to fixed batch
    shapes, so only a handful of kernels compile. Returns int64 scores
    aligned with ``pairs``.
    """
    if not len(pairs):
        return np.zeros(0, dtype=np.int64)
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    pair_q, pair_t = pairs[:, 0], pairs[:, 1]
    uq = np.unique(pair_q)
    lq_pad = pow2_at_least(max(len(q_seqs[qi]) for qi in uq), lq_pad)
    B = batch_size(lq_pad)
    profs = {int(qi): query_profile(
        q_seqs[qi], matrix_scores,
        None if biases is None else biases[qi], lq_pad) for qi in uq}
    out = np.zeros(len(pairs), dtype=np.int64)
    t_lens = np.array([len(t_seqs[ti]) for ti in pair_t])
    for lt_pad, idx in length_buckets(t_lens):
        for start in range(0, len(idx), B):
            chunk = idx[start:start + B]
            batch = fill_batch(chunk, pair_q, pair_t, profs, q_seqs, t_seqs,
                               B, lq_pad, lt_pad, matrix_scores.shape[1])
            scores = np.asarray(sw_score_batch(*batch, gap_open, gap_extend))
            out[chunk] = scores[:len(chunk)]
    return out
