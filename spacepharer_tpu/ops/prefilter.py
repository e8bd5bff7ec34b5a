"""k-mer prefilter: spaced-seed index, similar-k-mer matching, ungapped
diagonal rescoring, per-query candidate selection.

Parity targets (see docs/SEARCH_SEMANTICS.md):
  IndexBuilder::fillDatabase     (index construction + tantan masking)
  QueryMatcher::match/matchQuery (k-mer matching + thresholds)
  KmerGenerator                  (similar k-mer set = exact threshold set)
  UngappedAlignment              (diagonal rescoring with VTML40@2)

This engine is vectorized NumPy, organized so the hot pieces
(unique-code scoring, diagonal rescoring) are batched array ops; the
native batch driver (native/search_native.c) runs the same walk in C,
and ops/prefilter_dense.py recomputes the match set on the device.
"""
import os

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .bias import local_aa_bias, round_half_away
from .matrices import ScoringMatrix, load_matrix
from .tantan import likelihood_ratios, mask_sequences_batch

X_IDX = 20  # X in the 21-letter matrix alphabet


@dataclass
class PrefilterParams:
    kmer_size: int = 6
    spaced_pattern: str = "11011101"
    sensitivity: float = 5.7
    # The reference INTENDS 1500 (PredictMatch.cpp:15 "maxSequences =
    # 1500") but that assigns the clustering --max-sequences member,
    # not the prefilter's maxResListLen (--max-seqs, Parameters.cpp:
    # 2084), so its prefilter actually runs with the DEFAULT 300 —
    # empirically confirmed at flagship scale (prot_result rows/query
    # cap at exactly 300). Byte parity requires the effective value.
    max_seqs: int = 300
    min_diag_score: int = 15
    mask: bool = True
    comp_bias_corr: bool = True
    seed_matrix: str = "VTML80.out"
    ungapped_matrix: str = "VTML40.out"
    kmer_score: Optional[int] = None  # override kmer threshold
    # RAM budget (MB) for the target index; 0 = monolithic. When the
    # estimated index exceeds it, the target DB streams through
    # RAM-bounded splits with a per-query hit merge (the setupSplit /
    # mergeTargetSplits analog, Prefiltering.cpp:258, Prefiltering.h:49)
    split_memory_limit: int = 0
    # iterative sensitivity search (blastp.sh:24-99 STEPS loop /
    # Search.cpp --start-sens/--sens-steps): step sensitivities run
    # from start_sens to sensitivity; queries with >= 2 alignments
    # stop early, stragglers continue to the next (more sensitive) step
    start_sens: float = 4.0
    sens_steps: int = 1
    # k-mer matching engine ("host" = index walk, prefilter_query;
    # "device" = dense matrix-product matching, ops/prefilter_dense.py,
    # needs no postings index; "auto" = device when an accelerator is
    # attached and the workload amortizes it). Output is byte-identical
    # either way.
    engine: str = "auto"

    @property
    def offsets(self) -> np.ndarray:
        offs = np.flatnonzero(np.frombuffer(
            self.spaced_pattern.encode(), dtype=np.uint8) == ord("1"))
        if len(offs) != self.kmer_size:
            raise ValueError("spaced pattern weight must equal k-mer size")
        return offs

    @property
    def pattern_span(self) -> int:
        return len(self.spaced_pattern)

    def kmer_threshold(self) -> int:
        """Prefiltering::getKmerThreshold (Prefiltering.cpp:987-1020)."""
        if self.kmer_score is not None:
            return self.kmer_score
        base_by_k = {5: (160.75, 12.75), 6: (163.2, 8.917), 7: (186.15, 11.22)}
        base, slope = base_by_k[self.kmer_size]
        return int(np.float32(base) - np.float32(self.sensitivity) * np.float32(slope))


@dataclass
class TargetIndex:
    """Device/host representation of the searchable target side.

    Postings are stored CSR-style by unique k-mer code (the IndexTable
    layout, lib/mmseqs/src/prefiltering/IndexTable.h:25-38): uniq_codes
    [U] sorted, uniq_start [U+1] offsets, post_seq/post_pos the entries
    (one per (code, seq) at its first position, u16 position like the
    reference's packed entry)."""
    seqs_masked: list                 # list of uint8 arrays (matrix alphabet, masked)
    seq_lengths: np.ndarray
    post_seq: np.ndarray              # int32 [P]
    post_pos: np.ndarray              # uint16 [P]
    uniq_codes: np.ndarray            # int64 [U]
    uniq_start: np.ndarray            # int64 [U+1] offsets into postings
    uniq_letters: np.ndarray          # int8 [U, k] decomposed letters
    db_residues: int                  # total residues (unmasked lengths)
    flat_masked: Optional[np.ndarray] = None   # uint8 concat of seqs_masked
    masked_starts: Optional[np.ndarray] = None  # int64 [n+1]

    @property
    def n_postings(self) -> int:
        return len(self.post_seq)

    def packed_masked(self):
        """(flat uint8, starts int64) of the masked target sequences —
        the layout the native finalize kernel consumes."""
        if self.flat_masked is None:
            starts = np.zeros(len(self.seqs_masked) + 1, dtype=np.int64)
            np.cumsum([len(s) for s in self.seqs_masked], out=starts[1:])
            self.flat_masked = (
                np.ascontiguousarray(np.concatenate(self.seqs_masked),
                                     dtype=np.uint8)
                if len(starts) > 1 and starts[-1] else np.zeros(0, np.uint8))
            self.masked_starts = starts
        return self.flat_masked, self.masked_starts


def _spaced_codes(seq_num: np.ndarray, offsets: np.ndarray, span: int,
                  alphabet: int):
    """codes[i] for i in 0..L-span; valid = no X at informative offsets.

    Streaming over shifted views (no [n, k] letter matrix), so flat
    multi-megabase passes stay cache-friendly.
    """
    L = len(seq_num)
    n = L - span + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
    codes = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for off in offsets:
        col = seq_num[off:off + n]
        codes *= alphabet
        codes += col
        valid &= col != X_IDX
    return codes, valid


def build_target_index(aa_seqs: list, params: PrefilterParams,
                       packed=None) -> TargetIndex:
    """aa_seqs: list of numeric target ORFs (matrix alphabet, unmasked).

    packed: optional (flat uint8, offsets int64 [n+1]) holding the same
    sequences contiguously (e.g. SetDB.orf_aa_encoded()) — skips the
    per-sequence concatenation on the native path."""
    seed_m = load_matrix(params.seed_matrix, 8.0)
    offsets = params.offsets
    span = params.pattern_span
    kmer_thr = params.kmer_threshold()
    self_scores = np.diag(seed_m.scores).astype(np.int64)
    if packed is not None:
        db_residues = int(packed[1][-1])
        n_seqs = len(packed[1]) - 1
    else:
        db_residues = int(sum(len(s) for s in aa_seqs))
        n_seqs = len(aa_seqs)

    from ..native import get_lib
    lib = get_lib()
    if lib is not None and n_seqs:
        # one flat pass: concatenate unmasked, mask in place, scan
        # per-sequence windows in C (no separator buffer needed)
        if packed is not None:
            starts = np.ascontiguousarray(packed[1], dtype=np.int64)
            flat8 = packed[0].astype(np.uint8)   # copy; masked in place
        else:
            starts = np.zeros(n_seqs + 1, dtype=np.int64)
            np.cumsum([len(s) for s in aa_seqs], out=starts[1:])
            flat8 = np.concatenate(
                [np.asarray(s, dtype=np.uint8) for s in aa_seqs]) \
                if db_residues else np.zeros(0, np.uint8)
        if params.mask:
            from .tantan import (DECAY, MAX_CYCLE, MIN_MASK_PROB,
                                 REPEAT_END_PROB, REPEAT_PROB)
            ratios_c = np.ascontiguousarray(
                likelihood_ratios(seed_m), dtype=np.float64)
            mask = np.zeros(len(flat8), dtype=np.uint8)
            lib.tantan_mask_batch(
                flat8.ctypes.data, starts.ctypes.data, n_seqs,
                ratios_c.ctypes.data, ratios_c.shape[1],
                MAX_CYCLE, REPEAT_PROB, REPEAT_END_PROB, DECAY,
                MIN_MASK_PROB, mask.ctypes.data)
            flat8[mask.view(bool)] = X_IDX
        masked_seqs = [flat8[starts[i]:starts[i + 1]]
                       for i in range(n_seqs)]
        offs32 = np.ascontiguousarray(offsets, dtype=np.int32)
        self32 = np.zeros(32, dtype=np.int32)
        self32[:len(self_scores)] = self_scores
        out_code, out_seq, out_pos, out_uniq = \
            _postings_scratch(max(len(flat8), 1))
        n = -2
        n_uniq = np.zeros(1, dtype=np.int64)
        if (n_seqs < (1 << 21)
                and int(np.diff(starts).max(initial=0)) <= 0xFFFF):
            # v3 emits the uniq-code boundaries in the same pass, so no
            # host boundary scan over the postings is needed
            n = lib.build_postings_v3(
                flat8.ctypes.data, len(flat8),
                offs32.ctypes.data, len(offs32), span,
                starts.ctypes.data, n_seqs,
                self32.ctypes.data, int(kmer_thr), X_IDX,
                out_code.ctypes.data, out_seq.ctypes.data,
                out_pos.ctypes.data, out_uniq.ctypes.data,
                n_uniq.ctypes.data)
        if n >= 0:
            nu = int(n_uniq[0])
            uniq_start = out_uniq[:nu + 1].astype(np.int64) \
                if n else np.zeros(1, dtype=np.int64)
            uniq_codes = out_code[uniq_start[:-1]].astype(np.int64) \
                if n else np.zeros(0, dtype=np.int64)
        else:  # packed-key preconditions unmet or mmap failure
            n = lib.build_postings(
                flat8.ctypes.data, len(flat8),
                offs32.ctypes.data, len(offs32), span,
                starts.ctypes.data, n_seqs,
                self32.ctypes.data, int(kmer_thr), X_IDX,
                out_code.ctypes.data, out_seq.ctypes.data,
                out_pos.ctypes.data)
            # boundary pass over int32 views (the scratch buffers
            # recycle across builds; only the exact-size index arrays
            # pay first-touch, seconds/GB on this host)
            cv = out_code[:n]
            ustart = (np.flatnonzero(
                np.concatenate(([True], cv[1:] != cv[:-1])))
                if n else np.zeros(0, dtype=np.int64))
            uniq_codes = cv[ustart].astype(np.int64)
            uniq_start = np.concatenate([ustart, [n]]).astype(np.int64)
        post_seq = out_seq[:n].copy()
        post_pos = out_pos[:n].astype(np.uint16)
        return _finish_index(masked_seqs, post_seq, post_pos,
                             uniq_codes, uniq_start, params, db_residues,
                             packed_masked=(flat8, starts))

    if params.mask:
        ratios = likelihood_ratios(seed_m)
        masked_all = mask_sequences_batch(
            [np.asarray(s, dtype=np.int64) for s in aa_seqs], ratios, X_IDX,
            bucket_size=2048)
    else:
        masked_all = [np.asarray(s, dtype=np.int64) for s in aa_seqs]

    masked_seqs = masked_all

    # flat pass over all sequences at once: concatenate with X spacers so
    # no k-mer spans two sequences, then recover (seq, pos) per k-mer
    if n_seqs:
        sep = np.full(span - 1, X_IDX, dtype=np.int64)
        parts = []
        for ms in masked_all:
            parts.append(ms)
            parts.append(sep)
        flat = np.concatenate(parts[:-1]) if parts else np.zeros(0, np.int64)
        seq_starts = np.zeros(n_seqs + 1, dtype=np.int64)
        np.cumsum([len(ms) + span - 1 for ms in masked_all],
                  out=seq_starts[1:])
        codes_f, valid_f = _spaced_codes(flat, offsets, span, 20)
        if len(codes_f):
            gpos = np.flatnonzero(valid_f)
            kself = np.zeros(len(gpos), dtype=np.int64)
            for off in offsets:
                kself += self_scores[flat[gpos + off]]
            gpos = gpos[kself >= kmer_thr]
            sid = np.searchsorted(seq_starts, gpos, side="right") - 1
            pos = gpos - seq_starts[sid]
            kcodes = codes_f[gpos]
            # first occurrence per (seq, code): stable sort on the fused
            # (seq, code) key — positions are already ascending per seq
            K = np.int64(20) ** span  # > any code
            fused = sid * K + kcodes
            order = np.argsort(fused, kind="stable")
            f_sorted = fused[order]
            first = np.concatenate(([True], f_sorted[1:] != f_sorted[:-1]))
            keep = order[first]
            codes = kcodes[keep]
            post_seq = sid[keep].astype(np.int32)
            post_pos = pos[keep].astype(np.int32)
        else:
            codes = np.zeros(0, dtype=np.int64)
            post_seq = np.zeros(0, dtype=np.int32)
            post_pos = np.zeros(0, dtype=np.int32)
    else:
        codes = np.zeros(0, dtype=np.int64)
        post_seq = np.zeros(0, dtype=np.int32)
        post_pos = np.zeros(0, dtype=np.int32)
    # final postings order: (code, seq, pos); pos is unique per (code, seq)
    order = np.argsort(codes * np.int64(len(aa_seqs) + 1)
                       + post_seq.astype(np.int64), kind="stable") \
        if len(codes) else np.zeros(0, dtype=np.int64)
    codes, post_seq, post_pos = codes[order], post_seq[order], post_pos[order]
    n = len(codes)
    ustart = (np.flatnonzero(np.concatenate(([True], codes[1:] != codes[:-1])))
              if n else np.zeros(0, dtype=np.int64))
    uniq_codes = codes[ustart]
    uniq_start = np.concatenate([ustart, [n]]).astype(np.int64)
    return _finish_index(masked_seqs, post_seq,
                         post_pos.astype(np.uint16), uniq_codes,
                         uniq_start, params, db_residues)


def index_cache_key(params: PrefilterParams) -> str:
    """Content key of everything the index depends on."""
    import hashlib
    s = (f"{params.kmer_size}|{params.spaced_pattern}|"
         f"{params.kmer_threshold()}|{int(params.mask)}|"
         f"{params.seed_matrix}|v2")
    return hashlib.sha256(s.encode()).hexdigest()[:16]


def save_target_index(index: TargetIndex, setdb_path: str,
                      params: PrefilterParams) -> str:
    """Persist a TargetIndex inside a SetDB directory (the MMseqs
    `createindex` analog: a precomputed .idx keyed by the prefilter
    parameters)."""
    import json as _json
    d = os.path.join(setdb_path, f"index_{index_cache_key(params)}")
    os.makedirs(d, exist_ok=True)
    flat_masked, starts = index.packed_masked()
    np.save(os.path.join(d, "flat_masked.npy"), flat_masked)
    np.save(os.path.join(d, "starts.npy"), starts)
    for name in ("post_seq", "post_pos", "uniq_codes",
                 "uniq_start", "uniq_letters", "seq_lengths"):
        np.save(os.path.join(d, name + ".npy"), getattr(index, name))
    with open(os.path.join(d, "meta.json"), "w") as fh:
        _json.dump({"db_residues": index.db_residues}, fh)
    return d


class LazySlices:
    """List-like view of per-sequence slices over (flat, starts):
    slicing 10^5+ sequences out of an mmapped flat eagerly costs
    seconds of view-object churn per index load at flagship scale;
    consumers index or iterate, so slices materialize on touch."""

    __slots__ = ("_flat", "_starts")

    def __init__(self, flat, starts):
        self._flat = flat
        self._starts = starts

    def __len__(self):
        return len(self._starts) - 1

    def __getitem__(self, i):
        return self._flat[self._starts[i]:self._starts[i + 1]]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def load_target_index(setdb_path: str,
                      params: PrefilterParams) -> Optional[TargetIndex]:
    """Load a persisted index if one matches the prefilter parameters.
    Arrays are mmapped read-only; only the touched postings page in."""
    import json as _json
    d = os.path.join(setdb_path, f"index_{index_cache_key(params)}")
    if not os.path.exists(os.path.join(d, "meta.json")):
        return None
    with open(os.path.join(d, "meta.json")) as fh:
        meta = _json.load(fh)
    arr = {name: np.load(os.path.join(d, name + ".npy"), mmap_mode="r")
           for name in ("flat_masked", "starts", "post_seq",
                        "post_pos", "uniq_codes", "uniq_start",
                        "uniq_letters", "seq_lengths")}
    starts = arr["starts"]
    flat = arr["flat_masked"]
    seqs_masked = LazySlices(flat, starts)
    return TargetIndex(
        seqs_masked=seqs_masked, seq_lengths=arr["seq_lengths"],
        post_seq=arr["post_seq"],
        post_pos=arr["post_pos"], uniq_codes=arr["uniq_codes"],
        uniq_start=arr["uniq_start"], uniq_letters=arr["uniq_letters"],
        db_residues=int(meta["db_residues"]),
        flat_masked=flat, masked_starts=np.asarray(starts, dtype=np.int64),
    )


def persisted_index_exists(setdb_path: str, params: PrefilterParams) -> bool:
    d = os.path.join(setdb_path, f"index_{index_cache_key(params)}")
    return os.path.exists(os.path.join(d, "meta.json"))


def build_masked_flat(aa_seqs, params: PrefilterParams, packed=None):
    """(flat uint8, starts int64) of the tantan-masked target — the
    IndexBuilder masking stage (IndexBuilder.cpp:139-149) without the
    postings build. This is ALL the target-side state the dense device
    prefilter needs (ops/prefilter_dense.py)."""
    seed_m = load_matrix(params.seed_matrix, 8.0)
    if packed is not None:
        starts = np.ascontiguousarray(packed[1], dtype=np.int64)
        flat8 = packed[0].astype(np.uint8)      # copy; masked in place
        n_seqs = len(starts) - 1
    else:
        n_seqs = len(aa_seqs)
        starts = np.zeros(n_seqs + 1, dtype=np.int64)
        np.cumsum([len(s) for s in aa_seqs], out=starts[1:])
        flat8 = (np.concatenate(
            [np.asarray(s, dtype=np.uint8) for s in aa_seqs])
            if n_seqs and starts[-1] else np.zeros(0, np.uint8))
    if params.mask and len(flat8):
        from ..native import get_lib
        lib = get_lib()
        if lib is not None:
            from .tantan import (DECAY, MAX_CYCLE, MIN_MASK_PROB,
                                 REPEAT_END_PROB, REPEAT_PROB)
            ratios_c = np.ascontiguousarray(
                likelihood_ratios(seed_m), dtype=np.float64)
            mask = np.zeros(len(flat8), dtype=np.uint8)
            lib.tantan_mask_batch(
                flat8.ctypes.data, starts.ctypes.data, n_seqs,
                ratios_c.ctypes.data, ratios_c.shape[1],
                MAX_CYCLE, REPEAT_PROB, REPEAT_END_PROB, DECAY,
                MIN_MASK_PROB, mask.ctypes.data)
            flat8[mask.view(bool)] = X_IDX
        else:
            ratios = likelihood_ratios(seed_m)
            masked = mask_sequences_batch(
                [flat8[starts[i]:starts[i + 1]].astype(np.int64)
                 for i in range(n_seqs)], ratios, X_IDX, bucket_size=2048)
            flat8 = (np.concatenate(masked).astype(np.uint8)
                     if n_seqs else flat8)
    return flat8, starts


def mask_cache_key(params: PrefilterParams) -> str:
    """Content key of the masked-flat cache (mask params only — the
    postings threshold does not affect masking)."""
    import hashlib
    s = f"{int(params.mask)}|{params.seed_matrix}|tantan-v1"
    return hashlib.sha256(s.encode()).hexdigest()[:16]


def save_masked_flat(flat8, starts, setdb_path: str,
                     params: PrefilterParams) -> str:
    d = os.path.join(setdb_path, f"mask_{mask_cache_key(params)}")
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "flat_masked.npy"), flat8)
    np.save(os.path.join(d, "starts.npy"), starts)
    return d


def load_masked_flat(setdb_path: str, params: PrefilterParams):
    """Masked flat target from any persisted cache: the dedicated mask
    cache, else a persisted full index (which embeds the same arrays).
    Arrays are mmapped read-only. Returns (flat, starts) or None."""
    d = os.path.join(setdb_path, f"mask_{mask_cache_key(params)}")
    if os.path.exists(os.path.join(d, "starts.npy")):
        return (np.load(os.path.join(d, "flat_masked.npy"), mmap_mode="r"),
                np.load(os.path.join(d, "starts.npy"), mmap_mode="r"))
    di = os.path.join(setdb_path, f"index_{index_cache_key(params)}")
    if os.path.exists(os.path.join(di, "meta.json")):
        return (np.load(os.path.join(di, "flat_masked.npy"), mmap_mode="r"),
                np.load(os.path.join(di, "starts.npy"), mmap_mode="r"))
    return None


_POSTINGS_SCRATCH = {"cap": 0}


def _postings_scratch(cap: int):
    """Grow-only scratch buffers for the native postings builder —
    recycled so repeated index builds (easy-predict builds two) don't
    re-pay first-touch page faults (pathological on this host class)."""
    s = _POSTINGS_SCRATCH
    if s["cap"] < cap:
        s["code"] = np.empty(cap, dtype=np.int32)
        s["seq"] = np.empty(cap, dtype=np.int32)
        s["pos"] = np.empty(cap, dtype=np.int32)
        s["uniq"] = np.empty(cap + 1, dtype=np.int64)
        s["cap"] = cap
    return s["code"], s["seq"], s["pos"], s["uniq"]


def release_postings_scratch():
    """Free the Python scratch buffers and the native radix arena —
    for callers done with index building (e.g. after a split-mode
    sweep) that want the RAM back."""
    _POSTINGS_SCRATCH.clear()
    _POSTINGS_SCRATCH["cap"] = 0
    from ..native import get_lib
    lib = get_lib()
    if lib is not None:
        lib.postings_free_arena()


def _finish_index(masked_seqs, post_seq, post_pos, uniq_codes, uniq_start,
                  params, db_residues, packed_masked=None) -> TargetIndex:
    """CSR postings (final (code, seq) order) -> TargetIndex."""
    # decompose unique codes into letters
    k = params.kmer_size
    letters = np.zeros((len(uniq_codes), k), dtype=np.int8)
    tmp = uniq_codes.copy()
    for kk in range(k - 1, -1, -1):
        letters[:, kk] = tmp % 20
        tmp //= 20
    idx = TargetIndex(
        seqs_masked=masked_seqs,
        seq_lengths=np.array([len(s) for s in masked_seqs], dtype=np.int64),
        post_seq=post_seq, post_pos=post_pos,
        uniq_codes=uniq_codes, uniq_start=uniq_start, uniq_letters=letters,
        db_residues=db_residues,
    )
    if packed_masked is not None:
        idx.flat_masked = np.ascontiguousarray(packed_masked[0],
                                               dtype=np.uint8)
        idx.masked_starts = np.ascontiguousarray(packed_masked[1],
                                                 dtype=np.int64)
    return idx


def ungapped_diagonal_score(profile: np.ndarray, tseq: np.ndarray,
                            diag: int) -> int:
    """Max local segment sum along one diagonal.

    profile: [Lq, A] int per-position scores (substitution + aaCorr).
    diag = i - j (query pos minus target pos), signed.
    Mirrors UngappedAlignment::scalarDiagonalScoring + the diagonal
    offset logic (UngappedAlignment.cpp:368-382).
    """
    lq = profile.shape[0]
    lt = len(tseq)
    if diag >= 0:
        if diag >= lq:
            return 0
        ln = min(lt, lq - diag)
        scores = profile[diag:diag + ln, :][np.arange(ln), tseq[:ln]]
    else:
        md = -diag
        if md >= lt:
            return 0
        ln = min(lt - md, lq)
        scores = profile[:ln, :][np.arange(ln), tseq[md:md + ln]]
    run = 0
    best = 0
    # vectorized max-subarray-ending-here via cumulative min trick
    c = np.cumsum(scores)
    running_min = np.minimum.accumulate(np.concatenate([[0], c]))[:-1]
    best = int(np.max(c - running_min, initial=0))
    return best


class SimilarKmerEnumerator:
    """Output-sensitive similar-k-mer enumeration (KmerGenerator analog).

    Splits the 6-mer into two 3-mer halves; per half caches all 20^3
    candidate half-codes ordered by (score desc, code asc) — the exact
    enumeration order of calculateArrayProduct (KmerGenerator.cpp:186-).
    Enumerating {t : score >= thr} is then two searchsorted calls plus a
    repeat-expansion, O(|result|) instead of O(#index codes).
    """

    def __init__(self, seed_scores: np.ndarray, half: int = 3):
        self.s80 = seed_scores
        self.half = half
        self.n_half = 20 ** half
        self.cache = {}
        self.rank_cache = {}
        self.full_scores = None  # [20^3, 20^3] int16, precomputed table
        self.full_codes = None

    def precompute_all(self):
        """Materialize every 3-mer's sorted half list at once — the
        reference's ExtendedSubstitutionMatrix startup table
        (lib/mmseqs/src/commons/ExtendedSubstitutionMatrix.cpp), ~256MB.
        Opt-in for long-running services; the lazy radix-sorted cache
        (~0.1ms/miss, <=8000 misses) wins for one-shot runs. int16 is
        exact: half scores are bounded by 3*max|S| << 2^15 and half
        codes by 20^3."""
        if self.full_scores is not None:
            return
        n = self.n_half
        scores = np.empty((n, n), dtype=np.int16)
        codes = np.empty((n, n), dtype=np.int16)
        base = self.s80[:20, :20].astype(np.int32)
        row = 0
        for a in range(20):
            for b in range(20):
                sab = base[a][:, None, None] + base[b][None, :, None]
                for c in range(20):
                    s = (sab + base[c][None, None, :]).reshape(-1)
                    # int16 key -> NumPy radix sort, O(n) and stable
                    order = np.argsort((-s).astype(np.int16), kind="stable")
                    scores[row] = s[order]
                    codes[row] = order
                    row += 1
        self.full_scores = scores
        self.full_codes = codes

    def half_list(self, tri):
        if self.full_scores is not None and tri.max() < 20:
            row = int(tri[0]) * 400 + int(tri[1]) * 20 + int(tri[2])
            return self.full_scores[row], self.full_codes[row]
        key = bytes(tri)
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        s = self.s80[tri[0], :20].astype(np.int32)[:, None, None] \
            + self.s80[tri[1], :20][None, :, None] \
            + self.s80[tri[2], :20][None, None, :]
        s = s.reshape(-1)
        # stable argsort on -s == (score desc, code asc), the
        # calculateArrayProduct order; int16 key selects radix sort
        order = np.argsort((-s).astype(np.int16), kind="stable")
        entry = (s[order], order.astype(np.int64))
        self.cache[key] = entry
        return entry

    def half_rank(self, tri) -> np.ndarray:
        """rank[c] = position of half-code c in this half's enumeration
        order (score desc, code asc) — the inverse permutation of
        half_list's code order. Used to reconstruct the reference's
        match-stream emission order from dense device hits."""
        key = bytes(np.asarray(tri, dtype=np.int64))
        r = self.rank_cache.get(key)
        if r is None:
            _, codes = self.half_list(np.asarray(tri, dtype=np.int64))
            r = np.empty(self.n_half, dtype=np.int32)
            r[np.asarray(codes, dtype=np.int64)] = np.arange(
                self.n_half, dtype=np.int32)
            self.rank_cache[key] = r
        return r

    def enumerate(self, kmer_letters: np.ndarray, thr: int):
        """All 6-mer codes scoring >= thr vs kmer, in reference order."""
        s1, c1 = self.half_list(kmer_letters[:self.half])
        s2, c2 = self.half_list(kmer_letters[self.half:])
        if s1[0] + s2[0] < thr:
            return np.zeros(0, dtype=np.int64)
        n1 = int(np.searchsorted(-s1, -(thr - s2[0]), side="right"))
        n2 = np.searchsorted(-s2, -(thr - s1[:n1]), side="right")
        total = int(n2.sum())
        if total == 0:
            return np.zeros(0, dtype=np.int64)
        rep_i = np.repeat(np.arange(n1), n2)
        starts = np.concatenate(([0], np.cumsum(n2)[:-1]))
        pos_j = np.arange(total) - np.repeat(starts, n2)
        return (c1[rep_i].astype(np.int64) * self.n_half
                + c2[pos_j].astype(np.int64))


def _l2_cache_size() -> int:
    """Util::getL2CacheSize (Util.cpp:373-388): sysconf
    _SC_LEVEL2_CACHE_SIZE, else 262144. Python's os.sysconf lacks the
    name on this glibc, so fall back to the sysfs cache topology the C
    sysconf reads — the value is id-load-bearing (it picks BINCOUNT,
    which shapes the prefilter's bin-major tie order)."""
    try:
        l2 = os.sysconf("SC_LEVEL2_CACHE_SIZE")
        if l2 > 0:
            return l2
    except (ValueError, OSError):
        pass
    try:
        with open("/sys/devices/system/cpu/cpu0/cache/index2/size") as fh:
            txt = fh.read().strip()
        if txt.endswith("K"):
            return int(txt[:-1]) * 1024
        if txt.endswith("M"):
            return int(txt[:-1]) * 1024 * 1024
        return int(txt)
    except (OSError, ValueError):
        return 262144


def _bin_bits(db_size: int) -> int:
    """QueryMatcher::initDiagonalMatcher (QueryMatcher.cpp:383-410):
    smallest BINSIZE in {2,4,...,2048} with db_size/BINSIZE < L2 cache."""
    l2 = _l2_cache_size()
    for bits in range(1, 12):
        if db_size // (1 << bits) < l2:
            return bits
    return 11


@dataclass
class PrefilterHit:
    target: int
    score: int
    diagonal: int  # signed short semantics


def ungapped_profile_cap(q_num, bias80, ungapped_m):
    """(profile, cap) of the ungapped rescoring stage: VTML40x2 + aaCorr
    profile and the u8 saturation cap (UngappedAlignment byte kernel)."""
    aa_corr = round_half_away(np.asarray(bias80) / 4.0)
    profile = ungapped_m.scores[q_num].astype(np.int64) + aa_corr[:, None]
    sub_min = int(ungapped_m.scores.min())
    u_bias = abs(sub_min) + abs(int(min(aa_corr.min(initial=0), 0)))
    return profile, 255 - u_bias


def prefilter_query(q_num: np.ndarray, index: TargetIndex,
                    params: PrefilterParams,
                    seed_m: Optional[ScoringMatrix] = None,
                    ungapped_m: Optional[ScoringMatrix] = None,
                    enumerator: Optional[SimilarKmerEnumerator] = None,
                    bias80: Optional[np.ndarray] = None,
                    collect_all: bool = False) -> list:
    """Match one query ORF; returns hits sorted like the reference rows.

    collect_all=True keeps every per-target result at or above
    min_diag_score without the max_seqs histogram cut — the per-split
    hit list that merge_split_hits() k-way-merges into the global list
    (the reference's mergeTargetSplits role, Prefiltering.h:49)."""
    seed_m = seed_m or load_matrix(params.seed_matrix, 8.0)
    ungapped_m = ungapped_m or load_matrix(params.ungapped_matrix, 2.0)
    offsets = params.offsets
    span = params.pattern_span
    kmer_thr = params.kmer_threshold()

    q_num = np.asarray(q_num, dtype=np.int64)
    lq = len(q_num)
    if bias80 is None:
        if params.comp_bias_corr:
            bias80 = local_aa_bias(q_num, seed_m)
        else:
            bias80 = np.zeros(lq)

    codes, valid = _spaced_codes(q_num, offsets, span, 20)
    n_kmers = len(codes)
    if n_kmers == 0 or len(index.uniq_codes) == 0:
        return []

    # QueryMatcher::match hashes query positions [indexStart, indexTo)
    # where indexTo is the *last* k-mer position — i.e. the final k-mer
    # position's matches are always dropped (CacheFriendlyOperations.cpp:43-46
    # upper bound combined with QueryMatcher.cpp:289-293).
    valid[n_kmers - 1] = False
    kpos = np.flatnonzero(valid)
    if len(kpos) == 0:
        return []
    # per-kmer threshold
    kbias = round_half_away(bias80[kpos[:, None] + offsets[None, :]].sum(axis=1))
    thr = np.maximum(kmer_thr - kbias, 0)

    # enumerate similar k-mers per query k-mer (output-sensitive, exact
    # KmerGenerator order) and intersect with the index codes
    if enumerator is None:
        enumerator = SimilarKmerEnumerator(seed_m.scores)
    qletters = q_num[kpos[:, None] + offsets[None, :]]        # [nk, k]
    starts = index.uniq_start
    m_t_parts, m_d_parts = [], []
    for a in range(len(kpos)):
        sim = enumerator.enumerate(qletters[a], int(thr[a]))
        if len(sim) == 0:
            continue
        ci = np.searchsorted(index.uniq_codes, sim)
        ok = (ci < len(index.uniq_codes))
        ci = np.where(ok, ci, 0)
        ok &= index.uniq_codes[ci] == sim
        ci = ci[ok]
        if len(ci) == 0:
            continue
        i = int(kpos[a])
        # expand postings (ragged, vectorized)
        lo = starts[ci]
        cnt = (starts[ci + 1] - lo).astype(np.int64)
        total = int(cnt.sum())
        if total == 0:
            continue
        base = np.repeat(lo, cnt)
        within = np.arange(total) - np.repeat(
            np.concatenate(([0], np.cumsum(cnt)[:-1])), cnt)
        pidx = base + within
        m_t_parts.append(index.post_seq[pidx])
        m_d_parts.append((i - index.post_pos[pidx].astype(np.int64)) & 0xFFFF)
    if not m_t_parts:
        return []
    m_t = np.concatenate(m_t_parts)
    m_d = np.concatenate(m_d_parts)

    # ungapped rescoring profile: VTML40x2 + aaCorr (bias80/4 rounded)
    profile, cap = ungapped_profile_cap(q_num, bias80, ungapped_m)
    if collect_all:
        from dataclasses import replace
        params = replace(params, max_seqs=1 << 30)

    from ..native import get_lib
    lib = get_lib()
    if lib is not None:
        return _finalize_native(lib, m_t, m_d, index, profile, cap,
                                params, q_num)
    return _finalize_py(m_t, m_d, index, profile, cap, params, q_num)


def prefilter_query_batch(q_list: list, index: TargetIndex,
                          params: PrefilterParams,
                          seed_m: Optional[ScoringMatrix] = None,
                          ungapped_m: Optional[ScoringMatrix] = None,
                          enumerator=None, bias80_all=None,
                          collect_all: bool = False, packed=None,
                          as_arrays: bool = False):
    """Match MANY query ORFs in one native call; returns a list of hit
    lists parallel to ``q_list``, each bit-identical to
    ``prefilter_query`` on that query.

    This is the batched analog of the reference's OpenMP query loop
    (Prefiltering.cpp:776-800 driving QueryMatcher::matchQuery,
    QueryMatcher.cpp:84-323): the per-query Python overhead (~0.4-2 ms
    per ORF — the catalog-scale wall, BASELINE.md round-3 analysis)
    collapses into one C walk over flat-packed queries. Falls back to
    the per-query driver when no native library is available or the
    k-mer split is not 3+3.

    ``as_arrays=True`` returns raw (target, score, diagonal, per-query
    offsets) arrays instead of PrefilterHit lists — the zero-object
    contract consumed by the batch aligner at catalog scale."""
    seed_m = seed_m or load_matrix(params.seed_matrix, 8.0)
    ungapped_m = ungapped_m or load_matrix(params.ungapped_matrix, 2.0)

    def _fallback():
        enum = enumerator or SimilarKmerEnumerator(seed_m.scores)
        hls = [prefilter_query(
                   q, index, params, seed_m=seed_m, ungapped_m=ungapped_m,
                   enumerator=enum,
                   bias80=None if bias80_all is None else bias80_all[i],
                   collect_all=collect_all)
               for i, q in enumerate(q_list)]
        if not as_arrays:
            return hls
        off = np.zeros(len(hls) + 1, dtype=np.int64)
        np.cumsum([len(h) for h in hls], out=off[1:])
        t = np.fromiter((h.target for hl in hls for h in hl),
                        dtype=np.int32, count=int(off[-1]))
        s = np.fromiter((h.score for hl in hls for h in hl),
                        dtype=np.int32, count=int(off[-1]))
        d = np.fromiter((h.diagonal for hl in hls for h in hl),
                        dtype=np.int32, count=int(off[-1]))
        return t, s, d, off

    from ..native import get_lib
    lib = get_lib()
    if lib is None or params.kmer_size != 6 or len(index.uniq_codes) == 0:
        return _fallback()

    from .bias import expected_score_tab
    nq = len(q_list)
    if packed is not None:
        # zero-copy: queries are a contiguous slice of a flat array
        qflat0, qoff0 = packed
        base = int(qoff0[0])
        qflat = qflat0[base:int(qoff0[-1])]
        qstarts = np.ascontiguousarray(
            np.asarray(qoff0, dtype=np.int64) - base)
    else:
        qstarts = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum([len(q) for q in q_list], out=qstarts[1:])
        qflat = (np.ascontiguousarray(np.concatenate(q_list),
                                      dtype=np.uint8)
                 if nq and qstarts[-1] else np.zeros(1, np.uint8))
    seed32 = np.ascontiguousarray(seed_m.scores, dtype=np.int32)
    etab = np.ascontiguousarray(expected_score_tab(seed_m))
    offs32 = np.ascontiguousarray(params.offsets, dtype=np.int32)
    uniq_codes = np.ascontiguousarray(index.uniq_codes, dtype=np.int64)
    uniq_start = np.ascontiguousarray(index.uniq_start, dtype=np.int64)
    post_seq = np.ascontiguousarray(index.post_seq, dtype=np.int32)
    post_pos = np.ascontiguousarray(index.post_pos, dtype=np.uint16)
    flatm, mstarts = index.packed_masked()
    flatm = np.ascontiguousarray(flatm, dtype=np.uint8)
    mstarts = np.ascontiguousarray(mstarts, dtype=np.int64)
    ung32 = np.ascontiguousarray(ungapped_m.scores, dtype=np.int32)
    max_seqs = (1 << 30) if collect_all else params.max_seqs

    total = lib.prefilter_batch(
        qflat.ctypes.data, qstarts.ctypes.data, nq,
        seed32.ctypes.data, seed32.shape[1], etab.ctypes.data,
        int(params.comp_bias_corr),
        offs32.ctypes.data, params.kmer_size, params.pattern_span,
        int(params.kmer_threshold()), X_IDX,
        uniq_codes.ctypes.data, uniq_start.ctypes.data, len(uniq_codes),
        post_seq.ctypes.data, post_pos.ctypes.data,
        flatm.ctypes.data, mstarts.ctypes.data, len(index.seq_lengths),
        ung32.ctypes.data, abs(int(ung32.min())),
        params.min_diag_score, max_seqs,
        _bin_bits(len(index.seq_lengths)))
    if total < 0:
        lib.prefilter_batch_free()
        return _fallback()
    out_t = np.empty(total + 1, dtype=np.int32)
    out_s = np.empty(total + 1, dtype=np.int32)
    out_d = np.empty(total + 1, dtype=np.int32)
    out_off = np.empty(nq + 1, dtype=np.int64)
    lib.prefilter_batch_fetch(out_t.ctypes.data, out_s.ctypes.data,
                              out_d.ctypes.data, out_off.ctypes.data)
    if as_arrays:
        # raw hit arrays (target, score, signed diagonal, per-query
        # offsets) — the zero-object contract the batch aligner consumes
        return out_t[:total], out_s[:total], out_d[:total], out_off
    result = [[] for _ in range(nq)]
    for qi in np.flatnonzero(np.diff(out_off)):
        lo, hi = int(out_off[qi]), int(out_off[qi + 1])
        result[qi] = [PrefilterHit(int(out_t[i]), int(out_s[i]),
                                   int(out_d[i]))
                      for i in range(lo, hi)]
    return result


def merge_split_hits(hits: list, cap: int,
                     params: PrefilterParams) -> list:
    """Merge per-split collect_all hit lists into the global hit list.

    Reproduces the monolithic finalize's selection: histogram of capped
    scores -> max_seqs threshold -> (score desc, target asc) order ->
    truncate (QueryMatcher.h:199-209 + compareHitsByScoreAndId). Hits
    must carry GLOBAL target ids; per-target entries are unique across
    splits. Exactness caveat (shared with the reference's split mode):
    the dup filter's cross-bin state leak sees only its own split's
    match stream, so leak-edge tie cases can differ from a monolithic
    run."""
    hist = np.zeros(256, dtype=np.int64)
    for h in hits:
        hist[min(min(h.score, cap), 255)] += 1
    found = 0
    thr_score = 0
    for s in range(255, 0, -1):
        found += hist[s]
        if found >= params.max_seqs:
            thr_score = s
            break
    thr = max(params.min_diag_score, thr_score)
    out = [h for h in hits if min(h.score, cap) >= thr]
    out.sort(key=lambda h: (-abs(h.score), h.target))
    return out[:params.max_seqs]


def _finalize_native(lib, m_t, m_d, index: TargetIndex, profile, cap,
                     params: PrefilterParams, q_num) -> list:
    """C path of the dup filter + diag rescore (sw_native.c
    prefilter_finalize); bit-identical to _finalize_py."""
    flatm, mstarts = index.packed_masked()
    m_t32 = np.ascontiguousarray(m_t, dtype=np.int32)
    m_d16 = np.ascontiguousarray(m_d, dtype=np.uint16)
    prof32 = np.ascontiguousarray(profile, dtype=np.int32)
    q8 = np.ascontiguousarray(q_num, dtype=np.uint8)
    n = len(m_t32)
    out_t = np.empty(n, dtype=np.int32)
    out_s = np.empty(n, dtype=np.int32)
    out_d = np.empty(n, dtype=np.int32)
    nh = lib.prefilter_finalize(
        m_t32.ctypes.data, m_d16.ctypes.data, n,
        _bin_bits(len(index.seq_lengths)),
        flatm.ctypes.data, mstarts.ctypes.data, len(index.seq_lengths),
        prof32.ctypes.data, prof32.shape[0], prof32.shape[1],
        q8.ctypes.data,
        int(cap), params.min_diag_score, params.max_seqs,
        out_t.ctypes.data, out_s.ctypes.data, out_d.ctypes.data)
    if nh < 0:
        return _finalize_py(m_t, m_d, index, profile, cap, params, q_num)
    return [PrefilterHit(int(out_t[i]), int(out_s[i]), int(out_d[i]))
            for i in range(nh)]


def _finalize_py(m_t, m_d, index: TargetIndex, profile, cap,
                 params: PrefilterParams, q_num=None) -> list:
    # double-diagonal filter (CacheFriendlyOperations::findDuplicates,
    # CacheFriendlyOperations.cpp:146-225): targets are binned by
    # seqId & (BINSIZE-1); the per-slot (seqId >> log2(BINSIZE)) state
    # byte is shared across bins *without reset*, so bin b>0 inherits
    # leftover state from bin b-1's stage B — reproduced exactly.
    # Stage A keeps a match iff diagonal(u8) == slot state (initially 0:
    # a first match on diagonal ≡ 0 mod 256 passes); stage B drops
    # consecutive same-diagonal duplicates per slot.
    bin_bits = _bin_bits(len(index.seq_lengths))
    bin_mask = (1 << bin_bits) - 1
    m_t = np.asarray(m_t)
    m_d = np.asarray(m_d)
    d_u8 = (m_d & 0xFF).astype(np.int64)
    slots = {}
    diag_sets = {}
    emit_pos = 0
    for b in range(bin_mask + 1):
        sel = (m_t & bin_mask) == b
        kept = []  # (target, d16, d8) in stream order
        for t, d16, d8 in zip(m_t[sel], m_d[sel], d_u8[sel]):
            slot = int(t) >> bin_bits
            if slots.get(slot, 0) == d8:
                kept.append((int(t), int(d16), int(d8)))
            slots[slot] = int(d8)
        # stage B: reverse pass seeds slot = first-kept-diag + 1 (u8)
        for t, d16, d8 in reversed(kept):
            slots[t >> bin_bits] = (d8 + 1) & 0xFF
        for t, d16, d8 in kept:
            slot = t >> bin_bits
            if slots[slot] != d8:
                diag_sets.setdefault(t, []).append((d16, emit_pos))
                emit_pos += 1
            slots[slot] = d8

    results = []
    for t, dlist in diag_sets.items():
        tseq = index.seqs_masked[t]
        best = -1
        best_d = 0
        best_win = 0
        for d_u16, pos in dlist:  # candidate order; ties keep first
            d = d_u16 - 65536 if d_u16 >= 32768 else d_u16
            sc = ungapped_diagonal_score(profile, tseq, d)
            sc_cap = min(sc, cap)
            if sc_cap > best:
                best = sc_cap
                best_d = d_u16
                best_exact = sc
                best_win = pos
        results.append((t, best, best_d, best_exact, best_win))

    # histogram threshold (max_seqs cap)
    hist = np.zeros(256, dtype=np.int64)
    for _, sc, _, _, _ in results:
        hist[min(sc, 255)] += 1
    found = 0
    thr_score = 0
    for s in range(255, 0, -1):
        found += hist[s]
        if found >= params.max_seqs:
            thr_score = s
            break
    thr_score = max(params.min_diag_score, thr_score)

    # Truncation order parity: the reference's stable radix keeps the
    # match-stream order within a capped-score bucket
    # (radixSortByScoreSize, QueryMatcher.cpp:459-481), so ties at the
    # threshold survive by the WINNING entry's emit position; only the
    # surviving list is then sorted by compareHitsByScoreAndId.
    survivors = [r for r in results if r[1] >= thr_score]
    if thr_score >= cap and q_num is not None:
        # scoreIsTruncated branch (QueryMatcher.cpp:146-155): when the
        # threshold saturates the u8 cap, every survivor is exactly
        # rescored, RESCALED against the query's ungapped self score
        # into a u8 (rescoreHits, QueryMatcher.cpp:486-505), selected
        # in (rescaled desc, stream order) and emitted as the
        # QUANTIZED reconstruction lb + count*maxSelf/255
        # (getResult, QueryMatcher.cpp:367-370).
        self_sc = ungapped_diagonal_score(
            profile, np.asarray(q_num, dtype=np.int64), 0)
        max_self = min(max(self_sc - cap, 1), 65535)
        rescaled = []
        for t, sc, d_u16, sc_exact, win in survivors:
            new = (sc_exact - cap) & 0xFFFFFFFF        # u32 arithmetic
            score_f = np.float32(min(new, 65535))
            count8 = int(float(score_f / np.float32(max_self)
                               * np.float32(255)) + 0.5) & 0xFF
            rescaled.append((t, sc, d_u16, count8, win))
        rescaled.sort(key=lambda r: (-r[3], r[4]))
        rescaled = rescaled[:params.max_seqs]
        hits = []
        for t, sc, d_u16, count8, _ in rescaled:
            out_score = cap + (count8 * max_self) // 255
            d_signed = d_u16 - 65536 if d_u16 >= 32768 else d_u16
            hits.append(PrefilterHit(t, out_score, d_signed))
        hits.sort(key=lambda h: (-abs(h.score), h.target))
        return hits
    if len(survivors) > params.max_seqs:
        survivors.sort(key=lambda r: (-r[1], r[4]))
        survivors = survivors[:params.max_seqs]
    hits = []
    for t, sc, d_u16, sc_exact, _ in survivors:
        out_score = sc_exact if sc >= cap else sc
        d_signed = d_u16 - 65536 if d_u16 >= 32768 else d_u16
        hits.append(PrefilterHit(t, out_score, d_signed))
    hits.sort(key=lambda h: (-abs(h.score), h.target))
    return hits
