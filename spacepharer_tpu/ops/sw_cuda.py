"""Smith-Waterman scoring of candidate pairs on the device.

`score_pairs` is the one device scorer of the search: it takes the
prefilter's (query, target) candidate pairs and returns their exact SW
scores, on one device or over a (q, t) mesh.

* On an NVIDIA GPU the short queries (spacer ORFs, at most MAX_LQ
  residues, profile scores that fit int8) go to a CUDA kernel
  (cuda/sw_pairs.cu) called through jax.ffi: one thread per pair, the
  DP column in registers, Hopper's DPX max/add instructions. The
  library is compiled with nvcc for sm_90a at first use into
  `<repo>/build/cuda/` (or ahead of time: `python -m
  spacepharer_tpu.ops.sw_cuda`).
* Every other pair, and every pair on a CPU backend, goes to the XLA
  scan of ops/sw_tpu.py. Scores are identical either way.

Over a mesh, each pair belongs to the device that holds its query
(``q`` axis, contiguous query blocks) and its target (``t`` axis,
contiguous target blocks); every device runs the same scorer on its own
pairs under jax.shard_map, so one code path serves one card and four.

The kernel cannot run without a card, so `model_scores` keeps a NumPy
model of exactly its per-thread loop (int8 profile with -128 pad rows,
the row recurrence for F) for the CPU tests.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..logging import log

MAX_LQ = 32            # query rows held in registers (template sizes 16, 32)
N_LETTERS = 21         # profile rows: the 20 amino acids + X
PAD_SCORE = -128       # profile value of query rows past the query's end
WARP = 32
FFI_TARGET = "spacepharer_sw_pairs"
MAX_PAIRS_PER_CALL = 1 << 22

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cuda", "sw_pairs.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                         "build", "cuda")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


# ---------------------------------------------------------------------------
# host-side planning (shared by the kernel, the model and the tests)
# ---------------------------------------------------------------------------

def lq_template(qlen: int) -> int:
    return 16 if qlen <= 16 else 32


def kernel_profile(q, matrix_scores, bias=None, lq: int = None):
    """int8 [21, lq] profile P[a, j] = S[q_j][a] + bias_j, pad rows
    PAD_SCORE; None when the query cannot ride the kernel (too long,
    empty, or a score outside [-127, 127])."""
    q = np.asarray(q, dtype=np.int64)
    if not 0 < len(q) <= MAX_LQ:
        return None
    p = matrix_scores[q][:, :N_LETTERS].astype(np.int64)
    if bias is not None:
        p = p + np.asarray(bias, dtype=np.int64)[:len(q), None]
    if p.min() < -127 or p.max() > 127:
        return None
    lq = lq or lq_template(len(q))
    out = np.full((N_LETTERS, lq), PAD_SCORE, dtype=np.int8)
    out[:, :len(q)] = p.T
    return out


def plan_warps(pair_q, pair_tlen):
    """Lay pairs out for the kernel: one warp serves the pairs of one
    query, sorted by target length (longest first) so a warp's lanes
    finish together; each query's pairs are padded to whole warps.

    Returns (warp_q int32 [n_warps], slot int64 [n_pairs]): the query
    of each warp, and the slot (warp * 32 + lane) of each input pair.
    """
    pair_q = np.asarray(pair_q, dtype=np.int64)
    n = len(pair_q)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int64)
    order = np.lexsort((-np.asarray(pair_tlen, dtype=np.int64), pair_q))
    sq = pair_q[order]
    uq, first, counts = np.unique(sq, return_index=True, return_counts=True)
    n_w = (counts + WARP - 1) // WARP
    warp_base = np.zeros(len(uq), dtype=np.int64)
    np.cumsum(n_w[:-1], out=warp_base[1:])
    rank = np.arange(n, dtype=np.int64) - np.repeat(first, counts)
    slot = np.empty(n, dtype=np.int64)
    slot[order] = np.repeat(warp_base, counts) * WARP + rank
    warp_q = np.repeat(uq, n_w).astype(np.int32)
    return warp_q, slot


def pack_targets(t_seqs, t_idx):
    """Flat uint8 letters of targets `t_idx`, each start 16-byte aligned
    and every run padded to a multiple of 16 (the kernel reads 16
    letters at a time). Returns (flat, offsets int64 [len(t_idx)])."""
    lens = np.array([len(t_seqs[t]) for t in t_idx], dtype=np.int64)
    padded = (lens + 15) // 16 * 16
    offs = np.zeros(len(t_idx), dtype=np.int64)
    if len(t_idx):
        np.cumsum(padded[:-1], out=offs[1:])
    flat = np.zeros(max(int(padded.sum()), 16), dtype=np.uint8)
    for t, o, n in zip(t_idx, offs, lens):
        flat[o:o + n] = t_seqs[t]
    if len(flat) and flat.max() >= N_LETTERS:
        raise ValueError("target letters must be amino-acid indices < 21")
    return flat, offs


def model_scores(profs, t_list, gap_open: int, gap_extend: int):
    """NumPy model of the kernel's per-thread loop, vectorized over
    pairs: profs int8 [P, 21, LQ], t_list P letter arrays. int32
    arithmetic, rows in order, F by the row recurrence."""
    profs = np.asarray(profs, dtype=np.int32)
    P, _, LQ = profs.shape
    lens = np.array([len(t) for t in t_list], dtype=np.int64)
    LT = int(lens.max(initial=0))
    T = np.zeros((P, max(LT, 1)), dtype=np.int64)
    for i, t in enumerate(t_list):
        T[i, :len(t)] = t
    H = np.zeros((P, LQ), dtype=np.int32)
    E = np.zeros((P, LQ), dtype=np.int32)
    best = np.zeros(P, dtype=np.int32)
    go, ge = np.int32(gap_open), np.int32(gap_extend)
    rows = np.arange(P)
    for c in range(LT):
        live = c < lens
        s_col = profs[rows, T[:, c], :]                  # [P, LQ]
        diag = np.zeros(P, dtype=np.int32)
        F = np.full(P, -(1 << 28), dtype=np.int32)
        for j in range(LQ):
            hp = np.maximum(np.maximum(diag + s_col[:, j], E[:, j]), 0)
            diag = H[:, j].copy()
            hpo = hp - go
            e_new = np.maximum(np.maximum(hpo, E[:, j] - ge), 0)
            h = np.maximum(hp, F)
            F = np.maximum(F - ge, hpo)
            E[:, j] = np.where(live, e_new, E[:, j])
            H[:, j] = np.where(live, h, H[:, j])
            best = np.where(live, np.maximum(best, h), best)
    return best.astype(np.int64)


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

_registered = []


def _source_tag() -> str:
    with open(_SRC, "rb") as fh:
        h = hashlib.sha256(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library() -> str:
    """Compile cuda/sw_pairs.cu for sm_90a (once per source version);
    returns the shared library's path. Raises when nvcc fails."""
    import jax.ffi
    so = os.path.join(BUILD_DIR, f"libsw_pairs-{_source_tag()}.so")
    if os.path.exists(so):
        return so
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{r.stderr}")
    os.replace(tmp, so)
    return so


def _ensure_registered():
    if not _registered:
        import jax.ffi
        lib = ctypes.cdll.LoadLibrary(build_library())
        jax.ffi.register_ffi_target(FFI_TARGET, jax.ffi.pycapsule(lib.SwPairs),
                                    platform="CUDA")
        _registered.append(lib)


def cuda_available() -> bool:
    """True on a GPU backend: the kernel is then the scorer, and a
    failed build is an error, not a silent fallback."""
    import jax
    return jax.default_backend() == "gpu"


def _ffi(prof, tflat, warp_q, toff, tlen, lq, go, ge):
    import jax
    import jax.numpy as jnp
    return jax.ffi.ffi_call(
        FFI_TARGET, jax.ShapeDtypeStruct(toff.shape, jnp.int32))(
        prof, tflat, warp_q, toff, tlen, lq=np.int32(lq),
        gap_open=np.int32(go), gap_extend=np.int32(ge))


_JIT = {}


def _kernel_fn(mesh, lq, go, ge):
    key = (id(mesh), lq, go, ge)
    fn = _JIT.get(key)
    if fn is None:
        import jax
        from jax.sharding import PartitionSpec as P

        def local(prof, tflat, warp_q, toff, tlen):
            return _ffi(prof, tflat, warp_q, toff, tlen, lq, go, ge)

        if mesh is None:
            fn = jax.jit(local)
        else:
            spec = P(("q", "t"))
            fn = jax.jit(jax.shard_map(
                local, mesh=mesh, in_specs=(spec,) * 5, out_specs=spec,
                check_vma=False))
        _JIT[key] = fn
    return fn


def _device_inputs(pair_q, pair_t, profs, t_seqs, lq):
    """One device's kernel inputs (unpadded): (prof, tflat, warp_q,
    toff, tlen, slot)."""
    uq, q_loc = np.unique(pair_q, return_inverse=True)
    ut, t_loc = np.unique(pair_t, return_inverse=True)
    prof = (np.stack([profs[int(q)] for q in uq]) if len(uq)
            else np.zeros((0, N_LETTERS, lq), np.int8))
    tflat, offs = pack_targets(t_seqs, ut)
    t_lens = np.array([len(t_seqs[t]) for t in ut], dtype=np.int64)
    warp_q, slot = plan_warps(q_loc, t_lens[t_loc] if len(ut) else [])
    n_slots = len(warp_q) * WARP
    toff = np.zeros(n_slots, dtype=np.int32)
    tlen = np.zeros(n_slots, dtype=np.int32)
    if len(slot):
        toff[slot] = offs[t_loc]
        tlen[slot] = t_lens[t_loc]
    return prof, tflat, warp_q, toff, tlen, slot


def prepare_kernel_call(pair_q, pair_t, profs, t_seqs, lq, go, ge, mesh,
                        dev_of):
    """Plan and upload one kernel dispatch for pairs whose queries all
    use template `lq`. Returns (fn, args, finish): fn(*args) runs the
    kernel, finish(result) maps it back to int64 scores per pair."""
    import jax
    from .sw_tpu import pow2_at_least
    _ensure_registered()
    n_dev = 1 if mesh is None else mesh.devices.size
    per = [_device_inputs(pair_q[dev_of == d], pair_t[dev_of == d], profs,
                          t_seqs, lq) for d in range(n_dev)]
    # pow2 sizes: one compiled program serves many calls
    n_q = pow2_at_least(max(len(x[0]) for x in per), 8)
    n_t = pow2_at_least(max(len(x[1]) for x in per), 1 << 16)
    n_w = pow2_at_least(max(len(x[2]) for x in per), 64)
    stacked = [np.zeros((n_dev, n_q, N_LETTERS, lq), np.int8),
               np.zeros((n_dev, n_t), np.uint8),
               np.zeros((n_dev, n_w), np.int32),
               np.zeros((n_dev, n_w * WARP), np.int32),
               np.zeros((n_dev, n_w * WARP), np.int32)]
    for d, (prof, tflat, warp_q, toff, tlen, _) in enumerate(per):
        stacked[0][d, :len(prof)] = prof
        stacked[1][d, :len(tflat)] = tflat
        stacked[2][d, :len(warp_q)] = warp_q
        stacked[3][d, :len(toff)] = toff
        stacked[4][d, :len(tlen)] = tlen
    fn = _kernel_fn(mesh, lq, go, ge)
    if mesh is None:
        args = [jax.device_put(a[0]) for a in stacked]
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh = NamedSharding(mesh, P(("q", "t")))
        args = [jax.device_put(a.reshape(n_dev * a.shape[1], *a.shape[2:]),
                               sh) for a in stacked]
        _log_placement(args[3], n_dev)

    def finish(res):
        res = np.asarray(res).reshape(n_dev, -1)
        out = np.zeros(len(pair_q), dtype=np.int64)
        for d in range(n_dev):
            out[np.flatnonzero(dev_of == d)] = res[d, per[d][5]]
        return out

    return fn, args, finish


def kernel_groups(pair_q, q_seqs, matrix_scores, biases=None):
    """Kernel profiles of the queries that fit, and the pair indices of
    each template: (profs {q: int8 [21, lq]}, {lq: pair idx})."""
    pair_q = np.asarray(pair_q, dtype=np.int64)
    uq, inv = np.unique(pair_q, return_inverse=True)
    profs = {}
    lq_u = np.zeros(len(uq), dtype=np.int64)
    for i, q in enumerate(uq.tolist()):
        p = kernel_profile(q_seqs[q], matrix_scores,
                           None if biases is None else biases[q])
        if p is not None:
            profs[q] = p
            lq_u[i] = p.shape[1]
    lq_of = lq_u[inv]
    groups = {lq: np.flatnonzero(lq_of == lq) for lq in (16, 32)}
    return profs, {lq: g for lq, g in groups.items() if len(g)}


def _log_placement(arr, n_dev):
    devs = sorted({s.device.id for s in arr.addressable_shards})
    if len(devs) != n_dev:
        raise RuntimeError(f"mesh scoring: inputs landed on devices {devs}, "
                           f"expected {n_dev} distinct devices")
    log(3, f"mesh scoring: inputs on devices {devs}")


def _score_xla(pair_q, pair_t, q_seqs, t_seqs, matrix_scores, biases,
               go, ge, mesh, dev_of):
    """XLA-scan scores, over the mesh when one is given."""
    from .sw_tpu import (batch_size, fill_batch, length_buckets,
                         pow2_at_least, query_profile, score_pairs_bucketed,
                         sw_score_batch)
    if mesh is None:
        return score_pairs_bucketed(
            np.stack([pair_q, pair_t], axis=1), q_seqs, t_seqs,
            matrix_scores, biases, go, ge)
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    n_dev = mesh.devices.size
    uq = np.unique(pair_q)
    lq_pad = pow2_at_least(max(len(q_seqs[q]) for q in uq), 32)
    B = batch_size(lq_pad)
    profs = {int(q): query_profile(
        q_seqs[q], matrix_scores, None if biases is None else biases[q],
        lq_pad) for q in uq}
    spec = P(("q", "t"))
    key = (id(mesh), "xla", go, ge)
    fn = _JIT.get(key)
    if fn is None:
        fn = jax.jit(jax.shard_map(
            lambda a, b, c, d: sw_score_batch(a, b, c, d, go, ge),
            mesh=mesh, in_specs=(spec,) * 4, out_specs=spec,
            check_vma=False))
        _JIT[key] = fn
    sh = NamedSharding(mesh, spec)
    out = np.zeros(len(pair_q), dtype=np.int64)
    t_lens = np.array([len(t_seqs[t]) for t in pair_t])
    for lt_pad, idx in length_buckets(t_lens):
        per_dev = [idx[dev_of[idx] == d] for d in range(n_dev)]
        rounds = max(-(-len(p) // B) for p in per_dev)
        for r in range(rounds):
            chunks = [p[r * B:(r + 1) * B] for p in per_dev]
            parts = [fill_batch(c, pair_q, pair_t, profs, q_seqs, t_seqs, B,
                                lq_pad, lt_pad, matrix_scores.shape[1])
                     for c in chunks]
            args = [jax.device_put(np.concatenate([p[k] for p in parts]), sh)
                    for k in range(4)]
            if r == 0:
                _log_placement(args[0], n_dev)
            res = np.asarray(fn(*args)).reshape(n_dev, B)
            for d, c in enumerate(chunks):
                out[c] = res[d, :len(c)]
    return out


def device_of_pairs(pair_q, pair_t, mesh_shape):
    """Device (row-major in the (q, t) mesh) of each pair: contiguous
    blocks of the distinct queries on ``q``, of the distinct targets
    on ``t``."""
    nq, nt = mesh_shape
    uq, qi = np.unique(pair_q, return_inverse=True)
    ut, ti = np.unique(pair_t, return_inverse=True)
    return (qi * nq // max(len(uq), 1)) * nt + ti * nt // max(len(ut), 1)


def score_pairs(pair_q, pair_t, q_seqs, t_seqs, matrix_scores,
                biases=None, gap_open: int = 16, gap_extend: int = 2,
                mesh=None) -> np.ndarray:
    """Exact SW scores (int64) of candidate pairs (pair_q[i], pair_t[i]),
    indices into q_seqs / t_seqs; biases: optional per-query int arrays.
    """
    pair_q = np.asarray(pair_q, dtype=np.int64)
    pair_t = np.asarray(pair_t, dtype=np.int64)
    out = np.zeros(len(pair_q), dtype=np.int64)
    if len(pair_q) == 0:
        return out
    shape = (1, 1) if mesh is None else tuple(mesh.devices.shape)
    on_kernel = np.zeros(len(pair_q), dtype=bool)
    groups = {}
    if cuda_available():
        profs, groups = kernel_groups(pair_q, q_seqs, matrix_scores, biases)
        for sel in groups.values():
            on_kernel[sel] = True
    log(2, f"device scoring: {int(on_kernel.sum())} pairs on the CUDA "
           f"kernel, {int((~on_kernel).sum())} on the XLA scan"
           + ("" if mesh is None else f", mesh {shape[0]}x{shape[1]}"))
    for lq, sel in groups.items():
        for lo in range(0, len(sel), MAX_PAIRS_PER_CALL):
            s = sel[lo:lo + MAX_PAIRS_PER_CALL]
            fn, args, finish = prepare_kernel_call(
                pair_q[s], pair_t[s], profs, t_seqs, lq, gap_open,
                gap_extend, mesh, device_of_pairs(pair_q[s], pair_t[s],
                                                  shape))
            out[s] = finish(fn(*args))
    rest = np.flatnonzero(~on_kernel)
    if len(rest):
        out[rest] = _score_xla(pair_q[rest], pair_t[rest], q_seqs, t_seqs,
                               matrix_scores, biases, gap_open, gap_extend,
                               mesh, device_of_pairs(pair_q[rest],
                                                     pair_t[rest], shape))
    return out


if __name__ == "__main__":
    print(build_library())
