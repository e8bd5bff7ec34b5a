"""The device SW scorer on the CPU: planning, padding and routing of
ops/sw_cuda.py, and the NumPy model of the CUDA kernel's per-thread DP
against the exact host engine. The kernel itself needs a GPU; it is
checked there by chip_smoke.py (phase 2) and tests/test_gpu.py.

`emulate_kernel` replays the kernel's input contract (slot -> warp ->
query profile, slot -> target run) through the model, so every wrapper
path down to the FFI call runs here.
"""
import numpy as np
import pytest

from spacepharer_tpu.ops import sw_cuda
from spacepharer_tpu.ops.align import _forward_pass
from spacepharer_tpu.ops.matrices import load_matrix
from spacepharer_tpu.ops.sw_tpu import score_pairs_bucketed

M = load_matrix("VTML40.out", 2.0)


def _host_score(q, t, bias=None, go=16, ge=2):
    prof = M.scores[np.asarray(q, np.int64)].astype(np.int64)
    if bias is not None:
        prof = prof + np.asarray(bias, np.int64)[:, None]
    return int(_forward_pass(prof[:, np.asarray(t, np.int64)].T, go,
                             ge)[0]) if len(t) else 0


def emulate_kernel(prof, tflat, warp_q, toff, tlen, lq, go, ge):
    """NumPy stand-in for the FFI call: slot s of warp s // 32 scores
    prof[warp_q[s // 32]] against tflat[toff[s]:toff[s] + tlen[s]]."""
    prof, tflat, warp_q, toff, tlen = (np.asarray(a) for a in
                                       (prof, tflat, warp_q, toff, tlen))
    slots = np.arange(len(toff))
    profs = prof[warp_q[slots // sw_cuda.WARP]]
    ts = [tflat[o:o + n] for o, n in zip(toff, tlen)]
    return sw_cuda.model_scores(profs, ts, go, ge).astype(np.int32)


@pytest.fixture
def emulated(monkeypatch):
    """score_pairs as on a GPU, with the kernel replaced by the model."""
    def kernel_fn(mesh, lq, go, ge):
        def fn(prof, tflat, warp_q, toff, tlen):
            if mesh is None:
                return emulate_kernel(prof, tflat, warp_q, toff, tlen, lq,
                                      go, ge)
            n = mesh.devices.size
            parts = [np.asarray(a).reshape(n, -1, *np.asarray(a).shape[1:])
                     for a in (prof, tflat, warp_q, toff, tlen)]
            return np.concatenate([emulate_kernel(*[p[d] for p in parts],
                                                  lq, go, ge)
                                   for d in range(n)])
        return fn

    monkeypatch.setattr(sw_cuda, "cuda_available", lambda: True)
    monkeypatch.setattr(sw_cuda, "_ensure_registered", lambda: None)
    monkeypatch.setattr(sw_cuda, "_kernel_fn", kernel_fn)


@pytest.mark.parametrize("seed,go,ge,with_x", [
    (0, 16, 2, False), (1, 16, 2, True), (2, 10, 1, False), (3, 11, 1, True)])
def test_model_matches_forward_pass(seed, go, ge, with_x):
    """The kernel's row recurrence F[j+1] = max(F[j] - ge, h_pre[j] - go)
    and its -128 pad rows reproduce _forward_pass on every pair,
    lengths 1..32 across both register templates, with bias."""
    rng = np.random.default_rng(seed)
    hi = 21 if with_x else 20
    qs = [rng.integers(0, hi, n) for n in range(1, 33)]
    ts = [rng.integers(0, hi, int(rng.integers(1, 120))) for _ in qs]
    ts[3] = qs[3].copy()                    # a strong diagonal hit
    biases = [rng.integers(-7, 5, len(q)) for q in qs]
    profs = np.stack([sw_cuda.kernel_profile(q, M.scores, b, lq=32)
                      for q, b in zip(qs, biases)])
    got = sw_cuda.model_scores(profs, ts, go, ge)
    want = [_host_score(q, t, b, go, ge) for q, t, b in zip(qs, ts, biases)]
    assert got.tolist() == want
    assert max(want) > 20


def test_pad_rows_are_inert():
    """Padding a 16-row query to the 32-row template changes no score,
    even for a target that keeps scoring past the query's end."""
    rng = np.random.default_rng(4)
    q = rng.integers(0, 20, 12)
    ts = [np.concatenate([q, q, rng.integers(0, 20, 40)]),
          rng.integers(0, 20, 300)]
    p16 = sw_cuda.kernel_profile(q, M.scores, lq=16)
    p32 = sw_cuda.kernel_profile(q, M.scores, lq=32)
    assert (p32[:, 12:] == sw_cuda.PAD_SCORE).all()
    s16 = sw_cuda.model_scores(np.stack([p16, p16]), ts, 16, 2)
    s32 = sw_cuda.model_scores(np.stack([p32, p32]), ts, 16, 2)
    assert s16.tolist() == s32.tolist() == [_host_score(q, t) for t in ts]


def test_profile_int8_bounds_route_queries():
    """Queries the kernel cannot hold exactly get no kernel profile and
    go to the XLA scan: longer than the 32 register rows, empty, or a
    profile score outside int8 once the bias is added (-128 is reserved
    for pad rows)."""
    q = np.array([4, 7, 9, 1], np.int64)
    assert sw_cuda.kernel_profile(np.zeros(33, np.int64), M.scores) is None
    assert sw_cuda.kernel_profile(np.zeros(0, np.int64), M.scores) is None
    top = int(M.scores[q].max())
    low = int(M.scores[q].min())
    edge = np.full(4, 127 - top)
    assert sw_cuda.kernel_profile(q, M.scores, edge).max() == 127
    assert sw_cuda.kernel_profile(q, M.scores, edge + 1) is None
    floor = np.full(4, -127 - low)
    assert sw_cuda.kernel_profile(q, M.scores, floor)[:, :4].min() == -127
    assert sw_cuda.kernel_profile(q, M.scores, floor - 1) is None
    assert sw_cuda.kernel_profile(q, M.scores).shape == (21, 16)
    assert sw_cuda.kernel_profile(np.zeros(17, np.int64),
                                  M.scores).shape == (21, 32)


def test_plan_warps_layout():
    """One query per warp, longest target first, every pair a unique
    slot, each query padded to whole warps."""
    rng = np.random.default_rng(5)
    pair_q = rng.integers(0, 7, 300)
    tlen = rng.integers(1, 900, 300)
    warp_q, slot = sw_cuda.plan_warps(pair_q, tlen)
    assert len(np.unique(slot)) == len(slot)
    counts = np.bincount(pair_q, minlength=7)
    assert len(warp_q) == int(((counts + 31) // 32).sum())
    assert (warp_q[slot // 32] == pair_q).all()
    for w in range(len(warp_q)):
        lens = tlen[np.flatnonzero(slot // 32 == w)][
            np.argsort(slot[slot // 32 == w])]
        assert (np.diff(lens) <= 0).all()
    # warps of one query are contiguous and in descending length order
    for q in range(7):
        s = np.sort(slot[pair_q == q])
        assert (np.diff(tlen[pair_q == q][np.argsort(slot[pair_q == q])])
                <= 0).all()
        assert s[-1] - s[0] < 32 * ((counts[q] + 31) // 32)


def test_pack_targets_alignment():
    rng = np.random.default_rng(6)
    ts = [rng.integers(0, 21, n).astype(np.uint8) for n in (1, 16, 17, 40)]
    flat, offs = sw_cuda.pack_targets(ts, [3, 0, 2])
    assert (offs % 16 == 0).all() and len(flat) % 16 == 0
    for t, o in zip([3, 0, 2], offs):
        assert np.array_equal(flat[o:o + len(ts[t])], ts[t])
    with pytest.raises(ValueError):
        sw_cuda.pack_targets([np.array([21], np.uint8)], [0])


@pytest.mark.parametrize("mesh_shape", [None, (2, 2)])
def test_score_pairs_emulated_kernel(emulated, mesh_shape):
    """score_pairs routes short queries to the (emulated) kernel in both
    templates and wide queries to the XLA scan, on one device and on a
    2x2 mesh, and every score equals the host engine's."""
    import jax
    from spacepharer_tpu.parallel.sharding import make_mesh
    rng = np.random.default_rng(7)
    qs = [rng.integers(0, 20, n) for n in (5, 11, 16, 17, 23, 32, 33, 70)]
    ts = [rng.integers(0, 20, int(rng.integers(1, 400))) for _ in range(40)]
    ts[5] = np.concatenate([qs[6], qs[7]])
    biases = [rng.integers(-3, 3, len(q)) for q in qs]
    pair_q = rng.integers(0, len(qs), 500)
    pair_t = rng.integers(0, len(ts), 500)
    pair_q[:8] = np.arange(8)
    pair_t[:8] = 5
    mesh = None
    if mesh_shape is not None:
        mesh = make_mesh(*mesh_shape, devices=jax.devices()[:4])
    got = sw_cuda.score_pairs(pair_q, pair_t, qs, ts, M.scores, biases,
                              mesh=mesh)
    want = [_host_score(qs[q], ts[t], biases[q])
            for q, t in zip(pair_q, pair_t)]
    assert got.tolist() == want
    profs, groups = sw_cuda.kernel_groups(pair_q, qs, M.scores, biases)
    assert set(groups) == {16, 32} and len(profs) == 6


def test_device_of_pairs_covers_mesh():
    pair_q = np.repeat(np.arange(6), 10)
    pair_t = np.tile(np.arange(10), 6)
    dev = sw_cuda.device_of_pairs(pair_q, pair_t, (2, 2))
    assert sorted(np.unique(dev).tolist()) == [0, 1, 2, 3]
    assert (dev // 2 == (pair_q >= 3)).all()
    assert (dev % 2 == (pair_t >= 5)).all()


def test_score_pairs_bucketed_long_targets():
    """The XLA scan at real widths: targets past 2048 aa land in their
    own pow2 buckets (no host [B, LT, LQ] tensor), queries of 40-300
    rows, scores exact."""
    rng = np.random.default_rng(8)
    qs = [rng.integers(0, 20, n) for n in (9, 40, 300)]
    ts = [rng.integers(0, 20, n) for n in (30, 700, 2100, 4500)]
    ts[3][1000:1040] = qs[1]
    pairs = [(q, t) for q in range(3) for t in range(4)]
    got = score_pairs_bucketed(pairs, qs, ts, M.scores)
    want = [_host_score(qs[q], ts[t]) for q, t in pairs]
    assert got.tolist() == want
    assert got[1 * 4 + 3] > 100
