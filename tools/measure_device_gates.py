#!/usr/bin/env python3
"""Measure on a GPU the numbers behind the engine gates of
pipeline/predictmatch.py, and the kernel choices behind them:

* fixed device overhead: a fresh process's client init, plus the first
  device scoring call with the compile cache warm (second run);
* candidate scoring rate: the device engine (CUDA scorer + E-value
  screen + native realignment of survivors) against the host engine
  (native batched aligner, all cores) on all golden spacer ORFs x all
  golden target ORFs;
* dense prefilter: the counts step alone, and the k-mer x residue rate
  of the whole device match step (counts + hit-tile extraction).

    python tools/measure_device_gates.py

Prints one line per measurement, with the card's name and power limit.
"""
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PROBE = r"""
import sys, time
t0 = time.perf_counter()
import jax
jax.devices()
t1 = time.perf_counter()
import numpy as np
sys.path.insert(0, sys.argv[1])
from spacepharer_tpu.ops.matrices import load_matrix
from spacepharer_tpu.ops.sw_cuda import score_pairs
m = load_matrix("VTML40.out", 2.0)
rng = np.random.default_rng(0)
qs = [rng.integers(0, 20, 12)]
ts = [rng.integers(0, 20, 300)]
score_pairs([0], [0], qs, ts, m.scores)
t2 = time.perf_counter()
print(f"{t1 - t0:.3f} {t2 - t1:.3f}")
"""


def card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return r.stdout.strip()


def timed(fn, reps=3):
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def overhead():
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", PROBE, REPO],
                             capture_output=True, text=True, check=True)
        wall = time.perf_counter() - t0
        init, first = out.stdout.split()
        print(f"OVERHEAD {run}: process {wall:.3f}s, client init "
              f"{init}s, first device scoring {first}s")


def scoring():
    import numpy as np
    import __graft_entry__ as ge
    from spacepharer_tpu.io.setdb import SetDB
    from spacepharer_tpu.ops.align import AlnParams, align_query_batch
    from spacepharer_tpu.ops.evalue import EvalueComputer, gumbel_params
    from spacepharer_tpu.ops.matrices import load_matrix
    from spacepharer_tpu.pipeline.predictmatch import (PredictParams,
                                                       _search_device)
    run = ge.golden_run_dir()
    qdb = SetDB.load(ge.golden_query_setdb(run))
    tdb = SetDB.load(os.path.join(run, "targets"))
    qf, qo = qdb.orf_aa_encoded()
    tf, to = tdb.orf_aa_encoded()
    q_all = [qf[qo[i]:qo[i + 1]] for i in range(len(qo) - 1)]
    keys = list(range(len(q_all)))
    m40 = load_matrix("VTML40.out", 2.0)
    params = PredictParams(use_tpu=True)
    evaluer = EvalueComputer(gumbel_params("VTML40.out", 16, 2), int(to[-1]))
    cand = {k: list(range(len(to) - 1)) for k in keys}
    cells = int(sum(len(q) for q in q_all)) * int(to[-1])
    t_dev = timed(lambda: _search_device(keys, tf, to, cand, q_all, m40,
                                         evaluer, params))
    t_host = timed(lambda: align_query_batch(
        q_all, [cand[k] for k in keys], tf, to, m40, AlnParams(), evaluer,
        as_rows=True))
    print(f"SCORING {cells} cells ({len(keys)} x {len(to) - 1} pairs): "
          f"device engine {t_dev:.6f}s ({cells / t_dev:.4g} cells/s), host "
          f"engine ({os.cpu_count()} cores) {t_host:.6f}s "
          f"({cells / t_host:.4g} cells/s)")


def dense():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from spacepharer_tpu.ops import prefilter_dense as pd
    from spacepharer_tpu.ops.bias import local_aa_bias
    from spacepharer_tpu.ops.matrices import load_matrix
    from spacepharer_tpu.ops.prefilter import PrefilterParams
    rng = np.random.default_rng(1)
    params = PrefilterParams()
    seed_m = load_matrix(params.seed_matrix, 8.0)
    # spacer-ORF-shaped queries: ~1.2k k-mer rows, the golden run's size
    q_all = [rng.integers(0, 20, int(rng.integers(9, 19))).astype(np.int64)
             for _ in range(90)]
    bias80 = [local_aa_bias(q, seed_m) for q in q_all]
    batch = pd.build_query_batch(q_all, list(range(len(q_all))), bias80,
                                 params)
    nqt = 1
    while nqt * pd.TILE_Q < batch.n_rows:
        nqt *= 2
    rows = nqt * pd.TILE_Q
    t_res = 16 * pd.default_chunk(rows)
    flat = rng.integers(0, 20, size=t_res).astype(np.uint8)
    starts = np.arange(0, t_res + 1, 300, dtype=np.int64)
    starts[-1] = t_res
    bval = pd.target_boundary_valid(starts, batch.span)
    thr = params.kmer_threshold()
    C = pd.default_chunk(rows)
    prep = pd._device_prep_fn(batch.span, tuple(int(o) for o in
                                                batch.offsets), int(thr))
    letters = np.asarray(flat[:C + batch.span - 1], np.int32)
    texp, tval = prep(jnp.asarray(letters), jnp.asarray(bval[:C]),
                      jnp.asarray(np.diag(seed_m.scores).astype(np.int32)))
    qexp = jnp.asarray(pd.build_qexp(batch, seed_m.scores, rows),
                       dtype=jnp.bfloat16)
    thr_np = np.full((rows, 1), float(pd.THR_INVALID), np.float32)
    thr_np[:batch.n_rows, 0] = batch.kmer_thr
    thr_d = jnp.asarray(thr_np)
    cells = rows * C
    t = timed(lambda: jax.block_until_ready(
        pd._counts_xla_fn()(qexp, thr_d, texp, tval)), reps=5)
    print(f"DENSE counts: {rows} rows x {C} positions: {t:.6f}s "
          f"({cells / t:.4g} cells/s)")
    t = timed(lambda: pd.match_pairs_device(batch, flat, bval,
                                            seed_m.scores, thr), reps=2)
    print(f"DENSE match_pairs_device: {batch.n_rows} k-mers x {t_res} "
          f"residues in {t:.6f}s ({batch.n_rows * t_res / t:.4g} "
          f"kmer*res/s)")


if __name__ == "__main__":
    print(f"card: {card()}")
    overhead()
    scoring()
    dense()
