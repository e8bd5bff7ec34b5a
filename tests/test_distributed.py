"""Real multi-process jax.distributed smoke (the reference's MPI analog,
MMseqsMPI.{h,cpp} / Prefiltering.cpp:559-600 runMpiSplits).

Two localhost CPU processes (coordinator + worker, 4 virtual devices
each) initialize a cluster, build one GLOBAL 2x4 (q, t) mesh spanning
both processes, run the sharded search pipeline on real ORFs of the
golden bundle's reference-built target SetDB, and assert the
collectively-merged result equals a single-process NumPy oracle.
Skipped if the rendezvous port can't bind.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(r"""
    import sys, os
    addr, pid, targets = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    import jax
    jax.distributed.initialize(coordinator_address=addr, num_processes=2,
                               process_id=pid)
    import numpy as np
    from spacepharer_tpu.alphabet import encode_aa
    from spacepharer_tpu.io.setdb import SetDB
    from spacepharer_tpu.ops.matrices import load_matrix
    from spacepharer_tpu.ops.align import _forward_pass
    from spacepharer_tpu.parallel.sharding import (
        pack_queries, pack_targets, sharded_search_pipeline)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    assert jax.process_count() == 2, jax.process_count()
    devs = np.asarray(jax.devices()).reshape(2, 4)   # global mesh!
    mesh = Mesh(devs, axis_names=("q", "t"))

    tdb = SetDB.load(targets)
    m = load_matrix("VTML40.out", 2.0)
    rng = np.random.default_rng(0)
    qs = [rng.integers(0, 20, int(rng.integers(6, 24))) for _ in range(16)]
    ts = [encode_aa(tdb.orf_aa(i).tobytes())[:48] for i in range(32)]
    set_of_t = np.asarray(tdb.orf_to_set[:32], dtype=np.int32)
    n_sets = int(tdb.set_size.shape[0])
    q_prof, q_len = pack_queries(qs, m.scores, 24)
    t_seqs, t_len = pack_targets(ts, 48, x_index=20)

    def gput(x, spec):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            x.shape, sh, lambda idx: x[idx])

    args = (gput(q_prof, P("q", None, None)), gput(q_len, P("q")),
            gput(t_seqs, P("t", None)), gput(t_len, P("t")),
            gput(set_of_t, P("t")))
    step = sharded_search_pipeline(mesh, top_k=4, n_sets=n_sets)
    scores, idx, best_set = step(*args)
    from jax.experimental import multihost_utils
    scores_g = multihost_utils.process_allgather(scores, tiled=True)
    best_g = multihost_utils.process_allgather(best_set, tiled=True)

    for qi in range(0, 16, 5):
        prof = m.scores[np.asarray(qs[qi], dtype=np.int64)].astype(np.int64)
        allsc = np.array([_forward_pass(prof[:, t].T, 16, 2)[0]
                          if len(t) else 0 for t in ts], dtype=np.int64)
        assert int(scores_g[qi, 0]) == int(allsc.max()), qi
        want = np.zeros(n_sets, dtype=np.int64)
        np.maximum.at(want, set_of_t, allsc)
        assert np.array_equal(np.maximum(want, 0), best_g[qi]), qi
    print(f"DIST-OK-{pid}", flush=True)
""")


def test_two_process_distributed_smoke(tmp_path, golden):
    try:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    except OSError:
        pytest.skip("no localhost port available")
    addr = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    script = str(tmp_path / "worker.py")
    with open(script, "w") as fh:
        fh.write(WORKER)
    procs = [subprocess.Popen(
        [sys.executable, script, addr, str(pid),
         os.path.join(golden, "targets")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(tmp_path)) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, (pid, err[-3000:])
        assert f"DIST-OK-{pid}" in out, (pid, out, err[-1500:])
