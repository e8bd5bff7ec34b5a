#!/usr/bin/env python3
"""Smoke test of spacepharer's device path on an NVIDIA GPU.

    python chip_smoke.py                  # phases 1-4 on one GPU
    python chip_smoke.py --copies 40      # smaller flagship corpus
    python chip_smoke.py --four-gpus      # the mesh path on four GPUs

Phases (each in its own subprocess, one after another; this process
never opens the GPU, so each child has the card to itself):

1. environment: card name and power limit, jax/jaxlib, XLA_FLAGS, the
   compile-cache directory; fails unless JAX sees a GPU.
2. kernels at real widths: the CUDA Smith-Waterman scorer against
   ops.align._forward_pass on all golden spacer ORFs x all golden
   target ORFs (plus wide queries routed to the XLA scan), timed beside
   the plain-XLA scan; and the dense prefilter's match set against
   match_pairs_numpy on planted motifs over more than one full chunk.
3. golden CLI run: `bin/spacepharer predictmatch --use-tpu 1
   --prefilter-engine device` on the golden run's reference-built DBs;
   result.tsv must equal the golden one byte for byte.
4. flagship-scale CLI run: a seeded 820-copy corpus of the golden
   genomes (~100 M nt), easy-predict on the host engines and on the
   device engines; the two result.tsv must be identical and non-empty.

--four-gpus runs only `easy-predict --shards 1,4` and `--shards 2,2`
on the phase-4 corpus against a one-GPU device run, and the sharded
dry run `__graft_entry__.dryrun_multichip(4)`.

The last line of standard output is one JSON object; "ok" is true only
when every phase passed. Work files go to <repo>/build/chip_smoke/.
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")
SPACEPHARER = os.path.join(HERE, "bin", "spacepharer")
COUNTS_POSITIONS = 1 << 21    # target positions of the counts-only timing


class PhaseError(RuntimeError):
    pass


def run(cmd, timeout, cwd=None, env=None):
    """Run cmd in its own process group; returns (rc, stdout+stderr).
    The whole group is killed when the command ends or times out."""
    t0 = time.time()
    p = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        raise PhaseError(f"timed out after {timeout}s: {' '.join(cmd)}\n"
                         f"{out[-3000:]}")
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    print(f"  [{time.time() - t0:.2f}s] {' '.join(cmd)}", flush=True)
    return p.returncode, out


def worker(name, timeout, *args):
    """Run a phase of this file (`--worker name`) in a child process;
    its last line is a JSON result."""
    rc, out = run([sys.executable, os.path.abspath(__file__), "--worker",
                   name, *args], timeout, cwd=HERE)
    for line in out.splitlines()[:-1]:
        print("  " + line)
    last = out.strip().splitlines()[-1] if out.strip() else ""
    if rc != 0:
        raise PhaseError(f"{name} failed (rc {rc}):\n{out[-4000:]}")
    return json.loads(last)


def cli(args, timeout, log_name):
    rc, out = run([SPACEPHARER, *args], timeout, cwd=WORK)
    with open(os.path.join(WORK, log_name), "w") as fh:
        fh.write(out)
    if rc != 0:
        raise PhaseError(f"spacepharer {args[0]} failed (rc {rc}):\n"
                         f"{out[-4000:]}")
    return out


def stage_times(out):
    return [line for line in out.splitlines()
            if line.startswith("Time for ")]


def check_device_log(out, what):
    """The device engines ran: the dense prefilter on the GPU backend,
    candidate scoring on the device with pairs on the CUDA kernel."""
    need = ["dense device prefilter (gpu)", "-> device scoring engine"]
    for n in need:
        if n not in out:
            raise PhaseError(f"{what}: log lacks '{n}'")
    kern = [line for line in out.splitlines()
            if "pairs on the CUDA kernel" in line]
    if not any(int(line.split()[2]) > 0 for line in kern):
        raise PhaseError(f"{what}: no pairs ran on the CUDA kernel: {kern}")
    for line in out.splitlines():
        if line.startswith(("dense device prefilter", "dense prefilter:",
                            "device scoring",
                            "candidate cells")):
            print("  " + line)


def same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# ---------------------------------------------------------------------------
# phases (parent side)
# ---------------------------------------------------------------------------

def phase_env():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {r.stderr.strip()}")
    print(r.stdout.strip())
    info = worker("env", 300)
    print(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return info


def phase_kernels():
    return worker("kernels", 900)


def phase_golden():
    import __graft_entry__ as ge
    run_dir = ge.golden_run_dir()
    out = cli(["predictmatch", ge.golden_query_setdb(run_dir),
               os.path.join(run_dir, "targets"),
               os.path.join(run_dir, "targets_rev"),
               os.path.join(WORK, "golden_result.tsv"),
               os.path.join(WORK, "golden_tmp"), "--use-tpu", "1",
               "--prefilter-engine", "device", "--force-restart"],
              600, "golden.log")
    check_device_log(out, "golden run")
    if not same_file(os.path.join(WORK, "golden_result.tsv"),
                     os.path.join(run_dir, "result.tsv")):
        raise PhaseError("golden run: result.tsv differs from the golden one")
    print("  result.tsv byte-identical to the golden result.tsv")


def build_corpus(copies):
    corpus = os.path.join(WORK, f"flagship{copies}")
    stamp = os.path.join(corpus, "done")
    if not os.path.exists(stamp):
        rc, out = run([sys.executable,
                       os.path.join(HERE, "tools", "make_flagship_corpus.py"),
                       str(copies), os.path.join(corpus, "genomes"),
                       "--spacers", os.path.join(corpus, "spacers")], 600)
        if rc != 0:
            raise PhaseError(f"corpus build failed:\n{out[-3000:]}")
        print("  " + out.strip().replace("\n", "\n  "))
        genomes = sorted(os.listdir(os.path.join(corpus, "genomes")))
        gpaths = [os.path.join(corpus, "genomes", g) for g in genomes]
        cli(["createsetdb", *gpaths, os.path.join(corpus, "targets"),
             os.path.join(corpus, "tmp")], 900, "createsetdb.log")
        cli(["createsetdb", *gpaths, os.path.join(corpus, "targets_rev"),
             os.path.join(corpus, "tmp"), "--reverse-fragments", "1"], 900,
            "createsetdb_rev.log")
        with open(stamp, "w") as fh:
            fh.write("ok\n")
    spacers = sorted(os.path.join(corpus, "spacers", f)
                     for f in os.listdir(os.path.join(corpus, "spacers")))
    return corpus, spacers


def easy_predict(corpus, spacers, tag, flags, timeout=900):
    out_tsv = os.path.join(corpus, f"result_{tag}.tsv")
    out = cli(["easy-predict", *spacers, os.path.join(corpus, "targets"),
               out_tsv, os.path.join(corpus, f"tmp_{tag}"),
               "--force-restart", *flags], timeout, f"{tag}.log")
    for line in stage_times(out):
        print(f"  {tag}: {line}")
    return out_tsv, out


def phase_flagship(copies):
    corpus, spacers = build_corpus(copies)
    host_tsv, _ = easy_predict(corpus, spacers, "host",
                               ["--use-tpu", "0", "--prefilter-engine",
                                "host"])
    dev_tsv, out = easy_predict(
        corpus, spacers, "device",
        ["--use-tpu", "1", "--prefilter-engine", "device", "--trace-dir",
         os.path.join(WORK, "trace")])
    check_device_log(out, "flagship device run")
    if os.path.getsize(host_tsv) == 0:
        raise PhaseError("flagship: empty result.tsv")
    if not same_file(host_tsv, dev_tsv):
        raise PhaseError("flagship: device result.tsv differs from host")
    n_hits = sum(1 for line in open(host_tsv) if line.startswith("#"))
    print(f"  device result.tsv byte-identical to host "
          f"({os.path.getsize(host_tsv)} bytes, {n_hits} matched sets)")


def phase_four_gpus(copies):
    corpus, spacers = build_corpus(copies)
    dev = ["--use-tpu", "1", "--prefilter-engine", "device"]
    one_tsv, out = easy_predict(corpus, spacers, "device1", dev)
    check_device_log(out, "one-GPU device run")
    for shards in ("1,4", "2,2"):
        tag = "shards" + shards.replace(",", "x")
        tsv, out = easy_predict(corpus, spacers, tag,
                                dev + ["--shards", shards])
        check_device_log(out, f"--shards {shards} run")
        placed = [line for line in out.splitlines()
                  if line.startswith("mesh scoring: inputs on devices")]
        if not placed or any(len(json.loads(line.split("devices ")[1])) != 4
                             for line in placed):
            raise PhaseError(f"--shards {shards}: inputs not on 4 devices: "
                             f"{placed}")
        print(f"  {tag}: {placed[0]}")
        if not same_file(one_tsv, tsv):
            raise PhaseError(f"--shards {shards}: result.tsv differs from "
                             "the one-GPU run")
        print(f"  --shards {shards}: result.tsv byte-identical to one GPU")
    info = worker("dryrun4", 900)
    return info


# ---------------------------------------------------------------------------
# workers (child side: these import jax)
# ---------------------------------------------------------------------------

def _device_info():
    import jax
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def w_env():
    import jax
    import jaxlib
    info = _device_info()
    import spacepharer_tpu  # noqa: F401  (sets the compile cache)
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    print(f"devices: {jax.devices()}")
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {info['platform']}")
    return info


def _timed(fn, reps=3):
    fn()                                  # warm-up (compiles)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def _ref_chunk(args):
    from spacepharer_tpu.ops.align import _forward_pass
    prof, targets = args
    return [int(_forward_pass(prof[:, t].T, 16, 2)[0]) if len(t) else 0
            for t in targets]


def w_kernels():
    import multiprocessing as mp

    import numpy as np

    import __graft_entry__ as ge
    from spacepharer_tpu.io.setdb import SetDB
    from spacepharer_tpu.ops.align import sw_bias_i8
    from spacepharer_tpu.ops.matrices import load_matrix

    # --- SW scorer parity: all golden spacer ORFs x all target ORFs
    run_dir = ge.golden_run_dir()
    qdb = SetDB.load(ge.golden_query_setdb(run_dir))
    tdb = SetDB.load(os.path.join(run_dir, "targets"))
    m = load_matrix("VTML40.out", 2.0)
    qf, qo = qdb.orf_aa_encoded()
    tf, to = tdb.orf_aa_encoded()
    qs = [qf[qo[i]:qo[i + 1]].astype(np.int64) for i in range(len(qo) - 1)]
    ts = [tf[to[i]:to[i + 1]].astype(np.int64) for i in range(len(to) - 1)]
    t_lens = np.diff(to)
    # wide queries the kernel cannot hold: target ORFs of 40+ residues,
    # the longest among them
    order = np.argsort(t_lens)
    wide = [int(order[np.searchsorted(t_lens[order], n)])
            for n in (40, 120, 400)] + [int(order[-1])]
    qs += [ts[i] for i in wide]
    biases = [sw_bias_i8(q, m) for q in qs]
    pair_q = np.repeat(np.arange(len(qs)), len(ts))
    pair_t = np.tile(np.arange(len(ts)), len(qs))
    print(f"SW parity: {len(qs)} queries ({len(wide)} wide, longest "
          f"{max(len(q) for q in qs)}) x {len(ts)} targets (longest "
          f"{int(t_lens.max())}) = {len(pair_q)} pairs")
    t0 = time.time()
    jobs = [(m.scores[q].astype(np.int64) + b[:, None], ts)
            for q, b in zip(qs, biases)]
    with mp.get_context("spawn").Pool(os.cpu_count()) as pool:
        ref = np.array(sum(pool.map(_ref_chunk, jobs), []), dtype=np.int64)
    print(f"_forward_pass reference: {time.time() - t0:.1f}s")

    import jax
    from spacepharer_tpu.ops import sw_cuda
    from spacepharer_tpu.ops.sw_tpu import score_pairs_bucketed
    if not sw_cuda.cuda_available():
        raise SystemExit(f"no GPU backend: {jax.default_backend()}")
    t0 = time.time()
    got = sw_cuda.score_pairs(pair_q, pair_t, qs, ts, m.scores, biases)
    print(f"first score_pairs (nvcc build + compile): "
          f"{time.time() - t0:.1f}s")
    bad = np.flatnonzero(got != ref)
    if len(bad):
        eg = [(int(pair_q[i]), int(pair_t[i]), int(got[i]), int(ref[i]))
              for i in bad[:5]]
        raise SystemExit(f"SW mismatch at {len(bad)} pairs, e.g. {eg}")
    print(f"SW scores exact on all {len(pair_q)} pairs")

    # timing: kernel pairs through the CUDA kernel vs the XLA scan
    profs, groups = sw_cuda.kernel_groups(pair_q, qs, m.scores, biases)
    sel = np.concatenate(list(groups.values()))
    cells = int(sum(len(qs[pair_q[i]]) * t_lens[pair_t[i]] for i in sel))
    calls = []
    for lq, g in groups.items():
        calls.append(sw_cuda.prepare_kernel_call(
            pair_q[g], pair_t[g], profs, ts, lq, 16, 2, None,
            np.zeros(len(g), np.int64)))

    def kernel_only():
        for fn, args, _ in calls:
            jax.block_until_ready(fn(*args))

    t_kernel = _timed(kernel_only, reps=5)
    t_cuda = _timed(lambda: sw_cuda.score_pairs(
        pair_q[sel], pair_t[sel], qs, ts, m.scores, biases), reps=2)
    pairs_sel = np.stack([pair_q[sel], pair_t[sel]], axis=1)
    t_xla = _timed(lambda: score_pairs_bucketed(
        pairs_sel, qs, ts, m.scores, biases, 16, 2), reps=1)
    card = _card()
    print(f"TIMING sw: {len(sel)} pairs, {cells} true cells; CUDA kernel "
          f"alone {t_kernel:.6f}s ({cells / t_kernel:.4g} cells/s); "
          f"score_pairs on CUDA {t_cuda:.6f}s; XLA scan "
          f"(score_pairs_bucketed) {t_xla:.6f}s ({cells / t_xla:.4g} "
          f"cells/s); card {card}")

    # --- dense prefilter parity over more than one full chunk
    from spacepharer_tpu.ops.bias import local_aa_bias
    from spacepharer_tpu.ops.prefilter import PrefilterParams
    from spacepharer_tpu.ops import prefilter_dense as pd
    rng = np.random.default_rng(5)
    params = PrefilterParams(mask=False)
    seed_m = load_matrix(params.seed_matrix, 8.0)
    queries = [rng.integers(0, 20, int(rng.integers(9, 24)))
               for _ in range(64)]
    q_all = [np.asarray(q, np.int64) for q in queries]
    bias80 = [local_aa_bias(q, seed_m) for q in q_all]
    batch = pd.build_query_batch(q_all, list(range(len(q_all))), bias80,
                                 params)
    chunk = pd.default_chunk()
    t_res = chunk + chunk // 3
    lens = rng.integers(30, 600, size=t_res // 30)
    starts = np.concatenate([[0], np.cumsum(lens)])
    starts = starts[:np.searchsorted(starts, t_res)]
    starts = np.append(starts, t_res).astype(np.int64)
    flat = rng.integers(0, 20, size=t_res).astype(np.uint8)
    flat[rng.random(t_res) < 0.05] = 20
    for q in queries:                       # planted motifs
        for _ in range(8):
            p = int(rng.integers(0, t_res - len(q)))
            flat[p:p + len(q)] = q
    bval = pd.target_boundary_valid(starts, batch.span)
    thr = params.kmer_threshold()
    t0 = time.time()
    gi0, gj0 = pd.match_pairs_numpy(batch, flat, bval, seed_m.scores, thr)
    print(f"dense oracle (numpy): {len(gi0)} matches over {t_res} "
          f"positions ({t_res / chunk:.2f} chunks of {chunk}), "
          f"{time.time() - t0:.1f}s")
    res = []
    t_dense = _timed(lambda: res.append(pd.match_pairs_device(
        batch, flat, bval, seed_m.scores, thr)), reps=2)
    gi, gj = res[-1]
    want = sorted(zip(gi0.tolist(), gj0.tolist()))
    if sorted(zip(gi.tolist(), gj.tolist())) != want or not want:
        raise SystemExit(f"dense: match set differs ({len(gi)} vs "
                         f"{len(want)})")
    print(f"dense match set exact ({len(want)} matches)")
    print(f"TIMING dense match_pairs_device: {batch.n_rows} k-mer rows x "
          f"{t_res} positions in {t_dense:.6f}s "
          f"({batch.n_rows * t_res / t_dense:.4g} kmer*res/s); card {card}")
    return _device_info()


def w_dryrun4():
    import __graft_entry__ as ge
    info = _device_info()
    if info["count"] < 4:
        raise SystemExit(f"--four-gpus needs 4 GPUs, JAX sees {info}")
    ge.dryrun_multichip(4)
    print("dryrun_multichip(4) passed")
    return info


WORKERS = {"env": w_env, "kernels": w_kernels, "dryrun4": w_dryrun4}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--copies", type=int, default=820,
                    help="mutated copies per golden genome in phase 4")
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-GPU mesh path")
    ap.add_argument("--phases", default="env,kernels,golden,flagship",
                    help="comma-separated subset of the one-GPU phases")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "spacepharer_tpu")):
        print("chip_smoke: the spacepharer_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.worker:
        info = WORKERS[args.worker]()
        print(json.dumps(info))
        return 0

    os.makedirs(WORK, exist_ok=True)
    t_start = time.time()
    try:
        print("== phase 1: environment", flush=True)
        info = phase_env()
        if args.four_gpus:
            print("== four GPUs: --shards 1,4 and 2,2 vs one GPU, "
                  "dryrun_multichip(4)", flush=True)
            info = phase_four_gpus(args.copies)
        else:
            phases = args.phases.split(",")
            if "kernels" in phases:
                print("== phase 2: kernels at real widths", flush=True)
                info = phase_kernels()
            if "golden" in phases:
                print("== phase 3: golden CLI run", flush=True)
                phase_golden()
            if "flagship" in phases:
                print(f"== phase 4: flagship corpus, {args.copies} copies",
                      flush=True)
                phase_flagship(args.copies)
    except (PhaseError, ValueError, OSError) as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    print(f"all phases passed in {time.time() - t_start:.1f}s; card "
          f"{_card()}")
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
