#!/usr/bin/env python3
"""Generate a GenBank_phage_2018_09-shaped target corpus: N mutated
copies of each of the three phage genomes of the golden regression run
(tests/golden_run.tar.gz, the reference's own example genomes),
point-mutated at --rate so that NO two contigs are identical — no
duplicate-contig tie-break artifact, so byte-equality stays the parity
bar at flagship scale (reference README.md:77: ~8000 phage genomes,
~400 Mbp; data/genbank_phages_2018_09.tsv).

    python tools/make_flagship_corpus.py 820 build/flagship100M \
        --spacers build/spacers
        -> 2460 genomes, ~100.5 M nt (+ the golden spacers as FASTA)

Each output file holds one genome (file number = set id, matching
createdb's set semantics, lib/mmseqs/src/util/createdb.cpp:15).
--spacers also writes the golden run's spacer DB (`query`) as one FASTA
file per spacer set, the input of easy-predict.
"""
import argparse
import gzip
import os
import tarfile
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_TAR = os.path.join(REPO, "tests", "golden_run.tar.gz")
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _db(run_dir, name):
    import sys
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from spacepharer_tpu.io.mmseqs_compat import MMseqsDB
    return MMseqsDB(os.path.join(run_dir, name))


def golden_genomes(run_dir):
    """[(source file name, header, seq uint8)] of the golden targets."""
    nucl, heads = _db(run_dir, "targets_nucl"), _db(run_dir, "targets_nucl_h")
    names = dict(nucl.source())
    files = {key: num for key, _, num in nucl.lookup()}
    out = []
    for i, key in enumerate(nucl.keys):
        seq = nucl.get_by_rank(i).rstrip(b"\0").strip()
        header = heads.get_by_rank(i).rstrip(b"\0").strip().decode()
        out.append((names[files[int(key)]], header,
                    np.frombuffer(seq, dtype=np.uint8)))
    return out


def write_golden_spacers(run_dir, outdir):
    """One FASTA file per spacer set of the golden `query` DB."""
    query, heads = _db(run_dir, "query"), _db(run_dir, "query_h")
    names = dict(query.source())
    files = {key: num for key, _, num in query.lookup()}
    os.makedirs(outdir, exist_ok=True)
    per_file = {num: [] for num in names}
    for i, key in enumerate(query.keys):
        seq = query.get_by_rank(i).rstrip(b"\0").strip()
        header = heads.get_by_rank(i).rstrip(b"\0").strip()
        per_file[files[int(key)]].append(b">" + header + b"\n" + seq + b"\n")
    n = 0
    for num, recs in sorted(per_file.items()):
        if recs:
            with open(os.path.join(outdir, names[num] + ".fas"), "wb") as fh:
                fh.write(b"".join(recs))
            n += 1
    return n


def mutate(seq, rate, rng):
    """Point-substitute ~rate of the ACGT positions (always to a
    DIFFERENT base, so every copy differs from the original)."""
    out = seq.copy()
    # map ACGT (either case) -> 0..3; others untouched
    lut = np.full(256, 255, dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
        lut[b + 32] = i
    code = lut[seq]
    is_base = code != 255
    hit = is_base & (rng.random(seq.shape[0]) < rate)
    n = int(hit.sum())
    if n:
        # new base = (old + 1..3) mod 4: never the same base
        shift = rng.integers(1, 4, size=n).astype(np.uint8)
        out[hit] = BASES[(code[hit] + shift) % 4]
    return out


def write_gz(path, header, seq, width=70):
    pad = (-len(seq)) % width
    mat = np.concatenate([seq, np.full(pad, ord(" "), np.uint8)])
    mat = mat.reshape(-1, width)
    lines = b"\n".join(row.tobytes().rstrip() for row in mat)
    with gzip.open(path, "wb", compresslevel=1) as fh:
        fh.write(b">" + header.encode() + b"\n" + lines + b"\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_copies", type=int,
                    help="mutated copies per example genome")
    ap.add_argument("outdir")
    ap.add_argument("--rate", type=float, default=0.02,
                    help="per-base substitution rate (default 2%%)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spacers", default=None, metavar="DIR",
                    help="also write the golden spacer sets as FASTA here")
    ap.add_argument("--golden-tar", default=GOLDEN_TAR)
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.outdir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=args.outdir) as tmp:
        with tarfile.open(args.golden_tar) as tf:
            tf.extractall(tmp, filter="tar")
        run_dir = os.path.join(tmp, "run")
        genomes = golden_genomes(run_dir)
        if args.spacers:
            n_sets = write_golden_spacers(run_dir, args.spacers)
            print(f"wrote {n_sets} spacer sets to {args.spacers}")
    total = 0
    n_files = 0
    for src, header, seq in genomes:
        acc = header.split()[0]
        base = src[:-len(".fna.gz")] if src.endswith(".fna.gz") else src
        for ci in range(args.n_copies):
            mseq = mutate(seq, args.rate, rng)
            name = f"{base}_mut{ci:05d}.fna.gz"
            write_gz(os.path.join(args.outdir, name),
                     f"{acc}_mut{ci:05d} mutated copy {ci}", mseq)
            total += len(mseq)
            n_files += 1
    print(f"wrote {n_files} genomes, {total} nt to {args.outdir}")


if __name__ == "__main__":
    main()
