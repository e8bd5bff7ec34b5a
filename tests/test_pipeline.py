"""End-to-end predictmatch parity: byte-identical result.tsv."""
import glob
import os

import pytest

from spacepharer_tpu.io.setdb import build_setdb_from_fasta, build_setdb_from_spacers
from spacepharer_tpu.io.spacer_formats import parse_spacers
from spacepharer_tpu.pipeline.predictmatch import PredictParams, predict_match


@pytest.fixture(scope="module")
def dbs(examples_dir):
    genomes = sorted(glob.glob(os.path.join(examples_dir, "GCA_*.fna.gz")))
    tdb = build_setdb_from_fasta(genomes)
    cdb = build_setdb_from_fasta(genomes, reverse_fragments=True)
    recs, sources = parse_spacers(
        sorted(glob.glob(os.path.join(examples_dir, "*.fas"))))
    qdb = build_setdb_from_spacers(recs, sources)
    return qdb, tdb, cdb


def test_predictmatch_matches_reference(dbs, golden):
    qdb, tdb, cdb = dbs
    res = predict_match(qdb, tdb, cdb)
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert res.text == fh.read()


def test_regression_invariant_six_hits(dbs, golden):
    """util/run_regression.sh check 1: exactly 6 hits with p_bh < 1e-3."""
    qdb, tdb, cdb = dbs
    res = predict_match(qdb, tdb, cdb)
    cnt = 0
    for line in res.text.split("\n"):
        if line.startswith(">"):
            fields = line.split("\t")
            if float(fields[2]) < 1e-3:
                cnt += 1
    assert cnt == 6


def test_fmt0_and_fmt2(dbs):
    qdb, tdb, cdb = dbs
    p0 = PredictParams(fmt=0)
    res0 = predict_match(qdb, tdb, cdb, p0)
    assert res0.text and not any(l.startswith(">") for l in res0.text.split("\n"))
    p2 = PredictParams(fmt=2)
    res2 = predict_match(qdb, tdb, cdb, p2)
    # fmt 2 carries gapped alignment lines after each hit line
    lines = res2.text.split("\n")
    gt = [i for i, l in enumerate(lines) if l.startswith(">")]
    assert gt and all(set(lines[i + 1]) <= set("ACGTUNRYSWKMBDHV-acgtn")
                      for i in gt)


@pytest.fixture(scope="module")
def tax_dbs(examples_dir):
    genomes = sorted(glob.glob(os.path.join(examples_dir, "GCA_*.fna.gz")))
    taxdump = os.path.join(examples_dir, "ncbi_taxdump")
    tdb = build_setdb_from_fasta(
        genomes, tax_mapping_file=os.path.join(examples_dir, "genome_taxa.tsv"),
        taxdump_dir=taxdump)
    cdb = build_setdb_from_fasta(genomes, reverse_fragments=True)
    recs, sources = parse_spacers(
        sorted(glob.glob(os.path.join(examples_dir, "*.fas"))))
    qdb = build_setdb_from_spacers(
        recs, sources, tax_mapping_file=os.path.join(examples_dir, "spacer_taxa.tsv"),
        taxdump_dir=taxdump)
    return qdb, tdb, cdb


def test_taxonomy_outputs_match_reference(tax_dbs, golden):
    qdb, tdb, cdb = tax_dbs
    res = predict_match(qdb, tdb, cdb)
    # byte-exact incl. row order: the golden fixture is the reference's
    # single-thread run (with >1 thread the reference's createtsv order
    # is a nondeterministic DBWriter interleaving, createtsv.cpp:85
    # LINEAR_ACCCESS over per-thread concatenation; --threads 1 is its
    # deterministic operating point and matches our key-sorted emission)
    with open(os.path.join(golden, "result.tsv_lca.tsv")) as fh:
        assert res.lca_tsv == fh.read()
    with open(os.path.join(golden, "result.tsv_lca_per_target.tsv")) as fh:
        assert res.lca_per_target_tsv == fh.read()


def test_regression_lca_invariants(tax_dbs):
    """util/run_regression.sh checks 2+3."""
    qdb, tdb, cdb = tax_dbs
    res = predict_match(qdb, tdb, cdb)
    listeria = burkholderia = other = 0
    for line in res.lca_tsv.rstrip("\n").split("\n"):
        taxid = int(line.split("\t")[1])
        if taxid == 40521:
            listeria += 1
        elif taxid == 244310:
            burkholderia += 1
        elif taxid != 0:
            other += 1
    assert (listeria, burkholderia, other) == (5, 1, 0)
    expect = {"GCA_000836905.1_ViralProj14035_genomic.fna.gz": 0,
              "GCA_000845445.1_ViralProj14409_genomic.fna.gz": 28216,
              "GCA_000849645.1_ViralProj14589_genomic.fna.gz": 1639}
    for line in res.lca_per_target_tsv.rstrip("\n").split("\n"):
        f = line.split("\t")
        assert expect[f[0]] == int(f[1])


def test_predictmatch_use_tpu_output_identical(dbs, golden):
    """The device bulk-scoring path (--use-tpu) must reproduce the
    host path byte for byte (here on the CPU jax backend)."""
    qdb, tdb, cdb = dbs
    res = predict_match(qdb, tdb, cdb, PredictParams(use_tpu=True))
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert res.text == fh.read()


def test_predictmatch_device_prefilter_output_identical(dbs, golden):
    """The dense device prefilter (--prefilter-engine device) must
    reproduce the host prefilter byte for byte end-to-end (here via the
    XLA backend on CPU jax; the match stream feeds the same exact
    finalize)."""
    from dataclasses import replace
    qdb, tdb, cdb = dbs
    p = PredictParams()
    p = replace(p, prefilter=replace(p.prefilter, engine="device"))
    res = predict_match(qdb, tdb, cdb, p)
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert res.text == fh.read()


@pytest.mark.parametrize("mesh", [(1, 8), (2, 4), (4, 2)])
def test_predictmatch_mesh_shapes_byte_identical(dbs, golden, mesh):
    """The sharded scoring engine yields byte-identical result.tsv for
    every (q, t) mesh shape — the split-invariance the reference's
    target-split merge guarantees (Prefiltering.h:43-49), here on the
    8-device virtual CPU mesh."""
    qdb, tdb, cdb = dbs
    res = predict_match(qdb, tdb, cdb, PredictParams(mesh=mesh))
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert res.text == fh.read()
