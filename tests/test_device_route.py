"""The device route of predictmatch on the golden regression bundles:
device scoring (use_tpu=True) with the dense device prefilter, on one
device and on (q, t) meshes of the 8 virtual CPU devices, must give the
golden result.tsv byte for byte.

The inputs are the reference-built DBs of tests/golden_run.tar.gz (the
spacer SetDB easy-predict built, the target SetDB and its reverse
control), so no example corpus is needed. On a GPU the same route runs
the CUDA scorer and the dense prefilter on the GPU (chip_smoke.py
phase 3).
"""
import glob
import os
from dataclasses import replace

import pytest

from spacepharer_tpu.io.setdb import SetDB
from spacepharer_tpu.pipeline.predictmatch import PredictParams, predict_match


@pytest.fixture(scope="module")
def golden_dbs(golden):
    q = sorted(glob.glob(os.path.join(golden, "tmp", "*", "qsetdb")))[0]
    return (SetDB.load(q), SetDB.load(os.path.join(golden, "targets")),
            SetDB.load(os.path.join(golden, "targets_rev")))


@pytest.mark.parametrize("mesh", [None, (1, 2), (2, 4)])
def test_device_route_matches_golden(golden_dbs, golden, mesh):
    qdb, tdb, cdb = golden_dbs
    p = PredictParams(use_tpu=True, mesh=mesh)
    p = replace(p, prefilter=replace(p.prefilter, engine="device"))
    res = predict_match(qdb, tdb, cdb, p)
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert res.text == fh.read()


def test_host_route_matches_golden(golden_dbs, golden):
    qdb, tdb, cdb = golden_dbs
    p = PredictParams(use_tpu=False)
    p = replace(p, prefilter=replace(p.prefilter, engine="host"))
    res = predict_match(qdb, tdb, cdb, p)
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert res.text == fh.read()
