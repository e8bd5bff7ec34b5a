"""Engine-routing gate regressions.

The gate constants in pipeline/predictmatch.py are measurements on the
H100 machine (tools/measure_device_gates.py): the device's fixed
overhead, the scoring engines' cell rates and the dense prefilter's
k-mer x residue rate. These tests pin the DECISIONS for representative
workload shapes so a gate regression fails a test, not a production run.
"""
import math

from spacepharer_tpu.pipeline import predictmatch as pm
from spacepharer_tpu.pipeline.predictmatch import (
    _DEVICE_CELLS_THRESHOLD, dense_prefilter_viable,
    device_scoring_engages, scoring_threshold)


class TestDensePrefilterGate:
    def test_small_queries_vs_big_fresh_target_uses_device(self):
        # one host's spacers (100 k-mers) against a fresh gigabase
        # target: the host pays the postings build, the device only
        # its fixed overhead plus 1e11 cells
        assert dense_prefilter_viable(nk_total=100, t_res=10 ** 9,
                                      has_idx=False)

    def test_moderate_fresh_target_stays_on_host(self):
        # flagship shape (golden spacers, 1.6k k-mers x 56.7 M residues):
        # the host builds and walks the index faster than the device
        # matches densely (measured: 5.9 s vs 6.4 s + client init)
        assert not dense_prefilter_viable(nk_total=1_630,
                                          t_res=56_711_840,
                                          has_idx=False)

    def test_catalog_query_side_stays_on_host(self):
        # Shmakov-shaped: 370k query ORFs = ~870k k-mers; the dense
        # product would dwarf the output-sensitive host walk
        assert not dense_prefilter_viable(nk_total=870_000,
                                          t_res=7_400_000, has_idx=False)

    def test_decision_follows_the_cost_model_without_row_cap(self):
        # no hard cap on k-mer rows: the decision is the cost model's
        for nk in (10, 1_000, (1 << 15) + 1, 100_000):
            for t_res in (10 ** 6, 10 ** 8, 10 ** 10, 10 ** 12):
                dense = nk * t_res / pm._DENSE_KMER_RES_PER_S \
                    + pm._DEVICE_OVERHEAD_S
                host = t_res * pm._HOST_POSTINGS_S_PER_RES \
                    + nk * pm._HOST_WALK_S_PER_KMER
                assert dense_prefilter_viable(nk, t_res, False) == \
                    (dense < host), (nk, t_res)

    def test_persisted_index_keeps_host(self):
        # with a persisted postings index the host walk is nearly free;
        # the dense engine can never amortize its fixed overhead
        nk, t_res = 100, 10 ** 9
        assert dense_prefilter_viable(nk, t_res, has_idx=False)
        assert not dense_prefilter_viable(nk, t_res, has_idx=True)

    def test_fixed_overhead_keeps_small_targets_on_host(self):
        # a few spacers against a million residues: the host finishes
        # before the device client is up
        assert not dense_prefilter_viable(nk_total=10, t_res=10 ** 6,
                                          has_idx=False)


class TestScoringEngineGate:
    def test_sparse_candidates_never_probe_the_accelerator(self):
        # catalog-scale: few candidate cells -> host, WITHOUT touching
        # the accelerator probe (device client init costs seconds)
        def boom():
            raise AssertionError("accelerator probe must not run")
        assert device_scoring_engages(None, None, 1e8,
                                      accel_present=boom) is False

    def test_measured_rates_keep_auto_scoring_on_the_host(self):
        # the device engine's marginal rate (it repeats the survivors'
        # host realignment) is below the host aligner's, so no cell
        # count amortizes the overhead; the formula is finite once the
        # device is faster at the margin
        def boom():
            raise AssertionError("accelerator probe must not run")
        assert _DEVICE_CELLS_THRESHOLD == math.inf
        assert not device_scoring_engages(None, None, 1e15,
                                          accel_present=boom)
        assert scoring_threshold(3.5, 2e9, 1e9) == 3.5 / (1e-9 - 5e-10)
        assert scoring_threshold(3.5, 1e9, 1e9) == math.inf

    def test_explicit_flags_win(self):
        def boom():
            raise AssertionError("accelerator probe must not run")
        assert device_scoring_engages(True, None, 0, accel_present=boom)
        assert device_scoring_engages(None, (2, 4), 0, accel_present=boom)
        assert not device_scoring_engages(False, None, 1e30,
                                          accel_present=boom)
        # use_tpu=False beats an explicit mesh (the mesh path is gated
        # on use_tpu is not False upstream)
        assert not device_scoring_engages(False, (2, 4), 1e30,
                                          accel_present=boom)
