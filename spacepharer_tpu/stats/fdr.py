"""FDR calibration against the reversed-control search.

Parity target: filtermatchbyfdr (src/util/FilterMatchbyFdr.cpp:13-263):
sort positive and control S_comb lists descending, build the ROC-like
curve over unique positive scores, convex-hull slope scan, pi0 = mean of
the last two slopes, walk the curve to the score threshold at the FDR
cutoff; keep rows with score >= threshold (optionally annotating the
interpolated FDR). Also the empirical-P alternative
(src/util/EmpiricalPval.cpp).
"""
import math
import sys

from .aggregation import fmt_e3

DBL_MAX = sys.float_info.max


def compute_fdr_threshold(pos_scores, neg_scores, fdr_cutoff: float,
                          report_fdr: bool = False):
    """Returns (threshold, unique_score_list, fdr_list, messages)."""
    pos = sorted(pos_scores, reverse=True)
    if not pos:
        pos = [0.0]
    messages = []
    unique_scores = []
    fdr_list = []

    if not neg_scores:
        messages.append("Combined score list of control set is empty. "
                        "Printing all matches")
        if report_fdr:
            s = -DBL_MAX
            for p in pos:
                if s < p:
                    unique_scores.append(p)
                    fdr_list.append(0.0)
                    s = p
        return pos[-1], unique_scores, fdr_list, messages

    neg = sorted(neg_scores, reverse=True)

    x = []
    y = []
    current = DBL_MAX
    neg_counter = 0
    pos_counter = 0
    for _ in range(len(pos)):
        if pos[pos_counter] < current:
            current = pos[pos_counter]
            while neg_counter < len(neg) and current < neg[neg_counter]:
                neg_counter += 1
            unique_scores.append(current)
            y.append(pos_counter / len(pos))
            x.append((neg_counter + 0.5) / (len(neg) + 1))
        pos_counter += 1
    x.append(1.0)
    y.append(1.0)

    # convex-hull slope scan (FilterMatchbyFdr.cpp:123-141)
    i = 0
    slope_list = []
    idx_list = []
    while i < len(x) - 1:
        slope_max = 0.0
        j_max = i + 1
        for j in range(i + 1, len(x)):
            dx = x[j] - x[i]
            slope = (y[j] - y[i]) / dx if dx != 0 else math.inf
            if slope >= slope_max:
                j_max = j
                slope_max = slope
        i = j_max
        slope_list.append(slope_max)
        idx_list.append(j_max)

    pi0 = (slope_list[-2] + slope_list[-1]) / 2 if len(slope_list) >= 2 \
        else slope_list[-1]

    i = 0
    current_fdr = 0.0
    if x[idx_list[-1]] * pi0 / y[idx_list[-1]] >= fdr_cutoff:
        while current_fdr <= fdr_cutoff:
            current_fdr = x[idx_list[i]] * pi0 / y[idx_list[i]]
            i += 1

    if i < 2:
        if fdr_cutoff < 1:
            messages.append(f"Combined score list too short. Using threshold 0")
        else:
            messages.append("FDR cutoff is set to 1. Printing all matches.")
        threshold = pos[-1]
    else:
        j = idx_list[i - 2]
        tpfp = y[j]
        fp = x[j] * pi0
        current_fdr = 0.0
        # the walk stops at the lowest positive score at the latest:
        # past it lies only the curve's (1, 1) end point, which has no
        # score of its own (threshold = keep every positive match)
        while current_fdr <= fdr_cutoff and j < len(unique_scores) - 1:
            j += 1
            dx = x[j] - x[j - 1]
            tpfp += dx * slope_list[i - 1]
            fp += dx * pi0
            current_fdr = fp / tpfp
        threshold = unique_scores[j]
        messages.append(f"Combined score threshold is {threshold} with FDR of "
                        f"{fdr_cutoff}.")

    if report_fdr:
        for _ in range(idx_list[0]):
            fdr_list.append(0.0)
        for ii in range(len(idx_list) - 1):
            tpfp = y[idx_list[ii]]
            fp = x[idx_list[ii]] * pi0
            for j in range(idx_list[ii], idx_list[ii + 1]):
                if math.isinf(slope_list[ii]):
                    fdr_list.append(x[idx_list[ii]] * pi0 / y[idx_list[ii]])
                else:
                    tpfp += (x[j] - x[j - 1]) * slope_list[ii]
                    fp += (x[j] - x[j - 1]) * pi0
                    fdr_list.append(fp / tpfp)

    return threshold, unique_scores, fdr_list, messages


def filter_match_by_fdr(pos_entries: dict, neg_entries: dict,
                        fdr_cutoff: float, report_fdr: bool = False):
    """{qset: [[tset, score, seqid], ...]} -> filtered dict (same shape).

    Score column index 1, parsed as double like the reference.
    """
    pos_scores = [float(r[1]) for rows in pos_entries.values() for r in rows]
    neg_scores = [float(r[1]) for rows in neg_entries.values() for r in rows]
    threshold, uniq, fdr_list, messages = compute_fdr_threshold(
        pos_scores, neg_scores if neg_entries else [], fdr_cutoff, report_fdr)
    out = {}
    for key, rows in pos_entries.items():
        kept = []
        for r in rows:
            score = float(r[1])
            if score >= threshold:
                row = list(r[:3])
                if report_fdr:
                    try:
                        idx = uniq.index(score)
                        row.append(str(fdr_list[idx]))
                    except (ValueError, IndexError):
                        row.append("0")
                kept.append(row)
        out[key] = kept
    return out, messages


def empirical_pval(pos_entries: dict, neg_entries: dict):
    """empiricalpval (src/util/EmpiricalPval.cpp): P per pair =
    (n - k + 0.5)/(n + 1) by binary search of the score in the sorted
    control list."""
    neg = sorted(float(r[1]) for rows in neg_entries.values() for r in rows)
    n = len(neg)
    out = {}
    for key, rows in pos_entries.items():
        new_rows = []
        for r in rows:
            score = float(r[1])
            # rank of first element >= score
            import bisect
            k = bisect.bisect_left(neg, score)
            pval = (n - k + 0.5) / (n + 1)
            new_rows.append([r[0], fmt_e3(pval)] + list(r[2:]))
        out[key] = new_rows
    return out
