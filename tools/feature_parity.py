"""Measured parity of the ranker feature plane vs the pandas oracle
(VERDICT r2 item 4).

Runs the framework's fused segment kernels (otto_tpu/features/*) and the
reference-semantics pandas oracle (otto_tpu/eval/feature_oracle.py) over the
IDENTICAL event store and candidate grid, then reports per-column:

- max |delta| over entries where both sides are finite
- NaN-pattern agreement (fraction of entries whose null-ness matches)

plus a protocol-parity block for GroupKFold + negative sampling
(lgb_trainer.py:81-133): fold balance/disjointness, per-fold sampled
negative fraction, and the positive-bearing-session restriction, framework
vs sklearn+pandas.

Writes PARITY_FEATURES.json.  Usage:
  python tools/feature_parity.py [--sessions 50000] [--aids 8000] [--out ...]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def compare(fw: np.ndarray, orc: np.ndarray):
    """(max_abs_diff over both-finite, nan-pattern agreement, n)."""
    fw = np.asarray(fw, np.float64)
    orc = np.asarray(orc, np.float64)
    fnan, onan = np.isnan(fw), np.isnan(orc)
    both = ~fnan & ~onan
    mad = float(np.max(np.abs(fw[both] - orc[both]))) if both.any() else 0.0
    # relative for large-magnitude columns (ts sums etc.)
    scale = max(float(np.max(np.abs(orc[both]))) if both.any() else 1.0, 1.0)
    return {
        "max_abs_diff": round(mad, 9),
        "max_rel_diff": round(mad / scale, 12),
        "nan_pattern_agree": round(float((fnan == onan).mean()), 6),
        "n": int(fw.size),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=50_000)
    ap.add_argument("--aids", type=int, default=8_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="PARITY_FEATURES.json")
    args = ap.parse_args()

    from otto_tpu.data.splits import split_by_time
    from otto_tpu.data.synthetic import synthetic_events_v2
    from otto_tpu.eval import feature_oracle as fo
    from otto_tpu.features import (
        RANKER_FEATURES,
        compute_aid_features,
        compute_interaction_features,
        compute_session_features,
    )
    from otto_tpu.models.candidates import regular_candidates
    from otto_tpu.models.covisitation import build_covisitation
    from otto_tpu.models.ranker import group_kfold, negative_sample_mask

    results: dict = {"config": vars(args)}
    t0 = time.time()
    store = synthetic_events_v2(n_sessions=args.sessions, n_aids=args.aids, seed=args.seed)
    split = split_by_time(store, val_fraction=0.15, seed=args.seed)
    target = split.val_input
    print(f"# data: {store.n_events} events ({time.time()-t0:.0f}s)", flush=True)

    # ---------------- aid features ----------------------------------------
    t0 = time.time()
    fw_aid = compute_aid_features(target, args.aids)
    fw_s = time.time() - t0
    t0 = time.time()
    df = fo.events_to_frame(target)
    or_aid = fo.oracle_aid_features(df)
    or_s = time.time() - t0
    present = np.flatnonzero(fw_aid["aid_count"] > 0)
    # oracle is indexed by present aids; align on the intersection order
    or_aid = or_aid.reindex(present)
    aid_cols = sorted(set(fw_aid) & set(or_aid.columns))
    results["aid_features"] = {
        "framework_s": round(fw_s, 1), "oracle_s": round(or_s, 1),
        "n_aids_present": int(len(present)),
        "columns": {c: compare(fw_aid[c][present], or_aid[c].to_numpy()) for c in aid_cols},
    }
    print(f"# aid features: fw {fw_s:.0f}s oracle {or_s:.0f}s "
          f"({len(aid_cols)} shared columns)", flush=True)

    # ---------------- session features ------------------------------------
    t0 = time.time()
    fw_sess = compute_session_features(target, fw_aid)
    fw_s = time.time() - t0
    t0 = time.time()
    or_sess = fo.oracle_session_features(df, or_aid.set_axis(present, axis=0))
    or_s = time.time() - t0
    or_sess = or_sess.reindex(np.arange(target.n_sessions))
    sess_cols = sorted(set(fw_sess) & set(or_sess.columns))
    results["session_features"] = {
        "framework_s": round(fw_s, 1), "oracle_s": round(or_s, 1),
        "columns": {c: compare(fw_sess[c], or_sess[c].to_numpy()) for c in sess_cols},
    }
    print(f"# session features: fw {fw_s:.0f}s oracle {or_s:.0f}s "
          f"({len(sess_cols)} shared columns)", flush=True)

    # ---------------- interaction features --------------------------------
    mats = build_covisitation(split.train, args.aids)
    cands = regular_candidates(target, mats, labels=split.val_labels)
    c = cands.candidates["orders"]
    s = cands.scores["orders"]
    t0 = time.time()
    fw_int = compute_interaction_features(target, c, s, args.aids)
    fw_s = time.time() - t0
    t0 = time.time()
    or_int = fo.oracle_interaction_features(df, c, s)
    or_s = time.time() - t0
    ok = (c >= 0).reshape(-1)
    int_cols = sorted(set(fw_int) & set(or_int.columns) - {"session", "candidates"})
    results["interaction_features"] = {
        "framework_s": round(fw_s, 1), "oracle_s": round(or_s, 1),
        "n_pairs": int(ok.sum()),
        "columns": {
            col: compare(fw_int[col].reshape(-1)[ok], or_int[col].to_numpy())
            for col in int_cols
        },
    }
    print(f"# interaction features: fw {fw_s:.0f}s oracle {or_s:.0f}s "
          f"({len(int_cols)} shared columns)", flush=True)

    # ---------------- fold + negative-sampling protocol --------------------
    labels = cands.labels["orders"]
    mask = c >= 0
    S, C = c.shape
    sizes = mask.sum(axis=1)
    fw_folds = group_kfold(sizes, 5)
    sess_rows = np.repeat(np.arange(S), C)[mask.reshape(-1)]
    lab_rows = labels.reshape(-1)[mask.reshape(-1)].astype(np.int64)
    oracle_folds = fo.oracle_fold_and_sampling(sess_rows, lab_rows, n_folds=5, ratio=0.30)

    fw_fold_sizes = [int(sizes[fw_folds == f].sum()) for f in range(5)]
    or_fold_sizes = [int(len(f["val_rows"])) for f in oracle_folds]
    rng = np.random.default_rng(0)
    keep = negative_sample_mask(labels, mask, 0.30, rng)
    has_pos = (labels * mask).sum(axis=1) > 0
    negs_eligible = mask & (labels == 0) & has_pos[:, None]
    fw_neg_frac = float((keep & negs_eligible).sum() / max(negs_eligible.sum(), 1))
    fw_stray = int((keep & mask & (labels == 0) & ~has_pos[:, None]).sum())
    pos_sessions = np.unique(sess_rows[lab_rows == 1])
    or_stray = 0
    or_neg_fracs = []
    for f in oracle_folds:
        rows = f["train_rows"]
        r_lab = lab_rows[rows]
        r_sess = sess_rows[rows]
        or_stray += int((~np.isin(r_sess[r_lab == 0], pos_sessions)).sum())
        or_neg_fracs.append(round(f["neg_sampled"] / max(f["neg_eligible"], 1), 4))
    results["protocol"] = {
        "framework_fold_row_sizes": fw_fold_sizes,
        "oracle_fold_val_sizes": or_fold_sizes,
        "fold_balance_framework": round(max(fw_fold_sizes) / max(min(fw_fold_sizes), 1), 4),
        "framework_sampled_negative_fraction": round(fw_neg_frac, 4),
        "oracle_sampled_negative_fractions": or_neg_fracs,
        "target_ratio": 0.30,
        "framework_strays_outside_positive_sessions": fw_stray,
        "oracle_strays_outside_positive_sessions": or_stray,
    }

    pathlib.Path(args.out).write_text(json.dumps(results, indent=1))

    # summary: worst columns per family
    print("\n## Feature parity summary (worst 5 columns per family)")
    for fam in ("aid_features", "session_features", "interaction_features"):
        cols = results[fam]["columns"]
        worst = sorted(cols.items(), key=lambda kv: -kv[1]["max_rel_diff"])[:5]
        print(f"\n{fam}: {len(cols)} columns")
        for name, st in worst:
            print(f"  {name}: max_abs {st['max_abs_diff']:.3g} "
                  f"rel {st['max_rel_diff']:.3g} nan_agree {st['nan_pattern_agree']:.4f}")
    print(f"\nprotocol: {results['protocol']}")
    print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
