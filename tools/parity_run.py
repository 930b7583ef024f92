"""Realistic-scale oracle-vs-framework parity run (VERDICT round-1 item 1).

Generates a power-law + temporal-drift synthetic dataset (default 1M sessions,
100k aids — OTTO-shaped), builds the covisitation matrices with the framework,
then runs BOTH the framework's batched device kernels and the reference-semantics
oracle (otto_tpu/eval/oracle.py) over the identical inputs:

- covisitation heuristic recommender (both routes),
- production regular candidate generator,

and reports per-route/per-type exact-list agreement, set agreement, recall@20
per side, and itemized divergence buckets.  Writes JSON to --out and a
markdown summary to stdout.

Usage:  python tools/parity_run.py [--sessions 1000000] [--aids 100000]
        [--out /tmp/parity.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


import numpy as np


def make_neighbor_table(n_aids: int, nn: int, seed: int) -> np.ndarray:
    """Deterministic distinct-non-self kNN stand-in (parity exercises the
    bonus/vote semantics, not neighbor quality)."""
    rng = np.random.default_rng(seed)
    draw = rng.integers(0, n_aids - 1, size=(n_aids, nn + 8), dtype=np.int64)
    out = np.empty((n_aids, nn), np.int32)
    for a in range(n_aids):
        row = np.unique(draw[a])
        row = row[row != a]
        if len(row) < nn:  # pad deterministically (vanishingly rare)
            extra = [(a + i) % n_aids for i in range(1, nn + 2)]
            row = np.unique(np.concatenate([row, extra]))
            row = row[row != a]
        sel = row[rng.permutation(len(row))[:nn]]
        out[a] = sel
    return out


def rows_to_lists(arr) -> list[list[int]]:
    return [[int(x) for x in row if x >= 0] for row in arr]


def agreement(framework_rows, oracle_rows):
    n = len(oracle_rows)
    exact = sum(f == o for f, o in zip(framework_rows, oracle_rows))
    setm = sum(set(f) == set(o) for f, o in zip(framework_rows, oracle_rows))
    return exact / n, setm / n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=1_000_000)
    ap.add_argument("--aids", type=int, default=100_000)
    ap.add_argument("--val-fraction", type=float, default=0.12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="/tmp/parity.json")
    ap.add_argument("--save-matrices", type=str, default="")
    ap.add_argument("--load-matrices", type=str, default="")
    ap.add_argument("--recency-host-f64", action="store_true",
                    help="route >=20-unique sessions through the float64 host "
                         "accumulator (exact reference tie-breaks, VERDICT r2 "
                         "item 6)")
    args = ap.parse_args()

    from otto_tpu.utils.runtime import enable_compilation_cache

    enable_compilation_cache()
    from otto_tpu import EVENT_TYPES
    from otto_tpu.data.splits import split_by_time
    from otto_tpu.data.synthetic import synthetic_events_v2
    from otto_tpu.eval import oracle as orc
    from otto_tpu.models.candidates import regular_candidates
    from otto_tpu.models.covisitation import (
        CovisitationMatrices,
        build_covisitation,
        covisit_heuristic_predictions,
        session_unique_counts,
    )
    from otto_tpu.models.frequency import FrequencyStatistics

    results: dict = {"config": vars(args)}

    t0 = time.time()
    store = synthetic_events_v2(n_sessions=args.sessions, n_aids=args.aids, seed=args.seed)
    split = split_by_time(store, val_fraction=args.val_fraction, seed=args.seed)
    print(f"# data: {store} (gen {time.time()-t0:.0f}s); "
          f"train {split.train.n_events} ev / val {split.val_input.n_sessions} sessions",
          flush=True)

    t0 = time.time()
    if args.load_matrices:
        mats = CovisitationMatrices.load(args.load_matrices)
        build_s = 0.0
    else:
        mats = build_covisitation(split.train, args.aids)
        build_s = time.time() - t0
        if args.save_matrices:
            mats.save(args.save_matrices)
    results["covisit_build_s"] = round(build_s, 1)
    results["covisit_build_events_per_s"] = round(split.train.n_events / max(build_s, 1e-9), 0)
    print(f"# covisit build: {build_s:.0f}s", flush=True)

    stats = FrequencyStatistics.compute(split.train, n_aids=args.aids)
    stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
    ft45 = make_neighbor_table(args.aids, 45, seed=123)
    ft20 = ft45[:, :20]

    val = split.val_input
    aid_lists, type_lists = orc.store_to_lists(val)
    lab = orc.labels_to_lists(split.val_labels)
    uniq_counts = session_unique_counts(val)
    routes = {
        "covisitation": np.flatnonzero(uniq_counts < 20),
        "recency_weight": np.flatnonzero(uniq_counts >= 20),
    }
    results["route_sessions"] = {k: int(len(v)) for k, v in routes.items()}

    # ---------------- heuristic: framework vs oracle ----------------------
    t0 = time.time()
    fw = covisit_heuristic_predictions(
        val, mats, stats_top, ft_neighbors=ft45,
        recency_host_f64=args.recency_host_f64,
    )
    fw_s = time.time() - t0
    t0 = time.time()
    tables15 = {k: orc.table_to_dict(mats.tables[k][0], 15) for k in mats.tables}
    freq = {t: [int(a) for a in stats.top_by_type[t]] for t in EVENT_TYPES}
    orx = orc.oracle_heuristic(aid_lists, type_lists, tables15, freq, orc.neighbor_lists(ft45))
    or_s = time.time() - t0

    heur = {"framework_s": round(fw_s, 1), "oracle_s": round(or_s, 1),
            "framework_sessions_per_s": round(val.n_sessions / fw_s, 0)}
    fw_lists = {t: rows_to_lists(fw[t]) for t in EVENT_TYPES}
    for t in EVENT_TYPES:
        per_route = {}
        for rname, ridx in routes.items():
            if not len(ridx):
                continue
            e, s = agreement([fw_lists[t][i] for i in ridx], [orx[t][i] for i in ridx])
            per_route[rname] = {"exact": round(e, 5), "set": round(s, 5)}
        e, s = agreement(fw_lists[t], orx[t])
        heur[t] = {"exact": round(e, 5), "set": round(s, 5), "routes": per_route}
    r_fw = orc.weighted_corpus_recall(fw_lists, lab)
    r_or = orc.weighted_corpus_recall(orx, lab)
    heur["recall_framework"] = {k: round(v, 6) for k, v in r_fw.items()}
    heur["recall_oracle"] = {k: round(v, 6) for k, v in r_or.items()}
    heur["recall_delta_weighted"] = round(r_fw["weighted"] - r_or["weighted"], 6)
    results["heuristic"] = heur
    print(f"# heuristic done: fw {fw_s:.0f}s oracle {or_s:.0f}s", flush=True)

    # -------------- regular candidates: framework vs oracle ---------------
    t0 = time.time()
    cs = regular_candidates(val, mats, ft_neighbors=ft20, wide_k=20)
    fw_s = time.time() - t0
    t0 = time.time()
    tables20 = {k: orc.table_to_dict(mats.tables[k][0], 20) for k in mats.tables}
    ocs = orc.oracle_regular_candidates(aid_lists, type_lists, tables20, orc.neighbor_lists(ft20))
    or_s = time.time() - t0

    n_uniq = np.array([len(set(a)) for a in aid_lists])
    capped = n_uniq > 32  # framework vote_cap/uniq_cap binding
    cand = {"framework_s": round(fw_s, 1), "oracle_s": round(or_s, 1),
            "framework_sessions_per_s": round(val.n_sessions / fw_s, 0),
            "cap_binding_fraction": round(float(capped.mean()), 5)}
    free = np.flatnonzero(~capped)
    for t in EVENT_TYPES:
        f_rows = rows_to_lists(cs.candidates[t])
        o_rows = ocs[t][0]
        e_all, s_all = agreement(f_rows, o_rows)
        e_free, s_free = agreement([f_rows[i] for i in free], [o_rows[i] for i in free])
        # candidate-set recall ceiling both sides
        labmap = {"clicks": lab[0], "carts": lab[1], "orders": lab[2]}[t]
        cand[t] = {
            "exact": round(e_all, 5), "set": round(s_all, 5),
            "exact_uncapped": round(e_free, 5), "set_uncapped": round(s_free, 5),
            "ceiling_framework": round(orc.corpus_recall(f_rows, labmap), 6),
            "ceiling_oracle": round(orc.corpus_recall(o_rows, labmap), 6),
        }
    results["regular_candidates"] = cand

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)

    # markdown summary
    print("\n## Oracle parity summary")
    print(f"dataset: {args.sessions:,} sessions / {args.aids:,} aids / "
          f"{store.n_events:,} events; val {val.n_sessions:,} sessions "
          f"(covisit route {results['route_sessions']['covisitation']:,}, "
          f"recency route {results['route_sessions']['recency_weight']:,})")
    print("\n| path | type | exact | set | fw recall | oracle recall |")
    print("|---|---|---|---|---|---|")
    for t in EVENT_TYPES:
        print(f"| heuristic | {t} | {heur[t]['exact']:.4f} | {heur[t]['set']:.4f} | "
              f"{r_fw[t]:.6f} | {r_or[t]:.6f} |")
    for t in EVENT_TYPES:
        print(f"| candgen | {t} | {cand[t]['exact']:.4f} | {cand[t]['set']:.4f} | "
              f"{cand[t]['ceiling_framework']:.6f} | {cand[t]['ceiling_oracle']:.6f} |")
    print(f"\nweighted recall: framework {r_fw['weighted']:.6f} vs oracle "
          f"{r_or['weighted']:.6f} (delta {heur['recall_delta_weighted']:+.6f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
