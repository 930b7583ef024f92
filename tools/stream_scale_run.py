"""The production two-stage path at reference serving scale (VERDICT r3 #1).

Runs the full streamed pipeline — covisitation build, ranker training on a
labeled subsample, then shard-streamed candgen -> features -> fold-averaged
GBDT prediction -> prior blend -> top-20 — over >= 1M target sessions at the
reference aid cardinality, with per-stage wall times, per-shard accounting,
peak RSS, and a paired-bootstrap lift CI vs the covisitation heuristic on
the training-disjoint streamed sessions.

Reference scale being matched: 1.8M validation / 5.2M test sessions served
through a 15-shard candidate explode
(src/ranker/regular_candidate_generation.py:226-257) and 20-chunk
fold-averaged prediction (src/ranker/lgb_trainer.py:248-263).

Usage:
  python tools/stream_scale_run.py --sessions 2000000 \
      --aids 1855604 --train-sessions 40000 --out artifacts/LIFT_r04_1M.json
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=2_000_000,
                    help="total sessions; val_fraction of them become the "
                         "streamed target")
    ap.add_argument("--aids", type=int, default=1_855_604)
    ap.add_argument("--val-fraction", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-sessions", type=int, default=40_000)
    ap.add_argument("--shard-sessions", type=int, default=100_000)
    ap.add_argument("--trees", type=int, default=150)
    ap.add_argument("--folds", type=int, default=3)
    ap.add_argument("--early-stop", type=int, default=50)
    ap.add_argument("--selection-seed", type=int, default=17)
    ap.add_argument("--n-boot", type=int, default=1000)
    ap.add_argument("--chunk-sessions", type=int, default=2048)
    ap.add_argument("--max-stream-sessions", type=int, default=0,
                    help="cap streamed sessions (0 = all; recorded in "
                         "timings as stream_capped_at)")
    ap.add_argument("--engine", type=str, default="gbdt",
                    choices=["gbdt", "tower"])
    ap.add_argument("--loss", type=str, default="",
                    help="override the engine's loss (gbdt: lambdarank|bce)")
    ap.add_argument("--matrices-dir", type=str, default="",
                    help="load/save covisitation matrices here (crash resume)")
    ap.add_argument("--artifact-dir", type=str, default="",
                    help="per-stage artifact persistence for the training "
                         "subcall (crash resume)")
    ap.add_argument("--out", type=str, default="artifacts/LIFT_r04_1M.json")
    args = ap.parse_args()

    import jax

    from otto_tpu.utils.runtime import enable_compilation_cache

    enable_compilation_cache()

    from otto_tpu.logging_utils import configure_logging

    # the framework's idempotent configurator, not logging.basicConfig: the
    # otto_tpu subtree keeps ONE handler/format for the whole run and root-
    # level INFO from third-party libs stays quiet (ADVICE r4)
    configure_logging()

    from otto_tpu import EVENT_TYPES
    from otto_tpu.config import GBDTConfig, RankerConfig
    from otto_tpu.data.splits import split_by_time
    from otto_tpu.data.synthetic import synthetic_events_v2
    from otto_tpu.models.covisitation import CovisitationMatrices, build_covisitation
    from otto_tpu.streaming import run_two_stage_streamed

    results: dict = {"config": vars(args), "platform": jax.default_backend()}
    out_path = pathlib.Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    def flush():
        out_path.write_text(json.dumps(results, indent=1))

    t0 = time.time()
    store = synthetic_events_v2(n_sessions=args.sessions, n_aids=args.aids,
                                seed=args.seed)
    split = split_by_time(store, val_fraction=args.val_fraction, seed=args.seed)
    del store
    results["datagen_s"] = round(time.time() - t0, 1)
    results["train_events"] = int(split.train.n_events)
    results["target_sessions"] = int(split.val_input.n_sessions)
    results["target_events"] = int(split.val_input.n_events)
    print(f"# data: train {split.train.n_events} events, target "
          f"{split.val_input.n_sessions} sessions "
          f"({results['datagen_s']}s)", flush=True)
    flush()

    matrices = None
    if args.matrices_dir:
        mdir = pathlib.Path(args.matrices_dir)
        if (mdir / "covisit_time_weighted.npz").exists():
            t0 = time.time()
            matrices = CovisitationMatrices.load(mdir)
            print(f"# matrices loaded from {mdir} ({time.time()-t0:.0f}s)",
                  flush=True)
        else:
            t0 = time.time()
            matrices = build_covisitation(split.train, args.aids)
            results["covisit_build_s"] = round(time.time() - t0, 1)
            mdir.mkdir(parents=True, exist_ok=True)
            matrices.save(mdir)
            print(f"# matrices built ({results['covisit_build_s']}s)", flush=True)
            flush()

    if args.engine == "tower":
        cfg = RankerConfig(hidden_dims=(256, 128), n_folds=args.folds,
                           epochs=8, batch_sessions=512, dropout=0.0,
                           loss="lambdarank")
    else:
        cfg = GBDTConfig(n_trees=args.trees, n_folds=args.folds,
                         early_stopping_rounds=args.early_stop,
                         min_data_in_leaf=200,
                         **({"loss": args.loss} if args.loss else {}))

    shard_count = [0]

    def _progress(timings, shard_times, extras=None):
        # partial artifact after every shard: a killed run still leaves
        # per-stage evidence on disk — including an incremental lift + CI
        # over the sessions streamed so far (every 4th shard), so ANY
        # cutoff still carries the flagship number
        results["timings_partial"] = timings
        results["shards"] = shard_times
        shard_count[0] += 1
        if extras is not None and extras.get("labels") is not None and (
                shard_count[0] % 4 == 0):
            from otto_tpu import EVENT_TYPES
            from otto_tpu.eval.harness import (evaluate_predictions,
                                               paired_bootstrap_lift)

            hi = extras["hi"]
            idx = extras["streamed_idx"][:hi]
            lab = extras["labels"].take(idx)
            pr = {t: extras["predictions"][t][:hi] for t in EVENT_TYPES}
            hr = {t: extras["heuristic_predictions"][t][:hi] for t in EVENT_TYPES}
            rep = evaluate_predictions(lab, pr["clicks"], pr["carts"], pr["orders"])
            hrep = evaluate_predictions(lab, hr["clicks"], hr["carts"], hr["orders"])
            boot = paired_bootstrap_lift(lab, pr, hr, n_boot=200,
                                         seed=args.selection_seed)
            results["partial_lift"] = {
                "sessions": int(hi),
                "two_stage_weighted": round(rep.weighted, 6),
                "heuristic_weighted": round(hrep.weighted, 6),
                "lift": round(rep.weighted - hrep.weighted, 6),
                "bootstrap": boot,
            }
            print(f"# partial lift @ {hi}: {rep.weighted - hrep.weighted:+.6f} "
                  f"ci95 {boot['ci95']}", flush=True)
        flush()
        print(f"# shard done: {timings.get('streamed_so_far')} sessions "
              f"streamed", flush=True)

    res = run_two_stage_streamed(
        split.train, split.val_input, args.aids, labels=split.val_labels,
        ranker_config=cfg,
        train_sessions=args.train_sessions,
        shard_sessions=args.shard_sessions,
        selection_seed=args.selection_seed,
        chunk_sessions=args.chunk_sessions,
        matrices=matrices,
        artifact_dir=args.artifact_dir or None,
        n_boot=args.n_boot,
        progress_cb=_progress,
        max_stream_sessions=args.max_stream_sessions,
    )
    results.pop("timings_partial", None)

    def _rep(rep):
        return {"weighted": rep.weighted, "corpus_weighted": rep.corpus_weighted,
                **{t: getattr(rep, t) for t in EVENT_TYPES}}

    results["timings"] = res.timings
    results["shards"] = res.shard_times
    results["two_stage_streamed"] = _rep(res.report)
    results["heuristic_streamed"] = _rep(res.heuristic_report)
    results["lift_vs_heuristic_disjoint"] = round(res.lift_vs_heuristic, 6)
    results["bootstrap_vs_heuristic_disjoint"] = res.bootstrap_vs_heuristic
    # training-subcall internals for the record
    if res.artifacts.report is not None:
        results["train_subsample_report"] = _rep(res.artifacts.report)
    if res.artifacts.report_disjoint is not None:
        results["train_subsample_report_disjoint"] = _rep(res.artifacts.report_disjoint)
    results["max_recall_train_subsample"] = res.artifacts.max_recall
    flush()
    b = res.bootstrap_vs_heuristic or {}
    print(f"\n# streamed {res.timings['streamed_sessions']} sessions in "
          f"{res.timings['stream_s']}s "
          f"({res.timings.get('stream_sessions_per_s', 0)}/s, "
          f"{res.timings.get('ranker_rows_per_s', 0)} ranker rows/s); "
          f"lift vs heuristic {results['lift_vs_heuristic_disjoint']:+.6f} "
          f"ci95 {b.get('ci95')} p<=0 {b.get('p_le_0')}", flush=True)
    print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
