"""Test-week submission dress rehearsal (VERDICT r4 item 8).

The reference's final deliverable is a gzip CSV of top-20 predictions for
~5.2M test sessions, produced by sharded candidate generation + fold-averaged
GBDT prediction + a final format pass
(src/ranker/inference.py:402-407,570-573; regular_candidate_generation.py:
226-257 15-shard explode).  This tool exercises the framework's equivalent at
that scale: prediction-only streaming (``run_two_stage_streamed`` with
pre-trained artifacts, no labels) over a fresh test-week session store at the
full 1,855,604-aid cardinality, followed by the native submission writer,
with row-count and format assertions on the produced file.

Usage (after a training run has populated an artifact dir):
  python tools/submission_rehearsal.py --sessions 5200000 \
      --artifact-dir art_1m --matrices-dir mats_1m \
      --out artifacts/SUBMISSION_r05.json
"""

from __future__ import annotations

import argparse
import gzip
import json
import pathlib
import resource
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=5_200_000,
                    help="test-week session count (reference: ~5.2M)")
    ap.add_argument("--aids", type=int, default=1_855_604)
    ap.add_argument("--train-sessions-source", type=int, default=2_000_000,
                    help="session count of the ORIGINAL training datagen "
                         "(split in half by time; its train half feeds "
                         "frequency stats + aid features, matching the fit)")
    ap.add_argument("--seed", type=int, default=0, help="training datagen seed")
    ap.add_argument("--test-seed", type=int, default=101,
                    help="test-week datagen seed (disjoint sessions)")
    ap.add_argument("--shard-sessions", type=int, default=100_000)
    ap.add_argument("--chunk-sessions", type=int, default=2048)
    ap.add_argument("--artifact-dir", type=str, required=True)
    ap.add_argument("--matrices-dir", type=str, default="")
    ap.add_argument("--submission-path", type=str,
                    default="submission.csv.gz")
    ap.add_argument("--out", type=str, default="artifacts/SUBMISSION_r05.json")
    args = ap.parse_args()

    import jax

    from otto_tpu.utils.runtime import enable_compilation_cache

    enable_compilation_cache()

    from otto_tpu.logging_utils import configure_logging

    configure_logging()

    from otto_tpu import EVENT_TYPES, TOP_K
    from otto_tpu.data.splits import split_by_time
    from otto_tpu.data.submission import write_submission
    from otto_tpu.data.synthetic import synthetic_events_v2
    from otto_tpu.models.covisitation import CovisitationMatrices
    from otto_tpu.models.gbdt import load_ranker_model
    from otto_tpu.streaming import run_two_stage_streamed
    from otto_tpu.twostage import TwoStageArtifacts

    results: dict = {"config": vars(args), "platform": jax.default_backend()}
    out_path = pathlib.Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    def flush():
        out_path.write_text(json.dumps(results, indent=1))

    # ---- training-side stores (reproduce the fit-time train split) -------
    t0 = time.time()
    store = synthetic_events_v2(n_sessions=args.train_sessions_source,
                                n_aids=args.aids, seed=args.seed)
    split = split_by_time(store, val_fraction=0.5, seed=args.seed)
    train = split.train
    del store, split
    results["train_datagen_s"] = round(time.time() - t0, 1)

    # ---- test-week store -------------------------------------------------
    t0 = time.time()
    target = synthetic_events_v2(n_sessions=args.sessions, n_aids=args.aids,
                                 seed=args.test_seed)
    results["test_datagen_s"] = round(time.time() - t0, 1)
    results["test_sessions"] = int(target.n_sessions)
    results["test_events"] = int(target.n_events)
    print(f"# test week: {target.n_sessions} sessions, {target.n_events} "
          f"events ({results['test_datagen_s']}s)", flush=True)
    flush()

    # ---- artifacts -------------------------------------------------------
    adir = pathlib.Path(args.artifact_dir)
    t0 = time.time()
    if args.matrices_dir and (pathlib.Path(args.matrices_dir)
                              / "covisit_time_weighted.npz").exists():
        matrices = CovisitationMatrices.load(pathlib.Path(args.matrices_dir))
    else:
        matrices = CovisitationMatrices.load(adir / "covisitation")
    meta = json.loads((adir / "meta.json").read_text())
    rankers = {name: load_ranker_model(adir / f"ranker_{name}.npz")
               for name in meta["ranker_names"] if not name.endswith("_b")}
    artifacts = TwoStageArtifacts(
        matrices=matrices, sgns=None, candidates=None, rankers=rankers,
        predictions={}, report=None, max_recall=meta.get("max_recall", {}),
        heuristic_union=meta.get("heuristic_union", True),
        feature_list=meta.get("feature_list"),
    )
    results["artifact_load_s"] = round(time.time() - t0, 1)
    print(f"# artifacts loaded ({results['artifact_load_s']}s): "
          f"{sorted(rankers)}", flush=True)
    flush()

    # ---- prediction-only streaming --------------------------------------
    def _progress(timings, shard_times, extras=None):
        results["timings_partial"] = timings
        results["shards"] = shard_times
        flush()
        print(f"# shard done: {timings.get('streamed_so_far')} sessions",
              flush=True)

    res = run_two_stage_streamed(
        train, target, args.aids, labels=None,
        artifacts=artifacts,
        shard_sessions=args.shard_sessions,
        chunk_sessions=args.chunk_sessions,
        matrices=matrices,
        n_boot=0,
        progress_cb=_progress,
    )
    results.pop("timings_partial", None)
    results["timings"] = res.timings
    results["shards"] = res.shard_times
    flush()
    print(f"# streamed {res.timings['streamed_sessions']} sessions in "
          f"{res.timings['stream_s']}s", flush=True)

    # ---- submission file -------------------------------------------------
    sub_path = pathlib.Path(args.submission_path)
    t0 = time.time()
    write_submission(sub_path, target.session_ids, res.predictions)
    results["write_s"] = round(time.time() - t0, 1)
    results["file_mb"] = round(sub_path.stat().st_size / 1e6, 1)

    # ---- assertions: row count + format ----------------------------------
    t0 = time.time()
    n_rows = 0
    seen_types = {t: 0 for t in EVENT_TYPES}
    bad = 0
    with gzip.open(sub_path, "rt") as f:
        header = f.readline()
        assert header.strip() == "session_type,labels", header
        for i, line in enumerate(f):
            n_rows += 1
            if i < 200_000:  # full parse of a prefix; count-only beyond
                st, labels = line.rstrip("\n").split(",", 1)
                sid, etype = st.rsplit("_", 1)
                seen_types[etype] += 1
                toks = labels.split()
                if len(toks) > TOP_K or any(not t.isdigit() for t in toks):
                    bad += 1
    results["verify_s"] = round(time.time() - t0, 1)
    results["rows"] = int(n_rows)
    results["rows_expected"] = int(target.n_sessions * 3)
    results["rows_match"] = bool(n_rows == target.n_sessions * 3)
    results["prefix_bad_rows"] = int(bad)
    results["prefix_type_counts"] = seen_types
    results["peak_rss_gb"] = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2)
    flush()
    assert results["rows_match"], (n_rows, target.n_sessions * 3)
    assert bad == 0
    print(f"# submission: {n_rows} rows ({results['file_mb']} MB) "
          f"write {results['write_s']}s verify {results['verify_s']}s — OK",
          flush=True)
    print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
