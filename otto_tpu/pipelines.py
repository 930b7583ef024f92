"""End-to-end pipeline entry points (validation / submission modes).

Each reference model script is an argparse ``__main__`` with a
``mode in {validation, submission}`` contract writing files under hardcoded
paths.  Here the equivalents are plain functions over in-memory stores, plus a
small CLI (``python -m otto_tpu.pipelines``) for file-based runs.
"""

from __future__ import annotations

from dataclasses import dataclass


import numpy as np

from otto_tpu import EVENT_TYPES, TOP_K
from otto_tpu.config import DataConfig
from otto_tpu.data import EventStore, splits, submission
from otto_tpu.data.labels import SessionLabels
from otto_tpu.eval import RecallReport, evaluate_predictions
from otto_tpu.logging_utils import get_logger
from otto_tpu.models.frequency import FrequencyStatistics, aid_frequency_predictions
from otto_tpu.models.recency import (
    SUBMISSION_COEFFICIENTS,
    VALIDATION_COEFFICIENTS,
    aid_weight_predictions,
)

log = get_logger(__name__)

# Device-friendly packing width: sessions longer than this keep their most
# recent MAX_SESSION_LEN events (recency weights still use true positions).
MAX_SESSION_LEN = 256


def _packed(store: EventStore, max_len: int = MAX_SESSION_LEN):
    return store.pack(max_len=min(max_len, max(int(store.lengths.max(initial=1)), 1)), keep="last")


@dataclass
class BaselineResult:
    predictions: dict[str, np.ndarray]
    report: RecallReport | None


def run_aid_frequency(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
) -> BaselineResult:
    """aid-frequency baseline (reference: src/baseline/aid_frequency.py)."""
    stats = FrequencyStatistics.compute(train, n_aids=n_aids, k=k)
    preds = aid_frequency_predictions(_packed(target), stats, k=k)
    report = None
    if labels is not None:
        report = evaluate_predictions(labels, preds["clicks"], preds["carts"], preds["orders"])
        log.info("aid frequency validation scores\n%s", report)
    return BaselineResult(preds, report)


def run_aid_weight(
    target: EventStore,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
) -> BaselineResult:
    """aid-weight recency baseline (reference: src/baseline/aid_weight.py).
    Validation mode uses type coefficients {1,6,3}; submission {1,3,6}."""
    coeffs = VALIDATION_COEFFICIENTS if labels is not None else SUBMISSION_COEFFICIENTS
    preds = aid_weight_predictions(_packed(target), coefficients=coeffs, k=k)
    report = None
    if labels is not None:
        report = evaluate_predictions(labels, preds["clicks"], preds["carts"], preds["orders"])
        log.info("aid weight validation scores\n%s", report)
    return BaselineResult(preds, report)


def run_covisit_heuristic(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
) -> BaselineResult:
    """Covisitation heuristic recommender end to end (reference:
    src/covisitation/inference.py)."""
    from otto_tpu import EVENT_TYPES
    from otto_tpu.models.covisitation import build_covisitation, covisit_heuristic_predictions
    from otto_tpu.models.frequency import FrequencyStatistics

    mats = build_covisitation(train, n_aids)
    stats = FrequencyStatistics.compute(train, n_aids=n_aids, k=k)
    stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
    preds = covisit_heuristic_predictions(target, mats, stats_top, k=k)
    report = None
    if labels is not None:
        report = evaluate_predictions(labels, preds["clicks"], preds["carts"], preds["orders"])
        log.info("covisitation heuristic validation scores\n%s", report)
    return BaselineResult(preds, report)


def run_tfidf(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
) -> BaselineResult:
    """TF-IDF similar-session recommender (reference: src/tfidf/inference.py)."""
    from otto_tpu.models.tfidf import TfIdfModel

    model = TfIdfModel.fit(train, n_aids=n_aids)
    preds = model.similar_session_predictions(target, k=k)
    report = None
    if labels is not None:
        report = evaluate_predictions(labels, preds["clicks"], preds["carts"], preds["orders"])
        log.info("tfidf validation scores\n%s", report)
    return BaselineResult(preds, report)


def run_sequence(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    config_path: str | None = None,
) -> BaselineResult:
    """Sequential recommender with 3-way serving routing (reference:
    src/recbole/{trainer,inference}.py)."""
    from otto_tpu.config import SequenceModelConfig
    from otto_tpu.models.sequence import sequence_serving_predictions, train_sequence_model

    cfg = (SequenceModelConfig.from_yaml(config_path) if config_path
           else SequenceModelConfig()).replace(n_aids=n_aids)
    model = train_sequence_model(train, cfg)
    seen = np.zeros(n_aids, bool)
    seen[train.aid] = True
    preds = sequence_serving_predictions(target, model, trained_aid_mask=seen, k=k)
    report = None
    if labels is not None:
        report = evaluate_predictions(labels, preds["clicks"], preds["carts"], preds["orders"])
        log.info("sequence (%s) validation scores\n%s", cfg.architecture, report)
    return BaselineResult(preds, report)


def run_embedding_knn(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    config_path: str | None = None,
) -> BaselineResult:
    """SGNS embeddings + kNN serving (reference: src/gensim_fasttext/
    {trainer,inference}.py; n_nns=21 validation / 101 submission)."""
    from otto_tpu.config import SGNSConfig
    from otto_tpu.models.embeddings import embedding_knn_predictions, train_sgns

    cfg = SGNSConfig.from_yaml(config_path) if config_path else SGNSConfig()
    sgns = train_sgns(train, n_aids, cfg)
    n_nns = 21 if labels is not None else 101
    table = sgns.neighbor_table(k=n_nns)
    preds = embedding_knn_predictions(target, table, k=k)
    report = None
    if labels is not None:
        report = evaluate_predictions(labels, preds["clicks"], preds["carts"], preds["orders"])
        log.info("embedding-knn validation scores\n%s", report)
    return BaselineResult(preds, report)


def run_doc2vec(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    k: int = TOP_K,
    config_path: str | None = None,
) -> BaselineResult:
    """Doc2Vec analog: pooled session embeddings + similar-session retrieval
    (reference: gensim Doc2Vec mode of src/gensim_fasttext/trainer.py:41-59)."""
    from otto_tpu.config import SGNSConfig
    from otto_tpu.models.embeddings import SessionEmbeddingModel, train_sgns

    cfg = SGNSConfig.from_yaml(config_path) if config_path else SGNSConfig()
    sgns = train_sgns(train, n_aids, cfg)
    model = SessionEmbeddingModel.fit(train, sgns.embeddings)
    preds = model.similar_session_predictions(target, k=k)
    report = None
    if labels is not None:
        report = evaluate_predictions(labels, preds["clicks"], preds["carts"], preds["orders"])
        log.info("doc2vec-analog validation scores\n%s", report)
    return BaselineResult(preds, report)


MODEL_RUNNERS = {
    "aid_frequency": run_aid_frequency,
    "aid_weight": run_aid_weight,
    "covisitation": run_covisit_heuristic,
    "tfidf": run_tfidf,
    "sequence": run_sequence,
    "embedding_knn": run_embedding_knn,
    "doc2vec": run_doc2vec,
}


def run_ensemble(
    manifest: dict,
    labels: SessionLabels | None = None,
    holdout_fraction: float = 0.25,
    seed: int = 42,
    k: int = TOP_K,
):
    """File-based multi-model ensemble (the reference's final inference stage,
    src/ranker/inference.py:14-85,123-140,321-337): load N per-model
    prediction files per event type, robust-scale, outer-join on
    (session, aid), blend with the manifest's fixed weights, cut to top-20.

    With ``labels``, reports recall on all labeled sessions (the OOF view)
    and on a held-out ``holdout_fraction`` subset (the reference's
    teammate-defined holdout sessions, inference.py:139,321-337).
    """
    from otto_tpu.eval.harness import evaluate_predictions
    from otto_tpu.models.ensemble import align_to_sessions, blend_files

    blended = blend_files(manifest, k=k)
    report = None
    if labels is not None:
        preds = {t: align_to_sessions(labels.session_ids, blended[t], k=k)
                 for t in EVENT_TYPES}
        report = evaluate_predictions(
            labels, preds["clicks"], preds["carts"], preds["orders"]
        )
        log.info("ensemble blend scores (all labeled sessions)\n%s", report)
        rng = np.random.default_rng(seed)
        hold = rng.random(labels.n_sessions) < holdout_fraction
        hold_labels = SessionLabels(
            session_ids=labels.session_ids[hold],
            click=labels.click[hold],
            cart_flat=labels.cart_flat[np.repeat(hold, labels.cart_counts)],
            cart_offsets=np.concatenate([[0], np.cumsum(labels.cart_counts[hold])]),
            order_flat=labels.order_flat[np.repeat(hold, labels.order_counts)],
            order_offsets=np.concatenate([[0], np.cumsum(labels.order_counts[hold])]),
        )
        hold_report = evaluate_predictions(
            hold_labels, preds["clicks"][hold], preds["carts"][hold], preds["orders"][hold]
        )
        log.info("ensemble blend scores (holdout %.0f%%)\n%s",
                 100 * holdout_fraction, hold_report)
        preds_out = preds
    else:
        sessions = blended["clicks"][0]
        preds_out = {t: align_to_sessions(sessions, blended[t], k=k) for t in EVENT_TYPES}
        preds_out["__sessions"] = sessions
    return BaselineResult(preds_out, report)


def main(argv=None):
    import argparse

    from otto_tpu.utils.runtime import enable_compilation_cache

    enable_compilation_cache()

    parser = argparse.ArgumentParser(prog="otto_tpu.pipelines")
    parser.add_argument(
        "model",
        choices=["aid_frequency", "aid_weight", "covisitation", "two_stage",
                 "two_stage_streamed", "tfidf", "sequence", "embedding_knn",
                 "doc2vec", "ensemble"],
    )
    parser.add_argument("mode", choices=["validation", "submission"])
    parser.add_argument("--events", default=None,
                        help="parquet of (session, aid, ts, type) or .jsonl raw file "
                             "(optional for 'ensemble submission', required otherwise)")
    parser.add_argument("--manifest", default=None,
                        help="ensemble: JSON manifest {etype: {model: {path, weight}}} "
                             "of per-model prediction files (npz/parquet with "
                             "session/aid/score) — the reference's read_predictions "
                             "contract (src/ranker/inference.py:14-85)")
    parser.add_argument("--holdout-fraction", type=float, default=0.25,
                        help="ensemble validation: extra recall report on this "
                             "fraction of sessions (inference.py:321-337)")
    parser.add_argument("--output", default=None, help="submission csv.gz path")
    parser.add_argument("--n-aids", type=int, default=DataConfig().n_aids)
    parser.add_argument("--val-fraction", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--config", default=None,
                        help="model YAML (sequence / embedding_knn / doc2vec / two_stage ranker)")
    parser.add_argument("--ranker", choices=["tower", "gbdt"], default="tower",
                        help="two_stage reranking engine: listwise MLP tower or the "
                             "histogram GBDT (the reference's LightGBM stage)")
    parser.add_argument("--test-events", default=None,
                        help="submission mode: separate test events file to predict "
                             "(the reference's train.jsonl/test.jsonl split); defaults "
                             "to predicting --events sessions themselves")
    parser.add_argument("--artifact-dir", default=None,
                        help="two_stage per-stage persistence / crash-resume directory")
    parser.add_argument("--train-sessions", type=int, default=50_000,
                        help="two_stage_streamed: labeled target sessions used "
                             "to fit the rankers; the rest stream")
    parser.add_argument("--shard-sessions", type=int, default=100_000,
                        help="two_stage_streamed: prediction shard size "
                             "(bounds peak memory — the reference's 15-shard "
                             "explode / 20-chunk prediction analog)")
    args = parser.parse_args(argv)

    def _read(path):
        if str(path).endswith(".jsonl"):
            from otto_tpu.data.ingest import read_jsonl

            return read_jsonl(path)
        return EventStore.from_parquet(path)

    if args.model == "ensemble":
        import json

        if not args.manifest:
            parser.error("ensemble requires --manifest")
        manifest = json.loads(open(args.manifest).read())
        if args.mode == "validation":
            if not args.events:
                parser.error("ensemble validation requires --events (for labels)")
            sp = splits.split_by_fraction(
                _read(args.events), val_fraction=args.val_fraction, seed=args.seed
            )
            result = run_ensemble(manifest, sp.val_labels,
                                  holdout_fraction=args.holdout_fraction, seed=args.seed)
            print(result.report)
        else:
            result = run_ensemble(manifest, None)
            sessions = result.predictions.pop("__sessions")
            out = args.output or "ensemble_submission.csv.gz"
            submission.write_submission(out, sessions, result.predictions)
            print(f"wrote {out}")
        return result

    if not args.events:
        parser.error("--events is required")
    store = _read(args.events)

    def dispatch(train, target, labels):
        if args.model == "two_stage_streamed":
            from otto_tpu.config import GBDTConfig, RankerConfig
            from otto_tpu.streaming import run_two_stage_streamed

            cfg_cls = GBDTConfig if args.ranker == "gbdt" else RankerConfig
            rcfg = cfg_cls.from_yaml(args.config) if args.config else cfg_cls()
            artifacts = None
            if labels is None:
                # submission: fit rankers on a truncated labeled split of the
                # train events (two_stage's pattern), then stream the target
                from otto_tpu.twostage import run_two_stage

                sp = splits.split_by_fraction(
                    train, val_fraction=args.val_fraction, seed=args.seed)
                artifacts = run_two_stage(
                    sp.train, sp.val_input, args.n_aids, labels=sp.val_labels,
                    ranker_config=rcfg, artifact_dir=args.artifact_dir)
            res = run_two_stage_streamed(
                train, target, args.n_aids, labels=labels,
                ranker_config=rcfg,
                train_sessions=args.train_sessions,
                shard_sessions=args.shard_sessions,
                artifacts=artifacts,
                artifact_dir=args.artifact_dir,
                n_boot=0 if labels is None else 1000,
            )
            if res.bootstrap_vs_heuristic is not None:
                b = res.bootstrap_vs_heuristic
                print(f"lift vs heuristic {b['lift']:+.6f} ci95 {b['ci95']} "
                      f"(streamed, training-disjoint)")
            # predictions cover the streamed sessions; in submission mode
            # train_sessions=0 is implied by labels=None (everything streams)
            return BaselineResult(res.predictions, res.report)
        if args.model == "two_stage":
            from otto_tpu.config import GBDTConfig, RankerConfig
            from otto_tpu.twostage import predict_two_stage, run_two_stage

            cfg_cls = GBDTConfig if args.ranker == "gbdt" else RankerConfig
            rcfg = cfg_cls.from_yaml(args.config) if args.config else cfg_cls()
            if labels is None:
                # submission: train the two-stage on a truncated split of the
                # train events (the reference trains its rankers on the
                # labeled validation week, src/ranker/lgb_trainer.py:51-57),
                # then score the target sessions with the trained artifacts
                sp = splits.split_by_fraction(
                    train, val_fraction=args.val_fraction, seed=args.seed
                )
                art = run_two_stage(sp.train, sp.val_input, args.n_aids,
                                    labels=sp.val_labels, ranker_config=rcfg,
                                    artifact_dir=args.artifact_dir)
                preds = predict_two_stage(art, train, target, args.n_aids)
                return BaselineResult(preds, None)
            art = run_two_stage(train, target, args.n_aids, labels=labels,
                                ranker_config=rcfg,
                                artifact_dir=args.artifact_dir)
            return BaselineResult(art.predictions, art.report)
        runner = MODEL_RUNNERS[args.model]
        if args.model == "aid_weight":
            return runner(target, labels)
        kw = {"config_path": args.config} if args.model in (
            "sequence", "embedding_knn", "doc2vec") else {}
        return runner(train, target, args.n_aids, labels, **kw)

    if args.mode == "validation":
        sp = splits.split_by_fraction(store, val_fraction=args.val_fraction, seed=args.seed)
        result = dispatch(sp.train, sp.val_input, sp.val_labels)
        print(result.report)
    else:
        target = _read(args.test_events) if args.test_events else store
        result = dispatch(store, target, None)
        out = args.output or f"{args.model}_submission.csv.gz"
        submission.write_submission(out, target.session_ids, result.predictions)
        print(f"wrote {out}")
    return result


if __name__ == "__main__":
    main()
