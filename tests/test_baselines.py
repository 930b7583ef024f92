"""Frequency/recency baseline tests, including reference-oracle parity for the
prediction construction and an end-to-end validation run on synthetic data."""

from collections import Counter
from pathlib import Path

import numpy as np

from otto_tpu import EVENT_TYPES
from otto_tpu.data import splits, synthetic_events
from otto_tpu.eval import evaluate_predictions
from otto_tpu.models.frequency import (
    FrequencyStatistics,
    aid_counts,
    aid_frequency_predictions,
)
from otto_tpu.models.recency import aid_weight_predictions

REPO = Path(__file__).resolve().parents[1]


def test_aid_counts_matches_bincount(small_events):
    n_aids = 500
    got = np.asarray(aid_counts(small_events.aid, n_aids))
    expected = np.bincount(small_events.aid, minlength=n_aids)
    np.testing.assert_array_equal(got, expected)


def test_frequency_statistics_roundtrip(small_events, tmp_path):
    stats = FrequencyStatistics.compute(small_events, n_aids=500, k=20)
    # top-20 global equals numpy ranking (ties: any consistent order ok on counts)
    counts = np.bincount(small_events.aid, minlength=500)
    np.testing.assert_array_equal(np.sort(counts[stats.top_all])[::-1], np.sort(counts)[::-1][:20])
    stats.save(tmp_path, prefix="train")
    loaded = FrequencyStatistics.load(tmp_path, prefix="train")
    np.testing.assert_array_equal(loaded.top_all, stats.top_all)
    for name in EVENT_TYPES:
        np.testing.assert_array_equal(loaded.top_by_type[name], stats.top_by_type[name])


def test_aid_frequency_prediction_semantics(small_events):
    stats = FrequencyStatistics.compute(small_events, n_aids=500, k=20)
    L = int(small_events.lengths.max())
    packed = small_events.pack(max_len=L, keep="first")
    preds = aid_frequency_predictions(packed, stats)
    for s in range(min(50, small_events.n_sessions)):
        lo, hi = small_events.offsets[s], small_events.offsets[s + 1]
        session_aids = list(Counter(small_events.aid[lo:hi].tolist()).keys())[:20]
        for name in EVENT_TYPES:
            expected = session_aids + stats.top_by_type[name][: 20 - len(session_aids)].tolist()
            got = [int(a) for a in preds[name][s] if a >= 0]
            assert got == expected


def test_end_to_end_baselines_beat_nothing():
    es = synthetic_events(n_sessions=1500, n_aids=800, mean_length=10, seed=21)
    sp = splits.split_by_fraction(es, val_fraction=0.3)
    stats = FrequencyStatistics.compute(sp.train, n_aids=800, k=20)
    L = int(sp.val_input.lengths.max())
    packed = sp.val_input.pack(max_len=L, keep="last")

    freq_preds = aid_frequency_predictions(packed, stats)
    freq_report = evaluate_predictions(
        sp.val_labels, freq_preds["clicks"], freq_preds["carts"], freq_preds["orders"]
    )
    weight_preds = aid_weight_predictions(packed)
    weight_report = evaluate_predictions(
        sp.val_labels,
        weight_preds["clicks"],
        weight_preds["carts"],
        weight_preds["orders"],
    )
    # Both baselines must recover signal on clustered synthetic data.
    assert freq_report.weighted > 0.02
    assert weight_report.weighted > 0.02
    assert 0 < freq_report.clicks <= 1
    assert 0 < weight_report.clicks <= 1


def test_writers_roundtrip(tmp_path):
    from otto_tpu.data.writers import (
        read_chunked_parquet,
        truncated_train_store,
        write_chunked_parquet,
    )

    es = synthetic_events(n_sessions=250, n_aids=100, seed=33)
    paths = write_chunked_parquet(es, tmp_path, chunk_sessions=100)
    assert len(paths) == 3
    back = read_chunked_parquet(tmp_path)
    np.testing.assert_array_equal(back.aid, es.aid)
    np.testing.assert_array_equal(back.session_ids, es.session_ids)

    cutoff = int(es.session_ids[200])
    trunc = truncated_train_store(es, cutoff, seed=0)
    # early sessions unchanged; late sessions shortened or equal
    early = es.sessions_between(hi=cutoff)
    assert trunc.sessions_between(hi=cutoff).n_events == early.n_events
    late_orig = es.sessions_between(lo=cutoff)
    late_trunc = trunc.sessions_between(lo=cutoff)
    assert late_trunc.n_events < late_orig.n_events


def test_cli_covisitation_mode():
    import subprocess, sys, os

    es = synthetic_events(n_sessions=400, n_aids=300, seed=34)
    es.to_parquet("/tmp/cli_events.parquet")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "otto_tpu.pipelines", "covisitation", "validation",
         "--events", "/tmp/cli_events.parquet", "--n-aids", "300",
         "--val-fraction", "0.3"],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "weighted recall@20" in r.stdout


def test_cli_submission_mode(tmp_path):
    import subprocess, sys, os

    es = synthetic_events(n_sessions=200, n_aids=150, seed=35)
    es.to_parquet("/tmp/cli_events_sub.parquet")
    out = tmp_path / "sub.csv.gz"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "otto_tpu.pipelines", "aid_weight", "submission",
         "--events", "/tmp/cli_events_sub.parquet", "--n-aids", "150",
         "--output", str(out)],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    from otto_tpu.data.submission import read_submission

    back = read_submission(out)
    assert len(back["clicks"]) == 200
    # every line has <= 20 predictions
    assert all(len(v) <= 20 for v in back["clicks"].values())


def test_cli_new_model_families(tmp_path):
    """tfidf / doc2vec validation-mode runs through the CLI (the remaining
    families — sequence, embedding_knn — share the same dispatch path and are
    covered in-process by their model tests)."""
    import subprocess, sys, os

    es = synthetic_events(n_sessions=300, n_aids=200, seed=36)
    p = tmp_path / "events.parquet"
    es.to_parquet(p)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    for model in ("tfidf", "doc2vec"):
        r = subprocess.run(
            [sys.executable, "-m", "otto_tpu.pipelines", model, "validation",
             "--events", str(p), "--n-aids", "200", "--val-fraction", "0.3"],
            capture_output=True, text=True, timeout=600, cwd=REPO, env=env,
        )
        assert r.returncode == 0, (model, r.stderr[-2000:])
        assert "weighted recall@20" in r.stdout, model


def test_cli_two_stage_gbdt_engine(tmp_path):
    """two_stage validation through the CLI with the GBDT engine + a YAML
    ranker config (the reference's lgb config-path contract)."""
    import subprocess, sys, os

    es = synthetic_events(n_sessions=300, n_aids=200, seed=37)
    p = tmp_path / "events.parquet"
    es.to_parquet(p)
    cfg = tmp_path / "gbdt.yaml"
    cfg.write_text(
        "n_trees: 8\nearly_stopping_rounds: 1000\nlearning_rate: 0.3\n"
        "max_depth: 3\nn_bins: 32\nmin_data_in_leaf: 1\nmin_split_gain: 0.0\n"
        "min_child_weight: 1.0e-6\nn_folds: 2\nchunk_sessions: 64\n"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "otto_tpu.pipelines", "two_stage", "validation",
         "--events", str(p), "--n-aids", "200", "--val-fraction", "0.3",
         "--ranker", "gbdt", "--config", str(cfg)],
        capture_output=True, text=True, timeout=900, cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "weighted recall@20" in r.stdout


def test_cli_two_stage_submission_mode(tmp_path):
    """two_stage submission: trains on a truncated split of --events, scores
    the separate --test-events sessions, writes the gzip submission
    (the reference's production path, src/ranker/inference.py:402-407)."""
    import subprocess, sys, os

    es = synthetic_events(n_sessions=300, n_aids=200, seed=38)
    test_es = synthetic_events(n_sessions=80, n_aids=200, seed=39)
    p = tmp_path / "train.parquet"
    pt = tmp_path / "test.parquet"
    es.to_parquet(p)
    test_es.to_parquet(pt)
    cfg = tmp_path / "gbdt.yaml"
    cfg.write_text(
        "n_trees: 6\nearly_stopping_rounds: 1000\nlearning_rate: 0.3\n"
        "max_depth: 3\nn_bins: 32\nmin_data_in_leaf: 1\nmin_split_gain: 0.0\n"
        "min_child_weight: 1.0e-6\nn_folds: 2\nchunk_sessions: 64\n"
    )
    out = tmp_path / "sub.csv.gz"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "otto_tpu.pipelines", "two_stage", "submission",
         "--events", str(p), "--test-events", str(pt), "--n-aids", "200",
         "--val-fraction", "0.3", "--ranker", "gbdt", "--config", str(cfg),
         "--output", str(out)],
        capture_output=True, text=True, timeout=900, cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    from otto_tpu.data.submission import read_submission

    back = read_submission(out)
    assert len(back["clicks"]) == 80
    assert all(0 < len(v) <= 20 for v in back["orders"].values())
