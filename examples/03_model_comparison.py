"""Baseline-analysis example (replaces the reference's frequency-baseline
notebook): run every model family on one synthetic split and compare
weighted recall@20."""

import sys as _sys, pathlib as _pathlib
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

from otto_tpu.config import CovisitConfig, GBDTConfig, RankerConfig, SGNSConfig
from otto_tpu.data import splits, synthetic_events
from otto_tpu.logging_utils import configure_logging
from otto_tpu.pipelines import (
    run_aid_frequency,
    run_aid_weight,
    run_covisit_heuristic,
    run_doc2vec,
    run_embedding_knn,
    run_sequence,
    run_tfidf,
)
from otto_tpu.twostage import run_two_stage

configure_logging()

from otto_tpu.utils.runtime import enable_compilation_cache
enable_compilation_cache()

es = synthetic_events(n_sessions=6_000, n_aids=2_000, mean_length=12)
sp = splits.split_by_fraction(es, val_fraction=0.25)
N = 2_000

rows = []
rows.append(("aid_frequency", run_aid_frequency(sp.train, sp.val_input, N, sp.val_labels).report))
rows.append(("aid_weight", run_aid_weight(sp.val_input, sp.val_labels).report))
rows.append(("covisitation", run_covisit_heuristic(sp.train, sp.val_input, N, sp.val_labels).report))
rows.append(("tfidf", run_tfidf(sp.train, sp.val_input, N, sp.val_labels).report))
rows.append(("doc2vec", run_doc2vec(sp.train, sp.val_input, N, sp.val_labels).report))
rows.append(("embedding_knn", run_embedding_knn(sp.train, sp.val_input, N, sp.val_labels).report))
rows.append(("sequence (gru)", run_sequence(sp.train, sp.val_input, N, sp.val_labels).report))
_cfg_dir = _pathlib.Path(__file__).resolve().parent.parent / "configs"
rows.append(("sequence (transformer)", run_sequence(
    sp.train, sp.val_input, N, sp.val_labels,
    config_path=str(_cfg_dir / "sequence_transformer.yaml")).report))
rows.append(("sequence (moe transformer)", run_sequence(
    sp.train, sp.val_input, N, sp.val_labels,
    config_path=str(_cfg_dir / "sequence_moe.yaml")).report))
rows.append(("sequence (narm)", run_sequence(
    sp.train, sp.val_input, N, sp.val_labels,
    config_path=str(_cfg_dir / "sequence_narm.yaml")).report))
rows.append(("sequence (stamp)", run_sequence(
    sp.train, sp.val_input, N, sp.val_labels,
    config_path=str(_cfg_dir / "sequence_stamp.yaml")).report))
rows.append(("sequence (caser)", run_sequence(
    sp.train, sp.val_input, N, sp.val_labels,
    config_path=str(_cfg_dir / "sequence_caser.yaml")).report))
art = run_two_stage(
    sp.train, sp.val_input, N, labels=sp.val_labels,
    covisit_config=CovisitConfig(top_k_wide=20, session_tail=30),
    ranker_config=RankerConfig(hidden_dims=(128, 64), n_folds=3, epochs=5,
                               batch_sessions=256, dropout=0.0),
    sgns_config=SGNSConfig(dim=16, window=5, negatives=10, epochs=3),
)
rows.append(("two_stage (+sgns)", art.report))
art_g = run_two_stage(
    sp.train, sp.val_input, N, labels=sp.val_labels,
    matrices=art.matrices, sgns=art.sgns,  # reuse stage-0 artifacts
    ranker_config=GBDTConfig(n_trees=300, early_stopping_rounds=60, eval_every=5,
                             learning_rate=0.08, max_depth=6, n_bins=128,
                             min_data_in_leaf=30, n_folds=3, chunk_sessions=512),
)
rows.append(("two_stage (gbdt engine)", art_g.report))

print(f"\n{'model':24s} weighted  clicks  carts  orders")
for name, r in rows:
    print(f"{name:24s} {r.weighted:.4f}   {r.clicks:.4f}  {r.carts:.4f}  {r.orders:.4f}")
print("candidate ceiling:", {k: round(v, 4) for k, v in art.max_recall.items()})
