"""The two-stage production pipeline as one engine call.

Replaces the reference's four chained CLI processes (SURVEY §3.4):
regular candidate generation -> aid/session/interaction feature engineering ->
GBDT rankers per event type -> ensemble blend, which communicated through
pickle files.  Here the stages pass arrays in memory:

1. covisitation matrices (+ optional SGNS embeddings) are built from train
   events
2. the regular candidate generator emits [S, C] candidates/scores/labels
3. the three feature families assemble the [S, C, 54] tensor
4. one listwise tower per event type trains with the reference's fold /
   negative-sampling protocol and produces fold-averaged scores
5. per-type scores blend (robust-scaled) into final top-20 predictions,
   evaluated with the weighted recall@20 harness
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from otto_tpu import EVENT_TYPES, TOP_K
from otto_tpu.config import CovisitConfig, RankerConfig, SGNSConfig
from otto_tpu.data.events import EventStore
from otto_tpu.data.labels import SessionLabels
from otto_tpu.eval.harness import RecallReport, evaluate_predictions
from otto_tpu.eval.metrics import corpus_recall_at_k
from otto_tpu.features import (
    RANKER_FEATURES,
    assemble_features,
    compute_aid_features,
    compute_interaction_features,
    compute_session_features,
)
from otto_tpu.logging_utils import get_logger
from otto_tpu.models.candidates import CandidateSet, regular_candidates
from otto_tpu.models.covisitation import CovisitationMatrices, build_covisitation
from otto_tpu.models.embeddings import SGNSModel, train_sgns
from otto_tpu.models.gbdt import GBDTConfig, load_ranker_model, train_gbdt_ranker
from otto_tpu.models.ranker import RankerData, RankerModel, top_k_predictions, train_ranker


def _train_engine(data: RankerData, cfg, eval_recall, device=None):
    """Dispatch on config type: RankerConfig -> listwise tower,
    GBDTConfig -> histogram GBDT (the reference's LightGBM engine
    re-implemented, models/gbdt.py).  ``device`` routes the GBDT
    fit's jitted passes to a specific accelerator (committed inputs)."""
    if isinstance(cfg, GBDTConfig):
        return train_gbdt_ranker(data, cfg, eval_recall=eval_recall,
                                 device=device)
    return train_ranker(data, cfg, eval_recall=eval_recall)

log = get_logger(__name__)


def _blend_scores(candidates: np.ndarray, score_mats: list[np.ndarray],
                  weights: list[float]) -> np.ndarray:
    """Robust-scaled weighted blend of [S, C] score matrices over the same
    candidate grid (the in-grid specialization of models/ensemble.blend)."""
    from otto_tpu.models.ensemble import robust_scale

    valid = candidates >= 0
    out = np.zeros_like(score_mats[0], dtype=np.float64)
    for w, s in zip(weights, score_mats):
        scaled = np.zeros_like(out)
        finite = valid & np.isfinite(s)
        scaled[finite] = robust_scale(s[finite].astype(np.float64))
        out += w * scaled
    return np.where(valid, out, -np.inf).astype(np.float32)


PRIOR_ALPHAS = (0.0, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0)


def _heuristic_rank_matrix(candidates: np.ndarray, heur: np.ndarray,
                           chunk: int = 8192):
    """Per-candidate rank in the session's heuristic top-k list.

    Returns ``rank`` int32 [S, C] (0-based position in ``heur``, -1 if the
    candidate is not in the heuristic list) and ``present`` bool [S, K]
    (heuristic entry already covered by the candidate grid).  Chunked
    broadcast keeps the [chunk, C, K] equality tensor small.
    """
    S, C = candidates.shape
    K = heur.shape[1]
    rank = np.full((S, C), -1, np.int32)
    present = np.zeros((S, K), bool)
    for s0 in range(0, S, chunk):
        s1 = min(s0 + chunk, S)
        c = candidates[s0:s1]
        h = heur[s0:s1]
        eq = (c[:, :, None] == h[:, None, :]) & (c >= 0)[:, :, None] & (h >= 0)[:, None, :]
        any_c = eq.any(axis=2)
        rank[s0:s1] = np.where(any_c, eq.argmax(axis=2).astype(np.int32), -1)
        present[s0:s1] = eq.any(axis=1)
    return rank, present


def _union_heuristic(cands: CandidateSet, heur_preds: dict[str, np.ndarray],
                     labels: SessionLabels | None) -> dict[str, np.ndarray]:
    """Union each session's heuristic top-k into the candidate grid.

    Appends K extra columns holding heuristic picks missing from the grid
    (candgen score 0 — the ``heuristic_rank_score`` feature and prior carry
    their ordering), recomputes labels for the widened grid, and returns the
    per-type [S, C+K] heuristic-rank matrices.  Guarantees the heuristic's
    exact top-20 is reachable by the reranker, so the prior blend at
    alpha = 0 reproduces the L4 heuristic and any selected alpha > 0 is
    measured lift over it.
    """
    from otto_tpu.models.candidates import _label_dict

    heur_rank: dict[str, np.ndarray] = {}
    for etype in EVENT_TYPES:
        c = cands.candidates[etype]
        sc = cands.scores[etype]
        h = heur_preds[etype]
        S, _ = c.shape
        K = h.shape[1]
        _, present = _heuristic_rank_matrix(c, h)
        missing = (~present) & (h >= 0)  # [S, K]
        ext = np.full((S, K), -1, np.int32)
        pos = np.cumsum(missing, axis=1) - 1
        r, kk = np.nonzero(missing)
        ext[r, pos[r, kk]] = h[r, kk]
        cands.candidates[etype] = np.concatenate([c, ext], axis=1)
        cands.scores[etype] = np.concatenate(
            [sc, np.zeros((S, K), sc.dtype)], axis=1
        )
        rank, _ = _heuristic_rank_matrix(cands.candidates[etype], h)
        heur_rank[etype] = rank
    if labels is not None:
        cands.labels = _label_dict(cands.candidates, labels)
    return heur_rank


def _prior_matrix(candidates: np.ndarray, heur_rank: np.ndarray | None):
    """Rank-prior score matrix: candgen order, with heuristic-list members
    lifted strictly above it in heuristic order (top-20 by this prior is then
    exactly the heuristic's list)."""
    S, C = candidates.shape
    valid = candidates >= 0
    prior = np.where(valid, -np.arange(C, dtype=np.float32)[None, :], -np.inf)
    if heur_rank is not None:
        # K pinned to the heuristic list width (ranks are positions in a
        # top-TOP_K list) so training and prediction share the same scale
        # regardless of the observed max rank (ADVICE r3)
        K = TOP_K
        prior = np.where(
            (heur_rank >= 0) & valid,
            (C + K - heur_rank).astype(np.float32),
            prior,
        )
    return prior


def _prior_blend(candidates: np.ndarray, tower_scores: np.ndarray, eval_fn,
                 heur_rank: np.ndarray | None = None):
    """Blend the tower score with the candidate-ordering prior.

    The prior is the candidate-generator's ordering (session recency +
    covisitation votes) — or, when ``heur_rank`` is given, that ordering with
    the covisit heuristic's top-20 lifted above it, so alpha = 0 reproduces
    the L4 heuristic exactly.  ``score = prior + alpha * tower`` lets the
    learned model only refine it; ``alpha`` is selected per event type by
    recall over a small grid (alpha -> infinity recovers the pure tower).
    """
    S, C = candidates.shape
    valid = candidates >= 0
    prior = _prior_matrix(candidates, heur_rank)
    prior_n = _blend_scores(candidates, [prior], [1.0])
    tower_n = _blend_scores(candidates, [tower_scores], [1.0])
    best_alpha, best_r, best_scores = 0.0, -1.0, prior_n
    idx = np.arange(S)
    tower_z = np.where(valid, tower_n, 0.0)  # avoid 0 * -inf = nan at alpha 0
    for alpha in PRIOR_ALPHAS:
        blended = np.where(valid, prior_n + alpha * tower_z, -np.inf)
        r = eval_fn(idx, blended)
        if r > best_r:
            best_alpha, best_r, best_scores = alpha, r, blended
    # also consider the pure tower (alpha = inf)
    r_tower = eval_fn(idx, tower_n)
    if r_tower > best_r:
        return tower_n, float("inf")
    return best_scores, best_alpha


@dataclass
class TwoStageArtifacts:
    matrices: CovisitationMatrices
    sgns: SGNSModel | None
    candidates: CandidateSet
    rankers: dict[str, RankerModel]
    predictions: dict[str, np.ndarray]  # etype -> [S, 20]
    report: RecallReport | None
    max_recall: dict[str, float] = field(default_factory=dict)
    # sessions used for alpha / early-stop selection (True) vs held out for
    # the unbiased report (False); ``report_disjoint`` scores only the
    # held-out half, so it carries no selection optimism
    selection_mask: np.ndarray | None = None
    report_disjoint: RecallReport | None = None
    # training-time settings that prediction must reproduce (ADVICE r3):
    # whether the heuristic top-k was unioned into the grid (adds the
    # heuristic_rank_score column + the lifted prior) and the resolved
    # feature list the rankers were fit on
    heuristic_union: bool = True
    feature_list: list[str] | None = None

    def save(self, directory) -> None:
        """Persist everything needed to re-score new sessions (the
        reference's per-stage artifact files, SURVEY §5.3-5.4: every stage
        persists so reruns resume from the last file)."""
        import json
        from pathlib import Path

        d = Path(directory)
        (d / "covisitation").mkdir(parents=True, exist_ok=True)
        self.matrices.save(d / "covisitation")
        if self.sgns is not None:
            self.sgns.save(d / "sgns.npz")
        for name, model in self.rankers.items():
            model.save(d / f"ranker_{name}.npz")
        np.savez_compressed(d / "predictions.npz", **self.predictions)
        meta = {
            "ranker_names": sorted(self.rankers),
            "has_sgns": self.sgns is not None,
            "max_recall": self.max_recall,
            "heuristic_union": bool(self.heuristic_union),
            "feature_list": self.feature_list,
        }
        (d / "meta.json").write_text(json.dumps(meta, indent=1))

    @classmethod
    def load(cls, directory, ranker_config: RankerConfig = RankerConfig()) -> "TwoStageArtifacts":
        import json
        from pathlib import Path

        d = Path(directory)
        meta = json.loads((d / "meta.json").read_text())
        matrices = CovisitationMatrices.load(d / "covisitation")
        sgns = SGNSModel.load(d / "sgns.npz") if meta["has_sgns"] else None
        rankers = {
            name: load_ranker_model(d / f"ranker_{name}.npz", ranker_config)
            for name in meta["ranker_names"]
        }
        z = np.load(d / "predictions.npz")
        preds = {k: z[k] for k in z.files}
        return cls(matrices, sgns, None, rankers, preds, None,
                   max_recall=meta["max_recall"],
                   heuristic_union=meta.get("heuristic_union", True),
                   feature_list=meta.get("feature_list"))


def _recall_eval_fn(labels: SessionLabels, candidates: np.ndarray, etype: str):
    """eval_recall callback for train_ranker: corpus recall@20 of the top-20
    reranked candidates on a subset of sessions."""
    import jax.numpy as jnp

    padded = labels.padded(etype)

    def eval_recall(session_indices, scores):
        top = top_k_predictions(candidates[session_indices], scores, k=TOP_K)
        return float(
            corpus_recall_at_k(jnp.asarray(top), jnp.asarray(padded[session_indices]), k=TOP_K)
        )

    return eval_recall


def run_two_stage(
    train: EventStore,
    target: EventStore,
    n_aids: int,
    labels: SessionLabels | None = None,
    covisit_config: CovisitConfig = CovisitConfig(),
    ranker_config: RankerConfig | GBDTConfig = RankerConfig(),
    second_ranker_config: RankerConfig | GBDTConfig | None = None,
    blend_weights: tuple[float, float] = (0.5, 0.5),
    prior_blend: bool = True,
    sgns_config: SGNSConfig | None = None,
    feature_list: list[str] = RANKER_FEATURES,
    ft_k: int = 20,
    uniq_cap: int = 64,
    k_covisit: int = 100,
    matrices: CovisitationMatrices | None = None,
    sgns: SGNSModel | None = None,
    artifact_dir=None,
    selection_fraction: float = 0.5,
    selection_seed: int = 17,
    heuristic_union: bool = True,
    heuristic_preds: dict[str, np.ndarray] | None = None,
    chunk_sessions: int = 2048,
    aid_feats: dict[str, np.ndarray] | None = None,
    train_device=None,
) -> TwoStageArtifacts:
    """Train + evaluate (labels given) or predict (labels None) end to end.

    ``train`` supplies statistics (covisitation, embeddings, aid features);
    ``target`` sessions receive candidates and predictions.

    ``selection_fraction`` splits the labeled target sessions into a
    *selection* subset (prior-blend alpha and early-stop metrics are computed
    only there) and a disjoint *report* subset scored by
    ``artifacts.report_disjoint`` — so the reported number never shares
    sessions with the hyper-selection (the reference's OOF-vs-holdout split,
    src/ranker/inference.py:321-337).  ``report`` still covers all sessions
    for continuity; cite ``report_disjoint`` when claiming lift.

    ``artifact_dir`` enables per-stage persistence and crash resume (the
    reference's pattern of every stage persisting so reruns restart from the
    last file, SURVEY §5.3: ``load_dataset: True`` short-circuits, chunked
    writes): representation models found under the directory are loaded
    instead of rebuilt, and are saved there as they complete.
    """
    from pathlib import Path

    adir = Path(artifact_dir) if artifact_dir is not None else None
    if adir is not None:
        # per-stage saves (rankers, sgns) assume the directory exists even
        # when the covisitation branch that used to create it is skipped
        # because prebuilt matrices were passed in
        adir.mkdir(parents=True, exist_ok=True)

    # ---- stage 0: representation models ----------------------------------
    if matrices is None and adir is not None and (adir / "covisitation").is_dir():
        log.info("resuming covisitation matrices from %s", adir)
        matrices = CovisitationMatrices.load(adir / "covisitation")
    if matrices is None:
        log.info("building covisitation matrices over %d events", train.n_events)
        matrices = build_covisitation(train, n_aids, covisit_config)
        if adir is not None:
            (adir / "covisitation").mkdir(parents=True, exist_ok=True)
            matrices.save(adir / "covisitation")
    ft_neighbors = None
    if (sgns_config is not None and sgns is None and adir is not None
            and (adir / "sgns.npz").exists()):
        log.info("resuming SGNS embeddings from %s", adir)
        sgns = SGNSModel.load(adir / "sgns.npz", sgns_config)
    if sgns_config is not None and sgns is None:
        log.info("training SGNS embeddings")
        sgns = train_sgns(train, n_aids, sgns_config)
        if adir is not None:
            adir.mkdir(parents=True, exist_ok=True)
            sgns.save(adir / "sgns.npz")
    if sgns is not None:
        ft_neighbors = sgns.neighbor_table(k=ft_k)

    # ---- stage 1: candidates ---------------------------------------------
    cands = regular_candidates(
        target,
        matrices,
        ft_neighbors=ft_neighbors,
        labels=labels,
        uniq_cap=uniq_cap,
        wide_k=min(covisit_config.top_k_wide, matrices.tables["time_weighted"][0].shape[1]),
        k_covisit=k_covisit,
        chunk_sessions=chunk_sessions,
    )
    heur_rank = None
    if heuristic_union:
        # union the L4 heuristic's top-20 into the grid and expose its
        # ordering as a feature + the blend prior: two-stage then dominates
        # the heuristic by construction (alpha = 0 recovers it exactly) and
        # any selected alpha > 0 is measured reranker lift over it
        heur_preds = heuristic_preds
        if heur_preds is None:
            import jax

            from otto_tpu.models.covisitation import covisit_heuristic_predictions
            from otto_tpu.models.frequency import FrequencyStatistics

            stats = FrequencyStatistics.compute(train, n_aids=n_aids)
            stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
            heur_preds = covisit_heuristic_predictions(
                target, matrices, stats_top, ft_neighbors=ft_neighbors,
                chunk_sessions=chunk_sessions,
                # on a CPU host the vectorized accumulators are both faster
                # and tie-break-exact; on an accelerator the device kernels
                recency_host_f64=jax.default_backend() == "cpu",
                covisit_host=jax.default_backend() == "cpu",
            )
        heur_rank = _union_heuristic(cands, heur_preds, labels)
        feature_list = list(feature_list) + ["heuristic_rank_score"]
    max_recall = cands.max_recall_report(labels) if labels is not None else {}

    # ---- stage 2: features ------------------------------------------------
    # aid/session statistics come from train+target events (the reference
    # computes them over the full split union, aid_feature_engineering.py:29-38).
    # A precomputed ``aid_feats`` (e.g. over the FULL target in the streamed
    # pipeline, otto_tpu/streaming.py) takes precedence so training and
    # shard prediction share one global feature plane.
    if aid_feats is None:
        stats_store = EventStore.from_flat(
            np.concatenate([train.session_ids[train.session_idx], target.session_ids[target.session_idx]]),
            np.concatenate([train.aid, target.aid]),
            np.concatenate([train.ts, target.ts]),
            np.concatenate([train.type, target.type]),
        )
        aid_feats = compute_aid_features(stats_store, n_aids)
    sess_feats = compute_session_features(target, aid_feats)

    # ---- stage 3+4: per-type ranker training / prediction -----------------
    sel_mask = None
    if labels is not None and 0.0 < selection_fraction < 1.0:
        sel_mask = (
            np.random.default_rng(selection_seed).random(target.n_sessions)
            < selection_fraction
        )
        if sel_mask.all() or not sel_mask.any():  # degenerate tiny inputs
            sel_mask = None

    rankers: dict[str, RankerModel] = {}
    predictions: dict[str, np.ndarray] = {}
    for etype in EVENT_TYPES:
        inter = compute_interaction_features(
            target, cands.candidates[etype], cands.scores[etype], n_aids
        )
        if heur_rank is not None:
            hr = heur_rank[etype]
            K = TOP_K  # list width, not observed max rank (ADVICE r3)
            inter["heuristic_rank_score"] = np.where(
                hr >= 0, (K - hr).astype(np.float32) / K, 0.0
            ).astype(np.float32)
        X = assemble_features(feature_list, inter, aid_feats, sess_feats, cands.candidates[etype])
        mask = cands.candidates[etype] >= 0
        if labels is not None:
            data = RankerData(
                features=X,
                labels=cands.labels[etype],
                mask=mask,
                session_ids=target.session_ids,
                candidates=cands.candidates[etype],
                feature_names=list(feature_list),
            )
            eval_fn = _recall_eval_fn(labels, cands.candidates[etype], etype)
            if sel_mask is not None:
                # restrict alpha / early-stop selection to the selection half
                raw_eval = eval_fn

                def eval_fn(session_indices, scores, _raw=raw_eval):
                    keep = sel_mask[session_indices]
                    if not keep.any():
                        return _raw(session_indices, scores)
                    return _raw(session_indices[keep], scores[keep])

            rk_path = (adir / f"ranker_{etype}.npz") if adir is not None else None
            resumed = rk_path is not None and rk_path.exists()
            if resumed:
                # crash resume: reload the finished fold models and score
                # with them (the reference's reload-and-predict pattern,
                # lgb_trainer.py:248-263; fold-averaged rather than OOF)
                log.info("resuming %s ranker from %s", etype, rk_path)
                model = load_ranker_model(
                    rk_path,
                    ranker_config if not isinstance(ranker_config, GBDTConfig) else None,
                )
                mask_e = cands.candidates[etype] >= 0
                if train_device is not None and hasattr(model, "predict_binned_folds"):
                    oof = model.predict(X, mask_e, device=train_device)
                else:
                    oof = model.predict(X, mask_e)
                rankers[etype] = model
            else:
                model, oof = _train_engine(data, ranker_config, eval_fn,
                                           device=train_device)
                rankers[etype] = model
            if second_ranker_config is not None and not resumed:
                # the reference blends a LightGBM and an XGBoost reranker
                # (ranker/inference.py:64-85); here: a second tower with a
                # different seed/architecture, robust-scaled weighted blend
                model_b, oof_b = _train_engine(data, second_ranker_config,
                                               eval_fn, device=train_device)
                rankers[f"{etype}_b"] = model_b
                oof = _blend_scores(
                    cands.candidates[etype], [oof, oof_b], list(blend_weights)
                )
            if prior_blend:
                stored_alpha = getattr(rankers[etype], "prior_alpha", float("nan"))
                if resumed and not np.isnan(stored_alpha):
                    # reuse the alpha selected before the crash
                    hr = None if heur_rank is None else heur_rank[etype]
                    c = cands.candidates[etype]
                    valid = c >= 0
                    prior_n = _blend_scores(c, [_prior_matrix(c, hr)], [1.0])
                    tower_n = _blend_scores(c, [oof], [1.0])
                    if np.isfinite(stored_alpha):
                        tower_z = np.where(valid, tower_n, 0.0)
                        oof = np.where(valid, prior_n + stored_alpha * tower_z, -np.inf)
                    else:  # alpha = inf -> pure tower
                        oof = tower_n
                else:
                    oof, alpha = _prior_blend(
                        cands.candidates[etype], oof, eval_fn,
                        heur_rank=None if heur_rank is None else heur_rank[etype],
                    )
                    rankers[etype].prior_alpha = alpha
                    log.info("%s: prior-blend alpha %.2f", etype, alpha)
            predictions[etype] = top_k_predictions(cands.candidates[etype], oof, k=TOP_K)
            if adir is not None:
                rankers[etype].save(adir / f"ranker_{etype}.npz")
                if f"{etype}_b" in rankers:
                    rankers[f"{etype}_b"].save(adir / f"ranker_{etype}_b.npz")
        else:
            raise ValueError(
                "prediction-only mode requires pre-trained rankers; use predict_two_stage"
            )

    report = None
    report_disjoint = None
    if labels is not None:
        report = evaluate_predictions(
            labels, predictions["clicks"], predictions["carts"], predictions["orders"]
        )
        log.info("two-stage validation scores\n%s", report)
        if sel_mask is not None:
            holdout = np.flatnonzero(~sel_mask)
            report_disjoint = evaluate_predictions(
                labels.take(holdout),
                predictions["clicks"][holdout],
                predictions["carts"][holdout],
                predictions["orders"][holdout],
            )
            log.info(
                "two-stage scores on the %d selection-disjoint sessions\n%s",
                len(holdout), report_disjoint,
            )

    artifacts = TwoStageArtifacts(
        matrices=matrices,
        sgns=sgns,
        candidates=cands,
        rankers=rankers,
        predictions=predictions,
        report=report,
        max_recall=max_recall,
        selection_mask=sel_mask,
        report_disjoint=report_disjoint,
        heuristic_union=heuristic_union,
        feature_list=list(feature_list),
    )
    if adir is not None:
        artifacts.save(adir)
    return artifacts


def predict_two_stage(
    artifacts: TwoStageArtifacts,
    train: EventStore,
    target: EventStore,
    n_aids: int,
    feature_list: list[str] | None = None,
    uniq_cap: int = 64,
    k_covisit: int = 100,
    heuristic_union: bool | None = None,
    aid_feats: dict[str, np.ndarray] | None = None,
    heuristic_preds: dict[str, np.ndarray] | None = None,
    chunk_sessions: int = 2048,
    wide_k: int | None = None,
    stats_out: dict | None = None,
    predict_device=None,
) -> dict[str, np.ndarray]:
    """Score new sessions with already-trained artifacts (submission mode).

    ``heuristic_union`` and ``feature_list`` default to the training-time
    settings recorded in the artifacts (meta.json), so prediction scores with
    the same feature plane and prior the rankers were fit on (ADVICE r3);
    pass them explicitly only to override.
    """
    if heuristic_union is None:
        heuristic_union = artifacts.heuristic_union
    if feature_list is None:
        if artifacts.feature_list is not None:
            # strip the union-added column; it is re-appended below iff union
            feature_list = [f for f in artifacts.feature_list
                            if f != "heuristic_rank_score"]
        else:
            feature_list = RANKER_FEATURES
    ft_neighbors = artifacts.sgns.neighbor_table(k=20) if artifacts.sgns is not None else None
    if wide_k is None:
        # mirror run_two_stage's training-time candgen width
        wide_k = min(CovisitConfig().top_k_wide,
                     artifacts.matrices.tables["time_weighted"][0].shape[1])
    cands = regular_candidates(
        target, artifacts.matrices, ft_neighbors=ft_neighbors,
        uniq_cap=uniq_cap, k_covisit=k_covisit,
        chunk_sessions=chunk_sessions, wide_k=wide_k,
    )
    heur_rank = None
    if heuristic_union:
        if heuristic_preds is None:
            import jax

            from otto_tpu.models.covisitation import covisit_heuristic_predictions
            from otto_tpu.models.frequency import FrequencyStatistics

            stats = FrequencyStatistics.compute(train, n_aids=n_aids)
            stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
            heuristic_preds = covisit_heuristic_predictions(
                target, artifacts.matrices, stats_top, ft_neighbors=ft_neighbors,
                chunk_sessions=chunk_sessions,
                recency_host_f64=jax.default_backend() == "cpu",
                covisit_host=jax.default_backend() == "cpu",
            )
        heur_rank = _union_heuristic(cands, heuristic_preds, None)
        feature_list = list(feature_list) + ["heuristic_rank_score"]
    if aid_feats is None:
        stats_store = EventStore.from_flat(
            np.concatenate([train.session_ids[train.session_idx], target.session_ids[target.session_idx]]),
            np.concatenate([train.aid, target.aid]),
            np.concatenate([train.ts, target.ts]),
            np.concatenate([train.type, target.type]),
        )
        aid_feats = compute_aid_features(stats_store, n_aids)
    sess_feats = compute_session_features(target, aid_feats)
    out = {}
    for etype in EVENT_TYPES:
        inter = compute_interaction_features(
            target, cands.candidates[etype], cands.scores[etype], n_aids
        )
        if heur_rank is not None:
            hr = heur_rank[etype]
            K = TOP_K  # list width, not observed max rank (ADVICE r3)
            inter["heuristic_rank_score"] = np.where(
                hr >= 0, (K - hr).astype(np.float32) / K, 0.0
            ).astype(np.float32)
        X = assemble_features(feature_list, inter, aid_feats, sess_feats, cands.candidates[etype])
        mask = cands.candidates[etype] >= 0
        model = artifacts.rankers[etype]

        def _predict(m):
            # only the GBDT engine takes a device route; the tower predicts
            # in place
            if predict_device is not None and hasattr(m, "predict_binned_folds"):
                return m.predict(X, mask, device=predict_device)
            return m.predict(X, mask)

        scores = _predict(model)
        b = artifacts.rankers.get(f"{etype}_b")
        if b is not None:
            scores = _blend_scores(cands.candidates[etype],
                                   [scores, _predict(b)], [0.5, 0.5])
        if stats_out is not None:
            stats_out[f"rows_{etype}"] = int(np.prod(cands.candidates[etype].shape))
        alpha = getattr(model, "prior_alpha", float("nan"))
        if np.isfinite(alpha):
            prior = _prior_matrix(
                cands.candidates[etype],
                None if heur_rank is None else heur_rank[etype],
            )
            prior_n = _blend_scores(cands.candidates[etype], [prior], [1.0])
            tower_n = _blend_scores(cands.candidates[etype], [scores], [1.0])
            tower_z = np.where(mask, tower_n, 0.0)  # avoid 0 * -inf = nan
            scores = np.where(mask, prior_n + alpha * tower_z, -np.inf)
        out[etype] = top_k_predictions(cands.candidates[etype], scores, k=TOP_K)
    return out
