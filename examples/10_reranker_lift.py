"""Example 10: reranker lift with the heuristic-union protocol (round 3).

The reference's L6 exists because its lambdarank GBDT beats candidate
ordering (src/ranker/lgb_trainer.py:156-198).  This example shows the
framework's guarantee-then-refine version of that contract:

1. the covisitation heuristic's top-20 is unioned into the candidate grid
   and used as the prior-blend prior, so the two-stage pipeline at alpha = 0
   reproduces the heuristic exactly — it can no longer lose to it;
2. alpha and early stopping are selected on a session half disjoint from
   the reported half, so the reported lift carries no selection optimism.

Run:  python examples/10_reranker_lift.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from otto_tpu import EVENT_TYPES
from otto_tpu.config import RankerConfig
from otto_tpu.data.splits import split_by_time
from otto_tpu.data.synthetic import synthetic_events_v2
from otto_tpu.eval.harness import evaluate_predictions
from otto_tpu.models.covisitation import build_covisitation, covisit_heuristic_predictions
from otto_tpu.models.frequency import FrequencyStatistics
from otto_tpu.twostage import run_two_stage

store = synthetic_events_v2(n_sessions=8000, n_aids=4000, seed=11)
split = split_by_time(store, val_fraction=0.2, seed=11)
mats = build_covisitation(split.train, 4000)
stats = FrequencyStatistics.compute(split.train, n_aids=4000)
stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}

heur = covisit_heuristic_predictions(
    split.val_input, mats, stats_top, recency_host_f64=True
)

art = run_two_stage(
    split.train, split.val_input, 4000, labels=split.val_labels,
    matrices=mats, heuristic_preds=heur,
    ranker_config=RankerConfig(hidden_dims=(128, 64), n_folds=2, epochs=4,
                               batch_sessions=256, loss="lambdarank"),
)

hold = np.flatnonzero(~art.selection_mask)
lab_h = split.val_labels.take(hold)
heur_rep = evaluate_predictions(
    lab_h, heur["clicks"][hold], heur["carts"][hold], heur["orders"][hold]
)
print(f"alphas: { {t: art.rankers[t].prior_alpha for t in EVENT_TYPES} }")
print(f"heuristic (disjoint half): weighted {heur_rep.weighted:.4f}")
print(f"two-stage (disjoint half): weighted {art.report_disjoint.weighted:.4f}")
print(f"lift: {art.report_disjoint.weighted - heur_rep.weighted:+.4f}")
# guaranteed on the selection half (alpha=0 reproduces the heuristic); on
# the disjoint half a selected alpha>0 can drift by generalization noise
assert art.report_disjoint.weighted >= heur_rep.weighted - 5e-3, (
    "two-stage fell materially below the heuristic it unions"
)
