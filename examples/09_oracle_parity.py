"""Oracle-parity demo: the framework's batched heuristic + candidate
generator vs the reference-semantics oracle on one small dataset.

The oracle (`otto_tpu.eval.oracle`) restates the reference's per-session
Counter/list algorithms exactly (src/covisitation/inference.py:128-247,
src/ranker/regular_candidate_generation.py:138-197); this demo feeds both
sides identical covisitation tables and frequency statistics and prints the
agreement table.  The realistic-scale run (1M sessions / 100k aids) lives in
tools/parity_run.py; its CPU-run results are recorded in PARITY_1M.json.

Run: python examples/09_oracle_parity.py  (CPU, ~2 min)
"""

import os
import pathlib
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from otto_tpu import EVENT_TYPES
from otto_tpu.data.splits import split_by_time
from otto_tpu.data.synthetic import synthetic_events_v2
from otto_tpu.eval import oracle as orc
from otto_tpu.models.candidates import regular_candidates
from otto_tpu.models.covisitation import build_covisitation, covisit_heuristic_predictions
from otto_tpu.models.frequency import FrequencyStatistics

N_AIDS = 2_000

store = synthetic_events_v2(n_sessions=8_000, n_aids=N_AIDS, n_clusters=60, seed=1)
split = split_by_time(store, val_fraction=0.2)
mats = build_covisitation(split.train, N_AIDS)
stats = FrequencyStatistics.compute(split.train, n_aids=N_AIDS)
stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}

fw = covisit_heuristic_predictions(split.val_input, mats, stats_top)
cs = regular_candidates(split.val_input, mats)

aid_lists, type_lists = orc.store_to_lists(split.val_input)
tables15 = {k: orc.table_to_dict(mats.tables[k][0], 15) for k in mats.tables}
tables20 = {k: orc.table_to_dict(mats.tables[k][0], 20) for k in mats.tables}
freq = {t: [int(a) for a in stats.top_by_type[t]] for t in EVENT_TYPES}
orx = orc.oracle_heuristic(aid_lists, type_lists, tables15, freq, None)
ocs = orc.oracle_regular_candidates(aid_lists, type_lists, tables20, None)

lab = orc.labels_to_lists(split.val_labels)
rows = lambda arr: [[int(x) for x in r if x >= 0] for r in arr]
print("| path | type | exact | set | fw recall | oracle recall |")
print("|---|---|---|---|---|---|")
labmap = dict(zip(EVENT_TYPES, lab))
for t in EVENT_TYPES:
    f = rows(fw[t])
    e = np.mean([a == b for a, b in zip(f, orx[t])])
    s = np.mean([set(a) == set(b) for a, b in zip(f, orx[t])])
    print(f"| heuristic | {t} | {e:.4f} | {s:.4f} | "
          f"{orc.corpus_recall(f, labmap[t]):.4f} | "
          f"{orc.corpus_recall(orx[t], labmap[t]):.4f} |")
for t in EVENT_TYPES:
    f = rows(cs.candidates[t])
    e = np.mean([a == b for a, b in zip(f, ocs[t][0])])
    print(f"| candgen | {t} | {e:.4f} | - | "
          f"{orc.corpus_recall(f, labmap[t]):.4f} | "
          f"{orc.corpus_recall(ocs[t][0], labmap[t]):.4f} |")
