"""Production-serving walkthrough: train once, persist artifacts, score
fresh sessions from a separate process.

The reference's deployment story is "rerun the inference scripts over files";
here the artifact directory is the deployable unit: covisitation tables,
SGNS embedding table, and per-event-type ranker folds, all reloadable with
``TwoStageArtifacts.load`` (see otto_tpu/twostage.py).

Run: python examples/06_serving.py [artifact_dir]
"""

import sys as _sys, pathlib as _pathlib
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import tempfile
import time

import numpy as np

from otto_tpu.config import CovisitConfig, RankerConfig, SGNSConfig
from otto_tpu.data import splits, synthetic_events
from otto_tpu.logging_utils import configure_logging
from otto_tpu.twostage import TwoStageArtifacts, predict_two_stage, run_two_stage
from otto_tpu.utils.runtime import enable_compilation_cache

configure_logging()
enable_compilation_cache()

artifact_dir = _sys.argv[1] if len(_sys.argv) > 1 else tempfile.mkdtemp(prefix="otto_serve_")
N_AIDS = 2_000

# ---------------- offline: train + persist ---------------------------------
es = synthetic_events(n_sessions=6_000, n_aids=N_AIDS, mean_length=12)
sp = splits.split_by_fraction(es, val_fraction=0.25)
art = run_two_stage(
    sp.train, sp.val_input, N_AIDS, labels=sp.val_labels,
    covisit_config=CovisitConfig(top_k_wide=20, session_tail=30),
    ranker_config=RankerConfig(hidden_dims=(128, 64), n_folds=3, epochs=5,
                               batch_sessions=256, dropout=0.0),
    sgns_config=SGNSConfig(dim=16, window=5, negatives=10, epochs=3),
    artifact_dir=artifact_dir,
)
print(f"trained; validation weighted recall@20 = {art.report.weighted:.4f}")
print(f"artifacts persisted under {artifact_dir}")

# ---------------- online: load + serve --------------------------------------
# (in production this runs in a different process; loading is all it needs)
serving = TwoStageArtifacts.load(artifact_dir)

fresh = es.select_sessions(np.arange(es.n_sessions - 512, es.n_sessions))
t0 = time.perf_counter()
preds = predict_two_stage(serving, sp.train, fresh, N_AIDS)
dt = time.perf_counter() - t0
print(f"scored {fresh.n_sessions} fresh sessions in {dt:.2f}s "
      f"({fresh.n_sessions / dt:,.0f} sessions/s, "
      f"{dt / fresh.n_sessions * 1e3:.1f} ms/session amortized)")
for etype in ("clicks", "carts", "orders"):
    row = preds[etype][0]
    print(f"  sample {etype}: {row[row >= 0][:10].tolist()}")
