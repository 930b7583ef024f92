#!/usr/bin/env python3
"""Smoke test of the OTTO two-stage path on the GPU, at full catalogue width.

    python chip_smoke.py               # one card: device, retrieval, train, serve
    python chip_smoke.py --four-cards  # four cards: the mesh-routed paths only

Every phase drives the library's own entry points at the OTTO catalogue's
width (1,855,604 aids, 32-dim item table, 7 covisitation kinds) with data and
weights made from fixed seeds, prints what it found, and stops the process
with a non-zero exit at the first failed check.  Every comparison states its
tolerance and why.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

The script refuses to run anywhere but on a GPU: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
N_AIDS = 1_855_604


@dataclass(frozen=True)
class Sizes:
    """Shapes of every phase (the defaults are the real ones)."""

    n_aids: int = N_AIDS
    dim: int = 32
    n_queries: int = 4096       # retrieval recall check
    sgns_steps: int = 64        # SGNS optimizer steps (two dispatches)
    gbdt_rows: int = 20_000 * 100  # sessions x candidates of the reference ranker
    gbdt_features: int = 52
    seq_sessions: int = 2048    # full_sort_topk queries
    serve_sessions: int = 300_000
    oracle_sessions: int = 20_000
    serve_trees: int = 8


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, default=float), flush=True)


def require_gpu(devices):
    """The first device must be a GPU; anything else is a failure."""
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: FAILED: needs a GPU, JAX found "
                         f"{d.platform!r} ({d.device_kind})")
    return d


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def read_config(name: str) -> dict:
    """``key: value`` lines of ``configs/<name>.yaml`` (flat files; no YAML
    dependency on this path)."""
    out = {}
    for line in (HERE / "configs" / f"{name}.yaml").read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if ":" in line:
            key, val = (s.strip() for s in line.split(":", 1))
            try:
                out[key] = json.loads(val)
            except json.JSONDecodeError:
                out[key] = val
    return out


def timed(fn, *args, **kw):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


def recall(got: np.ndarray, want: np.ndarray) -> float:
    k = want.shape[1]
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(got, want)]))


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------

def phase_device():
    import jax

    d = require_gpu(jax.devices())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    say("device", kind=d.device_kind, count=len(jax.devices()),
        jax=jax.__version__)
    from otto_tpu.utils.runtime import enable_compilation_cache

    say("device", compile_cache=enable_compilation_cache())
    return smi


# --------------------------------------------------------------------------
# phase 2: retrieval
# --------------------------------------------------------------------------

def phase_retrieval(sz: Sizes, interpret: bool = False):
    import jax
    import jax.numpy as jnp

    import otto_tpu.ops.retrieval as R

    items = jax.random.normal(jax.random.PRNGKey(0), (sz.n_aids, sz.dim), jnp.float32)
    queries = jax.random.normal(jax.random.PRNGKey(1), (sz.n_queries, sz.dim), jnp.float32)

    # the stage-1 kernel against its plain-XLA reference at full width.
    # Tolerance: 1e-5 of the largest |score|, because the kernel's Triton dot
    # and XLA's GEMM sum the K=32 bf16 products in different orders; indices
    # may then differ only where two window maxima tie within that rounding,
    # so at least 99.9% of them must agree.
    block = R.stage1_block(sz.n_aids, 100)
    table, _ = R._pad_items(items.astype(jnp.bfloat16), block)
    sq = jnp.sum(items * items, axis=1)
    bias = jnp.concatenate([sq, jnp.full((table.shape[0] - sz.n_aids,), jnp.inf)])
    q1 = (2.0 * queries[:256]).astype(jnp.bfloat16)
    (kv, ki), t_k = timed(jax.jit(lambda q, t, b: R._stage1(
        q, t, b, block=block, interpret=interpret)), q1, table, bias)
    rv, ri = jax.jit(lambda q, t, b: R.stage1_reference(q, t, b, block=block))(
        q1, table, bias)
    kv, ki, rv, ri = map(np.asarray, (kv, ki, rv, ri))
    live = np.isfinite(rv)
    scale = np.abs(rv[live]).max()
    val_err = float(np.abs(kv[live] - rv[live]).max() / scale)
    idx_eq = float((ki == ri)[live].mean())
    say("retrieval", stage1_vs_reference_rel_err=val_err, stage1_index_agreement=idx_eq,
        block=block, first_call_s=t_k)
    check(np.array_equal(np.isfinite(kv), live) and val_err <= 1e-5 and idx_eq >= 0.999,
          "stage-1 kernel disagrees with its plain reference")

    # the served path against the exact scan (float32, Precision.HIGHEST).
    # Bars: mean recall >= 0.99 (the production bar); every returned score
    # within 1e-5 x the row's largest |score| of an f32 HIGHEST rescoring of
    # the same item (euclidean scores can sit near zero, so a per-entry
    # relative bound would be meaningless).
    for metric in ("dot", "euclidean"):
        (_, exact_i), t_exact = timed(R.topk_scan, queries, items, k=100, metric=metric)
        exact_i = np.asarray(exact_i)
        for k in (100, 21):
            R.topk_blocked(queries, items, k=k, metric=metric, interpret=interpret)
            (s, i), t_fast = timed(R.topk_blocked, queries, items, k=k,
                                   metric=metric, interpret=interpret)
            x = items[i]
            ref = jnp.einsum("bd,bkd->bk", queries, x, precision=R.HIGHEST)
            if metric == "euclidean":
                ref = 2.0 * ref - jnp.sum(x * x, axis=2)
            ref, s, i = np.asarray(ref), np.asarray(s), np.asarray(i)
            err = float(np.max(np.abs(s - ref) / np.abs(ref).max(axis=1, keepdims=True)))
            rec = recall(i, exact_i[:, :k])
            say("retrieval", metric=metric, k=k, recall=rec, score_rel_err=err,
                blocked_s=t_fast, exact_scan_s=t_exact, queries=sz.n_queries)
            check(rec >= 0.99, f"recall@{k} {metric} {rec:.4f} < 0.99")
            check(err <= 1e-5, f"scores {metric} k={k} off by {err:.2e} of the row max")

    time_neighbor_table(sz, items, interpret)


def time_neighbor_table(sz: Sizes, items, interpret: bool = False):
    """The full-catalogue neighbour table through the library, then the
    same sweep on the device with the kernel and with the plain-XLA stage 1."""
    import jax
    import jax.numpy as jnp

    import otto_tpu.ops.retrieval as R

    t0 = time.perf_counter()
    nbr = R.build_neighbor_table(np.asarray(items), k=20, metric="euclidean",
                                 interpret=interpret)
    t_table = time.perf_counter() - t0
    check(nbr.shape == (sz.n_aids, 20) and nbr.min() >= 0 and nbr.max() < sz.n_aids,
          "neighbour table shape or range")
    check(not (nbr == np.arange(sz.n_aids)[:, None]).any(), "neighbour table holds self")
    sweeps = {}
    for name, qb, kw in (("kernel", 4096, dict(interpret=interpret)),
                         ("plain_xla", 1024, dict(reference=True))):
        R.topk_blocked(items[:qb], items, k=21, metric="euclidean", **kw)
        t0 = time.perf_counter()
        for st in range(0, sz.n_aids, qb):
            q = items[st:st + qb]
            if q.shape[0] < qb:
                q = jnp.pad(q, ((0, qb - q.shape[0]), (0, 0)))
            out = R.topk_blocked(q, items, k=21, metric="euclidean", **kw)
        jax.block_until_ready(out)
        sweeps[name] = time.perf_counter() - t0
    say("retrieval", neighbor_table_k20_s=t_table,
        sweep_k21_kernel_s=sweeps["kernel"], sweep_k21_plain_xla_s=sweeps["plain_xla"])


# --------------------------------------------------------------------------
# phase 3: train
# --------------------------------------------------------------------------

def make_corpus(sz: Sizes, seed: int = 7):
    from otto_tpu.data.splits import split_by_time
    from otto_tpu.data.synthetic import synthetic_events_v2

    t0 = time.perf_counter()
    store = synthetic_events_v2(n_sessions=sz.serve_sessions, n_aids=sz.n_aids, seed=seed)
    split = split_by_time(store, val_fraction=0.2, seed=seed)
    say("setup", sessions=store.n_sessions, events=store.n_events,
        train_events=split.train.n_events, val_sessions=split.val_input.n_sessions,
        datagen_s=time.perf_counter() - t0)
    return split


def phase_train(sz: Sizes, split):
    import jax
    import jax.numpy as jnp

    from otto_tpu.config import SGNSConfig, SequenceModelConfig
    from otto_tpu.models.embeddings import train_sgns_device
    from otto_tpu.models.gbdt import _grow_tree
    from otto_tpu.models.sequence import train_sequence_model
    from otto_tpu.ops.retrieval import topk_scan

    # SGNS over the full-catalogue table, fastText widths, capped steps
    cfg = SGNSConfig.from_dict({**read_config("fasttext"), "epochs": 1})
    acct: dict = {}
    t0 = time.perf_counter()
    sgns = train_sgns_device(split.train, sz.n_aids, cfg,
                             steps_per_dispatch=sz.sgns_steps // 2,
                             max_steps_per_epoch=sz.sgns_steps, pairs_out=acct)
    loss = acct["epoch_log"][-1]["loss"]
    say("train", model="sgns", table=list(sgns.w_in.shape), steps=sz.sgns_steps,
        loss=loss, pairs=acct["pairs_trained"], s=time.perf_counter() - t0)
    check(np.isfinite(loss) and np.isfinite(sgns.w_in).all(), "SGNS loss or table not finite")

    # one GBDT tree at the reference ranker shape, both histogram routes.
    # Gradients are small integers and hessians 1, so every histogram sum is
    # exact in float32 whatever the summation order (atomics included): both
    # routes must grow the identical tree.
    n, f = sz.gbdt_rows, sz.gbdt_features
    kb, kg = jax.random.split(jax.random.PRNGKey(3))
    binned = jax.random.randint(kb, (n, f), 0, 256, jnp.int32).astype(jnp.uint8)
    signal = (binned[:, 0] > 128).astype(jnp.float32) - (binned[:, 1] > 64).astype(jnp.float32)
    grad = signal + jax.random.randint(kg, (n,), -1, 2).astype(jnp.float32)
    ones = jnp.ones(n, jnp.float32)
    args = (binned, grad, ones, ones, ones, jnp.ones(f, bool), jnp.float32(0.01),
            jnp.float32(1e-5), jnp.float32(2000.0), jnp.float32(1e-3), jnp.float32(0.05))
    trees, times = {}, {}
    for impl in ("matmul", "scatter"):
        kw = dict(depth=7, n_bins=256, hist_chunk=1 << 18, hist_impl=impl)
        jax.block_until_ready(_grow_tree(*args, **kw))
        trees[impl], times[impl] = timed(_grow_tree, *args, **kw)
    a, b = trees["matmul"], trees["scatter"]
    same = all(np.array_equal(np.asarray(a[j]), np.asarray(b[j])) for j in (0, 1, 4))
    leaf_err = float(np.abs(np.asarray(a[2]) - np.asarray(b[2])).max())
    say("train", model="gbdt_tree", rows=n, features=f, depth=7, bins=256,
        matmul_s=times["matmul"], scatter_s=times["scatter"], same_tree=same,
        leaf_max_abs_diff=leaf_err)
    check(same and leaf_err <= 1e-6 and np.isfinite(np.asarray(a[2])).all(),
          "GBDT histogram routes grew different trees")

    # SASRec-style session encoder at full catalogue width, a few steps
    scfg = SequenceModelConfig.from_dict({**read_config("sequence_transformer"),
                                          "n_aids": sz.n_aids, "epochs": 1})
    lengths = np.diff(split.train.offsets)
    # about four optimizer batches of (prefix -> next aid) examples
    take = np.cumsum(np.maximum(lengths - 1, 0)) <= 4 * scfg.batch_size
    t0 = time.perf_counter()
    model = train_sequence_model(split.train.select_sessions(take), scfg)
    loss = model.history[-1]["loss"]
    say("train", model="sasrec", n_aids=sz.n_aids, dim=scfg.dim, loss=loss,
        s=time.perf_counter() - t0)
    check(np.isfinite(loss), "sequence model loss not finite")
    sess = split.val_input.select_sessions(np.arange(split.val_input.n_sessions) < sz.seq_sessions)
    t0 = time.perf_counter()
    top = model.full_sort_topk(sess, k=20)
    t_top = time.perf_counter() - t0
    vecs = jnp.asarray(model.encode_sessions(sess))
    items = jnp.asarray(np.asarray(model.params["item_emb"])[: sz.n_aids])
    _, exact = topk_scan(vecs, items, k=20, metric="dot")
    rec = recall(top, np.asarray(exact))
    say("train", model="sasrec_full_sort_topk", sessions=sess.n_sessions,
        recall_vs_exact=rec, s=t_top)
    check(top.shape == (sess.n_sessions, 20) and top.min() >= 0 and top.max() < sz.n_aids,
          "full_sort_topk shape or range")
    check(rec >= 0.99, f"full_sort_topk recall {rec:.4f} < 0.99")
    return sgns


# --------------------------------------------------------------------------
# phase 4: serve
# --------------------------------------------------------------------------

def phase_serve(sz: Sizes, split, sgns):
    from otto_tpu import EVENT_TYPES
    from otto_tpu.config import GBDTConfig
    from otto_tpu.eval import oracle as orc
    from otto_tpu.eval.harness import evaluate_predictions
    from otto_tpu.models.covisitation import build_covisitation, covisit_heuristic_predictions
    from otto_tpu.models.frequency import FrequencyStatistics
    from otto_tpu.twostage import predict_two_stage, run_two_stage

    t0 = time.perf_counter()
    mats = build_covisitation(split.train, sz.n_aids)
    say("serve", covisit_kinds=len(mats.tables), rows=mats.n_aids,
        build_s=time.perf_counter() - t0)
    check(len(mats.tables) == 7 and mats.n_aids == sz.n_aids, "covisitation tables")

    # half the target sessions fit the rankers, the other half is served
    S = split.val_input.n_sessions
    fit = np.random.default_rng(11).random(S) < 0.5
    fit_in, held_in = split.val_input.select_sessions(fit), split.val_input.select_sessions(~fit)
    fit_lab = split.val_labels.take(np.flatnonzero(fit))
    held_lab = split.val_labels.take(np.flatnonzero(~fit))

    t0 = time.perf_counter()
    art = run_two_stage(
        split.train, fit_in, sz.n_aids, labels=fit_lab, matrices=mats, sgns=sgns,
        ranker_config=GBDTConfig(n_trees=sz.serve_trees, n_folds=2,
                                 early_stopping_rounds=sz.serve_trees, eval_every=4))
    say("serve", fit_sessions=fit_in.n_sessions, fit_weighted_recall=art.report.weighted,
        fit_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    preds = predict_two_stage(art, split.train, held_in, sz.n_aids)
    t_pred = time.perf_counter() - t0
    rep = evaluate_predictions(held_lab, preds["clicks"], preds["carts"], preds["orders"])
    say("serve", held_sessions=held_in.n_sessions, weighted_recall_at_20=rep.weighted,
        clicks=rep.clicks, carts=rep.carts, orders=rep.orders, predict_s=t_pred,
        sessions_per_s=held_in.n_sessions / t_pred)
    for t in EVENT_TYPES:
        p = preds[t]
        check(p.shape == (held_in.n_sessions, 20) and p.max() < sz.n_aids,
              f"{t} predictions shape or range")
    check(0.0 < rep.weighted < 1.0, "weighted recall@20 outside (0, 1)")

    # the heuristic's device route against the reference-semantics oracle on
    # the same sessions.  Tolerances as in tests/test_oracle_parity.py: ties
    # between equal float weights may resolve differently between the
    # device's f32 and the oracle's f64 sums, so >= 97% of lists identical,
    # >= 98% identical as sets, weighted recall within 2e-3.
    n_or = min(sz.oracle_sessions, held_in.n_sessions)
    sub = held_in.select_sessions(np.arange(held_in.n_sessions) < n_or)
    sub_lab = held_lab.take(np.arange(n_or))
    stats = FrequencyStatistics.compute(split.train, n_aids=sz.n_aids)
    stats_top = {t: stats.top_by_type[t] for t in EVENT_TYPES}
    ft = sgns.neighbor_table(k=20)
    t0 = time.perf_counter()
    heur = covisit_heuristic_predictions(sub, mats, stats_top, ft_neighbors=ft,
                                         recency_host_f64=False, covisit_host=False)
    t_dev = time.perf_counter() - t0
    aid_lists, type_lists = orc.store_to_lists(sub)
    tables15 = {k: orc.table_to_dict(mats.tables[k][0], 15) for k in mats.tables}
    freq = {t: [int(a) for a in stats.top_by_type[t]] for t in EVENT_TYPES}
    t0 = time.perf_counter()
    oracle = orc.oracle_heuristic(aid_lists, type_lists, tables15, freq, orc.neighbor_lists(ft))
    t_or = time.perf_counter() - t0
    lab = orc.labels_to_lists(sub_lab)
    dev_lists = {t: [[int(x) for x in row if x >= 0] for row in heur[t]] for t in EVENT_TYPES}
    r_dev = orc.weighted_corpus_recall(dev_lists, lab)["weighted"]
    r_or = orc.weighted_corpus_recall(oracle, lab)["weighted"]
    for t in EVENT_TYPES:
        exact = np.mean([f == o for f, o in zip(dev_lists[t], oracle[t])])
        setm = np.mean([set(f) == set(o) for f, o in zip(dev_lists[t], oracle[t])])
        say("serve", heuristic_vs_oracle=t, exact_match=exact, set_match=setm)
        check(exact >= 0.97 and setm >= 0.98, f"heuristic {t} parity {exact:.4f}/{setm:.4f}")
    say("serve", sessions=n_or, heuristic_weighted_recall=r_dev, oracle_weighted_recall=r_or,
        device_route_s=t_dev, oracle_s=t_or)
    check(abs(r_dev - r_or) < 2e-3, f"heuristic recall {r_dev:.4f} vs oracle {r_or:.4f}")


# --------------------------------------------------------------------------
# --four-cards: the mesh-routed paths against one card
# --------------------------------------------------------------------------

def phase_four_cards(sz: Sizes, n_dev: int = 4, interpret: bool = False):
    """Sharded candidate generation and heuristic routes over row-sharded
    full-width tables, ``sharded_topk`` over the full item table, and the
    data-parallel GBDT grow, each against the same call on one card.
    Integer outputs must be bit-equal; float outputs carry a stated
    tolerance."""
    import jax
    import jax.numpy as jnp

    from otto_tpu import EVENT_TYPES
    from otto_tpu.config import COVISIT_KINDS, MeshConfig
    from otto_tpu.data.synthetic import synthetic_events_v2
    from otto_tpu.models.candidates import regular_candidates
    from otto_tpu.models.covisitation import CovisitationMatrices, covisit_heuristic_predictions
    from otto_tpu.models.gbdt import _grow_tree
    from otto_tpu.parallel.data_parallel import make_dp_gbdt_grow
    from otto_tpu.parallel.mesh import make_mesh, shard_rows
    from otto_tpu.parallel.sharded_embedding import sharded_topk
    from otto_tpu.ops.retrieval import topk_blocked, topk_scan

    devices = jax.devices()
    check(len(devices) == n_dev, f"--four-cards needs {n_dev} devices, found {len(devices)}")

    def spans_all(x):
        return {s.device for s in x.addressable_shards} == set(devices)

    # tables are row-sharded over model=4: the cards are all-to-all over
    # NVLink, so the one collective (the masked-gather psum) needs no torus
    # layout, and each card holds a quarter of every table
    mesh_m = make_mesh(MeshConfig(data_parallel=1, model_parallel=n_dev), devices=devices)
    rng = np.random.default_rng(5)
    tables = {}
    for kind in COVISIT_KINDS:
        aids = rng.integers(0, sz.n_aids, (sz.n_aids, 50), dtype=np.int32)
        aids[rng.random(sz.n_aids) < 0.1, 30:] = -1
        w = -np.sort(-rng.random((sz.n_aids, 50)).astype(np.float32), axis=1)
        tables[kind] = (aids, np.where(aids >= 0, w, 0.0).astype(np.float32))
    mats = CovisitationMatrices(tables, sz.n_aids)
    ft = rng.integers(0, sz.n_aids, (sz.n_aids, 20), dtype=np.int32)
    sess = synthetic_events_v2(n_sessions=8192, n_aids=sz.n_aids, seed=9)
    stats_top = {t: rng.integers(0, sz.n_aids, 20).astype(np.int32) for t in EVENT_TYPES}
    check(spans_all(shard_rows(mesh_m, tables["time_weighted"][0])),
          "row-sharded table is not spread over all cards")

    kw = dict(ft_neighbors=ft, wide_k=20, chunk_sessions=1024)
    t0 = time.perf_counter()
    one = regular_candidates(sess, mats, **kw)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = regular_candidates(sess, mats, mesh=mesh_m, **kw)
    t_four = time.perf_counter() - t0
    for t in EVENT_TYPES:
        check(np.array_equal(one.candidates[t], four.candidates[t]), f"candgen {t} differs")
        # scores: sums of the same float32 weights in the same order per
        # session; 1e-5 relative covers a reordered reduction
        np.testing.assert_allclose(one.scores[t], four.scores[t], rtol=1e-5, atol=1e-6)
    say("four_cards", route="regular_candidates", sessions=sess.n_sessions,
        one_card_s=t_one, four_card_s=t_four, candidates_equal=True)

    kw = dict(ft_neighbors=ft, chunk_sessions=1024)
    one = covisit_heuristic_predictions(sess, mats, stats_top, **kw)
    four = covisit_heuristic_predictions(sess, mats, stats_top, mesh=mesh_m, **kw)
    for t in EVENT_TYPES:
        check(np.array_equal(one[t], four[t]), f"heuristic {t} differs")
    say("four_cards", route="covisit_heuristic", predictions_equal=True)

    # sharded_topk over the full item table against one card's blocked path:
    # each shard's survivors are a subset of the single table's, so the
    # merged indices must match; scores are the same f32 HIGHEST rescoring
    items = jax.random.normal(jax.random.PRNGKey(0), (sz.n_aids, sz.dim), jnp.float32)
    q = jax.random.normal(jax.random.PRNGKey(1), (1024, sz.dim), jnp.float32)
    tbl = shard_rows(mesh_m, np.asarray(items))
    check(spans_all(tbl), "item table is not spread over all cards")
    s4, i4 = sharded_topk(mesh_m, q, tbl, k=100, metric="euclidean", interpret=interpret)
    s1, i1 = topk_blocked(q, items, k=100, metric="euclidean", interpret=interpret)
    _, ie = topk_scan(q, items, k=100, metric="euclidean")
    i4, i1, ie = np.asarray(i4), np.asarray(i1), np.asarray(ie)
    rec = recall(i4, i1)
    err = float(np.max(np.abs(np.asarray(s4) - np.asarray(s1))[i4 == i1]))
    say("four_cards", route="sharded_topk", recall_vs_one_card=rec,
        recall_vs_exact=recall(i4, ie), one_card_recall_vs_exact=recall(i1, ie),
        index_equal=float((i4 == i1).mean()), score_max_abs_diff=err)
    # per-shard blocks differ from the single table's blocks, so survivors
    # of a crowded block can differ: the bar is recall >= 0.99 against the
    # one-card result, and scores of shared items within 1e-4 absolute
    # (|score| < 200; rescoring sums D=32 products in either order)
    check(rec >= 0.99 and err <= 1e-4, "sharded_topk disagrees with one card")

    # data-parallel GBDT grow over data=4 against the single-card grow:
    # integer-valued gradients make every histogram sum exact, so the tree
    # must be identical
    mesh_d = make_mesh(MeshConfig(data_parallel=n_dev, model_parallel=1), devices=devices)
    n, f = sz.gbdt_rows, sz.gbdt_features
    kb, kg = jax.random.split(jax.random.PRNGKey(3))
    binned = jax.random.randint(kb, (n, f), 0, 256, jnp.int32).astype(jnp.uint8)
    grad = ((binned[:, 0] > 128).astype(jnp.float32)
            + jax.random.randint(kg, (n,), -1, 2).astype(jnp.float32))
    ones = jnp.ones(n, jnp.float32)
    scal = (jnp.float32(0.01), jnp.float32(1e-5), jnp.float32(2000.0),
            jnp.float32(1e-3), jnp.float32(0.05))
    single = _grow_tree(binned, grad, ones, ones, ones, jnp.ones(f, bool), *scal,
                        depth=7, n_bins=256, hist_chunk=1 << 18)
    from jax.sharding import NamedSharding, PartitionSpec as P

    rows = NamedSharding(mesh_d, P("data"))
    dp_args = [jax.device_put(x, rows) for x in (binned, grad, ones, ones, ones)]
    check(all(spans_all(x) for x in dp_args), "GBDT rows are not spread over all cards")
    grow = make_dp_gbdt_grow(mesh_d, depth=7, n_bins=256)
    dp = grow(*dp_args, jnp.ones(f, bool), *scal)
    same = all(np.array_equal(np.asarray(single[j]), np.asarray(dp[j])) for j in (0, 1, 4))
    leaf_err = float(np.abs(np.asarray(single[2]) - np.asarray(dp[2])).max())
    say("four_cards", route="dp_gbdt_grow", rows=n, same_tree=same, leaf_max_abs_diff=leaf_err)
    check(same and leaf_err <= 1e-6, "data-parallel GBDT grew a different tree")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh-routed paths, on four cards")
    args = ap.parse_args(argv)
    import jax

    devices = jax.devices()
    require_gpu(devices)
    t_all = time.perf_counter()
    phase_device()
    sz = Sizes()
    phase_s = {}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        return out

    if args.four_cards:
        run("four_cards", phase_four_cards, sz)
    else:
        run("retrieval", phase_retrieval, sz)
        split = run("setup", make_corpus, sz)
        sgns = run("train", phase_train, sz, split)
        run("serve", phase_serve, sz, split, sgns)
    say("done", total_s=time.perf_counter() - t_all, phase_s=phase_s)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
