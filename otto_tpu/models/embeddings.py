"""Skip-gram negative-sampling (SGNS) aid embeddings.

The accelerator replacement for the reference's fastText
(``fasttext.train_unsupervised`` skipgram, dim 32, ws 10, neg 40, loss ns —
src/gensim_fasttext/trainer.py:65 + models/fasttext/config.yaml) and gensim
Word2Vec (models/word2vec/config.yaml).  Sessions are the "sentences", aids
the "words" (src/gensim_fasttext/dataset.py:14-33); aid ids index the table
directly — no token vocabulary.

Design:
- host side: vectorized skip-gram pair generation with per-center reduced
  windows and frequent-aid subsampling (word2vec's ``t`` heuristic)
- device side: one jitted step per batch — gather rows, sigmoid BCE with
  in-step negative sampling from the unigram^0.75 distribution
  (inverse-CDF ``searchsorted`` on device), and *sparse* SGD scatter updates
  (``table.at[idx].add``) so no step ever writes the full 1.86M x d table
- linear learning-rate decay over total steps (fastText's schedule)

The trained ``embeddings`` (input vectors) feed the exact top-k retrieval in
:mod:`otto_tpu.ops.retrieval` — together they replace fastText + Annoy.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from otto_tpu.config import SGNSConfig
from otto_tpu.data.events import EventStore
from otto_tpu.logging_utils import get_logger
from otto_tpu.ops.retrieval import build_neighbor_table

log = get_logger(__name__)


def skipgram_pairs(
    store: EventStore,
    window: int,
    rng: np.random.Generator,
    subsample_t: float = 0.0,
    counts: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized skip-gram pair generation over all sessions.

    Each surviving event draws a reduced window b ~ U{1..window}; pairs are
    (center, context) for every context within b positions in the same
    session.  With ``subsample_t`` > 0, frequent aids are dropped with
    word2vec's probability 1 - (sqrt(t/f) + t/f).
    """
    aid = store.aid
    sidx = store.session_idx
    n = len(aid)

    keep = np.ones(n, dtype=bool)
    if subsample_t > 0 and counts is not None:
        freq = counts[aid] / max(counts.sum(), 1)
        p_keep = np.sqrt(subsample_t / np.maximum(freq, 1e-12)) + subsample_t / np.maximum(
            freq, 1e-12
        )
        keep = rng.random(n) < np.minimum(p_keep, 1.0)

    aid_k = aid[keep]
    sidx_k = sidx[keep]
    m = len(aid_k)
    b = rng.integers(1, window + 1, size=m)

    centers, contexts = [], []
    for d in range(1, window + 1):
        same = sidx_k[:-d] == sidx_k[d:] if d < m else np.zeros(0, bool)
        fwd = same & (b[:-d] >= d)  # context d positions ahead of center
        bwd = same & (b[d:] >= d)  # context d positions behind center
        centers.append(aid_k[:-d][fwd])
        contexts.append(aid_k[d:][fwd])
        centers.append(aid_k[d:][bwd])
        contexts.append(aid_k[:-d][bwd])
    c = np.concatenate(centers).astype(np.int32)
    x = np.concatenate(contexts).astype(np.int32)
    drop_same = c != x
    return c[drop_same], x[drop_same]


def _sgns_step_impl(w_in, w_out, acc_in, acc_out, centers, contexts, neg_cdf, lr, key,
                    n_negatives: int):
    """One SGNS step with sparse per-coordinate adagrad.

    Gradients are closed-form over the gathered rows and applied with
    scatter-adds touching only the batch's rows.  Autodiff would emit the
    same scatter for the gradient but then run the adagrad update over the
    FULL [N, D] tables — ~8 full-table HBM passes per step (at OTTO scale
    1.9 GB per 8k-pair batch); the sparse form's traffic scales with the
    batch instead (~20x less).  Duplicate rows in a batch accumulate into
    ``acc`` first and every occurrence then scales by the batch-complete
    accumulator — word2vec-style sparse adagrad (the same reason the
    reference's torch trainers use SparseAdam, torch_trainer.py:352).
    """
    B = centers.shape[0]
    u = jax.random.uniform(key, (B, n_negatives))
    negatives = jnp.searchsorted(neg_cdf, u).astype(jnp.int32)

    c_rows = w_in[centers]  # [B, D]
    pos_rows = w_out[contexts]  # [B, D]
    neg_rows = w_out[negatives]  # [B, Neg, D]
    pos_logit = jnp.sum(c_rows * pos_rows, axis=1)  # [B]
    neg_logit = jnp.einsum("bd,bnd->bn", c_rows, neg_rows)  # [B, Neg]
    loss = jnp.sum(-jax.nn.log_sigmoid(pos_logit)) + jnp.sum(
        -jax.nn.log_sigmoid(-neg_logit)
    )

    # d loss / d logit
    g_pos = jax.nn.sigmoid(pos_logit) - 1.0  # [B]
    g_neg = jax.nn.sigmoid(neg_logit)  # [B, Neg]
    # row gradients
    g_c = g_pos[:, None] * pos_rows + jnp.einsum("bn,bnd->bd", g_neg, neg_rows)
    g_ctx = g_pos[:, None] * c_rows  # [B, D]
    g_negrows = g_neg[:, :, None] * c_rows[:, None, :]  # [B, Neg, D]

    out_idx = jnp.concatenate([contexts, negatives.reshape(-1)])  # [B + B*Neg]
    g_out_rows = jnp.concatenate([g_ctx, g_negrows.reshape(-1, g_ctx.shape[1])])

    acc_in = acc_in.at[centers].add(g_c * g_c)
    acc_out = acc_out.at[out_idx].add(g_out_rows * g_out_rows)
    w_in = w_in.at[centers].add(-lr * g_c * jax.lax.rsqrt(acc_in[centers] + 1e-10))
    w_out = w_out.at[out_idx].add(
        -lr * g_out_rows * jax.lax.rsqrt(acc_out[out_idx] + 1e-10)
    )
    return w_in, w_out, acc_in, acc_out, loss / B


_sgns_step = jax.jit(_sgns_step_impl, static_argnames=("n_negatives",),
                     donate_argnums=(0, 1, 2, 3))


def build_huffman_paths(counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Huffman tree over aid frequencies → per-leaf classifier paths, for the
    hierarchical-softmax objective (the reference's word2vec trains with
    ``hs: 1`` — models/word2vec/config.yaml:14).

    Returns ``(nodes int32 [V, L], signs int8 [V, L])``: row ``v`` lists the
    inner-node ids (0..V-2) on ``v``'s root→leaf path with ``sign = 1-2*code``
    (word2vec's branch encoding); positions past the path depth pad with
    node 0 / sign 0 (masked out by sign == 0, and their gradients are exactly
    zero).  Built with the two-queue O(V) merge after one sort; path
    extraction is vectorized by climbing all leaves one level per pass.
    """
    V = len(counts)
    if V < 2:
        return np.zeros((V, 1), np.int32), np.zeros((V, 1), np.int8)
    order = np.argsort(counts, kind="stable")
    leaf_w = np.asarray(counts, np.float64)[order]
    n_inner = V - 1
    inner_w = np.zeros(n_inner, np.float64)
    parent = np.full(V + n_inner, -1, np.int64)  # leaves: original ids; inner: V+i
    code = np.zeros(V + n_inner, np.int8)
    li = ii = 0
    for k in range(n_inner):  # two-queue merge: both queues stay sorted
        for j in range(2):
            take_leaf = li < V and (ii >= k or leaf_w[li] <= inner_w[ii])
            if take_leaf:
                node_id, w = order[li], leaf_w[li]
                li += 1
            else:
                node_id, w = V + ii, inner_w[ii]
                ii += 1
            parent[node_id] = V + k
            code[node_id] = j
            inner_w[k] += w
    root = V + n_inner - 1
    # climb all leaves level-by-level; step i records (classifier, branch)
    steps = []
    cur = np.arange(V, dtype=np.int64)
    active = cur != root
    while active.any():
        p = np.where(active, parent[cur], cur)
        steps.append((p, code[cur], active))
        cur = p
        active = cur != root
    nodes = np.zeros((V, len(steps)), np.int32)
    signs = np.zeros((V, len(steps)), np.int8)
    for i, (p, c, a) in enumerate(steps):
        idx = np.flatnonzero(a)
        nodes[idx, i] = (p[idx] - V).astype(np.int32)
        signs[idx, i] = 1 - 2 * c[idx]
    return nodes, signs


def _hs_step_impl(w_in, w_node, acc_in, acc_node, centers, path_nodes,
                  path_signs, lr):
    """One hierarchical-softmax step with the same sparse adagrad as SGNS.

    ``path_nodes/path_signs`` [B, L] are the context word's Huffman path
    (host-gathered); loss = Σ -log σ(sign · h·w_node) over valid positions.
    Pad positions (sign 0) contribute exactly zero gradient and scatter a
    zero row into node 0.
    """
    h = w_in[centers]  # [B, D]
    rows = w_node[path_nodes]  # [B, L, D]
    sgn = path_signs.astype(jnp.float32)
    logit = jnp.einsum("bd,bld->bl", h, rows)
    t = sgn * logit
    valid = sgn != 0
    loss = jnp.sum(jnp.where(valid, -jax.nn.log_sigmoid(t), 0.0))
    g_logit = jnp.where(valid, sgn * (jax.nn.sigmoid(t) - 1.0), 0.0)  # [B, L]
    g_c = jnp.einsum("bl,bld->bd", g_logit, rows)
    g_rows = (g_logit[:, :, None] * h[:, None, :]).reshape(-1, h.shape[1])
    node_idx = path_nodes.reshape(-1)
    acc_in = acc_in.at[centers].add(g_c * g_c)
    acc_node = acc_node.at[node_idx].add(g_rows * g_rows)
    w_in = w_in.at[centers].add(-lr * g_c * jax.lax.rsqrt(acc_in[centers] + 1e-10))
    w_node = w_node.at[node_idx].add(
        -lr * g_rows * jax.lax.rsqrt(acc_node[node_idx] + 1e-10)
    )
    return w_in, w_node, acc_in, acc_node, loss / centers.shape[0]


@partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def _hs_multi_step(w_in, w_node, acc_in, acc_node, centers, path_nodes,
                   path_signs, lrs):
    """G sequential hierarchical-softmax steps in one device program
    (the hs analog of :func:`_sgns_multi_step`).  centers [G, B];
    path_nodes/path_signs [G, B, L]; lrs [G]."""

    def body(carry, inp):
        w_in, w_node, acc_in, acc_node = carry
        bc, bn, bs, lr = inp
        w_in, w_node, acc_in, acc_node, loss = _hs_step_impl(
            w_in, w_node, acc_in, acc_node, bc, bn, bs, lr
        )
        return (w_in, w_node, acc_in, acc_node), loss

    (w_in, w_node, acc_in, acc_node), losses = jax.lax.scan(
        body, (w_in, w_node, acc_in, acc_node), (centers, path_nodes, path_signs, lrs)
    )
    return w_in, w_node, acc_in, acc_node, jnp.mean(losses)


@partial(jax.jit, static_argnames=("n_negatives",), donate_argnums=(0, 1, 2, 3))
def _sgns_multi_step(w_in, w_out, acc_in, acc_out, centers, contexts, neg_cdf,
                     lrs, key, n_negatives: int):
    """``lax.scan`` of G sequential SGNS steps in ONE device program.

    centers/contexts: int32 [G, B]; lrs: float32 [G].  The per-step math is
    identical to :func:`_sgns_step`; batching G steps per dispatch amortizes
    per-program dispatch latency (the dominant cost of small sparse steps on
    a remote-attached device, and still a win on local chips) and ships the
    G batches as one host->device transfer.  Returns the mean loss over the
    G steps.
    """

    def body(carry, inp):
        w_in, w_out, acc_in, acc_out, key = carry
        bc, bx, lr = inp
        key, sub = jax.random.split(key)
        w_in, w_out, acc_in, acc_out, loss = _sgns_step_impl(
            w_in, w_out, acc_in, acc_out, bc, bx, neg_cdf, lr, sub, n_negatives
        )
        return (w_in, w_out, acc_in, acc_out, key), loss

    (w_in, w_out, acc_in, acc_out, key), losses = jax.lax.scan(
        body, (w_in, w_out, acc_in, acc_out, key), (centers, contexts, lrs)
    )
    return w_in, w_out, acc_in, acc_out, key, jnp.mean(losses)


def _sgns_weighted_step(w_in, w_out, acc_in, acc_out, centers, contexts,
                        weight, neg_cdf, lr, key, n_negatives: int):
    """SGNS step with a per-pair weight column (0 = rejected sample).

    Identical math to :func:`_sgns_step_impl` with every pair's loss and
    gradient scaled by ``weight`` — the masked form the device-resident pair
    sampler needs (rejected draws carry weight 0 and scatter zero rows)."""
    B = centers.shape[0]
    u = jax.random.uniform(key, (B, n_negatives))
    negatives = jnp.searchsorted(neg_cdf, u).astype(jnp.int32)

    c_rows = w_in[centers]
    pos_rows = w_out[contexts]
    neg_rows = w_out[negatives]
    pos_logit = jnp.sum(c_rows * pos_rows, axis=1)
    neg_logit = jnp.einsum("bd,bnd->bn", c_rows, neg_rows)
    loss = jnp.sum(weight * (-jax.nn.log_sigmoid(pos_logit))) + jnp.sum(
        weight[:, None] * (-jax.nn.log_sigmoid(-neg_logit))
    )

    g_pos = weight * (jax.nn.sigmoid(pos_logit) - 1.0)
    g_neg = weight[:, None] * jax.nn.sigmoid(neg_logit)
    g_c = g_pos[:, None] * pos_rows + jnp.einsum("bn,bnd->bd", g_neg, neg_rows)
    g_ctx = g_pos[:, None] * c_rows
    g_negrows = g_neg[:, :, None] * c_rows[:, None, :]

    out_idx = jnp.concatenate([contexts, negatives.reshape(-1)])
    g_out_rows = jnp.concatenate([g_ctx, g_negrows.reshape(-1, g_ctx.shape[1])])

    acc_in = acc_in.at[centers].add(g_c * g_c)
    acc_out = acc_out.at[out_idx].add(g_out_rows * g_out_rows)
    w_in = w_in.at[centers].add(-lr * g_c * jax.lax.rsqrt(acc_in[centers] + 1e-10))
    w_out = w_out.at[out_idx].add(
        -lr * g_out_rows * jax.lax.rsqrt(acc_out[out_idx] + 1e-10)
    )
    return w_in, w_out, acc_in, acc_out, loss / jnp.maximum(jnp.sum(weight), 1.0)


def _sgns_shared_neg_step(w_in, w_out, acc_in, acc_out, centers, contexts,
                          weight, neg_cdf, lr, key, n_negatives: int,
                          n_shared: int):
    """SGNS step with a SHARED negative set — the matmul formulation.

    The per-pair-negatives step gathers and scatter-adds B x (1 + neg) rows;
    at neg 40 the scatter dominates.  Here
    ``n_shared`` negatives are drawn once per STEP and every pair scores
    against all of them through one [B, D] x [D, Nn] matmul; negative-row
    gradients reduce over the batch with the transposed matmul and scatter
    only Nn rows.  The negative term is scaled by ``n_negatives / n_shared``
    so gradient magnitudes match the per-pair objective in expectation —
    negative sharing is the standard accelerator formulation of word2vec's
    ns loss (each pair still sees negatives drawn from the same
    unigram^0.75 distribution, just shared across the batch).
    """
    u = jax.random.uniform(key, (n_shared,))
    negatives = jnp.searchsorted(neg_cdf, u).astype(jnp.int32)
    scale = jnp.float32(n_negatives / n_shared)

    c_rows = w_in[centers]  # [B, D]
    pos_rows = w_out[contexts]  # [B, D]
    neg_rows = w_out[negatives]  # [Nn, D]
    pos_logit = jnp.sum(c_rows * pos_rows, axis=1)  # [B]
    neg_logit = jnp.dot(c_rows, neg_rows.T,
                        preferred_element_type=jnp.float32)  # [B, Nn]
    loss = jnp.sum(weight * (-jax.nn.log_sigmoid(pos_logit))) + scale * jnp.sum(
        weight[:, None] * (-jax.nn.log_sigmoid(-neg_logit))
    )

    g_pos = weight * (jax.nn.sigmoid(pos_logit) - 1.0)  # [B]
    g_neg = scale * weight[:, None] * jax.nn.sigmoid(neg_logit)  # [B, Nn]
    g_c = g_pos[:, None] * pos_rows + jnp.dot(
        g_neg, neg_rows, preferred_element_type=jnp.float32)  # [B, D]
    g_ctx = g_pos[:, None] * c_rows  # [B, D]
    g_negrows = jnp.dot(g_neg.T, c_rows,
                        preferred_element_type=jnp.float32)  # [Nn, D]

    acc_in = acc_in.at[centers].add(g_c * g_c)
    acc_out = acc_out.at[contexts].add(g_ctx * g_ctx)
    acc_out = acc_out.at[negatives].add(g_negrows * g_negrows)
    w_in = w_in.at[centers].add(-lr * g_c * jax.lax.rsqrt(acc_in[centers] + 1e-10))
    w_out = w_out.at[contexts].add(
        -lr * g_ctx * jax.lax.rsqrt(acc_out[contexts] + 1e-10))
    w_out = w_out.at[negatives].add(
        -lr * g_negrows * jax.lax.rsqrt(acc_out[negatives] + 1e-10))
    return w_in, w_out, acc_in, acc_out, loss / jnp.maximum(jnp.sum(weight), 1.0)


@partial(jax.jit,
         static_argnames=("n_steps", "batch", "window", "n_negatives",
                          "n_shared"),
         donate_argnums=(0, 1, 2, 3))
def _sgns_device_chunk(w_in, w_out, acc_in, acc_out, aid_k, sidx_k, m,
                       neg_cdf, lrs, key, *, n_steps: int, batch: int,
                       window: int, n_negatives: int, n_shared: int = 0):
    """``n_steps`` SGNS steps with pairs SAMPLED ON DEVICE — zero per-step
    host traffic (the host-paired path ships 8 bytes/pair to the device).

    ``aid_k``/``sidx_k`` are the subsampled+compacted event stream (resident;
    padded to a fixed length, ``m`` = live prefix).  Each step draws ``batch``
    (event, offset, direction) triples and keeps draws whose context lies in
    the same session within a per-draw reduced window ``b ~ U{1..window}`` —
    the same marginal pair distribution as :func:`skipgram_pairs` (each valid
    (center, context) at distance d is produced w.p. proportional to
    P(b >= d) = (window-d+1)/window); rejected draws carry weight 0.
    I.i.d. sampling replaces the host path's epoch-exact enumeration — the
    stochastic-equivalence word2vec itself relies on.
    """
    n_pad = aid_k.shape[0]

    def body(carry, inp):
        w_in, w_out, acc_in, acc_out, key = carry
        lr = inp
        key, k_e, k_d, k_dir, k_neg = jax.random.split(key, 5)
        u = jax.random.uniform(k_e, (batch,))
        e = jnp.minimum((u * m).astype(jnp.int32), m - 1)
        d = jax.random.randint(k_d, (batch,), 1, window + 1)
        sign = jnp.where(jax.random.bernoulli(k_dir, 0.5, (batch,)), 1, -1)
        # the reduced-window acceptance: an i.i.d. b ~ U{1..window} per draw
        b = jax.random.randint(jax.random.fold_in(k_d, 1), (batch,), 1, window + 1)
        ctx_e = e + sign * d
        in_range = (ctx_e >= 0) & (ctx_e < m)
        ctx_e = jnp.clip(ctx_e, 0, n_pad - 1)
        ok = in_range & (b >= d) & (sidx_k[e] == sidx_k[ctx_e])
        centers = aid_k[e]
        contexts = aid_k[ctx_e]
        ok = ok & (centers != contexts)
        w = ok.astype(jnp.float32)
        # rejected draws point at row 0 with weight 0 (zero gradient rows)
        centers = jnp.where(ok, centers, 0)
        contexts = jnp.where(ok, contexts, 0)
        if n_shared:
            w_in, w_out, acc_in, acc_out, loss = _sgns_shared_neg_step(
                w_in, w_out, acc_in, acc_out, centers, contexts, w,
                neg_cdf, lr, k_neg, n_negatives, n_shared)
        else:
            w_in, w_out, acc_in, acc_out, loss = _sgns_weighted_step(
                w_in, w_out, acc_in, acc_out, centers, contexts, w,
                neg_cdf, lr, k_neg, n_negatives)
        return (w_in, w_out, acc_in, acc_out, key), (loss, jnp.sum(w))

    (w_in, w_out, acc_in, acc_out, key), (losses, kept) = jax.lax.scan(
        body, (w_in, w_out, acc_in, acc_out, key), lrs, length=n_steps)
    return w_in, w_out, acc_in, acc_out, key, jnp.mean(losses), jnp.sum(kept)


def train_sgns_device(
    store: EventStore,
    n_aids: int,
    config: SGNSConfig = SGNSConfig(),
    steps_per_dispatch: int = 512,
    pairs_out: dict | None = None,
    shared_negatives: int | None = None,
    max_steps_per_epoch: int = 0,
    progress_every: int = 0,
) -> SGNSModel:
    """Device-resident SGNS training: the event stream goes to the device
    once per epoch (~8 bytes/event) and every pair is sampled there.

    Trains the reference fastText configuration (dim 32, ws 10, neg 40,
    5 epochs — models/fasttext/config.yaml:3-19) at device-limited
    throughput.  ``pairs_out`` receives {"pairs_trained", "train_s",
    "pairs_per_s"} accounting.

    ``shared_negatives`` switches the loss to the shared-negative matmul
    formulation (see :func:`_sgns_shared_neg_step`); ``None`` defaults to
    ``max(batch // 8, n_negatives)`` when ``config.negatives >= 16`` (the
    per-pair scatter dominates there) and 0 (per-pair negatives, exact
    word2vec objective) otherwise.

    ``max_steps_per_epoch`` caps the measured epoch at a whole number of
    dispatches (a full-corpus measurement run on a wall-clock budget); the
    uncapped step count is recorded in ``epoch_log`` so the capped run's
    per-component costs extrapolate without guessing.  ``progress_every``
    forces the running loss every that many dispatches (a ~4-byte fetch —
    visible pacing in long runs).
    """
    import time as _time

    rng = np.random.default_rng(config.seed)
    key = jax.random.PRNGKey(config.seed)

    counts = np.bincount(store.aid, minlength=n_aids).astype(np.float64)
    p = counts**config.ns_exponent
    p /= p.sum()
    neg_cdf = jnp.asarray(np.cumsum(p), jnp.float32)

    d = config.dim
    scale = 1.0 / d
    w_in = jnp.asarray(rng.uniform(-scale, scale, size=(n_aids, d)).astype(np.float32))
    w_out = jnp.zeros((n_aids, d), jnp.float32)
    acc_in = jnp.zeros((n_aids, d), jnp.float32)
    acc_out = jnp.zeros((n_aids, d), jnp.float32)

    B = config.batch_centers
    if shared_negatives is None:
        shared_negatives = (max(B // 8, config.negatives)
                            if config.negatives >= 16 else 0)
    n = store.n_events
    freq = counts[store.aid] / max(counts.sum(), 1)
    # expected pairs per epoch matches the host generator's count: each
    # surviving adjacent (center, context) pair at distance d survives the
    # reduced window w.p. (window-d+1)/window => ~window/2 + 1/2 per side
    t0_all = _time.time()
    total_pairs = 0
    n_steps_total = None
    step = 0
    epoch_log: list[dict] = []
    min_ratio = config.min_learning_rate / config.learning_rate
    for epoch in range(config.epochs):
        # per-epoch host-side cost, measured separately (VERDICT r4 item 6:
        # the subsample/compact/upload at 220M events was untested): the
        # subsample+compact is host numpy, the upload moves ~8 B/event
        t_h = _time.time()
        if config.subsample_t > 0:
            p_keep = (np.sqrt(config.subsample_t / np.maximum(freq, 1e-12))
                      + config.subsample_t / np.maximum(freq, 1e-12))
            keep = rng.random(n) < np.minimum(p_keep, 1.0)
        else:
            keep = np.ones(n, bool)
        aid_k = store.aid[keep].astype(np.int32)
        sidx_k = store.session_idx[keep].astype(np.int32)
        m = len(aid_k)
        # fixed padded shape across epochs -> one compile
        aid_pad = np.zeros(n, np.int32)
        sidx_pad = np.full(n, -1, np.int32)
        aid_pad[:m] = aid_k
        sidx_pad[:m] = sidx_k
        host_prep_s = _time.time() - t_h
        t_u = _time.time()
        aid_dev = jnp.asarray(aid_pad)
        sidx_dev = jnp.asarray(sidx_pad)
        # force materialization on device before starting the step clock
        _ = np.asarray(aid_dev[:1]), np.asarray(sidx_dev[:1])
        upload_s = _time.time() - t_u
        if n_steps_total is None:
            # the host generator emits ~2*m*w*acc pairs per epoch (each of m
            # events, both directions, w offsets, acceptance acc = mean over
            # d of P(b>=d)*P(same session)); a device draw accepts with the
            # SAME probability acc, so matching the host epoch count takes
            # 2*m*w draws per epoch
            w_ = config.window
            draws_per_epoch = 2 * m * w_
            n_steps_epoch = max(-(-draws_per_epoch // B), 1)
            # every dispatch runs exactly steps_per_dispatch scanned steps
            # (one compiled shape); round the epoch up to a whole dispatch
            n_steps_epoch = -(-n_steps_epoch // steps_per_dispatch) * steps_per_dispatch
            n_steps_epoch_full = n_steps_epoch
            if max_steps_per_epoch:
                n_steps_epoch = min(
                    n_steps_epoch,
                    max(-(-max_steps_per_epoch // steps_per_dispatch), 1)
                    * steps_per_dispatch)
            n_steps_total = n_steps_epoch * config.epochs
        losses, kepts = [], []
        t_ep = _time.time()
        for s0 in range(0, n_steps_epoch, steps_per_dispatch):
            lrs = config.learning_rate * np.maximum(
                1.0 - (step + np.arange(steps_per_dispatch)) / max(n_steps_total, 1),
                min_ratio).astype(np.float32)
            w_in, w_out, acc_in, acc_out, key, loss, kept = _sgns_device_chunk(
                w_in, w_out, acc_in, acc_out, aid_dev, sidx_dev,
                jnp.int32(m), neg_cdf, jnp.asarray(lrs), key,
                n_steps=steps_per_dispatch, batch=B, window=config.window,
                n_negatives=config.negatives, n_shared=shared_negatives)
            step += min(steps_per_dispatch, n_steps_epoch - s0)
            losses.append(loss)
            kepts.append(kept)  # device scalars; forced once per epoch
            if progress_every and ((s0 // steps_per_dispatch) + 1) % progress_every == 0:
                done = s0 + steps_per_dispatch
                el = _time.time() - t_ep
                log.info("sgns-device epoch %d: %d/%d steps, %.0fk draws/s, "
                         "loss %.4f (%.0fs)", epoch + 1, done, n_steps_epoch,
                         done * B / max(el, 1e-9) / 1e3,
                         float(np.asarray(loss)), el)
        ep_loss = float(np.asarray(losses[-1])) if losses else float("nan")
        ep_kept = int(sum(float(np.asarray(k)) for k in kepts))
        total_pairs += ep_kept
        total_draws = len(kepts) * steps_per_dispatch * B
        epoch_log.append({
            "host_prep_s": round(host_prep_s, 1),
            "upload_s": round(upload_s, 1),
            "upload_mb": round((aid_pad.nbytes + sidx_pad.nbytes) / 1e6, 1),
            "kept_events": int(m),
            "pairs": int(ep_kept),
            "loss": round(ep_loss, 4),
            "steps_run": int(n_steps_epoch),
            "steps_full_epoch": int(n_steps_epoch_full),
            "step_s": round(_time.time() - t_ep, 1),
        })
        log.info("sgns-device epoch %d/%d: %d pairs (%d steps, accept %.2f), "
                 "loss %.4f (host prep %.1fs, upload %.1fs)",
                 epoch + 1, config.epochs, ep_kept,
                 n_steps_epoch, ep_kept / max(total_draws, 1), ep_loss,
                 host_prep_s, upload_s)
    train_s = _time.time() - t0_all
    if pairs_out is not None:
        pairs_out.update({
            "pairs_trained": int(total_pairs),
            "train_s": round(train_s, 1),
            "pairs_per_s": round(total_pairs / max(train_s, 1e-9), 0),
            "shared_negatives": int(shared_negatives),
            "epoch_log": epoch_log,
        })
    log.info("sgns-device: %d pairs in %.1fs (%.0f pairs/s)",
             total_pairs, train_s, total_pairs / max(train_s, 1e-9))
    return SGNSModel(np.asarray(w_in), np.asarray(w_out),
                     counts.astype(np.float32), config)


@dataclass
class SGNSModel:
    w_in: np.ndarray  # [n_aids, d] — the "word vectors"
    w_out: np.ndarray
    counts: np.ndarray
    config: SGNSConfig

    @property
    def embeddings(self) -> np.ndarray:
        return self.w_in

    def neighbor_table(self, k: int, metric: str = "euclidean", **kw):
        return build_neighbor_table(self.w_in, k=k, metric=metric, **kw)

    def save(self, path) -> None:
        np.savez_compressed(path, w_in=self.w_in, w_out=self.w_out, counts=self.counts)

    @classmethod
    def load(cls, path, config: SGNSConfig = SGNSConfig()) -> "SGNSModel":
        z = np.load(path)
        return cls(z["w_in"], z["w_out"], z["counts"], config)


def train_sgns(
    store: EventStore,
    n_aids: int,
    config: SGNSConfig = SGNSConfig(),
    log_every: int = 200,
    checkpoint_dir: str | None = None,
    stop_after_epochs: int | None = None,
) -> SGNSModel:
    """Train; with ``checkpoint_dir`` the full state (tables + adagrad
    accumulators) is checkpointed per epoch and training resumes from the
    latest epoch after a crash (SURVEY §5.3/5.4 — the reference restarts
    from scratch)."""
    rng = np.random.default_rng(config.seed)
    key = jax.random.PRNGKey(config.seed)

    counts = np.bincount(store.aid, minlength=n_aids).astype(np.float64)
    # unigram^0.75 negative-sampling distribution (word2vec ns_exponent)
    p = counts**config.ns_exponent
    p /= p.sum()
    neg_cdf = jnp.asarray(np.cumsum(p), jnp.float32)

    d = config.dim
    scale = 1.0 / d
    use_hs = config.objective == "hs"
    hs_nodes = hs_signs = None
    n_out = n_aids
    if use_hs:  # output table holds the V-1 Huffman inner nodes
        hs_nodes, hs_signs = build_huffman_paths(counts)
        n_out = max(n_aids - 1, 1)
        log.info("sgns: hierarchical softmax, max path depth %d", hs_nodes.shape[1])
    w_in = jnp.asarray(rng.uniform(-scale, scale, size=(n_aids, d)).astype(np.float32))
    w_out = jnp.zeros((n_out, d), jnp.float32)
    acc_in = jnp.zeros((n_aids, d), jnp.float32)
    acc_out = jnp.zeros((n_out, d), jnp.float32)

    mgr = None
    start_epoch = 0
    if checkpoint_dir is not None:
        from otto_tpu.utils.checkpoint import CheckpointManager

        mgr = CheckpointManager(checkpoint_dir, max_to_keep=2)
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest)
            w_in = jnp.asarray(state["w_in"])
            w_out = jnp.asarray(state["w_out"])
            acc_in = jnp.asarray(state["acc_in"])
            acc_out = jnp.asarray(state["acc_out"])
            key = jnp.asarray(state["key"])
            start_epoch = latest
            log.info("sgns: resumed from epoch %d", start_epoch)

    # pre-generate one epoch of pairs to size the lr schedule
    total_steps = None
    B = config.batch_centers
    G = max(config.steps_per_call, 1)
    step = 0

    def epoch_groups(n_pairs: int) -> int:
        # must equal len(BatchLoader(..., G*B, drop_remainder=False)): the
        # lr schedule, loss logging, and crash-resume replay all count on it
        return -(-n_pairs // (G * B)) if n_pairs else 0

    if start_epoch:
        # replay the host RNG so pair sampling continues deterministically,
        # and advance the lr-schedule step counter
        for _ in range(start_epoch):
            c, _x = skipgram_pairs(store, config.window, rng,
                                   subsample_t=config.subsample_t, counts=counts)
            rng.permutation(len(c))
            ng = epoch_groups(len(c))
            if total_steps is None:
                total_steps = ng * G * config.epochs
            step += ng * G
    min_ratio = config.min_learning_rate / config.learning_rate
    for epoch in range(start_epoch, config.epochs):
        c, x = skipgram_pairs(
            store, config.window, rng, subsample_t=config.subsample_t, counts=counts
        )
        perm = rng.permutation(len(c))
        n_groups = epoch_groups(len(c))
        if total_steps is None:
            total_steps = n_groups * G * config.epochs
        losses = []
        # prefetching loader (data/loader.py) ships G optimizer batches per
        # dispatch; _sgns_multi_step scans the G steps in one device program
        # (short tails wrap so every group has one compiled shape)
        from otto_tpu.data.loader import BatchLoader

        loader = BatchLoader((c, x), G * B, order=perm, drop_remainder=False)
        for i, (gc, gx) in enumerate(loader):
            lrs = config.learning_rate * np.maximum(
                1.0 - (step + np.arange(G)) / max(total_steps, 1), min_ratio
            ).astype(np.float32)
            if use_hs:
                gx_np = np.asarray(gx)
                w_in, w_out, acc_in, acc_out, loss = _hs_multi_step(
                    w_in, w_out, acc_in, acc_out,
                    gc.reshape(G, B),
                    jnp.asarray(hs_nodes[gx_np].reshape(G, B, -1)),
                    jnp.asarray(hs_signs[gx_np].reshape(G, B, -1)),
                    jnp.asarray(lrs),
                )
            else:
                w_in, w_out, acc_in, acc_out, key, loss = _sgns_multi_step(
                    w_in, w_out, acc_in, acc_out,
                    gc.reshape(G, B), gx.reshape(G, B),
                    neg_cdf, jnp.asarray(lrs), key, config.negatives,
                )
            step += G
            if (i + 1) % max(log_every // G, 1) == 0 or i == n_groups - 1:
                losses.append(loss)  # device scalar; forced at epoch end
        log.info(
            "sgns epoch %d/%d: %d pairs, loss %.4f",
            epoch + 1, config.epochs, len(c),
            float(np.mean([float(l) for l in losses])) if losses else float("nan"),
        )
        if mgr is not None:
            mgr.save(epoch + 1, {
                "w_in": np.asarray(w_in), "w_out": np.asarray(w_out),
                "acc_in": np.asarray(acc_in), "acc_out": np.asarray(acc_out),
                "key": np.asarray(key),
            })
        if stop_after_epochs is not None and (epoch + 1 - start_epoch) >= stop_after_epochs:
            log.info("sgns: stopping after %d epochs this run", stop_after_epochs)
            break
    if mgr is not None:
        mgr.close()
    return SGNSModel(np.asarray(w_in), np.asarray(w_out), counts.astype(np.float32), config)


# ---------------------------------------------------------------------------
# Serving: the embedding-kNN recommender (reference:
# src/gensim_fasttext/inference.py:80-160).  Sessions with >= 20 distinct
# aids get typed recency-weight scores (coefficients {1,6,3}, exponents
# 0.1..1); the rest get their ascending-unique session aids padded with kNN
# neighbors of the last aid.  ``recursive_nns`` (config nns.recursive_nns)
# walks the neighbor graph instead of taking one row.
# ---------------------------------------------------------------------------

from otto_tpu import EVENT_TYPES, TOP_K


def recursive_neighbors(table: np.ndarray, start_aid: int, n: int,
                        exclude: set[int]) -> list[int]:
    """Greedy neighbor-graph walk: repeatedly append the nearest unseen
    neighbor of the current aid (gensim_fasttext/inference.py:124-141)."""
    out: list[int] = []
    current = start_aid
    seen = set(exclude)
    seen.add(start_aid)  # the query aid itself is never a neighbor
    for _ in range(n):
        advanced = False
        for cand in table[current]:
            cand = int(cand)
            if cand < 0 or cand in seen or cand in out:
                continue
            out.append(cand)
            seen.add(cand)
            current = cand
            advanced = True
            break
        if not advanced:
            break
    return out


def embedding_knn_predictions(
    store,
    neighbor_table: np.ndarray,
    k: int = TOP_K,
    recursive: bool = False,
) -> dict[str, np.ndarray]:
    """Full serving path of the embedding model over an EventStore."""
    import jax.numpy as jnp

    from otto_tpu.models.covisitation import session_unique_counts
    from otto_tpu.ops.sessions import recency_weighted_top_aids

    counts = session_unique_counts(store)
    S = store.n_sessions
    preds = np.full((S, k), -1, np.int32)

    rec_idx = np.flatnonzero(counts >= 20)
    knn_idx = np.flatnonzero(counts < 20)

    if len(rec_idx):
        sub = store.select_sessions(rec_idx)
        packed = sub.pack(max_len=256, keep="last")
        top, _ = recency_weighted_top_aids(
            jnp.asarray(packed.aids), jnp.asarray(packed.types), jnp.asarray(packed.mask),
            jnp.asarray(packed.lengths), jnp.asarray([1.0, 6.0, 3.0], jnp.float32),
            k=k, lo=0.1, hi=1.0,
        )
        preds[rec_idx] = np.asarray(top)

    if len(knn_idx):
        last = store.last_aid()
        for s in knn_idx:
            lo, hi = store.offsets[s], store.offsets[s + 1]
            uniq = np.unique(store.aid[lo:hi]).tolist()  # ascending, reference :86
            if recursive:
                nns = recursive_neighbors(
                    neighbor_table, int(last[s]), k - len(uniq), set(uniq)
                )
            else:
                # no dedup against the session aids here — parity with the
                # reference, whose non-recursive branch concatenates raw kNN
                # rows (gensim_fasttext/inference.py:143-155:
                # `predictions = session_unique_aids + nearest_neighbors`);
                # only the recursive walk excludes them (:127-140)
                nns = [int(a) for a in neighbor_table[int(last[s])] if a >= 0]
            row = (uniq + nns)[:k]
            preds[s, : len(row)] = row
    return {etype: preds for etype in EVENT_TYPES}


# ---------------------------------------------------------------------------
# Doc2Vec analog: dense session vectors pooled from the trained item table
# (the reference trains gensim Doc2Vec session embeddings as one of its three
# gensim_fasttext trainer modes, src/gensim_fasttext/trainer.py:41-59).
# Instead of a separately-trained document table, session vectors are
# recency-weighted means of SGNS item embeddings — one segment-sum — and
# similar sessions come from the same exact top-k scan that replaces
# Annoy.
# ---------------------------------------------------------------------------


def session_embeddings(
    store, item_emb: np.ndarray, weighting: str = "recency"
) -> np.ndarray:
    """L2-normalized pooled session vectors [S, d].

    weighting='recency' uses the reference's logspace(0.1, 1, base 2) - 1
    recency profile per session; 'mean' is uniform."""
    S = store.n_sessions
    d = item_emb.shape[1]
    lengths = store.lengths.astype(np.float64)
    pos = store.position_in_session.astype(np.float64)
    if weighting == "recency":
        n = lengths[store.session_idx]
        lo, hi = 0.1, 1.0
        expo = np.where(n > 1, lo + (hi - lo) * pos / np.maximum(n - 1, 1), hi)
        w = (np.power(2.0, expo) - 1.0).astype(np.float32)
    elif weighting == "mean":
        w = np.ones(store.n_events, np.float32)
    else:
        raise ValueError(weighting)
    vec = np.zeros((S, d), np.float32)
    np.add.at(vec, store.session_idx, item_emb[store.aid] * w[:, None])
    norms = np.linalg.norm(vec, axis=1, keepdims=True)
    return vec / np.maximum(norms, 1e-9)


@dataclass
class SessionEmbeddingModel:
    """Similar-session recommender over pooled session vectors (Doc2Vec
    analog; retrieval mirrors src/tfidf/inference.py:83-96's
    similar-session aid gathering)."""

    vectors: np.ndarray  # [S_corpus, d] normalized
    corpus: object  # EventStore
    item_emb: np.ndarray
    weighting: str = "recency"

    @classmethod
    def fit(cls, corpus, item_emb: np.ndarray, weighting: str = "recency"):
        return cls(session_embeddings(corpus, item_emb, weighting), corpus,
                   item_emb, weighting)

    def similar_session_predictions(
        self, queries, n_similar: int = 5, k: int = TOP_K, query_batch: int = 4096
    ) -> dict[str, np.ndarray]:
        from otto_tpu.models.tfidf import retrieve_similar_session_aids

        qv = session_embeddings(queries, self.item_emb, self.weighting)
        preds = retrieve_similar_session_aids(
            qv, self.vectors, self.corpus, n_similar=n_similar, k=k,
            query_batch=query_batch,
        )
        return {etype: preds for etype in EVENT_TYPES}
