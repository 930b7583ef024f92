"""Sequential session recommender — the RecBole-stack replacement
(reference: src/recbole/{dataset,trainer,inference}.py).

Two encoder architectures over the session's last ``max_len`` aids (RecBole
pads item lists to 20, recbole/inference.py:63-68), selected by
``SequenceModelConfig.architecture`` the way the reference selects RecBole
models by name (recbole/trainer.py:28-47):

- ``gru`` — GRU4Rec-style recurrent encoder (lax.scan over time).
- ``transformer`` — SASRec-style causal self-attention encoder; with L=20 the
  attention is a tiny matmul and the whole block fuses.
- ``narm`` — NARM-style attention-GRU: the GRU's hidden states feed an
  additive attention head whose context vector (local encoder) concatenates
  with the final state (global encoder) before the bilinear decode.
- ``stamp`` — STAMP short-term attention/memory-priority: additive attention
  over raw item embeddings + two one-layer MLP heads composed by elementwise
  product (no recurrence).
- ``caser`` — Caser CNN: horizontal convolutions (heights 2-4) max-pooled
  over time + a vertical position convolution, through a fully-connected
  projection.

All use tied item embeddings; the objective is sampled softmax or, for the
GRU4Rec+ configuration, BPR-max with score regularization
(``SequenceModelConfig.loss = 'bpr_max'``).
Inference is ``full_sort_predict`` semantics: encode the session, score all
items with one matmul through the exact top-k scan (recbole/inference.py:74-84
full_sort + topk), excluding the PAD position.  The 3-way serving routing
(>=20 unique aids -> recency; else model; unknown last aid -> embedding kNN
fallback, recbole/inference.py:137-148) lives in the serving pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

from otto_tpu.config import SequenceModelConfig
from otto_tpu.data.events import EventStore
from otto_tpu.logging_utils import get_logger
from otto_tpu.ops.retrieval import topk_scan

log = get_logger(__name__)


def init_params(
    key,
    n_aids: int,
    dim: int,
    hidden: int,
    architecture: str = "gru",
    max_len: int = 20,
    n_layers: int = 2,
    n_heads: int = 2,
    moe_experts: int = 0,
) -> dict:
    if architecture in ("gru", "narm"):
        k1, k2, k3, k4, k5, k6, k7 = jax.random.split(key, 7)
        scale = 0.05
        p = {
            "item_emb": jax.random.normal(k1, (n_aids + 1, dim)) * scale,  # +1 PAD row
            "gru_wx": jax.random.normal(k2, (dim, 3 * hidden)) * np.sqrt(1.0 / dim),
            "gru_wh": jax.random.normal(k3, (hidden, 3 * hidden)) * np.sqrt(1.0 / hidden),
            "gru_b": jnp.zeros((3 * hidden,)),
            "out_proj": jax.random.normal(k4, (hidden, dim)) * np.sqrt(1.0 / hidden),
        }
        if architecture == "narm":
            # additive attention over the hidden-state sequence (NARM's local
            # encoder); out_proj widens to consume [global ; local]
            p["narm_a1"] = jax.random.normal(k5, (hidden, hidden)) * np.sqrt(1.0 / hidden)
            p["narm_a2"] = jax.random.normal(k6, (hidden, hidden)) * np.sqrt(1.0 / hidden)
            p["narm_v"] = jax.random.normal(k7, (hidden,)) * np.sqrt(1.0 / hidden)
            p["out_proj"] = jax.random.normal(k4, (2 * hidden, dim)) * np.sqrt(0.5 / hidden)
        return p
    if architecture == "stamp":
        # STAMP (Liu et al., KDD'18): short-term attention/memory priority —
        # additive attention over item embeddings queried by the last item and
        # the session mean, two one-layer MLPs, trilinear decode via the
        # elementwise product of the two heads (RecBole zoo member)
        k1, k2, k3, k4, k5, k6, k7 = jax.random.split(key, 7)
        s = np.sqrt(1.0 / dim)
        return {
            "item_emb": jax.random.normal(k1, (n_aids + 1, dim)) * 0.05,
            "stamp_w1": jax.random.normal(k2, (dim, dim)) * s,
            "stamp_w2": jax.random.normal(k3, (dim, dim)) * s,
            "stamp_w3": jax.random.normal(k4, (dim, dim)) * s,
            "stamp_ba": jnp.zeros((dim,)),
            "stamp_w0": jax.random.normal(k5, (dim,)) * s,
            "stamp_ws": jax.random.normal(k6, (dim, dim)) * s,
            "stamp_bs": jnp.zeros((dim,)),
            "stamp_wt": jax.random.normal(k7, (dim, dim)) * s,
            "stamp_bt": jnp.zeros((dim,)),
        }
    if architecture == "caser":
        # Caser (Tang & Wang, WSDM'18): the session embedding matrix as an
        # L x D image — horizontal convolutions of heights 2..4 max-pooled
        # over time + a vertical convolution over positions, concatenated
        # through a fully-connected layer (CNN member of the RecBole zoo)
        heights = (2, 3, 4)
        n_h = max(8, hidden // 4)  # filters per height
        n_v = 4
        keys = jax.random.split(key, 3 + len(heights))
        p = {
            "item_emb": jax.random.normal(keys[0], (n_aids + 1, dim)) * 0.05,
            "caser_wv": jax.random.normal(keys[1], (n_v, max_len)) * np.sqrt(1.0 / max_len),
            "caser_wh": [
                jax.random.normal(keys[3 + i], (h * dim, n_h)) * np.sqrt(1.0 / (h * dim))
                for i, h in enumerate(heights)
            ],
        }
        fc_in = n_v * dim + n_h * len(heights)
        p["caser_fc"] = jax.random.normal(keys[2], (fc_in, dim)) * np.sqrt(1.0 / fc_in)
        p["caser_fb"] = jnp.zeros((dim,))
        return p
    if architecture == "transformer":
        if dim % n_heads:
            raise ValueError(f"dim={dim} not divisible by n_heads={n_heads}")
        keys = jax.random.split(key, 3 + n_layers)
        p = {
            "item_emb": jax.random.normal(keys[0], (n_aids + 1, dim)) * 0.05,
            "pos_emb": jax.random.normal(keys[1], (max_len, dim)) * 0.05,
            "out_proj": jax.random.normal(keys[2], (dim, dim)) * np.sqrt(1.0 / dim),
            "final_ln": {"scale": jnp.ones((dim,)), "bias": jnp.zeros((dim,))},
            "layers": [],
        }
        s = np.sqrt(1.0 / dim)
        hd = dim // n_heads
        for li in range(n_layers):
            lk = jax.random.split(keys[3 + li], 6)
            layer = {
                # [D, heads, head_dim] so the head count travels with the
                # array shape (params stay a pure-array pytree for optax)
                "wq": jax.random.normal(lk[0], (dim, n_heads, hd)) * s,
                "wk": jax.random.normal(lk[1], (dim, n_heads, hd)) * s,
                "wv": jax.random.normal(lk[2], (dim, n_heads, hd)) * s,
                "wo": jax.random.normal(lk[3], (dim, dim)) * s,
                "ln1": {"scale": jnp.ones((dim,)), "bias": jnp.zeros((dim,))},
                "ln2": {"scale": jnp.ones((dim,)), "bias": jnp.zeros((dim,))},
            }
            if moe_experts > 0:
                # top-1-gated MoE FFN (ops/moe.py); same 4x hidden per expert
                from otto_tpu.ops.moe import init_moe

                layer["moe"] = init_moe(lk[4], dim, 4 * dim, moe_experts)
            else:
                layer.update(
                    ffn_w1=jax.random.normal(lk[4], (dim, 4 * dim)) * s,
                    ffn_b1=jnp.zeros((4 * dim,)),
                    ffn_w2=jax.random.normal(lk[5], (4 * dim, dim)) * np.sqrt(0.25 / dim),
                    ffn_b2=jnp.zeros((dim,)),
                )
            p["layers"].append(layer)
        return p
    raise ValueError(f"unknown architecture {architecture!r}")


def _gru_cell(params, h, x):
    H = h.shape[-1]
    # r/z gates use only the first 2H columns; the candidate gate needs r
    # applied to h first, so computing the full 3H matmul would waste a third
    # of the work in the sequential scan
    gates = x @ params["gru_wx"][:, : 2 * H] + h @ params["gru_wh"][:, : 2 * H] \
        + params["gru_b"][: 2 * H]
    r = jax.nn.sigmoid(gates[..., :H])
    z = jax.nn.sigmoid(gates[..., H : 2 * H])
    n = jnp.tanh(x @ params["gru_wx"][:, 2 * H :] + (r * h) @ params["gru_wh"][:, 2 * H :]
                 + params["gru_b"][2 * H :])
    return (1 - z) * h + z * n


def _encode_gru(params, seq: jax.Array, mask: jax.Array) -> jax.Array:
    emb = params["item_emb"][seq]  # [B, L, D]
    B = seq.shape[0]
    H = params["gru_wh"].shape[0]

    def step(h, inp):
        x, m = inp
        h_new = _gru_cell(params, h, x)
        h = jnp.where(m[:, None], h_new, h)
        return h, None

    h0 = jnp.zeros((B, H))
    h, _ = jax.lax.scan(step, h0, (jnp.swapaxes(emb, 0, 1), jnp.swapaxes(mask, 0, 1)))
    return h @ params["out_proj"]


def _encode_narm(params, seq: jax.Array, mask: jax.Array) -> jax.Array:
    """NARM encoder: GRU over the session, final state = global encoder,
    additive-attention context over all hidden states = local encoder,
    ``[h_global ; c_local] @ out_proj`` = session vector.  Attention weights
    are unnormalized sigmoids (NARM's formulation), zeroed at padding."""
    emb = params["item_emb"][seq]  # [B, L, D]
    B = seq.shape[0]
    H = params["gru_wh"].shape[0]

    def step(h, inp):
        x, m = inp
        h_new = _gru_cell(params, h, x)
        h = jnp.where(m[:, None], h_new, h)
        return h, h

    h0 = jnp.zeros((B, H))
    h_last, hs = jax.lax.scan(
        step, h0, (jnp.swapaxes(emb, 0, 1), jnp.swapaxes(mask, 0, 1))
    )
    hs = jnp.swapaxes(hs, 0, 1)  # [B, L, H]
    q = h_last @ params["narm_a1"]  # [B, H]
    kk = hs @ params["narm_a2"]  # [B, L, H]
    alpha = jax.nn.sigmoid(q[:, None, :] + kk) @ params["narm_v"]  # [B, L]
    alpha = jnp.where(mask, alpha, 0.0)
    c_local = jnp.einsum("bl,blh->bh", alpha, hs)
    return jnp.concatenate([h_last, c_local], axis=1) @ params["out_proj"]


def _encode_stamp(params, seq: jax.Array, mask: jax.Array) -> jax.Array:
    """STAMP encoder: attention weights a_i = w0 . sigmoid(W1 x_i + W2 m_t +
    W3 m_s + b_a) over the session items, memory m_a = sum a_i x_i + m_s,
    session vector = tanh(W_s m_a + b_s) * tanh(W_t m_t + b_t) — the
    trilinear composition reduces to an elementwise product under the shared
    tied-embedding dot-product decode."""
    emb = params["item_emb"][seq] * mask[:, :, None]  # [B, L, D]
    cnt = jnp.maximum(jnp.sum(mask, axis=1, keepdims=True), 1)
    m_s = jnp.sum(emb, axis=1) / cnt  # [B, D] session mean
    last = jnp.maximum(jnp.sum(mask, axis=1) - 1, 0)
    m_t = jnp.take_along_axis(emb, last[:, None, None], axis=1)[:, 0]  # [B, D]
    pre = (
        emb @ params["stamp_w1"]
        + (m_t @ params["stamp_w2"])[:, None, :]
        + (m_s @ params["stamp_w3"])[:, None, :]
        + params["stamp_ba"]
    )
    alpha = jax.nn.sigmoid(pre) @ params["stamp_w0"]  # [B, L]
    alpha = jnp.where(mask, alpha, 0.0)
    m_a = jnp.einsum("bl,bld->bd", alpha, emb) + m_s
    h_s = jnp.tanh(m_a @ params["stamp_ws"] + params["stamp_bs"])
    h_t = jnp.tanh(m_t @ params["stamp_wt"] + params["stamp_bt"])
    return h_s * h_t


def _encode_caser(params, seq: jax.Array, mask: jax.Array) -> jax.Array:
    """Caser encoder.  Horizontal convolutions run as stacked-slice matmuls —
    for height h the [B, L-h+1, h*D] window tensor hits the matrix units as one
    batched matmul instead of an im2col gather; windows extending past the
    session length are zeroed before the time max-pool (activations are
    ReLU >= 0, so zeros never win over a valid window)."""
    emb = params["item_emb"][seq] * mask[:, :, None]  # [B, L, D]
    B, L, D = emb.shape
    lens = jnp.sum(mask, axis=1)  # [B]
    feats = [jnp.einsum("vl,bld->bvd", params["caser_wv"], emb).reshape(B, -1)]
    for w in params["caser_wh"]:
        h = w.shape[0] // D
        win = jnp.concatenate(
            [emb[:, j : L - h + 1 + j] for j in range(h)], axis=-1
        )  # [B, L-h+1, h*D]
        conv = jax.nn.relu(win @ w)  # [B, L-h+1, n_h]
        valid = (jnp.arange(L - h + 1)[None, :] + h) <= lens[:, None]
        conv = jnp.where(valid[:, :, None], conv, 0.0)
        feats.append(jnp.max(conv, axis=1))
    z = jnp.concatenate(feats, axis=1)
    return jax.nn.relu(z @ params["caser_fc"] + params["caser_fb"])


def _layer_norm(ln, x, eps=1e-6):
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * ln["scale"] + ln["bias"]


def transformer_block(layer, x: jax.Array, attn_ok: jax.Array) -> jax.Array:
    """One pre-LN causal self-attention + FFN block (single-device form; the
    tensor-parallel variant with head/hidden sharding lives in
    parallel/model_parallel.py).  Layers carrying a ``moe`` sub-tree use the
    top-1-gated mixture-of-experts FFN instead of the dense one."""
    B, L, D = x.shape
    h = _layer_norm(layer["ln1"], x)
    hd = layer["wq"].shape[-1]
    q = jnp.einsum("bld,dhk->blhk", h, layer["wq"])
    k = jnp.einsum("bld,dhk->blhk", h, layer["wk"])
    v = jnp.einsum("bld,dhk->blhk", h, layer["wv"])
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    logits = jnp.where(attn_ok[:, None], logits, -1e9)
    att = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, D)
    x = x + out @ layer["wo"]
    h = _layer_norm(layer["ln2"], x)
    if "moe" in layer:
        return x + _moe_ffn(layer["moe"], h, attn_ok, model_axis=None)
    return x + jax.nn.gelu(h @ layer["ffn_w1"] + layer["ffn_b1"]) @ layer["ffn_w2"] + layer["ffn_b2"]


def _moe_ffn(moe, h: jax.Array, attn_ok: jax.Array, model_axis) -> jax.Array:
    """MoE FFN over the flattened [B*L] token stream; padding positions
    (derived from the last attention row, which is exactly the key mask)
    never occupy expert capacity.  Capacity factor 2 over a uniform split."""
    from otto_tpu.ops.moe import moe_apply

    B, L, D = h.shape
    n_experts = moe["wg"].shape[1]
    tok_ok = attn_ok[:, -1, :].reshape(-1)  # [B*L] key mask
    T = B * L
    cap = min(T, max(1, -(-2 * T // n_experts)))
    out = moe_apply(moe, h.reshape(T, D), capacity=cap, model_axis=model_axis,
                    token_mask=tok_ok)
    return out.reshape(B, L, D)


def _encode_transformer(params, seq: jax.Array, mask: jax.Array) -> jax.Array:
    """SASRec-style causal encoder.  Sessions are right-padded
    (EventStore.pack keep='last'); the session vector is the hidden state at
    the last valid position.  L is small (20) so attention is one fused
    matmul per layer — no flash/ring machinery needed (SURVEY §5.7)."""
    B, L = seq.shape
    x = params["item_emb"][seq] + params["pos_emb"][None, :L]  # [B, L, D]
    x = jnp.where(mask[:, :, None], x, 0.0)
    causal = jnp.tril(jnp.ones((L, L), bool))
    attn_ok = causal[None] & mask[:, None, :]  # [B, Lq, Lk]
    for layer in params["layers"]:
        x = transformer_block(layer, x, attn_ok)
    x = _layer_norm(params["final_ln"], x)
    last = jnp.maximum(jnp.sum(mask, axis=1) - 1, 0)  # [B]
    h_last = jnp.take_along_axis(x, last[:, None, None], axis=1)[:, 0]
    return h_last @ params["out_proj"]


def encode(params, seq: jax.Array, mask: jax.Array) -> jax.Array:
    """seq: int32 [B, L] (PAD = n_aids); returns session vectors [B, dim]."""
    if "stamp_w0" in params:
        return _encode_stamp(params, seq, mask)
    if "caser_fc" in params:
        return _encode_caser(params, seq, mask)
    if "narm_v" in params:
        return _encode_narm(params, seq, mask)
    if "gru_wx" in params:
        return _encode_gru(params, seq, mask)
    return _encode_transformer(params, seq, mask)


@dataclass
class SequenceModel:
    params: dict
    config: SequenceModelConfig
    history: list = field(default_factory=list)

    def encode_sessions(self, store: EventStore, batch: int = 4096) -> np.ndarray:
        cfg = self.config
        packed = store.pack(max_len=cfg.max_len, keep="last")
        seq = np.where(packed.mask, packed.aids, cfg.n_aids).astype(np.int32)
        out = np.zeros((store.n_sessions, cfg.dim), np.float32)
        # params passed as a runtime arg: a closure-capturing lambda would be
        # re-jitted per call AND bake the full item table into the executable
        enc = jax.jit(encode)
        params = self.params
        for start in range(0, store.n_sessions, batch):
            end = min(start + batch, store.n_sessions)
            s = seq[start:end]
            m = packed.mask[start:end]
            pad = batch - (end - start)
            if pad:
                s = np.concatenate([s, np.full((pad, cfg.max_len), cfg.n_aids, np.int32)])
                m = np.concatenate([m, np.zeros((pad, cfg.max_len), bool)])
            out[start:end] = np.asarray(enc(params, jnp.asarray(s), jnp.asarray(m)))[: end - start]
        return out

    def full_sort_topk(self, store: EventStore, k: int = 20, batch: int = 4096) -> np.ndarray:
        """Top-k items for every session (recbole full_sort_predict + topk,
        PAD row excluded).

        Catalogues large enough for the blocked path
        (:func:`otto_tpu.ops.retrieval.blocked_fits`) take
        :func:`otto_tpu.ops.retrieval.topk_blocked`; smaller ones the exact
        scan.
        """
        from otto_tpu.ops.retrieval import blocked_fits, topk_blocked

        vecs = self.encode_sessions(store, batch=batch)
        items = jnp.asarray(np.asarray(self.params["item_emb"])[: self.config.n_aids])
        out = np.zeros((store.n_sessions, k), np.int32)
        use_blocked = blocked_fits(self.config.n_aids, k)
        for start in range(0, store.n_sessions, batch):
            end = min(start + batch, store.n_sessions)
            q = jnp.asarray(vecs[start:end])
            if use_blocked:
                _, i = topk_blocked(q, items, k=k, metric="dot")
            else:
                _, i = topk_scan(q, items, k=k, block=16384, metric="dot")
            out[start:end] = np.asarray(i)
        return out

    def save(self, path):
        leaves = jax.tree_util.tree_leaves(self.params)
        np.savez_compressed(path, **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)})

    @classmethod
    def load(cls, path, config: SequenceModelConfig):
        template = init_params(
            jax.random.PRNGKey(0), config.n_aids, config.dim, config.hidden,
            architecture=config.architecture, max_len=config.max_len,
            n_layers=config.n_layers, n_heads=config.n_heads,
            moe_experts=config.moe_experts,
        )
        treedef = jax.tree_util.tree_structure(template)
        z = np.load(path)
        leaves = [jnp.asarray(z[f"leaf_{i}"]) for i in range(len(z.files))]
        return cls(jax.tree_util.tree_unflatten(treedef, leaves), config)


def _training_examples(store: EventStore, max_len: int, n_aids: int):
    """(prefix sequence, next aid) pairs: one example per event with >= 1
    predecessor, prefix clipped to the last max_len events."""
    pos = store.position_in_session
    valid = pos > 0
    tgt_idx = np.flatnonzero(valid)
    n = len(tgt_idx)
    seqs = np.full((n, max_len), n_aids, np.int32)
    masks = np.zeros((n, max_len), bool)
    # vectorized prefix extraction: for each target event at flat index i with
    # in-session position p, the prefix is events [i-p, i) clipped to max_len
    p = pos[tgt_idx]
    take = np.minimum(p, max_len)
    for j in range(max_len):  # bounded by max_len (20), vectorized over n
        src = tgt_idx - take + j
        ok = j < take
        seqs[ok, j] = store.aid[src[ok]]
        masks[ok, j] = True
    targets = store.aid[tgt_idx].astype(np.int32)
    return seqs, masks, targets


def train_sequence_model(
    store: EventStore, config: SequenceModelConfig = SequenceModelConfig()
) -> SequenceModel:
    rng = np.random.default_rng(config.seed)
    key = jax.random.PRNGKey(config.seed)
    key, init_key = jax.random.split(key)
    params = init_params(
        init_key, config.n_aids, config.dim, config.hidden,
        architecture=config.architecture, max_len=config.max_len,
        n_layers=config.n_layers, n_heads=config.n_heads,
        moe_experts=config.moe_experts,
    )
    optimizer = optax.adam(config.learning_rate)
    opt_state = optimizer.init(params)

    seqs, masks, targets = _training_examples(store, config.max_len, config.n_aids)
    log.info("sequence model: %d training examples", len(targets))

    loss_name = getattr(config, "loss", "sampled_softmax")
    bpr_reg = getattr(config, "bpr_reg", 1.0)

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, seq, mask, tgt, negs):
        def loss_fn(p):
            h = encode(p, seq, mask)  # [B, D]
            pos_e = p["item_emb"][tgt]
            neg_e = p["item_emb"][negs]  # [B, Neg, D]
            pos_logit = jnp.sum(h * pos_e, axis=1)
            neg_logit = jnp.einsum("bd,bnd->bn", h, neg_e)
            if loss_name == "bpr_max":
                # GRU4Rec+ BPR-max (Hidasi & Karatzoglou 2018): negatives are
                # softmax-weighted by their own scores, plus a score
                # regularizer on the weighted negatives
                s = jax.nn.softmax(neg_logit, axis=1)
                p_win = jnp.sum(s * jax.nn.sigmoid(pos_logit[:, None] - neg_logit), axis=1)
                reg = jnp.sum(s * neg_logit**2, axis=1)
                return jnp.mean(-jnp.log(p_win + 1e-10) + bpr_reg * reg)
            # sampled softmax (one positive vs sampled negatives)
            logits = jnp.concatenate([pos_logit[:, None], neg_logit], axis=1)
            return -jnp.mean(jax.nn.log_softmax(logits, axis=1)[:, 0])

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    B = config.batch_size
    history = []
    n = len(targets)
    for epoch in range(config.epochs):
        order = rng.permutation(n)
        losses = []
        for i in range(max(n // B, 1)):
            sel = order[i * B : (i + 1) * B]
            if len(sel) < B:
                # wrap (tiling as needed) so tiny datasets still fill a batch
                reps = -(-B // max(len(sel), 1))
                sel = np.tile(sel, reps)[:B]
            negs = rng.integers(0, config.n_aids, (B, config.n_negatives)).astype(np.int32)
            params, opt_state, loss = step(
                params,
                opt_state,
                jnp.asarray(seqs[sel]),
                jnp.asarray(masks[sel]),
                jnp.asarray(targets[sel]),
                jnp.asarray(negs),
            )
            losses.append(float(loss))
        history.append({"epoch": epoch, "loss": float(np.mean(losses))})
        log.info("sequence epoch %d: loss %.4f", epoch, np.mean(losses))
    return SequenceModel(params, config, history)


def sequence_serving_predictions(
    store: EventStore,
    model: SequenceModel,
    trained_aid_mask: np.ndarray | None = None,
    ft_neighbors: np.ndarray | None = None,
    k: int = 20,
) -> dict[str, np.ndarray]:
    """3-way serving routing (recbole/inference.py:137-148):

    - >= 20 distinct aids -> typed recency weights
    - last aid seen in training -> GRU full-sort top-k
    - otherwise -> embedding-kNN fallback of the last aid
    """
    import jax.numpy as jnp

    from otto_tpu import EVENT_TYPES
    from otto_tpu.models.covisitation import session_unique_counts
    from otto_tpu.ops.sessions import recency_weighted_top_aids

    counts = session_unique_counts(store)
    last = store.last_aid()
    S = store.n_sessions
    in_vocab = (
        trained_aid_mask[last]
        if trained_aid_mask is not None
        else np.ones(S, bool)
    )

    route_recency = counts >= 20
    route_model = ~route_recency & in_vocab
    route_fallback = ~route_recency & ~in_vocab

    preds = np.full((S, k), -1, np.int32)
    if route_recency.any():
        idx = np.flatnonzero(route_recency)
        sub = store.select_sessions(idx)
        packed = sub.pack(max_len=256, keep="last")
        top, _ = recency_weighted_top_aids(
            jnp.asarray(packed.aids), jnp.asarray(packed.types), jnp.asarray(packed.mask),
            jnp.asarray(packed.lengths), jnp.asarray([1.0, 6.0, 3.0], jnp.float32),
            k=k, lo=0.1, hi=1.0,
        )
        preds[idx] = np.asarray(top)
    if route_model.any():
        idx = np.flatnonzero(route_model)
        sub = store.select_sessions(idx)
        preds[idx] = model.full_sort_topk(sub, k=k)
    if route_fallback.any() and ft_neighbors is not None:
        idx = np.flatnonzero(route_fallback)
        rows = ft_neighbors[last[idx]][:, :k]
        w = rows.shape[1]
        preds[idx, :w] = rows
    return {etype: preds.copy() for etype in EVENT_TYPES}
