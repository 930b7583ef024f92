"""otto_tpu — a JAX session-recommender framework for the OTTO
multi-objective task (predict clicks/carts/orders per truncated session,
scored by weighted recall@20 = 0.1*click + 0.3*cart + 0.6*order).

This is a from-scratch JAX/XLA/Pallas/pjit re-design of the capabilities of the
reference Kaggle solution ``gunesevitan/otto-multi-objective-recommender-system``
(see SURVEY.md).  The reference is a pipeline of CPU/CUDA scripts over files;
this framework is a library with one engine:

- columnar event arrays + CSR session offsets instead of per-session Python loops
- every per-session heuristic (recency weights, covisitation votes, frequency
  padding) recast as batched fixed-shape segment ops that XLA tiles onto the
  accelerator's vector and matrix units
- covisitation matrices built on-device by a sort/segment-reduce engine
- fastText/word2vec/MF/CF embedding training as JAX/optax embedding tables,
  shardable row-wise across a device mesh
- Annoy ANN replaced by a fused scan-and-select top-k (a Pallas kernel through
  Triton) with exact float32 rescoring
- the LightGBM/XGBoost lambdarank rerankers replaced by data-parallel dense
  scoring towers with listwise/LambdaRank losses
- `jax.sharding.Mesh` + collectives as the scale-out story (the reference had none)

Subpackages
-----------
- ``otto_tpu.data``      ingest, event store, splits, labels, synthetic data, submissions
- ``otto_tpu.ops``       segment ops, session kernels, top-k, retrieval (Pallas)
- ``otto_tpu.models``    frequency/recency baselines, covisitation, embeddings, MF/CF,
                         TF-IDF, sequence encoder, ranker towers, ensembling
- ``otto_tpu.features``  aid / session / interaction feature engineering on device
- ``otto_tpu.parallel``  mesh construction, sharded embedding tables, collective top-k
- ``otto_tpu.eval``      recall@20 metrics and validation harnesses
- ``otto_tpu.utils``     checkpointing, profiling, PRNG seeding
"""

__version__ = "0.1.0"

# Event-type encoding, shared with the reference dataset
# (reference: src/utilities/dataset_writer_pickle.py:29-33).
CLICK, CART, ORDER = 0, 1, 2
EVENT_TYPES = ("clicks", "carts", "orders")
TYPE_WEIGHTS = (0.1, 0.3, 0.6)  # weighted recall@20 blend weights
TOP_K = 20
