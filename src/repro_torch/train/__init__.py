"""Training substrate: optimizer, data, checkpointing, train step.

The port of ``repro.train``.

* ``optimizer``  — AdamW (fp32 master + moments) and Adafactor
  (factored), global-norm clipping, warmup + cosine schedule.
* ``data``       — the deterministic synthetic stream and its prefetcher.
* ``checkpoint`` — atomic checkpoints in the reference's on-disk format.
* ``train_step`` — the train state, its sharding specs, and the step
  (fp32 gradient accumulation over microbatches, then one update).
* ``tree``       — the reference's pytree layout of nested dicts and
  lists, which the optimizer state and checkpoints keep.
"""
