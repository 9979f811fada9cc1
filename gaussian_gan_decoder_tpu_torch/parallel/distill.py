"""The batched-view distillation step — port of parallel/distill.py
(make_parallel_train_step), on one card.

B views a step, each with its own latent and target draws; the loss is the
mean of the per-view losses and the metrics are their means; then one Adam
update. The JAX step vmaps the views and shards them over a device mesh;
here it is train/distill.py's make_batched_train_step, which runs the views
one after another and accumulates each view's backward of loss / B, so B
views never hold B sets of activations at once (its step also returns the
last view's aux). Sharding the views over several cards (torch.distributed)
is not part of this module.
"""
from ..train.distill import make_batched_train_step as make_parallel_train_step  # noqa: F401
