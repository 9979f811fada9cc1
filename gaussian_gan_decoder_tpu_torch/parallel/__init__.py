from .distill import make_parallel_train_step  # noqa: F401
