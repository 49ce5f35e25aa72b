"""Training and evaluation engines: ``trainer.py`` (``Trainer``, ``fit``),
``optim.py``, ``checkpoints.py`` and the serving ``evaluator.py``."""
