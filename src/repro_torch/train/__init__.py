"""Training: the optimizers (``optimizer.py``) and one LM step
(``step.py``)."""
