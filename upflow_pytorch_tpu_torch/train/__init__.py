"""Training: the step (``step.py``) and the evaluation model
(``trainer.py``)."""
