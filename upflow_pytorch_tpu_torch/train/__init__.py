"""Training: the step (``step.py``) and the trainer with its evaluation
model (``trainer.py``)."""
