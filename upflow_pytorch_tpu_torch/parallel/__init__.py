"""Multi-GPU data parallelism on ``torch.distributed``: the group and the
mesh (``mesh.py``), the reductions over the ranks (``reduce.py``), the
sharded train and eval steps (``step.py``) and a one-step dry run over n
ranks (``dryrun.py``).  Port of ``upflow_pytorch_tpu/parallel/``."""
