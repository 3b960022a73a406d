"""Multi-GPU parallelism on ``torch.distributed``: the group and the
('data', 'spatial') mesh (``mesh.py``), the reductions over the ranks
(``reduce.py``), the width sharding of the eval step over 'spatial'
(``spatial.py``), the sharded train and eval steps (``step.py``) and a
dry run over n ranks (``dryrun.py``).  Port of
``upflow_pytorch_tpu/parallel/``."""
