"""UPFlow in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of ``upflow_pytorch_tpu`` (JAX) that imports neither JAX nor that
package.  Entry points: ``models.entry.build_model`` and
``models.entry.forward`` (inference), ``train.step.create_train_state``
and ``train.step.make_train_step`` (one training step), and
``train.trainer.Trainer`` (the training loop with evaluation,
checkpoints, resume and the ``.pth`` import).
"""
