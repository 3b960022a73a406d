"""UPFlow in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of ``upflow_pytorch_tpu`` (JAX) that imports neither JAX nor that
package.  Entry points: ``models.upflow.build_model`` and
``models.upflow.forward`` (inference), ``train.step.create_train_state``
and ``train.step.make_train_step`` (training).
"""
