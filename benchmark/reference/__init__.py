"""The plain fp32 PyTorch reference of UPFlow that decides ``correct``.

A frozen, self-contained copy of the published semantics: its own ``.npz``
reader (``npz.py``), its own synthetic pair generator (``synthetic.py``),
the bidirectional forward with self-guided upsampling and the
forward-backward occlusion check (``upflow.py``), the fine-tune recipe's
losses (``losses.py``) and Adam with AMSGrad (``amsgrad.py``).  It imports
neither JAX nor either UPFlow package, and takes no weights or tables from
the program under test.
"""
