"""What the benchmark wraps around the program's calls for the profiled
slice that attributes device time (never for the window or the slice that
reads the device's busy time).

- ``op_calls``: each op of ``benchmark/ops/`` names the program function
  that runs it (``TARGET``, ``module:function``); the function is wrapped
  so that each call's bytes and operations, from the op's ``cost`` at the
  call's arguments, are recorded.
- ``backward_ranges``: every ``torch.autograd.Function`` defined in the
  program's loaded modules gets its backward wrapped in a host range
  ``bench_bwd::<Function>``, so that the profile attributes the kernels
  launched there to the rule.

Both restore the program as they found it.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
from typing import Dict, Iterator, List

import torch
from torch.profiler import record_function


@contextlib.contextmanager
def op_calls(ops: Dict[str, object], calls: List) -> Iterator[List[str]]:
    """Yields the ops whose target was found; an op whose target the
    program no longer has is left out (and named on standard error)."""
    patched, found = [], []
    for name, op in ops.items():
        modname, attr = op.TARGET.split(":")
        try:
            module = importlib.import_module(modname)
            orig = getattr(module, attr)
        except (ImportError, AttributeError):
            print("op %s: %s not found in the program; left out" % (
                name, op.TARGET), file=sys.stderr)
            continue

        def wrapped(*args, _orig=orig, _name=name, _op=op, **kwargs):
            calls.append((_name,) + tuple(_op.cost(*args, **kwargs)))
            return _orig(*args, **kwargs)

        setattr(module, attr, wrapped)
        patched.append((module, attr, orig))
        found.append(name)
    try:
        yield found
    finally:
        for module, attr, orig in patched:
            setattr(module, attr, orig)


def kernels(ops: Dict[str, object]) -> Dict[str, str]:
    """Each op's device kernel name pattern."""
    return {name: op.KERNEL for name, op in ops.items()}


def _functions(package: str):
    for modname, module in list(sys.modules.items()):
        if module is None or not (modname == package
                                  or modname.startswith(package + ".")):
            continue
        for obj in vars(module).values():
            if (isinstance(obj, type)
                    and issubclass(obj, torch.autograd.Function)
                    and obj.__module__ == modname
                    and "backward" in vars(obj)):
                yield obj


@contextlib.contextmanager
def backward_ranges(package: str) -> Iterator[None]:
    """Ranges the backward of each autograd Function of ``package``."""
    saved = {fn: vars(fn)["backward"] for fn in _functions(package)}

    def ranged(name, backward):
        def run(ctx, *grads):
            with record_function("bench_bwd::" + name):
                return backward(ctx, *grads)
        return staticmethod(run)

    for fn, sm in saved.items():
        fn.backward = ranged(fn.__name__, sm.__func__)
    try:
        yield
    finally:
        for fn, sm in saved.items():
            fn.backward = sm
