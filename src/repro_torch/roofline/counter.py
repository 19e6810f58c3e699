"""Cost and memory of an eager PyTorch program, op by op: the port's
counterpart of XLA's ``cost_analysis()`` and ``memory_analysis()``, which
the JAX package's dry-run reads from a compiled program.

:class:`CostCounter` is a ``TorchDispatchMode``.  Every aten op that runs
under it adds

* its product FLOPs, from ``torch.utils.flop_counter``'s formulas (mm,
  bmm, addmm, baddbmm, convolution, scaled dot-product attention), kept
  apart by the dtype of the product's operands (bf16 and float32 run at
  different peaks on the card);
* the bytes it reads and writes: every tensor argument read once, every
  output written once; views and allocations move nothing.  This is the
  eager program's traffic, op by op — XLA's count comes after fusion, so
  the two differ by what a fusion keeps out of memory.  With no compiler
  in the port, the eager count is the bound that fits it;
* the storages it creates to the live bytes, each taken off again by a
  ``weakref.finalize`` on its storage when the storage is freed; the
  largest live total is the program's peak.  Tensors made before the
  mode (params, cache, inputs) are counted once :meth:`track` names them,
  or when an op first reads them.

It runs on ``meta`` tensors (shapes only: the dry-run) and on ``cuda``
tensors alike (the card check of the dry-run), and counts the same ops
on both: the products decompose the same way on either device.
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

#: allocations that write nothing (their storage still counts as live)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "resize_", "set_", "detach", "alias",
               "lift_fresh"}


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and live storage of the ops run inside it.

    ``flops``: total product FLOPs; ``flops_by_dtype``: the same split by
    operand dtype (``"bfloat16"``, ``"float32"``, ...); ``bytes``: bytes
    read plus written; ``by_op``: aten op name -> [calls, flops, bytes];
    ``live``/``peak``: bytes of live storages now / at most."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_dtype: Dict[str, int] = collections.Counter()
        self.bytes = 0
        self.by_op: Dict[str, list] = collections.defaultdict(
            lambda: [0, 0, 0])
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    # -- live storage ---------------------------------------------------

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._storages:
            return
        n = storage.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._release, key)

    def track(self, *trees) -> int:
        """Counts the storages of ``trees``' tensors as live (the program's
        arguments).  Returns the bytes newly counted."""
        before = self.live
        for t in _tensors(trees):
            self._hold(t)
        return self.live - before

    # -- the ops ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        for t in ins:
            self._hold(t)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        name = func._overloadpacket.__name__
        flops = 0
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
            dtype = str(ins[0].dtype).replace("torch.", "") if ins else "?"
            self.flops_by_dtype[dtype] += flops
            self.flops += flops
        nbytes = 0
        if not (func.is_view or name in _NO_TRAFFIC):
            nbytes = sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
            self.bytes += nbytes
        rec = self.by_op[name]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        return out
