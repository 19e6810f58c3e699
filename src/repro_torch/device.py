"""Device resolution shared by every entry point of the port, and the host
-> device constants of the solve path.

A blocking copy from pageable host memory to the card waits for the
stream, so a constant built anew inside a solver loop drains the queue on
every call.  The solve path therefore copies host data with
:func:`to_device` (pinned memory, a copy that does not block) and keeps
what it builds from the host with :func:`constant` (made once per key).
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Hashable, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

#: the most constants :func:`constant` keeps (least recently used go first)
MAX_CONSTANTS = 64

_constants: "collections.OrderedDict[Hashable, object]" = \
    collections.OrderedDict()
_constants_lock = threading.Lock()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Asking for CUDA on a machine without it
    raises: the port never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def to_device(a, dtype: torch.dtype, device: DeviceLike) -> torch.Tensor:
    """Host data (numpy, list, scalar, CPU tensor) -> a ``dtype`` tensor on
    ``device``, converted on the host.  To a CUDA device the copy goes from
    pinned memory without blocking: the stream is not waited for."""
    device = torch.device(device)
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            return a.to(device=device, dtype=dtype)
        t = a.to(dtype)
    else:
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to host memory: pinned when it lives on a card, so a
    later copy back to the card runs at the link's rate."""
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.is_cuda).copy_(t)


def constant(key: Hashable, make: Callable[[], object]):
    """``make()``'s result, made once per ``key`` and kept (the last
    :data:`MAX_CONSTANTS` keys).  The key names everything the result
    depends on, the device included."""
    with _constants_lock:
        if key in _constants:
            _constants.move_to_end(key)
            return _constants[key]
    value = make()
    with _constants_lock:
        value = _constants.setdefault(key, value)
        _constants.move_to_end(key)
        while len(_constants) > MAX_CONSTANTS:
            _constants.popitem(last=False)
    return value
