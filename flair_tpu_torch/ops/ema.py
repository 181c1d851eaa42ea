"""EMA of parameters (nn.py:804-814 update_ema).

Counterpart of ``flair_tpu/ops/ema.py``. The JAX package returns a new
pytree; here the float32 streams are updated in place, a state dict or a
list of tensors at a time.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import torch

Streams = Union[Mapping[str, torch.Tensor], Sequence[torch.Tensor]]


@torch.no_grad()
def ema_update(ema_params: Streams, params: Streams, rate: float = 0.99):
    """ema ← rate·ema + (1 − rate)·params, tensor by tensor, in the
    stream's dtype (float32). ``ema_params`` and ``params`` are both dicts
    with the same keys or both sequences in the same order. Returns
    ``ema_params``."""
    if isinstance(ema_params, Mapping):
        pairs = [(ema_params[k], params[k]) for k in ema_params]
    else:
        pairs = list(zip(ema_params, params, strict=True))
    for e, p in pairs:
        e.copy_(e * rate + p.to(e.dtype) * (1.0 - rate))
    return ema_params
