"""State carried across from the reference package.

The compiler flow has no weights.  What both sides must agree on is the
*design* (an HIR module) and the *stimulus* (integer or float arrays, one per
memref argument).  The textual IR is the interchange format for the first —
``print_module`` on one side, ``parse`` on the other — and numpy arrays are
the format for the second.

The model has weights: ``params_from_reference`` maps the reference's
``init_lm`` tree, fetched to the host as numpy arrays, onto the port's, and
``state_from_reference`` a whole train state (parameters and AdamW moments).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ._device import resolve_device
from .core import ir
from .core.lower.common import cuda_dtype
from .core.parser import parse


def module_from_reference_text(text: str) -> ir.Module:
    """Rebuild a module from the reference package's ``print_module`` text
    with this package's own parser, so both sides compute on one design —
    including one built by the reference's builder and rewritten by the
    reference's passes."""
    return parse(text)


def to_tensor(array, elem_type: ir.Type,
              device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """Stimulus array -> tensor of the memref element's dtype on ``device``
    (``None`` = the CUDA device).  ``make_inputs`` yields ``int64`` numpy
    arrays; they are cast to the memref's dtype as the reference casts them."""
    dev = resolve_device(device)
    dtype = cuda_dtype(elem_type)
    if isinstance(array, torch.Tensor):
        return array.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.ascontiguousarray(array)).to(device=dev, dtype=dtype)


def params_from_reference(tree, device: Optional[Union[str, torch.device]] = None):
    """The reference's parameter tree (nested dicts and lists of numpy
    arrays, as ``jax.device_get`` returns them) as the same tree of tensors
    on ``device`` (``None`` = the CUDA device).  numpy has no bfloat16: a
    bfloat16 leaf travels as float32 holding its values, which are exact
    there, and becomes bfloat16 again on the port's side."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_reference(v, dev) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32)).to(device=dev, dtype=torch.bfloat16)
    return torch.tensor(arr).to(dev)             # a copy: fetched arrays are read-only


def state_from_reference(state, device: Optional[Union[str, torch.device]] = None):
    """The reference's train state (``{"params", "opt": {"m", "v", "step"}}``,
    fetched to the host) as the port's on ``device`` (``None`` = the CUDA
    device): the parameters as ``params_from_reference`` carries them, the
    float32 moments leaf for leaf, the step count an int32 scalar — so both
    sides can take a train step from one state."""
    dev = resolve_device(device)
    opt = state["opt"]
    return {"params": params_from_reference(state["params"], dev),
            "opt": {"m": params_from_reference(opt["m"], dev),
                    "v": params_from_reference(opt["v"], dev),
                    "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32,
                                         device=dev)}}
