"""`--debug_nans`: the first NaN raises FloatingPointError (the port's
counterpart of the JAX package's `jax_debug_nans`, which the JAX Trainer
sets).

Two traps, both off unless the flag is set (nothing is registered then):

- a forward hook on every module of the model that raises
  `FloatingPointError` naming the module (its qualified name and class)
  when a floating tensor of its output holds a NaN; hooks of inner modules
  run first, so the name is the innermost module that made the NaN. Each
  check reads one flag back to the host: a debug run is slow by design;
- `anomaly()`: torch's anomaly mode with `check_nan=True` for the run,
  which checks every backward function's outputs, the custom ones too
  (`PwBnAct`, `ConvBnAct`, `DwBnAct`, `Depthwise3dS1`, `FlashAttention`,
  the collectives' Functions); `as_floating_point_error` turns its
  RuntimeError into the FloatingPointError the JAX package raises.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch


def _floats(out):
    if torch.is_tensor(out):
        if out.is_floating_point():
            yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _floats(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _floats(v)


def install_nan_hooks(model: torch.nn.Module) -> List:
    """A NaN check on the output of every module of `model`; returns the
    hook handles (`handle.remove()` takes one off)."""
    handles = []
    for name, module in model.named_modules():
        label = f"{name or '<model>'} ({type(module).__name__})"

        def check(_module, _inputs, output, label=label):
            for t in _floats(output):
                if bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"debug_nans: NaN in the output of module {label}, "
                        f"shape {tuple(t.shape)}")

        handles.append(module.register_forward_hook(check))
    return handles


@contextlib.contextmanager
def anomaly():
    """torch's anomaly mode with NaN checks for the enclosed run; the mode
    before it comes back on exit."""
    with torch.autograd.set_detect_anomaly(True, check_nan=True):
        yield


@contextlib.contextmanager
def as_floating_point_error():
    """Re-raise anomaly mode's NaN RuntimeError ("Function '...' returned
    nan values in its Nth output") as FloatingPointError; other errors pass
    through."""
    try:
        yield
    except RuntimeError as e:
        if "returned nan values" in str(e):
            raise FloatingPointError(f"debug_nans: {e}") from e
        raise
