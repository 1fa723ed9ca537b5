"""Random draws of the reference, made as the program makes them.

The program draws every noise tensor and dropout mask of a batch from one
generator, whole-batch shaped. The reference may run a batch a block of
rows at a time (so that float32 fits beside the card's other work): inside
``rows(index, b)`` every draw is made at the whole batch's shape ``b``
and cut to the rows ``index`` (a slice or a list of row numbers), so that
a block sees the numbers its rows would have had in one whole pass, and
the generator advances as it would.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple, Union

import torch

Rows = Union[slice, List[int]]
_ROWS: Optional[Tuple[Rows, int]] = None


@contextlib.contextmanager
def rows(index: Rows, b: int):
    """Draws of the block are rows ``index`` of whole-batch draws of ``b``."""
    global _ROWS
    old, _ROWS = _ROWS, (index, b)
    try:
        yield
    finally:
        _ROWS = old


def _whole(shape) -> Tuple[Tuple[int, ...], Optional[Rows]]:
    shape = tuple(shape)
    if _ROWS is None:
        return shape, None
    index, b = _ROWS
    n = len(range(b)[index]) if isinstance(index, slice) else len(index)
    if shape[0] != n:
        raise ValueError(f"a draw of {shape} in a block of {n} rows")
    return (b,) + shape[1:], index


def randn(shape, generator: torch.Generator, device,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``torch.randn(shape, generator=generator, device=device)``."""
    full, cut = _whole(shape)
    out = torch.randn(full, generator=generator, device=device, dtype=dtype)
    return out if cut is None else out[cut]


def rand(shape, generator: torch.Generator, device) -> torch.Tensor:
    """``torch.rand(shape, generator=generator, device=device)``."""
    full, cut = _whole(shape)
    out = torch.rand(full, generator=generator, device=device)
    return out if cut is None else out[cut]


def randint(high: int, shape, generator: torch.Generator,
            device) -> torch.Tensor:
    """``torch.randint(0, high, shape, generator=generator, device=...)``."""
    full, cut = _whole(shape)
    out = torch.randint(0, high, full, generator=generator, device=device)
    return out if cut is None else out[cut]


def normal_like(shape, like: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """A standard normal float32 draw on the generator's device, moved to
    ``like``'s device and dtype (the program's ``draw_normal``)."""
    return randn(shape, generator, generator.device).to(like)
