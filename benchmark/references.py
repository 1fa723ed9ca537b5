"""The plain reference a configuration is checked against, and the work
count its roofline and MFU shares divide by, found by name.

A configuration's file may name its reference under ``"reference"``: a
dotted module, ``benchmark.reference`` itself or a package or module
inside it (so that ``benchmark/tests/test_bench_harness.py`` holds it to
importing neither JAX nor the port). Without the key, or with
``benchmark.reference``, the configuration takes the frozen reference
(``benchmark/reference/``) and ``benchmark.work``.

A named reference module provides

* ``Config``: ``Config.from_dict(cfg_dict)`` of the configuration, with
  ``vits``, ``diffusion_encoder``, ``data`` and ``train`` sections as the
  frozen ``benchmark.reference.config`` has them;
* ``DiffVits(cfg, n_vocab)``: the model, whose state dict names are the
  port's (``benchmark.weights.make_state_dict`` draws its weights from
  the reference's module tree, and the same state dict loads into the
  program), with ``vits.neg_cent`` and ``loss`` as the frozen model has
  them;
* ``synthesize``: the frozen ``synthesize``'s signature and results;
* ``Vocos(n_mels)`` and ``maximum_path(neg_cent, mask)``;
* ``work``: a hashable object (a module or a class) with
  ``synthesize``, ``predict_lengths``, ``vocoder`` and ``train_forward``
  of ``benchmark.work``'s signatures, counting this reference's products
  as ``benchmark.work.Op``s.

It may import and reuse every layer of the frozen reference and
``benchmark.work``'s helpers. It draws every random number through
``benchmark.reference.draws`` and multiplies through ``nn.Linear`` and
``nn.Conv1d`` (or ``bmm`` / ``matmul`` of two activations), so that the
check's row-blocked draws and the float8 control
(``benchmark.reference.quant.fp8_products``) apply to it unchanged.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import importlib
import re
from typing import Any, Callable, Dict

FROZEN = "benchmark.reference"
NAMES = ("Config", "DiffVits", "synthesize", "Vocos", "maximum_path",
         "work")
WORK = ("synthesize", "predict_lengths", "vocoder", "train_forward")
_DOTTED = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*(\.[A-Za-z_][A-Za-z0-9_]*)*$")


class BadReference(ValueError):
    """A configuration's ``"reference"`` that cannot be used."""


@dataclasses.dataclass(frozen=True)
class Reference:
    name: str
    Config: type
    DiffVits: type
    synthesize: Callable
    Vocos: type
    maximum_path: Callable
    work: Any


def resolve(cfg_dict: Dict) -> Reference:
    """The reference that ``cfg_dict`` (a configuration file's contents)
    names; raises ``BadReference`` for a name that lies outside
    ``benchmark.reference``, does not import, or lacks one of ``NAMES``
    or of ``work``'s functions."""
    name = cfg_dict.get("reference", FROZEN)
    if not isinstance(name, str) or not _DOTTED.match(name) or not (
            name == FROZEN or name.startswith(FROZEN + ".")):
        raise BadReference(f"reference {name!r} is not {FROZEN} or a "
                           f"module inside it")
    if name == FROZEN:
        from benchmark import work
        from benchmark.reference import config, layers, model, vocos
        return Reference(name, config.Config, model.DiffVits,
                         model.synthesize, vocos.Vocos, layers.maximum_path,
                         work)
    try:
        mod = importlib.import_module(name)
    except ImportError as e:
        raise BadReference(f"reference {name!r} does not import: {e}") \
            from e
    missing = [n for n in NAMES if not hasattr(mod, n)]
    work = getattr(mod, "work", None)
    missing += [f"work.{n}" for n in WORK if not hasattr(work, n)]
    if not isinstance(work, collections.abc.Hashable):
        missing.append("a hashable work")
    if missing:
        raise BadReference(f"reference {name!r} lacks "
                           f"{', '.join(missing)}")
    return Reference(name, *(getattr(mod, n) for n in NAMES))
