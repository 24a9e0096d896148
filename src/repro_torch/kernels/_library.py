"""The ``repro_torch`` operator library: every hand-written kernel as a
``torch.library`` op.

Each op is a schema with three implementations: a CUDA one (the kernel's
launch), a CPU one (the plain version) and a fake one (``FakeTensorMode``:
the outputs' shapes and dtypes only). The dispatcher picks by the tensors'
device, so a CUDA tensor never reaches a plain version and any other
device raises; a ``meta`` tensor outside fake mode raises too
(:func:`fake_only`). The library is defined with
``torch.library.Library``, not ``torch.library.custom_op``, whose kernels
import ``torch._dynamo`` on their first call (seconds, inside a serving or
streaming path).

An op whose kernel allocates a workspace inside its launch (beyond its
outputs) registers that workspace's bytes as a function of the op's
arguments in :data:`WORKSPACES`; ``runtime/cost_analysis.py`` counts them in
the traced peak and bytes.
"""
from __future__ import annotations

from typing import Callable

import torch

#: the ops' library (one per namespace; every kernel module defines its ops here)
LIB = torch.library.Library("repro_torch", "DEF")
#: op name -> bytes of the workspace its CUDA implementation allocates, from
#: the op's arguments (fake tensors in a cost trace)
WORKSPACES: dict[str, Callable[..., int]] = {}


def define_op(schema: str, cuda, cpu, fake, workspace: Callable[..., int] | None = None):
    """Define ``repro_torch::<name>`` from ``schema`` with its CUDA, CPU and
    fake implementations (and its workspace bytes); returns the op."""
    name = schema.split("(")[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)
    if workspace is not None:
        WORKSPACES[name] = workspace
    return getattr(torch.ops.repro_torch, name)


def fake_only(name: str, *tensors: torch.Tensor) -> None:
    """The fake implementations serve fake tensors only: a ``meta`` tensor
    outside ``FakeTensorMode`` has no kernel, as any other device."""
    from torch._subclasses.fake_tensor import is_fake

    if not all(is_fake(t) for t in tensors):
        raise ValueError(f"no {name} for device {tensors[0].device} (fake tensors take shapes "
                         f"only; the kernel takes CUDA tensors, the plain version CPU ones)")
