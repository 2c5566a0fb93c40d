"""Logical-axis sharding: MaxText-style rules mapping logical tensor axes to
mesh axes, with divisibility-aware fallback.

The port of the reference package's ``repro/models/sharding.py``. Logical
axes used across the models:
  batch     — data-parallel batch            → ("pod", "data")
  seq_sp    — sequence-parallel residual     → "model"   (Megatron-SP)
  heads     — attention heads                → "model"
  kv_heads  — KV heads                       → "model" (if divisible)
  ff        — MLP hidden                     → "model"
  vocab     — vocabulary                     → "model"
  embed     — d_model on weights             → ("pod", "data")  (FSDP/ZeRO)
  experts   — MoE experts                    → (unsharded; d_ff TP instead)
  kv_seq    — KV-cache sequence              → "model" (long-context decode)

The mesh is the port's own plain :class:`repro_torch.launch.mesh.Mesh`
(``axis_names`` and ``shape``), and a spec is a plain tuple whose entries
are ``None``, an axis name, or a tuple of names — the entries of the
reference's ``PartitionSpec(*entries)``, one for one. The specs are a plan
(:mod:`repro_torch.launch`): the port's models run on one card, so nothing
here moves a tensor.

``with axis_rules(mesh, rules): ...`` activates the rules; without an
active context every spec is ``()`` (replicated).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

_STATE = threading.local()


def default_rules(mesh) -> dict[str, tuple[str, ...]]:
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    model = ("model",) if "model" in mesh.axis_names else ()
    return {
        "batch": data_axes,
        "seq_sp": model,
        "heads": model,
        "kv_heads": model,
        "ff": model,
        "vocab": model,
        "embed": data_axes,
        "experts": (),
        "kv_seq": model,
        "state": (),
    }


def pure_dp_rules(mesh) -> dict[str, tuple[str, ...]]:
    """The profile for small models: no tensor parallelism at all — batch
    over (data, model), params fully replicated, grads all-reduced once.
    Removes every per-layer activation collective."""
    axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    return {
        "batch": axes,
        "seq_sp": (), "heads": (), "kv_heads": (), "ff": (),
        "vocab": (), "embed": (), "experts": (), "kv_seq": (), "state": (),
    }


@contextlib.contextmanager
def axis_rules(mesh, rules: dict[str, tuple[str, ...]] | None = None):
    """Activate ``rules`` (default: :func:`default_rules`) on ``mesh`` for
    this thread; ``mesh=None`` deactivates. The outer context is restored on
    exit, also on an exception."""
    prev = getattr(_STATE, "ctx", None)
    if mesh is None:
        _STATE.ctx = None
    else:
        _STATE.ctx = (mesh, rules or default_rules(mesh))
    try:
        yield
    finally:
        _STATE.ctx = prev


def active_mesh():
    ctx = getattr(_STATE, "ctx", None)
    return ctx[0] if ctx else None


def _axes_for(logical: str | None) -> tuple[str, ...]:
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None or logical is None:
        return ()
    return ctx[1].get(logical, ())


def spec_for(shape: tuple[int, ...], logical_axes: tuple[str | None, ...]) -> tuple:
    """The spec of a shape, dropping axes that don't divide evenly."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return ()
    sizes = dict(zip(ctx[0].axis_names, ctx[0].shape))
    out = []
    for dim, logical in zip(shape, logical_axes):
        axes = _axes_for(logical)
        prod = math.prod(sizes[a] for a in axes)
        if axes and dim % prod == 0 and prod > 1:
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return tuple(out)


def constrain(x, *logical_axes: str | None):
    """The identity, with or without an active context. The reference's
    ``with_sharding_constraint`` only acts inside an SPMD compile; the
    port's models run on one card, so there is nothing to constrain."""
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: tuple


def named_sharding(shape: tuple[int, ...], logical_axes: tuple[str | None, ...]):
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return None
    return NamedSharding(ctx[0], spec_for(shape, logical_axes))


def is_axes(node) -> bool:
    """A logical-axes leaf: a tuple of axis names and ``None`` (``()`` for a
    scalar), as opposed to a tuple of subtrees (a recurrent cache's)."""
    return isinstance(node, tuple) and all(a is None or isinstance(a, str) for a in node)


def map_logical(fn, tree, logical):
    """``fn(node, axes)`` at every logical-axes leaf of ``logical`` over the
    matching node of ``tree`` (a tensor, a shape, or a whole subtree);
    dicts, lists and tuples of subtrees recurse, and a ``None`` node of
    ``tree`` (an empty subtree, a Mamba2 conv buffer after a short prompt)
    stays ``None``."""
    if tree is None:
        return None
    if is_axes(logical):
        return fn(tree, logical)
    if isinstance(logical, dict):
        return {k: map_logical(fn, tree[k], v) for k, v in logical.items()}
    return type(logical)(map_logical(fn, t, v) for t, v in zip(tree, logical, strict=True))


def shape_of(node) -> tuple[int, ...]:
    """A leaf's shape: a tensor's ``.shape`` or a shape given as a sequence."""
    return tuple(getattr(node, "shape", node))


def tree_specs(tree_shapes, tree_logical):
    """Map matching trees of shapes (or tensors) & logical-axis tuples to
    specs."""
    return map_logical(lambda node, lg: spec_for(shape_of(node), lg), tree_shapes, tree_logical)


def stacked(logical):
    """Logical axes of per-layer leaves stacked along a leading layer axis
    (unsharded: a leading ``None``)."""
    return map_logical(lambda axes, _: (None, *axes), logical, logical)
