"""The port's sharding plan (``repro_torch.models.sharding``, the models'
logical axes, ``repro_torch.launch.specs``) held against the reference's.

For all ten configs at full width, every parameter, cache and batch leaf's
spec must equal the reference's ``PartitionSpec`` as a tuple, exactly. The
reference side is ``jax.eval_shape`` of its ``init`` / ``init_cache`` and
its own ``param_specs`` / ``spec_for`` under ``axis_rules`` with a
duck-typed mesh (``axis_names`` and ``devices=np.empty(shape, object)``:
no device is touched); the port side is ``arch.init(device="meta")`` and
its own specs. Meshes (16, 16), (2, 16, 16) and (2, 4), under the default
and ``pure_dp`` rules, with and without the ``--opt`` levers. Also exact:
the per-device argument bytes of every cell against the reference's shapes
cut by its specs, ``runnable_cells``, ``model_flops``, ``flops_pass_cfg``
and ``slstm_flops_correction``. ``repro.launch.dryrun`` is never imported
(it sets 512 host devices at import).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import repro.launch.roofline as ref_roofline
import repro.launch.specs as ref_specs
import repro.models.registry as ref_registry
import repro.models.sharding as ref_sharding
import repro.train.train_step as ref_train_step
from repro.train.optimizer import init_opt_state as ref_init_opt_state
from repro_torch.launch import roofline, specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import SHAPES, arch_names, get
from repro_torch.models import registry, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.train.train_step import param_specs
from repro_torch.tree import tree_flatten

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
OPT = dict(weight_gather=True, decode_cache_seq_shard=True)


class DuckMesh:
    """What the reference's ``spec_for`` reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, object)


def _rules(kind: str, module, mesh):
    return module.pure_dp_rules(mesh) if kind == "pure_dp" else None


def _ref_flat(tree) -> dict:
    """path -> spec tuple of a reference spec tree (JAX's order)."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {_path(path): tuple(spec) for path, spec in leaves}


def _path(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _port_flat(tensors, specs_tree) -> dict:
    """path -> spec of the port's spec tree, walked by its tensor tree."""
    out = {}
    for path, _ in tree_flatten(tensors):
        node = specs_tree
        for k in path:
            node = node[k]
        out[path] = node
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(name: str):
    arch = ref_registry.get(name)
    return jax.eval_shape(lambda: arch.init(jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _port_params(name: str):
    return get(name).init(device="meta")


def _ref_arch(name: str, opt: bool):
    arch = ref_registry.get(name)
    if opt:
        arch = ref_registry.Arch(cfg=dataclasses.replace(arch.cfg, **OPT), module=arch.module)
    return arch


def _port_arch(name: str, opt: bool):
    arch = get(name)
    if opt:
        arch = registry.Arch(cfg=dataclasses.replace(arch.cfg, **OPT), module=arch.module)
    return arch


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", arch_names())
def test_param_and_cache_specs_equal_reference(name, mesh_name):
    shape, names = MESHES[mesh_name]
    ref_mesh, mesh = DuckMesh(shape, names), Mesh(shape, names)
    ref_p, port_p = _ref_params(name), _port_params(name)
    ref_shapes = {_path(path): tuple(sds.shape)
                  for path, sds in jax.tree_util.tree_flatten_with_path(ref_p)[0]}
    assert ref_shapes == {path: tuple(t.shape) for path, t in tree_flatten(port_p)}
    n_checked = 0
    for rules in ("default", "pure_dp"):
        for opt in (False, True):
            ref_arch, arch = _ref_arch(name, opt), _port_arch(name, opt)
            with ref_sharding.axis_rules(ref_mesh, _rules(rules, ref_sharding, ref_mesh)):
                want = _ref_flat(ref_train_step.param_specs(ref_arch, ref_p))
                ref_caches = {}
                for B, S in ((128, 32768), (1, 524288)):
                    cache = jax.eval_shape(lambda: ref_arch.init_cache(B, S))
                    logical = ref_arch.module.cache_logical_axes(ref_arch.cfg, B)
                    ref_caches[B] = _ref_flat(jax.tree.map(
                        lambda sds, lg: ref_sharding.spec_for(tuple(sds.shape), tuple(lg)),
                        cache, logical))
            with sharding.axis_rules(mesh, _rules(rules, sharding, mesh)):
                got = _port_flat(port_p, param_specs(arch, port_p))
                for B, S in ((128, 32768), (1, 524288)):
                    cache = arch.init_cache(B, S, device="meta")
                    got_c = _port_flat(cache, sharding.tree_specs(
                        cache, arch.module.cache_logical_axes(arch.cfg, B)))
                    assert got_c == ref_caches[B], (rules, opt, B)
                    n_checked += len(got_c)
            assert got == want, (rules, opt)
            n_checked += len(got)
    assert n_checked > 0


@pytest.mark.parametrize("name", arch_names())
def test_batch_specs_and_argument_bytes_equal_reference(name):
    """Batch specs of every kind on every mesh, and the per-device bytes of
    each runnable cell's arguments on the (16, 16) mesh under the cell's own
    rules, against the reference's shapes cut by its specs."""
    ref_arch, arch = ref_registry.get(name), get(name)
    for mesh_name, (shape, names) in MESHES.items():
        ref_mesh, mesh = DuckMesh(shape, names), Mesh(shape, names)
        for shape_spec in SHAPES.values():
            ref_batch = ref_specs.batch_specs(ref_arch.cfg, shape_spec, shape_spec.kind)
            logical = ref_train_step.batch_logical_axes(ref_arch.cfg)
            with ref_sharding.axis_rules(ref_mesh):
                want = {k: tuple(ref_sharding.spec_for(tuple(v.shape), tuple(logical[k])))
                        for k, v in ref_batch.items()}
            got = specs.input_specs(arch, shape_spec, mesh)[1][-1] \
                if shape_spec.kind != "decode" else None
            if got is not None:
                assert got == want, (mesh_name, shape_spec.name)

    shape, names = MESHES["16x16"]
    ref_mesh, mesh = DuckMesh(shape, names), Mesh(shape, names)
    sizes = dict(zip(names, shape))
    for shape_name, runnable, _ in registry.runnable_cells(name):
        if not runnable:
            continue
        shape_spec = SHAPES[shape_name]
        fn, args, in_specs = specs.dryrun_target(name, shape_name, mesh)
        got = specs.per_device_bytes(args, in_specs, mesh)
        rules = ref_sharding.pure_dp_rules(ref_mesh) \
            if ref_arch.cfg.sharding_profile == "pure_dp" else None
        with ref_sharding.axis_rules(ref_mesh, rules):
            p_sds = _ref_params(name)
            p_specs = ref_train_step.param_specs(ref_arch, p_sds)
            if shape_spec.kind == "decode":
                B = shape_spec.batch
                cache = jax.eval_shape(lambda: ref_arch.init_cache(B, shape_spec.seq))
                c_specs = jax.tree.map(
                    lambda sds, lg: ref_sharding.spec_for(tuple(sds.shape), tuple(lg)), cache,
                    ref_arch.module.cache_logical_axes(ref_arch.cfg, B))
                tok = jax.ShapeDtypeStruct((B, 1), np.int32)
                pairs = [(p_sds, p_specs), (tok, ref_sharding.spec_for((B, 1), ("batch", None))),
                         (cache, c_specs)]
            else:
                batch = ref_specs.batch_specs(ref_arch.cfg, shape_spec, shape_spec.kind)
                logical = ref_train_step.batch_logical_axes(ref_arch.cfg)
                b_specs = {k: ref_sharding.spec_for(tuple(v.shape), tuple(logical[k]))
                           for k, v in batch.items()}
                pairs = [(p_sds, p_specs), (batch, b_specs)]
                if shape_spec.kind == "train":
                    opt = jax.eval_shape(lambda: ref_init_opt_state(p_sds))
                    pairs.insert(1, (opt, ref_train_step.opt_state_specs(p_specs)))
        want = 0
        for tree, spec_tree in pairs:
            leaves = jax.tree.leaves(tree)
            spec_leaves = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
            assert len(leaves) == len(spec_leaves)
            for sds, spec in zip(leaves, spec_leaves):
                cut = int(np.prod([sizes[a] for e in spec if e is not None
                                   for a in ((e,) if isinstance(e, str) else e)]))
                want += int(np.prod(sds.shape)) * sds.dtype.itemsize // cut
        assert got == want, (name, shape_name)


@pytest.mark.parametrize("name", arch_names())
def test_cells_flops_and_configs_equal_reference(name):
    assert registry.runnable_cells(name) == ref_registry.runnable_cells(name)
    cfg, ref_cfg = get(name).cfg, ref_registry.get(name).cfg
    for shape_spec in SHAPES.values():
        assert roofline.model_flops(cfg, shape_spec, shape_spec.kind) == \
            ref_roofline.model_flops(ref_cfg, shape_spec, shape_spec.kind)
        # The port's config has fields the reference's lacks (another
        # family's); here they keep their defaults.
        want = dataclasses.asdict(ref_specs.flops_pass_cfg(ref_cfg, shape_spec))
        assert dataclasses.asdict(specs.flops_pass_cfg(cfg, shape_spec)) == \
            dataclasses.asdict(ModelConfig(**want))
        assert specs.slstm_flops_correction(cfg, shape_spec) == \
            ref_specs.slstm_flops_correction(ref_cfg, shape_spec)


def test_axis_rules_restore_the_outer_context():
    outer, inner = Mesh((16, 16), ("data", "model")), Mesh((2, 4), ("data", "model"))
    assert sharding.active_mesh() is None and sharding.spec_for((32, 64), ("batch", None)) == ()
    with sharding.axis_rules(outer):
        assert sharding.spec_for((32, 64), ("batch", "ff")) == ("data", "model")
        with sharding.axis_rules(inner, sharding.pure_dp_rules(inner)):
            assert sharding.active_mesh() is inner
            assert sharding.spec_for((32, 64), ("batch", "ff")) == (("data", "model"), None)
        assert sharding.active_mesh() is outer
        with pytest.raises(RuntimeError):
            with sharding.axis_rules(inner):
                raise RuntimeError("inside")
        assert sharding.active_mesh() is outer
        with sharding.axis_rules(None):
            assert sharding.active_mesh() is None
        assert sharding.active_mesh() is outer
        # Divisibility fallback: 30 does not divide by 16.
        assert sharding.spec_for((30, 64), ("batch", "ff")) == (None, "model")
        assert sharding.named_sharding((32, 64), ("batch", None)).spec == ("data", None)
    assert sharding.active_mesh() is None and sharding.named_sharding((4,), (None,)) is None
    x = object()
    assert sharding.constrain(x, "batch") is x
