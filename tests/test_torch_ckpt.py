"""The port's erasure-coded checkpoints (``repro_torch.ckpt``) against the
reference's on the CPU: the same strips and manifest byte for byte for the
same tree (bfloat16 leaves and the int32 ``opt/step`` included), and
restores across the packages both ways with the same bits. Mirrors the
checkpoint tests of ``tests/test_train_ckpt.py``. The port codes through
``Codec("kernel", device="cpu")`` (K1's plain version), the reference
through its default numpy codec."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as ref_restore
from repro.ckpt import save_checkpoint as ref_save
from repro.models import get as ref_get
from repro.storage import MemoryStore as RefMemoryStore
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.coding.codec import Codec
from repro_torch.core import PAPER_READ_3MB, RequestClass, TOFECPolicy
from repro_torch.models import get, params_from_numpy
from repro_torch.storage import FaultyStore, MemoryStore, StorageError
from repro_torch.train import init_opt_state
from repro_torch.tree import tree_flatten

CPU = torch.device("cpu")
CODEC = Codec("kernel", device="cpu")


def _tensor_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_same_bits(got, want):
    """A port tree (tensors) against a reference tree (numpy), leaf by leaf:
    names, shapes, dtypes and bytes."""
    got, want = tree_flatten(got), jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got] == [tuple(str(k.key) for k in p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        assert tuple(g.shape) == w.shape, path
        assert g.reshape(-1).view(torch.uint8).numpy().tobytes() == w.tobytes(), path


def _train_state():
    """The reference's bfloat16 smoke parameters and a seeded optimizer
    state at step 7: (reference numpy tree, port tensor tree)."""
    rp = jax.tree.map(np.asarray, ref_get("qwen1.5-0.5b", smoke=True).init(jax.random.key(3)))
    rng = np.random.default_rng(0)
    mom = lambda: jax.tree.map(  # noqa: E731
        lambda a: rng.standard_normal(a.shape).astype(np.float32), rp)
    ref_tree = {"params": rp, "opt": {"m": mom(), "v": mom(), "step": np.int32(7)}}
    port_tree = {"params": params_from_numpy(rp, CPU),
                 "opt": {"m": _tensor_tree(ref_tree["opt"]["m"]),
                         "v": _tensor_tree(ref_tree["opt"]["v"]),
                         "step": torch.tensor(7, dtype=torch.int32)}}
    return ref_tree, port_tree


def _objects(store):
    return {key: store.get(key) for key in store.keys()}


def test_checkpoint_roundtrip_and_erasure_recovery():
    store = MemoryStore()
    rng = np.random.default_rng(0)
    tree = {
        "w": torch.from_numpy(rng.normal(size=(33, 17)).astype(np.float32)),
        "nested": {"b": torch.from_numpy(rng.integers(-5, 5, size=(9,)).astype(np.int32))},
    }
    save_checkpoint(store, "ck", 5, tree, n_max=6, k_max=3, device="cpu")
    assert latest_step(store, "ck") == 5

    # Drop strips up to n - k per leaf: restore must still succeed.
    faulty = FaultyStore(store)
    for key in store.keys():
        if key.endswith("strip0") or key.endswith("strip2"):
            faulty.lose_object(key)
    got = restore_checkpoint(faulty, "ck", 5, tree, device="cpu")
    assert torch.equal(got["w"], tree["w"])
    assert torch.equal(got["nested"]["b"], tree["nested"]["b"])


def test_checkpoint_unrecoverable_raises():
    store = MemoryStore()
    tree = {"w": torch.ones((4, 4))}
    save_checkpoint(store, "ck2", 1, tree, n_max=4, k_max=2, device="cpu")
    faulty = FaultyStore(store)
    lost = 0
    for key in store.keys():
        if "strip" in key and lost < 3:
            faulty.lose_object(key)
            lost += 1
    with pytest.raises(StorageError):
        restore_checkpoint(faulty, "ck2", 1, tree, device="cpu")


def test_tofec_policy_drives_checkpoint_chunking():
    """Backlogged writer → k drops toward 1 (throughput mode)."""
    store = MemoryStore()
    cls = RequestClass("ckpt", 3.0, PAPER_READ_3MB, k_max=4, r_max=2.0, n_max=8)
    tree = {f"w{i}": torch.ones((64,)) for i in range(4)}
    m_idle = save_checkpoint(store, "cki", 1, tree, policy=TOFECPolicy.for_classes([cls], L=16),
                             n_max=8, k_max=4, device="cpu")
    m_busy = save_checkpoint(store, "ckb", 1, tree, policy=TOFECPolicy.for_classes([cls], L=16),
                             n_max=8, k_max=4, pending_hint=500, device="cpu")
    k_idle = [v["k"] for v in m_idle["leaves"].values()]
    k_busy = [v["k"] for v in m_busy["leaves"].values()]
    assert max(k_idle) > max(k_busy)
    assert max(k_busy) == 1


@pytest.mark.parametrize("n_max,k_max", [(8, 4), (6, 3), (3, 1)])
def test_strips_and_manifest_equal_the_references(n_max, k_max):
    """Every object of one checkpoint — each leaf's n strips, the manifest
    JSON and LATEST — byte for byte, for a training state with bfloat16
    parameters, float32 moments and the 0-d int32 step."""
    ref_tree, port_tree = _train_state()
    ref_store, store = RefMemoryStore(), MemoryStore()
    want = ref_save(ref_store, "ck", 9, ref_tree, n_max=n_max, k_max=k_max)
    got = save_checkpoint(store, "ck", 9, port_tree, n_max=n_max, k_max=k_max, codec=CODEC)
    assert got == want
    assert _objects(store) == _objects(ref_store)
    manifest = json.loads(store.get("ck/step9/MANIFEST"))
    assert list(manifest["leaves"])[:2] == ["opt/m/embedding/embed", "opt/m/embedding/head"]
    assert manifest["leaves"]["opt/step"]["dtype"] == "int32"
    assert manifest["leaves"]["opt/step"]["bytes"] == 4
    assert manifest["leaves"]["params/layers/attn/wq"]["dtype"] == "bfloat16"


def test_reference_checkpoint_restores_in_the_port():
    ref_tree, port_tree = _train_state()
    ref_store = RefMemoryStore()
    ref_save(ref_store, "ck", 4, ref_tree)
    store = MemoryStore()  # the port's store holding the reference's objects
    for key, data in _objects(ref_store).items():
        store.put(key, data)
    faulty = FaultyStore(store)
    for key in store.keys():
        if key.endswith(("strip1", "strip6")):
            faulty.lose_object(key)
    got = restore_checkpoint(faulty, "ck", 4, port_tree, device="cpu")
    _assert_same_bits(got, ref_tree)


def test_port_checkpoint_restores_in_the_reference():
    ref_tree, port_tree = _train_state()
    store = MemoryStore()
    save_checkpoint(store, "ck", 4, port_tree, codec=CODEC)
    ref_store = RefMemoryStore()
    for key, data in _objects(store).items():
        if not key.endswith(("strip0", "strip3", "strip5")):
            ref_store.put(key, data)
    got = ref_restore(ref_store, "ck", 4, ref_tree)
    _assert_same_bits(port_tree, jax.tree.map(np.asarray, got))


def test_restore_takes_shapes_and_dtypes_from_the_manifest():
    """A ``meta`` tree gives the structure only; the leaves come back on the
    asked device with the manifest's dtypes, as tensors of their own."""
    _, port_tree = _train_state()
    store = MemoryStore()
    save_checkpoint(store, "ck", 2, port_tree, codec=CODEC)
    like = jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), port_tree)
    got = restore_checkpoint(store, "ck", 2, like, device="cpu")
    for (path, g), (_, w) in zip(tree_flatten(got), tree_flatten(port_tree)):
        assert g.device == CPU and g.dtype == w.dtype and torch.equal(g, w), path
        assert g.untyped_storage().data_ptr() != w.untyped_storage().data_ptr()
    assert got["opt"]["step"].shape == () and int(got["opt"]["step"]) == 7


def test_async_snapshot_holds_the_values_from_before_the_next_step():
    """``submit`` copies synchronously: an in-place update right after it
    (as the optimizer's) does not reach the checkpoint."""
    _, port_tree = _train_state()
    before = jax.tree.map(torch.clone, port_tree)
    store = MemoryStore()
    ckpt = AsyncCheckpointer(store, "ck", device="cpu")
    ckpt.submit(1, port_tree)
    for _, t in tree_flatten(port_tree):
        t.add_(1)
    ckpt.wait()
    ckpt.close()
    got = restore_checkpoint(store, "ck", 1, port_tree, device="cpu")
    for (path, g), (_, w) in zip(tree_flatten(got), tree_flatten(before)):
        assert torch.equal(g, w), path


def test_async_checkpointer_reports_a_failed_write():
    class Broken(MemoryStore):
        def put(self, key, data):
            raise StorageError(f"{key}: refused")

    ckpt = AsyncCheckpointer(Broken(), "ck", device="cpu")
    ckpt.submit(1, {"w": torch.ones(3)})
    with pytest.raises(StorageError, match="refused"):
        ckpt.wait()


def test_checkpoint_of_a_fresh_optimizer_state_names_the_references_leaves():
    params = get("gemma2-2b", smoke=True).init(torch.Generator().manual_seed(0))
    tree = {"params": params, "opt": init_opt_state(params)}
    manifest = save_checkpoint(MemoryStore(), "ck", 1, tree, codec=CODEC)
    rp = jax.eval_shape(ref_get("gemma2-2b", smoke=True).init, jax.random.key(0))
    ref_names = ["/".join(str(k.key) for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(
        {"params": rp, "opt": {"m": rp, "v": rp, "step": np.int32(0)}})[0]]
    assert ["/".join(path) for path, _ in tree_flatten(tree)] == ref_names
    assert sorted(manifest["leaves"]) == sorted(ref_names)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    tree = {"w": torch.ones(3)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        save_checkpoint(MemoryStore(), "ck", 1, tree)
    store = MemoryStore()
    save_checkpoint(store, "ck", 1, tree, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_checkpoint(store, "ck", 1, tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncCheckpointer(store, "ck")
