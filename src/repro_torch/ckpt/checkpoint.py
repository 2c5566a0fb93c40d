"""Erasure-coded distributed checkpointing (TOFEC-integrated).

The port of the reference package's ``repro/ckpt/checkpoint.py``, writing
the same format, so a checkpoint written by either package restores in the
other. Every checkpoint leaf (one tensor of the params/opt-state tree) is:
  1. serialized (raw bytes + dtype/shape manifest entry, crc32 checksum),
  2. RS-encoded into n strips of size ⌈bytes/k⌉ through the batched codec
     (:mod:`repro_torch.coding.codec`; the ``kernel`` backend runs K1 on the
     card); leaves sharing an (n, k, strip bucket) are encoded in ONE
     batched kernel call,
  3. written as n independent objects ``{prefix}/step{s}/{leaf}/strip{i}``.

Leaves are named and ordered as ``jax.tree_util.tree_flatten_with_path``
names and orders them (dict keys sorted, list items by index, joined by
``/``: ``opt/m/embedding/embed``, ``opt/step``, ``params/layers/attn/wq``,
``params/decoder/0/cross_attn/wq``), and
the manifest is the reference's JSON, dtype strings included
(``"bfloat16"``, ``"float32"``, ``"int32"``). Bytes are serialized through
a same-width byte view of the tensor, so bfloat16 needs no numpy dtype.

Restore fetches any k surviving strips per leaf and batch-decodes all
leaves that share (n, k, strip size) in one codec call — the codec accepts
a per-item ``present`` matrix, so heterogeneous erasure patterns across
leaves still form a single batch. Node/object loss up to n−k per leaf is
invisible. The chunking level k is chosen per write by the TOFEC
controller from the writer backlog: an idle writer uses high k (many small
parallel strips → low write latency), a backlogged writer drops to k=1
(one big strip + parity → max throughput), the paper's throughput-delay
trade-off transplanted to checkpoints.

``AsyncCheckpointer`` overlaps encode+write with training steps.

Entry points code on the card unless given ``device="cpu"`` (or a
``codec``); restored tensors land on ``device``.
"""

from __future__ import annotations

import json
import queue as _queue
import threading
import zlib

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.coding import codec as codec_mod
from repro_torch.core.controller import Policy, StaticPolicy
from repro_torch.storage.backend import ObjectStore, StorageError
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def _leaf_paths(tree) -> list[tuple[str, object]]:
    return [("/".join(map(str, path)), leaf) for path, leaf in tree_flatten(tree)]


def _host(leaf) -> torch.Tensor:
    """``leaf`` (a tensor or numpy array) as a contiguous host tensor; a host
    tensor is used as it is."""
    return torch.as_tensor(leaf).detach().cpu().contiguous()


def _payload(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as a uint8 array (a view, any dtype)."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of the dtype, the manifest's (``torch.bfloat16`` →
    ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def save_checkpoint(
    store: ObjectStore,
    prefix: str,
    step: int,
    tree,
    *,
    policy: Policy | None = None,
    n_max: int = 8,
    k_max: int = 4,
    pending_hint: int = 0,
    codec: codec_mod.Codec | None = None,
    device=None,
) -> dict:
    """Write one erasure-coded checkpoint; returns the manifest. ``codec``
    defaults to :func:`repro_torch.coding.codec.get_codec` on ``device``
    (default: the card)."""
    policy = policy or StaticPolicy(n_max, k_max)
    codec = codec or codec_mod.get_codec(device=device)
    leaves = [(name, _host(leaf)) for name, leaf in _leaf_paths(tree)]
    manifest = {"step": step, "leaves": {}, "format": 1}

    # Pick a plan per leaf, then group by (n, k) so each group shards
    # through ONE batched encode call.
    plans: list[tuple[str, torch.Tensor, int, int]] = []
    for name, arr in leaves:
        # Backlog signal = externally pending checkpoint snapshots (the
        # async writer's queue depth) — the TOFEC queue-length analogue.
        # An idle writer chunks finely (low latency); a backlogged one
        # degrades toward k=1 (max throughput), Corollary 1 verbatim.
        n, k = policy.select(q=pending_hint, idle=max(0, n_max - 1), cls_id=0)
        n = min(n, n_max)
        k = min(k, k_max, max(1, n))
        plans.append((name, arr, n, k))

    # Group by (n, k, pow2-bucketed strip width): batching pads members to
    # the group max, so bucketing bounds zero-padding waste at 2× per leaf
    # and matches the codec's own shape buckets.
    groups: dict[tuple[int, int, int], list[tuple[str, torch.Tensor]]] = {}
    for name, arr, n, k in plans:
        strip = codec_mod.Codec.strip_bytes(arr.numel() * arr.element_size(), k)
        groups.setdefault((n, k, codec_mod.pow2_bucket(strip, 128)), []).append((name, arr))

    for (n, k, _bucket), members in groups.items():
        payloads = [_payload(arr) for _, arr in members]
        all_strips = codec.encode_blobs(payloads, n=n, k=k)
        for (name, arr), payload, strips in zip(members, payloads, all_strips):
            for si in range(n):
                store.put(f"{prefix}/step{step}/{name}/strip{si}", strips[si].tobytes())
            manifest["leaves"][name] = {
                "shape": list(arr.shape),
                "dtype": _dtype_name(arr.dtype),
                "n": int(n),
                "k": int(k),
                "bytes": int(payload.size),
                "strip_bytes": int(strips.shape[1]),  # this leaf's own ⌈bytes/k⌉
                "crc": zlib.crc32(payload) & 0xFFFFFFFF,
            }
    store.put(f"{prefix}/step{step}/MANIFEST", json.dumps(manifest).encode())
    store.put(f"{prefix}/LATEST", str(step).encode())
    return manifest


def latest_step(store: ObjectStore, prefix: str) -> int | None:
    try:
        return int(store.get(f"{prefix}/LATEST").decode())
    except StorageError:
        return None


def restore_checkpoint(
    store: ObjectStore,
    prefix: str,
    step: int,
    tree_like,
    *,
    codec: codec_mod.Codec | None = None,
    device=None,
) -> object:
    """Rebuild a tree of ``tree_like``'s structure from any k of n strips
    per leaf, each leaf's shape and dtype from the manifest, its bytes
    checked against the crc; tensors on ``device`` (default: the card).
    ``tree_like``'s leaves are not read (``meta`` tensors will do)."""
    device = resolve_device(device)
    codec = codec or codec_mod.get_codec(device=device)
    manifest = json.loads(store.get(f"{prefix}/step{step}/MANIFEST").decode())
    names = [name for name, _ in _leaf_paths(tree_like)]

    # Fetch any k surviving strips per leaf, then batch-decode all leaves
    # sharing (n, k, strip_bytes) in one codec call (per-item present).
    fetched: dict[str, tuple[np.ndarray, tuple[int, ...]]] = {}
    groups: dict[tuple[int, int, int], list[str]] = {}
    for name in names:
        meta = manifest["leaves"][name]
        n, k = meta["n"], meta["k"]
        got: dict[int, bytes] = {}
        for si in range(n):
            if len(got) >= k:
                break
            try:
                got[si] = store.get(f"{prefix}/step{step}/{name}/strip{si}")
            except StorageError:
                continue
        if len(got) < k:
            raise StorageError(
                f"{name}: only {len(got)}/{k} strips survive — unrecoverable"
            )
        present = tuple(sorted(got))[:k]
        strips = np.stack([np.frombuffer(got[si], np.uint8) for si in present])
        fetched[name] = (strips, present)
        groups.setdefault((n, k, meta["strip_bytes"]), []).append(name)

    payloads: dict[str, np.ndarray] = {}
    for (n, k, _strip), members in groups.items():
        rows = np.stack([fetched[nm][0] for nm in members])
        present = np.stack([fetched[nm][1] for nm in members])
        decoded = np.asarray(codec.decode(rows, present, n, k))
        for i, nm in enumerate(members):
            payloads[nm] = np.ascontiguousarray(
                decoded[i].reshape(-1)[: manifest["leaves"][nm]["bytes"]])

    out_leaves = []
    for name in names:
        meta = manifest["leaves"][name]
        payload = payloads[name]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != meta["crc"]:
            raise StorageError(f"{name}: checksum mismatch after decode")
        # Copied before the dtype view: a payload may start at any byte.
        t = torch.from_numpy(payload).to(device, copy=True)
        out_leaves.append(t.view(getattr(torch, meta["dtype"])).reshape(meta["shape"]))
    return tree_unflatten(tree_like, out_leaves)


class AsyncCheckpointer:
    """Background checkpoint writer: snapshot on submit, write off-thread.

    ``submit`` copies every leaf to the host synchronously (the training
    step updates its tensors in place, so the snapshot never refers to a
    live tensor), then a worker thread encodes (K1 on the card's current
    stream) and writes. ``wait()`` drains the queue.
    """

    def __init__(self, store: ObjectStore, prefix: str, *, policy: Policy | None = None,
                 device=None):
        self.store = store
        self.prefix = prefix
        self.policy = policy
        self.device = resolve_device(device)
        self._q: _queue.Queue = _queue.Queue()
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, step: int, tree) -> None:
        host_tree = tree_map(lambda x: torch.as_tensor(x).detach().to("cpu", copy=True), tree)
        self._q.put((step, host_tree))

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, tree = item
                save_checkpoint(
                    self.store, self.prefix, step, tree,
                    policy=self.policy, pending_hint=self._q.qsize(), device=self.device,
                )
            except Exception as e:  # reported by wait() / close()
                self._err = e
            finally:
                self._q.task_done()

    def wait(self):
        """Block until all submitted checkpoints are durable."""
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err
