"""Shared on-device reduction helpers for the sweep frontiers.

The port of the reference package's ``repro/fleet/stats.py``, as torch
functions on the device of their inputs:

* :func:`masked_percentiles` — values outside ``mask`` are pushed to ``BIG``
  before the sort, so they sort past every real sample and never enter a
  gather; the gather index is ``floor(q/100 · (count−1))`` — lower-
  interpolation percentiles, exact order statistics of the masked sample;
  rows whose mask is empty report NaN.
* :func:`frontier_block_reduce` and :func:`convergence_reduce` — the
  per-row reductions behind both frontier paths: the materialized reduction
  (:mod:`repro_torch.fleet.frontier` over a whole (G, T) result block) and
  the streaming per-chunk fold (:func:`repro_torch.fleet.sweep.frontier_fold`).

Bit-exact streaming. The reference relies on XLA reducing each row the same
way whatever the leading batch size. torch picks how it splits a float
reduction from the tensor's shape (on the CPU and on the card), so a row's
mean could change with the number of rows beside it. On the card it also
changes with the row's place in the block: a row of a contiguous (rows, T)
temporary starts at another 16-byte alignment when T is not a multiple of
4, and the vectorized reduction then adds its elements in another order.
So :func:`reduce_row_blocks` always reduces blocks of exactly
:data:`ROW_BLOCK` rows, and grid row g always sits at place g % ROW_BLOCK of
its block, whichever chunk of the grid it came in (the places of rows a
chunk does not hold are padded by repeating one it does, and the padding is
cut off): a row's statistics are then the same in a streamed and a
materialized run.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from repro_torch.core import queueing

#: Finite stand-in for +inf in float32 sorts (sorts past any real delay).
BIG = float(np.finfo(np.float32).max)

#: Rows per float reduction call of :func:`frontier_block_reduce`.
ROW_BLOCK = 64


def masked_percentiles(x: torch.Tensor, qs, mask: torch.Tensor | None = None) -> torch.Tensor:
    """(G, T) values → (G, len(qs)) lower-interpolation percentiles.

    ``mask`` (G, T) bool restricts each row to a subsample; ``None`` reduces
    over whole rows. Rows with an empty mask report NaN.
    """
    qs = torch.as_tensor(qs, dtype=torch.float32, device=x.device)
    G, T = x.shape
    if mask is None:
        cnt = torch.full((G,), T, dtype=torch.int32, device=x.device)
        srt = torch.sort(x, dim=1).values
    else:
        cnt = mask.sum(1).to(torch.int32)
        srt = torch.sort(torch.where(mask, x, BIG), dim=1).values
    idx = torch.clamp(
        (qs[:, None] / 100.0 * (cnt[None, :] - 1)).to(torch.int32), 0, T - 1
    )  # (len(qs), G)
    # An empty subsample has no order statistics: report NaN instead of the
    # BIG sentinel the clamped gather would land on.
    vals = torch.gather(srt, 1, idx.T.to(torch.int64))
    return torch.where(cnt[:, None] > 0, vals, torch.nan)


def _block_stats(out: dict, delta_bar, delta_tilde, psi_bar, psi_tilde, J, w: int) -> dict:
    tot = out["total"][:, w:]
    nf = out["n"][:, w:].to(torch.float32)
    kf = out["k"][:, w:].to(torch.float32)
    r = nf / kf
    params = types.SimpleNamespace(
        delta_bar=delta_bar[:, None], delta_tilde=delta_tilde[:, None],
        psi_bar=psi_bar[:, None], psi_tilde=psi_tilde[:, None],
    )
    usage = queueing.usage(params, J[:, None], kf, r)  # Eq.3, broadcast
    pct = masked_percentiles(tot, [50.0, 90.0, 95.0, 99.0])
    return {
        "mean": tot.mean(1),
        "std": tot.std(1, correction=0),
        "p50": pct[:, 0], "p90": pct[:, 1], "p95": pct[:, 2], "p99": pct[:, 3],
        "mean_queueing": out["queueing"][:, w:].mean(1),
        "mean_k": kf.mean(1),
        "mean_n": nf.mean(1),
        "mean_usage": usage.mean(1),
    }


def class_params(cfg: dict, device) -> list[torch.Tensor]:
    """The class parameters :func:`frontier_block_reduce` takes, from a
    sweep's stacked numpy config, as tensors on ``device``."""
    return [torch.from_numpy(cfg[name]).to(device)
            for name in ("delta_bar", "delta_tilde", "psi_bar", "psi_tilde", "J")]


def frontier_block_reduce(out: dict, delta_bar, delta_tilde, psi_bar, psi_tilde, J, *,
                          w: int, first: int = 0) -> dict[str, torch.Tensor]:
    """Per-row frontier statistics of a (rows, T) result block.

    ``out`` holds ``total``/``queueing`` (float32) and ``n``/``k`` (int32)
    blocks; the class parameters are (rows,) float32 tensors; ``w`` is the
    warmup cut and ``first`` the grid index of the block's first row.
    Reduces through :func:`reduce_row_blocks`, so the result of a row never
    depends on how the grid was chunked.
    """
    names = ("delta_bar", "delta_tilde", "psi_bar", "psi_tilde", "J")
    rows = {name: out[name] for name in ("total", "queueing", "n", "k")}
    rows.update(zip(names, (delta_bar, delta_tilde, psi_bar, psi_tilde, J)))
    return reduce_row_blocks(lambda blk: _block_stats(blk, *(blk[n] for n in names), w), rows,
                             first=first)


def reduce_row_blocks(reduce, rows: dict, *, first: int = 0) -> dict[str, torch.Tensor]:
    """``reduce`` over blocks of exactly :data:`ROW_BLOCK` rows, each row at
    the place its grid index gives it.

    ``rows`` maps names to tensors whose leading axis holds grid rows
    ``first``, ``first + 1``, ...; ``reduce`` takes one block of them and
    returns per-row statistics, which are cut back to the rows given and
    concatenated in their order. Grid row g sits at place g % ROW_BLOCK;
    the other places repeat the block's first given row. A row's statistics
    then never depend on how the grid was chunked (see the module
    docstring).
    """
    n = next(iter(rows.values())).shape[0]
    dev = next(iter(rows.values())).device
    parts = []
    lo = 0
    while lo < n:
        start = (first + lo) % ROW_BLOCK  # place of local row lo in its block
        hi = min(n, lo + ROW_BLOCK - start)
        idx = torch.full((ROW_BLOCK,), lo, dtype=torch.int64, device=dev)
        idx[start:start + hi - lo] = torch.arange(lo, hi, device=dev)
        red = reduce({name: v.index_select(0, idx) for name, v in rows.items()})
        parts.append({name: v[start:start + hi - lo] for name, v in red.items()})
        lo = hi
    return {name: torch.cat([p[name] for p in parts]) for name in parts[0]}


def convergence_reduce(k: torch.Tensor, *, w: int, bins: int) -> dict[str, torch.Tensor]:
    """Per-row adaptation-convergence integers for a (rows, T) k block.

    The device mirror of the host loop in
    :func:`repro_torch.fleet.frontier.convergence_stats`, returning exact
    integers so the streamed path can finish the fractions on host:

    * ``modal_k`` — first-argmax of the k histogram (``np.bincount(...).
      argmax()`` tie-breaking);
    * ``modal_count`` — occurrences of the modal k;
    * ``settle_idx`` — 1 + the last position where k leaves ±1 of the modal
      value (0 if it never does).

    ``bins`` must exceed every k the block can contain.
    """
    ks = k[:, w:].to(torch.int32)
    counts = (ks[:, :, None] == torch.arange(bins, device=k.device)).sum(1)
    modal = torch.argmax(counts, dim=1)  # the first maximum, as bincount's argmax
    off = (ks - modal[:, None]).abs() > 1
    pos = torch.arange(1, ks.shape[1] + 1, dtype=torch.int32, device=k.device)
    return {
        "modal_k": modal.to(torch.int32),
        "modal_count": torch.gather(counts, 1, modal[:, None])[:, 0],
        "settle_idx": torch.where(off, pos, 0).amax(1),
    }
