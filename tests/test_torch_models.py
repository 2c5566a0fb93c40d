"""The port's dense LM (``repro_torch.models``) against the reference's on
the CPU, at the smoke configs.

Parameters come from the reference's ``arch.init(jax.random.key(s))`` and
are carried across with ``params_from_numpy``; token ids and activations
are drawn with numpy. Tolerances: atol = rtol = 1e-4 in float32 (the two
frameworks sum in different orders), and the reference's own bar of 0.08
in bfloat16 (``tests/test_arch_smoke.py``'s decode-vs-prefill check)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import arch_names as ref_arch_names
from repro.models import get as ref_get
from repro.models import layers as ref_ly
from repro.models.config import ShapeSpec as RefShapeSpec
from repro.models.registry import Arch as RefArch
from repro.models.registry import make_batch as ref_make_batch
from repro_torch.models import ShapeSpec, arch_names, get, make_batch, params_from_numpy
from repro_torch.models import layers as ly
from repro_torch.models.registry import Arch

CPU = torch.device("cpu")
DENSE = ["gemma2-2b", "mistral-nemo-12b", "yi-6b", "qwen1.5-0.5b"]
#: The other families' configs the port runs (tests/test_torch_families.py,
#: tests/test_torch_xlstm.py, tests/test_torch_hybrid.py).
PORTED = ["mixtral-8x7b", "grok-1-314b", "pixtral-12b", "whisper-base", "xlstm-350m",
          "zamba2-2.7b"]
TOL = {"float32": 1e-4, "bfloat16": 0.08}


def _pair(name, dtype, seed=1):
    """(reference arch, port arch, reference params, port params) at the
    smoke config in ``dtype``."""
    ref = ref_get(name, smoke=True)
    cfg = dataclasses.replace(ref.cfg, dtype=dtype)
    ref = RefArch(cfg=cfg, module=ref.module)
    port = Arch(cfg=_port_cfg(cfg), module=get(name, smoke=True).module)
    rp = ref.init(jax.random.key(seed))
    return ref, port, rp, params_from_numpy(jax.tree.map(np.asarray, rp), CPU)


def _port_cfg(ref_cfg):
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**dataclasses.asdict(ref_cfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x).astype(np.float64)


def _close(port, ref, tol, what):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=tol, atol=tol, err_msg=what)


def _assert_cache(pc, rc, tol, what):
    assert set(pc) == set(rc)
    for leaf in ("k", "v"):
        _close(pc[leaf], rc[leaf], tol, f"{what}: cache {leaf}")
    np.testing.assert_array_equal(pc["slot_pos"].numpy(), np.asarray(rc["slot_pos"]))
    assert int(pc["pos"]) == int(rc["pos"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_two_decode_steps_match_reference(name, dtype):
    ref, port, rp, pp = _pair(name, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(3)
    B, S = 2, 16
    toks = rng.integers(0, ref.cfg.vocab, size=(B, S)).astype(np.int32)
    rl, rc = ref.prefill(rp, {"tokens": jnp.asarray(toks)}, max_seq=S + 8)
    pl, pc = port.prefill(pp, {"tokens": torch.from_numpy(toks)}, max_seq=S + 8)
    assert pl.shape == (B, 1, ref.cfg.vocab) and pl.dtype == torch.float32
    _close(pl, rl, tol, "prefill logits")
    _assert_cache(pc, rc, tol, "prefill")
    for step in range(2):
        nxt = rng.integers(0, ref.cfg.vocab, size=(B, 1)).astype(np.int32)
        rl, rc = ref.decode_step(rp, jnp.asarray(nxt), rc)
        pl, pc = port.decode_step(pp, torch.from_numpy(nxt), pc)
        _close(pl, rl, tol, f"decode step {step} logits")
        _assert_cache(pc, rc, tol, f"decode step {step}")


@pytest.mark.parametrize("name", DENSE)
def test_decode_matches_prefill_continuation(name):
    """Decoding token t+1 after prefill[0:t] matches prefill[0:t+1]'s last
    logits (``tests/test_arch_smoke.py``'s teacher-forcing check, default
    bfloat16, its 0.08 bar), on the port alone."""
    arch = get(name, smoke=True)
    params = arch.init(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    B, S = 2, 12
    toks = torch.from_numpy(rng.integers(0, arch.cfg.vocab, size=(B, S + 1)).astype(np.int32))
    _, cache = arch.prefill(params, {"tokens": toks[:, :S]}, max_seq=S + 4)
    step_logits, _ = arch.decode_step(params, toks[:, S:S + 1], cache)
    full_logits, _ = arch.prefill(params, {"tokens": toks}, max_seq=S + 4)
    assert torch.isfinite(step_logits).all()
    np.testing.assert_allclose(step_logits.numpy(), full_logits.numpy(), rtol=0.08, atol=0.08)


def _qkv(rng, B, Sq, Skv, H, Hkv, hd, dtype):
    draw = [rng.normal(size=(B, s, h, hd)).astype(np.float32)
            for s, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv))]
    ref = [jnp.asarray(a, dtype) for a in draw]
    port = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in draw]
    return ref, port


# (Sq, window, softcap): S > attn_q_chunk = 8 throughout; a window that takes
# the banded path, one that does not, ragged S (padded queries and keys).
ATTN_CASES = [(24, None, None), (24, 6, None), (21, 5, 50.0), (40, 12, None), (19, None, 30.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,softcap", ATTN_CASES)
def test_chunked_attention_matches_reference(S, window, softcap, dtype):
    ref_cfg = dataclasses.replace(ref_get("gemma2-2b", smoke=True).cfg, attn_q_chunk=8,
                                  attn_kv_chunk=8, dtype=dtype)
    cfg = dataclasses.replace(get("gemma2-2b", smoke=True).cfg, attn_q_chunk=8,
                              attn_kv_chunk=8, dtype=dtype)
    (rq, rk, rv), (pq, pk, pv) = _qkv(np.random.default_rng(S), 2, S, S, 4, 2, 16, dtype)
    want = ref_ly.chunked_attention(ref_cfg, rq, rk, rv, causal=True, window=window,
                                    softcap=softcap)
    got = ly.chunked_attention(cfg, pq, pk, pv, window=window, softcap=softcap)
    assert got.shape == want.shape and got.dtype == pq.dtype
    _close(got, want, TOL[dtype], "chunked attention")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 6])
def test_attention_sublayer_matches_reference(window, dtype):
    """The whole causal sublayer (projections, rope, chunked attention,
    output projection) at S = 20 > attn_q_chunk = 8."""
    ref, port, rp, pp = _pair("qwen1.5-0.5b", dtype)
    ref_cfg = dataclasses.replace(ref.cfg, attn_q_chunk=8, attn_kv_chunk=8)
    cfg = dataclasses.replace(port.cfg, attn_q_chunk=8, attn_kv_chunk=8)
    x = np.random.default_rng(11).normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    want = ref_ly.attention(jax.tree.map(lambda a: a[1], rp["layers"]["attn"]), ref_cfg,
                            jnp.asarray(x, jnp.dtype(dtype)), window=window)
    got, _, _ = ly.attention({k: v[1] for k, v in pp["layers"]["attn"].items()}, cfg,
                             torch.from_numpy(x).to(getattr(torch, dtype)), window=window)
    _close(got, want, TOL[dtype], "attention sublayer")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_through_a_wrapped_ring(window, dtype):
    """Positions 0..pos-1 in a ring of Smax = 8 slots that has wrapped
    (pos = 19): the new token lands in slot pos % Smax and the mask reads
    each slot's absolute position."""
    ref, port, rp, pp = _pair("yi-6b", dtype)
    cfg = port.cfg
    rng = np.random.default_rng(7)
    B, Smax, pos = 2, 8, 19
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.normal(size=(B, Smax, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
              for _ in range(2))
    slot_pos = np.array([(pos - Smax + ((s - pos) % Smax)) for s in range(Smax)], np.int32)
    slot_pos[5] = -(2**30)  # one empty slot
    dt_j, dt_t = jnp.dtype(dtype), getattr(torch, dtype)
    r_attn = jax.tree.map(lambda a: a[0], rp["layers"]["attn"])
    p_attn = {k: v[0] for k, v in pp["layers"]["attn"].items()}
    want = ref_ly.decode_attention(r_attn, ref.cfg, jnp.asarray(x, dt_j), jnp.asarray(ck, dt_j),
                                   jnp.asarray(cv, dt_j), jnp.asarray(slot_pos), jnp.int32(pos),
                                   window=window)
    cache = (torch.from_numpy(ck).to(dt_t), torch.from_numpy(cv).to(dt_t),
             torch.from_numpy(slot_pos.copy()))
    out = ly.decode_attention(p_attn, cfg, torch.from_numpy(x).to(dt_t), *cache,
                              torch.tensor(pos, dtype=torch.int32), window=window)
    # The port updates the cache in place; the reference returns the copies.
    for g, w, what in zip((out, *cache), want, ("out", "cache_k", "cache_v", "slot_pos")):
        _close(g, w, TOL[dtype], what)
    assert int(cache[2][pos % Smax]) == pos


def test_registry_lists_the_dense_family_with_the_reference_layout():
    """Every ported family's configs, in the reference's order, and each
    one's init shapes and dtypes against the reference's ``eval_shape``."""
    assert arch_names() == ref_arch_names()
    assert sorted(arch_names()) == sorted(DENSE + PORTED)
    for name in DENSE + PORTED:
        arch = get(name, smoke=True)
        assert arch.cfg == _port_cfg(ref_get(name, smoke=True).cfg)
        assert get(name).cfg == _port_cfg(ref_get(name).cfg)
        ref_shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  jax.eval_shape(ref_get(name, smoke=True).init,
                                                 jax.random.key(0)))
        params = arch.init(torch.Generator().manual_seed(0))
        shapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                              params)
        assert shapes == ref_shapes, name
        # The reference's distributions: zero norm scales and QKV biases.
        assert not params["ln_f"]["scale"].any()
        if arch.cfg.family == "ssm":
            assert not any(blk["ln"]["scale"].any() for blk in params["blocks"])
            continue
        if arch.cfg.family == "hybrid":
            assert not params["layers"]["ln"]["scale"].any()
            assert not any(params["shared"][n]["scale"].any() for n in ("ln1", "ln2"))
            continue
        blocks = params["decoder"][0] if arch.cfg.family == "encdec" else params["layers"]
        assert not blocks["ln1"]["scale"].any()
        if arch.cfg.qkv_bias:
            attn = blocks["self_attn"] if arch.cfg.family == "encdec" else blocks["attn"]
            assert not attn["bq"].any()


def test_init_is_seeded_and_scaled():
    arch = get("qwen1.5-0.5b", smoke=True)
    a = arch.init(torch.Generator().manual_seed(4))
    b = arch.init(torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    wq = a["layers"]["attn"]["wq"].float()  # normal × 1/sqrt(d_model)
    assert abs(wq.std().item() * np.sqrt(arch.cfg.d_model) - 1.0) < 0.1


def test_other_families_raise_naming_item_13():
    """Every family is ported: the registry maps the hybrid family to
    ``models.hybrid``, and ``lm`` refuses it, naming that module; an
    unknown arch raises ``KeyError`` naming the known ones."""
    from repro_torch.models import hybrid as hybrid_mod

    assert get("zamba2-2.7b").module is hybrid_mod
    with pytest.raises(KeyError, match="the port has .*'zamba2-2.7b'"):
        get("zamba2-7b")
    arch = get("qwen1.5-0.5b", smoke=True)
    hybrid = Arch(cfg=dataclasses.replace(arch.cfg, family="hybrid"), module=arch.module)
    with pytest.raises(NotImplementedError, match="repro_torch.models.hybrid runs"):
        hybrid.init(torch.Generator())
    with pytest.raises(NotImplementedError, match="repro_torch.models.hybrid runs"):
        hybrid.prefill({}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    nemo = Arch(cfg=dataclasses.replace(arch.cfg, family="nemotron_h"), module=arch.module)
    with pytest.raises(NotImplementedError, match="repro_torch.models.nemotron_h runs"):
        nemo.init(torch.Generator())


def test_make_batch_draws_the_reference_batch():
    cfg = get("qwen1.5-0.5b", smoke=True).cfg
    for kind in ("prefill", "train"):
        batch = make_batch(cfg, ShapeSpec("s", kind, seq=16, batch=2),
                           np.random.default_rng(5), device="cpu")
        want = ref_make_batch(ref_get("qwen1.5-0.5b", smoke=True).cfg,
                              RefShapeSpec("s", kind, seq=16, batch=2), np.random.default_rng(5))
        assert sorted(batch) == sorted(want)
        for key in batch:
            np.testing.assert_array_equal(batch[key].numpy(), np.asarray(want[key]))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    arch = get("qwen1.5-0.5b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arch.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arch.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
