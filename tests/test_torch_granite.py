"""granite-3-2b in the port against the JAX package: its config, and its
serving path on a granite-shaped small config.

granite-3-2b is the one assigned config at d_head 64 (H=32 over Hkv=8, so
G=4), with tied embeddings (the head is ``embed.T``, no ``lm_head``) and a
vocabulary of 49,155 padded to 49,280 (``_mask_padded_vocab``). The small
config keeps every one of those traits at d_model 256 over 2 layers:
d_head 64, H=8 over Hkv=2, the full vocabulary, float32. JAX parameters
come from ``repro.models.transformer.init_lm`` and reach the port through
``params_from_numpy``; tokens come from numpy. Everything runs on the CPU,
where the attention wrapper runs its plain version, at
``tests/test_torch_lm.py``'s tolerance (``rtol=1e-4, atol=1e-5``). The card
side (the bfloat16 kernel at d=64) is in ``tests/test_torch_flash.py``'s
``cuda`` tests and ``chip_smoke.py``'s attn-d64, lm-granite-check and
lm-granite phases.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.core import export as jax_export
from repro.models import transformer as jax_tfm
from repro_torch.configs import get_config
from repro_torch.core import export
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import transformer as tfm

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "granite-3-2b"
SMALL = dict(name="granite-3-2b-small", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
             d_head=64, d_ff=512, dtype="float32", remat=False, attn_chunk=16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs():
    return (dataclasses.replace(jax_get_config(ARCH), **SMALL),
            dataclasses.replace(get_config(ARCH), **SMALL))


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg, _ = _cfgs()
    jp = jax_tfm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jp, tfm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, b=2, s=12, seed=1):
    # ids across the whole vocabulary, the last rows of the table included
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_config_matches_jax():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
            cfg.vocab_size, cfg.tie_embeddings) == (40, 2048, 32, 8, 64, 8192, 49155, True)
    assert cfg.vocab_padded == jcfg.vocab_padded == 49280
    assert cfg.n_params() == jcfg.n_params() == 2_533_365_760
    assert cfg.n_active_params() == jcfg.n_active_params()


def test_kernel_head_widths_serve_granite_in_bfloat16_only():
    """The bfloat16 forward and backward kernels take granite's d_head 64
    (and 128); the float32 forward and backward kernels take 128 only, so
    granite serves and trains on the card in bfloat16 only."""
    d = get_config(ARCH).d_head
    for direction in ("forward", "backward"):
        assert FA.KERNEL_HEAD_DIMS[(direction, torch.bfloat16)] == (64, 128)
        assert FA.KERNEL_HEAD_DIMS[(direction, torch.float32)] == (128,)
        assert d not in FA.KERNEL_HEAD_DIMS[(direction, torch.float32)]


def test_forward_prefill_decode_match_jax():
    jcfg, cfg = _cfgs()
    jp, tp = _weights()
    toks = _tokens(cfg)
    want, _ = jax_tfm.forward(jp, jnp.asarray(toks), jcfg)
    got, aux = tfm.forward(tp, _t(toks), cfg)
    assert tuple(got.shape) == (2, 12, 49280) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert (got[..., cfg.vocab_size:] == -1e30).all()   # the padded columns

    jl, jc = jax_tfm.prefill(jp, jnp.asarray(toks), jcfg)
    tl, tc = tfm.prefill(tp, _t(toks), cfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    assert (tl[:, cfg.vocab_size:] == -1e30).all()
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape == (2, 2, 12, 2, 64)
        np.testing.assert_allclose(tc[key].numpy(), _np(jc[key]), **TOL)

    # one decode step at position 12 (row 0) and 9 (row 1) on a 16-slot cache
    jcache = jax_tfm.init_cache(jcfg, 2, 16)
    jcache = {k: v.at[:, :, :12].set(jc[k]) for k, v in jcache.items()}
    tcache = tfm.init_cache(cfg, 2, 16, device="cpu")
    for key in ("k", "v"):
        tcache[key][:, :, :12] = tc[key]
    new, pos = np.array([3, 49154], np.int32), np.array([12, 9], np.int32)
    jl, jcache = jax_tfm.decode_step(jp, jcache, jnp.asarray(new), jnp.asarray(pos), jcfg)
    tl, tcache = tfm.decode_step(tp, tcache, _t(new), _t(pos), cfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    assert (tl[:, cfg.vocab_size:] == -1e30).all()
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), _np(jcache[key]), **TOL)


def test_tied_tree_has_the_jax_names_and_no_lm_head():
    jcfg, cfg = _cfgs()
    jp, tp = _weights()
    jflat = jax_export._flatten_named(jax.tree.map(np.asarray, jp))
    flat = export.flatten_named(tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert sorted(flat) == sorted(jflat) == sorted(export.flatten_named(tp))
    assert "lm_head" not in flat and flat["embed"].shape == (49280, 256)
    for name, arr in flat.items():
        assert arr.shape == jflat[name].shape and arr.dtype == jflat[name].dtype, name
    assert flat["layers/attn/wk"].shape == (2, 256, 2 * 64)


def test_flash_matches_chunked_at_d64_without_a_launch():
    _, cfg = _cfgs()
    _, tp = _weights()
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    before = FA.launches
    for s in (12, 32):   # one chunk of 16 and two
        toks = _t(_tokens(cfg, s=s, seed=2))
        np.testing.assert_allclose(tfm.forward(tp, toks, cfg)[0].numpy(),
                                   tfm.forward(tp, toks, chunked)[0].numpy(), **TOL)
        fl, fc = tfm.prefill(tp, toks, cfg)
        cl, cc = tfm.prefill(tp, toks, chunked)
        np.testing.assert_allclose(fl.numpy(), cl.numpy(), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(fc[key].numpy(), cc[key].numpy(), **TOL)
    assert FA.launches == before   # CPU tensors: the plain version, no launch


def test_decode_steps_from_an_empty_cache_match_forward():
    _, cfg = _cfgs()
    _, tp = _weights()
    toks = _tokens(cfg, s=8, seed=3)
    full, _ = tfm.forward(tp, _t(toks), cfg)
    cache = tfm.init_cache(cfg, 2, 8, device="cpu")
    for t in range(8):
        lg, cache = tfm.decode_step(tp, cache, _t(toks[:, t]),
                                    torch.full((2,), t, dtype=torch.int32), cfg)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), **TOL)
