"""The port's configs, numerics and models (dense and ssm) against the JAX
package on the CPU, at float32 on the same parameters (carried across by
path)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import common as jax_common
from repro.models import param_template as jax_param_template
from repro.models import mamba as jax_mamba
from repro.models.ffn import ffn_forward as jax_ffn
from repro_torch import configs
from repro_torch.models import Model, param_template
from repro_torch.models.common import apply_rope, causal_mask, rms_norm
from repro_torch.models.ffn import ffn_forward
from repro_torch.models.mamba import (_causal_conv, mamba_decode,
                                      mamba_forward, mamba_prefill)
from torch_parity import arrays, close, flatten, reduced_pair

TIGHT = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", configs.PORTED)
@pytest.mark.parametrize("getter", ["get", "get_reduced"])
def test_config_and_template_match_jax(getter, arch):
    cfg = getattr(configs, getter)(arch)
    jcfg = getattr(jax_configs, getter)(arch)
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.dtype == torch.bfloat16
    assert {p: d.shape for p, d in param_template(cfg).items()} == \
        {p: d.shape for p, d in jax_param_template(jcfg).items()}
    assert cfg.param_count() == jcfg.param_count()


def test_other_archs_are_not_ported_yet():
    assert configs.ARCHS == jax_configs.ARCHS
    with pytest.raises(NotImplementedError, match="not ported yet"):
        configs.get("hymba-1.5b")
    with pytest.raises(KeyError):
        configs.get_reduced("no-such-arch")


def test_init_params_distributions():
    cfg = configs.get_reduced("tinyllama-1.1b")
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    wq = params["layers"]["attn"]["wq"].float()
    assert wq.shape == (2, 64, 64)
    assert abs(wq.std().item() - 64 ** -0.5) < 0.02
    assert torch.equal(params["final_norm"], torch.ones(64, dtype=cfg.dtype))
    again = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(params["embed"], again["embed"])


def test_ssm_inits_follow_the_jax_distributions():
    """A_log = log U(1, 16); dt_bias = log expm1 U(1e-3, 0.1); D ones."""
    cfg = dataclasses.replace(configs.get_reduced("mamba2-370m"),
                              num_layers=64)
    ssm = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")["layers"][
        "ssm"]
    a = torch.exp(ssm["A_log"].float())
    assert ssm["A_log"].shape == (64, 8)
    assert 1.0 <= a.min().item() and a.max().item() <= 16.0
    assert abs(a.mean().item() - 8.5) < 0.5
    u = torch.nn.functional.softplus(ssm["dt_bias"].float())
    assert 1e-3 * 0.99 <= u.min().item() and u.max().item() <= 0.1 * 1.01
    assert abs(u.mean().item() - 0.0505) < 0.005
    assert torch.equal(ssm["D"], torch.ones(64, 8, dtype=cfg.dtype))


def test_rms_norm_rope_ffn_and_mask_match_jax():
    (jx, js), (tx, ts) = arrays(0, (2, 8, 64), (64,))
    close(rms_norm(tx, ts), jax_common.rms_norm(jx, js), TIGHT)

    (jq,), (tq,) = arrays(1, (2, 8, 4, 16))
    pos = np.arange(8)[None].repeat(2, 0) + np.array([[0], [5]])
    close(apply_rope(tq, torch.from_numpy(pos)),
          jax_common.apply_rope(jq, jnp.asarray(pos)), TIGHT)
    (jh,), (th,) = arrays(2, (2, 8, 16))              # no head axis
    close(apply_rope(th, torch.from_numpy(pos)),
          jax_common.apply_rope(jh, jnp.asarray(pos)), TIGHT)

    (jh, jg, ju, jo), (th, tg, tu, to) = arrays(
        3, (2, 8, 64), (64, 128), (64, 128), (128, 64), scale=0.2)
    close(ffn_forward(th, {"wi_gate": tg, "wi_up": tu, "wo": to}, "swiglu"),
          jax_ffn(jh, {"wi_gate": jg, "wi_up": ju, "wo": jo}, "swiglu",
                  jax_common.ShardCtx(None, jax_configs.get_reduced(
                      "tinyllama-1.1b"))), TIGHT)

    assert np.array_equal(causal_mask(5, 7, 2).numpy(),
                          np.asarray(jax_common.causal_mask(5, 7, 2)))


def test_params_from_jax_carries_bf16_exactly():
    *_, jparams, _, tparams = reduced_pair(dtype=jnp.bfloat16)
    flat = flatten(jparams)
    assert flat["embed"].dtype.name == "bfloat16"
    got = tparams["layers"]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(flat["layers/attn/wq"], np.float32))


def test_prefill_and_teacher_forced_decode_match_jax():
    """Prefill's last logits and 8 teacher-forced decode steps, port (fused
    norm + kernel plain versions) against the JAX jnp path, float32."""
    _, jmodel, jparams, tcfg, tparams = reduced_pair()
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 259, (2, 16), dtype=np.int32)
    forced = rng.integers(0, 259, (2, 8), dtype=np.int32)
    model = Model(tcfg)

    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                     max_len=24)
    with torch.inference_mode():
        tlogits, tcache = model.prefill(tparams, torch.from_numpy(prompt),
                                        max_len=24)
    close(tlogits, jlogits, MODEL_TOL)
    assert tcache["layers"]["k"].shape == jcache["layers"]["k"].shape
    close(tcache["layers"]["k"], jcache["layers"]["k"], MODEL_TOL)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 16

    jstep = jax.jit(jmodel.decode_step)
    for t in range(8):
        tok = forced[:, t:t + 1]
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        with torch.inference_mode():
            tlogits, tcache = model.decode_step(tparams, tcache,
                                                torch.from_numpy(tok))
        close(tlogits, jlogits, MODEL_TOL)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 24


def test_prefill_matches_full_forward_and_decode_continues_it():
    """The port's prefill→decode equals its own full-sequence forward (the
    port of tests/test_models_smoke.py's consistency check)."""
    *_, tcfg, tparams = reduced_pair()
    model = Model(tcfg)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, 259, (2, 12), dtype=np.int32))
    with torch.inference_mode():
        full, _ = model(tparams, toks)
        last, cache = model.prefill(tparams, toks[:, :8], max_len=12)
        np.testing.assert_allclose(last.numpy(), full[:, 7].numpy(),
                                   **MODEL_TOL)
        for t in range(8, 12):
            logits, cache = model.decode_step(tparams, cache, toks[:, t:t + 1])
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                       **MODEL_TOL)


def test_cache_template_matches_jax():
    jcfg, jmodel, _, tcfg, _ = reduced_pair()
    want = jmodel.init_cache(3, 20)
    got = Model(tcfg).init_cache(3, 20, "cpu")
    for name in ("k", "v"):
        assert tuple(got["layers"][name].shape) == \
            want["layers"][name].shape
        assert not got["layers"][name].any()
    assert got["pos"].dtype == torch.int32 and int(got["pos"]) == 0


def test_unported_modes_and_families_raise():
    cfg = configs.get_reduced("tinyllama-1.1b")
    with pytest.raises(NotImplementedError):
        Model(dataclasses.replace(cfg, family="moe"))
    with pytest.raises(NotImplementedError):
        Model(dataclasses.replace(cfg, sliding_window=8))
    *_, tcfg, params = reduced_pair()
    with pytest.raises(NotImplementedError):
        Model(tcfg)(params, torch.zeros((1, 4), dtype=torch.int32),
                    mode="train")
    groups = dataclasses.replace(configs.get_reduced("mamba2-370m"),
                                 ssm_ngroups=2)
    model = Model(groups)
    with pytest.raises(NotImplementedError, match="SSM group"):
        model.prefill(model.init(torch.Generator().manual_seed(0), "cpu"),
                      torch.zeros((1, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# mamba2 (ssm family)
# ---------------------------------------------------------------------------
def test_mamba_block_pieces_match_jax():
    """Causal conv (with and without its carry) and the Mamba-2 block's
    prefill, forward and decode on the reduced config's layer 0."""
    jcfg, _, jparams, tcfg, tparams = reduced_pair(arch="mamba2-370m")
    (jx, jw, js), (tx, tw, ts) = arrays(0, (2, 7, 24), (4, 24), (2, 3, 24))
    for jstate, tstate in ((None, None), (js, ts)):
        want = jax_mamba._causal_conv(jx, jw, jstate)
        got = _causal_conv(tx, tw, tstate)
        close(got[0], want[0], TIGHT)
        close(got[1], want[1], TIGHT)

    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["ssm"])
    tp = {k: v[0] for k, v in tparams["layers"]["ssm"].items()}
    ctx = jax_common.ShardCtx(None, jcfg)
    (jh,), (th,) = arrays(1, (2, 20, 64))
    want_y, want_cache = jax_mamba.mamba_prefill(jh, jp, jcfg, ctx)
    got_y, got_cache = mamba_prefill(th, tp, tcfg)
    close(got_y, want_y, MODEL_TOL)
    close(mamba_forward(th, tp, tcfg), jax_mamba.mamba_forward(
        jh, jp, jcfg, ctx), MODEL_TOL)
    for name in want_cache:
        close(got_cache[name], want_cache[name], MODEL_TOL)
    (jt,), (tt,) = arrays(2, (2, 1, 64))
    want_y, want_cache = jax_mamba.mamba_decode(jt, jp, jcfg, ctx, want_cache)
    got_y, got_cache = mamba_decode(tt, tp, tcfg, got_cache)
    close(got_y, want_y, MODEL_TOL)
    for name in want_cache:
        close(got_cache[name], want_cache[name], MODEL_TOL)


def test_mamba_prefill_and_teacher_forced_decode_match_jax():
    """Reduced mamba2 in float32: prefill logits and cache at a prompt of
    40 (not a multiple of its chunk of 16), then 8 teacher-forced decode
    steps, port against the JAX jnp path."""
    _, jmodel, jparams, tcfg, tparams = reduced_pair(arch="mamba2-370m")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 259, (2, 40), dtype=np.int32)
    forced = rng.integers(0, 259, (2, 8), dtype=np.int32)
    model = Model(tcfg)

    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                     max_len=48)
    with torch.inference_mode():
        tlogits, tcache = model.prefill(tparams, torch.from_numpy(prompt),
                                        max_len=48)
    close(tlogits, jlogits, MODEL_TOL)
    assert tcache["layers"].keys() == jcache["layers"].keys()
    for name, want in jcache["layers"].items():
        assert tuple(tcache["layers"][name].shape) == want.shape
        close(tcache["layers"][name], want, MODEL_TOL)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 40

    jstep = jax.jit(jmodel.decode_step)
    for t in range(8):
        tok = forced[:, t:t + 1]
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        with torch.inference_mode():
            tlogits, tcache = model.decode_step(tparams, tcache,
                                                torch.from_numpy(tok))
        close(tlogits, jlogits, MODEL_TOL)
    close(tcache["layers"]["ssm"], jcache["layers"]["ssm"], MODEL_TOL)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 48


def test_mamba_prefill_matches_full_forward_and_decode_continues_it():
    *_, tcfg, tparams = reduced_pair(arch="mamba2-370m")
    model = Model(tcfg)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, 259, (2, 24), dtype=np.int32))
    with torch.inference_mode():
        full, _ = model(tparams, toks)
        last, cache = model.prefill(tparams, toks[:, :19], max_len=24)
        np.testing.assert_allclose(last.numpy(), full[:, 18].numpy(),
                                   **MODEL_TOL)
        for t in range(19, 24):
            logits, cache = model.decode_step(tparams, cache, toks[:, t:t + 1])
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                       **MODEL_TOL)


def test_mamba_cache_template_matches_jax():
    _, jmodel, _, tcfg, _ = reduced_pair(arch="mamba2-370m")
    want = jmodel.init_cache(3, 20)
    got = Model(tcfg).init_cache(3, 20, "cpu")
    assert got["layers"].keys() == want["layers"].keys()
    for name, w in want["layers"].items():
        g = got["layers"][name]
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    assert got["pos"].dtype == torch.int32 and int(got["pos"]) == 0
